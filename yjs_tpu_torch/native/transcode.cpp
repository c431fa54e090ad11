// Native columnar transcoder for the Yjs V1 and V2 wire formats.
//
// The host-side decode of update blobs (reference src/utils/encoding.js
// readClientsStructRefs, encoding.js:127-198, the V2 9-stream columnar
// container of UpdateDecoder.js:270-293, and the DS sections of
// DeleteSet.js:270-285) is the per-item hot loop of the marshaling pipeline
// feeding the TPU batch engine (SURVEY.md §7 phase 1: "the only candidate
// for a C++ component — varint/RLE transcode at 100k-doc scale").  This
// library scans an update once and emits fixed-width columns; variable
// payloads stay in the source buffer, referenced by byte ranges, and are
// decoded lazily by the Python side only when materialized.
//
// Two-pass C ABI: ytpu_count_v1/v2 sizes the outputs, ytpu_decode_v1/v2
// fills caller-allocated arrays.  All columns are int64 with -1 as the null
// sentinel.  Returns 0 on success, a negative error code otherwise.

#include "wire.h"

using namespace ytpu_wire;
extern "C" {

// Returns bytes written into `out`, or a negative error code.
int64_t ytpu_encode_v1(
    const uint8_t** bufs, const uint64_t* buf_lens, uint64_t n_bufs,
    // write groups: one per client, descending id order
    const int64_t* group_client, const int64_t* group_start,
    const int64_t* group_len, uint64_t n_groups,
    // per written row, flat in group order
    const int64_t* clock, const int64_t* length, const int64_t* offset,
    const int64_t* origin_client, const int64_t* origin_clock,
    const int64_t* right_client, const int64_t* right_clock,
    const int64_t* content_ref,
    const int64_t* name_ofs, const int64_t* name_len,
    const int64_t* sub_ofs, const int64_t* sub_len,
    const int64_t* parent_client, const int64_t* parent_clock,
    const int64_t* src_kind, const int64_t* src_buf,
    const int64_t* src_ofs, const int64_t* src_end,
    const uint8_t* strings, uint64_t strings_len,
    // delete-set groups (client order as given)
    const int64_t* ds_group_client, const int64_t* ds_group_start,
    const int64_t* ds_group_len, uint64_t n_ds_groups,
    const int64_t* ds_clock, const int64_t* ds_len,
    uint8_t* out, uint64_t out_cap) {
  Writer w{out, out_cap, 0, false};
  w.varuint(n_groups);
  for (uint64_t g = 0; g < n_groups && !w.fail; g++) {
    int64_t start = group_start[g], n = group_len[g];
    w.varuint((uint64_t)n);
    w.varuint((uint64_t)group_client[g]);
    w.varuint((uint64_t)(clock[start] + offset[start]));
    for (int64_t r = start; r < start + n && !w.fail; r++) {
      int64_t ofs = offset[r];
      int64_t ref = content_ref[r];
      if (src_kind[r] == kSrcNone) {  // GC struct (GC.js:45-48)
        w.u8(0);
        w.varuint((uint64_t)(length[r] - ofs));
        continue;
      }
      // resolve origin under the partial-first-struct rule
      int64_t oc = origin_client[r], ok = origin_clock[r];
      if (ofs > 0) { oc = group_client[g]; ok = clock[r] + ofs - 1; }
      bool has_o = oc >= 0, has_r = right_client[r] >= 0;
      bool has_sub = sub_ofs[r] >= 0;
      // BIT6 always reflects parentSub presence (Item.js:631); the parent
      // strings themselves are only written when neither neighbor id is
      // (canCopyParentInfo, Item.js:640-652)
      uint8_t info = (uint8_t)(ref & kBits5);
      if (has_o) info |= kBit8;
      if (has_r) info |= kBit7;
      if (has_sub) info |= kBit6;
      w.u8(info);
      if (has_o) { w.varuint((uint64_t)oc); w.varuint((uint64_t)ok); }
      if (has_r) {
        w.varuint((uint64_t)right_client[r]);
        w.varuint((uint64_t)right_clock[r]);
      }
      if (!has_o && !has_r) {
        if (name_ofs[r] >= 0) {
          w.varuint(1);  // parent_info: root-type key (Item.js:640-652)
          if ((uint64_t)(name_ofs[r] + name_len[r]) > strings_len) return -3;
          w.varuint((uint64_t)name_len[r]);
          w.bytes(strings + name_ofs[r], (uint64_t)name_len[r]);
        } else if (parent_client[r] >= 0) {
          w.varuint(0);  // parent is the nested type item's id (Item.js:644)
          w.varuint((uint64_t)parent_client[r]);
          w.varuint((uint64_t)parent_clock[r]);
        } else {
          return -3;
        }
        if (has_sub) {
          if ((uint64_t)(sub_ofs[r] + sub_len[r]) > strings_len) return -3;
          w.varuint((uint64_t)sub_len[r]);
          w.bytes(strings + sub_ofs[r], (uint64_t)sub_len[r]);
        }
      }
      switch (src_kind[r]) {
        case kSrcDeleted:
          w.varuint((uint64_t)(length[r] - ofs));
          break;
        case kSrcFramed: case kSrcSpill: case kSrcUtf8:
        case kSrcAnys: case kSrcJsons: {
          if (src_buf[r] < 0 || (uint64_t)src_buf[r] >= n_bufs) return -4;
          const uint8_t* sb = bufs[src_buf[r]];
          uint64_t sl = buf_lens[src_buf[r]];
          if (src_ofs[r] < 0 || src_end[r] < src_ofs[r] ||
              (uint64_t)src_end[r] > sl)
            return -4;
          if (src_kind[r] == kSrcUtf8) {
            write_cut_string(&w, sb + src_ofs[r],
                             (uint64_t)(src_end[r] - src_ofs[r]), ofs);
          } else if (src_kind[r] == kSrcAnys || src_kind[r] == kSrcJsons) {
            // `length` elements at [ofs,end): re-frame as varuint count +
            // element bytes, skipping the first `ofs` elements (the
            // partial-first-struct rule applied element-wise)
            w.varuint((uint64_t)(length[r] - ofs));
            Reader er{sb, (uint64_t)src_end[r], (uint64_t)src_ofs[r], false};
            for (int64_t i = 0; i < ofs && !er.fail; i++) {
              if (src_kind[r] == kSrcAnys) er.skip_any();
              else { uint64_t o, b; er.var_string(&o, &b); }
            }
            if (er.fail) return -4;
            w.bytes(sb + er.pos, (uint64_t)(src_end[r] - (int64_t)er.pos));
          } else {
            if (src_kind[r] == kSrcFramed && ofs != 0) return -5;
            w.bytes(sb + src_ofs[r], (uint64_t)(src_end[r] - src_ofs[r]));
          }
          break;
        }
        default:
          return -6;
      }
    }
  }
  // DS section (DeleteSet.js:219-232)
  w.varuint(n_ds_groups);
  for (uint64_t g = 0; g < n_ds_groups && !w.fail; g++) {
    w.varuint((uint64_t)ds_group_client[g]);
    int64_t start = ds_group_start[g], n = ds_group_len[g];
    w.varuint((uint64_t)n);
    for (int64_t i = start; i < start + n; i++) {
      w.varuint((uint64_t)ds_clock[i]);
      w.varuint((uint64_t)ds_len[i]);
    }
  }
  if (w.fail) return -2;
  return (int64_t)w.pos;
}

int ytpu_count_v1(const uint8_t* buf, uint64_t len,
                  uint64_t* n_structs, uint64_t* n_ds) {
  Reader r{buf, len, 0, false};
  *n_structs = parse_structs(&r, nullptr);
  if (r.fail) return -1;
  *n_ds = parse_ds(&r, nullptr, nullptr, nullptr);
  if (r.fail) return -2;
  if (r.pos != len) return -3;  // trailing garbage
  return 0;
}

int ytpu_decode_v1(const uint8_t* buf, uint64_t len,
                   int64_t* client, int64_t* clock, int64_t* length,
                   int64_t* origin_client, int64_t* origin_clock,
                   int64_t* right_client, int64_t* right_clock,
                   int64_t* info,
                   int64_t* parent_name_ofs, int64_t* parent_name_len,
                   int64_t* parent_id_client, int64_t* parent_id_clock,
                   int64_t* parent_sub_ofs, int64_t* parent_sub_len,
                   int64_t* content_ofs, int64_t* content_end,
                   int64_t* ds_client, int64_t* ds_clock, int64_t* ds_len) {
  Reader r{buf, len, 0, false};
  StructOut out{client, clock, length, origin_client, origin_clock,
                right_client, right_clock, info,
                parent_name_ofs, parent_name_len,
                parent_id_client, parent_id_clock,
                parent_sub_ofs, parent_sub_len,
                content_ofs, content_end};
  parse_structs(&r, &out);
  if (r.fail) return -1;
  parse_ds(&r, ds_client, ds_clock, ds_len);
  if (r.fail) return -2;
  return 0;
}

int ytpu_count_v2(const uint8_t* buf, uint64_t len,
                  uint64_t* n_structs, uint64_t* n_ds) {
  V2Streams v;
  if (!v.init(buf, len)) return -1;
  int err = 0;
  *n_structs = parse_structs_v2(&v, nullptr, &err);
  if (err != 0) return err;
  *n_ds = parse_ds_v2(&v.rest, nullptr, nullptr, nullptr);
  if (v.rest.fail) return -2;
  if (v.rest.pos != len) return -3;  // trailing garbage
  return 0;
}

int ytpu_decode_v2(const uint8_t* buf, uint64_t len,
                   int64_t* client, int64_t* clock, int64_t* length,
                   int64_t* origin_client, int64_t* origin_clock,
                   int64_t* right_client, int64_t* right_clock,
                   int64_t* info,
                   int64_t* parent_name_ofs, int64_t* parent_name_len,
                   int64_t* parent_id_client, int64_t* parent_id_clock,
                   int64_t* parent_sub_ofs, int64_t* parent_sub_len,
                   int64_t* content_ofs, int64_t* content_end,
                   int64_t* content_ofs2, int64_t* content_end2,
                   int64_t* content_count,
                   int64_t* ds_client, int64_t* ds_clock, int64_t* ds_len) {
  V2Streams v;
  if (!v.init(buf, len)) return -1;
  StructOut2 out{client, clock, length, origin_client, origin_clock,
                 right_client, right_clock, info,
                 parent_name_ofs, parent_name_len,
                 parent_id_client, parent_id_clock,
                 parent_sub_ofs, parent_sub_len,
                 content_ofs, content_end,
                 content_ofs2, content_end2, content_count};
  int err = 0;
  parse_structs_v2(&v, &out, &err);
  if (err != 0) return err;
  parse_ds_v2(&v.rest, ds_client, ds_clock, ds_len);
  if (v.rest.fail) return -2;
  return 0;
}

}  // extern "C"
