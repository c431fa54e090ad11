// Shared wire-format scanners/writers for the native transcoder and the
// native plan core (plancore.cpp).  Header-only; every definition is
// inline-safe inside namespace ytpu_wire.  Extracted verbatim from
// transcode.cpp — see that file's header comment for the format notes
// (reference src/utils/encoding.js:127-198, UpdateDecoder.js:270-293,
// DeleteSet.js:270-285).
#pragma once
#include <cstdint>
#include <cstddef>
#include <vector>

namespace ytpu_wire {

struct Reader {
  const uint8_t* buf;
  uint64_t len;
  uint64_t pos;
  bool fail;

  uint8_t u8() {
    if (pos >= len) { fail = true; return 0; }
    return buf[pos++];
  }

  // lib0 varuint (7 bits per byte, little-endian groups).  Fast paths
  // for the 1- and 2-byte encodings that dominate wire traffic.
  uint64_t varuint() {
    if (pos < len) {
      uint8_t r0 = buf[pos];
      if (r0 < 0x80) {
        pos++;
        return r0;
      }
      if (pos + 1 < len) {
        uint8_t r1 = buf[pos + 1];
        if (r1 < 0x80) {
          pos += 2;
          return (uint64_t)(r0 & 0x7f) | ((uint64_t)r1 << 7);
        }
      }
    }
    uint64_t num = 0;
    int shift = 0;
    while (true) {
      if (pos >= len || shift > 63) { fail = true; return 0; }
      uint8_t r = buf[pos++];
      num |= (uint64_t)(r & 0x7f) << shift;
      shift += 7;
      if (r < 0x80) return num;
    }
  }

  // lib0 varint: first byte holds sign bit 0x40 and 6 bits of payload
  void varint() {
    if (pos >= len) { fail = true; return; }
    uint8_t r = buf[pos++];
    if (r < 0x80) return;
    int shift = 6;
    while (true) {
      if (pos >= len || shift > 63) { fail = true; return; }
      uint8_t c = buf[pos++];
      shift += 7;
      if (c < 0x80) return;
    }
  }

  void skip(uint64_t n) {
    if (n > len - pos) { fail = true; return; }  // overflow-safe bound check
    pos += n;
  }

  // var_string: varuint byte length + utf8; returns (ofs, bytelen)
  void var_string(uint64_t* ofs, uint64_t* blen) {
    uint64_t n = varuint();
    *ofs = pos;
    *blen = n;
    skip(n);
  }

  // UTF-16 code-unit count of a utf8 range (JS string .length
  // semantics).  Malformed sequences — bad lead byte, missing/invalid
  // continuation bytes (must be 0x80-0xBF), truncation — set `fail`, so
  // adversarial bytes take the demote-to-Python path instead of
  // silently miscounting (the Python decoder raises here)
  uint64_t utf16_len(uint64_t ofs, uint64_t blen) {
    uint64_t units = 0;
    uint64_t end = ofs + blen;
    if (end > len) { fail = true; return 0; }
    for (uint64_t i = ofs; i < end; ) {
      // ASCII fast path: count 8 valid bytes per iteration
      while (i + 8 <= end) {
        uint64_t w;
        __builtin_memcpy(&w, buf + i, 8);
        if (w & 0x8080808080808080ull) break;
        units += 8;
        i += 8;
      }
      if (i >= end) break;
      uint8_t b = buf[i];
      uint64_t n;
      if (b < 0x80) { n = 1; units += 1; }
      else if (b < 0xC2) { fail = true; return 0; }  // continuation/overlong lead
      else if (b < 0xE0) { n = 2; units += 1; }
      else if (b < 0xF0) { n = 3; units += 1; }
      else if (b < 0xF5) { n = 4; units += 2; }
      else { fail = true; return 0; }                // > U+10FFFF lead
      if (i + n > end) { fail = true; return 0; }    // truncated sequence
      for (uint64_t j = 1; j < n; j++) {
        if ((buf[i + j] & 0xC0) != 0x80) { fail = true; return 0; }
      }
      i += n;
    }
    return units;
  }

  // skip one lib0 "any" value
  void skip_any(int depth = 0) {
    if (depth > 64) { fail = true; return; }
    uint8_t tag = u8();
    if (fail) return;
    switch (tag) {
      case 127: case 126: case 121: case 120: break;  // undefined/null/bools
      case 125: varint(); break;
      case 124: skip(4); break;                        // float32
      case 123: skip(8); break;                        // float64
      case 122: skip(8); break;                        // bigint64
      case 119: { uint64_t o, b; var_string(&o, &b); break; }
      case 118: {                                      // object
        uint64_t n = varuint();
        for (uint64_t i = 0; i < n && !fail; i++) {
          uint64_t o, b; var_string(&o, &b);
          skip_any(depth + 1);
        }
        break;
      }
      case 117: {                                      // array
        uint64_t n = varuint();
        for (uint64_t i = 0; i < n && !fail; i++) skip_any(depth + 1);
        break;
      }
      case 116: { uint64_t n = varuint(); skip(n); break; }  // uint8array
      default: fail = true;
    }
  }
};

constexpr uint8_t kBit6 = 0x20, kBit7 = 0x40, kBit8 = 0x80, kBits5 = 0x1f;

// ---------------------------------------------------------------------------
// V2: lib0 stream decoders over sub-ranges of the update buffer
// (mirrors yjs_tpu/lib0/decoding.py RleDecoder / UintOptRleDecoder /
// IntDiffOptRleDecoder / StringDecoder; reference UpdateDecoder.js:270-293)
// ---------------------------------------------------------------------------

// lib0 signed varint: first byte = sign bit 0x40 + 6 payload bits
inline void varint_signed(Reader* r, int64_t* num, int* sign) {
  if (r->pos >= r->len) { r->fail = true; *num = 0; *sign = 1; return; }
  uint8_t b = r->buf[r->pos++];
  *num = b & 0x3f;
  *sign = (b & kBit7) ? -1 : 1;
  if ((b & kBit8) == 0) return;
  int shift = 6;
  while (true) {
    if (r->pos >= r->len || shift > 63) { r->fail = true; return; }
    uint8_t c = r->buf[r->pos++];
    *num |= (int64_t)(c & 0x7f) << shift;
    shift += 7;
    if (c < 0x80) return;
  }
}

struct RleU8 {  // RleDecoder(read_uint8): u8 value + (varuint count + 1)
  Reader r;
  int64_t s = 0, count = 0;
  int64_t read() {
    if (count == 0) {
      s = r.u8();
      if (r.pos < r.len) count = (int64_t)r.varuint() + 1;
      else count = INT64_MAX;  // final value repeats forever
    }
    count--;
    return s;
  }
};

struct UintOptRle {
  Reader r;
  int64_t s = 0, count = 0;
  int64_t read() {
    if (count == 0) {
      int sign; varint_signed(&r, &s, &sign);
      count = 1;
      if (sign < 0) count = (int64_t)r.varuint() + 2;
    }
    count--;
    return s;
  }
};

struct IntDiffOptRle {
  Reader r;
  int64_t s = 0, count = 0, diff = 0;
  int64_t read() {
    if (count == 0) {
      int64_t num; int sign; varint_signed(&r, &num, &sign);
      int64_t d = sign * num;
      bool has_count = (d & 1) != 0;
      diff = d >> 1;  // arithmetic shift = floor div 2 (also for negatives)
      count = has_count ? (int64_t)r.varuint() + 2 : 1;
    }
    s += diff;
    count--;
    return s;
  }
};

struct StringDec {  // one UTF-8 arena + UintOptRle of UTF-16 lengths
  UintOptRle lens;
  uint64_t arena_ofs = 0, arena_end = 0, cursor = 0;
  const uint8_t* buf = nullptr;

  void init(const uint8_t* b, uint64_t slice_start, uint64_t slice_end) {
    buf = b;
    lens.r = Reader{b, slice_end, slice_start, false};
    uint64_t blen = lens.r.varuint();
    arena_ofs = lens.r.pos;
    lens.r.skip(blen);
    arena_end = lens.r.pos;
    cursor = arena_ofs;
  }

  // consume one string; returns absolute (ofs, end) byte range of its
  // UTF-8.  Continuation bytes are validated (0x80-0xBF) so malformed
  // arenas fail the scan (-> demote-to-Python) instead of miscounting
  void read(int64_t* ofs, int64_t* end) {
    int64_t units = lens.read();
    *ofs = (int64_t)cursor;
    uint64_t i = cursor;
    int64_t got = 0;
    while (got < units && i < arena_end) {
      uint8_t b = buf[i];
      uint64_t n;
      if (b < 0x80) { n = 1; got += 1; }
      else if (b < 0xC2) { lens.r.fail = true; break; }
      else if (b < 0xE0) { n = 2; got += 1; }
      else if (b < 0xF0) { n = 3; got += 1; }
      else if (b < 0xF5) { n = 4; got += 2; }
      else { lens.r.fail = true; break; }
      if (i + n > arena_end) { lens.r.fail = true; break; }
      for (uint64_t j = 1; j < n; j++) {
        if ((buf[i + j] & 0xC0) != 0x80) { lens.r.fail = true; break; }
      }
      if (lens.r.fail) break;
      i += n;
    }
    if (got != units || i > arena_end) lens.r.fail = true;
    cursor = i;
    *end = (int64_t)i;
  }

  bool failed() const { return lens.r.fail; }
};

struct V2Streams {
  IntDiffOptRle key_clock;
  UintOptRle client;
  IntDiffOptRle left_clock;
  IntDiffOptRle right_clock;
  RleU8 info;
  StringDec str;
  RleU8 parent_info;
  UintOptRle type_ref;
  UintOptRle len;
  Reader rest;  // counts, clocks, DS section, rest-stream contents
  // read_key cache: ranges of previously seen keys (parent_sub
  // dictionary) — grows without bound like the reference's JS array
  // (UpdateDecoder.js:370-393); the old 4096-entry cap silently demoted
  // wide-key docs to the CPU core
  std::vector<int64_t> key_ofs, key_end;

  bool init(const uint8_t* buf, uint64_t blen) {
    Reader r{buf, blen, 0, false};
    r.u8();  // feature flag (always 0 in v13.4)
    uint64_t o, n;
    auto slice = [&](auto setup) {
      n = r.varuint(); o = r.pos; r.skip(n);
      if (!r.fail) setup(o, o + n);
    };
    slice([&](uint64_t a, uint64_t b) { key_clock.r = Reader{buf, b, a, false}; });
    slice([&](uint64_t a, uint64_t b) { client.r = Reader{buf, b, a, false}; });
    slice([&](uint64_t a, uint64_t b) { left_clock.r = Reader{buf, b, a, false}; });
    slice([&](uint64_t a, uint64_t b) { right_clock.r = Reader{buf, b, a, false}; });
    slice([&](uint64_t a, uint64_t b) { info.r = Reader{buf, b, a, false}; });
    slice([&](uint64_t a, uint64_t b) { str.init(buf, a, b); });
    slice([&](uint64_t a, uint64_t b) { parent_info.r = Reader{buf, b, a, false}; });
    slice([&](uint64_t a, uint64_t b) { type_ref.r = Reader{buf, b, a, false}; });
    slice([&](uint64_t a, uint64_t b) { len.r = Reader{buf, b, a, false}; });
    if (r.fail) return false;
    rest = Reader{buf, blen, r.pos, false};
    return true;
  }

  void read_key(int64_t* ofs, int64_t* end) {  // UpdateDecoder.js:382-391
    int64_t kc = key_clock.read();
    if (kc >= 0 && (size_t)kc < key_ofs.size()) {
      *ofs = key_ofs[(size_t)kc];
      *end = key_end[(size_t)kc];
      return;
    }
    str.read(ofs, end);
    key_ofs.push_back(*ofs);
    key_end.push_back(*end);
  }

  bool any_fail() {
    return key_clock.r.fail || client.r.fail || left_clock.r.fail ||
           right_clock.r.fail || info.r.fail || str.failed() ||
           parent_info.r.fail || type_ref.r.fail || len.r.fail || rest.fail;
  }
};

struct StructOut2 {
  int64_t *client, *clock, *length;
  int64_t *origin_client, *origin_clock;
  int64_t *right_client, *right_clock;
  int64_t *info;
  int64_t *parent_name_ofs, *parent_name_len;
  int64_t *parent_id_client, *parent_id_clock;
  int64_t *parent_sub_ofs, *parent_sub_len;
  int64_t *content_ofs, *content_end;     // kind-specific primary range
  int64_t *content_ofs2, *content_end2;   // secondary range (Format value …)
  int64_t *content_count;                 // element count / type_ref
};

// Parse the V2 struct section.  When out == nullptr, only counts.
inline uint64_t parse_structs_v2(V2Streams* v, StructOut2* out, int* err) {
  uint64_t idx = 0;
  Reader* rest = &v->rest;
  uint64_t n_updates = rest->varuint();
  for (uint64_t u = 0; u < n_updates && !rest->fail; u++) {
    uint64_t n_structs = rest->varuint();
    int64_t client = v->client.read();
    uint64_t clock = rest->varuint();
    for (uint64_t s = 0; s < n_structs; s++) {
      if (v->any_fail()) { *err = -1; return idx; }
      uint8_t info = (uint8_t)v->info.read();
      uint8_t ref = info & kBits5;
      int64_t oc = -1, ok = 0, rc = -1, rk = 0;
      int64_t pno = -1, pne = -1, pic = -1, pik = -1, pso = -1, pse = -1;
      int64_t c_ofs = -1, c_end = -1, c_ofs2 = -1, c_end2 = -1, c_cnt = -1;
      int64_t length = 0;
      if (ref != 0) {
        if (info & kBit8) { oc = v->client.read(); ok = v->left_clock.read(); }
        if (info & kBit7) { rc = v->client.read(); rk = v->right_clock.read(); }
        if (!(info & (kBit7 | kBit8))) {
          if (v->parent_info.read() == 1) {
            v->str.read(&pno, &pne);
          } else {
            pic = v->client.read(); pik = v->left_clock.read();
          }
          if (info & kBit6) v->str.read(&pso, &pse);
        }
        switch (ref) {
          case 1: length = v->len.read(); break;            // ContentDeleted
          case 3: {                                         // ContentBinary
            c_ofs = (int64_t)rest->pos;
            uint64_t n = rest->varuint(); rest->skip(n);
            c_end = (int64_t)rest->pos;
            length = 1;
            break;
          }
          case 4: {                                         // ContentString
            v->str.read(&c_ofs, &c_end);
            // UTF-16 unit length = what the arena scan consumed
            length = v->str.lens.s;
            break;
          }
          case 5: {                                         // ContentEmbed
            c_ofs = (int64_t)rest->pos;
            rest->skip_any();
            c_end = (int64_t)rest->pos;
            length = 1;
            break;
          }
          case 6: {                                         // ContentFormat
            v->str.read(&c_ofs, &c_end);                    // key string
            c_ofs2 = (int64_t)rest->pos;
            rest->skip_any();                               // json value
            c_end2 = (int64_t)rest->pos;
            length = 1;
            break;
          }
          case 7: {                                         // ContentType
            c_cnt = v->type_ref.read();
            // XmlElement / XmlHook names go through the key dictionary
            // (readYXmlElement: decoder.readKey(), YXmlElement.js:225)
            if (c_cnt == 3 || c_cnt == 5) v->read_key(&c_ofs, &c_end);
            length = 1;
            break;
          }
          case 8: {                                         // ContentAny
            c_cnt = v->len.read();
            c_ofs = (int64_t)rest->pos;
            for (int64_t i = 0; i < c_cnt && !rest->fail; i++) rest->skip_any();
            c_end = (int64_t)rest->pos;
            length = c_cnt;
            break;
          }
          case 2:                                           // ContentJSON
          case 9:                                           // ContentDoc
          default:
            // legacy / subdoc payloads: punt the whole update to the
            // Python decoder (they demote the doc off the device path
            // anyway)
            *err = -4;
            return idx;
        }
      } else {
        length = v->len.read();                             // GC
      }
      if (v->any_fail()) { *err = -1; return idx; }
      if (length == 0 && ref != 0) { *err = -1; return idx; }
      if (out != nullptr) {
        out->client[idx] = client;
        out->clock[idx] = (int64_t)clock;
        out->length[idx] = length;
        out->origin_client[idx] = oc; out->origin_clock[idx] = ok;
        out->right_client[idx] = rc; out->right_clock[idx] = rk;
        out->info[idx] = info;
        out->parent_name_ofs[idx] = pno;
        out->parent_name_len[idx] = pno < 0 ? -1 : pne - pno;
        out->parent_id_client[idx] = pic; out->parent_id_clock[idx] = pik;
        out->parent_sub_ofs[idx] = pso;
        out->parent_sub_len[idx] = pso < 0 ? -1 : pse - pso;
        out->content_ofs[idx] = c_ofs; out->content_end[idx] = c_end;
        out->content_ofs2[idx] = c_ofs2; out->content_end2[idx] = c_end2;
        out->content_count[idx] = c_cnt;
      }
      idx++;
      clock += (uint64_t)length;
    }
  }
  if (rest->fail) *err = -1;
  return idx;
}

// V2 DS section (coding.py DSDecoderV2: delta-varint clocks, len-1 wire)
inline uint64_t parse_ds_v2(Reader* r, int64_t* ds_client, int64_t* ds_clock,
                     int64_t* ds_len) {
  uint64_t idx = 0;
  uint64_t n_clients = r->varuint();
  for (uint64_t c = 0; c < n_clients && !r->fail; c++) {
    int64_t cur = 0;
    uint64_t client = r->varuint();
    uint64_t n = r->varuint();
    for (uint64_t i = 0; i < n && !r->fail; i++) {
      cur += (int64_t)r->varuint();
      int64_t clock = cur;
      int64_t len = (int64_t)r->varuint() + 1;
      cur += len;
      if (ds_client != nullptr) {
        ds_client[idx] = (int64_t)client;
        ds_clock[idx] = clock;
        ds_len[idx] = len;
      }
      idx++;
    }
  }
  return idx;
}

struct StructOut {
  int64_t *client, *clock, *length;
  int64_t *origin_client, *origin_clock;
  int64_t *right_client, *right_clock;
  int64_t *info;
  int64_t *parent_name_ofs, *parent_name_len;
  int64_t *parent_id_client, *parent_id_clock;
  int64_t *parent_sub_ofs, *parent_sub_len;
  int64_t *content_ofs, *content_end;
};

// Parse the struct section.  When out == nullptr, only counts.
// Returns the number of structs, or sets r->fail.
inline uint64_t parse_structs(Reader* r, StructOut* out) {
  uint64_t idx = 0;
  uint64_t n_updates = r->varuint();
  for (uint64_t u = 0; u < n_updates && !r->fail; u++) {
    uint64_t n_structs = r->varuint();
    uint64_t client = r->varuint();
    uint64_t clock = r->varuint();
    for (uint64_t s = 0; s < n_structs && !r->fail; s++) {
      uint8_t info = r->u8();
      uint8_t ref = info & kBits5;
      int64_t oc = -1, ok = 0, rc = -1, rk = 0;
      int64_t pno = -1, pnl = -1, pic = -1, pik = -1, pso = -1, psl = -1;
      uint64_t length = 0, c_ofs = 0, c_end = 0;
      if (ref != 0) {
        if (info & kBit8) { oc = (int64_t)r->varuint(); ok = (int64_t)r->varuint(); }
        if (info & kBit7) { rc = (int64_t)r->varuint(); rk = (int64_t)r->varuint(); }
        if (!(info & (kBit7 | kBit8))) {
          if (r->varuint() == 1) {                       // parent is root name
            uint64_t o, b; r->var_string(&o, &b);
            pno = (int64_t)o; pnl = (int64_t)b;
          } else {                                       // parent is an id
            pic = (int64_t)r->varuint(); pik = (int64_t)r->varuint();
          }
          if (info & kBit6) {
            uint64_t o, b; r->var_string(&o, &b);
            pso = (int64_t)o; psl = (int64_t)b;
          }
        }
        c_ofs = r->pos;
        switch (ref) {
          case 1: length = r->varuint(); break;          // ContentDeleted
          case 2: {                                      // ContentJSON
            uint64_t n = r->varuint();
            for (uint64_t i = 0; i < n && !r->fail; i++) {
              uint64_t o, b; r->var_string(&o, &b);
            }
            length = n;
            break;
          }
          case 3: { uint64_t n = r->varuint(); r->skip(n); length = 1; break; }
          case 4: {                                      // ContentString
            uint64_t o, b; r->var_string(&o, &b);
            length = r->utf16_len(o, b);
            break;
          }
          case 5: {                                      // ContentEmbed (json string)
            uint64_t o, b; r->var_string(&o, &b);
            length = 1;
            break;
          }
          case 6: {                                      // ContentFormat
            uint64_t o, b;
            r->var_string(&o, &b);                       // key
            r->var_string(&o, &b);                       // json value
            length = 1;
            break;
          }
          case 7: {                                      // ContentType
            uint64_t tref = r->varuint();
            if (tref == 3 || tref == 5) {                // XmlElement / XmlHook
              uint64_t o, b; r->var_string(&o, &b);
            }
            length = 1;
            break;
          }
          case 8: {                                      // ContentAny
            uint64_t n = r->varuint();
            for (uint64_t i = 0; i < n && !r->fail; i++) r->skip_any();
            length = n;
            break;
          }
          case 9: {                                      // ContentDoc
            uint64_t o, b; r->var_string(&o, &b);        // guid
            r->skip_any();                               // opts
            length = 1;
            break;
          }
          default: r->fail = true;
        }
        c_end = r->pos;
      } else {
        length = r->varuint();                           // GC
      }
      if (r->fail) break;
      if (length == 0 && ref != 0) { r->fail = true; break; }
      if (out != nullptr) {
        out->client[idx] = (int64_t)client;
        out->clock[idx] = (int64_t)clock;
        out->length[idx] = (int64_t)length;
        out->origin_client[idx] = oc; out->origin_clock[idx] = ok;
        out->right_client[idx] = rc; out->right_clock[idx] = rk;
        out->info[idx] = info;
        out->parent_name_ofs[idx] = pno; out->parent_name_len[idx] = pnl;
        out->parent_id_client[idx] = pic; out->parent_id_clock[idx] = pik;
        out->parent_sub_ofs[idx] = pso; out->parent_sub_len[idx] = psl;
        out->content_ofs[idx] = (int64_t)c_ofs; out->content_end[idx] = (int64_t)c_end;
      }
      idx++;
      clock += length;
    }
  }
  return idx;
}

inline uint64_t parse_ds(Reader* r, int64_t* ds_client, int64_t* ds_clock, int64_t* ds_len) {
  uint64_t idx = 0;
  uint64_t n_clients = r->varuint();
  for (uint64_t c = 0; c < n_clients && !r->fail; c++) {
    uint64_t client = r->varuint();
    uint64_t n = r->varuint();
    for (uint64_t i = 0; i < n && !r->fail; i++) {
      uint64_t clock = r->varuint();
      uint64_t len = r->varuint();
      if (ds_client != nullptr) {
        ds_client[idx] = (int64_t)client;
        ds_clock[idx] = (int64_t)clock;
        ds_len[idx] = (int64_t)len;
      }
      idx++;
    }
  }
  return idx;
}

// ---------------------------------------------------------------------------
// V1 wire encoder: mirror columns -> update bytes (the writer half of sync
// step 2 / update emission; reference encoding.js:71-116, Item.js:625-658,
// GC.js:45-48, DeleteSet.js:219-232).  Content bytes are memcpy'd from the
// source update buffers the rows were decoded from (payloads never transit
// Python), except spill rows the caller pre-encoded.
// ---------------------------------------------------------------------------

struct Writer {
  uint8_t* out;
  uint64_t cap, pos;
  bool fail;

  void u8(uint8_t b) {
    if (pos >= cap) { fail = true; return; }
    out[pos++] = b;
  }

  void varuint(uint64_t num) {
    while (num > 0x7f) {
      u8(0x80 | (num & 0x7f));
      num >>= 7;
    }
    u8((uint8_t)num);
  }

  void bytes(const uint8_t* src, uint64_t n) {
    if (n > cap - pos) { fail = true; return; }
    for (uint64_t i = 0; i < n; i++) out[pos + i] = src[i];
    pos += n;
  }
};

// content-source kinds (matches yjs_tpu/native/__init__.py encode wrapper)
constexpr int64_t kSrcNone = 0;      // GC row: no content bytes
constexpr int64_t kSrcDeleted = 1;   // ContentDeleted: varuint(len - offset)
constexpr int64_t kSrcFramed = 2;    // V1-framed bytes, memcpy (offset == 0)
constexpr int64_t kSrcUtf8 = 3;      // raw UTF-8 string bytes -> var_string
constexpr int64_t kSrcSpill = 4;     // caller-framed bytes, offset applied
// element ranges from the native plan core (plancore.cpp): `length`
// elements at [ofs,end); encode emits varuint(length-offset) + the elements
// from `offset` on (ContentAny lib0 any values / ContentJSON var_strings)
constexpr int64_t kSrcAnys = 5;
constexpr int64_t kSrcJsons = 6;

// write a var_string from raw UTF-8, skipping `offset` UTF-16 units; a cut
// landing inside a surrogate pair (4-byte char) emits U+FFFD for the lone
// low surrogate, exactly like the Python u16 wire encode (lib0/u16.py)
inline void write_cut_string(Writer* w, const uint8_t* s, uint64_t blen,
                      int64_t offset) {
  uint64_t i = 0;
  bool mid_pair = false;
  int64_t skipped = 0;
  while (skipped < offset && i < blen) {
    uint8_t b = s[i];
    if (b < 0x80) { skipped += 1; i += 1; }
    else if (b < 0xE0) { skipped += 1; i += 2; }
    else if (b < 0xF0) { skipped += 1; i += 3; }
    else {
      if (skipped + 2 <= offset) { skipped += 2; i += 4; }
      else {  // cut lands between the pair's units
        skipped += 2;  // consume the char; emit replacement low half
        i += 4;
        mid_pair = true;
      }
    }
  }
  uint64_t body = blen - i;
  w->varuint(body + (mid_pair ? 3 : 0));
  if (mid_pair) { w->u8(0xEF); w->u8(0xBF); w->u8(0xBD); }
  w->bytes(s + i, body);
}

}  // namespace ytpu_wire
