"""The cases of the JAX package's ``tests/test_native.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Native C++ transcoder vs the pure-Python decoder: byte-exact metadata
equivalence on updates exercising every content kind, plus fallback."""

import pytest

import yjs_tpu_torch as Y
from yjs_tpu_torch.ops.columns import (
    LazyContent,
    LazyContentV2,
    _decode_update_refs_native,
    _decode_update_refs_native_v2,
    decode_update_refs,
)
from yjs_tpu_torch import native


requires_native = pytest.mark.skipif(
    native.load() is None, reason="native transcoder not built"
)


def python_decode(update, v2=False):
    """Force the pure-Python path."""
    import yjs_tpu_torch.native as nat

    old_lib, old_tried = nat._lib, nat._tried
    nat._lib, nat._tried = None, True
    try:
        return decode_update_refs(update, v2)
    finally:
        nat._lib, nat._tried = old_lib, old_tried


def ref_meta(r):
    return (
        r.client, r.clock, r.length, r.origin, r.right_origin,
        r.parent_name, r.parent_id, r.parent_sub, r.content_ref, r.is_gc,
    )


def assert_equivalent(update, v2=False):
    if v2:
        refs_n, ds_n = _decode_update_refs_native_v2(update)
    else:
        refs_n, ds_n = _decode_update_refs_native(update)
    refs_p, ds_p = python_decode(update, v2)
    assert sorted(refs_n.keys()) == sorted(refs_p.keys())
    for client in refs_p:
        metas_n = [ref_meta(r) for r in refs_n[client]]
        metas_p = [ref_meta(r) for r in refs_p[client]]
        assert metas_n == metas_p
        # lazily-realized payloads must equal the eagerly-decoded ones
        for rn, rp in zip(refs_n[client], refs_p[client]):
            if isinstance(rn.content, (LazyContent, LazyContentV2)):
                cn = rn.materialize()
                assert type(cn) is type(rp.content)
                if rn.content_ref == 7:  # nested type: compare structurally
                    assert type(cn.type) is type(rp.content.type)
                    assert getattr(cn.type, "node_name", None) == getattr(
                        rp.content.type, "node_name", None
                    )
                else:
                    assert cn.get_content() == rp.content.get_content()
    assert sorted(ds_n) == sorted(ds_p)


@requires_native
class TestNativeEquivalence:
    def test_text_doc(self):
        d = Y.Doc(gc=False)
        d.client_id = 42
        t = d.get_text("text")
        t.insert(0, "hello wörld 🙂")
        t.insert(3, "XY")
        t.delete(1, 4)
        t.format(0, 3, {"bold": True})
        assert_equivalent(Y.encode_state_as_update(d))

    def test_all_content_kinds(self):
        d = Y.Doc(gc=False)
        d.client_id = 7
        arr = d.get_array("arr")
        arr.insert(0, [1, 2.5, "s", True, None, {"k": [1, 2]}, b"\x00\xff"])
        m = d.get_map("map")
        m.set("num", 3)
        m.set("nested", {"deep": {"er": [1]}})
        t = d.get_text("text")
        t.insert(0, "abc")
        t.insert(1, "🙂🙂")
        assert_equivalent(Y.encode_state_as_update(d))

    def test_xml_and_types(self):
        from yjs_tpu_torch.types.yxml import YXmlElement, YXmlText

        d = Y.Doc(gc=False)
        d.client_id = 9
        frag = d.get("xml", Y.YXmlFragment)
        el = YXmlElement("div")
        frag.insert(0, [el, YXmlText("txt")])
        el.set_attribute("class", "c1")
        assert_equivalent(Y.encode_state_as_update(d))

    def test_multi_client_with_deletes_and_gc(self):
        a = Y.Doc(gc=False)
        a.client_id = 1
        b = Y.Doc(gc=True)
        b.client_id = 2
        a.get_text("text").insert(0, "shared text")
        Y.apply_update(b, Y.encode_state_as_update(a))
        b.get_text("text").delete(2, 5)
        b.get_text("text").insert(0, "B")
        assert_equivalent(Y.encode_state_as_update(b))

    def test_garbage_rejected(self):
        from yjs_tpu_torch.native import NativeDecodeError, decode_v1_columns

        with pytest.raises(NativeDecodeError):
            decode_v1_columns(b"\x99\xfe\x03garbage")


@requires_native
class TestNativeEquivalenceV2:
    """The V2 9-stream columnar container (reference
    UpdateDecoder.js:270-293) through the native scanner."""

    def test_text_doc_v2(self):
        d = Y.Doc(gc=False)
        d.client_id = 42
        t = d.get_text("text")
        t.insert(0, "hello wörld 🙂")
        t.insert(3, "XY")
        t.delete(1, 4)
        t.format(0, 3, {"bold": True})
        assert_equivalent(Y.encode_state_as_update_v2(d), v2=True)

    def test_all_content_kinds_v2(self):
        d = Y.Doc(gc=False)
        d.client_id = 7
        arr = d.get_array("arr")
        arr.insert(0, [1, 2.5, "s", True, None, {"k": [1, 2]}, b"\x00\xff"])
        m = d.get_map("map")
        m.set("num", 3)
        m.set("nested", {"deep": {"er": [1]}})
        t = d.get_text("text")
        t.insert(0, "abc")
        t.insert(1, "🙂🙂")
        assert_equivalent(Y.encode_state_as_update_v2(d), v2=True)

    def test_xml_and_types_v2(self):
        from yjs_tpu_torch.types.yxml import YXmlElement, YXmlText

        d = Y.Doc(gc=False)
        d.client_id = 9
        frag = d.get("xml", Y.YXmlFragment)
        el = YXmlElement("div")
        frag.insert(0, [el, YXmlText("txt")])
        el.set_attribute("class", "c1")
        assert_equivalent(Y.encode_state_as_update_v2(d), v2=True)

    def test_multi_client_with_deletes_and_gc_v2(self):
        a = Y.Doc(gc=False)
        a.client_id = 1
        b = Y.Doc(gc=True)
        b.client_id = 2
        a.get_text("text").insert(0, "shared text")
        Y.apply_update(b, Y.encode_state_as_update(a))
        b.get_text("text").delete(2, 5)
        b.get_text("text").insert(0, "B")
        assert_equivalent(Y.encode_state_as_update_v2(b), v2=True)

    def test_map_key_dictionary_v2(self):
        # repeated map keys exercise the keyClock dictionary
        # (UpdateDecoder.js:382-391)
        a = Y.Doc(gc=False)
        a.client_id = 3
        b = Y.Doc(gc=False)
        b.client_id = 4
        for i in range(5):
            a.get_map("m").set("shared", i)
            b.get_map("m").set("shared", 10 + i)
            Y.apply_update(a, Y.encode_state_as_update(b))
            Y.apply_update(b, Y.encode_state_as_update(a))
        assert_equivalent(Y.encode_state_as_update_v2(a), v2=True)

    def test_subdoc_falls_back_v2(self):
        # ContentDoc payloads punt to the Python decoder (error -4)
        d = Y.Doc(gc=False)
        d.client_id = 6
        d.get_map("m").set("sub", Y.Doc(guid="child"))
        u = Y.encode_state_as_update_v2(d)
        with pytest.raises(native.NativeDecodeError):
            native.decode_v2_columns(u)
        refs, _ds = decode_update_refs(u, v2=True)  # silent fallback
        assert refs[6][0].content_ref == 9

    def test_garbage_rejected_v2(self):
        with pytest.raises(native.NativeDecodeError):
            native.decode_v2_columns(b"\x00\x01\x02junk")

    def test_key_caching_encoder_xml_names_v2(self, monkeypatch):
        # a spec-compliant encoder MAY cache keys and emit keyClock-only
        # references for repeated Xml names (readKey, YXmlElement.js:225);
        # the v13.4 reference never does (its writeKey quirk), so simulate
        # a caching writeKey and ensure the native scanner's key dictionary
        # handles it identically to the Python decoder
        from yjs_tpu_torch.coding import UpdateEncoderV2
        from yjs_tpu_torch.types.yxml import YXmlElement

        def caching_write_key(self, key):
            clock = self.key_map.get(key)
            if clock is None:
                clock = len(self.key_map)
                self.key_map[key] = clock
                self.key_clock_encoder.write(clock)
                self.string_encoder.write(key)
            else:
                self.key_clock_encoder.write(clock)

        monkeypatch.setattr(UpdateEncoderV2, "write_key", caching_write_key)
        d = Y.Doc(gc=False)
        d.client_id = 11
        frag = d.get("xml", Y.YXmlFragment)
        frag.insert(0, [YXmlElement("div"), YXmlElement("span"),
                        YXmlElement("div"), YXmlElement("div")])
        u = Y.encode_state_as_update_v2(d)
        assert_equivalent(u, v2=True)


@requires_native
class TestNativeEncode:
    """ytpu_encode_v1: the native writer must be byte-identical to the
    Python encoder for every mirror state (reference encoding.js:71-116,
    Item.js:625-658)."""

    def _python_encode(self, mirror, target_sv=None):
        import yjs_tpu_torch.native as nat

        old_lib, old_tried = nat._lib, nat._tried
        nat._lib, nat._tried = None, True
        try:
            return mirror.encode_state_as_update(target_sv)
        finally:
            nat._lib, nat._tried = old_lib, old_tried

    def _assert_byte_equal(self, mirror, target_sv=None):
        assert mirror.encode_state_as_update(target_sv) == self._python_encode(
            mirror, target_sv
        )

    @pytest.mark.parametrize("seed", range(4))
    def test_fuzz_encode_parity(self, seed):
        import random

        from yjs_tpu_torch.ops.columns import DocMirror

        gen = random.Random(7000 + seed)
        docs = []
        for i in range(3):
            d = Y.Doc(gc=False)
            d.client_id = i + 1
            docs.append(d)
        upds = []
        for d in docs:
            d.on("update", lambda u, origin, _d: upds.append(u))
        for _ in range(60):
            d = gen.choice(docs)
            op = gen.random()
            if op < 0.55:
                t = d.get_text("text")
                ln = len(t.to_string())
                if gen.random() < 0.7 or ln == 0:
                    t.insert(gen.randint(0, ln), gen.choice(["x", "🙂y", "zz "]))
                else:
                    pos = gen.randrange(ln)
                    t.delete(pos, min(gen.randint(1, 3), ln - pos))
            elif op < 0.85:
                d.get_map("map").set(gen.choice("abc"), gen.randrange(50))
            else:
                d.get_array("arr").insert(0, [gen.randrange(9), "s"])
            if gen.random() < 0.3:
                src, dst = gen.choice(docs), gen.choice(docs)
                for u in upds:
                    Y.apply_update(dst, u)
        v2 = gen.random() < 0.5
        mirror = DocMirror("text", device="cpu")
        merged = (Y.encode_state_as_update_v2 if v2 else Y.encode_state_as_update)(
            docs[0]
        )
        mirror.ingest(merged, v2=v2)
        mirror.prepare_step()
        self._assert_byte_equal(mirror)
        # diff against a random partial state vector (offset cuts)
        full_sv = mirror.state_vector()
        partial = {c: gen.randint(0, v) for c, v in full_sv.items()}
        self._assert_byte_equal(mirror, partial)
        # the emitted update reproduces the doc
        d2 = Y.Doc(gc=False)
        Y.apply_update(d2, mirror.encode_state_as_update())
        assert d2.get_text("text").to_string() == docs[0].get_text("text").to_string()
        assert d2.get_map("map").to_json() == docs[0].get_map("map").to_json()

    def test_fallback_when_disabled(self, monkeypatch):
        d = Y.Doc(gc=False)
        d.client_id = 3
        d.get_text("text").insert(0, "plain")
        refs, ds = python_decode(Y.encode_state_as_update(d))
        assert refs[3][0].length == 5


def test_wide_key_dictionary_stays_native():
    """>4096 distinct map keys ride the native V2 scan without demotion
    (the old fixed key-table cap silently demoted wide docs; ADVICE r3)."""
    import yjs_tpu_torch as Y
    from torch_service import BatchEngine

    d = Y.Doc(gc=False)
    m = d.get_map("meta")
    for i in range(4200):
        m.set(f"key{i}", i)
    eng = BatchEngine(1, root_name="meta")
    eng.queue_update(0, Y.encode_state_as_update_v2(d), v2=True)
    eng.flush()
    assert eng.demotions == []
    assert eng.map_json(0, "meta") == m.to_json()


def test_malformed_utf8_matches_python_error(monkeypatch):
    """Adversarial bytes with invalid UTF-8 continuations must raise the
    same error the Python decoder raises — not silently miscount on the
    native path (ADVICE r3: continuation-byte validation).

    Strict mode: by default the resilience layer isolates a poisoned doc
    instead of raising, so disable it to assert raw error-type parity
    (the isolation-path contract is covered by tests/test_resilience.py).
    """
    import pytest

    import yjs_tpu_torch as Y
    from torch_service import BatchEngine

    monkeypatch.setenv("YTPU_RESILIENCE_DISABLED", "1")

    base = Y.Doc(gc=False)
    base.get_text("text").insert(0, "AAAA")
    u = bytearray(Y.encode_state_as_update(base))
    pos = bytes(u).find(b"AAAA")
    u[pos] = 0xE2   # 3-byte lead ...
    u[pos + 1] = 0x28  # ... with an invalid continuation byte
    with pytest.raises(Exception) as py_err:
        ref = Y.Doc(gc=False)
        Y.apply_update(ref, bytes(u))
    eng = BatchEngine(1)
    eng.queue_update(0, bytes(u))
    with pytest.raises(Exception) as nat_err:
        eng.flush()
    assert type(nat_err.value) is type(py_err.value)
