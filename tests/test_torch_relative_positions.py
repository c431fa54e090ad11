"""The cases of the JAX package's ``tests/test_relative_positions.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions).

Relative positions (scenarios modeled on reference README examples and
RelativePosition.js behavior)."""

import yjs_tpu_torch as Y


def _check_rel_pos(text, rpos, expected_index):
    apos = Y.create_absolute_position_from_relative_position(rpos, text.doc)
    assert apos is not None
    assert apos.type is text
    assert apos.index == expected_index


def test_rel_pos_survives_inserts():
    doc = Y.Doc()
    text = doc.get_text("t")
    text.insert(0, "abc")
    rpos = Y.create_relative_position_from_type_index(text, 2)
    text.insert(0, "xxx")
    _check_rel_pos(text, rpos, 5)
    text.delete(0, 1)
    _check_rel_pos(text, rpos, 4)


def test_rel_pos_end_of_type():
    doc = Y.Doc()
    text = doc.get_text("t")
    text.insert(0, "ab")
    rpos = Y.create_relative_position_from_type_index(text, 2)
    text.insert(2, "cd")
    _check_rel_pos(text, rpos, 4)


def test_rel_pos_codec_roundtrip():
    doc = Y.Doc()
    text = doc.get_text("t")
    text.insert(0, "hello")
    for index in (0, 2, 5):
        rpos = Y.create_relative_position_from_type_index(text, index)
        decoded = Y.decode_relative_position(Y.encode_relative_position(rpos))
        # note: when `item` is set, the codec intentionally drops tname/type
        # (reference RelativePosition.js:145-160), so compare against a
        # re-encoded copy rather than the original
        decoded2 = Y.decode_relative_position(Y.encode_relative_position(decoded))
        assert Y.compare_relative_positions(decoded, decoded2)
        _check_rel_pos(text, decoded, index)


def test_rel_pos_from_json():
    doc = Y.Doc()
    text = doc.get_text("t")
    text.insert(0, "hello")
    rpos = Y.create_relative_position_from_type_index(text, 3)
    rpos2 = Y.create_relative_position_from_json(rpos.to_json())
    assert Y.compare_relative_positions(rpos, rpos2)


def test_rel_pos_deleted_target():
    doc = Y.Doc()
    text = doc.get_text("t")
    text.insert(0, "abcdef")
    rpos = Y.create_relative_position_from_type_index(text, 3)
    text.delete(2, 3)
    apos = Y.create_absolute_position_from_relative_position(rpos, doc)
    assert apos is not None
    assert apos.index == 2


def test_rel_pos_missing_client_returns_none():
    doc = Y.Doc()
    text = doc.get_text("t")
    text.insert(0, "ab")
    rpos = Y.create_relative_position_from_type_index(text, 1)
    other = Y.Doc()
    other.get_text("t")
    assert Y.create_absolute_position_from_relative_position(rpos, other) is None


# ---------------------------------------------------------------------------
# Engine-path cursors: create/resolve straight from mirror columns,
# parity-pinned against the CPU reference path under concurrent edits,
# compaction, and undo/redo (redone chains).
# ---------------------------------------------------------------------------

import random

from yjs_tpu_torch.ops import BatchEngine
from yjs_tpu_torch.provider import TpuProvider


def _two_client_conflict_doc(seed=7, n_ops=120):
    """Two clients typing/deleting concurrently with periodic syncs;
    returns (merged_update, reference_doc)."""
    gen = random.Random(seed)
    a = Y.Doc(gc=False)
    a.client_id = 101
    b = Y.Doc(gc=False)
    b.client_id = 202

    def sync():
        ua = Y.encode_state_as_update(a, Y.encode_state_vector(b))
        ub = Y.encode_state_as_update(b, Y.encode_state_vector(a))
        Y.apply_update(b, ua)
        Y.apply_update(a, ub)

    for _ in range(n_ops):
        d = a if gen.random() < 0.5 else b
        t = d.get_text("text")
        ln = len(t.to_string())
        if gen.random() < 0.7 or ln == 0:
            t.insert(gen.randint(0, ln), gen.choice(["ab", "c", "def ", "🙂"]))
        else:
            pos = gen.randrange(ln)
            t.delete(pos, min(gen.randint(1, 3), ln - pos))
        if gen.random() < 0.25:
            sync()
    sync()
    return Y.encode_state_as_update(a), a


def _assert_rpos_equal(ra, rb):
    assert ra.tname == rb.tname
    assert Y.compare_ids(ra.item, rb.item)
    assert Y.compare_ids(ra.type, rb.type)


def test_engine_cursor_create_resolve_parity():
    update, ref = _two_client_conflict_doc()
    eng = BatchEngine(1, device="cpu")
    eng.queue_update(0, update)
    eng.flush()
    text = ref.get_text("text")
    n = len(text.to_string())
    rposes = []
    for i in range(0, n + 1):
        rc = Y.create_relative_position_from_type_index(text, i)
        re_ = eng.relative_position_from_index(0, i, "text")
        _assert_rpos_equal(rc, re_)
        rposes.append(rc)
        # resolve immediately: same index back on both paths
        a = Y.create_absolute_position_from_relative_position(rc, ref)
        assert a is not None and a.index == i
        assert eng.absolute_index_from_relative(0, rc) == i


def test_engine_cursor_survives_concurrent_edits():
    update, ref = _two_client_conflict_doc(seed=13)
    eng = BatchEngine(1, device="cpu")
    eng.queue_update(0, update)
    eng.flush()
    text = ref.get_text("text")
    n = len(text.to_string())
    step = max(1, n // 17)
    rposes = [
        Y.create_relative_position_from_type_index(text, i)
        for i in range(0, n + 1, step)
    ]
    # a second wave of concurrent edits (insert before/after anchors,
    # delete ranges covering some anchors) applied to both replicas
    c = Y.Doc(gc=False)
    c.client_id = 303
    Y.apply_update(c, update)
    t2 = c.get_text("text")
    gen = random.Random(99)
    for _ in range(60):
        ln = len(t2.to_string())
        if gen.random() < 0.6 or ln == 0:
            t2.insert(gen.randint(0, ln), gen.choice(["XX", "y", "zz "]))
        else:
            pos = gen.randrange(ln)
            t2.delete(pos, min(gen.randint(1, 4), ln - pos))
    wave = Y.encode_state_as_update(c, Y.encode_state_vector(ref))
    Y.apply_update(ref, wave)
    eng.queue_update(0, wave)
    eng.flush()
    assert eng.text(0) == ref.get_text("text").to_string()
    for rp in rposes:
        a = Y.create_absolute_position_from_relative_position(rp, ref)
        got = eng.absolute_index_from_relative(0, rp)
        assert a is not None
        assert got == a.index, (rp.to_json(), got, a.index)


def test_engine_cursor_post_compaction():
    # low compaction threshold: the flush after the second wave rebuilds
    # the mirror's rows; anchors inside MERGED runs must still resolve
    update, ref = _two_client_conflict_doc(seed=21)
    eng = BatchEngine(1, gc=False, compact_min_rows=4, device="cpu")
    eng.queue_update(0, update)
    eng.flush()
    text = ref.get_text("text")
    n = len(text.to_string())
    rposes = [
        Y.create_relative_position_from_type_index(text, i)
        for i in range(0, n + 1, max(1, n // 11))
    ]
    # more traffic to trigger another compaction cycle
    c = Y.Doc(gc=False)
    c.client_id = 404
    Y.apply_update(c, update)
    for k in range(40):
        t2 = c.get_text("text")
        t2.insert(len(t2.to_string()), f"tail{k} ")
    wave = Y.encode_state_as_update(c, Y.encode_state_vector(ref))
    Y.apply_update(ref, wave)
    eng.queue_update(0, wave)
    eng.flush()
    assert eng.last_compaction, "compaction must have run for this test"
    assert eng.text(0) == ref.get_text("text").to_string()
    for rp in rposes:
        a = Y.create_absolute_position_from_relative_position(rp, ref)
        got = eng.absolute_index_from_relative(0, rp)
        assert a is not None and got == a.index
    # fresh cursors created post-compaction still match the CPU path
    for i in range(0, len(ref.get_text("text").to_string()) + 1, 7):
        rc = Y.create_relative_position_from_type_index(ref.get_text("text"), i)
        re_ = eng.relative_position_from_index(0, i, "text")
        _assert_rpos_equal(rc, re_)


def test_engine_cursor_deleted_anchor_and_end():
    a = Y.Doc(gc=False)
    a.client_id = 5
    t = a.get_text("text")
    t.insert(0, "hello world")
    u = Y.encode_state_as_update(a)
    eng = BatchEngine(1, device="cpu")
    eng.queue_update(0, u)
    eng.flush()
    # end-of-list cursor (item=None, tname case)
    rend = eng.relative_position_from_index(0, 11, "text")
    assert rend.item is None and rend.tname == "text"
    # cursor inside a range that then gets deleted -> clamps to run start
    rmid = eng.relative_position_from_index(0, 8, "text")
    t.delete(4, 6)  # delete "o worl"
    eng.queue_update(0, Y.encode_state_as_update(a))
    eng.flush()
    acpu = Y.create_absolute_position_from_relative_position(rmid, a)
    assert eng.absolute_index_from_relative(0, rmid) == acpu.index
    aend = Y.create_absolute_position_from_relative_position(rend, a)
    assert eng.absolute_index_from_relative(0, rend) == aend.index
    # unknown-client anchor resolves to None on both paths
    ghost = Y.RelativePosition(None, "text", Y.create_id(999, 0)) if hasattr(Y, "RelativePosition") else None
    if ghost is not None:
        assert eng.absolute_index_from_relative(0, ghost) is None


def test_provider_cursor_redone_chain():
    """Cursor anchored in content that is undone then redone: the
    undo-enabled room resolves through the replica's follow-redone walk
    and must agree with a pure-CPU UndoManager replay."""
    prov = TpuProvider(n_docs=2, device="cpu")
    guid = "room"
    a = Y.Doc(gc=False)
    a.client_id = 9
    a.get_text("text").insert(0, "base ")
    base = Y.encode_state_as_update(a)
    prov.receive_update(guid, base)
    prov.flush()
    prov.enable_undo(guid)
    # undoable edit adds "mark " at 0; cursor anchored inside it
    b = Y.Doc(gc=False)
    b.client_id = 10
    Y.apply_update(b, base)
    b.get_text("text").insert(0, "mark ")
    wave = Y.encode_state_as_update(b, Y.encode_state_vector(a))
    prov.receive_update(guid, wave, undoable=True)
    prov.flush()
    rp = prov.create_relative_position(guid, 2)  # inside "mark "
    assert prov.resolve_relative_position(guid, rp) == 2
    # CPU twin: same updates + same undo/redo sequence via UndoManager
    cpu = Y.Doc(gc=False)
    Y.apply_update(cpu, base)
    um = Y.UndoManager(cpu.get_text("text"), capture_timeout=0,
                       tracked_origins={"remote"})
    cpu.transact(lambda tr: Y.apply_update(cpu, wave, "remote"), "remote")
    rev = prov.undo(guid)
    assert rev is not None
    um.undo()
    prov.flush()
    rev2 = prov.redo(guid)
    assert rev2 is not None
    um.redo()
    prov.flush()
    assert prov.text(guid) == cpu.get_text("text").to_string()
    got = prov.resolve_relative_position(guid, rp)
    acpu = Y.create_absolute_position_from_relative_position(rp, cpu)
    # follow-redone lands the cursor back inside the redone "mark "
    assert acpu is not None and got == acpu.index == 2
    # contrast: the pure-mirror path has no redone chains (they are
    # replica-local, never on the wire) and resolves past the tombstoned
    # original instead — the documented deviation this test pins
    assert prov.engine.absolute_index_from_relative(0, rp) == 5
