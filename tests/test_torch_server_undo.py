"""The cases of the JAX package's ``tests/test_server_undo.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions; ``tests/torch_service.py``).

Server-side undo for device-resident rooms (utils/server_undo.py +
TpuProvider.enable_undo/undo/redo) — parity-pinned against a pure-CPU
doc driving the reference-exact UndoManager (utils/undo.py, the twin of
src/utils/UndoManager.js:19-296)."""

import yjs_tpu_torch as Y
from torch_service import TpuProvider
from yjs_tpu_torch.utils.undo import UndoManager


def _client_edit(doc, sv, fn):
    """Apply ``fn`` to a client doc, return (incremental update, new sv)."""
    fn(doc)
    u = Y.encode_state_as_update(doc, sv)
    return u, Y.encode_state_vector(doc)


def test_provider_undo_basic():
    prov = TpuProvider(n_docs=2)
    prov.enable_undo("room")
    c = Y.Doc(gc=False)
    sv = None
    u, sv = _client_edit(c, sv, lambda d: d.get_text("text").insert(0, "hello"))
    prov.receive_update("room", u, undoable=True)
    u, sv = _client_edit(c, sv, lambda d: d.get_text("text").insert(5, " world"))
    prov.receive_update("room", u, undoable=True)
    prov.flush()
    assert prov.text("room") == "hello world"

    undo_u = prov.undo("room")
    assert undo_u is not None
    # both edits landed within one capture window, so they merged into a
    # single stack item and undo reverts both (reference
    # UndoManager.js:199-205 merge rule)
    assert prov.text("room") == ""

    redo_u = prov.redo("room")
    assert redo_u is not None
    assert prov.text("room") == "hello world"
    # the returned updates replay identically on any peer
    peer = Y.Doc(gc=False)
    Y.apply_update(peer, prov.encode_state_as_update("room"))
    assert peer.get_text("text").to_string() == "hello world"


def test_provider_undo_capture_timeout_zero_separates_items():
    prov = TpuProvider(n_docs=1)
    prov.enable_undo("r", capture_timeout=0)
    c = Y.Doc(gc=False)
    sv = None
    for word in ("a", "b", "c"):
        u, sv = _client_edit(
            c, sv, lambda d, w=word: d.get_text("text").insert(
                len(d.get_text("text").to_string()), w
            )
        )
        prov.receive_update("r", u, undoable=True)
    prov.flush()
    assert prov.text("r") == "abc"
    prov.undo("r")
    assert prov.text("r") == "ab"
    prov.undo("r")
    assert prov.text("r") == "a"
    prov.redo("r")
    assert prov.text("r") == "ab"
    prov.undo("r")
    assert prov.text("r") == "a"
    prov.undo("r")
    assert prov.text("r") == ""
    assert prov.undo("r") is None  # stack exhausted


def test_provider_undo_does_not_revert_foreign_edits():
    """Undo must only revert tracked-origin changes — a second client's
    concurrent edits survive (reference trackedOrigins filter)."""
    prov = TpuProvider(n_docs=1)
    prov.enable_undo("r", capture_timeout=0)
    a = Y.Doc(gc=False)
    b = Y.Doc(gc=False)
    a.client_id, b.client_id = 1, 2
    ua, sva = _client_edit(a, None, lambda d: d.get_text("text").insert(0, "AAA"))
    prov.receive_update("r", ua, undoable=True)
    Y.apply_update(b, ua)
    ub, svb = _client_edit(b, None, lambda d: d.get_text("text").insert(3, "BBB"))
    prov.receive_update("r", ub, undoable=False)  # foreign client
    prov.flush()
    assert prov.text("r") == "AAABBB"
    prov.undo("r")
    assert prov.text("r") == "BBB"  # only A's edit reverted
    prov.redo("r")
    assert prov.text("r") == "AAABBB"


def test_server_undo_parity_with_cpu_undo_manager():
    """The room's undo/redo sequence lands on the same text as a pure-CPU
    doc driving the reference UndoManager over the same edits."""
    # CPU oracle: one doc, local edits through an UndoManager
    oracle = Y.Doc(gc=False)
    oracle.client_id = 7
    text = oracle.get_text("text")
    um = UndoManager(text, capture_timeout=0, tracked_origins={"me"})

    prov = TpuProvider(n_docs=1)
    prov.enable_undo("r", capture_timeout=0)
    sv = None
    client = Y.Doc(gc=False)
    client.client_id = 7

    def step(fn):
        nonlocal sv
        oracle.transact(lambda _t: fn(text), "me")
        fn2u, _ = _client_edit(client, sv, lambda d: fn(d.get_text("text")))
        sv = Y.encode_state_vector(client)
        prov.receive_update("r", fn2u, undoable=True)

    step(lambda t: t.insert(0, "one "))
    step(lambda t: t.insert(4, "two "))
    step(lambda t: t.delete(0, 2))
    step(lambda t: t.format(0, 3, {"bold": True}))
    prov.flush()
    assert prov.text("r") == text.to_string()

    for op in ("undo", "undo", "redo", "undo", "undo", "undo", "redo"):
        getattr(um, op)()
        getattr(prov, op)("r")
        assert prov.text("r") == text.to_string(), op
        assert prov.to_delta("r") == text.to_delta(), op


def test_provider_undo_embeds_and_deletes():
    """Undo of embeds + deletions (reference undo-redo.tests.js scenarios)."""
    prov = TpuProvider(n_docs=1)
    prov.enable_undo("r", capture_timeout=0)
    c = Y.Doc(gc=False)
    sv = None
    u, sv = _client_edit(
        c, sv, lambda d: d.get_text("text").insert_embed(
            0, {"image": "x.png"}
        )
    )
    prov.receive_update("r", u, undoable=True)
    u, sv = _client_edit(c, sv, lambda d: d.get_text("text").insert(1, "cap"))
    prov.receive_update("r", u, undoable=True)
    prov.flush()
    assert prov.to_delta("r") == [
        {"insert": {"image": "x.png"}},
        {"insert": "cap"},
    ]
    prov.undo("r")
    assert prov.to_delta("r") == [{"insert": {"image": "x.png"}}]
    prov.undo("r")
    assert prov.to_delta("r") == []
    prov.redo("r")
    assert prov.to_delta("r") == [{"insert": {"image": "x.png"}}]
