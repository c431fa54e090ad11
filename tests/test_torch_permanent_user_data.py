"""The cases of the JAX package's ``tests/test_permanent_user_data.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``,
every engine and provider on the CPU (``device="cpu"``, the
kernels' plain versions).

PermanentUserData + the content-ref dispatch table (reference
tests/encoding.tests.js testPermanentUserData / testStructReferences)."""

import yjs_tpu_torch as Y
from yjs_tpu_torch.core import (
    content_refs,
    read_content_any,
    read_content_binary,
    read_content_deleted,
    read_content_doc,
    read_content_embed,
    read_content_format,
    read_content_json,
    read_content_string,
    read_content_type,
)


def test_struct_references():
    """The wire content-ref table wiring (reference encoding.tests.js
    testStructReferences): ref N must dispatch to the right reader, or
    every udpate with that content kind decodes as garbage."""
    assert len(content_refs) == 10
    assert content_refs[1] is read_content_deleted
    assert content_refs[2] is read_content_json
    assert content_refs[3] is read_content_binary
    assert content_refs[4] is read_content_string
    assert content_refs[5] is read_content_embed
    assert content_refs[6] is read_content_format
    assert content_refs[7] is read_content_type
    assert content_refs[8] is read_content_any
    assert content_refs[9] is read_content_doc


def test_permanent_user_data():
    """(reference encoding.tests.js testPermanentUserData)."""
    ydoc1 = Y.Doc(gc=False)
    ydoc2 = Y.Doc(gc=False)
    pd1 = Y.PermanentUserData(ydoc1)
    pd2 = Y.PermanentUserData(ydoc2)
    pd1.set_user_mapping(ydoc1, ydoc1.client_id, "user a")
    pd2.set_user_mapping(ydoc2, ydoc2.client_id, "user b")
    ydoc1.get_text("").insert(0, "xhi")
    ydoc1.get_text("").delete(0, 1)
    ydoc2.get_text("").insert(0, "hxxi")
    ydoc2.get_text("").delete(1, 2)
    Y.apply_update(ydoc2, Y.encode_state_as_update(ydoc1))
    Y.apply_update(ydoc1, Y.encode_state_as_update(ydoc2))

    # user lookup by live client id and by deleted-item id
    assert pd1.get_user_by_client_id(ydoc1.client_id) == "user a"
    assert pd1.get_user_by_client_id(ydoc2.client_id) == "user b"
    from yjs_tpu_torch.core import create_delete_set_from_struct_store
    from yjs_tpu_torch.ids import create_id

    ds = create_delete_set_from_struct_store(ydoc1.store)
    del_item = ds.clients[ydoc1.client_id][0]
    assert (
        pd1.get_user_by_deleted_id(
            create_id(ydoc1.client_id, del_item.clock)
        )
        == "user a"
    )
    # the remote peer's deletions arrived as an encoded DeleteSet through
    # the users-map observer — attribute them to "user b" on doc1's side
    del_item_b = ds.clients[ydoc2.client_id][0]
    assert (
        pd1.get_user_by_deleted_id(
            create_id(ydoc2.client_id, del_item_b.clock)
        )
        == "user b"
    )

    # a third doc synced from doc1 re-attaches under the same name
    ydoc3 = Y.Doc(gc=False)
    Y.apply_update(ydoc3, Y.encode_state_as_update(ydoc1))
    pd3 = Y.PermanentUserData(ydoc3)
    pd3.set_user_mapping(ydoc3, ydoc3.client_id, "user a")
    assert pd3.get_user_by_client_id(ydoc1.client_id) == "user a"


def test_engine_room_user_data_parity():
    """Engine-path attribution: clients maintain PermanentUserData in
    the room as usual; the provider answers user_by_client_id /
    user_by_deleted_id from mirror columns and must agree with a CPU
    PermanentUserData fed the same traffic."""
    from yjs_tpu_torch.provider import TpuProvider

    # two editing clients, each with its own PUD mapping
    d1 = Y.Doc(gc=False)
    d1.client_id = 71
    d2 = Y.Doc(gc=False)
    d2.client_id = 72
    pd1 = Y.PermanentUserData(d1)
    pd1.set_user_mapping(d1, d1.client_id, "alice")
    pd2 = Y.PermanentUserData(d2)
    pd2.set_user_mapping(d2, d2.client_id, "bob")

    def sync():
        u1 = Y.encode_state_as_update(d1, Y.encode_state_vector(d2))
        u2 = Y.encode_state_as_update(d2, Y.encode_state_vector(d1))
        Y.apply_update(d2, u1)
        Y.apply_update(d1, u2)

    sync()
    d1.get_text("text").insert(0, "alice writes. ")
    sync()
    d2.get_text("text").insert(0, "bob writes. ")
    sync()
    # alice deletes bob's prefix; bob deletes part of alice's text
    d1.get_text("text").delete(0, 4)   # "bob "
    sync()
    d2.get_text("text").delete(0, 8)   # "writes. "
    sync()

    # server room receives everything
    prov = TpuProvider(n_docs=2, device="cpu")
    prov.receive_update("room", Y.encode_state_as_update(d1))
    prov.flush()
    assert prov.engine.fallback == {}, prov.engine.demotions
    rud = prov.user_data("room")

    # CPU oracle on a third replica
    cpu = Y.Doc(gc=False)
    oracle = Y.PermanentUserData(cpu)
    Y.apply_update(cpu, Y.encode_state_as_update(d1))

    assert rud.user_by_client_id(71) == oracle.get_user_by_client_id(71) == "alice"
    assert rud.user_by_client_id(72) == oracle.get_user_by_client_id(72) == "bob"
    assert rud.user_by_client_id(999) is None

    # attribution of every deleted id agrees with the oracle, and both
    # deleters actually show up (the test is vacuous otherwise)
    seen = set()
    for client, dels in cpu.store.clients.items():
        for s in dels:
            if s.deleted:
                for clk in (s.id.clock, s.id.clock + s.length - 1):
                    who_cpu = oracle.get_user_by_deleted_id(
                        Y.createID(client, clk)
                    )
                    who_eng = rud.user_by_deleted_id(Y.createID(client, clk))
                    assert who_eng == who_cpu, (client, clk, who_eng, who_cpu)
                    if who_cpu:
                        seen.add(who_cpu)
    assert seen == {"alice", "bob"}

    # late traffic invalidates the cache: a new mapping becomes visible
    d3 = Y.Doc(gc=False)
    d3.client_id = 73
    Y.apply_update(d3, Y.encode_state_as_update(d1))
    pd3 = Y.PermanentUserData(d3)
    pd3.set_user_mapping(d3, 73, "carol")
    prov.receive_update(
        "room", Y.encode_state_as_update(d3, Y.encode_state_vector(d1))
    )
    prov.flush()
    assert rud.user_by_client_id(73) == "carol"


def test_engine_room_user_data_delete_only_update():
    """Regression: a DELETE-ONLY update must invalidate the RoomUserData
    cache.  Deleting the users-map entry removes the
    attribution from the live-state view (documented deviation: the
    reference's observer dicts never forget)."""
    from yjs_tpu_torch.provider import TpuProvider

    d = Y.Doc(gc=False)
    d.client_id = 81
    pd = Y.PermanentUserData(d)
    pd.set_user_mapping(d, 81, "dave")
    prov = TpuProvider(n_docs=1, device="cpu")
    prov.receive_update("room", Y.encode_state_as_update(d))
    prov.flush()
    rud = prov.user_data("room")
    assert rud.user_by_client_id(81) == "dave"
    # delete-only update authored on a PUD-free replica (the reference's
    # own observer crashes on users-entry deletion — @experimental): the
    # room must still see the removal
    d2 = Y.Doc(gc=False)
    d2.client_id = 82
    Y.apply_update(d2, Y.encode_state_as_update(d))
    sv = Y.encode_state_vector(d2)
    d2.get_map("users").delete("dave")
    prov.receive_update("room", Y.encode_state_as_update(d2, sv))
    prov.flush()
    assert prov.engine.fallback == {}
    assert rud.user_by_client_id(81) is None  # stale cache would say "dave"
