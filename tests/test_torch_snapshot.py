"""The cases of the JAX package's ``tests/test_snapshot.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``.

Snapshots (scenarios modeled on reference tests/snapshot.tests.js)."""

import yjs_tpu_torch as Y


def test_basic_restore_snapshot():
    doc = Y.Doc(gc=False)
    doc.get_array("array").insert(0, ["hello"])
    snap = Y.snapshot(doc)
    doc.get_array("array").insert(1, ["world"])
    doc_restored = Y.create_doc_from_snapshot(doc, snap)
    assert doc_restored.get_array("array").to_json() == ["hello"]
    assert doc.get_array("array").to_json() == ["hello", "world"]


def test_empty_restore_snapshot():
    doc = Y.Doc(gc=False)
    snap = Y.snapshot(doc)
    snap.sv[9999] = 0
    doc.get_array("array").insert(0, ["world"])
    doc_restored = Y.create_doc_from_snapshot(doc, snap)
    assert doc_restored.get_array("array").to_json() == []
    # now this snapshot reflects the latest state; should still work
    snap2 = Y.snapshot(doc)
    doc_restored2 = Y.create_doc_from_snapshot(doc, snap2)
    assert doc_restored2.get_array("array").to_json() == ["world"]


def test_restore_snapshot_with_subtype():
    doc = Y.Doc(gc=False)
    doc.get_array("array").insert(0, [Y.YText("when")])
    snap = Y.snapshot(doc)
    doc.get_array("array").get(0).insert(0, "out ")
    doc_restored = Y.create_doc_from_snapshot(doc, snap)
    assert [t.to_string() for t in doc_restored.get_array("array").to_array()] == ["when"]
    assert [t.to_string() for t in doc.get_array("array").to_array()] == ["out when"]


def test_restore_deleted_item():
    doc = Y.Doc(gc=False)
    doc.get_array("array").insert(0, ["item1", "item2"])
    snap = Y.snapshot(doc)
    doc.get_array("array").delete(0)
    doc_restored = Y.create_doc_from_snapshot(doc, snap)
    assert doc_restored.get_array("array").to_json() == ["item1", "item2"]


def test_restore_left_item():
    doc = Y.Doc(gc=False)
    doc.get_array("array").insert(0, ["item1"])
    doc.get_map("map").set("test", "ok")
    doc.get_array("array").insert(0, ["item0"])
    snap = Y.snapshot(doc)
    doc.get_array("array").insert(0, ["item-1"])
    doc_restored = Y.create_doc_from_snapshot(doc, snap)
    assert doc_restored.get_array("array").to_json() == ["item0", "item1"]
    assert doc_restored.get_map("map").get("test") == "ok"


def test_ydoc_snapshot_visibility_text():
    doc = Y.Doc(gc=False)
    text = doc.get_text("text")
    text.insert(0, "world!")
    snapshot1 = Y.snapshot(doc)
    text.insert(0, "hello ")
    snapshot2 = Y.snapshot(doc)
    text.delete(0, 5)
    # render with two-snapshot diff + ychange attribution
    delta = text.to_delta(snapshot2, snapshot1)
    assert any(
        op.get("attributes", {}).get("ychange", {}).get("type") == "added"
        for op in delta
    )
    state1 = text.to_delta(snapshot1)
    assert state1 == [{"insert": "world!"}]
    state2 = text.to_delta(snapshot2)
    assert state2 == [{"insert": "hello world!"}]


def test_snapshot_encoding_roundtrip():
    doc = Y.Doc(gc=False)
    doc.get_text("t").insert(0, "abc")
    doc.get_text("t").delete(1, 1)
    snap = Y.snapshot(doc)
    for enc, dec in (
        (Y.encode_snapshot, Y.decode_snapshot),
        (Y.encode_snapshot_v2, Y.decode_snapshot_v2),
    ):
        restored = dec(enc(snap))
        assert Y.equal_snapshots(snap, restored)


def test_is_visible():
    doc = Y.Doc(gc=False)
    text = doc.get_text("t")
    text.insert(0, "abc")
    snap = Y.snapshot(doc)
    text.insert(3, "later")
    item = text._start
    assert Y.is_visible(item, snap)
    assert Y.is_visible(item, None) == (not item.deleted)


def test_deleted_items_base():
    """(reference snapshot.tests.js testDeletedItemsBase)."""
    doc = Y.Doc(gc=False)
    doc.get_array("array").insert(0, ["item1"])
    doc.get_array("array").delete(0, 1)
    snap = Y.snapshot(doc)
    doc.get_array("array").insert(0, ["item0"])
    restored = Y.create_doc_from_snapshot(doc, snap)
    assert restored.get_array("array").to_array() == []
    assert doc.get_array("array").to_array() == ["item0"]


def test_deleted_items_2():
    """(reference snapshot.tests.js testDeletedItems2)."""
    doc = Y.Doc(gc=False)
    doc.get_array("array").insert(0, ["item1", "item2", "item3"])
    doc.get_array("array").delete(1, 1)
    snap = Y.snapshot(doc)
    doc.get_array("array").insert(0, ["item0"])
    restored = Y.create_doc_from_snapshot(doc, snap)
    assert restored.get_array("array").to_array() == ["item1", "item3"]
    assert doc.get_array("array").to_array() == ["item0", "item1", "item3"]


def test_dependent_changes(rng):
    """(reference snapshot.tests.js testDependentChanges)."""
    from torch_helpers import init

    result = init(rng, users=2)
    array0, array1 = result["array0"], result["array1"]
    tcn = result["testConnector"]
    array0.doc.gc = False
    array1.doc.gc = False
    array0.insert(0, ["user1item1"])
    tcn.sync_all()
    array1.insert(1, ["user2item1"])
    tcn.sync_all()
    snap = Y.snapshot(array0.doc)
    array0.insert(2, ["user1item2"])
    tcn.sync_all()
    array1.insert(3, ["user2item2"])
    tcn.sync_all()
    restored0 = Y.create_doc_from_snapshot(array0.doc, snap)
    assert restored0.get_array("array").to_array() == [
        "user1item1", "user2item1"
    ]
    restored1 = Y.create_doc_from_snapshot(array1.doc, snap)
    assert restored1.get_array("array").to_array() == [
        "user1item1", "user2item1"
    ]
