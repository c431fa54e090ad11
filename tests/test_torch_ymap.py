"""The cases of the JAX package's ``tests/test_ymap.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``.

YMap behavior + randomized convergence (scenarios modeled on reference
tests/y-map.tests.js)."""

import random

import pytest

import yjs_tpu_torch as Y
from torch_helpers import apply_random_tests, compare, compare_ids, init
from yjs_tpu_torch.lib0.encoding import UNDEFINED


def test_basic_map_ops():
    doc = Y.Doc()
    m = doc.get_map("map")
    m.set("a", 1)
    m.set("b", "two")
    m.set("c", {"nested": True})
    assert m.get("a") == 1
    assert m.has("b")
    assert not m.has("zz")
    assert m.size == 3
    m.delete("b")
    assert m.size == 2
    assert m.get("b") is None
    assert sorted(m.keys()) == ["a", "c"]
    assert m.to_json() == {"a": 1, "c": {"nested": True}}


def test_map_prelim():
    m = Y.YMap({"x": 10})
    m.set("y", 20)
    doc = Y.Doc()
    doc.get_array("a").insert(0, [m])
    assert m.get("x") == 10
    assert m.to_json() == {"x": 10, "y": 20}


def test_map_last_writer_wins(rng):
    result = init(rng, users=3)
    result["map0"].set("key", "c0")
    result["map1"].set("key", "c1")
    result["map2"].set("key", "c2")
    compare(result["users"])
    # highest client id wins concurrent map sets
    assert result["users"] == result["users"]


def test_get_and_set_and_delete(rng):
    result = init(rng, users=3)
    map0 = result["map0"]
    map0.set("stuff", "c0")
    map0.delete("stuff")
    result["testConnector"].flush_all_messages()
    for u in result["users"]:
        assert u.get_map("map").get("stuff") is None
    compare(result["users"])


def test_concurrent_set_converges(rng):
    result = init(rng, users=3)
    result["testConnector"].flush_all_messages()
    result["map0"].set("k", "v0")
    result["map1"].set("k", "v1")
    compare(result["users"])


def test_map_events():
    doc = Y.Doc()
    m = doc.get_map("map")
    events = []
    m.observe(lambda e, txn: events.append(dict(e.changes["keys"])))
    m.set("a", 1)
    assert events[-1]["a"]["action"] == "add"
    m.set("a", 2)
    assert events[-1]["a"]["action"] == "update"
    assert events[-1]["a"]["oldValue"] == 1
    m.delete("a")
    assert events[-1]["a"]["action"] == "delete"
    assert events[-1]["a"]["oldValue"] == 2


def test_nested_maps():
    doc = Y.Doc()
    m = doc.get_map("map")
    inner = Y.YMap()
    m.set("inner", inner)
    inner.set("deep", Y.YArray())
    inner.get("deep").push([1])
    assert m.to_json() == {"inner": {"deep": [1]}}
    assert m.get("inner").parent is m


# -- randomized fuzz (reference y-map.tests.js:426-606) ---------------------

def _set_key(user, gen: random.Random):
    key = gen.choice(["one", "two"])
    value = "val" + str(gen.randint(0, 100))
    user.get_map("map").set(key, value)


def _set_type(user, gen: random.Random):
    key = gen.choice(["one", "two"])
    typ = gen.choice(["array", "map"])
    if typ == "array":
        nested = Y.YArray()
        user.get_map("map").set(key, nested)
        nested.insert(0, [gen.randint(0, 10) for _ in range(3)])
    else:
        nested = Y.YMap()
        user.get_map("map").set(key, nested)
        nested.set("deepkey", "deepvalue" + str(gen.randint(0, 10)))


def _delete_key(user, gen: random.Random):
    key = gen.choice(["one", "two"])
    user.get_map("map").delete(key)


MAP_MODS = [_set_key, _set_type, _delete_key]


@pytest.mark.parametrize("iterations", [6, 40, 120])
def test_repeat_random_map_ops(rng, iterations):
    apply_random_tests(rng, MAP_MODS, iterations)


def test_map_having_iterable_as_constructor_param(rng):
    """(reference y-map.tests.js
    testMapHavingIterableAsConstructorParamTests)."""
    result = init(rng, users=1)
    map0 = result["map0"]
    m1 = Y.YMap({"number": 1, "string": "hello"})
    map0.set("m1", m1)
    assert m1.get("number") == 1
    assert m1.get("string") == "hello"
    m2 = Y.YMap([("object", {"x": 1}), ("boolean", True)])
    map0.set("m2", m2)
    assert m2.get("object")["x"] == 1
    assert m2.get("boolean") is True
    m3 = Y.YMap(
        list(dict(m1.entries()).items()) + list(dict(m2.entries()).items())
    )
    map0.set("m3", m3)
    assert m3.get("number") == 1
    assert m3.get("string") == "hello"
    assert m3.get("object")["x"] == 1
    assert m3.get("boolean") is True


def test_ymap_sets_ymap(rng):
    """(reference y-map.tests.js testYmapSetsYmap)."""
    result = init(rng, users=2)
    map0 = result["map0"]
    m = map0.set("Map", Y.YMap())
    assert map0.get("Map") is m
    m.set("one", 1)
    assert m.get("one") == 1
    compare(result["users"])


def test_ymap_sets_yarray(rng):
    """(reference y-map.tests.js testYmapSetsYarray)."""
    result = init(rng, users=2)
    map0 = result["map0"]
    arr = map0.set("Array", Y.YArray())
    assert arr is map0.get("Array")
    arr.insert(0, [1, 2, 3])
    assert map0.to_json() == {"Array": [1, 2, 3]}
    compare(result["users"])


def test_size_and_delete_of_map_property(rng):
    """(reference y-map.tests.js testSizeAndDeleteOfMapProperty)."""
    result = init(rng, users=1)
    map0 = result["map0"]
    map0.set("stuff", "c0")
    map0.set("otherstuff", "c1")
    assert map0.size == 2
    map0.delete("stuff")
    assert map0.size == 1
    map0.delete("otherstuff")
    assert map0.size == 0


def test_get_set_map_property_three_conflicts(rng):
    """(reference y-map.tests.js
    testGetAndSetOfMapPropertyWithThreeConflicts)."""
    result = init(rng, users=3)
    map0, map1, map2 = result["map0"], result["map1"], result["map2"]
    map0.set("stuff", "c0")
    map1.set("stuff", "c1")
    map1.set("stuff", "c2")
    map2.set("stuff", "c3")
    result["testConnector"].flush_all_messages()
    for user in result["users"]:
        assert user.get_map("map").get("stuff") == "c3"
    compare(result["users"])


def test_get_set_delete_map_property_three_conflicts(rng):
    """(reference y-map.tests.js
    testGetAndSetAndDeleteOfMapPropertyWithThreeConflicts)."""
    result = init(rng, users=4)
    map0, map1, map2, map3 = (
        result["map0"], result["map1"], result["map2"], result["map3"]
    )
    map0.set("stuff", "c0")
    map1.set("stuff", "c1")
    map1.set("stuff", "c2")
    map2.set("stuff", "c3")
    result["testConnector"].flush_all_messages()
    map0.set("stuff", "deleteme")
    map1.set("stuff", "c1")
    map2.set("stuff", "c2")
    map3.set("stuff", "c3")
    map3.delete("stuff")
    result["testConnector"].flush_all_messages()
    for user in result["users"]:
        assert user.get_map("map").get("stuff") is None
    compare(result["users"])


def test_observe_deep_properties(rng):
    """(reference y-map.tests.js testObserveDeepProperties)."""
    result = init(rng, users=4)
    map1, map2, map3 = result["map1"], result["map2"], result["map3"]
    _map1 = map1.set("map", Y.YMap())
    calls = [0]
    seen = {}

    def deep(events, _tr=None):
        for event in events:
            calls[0] += 1
            assert "deepmap" in event.keys_changed
            assert len(event.path) == 1 and event.path[0] == "map"
            seen["id"] = event.target.get("deepmap")._item.id

    map1.observe_deep(deep)
    result["testConnector"].flush_all_messages()
    _map3 = map3.get("map")
    _map3.set("deepmap", Y.YMap())
    result["testConnector"].flush_all_messages()
    _map2 = map2.get("map")
    _map2.set("deepmap", Y.YMap())
    result["testConnector"].flush_all_messages()
    dmap1 = _map1.get("deepmap")
    dmap2 = _map2.get("deepmap")
    dmap3 = _map3.get("deepmap")
    assert calls[0] > 0
    assert compare_ids(dmap1._item.id, dmap2._item.id)
    assert compare_ids(dmap1._item.id, dmap3._item.id)
    assert compare_ids(dmap1._item.id, seen["id"])
    compare(result["users"])


def test_throws_add_update_delete_events(rng):
    """(reference y-map.tests.js testThrowsAddAndUpdateAndDeleteEvents)."""
    result = init(rng, users=2)
    map0 = result["map0"]
    box = {}
    map0.observe(lambda e, _tr=None: box.__setitem__("e", e))
    map0.set("stuff", 4)
    assert box["e"].target is map0 and box["e"].keys_changed == {"stuff"}
    map0.set("stuff", Y.YArray())  # update, oldValue in contents
    assert box["e"].target is map0 and box["e"].keys_changed == {"stuff"}
    map0.set("stuff", 5)  # update, oldValue in opContents
    assert box["e"].target is map0 and box["e"].keys_changed == {"stuff"}
    map0.delete("stuff")  # delete
    assert box["e"].target is map0 and box["e"].keys_changed == {"stuff"}
    compare(result["users"])


def test_map_change_event_payload(rng):
    """keys action/oldValue across transactions (reference
    y-map.tests.js testChangeEvent)."""
    from yjs_tpu_torch.lib0.encoding import UNDEFINED

    result = init(rng, users=2)
    map0 = result["map0"]
    users = result["users"]
    box = {}
    map0.observe(lambda e, _tr=None: box.__setitem__("ch", e.changes))
    map0.set("a", 1)
    kc = box["ch"]["keys"]["a"]
    assert kc["action"] == "add" and kc["oldValue"] is UNDEFINED
    map0.set("a", 2)
    kc = box["ch"]["keys"]["a"]
    assert kc["action"] == "update" and kc["oldValue"] == 1
    users[0].transact(lambda _t: (map0.set("a", 3), map0.set("a", 4)))
    kc = box["ch"]["keys"]["a"]
    assert kc["action"] == "update" and kc["oldValue"] == 2
    users[0].transact(lambda _t: (map0.set("b", 1), map0.set("b", 2)))
    kc = box["ch"]["keys"]["b"]
    assert kc["action"] == "add" and kc["oldValue"] is UNDEFINED
    users[0].transact(lambda _t: (map0.set("c", 1), map0.delete("c")))
    assert len(box["ch"]["keys"]) == 0
    users[0].transact(lambda _t: (map0.set("d", 1), map0.set("d", 2)))
    kc = box["ch"]["keys"]["d"]
    assert kc["action"] == "add" and kc["oldValue"] is UNDEFINED
    compare(result["users"])


def test_ymap_event_exceptions_complete_transaction():
    """A throwing observer must not corrupt the transaction (reference
    y-map.tests.js testYmapEventExceptionsShouldCompleteTransaction)."""
    doc = Y.Doc()
    m = doc.get_map("map")
    called = {"update": False, "obs": False, "deep": False}
    doc.on("update", lambda *a: called.__setitem__("update", True))

    def throwing(e, _tr=None):
        called.__setitem__("obs", True)
        raise RuntimeError("Failure")

    def throwing_deep(es, _tr=None):
        called.__setitem__("deep", True)
        raise RuntimeError("Failure")

    m.observe(throwing)
    m.observe_deep(throwing_deep)
    with pytest.raises(RuntimeError):
        m.set("y", "2")
    assert all(called.values())
    for k in called:
        called[k] = False
    with pytest.raises(RuntimeError):
        m.set("z", "3")
    assert all(called.values())
    assert m.get("z") == "3"
