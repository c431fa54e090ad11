"""The cases of the JAX package's ``tests/test_yarray.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``.

YArray behavior + randomized convergence tests (scenarios modeled on
reference tests/y-array.tests.js)."""

import random

import pytest

import yjs_tpu_torch as Y
from torch_helpers import apply_random_tests, compare, init


def test_basic_insert_delete():
    doc = Y.Doc()
    arr = doc.get_array("arr")
    arr.insert(0, [1, 2, 3])
    arr.insert(1, ["x"])
    assert arr.to_json() == [1, "x", 2, 3]
    arr.delete(1, 2)
    assert arr.to_json() == [1, 3]
    arr.push([4])
    arr.unshift([0])
    assert arr.to_json() == [0, 1, 3, 4]
    assert arr.get(2) == 3
    assert arr.length == 4
    assert arr.slice(1, 3) == [1, 3]
    assert arr.slice(-2) == [3, 4]


def test_types_as_content():
    doc = Y.Doc()
    arr = doc.get_array("arr")
    nested = Y.YArray()
    arr.insert(0, [nested])
    nested.insert(0, ["inner"])
    m = Y.YMap({"k": 1})
    arr.push([m])
    assert arr.to_json() == [["inner"], {"k": 1}]


def test_insert_three_elements_try_re_get(rng):
    result = init(rng, users=2)
    array0, array1 = result["array0"], result["array1"]
    array0.insert(0, [1, True, False])
    assert array0.to_json() == [1, True, False]
    result["testConnector"].flush_all_messages()
    assert array1.to_json() == [1, True, False]
    compare(result["users"])


def test_concurrent_inserts_converge(rng):
    result = init(rng, users=3)
    array0, array1, array2 = result["array0"], result["array1"], result["array2"]
    array0.insert(0, [0])
    array1.insert(0, [1])
    array2.insert(0, [2])
    compare(result["users"])


def test_insertions_in_late_sync(rng):
    result = init(rng, users=3)
    tc = result["testConnector"]
    tc.flush_all_messages()
    result["users"][1].disconnect()
    result["users"][2].disconnect()
    result["array0"].insert(1, ["user0"]) if result["array0"].length > 0 else result[
        "array0"
    ].insert(0, ["user0"])
    result["array1"].insert(0, ["user1"])
    result["array2"].insert(0, ["user2"])
    result["users"][1].connect()
    result["users"][2].connect()
    compare(result["users"])


def test_disconnect_really_prevents_sending_messages(rng):
    result = init(rng, users=3)
    tc = result["testConnector"]
    array0, array1 = result["array0"], result["array1"]
    tc.flush_all_messages()
    result["users"][1].disconnect()
    array0.insert(0, ["x"])
    assert array1.to_json() == []
    result["users"][1].connect()
    compare(result["users"])


def test_delete_insert_circular(rng):
    result = init(rng, users=2)
    array0 = result["array0"]
    array0.insert(0, ["A", "B", "C"])
    array0.delete(1, 1)
    array0.insert(1, ["b"])
    assert array0.to_json() == ["A", "b", "C"]
    compare(result["users"])


def test_observer_event():
    doc = Y.Doc()
    arr = doc.get_array("arr")
    fired = {}

    def obs(event, txn):
        fired["added"] = len(event.changes["added"])
        fired["deleted"] = len(event.changes["deleted"])
        fired["delta"] = event.changes["delta"]

    arr.observe(obs)
    arr.insert(0, [1, 2])
    assert fired["added"] == 1
    assert fired["delta"] == [{"insert": [1, 2]}]
    arr.delete(0, 1)
    assert fired["deleted"] == 1
    assert fired["delta"] == [{"delete": 1}]


def test_observe_deep():
    doc = Y.Doc()
    arr = doc.get_array("arr")
    events = []
    arr.observe_deep(lambda evts, txn: events.append(evts))
    nested = Y.YMap()
    arr.insert(0, [nested])
    assert len(events) == 1
    nested.set("key", "value")
    assert len(events) == 2
    assert events[1][0].path == [0]


# -- randomized convergence fuzzing (reference y-array.tests.js:386-502) ----

_unique_counter = [0]


def _unique_number():
    _unique_counter[0] += 1
    return _unique_counter[0]


def _insert_generic(user, gen: random.Random):
    arr = user.get_array("array")
    pos = gen.randint(0, arr.length)
    arr.insert(pos, [_unique_number() for _ in range(gen.randint(1, 4))])


def _insert_type_array(user, gen: random.Random):
    arr = user.get_array("array")
    pos = gen.randint(0, arr.length)
    nested = Y.YArray()
    arr.insert(pos, [nested])
    nested.insert(0, [gen.randint(0, 10), gen.randint(0, 10)])


def _insert_text(user, gen: random.Random):
    arr = user.get_array("array")
    pos = gen.randint(0, arr.length)
    arr.insert(pos, ["str" + str(gen.randint(0, 100))])


def _delete_generic(user, gen: random.Random):
    arr = user.get_array("array")
    length = arr.length
    if length > 0:
        pos = gen.randint(0, length - 1)
        del_length = min(gen.randint(1, 2), length - pos)
        if gen.random() < 0.5:
            item = arr.get(pos)
            if isinstance(item, Y.YArray) and item.length > 0:
                pos2 = gen.randint(0, item.length - 1)
                item.delete(pos2, min(gen.randint(1, 2), item.length - pos2))
                return
        arr.delete(pos, del_length)


ARRAY_MODS = [_insert_generic, _insert_type_array, _insert_text, _delete_generic]


@pytest.mark.parametrize("iterations", [6, 40, 120])
def test_repeat_random_array_ops(rng, iterations):
    apply_random_tests(rng, ARRAY_MODS, iterations)


def test_slice():
    """(reference y-array.tests.js testSlice)."""
    doc = Y.Doc()
    arr = doc.get_array("array")
    arr.insert(0, [1, 2, 3])
    assert arr.slice(0) == [1, 2, 3]
    assert arr.slice(1) == [2, 3]
    assert arr.slice(0, -1) == [1, 2]
    arr.insert(0, [0])
    assert arr.slice(0) == [0, 1, 2, 3]
    assert arr.slice(0, 2) == [0, 1]


def test_concurrent_insert_delete_with_three_conflicts(rng):
    """(reference y-array.tests.js
    testConcurrentInsertDeleteWithThreeConflicts)."""
    result = init(rng, users=3)
    array0, array1, array2 = (
        result["array0"], result["array1"], result["array2"]
    )
    array0.insert(0, ["x", "y", "z"])
    result["testConnector"].flush_all_messages()
    array0.insert(1, [0])
    array1.delete(0, 1)
    array1.delete(1, 1)
    array2.insert(1, [2])
    compare(result["users"])


def test_deletions_in_late_sync(rng):
    """(reference y-array.tests.js testDeletionsInLateSync)."""
    result = init(rng, users=2)
    array0, array1 = result["array0"], result["array1"]
    array0.insert(0, ["x", "y"])
    result["testConnector"].flush_all_messages()
    result["users"][1].disconnect()
    array1.delete(1, 1)
    array0.delete(0, 2)
    result["users"][1].connect()
    compare(result["users"])


def test_insert_then_merge_delete_on_sync(rng):
    """(reference y-array.tests.js testInsertThenMergeDeleteOnSync)."""
    result = init(rng, users=2)
    array0, array1 = result["array0"], result["array1"]
    array0.insert(0, ["x", "y", "z"])
    result["testConnector"].flush_all_messages()
    result["users"][0].disconnect()
    array1.delete(0, 3)
    result["users"][0].connect()
    compare(result["users"])


def test_garbage_collector(rng):
    """(reference y-array.tests.js testGarbageCollector)."""
    result = init(rng, users=3)
    array0 = result["array0"]
    array0.insert(0, ["x", "y", "z"])
    result["testConnector"].flush_all_messages()
    result["users"][0].disconnect()
    array0.delete(0, 3)
    result["users"][0].connect()
    result["testConnector"].flush_all_messages()
    compare(result["users"])


def test_insert_and_delete_events(rng):
    """(reference y-array.tests.js testInsertAndDeleteEvents)."""
    result = init(rng, users=2)
    array0 = result["array0"]
    seen = []
    array0.observe(lambda e, _tr=None: seen.append(e))
    array0.insert(0, [0, 1, 2])
    assert len(seen) == 1
    array0.delete(0, 1)
    assert len(seen) == 2
    array0.delete(0, 2)
    assert len(seen) == 3
    compare(result["users"])


def test_nested_observer_events(rng):
    """Observer re-entrancy: an insert from inside an observer fires the
    observer again AFTER the current call completes (reference
    y-array.tests.js testNestedObserverEvents)."""
    result = init(rng, users=2)
    array0 = result["array0"]
    vals = []

    def obs(e, _tr=None):
        if array0.length == 1:
            array0.insert(1, [1])
            vals.append(0)
        else:
            vals.append(1)

    array0.observe(obs)
    array0.insert(0, [0])
    assert vals == [0, 1]
    assert array0.to_array() == [0, 1]
    compare(result["users"])


def test_change_event_payload(rng):
    """event.changes added/deleted sizes + delta shapes (reference
    y-array.tests.js testChangeEvent)."""
    result = init(rng, users=2)
    array0 = result["array0"]
    box = {}

    def obs(e, _tr=None):
        box["changes"] = e.changes

    array0.observe(obs)
    new_arr = Y.YArray()
    array0.insert(0, [new_arr, 4, "dtrn"])
    ch = box.pop("changes")
    assert len(ch["added"]) == 2 and len(ch["deleted"]) == 0
    assert ch["delta"] == [{"insert": [new_arr, 4, "dtrn"]}]
    array0.delete(0, 2)
    ch = box.pop("changes")
    assert len(ch["added"]) == 0 and len(ch["deleted"]) == 2
    assert ch["delta"] == [{"delete": 2}]
    array0.insert(1, [0.1])
    ch = box.pop("changes")
    assert len(ch["added"]) == 1 and len(ch["deleted"]) == 0
    assert ch["delta"] == [{"retain": 1}, {"insert": [0.1]}]
    compare(result["users"])


def test_event_target_is_set_correctly(rng):
    """(reference y-array.tests.js testEventTargetIsSetCorrectlyOnLocal /
    OnRemote)."""
    result = init(rng, users=3)
    array0, array1 = result["array0"], result["array1"]
    box = {}
    array0.observe(lambda e, _tr=None: box.__setitem__("t", e.target))
    array0.insert(0, ["stuff"])
    assert box["t"] is array0
    box2 = {}
    array1.observe(lambda e, _tr=None: box2.__setitem__("t", e.target))
    result["testConnector"].flush_all_messages()
    assert box2["t"] is array1
    compare(result["users"])


def test_iterating_array_containing_types():
    """(reference y-array.tests.js testIteratingArrayContainingTypes)."""
    y = Y.Doc()
    arr = y.get_array("arr")
    for i in range(10):
        m = Y.YMap()
        m.set("value", i)
        arr.push([m])
    for cnt, item in enumerate(arr.to_array()):
        assert item.get("value") == cnt
