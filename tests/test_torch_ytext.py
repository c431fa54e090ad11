"""The cases of the JAX package's ``tests/test_ytext.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``.

YText behavior + formatting + randomized convergence (scenarios modeled
on reference tests/y-text.tests.js)."""

import random

import pytest

import yjs_tpu_torch as Y
from torch_helpers import apply_random_tests, compare, init


def test_basic_insert_delete(rng):
    result = init(rng, users=2)
    text0 = result["text0"]
    text0.insert(0, "abc")
    assert text0.to_string() == "abc"
    text0.delete(0, 1)
    text0.delete(1, 1)
    assert text0.to_string() == "b"
    text0.insert(0, "z")
    assert text0.to_string() == "zb"
    result["testConnector"].flush_all_messages()
    assert result["text1"].to_string() == "zb"
    compare(result["users"])


def test_concurrent_inserts(rng):
    result = init(rng, users=3)
    result["text0"].insert(0, "abc")
    result["testConnector"].flush_all_messages()
    result["text0"].insert(1, "0")
    result["text1"].insert(1, "1")
    result["text2"].insert(2, "2")
    compare(result["users"])


def test_formatting_basic():
    doc = Y.Doc()
    text = doc.get_text("text")
    text.insert(0, "bold plain", {"bold": True})
    text.format(4, 6, {"bold": None})
    delta = text.to_delta()
    assert delta == [
        {"insert": "bold", "attributes": {"bold": True}},
        {"insert": " plain"},
    ]


def test_formatting_overlap():
    doc = Y.Doc()
    text = doc.get_text("text")
    text.insert(0, "abcdef")
    text.format(0, 4, {"bold": True})
    text.format(2, 4, {"italic": True})
    assert text.to_delta() == [
        {"insert": "ab", "attributes": {"bold": True}},
        {"insert": "cd", "attributes": {"bold": True, "italic": True}},
        {"insert": "ef", "attributes": {"italic": True}},
    ]


def test_insert_inherits_attributes():
    doc = Y.Doc()
    text = doc.get_text("text")
    text.insert(0, "ab", {"bold": True})
    # inserting inside the bold range without explicit attrs inherits bold
    text.insert(1, "X")
    assert text.to_delta() == [{"insert": "aXb", "attributes": {"bold": True}}]


def test_delta_event():
    doc = Y.Doc()
    text = doc.get_text("text")
    deltas = []
    text.observe(lambda e, txn: deltas.append(e.delta))
    text.insert(0, "abc", {"bold": True})
    assert deltas[-1] == [{"insert": "abc", "attributes": {"bold": True}}]
    text.delete(0, 1)
    assert deltas[-1] == [{"delete": 1}]
    text.insert(2, "z")
    assert deltas[-1] == [{"retain": 2}, {"insert": "z", "attributes": {"bold": True}}]


def test_apply_delta():
    doc = Y.Doc()
    text = doc.get_text("text")
    text.apply_delta(
        [
            {"insert": "Gandalf", "attributes": {"bold": True}},
            {"insert": " the "},
            {"insert": "Grey", "attributes": {"color": "#ccc"}},
        ]
    )
    assert text.to_delta() == [
        {"insert": "Gandalf", "attributes": {"bold": True}},
        {"insert": " the "},
        {"insert": "Grey", "attributes": {"color": "#ccc"}},
    ]
    text.apply_delta([{"retain": 7}, {"delete": 5}, {"insert": ", "}])
    assert text.to_string() == "Gandalf, Grey"


def test_embed():
    doc = Y.Doc()
    text = doc.get_text("text")
    text.insert(0, "ab")
    text.insert_embed(1, {"image": "x.png"}, {"width": 100})
    delta = text.to_delta()
    assert delta == [
        {"insert": "a"},
        {"insert": {"image": "x.png"}, "attributes": {"width": 100}},
        {"insert": "b"},
    ]


def test_text_attributes():
    doc = Y.Doc()
    text = doc.get_text("text")
    text.set_attribute("block", "quote")
    assert text.get_attribute("block") == "quote"
    assert text.get_attributes() == {"block": "quote"}
    text.remove_attribute("block")
    assert text.get_attributes() == {}


def test_surrogate_pair_split():
    doc = Y.Doc()
    text = doc.get_text("text")
    text.insert(0, "a\U0001f600b")  # astral char occupies 2 UTF-16 units
    assert text.length == 4
    # delete only the first half of the surrogate pair: both halves become FFFD
    text.delete(1, 1)
    assert text.length == 3
    u = Y.encode_state_as_update(doc)
    doc2 = Y.Doc()
    Y.apply_update(doc2, u)
    assert doc2.get_text("text").to_string() == doc.get_text("text").to_string()


def test_concurrent_formatting_converges(rng):
    result = init(rng, users=3)
    result["text0"].insert(0, "abcdef")
    result["testConnector"].flush_all_messages()
    result["text0"].format(0, 6, {"bold": True})
    result["text1"].format(0, 3, {"italic": True})
    result["text2"].delete(2, 2)
    compare(result["users"])


def test_large_insertions(rng):
    result = init(rng, users=2)
    text0 = result["text0"]
    gen = rng
    for _ in range(200):
        pos = gen.randint(0, text0.length)
        text0.insert(pos, "a")
    for _ in range(40):
        if text0.length > 2:
            pos = gen.randint(0, text0.length - 2)
            text0.delete(pos, 2)
    compare(result["users"])


# -- randomized fuzz with quill-like ops (reference y-text.tests.js:555-619)

_ATTRS = [{}, {"bold": True}, {"italic": True}, {"color": "red"}]


def _insert_text(user, gen: random.Random):
    text = user.get_text("text")
    pos = gen.randint(0, text.length)
    attrs = gen.choice(_ATTRS)
    s = "text" + str(gen.randint(0, 100)) + " "
    if attrs:
        text.insert(pos, s, attrs)
    else:
        text.insert(pos, s)


def _delete_text(user, gen: random.Random):
    text = user.get_text("text")
    if text.length > 0:
        pos = gen.randint(0, text.length - 1)
        text.delete(pos, min(gen.randint(1, 4), text.length - pos))


def _format_text(user, gen: random.Random):
    text = user.get_text("text")
    if text.length > 0:
        pos = gen.randint(0, text.length - 1)
        length = min(gen.randint(1, 5), text.length - pos)
        attrs = gen.choice([{"bold": True}, {"bold": None}, {"italic": True}])
        text.format(pos, length, attrs)


def _insert_embed(user, gen: random.Random):
    text = user.get_text("text")
    pos = gen.randint(0, text.length)
    text.insert_embed(pos, {"image": "img.png"})


TEXT_MODS = [_insert_text, _delete_text, _format_text, _insert_embed]


@pytest.mark.parametrize("iterations", [6, 40, 100])
def test_repeat_random_text_ops(rng, iterations):
    apply_random_tests(rng, TEXT_MODS, iterations)


def test_get_delta_with_embeds(rng):
    """(reference y-text.tests.js testGetDeltaWithEmbeds)."""
    result = init(rng, users=1)
    text0 = result["text0"]
    text0.apply_delta([{"insert": {"linebreak": "s"}}])
    assert text0.to_delta() == [{"insert": {"linebreak": "s"}}]


def test_to_json(rng):
    """(reference y-text.tests.js testToJson)."""
    result = init(rng, users=1)
    text0 = result["text0"]
    text0.insert(0, "abc", {"bold": True})
    assert text0.to_json() == "abc"


def test_to_delta_embed_attributes(rng):
    """(reference y-text.tests.js testToDeltaEmbedAttributes)."""
    result = init(rng, users=1)
    text0 = result["text0"]
    text0.insert(0, "ab", {"bold": True})
    text0.insert_embed(1, {"image": "imageSrc.png"}, {"width": 100})
    assert text0.to_delta() == [
        {"insert": "a", "attributes": {"bold": True}},
        {"insert": {"image": "imageSrc.png"}, "attributes": {"width": 100}},
        {"insert": "b", "attributes": {"bold": True}},
    ]


def test_to_delta_embed_no_attributes(rng):
    """(reference y-text.tests.js testToDeltaEmbedNoAttributes)."""
    result = init(rng, users=1)
    text0 = result["text0"]
    text0.insert(0, "ab", {"bold": True})
    text0.insert_embed(1, {"image": "imageSrc.png"})
    assert text0.to_delta() == [
        {"insert": "a", "attributes": {"bold": True}},
        {"insert": {"image": "imageSrc.png"}},
        {"insert": "b", "attributes": {"bold": True}},
    ]


def test_formatting_removed(rng):
    """Format-cleanup corner: deleting every formatted char leaves one
    struct (reference y-text.tests.js testFormattingRemoved)."""
    result = init(rng, users=1)
    text0 = result["text0"]
    text0.insert(0, "ab", {"bold": True})
    text0.delete(0, 2)
    assert len(Y.get_type_children(text0)) == 1


def test_formatting_removed_in_mid_text(rng):
    """(reference y-text.tests.js testFormattingRemovedInMidText)."""
    result = init(rng, users=1)
    text0 = result["text0"]
    text0.insert(0, "1234")
    text0.insert(2, "ab", {"bold": True})
    text0.delete(2, 2)
    assert len(Y.get_type_children(text0)) == 3


def test_append_chars(rng):
    """(reference y-text.tests.js testAppendChars, N scaled down)."""
    result = init(rng, users=1)
    text0 = result["text0"]
    n = 3000
    for _ in range(n):
        text0.insert(text0.length, "a")
    assert text0.length == n


def test_text_snapshot_diff(rng):
    """Two-snapshot diff with ychange (reference y-text.tests.js
    testSnapshot)."""
    result = init(rng, users=1)
    text0 = result["text0"]
    doc0 = text0.doc
    doc0.gc = False
    text0.apply_delta([{"insert": "abcd"}])
    snapshot1 = Y.snapshot(doc0)
    text0.apply_delta([{"retain": 1}, {"insert": "x"}, {"delete": 1}])
    snapshot2 = Y.snapshot(doc0)
    text0.apply_delta(
        [{"retain": 2}, {"delete": 3}, {"insert": "x"}, {"delete": 1}]
    )
    assert text0.to_delta(snapshot1) == [{"insert": "abcd"}]
    assert text0.to_delta(snapshot2) == [{"insert": "axcd"}]
    state2_diff = text0.to_delta(snapshot2, snapshot1)
    for v in state2_diff:
        if "attributes" in v and "ychange" in v["attributes"]:
            v["attributes"]["ychange"].pop("user", None)
    assert state2_diff == [
        {"insert": "a"},
        {"insert": "x", "attributes": {"ychange": {"type": "added"}}},
        {"insert": "b", "attributes": {"ychange": {"type": "removed"}}},
        {"insert": "cd"},
    ]


def test_text_snapshot_delete_after(rng):
    """(reference y-text.tests.js testSnapshotDeleteAfter)."""
    result = init(rng, users=1)
    text0 = result["text0"]
    text0.doc.gc = False
    text0.apply_delta([{"insert": "abcd"}])
    snapshot1 = Y.snapshot(text0.doc)
    text0.apply_delta([{"retain": 4}, {"insert": "e"}])
    assert text0.to_delta(snapshot1) == [{"insert": "abcd"}]
