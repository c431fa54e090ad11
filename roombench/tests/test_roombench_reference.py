"""The plain reference against frozen texts and Yjs's conflict rule."""

import hashlib
import json
import os

import pytest

from roombench import bases, ycodec
from roombench.ytext import TextDoc

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cfg(name):
    with open(os.path.join(ROOT, "roombench", "configs", name + ".json")) as f:
        return json.load(f)


def test_b4_stand_in_matches_its_frozen_text():
    (u,) = bases.histories(ROOT, _cfg("b4docs256")["history"])
    with open(os.path.join(ROOT, "tests", "fixtures", "b4_trace.json")) as f:
        meta = json.load(f)
    d = TextDoc()
    d.apply_update(u)
    t = d.text()
    assert d.complete()
    assert len(t) == meta["text_len"]
    assert hashlib.sha256(t.encode()).hexdigest() == meta["text_sha256"]
    assert d.sv == {int(c): k for c, k in meta["state_vector"].items()}


# texts of the distinct-trace fixture, frozen when they matched the
# program's CPU core
FROZEN = {
    0: (5650, "644a5bdf3a789a6cb7b6b91034adb4366c493aac1f5f442babb173a65f54e1d5"),
    1: (5598, "5fb72075f919eff9a3a5e2813c876551ba0796c0b25d4bdd49cc068109e0509d"),
    1023: (5617, "149bc74b5cce518a97ef4ad8dee7e90a75f6df7a7bae4a93e4deca24b28b8e3b"),
}


@pytest.mark.parametrize("i", sorted(FROZEN))
def test_distinct_traces_match_frozen_texts(i):
    h = bases.histories(ROOT, _cfg("rooms12k")["history"])
    d = TextDoc()
    d.apply_update(h[i])
    t = d.text()
    assert (len(t), hashlib.sha256(t.encode()).hexdigest()) == FROZEN[i]


def test_fixture_with_wrong_sha_is_refused():
    spec = dict(_cfg("b4docs256")["history"], sha256="0" * 64)
    with pytest.raises(bases.FixtureError):
        bases.histories(ROOT, spec)


def test_concurrent_inserts_order_by_client_and_wait_for_dependencies():
    a = ycodec.encode_insert(7, 0, None, None, "x", "text")
    # two clients insert after x concurrently: the lower client goes first
    b = ycodec.encode_insert(9, 0, ycodec.pack_id(7, 0), None, "b", "text")
    c = ycodec.encode_insert(5, 0, ycodec.pack_id(7, 0), None, "c", "text")
    # a later insert of client 9 that arrives before what it depends on
    later = ycodec.encode_insert(9, 1, ycodec.pack_id(9, 0), None, "d", "text")
    for order in ([a, b, c, later], [later, c, b, a], [c, a, later, b]):
        d = TextDoc()
        for u in order:
            d.apply_update(u)
        assert d.complete()
        assert d.text() == "xcbd"
    d.apply_update(ycodec.encode_delete(ycodec.pack_id(5, 0)))
    assert d.text() == "xbd"
    assert d.sv == {7: 1, 9: 2, 5: 1}


def test_missing_dependency_waits():
    d = TextDoc()
    d.apply_update(ycodec.encode_insert(9, 1, ycodec.pack_id(9, 0), None, "d", "text"))
    assert not d.complete() and d.text() == ""


def test_session_update_round_trips():
    items = [(None, None, "a"), (ycodec.pack_id(3, 0), None, "b")]
    u = ycodec.encode_session(3, 0, items, [ycodec.pack_id(3, 0)], "text")
    runs, ds = ycodec.decode_update(u)
    assert [(r.client, r.clock, r.text) for r in runs] == [(3, 0, "a"), (3, 1, "b")]
    assert ds == [(3, 0, 1)]
    d = TextDoc()
    d.apply_update(u)
    assert d.text() == "b"


def test_step_messages_round_trip():
    sv = {101: 5, 1 << 31: 70000}
    msg = ycodec.encode_step1(sv)
    r = ycodec.Reader(msg)
    assert r.uint() == ycodec.SYNC_STEP1
    body = ycodec.Reader(r.bytes())
    assert {body.uint(): body.uint() for _ in range(body.uint())} == sv
    u = ycodec.encode_insert(3, 0, None, None, "q", "text")
    out = bytearray((ycodec.SYNC_STEP2,))
    ycodec.write_uint(out, len(u))
    assert ycodec.decode_step2(bytes(out + u)) == u
