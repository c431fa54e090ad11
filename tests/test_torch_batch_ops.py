"""The cases of the JAX package's ``tests/test_batch_ops.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``.

Each case runs twice: on the native plan core, and under
``YTPU_NO_NATIVE_PLAN=1``, where the Python mirror plans the columns
with the segment planner's kernels on ``device="cpu"`` (their plain
versions).  Besides the doc-level oracle, every result is held byte for
byte against the JAX package's ``merge_updates_columnar``,
``diff_update_columnar`` and ``encode_state_vector_from_update_columnar``
on the same inputs, under the same planner.

Doc-free columnar batch ops vs the doc-level oracle
(yjs_tpu_torch.updates.merge_updates / diff_update)."""

import random

import pytest

import yjs_tpu_torch as Y
from yjs_tpu.ops import batch as jax_batch
from yjs_tpu_torch.ops import batch as port_batch
from yjs_tpu_torch.updates import (
    diff_update,
    encode_state_vector_from_update,
    merge_updates,
)


@pytest.fixture(params=["native", "python"])
def planner(request, monkeypatch):
    """The plan path both packages' batch ops take in this case."""
    if request.param == "python":
        monkeypatch.setenv("YTPU_NO_NATIVE_PLAN", "1")
    else:
        monkeypatch.delenv("YTPU_NO_NATIVE_PLAN", raising=False)
    monkeypatch.delenv("YTPU_PLAN_SEGMENT", raising=False)
    return request.param


def merge_updates_columnar(updates, v2=False, out_v2=None):
    got = port_batch.merge_updates_columnar(
        updates, v2=v2, out_v2=out_v2, device="cpu"
    )
    assert got == jax_batch.merge_updates_columnar(
        updates, v2=v2, out_v2=out_v2
    )
    return got


def diff_update_columnar(update, encoded_state_vector, v2=False):
    got = port_batch.diff_update_columnar(
        update, encoded_state_vector, v2=v2, device="cpu"
    )
    assert got == jax_batch.diff_update_columnar(
        update, encoded_state_vector, v2=v2
    )
    return got


def encode_state_vector_from_update_columnar(update, v2=False):
    got = port_batch.encode_state_vector_from_update_columnar(
        update, v2=v2, device="cpu"
    )
    assert got == jax_batch.encode_state_vector_from_update_columnar(
        update, v2=v2
    )
    return got


def _state(update: bytes, v2: bool = False):
    d = Y.Doc(gc=False)
    (Y.apply_update_v2 if v2 else Y.apply_update)(d, update)
    return (
        d.get_text("text").to_string(),
        d.get_map("map").to_json(),
        Y.decode_state_vector(Y.encode_state_vector(d)),
    )


def _concurrent_updates(seed: int, v2: bool = False):
    gen = random.Random(seed)
    docs = []
    updates = []
    for i in range(3):
        d = Y.Doc(gc=False)
        d.client_id = i + 1
        docs.append(d)
    base = None
    for step in range(25):
        d = gen.choice(docs)
        op = gen.random()
        if op < 0.6:
            t = d.get_text("text")
            ln = len(t.to_string())
            if gen.random() < 0.7 or ln == 0:
                t.insert(gen.randint(0, ln), gen.choice(["x", "yy🙂", "z "]))
            else:
                pos = gen.randrange(ln)
                t.delete(pos, min(gen.randint(1, 2), ln - pos))
        else:
            d.get_map("map").set(gen.choice("ab"), gen.randrange(50))
        if gen.random() < 0.3:
            src, dst = gen.choice(docs), gen.choice(docs)
            Y.apply_update(dst, Y.encode_state_as_update(src))
    enc = Y.encode_state_as_update_v2 if v2 else Y.encode_state_as_update
    return [enc(d) for d in docs]


@pytest.mark.parametrize("seed", range(3))
def test_merge_matches_oracle(seed, planner):
    updates = _concurrent_updates(seed)
    merged_col = merge_updates_columnar(updates)
    merged_doc = merge_updates(updates)
    assert _state(merged_col) == _state(merged_doc)


def test_merge_v2_in_v1_out_and_back(planner):
    updates_v2 = _concurrent_updates(9, v2=True)
    # V2 in, V1 out: one-pass format conversion during the merge
    merged_v1 = merge_updates_columnar(updates_v2, v2=True, out_v2=False)
    merged_v2 = merge_updates_columnar(updates_v2, v2=True)
    assert _state(merged_v1) == _state(merged_v2, v2=True)


@pytest.mark.parametrize("seed", range(3))
def test_diff_matches_oracle(seed, planner):
    updates = _concurrent_updates(100 + seed)
    merged = merge_updates(updates)
    # a peer that saw only the first update asks for the rest
    peer_sv = encode_state_vector_from_update_columnar(updates[0])
    diff_col = diff_update_columnar(merged, peer_sv)
    diff_doc = diff_update(merged, peer_sv)
    # applying either diff on top of the peer's state converges identically
    for diff in (diff_col, diff_doc):
        d = Y.Doc(gc=False)
        Y.apply_update(d, updates[0])
        Y.apply_update(d, diff)
        assert _state(Y.encode_state_as_update(d)) == _state(merged)


def test_incomplete_deps_withheld_like_oracle(planner):
    # an update missing its causal prefix: both paths withhold the structs
    d = Y.Doc(gc=False)
    d.client_id = 5
    d.get_text("text").insert(0, "one ")
    sv = Y.encode_state_vector(d)
    d.get_text("text").insert(4, "two ")
    tail_only = Y.encode_state_as_update(d, sv)
    assert _state(merge_updates_columnar([tail_only])) == _state(
        merge_updates([tail_only])
    )


def test_subdoc_updates_fall_back_to_oracle(planner):
    d = Y.Doc(gc=False)
    d.client_id = 5
    d.get_map("m").set("sub", Y.Doc(guid="child"))
    d.get_text("text").insert(0, "t")
    u = Y.encode_state_as_update(d)
    merged = merge_updates_columnar([u])
    assert _state(merged) == _state(merge_updates([u]))
    sv = encode_state_vector_from_update_columnar(u)
    assert Y.decode_state_vector(sv) == Y.decode_state_vector(
        encode_state_vector_from_update(u)
    )
    assert _state(diff_update_columnar(u, Y.encode_state_vector(Y.Doc(gc=False)))) \
        == _state(u)


def test_state_vector_from_update(planner):
    updates = _concurrent_updates(7)
    merged = merge_updates(updates)
    assert Y.decode_state_vector(
        encode_state_vector_from_update_columnar(merged)
    ) == Y.decode_state_vector(encode_state_vector_from_update(merged))
