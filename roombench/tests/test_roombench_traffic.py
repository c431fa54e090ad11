"""The generator: a seed gives the same bytes, and every update decodes
and applies to the reference."""

import json
import os

import pytest

from roombench import bases, harness, traffic

ROOT = harness.ROOT


def _load(config, mix, rooms):
    with open(os.path.join(ROOT, "roombench", "configs", config + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "roombench", "traffic", mix + ".json")) as f:
        mx = json.load(f)
    cfg["rooms"] = rooms
    hist = bases.histories(ROOT, cfg["history"])
    return cfg, mx, hist


def _make(cfg, mx, hist, seed, ticks, workers=1):
    room_base = harness.deal(cfg, len(hist), traffic.ranking(cfg["rooms"], seed))
    bs = [None] * len(hist)
    for h in set(room_base):
        bs[h] = bases.integrate((hist[h], cfg["root"]))
    tr = traffic.make(cfg, mx, hist, bs, room_base, seed, ticks, workers)
    return tr, bs, room_base


@pytest.mark.parametrize("config,mix,rooms", [("rooms12k", "typing", 12), ("b4docs256", "join", 2)])
def test_same_seed_same_bytes(config, mix, rooms):
    cfg, mx, hist = _load(config, mix, rooms)
    seed = 2**31 + 12345
    a, _, _ = _make(cfg, mx, hist, seed, 3)
    b, _, _ = _make(cfg, mx, hist, seed, 3, workers=2)
    c, _, _ = _make(cfg, mx, hist, seed + 1, 3)
    for tr in (a, b, c):
        tr.edit_buf = bytes(tr.edit_buf)
    assert a.edit_buf == b.edit_buf and a.edit_room == b.edit_room
    assert a.join_buf == b.join_buf and a.load == b.load
    assert a.edit_buf != c.edit_buf


def test_typing_updates_apply_to_the_reference():
    cfg, mx, hist = _load("rooms12k", "typing", 8)
    tr, bs, room_base = _make(cfg, mx, hist, 77, 4)
    docs = {}
    n_del = 0
    for i in range(len(tr.edit_room)):
        r = tr.edit_room[i]
        d = docs.get(r)
        if d is None:
            d = docs[r] = bs[room_base[r]].textdoc("text")
        before = len(d.deleted)
        d.apply_update(bytes(tr.edit_buf[tr.edit_off[i]:tr.edit_off[i + 1]]))
        n_del += len(d.deleted) - before
        assert d.complete()
    total = len(tr.edit_room)
    assert total == 4 * mx["keystrokes_per_tick"]
    assert sum(tr.k1_rows) + sum(tr.k1_deletes) == total
    assert sum(tr.k1_deletes) == n_del
    # the B4 texture: about three edits in ten are deletes
    assert 0.15 < n_del / total < 0.45


def test_join_traffic_state_vectors_fit_the_rooms():
    cfg, mx, hist = _load("b4docs256", "join", 2)
    tr, bs, room_base = _make(cfg, mx, hist, 5, 6)
    stale = 0
    for j in range(len(tr.join_room)):
        msg = bytes(tr.join_buf[tr.join_off[j]:tr.join_off[j + 1]])
        from roombench.check import _decode_step1_sv
        sv = _decode_step1_sv(msg)
        if tr.join_stale[j]:
            stale += 1
            assert sv and all(k > 0 for k in sv.values())
        else:
            assert sv == {}
    assert 0 < stale < len(tr.join_room)
    # each room's tail is one update of its new client, applied on top of B4
    assert [r for r, _ in tr.load] == [0, 0, 1, 1]
    d = bs[0].textdoc("text")
    d.apply_update(tr.load[1][1])
    assert d.complete() and d.sv[tr.clients[0]] > 0


def test_histories_go_by_popularity_rank():
    cfg, mx, hist = _load("rooms12k", "typing", 12500)
    k = cfg["history"]["rooms_per_history"]
    for seed in (1, 2):
        order = traffic.ranking(12500, seed)
        deal = harness.deal(cfg, len(hist), order)
        assert [deal[r] for r in order[:2 * k]] == [0] * k + [1] * k
        assert sorted(deal) == [h for h in range(1024) for _ in range(k)][:12500]


def test_ticks_needed_sizes_for_three_times_the_fastest_rate():
    assert traffic.ticks_needed({"sized_for_ticks_per_s": 4.0}, 30) == 1 + 360


def test_bases_are_integrated_once_and_then_loaded(tmp_path, monkeypatch):
    cfg, _, hist = _load("rooms12k", "typing", 8)
    monkeypatch.setattr(bases, "CACHE", str(tmp_path))
    calls = []

    def pool_map(fn, jobs):
        calls.append(len(jobs))
        return [fn(j) for j in jobs]

    a = bases.integrated(cfg["history"], hist, "text", [3, 1], pool_map)
    b = bases.integrated(cfg["history"], hist, "text", [1, 3, 5], pool_map)
    c = bases.integrated(cfg["history"], hist, "text", [5, 3], pool_map)
    assert calls == [2, 1]  # 1 and 3, then 5 alone, then nothing
    assert a[0] is None and a[2] is None and c[1] is None
    want = bases.integrate((hist[3], "text"))
    for got in (a[3], b[3], c[3]):
        assert (got.ids, got.dead, got.chars, got.sv, got.ds) == (
            want.ids, want.dead, want.chars, want.sv, want.ds)
    # another fixture (another pinned sha256) has a cache of its own
    other = dict(cfg["history"], sha256="f" * 64)
    bases.integrated(other, hist, "text", [3], pool_map)
    assert calls == [2, 1, 1]
