"""The general traffic generator: every tick of a run, made before it starts.

A traffic mix is a data file (``traffic/<name>.json``) of parameters; this
module is the one generator that reads them.  A run is a closed loop of
ticks fixed by count.  Each tick delivers ``keystrokes`` single-keystroke
updates to rooms drawn from the mix's popularity, then either flushes or
answers ``joins`` sync-step-1 messages in one batch (which flushes first).

Keystrokes follow the B4 editing texture: a room's one new client types at
a cursor, runs of backspaces take a ``delete_share`` of them, and a
``jump_share`` of them first move the cursor to a random place.  An insert
takes Yjs ``insertText``'s neighbours: after the cursor's visible
character and the deleted items that follow it, before the next visible
one.

Everything is encoded as Yjs v1 bytes into a few flat buffers with offset
arrays, so the measured window only slices its next update and reads the
clock: no generator thread, queue or hand-over runs inside it, and the
collector has nothing of it to walk.
"""

from __future__ import annotations

import math
import multiprocessing
import random
from array import array
from concurrent.futures import ProcessPoolExecutor

from . import ycodec


class TrafficExhausted(RuntimeError):
    pass


def rng_for(seed: int, what: str) -> random.Random:
    """An independent stream of the run's seed for one purpose."""
    return random.Random(f"{seed}/{what}")


class Popularity:
    """Room draws: ``uniform``, or ``zipf`` with exponent ``theta`` over
    ``order`` (the rooms, hottest first)."""

    def __init__(self, spec: dict, order: list[int]):
        n_rooms = len(order)
        self.n = n_rooms
        self.kind = spec["kind"]
        if self.kind == "zipf":
            theta = spec["theta"]
            self.rooms = order
            acc = 0.0
            self.cum = []
            for k in range(1, n_rooms + 1):
                acc += 1.0 / k ** theta
                self.cum.append(acc)
        elif self.kind != "uniform":
            raise ValueError(f"unknown popularity {self.kind!r}")

    def draw(self, rng: random.Random, k: int) -> list[int]:
        if self.kind == "uniform":
            return [rng.randrange(self.n) for _ in range(k)]
        return rng.choices(self.rooms, cum_weights=self.cum, k=k)

    def hottest(self) -> int | None:
        return self.rooms[0] if self.kind == "zipf" else None


def ranking(n_rooms: int, seed: int) -> list[int]:
    """The rooms by the keystrokes' popularity, hottest first: a shuffle
    the seed draws (every room alike under ``uniform``)."""
    order = list(range(n_rooms))
    rng_for(seed, "rank").shuffle(order)
    return order


class Typist:
    """One room's new client: its copy of the room's item order, its
    cursor, and its clock."""

    __slots__ = ("seq", "dead", "cursor", "client", "clock", "deleting",
                 "p_start_del", "p_stop_del", "p_jump", "alphabet", "root")

    def __init__(self, ids, dead, client: int, ks: dict, root: str, rng):
        self.seq = ids.tolist()
        self.dead = bytearray(dead)
        self.cursor = rng.randrange(len(self.seq) + 1)
        self.client = client
        self.clock = 0
        self.deleting = False
        s = ks["delete_share"]
        run = ks["mean_delete_run"]
        self.p_stop_del = 1.0 / run
        self.p_start_del = 1.0 / (run * (1.0 - s) / s)
        self.p_jump = ks["jump_share"]
        self.alphabet = ks["alphabet"]
        self.root = root

    def keystroke(self, rng: random.Random):
        """One keystroke: ``("i", origin, right, char)`` or ``("d", id)``."""
        seq, dead = self.seq, self.dead
        if rng.random() < self.p_jump:
            self.cursor = rng.randrange(len(seq) + 1)
        if self.deleting:
            if rng.random() < self.p_stop_del:
                self.deleting = False
        elif rng.random() < self.p_start_del:
            self.deleting = True
        if self.deleting:
            j = self.cursor - 1
            while j >= 0 and dead[j]:
                j -= 1
            if j >= 0:
                dead[j] = 1
                self.cursor = j
                return ("d", seq[j])
            self.deleting = False  # nothing left of the cursor: type
        i = self.cursor
        n = len(seq)
        while i < n and dead[i]:
            i += 1
        origin = seq[i - 1] if i > 0 else None
        right = seq[i] if i < n else None
        me = ycodec.pack_id(self.client, self.clock)
        self.clock += 1
        seq.insert(i, me)
        dead.insert(i, 0)
        self.cursor = i + 1
        return ("i", origin, right, rng.choice(self.alphabet))

    def encode(self, ks) -> bytes:
        """One keystroke as its own v1 update."""
        if ks[0] == "d":
            return ycodec.encode_delete(ks[1])
        _, origin, right, ch = ks
        return ycodec.encode_insert(self.client, self.clock - 1, origin, right,
                                    ch, self.root)


class Traffic:
    """Every update and message of a run, in flat buffers.

    ``load``: (room, update) pairs delivered before the one loading flush.
    Tick ``t`` sends edits ``tick_edits[t]:tick_edits[t+1]`` (bytes
    ``edit_buf[edit_off[i]:edit_off[i+1]]`` to room ``edit_room[i]``),
    then joins ``tick_joins[t]:tick_joins[t+1]`` likewise.  ``k1_*`` are
    the rows, deletes and rooms each tick's flush applies.  Tick 0 is the
    warm tick, run in set-up."""

    def __init__(self):
        self.guids: list[str] = []
        self.clients: list[int] = []
        self.load: list[tuple[int, bytes]] = []
        self.edit_buf = bytearray()
        self.edit_off = array("q", [0])
        self.edit_room = array("i")
        self.tick_edits = array("q", [0])
        self.join_buf = bytearray()
        self.join_off = array("q", [0])
        self.join_room = array("i")
        self.join_stale = array("b")
        self.tick_joins = array("q", [0])
        self.k1_rows = array("q")
        self.k1_deletes = array("q")
        self.k1_rooms = array("q")
        self.hottest: int | None = None

    @property
    def n_ticks(self) -> int:
        return len(self.tick_edits) - 1


def ticks_needed(mix: dict, seconds: float) -> int:
    """The warm tick plus three times the ticks of the fastest window the
    mix was sized for, at ``seconds``."""
    return 1 + math.ceil(3.0 * mix["sized_for_ticks_per_s"] * seconds)


def _room_job(job):
    """Type the keystrokes of some rooms of one history.

    ``job``: (ids, dead, root, ks, seed, rooms): the history's item ids in
    document order and their deleted flags (from its :class:`~.bases.Base`),
    and the rooms as (room, client, tail, n).  Returns, per room, its tail
    update (or None), the tail's inserts, and its ``n`` window keystrokes:
    one bytes object, their offsets and whether each inserted (1) or
    deleted (0)."""
    ids, dead, root, ks, seed, rooms = job
    out = []
    for r, client, tail, n in rooms:
        rng = rng_for(seed, f"room/{r}")
        t = Typist(ids, dead, client, ks, root, rng)
        tail_u = None
        if tail:
            items, deletes = [], []
            for _ in range(tail):
                k = t.keystroke(rng)
                if k[0] == "d":
                    deletes.append(k[1])
                else:
                    items.append(k[1:])
            tail_u = ycodec.encode_session(client, 0, items, deletes, root)
        buf = bytearray()
        off = array("q", [0])
        kinds = bytearray(n)
        for i in range(n):
            k = t.keystroke(rng)
            kinds[i] = k[0] == "i"
            buf += t.encode(k)
            off.append(len(buf))
        out.append((r, tail_u, t.clock - sum(kinds), bytes(buf), off, bytes(kinds)))
    return out


def _jobs(bases, room_base, counts, clients, tail, root, ks, seed, workers):
    """One job a history, or up to ``workers`` jobs where a history has
    many rooms (eight a job at least)."""
    by_h: dict[int, list[int]] = {}
    for r, h in enumerate(room_base):
        by_h.setdefault(h, []).append(r)
    jobs = []
    for h, rooms in sorted(by_h.items()):
        parts = max(1, min(workers, len(rooms) // 8))
        for k in range(parts):
            part = rooms[k::parts]
            spec = [(r, clients[r], tail, counts[r]) for r in part]
            jobs.append((h, (bases[h].ids, bases[h].dead, root, ks, seed, spec)))
    return jobs


def make(cfg: dict, mix: dict, history: list[bytes], bases: list,
         room_base: list[int], seed: int, n_ticks: int,
         workers: int = 1) -> Traffic:
    """All traffic of a run of configuration ``cfg`` under ``mix``.

    Room ``r`` starts from ``history[room_base[r]]``, integrated as
    ``bases[room_base[r]]``.  The tick plan (which room each keystroke and
    join goes to) is drawn here; each room's keystrokes come from its own
    stream of the seed, typed in ``workers`` spawned processes, and are
    then laid into the ticks in order."""
    n_rooms = cfg["rooms"]
    root = cfg["root"]
    tail = cfg.get("tail_keystrokes", 0)
    tr = Traffic()
    tr.guids = [f"room-{r:05d}" for r in range(n_rooms)]
    tr.clients = rng_for(seed, "clients").sample(range(1 << 20, 1 << 32), n_rooms)
    edits = Popularity(mix["keystroke_rooms"], ranking(n_rooms, seed))
    tr.hottest = edits.hottest()
    draws = rng_for(seed, "rooms")
    k = mix["keystrokes_per_tick"]
    plan = [edits.draw(draws, k) for _ in range(n_ticks)]
    joins = Popularity(mix["join_rooms"], ranking(n_rooms, seed))
    jplan = [joins.draw(draws, mix["joins_per_tick"]) for _ in range(n_ticks)]
    counts = [0] * n_rooms
    for rooms in plan:
        for r in rooms:
            counts[r] += 1
    jobs = _jobs(bases, room_base, counts, tr.clients, tail, root,
                 mix["keystroke"], seed, workers)
    typed: dict[int, tuple] = {}
    clock = [0] * n_rooms  # each room's new client's inserts so far
    for h, rooms in zip((h for h, _ in jobs),
                        pool_map(_room_job, [j for _, j in jobs], workers)):
        for r, tail_u, tail_rows, buf, off, kinds in rooms:
            typed[r] = (buf, off, kinds)
            clock[r] = tail_rows
            tr.load.append((r, history[h]))
            if tail_u is not None:
                tr.load.append((r, tail_u))
    tr.load.sort(key=lambda x: x[0])  # a room's history before its tail
    nxt = [0] * n_rooms
    stale = rng_for(seed, "stale")
    lo, hi = mix.get("stale_suffix", (0.0, 0.0))
    ebuf = tr.edit_buf
    for t in range(n_ticks):
        rows = 0
        for r in plan[t]:
            buf, off, kinds = typed[r]
            i = nxt[r]
            nxt[r] = i + 1
            ebuf += buf[off[i]:off[i + 1]]
            tr.edit_off.append(len(ebuf))
            tr.edit_room.append(r)
            if kinds[i]:
                rows += 1
                clock[r] += 1
        tr.tick_edits.append(len(tr.edit_room))
        tr.k1_rows.append(rows)
        tr.k1_deletes.append(len(plan[t]) - rows)
        tr.k1_rooms.append(len(set(plan[t])))
        for r in jplan[t]:
            is_stale = stale.random() < mix["stale_share"]
            sv = {}
            if is_stale:
                full = dict(bases[room_base[r]].sv)
                if clock[r]:
                    full[tr.clients[r]] = clock[r]
                sv = {c: v - math.ceil(stale.uniform(lo, hi) * v)
                      for c, v in full.items() if v}
            tr.join_buf += ycodec.encode_step1(sv)
            tr.join_off.append(len(tr.join_buf))
            tr.join_room.append(r)
            tr.join_stale.append(1 if is_stale else 0)
        tr.tick_joins.append(len(tr.join_room))
    return tr


def pool_map(fn, jobs, workers):
    """``[fn(j) for j in jobs]``, in ``workers`` spawned processes."""
    if workers <= 1 or len(jobs) <= 1:
        return [fn(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        return list(pool.map(fn, jobs, chunksize=max(1, len(jobs) // (workers * 4))))
