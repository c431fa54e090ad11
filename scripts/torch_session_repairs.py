#!/usr/bin/env python3
"""Where the anti-entropy repairs of ``chip_smoke.py``'s ``[session]``
phase fall, round by round.

    python3 scripts/torch_session_repairs.py ROOMS [--quiet TICKS]
        [--device cpu|cuda] [--workers N]

Runs the smoke's ``session_path`` alone (no child processes) at ``ROOMS``
rooms, with the settle's quiet window set to ``TICKS`` (the smoke's
``SESSION_QUIET_TICKS`` by default), on the card or, with ``--device
cpu``, on the kernels' plain versions.  It counts, on the card's pair
(its CPU twin, in a process of its own, repeats its schedule frame for
frame), each digest a session sends and each repair a session makes, by
the round and the tick after that round's deal, and prints them with the
phase's session counters as one JSON line (round 4's later ticks
include the settle after the TCP clients).  A repair is a digest that
reached the side holding an update its sender lacked.
"""

from __future__ import annotations

import argparse
import collections
import json
import multiprocessing
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402

WORKERS = 2


def _pool(n_jobs: int):
    return multiprocessing.get_context("spawn").Pool(min(WORKERS, n_jobs))


def main() -> int:
    global WORKERS
    ap = argparse.ArgumentParser()
    ap.add_argument("rooms", type=int)
    ap.add_argument("--quiet", type=int, default=S.SESSION_QUIET_TICKS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=WORKERS)
    args = ap.parse_args()
    WORKERS = args.workers
    S.SESSION_QUIET_TICKS = args.quiet
    S.worker_pool = _pool
    S._child_runs = lambda device, snap_dir=None: {}
    os.environ["YTPU_SYNC_DEVICE"] = "1"
    from yjs_tpu_torch.sync import session as M

    at = {"round": 0, "tick": 0}
    repairs, digests = collections.Counter(), collections.Counter()
    deal, tick = S.SessionPair.deal, S.SessionPair.tick
    on_digest, send_digest = M.SyncSession._on_digest, M.SyncSession._send_digest

    def counted_deal(pair, k, pieces):
        at.update(round=k + 1, tick=0)
        return deal(pair, k, pieces)

    def counted_tick(pair):
        at["tick"] += 1
        return tick(pair)

    def counted_on_digest(sess, dec):
        before = sess.n_repairs
        on_digest(sess, dec)
        if sess.n_repairs > before:
            repairs[f"{at['round']}:{at['tick']}"] += 1

    def counted_send_digest(sess):
        digests[f"{at['round']}:{at['tick']}"] += 1
        return send_digest(sess)

    S.SessionPair.deal, S.SessionPair.tick = counted_deal, counted_tick
    M.SyncSession._on_digest = counted_on_digest
    M.SyncSession._send_digest = counted_send_digest
    fig = S.session_path(S.load_traces(), "", device=args.device,
                         n_rooms=args.rooms)
    print(json.dumps({
        "rooms": args.rooms, "quiet_ticks": args.quiet,
        "device": args.device, "counters": fig["counters"],
        "round_ticks": [r["ticks"] for r in fig["rounds"]],
        "repairs_at_round_tick": dict(repairs),
        "digests_at_round_tick": dict(digests),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
