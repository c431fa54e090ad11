#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with an NVIDIA card
(sm_90a: H100/H200).  It imports nothing of JAX or of the JAX package.
Phases, each printed on its own lines; any failed check raises and the
script exits non-zero:

1. device: the card's name and count, and ``nvidia-smi``'s name and
   power limit;
2. build: the native plan core (g++) and the eleven CUDA sources (one
   nvcc per source, all at once), with build seconds, each kernel's
   registers and spills, and each YATA step instantiation's shared,
   global and generic loads and stores (``cuobjdump -sass``);
3. main path: a room server's fleet, ``BatchEngine(n_docs=4096)`` on the
   card beside a CPU twin ``BatchEngine(4096, device="cpu")`` that runs
   the kernels' plain versions on the same bytes:
   - flush 1 gives every doc one of the fixture's 1024 distinct 1500-op
     traces, cycled (dense apply lanes);
   - flush 2 sends a seeded editor's edits of 64 traces to every doc
     holding them (sparse and delete lanes), after compacting every doc
     of at least 512 rows (scatter_rows);
   - 16 docs go through export_doc_columns / reset_doc /
     hydrate_doc_columns (scatter_rows);
   - 32 sampled docs export text() and encode_state_as_update() from the
     device tables (list_ranks), checked against a CPU ``Doc`` fed the
     same bytes;
   after each step the card's three tables must equal the twin's;
4. provider path: the README's ``TpuProvider(n_docs=4096)`` on the card
   beside a CPU twin ``TpuProvider(4096, device="cpu")``, each
   journaling to its own WAL directory, under ``YTPU_SYNC_DEVICE=1``
   (the device sync branch):
   - every room gets its fixture trace, ``flush()``, then the seeded
     editors' edits, ``flush()`` (tables equal the twin's after each);
   - a reconnect storm: 4096 sync-step-1 messages in one
     ``handle_sync_step1_batch`` (one ``diff_mask_kernel`` launch), a
     third from new clients, a third from clients holding the state
     after flush 1, a third up to date; replies equal the twin's byte
     for byte, and 32 sampled clients converge to the room's text and
     state vector after applying theirs;
   - ``engine.state_vectors_batched`` over all rooms
     (``state_vector_kernel``) equals every per-doc state vector;
   - ``checkpoint()`` (one diff-mask launch over the fleet), then
     ``TpuProvider.recover`` on the card: every room's state vector
     equals the twin's and sampled texts equal the CPU ``Doc``;
   with the host times of the storm's phases, the checkpoint and the
   recovery;
5. YATA path: the on-device YATA lanes at the same width and on the same
   bytes:
   - ``YTPU_KERNEL=levels``: ``BatchEngine(4096)`` on the card beside a
     CPU twin ``BatchEngine(4096, device="cpu")``; flush 1 (the traces),
     then flush 2 (the edits, after compacting every doc of at least 512
     rows); after each, the card's three tables and six resident static
     columns equal the twin's byte for byte, untrimmed, its tables trimmed
     to live rows equal the main path's apply engine's, and every doc's
     current statics equal its mirror's ``static_columns()``; 32 sampled
     docs export text and encoded state from the device tables, checked
     against a CPU ``Doc``;
   - ``YTPU_KERNEL=seq``: ``BatchEngine(4096)`` on the card through the
     same flushes, its trimmed tables equal to the levels and the apply
     engines';
   each flush runs under a CUDA activity trace (``torch.profiler``), and
   its host time is split into plan, pack, statics (host pack; pinned
   copy and launch), dispatch, emit and the closing synchronise, its
   device time into kernels and copies, with the device's idle share;
6. planner path: the Python mirror's device cold planner
   (``YTPU_NO_NATIVE_PLAN=1``, ``YTPU_PLAN_SEGMENT`` unset, so the
   whole-chunk ``device`` mode) on ``BatchEngine(512)`` on the card
   beside a CPU twin (in a spawned process of its own, each flush beside
   the card's), one doc per distinct fixture trace, the first 512
   of its 1024 (a 4096-doc fleet of the 1024 plans twice this chunk, its
   other 3072 docs replaying the plan cache; the depth is cut to keep the
   script's time as the service phases grow):
   - flush 1 loads the traces (one chunk conflict scan, K12, over every
     doc's refs);
   - flush 2 gives every doc a seeded burst of 40 edits by three
     interleaving editors (a chunk scan and one chunk anchor lookup, K11,
     over every doc's fragment index);
   - flush 3 gives doc 0 a second burst (a lone cold doc plans per doc);
   after each, the tables equal the twin's, nothing is demoted or rolled
   back and ``plan_threads`` is the co-planned doc count; flush 1's
   trimmed tables equal the main path's (native planner); 32 sampled
   docs' texts and encoded states equal a CPU ``Doc``; each flush runs
   under a CUDA activity trace, its host time split into plan (the
   segment planner's share), pack, dispatch and emit;
7. broadcast path (the B4 replay shape): one trace planned once by a
   Python mirror on the card and fanned out over 4096 docs by
   ``apply_plan_shared`` (K7a) and ``batch_step_levels_shared`` (K7b),
   each held against ``apply_lanes`` and ``batch_step_levels`` fed the
   same inputs replicated per doc, table for table, the two against each
   other on the live rows, and doc 0's text against a CPU ``Doc``;
8. mesh path: the doc-sharded engine (``BatchEngine(4096, mesh=)``) on
   a ``DocMesh`` of four shards that share the card (1024 docs a
   shard), its plan cache shared with the earlier phases:
   - the apply lane's flush 1, flush 2 (with compaction), the 16
     warm-tier round trips and the 32 exports, each step's trimmed
     tables equal to the main path's unmeshed engine's
     (``sharded_apply_plan``, K14);
   - the levels lane's two flushes, trimmed tables equal to the YATA
     path's (``sharded_batch_step``, K15);
   - ``state_vectors_batched`` over every doc equal to the unmeshed
     engine's and 32 CPU Docs' (``sharded_state_vectors``, K16), and K16
     on a 2 x 2 (docs x rows) mesh equal to unsharded K9, each one K16
     launch and no fold by the wrappers' counts (the row shards meet in
     one output on the card);
   - a 64-doc Python-mirror meshed engine (``YTPU_NO_NATIVE_PLAN=1``)
     beside a CPU-mesh twin, both planning cold: traces, then a seeded
     burst whose chunk plan runs the sharded lookup (K13); tables equal
     the twin's;
   every flush's ``last_metrics`` (the shards' device counters folded by
   ``shard_fold`` on the card) equals the plain fold of the counters of
   its dispatched inputs;
9. fleet path, under ``YTPU_SYNC_DEVICE=1`` as are the next three:
   ``FleetRouter(8, 1024)`` on the card (every shard's engine on the one
   card, replication at its default factor 1) beside a CPU twin fleet
   ``FleetRouter(8, 1024, device="cpu")`` (in a spawned process of its
   own, each step beside the card's, compared by fingerprints: each
   doc's trimmed tables and each room's encoded state by digest), each
   journaling to its own WAL root, fed the main path's traces over 4096
   rooms:
   - one flush (``apply_lanes`` checked to launch at least once for each
     shard with pending rooms);
   - 64 live migrations (``migrate_doc``) and a flush, a drain of one
     shard, a rebalancer ``tick()``;
   - a shard killed, failed over (``fail_over``) and its promoted rooms
     flushed, then revived (its fresh engine checked to be on the card);
   - ``checkpoint()``, ``close(checkpoint=False)``, then
     ``FleetRouter.recover`` on the card;
   after each step both fleets have the same live shards, routing epoch
   and placements, every shard's trimmed tables equal the twin's slot
   for slot, and every room's encoded state the twin's; after the revive
   and the recovery 32 sampled rooms (half of them rooms the failover
   found without a replica) equal a CPU ``Doc``; with the flush wall and
   elements a second, migrations a second, the kill-to-converged and
   recovery walls, and ``torch.cuda.memory_allocated`` before the kill,
   after the failover and after the revive;
10. geo path: two regions, each a ``TpuProvider(1024)`` on the card with
   a ``GeoReplicator``, linked by a pair of in-memory pipes without
   faults; region A takes every room's fixture trace, region B a
   concurrent edit of every room; the replicators tick until every
   room's state vector agrees on live links; both regions' rooms equal
   each other and a CPU ``Doc``; with the ticks and seconds to
   convergence and the delta bytes each link shipped;
11. capacity ramp: ``ramp_capacity`` over providers on the card, stages
   of 8 to 64 sessions, into a TSDB of its own; every stage must be
   recorded there and the knee read back from it; with the knee and
   ``sessions_per_device``;
12. cluster path: the port's process cluster, ``Supervisor(4, ...,
   docs_per_shard=1024, backend="auto", device="cuda")``: four shard
   processes (``python -m yjs_tpu_torch.cluster.shard --device cuda``),
   each its own CUDA context on the card, beside a CPU twin cluster
   (``device="cpu"``, its children running the plain kernels) fed every
   update and sync frame the card's facade accepted, and a gateway over
   the card's:
   - spawn: every child's ready line names the card; the seconds from
     spawn to ready, a child;
   - 1024 rooms (room r gets fixture trace r) through the facade, four
     calls in flight a cluster, then every live shard flushed through a
     call that raises;
     32 sampled texts equal a CPU ``Doc``;
   - 16 clients on 8 rooms, a y-websocket and a session client (the
     launcher's ``WsClient`` and ``SessionClient``) in each, 64 seeded
     edits each: edit-to-visible p50 and p99, every client converged to
     its room's server text;
   - kill -9 of an edited room's owner while a stream of 40 edits to
     another of its rooms and a flush are in flight: the child restarts
     through ``recover`` on the card, no acked edit is lost;
   - the same shard killed again, past ``restart_max``: failover, the
     promoted successors recover-restarted on the card;
   - the federated snapshot, the children's launch counts (the
     ``launches`` RPC, read before each kill, before every ``shutdown``
     call and after a checkpoint) and each child's memory on the card
     (``nvidia-smi``); a graceful close checkpoints every shard;
   - supervision reported the planned restart and failover and nothing
     else, and every child either cluster started exited 0, the two
     killed ones -9;
   after each step every room's full diff equals the twin's byte for
   byte (in canonical form once a shard replayed its WAL, which merges
   structs that live flushes kept apart) and its state vector the twin's
   as a map;
13. session path, under ``YTPU_SYNC_DEVICE=1`` and ``YTPU_EXPORT_DEVICE=1``:
   two providers on the card, A and B, each ``TpuProvider(2048)`` with a
   WAL (rooms cut from the README's 4096 for time), one session pair a
   room over one ``PipeNetwork`` behind a seeded ``NetworkFaultInjector``
   (drop 0.05, duplicate 0.02, reorder 0.05, delay 0.05, one partition
   that heals), beside a CPU twin pair (``device="cpu"``, in a spawned
   process of its own, each step beside the card's) driven by the same
   seeded injector and schedule:
   - each room's fixture trace cut into four updates (each client's
     structs at a quarter, a half and three quarters of its clock; cut
     by eight spawned workers), dealt between A and B in four rounds,
     each round receive, flush, tick the sessions and settle;
   - after round 2 B is killed without a checkpoint, recovered from its
     WAL on the card, and its sessions catch up by delta replay (A's
     sessions resume, none resyncs in full);
   - 32 ``examples/torch_socket_connector.py`` clients over loopback TCP
     on 32 rooms of A, ``--provider`` sessions served on this thread
     (``yjs_tpu_torch.cluster.gateway.ProviderHost``): each syncs, then all edit at once eight times;
     edit-to-visible is the time until A's flushed state vector covers
     the edit; every client converges with A, B takes the edits;
   - after each round the frames (a digest of every frame in order),
     A's and B's device tables byte for byte and every room's state
     vector equal the twin's; after the TCP edits, whose timing the
     twin cannot replay (its A takes the same updates afterwards), the
     states: state vectors, and full diffs byte for byte but in the TCP
     rooms (canonical there); every room on A and B equals a CPU ``Doc``
     fed its whole trace and its TCP edits (text, state vector as a map,
     full diff in canonical form; eight spawned workers);
   - ``scripts/torch_ytpu_stats.py --demo --json``,
     ``scripts/torch_ytpu_top.py --demo --once --plain`` and
     ``examples/torch_server_demo.py`` as child processes on the card
     beside those checks, then A's checkpoint and
     ``scripts/torch_ytpu_top.py <dir> --once --plain`` over A's and B's
     metrics snapshots: each child must exit 0 with its expected rows
     (no child and no worker runs while the rounds and the TCP edits
     are timed);
   with rounds, ticks and seconds to converge, the session counters
   (frames sent, dropped, retransmitted, repairs), A's flush elements a
   second, B's kill-to-caught-up seconds and TCP edit-to-visible p50 and
   p99;
14. gate: the port's CI checks and the doc-free batch ops on the card
   (``gate_path``):
   - the fixture's first 128 traces (cut from 256 for time), each cut
     into eight updates (by eight spawned workers, which also compute
     the CPU results), go through ``merge_updates_columnar``, then
     ``encode_state_vector_from_update_columnar`` of the first update and
     ``diff_update_columnar`` of the merge against that state vector,
     under ``YTPU_NO_NATIVE_PLAN=1`` with ``device="cuda"`` (the Python
     mirror's per-doc plan, ``conflict_scan`` on the card; a fresh
     mirror's anchors all lie in its own batch, so the anchor lookup has
     nothing to search); every result equals the same call's with
     ``device="cpu"`` byte for byte, and that one the CPU core's
     ``merge_updates`` / ``diff_update`` in canonical form and its state
     vector as a map; timed alone, as docs a second;
   - ``scripts/torch_check_trace.py``'s ``selftest()`` and
     ``scripts/torch_check_metrics_schema.py``'s ``main([])`` in this
     process with their defaults (the card, backend ``auto``): each
     returns 0, and the selftest's fleet launches ``apply_lanes``;
   - ``scripts/torch_ytpu_cluster.py --shards 2 --smoke`` as a child
     with no ``--backend`` and no ``--device``: it exits 0 with its
     ``smoke: OK`` line, its shards on the card, and its shards'
     ``launches`` RPC shows ``apply_lanes`` launched;
15. kernels: each kernel against its plain version on the card at its
   path's largest shapes (exact), with times from CUDA events (``ms``:
   per call, launch gaps included; the YATA steps restore their tables
   before each timed launch and time it alone), device time from
   ``torch.profiler`` (``device_ms``; not for the YATA steps, whose
   device ms come from ``scripts/torch_yata_ab.py``) and the byte bound,
   printed as one
   ``{"kernels": [...]}`` line; each row's ``launches`` is its path's
   count (counts are zeroed just before each path and read just after);
   the YATA steps' rows add the longest per-doc chain of dependent loads
   (``dep_chain``), which limits them (``limited_by``), the measured
   time per load, the variant the size picked (``variant``: checked
   against ``SMOKE_VARIANT``: at 4097 rows a doc's rows stay in global
   memory, at the broadcast step's ~1400 all but the visit row are staged
   in shared memory), its staged ``smem_bytes``, ``threads`` a block and
   ``blocks_per_sm``; K5's and K6's add ``variants``: the first 32 docs
   of their input in each variant, forced, and widened to N+1 = 16385,
   each equal to its plain version, with its events ms; the
   planner kernels' rows add the pageable host copies around them
   (``h2d_ms``, ``d2h_ms``); the fold's, K13's and K11's rows
   add ``ms_obs_off`` (the same events loop with the kernel profiler off)
   and ``host_us`` (one call's host time by ``time.perf_counter`` over
   1000 calls, split into the profiler, the checks and allocation, the
   device guard and stream lookup, and the ctypes call with its launch),
   K1's and K2's rows add ``host_us`` too, K14's and K15's rows add
   ``host_us`` (K15's on an empty schedule of the same shapes, so that
   the calls do no YATA work) and the devices their shards lie on, and
   K1's and K14's rows add the ``variant`` that ran ("staged": each lane
   block scans its section's counts in shared memory), and K1's, K14's
   and K15's rows add ``launches_a_call`` (the wrappers'
   launch counts over one call: one launch a device, checked) and
   ``kernels_a_call`` (the kernels one call launches, by name, from
   ``torch.profiler``, which may lose an event: checked to be no more
   than one a device);
   K16's row adds ``launches_a_call`` on the 1-D and on the 2 x 2
   (docs x rows) mesh of the card, each checked to be one launch and no
   fold, ``ms_2x2`` and ``host_us``; K8's adds the ``variant`` it ran
   (checked: "staged", in shared memory, at the export's N+1 = 2049),
   the ``rounds`` it ran of ``max_rounds``, its staged ``smem_bytes``,
   ``host_us`` and an empty kernel's events and device ms through the
   same launch path (``floor_ms``, ``floor_device_ms``), the floor under
   any one-launch call;
   K13's ``library_one_ms`` (one ``torch.searchsorted`` over the whole
   query, which on one card computes the same function) and K11's time
   with its shared-memory sample staged and not staged, in turns, each
   from 50 launches replayed back to back from a CUDA graph
   (``graph_ms_staged``, ``graph_ms_unstaged``);
   K7a's two rows (``apply_plan_shared`` at the broadcast path's 4096
   docs, ``apply_plan_shared_b4`` at the B4 replay's 16384, held to the
   plain version at 1024) and K10's row add ``launches_a_call`` and
   ``kernels_a_call`` (checked: one launch, one kernel) and ``host_us``;
   K7a's add ``library_ms`` (``index_put_`` x3 on the in-bound lanes,
   filtered once outside the timed call) and ``docs_a_block``; K10's
   ``bound_ms`` counts row_clock only where a row is needed (the kernel
   reads no other), and ``bound_ms_all_read`` every clock;
   K12's two rows (chunk and per doc) are held to the plain version on
   the planner's captured input, on a doc at every tile edge and on one
   chained run through 2**20 lanes, and add ``kernels_a_call`` (checked:
   one kernel), ``ms_obs_off``, ``host_us``, ``graph_ms`` (50 calls
   replayed from a CUDA graph), ``lanes_a_thread`` and ``tiles``;
   every row adds ``launches_fleet``, ``launches_geo``,
   ``launches_capacity``, ``launches_cluster``, ``launches_session`` and
   ``launches_gate``, its launches on the five service paths and the
   gate (the cluster's and the gate launcher's in their shard children);
16. the last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import random
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "distinct_traces_1500.bin.z"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
N_DOCS = 4096  # the README's TpuProvider(n_docs=4096) fleet
N_EDITED = 64
N_HYDRATED = 16
N_EXPORTED = 32
N_SAMPLED_CLIENTS = 32
TIMED_LAUNCHES = 50
HOST_SPLIT_CALLS = 1000
YATA_TIMED_LAUNCHES = 20
# The YATA steps' rows carry no profiler device time: in this long run
# their traces, of 20 calls or of 10, read a third to two thirds of what
# scripts/torch_yata_ab.py reads in a fresh process with the same traces,
# beside events that agree with the latter; their ms are events.


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def load_traces() -> list[bytes]:
    """The fixture's distinct traces: ``<II`` count and ops, then
    ``<I``-length-prefixed updates (one per trace)."""
    raw = zlib.decompress(FIXTURE.read_bytes())
    count, n_ops = struct.unpack_from("<II", raw, 0)
    check(n_ops == 1500, f"fixture holds {n_ops}-op traces")
    out, o = [], 8
    for _ in range(count):
        (ln,) = struct.unpack_from("<I", raw, o)
        out.append(raw[o + 4 : o + 4 + ln])
        o += 4 + ln
    return out


def editor_edits(Y, trace: bytes, seed: int) -> list[bytes]:
    """A few incremental edits by a seeded editor holding ``trace``."""
    gen = random.Random(seed)
    doc = Y.Doc(gc=False)
    doc.client_id = 70000 + seed
    Y.apply_update(doc, trace)
    text = doc.get_text("text")
    out = []
    for _ in range(4):
        sv = Y.encode_state_vector(doc)
        if len(text) > 8 and gen.random() < 0.5:
            text.delete(gen.randrange(len(text) - 4), gen.randint(1, 3))
        else:
            text.insert(gen.randrange(len(text) + 1), gen.choice(["ab", "xyz "]))
        out.append(Y.encode_state_as_update(doc, sv))
    return out


# -- phase 1 and 2 ----------------------------------------------------------------


def device_phase() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}")
    log(smi)
    return {"name": name, "count": count, "smi": smi}


def build_phase() -> None:
    from yjs_tpu_torch import native
    from yjs_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        plan = pool.submit(native.load)
        kernels = pool.submit(_cuda.build_all)
        info = kernels.result()
        lib = plan.result()
    check(lib is not None and native.has_plancore(), "native plan core built")
    log(f"[build] wall {time.perf_counter() - t0:.2f}s; "
        f"g++ plan core {native.build_seconds:.2f}s; launches read the "
        f"stream with {_cuda.stream_lookup}")
    for name, rec in info.items():
        log(f"[build] nvcc {name}.cu {rec['seconds']:.2f}s")
        for line in _cuda.ptxas_summary(rec["ptxas"]):
            log(f"[build]   {line}")
    for kernel, ops in sass_memory_ops(info["yata"]["path"]).items():
        log(f"[build]   yata.cu SASS {kernel}: " + ", ".join(
            f"{op} {n}" for op, n in sorted(ops.items())))


def sass_memory_ops(path: str) -> dict:
    """Per kernel template instance of a built library (``name<args>``,
    the variant as its index in ``kernels.YATA_VARIANTS``), its shared
    (LDS, STS), global (LDG, STG) and generic (LD, ST) memory
    instructions, from ``cuobjdump -sass``; {} where the toolkit has no
    cuobjdump.  The staged YATA variants' rows are read and written by
    LDS and STS."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("[build]   cuobjdump not found: SASS not read")
        return {}
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(
            r"Function : \S*?\d([a-z][a-z_]*_kernel)I((?:L[bi]\d+E)+)E", line)
        if m:
            args = re.sub(r"Lb([01])E", lambda g: ("false", "true")[
                int(g.group(1))] + ",", m.group(2))
            args = re.sub(r"Li(\d+)E", r"\1,", args).rstrip(",")
            cur = out.setdefault(f"{m.group(1)}<{args}>", {})
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
        if cur is not None and m and m.group(1) in (
                "LDS", "STS", "LDG", "STG", "LD", "ST"):
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return out


# -- phase 3 ----------------------------------------------------------------------


MAIN_KERNELS = (
    ("apply_lanes", lambda a: a[1].numel()),
    ("scatter_rows", lambda a: a[4].numel()),
    ("list_ranks", lambda a: a[0].numel()),
)
PROVIDER_KERNELS = (
    ("state_vector_kernel", lambda a: a[0].numel()),
    ("diff_mask_kernel", lambda a: a[0].numel()),
)


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (tuple, list)) else ()
    )
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


class Capture:
    """Keeps the largest input each kernel wrapper saw on a path (for
    the kernel phase), delegating every call to the wrapper itself.
    ``watched`` holds ``(name, size)`` or ``(name, size, key)`` entries:
    ``key(args)`` names the variant the input is kept under."""

    def __init__(self, kernels, watched, device_type: str = "cuda"):
        self.kernels = kernels
        self.watched = watched
        self.device_type = device_type
        self.seen: dict = {}
        self._orig = {}

    def __enter__(self):
        k = self.kernels
        for name, size, *key in self.watched:
            orig = getattr(k, name)
            self._orig[name] = orig

            def wrapped(*args, _orig=orig, _size=size,
                        _key=(key[0] if key else lambda a, n=name: n),
                        **kwargs):
                # the CPU twin's calls are not kept
                if _first_tensor(args).device.type == self.device_type:
                    best = self.seen.get(_key(args))
                    if best is None or _size(args) > _size(best):
                        self.seen[_key(args)] = _clone(args)
                return _orig(*args, **kwargs)

            setattr(k, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self.kernels, name, orig)
        return False


def assert_twins(eng, twin, what: str, tag: str = "main") -> None:
    for name in ("_right", "_deleted", "_starts"):
        a, b = getattr(eng, name), getattr(twin, name)
        check(a.shape == b.shape, f"{what}: {name} shape {a.shape} vs {b.shape}")
        check(torch.equal(a.cpu(), b), f"{what}: {name} differs from the CPU twin")
    log(f"[{tag}] {what}: device tables equal the CPU twin "
        f"({tuple(eng._right.shape)} right, {tuple(eng._starts.shape)} starts)")


def timed_flush(eng) -> float:
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    eng.flush()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return time.perf_counter() - t0


def warm_up(trace: bytes) -> None:
    """One small flush and export on the card before the timed path:
    CUDA context, module loads and allocator pools are set-up, not
    flush time."""
    from yjs_tpu_torch.ops import BatchEngine
    from yjs_tpu_torch.ops import kernels as K

    eng = BatchEngine(2, device="cuda")
    eng.queue_update(0, trace)
    eng.flush()
    eng.text(0)
    saved = os.environ.get("YTPU_KERNEL")
    try:
        for mode in ("levels", "seq"):
            os.environ["YTPU_KERNEL"] = mode
            eng = BatchEngine(2, device="cuda")
            eng.queue_update(0, trace)
            eng.flush()
    finally:
        restore_env("YTPU_KERNEL", saved)
    one = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    K.state_vector_kernel(one, one, 1)
    K.diff_mask_kernel(one, one, one, one)
    lane = torch.zeros(1, dtype=torch.int64, device="cuda")
    K.conflict_scan(*[lane] * 7, lane)
    K.conflict_scan(*[lane] * 7)
    K.anchor_lookup(lane, lane)
    K.apply_plan_shared((one, one.bool(), one), one[0], 0, 0, 1)
    torch.cuda.synchronize()


def restore_env(name: str, value) -> None:
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def seeded_edits(Y, traces: list[bytes]) -> dict[int, list[bytes]]:
    """The seeded editors' edits of the first N_EDITED traces."""
    return {t: editor_edits(Y, traces[t], t)
            for t in range(min(N_EDITED, len(traces)))}


def main_path(device: str, n_docs: int, traces: list[bytes],
              edits: dict[int, list[bytes]]) -> dict:
    """Drive the engine on ``device`` beside a CPU twin; returns the
    figures.  Exports read the device tables (YTPU_EXPORT_DEVICE=1)."""
    import yjs_tpu_torch as Y
    from yjs_tpu_torch.ops import BatchEngine
    from yjs_tpu_torch.ops.carry import trim_tables

    os.environ["YTPU_EXPORT_DEVICE"] = "1"
    eng = BatchEngine(n_docs, device=device)
    twin = BatchEngine(n_docs, device="cpu")
    held = [traces[i % len(traces)] for i in range(n_docs)]
    log_of = {i: [held[i]] for i in range(n_docs)}

    # flush 1: one distinct trace per doc (dense lanes)
    for e in (eng, twin):
        for i in range(n_docs):
            e.queue_update(i, held[i])
    t1 = timed_flush(eng)
    twin.flush()
    m1 = dict(eng.last_flush_metrics)
    elements = sum(sum(eng.state_vector(i).values()) for i in range(n_docs))
    assert_twins(eng, twin, "flush 1")
    # each flush's tables trimmed to live rows: the YATA lanes' yardstick
    trimmed = [trim_tables(eng)]

    # flush 2: edits of N_EDITED traces to every doc holding them, after
    # compaction of every doc of at least 512 rows
    for t, ups in edits.items():
        for i in range(t, n_docs, len(traces)):
            for u in ups:
                eng.queue_update(i, u)
                twin.queue_update(i, u)
            log_of[i].extend(ups)
    t2 = timed_flush(eng)
    twin.flush()
    m2 = dict(eng.last_flush_metrics)
    n_compacted = len(eng.last_compaction or [])
    check(n_compacted > 0, "flush 2 compacted no doc")
    check(twin.last_compaction == eng.last_compaction, "compaction stats differ")
    assert_twins(eng, twin, "flush 2")
    trimmed.append(trim_tables(eng))

    # warm-tier round trip (deferred scatter_rows on the next read-back)
    hydrated, sample = warm_tier_sample(n_docs)
    for e in (eng, twin):
        round_trip(e, hydrated)

    # exports from the device tables, held against the CPU core: every
    # hydrated doc plus others drawn at random
    for i in sample:
        want = check_export(Y, eng, log_of[i], i, "device")
        check(twin.text(i) == want, f"doc {i}: twin text differs")
    if device == "cuda":
        torch.cuda.synchronize()
    assert_twins(eng, twin, "after hydration and export")
    trimmed.append(trim_tables(eng))
    log(f"[main] {len(sample)} sampled docs: texts and encoded states equal "
        f"the CPU Doc ({len(hydrated)} hydrated)")

    table_bytes = int(eng._right.nbytes + eng._deleted.nbytes + eng._starts.nbytes)
    return {
        "t_flush1_s": t1, "t_flush2_s": t2, "elements": elements,
        "flush1": m1, "flush2": m2, "n_compacted": n_compacted,
        "table_bytes": table_bytes, "trimmed": trimmed,
        "log_of": log_of,
        # the mesh phase's yardstick for its sharded state vectors
        "state_vectors": eng.state_vectors_batched(list(range(n_docs))),
    }


def warm_tier_sample(n_docs: int) -> tuple[list, list]:
    """The docs that go through the warm tier (export_doc_columns,
    reset_doc, hydrate_doc_columns) and the docs exported after: every
    hydrated doc plus others drawn at random (seeded)."""
    gen = random.Random(1)
    hydrated = sorted(gen.sample(range(n_docs), min(N_HYDRATED, n_docs)))
    others = [i for i in range(n_docs) if i not in set(hydrated)]
    sample = sorted(hydrated + gen.sample(
        others, min(len(others), N_EXPORTED - len(hydrated))
    ))
    return hydrated, sample


def round_trip(eng, docs) -> None:
    for i in docs:
        mirror = eng.export_doc_columns(i)
        eng.reset_doc(i)
        eng.hydrate_doc_columns(i, mirror)


def check_export(Y, eng, updates: list, i: int, what: str) -> str:
    """Doc ``i``'s text and encoded state from ``eng``'s device tables
    equal a CPU ``Doc`` fed ``updates``; returns the text."""
    doc = Y.Doc(gc=False)
    for u in updates:
        Y.apply_update(doc, u)
    want = doc.get_text("text").to_string()
    check(eng.text(i) == want, f"doc {i}: {what} text differs from the CPU Doc")
    state = Y.merge_updates([eng.encode_state_as_update(i)])
    check(state == Y.merge_updates([Y.encode_state_as_update(doc)]),
          f"doc {i}: {what} encoded state differs from the CPU Doc")
    return want


# -- phase 4 ----------------------------------------------------------------------


class StormTimer:
    """Host times of one reconnect storm on the card's engine: the
    column build, the H2D copies and the diff kernel are wrapped, each
    between two synchronises, so a phase's device work counts where it
    was queued; the rest of ``sync_step2_batch`` is the read-back and
    the per-reply encode, the rest of ``handle_sync_step1_batch`` the
    provider's decoding and framing."""

    def __init__(self, eng, kernels):
        self.eng = eng
        self.kernels = kernels
        self.t = {"columns": 0.0, "h2d": 0.0, "kernel": 0.0, "step2": 0.0}
        self._kernel = None

    def _wrap(self, key, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.t[key] += time.perf_counter() - t0
            return out

        return timed

    def __enter__(self):
        eng = self.eng
        eng._sync_columns = self._wrap("columns", eng._sync_columns)
        eng._put_r = self._wrap("h2d", eng._put_r)
        eng.sync_step2_batch = self._wrap("step2", eng.sync_step2_batch)
        self._kernel = self.kernels.diff_mask_kernel
        self.kernels.diff_mask_kernel = self._wrap("kernel", self._kernel)
        return self

    def __exit__(self, *exc):
        for name in ("_sync_columns", "_put_r", "sync_step2_batch"):
            delattr(self.eng, name)
        self.kernels.diff_mask_kernel = self._kernel
        return False


def step1_message(sv: bytes) -> bytes:
    """A sync-step-1 frame carrying an encoded state vector."""
    from yjs_tpu_torch.lib0 import encoding
    from yjs_tpu_torch.sync import protocol

    enc = encoding.Encoder()
    encoding.write_var_uint(enc, protocol.MESSAGE_YJS_SYNC_STEP_1)
    encoding.write_var_uint8_array(enc, sv)
    return enc.to_bytes()


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def provider_path(n_docs: int, traces: list[bytes],
                  edits: dict[int, list[bytes]]) -> dict:
    """Drive ``TpuProvider`` on the card beside a CPU twin through
    ingest, two flushes, a reconnect storm, batched state vectors, a
    checkpoint and a recovery; returns the host times."""
    import gc

    import yjs_tpu_torch as Y
    import yjs_tpu_torch.updates as U
    from yjs_tpu_torch.lib0.decoding import Decoder
    from yjs_tpu_torch.lib0.encoding import Encoder
    from yjs_tpu_torch.ops import kernels as K
    from yjs_tpu_torch.provider import TpuProvider
    from yjs_tpu_torch.sync import protocol

    guid = [f"r{i}" for i in range(n_docs)]
    held = [traces[i % len(traces)] for i in range(n_docs)]
    log_of = {i: [held[i]] for i in range(n_docs)}
    times = {}
    with tempfile.TemporaryDirectory() as card_dir, \
            tempfile.TemporaryDirectory() as twin_dir:
        card = TpuProvider(n_docs, wal_dir=card_dir)
        twin = TpuProvider(n_docs, wal_dir=twin_dir, device="cpu")
        check(card.engine.device.type == "cuda",
              "the default provider is not on the card")

        # ingest (journaled) and flush 1
        _, times["ingest"] = timed(lambda: [
            card.receive_update(guid[i], held[i]) for i in range(n_docs)
        ])
        for i in range(n_docs):
            twin.receive_update(guid[i], held[i])
        _, times["flush1"] = timed(card.flush)
        twin.flush()
        assert_twins(card.engine, twin.engine, "flush 1", "provider")
        doc_of = [card.doc_id(g) for g in guid]
        sv1 = [card.engine.encode_state_vector(doc_of[i]) for i in range(n_docs)]

        # flush 2: the seeded editors' edits
        edited = []
        for t, ups in edits.items():
            for i in range(t, n_docs, len(traces)):
                for u in ups:
                    card.receive_update(guid[i], u)
                    twin.receive_update(guid[i], u)
                log_of[i].extend(ups)
                edited.append(i)
        _, times["flush2"] = timed(card.flush)
        twin.flush()
        assert_twins(card.engine, twin.engine, "flush 2", "provider")

        # the reconnect storm: new, flush-1 and up-to-date clients
        empty = Y.encode_state_vector(Y.Doc())
        client_sv = [
            (empty, sv1[i], card.engine.encode_state_vector(doc_of[i]))[i % 3]
            for i in range(n_docs)
        ]
        msgs = [(guid[i], step1_message(client_sv[i])) for i in range(n_docs)]
        before = K.launches["diff_mask"]
        with StormTimer(card.engine, K) as storm:
            replies, times["storm"] = timed(
                lambda: card.handle_sync_step1_batch(msgs)
            )
        check(K.launches["diff_mask"] == before + 1,
              "the storm did not take exactly one diff_mask launch")
        twin_replies = twin.handle_sync_step1_batch(msgs)
        bad = sum(a != b for a, b in zip(replies, twin_replies))
        check(len(replies) == n_docs and bad == 0,
              f"{bad} storm replies differ from the CPU twin's")
        reply_bytes = sum(len(r) for r in replies)
        gen = random.Random(2)
        others = sorted(set(range(n_docs)) - set(edited))
        half = N_SAMPLED_CLIENTS // 2
        sample = sorted(gen.sample(edited, min(half, len(edited)))
                        + gen.sample(others, min(half, len(others))))
        for i in sample:
            d = Y.Doc(gc=False)
            for u in (
                [], [held[i]], log_of[i]
            )[i % 3]:
                Y.apply_update(d, u)
            protocol.read_sync_message(Decoder(replies[i]), Encoder(), d)
            want = card.text(guid[i])
            check(d.get_text("text").to_string() == want,
                  f"room {guid[i]}: client text differs after the reply")
            check(Y.decode_state_vector(Y.encode_state_vector(d))
                  == card.state_vector(guid[i]),
                  f"room {guid[i]}: client state vector differs")
            oracle = Y.Doc(gc=False)
            for u in log_of[i]:
                Y.apply_update(oracle, u)
            check(oracle.get_text("text").to_string() == want,
                  f"room {guid[i]}: provider text differs from the CPU Doc")
        log(f"[provider] storm: {n_docs} replies ({reply_bytes} bytes) equal "
            f"the CPU twin's; {len(sample)} sampled clients converged")

        # state vectors of the whole fleet in one launch
        before = K.launches["state_vector"]
        svs, times["state_vectors"] = timed(
            lambda: card.engine.state_vectors_batched(doc_of)
        )
        check(K.launches["state_vector"] == before + 1,
              "state_vectors_batched did not take exactly one launch")
        check(svs == [card.engine.state_vector(i) for i in doc_of],
              "batched state vectors differ from the per-doc ones")
        log(f"[provider] state_vectors_batched: {n_docs} state vectors equal "
            "the per-doc ones")

        # checkpoint (one diff-mask launch over the fleet), crash, recover
        before = K.launches["diff_mask"]
        stats, times["checkpoint"] = timed(card.checkpoint)
        check(K.launches["diff_mask"] == before + 1,
              "the checkpoint did not take exactly one diff_mask launch")
        check(stats["docs"] == n_docs, f"checkpoint covered {stats['docs']} docs")
        card.wal.abandon()
        del card
        gc.collect()
        # replay validates every record before it queues it: time that
        # share of the recovery (replay_wal imports the function per call)
        validate = U.validate_update
        spent = [0.0]

        def timed_validate(*args, **kw):
            t0 = time.perf_counter()
            try:
                return validate(*args, **kw)
            finally:
                spent[0] += time.perf_counter() - t0

        U.validate_update = timed_validate
        try:
            rec, times["recover"] = timed(lambda: TpuProvider.recover(card_dir))
        finally:
            U.validate_update = validate
        times["recover_validate"] = spent[0]
        check(rec.engine.device.type == "cuda", "recovery left the card")
        lr = rec.last_recovery
        check(lr["outcome"] == "clean" and lr["snapshots_applied"] == n_docs,
              f"recovery: {lr['outcome']}, {lr['snapshots_applied']} snapshots")
        rsv = rec.engine.state_vectors_batched([rec.doc_id(g) for g in guid])
        check(rsv == [twin.state_vector(g) for g in guid],
              "recovered state vectors differ from the CPU twin's")
        for i in sample:
            oracle = Y.Doc(gc=False)
            for u in log_of[i]:
                Y.apply_update(oracle, u)
            check(rec.text(guid[i]) == oracle.get_text("text").to_string(),
                  f"room {guid[i]}: recovered text differs from the CPU Doc")
        log(f"[provider] checkpoint of {n_docs} rooms "
            f"({stats['snapshot_bytes']} snapshot bytes) recovered on the card: "
            f"state vectors equal the twin's, {len(sample)} texts the CPU Doc's")
        times.update({f"storm_{k}": v for k, v in storm.t.items()})
        times["n_replies"] = n_docs
        times["reply_bytes"] = reply_bytes
        del rec, twin
        gc.collect()
    return times


# -- phase 5 ----------------------------------------------------------------------


YATA_KERNELS = (
    ("scatter_statics", lambda a: a[1].numel()),
    ("batch_step", lambda a: a[3].numel()),
    ("batch_step_levels", lambda a: a[3].numel()),
)


def device_split(prof) -> dict:
    """Device time inside a traced run, in ms, from its CUDA activity
    records: kernels (the statics scatter, the YATA steps, the rest, and
    ``by_name`` per kernel) and copies (``d2h`` among the others),
    ``busy`` the union of all their intervals (record_function ranges
    left out), ``statics_h2d`` the host-to-device copy that the statics
    scatter reads (the last one to start before it)."""
    from torch.autograd import DeviceType

    ivs = []
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name.startswith("ytpu.")):
            continue
        ivs.append((e.time_range.start, e.time_range.end, e.name))
    ivs.sort()
    out = dict.fromkeys(("k3", "step", "kernels", "h2d", "statics_h2d",
                         "d2h", "copies"), 0.0)
    by_name = {}
    k3_start = min((a for a, _b, n in ivs if "scatter_statics" in n),
                   default=None)
    busy, hi = 0.0, float("-inf")
    for a, b, name in ivs:
        busy += max(0.0, b - max(a, hi))
        hi = max(hi, b)
        dur = (b - a) / 1e3
        if name.startswith("Memcpy HtoD"):
            out["h2d"] += dur
            if k3_start is not None and a < k3_start:
                out["statics_h2d"] = dur
        elif name.startswith(("Memcpy", "Memset")):
            out["copies"] += dur
            if name.startswith("Memcpy DtoH"):
                out["d2h"] += dur
        else:
            out["kernels"] += dur
            by_name[name] = by_name.get(name, 0.0) + dur
            if "scatter_statics" in name:
                out["k3"] += dur
            elif "batch_step" in name:
                out["step"] += dur
    out["busy"] = busy / 1e3
    out["by_name"] = by_name
    return out


def yata_flush(eng) -> dict:
    """One timed flush of an engine on the card under a CUDA activity
    trace: its host time split into plan, pack (without the statics),
    statics (host pack; pinned copy and launches), dispatch, emit and the
    closing synchronise, from the flush metrics and the engine's phase
    spans, and its device time from the trace (:func:`device_split`)."""
    from torch.profiler import ProfilerActivity, profile

    eng.obs.tracer.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = timed_flush(eng)
    spans = {}
    for ev in eng.obs.tracer.trace_events():
        if ev.get("ph") == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e6
    check("ytpu.statics" in spans and "ytpu.statics_pack" in spans,
          "the flush recorded no statics phase")
    m = dict(eng.last_flush_metrics)
    dev = device_split(prof)
    return {
        "wall": wall, "plan": m["t_plan_s"] + m["t_compact_s"],
        "pack": m["t_pack_s"] - spans["ytpu.statics"],
        "statics_pack": spans["ytpu.statics_pack"],
        "statics_rest": spans["ytpu.statics"] - spans["ytpu.statics_pack"],
        "dispatch": m["t_dispatch_s"], "emit": m["t_emit_s"],
        "sync": wall - m["t_total_s"], "n_levels": m["n_levels"],
        "level_width": m["level_width"], "occupancy": m["schedule_occupancy"],
        "realloc_bytes": m["realloc_bytes"], "device": dev,
        "idle": 1.0 - dev["busy"] / (wall * 1e3),
    }


def log_yata_flush(lane: str, name: str, f: dict, smi: str) -> None:
    d = f["device"]
    log(f"[yata] {lane} {name} ({smi}): wall {f['wall']:.3f}s = plan "
        f"{f['plan']:.3f} + pack {f['pack']:.3f} + statics host pack "
        f"{f['statics_pack']:.3f} + statics pinned copy and launch "
        f"{f['statics_rest']:.3f} + dispatch {f['dispatch']:.3f} + emit "
        f"{f['emit']:.3f} + closing sync {f['sync']:.3f}; "
        f"L={f['n_levels']} W={f['level_width']} "
        f"occupancy {f['occupancy']:.4f}")
    log(f"[yata] {lane} {name} device (CUDA activity trace, ms): busy "
        f"{d['busy']:.3f} = kernels {d['kernels']:.3f} (scatter_statics "
        f"{d['k3']:.3f}, {'batch_step' if lane == 'seq' else 'batch_step_levels'} "
        f"{d['step']:.3f}) + H2D {d['h2d']:.3f} (statics {d['statics_h2d']:.3f})"
        f" + other copies {d['copies']:.3f}, overlaps counted once; idle "
        f"{f['idle']:.6f} of the wall")


def assert_yata_twins(eng, twin, what: str) -> None:
    """Untrimmed, byte for byte: the three tables and six statics."""
    from yjs_tpu_torch.ops.kernels import STATIC_KEYS

    assert_twins(eng, twin, what, "yata")
    for key in STATIC_KEYS:
        a, b = eng._statics[key], twin._statics[key]
        check(a.shape == b.shape and torch.equal(a.cpu(), b),
              f"{what}: static column {key} differs from the CPU twin")
    log(f"[yata] {what}: the six static columns equal the CPU twin "
        f"({tuple(eng._statics['client_key'].shape)} each)")


def assert_trimmed(eng, want: list, what: str, tag: str = "yata") -> list:
    """Tables trimmed to each doc's live rows and segments equal
    ``want`` (another lane's, after the same flushes)."""
    from yjs_tpu_torch.ops.carry import trim_tables

    got = trim_tables(eng)
    check(len(got) == len(want), f"{what}: doc counts differ")
    for i, (g, w) in enumerate(zip(got, want)):
        check((g is None) == (w is None), f"{what}: doc {i} served differently")
        if g is not None:
            check(all(np.array_equal(a, b) for a, b in zip(g, w)),
                  f"{what}: doc {i}'s trimmed tables differ")
    log(f"[{tag}] {what}: trimmed tables equal")
    return got


def assert_statics_current(eng, must: set, what: str) -> None:
    """Every doc whose statics are current (uploaded rows == its row
    count) holds its mirror's static columns; the docs in ``must`` are
    current.  A doc compacted since its last device-lane flush re-uploads
    lazily, on its next one."""
    from yjs_tpu_torch.ops.kernels import STATIC_KEYS

    host = {k: eng._statics[k].cpu().numpy() for k in STATIC_KEYS}
    current = 0
    for i, m in enumerate(eng.mirrors):
        n = m.n_rows
        if eng._uploaded_rows[i] != n:
            check(i not in must, f"{what}: doc {i}'s statics are not current")
            continue
        cols = m.static_columns()
        cols["client_key"] = cols["client_key"].astype(np.uint32).view(np.int32)
        for k in STATIC_KEYS:
            check(np.array_equal(host[k][i, :n], cols[k]),
                  f"{what}: doc {i}'s {k} differs from its mirror")
        current += 1
    log(f"[yata] {what}: statics of {current} docs equal their mirrors' "
        f"static_columns(); {len(eng.mirrors) - current} await a lazy "
        "re-upload after compaction")


def yata_path(traces: list[bytes], edits: dict[int, list[bytes]],
              apply_trimmed: list, smi: str) -> dict:
    """The on-device YATA lanes at the main path's width: a levels engine
    on the card beside a CPU twin, then a seq engine on the card, through
    the main path's two flushes (flush 2 after the compaction of every
    doc of at least 512 rows); returns the flush splits."""
    import yjs_tpu_torch as Y
    from yjs_tpu_torch.ops import BatchEngine

    n_docs = N_DOCS
    held = [traces[i % len(traces)] for i in range(n_docs)]
    log_of = {i: [held[i]] for i in range(n_docs)}
    edited = set()
    for t, ups in edits.items():
        for i in range(t, n_docs, len(traces)):
            log_of[i].extend(ups)
            edited.add(i)
    saved = os.environ.get("YTPU_KERNEL")
    out = {}
    try:
        os.environ["YTPU_KERNEL"] = "levels"
        eng = BatchEngine(n_docs, device="cuda")
        twin = BatchEngine(n_docs, device="cpu")
        for e in (eng, twin):
            for i in range(n_docs):
                e.queue_update(i, held[i])
        out["levels1"] = yata_flush(eng)
        t0 = time.perf_counter()
        twin.flush()
        out["twin1"] = time.perf_counter() - t0
        log_yata_flush("levels", "flush 1", out["levels1"], smi)
        assert_yata_twins(eng, twin, "levels flush 1")
        lev = [assert_trimmed(eng, apply_trimmed[0],
                              "levels flush 1 against the apply lane")]
        assert_statics_current(eng, set(range(n_docs)), "levels flush 1")

        for e in (eng, twin):
            for t, ups in edits.items():
                for i in range(t, n_docs, len(traces)):
                    for u in ups:
                        e.queue_update(i, u)
        out["levels2"] = yata_flush(eng)
        t0 = time.perf_counter()
        twin.flush()
        out["twin2"] = time.perf_counter() - t0
        out["n_compacted"] = len(eng.last_compaction or [])
        check(out["n_compacted"] > 0, "levels flush 2 compacted no doc")
        check(twin.last_compaction == eng.last_compaction,
              "levels compaction stats differ from the twin's")
        log_yata_flush("levels", "flush 2", out["levels2"], smi)
        assert_yata_twins(eng, twin, "levels flush 2")
        lev.append(assert_trimmed(eng, apply_trimmed[1],
                                  "levels flush 2 against the apply lane"))
        assert_statics_current(eng, edited, "levels flush 2")
        del twin

        # exports from the levels engine's device tables
        gen = random.Random(3)
        others = sorted(set(range(n_docs)) - edited)
        half = N_EXPORTED // 2
        sample = sorted(gen.sample(sorted(edited), min(half, len(edited)))
                        + gen.sample(others, min(half, len(others))))
        for i in sample:
            doc = Y.Doc(gc=False)
            for u in log_of[i]:
                Y.apply_update(doc, u)
            check(eng.text(i) == doc.get_text("text").to_string(),
                  f"doc {i}: levels text differs from the CPU Doc")
            check(Y.merge_updates([eng.encode_state_as_update(i)])
                  == Y.merge_updates([Y.encode_state_as_update(doc)]),
                  f"doc {i}: levels encoded state differs from the CPU Doc")
        log(f"[yata] {len(sample)} sampled docs: levels texts and encoded "
            "states equal the CPU Doc")
        out["statics_bytes"] = int(sum(v.nbytes for v in eng._statics.values()))
        out["trimmed"] = lev  # the mesh phase's yardstick for its levels lane
        del eng

        os.environ["YTPU_KERNEL"] = "seq"
        eng = BatchEngine(n_docs, device="cuda")
        for i in range(n_docs):
            eng.queue_update(i, held[i])
        out["seq1"] = yata_flush(eng)
        log_yata_flush("seq", "flush 1", out["seq1"], smi)
        assert_trimmed(eng, lev[0], "seq flush 1 against the levels lane")
        assert_trimmed(eng, apply_trimmed[0], "seq flush 1 against the apply lane")
        for t, ups in edits.items():
            for i in range(t, n_docs, len(traces)):
                for u in ups:
                    eng.queue_update(i, u)
        out["seq2"] = yata_flush(eng)
        log_yata_flush("seq", "flush 2", out["seq2"], smi)
        assert_trimmed(eng, lev[1], "seq flush 2 against the levels lane")
        assert_trimmed(eng, apply_trimmed[1], "seq flush 2 against the apply lane")
        del eng
    finally:
        restore_env("YTPU_KERNEL", saved)
    return out


# -- phase 6: the Python mirror's device cold planner ------------------------------


N_PLANNER_DOCS = 512  # one doc per distinct fixture trace, half of them
N_BURST_OPS = 40
PLANNER_KERNELS = (
    ("conflict_scan", lambda a: a[0].numel(),
     lambda a: "conflict_scan" if len(a) < 8 or a[7] is None
     else "conflict_scan_chunk"),
    ("anchor_lookup", lambda a: a[1].numel()),
)


def interleaved_burst(held: list[bytes], seed: int,
                      n_ops: int = N_BURST_OPS) -> list[bytes]:
    """A seeded burst in the ``interleaved`` shape of the JAX package's
    segment-planner corpus (``tests/test_segment_planner.py``): three
    editors (clients 300-302) that hold ``held`` insert one char at a
    random position (a quarter of the edits delete one), one update an
    edit; after each edit, with chance 0.3, one editor syncs another.  A
    sync carries what the receiver lacks (the corpus sends the whole
    state, which integrates to the same doc)."""
    import yjs_tpu_torch as Y

    gen = random.Random(seed)
    docs = []
    for k in range(3):
        d = Y.Doc(gc=False)
        d.client_id = 300 + k
        for u in held:
            Y.apply_update(d, u)
        docs.append(d)
    out = []
    while len(out) < n_ops:
        j = gen.randrange(3)
        d = docs[j]
        t = d.get_text("text")
        sv = Y.encode_state_vector(d)
        if len(t) and gen.random() < 0.25:
            t.delete(gen.randrange(len(t)), 1)
        else:
            t.insert(gen.randrange(len(t) + 1), gen.choice("abcdef "))
        out.append(Y.encode_state_as_update(d, sv))
        if gen.random() < 0.3:
            k = gen.randrange(3)
            if k != j:
                other = docs[k]
                Y.apply_update(other, Y.encode_state_as_update(
                    d, Y.encode_state_vector(other)))
    return out


def _burst_job(job):
    held, seed = job
    return interleaved_burst(held, seed)


TWIN_THREADS = 4  # a CPU twin's kernels, beside the card's thread


def worker_pool(n_jobs: int):
    """Spawned worker processes, one a core (at most 8)."""
    import multiprocessing

    workers = max(1, min(8, os.cpu_count() or 1, n_jobs))
    return multiprocessing.get_context("spawn").Pool(workers)


def make_bursts(helds: list[list[bytes]], first_seed: int, pool):
    """One burst per doc (seed ``first_seed + doc``), generated in
    parallel by ``pool``'s worker processes; returns the pending result
    (``.get()`` gives the bursts)."""
    jobs = [(held, first_seed + i) for i, held in enumerate(helds)]
    return pool.map_async(_burst_job, jobs, chunksize=16)


class PlannerTimer:
    """Host time inside the segment planner (``plan_chunk`` and the
    per-doc ``plan_doc``, outermost calls only) and the co-planned doc
    count of each ``plan_chunk`` call, by wrapping the module's two
    entry points (the engine and the mirror call them through it)."""

    def __init__(self):
        from yjs_tpu_torch.ops import segment_planner

        self.sp = segment_planner
        self.t = 0.0
        self.co_planned: list[int] = []
        self._depth = 0
        self._orig = {}

    def _wrap(self, fn, chunk: bool):
        def timed(items, *args, **kw):
            if chunk:
                self.co_planned.append(
                    sum(1 for q, _s in items if q is not None))
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(items, *args, **kw)
            finally:
                self._depth -= 1
                if not self._depth:
                    self.t += time.perf_counter() - t0

        return timed

    def reset(self) -> None:
        self.t = 0.0
        self.co_planned = []

    def __enter__(self):
        for name in ("plan_chunk", "plan_doc"):
            self._orig[name] = getattr(self.sp, name)
            setattr(self.sp, name,
                    self._wrap(self._orig[name], name == "plan_chunk"))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.sp, name, fn)
        return False


def planner_flush(eng, timer: PlannerTimer) -> dict:
    """One timed flush of a Python-mirror engine on the card under a CUDA
    activity trace: its host time split into plan (the planner's share
    from ``timer``), pack, dispatch, emit and the closing synchronise,
    its device time from the trace; checks that nothing was demoted,
    rolled back or sent to the CPU core and that ``plan_threads`` is the
    co-planned doc count."""
    from torch.profiler import ProfilerActivity, profile

    timer.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = timed_flush(eng)
    m = dict(eng.last_flush_metrics)
    check(m["n_demoted"] == 0 and m["n_rolled_back"] == 0 and not eng.fallback,
          f"the planner flush demoted {m['n_demoted']} and rolled back "
          f"{m['n_rolled_back']} docs")
    want = max(timer.co_planned, default=1)
    check(m["plan_threads"] == want,
          f"plan_threads {m['plan_threads']} != co-planned {want}")
    dev = device_split(prof)
    k12 = sum(v for k, v in dev["by_name"].items()
              if "conflict_scan_kernel" in k)
    k11 = sum(v for k, v in dev["by_name"].items() if "anchor_lookup" in k)
    return {
        "wall": wall, "plan": m["t_plan_s"] + m["t_compact_s"],
        "planner": timer.t, "pack": m["t_pack_s"],
        "dispatch": m["t_dispatch_s"], "emit": m["t_emit_s"],
        "sync": wall - m["t_total_s"], "plan_threads": m["plan_threads"],
        "cold": m["plan_cache_misses"], "fast": m["plan_segment_fast"],
        "residue": m["plan_segment_residue"], "device": dev,
        "k12": k12, "k11": k11, "idle": 1.0 - dev["busy"] / (wall * 1e3),
    }


def log_planner_flush(name: str, f: dict, smi: str) -> None:
    d = f["device"]
    log(f"[planner] {name} ({smi}): wall {f['wall']:.3f}s = plan "
        f"{f['plan']:.3f} (segment planner {f['planner']:.3f}, "
        f"{f['planner'] / max(f['plan'], 1e-9):.4f} of plan) + pack "
        f"{f['pack']:.3f} + dispatch {f['dispatch']:.3f} + emit "
        f"{f['emit']:.3f} + closing sync {f['sync']:.3f}; {f['cold']} cold "
        f"docs, plan_threads {f['plan_threads']}, fast-set structs "
        f"{f['fast']}, residue {f['residue']}")
    log(f"[planner] {name} device (CUDA activity trace, ms): busy "
        f"{d['busy']:.3f} = kernels {d['kernels']:.3f} (conflict_scan "
        f"{f['k12']:.3f}, anchor_lookup {f['k11']:.3f}) + H2D {d['h2d']:.3f}"
        f" + D2H {d['d2h']:.3f} + other copies {d['copies'] - d['d2h']:.3f}, "
        f"overlaps counted once; idle {f['idle']:.6f} of the wall")


class PlannerTwin:
    """The planner path's CPU twin, ``BatchEngine(n_docs, device="cpu")``
    on Python mirrors, for a :class:`Twin` process of its own: each
    flush plans cold on the plain kernels (its process's plan cache never
    holds the card's plans) beside the card engine's."""

    def __init__(self, n_docs: int):
        os.environ["YTPU_NO_NATIVE_PLAN"] = "1"
        os.environ.pop("YTPU_PLAN_SEGMENT", None)
        from yjs_tpu_torch.ops import BatchEngine

        self.eng = BatchEngine(n_docs, device="cpu")

    def flush(self, ups: dict) -> tuple:
        """Queues ``ups`` (doc -> updates) and flushes; returns the
        flush's seconds, its plan-cache hits and misses, and the three
        tables."""
        for i, us in ups.items():
            for u in us:
                self.eng.queue_update(i, u)
        t0 = time.perf_counter()
        self.eng.flush()
        dt = time.perf_counter() - t0
        tm = self.eng.last_flush_metrics
        return (dt, tm["plan_cache_hits"], tm["plan_cache_misses"],
                {name: getattr(self.eng, name)
                 for name in ("_right", "_deleted", "_starts")})


def planner_path(traces: list[bytes], main_trimmed: list, smi: str,
                 device: str = "cuda", n_docs: int = N_PLANNER_DOCS) -> dict:
    """The Python mirror's cold planner (``YTPU_NO_NATIVE_PLAN=1``,
    ``YTPU_PLAN_SEGMENT`` unset: the whole-chunk device mode) on
    ``BatchEngine(512)`` on the card beside a CPU twin: flush 1 loads
    one distinct trace a doc (one chunk conflict scan over every doc),
    flush 2 gives every doc a seeded interleaved burst (a chunk scan and
    one chunk anchor lookup), flush 3 a second burst to doc 0 alone (the
    per-doc scan and lookup).  The twin (:class:`PlannerTwin`) runs in a
    spawned process of its own, each flush beside the card's, and plans
    every doc on the plain kernels; the plan cache is emptied before each
    of the card's flushes, so it plans cold too.  Returns the flushes'
    splits."""
    from types import SimpleNamespace

    import yjs_tpu_torch as Y
    from yjs_tpu_torch.ops import BatchEngine, plan_cache
    from yjs_tpu_torch.ops.columns import DocMirror

    n_docs = min(n_docs, len(traces))
    saved = {k: os.environ.get(k)
             for k in ("YTPU_NO_NATIVE_PLAN", "YTPU_PLAN_SEGMENT")}
    out = {"n_docs": n_docs}
    twin = None
    try:
        os.environ["YTPU_NO_NATIVE_PLAN"] = "1"
        os.environ.pop("YTPU_PLAN_SEGMENT", None)
        plan_cache.reset_cache()
        eng = BatchEngine(n_docs, device=device)
        twin = Twin(PlannerTwin, n_docs)
        twin.result()  # built
        check(all(type(m) is DocMirror for m in eng.mirrors),
              "the planner path does not run on Python mirrors")
        pool = worker_pool(n_docs)
        pending = None
        bursts = extra = None

        def updates_of(k):
            # the bursts are set-up: their worker processes build them
            # while the twin plans flush 1 (the card's timed flushes run
            # with no workers beside them, only the twin's process)
            nonlocal bursts, extra
            if k == 1:
                return {i: [traces[i]] for i in range(n_docs)}
            if bursts is None:
                t0 = time.perf_counter()
                bursts = pending.get()
                extra = interleaved_burst([traces[0], *bursts[0]], 499)
                out["t_bursts"] = time.perf_counter() - t0
            if k == 2:
                return {i: bursts[i] for i in range(n_docs)}
            return {0: extra}

        with pool, PlannerTimer() as timer:
            for k, name in enumerate(("flush 1", "flush 2", "flush 3"), 1):
                ups = updates_of(k)
                for i, us in ups.items():
                    for u in us:
                        eng.queue_update(i, u)
                twin.start("flush", ups)
                # the card plans cold: the plan cache is emptied before
                # its flush (the twin's process has a cache of its own)
                plan_cache.reset_cache()
                out[f"flush{k}"] = f = planner_flush(eng, timer)
                plan_cache.reset_cache()
                if k == 1:
                    pending = make_bursts(
                        [[traces[i]] for i in range(n_docs)], 500, pool)
                out[f"twin{k}"], hits, misses, tables = twin.result()
                check(hits == 0 and misses == f["cold"],
                      f"planner {name}: the twin replayed {hits} plans and "
                      f"planned {misses} cold, the card {f['cold']}")
                log_planner_flush(name, f, smi)
                assert_twins(eng, SimpleNamespace(**tables),
                             f"planner {name}", "planner")
                if k == 1:
                    assert_trimmed(eng, main_trimmed[0][:n_docs],
                                   "planner flush 1 against the main path's "
                                   "apply lane (native planner)", "planner")
        check(out["flush3"]["plan_threads"] == 1,
              "flush 3's lone cold doc was not planned per doc")
        log_of = {i: [traces[i], *bursts[i]] for i in range(n_docs)}
        log_of[0] += extra
        gen = random.Random(4)
        sample = sorted({0, *gen.sample(range(n_docs), min(N_EXPORTED, n_docs) - 1)})
        for i in sample:
            doc = Y.Doc(gc=False)
            for u in log_of[i]:
                Y.apply_update(doc, u)
            check(eng.text(i) == doc.get_text("text").to_string(),
                  f"doc {i}: planner-path text differs from the CPU Doc")
            check(Y.merge_updates([eng.encode_state_as_update(i)])
                  == Y.merge_updates([Y.encode_state_as_update(doc)]),
                  f"doc {i}: planner-path encoded state differs from the CPU Doc")
        log(f"[planner] {len(sample)} sampled docs: texts and encoded states "
            "equal the CPU Doc")
        out["burst_updates"] = sum(len(b) for b in bursts)
        del eng
        plan_cache.reset_cache()
    finally:
        if twin is not None:
            twin.stop()
        for k, v in saved.items():
            restore_env(k, v)
    return out


# -- phase 7: broadcast replay (the B4 shape) --------------------------------------


N_BROADCAST_DOCS = 4096
BROADCAST_KERNELS = (
    ("apply_plan_shared", lambda a: a[1].numel()),
    ("batch_step_levels_shared", lambda a: a[3].numel()),
)


def shared_plan(trace: bytes, device) -> dict:
    """One trace planned once by a Python mirror on the card (its segment
    planner's kernels there), packed as the broadcast kernels take it:
    the K7a lanes, the K7b statics (six ``[cap+1]`` columns), splits,
    level schedule and deletes, and the widths."""
    from yjs_tpu_torch.ops import kernels as K
    from yjs_tpu_torch.ops.columns import DocMirror
    from yjs_tpu_torch.ops.engine import _STATIC_COLS

    mirror = DocMirror("text", device=device)
    mirror.ingest(trace, False)
    t0 = time.perf_counter()
    plan = mirror.prepare_step(want_levels=True)
    t_plan = time.perf_counter() - t0
    n = mirror.n_rows
    w = max(plan.max_width, 1)
    cap = n + 2 * w
    s1 = max(8, mirror.n_segs) + 1
    cols = mirror.static_columns()
    statics = {}
    for key, fill, _dtype in _STATIC_COLS:
        col = np.full(cap + 1, fill, np.int64)
        col[:n] = cols[key]
        col = col.astype(np.uint32).view(np.int32) if key == "client_key" \
            else col.astype(np.int32)
        statics[key] = torch.from_numpy(col).to(device)
    packed = plan.packed_levels()
    lv = np.full((max(1, len(packed)), w, 8), K.NULL, np.int32)
    for j, entries in enumerate(packed):
        if entries:
            lv[j, : len(entries)] = entries
    splits = np.full((max(1, len(plan.splits)), 2), K.NULL, np.int32)
    if plan.splits:
        splits[: len(plan.splits)] = np.asarray(plan.splits, np.int32)
    dels = np.full(max(1, len(plan.delete_rows)), K.NULL, np.int32)
    if plan.delete_rows:
        dels[: len(plan.delete_rows)] = np.asarray(plan.delete_rows, np.int32)

    def pad(idx, minimum, oob):
        i = np.full(max(minimum, 1 << max(0, (len(idx) - 1).bit_length())),
                    oob, np.int32)
        i[: len(idx)] = np.asarray(idx, np.int32)
        return i

    rows = pad(plan.link_rows, 64, cap + 1)
    vals = np.full(len(rows), K.NULL, np.int32)
    vals[: len(plan.link_vals)] = plan.link_vals
    segs = pad(plan.head_segs, 8, s1)
    hvals = np.full(len(segs), K.NULL, np.int32)
    hvals[: len(plan.head_vals)] = plan.head_vals
    dl = pad(plan.delete_rows, 64, cap + 1)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {
        "mirror": mirror, "t_plan": t_plan, "n": n, "cap": cap, "s1": s1,
        "lanes": to(np.concatenate([rows, vals, segs, hvals, dl])),
        "k_l": len(rows), "k_h": len(segs), "k_d": len(dl),
        "statics": statics, "splits": to(splits), "lv": to(lv),
        "dels": to(dels),
    }


def broadcast_path(trace: bytes, n_docs: int = N_BROADCAST_DOCS,
                   device: str = "cuda") -> dict:
    """The B4 replay shape: one trace planned once, fanned out over
    ``n_docs`` docs by K7a (the resolved delta) and K7b (the levels
    plan); each held against K1 and K6 fed the same inputs replicated
    per doc, table for table, K7a's and K7b's live rows against each
    other, and doc 0's text (ranked on the card) against a CPU Doc."""
    import yjs_tpu_torch as Y
    from yjs_tpu_torch.ops import kernels as K
    from yjs_tpu_torch.ops.engine import visible_text

    dev = torch.device(device)
    sp = shared_plan(trace, dev)
    b, cap, s1, n = n_docs, sp["cap"], sp["s1"], sp["n"]
    k_l, k_h, k_d = sp["k_l"], sp["k_h"], sp["k_d"]

    def fresh():
        return (torch.full((b, cap + 1), K.NULL, dtype=torch.int32, device=dev),
                torch.zeros((b, cap + 1), dtype=torch.bool, device=dev),
                torch.full((b, s1), K.NULL, dtype=torch.int32, device=dev))

    lanes = sp["lanes"]
    out_a = K.apply_plan_shared(fresh(), lanes, k_l, k_h, k_d)
    # K1 on the same delta, once per doc: [cnt 4B][rows|vals][segs|hvals][dels]
    rows, vals = lanes[:k_l], lanes[k_l : 2 * k_l]
    segs, hvals = lanes[2 * k_l : 2 * k_l + k_h], lanes[2 * k_l + k_h : 2 * k_l + 2 * k_h]
    dl = lanes[2 * k_l + 2 * k_h :]
    counts = torch.tensor([0] * b + [k_l] * b + [k_h] * b + [k_d] * b,
                          dtype=torch.int32, device=dev)
    k1_lanes = torch.cat([counts] + [x.repeat(b) for x in
                                     (rows, vals, segs, hvals, dl)])
    k1_widths = (0, b * k_l, b * k_h, b * k_d)
    out_1 = K.apply_lanes(fresh(), k1_lanes, *k1_widths)
    for name, x, y in zip(("right", "deleted", "starts"), out_a, out_1):
        check(torch.equal(x, y), f"K7a's {name} differs from K1's on the replicated delta")
    log(f"[broadcast] apply_plan_shared over {b} docs equals apply_lanes on the "
        f"delta replicated per doc ({b * (2 * k_l + 2 * k_h + k_d)} lanes)")

    scratch = torch.full((b,), n, dtype=torch.int32, device=dev)
    args_b = (sp["statics"], fresh(), sp["splits"], sp["lv"], sp["dels"],
              scratch)
    inputs_b = _clone(args_b)
    out_b = K.batch_step_levels_shared(*args_b)
    rep = {k: v.expand(b, -1).contiguous() for k, v in sp["statics"].items()}
    args_6 = (rep, fresh(), sp["splits"].expand(b, -1, -1).contiguous(),
              sp["lv"].expand(b, -1, -1, -1).contiguous(),
              sp["dels"].expand(b, -1).contiguous(), scratch)
    inputs_6 = _clone(args_6)
    out_6 = K.batch_step_levels(*args_6)
    for name, x, y in zip(("right", "deleted", "starts"), out_b, out_6):
        check(torch.equal(x, y), f"K7b's {name} differs from K6's on the replicated plan")
    log(f"[broadcast] batch_step_levels_shared over {b} docs equals "
        f"batch_step_levels on the plan replicated per doc (schedule "
        f"{tuple(sp['lv'].shape)} shared, {tuple(sp['lv'].shape)} x {b} replicated)")
    segs_n = sp["mirror"].n_segs
    for name, x, y, w in zip(("right", "deleted", "starts"), out_a, out_b,
                             (n, n, segs_n)):
        check(torch.equal(x[:, :w], y[:, :w]),
              f"K7a's and K7b's live {name} rows differ")
    log("[broadcast] K7a's and K7b's live rows are equal")
    m = sp["mirror"]
    text_seg = m.segments[("text", None, K.NULL)]
    valid = torch.zeros((1, cap + 1), dtype=torch.bool)
    valid[0, :n] = torch.from_numpy(np.asarray(m.row_seg) == text_seg)
    d = K.list_ranks(out_b[0][:1].contiguous(), valid.to(dev))[0].cpu().numpy()
    rows_in_order = np.nonzero(d >= 0)[0]
    rows_in_order = rows_in_order[np.argsort(-d[rows_in_order], kind="stable")]
    deleted = out_b[1][0].cpu().numpy()
    text = visible_text(m, rows_in_order, deleted[rows_in_order])
    doc = Y.Doc(gc=False)
    Y.apply_update(doc, trace)
    check(text == doc.get_text("text").to_string(),
          "broadcast doc 0's text differs from the CPU Doc")
    log(f"[broadcast] doc 0's text ({len(text)} chars) ranked on the card "
        f"equals the CPU Doc; the trace planned in {sp['t_plan']:.3f}s")
    return {
        "apply_plan_shared": (fresh(), lanes, k_l, k_h, k_d),
        "batch_step_levels_shared": inputs_b,
        "apply_lanes_replicated": (fresh(), k1_lanes, *k1_widths),
        "batch_step_levels_replicated": inputs_6,
        "t_plan": sp["t_plan"], "n": n, "cap": cap,
        "schedule": tuple(sp["lv"].shape),
    }


# -- phase 7b: the B4 broadcast replay (bench.py's headline shape) ---------------


N_B4_DOCS = 16384  # bench.py's YTPU_BENCH_DOCS
N_B4_CHECKED = 1024
B4 = ROOT / "tests" / "fixtures" / "b4_trace.bin"


def b4_plan() -> dict:
    """The B4 fixture planned once by the port's native mirror and packed
    as ``bench.py`` packs its B4 replay: each section padded to a power
    of two (links and deletes at least 64, heads 8), padding one past the
    table (``cap + 1``)."""
    from yjs_tpu_torch.ops.native_mirror import NativeMirror

    mirror = NativeMirror("text")
    t0 = time.perf_counter()
    mirror.ingest(B4.read_bytes(), False)
    plan = mirror.prepare_step()
    t_plan = time.perf_counter() - t0
    n = mirror.n_rows
    cap = max(64, n)
    s1 = max(8, mirror.n_segs) + 1

    def pad(idx, vals, minimum, oob):
        k = len(idx)
        i = np.full(max(minimum, 1 << max(0, (k - 1).bit_length())), oob,
                    np.int32)
        i[:k] = np.asarray(idx, np.int32)
        v = np.full(len(i), -1, np.int32)
        if vals is not None:
            v[:k] = np.asarray(vals, np.int32)
        return i, v

    rows, vals = pad(plan.link_rows, plan.link_vals, 64, cap + 1)
    segs, hvals = pad(plan.head_segs, plan.head_vals, 8, s1)
    dels, _ = pad(plan.delete_rows, None, 64, cap + 1)
    return {"mirror": mirror, "t_plan": t_plan, "n": n, "cap": cap, "s1": s1,
            "lanes": np.concatenate([rows, vals, segs, hvals, dels]),
            "k_l": len(rows), "k_h": len(segs), "k_d": len(dels)}


def b4_path(n_docs: int = N_B4_DOCS, device: str = "cuda") -> dict:
    """``bench.py``'s B4 replay on the port: the fixture's 182k inserts
    and 77k deletes planned once, fanned out over ``n_docs`` fresh docs by
    ``apply_plan_shared`` (K7a) in one call; every doc's tables equal doc
    0's, doc 0's equal the plain version's, and doc 0's text (ranked on
    the card) has the fixture's length and sha256."""
    import hashlib

    from yjs_tpu_torch.ops import kernels as K
    from yjs_tpu_torch.ops.engine import visible_text

    dev = torch.device(device)
    sp = b4_plan()
    cap, s1, n = sp["cap"], sp["s1"], sp["n"]
    k_l, k_h, k_d = sp["k_l"], sp["k_h"], sp["k_d"]
    lanes = torch.from_numpy(sp["lanes"]).to(dev)

    def fresh(b):
        return (torch.full((b, cap + 1), K.NULL, dtype=torch.int32, device=dev),
                torch.zeros((b, cap + 1), dtype=torch.bool, device=dev),
                torch.full((b, s1), K.NULL, dtype=torch.int32, device=dev))

    t0 = time.perf_counter()
    out = K.apply_plan_shared(fresh(n_docs), lanes, k_l, k_h, k_d)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    for name, t in zip(("right", "deleted", "starts"), out):
        check(bool((t == t[:1]).all()), f"B4: a doc's {name} differs from doc 0's")
    ref = K.apply_plan_shared_plain(fresh(1), lanes, k_l, k_h, k_d)
    for name, r, t in zip(("right", "deleted", "starts"), ref, out):
        check(torch.equal(r[0], t[0]), f"B4: doc 0's {name} differs from the plain version's")
    m = sp["mirror"]
    text_seg = m.segments[("text", None, K.NULL)]
    valid = torch.zeros((1, cap + 1), dtype=torch.bool)
    valid[0, :n] = torch.from_numpy(np.asarray(m.row_seg) == text_seg)
    d = K.list_ranks(out[0][:1].contiguous(), valid.to(dev))[0].cpu().numpy()
    rows = np.nonzero(d >= 0)[0]
    rows = rows[np.argsort(-d[rows], kind="stable")]
    text = visible_text(m, rows, out[1][0].cpu().numpy()[rows])
    meta = json.loads(B4.with_suffix(".json").read_text())
    check(len(text) == meta["text_len"]
          and hashlib.sha256(text.encode()).hexdigest() == meta["text_sha256"],
          "B4: doc 0's text differs from the fixture's")
    log(f"[b4] the B4 fixture ({meta['n_inserts']} inserts, {meta['n_deletes']} "
        f"deletes; {n} rows) planned once by the native mirror in "
        f"{sp['t_plan']:.3f}s, fanned out over {n_docs} docs by one "
        f"apply_plan_shared call ({t_step * 1e3:.3f} ms host wall with its "
        f"synchronise); every doc equals doc 0, doc 0 the plain version, its "
        f"text ({len(text)} chars) the fixture's sha256")
    del out, ref
    return {"apply_plan_shared": (fresh, lanes, k_l, k_h, k_d),
            "t_plan": sp["t_plan"], "n": n}


# -- phase 8 ----------------------------------------------------------------------


# -- phase 8: the doc-sharded mesh on the one card ---------------------------------


N_SHARDS = 4  # shards of the mesh, all on the one card
N_MESH_PLANNER_DOCS = 64
MESH_LAUNCHED = ("sharded_apply_plan", "sharded_batch_step",
                 "sharded_state_vectors", "sharded_lookup", "shard_fold")


class MeshSpy:
    """Wraps a meshed engine's ``_dispatch``.  For each "lanes" and
    "levels" dispatch it computes the plain per-shard progress counters
    from the dispatch's own inputs (new per lanes dispatch, summed over a
    flush's level blocks, as the engine's are), and it keeps the largest
    such dispatch's inputs with the tables as they were before it (for
    the kernel phase)."""

    def __init__(self, eng):
        self.eng = eng
        self.plain = None
        self.seen = {}
        self._orig = eng._dispatch
        eng._dispatch = self._spy

    def _keep(self, kind: str, size: int, make) -> None:
        best = self.seen.get(kind)
        if best is None or size > best[0]:
            self.seen[kind] = (size, make())

    def _spy(self, kind, *args, slot=None):
        eng = self.eng

        def tables():
            return [tuple(t.clone() for t in tabs) for tabs in eng._tabs]

        if kind == "lanes":
            host = slot.host.clone()
            b = eng._b_loc
            v = host.long()
            self.plain = [
                torch.stack([v[s, : 2 * b].sum(), v[s, 3 * b : 4 * b].sum()])
                .to(torch.int32) for s in range(v.shape[0])
            ]
            self._keep("lanes", host.numel(),
                       lambda: (tables(), host.to(eng.device), args[1]))
        elif kind == "levels":
            statics, splits, lv, dels, scratch = args
            c = [torch.stack([(a[..., 0] >= 0).sum(), (d >= 0).sum()])
                 .to(torch.int32).cpu() for a, d in zip(lv, dels)]
            first = eng._counters is None  # the flush's first level block
            self.plain = c if first else [
                a + x for a, x in zip(self.plain, c)
            ]
            self._keep("levels", sum(a.numel() for a in lv), lambda: (
                _clone(statics), tables(), _clone(splits), _clone(lv),
                _clone(dels), _clone(scratch),
            ))
        return self._orig(kind, *args, slot=slot)

    def check_metrics(self, what: str) -> dict:
        """The engine's ``last_metrics`` (its device counters, folded on
        the card) equal the plain fold of the plain counters."""
        from yjs_tpu_torch.parallel import mesh as pm

        got = self.eng.last_metrics
        want = pm.fold_metrics(self.plain, plain=True)
        check(got == want, f"{what}: last_metrics {got} != plain fold {want}")
        return got


def mesh_path(traces: list[bytes], edits: dict[int, list[bytes]],
              main_fig: dict, levels_trimmed: list, smi: str,
              device: str = "cuda", n_docs: int = N_DOCS) -> dict:
    """The doc-sharded engine at the main path's width on a mesh of
    ``N_SHARDS`` shards that share the card: the apply lane's two flushes,
    the warm-tier round trips and the exports, each step's trimmed tables
    equal to the main path's unmeshed engine's; the levels lane's two
    flushes against the YATA path's; the batched state vectors (K16)
    against the unmeshed engine's and a CPU ``Doc``; K16 on a 2 x 2
    ("docs", "rows") mesh against unsharded K9; a small Python-mirror
    meshed engine whose flush-2 chunk runs the sharded lookup (K13)
    against a meshed CPU twin, both planning cold.  Every flush's
    ``last_metrics`` equals the plain fold of its inputs' counters."""
    import yjs_tpu_torch as Y
    from yjs_tpu_torch.ops import BatchEngine, plan_cache
    from yjs_tpu_torch.ops import kernels as K
    from yjs_tpu_torch.ops.columns import DocMirror
    from yjs_tpu_torch.ops.engine import _bucket
    from yjs_tpu_torch.parallel import DocMesh
    from yjs_tpu_torch.parallel import mesh as pm

    card = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh = DocMesh([card] * N_SHARDS)
    trimmed = main_fig["trimmed"]
    log_of = main_fig["log_of"]
    held = [traces[i % len(traces)] for i in range(n_docs)]
    out = {"mesh": mesh}
    log(f"[mesh] {mesh}: {n_docs} docs, {n_docs // N_SHARDS} a shard; the "
        "apply lane shares the process's plan cache with the earlier "
        "phases (what this phase tests is the sharded apply, not planning)")

    # the apply lane: flush 1, flush 2 (with compaction), warm tier, exports
    eng = BatchEngine(n_docs, mesh=mesh)
    check(eng.device == card, "the meshed engine is not on the card")
    spy = MeshSpy(eng)
    for i in range(n_docs):
        eng.queue_update(i, held[i])
    out["apply1"] = timed_flush(eng)
    m1 = spy.check_metrics("apply flush 1")
    assert_trimmed(eng, trimmed[0], "apply flush 1 against the unmeshed "
                   "engine", "mesh")
    for t, ups in edits.items():
        for i in range(t, n_docs, len(traces)):
            for u in ups:
                eng.queue_update(i, u)
    out["apply2"] = timed_flush(eng)
    m2 = spy.check_metrics("apply flush 2")
    check(len(eng.last_compaction or []) == main_fig["n_compacted"],
          "the meshed flush 2 compacted another doc count")
    assert_trimmed(eng, trimmed[1], "apply flush 2 against the unmeshed "
                   "engine", "mesh")
    hydrated, sample = warm_tier_sample(n_docs)
    round_trip(eng, hydrated)
    for i in sample:
        check_export(Y, eng, log_of[i], i, "meshed")
    assert_trimmed(eng, trimmed[2], "after hydration and export against the "
                   "unmeshed engine", "mesh")
    shards = eng.shard_tables()
    check(len(shards) == N_SHARDS and all(
        t.device == card and t.shape[0] == n_docs // N_SHARDS
        for tabs, _st in shards for t in tabs
    ), "a shard's tables are not its doc block on the card")
    log(f"[mesh] apply flush 1 {out['apply1']:.3f}s, flush 2 "
        f"{out['apply2']:.3f}s ({smi}); last_metrics {m1} / {m2} equal the "
        f"plain fold; {len(sample)} sampled docs' texts and encoded states "
        f"equal the CPU Doc ({len(hydrated)} hydrated)")

    # K16 on the doc axis: the batched state vectors of every doc, one
    # launch for the four shards of the card and no fold (the wrappers'
    # counts over the call)
    docs = list(range(n_docs))
    torch.cuda.synchronize()
    before = dict(K.launches)
    t0 = time.perf_counter()
    svs = eng.state_vectors_batched(docs)
    out["t_state_vectors"] = time.perf_counter() - t0
    sv_grew = {k: K.launches[k] - before[k] for k in
               ("sharded_state_vectors", "shard_fold", "state_vector")}
    check(sv_grew == {"sharded_state_vectors": 1, "shard_fold": 0,
                      "state_vector": 0},
          f"state_vectors_batched on {N_SHARDS} shards of the card launched "
          f"{sv_grew}, not one K16 launch and no fold")
    check(svs == main_fig["state_vectors"],
          "meshed state vectors differ from the unmeshed engine's")
    for i in sample:
        doc = Y.Doc(gc=False)
        for u in log_of[i]:
            Y.apply_update(doc, u)
        want = {c: v for c, v in Y.get_state_vector(doc.store).items() if v}
        check(svs[i] == want, f"doc {i}: meshed state vector differs from "
              "the CPU Doc")
    row_slot, _clock, row_end = eng._sync_columns(docs)
    n_slots = _bucket(  # as the engine buckets it
        max(1, max(len(eng.mirrors[i].client_of_slot) for i in docs)), 4)
    if row_slot.shape[1] % 2:  # two row shards: an even row count
        row_slot = np.pad(row_slot, ((0, 0), (0, 1)), constant_values=-1)
        row_end = np.pad(row_end, ((0, 0), (0, 1)))
    out["sv_cols"] = (row_slot, row_end, n_slots)
    mesh2 = DocMesh(np.full((2, 2), card, dtype=object), ("docs", "rows"))
    out["mesh2"] = mesh2
    before = dict(K.launches)
    got2 = pm.sharded_state_vectors(mesh2, n_slots, "docs", "rows")(
        row_slot, row_end)
    sv2_grew = {k: K.launches[k] - before[k] for k in
                ("sharded_state_vectors", "shard_fold", "state_vector")}
    check(sv2_grew == {"sharded_state_vectors": 1, "shard_fold": 0,
                       "state_vector": 0},
          f"K16 on the 2 x 2 mesh of the card launched {sv2_grew}, not one "
          "launch and no fold")
    one = K.state_vector_kernel(pm.put_host(row_slot, card),
                                pm.put_host(row_end, card), n_slots)
    check(torch.equal(got2, one), "the 2 x 2 sharded state vectors differ "
          "from unsharded K9")
    log(f"[mesh] state_vectors_batched over {n_docs} docs "
        f"{out['t_state_vectors']:.4f}s equals the unmeshed engine's and "
        f"{len(sample)} CPU Docs' (launches {sv_grew}); on a 2 x 2 (docs x "
        f"rows) mesh over [{row_slot.shape[0]}, {row_slot.shape[1]}] sync "
        f"columns ({n_slots} slots) K16 equals unsharded K9 (launches "
        f"{sv2_grew})")
    out["lanes"] = spy.seen["lanes"][1]
    del eng, spy

    # the levels lane on the same mesh
    saved = {k: os.environ.get(k) for k in
             ("YTPU_KERNEL", "YTPU_NO_NATIVE_PLAN", "YTPU_PLAN_SEGMENT")}
    try:
        os.environ["YTPU_KERNEL"] = "levels"
        eng = BatchEngine(n_docs, mesh=mesh)
        spy = MeshSpy(eng)
        for i in range(n_docs):
            eng.queue_update(i, held[i])
        out["levels1"] = timed_flush(eng)
        l1 = spy.check_metrics("levels flush 1")
        assert_trimmed(eng, levels_trimmed[0], "levels flush 1 against the "
                       "YATA path's", "mesh")
        for t, ups in edits.items():
            for i in range(t, n_docs, len(traces)):
                for u in ups:
                    eng.queue_update(i, u)
        out["levels2"] = timed_flush(eng)
        l2 = spy.check_metrics("levels flush 2")
        assert_trimmed(eng, levels_trimmed[1], "levels flush 2 against the "
                       "YATA path's", "mesh")
        log(f"[mesh] levels flush 1 {out['levels1']:.3f}s, flush 2 "
            f"{out['levels2']:.3f}s ({smi}); last_metrics {l1} / {l2} equal "
            "the plain fold")
        out["levels"] = spy.seen["levels"][1]
        del eng, spy
        restore_env("YTPU_KERNEL", saved["YTPU_KERNEL"])

        # a Python-mirror meshed engine: the chunk planner's sharded lookup
        os.environ["YTPU_NO_NATIVE_PLAN"] = "1"
        os.environ.pop("YTPU_PLAN_SEGMENT", None)
        n = N_MESH_PLANNER_DOCS
        t0 = time.perf_counter()
        with worker_pool(n) as pool:
            bursts = make_bursts([[traces[i]] for i in range(n)], 700,
                                 pool).get()
        out["t_bursts"] = time.perf_counter() - t0
        eng = BatchEngine(n, mesh=mesh)
        twin = BatchEngine(n, mesh=DocMesh([torch.device("cpu")] * N_SHARDS))
        check(all(type(m) is DocMirror for m in eng.mirrors),
              "the meshed planner engine does not run on Python mirrors")
        spy = MeshSpy(eng)
        for k, ups in enumerate(([[traces[i]] for i in range(n)], bursts), 1):
            for e in (eng, twin):
                for i, us in enumerate(ups):
                    for u in us:
                        e.queue_update(i, u)
            before = K.launches["sharded_lookup"]
            plan_cache.reset_cache()  # each engine plans cold
            t = timed_flush(eng)
            plan_cache.reset_cache()
            twin.flush()
            lookups = K.launches["sharded_lookup"] - before
            m = eng.last_flush_metrics
            check(m["n_demoted"] == 0 and m["n_rolled_back"] == 0,
                  f"planner flush {k} demoted or rolled back a doc")
            check(m["plan_cache_hits"] == 0 and
                  twin.last_flush_metrics["plan_cache_hits"] == 0,
                  f"planner flush {k} replayed a cached plan")
            check(eng.last_metrics == twin.last_metrics,
                  f"planner flush {k}: last_metrics differ from the twin's")
            spy.check_metrics(f"planner flush {k}")
            assert_twins(eng, twin, f"planner flush {k} ({n} docs, "
                         f"{m['plan_threads']} co-planned, {lookups} "
                         f"sharded lookup launches, {t:.3f}s)", "mesh")
        # one launch serves every shard of the card
        check(lookups >= 1 or card.type != "cuda",
              "flush 2's chunk did not run the sharded lookup")
        for i in range(0, n, n // 8):
            check_export(Y, eng, [traces[i], *bursts[i]], i, "meshed planner")
        log(f"[mesh] planner engine: bursts {out['t_bursts']:.1f}s (set-up); "
            "8 sampled docs' texts and encoded states equal the CPU Doc")
        del eng, twin, spy
        plan_cache.reset_cache()
    finally:
        for k, v in saved.items():
            restore_env(k, v)
    return out


def mesh_rows(mfig: dict, m_launches: dict, plseen: dict) -> list[dict]:
    """K14, K15, K16, K13 and the fold against their plain versions on the
    card, at the mesh phase's largest inputs (K13 at the planner path's
    flush-2 shapes, split over the shards)."""
    from yjs_tpu_torch.ops import kernels as K
    from yjs_tpu_torch.parallel import mesh as pm

    mesh = mfig["mesh"]
    rows = []

    def fresh(tables):
        return [tuple(t.clone() for t in tabs) for tabs in tables]

    # K14 at the apply lane's flush-1 lanes
    tables, lanes, key = mfig["lanes"]
    parts = list(lanes)
    fn = fn_k14 = pm.sharded_apply_plan(mesh, "docs", *key)
    pfn = pm.sharded_apply_plan(mesh, "docs", *key, plain=True)
    got, gc = fn(fresh(tables), parts)
    ref, rc = pfn(fresh(tables), parts)
    err = max(max_abs_err(g, r) for gs, rs in zip(got, ref)
              for g, r in zip(gs, rs))
    err = max(err, max(max_abs_err(g, r) for g, r in zip(gc, rc)))
    base = fresh(tables)
    b_loc, n1 = tables[0][0].shape
    s1 = tables[0][2].shape[1]
    nbytes = sum(apply_lanes_bytes(p, b_loc, key, n1, s1) + 8 for p in parts)
    n_devices = len({str(d) for d in mesh.axis_devices()})
    rows.append({
        "name": "sharded_apply_plan", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/apply_lanes.cu",
        "replaces": "yjs_tpu/parallel/mesh.py:134",
        "shape": f"shards={len(parts)} B_loc={b_loc} N+1={n1} S+1={s1} "
                 f"lanes={tuple(lanes.shape)} {lanes.dtype}",
        "launches": m_launches["sharded_apply_plan"], "max_abs_err": err,
        "variant": K.last_variant["sharded_apply_plan"],
        "devices": n_devices,
        "kernels_a_call": kernels_a_call(lambda: fn(base, parts)),
        "ms": cuda_ms(lambda: fn(base, parts)),
        "host_us": host_split(lambda: fn(base, parts)),
        "device_ms": device_ms(lambda: fn(base, parts)),
        "plain_ms": cuda_ms(lambda: pfn(base, parts), 5),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    })

    # K15 at the levels lane's largest level block
    statics, tables, splits, lv, dels, scratch = mfig["levels"]
    fn = pm.sharded_batch_step(mesh, "docs")
    got, gc = fn(statics, fresh(tables), splits, lv, dels, scratch)
    b_loc, n1 = tables[0][0].shape
    info = yata_variant_row("sharded_batch_step", n1, tables[0][2].shape[1],
                            max(1, lv[0].shape[2]), tables[0][0].device)
    stats = [K.new_yata_stats(b_loc, t[0].device) for t in tables]
    ref = fresh(tables)
    rc = [torch.zeros(2, dtype=torch.int32, device=t[0].device)
          for t in tables]

    def plain():
        for s in range(len(ref)):
            K.batch_step_levels_plain(statics[s], ref[s], splits[s], lv[s],
                                      dels[s], scratch[s], stats=stats[s],
                                      counter=rc[s])

    plain_ms = once_ms(plain)
    err = max(max_abs_err(g, r) for gs, rs in zip(got, ref)
              for g, r in zip(gs, rs))
    err = max(err, max(max_abs_err(g, r) for g, r in zip(gc, rc)))
    work = fresh(tables)

    def restore():
        for w, o in zip(work, tables):
            for a, b in zip(w, o):
                a.copy_(b)

    def launch():
        fn(statics, work, splits, lv, dels, scratch)

    ms = cuda_ms_restored(launch, restore)
    nbytes = sum(
        yata_bytes("batch_step_levels",
                   (statics[s], tables[s], splits[s], lv[s], dels[s],
                    scratch[s]), stats[s]) + 8
        for s in range(len(tables))
    )
    chain = max(int(st["chain"].max()) for st in stats)
    # the host's share at the same shapes with an empty schedule (no lane
    # has a row), so that a thousand calls back to back do no YATA work
    idle = fresh(tables)
    null = [[torch.full_like(t, K.NULL) for t in blk]
            for blk in (splits, lv, dels)]
    rows.append({
        "name": "sharded_batch_step", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/yata.cu",
        "replaces": "yjs_tpu/parallel/mesh.py:101",
        "shape": f"shards={len(tables)} B_loc={b_loc} N+1={n1} "
                 f"schedule={tuple(lv[0].shape)} a shard",
        "launches": m_launches["sharded_batch_step"], "max_abs_err": err,
        "devices": n_devices,
        "kernels_a_call": kernels_a_call(launch, restore),
        "ms": ms, "plain_ms": plain_ms,
        "host_us": host_split(lambda: fn(statics, idle, *null, scratch)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "limited_by": "dep_chain", "dep_chain": chain,
        "ns_per_dep_load": ms * 1e6 / max(1, chain), **info,
    })

    # one launch a device, whatever the shards on it: the
    # wrappers' counts over one more call are the proof (and no shard went
    # through a one-shard wrapper); a trace may lose a kernel's event but
    # never adds one, so the trace's counts only bound ours from above
    for row, call, ours in (
            (rows[0], lambda: fn_k14(base, parts), ("apply_lanes_kernel",)),
            (rows[1], lambda: (restore(), launch()),
             ("batch_step_levels_kernel",))):
        grew = row["launches_a_call"] = launches_a_call(K, call)
        check(grew == {row["name"]: n_devices},
              f"{row['name']}: launches {grew} in one call on {n_devices} "
              "device(s)")
        seen = {k: v for k, v in (row["kernels_a_call"] or {}).items()
                if k.startswith(ours)}
        check(all(v <= n_devices for v in seen.values()),
              f"{row['name']}: the trace shows {seen} in one call on "
              f"{n_devices} device(s)")

    # K16 over the 4096 docs' sync columns, the doc axis over the shards
    row_slot, row_end, n_slots = mfig["sv_cols"]
    bs = pm.state_vector_blocks(mesh, row_slot)
    be = pm.state_vector_blocks(mesh, row_end)
    fn = pm.sharded_state_vectors(mesh, n_slots)
    pfn = pm.sharded_state_vectors(mesh, n_slots, plain=True)
    got = fn(bs, be)
    ref = pfn(bs, be)
    err = max_abs_err(got, ref)
    slot_d = pm.put_host(row_slot, got.device)
    end_d = pm.put_host(row_end, got.device)
    check(torch.equal(got, K.state_vector_kernel(slot_d, end_d, n_slots)),
          "K16 differs from unsharded K9")
    b, n = row_slot.shape
    seg = torch.where((slot_d >= 0) & (slot_d < n_slots), slot_d,
                      torch.full_like(slot_d, n_slots)).long()

    def library():
        return torch.zeros((b, n_slots + 1), dtype=torch.int32,
                           device=slot_d.device).scatter_reduce_(
            1, seg, end_d, "amax", include_self=True)

    check(torch.equal(library()[:, :n_slots], ref),
          "scatter_reduce_ disagrees with K16's plain version")
    # and on the 2 x 2 (docs x rows) mesh, the row shards meeting in one
    # output: one launch a call on the one card, no fold, by the counts
    mesh2 = mfig["mesh2"]
    bs2 = pm.state_vector_blocks(mesh2, row_slot, "docs", "rows")
    be2 = pm.state_vector_blocks(mesh2, row_end, "docs", "rows")
    fn2 = pm.sharded_state_vectors(mesh2, n_slots, "docs", "rows")
    got2 = fn2(bs2, be2)
    err = max(err, max_abs_err(got2, ref))
    a_call = {}
    for key, call in (("1-D", lambda: fn(bs, be)), ("2x2", lambda: fn2(bs2, be2))):
        a_call[key] = launches_a_call(K, call)
        check(a_call[key] == {"sharded_state_vectors": 1},
              f"K16 on the {key} mesh launched {a_call[key]} in one call on "
              "one card, not one launch and no fold")
    rows.append({
        "name": "sharded_state_vectors", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/state_vector.cu",
        "replaces": "yjs_tpu/parallel/mesh.py:168",
        "shape": f"shards={len(bs)} B={b} N={n} n_slots={n_slots}",
        "launches": m_launches["sharded_state_vectors"], "max_abs_err": err,
        "devices": 1, "launches_a_call": a_call,
        "ms": cuda_ms(lambda: fn(bs, be)),
        "ms_2x2": cuda_ms(lambda: fn2(bs2, be2)),
        "host_us": host_split(lambda: fn(bs, be)),
        "device_ms": device_ms(lambda: fn(bs, be)),
        "plain_ms": cuda_ms(lambda: pfn(bs, be), 5),
        "bound_ms": (row_slot.nbytes + row_end.nbytes + 4 * b * n_slots)
        / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": cuda_ms(library),
    })

    # the fold at the 2 x 2 mesh's row partials of one doc block (pmax)
    blocks = pm.state_vector_blocks(mfig["mesh2"], row_slot, "docs", "rows")
    ends = pm.state_vector_blocks(mfig["mesh2"], row_end, "docs", "rows")
    partials = [K.state_vector_kernel(s, e, n_slots)
                for s, e in zip(blocks[0], ends[0])]
    got = K.shard_fold(partials, "max")
    ref = K.shard_fold_plain(partials, "max")
    check(torch.equal(torch.maximum(*partials), ref),
          "torch.maximum disagrees with the plain fold")
    rows.append({
        "name": "shard_fold", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/shard_fold.cu",
        "replaces": "yjs_tpu/parallel/mesh.py:117",
        "shape": f"max of {len(partials)} x {tuple(partials[0].shape)} int32 "
                 "(the rows axis' pmax, :176; the counters' psum is 2 "
                 "int32 a shard)",
        "launches": m_launches["shard_fold"],
        "max_abs_err": max_abs_err(got, ref),
        "ms": cuda_ms(lambda: K.shard_fold(partials, "max")),
        "ms_obs_off": obs_off(lambda: cuda_ms(
            lambda: K.shard_fold(partials, "max"))),
        "host_us": host_split(lambda: K.shard_fold(partials, "max")),
        "device_ms": device_ms(lambda: K.shard_fold(partials, "max")),
        "plain_ms": cuda_ms(lambda: K.shard_fold_plain(partials, "max")),
        "bound_ms": (len(partials) + 1) * partials[0].nbytes
        / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.maximum(*partials)),
    })

    # K13 at the planner path's flush-2 lookup, its queries over the shards
    flat, q = plseen["anchor_lookup"]
    hays = [flat] * N_SHARDS  # one card: one copy of the haystack
    qs = list(q.chunk(N_SHARDS))
    got = K.sharded_anchor_lookup(hays, qs)
    ref = K.sharded_anchor_lookup_plain(hays, qs)
    err = max(max_abs_err(g, r) for g, r in zip(got, ref))
    check(torch.equal(torch.cat(got), K.anchor_lookup(flat, q)),
          "K13 differs from K11 on the whole query")

    def library():
        return [torch.searchsorted(flat, p, right=True) - 1 for p in qs]

    def library_one():
        # one card: the shards share one haystack, so one call over the
        # whole query computes the same function
        return torch.searchsorted(flat, q, right=True) - 1

    check(all(torch.equal(a, b) for a, b in zip(library(), ref)),
          "torch.searchsorted disagrees with K13's plain version")
    check(torch.equal(library_one(), torch.cat(ref)),
          "one torch.searchsorted disagrees with K13's plain version")
    rows.append({
        "name": "sharded_lookup", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/anchor_lookup.cu",
        "replaces": "yjs_tpu/ops/segment_planner.py:286",
        "shape": f"shards={N_SHARDS} haystack={flat.numel()} "
                 f"queries={q.numel()} int64",
        "launches": m_launches["sharded_lookup"], "max_abs_err": err,
        "ms": cuda_ms(lambda: K.sharded_anchor_lookup(hays, qs)),
        "ms_obs_off": obs_off(lambda: cuda_ms(
            lambda: K.sharded_anchor_lookup(hays, qs))),
        "host_us": host_split(lambda: K.sharded_anchor_lookup(hays, qs)),
        "device_ms": device_ms(lambda: K.sharded_anchor_lookup(hays, qs)),
        "plain_ms": cuda_ms(lambda: K.sharded_anchor_lookup_plain(hays, qs)),
        "bound_ms": lookup_bytes(flat, q) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": cuda_ms(library),
        "library_one_ms": cuda_ms(library_one),
    })
    for row in rows:
        row["path"] = "mesh"
    return rows


# -- phase 9: the fleet on the one card --------------------------------------------


N_FLEET_SHARDS = 8
N_FLEET_DOCS = 1024  # slots a shard
N_FLEET_ROOMS = 4096  # the main path's rooms, fed its traces
N_FLEET_MOVED = 64
N_FLEET_SAMPLED = 32  # rooms held to a CPU Doc, half of them lost at failover
N_GEO_ROOMS = 1024
N_GEO_TICKS = 400


def fleet_fingerprint(fleet, rooms: list[str]) -> dict:
    """What :func:`fleet_twins` compares of a fleet: its shards, live
    shards and routing epoch, each live shard's rooms and slots with a
    digest of each doc's trimmed tables, every room's owner and a digest
    of every room's encoded state."""
    from hashlib import blake2b

    from yjs_tpu_torch.ops.carry import trim_tables

    def digest(parts) -> bytes:
        h = blake2b(digest_size=16)
        for x in parts:
            if x is None:
                h.update(b"-")
            else:
                x = np.ascontiguousarray(x)
                h.update(f"{x.dtype}{x.shape}".encode())
                h.update(x.tobytes())
        return h.digest()

    shards = []
    for k, p in enumerate(fleet.shards):
        if fleet._is_stub(k):
            shards.append(None)
            continue
        shards.append((dict(p._guids), [
            None if t is None else digest(t) for t in trim_tables(p.engine)]))
    return {
        "n_shards": len(fleet.shards), "live": list(fleet.live_shards),
        "epoch": fleet.table.epoch, "shards": shards,
        "owners": [fleet.owner_of(g) for g in rooms],
        "states": [blake2b(fleet.encode_state_as_update(g),
                           digest_size=16).digest() for g in rooms],
    }


def fleet_twins(fleet, twin_fp: dict, rooms: list[str], what: str) -> None:
    """``fleet`` equals its CPU twin (``twin_fp``, the twin's
    :func:`fleet_fingerprint`): the same live shards and routing epoch,
    every shard's rooms in the same slots with the same trimmed tables,
    every room's owner, and every room's encoded state."""
    t0 = time.perf_counter()
    fp = fleet_fingerprint(fleet, rooms)
    check(fp["n_shards"] == twin_fp["n_shards"],
          f"{what}: {fp['n_shards']} shards, the twin {twin_fp['n_shards']}")
    check(fp["live"] == twin_fp["live"],
          f"{what}: live shards {fp['live']} vs {twin_fp['live']}")
    check(fp["epoch"] == twin_fp["epoch"],
          f"{what}: routing epoch {fp['epoch']} vs {twin_fp['epoch']}")
    for k, (a, b) in enumerate(zip(fp["shards"], twin_fp["shards"])):
        check((a is None) == (b is None),
              f"{what}: shard {k} is dead on one side only")
        if a is None:
            continue
        check(a[0] == b[0],
              f"{what}: shard {k} holds other rooms or slots than the twin's")
        for i, (x, y) in enumerate(zip(a[1], b[1])):
            check(x == y, f"{what}: shard {k} doc {i}: trimmed tables differ "
                  "from the CPU twin's")
    check(fp["owners"] == twin_fp["owners"],
          f"{what}: room placements differ from the twin's")
    bad = sum(x != y for x, y in zip(fp["states"], twin_fp["states"]))
    check(bad == 0, f"{what}: {bad} rooms' encoded states differ from the twin's")
    log(f"[fleet] {what}: {len(fp['live'])} live shards, epoch "
        f"{fp['epoch']}; tables, placements and {len(rooms)} rooms' "
        f"states equal the CPU twin's (checked in "
        f"{time.perf_counter() - t0:.1f}s)")


class FleetTwin:
    """The fleet path's CPU twin, ``FleetRouter(..., device="cpu")``, for
    a :class:`Twin` process of its own: each step runs beside the card
    fleet's and answers its seconds, its report and the twin's
    :func:`fleet_fingerprint`."""

    def __init__(self, n_shards: int, n_docs: int, wal_dir: str,
                 rooms: list[str]):
        from yjs_tpu_torch.fleet import FleetRouter

        self.rooms = rooms
        self.fleet = FleetRouter(n_shards, n_docs, wal_dir=wal_dir,
                                 device="cpu")

    def _step(self, fn) -> tuple:
        # host seconds: this process never touches the card
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        return dt, out, fleet_fingerprint(self.fleet, self.rooms)

    def ingest_flush(self, held: list[bytes]) -> tuple:
        f = self.fleet
        t0 = time.perf_counter()
        for g, u in zip(self.rooms, held):
            f.receive_update(g, u)
        return (time.perf_counter() - t0,) + self._step(f.flush)

    def migrate(self, moved: list[str], n: int) -> tuple:
        return self._step(lambda: fleet_migrate(self.fleet, moved, n))

    def drain(self, k: int) -> tuple:
        return self._step(lambda: fleet_flushed(self.fleet,
                                                self.fleet.drain_shard(k)))

    def tick(self) -> tuple:
        return self._step(lambda: fleet_flushed(self.fleet, self.fleet.tick()))

    def fail_over(self, victim: int) -> tuple:
        self.fleet.kill_shard(victim)
        return self._step(lambda: fleet_flushed(self.fleet,
                                                self.fleet.fail_over(victim)))

    def revive(self, victim: int) -> tuple:
        return self._step(lambda: fleet_flushed(
            self.fleet, self.fleet.revive_shard(victim)))

    def checkpoint_close(self) -> None:
        self.fleet.checkpoint()
        self.fleet.close(checkpoint=False)
        self.fleet = None

    def recover(self, wal_dir: str) -> tuple:
        from yjs_tpu_torch.fleet import FleetRouter

        def rec():
            self.fleet = FleetRouter.recover(wal_dir, device="cpu")

        return self._step(rec)

    def close(self) -> None:
        if self.fleet is not None:
            self.fleet.close(checkpoint=False)


def fleet_flushed(fleet, result):
    """``result``, after a flush of ``fleet``."""
    fleet.flush()
    return result


def fleet_migrate(fleet, moved: list[str], n: int) -> None:
    """Each room of ``moved`` to the next shard round the ring, then a
    flush."""
    for j, g in enumerate(moved):
        src = fleet.owner_of(g)
        fleet.migrate_doc(g, (src + 1 + j % (n - 1)) % n)
    fleet.flush()


def fleet_oracle(fleet, rooms: list[str], held: list[bytes],
                 sample: list[str], what: str, cache: dict) -> None:
    """Each sampled room's encoded state equals a CPU ``Doc`` fed its
    trace (``cache`` keeps each trace's canonical state)."""
    import yjs_tpu_torch as Y

    index = {g: i for i, g in enumerate(rooms)}
    for g in sample:
        u = held[index[g]]
        if u not in cache:
            doc = Y.Doc(gc=False)
            Y.apply_update(doc, u)
            cache[u] = Y.merge_updates([Y.encode_state_as_update(doc)])
        check(Y.merge_updates([fleet.encode_state_as_update(g)]) == cache[u],
              f"{g}: the fleet's state differs from the CPU Doc {what}")
    log(f"[fleet] {what}: {len(sample)} sampled rooms' states equal the CPU Doc")


def fleet_path(traces: list[bytes], smi: str, device: str = "cuda") -> dict:
    """``FleetRouter(8, 1024)`` on the card beside a CPU twin fleet fed the
    same bytes: one flush of 4096 rooms, 64 live migrations, a drain and a
    rebalancer tick, a kill with its failover and a revive, then a
    checkpoint, a close and a recovery; the two fleets equal after each.
    The twin (:class:`FleetTwin`) runs in a spawned process of its own,
    each step beside the card's."""
    import gc

    from yjs_tpu_torch.fleet import FleetRouter
    from yjs_tpu_torch.ops import kernels as K

    card_dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mem = (torch.cuda.memory_allocated if device == "cuda" else lambda: 0)
    rooms = [f"room-{i:04d}" for i in range(N_FLEET_ROOMS)]
    held = [traces[i % len(traces)] for i in range(N_FLEET_ROOMS)]
    fig = {}
    # exports read the host mirror here: the tables are compared whole
    saved = os.environ.pop("YTPU_EXPORT_DEVICE", None)
    twin = None
    try:
        with tempfile.TemporaryDirectory() as card_dir, \
                tempfile.TemporaryDirectory() as twin_dir:
            # the twin fleet runs in a process of its own, each step beside
            # the card fleet's, and answers with its fingerprint
            twin = Twin(FleetTwin, N_FLEET_SHARDS, N_FLEET_DOCS, twin_dir,
                        rooms)
            card = FleetRouter(N_FLEET_SHARDS, N_FLEET_DOCS,
                               wal_dir=card_dir, device=device)
            check(all(p.engine.device == card_dev for p in card.shards),
                  "a shard's engine is not on the card")
            twin.result()  # built
            twin.start("ingest_flush", held)
            _, fig["ingest"] = timed(lambda: [
                card.receive_update(g, u) for g, u in zip(rooms, held)])
            pending = [k for k in card.live_shards if card.shards[k]._dirty]
            before = K.launches["apply_lanes"]
            _, fig["flush"] = timed(card.flush)
            fig["flush_k1"] = K.launches["apply_lanes"] - before
            fig["ingest_twin"], fig["flush_twin"], _, tfp = twin.result()
            # (a CPU run counts no launches: the plain versions serve)
            check(device != "cuda" or fig["flush_k1"] >= len(pending),
                  f"the fleet flush launched apply_lanes {fig['flush_k1']} "
                  f"times for {len(pending)} shards with pending rooms")
            fig["pending_shards"] = len(pending)
            fig["elements"] = sum(sum(card.state_vector(g).values())
                                  for g in rooms)
            fig["per_shard"] = [len(card.shards[k].guids())
                                for k in card.live_shards]
            fleet_twins(card, tfp, rooms, "flush")

            # live migrations: each room to the next shard round the ring
            gen = random.Random(3)
            moved = gen.sample(rooms, N_FLEET_MOVED)
            n = N_FLEET_SHARDS
            twin.start("migrate", moved, n)
            _, fig["migrate"] = timed(lambda: fleet_migrate(card, moved, n))
            tfp = twin.result()[2]
            fleet_twins(card, tfp, rooms, f"{N_FLEET_MOVED} migrations")
            drained = card.owner_of(moved[0])
            twin.start("drain", drained)
            (fig["drained"], fig["drain"]) = timed(
                lambda: card.drain_shard(drained))
            card.flush()
            _, tdrained, tfp = twin.result()
            check(tdrained == fig["drained"], "the drain moved otherwise "
                  "than the twin's")
            fleet_twins(card, tfp, rooms, f"drain of shard {drained}")
            twin.start("tick")
            fig["decisions"] = card.tick()
            card.flush()
            _, tdecisions, tfp = twin.result()
            check(fig["decisions"] == tdecisions,
                  "the rebalancer decided otherwise than the twin's")
            fleet_twins(card, tfp, rooms, "rebalancer tick")

            # a shard's machine dies; its replicas are promoted
            victim = card.owner_of(rooms[1])
            fig["mem_before_kill"] = mem()
            owned = [g for g in rooms if card.owner_of(g) == victim]
            twin.start("fail_over", victim)
            card.kill_shard(victim)
            res, fig["failover"] = timed(
                lambda: fleet_flushed(card, card.fail_over(victim)))
            fig["failover_twin"], tres, tfp = twin.result()
            check(res == tres, "failover reports differ")
            # a room moved since its replica was seeded (as the drain
            # moved many onto this shard) may have none: failover declares
            # it lost (it comes back empty where it is next placed), and
            # the revive merges the dead shard's copy into it (the JAX
            # fleet does the same)
            check(len(res["promoted"]) + len(res["lost"]) == len(owned),
                  f"failover promoted {len(res['promoted'])} and lost "
                  f"{len(res['lost'])} of {len(owned)} rooms")
            fig["promoted"] = len(res["promoted"])
            fig["lost"] = len(res["lost"])
            fig["mem_after_failover"] = mem()
            fleet_twins(card, tfp, rooms, f"failover of shard {victim}")
            twin.start("revive", victim)
            rev = card.revive_shard(victim)
            check(card.shards[victim].engine.device == card_dev,
                  f"the revived shard's engine is on "
                  f"{card.shards[victim].engine.device}")
            fig["mem_after_revive"] = mem()
            fig["fenced"] = len(rev["fenced"])
            fig["readopted"] = len(rev["readopted"])
            card.flush()
            _, trev, tfp = twin.result()
            check(rev == trev, "revive reports differ")
            fleet_twins(card, tfp, rooms, f"revive of shard {victim}")
            lost_rooms = sorted(set(owned) - set(res["promoted"]))
            sample = sorted(set(lost_rooms[:N_FLEET_SAMPLED // 2])
                            | set(gen.sample(rooms, N_FLEET_SAMPLED // 2)))
            oracle = {}
            fleet_oracle(card, rooms, held, sample, "after the revive", oracle)

            # checkpoint, close, recover on the card
            twin.start("checkpoint_close")
            card.checkpoint()
            card.close(checkpoint=False)
            del card
            gc.collect()
            twin.result()
            twin.start("recover", twin_dir)
            rec, fig["recover"] = timed(
                lambda: FleetRouter.recover(card_dir, device=device))
            fig["recover_twin"], _, tfp = twin.result()
            check(all(rec._is_stub(k) or p.engine.device == card_dev
                      for k, p in enumerate(rec.shards)),
                  "a recovered shard's engine is not on the card")
            fleet_twins(rec, tfp, rooms, "recovery")
            fleet_oracle(rec, rooms, held, sample, "after the recovery", oracle)
            fig["resolution"] = rec.last_recovery["resolution"]
            rec.close(checkpoint=False)
            twin.call("close")
            del rec
            gc.collect()
    finally:
        if twin is not None:
            twin.stop()
        restore_env("YTPU_EXPORT_DEVICE", saved)
    rate = fig["elements"] / fig["flush"]
    log(f"[fleet] {N_FLEET_SHARDS} shards x {N_FLEET_DOCS} slots, "
        f"{N_FLEET_ROOMS} rooms ({min(fig['per_shard'])}-"
        f"{max(fig['per_shard'])} a shard): flush {fig['flush']:.3f}s, "
        f"{fig['elements']} elements = {rate:.0f} elements/s, apply_lanes "
        f"launched {fig['flush_k1']} times for {fig['pending_shards']} "
        f"shards ({smi})")
    log(f"[fleet] {N_FLEET_MOVED} migrations and their flush "
        f"{fig['migrate']:.3f}s = {N_FLEET_MOVED / fig['migrate']:.1f} "
        f"migrations/s; drain of {fig['drained']} rooms {fig['drain']:.3f}s "
        f"= {fig['drained'] / fig['drain']:.1f} migrations/s; rebalancer "
        f"decisions {len(fig['decisions'])} ({smi})")
    log(f"[fleet] kill to converged (fail_over + flush of {fig['promoted']} "
        f"promoted rooms, {fig['lost']} without a replica) "
        f"{fig['failover']:.3f}s; the revive fenced {fig['fenced']} rooms and "
        f"re-adopted {fig['readopted']}; recover wall {fig['recover']:.3f}s, "
        f"resolution {json.dumps(fig['resolution'], sort_keys=True)} ({smi})")
    log(f"[fleet] host s: ingest {fig['ingest']:.3f} (twin "
        f"{fig['ingest_twin']:.3f}); the twin's flush {fig['flush_twin']:.3f}, "
        f"failover {fig['failover_twin']:.3f}, recovery "
        f"{fig['recover_twin']:.3f}, each in its own process beside the "
        f"card's step ({smi})")
    log(f"[fleet] torch.cuda.memory_allocated: before the kill "
        f"{fig['mem_before_kill']}, after the failover "
        f"{fig['mem_after_failover']}, after the revive "
        f"{fig['mem_after_revive']} bytes")
    return fig


# -- phase 10: geo replication between two providers on the card ------------------


def _canonical_job(updates):
    """The canonical encoded state of a CPU ``Doc`` fed ``updates``."""
    import yjs_tpu_torch as Y

    doc = Y.Doc(gc=False)
    for u in updates:
        Y.apply_update(doc, u)
    return Y.merge_updates([Y.encode_state_as_update(doc)])


def geo_path(traces: list[bytes], smi: str, device: str = "cuda") -> dict:
    """Two regions, each a ``TpuProvider(1024)`` on the card with a
    ``GeoReplicator``, linked by a pair of in-memory pipes without faults:
    region A takes every room's fixture trace, region B a concurrent edit
    of every room by its own client; the replicators tick until every
    room's state vector agrees and both links are live.  Both regions'
    rooms must equal each other and a CPU ``Doc`` fed both updates."""
    import yjs_tpu_torch as Y
    from yjs_tpu_torch.geo import GeoConfig, GeoReplicator
    from yjs_tpu_torch.provider import TpuProvider
    from yjs_tpu_torch.sync.session import SessionConfig
    from yjs_tpu_torch.sync.transport import PipeNetwork

    card_dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    cfg = SessionConfig(
        seed=1, heartbeat=0, liveness=0, antientropy=8, hello_timeout=0,
        retry_base=4, retry_cap=16, retry_max=6, retry_jitter=0.25,
    )
    a = TpuProvider(N_GEO_ROOMS, device=device)
    b = TpuProvider(N_GEO_ROOMS, device=device)
    check(a.engine.device == card_dev and b.engine.device == card_dev,
          "a region's engine is not on the card")
    net = PipeNetwork()
    ta, tb = net.pair("geo:A", "geo:B")
    ra = GeoReplicator(a, GeoConfig(region="A", seed=1))
    rb = GeoReplicator(b, GeoConfig(region="B", seed=2))
    ra.add_peer("B", lambda: ta, session_config=cfg)
    rb.add_peer("A", lambda: tb, session_config=cfg)

    def tick():
        a.flush()
        b.flush()
        ra.tick()
        rb.tick()
        net.pump()

    for _ in range(12):  # the handshake
        tick()
    rooms = [f"geo-{i:04d}" for i in range(N_GEO_ROOMS)]
    edits_b = []
    for i, g in enumerate(rooms):
        d = Y.Doc(gc=False)
        d.client_id = 900000 + i
        d.get_text("text").insert(0, f"[B{i}]")
        edits_b.append(Y.encode_state_as_update(d))
        a.receive_update(g, traces[i % len(traces)])
        b.receive_update(g, edits_b[i])

    def live():
        return all(link.session.state == "live"
                   for rep in (ra, rb) for link in rep.links.values())

    def converge():
        for n in range(1, N_GEO_TICKS + 1):
            tick()
            if live() and all(a.state_vector(g) == b.state_vector(g)
                              for g in rooms):
                return n
        raise AssertionError(f"geo regions not converged in {N_GEO_TICKS} ticks")

    ticks, wall = timed(converge)
    with worker_pool(len(rooms)) as pool:
        wants = pool.map(_canonical_job, [
            (traces[i % len(traces)], edits_b[i]) for i in range(len(rooms))
        ], chunksize=16)
    for g, want in zip(rooms, wants):
        state = a.encode_state_as_update(g)
        check(state == b.encode_state_as_update(g),
              f"{g}: the regions' encoded states differ")
        check(Y.merge_updates([state]) == want,
              f"{g}: the regions' state differs from the CPU Doc")
    shipped = {r: rep.links[p].shipped_bytes
               for r, rep, p in (("A", ra, "B"), ("B", rb, "A"))}
    resyncs = [link.session.n_full_resyncs
               for rep in (ra, rb) for link in rep.links.values()]
    check(resyncs == [1, 1], f"geo links resynced {resyncs} times")
    log(f"[geo] 2 regions x {N_GEO_ROOMS} rooms edited in both: converged in "
        f"{ticks} ticks, {wall:.3f}s; delta bytes shipped A->B "
        f"{shipped['A']}, B->A {shipped['B']}; every room equals the CPU Doc "
        f"in both regions ({smi})")
    return {"ticks": ticks, "wall": wall, "shipped": shipped}


# -- phase 11: the capacity ramp on the card ----------------------------------------


def capacity_path(smi: str, device: str = "cuda") -> dict:
    """``ramp_capacity`` over providers on the card on a short stage
    list, into a TSDB of its own: every stage must be recorded there, and
    the knee read back from it."""
    from yjs_tpu_torch.obs.capacity import (
        CapacityConfig, ramp_capacity, read_knee, sessions_per_device,
    )
    from yjs_tpu_torch.obs.tsdb import Tsdb, TsdbConfig
    from yjs_tpu_torch.provider import TpuProvider

    card_dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    store = Tsdb(TsdbConfig(interval_s=1.0, retention_raw_s=86400.0,
                            directory=None))
    cfg = CapacityConfig(start_sessions=8, max_sessions=64, growth=2.0,
                         ticks_per_stage=24, flush_every=2, seed=0)

    def make_server(n):
        prov = TpuProvider(n + 4, device=device)
        check(prov.engine.device == card_dev,
              "a ramp stage's provider is not on the card")
        return prov

    result, wall = timed(
        lambda: ramp_capacity(make_server, config=cfg, store=store, now=1000.0))
    lo, hi = result["window"]
    stages = [s["sessions"] for s in result["stages"]]
    recorded = [int(v) for _, v in store.query(
        "ytpu_capacity_sessions", start=lo - 1.0, end=hi + 1.0, tier="raw")]
    oks = store.query("ytpu_capacity_ok", start=lo - 1.0, end=hi + 1.0,
                      tier="raw")
    check(recorded == stages and len(oks) == len(stages),
          f"the TSDB holds stages {recorded}, the ramp ran {stages}")
    knee = read_knee(store, lo - 1.0, hi + 1.0)
    check(knee == result["sessions_at_slo"],
          f"knee {knee} read back, the ramp reported {result['sessions_at_slo']}")
    spd = sessions_per_device(result)
    log(f"[capacity] stages {json.dumps(result['stages'])}; knee {knee} "
        f"sessions, sessions_per_device {spd['sessions_per_device']} "
        f"({spd['n_devices']} devices), ceiling hit {spd['ceiling_hit']}; "
        f"ramp wall {wall:.3f}s ({smi})")
    return {"knee": knee, "sessions_per_device": spd, "wall": wall,
            "stages": result["stages"]}


# -- phase 12: the process cluster on the card --------------------------------------


N_CLUSTER_SHARDS = 4
N_CLUSTER_DOCS = 1024  # slots a shard: the fleet phase's shard width
# rooms, each a distinct fixture trace: a restarted shard's recover
# materializes its journal-only replica copies beside its own rooms, so
# owned + replica rooms must fit its slots (at 2048 rooms one shard would
# hold 1073 of 1024)
N_CLUSTER_ROOMS = 1024
N_CLUSTER_CALLS = 4  # facade calls in flight, a cluster
N_CLUSTER_SAMPLED = 32
N_GATEWAY_ROOMS = 8  # a y-websocket and a session client in each
N_GATEWAY_EDITS = 64  # a client
N_STREAM_EDITS = 40  # the edit stream in flight through the kill
N_STREAM_BEFORE_KILL = 10
CLUSTER_WAIT_S = 120.0


def _load_script(name: str):
    """``scripts/<name>.py`` as a module (the cluster launcher's session
    and y-websocket clients drive the gateway; the gate phase calls the
    CI checks)."""
    import importlib.util

    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_supervisor():
    """The port's ``Supervisor`` with four instruments: the seconds each
    child took from spawn to its ready line; every child process it
    started, to hold each one's exit code; the children's kernel launch
    counts, read over RPC on demand and by every ``shutdown`` call (the
    graceful close's and a failover's close of each successor) just
    before it; and a log of every update and sync frame its facade
    accepted, in order, for the CPU twin."""
    import threading

    from yjs_tpu_torch.cluster import RpcError, Supervisor

    class SmokeSupervisor(Supervisor):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.spawns: list[tuple[int, float, str]] = []
            self.procs: list = []  # (shard, Popen), every child started
            self.launches: dict[str, int] = {}
            self.launch_read_errors: list[str] = []
            self.ingress: list[tuple[str, str, bytes]] = []
            self.logging = False
            self._ingress_lock = threading.Lock()

        def _spawn(self, sp) -> None:
            t0 = time.perf_counter()
            super()._spawn(sp)
            self.spawns.append(
                (sp.shard_id, time.perf_counter() - t0, sp.device))
            self.procs.append((sp.shard_id, sp.proc))
            client, call = sp.client, sp.client.call

            def counted_call(method, payload=None, timeout=None):
                if method == "shutdown":
                    self._take_launches(sp.shard_id, call)
                return call(method, payload, timeout=timeout)

            client.call = counted_call

        def _take_launches(self, k: int, call) -> None:
            try:
                got = call("launches", {"reset": True})["launches"]
            except RpcError as e:
                self.launch_read_errors.append(f"shard {k}: {e}")
                return
            with self._ingress_lock:
                for name, n in got.items():
                    self.launches[name] = self.launches.get(name, 0) + int(n)

        def read_launches(self) -> None:
            """Add every live child's launch counts to ``launches`` and
            zero them in the child."""
            for row in self.recovery_report()["shards"]:
                if row["state"] == "live":
                    self._take_launches(row["shard"],
                                        self._client_of(row["shard"]).call)

        def _record(self, kind: str, guid: str, data: bytes) -> None:
            if self.logging:
                with self._ingress_lock:
                    self.ingress.append((kind, guid, bytes(data)))

        def receive_update(self, guid, update, v2=False, internal=False):
            ok = super().receive_update(guid, update, v2=v2, internal=internal)
            if ok:
                self._record("update", guid, update)
            return ok

        def handle_sync_message(self, guid, message):
            reply = super().handle_sync_message(guid, message)
            self._record("sync", guid, message)
            return reply

        def drain_ingress(self) -> list:
            with self._ingress_lock:
                out, self.ingress = self.ingress, []
            return out

    return SmokeSupervisor


def _retry(fn, deadline_s: float = CLUSTER_WAIT_S):
    """One facade call, retried while its room's shard is down."""
    from yjs_tpu_torch.cluster import RpcError

    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return fn()
        except RpcError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def _flush_shards(sup) -> float:
    """Flush every live shard through its RPC client, which raises on any
    error the child reports (the facade's ``flush()`` drops them)."""
    t0 = time.perf_counter()
    for row in sup.recovery_report()["shards"]:
        if row["state"] == "live":
            sup._client_of(row["shard"]).call("flush", {})
    return time.perf_counter() - t0


def _cluster_states(sup, rooms: list[str]) -> dict:
    """Each room's state vector (as a map) and full diff (its bytes)."""
    import yjs_tpu_torch as Y

    def one(g):
        return (Y.decode_state_vector(_retry(
                    lambda: sup.state_vector_bytes(g))),
                _retry(lambda: sup.diff_update(g, None)))

    with ThreadPoolExecutor(N_CLUSTER_CALLS) as ex:
        return dict(zip(rooms, ex.map(one, rooms)))


def cluster_twins(card, twin, rooms: list[str], what: str,
                  canonical: bool = False) -> dict:
    """Every room's full diff from the card's cluster equals the CPU
    twin's byte for byte, and its state vector the twin's as a map (the
    twin first takes whatever the card's facade accepted since the last
    call); returns the card's.  A state vector's encoded order is the
    order its clients first reached the engine's flushes, which differs
    between a live run and its replay, so it is compared decoded, as the
    reference's cluster tests compare a room's peers.  With ``canonical``
    (after a restart) a diff whose bytes differ is compared in canonical
    form (``merge_updates``): a shard that replayed its WAL merged in one
    flush the structs that live flushes kept apart."""
    import yjs_tpu_torch as Y

    t0 = time.perf_counter()
    for kind, g, data in card.drain_ingress():
        if kind == "update":
            check(_retry(lambda: twin.receive_update(g, data)),
                  f"{what}: the twin refused an update of {g}")
        else:
            _retry(lambda: twin.handle_sync_message(g, data))
    t1 = time.perf_counter()
    _flush_shards(card)
    _flush_shards(twin)
    t2 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        fa = ex.submit(_cluster_states, card, rooms)
        fb = ex.submit(_cluster_states, twin, rooms)
        a, b = fa.result(), fb.result()
    bad = [g for g in rooms if a[g][0] != b[g][0]]
    check(not bad, f"{what}: {len(bad)} rooms' state vectors differ from "
          f"the twin's, first {bad[:3]}")
    t3 = time.perf_counter()
    bad = [g for g in rooms if a[g][1] != b[g][1]]
    n_raw = len(rooms) - len(bad)
    if canonical:
        bad = [g for g in bad if Y.merge_updates([a[g][1]])
               != Y.merge_updates([b[g][1]])]
    check(not bad, f"{what}: {len(bad)} rooms' full diffs differ from the "
          f"twin's, first {bad[:3]}")
    log(f"[cluster] {what}: {len(rooms)} rooms' state vectors and full "
        f"diffs equal the CPU twin's ({n_raw} diffs byte for byte, the "
        f"rest in canonical form); the twin's catch-up {t1 - t0:.1f}s, "
        f"flushes {t2 - t1:.1f}s, reads {t3 - t2:.1f}s, compare "
        f"{time.perf_counter() - t3:.1f}s")
    return a


def planned_events(sup, victim: int) -> None:
    """The supervisor reported exactly the smoke's two planned deaths of
    ``victim``: its restart, then its failover."""
    report = sup.recovery_report()
    got = [(e["outcome"], e["shard"]) for e in report["events"]]
    check(got == [("recovered", victim), ("failover", victim)]
          and report["outcomes"] == {"recovered": 1, "failover": 1},
          f"supervision reported {got}, outcomes {report['outcomes']}")


def _card_memory() -> dict:
    """The card's memory in use (MiB) and its compute processes' rows,
    from ``nvidia-smi``; a container may list every process under one
    pid, so a child's share is read from the total's growth."""
    def smi(*args) -> str:
        return subprocess.run(["nvidia-smi", *args,
                               "--format=csv,noheader,nounits"],
                              capture_output=True, text=True,
                              timeout=60).stdout
    used = smi("--query-gpu=memory.used").split()
    return {"used_mib": int(used[0]) if used else None,
            "apps": [line.strip() for line in
                     smi("--query-compute-apps=pid,used_memory").splitlines()
                     if line.strip()]}


def _pct(xs: list[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def gateway_edits(launcher, gw, card, rooms: list[str], seed: int) -> dict:
    """Two clients a room, one of each dialect, each making seeded edits
    (a unique token at the start or the end of its text, one at a time)
    and timing each until the update that carries it is applied at its
    room's other client."""
    import re
    import threading

    import yjs_tpu_torch as Y

    token_re = re.compile(rb"\[[ws]\d+e\d+\]")
    seen: list[dict] = []
    cond = threading.Condition()

    def watch(doc, box):
        def on_update(update, origin, _doc):
            now = time.perf_counter()
            found = token_re.findall(bytes(update))
            if found:
                with cond:
                    for tok in found:
                        box.setdefault(tok.decode("ascii"), now)
                    cond.notify_all()
        doc.on("update", on_update)

    pairs = []
    for j, g in enumerate(rooms):
        ws_doc, ss_doc = Y.Doc(gc=False), Y.Doc(gc=False)
        ws_doc.client_id, ss_doc.client_id = 500000 + 2 * j, 500001 + 2 * j
        boxes = ({}, {})
        watch(ws_doc, boxes[0])
        watch(ss_doc, boxes[1])
        seen.extend(boxes)
        pairs.append((launcher.WsClient(gw.port, g, doc=ws_doc),
                      launcher.SessionClient(gw.port, g, f"smoke-{j}",
                                             doc=ss_doc)))

    def wait_text(client, want, deadline_s=CLUSTER_WAIT_S) -> bool:
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            if client.text() == want:
                return True
            time.sleep(0.05)
        return False

    for (ws, ss), g in zip(pairs, rooms):
        want = _retry(lambda: card.text(g))
        for c in (ws, ss):
            check(wait_text(c, want),
                  f"{g}: a {type(c).__name__} never received the room")
    lat: list[float] = []
    fails: list[str] = []

    def drive(me, peer_box, tag, gen):
        for e in range(N_GATEWAY_EDITS):
            token = f"[{tag}e{e}]"
            with me.lock:
                text = me.doc.get_text("text")
                t0 = time.perf_counter()
                text.insert(0 if gen.random() < 0.5 else len(text), token)
            deadline = time.monotonic() + CLUSTER_WAIT_S
            with cond:
                while token not in peer_box and time.monotonic() < deadline:
                    cond.wait(0.5)
                at = peer_box.get(token)
                if at is None:
                    fails.append(token)
                    return
                lat.append(at - t0)

    gen = random.Random(seed)
    threads = []
    for j, (ws, ss) in enumerate(pairs):
        ws_box, ss_box = seen[2 * j], seen[2 * j + 1]
        for me, box, tag in ((ws, ss_box, f"w{j}"), (ss, ws_box, f"s{j}")):
            threads.append(threading.Thread(
                target=drive, args=(me, box, tag, random.Random(gen.random()))))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(not fails, f"edits never reached the peer: {fails[:4]}")
    for (ws, ss), g in zip(pairs, rooms):
        _retry(lambda: card.flush(g))
        want = _retry(lambda: card.text(g))
        for c in (ws, ss):
            check(wait_text(c, want),
                  f"{g}: a client never converged to the server text")
    return {"pairs": pairs, "lat": lat, "wall": wall,
            "p50_ms": _pct(lat, 0.5) * 1e3, "p99_ms": _pct(lat, 0.99) * 1e3}


def cluster_path(traces: list[bytes], smi: str, device: str = "cuda",
                 n_docs: int = N_CLUSTER_DOCS,
                 n_rooms: int = N_CLUSTER_ROOMS) -> dict:
    """Four shard processes on the card (each its own CUDA context) under
    the port's ``Supervisor`` beside a CPU twin cluster fed the same
    bytes, a gateway over the card's: spawn, rooms, gateway clients, a
    kill -9 with its restart, a failover, federation, and a graceful
    close; the two clusters' rooms equal after each step."""
    # the children run ``python -m yjs_tpu_torch.cluster.shard``: they
    # find the package from any working directory
    saved_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), saved_path) if p)
    try:
        return _cluster_path(traces, smi, device, n_docs, n_rooms)
    finally:
        restore_env("PYTHONPATH", saved_path)


def _cluster_path(traces, smi, device, n_docs, n_rooms) -> dict:
    import signal
    import tempfile
    import threading

    import yjs_tpu_torch as Y
    from yjs_tpu_torch.cluster import (
        ClusterConfig, Gateway, GatewayConfig, RpcError,
    )

    launcher = _load_script("torch_ytpu_cluster")
    Sup = _smoke_supervisor()
    cfg = ClusterConfig(heartbeat_s=0.15, restart_max=1,
                        restart_backoff_s=0.05, spawn_timeout_s=600.0)
    rooms = [f"room-{i:04d}" for i in range(n_rooms)]
    held = [traces[i % len(traces)] for i in range(n_rooms)]
    fig: dict = {}
    card_type = torch.device(device).type
    with tempfile.TemporaryDirectory() as card_root, \
            tempfile.TemporaryDirectory() as twin_root:
        card = Sup(N_CLUSTER_SHARDS, card_root, docs_per_shard=n_docs,
                   config=cfg, backend="auto", device=device)
        twin = Sup(N_CLUSTER_SHARDS, twin_root, docs_per_shard=n_docs,
                   config=cfg, backend="auto", device="cpu")
        gw = None
        pairs = []
        try:
            # 1. spawn: the two clusters' children come up side by side
            on_card = card_type == "cuda"
            mem0 = _card_memory() if on_card else {}
            t0 = time.perf_counter()
            tw = threading.Thread(target=twin.start)
            tw.start()
            card.start()
            tw.join()
            fig["spawn_wall"] = time.perf_counter() - t0
            rows = card.recovery_report()["shards"]
            check(all(torch.device(r["device"]).type == card_type
                      for r in rows),
                  f"a child's ready line names another device: "
                  f"{[r['device'] for r in rows]}")
            check({r["device"] for r in twin.recovery_report()["shards"]}
                  == {"cpu"}, "a twin child is not on the CPU")
            log(f"[cluster] spawn to ready ({smi}): " + ", ".join(
                f"shard {k} {s:.2f}s on {d}" for k, s, d in card.spawns)
                + f"; twin {', '.join(f'{s:.2f}s' for _, s, _ in twin.spawns)}")
            card.read_launches()  # every count zero before the path
            card.launches.clear()

            # 2. rooms through the facade, then every shard flushed
            def ingest(sup):
                def one(i):
                    g, u = rooms[i], held[i]
                    check(_retry(lambda: sup.receive_update(g, u)),
                          f"{g}: the facade refused its trace")

                t = time.perf_counter()
                with ThreadPoolExecutor(N_CLUSTER_CALLS) as ex:
                    list(ex.map(one, range(n_rooms)))
                return time.perf_counter() - t

            with ThreadPoolExecutor(1) as ex:
                ft = ex.submit(ingest, twin)
                fig["ingest"] = ingest(card)
                fig["ingest_twin"] = ft.result()
            fig["flush"] = _flush_shards(card)
            # each child made its CUDA context at its first flush
            mem1 = _card_memory() if on_card else {}
            per_shard = [len(_retry(lambda: card._call(r["shard"], "guids", {}))
                             ["guids"]) for r in rows]
            states = cluster_twins(card, twin, rooms, f"{n_rooms} rooms")
            fig["elements"] = sum(sum(sv.values())
                                  for sv, _ in states.values())
            gen = random.Random(5)
            sample = gen.sample(range(n_rooms), N_CLUSTER_SAMPLED)
            for i in sample:
                doc = Y.Doc(gc=False)
                Y.apply_update(doc, held[i])
                check(_retry(lambda: card.text(rooms[i]))
                      == doc.get_text("text").to_string(),
                      f"{rooms[i]}: the cluster's text differs from the CPU Doc")
            rate = fig["elements"] / (fig["ingest"] + fig["flush"])
            log(f"[cluster] {N_CLUSTER_SHARDS} shards x {n_docs} slots, "
                f"{n_rooms} rooms ({min(per_shard)}-{max(per_shard)} a "
                f"shard, replica copies besides): ingest through the facade, "
                f"{N_CLUSTER_CALLS} calls in flight, "
                f"{fig['ingest']:.3f}s (the shards' tickers flush meanwhile), "
                f"then the flush of every shard {fig['flush']:.3f}s; "
                f"{fig['elements']} elements = {rate:.0f} elements/s; "
                f"{N_CLUSTER_SAMPLED} sampled texts equal the CPU Doc; twin "
                f"ingest {fig['ingest_twin']:.3f}s ({smi})")

            # 3. the gateway: two dialects, two clients a room
            gw = Gateway(card, config=GatewayConfig(port=0)).start()
            card.logging = True
            gw_rooms = rooms[:N_GATEWAY_ROOMS]
            g3 = gateway_edits(launcher, gw, card, gw_rooms, seed=6)
            pairs = g3.pop("pairs")
            lat = g3.pop("lat")
            fig["gateway"] = g3
            cluster_twins(card, twin, rooms, "gateway edits")
            log(f"[cluster] gateway: {2 * len(gw_rooms)} clients on "
                f"{len(gw_rooms)} rooms (y-websocket and session dialects), "
                f"{len(lat)} edits: edit-to-visible p50 {g3['p50_ms']:.1f} "
                f"ms, p99 {g3['p99_ms']:.1f} ms, wall {g3['wall']:.2f}s; "
                f"every client converged to its room's server text ({smi})")

            # 4. kill -9 an edited room's owner with an edit stream and a
            # flush in flight; the child restarts through recover
            victim = card.owner_of(gw_rooms[0])
            stream_room = next(g for g in rooms[N_GATEWAY_ROOMS:]
                               if card.owner_of(g) == victim)
            sdoc = Y.Doc(gc=False)
            sdoc.client_id = 777777
            acked = []
            killed = threading.Event()

            def stream():
                for e in range(N_STREAM_EDITS):
                    sv = Y.encode_state_vector(sdoc)
                    sdoc.get_text("text").insert(0, f"[k{e}]")
                    u = Y.encode_state_as_update(sdoc, sv)
                    check(_retry(lambda: card.receive_update(stream_room, u)),
                          "a stream edit was refused")
                    acked.append(time.perf_counter())

            def flusher():
                while not killed.is_set():
                    try:
                        card._client_of(victim).call("flush", {})
                    except RpcError:
                        return  # the kill cut it

            ts = threading.Thread(target=stream)
            ts.start()
            while len(acked) < N_STREAM_BEFORE_KILL:
                time.sleep(0.001)
            tf = threading.Thread(target=flusher)
            tf.start()
            time.sleep(0.02)
            card.read_launches()
            old_pid = card._shards[victim].pid
            killed_procs = [card._shards[victim].proc]
            t_kill = time.perf_counter()
            os.kill(old_pid, signal.SIGKILL)
            killed.set()
            deadline = time.monotonic() + CLUSTER_WAIT_S
            while card.recovery_report()["outcomes"].get("recovered", 0) < 1:
                check(time.monotonic() < deadline, "no restart was reported")
                time.sleep(0.01)
            t_back = time.perf_counter()
            ts.join()
            tf.join()
            t_stream = acked[-1]
            report = card.recovery_report()
            (ev,) = report["events"]
            check(ev["outcome"] == "recovered" and ev["shard"] == victim,
                  f"the restart reported {ev}")
            check(ev["recovery"].get("outcome") == "recovered",
                  "the restarted child did not replay its WAL")
            row = report["shards"][victim]
            check(row["pid"] != old_pid and torch.device(row["device"]).type
                  == card_type, f"the restarted child runs on {row['device']}")
            sv = Y.decode_state_vector(
                _retry(lambda: card.state_vector_bytes(stream_room)))
            check(sv.get(sdoc.client_id, 0)
                  == Y.decode_state_vector(Y.encode_state_vector(sdoc))[
                      sdoc.client_id],
                  "an acked stream edit was lost over the kill")
            fig["restart"] = {
                "unavailable_s": ev["unavailable_s"],
                "kill_to_recovered_s": t_back - t_kill,
                "kill_to_stream_acked_s": t_stream - t_kill,
                "records_applied": ev["recovery"].get("records_applied"),
            }
            cluster_twins(card, twin, rooms, f"kill -9 of shard {victim}",
                          canonical=True)
            for ws, ss in pairs:
                want = _retry(lambda: card.text(ws.room))
                check(ws.text() == want and ss.text() == want,
                      f"{ws.room}: a client lost the server text")
            log(f"[cluster] kill -9 of shard {victim} (owner of "
                f"{gw_rooms[0]}) with {N_STREAM_EDITS} stream edits to "
                f"{stream_room} and a flush in flight: outcome recovered, "
                f"{ev['recovery'].get('records_applied')} WAL records "
                f"replayed on the card, unavailable_s {ev['unavailable_s']}, "
                f"kill to recovered {t_back - t_kill:.3f}s, kill to the "
                f"last stream edit acked {t_stream - t_kill:.3f}s; no acked "
                f"edit lost ({smi})")

            # 5. the same shard again, past restart_max: failover
            card.read_launches()
            owned = [g for g in rooms if card.owner_of(g) == victim]
            killed_procs.append(card._shards[victim].proc)
            t_kill = time.perf_counter()
            os.kill(card._shards[victim].pid, signal.SIGKILL)
            deadline = time.monotonic() + CLUSTER_WAIT_S
            while card.recovery_report()["outcomes"].get("failover", 0) < 1:
                check(time.monotonic() < deadline, "no failover was reported")
                time.sleep(0.01)
            t_back = time.perf_counter()
            report = card.recovery_report()
            ev = report["events"][-1]
            planned_events(card, victim)
            check(ev["promoted"] >= 1, f"the failover reported {ev}")
            check(report["shards"][victim]["state"] == "lost",
                  "the failed shard is not marked lost")
            moved = {card.owner_of(g) for g in owned}
            check(victim not in moved, "a room stayed on the lost shard")
            check(all(torch.device(r["device"]).type == card_type
                      for r in report["shards"] if r["state"] == "live"),
                  "a promoted successor runs off the card")
            # the twin keeps every room where it was: the comparison is by
            # room, wherever the card now serves it
            cluster_twins(card, twin, rooms, f"failover of shard {victim}",
                          canonical=True)
            sv = Y.decode_state_vector(
                _retry(lambda: card.state_vector_bytes(stream_room)))
            check(sv.get(sdoc.client_id, 0)
                  == Y.decode_state_vector(Y.encode_state_vector(sdoc))[
                      sdoc.client_id],
                  "an acked stream edit was lost over the failover")
            fig["failover"] = {
                "kill_to_failover_s": t_back - t_kill,
                "unavailable_s": ev["unavailable_s"],
                "promoted": ev["promoted"],
                "successors": sorted(moved),
                "rooms": len(owned),
            }
            log(f"[cluster] failover of shard {victim} past restart_max: "
                f"{ev['promoted']} of its {len(owned)} rooms promoted onto "
                f"shards {sorted(moved)} (recover-restarted on the card), "
                f"unavailable_s {ev['unavailable_s']}, kill to failover "
                f"{t_back - t_kill:.3f}s; every room served again and equal "
                f"to the twin's, every acked edit held ({smi})")

            # 6. federation, launches, memory on the card
            snap = card.metrics_snapshot()
            card.read_launches()
            pids = [r["pid"] for r in card.recovery_report()["shards"]
                    if r["state"] == "live"]
            mem2 = _card_memory() if on_card else {}
            fig["card_memory"] = {"before_spawn": mem0, "rooms_in": mem1,
                                  "after_failover": mem2}
            # a checkpoint of every live shard through its RPC client,
            # side by side (counted: a closing checkpoint is not, it runs
            # after the child's RPC server has closed)
            live = [r["shard"] for r in card.recovery_report()["shards"]
                    if r["state"] == "live"]
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(live)) as ex:
                done = list(ex.map(lambda k: card._client_of(k).call(
                    "checkpoint", {})["checkpoint"], live))
            check(all(done), f"a shard wrote no checkpoint: {done}")
            fig["checkpoint"] = time.perf_counter() - t0
            card.read_launches()
            fed = snap["federation"]
            check(fed.get("stale") == [f"shard-{victim:03d}"],
                  f"federation: stale sources {fed.get('stale')}")
            log(f"[cluster] federation: {fed['sources']} sources, "
                f"stale {fed.get('stale')}")
            per_child = ([(m["used_mib"] - mem0["used_mib"]) / n
                          for m, n in ((mem1, N_CLUSTER_SHARDS),
                                       (mem2, len(pids)))]
                         if on_card else None)
            log(f"[cluster] checkpoint of the {len(pids)} live shards "
                f"{fig['checkpoint']:.3f}s; the children's kernel launches "
                f"so far (read before each kill, before each successor's "
                f"close and after the checkpoint) "
                f"{json.dumps(card.launches, sort_keys=True)}")
            log(f"[cluster] memory on the card (nvidia-smi, MiB): "
                f"{json.dumps(fig['card_memory'])}; a child's share of the "
                f"growth over the parent's: {per_child} MiB, with its rooms "
                f"in and after the failover ({smi})")
        finally:
            for ws, ss in pairs:
                ws.close()
                ss.close()
            if gw is not None:
                gw.close()
            # 7. a graceful close checkpoints every shard
            t0 = time.perf_counter()
            procs = [sp.proc for sp in card._shards.values()
                     if sp.state == "live"]
            tw = threading.Thread(target=twin.close)
            tw.start()
            card.close()
            fig["close"] = time.perf_counter() - t0
            tw.join()
        # supervision saw the two planned deaths and nothing else: a child
        # that failed on its own (a kernel error exits 1, and the monitor
        # would restart it) shows as another event or another exit code
        planned_events(card, victim)
        check(not twin.recovery_report()["events"],
              f"the twin's supervisor saw {twin.recovery_report()['events']}")
        check(not card.launch_read_errors,
              f"launch counts unread: {card.launch_read_errors}")
        fig["launches"] = dict(card.launches)
        exits = [(k, p.poll(), -signal.SIGKILL if p in killed_procs else 0)
                 for sup in (card, twin) for k, p in sup.procs]
        bad = [(k, rc, want) for k, rc, want in exits if rc != want]
        check(not bad, f"children exited with codes other than planned "
              f"(shard, code, planned): {bad}")
        snaps = [d for d in sorted(Path(card_root).iterdir())
                 if d.name != f"shard-{victim:03d}"
                 and not any(p.name.startswith("checkpoint-")
                             for p in d.iterdir())]
        check(not snaps, f"no closing checkpoint in {snaps}")
        log(f"[cluster] graceful close {fig['close']:.3f}s: {len(procs)} "
            f"children exited 0, each WAL holds its closing checkpoint; of "
            f"the {len(exits)} children the two clusters started, the two "
            f"killed exited -9, the rest 0, and supervision reported only "
            f"the planned restart and failover")
    return fig


# -- phase 13: peer sessions between two providers on the card --------------------

N_SESSION_ROOMS = 2048  # one session pair a room; cut from 4096 for time
# every flush (K1), the batched state vectors (K9) and full diffs and the
# checkpoint (K10, under YTPU_SYNC_DEVICE=1), the text exports (K8,
# under YTPU_EXPORT_DEVICE=1)
SESSION_LAUNCHED = ("apply_lanes", "state_vector", "diff_mask", "list_ranks")
N_SESSION_ROUNDS = 4  # a trace cut into four updates, one dealt a round
SESSION_KILL_AFTER = 2  # rounds before B is killed
SESSION_CHAOS = dict(seed=15, drop=0.05, duplicate=0.02, reorder=0.05,
                     delay=0.05)
SESSION_PARTITION = (1, 2, 3)  # round, its tick, pump rounds the link is down
SESSION_SETTLE_TICKS = 400
SESSION_QUIET_TICKS = 1
N_TCP_CLIENTS = 32
N_TCP_EDITS = 8  # a client
TCP_EDIT_GAP_S = 0.1
TCP_WAIT_S = 120.0
CHILD_WAIT_S = 300.0


def _trace_pieces(trace: bytes, n: int = N_SESSION_ROUNDS) -> list[bytes]:
    """``trace`` as ``n`` incremental updates whose merge is the trace:
    each client's structs cut at every ``n``-th of its clock (a quarter,
    a half and three quarters for the session's four; prefixes rebuilt
    from snapshots that delete nothing), the last piece carrying the
    rest and the whole delete set."""
    import yjs_tpu_torch as Y
    from yjs_tpu_torch.core import DeleteSet
    from yjs_tpu_torch.utils.snapshot import (
        create_doc_from_snapshot, create_snapshot,
    )

    doc = Y.Doc(gc=False)
    Y.apply_update(doc, trace)
    full = Y.decode_state_vector(Y.encode_state_vector(doc))
    prefixes = []
    for k in range(1, n):
        cut = {c: clock * k // n for c, clock in full.items()}
        prefix = create_doc_from_snapshot(
            doc, create_snapshot(DeleteSet(), cut), Y.Doc(gc=False)
        )
        prefixes.append(Y.encode_state_as_update(prefix))
    prefixes.append(trace)
    out, prev = [], None
    for p in prefixes:
        out.append(p if prev is None else Y.diff_update(
            p, Y.encode_state_vector_from_update(prev)))
        prev = p
    return out


def _trace_oracle(updates: list[bytes]) -> tuple:
    """A CPU ``Doc`` fed ``updates``: its text, state vector and full
    diff in canonical form."""
    import yjs_tpu_torch as Y

    doc = Y.Doc(gc=False)
    for u in updates:
        Y.apply_update(doc, u)
    return (doc.get_text("text").to_string(),
            Y.decode_state_vector(Y.encode_state_vector(doc)),
            Y.merge_updates([Y.encode_state_as_update(doc)]))


def _canonical_check_job(job):
    """``(room, side)`` of each full diff whose canonical form is not
    ``canon``; equal diffs are merged once (rooms dealt alike often give
    the same bytes)."""
    import yjs_tpu_torch as Y

    canon, states = job
    same: dict[bytes, bool] = {}
    for _key, state in states:
        if state not in same:
            same[state] = Y.merge_updates([state]) == canon
    return [key for key, state in states if not same[state]]


def _pin_sids(start: int) -> None:
    """Session ids seed each session's retransmit backoff: the card's
    pair and its CPU twin number theirs alike."""
    import itertools

    from yjs_tpu_torch.sync import session as session_mod

    session_mod._SID = itertools.count(start)


class SessionPair:
    """Providers A and B, each ``TpuProvider(n_rooms)`` with a WAL, and
    one session pair a room over one ``PipeNetwork`` behind a seeded
    ``NetworkFaultInjector``; every frame the network takes goes into a
    running digest, and A's flushes are timed."""

    def __init__(self, rooms: list[str], device: str, root: Path):
        import hashlib

        from yjs_tpu_torch.provider import TpuProvider
        from yjs_tpu_torch.resilience import (
            NetChaosConfig, NetworkFaultInjector,
        )
        from yjs_tpu_torch.sync.session import SessionConfig
        from yjs_tpu_torch.sync.transport import PipeNetwork

        self.rooms = rooms
        self.device = device
        self.root = root
        self.cfg = SessionConfig(
            seed=SESSION_CHAOS["seed"], retry_base=2, retry_cap=8,
            retry_max=6, retry_jitter=0.25, antientropy=16, heartbeat=0,
            liveness=0, hello_timeout=0,
        )
        self.injector = NetworkFaultInjector(NetChaosConfig(**SESSION_CHAOS))
        self.net = PipeNetwork(self.injector)
        self.digest = hashlib.blake2b(digest_size=16)
        self.n_frames = 0
        enqueue = self.net._enqueue

        def spy(src, dst, frame):
            self.digest.update(src.name.encode() + b"\0" + bytes(frame))
            self.n_frames += 1
            enqueue(src, dst, frame)

        self.net._enqueue = spy
        self.a = TpuProvider(len(rooms), device=device,
                             wal_dir=str(root / "a"))
        self.b = TpuProvider(len(rooms), device=device,
                             wal_dir=str(root / "b"))
        self.flush_s = 0.0
        self.killed_rows: list[dict] = []  # B's sessions' counters at its kill
        self.links: dict[str, tuple] = {}
        _pin_sids(1)
        for g in rooms:
            ta, tb = self.net.pair(f"A:{g}", f"B:{g}")
            self.a.session(g, "B", self.cfg).connect(ta)
            self.b.session(g, "A", self.cfg).connect(tb)
            self.links[g] = (ta, tb)

    def sync(self) -> None:
        if self.device != "cpu":
            torch.cuda.synchronize()

    def flush(self) -> None:
        self.sync()
        t0 = time.perf_counter()
        self.a.flush()
        self.sync()
        self.flush_s += time.perf_counter() - t0
        self.b.flush()

    def tick(self) -> None:
        self.net.pump()
        self.flush()
        self.a.tick_sessions()
        self.b.tick_sessions()

    def quiet(self) -> bool:
        if self.net.in_flight:
            return False
        return all(s.outbox_depth == 0 for p in (self.a, self.b)
                   for s in p._sessions.values())

    def settle(self, partition_at: int | None = None) -> int:
        """Ticks until the wire and every outbox stayed empty for
        ``SESSION_QUIET_TICKS`` ticks; a partition opens at tick
        ``partition_at`` for ``SESSION_PARTITION[2]`` pump rounds."""
        quiet = 0
        for n in range(1, SESSION_SETTLE_TICKS + 1):
            if n == partition_at:
                self.injector._partition_left = SESSION_PARTITION[2]
            self.tick()
            quiet = quiet + 1 if self.quiet() else 0
            if quiet >= SESSION_QUIET_TICKS and n > (partition_at or 0):
                return n
        raise AssertionError(
            f"sessions not settled in {SESSION_SETTLE_TICKS} ticks")

    def deal(self, k: int, piece: list[bytes]) -> tuple[int, int]:
        """Round ``k``: each room's trace's ``k``-th piece (``piece``, one
        a trace) to A or to B, in turn."""
        n_a = 0
        for i, g in enumerate(self.rooms):
            target = self.a if (i + k) % 2 == 0 else self.b
            n_a += target is self.a
            target.receive_update(g, piece[i % len(piece)])
        return n_a, len(self.rooms) - n_a

    def play_round(self, k: int, piece: list[bytes],
                   partition_at: int | None) -> tuple:
        """Deal, flush, tick the sessions and settle: ``(dealt, ticks)``."""
        dealt = self.deal(k, piece)
        self.flush()
        self.a.tick_sessions()
        self.b.tick_sessions()
        return dealt, self.settle(partition_at)

    def take_to_a(self, updates: dict[str, list[bytes]]) -> int:
        """``updates`` into A's rooms, then settle: the ticks taken."""
        for g, ups in updates.items():
            for u in ups:
                self.a.receive_update(g, u)
        return self.settle()

    def fingerprint(self) -> tuple:
        """The frames so far (count and digest) and A's and B's device
        tables (dtype, shape and a digest of their bytes)."""
        import hashlib

        tables = {}
        for name, p in (("A", self.a), ("B", self.b)):
            for t in ("_right", "_deleted", "_starts"):
                u = getattr(p.engine, t)
                if u is not None:
                    u = u.cpu().contiguous()
                    u = (str(u.dtype), tuple(u.shape), hashlib.blake2b(
                        u.numpy(), digest_size=16).digest())
                tables[f"{name}'s {t}"] = u
        return self.n_frames, self.digest.digest(), tables

    def states(self) -> dict:
        """Every room's full diff and state vector, on A and on B."""
        out = {}
        for name, p in (("A", self.a), ("B", self.b)):
            docs = [p.doc_id(g) for g in self.rooms]
            out[name] = (p.engine.encode_states_batched(docs),
                         p.engine.state_vectors_batched(docs))
        return out

    def texts(self, rooms: list[str]) -> list[tuple[str, str]]:
        return [(self.a.text(g), self.b.text(g)) for g in rooms]

    def close(self) -> None:
        self.a.close(checkpoint=False)
        self.b.close(checkpoint=False)

    def kill_and_recover_b(self) -> float:
        """B dies without a checkpoint (its WAL handle dropped), is
        recovered from its WAL on its device, and its sessions re-attach
        armed with the journaled ack floors; returns the recover wall."""
        from yjs_tpu_torch.provider import TpuProvider

        for ta, tb in self.links.values():
            self.net.kill(ta, tb)
        self.killed_rows = self.b.sessions_snapshot()
        self.b.wal.abandon()
        self.b = None
        self.sync()
        t0 = time.perf_counter()
        self.b = TpuProvider.recover(str(self.root / "b"),
                                     device=self.device)
        self.sync()
        wall = time.perf_counter() - t0
        _pin_sids(1 << 20)
        for g in self.rooms:
            ta, tb = self.net.pair(f"A:{g}", f"B:{g}")
            self.a.session(g, "B", self.cfg).attach(ta)
            self.b.session(g, "A", self.cfg).connect(tb)
            self.links[g] = (ta, tb)
        return wall

    def state_vectors(self, p) -> list[dict]:
        return p.engine.state_vectors_batched([p.doc_id(g) for g in self.rooms])

    def counters(self) -> dict:
        rows = (self.a.sessions_snapshot() + self.b.sessions_snapshot()
                + self.killed_rows)
        out = {k: sum(r[k] for r in rows)
               for k in ("sent", "retransmits", "repairs", "resumes",
                         "full_resyncs")}
        out.update(self.injector.fault_counts)
        return out


def _twin_main(conn, factory, args: tuple) -> None:
    """A CPU twin's process: builds ``factory(*args)``, then runs each
    ``(method, args)`` that arrives until ``close``; each step, the build
    included, answers ``(True, result)`` or ``(False, traceback)``."""
    import traceback

    torch.set_num_threads(TWIN_THREADS)
    twin, op = None, None
    while op != "close":
        try:
            if twin is None:
                twin = factory(*args)
                out = None
            else:
                op, op_args = conn.recv()
                out = getattr(twin, op)(*op_args)
            conn.send((True, out))
        except BaseException:
            conn.send((False, traceback.format_exc()))
            return


class Twin:
    """A CPU twin, ``factory(*args)``, in a spawned process of its own:
    :meth:`start` sends it a step, which runs beside the card's, and
    :meth:`result` waits for that step's answer (the first answer is
    the build's)."""

    def __init__(self, factory, *args):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_twin_main,
                                args=(child, factory, args), daemon=True)
        self.proc.start()
        child.close()

    def start(self, op: str, *args) -> None:
        self.conn.send((op, args))

    def result(self):
        ok, out = self.conn.recv()
        check(ok, f"the CPU twin failed: {out}")
        return out

    def call(self, op: str, *args):
        self.start(op, *args)
        return self.result()

    def stop(self) -> None:
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(30)


def session_twins(card: SessionPair, twin_fp: tuple, what: str) -> None:
    """The card's pair equals its CPU twin: the same frames in the same
    order, and A's and B's device tables byte for byte."""
    n, digest, tables = card.fingerprint()
    check(n == twin_fp[0] and digest == twin_fp[1],
          f"{what}: the frames differ from the twin's ({n} vs {twin_fp[0]})")
    for name, t in tables.items():
        check(t == twin_fp[2][name], f"{what}: {name} differs from the twin's")


def _tcp_clients(pair: SessionPair, rooms: list[str], seed: int) -> dict:
    """``N_TCP_CLIENTS`` socket clients (``examples/torch_socket_connector``)
    over loopback TCP, one a room of A, each a ``--provider`` session
    served by A on this thread: each syncs, then all edit at once
    ``N_TCP_EDITS`` times; an edit is visible once A's flushed state
    vector covers it.  Returns the clients' updates a room and the
    edit-to-visible times."""
    import socket

    import yjs_tpu_torch as Y
    from yjs_tpu_torch.sync.session import SessionConfig

    from yjs_tpu_torch.cluster.gateway import ProviderHost

    sys.path.insert(0, str(ROOT / "examples"))
    from torch_socket_connector import SocketConnector

    cfg = SessionConfig(seed=seed, heartbeat=0, liveness=0, hello_timeout=0)
    host = ProviderHost(pair.a, config=cfg)
    port = host.listen(0)
    gen = random.Random(seed)
    clients = []
    sent: dict[str, list[bytes]] = {g: [] for g in rooms}
    for k, g in enumerate(rooms):
        doc = Y.Doc(gc=False)
        doc.client_id = 800000 + k

        def record(u, origin, d, _g=g):
            if origin is None:  # a local edit, not the server's
                sent[_g].append(bytes(u))

        doc.on("update", record)
        sock = socket.create_connection(("127.0.0.1", port))
        conn = SocketConnector(doc, sock, config=cfg, room=g, peer=f"tcp-{k}")
        conn.connect()
        clients.append((g, doc, conn))
    a = pair.a

    def pump_until(cond, what):
        deadline = time.perf_counter() + TCP_WAIT_S
        while not cond():
            check(time.perf_counter() < deadline, f"TCP clients: {what}")
            if not host.pump():
                time.sleep(0.002)

    def synced():
        for g, doc, conn in clients:
            with conn.lock:
                sv = Y.decode_state_vector(Y.encode_state_vector(doc))
            if conn.session.state != "live" or sv != a.state_vector(g):
                return False
        return True

    t0 = time.perf_counter()
    pump_until(synced, "the initial sync did not converge")
    t_sync = time.perf_counter() - t0
    pending = []  # (room, client id, clock, t0)
    lat = []
    t0 = time.perf_counter()
    for j in range(N_TCP_EDITS):
        for g, doc, conn in clients:
            with conn.lock:
                t = doc.get_text("text")
                t.insert(gen.randrange(len(t) + 1), f"<{g}:{j}>")
                clock = Y.decode_state_vector(
                    Y.encode_state_vector(doc))[doc.client_id]
            pending.append((g, doc.client_id, clock, time.perf_counter()))
        gap = time.perf_counter() + TCP_EDIT_GAP_S
        while time.perf_counter() < gap or (j == N_TCP_EDITS - 1 and pending):
            host.pump()
            now = time.perf_counter()
            left = []
            for g, cid, clock, te in pending:
                if a.engine.state_vector(a.doc_id(g)).get(cid, 0) >= clock:
                    lat.append(now - te)
                else:
                    left.append((g, cid, clock, te))
            pending = left
            check(now - t0 < TCP_WAIT_S, "TCP edits never became visible")

    def converged():
        for g, doc, conn in clients:
            with conn.lock:
                text = doc.get_text("text").to_string()
                sv = Y.decode_state_vector(Y.encode_state_vector(doc))
            if text != a.text(g) or sv != a.state_vector(g):
                return False
        return True

    pump_until(converged, "the clients did not converge with A")
    t_converge = time.perf_counter() - t0
    for _g, _doc, conn in clients:
        conn.close()
        check(conn.join(timeout=10.0), "a TCP client's threads did not join")
    host.close()
    return {"sent": sent, "lat": lat, "t_sync": t_sync,
            "t_converge": t_converge}


def _child_runs(device: str, snap_dir: Path | None = None) -> dict:
    """The port's operator scripts and server demo as child processes,
    on the card (``--device cpu`` when the phase runs on the CPU), with
    the rows each must print; the snapshot directory's dashboard when
    ``snap_dir`` is given."""
    extra = ["--device", "cpu"] if device == "cpu" else []
    if snap_dir is not None:
        return {"torch_ytpu_top <dir> --once --plain": (
            ["scripts/torch_ytpu_top.py", str(snap_dir), "--once", "--plain"],
            ("FLEET", " " * 13 + "a ", " " * 13 + "b "))}
    return {
        "torch_ytpu_stats --demo --json": (
            ["scripts/torch_ytpu_stats.py", "--demo", "--json"] + extra,
            ('"counters"', '"ytpu_net_')),
        "torch_ytpu_top --demo --once --plain": (
            ["scripts/torch_ytpu_top.py", "--demo", "--once", "--plain"]
            + extra, ("provider-a", "provider-b", "fleet verdict")),
        "torch_server_demo": (
            ["examples/torch_server_demo.py"] + extra,
            ("demo OK", f"provider on {'cpu' if device == 'cpu' else 'cuda'}")),
    }


class _Child:
    """One child process and a thread that waits for it, so its wall is
    its own even while this thread drives the sessions."""

    def __init__(self, argv: list[str], env: dict):
        import threading

        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable] + argv, cwd=str(ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        self.out = self.err = ""
        self.wall = None
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self) -> None:
        self.out, self.err = self.proc.communicate()
        self.wall = time.perf_counter() - self.t0

    def join(self, timeout: float) -> None:
        self._waiter.join(timeout)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self._waiter.join(30)


def _start_children(runs: dict) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return {name: _Child(argv, env) for name, (argv, _want) in runs.items()}


def _finish_children(runs: dict, children: dict) -> dict:
    """Wait for each child: it must exit 0 and print its rows; returns
    each one's seconds from its start to its exit."""
    try:
        for name, child in children.items():
            child.join(CHILD_WAIT_S)
            check(child.wall is not None, f"{name} did not exit in "
                  f"{CHILD_WAIT_S:.0f}s")
            check(child.proc.returncode == 0,
                  f"{name} exited {child.proc.returncode}: {child.err[-2000:]}")
            for want in runs[name][1]:
                check(want in child.out, f"{name} printed no {want!r}: "
                      f"{child.out[-1500:]}")
    finally:
        for child in children.values():
            child.kill()
    return {name: child.wall for name, child in children.items()}


def session_path(traces: list[bytes], smi: str, device: str = "cuda",
                 n_rooms: int = N_SESSION_ROOMS) -> dict:
    """Two providers on the card, A and B, each ``TpuProvider(n_rooms)``
    with a WAL under ``YTPU_SYNC_DEVICE=1`` and ``YTPU_EXPORT_DEVICE=1``,
    one session pair a room over a faulted pipe network, beside a CPU
    twin pair driven by the same seeded injector and schedule: four
    rounds deal each room's trace between A and B; B is killed after
    round 2 and recovered from its WAL; TCP clients edit rooms of A;
    the operator scripts and the server demo run as child processes.
    The twin pair runs in a spawned process of its own, each step beside
    the card pair's; spawned workers cut the traces and build the CPU
    ``Doc`` oracle while the pairs are built and finish before the first
    round, and the children start after the TCP clients, so while the
    rounds and the edits are timed only the twin's process shares the
    host."""
    import shutil

    saved = os.environ.get("YTPU_EXPORT_DEVICE")
    os.environ["YTPU_EXPORT_DEVICE"] = "1"
    root = Path(tempfile.mkdtemp(prefix="ytpu-session-"))
    fig = {}
    rooms = [f"s-{i:04d}" for i in range(n_rooms)]
    n_traces = min(len(traces), n_rooms)
    tcp_rooms = rooms[:N_TCP_CLIENTS]
    pool = worker_pool(n_traces)
    children = {}
    twin = None
    try:
        t0 = time.perf_counter()
        pieces_async = pool.map_async(_trace_pieces, traces[:n_traces],
                                      chunksize=8)
        oracle_async = pool.map_async(
            _trace_oracle, [[t] for t in traces[:n_traces]], chunksize=8)
        twin = Twin(SessionPair, rooms, "cpu", root / "twin")
        card = SessionPair(rooms, device, root / "card")
        dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
        check(card.a.engine.device == dev and card.b.engine.device == dev,
              "a session provider's engine is not on its device")
        twin.result()  # built
        twin.start("settle")  # the handshake, beside the card's
        ticks = [card.settle(), twin.result()]
        check(ticks[0] == ticks[1], f"handshake: settled in {ticks[0]} ticks, "
              f"the twin in {ticks[1]}")
        session_twins(card, twin.call("fingerprint"), "handshake")
        # the workers finish before the rounds, and the children start
        # after the TCP clients: the timed rounds, flushes, recovery and
        # edits share the host with the twin's process alone
        pieces = pieces_async.get()
        oracle = oracle_async.get()
        fig["t_setup"] = time.perf_counter() - t0
        rounds = []
        t_rounds = time.perf_counter()
        for k in range(N_SESSION_ROUNDS):
            tr = time.perf_counter()
            part = SESSION_PARTITION[1] if k == SESSION_PARTITION[0] else None
            piece = [p[k] for p in pieces]
            twin.start("play_round", k, piece, part)
            dealt, ticks = card.play_round(k, piece, part)
            t_card = time.perf_counter() - tr
            twin_ticks = twin.result()[1]
            check(ticks == twin_ticks,
                  f"round {k + 1}: settled in {ticks} ticks, the twin in "
                  f"{twin_ticks}")
            session_twins(card, twin.call("fingerprint"), f"round {k + 1}")
            check(card.state_vectors(card.a) == card.state_vectors(card.b),
                  f"round {k + 1}: A and B did not converge")
            rounds.append({"ticks": ticks, "s": t_card,
                           "s_twin": time.perf_counter() - tr,
                           "dealt": dealt, "frames": card.n_frames})
            log(f"[session] round {k + 1}: {dealt[0]} updates to A, "
                f"{dealt[1]} to B; settled in {ticks} ticks, {t_card:.3f}s "
                f"({rounds[-1]['s_twin']:.3f}s until the twin's answer and "
                f"the comparison); {card.n_frames} frames so far; A and B "
                "converged; frames and tables equal the CPU twin's")
            if k + 1 == SESSION_KILL_AFTER:
                twin.start("kill_and_recover_b")
                t_kill = time.perf_counter()
                fig["recover"] = card.kill_and_recover_b()
                cu = card.settle()
                check(card.state_vectors(card.a) == card.state_vectors(card.b),
                      "B did not catch up with A")
                fig["kill_to_caught_up"] = time.perf_counter() - t_kill
                fig["recover_twin"] = twin.result()
                twin_cu = twin.call("settle")
                check(cu == twin_cu, f"catch-up ticks {cu}, the twin's {twin_cu}")
                fig["catch_up_ticks"] = cu
                session_twins(card, twin.call("fingerprint"), "B recovered")
                c = card.counters()
                log(f"[session] B killed after round {k + 1} (no "
                    f"checkpoint), recovered from its WAL on the card in "
                    f"{fig['recover']:.3f}s (the twin {fig['recover_twin']:.3f}s "
                    f"beside it), caught up by delta replay in {cu} ticks: "
                    f"kill to caught up {fig['kill_to_caught_up']:.3f}s; "
                    f"sessions resumed {c['resumes']}, full resyncs "
                    f"{c['full_resyncs']} (B's killed sessions included; "
                    f"{smi})")
        fig["t_rounds"] = time.perf_counter() - t_rounds
        fig["rounds"] = rounds
        c = card.counters()
        check(all(r["full_resyncs"] == 1 and r["resumes"] == 1
                  for r in card.a.sessions_snapshot()),
              "A's sessions did not resume B by delta replay (one full "
              "resync and one resume a session)")
        check(c["net_partition"] >= SESSION_PARTITION[2],
              "the partition never opened")
        fig["counters"] = c
        elements = sum(sum(sv.values()) for sv in card.state_vectors(card.a))
        fig["elements"] = elements
        fig["flush_s"] = card.flush_s
        log(f"[session] converged: {N_SESSION_ROUNDS} rounds, "
            f"{sum(r['ticks'] for r in rounds) + fig['catch_up_ticks']} "
            f"ticks, {fig['t_rounds']:.3f}s with the twin's comparisons; "
            f"frames sent {c['sent']} ({card.n_frames} through the network), "
            f"dropped {c['net_drop']}, duplicated {c['net_dup']}, delayed "
            f"{c['net_delay']}, reordered rounds {c['net_reorder']}, "
            f"partitioned rounds {c['net_partition']}; retransmitted "
            f"{c['retransmits']}; repairs {c['repairs']} (the session "
            "counters of A's sessions, B's and B's killed ones)")
        log(f"[session] A's flushes: {elements} elements in "
            f"{card.flush_s:.3f}s = {elements / card.flush_s:.0f} elements/s "
            f"({smi})")

        # TCP clients on A (the twin's A takes their updates afterwards)
        t0 = time.perf_counter()
        tcp = _tcp_clients(card, tcp_rooms, seed=71)
        fig["tcp"] = {k: tcp[k] for k in ("t_sync", "t_converge")}
        twin.start("take_to_a", tcp["sent"])
        ticks = [card.settle(), twin.result()]
        lat = tcp["lat"]
        check(len(lat) == N_TCP_CLIENTS * N_TCP_EDITS,
              f"{len(lat)} TCP edits timed")
        fig["tcp_p50_ms"] = _pct(lat, 0.50) * 1e3
        fig["tcp_p99_ms"] = _pct(lat, 0.99) * 1e3
        log(f"[session] TCP: {N_TCP_CLIENTS} socket clients "
            f"(torch_socket_connector, --provider sessions on A), synced in "
            f"{tcp['t_sync']:.3f}s; {len(lat)} concurrent edits, "
            f"edit-to-visible p50 {fig['tcp_p50_ms']:.1f} ms, p99 "
            f"{fig['tcp_p99_ms']:.1f} ms; every client converged with A in "
            f"{tcp['t_converge']:.3f}s; B took the edits in {ticks[0]} ticks "
            f"({time.perf_counter() - t0:.1f}s, the twin's A taking them "
            f"beside it; {smi})")

        # the operator scripts and the server demo, beside the checks
        runs = _child_runs(device)
        children = _start_children(runs)

        # every room on A and B against the CPU Doc, and against the twin:
        # the twin encodes its states and the workers merge full diffs
        # while this thread reads the card's
        t0 = time.perf_counter()
        twin.start("states")
        tcp_async = pool.map_async(
            _trace_oracle,
            [[traces[i % n_traces]] + tcp["sent"][g]
             for i, g in enumerate(tcp_rooms)])
        states = card.states()
        t_states = time.perf_counter() - t0
        states.update((f"twin {k}", v) for k, v in twin.result().items())
        want = {g: oracle[i % n_traces] for i, g in enumerate(rooms)}
        want.update(zip(tcp_rooms, tcp_async.get()))
        jobs = {}
        for i, g in enumerate(rooms):
            for side in ("A", "B"):
                check(states[side][1][i] == want[g][1],
                      f"{g}: {side}'s state vector differs from the CPU Doc")
                check(states[side][1][i] == states[f"twin {side}"][1][i],
                      f"{g}: {side}'s state vector differs from the twin's")
                if g not in tcp_rooms:
                    check(states[side][0][i] == states[f"twin {side}"][0][i],
                          f"{g}: {side}'s full diff differs from the twin's")
            sides = ("A", "B", "twin A", "twin B") if g in tcp_rooms else ("A", "B")
            key = g if g in tcp_rooms else i % n_traces
            job = jobs.setdefault(key, (want[g][2], []))
            job[1].extend(((g, s), states[s][0][i]) for s in sides)
        merged = pool.map_async(_canonical_check_job, list(jobs.values()),
                                chunksize=4)
        t_texts = time.perf_counter()
        for name, p in (("A", card.a), ("B", card.b)):
            bad = [g for g in rooms if p.text(g) != want[g][0]]
            check(not bad, f"{name}'s text differs from the CPU Doc in "
                  f"{len(bad)} rooms: {bad[:8]}")
        t_texts = time.perf_counter() - t_texts
        for g, texts in zip(tcp_rooms, twin.call("texts", tcp_rooms)):
            check(texts == (want[g][0], want[g][0]),
                  f"{g}: the twin's text differs from the CPU Doc")
        t_merged = time.perf_counter()
        bad = [key for part in merged.get() for key in part]
        t_merged = time.perf_counter() - t_merged
        check(not bad, f"full diffs differ from the CPU Doc: {bad[:8]}")
        fig["t_oracle"] = time.perf_counter() - t0
        log(f"[session] every one of {n_rooms} rooms on A and on B equals a "
            "CPU Doc fed its whole trace and the TCP edits (text, state "
            "vector as a map, full diff in canonical form), and the CPU twin "
            f"pair (state vectors; full diffs byte for byte but in the "
            f"{len(tcp_rooms)} TCP rooms, canonical there): "
            f"{fig['t_oracle']:.1f}s (the card's states {t_states:.1f}s, "
            f"its {2 * n_rooms} texts {t_texts:.1f}s, then the workers' "
            f"merges {t_merged:.1f}s more)")

        # the children exit, then an operator's checkpoint of A and the
        # snapshot dashboard
        fig["children"] = _finish_children(runs, children)
        children = {}
        card.sync()
        t0 = time.perf_counter()
        card.a.checkpoint()
        card.sync()
        fig["checkpoint"] = time.perf_counter() - t0
        snap_dir = root / "snapshots"
        snap_dir.mkdir()
        for name, p in (("a", card.a), ("b", card.b)):
            (snap_dir / f"{name}.json").write_text(
                json.dumps(p.metrics_snapshot()))
        dir_runs = _child_runs(device, snap_dir)
        fig["children"].update(
            _finish_children(dir_runs, _start_children(dir_runs)))
        log(f"[session] A's checkpoint {fig['checkpoint']:.3f}s; children "
            "exited 0 with their rows (s from start to exit; the first three "
            "ran beside the oracle checks): " + ", ".join(
                f"{k} {v:.1f}" for k, v in fig["children"].items()))
        card.close()
        twin.call("close")
    finally:
        for child in children.values():
            child.kill()
        if twin is not None:
            twin.stop()
        pool.terminate()
        pool.join()
        restore_env("YTPU_EXPORT_DEVICE", saved)
        shutil.rmtree(root, ignore_errors=True)
    return fig


N_GATE_DOCS = 128  # the fixture's first traces, one doc each; cut from 256 for time
N_GATE_PIECES = 8  # each trace cut into eight updates
GATE_WAIT_S = 300.0
GATE_LAUNCHER = ["scripts/torch_ytpu_cluster.py", "--shards", "2", "--smoke"]


def _batch_ops(pieces: list[bytes], device: str) -> tuple:
    """The doc-free batch ops on one doc's updates: their merge, the
    first update's state vector and the merge's diff against it."""
    from yjs_tpu_torch.ops import batch

    merged = batch.merge_updates_columnar(pieces, device=device)
    sv = batch.encode_state_vector_from_update_columnar(pieces[0],
                                                        device=device)
    return merged, sv, batch.diff_update_columnar(merged, sv, device=device)


def _gate_job(trace: bytes) -> tuple:
    """In a worker: ``trace`` cut into ``N_GATE_PIECES`` updates, the
    batch ops on the Python mirror with ``device="cpu"`` (the planner's
    plain kernels), and which of their results disagree with the CPU
    core's ``merge_updates`` / ``encode_state_vector_from_update`` /
    ``diff_update``.  The core merges adjacent runs and the columnar ops
    keep each update's, so merge and diff are compared in canonical form
    (``merge_updates([x])``), state vectors as maps."""
    os.environ["YTPU_NO_NATIVE_PLAN"] = "1"
    import yjs_tpu_torch as Y

    pieces = _trace_pieces(trace, N_GATE_PIECES)
    merged, sv, diff = _batch_ops(pieces, "cpu")
    o_merged = Y.merge_updates(pieces)
    o_sv = Y.encode_state_vector_from_update(pieces[0])
    wrong = []
    if Y.merge_updates([merged]) != o_merged:
        wrong.append("merge")
    if Y.decode_state_vector(sv) != Y.decode_state_vector(o_sv):
        wrong.append("state vector")
    if Y.merge_updates([diff]) != Y.merge_updates(
            [Y.diff_update(o_merged, o_sv)]):
        wrong.append("diff")
    return pieces, (merged, sv, diff), wrong


def _delta(K, before: dict) -> dict:
    """The wrappers' launch counts that grew since ``before``."""
    return {k: v - before.get(k, 0) for k, v in K.launches.items()
            if v != before.get(k, 0)}


def gate_path(traces: list[bytes], smi: str, device: str = "cuda",
              n_docs: int = N_GATE_DOCS) -> dict:
    """The port's CI checks and the doc-free batch ops on ``device``:

    - (a) ``merge_updates_columnar`` of each of ``n_docs`` traces cut
      into ``N_GATE_PIECES`` updates, ``encode_state_vector_from_update_
      columnar`` of its first update and ``diff_update_columnar`` of the
      merge against that state vector, under ``YTPU_NO_NATIVE_PLAN=1``
      (the Python mirror plans on the segment planner's kernels), held
      byte for byte to the same calls with ``device="cpu"`` and, through
      them, to the CPU core's results (spawned workers cut the traces and
      compute both);
    - (b) ``scripts/torch_check_trace.py``'s ``selftest()`` with its
      defaults (a 3-shard port fleet on the card, backend ``auto``);
    - (c) ``scripts/torch_check_metrics_schema.py``'s ``main([])``;
    - (d) ``scripts/torch_ytpu_cluster.py --shards 2 --smoke`` as a child
      with no ``--backend`` and no ``--device``: exit 0, ``smoke: OK``,
      and its shards' launch counts (the ``launches`` RPC).

    (b), (c) and (d) run beside the workers; (a)'s calls on the card are
    timed alone after them.  Returns the figures, with ``launches_child``
    the launcher's shards' counts."""
    import shutil

    from yjs_tpu_torch.ops import kernels as K

    cpu = device == "cpu"
    fig: dict = {}
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="ytpu-gate-"))
    argv = GATE_LAUNCHER + ["--wal-root", str(root / "wal")]
    if cpu:
        argv += ["--device", "cpu"]
    runs = {"torch_ytpu_cluster --shards 2 --smoke": (argv, ("smoke: OK",))}
    children = _start_children(runs)
    pool = worker_pool(n_docs)
    saved = os.environ.get("YTPU_NO_NATIVE_PLAN")
    try:
        jobs = pool.map_async(_gate_job, traces[:n_docs], chunksize=4)

        # (b) the trace selftest in-process, rooms on the engine
        trace_check = _load_script("torch_check_trace")
        before = dict(K.launches)
        t0 = time.perf_counter()
        rc = trace_check.selftest(device="cpu" if cpu else None)
        fig["t_trace"] = time.perf_counter() - t0
        fig["trace_launches"] = _delta(K, before)
        check(rc == 0, f"torch_check_trace selftest exited {rc}")
        check(cpu or fig["trace_launches"].get("apply_lanes", 0) > 0,
              "the trace selftest's fleet never launched apply_lanes")

        # (c) the metrics-schema check with its defaults
        schema = _load_script("torch_check_metrics_schema")
        t0 = time.perf_counter()
        rc = schema.main(["--device", "cpu"] if cpu else [])
        fig["t_schema"] = time.perf_counter() - t0
        check(rc == 0, f"torch_check_metrics_schema exited {rc}")

        # the workers' cuts and CPU results, then (d)'s child
        t0 = time.perf_counter()
        jobs.wait(GATE_WAIT_S)
        check(jobs.ready(), f"the gate's workers took over {GATE_WAIT_S}s")
        done = jobs.get()
        fig["t_workers_wait"] = time.perf_counter() - t0
        wrong = [(i, w) for i, (_p, _r, w) in enumerate(done) if w]
        check(not wrong, "batch ops on the CPU disagree with the CPU core: "
              f"{wrong[:8]}")
        walls = _finish_children(runs, children)
        child = next(iter(children.values()))
        fig["t_launcher"] = next(iter(walls.values()))
        ok = next(ln for ln in child.out.splitlines()
                  if ln.startswith("smoke: OK"))
        fig["launcher_ok"] = ok
        got = next(ln for ln in child.out.splitlines()
                   if ln.startswith("smoke: launches "))
        fig["launches_child"] = json.loads(got[len("smoke: launches "):])
        check(cpu or fig["launches_child"].get("apply_lanes", 0) > 0,
              "the launcher's shards never launched apply_lanes: " + ok)
        check(cpu or "device=cuda" in child.out,
              "a launcher shard is not on the card: " + child.out[-1500:])

        # (a) the batch ops on the card, timed alone
        os.environ["YTPU_NO_NATIVE_PLAN"] = "1"
        before = dict(K.launches)
        t0 = time.perf_counter()
        got = [_batch_ops(pieces, device) for pieces, _r, _w in done]
        if not cpu:
            torch.cuda.synchronize()
        fig["t_batch_ops"] = time.perf_counter() - t0
        fig["batch_launches"] = _delta(K, before)
        for i, (ours, (_p, theirs, _w)) in enumerate(zip(got, done)):
            for what, a, b in zip(("merge", "state vector", "diff"),
                                  ours, theirs):
                check(a == b, f"doc {i}: the {what} on {device} differs from "
                      "the one with device='cpu'")
        check(cpu or fig["batch_launches"].get("conflict_scan", 0) > 0,
              "the batch ops never launched the per-doc conflict scan")
    finally:
        restore_env("YTPU_NO_NATIVE_PLAN", saved)
        for child in children.values():
            child.kill()
        pool.terminate()
        pool.join()
        shutil.rmtree(root, ignore_errors=True)
    fig["n_docs"] = n_docs
    fig["bytes_in"] = sum(len(u) for p, _r, _w in done for u in p)
    fig["wall"] = time.perf_counter() - t_phase
    rate = n_docs / fig["t_batch_ops"]
    log(f"[gate] batch ops on {device}: {n_docs} docs of {N_GATE_PIECES} "
        f"updates ({fig['bytes_in']} bytes), merge + state vector + diff "
        f"each, {fig['t_batch_ops']:.3f}s = {rate:.1f} docs/s; equal byte "
        "for byte to device='cpu' and, in canonical form, to the CPU core; "
        f"launches {fig['batch_launches']} ({smi})")
    log(f"[gate] torch_check_trace selftest rc 0 in {fig['t_trace']:.1f}s, "
        f"launches {fig['trace_launches']}; torch_check_metrics_schema rc 0 "
        f"in {fig['t_schema']:.1f}s (both beside the workers)")
    log(f"[gate] {' '.join(GATE_LAUNCHER)}: exit 0 in "
        f"{fig['t_launcher']:.1f}s, {ok!r}; its shards' launches "
        f"{ {k: v for k, v in fig['launches_child'].items() if v} }")
    log(f"[gate] workers waited for {fig['t_workers_wait']:.1f}s after (b) "
        f"and (c); phase {fig['wall']:.1f}s ({smi})")
    return fig


def cuda_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    """Mean ms of ``fn()`` over ``n`` calls, from CUDA events, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def obs_off(fn):
    """``fn()`` with ``YTPU_OBS_DISABLED=1`` (the kernel profiler reads it
    on every call), the variable restored afterwards."""
    saved = os.environ.get("YTPU_OBS_DISABLED")
    os.environ["YTPU_OBS_DISABLED"] = "1"
    try:
        return fn()
    finally:
        restore_env("YTPU_OBS_DISABLED", saved)


def host_us(fn, n: int = HOST_SPLIT_CALLS) -> float:
    """Host µs per call of ``fn()`` by ``time.perf_counter`` over ``n``
    calls back to back, after a warm-up call (the calls only enqueue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def host_split(wrapper) -> dict:
    """One call's host time split into its parts, µs each:

    - ``profiler``: the profiled call minus its body with the profiler
      off (``YTPU_OBS_DISABLED=1``; every profiled call inside the body
      is counted here);
    - ``checks_alloc``: the body with ``_cuda._call`` replaced by a no-op
      (checks, allocation, the ctypes argument marshalling);
    - ``guard_stream``: what ``_call`` adds around the entry point, with
      every entry point replaced by a no-op (the device guard and the
      stream lookup);
    - ``ctypes``: the entry points themselves (the ctypes call and the
      kernel launch).

    ``wrapper`` is a zero-argument call of a profiled kernel wrapper.
    With the profiler off the wrapper still reads the variable, which
    ``checks_alloc`` then counts."""
    from yjs_tpu_torch.ops import _cuda

    total = host_us(wrapper)
    body = obs_off(lambda: host_us(wrapper))
    fns, call = _cuda._fns, _cuda._call
    _cuda._fns = {k: (lambda *a: 0) for k in fns}
    try:
        no_entry = obs_off(lambda: host_us(wrapper))
    finally:
        _cuda._fns = fns
    _cuda._call = lambda *a: None
    try:
        no_call = obs_off(lambda: host_us(wrapper))
    finally:
        _cuda._call = call
    return {"total": total, "profiler": total - body,
            "checks_alloc": no_call, "guard_stream": no_entry - no_call,
            "ctypes": body - no_entry}


def graph_ms(fn, n: int = TIMED_LAUNCHES, replays: int = 5) -> float:
    """Mean ms of one call's kernels replayed back to back: ``n`` calls of
    ``fn()`` captured in a CUDA graph, CUDA events around ``replays``
    replays.  No host work lies between the launches, so the card stays
    loaded and its clocks up: a small kernel's own time, for comparing
    two versions of it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * replays)


def device_ms(fn, n: int = TIMED_LAUNCHES, restore=None):
    """Mean device time per call of ``fn()``'s kernels, from
    ``torch.profiler`` (None when the profiler records no device time):
    set beside :func:`cuda_ms`, it separates kernel time from launch
    gaps.  ``restore()``, run before every call, puts back tables the
    kernel writes in place; its device-to-device copies are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if restore is not None:
        restore()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if restore is not None:
                restore()
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and not (restore is not None and e.key.startswith("Memcpy"))
    )
    return us / 1e3 / n if us > 0 else None


def launches_a_call(K, fn) -> dict:
    """The wrappers' launch counts that grow over one call of ``fn()``."""
    before = dict(K.launches)
    fn()
    torch.cuda.synchronize()
    return _delta(K, before)


def kernels_a_call(fn, restore=None, n: int = 5) -> dict | None:
    """The CUDA kernels one call of ``fn()`` launches, by name (the
    template and namespace kept, the parameters cut): a ``torch.profiler``
    trace of ``n`` calls after an untraced warm-up call; ``restore()``
    runs before each call, and copies are left out; PyTorch's own kernels,
    such as the counters' zero fill, are not.  Each count is divided by ``n``.  A trace may lose an
    event, so a count can fall short of the launches, never exceed them.
    None when the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if restore is not None:
        restore()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if restore is not None:
                restore()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Memcpy")):
            continue
        name = e.key.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].removeprefix("void ")[-80:]
        out[name] = out.get(name, 0) + e.count / n
    return out or None


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.long() - b.long()).abs().max().item()) if a.numel() else 0.0


def apply_lanes_bytes(lanes: torch.Tensor, b: int, widths, n1: int, s1: int) -> int:
    """Lanes read once plus one element written per in-bounds target."""
    k_dn, k_sp, k_h, k_d = widths
    v = lanes.long().cpu().numpy()
    cnt = v[: 4 * b].reshape(4, b).sum(axis=1)
    o = 4 * b
    n_dense = int(cnt[0])
    sp = v[o + k_dn : o + k_dn + int(cnt[1])]
    o2 = o + k_dn + 2 * k_sp
    hd = v[o2 : o2 + int(cnt[2])]
    o3 = o2 + 2 * k_h
    dl = v[o3 : o3 + int(cnt[3])]

    def inb(x, n):
        x = np.where(x < 0, x + n, x)
        return int(((x >= 0) & (x < n)).sum())

    return (lanes.nbytes + 4 * (n_dense + inb(sp, n1) + inb(hd, s1))
            + inb(dl, n1))


def cuda_ms_restored(launch, restore, n: int = YATA_TIMED_LAUNCHES) -> float:
    """Mean ms of ``launch()`` over ``n`` calls from CUDA events recorded
    around each launch alone, after a warm-up; ``restore()`` puts the
    tables back before every launch (the kernels write them in place)."""
    restore()
    launch()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n):
        restore()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / n


def once_ms(fn) -> float:
    """ms of one call of ``fn()`` from CUDA events (the plain YATA versions
    take seconds on the card: one timed call after the comparison call)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def yata_bytes(name: str, args, stats) -> int:
    """The bytes the step must move on these inputs: every schedule input
    read once; per integrated item (every seq entry, every deferred level
    lane) one gap read and two link writes (12 B), and for an item whose
    conflict scan visits a row (``scanned``; the rest keep their gap and
    need no statics) its five statics and the splice's link read (24 B);
    per conflict-scan step the visited row's six statics, its link and
    its visit mark read and written (36 B); per level lane slot the gap
    read of a real lane (4 B) and the two link writes every slot makes,
    real or scratch (8 B); per split three link reads or writes and two
    deleted bits (14 B); one byte per delete."""
    splits, sched, dels = args[2], args[3], args[4]
    nbytes = sum(t.nbytes for t in args[2:] if isinstance(t, torch.Tensor))
    real = int((sched[..., 0] >= 0).sum())
    n_splits = int((splits[..., 0] >= 0).sum())
    n_dels = int(((dels >= 0) & (dels < args[1][0].shape[1])).sum())
    steps = int(stats["scan_steps"].sum())
    scanned = int(stats["scanned"].sum())
    if name == "batch_step":
        items = real
    else:
        items = int(stats["deferred"].sum())
        nbytes += 4 * real + 8 * sched[..., 0].numel()
    return (nbytes + 12 * items + 24 * scanned + 36 * steps + 14 * n_splits
            + n_dels)


# the YATA steps' kinds in _cuda.yata_occupancy
YATA_KINDS = {"batch_step": 0, "batch_step_levels": 1,
              "sharded_batch_step": 1, "batch_step_levels_shared": 2}
# the variant each YATA step's main-path input takes on an H100
# (kernels.yata_variant: the smoke's docs of 4097 rows stage nothing, the
# broadcast step's docs of about 1400 rows all but the visit row)
SMOKE_VARIANT = {"batch_step": "global", "batch_step_levels": "global",
                 "sharded_batch_step": "global",
                 "batch_step_levels_shared": "rows"}
# the docs of the variant case, and the rows of its widest docs
N_VARIANT_DOCS = 32
WIDE_DOC_N1 = 16385


def yata_variant_row(name: str, n1: int, s1: int, w: int, dev,
                     want: str | None = None) -> dict:
    """The variant the YATA wrapper ``name`` launched last, for docs of
    ``n1`` (N+1) rows, ``s1`` (S+1) heads and ``w`` fast-flag bytes (0 for
    K5): checked against ``kernels.yata_variant`` on this card and against
    ``want`` (by default :data:`SMOKE_VARIANT`'s), with its staged
    shared-memory bytes, threads a block and blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    from yjs_tpu_torch.ops import _cuda
    from yjs_tpu_torch.ops import kernels as K

    want = want or SMOKE_VARIANT[name]
    variant, smem = K.yata_variant(n1, s1, w, _cuda.smem_optin(dev))
    check(K.last_variant[name] == variant,
          f"{name} launched the {K.last_variant[name]} variant, not {variant}")
    check(variant == want, f"{name} at N+1={n1} S+1={s1} W={w} takes the "
          f"{variant} variant, not {want}")
    threads, blocks = _cuda.yata_occupancy(
        dev, YATA_KINDS[name], K.YATA_VARIANTS.index(variant), smem)
    return {"variant": variant, "smem_bytes": smem, "threads": threads,
            "blocks_per_sm": blocks}


def variant_rows(name: str, statics: dict, dyn, rest) -> list[dict]:
    """K5 or K6 (``name``) against its plain version on the first
    :data:`N_VARIANT_DOCS` docs of its YATA-path input: in each variant,
    forced (``kernels.yata_variant`` replaced for the call; the path takes
    the one its size picks), and widened to :data:`WIDE_DOC_N1` rows with
    the engine's fills (the schedules name rows below the old width) in
    the variant that size picks.  So every instantiation of the step meets
    its plain version on the card.  Its launches here are comparisons and
    count for no path."""
    from yjs_tpu_torch.ops import kernels as K
    from yjs_tpu_torch.ops.engine import _STATIC_COLS

    fn, plain = getattr(K, name), getattr(K, f"{name}_plain")
    b = N_VARIANT_DOCS
    args = [r[:b].contiguous() for r in rest]
    w = 0 if name == "batch_step" else max(1, args[1].shape[2])
    pick = K.yata_variant
    out = []
    for n1, forced in [(dyn[0].shape[1], v) for v in K.YATA_VARIANTS] + [
            (WIDE_DOC_N1, None)]:
        def wide(t, fill, n1=n1):
            o = torch.full((b, n1), fill, dtype=t.dtype, device=t.device)
            o[:, : t.shape[1]] = t[:b]
            return o

        st = {k: wide(statics[k], fill) for k, fill, _dt in _STATIC_COLS}
        tabs = (wide(dyn[0], K.NULL), wide(dyn[1], False),
                dyn[2][:b].clone())
        work = _clone(tabs)

        def restore(work=work, tabs=tabs):
            for a, o in zip(work, tabs):
                a.copy_(o)

        if forced is not None:
            K.yata_variant = lambda n1, s1, w, limit, v=forced: (
                v, K.yata_smem_bytes(n1, s1, w, v))
        try:
            got = fn(st, _clone(tabs), *args)
            info = yata_variant_row(name, n1, tabs[2].shape[1], w,
                                    tabs[0].device, forced or "global")
            ms = cuda_ms_restored(
                lambda st=st, work=work: fn(st, work, *args), restore, 5)
        finally:
            K.yata_variant = pick
        ref = plain(st, _clone(tabs), *args)
        err = max(max_abs_err(g, r) for g, r in zip(got, ref))
        check(err == 0, f"{name} at N+1={n1} in the {info['variant']} "
              "variant differs from its plain version")
        out.append({"N+1": n1, "B": b, "forced": forced is not None,
                    "max_abs_err": err, "ms": ms, **info})
        log(f"[kernels] {name} at N+1={n1} over {b} docs ({info['variant']} "
            f"variant{', forced' if forced else ''}, {info['smem_bytes']} "
            f"shared bytes, {info['blocks_per_sm']} blocks an SM) equals "
            "its plain version")
    return out


def yata_rows(yseen: dict, ylaunches: dict) -> list[dict]:
    """K3, K5 and K6 against their plain versions at the largest input the
    YATA path gave each (tables as they were before that call)."""
    from yjs_tpu_torch.ops import kernels as K

    rows = []
    # scatter_statics at flush 1's full upload
    statics, packed = yseen["scatter_statics"]
    got = K.scatter_statics(_clone(statics), packed)
    ref = K.scatter_statics_plain(_clone(statics), packed)
    err = max(max_abs_err(got[k], ref[k]) for k in K.STATIC_KEYS)
    base = _clone(statics)
    ms = cuda_ms(lambda: K.scatter_statics(base, packed))
    dev_ms = device_ms(lambda: K.scatter_statics(base, packed))
    plain_ms = cuda_ms(lambda: K.scatter_statics_plain(base, packed), 5)
    d, r = packed[0].long(), packed[1].long()

    def library():
        for j, key in enumerate(K.STATIC_KEYS):
            base[key].index_put_((d, r), packed[2 + j])

    library()
    check(all(torch.equal(base[k], ref[k]) for k in K.STATIC_KEYS),
          "index_put_ x6 disagrees with the plain statics scatter")
    lib_ms = cuda_ms(library)
    b, n1 = statics["client_key"].shape
    k = packed.shape[1]
    rows.append({
        "name": "scatter_statics", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/statics.cu",
        "replaces": "yjs_tpu/ops/engine.py:152",
        "shape": f"K={k} B={b} N+1={n1}", "path": "yata",
        "launches": ylaunches["scatter_statics"], "max_abs_err": err,
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": (packed.nbytes + 24 * k) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": lib_ms,
    })

    # batch_step and batch_step_levels at their largest schedule
    for name, plain, source, line in (
        ("batch_step", K.batch_step_plain, "yata.cu", 327),
        ("batch_step_levels", K.batch_step_levels_plain, "yata.cu", 337),
    ):
        statics, dyn, *rest = yseen[name]
        fn = getattr(K, name)
        b, n1 = dyn[0].shape
        got = fn(statics, _clone(dyn), *rest)
        w = 0 if name == "batch_step" else max(1, rest[1].shape[2])
        info = yata_variant_row(name, n1, dyn[2].shape[1], w, dyn[0].device)
        stats = K.new_yata_stats(b, dyn[0].device)
        ref = _clone(dyn)
        plain_ms = once_ms(lambda: plain(statics, ref, *rest, stats=stats))
        err = max(max_abs_err(g, r) for g, r in zip(got, ref))
        work = _clone(dyn)

        def restore(work=work, dyn=dyn):
            for w, o in zip(work, dyn):
                w.copy_(o)

        def launch(fn=fn, statics=statics, work=work, rest=rest):
            fn(statics, work, *rest)

        ms = cuda_ms_restored(launch, restore)
        nbytes = yata_bytes(name, (statics, dyn, *rest), stats)
        chain = int(stats["chain"].max())
        sched = rest[1]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"yjs_tpu_torch/csrc/{source}",
            "replaces": f"yjs_tpu/ops/kernels.py:{line}",
            "shape": f"B={b} N+1={n1} S+1={dyn[2].shape[1]} "
                     f"schedule={tuple(sched.shape)}",
            "path": "yata",
            "launches": ylaunches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            # what limits them is not a roofline bound but the longest
            # per-doc chain of dependent loads (kernels.new_yata_stats):
            # each load's address comes from the one before it, so the
            # chain runs at one memory round trip a load however few
            # bytes move; ns_per_dep_load is the measured time per load
            # (by events, launch included)
            "limited_by": "dep_chain", "dep_chain": chain,
            "ns_per_dep_load": ms * 1e6 / max(1, chain),
            "scan_steps": int(stats["scan_steps"].sum()),
            "scanned": int(stats["scanned"].sum()),
            "deferred": int(stats["deferred"].sum()),
            **info,
            "variants": variant_rows(name, statics, dyn, rest),
        })
    return rows


def host_copy_ms(host: list, outs: list) -> tuple[float, float]:
    """ms of the pageable host-to-device copies of ``host`` (numpy) and
    of the device-to-host copies of ``outs``, as ``kernels._run_padded``
    makes them around a planner kernel, from CUDA events (5 calls each).
    ``outs`` are whole padded outputs; the planner copies back only the
    real lanes, so the D2H time is an upper bound."""
    h2d = cuda_ms(lambda: [torch.from_numpy(a).to("cuda") for a in host], 5)
    d2h = cuda_ms(lambda: [t.cpu() for t in outs], 5)
    return h2d, d2h


def scan_edge_inputs(n: int, tile: int | None):
    """``(cols, doc)``: K12's seven int64 columns and a doc column of
    ``n`` lanes on the card, every lane's origin inside the lane before's
    id range; a new doc at every multiple of ``tile`` (None: one doc, a
    single run through every tile)."""
    g = torch.Generator().manual_seed(12)
    length = torch.randint(1, 5, (n,), generator=g)
    clock = torch.cumsum(length, 0) - length
    client = torch.full((n,), 3)
    o_ck = torch.roll(clock + length - 1, 1)
    cols = (client, clock, length, client, o_ck, torch.full((n,), -1),
            torch.zeros(n, dtype=torch.int64))
    doc = torch.arange(n) // tile if tile else torch.zeros(n, dtype=torch.int64)
    return ([c.to(torch.int64).to("cuda") for c in cols],
            doc.to(torch.int64).to("cuda"))


def planner_rows(plseen: dict, pl_launches: dict) -> list[dict]:
    """K12 (chunk and per doc) and K11 against their plain versions at
    the largest input the planner path gave each, with the copies around
    them; K12 also on a doc at every tile edge and on one run through
    2**20 lanes, and with its kernels a call, host split and graph
    replay time."""
    from yjs_tpu_torch.ops import _cuda
    from yjs_tpu_torch.ops import kernels as K

    rows = []
    tile = _cuda.SCAN_THREADS * _cuda.SCAN_LANES
    edges = scan_edge_inputs(3 * tile + 1, tile)
    chained = scan_edge_inputs(1 << 20, None)
    for name, line in (("conflict_scan_chunk", 604), ("conflict_scan", 548)):
        args = plseen[name]
        cols, doc = args[:7], (args[7] if len(args) > 7 else None)
        err = 0.0
        # the planner's captured input, then a doc at every tile edge and
        # one run through 2**20 lanes, in this row's form
        for c, d in ((cols, doc), edges, chained):
            d = d if name == "conflict_scan_chunk" else None
            got = K.conflict_scan(*c, d)
            ref = K.conflict_scan_plain(*c, d)
            err = max(err, *(max_abs_err(g, r) for g, r in zip(got, ref)))
        check(err == 0, f"K12 {name} differs from its plain version")

        def call():
            return K.conflict_scan(*cols, doc)

        got = call()
        # a trace may lose an event (a count falls short, never over) or
        # record none: traced again then
        for _ in range(5):
            a_call = kernels_a_call(call, n=20)
            if a_call is not None:
                break
        check(a_call is not None and len(a_call) == 1
              and "conflict_scan_kernel" in next(iter(a_call))
              and 0 < next(iter(a_call.values())) <= 1,
              f"K12 {name} launched {a_call} a call, not one kernel")
        ms = cuda_ms(call)
        ms_obs_off = obs_off(lambda: cuda_ms(call))
        split = host_split(call)
        g_ms = graph_ms(call)
        dev_ms = device_ms(call)
        plain_ms = cuda_ms(lambda: K.conflict_scan_plain(*cols, doc), 5)
        ins = [t for t in args if t is not None]
        h2d, d2h = host_copy_ms([t.cpu().numpy() for t in ins], list(got))
        n = cols[0].numel()
        nbytes = sum(t.nbytes for t in ins) + sum(t.nbytes for t in got)
        rows.append({
            "name": name, "route": "cuda",
            "source": "yjs_tpu_torch/csrc/conflict_scan.cu",
            "replaces": f"yjs_tpu/ops/kernels.py:{line}",
            "shape": f"lanes={n} columns={len(ins)} int64; checked also "
                     f"at {3 * tile + 1} lanes (a doc at every tile edge) "
                     "and 1048576 (one run)",
            "path": "planner", "launches": pl_launches[name],
            "max_abs_err": err, "kernels_a_call": a_call,
            "lanes_a_thread": _cuda.SCAN_LANES, "tiles": _cuda.scan_tiles(n),
            "ms": ms, "ms_obs_off": ms_obs_off, "host_us": split,
            "graph_ms": g_ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "h2d_ms": h2d, "d2h_ms": d2h,
        })

    flat, q = plseen["anchor_lookup"]
    got = K.anchor_lookup(flat, q)
    ref = K.anchor_lookup_plain(flat, q)
    err = max_abs_err(got, ref)
    ms = cuda_ms(lambda: K.anchor_lookup(flat, q))
    ms_obs_off = obs_off(lambda: cuda_ms(lambda: K.anchor_lookup(flat, q)))
    split = host_split(lambda: K.anchor_lookup(flat, q))
    dev_ms = device_ms(lambda: K.anchor_lookup(flat, q))
    # the same launch with the shared-memory sample staged and not staged
    unstaged = torch.empty_like(q)
    desc = [flat.data_ptr(), flat.numel(), q.data_ptr(), unstaged.data_ptr(),
            q.numel()]

    def launch(stage_min):
        return lambda: _cuda.anchor_lookup(desc, q.device, stage_min)

    launch(1 << 62)()
    check(torch.equal(unstaged, ref), "K11 unstaged differs from its plain version")
    # replayed from a graph, in turns (staged, unstaged, unstaged,
    # staged): launched one by one from the host the card idles between
    # kernels of a few µs, and its clocks follow its load
    order = (_cuda.LOOKUP_STAGE_MIN, 1 << 62, 1 << 62, _cuda.LOOKUP_STAGE_MIN)
    turns = [graph_ms(launch(m)) for m in order]
    staging = {"graph_ms_staged": [turns[0], turns[3]],
               "graph_ms_unstaged": [turns[1], turns[2]]}
    plain_ms = cuda_ms(lambda: K.anchor_lookup_plain(flat, q), 5)

    def library():
        return torch.searchsorted(flat, q, right=True) - 1

    check(torch.equal(library(), ref), "torch.searchsorted disagrees with K11's plain version")
    lib_ms = cuda_ms(library)
    h2d, d2h = host_copy_ms([flat.cpu().numpy(), q.cpu().numpy()], [got])
    rows.append({
        "name": "anchor_lookup", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/anchor_lookup.cu",
        "replaces": "yjs_tpu/ops/kernels.py:531",
        "shape": f"haystack={flat.numel()} queries={q.numel()} int64",
        "path": "planner", "launches": pl_launches["anchor_lookup"],
        "max_abs_err": err, "ms": ms, "ms_obs_off": ms_obs_off,
        "host_us": split, "device_ms": dev_ms, **staging, "plain_ms": plain_ms,
        "bound_ms": lookup_bytes(flat, q) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": lib_ms, "h2d_ms": h2d, "d2h_ms": d2h,
    })
    return rows


def lookup_bytes(flat: torch.Tensor, q: torch.Tensor) -> int:
    """The bytes these searches need: each query read and each answer
    written once (8 B each), and each haystack entry that some search
    visits read once (the rest of the haystack is never touched)."""
    hay, keys = flat.cpu().numpy(), q.cpu().numpy()
    lo = np.zeros(len(keys), np.int64)
    hi = np.full(len(keys), len(hay), np.int64)
    seen = []
    while True:
        act = lo < hi
        if not act.any():
            break
        mid = lo + ((hi - lo) >> 1)
        seen.append(mid[act])
        go = act & (hay[np.minimum(mid, max(0, len(hay) - 1))] <= keys)
        lo = np.where(go, mid + 1, lo)
        hi = np.where(act & ~go, mid, hi)
    visited = np.unique(np.concatenate(seen)).size if seen else 0
    return 16 * len(keys) + 8 * visited


def shared_lane_writes(lanes: torch.Tensor, k_l: int, k_h: int, n1: int,
                       s1: int) -> tuple[int, int, int]:
    """In-bounds link, head and delete targets of one shared delta (after
    the wrap of negative indices), each written once per doc."""
    v = lanes.long().cpu().numpy()

    def inb(x, n):
        x = np.where(x < 0, x + n, x)
        return int(((x >= 0) & (x < n)).sum())

    return (inb(v[:k_l], n1), inb(v[2 * k_l : 2 * k_l + k_h], s1),
            inb(v[2 * k_l + 2 * k_h :], n1))


def shared_index_put(lanes: torch.Tensor, k_l: int, k_h: int, n1: int,
                     s1: int):
    """K7a's library yardstick: ``index_put_`` x3 (``right[:, rows] =
    vals``, ``starts[:, segs] = hvals``, ``deleted[:, dels] = True``) on
    the in-bound lanes of one shared delta, filtered (negative targets
    wrapped) once here, outside the timed call.  Returns ``put(dyn)``."""
    host = lanes.long().cpu().numpy()
    o = 2 * k_l + 2 * k_h

    def inb(x, n):
        x = np.where(x < 0, x + n, x)
        keep = (x >= 0) & (x < n)
        return (torch.from_numpy(x[keep]).to(lanes.device),
                torch.from_numpy(keep).to(lanes.device))

    rows, keep = inb(host[:k_l], n1)
    vals = lanes[k_l : 2 * k_l][keep]
    segs, hkeep = inb(host[2 * k_l : 2 * k_l + k_h], s1)
    hvals = lanes[2 * k_l + k_h : o][hkeep]
    dels, _ = inb(host[o:], n1)

    def put(dyn):
        dyn[0][:, rows] = vals
        dyn[2][:, segs] = hvals
        dyn[1][:, dels] = True
        return dyn

    return put


def one_kernel_a_call(call, kernel: str, name: str):
    """The kernels one ``call()`` launches by the profiler (traced again
    when a trace records none), checked to be ``kernel`` alone, at most
    once (a trace may lose an event, never add one)."""
    for _ in range(5):
        a_call = kernels_a_call(call, n=20)
        if a_call is not None:
            break
    check(a_call is not None and len(a_call) == 1
          and kernel in next(iter(a_call))
          and 0 < next(iter(a_call.values())) <= 1,
          f"{name} launched {a_call} a call, not one kernel")
    return a_call


def shared_row(fresh, lanes, k_l: int, k_h: int, k_d: int, b: int,
               b_check: int, launches: int, path: str, name: str) -> dict:
    """K7a against its plain version on ``b_check`` fresh docs, and its
    times over ``b`` docs: events, device, plain, ``index_put_`` x3,
    host split, kernels and launches a call (checked: one)."""
    from yjs_tpu_torch.ops import kernels as K

    got = K.apply_plan_shared(fresh(b_check), lanes, k_l, k_h, k_d)
    ref = K.apply_plan_shared_plain(fresh(b_check), lanes, k_l, k_h, k_d)
    err = max(max_abs_err(g, r) for g, r in zip(got, ref))
    base = fresh(b)
    n1, s1 = base[0].shape[1], base[2].shape[1]
    put = shared_index_put(lanes, k_l, k_h, n1, s1)
    lib = put(fresh(b_check))
    check(all(torch.equal(x, r) for x, r in zip(lib, ref)),
          f"{name}: index_put_ x3 disagrees with the plain version")
    del got, ref, lib

    def call():
        return K.apply_plan_shared(base, lanes, k_l, k_h, k_d)

    a_launch = launches_a_call(K, call)
    check(a_launch == {"apply_plan_shared": 1},
          f"{name}: launches {a_launch} in one call")
    a_call = one_kernel_a_call(call, "apply_shared_kernel", name)
    w_l, w_h, w_d = shared_lane_writes(lanes, k_l, k_h, n1, s1)
    return {
        "name": name, "route": "cuda",
        "source": "yjs_tpu_torch/csrc/apply_shared.cu",
        "replaces": "yjs_tpu/ops/kernels.py:449",
        "shape": f"B={b} N+1={n1} S+1={s1} lanes={lanes.numel()} "
                 f"({k_l}, {k_h}, {k_d}) shared, in bounds ({w_l}, {w_h}, "
                 f"{w_d}); checked at B={b_check}",
        "path": path, "launches": launches, "max_abs_err": err,
        "launches_a_call": a_launch, "kernels_a_call": a_call,
        "docs_a_block": K.shared_docs_a_block(
            b, n1, k_l, k_h, k_d, torch.cuda.get_device_properties(
                base[0].device).multi_processor_count),
        "ms": cuda_ms(call), "device_ms": device_ms(call),
        "plain_ms": cuda_ms(
            lambda: K.apply_plan_shared_plain(base, lanes, k_l, k_h, k_d), 3),
        "host_us": host_split(call),
        "bound_ms": (lanes.nbytes + b * (4 * w_l + 4 * w_h + w_d))
        / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": cuda_ms(lambda: put(base)),
    }


def broadcast_rows(bfig: dict, b_launches: dict, b4fig: dict,
                   b4_launches: dict) -> list[dict]:
    """K7a and K7b against their plain versions at the broadcast path's
    4096-doc fan-out, each timed beside K1 or K6 on its inputs replicated
    per doc (``replicated_ms``; K7a's ``replicated_device_ms`` too), and
    K7a at the B4 replay's 16384 docs (``apply_plan_shared_b4``)."""
    from yjs_tpu_torch.ops import kernels as K

    rows = []
    tables, lanes, k_l, k_h, k_d = bfig["apply_plan_shared"]
    b = tables[0].shape[0]
    row = shared_row(lambda docs: tuple(t[:docs].clone() for t in tables),
                     lanes, k_l, k_h, k_d, b, b,
                     b_launches["apply_plan_shared"], "broadcast",
                     "apply_plan_shared")
    # K1 on the same delta replicated per doc, the unshared yardstick
    rtables, rlanes, *rwidths = bfig["apply_lanes_replicated"]
    rbase = _clone(rtables)
    row["replicated_ms"] = cuda_ms(lambda: K.apply_lanes(rbase, rlanes, *rwidths))
    row["replicated_device_ms"] = device_ms(
        lambda: K.apply_lanes(rbase, rlanes, *rwidths))
    rows.append(row)
    # the B4 replay: held at N_B4_CHECKED docs, timed at N_B4_DOCS
    fresh, lanes, k_l, k_h, k_d = b4fig["apply_plan_shared"]
    rows.append(shared_row(fresh, lanes, k_l, k_h, k_d, N_B4_DOCS,
                           N_B4_CHECKED, b4_launches["apply_plan_shared"],
                           "b4", "apply_plan_shared_b4"))
    torch.cuda.empty_cache()

    statics, dyn, splits, lv, dels, scratch = bfig["batch_step_levels_shared"]
    b, n1 = dyn[0].shape
    got = K.batch_step_levels_shared(statics, _clone(dyn), splits, lv, dels,
                                     scratch)
    info = yata_variant_row("batch_step_levels_shared", n1, dyn[2].shape[1],
                            max(1, lv.shape[1]), dyn[0].device)
    stats = K.new_yata_stats(b, dyn[0].device)
    ref = _clone(dyn)
    plain_ms = once_ms(lambda: K.batch_step_levels_shared_plain(
        statics, ref, splits, lv, dels, scratch, stats=stats))
    err = max(max_abs_err(g, r) for g, r in zip(got, ref))
    work = _clone(dyn)

    def restore():
        for w, o in zip(work, dyn):
            w.copy_(o)

    def launch():
        K.batch_step_levels_shared(statics, work, splits, lv, dels, scratch)

    ms = cuda_ms_restored(launch, restore)
    # K6 on the same plan replicated per doc, the unshared yardstick
    rstatics, rdyn, *rrest = bfig["batch_step_levels_replicated"]
    rwork = _clone(rdyn)

    def rrestore():
        for w, o in zip(rwork, rdyn):
            w.copy_(o)

    def rlaunch():
        K.batch_step_levels(rstatics, rwork, *rrest)

    rep_ms = cuda_ms_restored(rlaunch, rrestore)
    # the shared inputs once; per doc each real lane's gap read (4 B) and
    # every lane slot's two link writes (8 B), each split (14 B) and
    # delete (1 B); per integrated item, scanned item and scan step what
    # yata_bytes charges
    real = int((lv[..., 0] >= 0).sum())
    n_splits = int((splits[:, 0] >= 0).sum())
    n_dels = int(((dels >= 0) & (dels < n1)).sum())
    nbytes = (sum(v.nbytes for v in statics.values()) + splits.nbytes
              + lv.nbytes + dels.nbytes + scratch.nbytes
              + b * (4 * real + 8 * lv[..., 0].numel() + 14 * n_splits + n_dels)
              + 12 * int(stats["deferred"].sum())
              + 24 * int(stats["scanned"].sum())
              + 36 * int(stats["scan_steps"].sum()))
    chain = int(stats["chain"].max())
    rows.append({
        "name": "batch_step_levels_shared", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/yata.cu",
        "replaces": "yjs_tpu/ops/kernels.py:350",
        "shape": f"B={b} N+1={n1} S+1={dyn[2].shape[1]} "
                 f"schedule={tuple(lv.shape)} shared",
        "path": "broadcast",
        "launches": b_launches["batch_step_levels_shared"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "limited_by": "dep_chain", "dep_chain": chain,
        "ns_per_dep_load": ms * 1e6 / max(1, chain),
        "scan_steps": int(stats["scan_steps"].sum()),
        "scanned": int(stats["scanned"].sum()),
        "deferred": int(stats["deferred"].sum()),
        "replicated_ms": rep_ms, **info,
    })
    return rows


def kernel_phase(seen: dict, launches: dict, pseen: dict,
                 plaunches: dict, yseen: dict, ylaunches: dict,
                 plseen: dict, pl_launches: dict, bfig: dict,
                 b_launches: dict, b4fig: dict, b4_launches: dict,
                 mfig: dict, m_launches: dict) -> list[dict]:
    """Each kernel against its plain version on the largest input its
    path gave it (tables as they were before that call); ``launches`` and
    ``plaunches`` are the main and the provider path's counts."""
    from yjs_tpu_torch.ops import kernels as K

    rows = []
    saved = dict(K.launches)

    # apply_lanes at flush 1's shapes
    tables, lanes, *widths = seen["apply_lanes"]
    b, n1 = tables[0].shape
    s1 = tables[2].shape[1]

    def fresh():
        return tuple(t.clone() for t in tables)

    got = K.apply_lanes(fresh(), lanes, *widths)
    ref = K.apply_lanes_plain(fresh(), lanes, *widths)
    err = max(max_abs_err(g, r) for g, r in zip(got, ref))
    base = fresh()

    def k1():
        return K.apply_lanes(base, lanes, *widths)

    ms = cuda_ms(k1)
    dev_ms = device_ms(k1)
    plain_ms = cuda_ms(lambda: K.apply_lanes_plain(base, lanes, *widths))
    nbytes = apply_lanes_bytes(lanes, b, widths, n1, s1)
    rows.append({
        "name": "apply_lanes", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/apply_lanes.cu",
        "replaces": "yjs_tpu/ops/kernels.py:406",
        "shape": f"B={b} N+1={n1} S+1={s1} lanes={lanes.numel()} {lanes.dtype}",
        "launches": launches["apply_lanes"], "max_abs_err": err,
        "variant": K.last_variant["apply_lanes"],
        "launches_a_call": launches_a_call(K, k1),
        "kernels_a_call": kernels_a_call(k1),
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "host_us": host_split(k1),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    })
    # one launch a call: the wrapper's count over one call is the proof; a
    # trace may lose a kernel's event but never adds one
    row = rows[-1]
    check(row["launches_a_call"] == {"apply_lanes": 1},
          f"apply_lanes: launches {row['launches_a_call']} in one call")
    traced = {k: v for k, v in (row["kernels_a_call"] or {}).items()
              if k.startswith("apply_lanes_kernel")}
    check(all(v <= 1 for v in traced.values()),
          f"apply_lanes: the trace shows {traced} in one call")

    # scatter_rows at the compaction's shapes
    *tables, idx, new_right, new_deleted, new_starts = seen["scatter_rows"]
    new = (idx, new_right, new_deleted, new_starts)
    b, n1 = tables[0].shape
    s1 = tables[2].shape[1]
    got = K.scatter_rows(*fresh(), *new)
    ref = K.scatter_rows_plain(*fresh(), *new)
    err = max(max_abs_err(g, r) for g, r in zip(got, ref))
    base = fresh()
    ms = cuda_ms(lambda: K.scatter_rows(*base, *new))
    dev_ms = device_ms(lambda: K.scatter_rows(*base, *new))
    plain_ms = cuda_ms(lambda: K.scatter_rows_plain(*base, *new))
    split = host_split(lambda: K.scatter_rows(*base, *new))
    idx64 = idx.long()

    def library():
        base[0].index_copy_(0, idx64, new_right)
        base[1].index_copy_(0, idx64, new_deleted)
        base[2].index_copy_(0, idx64, new_starts)

    lib_ms = cuda_ms(library)
    k = idx.numel()
    nbytes = idx.nbytes + 2 * (new_right.nbytes + new_deleted.nbytes
                               + new_starts.nbytes)
    rows.append({
        "name": "scatter_rows", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/scatter_rows.cu",
        "replaces": "yjs_tpu/ops/kernels.py:479",
        "shape": f"k={k} B={b} N+1={n1} S+1={s1}",
        "launches": launches["scatter_rows"], "max_abs_err": err,
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "host_us": split,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": lib_ms,
    })

    # list_ranks at the export's shapes (one doc row), with the rounds it
    # ran, its variant (staged in shared memory at this width: checked) and
    # the floor under any one-launch call: an empty kernel's events and
    # device time through the same ctypes path
    from yjs_tpu_torch.ops import _cuda

    right1, valid1 = seen["list_ranks"]
    n1 = right1.shape[1]
    ran = torch.zeros(1, dtype=torch.int32, device=right1.device)
    ran_plain = torch.zeros_like(ran)
    got = K.list_ranks(right1, valid1, ran)
    ref = K.list_ranks_plain(right1, valid1, ran_plain)
    err = max(max_abs_err(got, ref), max_abs_err(ran, ran_plain))
    variant = K.last_variant["list_ranks"]
    check(variant == "staged",
          f"list_ranks at N+1={n1} ran {variant}, not staged")
    ms = cuda_ms(lambda: K.list_ranks(right1, valid1))
    dev_ms = device_ms(lambda: K.list_ranks(right1, valid1))
    plain_ms = cuda_ms(lambda: K.list_ranks_plain(right1, valid1))
    nbytes = right1.nbytes + valid1.nbytes + right1.nbytes
    rows.append({
        "name": "list_ranks", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/list_ranks.cu",
        "replaces": "yjs_tpu/ops/kernels.py:674",
        "shape": f"b={right1.shape[0]} N+1={n1}",
        "launches": launches["list_ranks"], "max_abs_err": err,
        "variant": variant, "rounds": int(ran.item()),
        "max_rounds": K._n_rounds(n1),
        "smem_bytes": K.LIST_RANKS_ROW_BYTES * n1,
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "host_us": host_split(lambda: K.list_ranks(right1, valid1)),
        "floor_ms": cuda_ms(lambda: _cuda.empty_launch(right1.device)),
        "floor_device_ms": device_ms(
            lambda: _cuda.empty_launch(right1.device)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    })
    for row in rows:
        row["path"] = "main"

    # state_vector_kernel at the fleet's state vectors (B = all rooms)
    row_slot, row_end, n_slots = pseen["state_vector_kernel"]
    b, n = row_slot.shape
    got = K.state_vector_kernel(row_slot, row_end, n_slots)
    ref = K.state_vector_kernel_plain(row_slot, row_end, n_slots)
    err = max_abs_err(got, ref)
    ms = cuda_ms(lambda: K.state_vector_kernel(row_slot, row_end, n_slots))
    dev_ms = device_ms(lambda: K.state_vector_kernel(row_slot, row_end, n_slots))
    plain_ms = cuda_ms(
        lambda: K.state_vector_kernel_plain(row_slot, row_end, n_slots)
    )
    # the library call: one scatter_reduce_ "amax" into a zero buffer,
    # out-of-range slots sent to an extra column beforehand
    seg = torch.where((row_slot >= 0) & (row_slot < n_slots), row_slot,
                      torch.full_like(row_slot, n_slots)).long()

    def library():
        return torch.zeros((b, n_slots + 1), dtype=torch.int32,
                           device=row_slot.device).scatter_reduce_(
            1, seg, row_end, "amax", include_self=True)

    check(torch.equal(library()[:, :n_slots], ref),
          "scatter_reduce_ disagrees with the plain state vectors")
    lib_ms = cuda_ms(library)
    nbytes = row_slot.nbytes + row_end.nbytes + got.nbytes
    rows.append({
        "name": "state_vector", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/state_vector.cu",
        "replaces": "yjs_tpu/ops/kernels.py:705",
        "shape": f"B={b} N={n} n_slots={n_slots}", "path": "provider",
        "launches": plaunches["state_vector"], "max_abs_err": err,
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": lib_ms,
    })

    # diff_mask_kernel at the reconnect storm's shapes
    row_slot, row_clock, row_end, sv = args = pseen["diff_mask_kernel"]
    b, n = row_slot.shape
    got = K.diff_mask_kernel(*args)
    ref = K.diff_mask_kernel_plain(*args)
    err = max(max_abs_err(g, r) for g, r in zip(got, ref))

    def k10():
        return K.diff_mask_kernel(*args)

    a_launch = launches_a_call(K, k10)
    check(a_launch == {"diff_mask": 1}, f"diff_mask: launches {a_launch} in one call")
    a_call = one_kernel_a_call(k10, "diff_mask_kernel", "diff_mask")
    ms = cuda_ms(k10)
    dev_ms = device_ms(k10)
    plain_ms = cuda_ms(lambda: K.diff_mask_kernel_plain(*args))
    # row_clock is read only where a row is needed
    ins = row_slot.nbytes + row_end.nbytes + sv.nbytes
    outs = got[0].nbytes + got[1].nbytes
    needed = int(got[0].sum())
    rows.append({
        "name": "diff_mask", "route": "cuda",
        "source": "yjs_tpu_torch/csrc/diff_mask.cu",
        "replaces": "yjs_tpu/ops/kernels.py:724",
        "shape": f"B={b} N={n} n_slots={sv.shape[1]} needed rows={needed}",
        "path": "provider",
        "launches": plaunches["diff_mask"], "max_abs_err": err,
        "launches_a_call": a_launch, "kernels_a_call": a_call,
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "host_us": host_split(k10),
        "bound_ms": (ins + 4 * needed + outs) / HBM_BYTES_PER_S * 1e3,
        "bound_ms_all_read": (ins + row_clock.nbytes + outs)
        / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
    })
    rows.extend(yata_rows(yseen, ylaunches))
    rows.extend(planner_rows(plseen, pl_launches))
    rows.extend(broadcast_rows(bfig, b_launches, b4fig, b4_launches))
    rows.extend(mesh_rows(mfig, m_launches, plseen))
    torch.cuda.synchronize()
    # comparison and timing launches are not the main path's
    K.launches.update(saved)
    for row in rows:
        check(row["launches"] > 0,
              f"{row['name']} never launched on its path ({row['path']})")
        check(row["max_abs_err"] == 0, f"{row['name']} differs from its plain version")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "yjs_tpu_torch").is_dir() or not FIXTURE.exists():
        print("chip_smoke: run from the root of a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from yjs_tpu_torch.ops import kernels as K

    dev = device_phase()
    build_phase()
    import yjs_tpu_torch as Y

    traces = load_traces()
    edits = seeded_edits(Y, traces)
    warm_up(traces[0])
    K.reset_launches()
    t0 = time.perf_counter()
    with Capture(K, MAIN_KERNELS) as cap:
        figures = main_path("cuda", N_DOCS, traces, edits)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    log(f"[main] wall {time.perf_counter() - t0:.1f}s; launches {launches}")
    for name in ("flush1", "flush2"):
        log(f"[main] {name} metrics " + json.dumps(figures[name], sort_keys=True))
    log(f"[main] flush 2: realloc_bytes {figures['flush2']['realloc_bytes']} "
        f"flush_donated {figures['flush2']['flush_donated']} "
        f"compacted {figures['n_compacted']} docs")
    log(f"[main] table bytes {figures['table_bytes']}")
    rate = figures["elements"] / figures["t_flush1_s"]
    log(f"[main] flush 1: {figures['elements']} elements in "
        f"{figures['t_flush1_s']:.3f}s = {rate:.0f} elements/s; flush 2 "
        f"{figures['t_flush2_s']:.3f}s ({dev['smi']})")

    # the provider path, with the device sync branch on for the phase
    saved_env = os.environ.get("YTPU_SYNC_DEVICE")
    os.environ["YTPU_SYNC_DEVICE"] = "1"
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        with Capture(K, PROVIDER_KERNELS) as pcap:
            times = provider_path(N_DOCS, traces, edits)
        torch.cuda.synchronize()
    finally:
        if saved_env is None:
            del os.environ["YTPU_SYNC_DEVICE"]
        else:
            os.environ["YTPU_SYNC_DEVICE"] = saved_env
    plaunches = dict(K.launches)
    log(f"[provider] wall {time.perf_counter() - t0:.1f}s; launches {plaunches}")
    for name in ("apply_lanes", "state_vector", "diff_mask"):
        check(plaunches[name] > 0, f"{name} never launched on the provider path")
    st = {k: times[f"storm_{k}"] for k in ("columns", "h2d", "kernel", "step2")}
    encode = st["step2"] - st["columns"] - st["h2d"] - st["kernel"]
    log(f"[provider] host s ({dev['smi']}): ingest {times['ingest']:.3f}, "
        f"flush 1 {times['flush1']:.3f}, flush 2 {times['flush2']:.3f}")
    log(f"[provider] storm of {times['n_replies']} step-1 messages "
        f"({dev['smi']}): total {times['storm']:.4f}s; _sync_columns build "
        f"{st['columns']:.4f}s; H2D {st['h2d']:.4f}s; kernel "
        f"{st['kernel']:.6f}s; D2H + per-reply encode {encode:.4f}s "
        f"({encode / times['n_replies'] * 1e3:.4f} ms a reply); provider "
        f"decode and framing {times['storm'] - st['step2']:.4f}s")
    log(f"[provider] state_vectors_batched {times['state_vectors']:.4f}s; "
        f"checkpoint wall {times['checkpoint']:.3f}s; recover wall "
        f"{times['recover']:.3f}s, of which replay's validate_update "
        f"{times['recover_validate']:.3f}s ({dev['smi']})")

    # the on-device YATA lanes at the main path's width
    K.reset_launches()
    t0 = time.perf_counter()
    with Capture(K, YATA_KERNELS) as ycap:
        yfig = yata_path(traces, edits, figures["trimmed"], dev["smi"])
    torch.cuda.synchronize()
    ylaunches = dict(K.launches)
    log(f"[yata] wall {time.perf_counter() - t0:.1f}s; launches {ylaunches}")
    for name, _size in YATA_KERNELS:
        check(ylaunches[name] > 0, f"{name} never launched on the YATA path")
    log(f"[yata] CPU twin (plain kernels) flush 1 {yfig['twin1']:.3f}s, "
        f"flush 2 {yfig['twin2']:.3f}s; statics {yfig['statics_bytes']} "
        f"bytes; flush 2 compacted {yfig['n_compacted']} docs")

    # the Python mirror's device cold planner
    K.reset_launches()
    t0 = time.perf_counter()
    with Capture(K, PLANNER_KERNELS) as plcap:
        pfig = planner_path(traces, figures["trimmed"], dev["smi"])
    torch.cuda.synchronize()
    pl_launches = dict(K.launches)
    log(f"[planner] wall {time.perf_counter() - t0:.1f}s; launches {pl_launches}")
    log(f"[planner] {pfig['n_docs']} docs, one per distinct fixture trace "
        f"(of {len(traces)}; a {N_DOCS}-doc fleet of all of them plans a "
        f"chunk {len(traces) // pfig['n_docs']}x this one, its other "
        f"{N_DOCS - len(traces)} docs replaying the plan cache and launching "
        "nothing); bursts of "
        f"{pfig['burst_updates']} updates (set-up) generated by worker "
        "processes after the card's flush 1, waited for "
        f"{pfig['t_bursts']:.1f}s after the twin's; CPU twin flushes, in a "
        "process of their own beside the card's, planned cold on the plain "
        f"kernels, {pfig['twin1']:.3f} (beside the burst workers too) / "
        f"{pfig['twin2']:.3f} / {pfig['twin3']:.3f}s")
    check(pl_launches["conflict_scan_chunk"] >= 2,
          "the chunk conflict scan launched fewer than twice")
    check(pl_launches["anchor_lookup"] >= 1, "the anchor lookup never launched")
    check(pl_launches["conflict_scan"] >= 1,
          "the per-doc conflict scan never launched")

    # broadcast replay: one trace over 4096 docs
    K.reset_launches()
    t0 = time.perf_counter()
    bfig = broadcast_path(traces[0])
    torch.cuda.synchronize()
    b_launches = dict(K.launches)
    log(f"[broadcast] wall {time.perf_counter() - t0:.1f}s; launches {b_launches}")
    for name, _size in BROADCAST_KERNELS:
        check(b_launches[name] == 1, f"{name} did not launch once")

    # the B4 replay: bench.py's headline shape, one K7a call
    K.reset_launches()
    t0 = time.perf_counter()
    b4fig = b4_path()
    torch.cuda.synchronize()
    b4_launches = dict(K.launches)
    log(f"[b4] wall {time.perf_counter() - t0:.1f}s; launches {b4_launches}")
    check(b4_launches["apply_plan_shared"] == 1,
          "the B4 replay did not take one apply_plan_shared launch")

    # the doc-sharded mesh: four shards on the one card
    K.reset_launches()
    t0 = time.perf_counter()
    mfig = mesh_path(traces, edits, figures, yfig.pop("trimmed"), dev["smi"])
    torch.cuda.synchronize()
    m_launches = dict(K.launches)
    log(f"[mesh] wall {time.perf_counter() - t0:.1f}s; launches {m_launches}")
    for name in MESH_LAUNCHED:
        check(m_launches[name] > 0, f"{name} never launched on the mesh path")
    for name in ("trimmed", "log_of", "state_vectors"):
        del figures[name]

    # the fleet, geo replication and the capacity ramp on the card, with
    # the device sync branch on (the fleet's checkpoints take diff_mask)
    service = {}
    saved_env = os.environ.get("YTPU_SYNC_DEVICE")
    os.environ["YTPU_SYNC_DEVICE"] = "1"
    try:
        for name, run in (
            ("fleet", lambda: fleet_path(traces, dev["smi"])),
            ("geo", lambda: geo_path(traces, dev["smi"])),
            ("capacity", lambda: capacity_path(dev["smi"])),
        ):
            K.reset_launches()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            service[name] = dict(K.launches)
            log(f"[{name}] wall {time.perf_counter() - t0:.1f}s; launches "
                f"{service[name]}")
            check(service[name]["apply_lanes"] > 0,
                  f"apply_lanes never launched on the {name} path")
        # the process cluster: its kernels launch in the shard children,
        # each of which counts its own (read over RPC before each kill
        # and at the end)
        t0 = time.perf_counter()
        cfig = cluster_path(traces, dev["smi"])
        service["cluster"] = cfig["launches"]
        log(f"[cluster] wall {time.perf_counter() - t0:.1f}s; the "
            f"children's launches {service['cluster']}")
        check(service["cluster"].get("apply_lanes", 0) > 0,
              "apply_lanes never launched in a cluster shard")
        # peer sessions between two providers on the card
        K.reset_launches()
        t0 = time.perf_counter()
        session_path(traces, dev["smi"])
        torch.cuda.synchronize()
        service["session"] = dict(K.launches)
        log(f"[session] wall {time.perf_counter() - t0:.1f}s; launches "
            f"{service['session']}")
        for name in SESSION_LAUNCHED:
            check(service["session"][name] > 0,
                  f"{name} never launched on the session path")
        idle = sorted(k for k, v in service["session"].items() if v == 0)
        log(f"[session] kernels not launched on this path: {idle} (no "
            "mesh, so no sharded kernel; the YATA, planner and broadcast "
            "kernels serve other lanes)")
    finally:
        restore_env("YTPU_SYNC_DEVICE", saved_env)
    check(service["fleet"]["diff_mask"] > 0,
          "the fleet's checkpoint never launched diff_mask")
    # the port's CI checks and the doc-free batch ops on the card; the
    # launcher child's shards count their own launches
    K.reset_launches()
    t0 = time.perf_counter()
    gfig = gate_path(traces, dev["smi"])
    torch.cuda.synchronize()
    service["gate"] = dict(K.launches)
    for name, n in gfig["launches_child"].items():
        service["gate"][name] = service["gate"].get(name, 0) + int(n)
    log(f"[gate] wall {time.perf_counter() - t0:.1f}s; launches "
        f"{service['gate']} (the launcher's shards' included)")
    rows = kernel_phase(cap.seen, launches, pcap.seen, plaunches, ycap.seen,
                        ylaunches, plcap.seen, pl_launches, bfig, b_launches,
                        b4fig, b4_launches, mfig, m_launches)
    for row in rows:  # each kernel's launches on the service paths
        for name, counts in service.items():
            row[f"launches_{name}"] = counts.get(row["name"], 0)
    log(json.dumps({"kernels": rows}))
    log(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
