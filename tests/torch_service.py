"""Shared pieces of the port's service-stack suites (fleet, replication,
geo, overload, cluster, sessions, resilience, observability): the port's
engines, providers, fleets and cluster shards placed on the CPU, and
the seeded-room helpers the JAX package's fleet suites each define.

``BatchEngine``, ``TpuProvider``, ``FleetRouter``, ``Supervisor`` and
``ShardServer`` here are the port's classes with ``device="cpu"`` as
their default, so every engine and provider a test builds, directly,
through a fleet (constructor,
``add_shard``, ``revive_shard``, ``recover``) or in a shard process,
runs the kernels' plain PyTorch versions.  ``BACKENDS`` are the
provider backends the suites run under: ``"cpu"`` (every doc on the CPU
core) and ``"auto"`` (the engine's apply lane, where the plain
``apply_lanes`` carries every flush).
"""

import random

import yjs_tpu_torch as Y
from yjs_tpu_torch.cluster import Supervisor as _Supervisor
from yjs_tpu_torch.cluster.shard import ShardServer as _ShardServer
from yjs_tpu_torch.fleet import FailoverConfig
from yjs_tpu_torch.fleet import FleetRouter as _FleetRouter
from yjs_tpu_torch.ops import BatchEngine as _BatchEngine
from yjs_tpu_torch.persistence import WalConfig
from yjs_tpu_torch.provider import TpuProvider as _TpuProvider
from yjs_tpu_torch.sync.session import SessionConfig
from yjs_tpu_torch.updates import encode_state_as_update, encode_state_vector

BACKENDS = ("cpu", "auto")

SMALL = WalConfig(segment_bytes=256, fsync="never")
# jitter off + tight thresholds: conviction lands on an exact tick
FAST = FailoverConfig(suspect_ticks=2, confirm_ticks=1, jitter_ticks=0)


class TpuProvider(_TpuProvider):
    """The port's provider, on the CPU unless told otherwise."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)

    @classmethod
    def recover(cls, *args, device="cpu", **kwargs):
        return super().recover(*args, device=device, **kwargs)


class BatchEngine(_BatchEngine):
    """The port's engine, on the CPU unless told otherwise."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


class FleetRouter(_FleetRouter):
    """The port's fleet, every shard on the CPU unless told otherwise."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)

    @classmethod
    def recover(cls, *args, device="cpu", **kwargs):
        return super().recover(*args, device=device, **kwargs)


def quiet_config(**kw):
    base = dict(
        heartbeat=0, liveness=0, antientropy=0, hello_timeout=0,
        retry_base=4, retry_jitter=0.0, seed=1,
    )
    base.update(kw)
    return SessionConfig(**base)


def update_for(text, client_id=99):
    d = Y.Doc(gc=False)
    d.client_id = client_id
    d.get_text("text").insert(0, text)
    return encode_state_as_update(d)


def seeded_rooms(seed, n_rooms, n_ops):
    """room -> (reference Doc, incremental update stream), seeded."""
    out = {}
    for j in range(n_rooms):
        gen = random.Random(seed * 1000 + j)
        d = Y.Doc(gc=False)
        d.client_id = 100 + j
        updates = []
        d.on("update", lambda u, origin, doc: updates.append(bytes(u)))
        t = d.get_text("text")
        for _ in range(n_ops):
            if len(t) and gen.random() < 0.3:
                t.delete(gen.randrange(len(t)), 1)
            else:
                t.insert(gen.randrange(len(t) + 1), gen.choice("abcdef "))
        out[f"room-{j}"] = (d, updates)
    return out


def edit(doc, text, pos=0):
    """One more reference edit, returned as its incremental update."""
    sv = encode_state_vector(doc)
    doc.get_text("text").insert(pos, text)
    return encode_state_as_update(doc, sv)


def canonical(fleet, guid):
    return Y.merge_updates([fleet.encode_state_as_update(guid)])


def canonical_doc(doc):
    return Y.merge_updates([encode_state_as_update(doc)])


def slot_owners(fleet):
    """guid -> [live shards actually holding an engine slot for it]."""
    out = {}
    for k, p in enumerate(fleet.shards):
        if fleet._is_stub(k):
            continue
        for g in p.guids():
            out.setdefault(g, []).append(k)
    return out


def convict(fleet, shard, budget=16):
    """Tick until the detector confirms ``shard`` dead (and the
    coordinator has failed it over)."""
    for _ in range(budget):
        fleet.tick()
        if shard in fleet._down:
            return
    raise AssertionError(f"shard {shard} never convicted")


def crash(fleet):
    """Kill every live shard: no close, no checkpoint, handles dropped."""
    for k, p in enumerate(fleet.shards):
        if not fleet._is_stub(k):
            p.wal.abandon()


class Supervisor(_Supervisor):
    """The port's process cluster, every shard child on the CPU unless
    told otherwise."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


class ShardServer(_ShardServer):
    """The port's in-process shard server, on the CPU unless told
    otherwise."""

    def __init__(self, *args, device="cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)


def load_script(name):
    """A file of ``scripts/`` imported as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_thread_a_child(monkeypatch):
    """Every shard child imports torch: one intra-op thread each keeps a
    few children beside other test workers from oversubscribing cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def wait_outcome(sup, outcome, deadline_s=90.0):
    """The supervisor's recovery report once it counts ``outcome``."""
    import time

    deadline = time.time() + deadline_s
    while time.time() < deadline:
        report = sup.recovery_report()
        if report["outcomes"].get(outcome, 0) >= 1:
            return report
        time.sleep(0.1)
    raise AssertionError(
        f"supervision never reported {outcome!r}: {sup.recovery_report()}"
    )


def live_devices(report):
    """The devices the live shard children of a recovery report took."""
    return {r["device"] for r in report["shards"] if r["state"] == "live"}
