"""Shared pieces of the port's service-stack suites (fleet, replication,
geo, overload): the port's providers and fleets placed on the CPU, and
the seeded-room helpers the JAX package's fleet suites each define.

``TpuProvider`` and ``FleetRouter`` here are the port's classes with
``device="cpu"`` as their default, so every provider a test builds,
directly or through a fleet (constructor, ``add_shard``,
``revive_shard``, ``recover``), runs the kernels' plain PyTorch
versions.  ``BACKENDS`` are the provider backends the suites run under:
``"cpu"`` (every doc on the CPU core) and ``"auto"`` (the engine's
apply lane, where the plain ``apply_lanes`` carries every flush).
"""

import random

import yjs_tpu_torch as Y
from yjs_tpu_torch.fleet import FailoverConfig
from yjs_tpu_torch.fleet import FleetRouter as _FleetRouter
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
