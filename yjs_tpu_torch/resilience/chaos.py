"""Deterministic fault injection at the provider/protocol seams.

Models what a hostile transport can do to a CRDT deployment: corrupt,
truncate, duplicate, reorder, and drop — applied to raw update payloads
(``kind="update"``) or framed sync messages (``kind="frame"``).  All
randomness comes from one seeded PRNG, so a chaos test failure replays
byte-for-byte from its seed.

Detectability contract: the injector only produces corruptions that are
REJECTABLE — a corrupted update is verified (and if necessary forced) to
fail :func:`yjs_tpu.updates.validate_update`, and a corrupted frame is
rewritten so the tolerant frame reader rejects or skips it.  A bit flip
that happens to decode as a *different valid update* is a Byzantine
fault no CRDT convergence contract can absorb (garbage-in); real
transports reject it by checksum, so the harness models the
post-checksum world.  Faults applied are counted per kind in the
process-global ``ytpu_chaos_faults_total{fault=...}`` family.

Env knobs (all probabilities in [0, 1], default 0 = fault disabled):
``YTPU_CHAOS_SEED`` (int, default 0), ``YTPU_CHAOS_CORRUPT``,
``YTPU_CHAOS_TRUNCATE``, ``YTPU_CHAOS_DUP``, ``YTPU_CHAOS_REORDER``,
``YTPU_CHAOS_DROP``.
"""

from __future__ import annotations

import os
import random

from ..obs import global_registry
from ..updates import InvalidUpdate, validate_update

_FAULTS = ("corrupt", "truncate", "duplicate", "reorder", "drop")

# 9 continuation bytes splice a ~2**63 count into the leading varint:
# whatever follows, the decoder's struct loop exhausts the buffer and
# raises — the guaranteed-invalid fallback when random flips fail
_POISON_PREFIX = b"\xff" * 9


def _env_float(env, name: str, default: float = 0.0) -> float:
    try:
        return min(1.0, max(0.0, float(env.get(name, default))))
    except (TypeError, ValueError):
        return default


def _env_int(env, name: str, default: int = 0) -> int:
    try:
        return max(0, int(env.get(name, default)))
    except (TypeError, ValueError):
        return default


class ChaosConfig:
    """Per-fault probabilities + PRNG seed."""

    __slots__ = ("seed", "corrupt", "truncate", "duplicate", "reorder", "drop")

    def __init__(
        self,
        seed: int = 0,
        corrupt: float = 0.0,
        truncate: float = 0.0,
        duplicate: float = 0.0,
        reorder: float = 0.0,
        drop: float = 0.0,
    ):
        self.seed = seed
        self.corrupt = corrupt
        self.truncate = truncate
        self.duplicate = duplicate
        self.reorder = reorder
        self.drop = drop

    @classmethod
    def from_env(cls, env=None) -> "ChaosConfig":
        env = os.environ if env is None else env
        try:
            seed = int(env.get("YTPU_CHAOS_SEED", "0"))
        except (TypeError, ValueError):
            seed = 0
        return cls(
            seed=seed,
            corrupt=_env_float(env, "YTPU_CHAOS_CORRUPT"),
            truncate=_env_float(env, "YTPU_CHAOS_TRUNCATE"),
            duplicate=_env_float(env, "YTPU_CHAOS_DUP"),
            reorder=_env_float(env, "YTPU_CHAOS_REORDER"),
            drop=_env_float(env, "YTPU_CHAOS_DROP"),
        )

    def any_faults(self) -> bool:
        return any(
            getattr(self, f) > 0.0
            for f in ("corrupt", "truncate", "duplicate", "reorder", "drop")
        )

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class ChaosInjector:
    """Applies one :class:`ChaosConfig`'s fault mix to message streams.

    ``kind="update"`` treats payloads as raw (V1) update bytes and holds
    corruption to the detectability contract via ``validate_update``;
    ``kind="frame"`` treats them as framed sync messages and corrupts
    the framing itself (unknown message type / inflated length varint),
    which the tolerant ``read_sync_message`` path skips and counts.
    """

    def __init__(self, config: ChaosConfig | None = None, kind: str = "update"):
        if kind not in ("update", "frame"):
            raise ValueError(f"unknown chaos kind {kind!r}")
        self.config = config if config is not None else ChaosConfig.from_env()
        self.kind = kind
        self.rng = random.Random(self.config.seed)
        self.fault_counts: dict[str, int] = {f: 0 for f in _FAULTS}
        fam = global_registry().counter(
            "ytpu_chaos_faults_total",
            "Faults injected by the chaos harness, by fault kind",
            labelnames=("fault",),
        )
        self._children = {f: fam.labels(fault=f) for f in _FAULTS}

    def _hit(self, fault: str) -> None:
        self.fault_counts[fault] += 1
        self._children[fault].inc()

    # -- fault primitives ---------------------------------------------------

    def corrupt(self, payload: bytes) -> bytes:
        """Flip bits until the payload is verifiably rejectable."""
        self._hit("corrupt")
        if self.kind == "frame":
            # rewrite the leading message-type varint to an unknown type
            # (or inflate it): both deterministically un-integratable
            if self.rng.random() < 0.5:
                return b"\x7f" + payload[1:]
            return _POISON_PREFIX + payload
        out = bytearray(payload)
        for _ in range(8):
            if not out:
                break
            i = self.rng.randrange(len(out))
            out[i] ^= 1 << self.rng.randrange(8)
            try:
                validate_update(bytes(out))
            except InvalidUpdate:
                return bytes(out)
        return _POISON_PREFIX + bytes(payload)

    def truncate(self, payload: bytes) -> bytes:
        """Cut the payload short (verified rejectable for updates)."""
        self._hit("truncate")
        if not payload:
            return payload
        for _ in range(8):
            cut = self.rng.randrange(len(payload))
            out = payload[:cut]
            if self.kind == "frame":
                return out
            try:
                validate_update(out)
            except InvalidUpdate:
                return out
        return _POISON_PREFIX + payload

    # -- stream application -------------------------------------------------

    def apply(self, messages: list[bytes]) -> list[bytes]:
        """One fault-mix pass over a message stream.

        Per message: maybe drop, maybe duplicate, maybe corrupt or
        truncate (each delivered copy faulted independently); then maybe
        reorder the whole batch.  Deterministic in (config.seed, input).
        """
        cfg = self.config
        rng = self.rng
        out: list[bytes] = []
        for m in messages:
            if cfg.drop and rng.random() < cfg.drop:
                self._hit("drop")
                continue
            copies = [m]
            if cfg.duplicate and rng.random() < cfg.duplicate:
                self._hit("duplicate")
                copies.append(m)
            for c in copies:
                if cfg.corrupt and rng.random() < cfg.corrupt:
                    c = self.corrupt(c)
                elif cfg.truncate and rng.random() < cfg.truncate:
                    c = self.truncate(c)
                out.append(c)
        if len(out) > 1 and cfg.reorder and rng.random() < cfg.reorder:
            self._hit("reorder")
            rng.shuffle(out)
        return out


class NetChaosConfig:
    """Per-fault probabilities + PRNG seed for the TRANSPORT seam
    (peer sessions).  Distinct from :class:`ChaosConfig`: these faults act on
    whole frames in flight (a lossy datagram link), not on payload
    bytes — nothing here corrupts content, so the session layer's
    ack/retransmit + anti-entropy machinery must heal every mix.

    Env knobs (probabilities in [0, 1], default 0 = disabled):
    ``YTPU_CHAOS_SEED`` plus ``YTPU_CHAOS_NET_DROP``,
    ``YTPU_CHAOS_NET_DELAY``, ``YTPU_CHAOS_NET_DUP``,
    ``YTPU_CHAOS_NET_REORDER``, ``YTPU_CHAOS_NET_PARTITION``.

    The WAN profile adds the shapes a LAN mix can't express:
    ``YTPU_CHAOS_NET_PARTITION_ONEWAY`` (probability of an asymmetric
    partition window: one direction goes dark, the reverse still
    flows), ``YTPU_CHAOS_NET_FLAP_TICKS`` (deterministic link flapping:
    up for 3 N-round windows, down for one, straight off the round
    counter), ``YTPU_CHAOS_NET_RTT_TICKS`` +
    ``YTPU_CHAOS_NET_RTT_JITTER_TICKS`` (per-link propagation delay in
    pump rounds, added to every frame — an RTT distribution, not a
    fault), and ``YTPU_CHAOS_NET_BW_FRAMES`` (per-direction bandwidth
    cap in frames per round; excess frames queue to the next round
    rather than being lost)."""

    __slots__ = ("seed", "drop", "delay", "duplicate", "reorder",
                 "partition", "oneway", "flap_ticks", "rtt_ticks",
                 "rtt_jitter_ticks", "bw_frames")

    def __init__(
        self,
        seed: int = 0,
        drop: float = 0.0,
        delay: float = 0.0,
        duplicate: float = 0.0,
        reorder: float = 0.0,
        partition: float = 0.0,
        oneway: float = 0.0,
        flap_ticks: int = 0,
        rtt_ticks: int = 0,
        rtt_jitter_ticks: int = 0,
        bw_frames: int = 0,
    ):
        self.seed = seed
        self.drop = drop
        self.delay = delay
        self.duplicate = duplicate
        self.reorder = reorder
        self.partition = partition
        self.oneway = oneway
        self.flap_ticks = flap_ticks
        self.rtt_ticks = rtt_ticks
        self.rtt_jitter_ticks = rtt_jitter_ticks
        self.bw_frames = bw_frames

    @classmethod
    def from_env(cls, env=None) -> "NetChaosConfig":
        env = os.environ if env is None else env
        try:
            seed = int(env.get("YTPU_CHAOS_SEED", "0"))
        except (TypeError, ValueError):
            seed = 0
        return cls(
            seed=seed,
            drop=_env_float(env, "YTPU_CHAOS_NET_DROP"),
            delay=_env_float(env, "YTPU_CHAOS_NET_DELAY"),
            duplicate=_env_float(env, "YTPU_CHAOS_NET_DUP"),
            reorder=_env_float(env, "YTPU_CHAOS_NET_REORDER"),
            partition=_env_float(env, "YTPU_CHAOS_NET_PARTITION"),
            oneway=_env_float(env, "YTPU_CHAOS_NET_PARTITION_ONEWAY"),
            flap_ticks=_env_int(env, "YTPU_CHAOS_NET_FLAP_TICKS"),
            rtt_ticks=_env_int(env, "YTPU_CHAOS_NET_RTT_TICKS"),
            rtt_jitter_ticks=_env_int(
                env, "YTPU_CHAOS_NET_RTT_JITTER_TICKS"
            ),
            bw_frames=_env_int(env, "YTPU_CHAOS_NET_BW_FRAMES"),
        )

    def any_faults(self) -> bool:
        return any(
            getattr(self, f) > 0.0
            for f in ("drop", "delay", "duplicate", "reorder", "partition",
                      "oneway", "flap_ticks", "rtt_ticks", "bw_frames")
        )

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class NetworkFaultInjector:
    """Frame-level fault injection for :class:`yjs_tpu.sync.transport.
    PipeNetwork` — the transport seam the session layer must survive.

    Three hooks, all driven by one seeded PRNG (same determinism
    contract as :class:`ChaosInjector`):

    - :meth:`fates` — at enqueue, each frame's delivery plan: a list of
      pump-round delays (one per delivered copy; ``None`` = dropped
      copy).  Applies drop, duplicate, and delay.
    - :meth:`partitioned` — per pump round: while a partition window is
      open the link is down and everything due that round is lost (the
      classic net-split; retransmission must heal it).
    - :meth:`maybe_reorder` — per pump round, maybe shuffle the due
      batch.

    Faults are counted in the process-global ``ytpu_chaos_faults_total``
    family (``net_drop``/``net_delay``/``net_dup``/``net_reorder``/
    ``net_partition``).
    """

    _NET_FAULTS = ("net_drop", "net_delay", "net_dup", "net_reorder",
                   "net_partition", "net_oneway", "net_flap", "net_bw")

    def __init__(self, config: NetChaosConfig | None = None):
        self.config = config if config is not None else NetChaosConfig.from_env()
        self.rng = random.Random(self.config.seed)
        self.fault_counts: dict[str, int] = {f: 0 for f in self._NET_FAULTS}
        self._partition_left = 0
        # one-way partition window: frames TOWARD _oneway_dst
        # are lost while the window is open; the reverse direction (and
        # every other endpoint) keeps flowing — the asymmetric split a
        # symmetric partition can't model
        self._oneway_left = 0
        self._oneway_dst: str | None = None
        # endpoint names registered by PipeNetwork.pair, so the one-way
        # victim is picked deterministically even on idle rounds
        self._links: list[str] = []
        fam = global_registry().counter(
            "ytpu_chaos_faults_total",
            "Faults injected by the chaos harness, by fault kind",
            labelnames=("fault",),
        )
        self._children = {f: fam.labels(fault=f) for f in self._NET_FAULTS}

    def _hit(self, fault: str) -> None:
        self.fault_counts[fault] += 1
        self._children[fault].inc()

    def fates(self, frame: bytes) -> list:
        """Delivery plan for one enqueued frame: delays in pump rounds
        per copy (``None`` entries are dropped copies)."""
        cfg, rng = self.config, self.rng
        if cfg.drop and rng.random() < cfg.drop:
            self._hit("net_drop")
            return [None]
        n_copies = 1
        if cfg.duplicate and rng.random() < cfg.duplicate:
            self._hit("net_dup")
            n_copies = 2
        out = []
        for _ in range(n_copies):
            delay = 0
            if cfg.delay and rng.random() < cfg.delay:
                self._hit("net_delay")
                delay = 1 + rng.randrange(3)
            # WAN propagation: every copy pays the link RTT floor plus
            # per-frame jitter (a latency profile, not a counted fault)
            if cfg.rtt_ticks:
                delay += cfg.rtt_ticks
            if cfg.rtt_jitter_ticks:
                delay += rng.randrange(cfg.rtt_jitter_ticks + 1)
            out.append(delay)
        return out

    def register_link(self, a_name: str, b_name: str) -> None:
        """Called by :meth:`PipeNetwork.pair`: remember the endpoint
        names so one-way partition windows can pick a victim direction
        deterministically."""
        for n in (a_name, b_name):
            if n not in self._links:
                self._links.append(n)

    def _flap_down(self, rnd: int) -> bool:
        """Deterministic link flapping straight off the pump-round
        counter: with ``flap_ticks=N`` the link is up for three N-round
        windows then down for one (75% duty cycle) — replayable from
        the round number alone, no RNG draw."""
        f = self.config.flap_ticks
        return bool(f) and (rnd % (4 * f)) >= 3 * f

    def _tick_oneway(self, due: list) -> None:
        cfg = self.config
        if self._oneway_left > 0:
            self._oneway_left -= 1
            if self._oneway_left == 0:
                self._oneway_dst = None
            return
        if not cfg.oneway or self.rng.random() >= cfg.oneway:
            return
        names = self._links or sorted({e[1].name for e in due})
        if not names:
            return
        self._oneway_dst = names[self.rng.randrange(len(names))]
        self._oneway_left = 1 + self.rng.randrange(4)

    def filter_due(self, due: list, rnd: int) -> tuple[list, list]:
        """Direction-aware WAN shaping for one pump round's due batch.
        One-way partition windows and flap-down windows LOSE frames
        (retransmission must heal them); the per-direction bandwidth
        cap DEFERS excess frames to the next round (queueing delay, not
        loss).  Returns ``(deliver, defer)``."""
        cfg = self.config
        self._tick_oneway(due)
        flap = self._flap_down(rnd)
        deliver: list = []
        defer: list = []
        sent: dict[str, int] = {}
        for e in due:
            name = e[1].name
            if self._oneway_dst is not None and name == self._oneway_dst:
                self._hit("net_oneway")
                continue
            if flap:
                self._hit("net_flap")
                continue
            n = sent.get(name, 0)
            if cfg.bw_frames and n >= cfg.bw_frames:
                self._hit("net_bw")
                defer.append(e)
                continue
            sent[name] = n + 1
            deliver.append(e)
        return deliver, defer

    def partitioned(self) -> bool:
        """Is the link down this pump round?  Partition windows open
        with probability ``partition`` and last 1-4 rounds."""
        if self._partition_left > 0:
            self._partition_left -= 1
            self._hit("net_partition")
            return True
        cfg = self.config
        if cfg.partition and self.rng.random() < cfg.partition:
            self._partition_left = self.rng.randrange(4)
            self._hit("net_partition")
            return True
        return False

    def maybe_reorder(self, batch: list) -> list:
        if self.config.reorder and self.rng.random() < self.config.reorder:
            self._hit("net_reorder")
            batch = list(batch)
            self.rng.shuffle(batch)
        return batch


class DiskFaultInjector:
    """File-level faults for the WAL crash harness.

    Two faults, matching what disks and crashes actually do to a log:
    ``tear`` truncates the final bytes of a file mid-record (the torn
    write a kill leaves on the ACTIVE segment — recovery must truncate
    at the first bad checksum), and ``bitflip`` flips one byte in place
    (at-rest corruption of a SEALED segment — recovery must dead-letter
    the record and resynchronize, never abort).  Same determinism
    contract as :class:`ChaosInjector`: one seeded PRNG, and every
    fault is detectable by construction — any single flipped byte fails
    the record CRC-32.  Counted in the process-global
    ``ytpu_chaos_faults_total`` family (``disk_tear``/``disk_bitflip``).
    """

    _DISK_FAULTS = ("disk_tear", "disk_bitflip")

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.fault_counts: dict[str, int] = {
            f: 0 for f in self._DISK_FAULTS
        }
        fam = global_registry().counter(
            "ytpu_chaos_faults_total",
            "Faults injected by the chaos harness, by fault kind",
            labelnames=("fault",),
        )
        self._children = {f: fam.labels(fault=f) for f in self._DISK_FAULTS}

    def _hit(self, fault: str) -> None:
        self.fault_counts[fault] += 1
        self._children[fault].inc()

    def tear(self, path, max_bytes: int = 64) -> int:
        """Truncate up to ``max_bytes`` off the end of ``path`` (at
        least 1).  Returns the bytes removed (0 if the file is empty)."""
        size = os.path.getsize(path)
        if size <= 1:
            return 0
        cut = self.rng.randrange(1, min(max_bytes, size - 1) + 1)
        os.truncate(path, size - cut)
        self._hit("disk_tear")
        return cut

    def bitflip(self, path, lo: int = 0) -> int:
        """Flip one random bit of one byte at offset >= ``lo`` in
        place.  Returns the flipped offset, or -1 if the file has no
        byte past ``lo``."""
        size = os.path.getsize(path)
        if size <= lo:
            return -1
        off = self.rng.randrange(lo, size)
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ (1 << self.rng.randrange(8))]))
        self._hit("disk_bitflip")
        return off
