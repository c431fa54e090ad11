"""Per-provider append-only write-ahead log with snapshot compaction.

Layout of a WAL directory (one per provider):

    wal-00000000.log          sealed segment (oldest surviving)
    wal-00000001.log          ...
    wal-00000002.log          active segment (appends go here)
    checkpoint-00000001.snap  newest checkpoint: full per-doc snapshots
                              + the dead-letter-queue dump; covers every
                              segment with index < 1

Appends are length-prefixed CRC-checksummed records (see records.py).
When the active segment passes ``segment_bytes`` it is sealed and a new
one opened.  ``checkpoint()`` folds everything written so far into
per-doc ``encode_state_as_update`` snapshots (the y-leveldb compaction
model: an update log is only a delayed snapshot) and deletes the
covered segments — recovery then replays snapshot-then-tail.

Env knobs (constructor args win over env):

- ``YTPU_WAL_DIR`` — enables journaling for every provider constructed
  without an explicit ``wal_dir``
- ``YTPU_WAL_SEGMENT_BYTES`` — rotation threshold (default 4 MiB)
- ``YTPU_WAL_FSYNC`` — ``always`` (fsync per append: zero-loss, pays a
  disk round trip per update), ``interval`` (default; fsync every
  ``YTPU_WAL_FSYNC_INTERVAL`` appends — bounded loss window, amortized
  cost), ``never`` (flush to the OS only; a host crash may lose the
  page-cache tail, a process crash loses nothing)
- ``YTPU_WAL_FSYNC_INTERVAL`` — appends between fsyncs in ``interval``
  mode (default 64)
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from pathlib import Path

from .records import (
    KIND_DLQ,
    KIND_NAMES,
    KIND_SNAPSHOT,
    SEG_HEADER,
    SNAP_HEADER,
    encode_record,
)

SEGMENT_RE = re.compile(r"wal-(\d{8})\.log$")
CHECKPOINT_RE = re.compile(r"checkpoint-(\d{8})\.snap$")

_FSYNC_MODES = ("always", "interval", "never")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class WalConfig:
    """Rotation + fsync policy (env-derived defaults)."""

    __slots__ = ("segment_bytes", "fsync", "fsync_interval")

    def __init__(
        self,
        segment_bytes: int | None = None,
        fsync: str | None = None,
        fsync_interval: int | None = None,
    ):
        if segment_bytes is None:
            segment_bytes = _env_int("YTPU_WAL_SEGMENT_BYTES", 4 << 20)
        self.segment_bytes = max(1, segment_bytes)
        if fsync is None:
            fsync = os.environ.get("YTPU_WAL_FSYNC", "interval")
        if fsync not in _FSYNC_MODES:
            raise ValueError(
                f"YTPU_WAL_FSYNC must be one of {_FSYNC_MODES}, got {fsync!r}"
            )
        self.fsync = fsync
        if fsync_interval is None:
            fsync_interval = _env_int("YTPU_WAL_FSYNC_INTERVAL", 64)
        self.fsync_interval = max(1, fsync_interval)

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class _Noop:
    def inc(self, amount=1):
        pass

    def observe(self, value):
        pass

    def labels(self, **kw):
        return self


class WalMetrics:
    """The ``ytpu_wal_*`` instrument bundle.

    Registered unconditionally at provider construction (registry=the
    engine's) so exposition and scripts/check_metrics_schema.py see the
    families whether or not a WAL is attached; a standalone
    WriteAheadLog (fixture generator, tests) passes ``registry=None``
    and gets no-ops.
    """

    def __init__(self, registry=None):
        if registry is None:
            noop = _Noop()
            self.records = self.bytes = self.fsyncs = noop
            self.segments = self.compactions = self.reclaimed = noop
            self.recoveries = self.replayed = noop
            self.torn = self.corrupt = self.replay_seconds = noop
            self.append_seconds = self.overflow = noop
            return
        self.records = registry.counter(
            "ytpu_wal_records_appended_total",
            "Records appended to the write-ahead log, by record kind",
            labelnames=("kind",),
        )
        self.bytes = registry.counter(
            "ytpu_wal_bytes_appended_total",
            "Encoded record bytes appended to the write-ahead log",
            unit="bytes",
        )
        self.fsyncs = registry.counter(
            "ytpu_wal_fsyncs_total",
            "fsync calls issued by the write-ahead log",
        )
        self.segments = registry.counter(
            "ytpu_wal_segments_sealed_total",
            "WAL segments sealed (rotation or checkpoint)",
        )
        self.compactions = registry.counter(
            "ytpu_wal_compactions_total",
            "Checkpoints written (sealed segments folded into per-doc "
            "snapshots)",
        )
        self.reclaimed = registry.counter(
            "ytpu_wal_compaction_reclaimed_bytes_total",
            "Segment + stale-checkpoint bytes deleted by compaction",
            unit="bytes",
        )
        self.recoveries = registry.counter(
            "ytpu_wal_recoveries_total",
            "Recovery replays run, by outcome (clean / torn_tail / "
            "corrupt_records / empty)",
            labelnames=("outcome",),
        )
        self.replayed = registry.counter(
            "ytpu_wal_replay_records_total",
            "Records processed during recovery replay, by disposition",
            labelnames=("disposition",),
        )
        self.torn = registry.counter(
            "ytpu_wal_torn_tail_truncations_total",
            "Final-segment torn tails truncated during recovery",
        )
        self.corrupt = registry.counter(
            "ytpu_wal_corrupt_records_total",
            "Mid-log corrupt records found during recovery (routed to "
            "the dead-letter queue)",
        )
        self.replay_seconds = registry.histogram(
            "ytpu_wal_replay_seconds",
            "Wall time of one recovery replay (snapshot + tail)",
            unit="s",
        )
        self.append_seconds = registry.histogram(
            "ytpu_wal_append_seconds",
            "Wall time of one WAL append (encode + write + policy fsync)",
            unit="s",
        )
        self.overflow = registry.counter(
            "ytpu_wal_recovery_overflow_total",
            "Replayed records whose doc could not be admitted "
            "(ProviderFullError) and were routed to the dead-letter "
            "queue with a wal-overflow: reason",
        )


def list_segments(path) -> list[tuple[int, Path]]:
    """(index, path) of every WAL segment in the directory, ascending."""
    out = []
    for p in Path(path).iterdir():
        m = SEGMENT_RE.match(p.name)
        if m:
            out.append((int(m.group(1)), p))
    out.sort()
    return out


def list_checkpoints(path) -> list[tuple[int, Path]]:
    """(upto, path) of every checkpoint file, ascending by coverage."""
    out = []
    for p in Path(path).iterdir():
        m = CHECKPOINT_RE.match(p.name)
        if m:
            out.append((int(m.group(1)), p))
    out.sort()
    return out


class WriteAheadLog:
    """Append-only journal for one provider.

    Existing segments in the directory are treated as sealed history
    (recovery reads them; this writer never touches their contents) —
    appends always start a NEW segment, so a crashed predecessor's torn
    tail can be truncated by recovery without racing the live writer.
    """

    def __init__(self, path, config: WalConfig | None = None, metrics=None,
                 tracer=None):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.config = config if config is not None else WalConfig()
        self.metrics = metrics if metrics is not None else WalMetrics(None)
        # optional host tracer (yjs_tpu_torch.obs.Tracer): journal latency
        # becomes a span inside the provider's receive/flush timeline
        self._tracer = tracer
        existing = list_segments(self.dir)
        ckpts = list_checkpoints(self.dir)
        self._next_index = max(
            [i + 1 for i, _ in existing] + [u for u, _ in ckpts] + [0]
        )
        # the first index THIS writer owns: recovery replays strictly
        # below it, so the replay can never consume its own appends
        self.first_index = self._next_index
        self._f = None
        self._path: Path | None = None
        self._size = 0
        self._appends = 0
        self._closed = False
        self._dead = False

    # -- appending -----------------------------------------------------------

    def _open_next(self) -> None:
        self._index = self._next_index
        self._next_index += 1
        self._path = self.dir / f"wal-{self._index:08d}.log"
        self._f = open(self._path, "wb")
        self._f.write(SEG_HEADER)
        self._size = len(SEG_HEADER)

    def _seal(self) -> None:
        if self._f is None:
            return
        self._f.flush()
        if self.config.fsync != "never":
            os.fsync(self._f.fileno())
            self.metrics.fsyncs.inc()
        self._f.close()
        self._f = None
        self.metrics.segments.inc()

    def append(
        self, kind: int, guid: str, payload: bytes, v2: bool = False
    ) -> tuple[Path, int, int]:
        """Journal one record (durability per the fsync policy).

        Returns a ``(path, offset, length)`` locator for the record just
        written — the cold tier keeps locators instead of
        payload bytes and reads the record back on promotion.  Locators
        dangle once ``checkpoint()`` deletes the segment; holders must
        re-journal after a checkpoint (the ack-floor idiom)."""
        if self._dead:
            raise RuntimeError("WAL abandoned (simulated crash)")
        if self._closed:
            raise RuntimeError("WAL is closed")
        t0 = time.perf_counter()
        rec = encode_record(kind, guid, payload, v2)
        if self._f is None or self._size >= self.config.segment_bytes:
            self._seal()
            self._open_next()
        offset = self._size
        self._f.write(rec)
        # flush to the OS on every append: in-process readers (tests,
        # the crash harness) must see exactly what a crashed process
        # would leave behind — fsync is the only policy-gated cost
        self._f.flush()
        self._size += len(rec)
        self._appends += 1
        self.metrics.records.labels(kind=KIND_NAMES[kind]).inc()
        self.metrics.bytes.inc(len(rec))
        cfg = self.config
        if cfg.fsync == "always" or (
            cfg.fsync == "interval" and self._appends % cfg.fsync_interval == 0
        ):
            os.fsync(self._f.fileno())
            self.metrics.fsyncs.inc()
        dt = time.perf_counter() - t0
        self.metrics.append_seconds.observe(dt)
        if self._tracer is not None and self._tracer.enabled:
            # record as a completed span (retroactively: the duration is
            # already known, no context-manager overhead on the hot path)
            self._tracer._events.append((
                "ytpu.wal.append", "X",
                (t0 - self._tracer._t0) * 1e6, dt * 1e6,
                threading.get_ident(), {"kind": KIND_NAMES[kind]}, None,
            ))
        return (self._path, offset, len(rec))

    # -- compaction ----------------------------------------------------------

    def checkpoint(
        self,
        doc_snapshots: list[tuple[str, bytes]],
        dlq_state: dict | None = None,
    ) -> dict:
        """Fold the log into a checkpoint file and truncate the history.

        ``doc_snapshots`` are (guid, encode_state_as_update bytes) pairs
        reflecting EVERYTHING journaled so far (the caller flushes
        first).  The active segment is sealed, the checkpoint is
        written+fsynced+atomically renamed, and only then are the
        covered segments and older checkpoints deleted — a crash at any
        point leaves either the old history or the new checkpoint fully
        intact (replaying both, where they overlap, is safe by update
        idempotence)."""
        if self._dead:
            raise RuntimeError("WAL abandoned (simulated crash)")
        self._seal()
        upto = self._next_index
        final = self.dir / f"checkpoint-{upto:08d}.snap"
        tmp = final.with_suffix(".snap.tmp")
        snap_bytes = 0
        with open(tmp, "wb") as f:
            f.write(SNAP_HEADER)
            for guid, snap in doc_snapshots:
                rec = encode_record(KIND_SNAPSHOT, guid, snap)
                f.write(rec)
                snap_bytes += len(rec)
            if dlq_state is not None:
                rec = encode_record(
                    KIND_DLQ, "", json.dumps(dlq_state).encode("utf-8")
                )
                f.write(rec)
                snap_bytes += len(rec)
            f.flush()
            if self.config.fsync != "never":
                os.fsync(f.fileno())
                self.metrics.fsyncs.inc()
        os.replace(tmp, final)
        reclaimed = 0
        removed = 0
        for idx, p in list_segments(self.dir):
            if idx < upto:
                reclaimed += p.stat().st_size
                p.unlink()
                removed += 1
        for cov, p in list_checkpoints(self.dir):
            if cov < upto:
                reclaimed += p.stat().st_size
                p.unlink()
        self.metrics.compactions.inc()
        self.metrics.reclaimed.inc(reclaimed)
        return {
            "checkpoint": str(final),
            "docs": len(doc_snapshots),
            "snapshot_bytes": snap_bytes,
            "segments_removed": removed,
            "reclaimed_bytes": reclaimed,
        }

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Seal the active segment and stop accepting appends."""
        if not self._dead:
            self._seal()
        self._closed = True

    def abandon(self) -> None:
        """Simulated crash (the chaos harness): drop the file handle
        with NO seal-time fsync and refuse all further appends — the
        directory is left exactly as a killed process would leave it."""
        if self._f is not None:
            self._f.close()
            self._f = None
        self._dead = True
