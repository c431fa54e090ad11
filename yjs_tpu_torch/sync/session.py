"""SyncSession: resumable per-peer sessions over the y-protocols wire.

The sync protocol (:mod:`yjs_tpu_torch.sync.protocol`) is a byte-compatible
port of y-protocols' 2-step handshake and is deliberately network-
agnostic — which means a lost, duplicated, or stalled frame silently
diverges a peer until the next full handshake.  This module makes the
FRAMEWORK own peer-session lifecycle without
changing one wire byte of the v13.4.9-compatible frames: session
control rides a new ENVELOPE message type that a plain y-protocols
peer's tolerant frame reader skips and counts as unknown, so sessions
negotiate DOWN to the plain protocol automatically when the far side
never speaks envelope.

Per-peer state machine::

    connecting ──► syncing ──► live ◄──► lagging
        ▲            ▲          │
        │            └──attach──┤ (transport loss / liveness timeout)
        └── (first attach)      ▼
                           reconnecting ──► closed

- **connecting**: transport attached, HELLO sent, peer not yet heard.
- **syncing**: handshake frames exchanged; the initial delta (computed
  against the peer's HELLO/WELCOME state vector) is in flight.
- **live**: steady state — updates flow as seq-numbered DATA frames,
  cumulative ACKs flow back, unacked frames retransmit with
  exponential backoff + jitter and dead-letter after the retry cap.
- **lagging**: the bounded outbox crossed its high watermark; new
  updates coalesce into ONE pending delta (computed against the
  peer's last-known state vector) that is sent when ACKs drain the
  outbox below the low watermark — intermediate deltas are shed in
  preference to disconnecting the peer.
- **reconnecting**: transport lost; all session state (seq spaces,
  outbox, peer identity) is retained so :meth:`SyncSession.attach`
  resumes with delta catch-up instead of a full resync.
- **closed**: terminal.

An **anti-entropy repair loop** (every ``YTPU_NET_ANTIENTROPY`` ticks
in ``live``) exchanges state-vector digests and heals silent divergence
— anything retransmission could not deliver (retry-cap dead letters,
frames shed under backpressure, partitions outliving the outbox) — via
targeted diffs, counted in ``ytpu_net_antientropy_repairs_total``.

Time is counted in TICKS (the caller drives :meth:`SyncSession.tick`),
the same deterministic-clock choice as the resilience health tracker:
backoff, heartbeat, liveness, and anti-entropy behavior all replay
exactly under test.  All ``YTPU_NET_*`` knobs are documented in README
"Replication & sessions".
"""

from __future__ import annotations

import itertools
import os
import random

from ..lib0 import decoding, encoding
from ..lib0.decoding import Decoder
from ..lib0.encoding import Encoder
from ..obs import global_registry
from ..obs.blackbox import flight_recorder
from ..obs.dist import (
    TraceContext,
    current_context,
    mint_for_update,
    trace_metrics,
    use_context,
)
from ..updates import (
    apply_update,
    decode_state_vector,
    encode_state_as_update,
    encode_state_vector,
)
from . import protocol

# the envelope message type: any varint the plain protocol does not
# know is skipped-and-counted by read_sync_message (that tolerance
# is a contract), so plain peers survive our control frames and
# we detect them by their bare step-1 — that IS the negotiation
MESSAGE_YTPU_SESSION = 121

K_HELLO = 0
K_WELCOME = 1
K_DATA = 2
K_ACK = 3
K_PING = 4
K_PONG = 5
K_DIGEST = 6
# cooperative backpressure: "back off for N ticks".  Sent
# when a session enters lagging (before more frames would be shed) and
# as the admission layer's reply to a rejected write.  Plain
# y-protocols peers skip the whole envelope; enhanced peers coalesce
# their sends into one pending delta until the window passes.
K_BUSY = 7

_KIND_NAMES = {
    K_HELLO: "hello",
    K_WELCOME: "welcome",
    K_DATA: "data",
    K_ACK: "ack",
    K_PING: "ping",
    K_PONG: "pong",
    K_DIGEST: "digest",
    K_BUSY: "busy",
}

CONNECTING = "connecting"
SYNCING = "syncing"
LIVE = "live"
LAGGING = "lagging"
RECONNECTING = "reconnecting"
CLOSED = "closed"

STATES = (CONNECTING, SYNCING, LIVE, LAGGING, RECONNECTING, CLOSED)

# session ids are process-local instance handles (never persisted as
# identity, only echoed back for resume matching); 0 means "none"
_SID = itertools.count(1)

# an empty V1 update (0 client struct-lists + empty delete set) — a
# diff at or below this size carries nothing and is not worth a frame
_EMPTY_UPDATE_LEN = 2


def encode_busy(retry_after: int) -> bytes:
    """One BUSY envelope frame: ``121 | K_BUSY | varint retry_after``.
    Module-level (not a session method) because the provider's
    admission seam emits it as a ``handle_sync_message`` reply without
    owning a session object."""
    enc = Encoder()
    encoding.write_var_uint(enc, MESSAGE_YTPU_SESSION)
    encoding.write_var_uint(enc, K_BUSY)
    encoding.write_var_uint(enc, max(1, int(retry_after)))
    return enc.to_bytes()


def _env_int(name: str, default: int, lo: int = 0,
             hi: int = 1 << 30) -> int:
    try:
        return max(lo, min(hi, int(os.environ.get(name, default))))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return max(0.0, float(os.environ.get(name, default)))
    except (TypeError, ValueError):
        return default


class SessionConfig:
    """Knobs, env-defaulted (``YTPU_NET_*``), ticks unless noted.

    - ``retry_base`` / ``retry_cap``: exponential backoff window for
      unacked DATA frames (``YTPU_NET_RETRY_BASE`` default 2,
      ``YTPU_NET_RETRY_CAP`` default 64).
    - ``retry_max``: retransmit attempts before the frame's payload is
      dead-lettered through the host (``YTPU_NET_RETRY_MAX`` default 8;
      anti-entropy then owns the repair).
    - ``retry_jitter``: fractional jitter on each backoff
      (``YTPU_NET_RETRY_JITTER`` default 0.25, deterministic per
      session seed).
    - ``outbox_high`` / ``outbox_low``: backpressure watermarks on the
      per-peer outbox (``YTPU_NET_OUTBOX_HIGH`` default 256,
      ``YTPU_NET_OUTBOX_LOW`` default 64).
    - ``heartbeat``: idle ticks before a PING (``YTPU_NET_HEARTBEAT``
      default 8; 0 disables).
    - ``liveness``: ticks without ANY inbound frame before the
      transport is declared dead (``YTPU_NET_LIVENESS`` default 32;
      0 disables).
    - ``antientropy``: ticks between state-vector digests in ``live``
      (``YTPU_NET_ANTIENTROPY`` default 16; 0 disables).
    - ``hello_timeout``: ticks in ``connecting`` before falling back to
      a bare plain-protocol step 1 for peers that never initiate
      (``YTPU_NET_HELLO_TIMEOUT`` default 4; 0 disables).
    - ``busy_retry``: retry-after ticks carried by the BUSY frame a
      lagging session sends before shedding more frames
      (``YTPU_NET_BUSY_RETRY`` default 4; 0 disables sending — BUSY
      frames are still honored on receive).
    """

    __slots__ = ("retry_base", "retry_cap", "retry_max", "retry_jitter",
                 "outbox_high", "outbox_low", "heartbeat", "liveness",
                 "antientropy", "hello_timeout", "busy_retry", "seed")

    def __init__(
        self,
        retry_base: int | None = None,
        retry_cap: int | None = None,
        retry_max: int | None = None,
        retry_jitter: float | None = None,
        outbox_high: int | None = None,
        outbox_low: int | None = None,
        heartbeat: int | None = None,
        liveness: int | None = None,
        antientropy: int | None = None,
        hello_timeout: int | None = None,
        busy_retry: int | None = None,
        seed: int = 0,
    ):
        def pick(v, name, default, lo=0):
            return v if v is not None else _env_int(name, default, lo)

        self.retry_base = pick(retry_base, "YTPU_NET_RETRY_BASE", 2, 1)
        self.retry_cap = pick(retry_cap, "YTPU_NET_RETRY_CAP", 64, 1)
        self.retry_max = pick(retry_max, "YTPU_NET_RETRY_MAX", 8, 1)
        self.retry_jitter = (
            retry_jitter
            if retry_jitter is not None
            else _env_float("YTPU_NET_RETRY_JITTER", 0.25)
        )
        self.outbox_high = pick(outbox_high, "YTPU_NET_OUTBOX_HIGH", 256, 1)
        self.outbox_low = pick(outbox_low, "YTPU_NET_OUTBOX_LOW", 64, 0)
        self.heartbeat = pick(heartbeat, "YTPU_NET_HEARTBEAT", 8)
        self.liveness = pick(liveness, "YTPU_NET_LIVENESS", 32)
        self.antientropy = pick(antientropy, "YTPU_NET_ANTIENTROPY", 16)
        self.hello_timeout = pick(
            hello_timeout, "YTPU_NET_HELLO_TIMEOUT", 4
        )
        self.busy_retry = pick(busy_retry, "YTPU_NET_BUSY_RETRY", 4)
        self.seed = seed

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class SessionMetrics:
    """The ``ytpu_net_*`` metric families (registered once per
    registry; provider construction registers them unconditionally so
    exposition and the schema checker see the full surface)."""

    def __init__(self, registry=None):
        r = registry if registry is not None else global_registry()
        self.sessions = r.gauge(
            "ytpu_net_sessions",
            "Live peer sessions by state",
            labelnames=("state",),
        )
        self.frames = r.counter(
            "ytpu_net_frames_total",
            "Session frames by direction and envelope kind (plain-"
            "protocol passthrough counts as kind=plain)",
            labelnames=("dir", "kind"),
        )
        self.retransmits = r.counter(
            "ytpu_net_retransmits_total",
            "DATA frames retransmitted after backoff expiry",
        )
        self.acks = r.counter(
            "ytpu_net_acks_total",
            "Cumulative-ack frames processed",
        )
        self.resumes = r.counter(
            "ytpu_net_resumes_total",
            "Reconnect handshakes resumed via delta catch-up (no full "
            "resync)",
        )
        self.full_resyncs = r.counter(
            "ytpu_net_full_resyncs_total",
            "Handshakes that established a fresh session (initial "
            "connect, or resume state lost)",
        )
        self.repairs = r.counter(
            "ytpu_net_antientropy_repairs_total",
            "Targeted diffs sent because a digest exposed peer "
            "divergence",
        )
        self.rounds = r.counter(
            "ytpu_net_antientropy_rounds_total",
            "State-vector digests initiated by the repair loop",
        )
        self.coalesced = r.counter(
            "ytpu_net_coalesced_updates_total",
            "Updates folded into a pending delta instead of queueing "
            "(backpressure / pre-sync buffering)",
        )
        self.shed = r.counter(
            "ytpu_net_shed_frames_total",
            "Queued-but-unsent outbox frames dropped when entering "
            "lagging (superseded by the coalesced delta)",
        )
        self.dead_lettered = r.counter(
            "ytpu_net_dead_lettered_total",
            "DATA payloads dead-lettered after the retransmit cap",
        )
        self.heartbeats = r.counter(
            "ytpu_net_heartbeats_total",
            "PING/PONG liveness frames",
            labelnames=("dir",),
        )
        self.liveness_timeouts = r.counter(
            "ytpu_net_liveness_timeouts_total",
            "Sessions declared dead after the liveness window",
        )
        self.negotiated_down = r.counter(
            "ytpu_net_negotiated_down_total",
            "Sessions that fell back to the plain y-protocols flow "
            "(peer never spoke envelope)",
        )
        self.outbox_depth = r.gauge(
            "ytpu_net_outbox_depth",
            "Deepest per-peer outbox across the session fleet "
            "(refreshed on tick/snapshot)",
        )
        self.busy_backoffs = r.counter(
            "ytpu_net_busy_backoffs_total",
            "BUSY/retry-after frames honored (sends coalesced until "
            "the advertised window passed)",
        )

    def set_state_gauges(self, sessions) -> None:
        counts = {s: 0 for s in STATES}
        deepest = 0
        for sess in sessions:
            counts[sess.state] = counts.get(sess.state, 0) + 1
            deepest = max(deepest, len(sess._outbox))
        for state, n in counts.items():
            self.sessions.labels(state=state).set(n)
        self.outbox_depth.set(deepest)


class DocSessionHost:
    """Session host over a CPU :class:`yjs_tpu_torch.core.Doc` — the seam a
    :class:`SyncSession` drives (``TpuProvider`` rooms use
    :class:`yjs_tpu_torch.provider._ProviderSessionHost`, same shape).

    ``slo`` (optional :class:`yjs_tpu_torch.obs.slo.ConvergenceTracker`)
    stamps the receive/integrate/visible stages on every applied inner
    frame — the session layer inherits the convergence SLOs with
    zero wire changes."""

    def __init__(self, doc, origin=None, slo=None):
        self.doc = doc
        self.origin = origin if origin is not None else self
        self.slo = slo
        self.dead_letters: list[tuple[bytes, str]] = []

    def state_vector(self) -> bytes:
        return encode_state_vector(self.doc)

    def diff_update(self, sv: bytes | None) -> bytes:
        return encode_state_as_update(self.doc, sv)

    def apply_update(self, update: bytes) -> None:
        apply_update(self.doc, update, self.origin)

    def handle_frame(self, frame: bytes) -> bytes | None:
        dec = Decoder(frame)
        enc = Encoder()
        protocol.read_sync_message(
            dec, enc, self.doc, self.origin, slo=self.slo
        )
        out = enc.to_bytes()
        return out or None

    def dead_letter(self, payload: bytes, reason: str) -> None:
        self.dead_letters.append((bytes(payload), reason))

    def journal_ack(self, sid: int, seq: int) -> None:
        pass  # durable ack floors are a provider concern (WAL)


class SyncSession:
    """One peer's session state machine (see module docstring).

    Not thread-safe: the owner serializes :meth:`tick`, transport
    callbacks, and :meth:`send_update` (``examples/socket_connector.py``
    shows the lock discipline for a threaded transport).
    """

    def __init__(
        self,
        host,
        config: SessionConfig | None = None,
        metrics: SessionMetrics | None = None,
        peer: str = "peer",
    ):
        self.host = host
        self.config = config if config is not None else SessionConfig()
        self.metrics = metrics if metrics is not None else SessionMetrics()
        self.peer = peer
        self.sid = next(_SID)
        self.state = CLOSED  # no transport yet; attach() arms it
        self._closed = False  # set by close(); CLOSED-state alone just
        # means "not attached yet" (registries must not discard those)
        self.transport = None
        self.plain_mode = False
        self._peer_enhanced = False
        self._rng = random.Random((self.config.seed << 8) ^ self.sid)
        # anti-entropy jitter: per-peer seeded stream, kept
        # SEPARATE from the retransmit-backoff RNG so adding digest
        # jitter never perturbs the pinned backoff sequences.  Same
        # keyed-stream pattern as the failover FailureDetector; spreads
        # N links' digests so a partition heal doesn't fire one
        # synchronized digest storm across every WAN link at once.
        # Keyed by the stable peer label, NOT the process-global sid:
        # sids depend on how many sessions existed before this one, so
        # a sid-keyed stream would make same-seed replays within one
        # process diverge.
        self._ae_rng = random.Random(f"ae:{self.config.seed}:{self.peer}")
        self._ae_jitter = 0

        # clocks (ticks)
        self._tick = 0
        self._attached_at = 0
        self._last_recv = 0
        self._last_send = 0
        self._last_ack = 0
        self._last_digest = 0

        # send side: seq-numbered outbox of unacked DATA frames
        self._send_seq = 0
        self._outbox: list[dict] = []
        self._pending_delta = False

        # admission policy: the owning provider/fleet's
        # AdmissionController, read dynamically for its brownout flags
        # (force_coalesce, antientropy_paused); None for client-side
        # sessions.  _busy_until is the peer-advertised backoff window.
        self.policy = None
        self._busy_until = 0
        self.n_busy_backoffs = 0

        # receive side: cumulative ack + out-of-order window
        self._peer_sid = 0
        self._recv_cum = 0
        self._recv_seen: set[int] = set()
        self._peer_sv: bytes | None = None

        # resume hint for sessions rebuilt from WAL recovery: HELLO
        # claims this (peer sid, recv floor) so the surviving peer
        # resumes retransmission instead of a full resync
        self._resume_hint: tuple[int, int] | None = None

        # fleet routing-table epoch this session last re-homed at
        #; 0 = never owned by a fleet
        self.routing_epoch = 0

        # per-epoch handshake bookkeeping
        self._hs_counted = False
        self._hs_diff_sent = False
        self._hs_seq_settled = False
        self._sent_plain_step1 = False
        # HELLO is retried on its own backoff — a lossy link that eats
        # the first frame must not wedge the session in "connecting"
        self._hello_attempts = 0
        self._next_hello = 0

        # per-session stats (metrics are fleet-wide; snapshots need
        # per-peer numbers and must survive YTPU_OBS_DISABLED)
        self.n_sent = 0
        self.n_received = 0
        self.n_retransmits = 0
        self.n_resumes = 0
        self.n_full_resyncs = 0
        self.n_repairs = 0
        self.n_coalesced = 0
        self.n_shed = 0
        self.n_dead_lettered = 0
        self.n_liveness_timeouts = 0

        self.on_state_change = None  # callable(session, old, new)

    # -- lifecycle -----------------------------------------------------------

    def _set_state(self, new: str) -> None:
        old = self.state
        if old == new:
            return
        self.state = new
        if self.on_state_change is not None:
            self.on_state_change(self, old, new)

    def connect(self, transport) -> None:
        """First attach + handshake kick-off."""
        self.attach(transport)

    def attach(self, transport) -> None:
        """Bind a (new) transport and start a handshake epoch.  All
        resume state — seq spaces, outbox, peer identity — carries
        over, so a reconnect replays deltas instead of full state."""
        if self._closed:
            raise RuntimeError("session is closed")
        self.transport = transport
        transport.on_frame = self._on_transport_frame
        transport.on_close = self._on_transport_close
        self._attached_at = self._tick
        self._last_recv = self._tick
        self._hs_counted = False
        self._hs_diff_sent = False
        self._hs_seq_settled = False
        self._sent_plain_step1 = False
        self._hello_attempts = 0
        self._set_state(CONNECTING)
        if self._resume_hint is not None and self._peer_sid == 0:
            self._peer_sid, self._recv_cum = self._resume_hint
        self._send_hello()
        # everything already in the outbox predates this transport:
        # schedule an immediate retransmit pass once the handshake
        # settles (marked here; _on_welcome/_on_hello prune first)
        for e in self._outbox:
            e["next_retry"] = self._tick

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._set_state(CLOSED)
        t, self.transport = self.transport, None
        if t is not None:
            t.on_close = None
            t.close()

    def _on_transport_close(self) -> None:
        self._transport_lost()

    def _transport_lost(self) -> None:
        if self.state in (CLOSED, RECONNECTING):
            return
        t, self.transport = self.transport, None
        if t is not None:
            t.on_close = None
            t.close()
        self._set_state(RECONNECTING)

    # -- wire helpers --------------------------------------------------------

    def _send_frame(self, frame: bytes, kind: str) -> bool:
        t = self.transport
        if t is None:
            return False
        ok = t.send(frame)
        if not ok:
            self._transport_lost()
            return False
        self._last_send = self._tick
        self.metrics.frames.labels(dir="send", kind=kind).inc()
        return True

    def _envelope(self, kind: int) -> Encoder:
        enc = Encoder()
        encoding.write_var_uint(enc, MESSAGE_YTPU_SESSION)
        encoding.write_var_uint(enc, kind)
        return enc

    def _send_hello(self) -> None:
        self._hello_attempts += 1
        self._next_hello = self._tick + self._backoff(
            min(self._hello_attempts, 8)
        )
        enc = self._envelope(K_HELLO)
        encoding.write_var_uint(enc, self.sid)
        encoding.write_var_uint(enc, self._peer_sid)
        encoding.write_var_uint(enc, self._recv_cum)
        encoding.write_var_uint8_array(enc, self.host.state_vector())
        self._send_frame(enc.to_bytes(), "hello")

    def _send_welcome(self, resumed: bool) -> None:
        enc = self._envelope(K_WELCOME)
        encoding.write_var_uint(enc, self.sid)
        encoding.write_var_uint(enc, 1 if resumed else 0)
        encoding.write_var_uint(enc, self._recv_cum)
        encoding.write_var_uint8_array(enc, self.host.state_vector())
        self._send_frame(enc.to_bytes(), "welcome")

    def _send_ack(self) -> None:
        enc = self._envelope(K_ACK)
        encoding.write_var_uint(enc, self._recv_cum)
        self._send_frame(enc.to_bytes(), "ack")

    def _send_digest(self) -> None:
        enc = self._envelope(K_DIGEST)
        encoding.write_var_uint8_array(enc, self.host.state_vector())
        self._last_digest = self._tick
        # re-draw the next interval's jitter (0..antientropy/4 ticks)
        # so consecutive digests desynchronize across sessions even
        # when they were armed on the same tick (partition heal)
        span = max(1, self.config.antientropy // 4)
        self._ae_jitter = self._ae_rng.randrange(span + 1)
        self.metrics.rounds.inc()
        self._send_frame(enc.to_bytes(), "digest")

    def _send_busy(self, retry_after: int) -> None:
        self._send_frame(encode_busy(retry_after), "busy")

    def _on_busy(self, dec: Decoder) -> None:
        retry = decoding.read_var_uint(dec)
        until = self._tick + max(1, int(retry))
        if until > self._busy_until:
            self._busy_until = until
        self.n_busy_backoffs += 1
        self.metrics.busy_backoffs.inc()

    def _data_frame(self, seq: int, inner: bytes,
                    trace: TraceContext | None = None) -> bytes:
        """``121 | K_DATA | varint seq | varint8array inner`` plus — for
        a SAMPLED trace context — one trailing varint8array
        carrying the 25-byte trace blob.  Pre-PR readers decode only
        seq + inner and never touch trailing decoder bytes; stock
        y-protocols v13.4.9 readers skip the whole unknown type-121
        message — zero wire change either way.  Unsampled traffic omits
        the key entirely, so the absent path is exercised routinely."""
        enc = self._envelope(K_DATA)
        encoding.write_var_uint(enc, seq)
        encoding.write_var_uint8_array(enc, inner)
        if trace is not None and trace.sampled:
            encoding.write_var_uint8_array(enc, trace.to_bytes())
            trace_metrics().carried.labels(dir="send").inc()
        return enc.to_bytes()

    def _queue_data(self, inner: bytes,
                    trace: TraceContext | None = None) -> None:
        """Seq-number one inner frame, queue for ack tracking, send.
        The trace context is stored on the outbox entry so retransmits
        re-carry the SAME causal identity."""
        if trace is None:
            trace = current_context()
        self._send_seq += 1
        entry = {
            "seq": self._send_seq,
            "inner": inner,
            "attempts": 0,
            "next_retry": self._tick + self._backoff(1),
            "sent": False,
            "trace": trace,
        }
        self._outbox.append(entry)
        entry["sent"] = self._send_frame(
            self._data_frame(entry["seq"], inner, trace), "data"
        )
        self.n_sent += 1

    def _backoff(self, attempts: int) -> int:
        cfg = self.config
        base = min(cfg.retry_cap, cfg.retry_base * (1 << (attempts - 1)))
        jitter = 1.0 + cfg.retry_jitter * self._rng.random()
        return max(1, int(base * jitter))

    # -- outbound updates ----------------------------------------------------

    def send_update(self, update: bytes) -> None:
        """Ship one local update to the peer.

        Live sessions send a seq-numbered DATA frame.  Under
        backpressure (outbox at the high watermark) or before the
        handshake settles, the update is NOT queued — it is coalesced
        into one pending delta served from the host's current state,
        preferring shed intermediates over a disconnect."""
        if self.state == CLOSED:
            return
        if self.plain_mode:
            enc = Encoder()
            protocol.write_update(enc, update)
            self._send_frame(enc.to_bytes(), "plain")
            self.n_sent += 1
            return
        if self.state in (CONNECTING, SYNCING, RECONNECTING):
            self._pending_delta = True
            self.n_coalesced += 1
            self.metrics.coalesced.inc()
            return
        pol = self.policy
        if self._tick < self._busy_until or (
            pol is not None and getattr(pol, "force_coalesce", False)
        ):
            # peer asked us to back off (BUSY) or the brownout level
            # forces lagging-style coalescing: fold into the pending
            # delta, flushed by tick() once the window allows
            self._pending_delta = True
            self.n_coalesced += 1
            self.metrics.coalesced.inc()
            return
        if self.state == LAGGING or len(self._outbox) >= self.config.outbox_high:
            self._enter_lagging()
            self._pending_delta = True
            self.n_coalesced += 1
            self.metrics.coalesced.inc()
            return
        inner = Encoder()
        protocol.write_update(inner, update)
        # the trace is minted from the RAW update bytes (not the framed
        # inner), matching what a receiving provider would mint for the
        # same payload — carried and minted identities agree
        self._queue_data(
            inner.to_bytes(),
            trace=current_context() or mint_for_update(update),
        )

    def _enter_lagging(self) -> None:
        if self.state == LAGGING:
            return
        # cooperative backpressure first: tell the peer to back off
        # BEFORE frames start shedding, so a well-behaved sender
        # coalesces at its end instead of flooding a lagging link.
        # Gated on an admission policy being live — without one the
        # wire behavior is exactly the protocol without admission.
        pol = self.policy
        if (
            self.config.busy_retry
            and not self.plain_mode
            and pol is not None
            and getattr(pol, "enabled", False)
        ):
            self._send_busy(self.config.busy_retry)
        # shed queued-but-never-sent frames: the coalesced delta
        # supersedes them (sent-once frames stay for ack accounting —
        # the peer may already hold them)
        kept = []
        for e in self._outbox:
            if e["sent"]:
                kept.append(e)
            else:
                self.n_shed += 1
                self.metrics.shed.inc()
        self._outbox = kept
        self._set_state(LAGGING)

    def _maybe_flush_delta(self) -> None:
        """Send the coalesced catch-up delta once the peer can absorb
        it (post-handshake, or outbox drained below the low mark)."""
        if not self._pending_delta or self.plain_mode:
            return
        if self.state not in (LIVE, LAGGING):
            return
        if self._tick < self._busy_until:
            return  # peer asked us to hold off; tick() flushes later
        if len(self._outbox) > self.config.outbox_low:
            return
        self._pending_delta = False
        diff = self.host.diff_update(self._peer_sv)
        if len(diff) > _EMPTY_UPDATE_LEN:
            inner = Encoder()
            protocol.write_update(inner, diff)
            self._queue_data(inner.to_bytes())
        if self.state == LAGGING:
            self._set_state(LIVE)

    # -- handshake -----------------------------------------------------------

    def _reset_recv(self, peer_sid: int) -> None:
        self._peer_sid = peer_sid
        self._recv_cum = 0
        self._recv_seen.clear()

    def _reset_send(self) -> None:
        self._send_seq = 0
        self._outbox = []

    def _count_handshake(self, resumed: bool) -> None:
        if self._hs_counted:
            return
        self._hs_counted = True
        if resumed:
            self.n_resumes += 1
            self.metrics.resumes.inc()
        else:
            self.n_full_resyncs += 1
            self.metrics.full_resyncs.inc()

    def _finish_handshake(self) -> None:
        if self.state in (CONNECTING, RECONNECTING):
            self._set_state(SYNCING)
        if not self._hs_diff_sent:
            self._hs_diff_sent = True
            diff = self.host.diff_update(self._peer_sv)
            if len(diff) > _EMPTY_UPDATE_LEN:
                inner = Encoder()
                protocol.write_update(inner, diff)
                self._queue_data(inner.to_bytes())
        if self.state == SYNCING and not self._outbox:
            self._set_state(LIVE)
            self._maybe_flush_delta()

    def _on_hello(self, dec: Decoder) -> None:
        sid = decoding.read_var_uint(dec)
        resume_sid = decoding.read_var_uint(dec)
        resume_seq = decoding.read_var_uint(dec)
        self._peer_sv = decoding.read_var_uint8_array(dec)
        self._peer_enhanced = True
        self.plain_mode = False
        # the two directions resume INDEPENDENTLY.  `resumed` judges
        # the peer's claim about MY send stream; `recv_resumed` is my
        # own receive-side continuity for the PEER's stream — true when
        # the HELLO names the sid my receive floor belongs to (a live
        # floor, or one re-armed from a journaled WAL record).  The
        # WELCOME must carry `recv_resumed`: it is what tells the peer
        # to prune-and-retransmit instead of restarting its seq space,
        # and conflating it with `resumed` makes a recovered region's
        # peers full-resync whenever the WELCOME races ahead of the
        # recovered side's own HELLO (reordered or lossy WAN links).
        recv_resumed = sid == self._peer_sid and sid != 0
        if sid != self._peer_sid:
            # a new peer instance: its receive history died with it
            self._reset_recv(sid)
        resumed = resume_sid == self.sid
        if not self._hs_seq_settled:
            # settle the send-side seq space ONCE per epoch: HELLO and
            # WELCOME both carry the verdict and both arrive — a second
            # reset would recycle seqs the peer has already seen
            self._hs_seq_settled = True
            if resumed:
                # the peer holds everything up to resume_seq from THIS
                # session: prune, then retransmit the survivors now
                self._drop_acked(resume_seq)
                for e in self._outbox:
                    e["next_retry"] = self._tick
            else:
                # peer has no memory of our frames: restart the seq
                # space (the handshake delta below carries all history)
                self._reset_send()
        # classify as a resume only when a prior handshake completed —
        # a duplicate HELLO inside a lossy INITIAL handshake names a
        # sid we already learned, which is continuity on the wire but
        # not a resumed session
        self._count_handshake(
            resumed and (self.n_resumes + self.n_full_resyncs) > 0
        )
        self._send_welcome(recv_resumed)
        self._finish_handshake()

    def _on_welcome(self, dec: Decoder) -> None:
        sid = decoding.read_var_uint(dec)
        resumed = bool(decoding.read_var_uint(dec))
        recv_seq = decoding.read_var_uint(dec)
        self._peer_sv = decoding.read_var_uint8_array(dec)
        self._peer_enhanced = True
        self.plain_mode = False
        if sid != self._peer_sid:
            self._reset_recv(sid)
        if not self._hs_seq_settled:
            self._hs_seq_settled = True
            if resumed:
                self._drop_acked(recv_seq)
                for e in self._outbox:
                    e["next_retry"] = self._tick
            else:
                self._reset_send()
        self._count_handshake(
            resumed and (self.n_resumes + self.n_full_resyncs) > 0
        )
        self._finish_handshake()

    # -- data / ack ----------------------------------------------------------

    def _drop_acked(self, cum: int) -> None:
        if self._outbox:
            self._outbox = [e for e in self._outbox if e["seq"] > cum]

    def _on_data(self, dec: Decoder) -> None:
        seq = decoding.read_var_uint(dec)
        inner = decoding.read_var_uint8_array(dec)
        # optional trailing trace-context key: absent on
        # unsampled traffic and on frames from pre-PR senders; any
        # parse trouble degrades to "no context" — never to a dead
        # frame (the inner payload was already read intact)
        ctx = None
        try:
            if dec.has_content():
                ctx = TraceContext.from_bytes(
                    decoding.read_var_uint8_array(dec)
                )
        except Exception:
            ctx = None
        if ctx is not None:
            trace_metrics().carried.labels(dir="recv").inc()
        if seq <= self._recv_cum or seq in self._recv_seen:
            self._send_ack()  # duplicate: the peer missed our ack
            return
        self.n_received += 1
        with use_context(ctx):
            reply = self.host.handle_frame(bytes(inner))
        if reply is not None and reply[0] == MESSAGE_YTPU_SESSION:
            # an envelope reply (admission BUSY) means the host REFUSED
            # this frame — it was neither applied nor journaled.  Leave
            # the seq un-acked so the peer keeps it in its outbox and
            # retransmits once its backoff expires; acking a rejected
            # update would silently lose it.
            self.n_received -= 1
            self._send_frame(reply, "busy")
            return
        self._recv_seen.add(seq)
        while (self._recv_cum + 1) in self._recv_seen:
            self._recv_cum += 1
            self._recv_seen.discard(self._recv_cum)
        self._send_ack()
        self.host.journal_ack(self._peer_sid, self._recv_cum)
        if reply is not None:
            if self.state in (LIVE, SYNCING, LAGGING):
                self._queue_data(reply)
            else:
                self._send_frame(reply, "plain")

    def _on_ack(self, dec: Decoder) -> None:
        cum = decoding.read_var_uint(dec)
        self.metrics.acks.inc()
        self._last_ack = self._tick
        self._drop_acked(cum)
        if self.state == SYNCING and not self._outbox:
            self._set_state(LIVE)
        if len(self._outbox) <= self.config.outbox_low:
            self._maybe_flush_delta()

    def _on_digest(self, dec: Decoder) -> None:
        peer_sv = decoding.read_var_uint8_array(dec)
        self._peer_sv = peer_sv
        pol = self.policy
        if pol is not None and getattr(pol, "antientropy_paused", False):
            # shed-background: answering repairs is exactly the
            # expensive diff work this level exists to shed; the peer's
            # own digest loop retries once the brownout lifts
            return
        mine = decode_state_vector(self.host.state_vector())
        theirs = decode_state_vector(bytes(peer_sv))
        ahead = any(
            clock > theirs.get(client, 0) for client, clock in mine.items()
        )
        behind = any(
            clock > mine.get(client, 0) for client, clock in theirs.items()
        )
        if ahead:
            # silent divergence detected: targeted repair diff
            diff = self.host.diff_update(bytes(peer_sv))
            if len(diff) > _EMPTY_UPDATE_LEN:
                self.n_repairs += 1
                self.metrics.repairs.inc()
                inner = Encoder()
                protocol.write_update(inner, diff)
                self._queue_data(inner.to_bytes())
        if behind and self._tick - self._last_digest >= 2:
            # solicit the peer's repair path without a digest storm
            self._send_digest()

    # -- inbound dispatch ----------------------------------------------------

    def _on_transport_frame(self, frame: bytes) -> None:
        if self.state == CLOSED or not frame:
            return
        self._last_recv = self._tick
        try:
            dec = Decoder(frame)
            mtype = decoding.read_var_uint(dec)
        except Exception:
            self.host.dead_letter(frame, "net-bad-frame")
            return
        if mtype != MESSAGE_YTPU_SESSION:
            self.metrics.frames.labels(dir="recv", kind="plain").inc()
            self._on_plain_frame(frame)
            return
        try:
            kind = decoding.read_var_uint(dec)
        except Exception:
            self.host.dead_letter(frame, "net-bad-envelope")
            return
        self.metrics.frames.labels(
            dir="recv", kind=_KIND_NAMES.get(kind, "unknown")
        ).inc()
        try:
            if kind == K_HELLO:
                self._on_hello(dec)
            elif kind == K_WELCOME:
                self._on_welcome(dec)
            elif kind == K_DATA:
                self._on_data(dec)
            elif kind == K_ACK:
                self._on_ack(dec)
            elif kind == K_PING:
                self.metrics.heartbeats.labels(dir="recv").inc()
                self._send_frame(self._envelope(K_PONG).to_bytes(), "pong")
            elif kind == K_PONG:
                self.metrics.heartbeats.labels(dir="recv").inc()
            elif kind == K_DIGEST:
                self._on_digest(dec)
            elif kind == K_BUSY:
                self._on_busy(dec)
            # unknown envelope kinds: a newer revision — skip (the
            # same tolerance contract as the plain frame reader)
        except Exception as e:
            self.host.dead_letter(
                frame, f"net-envelope: {type(e).__name__}: {e}"
            )

    def _on_plain_frame(self, frame: bytes) -> None:
        """A bare y-protocols frame: the peer speaks the plain
        protocol (or our own fallback step 1 crossed a slow HELLO).
        Negotiate down — acks/retransmit/heartbeats all require the
        envelope; plain mode is pure passthrough."""
        if not self._peer_enhanced and not self.plain_mode:
            self.plain_mode = True
            self.metrics.negotiated_down.inc()
        reply = self.host.handle_frame(frame)
        self.n_received += 1
        if self.plain_mode:
            if not self._sent_plain_step1:
                self._sent_plain_step1 = True
                enc = Encoder()
                encoding.write_var_uint(
                    enc, protocol.MESSAGE_YJS_SYNC_STEP_1
                )
                encoding.write_var_uint8_array(
                    enc, self.host.state_vector()
                )
                self._send_frame(enc.to_bytes(), "plain")
            if reply is not None:
                self._send_frame(reply, "plain")
            if self.state in (CONNECTING, SYNCING):
                self._count_handshake(False)
                self._set_state(LIVE)
        elif reply is not None:
            if reply[0] == MESSAGE_YTPU_SESSION:
                self._send_frame(reply, "busy")
            else:
                # enhanced peer sent a stray bare frame: answer in kind
                self._queue_data(reply)

    # -- the clock -----------------------------------------------------------

    def tick(self) -> None:
        """One unit of session time: drives retransmission backoff,
        the plain-protocol fallback, heartbeats, liveness, and the
        anti-entropy repair loop.  The owner calls this at its own
        cadence (a provider flush loop, a transport ticker thread)."""
        if self.state == CLOSED:
            return
        self._tick += 1
        cfg = self.config
        if self.state == RECONNECTING:
            return  # waiting on attach(); no wire to drive
        if self.plain_mode:
            return  # no envelope: nothing to retransmit or probe
        if (
            self.state == CONNECTING
            and cfg.hello_timeout
            and not self._sent_plain_step1
            and self._tick - self._attached_at >= cfg.hello_timeout
        ):
            # peer silent: maybe it is a plain server awaiting step 1
            self._sent_plain_step1 = True
            enc = Encoder()
            encoding.write_var_uint(enc, protocol.MESSAGE_YJS_SYNC_STEP_1)
            encoding.write_var_uint8_array(enc, self.host.state_vector())
            self._send_frame(enc.to_bytes(), "plain")
        # the handshake itself rides the lossy link: retry HELLO on
        # backoff until the peer answers (a plain peer skips the
        # envelope, so over-sending never hurts interop)
        if self.state == CONNECTING and self._tick >= self._next_hello:
            self._send_hello()
        # retransmission with exponential backoff + jitter; a BUSY
        # window pauses the whole pass (attempts included) — the server
        # asked us to hold, so burning the retry budget against its
        # admission gate would dead-letter frames it WILL take later
        if (
            self.state in (SYNCING, LIVE, LAGGING)
            and self._outbox
            and self._tick >= self._busy_until
        ):
            expired = []
            for e in self._outbox:
                if e["next_retry"] > self._tick:
                    continue
                e["attempts"] += 1
                if e["attempts"] > cfg.retry_max:
                    expired.append(e)
                    continue
                e["next_retry"] = self._tick + self._backoff(e["attempts"])
                if self._send_frame(
                    self._data_frame(e["seq"], e["inner"], e.get("trace")),
                    "data",
                ):
                    e["sent"] = True
                    self.n_retransmits += 1
                    self.metrics.retransmits.inc()
                else:
                    return  # transport died mid-pass
            if expired:
                dead = {e["seq"] for e in expired}
                self._outbox = [
                    e for e in self._outbox if e["seq"] not in dead
                ]
                for e in expired:
                    self.n_dead_lettered += 1
                    self.metrics.dead_lettered.inc()
                    # a retry-capped frame is an acked-loss near-miss on
                    # a WAN link: force-sample the frame's own trace so
                    # the drop is always visible in Perfetto/blackbox
                    # even at production sampling rates, then dead-letter
                    # under that context so the DLQ seam sees it too
                    ctx = e.get("trace")
                    if ctx is not None:
                        ctx = ctx.force("geo-retry-cap")
                    flight_recorder().record(
                        "session", "retry_cap_dead_letter",
                        severity="warning",
                        trace=(None if ctx is None else ctx.trace_hex),
                        peer=self.peer, seq=e["seq"], state=self.state,
                        attempts=e["attempts"],
                    )
                    with use_context(ctx):
                        self.host.dead_letter(
                            e["inner"],
                            f"net-retry-exhausted: seq {e['seq']} after "
                            f"{cfg.retry_max} attempts",
                        )
                # the peer never confirmed those frames: let the
                # anti-entropy loop close the gap promptly
                self._last_digest = min(
                    self._last_digest, self._tick - cfg.antientropy
                )
                # a WAN storm can dead-letter the ENTIRE initial sync;
                # syncing -> live otherwise fires only on send/ack
                # success, and anti-entropy is live-gated — without
                # this promotion the session wedges in syncing with
                # the healer that would close the gap never running
                if self.state == SYNCING and not self._outbox:
                    self._set_state(LIVE)
        # liveness: nothing heard for the whole window → transport dead
        if (
            cfg.liveness
            and self.state in (SYNCING, LIVE, LAGGING)
            and self._tick - self._last_recv >= cfg.liveness
        ):
            self.n_liveness_timeouts += 1
            self.metrics.liveness_timeouts.inc()
            self._transport_lost()
            return
        # busy/forced coalescing has no ack to trigger the delta flush:
        # drive it from the clock once the advertised window passes
        # (guarded to the admission paths so classic lagging recovery
        # stays ack-driven, byte-for-byte)
        pol = self.policy
        if (
            self._pending_delta
            and self.state in (LIVE, LAGGING)
            and self._tick >= self._busy_until
            and (
                self._busy_until
                or (pol is not None and getattr(pol, "force_coalesce", False))
            )
        ):
            self._maybe_flush_delta()
        # heartbeat: keep an idle link observably alive
        if (
            cfg.heartbeat
            and self.state == LIVE
            and self._tick - self._last_send >= cfg.heartbeat
        ):
            self.metrics.heartbeats.labels(dir="send").inc()
            self._send_frame(self._envelope(K_PING).to_bytes(), "ping")
        # anti-entropy: periodic digest exchange heals silent divergence
        # (paused under brownout — digest repair is background work the
        # shed-background level exists to shed)
        if (
            cfg.antientropy
            and self.state == LIVE
            and self._tick - self._last_digest >= cfg.antientropy + self._ae_jitter
            and not (
                pol is not None
                and getattr(pol, "antientropy_paused", False)
            )
        ):
            self._send_digest()

    # -- introspection -------------------------------------------------------

    @property
    def outbox_depth(self) -> int:
        return len(self._outbox)

    @property
    def last_ack_age(self) -> int:
        return self._tick - self._last_ack

    def rehome(self, epoch: int) -> None:
        """The host's routing epoch changed (fleet doc migration moved
        the room to another shard).  Seq spaces, outbox, and peer
        identity all survive — the host facade re-points transparently —
        but the handoff window may have raced a flush, so a live
        enhanced session immediately offers a state-vector digest: the
        anti-entropy loop then repairs any gap with a targeted diff
        instead of waiting out the ``antientropy`` interval."""
        self.routing_epoch = int(epoch)
        if (
            not self._closed
            and not self.plain_mode
            and self.transport is not None
            and self.state in (SYNCING, LIVE, LAGGING)
        ):
            self._send_digest()

    def set_resume_hint(self, peer_sid: int, recv_seq: int) -> None:
        """Arm a recovered session's HELLO with the journaled ack
        floor (see ``TpuProvider.recover``): the surviving peer then
        resumes retransmission past ``recv_seq`` instead of a full
        resync."""
        self._resume_hint = (int(peer_sid), int(recv_seq))

    @property
    def ack_floor(self) -> tuple[int, int]:
        """The receive floor this session would journal: ``(peer sid,
        cumulative seq received)``.  The fleet re-journals it onto a
        doc's NEW owner (migration destination, failover promotion) so
        the shard that answers the next handshake holds the floor and
        the peer resumes instead of full-resyncing."""
        return (self._peer_sid, self._recv_cum)

    def snapshot(self) -> dict:
        """JSON-able per-peer row (the ``sessions_snapshot()`` shape)."""
        return {
            "peer": self.peer,
            "sid": self.sid,
            "peer_sid": self._peer_sid,
            "state": self.state,
            "plain": self.plain_mode,
            "outbox_depth": len(self._outbox),
            "pending_delta": self._pending_delta,
            "send_seq": self._send_seq,
            "recv_cum": self._recv_cum,
            "last_ack_age": self.last_ack_age,
            "sent": self.n_sent,
            "received": self.n_received,
            "retransmits": self.n_retransmits,
            "resumes": self.n_resumes,
            "full_resyncs": self.n_full_resyncs,
            "repairs": self.n_repairs,
            "coalesced": self.n_coalesced,
            "shed": self.n_shed,
            "dead_lettered": self.n_dead_lettered,
            "liveness_timeouts": self.n_liveness_timeouts,
            "busy_backoffs": self.n_busy_backoffs,
            "busy_until": self._busy_until,
            "routing_epoch": self.routing_epoch,
            "tick": self._tick,
        }
