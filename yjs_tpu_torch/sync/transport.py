"""Transport seam for :mod:`yjs_tpu_torch.sync.session`.

A :class:`Transport` is the narrowest thing a session needs from a
network: ``send(frame)`` one length-delimited byte frame, surface
inbound frames through ``on_frame``, and report loss through
``on_close``.  Framing, threading, and reconnection policy live with
the transport's owner — the session only ever sees whole frames and a
liveness signal.

Two implementations ship here:

- :class:`CallbackTransport` — adapter for callers that already have a
  delivery mechanism (a socket writer thread, a websocket, a test
  harness): construct with a ``send_fn`` and feed inbound bytes to
  :meth:`CallbackTransport.deliver`.
- :class:`PipeNetwork` / :class:`PipeTransport` — a deterministic
  in-memory network for tests and benchmarks: frames queue in-flight
  and deliver on explicit :meth:`PipeNetwork.pump` rounds, optionally
  through a :class:`yjs_tpu_torch.resilience.chaos.NetworkFaultInjector`
  (drop / delay / duplicate / reorder / partition at this exact seam).
"""

from __future__ import annotations


class Transport:
    """Contract: ``send`` whole frames out, get whole frames in via
    ``on_frame``, learn about loss via ``on_close``.  ``send`` returns
    False (never raises) when the transport is down — the session
    treats that as a loss signal and keeps the frame for retransmit."""

    def __init__(self):
        self.on_frame = None  # callable(frame: bytes)
        self.on_close = None  # callable()
        self.alive = True

    def send(self, frame: bytes) -> bool:  # pragma: no cover - contract
        raise NotImplementedError

    def close(self) -> None:
        if not self.alive:
            return
        self.alive = False
        cb = self.on_close
        if cb is not None:
            cb()


class CallbackTransport(Transport):
    """Adapter transport: outbound frames go to ``send_fn(frame)``
    (return False or raise to signal loss); the owner pushes inbound
    frames with :meth:`deliver`."""

    def __init__(self, send_fn):
        super().__init__()
        self._send_fn = send_fn

    def send(self, frame: bytes) -> bool:
        if not self.alive:
            return False
        try:
            ok = self._send_fn(frame)
        except Exception:
            self.close()
            return False
        if ok is False:
            self.close()
            return False
        return True

    def deliver(self, frame: bytes) -> None:
        if self.alive and self.on_frame is not None:
            self.on_frame(bytes(frame))


class PipeTransport(Transport):
    """One endpoint of an in-memory :class:`PipeNetwork` link."""

    def __init__(self, network: "PipeNetwork", name: str):
        super().__init__()
        self.network = network
        self.name = name
        self.peer: "PipeTransport | None" = None

    def send(self, frame: bytes) -> bool:
        if not self.alive or self.peer is None or not self.peer.alive:
            return False
        self.network._enqueue(self, self.peer, bytes(frame))
        return True


class PipeNetwork:
    """Deterministic in-memory frame network.

    Frames sent on one endpoint queue in-flight and reach the peer's
    ``on_frame`` only during :meth:`pump` — tests control time.  An
    optional injector (see
    :class:`yjs_tpu_torch.resilience.chaos.NetworkFaultInjector`) decides
    each frame's fate at enqueue time (drop / duplicate / delay) and
    each pump round's shape (reorder, partition)."""

    def __init__(self, injector=None):
        self.injector = injector
        self.round = 0
        # in-flight entries: (due_round, dst_transport, frame)
        self._inflight: list[tuple[int, "PipeTransport", bytes]] = []

    def pair(
        self, a_name: str = "a", b_name: str = "b"
    ) -> tuple[PipeTransport, PipeTransport]:
        a = PipeTransport(self, a_name)
        b = PipeTransport(self, b_name)
        a.peer, b.peer = b, a
        # WAN-profile injectors pick one-way partition victims from the
        # registered endpoint names (getattr: simple test fakes lack it)
        reg = getattr(self.injector, "register_link", None)
        if reg is not None:
            reg(a_name, b_name)
        return a, b

    def _enqueue(self, src, dst, frame: bytes) -> None:
        inj = self.injector
        if inj is None:
            self._inflight.append((self.round + 1, dst, frame))
            return
        for delay in inj.fates(frame):
            if delay is None:
                continue  # dropped
            self._inflight.append((self.round + 1 + delay, dst, frame))

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def kill(self, *transports: PipeTransport) -> None:
        """Sever endpoints (transport loss, NOT process loss): their
        in-flight frames vanish and ``on_close`` fires — the session
        on each side goes ``reconnecting`` and keeps its state."""
        dead = set(transports)
        self._inflight = [
            e for e in self._inflight if e[1] not in dead
        ]
        for t in transports:
            t.close()

    def pump(self, rounds: int = 1) -> int:
        """Advance time; deliver every due frame.  Returns frames
        delivered (dropped/partitioned frames do not count)."""
        delivered = 0
        inj = self.injector
        for _ in range(rounds):
            self.round += 1
            due = [e for e in self._inflight if e[0] <= self.round]
            if not due:
                continue
            self._inflight = [
                e for e in self._inflight if e[0] > self.round
            ]
            partitioned = inj is not None and inj.partitioned()
            if partitioned:
                continue  # the link is down: everything due is lost
            # WAN shaping (one-way partitions, flap windows, bandwidth
            # caps) is direction-aware, so it filters per frame rather
            # than felling the whole round; over-budget frames re-queue
            # for the next round instead of being lost
            filt = getattr(inj, "filter_due", None)
            if filt is not None:
                due, defer = filt(due, self.round)
                for _due_round, dst, frame in defer:
                    self._inflight.append((self.round + 1, dst, frame))
            if inj is not None and len(due) > 1:
                due = inj.maybe_reorder(due)
            for _due_round, dst, frame in due:
                if dst.alive and dst.on_frame is not None:
                    dst.on_frame(frame)
                    delivered += 1
        return delivered

    def settle(
        self, tick_fns=(), max_rounds: int = 200, idle_rounds: int = 1
    ) -> int:
        """Pump (interleaving the given session ``tick`` callables)
        until the wire stays empty for ``idle_rounds`` consecutive
        rounds; returns rounds used.  Under fault injection an empty
        wire is NOT settled — a dropped frame regenerates only when its
        retransmit backoff expires — so lossy callers must pass an
        ``idle_rounds`` larger than the worst backoff gap (e.g.
        ``retry_cap * (1 + retry_jitter)`` ticks)."""
        idle = 0
        for n in range(max_rounds):
            if not self._inflight:
                idle += 1
                if n > 0 and idle >= idle_rounds:
                    return n
            else:
                idle = 0
            self.pump()
            for fn in tick_fns:
                fn()
        return max_rounds
