"""Seeded, tick-deterministic multi-tenant overload generator.

The proof harness for the admission/brownout subsystem: drive a mixed
population of clients — interactive editors, idlers, reconnectors, lossy
links, and an abusive tenant pushing far over its rate — against a
provider or a replicated :class:`~yjs_tpu_torch.fleet.FleetRouter` at a
configurable multiple of sustained admission capacity, then prove the
invariants the paper's robustness story needs:

- **zero acked-update loss** — every update the server accepted (direct
  ``receive_update`` returning True, or a session DATA frame it acked)
  is present in the final server state;
- **byte-identical convergence** — each doc has exactly one writer, so
  the server's final text must equal the writer's local text exactly;
- **interactive protection** — visibility probes (edit tick → tick the
  edit is readable on the server) give an interactive p99 that the
  brownout ladder is meant to protect while background traffic sheds;
- **bounded recovery** — after the load stops, the brownout level walks
  back to ``normal`` within a bounded number of ticks (hysteresis, no
  flapping).

Everything is driven by one integer seed and a tick loop — no wall
clocks, no threads — so a failing run replays exactly from its seed
(printed by the test harness on failure).
"""

from __future__ import annotations

import random

from .admission import AdmissionRejected
from .core import Doc
from .resilience.chaos import NetChaosConfig, NetworkFaultInjector
from .sync.session import DocSessionHost, SessionConfig, SyncSession
from .sync.transport import PipeNetwork

__all__ = [
    "LoadGen", "LoadGenConfig", "Profile", "PROFILES", "INTERACTIVE_MIX",
]

_ALPHABET = "abcdefghijklmnopqrstuvwxyz "


class Profile:
    """One client behavior archetype.

    ``p_edit`` is the per-tick edit probability; ``burst`` the edits per
    editing tick; ``direct`` clients skip the session layer and call
    ``receive_update`` themselves (retrying rejections with a cumulative
    delta); ``faults`` (a NetChaosConfig kwargs dict) puts the client's
    pipe behind the network fault injector; ``reconnect_every`` kills and
    re-attaches the transport on that tick cadence; ``interactive``
    clients carry the visibility probes the SLO assertions read."""

    __slots__ = (
        "name", "p_edit", "burst", "direct", "faults",
        "reconnect_every", "interactive",
    )

    def __init__(
        self, name, p_edit, burst=1, direct=False, faults=None,
        reconnect_every=0, interactive=False,
    ):
        self.name = name
        self.p_edit = float(p_edit)
        self.burst = max(1, int(burst))
        self.direct = bool(direct)
        self.faults = dict(faults) if faults else None
        self.reconnect_every = max(0, int(reconnect_every))
        self.interactive = bool(interactive)


PROFILES = {
    # the interactive population the brownout ladder protects
    "edit": Profile("edit", p_edit=0.4, interactive=True),
    # parked tabs: rare edits, mostly heartbeat/anti-entropy traffic
    "idle": Profile("idle", p_edit=0.02),
    # flappy links: periodic transport loss + reattach (must resume,
    # never full-resync)
    "reconnect": Profile(
        "reconnect", p_edit=0.2, reconnect_every=40, interactive=True
    ),
    # lossy last mile: drops/dups/delays/reorders on the pipe
    "lossy": Profile(
        "lossy", p_edit=0.2,
        faults=dict(drop=0.12, duplicate=0.1, delay=0.2, reorder=0.2),
    ),
    # the overload driver: one tenant hammering direct writes far over
    # its token rate — this is what the fleet must shed
    "abusive": Profile("abusive", p_edit=1.0, burst=4, direct=True),
}

# population mix: (profile, weight)
_DEFAULT_MIX = (
    ("edit", 4), ("idle", 4), ("reconnect", 1), ("lossy", 1),
    ("abusive", 2),
)

# all-interactive population for capacity ramps (obs/capacity.py): every
# session is an editor whose visibility latency the SLO verdict watches
INTERACTIVE_MIX = (("edit", 1),)


class LoadGenConfig:
    """Shape of one load-generation run."""

    __slots__ = (
        "seed", "n_clients", "mix", "flush_every", "root_name",
        "session_config", "drain_max_ticks", "slo_target_ms",
    )

    def __init__(
        self,
        seed: int = 0,
        n_clients: int = 24,
        mix=_DEFAULT_MIX,
        flush_every: int = 2,
        root_name: str = "text",
        session_config: SessionConfig | None = None,
        drain_max_ticks: int = 3000,
        slo_target_ms: float = 5000.0,
    ):
        self.seed = int(seed)
        self.n_clients = max(1, int(n_clients))
        self.mix = tuple(mix)
        self.flush_every = max(1, int(flush_every))
        self.root_name = root_name
        self.session_config = session_config or SessionConfig(
            retry_base=2, retry_cap=16, retry_max=8, retry_jitter=0.25,
            antientropy=16, heartbeat=0, liveness=0, hello_timeout=0,
        )
        self.drain_max_ticks = max(1, int(drain_max_ticks))
        # the convergence SLO target is wall-clock (250 ms production
        # default) but this harness is tick-driven: a pure-Python tick
        # loop legitimately spends hundreds of ms per flush interval, so
        # the production target would page on simulation speed, not on
        # starvation.  Rescale it to the harness (a wedged fleet still
        # pages at 5 s); tick-deterministic interactive latency is
        # measured by the visibility probes instead.
        self.slo_target_ms = float(slo_target_ms)


class _Client:
    """Common writer state: one local Doc, one owned guid."""

    def __init__(self, lg: "LoadGen", idx: int, profile: Profile):
        self.lg = lg
        self.idx = idx
        self.profile = profile
        tenant = "abuser" if profile.direct else f"tenant{idx % 4}"
        self.tenant = tenant
        self.guid = f"{tenant}/{profile.name}-{idx}"
        self.rng = random.Random((lg.config.seed * 1000003) ^ (idx * 7919))
        self.doc = Doc(gc=False)
        self.doc.client_id = idx + 1
        self.n_edits = 0
        # outstanding visibility probe: (sent_tick, local_text_len)
        self.probe: tuple[int, int] | None = None
        self.latencies: list[int] = []

    @property
    def text(self) -> str:
        return str(self.doc.get_text(self.lg.config.root_name))

    def edit(self, tick: int) -> bool:
        if self.rng.random() >= self.profile.p_edit:
            return False
        t = self.doc.get_text(self.lg.config.root_name)
        for _ in range(self.profile.burst):
            t.insert(len(t), self.rng.choice(_ALPHABET))
            self.n_edits += 1
        if self.profile.interactive and self.probe is None:
            self.probe = (tick, len(t))
        return True

    def check_probe(self, tick: int) -> None:
        if self.probe is None:
            return
        sent, want = self.probe
        try:
            visible = len(self.lg.server.text(self.guid))
        except Exception:
            return
        if visible >= want:
            self.latencies.append(tick - sent)
            self.probe = None

    def settle_probe(self, tick: int) -> None:
        """Drain-phase bound: an unanswered probe scores its final age
        so a stalled doc cannot silently vanish from the p99."""
        if self.probe is not None:
            self.latencies.append(tick - self.probe[0])
            self.probe = None


class _DirectClient(_Client):
    """No session: push cumulative deltas straight into the server's
    ``receive_update`` seam and honor typed rejections by retrying the
    (now larger) delta after the advertised retry window.  An accepted
    push is an ACK — the server owns those bytes from that moment."""

    def __init__(self, lg, idx, profile):
        super().__init__(lg, idx, profile)
        from .updates import encode_state_as_update, encode_state_vector

        self._encode_delta = encode_state_as_update
        self._encode_sv = encode_state_vector
        self._acked_sv: bytes | None = None
        self._next_try = 0
        self.n_acked = 0
        self.n_rejected = 0

    def dirty(self) -> bool:
        return self._acked_sv != self._encode_sv(self.doc)

    def push(self, tick: int) -> None:
        if tick < self._next_try or not self.dirty():
            return
        delta = self._encode_delta(self.doc, self._acked_sv)
        try:
            accepted = self.lg.server.receive_update(self.guid, delta)
        except AdmissionRejected as e:
            self.n_rejected += 1
            self._next_try = tick + max(1, e.retry_after)
            return
        except Exception:
            # shard down mid-failover / fleet full: back off and retry
            # the cumulative delta — the CRDT makes the re-push free
            self._next_try = tick + 4
            return
        if accepted:
            self.n_acked += 1
            self._acked_sv = self._encode_sv(self.doc)

    def tick(self, tick: int) -> None:
        self.push(tick)


class _SessionClient(_Client):
    """Real enhanced-envelope session over an in-memory pipe, optionally
    behind the network fault injector, optionally flapping its transport
    on a cadence (reconnect profile)."""

    def __init__(self, lg, idx, profile):
        super().__init__(lg, idx, profile)
        inj = None
        if profile.faults:
            inj = NetworkFaultInjector(NetChaosConfig(
                seed=(lg.config.seed * 31 + idx) & 0x7FFFFFFF,
                **profile.faults,
            ))
        self.net = PipeNetwork(inj)
        self.session = SyncSession(
            DocSessionHost(self.doc), lg.config.session_config,
            peer="server",
        )
        self.doc.on("update", self._relay)
        self.server_session = lg.server.session(
            self.guid, f"client-{idx}", lg.config.session_config
        )
        self._connect(first=True)

    def _relay(self, update, origin, _doc):
        if origin is not self.session.host:
            self.session.send_update(bytes(update))

    def _connect(self, first: bool = False) -> None:
        ta, tb = self.net.pair(f"c{self.idx}", "srv")
        if first:
            self.session.connect(ta)
            self.server_session.connect(tb)
        else:
            self.session.attach(ta)
            self.server_session.attach(tb)

    def maybe_reconnect(self, tick: int) -> None:
        every = self.profile.reconnect_every
        if every and tick and tick % every == 0:
            self.net.kill(self.session.transport,
                          self.server_session.transport)
            self._connect()

    def tick(self, tick: int) -> None:
        self.maybe_reconnect(tick)
        self.net.pump()
        self.session.tick()

    def settled(self) -> bool:
        return (
            self.net.in_flight == 0
            and not self.session._outbox
            and not self.server_session._outbox
        )


class LoadGen:
    """Drive a mixed-profile population against ``server`` (a
    :class:`~yjs_tpu_torch.provider.TpuProvider` or
    :class:`~yjs_tpu_torch.fleet.FleetRouter`) for a seeded, reproducible
    number of ticks, then :meth:`drain` to quiescence and read the
    invariants off :meth:`report`."""

    def __init__(self, server, config: LoadGenConfig | None = None):
        self.server = server
        self.config = config or LoadGenConfig()
        # the harness owns its convergence accounting: rescale the
        # wall-clock SLO target to harness speed AND give the fleet a
        # private origin clock — the process-global one may carry
        # first-sighting stamps for byte-identical updates emitted by
        # earlier (seeded, hence colliding) runs in this process, which
        # would read as minutes-old origins and page the SLO forever
        from .obs.slo import OriginClock

        origins = OriginClock()
        for p in getattr(server, "shards", [server]):
            slo = getattr(p, "slo", None)
            if slo is not None:
                slo._origins = origins
                if self.config.slo_target_ms:
                    slo.target_ms = self.config.slo_target_ms
        self.tick = 0
        self.level_history: list[int] = []
        self.slo_page_ticks = 0
        self.recovery_ticks: int | None = None
        self.clients: list[_Client] = []
        weighted = [
            name for name, w in self.config.mix for _ in range(w)
        ]
        for i in range(self.config.n_clients):
            profile = PROFILES[weighted[i % len(weighted)]]
            cls = _DirectClient if profile.direct else _SessionClient
            self.clients.append(cls(self, i, profile))
        self._interactive = [
            c for c in self.clients if c.profile.interactive
        ]

    # -- capacity arithmetic ------------------------------------------------

    def offered_per_tick(self) -> float:
        return sum(c.profile.p_edit * c.profile.burst
                   for c in self.clients)

    def capacity_per_tick(self) -> float:
        """Sustained admission capacity: per-tenant token rate summed
        over the distinct tenants this population uses."""
        adm = self.server.admission
        tenants = {c.tenant for c in self.clients}
        return adm.config.tenant_rate * max(1, len(tenants))

    def overload_factor(self) -> float:
        cap = self.capacity_per_tick()
        return self.offered_per_tick() / cap if cap else float("inf")

    # -- tick loop ----------------------------------------------------------

    def _tick_server(self) -> None:
        srv = self.server
        tick_fleet = getattr(srv, "tick", None)
        if callable(tick_fleet):
            tick_fleet()
        else:
            srv.tick_sessions()

    def _flush_interval(self) -> int:
        scale = self.server.admission.flush_interval_scale
        return max(1, round(self.config.flush_every * scale))

    def step(self, editing: bool = True, on_tick=None) -> None:
        """One deterministic tick: edits, direct pushes, pumps, session
        ticks, the server tick (admission clock included), and a flush
        on the brownout-scaled cadence."""
        self.tick += 1
        for c in self.clients:
            if editing:
                c.edit(self.tick)
            c.tick(self.tick)
        self._tick_server()
        adm = self.server.admission
        self.level_history.append(adm.level)
        if self._worst_slo() == "page":
            self.slo_page_ticks += 1
        if self.tick % self._flush_interval() == 0:
            self.server.flush()
            for c in self._interactive:
                c.check_probe(self.tick)
        if on_tick is not None:
            on_tick(self)

    def run(self, ticks: int, on_tick=None) -> "LoadGen":
        for _ in range(ticks):
            self.step(editing=True, on_tick=on_tick)
        return self

    def _worst_slo(self) -> str:
        rank = {"ok": 0, "warning": 1, "page": 2}
        worst = "ok"
        for p in getattr(self.server, "shards", [self.server]):
            try:
                st = p.slo.state()
            except Exception:
                continue
            if rank.get(st, 0) > rank.get(worst, 0):
                worst = st
        return worst

    # -- drain / quiescence --------------------------------------------------

    def _converged(self) -> bool:
        adm = self.server.admission
        if adm.queue_depth():
            return False
        for c in self.clients:
            if isinstance(c, _DirectClient):
                if c.dirty():
                    return False
            elif not c.settled():
                return False
        return True

    def drain(self) -> int:
        """Stop editing, keep the machinery ticking until every client's
        traffic is fully integrated AND the brownout level is back to
        ``normal``.  Returns recovery ticks (load-stop → level normal);
        raises if the fleet cannot quiesce inside ``drain_max_ticks``."""
        start = self.tick
        recovered_at = None
        for _ in range(self.config.drain_max_ticks):
            self.step(editing=False)
            if recovered_at is None and self.server.admission.level == 0:
                recovered_at = self.tick
            if self._converged() and recovered_at is not None:
                break
        else:
            raise AssertionError(
                f"loadgen failed to quiesce in "
                f"{self.config.drain_max_ticks} ticks "
                f"(seed {self.config.seed}): "
                f"{self.server.admission.snapshot()}"
            )
        # a few settle laps for in-flight anti-entropy repairs
        for _ in range(8):
            self.step(editing=False)
        self.server.flush()
        for c in self._interactive:
            c.check_probe(self.tick)
            c.settle_probe(self.tick)
        self.recovery_ticks = (recovered_at or self.tick) - start
        return self.recovery_ticks

    # -- invariants ----------------------------------------------------------

    def convergence_failures(self) -> list[dict]:
        """Byte-identical check, one writer per doc: server text must
        equal the writer's local text exactly."""
        out = []
        for c in self.clients:
            server_text = self.server.text(c.guid)
            if server_text != c.text:
                out.append({
                    "guid": c.guid, "profile": c.profile.name,
                    "server_len": len(server_text),
                    "client_len": len(c.text),
                })
        return out

    def interactive_p99(self) -> int:
        lat = sorted(
            x for c in self._interactive for x in c.latencies
        )
        if not lat:
            return 0
        return lat[min(len(lat) - 1, int(0.99 * (len(lat) - 1)))]

    def report(self) -> dict:
        adm = self.server.admission.snapshot()
        offered = max(1, adm["offered"])
        rejected = sum(adm["rejected"].values())
        full_resyncs = sorted({
            c.session.n_full_resyncs for c in self.clients
            if isinstance(c, _SessionClient)
        })
        return {
            "seed": self.config.seed,
            "ticks": self.tick,
            "clients": len(self.clients),
            "profiles": {
                name: sum(
                    1 for c in self.clients if c.profile.name == name
                )
                for name, _w in self.config.mix
            },
            "edits": sum(c.n_edits for c in self.clients),
            "overload_factor": round(self.overload_factor(), 3),
            "shed_fraction": round(
                (adm["queued"] + rejected) / offered, 4
            ),
            "reject_rate": round(rejected / offered, 4),
            "interactive_p99_ticks": self.interactive_p99(),
            "slo_page_ticks": self.slo_page_ticks,
            "max_level": max(self.level_history, default=0),
            "transitions": adm["brownout"]["transitions"],
            "recovery_ticks": self.recovery_ticks,
            "convergence_failures": self.convergence_failures(),
            "session_full_resyncs": full_resyncs,
            "admission": adm,
        }

    def assert_invariants(self, max_interactive_p99: int | None = None):
        """The overload acceptance bundle: zero acked loss / byte
        identity, interactive SLO never paged, bounded recovery."""
        rep = self.report()
        assert not rep["convergence_failures"], (
            f"acked-update loss or divergence (seed {rep['seed']}): "
            f"{rep['convergence_failures']}"
        )
        assert rep["slo_page_ticks"] == 0, (
            f"interactive SLO paged for {rep['slo_page_ticks']} ticks "
            f"(seed {rep['seed']})"
        )
        assert self.server.admission.level == 0, (
            f"brownout never recovered (seed {rep['seed']}): "
            f"{rep['admission']['brownout']}"
        )
        if max_interactive_p99 is not None:
            assert rep["interactive_p99_ticks"] <= max_interactive_p99, (
                f"interactive p99 {rep['interactive_p99_ticks']} > "
                f"{max_interactive_p99} (seed {rep['seed']})"
            )
        return rep
