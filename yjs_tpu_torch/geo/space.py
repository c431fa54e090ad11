"""Doc-space codecs + the session host seam for inter-region links.

A geo link peers per doc-SPACE, not per doc: one type-121
:class:`~yjs_tpu_torch.sync.session.SyncSession` carries every room a region
holds, so N regions x M docs costs N-1 sessions per region instead of
(N-1) x M.  The session machinery is reused byte-for-byte — seq/ack,
retransmit backoff, resume-vs-full-resync handshakes, digests — by
giving it a host whose "state vector" and "updates" are COMPOSITE:

    space state vector:   varint n | n x (varstring guid,
                                         varint8array per-doc sv)
    space update payload: varint n | n x (varstring guid,
                                          varint8array per-doc update)

Composite payloads ride the wire inside the ordinary
``MESSAGE_YJS_UPDATE`` framing the session already wraps around inner
frames, so nothing in session.py knows the difference; only the two
seams that PARSE host bytes (the anti-entropy digest comparison and the
inbound frame handler) are overridden — see
:class:`~yjs_tpu_torch.geo.replicator.GeoSession` and
:meth:`SpaceSessionHost.handle_frame`.
"""

from __future__ import annotations

from ..coding import default_ds_encoder
from ..lib0 import decoding, encoding
from ..lib0.decoding import Decoder
from ..lib0.encoding import Encoder
from ..obs import dist as obs_dist
from ..obs.blackbox import flight_recorder
from ..sync import protocol
from ..updates import decode_state_vector, write_state_vector

__all__ = [
    "SpaceSessionHost",
    "decode_space_sv",
    "decode_space_update",
    "encode_space_sv",
    "encode_space_update",
]


def _sv_bytes(sv: dict[int, int]) -> bytes:
    enc = default_ds_encoder()
    write_state_vector(enc, sv)
    return enc.to_bytes()


def encode_space_sv(svs: dict[str, dict[int, int]]) -> bytes:
    """``{guid: per-doc sv dict}`` -> composite space state vector."""
    enc = Encoder()
    encoding.write_var_uint(enc, len(svs))
    for guid in sorted(svs):
        encoding.write_var_string(enc, guid)
        encoding.write_var_uint8_array(enc, _sv_bytes(svs[guid]))
    return enc.to_bytes()


def decode_space_sv(data: bytes | None) -> dict[str, dict[int, int]]:
    """Inverse of :func:`encode_space_sv`.  Empty/absent/unparseable
    bytes decode to ``{}`` ("the peer has nothing"), which makes every
    doc look ahead — the safe direction: the diff then carries full
    state and the CRDT merge absorbs any overlap."""
    if not data:
        return {}
    out: dict[str, dict[int, int]] = {}
    try:
        dec = Decoder(bytes(data))
        n = decoding.read_var_uint(dec)
        for _ in range(n):
            guid = decoding.read_var_string(dec)
            out[guid] = decode_state_vector(
                bytes(decoding.read_var_uint8_array(dec))
            )
    except Exception:
        return {}
    return out


def encode_space_update(parts: list[tuple[str, bytes]]) -> bytes:
    """``[(guid, update bytes), ...]`` -> composite space update."""
    enc = Encoder()
    encoding.write_var_uint(enc, len(parts))
    for guid, upd in parts:
        encoding.write_var_string(enc, guid)
        encoding.write_var_uint8_array(enc, upd)
    return enc.to_bytes()


def decode_space_update(data: bytes) -> list[tuple[str, bytes]]:
    """Inverse of :func:`encode_space_update`.  Raises on malformed
    bytes — the caller dead-letters (session transports are content-
    clean by the chaos detectability contract, so a parse failure here
    is a real bug, not line noise)."""
    dec = Decoder(bytes(data))
    n = decoding.read_var_uint(dec)
    out = []
    for _ in range(n):
        guid = decoding.read_var_string(dec)
        out.append((guid, bytes(decoding.read_var_uint8_array(dec))))
    return out


# a V1 update of "nothing" (0 struct clients + empty delete set)
_EMPTY_UPDATE_LEN = 2


class SpaceSessionHost:
    """The :class:`~yjs_tpu_torch.sync.session.SyncSession` host seam served
    by a whole region facade (a :class:`~yjs_tpu_torch.provider.TpuProvider`,
    a :class:`~yjs_tpu_torch.fleet.FleetRouter`, or a cluster
    supervisor) instead of one room.

    The facade needs: ``receive_update(guid, update, internal=True)``,
    a per-doc state-vector surface (``state_vector(guid) -> dict`` or
    ``state_vector_bytes(guid) -> bytes``), and a per-doc diff surface
    (``encode_state_as_update(guid, sv)`` or ``diff_update(guid, sv)``)
    — both spellings are probed so every existing facade qualifies
    without change.  Doc discovery prefers ``facade.guids()``; facades
    without one (the RPC supervisor) fall back to the tracked set the
    replicator feeds from its update bridge and remote applies.
    """

    __slots__ = ("facade", "link", "_tracked")

    def __init__(self, facade, link=None):
        self.facade = facade
        self.link = link  # GeoLink back-pointer (floors, loss counting)
        self._tracked: set[str] = set()

    # -- doc discovery -------------------------------------------------------

    def track(self, guid: str) -> None:
        self._tracked.add(guid)

    def docs(self) -> list[str]:
        fn = getattr(self.facade, "guids", None)
        if callable(fn):
            names = set(fn())
        else:
            names = set()
            shards = getattr(self.facade, "shards", None)
            if shards:
                for p in shards:
                    try:
                        names.update(p.guids())
                    except Exception:
                        continue  # a dead shard hides nothing durable
        names.update(self._tracked)
        return sorted(names)

    # -- per-doc facade adapters ---------------------------------------------

    def _doc_sv_bytes(self, guid: str) -> bytes:
        fn = getattr(self.facade, "state_vector_bytes", None)
        if fn is not None:
            return fn(guid)
        return _sv_bytes(self.facade.state_vector(guid))

    def _doc_diff(self, guid: str, sv: bytes | None) -> bytes:
        fn = getattr(self.facade, "encode_state_as_update", None)
        if fn is not None:
            return fn(guid, sv if sv else None)
        return self.facade.diff_update(guid, sv if sv else None)

    # -- the session host seam -----------------------------------------------

    def state_vector(self) -> bytes:
        svs = {}
        for guid in self.docs():
            try:
                svs[guid] = decode_state_vector(self._doc_sv_bytes(guid))
            except Exception:
                continue
        return encode_space_sv(svs)

    def diff_update(self, sv: bytes | None) -> bytes:
        """Composite diff: per doc, everything the peer space's sv says
        it lacks.  Docs the peer has never heard of ship full state."""
        theirs = decode_space_sv(sv)
        parts: list[tuple[str, bytes]] = []
        for guid in self.docs():
            target = theirs.get(guid)
            try:
                upd = self._doc_diff(
                    guid, encode_sv_dict(target) if target else None
                )
            except Exception:
                continue
            if len(upd) > _EMPTY_UPDATE_LEN:
                parts.append((guid, upd))
        return encode_space_update(parts)

    def ahead_behind(self, peer_sv: bytes) -> tuple[bool, bool]:
        """The digest comparison at space granularity (the stock
        session parses its host's sv as ONE doc vector, which composite
        bytes are not — :class:`GeoSession` routes here instead)."""
        theirs = decode_space_sv(peer_sv)
        ahead = behind = False
        seen = set()
        for guid in self.docs():
            seen.add(guid)
            try:
                mine = decode_state_vector(self._doc_sv_bytes(guid))
            except Exception:
                continue
            t = theirs.get(guid, {})
            if any(c > t.get(k, 0) for k, c in mine.items()):
                ahead = True
            if any(c > mine.get(k, 0) for k, c in t.items()):
                behind = True
            if ahead and behind:
                return True, True
        # docs only the peer holds: we are behind on those
        if any(g not in seen for g in theirs):
            behind = True
        return ahead, behind

    def apply_update(self, payload: bytes) -> None:
        """Integrate one composite payload: per doc, through the
        region's normal ingress (``internal=True`` — WAN replication is
        already-admitted traffic, like migration and failover state
        transfer).  Emits the ``flow_end`` half of the cross-region
        Perfetto arrow minted by the sending link."""
        link = self.link
        for guid, upd in decode_space_update(payload):
            self.track(guid)
            if link is not None:
                link.note_remote_apply(guid, upd)
            self.facade.receive_update(guid, upd, internal=True)

    def handle_frame(self, frame: bytes) -> bytes | None:
        """Inbound inner frame from the peer session.  WAN links only
        ever wrap composite payloads in ``MESSAGE_YJS_UPDATE`` framing;
        anything else is tolerated-and-counted like the plain reader."""
        try:
            dec = Decoder(bytes(frame))
            mtype = decoding.read_var_uint(dec)
            if mtype != protocol.MESSAGE_YJS_UPDATE:
                return None
            payload = bytes(decoding.read_var_uint8_array(dec))
        except Exception:
            self.dead_letter(frame, "geo-bad-frame")
            return None
        self.apply_update(payload)
        return None

    def dead_letter(self, payload: bytes, reason: str) -> None:
        """A frame the link layer gave up on.  There is no single room
        to attribute it to, so it lands in the blackbox (force-sampled
        by the session's retry-cap path) and on the link's loss
        counter; the anti-entropy digest owns the repair."""
        ctx = obs_dist.current_context()
        if ctx is not None:
            # loss evidence must survive production sampling rates
            ctx = ctx.force("geo-link-dead-letter")
        flight_recorder().record(
            "geo", "link_dead_letter", severity="warning",
            trace=(ctx.trace_hex if ctx is not None else None),
            peer=(self.link.region if self.link is not None else None),
            reason=reason, size=len(payload),
        )
        if self.link is not None:
            self.link.note_dead_letter(reason)

    def journal_ack(self, sid: int, seq: int) -> None:
        if self.link is not None:
            self.link.on_recv_floor(sid, seq)


def encode_sv_dict(sv: dict[int, int]) -> bytes:
    """Public spelling of the per-doc sv dict -> bytes encoder (the
    replicator's delta scheduler uses it for diff targets)."""
    return _sv_bytes(sv)
