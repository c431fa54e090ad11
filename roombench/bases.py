"""Room histories: read the fixtures a configuration names, check their
sha256, and integrate each distinct history once with the plain reference.

A :class:`Base` is one integrated history in compact form: its item ids in
document order, which are deleted, their characters, origins, the state
vector and the delete set.  The traffic generator places keystrokes by it;
the correctness check rebuilds a :class:`~.ytext.TextDoc` from it and
integrates the keystrokes that were sent.

The bases depend only on the pinned fixture and the reference's code, so
:func:`integrated` keeps them in the checkout's ``.roombench_cache/``,
keyed by both: the first run of a checkout integrates, later runs load.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import struct
import zlib
from array import array

from .ytext import END, HEAD, TextDoc


HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(os.path.dirname(HERE), ".roombench_cache")


class FixtureError(ValueError):
    pass


def read_fixture(root: str, spec: dict) -> bytes:
    """The fixture's bytes, refused unless their sha256 is the pinned one."""
    path = os.path.join(root, spec["fixture"])
    with open(path, "rb") as f:
        raw = f.read()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != spec["sha256"]:
        raise FixtureError(f"{spec['fixture']}: sha256 {digest}, pinned {spec['sha256']}")
    return raw


def histories(root: str, spec: dict) -> list[bytes]:
    """The distinct history updates a configuration's fixture holds."""
    raw = read_fixture(root, spec)
    if spec["format"] == "update":
        return [raw]
    if spec["format"] == "traces":  # zlib: <u32 n><u32 ops> then [<u32 len><update>]*n
        raw = zlib.decompress(raw)
        n, _ops = struct.unpack_from("<II", raw, 0)
        off = 8
        out = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<I", raw, off)
            off += 4
            out.append(raw[off:off + ln])
            off += ln
        if off != len(raw):
            raise FixtureError(f"{spec['fixture']}: {len(raw) - off} trailing bytes")
        return out
    raise FixtureError(f"unknown fixture format {spec['format']!r}")


class Base:
    """One integrated history, compact (see the module docstring)."""

    __slots__ = ("ids", "dead", "chars", "origins", "rights", "sv", "ds")

    def __init__(self, ids, dead, chars, origins, rights, sv, ds):
        self.ids = ids          # array('q'): item ids in document order
        self.dead = dead        # bytes: 1 where the item is deleted
        self.chars = chars      # str: each item's character (deleted too)
        self.origins = origins  # array('q'): origin id, HEAD for none
        self.rights = rights    # array('q'): right origin id, END for none
        self.sv = sv            # dict client -> clock
        self.ds = ds            # frozenset of deleted ids

    @classmethod
    def of(cls, doc: TextDoc) -> "Base":
        if not doc.complete():
            raise FixtureError("history has structs with missing dependencies")
        order = doc.ordered()
        return cls(
            array("q", order),
            bytes(map(doc.deleted.__contains__, order)),
            "".join(map(doc.chars.__getitem__, order)),
            array("q", map(doc.origin.__getitem__, order)),
            array("q", map(doc.right.__getitem__, order)),
            dict(doc.sv),
            frozenset(doc.deleted),
        )

    def textdoc(self, root: str) -> TextDoc:
        """The history as a fresh :class:`TextDoc`."""
        d = TextDoc(root)
        ids = self.ids.tolist()
        nxt = d.nxt
        prev = HEAD
        for i in ids:
            nxt[prev] = i
            prev = i
        nxt[prev] = END
        d.origin = dict(zip(ids, self.origins))
        d.right = dict(zip(ids, self.rights))
        d.chars = dict(zip(ids, self.chars))
        d.deleted = set(self.ds)
        d.sv = dict(self.sv)
        return d


def integrate(job: tuple[bytes, str]) -> Base:
    """One history (``(update, root name)``) integrated by the reference."""
    history, root = job
    doc = TextDoc(root)
    doc.apply_update(history)
    return Base.of(doc)


def _cache_path(spec: dict, root: str) -> str:
    """The cache file of a fixture's bases: named by the fixture's pinned
    sha256, the root type's name and the reference's own source."""
    h = hashlib.sha256(f"{spec['sha256']}/{root}".encode())
    for name in ("bases.py", "ytext.py", "ycodec.py"):
        with open(os.path.join(HERE, name), "rb") as f:
            h.update(f.read())
    return os.path.join(CACHE, f"bases-{h.hexdigest()[:32]}.pickle")


def integrated(spec: dict, history: list[bytes], root: str, needed,
               pool_map) -> list:
    """``bases[h]`` for each history ``h`` in ``needed`` (None for the
    rest): loaded from the cache, the missing ones integrated with
    ``pool_map(integrate, jobs)`` and the cache rewritten."""
    path = _cache_path(spec, root)
    try:
        with open(path, "rb") as f:
            have: dict = pickle.load(f)
    except FileNotFoundError:
        have = {}
    todo = sorted(set(needed) - set(have))
    if todo:
        for h, b in zip(todo, pool_map(integrate, [(history[h], root) for h in todo])):
            have[h] = b
        os.makedirs(CACHE, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.part"
        with open(tmp, "wb") as f:
            pickle.dump(have, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    out = [None] * len(history)
    for h in needed:
        out[h] = have[h]
    return out
