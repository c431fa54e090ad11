"""Lamport-timestamp identity: ``ID(client, clock)``.

Mirrors the semantics of reference src/utils/ID.js:8-69.  Every CRDT struct is
addressed by the pair (client, clock); clocks are per-client, contiguous, and
count UTF-16 content units.
"""

from __future__ import annotations

from .lib0 import decoding, encoding


class ID:
    __slots__ = ("client", "clock")

    def __init__(self, client: int, clock: int):
        self.client = client
        self.clock = clock

    def __repr__(self):
        return f"ID({self.client},{self.clock})"

    def __eq__(self, other):
        return (
            isinstance(other, ID)
            and other.client == self.client
            and other.clock == self.clock
        )

    def __hash__(self):
        return hash((self.client, self.clock))


def create_id(client: int, clock: int) -> ID:
    return ID(client, clock)


def compare_ids(a: ID | None, b: ID | None) -> bool:
    return a is b or (
        a is not None and b is not None and a.client == b.client and a.clock == b.clock
    )


def write_id(encoder: encoding.Encoder, id: ID) -> None:
    encoding.write_var_uint(encoder, id.client)
    encoding.write_var_uint(encoder, id.clock)


def read_id(decoder: decoding.Decoder) -> ID:
    return ID(decoding.read_var_uint(decoder), decoding.read_var_uint(decoder))


def find_root_type_key(type_) -> str:
    """Reverse lookup of a root type's key in ``doc.share``
    (reference src/utils/ID.js:82-90)."""
    for key, value in type_.doc.share.items():
        if value is type_:
            return key
    raise RuntimeError("root type not found in doc.share")
