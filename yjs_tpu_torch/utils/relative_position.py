"""RelativePosition: stable cursors that survive concurrent edits
(reference src/utils/RelativePosition.js)."""

from __future__ import annotations

from ..core import ContentType, Item, follow_redone, get_state
from ..ids import ID, compare_ids, create_id, find_root_type_key, read_id, write_id
from ..lib0 import decoding, encoding
from ..lib0.decoding import Decoder
from ..lib0.encoding import Encoder


class RelativePosition:
    __slots__ = ("type", "tname", "item")

    def __init__(self, type_: ID | None, tname: str | None, item: ID | None):
        self.type = type_
        self.tname = tname
        self.item = item

    def to_json(self) -> dict:
        out = {}
        if self.type is not None:
            out["type"] = {"client": self.type.client, "clock": self.type.clock}
        if self.tname is not None:
            out["tname"] = self.tname
        if self.item is not None:
            out["item"] = {"client": self.item.client, "clock": self.item.clock}
        return out


def create_relative_position_from_json(json: dict) -> RelativePosition:
    type_ = json.get("type")
    item = json.get("item")
    return RelativePosition(
        create_id(type_["client"], type_["clock"]) if type_ else None,
        json.get("tname") or None,
        create_id(item["client"], item["clock"]) if item else None,
    )


class AbsolutePosition:
    __slots__ = ("type", "index")

    def __init__(self, type_, index: int):
        self.type = type_
        self.index = index


def create_absolute_position(type_, index: int) -> AbsolutePosition:
    return AbsolutePosition(type_, index)


def create_relative_position(type_, item: ID | None) -> RelativePosition:
    typeid = None
    tname = None
    if type_._item is None:
        tname = find_root_type_key(type_)
    else:
        typeid = create_id(type_._item.id.client, type_._item.id.clock)
    return RelativePosition(typeid, tname, item)


def create_relative_position_from_type_index(type_, index: int) -> RelativePosition:
    t = type_._start
    while t is not None:
        if not t.deleted and t.countable:
            if t.length > index:
                # found the position inside the list
                return create_relative_position(type_, create_id(t.id.client, t.id.clock + index))
            index -= t.length
        t = t.right
    return create_relative_position(type_, None)


def write_relative_position(encoder: Encoder, rpos: RelativePosition) -> Encoder:
    if rpos.item is not None:
        encoding.write_var_uint(encoder, 0)
        write_id(encoder, rpos.item)
    elif rpos.tname is not None:
        # position at end of list; type stored in doc.share
        encoding.write_uint8(encoder, 1)
        encoding.write_var_string(encoder, rpos.tname)
    elif rpos.type is not None:
        # position at end of list; type attached to an item
        encoding.write_uint8(encoder, 2)
        write_id(encoder, rpos.type)
    else:
        raise RuntimeError("invalid relative position")
    return encoder


def encode_relative_position(rpos: RelativePosition) -> bytes:
    encoder = Encoder()
    write_relative_position(encoder, rpos)
    return encoder.to_bytes()


def read_relative_position(decoder: Decoder) -> RelativePosition:
    type_ = None
    tname = None
    item_id = None
    case = decoding.read_var_uint(decoder)
    if case == 0:
        item_id = read_id(decoder)
    elif case == 1:
        tname = decoding.read_var_string(decoder)
    elif case == 2:
        type_ = read_id(decoder)
    return RelativePosition(type_, tname, item_id)


def decode_relative_position(buf: bytes) -> RelativePosition:
    return read_relative_position(Decoder(buf))


def create_absolute_position_from_relative_position(rpos: RelativePosition, doc) -> AbsolutePosition | None:
    """(reference RelativePosition.js:214-262)."""
    store = doc.store
    right_id = rpos.item
    type_id = rpos.type
    tname = rpos.tname
    type_ = None
    index = 0
    if right_id is not None:
        if get_state(store, right_id.client) <= right_id.clock:
            return None
        right, diff = follow_redone(store, right_id)
        if type(right) is not Item:
            return None
        type_ = right.parent
        if type_._item is None or not type_._item.deleted:
            index = 0 if right.deleted or not right.countable else diff
            n = right.left
            while n is not None:
                if not n.deleted and n.countable:
                    index += n.length
                n = n.left
    else:
        if tname is not None:
            type_ = doc.get(tname)
        elif type_id is not None:
            if get_state(store, type_id.client) <= type_id.clock:
                # type does not exist yet
                return None
            item, _ = follow_redone(store, type_id)
            if type(item) is Item and type(item.content) is ContentType:
                type_ = item.content.type
            else:
                # garbage collected
                return None
        else:
            raise RuntimeError("invalid relative position")
        index = type_._length
    return create_absolute_position(type_, index)


def compare_relative_positions(a: RelativePosition | None, b: RelativePosition | None) -> bool:
    return a is b or (
        a is not None
        and b is not None
        and a.tname == b.tname
        and compare_ids(a.item, b.item)
        and compare_ids(a.type, b.type)
    )
