"""Core CRDT runtime: identity structs, store, transactions, documents.

This is the CPU reference implementation of the YATA list CRDT with compound
(run-length) items, semantically equivalent to the reference JavaScript
implementation (yjs v13.4.9):

- Item / GC structs ............ reference src/structs/Item.js, GC.js
- Content classes .............. reference src/structs/Content*.js
- StructStore .................. reference src/utils/StructStore.js
- DeleteSet .................... reference src/utils/DeleteSet.js
- Transaction / transact ....... reference src/utils/Transaction.js
- Doc .......................... reference src/utils/Doc.js

It doubles as the conformance oracle for the TPU batch engine in
``yjs_tpu/ops`` (the same role the JS path plays for the reference's
north-star provider design, see BASELINE.json).
"""

from __future__ import annotations

import random as _random

from .ids import ID, compare_ids, create_id, find_root_type_key
from .lib0.binary import BIT1, BIT2, BIT3, BIT4, BIT6, BIT7, BIT8, BITS5
from .lib0.encoding import UNDEFINED
from .lib0.observable import Observable
from .lib0.u16 import from_u16

# ---------------------------------------------------------------------------
# Event handler (reference src/utils/EventHandler.js)
# ---------------------------------------------------------------------------


class EventHandler:
    __slots__ = ("l",)

    def __init__(self):
        self.l = []


def create_event_handler() -> EventHandler:
    return EventHandler()


def add_event_handler_listener(handler: EventHandler, f) -> None:
    handler.l.append(f)


def remove_event_handler_listener(handler: EventHandler, f) -> None:
    try:
        handler.l.remove(f)
    except ValueError:
        pass


def call_all(fs, args, i=0):
    """Call every function even if some throw (the last error propagates),
    processing entries appended during iteration (lib0/function.callAll)."""
    try:
        while i < len(fs):
            fs[i](*args)
            i += 1
    finally:
        if i < len(fs):
            call_all(fs, args, i + 1)


def call_event_handler_listeners(handler: EventHandler, arg0, arg1) -> None:
    call_all(list(handler.l), [arg0, arg1])


# ---------------------------------------------------------------------------
# Struct base + GC (reference src/structs/AbstractStruct.js, GC.js)
# ---------------------------------------------------------------------------

GC_STRUCT_REF = 0


class AbstractStruct:
    """Struct contract shared by :class:`GC` and :class:`Item` (reference
    src/structs/AbstractStruct.js:10-45).  The concrete structs implement
    the whole surface themselves (``id``/``length``/``deleted``,
    ``merge_with``, ``integrate``, ``write``, ``get_missing``) — this base
    is the exported contract (reference src/index.js:17), carrying no
    state (``__slots__ = ()``) so it costs nothing at runtime."""

    __slots__ = ()

    def merge_with(self, right) -> bool:  # pragma: no cover - contract
        raise NotImplementedError

    def integrate(self, transaction, offset: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def write(self, encoder, offset: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def get_missing(self, transaction, store):  # pragma: no cover
        raise NotImplementedError


class GC(AbstractStruct):
    """Length-only tombstone struct; always deleted, merges unconditionally."""

    __slots__ = ("id", "length")

    def __init__(self, id: ID, length: int):
        self.id = id
        self.length = length

    deleted = True

    def delete(self, transaction) -> None:
        pass

    def merge_with(self, right: "GC") -> bool:
        self.length += right.length
        return True

    def integrate(self, transaction: "Transaction", offset: int) -> None:
        if offset > 0:
            self.id = create_id(self.id.client, self.id.clock + offset)
            self.length -= offset
        add_struct(transaction.doc.store, self)

    def write(self, encoder, offset: int) -> None:
        encoder.write_info(GC_STRUCT_REF)
        encoder.write_len(self.length - offset)

    def get_missing(self, transaction, store) -> int | None:
        return None


# ---------------------------------------------------------------------------
# Content classes (reference src/structs/Content*.js)
# ---------------------------------------------------------------------------


class ContentDeleted:
    """Ref 1: length-only content of an already-deleted item."""

    __slots__ = ("len",)
    REF = 1
    countable = False

    def __init__(self, ln: int):
        self.len = ln

    def get_length(self) -> int:
        return self.len

    def get_content(self):
        return []

    def copy(self):
        return ContentDeleted(self.len)

    def splice(self, offset: int):
        right = ContentDeleted(self.len - offset)
        self.len = offset
        return right

    def merge_with(self, right) -> bool:
        self.len += right.len
        return True

    def integrate(self, transaction, item) -> None:
        add_to_delete_set(transaction.delete_set, item.id.client, item.id.clock, self.len)
        item.mark_deleted()

    def delete(self, transaction) -> None:
        pass

    def gc(self, store) -> None:
        pass

    def write(self, encoder, offset: int) -> None:
        encoder.write_len(self.len - offset)


def read_content_deleted(decoder):
    return ContentDeleted(decoder.read_len())


class ContentJSON:
    """Ref 2: legacy JSON-string-encoded array content."""

    __slots__ = ("arr",)
    REF = 2
    countable = True

    def __init__(self, arr: list):
        self.arr = arr

    def get_length(self) -> int:
        return len(self.arr)

    def get_content(self):
        return self.arr

    def copy(self):
        return ContentJSON(self.arr)

    def splice(self, offset: int):
        right = ContentJSON(self.arr[offset:])
        self.arr = self.arr[:offset]
        return right

    def merge_with(self, right) -> bool:
        self.arr = self.arr + right.arr
        return True

    def integrate(self, transaction, item) -> None:
        pass

    def delete(self, transaction) -> None:
        pass

    def gc(self, store) -> None:
        pass

    def write(self, encoder, offset: int) -> None:
        encoder.write_len(len(self.arr) - offset)
        for i in range(offset, len(self.arr)):
            c = self.arr[i]
            encoder.write_string("undefined" if c is UNDEFINED else _json_stringify(c))


def read_content_json(decoder):
    cs = []
    for _ in range(decoder.read_len()):
        c = decoder.read_string()
        cs.append(UNDEFINED if c == "undefined" else _json_parse(c))
    return ContentJSON(cs)


class ContentBinary:
    """Ref 3: a single Uint8Array payload (length always 1)."""

    __slots__ = ("content",)
    REF = 3
    countable = True

    def __init__(self, content: bytes):
        self.content = content

    def get_length(self) -> int:
        return 1

    def get_content(self):
        return [self.content]

    def copy(self):
        return ContentBinary(self.content)

    def splice(self, offset: int):
        raise NotImplementedError

    def merge_with(self, right) -> bool:
        return False

    def integrate(self, transaction, item) -> None:
        pass

    def delete(self, transaction) -> None:
        pass

    def gc(self, store) -> None:
        pass

    def write(self, encoder, offset: int) -> None:
        encoder.write_buf(self.content)


def read_content_binary(decoder):
    return ContentBinary(decoder.read_buf())


class ContentString:
    """Ref 4: a text run.  ``str`` is stored in u16 form (see lib0/u16.py);
    splitting guards surrogate pairs by substituting U+FFFD
    (reference src/structs/ContentString.js:51-66)."""

    __slots__ = ("str",)
    REF = 4
    countable = True

    def __init__(self, s: str):
        self.str = s

    def get_length(self) -> int:
        return len(self.str)

    def get_content(self):
        return list(self.str)

    def copy(self):
        return ContentString(self.str)

    def splice(self, offset: int):
        right = ContentString(self.str[offset:])
        self.str = self.str[:offset]
        last = self.str[offset - 1] if offset > 0 else ""
        if last and 0xD800 <= ord(last) <= 0xDBFF:
            # never split a surrogate pair: replace both halves with U+FFFD
            self.str = self.str[: offset - 1] + "�"
            right.str = "�" + right.str[1:]
        return right

    def merge_with(self, right) -> bool:
        self.str += right.str
        return True

    def integrate(self, transaction, item) -> None:
        pass

    def delete(self, transaction) -> None:
        pass

    def gc(self, store) -> None:
        pass

    def write(self, encoder, offset: int) -> None:
        encoder.write_string(self.str if offset == 0 else self.str[offset:])


def read_content_string(decoder):
    return ContentString(decoder.read_string())


class ContentEmbed:
    """Ref 5: one embedded JSON object inside rich text."""

    __slots__ = ("embed",)
    REF = 5
    countable = True

    def __init__(self, embed):
        self.embed = embed

    def get_length(self) -> int:
        return 1

    def get_content(self):
        return [self.embed]

    def copy(self):
        return ContentEmbed(self.embed)

    def splice(self, offset: int):
        raise NotImplementedError

    def merge_with(self, right) -> bool:
        return False

    def integrate(self, transaction, item) -> None:
        pass

    def delete(self, transaction) -> None:
        pass

    def gc(self, store) -> None:
        pass

    def write(self, encoder, offset: int) -> None:
        encoder.write_json(self.embed)


def read_content_embed(decoder):
    return ContentEmbed(decoder.read_json())


class ContentFormat:
    """Ref 6: rich-text formatting marker; not countable
    (reference src/structs/ContentFormat.js:38-40)."""

    __slots__ = ("key", "value")
    REF = 6
    countable = False

    def __init__(self, key: str, value):
        self.key = key
        self.value = value

    def get_length(self) -> int:
        return 1

    def get_content(self):
        return []

    def copy(self):
        return ContentFormat(self.key, self.value)

    def splice(self, offset: int):
        raise NotImplementedError

    def merge_with(self, right) -> bool:
        return False

    def integrate(self, transaction, item) -> None:
        # formats invalidate the parent's search-marker index
        item.parent._search_marker = None

    def delete(self, transaction) -> None:
        pass

    def gc(self, store) -> None:
        pass

    def write(self, encoder, offset: int) -> None:
        encoder.write_key(self.key)
        encoder.write_json(self.value)


def read_content_format(decoder):
    return ContentFormat(decoder.read_string(), decoder.read_json())


# type-ref dispatch registry, filled by yjs_tpu.types at import time
# (reference src/structs/ContentType.js:19-35)
type_refs: list = [None] * 7

YARRAY_REF_ID = 0
YMAP_REF_ID = 1
YTEXT_REF_ID = 2
YXML_ELEMENT_REF_ID = 3
YXML_FRAGMENT_REF_ID = 4
YXML_HOOK_REF_ID = 5
YXML_TEXT_REF_ID = 6


class ContentType:
    """Ref 7: nests a shared type inside an item."""

    __slots__ = ("type",)
    REF = 7
    countable = True

    def __init__(self, type_):
        self.type = type_

    def get_length(self) -> int:
        return 1

    def get_content(self):
        return [self.type]

    def copy(self):
        return ContentType(self.type._copy())

    def splice(self, offset: int):
        raise NotImplementedError

    def merge_with(self, right) -> bool:
        return False

    def integrate(self, transaction, item) -> None:
        self.type._integrate(transaction.doc, item)

    def delete(self, transaction) -> None:
        # recursively delete children; already-deleted ones become merge
        # candidates (reference src/structs/ContentType.js:106-129)
        item = self.type._start
        while item is not None:
            if not item.deleted:
                item.delete(transaction)
            else:
                transaction._merge_structs.append(item)
            item = item.right
        for item in self.type._map.values():
            if not item.deleted:
                item.delete(transaction)
            else:
                transaction._merge_structs.append(item)
        transaction.changed.pop(self.type, None)

    def gc(self, store) -> None:
        item = self.type._start
        while item is not None:
            item.gc(store, True)
            item = item.right
        self.type._start = None
        for item in self.type._map.values():
            while item is not None:
                item.gc(store, True)
                item = item.left
        self.type._map = {}

    def write(self, encoder, offset: int) -> None:
        self.type._write(encoder)


def read_content_type(decoder):
    return ContentType(type_refs[decoder.read_type_ref()](decoder))


class ContentAny:
    """Ref 8: default content — an array of arbitrary JSON-ish values."""

    __slots__ = ("arr",)
    REF = 8
    countable = True

    def __init__(self, arr: list):
        self.arr = arr

    def get_length(self) -> int:
        return len(self.arr)

    def get_content(self):
        return self.arr

    def copy(self):
        return ContentAny(self.arr)

    def splice(self, offset: int):
        right = ContentAny(self.arr[offset:])
        self.arr = self.arr[:offset]
        return right

    def merge_with(self, right) -> bool:
        self.arr = self.arr + right.arr
        return True

    def integrate(self, transaction, item) -> None:
        pass

    def delete(self, transaction) -> None:
        pass

    def gc(self, store) -> None:
        pass

    def write(self, encoder, offset: int) -> None:
        encoder.write_len(len(self.arr) - offset)
        for i in range(offset, len(self.arr)):
            encoder.write_any(self.arr[i])


def read_content_any(decoder):
    return ContentAny([decoder.read_any() for _ in range(decoder.read_len())])


class ContentDoc:
    """Ref 9: subdocument embedding (reference src/structs/ContentDoc.js)."""

    __slots__ = ("doc", "opts")
    REF = 9
    countable = True

    def __init__(self, doc: "Doc"):
        if doc._item is not None:
            raise RuntimeError(
                "This document was already integrated as a sub-document. "
                "Create a second instance with the same guid instead."
            )
        self.doc = doc
        opts = {}
        if not doc.gc:
            opts["gc"] = False
        if doc.auto_load:
            opts["autoLoad"] = True
        if doc.meta is not None:
            opts["meta"] = doc.meta
        self.opts = opts

    def get_length(self) -> int:
        return 1

    def get_content(self):
        return [self.doc]

    def copy(self):
        return ContentDoc(self.doc)

    def splice(self, offset: int):
        raise NotImplementedError

    def merge_with(self, right) -> bool:
        return False

    def integrate(self, transaction, item) -> None:
        self.doc._item = item
        transaction.subdocs_added.add(self.doc)
        if self.doc.should_load:
            transaction.subdocs_loaded.add(self.doc)

    def delete(self, transaction) -> None:
        if self.doc in transaction.subdocs_added:
            transaction.subdocs_added.discard(self.doc)
        else:
            transaction.subdocs_removed.add(self.doc)

    def gc(self, store) -> None:
        pass

    def write(self, encoder, offset: int) -> None:
        encoder.write_string(self.doc.guid)
        encoder.write_any(self.opts)


def read_content_doc(decoder):
    guid = decoder.read_string()
    opts = decoder.read_any() or {}
    kwargs = {"guid": guid}
    kwargs.update(_opts_to_kwargs(opts))
    return ContentDoc(Doc(**kwargs))


# content-ref dispatch table (reference src/structs/Item.js:672-683)
content_refs = [
    None,  # 0 is the GC struct ref, not an item content
    read_content_deleted,
    read_content_json,
    read_content_binary,
    read_content_string,
    read_content_embed,
    read_content_format,
    read_content_type,
    read_content_any,
    read_content_doc,
]


def read_item_content(decoder, info: int):
    return content_refs[info & BITS5](decoder)


# ---------------------------------------------------------------------------
# Item (reference src/structs/Item.js:232-659)
# ---------------------------------------------------------------------------


class Item(AbstractStruct):
    """THE core struct: a run of content with YATA integration pointers.

    ``info`` bitfield: BIT1 keep, BIT2 countable, BIT3 deleted, BIT4 marker.
    """

    __slots__ = (
        "id",
        "length",
        "origin",
        "left",
        "right",
        "right_origin",
        "parent",
        "parent_sub",
        "redone",
        "content",
        "info",
    )

    def __init__(self, id, left, origin, right, right_origin, parent, parent_sub, content):
        self.id = id
        self.length = content.get_length()
        self.origin = origin
        self.left = left
        self.right = right
        self.right_origin = right_origin
        self.parent = parent
        self.parent_sub = parent_sub
        self.redone = None
        self.content = content
        self.info = BIT2 if content.countable else 0

    # -- info bits ----------------------------------------------------------

    @property
    def marker(self) -> bool:
        return (self.info & BIT4) > 0

    @marker.setter
    def marker(self, is_marked: bool) -> None:
        if ((self.info & BIT4) > 0) != is_marked:
            self.info ^= BIT4

    @property
    def keep(self) -> bool:
        return (self.info & BIT1) > 0

    @keep.setter
    def keep(self, do_keep: bool) -> None:
        if self.keep != do_keep:
            self.info ^= BIT1

    @property
    def countable(self) -> bool:
        return (self.info & BIT2) > 0

    @property
    def deleted(self) -> bool:
        return (self.info & BIT3) > 0

    @deleted.setter
    def deleted(self, do_delete: bool) -> None:
        if self.deleted != do_delete:
            self.info ^= BIT3

    def mark_deleted(self) -> None:
        self.info |= BIT3

    # -- causal dependencies ------------------------------------------------

    def get_missing(self, transaction, store) -> int | None:
        """Return the client of a missing causal dependency, or None after
        resolving origins into live left/right pointers
        (reference src/structs/Item.js:354-397)."""
        origin = self.origin
        if (
            origin is not None
            and origin.client != self.id.client
            and origin.clock >= get_state(store, origin.client)
        ):
            return origin.client
        right_origin = self.right_origin
        if (
            right_origin is not None
            and right_origin.client != self.id.client
            and right_origin.clock >= get_state(store, right_origin.client)
        ):
            return right_origin.client
        parent = self.parent
        if (
            parent is not None
            and type(parent) is ID
            and self.id.client != parent.client
            and parent.clock >= get_state(store, parent.client)
        ):
            return parent.client

        # all dependencies known; resolve them into pointers
        if origin is not None:
            self.left = get_item_clean_end(transaction, store, origin)
            # the origin may resolve into a GC run (tombstoned before this
            # item arrived); JS reads `.lastId` as undefined and the GC
            # check below degrades the item (reference Item.js:369-377)
            self.origin = (
                self.left.last_id if type(self.left) is Item else None
            )
        if right_origin is not None:
            self.right = get_item_clean_start(transaction, right_origin)
            self.right_origin = self.right.id
        if (self.left is not None and type(self.left) is GC) or (
            self.right is not None and type(self.right) is GC
        ):
            self.parent = None
        if self.parent is None:
            if self.left is not None and type(self.left) is Item:
                self.parent = self.left.parent
                self.parent_sub = self.left.parent_sub
            if self.right is not None and type(self.right) is Item:
                self.parent = self.right.parent
                self.parent_sub = self.right.parent_sub
        elif type(self.parent) is ID:
            parent_item = get_item(store, self.parent)
            if type(parent_item) is GC:
                self.parent = None
            else:
                # the parent item's content may have been replaced by
                # ContentDeleted; JS reads `.type` as undefined and the item
                # then integrates as a GC struct (reference Item.js:388-395)
                self.parent = getattr(parent_item.content, "type", None)
        return None

    # -- YATA integration ---------------------------------------------------

    def integrate(self, transaction, offset: int) -> None:
        """Insert this item into its parent's list, resolving concurrent
        inserts by the YATA rules (reference src/structs/Item.js:403-517)."""
        if offset > 0:
            self.id = create_id(self.id.client, self.id.clock + offset)
            self.left = get_item_clean_end(
                transaction, transaction.doc.store, create_id(self.id.client, self.id.clock - 1)
            )
            # the known prefix may have been replaced by a GC run; JS reads
            # `.lastId` as undefined and proceeds (reference Item.js:404-409)
            self.origin = (
                self.left.last_id if type(self.left) is Item else None
            )
            self.content = self.content.splice(offset)
            self.length -= offset

        parent = self.parent
        if parent is not None:
            if (self.left is None and (self.right is None or self.right.left is not None)) or (
                self.left is not None and self.left.right is not self.right
            ):
                left = self.left
                # find the first potentially conflicting item
                if left is not None:
                    o = left.right
                elif self.parent_sub is not None:
                    o = parent._map.get(self.parent_sub)
                    while o is not None and o.left is not None:
                        o = o.left
                else:
                    o = parent._start
                conflicting_items = set()
                items_before_origin = set()
                # Let c in conflicting_items, b in items_before_origin:
                # ***{origin}bbbb{this}{c,b}{c,b}{o}***
                this_origin = self.origin
                this_client = self.id.client
                store = transaction.doc.store
                while o is not None and o is not self.right:
                    items_before_origin.add(o)
                    conflicting_items.add(o)
                    if compare_ids(this_origin, o.origin):
                        # case 1: same origin — lower client id goes left
                        if o.id.client < this_client:
                            left = o
                            conflicting_items.clear()
                        elif compare_ids(self.right_origin, o.right_origin):
                            # same integration points: id decides; this goes
                            # to the left of o, so we are done
                            break
                    elif o.origin is not None and get_item(store, o.origin) in items_before_origin:
                        # case 2: o's origin is between origin and this
                        if get_item(store, o.origin) not in conflicting_items:
                            left = o
                            conflicting_items.clear()
                    else:
                        break
                    o = o.right
                self.left = left
            # reconnect left/right + update parent map/start
            if self.left is not None:
                right = self.left.right
                self.right = right
                self.left.right = self
            else:
                if self.parent_sub is not None:
                    r = parent._map.get(self.parent_sub)
                    while r is not None and r.left is not None:
                        r = r.left
                else:
                    r = parent._start
                    parent._start = self
                self.right = r
            if self.right is not None:
                self.right.left = self
            elif self.parent_sub is not None:
                # this is the new current attribute value of parent
                parent._map[self.parent_sub] = self
                if self.left is not None:
                    self.left.delete(transaction)
            if self.parent_sub is None and self.countable and not self.deleted:
                parent._length += self.length
            add_struct(transaction.doc.store, self)
            self.content.integrate(transaction, self)
            add_changed_type_to_transaction(transaction, parent, self.parent_sub)
            if (parent._item is not None and parent._item.deleted) or (
                self.parent_sub is not None and self.right is not None
            ):
                # delete if parent is deleted, or if this is not the current
                # attribute value of parent
                self.delete(transaction)
        else:
            # parent is not defined: integrate a GC struct instead
            GC(self.id, self.length).integrate(transaction, 0)

    # -- navigation ---------------------------------------------------------

    @property
    def next(self):
        n = self.right
        while n is not None and n.deleted:
            n = n.right
        return n

    @property
    def prev(self):
        n = self.left
        while n is not None and n.deleted:
            n = n.left
        return n

    @property
    def last_id(self) -> ID:
        return self.id if self.length == 1 else create_id(self.id.client, self.id.clock + self.length - 1)

    # -- run compaction -----------------------------------------------------

    def merge_with(self, right: "Item") -> bool:
        """Merge a directly adjacent right neighbour into this run
        (reference src/structs/Item.js:555-579)."""
        if (
            compare_ids(right.origin, self.last_id)
            and self.right is right
            and compare_ids(self.right_origin, right.right_origin)
            and self.id.client == right.id.client
            and self.id.clock + self.length == right.id.clock
            and self.deleted == right.deleted
            and self.redone is None
            and right.redone is None
            and type(self.content) is type(right.content)
            and self.content.merge_with(right.content)
        ):
            if right.keep:
                self.keep = True
            self.right = right.right
            if self.right is not None:
                self.right.left = self
            self.length += right.length
            return True
        return False

    def delete(self, transaction) -> None:
        if not self.deleted:
            parent = self.parent
            if self.countable and self.parent_sub is None:
                parent._length -= self.length
            self.mark_deleted()
            add_to_delete_set(transaction.delete_set, self.id.client, self.id.clock, self.length)
            add_changed_type_to_transaction(transaction, parent, self.parent_sub)
            self.content.delete(transaction)

    def gc(self, store, parent_gcd: bool) -> None:
        if not self.deleted:
            raise RuntimeError("cannot gc an undeleted item")
        self.content.gc(store)
        if parent_gcd:
            replace_struct(store, self, GC(self.id, self.length))
        else:
            self.content = ContentDeleted(self.length)

    # -- wire ---------------------------------------------------------------

    def write(self, encoder, offset: int) -> None:
        """Wire-encode (reference src/structs/Item.js:625-658)."""
        origin = create_id(self.id.client, self.id.clock + offset - 1) if offset > 0 else self.origin
        right_origin = self.right_origin
        parent_sub = self.parent_sub
        info = (
            (self.content.REF & BITS5)
            | (0 if origin is None else BIT8)
            | (0 if right_origin is None else BIT7)
            | (0 if parent_sub is None else BIT6)
        )
        encoder.write_info(info)
        if origin is not None:
            encoder.write_left_id(origin)
        if right_origin is not None:
            encoder.write_right_id(right_origin)
        if origin is None and right_origin is None:
            parent = self.parent
            parent_item = parent._item
            if parent_item is None:
                ykey = find_root_type_key(parent)
                encoder.write_parent_info(True)
                encoder.write_string(ykey)
            else:
                encoder.write_parent_info(False)
                encoder.write_left_id(parent_item.id)
            if parent_sub is not None:
                encoder.write_string(parent_sub)
        self.content.write(encoder, offset)


# -- item helpers (reference src/structs/Item.js:38-227) --------------------


def follow_redone(store, id: ID):
    """Follow a chain of ``redone`` pointers; returns (item, diff)."""
    next_id = id
    diff = 0
    while True:
        if diff > 0:
            next_id = create_id(next_id.client, next_id.clock + diff)
        item = get_item(store, next_id)
        diff = next_id.clock - item.id.clock
        next_id = item.redone if type(item) is Item else None
        if next_id is None or type(item) is not Item:
            break
    return item, diff


def keep_item(item, keep: bool) -> None:
    """Pin item + all ancestors against GC (reference Item.js:67-72)."""
    while item is not None and item.keep != keep:
        item.keep = keep
        item = item.parent._item


def split_item(transaction, left_item: Item, diff: int) -> Item:
    """Split a run at ``diff`` content units (reference Item.js:84-120)."""
    client = left_item.id.client
    clock = left_item.id.clock
    right_item = Item(
        create_id(client, clock + diff),
        left_item,
        create_id(client, clock + diff - 1),
        left_item.right,
        left_item.right_origin,
        left_item.parent,
        left_item.parent_sub,
        left_item.content.splice(diff),
    )
    if left_item.deleted:
        right_item.mark_deleted()
    if left_item.keep:
        right_item.keep = True
    if left_item.redone is not None:
        right_item.redone = create_id(left_item.redone.client, left_item.redone.clock + diff)
    # do not set left_item.right_origin — that would break sync
    left_item.right = right_item
    if right_item.right is not None:
        right_item.right.left = right_item
    transaction._merge_structs.append(right_item)
    if right_item.parent_sub is not None and right_item.right is None:
        right_item.parent._map[right_item.parent_sub] = right_item
    left_item.length = diff
    return right_item


def redo_item(transaction, item: Item, redoitems: set) -> Item | None:
    """Redo the effect of an (undone) operation (reference Item.js:133-227)."""
    doc = transaction.doc
    store = doc.store
    own_client_id = doc.client_id
    redone = item.redone
    if redone is not None:
        return get_item_clean_start(transaction, redone)
    parent_item = item.parent._item
    if item.parent_sub is None:
        # list item: re-insert at the old position
        left = item.left
        right = item
    else:
        # map item: insert as the current value
        left = item
        while left.right is not None:
            left = left.right
            if left.id.client != own_client_id:
                # conflicts with a change from another client; cannot redo
                return None
        right = None
    # make sure the parent is redone
    if parent_item is not None and parent_item.deleted and parent_item.redone is None:
        if parent_item not in redoitems or redo_item(transaction, parent_item, redoitems) is None:
            return None
    if parent_item is not None and parent_item.redone is not None:
        while parent_item.redone is not None:
            parent_item = get_item_clean_start(transaction, parent_item.redone)
        # find next cloned_redo items
        while left is not None:
            left_trace = left
            while left_trace is not None and left_trace.parent._item is not parent_item:
                left_trace = (
                    None
                    if left_trace.redone is None
                    else get_item_clean_start(transaction, left_trace.redone)
                )
            if left_trace is not None and left_trace.parent._item is parent_item:
                left = left_trace
                break
            left = left.left
        while right is not None:
            right_trace = right
            while right_trace is not None and right_trace.parent._item is not parent_item:
                right_trace = (
                    None
                    if right_trace.redone is None
                    else get_item_clean_start(transaction, right_trace.redone)
                )
            if right_trace is not None and right_trace.parent._item is parent_item:
                right = right_trace
                break
            right = right.right
    next_clock = get_state(store, own_client_id)
    next_id = create_id(own_client_id, next_clock)
    redone_item = Item(
        next_id,
        left,
        left.last_id if left is not None else None,
        right,
        right.id if right is not None else None,
        item.parent if parent_item is None else parent_item.content.type,
        item.parent_sub,
        item.content.copy(),
    )
    item.redone = next_id
    keep_item(redone_item, True)
    redone_item.integrate(transaction, 0)
    return redone_item


# ---------------------------------------------------------------------------
# StructStore (reference src/utils/StructStore.js)
# ---------------------------------------------------------------------------


class StructStore:
    """Per-client insertion-order arrays of structs, sorted by clock, plus
    pending buffers for causally-early updates."""

    __slots__ = ("clients", "pending_clients_struct_refs", "pending_stack", "pending_delete_readers")

    def __init__(self):
        self.clients: dict[int, list] = {}
        # client -> {"i": next index, "refs": [structs]}
        self.pending_clients_struct_refs: dict[int, dict] = {}
        self.pending_stack: list = []
        self.pending_delete_readers: list = []


def get_state_vector(store: StructStore) -> dict[int, int]:
    sm = {}
    for client, structs in store.clients.items():
        struct = structs[-1]
        sm[client] = struct.id.clock + struct.length
    return sm


def get_state(store: StructStore, client: int) -> int:
    structs = store.clients.get(client)
    if structs is None:
        return 0
    last = structs[-1]
    return last.id.clock + last.length


def integrity_check(store: StructStore) -> None:
    for structs in store.clients.values():
        for i in range(1, len(structs)):
            left = structs[i - 1]
            right = structs[i]
            if left.id.clock + left.length != right.id.clock:
                raise RuntimeError("StructStore failed integrity check")


def add_struct(store: StructStore, struct) -> None:
    structs = store.clients.get(struct.id.client)
    if structs is None:
        store.clients[struct.id.client] = [struct]
        return
    last = structs[-1]
    if last.id.clock + last.length != struct.id.clock:
        raise RuntimeError("struct store clocks must be contiguous")
    structs.append(struct)


def find_index_ss(structs: list, clock: int) -> int:
    """Binary search with pivot guess (reference StructStore.js:123-151)."""
    left = 0
    right = len(structs) - 1
    mid = structs[right]
    midclock = mid.id.clock
    if midclock == clock:
        return right
    midindex = int((clock / (midclock + mid.length - 1)) * right)
    while left <= right:
        mid = structs[midindex]
        midclock = mid.id.clock
        if midclock <= clock:
            if clock < midclock + mid.length:
                return midindex
            left = midindex + 1
        else:
            right = midindex - 1
        midindex = (left + right) // 2
    raise RuntimeError(f"struct with clock {clock} not found")


def find(store: StructStore, id: ID):
    structs = store.clients[id.client]
    return structs[find_index_ss(structs, id.clock)]


get_item = find


def find_index_clean_start(transaction, structs: list, clock: int) -> int:
    index = find_index_ss(structs, clock)
    struct = structs[index]
    if struct.id.clock < clock and type(struct) is Item:
        structs.insert(index + 1, split_item(transaction, struct, clock - struct.id.clock))
        return index + 1
    return index


def get_item_clean_start(transaction, id: ID) -> Item:
    structs = transaction.doc.store.clients[id.client]
    return structs[find_index_clean_start(transaction, structs, id.clock)]


def get_item_clean_end(transaction, store: StructStore, id: ID):
    structs = store.clients[id.client]
    index = find_index_ss(structs, id.clock)
    struct = structs[index]
    if id.clock != struct.id.clock + struct.length - 1 and type(struct) is not GC:
        structs.insert(index + 1, split_item(transaction, struct, id.clock - struct.id.clock + 1))
    return struct


def replace_struct(store: StructStore, struct, new_struct) -> None:
    structs = store.clients[struct.id.client]
    structs[find_index_ss(structs, struct.id.clock)] = new_struct


def iterate_structs(transaction, structs: list, clock_start: int, length: int, f) -> None:
    if length == 0:
        return
    clock_end = clock_start + length
    index = find_index_clean_start(transaction, structs, clock_start)
    while True:
        struct = structs[index]
        index += 1
        if clock_end < struct.id.clock + struct.length:
            find_index_clean_start(transaction, structs, clock_end)
        f(struct)
        if index >= len(structs) or structs[index].id.clock >= clock_end:
            break


# ---------------------------------------------------------------------------
# DeleteSet (reference src/utils/DeleteSet.js)
# ---------------------------------------------------------------------------


class DeleteItem:
    __slots__ = ("clock", "len")

    def __init__(self, clock: int, ln: int):
        self.clock = clock
        self.len = ln

    def __repr__(self):
        return f"DeleteItem({self.clock},{self.len})"


class DeleteSet:
    """State-based delete CRDT: client -> sorted array of (clock, len)."""

    __slots__ = ("clients",)

    def __init__(self):
        self.clients: dict[int, list[DeleteItem]] = {}


def iterate_deleted_structs(transaction, ds: DeleteSet, f) -> None:
    for client, deletes in ds.clients.items():
        structs = transaction.doc.store.clients[client]
        for del_item in deletes:
            iterate_structs(transaction, structs, del_item.clock, del_item.len, f)


def find_index_ds(dis: list[DeleteItem], clock: int) -> int | None:
    left = 0
    right = len(dis) - 1
    while left <= right:
        midindex = (left + right) // 2
        mid = dis[midindex]
        midclock = mid.clock
        if midclock <= clock:
            if clock < midclock + mid.len:
                return midindex
            left = midindex + 1
        else:
            right = midindex - 1
    return None


def is_deleted(ds: DeleteSet, id: ID) -> bool:
    dis = ds.clients.get(id.client)
    return dis is not None and find_index_ds(dis, id.clock) is not None


def sort_and_merge_delete_set(ds: DeleteSet) -> None:
    for dels in ds.clients.values():
        dels.sort(key=lambda d: d.clock)
        # merge in place: i scans, j is the insert position
        j = 1
        for i in range(1, len(dels)):
            left = dels[j - 1]
            right = dels[i]
            if left.clock + left.len == right.clock:
                left.len += right.len
            else:
                if j < i:
                    dels[j] = right
                j += 1
        del dels[j:]


def merge_delete_sets(dss: list[DeleteSet]) -> DeleteSet:
    merged = DeleteSet()
    for dss_i, ds in enumerate(dss):
        for client, dels_left in ds.clients.items():
            if client not in merged.clients:
                dels = [DeleteItem(d.clock, d.len) for d in dels_left]
                for i in range(dss_i + 1, len(dss)):
                    dels.extend(
                        DeleteItem(d.clock, d.len) for d in dss[i].clients.get(client, ())
                    )
                merged.clients[client] = dels
    sort_and_merge_delete_set(merged)
    return merged


def add_to_delete_set(ds: DeleteSet, client: int, clock: int, length: int) -> None:
    ds.clients.setdefault(client, []).append(DeleteItem(clock, length))


def create_delete_set() -> DeleteSet:
    """Fresh empty DeleteSet (reference src/utils/DeleteSet.js
    createDeleteSet, exported from src/index.js:42)."""
    return DeleteSet()


def create_delete_set_from_struct_store(ss: StructStore) -> DeleteSet:
    ds = DeleteSet()
    for client, structs in ss.clients.items():
        ds_items = []
        i = 0
        n = len(structs)
        while i < n:
            struct = structs[i]
            if struct.deleted:
                clock = struct.id.clock
                ln = struct.length
                while i + 1 < n:
                    nxt = structs[i + 1]
                    if nxt.id.clock == clock + ln and nxt.deleted:
                        ln += nxt.length
                        i += 1
                    else:
                        break
                ds_items.append(DeleteItem(clock, ln))
            i += 1
        if ds_items:
            ds.clients[client] = ds_items
    return ds


def write_delete_set(encoder, ds: DeleteSet) -> None:
    from .lib0 import encoding as lib0enc

    lib0enc.write_var_uint(encoder.rest_encoder, len(ds.clients))
    for client, ds_items in ds.clients.items():
        encoder.reset_ds_cur_val()
        lib0enc.write_var_uint(encoder.rest_encoder, client)
        lib0enc.write_var_uint(encoder.rest_encoder, len(ds_items))
        for item in ds_items:
            encoder.write_ds_clock(item.clock)
            encoder.write_ds_len(item.len)


def read_delete_set(decoder) -> DeleteSet:
    from .lib0 import decoding as lib0dec

    ds = DeleteSet()
    num_clients = lib0dec.read_var_uint(decoder.rest_decoder)
    for _ in range(num_clients):
        decoder.reset_ds_cur_val()
        client = lib0dec.read_var_uint(decoder.rest_decoder)
        num_deletes = lib0dec.read_var_uint(decoder.rest_decoder)
        if num_deletes > 0:
            ds_field = ds.clients.setdefault(client, [])
            for _ in range(num_deletes):
                ds_field.append(DeleteItem(decoder.read_ds_clock(), decoder.read_ds_len()))
    return ds


def read_and_apply_delete_set(decoder, transaction, store) -> None:
    """Split & delete live ranges; buffer not-yet-known ranges
    (reference src/utils/DeleteSet.js:270-323)."""
    from .lib0 import decoding as lib0dec

    unapplied = DeleteSet()
    num_clients = lib0dec.read_var_uint(decoder.rest_decoder)
    for _ in range(num_clients):
        decoder.reset_ds_cur_val()
        client = lib0dec.read_var_uint(decoder.rest_decoder)
        num_deletes = lib0dec.read_var_uint(decoder.rest_decoder)
        structs = store.clients.get(client, [])
        state = get_state(store, client)
        for _ in range(num_deletes):
            clock = decoder.read_ds_clock()
            clock_end = clock + decoder.read_ds_len()
            if clock < state:
                if state < clock_end:
                    add_to_delete_set(unapplied, client, state, clock_end - state)
                index = find_index_ss(structs, clock)
                struct = structs[index]
                # split the first item if necessary
                if not struct.deleted and struct.id.clock < clock:
                    structs.insert(
                        index + 1, split_item(transaction, struct, clock - struct.id.clock)
                    )
                    index += 1
                while index < len(structs):
                    struct = structs[index]
                    index += 1
                    if struct.id.clock < clock_end:
                        if not struct.deleted:
                            if clock_end < struct.id.clock + struct.length:
                                structs.insert(
                                    index,
                                    split_item(
                                        transaction, struct, clock_end - struct.id.clock
                                    ),
                                )
                            struct.delete(transaction)
                    else:
                        break
            else:
                add_to_delete_set(unapplied, client, clock, clock_end - clock)
    if unapplied.clients:
        # re-encode the unapplied ranges and park them for later
        from .coding import DSDecoderV2, DSEncoderV2
        from .lib0.decoding import Decoder

        ds_encoder = DSEncoderV2()
        write_delete_set(ds_encoder, unapplied)
        store.pending_delete_readers.append(DSDecoderV2(Decoder(ds_encoder.to_bytes())))


# ---------------------------------------------------------------------------
# Transaction (reference src/utils/Transaction.js)
# ---------------------------------------------------------------------------


class Transaction:
    __slots__ = (
        "doc",
        "delete_set",
        "before_state",
        "after_state",
        "changed",
        "changed_parent_types",
        "_merge_structs",
        "origin",
        "meta",
        "local",
        "subdocs_added",
        "subdocs_removed",
        "subdocs_loaded",
    )

    def __init__(self, doc: "Doc", origin, local: bool):
        self.doc = doc
        self.delete_set = DeleteSet()
        self.before_state = get_state_vector(doc.store)
        self.after_state: dict[int, int] = {}
        self.changed: dict = {}
        self.changed_parent_types: dict = {}
        self._merge_structs: list = []
        self.origin = origin
        self.meta: dict = {}
        self.local = local
        self.subdocs_added: set = set()
        self.subdocs_removed: set = set()
        self.subdocs_loaded: set = set()


def write_update_message_from_transaction(encoder, transaction: Transaction) -> bool:
    if not transaction.delete_set.clients and not any(
        transaction.before_state.get(client) != clock
        for client, clock in transaction.after_state.items()
    ):
        return False
    from .updates import write_clients_structs

    sort_and_merge_delete_set(transaction.delete_set)
    write_clients_structs(encoder, transaction.doc.store, transaction.before_state)
    write_delete_set(encoder, transaction.delete_set)
    return True


def next_id(transaction: Transaction) -> ID:
    y = transaction.doc
    return create_id(y.client_id, get_state(y.store, y.client_id))


def add_changed_type_to_transaction(transaction: Transaction, type_, parent_sub) -> None:
    item = type_._item
    if item is None or (
        item.id.clock < transaction.before_state.get(item.id.client, 0) and not item.deleted
    ):
        transaction.changed.setdefault(type_, set()).add(parent_sub)


def _try_to_merge_with_left(structs: list, pos: int) -> None:
    left = structs[pos - 1]
    right = structs[pos]
    if left.deleted == right.deleted and type(left) is type(right):
        if left.merge_with(right):
            del structs[pos]
            if (
                type(right) is Item
                and right.parent_sub is not None
                and right.parent._map.get(right.parent_sub) is right
            ):
                right.parent._map[right.parent_sub] = left


def _try_gc_delete_set(ds: DeleteSet, store: StructStore, gc_filter) -> None:
    for client, delete_items in ds.clients.items():
        structs = store.clients[client]
        for di in range(len(delete_items) - 1, -1, -1):
            delete_item = delete_items[di]
            end_clock = delete_item.clock + delete_item.len
            si = find_index_ss(structs, delete_item.clock)
            while si < len(structs):
                struct = structs[si]
                if struct.id.clock >= end_clock:
                    break
                if type(struct) is Item and struct.deleted and not struct.keep and gc_filter(struct):
                    struct.gc(store, False)
                si += 1


def _try_merge_delete_set(ds: DeleteSet, store: StructStore) -> None:
    # merge right-to-left for efficiency and completeness
    for client, delete_items in ds.clients.items():
        structs = store.clients[client]
        for di in range(len(delete_items) - 1, -1, -1):
            delete_item = delete_items[di]
            most_right = min(
                len(structs) - 1,
                1 + find_index_ss(structs, delete_item.clock + delete_item.len - 1),
            )
            si = most_right
            while si > 0 and structs[si].id.clock >= delete_item.clock:
                _try_to_merge_with_left(structs, si)
                si -= 1


def try_gc(ds: DeleteSet, store: StructStore, gc_filter) -> None:
    _try_gc_delete_set(ds, store, gc_filter)
    _try_merge_delete_set(ds, store)


def _cleanup_transactions(transaction_cleanups: list, i: int) -> None:
    if i >= len(transaction_cleanups):
        return
    transaction = transaction_cleanups[i]
    doc = transaction.doc
    store = doc.store
    ds = transaction.delete_set
    merge_structs = transaction._merge_structs
    try:
        sort_and_merge_delete_set(ds)
        transaction.after_state = get_state_vector(store)
        doc._transaction = None
        doc.emit("beforeObserverCalls", [transaction, doc])
        fs: list = []
        for itemtype, subs in transaction.changed.items():
            def _call_observer(itemtype=itemtype, subs=subs):
                if itemtype._item is None or not itemtype._item.deleted:
                    itemtype._call_observer(transaction, subs)

            fs.append(_call_observer)

        def _deep_events():
            for type_, events in transaction.changed_parent_types.items():
                def _call_deep(type_=type_, events=events):
                    if type_._item is None or not type_._item.deleted:
                        evts = [
                            event
                            for event in events
                            if event.target._item is None or not event.target._item.deleted
                        ]
                        for event in evts:
                            event.current_target = type_
                        evts.sort(key=lambda event: len(event.path))
                        if evts:
                            call_event_handler_listeners(type_._deh, evts, transaction)

                fs.append(_call_deep)
            fs.append(lambda: doc.emit("afterTransaction", [transaction, doc]))

        fs.append(_deep_events)
        call_all(fs, [])
    finally:
        # GC + compaction passes; this is where content is actually removed
        if doc.gc:
            _try_gc_delete_set(ds, store, doc.gc_filter)
        _try_merge_delete_set(ds, store)

        for client, clock in transaction.after_state.items():
            before_clock = transaction.before_state.get(client, 0)
            if before_clock != clock:
                structs = store.clients[client]
                first_change_pos = max(find_index_ss(structs, before_clock), 1)
                for idx in range(len(structs) - 1, first_change_pos - 1, -1):
                    _try_to_merge_with_left(structs, idx)
        for struct in merge_structs:
            client = struct.id.client
            clock = struct.id.clock
            structs = store.clients[client]
            replaced_pos = find_index_ss(structs, clock)
            if replaced_pos + 1 < len(structs):
                _try_to_merge_with_left(structs, replaced_pos + 1)
            if replaced_pos > 0:
                _try_to_merge_with_left(structs, replaced_pos)
        if not transaction.local and transaction.after_state.get(
            doc.client_id
        ) != transaction.before_state.get(doc.client_id):
            # another client is using our client id: regenerate
            doc.client_id = generate_new_client_id()
        doc.emit("afterTransactionCleanup", [transaction, doc])
        if "update" in doc._observers:
            from .coding import default_update_encoder

            encoder = default_update_encoder()
            if write_update_message_from_transaction(encoder, transaction):
                doc.emit("update", [encoder.to_bytes(), transaction.origin, doc])
        if "updateV2" in doc._observers:
            from .coding import UpdateEncoderV2

            encoder = UpdateEncoderV2()
            if write_update_message_from_transaction(encoder, transaction):
                doc.emit("updateV2", [encoder.to_bytes(), transaction.origin, doc])
        for subdoc in transaction.subdocs_added:
            doc.subdocs.add(subdoc)
        for subdoc in transaction.subdocs_removed:
            doc.subdocs.discard(subdoc)
        doc.emit(
            "subdocs",
            [
                {
                    "loaded": transaction.subdocs_loaded,
                    "added": transaction.subdocs_added,
                    "removed": transaction.subdocs_removed,
                }
            ],
        )
        for subdoc in transaction.subdocs_removed:
            subdoc.destroy()
        if len(transaction_cleanups) <= i + 1:
            doc._transaction_cleanups = []
            doc.emit("afterAllTransactions", [doc, transaction_cleanups])
        else:
            _cleanup_transactions(transaction_cleanups, i + 1)


def transact(doc: "Doc", f, origin=None, local: bool = True):
    """Run `f(transaction)`, reusing the current transaction when nested
    (reference src/utils/Transaction.js:378-405)."""
    transaction_cleanups = doc._transaction_cleanups
    initial_call = False
    result = None
    if doc._transaction is None:
        initial_call = True
        doc._transaction = Transaction(doc, origin, local)
        transaction_cleanups.append(doc._transaction)
        if len(transaction_cleanups) == 1:
            doc.emit("beforeAllTransactions", [doc])
        doc.emit("beforeTransaction", [doc._transaction, doc])
    try:
        result = f(doc._transaction)
    finally:
        if initial_call and transaction_cleanups[0] is doc._transaction:
            _cleanup_transactions(transaction_cleanups, 0)
    return result


# ---------------------------------------------------------------------------
# Doc (reference src/utils/Doc.js)
# ---------------------------------------------------------------------------


def generate_new_client_id() -> int:
    return _random.getrandbits(32)


def _uuidv4() -> str:
    import uuid

    return str(uuid.uuid4())


class Doc(Observable):
    """A shared document: root-type registry + struct store + transactions."""

    def __init__(self, guid=None, gc=True, gc_filter=None, meta=None, auto_load=False):
        super().__init__()
        self.gc = gc
        self.gc_filter = gc_filter if gc_filter is not None else (lambda item: True)
        self.client_id = generate_new_client_id()
        self.guid = guid if guid is not None else _uuidv4()
        self.share: dict[str, object] = {}
        self.store = StructStore()
        self._transaction: Transaction | None = None
        self._transaction_cleanups: list[Transaction] = []
        self.subdocs: set[Doc] = set()
        self._item: Item | None = None
        self.should_load = auto_load
        self.auto_load = auto_load
        self.meta = meta

    # camelCase alias kept for API parity with the reference
    @property
    def clientID(self) -> int:  # noqa: N802
        return self.client_id

    @clientID.setter
    def clientID(self, v: int) -> None:  # noqa: N802
        self.client_id = v

    def load(self) -> None:
        item = self._item
        if item is not None and not self.should_load:
            def _mark(transaction):
                transaction.subdocs_loaded.add(self)

            transact(item.parent.doc, _mark, None, True)
        self.should_load = True

    def get_subdocs(self) -> set:
        return self.subdocs

    def get_subdoc_guids(self) -> set:
        return {doc.guid for doc in self.subdocs}

    def transact(self, f, origin=None):
        return transact(self, f, origin)

    def get(self, name: str, type_constructor=None):
        """Lazy root-type definition with retyping of placeholder types
        (reference src/utils/Doc.js:139-171)."""
        from .types.abstract import AbstractType

        if type_constructor is None:
            type_constructor = AbstractType
        type_ = self.share.get(name)
        if type_ is None:
            type_ = type_constructor()
            type_._integrate(self, None)
            self.share[name] = type_
        constr = type(type_)
        if type_constructor is not AbstractType and constr is not type_constructor:
            if constr is AbstractType:
                t = type_constructor()
                t._map = type_._map
                for n in type_._map.values():
                    while n is not None:
                        n.parent = t
                        n = n.left
                t._start = type_._start
                n = t._start
                while n is not None:
                    n.parent = t
                    n = n.right
                t._length = type_._length
                self.share[name] = t
                t._integrate(self, None)
                return t
            raise TypeError(
                f"Type with the name {name} has already been defined with a different constructor"
            )
        return type_

    def get_array(self, name: str = ""):
        from .types.yarray import YArray

        return self.get(name, YArray)

    def get_text(self, name: str = ""):
        from .types.ytext import YText

        return self.get(name, YText)

    def get_map(self, name: str = ""):
        from .types.ymap import YMap

        return self.get(name, YMap)

    def get_xml_fragment(self, name: str = ""):
        from .types.yxml import YXmlFragment

        return self.get(name, YXmlFragment)

    def to_json(self) -> dict:
        return {key: value.to_json() for key, value in self.share.items()}

    def destroy(self) -> None:
        for subdoc in list(self.subdocs):
            subdoc.destroy()
        item = self._item
        if item is not None:
            self._item = None
            content = item.content
            if item.deleted:
                # content may already be gc'd to ContentDeleted; JS sets a
                # dangling .doc property there, which is a no-op for us
                if type(content) is ContentDoc:
                    content.doc = None
            else:
                new_doc = Doc(guid=self.guid, **_opts_to_kwargs(content.opts))
                content.doc = new_doc
                new_doc._item = item

            def _propagate(transaction):
                if not item.deleted:
                    transaction.subdocs_added.add(content.doc)
                transaction.subdocs_removed.add(self)

            transact(item.parent.doc, _propagate, None, True)
        self.emit("destroyed", [True])
        self.emit("destroy", [self])
        super().destroy()


def _opts_to_kwargs(opts: dict) -> dict:
    kwargs = {}
    if "gc" in opts:
        kwargs["gc"] = opts["gc"]
    if "autoLoad" in opts:
        kwargs["auto_load"] = opts["autoLoad"]
    if "meta" in opts:
        kwargs["meta"] = opts["meta"]
    return kwargs


# -- misc helpers -----------------------------------------------------------


def is_parent_of(parent, child: Item | None) -> bool:
    """Ancestor test (reference src/utils/isParentOf.js:14-22)."""
    while child is not None:
        if child.parent is parent:
            return True
        child = child.parent._item
    return False


def log_type(type_) -> None:
    """Debug dump of a type's item list (reference src/utils/logging.js)."""
    s = type_._start
    arr = []
    while s is not None:
        arr.append(s)
        s = s.right
    print("Children:", arr)
    print(
        "Children content:",
        [from_u16("".join(map(str, c.content.get_content()))) for c in arr if not c.deleted],
    )


def _json_stringify(value) -> str:
    from .coding import _json_stringify as impl

    return impl(value)


def _json_parse(s: str):
    from .coding import _json_parse as impl

    return impl(s)
