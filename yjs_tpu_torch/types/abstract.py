"""AbstractType: base of all shared types + list/map primitives + the
search-marker index cache (reference src/types/AbstractType.js)."""

from __future__ import annotations

from ..core import (
    ContentAny,
    ContentBinary,
    ContentDoc,
    ContentType,
    Doc,
    Item,
    add_event_handler_listener,
    call_event_handler_listeners,
    create_event_handler,
    get_item_clean_start,
    get_state,
    remove_event_handler_listener,
)
from ..ids import create_id

MAX_SEARCH_MARKER = 80

_global_search_marker_timestamp = 0


def _next_timestamp() -> int:
    global _global_search_marker_timestamp
    _global_search_marker_timestamp += 1
    return _global_search_marker_timestamp


class ArraySearchMarker:
    """Cached (item, index) pair for ~O(1) index→item lookups near recent
    edit positions (reference AbstractType.js:33-44)."""

    __slots__ = ("p", "index", "timestamp")

    def __init__(self, p: Item, index: int):
        p.marker = True
        self.p = p
        self.index = index
        self.timestamp = _next_timestamp()


def _refresh_marker_timestamp(marker: ArraySearchMarker) -> None:
    marker.timestamp = _next_timestamp()


def _overwrite_marker(marker: ArraySearchMarker, p: Item, index: int) -> None:
    marker.p.marker = False
    marker.p = p
    p.marker = True
    marker.index = index
    marker.timestamp = _next_timestamp()


def _mark_position(search_marker: list, p: Item, index: int) -> ArraySearchMarker:
    if len(search_marker) >= MAX_SEARCH_MARKER:
        marker = min(search_marker, key=lambda a: a.timestamp)
        _overwrite_marker(marker, p, index)
        return marker
    pm = ArraySearchMarker(p, index)
    search_marker.append(pm)
    return pm


def find_marker(yarray: "AbstractType", index: int) -> ArraySearchMarker | None:
    """Find (and refresh) the best marker for `index`
    (reference AbstractType.js:97-168)."""
    if yarray._start is None or index == 0 or yarray._search_marker is None:
        return None
    sm = yarray._search_marker
    marker = min(sm, key=lambda a: abs(index - a.index)) if sm else None
    p = yarray._start
    pindex = 0
    if marker is not None:
        p = marker.p
        pindex = marker.index
        _refresh_marker_timestamp(marker)
    # iterate right
    while p.right is not None and pindex < index:
        if not p.deleted and p.countable:
            if index < pindex + p.length:
                break
            pindex += p.length
        p = p.right
    # iterate left if we overshot
    while p.left is not None and pindex > index:
        p = p.left
        if not p.deleted and p.countable:
            pindex -= p.length
    # ensure p cannot be merged with its left neighbour
    while (
        p.left is not None
        and p.left.id.client == p.id.client
        and p.left.id.clock + p.left.length == p.id.clock
    ):
        p = p.left
        if not p.deleted and p.countable:
            pindex -= p.length
    if (
        marker is not None
        and abs(marker.index - pindex) < p.parent._length / MAX_SEARCH_MARKER
    ):
        _overwrite_marker(marker, p, pindex)
        return marker
    return _mark_position(sm, p, pindex)


def update_marker_changes(search_marker: list, index: int, length: int) -> None:
    """Shift markers after an insert (len>0) or delete (len<0); call before
    deleting (reference AbstractType.js:179-210)."""
    for i in range(len(search_marker) - 1, -1, -1):
        m = search_marker[i]
        if length > 0:
            p = m.p
            p.marker = False
            # move marker to the prev undeleted countable position
            while p is not None and (p.deleted or not p.countable):
                p = p.left
                if p is not None and not p.deleted and p.countable:
                    m.index -= p.length
            if p is None or p.marker:
                del search_marker[i]
                continue
            m.p = p
            p.marker = True
        if index < m.index or (length > 0 and index == m.index):
            m.index = max(index, m.index + length)


def get_type_children(t: "AbstractType") -> list:
    s = t._start
    arr = []
    while s is not None:
        arr.append(s)
        s = s.right
    return arr


def call_type_observers(type_, transaction, event) -> None:
    """Fire observers and propagate the event to all ancestors' deep
    observers (reference AbstractType.js:237-249)."""
    changed_type = type_
    changed_parent_types = transaction.changed_parent_types
    while True:
        changed_parent_types.setdefault(type_, []).append(event)
        if type_._item is None:
            break
        type_ = type_._item.parent
    call_event_handler_listeners(changed_type._eh, event, transaction)


class AbstractType:
    def __init__(self):
        self._item: Item | None = None
        self._map: dict[str, Item] = {}
        self._start: Item | None = None
        self.doc: Doc | None = None
        self._length = 0
        self._eh = create_event_handler()
        self._deh = create_event_handler()
        self._search_marker: list | None = None

    @property
    def parent(self):
        return self._item.parent if self._item else None

    def _integrate(self, y: Doc, item: Item | None) -> None:
        self.doc = y
        self._item = item

    def _copy(self) -> "AbstractType":
        raise NotImplementedError

    def clone(self) -> "AbstractType":
        raise NotImplementedError

    def _write(self, encoder) -> None:
        pass

    @property
    def _first(self):
        n = self._start
        while n is not None and n.deleted:
            n = n.right
        return n

    def _call_observer(self, transaction, parent_subs) -> None:
        if not transaction.local and self._search_marker is not None:
            self._search_marker.clear()

    def observe(self, f) -> None:
        add_event_handler_listener(self._eh, f)

    def observe_deep(self, f) -> None:
        add_event_handler_listener(self._deh, f)

    def unobserve(self, f) -> None:
        remove_event_handler_listener(self._eh, f)

    def unobserve_deep(self, f) -> None:
        remove_event_handler_listener(self._deh, f)

    def to_json(self):
        pass


# ---------------------------------------------------------------------------
# List primitives (reference AbstractType.js:407-774)
# ---------------------------------------------------------------------------

def type_list_slice(type_: AbstractType, start: int, end: int) -> list:
    if start < 0:
        start = type_._length + start
    if end < 0:
        end = type_._length + end
    length = end - start
    cs = []
    n = type_._start
    while n is not None and length > 0:
        if n.countable and not n.deleted:
            c = n.content.get_content()
            if len(c) <= start:
                start -= len(c)
            else:
                for i in range(start, len(c)):
                    if length <= 0:
                        break
                    cs.append(c[i])
                    length -= 1
                start = 0
        n = n.right
    return cs


def type_list_to_array(type_: AbstractType) -> list:
    cs = []
    n = type_._start
    while n is not None:
        if n.countable and not n.deleted:
            cs.extend(n.content.get_content())
        n = n.right
    return cs


def type_list_to_array_snapshot(type_: AbstractType, snapshot) -> list:
    from ..utils.snapshot import is_visible

    cs = []
    n = type_._start
    while n is not None:
        if n.countable and is_visible(n, snapshot):
            cs.extend(n.content.get_content())
        n = n.right
    return cs


def type_list_for_each(type_: AbstractType, f) -> None:
    index = 0
    n = type_._start
    while n is not None:
        if n.countable and not n.deleted:
            for c in n.content.get_content():
                f(c, index, type_)
                index += 1
        n = n.right


def type_list_map(type_: AbstractType, f) -> list:
    result = []

    def _collect(c, i, _t):
        result.append(f(c, i, _t))

    type_list_for_each(type_, _collect)
    return result


def type_list_create_iterator(type_: AbstractType):
    n = type_._start
    while n is not None:
        if not n.deleted and n.countable:
            yield from n.content.get_content()
        n = n.right


def type_list_for_each_snapshot(type_: AbstractType, f, snapshot) -> None:
    from ..utils.snapshot import is_visible

    index = 0
    n = type_._start
    while n is not None:
        if n.countable and is_visible(n, snapshot):
            for c in n.content.get_content():
                f(c, index, type_)
                index += 1
        n = n.right


def type_list_get(type_: AbstractType, index: int):
    marker = find_marker(type_, index)
    n = type_._start
    if marker is not None:
        n = marker.p
        index -= marker.index
    while n is not None:
        if not n.deleted and n.countable:
            if index < n.length:
                return n.content.get_content()[index]
            index -= n.length
        n = n.right
    return None


def type_list_insert_generics_after(transaction, parent: AbstractType, reference_item, content: list) -> None:
    """Pack plain values into ContentAny/Binary/Doc/Type runs and integrate
    (reference AbstractType.js:631-680)."""
    left = reference_item
    doc = transaction.doc
    own_client_id = doc.client_id
    store = doc.store
    right = parent._start if reference_item is None else reference_item.right
    json_content: list = []

    def pack_json_content():
        nonlocal left, json_content
        if json_content:
            left = Item(
                create_id(own_client_id, get_state(store, own_client_id)),
                left,
                left.last_id if left else None,
                right,
                right.id if right else None,
                parent,
                None,
                ContentAny(json_content),
            )
            left.integrate(transaction, 0)
            json_content = []

    for c in content:
        if c is None or isinstance(c, (int, float, bool, str, list, dict)):
            json_content.append(c)
        else:
            pack_json_content()
            if isinstance(c, (bytes, bytearray, memoryview)):
                content_obj = ContentBinary(bytes(c))
            elif isinstance(c, Doc):
                content_obj = ContentDoc(c)
            elif isinstance(c, AbstractType):
                content_obj = ContentType(c)
            else:
                raise TypeError("Unexpected content type in insert operation")
            left = Item(
                create_id(own_client_id, get_state(store, own_client_id)),
                left,
                left.last_id if left else None,
                right,
                right.id if right else None,
                parent,
                None,
                content_obj,
            )
            left.integrate(transaction, 0)
    pack_json_content()


def type_list_insert_generics(transaction, parent: AbstractType, index: int, content: list) -> None:
    if index == 0:
        if parent._search_marker is not None:
            update_marker_changes(parent._search_marker, index, len(content))
        return type_list_insert_generics_after(transaction, parent, None, content)
    start_index = index
    marker = find_marker(parent, index)
    n = parent._start
    if marker is not None:
        n = marker.p
        index -= marker.index
        if index == 0:
            # step one item left so the insertion-point scan below works
            n = n.prev
            index += n.length if (n is not None and n.countable and not n.deleted) else 0
    while n is not None:
        if not n.deleted and n.countable:
            if index <= n.length:
                if index < n.length:
                    # split for an in-between insert
                    get_item_clean_start(
                        transaction, create_id(n.id.client, n.id.clock + index)
                    )
                break
            index -= n.length
        n = n.right
    if parent._search_marker is not None:
        update_marker_changes(parent._search_marker, start_index, len(content))
    return type_list_insert_generics_after(transaction, parent, n, content)


def type_list_delete(transaction, parent: AbstractType, index: int, length: int) -> None:
    if length == 0:
        return
    start_index = index
    start_length = length
    marker = find_marker(parent, index)
    n = parent._start
    if marker is not None:
        n = marker.p
        index -= marker.index
    # find the first item to delete
    while n is not None and index > 0:
        if not n.deleted and n.countable:
            if index < n.length:
                get_item_clean_start(transaction, create_id(n.id.client, n.id.clock + index))
            index -= n.length
        n = n.right
    # delete until done
    while length > 0 and n is not None:
        if not n.deleted:
            if length < n.length:
                get_item_clean_start(transaction, create_id(n.id.client, n.id.clock + length))
            n.delete(transaction)
            length -= n.length
        n = n.right
    if length > 0:
        raise IndexError("array length exceeded")
    if parent._search_marker is not None:
        update_marker_changes(parent._search_marker, start_index, -start_length + length)


# ---------------------------------------------------------------------------
# Map primitives (reference AbstractType.js:784-903)
# ---------------------------------------------------------------------------

def type_map_delete(transaction, parent: AbstractType, key: str) -> None:
    c = parent._map.get(key)
    if c is not None:
        c.delete(transaction)


def type_map_set(transaction, parent: AbstractType, key: str, value) -> None:
    left = parent._map.get(key)
    doc = transaction.doc
    own_client_id = doc.client_id
    if value is None or isinstance(value, (int, float, bool, str, list, dict)):
        content = ContentAny([value])
    elif isinstance(value, (bytes, bytearray, memoryview)):
        content = ContentBinary(bytes(value))
    elif isinstance(value, Doc):
        content = ContentDoc(value)
    elif isinstance(value, AbstractType):
        content = ContentType(value)
    else:
        raise TypeError("Unexpected content type")
    Item(
        create_id(own_client_id, get_state(doc.store, own_client_id)),
        left,
        left.last_id if left else None,
        None,
        None,
        parent,
        key,
        content,
    ).integrate(transaction, 0)


def type_map_get(parent: AbstractType, key: str):
    val = parent._map.get(key)
    return val.content.get_content()[val.length - 1] if val is not None and not val.deleted else None


def type_map_get_all(parent: AbstractType) -> dict:
    res = {}
    for key, value in parent._map.items():
        if not value.deleted:
            res[key] = value.content.get_content()[value.length - 1]
    return res


def type_map_has(parent: AbstractType, key: str) -> bool:
    val = parent._map.get(key)
    return val is not None and not val.deleted


def type_map_get_snapshot(parent: AbstractType, key: str, snapshot):
    from ..utils.snapshot import is_visible

    v = parent._map.get(key)
    while v is not None and (
        v.id.client not in snapshot.sv or v.id.clock >= snapshot.sv.get(v.id.client, 0)
    ):
        v = v.left
    return v.content.get_content()[v.length - 1] if v is not None and is_visible(v, snapshot) else None


def create_map_iterator(map_: dict):
    return ((key, item) for key, item in map_.items() if not item.deleted)
