"""YText: rich text over ContentString/Embed/Format runs
(reference src/types/YText.js).

Indices are UTF-16 code units (JS string semantics); see lib0/u16.py.
User-facing strings (toString / deltas) are ordinary Python strings; the
internal representation is u16 form.
"""

from __future__ import annotations

from ..core import (
    GC,
    ContentEmbed,
    ContentFormat,
    ContentString,
    Item,
    YTEXT_REF_ID,
    get_item_clean_start,
    get_state,
    iterate_deleted_structs,
    iterate_structs,
    transact,
    type_refs,
)
from ..ids import create_id
from ..lib0.u16 import from_u16, to_u16
from .abstract import (
    AbstractType,
    call_type_observers,
    find_marker,
    type_map_delete,
    type_map_get,
    type_map_get_all,
    type_map_set,
    update_marker_changes,
)
from .events import YEvent


def _js_falsy(v) -> bool:
    return (
        v is None
        or v is False
        or (isinstance(v, (int, float)) and (v == 0 or v != v))
        or (isinstance(v, str) and v == "")
    )


def _or_null(v):
    """JS `v || null`."""
    return None if _js_falsy(v) else v


def _js_strict_eq(a, b) -> bool:
    """JS `===`: identity for objects/arrays, value equality for primitives
    (bool and number are distinct JS types)."""
    if isinstance(a, (dict, list)) or isinstance(b, (dict, list)):
        return a is b
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return a == b


def equal_attrs(a, b) -> bool:
    """JS `===` or flat object equality (reference YText.js:41)."""
    if a is b:
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return len(a) == len(b) and all(k in b and b[k] == v for k, v in a.items())
    if isinstance(a, list) and isinstance(b, list):
        return a == b
    if isinstance(a, (dict, list)) or isinstance(b, (dict, list)):
        return False
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if a is None or b is None:
        return a is b
    return a == b


class ItemTextListPosition:
    """Walker through a YText's item list tracking index + active formatting
    attributes (reference YText.js:43-80)."""

    __slots__ = ("left", "right", "index", "current_attributes")

    def __init__(self, left, right, index: int, current_attributes: dict):
        self.left = left
        self.right = right
        self.index = index
        self.current_attributes = current_attributes

    def forward(self) -> None:
        if self.right is None:
            raise RuntimeError("position out of range")
        content = self.right.content
        if type(content) in (ContentEmbed, ContentString):
            if not self.right.deleted:
                self.index += self.right.length
        elif type(content) is ContentFormat:
            if not self.right.deleted:
                update_current_attributes(self.current_attributes, content)
        self.left = self.right
        self.right = self.right.right


def find_next_position(transaction, pos: ItemTextListPosition, count: int) -> ItemTextListPosition:
    while pos.right is not None and count > 0:
        content = pos.right.content
        tc = type(content)
        if tc in (ContentEmbed, ContentString):
            if not pos.right.deleted:
                if count < pos.right.length:
                    # split right
                    get_item_clean_start(
                        transaction, create_id(pos.right.id.client, pos.right.id.clock + count)
                    )
                pos.index += pos.right.length
                count -= pos.right.length
        elif tc is ContentFormat:
            if not pos.right.deleted:
                update_current_attributes(pos.current_attributes, content)
        pos.left = pos.right
        pos.right = pos.right.right
    return pos


def find_position(transaction, parent, index: int) -> ItemTextListPosition:
    current_attributes: dict = {}
    marker = find_marker(parent, index)
    if marker is not None:
        pos = ItemTextListPosition(marker.p.left, marker.p, marker.index, current_attributes)
        return find_next_position(transaction, pos, index - marker.index)
    pos = ItemTextListPosition(None, parent._start, 0, current_attributes)
    return find_next_position(transaction, pos, index)


def insert_negated_attributes(transaction, parent, curr_pos: ItemTextListPosition, negated_attributes: dict) -> None:
    """Close formatting ranges after an insert (reference YText.js:150-173)."""
    while curr_pos.right is not None and (
        curr_pos.right.deleted
        or (
            type(curr_pos.right.content) is ContentFormat
            and equal_attrs(
                negated_attributes.get(curr_pos.right.content.key),
                curr_pos.right.content.value,
            )
        )
    ):
        if not curr_pos.right.deleted:
            negated_attributes.pop(curr_pos.right.content.key, None)
        curr_pos.forward()
    doc = transaction.doc
    own_client_id = doc.client_id
    left = curr_pos.left
    right = curr_pos.right
    for key, val in negated_attributes.items():
        left = Item(
            create_id(own_client_id, get_state(doc.store, own_client_id)),
            left,
            left.last_id if left else None,
            right,
            right.id if right else None,
            parent,
            None,
            ContentFormat(key, val),
        )
        left.integrate(transaction, 0)


def update_current_attributes(current_attributes: dict, fmt: ContentFormat) -> None:
    if fmt.value is None:
        current_attributes.pop(fmt.key, None)
    else:
        current_attributes[fmt.key] = fmt.value


def minimize_attribute_changes(curr_pos: ItemTextListPosition, attributes: dict) -> None:
    """Skip over formats that already match (reference YText.js:198-210)."""
    while True:
        if curr_pos.right is None:
            break
        if curr_pos.right.deleted or (
            type(curr_pos.right.content) is ContentFormat
            and equal_attrs(
                _or_null(attributes.get(curr_pos.right.content.key)),
                curr_pos.right.content.value,
            )
        ):
            pass
        else:
            break
        curr_pos.forward()


def insert_attributes(transaction, parent, curr_pos: ItemTextListPosition, attributes: dict) -> dict:
    doc = transaction.doc
    own_client_id = doc.client_id
    negated_attributes: dict = {}
    for key, val in attributes.items():
        current_val = _or_null(curr_pos.current_attributes.get(key))
        if not equal_attrs(current_val, val):
            negated_attributes[key] = current_val
            left = curr_pos.left
            right = curr_pos.right
            curr_pos.right = Item(
                create_id(own_client_id, get_state(doc.store, own_client_id)),
                left,
                left.last_id if left else None,
                right,
                right.id if right else None,
                parent,
                None,
                ContentFormat(key, val),
            )
            curr_pos.right.integrate(transaction, 0)
            curr_pos.forward()
    return negated_attributes


def insert_text(transaction, parent, curr_pos: ItemTextListPosition, text, attributes: dict) -> None:
    """(reference YText.js:252-274). ``text`` is a u16-form str or an embed
    dict."""
    for key in curr_pos.current_attributes:
        if key not in attributes:
            attributes[key] = None
    doc = transaction.doc
    own_client_id = doc.client_id
    minimize_attribute_changes(curr_pos, attributes)
    negated_attributes = insert_attributes(transaction, parent, curr_pos, attributes)
    content = ContentString(text) if isinstance(text, str) else ContentEmbed(text)
    left = curr_pos.left
    right = curr_pos.right
    index = curr_pos.index
    if parent._search_marker is not None:
        update_marker_changes(parent._search_marker, curr_pos.index, content.get_length())
    right = Item(
        create_id(own_client_id, get_state(doc.store, own_client_id)),
        left,
        left.last_id if left else None,
        right,
        right.id if right else None,
        parent,
        None,
        content,
    )
    right.integrate(transaction, 0)
    curr_pos.right = right
    curr_pos.index = index
    curr_pos.forward()
    insert_negated_attributes(transaction, parent, curr_pos, negated_attributes)


def format_text(transaction, parent, curr_pos: ItemTextListPosition, length: int, attributes: dict) -> None:
    """(reference YText.js:286-333)."""
    doc = transaction.doc
    own_client_id = doc.client_id
    minimize_attribute_changes(curr_pos, attributes)
    negated_attributes = insert_attributes(transaction, parent, curr_pos, attributes)
    while length > 0 and curr_pos.right is not None:
        if not curr_pos.right.deleted:
            content = curr_pos.right.content
            tc = type(content)
            if tc is ContentFormat:
                if content.key in attributes:
                    attr = attributes[content.key]
                    if equal_attrs(attr, content.value):
                        negated_attributes.pop(content.key, None)
                    else:
                        negated_attributes[content.key] = content.value
                    curr_pos.right.delete(transaction)
            elif tc in (ContentEmbed, ContentString):
                if length < curr_pos.right.length:
                    get_item_clean_start(
                        transaction,
                        create_id(curr_pos.right.id.client, curr_pos.right.id.clock + length),
                    )
                length -= curr_pos.right.length
        curr_pos.forward()
    # Quill assumes the editor ends with a newline; pad if formatting past end
    if length > 0:
        newlines = "\n" * length
        curr_pos.right = Item(
            create_id(own_client_id, get_state(doc.store, own_client_id)),
            curr_pos.left,
            curr_pos.left.last_id if curr_pos.left else None,
            curr_pos.right,
            curr_pos.right.id if curr_pos.right else None,
            parent,
            None,
            ContentString(newlines),
        )
        curr_pos.right.integrate(transaction, 0)
        curr_pos.forward()
    insert_negated_attributes(transaction, parent, curr_pos, negated_attributes)


def cleanup_formatting_gap(transaction, start, end, start_attributes: dict, end_attributes: dict) -> int:
    """Delete redundant format markers inside a deleted gap
    (reference YText.js:348-374)."""
    while end is not None and type(end.content) is not ContentString and type(end.content) is not ContentEmbed:
        if not end.deleted and type(end.content) is ContentFormat:
            update_current_attributes(end_attributes, end.content)
        end = end.right
    cleanups = 0
    while start is not end:
        if not start.deleted:
            content = start.content
            if type(content) is ContentFormat:
                # the reference compares with JS === here (identity for
                # objects), not deep equality (YText.js:362)
                if not _js_strict_eq(
                    _or_null(end_attributes.get(content.key)), content.value
                ) or _js_strict_eq(
                    _or_null(start_attributes.get(content.key)), content.value
                ):
                    start.delete(transaction)
                    cleanups += 1
        start = start.right
    return cleanups


def cleanup_contextless_formatting_gap(transaction, item) -> None:
    """(reference YText.js:380-398)."""
    while item is not None and item.right is not None and (
        item.right.deleted
        or (
            type(item.right.content) is not ContentString
            and type(item.right.content) is not ContentEmbed
        )
    ):
        item = item.right
    attrs = set()
    while item is not None and (
        item.deleted
        or (type(item.content) is not ContentString and type(item.content) is not ContentEmbed)
    ):
        if not item.deleted and type(item.content) is ContentFormat:
            key = item.content.key
            if key in attrs:
                item.delete(transaction)
            else:
                attrs.add(key)
        item = item.left


def cleanup_ytext_formatting(type_: "YText") -> int:
    """Full two-pass formatting cleanup (reference YText.js:412-437)."""
    res = 0

    def _run(transaction):
        nonlocal res
        start = type_._start
        end = type_._start
        start_attributes: dict = {}
        current_attributes = dict(start_attributes)
        while end is not None:
            if end.deleted is False:
                tc = type(end.content)
                if tc is ContentFormat:
                    update_current_attributes(current_attributes, end.content)
                elif tc in (ContentEmbed, ContentString):
                    res += cleanup_formatting_gap(
                        transaction, start, end, start_attributes, current_attributes
                    )
                    start_attributes = dict(current_attributes)
                    start = end
            end = end.right

    transact(type_.doc, _run)
    return res


def delete_text(transaction, curr_pos: ItemTextListPosition, length: int) -> ItemTextListPosition:
    """(reference YText.js:448-475)."""
    start_length = length
    start_attrs = dict(curr_pos.current_attributes)
    start = curr_pos.right
    while length > 0 and curr_pos.right is not None:
        if curr_pos.right.deleted is False:
            tc = type(curr_pos.right.content)
            if tc in (ContentEmbed, ContentString):
                if length < curr_pos.right.length:
                    get_item_clean_start(
                        transaction,
                        create_id(curr_pos.right.id.client, curr_pos.right.id.clock + length),
                    )
                length -= curr_pos.right.length
                curr_pos.right.delete(transaction)
        curr_pos.forward()
    if start is not None:
        cleanup_formatting_gap(
            transaction, start, curr_pos.right, start_attrs, dict(curr_pos.current_attributes)
        )
    parent = (curr_pos.left if curr_pos.left is not None else curr_pos.right).parent
    if parent._search_marker is not None:
        update_marker_changes(parent._search_marker, curr_pos.index, -start_length + length)
    return curr_pos


class YTextEvent(YEvent):
    """(reference YText.js:515-733)."""

    def __init__(self, ytext, transaction, subs):
        super().__init__(ytext, transaction)
        self._delta = None
        self.child_list_changed = False
        self.keys_changed = set()
        for sub in subs:
            if sub is None:
                self.child_list_changed = True
            else:
                self.keys_changed.add(sub)

    @property
    def delta(self) -> list:
        if self._delta is None:
            y = self.target.doc
            self._delta = []

            def _compute(transaction):
                delta = self._delta
                current_attributes: dict = {}
                old_attributes: dict = {}
                item = self.target._start
                state = {"action": None, "insert": "", "retain": 0, "delete_len": 0}
                attributes: dict = {}

                def add_op():
                    action = state["action"]
                    if action is not None:
                        if action == "delete":
                            op = {"delete": state["delete_len"]}
                            state["delete_len"] = 0
                        elif action == "insert":
                            ins = state["insert"]
                            op = {"insert": from_u16(ins) if isinstance(ins, str) else ins}
                            if current_attributes:
                                op["attributes"] = {
                                    key: value
                                    for key, value in current_attributes.items()
                                    if value is not None
                                }
                            state["insert"] = ""
                        else:  # retain
                            op = {"retain": state["retain"]}
                            if attributes:
                                op["attributes"] = dict(attributes)
                            state["retain"] = 0
                        delta.append(op)
                        state["action"] = None

                while item is not None:
                    tc = type(item.content)
                    if tc is ContentEmbed:
                        if self.adds(item):
                            if not self.deletes(item):
                                add_op()
                                state["action"] = "insert"
                                state["insert"] = item.content.embed
                                add_op()
                        elif self.deletes(item):
                            if state["action"] != "delete":
                                add_op()
                                state["action"] = "delete"
                            state["delete_len"] += 1
                        elif not item.deleted:
                            if state["action"] != "retain":
                                add_op()
                                state["action"] = "retain"
                            state["retain"] += 1
                    elif tc is ContentString:
                        if self.adds(item):
                            if not self.deletes(item):
                                if state["action"] != "insert":
                                    add_op()
                                    state["action"] = "insert"
                                state["insert"] += item.content.str
                        elif self.deletes(item):
                            if state["action"] != "delete":
                                add_op()
                                state["action"] = "delete"
                            state["delete_len"] += item.length
                        elif not item.deleted:
                            if state["action"] != "retain":
                                add_op()
                                state["action"] = "retain"
                            state["retain"] += item.length
                    elif tc is ContentFormat:
                        key = item.content.key
                        value = item.content.value
                        if self.adds(item):
                            if not self.deletes(item):
                                cur_val = _or_null(current_attributes.get(key))
                                if not equal_attrs(cur_val, value):
                                    if state["action"] == "retain":
                                        add_op()
                                    if equal_attrs(value, _or_null(old_attributes.get(key))):
                                        attributes.pop(key, None)
                                    else:
                                        attributes[key] = value
                                else:
                                    item.delete(transaction)
                        elif self.deletes(item):
                            old_attributes[key] = value
                            cur_val = _or_null(current_attributes.get(key))
                            if not equal_attrs(cur_val, value):
                                if state["action"] == "retain":
                                    add_op()
                                attributes[key] = cur_val
                        elif not item.deleted:
                            old_attributes[key] = value
                            if key in attributes:
                                attr = attributes[key]
                                if not equal_attrs(attr, value):
                                    if state["action"] == "retain":
                                        add_op()
                                    if value is None:
                                        attributes[key] = value
                                    else:
                                        attributes.pop(key, None)
                                else:
                                    item.delete(transaction)
                        if not item.deleted:
                            if state["action"] == "insert":
                                add_op()
                            update_current_attributes(current_attributes, item.content)
                    item = item.right
                add_op()
                while delta:
                    last_op = delta[-1]
                    if "retain" in last_op and "attributes" not in last_op:
                        delta.pop()
                    else:
                        break

            transact(y, _compute)
        return self._delta


class YText(AbstractType):
    def __init__(self, string: str | None = None):
        super().__init__()
        self._pending: list | None = (
            [lambda: self.insert(0, string)] if string is not None else []
        )
        self._search_marker = []

    @property
    def length(self) -> int:
        return self._length

    def __len__(self) -> int:
        return self._length

    def _integrate(self, y, item) -> None:
        super()._integrate(y, item)
        try:
            for f in self._pending:
                f()
        except Exception as e:  # reference logs and continues (YText.js:776-780)
            import sys

            print(e, file=sys.stderr)
        self._pending = None

    def _copy(self) -> "YText":
        return YText()

    def clone(self) -> "YText":
        text = YText()
        text.apply_delta(self.to_delta())
        return text

    def _call_observer(self, transaction, parent_subs) -> None:
        super()._call_observer(transaction, parent_subs)
        event = YTextEvent(self, transaction, parent_subs)
        doc = transaction.doc
        if not transaction.local:
            # remote change: clean up potential formatting duplicates
            # (reference YText.js:803-856)
            found_formatting_item = False
            for client, after_clock in transaction.after_state.items():
                clock = transaction.before_state.get(client, 0)
                if after_clock == clock:
                    continue

                def _check(item):
                    nonlocal found_formatting_item
                    if (
                        not item.deleted
                        and type(item) is Item
                        and type(item.content) is ContentFormat
                    ):
                        found_formatting_item = True

                iterate_structs(
                    transaction, doc.store.clients[client], clock, after_clock, _check
                )
                if found_formatting_item:
                    break
            if not found_formatting_item:
                def _check_deleted(item):
                    nonlocal found_formatting_item
                    if type(item) is GC or found_formatting_item:
                        return
                    if item.parent is self and type(item.content) is ContentFormat:
                        found_formatting_item = True

                iterate_deleted_structs(transaction, transaction.delete_set, _check_deleted)

            def _cleanup(t):
                if found_formatting_item:
                    cleanup_ytext_formatting(self)
                else:
                    def _gap(item):
                        if type(item) is GC:
                            return
                        if item.parent is self:
                            cleanup_contextless_formatting_gap(t, item)

                    iterate_deleted_structs(t, t.delete_set, _gap)

            transact(doc, _cleanup)
        call_type_observers(self, transaction, event)

    def to_string(self) -> str:
        parts = []
        n = self._start
        while n is not None:
            if not n.deleted and n.countable and type(n.content) is ContentString:
                parts.append(n.content.str)
            n = n.right
        return from_u16("".join(parts))

    def __str__(self) -> str:
        return self.to_string()

    def to_json(self) -> str:
        return self.to_string()

    def apply_delta(self, delta: list, sanitize: bool = True) -> None:
        """(reference YText.js:898-924)."""
        if self.doc is not None:
            def _apply(transaction):
                curr_pos = ItemTextListPosition(None, self._start, 0, {})
                for i, op in enumerate(delta):
                    if "insert" in op:
                        ins = op["insert"]
                        if (
                            not sanitize
                            and isinstance(ins, str)
                            and i == len(delta) - 1
                            and curr_pos.right is None
                            and ins.endswith("\n")
                        ):
                            ins = ins[:-1]
                        if not isinstance(ins, str) or len(ins) > 0:
                            if isinstance(ins, str):
                                ins = to_u16(ins)
                            insert_text(
                                transaction, self, curr_pos, ins, dict(op.get("attributes", {}))
                            )
                    elif "retain" in op:
                        format_text(
                            transaction,
                            self,
                            curr_pos,
                            op["retain"],
                            dict(op.get("attributes", {})),
                        )
                    elif "delete" in op:
                        delete_text(transaction, curr_pos, op["delete"])

            transact(self.doc, _apply)
        else:
            self._pending.append(lambda: self.apply_delta(delta, sanitize))

    def to_delta(self, snapshot=None, prev_snapshot=None, compute_ychange=None) -> list:
        """Delta representation, optionally as a two-snapshot diff with
        ychange attribution (reference YText.js:936-1030)."""
        from ..utils.snapshot import is_visible, split_snapshot_affected_structs

        ops: list = []
        current_attributes: dict = {}
        doc = self.doc
        parts: list[str] = []

        def pack_str():
            if parts:
                s = from_u16("".join(parts))
                op = {"insert": s}
                if current_attributes:
                    op["attributes"] = dict(current_attributes)
                ops.append(op)
                parts.clear()

        def _compute(transaction):
            nonlocal current_attributes
            if snapshot is not None:
                split_snapshot_affected_structs(transaction, snapshot)
            if prev_snapshot is not None:
                split_snapshot_affected_structs(transaction, prev_snapshot)
            n = self._start
            while n is not None:
                if is_visible(n, snapshot) or (
                    prev_snapshot is not None and is_visible(n, prev_snapshot)
                ):
                    tc = type(n.content)
                    if tc is ContentString:
                        cur = current_attributes.get("ychange")
                        if snapshot is not None and not is_visible(n, snapshot):
                            if (
                                cur is None
                                or cur.get("user") != n.id.client
                                or cur.get("state") != "removed"
                            ):
                                pack_str()
                                current_attributes["ychange"] = (
                                    compute_ychange("removed", n.id)
                                    if compute_ychange
                                    else {"type": "removed"}
                                )
                        elif prev_snapshot is not None and not is_visible(n, prev_snapshot):
                            if (
                                cur is None
                                or cur.get("user") != n.id.client
                                or cur.get("state") != "added"
                            ):
                                pack_str()
                                current_attributes["ychange"] = (
                                    compute_ychange("added", n.id)
                                    if compute_ychange
                                    else {"type": "added"}
                                )
                        elif cur is not None:
                            pack_str()
                            current_attributes.pop("ychange", None)
                        parts.append(n.content.str)
                    elif tc is ContentEmbed:
                        pack_str()
                        op = {"insert": n.content.embed}
                        if current_attributes:
                            op["attributes"] = dict(current_attributes)
                        ops.append(op)
                    elif tc is ContentFormat:
                        if is_visible(n, snapshot):
                            pack_str()
                            update_current_attributes(current_attributes, n.content)
                n = n.right
            pack_str()

        transact(doc, _compute, split_snapshot_affected_structs)
        return ops

    def insert(self, index: int, text: str, attributes: dict | None = None) -> None:
        if len(text) <= 0:
            return
        y = self.doc
        if y is not None:
            u16text = to_u16(text)

            def _ins(transaction):
                pos = find_position(transaction, self, index)
                attrs = attributes
                if attrs is None:
                    attrs = dict(pos.current_attributes)
                insert_text(transaction, self, pos, u16text, dict(attrs))

            transact(y, _ins)
        else:
            self._pending.append(lambda: self.insert(index, text, attributes))

    def insert_embed(self, index: int, embed: dict, attributes: dict | None = None) -> None:
        if not isinstance(embed, dict):
            raise TypeError("Embed must be a dict")
        y = self.doc
        if y is not None:
            def _ins(transaction):
                pos = find_position(transaction, self, index)
                insert_text(transaction, self, pos, embed, dict(attributes or {}))

            transact(y, _ins)
        else:
            self._pending.append(lambda: self.insert_embed(index, embed, attributes))

    def delete(self, index: int, length: int) -> None:
        if length == 0:
            return
        y = self.doc
        if y is not None:
            transact(
                y, lambda txn: delete_text(txn, find_position(txn, self, index), length)
            )
        else:
            self._pending.append(lambda: self.delete(index, length))

    def format(self, index: int, length: int, attributes: dict) -> None:
        if length == 0:
            return
        y = self.doc
        if y is not None:
            def _fmt(transaction):
                pos = find_position(transaction, self, index)
                if pos.right is None:
                    return
                format_text(transaction, self, pos, length, dict(attributes))

            transact(y, _fmt)
        else:
            self._pending.append(lambda: self.format(index, length, attributes))

    def remove_attribute(self, attribute_name: str) -> None:
        if self.doc is not None:
            transact(self.doc, lambda txn: type_map_delete(txn, self, attribute_name))
        else:
            self._pending.append(lambda: self.remove_attribute(attribute_name))

    def set_attribute(self, attribute_name: str, attribute_value) -> None:
        if self.doc is not None:
            transact(
                self.doc, lambda txn: type_map_set(txn, self, attribute_name, attribute_value)
            )
        else:
            self._pending.append(lambda: self.set_attribute(attribute_name, attribute_value))

    def get_attribute(self, attribute_name: str):
        return type_map_get(self, attribute_name)

    def get_attributes(self, snapshot=None) -> dict:
        return type_map_get_all(self)

    def _write(self, encoder) -> None:
        encoder.write_type_ref(YTEXT_REF_ID)


def read_ytext(_decoder) -> YText:
    return YText()


type_refs[YTEXT_REF_ID] = read_ytext
