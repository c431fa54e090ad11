"""UndoManager: selective, scope-filtered undo/redo
(reference src/utils/UndoManager.js)."""

from __future__ import annotations

import time as _time

from ..core import (
    GC,
    DeleteSet,
    Item,
    get_item_clean_start,
    get_state,
    is_parent_of,
    iterate_deleted_structs,
    iterate_structs,
    keep_item,
    merge_delete_sets,
    redo_item,
    follow_redone,
    transact,
)
from ..ids import create_id
from ..lib0.observable import Observable


class StackItem:
    __slots__ = ("ds", "before_state", "after_state", "meta")

    def __init__(self, ds: DeleteSet, before_state: dict, after_state: dict):
        self.ds = ds
        self.before_state = before_state
        self.after_state = after_state
        self.meta: dict = {}


def _pop_stack_item(undo_manager: "UndoManager", stack: list, event_type: str):
    """(reference UndoManager.js:42-134)."""
    result = None
    doc = undo_manager.doc
    scope = undo_manager.scope

    def _run(transaction):
        nonlocal result
        while stack and result is None:
            store = doc.store
            stack_item = stack.pop()
            items_to_redo: set = set()
            items_to_delete: list = []
            performed_change = False
            for client, end_clock in stack_item.after_state.items():
                start_clock = stack_item.before_state.get(client, 0)
                length = end_clock - start_clock
                structs = store.clients.get(client)
                if start_clock != end_clock:
                    # keep the created range split-aligned before iterating
                    get_item_clean_start(transaction, create_id(client, start_clock))
                    if end_clock < get_state(doc.store, client):
                        get_item_clean_start(transaction, create_id(client, end_clock))

                    def _collect(struct):
                        if type(struct) is Item:
                            if struct.redone is not None:
                                item, diff = follow_redone(store, struct.id)
                                if diff > 0:
                                    item = get_item_clean_start(
                                        transaction, create_id(item.id.client, item.id.clock + diff)
                                    )
                                if item.length > length:
                                    get_item_clean_start(
                                        transaction, create_id(item.id.client, end_clock)
                                    )
                                struct = item
                            if not struct.deleted and any(
                                is_parent_of(type_, struct) for type_ in scope
                            ):
                                items_to_delete.append(struct)

                    iterate_structs(transaction, structs, start_clock, length, _collect)

            def _collect_redo(struct):
                clock = struct.id.clock
                client = struct.id.client
                start_clock = stack_item.before_state.get(client, 0)
                end_clock = stack_item.after_state.get(client, 0)
                if (
                    type(struct) is Item
                    and any(is_parent_of(type_, struct) for type_ in scope)
                    and not (start_clock <= clock < end_clock)
                ):
                    items_to_redo.add(struct)

            iterate_deleted_structs(transaction, stack_item.ds, _collect_redo)
            for struct in items_to_redo:
                performed_change = (
                    redo_item(transaction, struct, items_to_redo) is not None
                ) or performed_change
            # delete in reverse so children are deleted before parents
            for item in reversed(items_to_delete):
                if undo_manager.delete_filter(item):
                    item.delete(transaction)
                    performed_change = True
            # v13.4.9 quirk: result is set unconditionally (performed_change
            # is tracked but unused, reference UndoManager.js:62,121)
            del performed_change
            result = stack_item
        for type_, sub_props in transaction.changed.items():
            if None in sub_props and type_._search_marker is not None:
                type_._search_marker.clear()

    transact(doc, _run, undo_manager)
    if result is not None:
        undo_manager.emit(
            "stack-item-popped", [{"stackItem": result, "type": event_type}, undo_manager]
        )
    return result


class UndoManager(Observable):
    """Track transactions on a set of scope types and selectively revert
    them.  ``tracked_origins`` filters which transaction origins count."""

    def __init__(
        self,
        type_scope,
        capture_timeout: float = 500,
        delete_filter=None,
        tracked_origins: set | None = None,
    ):
        super().__init__()
        self.scope = type_scope if isinstance(type_scope, list) else [type_scope]
        self.delete_filter = delete_filter if delete_filter is not None else (lambda item: True)
        self.tracked_origins = tracked_origins if tracked_origins is not None else {None}
        self.tracked_origins.add(self)
        self.undo_stack: list[StackItem] = []
        self.redo_stack: list[StackItem] = []
        self.undoing = False
        self.redoing = False
        self.doc = self.scope[0].doc
        self.last_change = 0.0
        self.capture_timeout = capture_timeout
        self.doc.on("afterTransaction", self._after_transaction)

    def _tracks_origin(self, origin) -> bool:
        try:
            if origin in self.tracked_origins:
                return True
        except TypeError:
            pass
        return origin is not None and type(origin) in self.tracked_origins

    def _after_transaction(self, transaction, _doc) -> None:
        """(reference UndoManager.js:183-219)."""
        if not any(
            type_ in transaction.changed_parent_types for type_ in self.scope
        ) or not self._tracks_origin(transaction.origin):
            return
        undoing = self.undoing
        redoing = self.redoing
        stack = self.redo_stack if undoing else self.undo_stack
        if undoing:
            self.stop_capturing()  # next undo should not merge into last item
        elif not redoing:
            self.redo_stack = []
        before_state = transaction.before_state
        after_state = transaction.after_state
        now = _time.time() * 1000
        if (
            now - self.last_change < self.capture_timeout
            and stack
            and not undoing
            and not redoing
        ):
            last_op = stack[-1]
            last_op.ds = merge_delete_sets([last_op.ds, transaction.delete_set])
            last_op.after_state = after_state
        else:
            stack.append(StackItem(transaction.delete_set, before_state, after_state))
        if not undoing and not redoing:
            self.last_change = now

        def _keep(item):
            if type(item) is Item and any(is_parent_of(type_, item) for type_ in self.scope):
                keep_item(item, True)

        iterate_deleted_structs(transaction, transaction.delete_set, _keep)
        self.emit(
            "stack-item-added",
            [
                {
                    "stackItem": stack[-1],
                    "origin": transaction.origin,
                    "type": "redo" if undoing else "undo",
                },
                self,
            ],
        )

    def clear(self) -> None:
        def _run(transaction):
            def clear_item(stack_item):
                def _unkeep(item):
                    if type(item) is Item and any(
                        is_parent_of(type_, item) for type_ in self.scope
                    ):
                        keep_item(item, False)

                iterate_deleted_structs(transaction, stack_item.ds, _unkeep)

            for stack_item in self.undo_stack:
                clear_item(stack_item)
            for stack_item in self.redo_stack:
                clear_item(stack_item)

        self.doc.transact(_run)
        self.undo_stack = []
        self.redo_stack = []

    def stop_capturing(self) -> None:
        self.last_change = 0.0

    def undo(self):
        self.undoing = True
        try:
            return _pop_stack_item(self, self.undo_stack, "undo")
        finally:
            self.undoing = False

    def redo(self):
        self.redoing = True
        try:
            return _pop_stack_item(self, self.redo_stack, "redo")
        finally:
            self.redoing = False
