"""Server-side undo/redo for device-resident rooms.

The reference UndoManager (src/utils/UndoManager.js:19-296) is item-graph
surgery: popping a stack item walks the struct store, follows persistent
``redone`` pointers left by earlier undos, pins kept items, and rebuilds
deleted items with fresh ids (redoItem, Item.js).  That state — redone
links, keep flags, the item graph itself — must PERSIST between undo and
redo calls, so a correct server-side undo cannot be recomputed on demand
from the engine's columnar state.

Design: an opt-in PER-ROOM CPU REPLICA.  :class:`RoomUndo` feeds every
update the room receives into a ``Doc(gc=False)`` replica and runs the
reference-exact :class:`~yjs_tpu.utils.undo.UndoManager` on it.  Calling
``undo()``/``redo()`` performs the reverting transaction on the replica,
captures the update it emits, and hands it back for the engine + the
room's peers — the device-resident room applies it through the normal
batched flush path like any other client edit.

Why not a native/device undo: undo volume is interactive (a keypress,
not a batch); the work is pointer-chasing over exactly the item graph
the CPU core already models; and the replica is required anyway for the
persistent redone/keep state.  Rooms that never enable undo pay nothing;
rooms that do pay one CPU replica — the same cost profile as the
reference, where the UndoManager's host doc IS that replica.
"""

from __future__ import annotations

from ..core import Doc
from ..updates import apply_update, apply_update_v2
from .undo import UndoManager

#: origin tag for updates that should land on the room's undo stack
TRACKED = "room-undo-tracked"

_GETTERS = {
    "text": Doc.get_text,
    "map": Doc.get_map,
    "array": Doc.get_array,
    "xml": Doc.get_xml_fragment,
}


class RoomUndo:
    """Reference-semantics undo/redo stack for one provider room.

    ``scopes`` is a list of ``(kind, name)`` root-type scopes (kind in
    ``text|map|array|xml``) the stack tracks — the UndoManager scope
    filter (reference UndoManager.js:19-41).  Updates fed with
    ``tracked=True`` (or an origin in ``tracked_origins``) are undoable;
    everything else is foreign traffic that undo must not revert."""

    def __init__(
        self,
        initial_state: bytes | None,
        scopes=(("text", "text"),),
        capture_timeout: float = 500,
        delete_filter=None,
    ):
        self.replica = Doc(gc=False)
        if initial_state:
            apply_update(self.replica, initial_state)
        scope_types = [
            _GETTERS[kind](self.replica, name) for kind, name in scopes
        ]
        self.manager = UndoManager(
            scope_types,
            capture_timeout=capture_timeout,
            delete_filter=delete_filter,
            tracked_origins={TRACKED},
        )

    # -- update ingestion ---------------------------------------------------

    def apply_update(self, update: bytes, tracked: bool, v2: bool = False):
        """Feed one room update into the replica.  ``tracked`` updates
        land on the undo stack; foreign ones only advance the state."""
        origin = TRACKED if tracked else "room-undo-foreign"
        if v2:
            apply_update_v2(self.replica, update, origin)
        else:
            apply_update(self.replica, update, origin)

    # -- undo / redo --------------------------------------------------------

    def _capture(self, op) -> bytes | None:
        collected: list[bytes] = []

        def on_update(update, _origin, _doc):
            collected.append(update)

        self.replica.on("update", on_update)
        try:
            popped = op()
        finally:
            self.replica.off("update", on_update)
        if popped is None or not collected:
            return None
        if len(collected) == 1:
            return collected[0]
        from ..updates import merge_updates

        return merge_updates(collected)

    def undo(self) -> bytes | None:
        """Revert the room's last tracked change; returns the update to
        apply to the room (and broadcast), or None if nothing to undo."""
        return self._capture(self.manager.undo)

    def redo(self) -> bytes | None:
        return self._capture(self.manager.redo)

    @property
    def can_undo(self) -> bool:
        return bool(self.manager.undo_stack)

    @property
    def can_redo(self) -> bool:
        return bool(self.manager.redo_stack)

    def stop_capturing(self) -> None:
        self.manager.stop_capturing()

    def clear(self) -> None:
        self.manager.clear()
