"""YEvent: change description delivered to observers
(reference src/utils/YEvent.js:13-228)."""

from __future__ import annotations

from ..core import is_deleted
from ..lib0.encoding import UNDEFINED


class YEvent:
    def __init__(self, target, transaction):
        self.target = target
        self.current_target = target
        self.transaction = transaction
        self._changes = None

    @property
    def path(self):
        return get_path_to(self.current_target, self.target)

    def deletes(self, struct) -> bool:
        """True if `struct` was deleted by this event's transaction (also
        when added-then-deleted)."""
        return is_deleted(self.transaction.delete_set, struct.id)

    def adds(self, struct) -> bool:
        return struct.id.clock >= self.transaction.before_state.get(struct.id.client, 0)

    @property
    def changes(self) -> dict:
        """Lazily computed {added, deleted, delta, keys}
        (reference YEvent.js:85-187)."""
        changes = self._changes
        if changes is None:
            target = self.target
            added: set = set()
            deleted: set = set()
            delta: list = []
            keys: dict = {}
            changes = {"added": added, "deleted": deleted, "delta": delta, "keys": keys}
            changed = self.transaction.changed.get(target, set())
            if None in changed:
                last_op = None

                def pack_op():
                    if last_op is not None:
                        delta.append(last_op)

                item = target._start
                while item is not None:
                    if item.deleted:
                        if self.deletes(item) and not self.adds(item):
                            if last_op is None or "delete" not in last_op:
                                pack_op()
                                last_op = {"delete": 0}
                            last_op["delete"] += item.length
                            deleted.add(item)
                    else:
                        if self.adds(item):
                            if last_op is None or "insert" not in last_op:
                                pack_op()
                                last_op = {"insert": []}
                            last_op["insert"] = last_op["insert"] + item.content.get_content()
                            added.add(item)
                        else:
                            if last_op is None or "retain" not in last_op:
                                pack_op()
                                last_op = {"retain": 0}
                            last_op["retain"] += item.length
                    item = item.right
                if last_op is not None and "retain" not in last_op:
                    pack_op()
            for key in changed:
                if key is not None:
                    item = target._map.get(key)
                    if self.adds(item):
                        prev = item.left
                        while prev is not None and self.adds(prev):
                            prev = prev.left
                        if self.deletes(item):
                            if prev is not None and self.deletes(prev):
                                action = "delete"
                                old_value = prev.content.get_content()[-1]
                            else:
                                continue
                        else:
                            if prev is not None and self.deletes(prev):
                                action = "update"
                                old_value = prev.content.get_content()[-1]
                            else:
                                action = "add"
                                old_value = UNDEFINED
                    else:
                        if self.deletes(item):
                            action = "delete"
                            old_value = item.content.get_content()[-1]
                        else:
                            continue
                    keys[key] = {"action": action, "oldValue": old_value}
            self._changes = changes
        return changes


def get_path_to(parent, child) -> list:
    """Path of keys/indices from `parent` down to `child`
    (reference YEvent.js:207-228)."""
    path: list = []
    while child._item is not None and child is not parent:
        if child._item.parent_sub is not None:
            path.insert(0, child._item.parent_sub)
        else:
            i = 0
            c = child._item.parent._start
            while c is not child._item and c is not None:
                if not c.deleted:
                    i += 1
                c = c.right
            path.insert(0, i)
        child = child._item.parent
    return path
