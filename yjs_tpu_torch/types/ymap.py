"""YMap: shared last-writer-wins map (reference src/types/YMap.js)."""

from __future__ import annotations

from ..core import YMAP_REF_ID, transact, type_refs
from .abstract import (
    AbstractType,
    call_type_observers,
    create_map_iterator,
    type_map_delete,
    type_map_get,
    type_map_has,
    type_map_set,
)
from .events import YEvent


class YMapEvent(YEvent):
    def __init__(self, ymap, transaction, subs):
        super().__init__(ymap, transaction)
        self.keys_changed = subs


class YMap(AbstractType):
    def __init__(self, entries=None):
        super().__init__()
        self._prelim_content: dict | None = dict(entries) if entries is not None else {}

    def _integrate(self, y, item) -> None:
        super()._integrate(y, item)
        for key, value in self._prelim_content.items():
            self.set(key, value)
        self._prelim_content = None

    def _copy(self) -> "YMap":
        return YMap()

    def clone(self) -> "YMap":
        m = YMap()

        def _cp(value, key, _t):
            m.set(key, value.clone() if isinstance(value, AbstractType) else value)

        self.for_each(_cp)
        return m

    def _call_observer(self, transaction, parent_subs) -> None:
        call_type_observers(self, transaction, YMapEvent(self, transaction, parent_subs))

    def to_json(self) -> dict:
        result = {}
        for key, item in self._map.items():
            if not item.deleted:
                v = item.content.get_content()[item.length - 1]
                result[key] = v.to_json() if isinstance(v, AbstractType) else v
        return result

    @property
    def size(self) -> int:
        return sum(1 for _ in create_map_iterator(self._map))

    def __len__(self) -> int:
        return self.size

    def keys(self):
        return (v[0] for v in create_map_iterator(self._map))

    def values(self):
        return (v[1].content.get_content()[v[1].length - 1] for v in create_map_iterator(self._map))

    def entries(self):
        return (
            (v[0], v[1].content.get_content()[v[1].length - 1])
            for v in create_map_iterator(self._map)
        )

    def for_each(self, f) -> None:
        for key, item in self._map.items():
            if not item.deleted:
                f(item.content.get_content()[item.length - 1], key, self)

    def __iter__(self):
        return self.entries()

    def delete(self, key: str) -> None:
        if self.doc is not None:
            transact(self.doc, lambda txn: type_map_delete(txn, self, key))
        else:
            self._prelim_content.pop(key, None)

    def set(self, key: str, value):
        if self.doc is not None:
            transact(self.doc, lambda txn: type_map_set(txn, self, key, value))
        else:
            self._prelim_content[key] = value
        return value

    def get(self, key: str):
        return type_map_get(self, key)

    def __getitem__(self, key: str):
        return self.get(key)

    def __setitem__(self, key: str, value):
        self.set(key, value)

    def has(self, key: str) -> bool:
        return type_map_has(self, key)

    def __contains__(self, key: str) -> bool:
        return self.has(key)

    def _write(self, encoder) -> None:
        encoder.write_type_ref(YMAP_REF_ID)


def read_ymap(_decoder) -> YMap:
    return YMap()


type_refs[YMAP_REF_ID] = read_ymap
