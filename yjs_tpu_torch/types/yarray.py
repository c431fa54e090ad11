"""YArray: shared list (reference src/types/YArray.js)."""

from __future__ import annotations

from ..core import YARRAY_REF_ID, transact, type_refs
from .abstract import (
    AbstractType,
    call_type_observers,
    type_list_create_iterator,
    type_list_delete,
    type_list_for_each,
    type_list_get,
    type_list_insert_generics,
    type_list_map,
    type_list_slice,
    type_list_to_array,
)
from .events import YEvent


class YArrayEvent(YEvent):
    pass


class YArray(AbstractType):
    def __init__(self):
        super().__init__()
        self._prelim_content: list | None = []
        self._search_marker = []

    @staticmethod
    def from_(items: list) -> "YArray":
        a = YArray()
        a.push(items)
        return a

    def _integrate(self, y, item) -> None:
        super()._integrate(y, item)
        self.insert(0, self._prelim_content)
        self._prelim_content = None

    def _copy(self) -> "YArray":
        return YArray()

    def clone(self) -> "YArray":
        arr = YArray()
        arr.insert(
            0,
            [el.clone() if isinstance(el, AbstractType) else el for el in self.to_array()],
        )
        return arr

    @property
    def length(self) -> int:
        return self._length if self._prelim_content is None else len(self._prelim_content)

    def __len__(self) -> int:
        return self.length

    def _call_observer(self, transaction, parent_subs) -> None:
        super()._call_observer(transaction, parent_subs)
        call_type_observers(self, transaction, YArrayEvent(self, transaction))

    def insert(self, index: int, content: list) -> None:
        if self.doc is not None:
            transact(self.doc, lambda txn: type_list_insert_generics(txn, self, index, content))
        else:
            self._prelim_content[index:index] = content

    def push(self, content: list) -> None:
        self.insert(self.length, content)

    def unshift(self, content: list) -> None:
        self.insert(0, content)

    def delete(self, index: int, length: int = 1) -> None:
        if self.doc is not None:
            transact(self.doc, lambda txn: type_list_delete(txn, self, index, length))
        else:
            del self._prelim_content[index:index + length]

    def get(self, index: int):
        return type_list_get(self, index)

    def __getitem__(self, index: int):
        return self.get(index)

    def to_array(self) -> list:
        return type_list_to_array(self)

    def slice(self, start: int = 0, end: int | None = None) -> list:
        return type_list_slice(self, start, end if end is not None else self.length)

    def to_json(self) -> list:
        return self.map(lambda c, i, t: c.to_json() if isinstance(c, AbstractType) else c)

    def map(self, f) -> list:
        return type_list_map(self, f)

    def for_each(self, f) -> None:
        type_list_for_each(self, f)

    def __iter__(self):
        return type_list_create_iterator(self)

    def _write(self, encoder) -> None:
        encoder.write_type_ref(YARRAY_REF_ID)


def read_yarray(_decoder) -> YArray:
    return YArray()


type_refs[YARRAY_REF_ID] = read_yarray
