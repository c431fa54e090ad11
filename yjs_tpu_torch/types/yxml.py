"""XML tree types: YXmlFragment, YXmlElement, YXmlText, YXmlHook, plus the
DFS tree walker (reference src/types/YXmlFragment.js, YXmlElement.js,
YXmlText.js, YXmlHook.js, YXmlEvent.js)."""

from __future__ import annotations

from ..core import (
    YXML_ELEMENT_REF_ID,
    YXML_FRAGMENT_REF_ID,
    YXML_HOOK_REF_ID,
    YXML_TEXT_REF_ID,
    transact,
    type_refs,
)
from .abstract import (
    AbstractType,
    call_type_observers,
    type_list_delete,
    type_list_for_each,
    type_list_get,
    type_list_insert_generics,
    type_list_insert_generics_after,
    type_list_map,
    type_list_slice,
    type_list_to_array,
    type_map_delete,
    type_map_get,
    type_map_get_all,
    type_map_set,
)
from .events import YEvent
from .ymap import YMap
from .ytext import YText


class YXmlEvent(YEvent):
    def __init__(self, target, subs, transaction):
        super().__init__(target, transaction)
        self.child_list_changed = False
        self.attributes_changed = set()
        for sub in subs:
            if sub is None:
                self.child_list_changed = True
            else:
                self.attributes_changed.add(sub)


class YXmlTreeWalker:
    """Depth-first walker over an XML subtree
    (reference YXmlFragment.js:55-116)."""

    def __init__(self, root, f=None):
        self._filter = f if f is not None else (lambda type_: True)
        self._root = root
        self._current_node = root._start
        self._first_call = True

    def __iter__(self):
        return self

    def __next__(self):
        n = self._current_node
        if n is None:
            raise StopIteration
        # gc'd children carry ContentDeleted with no .type; the reference's
        # short-circuit on n.deleted tolerates the undefined read
        type_ = getattr(n.content, "type", None)
        if not self._first_call or n.deleted or not self._filter(type_):
            while True:
                type_ = getattr(n.content, "type", None)
                if (
                    not n.deleted
                    and (type(type_) is YXmlElement or type(type_) is YXmlFragment)
                    and type_._start is not None
                ):
                    # walk down
                    n = type_._start
                else:
                    # walk right or up
                    while n is not None:
                        if n.right is not None:
                            n = n.right
                            break
                        elif n.parent is self._root:
                            n = None
                        else:
                            n = n.parent._item
                if n is None or (not n.deleted and self._filter(n.content.type)):
                    break
        self._first_call = False
        if n is None:
            raise StopIteration
        self._current_node = n
        return n.content.type

    # JS-style iteration protocol used by querySelector
    def next(self):
        try:
            return {"value": self.__next__(), "done": False}
        except StopIteration:
            return {"value": None, "done": True}


class YXmlFragment(AbstractType):
    def __init__(self):
        super().__init__()
        self._prelim_content: list | None = []

    @property
    def first_child(self):
        first = self._first
        return first.content.get_content()[0] if first else None

    def _integrate(self, y, item) -> None:
        super()._integrate(y, item)
        self.insert(0, self._prelim_content)
        self._prelim_content = None

    def _copy(self) -> "YXmlFragment":
        return YXmlFragment()

    def clone(self) -> "YXmlFragment":
        el = YXmlFragment()
        el.insert(
            0, [item.clone() if isinstance(item, AbstractType) else item for item in self.to_array()]
        )
        return el

    @property
    def length(self) -> int:
        return self._length if self._prelim_content is None else len(self._prelim_content)

    def __len__(self) -> int:
        return self.length

    def create_tree_walker(self, filter_) -> YXmlTreeWalker:
        return YXmlTreeWalker(self, filter_)

    def query_selector(self, query: str):
        query = query.upper()
        walker = YXmlTreeWalker(
            self,
            lambda element: getattr(element, "node_name", None) is not None
            and element.node_name.upper() == query,
        )
        nxt = walker.next()
        return None if nxt["done"] else nxt["value"]

    def query_selector_all(self, query: str) -> list:
        query = query.upper()
        return list(
            YXmlTreeWalker(
                self,
                lambda element: getattr(element, "node_name", None) is not None
                and element.node_name.upper() == query,
            )
        )

    def _call_observer(self, transaction, parent_subs) -> None:
        call_type_observers(self, transaction, YXmlEvent(self, parent_subs, transaction))

    def to_string(self) -> str:
        return "".join(type_list_map(self, lambda xml, i, t: xml.to_string()))

    def __str__(self) -> str:
        return self.to_string()

    def to_json(self) -> str:
        return self.to_string()

    def insert(self, index: int, content: list) -> None:
        if self.doc is not None:
            transact(self.doc, lambda txn: type_list_insert_generics(txn, self, index, content))
        else:
            self._prelim_content[index:index] = content

    def insert_after(self, ref, content: list) -> None:
        if self.doc is not None:
            def _ins(transaction):
                ref_item = ref._item if isinstance(ref, AbstractType) else ref
                type_list_insert_generics_after(transaction, self, ref_item, content)

            transact(self.doc, _ins)
        else:
            pc = self._prelim_content
            if ref is None:
                index = 0
            else:
                try:
                    index = pc.index(ref) + 1
                except ValueError:
                    raise LookupError("Reference item not found")
            pc[index:index] = content

    def delete(self, index: int, length: int = 1) -> None:
        if self.doc is not None:
            transact(self.doc, lambda txn: type_list_delete(txn, self, index, length))
        else:
            del self._prelim_content[index:index + length]

    def to_array(self) -> list:
        return type_list_to_array(self)

    def push(self, content: list) -> None:
        self.insert(self.length, content)

    def unshift(self, content: list) -> None:
        self.insert(0, content)

    def get(self, index: int):
        return type_list_get(self, index)

    def slice(self, start: int = 0, end: int | None = None) -> list:
        return type_list_slice(self, start, end if end is not None else self.length)

    def for_each(self, f) -> None:
        type_list_for_each(self, f)

    def _write(self, encoder) -> None:
        encoder.write_type_ref(YXML_FRAGMENT_REF_ID)


class YXmlElement(YXmlFragment):
    def __init__(self, node_name: str = "UNDEFINED"):
        super().__init__()
        self.node_name = node_name
        self._prelim_attrs: dict | None = {}

    @property
    def next_sibling(self):
        n = self._item.next if self._item else None
        return n.content.type if n else None

    @property
    def prev_sibling(self):
        n = self._item.prev if self._item else None
        return n.content.type if n else None

    def _integrate(self, y, item) -> None:
        super()._integrate(y, item)
        for key, value in self._prelim_attrs.items():
            self.set_attribute(key, value)
        self._prelim_attrs = None

    def _copy(self) -> "YXmlElement":
        return YXmlElement(self.node_name)

    def clone(self) -> "YXmlElement":
        el = YXmlElement(self.node_name)
        attrs = self.get_attributes()
        for key, value in attrs.items():
            el.set_attribute(key, value)
        el.insert(
            0, [item.clone() if isinstance(item, AbstractType) else item for item in self.to_array()]
        )
        return el

    def to_string(self) -> str:
        """Sorted-attribute XML serialization (reference YXmlElement.js:97-113)."""
        attrs = self.get_attributes()
        attrs_string = " ".join(f'{key}="{attrs[key]}"' for key in sorted(attrs.keys()))
        node_name = self.node_name.lower()
        inner = "".join(type_list_map(self, lambda xml, i, t: xml.to_string()))
        sep = " " + attrs_string if attrs_string else ""
        return f"<{node_name}{sep}>{inner}</{node_name}>"

    def remove_attribute(self, attribute_name: str) -> None:
        if self.doc is not None:
            transact(self.doc, lambda txn: type_map_delete(txn, self, attribute_name))
        else:
            self._prelim_attrs.pop(attribute_name, None)

    def set_attribute(self, attribute_name: str, attribute_value) -> None:
        if self.doc is not None:
            transact(self.doc, lambda txn: type_map_set(txn, self, attribute_name, attribute_value))
        else:
            self._prelim_attrs[attribute_name] = attribute_value

    def get_attribute(self, attribute_name: str):
        return type_map_get(self, attribute_name)

    def get_attributes(self, snapshot=None) -> dict:
        return type_map_get_all(self)

    def _write(self, encoder) -> None:
        encoder.write_type_ref(YXML_ELEMENT_REF_ID)
        encoder.write_key(self.node_name)


class YXmlText(YText):
    @property
    def next_sibling(self):
        n = self._item.next if self._item else None
        return n.content.type if n else None

    @property
    def prev_sibling(self):
        n = self._item.prev if self._item else None
        return n.content.type if n else None

    def _copy(self) -> "YXmlText":
        return YXmlText()

    def clone(self) -> "YXmlText":
        text = YXmlText()
        text.apply_delta(self.to_delta())
        return text

    def to_string(self) -> str:
        """Render delta attributes as nested sorted tags
        (reference YXmlText.js:65-97)."""
        out = []
        for delta in self.to_delta():
            nested_nodes = []
            for node_name in delta.get("attributes", {}):
                attrs = [
                    {"key": key, "value": delta["attributes"][node_name][key]}
                    for key in delta["attributes"][node_name]
                ]
                attrs.sort(key=lambda a: a["key"])
                nested_nodes.append({"nodeName": node_name, "attrs": attrs})
            nested_nodes.sort(key=lambda n: n["nodeName"])
            s = ""
            for node in nested_nodes:
                s += f"<{node['nodeName']}"
                for attr in node["attrs"]:
                    s += f" {attr['key']}=\"{attr['value']}\""
                s += ">"
            s += str(delta["insert"])
            for node in reversed(nested_nodes):
                s += f"</{node['nodeName']}>"
            out.append(s)
        return "".join(out)

    def __str__(self) -> str:
        return self.to_string()

    def to_json(self) -> str:
        return self.to_string()

    def _write(self, encoder) -> None:
        encoder.write_type_ref(YXML_TEXT_REF_ID)


class YXmlHook(YMap):
    def __init__(self, hook_name: str = "UNDEFINED"):
        super().__init__()
        self.hook_name = hook_name

    def _copy(self) -> "YXmlHook":
        return YXmlHook(self.hook_name)

    def clone(self) -> "YXmlHook":
        el = YXmlHook(self.hook_name)

        def _cp(value, key, _t):
            el.set(key, value)

        self.for_each(_cp)
        return el

    def _write(self, encoder) -> None:
        encoder.write_type_ref(YXML_HOOK_REF_ID)
        encoder.write_key(self.hook_name)


def read_yxml_fragment(_decoder) -> YXmlFragment:
    return YXmlFragment()


def read_yxml_element(decoder) -> YXmlElement:
    return YXmlElement(decoder.read_key())


def read_yxml_text(_decoder) -> YXmlText:
    return YXmlText()


def read_yxml_hook(decoder) -> YXmlHook:
    return YXmlHook(decoder.read_key())


type_refs[YXML_FRAGMENT_REF_ID] = read_yxml_fragment
type_refs[YXML_ELEMENT_REF_ID] = read_yxml_element
type_refs[YXML_TEXT_REF_ID] = read_yxml_text
type_refs[YXML_HOOK_REF_ID] = read_yxml_hook
