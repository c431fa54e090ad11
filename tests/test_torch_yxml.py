"""The cases of the JAX package's ``tests/test_yxml.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``.

XML types (scenarios modeled on reference tests/y-xml.tests.js)."""

import yjs_tpu_torch as Y
from torch_helpers import compare, init


def test_custom_typings():
    doc = Y.Doc()
    xml = doc.get_xml_fragment("xml")
    p = Y.YXmlElement("p")
    xml.insert(0, [p])
    txt = Y.YXmlText("text")
    p.insert(0, [txt])
    assert xml.to_string() == "<p>text</p>"


def test_attributes_and_siblings():
    doc = Y.Doc()
    xml = doc.get("xml", Y.YXmlElement)
    el = Y.YXmlElement("div")
    xml.insert(0, [el])
    el.set_attribute("class", "x")
    el.set_attribute("about", "y")
    assert el.get_attribute("class") == "x"
    assert el.get_attributes() == {"class": "x", "about": "y"}
    assert el.to_string() == '<div about="y" class="x"></div>'
    el.remove_attribute("about")
    assert el.get_attributes() == {"class": "x"}
    el2 = Y.YXmlElement("span")
    xml.insert(1, [el2])
    assert el.next_sibling is el2
    assert el2.prev_sibling is el
    assert el2.next_sibling is None


def test_tree_walker_query_selector():
    doc = Y.Doc()
    xml = doc.get_xml_fragment("xml")
    div = Y.YXmlElement("div")
    xml.insert(0, [div])
    p1 = Y.YXmlElement("p")
    p2 = Y.YXmlElement("p")
    span = Y.YXmlElement("span")
    div.insert(0, [p1, span, p2])
    ps = xml.query_selector_all("p")
    assert ps == [p1, p2]
    assert xml.query_selector("span") is span
    assert xml.query_selector("nope") is None
    all_elems = list(xml.create_tree_walker(lambda t: isinstance(t, Y.YXmlElement)))
    assert all_elems == [div, p1, span, p2]


def test_xml_text_formatting_to_string():
    doc = Y.Doc()
    xml = doc.get_xml_fragment("xml")
    txt = Y.YXmlText()
    xml.insert(0, [txt])
    txt.insert(0, "bold", {"b": {}})
    # insert without attributes inherits the active formatting
    txt.insert(4, "more")
    assert xml.to_string() == "<b>boldmore</b>"
    # explicit empty attributes escape the formatting range
    txt.insert(8, "plain", {})
    assert xml.to_string() == "<b>boldmore</b>plain"


def test_xml_sync(rng):
    from torch_helpers import compare, init

    result = init(rng, users=3)
    xml0 = result["xml0"]
    p = Y.YXmlElement("p")
    xml0.insert(0, [p])
    p.set_attribute("id", "42")
    result["testConnector"].flush_all_messages()
    assert result["xml1"].to_string() == xml0.to_string()
    compare(result["users"])


def test_xml_hook():
    doc = Y.Doc()
    xml = doc.get_xml_fragment("xml")
    hook = Y.YXmlHook("custom-component")
    xml.insert(0, [hook])
    hook.set("prop", "value")
    # replicate
    doc2 = Y.Doc()
    Y.apply_update(doc2, Y.encode_state_as_update(doc))
    restored = doc2.get_xml_fragment("xml").get(0)
    assert isinstance(restored, Y.YXmlHook)
    assert restored.hook_name == "custom-component"
    assert restored.get("prop") == "value"


def test_xml_fragment_first_child():
    doc = Y.Doc()
    xml = doc.get_xml_fragment("xml")
    assert xml.first_child is None
    a = Y.YXmlElement("a")
    xml.insert(0, [a])
    assert xml.first_child is a


def test_xml_events(rng):
    """attributesChanged / childListChanged, local + remote (reference
    y-xml.tests.js testEvents)."""
    result = init(rng, users=2)
    xml0, xml1 = result["xml0"], result["xml1"]
    box = {}
    xml0.observe(lambda e, _tr=None: box.__setitem__("l", e))
    xml1.observe(lambda e, _tr=None: box.__setitem__("r", e))

    def fresh(side):
        # stale events must not satisfy later steps' assertions
        return box.pop(side)

    xml0.set_attribute("key", "value")
    assert "key" in fresh("l").attributes_changed
    result["testConnector"].flush_all_messages()
    assert "key" in fresh("r").attributes_changed
    xml0.remove_attribute("key")
    assert "key" in fresh("l").attributes_changed
    result["testConnector"].flush_all_messages()
    assert "key" in fresh("r").attributes_changed
    xml0.insert(0, [Y.YXmlText("some text")])
    assert fresh("l").child_list_changed
    result["testConnector"].flush_all_messages()
    assert fresh("r").child_list_changed
    xml0.delete(0, 1)
    assert fresh("l").child_list_changed
    result["testConnector"].flush_all_messages()
    assert fresh("r").child_list_changed
    compare(result["users"])


def test_insert_after():
    """(reference y-xml.tests.js testInsertafter)."""
    import pytest

    ydoc = Y.Doc()
    yxml = ydoc.get_xml_fragment("xml")
    first = Y.YXmlText()
    second = Y.YXmlElement("p")
    third = Y.YXmlElement("p")
    deepsecond1 = Y.YXmlElement("span")
    deepsecond2 = Y.YXmlText()
    second.insert_after(None, [deepsecond1])
    second.insert_after(deepsecond1, [deepsecond2])
    yxml.insert_after(None, [first, second])
    yxml.insert_after(second, [third])
    assert yxml.length == 3
    assert second.get(0) is deepsecond1
    assert second.get(1) is deepsecond2
    assert yxml.to_array() == [first, second, third]
    el = Y.YXmlElement("p")
    with pytest.raises(LookupError):
        el.insert_after(deepsecond1, [Y.YXmlText()])
