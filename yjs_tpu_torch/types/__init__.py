"""Shared types (L3): YArray, YMap, YText, YXml*.

Importing this package registers every type's read-constructor in
``yjs_tpu.core.type_refs`` (the wire dispatch table, reference
src/structs/ContentType.js:19-35).
"""

from .abstract import AbstractType  # noqa: F401
from .events import YEvent  # noqa: F401
from .yarray import YArray, YArrayEvent  # noqa: F401
from .ymap import YMap, YMapEvent  # noqa: F401
from .ytext import YText, YTextEvent  # noqa: F401
from .yxml import (  # noqa: F401
    YXmlElement,
    YXmlEvent,
    YXmlFragment,
    YXmlHook,
    YXmlText,
)
