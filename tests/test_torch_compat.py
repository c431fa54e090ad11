"""The cases of the JAX package's ``tests/test_compat.py`` on the
PyTorch port: the same cases and assertions over ``yjs_tpu_torch``.

Wire-format compatibility fixtures.

The base64 documents in tests/fixtures/compat_v1.json were generated by Yjs
v13.2.0 (taken verbatim from reference tests/compatibility.tests.js:16-46 —
conformance *data*, not code).  They pin the V1 binary format: our decoder
must integrate them to exactly the recorded JSON/delta values.
"""

import base64
import json
import os

import yjs_tpu_torch as Y

FIXTURES = json.load(
    open(os.path.join(os.path.dirname(__file__), "fixtures", "compat_v1.json"))
)


def test_array_compatibility_v1():
    fx = FIXTURES["testArrayCompatibilityV1"]
    doc = Y.Doc()
    Y.apply_update(doc, base64.b64decode(fx["oldDoc"]))
    assert doc.get_array("array").to_json() == fx["oldVal"]


def test_map_decoding_compatibility_v1():
    fx = FIXTURES["testMapDecodingCompatibilityV1"]
    doc = Y.Doc()
    Y.apply_update(doc, base64.b64decode(fx["oldDoc"]))
    assert doc.get_map("map").to_json() == fx["oldVal"]


def test_text_decoding_compatibility_v1():
    fx = FIXTURES["testTextDecodingCompatibilityV1"]
    doc = Y.Doc()
    Y.apply_update(doc, base64.b64decode(fx["oldDoc"]))
    assert doc.get_text("text").to_delta() == fx["oldVal"]


def test_reencode_fixture_roundtrip():
    """After integrating a v13.2 doc, re-encoding V1/V2 and re-applying must
    reproduce the same content."""
    fx = FIXTURES["testArrayCompatibilityV1"]
    doc = Y.Doc()
    Y.apply_update(doc, base64.b64decode(fx["oldDoc"]))
    for encode, apply_ in (
        (Y.encode_state_as_update, Y.apply_update),
        (Y.encode_state_as_update_v2, Y.apply_update_v2),
    ):
        doc2 = Y.Doc()
        apply_(doc2, encode(doc))
        assert doc2.get_array("array").to_json() == fx["oldVal"]
