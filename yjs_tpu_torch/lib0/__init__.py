"""Host-side binary primitives, wire-compatible with the lib0 JS library.

The reference framework (yjs v13.4.9) builds its entire wire format
on lib0's varint/RLE/string/any encoders (see e.g. reference
src/utils/UpdateEncoder.js:264-304).  This package reimplements those byte
formats from scratch in Python so that updates produced here are bit-identical
to updates produced by the JS implementation.
"""
