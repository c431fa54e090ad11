"""UTF-16 code-unit string helpers.

The reference implementation is JavaScript, where `string.length`, slicing and
`split('')` all operate on UTF-16 code units.  Item lengths, YText indices and
the V2 string-column lengths are therefore all UTF-16-unit based (see e.g.
reference src/structs/ContentString.js:51-66, which guards against splitting a
surrogate pair when an item is split).

To match those semantics exactly we represent text *internally* as Python
strings in "u16 form": every astral code point is expanded into its surrogate
pair, so ``len()``/slicing on the Python string equal JS semantics.  The
helpers below convert between u16 form and ordinary Python strings.
"""


def to_u16(s: str) -> str:
    """Expand astral code points into surrogate pairs (JS string model)."""
    for ch in s:
        if ord(ch) > 0xFFFF:
            break
    else:
        return s
    out = []
    for ch in s:
        cp = ord(ch)
        if cp > 0xFFFF:
            cp -= 0x10000
            out.append(chr(0xD800 | (cp >> 10)))
            out.append(chr(0xDC00 | (cp & 0x3FF)))
        else:
            out.append(ch)
    return "".join(out)


def from_u16(s: str) -> str:
    """Recombine surrogate pairs into astral code points.

    Lone surrogates are replaced with U+FFFD, mirroring what a JS engine
    produces when such a string is UTF-8 encoded for the wire.
    """
    for ch in s:
        if 0xD800 <= ord(ch) <= 0xDFFF:
            break
    else:
        return s
    out = []
    i = 0
    n = len(s)
    while i < n:
        c = ord(s[i])
        if 0xD800 <= c <= 0xDBFF and i + 1 < n and 0xDC00 <= ord(s[i + 1]) <= 0xDFFF:
            out.append(chr(0x10000 + ((c - 0xD800) << 10) + (ord(s[i + 1]) - 0xDC00)))
            i += 2
        elif 0xD800 <= c <= 0xDFFF:
            out.append("�")
            i += 1
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def u16_encode_utf8(s: str) -> bytes:
    """UTF-8 encode a u16-form string the way a JS engine would."""
    return from_u16(s).encode("utf-8")


def utf8_decode_u16(b: bytes) -> str:
    """Decode UTF-8 bytes into u16 form."""
    return to_u16(b.decode("utf-8"))
