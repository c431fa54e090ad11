"""K1's share of its roofline: the least time its bytes
(:mod:`.k1_bytes`) take at the card's memory bandwidth (``peaks.json``),
over K1's device time in the traced window.  Nothing to read without a
trace, a known card or a K1 event."""

from .k1_bytes import k1_bytes
from .. import peaks


def read(rec, name):
    tr = rec.get("trace")
    if not tr:
        return None
    t = sum(s for k, s in tr["kernels"].items() if "apply_lanes" in k)
    bw = peaks.hbm_bytes_per_s(rec["device_kind"])
    if not t or not bw:
        return None
    k = rec["k1"]
    return k1_bytes(k["rows"], k["deletes"], k["rooms"]) / bw / t * 100.0
