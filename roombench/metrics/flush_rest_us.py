"""Pack, H2D and emit: the program's ``t_pack_s``, ``t_dispatch_s``,
``t_device_wait_s`` and ``t_emit_s`` summed over the window's flushes,
per unit of the cell's work."""

KEYS = ("t_pack_s", "t_dispatch_s", "t_device_wait_s", "t_emit_s")


def read(rec, name):
    f = rec["flush"]
    if not rec["work"] or not f["n"]:
        return None
    return sum(f[k] for k in KEYS) / rec["work"] * 1e6
