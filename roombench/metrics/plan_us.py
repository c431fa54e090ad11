"""Host plan: the program's ``t_plan_s`` summed over the window's
flushes, per unit of the cell's work."""


def read(rec, name):
    f = rec["flush"]
    if not rec["work"] or not f["n"]:
        return None
    return f["t_plan_s"] / rec["work"] * 1e6
