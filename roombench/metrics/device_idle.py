"""The share of the traced window in which no operation ran on the device
(``torch.profiler``'s kernel, copy and set events, their union)."""


def read(rec, name):
    tr = rec.get("trace")
    if not tr or not tr["window_s"]:
        return None
    return (1.0 - tr["busy_s"] / tr["window_s"]) * 100.0
