"""Sync-step-1 messages answered with a step-2 reply inside the window,
over the window's whole time."""


def read(rec, name):
    if not rec["joins"]:
        return None
    return rec["joins"] / rec["window_s"]
