"""Keystroke updates accepted and made readable by a flush inside the
window, over the window's whole time."""


def read(rec, name):
    if not rec["edits"]:
        return None
    return rec["edits"] / rec["window_s"]
