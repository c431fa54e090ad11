"""Provider ingest: the harness's clock around each ``receive_update`` of
the window, summed, per unit of the cell's work (an edit, or a join)."""


def read(rec, name):
    if not rec["work"] or not rec["n_received"]:
        return None
    return rec["ingest_s"] / rec["work"] * 1e6
