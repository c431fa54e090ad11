"""Sync reply: the harness's clock around each join batch, less the
program's ``ytpu.provider.flush`` span inside it, per join.  Nothing to
read where a batch's flush span was not found."""


def read(rec, name):
    b = rec["batches"]
    if not rec["joins"] or not b["n"] or b["flush_spans"] != b["n"]:
        return None
    return (b["wall_s"] - b["flush_s"]) / rec["joins"] * 1e6
