"""The comparison that decides ``correct``: the program against the plain
reference, on what the measured window produced.

Each number compared is a count of wrong answers, and every comparison is
exact, so each limit is 0:

- ``rooms_sv_wrong``: rooms whose state vector differs from the one the
  sent updates give (every room);
- ``rooms_ds_wrong``: rooms whose delete set differs (every room);
- ``rooms_text_wrong``: rooms whose text differs from the reference's
  YATA integration of the sent updates (the configuration's sample,
  drawn from the seed, with the hottest rooms in it).  The harness has
  the program serve these texts from the card's tables (the links and
  delete marks that the device step wrote, ranked on the device and read
  back), so they judge the device step and not the host's mirror;
- ``wal_edits_missing``: acknowledged updates not read back, whole and in
  order, from the write-ahead log (every update);
- ``replies_missing``: sync-step-1 messages of the window with no reply;
- ``replies_wrong``: sampled join replies that, applied to the joiner's
  state, do not give the room's items and delete set at that tick.
"""

from __future__ import annotations

from . import walread, ycodec
from .traffic import rng_for
from .ytext import END, HEAD


def _sv_ds_of_updates(base, updates) -> tuple[dict[int, int], set[int]]:
    """The state vector and delete set a room has after its history and
    ``updates``: each client's highest clock plus one, the union of every
    delete set."""
    sv = dict(base.sv)
    ds = set(base.ds)
    for u in updates:
        runs, dels = ycodec.decode_update(u)
        for r in runs:
            end = r.clock + r.length
            if end > sv.get(r.client, 0):
                sv[r.client] = end
        for c, k, n in dels:
            b = ycodec.pack_id(c, k)
            ds.update(range(b, b + n))
    return sv, ds


def _room_updates(tr, end_edit: int) -> tuple[list[list[bytes]], list[int]]:
    """Per room, every update it was sent, in order: the load (its
    history first), then each edit before ``end_edit``; and each room's
    number of load updates."""
    per = [[] for _ in tr.guids]
    for r, u in tr.load:
        per[r].append(u)
    n_load = [len(p) for p in per]
    buf, off, room = tr.edit_buf, tr.edit_off, tr.edit_room
    for i in range(end_edit):
        per[room[i]].append(buf[off[i]:off[i + 1]])
    return per, n_load


def _decode_step1_sv(msg: bytes) -> dict[int, int]:
    r = ycodec.Reader(msg)
    if r.uint() != ycodec.SYNC_STEP1:
        raise ValueError("not a sync step 1")
    body = ycodec.Reader(r.bytes())
    return {body.uint(): body.uint() for _ in range(body.uint())}


def _reply_wrong(reply: bytes, doc, joiner_sv: dict[int, int]) -> str | None:
    """Why ``reply`` does not complete a joiner at ``joiner_sv`` to
    ``doc``'s state, or None.  The joiner holds each client's items below
    its clock; the reply must hold exactly the rest, each with the
    reference's origins and character, and the whole delete set."""
    try:
        runs, dels = ycodec.decode_update(ycodec.decode_step2(reply))
    except (ValueError, IndexError) as e:
        return f"undecodable: {e}"
    got = 0
    origin, right, chars = doc.origin, doc.right, doc.chars
    for r in runs:
        if r.kind != "item":
            return f"{r.kind} struct"
        if r.clock < joiner_sv.get(r.client, 0):
            return "holds items the joiner has"
        o = HEAD if r.origin is None else r.origin
        ro = END if r.right is None else r.right
        base = ycodec.pack_id(r.client, r.clock)
        for j in range(r.length):
            i = base + j
            if i not in chars:
                return "holds an item the room lacks"
            if origin[i] != o or right[i] != ro:
                return "origins differ"
            if r.text is not None and r.text[j] != chars[i]:
                return "content differs"
            o = i
        got += r.length
    want = sum(k - min(k, joiner_sv.get(c, 0)) for c, k in doc.sv.items())
    if got != want:
        return f"{got} items, {want} due"
    ds = set()
    for c, k, n in dels:
        b = ycodec.pack_id(c, k)
        ds.update(range(b, b + n))
    if ds != doc.deleted:
        return "delete set differs"
    return None


def _reference(bases, room_base, root, r, updates):
    """The reference doc of room ``r`` after ``updates`` (its history
    first, which the base already holds)."""
    doc = bases[room_base[r]].textdoc(root)
    for u in updates[1:]:
        doc.apply_update(u)
    return doc


def compare(prov, tr, bases, room_base, cfg, seed, win, wal_dir) -> tuple[dict, list[str]]:
    """The numbers compared, ``{name: [value, limit]}``, and notes on
    what was wrong."""
    root = cfg["root"]
    end_edit = tr.tick_edits[win["end_tick"]]
    per, n_load = _room_updates(tr, end_edit)
    notes: list[str] = []

    def note(msg: str) -> None:
        if len(notes) < 9:
            notes.append(msg)

    sv_wrong = ds_wrong = 0
    for r, guid in enumerate(tr.guids):
        sv, ds = _sv_ds_of_updates(bases[room_base[r]], per[r][1:])
        got_sv = prov.state_vector(guid)
        if got_sv != sv:
            sv_wrong += 1
            note(f"{guid}: state vector {got_sv} != {sv}")
        got = prov.encode_state_as_update(guid, ycodec.encode_state_vector(sv))
        if ycodec.decode_delete_set_of(got) != ds:
            ds_wrong += 1
            note(f"{guid}: delete set differs")
    # text: a sample of the rooms the window's edits touched, the hottest in it
    touched = sorted({tr.edit_room[i] for i in range(end_edit)})
    n_text = min(cfg["check"]["text_rooms"], len(touched))
    pick = rng_for(seed, "check-text").sample(touched, n_text)
    if tr.hottest in touched and tr.hottest not in pick:
        pick[0] = tr.hottest
    text_wrong = 0
    for r in pick:
        doc = _reference(bases, room_base, root, r, per[r])
        if not doc.complete() or prov.text(tr.guids[r]) != doc.text():
            text_wrong += 1
            note(f"{tr.guids[r]}: text differs")
    # every acknowledged update, read back whole and in order from the log
    wal, missing = walread.updates_by_guid(wal_dir)
    for r, guid in enumerate(tr.guids):
        got = wal.get(guid, [])
        if got != per[r]:
            n = sum(1 for a, b in zip(got, per[r]) if a != b) + abs(len(got) - len(per[r]))
            missing += n
            note(f"{guid}: {n} updates not read back from the log")
    # sampled join replies, each against the room at its tick
    replies_wrong = 0
    for j, reply in win["replies"].items():
        r = tr.join_room[j]
        t = win["join_tick"][j]
        upto = tr.tick_edits[t + 1]
        sent = sum(1 for i in range(upto) if tr.edit_room[i] == r)
        doc = _reference(bases, room_base, root, r, per[r][:n_load[r] + sent])
        sv = _decode_step1_sv(tr.join_buf[tr.join_off[j]:tr.join_off[j + 1]])
        why = _reply_wrong(reply, doc, sv)
        if why is not None:
            replies_wrong += 1
            note(f"join {j} to {tr.guids[r]}: {why}")
    notes.insert(0, f"compared: {len(tr.guids)} rooms' state vectors and delete "
                    f"sets, {len(pick)} texts, {len(win['replies'])} join replies")
    checks = {
        "rooms_sv_wrong": [sv_wrong, 0],
        "rooms_ds_wrong": [ds_wrong, 0],
        "rooms_text_wrong": [text_wrong, 0],
        "wal_edits_missing": [missing, 0],
    }
    if tr.tick_joins[-1]:
        checks["replies_missing"] = [win["replies_missing"], 0]
        checks["replies_wrong"] = [replies_wrong, 0]
    return checks, notes
