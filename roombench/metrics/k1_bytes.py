"""The bytes K1 (``apply_lanes``) has to move for the window's work,
counted from what the updates apply and not from K1's launch shape, so a
later K1, or none, reads the same work.  Each input is read once and each
output written once:

- a room the flush touches: its four 4-byte per-room counts, read;
- an inserted row: its own right link (a 4-byte value read, 4 bytes
  written) and the relink of its left neighbour or of the room's head
  (a 4-byte target and a 4-byte value read, 4 bytes written): 20 bytes;
- a delete: its 4-byte row read and its 1-byte mark written.
"""


def k1_bytes(rows: int, deletes: int, rooms: int) -> int:
    return 16 * rooms + 20 * rows + 5 * deletes
