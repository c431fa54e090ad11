"""The plain reference: one Yjs ``Y.Text`` room, integrated by YATA.

Each character is its own item (Yjs merges runs of one client, and a
merged item integrates as its characters would, one after another), held
in a linked list of dicts keyed by packed id (see :mod:`.ycodec`).  An
item without an origin has ``HEAD`` there, one without a right origin
``END``; deleted content's character is ``"\0"``.  The
integration is Yjs's ``Item.integrate`` conflict loop (``Item.js``) line
for line; updates whose dependencies are missing wait, as Yjs's pending
structs do.  It imports nothing of the program under test and takes only
update bytes that the benchmark made or read from a fixture.
"""

from __future__ import annotations

from .ycodec import client_of, clock_of, decode_update, pack_id

HEAD = -1
END = -2


class TextDoc:
    """One room's text: items, their order, the delete set, the clocks."""

    def __init__(self, root: str = "text"):
        self.root = root
        self.nxt: dict[int, int] = {HEAD: END}
        self.origin: dict[int, int] = {}
        self.right: dict[int, int] = {}
        self.chars: dict[int, str] = {}
        self.deleted: set[int] = set()
        self.sv: dict[int, int] = {}
        self._pending: list = []
        self._pending_ds: set[int] = set()

    def copy(self) -> "TextDoc":
        d = TextDoc.__new__(TextDoc)
        d.root = self.root
        d.nxt = dict(self.nxt)
        d.origin = dict(self.origin)
        d.right = dict(self.right)
        d.chars = dict(self.chars)
        d.deleted = set(self.deleted)
        d.sv = dict(self.sv)
        d._pending = list(self._pending)
        d._pending_ds = set(self._pending_ds)
        return d

    # -- integration ---------------------------------------------------------

    def apply_update(self, update: bytes) -> None:
        runs, ds = decode_update(update)
        self._pending.extend(r for r in runs if r.kind != "skip")
        self._drain()
        for c, k, n in ds:
            base = pack_id(c, k)
            self._pending_ds.update(range(base, base + n))
        self._apply_pending_ds()

    def _apply_pending_ds(self) -> None:
        if not self._pending_ds:
            return
        have = self.chars
        hit = {i for i in self._pending_ds if i in have}
        self.deleted |= hit
        self._pending_ds -= hit

    def _blocker(self, run) -> int | None:
        """None when ``run`` can integrate now; else the client whose
        next run it waits for, or -1 where nothing pending can help."""
        sv = self.sv
        if run.clock > sv.get(run.client, 0):
            return -1
        for dep in (run.origin, run.right):
            if dep is not None and dep not in self.chars:
                c = client_of(dep)
                if clock_of(dep) >= sv.get(c, 0):
                    return c
        return None

    def _drain(self) -> None:
        """Integrate the pending runs client by client, switching to the
        client a run waits for (Yjs's ``integrateStructs`` stack) until
        no run can move; what is left waits for a later update."""
        queues: dict[int, list] = {}
        for run in self._pending:
            queues.setdefault(run.client, []).append(run)
        for runs in queues.values():
            runs.sort(key=lambda r: r.clock)
        pos = dict.fromkeys(queues, 0)
        progress = True
        while progress:
            progress = False
            blocked: set[int] = set()
            for c in queues:
                stack = [c]
                while stack:
                    cc = stack[-1]
                    runs = queues[cc]
                    if cc in blocked or pos[cc] >= len(runs):
                        stack.pop()
                        if stack:  # a run below waits on what is not here
                            blocked.update(stack)
                            stack.clear()
                        continue
                    run = runs[pos[cc]]
                    b = self._blocker(run)
                    if b is None:
                        self._integrate_run(run)
                        pos[cc] += 1
                        progress = True
                        if len(stack) > 1:
                            stack.pop()
                    elif b == -1 or b in blocked or b in stack or b not in queues:
                        blocked.update(stack)
                        stack.clear()
                    else:
                        stack.append(b)
        self._pending = [r for c, runs in queues.items() for r in runs[pos[c]:]]

    def _integrate_run(self, run) -> None:
        have = self.sv.get(run.client, 0)
        skip = have - run.clock  # clocks this doc already holds
        if skip >= run.length:
            return
        if run.kind == "gc":
            raise ValueError("GC struct in a text room kept without gc")
        origin = run.origin
        if skip > 0:
            origin = pack_id(run.client, run.clock + skip - 1)
        elif origin is None and run.right is None and run.parent != self.root:
            raise ValueError(f"item outside the root text: {run.parent!r}")
        base = pack_id(run.client, run.clock)
        text = run.text
        origin = HEAD if origin is None else origin
        right = END if run.right is None else run.right
        for j in range(max(skip, 0), run.length):
            i = base + j
            self._integrate(i, origin, right, "\0" if text is None else text[j])
            if text is None:
                self.deleted.add(i)
            origin = i
        self.sv[run.client] = run.clock + run.length

    def _integrate(self, me: int, origin: int, right: int, ch: str) -> None:
        """Yjs ``Item.integrate`` for one character ``me`` between its
        origins (``HEAD`` and ``END`` standing for none)."""
        nxt = self.nxt
        left = origin
        stop = right
        o = nxt[left]
        if o != stop:
            orig = self.origin
            rig = self.right
            mine = me >> 32
            conflicting: set[int] = set()
            before: set[int] = set()
            while o != stop and o != END:
                before.add(o)
                conflicting.add(o)
                oo = orig[o]
                if oo == origin:
                    if (o >> 32) < mine:
                        left = o
                        conflicting.clear()
                    elif rig[o] == right:
                        break
                elif oo in before:
                    if oo not in conflicting:
                        left = o
                        conflicting.clear()
                else:
                    break
                o = nxt[o]
        nxt[me] = nxt[left]
        nxt[left] = me
        self.origin[me] = origin
        self.right[me] = right
        self.chars[me] = ch

    # -- reads ---------------------------------------------------------------

    def ordered(self) -> list[int]:
        """Every item id in document order, deleted ones included."""
        out = []
        nxt = self.nxt
        i = nxt[HEAD]
        while i != END:
            out.append(i)
            i = nxt[i]
        return out

    def text(self) -> str:
        chars = self.chars
        dead = self.deleted
        return "".join(chars[i] for i in self.ordered() if i not in dead)

    def state_vector(self) -> dict[int, int]:
        return dict(self.sv)

    def complete(self) -> bool:
        """No struct or delete waits for a missing dependency."""
        return not self._pending and not self._pending_ds
