"""Minimal Observable base class (mirrors lib0/observable semantics used by
the reference Doc, reference src/utils/Doc.js:36)."""

from __future__ import annotations


class Observable:
    def __init__(self):
        self._observers: dict[str, set] = {}

    def on(self, name: str, f) -> None:
        self._observers.setdefault(name, set()).add(f)

    def once(self, name: str, f) -> None:
        def _f(*args):
            self.off(name, _f)
            f(*args)

        self.on(name, _f)

    def off(self, name: str, f) -> None:
        observers = self._observers.get(name)
        if observers is not None:
            observers.discard(f)
            if not observers:
                del self._observers[name]

    def emit(self, name: str, args) -> None:
        # copy so that observers may unregister themselves mid-emit
        for f in list(self._observers.get(name, ())):
            f(*args)

    def destroy(self) -> None:
        self._observers = {}
