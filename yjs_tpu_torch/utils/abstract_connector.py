"""AbstractConnector: the interchangeable-connector contract
(reference src/utils/AbstractConnector.js:16-26).

All connectors hold the doc they bind and an (optional) awareness
instance and speak through the Observable event surface; like the
reference, this is typing/contract information more than machinery —
``examples/socket_connector.py`` shows a real transport built on it.
"""

from __future__ import annotations

from ..lib0.observable import Observable


class AbstractConnector(Observable):
    """Base class all connectors implement to stay interchangeable.

    Note (mirroring the reference): this interface is experimental and
    inheriting it is optional — it serves as the contract's shape.

    Subclasses get lifecycle hooks — default no-ops, so existing
    connectors keep working unchanged:

    - :meth:`on_connect` — the transport reached the peer (fired on
      every successful (re)connect, not just the first);
    - :meth:`on_disconnect` — the transport was lost or closed;
      ``reason`` is a short human string (``"closed"``, ``"eof"``,
      ``"liveness-timeout"``, ...);
    - :meth:`on_error` — a transport-layer exception the connector
      absorbed (the session/retransmit machinery handles recovery;
      this is the observation point).
    """

    def __init__(self, ydoc, awareness=None):
        super().__init__()
        self.doc = ydoc
        self.awareness = awareness

    def on_connect(self) -> None:
        """Called when the underlying transport comes up."""

    def on_disconnect(self, reason: str = "closed") -> None:
        """Called when the underlying transport goes away."""

    def on_error(self, exc: BaseException) -> None:
        """Called when the connector absorbs a transport error."""
