"""Transports: how protocol messages reach the servers.

A ``Transport`` carries ``repro_torch.core.protocol`` messages both ways: the
client (``VolunteerSession``) issues a request through ``call`` and gets the
reply; async notifications (``Wake``, ``VersionReady``) flow back through the
``deliver(consumer, msg)`` sink the owning engine installs.

- ``InProcessTransport`` — direct dispatch onto the in-process
  ``ServerEndpoint``; zero copies, zero serialization. The engines' default.

Port of ``repro/core/transport.py``. Its ``WireTransport`` (every message
round-tripped through canonical bytes) and ``FaultyTransport`` (seeded
notification faults) come with a later slice: decoded wire messages carry
numpy leaves, which the port's compute must first accept, and tensors on the
card must be moved to the host before encoding.
"""
from __future__ import annotations

from typing import Any, Callable, Union

from repro_torch.core.protocol import ServerEndpoint

Deliver = Callable[[str, Any], None]


def make_transport(transport: Union[str, Callable, None],
                   endpoint: ServerEndpoint) -> "Transport":
    """Resolve an engine's ``transport=`` argument: "inproc" | a factory
    ``endpoint -> Transport``. A factory — not a pre-built instance — because
    a Transport is bound to ONE endpoint, and it must be the engine's own
    (where the task graph was enqueued), not whatever a caller happened to
    wrap."""
    if transport is None or transport == "inproc":
        return InProcessTransport(endpoint)
    if transport == "wire":
        raise NotImplementedError("the wire transport is not ported yet; "
                                  "use transport='inproc'")
    if callable(transport):
        built = transport(endpoint)
        if not isinstance(built, Transport):
            raise TypeError(f"transport factory returned {type(built).__name__},"
                            f" not a Transport")
        return built
    raise ValueError(f"unknown transport {transport!r}")


class Transport:
    """Message port: synchronous request/reply + async notification sink."""

    def call(self, msg):
        raise NotImplementedError

    def set_deliver(self, deliver: Deliver) -> None:
        """Install the engine's notification sink."""
        raise NotImplementedError


class InProcessTransport(Transport):
    """Direct calls onto the endpoint — the zero-copy fast path."""

    def __init__(self, endpoint: ServerEndpoint):
        self.endpoint = endpoint
        self._deliver: Deliver = lambda c, m: None
        endpoint.set_notify(self._notify)
        self.calls = 0

    def set_deliver(self, deliver: Deliver) -> None:
        self._deliver = deliver

    def call(self, msg):
        self.calls += 1
        return self.endpoint.handle(msg)

    def _notify(self, consumer: str, msg) -> None:
        self._deliver(consumer, msg)
