"""Transports: how protocol messages reach the servers.

A ``Transport`` carries ``repro_torch.core.protocol`` messages both ways:
the client (``VolunteerSession``) issues a request through ``call`` and gets
the reply;
async notifications (``Wake``, ``VersionReady``) flow back through the
``deliver(consumer, msg)`` sink the owning engine installs. Three
implementations, one contract:

- ``InProcessTransport`` — direct dispatch onto the in-process
  ``ServerEndpoint``; zero copies, zero serialization. The engines' default:
  bit-matches the pre-transport direct-call behavior exactly.

- ``WireTransport`` — every request, reply, AND notification round-trips
  through canonical bytes (``encode_message``/``decode_message``), proving
  the whole protocol is serializable and *measuring* real message sizes:
  ``bytes_sent``/``bytes_received`` totals plus a ``take_bytes()`` tap for
  a network cost model (the reference's Simulator reads it).

- ``FaultyTransport`` — wraps another transport and injects chaos at message
  granularity on the notification path: seeded drop / duplicate / delay of
  ``Wake`` and ``VersionReady`` fires (the ROADMAP's "stale reads, lost watch
  fires" rung). Requests pass through untouched — queue state stays sound;
  only *delivery* misbehaves, which is exactly the failure the lease-expiry
  path must absorb. Deterministic: decisions come from ``random.Random(seed)``
  in delivery order, so a fault schedule replays bit-for-bit and applies
  identically to the single-server and sharded runs of a metamorphic pair.

Port of ``repro/core/transport.py``, whole. Over the wire a tensor leaf is
copied to the host and arrives as a numpy array (``checkpoint/serialize.py``);
the port's compute entries move such leaves back onto their device.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

from repro_torch.core.protocol import (ServerEndpoint, VersionReady, Wake,
                                       decode_message, encode_message)

Deliver = Callable[[str, Any], None]


def make_transport(transport: Union[str, Callable, None],
                   endpoint: ServerEndpoint) -> "Transport":
    """Resolve an engine's ``transport=`` argument: "inproc" | "wire" | a
    factory ``endpoint -> Transport`` (e.g. for a custom FaultyTransport
    stack). A factory — not a pre-built instance — because a Transport is
    bound to ONE endpoint, and it must be the engine's own (where the task
    graph was enqueued), not whatever a caller happened to wrap."""
    if transport is None or transport == "inproc":
        return InProcessTransport(endpoint)
    if transport == "wire":
        return WireTransport(endpoint)
    if callable(transport):
        built = transport(endpoint)
        if not isinstance(built, Transport):
            raise TypeError(f"transport factory returned {type(built).__name__},"
                            f" not a Transport")
        return built
    raise ValueError(f"unknown transport {transport!r}")


class Transport:
    """Message port: synchronous request/reply + async notification sink."""

    measures_bytes = False

    def call(self, msg):
        raise NotImplementedError

    def set_deliver(self, deliver: Deliver) -> None:
        """Install the engine's notification sink."""
        raise NotImplementedError

    def take_bytes(self) -> float:
        """Bytes moved since the last take (0 when nothing is measured)."""
        return 0.0


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


class WireTransport(Transport):
    """Round-trip every message through bytes; measure what actually moves."""

    measures_bytes = True

    def __init__(self, endpoint: ServerEndpoint):
        self.endpoint = endpoint
        self._deliver: Deliver = lambda c, m: None
        endpoint.set_notify(self._notify)
        self.calls = 0
        self.bytes_sent = 0          # client -> server (requests)
        self.bytes_received = 0      # server -> client (replies, notifications)
        self._tap = 0.0

    def set_deliver(self, deliver: Deliver) -> None:
        self._deliver = deliver

    def _account(self, n: int, *, sent: bool) -> None:
        if sent:
            self.bytes_sent += n
        else:
            self.bytes_received += n
        self._tap += n

    def take_bytes(self) -> float:
        n, self._tap = self._tap, 0.0
        return n

    def call(self, msg):
        self.calls += 1
        req = encode_message(msg)
        self._account(len(req), sent=True)
        reply = self.endpoint.handle(decode_message(req))
        rep = encode_message(reply)
        self._account(len(rep), sent=False)
        return decode_message(rep)

    def _notify(self, consumer: str, msg) -> None:
        data = encode_message(msg)
        self._account(len(data), sent=False)
        self._deliver(consumer, decode_message(data))


@dataclass(frozen=True)
class FaultSpec:
    """Seeded notification-fault distribution. Probabilities are evaluated
    per delivery, in delivery order; ``max_faults`` caps total injections so a
    schedule can target e.g. exactly one lost watch fire."""
    drop_wake: float = 0.0            # lose a queue-subscription fire
    drop_version_ready: float = 0.0   # lose a DataServer watch fire
    duplicate: float = 0.0            # deliver a notification twice
    delay: float = 0.0                # defer a delivery by ``delay_dt``
    delay_dt: float = 0.5
    max_faults: int = 10 ** 9


class FaultyTransport(Transport):
    """Chaos at message granularity, on the notification path only.

    ``defer(dt, fn)`` is the engine's timer (the Simulator posts to its event
    heap); without one, delay faults degrade to immediate delivery.
    """

    def __init__(self, inner: Transport, spec: FaultSpec, *, seed: int = 0,
                 defer: Optional[Callable[[float, Callable[[], None]], None]]
                 = None):
        self.inner = inner
        self.spec = spec
        self.rng = random.Random(seed)
        self.defer = defer
        self._deliver: Deliver = lambda c, m: None
        inner.set_deliver(self._on_notify)
        self.faults: Dict[str, int] = {"drop": 0, "duplicate": 0, "delay": 0}

    @property
    def measures_bytes(self):  # type: ignore[override]
        return self.inner.measures_bytes

    def set_deliver(self, deliver: Deliver) -> None:
        self._deliver = deliver

    def take_bytes(self) -> float:
        return self.inner.take_bytes()

    def call(self, msg):
        return self.inner.call(msg)

    def _budget(self) -> bool:
        return sum(self.faults.values()) < self.spec.max_faults

    def _on_notify(self, consumer: str, msg) -> None:
        s = self.spec
        p_drop = (s.drop_version_ready if isinstance(msg, VersionReady)
                  else s.drop_wake if isinstance(msg, Wake) else 0.0)
        # three rng draws per delivery, unconditionally, so the consumed
        # sequence — and every later decision — is identical across runs
        r_drop, r_dup, r_delay = (self.rng.random() for _ in range(3))
        if r_drop < p_drop and self._budget():
            self.faults["drop"] += 1
            return
        if r_dup < s.duplicate and self._budget():
            self.faults["duplicate"] += 1
            self._deliver(consumer, msg)
        if r_delay < s.delay and self._budget() \
                and self.defer is not None:
            self.faults["delay"] += 1
            self.defer(s.delay_dt,
                       lambda c=consumer, m=msg: self._deliver(c, m))
            return
        self._deliver(consumer, msg)
