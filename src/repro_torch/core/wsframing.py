"""RFC 6455 WebSocket framing as a sans-IO layer.

The gateway speaks two dialects on one port: the native length-prefixed
byte framing (docs/protocol.md "Byte framing") and WebSocket, the only
framing a browser can produce.  This module owns everything RFC 6455
says about bytes and nothing about sockets: handshake parsing/response,
frame encode/decode, masking, fragmentation, ping/pong, and the close
handshake are all pure functions over buffers, so every rule is
unit-testable byte-for-byte without a network.

Layering (mirrors protocol.py's sans-IO split):

- ``ServerHandshake`` / client handshake helpers: HTTP upgrade in/out.
- ``Framer``: one side of an established connection.  ``feed(data)``
  returns decoded events (``Message``/``Ping``/``Pong``/``Closed``);
  ``send_message``/``ping``/``pong``/``close`` return wire bytes.
- The gateway maps **one protocol message to one binary WebSocket
  message** — the payload is ``encode_message(msg)`` WITHOUT the u32
  length prefix, because WS frames carry their own lengths.

Hard rules enforced here (violations raise ``WsProtocolError`` with an
RFC close code, and the I/O layer closes the connection):

- client frames MUST be masked; server frames MUST NOT be (RFC 5.1);
- RSV bits zero (no extensions negotiated);
- control frames are unfragmented and carry <= 125 payload bytes;
- a frame or reassembled message larger than ``max_frame`` is refused
  with close code 1009 *before* its payload is buffered — the cap is
  shared with the native dialect's ``MAX_FRAME`` so a hostile length
  field can't drive allocation in either framing.
"""
from __future__ import annotations

import base64
import hashlib
import os
import struct
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

# Shared frame cap for BOTH wire dialects (native u32-prefixed and WS).
# Large enough for any model blob the benchmarks ship (tens of MB),
# small enough that a corrupt/hostile length field cannot drive a
# multi-GB allocation loop.
MAX_FRAME = 32 * 1024 * 1024

# RFC 6455 section 1.3 — fixed GUID appended to the client key.
GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

WS_VERSION = "13"

# Opcodes (RFC 5.2).
OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

_DATA_OPCODES = (OP_TEXT, OP_BINARY)
_CONTROL_OPCODES = (OP_CLOSE, OP_PING, OP_PONG)

# Close codes (RFC 7.4.1).
CLOSE_NORMAL = 1000
CLOSE_GOING_AWAY = 1001
CLOSE_PROTOCOL_ERROR = 1002
CLOSE_TOO_BIG = 1009

_MAX_HANDSHAKE = 8 * 1024  # HTTP upgrade header cap

_U16 = struct.Struct(">H")
_U64 = struct.Struct(">Q")


class WsProtocolError(Exception):
    """Peer violated RFC 6455; carries the close code to send back."""

    def __init__(self, reason: str, code: int = CLOSE_PROTOCOL_ERROR):
        super().__init__(reason)
        self.code = code
        self.reason = reason


# ---------------------------------------------------------------------------
# events produced by Framer.feed
# ---------------------------------------------------------------------------

# sentinel returned by _parse_one when a non-final fragment was consumed
_CONSUMED = object()


@dataclass(frozen=True)
class Message:
    """A complete (possibly reassembled) data message."""
    data: bytes


@dataclass(frozen=True)
class Ping:
    data: bytes


@dataclass(frozen=True)
class Pong:
    data: bytes


@dataclass(frozen=True)
class Closed:
    """Peer sent a Close frame. ``code`` is None when it carried no code."""
    code: Optional[int]
    reason: bytes = b""


# ---------------------------------------------------------------------------
# handshake
# ---------------------------------------------------------------------------

def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client ``Sec-WebSocket-Key``."""
    digest = hashlib.sha1((key + GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def is_ws_preamble(data: bytes) -> bool:
    """Dialect sniff: does this connection open like an HTTP upgrade?

    One byte disambiguates.  A WS connection starts ``GET `` (0x47);
    the native dialect starts with a u32 BE length that is < MAX_FRAME
    (32 MiB = 0x02000000), so its first byte is always <= 0x01 and can
    never be ``G``.
    """
    return data[:1] == b"G"


def _parse_headers(block: bytes) -> Tuple[str, dict]:
    try:
        text = block.decode("latin-1")
    except UnicodeDecodeError as e:  # latin-1 never fails, but be explicit
        raise WsProtocolError(f"undecodable handshake: {e}") from e
    lines = text.split("\r\n")
    request_line = lines[0]
    headers: dict = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise WsProtocolError(f"malformed header line: {line!r}")
        headers[name.strip().lower()] = value.strip()
    return request_line, headers


def handshake_response(key: str) -> bytes:
    return (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(key)}\r\n"
        "\r\n"
    ).encode("ascii")


def bad_handshake_response(reason: str = "bad websocket handshake") -> bytes:
    body = reason.encode("ascii", "replace")
    return (
        "HTTP/1.1 400 Bad Request\r\n"
        "Connection: close\r\n"
        f"Content-Length: {len(body)}\r\n"
        "\r\n"
    ).encode("ascii") + body


class ServerHandshake:
    """Incremental parser for the client's HTTP upgrade request.

    ``feed(data)`` returns the 101 response bytes once the full header
    block has arrived (None while incomplete); raises WsProtocolError on
    a request that is not a well-formed WS upgrade.  Bytes received past
    the header block are preserved in ``leftover`` — they are the first
    frame bytes and must be fed to the Framer.
    """

    def __init__(self) -> None:
        self._buf = b""
        self.leftover = b""
        self.path: Optional[str] = None

    def feed(self, data: bytes) -> Optional[bytes]:
        self._buf += data
        end = self._buf.find(b"\r\n\r\n")
        if end < 0:
            if len(self._buf) > _MAX_HANDSHAKE:
                raise WsProtocolError("handshake header block too large",
                                      CLOSE_TOO_BIG)
            return None
        block, self.leftover = self._buf[:end], self._buf[end + 4:]
        request_line, headers = _parse_headers(block)
        parts = request_line.split(" ")
        if len(parts) != 3 or parts[0] != "GET":
            raise WsProtocolError(f"not a GET request: {request_line!r}")
        self.path = parts[1]
        if "websocket" not in headers.get("upgrade", "").lower():
            raise WsProtocolError("missing Upgrade: websocket header")
        connection = headers.get("connection", "").lower()
        if "upgrade" not in (t.strip() for t in connection.split(",")):
            raise WsProtocolError("missing Connection: Upgrade header")
        key = headers.get("sec-websocket-key")
        if not key:
            raise WsProtocolError("missing Sec-WebSocket-Key header")
        version = headers.get("sec-websocket-version")
        if version != WS_VERSION:
            raise WsProtocolError(
                f"unsupported Sec-WebSocket-Version: {version!r}")
        return handshake_response(key)


def client_handshake_request(host: str, path: str = "/",
                             key: Optional[str] = None) -> Tuple[bytes, str]:
    """Upgrade request bytes + the key to verify the response against."""
    if key is None:
        key = base64.b64encode(os.urandom(16)).decode("ascii")
    request = (
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        f"Sec-WebSocket-Version: {WS_VERSION}\r\n"
        "\r\n"
    ).encode("ascii")
    return request, key


class ClientHandshake:
    """Incremental parser for the server's 101 response.

    ``feed(data)`` returns True once the response is complete and valid;
    raises WsProtocolError otherwise.  ``leftover`` holds any frame
    bytes that arrived glued to the response.
    """

    def __init__(self, key: str) -> None:
        self._key = key
        self._buf = b""
        self.done = False
        self.leftover = b""

    def feed(self, data: bytes) -> bool:
        if self.done:
            self.leftover += data
            return True
        self._buf += data
        end = self._buf.find(b"\r\n\r\n")
        if end < 0:
            if len(self._buf) > _MAX_HANDSHAKE:
                raise WsProtocolError("handshake response too large",
                                      CLOSE_TOO_BIG)
            return False
        block, self.leftover = self._buf[:end], self._buf[end + 4:]
        status_line, headers = _parse_headers(block)
        parts = status_line.split(" ", 2)
        if len(parts) < 2 or parts[1] != "101":
            raise WsProtocolError(f"expected 101, got: {status_line!r}")
        want = accept_key(self._key)
        got = headers.get("sec-websocket-accept")
        if got != want:
            raise WsProtocolError(
                f"Sec-WebSocket-Accept mismatch: {got!r} != {want!r}")
        self.done = True
        return True


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def _mask_bytes(payload: bytes, mask: bytes) -> bytes:
    # XOR with a repeating 4-byte mask (RFC 5.3); int-XOR over the whole
    # buffer is far faster than a per-byte loop.
    if not payload:
        return payload
    reps = -(-len(payload) // 4)
    key = (mask * reps)[:len(payload)]
    return (int.from_bytes(payload, "big")
            ^ int.from_bytes(key, "big")).to_bytes(len(payload), "big")


class Framer:
    """Sans-IO frame codec for one side of an established connection.

    Servers send unmasked and require masked input; clients the inverse.
    Use the ``server_framer()`` / ``client_framer()`` factories.
    """

    def __init__(self, *, masking: bool, require_masked: bool,
                 max_frame: int = MAX_FRAME,
                 mask_source: Callable[[int], bytes] = os.urandom) -> None:
        self.masking = masking
        self.require_masked = require_masked
        self.max_frame = max_frame
        self.mask_source = mask_source
        self._buf = b""
        self._fragments: List[bytes] = []
        self._fragment_total = 0
        self.closed = False

    # -- receive side -------------------------------------------------------

    @property
    def mid_frame(self) -> bool:
        """True when bytes of an unfinished frame or message are pending.

        The I/O layer uses this for stall detection: a peer that goes
        silent mid-frame is dead (or hostile), while silence between
        frames is just an idle connection.
        """
        return bool(self._buf) or bool(self._fragments)

    def feed(self, data: bytes) -> List[object]:
        """Consume received bytes; return completed events in order."""
        if self.closed:
            return []
        self._buf += data
        events: List[object] = []
        while True:
            parsed = self._parse_one()
            if parsed is None:
                return events
            if parsed is _CONSUMED:  # a non-final fragment: no event yet
                continue
            events.append(parsed)
            if isinstance(parsed, Closed):
                self.closed = True
                return events

    def _parse_one(self):
        buf = self._buf
        if len(buf) < 2:
            return None
        b0, b1 = buf[0], buf[1]
        fin = bool(b0 & 0x80)
        if b0 & 0x70:
            raise WsProtocolError("nonzero RSV bits without an extension")
        opcode = b0 & 0x0F
        masked = bool(b1 & 0x80)
        length = b1 & 0x7F
        offset = 2
        if length == 126:
            if len(buf) < offset + 2:
                return None
            length = _U16.unpack_from(buf, offset)[0]
            offset += 2
        elif length == 127:
            if len(buf) < offset + 8:
                return None
            length = _U64.unpack_from(buf, offset)[0]
            offset += 8
        # refuse hostile lengths BEFORE buffering any payload
        if length > self.max_frame:
            raise WsProtocolError(
                f"{length}-byte frame exceeds max_frame={self.max_frame}",
                CLOSE_TOO_BIG)
        if masked != self.require_masked:
            side = "masked" if self.require_masked else "unmasked"
            raise WsProtocolError(f"peer frames must be {side}")
        mask = b""
        if masked:
            if len(buf) < offset + 4:
                return None
            mask = buf[offset:offset + 4]
            offset += 4
        if len(buf) < offset + length:
            return None
        payload = buf[offset:offset + length]
        self._buf = buf[offset + length:]
        if masked:
            payload = _mask_bytes(payload, mask)
        if opcode in _CONTROL_OPCODES:
            if not fin:
                raise WsProtocolError("fragmented control frame")
            if length > 125:
                raise WsProtocolError("control frame payload > 125 bytes")
            if opcode == OP_PING:
                return Ping(payload)
            if opcode == OP_PONG:
                return Pong(payload)
            code: Optional[int] = None
            reason = b""
            if len(payload) >= 2:
                code = _U16.unpack(payload[:2])[0]
                reason = payload[2:]
            elif len(payload) == 1:
                raise WsProtocolError("close frame with 1-byte payload")
            return Closed(code, reason)
        if opcode in _DATA_OPCODES:
            if self._fragments:
                raise WsProtocolError(
                    "new data frame while a fragmented message is pending")
            if fin:
                return Message(payload)
            self._fragments.append(payload)
            self._fragment_total = len(payload)
            return _CONSUMED
        if opcode == OP_CONT:
            if not self._fragments:
                raise WsProtocolError("continuation frame with no message")
            self._fragment_total += len(payload)
            if self._fragment_total > self.max_frame:
                raise WsProtocolError(
                    f"reassembled message exceeds max_frame={self.max_frame}",
                    CLOSE_TOO_BIG)
            self._fragments.append(payload)
            if not fin:
                return _CONSUMED
            data = b"".join(self._fragments)
            self._fragments = []
            self._fragment_total = 0
            return Message(data)
        raise WsProtocolError(f"unknown opcode {opcode:#x}")

    # -- send side ----------------------------------------------------------

    def _frame(self, opcode: int, payload: bytes, fin: bool = True) -> bytes:
        head = bytearray()
        head.append((0x80 if fin else 0x00) | opcode)
        mask_bit = 0x80 if self.masking else 0x00
        n = len(payload)
        if n <= 125:
            head.append(mask_bit | n)
        elif n <= 0xFFFF:
            head.append(mask_bit | 126)
            head += _U16.pack(n)
        else:
            head.append(mask_bit | 127)
            head += _U64.pack(n)
        if self.masking:
            mask = self.mask_source(4)
            head += mask
            payload = _mask_bytes(payload, mask)
        return bytes(head) + payload

    def send_message(self, payload: bytes,
                     fragment_size: Optional[int] = None) -> bytes:
        """Encode one binary message; optionally split into fragments."""
        if len(payload) > self.max_frame:
            raise WsProtocolError(
                f"refusing to send {len(payload)}-byte message "
                f"(max_frame={self.max_frame})", CLOSE_TOO_BIG)
        if fragment_size is None or fragment_size >= len(payload):
            return self._frame(OP_BINARY, payload)
        out = bytearray()
        chunks = [payload[i:i + fragment_size]
                  for i in range(0, len(payload), fragment_size)] or [b""]
        for i, chunk in enumerate(chunks):
            opcode = OP_BINARY if i == 0 else OP_CONT
            out += self._frame(opcode, chunk, fin=(i == len(chunks) - 1))
        return bytes(out)

    def ping(self, payload: bytes = b"") -> bytes:
        return self._frame(OP_PING, payload)

    def pong(self, payload: bytes = b"") -> bytes:
        return self._frame(OP_PONG, payload)

    def close(self, code: int = CLOSE_NORMAL, reason: bytes = b"") -> bytes:
        payload = _U16.pack(code) + reason if code is not None else b""
        return self._frame(OP_CLOSE, payload[:125])


def server_framer(max_frame: int = MAX_FRAME) -> Framer:
    return Framer(masking=False, require_masked=True, max_frame=max_frame)


def client_framer(max_frame: int = MAX_FRAME,
                  mask_source: Callable[[int], bytes] = os.urandom) -> Framer:
    return Framer(masking=True, require_masked=False, max_frame=max_frame,
                  mask_source=mask_source)
