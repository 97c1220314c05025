"""Two-party TCP transport with the reference's framing discipline.

Copy of ``pplp_tpu.protocol.transport``, the same bytes on the wire; host
code only. Behavioral equivalent of the C++ reference's
``include/util.h:47-335``:
  * 128-byte ASCII length prefix before every framed payload
    (``bytes_to_send``/``bytes_to_receive``, util.h:51-63)
  * ``connect_to_server`` (active open) / ``connect_to_client``
    (bind+listen+accept, SO_REUSEADDR), IPv4 and IPv6.

Divergence from the reference (documented): the reference sends the parms
message raw and assumes it arrives in a single <=128-byte recv (util.h quirk
list, SURVEY.md §4); here every message is length-framed, which removes that
fragility without changing message count or ordering.

Every blocking wait can be bounded: ``timeout`` (seconds, None waits for
ever) bounds a connect, an accept, and each send and receive on the channel;
a wait that runs out raises ``TimeoutError`` and a peer that closes raises
``ConnectionError``, so a failed session raises instead of hanging. A server
that keeps its ``listen`` socket open ``accept``s the next connection after a
failed one. Frames sent and received are the program spans
``transport.send_frame`` and ``transport.recv_frame`` (``bytes``: the
payload's length).
"""

from __future__ import annotations

import socket

from ..utils.profiling import span

__all__ = ["Channel", "connect_to_server", "connect_to_client", "listen", "accept",
           "SIZE_BUFFER"]

SIZE_BUFFER = 128


class Channel:
    """Framed, byte-counting channel over a connected socket. ``timeout``
    bounds each send and receive (None leaves the socket as it is)."""

    def __init__(self, sock: socket.socket, timeout: float | None = None):
        self.sock = sock
        if timeout is not None:
            sock.settimeout(timeout)
        self.bytes_sent = 0
        self.bytes_received = 0

    # -- framing (util.h:51-63) -----------------------------------------

    def send_frame(self, payload: bytes) -> int:
        header = str(len(payload)).encode().ljust(SIZE_BUFFER, b"\x00")
        with span("transport.send_frame", bytes=len(payload)):
            self.sock.sendall(header)
            self.sock.sendall(payload)
        n = SIZE_BUFFER + len(payload)
        self.bytes_sent += n
        return len(payload)

    # Reject absurd frame claims before allocating (the reference trusts the
    # peer's ASCII header unconditionally — util.h:58-63).
    MAX_FRAME = 1 << 32

    def recv_frame(self) -> bytes:
        return self.recv_frame_with_header()[1]

    def recv_frame_with_header(self) -> tuple[bytes, bytes]:
        """The next frame as it came off the socket: its 128-byte header and
        its payload."""
        with span("transport.recv_frame") as rec:
            header = self._recv_exact(SIZE_BUFFER)
            digits = header.split(b"\x00", 1)[0]
            if not digits.isdigit():
                raise ConnectionError(f"malformed frame header {digits[:16]!r}")
            length = int(digits)
            if length > self.MAX_FRAME:
                raise ConnectionError(f"frame length {length} exceeds cap")
            payload = self._recv_exact(length)
            rec.set(bytes=length)
        self.bytes_received += SIZE_BUFFER + length
        return header, payload

    def _recv_exact(self, length: int) -> bytes:
        chunks = []
        remaining = length
        while remaining:
            chunk = self.sock.recv(remaining)
            if not chunk:
                raise ConnectionError("peer closed mid-frame")
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    def close(self):
        self.sock.close()


def connect_to_server(ip: str, port: int, ipv6: bool = False, timeout=None) -> Channel:
    """Active open to the listening peer (util.h:95-178)."""
    family = socket.AF_INET6 if ipv6 else socket.AF_INET
    sock = socket.socket(family, socket.SOCK_STREAM)
    if timeout is not None:
        sock.settimeout(timeout)
    try:
        sock.connect((ip, port))
    except OSError:
        sock.close()
        raise
    return Channel(sock)


def listen(ip: str, port: int, ipv6: bool = False) -> socket.socket:
    """Bind + listen (util.h:181-335); port 0 binds a free port, which
    ``getsockname()[1]`` then gives."""
    family = socket.AF_INET6 if ipv6 else socket.AF_INET
    listener = socket.socket(family, socket.SOCK_STREAM)
    try:
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((ip, port))
        listener.listen(8)
    except OSError:
        listener.close()
        raise
    return listener


def accept(listener: socket.socket, timeout=None) -> Channel:
    """Accept one peer on ``listener``; ``timeout`` bounds the wait and then
    each send and receive on the channel."""
    listener.settimeout(timeout)
    conn, _addr = listener.accept()
    return Channel(conn, timeout)


def connect_to_client(ip: str, port: int, ipv6: bool = False, timeout=None) -> Channel:
    """Bind + listen + accept one peer (util.h:181-335)."""
    listener = listen(ip, port, ipv6)
    try:
        return accept(listener, timeout)
    finally:
        listener.close()
