"""Plain reference of the wire's framing, written from the protocol.

The reference protocol (github.com/phanen/pplp ``include/util.h:51-63``,
``bytes_to_send`` / ``bytes_to_receive``) sends every message as a frame:
the payload's length in ASCII decimal, NUL-padded to a 128-byte header,
then the payload. Nothing here comes from the program under test.
"""

from __future__ import annotations

SIZE_BUFFER = 128


def header(length: int) -> bytes:
    """The 128-byte header of a frame of ``length`` payload bytes."""
    digits = str(length).encode("ascii")
    if len(digits) >= SIZE_BUFFER:
        raise ValueError(f"a length of {len(digits)} digits does not fit the header")
    return digits + b"\0" * (SIZE_BUFFER - len(digits))


def frame(payload: bytes) -> bytes:
    """The frame's bytes as they go on the wire: header, then payload."""
    return header(len(payload)) + payload
