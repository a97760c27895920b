"""Byte-framed host link protocol, a copy of ``rsp_chains_tpu.io.framing`` on
the port's ``native``: the functional analog of the reference's UART
transport (SURVEY §2.6) without the electrical bit timing (explicit non-goal,
SURVEY §7).

The reference serializes 32-bit chain beats through 8-bit UART frames with width
adapters (``RxFftCfarMagTxChain.scala:27-46``) and marks end-of-frame with the
AXI4-Stream ``last`` bit. Here the wire unit is a length-prefixed frame:

    header (16 bytes, little-endian):
        magic   u32  = 0x52535043 ("RSPC")
        seq     u32  frame sequence number
        n_words u32  payload length in 32-bit beat words
        flags   u16  bit 0 = last (end of CPI), bit 1 = config frame
        channel u16  channel index
    payload: n_words x u32 beat words (IQ in, CFAR words out)
    crc     u32  CRC-32 (IEEE) over header+payload — the parity-error analog
                 (DSPBlockUART.scala:159-166)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from . import native

MAGIC = 0x52535043
HEADER = struct.Struct("<IIIHH")
FLAG_LAST = 1
FLAG_CONFIG = 2
# Upper bound on payload words per frame. The length field is unprotected until
# the CRC is checked, so a corrupted length must be rejected *before* it drives
# buffering decisions: without this bound a single bit flip in n_words makes
# decode_frame wait for gigabytes that never arrive, wedging the stream. 1 Mi
# words (4 MiB) is far above any real CPI frame.
MAX_FRAME_WORDS = 1 << 20


class FrameError(ValueError):
    """Bad magic or CRC — the sticky parity-error analog."""


@dataclass
class Frame:
    seq: int
    words: np.ndarray  # uint32 beat words
    last: bool = False
    config: bool = False
    channel: int = 0

    @property
    def iq(self) -> np.ndarray:
        """Payload decoded as complex64 IQ samples."""
        return native.unpack_iq_c64(self.words)


def encode_frame(words: np.ndarray, seq: int, *, last: bool = False,
                 config: bool = False, channel: int = 0) -> bytes:
    words = np.ascontiguousarray(words, np.uint32).reshape(-1)
    flags = (FLAG_LAST if last else 0) | (FLAG_CONFIG if config else 0)
    hdr = HEADER.pack(MAGIC, seq & 0xFFFFFFFF, words.size, flags, channel)
    body = hdr + words.tobytes()
    crc = native.crc32(body)
    return body + struct.pack("<I", crc)


def encode_iq_frame(iq: np.ndarray, seq: int, **kw) -> bytes:
    """Pack complex IQ samples into beat words and frame them."""
    return encode_frame(native.pack_iq_c64(iq), seq, **kw)


def decode_frame(buf: bytes, offset: int = 0) -> tuple[Frame, int]:
    """Decode one frame starting at ``buf[offset]``; returns
    (frame, bytes_consumed). Raises FrameError on bad magic/CRC,
    needs-more-data as IndexError."""
    if len(buf) - offset < HEADER.size + 4:
        raise IndexError("short buffer")
    magic, seq, n_words, flags, channel = HEADER.unpack_from(buf, offset)
    if magic != MAGIC:
        raise FrameError(f"bad magic 0x{magic:08x}")
    if n_words > MAX_FRAME_WORDS:
        # corrupted length with valid magic: treat as a framing error so the
        # one-byte resync path engages instead of buffering unboundedly
        raise FrameError(f"frame length {n_words} words exceeds MAX_FRAME_WORDS")
    total = HEADER.size + 4 * n_words + 4
    if len(buf) - offset < total:
        raise IndexError("short buffer")
    payload = np.frombuffer(buf, np.uint32, n_words, offset + HEADER.size).copy()
    (crc,) = struct.unpack_from("<I", buf, offset + HEADER.size + 4 * n_words)
    body = buf[offset : offset + HEADER.size + 4 * n_words]
    if native.crc32(body) != crc:
        raise FrameError("CRC mismatch")
    return (
        Frame(seq=seq, words=payload, last=bool(flags & FLAG_LAST),
              config=bool(flags & FLAG_CONFIG), channel=channel),
        total,
    )


class FrameDecoder:
    """Incremental decoder for a byte stream (socket/file/pipe feed), the RX
    deserializer analog. Feed arbitrary chunks; yields complete Frames."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, chunk: bytes) -> Iterator[Frame]:
        self._buf.extend(chunk)
        # one bytes copy per feed() (not per frame); decoding walks an offset
        buf = bytes(self._buf)

        scanned = native.scan_frames(buf, MAX_FRAME_WORDS)
        if scanned is not None:
            # native fast path: one linear C++ scan (magic + CRC validated
            # in-pass) — resync over corrupted input costs a scan, not a
            # Python decode attempt per byte. The resume offset tracks the
            # last YIELDED frame so abandoning the iterator keeps the
            # remaining frames buffered (same contract as the Python path).
            metas, consumed, _skipped = scanned
            nxt = 0
            try:
                for off, n_words, seq, flags, channel, start, total in metas:
                    words = np.frombuffer(buf, np.uint32, n_words, off).copy()
                    # advance BEFORE yielding (like the Python path's
                    # pos += consumed) so an abandoned iterator never
                    # re-yields a delivered frame
                    nxt = start + total
                    yield Frame(seq=seq, words=words,
                                last=bool(flags & FLAG_LAST),
                                config=bool(flags & FLAG_CONFIG),
                                channel=channel)
                nxt = consumed
            finally:
                self._buf = bytearray(buf[nxt:])
            return

        pos = 0
        try:
            while True:
                try:
                    frame, consumed = decode_frame(buf, pos)
                except IndexError:
                    return
                except FrameError:
                    pos += 1  # resync: skip one byte (framing-error analog)
                    continue
                pos += consumed
                yield frame
        finally:
            self._buf = bytearray(buf[pos:])
