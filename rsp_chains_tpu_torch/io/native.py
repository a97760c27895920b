"""ctypes binding for the C++ host data-plane hot path (``io/native/packing.cpp``),
the port of ``rsp_chains_tpu.io.native`` with its own copy of the source.

The shared library is built on first use with the system's ``g++`` into the
package's git-ignored ``_build/`` directory, named by a hash of the source,
the flags and the machine, so a source edit builds anew; the build writes a
temporary file and renames it, so concurrent processes see a whole library
or none. Every entry point has a numpy fallback, the JAX package's, so the
package works without a compiler; ``HAVE_NATIVE`` reports which path is
active. Nothing here touches a device."""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "packing.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
HAVE_NATIVE = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + (platform.machine(),)).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libpacking_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *FLAGS, str(_SRC), "-o", tmp],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _lib, HAVE_NATIVE
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        lib = None
        if path.exists():
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:    # built on another host: build it here
                lib = None
        if lib is None:
            try:
                lib = ctypes.CDLL(str(path)) if _build(path) else None
            except OSError:
                lib = None
        if lib is None:
            _lib = False
            return _lib
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        lib.pack_iq_i16.argtypes = [i16p, u32p, ctypes.c_int64]
        lib.pack_iq_i16.restype = None
        lib.unpack_iq_f32.argtypes = [u32p, f32p, ctypes.c_int64]
        lib.unpack_iq_f32.restype = None
        lib.pack_iq_f32.argtypes = [f32p, u32p, ctypes.c_int64]
        lib.pack_iq_f32.restype = None
        lib.crc32_ieee.argtypes = [u8p, ctypes.c_int64, ctypes.c_uint32]
        lib.crc32_ieee.restype = ctypes.c_uint32
        lib.unpack_cfar_words.argtypes = [u32p, ctypes.c_int64, ctypes.c_int,
                                          u32p, u32p, u8p]
        lib.unpack_cfar_words.restype = None
        lib.scan_frames.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.scan_frames.restype = ctypes.c_int64
        _lib = lib
        HAVE_NATIVE = True
        return _lib


def pack_iq_i16(iq: np.ndarray) -> np.ndarray:
    """Interleaved int16 [re, im, ...] (or complex-viewed int16 pairs) -> uint32
    beat words. Shape [..., n, 2] int16 or flat even-length int16."""
    iq = np.ascontiguousarray(iq, np.int16).reshape(-1)
    n = iq.size // 2
    out = np.empty(n, np.uint32)
    lib = _load()
    if lib:
        lib.pack_iq_i16(iq, out, n)
    else:
        pairs = iq.reshape(n, 2).astype(np.uint16)
        out[:] = (pairs[:, 0].astype(np.uint32) << 16) | pairs[:, 1]
    return out


def unpack_iq_c64(words: np.ndarray) -> np.ndarray:
    """uint32 beat words -> complex64 array (host-side fast path)."""
    words = np.ascontiguousarray(words, np.uint32).reshape(-1)
    out = np.empty(2 * words.size, np.float32)
    lib = _load()
    if lib:
        lib.unpack_iq_f32(words, out, words.size)
    else:
        out[0::2] = (words >> 16).astype(np.uint16).view(np.int16).astype(np.float32)
        out[1::2] = (words & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.float32)
    return out.view(np.complex64)


def pack_iq_c64(iq: np.ndarray) -> np.ndarray:
    """complex64 -> uint32 beat words (round-half-up, saturating int16)."""
    flat = np.ascontiguousarray(iq, np.complex64).reshape(-1)
    out = np.empty(flat.size, np.uint32)
    lib = _load()
    if lib:
        lib.pack_iq_f32(flat.view(np.float32), out, flat.size)
    else:
        r = np.clip(np.floor(flat.real + 0.5), -32768, 32767).astype(np.int16)
        m = np.clip(np.floor(flat.imag + 0.5), -32768, 32767).astype(np.int16)
        out[:] = (r.astype(np.uint16).astype(np.uint32) << 16) | m.astype(np.uint16)
    return out


def crc32(data: np.ndarray | bytes, seed: int = 0) -> int:
    buf = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    lib = _load()
    if lib:
        return int(lib.crc32_ieee(buf, buf.size, seed))
    import zlib

    return zlib.crc32(buf.tobytes(), seed) & 0xFFFFFFFF


def scan_frames(buf: bytes | bytearray, max_words: int, max_frames: int = 256):
    """One linear C++ pass over a byte stream: find complete, CRC-valid RSPC
    frames (``io/framing.py`` wire format). Returns
    ``(metas, consumed, skipped)`` where each meta is
    ``(payload_offset, n_words, seq, flags, channel, frame_start,
    frame_total_bytes)`` — or ``None`` when the native library is unavailable
    (the caller falls back to the Python decoder).
    The win is resync on corrupted input: one scan instead of a Python
    decode attempt (struct unpack + exception) per byte."""
    lib = _load()
    if not lib:
        return None
    b = np.frombuffer(bytes(buf), np.uint8)
    metas = []
    pos = 0
    skipped = 0
    meta = np.empty(7 * max_frames, np.int64)
    consumed_c = ctypes.c_int64()
    skipped_c = ctypes.c_int64()
    while True:
        sub = b[pos:]
        nf = int(lib.scan_frames(np.ascontiguousarray(sub), sub.size,
                                 max_words, meta, max_frames,
                                 ctypes.byref(consumed_c),
                                 ctypes.byref(skipped_c)))
        for i in range(nf):
            off, n_words, seq, flags, channel, total, start = \
                meta[7 * i : 7 * i + 7]
            metas.append((pos + int(off), int(n_words), int(seq),
                          int(flags), int(channel), pos + int(start),
                          int(total)))
        skipped += int(skipped_c.value)
        pos += int(consumed_c.value)
        if nf < max_frames:
            break
    return metas, pos, skipped


def unpack_cfar_words(words: np.ndarray, bin_width: int):
    """CFAR output words -> (threshold, bins, peaks) via the native decoder."""
    words = np.ascontiguousarray(words, np.uint32).reshape(-1)
    n = words.size
    thr = np.empty(n, np.uint32)
    bins = np.empty(n, np.uint32)
    pk = np.empty(n, np.uint8)
    lib = _load()
    if lib:
        lib.unpack_cfar_words(words, n, bin_width, thr, bins, pk)
    else:
        pk[:] = words & 1
        bins[:] = (words >> 1) & ((1 << bin_width) - 1)
        thr[:] = words >> (bin_width + 1)
    return thr, bins, pk
