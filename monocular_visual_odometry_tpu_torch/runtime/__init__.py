"""Host runtime: PNG decode and encode, and the ordered prefetching frame
loader.

Counterpart of ``monocular_visual_odometry_tpu.runtime`` (a libpng decoder
and a C++ worker pool there). The port needs neither libpng nor Pillow:
:func:`decode_png` parses the chunks here, inflates the image data with the
standard library's ``zlib`` and hands the filtered rows to
``csrc/png_gray.cpp`` (built with the host C++ compiler at first use,
ctypes), which undoes the row filters and converts to gray as the libpng
route does. There is one route: a build or decode failure raises with the
compiler's or the decoder's message. Return codes keep the JAX loader's
meaning (-1 unreadable file, -3 corrupt data, -4 wrong size); -5 is an
interlaced image, which is not read.

:class:`FrameLoader` decodes ``depth`` frames ahead on ``n_threads``
threads; they overlap, since ``zlib`` and the ctypes call release the GIL.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from monocular_visual_odometry_tpu_torch.ops.cuda import build

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_lib = None
_lib_lock = threading.Lock()


class PNGError(IOError):
    """A PNG that cannot be decoded; ``rc`` is the decoder's return code."""

    def __init__(self, path, rc: int, msg: str):
        super().__init__(f"{path}: {msg} (rc {rc})")
        self.rc = rc


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build.build_host("png_gray")[0]))
            P = ctypes.c_void_p
            lib.mvo_png_to_gray.argtypes = [P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                                            ctypes.c_int, P, ctypes.c_char_p, ctypes.c_int]
            lib.mvo_png_to_gray.restype = ctypes.c_int
            _lib = lib
    return _lib


def _chunks(path) -> tuple[tuple, bytes, bytes]:
    """(IHDR fields, PLTE, the concatenated IDAT stream) of a PNG file. The
    CRC of every critical chunk is checked; ancillary chunks are skipped."""
    try:
        data = Path(path).read_bytes()
    except OSError as e:
        raise PNGError(path, -1, f"cannot read: {e.strerror}") from e
    if data[:8] != _SIGNATURE:
        raise PNGError(path, -3, "not a PNG file")
    pos, ihdr, plte, idat = 8, None, b"", []
    while True:
        if pos + 12 > len(data):
            raise PNGError(path, -3, "truncated file")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if pos + 12 + n > len(data):
            raise PNGError(path, -3, f"truncated {kind.decode('latin-1')} chunk")
        critical = not kind[0] & 0x20
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if critical and zlib.crc32(kind + body) != crc:
            raise PNGError(path, -3, f"CRC error in the {kind.decode('latin-1')} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            if n != 13:
                raise PNGError(path, -3, "bad IHDR chunk")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif critical:
            raise PNGError(path, -3, f"unknown critical chunk {kind.decode('latin-1')}")
        if ihdr is None:
            raise PNGError(path, -3, "IHDR is not the first chunk")
    if ihdr is None or not idat:
        raise PNGError(path, -3, "no image data")
    return ihdr, plte, b"".join(idat)


def png_size(path) -> tuple[int, int]:
    """(height, width) from a PNG's header."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise PNGError(path, -3, "not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def _decode_into(path, out: np.ndarray) -> None:
    """Decode the PNG at ``path`` into ``out`` (float32 [H,W], C order)."""
    height, width = out.shape
    (w, h, depth, color, compression, filter_method, interlace), plte, stream = _chunks(path)
    if (h, w) != (height, width):
        raise PNGError(path, -4, f"image is {w}x{h}, expected {width}x{height}")
    if compression != 0 or filter_method != 0:
        raise PNGError(path, -3, "unknown compression or filter method")
    if interlace:
        raise PNGError(path, -5, "interlaced (Adam7) PNGs are not read")
    try:
        rows = bytearray(zlib.decompress(stream))
    except zlib.error as e:
        raise PNGError(path, -3, f"zlib: {e}") from e
    err = ctypes.create_string_buffer(256)
    buf = (ctypes.c_uint8 * len(rows)).from_buffer(rows)
    rc = _library().mvo_png_to_gray(buf, len(rows), w, h, depth, color, plte, len(plte) // 3,
                                    out.ctypes.data, err, len(err))
    if rc != 0:
        raise PNGError(path, rc, err.value.decode())


def decode_png(path: str, height: int, width: int) -> np.ndarray:
    """Decode one PNG of size ``height`` x ``width`` to float32 grayscale
    [H, W] (0..255). Raises :class:`PNGError` (an ``IOError``) otherwise."""
    out = np.empty((height, width), dtype=np.float32)
    _decode_into(path, out)
    return out


def write_png(path, img: np.ndarray) -> None:
    """Write a uint8 [H,W] (gray) or [H,W,3] (RGB) image as a PNG: filter-0
    rows deflated with ``zlib``."""
    a = np.ascontiguousarray(img)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError(f"write_png: need uint8 [H,W] or [H,W,3], got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = np.zeros((h, 1 + a[0].size), dtype=np.uint8)  # filter type 0 per row
    rows[:, 1:] = a.reshape(h, -1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if a.ndim == 2 else 2, 0, 0, 0)
    data = (_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(str(path))), exist_ok=True)
    Path(path).write_bytes(data)


class FrameLoader:
    """Ordered prefetching loader over a frame path list: ``n_threads``
    workers decode frames in order, at most ``depth`` ahead of the one the
    caller takes next. Iterating yields float32 [H,W] frames; a frame that
    cannot be decoded raises its :class:`PNGError` (an ``IOError``) in
    turn. ``close()`` (or leaving the ``with`` block) stops the workers,
    mid-sequence too."""

    def __init__(self, paths: Sequence[str], height: int, width: int,
                 depth: int = 4, n_threads: int = 2):
        self.paths = list(paths)
        self.height = height
        self.width = width
        self.depth = max(depth, 1)
        _library()  # a build failure raises here, not in a worker
        self._cv = threading.Condition()
        self._next = 0      # next index a worker takes
        self._emit = 0      # next index the caller takes
        self._ready = {}    # index -> (frame, exception or None)
        self._closing = False
        self._workers = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(max(n_threads, 1))]
        for t in self._workers:
            t.start()

    def _work(self) -> None:
        while True:
            with self._cv:
                if self._closing or self._next >= len(self.paths):
                    return
                idx = self._next
                self._next += 1
            frame = np.empty((self.height, self.width), dtype=np.float32)
            try:
                _decode_into(self.paths[idx], frame)
                error = None
            except Exception as e:  # handed to the caller, raised in turn
                error = e
            with self._cv:
                self._cv.wait_for(lambda: self._closing or idx < self._emit + self.depth)
                if self._closing:
                    return
                self._ready[idx] = (frame, error)
                self._cv.notify_all()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            with self._cv:
                idx = self._emit
                if idx >= len(self.paths):
                    return
                self._cv.wait_for(lambda: self._closing or idx in self._ready)
                if self._closing:
                    return
                frame, error = self._ready.pop(idx)
                self._emit += 1
                self._cv.notify_all()
            if error is not None:
                raise error
            yield frame

    def close(self) -> None:
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        for t in self._workers:
            t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
