"""Port parity for the host runtime: the PNG decoder, the PNG writer and the
prefetching frame loader, the PyTorch package against the JAX package.

The port decodes with stdlib ``zlib`` and its own C++ row unfilter
(``csrc/png_gray.cpp``), the JAX package with libpng. Every image here
decodes bit-equal to the JAX package's libpng route: PIL-written 8-bit gray
PNGs (PIL picks the row filters adaptively), PNGs written here with every
one of the five row filters in turn at every bit depth and color type, and
the port's own PNGs. An interlaced PNG, which the libpng route reads
without de-interlacing, is rejected.
"""

import ctypes
import struct
import sys
import threading
import zlib

import numpy as np
import pytest
from PIL import Image

from monocular_visual_odometry_tpu import runtime as jrt
from monocular_visual_odometry_tpu.data import synthetic as jsyn
from monocular_visual_odometry_tpu_torch import runtime as trt
from monocular_visual_odometry_tpu_torch.data import synthetic as tsyn
from monocular_visual_odometry_tpu_torch.utils import io as tio

H, W = 120, 160


def _libpng(path, h, w):
    """The JAX package's libpng decode (its native route, not its PIL
    fallback)."""
    if not jrt.native_available():
        pytest.skip("the JAX package's native runtime did not build")
    out = np.empty((h, w), dtype=np.float32)
    rc = jrt._load_native().mvo_decode_png(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w)
    assert rc == 0, rc
    return out


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack(values, depth):
    """[H, n] samples -> [H, rowbytes] bytes of ``depth`` bits, MSB first."""
    if depth == 16:
        return values.astype(">u2").view(np.uint8).reshape(values.shape[0], -1)
    if depth == 8:
        return values.astype(np.uint8)
    per = 8 // depth
    h, n = values.shape
    v = np.zeros((h, -(-n // per) * per), dtype=np.int64)
    v[:, :n] = values
    v = v.reshape(h, -1, per)
    shifts = 8 - depth * (np.arange(per) + 1)
    return (v << shifts).sum(-1).astype(np.uint8)


def _filtered(raw, bpp, filters):
    """Scanlines with filter ``filters[y % len]`` on row y (forward filters
    use the unfiltered bytes, so they vectorize along the row)."""
    out, prev = [], np.zeros(raw.shape[1], np.int64)
    z = np.zeros(bpp, np.int64)
    for y, row in enumerate(raw.astype(np.int64)):
        f = filters[y % len(filters)]
        left = np.concatenate([z, row[:-bpp]])[:row.size]
        upleft = np.concatenate([z, prev[:-bpp]])[:row.size]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _write(path, values, depth, color, plte=b"", interlace=0, filters=(0, 1, 2, 3, 4),
           crc_ok=True):
    h, n = values.shape
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    w = n // ch
    raw = _pack(values, depth)
    data = _filtered(raw, max(1, ch * depth // 8), filters)
    idat = _chunk(b"IDAT", zlib.compress(data))
    if not crc_ok:
        idat = idat[:-1] + bytes([idat[-1] ^ 1])
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
                     + (_chunk(b"PLTE", plte) if plte else b"") + idat + _chunk(b"IEND", b""))
    return path


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rtseq")
    tsyn.render_sequence(str(d), n_frames=6, height=H, width=W)
    return tio.image_paths(str(d), 6)


def test_decode_pil_gray_equals_libpng(tmp_path):
    rng = np.random.default_rng(0)
    frame = jsyn.render_frame(jsyn.make_trajectory(2)[1], jsyn.default_scene(0),
                              np.array([[615.0, 0, 80], [0, 615, 60], [0, 0, 1]]), H, W)
    images = {"noise": rng.integers(0, 256, (H, W)).astype(np.uint8),
              "ramp": np.add.outer(np.arange(H), 2 * np.arange(W)).astype(np.uint8),
              "frame": frame,
              "flat": np.full((H, W), 77, np.uint8)}
    for name, img in images.items():
        p = tmp_path / f"{name}.png"
        Image.fromarray(img).save(p)
        got = trt.decode_png(str(p), H, W)
        np.testing.assert_array_equal(got, _libpng(p, H, W), err_msg=name)
        np.testing.assert_array_equal(got, img.astype(np.float32), err_msg=name)
        np.testing.assert_array_equal(got, jrt.decode_png(str(p), H, W), err_msg=name)


# (color type, bit depth) of every combination PNG allows
FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
           (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("color,depth", FORMATS, ids=lambda v: str(v))
def test_every_filter_and_format_equals_libpng(tmp_path, color, depth):
    """Width 37 (rows end mid-byte at 1, 2 and 4 bits); rows cycle through
    the five filters (0, 1, 2, 3, 4) and then in another order."""
    rng = np.random.default_rng(color * 100 + depth)
    h, w = 23, 37
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    top = (1 << depth) - 1
    values = rng.integers(0, top + 1, (h, w * ch))
    values[: h // 2, ::ch] = (np.arange(w) * top // max(w - 1, 1))[None]  # smooth rows
    if color in (2, 6):
        values[::3, 1::ch] = values[::3, ::ch]  # some gray pixels: r == g == b
        values[::3, 2::ch] = values[::3, ::ch]
    plte = b""
    if color == 3:
        plte = rng.integers(0, 256, 3 * (top + 1)).astype(np.uint8).tobytes()
    for k, filters in enumerate([(0, 1, 2, 3, 4), (4, 3, 2, 1, 0)]):
        p = _write(tmp_path / f"i{k}.png", values, depth, color, plte, filters=filters)
        np.testing.assert_array_equal(trt.decode_png(str(p), h, w), _libpng(p, h, w))


def test_own_png_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    gray = rng.integers(0, 256, (H, W)).astype(np.uint8)
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    trt.write_png(tmp_path / "sub" / "g.png", gray)
    trt.write_png(tmp_path / "c.png", rgb)
    assert trt.png_size(tmp_path / "sub" / "g.png") == (H, W)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "sub" / "g.png")), gray)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "c.png")), rgb)
    got = trt.decode_png(str(tmp_path / "sub" / "g.png"), H, W)
    np.testing.assert_array_equal(got, gray.astype(np.float32))
    np.testing.assert_array_equal(got, _libpng(tmp_path / "sub" / "g.png", H, W))
    np.testing.assert_array_equal(trt.decode_png(str(tmp_path / "c.png"), H, W),
                                  _libpng(tmp_path / "c.png", H, W))
    for bad in (gray.astype(np.float32), rgb[..., :2], gray[None]):
        with pytest.raises(ValueError, match="write_png"):
            trt.write_png(tmp_path / "x.png", bad)


@pytest.mark.parametrize("case,rc", [("interlaced", -5), ("wrong_size", -4), ("missing", -1),
                                     ("not_png", -3), ("bad_crc", -3), ("bad_filter", -3),
                                     ("truncated", -3)])
def test_decode_errors(tmp_path, case, rc):
    values = np.random.default_rng(2).integers(0, 256, (8, 10))
    p = tmp_path / "e.png"
    h, w = 8, 10
    if case == "interlaced":
        _write(p, values, 8, 0, interlace=1)
    elif case == "wrong_size":
        _write(p, values, 8, 0)
        h, w = 10, 8
    elif case == "not_png":
        p.write_bytes(b"GIF89a" + bytes(40))
    elif case == "bad_crc":
        _write(p, values, 8, 0, crc_ok=False)
    elif case == "bad_filter":
        _write(p, values, 8, 0, filters=(0, 5))
    elif case == "truncated":
        p.write_bytes(_write(p, values, 8, 0).read_bytes()[:60])
    with pytest.raises(IOError, match=rf"\(rc {rc}\)") as e:
        trt.decode_png(str(p), h, w)
    assert e.value.rc == rc


def test_loader_ordered_and_complete(seq):
    with trt.FrameLoader(seq, H, W, depth=2, n_threads=3) as fl:
        frames = list(fl)
    assert len(frames) == 6
    for path, f in zip(seq, frames):
        np.testing.assert_array_equal(f, _libpng(path, H, W))


def test_loader_early_close(seq):
    fl = trt.FrameLoader(seq, H, W, depth=2)
    it = iter(fl)
    next(it)
    fl.close()  # must not hang with frames still being decoded
    assert not any(t.is_alive() for t in fl._workers)
    assert list(it) == []


def test_loader_stops_on_an_unreadable_frame(seq, tmp_path):
    """Frames before the bad one come out; the bad one raises IOError (its
    rc), as the CLI expects to stop there; a wrong-size frame is an error."""
    bad = tmp_path / "small.png"
    trt.write_png(bad, np.zeros((H // 2, W), np.uint8))
    paths = seq[:2] + [str(bad)] + seq[2:]
    got = []
    with trt.FrameLoader(paths, H, W) as fl:
        with pytest.raises(IOError, match=r"rc -4"):
            for f in fl:
                got.append(f)
    assert len(got) == 2
    with trt.FrameLoader(seq[:1] + [str(tmp_path / "none.png")], H, W) as fl:
        it = iter(fl)
        next(it)
        with pytest.raises(IOError, match=r"rc -1"):
            next(it)


def test_loader_stress_more_threads_than_cores(tmp_path):
    """16 workers, a small ring, a short switch interval: every frame once,
    in order, within a time bound."""
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (40, 16, 24)).astype(np.uint8)
    paths = []
    for i, img in enumerate(imgs):
        trt.write_png(tmp_path / f"f{i}.png", img)
        paths.append(str(tmp_path / f"f{i}.png"))
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def run():
            with trt.FrameLoader(paths, 16, 24, depth=3, n_threads=16) as fl:
                got.extend(fl)
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive()
    assert len(got) == len(imgs)
    for img, f in zip(imgs, got):
        np.testing.assert_array_equal(f, img.astype(np.float32))
