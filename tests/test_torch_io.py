"""The port's image I/O (``io/image.py``): its PNG codec of zlib and numpy
against Pillow, in both directions, with decoded pixels equal; the annotation round trip; the integer readouts against the JAX
package's; and what happens where Pillow is missing."""

import io as stdio
import struct
import subprocess
import sys
import textwrap
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from realtimedepthdiffusion_tpu import io as jio
from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.pipeline import DepthPipeline as JPipeline
from realtimedepthdiffusion_tpu_torch import get_pipeline
from realtimedepthdiffusion_tpu_torch import io as tio
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.io import image as timage

KINDS = ["gray8", "rgb8", "rgba8", "gray16", "gray_alpha8"]


def _pixels(kind, h=37, w=53, seed=0):
    """Smooth content with noise, so that an adaptive encoder has a reason
    to pick each filter."""
    r = np.random.default_rng(seed)
    ramp = np.add.outer(np.arange(h) * 3, np.arange(w) * 2)
    if kind == "gray16":
        return ((ramp * 157 + r.integers(0, 900, (h, w))) % 65536).astype(np.uint16)
    channels = {"gray8": None, "rgb8": 3, "rgba8": 4, "gray_alpha8": 2}[kind]
    if channels is None:
        return ((ramp + r.integers(0, 9, (h, w))) % 256).astype(np.uint8)
    base = ramp[..., None] * np.arange(1, channels + 1)
    return ((base + r.integers(0, 9, (h, w, channels))) % 256).astype(np.uint8)


def _pil_png(arr, **kw):
    mode = {2: "LA"}.get(arr.shape[2]) if arr.ndim == 3 and arr.shape[2] == 2 else None
    buf = stdio.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG", **kw)
    return buf.getvalue()


def _png_with_filter(arr, ftype):
    """A PNG of ``arr`` whose every row uses filter ``ftype``, encoded here
    from the PNG specification's definitions (one byte at a time)."""
    h, w = arr.shape[:2]
    if arr.dtype == np.uint16:
        depth, ctype, raw = 16, 0, arr.astype(">u2").tobytes()
        bpp = 2
    else:
        channels = 1 if arr.ndim == 2 else arr.shape[2]
        depth, ctype, raw, bpp = 8, {1: 0, 2: 4, 3: 2, 4: 6}[channels], arr.tobytes(), channels
    stride = w * bpp
    out = bytearray()
    prev = bytes(stride)
    for y in range(h):
        line = raw[y * stride:(y + 1) * stride]
        out.append(ftype)
        for i in range(stride):
            a = line[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if ftype == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) // 2)[ftype]
            out.append((line[i] - pred) & 255)
        prev = line

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    body = zlib.compress(bytes(out))
    half = len(body) // 2  # two IDAT chunks: a decoder must join them
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"tEXt", b"Comment\x00ignored") + chunk(b"IDAT", body[:half])
            + chunk(b"IDAT", body[half:]) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_decode_every_filter_type(kind, ftype):
    """Each filter type on each pixel format: the codec's pixels equal the
    array encoded, and Pillow's reading of the same bytes."""
    arr = _pixels(kind, seed=ftype)
    data = _png_with_filter(arr, ftype)
    got = tio.png_decode(data)
    assert got.dtype == arr.dtype and np.array_equal(got, arr)
    assert np.array_equal(np.asarray(Image.open(stdio.BytesIO(data))), arr)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_what_pillow_writes(kind):
    """Pillow's own encoder (adaptive filters) at two efforts."""
    arr = _pixels(kind, 64, 80, seed=5)
    for kw in ({}, {"compress_level": 1}, {"optimize": True}):
        got = tio.png_decode(_pil_png(arr, **kw))
        assert got.dtype == arr.dtype and np.array_equal(got, arr)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
@pytest.mark.parametrize("level", [None, 0, 1, 9])
def test_pillow_decodes_what_the_codec_writes(kind, level):
    arr = _pixels(kind, seed=3)
    data = tio.png_encode(arr, level)
    back = np.asarray(Image.open(stdio.BytesIO(data)))
    assert back.shape == arr.shape and np.array_equal(back, arr)
    assert np.array_equal(tio.png_decode(data), arr)
    if level is not None:  # png_level is zlib's level: 0 stores, 9 packs hardest
        assert len(tio.png_encode(arr, 0)) >= len(data) >= len(tio.png_encode(arr, 9))


@pytest.mark.parametrize("bad", ["palette", "interlaced", "rgb16", "one_bit", "crc", "not_png",
                                 "rgba_write", "float_write"])
def test_codec_refusals(bad):
    arr = _pixels("rgb8")
    buf = stdio.BytesIO()
    if bad == "palette":
        Image.fromarray(arr).convert("P").save(buf, format="PNG")
    elif bad == "interlaced":
        data = bytearray(tio.png_encode(arr))
        data[28] = 1
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
        buf.write(bytes(data))
    elif bad == "rgb16":
        data = bytearray(tio.png_encode(arr))
        data[24] = 16
        buf.write(bytes(data))
    elif bad == "one_bit":
        Image.fromarray(arr[..., 0] > 128).save(buf, format="PNG")
    elif bad == "crc":
        data = bytearray(tio.png_encode(arr))
        data[-20] ^= 1
        buf.write(bytes(data))
    elif bad == "not_png":
        buf.write(b"\xff\xd8\xff\xe0 a JPEG's first bytes")
    if bad.endswith("_write"):
        wrong = _pixels("rgba8") if bad == "rgba_write" else arr.astype(np.float32)
        with pytest.raises(ValueError, match="the zlib codec writes"):
            tio.png_encode(wrong)
    else:
        with pytest.raises(ValueError):
            tio.png_decode(buf.getvalue())


@pytest.fixture()
def zlib_codec(monkeypatch):
    """The public functions on the zlib codec, as where Pillow is missing."""
    monkeypatch.setattr(timage, "codec", lambda: "zlib")

    def no_pil():
        raise AssertionError("the zlib codec reached for Pillow")

    monkeypatch.setattr(timage, "_pil", no_pil)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray_alpha8"])
def test_readers_equal_the_reference_on_both_codecs(tmp_path, monkeypatch, kind):
    """``imread_rgb``, ``imread_gray`` and ``image_size`` of a Pillow-written
    file: the zlib codec, the port on Pillow and the JAX package agree."""
    path = str(tmp_path / f"{kind}.png")
    with open(path, "wb") as f:
        f.write(_pil_png(_pixels(kind, seed=9)))
    want = (jio.imread_rgb(path), jio.imread_gray(path), jio.image_size(path))
    assert tio.codec() == "pil"
    for name in ("pil", "zlib"):
        monkeypatch.setattr(timage, "codec", lambda name=name: name)
        got = (tio.imread_rgb(path), tio.imread_gray(path), tio.image_size(path))
        assert got[0].dtype == np.uint8 and got[0].shape == want[0].shape
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[2] == want[2] == want[0].shape[:2]


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_imwrite_on_the_zlib_codec(tmp_path, zlib_codec, kind):
    """What ``imwrite`` writes without Pillow, Pillow and the JAX package
    read back equal, at every ``png_level``; u8 input of another dtype is
    cast as the reference casts it."""
    arr = _pixels(kind, seed=11)
    for level in (None, 1):
        path = str(tmp_path / f"{kind}_{level}.PNG")
        tio.imwrite(path, arr, png_level=level)
        assert np.array_equal(np.asarray(Image.open(path)), arr)
    if kind != "gray16":
        tio.imwrite(path, arr.astype(np.float32))
        assert np.array_equal(np.asarray(Image.open(path)), arr)
        assert np.array_equal(jio.imread_rgb(path), tio.imread_rgb(path))
    else:
        with pytest.raises(ValueError, match="16-bit"):
            tio.imread_gray(path)
        with open(path, "rb") as f:
            assert np.array_equal(tio.png_decode(f.read()), arr)


@pytest.mark.parametrize("codec", ["pil", "zlib"])
def test_annotation_round_trip(tmp_path, monkeypatch, codec):
    """save -> load gives the planes back on either codec, and the file is
    the one the JAX package writes and reads."""
    monkeypatch.setattr(timage, "codec", lambda: codec)
    r = np.random.default_rng(2)
    mask = r.random((40, 56)) < 0.2
    value = np.where(mask, r.choice([0, 64, 128, 192, 254], (40, 56)), 0).astype(np.uint8)
    path, jpath = str(tmp_path / "ann.png"), str(tmp_path / "jann.png")
    tio.save_annotation(path, mask, value)
    jio.save_annotation(jpath, mask, value)
    for p in (path, jpath):
        m, v = tio.load_annotation(p)
        assert m.dtype == bool and v.dtype == np.uint8
        assert np.array_equal(m, mask) and np.array_equal(v, value)
    jm, jv = jio.load_annotation(path)
    assert np.array_equal(jm, mask) and np.array_equal(jv, value)
    assert np.array_equal(np.asarray(Image.open(path)), np.asarray(Image.open(jpath)))
    cfg = DiffusionConfig(annotation_sentinel=7)
    tio.save_annotation(path, mask, value, cfg)
    assert int(np.asarray(Image.open(path))[~mask].max()) == 7
    assert np.array_equal(tio.load_annotation(path, cfg)[0], mask)


@pytest.mark.parametrize("name", ["photo.jpg", "photo.JPEG", "photo.bmp"])
def test_other_formats_need_pillow(tmp_path, zlib_codec, name):
    """Without Pillow a JPEG is refused, on read and on write, by a message
    that names PIL; nothing falls back to another decoder."""
    path = str(tmp_path / name)
    Image.fromarray(_pixels("rgb8")).save(path)
    for read in (tio.imread_rgb, tio.imread_gray, tio.image_size):
        with pytest.raises(RuntimeError, match="PIL"):
            read(path)
    with pytest.raises(RuntimeError, match="PIL"):
        tio.imwrite(path, _pixels("rgb8"))
    with pytest.raises(RuntimeError, match="PIL"):
        tio.load_annotation(path)


def test_codec_follows_the_import():
    """With Pillow blocked, ``codec()`` says "zlib", a PNG round-trips, and
    a JPEG raises naming PIL; with it importable, ``codec()`` says "pil"."""
    assert tio.codec() == "pil"
    code = textwrap.dedent("""
        import sys, os, tempfile
        sys.modules["PIL"] = None
        import numpy as np
        from realtimedepthdiffusion_tpu_torch import io
        assert io.codec() == "zlib"
        d = tempfile.mkdtemp()
        a = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
        io.imwrite(os.path.join(d, "a.png"), a)
        assert np.array_equal(io.imread_rgb(os.path.join(d, "a.png")), a)
        open(os.path.join(d, "a.jpg"), "wb").write(b"\\xff\\xd8\\xff\\xe0")
        try:
            io.imread_rgb(os.path.join(d, "a.jpg"))
        except RuntimeError as e:
            assert "PIL" in str(e), e
        else:
            raise SystemExit("a JPEG was read without PIL")
        assert io.codec() == "zlib" and "PIL.Image" not in sys.modules
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _depths():
    base = np.array([0.0, 1.0, 127.5, 254.99, 255.0, -1.0, 300.0, 1e-3, 0.5, 1.5, 2.5], np.float32)
    halves = (np.arange(0, 65536, 997, dtype=np.float32) + np.float32(0.5)) / np.float32(257)
    return np.concatenate([base, halves, np.nextafter(halves, np.float32(0)),
                           np.nextafter(halves, np.float32(300))]).astype(np.float32)[None]


def test_depth_to_u16_equals_pipeline_and_jax():
    d = _depths()
    got = tio.depth_to_u16(d)
    assert got.dtype == np.uint16 and np.array_equal(got, jio.depth_to_u16(d))
    pipe = get_pipeline(1, d.shape[1], DiffusionConfig(), device="cpu")
    assert np.array_equal(pipe.depth_u16(torch.from_numpy(d)).numpy(), got)
    jpipe = JPipeline(1, d.shape[1], JConfig(backend="xla", fast_start=False))
    assert np.array_equal(np.asarray(jpipe.depth_u16(jnp.asarray(d))), got)


def test_depth_to_u8_equals_pipeline_and_jax():
    d = _depths()
    got = tio.depth_to_u8(d)
    assert got.dtype == np.uint8 and np.array_equal(got, jio.depth_to_u8(d))
    pipe = get_pipeline(1, d.shape[1], DiffusionConfig(), device="cpu")
    assert np.array_equal(pipe.depth_u8(torch.from_numpy(d)).numpy(), got)
