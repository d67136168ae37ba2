"""Image and annotation I/O (port of ``realtimedepthdiffusion_tpu/io/image.py``).

Imaging libraries are confined to this module: everything inside the port
works on numpy arrays and torch tensors. There are two codecs, and
``codec()`` says which one this process uses:

- ``"pil"`` where ``import PIL`` succeeds: PNG and JPEG through Pillow, as
  in the reference;
- ``"zlib"`` where it does not: PNG through ``png_encode`` / ``png_decode``
  below, made of ``zlib`` and numpy. They cover what the port writes and
  reads: 8-bit gray, 8-bit RGB (RGBA is read as RGB, gray with alpha as
  gray) and 16-bit gray, non-interlaced; every filter type on read, filter
  0 on write. Any other file raises, a JPEG naming Pillow as what it needs.

The choice is made once, by the import alone; no call switches codec after
a failure.

Annotation checkpoint format, the contract of the original program
(``src/main.cpp:160-170`` load, ``:297-318`` save):
- grayscale PNG, one byte per pixel
- value 32  = unannotated sentinel
- any other value = scribbled depth (the dataset uses {0,64,128,192,254})
The annotation PNG round-trips a session: it is the checkpoint format.
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import Tuple

import numpy as np

from ..config import DiffusionConfig

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Samples per pixel of the PNG colour types read here: gray, RGB, gray with
# alpha, RGBA. (3, a palette, is refused.)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


@functools.lru_cache(maxsize=None)
def codec() -> str:
    """``"pil"`` if Pillow imports in this process, else ``"zlib"``."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return "zlib"
    return "pil"


def _pil():
    from PIL import Image  # local import: I/O boundary only

    return Image


def _is_png(path: str) -> bool:
    return str(path).lower().endswith(".png")


def _read_png_file(path: str) -> np.ndarray:
    """A PNG file's pixels by the zlib codec; any other file raises."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise RuntimeError(
            f"{path}: not a PNG. Without Pillow (PIL) this module reads and writes PNG only; "
            "a JPEG or any other format needs PIL"
        )
    return png_decode(data)


def _png_header(data: bytes):
    """(width, height, bit depth, colour type, interlace) of a PNG."""
    if not data.startswith(_PNG_SIGNATURE) or data[12:16] != b"IHDR" or len(data) < 33:
        raise ValueError("not a PNG: bad signature or no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", data[16:29])
    return w, h, depth, ctype, interlace


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of a PNG's inflated data: (h, stride) bytes.
    Types 0-2 run in numpy; 3 (average) and 4 (Paeth) depend on the byte to
    the left and run a Python loop over the row."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zeros above the image
    for y in range(h):
        ftype, line, up = int(rows[y, 0]), rows[y, 1:], out[y]
        if ftype == 0:
            out[y + 1] = line
        elif ftype == 1:  # Sub: a running sum per byte lane, modulo 256
            lanes = line.reshape(-1, bpp)
            out[y + 1] = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            out[y + 1] = line + up
        elif ftype in (3, 4):
            cur = bytearray(stride)
            src, above = line.tolist(), up.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = above[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = above[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (src[i] + pred) & 255
            out[y + 1] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
    return out[1:]


def png_decode(data: bytes) -> np.ndarray:
    """The pixels of a PNG as it stores them: (H, W) uint8 or uint16 for
    gray, (H, W, C) uint8 for RGB (3), gray with alpha (2) and RGBA (4).
    Non-interlaced, 8 bits a sample, or 16 for gray; anything else raises."""
    w, h, depth, ctype, interlace = _png_header(data)
    if ctype not in _PNG_CHANNELS or interlace or not (depth == 8 or (depth == 16 and ctype == 0)):
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, interlace {interlace}): "
            "the zlib codec reads non-interlaced 8-bit gray, RGB and RGBA and 16-bit gray"
        )
    idat, pos = [], len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    channels = _PNG_CHANNELS[ctype]
    bpp = channels * depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        return np.ascontiguousarray(px).view(">u2").astype(np.uint16)  # big-endian samples
    return px.reshape(h, w) if channels == 1 else px.reshape(h, w, channels)


def png_encode(arr: np.ndarray, level: int | None = None) -> bytes:
    """A PNG of uint8 (H, W) gray or (H, W, 3) RGB, or uint16 (H, W) gray:
    filter 0 on every row, deflated at zlib's ``level`` (its default if
    None)."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16 and arr.ndim == 2:
        depth, ctype, body = 16, 0, arr.astype(">u2").view(np.uint8)
    elif arr.dtype == np.uint8 and (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        depth, ctype, body = 8, (0 if arr.ndim == 2 else 2), arr
    else:
        raise ValueError(f"the zlib codec writes uint8 (H, W) or (H, W, 3) and uint16 (H, W), "
                         f"got {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.zeros((h, body.size // h + 1), np.uint8)  # filter type 0 leads each row
    rows[:, 1:] = body.reshape(h, -1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    deflated = zlib.compress(rows.tobytes(), -1 if level is None else int(level))
    return (_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", deflated) + chunk(b"IEND", b""))


def _rgb_to_l(rgb: np.ndarray) -> np.ndarray:
    """Pillow's 'L' of an RGB image: the ITU-R 601-2 luma in 16-bit fixed
    point, rounded."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _eight_bit(path: str, px: np.ndarray) -> np.ndarray:
    if px.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit PNG has no 8-bit reading here; "
                         "png_decode returns its uint16 pixels")
    return px


def imread_rgb(path: str) -> np.ndarray:
    """Load an image as (H, W, 3) uint8 RGB (alpha is dropped)."""
    if codec() == "pil":
        return np.asarray(_pil().open(path).convert("RGB"), dtype=np.uint8)
    px = _eight_bit(path, _read_png_file(path))
    if px.ndim == 2 or px.shape[2] == 2:
        gray = px if px.ndim == 2 else px[..., 0]
        return np.ascontiguousarray(np.repeat(gray[..., None], 3, axis=2))
    return np.ascontiguousarray(px[..., :3])


def image_size(path: str) -> Tuple[int, int]:
    """(H, W) of an image from its header alone, without decoding pixels;
    the shape ``imread_rgb`` would return (no EXIF transpose on either)."""
    if codec() == "pil":
        with _pil().open(path) as img:
            w, h = img.size
        return h, w
    with open(path, "rb") as f:
        head = f.read(33)
    if not head.startswith(_PNG_SIGNATURE):
        _read_png_file(path)  # raises, naming what it needs
    w, h, *_ = _png_header(head)
    return h, w


def imread_gray(path: str) -> np.ndarray:
    """Load an image as (H, W) uint8 grayscale (Pillow's 'L' mode)."""
    if codec() == "pil":
        return np.asarray(_pil().open(path).convert("L"), dtype=np.uint8)
    px = _eight_bit(path, _read_png_file(path))
    if px.ndim == 2 or px.shape[2] == 2:
        return np.ascontiguousarray(px if px.ndim == 2 else px[..., 0])
    return _rgb_to_l(px)


def imwrite(path: str, arr: np.ndarray, png_level: int | None = None) -> None:
    """Write uint8 (H,W) gray / (H,W,3) RGB, or uint16 (H,W) gray (a 16-bit
    PNG: the ``depth_to_u16`` export). ``png_level`` (0-9, PNG only) is
    zlib's effort; level 1 encodes several times faster than the default 6
    for a somewhat larger file."""
    arr = np.asarray(arr)
    if not (arr.dtype == np.uint16 and arr.ndim == 2):
        arr = arr.astype(np.uint8)
    if codec() == "pil":
        kw = {}
        if png_level is not None and _is_png(path):
            kw["compress_level"] = int(png_level)
        _pil().fromarray(arr).save(path, **kw)
        return
    if not _is_png(path):
        raise RuntimeError(
            f"{path}: without Pillow (PIL) this module writes PNG only; "
            "a JPEG or any other format needs PIL"
        )
    data = png_encode(arr, png_level)
    with open(path, "wb") as f:
        f.write(data)


def load_annotation(
    path: str, cfg: DiffusionConfig = DiffusionConfig()
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode an annotation PNG into (mask bool, value uint8): every pixel
    that differs from the sentinel (32) is annotated, and its gray value is
    the scribbled depth."""
    ann = imread_gray(path)
    mask = ann != np.uint8(cfg.annotation_sentinel)
    value = np.where(mask, ann, np.uint8(0)).astype(np.uint8)
    return mask, value


def save_annotation(
    path: str,
    mask: np.ndarray,
    value: np.ndarray,
    cfg: DiffusionConfig = DiffusionConfig(),
) -> None:
    """Encode (mask, value) back to the annotation PNG: scribbled pixels
    keep their value, everything else becomes the sentinel. Inverse of
    ``load_annotation``."""
    ann = np.where(mask, value, np.uint8(cfg.annotation_sentinel)).astype(np.uint8)
    imwrite(path, ann)


def depth_to_u8(depth: np.ndarray) -> np.ndarray:
    """float32 depth -> uint8 with saturation and round-half-to-even, as
    ``GpuMat::convertTo(CV_8UC1)`` gives it (``src/main.cpp:290``)."""
    return np.clip(np.rint(depth), 0, 255).astype(np.uint8)


def depth_to_u16(depth: np.ndarray) -> np.ndarray:
    """float32 depth -> uint16 at the solver's precision: u16 = depth * 257,
    the usual 8-to-16-bit replication scale (255 maps to 65535, and u16 //
    257 recovers ``depth_to_u8`` up to rounding). The multiply runs in
    float32, so this and ``DepthPipeline.depth_u16`` on the device are the
    same IEEE operation (a float64 product can round a knife-edge value to
    the other side of .5)."""
    scaled = depth.astype(np.float32) * np.float32(257.0)
    return np.clip(np.rint(scaled), 0, 65535).astype(np.uint16)
