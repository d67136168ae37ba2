"""I/O boundary: image and annotation codecs. The only package of the port
that may import Pillow; ``codec()`` says whether it did."""

from .image import (
    codec,
    depth_to_u8,
    depth_to_u16,
    image_size,
    imread_gray,
    imread_rgb,
    imwrite,
    load_annotation,
    png_decode,
    png_encode,
    save_annotation,
)

__all__ = [
    "codec",
    "depth_to_u8",
    "depth_to_u16",
    "image_size",
    "imread_gray",
    "imread_rgb",
    "imwrite",
    "load_annotation",
    "png_decode",
    "png_encode",
    "save_annotation",
]
