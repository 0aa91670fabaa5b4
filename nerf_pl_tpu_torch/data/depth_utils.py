"""PFM (portable float map) depth I/O (``nerf_pl_tpu/data/depth_utils.py``;
reference ``datasets/depth_utils.py:5-70``).

PFM layout: header line ``PF`` (colour) or ``Pf`` (grayscale), a ``W H``
dimensions line, a scale line whose sign encodes endianness (< 0 =
little-endian), then rows of float32 samples bottom-to-top.
"""
from __future__ import annotations

import re

import numpy as np


def read_pfm(filename: str):
    """Returns (data, scale); data is (H, W) or (H, W, 3) float."""
    with open(filename, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")

        dims = f.readline()
        while dims.startswith(b"#"):  # skip comments
            dims = f.readline()
        match = re.match(rb"^(\d+)\s(\d+)\s$", dims)
        if not match:
            raise ValueError("Malformed PFM header.")
        width, height = int(match.group(1)), int(match.group(2))

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = data.reshape(shape)
    return np.flipud(data), scale


def save_pfm(filename: str, image: np.ndarray, scale: float = 1.0) -> None:
    if image.dtype.name != "float32":
        raise ValueError("Image dtype must be float32.")
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("Image must have H x W x {1, 3} shape.")

    image = np.flipud(image)
    if image.dtype.byteorder == ">" or (
        image.dtype.byteorder == "=" and np.little_endian is False
    ):
        scale = abs(scale)
    else:
        scale = -abs(scale)

    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{scale}\n".encode())
        image.tofile(f)
