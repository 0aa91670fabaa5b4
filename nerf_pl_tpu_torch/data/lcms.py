"""``LAB`` to ``RGB`` as Pillow converts it: through LittleCMS 2.17.

``Image.convert`` takes a ``LAB`` picture to ``RGB`` or ``RGBA`` with
``ImageCms.buildTransform(createProfile("LAB"), createProfile("sRGB"),
"LAB", mode)``: ``cmsCreateLab2Profile(NULL)`` (Lab, D50 white, an identity
Lut16 in V2 encoding) to ``cmsCreate_sRGBProfile()`` (Rec. 709 primaries and
a D65 white adapted to D50 by Bradford, the IEC 61966-2.1 curves, a matrix
shaper), perceptual intent, flags 0, Pillow's pixel types (4 bytes a pixel,
the fourth an extra channel; ``LAB`` as ``PT_LabV2``, read as plain bytes).
The core image's bytes go in as they stand: L 0-255, a and b offset by 128.

What LittleCMS builds, rebuilt here step for step:

  * the pipeline: the Lab profile's V4-to-V2 matrix, identity CLUT and
    V2-to-V4 matrix (which ``PreOptimize`` removes: they cancel), the
    Lab-to-XYZ stage (V4 rules: L = 100 v, a = 255 v - 128; ``cmsLab2XYZ``
    on D50, over 1 + 32767/32768), the sRGB profile's inverse colorant
    matrix times 1 + 32767/32768, and the inverse of its parametric curve
    (type -4); each stage takes float32 in and gives float32 out, doubles
    inside, as ``_LUTeval16`` runs them;
  * ``OptimizeByResampling``: a 16-bit CLUT of 33 nodes an axis, sampled at
    ``_cmsQuantizeVal`` inputs (``floor(i 65535 / 32 + 0.5)``), each output
    saturated to 16 bits by ``_cmsQuickSaturateWord`` (the 2^36 x 1.5
    floor); the white fix-up finds Lab's white (0xFFFF, 0x8080, 0x8080)
    off the nodes and patches nothing;
  * per pixel, ``TetrahedralInterp16`` on each channel widened as x * 257,
    then ``FROM_16_TO_8``: ``csrc/lcms_transform.cpp`` (``lab_to_rgb``),
    with ``lab_to_rgb_plain`` the same stage in numpy.

Pillow's ``RGBA`` has the same colours, and for alpha the core image's
fourth byte, which its transform copies (``data/image.py``'s
``Picture.pad``).  ``LAB`` to ``L`` is not a conversion Pillow has: it
raises, and so does ``data/image.py``.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from . import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "lcms_transform.cpp"
NODES = 33

_D50 = (0.9642, 1.0, 0.8249)
_BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367),
             (0.0389, -0.0685, 1.0296))
_MAX_ENCODEABLE_XYZ = 1.0 + 32767.0 / 32768.0
# cmsCreate_sRGBProfile: the D65 white point, the Rec. 709 primaries (x, y)
# and the parametric curve of type 4
_D65 = (0.3127, 0.3290)
_PRIMARIES = ((0.6400, 0.3300), (0.3000, 0.6000), (0.1500, 0.0600))
_CURVE = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)

_lock = threading.Lock()
_lib = None
_table = None


# ------------------------------------- cmsmtrx.c and cmswtpnt.c, in doubles
def _inverse(a):
    """``_cmsMAT3inverse``, term for term."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _product(a, b):
    """``_cmsMAT3per``."""
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _apply(a, v):
    """``_cmsMAT3eval``."""
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def _adaptation(src, dst):
    """``_cmsAdaptationMatrix`` with Bradford's cone matrix."""
    s, d = _apply(_BRADFORD, src), _apply(_BRADFORD, dst)
    cone = [[d[0] / s[0], 0.0, 0.0], [0.0, d[1] / s[1], 0.0],
            [0.0, 0.0, d[2] / s[2]]]
    return _product(_inverse(_BRADFORD), _product(cone, _BRADFORD))


def _rgb_to_xyz():
    """``_cmsBuildRGB2XYZtransferMatrix`` of sRGB, adapted to D50: the
    colorant tags ``cmsCreate_sRGBProfile`` writes."""
    (xr, yr), (xg, yg), (xb, yb) = _PRIMARIES
    xn, yn = _D65
    coef = _apply(_inverse([[xr, xg, xb], [yr, yg, yb],
                            [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
                  [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb],
         [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg),
          coef[2] * (1.0 - xb - yb)]]
    white = [(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0]  # cmsxyY2XYZ
    return _product(_adaptation(white, _D50), m)


def output_matrix():
    """``BuildRGBOutputMatrixShaper``'s matrix: the colorants' inverse,
    each term times 1 + 32767/32768."""
    return [[v * _MAX_ENCODEABLE_XYZ for v in row]
            for row in _inverse(_rgb_to_xyz())]


# ------------------------------------------------------------ the CLUT
def _saturate_word(d: np.ndarray) -> np.ndarray:
    """``_cmsQuickSaturateWord``: +0.5, clipped, then ``_cmsQuickFloorWord``
    (the floor of ``d - 32767`` read from ``d - 32767 + 2^36 x 1.5``)."""
    d = d + 0.5
    t = (d - 32767.0) + 103079215104.0
    low = (t.view(np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    word = (low >> 16) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, word)
                    ).astype(np.uint16)


def _lab_to_xyz(v):
    """``EvaluateLab2XYZ`` on float32 inputs: float32 X, Y, Z over
    ``MAX_ENCODEABLE_XYZ``."""
    lab = (v[0].astype(np.float64) * 100.0,
           v[1].astype(np.float64) * 255.0 - 128.0,
           v[2].astype(np.float64) * 255.0 - 128.0)
    y = (lab[0] + 16.0) / 116.0
    x = y + 0.002 * lab[1]
    z = y - 0.005 * lab[2]

    def f_1(t):
        return np.where(t <= 24.0 / 116.0,
                        (108.0 / 841.0) * (t - (16.0 / 116.0)), t * t * t)
    return [(f_1(t) * w / _MAX_ENCODEABLE_XYZ).astype(np.float32)
            for t, w in zip((x, y, z), _D50)]


def _inverse_curve(v: np.ndarray) -> np.ndarray:
    """The parametric curve of type -4 on float32 inputs, as float32."""
    g, a, b, c, d = _CURVE
    e = a * d + b
    disc = e ** g if e >= 0 else 0.0
    r = v.astype(np.float64)
    with np.errstate(invalid="ignore"):
        out = np.where(r >= disc, (np.power(np.maximum(r, 0.0), 1.0 / g) - b)
                       / a, r / c)
    return out.astype(np.float32)


def build_clut() -> np.ndarray:
    """The (33, 33, 33, 3) uint16 CLUT LittleCMS samples for Pillow's
    ``LAB`` -> ``RGB`` transform, indexed [L][a][b]."""
    q = np.floor(np.arange(NODES) * 65535.0 / (NODES - 1) + 0.5)
    grid = np.meshgrid(q, q, q, indexing="ij")
    v = [(g.ravel().astype(np.float32) / np.float32(65535.0)) for g in grid]
    xyz = _lab_to_xyz(v)
    m = output_matrix()
    out = []
    for i in range(3):  # EvaluateMatrix: a double sum, stored as float32
        acc = np.zeros(xyz[0].shape, np.float64)
        for j in range(3):
            acc = acc + xyz[j].astype(np.float64) * m[i][j]
        rgb = _inverse_curve(acc.astype(np.float32))
        out.append(_saturate_word(rgb.astype(np.float64) * 65535.0))
    return np.stack(out, -1).reshape(NODES, NODES, NODES, 3)


def clut() -> np.ndarray:
    """``build_clut()``, built once."""
    global _table
    with _lock:
        if _table is None:
            _table = np.ascontiguousarray(build_clut())
        return _table


# ---------------------------------------------------------- per pixel
def _to_fixed_domain(a):
    return a + (a + 0x7FFF) // 0xFFFF


def lab_to_rgb_plain(px: np.ndarray) -> np.ndarray:
    """(..., 3+) uint8 core-image ``LAB`` -> (..., 3) uint8 ``RGB``: the
    tetrahedral interpolation in numpy."""
    table = clut().astype(np.int64)
    shape = px.shape[:-1]
    v = px[..., :3].reshape(-1, 3).astype(np.int64)
    f = _to_fixed_domain(v * 257 * (NODES - 1))
    n0, r = f >> 16, f & 0xFFFF
    step = (v != 255).astype(np.int64)
    x0, y0, z0 = n0[:, 0], n0[:, 1], n0[:, 2]
    x1, y1, z1 = x0 + step[:, 0], y0 + step[:, 1], z0 + step[:, 2]
    rx, ry, rz = r[:, 0:1], r[:, 1:2], r[:, 2:3]

    def d(a, b, c):
        return table[a, b, c]
    c0 = d(x0, y0, z0)
    # the six tetrahedra, in TetrahedralInterp16's order of tests
    cases = [
        ((rx >= ry) & (ry >= rz),
         (d(x1, y0, z0) - c0, d(x1, y1, z0) - d(x1, y0, z0),
          d(x1, y1, z1) - d(x1, y1, z0))),
        ((rx >= ry) & (ry < rz) & (rz >= rx),
         (d(x1, y0, z1) - d(x0, y0, z1), d(x1, y1, z1) - d(x1, y0, z1),
          d(x0, y0, z1) - c0)),
        ((rx >= ry) & (ry < rz) & (rz < rx),
         (d(x1, y0, z0) - c0, d(x1, y1, z1) - d(x1, y0, z1),
          d(x1, y0, z1) - d(x1, y0, z0))),
        ((rx < ry) & (rx >= rz),
         (d(x1, y1, z0) - d(x0, y1, z0), d(x0, y1, z0) - c0,
          d(x1, y1, z1) - d(x1, y1, z0))),
        ((rx < ry) & (rx < rz) & (ry >= rz),
         (d(x1, y1, z1) - d(x0, y1, z1), d(x0, y1, z0) - c0,
          d(x0, y1, z1) - d(x0, y1, z0))),
        ((rx < ry) & (rx < rz) & (ry < rz),
         (d(x1, y1, z1) - d(x0, y1, z1), d(x0, y1, z1) - d(x0, y0, z1),
          d(x0, y0, z1) - c0)),
    ]
    c = [np.zeros_like(c0) for _ in range(3)]
    for mask, terms in cases:
        m = np.broadcast_to(mask, c0.shape)
        for k in range(3):
            c[k] = np.where(m, terms[k], c[k])
    rest = c[0] * rx + c[1] * ry + c[2] * rz + 0x8001
    v16 = (c0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF
    out = ((v16 * 65281 + 8388608) >> 24).astype(np.uint8)
    return out.reshape(shape + (3,))


def _native():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SOURCE)))
            lib.lcms_lab_to_rgb.restype = None
            lib.lcms_lab_to_rgb.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_void_p,
                                            ctypes.c_void_p]
            _lib = lib
        return _lib


def lab_to_rgb(px: np.ndarray) -> np.ndarray:
    """The C++ stage: ``lab_to_rgb_plain``'s output."""
    table = clut()
    lib = _native()
    src = np.ascontiguousarray(px)
    n = src.size // src.shape[-1]
    out = np.empty(src.shape[:-1] + (3,), np.uint8)
    lib.lcms_lab_to_rgb(src.ctypes.data, n, src.shape[-1], table.ctypes.data,
                        out.ctypes.data)
    return out
