"""A Kodak PhotoCD reader: what Pillow's ``PcdImagePlugin`` gives: the
768x512 base image at byte 96 * 2048, two rows of luma then the pair's
half-width Cb and Cr rows, PhotoYCC to ``RGB`` as the ``pcd`` decoder's
``YCC;P`` unpacker does, turned 90 or 270 degrees (counter-clockwise, the
size 512x768) where the orientation byte's low bits are 1 or 3.

The unpacker is a table lookup, ``r = L[y] + CR[cr]``, ``g = L[y] +
GR[cr] + GB[cb]``, ``b = L[y] + CB[cb]``, clipped to 0-255.  Pillow's
tables are not linear in their index (their rounding is their
generator's), so these were read off Pillow's decoder: every (y, cb) and
(y, cr) pair, and every (cb, cr) pair at enough luma values to see each
green sum unclipped, solved for integer tables that give the same clipped
outputs; the tests hold the decode against Pillow's.  Each table is its
first value and its steps (int8, base64).
"""
from __future__ import annotations

import base64

import numpy as np

from . import unpack

W, H = 768, 512


def _table(first: int, steps) -> np.ndarray:
    d = np.frombuffer(base64.b64decode("".join(steps)), np.int8)
    return np.concatenate([[first], first + np.cumsum(d, dtype=np.int64)])


_L = _table(0, (
    "AQIBAQIBAgEBAgEBAgEBAgEBAgECAQECAQECAQECAQECAQIBAQIBAQIBAQIBAQIBAgEB"
    "AgEBAgEBAgECAQECAQECAQECAQECAQIBAQIBAQIBAQIBAQIBAgEBAgEBAgEBAgEBAgEC"
    "AQECAQECAQECAQECAQIBAQIBAQIBAQIBAgEBAgEBAgEBAgEBAgECAQECAQECAQECAQEC"
    "AQIBAQIBAQIBAQIBAQIBAgEBAgEBAgEBAgECAQECAQECAQECAQECAQIBAQIBAQIBAQIB"
    "AQIBAgEBAgEBAgEBAgEBAgECAQECAQECAQECAQIBAQIBAQIBAQIBAQIBAgEBAgEBAgEB"))

_CR = _table(-249, (
    "AgICAgIBAgICAgECAgICAgECAgICAgECAgICAQICAgICAQICAgIBAgICAgIBAgICAgIB"
    "AgICAgECAgICAgECAgICAQICAgICAQICAgICAQICAgIBAgICAgIBAgICAgECAgICAgEC"
    "AgICAgECAgICAQICAgICAQICAgIBAgICAgIBAgICAgIBAgECAgECAgICAgECAgICAgEC"
    "AgICAQICAgICAQICAgIBAgICAgIBAgICAgIBAgICAgECAgICAgECAgICAQICAgICAQIC"
    "AgICAQICAgIBAgICAgIBAgICAgECAgICAgECAgICAgECAgICAQICAgICAQICAgIBAgIC"))

_CB = _table(-345, (
    "AgIDAgICAwICAgIDAgICAgMCAgIDAgICAgMCAgIDAgICAgMCAgIDAgICAgMCAgICAwIC"
    "AgMCAgICAwICAgMCAgICAwICAgIDAgICAwICAgIDAgICAwICAgIDAgICAgMCAgIDAgIC"
    "AgMCAgIDAgICAgMCAgIDAgICAgMCAgICAwICAgMCAgICAwICAgMCAgICAwICAgIDAgIC"
    "AwIBAgIDAgICAwICAgIDAgICAgMCAgIDAgICAgMCAgIDAgICAgMCAgICAwICAgMCAgIC"
    "AwICAgMCAgICAwICAgMCAgICAwICAgIDAgICAwICAgIDAgICAwICAgIDAgICAgMCAgID"))

_GR = _table(127, (
    "////////AP////////////////8A/////////////////wD///////////////8A////"
    "/////////////wD/////////////////AP///////////////wD/////////////////"
    "AP////////////////8A/////////////////wD///////8A//////8A////////////"
    "/////wD/////////////////AP////////////////8A////////////////AP//////"
    "//////////8A/////////////////wD///////////////8A/////////////////wD/"))

_GB = _table(67, (
    "AP8A/wAA/wD/AP8AAP8A/wD/AAD/AP8A/wAA/wD/AP8A/wAA/wD/AP8AAP8A/wD/AAD/"
    "AP8A/wAA/wD/AP8AAP8A/wD/AAD/AP8A/wAA/wD/AP8AAP8A/wD/AAD/AP8A/wAA/wD/"
    "AP8AAP8A/wD/AAD/AP8A/wD/AAD/AP8A/wAA/wD/AP8AAP8A/wD/AAD/AP8A/wAA/wD/"
    "AP8AAAAA/wD/AAD/AP8A/wAA/wD/AP8AAP8A/wD/AAD/AP8A/wAA/wD/AP8A/wAA/wD/"
    "AP8AAP8A/wD/AAD/AP8A/wAA/wD/AP8AAP8A/wD/AAD/AP8A/wAA/wD/AP8AAP8A/wD/"))


def photo_ycc_to_rgb(y: np.ndarray, cb: np.ndarray,
                     cr: np.ndarray) -> np.ndarray:
    """PhotoYCC samples (uint8, one shape) -> (..., 3) uint8 RGB."""
    lum = _L[y]
    rgb = np.stack([lum + _CR[cr], lum + _GR[cr] + _GB[cb], lum + _CB[cb]],
                   -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def open_pcd(data: bytes) -> dict:
    s = data[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    turn = {1: 90, 3: 270}.get(s[1538] & 3)
    return dict(size=(H, W) if turn else (W, H), mode="RGB", turn=turn)


def load_pcd(data: bytes, head: dict):
    start, need = 96 * 2048, H * W * 3 // 2
    if len(data) - start < need:
        raise ValueError(unpack.TRUNCATED)
    pairs = np.frombuffer(data, np.uint8, need, start).reshape(H // 2,
                                                                3 * W)
    y = pairs[:, :2 * W].reshape(H, W)
    x = np.arange(W)
    cb = np.repeat(pairs[:, 2 * W + x // 2], 2, 0)
    cr = np.repeat(pairs[:, (x + 5 * W) // 2], 2, 0)
    px = photo_ycc_to_rgb(y, cb, cr)
    if head["turn"]:
        px = np.rot90(px, 1 if head["turn"] == 90 else 3)
    return np.ascontiguousarray(px), "RGB", None, None
