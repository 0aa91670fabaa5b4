"""Checkpoint save/restore in the JAX package's file format
(``nerf_pl_tpu/training/checkpoints.py``).

One msgpack file holds ``{params, opt_state, step, epoch}`` as flax's
``msgpack_serialize`` writes it: nested maps with string keys, lists stored
as maps keyed ``"0".."n-1"``, arrays as msgpack ext type 1 and numpy
scalars as ext type 3, each ext payload a msgpack ``(shape, dtype_name,
C-order bytes)`` tuple.  A self-contained codec for that subset lives
here, so files move both ways between the packages without flax or msgpack.

``bfloat16`` arrays are read as float32 (numpy has no bfloat16; widening is
exact) and written from bfloat16 torch tensors under the name ``bfloat16``.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..models.nerf import NeRF, nerf_to_numpy

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ---------------------------------------------------------------- encoding
def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v <= 0xFF:
        out += b"\xcc" + struct.pack(">B", v)
    elif 0 <= v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif 0 <= v < 1 << 64:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x80 <= v:
        out += b"\xd0" + struct.pack(">b", v)
    elif -0x8000 <= v:
        out += b"\xd1" + struct.pack(">h", v)
    elif -0x80000000 <= v:
        out += b"\xd2" + struct.pack(">i", v)
    elif -(1 << 63) <= v:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int,
              codes: Sequence[int]) -> None:
    """Header of a str/bin/array/map of length ``n``."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += b"\xc7" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += b"\xc8" + struct.pack(">H", n)
    else:
        out += b"\xc9" + struct.pack(">I", n)
    out += struct.pack(">b", code) + data


def _array_payload(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:  # bf16 only: numpy has no bfloat16
            # (a float16 tensor goes through numpy's own float16 below)
            return packb((tuple(t.shape), "bfloat16",
                          t.view(torch.int16).numpy().tobytes()))
        arr = t.numpy()
    arr = np.asarray(arr)  # not ascontiguousarray: it makes a 0-d array 1-d
    if arr.dtype.hasobject:
        raise ValueError("object arrays cannot be serialized")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, -1, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack-encode ``obj`` (ext 1 for arrays, ext 3 for numpy scalars)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# ---------------------------------------------------------------- decoding
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
               0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_EXT_LEN = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_VAR_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",  # bin
            0xC7: ">B", 0xC8: ">H", 0xC9: ">I",  # ext
            0xD9: ">B", 0xDA: ">H", 0xDB: ">I",  # str
            0xDC: ">H", 0xDD: ">I",  # array
            0xDE: ">H", 0xDF: ">I"}  # map


def _array_from_payload(data) -> np.ndarray:
    shape, dtype_name, buf = unpackb(bytes(data), raw_str=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _read(r: _Reader, raw_str: bool):
    b = r.unpack(">B")
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw_str)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw_str) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _read_str(r, b & 0x1F, raw_str)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED_INTS:
        return r.unpack(_FIXED_INTS[b])
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    if b in _EXT_LEN or 0xC7 <= b <= 0xC9:
        n = _EXT_LEN[b] if b in _EXT_LEN else r.unpack(_VAR_LEN[b])
        code = r.unpack(">b")
        data = r.take(n)
        if code == _EXT_NDARRAY:
            return _array_from_payload(data)
        if code == _EXT_NPSCALAR:
            return _array_from_payload(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")
    if b in _VAR_LEN:
        n = r.unpack(_VAR_LEN[b])
        if b <= 0xC6:
            return bytes(r.take(n))
        if b <= 0xDB:
            return _read_str(r, n, raw_str)
        if b <= 0xDD:
            return [_read(r, raw_str) for _ in range(n)]
        return _read_map(r, n, raw_str)
    raise ValueError(f"unsupported msgpack byte 0x{b:02x}")


def _read_str(r: _Reader, n: int, raw_str: bool):
    data = bytes(r.take(n))
    return data if raw_str else data.decode("utf-8")


def _read_map(r: _Reader, n: int, raw_str: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r, raw_str)
        out[k] = _read(r, raw_str)
    return out


def unpackb(data: bytes, raw_str: bool = False):
    """Decode one msgpack object (the inverse of ``packb``)."""
    r = _Reader(data)
    obj = _read(r, raw_str)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj


# ------------------------------------------------------------ checkpoints
def _to_state_dict(tree):
    """flax ``to_state_dict`` for plain trees: lists/tuples become maps
    keyed ``"0".."n-1"``; modules become their JAX param trees."""
    if isinstance(tree, NeRF):
        tree = nerf_to_numpy(tree)
    if isinstance(tree, dict):
        return {str(k): _to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def _unchunk(tree):
    """Reassemble arrays that flax split into ``__msgpack_chunked_array__``
    maps (only arrays above 1 GiB)."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def save_checkpoint(path: str, state: Any) -> None:
    """Write ``state`` (nested dicts/lists of arrays, tensors, NeRF modules
    and python scalars) atomically.  In a process group only rank 0 writes:
    the state is replicated, and N ranks replacing one shared path could
    publish a torn file."""
    from .logging import is_primary

    if not is_primary():
        return
    data = packb(_to_state_dict(state))
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Any:
    """The checkpoint's state dict: nested dicts with numpy leaves."""
    with open(path, "rb") as f:
        return _unchunk(unpackb(f.read()))


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if not isinstance(tree, dict):
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


def extract_model_state_dict(
    ckpt_path: str,
    model_name: str = "params",
    prefixes_to_ignore: Sequence[str] = (),
) -> Dict[str, np.ndarray]:
    """Flattened ``{path: array}`` for keys under ``model_name`` with the
    prefix stripped and ``prefixes_to_ignore`` dropped (reference
    ``utils/__init__.py:55-70``)."""
    raw = load_checkpoint(ckpt_path)
    if ("params" in raw and model_name != "params"
            and model_name in raw.get("params", {})):
        raw = raw["params"]
    pre = model_name + "/"
    out = {}
    for k, v in _flatten(raw).items():
        if not k.startswith(pre):
            continue
        k = k[len(pre):]
        if any(k.startswith(p) for p in prefixes_to_ignore):
            continue
        out[k] = v
    return out


def load_ckpt_into(
    model: torch.nn.Module,
    ckpt_path: str,
    model_name: str = "coarse",
    prefixes_to_ignore: Sequence[str] = (),
    loaded: Optional[Dict[str, np.ndarray]] = None,
) -> torch.nn.Module:
    """Non-strict merge of a checkpoint's ``model_name`` weights into
    ``model`` in place (reference ``load_ckpt``); parameter
    ``xyz_layers.0.w`` reads key ``xyz_layers/0/w``."""
    if loaded is None:
        loaded = extract_model_state_dict(ckpt_path, model_name,
                                          prefixes_to_ignore)
    with torch.no_grad():
        for name, p in model.named_parameters():
            key = name.replace(".", "/")
            if key not in loaded:
                continue
            new = torch.from_numpy(np.array(loaded[key], np.float32))
            if tuple(new.shape) != tuple(p.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(new.shape)}"
                                 f" != model shape {tuple(p.shape)}")
            p.copy_(new)
    return model
