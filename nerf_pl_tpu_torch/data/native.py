"""ctypes bindings for the native C++ ray store (``csrc/raystore.cpp``, the
port's own copy of the JAX package's ``native/raystore.cpp``;
``nerf_pl_tpu/data/native.py``) — the host data engine behind the trainer's
streaming mode (``--data_device_resident false``; the reference's
DataLoader worker pool, ``train.py:89-94``, as one native library).

The library is built at first use from the package's ``csrc/raystore.cpp``
with ``g++ -O3 -std=c++17 -fPIC -Wall -pthread -shared`` into
``build/nerf_pl_tpu_torch/`` under a name that carries a hash of the source
and flags, so an edited source rebuilds; processes that start together
(pytest-xdist workers) build it once, behind a file lock.  A build or load
failure raises, naming the source; the numpy store (``force_fallback=True``,
the JAX package's fallback and epoch permutation) is used only when asked
for.  ``build(source)`` builds the port's other host libraries, the image
readers' ``csrc/*.cpp``, the same way; ``extra`` flags (the JPEG 2000
decoder's ``-ffp-contract=off``) join the command and the hash.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "raystore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_pl_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None


def library_path(source: Path = SOURCE, extra: Sequence[str] = ()) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(extra)).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, extra: Sequence[str] = ()) -> Path:
    """Compile ``source`` if its library is missing; returns its path."""
    out = library_path(source, extra)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"g++ not found: {source} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, *extra, "-o", str(tmp),
                               str(source)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building {source} failed:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        fp = ctypes.POINTER(ctypes.c_float)
        lib.raystore_create.restype = vp
        lib.raystore_create.argtypes = [ctypes.POINTER(vp),
                                        ctypes.POINTER(i64), i64, i64,
                                        ctypes.c_uint64]
        lib.raystore_destroy.argtypes = [vp]
        lib.raystore_rows.restype = i64
        lib.raystore_rows.argtypes = [vp]
        lib.raystore_row_width.restype = i64
        lib.raystore_row_width.argtypes = [vp]
        lib.raystore_fill_batch.restype = i64
        lib.raystore_fill_batch.argtypes = [vp, i64, i64, i64, fp, ctypes.c_int]
        lib.raystore_fill_sequential.restype = i64
        lib.raystore_fill_sequential.argtypes = [vp, i64, i64, fp, ctypes.c_int]
        lib.raystore_epoch_perm.argtypes = [vp, i64,
                                            ctypes.POINTER(ctypes.c_uint32)]
        _lib = lib
        return lib


class RayStore:
    """Interleaved row store with background-prefetched epoch shuffles.

    ``columns``: list of (N, Ci) float32 arrays (e.g. rays, rgbs).
    ``fill_batch(epoch, step, batch)`` returns a (batch, sum(Ci)) array of
    the epoch permutation's rows ``[step*batch, (step+1)*batch)``; ``split``
    slices it back into the columns.  ``out``, where given, is a
    (batch, sum(Ci)) float32 array to fill (a pinned buffer, say)."""

    def __init__(self, columns: Sequence[np.ndarray], seed: int = 0,
                 threads: int = 4, force_fallback: bool = False):
        self.widths = [int(c.shape[1]) for c in columns]
        self.n_rows = int(columns[0].shape[0])
        self.row_width = sum(self.widths)
        self.threads = threads
        self._handle = None
        cols = [np.ascontiguousarray(c, dtype=np.float32) for c in columns]
        if force_fallback:
            self._data = np.concatenate(cols, axis=1)
            self._seed = seed
            self._perm_epoch = -1
            self._perm = None
            return
        lib = _load_lib()
        ptrs = (ctypes.c_void_p * len(cols))(
            *[c.ctypes.data_as(ctypes.c_void_p).value for c in cols])
        widths = (ctypes.c_int64 * len(cols))(*self.widths)
        self._lib = lib
        self._handle = lib.raystore_create(ptrs, widths, len(cols),
                                           self.n_rows, seed)
        if not self._handle:
            raise RuntimeError("raystore_create failed")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.raystore_destroy(self._handle)
            self._handle = None

    @property
    def native(self) -> bool:
        return self._handle is not None

    def _fallback_perm(self, epoch: int):
        if self._perm_epoch != epoch:
            rng = np.random.RandomState((self._seed * 7919 + epoch) % 2**31)
            self._perm = rng.permutation(self.n_rows)
            self._perm_epoch = epoch
        return self._perm

    def _out(self, batch: int, out: Optional[np.ndarray]) -> np.ndarray:
        if out is None:
            return np.empty((batch, self.row_width), np.float32)
        if (out.dtype != np.float32 or out.shape != (batch, self.row_width)
                or not out.flags.c_contiguous):
            raise ValueError(f"out must be a C-contiguous float32 array of "
                             f"shape {(batch, self.row_width)}")
        return out

    def fill_batch(self, epoch: int, step: int, batch: int,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        out = self._out(batch, out)
        if self._handle:
            n = self._lib.raystore_fill_batch(
                self._handle, epoch, step, batch,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.threads)
        else:
            perm = self._fallback_perm(epoch)
            lo = step * batch
            idx = perm[lo:lo + batch]
            n = len(idx)
            out[:n] = self._data[idx]
        return out[:n]

    def fill_sequential(self, start: int, batch: int,
                        out: Optional[np.ndarray] = None) -> np.ndarray:
        out = self._out(batch, out)
        if self._handle:
            n = self._lib.raystore_fill_sequential(
                self._handle, start, batch,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.threads)
        else:
            # clamp like the native path: start past the end returns empty
            n = max(0, min(batch, self.n_rows - start))
            out[:n] = self._data[start:start + n]
        return out[:n]

    def epoch_perm(self, epoch: int) -> np.ndarray:
        if self._handle:
            out = np.empty(self.n_rows, np.uint32)
            self._lib.raystore_epoch_perm(
                self._handle, epoch,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
            return out
        return self._fallback_perm(epoch).astype(np.uint32)

    def split(self, rows) -> List:
        out, off = [], 0
        for w in self.widths:
            out.append(rows[:, off:off + w])
            off += w
        return out
