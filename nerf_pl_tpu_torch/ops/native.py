"""Build the CUDA sources in ``nerf_pl_tpu_torch/csrc`` and load them.

Each library in ``LIBRARIES`` is one ``csrc/<source>.cu`` compiled by
``nvcc`` on its own, with the library's defines, into a shared library with
a plain C interface, loaded with ``ctypes``.  The fused MLP's three sources
build twice each: their float32 and bfloat16 kernels in one library, their
float16 kernels in another (``NERF_DTYPES``, a bitmask of the weight types'
codes, ``csrc/fused_mlp_common.cuh``), so that the three types compile in
parallel.  The library is built at first use into
``build/nerf_pl_tpu_torch/`` at the root of the checkout, under a name that
carries a hash of the source, headers, flags and defines, so an edited
source rebuilds and an unchanged one loads at once.  ``build`` starts one
``nvcc`` per library, all together.

A build failure raises; nothing falls back to the plain PyTorch versions.
No ``--use_fast_math``: it turns ``sinf`` into ``__sinf``, which is wrong at
the positional-encoding arguments (up to 2^9 * |x|, about 10^3 rad).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_pl_tpu_torch"
SOURCES = ("fused_mlp", "fused_mlp_bwd", "fused_mlp_wide", "searchsorted",
           "chain_probe")
# library name -> (source, defines); a fused MLP library of float16 kernels
# is its source's name with F16_SUFFIX (``library``)
F16_SUFFIX = "_f16"
FUSED = ("fused_mlp", "fused_mlp_bwd", "fused_mlp_wide")
LIBRARIES = {name: (name, ("-DNERF_DTYPES=3",) if name in FUSED else ())
             for name in SOURCES}
LIBRARIES.update({name + F16_SUFFIX: (name, ("-DNERF_DTYPES=4",))
                  for name in FUSED})
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library(source: str, float16: bool = False) -> str:
    """The library of ``source``'s kernels: its float16 one if asked."""
    return source + F16_SUFFIX if float16 else source


def library_path(name: str) -> Path:
    source, defines = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    h.update((CSRC / f"{source}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared device code
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(LIBRARIES)) -> dict:
    """Compile every missing library in ``names`` in parallel.

    Returns ``{name: seconds}`` (0.0 for a library already built); the
    ``-Xptxas=-v`` report of each build is kept beside the library as
    ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        source, defines = LIBRARIES[name]
        cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(CSRC / f"{source}.cu")]
        jobs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} "
                          f"({LIBRARIES[name][0]}.cu):\n{log}")
            continue
        out.with_suffix(".so.log").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (of ``LIBRARIES``), built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
