"""The index maps of the float32 fused-MLP kernels (``csrc/fused_mlp_common.cuh``
``dense_acc`` / ``dense``, ``csrc/fused_mlp_bwd.cu`` ``bwd_epilogue`` and
``fused_nerf_wgrad_kernel``), checked on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against the
plain versions and pins their f32 bits by digest).  What can be held here is
the arithmetic of their indices, read from the source and evaluated over
every thread: every output of a weight-grad tile owned by exactly one thread
and accumulated from its own row and column, every 16-byte vector of a slab
staged exactly once, and
the activation rows' pad spreading a quarter-warp's column stores over more
of shared memory's 16-byte bank groups than the unpadded rows do.
"""
import re
from pathlib import Path

import numpy as np
import pytest

CSRC = Path(__file__).resolve().parent.parent / "nerf_pl_tpu_torch" / "csrc"
COMMON = (CSRC / "fused_mlp_common.cuh").read_text()
BWD = (CSRC / "fused_mlp_bwd.cu").read_text()


def _wgrad_tile() -> tuple:
    m = re.search(r"constexpr int WK = (\d+), WN = (\d+), WP = (\d+), "
                  r"WSTAGES_F32 = (\d+);", BWD)
    assert m, "the f32 wgrad tile's constants"
    return tuple(int(v) for v in m.groups())


def _pad() -> int:
    m = re.search(r"static constexpr int LDA_F32 = TP \+ (\d+);", COMMON)
    assert m, "the f32 activation rows' pad"
    return int(m.group(1))


def _kernel(name: str) -> str:
    """The body of the ``__global__`` function ``name`` in the backward."""
    start = BWD.index(f"\n{name}(")
    return BWD[start:BWD.index("\n}\n", start)]


def _c_int(body: str, pattern: str):
    """The C integer expression that ``pattern``'s group 1 matches in
    ``body``, as a function of its free names: the kernel's own index
    arithmetic, evaluated in Python (every operand is non-negative, so C's
    ``/`` is Python's ``//``)."""
    m = re.search(pattern, body)
    assert m, pattern
    code = compile(m.group(1).replace("/", "//"), pattern, "eval")
    return lambda **names: eval(code, {"__builtins__": {}}, names)


def _wgrad_maps() -> dict:
    """The f32 weight-grad kernel's thread maps, read from its source: the
    thread's tile coordinates, the row and column of accumulator (u, v) as
    stored, the rows and columns its products read, and its staging
    copies."""
    WK, WN, WP, _ = _wgrad_tile()
    body = _kernel("fused_nerf_wgrad_kernel")
    sizes = dict(WK=WK, WN=WN, WP=WP)
    return dict(
        tk=_c_int(body, r"const int tk = ([^,;]+),"),
        tn=_c_int(body, r"const int tk = [^,;]+, tn = ([^;]+);"),
        k=_c_int(body, r"const int k = k0 \+ ([^;]+);"),
        n=_c_int(body, r"const int n = n0 \+ ([^;]+);"),
        a_col=_c_int(body, r"load4\(&As\[b\]\[pp\]\[([^\]]+)\], a\[h\]\)"),
        g_col=_c_int(body, r"load4\(&Gs\[b\]\[pp\]\[([^\]]+)\], g\[h\]\)"),
        a_term=_c_int(body, r"fmaf\(a\[([^\]]+)\]"),
        a_elem=_c_int(body, r"fmaf\(a\[[^\]]+\]\[([^\]]+)\]"),
        g_term=_c_int(body, r"fmaf\(a\[[^,]+, g\[([^\]]+)\]"),
        g_elem=_c_int(body, r"fmaf\(a\[[^,]+, g\[[^\]]+\]\[([^\]]+)\]"),
        copies=_c_int(body, r"for \(int r = 0; r < ([^;]+);")(**sizes),
        col=lambda tid: _c_int(body, r"const int c = ([^,;]+),")(tid=tid,
                                                                 **sizes),
        pp0=lambda tid: _c_int(body, r"const int c = [^,;]+, pp0 = ([^;]+);")(
            tid=tid, **sizes),
        pp=_c_int(body, r"const int pp = ([^;]+);"),
        sizes=sizes)


def test_f32_wgrad_threads_own_each_output_once():
    """Each output of the WK x WN tile is stored by exactly one of the 256
    threads, and the products it accumulates read that output's row of
    a_in and column of g_pre: the kernel's own expressions for the
    thread's coordinates, the stored (k, n) of accumulator (u, v), the
    shared-memory columns its products load and the terms ``fmaf`` takes."""
    m = _wgrad_maps()
    WK, WN = m["sizes"]["WK"], m["sizes"]["WN"]
    owner = np.full((WK, WN), -1)
    for t in range(256):
        tk, tn = m["tk"](tid=t), m["tn"](tid=t)
        for u in range(8):
            k = m["k"](u=u, tk=tk)
            read_k = m["a_col"](h=m["a_term"](u=u), tk=tk) + m["a_elem"](u=u)
            assert read_k == k, (t, u)
            for v in range(8):
                n = m["n"](v=v, tn=tn)
                read_n = (m["g_col"](h=m["g_term"](v=v), tn=tn)
                          + m["g_elem"](v=v))
                assert read_n == n, (t, v)
                assert owner[k, n] == -1, (k, n)
                owner[k, n] = t
    assert (owner >= 0).all()


def test_f32_wgrad_stage_copies_each_vector_once():
    """A slab's WP x WK floats of a_in and WP x WN of g_pre go as 16-byte
    vectors, by the kernel's own expressions for a thread's column, first
    point and copies: every vector of both staged exactly once."""
    m = _wgrad_maps()
    WK, WN, WP = (m["sizes"][k] for k in ("WK", "WN", "WP"))
    assert WK == WN  # one column of vectors a thread in both operands
    seen = np.zeros((WP, WK), int)
    for t in range(256):
        c, pp0 = m["col"](t), m["pp0"](t)
        for r in range(m["copies"]):
            pp = m["pp"](pp0=pp0, r=r, **m["sizes"])
            seen[pp, c:c + 4] += 1
    assert (seen == 1).all()


def _store_wavefronts(pitch: int, cpl: int, tp: int) -> int:
    """Wavefronts of one 16-byte store down an output column: lane l of a
    quarter-warp writes 4 points of column cpl * l (rows ``pitch`` floats
    apart) at point 8 w; each quarter-warp takes as many wavefronts as the
    most lanes that share one of shared memory's eight 16-byte groups."""
    worst = 0
    for w in range(8):
        for q in range(4):
            groups = [((cpl * l) * pitch + w * (tp // 8)) // 4 % 8
                      for l in range(8 * q, 8 * q + 8)]
            worst = max(worst, max(np.bincount(groups, minlength=8)))
    return 4 * worst


@pytest.mark.parametrize("cpl", [4, 2])
@pytest.mark.parametrize("tp", [64, 32])
def test_f32_pad_spreads_the_column_stores(cpl, tp):
    pad = _pad()
    assert (tp + pad) % 4 == 0, "a padded row stays 16-byte aligned"
    unpadded = _store_wavefronts(tp, cpl, tp)
    padded = _store_wavefronts(tp + pad, cpl, tp)
    assert unpadded == 32  # eight lanes on one group, four quarter-warps
    assert padded <= unpadded // 2
