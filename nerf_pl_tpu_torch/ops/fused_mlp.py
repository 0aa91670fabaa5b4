"""The fused NeRF MLP with in-kernel positional encoding, with its backward
(``nerf_pl_tpu/ops/fused_mlp.py::fused_nerf_apply_raw_t`` and
``fused_nerf_apply_raw``), and on pre-embedded rows at any width that the
wide kernel takes (``fused_nerf_apply``).

``fused_nerf_apply_raw_t(model, x_rawT)`` takes ``(8, P)`` float32 rows
``[xyz(3) | dir(3) | 0 0]`` and returns ``(8, P)`` float32: rows
``[rgb(3) | sigma | 0 x 4]``, or sigma in row 0 and zeros below when
``sigma_only``.  ``fused_nerf_apply_raw(model, xyz, dirs)`` takes the same
data row-major, ``(P, 8)`` at the kernels, and returns ``(P, 4)`` ``[rgb,
sigma]`` or ``(P, 1)``.  The positional encoding (10 xyz / 4 dir
frequencies) runs inside the kernels.

Kernels (``csrc/fused_mlp.cu``, ``csrc/fused_mlp_bwd.cu``), each on the
channel-major layout and, primed, on the row-major one (a compile-time
layout flag on the same code, so both give the same bits):
  * C, C' — the forward;
  * D, D' — the forward that also writes the activation stash ``(P, 2432)``
    (sigma-only ``(P, 2048)``) in the compute dtype: h1..h8, fin, d;
  * E, E' — the backward that reads D's stash;
  * F, F' — the backward that recomputes the forward instead;
  * G — the forward on pre-embedded rows ``(P, 63)`` or ``(P, 90)`` at
    W = 128..640 (``csrc/fused_mlp_wide.cu``), behind ``fused_nerf_apply``;
  * H — F on pre-embedded rows, which also returns dx (W = 256 only, as
    JAX's ``_bwd_core``), the backward of ``fused_nerf_apply``.
With grad enabled and trainable parameters, the call is a
``torch.autograd.Function`` whose forward is D and backward E, or C and F
past ``STASH_MAX_POINTS`` points or with ``stash_blocks=None``
(``_auto_stash_blocks``, fused_mlp.py:1267-1272).  Weight grads are rounded
to the compute dtype and bias grads are not, as ``_fused_raw_t_bwd_rule``
casts each packed grad to its packed dtype.  The raw kernels' input gets
no gradient (rays are data); ``fused_nerf_apply``'s does, as in JAX.

Dispatch follows the input's device: a CUDA tensor launches the kernels or
raises, a CPU tensor runs their plain PyTorch versions, which repeat the
kernels' rounding step by step (``_bwd_core``, fused_mlp.py:209-289).  The
compute dtype is float32, bfloat16 or float16, as in JAX; in the two 16-bit
types every product of the forward and backward (C-H) runs on the tensor
cores, in float32 on the scalar path; the weight-grad products are a job
table built here (``wgrad_jobs``).
"""
from __future__ import annotations

import ctypes

import torch

from ..models.embedding import posenc
from ..models.nerf import NeRF
from . import native

# the reference architecture the kernels are written for (models/nerf.py)
D, W, CX, CD, WH, SKIP = 8, 256, 63, 27, 128, 4
XYZ_FREQS, DIR_FREQS = 10, 4
RAW_COLS = OUT_COLS = 8
# activation stash columns (fused_mlp.py:699-700): h1..h8, then fin and d
STASH_FIN, STASH_D = D * W, D * W + W
STASH_COLS_RGB, STASH_COLS_SIGMA = STASH_D + WH, D * W
# past this point count "auto" takes the remat backward (fused_mlp.py:1264).
# The number was chosen on the TPU for a 16 GB chip; the TPU's stash and
# backward block sizes mean nothing to the CUDA kernels.
STASH_MAX_POINTS = 2_000_000
# the backward's point chunk and the split of its weight-grad sums
BWD_CHUNK, BWD_SPLIT = 262_144, 32
# The backward's G buffer (csrc/fused_mlp_bwd.cu): one row of G_COLS values
# of the compute dtype a point of the chunk, each rounded g_pre (layer i's at
# column i * W, i < D; then the heads') and the two embeddings, the operands
# of the weight grads.  Columns past a block's live ones are never written.
G_FIN = D * W              # g_fin (256)
G_DPRE = G_FIN + W         # g_dpre (128)
G_RGB = G_DPRE + WH        # g_rgbpre (3)
G_SIG = G_RGB + 8          # g_sigma (1)
G_XE = G_SIG + 8           # x_emb (63)
G_DE = G_XE + 64           # dir_emb (27)
G_COLS = G_DE + 32         # 2544
G_LAYOUT = (G_FIN, G_DPRE, G_RGB, G_SIG, G_XE, G_DE, G_COLS)
# a weight-grad job: dW[out : out + K * N] (row-major K x N, the packed
# layer's rows) = a_in[:, a_col : a_col + K]^T @ G[:, g_col : g_col + N]
# summed over the points, a_in the stash (a_in_g = 0) or the G buffer (1),
# by the kernel of its route: the scalar tiles, the tensor cores, or the
# narrow heads' kernel (16-bit only, N <= 4)
WGRAD_JOB_FIELDS = ("a_in_g", "a_col", "K", "g_col", "N", "out", "route")
ROUTE_SCALAR, ROUTE_TC, ROUTE_NARROW = 0, 1, 2
# the compute dtypes the kernels take, by their code at the C interface
# (csrc/fused_mlp_common.cuh DType); the 16-bit ones run the tensor cores
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)


def supports_fused(model) -> bool:
    """The kernels are specialised to the reference architecture."""
    if not isinstance(model, NeRF):
        return False
    layers = model.xyz_layers
    return (
        len(layers) == D
        and tuple(layers[0].w.shape) == (CX, W)
        and tuple(layers[SKIP].w.shape) == (W + CX, W)
        and all(tuple(layers[i].w.shape) == (W, W)
                for i in range(1, D) if i != SKIP)
        and tuple(model.dir_layer.w.shape) == (W + CD, WH)
    )


def dense_layers(model: NeRF) -> list:
    """The packing order: W_0..W_7, sigma, xyz_final, dir_layer, rgb."""
    return list(model.xyz_layers) + [model.sigma, model.xyz_final,
                                     model.dir_layer, model.rgb]


def stash_cols(sigma_only: bool) -> int:
    return STASH_COLS_SIGMA if sigma_only else STASH_COLS_RGB


def block_offsets() -> list:
    """Offsets of each dense layer's weight block in ``pack_weights``' buffer
    at the reference architecture, in ``dense_layers`` order."""
    sizes = [CX * W] + [(W + CX) * W if i == SKIP else W * W
                        for i in range(1, D)]
    sizes += [W, W * W, (W + CD) * WH, WH * 3]  # sigma, fin, dir, rgb
    return [sum(sizes[:i]) for i in range(len(sizes))]


def wgrad_jobs(sigma_only: bool, compute_dtype) -> list:
    """The backward's weight-grad products, the job table of the wgrad
    kernels: one tuple of ``WGRAD_JOB_FIELDS`` for each ``wgrad`` call of
    ``_bwd_core`` (the skip layer and the dir head as two jobs each, for
    their rows from the embedding and from h).  In bf16 and fp16 every
    product with 128 or more output columns runs on the tensor cores and the
    sigma and rgb heads (1 and 3 columns) on the narrow kernel; in f32 every
    product runs the scalar kernel."""
    off = block_offsets()
    tc = compute_dtype in TENSOR_CORE_DTYPES
    jobs = []

    def add(a_in_g, a_col, k, g_col, n, out):
        route = (ROUTE_SCALAR if not tc else
                 ROUTE_TC if n >= 128 else ROUTE_NARROW)
        jobs.append((a_in_g, a_col, k, g_col, n, out, route))

    add(1, G_XE, CX, 0, W, off[0])
    for i in range(1, D):  # layer i reads h_i, stash column (i - 1) * W
        if i == SKIP:
            add(1, G_XE, CX, i * W, W, off[i])  # the rows of x_emb
            add(0, (i - 1) * W, W, i * W, W, off[i] + CX * W)
        else:
            add(0, (i - 1) * W, W, i * W, W, off[i])
    add(0, (D - 1) * W, W, G_SIG, 1, off[D])
    if not sigma_only:
        add(0, (D - 1) * W, W, G_FIN, W, off[D + 1])
        add(0, STASH_FIN, W, G_DPRE, WH, off[D + 2])  # the rows of fin
        add(1, G_DE, CD, G_DPRE, WH, off[D + 2] + W * WH)  # of dir_emb
        add(0, STASH_D, WH, G_RGB, 3, off[D + 3])
    return jobs


# the wide forward's weight budget (fused_mlp.py:441-452): the TPU kernel
# keeps every weight resident in VMEM, packed at 128-lane input tiles
CIN = 128
_WIDE_WEIGHT_BUDGET = 9 << 20


def _packed_weight_bytes(w: int, itemsize: int = 2) -> int:
    wh = w // 2
    rows = CIN * w + (D - 2) * w * w + (CIN + w) * w  # trunk incl. skip
    rows += w * CIN + w * w + (w + CIN) * wh + wh * CIN  # heads
    return rows * itemsize


def supports_fused_wide(model, compute_dtype=torch.bfloat16) -> bool:
    """The models that JAX's wide fused forward takes (``supports_fused_wide``,
    fused_mlp.py:455-481): the reference topology at a width W != 256 that is
    a multiple of 128, whose weights packed in ``compute_dtype`` fit the TPU
    kernel's budget (W <= 640 in bf16 and fp16, W <= 384 in f32).  The
    budget is the TPU's VMEM; it is kept so the port takes the wide kernel
    exactly where JAX does, and kernel G is built for just those widths."""
    if not isinstance(model, NeRF):
        return False
    layers = model.xyz_layers
    w_ = int(layers[0].w.shape[1])
    itemsize = torch.empty((), dtype=compute_dtype).element_size()
    return (
        len(layers) == D
        and w_ % 128 == 0
        and w_ != W
        and tuple(layers[0].w.shape) == (CX, w_)
        and tuple(layers[SKIP].w.shape) == (w_ + CX, w_)
        and tuple(model.dir_layer.w.shape) == (w_ + CD, w_ // 2)
        and _packed_weight_bytes(w_, itemsize) <= _WIDE_WEIGHT_BUDGET
    )


def supports_fused_apply(model, compute_dtype=torch.bfloat16) -> bool:
    """The models that ``fused_nerf_apply`` (kernel G) takes: the reference
    architecture, or a wide one that ``supports_fused_wide`` admits."""
    return supports_fused(model) or supports_fused_wide(model, compute_dtype)


# ------------------------------------------------------------ plain versions
def _raw_embed(x_rawT: torch.Tensor, sigma_only: bool) -> tuple:
    """The in-kernel positional encoding of (8, P) raw rows: ``(xyz_emb,
    dir_emb or None)``."""
    xe = posenc(x_rawT[0:3].T.float(), XYZ_FREQS)
    return xe, None if sigma_only else posenc(x_rawT[3:6].T.float(),
                                              DIR_FREQS)


def _split_embedded(x: torch.Tensor, sigma_only: bool) -> tuple:
    """Pre-embedded rows ``(P, 63)`` or ``(P, 90)`` -> ``(xyz_emb, dir_emb
    or None)``; 63-column rows in rgb mode get a zero dir_emb, as JAX pads x
    with zero columns."""
    x = x.float()
    if sigma_only:
        return x[:, :CX], None
    if x.shape[1] >= CX + CD:
        return x[:, :CX], x[:, CX:CX + CD]
    return x[:, :CX], x.new_zeros((x.shape[0], CD))


def _forward_plain(model: NeRF, xe: torch.Tensor, de, sigma_only: bool,
                   compute_dtype, keep_acts: bool = True) -> dict:
    """``_fwd_body`` (fused_mlp.py:155-181) on the embedded input ``xe``
    (and ``de`` unless sigma-only), at the model's width: each layer's input
    and weight rounded to ``compute_dtype``, f32 products and sums, f32
    bias, ReLU and sigmoid.  Activations are returned in f32 (the trunk's
    only with ``keep_acts``)."""
    h, acts = xe, [xe]
    for i, layer in enumerate(model.xyz_layers):
        if i == SKIP:
            h = torch.cat([xe, h], dim=-1)
        h = torch.relu(layer(h, compute_dtype))
        if keep_acts:
            acts.append(h)
    res = {"xe": xe, "acts": acts, "sigma": model.sigma(h, compute_dtype)[:, 0]}
    if not sigma_only:
        fin = model.xyz_final(h, compute_dtype)
        d = torch.relu(model.dir_layer(torch.cat([fin, de], -1), compute_dtype))
        res.update(de=de, fin=fin, d=d,
                   rgb=torch.sigmoid(model.rgb(d, compute_dtype)))
    return res


def _out_rows(f: dict, sigma_only: bool) -> torch.Tensor:
    sigma = f["sigma"]
    res = torch.zeros((OUT_COLS, sigma.shape[0]), dtype=torch.float32,
                      device=sigma.device)
    if sigma_only:
        res[0] = sigma
    else:
        res[:3] = f["rgb"].T
        res[3] = sigma
    return res


def fused_nerf_apply_raw_t_plain(model: NeRF, x_rawT: torch.Tensor,
                                 sigma_only: bool = False,
                                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of kernel C on any device."""
    with torch.no_grad():
        return _out_rows(_forward_plain(model, *_raw_embed(x_rawT, sigma_only),
                                        sigma_only, compute_dtype,
                                        keep_acts=False),
                         sigma_only)


def fused_nerf_stash_fwd_plain(model: NeRF, x_rawT: torch.Tensor,
                               sigma_only: bool = False,
                               compute_dtype=torch.bfloat16):
    """Plain PyTorch version of kernel D: ``(out (8, P), stash (P, SC))``,
    the stash holding each activation rounded to ``compute_dtype``."""
    with torch.no_grad():
        f = _forward_plain(model, *_raw_embed(x_rawT, sigma_only), sigma_only,
                           compute_dtype)
        pieces = f["acts"][1:] + ([] if sigma_only else [f["fin"], f["d"]])
        stash = torch.cat([a.to(compute_dtype) for a in pieces], dim=1)
        return _out_rows(f, sigma_only), stash


def fused_nerf_apply_raw_plain(model: NeRF, x_raw: torch.Tensor,
                               sigma_only: bool = False,
                               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of kernel C': C's on the transposed rows
    (made contiguous, so the sums run in C's order)."""
    return fused_nerf_apply_raw_t_plain(model, x_raw.T.contiguous(),
                                        sigma_only,
                                        compute_dtype).T.contiguous()


def fused_nerf_raw_stash_fwd_plain(model: NeRF, x_raw: torch.Tensor,
                                   sigma_only: bool = False,
                                   compute_dtype=torch.bfloat16):
    """Plain PyTorch version of kernel D': ``(out (P, 8), stash (P, SC))``."""
    out, stash = fused_nerf_stash_fwd_plain(model, x_raw.T.contiguous(),
                                            sigma_only, compute_dtype)
    return out.T.contiguous(), stash


def fused_nerf_raw_bwd_plain(model: NeRF, x_raw: torch.Tensor,
                             g: torch.Tensor, sigma_only: bool = False,
                             compute_dtype=torch.bfloat16, stash=None):
    """Plain PyTorch version of kernels E' (with ``stash``) and F'
    (without), on ``(P, 8)`` x and g: E's and F's on the transposes."""
    return fused_nerf_bwd_plain(model, x_raw.T.contiguous(),
                                g.T.contiguous(), sigma_only, compute_dtype,
                                stash)


def fused_nerf_bwd_plain(model: NeRF, x_rawT: torch.Tensor, g: torch.Tensor,
                         sigma_only: bool = False,
                         compute_dtype=torch.bfloat16, stash=None):
    """Plain PyTorch version of kernels E (with ``stash``) and F (without):
    the packed f32 weight and bias grads ``(dw, db)`` for the cotangent
    ``g (8, P)``, step for step as ``_bwd_core``.  E reads the activations,
    fin and d from the stash and recomputes rgb from the stashed d; F
    recomputes the forward in f32 (the wgrad operands round either way)."""
    with torch.no_grad():
        dw, db, _ = _bwd_plain(model, *_raw_embed(x_rawT, sigma_only), g,
                               sigma_only, compute_dtype, stash)
        return dw, db


def fused_nerf_apply_plain(model: NeRF, x: torch.Tensor,
                           sigma_only: bool = False,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of kernel G on any device: pre-embedded rows
    ``x (P, 63)`` or ``(P, 90)`` -> ``(P, 8)`` float32 ``[rgb | sigma | 0]``
    (sigma-only: sigma in column 0), at the model's width."""
    with torch.no_grad():
        return _out_rows(_forward_plain(model, *_split_embedded(x, sigma_only),
                                        sigma_only, compute_dtype,
                                        keep_acts=False), sigma_only).T \
            .contiguous()


def fused_nerf_bwd_dx_plain(model: NeRF, x: torch.Tensor, g: torch.Tensor,
                            sigma_only: bool = False,
                            compute_dtype=torch.bfloat16):
    """Plain PyTorch version of kernel H: ``(dx, dw, db)`` for pre-embedded
    rows ``x (P, C)`` and the cotangent ``g (P, 8)`` of G's output, step for
    step as ``_bwd_core`` with ``want_dx``: dx ``(P, C)`` f32 holds
    ``round(g_pre_4) @ W_4[:63]^T + round(g_pre_0) @ W_0^T`` in its xyz
    columns and, in rgb mode, ``round(g_dpre) @ Wdir[W:]^T`` in its dir
    columns; dw, db the packed f32 grads as ``fused_nerf_bwd_plain``."""
    with torch.no_grad():
        xe, de = _split_embedded(x, sigma_only)
        dw, db, parts = _bwd_plain(model, xe, de, g.float().T, sigma_only,
                                   compute_dtype, None, want_dx=True)
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx[:, :CX] = parts["skip"] + parts["l0"]
        if not sigma_only and x.shape[1] >= CX + CD:
            dx[:, CX:CX + CD] = parts["dir"]
        return dx, dw, db


def _relu_mask(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``g`` where the ReLU output ``h`` is positive, else 0: a select, as
    XLA compiles ``_bwd_core``'s ``g * (h > 0)`` (it rewrites a product by
    a converted predicate into a select) and as the kernels form it, so a
    NaN or Inf ``g`` under a zero mask gives 0, not NaN."""
    return torch.where(h > 0, g, torch.zeros((), dtype=g.dtype,
                                             device=g.device))


def _bwd_plain(model, xe, de, g, sigma_only, cdt, stash, want_dx=False,
               gbuf=None):
    """``_bwd_core`` on the embedded input and the cotangent ``g (8, P)``:
    ``(dw, db, dx parts)``, the parts (``want_dx``) the three products that
    reach the input, by name.  With ``gbuf`` (a ``(P, G_COLS)`` f32
    tensor), also what the kernels write to their G buffer, each value
    rounded to the compute dtype; the columns they never write are left as
    they are."""
    def r(t):  # an operand rounded to the compute dtype, held in f32
        return t.to(cdt).float()

    def keep(col, t):
        if gbuf is not None:
            gbuf[:, col:col + t.shape[1]] = r(t)

    def wgrad(a, gp):
        return r(a).T @ r(gp)

    dense = dense_layers(model)
    f = _forward_plain(model, xe, de, sigma_only, cdt)
    parts = {}
    if stash is None:
        act = f["acts"].__getitem__
        fin, d, rgb = f.get("fin"), f.get("d"), f.get("rgb")
    else:
        s = stash.float()

        def act(i):
            return xe if i == 0 else s[:, (i - 1) * W:i * W]

        if not sigma_only:
            fin, d = s[:, STASH_FIN:STASH_D], s[:, STASH_D:STASH_COLS_RGB]
            rgb = torch.sigmoid(model.rgb(d, cdt))
    gw = [torch.zeros_like(m.w, dtype=torch.float32) for m in dense]
    gb = [torch.zeros_like(m.b, dtype=torch.float32) for m in dense]
    g = g.float()
    h8 = act(D)
    sig, fin_l, dir_l, rgb_l = dense[D:]
    keep(G_XE, xe)
    if sigma_only:
        g_sigma = g[0][:, None]
        g_h = r(g_sigma) @ r(sig.w).T
    else:
        g_sigma = g[3][:, None]
        g_rgbpre = g[:3].T * rgb * (1.0 - rgb)
        gw[D + 3], gb[D + 3] = wgrad(d, g_rgbpre), g_rgbpre.sum(0)
        g_dpre = _relu_mask(r(g_rgbpre) @ r(rgb_l.w).T, d)
        din = torch.cat([fin, f["de"]], dim=1)
        gw[D + 2], gb[D + 2] = wgrad(din, g_dpre), g_dpre.sum(0)
        g_din = r(g_dpre) @ r(dir_l.w).T
        g_fin, parts["dir"] = g_din[:, :W], g_din[:, W:]
        gw[D + 1], gb[D + 1] = wgrad(h8, g_fin), g_fin.sum(0)
        g_h = r(g_fin) @ r(fin_l.w).T + r(g_sigma) @ r(sig.w).T
        for col, t in ((G_DE, f["de"]), (G_RGB, g_rgbpre), (G_DPRE, g_dpre),
                       (G_FIN, g_fin)):
            keep(col, t)
    keep(G_SIG, g_sigma)
    gw[D], gb[D] = wgrad(h8, g_sigma), g_sigma.sum(0)
    for i in range(D - 1, -1, -1):
        g_pre = _relu_mask(g_h, act(i + 1))
        keep(i * W, g_pre)
        a_in = torch.cat([xe, act(i)], dim=1) if i == SKIP else act(i)
        gw[i], gb[i] = wgrad(a_in, g_pre), g_pre.sum(0)
        if i > 0 or want_dx:
            g_in = r(g_pre) @ r(dense[i].w).T
            if i == SKIP:
                parts["skip"], g_h = g_in[:, :CX], g_in[:, CX:]
            elif i == 0:
                parts["l0"] = g_in
            else:
                g_h = g_in
    return (torch.cat([t.reshape(-1) for t in gw]),
            torch.cat([t.reshape(-1) for t in gb]), parts)


# ------------------------------------------------------------------ packing
def _param_key(model, compute_dtype):
    return (compute_dtype,
            tuple((p.data_ptr(), p._version) for p in model.parameters()))


def _cached(model, attr, compute_dtype, build):
    key = _param_key(model, compute_dtype)
    cached = getattr(model, attr, None)
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        packed = build()
    setattr(model, attr, (key, packed))
    return packed


def pack_weights(model: NeRF, compute_dtype):
    """Kernel operands: all weights as one ``compute_dtype`` buffer in the
    order W_0..W_7, Wsig, Wfin, Wdir, Wrgb (each ``(fan_in, fan_out)``
    row-major, unpadded, at the model's width), all biases as one f32 buffer
    in the same order.  Cached on the module until a parameter is replaced
    or changed in place."""
    def build():
        dense = dense_layers(model)
        wbuf = torch.cat([m.w.reshape(-1) for m in dense]).to(compute_dtype)
        bbuf = torch.cat([m.b.reshape(-1) for m in dense]).float()
        return wbuf.contiguous(), bbuf.contiguous()

    return _cached(model, "_fused_pack", compute_dtype, build)


def pack_weights_t(model: NeRF, compute_dtype) -> torch.Tensor:
    """The f32 backward's dgrad operands (its scalar sweep streams the
    transposes; the 16-bit sweep reads ``pack_weights`` as it is, the .col B
    operand of its tensor-core products) in ``compute_dtype``: the h rows of
    W_1..W_7 transposed (256 x 256 each), Wfin transposed, and the fin rows
    of Wdir transposed (128 x 256).  Cached like ``pack_weights``."""
    def build():
        blocks = [model.xyz_layers[i].w[-W:].T for i in range(1, D)]
        blocks += [model.xyz_final.w.T, model.dir_layer.w[:W].T]
        return torch.cat([b.reshape(-1) for b in blocks]).to(
            compute_dtype).contiguous()

    return _cached(model, "_fused_pack_t", compute_dtype, build)


# kernel H's dx operands are padded to this many output columns
DX_COLS = 64


def pack_weights_dx(model: NeRF, compute_dtype) -> torch.Tensor:
    """Kernel H's dx operands in ``compute_dtype``, each padded with zero
    columns to ``DX_COLS``: the dir rows of Wdir transposed (128 x 27 live),
    the xyz rows of W_4 transposed (256 x 63 live), W_0 transposed (256 x 63
    live), in the order the sweep reaches them.  Cached like
    ``pack_weights``."""
    def build():
        blocks = [model.dir_layer.w[W:].T, model.xyz_layers[SKIP].w[:CX].T,
                  model.xyz_layers[0].w.T]
        return torch.cat([
            torch.nn.functional.pad(b, (0, DX_COLS - b.shape[1])).reshape(-1)
            for b in blocks]).to(compute_dtype).contiguous()

    return _cached(model, "_fused_pack_dx", compute_dtype, build)


def unpack_grads(model: NeRF, dw: torch.Tensor, db: torch.Tensor,
                 compute_dtype) -> list:
    """Packed f32 grads -> ``[gW_0, gb_0, ..., gW_rgb, gb_rgb]`` in
    ``dense_layers`` order, at the model's width; weight grads rounded to
    ``compute_dtype``."""
    out, wo, bo = [], 0, 0
    for m in dense_layers(model):
        nw, nb = m.w.numel(), m.b.numel()
        out.append(dw[wo:wo + nw].to(compute_dtype).float().view_as(m.w))
        out.append(db[bo:bo + nb].view_as(m.b))
        wo, bo = wo + nw, bo + nb
    return out


# ------------------------------------------------------------ CUDA kernels
def _lib(compute_dtype):
    lib = native.load(native.library("fused_mlp",
                                     compute_dtype == torch.float16))
    if not getattr(lib, "_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.nerf_fused_fwd.argtypes = [p, p, p, p, ll, i, i, i, p]
        lib.nerf_fused_fwd.restype = i
        lib.nerf_fused_stash_fwd.argtypes = [p, p, p, p, ll, i, i, i, p, p]
        lib.nerf_fused_stash_fwd.restype = i
        lib.nerf_fused_stash_cols.argtypes = [i]
        lib.nerf_fused_stash_cols.restype = i
        lib.nerf_fused_weight_count.restype = ll
        lib.nerf_fused_bias_count.restype = ll
        lib._typed = True
    return lib


def _bwd_lib(compute_dtype):
    lib = native.load(native.library("fused_mlp_bwd",
                                     compute_dtype == torch.float16))
    if not getattr(lib, "_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.nerf_fused_bwd.argtypes = [p, p, p, p, p, ll, i, i, i, i, p, p, p,
                                       p, p, p, p, ll, i, i, p, p, p, i, p]
        lib.nerf_fused_bwd.restype = i
        lib.nerf_bwd_g_layout.argtypes = [i]
        for name in ("nerf_bwd_weight_count", "nerf_bwd_bias_count",
                     "nerf_bwd_transposed_count",
                     "nerf_bwd_dx_transposed_count"):
            getattr(lib, name).restype = ll
        for name in ("nerf_bwd_g_cols", "nerf_bwd_points_per_cta",
                     "nerf_bwd_bias_rows_per_group", "nerf_bwd_job_fields",
                     "nerf_bwd_g_layout"):
            getattr(lib, name).restype = i
        if (tuple(lib.nerf_bwd_g_layout(k) for k in range(len(G_LAYOUT)))
                != G_LAYOUT
                or lib.nerf_bwd_job_fields() != len(WGRAD_JOB_FIELDS)):
            raise ValueError("the G buffer or the job table does not match "
                             "the kernel's layout")
        lib._typed = True
    return lib


def _wide_lib(compute_dtype):
    lib = native.load(native.library("fused_mlp_wide",
                                     compute_dtype == torch.float16))
    if not getattr(lib, "_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.nerf_wide_fwd.argtypes = [p, i, p, p, p, ll, i, i, i, p]
        lib.nerf_wide_fwd.restype = i
        lib.nerf_wide_supported.argtypes = [i, i]
        lib.nerf_wide_supported.restype = i
        for name in ("nerf_wide_weight_count", "nerf_wide_bias_count"):
            getattr(lib, name).argtypes = [i]
            getattr(lib, name).restype = ll
        lib._typed = True
    return lib


# the tile input of the backward kernel (csrc's Io): raw rays channel-major
# (E, F) or row-major (E', F'), or pre-embedded rows (H)
IO_CHANNEL, IO_ROW, IO_EMBEDDED = 0, 1, 2


def _n_points(x: torch.Tensor, row_major: bool) -> int:
    return x.shape[0] if row_major else x.shape[1]


def _io_shape(P: int, row_major: bool) -> tuple:
    return (P, OUT_COLS) if row_major else (OUT_COLS, P)


def _check_raw(t: torch.Tensor, name: str, row_major: bool) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if row_major:
        if t.dim() != 2 or t.shape[1] != RAW_COLS:
            raise ValueError(f"{name} must be (P, {RAW_COLS}), got "
                             f"{tuple(t.shape)}")
        if t.data_ptr() % 16:  # the kernels move rows in 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")
    elif t.dim() != 2 or t.shape[0] != RAW_COLS:
        raise ValueError(f"{name} must be ({RAW_COLS}, P), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_dtype(compute_dtype) -> int:
    """The dtype's code at the kernels' C interface; other dtypes raise."""
    if compute_dtype not in DTYPE_CODES:
        raise TypeError(f"compute_dtype must be float32, bfloat16 or "
                        f"float16, got {compute_dtype}")
    return DTYPE_CODES[compute_dtype]


def _operands(model: NeRF, x: torch.Tensor, compute_dtype, row_major: bool):
    """Checks shared by every kernel's wrapper; the packed weights."""
    _check_raw(x, "x_raw" if row_major else "x_rawT", row_major)
    _check_dtype(compute_dtype)
    if not supports_fused(model):
        raise ValueError("the fused kernels need the reference architecture")
    wbuf, bbuf = pack_weights(model, compute_dtype)
    if wbuf.device != x.device:
        raise ValueError(f"weights on {wbuf.device}, input on {x.device}")
    return wbuf, bbuf


def _check_counts(lib, wbuf, bbuf, prefix):
    if (wbuf.numel() != getattr(lib, f"{prefix}_weight_count")()
            or bbuf.numel() != getattr(lib, f"{prefix}_bias_count")()):
        raise ValueError("packed weights do not match the kernel's layout")


def _fwd_cuda(model, x, sigma_only, compute_dtype, row_major, stash):
    """Kernels C/C' (``stash=False``: the output) and D/D' (``(out,
    stash)``) on the card."""
    wbuf, bbuf = _operands(model, x, compute_dtype, row_major)
    lib = _lib(compute_dtype)
    _check_counts(lib, wbuf, bbuf, "nerf_fused")
    P, dev = _n_points(x, row_major), x.device
    out = torch.empty(_io_shape(P, row_major), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), out.data_ptr(), wbuf.data_ptr(), bbuf.data_ptr(), P,
            int(sigma_only), DTYPE_CODES[compute_dtype], int(row_major))
    if not stash:
        if P:
            with torch.cuda.device(dev):  # the launch uses the current device
                err = lib.nerf_fused_fwd(*args, native.stream_of(x))
            native.check(lib, err, "nerf_fused_fwd")
        return out
    sc = stash_cols(sigma_only)
    if lib.nerf_fused_stash_cols(int(sigma_only)) != sc:
        raise ValueError("the stash layout does not match the kernel's")
    st = torch.empty((P, sc), dtype=compute_dtype, device=dev)
    if P:
        with torch.cuda.device(dev):
            err = lib.nerf_fused_stash_fwd(*args, st.data_ptr(),
                                           native.stream_of(x))
        native.check(lib, err, "nerf_fused_stash_fwd")
    return out, st


def _counted(fn, x, row_major, grids: int = 1):
    """Count one launch of ``fn``'s kernel unless there were no points, and
    the ``grids`` its body ran as (the backward's dgrad kernel runs once a
    point chunk: what a trace of the device sees)."""
    if _n_points(x, row_major):
        fn.launches += 1
        fn.grids += grids


def _bwd_grids(x, row_major) -> int:
    return -(-_n_points(x, row_major) // BWD_CHUNK)


def fused_nerf_apply_raw_t_cuda(model: NeRF, x_rawT: torch.Tensor,
                                sigma_only: bool = False,
                                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel C on the card: the forward on (8, P), no stash."""
    out = _fwd_cuda(model, x_rawT, sigma_only, compute_dtype, False, False)
    _counted(fused_nerf_apply_raw_t_cuda, x_rawT, False)
    return out


def fused_nerf_apply_raw_cuda(model: NeRF, x_raw: torch.Tensor,
                              sigma_only: bool = False,
                              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel C' on the card: the forward on (P, 8), no stash."""
    out = _fwd_cuda(model, x_raw, sigma_only, compute_dtype, True, False)
    _counted(fused_nerf_apply_raw_cuda, x_raw, True)
    return out


def fused_nerf_stash_fwd_cuda(model: NeRF, x_rawT: torch.Tensor,
                              sigma_only: bool = False,
                              compute_dtype=torch.bfloat16):
    """Kernel D on the card: ``(out (8, P), stash (P, SC))``."""
    res = _fwd_cuda(model, x_rawT, sigma_only, compute_dtype, False, True)
    _counted(fused_nerf_stash_fwd_cuda, x_rawT, False)
    return res


def fused_nerf_raw_stash_fwd_cuda(model: NeRF, x_raw: torch.Tensor,
                                  sigma_only: bool = False,
                                  compute_dtype=torch.bfloat16):
    """Kernel D' on the card: ``(out (P, 8), stash (P, SC))``."""
    res = _fwd_cuda(model, x_raw, sigma_only, compute_dtype, True, True)
    _counted(fused_nerf_raw_stash_fwd_cuda, x_raw, True)
    return res


def _bwd_cuda(model, x, g, sigma_only, compute_dtype, stash, row_major):
    wbuf, bbuf = _operands(model, x, compute_dtype, row_major)
    _check_raw(g, "g", row_major)
    P = _n_points(x, row_major)
    if _n_points(g, row_major) != P:
        raise ValueError(f"g has {_n_points(g, row_major)} points, x {P}")
    sc = stash_cols(sigma_only)
    if stash is not None and (stash.shape != (P, sc)
                              or stash.dtype != compute_dtype
                              or stash.device != x.device
                              or not stash.is_contiguous()):
        raise ValueError(f"stash must be a contiguous ({P}, {sc}) "
                         f"{compute_dtype} tensor on {x.device}")
    return _bwd_launch(model, x, g, wbuf, bbuf, P, sigma_only, compute_dtype,
                       stash, IO_ROW if row_major else IO_CHANNEL)


def _bwd_launch(model, x, g, wbuf, bbuf, P, sigma_only, compute_dtype, stash,
                io, dx=None):
    """The backward kernels' workspace and launch: E or F (E', F') on raw
    rays, or H with ``dx`` (P, C) zeros on pre-embedded rows."""
    sc = stash_cols(sigma_only)
    lib = _bwd_lib(compute_dtype)
    _check_counts(lib, wbuf, bbuf, "nerf_bwd")
    wt = None
    if compute_dtype == torch.float32:  # the scalar sweep's operands
        wt = pack_weights_t(model, compute_dtype)
        if wt.numel() != lib.nerf_bwd_transposed_count():
            raise ValueError("transposed weights do not match the kernel's "
                             "layout")
    jobs = wgrad_jobs(sigma_only, compute_dtype)
    table = (ctypes.c_longlong * (len(jobs) * len(WGRAD_JOB_FIELDS)))(
        *[v for job in jobs for v in job])
    wx, x_cols = None, 0
    if dx is not None:
        wx, x_cols = pack_weights_dx(model, compute_dtype), x.shape[1]
        if wx.numel() != lib.nerf_bwd_dx_transposed_count():
            raise ValueError("dx operands do not match the kernel's layout")
    dev = x.device
    dw = torch.zeros(wbuf.numel(), dtype=torch.float32, device=dev)
    db = torch.zeros(bbuf.numel(), dtype=torch.float32, device=dev)
    if P == 0:
        return dw, db
    chunk = min(BWD_CHUNK, P)
    tp, rpg = lib.nerf_bwd_points_per_cta(), lib.nerf_bwd_bias_rows_per_group()
    tiles = -(-chunk // tp)
    gbuf = torch.empty((chunk, G_COLS), dtype=compute_dtype, device=dev)
    wpart = torch.zeros((BWD_SPLIT, wbuf.numel()), dtype=torch.float32,
                        device=dev)
    bpart = torch.empty((tiles, bbuf.numel()), dtype=torch.float32, device=dev)
    btmp = torch.empty((-(-tiles // rpg), bbuf.numel()), dtype=torch.float32,
                       device=dev)
    if stash is None:  # F: the forward is recomputed into a chunk scratch
        stash = torch.empty((chunk, sc), dtype=compute_dtype, device=dev)
        remat = 1
    else:
        remat = 0
    with torch.cuda.device(dev):
        err = lib.nerf_fused_bwd(
            x.data_ptr(), g.data_ptr(), wbuf.data_ptr(), bbuf.data_ptr(),
            None if wt is None else wt.data_ptr(), P, int(sigma_only),
            DTYPE_CODES[compute_dtype], remat, io,
            stash.data_ptr(), gbuf.data_ptr(), wpart.data_ptr(),
            bpart.data_ptr(), btmp.data_ptr(), dw.data_ptr(), db.data_ptr(),
            chunk, BWD_SPLIT, x_cols, None if wx is None else wx.data_ptr(),
            None if dx is None else dx.data_ptr(), ctypes.addressof(table),
            len(jobs), native.stream_of(x))
    native.check(lib, err, "nerf_fused_bwd")
    return dw, db


def _need_stash(stash, kernel):
    if stash is None:
        raise ValueError(f"kernel {kernel} reads a stash; the remat kernel "
                         "recomputes")


def fused_nerf_bwd_stash_cuda(model: NeRF, x_rawT: torch.Tensor,
                              g: torch.Tensor, stash: torch.Tensor,
                              sigma_only: bool = False,
                              compute_dtype=torch.bfloat16):
    """Kernel E on the card: packed f32 ``(dw, db)`` from D's stash."""
    _need_stash(stash, "E")
    out = _bwd_cuda(model, x_rawT, g, sigma_only, compute_dtype, stash, False)
    _counted(fused_nerf_bwd_stash_cuda, x_rawT, False,
             _bwd_grids(x_rawT, False))
    return out


def fused_nerf_raw_bwd_stash_cuda(model: NeRF, x_raw: torch.Tensor,
                                  g: torch.Tensor, stash: torch.Tensor,
                                  sigma_only: bool = False,
                                  compute_dtype=torch.bfloat16):
    """Kernel E' on the card: packed f32 ``(dw, db)`` from the stash of D',
    x and g ``(P, 8)``."""
    _need_stash(stash, "E'")
    out = _bwd_cuda(model, x_raw, g, sigma_only, compute_dtype, stash, True)
    _counted(fused_nerf_raw_bwd_stash_cuda, x_raw, True,
             _bwd_grids(x_raw, True))
    return out


def fused_nerf_bwd_remat_cuda(model: NeRF, x_rawT: torch.Tensor,
                              g: torch.Tensor, sigma_only: bool = False,
                              compute_dtype=torch.bfloat16):
    """Kernel F on the card: packed f32 ``(dw, db)``, forward recomputed."""
    out = _bwd_cuda(model, x_rawT, g, sigma_only, compute_dtype, None, False)
    _counted(fused_nerf_bwd_remat_cuda, x_rawT, False,
             _bwd_grids(x_rawT, False))
    return out


def fused_nerf_raw_bwd_remat_cuda(model: NeRF, x_raw: torch.Tensor,
                                  g: torch.Tensor, sigma_only: bool = False,
                                  compute_dtype=torch.bfloat16):
    """Kernel F' on the card: packed f32 ``(dw, db)``, forward recomputed,
    x and g ``(P, 8)``."""
    out = _bwd_cuda(model, x_raw, g, sigma_only, compute_dtype, None, True)
    _counted(fused_nerf_raw_bwd_remat_cuda, x_raw, True,
             _bwd_grids(x_raw, True))
    return out


# pre-embedded rows: xyz_emb, or [xyz_emb | dir_emb]
EMB_COLS = (CX, CX + CD)


def _check_embedded(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] not in EMB_COLS:
        raise ValueError(f"x must be (P, {CX}) or (P, {CX + CD}) embedded "
                         f"rows, got {tuple(x.shape)}")


def _embedded_operands(model: NeRF, x: torch.Tensor, compute_dtype):
    """Checks shared by kernels G's and H's wrappers; the packed weights."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    _check_embedded(x)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _check_dtype(compute_dtype)
    if not supports_fused_apply(model, compute_dtype):
        raise ValueError("kernel G takes the reference architecture at W = "
                         "256 or a width that supports_fused_wide admits")
    wbuf, bbuf = pack_weights(model, compute_dtype)
    if wbuf.device != x.device:
        raise ValueError(f"weights on {wbuf.device}, input on {x.device}")
    return wbuf, bbuf


def fused_nerf_apply_cuda(model: NeRF, x: torch.Tensor,
                          sigma_only: bool = False,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel G on the card: pre-embedded rows ``x (P, 63)`` or ``(P, 90)``
    -> ``(P, 8)`` float32, at the model's width."""
    wbuf, bbuf = _embedded_operands(model, x, compute_dtype)
    lib = _wide_lib(compute_dtype)
    width, code = model.width, DTYPE_CODES[compute_dtype]
    if not lib.nerf_wide_supported(width, code):
        raise ValueError(f"kernel G is not built for W = {width} in "
                         f"{compute_dtype}")
    if (wbuf.numel() != lib.nerf_wide_weight_count(width)
            or bbuf.numel() != lib.nerf_wide_bias_count(width)):
        raise ValueError("packed weights do not match the kernel's layout")
    P = x.shape[0]
    out = torch.empty((P, OUT_COLS), dtype=torch.float32, device=x.device)
    if P:
        with torch.cuda.device(x.device):
            err = lib.nerf_wide_fwd(x.data_ptr(), x.shape[1], out.data_ptr(),
                                    wbuf.data_ptr(), bbuf.data_ptr(), P, width,
                                    int(sigma_only), code, native.stream_of(x))
        native.check(lib, err, "nerf_wide_fwd")
    _counted(fused_nerf_apply_cuda, x, True)
    return out


_NO_WIDE_GRAD = ("fused_nerf_apply has no backward at W = {w}: the fused "
                 "backward (JAX's _bwd_core, fused_mlp.py:261) is written for "
                 "W = 256, and JAX cannot differentiate the wide forward "
                 "either")


def fused_nerf_bwd_dx_cuda(model: NeRF, x: torch.Tensor, g: torch.Tensor,
                           sigma_only: bool = False,
                           compute_dtype=torch.bfloat16):
    """Kernel H on the card: ``(dx (P, C), dw, db)`` f32 for pre-embedded
    rows ``x (P, C)`` and the cotangent ``g (P, 8)`` of G's output, the
    forward recomputed; W = 256 only."""
    wbuf, bbuf = _embedded_operands(model, x, compute_dtype)
    if model.width != W:
        raise ValueError(_NO_WIDE_GRAD.format(w=model.width))
    _check_raw(g, "g", True)
    P = x.shape[0]
    if g.shape[0] != P:
        raise ValueError(f"g has {g.shape[0]} points, x {P}")
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dw, db = _bwd_launch(model, x, g, wbuf, bbuf, P, sigma_only,
                         compute_dtype, None, IO_EMBEDDED, dx)
    _counted(fused_nerf_bwd_dx_cuda, x, True,
             _bwd_grids(x, True))
    return dx, dw, db


KERNELS = {  # launch counters, by the letters PERF.md gives the kernels
    # (``launches``: calls that launched; ``grids``: the body's launches)
    "C": fused_nerf_apply_raw_t_cuda, "D": fused_nerf_stash_fwd_cuda,
    "E": fused_nerf_bwd_stash_cuda, "F": fused_nerf_bwd_remat_cuda,
    "C'": fused_nerf_apply_raw_cuda, "D'": fused_nerf_raw_stash_fwd_cuda,
    "E'": fused_nerf_raw_bwd_stash_cuda, "F'": fused_nerf_raw_bwd_remat_cuda,
    "G": fused_nerf_apply_cuda, "H": fused_nerf_bwd_dx_cuda,
}
for _fn in KERNELS.values():
    _fn.launches = _fn.grids = 0
del _fn


# ------------------------------------------------------------------ autograd
class _FusedRawT(torch.autograd.Function):
    """Forward D (``use_stash``) or C; backward E or F; with ``row_major``
    D', C', E', F' on ``(P, 8)``.  Inputs: ``x``, then the parameters in
    ``dense_layers`` order (w, b per layer)."""

    @staticmethod
    def forward(ctx, x, model, sigma_only, compute_dtype, use_stash,
                row_major, *params):
        cuda = x.device.type == "cuda"
        if use_stash:
            if cuda:
                fwd = (fused_nerf_raw_stash_fwd_cuda if row_major
                       else fused_nerf_stash_fwd_cuda)
            else:
                fwd = (fused_nerf_raw_stash_fwd_plain if row_major
                       else fused_nerf_stash_fwd_plain)
            out, stash = fwd(model, x, sigma_only, compute_dtype)
            ctx.save_for_backward(x, stash)
        else:
            if cuda:
                fwd = (fused_nerf_apply_raw_cuda if row_major
                       else fused_nerf_apply_raw_t_cuda)
            else:
                fwd = (fused_nerf_apply_raw_plain if row_major
                       else fused_nerf_apply_raw_t_plain)
            out = fwd(model, x, sigma_only, compute_dtype)
            ctx.save_for_backward(x)
        ctx.model, ctx.sigma_only, ctx.compute_dtype, ctx.row_major = (
            model, sigma_only, compute_dtype, row_major)
        return out

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        stash = rest[0] if rest else None
        model, sigma_only, cdt = ctx.model, ctx.sigma_only, ctx.compute_dtype
        rm = ctx.row_major
        g = g.float().contiguous()
        if x.device.type == "cuda":
            if stash is not None:
                bwd = (fused_nerf_raw_bwd_stash_cuda if rm
                       else fused_nerf_bwd_stash_cuda)
                dw, db = bwd(model, x, g, stash, sigma_only, cdt)
            else:
                bwd = (fused_nerf_raw_bwd_remat_cuda if rm
                       else fused_nerf_bwd_remat_cuda)
                dw, db = bwd(model, x, g, sigma_only, cdt)
        else:
            bwd = fused_nerf_raw_bwd_plain if rm else fused_nerf_bwd_plain
            dw, db = bwd(model, x, g, sigma_only, cdt, stash)
        return (None, None, None, None, None, None,
                *unpack_grads(model, dw, db, cdt))


def _apply(model, x, sigma_only, compute_dtype, stash_blocks, row_major):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused MLP for device {x.device}")
    params = [t for m in dense_layers(model) for t in (m.w, m.b)]
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        use_stash = stash_blocks is not None and (
            stash_blocks != "auto"
            or _n_points(x, row_major) <= STASH_MAX_POINTS)
        return _FusedRawT.apply(x, model, sigma_only, compute_dtype,
                                use_stash, row_major, *params)
    if x.device.type == "cuda":
        fwd = (fused_nerf_apply_raw_cuda if row_major
               else fused_nerf_apply_raw_t_cuda)
    else:
        fwd = (fused_nerf_apply_raw_plain if row_major
               else fused_nerf_apply_raw_t_plain)
    return fwd(model, x, sigma_only, compute_dtype)


def fused_nerf_apply_raw_t(model: NeRF, x_rawT: torch.Tensor,
                           sigma_only: bool = False,
                           compute_dtype=torch.bfloat16,
                           stash_blocks="auto") -> torch.Tensor:
    """Channel-major fused MLP: (8, P) in -> (8, P) out.  Kernels on a CUDA
    tensor, their plain versions on a CPU tensor.  ``stash_blocks`` picks
    the backward as in JAX: ``"auto"`` the stash (D then E) up to
    ``STASH_MAX_POINTS`` points, ``None`` the remat (C then F); any other
    value (the TPU's block sizes) the stash."""
    return _apply(model, x_rawT, sigma_only, compute_dtype, stash_blocks,
                  False)


def fused_nerf_apply_raw(model: NeRF, xyz: torch.Tensor, dirs=None,
                         compute_dtype=torch.bfloat16,
                         stash_blocks="auto") -> torch.Tensor:
    """Row-major fused MLP on raw ``xyz (P, 3)`` and ``dirs (P, 3)`` (None:
    sigma-only, the dir columns are zeros): ``(P, 4)`` ``[rgb, sigma]`` or
    ``(P, 1)`` sigma, float32.  The kernels take ``(P, 8)`` rows ``[xyz |
    dir | 0 0]``: C' (no grad, or the remat route's forward), D' and E'
    (the stash route) or F' (the remat route), chosen by ``stash_blocks``
    as ``fused_nerf_apply_raw_t`` chooses; plain versions on a CPU
    tensor."""
    P = xyz.shape[0]
    sigma_only = dirs is None
    zeros = torch.zeros((P, RAW_COLS - 3), dtype=torch.float32,
                        device=xyz.device)
    parts = [xyz.float(), zeros] if sigma_only else [
        xyz.float(), dirs.float(), zeros[:, 3:]]
    x = torch.cat(parts, dim=1)
    out = _apply(model, x, sigma_only, compute_dtype, stash_blocks, True)
    return out[:, :1] if sigma_only else out[:, :4]


class _FusedEmbedded(torch.autograd.Function):
    """Forward G, backward H, on pre-embedded rows ``(P, C)``; the ``(P, 8)``
    output.  Inputs: ``x``, then the parameters in ``dense_layers`` order
    (w, b per layer)."""

    @staticmethod
    def forward(ctx, x, model, sigma_only, compute_dtype, *params):
        fwd = (fused_nerf_apply_cuda if x.device.type == "cuda"
               else fused_nerf_apply_plain)
        ctx.save_for_backward(x)
        ctx.model, ctx.sigma_only, ctx.compute_dtype = (model, sigma_only,
                                                        compute_dtype)
        return fwd(model, x, sigma_only, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        model, cdt = ctx.model, ctx.compute_dtype
        bwd = (fused_nerf_bwd_dx_cuda if x.device.type == "cuda"
               else fused_nerf_bwd_dx_plain)
        dx, dw, db = bwd(model, x, g.float().contiguous(), ctx.sigma_only, cdt)
        return (dx if ctx.needs_input_grad[0] else None, None, None, None,
                *unpack_grads(model, dw, db, cdt))


def fused_nerf_apply(model: NeRF, x: torch.Tensor, sigma_only: bool = False,
                     compute_dtype=torch.bfloat16, block=None) -> torch.Tensor:
    """The fused MLP on pre-embedded rows (``fused_nerf_apply``,
    fused_mlp.py:495-523): ``x (P, 63)`` xyz_emb or ``(P, 90)`` [xyz_emb |
    dir_emb] -> ``(P, 1)`` sigma or ``(P, 4)`` ``[rgb, sigma]``, float32, at
    the reference width or a wide one (``supports_fused_apply``).  Kernel G
    on a CUDA tensor, its plain version on a CPU tensor.  With grad enabled
    and a trainable parameter or input, a ``torch.autograd.Function`` whose
    backward is kernel H (grads for the parameters and x), at W = 256 only:
    any other width raises, as JAX's backward fails there.  ``block``, the
    TPU kernel's point block, means nothing to the CUDA kernel (whose tile
    follows from the width) and is ignored."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused MLP for device {x.device}")
    _check_embedded(x)
    if not supports_fused_apply(model, compute_dtype):
        raise ValueError("fused_nerf_apply takes the reference architecture "
                         "at W = 256 or a width that supports_fused_wide "
                         "admits at the compute dtype")
    x = x.float().contiguous()
    params = [t for m in dense_layers(model) for t in (m.w, m.b)]
    if torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in params)):
        if model.width != W:
            raise ValueError(_NO_WIDE_GRAD.format(w=model.width))
        out = _FusedEmbedded.apply(x, model, sigma_only, compute_dtype,
                                   *params)
    else:
        fwd = (fused_nerf_apply_cuda if x.device.type == "cuda"
               else fused_nerf_apply_plain)
        out = fwd(model, x, sigma_only, compute_dtype)
    return out[:, :1] if sigma_only else out[:, :4]
