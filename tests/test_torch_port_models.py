"""The port's models (``nerf_pl_tpu_torch.models``) against the JAX package.

The same numpy weights and inputs, made from a seed, go through
``nerf_pl_tpu`` and ``nerf_pl_tpu_torch`` on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pl_tpu.models.camera import c2w_from_lookat as jax_c2w_from_lookat
from nerf_pl_tpu.models.embedding import posenc as jax_posenc
from nerf_pl_tpu.models.nerf import init_nerf as jax_init_nerf
from nerf_pl_tpu.models.nerf import nerf_apply
from nerf_pl_tpu_torch import resolve_device
from nerf_pl_tpu_torch.models.camera import c2w_from_lookat
from nerf_pl_tpu_torch.models.embedding import posenc
from nerf_pl_tpu_torch.models.nerf import init_nerf, nerf_from_numpy, nerf_to_numpy


def np_nerf(seed, D=8, W=256, cx=63, cd=27, skips=(4,)):
    """A NeRF param tree (JAX layout, numpy leaves) with ``nn.Linear``
    bounds, drawn from a numpy seed."""
    rng = np.random.RandomState(seed)

    def dense(fan_in, fan_out):
        bound = 1.0 / np.sqrt(fan_in)
        return {"w": rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
                "b": rng.uniform(-bound, bound, (fan_out,)).astype(np.float32)}

    layers = [dense(cx if i == 0 else (W + cx if i in skips else W), W)
              for i in range(D)]
    return {"xyz_layers": layers, "xyz_final": dense(W, W),
            "dir_layer": dense(W + cd, W // 2), "sigma": dense(W, 1),
            "rgb": dense(W // 2, 3)}


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dev)


@pytest.mark.parametrize("n_freqs,logscale", [(10, True), (4, True), (3, False), (0, True)])
def test_posenc_matches_jax(n_freqs, logscale):
    x = np.random.RandomState(0).uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    ref = np.asarray(jax_posenc(jnp.asarray(x), n_freqs, logscale))
    out = posenc(torch.from_numpy(x), n_freqs, logscale).numpy()
    assert out.shape == ref.shape == (64, 3 * (2 * n_freqs + 1))
    # f32 sin/cos of arguments up to 2^9 * 1.5 rad: both libraries are
    # accurate to about an ulp of the argument's reduction
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nerf_forward_matches_nerf_apply(sigma_only, dtype):
    tree = np_nerf(1, D=6, W=32, skips=(4,))
    model = nerf_from_numpy(tree, device="cpu")
    assert model.skips == (4,)
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (128, 63 if sigma_only else 90)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = np.asarray(nerf_apply(tree, jnp.asarray(x), sigma_only, jdt))
    with torch.no_grad():
        out = model(torch.from_numpy(x), sigma_only, tdt).numpy()
    assert out.shape == ref.shape == (128, 1 if sigma_only else 4)
    # f32: only the order of the f32 sums differs.  bf16: both round every
    # operand to bf16 and sum exactly-representable products in f32, so a
    # different sum order can only flip a rare bf16 rounding of a hidden
    # activation (2^-8 relative)
    atol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


def test_skip_inferred_from_weight_shapes():
    tree = np_nerf(3, D=6, W=32, skips=(3,))
    model = nerf_from_numpy(tree, device="cpu")
    assert model.skips == (3,)
    x = np.random.RandomState(4).uniform(-1, 1, (16, 90)).astype(np.float32)
    ref = np.asarray(nerf_apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_weight_round_trip():
    tree = np_nerf(5)
    back = nerf_to_numpy(nerf_from_numpy(tree, device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # flax stores lists as maps keyed "0".."n-1"
    keyed = dict(tree, xyz_layers={str(i): l for i, l in enumerate(tree["xyz_layers"])})
    again = nerf_to_numpy(nerf_from_numpy(keyed, device="cpu"))
    np.testing.assert_array_equal(again["xyz_layers"][7]["w"], tree["xyz_layers"][7]["w"])
    bad = dict(tree, rgb={"w": np.zeros((128, 4), np.float32), "b": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="rgb.w"):
        nerf_from_numpy(bad, device="cpu")


def test_init_nerf_layout_and_bounds():
    jtree = jax.tree_util.tree_map(np.shape, jax_init_nerf(jax.random.PRNGKey(0)))
    model = init_nerf(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_map(np.shape, nerf_to_numpy(model)) == jtree
    for name, p in model.named_parameters():
        p = p.detach()
        fan_in = getattr(model.get_submodule(name.rsplit(".", 1)[0]), "w").shape[0]
        assert float(p.abs().max()) <= 1.0 / np.sqrt(fan_in), name
        if p.numel() > 1:
            assert float(p.std()) > 0.2 / np.sqrt(fan_in), name
    again = init_nerf(torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_c2w_from_lookat_matches_jax_package():
    for eye in ([4.0, 1.0, 0.0], [0.3, -2.0, 3.5]):
        eye = np.asarray(eye, np.float32)
        at = np.asarray([0.1, 0.2, -0.3], np.float32)
        np.testing.assert_array_equal(c2w_from_lookat(eye, at),
                                      jax_c2w_from_lookat(eye, at))
