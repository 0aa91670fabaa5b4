"""The mesh tool against the JAX package on the CPU: the mesh utilities bit
for bit (keep_largest_cluster's tie between two components of equal size
included; the PLY and ``.vol`` bytes), ``grid_vertices_to_world`` at unequal
ranges, the images the fusion reads against PIL, and the whole tool
(``python -m nerf_pl_tpu_torch.extract_color_mesh``) against JAX's ``run``
on a scene written by ``generate_scene`` and a checkpoint written by the
JAX package: plain fusion, ``--use_vertex_normal`` and ``--vol_only``.
"""
import jax
import numpy as np
import pytest
from PIL import Image

from nerf_pl_tpu.models.nerf import init_nerf as jinit_nerf
from nerf_pl_tpu.tools import extract_mesh as jmesh
from nerf_pl_tpu.tools import mesh_utils as jmu
from nerf_pl_tpu.tools.evaluate import load_models as jload_models
from nerf_pl_tpu.training.checkpoints import save_checkpoint as jsave
from nerf_pl_tpu_torch.data.synthetic import generate_scene
from nerf_pl_tpu_torch.extract_color_mesh import main as mesh_main
from nerf_pl_tpu_torch.ops import fused_mlp, searchsorted
from nerf_pl_tpu_torch.tools import extract_mesh, mesh_utils
from nerf_pl_tpu_torch.tools.evaluate import load_models


def _two_blobs(n, shift=0.4, scale=(1.0, 1.0)):
    """Two Gaussian blobs on an n³ grid: equal in size with ``scale``
    (1, 1), so their surfaces tie in vertex count."""
    g = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(g, g, g)
    return (scale[0] * np.exp(-((X - shift) ** 2 + Y ** 2 + Z ** 2) * 20)
            + scale[1] * np.exp(-((X + shift) ** 2 + Y ** 2 + Z ** 2) * 20)
            ).astype(np.float32)


def _wavy(n, seed):
    rng = np.random.RandomState(seed)
    g = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(g, g, g)
    f = rng.uniform(4, 9, 3)
    return (np.sin(f[0] * X) * np.sin(f[1] * Y) * np.sin(f[2] * Z)
            + 0.05 * rng.normal(size=X.shape)).astype(np.float32)


VOLUMES = {
    "tie": (_two_blobs(24), 0.5),
    "tie_40": (_two_blobs(40), 0.3),
    "unequal": (_two_blobs(32, scale=(1.0, 0.8)), 0.4),
    "wavy": (_wavy(36, 3), 0.3),
    "empty": (np.zeros((8, 8, 8), np.float32), 0.5),
}


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_marching_and_cluster_bit_equal(name):
    vol, thr = VOLUMES[name]
    vj, tj = jmu.marching_tetrahedra(vol, thr)
    vt, tt = mesh_utils.marching_tetrahedra(vol, thr)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(tt, tj)
    assert vt.dtype == vj.dtype and tt.dtype == tj.dtype
    cj = jmu.keep_largest_cluster(vj, tj)
    ct = mesh_utils.keep_largest_cluster(vt, tt)
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    if name.startswith("tie"):
        # two components of the same size: the one holding the lower vertex
        # index is kept, as scipy's numbering and argmax choose
        assert 0 < len(cj[0]) < len(vj) and 2 * len(cj[0]) == len(vj)


def test_cluster_tie_picks_the_lower_vertex_index():
    """Two disjoint triangles and a lone vertex listed first: scipy numbers
    the lone vertex's component 0, the triangles' 1 and 2 in the order of
    their lowest vertex; the tie between the triangles goes to the first."""
    verts = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    tris = np.array([[5, 4, 6], [3, 1, 2]], np.int64)
    for mod in (jmu, mesh_utils):
        v, t = mod.keep_largest_cluster(verts, tris)
        np.testing.assert_array_equal(v, verts[[1, 2, 3]])
        np.testing.assert_array_equal(t, [[2, 0, 1]])


def test_cluster_on_a_long_chain():
    """A strip of 4,000 triangles numbered against its order (every other
    vertex from the far end): the union-find still finds one component, and
    a second, smaller strip goes."""
    n = 4000
    order = np.concatenate([np.arange(0, n + 2, 2), np.arange(1, n + 2, 2)])[::-1]
    tris = np.stack([order[i:i + 3] for i in range(n)]).astype(np.int64)
    small = np.array([[n + 2, n + 3, n + 4]], np.int64)
    verts = np.random.RandomState(0).normal(size=(n + 5, 3)).astype(np.float32)
    allt = np.concatenate([small, tris])
    for a, b in zip(mesh_utils.keep_largest_cluster(verts, allt),
                    jmu.keep_largest_cluster(verts, allt)):
        np.testing.assert_array_equal(a, b)
    assert len(mesh_utils.keep_largest_cluster(verts, allt)[0]) == n + 2


def _smooth_noise(n, cutoff, seed):
    """White noise on an n³ grid low-passed by a Gaussian of ``cutoff``
    cycles a sample: a random field smooth at the grid's spacing."""
    rng = np.random.default_rng(seed)
    k2 = (np.fft.fftfreq(n)[:, None, None] ** 2
          + np.fft.fftfreq(n)[None, :, None] ** 2
          + np.fft.rfftfreq(n)[None, None, :] ** 2)
    return np.fft.irfftn(np.fft.rfftn(rng.standard_normal((n, n, n)))
                         * np.exp(-k2 / (2 * cutoff ** 2)), s=(n, n, n),
                         axes=(0, 1, 2)).astype(np.float32)


@pytest.mark.parametrize("quantile", [0.5, 0.9])
def test_cluster_at_scale_bit_equal(quantile):
    """The iso-surface of a smooth random field on a 64³ grid, ~1.6e5
    vertices in one large cluster at the median, ~7e4 in many fragments at
    the 90th percentile: the union-find keeps what scipy's components keep,
    bit for bit."""
    field = _smooth_noise(64, 0.05, 0)
    v, t = mesh_utils.marching_tetrahedra(
        np.maximum(field - np.float32(np.quantile(field, quantile)), 0), 1e-6)
    assert len(v) > 5e4
    kept = mesh_utils.keep_largest_cluster(v, t)
    for a, b in zip(kept, jmu.keep_largest_cluster(v, t)):
        np.testing.assert_array_equal(a, b)
    assert 0 < len(kept[0]) < len(v)


@pytest.mark.parametrize("colors", [True, False], ids=["colors", "plain"])
def test_ply_bytes_equal(tmp_path, colors):
    vol, thr = VOLUMES["wavy"]
    v, t = mesh_utils.marching_tetrahedra(vol, thr)
    c = (np.random.RandomState(1).uniform(0, 255, (len(v), 3))
         if colors else None)
    jmu.write_ply(str(tmp_path / "j.ply"), v, t, c)
    mesh_utils.write_ply(str(tmp_path / "t.ply"), v, t, c)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    for a, b in zip(mesh_utils.read_ply(str(tmp_path / "j.ply")),
                    jmu.read_ply(str(tmp_path / "t.ply"))):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


def test_vol_bytes_equal(tmp_path):
    grid = np.abs(_wavy(12, 5)) * 30
    grid[0, 0, 0] = -1.0  # clamped at 0
    ranges = ([-1.0, 1.0], [-0.5, 1.5], [-1.2, 1.3])
    jmu.save_vol(str(tmp_path / "j.vol"), grid, *ranges)
    mesh_utils.save_vol(str(tmp_path / "t.vol"), grid, *ranges)
    assert (tmp_path / "j.vol").read_bytes() == (tmp_path / "t.vol").read_bytes()
    gj, rj = jmu.read_vol(str(tmp_path / "t.vol"))
    gt, rt = mesh_utils.read_vol(str(tmp_path / "j.vol"))
    np.testing.assert_array_equal(gt, gj)
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a, b)
    mesh_utils.save_vol(str(tmp_path / "z.vol"), np.zeros((3, 4, 5)), *ranges)
    jmu.save_vol(str(tmp_path / "zj.vol"), np.zeros((3, 4, 5)), *ranges)
    assert (tmp_path / "z.vol").read_bytes() == (tmp_path / "zj.vol").read_bytes()
    (tmp_path / "bad.vol").write_bytes(b"XVOL" + bytes(40))
    with pytest.raises(ValueError, match="not a NVOL file"):
        mesh_utils.read_vol(str(tmp_path / "bad.vol"))


def test_bilinear_sample_bit_equal():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    x = rng.uniform(-2, 19, 500)
    y = rng.uniform(-2, 15, 500)
    np.testing.assert_array_equal(mesh_utils.bilinear_sample(img, x, y),
                                  jmu.bilinear_sample(img, x, y))


def test_grid_vertices_to_world_unequal_ranges():
    rng = np.random.RandomState(4)
    verts = rng.uniform(0, 31, (200, 3)).astype(np.float32)
    args = (verts, 32, [-1.3, 1.3], [-0.92, 1.5], [-1.1, 0.7])
    out = extract_mesh.grid_vertices_to_world(*args)
    np.testing.assert_array_equal(out, jmesh.grid_vertices_to_world(*args))
    # axis 1 through x_range, axis 0 through y_range
    np.testing.assert_allclose(out[:, 0], 2.6 * verts[:, 1] / 32 - 1.3, rtol=1e-6)
    np.testing.assert_allclose(out[:, 1], 2.42 * verts[:, 0] / 32 - 0.92, rtol=1e-6)


# ------------------------------------------------------------ the whole tool
@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_scene")
    generate_scene(str(root / "scene"), img_wh=16, n_train=3, n_val=1, n_test=1)
    return str(root / "scene")


@pytest.fixture(scope="module")
def mesh_ckpt(tmp_path_factory):
    """A JAX-written checkpoint whose fine model has density variation (the
    sigma bias lifted), as ``tests/test_tools.py::mesh_ckpt`` builds it."""
    params = {"coarse": jinit_nerf(jax.random.PRNGKey(0)),
              "fine": jinit_nerf(jax.random.PRNGKey(1))}
    for name in params:
        params[name]["sigma"]["b"] = params[name]["sigma"]["b"] + 0.05
    path = str(tmp_path_factory.mktemp("mesh_ckpt") / "mesh.ckpt")
    jsave(path, {"params": params})
    return path


def _grid(n):
    g = np.linspace(-1, 1, n).astype(np.float32)
    return np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3)


def test_sigma_grid_matches_jax(mesh_ckpt):
    xyz = _grid(20)[:7000]  # a ragged last chunk, padded with zero rows
    ref = jmesh.query_sigma_grid(jload_models(mesh_ckpt)["fine"], xyz, 512)
    out = extract_mesh.query_sigma_grid(
        load_models(mesh_ckpt, "cpu")["fine"], xyz, 512)
    assert out.shape == ref.shape == (7000,) and out.dtype == np.float32
    # posenc + NeRF in f32 against JAX's nerf_apply: only the order of the
    # f32 sums differs (3.7e-9 on the CPU against sigmas of ~1e-2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def threshold(mesh_ckpt):
    """Half the grid's largest density (``tests/test_tools.py``)."""
    sigma = np.maximum(jmesh.query_sigma_grid(
        jload_models(mesh_ckpt)["fine"], _grid(24), 512), 0)
    assert sigma.max() > 0
    return 0.5 * float(sigma.max())


def _argv(scene, ckpt, out, thr, n_grid, extra=()):
    return ["--root_dir", scene, "--dataset_name", "blender",
            "--img_wh", "16", "16", "--N_samples", "8", "--chunk", "512",
            "--ckpt_path", ckpt, "--N_grid", str(n_grid),
            "--sigma_threshold", str(thr), "--out_path", out, *extra]


@pytest.mark.parametrize("mode", ["fusion", "vertex_normal"])
def test_mesh_tool_matches_jax(scene, mesh_ckpt, threshold, tmp_path, mode,
                               capsys):
    extra = (["--use_vertex_normal", "--N_importance", "8"]
             if mode == "vertex_normal" else [])
    n_grid = 32 if mode == "fusion" else 24
    ref = jmesh.run(jmesh.get_opts(_argv(
        scene, mesh_ckpt, str(tmp_path / "j.ply"), threshold, n_grid, extra)))
    launches = ({k: f.launches for k, f in fused_mlp.KERNELS.items()},
                searchsorted.searchsorted_interp_cuda.launches)
    out = mesh_main(_argv(scene, mesh_ckpt, str(tmp_path / "t.ply"),
                          threshold, n_grid, extra + ["--device", "cpu"]))
    # a CPU run takes the plain versions: no kernel launched
    assert launches == ({k: f.launches for k, f in fused_mlp.KERNELS.items()},
                        searchsorted.searchsorted_interp_cuda.launches)
    vj, tj, cj = jmu.read_ply(ref)
    vt, tt, ct = mesh_utils.read_ply(out)
    assert len(tt) > 0 and ct is not None
    # no grid value crosses the threshold between the two (the sigmas agree
    # to 1e-7), so the surfaces have the same cells and the same triangles
    np.testing.assert_array_equal(tt, tj)
    # a vertex interpolates between two grid sigmas on an edge of 2/(N-1):
    # a 1e-7 sigma difference over a ~1e-3 sigma step across the edge moves
    # it by ~1e-5 of the grid (1.3e-6 on the CPU)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5)
    # colours: the same images and the same renders up to f32 sum order;
    # uint8 truncation can move a value by one level (0 differ on the CPU)
    diff = np.abs(ct.astype(int) - cj.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[mesh] ")][-1]
    assert f'"vertices": {len(vt)}' in line and f'"faces": {len(tt)}' in line


def test_vol_only_matches_jax(scene, mesh_ckpt, tmp_path):
    argv = ["--root_dir", scene, "--img_wh", "16", "16", "--chunk", "512",
            "--ckpt_path", mesh_ckpt, "--N_grid", "16", "--x_range", "-1",
            "1", "--y_range", "-0.8", "1.2", "--vol_only"]
    ref = jmesh.run(jmesh.get_opts(argv + ["--vol_path", str(tmp_path / "j.vol")]))
    out = mesh_main(argv + ["--vol_path", str(tmp_path / "t.vol"), "--device",
                            "cpu"])
    assert out == str(tmp_path / "t.vol")
    gj, rj = jmu.read_vol(ref)
    gt, rt = mesh_utils.read_vol(out)
    assert gt.shape == (16, 16, 16) and gt.max() > 0
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a, b)
    # each payload byte rounds 255 sigma / sigma_max: a 1e-7 sigma difference
    # can move a byte that sits at a .5 by one level (none on the CPU)
    pj = np.round(gj * 255 / gj.max())
    pt = np.round(gt * 255 / gt.max())
    assert np.abs(pt - pj).max() <= 1
    assert not (tmp_path / "t.ply").exists()


def test_images_are_read_as_pil_reads_them(scene, tmp_path):
    """RGBA PNGs lose their alpha without blending, then LANCZOS to the
    tool's size, bit for bit against PIL."""
    import glob

    for path in sorted(glob.glob(f"{scene}/r_train_*.png")):
        for wh in ((16, 16), (11, 11)):
            ref = np.array(Image.open(path).convert("RGB").resize(
                wh, Image.LANCZOS))
            np.testing.assert_array_equal(extract_mesh._read_rgb(path, wh), ref)


def test_cli_flags_and_cuda_default(mesh_ckpt):
    """Every flag of the JAX tool parses to the same value, plus
    ``--device``, whose default ``cuda`` refuses to run without a card."""
    argv = ["--root_dir", "r", "--ckpt_path", "c"]
    mine, ref = vars(extract_mesh.get_opts(argv)), vars(jmesh.get_opts(argv))
    assert mine.pop("device") == "cuda" and mine == ref
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_main(["--root_dir", "r", "--ckpt_path", mesh_ckpt])
