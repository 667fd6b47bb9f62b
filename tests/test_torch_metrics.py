"""The port's evaluation metrics against the JAX package on the CPU.

Inputs come from a numpy seed and go through the JAX function and its counterpart in
dusty_gan_v2_tpu_torch/metrics; every tolerance is stated where it is used. Random draws
(SWD's patch positions and projection directions, KPD's subsets) are taken once, as
JAX or numpy draws them, and handed to both sides. The fused EMD kernel itself runs only
on a card (chip_smoke.py holds it against its plain version there); here the plain
version is held against the JAX scan and against the Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu.metrics import cov_mmd_1nna as j_cov
from dusty_gan_v2_tpu.metrics import depth as j_depth
from dusty_gan_v2_tpu.metrics import distance as j_dist
from dusty_gan_v2_tpu.metrics import fpd_kpd as j_fpd
from dusty_gan_v2_tpu.metrics import jsd as j_jsd
from dusty_gan_v2_tpu.metrics import pointnet as j_pointnet
from dusty_gan_v2_tpu.metrics import swd as j_swd
from dusty_gan_v2_tpu.metrics.pallas_emd import emd_pallas, emd_pallas_available
from dusty_gan_v2_tpu.ops.pad import _pad_axis as j_pad_axis
from dusty_gan_v2_tpu_torch.convert import load_pointnet_params, pointnet_params_to_state_dict
from dusty_gan_v2_tpu_torch.metrics import cov_mmd_1nna as t_cov
from dusty_gan_v2_tpu_torch.metrics import depth as t_depth
from dusty_gan_v2_tpu_torch.metrics import distance as t_dist
from dusty_gan_v2_tpu_torch.metrics import emd as t_emd
from dusty_gan_v2_tpu_torch.metrics import fpd_kpd as t_fpd
from dusty_gan_v2_tpu_torch.metrics import jsd as t_jsd
from dusty_gan_v2_tpu_torch.metrics import pointnet as t_pointnet
from dusty_gan_v2_tpu_torch.metrics import swd as t_swd
from dusty_gan_v2_tpu_torch.ops import pad_axis
from dusty_gan_v2_tpu_torch.utils import full_float32


def clouds(seed, B, n, kind="rand"):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, n, 3) if kind == "rand" else rng.randn(B, n, 3)
    return x.astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------- distances


@pytest.mark.parametrize("n,m", [(64, 64), (48, 96)])
def test_pairwise_sqdist_matches_jax(n, m):
    x, y = clouds(0, 3, n), clouds(1, 3, m)
    ref = np.asarray(j_dist.pairwise_sqdist(jnp.asarray(x), jnp.asarray(y)))
    got = t_dist.pairwise_sqdist(t(x), t(y)).numpy()
    assert got.shape == (3, n, m) and (got >= 0).all()
    # both are the cancelling |x|^2 + |y|^2 - 2xy form on O(1) coordinates
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_pairwise_sqdist_ignores_the_tf32_switch():
    """No matmul inside: the result is the same bits with TF32 allowed."""
    x, y = t(clouds(2, 2, 32)), t(clouds(3, 2, 40))
    ref = t_dist.pairwise_sqdist(x, y)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert torch.equal(t_dist.pairwise_sqdist(x, y), ref)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_pairwise_sqdist_is_symmetric_in_its_arguments():
    """d(x, y) and d(y, x)^T are the same bits: the kernel's row and column sweeps
    share one distance function, and so must the plain version."""
    x, y = t(clouds(4, 2, 48)), t(clouds(5, 2, 64))
    assert torch.equal(t_dist.pairwise_sqdist(x, y), t_dist.pairwise_sqdist(y, x).transpose(1, 2))


@pytest.mark.parametrize("n,m", [(64, 64), (48, 96)])
def test_chamfer_distance_matches_jax(n, m):
    x, y = clouds(6, 3, n), clouds(7, 3, m)
    ref = j_dist.chamfer_distance(jnp.asarray(x), jnp.asarray(y))
    got = t_dist.chamfer_distance(t(x), t(y))
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    for g, r in zip(got[2:], ref[2:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("n,m", [(48, 48), (48, 96), (96, 48)])
def test_approx_match_and_cost_match_jax(n, m):
    """n != m exercises the integer multipliers multiL / multiR.

    Single entries of the match (O(1) masses) are what is left after the clamped
    subtractions of nearly equal supplies and demands, and exp(-16384 d) turns the 1e-7
    by which the two d's differ into 1e-3 of K: they agree to 5e-4 absolute (1.1e-4
    seen). The cost, a sum over the whole plan, holds rtol 1e-5, and so do the masses
    each point sends."""
    x, y = clouds(8, 2, n, "randn"), clouds(9, 2, m, "randn")
    j_match = j_dist.approx_match(jnp.asarray(x), jnp.asarray(y))
    t_match = t_dist.approx_match(t(x), t(y))
    assert tuple(t_match.shape) == (2, m, n)
    np.testing.assert_allclose(t_match.numpy(), np.asarray(j_match), rtol=0, atol=5e-4)
    np.testing.assert_allclose(t_match.sum(1).numpy(), np.asarray(j_match.sum(1)), rtol=1e-5, atol=1e-6)
    j_cost = j_dist.match_cost(jnp.asarray(x), jnp.asarray(y), j_match)
    t_cost = t_dist.match_cost(t(x), t(y), t_match)
    np.testing.assert_allclose(t_cost.numpy(), np.asarray(j_cost), rtol=1e-5)


@pytest.mark.parametrize("n,m,kind", [(48, 48, "randn"), (48, 96, "randn"), (96, 48, "randn"), (128, 128, "rand")])
def test_earth_mover_distance_matches_jax(n, m, kind):
    x, y = clouds(10, 2, n, kind), clouds(11, 2, m, kind)
    ref = j_dist.earth_mover_distance(jnp.asarray(x), jnp.asarray(y))
    got = t_dist.earth_mover_distance(t(x), t(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_fused_cost_equals_two_pass_cost():
    x, y = t(clouds(12, 2, 48, "randn")), t(clouds(13, 2, 48, "randn"))
    two_pass = t_dist.match_cost(x, y, t_dist.approx_match(x, y))
    torch.testing.assert_close(t_dist.earth_mover_distance(x, y), two_pass, rtol=1e-5, atol=0)


def test_plain_emd_matches_the_pallas_kernel_in_interpret_mode():
    """2 x 256 points, tm=128, rtol 1e-4: how the JAX package's own test runs the kernel."""
    x, y = clouds(14, 2, 256), clouds(15, 2, 256)
    ref = emd_pallas(jnp.asarray(x), jnp.asarray(y), tm=128, interpret=True)
    got = t_dist.earth_mover_distance(t(x), t(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4)


def test_plain_emd_with_points_on_the_origin():
    """A third of each cloud sits on the origin (dropped rays): d = 0 and K = 1 at every
    level; the cost stays finite and matches the JAX scan (rtol 1e-5)."""
    x, y = clouds(16, 2, 96), clouds(17, 2, 96)
    x[:, ::3], y[:, 1::3] = 0.0, 0.0
    ref = j_dist.earth_mover_distance(jnp.asarray(x), jnp.asarray(y))
    got = t_dist.earth_mover_distance(t(x), t(y))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_emd_of_a_cloud_with_itself_is_small():
    x = t(clouds(18, 2, 64))
    assert float(t_dist.earth_mover_distance(x, x).max()) / 64 < 1e-3


def test_fscore_matches_jax():
    rng = np.random.RandomState(19)
    d1, d2 = (rng.rand(3, 50) * 2e-4).astype(np.float32), (rng.rand(3, 40) * 2e-4).astype(np.float32)
    d1[2], d2[2] = 1.0, 1.0  # no point under the threshold: 0 / 0 -> 0
    ref = j_dist.fscore(jnp.asarray(d1), jnp.asarray(d2))
    got = t_dist.fscore(t(d1), t(d2))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)
    assert float(got[0][2]) == 0.0


@pytest.mark.parametrize("n_x,n_gt,non_reg", [(64, 64, False), (48, 96, False), (96, 48, True)])
def test_dcd_matches_jax(n_x, n_gt, non_reg):
    x, gt = clouds(20, 3, n_x), clouds(21, 3, n_gt)
    ref = j_dist.density_aware_chamfer_distance(jnp.asarray(x), jnp.asarray(gt), non_reg=non_reg)
    got = t_dist.density_aware_chamfer_distance(t(x), t(gt), non_reg=non_reg)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- EMD dispatch


def test_emd_cuda_contract_covers_the_pallas_contract():
    for n in (512, 1024, 2048, 4096):
        assert emd_pallas_available(n, n) and t_emd.emd_cuda_available(n, n)
    assert t_emd.emd_cuda_available(48, 96) and t_emd.emd_cuda_available(1, 1)
    assert not t_emd.emd_cuda_available(8192, 8192)
    assert not t_emd.emd_cuda_available(0, 16)


def test_emd_dispatcher_takes_the_plain_version_on_the_cpu_and_counts_it():
    x, y = t(clouds(22, 2, 32)), t(clouds(23, 2, 32))
    before, launches = t_emd.emd_cost.plain_route, t_emd.emd_cuda.launches
    got = t_emd.emd_cost(x, y)
    assert t_emd.emd_cost.plain_route == before + 1 and t_emd.emd_cuda.launches == launches
    assert torch.equal(got, t_dist.earth_mover_distance(x, y))


def test_emd_cuda_rejects_cpu_tensors_and_bad_shapes():
    x = t(clouds(24, 2, 32))
    with pytest.raises(ValueError):
        t_emd.emd_cuda(x, x)
    with pytest.raises(ValueError):
        t_emd.emd_cost(x.to("meta"), x.to("meta"))


def test_compute_fns_match_jax():
    x, y = clouds(25, 4, 64), clouds(26, 4, 64)
    for name in ("cd", "emd", "dcd"):
        ref = np.asarray(j_cov._FNS[name](jnp.asarray(x), jnp.asarray(y)))
        got = t_cov._FNS[name](t(x), t(y)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7, err_msg=name)
    with pytest.raises(ValueError):
        t_cov.compute_emd(t(x), t(clouds(27, 4, 32)))


# --------------------------------------------------------------------------- COV / MMD / 1-NNA


def _matrices(seed, n_ref, n_gen):
    rng = np.random.RandomState(seed)
    sym = lambda a: (a + a.T) / 2  # noqa: E731
    return sym(rng.rand(n_ref, n_ref)), rng.rand(n_ref, n_gen), sym(rng.rand(n_gen, n_gen))


@pytest.mark.parametrize("n_ref,n_gen", [(12, 12), (9, 14)])
def test_cov_mmd_and_nna_match_jax_exactly(n_ref, n_gen):
    M_rr, M_rg, M_gg = _matrices(28, n_ref, n_gen)
    assert t_cov._compute_cov_mmd(M_rg) == j_cov._compute_cov_mmd(M_rg)
    for sqrt in (False, True):
        assert t_cov._compute_nna(M_rr, M_rg, M_gg, 1, sqrt) == j_cov._compute_nna(M_rr, M_rg, M_gg, 1, sqrt)


def test_pairwise_distance_matches_jax_with_a_tail_chunk():
    """6 x 5 clouds in chunks of 8: three full chunks and a tail of 6 pairs."""
    ref_set, gen_set = clouds(29, 6, 64), clouds(30, 5, 64)
    names = ("cd", "emd", "dcd")
    ref = j_cov._pairwise_distance(ref_set, gen_set, 8, names, verbose=False)
    got = t_cov._pairwise_distance(ref_set, gen_set, 8, names, device="cpu")
    for name in names:
        assert got[name].shape == (6, 5) and got[name].dtype == np.float32
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-5, atol=1e-7, err_msg=name)
    # entry (i, j) is the distance of ref_set[i] to gen_set[j]
    one = t_cov.compute_cd(t(ref_set[4:5]), t(gen_set[2:3]))
    np.testing.assert_allclose(got["cd"][4, 2], float(one), rtol=1e-6)


@pytest.mark.parametrize("names", [("cd",), ("emd",), ("cd", "dcd")])
def test_compute_cov_mmd_1nna_matches_jax(names):
    ref_set = clouds(33, 8, 48)
    gen_set = ref_set[::-1] + clouds(34, 8, 48, "randn") * 0.05
    ref = j_cov.compute_cov_mmd_1nna(gen_set, ref_set, 12, names, verbose=False)
    got = t_cov.compute_cov_mmd_1nna(gen_set, ref_set, 12, names, device="cpu")
    assert set(got) == set(ref)
    for key, value in ref.items():
        if "mmd" in key:
            np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)
        else:  # coverage and the 1-NNA counts are discrete
            assert got[key] == value, key


def test_compute_cov_mmd_1nna_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        t_cov.compute_cov_mmd_1nna(clouds(35, 2, 8), clouds(36, 2, 8), 4, ("cd",))
    with pytest.raises(TypeError):
        t_cov.compute_cov_mmd_1nna(clouds(35, 2, 8), clouds(36, 2, 8), 4, ["cd"], device="cpu")


# --------------------------------------------------------------------------- JSD


def _sphere_clouds(seed, B, n):
    x = clouds(seed, B, n, "randn")
    return (x / np.linalg.norm(x, axis=2, keepdims=True) * np.random.RandomState(seed).rand(B, n, 1) * 0.5).astype(np.float32)


def test_grid_and_entropy_match_jax():
    g_t, s_t = t_jsd.unit_cube_grid_point_cloud(8, True)
    g_j, s_j = j_jsd.unit_cube_grid_point_cloud(8, True)
    np.testing.assert_array_equal(g_t, g_j)
    assert s_t == s_j
    pcs = _sphere_clouds(37, 5, 200)
    e_j, c_j = j_jsd.entropy_of_occupancy_grid(pcs, resolution=8, batch_size=2)
    e_t, c_t = t_jsd.entropy_of_occupancy_grid(pcs, resolution=8, batch_size=2, device="cpu")
    np.testing.assert_array_equal(c_t, c_j)  # votes are integers
    assert abs(e_t - e_j) <= 1e-6


@pytest.mark.parametrize("resolution", [8, 28])
def test_compute_jsd_matches_jax(resolution):
    a, b = _sphere_clouds(38, 6, 128), _sphere_clouds(39, 6, 128) * 0.7
    ref = j_jsd.compute_jsd(a, b, resolution=resolution)
    got = t_jsd.compute_jsd(a, b, resolution=resolution, device="cpu")
    assert abs(got - ref) <= 1e-6
    assert abs(t_jsd.compute_jsd(a, a, resolution=resolution, device="cpu")) <= 1e-6


def test_jsd_warns_outside_the_unit_cube():
    with pytest.warns(UserWarning):
        t_jsd.entropy_of_occupancy_grid(clouds(40, 2, 16) * 3.0, resolution=4, device="cpu")


# --------------------------------------------------------------------------- SWD


@pytest.mark.parametrize("axis,lo,hi", [(-1, 2, 2), (-2, 1, 3), (-1, 0, 2)])
def test_reflect_pad_matches_jax(axis, lo, hi):
    x = clouds(41, 2, 5 * 6).reshape(2, 3, 5, 6)
    ref = j_pad_axis(jnp.asarray(x), axis, lo, hi, "reflect")
    np.testing.assert_array_equal(pad_axis(t(x), axis, lo, hi, "reflect").numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        pad_axis(t(x), -2, 5, 0, "reflect")


def _images(seed, B, C=1, H=32, W=64):
    return np.random.RandomState(seed).rand(B, C, H, W).astype(np.float32)


def test_pyramid_ops_match_jax():
    x = _images(42, 2, C=2)
    np.testing.assert_allclose(t_swd.pyramid_down(t(x)).numpy(), np.asarray(j_swd.pyramid_down(jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_swd.pyramid_up(t(x)).numpy(), np.asarray(j_swd.pyramid_up(jnp.asarray(x))),
                               rtol=0, atol=1e-5)


def test_laplacian_pyramid_matches_jax():
    x = _images(43, 2)
    ref = j_swd.laplacian_pyramid(jnp.asarray(x), 3)
    got = t_swd.laplacian_pyramid(t(x), 3)
    assert [tuple(g.shape) for g in got] == [(2, 1, 32, 64), (2, 1, 16, 32), (2, 1, 8, 16)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)


def test_extract_patches_and_finalize_match_jax_with_its_indices():
    x = _images(44, 3, C=2, H=16, W=24)
    key = jax.random.PRNGKey(3)
    inds = np.asarray(jax.random.permutation(key, (16 - 7 + 1) * (24 - 7 + 1))[:20])
    ref = j_swd._extract_patches(jnp.asarray(x), (7, 7), 20, key)
    got = t_swd._extract_patches(t(x), (7, 7), inds)
    assert tuple(got.shape) == (3, 20, 2, 7, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(t_swd._finalize(got).numpy(), np.asarray(j_swd._finalize(ref)), rtol=0, atol=1e-5)


def test_swd_matches_jax_with_its_directions():
    rng = np.random.RandomState(45)
    d1, d2 = rng.randn(300, 49).astype(np.float32), (rng.randn(300, 49) * 1.3 + 0.2).astype(np.float32)
    key = jax.random.PRNGKey(5)
    dirs = [np.asarray(jax.random.normal(jax.random.fold_in(key, r), (49, 16))) for r in range(3)]
    ref = float(j_swd._swd(jnp.asarray(d1), jnp.asarray(d2), 3, 16, key))
    got = float(t_swd._swd(t(d1), t(d2), 3, 16, dirs=dirs))
    assert abs(got - ref) <= 1e-5


def test_compute_swd_matches_jax_with_its_draws():
    """Two batches of 4 images, two pyramid levels; patch positions and directions as
    the JAX implementation derives them from its key.

    Relative 1e-4: the parts agree to 1e-5 (tests above), but on the smooth top level
    the float32 mean of jnp.mean on the CPU is 2e-6 off the float64 value (torch's is
    exact to 1e-8), and standardising 49 strongly correlated pixels by a small std
    carries that into the sorted projections (2.7e-5 seen on a score of 1.02)."""
    a, b = _images(46, 8), _images(47, 8) ** 2
    key = jax.random.PRNGKey(7)
    kw = dict(num_levels=2, patch_size=(7, 7), num_patches=16, dir_repeats=2, dirs_per_repeat=8, batch_size=4)
    ref = j_swd.compute_swd(a, b, rng=key, **kw)
    sizes = [(32 - 6) * (64 - 6), (16 - 6) * (32 - 6)]
    patch_inds = [
        [np.asarray(jax.random.permutation(jax.random.fold_in(jax.random.fold_in(key, i), lvl), sizes[lvl])[:16])
         for lvl in range(2)]
        for i in (0, 4)
    ]
    dirs = [
        [np.asarray(jax.random.normal(jax.random.fold_in(jax.random.fold_in(key, 777 + lvl), r), (49, 8)))
         for r in range(2)]
        for lvl in range(2)
    ]
    got = t_swd.compute_swd(t(a), t(b), patch_inds=patch_inds, dirs=dirs, **kw)
    assert set(got) == set(ref) == {"swd-16", "swd-32", "swd-mean"}
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), k


def test_compute_swd_draws_from_its_generator():
    a, b = t(_images(48, 4)), t(_images(49, 4) ** 2)
    kw = dict(num_patches=16, dir_repeats=2, dirs_per_repeat=8)
    one = t_swd.compute_swd(a, b, generator=torch.Generator().manual_seed(1), **kw)
    two = t_swd.compute_swd(a, b, generator=torch.Generator().manual_seed(1), **kw)
    other = t_swd.compute_swd(a, b, generator=torch.Generator().manual_seed(2), **kw)
    assert one == two and one != other and set(one) == {"swd-16", "swd-32", "swd-mean"}
    assert one == t_swd.compute_swd(a, b, generator=torch.Generator().manual_seed(1), batch_size=4, **kw)
    same = t_swd.compute_swd(a, a, **kw)
    assert same["swd-mean"] == 0.0 and one["swd-mean"] > 0.0


# --------------------------------------------------------------------------- PointNet, FPD / KPD, depth


def _seeded_pointnet_params(seed):
    """The JAX init for the tree; every leaf from numpy, the BN statistics randomised
    so that eval-mode batch norm is exercised."""
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray, j_pointnet.init_pointnet_params(jax.random.PRNGKey(0)))

    def draw(path, a):
        name = path[-1].key
        if name == "running_var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name == "running_mean":
            return (rng.randn(*a.shape) * 0.5).astype(np.float32)
        if name == "weight" and a.ndim == 1:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "weight":
            return (rng.randn(*a.shape) / np.sqrt(a.shape[1])).astype(np.float32)
        return (rng.randn(*a.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def test_pointnet_matches_jax_on_converted_weights():
    params = _seeded_pointnet_params(50)
    model = load_pointnet_params(t_pointnet.PointNetFeatures(), params)
    x = clouds(51, 3, 3 * 96, "randn").reshape(3, 3, 96 * 3)
    ref = np.asarray(j_pointnet.pointnet_features(params, jnp.asarray(x)))
    got = model(t(x)).numpy()
    assert got.shape == (3, t_pointnet.FEATURE_DIM) == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)  # the JAX test's bar


def test_pointnet_conversion_is_strict_and_takes_conv1d_weights():
    params = _seeded_pointnet_params(52)
    sd = pointnet_params_to_state_dict(params)
    model = t_pointnet.PointNetFeatures()
    assert set(sd) == set(model.state_dict())
    as_conv1d = jax.tree_util.tree_map(lambda a: a, params)
    as_conv1d["feat"]["conv1"]["weight"] = params["feat"]["conv1"]["weight"][..., None]
    assert torch.equal(pointnet_params_to_state_dict(as_conv1d)["feat.conv1.weight"], sd["feat.conv1.weight"])
    del as_conv1d["feat"]["stn"]["bn4"]
    with pytest.raises(RuntimeError):
        load_pointnet_params(model, as_conv1d)


def test_pointnet_loads_a_local_state_dict(tmp_path):
    """A SpareNet-style file: Conv1d weights (O, I, 1) and num_batches_tracked entries."""
    src = load_pointnet_params(t_pointnet.PointNetFeatures(), _seeded_pointnet_params(53))
    sd = {}
    for key, val in src.state_dict().items():
        sd[key] = val[..., None] if "conv" in key and key.endswith("weight") else val
        if key.endswith("running_var"):
            sd[key.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    path = tmp_path / "cls_model.pth"
    torch.save({"state_dict": sd}, path)
    model = t_pointnet.build_pointnet("cpu", seed=9, state_dict_path=str(path))
    x = t(clouds(54, 2, 3 * 40, "randn").reshape(2, 3, 120))
    assert torch.equal(model(x), src(x))


def test_pointnet_is_seeded_frozen_and_permutation_invariant():
    a, b, c = (t_pointnet.PointNetFeatures(seed=s) for s in (0, 0, 1))
    x = t(clouds(55, 2, 3 * 64, "randn").reshape(2, 3, 192))
    assert torch.equal(a(x), b(x)) and not torch.equal(a(x), c(x))
    assert not a.train().training and not any(p.requires_grad for p in a.parameters())
    perm = torch.from_numpy(np.random.RandomState(56).permutation(192))
    torch.testing.assert_close(a(x[:, :, perm]), a(x), rtol=1e-4, atol=1e-4)


def test_frechet_distance_matches_jax():
    rng = np.random.RandomState(57)
    f, g = rng.randn(200, 12), rng.randn(150, 12) * 1.2 + 0.3
    assert t_fpd.compute_frechet_distance(f, g) == pytest.approx(j_fpd.compute_frechet_distance(f, g), rel=1e-12)


def test_frechet_distance_regularises_when_the_root_is_not_finite(monkeypatch):
    """40 samples of 60 features: singular covariances. Where SciPy's root comes back
    NaN (newer versions do on a singular product) the covariances get 1e-6 on their
    diagonals, and the distance stays finite and close to the unregularised one."""
    rng = np.random.RandomState(60)
    f, g = rng.randn(40, 60), rng.randn(40, 60) + 0.1
    plain = t_fpd.compute_frechet_distance(f, g)
    real_sqrtm, calls = t_fpd.scipy.linalg.sqrtm, []

    def first_nan(a):
        calls.append(a)
        return np.full_like(a, np.nan) if len(calls) == 1 else real_sqrtm(a)

    monkeypatch.setattr(t_fpd.scipy.linalg, "sqrtm", first_nan)
    regularised = t_fpd.compute_frechet_distance(f, g)
    assert len(calls) == 2 and np.isfinite(regularised)
    if np.isfinite(plain):
        assert regularised == pytest.approx(plain, rel=1e-2)


def test_squared_mmd_matches_jax_with_the_same_seed():
    rng = np.random.RandomState(58)
    f, g = rng.randn(120, 12), rng.randn(90, 12) + 0.2
    np.random.seed(5)  # the JAX package draws from numpy's global state
    ref = j_fpd.compute_squared_mmd(f, g, num_subsets=10, max_subset_size=50)
    got = t_fpd.compute_squared_mmd(f, g, num_subsets=10, max_subset_size=50, rng=np.random.RandomState(5))
    assert got == pytest.approx(ref, rel=1e-12)
    again = t_fpd.compute_squared_mmd(f, g, num_subsets=10, max_subset_size=50)
    assert again == t_fpd.compute_squared_mmd(f, g, num_subsets=10, max_subset_size=50)


@pytest.mark.parametrize("masked", [False, True])
def test_depth_metrics_match_jax(masked):
    rng = np.random.RandomState(59)
    ref_d = (rng.rand(2, 1, 8, 16) * 40 + 1).astype(np.float32)
    gen_d = (ref_d * (1 + 0.3 * rng.randn(2, 1, 8, 16))).clip(0.5).astype(np.float32)
    mask = (rng.rand(2, 1, 8, 16) > 0.3).astype(np.float32) if masked else None
    j_mask = None if mask is None else jnp.asarray(mask)
    t_mask = None if mask is None else t(mask)
    ref = {**j_depth.compute_depth_error(jnp.asarray(ref_d), jnp.asarray(gen_d), j_mask),
           **j_depth.compute_depth_accuracy(jnp.asarray(ref_d), jnp.asarray(gen_d), j_mask)}
    got = {**t_depth.compute_depth_error(t(ref_d), t(gen_d), t_mask),
           **t_depth.compute_depth_accuracy(t(ref_d), t(gen_d), t_mask)}
    assert set(got) == set(ref) == {"abs_rel", "sq_rel", "rmse", "rmse_log", "accuracy_1", "accuracy_2", "accuracy_3"}
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_full_float32_restores_the_switches():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with full_float32():
            assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
