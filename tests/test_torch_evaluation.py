"""The port's evaluation slice as a whole against the same stages of the JAX package on
the CPU: a small generator (as tests/test_torch_generator.py builds it) -> to_outputs
(inverse depth, points, PointNet features, FPS) -> evaluate.

Weights, z and the logistic noise come from numpy seeds and are handed to both sides;
on the CPU the port's FPS and EMD wrappers take their plain versions.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu.geometry import CoordBridge as JCoordBridge
from dusty_gan_v2_tpu.geometry import resize_angle_lut as j_resize_angle_lut
from dusty_gan_v2_tpu.metrics import compute_cov_mmd_1nna as j_compute_cov_mmd_1nna
from dusty_gan_v2_tpu.metrics import compute_jsd as j_compute_jsd
from dusty_gan_v2_tpu.metrics import compute_squared_mmd as j_compute_squared_mmd
from dusty_gan_v2_tpu.metrics import pointnet_features as j_pointnet_features
from dusty_gan_v2_tpu.metrics.fps import downsample_point_clouds as j_downsample
from dusty_gan_v2_tpu.models import build_generator as j_build_generator
from dusty_gan_v2_tpu_torch import evaluation
from dusty_gan_v2_tpu_torch.convert import load_jax_variables, load_pointnet_params
from dusty_gan_v2_tpu_torch.evaluation import Outputs, collect_generated, evaluate, reals_to_outputs, to_outputs
from dusty_gan_v2_tpu_torch.metrics import PointNetFeatures, emd_cost, emd_cuda
from dusty_gan_v2_tpu_torch.models import build_generator
from dusty_gan_v2_tpu_torch.sampling import make_coord_bridge
from test_torch_generator import LUT, RES, SMALL_CFG, _seeded_variables
from test_torch_metrics import _seeded_pointnet_params

N_SET, K = 8, 128
PORT_ROOT = Path(evaluation.__file__).resolve().parent


def _logistic(seed):
    u = np.clip(np.random.RandomState(seed).rand(1, 1, *RES), 1e-6, 1 - 1e-6)
    return (np.log(u) - np.log1p(-u)).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    """Two small generators (the generated set's and the stand-in reference set's), a
    PointNet, and the JAX stages of test_gan.py's to_outputs over them."""
    angle = np.array(j_resize_angle_lut(np.load(LUT), RES))
    jG = j_build_generator(SMALL_CFG)
    pn_params = _seeded_pointnet_params(3)
    jcoord = JCoordBridge(RES[0], RES[1], 1.45, 80.0, angle=angle)
    noise = _logistic(0)

    @jax.jit
    def j_outputs(v, z):
        img = jG.apply(v, z, jnp.asarray(angle), gumbel_noise=jnp.asarray(noise))["image"]
        return j_to_outputs(img)

    def j_to_outputs(img):
        inv = jnp.clip((img + 1.0) / 2.0, 0, 1)
        pts = jcoord.convert(inv, "inv_depth_norm", "point_set") / jcoord.max_depth
        feats = j_pointnet_features(pn_params, pts.transpose(0, 2, 1))
        return inv, j_downsample(pts, K), feats

    sets = {}
    for name, seed in (("gen", 0), ("ref", 1)):
        v = _seeded_variables(jG, jnp.asarray(angle), seed=seed)
        z = np.random.RandomState(10 + seed).randn(N_SET, 16).astype(np.float32)
        tG = load_jax_variables(build_generator(SMALL_CFG, device="cpu"), v)
        sets[name] = (tG, z, tuple(np.asarray(a) for a in j_outputs(v, jnp.asarray(z))))
    pointnet = load_pointnet_params(PointNetFeatures(), pn_params)
    t_angle = torch.from_numpy(angle)
    return {
        "sets": sets, "pointnet": pointnet, "angle": t_angle, "coord": make_coord_bridge(t_angle),
        "noise": torch.from_numpy(noise), "jcoord": jcoord, "j_to_outputs": jax.jit(j_to_outputs),
    }


def _collect(world, name, **kw):
    tG, z, _ = world["sets"][name]
    kw.setdefault("pointnet", world["pointnet"])
    return collect_generated(
        tG, world["angle"], world["coord"], n=N_SET, batch_size=3, num_points=K,
        fixed_logistic=world["noise"], z=torch.from_numpy(z), **kw,
    )


@pytest.mark.parametrize("name", ["gen", "ref"])
def test_collect_generated_matches_the_jax_stages(world, name):
    """Batches of 3, 3, 2 through generate -> to_outputs: images and clouds within 1e-4
    (the generator's bar), features within the PointNet bar."""
    j_inv, j_small, j_feats = world["sets"][name][2]
    out = _collect(world, name)
    assert tuple(out.images.shape) == (N_SET, 1, *RES) and tuple(out.points.shape) == (N_SET, K, 3)
    np.testing.assert_allclose(out.images.numpy(), j_inv, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.points.numpy(), j_small, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.features.numpy(), j_feats, rtol=1e-3, atol=1e-3)


def test_collect_generated_keeps_images_and_clouds_for_the_subsample_only(world):
    full = _collect(world, "gen")
    part = _collect(world, "gen", num_subsample=4)
    assert part.images.shape[0] == part.points.shape[0] == 4 and part.features.shape[0] == N_SET
    assert torch.equal(part.images, full.images[:4]) and torch.equal(part.features, full.features)
    none = _collect(world, "gen", num_subsample=0, pointnet=None)
    assert none.images.shape[0] == none.points.shape[0] == 0 and tuple(none.features.shape) == (N_SET, 0)


def test_collect_generated_draws_z_and_noise_from_its_seed(world):
    tG = world["sets"]["gen"][0]
    args = (tG, world["angle"], world["coord"])
    a = collect_generated(*args, n=4, batch_size=3, num_points=K, seed=5)
    b = collect_generated(*args, n=4, batch_size=3, num_points=K, seed=5)
    c = collect_generated(*args, n=4, batch_size=3, num_points=K, seed=6)
    assert torch.equal(a.images, b.images) and not torch.equal(a.images, c.images)
    dropped = float((a.images == 0).float().mean())
    assert 0.0 < dropped < 1.0


def test_reals_to_outputs_matches_the_jax_stages(world):
    rng = np.random.RandomState(20)
    depth = (rng.rand(4, 1, *RES) * 100.0).astype(np.float32)  # some beyond max_depth
    mask = (rng.rand(4, 1, *RES) > 0.25).astype(np.float32)
    jc = world["jcoord"]
    x = jc.convert(jnp.asarray(depth), "depth", "inv_depth_norm") * 2.0 - 1.0
    x = jnp.asarray(mask) * x + (1 - jnp.asarray(mask)) * -1.0
    j_inv, j_small, j_feats = (np.asarray(a) for a in world["j_to_outputs"](x))
    out = reals_to_outputs(torch.from_numpy(depth), torch.from_numpy(mask), world["coord"],
                           raydrop_const=-1, pointnet=world["pointnet"], num_points=K)
    np.testing.assert_allclose(out.images.numpy(), j_inv, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.points.numpy(), j_small, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.features.numpy(), j_feats, rtol=1e-3, atol=1e-3)


def test_to_outputs_without_a_pointnet(world):
    img = torch.from_numpy(np.random.RandomState(21).rand(2, 1, *RES).astype(np.float32) * 2 - 1)
    out = to_outputs(img, world["coord"], None, K)
    assert tuple(out.features.shape) == (2, 0) and tuple(out.points.shape) == (2, K, 3)
    assert float(out.images.min()) >= 0.0 and float(out.images.max()) <= 1.0


def test_evaluate_matches_the_jax_stages(world):
    """8 + 8 clouds of 128 points: JSD (with its / 2), 1-NNA over CD and EMD. Scores
    within 1e-4; coverage and the 1-NNA counts are discrete and must be equal."""
    gen, ref = _collect(world, "gen"), _collect(world, "ref")
    j_gen, j_ref = world["sets"]["gen"][2], world["sets"]["ref"][2]
    expected = {"jsd": j_compute_jsd(j_gen[1] / 2.0, j_ref[1] / 2.0)}
    for dist in ("cd", "emd"):
        expected.update(j_compute_cov_mmd_1nna(j_gen[1], j_ref[1], batch_size=24, metrics=(dist,)))
    plain, launches = emd_cost.plain_route, emd_cuda.launches
    times = {}
    got = evaluate(gen, ref, metrics=("jsd", "1nna-cd", "1nna-emd"), pairwise_batch=24, device="cpu",
                   stage_times=times)
    # on the CPU every EMD chunk goes the plain route: 3 matrices x ceil(64 / 24) chunks
    assert emd_cost.plain_route - plain == 9 and emd_cuda.launches == launches
    assert list(times) == ["jsd", "1nna-cd", "1nna-emd"] and all(v >= 0 for v in times.values())
    assert set(got) == set(expected)
    for key, value in expected.items():
        if key == "jsd" or "mmd" in key:
            assert abs(got[key] - value) <= 1e-4, (key, got[key], value)
        else:
            assert got[key] == value, (key, got[key], value)


def test_evaluate_features_kpd_scale_and_train_features(world):
    """KPD is the squared MMD times 1000 with the subsets of RandomState(seed); FPD and
    KPD read `train_features` when given."""
    rng = np.random.RandomState(22)
    feats = lambda n, shift: torch.from_numpy((rng.randn(n, 6) + shift).astype(np.float32))  # noqa: E731
    empty = torch.zeros(0, 1, *RES), torch.zeros(0, K, 3)
    gen, ref = Outputs(*empty, feats(40, 0.0)), Outputs(*empty, feats(30, 0.5))
    got = evaluate(gen, ref, metrics=("fpd", "kpd"), device="cpu", seed=4)
    np.random.seed(4)
    expected = j_compute_squared_mmd(gen.features.numpy(), ref.features.numpy()) * 1000.0
    assert got["kpd"] == pytest.approx(expected, rel=1e-9) and np.isfinite(got["fpd"])
    train = feats(50, 2.0)
    other = evaluate(gen, ref, metrics=("fpd", "kpd"), train_features=train, device="cpu", seed=4)
    assert other["fpd"] > got["fpd"] and other["kpd"] > got["kpd"]


def test_evaluate_swd_reads_the_images_and_prints_stage_times(world, capsys):
    gen, ref = _collect(world, "gen"), _collect(world, "ref")
    big = lambda o: Outputs(o.images.repeat(1, 1, 2, 1), o.points, o.features)  # noqa: E731  16 x 64
    got = evaluate(big(gen), big(ref), metrics=("swd",), device="cpu")
    assert set(got) == {"swd-16", "swd-mean"} and got["swd-mean"] > 0
    assert "[t] swd:" in capsys.readouterr().out
    assert got == evaluate(big(gen), big(ref), metrics=("swd",), device="cpu")


def test_evaluate_defaults_to_the_card_and_rejects_unknown_metrics(world, monkeypatch):
    gen = _collect(world, "gen", pointnet=None)
    with pytest.raises(ValueError):
        evaluate(gen, gen, metrics=("jsd", "fid"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        evaluate(gen, gen, metrics=("jsd",))
    assert evaluation.DEFAULT_METRICS == ("swd", "jsd", "1nna-emd", "fpd", "kpd")


def test_port_rule_covers_the_evaluation_modules():
    """The no-JAX rule of test_torch_ops.py scans the whole package: the modules of
    this slice are in it, and so is a source for every kernel kernels.py builds."""
    from dusty_gan_v2_tpu_torch import kernels
    from test_torch_ops import PORT_DIR, test_port_imports_no_jax

    names = {p.relative_to(PORT_DIR).as_posix() for p in PORT_DIR.rglob("*.py")}
    assert {"evaluation.py", "metrics/emd.py", "metrics/distance.py", "metrics/cov_mmd_1nna.py", "metrics/jsd.py",
            "metrics/swd.py", "metrics/pointnet.py", "metrics/fpd_kpd.py", "metrics/depth.py"} <= names
    test_port_imports_no_jax()
    assert kernels.SOURCES == ("fused_bias_act", "fps", "emd", "fused_chain")
    assert all((kernels.CSRC / f"{name}.cu").is_file() for name in kernels.SOURCES)


def test_nvcc_flags_are_per_source():
    """fps.cu's index parity needs --fmad=false (and fused_bias_act keeps the flags it
    was built with); emd.cu pins its distance with intrinsics and leaves FMA on, takes
    expf for its exponential and the cost's square root as an approximate PTX instruction
    written in the source (no fast-math flag changes anything else in it)."""
    from dusty_gan_v2_tpu_torch.kernels import NVCC_FLAGS

    with_fmad_off = ("-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false "
                     "-shared -Xcompiler -fPIC -Xptxas -v")
    assert " ".join(NVCC_FLAGS["fps"]) == " ".join(NVCC_FLAGS["fused_bias_act"]) == with_fmad_off
    assert " ".join(NVCC_FLAGS["emd"]) == with_fmad_off.replace(" --fmad=false", "")
    assert NVCC_FLAGS["fused_chain"] == NVCC_FLAGS["emd"]  # pins its activation, FMA in its products
    emd_src = (PORT_ROOT / "csrc" / "emd.cu").read_text()
    for needle in ("__fmul_rn", "__fadd_rn", "__fsub_rn", "expf(", "sqrt.approx.f32",
                   "cudaFuncAttributeMaxDynamicSharedMemorySize"):
        assert needle in emd_src, needle
    assert "__expf" not in emd_src and "use_fast_math" not in " ".join(NVCC_FLAGS["emd"])
