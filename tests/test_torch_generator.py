"""The port's dusty_v2 generator and sampling slice against the JAX package on the CPU.

A small generator (ch_base 4, ch_max 16, 8x64, layers (2, 2)) is initialised in JAX,
its weights are replaced from a numpy seed (with a non-zero w_avg so the truncation
trick is exercised), and the variables are carried into the port by
convert/jax_variables.py. z and the logistic noise are numpy arrays handed to both.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu.geometry import CoordBridge as JCoordBridge
from dusty_gan_v2_tpu.geometry import resize_angle_lut as j_resize_angle_lut
from dusty_gan_v2_tpu.metrics.fps import downsample_point_clouds as j_downsample
from dusty_gan_v2_tpu.models import build_generator as j_build_generator
from dusty_gan_v2_tpu.models import build_pe_cache as j_build_pe_cache
from dusty_gan_v2_tpu.models.dusty_v2 import downsample_angle as j_downsample_angle
from dusty_gan_v2_tpu.ops import make_resample as j_make_resample
from dusty_gan_v2_tpu_torch.convert import flatten_variables, load_jax_variables
from dusty_gan_v2_tpu_torch.metrics import furthest_point_sampling, gather_points
from dusty_gan_v2_tpu_torch.models import build_discriminator, build_generator, build_pe_cache
from dusty_gan_v2_tpu_torch.models.dusty_v2 import downsample_angle
from dusty_gan_v2_tpu_torch.ops import make_resample
from dusty_gan_v2_tpu_torch.sampling import full_disc_cfg, full_gen_cfg, sample, sample_and_downsample

RES = (8, 64)
B = 3
SMALL_CFG = {
    "arch": "dusty_v2",
    "mapping_kwargs": {"in_ch": 16, "out_ch": 16, "depth": 2},
    "synthesis_kwargs": {
        "in_ch": 16,
        "out_ch": ({"name": "image", "ch": 1, "act": "tanh"},
                   {"name": "raydrop_logit", "ch": 1, "act": None}),
        "ch_base": 4, "ch_max": 16, "resolution": RES, "layers": (2, 2),
        "ring": True, "use_noise": False, "aug_coords": True,
    },
    "measurement_kwargs": {"raydrop_const": -1, "gumbel_temperature": 1},
}
LUT = Path(__file__).resolve().parent.parent / "data" / "coords" / "kitti_raw.npy"


def _seeded_variables(G, angle, seed):
    """JAX init for the tree and the Fourier banks; every param and stat from numpy."""
    init = lambda a: G.init(  # noqa: E731
        {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)},
        jnp.zeros((2, 16)), a
    )
    v = jax.jit(init)(angle)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(seed)

    def draw(path, a):
        keys = [p.key for p in path]
        if keys[-1] == "ema_var":
            return np.float32(rng.uniform(0.5, 2.0))
        if keys[-1] == "weight":
            std = 100.0 if "mapping_network" in keys else 1.0  # N(0, 1/lr_mul)
            return (rng.randn(*a.shape) * std).astype(np.float32)
        return (rng.randn(*a.shape) * 0.3).astype(np.float32)  # biases and w_avg

    return {
        "params": jax.tree_util.tree_map_with_path(draw, v["params"]),
        "stats": jax.tree_util.tree_map_with_path(draw, v["stats"]),
        "consts": v["consts"],
    }


@pytest.fixture(scope="module")
def models():
    angle = np.array(j_resize_angle_lut(np.load(LUT), RES))
    jG = j_build_generator(SMALL_CFG)
    v = _seeded_variables(jG, jnp.asarray(angle), seed=0)
    assert np.abs(v["stats"]["w_avg"]).max() > 0.1
    tG = load_jax_variables(build_generator(SMALL_CFG, device="cpu"), v)
    return jG, v, tG, angle


def _j_sample(jG, v, z, angle, psi, noise):
    fn = lambda v, z, n: jG.apply(v, z, jnp.asarray(angle), truncation_psi=psi, gumbel_noise=n)  # noqa: E731
    return jax.jit(fn)(v, jnp.asarray(z), jnp.asarray(noise))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    z = rng.randn(B, 16).astype(np.float32)
    u = np.clip(rng.rand(B, 1, *RES), 1e-6, 1 - 1e-6)
    return z, (np.log(u) - np.log1p(-u)).astype(np.float32)


def _assert_outputs_close(o, ref, z_noise):
    for key in ("image_orig", "raydrop_logit"):
        np.testing.assert_allclose(o[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(o["w"].numpy(), np.asarray(ref["w"]), rtol=1e-5, atol=1e-5)
    # the hard ray-drop mask may differ only where the soft value sits on the threshold
    soft = 1.0 / (1.0 + np.exp(-(np.asarray(ref["raydrop_logit"]) + z_noise)))
    settled = np.abs(soft - 0.5) >= 1e-5
    np.testing.assert_array_equal(o["raydrop_mask"].numpy()[settled], np.asarray(ref["raydrop_mask"])[settled])
    np.testing.assert_allclose(o["image"].numpy()[settled], np.asarray(ref["image"])[settled], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("psi", [0.7, 1.0])
def test_generator_matches_jax(models, psi):
    jG, v, tG, angle = models
    z, noise = _inputs(1)
    ref = _j_sample(jG, v, z, angle, psi, noise)
    o = sample(tG, torch.from_numpy(z), torch.from_numpy(angle), truncation_psi=psi,
               gumbel_noise=torch.from_numpy(noise))
    assert set(o) == set(ref) == {"image", "raydrop_logit", "w", "raydrop_mask", "image_orig"}
    _assert_outputs_close(o, ref, noise)


def test_pe_cache_matches_jax_and_in_call(models):
    jG, v, tG, angle = models
    j_cache = j_build_pe_cache(jG, v, jnp.asarray(angle))
    t_cache = build_pe_cache(tG, torch.from_numpy(angle))
    assert len(t_cache) == len(j_cache) == 3
    for a, b in zip(t_cache, j_cache):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    z, noise = _inputs(2)
    args = (torch.from_numpy(z),)
    kw = dict(truncation_psi=0.7, gumbel_noise=torch.from_numpy(noise))
    cached = sample(tG, *args, None, pe_cache=t_cache, **kw)
    direct = sample(tG, *args, torch.from_numpy(angle), **kw)
    torch.testing.assert_close(cached["image_orig"], direct["image_orig"], rtol=0, atol=0)


def test_downsample_angle_matches_jax():
    angle = np.array(j_resize_angle_lut(np.load(LUT), (16, 128)))
    ref = j_downsample_angle(jnp.asarray(angle), j_make_resample(down=2, ring=True))
    got = downsample_angle(torch.from_numpy(angle), make_resample(down=2, ring=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compute_dtype,num_fp16_layers", [("float32", -1), ("bfloat16", -1), ("bfloat16", 2)])
def test_block_dtypes_match_jax(compute_dtype, num_fp16_layers):
    cfg = copy.deepcopy(SMALL_CFG)
    cfg["compute_dtype"] = compute_dtype
    cfg["synthesis_kwargs"]["num_fp16_layers"] = num_fp16_layers
    jG = j_build_generator(cfg)
    from dusty_gan_v2_tpu.models.dusty_v2 import SynthesisNetwork

    kw = dict(jG.synthesis_kwargs)
    kw.setdefault("compute_dtype", jG.compute_dtype)
    expected = SynthesisNetwork(**kw).block_dtypes()
    tG = build_generator(cfg, device="cpu")
    assert tG.synthesis_network.block_dtypes() == expected
    assert [b.dtype for b in tG.synthesis_network.blocks()] == [
        {"float32": torch.float32, "bfloat16": torch.bfloat16}[d] for d in expected
    ]


def test_bf16_policy_runs_and_tracks_fp32(models):
    """The bfloat16 compute policy on the CPU: finite, and within bf16 noise of fp32.

    The bound is loose by nature: the policy computes the Fourier PE in bfloat16,
    where angle coordinates of magnitude ~64 round to steps of 0.25-0.5 rad, so a
    relative L2 error of a few percent is expected (about 1% at this seed)."""
    _, v, tG, angle = models
    cfg = copy.deepcopy(SMALL_CFG)
    cfg["compute_dtype"] = "bfloat16"
    tG16 = load_jax_variables(build_generator(cfg, device="cpu"), v)
    z, noise = _inputs(3)
    args = (torch.from_numpy(z), torch.from_numpy(angle), 0.7, torch.from_numpy(noise))
    o16, o32 = sample(tG16, *args), sample(tG, *args)
    assert o16["image_orig"].dtype == torch.float32
    assert torch.isfinite(o16["image_orig"]).all()
    rel = (o16["image_orig"] - o32["image_orig"]).norm() / o32["image_orig"].norm()
    assert rel < 0.03, rel


def test_slice_sample_points_fps_matches_jax(models):
    """sample -> inv_depth_norm -> points / max_depth -> FPS, as test_gan.py does."""
    jG, v, tG, angle = models
    z, noise = _inputs(4)
    k = 64
    ref = _j_sample(jG, v, z, angle, 0.7, noise)
    jcoord = JCoordBridge(RES[0], RES[1], 1.45, 80.0, angle=angle)
    j_inv = jnp.clip((ref["image"] + 1.0) / 2.0, 0, 1)
    j_pts = jcoord.convert(j_inv, "inv_depth_norm", "point_set") / jcoord.max_depth
    j_small = j_downsample(j_pts, k)

    from dusty_gan_v2_tpu_torch.sampling import make_coord_bridge

    coord = make_coord_bridge(torch.from_numpy(angle))
    o, inv, small = sample_and_downsample(
        tG, torch.from_numpy(z), torch.from_numpy(angle), coord,
        truncation_psi=0.7, gumbel_noise=torch.from_numpy(noise), k=k,
    )
    assert tuple(small.shape) == (B, k, 3)
    np.testing.assert_allclose(inv.numpy(), np.asarray(j_inv), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(small.numpy(), np.asarray(j_small), rtol=1e-4, atol=1e-4)
    pts = coord.convert(inv, "inv_depth_norm", "point_set") / coord.max_depth
    assert torch.equal(small, gather_points(pts, furthest_point_sampling(pts, k)))


def test_state_dict_keys_are_flax_paths(models):
    _, v, tG, _ = models
    assert set(tG.state_dict()) == set(flatten_variables(v))
    assert "synthesis_network.b1.conv1.mod.weight" in tG.state_dict()
    assert "synthesis_network.b2.head.raydrop_logit.ema_var" in tG.state_dict()


def test_loading_rejects_missing_and_extra_keys(models):
    _, v, _, _ = models
    tG = build_generator(SMALL_CFG, device="cpu")
    missing = copy.deepcopy(v)
    del missing["params"]["synthesis_network"]["b0"]["bias_act1"]
    with pytest.raises(RuntimeError):
        load_jax_variables(tG, missing)
    extra = copy.deepcopy(v)
    extra["stats"]["surplus"] = np.zeros(1, np.float32)
    with pytest.raises(RuntimeError):
        load_jax_variables(tG, extra)
    with pytest.raises(ValueError):
        load_jax_variables(tG, {**v, "noise": {}})


def test_seeded_build_is_deterministic():
    a = build_generator(SMALL_CFG, device="cpu", seed=5).state_dict()
    b = build_generator(SMALL_CFG, device="cpu", seed=5).state_dict()
    c = build_generator(SMALL_CFG, device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["mapping_network.fc0.weight"], c["mapping_network.fc0.weight"])


def test_noise_drawn_from_a_generator(models):
    """Without fixed noise the logistic noise comes from the torch.Generator given."""
    _, _, tG, angle = models
    z = torch.from_numpy(_inputs(5)[0])
    a = sample(tG, z, torch.from_numpy(angle), generator=torch.Generator().manual_seed(7))
    b = sample(tG, z, torch.from_numpy(angle), generator=torch.Generator().manual_seed(7))
    assert torch.equal(a["raydrop_mask"], b["raydrop_mask"])
    assert 0.0 < float(a["raydrop_mask"].mean()) < 1.0
    with pytest.raises(ValueError):
        sample(tG, z, torch.from_numpy(angle))


def test_other_archs_raise():
    """Every shipped arch builds (tests/test_torch_other_archs.py); an unknown one raises."""
    for arch in ("dusty_v3", "stylegan2"):
        with pytest.raises(NotImplementedError):
            build_generator({**full_gen_cfg(), "arch": arch}, device="cpu")
        with pytest.raises(NotImplementedError):
            build_discriminator({**full_disc_cfg(), "arch": arch}, device="cpu")
