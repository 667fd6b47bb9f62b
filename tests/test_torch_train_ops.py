"""The port's train-mode ops and generator against the JAX package on the CPU.

The ops the training step adds (the fractional circular shift, the warmup blur, the
resample sum of squares, a numpy upfirdn, the Fourier azimuth rotation, modconv's
shared rotation and ema_var update) are held to 1e-5, and the small generator of
tests/test_torch_generator.py in train mode, on converted weights with the azimuth
shift and the logistic noise injected, to 1e-4 on its images and 1e-5 relative on its
updated buffers (w_avg, every ema_var)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu.models import build_generator as j_build_generator
from dusty_gan_v2_tpu.models import build_pe_cache as j_build_pe_cache
from dusty_gan_v2_tpu.models import dusty_v2 as jdusty_v2
from dusty_gan_v2_tpu.ops import FourierFeature as JFourierFeature
from dusty_gan_v2_tpu.ops import ModConv2d as JModConv2d
from dusty_gan_v2_tpu.ops import make_resample as j_make_resample
from dusty_gan_v2_tpu.ops import pad as jpad
from dusty_gan_v2_tpu.ops import shift as jshift
from dusty_gan_v2_tpu.training.trainer import make_blur_kernel
from dusty_gan_v2_tpu_torch import ops
from dusty_gan_v2_tpu_torch.convert import flatten_variables, load_jax_variables
from dusty_gan_v2_tpu_torch.models import build_generator, build_pe_cache
from dusty_gan_v2_tpu_torch.parallel import PerSampleStream, ReplayStream, global_ids

from test_torch_generator import LUT, RES, SMALL_CFG, _seeded_variables

jresample = importlib.import_module("dusty_gan_v2_tpu.ops.resample")  # the package exports a function of that name

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The sizes here are tiny: one intra-op thread is as fast, and leaves the cores to
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


# --------------------------------------------------------------------------- streams

def test_global_ids_and_streams():
    assert global_ids(4).tolist() == [0, 1, 2, 3]
    assert global_ids(3, offset=8, rank=1).tolist() == [11, 12, 13]
    gen = torch.Generator().manual_seed(0)
    st = PerSampleStream(5, gen)
    assert st.normal((3,)).shape == (5, 3) and st.uniform().shape == (5,)
    r = st.randint((2,), 0, 2)
    assert r.dtype == torch.int32 and set(r.unique().tolist()) <= {0, 1}
    assert st.bernoulli(0.5, (4,)).dtype == torch.bool
    assert st.with_batch(10).logistic((1, 2)).shape == (10, 1, 2)
    a, b = PerSampleStream(4, torch.Generator().manual_seed(3)), PerSampleStream(4, torch.Generator().manual_seed(3))
    assert torch.equal(a.normal((7,)), b.normal((7,)))


def test_replay_stream_hands_out_in_order_and_checks_shapes():
    u = np.linspace(0, 1, 8, dtype=np.float32).reshape(4, 2)
    rs = ReplayStream([np.ones((4, 3), np.float32), u, np.zeros((8,), np.float32)], n=4)
    assert torch.equal(rs.normal((3,)), torch.ones(4, 3))
    assert torch.equal(rs.bernoulli(0.5, (2,)), torch.from_numpy(u < 0.5))
    assert rs.remaining == 1
    with pytest.raises(ValueError):
        rs.uniform()  # (8,) is not a draw of 4 samples
    assert rs.with_batch(8).uniform().shape == (8,)
    with pytest.raises(RuntimeError):
        rs.uniform()


# --------------------------------------------------------------------------- ops

@pytest.mark.parametrize("impl", ["matmul", "gather"])
def test_fractional_wrap_lerp_matches_jax(impl):
    x = rand(3, 2, 4, 16, seed=1)
    rng = np.random.RandomState(2)
    idx0 = rng.randint(0, 16, (3, 20)).astype(np.int32)
    frac = rng.rand(3, 1, 1, 20).astype(np.float32)
    ref = jshift.fractional_wrap_lerp(jnp.asarray(x), jnp.asarray(idx0), jnp.asarray(frac), impl=impl)
    close(ops.fractional_wrap_lerp(t(x), t(idx0), t(frac)), ref)


def test_circular_translate_w_matches_jax():
    x = rand(4, 2, 3, 32, seed=3)
    delta = np.array([0.0, 3.25, -7.5, 40.9], np.float32)
    close(ops.circular_translate_w(t(x), t(delta)), jdusty_v2.circular_translate_w(jnp.asarray(x), jnp.asarray(delta)))


@pytest.mark.parametrize("sigma,gain", [(2.0, 1.0), (1.0, 1.0), (0.0, 1.0), (2.0, 4.0)])
def test_filter2d_matches_jax(sigma, gain):
    k = make_blur_kernel(sigma, 2.0)
    x = rand(2, 3, 8, 32, seed=4)
    close(ops.filter2d(t(x), k, gain), jpad.filter2d(jnp.asarray(x), jnp.asarray(k), gain))


@pytest.mark.parametrize("shape,up", [((2, 3, 4, 32), 2), ((1, 16, 8, 64), 2), ((2, 2, 6, 10), 1)])
def test_resample_sumsq_matches_jax_and_direct(shape, up):
    x = rand(*shape, seed=5)
    plan, jplan = ops.make_resample(up=up), j_make_resample(up=up)
    s, n = ops.resample_sumsq(t(x), plan)
    js, jn = jresample.resample_sumsq(jnp.asarray(x), jplan)
    assert n == jn
    np.testing.assert_allclose(float(s), float(js), rtol=TOL)
    direct = ops.resample(t(x).double(), plan)
    np.testing.assert_allclose(float(s), float(direct.square().sum()), rtol=TOL)
    assert n == direct.numel()


@pytest.mark.parametrize("kernel_2d", [False, True])
@pytest.mark.parametrize("up,down,pad", [
    ((1, 2), (1, 1), (6, 5, 0, 0)), ((2, 1), (1, 1), (0, 0, 6, 5)), ((1, 1), (1, 2), (-1, -1, 0, 0)),
    ((1, 1), (2, 1), (0, 0, -1, -1)), ((2, 2), (1, 1), (2, 1, 2, 1)), ((1, 2), (1, 1), (-18, -19, 0, 0)),
])
def test_upfirdn2d_matches_jax(kernel_2d, up, down, pad):
    x = rand(2, 1, 8, 40, seed=6)
    k = np.asarray(rand(12, seed=7)).reshape(1, -1)
    if kernel_2d:
        k = np.outer(rand(3, seed=8), k[0])
    ref = jresample.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down, pad=pad)
    got = ops.upfirdn2d(x, k, up=up, down=down, pad=pad)
    assert got.shape == ref.shape
    close(got, ref)


# --------------------------------------------------------------------------- Fourier + modconv

def _j_fourier(res, angle):
    ff = JFourierFeature(resolution=res, num_freqs=16)
    v = ff.init(jax.random.PRNGKey(3), jnp.asarray(angle))
    return ff, v


def _t_fourier(res, v):
    pe = ops.FourierFeature(res, num_freqs=16)
    pe.freqs.copy_(t(v["consts"]["freqs"]))
    pe.phase.copy_(t(v["consts"]["phase"]))
    return pe


def test_fourier_azimuth_rotation_matches_jax():
    res = (8, 64)
    angle = rand(1, 2, *res, seed=9)
    ff, v = _j_fourier(res, angle)
    pe = _t_fourier(res, v)
    shift = np.array([0.0, 1.3, 5.9], np.float32)
    base, (sd, cd) = ff.apply(v, jnp.asarray(angle), azim_shift=jnp.asarray(shift), as_rotation=True)
    tbase, (tsd, tcd) = pe(t(angle), azim_shift=t(shift), as_rotation=True)
    close(tbase, base)
    close(tsd, sd)
    close(tcd, cd)
    # the per-sample shifted volume, from the angle and from a precomputed encoding
    ref = ff.apply(v, jnp.asarray(angle), azim_shift=jnp.asarray(shift))
    close(pe(t(angle), azim_shift=t(shift)), ref)
    close(pe(None, azim_shift=t(shift), precomputed=tbase), ref)
    # shifting the azimuth channel of the grid itself gives the same volume
    shifted = np.repeat(angle, 3, 0)
    shifted[:, 1] += shift[:, None, None]
    close(pe(t(shifted)), ref, 1e-4)


@pytest.mark.parametrize("case", ["shared_only", "split_rotation_stat", "plain_x"])
def test_modconv_train_update_and_rotation_match_jax(case):
    B, mod_ch, pe_ch, x_ch, out_ch = 3, 8, 6, 5, 4
    style = rand(B, mod_ch, seed=10)
    x_lo = rand(B, x_ch, 4, 16, seed=11)
    x_shared = rand(1, pe_ch, 8, 32, seed=12)
    plan, jplan = ops.make_resample(up=2), j_make_resample(up=2)
    sd, cd = np.sin(rand(B, pe_ch // 2, seed=13)), np.cos(rand(B, pe_ch // 2, seed=13))
    kw_j, kw_t = {}, {}
    if case == "shared_only":
        in_ch, xj, xt = pe_ch, None, None
        kw_j = dict(x_shared=jnp.asarray(x_shared))
        kw_t = dict(x_shared=t(x_shared))
    elif case == "split_rotation_stat":
        in_ch, xj, xt = x_ch + pe_ch, jnp.asarray(x_lo), t(x_lo)
        kw_j = dict(x_shared=jnp.asarray(x_shared), shared_rotation=(jnp.asarray(sd), jnp.asarray(cd)),
                    x_op=lambda y: jresample.resample(y, jplan), x_stat=jresample.resample_sumsq(jnp.asarray(x_lo), jplan))
        kw_t = dict(x_shared=t(x_shared), shared_rotation=(t(sd), t(cd)), x_op=lambda y: ops.resample(y, plan),
                    x_stat=ops.resample_sumsq(t(x_lo), plan))
    else:
        in_ch, xj, xt = x_ch, jnp.asarray(x_lo), t(x_lo)
    jm = JModConv2d(in_ch=in_ch, out_ch=out_ch, mod_ch=mod_ch, ksize=1, padding=0, use_bias=False, ema=True)
    v = jm.init(jax.random.PRNGKey(0), xj, jnp.asarray(style), **kw_j)
    rng = np.random.RandomState(14)
    v = jax.tree_util.tree_map(lambda a: np.asarray(rng.randn(*a.shape) * 0.5, np.float32), v)
    v["stats"]["ema_var"] = np.float32(1.7)
    tm = load_jax_variables(ops.ModConv2d(in_ch, out_ch, mod_ch, use_bias=False, ema=True), v)
    ref, mut = jm.apply(v, xj, jnp.asarray(style), train=True, mutable=["stats"], **kw_j)
    got = tm(xt, t(style), train=True, **kw_t)
    close(got, ref, 1e-5)
    np.testing.assert_allclose(float(tm.ema_var), float(mut["stats"]["ema_var"]), rtol=1e-6)
    assert float(tm.ema_var) != 1.7
    # eval mode leaves the buffer alone and divides by it
    before = float(tm.ema_var)
    tm(xt, t(style), **{k: w for k, w in kw_t.items() if k != "x_stat"})
    assert float(tm.ema_var) == before


# --------------------------------------------------------------------------- generator, train mode

@pytest.fixture(scope="module")
def models():
    from dusty_gan_v2_tpu.geometry import resize_angle_lut as j_resize_angle_lut

    angle = np.array(j_resize_angle_lut(np.load(LUT), RES))
    jG = j_build_generator(SMALL_CFG)
    v = _seeded_variables(jG, jnp.asarray(angle), seed=0)
    return jG, v, angle


def _train_inputs(seed, B=3):
    rng = np.random.RandomState(seed)
    z = rng.randn(B, 16).astype(np.float32)
    u = np.clip(rng.rand(B, 1, *RES), 1e-6, 1 - 1e-6)
    shift = rng.rand(B).astype(np.float32)
    return z, (np.log(u) - np.log1p(-u)).astype(np.float32), shift


def _j_train(jG, v, z, angle, noise, shift, monkeypatch, pe_cache=None):
    monkeypatch.setattr(jdusty_v2, "ps_uniform", lambda key, ids, *a, **k: jnp.asarray(shift))
    fn = lambda v, z, n, c: jG.apply(  # noqa: E731
        v, z, jnp.asarray(angle), train=True, gumbel_noise=n, pe_cache=c, rngs={"aug": jax.random.PRNGKey(0)},
        mutable=["stats"],
    )
    return jax.jit(fn)(v, jnp.asarray(z), jnp.asarray(noise), pe_cache)


def _buffers_close(tG, stats):
    ref = flatten_variables({"stats": stats})
    bufs = dict(tG.named_buffers())
    assert set(ref) <= set(bufs)
    for key, a in ref.items():
        np.testing.assert_allclose(bufs[key].numpy(), a, rtol=1e-5, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("use_pe_cache", [False, True])
def test_generator_train_forward_matches_jax(models, monkeypatch, use_pe_cache):
    jG, v, angle = models
    tG = load_jax_variables(build_generator(SMALL_CFG, device="cpu"), v)
    z, noise, shift = _train_inputs(1)
    j_cache = j_build_pe_cache(jG, v, jnp.asarray(angle)) if use_pe_cache else None
    t_cache = build_pe_cache(tG, t(angle)) if use_pe_cache else None
    o_ref, mut = _j_train(jG, v, z, angle, noise, shift, monkeypatch, j_cache)
    o = tG(t(z), None if use_pe_cache else t(angle), gumbel_noise=t(noise), pe_cache=t_cache, train=True,
           aug_shift=t(shift))
    for key in ("image_orig", "raydrop_logit", "w"):
        close(o[key], o_ref[key], 1e-4)
    settled = np.abs(1 / (1 + np.exp(-(np.asarray(o_ref["raydrop_logit"]) + noise))) - 0.5) >= 1e-5
    close(o["image"].detach().numpy()[settled], np.asarray(o_ref["image"])[settled], 1e-4)
    _buffers_close(tG, mut["stats"])
    # the buffers moved, w_avg toward the batch mean of w
    w_avg0 = v["stats"]["w_avg"]
    np.testing.assert_allclose(
        tG.w_avg.numpy(), w_avg0 + 0.005 * (np.asarray(o_ref["w"])[:, 0].mean(0, keepdims=True) - w_avg0), rtol=1e-5
    )
    assert all(float(tG.state_dict()[k]) != float(a) for k, a in flatten_variables({"stats": v["stats"]}).items()
               if k.endswith("ema_var"))


def test_generator_train_gradients_match_jax(models, monkeypatch):
    """The gradient of a readout of the train-mode image with respect to every parameter."""
    jG, v, angle = models
    tG = load_jax_variables(build_generator(SMALL_CFG, device="cpu"), v)
    z, noise, shift = _train_inputs(2)
    wts = rand(3, 1, *RES, seed=15)
    monkeypatch.setattr(jdusty_v2, "ps_uniform", lambda key, ids, *a, **k: jnp.asarray(shift))

    def loss(params):
        o, _ = jG.apply({**v, "params": params}, jnp.asarray(z), jnp.asarray(angle), train=True,
                        gumbel_noise=jnp.asarray(noise), rngs={"aug": jax.random.PRNGKey(0)}, mutable=["stats"])
        return jnp.sum(o["image"] * wts)

    gref = flatten_variables({"params": jax.jit(jax.grad(loss))(v["params"])})
    o = tG(t(z), t(angle), gumbel_noise=t(noise), train=True, aug_shift=t(shift))
    (o["image"] * t(wts)).sum().backward()
    scale = max(float(np.abs(a).max()) for a in gref.values())
    for key, p in tG.named_parameters():
        assert np.abs(p.grad.numpy() - gref[key]).max() <= 1e-4 * scale, key


def test_aug_coords_blitting_and_required_shift(models, monkeypatch):
    jG, v, angle = models
    cfg = {**SMALL_CFG, "synthesis_kwargs": {**SMALL_CFG["synthesis_kwargs"], "aug_coords_blitting": True}}
    jGb = j_build_generator(cfg)
    tG = load_jax_variables(build_generator(cfg, device="cpu"), v)
    z, noise, shift = _train_inputs(3)
    o_ref, _ = _j_train(jGb, v, z, angle, noise, shift, monkeypatch)
    o = tG(t(z), t(angle), gumbel_noise=t(noise), train=True, aug_shift=t(shift))
    close(o["image_orig"], o_ref["image_orig"], 1e-4)
    with pytest.raises(ValueError):
        tG(t(z), t(angle), gumbel_noise=t(noise), train=True)
    # drawn from a generator when not given: shift first, then the logistic noise
    state = {k: b.clone() for k, b in tG.named_buffers()}
    o1 = tG(t(z), t(angle), train=True, generator=torch.Generator().manual_seed(5))
    tG.load_state_dict(state, strict=False)
    gen = torch.Generator().manual_seed(5)
    s = torch.rand(3, generator=gen)
    n = ops.sample_logistic(gen, (3, 1, *RES))
    o2 = tG(t(z), t(angle), train=True, aug_shift=s, gumbel_noise=n)
    assert torch.equal(o1["image_orig"], o2["image_orig"])
