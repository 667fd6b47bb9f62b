"""The generator, discriminator and semseg options of the port against the JAX package on
the CPU: the "random_2" and "logscale" Fourier bases, synthesis blocks without a Fourier
PE, style mixing, remat (rematerialized G and D blocks, in the forward, the gradients,
R1's double backward and a whole Trainer.step), and semseg's pool forms and two-pass
BatchNorm moments.

The JAX models are initialised in JAX, every parameter and statistic is drawn anew from a
numpy seed (tests/test_torch_generator.py::_seeded_variables) and carried into the port by
convert/jax_variables.py. Draws the JAX modules make (style mixing's partner latent and
crossover, the azimuth shift, the step's draws) are replaced by given numpy arrays with
pytest's monkeypatch, and the port takes the same arrays. A JAX SynthesisNetwork with a
`layers` entry of 1 fails in its skip resample at scale 1 (resample(skip, None),
dusty_gan_v2_tpu/models/dusty_v2.py:318); the port passes the skip through there, and the
no-PE tests hold it to the JAX network with that one call made the identity. Bars: the
Fourier banks and encodings 1e-6; outputs 1e-4 (styles 1e-5); gradients 1e-4 of their
largest magnitude; the training step as tests/test_torch_trainer.py holds it; pools equal
in value and their gradients 1e-6; BatchNorm 1e-5; the float64 semseg step 1e-8 of the
largest magnitude (tests/test_torch_semseg_e2e.py). The port's remat runs equal its
plain runs to the bit."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

import dusty_gan_v2_tpu.semseg.common as jcommon
import dusty_gan_v2_tpu.semseg.squeezeseg as jsqueezeseg
from dusty_gan_v2_tpu.geometry import resize_angle_lut as j_resize_angle_lut
from dusty_gan_v2_tpu.models import base as jbase
from dusty_gan_v2_tpu.models import build_discriminator as j_build_discriminator
from dusty_gan_v2_tpu.models import build_generator as j_build_generator
from dusty_gan_v2_tpu.models import build_pe_cache as j_build_pe_cache
from dusty_gan_v2_tpu.models import dusty_v2 as jdusty_v2
from dusty_gan_v2_tpu.ops import fourier as jfourier
from dusty_gan_v2_tpu_torch.convert import flatten_variables, load_jax_variables
from dusty_gan_v2_tpu_torch.models import build_discriminator, build_generator, build_pe_cache
from dusty_gan_v2_tpu_torch.models.base import draw_style_mixing
from dusty_gan_v2_tpu_torch.ops import FourierFeature
from dusty_gan_v2_tpu_torch.parallel import PerSampleStream, ReplayStream
from dusty_gan_v2_tpu_torch.semseg import SqueezeSegV2
from dusty_gan_v2_tpu_torch.semseg import common as pcommon
from dusty_gan_v2_tpu_torch.semseg.train_step import SemsegTrainer
from dusty_gan_v2_tpu_torch.training import r1_penalty

from test_torch_generator import LUT, SMALL_CFG, _seeded_variables
from test_torch_other_archs import _g_cfg, _redraw
from test_torch_semseg import flat, fixed_dropout_keys, keep_mask, randomize_bn_stats, rel_err, t, to_flax
from test_torch_semseg_e2e import B as SB
from test_torch_semseg_e2e import _KeepFloat64, jax_step, step_batch, step_cfg
from test_torch_trainer import JaxSide, _cfg, _flat, _jflat, _moments_err, _named, _port, _update_err
from test_trainer import RES

B = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_skip_at_scale_1():
    """JAX's block resamples the skip with its up plan, None at scale 1: the identity there."""
    mp = pytest.MonkeyPatch()
    real = jdusty_v2.resample
    mp.setattr(jdusty_v2, "resample", lambda x, plan, *a, **k: x if plan is None else real(x, plan, *a, **k))
    yield
    mp.undo()


def _angle(res=RES):
    return np.array(j_resize_angle_lut(np.load(LUT), res))


def _gcfg(**syn):
    return {**SMALL_CFG, "synthesis_kwargs": {**SMALL_CFG["synthesis_kwargs"], **syn}}


def _grad_err(got, ref):
    """max |port - JAX| over every tensor, over the largest JAX magnitude."""
    assert got.keys() == ref.keys(), got.keys() ^ ref.keys()
    big = max(float(np.abs(v).max()) for v in ref.values())
    return max(float(np.abs(got[k] - ref[k]).max()) for k in ref) / big


def _port_grads(net):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy() for k, p in net.named_parameters()}


def _jax_grads(g):
    return flatten_variables({"params": jax.tree_util.tree_map(np.asarray, g)})


# ------------------------------------------------------------------------- Fourier banks

def test_fourier_banks_and_encodings_match_jax():
    """Each basis (random, random_2, logscale): the bank (the port's own for logscale,
    JAX's carried across for the random ones, whose own draws must fall on the basis'
    lattice) and the encoding: plain, shifted per sample, and as the rotation pair."""
    for basis in ("random", "random_2", "logscale"):
        _check_fourier(basis)


def _check_fourier(basis):
    res = (8, 64)
    angle = _angle(res)
    jff = jfourier.FourierFeature(resolution=res, basis_scale=basis, num_freqs=32)
    v = jff.init(jax.random.PRNGKey(4), jnp.asarray(angle))
    shift = np.random.RandomState(0).uniform(0, 2 * np.pi, B).astype(np.float32)
    mod = FourierFeature(res, basis, 32)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    freqs, phase = (np.asarray(v["consts"][k]) for k in ("freqs", "phase"))
    assert mod.out_ch == jfourier.fourier_out_ch(32, basis, res) == 2 * freqs.shape[0]
    assert tuple(mod.freqs.shape) == freqs.shape
    if basis == "logscale":
        assert mod.freqs.numpy().tobytes() == freqs.tobytes() and not mod.phase.any() and not phase.any()
    else:
        band_h, band_w = 2.0 ** (mod.L_h - 1), 2.0 ** (mod.L_w - 1)
        own_w = set(mod.freqs[:, 1].tolist())
        lattice = ({0.0} | {s * 2.0**k for k in range(mod.L_w) for s in (1, -1)} if basis == "random"
                   else set(np.arange(-band_w + 1, band_w)))
        assert own_w <= lattice and len(own_w) > 4 and float(mod.freqs[:, 0].abs().max()) <= band_h
        assert set(freqs[:, 1].tolist()) <= lattice
        with torch.no_grad():
            mod.freqs.copy_(t(freqs))
            mod.phase.copy_(t(phase))
    a = jnp.asarray(angle)
    for kw, pkw in (({}, {}), ({"azim_shift": jnp.asarray(shift)}, {"azim_shift": t(shift)})):
        ref, got = jff.apply(v, a, **kw), mod(t(angle), **pkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    ref_base, (ref_s, ref_c) = jff.apply(v, a, azim_shift=jnp.asarray(shift), as_rotation=True)
    got_base, (got_s, got_c) = mod(t(angle), azim_shift=t(shift), as_rotation=True)
    for g, r in ((got_base, ref_base), (got_s, ref_s), (got_c, ref_c)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------------- generators

def _jax_g(cfg, seed=0):
    jG = j_build_generator(cfg)
    v = _seeded_variables(jG, jnp.asarray(_angle()), seed=seed)
    return jG, v, load_jax_variables(build_generator(cfg, device="cpu"), v)


def _g_inputs(seed, style_dim=16):
    rng = np.random.RandomState(seed)
    z = rng.randn(B, style_dim).astype(np.float32)
    u = np.clip(rng.rand(B, 1, *RES), 1e-6, 1 - 1e-6)
    return z, (np.log(u) - np.log1p(-u)).astype(np.float32), rng.randn(2, B, 1, *RES).astype(np.float32)


def _g_compare(jG, v, tG, seed, jkw=None, pkw=None, train=False, stats=False):
    """Outputs (image_orig, raydrop_logit 1e-4, w 1e-5) and the parameter gradients of
    sum(image_orig * r0 + raydrop_logit * r1) (1e-4 of the largest), JAX against the
    port; in train mode the updated statistics too. Returns the port's outputs, gradients
    and buffers."""
    z, gumbel, r = _g_inputs(seed, tG.style_dim)
    angle = _angle()
    jkw, pkw = dict(jkw or {}), dict(pkw or {})

    def f(params):
        kw = dict(truncation_psi=1.0 if train else 0.7, gumbel_noise=jnp.asarray(gumbel), train=train,
                  rngs={"aug": jax.random.PRNGKey(1), "styles": jax.random.PRNGKey(2)}, **jkw)
        if train:
            o, mut = jG.apply({**v, "params": params}, jnp.asarray(z), jnp.asarray(angle), mutable=["stats"], **kw)
        else:
            o, mut = jG.apply({**v, "params": params}, jnp.asarray(z), jnp.asarray(angle), **kw), None
        return jnp.sum(o["image_orig"] * r[0]) + jnp.sum(o["raydrop_logit"] * r[1]), (o, mut)

    (_, (ref, mut)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(v["params"])
    tG.zero_grad(set_to_none=True)
    o = tG(t(z), t(angle), truncation_psi=1.0 if train else 0.7, gumbel_noise=t(gumbel), train=train, **pkw)
    ((o["image_orig"] * t(r[0])).sum() + (o["raydrop_logit"] * t(r[1])).sum()).backward()
    for key, tol in (("image_orig", 1e-4), ("raydrop_logit", 1e-4), ("w", 1e-5)):
        np.testing.assert_allclose(o[key].detach().numpy(), np.asarray(ref[key]), rtol=tol, atol=tol, err_msg=key)
    grads = _port_grads(tG)
    assert _grad_err(grads, _jax_grads(g)) <= 1e-4
    if stats:
        ref_stats = flatten_variables({"stats": jax.tree_util.tree_map(np.asarray, mut["stats"])})
        for k, a in ref_stats.items():
            np.testing.assert_allclose(tG.get_buffer(k).numpy(), a, rtol=1e-4, atol=1e-6, err_msg=k)
    return o, grads, {k: b.clone() for k, b in tG.named_buffers()}


def test_option_generators_match_jax():
    """A G with a block without a Fourier PE (layers (2, 1, 2): block 2 at scale 1), and
    Gs on the logscale and random_2 bases: outputs and gradients on converted weights; the
    PE cache equals JAX's (None for the no-PE block) and gives the in-call output."""
    for option in ("no-pe", "logscale", "random_2"):
        _check_option_generator(option)


def _check_option_generator(option):
    syn = {"no-pe": dict(layers=(2, 1, 2)), "logscale": dict(pe_type="logscale"),
           "random_2": dict(pe_type="random_2")}[option]
    jG, v, tG = _jax_g(_gcfg(**syn))
    blocks = tG.synthesis_network.blocks()
    assert [b.use_pe for b in blocks] == ([True, True, False, True] if option == "no-pe" else [True] * 3)
    o, _, _ = _g_compare(jG, v, tG, seed=1)
    j_cache = j_build_pe_cache(jG, v, jnp.asarray(_angle()))
    t_cache = build_pe_cache(tG, t(_angle()))
    assert [c is None for c in t_cache] == [c is None for c in j_cache] == [not b.use_pe for b in blocks]
    for a, b in zip(t_cache, j_cache):  # through the angle pyramid: tests/test_torch_generator.py's 1e-5
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    z, gumbel, _ = _g_inputs(1)
    with torch.no_grad():
        cached = tG(t(z), None, truncation_psi=0.7, gumbel_noise=t(gumbel), pe_cache=t_cache)
    assert torch.equal(cached["image_orig"], o["image_orig"].detach())


def _patch_mixing(mp, z2, n):
    """JAX's style-mixing draws: the partner latent (ps_normal) and the crossover (the
    scalar jax.random.randint) replaced by the given arrays."""
    real = jax.random.randint

    def randint(key, shape, minval, maxval, *a, **k):
        if tuple(shape) == ():
            assert 1 <= n < maxval, (n, maxval)
            return jnp.asarray(n, jnp.int32)
        return real(key, shape, minval, maxval, *a, **k)

    mp.setattr(jbase, "ps_normal", lambda key, ids, shape, dtype=jnp.float32: jnp.asarray(z2, dtype))
    mp.setattr(jax.random, "randint", randint)


@pytest.fixture(scope="module")
def small_g():
    return _jax_g(SMALL_CFG)


def test_style_mixing_matches_jax(small_g):
    """dusty_v2 (6 styles) with the crossover at 4: outputs and gradients."""
    jG, v, tG = small_g
    z2 = np.random.RandomState(14).randn(B, 16).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _patch_mixing(mp, z2, 4)
        _g_compare(jG, v, tG, seed=2, jkw={"style_mixing": True},
                   pkw={"style_mixing": True, "mixing": (t(z2), torch.tensor(4))})


def _check_crossover(tG, n):
    """The first n styles are z's (truncated toward w_avg), the rest z2's."""
    z, z2 = (torch.randn(B, 16, generator=torch.Generator().manual_seed(s)) for s in (n, 20 + n))
    with torch.no_grad():
        w = tG(z, t(_angle()), truncation_psi=0.7, gumbel_noise=torch.zeros(B, 1, *RES), style_mixing=True,
               mixing=(z2, torch.tensor(n)))["w"]
        w1, w2 = tG.mapping_network(z), tG.mapping_network(z2)
    w_avg = tG.w_avg[None]
    torch.testing.assert_close(w[:, :n], (w_avg + 0.7 * (w1[:, None] - w_avg)).expand(-1, n, -1), rtol=0, atol=0)
    torch.testing.assert_close(w[:, n:], (w_avg + 0.7 * (w2[:, None] - w_avg)).expand(-1, 6 - n, -1), rtol=0, atol=0)


def test_style_mixing_one_style_matches_jax():
    """The one-style generators, vanilla and dusty_v1, take style mixing (the crossover
    is always 1: z's style), as JAX's do."""
    for arch in ("vanilla", "dusty_v1"):
        _check_one_style(arch)


def _check_one_style(arch):
    cfg = _g_cfg(arch, True)
    cfg["synthesis_kwargs"].update(resolution=(32, 64), ch_base=4, ch_max=16)
    jG = j_build_generator(cfg)
    z = np.random.RandomState(3).randn(2, 64).astype(np.float32)
    z2 = np.random.RandomState(4).randn(2, 64).astype(np.float32)
    v = _redraw(jax.jit(lambda: jG.init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
                                        jnp.asarray(z)))(), 5)
    tG = load_jax_variables(build_generator(cfg, device="cpu"), v)
    g = jnp.zeros((2, 1, 32, 64))
    with pytest.MonkeyPatch.context() as mp:
        _patch_mixing(mp, z2, 1)
        ref = jax.jit(lambda v: jG.apply(v, jnp.asarray(z), None, style_mixing=True, gumbel_noise=g,
                                         rngs={"styles": jax.random.PRNGKey(2)}))(v)
    with torch.no_grad():
        o = tG(t(z), style_mixing=True, mixing=(t(z2), torch.tensor(1)), gumbel_noise=t(np.asarray(g)))
        plain = tG(t(z), gumbel_noise=t(np.asarray(g)))
    np.testing.assert_allclose(o["image"].numpy(), np.asarray(ref["image"]), rtol=1e-4, atol=1e-4)
    assert torch.equal(o["image"], plain["image"]) and torch.equal(o["w"], plain["w"])


def test_style_mixing_draws_and_crossover(small_g):
    """draw_style_mixing: a partner latent per sample and one crossover in [1, styles],
    from a PerSampleStream (and in the generator's draw order after the noise), or handed
    in by a ReplayStream; without draws and a generator the forward raises. The styles
    before the crossover are z's, the rest the partner's, at n 1, 4 and 6."""
    _, _, tG = small_g
    for n in (1, 4, 6):
        _check_crossover(tG, n)
    z = torch.randn(B, 16, generator=torch.Generator().manual_seed(0))
    z2, n = draw_style_mixing(PerSampleStream(B, torch.Generator().manual_seed(1)), 16, 6)
    assert tuple(z2.shape) == (B, 16) and n.ndim == 0 and 1 <= int(n) <= 6
    ns = {int(draw_style_mixing(PerSampleStream(B, torch.Generator().manual_seed(s)), 16, 6)[1]) for s in range(40)}
    assert ns == set(range(1, 7))
    rs = ReplayStream([z2.numpy(), np.int32(3)])
    r2, rn = draw_style_mixing(rs, 16, 6)
    assert rs.remaining == 0 and torch.equal(r2, z2) and int(rn) == 3 and rn.dtype == torch.int64
    gum = torch.zeros(B, 1, *RES)
    with torch.no_grad():
        a = tG(z, t(_angle()), gumbel_noise=gum, style_mixing=True, generator=torch.Generator().manual_seed(1))
        b = tG(z, t(_angle()), gumbel_noise=gum, style_mixing=True, mixing=(z2, n))
        assert torch.equal(a["w"], b["w"])
        with pytest.raises(ValueError, match="pass mixing"):
            tG(z, t(_angle()), gumbel_noise=gum, style_mixing=True)
        with pytest.raises(ValueError, match="style_mixing is off"):
            tG(z, t(_angle()), gumbel_noise=gum, mixing=(z2, n))


# ------------------------------------------------------------------------- remat

def test_remat_generator_matches_jax_and_the_plain_port():
    """A train-mode forward (azimuth shift, ema_var and w_avg updates) and its gradients,
    JAX's remat G against the port's on a remat tree loaded unchanged; the port's remat G
    equals its plain G to the bit in outputs, gradients and buffers (each ema_var written
    once)."""
    cfg_r = _gcfg(remat=True)
    jG, v, tG = _jax_g(cfg_r)
    assert tG.synthesis_network.remat
    jG_plain = j_build_generator(SMALL_CFG)
    assert jax.tree_util.tree_structure(v) == jax.tree_util.tree_structure(
        _seeded_variables(jG_plain, jnp.asarray(_angle()), seed=0))  # the flax names do not change
    shift = np.random.RandomState(6).rand(B).astype(np.float32)
    plain = load_jax_variables(build_generator(SMALL_CFG, device="cpu"), v)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdusty_v2, "ps_uniform", lambda key, ids, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0:
                   jnp.asarray(shift))
        o, g, bufs = _g_compare(jG, v, tG, seed=3, train=True, stats=True, pkw={"aug_shift": t(shift)})
    z, gumbel, r = _g_inputs(3)
    op = plain(t(z), t(_angle()), gumbel_noise=t(gumbel), train=True, aug_shift=t(shift))
    ((op["image_orig"] * t(r[0])).sum() + (op["raydrop_logit"] * t(r[1])).sum()).backward()
    assert torch.equal(op["image_orig"], o["image_orig"])
    gp = _port_grads(plain)
    assert all(np.array_equal(gp[k], g[k]) for k in g)
    assert all(torch.equal(b, bufs[k]) for k, b in plain.named_buffers())


D_CFG = {"arch": "dusty_v2", "layer_kwargs": {
    "in_ch": 1, "ring": True, "ch_base": 4, "ch_max": 16, "resolution": RES, "mbdis_group": 3, "mbdis_feat": 1,
    "pre_blur": True}}


def test_remat_discriminator_matches_jax_and_the_plain_port():
    """Logits and R1's penalty with its parameter gradient (a double backward through the
    rematerialized blocks and the chain ops), JAX's remat D against the port's; the port's
    remat D equals its plain D to the bit."""
    cfg_r = {**D_CFG, "layer_kwargs": {**D_CFG["layer_kwargs"], "remat": True}}
    jD = j_build_discriminator(cfg_r)
    x = np.random.RandomState(7).randn(B, 1, *RES).astype(np.float32)
    v = _redraw(jax.jit(lambda: jD.init(jax.random.PRNGKey(0), jnp.asarray(x)))(), 8)
    tD, plain = (load_jax_variables(build_discriminator(c, device="cpu"), v) for c in (cfg_r, D_CFG))
    assert tD.remat and not plain.remat

    def penalty(params):
        gx = jax.grad(lambda xx: jnp.sum(jD.apply({"params": params}, xx, blur_fuse=False)))(jnp.asarray(x))
        return jnp.mean(jnp.sum(gx ** 2, axis=(1, 2, 3)))

    logits = jax.jit(lambda v: jD.apply(v, jnp.asarray(x), blur_fuse=False))(v)
    pen, g = jax.jit(jax.value_and_grad(penalty))(v["params"])
    out = {}
    for name, D in (("remat", tD), ("plain", plain)):
        y = D(t(x), blur_fuse=False)
        p = r1_penalty(D, t(x))
        p.backward()
        out[name] = (y.detach(), p.detach(), _port_grads(D))
    y, p, grads = out["remat"]
    np.testing.assert_allclose(y.numpy(), np.asarray(logits), rtol=1e-4, atol=1e-4)
    assert abs(float(p) - float(pen)) <= 1e-4 * abs(float(pen))
    assert _grad_err(grads, _jax_grads(g)) <= 1e-4
    assert torch.equal(y, out["plain"][0]) and torch.equal(p, out["plain"][1])
    assert all(np.array_equal(grads[k], out["plain"][2][k]) for k in grads)


def _remat_cfg():
    cfg = _cfg()
    cfg.model.generator.synthesis_kwargs.remat = True
    cfg.model.discriminator.layer_kwargs.remat = True
    return cfg


@pytest.fixture(scope="module")
def remat_side():
    mp = pytest.MonkeyPatch()
    side = JaxSide(_remat_cfg(), RES, mp)
    # one step (Adam's moments populated), then ADA's p at 0.5 on its old sharding, so that
    # the compared step reuses the one compile
    pre, _, _ = side.step(side.state, 0)
    side.pre = pre.replace(ada=pre.ada._replace(p=jax.device_put(np.float32(0.5), pre.ada.p.sharding)))
    yield side
    mp.undo()


def test_remat_train_step_matches_jax(remat_side):
    """One Trainer.step with G and D remat (iteration 4: R1 + ADA + warmup, the variant
    iteration 0 compiled) against JAX Trainer.step with remat on the same injected draws,
    at tests/test_torch_trainer.py's bars (metrics and buffers 1e-4, updates and Adam
    moments 1e-3 of their largest). The remat G's and D's own equality to their plain
    forms is held to the bit above."""
    jnew, jm, draws = remat_side.step(remat_side.pre, 4)
    tr, st = _port(_remat_cfg(), RES, remat_side.pre)
    old = _flat(st)
    rs = ReplayStream(draws)
    m = {k: float(a) for k, a in tr.step(st, {k: np.array(a) for k, a in remat_side.batch.items()}, 4, draws=rs).items()}
    assert rs.remaining == 0
    sched = tr.schedule(4)
    assert (sched.do_r1, sched.do_ada, sched.skip_warmup) == (True, True, False)
    assert st.G.synthesis_network.remat and st.D.remat
    got = _flat(st)
    assert set(m) == set(jm)
    for k, v in jm.items():
        assert abs(m[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, m[k], v)
    ref = _jflat(jnew)
    for k in ref:
        if k.endswith(("w_avg", "ema_var")):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    jj = jax.tree_util.tree_map(np.asarray, jnew)
    err = {
        "G_updates": _update_err(got, ref, old, [k for k, _ in _named("G", st.G)]),
        "D_updates": _update_err(got, ref, old, [k for k, _ in _named("D", st.D)]),
        "G_moments": _moments_err(st.opt_G, st.G, jj.opt_G),
        "D_moments": _moments_err(st.opt_D, st.D, jj.opt_D),
    }
    print("iteration 4, remat: " + ", ".join(f"{k} {e:.3g}" for k, e in err.items()))
    assert max(err.values()) <= 1e-3, err


def test_option_checkpoint_loads_through_autoload_and_resume(tmp_path):
    """A train state with every G / D option (layers (2, 1, 2), the logscale basis, G and
    D remat) written in the JAX CLI's format: autoload_ckpt builds the same models from
    its config (G_ema's output equal to the bit) and a resume template takes the state
    equal to the bit."""
    from dusty_gan_v2_tpu_torch.pretrained import autoload_ckpt
    from dusty_gan_v2_tpu_torch.training import Trainer
    from dusty_gan_v2_tpu_torch.training.checkpoint import load_checkpoint, save_jax_checkpoint

    cfg = _remat_cfg()
    cfg.model.generator.synthesis_kwargs.update(layers=[2, 1, 2], pe_type="logscale")
    angle = t(_angle())
    tr = Trainer(cfg.to_dict(), device="cpu", angle=angle)
    st = tr.init_state(seed=2)
    path = tmp_path / "options.ckpt"
    save_jax_checkpoint(str(path), cfg.to_dict(), st, angle, 64)
    ck = autoload_ckpt(str(path), "cpu")
    G = ck["G_ema"]
    assert G.synthesis_network.remat and ck["D"].remat and ck["step"] == 64
    assert [b.use_pe for b in G.synthesis_network.blocks()] == [True, True, False, True]
    assert G.synthesis_network.b1.pe.basis_scale == "logscale"
    z = torch.randn(2, 16, generator=torch.Generator().manual_seed(0))
    kw = dict(truncation_psi=0.7, gumbel_noise=torch.zeros(2, 1, *RES))
    with torch.no_grad():
        assert torch.equal(G(z, angle, **kw)["image"], st.G_ema.eval()(z, angle, **kw)["image"])
    _, loaded, _, num_imgs = load_checkpoint(str(path), Trainer(cfg.to_dict(), device="cpu", angle=angle).init_state(5))
    assert num_imgs == 64
    for name in ("G", "G_ema", "D"):
        a, b = getattr(loaded, name).state_dict(), getattr(st, name).state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), name


# ------------------------------------------------------------------------- semseg switches

POOLS = [(7, (1, 1), 3), (3, (1, 2), 1), (3, (2, 2), 1), (2, (2, 2), 0), (4, (1, 3), 2)]


def test_pool_forms_match_jax_at_ties():
    """Each form at each of tests/test_torch_semseg.py's pool shapes: its values equal
    JAX's form and torch's MaxPool2d; on an input full of exact ties (post-ReLU zeros,
    small integers) its gradient equals jax.grad of the same JAX form: reduce_window's to
    the first maximum in row-major order, shift's split between the tied elements. An
    unknown form raises."""
    for impl in pcommon.POOL_IMPLS:
        for k, stride, pad in POOLS:
            _check_pool(impl, k, stride, pad)
    with pytest.raises(ValueError, match="avg"):
        pcommon.max_pool2d(torch.zeros(1, 1, 4, 4), impl="avg")


def _check_pool(impl, k, stride, pad):
    rng = np.random.RandomState(2)
    x = np.maximum(np.round(rng.randn(2, 5, 16, 33) * 2), 0).astype(np.float32)
    xt = t(x).requires_grad_()
    got = pcommon.max_pool2d(xt, k, stride, pad, impl=impl)
    ref = jcommon.max_pool2d(jnp.asarray(x), k, stride, pad, impl=impl)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.detach().numpy(), torch.nn.functional.max_pool2d(t(x), k, stride, pad).numpy())
    r = rng.randn(*got.shape).astype(np.float32)
    (got * t(r)).sum().backward()
    gj = jax.jit(jax.grad(lambda a: jnp.sum(jcommon.max_pool2d(a, k, stride, pad, impl=impl) * r)))(jnp.asarray(x))
    assert np.abs(xt.grad.numpy() - np.asarray(gj)).max() <= 1e-6
    if (k, stride) == (3, (1, 2)) and impl != "separable":
        # the forms route ties differently: each matches only its own JAX form
        gs = jax.jit(jax.grad(lambda a: jnp.sum(jcommon.max_pool2d(a, k, stride, pad, impl="separable") * r)))(
            jnp.asarray(x))
        assert np.abs(xt.grad.numpy() - np.asarray(gs)).max() > 1e-3


def test_two_pass_batchnorm_matches_jax():
    """Train-mode BN with two-pass moments (JAX's set_bn_one_pass(False)): output, input
    and affine gradients and the running statistics <= 1e-5 (the one-pass form:
    tests/test_torch_semseg.py); on an input whose mean is far from the running mean the
    two forms' variances part (the one-pass form subtracts two large terms)."""
    rng = np.random.RandomState(1)
    bn = pcommon.BatchNorm2d(5, momentum=0.1, one_pass=False)
    with torch.no_grad():
        bn.weight.copy_(t(rng.uniform(0.5, 1.5, 5).astype(np.float32)))
        bn.bias.copy_(t(rng.randn(5).astype(np.float32)))
    randomize_bn_stats(bn, rng)
    x = (rng.randn(3, 5, 4, 6) * 2 + 1).astype(np.float32)
    r = rng.randn(3, 5, 4, 6).astype(np.float32)
    v = to_flax(bn)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcommon, "_BN_ONE_PASS", False)

        def f(params, x):
            out, mut = jcommon.BatchNorm2d(5, 0.1).apply(
                {"params": params, "batch_stats": v["batch_stats"]}, x, train=True, mutable=["batch_stats"])
            return jnp.sum(out * r), (out, mut["batch_stats"])

        (_, (out, stats)), (g_params, g_x) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(v["params"], x)
    xt = t(x).requires_grad_()
    yt = bn(xt, train=True)
    (yt * t(r)).sum().backward()
    assert rel_err(yt.detach(), out) <= 1e-5 and rel_err(xt.grad, g_x) <= 1e-5
    assert rel_err(bn.weight.grad, g_params["weight"]) <= 1e-5
    for k in ("running_mean", "running_var"):
        assert np.abs(getattr(bn, k).numpy() - np.asarray(stats[k])).max() <= 1e-5
    far = t((rng.randn(3, 5, 4, 6) * 0.01 + 300).astype(np.float32))
    bns = [pcommon.BatchNorm2d(5, 1.0, one_pass) for one_pass in (True, False)]
    for bn in bns:
        bn(far, train=True)
    assert not torch.equal(bns[0].running_var, bns[1].running_var)


def test_float64_semseg_step_per_form_matches_jax():
    """One float64 step of SqueezeSegV2 + CAM built with each form, the reduce_window pool
    with two-pass BN and the shift pool (the JAX package's module globals set alike): the
    loss, every gradient, the updated parameters and the running statistics <= 1e-8 of
    their largest magnitude."""
    for pool_impl, bn_one_pass in (("reduce_window", False), ("shift", True)):
        _check_semseg_step(pool_impl, bn_one_pass)


def _check_semseg_step(pool_impl, bn_one_pass):
    cfg = step_cfg()
    model = SqueezeSegV2(("xyz", "depth"), 3, logit_bias=(0.01, 0.33, 0.33), dtype=torch.float64,
                         pool_impl=pool_impl, bn_one_pass=bn_one_pass).double()
    assert model.cam2.pool_impl == pool_impl and model.fire3.squeeze1x1.bn.one_pass == bn_one_pass
    tree = to_flax(model)
    batch = step_batch()
    with enable_x64(), fixed_dropout_keys(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsqueezeseg, "jnp", _KeepFloat64())
        mp.setattr(jcommon, "_POOL_IMPL", pool_impl)
        mp.setattr(jcommon, "_BN_ONE_PASS", bn_one_pass)
        f64 = lambda tr: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tr)  # noqa: E731
        params, stats = f64(tree["params"]), f64(tree["batch_stats"])
        tx, step = jax_step(cfg, jnp.float64, use_crf=False)
        new_params, new_stats, _, loss, grads, _ = jax.jit(step)(params, stats, jax.jit(tx.init)(params), batch)
        keep = keep_mask(SB, 64)
    trainer = SemsegTrainer(model, cfg, "cpu")
    tl, _ = trainer.forward_backward({k: t(a) for k, a in batch.items()}, 1, keep=t(keep))
    got_grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    trainer.update(1)

    def check(ours, theirs, what):
        theirs = flat(theirs)
        assert ours.keys() == theirs.keys(), what
        big = max(np.abs(a).max() for a in theirs.values())
        err = max(np.abs(ours[k].detach().numpy() - theirs[k]).max() for k in ours)
        assert err <= 1e-8 * big, (what, err, big)

    assert abs(float(tl) - float(loss)) <= 1e-8 * abs(float(loss))
    check(got_grads, grads, "gradients")
    check(dict(trainer.model.named_parameters()), new_params, "parameters")
    names = set(flat(new_stats))
    check({k: b for k, b in trainer.model.named_buffers() if k in names}, new_stats, "running statistics")


def test_copies_keep_the_switches():
    """deepcopy (the trainers copy models) keeps each module's form."""
    m = SqueezeSegV2(("xyz", "depth"), 3, pool_impl="shift", bn_one_pass=False)
    c = copy.deepcopy(m)
    assert c.pool_impl == c.cam1.pool_impl == "shift" and not c.conv1a.bn.one_pass
