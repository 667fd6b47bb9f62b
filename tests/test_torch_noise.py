"""Noise injection in the port (ops/noise.py, dusty_v2 with use_noise=True, the training
step's noise draws) against the JAX package on the CPU.

The JAX NoiseInjection draws its per-sample maps with ps_normal keyed by global id; here
that draw is replaced (pytest's monkeypatch on dusty_gan_v2_tpu.ops.noise.ps_normal) by
seeded numpy draws recorded in call order, and the port takes the same maps through a
ReplayStream. Bars: outputs within 1e-4; the training step as
tests/test_torch_trainer.py and tests/test_torch_pl.py hold it (losses, D outputs,
buffers and ADA 1e-4, each update and Adam moment within 1e-3 of its largest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu.models import build_generator as j_build_generator
from dusty_gan_v2_tpu.ops import noise as jnoise
from dusty_gan_v2_tpu.geometry import resize_angle_lut as j_resize_angle_lut
from dusty_gan_v2_tpu_torch.convert import load_jax_variables
from dusty_gan_v2_tpu_torch.models import build_generator, fixed_noise_maps
from dusty_gan_v2_tpu_torch.ops import NoiseInjection
from dusty_gan_v2_tpu_torch.parallel import PerSampleStream, ReplayStream

from test_torch_ada import NumpyDraws
from test_torch_generator import LUT, SMALL_CFG, _seeded_variables
from test_torch_trainer import (
    JaxSide, _flat, _jflat, _moments_err, _named, _np_batch, _port, _update_err,
)
from test_trainer import RES, tiny_cfg

B = 3
NOISE_CFG = {**SMALL_CFG, "synthesis_kwargs": {**SMALL_CFG["synthesis_kwargs"], "use_noise": True}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _patch_noise(mp, src):
    mp.setattr(jnoise, "ps_normal", lambda key, ids, shape, dtype=jnp.float32: src.normal((ids.shape[0], *shape)))


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed-map", "per-sample"])
def test_noise_injection_matches_jax(monkeypatch, fixed):
    rng = np.random.RandomState(0)
    x = rng.randn(B, 5, 4, 8).astype(np.float32)
    weight = rng.randn(1, 5, 1, 1).astype(np.float32)
    src = NumpyDraws(1)
    _patch_noise(monkeypatch, src)
    jmod = jnoise.NoiseInjection(ch=5)
    fixed_map = rng.randn(1, 1, 4, 8).astype(np.float32)
    kw = {"fixed_noise": jnp.asarray(fixed_map)} if fixed else {"rng": jax.random.PRNGKey(0)}
    ref = jmod.apply({"params": {"weight": jnp.asarray(weight)}}, jnp.asarray(x), **kw)
    mod = NoiseInjection((4, 8), ch=5)
    assert tuple(mod.weight.shape) == (1, 5, 1, 1) and not mod.weight.any()  # zeros, as the JAX init
    mod.weight.data.copy_(torch.from_numpy(weight))
    noise = torch.from_numpy(fixed_map) if fixed else mod.draw(ReplayStream(src.log))
    out = mod(torch.from_numpy(x), noise)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="does not fit"):
        mod(torch.from_numpy(x), torch.zeros(2, 1, 4, 8))


@pytest.fixture(scope="module")
def noise_models():
    angle = np.array(j_resize_angle_lut(np.load(LUT), RES))
    jG = j_build_generator(NOISE_CFG)
    v = _seeded_variables(jG, jnp.asarray(angle), seed=0)
    noise_w = [a for p, a in jax.tree_util.tree_leaves_with_path(v["params"]) if "noise" in jax.tree_util.keystr(p)]
    assert len(noise_w) == 5 and all(np.abs(a).max() > 0.1 for a in noise_w)  # 1 + 2 + 2 noise layers, non-zero
    tG = load_jax_variables(build_generator(NOISE_CFG, device="cpu"), v)
    return jG, v, tG, angle


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed-maps", "per-sample-draws"])
def test_noise_generator_matches_jax(noise_models, monkeypatch, fixed):
    """The use_noise=True generator on converted weights: with fixed (1, 1, H, W) maps
    (the JAX fixed_noise) and with per-sample maps drawn in block order."""
    jG, v, tG, angle = noise_models
    rng = np.random.RandomState(3)
    z = rng.randn(B, 16).astype(np.float32)
    u = np.clip(rng.rand(1, 1, *RES), 1e-6, 1 - 1e-6)
    gumbel = (np.log(u) - np.log1p(-u)).astype(np.float32)
    src = NumpyDraws(4)
    _patch_noise(monkeypatch, src)
    if fixed:
        maps = fixed_noise_maps(tG, 5, "cpu")
        jmaps = [[jnp.asarray(m.numpy()) for m in block] for block in maps]
        ref = jax.jit(lambda v, maps: jG.apply(v, jnp.asarray(z), jnp.asarray(angle), truncation_psi=0.7,
                                               gumbel_noise=jnp.asarray(gumbel), fixed_noise=maps))(v, jmaps)
    else:
        ref = jax.jit(lambda v: jG.apply(v, jnp.asarray(z), jnp.asarray(angle), truncation_psi=0.7,
                                         gumbel_noise=jnp.asarray(gumbel), rngs={"noise": jax.random.PRNGKey(0)}))(v)
        assert [a.shape for a in src.log] == [(B, 1, 2, 16), (B, 1, 4, 32), (B, 1, 4, 32), (B, 1, 8, 64),
                                              (B, 1, 8, 64)]
        rs = ReplayStream(src.log)
        maps = tG.synthesis_network.draw_noise(rs)
        assert rs.remaining == 0
    with torch.no_grad():
        o = tG(torch.from_numpy(z), torch.from_numpy(angle), truncation_psi=0.7, gumbel_noise=torch.from_numpy(gumbel),
               noise=maps)
    for key in ("image_orig", "raydrop_logit", "w"):
        np.testing.assert_allclose(o[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4, err_msg=key)
    # the maps matter: without them the output moves
    with torch.no_grad():
        zero = [[torch.zeros_like(m) for m in block] for block in maps]
        o0 = tG(torch.from_numpy(z), torch.from_numpy(angle), truncation_psi=0.7,
                gumbel_noise=torch.from_numpy(gumbel), noise=zero)
    assert float((o0["image_orig"] - o["image_orig"]).abs().max()) > 1e-2


def test_noise_generator_draws_from_a_generator(noise_models):
    """Without maps the generator draws them per sample from its torch.Generator (after
    the train-mode shift), the same rows on a PerSampleStream of the same seed; and it
    raises with neither."""
    _, _, tG, angle = noise_models
    z = torch.randn(B, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = tG(z, torch.from_numpy(angle), gumbel_noise=torch.zeros(1, 1, *RES), generator=torch.Generator().manual_seed(1))
        maps = tG.synthesis_network.draw_noise(PerSampleStream(B, torch.Generator().manual_seed(1), "cpu"))
        b = tG(z, torch.from_numpy(angle), gumbel_noise=torch.zeros(1, 1, *RES), noise=maps)
        assert torch.equal(a["image_orig"], b["image_orig"])
        with pytest.raises(ValueError, match="pass noise"):
            tG(z, torch.from_numpy(angle), gumbel_noise=torch.zeros(1, 1, *RES))
    assert fixed_noise_maps(build_generator(SMALL_CFG, device="cpu"), 0, "cpu") is None


def _noise_cfg():
    cfg = tiny_cfg()
    cfg.training.loss.pl = 2  # lazy pl 2: iteration 4 takes PL + R1 + ADA
    cfg.model.generator.synthesis_kwargs.use_noise = True
    return cfg


@pytest.fixture(scope="module")
def jax_side():
    mp = pytest.MonkeyPatch()
    side = JaxSide(_noise_cfg(), RES, mp)
    _patch_noise(mp, side.src)
    # one step of the variant the compared step takes (one compile); ADA's p at 0.5 and noise
    # weights of a trained G (not the near-zero ones of one step), each kept on its old
    # sharding so that the step does not compile again
    pre, _, _ = side.step(side.state, 0)
    rng = np.random.RandomState(7)
    noisy = lambda p, a: (  # noqa: E731
        jax.device_put(rng.randn(*a.shape).astype(np.float32) * 0.3, a.sharding)
        if "noise" in jax.tree_util.keystr(p) else a)
    side.pre = pre.replace(params_G=jax.tree_util.tree_map_with_path(noisy, pre.params_G),
                           ada=pre.ada._replace(p=jax.device_put(np.float32(0.5), pre.ada.p.sharding)))
    yield side
    mp.undo()


def test_noise_train_step_matches_jax(jax_side):
    """One Trainer.step of a use_noise=True generator (iteration 4: PL + R1 + ADA +
    warmup) against JAX Trainer.step on the same injected draws (each G forward draws
    shift, noise maps, ray-drop noise)."""
    it = 4
    jnew, jm, draws = jax_side.step(jax_side.pre, it)
    tr, st = _port(_noise_cfg(), RES, jax_side.pre)
    assert tr.schedule(it).do_pl and tr.schedule(it).do_r1
    old = _flat(st)
    rs = ReplayStream(draws)
    m = tr.step(st, _np_batch(jax_side.batch), it, draws=rs)
    assert rs.remaining == 0, "the port drew less than the JAX step"
    assert set(m) == set(jm) and "loss/G/path_length" in m
    for k, v in jm.items():
        assert abs(float(m[k]) - v) <= 1e-4 * max(1.0, abs(v)), (k, float(m[k]), v)
    ref, got = _jflat(jnew), _flat(st)
    for k in ref:
        if k.endswith(("w_avg", "ema_var")):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    jj = jax.tree_util.tree_map(np.asarray, jnew)
    err = {
        "G_updates": _update_err(got, ref, old, [k for k, _ in _named("G", st.G)]),
        "noise_updates": _update_err(got, ref, old, [k for k, _ in _named("G", st.G) if "noise" in k]),
        "D_updates": _update_err(got, ref, old, [k for k, _ in _named("D", st.D)]),
        "G_moments": _moments_err(st.opt_G, st.G, jj.opt_G),
        "D_moments": _moments_err(st.opt_D, st.D, jj.opt_D),
    }
    print(f"iteration {it}: " + ", ".join(f"{k} {v:.3g}" for k, v in err.items()))
    assert max(err.values()) <= 1e-3, err
