"""The port's DUSty v1 and vanilla families against the JAX package on the CPU.

- convT4x4s2_ring_fast against the JAX function (values and gradients, both H pad modes,
  tests/test_ops.py's shapes): 1e-5 relative to the largest magnitude (float32, one
  transposed convolution against a dilated convolution plus boundary corrections).
- EqualLRConvTranspose2d, ring-fast and plain, against the JAX module on the same
  weights: values and gradients 1e-5 of the largest magnitude.
- The vanilla generator, the dusty_v1 generator (on injected logistic noise) and the
  vanilla discriminator on weights converted from JAX `init` (redrawn from a numpy seed:
  non-zero biases, a non-zero w_avg), ring True and False, at tests/test_models.py::
  TestVanilla's size (64 x 128, ch_base 8, ch_max 64): 1e-4 absolute against JAX `apply`;
  the ray-drop mask equal.
- One full training step per arch pair (dusty_v1 + vanilla D, vanilla + vanilla D) with
  lazy gp = pl = ada = 1 at 32 x 64, ch_base 4 (tests/test_trainer.py::
  TestOtherArchsTrain's config), against JAX `Trainer.step` on replayed draws with
  tests/test_torch_trainer.py's harness (the JAX step compiled at XLA optimization level
  0, see there): losses, the PL penalty and baseline, D outputs, buffers and the ADA state
  1e-4; each parameter's update and Adam's moments within 1e-3 of their largest (a
  float32 step from weights one ulp away moves them about as much:
  tests/test_torch_trainer.py::test_update_bar_against_one_ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu.models import build_discriminator as j_build_discriminator
from dusty_gan_v2_tpu.models import build_generator as j_build_generator
from dusty_gan_v2_tpu.ops import EqualLRConvTranspose2d as JEqualLRConvTranspose2d
from dusty_gan_v2_tpu.ops.pad import convT4x4s2_ring_fast as j_convT4x4s2_ring_fast
from dusty_gan_v2_tpu_torch.convert import flatten_variables, load_jax_variables
from dusty_gan_v2_tpu_torch.models import build_discriminator, build_generator, build_pe_cache
from dusty_gan_v2_tpu_torch.ops import EqualLRConvTranspose2d, convT4x4s2_ring_fast
from dusty_gan_v2_tpu_torch.parallel import PerSampleStream, ReplayStream
from dusty_gan_v2_tpu_torch.sampling import CONFIG_DIR, train_cfg
from dusty_gan_v2_tpu_torch.training import Trainer
from dusty_gan_v2_tpu_torch.utils.config import Config

from test_torch_trainer import JaxSide, _flat, _jflat, _moments_err, _named, _np_batch, _port, _update_err
from test_trainer import tiny_cfg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# --------------------------------------------------------------------------- ops

@pytest.mark.parametrize("mode", ["replicate", "reflect"])
@pytest.mark.parametrize("shape", [(8, 16), (6, 10), (4, 32)])
def test_convT_ring_fast_matches_jax(mode, shape):
    """Values and both gradients (input and kernel) under one random cotangent. The JAX
    function takes the dilated convolution's kernel w_t (O, I, 4, 4); the port the
    transposed convolution's weight, its flip and transpose."""
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(2, 3, *shape).astype(np.float32)
    w_t = rng.randn(5, 3, 4, 4).astype(np.float32)
    g = rng.randn(2, 5, 2 * shape[0], 2 * shape[1]).astype(np.float32)

    @jax.jit
    def ref_fn(a, b, ct):
        y, vjp = jax.vjp(lambda a, b: j_convT4x4s2_ring_fast(a, b, mode), a, b)
        return (y,) + vjp(ct)

    y_ref, gx_ref, gw_ref = ref_fn(x, w_t, g)
    xt, wt = _t(x).requires_grad_(True), _t(w_t).requires_grad_(True)
    y = convT4x4s2_ring_fast(xt, wt.flip((-2, -1)).transpose(0, 1), mode)
    gx, gw = torch.autograd.grad(y, (xt, wt), _t(g))
    errs = [_rel(y.detach().numpy(), y_ref), _rel(gx.numpy(), gx_ref), _rel(gw.numpy(), gw_ref)]
    assert max(errs) <= 1e-5, errs


def test_convT_ring_fast_checks_its_arguments():
    x = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError):
        convT4x4s2_ring_fast(x, torch.zeros(2, 3, 3, 3))
    with pytest.raises(ValueError):
        convT4x4s2_ring_fast(x, torch.zeros(2, 3, 4, 4), "circular")


# (kernel, stride, padding, ring_fast, input H x W): the generator's upsample on its ring
# route and on the plain route (whose caller pads by reflection first), and the projection
CONVT_CASES = {
    "ring_fast": ((4, 4), (2, 2), (3, 3), True, (4, 8)),
    "plain_s2": ((4, 4), (2, 2), (3, 3), False, (6, 10)),
    "projection": ((2, 4), (1, 1), (0, 0), False, (1, 1)),
}


@pytest.mark.parametrize("case", sorted(CONVT_CASES))
def test_equal_lr_conv_transpose_matches_jax(case):
    kernel, stride, padding, ring_fast, hw = CONVT_CASES[case]
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, *hw).astype(np.float32)
    kw = dict(in_ch=3, out_ch=5, kernel_size=kernel, stride=stride, padding=padding, use_bias=True,
              ring_fast=ring_fast)
    jm = JEqualLRConvTranspose2d(**kw)
    params = {"weight": rng.randn(3, 5, *kernel).astype(np.float32), "bias": rng.randn(5).astype(np.float32)}
    y_ref = jm.apply({"params": params}, x)
    g = rng.randn(*y_ref.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, a: jm.apply({"params": p}, a), params, jnp.asarray(x))
    gp_ref, gx_ref = vjp(jnp.asarray(g))
    m = load_jax_variables(EqualLRConvTranspose2d(**kw), {"params": params})
    xt = _t(x).requires_grad_(True)
    y = m(xt)
    gx, gw, gb = torch.autograd.grad(y, (xt, m.weight, m.bias), _t(g))
    errs = {"y": _rel(y.detach().numpy(), y_ref), "x": _rel(gx.numpy(), gx_ref),
            "weight": _rel(gw.numpy(), gp_ref["weight"]), "bias": _rel(gb.numpy(), gp_ref["bias"])}
    assert max(errs.values()) <= 1e-5, errs
    if kernel != (4, 4):  # the ring route is the 4x4 stride-2 padding-3 one only
        with pytest.raises(ValueError):
            EqualLRConvTranspose2d(3, 5, kernel, stride, padding, ring_fast=True)


# --------------------------------------------------------------------------- models

RES_V = (64, 128)  # tests/test_models.py::TestVanilla's size
HEADS = ({"name": "image", "ch": 1, "act": None}, {"name": "raydrop_logit", "ch": 1, "act": None})


def _g_cfg(arch, ring):
    return {
        "arch": arch,
        "synthesis_kwargs": {"in_ch": 64, "out_ch": HEADS if arch == "dusty_v1" else HEADS[:1], "ch_base": 8,
                             "ch_max": 64, "resolution": RES_V, "ring": ring},
        "measurement_kwargs": {"raydrop_const": -1, "gumbel_temperature": 1},
    }


def _redraw(variables, seed):
    """Every leaf of a JAX variable tree drawn anew from numpy: weights N(0, 1), biases
    and w_avg N(0, 0.3^2)."""
    rng = np.random.RandomState(seed)

    def draw(path, a):
        std = 1.0 if path[-1].key == "weight" else 0.3
        return (rng.randn(*np.shape(a)) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "plain"])
@pytest.mark.parametrize("arch", ["vanilla", "dusty_v1"])
def test_generator_matches_jax(arch, ring):
    cfg = _g_cfg(arch, ring)
    jG = j_build_generator(cfg)
    rng = np.random.RandomState(1)
    z = rng.randn(3, 64).astype(np.float32)
    noise = rng.logistic(size=(3, 1, *RES_V)).astype(np.float32)
    v = jax.jit(lambda a: jG.init({"params": jax.random.PRNGKey(1), "gumbel": jax.random.PRNGKey(2)}, a))(z)
    v = _redraw(v, seed=2)
    assert set(v) == {"params", "stats"} and np.abs(v["stats"]["w_avg"]).max() > 0.1
    tG = load_jax_variables(build_generator(cfg, device="cpu"), v)
    assert set(tG.state_dict()) == set(flatten_variables(v))
    assert build_pe_cache(tG, torch.zeros(1, 2, *RES_V)) is None
    apply = jax.jit(lambda v, z, n, psi: jG.apply(v, z, truncation_psi=psi, gumbel_noise=n), static_argnums=3)
    for psi in (1.0, 0.7):
        ref = apply(v, z, noise, psi)
        got = tG(_t(z), truncation_psi=psi, gumbel_noise=_t(noise))
        assert set(got) == set(ref)
        assert got["w"].shape == (3, 1, 64) and got["image"].shape == (3, 1, *RES_V)
        for k in ref:
            err = float(np.abs(got[k].detach().numpy() - np.asarray(ref[k])).max())
            assert err <= (0.0 if k == "raydrop_mask" else 1e-4), (k, psi, err)
    if arch == "dusty_v1":
        assert 0.0 < float(got["raydrop_mask"].detach().mean()) < 1.0
        with pytest.raises(ValueError):  # no noise and no generator to draw it
            tG(_t(z))
    with pytest.raises(ValueError):  # no Fourier PE, no azimuth shift
        tG(_t(z), gumbel_noise=_t(noise), pe_cache=())


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "plain"])
def test_discriminator_matches_jax(ring):
    cfg = {"arch": "vanilla", "layer_kwargs": {"in_ch": 1, "ring": ring, "ch_base": 8, "ch_max": 64,
                                               "resolution": RES_V}}
    jD = j_build_discriminator(cfg)
    x = np.tanh(np.random.RandomState(3).randn(3, 1, *RES_V)).astype(np.float32)
    v = _redraw(jax.jit(jD.init)(jax.random.PRNGKey(2), x), seed=4)
    ref = np.asarray(jax.jit(jD.apply)(v, x))
    tD = load_jax_variables(build_discriminator(cfg, device="cpu"), v)
    got = tD(_t(x), blur_fuse=False).detach().numpy()
    assert got.shape == ref.shape == (3, 1, 1, 1)
    assert np.abs(got - ref).max() <= 1e-4, np.abs(got - ref).max()
    np.testing.assert_array_equal(tD(_t(x), blur_fuse=True).detach().numpy(), got)


@pytest.mark.parametrize("name", sorted(p.stem for p in CONFIG_DIR.glob("*.yaml")))
def test_builders_build_every_shipped_config(name):
    m = train_cfg(name)["model"]
    G = build_generator(m["generator"], device="cpu")
    D = build_discriminator(m["discriminator"], device="cpu")
    assert type(G).__module__.endswith(m["generator"]["arch"])
    assert type(D).__module__.endswith(m["discriminator"]["arch"])
    assert not G.training and G.w_avg.shape == (1, G.style_dim)


# --------------------------------------------------------------------------- the step

RES_T = (32, 64)  # tests/test_trainer.py::TestOtherArchsTrain's size


def _step_cfg(g_arch):
    cfg = tiny_cfg()
    cfg.training.lazy = Config({"gp": 1, "pl": 1, "ada": 1})
    cfg.model.generator = Config({
        "arch": g_arch,
        "mapping_kwargs": {"in_ch": 16, "out_ch": 16},
        "synthesis_kwargs": {"in_ch": 16, "out_ch": [dict(h) for h in HEADS], "ch_base": 4, "ch_max": 16,
                             "resolution": list(RES_T), "ring": True},
        "measurement_kwargs": {"raydrop_const": -1, "gumbel_temperature": 1},
    })
    cfg.model.discriminator = Config({"arch": "vanilla", "layer_kwargs": {
        "in_ch": 1, "ring": True, "ch_base": 4, "ch_max": 16, "resolution": list(RES_T)}})
    return cfg


@pytest.mark.parametrize("g_arch", ["dusty_v1", "vanilla"])
def test_full_step_matches_jax(g_arch):
    """Iteration 2 (PL, R1, ADA and warmup all on) from a JAX state two steps old."""
    cfg, it = _step_cfg(g_arch), 2
    mp = pytest.MonkeyPatch()
    try:
        side = JaxSide(cfg, RES_T, mp)
        side.pre = side.state
        for pre in range(it):  # one variant: compiled once, at iteration 0, with its draws
            side.pre, _, _ = side.step(side.pre, pre)
        # ADA at p = 0.5, placed as the state's p is (another placement would compile anew)
        p = jax.device_put(jnp.asarray(0.5, jnp.float32), side.pre.ada.p.sharding)
        side.pre = side.pre.replace(ada=side.pre.ada._replace(p=p))
        jnew, jm, draws = side.step(side.pre, it)
    finally:
        mp.undo()
    tr, st = _port(cfg, RES_T, side.pre)
    sched = tr.schedule(it)
    assert (sched.do_pl, sched.do_r1, sched.do_ada, sched.skip_warmup) == (True, True, True, False)
    assert tr.z_dim == 16 and tr.pe_cache_for(st) is None
    old = _flat(st)
    seen = []
    rs = ReplayStream(draws)
    m = tr.step(st, _np_batch(side.batch), it, draws=rs, on_phase=lambda name, s, values: seen.append(name))
    assert rs.remaining == 0, "the port drew less than the JAX step"
    assert seen == ["g", "pl", "d", "r1"] and set(m) == set(jm)
    for k, v in jm.items():  # adversarial losses, PL penalty and baseline, R1, D outputs, ADA
        assert abs(float(m[k]) - v) <= 1e-4 * max(1.0, abs(v)), (k, float(m[k]), v)
    ref, got = _jflat(jnew), _flat(st)
    assert set(ref) == set(got)
    np.testing.assert_allclose(got["G.w_avg"], ref["G.w_avg"], rtol=1e-4, atol=1e-6)
    for a, b in ((st.ada.p, jnew.ada.p), (st.ada.sign_cum, jnew.ada.sign_cum), (st.ada.n_pred_cum, jnew.ada.n_pred_cum)):
        assert abs(float(a) - float(b)) <= 1e-4
    jj = jax.tree_util.tree_map(np.asarray, jnew)
    err = {
        "G_updates": _update_err(got, ref, old, [k for k, _ in _named("G", st.G)]),
        "D_updates": _update_err(got, ref, old, [k for k, _ in _named("D", st.D)]),
        "G_ema_updates": _update_err(got, ref, old, [f"G_ema.{k}" for k, _ in st.G.named_parameters()]),
        "G_moments": _moments_err(st.opt_G, st.G, jj.opt_G),
        "D_moments": _moments_err(st.opt_D, st.D, jj.opt_D),
    }
    print(f"{g_arch} + vanilla D, iteration {it}: " + ", ".join(f"{k} {v:.3g}" for k, v in err.items()))
    assert max(err.values()) <= 1e-3, err
    # G stepped twice an iteration (G phase, PL) for three iterations
    assert float(st.opt_G.state[next(st.G.parameters())]["step"]) == float(jj.opt_G[0].count) == 6.0
    assert st.step == int(jnew.step) == 3


def test_generators_draw_what_jax_draws():
    """A train-mode forward in the step draws z and then: nothing for the vanilla G (a
    draw the JAX step does not make would shift every later one), one logistic map for
    dusty_v1's G; neither draws an azimuth shift."""
    counts = {}
    for g_arch in ("vanilla", "dusty_v1"):
        tr = Trainer(_step_cfg(g_arch).to_dict(), device="cpu", angle=torch.zeros(1, 2, *RES_T))
        st = tr.init_state(seed=0)
        rec = RecordingStream(tr.batch_size, tr.generator, tr.device)
        tr._fake(st, rec)
        counts[g_arch] = rec.calls
    assert counts == {"vanilla": ["normal"], "dusty_v1": ["normal", "logistic"]}


class RecordingStream(PerSampleStream):
    """A PerSampleStream that keeps the names of its draws (a logistic draw's own
    uniform is not counted apart)."""

    def __init__(self, n, generator, device, calls=None):
        super().__init__(n, generator, device)
        self.calls = [] if calls is None else calls
        self._in_logistic = False

    def with_batch(self, n):
        return RecordingStream(n, self.generator, self.device, self.calls)

    def normal(self, *a, **k):
        self.calls.append("normal")
        return super().normal(*a, **k)

    def uniform(self, *a, **k):
        if not self._in_logistic:
            self.calls.append("uniform")
        return super().uniform(*a, **k)

    def logistic(self, *a, **k):
        self.calls.append("logistic")
        self._in_logistic = True
        try:
            return super().logistic(*a, **k)
        finally:
            self._in_logistic = False
