"""The port's training step against dusty_gan_v2_tpu/training/trainer.py on the CPU.

The JAX Trainer (tests/test_trainer.py's tiny config, loss.pl = 0, one device) takes two
steps from its own init; ADA's p is then set to 0.5 and that state, whose Adam moments are
populated, is carried into the port by convert/jax_variables.py::load_jax_train_state.
From it each step variant that the shipped configs reach (R1 x ADA x warmup) runs on both
sides and the new states are compared.

The JAX step draws from threefry keys, the port from a torch.Generator. So the JAX
modules' draw functions are replaced with pytest's monkeypatch (the trainer's ps_normal
and warmup_fn, dusty_v2's ps_uniform, dusty_v1's per_sample_keys + sample_logistic, ADA's
PerSampleStream) by seeded numpy draws, recorded in call order while the step is traced
(each compiled variant keeps the draws of its trace), and the port replays the record
through a ReplayStream, which checks each shape. Bars: losses, D outputs, buffers and
the ADA state 1e-4; each parameter's and EMA parameter's update within 1e-3 of that
tensor's largest update (a float32 step from weights one ulp away moves them by about
as much: test_update_bar_against_one_ulp)."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dusty_gan_v2_tpu.augment import ada as jada
from dusty_gan_v2_tpu.models import dusty_v1 as jdusty_v1
from dusty_gan_v2_tpu.models import dusty_v2 as jdusty_v2
from dusty_gan_v2_tpu.ops import pad as jpad
from dusty_gan_v2_tpu.ops import shift as jshift
from dusty_gan_v2_tpu.parallel import make_mesh
from dusty_gan_v2_tpu.training import Trainer as JTrainer
from dusty_gan_v2_tpu.training import fetch_reals as j_fetch_reals
from dusty_gan_v2_tpu.training import make_blur_kernel as j_make_blur_kernel
from dusty_gan_v2_tpu.training import trainer as jtrainer
from dusty_gan_v2_tpu_torch.convert import flatten_variables, load_jax_train_state
from dusty_gan_v2_tpu_torch.parallel import PerSampleStream, ReplayStream
from dusty_gan_v2_tpu_torch.sampling import full_train_cfg
from dusty_gan_v2_tpu_torch.training import Trainer, fetch_reals, make_blur_kernel, warmup_fn

from test_torch_ada import NumpyDraws
from test_trainer import RES, make_angle, synth_batch, tiny_cfg

J_WARMUP = jtrainer.warmup_fn  # the real one, before any patch
_JIT = jax.jit
# iteration -> (do_r1, do_ada, skip_warmup) under tiny_cfg (lazy gp 4, ada 2; warmup fades
# after 1000 / 8 = 125 iterations). R1 every 4th step implies ADA, as gp 16 / ada 4 does in
# the shipped configs, so these six are every reachable variant.
VARIANTS = {4: (True, True, False), 2: (False, True, False), 3: (False, False, False),
            1000: (True, True, True), 1002: (False, True, True), 1003: (False, False, True)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The sizes here are tiny: one intra-op thread is as fast, and leaves the cores to
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _cfg(**policy):
    cfg = tiny_cfg()
    cfg.training.loss.pl = 0
    for k, v in policy.items():
        cfg.training.augment.policy[k] = v
    return cfg


class _Draws:
    """The JAX side's source of draws: the NumpyDraws of the step being traced."""

    def __init__(self):
        self.rec, self.n = NumpyDraws(0), None

    def __getattr__(self, name):  # normal / uniform / randint / logistic of the current record
        return getattr(self.rec, name)

    stream_class = NumpyDraws.stream_class


def _patch(mp, src):
    mp.setattr(jtrainer, "ps_normal", lambda key, ids, shape, dtype=jnp.float32: src.normal((ids.shape[0], *shape)))

    def warmup(x, rng, dropout_ratio, raydrop_const, blur_kernel=None, ids=None):
        if blur_kernel is not None:
            x = jpad.filter2d(x, blur_kernel)
        keep = (src.uniform(x.shape) < 1.0 - dropout_ratio).astype(x.dtype)
        return keep * x + (1.0 - keep) * raydrop_const

    mp.setattr(jtrainer, "warmup_fn", warmup)
    mp.setattr(jdusty_v2, "ps_uniform", lambda key, ids, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0:
               src.uniform((ids.shape[0], *shape), minval, maxval))

    def per_sample_keys(key, ids):  # sample indices in place of keys, for the lookup below
        src.n = ids.shape[0]
        return jnp.arange(ids.shape[0])

    mp.setattr(jdusty_v1, "per_sample_keys", per_sample_keys)
    mp.setattr(jdusty_v1, "sample_logistic", lambda k, shape, dtype=jnp.float32: src.logistic((src.n, *shape))[k])
    mp.setattr(jada, "PerSampleStream", src.stream_class())
    # the JAX package's literal gather form of the fractional shift: its default one-hot
    # matmul form gives a wrong ADA input gradient once jitted on the CPU, at any XLA
    # optimization level (tests/test_torch_ada.py::test_input_gradient_matches_finite_differences)
    mp.setattr(jshift, "_SHIFT_IMPL", "gather")


class JaxSide:
    """A JAX Trainer whose draws are recorded; step() returns (state, metrics, draws)."""

    def __init__(self, cfg, res, mp):
        self.src = _Draws()
        _patch(mp, self.src)
        self.t = JTrainer(cfg, mesh=make_mesh(jax.devices()[:1]), angle=make_angle(res))
        self.state = jax.jit(self.t.init_state)(jax.random.PRNGKey(0))  # 5x faster than eager here
        self.batch = synth_batch(np.random.RandomState(0), self.t.batch_size, res)
        self.draws = {}

    def step(self, state, it):
        self.src.rec = NumpyDraws(1000 + it)
        skip = self.t.warmup_params(it) == (0.0, 0.0)
        with pytest.MonkeyPatch.context() as mp:
            # XLA:CPU's optimized code computes ADA's input gradient wrongly (up to 1.6e-2
            # of a sample's largest element against finite differences; eager JAX and the
            # port agree with them): the step is compiled without backend optimization
            mp.setattr(jax, "jit", functools.partial(_JIT, compiler_options={"xla_backend_optimization_level": 0}))
            key = (*self.t.get_step_fn(it, skip_warmup=skip)[1:], skip)
            new, m = self.t.step(jax.tree_util.tree_map(jnp.copy, state), self.batch, jax.random.PRNGKey(1), it)
        if self.src.rec.log:  # traced now: these draws are baked into this variant
            self.draws[key] = self.src.rec.log
        return new, {k: float(v) for k, v in m.items()}, self.draws[key]


def _pre_state(side, iters=(0, 1)):
    s = side.state
    for it in iters:
        s, _, _ = side.step(s, it)
    return s.replace(ada=s.ada._replace(p=jnp.asarray(0.5, jnp.float32)))


@pytest.fixture(scope="module")
def jax_side():
    mp = pytest.MonkeyPatch()
    side = JaxSide(_cfg(), RES, mp)
    side.pre = _pre_state(side)
    yield side
    mp.undo()


def _port(cfg, res, jstate):
    tr = Trainer(cfg.to_dict(), device="cpu", angle=torch.from_numpy(np.array(make_angle(res))))
    return tr, load_jax_train_state(tr.init_state(), jax.tree_util.tree_map(np.asarray, jstate))


def _np_batch(batch):
    return {k: np.array(v) for k, v in batch.items()}


def _update_err(new, ref, old, keys):
    """max over `keys` of max |(new - old) - (ref - old)| / max |ref - old|, each element
    allowed 2 ulps of its stored float32 value first (an update finer than that cannot be
    stored: the mapping network's weights are ~100, stored x 1 / lr_mul)."""
    worst = 0.0
    for k in keys:
        d_ref, d_new = ref[k] - old[k], new[k] - old[k]
        excess = np.maximum(np.abs(d_new - d_ref) - 2 * np.spacing(np.abs(ref[k])), 0.0).max()
        scale = np.abs(d_ref).max()
        assert scale > 0 or excess == 0, k
        worst = max(worst, float(excess / scale) if scale > 0 else 0.0)
    return worst


def _moments_err(opt, net, jopt):
    """max over parameters of Adam's moments' max |port - JAX| / max |JAX|, and the step count."""
    adam = jopt[0]
    mu, nu = flatten_variables({"params": adam.mu}), flatten_variables({"params": adam.nu})
    worst = 0.0
    for k, p in net.named_parameters():
        s = opt.state[p]
        assert float(s["step"]) == float(adam.count), k
        for got, ref in ((s["exp_avg"], mu[k]), (s["exp_avg_sq"], nu[k])):
            worst = max(worst, float(np.abs(got.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)))
    return worst


def _adam_formula_err(opt, net, old, new, prefix):
    """The port's update of a network that took one Adam step this iteration against
    optax's formula on the port's own moments, in float64 (max over tensors, relative to
    the largest update, 2 ulps of the stored value allowed)."""
    g = opt.param_groups[0]
    (b1, b2), lr, eps = g["betas"], g["lr"], g["eps"]
    worst = 0.0
    for k, p in net.named_parameters():
        s = opt.state[p]
        t = float(s["step"])
        mu, nu = s["exp_avg"].double().numpy(), s["exp_avg_sq"].double().numpy()
        upd = -lr * (mu / (1 - b1 ** t)) / (np.sqrt(nu / (1 - b2 ** t)) + eps)
        d = new[f"{prefix}.{k}"].astype(np.float64) - old[f"{prefix}.{k}"]
        excess = np.maximum(np.abs(d - upd) - 2 * np.spacing(np.abs(new[f"{prefix}.{k}"])), 0.0).max()
        worst = max(worst, float(excess / np.abs(upd).max()))
    return worst


def _flat(state):
    """{"G.<path>", "G_ema.<path>", "D.<path>": numpy} of a port TrainState."""
    out = {}
    for name in ("G", "G_ema", "D"):
        for k, v in getattr(state, name).state_dict().items():
            out[f"{name}.{k}"] = v.detach().numpy().copy()
    return out


def _jflat(js):
    js = jax.tree_util.tree_map(np.asarray, js)
    out = {}
    for name, v in (("G", {"params": js.params_G, "stats": js.stats_G, "consts": js.consts_G}),
                    ("G_ema", {"params": js.params_G_ema, "stats": js.stats_G_ema, "consts": js.consts_G}),
                    ("D", {"params": js.params_D})):
        out.update({f"{name}.{k}": a for k, a in flatten_variables(v).items()})
    return out


def _compare_step(side, it, cfg=None, res=RES):
    """One step from the carried-across state on both sides. Returns the trainer, the
    port's state and the measured errors."""
    cfg = cfg or _cfg()
    jnew, jm, draws = side.step(side.pre, it)
    tr, st = _port(cfg, res, side.pre)
    old = _flat(st)
    rs = ReplayStream(draws)
    m = tr.step(st, _np_batch(side.batch), it, draws=rs)
    assert rs.remaining == 0, "the port drew less than the JAX step"
    assert set(m) == set(jm), (set(m) ^ set(jm))
    for k, v in jm.items():  # losses, D outputs, ADA's p and rt
        assert abs(float(m[k]) - v) <= 1e-4 * max(1.0, abs(v)), (k, float(m[k]), v)
    ref, got = _jflat(jnew), _flat(st)
    assert set(ref) == set(got)
    for k in ref:
        if k.endswith(("w_avg", "ema_var")):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    ja = jnew.ada
    for a, b in ((st.ada.p, ja.p), (st.ada.sign_cum, ja.sign_cum), (st.ada.n_pred_cum, ja.n_pred_cum)):
        assert abs(float(a) - float(b)) <= 1e-4, (float(a), float(b))
    assert st.step == int(jnew.step) == 3
    jj = jax.tree_util.tree_map(np.asarray, jnew)
    err = {
        "G_updates": _update_err(got, ref, old, [k for k, _ in _named("G", st.G)]),
        "D_updates": _update_err(got, ref, old, [k for k, _ in _named("D", st.D)]),
        # Adam's moments: the last gradient (beta1 = 0) and the second moment
        "G_moments": _moments_err(st.opt_G, st.G, jj.opt_G),
        "D_moments": _moments_err(st.opt_D, st.D, jj.opt_D),
        # G's update is Adam's on the port's own moments
        "G_adam": _adam_formula_err(st.opt_G, st.G, old, got, "G"),
    }
    assert max(err.values()) <= 1e-3 and err["G_adam"] <= 1e-4, err
    # G_ema: e * d + p * (1 - d) of the port's own G (float32, within 2 ulps); buffers are G's
    d32 = np.float32(tr.schedule(it).ema_decay)
    for k, _ in _named("G", st.G):
        e = f"G_ema.{k[2:]}"
        want = old[e] * d32 + got[k] * (np.float32(1) - d32)
        assert np.all(np.abs(got[e] - want) <= 2 * np.spacing(np.abs(want))), e
    for k in got:
        if k.startswith("G.") and not k[2:] in dict(st.G.named_parameters()):
            np.testing.assert_array_equal(got[f"G_ema.{k[2:]}"], got[k])
    return tr, st, err


def _named(prefix, net):
    return [(f"{prefix}.{k}", p) for k, p in net.named_parameters()]


@pytest.mark.parametrize("it", sorted(VARIANTS), ids=lambda it: "r1{}-ada{}-{}".format(
    *[int(v) for v in VARIANTS[it][:2]], "steady" if VARIANTS[it][2] else "warmup"))
def test_step_variant_matches_jax(jax_side, it):
    tr, _, err = _compare_step(jax_side, it)
    sched = tr.schedule(it)
    assert (sched.do_r1, sched.do_ada, sched.skip_warmup) == VARIANTS[it]
    print(f"iteration {it}: " + ", ".join(f"{k} {v:.3g}" for k, v in err.items()))


def test_update_bar_against_one_ulp(jax_side):
    """What float32 itself allows: the port's step from the carried-across state against
    the same step with every G and D parameter one ulp up (R1 + ADA + warmup variant),
    measured as the step against JAX is."""
    it = 4
    _, _, draws = jax_side.step(jax_side.pre, it)
    tr, a = _port(_cfg(), RES, jax_side.pre)
    b = copy.deepcopy(a)
    with torch.no_grad():
        for net in (b.G, b.D):
            for p in net.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, np.inf)))
    old_a, old_b = _flat(a), _flat(b)
    batch = _np_batch(jax_side.batch)
    tr.step(a, batch, it, draws=ReplayStream(draws))
    tr.step(b, batch, it, draws=ReplayStream(draws))
    new_a, new_b = _flat(a), _flat(b)
    # b's updates against a's, on a's starting values
    shifted = {k: new_b[k] - old_b[k] + old_a[k] for k in new_b}
    shift = {net: _update_err(shifted, new_a, old_a, [k for k, _ in _named(net, getattr(a, net))]) for net in ("G", "D")}
    print(f"one ulp in every weight moves the updates by {shift} of their largest")
    assert max(shift.values()) <= 1e-3


def test_load_jax_train_state_round_trip(jax_side):
    pre = jax.tree_util.tree_map(np.asarray, jax_side.pre)
    tr, st = _port(_cfg(), RES, jax_side.pre)
    got, ref = _flat(st), _jflat(pre)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for opt, net, jopt, jparams in ((st.opt_G, st.G, pre.opt_G, pre.params_G), (st.opt_D, st.D, pre.opt_D, pre.params_D)):
        mu, nu = flatten_variables({"params": jopt[0].mu}), flatten_variables({"params": jopt[0].nu})
        for name, p in net.named_parameters():
            s = opt.state[p]
            assert float(s["step"]) == float(jopt[0].count) == 2.0 or opt is st.opt_D
            np.testing.assert_array_equal(s["exp_avg"].numpy(), mu[name])
            np.testing.assert_array_equal(s["exp_avg_sq"].numpy(), nu[name])
    assert float(st.ada.p) == 0.5 and float(st.pl_ema) == float(pre.pl_ema) and st.step == 2
    # the R1 step at iteration 0 stepped D's Adam twice
    assert float(st.opt_D.state[next(st.D.parameters())]["step"]) == 3.0
    # a missing key fails
    bad = pre.replace(opt_G=(pre.opt_G[0]._replace(mu={k: v for k, v in pre.opt_G[0].mu.items() if k != "mapping_network"}),
                             pre.opt_G[1]))
    with pytest.raises(ValueError):
        load_jax_train_state(tr.init_state(), bad)
    bad = pre.replace(params_D={**pre.params_D, "extra": {"weight": np.zeros(2, np.float32)}})
    with pytest.raises(RuntimeError):
        load_jax_train_state(tr.init_state(), bad)


# --------------------------------------------------------------------------- pieces

def test_fetch_reals_matches_jax():
    rng = np.random.RandomState(3)
    batch = {k: np.array(v) for k, v in synth_batch(rng, 4, RES).items()}
    batch["depth"][0, 0, 0, :5] = [0.0, 1.0, 81.0, 1.45, 80.0]
    batch["mask"][0, 0, 0, :5] = [0.0, 1.0, 1.0, 1.0, 1.0]
    for b in (batch, {"depth": batch["depth"] * batch["mask"]}, {"depth": (batch["depth"] * batch["mask"]).astype(np.float16)}):
        ref = j_fetch_reals({k: jnp.asarray(v) for k, v in b.items()}, 1.45, 80.0, -1.0)
        got = fetch_reals(b, 1.45, 80.0, -1.0)
        for k in ("image", "raydrop_mask"):
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("blur", [False, True])
def test_warmup_fn_matches_jax(blur, monkeypatch):
    """The JAX warmup draws its keep mask inside a vmap over samples, so it is fed one
    sample at a time, with jax.random.bernoulli replaced by a recorded uniform."""
    x = np.tanh(np.random.RandomState(4).randn(3, 1, *RES)).astype(np.float32)
    kernel = j_make_blur_kernel(1.3, 2.0) if blur else None
    draws = NumpyDraws(5)
    monkeypatch.setattr(jtrainer.jax.random, "bernoulli", lambda k, p, shape: draws.uniform(shape) < p)
    ref = np.concatenate([
        np.asarray(J_WARMUP(jnp.asarray(x[i:i + 1]), jax.random.PRNGKey(0), 0.3, -1.0,
                            None if kernel is None else jnp.asarray(kernel)))
        for i in range(3)
    ])
    got = warmup_fn(torch.from_numpy(x), ReplayStream([np.stack(draws.log)], n=3), 0.3, -1.0, kernel)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert (got.numpy() == -1.0).mean() > 0.2
    with pytest.raises(ValueError):
        warmup_fn(torch.from_numpy(x), PerSampleStream(2, torch.Generator()), 0.3, -1.0)


def test_make_blur_kernel_matches_jax():
    for sigma, init in ((0.0, 0.0), (0.0, 2.0), (1.0, 2.0), (2.0, 2.0), (0.4, 3.0)):
        got, ref = make_blur_kernel(sigma, init), j_make_blur_kernel(sigma, init)
        assert (got is None) == (ref is None)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)


def test_schedule_and_adam_hyperparameters_match_jax(jax_side):
    jt = jax_side.t
    tr = Trainer(_cfg().to_dict(), device="cpu", angle=torch.zeros(1, 2, *RES))
    for it in (0, 1, 2, 3, 4, 60, 124, 125, 126, 1000, 1003, 10 ** 6 + 3):
        assert tr.warmup_params(it) == jt.warmup_params(it)
        assert tr.ema_decay(it) == jt.ema_decay(it)
        _, do_pl, do_r1, do_ada = jt.get_step_fn(it, skip_warmup=True)  # builds, does not compile
        sched = tr.schedule(it)
        assert (sched.do_r1, sched.do_ada) == (do_r1, do_ada) and not do_pl
    c = 4 / 5  # lazy gp 4: D's Adam takes lr * c and betas ** c
    assert tr.adam_G == {"lr": 0.002, "betas": (0.0, 0.99), "eps": 1e-8}
    assert tr.adam_D["lr"] == pytest.approx(0.002 * c) and tr.adam_D["betas"] == (0.0, 0.99 ** c)
    st = tr.init_state()
    assert st.opt_D.param_groups[0]["betas"] == (0.0, 0.99 ** c) and st.opt_G.param_groups[0]["lr"] == 0.002
    assert all(not p.requires_grad for p in st.G_ema.parameters())
    # with PL on (lazy pl 2), G's Adam takes lr * c_G and betas ** c_G, c_G = 2 / 3, and PL
    # runs where the JAX step runs it
    pl_cfg = _cfg()
    pl_cfg.training.loss.pl = 1
    jt_pl = JTrainer(pl_cfg, mesh=jt.mesh, angle=jt.angle)
    tr_pl = Trainer(pl_cfg.to_dict(), device="cpu", angle=torch.zeros(1, 2, *RES))
    assert tr_pl.adam_G["lr"] == pytest.approx(0.002 * 2 / 3) and tr_pl.adam_G["betas"] == (0.0, 0.99 ** (2 / 3))
    assert tr_pl.w_pl == jt_pl.w_pl == 2.0
    for it in (0, 1, 2, 3, 4, 1003):
        assert tr_pl.schedule(it).do_pl == jt_pl.get_step_fn(it, skip_warmup=True)[1] == (it % 2 == 0)


@pytest.mark.parametrize("bf16,path", [(False, "configs/gans/dusty_v2.yaml"), (True, "configs/gans/dusty_v2_bf16.yaml")])
def test_full_train_cfg_equals_the_yaml(bf16, path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    got = full_train_cfg(bf16)
    assert set(got) == {"dataset", "training", "model"}
    for section in got:
        assert got[section] == ref[section], section


def test_generator_draws_sample_and_augment_reals():
    """Without `draws` the step draws from the trainer's generator: two trainers of one
    seed take identical steps; sample() and augment_reals() run on the state."""
    cfg = _cfg().to_dict()
    angle = torch.from_numpy(np.array(make_angle(RES)))
    batch = _np_batch(synth_batch(np.random.RandomState(6), 8, RES))
    outs, seen = [], []
    for _ in range(2):
        tr = Trainer(cfg, device="cpu", angle=angle, seed=3)
        st = tr.init_state(seed=1)
        hook = lambda name, s, values: seen.append(  # noqa: E731
            (name, sorted(values), all(p.grad is not None for p in (s.G if name == "g" else s.D).parameters())))
        m = tr.step(st, batch, 0, on_phase=hook)
        outs.append((m, _flat(st)))
    assert seen[:3] == [("g", ["loss"], True), ("d", ["loss", "y_fake", "y_real"], True), ("r1", ["penalty"], True)]
    assert all(float(outs[0][0][k]) == float(outs[1][0][k]) for k in outs[0][0])
    assert all(np.array_equal(outs[0][1][k], outs[1][1][k]) for k in outs[0][1])
    o = tr.sample(st, torch.randn(2, 16))
    assert o["image"].shape == (2, 1, *RES) and torch.isfinite(o["image"]).all()
    x = tr.augment_reals(st, batch, 0)
    assert x.shape == (8, 1, *RES) and torch.isfinite(x).all()
    with pytest.raises(ValueError):
        tr.step(st, {"depth": batch["depth"][:4]}, 1)
    # a replay that runs short fails loudly
    with pytest.raises(RuntimeError):
        tr.step(st, batch, 3, draws=ReplayStream([]))
    assert isinstance(tr.stream(), PerSampleStream)
