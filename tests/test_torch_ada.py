"""The port's ADA against dusty_gan_v2_tpu/augment/ada.py on the CPU.

The JAX module draws from threefry keys and the port from a torch.Generator, so both are
fed the same seeded numpy draws: the JAX module's PerSampleStream is replaced (pytest
monkeypatch) by `NumpyDraws.stream_class()`, which draws from numpy and records each
array in call order, and the port replays the record through
`dusty_gan_v2_tpu_torch.parallel.ReplayStream`, which checks every shape. Tolerances:
the warp operators 1e-6, augmented images 1e-4, the p controller exact; the port's
augmentation differentiates twice (gradcheck, gradgradcheck in float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu.augment import ada as jada
from dusty_gan_v2_tpu.ops import shift as jshift
from dusty_gan_v2_tpu_torch.augment import AdaptiveAugment, AdaState
from dusty_gan_v2_tpu_torch.augment import ada as tada
from dusty_gan_v2_tpu_torch.parallel import PerSampleStream, ReplayStream

CONFIG_POLICY = dict(lr_flip=1, ud_flip=1, int_trans=1, iso_scale=1, frac_trans=1, brightness=1, contrast=1,
                     luma_flip=1, hue=1, saturation=1, imgfilter=0, noise=0, cutout=0)
FULL_POLICY = {**CONFIG_POLICY, "imgfilter": 1, "noise": 1, "cutout": 1}


class NumpyDraws:
    """Seeded numpy draws in place of the JAX package's threefry draws, recorded in call
    order (`log`) for the port's ReplayStream. Uniforms under a Bernoulli are recorded,
    and logistic noise is recorded as the noise."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.log = []

    def take(self, a):
        self.log.append(a)
        return jnp.asarray(a)

    def normal(self, shape):
        return self.take(self.rng.randn(*shape).astype(np.float32))

    def uniform(self, shape, minval=0.0, maxval=1.0):
        return self.take(self.rng.uniform(minval, maxval, shape).astype(np.float32))

    def randint(self, shape, minval=0, maxval=2):
        return self.take(self.rng.randint(minval, maxval, shape).astype(np.int32))

    def logistic(self, shape, eps=1e-7):
        u = self.rng.uniform(eps, 1.0 - eps, shape).astype(np.float32)
        return self.take((np.log(u) - np.log1p(-u)).astype(np.float32))

    def stream_class(self):
        rec = self

        class Stream:
            def __init__(self, key, ids):
                self.keys = ids  # ADA reads the batch from keys.shape[0]
                self.n = ids.shape[0]

            def normal(self, shape=(), dtype=jnp.float32):
                return rec.normal((self.n, *shape))

            def uniform(self, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
                return rec.uniform((self.n, *shape), minval, maxval)

            def randint(self, shape=(), minval=0, maxval=2, dtype=jnp.int32):
                return rec.randint((self.n, *shape), minval, maxval)

            def bernoulli(self, p, shape=()):
                return rec.uniform((self.n, *shape)) < p

        return Stream

    def replay(self, n=None):
        return ReplayStream(self.log, n=n)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The sizes here are tiny: one intra-op thread is as fast, and leaves the cores to
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _images(B, H, W, seed):
    return np.tanh(np.random.RandomState(seed).randn(B, 1, H, W)).astype(np.float32)


@pytest.mark.parametrize("H,W", [(8, 64), (32, 64), (64, 512), (5, 24)])
def test_warp_chain_mats_match_jax(H, W):
    ref = jada._warp_chain_mats(H, W)
    got = tada._warp_chain_mats(H, W)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


def test_filter_bank_matches_jax():
    np.testing.assert_array_equal(tada._make_fbank(), jada._make_fbank())


def _ada_pair(policy, seed, monkeypatch, x, p=0.5, ids=None):
    draws = NumpyDraws(seed)
    monkeypatch.setattr(jada, "PerSampleStream", draws.stream_class())
    ref = jada.AdaptiveAugment(p_target=0.6, kimg=500, **policy)(jnp.asarray(x), jnp.float32(p), None, ids=ids)
    return np.asarray(ref), draws


@pytest.mark.parametrize("policy_name,res", [("config", (8, 64)), ("config", (64, 512)), ("full", (32, 64))])
def test_augment_matches_jax_at_half_strength(monkeypatch, policy_name, res):
    policy = CONFIG_POLICY if policy_name == "config" else FULL_POLICY
    x = _images(6, *res, seed=1)
    ref, draws = _ada_pair(policy, 2, monkeypatch, x)
    n_draws = len(draws.log)
    rs = draws.replay(n=6)
    got = AdaptiveAugment(p_target=0.6, kimg=500, **policy)(torch.from_numpy(x), torch.tensor(0.5), rs)
    assert rs.remaining == 0 and n_draws == (20 if policy_name == "config" else 20 + 8 + 3 + 2)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert np.abs(ref - x).max() > 0.1  # the augmentation did something


def test_augment_concatenated_batch_and_p_zero(monkeypatch):
    """A 2B batch (the trainer's reals ++ fakes) under ids, and p = 0, where only the
    wavelet up/down chain remains (close to the identity, not equal to it)."""
    x = _images(8, 8, 64, seed=3)
    ids = jnp.concatenate([jnp.arange(4, dtype=jnp.uint32), jnp.arange(4, dtype=jnp.uint32) + 4])
    for p in (0.5, 0.0):
        ref, draws = _ada_pair(CONFIG_POLICY, 4, monkeypatch, x, p=p, ids=ids)
        st = ReplayStream(draws.log).with_batch(8)
        got = AdaptiveAugment(**CONFIG_POLICY)(torch.from_numpy(x), p, st)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert np.abs(got.numpy() - x).max() < 0.2


def test_stream_batch_must_match():
    with pytest.raises(ValueError):
        AdaptiveAugment(**CONFIG_POLICY)(torch.zeros(4, 1, 8, 64), 0.5, PerSampleStream(3, torch.Generator()))


def test_draws_from_a_generator_are_seeded():
    x = torch.from_numpy(_images(4, 32, 64, seed=5))
    ada = AdaptiveAugment(**FULL_POLICY)
    a = ada(x, 0.7, PerSampleStream(4, torch.Generator().manual_seed(1)))
    b = ada(x, 0.7, PerSampleStream(4, torch.Generator().manual_seed(1)))
    c = ada(x, 0.7, PerSampleStream(4, torch.Generator().manual_seed(2)))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cumulate_and_update_p_match_jax_exactly():
    jaug = jada.AdaptiveAugment(p_init=0.3, p_target=0.6, kimg=0.02)
    taug = AdaptiveAugment(p_init=0.3, p_target=0.6, kimg=0.02)
    js, ts = jaug.init_state(), taug.init_state()
    rng = np.random.RandomState(6)
    for step in range(7):
        y = rng.randn(8, 1).astype(np.float32) + (1.0 if step % 3 else -2.0)
        y[0, 0] = 0.0  # sign(0) = 0 on both
        js = jaug.cumulate(js, jnp.asarray(y))
        ts = taug.cumulate(ts, torch.from_numpy(y))
        if step % 2:
            js, jrt = jaug.update_p(js)
            ts, trt = taug.update_p(ts)
            assert float(trt) == float(jrt)
        for a, b in zip((ts.p, ts.sign_cum, ts.n_pred_cum), (js.p, js.sign_cum, js.n_pred_cum)):
            assert float(a) == float(b)
    assert 0.0 < float(ts.p) <= 0.9
    assert isinstance(AdaState.create(0.1).p, torch.Tensor)
    no_target = AdaptiveAugment(p_init=0.2, p_target=None)
    st, _ = no_target.update_p(no_target.cumulate(no_target.init_state(), torch.ones(4, 1)))
    assert float(st.p) == np.float32(0.2) and float(st.n_pred_cum) == 0.0


@pytest.mark.parametrize("policy,H,W", [(CONFIG_POLICY, 8, 16), (FULL_POLICY, 24, 24)], ids=["config", "full"])
def test_gradcheck_and_gradgradcheck_float64(policy, H, W):
    """R1 differentiates through the augmentation: first and second derivatives against
    finite differences, float64, with the draws fixed by a replay (imgfilter needs
    H, W > 21)."""
    B = 2
    draws = NumpyDraws(7)
    jada_stream = draws.stream_class()(None, jnp.arange(B))
    # a record of every draw the port makes, from a numpy-backed stream of this batch
    ada = AdaptiveAugment(**policy)
    probe = ada(torch.zeros(B, 1, H, W), 0.9, _RecordingStream(jada_stream))
    assert probe.shape == (B, 1, H, W)

    def f(x):
        return ada(x, 0.9, ReplayStream(draws.log, n=B))

    x = torch.from_numpy(_images(B, H, W, seed=8)).double().requires_grad_()
    # fast mode: each check along random directions, not the whole Jacobian (which
    # costs one forward per input element)
    assert torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-6, fast_mode=True)
    assert torch.autograd.gradgradcheck(lambda x: f(x) ** 2, (x,), eps=1e-6, atol=1e-6, fast_mode=True)


def test_input_gradient_matches_jax_and_finite_differences(monkeypatch):
    """ADA's input gradient, which the G phase runs through (config policy, p = 0.5):
    the port against JAX's jitted gradient and against central differences of the port in
    float64. The JAX gradient is taken in its gather form of the fractional shift and
    compiled without backend optimization: XLA:CPU's optimized code differs from finite
    differences here by up to 1.6e-2 of a sample's largest element, and the one-hot
    matmul form (the JAX package's default) by up to 0.41 at any optimization level,
    while eager JAX, the port and finite differences agree (tests/test_torch_trainer.py
    runs the JAX step the same way)."""
    x = _images(8, 8, 64, seed=9)
    w = np.random.RandomState(10).randn(*x.shape).astype(np.float32)
    draws = NumpyDraws(11)
    monkeypatch.setattr(jada, "PerSampleStream", draws.stream_class())
    monkeypatch.setattr(jshift, "_SHIFT_IMPL", "gather")
    ja = jada.AdaptiveAugment(**CONFIG_POLICY)
    grad = jax.jit(jax.grad(lambda xx: jnp.sum(ja(xx, jnp.float32(0.5), None) * w)),
                   compiler_options={"xla_backend_optimization_level": 0})
    ref = np.asarray(grad(jnp.asarray(x)))
    ada = AdaptiveAugment(**CONFIG_POLICY)

    def loss(xx):
        return (ada(xx, 0.5, ReplayStream(draws.log, n=8)) * torch.from_numpy(w).to(xx.dtype)).sum()

    xt = torch.from_numpy(x).requires_grad_()
    loss(xt).backward()
    got = xt.grad.numpy()
    for b in range(8):
        assert np.abs(got[b] - ref[b]).max() <= 1e-5 * np.abs(ref[b]).max(), b
    d = torch.from_numpy(np.random.RandomState(12).randn(*x.shape))
    x64, eps = torch.from_numpy(x).double(), 1e-4
    fd = (loss(x64 + eps * d) - loss(x64 - eps * d)) / (2 * eps)
    assert abs(float(fd) - float((xt.grad.double() * d).sum())) <= 1e-4 * abs(float(fd))


class _RecordingStream:
    """Adapts a NumpyDraws stream to the port's stream API (torch tensors out)."""

    def __init__(self, st):
        self.st, self.n = st, st.n

    def _t(self, a):
        return torch.from_numpy(np.array(a))

    def normal(self, shape=()):
        return self._t(self.st.normal(shape))

    def uniform(self, shape=(), minval=0.0, maxval=1.0):
        return self._t(self.st.uniform(shape, minval=minval, maxval=maxval))

    def randint(self, shape=()):
        return self._t(self.st.randint(shape))
