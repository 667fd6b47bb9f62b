"""The port's DiffAugment (dusty_gan_v2_tpu_torch/augment/diff_augment.py) against the JAX
package's (dusty_gan_v2_tpu/augment/diff_augment.py) on the CPU.

The JAX ops draw from threefry keys: op i of the policy from fold_in(rng, i), split as
the op splits it. The test makes the same draws with the same keys (a Bernoulli choice as
the uniforms under it, which is how jax.random.bernoulli draws) and hands them to the
port through a ReplayStream in the port's order. Bars: outputs and input gradients 1e-6;
the controller's p, sums and rt 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu.augment import ada as jada
from dusty_gan_v2_tpu.augment import diff_augment as jdiff
from dusty_gan_v2_tpu_torch.augment import AdaState, DiffAugment
from dusty_gan_v2_tpu_torch.augment import diff_augment as pdiff
from dusty_gan_v2_tpu_torch.parallel import PerSampleStream, ReplayStream

B, C, H, W = 5, 2, 8, 32
P = 0.6


def _jax_draws(name, key, shape, p):
    """The arrays the JAX op `name` draws from `key`, in the port's draw order."""
    B, _, H, W = shape
    one = (B, 1, 1, 1)
    u = lambda k: np.asarray(jax.random.uniform(k, one))  # noqa: E731  (bernoulli's uniforms)
    if name == "flip":
        return [u(key)]
    if name in ("brightness", "contrast"):
        k1, k2 = jax.random.split(key)
        return [np.asarray(jax.random.normal(k1, one)), u(k2)]
    k1, k2, k3 = jax.random.split(key, 3)
    if name == "translation":
        sh, sw = int(H / 8 / 2 + 0.5), int(W / 8 / 2 + 0.5)
        lo, hi = (-sh, sh + 1), (-sw, sw + 1)
    else:  # cutout
        ch, cw = int(H * 0.5 + 0.5), int(W * 0.5 + 0.5)
        lo, hi = (0, H + (1 - ch % 2)), (0, W + (1 - cw % 2))
    return [np.asarray(jax.random.randint(k1, (B, 1, 1), *lo)), np.asarray(jax.random.randint(k2, (B, 1, 1), *hi)),
            u(k3)]


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(B, C, H, W).astype(np.float32), rng.randn(B, C, H, W).astype(np.float32)


@pytest.mark.parametrize("name", ["flip", "brightness", "contrast", "translation", "cutout"])
def test_op_matches_jax(name):
    """Each op's output and its input gradient (a cotangent pulled back) on JAX's draws."""
    x, cot = _inputs(1)
    key = jax.random.PRNGKey(3)
    fn = lambda xx: jdiff._FNS[name](xx, key, P)  # noqa: E731
    ref, vjp = jax.vjp(fn, jnp.asarray(x))
    (ref_g,) = vjp(jnp.asarray(cot))
    draws = _jax_draws(name, key, x.shape, P)
    rs = ReplayStream(draws)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pdiff._FNS[name](xt, rs, P)
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    assert rs.remaining == 0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), rtol=1e-6, atol=1e-6)
    applied = (draws[-1] < (P * 0.5 if name == "flip" else P)).reshape(-1)
    assert 0 < applied.sum() < B  # some samples augmented, some kept
    moved = np.abs(np.asarray(ref) - x).reshape(B, -1).max(1) > 0
    np.testing.assert_array_equal(moved[~applied], False)


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_policy_matches_jax(p):
    """The whole default policy in order, each op on fold_in(rng, i)."""
    x, _ = _inputs(2)
    aug = jdiff.DiffAugment()
    rng = jax.random.PRNGKey(9)
    ref = aug(jnp.asarray(x), p, rng)
    draws = [a for i, name in enumerate(aug.policy) for a in _jax_draws(name, jax.random.fold_in(rng, i), x.shape, p)]
    rs = ReplayStream(draws)
    got = DiffAugment()(torch.from_numpy(x), p, rs)
    assert rs.remaining == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    if p == 0.0:
        np.testing.assert_array_equal(got.numpy(), x)


def test_translation_wraps_modulo_width_minus_one():
    """The reference's % (W - 1): a shift by 0 still moves column W - 1 to column 0."""
    x = torch.arange(W, dtype=torch.float32).expand(1, 1, H, W).contiguous()
    zeros = np.zeros((1, 1, 1), np.int64)
    out = pdiff.rand_translation(x, ReplayStream([zeros, zeros, np.zeros((1, 1, 1, 1))]), 1.0)
    assert out[0, 0, 0, -1] == 0.0 and torch.equal(out[0, 0, 0, :-1], x[0, 0, 0, :-1])


def test_controller_matches_jax():
    """cumulate (sign sums of D(real)) then update_p, twice, and p_target None."""
    rng = np.random.RandomState(5)
    aug, jaug = DiffAugment(p_init=0.2, kimg=0.004), jdiff.DiffAugment(p_init=0.2, kimg=0.004)
    st, jst = aug.init_state(), jaug.init_state()
    for _ in range(2):
        for _ in range(3):
            y = rng.randn(16, 1).astype(np.float32) + 1.5  # rt above the 0.6 target
            st, jst = aug.cumulate(st, torch.from_numpy(y)), jaug.cumulate(jst, jnp.asarray(y))
        for a, b in zip((st.p, st.sign_cum, st.n_pred_cum), (jst.p, jst.sign_cum, jst.n_pred_cum)):
            assert abs(float(a) - float(b)) <= 1e-6
        (st, rt), (jst, jrt) = aug.update_p(st), jaug.update_p(jst)
        assert abs(float(rt) - float(jrt)) <= 1e-6 and abs(float(st.p) - float(jst.p)) <= 1e-6
        assert float(st.sign_cum) == float(st.n_pred_cum) == 0.0
    assert float(st.p) == 1.0  # moved up, clipped at 1 (not at ADA's p_max 0.9)
    assert isinstance(st, AdaState) and isinstance(jst, jada.AdaState)
    fixed, jfixed = DiffAugment(p_target=None), jdiff.DiffAugment(p_target=None)
    assert fixed.p_init == jfixed.p_init == 1.0
    s, _ = fixed.update_p(fixed.cumulate(fixed.init_state(), torch.ones(4, 1)))
    assert float(s.p) == 1.0


def test_draws_from_a_per_sample_stream():
    """On the port's own stream: the batch is checked, and the same seed draws the same."""
    x = torch.randn(B, C, H, W, generator=torch.Generator().manual_seed(0))
    a = DiffAugment()(x, 0.5, PerSampleStream(B, torch.Generator().manual_seed(1)))
    b = DiffAugment()(x, 0.5, PerSampleStream(B, torch.Generator().manual_seed(1)))
    assert torch.equal(a, b) and not torch.equal(a, x)
    with pytest.raises(ValueError, match="stream draws for"):
        DiffAugment()(x, 0.5, PerSampleStream(B + 1, torch.Generator()))
    with pytest.raises(ValueError, match="unknown DiffAugment ops"):
        DiffAugment(policy=["color"])
