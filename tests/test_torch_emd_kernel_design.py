"""The numerics of the fused EMD kernel's design (csrc/emd.cu), held on the CPU.

The kernel runs only on a card; chip_smoke.py holds it against its plain version there.
Here a float32 emulation of its recurrence is held against that plain version,
metrics/distance.py::earth_mover_distance, at the evaluation's size (2048 x 2048 points a
pair) within the same bar of 1e-5 relative per pair. The emulation does what the kernel
does differently from the plain version:
- the sweep order A(0), then B(l) and C(l) + A(l+1) for l = 0..7, then B(8) and C(8);
- every exponential of the exact product of d and the level (a power of two), with a
  relative error of up to 2 * 2^-23 (CUDA's expf, which torch.exp also uses on the card,
  against the CPU's), and the cost's square root (sqrt.approx) with up to 2 * 2^-23,
  either of random sign per element or all of one sign: at or above the largest errors
  that CUDA documents for expf and that scripts/torch_emd_kernel_variants.py measures
  for sqrt.approx on an H100.
d is the plain version's to the bit (the kernel repeats its operation order), so the
emulation takes it from pairwise_sqdist. Two pairs a kind show the typical error, not the
rare pairs near the bar that sets of 256 pairs show on the card
(scripts/torch_emd_kernel_variants.py, chip_smoke.py). The plain version is then held against the JAX
package's earth_mover_distance on the same kinds of clouds, as tests/test_torch_metrics.py
does at smaller sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu.metrics import distance as j_dist
from dusty_gan_v2_tpu_torch.metrics.distance import _multipliers, earth_mover_distance, pairwise_sqdist

# the levels -4^(7 - l): powers of two, so a product with d is exact in float32
LEVELS = [-(4.0 ** (7 - l)) for l in range(9)]
EXP_ULP, SQRT_ULP = 2.0 * 2.0**-23, 2.0 * 2.0**-23  # relative
N_POINTS, N_PAIRS = 2048, 2


def clouds(kind, seed, B=N_PAIRS, n=N_POINTS):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, n, 3).astype(np.float32)
    if kind == "origin30":  # dropped rays sit on the origin: d = 0 and K = 1 at every level
        x[rng.rand(B, n) < 0.3] = 0.0
    return x


def emulate_kernel(x, y, error=None, seed=0):
    """(B,) costs of csrc/emd.cu's recurrence in float32. error: None (the approximations
    exact), "random" (each result off by up to the bound, of random sign) or "high" (all
    off by the bound, upwards)."""
    gen = torch.Generator().manual_seed(seed)

    def perturb(v, bound):
        if error is None:
            return v
        if error == "high":
            return v * (1 + bound)
        sign = torch.randint(0, 2, v.shape, generator=gen).to(v.dtype) * 2 - 1
        return v * (1 + bound * sign)

    def kexp(level):
        return perturb(torch.exp(D * level), EXP_ULP)

    D = pairwise_sqdist(x, y)
    B, n, m = D.shape
    multiL, multiR = _multipliers(n, m)
    sq = perturb(torch.sqrt(D), SQRT_ULP)
    remainL = D.new_full((B, n), multiL)
    remainR = D.new_full((B, m), multiR)
    cost = D.new_zeros((B,))
    ratioL = remainL / (1e-9 + (kexp(LEVELS[0]) * remainR[:, None, :]).sum(2))
    for level in range(9):
        # B(l)
        sumr = (kexp(LEVELS[level]) * ratioL[:, :, None]).sum(1) * remainR
        rr = torch.clamp(remainR / (sumr + 1e-9), max=1.0) * remainR
        remainR = torch.clamp(remainR - sumr, min=0.0)
        # C(l), fused with A(l + 1) below the last level
        last = level == len(LEVELS) - 1
        if not last:
            ka = (kexp(LEVELS[level + 1]) * remainR[:, None, :]).sum(2)
        kr = kexp(LEVELS[level]) * rr[:, None, :]
        cost = cost + (ratioL * (kr * sq).sum(2)).sum(1)
        remainL = torch.clamp(remainL - ratioL * kr.sum(2), min=0.0)
        if not last:
            ratioL = remainL / (1e-9 + ka)
    return cost


@pytest.fixture(scope="module", params=["uniform", "origin30"])
def pair_set(request):
    kind = request.param
    x, y = torch.from_numpy(clouds(kind, 0)), torch.from_numpy(clouds(kind, 1))
    return kind, x, y, earth_mover_distance(x, y)


def test_next_level_scale_is_exact():
    """The kernel steps its level by 0.25 from -16384 (and the fused sweep takes level
    l+1's as a quarter of level l's): exact, and so is every product L d, so K's argument
    is the plain version's level * D to the bit."""
    d = torch.from_numpy(np.random.RandomState(2).rand(4096).astype(np.float32))
    level = np.float32(-16384.0)
    for want in LEVELS:
        assert float(level) == want
        assert torch.equal((d * float(level)).double(), d.double() * want)
        level = np.float32(level * np.float32(0.25))


@pytest.mark.parametrize("error", [None, "random", "high"])
def test_kernel_recurrence_matches_the_plain_version(pair_set, error):
    kind, x, y, ref = pair_set
    got = emulate_kernel(x, y, error)
    assert bool(torch.isfinite(got).all()) and bool((ref > 0).all())
    rel = ((got - ref).abs() / ref).max().item()
    assert rel <= 1e-5, f"{kind} clouds, approximation error {error}: max relative error per pair {rel}"


@pytest.mark.parametrize("kind", ["uniform", "origin30"])
def test_plain_version_matches_jax(kind):
    """At 1024 x 1024, rtol 1e-5. The plain version's pairwise_sqdist differs from JAX's
    matmul form by ~1e-7 an entry, which exp(-16384 d) turns into ~1e-3 of single entries
    of K; the cost, a sum over the whole plan, holds the bar (at 2048 x 2048 with origin
    points the two sit 1.5e-5 apart, JAX's d being the one that differs from the kernel's)."""
    x, y = clouds(kind, 3, n=1024), clouds(kind, 4, n=1024)
    ref = j_dist.earth_mover_distance(jnp.asarray(x), jnp.asarray(y))
    got = earth_mover_distance(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
