"""The port's fused act -> resample chain against the JAX package on the CPU.

The JAX functions run their Pallas kernels in interpret mode, as tests/test_fused_chain.py
runs them; the port takes its plain versions (the tensors lie on the CPU) under the same
autograd Functions the card uses. Inputs come from a numpy seed. Tolerance 1e-5 (abs and
rel), the JAX test's own: float32 reassociation between the two products' sum orders.
The double backward has no JAX oracle (no JAX path takes one through the custom VJP);
it is held against the plain composition under torch.autograd and against finite
differences in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu.ops import fused_chain as jchain
from dusty_gan_v2_tpu.ops import make_resample as jmake_resample
from dusty_gan_v2_tpu_torch import ops
from dusty_gan_v2_tpu_torch.ops import fused_chain as tchain

TOL = 1e-5
CASES = [
    ((2, 4, 8, 16), 1, 1),  # blur (the discriminator block's main path and skip)
    ((2, 4, 8, 16), 2, 1),  # 2x up (generator block)
    ((2, 4, 8, 16), 1, 2),  # 2x down
    ((3, 2, 6, 12), 1, 1),  # odd plane count
]
IDS = ["blur", "up2", "down2", "odd-planes"]


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a, copy=True))
    return out if dtype is None else out.to(dtype)


def close(got, ref, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, dtype=np.float32), rtol=tol, atol=tol)


def plans(up, down):
    kw = dict(up=up, down=down, window=(1, 3, 3, 1), ring=True)
    return jmake_resample(**kw), ops.make_resample(**kw)


@pytest.mark.parametrize("shape,up,down", CASES, ids=IDS)
def test_fused_act_resample_forward_matches_jax(shape, up, down):
    jplan, tplan = plans(up, down)
    x, b = rand(*shape, seed=0), rand(shape[1], seed=1)
    ref = jchain.fused_act_resample(jnp.asarray(x), jnp.asarray(b), jplan)
    got = ops.fused_act_resample(t(x), t(b), tplan)
    assert tuple(got.shape) == ref.shape
    close(got, ref)


@pytest.mark.parametrize("shape,up,down", CASES, ids=IDS)
def test_fused_act_resample_grads_match_jax(shape, up, down):
    jplan, tplan = plans(up, down)
    x, b = rand(*shape, seed=2), rand(shape[1], seed=3, scale=0.1)
    co = rand(*jplan.out_shape(*shape[2:]), seed=4)[None, None]
    gx_ref, gb_ref = jax.grad(
        lambda x, b: jnp.sum(jchain.fused_act_resample(x, b, jplan) * co), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(b))
    xt, bt = t(x).requires_grad_(), t(b).requires_grad_()
    (ops.fused_act_resample(xt, bt, tplan) * t(co)).sum().backward()
    close(xt.grad, gx_ref)
    close(bt.grad, gb_ref)


@pytest.mark.parametrize("shape,up,down", CASES, ids=IDS)
def test_fused_resample_and_grad_match_jax(shape, up, down):
    jplan, tplan = plans(up, down)
    x = rand(*shape, seed=5)
    co = rand(*jplan.out_shape(*shape[2:]), seed=6)[None, None]
    close(ops.fused_resample(t(x), tplan), jchain.pallas_resample(jnp.asarray(x), jplan))
    g_ref = jax.grad(lambda v: jnp.sum(jchain.pallas_resample(v, jplan) * co))(jnp.asarray(x))
    xt = t(x).requires_grad_()
    (ops.fused_resample(xt, tplan) * t(co)).sum().backward()
    close(xt.grad, g_ref)


def test_fused_chain_equals_unfused_pair():
    _, plan = plans(1, 1)
    x, b = t(rand(2, 4, 8, 16, seed=7)), t(rand(4, seed=8))
    assert torch.equal(ops.fused_act_resample(x, b, plan), ops.resample(ops.fused_leaky_relu(x, b), plan))
    assert torch.equal(ops.fused_resample(x, plan), ops.resample(x, plan))


def test_bf16_rounding_placement_matches_jax():
    """bfloat16: bias rounded first, activation in float32 and rounded, each product
    accumulated in float32 and rounded. Forward within one bf16 ulp of the JAX kernel
    (the two sum in different orders, which can flip a rounding); the port's backward
    equals the stated formula bit for bit."""
    jplan, tplan = plans(1, 1)
    x, b = rand(2, 4, 8, 16, seed=9), rand(4, seed=10)
    xb, bb = t(x, torch.bfloat16), t(b)
    ref = jchain.fused_act_resample(jnp.asarray(x, jnp.bfloat16), jnp.asarray(b), jplan)
    got = ops.fused_act_resample(xb, bb, tplan)
    assert got.dtype == torch.bfloat16
    ref = t(np.asarray(ref.astype(jnp.float32)))
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=2.0**-100))) - 7)
    # an output near zero sums terms of the plane's size: allow their ulp as well
    slack = ulp.amax(dim=(-2, -1), keepdim=True)
    assert bool(((got.float() - ref).abs() <= ulp + slack).all())

    o = tchain.chain_operators(tplan, 8, 16, xb.device, torch.bfloat16)
    y = ops.fused_leaky_relu(xb, bb)  # one rounding
    z = (y.float() @ o.wmT.float()).to(torch.bfloat16)
    want = (o.hm.float() @ z.float()).to(torch.bfloat16)
    assert torch.equal(got, want)

    g = t(rand(2, 4, 8, 16, seed=11), torch.bfloat16)
    xg = xb.clone().requires_grad_()
    (dx,) = torch.autograd.grad(ops.fused_act_resample(xg, bb, tplan), xg, g)
    tt = (o.hmT.float() @ g.float()).to(torch.bfloat16)
    pre = xb.float() + bb.to(torch.bfloat16).float().reshape(1, -1, 1, 1)
    mask = torch.where(pre >= 0, torch.tensor(2.0**0.5), torch.tensor(2.0**0.5 * 0.2))
    assert torch.equal(dx, ((tt.float() @ o.wm.float()) * mask).to(torch.bfloat16))


def test_backward_kernel_plain_version_masks_from_the_input():
    _, plan = plans(1, 1)
    x, b, g = t(rand(2, 3, 8, 16, seed=12)), t(rand(3, seed=13)), t(rand(2, 3, 8, 16, seed=14))
    o = tchain.chain_operators(plan, 8, 16, x.device, x.dtype)
    dx = ops.fused_act_resample_bwd_plain(g, x, b, o.wm, o.hmT)
    xr = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(ops.resample(ops.fused_leaky_relu(xr, b), plan), xr, g)
    close(dx, want)


def _f64(shape, plan_kw, seed):
    plan = ops.make_resample(window=(1, 3, 3, 1), ring=True, **plan_kw)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape)).requires_grad_()
    # keep pre-activations away from the kink, where finite differences are wrong
    b = torch.from_numpy(rng.randn(shape[1]) * 0.1)
    with torch.no_grad():
        pre = x + b.reshape(1, -1, 1, 1)
        x += torch.where(pre.abs() < 0.05, 0.1 * torch.sign(pre) + (pre == 0) * 0.1, torch.zeros_like(pre))
    return plan, x, b.requires_grad_()


@pytest.mark.parametrize("plan_kw", [dict(), dict(up=2), dict(down=2)], ids=["blur", "up2", "down2"])
def test_gradcheck_and_gradgradcheck_float64(plan_kw):
    plan, x, b = _f64((2, 2, 4, 8), plan_kw, seed=15)
    act = lambda x, b: ops.fused_act_resample(x, b, plan)  # noqa: E731
    lin = lambda x: ops.fused_resample(x, plan)  # noqa: E731
    assert torch.autograd.gradcheck(act, (x, b), eps=1e-6, atol=1e-6)
    assert torch.autograd.gradgradcheck(act, (x, b), eps=1e-6, atol=1e-6)
    assert torch.autograd.gradcheck(lin, (x,), eps=1e-6, atol=1e-6)
    assert torch.autograd.gradgradcheck(lin, (x,), eps=1e-6, atol=1e-6)


def test_double_backward_matches_plain_composition():
    """An R1-shaped second derivative, d/dx sum((d sum(f(x) * c) / dx)^2) through a
    nonlinearity after the chain, against the unfused pair under torch.autograd."""
    _, plan = plans(1, 1)
    x, b, c = rand(2, 3, 8, 16, seed=16), rand(3, seed=17), rand(2, 3, 8, 16, seed=18)

    def second(f):
        xt, bt = t(x).requires_grad_(), t(b).requires_grad_()
        y = torch.tanh(f(xt, bt)) * t(c)
        (g,) = torch.autograd.grad(y.sum(), xt, create_graph=True)
        return torch.autograd.grad(g.square().sum(), (xt, bt))

    got = second(lambda x, b: ops.fused_act_resample(x, b, plan) + ops.fused_resample(x, plan))
    want = second(lambda x, b: ops.resample(ops.fused_leaky_relu(x, b), plan) + ops.resample(x, plan))
    for a, r in zip(got, want):
        close(a, r.detach().numpy())


def test_chain_wrappers_reject_cpu_tensors_and_shapes_outside_the_contract():
    _, plan = plans(1, 1)
    x, b = torch.zeros(1, 2, 8, 16), torch.zeros(2)
    o = tchain.chain_operators(plan, 8, 16, x.device, x.dtype)
    with pytest.raises(ValueError):
        ops.fused_chain_fwd_cuda(x, b, o)
    with pytest.raises(ValueError):
        ops.fused_chain_bwd_cuda(x, x, b, o)
    assert tchain.MAX_ROWS == 128 and tchain.MAX_COLS == 512
    assert ops.fused_chain_fwd_cuda.launches == 0 and ops.fused_chain_bwd_cuda.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 8], ids=lambda k: f"offset{k}")
def test_chain_wrappers_reject_views_the_kernels_cannot_read_in_vectors(offset, dtype):
    """The kernels read planes and ELL rows in 16-byte vectors: a contiguous view that
    starts off that alignment (a slice of a flat buffer) is refused before any launch."""
    flat = torch.zeros(64 + 2 * 8 * 16, dtype=dtype)
    view = flat[offset : offset + 2 * 8 * 16].view(1, 2, 8, 16)
    assert view.is_contiguous()
    if (offset * flat.element_size()) % 16:
        with pytest.raises(ValueError, match="aligned"):
            tchain._check_aligned("fused_chain_fwd_cuda", view)
    else:
        tchain._check_aligned("fused_chain_fwd_cuda", view)


# ------------------------------------------------------------------ the kernels' operator form

def _dense_random():
    rng = np.random.RandomState(19)
    return tchain.operators_from_dense(torch.from_numpy((rng.randn(24, 40) / np.sqrt(40)).astype(np.float32)),
                                       torch.from_numpy((rng.randn(100, 72) / np.sqrt(100)).astype(np.float32)))


# (plan keywords or None for dense random operators, (H, W), nnz of hm_ell, wmT_ell, hmT_ell,
# wm_ell): the discriminator's four blur sites, the generator's 2x up site, a 2x down, the
# ragged sizes the card is checked at, and dense random operators (40 x 100 -> 24 x 72)
ELL_SITES = [
    (dict(), (64, 512), (4, 4, 4, 4)), (dict(), (32, 256), (4, 4, 4, 4)), (dict(), (16, 128), (4, 4, 4, 4)),
    (dict(), (8, 64), (4, 4, 4, 4)), (dict(up=2), (32, 256), (2, 2, 4, 4)), (dict(down=2), (64, 512), (4, 4, 2, 2)),
    (dict(), (6, 12), (4, 4, 4, 4)), (dict(up=2), (23, 70), (2, 2, 4, 4)), (dict(down=2), (46, 140), (4, 4, 2, 2)),
    (None, (40, 100), (40, 100, 24, 72)),
]
ELL_IDS = ["blur-64x512", "blur-32x256", "blur-16x128", "blur-8x64", "up2-32x256", "down2-64x512",
           "blur-6x12", "up2-23x70", "down2-46x140", "dense-random"]


def _site_operators(plan_kw, hw, dtype=torch.float32):
    if plan_kw is None:
        o = _dense_random()
        return tchain.operators_from_dense(o.hm.to(dtype), o.wmT.to(dtype))
    return tchain.chain_operators(ops.make_resample(window=(1, 3, 3, 1), ring=True, **plan_kw), *hw, torch.device("cpu"), dtype)


def _forms(o):
    """(ELL form, the dense (n_out, n_in) matrix whose rows it holds) of every pass."""
    return ((o.hm_ell, o.hm), (o.wmT_ell, o.wmT.t()), (o.hmT_ell, o.hmT), (o.wm_ell, o.wm.t()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("plan_kw,hw,nnz", ELL_SITES, ids=ELL_IDS)
def test_ell_scatters_back_to_the_dense_operator(plan_kw, hw, nnz, dtype):
    for e, m in _forms(_site_operators(plan_kw, hw, dtype)):
        assert e.idx.dtype == torch.int32 and e.val.dtype == dtype and e.idx.shape == e.val.shape
        back = torch.zeros(m.shape, dtype=dtype).scatter_add_(1, e.idx.long(), e.val)
        assert torch.equal(back, m)


@pytest.mark.parametrize("plan_kw,hw,nnz", ELL_SITES, ids=ELL_IDS)
def test_ell_rows_ascend_and_pad_with_zero_at_a_valid_index(plan_kw, hw, nnz):
    for e, m in _forms(_site_operators(plan_kw, hw)):
        real = e.val != 0
        assert bool((e.idx >= 0).all()) and bool((e.idx < m.shape[1]).all())
        # the real entries come first and ascend; padding repeats the row's last index
        assert bool((real[:, :-1] | ~real[:, 1:]).all())
        step = e.idx[:, 1:] - e.idx[:, :-1]
        assert bool((step[real[:, 1:]] > 0).all()) and bool((step[~real[:, 1:]] == 0).all())
        assert torch.equal(real.sum(1), (m != 0).sum(1))


@pytest.mark.parametrize("plan_kw,hw,nnz", ELL_SITES, ids=ELL_IDS)
def test_ell_width_counts_the_non_zeros(plan_kw, hw, nnz):
    o = _site_operators(plan_kw, hw)
    assert tuple(e.nnz for e, _ in _forms(o)) == nnz
    assert tuple(int((m != 0).sum(1).max()) for _, m in _forms(o)) == nnz


@pytest.mark.parametrize("plan_kw,hw,nnz", ELL_SITES, ids=ELL_IDS)
def test_adjoint_swaps_every_form(plan_kw, hw, nnz):
    o = _site_operators(plan_kw, hw)
    a = o.adjoint
    assert a.hm is o.hmT and a.wmT is o.wm and a.hmT is o.hm and a.wm is o.wmT
    assert a.hm_ell is o.hmT_ell and a.wmT_ell is o.wm_ell and a.hmT_ell is o.hm_ell and a.wm_ell is o.wmT_ell
    assert all(x is y for x, y in zip(a.adjoint, o))


def _ell_apply(e, v):
    """Along v's last axis: out[..., o] = sum_k val[o, k] * v[..., idx[o, k]], in ascending k."""
    terms = v[..., e.idx.long()] * e.val
    out = torch.zeros(terms.shape[:-1], dtype=terms.dtype)
    for k in range(e.nnz):
        out = out + terms[..., k]
    return out


@pytest.mark.parametrize("plan_kw,hw,nnz", ELL_SITES, ids=ELL_IDS)
def test_ell_passes_equal_the_dense_products(plan_kw, hw, nnz):
    """The kernels' contraction as the forms orient it: the W-pass through wmT_ell along
    the columns, the H-pass through hm_ell along the rows; the adjoint through hmT_ell
    first, then wm_ell."""
    o = _site_operators(plan_kw, hw)
    (H, W), (Ho, Wo) = hw, (o.hm.shape[0], o.wmT.shape[1])
    x, g = t(rand(2, 3, H, W, seed=20)), t(rand(2, 3, Ho, Wo, seed=21))
    fwd = _ell_apply(o.hm_ell, _ell_apply(o.wmT_ell, x).transpose(-1, -2)).transpose(-1, -2)
    close(fwd, ops.fused_resample_plain(x, o.wmT, o.hm))
    adj = _ell_apply(o.wm_ell, _ell_apply(o.hmT_ell, g.transpose(-1, -2)).transpose(-1, -2))
    close(adj, ops.fused_resample_plain(g, o.wm, o.hmT))
