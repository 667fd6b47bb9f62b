"""The port's dusty_v2 discriminator, its ops and the D-side loss phases against the JAX
package on the CPU.

A small discriminator (ch_base 8, ch_max 64, 16x64, B=4, as tests/test_models.py's
D_CFG_V2) is initialised in JAX, every parameter is replaced from a numpy seed (biases
non-zero), and the variables are carried into the port by convert/jax_variables.py.
Tolerances: 1e-5 for single ops (float32 reassociation between XLA and PyTorch CPU
kernels), 1e-4 for logits, losses and gradients of the whole model (the bar the JAX
package held against its own torch reference), gradients relative to the reference's
largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu import ops as jops
from dusty_gan_v2_tpu.models import build_discriminator as j_build_discriminator
from dusty_gan_v2_tpu.models import loss as jloss
from dusty_gan_v2_tpu.ops import blurconv as jblurconv
from dusty_gan_v2_tpu.ops import pad as jpad
from dusty_gan_v2_tpu_torch import ops
from dusty_gan_v2_tpu_torch.convert import flatten_variables, load_jax_variables
from dusty_gan_v2_tpu_torch.models import GAN_OBJECTIVES, build_discriminator, gan_loss_d, gan_loss_g
from dusty_gan_v2_tpu_torch.sampling import full_disc_cfg
from dusty_gan_v2_tpu_torch.training import d_phase_loss, g_phase_loss, r1_penalty

RES, B = (16, 64), 4
D_CFG = {
    "arch": "dusty_v2",
    "layer_kwargs": {
        "in_ch": 1, "ring": True, "ch_base": 8, "ch_max": 64, "resolution": RES,
        "mbdis_group": 4, "mbdis_feat": 1, "num_fp16_layers": -1, "pre_blur": True,
    },
}
TOL = 1e-5


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


def close_rel_max(got, ref, tol=1e-4):
    """max |got - ref| <= tol * max |ref|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-12)


# --------------------------------------------------------------------------- ops

@pytest.mark.parametrize("mode", ["replicate", "reflect", "zeros"])
@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("padding", [1, (2, 1, 0, 3)])
def test_pad2d_matches_jax(mode, ring, padding):
    x = rand(2, 3, 5, 6, seed=1)
    close(ops.pad2d(t(x), padding, ring=ring, mode=mode), jpad.pad2d(jnp.asarray(x), padding, ring=ring, mode=mode), 0)


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (4, 2)])
@pytest.mark.parametrize("h_mode", ["replicate", "reflect"])
def test_conv_ring_fast_matches_jax(k, stride, h_mode):
    x, w = rand(2, 3, 8, 12, seed=2), rand(5, 3, k, k, seed=3, scale=0.3)
    ref = jpad.conv_ring_fast(jnp.asarray(x), jnp.asarray(w), (stride, stride), h_mode)
    got = ops.conv_ring_fast(t(x), t(w), (stride, stride), h_mode)
    assert tuple(got.shape) == ref.shape
    close(got, ref)
    if k == 3 and h_mode == "replicate":
        close(ops.conv3x3_ring_fast(t(x), t(w), (stride, stride)), ref)


def test_conv_ring_fast_rejects_other_kernels():
    with pytest.raises(ValueError):
        ops.conv_ring_fast(torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, 5, 5))
    with pytest.raises(ValueError):
        ops.conv_ring_fast(torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, 3, 3), (1, 1), "zeros")


RING_CONVS = [
    dict(kernel_size=3, stride=1, padding=1, ring=True),  # block conv1, epilogue conv
    dict(kernel_size=3, stride=2, padding=1, ring=True),  # block conv2
    dict(kernel_size=1, stride=2, padding=0, ring=True),  # block skip
    dict(kernel_size=1, stride=1, padding=0, ring=True, use_bias=True, gain=2.0, lr_mul=0.5),
    dict(kernel_size=3, stride=1, padding=1, ring=False, pad_mode="reflect"),
    dict(kernel_size=4, stride=2, padding=1, ring=True, pad_mode="reflect"),
    dict(kernel_size=3, stride=1, padding=2, ring=True),  # not the pad-1 case
]


@pytest.mark.parametrize("kw", RING_CONVS, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_ring_conv2d_matches_jax(kw):
    kw = {"use_bias": False, **kw}
    x = rand(2, 3, 8, 12, seed=4)
    m = jops.RingConv2d(in_ch=3, out_ch=5, **kw)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(5)
    v = jax.tree_util.tree_map(lambda a: (rng.randn(*a.shape) * 0.5).astype(np.float32), v)
    p = load_jax_variables(ops.RingConv2d(3, 5, **kw), v)
    assert set(p.state_dict()) == set(flatten_variables(v))
    close(p(t(x)), m.apply(v, jnp.asarray(x)))


def test_blur_vh_matches_jax():
    x = rand(2, 3, 8, 16, seed=6)
    ref = jops.blur_vh(jnp.asarray(x))
    got = ops.blur_vh(t(x))
    assert tuple(got.shape) == ref.shape == (2, 6, 8, 16)
    close(got, ref)
    close(ops.blur_vh(t(x), ring=False), jops.blur_vh(jnp.asarray(x), ring=False))


@pytest.mark.parametrize("batch,group,features", [(8, 4, 1), (2, 4, 1), (4, 4, 2), (6, 2, 3)])
def test_minibatch_stddev_matches_jax(batch, group, features):
    x = rand(batch, 6, 4, 8, seed=7)
    ref = jops.minibatch_stddev(jnp.asarray(x), group=group, features=features)
    got = ops.minibatch_stddev(t(x), group=group, features=features)
    assert tuple(got.shape) == ref.shape == (batch, 6 + features, 4, 8)
    close(got, ref)


@pytest.mark.parametrize("shape", [(2, 3, 8, 16), (1, 2, 6, 8), (2, 2, 16, 64)])
def test_blur_conv_composites_match_jax_and_the_two_stage_op(shape):
    x = rand(*shape, seed=8)
    w3, w1 = rand(5, shape[1], 3, 3, seed=9, scale=0.3), rand(5, shape[1], 1, 1, seed=10, scale=0.3)
    xt = t(x)
    got3, got1 = ops.blur_conv3x3s2_ring(xt, t(w3)), ops.blur_conv1x1s2_ring(xt, t(w1))
    close(got3, jblurconv.blur_conv3x3s2_ring(jnp.asarray(x), jnp.asarray(w3)))
    close(got1, jblurconv.blur_conv1x1s2_ring(jnp.asarray(x), jnp.asarray(w1)))
    blurred = ops.resample(xt, ops.make_resample(window=(1, 3, 3, 1), ring=True))
    close(got3, ops.conv_ring_fast(blurred, t(w3), (2, 2)))
    close(got1, torch.nn.functional.conv2d(blurred, t(w1), stride=2))


def test_blur_conv_grads_match_the_two_stage_op():
    x, w3 = rand(2, 3, 8, 16, seed=11), rand(4, 3, 3, 3, seed=12, scale=0.3)
    plan = ops.make_resample(window=(1, 3, 3, 1), ring=True)
    grads = []
    for f in (lambda x, w: ops.blur_conv3x3s2_ring(x, w), lambda x, w: ops.conv_ring_fast(ops.resample(x, plan), w, (2, 2))):
        xt, wt = t(x).requires_grad_(), t(w3).requires_grad_()
        f(xt, wt).square().sum().backward()
        grads.append((xt.grad, wt.grad))
    close(grads[0][0], grads[1][0].numpy(), 1e-4)
    close(grads[0][1], grads[1][1].numpy(), 1e-4)


def test_blur_conv_fusable_matches_jax():
    for shape in [(1, 1, 8, 16), (1, 1, 4, 16), (1, 1, 8, 6), (1, 1, 7, 16)]:
        for args in [(3, 2, 1, True, "replicate"), (1, 2, 0, True, "replicate"), (3, 1, 1, True, "replicate"),
                     (3, 2, 1, False, "replicate"), (3, 2, 1, True, "reflect")]:
            assert ops.blur_conv_fusable(shape, *args) == jblurconv.blur_conv_fusable(shape, *args)
    with pytest.raises(ValueError):
        ops.blur_conv3x3s2_ring(torch.zeros(1, 1, 4, 16), torch.zeros(1, 1, 3, 3))


@pytest.mark.parametrize("metric", GAN_OBJECTIVES)
def test_gan_losses_match_jax(metric):
    yr, yf = rand(6, 1, seed=13, scale=2.0), rand(6, 1, seed=14, scale=2.0)
    close(gan_loss_d(t(yr), t(yf), metric), jloss.gan_loss_d(jnp.asarray(yr), jnp.asarray(yf), metric), 1e-6)
    close(gan_loss_g(t(yr), t(yf), metric), jloss.gan_loss_g(jnp.asarray(yr), jnp.asarray(yf), metric), 1e-6)


def test_gan_loss_names():
    assert GAN_OBJECTIVES == jloss.GAN_OBJECTIVES
    with pytest.raises(NotImplementedError):
        gan_loss_d(torch.zeros(2, 1), torch.zeros(2, 1), "other")
    with pytest.raises(NotImplementedError):
        gan_loss_g(None, torch.zeros(2, 1), "other")


# --------------------------------------------------------------------------- the model

def _seeded_params(jD, seed):
    v = jD.init(jax.random.PRNGKey(0), jnp.zeros((B, 1, *RES)))
    rng = np.random.RandomState(seed)

    def draw(path, a):
        scale = 1.0 if path[-1].key == "weight" else 0.3  # N(0, 1) weights, non-zero biases
        return (rng.randn(*a.shape) * scale).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(draw, v["params"])}


@pytest.fixture(scope="module")
def models():
    jD = j_build_discriminator(D_CFG)
    v = _seeded_params(jD, seed=0)
    tD = load_jax_variables(build_discriminator(D_CFG, device="cpu"), v)
    return jD, v, tD


def _images(seed):
    return np.tanh(rand(B, 1, *RES, seed=seed))


def test_state_dict_keys_are_the_flax_paths(models):
    _, v, tD = models
    flat = flatten_variables(v)
    assert set(tD.state_dict()) == set(flat)
    assert "res0.conv2.conv.weight" in flat and "res1.bias_act1.bias" in flat and "fc2.bias" in flat
    for key, value in tD.state_dict().items():
        assert tuple(value.shape) == flat[key].shape, key


@pytest.mark.parametrize("blur_fuse", [False, True])
def test_logits_match_jax(models, blur_fuse):
    jD, v, tD = models
    x = _images(1)
    ref = jax.jit(lambda v, x: jD.apply(v, x, blur_fuse=blur_fuse))(v, jnp.asarray(x))
    got = tD(t(x), blur_fuse=blur_fuse)
    assert tuple(got.shape) == (B, 1) and float(np.abs(np.asarray(ref)).max()) > 1e-2
    close(got, ref, 1e-4)


def test_small_batch_and_unfusable_resolution(models):
    """B=2 < mbdis_group; and an 8-high input whose last block (4 rows) does not compose,
    so blur_fuse=True falls back to the chain route there, as the JAX block does."""
    jD, v, tD = models
    x = _images(2)[:2]
    close(tD(t(x)), jD.apply(v, jnp.asarray(x)), 1e-4)
    cfg = {"arch": "dusty_v2", "layer_kwargs": {**D_CFG["layer_kwargs"], "resolution": (8, 32)}}
    jD8 = j_build_discriminator(cfg)
    x8 = np.tanh(rand(B, 1, 8, 32, seed=3))
    v8 = jD8.init(jax.random.PRNGKey(1), jnp.asarray(x8))
    tD8 = load_jax_variables(build_discriminator(cfg, device="cpu"), v8)
    close(tD8(t(x8), blur_fuse=True), jD8.apply(v8, jnp.asarray(x8), blur_fuse=True), 1e-4)


def test_bf16_policy_close_to_fp32_and_to_jax(models):
    """compute_dtype="bfloat16": trunk in bfloat16, epilogue float32. The port rounds a
    bias-act once where JAX rounds after each of its three ops, so the two bf16 models
    agree to bf16 precision only: both within 5% relative L2 of the float32 logits."""
    jD, v, tD = models
    x = _images(4)
    cfg = {**D_CFG, "compute_dtype": "bfloat16"}
    tD16 = build_discriminator(cfg, device="cpu")
    tD16.load_state_dict(tD.state_dict())
    assert tD16.layer_dtype(0) == torch.bfloat16 and tD.layer_dtype(0) == torch.float32
    ref32 = np.asarray(jD.apply(v, jnp.asarray(x), blur_fuse=False))
    ref16 = np.asarray(j_build_discriminator(cfg).apply(v, jnp.asarray(x), blur_fuse=False))
    for fuse in (False, True):
        got = tD16(t(x), blur_fuse=fuse)
        assert got.dtype == torch.float32
        for ref in (ref32, ref16):
            assert np.linalg.norm(got.detach().numpy() - ref) <= 0.05 * np.linalg.norm(ref32)
    cfg2 = {**D_CFG, "compute_dtype": "bfloat16", "layer_kwargs": {**D_CFG["layer_kwargs"], "num_fp16_layers": 2}}
    D2 = build_discriminator(cfg2, device="cpu")
    assert [D2.layer_dtype(i) for i in range(4)] == [torch.bfloat16, torch.bfloat16, torch.float32, torch.float32]


def test_build_discriminator_rules(monkeypatch):
    with pytest.raises(NotImplementedError):  # vanilla builds (tests/test_torch_other_archs.py)
        build_discriminator({"arch": "stylegan2", "layer_kwargs": {}}, device="cpu")
    # remat builds (its blocks under torch.utils.checkpoint: tests/test_torch_options.py)
    assert build_discriminator({**D_CFG, "layer_kwargs": {**D_CFG["layer_kwargs"], "remat": True}}, device="cpu").remat
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        build_discriminator(D_CFG)
    a, b = build_discriminator(D_CFG, device="cpu", seed=3), build_discriminator(D_CFG, device="cpu", seed=3)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    full = full_disc_cfg()["layer_kwargs"]
    assert (full["ch_base"], full["ch_max"], full["resolution"], full["mbdis_group"]) == (32, 512, (64, 512), 4)


# --------------------------------------------------------------------------- loss phases

def _param_grads(tD):
    return {k: p.grad for k, p in tD.named_parameters()}


def _check_param_grads(tD, ref_tree, tol=1e-4):
    ref = flatten_variables({"params": ref_tree})
    scale = max(float(np.abs(a).max()) for a in ref.values())
    assert scale > 0
    for key, grad in _param_grads(tD).items():
        got = np.zeros_like(ref[key]) if grad is None else grad.numpy()
        assert np.abs(got - ref[key]).max() <= tol * scale, key


@pytest.mark.parametrize("metric", ["nsgan", "hinge", "ragan"])
def test_g_phase_loss_and_input_gradient_match_jax(models, metric):
    jD, v, tD = models
    x_fake, x_real = _images(5), _images(6)
    use_real = metric.startswith("ra")

    def loss(xf):
        y_fake = jD.apply(v, xf, train=True, blur_fuse=False)
        y_real = jD.apply(v, jnp.asarray(x_real), train=True, blur_fuse=False) if use_real else None
        return jloss.gan_loss_g(y_real, y_fake, metric)

    ref, gref = jax.jit(jax.value_and_grad(loss))(jnp.asarray(x_fake))
    xf = t(x_fake).requires_grad_()
    got = g_phase_loss(tD, xf, metric, t(x_real) if use_real else None)
    (gx,) = torch.autograd.grad(got, xf)
    close(got, ref, 1e-4)
    close_rel_max(gx, gref)


@pytest.mark.parametrize("metric", ["nsgan", "lsgan", "rahinge"])
def test_d_phase_loss_and_parameter_gradients_match_jax(models, metric):
    jD, v, tD = models
    x_real, x_fake = _images(7), _images(8)

    def loss(params):
        y_real = jD.apply({"params": params}, jnp.asarray(x_real), train=True, blur_fuse=False)
        y_fake = jD.apply({"params": params}, jnp.asarray(x_fake), train=True, blur_fuse=False)
        return jloss.gan_loss_d(y_real, y_fake, metric)

    ref, gref = jax.jit(jax.value_and_grad(loss))(v["params"])
    tD.zero_grad(set_to_none=True)
    got = d_phase_loss(tD, t(x_real), t(x_fake), metric)
    got.backward()
    close(got, ref, 1e-4)
    _check_param_grads(tD, gref)


def test_r1_penalty_and_parameter_gradients_match_jax(models):
    jD, v, tD = models
    x_real = _images(9)

    def penalty(params):
        g = jax.grad(lambda x: jnp.sum(jD.apply({"params": params}, x, train=True, blur_fuse=False)))(
            jnp.asarray(x_real)
        )
        return jnp.mean(jnp.sum(jnp.square(g), axis=(1, 2, 3)))

    ref, gref = jax.jit(jax.value_and_grad(penalty))(v["params"])
    tD.zero_grad(set_to_none=True)
    got = r1_penalty(tD, t(x_real))
    got.backward()
    assert float(ref) > 0
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-4)
    _check_param_grads(tD, gref)


def test_phases_do_not_touch_their_inputs(models):
    _, _, tD = models
    x_real, x_fake = t(_images(10)).requires_grad_(), t(_images(11)).requires_grad_()
    tD.zero_grad(set_to_none=True)
    (d_phase_loss(tD, x_real, x_fake) + r1_penalty(tD, x_real)).backward()
    assert x_real.grad is None and x_fake.grad is None
