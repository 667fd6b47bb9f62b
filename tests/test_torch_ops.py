"""PyTorch port ops against their JAX counterparts on the CPU, at fp32.

Inputs and weights come from a numpy seed and go through both the JAX function and
the port's; each op must agree within 1e-5 (float32 reassociation between XLA and
PyTorch CPU kernels)."""

import ast
import importlib
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu import ops as jops
from dusty_gan_v2_tpu.geometry import coords as jcoords
from dusty_gan_v2_tpu.ops import pad as jpad
from dusty_gan_v2_tpu_torch import ops
from dusty_gan_v2_tpu_torch.geometry import CoordBridge, bilinear_resize, resize_angle_lut
from dusty_gan_v2_tpu_torch.models.heads import resolve_act
from dusty_gan_v2_tpu_torch.utils import resolve_device, tanh_to_sigmoid

# the packages export a function named like the module, so fetch the modules
jresample = importlib.import_module("dusty_gan_v2_tpu.ops.resample")
tresample = importlib.import_module("dusty_gan_v2_tpu_torch.ops.resample")

TOL = 1e-5
PORT_DIR = Path(__file__).resolve().parent.parent / "dusty_gan_v2_tpu_torch"


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


def randomize(tree, seed, scale=0.5):
    """Replace every leaf of a flax variable tree with seeded numpy values."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(rng.randn(*np.shape(a)) * scale, np.float32), tree
    )


# --------------------------------------------------------------------------- pad / resample

@pytest.mark.parametrize("mode", ["circular", "replicate"])
@pytest.mark.parametrize("axis,lo,hi", [(-1, 2, 1), (-2, 1, 3), (-1, 0, 2), (-2, 0, 0)])
def test_pad_axis_matches_jax(mode, axis, lo, hi):
    x = rand(2, 3, 5, 6)
    ref = jpad._pad_axis(jnp.asarray(x), axis, lo, hi, mode)
    close(ops.pad_axis(t(x), axis, lo, hi, mode), ref, 0)


PLANS = [
    dict(up=2, ring=True),  # synthesis upsampling
    dict(down=2, ring=True),  # angle pyramid
    dict(up=2, ring=False),
    dict(down=2, ring=False),
    dict(ring=True),  # blur only
    dict(ring=True, direction="h"),
    dict(ring=True, direction="w"),
]


@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_resample_matches_jax(kw):
    x = rand(2, 3, 8, 16, seed=1)
    jplan = jresample.make_resample(**kw)
    ref = jresample.resample(jnp.asarray(x), jplan, method="conv")
    got = ops.resample(t(x), ops.make_resample(**kw))
    assert tuple(got.shape) == ref.shape == (2, 3) + jplan.out_shape(8, 16)
    close(got, ref)
    Hj, Wj = jresample._resample_matrices(jplan, 8, 16)
    Ht, Wt = tresample._resample_matrices(ops.make_resample(**kw), 8, 16)
    close(Ht, Hj, 1e-6)
    close(Wt, Wj, 1e-6)


# --------------------------------------------------------------------------- fused bias-act

def test_fused_leaky_relu_matches_jax_plain_and_pallas():
    from jax.experimental.pallas import tpu as pltpu

    x, b = rand(2, 5, 4, 8, seed=2), rand(5, seed=3)
    ref = jops.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b))
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = jops.fused_leaky_relu_pallas(jnp.asarray(x), jnp.asarray(b))
    got = ops.fused_leaky_relu(t(x), t(b))
    close(got, ref, 1e-6)
    close(got, ref_pallas, 1e-6)
    close(ops.fused_bias_act(t(x), t(b)), ref, 1e-6)


def test_fused_bias_act_grad_matches_jax():
    from jax.experimental.pallas import tpu as pltpu

    x, b = rand(2, 3, 4, 8, seed=4), rand(3, seed=5)
    f = lambda x, b: jnp.sum(jops.fused_leaky_relu_pallas(x, b) ** 2)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        gx_ref, gb_ref = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
    xt, bt = t(x).requires_grad_(), t(b).requires_grad_()
    (ops.fused_bias_act(xt, bt) ** 2).sum().backward()
    close(xt.grad, gx_ref)
    close(bt.grad, gb_ref)


def test_fused_bias_act_double_backward_matches_jax():
    x, b = rand(2, 3, 4, 4, seed=6), rand(3, seed=7)
    f = lambda x: jnp.sum(jops.fused_leaky_relu(x, jnp.asarray(b)) ** 2)  # noqa: E731
    gg_ref = jax.grad(lambda x: jnp.sum(jax.grad(f)(x) ** 2))(jnp.asarray(x))
    xt = t(x).requires_grad_()
    (g,) = torch.autograd.grad((ops.fused_bias_act(xt, t(b)) ** 2).sum(), xt, create_graph=True)
    (gg,) = torch.autograd.grad((g**2).sum(), xt)
    close(gg, gg_ref)


def test_fused_leaky_relu_bf16_rounds_once():
    x, b = rand(2, 4, 4, 8, seed=8), rand(4, seed=9)
    xb = t(x).to(torch.bfloat16)
    got = ops.fused_leaky_relu(xb, t(b))
    assert got.dtype == torch.bfloat16
    ref = ops.fused_leaky_relu(xb.float(), t(b).to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(got, ref)


def test_kernel_wrappers_reject_cpu_tensors():
    from dusty_gan_v2_tpu_torch.metrics import fps_cuda

    with pytest.raises(ValueError):
        ops.fused_bias_act_cuda(torch.zeros(1, 2, 2, 2), torch.zeros(2))
    with pytest.raises(ValueError):
        fps_cuda(torch.zeros(1, 8, 3), 4)


# --------------------------------------------------------------------------- layers

@pytest.mark.parametrize("gain,lr_mul,use_bias", [(1.0, 1.0, True), (math.sqrt(2), 0.01, True), (1.0, 1.0, False)])
def test_equal_lr_dense_matches_jax(gain, lr_mul, use_bias):
    m = jops.EqualLRDense(in_features=6, features=5, gain=gain, lr_mul=lr_mul, use_bias=use_bias)
    x = rand(3, 6, seed=10)
    v = randomize(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), 11)
    ref = m.apply(v, jnp.asarray(x))
    p = ops.EqualLRDense(6, 5, use_bias=use_bias, gain=gain, lr_mul=lr_mul)
    p.load_state_dict({k: t(a) for k, a in v["params"].items()})
    close(p(t(x)), ref)


def test_pixel_norm_matches_jax():
    x = rand(4, 7, seed=12)
    close(ops.pixel_norm(t(x)), jops.pixel_norm(jnp.asarray(x)))


def _modconv_pair(in_ch, out_ch, mod_ch, demod, use_bias, ema, seed, **apply_kw):
    m = jops.ModConv2d(in_ch=in_ch, out_ch=out_ch, mod_ch=mod_ch, ksize=1, stride=1,
                       padding=0, demod=demod, use_bias=use_bias, ema=ema)
    v = m.init(jax.random.PRNGKey(0), **apply_kw)
    v = randomize(v, seed)
    if ema:  # a positive running variance
        v["stats"]["ema_var"] = np.float32(np.random.RandomState(seed).uniform(0.5, 2.0))
    p = ops.ModConv2d(in_ch, out_ch, mod_ch, demod=demod, use_bias=use_bias, ema=ema)
    sd = {"weight": v["params"]["weight"], "mod.weight": v["params"]["mod"]["weight"],
          "mod.bias": v["params"]["mod"]["bias"]}
    if use_bias:
        sd["bias"] = v["params"]["bias"]
    if ema:
        sd["ema_var"] = v["stats"]["ema_var"]
    p.load_state_dict({k: t(a) for k, a in sd.items()})
    return m, v, p


@pytest.mark.parametrize("demod,use_bias,ema", [(True, False, True), (False, True, True), (True, True, False)])
def test_modconv_plain_path_matches_jax(demod, use_bias, ema):
    x, s = rand(2, 6, 4, 8, seed=13), rand(2, 5, seed=14)
    m, v, p = _modconv_pair(6, 3, 5, demod, use_bias, ema, 15, x=jnp.asarray(x), style=jnp.asarray(s))
    close(p(t(x), t(s)), m.apply(v, jnp.asarray(x), jnp.asarray(s)))
    wb_ref, b_ref = m.apply(v, jnp.asarray(x), jnp.asarray(s), return_weights=True)
    wb, b = p.weights(t(s), torch.float32)
    close(wb, wb_ref)
    if use_bias:
        close(b, b_ref)


def test_modconv_shared_input_without_x_matches_jax():
    xs, s = rand(1, 6, 4, 8, seed=16), rand(3, 5, seed=17)
    m, v, p = _modconv_pair(6, 4, 5, True, False, True, 18, x=None, style=jnp.asarray(s),
                            x_shared=jnp.asarray(xs))
    ref = m.apply(v, None, jnp.asarray(s), x_shared=jnp.asarray(xs))
    close(p(None, t(s), x_shared=t(xs)), ref)


def test_modconv_shared_input_with_low_res_x_op_matches_jax():
    x, xs, s = rand(2, 3, 4, 8, seed=19), rand(1, 6, 8, 16, seed=20), rand(2, 5, seed=21)
    jplan, tplan = jresample.make_resample(up=2), ops.make_resample(up=2)
    m, v, p = _modconv_pair(9, 4, 5, True, False, True, 22, x=jnp.asarray(x), style=jnp.asarray(s),
                            x_shared=jnp.asarray(xs), x_op=lambda y: jresample.resample(y, jplan, "conv"))
    ref = m.apply(v, jnp.asarray(x), jnp.asarray(s), x_shared=jnp.asarray(xs),
                  x_op=lambda y: jresample.resample(y, jplan, "conv"))
    got = p(t(x), t(s), x_shared=t(xs), x_op=lambda y: ops.resample(y, tplan))
    close(got, ref)


def test_fourier_feature_matches_jax():
    angle = rand(1, 2, 8, 64, seed=23, scale=1.5)
    m = jops.FourierFeature(resolution=(8, 64), basis_scale="random", num_freqs=32)
    v = m.init(jax.random.PRNGKey(3), jnp.asarray(angle))
    p = ops.FourierFeature((8, 64), "random", 32)
    p.load_state_dict({k: t(a) for k, a in v["consts"].items()})
    close(p(t(angle)), m.apply(v, jnp.asarray(angle)))
    assert p.out_ch == jops.fourier_out_ch(32, "random", (8, 64))


def test_fourier_feature_fresh_bank_on_lattice():
    p = ops.FourierFeature((8, 64), "random", 64)
    p.reset_parameters(torch.Generator().manual_seed(0))
    band_h = 2.0 ** (p.L_h - 1)
    assert p.freqs[:, 0].abs().max() <= band_h
    fw = p.freqs[:, 1].abs()
    assert torch.all((fw == 0) | (torch.log2(fw.clamp(min=1)) % 1 == 0))
    assert fw.max() <= 2.0 ** (p.L_w - 1)
    assert p.phase.min() >= 0 and p.phase.max() < 2 * math.pi


def test_gumbel_sigmoid_matches_jax():
    logits, noise = rand(2, 1, 4, 8, seed=24), rand(2, 1, 4, 8, seed=25)
    ref = jops.gumbel_sigmoid(jnp.asarray(logits), logistic_noise=jnp.asarray(noise), temperature=0.7)
    close(ops.gumbel_sigmoid(t(logits), t(noise), temperature=0.7), ref)
    soft = ops.gumbel_sigmoid(t(logits), t(noise), straight_through=False)
    close(soft, jops.gumbel_sigmoid(jnp.asarray(logits), logistic_noise=jnp.asarray(noise),
                                    straight_through=False))


def test_sample_logistic_is_seeded_and_logistic():
    a = ops.sample_logistic(torch.Generator().manual_seed(1), (20000,))
    b = ops.sample_logistic(torch.Generator().manual_seed(1), (20000,))
    assert torch.equal(a, b)
    assert abs(float(a.mean())) < 0.1
    assert abs(float(a.var()) - math.pi**2 / 3) < 0.2  # Logistic(0,1) variance


@pytest.mark.parametrize("name", [None, "tanh", "nn.Tanh", "sigmoid", "identity"])
def test_resolve_act_matches_jax(name):
    from dusty_gan_v2_tpu.models.heads import resolve_act as jresolve

    x = rand(3, 4, seed=26)
    close(resolve_act(name)(t(x)), jresolve(name)(jnp.asarray(x)), 1e-6)


# --------------------------------------------------------------------------- geometry

def test_bilinear_resize_and_angle_lut_match_jax():
    x = rand(1, 2, 6, 10, seed=27)
    close(bilinear_resize(t(x), (9, 23)), jcoords.bilinear_resize(jnp.asarray(x), (9, 23)))
    lut = np.load(Path(__file__).resolve().parent.parent / "data" / "coords" / "kitti_raw.npy")
    close(resize_angle_lut(lut, (8, 64), device="cpu"), jcoords.resize_angle_lut(lut, (8, 64)))


ROUTES = [
    ("inv_depth_norm", "point_set"),
    ("inv_depth_norm", "point_map"),
    ("inv_depth_norm", "depth"),
    ("depth", "inv_depth_norm"),
    ("depth_norm", "point_set"),
    ("inv_depth", "depth_norm"),
]


@pytest.mark.parametrize("src,tgt", ROUTES)
def test_coord_bridge_matches_jax(src, tgt):
    H, W = 8, 64
    lut = np.load(Path(__file__).resolve().parent.parent / "data" / "coords" / "kitti_raw.npy")
    rng = np.random.RandomState(28)
    x = {
        "inv_depth_norm": rng.uniform(-0.05, 1.0, (2, 1, H, W)),
        "depth": rng.uniform(0.0, 90.0, (2, 1, H, W)),
        "depth_norm": rng.uniform(0.0, 1.0, (2, 1, H, W)),
        "inv_depth": rng.uniform(0.0, 0.8, (2, 1, H, W)),
    }[src].astype(np.float32)
    jb = jcoords.CoordBridge(H, W, 1.45, 80.0, angle=lut)
    tb = CoordBridge(H, W, 1.45, 80.0, angle=lut, device="cpu")
    close(tb.convert(t(x), src, tgt), jb.convert(jnp.asarray(x), src, tgt))


def test_tanh_to_sigmoid():
    x = rand(5, seed=29)
    close(tanh_to_sigmoid(t(x)), (x + 1.0) / 2.0, 0)


# --------------------------------------------------------------------------- package rules

def test_port_imports_no_jax():
    """No module of the port imports jax, flax or the JAX package."""
    banned = ("jax", "flax", "dusty_gan_v2_tpu")
    offenders = []
    for path in PORT_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names if n.split(".")[0] in banned]
    assert offenders == []
    assert any(PORT_DIR.rglob("*.py"))


def test_default_device_raises_without_cuda(monkeypatch):
    from dusty_gan_v2_tpu_torch.models import build_generator
    from dusty_gan_v2_tpu_torch.sampling import full_gen_cfg, load_angle

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        build_generator(full_gen_cfg())
    with pytest.raises(RuntimeError):
        load_angle()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
