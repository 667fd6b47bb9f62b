"""The port's inversion toolkit and the steps of its two inversion stages against the JAX
package on the CPU.

Every function of inversion/ against the JAX one (both distances, relative on and off,
pyramid levels 1, 2 and None, noise renormalization of a dict, the schedule at every step
of a short run), then the loss of demo_inversion.py's forward on a small DUSty v2
generator (ch_base 4, ch_max 16, 8 x 64, layers (2, 2); weights from a numpy seed,
carried over by load_jax_variables) against jax.value_and_grad of the same forward,
written here from the JAX package's functions as the JAX demo writes it: loss within
1e-5 (relative), gradients within 1e-4 of their largest magnitude. The port's Adam steps
are held to optax's adam, fed the port's own gradients, within 1e-6. The phase gradient,
which runs through the angle pyramid's atan2 and each block's Fourier encoding, is held
to central finite differences in float64.
"""

import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_generator import RES, SMALL_CFG, _seeded_variables  # noqa: E402

from dusty_gan_v2_tpu import inversion as jinv  # noqa: E402
from dusty_gan_v2_tpu.geometry import CoordBridge as JCoordBridge  # noqa: E402
from dusty_gan_v2_tpu.geometry import resize_angle_lut as j_resize_angle_lut  # noqa: E402
from dusty_gan_v2_tpu.models import build_generator as j_build_generator  # noqa: E402
from dusty_gan_v2_tpu.models.dusty_v2 import MappingNetwork as JMappingNetwork  # noqa: E402
from dusty_gan_v2_tpu.utils import tanh_to_sigmoid as j_tanh_to_sigmoid  # noqa: E402
from dusty_gan_v2_tpu_torch import inversion as tinv  # noqa: E402
from dusty_gan_v2_tpu_torch.cli.demo_inversion import Inversion, LatentStage, TuningStage  # noqa: E402
from dusty_gan_v2_tpu_torch.convert import flatten_variables, load_jax_variables  # noqa: E402
from dusty_gan_v2_tpu_torch.geometry import CoordBridge  # noqa: E402
from dusty_gan_v2_tpu_torch.models import build_generator  # noqa: E402

LUT = Path(__file__).resolve().parent.parent / "data" / "coords" / "kitti_raw.npy"
NUM_STYLES = 6  # 2 * (len(layers) + 1)
Z = 16
LOSS_TOL, GRAD_TOL, ADAM_TOL = 1e-5, 1e-4, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------- functions


def _images(seed, shape=(2, 1, 16, 32)):
    rng = np.random.RandomState(seed)
    ref = rng.uniform(0.05, 1.0, shape).astype(np.float32)
    gen = (ref + 0.1 * rng.randn(*shape)).astype(np.float32)
    mask = (rng.rand(*shape) > 0.25).astype(np.float32)
    mask[1, :, :4] = 0.0  # a band with no valid pixel: the pyramid's count of 0
    return ref, gen, mask


@pytest.mark.parametrize("distance", ["l1", "l2"])
@pytest.mark.parametrize("relative", [True, False])
def test_masked_loss_matches_jax(distance, relative):
    ref, gen, mask = _images(0)
    got = tinv.masked_loss(_t(ref), _t(gen), _t(mask), distance, relative)
    want = jinv.masked_loss(jnp.asarray(ref), jnp.asarray(gen), jnp.asarray(mask), distance, relative)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    with pytest.raises(NotImplementedError):
        tinv.masked_loss(_t(ref), _t(gen), _t(mask), "huber")


@pytest.mark.parametrize("level", [1, 2, None])
@pytest.mark.parametrize("distance", ["l1", "l2"])
@pytest.mark.parametrize("relative", [True, False])
def test_multiscale_masked_loss_matches_jax(level, distance, relative):
    ref, gen, mask = _images(1)
    got = tinv.multiscale_masked_loss(_t(gen), _t(ref), _t(mask), level, distance, relative)
    want = jinv.multiscale_masked_loss(jnp.asarray(gen), jnp.asarray(ref), jnp.asarray(mask), level, distance, relative)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=0)


def test_blurpool_and_mask_update_match_jax():
    ref, _, mask = _images(2, (2, 3, 8, 16))
    np.testing.assert_allclose(tinv._blurpool(_t(ref)).numpy(), np.asarray(jinv._blurpool(jnp.asarray(ref))),
                               rtol=0, atol=1e-6)
    (norm, new_mask), (j_norm, j_mask) = tinv._update_mask(_t(mask[:, :1])), jinv._update_mask(jnp.asarray(mask[:, :1]))
    np.testing.assert_allclose(norm.numpy(), np.asarray(j_norm), rtol=1e-6, atol=0)  # 9 / count, rounded once
    np.testing.assert_array_equal(new_mask.numpy(), np.asarray(j_mask))


@pytest.mark.parametrize("shape", [(1, 6, 16), (3, 4, 8)])
def test_geocross_loss_matches_jax(shape):
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    x[0, 1] = x[0, 0]  # two equal styles: the sqrt's 1e-9 floor
    np.testing.assert_allclose(tinv.geocross_loss(_t(x)).numpy(), np.asarray(jinv.geocross_loss(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-7)


def test_spherical_project_matches_jax():
    x = np.random.RandomState(4).randn(2, 6, 16).astype(np.float32) * 3
    got = tinv.spherical_project(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jinv.spherical_project(jnp.asarray(x))), rtol=1e-6, atol=0)
    np.testing.assert_allclose((got**2).mean(dim=-1).numpy(), 1.0, rtol=1e-5)


def test_normalize_noise_matches_jax():
    rng = np.random.RandomState(5)
    noises = {"n0": rng.randn(1, 1, 4, 8).astype(np.float32) * 2 + 1, "n1": rng.randn(1, 1, 8, 16).astype(np.float32)}
    got = tinv.normalize_noise({k: _t(v) for k, v in noises.items()})
    want = jinv.normalize_noise({k: jnp.asarray(v) for k, v in noises.items()})
    assert set(got) == set(noises)
    for k in noises:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6)
    as_list = tinv.normalize_noise([_t(v) for v in noises.values()])
    assert isinstance(as_list, list) and torch.equal(as_list[0], got["n0"])


@pytest.mark.parametrize("num_steps", [7, 40])
def test_lr_schedule_matches_jax_at_every_step(num_steps):
    got, want = tinv.stylegan2_lr_schedule(num_steps), jinv.stylegan2_lr_schedule(num_steps)
    assert [got(i) for i in range(num_steps)] == [want(i) for i in range(num_steps)]
    assert got(0) == 0.0


# ---------------------------------------------------------------------------- the stages


@pytest.fixture(scope="module")
def setup():
    """The small generator in both packages, a target frame, the logistic noise."""
    angle = np.array(j_resize_angle_lut(np.load(LUT), RES))
    jG = j_build_generator(SMALL_CFG)
    v = _seeded_variables(jG, jnp.asarray(angle), seed=3)
    tG = load_jax_variables(build_generator(SMALL_CFG, device="cpu"), v).requires_grad_(False).eval()
    rng = np.random.RandomState(6)
    depth = rng.uniform(2.0, 60.0, (1, 1, *RES)).astype(np.float32)
    depth *= rng.rand(1, 1, *RES) > 0.15
    mask = (depth > 0).astype(np.float32)
    u = np.clip(rng.rand(1, 1, *RES).astype(np.float32), 1e-6, 1 - 1e-6)
    noise = np.log(u) - np.log1p(-u)
    jcoord = JCoordBridge(RES[0], RES[1], 1.45, 80.0, angle=angle)
    tcoord = CoordBridge(RES[0], RES[1], 1.45, 80.0, angle=angle, device="cpu")
    return {"angle": angle, "jG": jG, "v": v, "tG": tG, "depth": depth, "mask": mask, "noise": noise,
            "jcoord": jcoord, "tcoord": tcoord, "rng": rng}


def _latent(s, latent_type, seed):
    """A state away from the start: z from numpy; w and w+ the mapped z plus a spread."""
    rng = np.random.RandomState(seed)
    z = rng.randn(1, Z).astype(np.float32)
    if latent_type == "z":
        return z
    w = np.asarray(JMappingNetwork(**SMALL_CFG["mapping_kwargs"]).apply(
        {"params": s["v"]["params"]["mapping_network"]}, jnp.asarray(z)))
    if latent_type == "w":
        return w
    return (w[:, None] + 0.1 * rng.randn(1, NUM_STYLES, Z)).astype(np.float32)


def _j_loss_fn(s, latent_type):
    """demo_inversion.py's forward, from the JAX package's functions."""
    jcoord, jG = s["jcoord"], s["jG"]
    mapping = JMappingNetwork(**SMALL_CFG["mapping_kwargs"])
    t_mask = jnp.asarray(s["mask"])
    t_depth = jcoord.convert(jnp.asarray(s["depth"]), "depth", "depth_norm")
    t_inv = jcoord.convert(t_depth, "depth_norm", "inv_depth_norm") * t_mask
    angle, noise = jnp.asarray(s["angle"]), jnp.asarray(s["noise"])

    def forward(g_variables, latent, phase):
        if latent_type == "z":
            w = mapping.apply({"params": g_variables["params"]["mapping_network"]}, latent)
            w = jnp.tile(w[:, None], (1, NUM_STYLES, 1))
        elif latent_type == "w":
            w = jnp.tile(latent[:, None], (1, NUM_STYLES, 1))
        else:
            w = latent
        o = jG.apply(g_variables, w, angle + phase, input_w=True, gumbel_noise=noise)
        g_inv_orig = j_tanh_to_sigmoid(o["image_orig"])
        g_depth = jcoord.convert(g_inv_orig, "inv_depth_norm", "depth_norm")
        loss = jinv.multiscale_masked_loss(g_depth, t_depth, t_mask, level=2)
        loss = loss + jinv.multiscale_masked_loss(g_inv_orig, t_inv, t_mask, level=2)
        if latent_type == "w+":
            loss = loss + 5e-3 * jinv.geocross_loss(w)
        return jnp.sum(loss)

    return forward


def _inversion(s, latent_type, dtype=torch.float32):
    return Inversion(s["tcoord"], _t(s["angle"]).to(dtype), _t(s["depth"]).to(dtype), _t(s["mask"]).to(dtype),
                     _t(s["noise"]).to(dtype), latent_type, NUM_STYLES)


def _grad_err(got, want):
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    assert scale > 0
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()) for k in want) / scale


def _adam_reference(params, grads_seq, lr, scales):
    """optax.adam(lr) with each update scaled, over the given gradients; returns params."""
    opt = optax.adam(lr)
    state = opt.init(params)
    for g, scale in zip(grads_seq, scales):
        updates, state = opt.update(g, state)
        updates = jax.tree_util.tree_map(lambda u: u * np.float32(scale), updates)
        params = optax.apply_updates(params, updates)
    return params


@pytest.mark.parametrize("latent_type", ["z", "w", "w+"])
@pytest.mark.parametrize("optimize_phase,hypersphere_z", [(False, False), (True, True)])
def test_latent_step_matches_jax(setup, latent_type, optimize_phase, hypersphere_z):
    """Two stage-1 steps (the schedule's 0 at step 0, then step 1 of 10): each step's loss
    and gradients against jax.value_and_grad at the port's state, and the latent and
    phase after both against optax's adam on the port's gradients (+ the projection)."""
    s = setup
    latent0 = _latent(s, latent_type, seed=7)
    phase0 = np.array([0.01, -0.02], np.float32).reshape(1, 2, 1, 1)
    stage = LatentStage(_inversion(s, latent_type), s["tG"], _t(latent0), _t(phase0), num_steps=10, lr=5e-2,
                        optimize_phase=optimize_phase, hypersphere_z=hypersphere_z)
    j_vg = jax.jit(jax.value_and_grad(lambda p: _j_loss_fn(s, latent_type)(s["v"], p["latent"], p["phase"])))
    port_grads, scales = [], []
    for i in range(2):
        state = {"latent": jnp.asarray(stage.latent.detach().numpy()), "phase": jnp.asarray(stage.phase.detach().numpy())}
        loss_j, grads_j = j_vg(state)
        loss = stage.step(i)
        assert abs(float(loss) - float(loss_j)) <= LOSS_TOL * abs(float(loss_j)), (float(loss), float(loss_j))
        got = {"latent": stage.latent.grad.numpy(),
               "phase": stage.phase.grad.numpy() if optimize_phase else np.zeros_like(phase0)}
        want = {"latent": grads_j["latent"], "phase": grads_j["phase"] if optimize_phase else np.zeros_like(phase0)}
        assert _grad_err(got, want) <= GRAD_TOL
        if optimize_phase:
            assert float(np.abs(got["phase"]).max()) > 0
        port_grads.append({k: jnp.asarray(v) for k, v in got.items()})
        scales.append(stage.sched(i))
    # both steps through one optax state on the port's gradients (the moments advance at lr 0 too),
    # each followed by the projection
    opt = optax.adam(5e-2)
    st = opt.init({"latent": jnp.asarray(latent0), "phase": jnp.asarray(phase0)})
    p = {"latent": jnp.asarray(latent0), "phase": jnp.asarray(phase0)}
    for g, sc in zip(port_grads, scales):
        upd, st = opt.update(g, st)
        p = optax.apply_updates(p, jax.tree_util.tree_map(lambda u: u * np.float32(sc), upd))
        if hypersphere_z:
            p["latent"] = jinv.spherical_project(p["latent"])
    assert scales[0] == 0.0 and scales[1] > 0
    np.testing.assert_allclose(stage.latent.detach().numpy(), np.asarray(p["latent"]), rtol=0, atol=ADAM_TOL)
    np.testing.assert_allclose(stage.phase.detach().numpy(), np.asarray(p["phase"]), rtol=0, atol=ADAM_TOL)
    if not optimize_phase:
        assert torch.equal(stage.phase.detach(), _t(phase0))
    assert not any(q.grad is not None for q in s["tG"].parameters())  # G stays fixed in stage 1


@pytest.mark.parametrize("latent_type", ["z", "w"])
def test_tuning_step_matches_jax(setup, latent_type):
    """One stage-2 step: loss and every parameter's gradient against jax.value_and_grad
    over G's params; the update against optax's adam on the port's gradients (a
    parameter without a gradient is left as it is, as optax's zero update leaves it);
    buffers and the original G untouched."""
    s = setup
    latent = _latent(s, latent_type, seed=8)
    phase = np.array([0.02, 0.01], np.float32).reshape(1, 2, 1, 1)
    tG0 = copy.deepcopy(s["tG"])
    stage = TuningStage(_inversion(s, latent_type), s["tG"], _t(latent), _t(phase), lr=5e-4)
    before = {k: v.detach().clone() for k, v in stage.G.state_dict().items()}
    fwd = _j_loss_fn(s, latent_type)
    v = s["v"]
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: fwd({**v, "params": p}, jnp.asarray(latent), jnp.asarray(phase))))(v["params"])
    loss = stage.step()
    assert abs(float(loss) - float(loss_j)) <= LOSS_TOL * abs(float(loss_j))
    want = flatten_variables({"params": grads_j})
    names = dict(stage.G.named_parameters())
    assert set(want) == set(names)
    got = {k: (np.zeros_like(want[k]) if p.grad is None else p.grad.numpy()) for k, p in names.items()}
    mapping = [k for k in names if k.startswith("mapping_network.")]
    if latent_type == "w":  # the mapping network takes no part: no torch gradient, a zero JAX one
        assert all(names[k].grad is None and not np.any(want[k]) for k in mapping)
    else:
        assert all(names[k].grad is not None for k in mapping)
    assert _grad_err(got, want) <= GRAD_TOL
    ref = _adam_reference({k: jnp.asarray(before[k].numpy()) for k in names}, [{k: jnp.asarray(g) for k, g in got.items()}],
                          5e-4, [1.0])
    after = stage.G.state_dict()
    for k in names:
        np.testing.assert_allclose(after[k].numpy(), np.asarray(ref[k]), rtol=0, atol=ADAM_TOL, err_msg=k)
        if latent_type == "w" and k in mapping:
            assert torch.equal(after[k], before[k])
    for k, b in stage.G.named_buffers():
        assert torch.equal(b, before[k]), k
    for k, t in s["tG"].state_dict().items():  # the stage tunes a copy
        assert torch.equal(t, tG0.state_dict()[k]), k
    assert not any(p.requires_grad for p in s["tG"].parameters())


def test_phase_gradient_float64_finite_differences(setup):
    """d loss / d phase through the angle pyramid and the Fourier encodings, float64,
    against central differences (step 1e-6, bar 1e-6 of the gradient's magnitude)."""
    s = setup
    G = copy.deepcopy(s["tG"]).double()
    for block in G.synthesis_network.blocks():
        block.dtype = torch.float64  # the blocks' compute dtype (float32 in the config)
    inv = _inversion(s, "w+", torch.float64)
    latent = _t(_latent(s, "w+", seed=9)).double()
    phase = torch.tensor([0.013, -0.021], dtype=torch.float64).reshape(1, 2, 1, 1).requires_grad_(True)
    loss, _ = inv(G, latent, phase)
    assert loss.dtype == torch.float64
    (grad,) = torch.autograd.grad(loss, phase)
    eps = 1e-6
    fd = torch.zeros(2, dtype=torch.float64)
    with torch.no_grad():
        for i in range(2):
            d = torch.zeros_like(phase)
            d.view(-1)[i] = eps
            fd[i] = (inv(G, latent, phase + d)[0] - inv(G, latent, phase - d)[0]) / (2 * eps)
    assert float(grad.abs().max()) > 1e-3
    np.testing.assert_allclose(grad.reshape(-1).numpy(), fd.numpy(), rtol=0, atol=1e-6 * float(grad.abs().max()))
