"""Path-length regularization in the port's training step, and gradient accumulation,
against the JAX package on the CPU.

The harness is tests/test_torch_trainer.py's: the JAX Trainer (tiny config with
loss.pl = 2, lazy pl 2) takes two steps from its own init (iteration 0 runs PL, R1 and
ADA), ADA's p is set to 0.5, and that state is carried into the port; each PL variant
then runs on both sides on the JAX step's draws, recorded while it is traced and replayed
by the port. Bars, as for the other variants: losses (the PL penalty among them),
pl_ema, buffers and the ADA state 1e-4; each parameter's update and Adam's moments
within 1e-3 of their largest (G takes two Adam steps on a PL iteration, so its update is
held against JAX's, not against one Adam step on its final moments).

microbatch_value_and_grad is held against the JAX microbatch_value_and_grad on a tiny
D's nsgan loss: the loss 1e-5 relative, the gradients 1e-4 of their largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dusty_gan_v2_tpu.models import build_discriminator as j_build_discriminator
from dusty_gan_v2_tpu.training.accumulation import microbatch_value_and_grad as j_microbatch
from dusty_gan_v2_tpu_torch.convert import flatten_variables, load_jax_variables
from dusty_gan_v2_tpu_torch.models import build_discriminator
from dusty_gan_v2_tpu_torch.parallel import ReplayStream
from dusty_gan_v2_tpu_torch.training import microbatch_value_and_grad

from test_torch_trainer import JaxSide, _flat, _jflat, _moments_err, _named, _np_batch, _port, _pre_state, _update_err
from test_trainer import RES, tiny_cfg

# iteration -> (do_pl, do_r1, do_ada, skip_warmup) under the PL config (lazy pl 2, gp 4, ada 2)
PL_VARIANTS = {2: (True, False, True, False), 4: (True, True, True, False)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pl_cfg():
    cfg = tiny_cfg()
    cfg.training.loss.pl = 2
    return cfg


@pytest.fixture(scope="module")
def jax_side():
    mp = pytest.MonkeyPatch()
    side = JaxSide(_pl_cfg(), RES, mp)
    side.pre = _pre_state(side)
    yield side
    mp.undo()


@pytest.mark.parametrize("it", sorted(PL_VARIANTS), ids=lambda it: "pl-r1{}-ada{}-warmup".format(
    *[int(v) for v in PL_VARIANTS[it][1:3]]))
def test_pl_step_matches_jax(jax_side, it):
    jnew, jm, draws = jax_side.step(jax_side.pre, it)
    tr, st = _port(_pl_cfg(), RES, jax_side.pre)
    sched = tr.schedule(it)
    assert (sched.do_pl, sched.do_r1, sched.do_ada, sched.skip_warmup) == PL_VARIANTS[it]
    old = _flat(st)
    seen = {}
    rs = ReplayStream(draws)
    m = tr.step(st, _np_batch(jax_side.batch), it, draws=rs,
                on_phase=lambda name, s, values: seen.setdefault(name, sorted(values)))
    assert rs.remaining == 0, "the port drew less than the JAX step"
    assert seen["pl"] == ["penalty", "pl_ema"] and list(seen)[:2] == ["g", "pl"]
    assert set(m) == set(jm) and "loss/G/path_length" in m
    for k, v in jm.items():  # the adversarial losses, the PL penalty and baseline, D outputs, ADA
        assert abs(float(m[k]) - v) <= 1e-4 * max(1.0, abs(v)), (k, float(m[k]), v)
    assert abs(float(st.pl_ema) - float(jnew.pl_ema)) <= 1e-4 * max(1.0, abs(float(jnew.pl_ema)))
    assert float(jnew.pl_ema) > float(jax_side.pre.pl_ema)
    ref, got = _jflat(jnew), _flat(st)
    for k in ref:
        if k.endswith(("w_avg", "ema_var")):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    for a, b in ((st.ada.p, jnew.ada.p), (st.ada.sign_cum, jnew.ada.sign_cum), (st.ada.n_pred_cum, jnew.ada.n_pred_cum)):
        assert abs(float(a) - float(b)) <= 1e-4
    jj = jax.tree_util.tree_map(np.asarray, jnew)
    err = {
        "G_updates": _update_err(got, ref, old, [k for k, _ in _named("G", st.G)]),
        "D_updates": _update_err(got, ref, old, [k for k, _ in _named("D", st.D)]),
        # _moments_err also requires equal step counts: G's Adam stepped twice
        "G_moments": _moments_err(st.opt_G, st.G, jj.opt_G),
        "D_moments": _moments_err(st.opt_D, st.D, jj.opt_D),
    }
    print(f"iteration {it}: " + ", ".join(f"{k} {v:.3g}" for k, v in err.items()))
    assert max(err.values()) <= 1e-3, err
    assert float(st.opt_G.state[next(st.G.parameters())]["step"]) == float(jj.opt_G[0].count) == 5.0
    d32 = np.float32(tr.schedule(it).ema_decay)
    for k, _ in _named("G", st.G):
        e = f"G_ema.{k[2:]}"
        want = old[e] * d32 + got[k] * (np.float32(1) - d32)
        assert np.all(np.abs(got[e] - want) <= 2 * np.spacing(np.abs(want))), e


def test_pl_reaches_only_the_synthesis(jax_side):
    """PL differentiates through the styles: the mapping network's gradients are the
    zeros jax.grad gives (Adam still counts the step), the synthesis network's are not."""
    it = 2
    _, _, draws = jax_side.step(jax_side.pre, it)
    tr, st = _port(_pl_cfg(), RES, jax_side.pre)
    grads = {}

    def hook(name, s, values):
        if name == "pl":
            grads.update({k: p.grad.clone() for k, p in s.G.named_parameters()})

    tr.step(st, _np_batch(jax_side.batch), it, draws=ReplayStream(draws), on_phase=hook)
    assert grads and all(not g.any() for k, g in grads.items() if k.startswith("mapping_network."))
    assert any(g.abs().max() > 0 for k, g in grads.items() if k.startswith("synthesis_network."))


@pytest.mark.parametrize("n", [1, 2])
def test_microbatch_value_and_grad_matches_jax(n):
    cfg = tiny_cfg()
    x = np.tanh(np.random.RandomState(8).randn(8, 1, *RES)).astype(np.float32)
    jD = j_build_discriminator(cfg.model.discriminator)
    params = jax.jit(jD.init)(jax.random.PRNGKey(2), jnp.asarray(x))["params"]

    def j_loss(p, batch):
        return jnp.mean(jax.nn.softplus(-jD.apply({"params": p}, batch["x"], blur_fuse=False)))

    j_value, j_grads = jax.jit(lambda p, b: j_microbatch(j_loss, p, b, n))(params, {"x": jnp.asarray(x)})
    D = load_jax_variables(build_discriminator(cfg.model.discriminator, device="cpu"),
                           {"params": jax.tree_util.tree_map(np.asarray, params)})
    names, prms = zip(*D.named_parameters())
    value, grads = microbatch_value_and_grad(
        lambda batch: F.softplus(-D(batch["x"], blur_fuse=False)).mean(), prms, {"x": torch.from_numpy(x)}, n)
    assert abs(float(value) - float(j_value)) <= 1e-5 * abs(float(j_value))
    ref = flatten_variables({"params": jax.tree_util.tree_map(np.asarray, j_grads)})
    scale = max(float(np.abs(r).max()) for r in ref.values())
    err = max(float(np.abs(g.numpy() - ref[k]).max()) for k, g in zip(names, grads)) / scale
    assert err <= 1e-4, err
    with pytest.raises(ValueError):
        microbatch_value_and_grad(lambda b: b.sum(), prms, torch.zeros(6, 1), 4)
