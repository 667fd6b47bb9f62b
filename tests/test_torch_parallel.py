"""The port's data parallelism (dusty_gan_v2_tpu_torch/parallel/mesh.py) on the CPU, over gloo.

The rule: two processes, each on half of a global batch, take the step one process takes
on the whole batch. Two worker processes run this file itself with --worker (as
tests/test_parallel.py starts its worker), join a gloo group on a port taken from a bound
socket, run every check in one interpreter and write their results; the test process is
the one-process run (no group bound, every collective the identity) and compares.

- Collectives: axis_pmean, axis_psum and all_gather_rows, forward, backward and double
  backward, against the one-process computation on the concatenated data; the raw
  in-place reductions and the flat gradient average.
- Streams (in process, no group needed): rank k's rows of PerSampleStream and
  ReplayStream concatenate to the one-process draw, for the plain, reals ++ fakes and PL
  layouts.
- The models' cross-rank statistics: minibatch-stddev through R1's double backward (the
  D's parameter gradients), ModConv's ema_var and w_avg after a train-mode generator
  forward, ADA's accumulated sums.
- Trainer.step on tests/test_trainer.py's tiny config at a global batch of 16 (even
  B_local, as the JAX invariance test requires): every variant (warmup, ADA, D, lazy R1,
  PL, EMA) from the trainer's own generator, 2 processes against 1, at JAX's invariance
  bars (tests/test_trainer.py::TestDeviceCountInvariance: metrics rtol 2e-4 / atol 2e-5,
  parameters 1e-4 / 1e-5); and the variant with everything on (warmup, PL, R1, ADA), on
  draws replayed by global id, against JAX Trainer.step on a 2-device submesh, under
  tests/test_torch_trainer.py's step bar (1e-3 of the largest update, losses 1e-4).
- The semseg step in float64 (SqueezeSegV2 + CRF, focal loss, clip, SGD), its dropout
  masks from the rank-aware draws: 2 processes against 1 at the bars of JAX's own
  1-vs-8-device test (tests/test_semseg.py: loss rtol 1e-12, gradients and parameters
  1e-7, statistics 1e-9).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu_torch.parallel import PerSampleStream, ReplayStream, mesh

WORLD = 2
N_COLL = 4  # rows of the collectives' global input
RES = (8, 64)
B = 16  # the trainer's global batch
SEQ = (1, 2, 3, 4, 1000, 1001, 1002)  # iterations of the own-generator run: every variant
REPLAY = (4,)  # the variant replayed from JAX draws: warmup + PL + R1 + ADA (one JAX compile)
CHILD_TIMEOUT = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(argv, world=WORLD, timeout=CHILD_TIMEOUT, script=__file__):
    """Run `script --worker <rank> <world> <port> *argv` in `world` processes; fail on a
    child's non-zero exit or its timeout (every child is then killed)."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(Path(__file__).parent.parent), str(Path(__file__).parent),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, script, "--worker", str(r), str(world), str(port), *map(str, argv)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs


# ------------------------------------------------------------------ shared by both sides
def coll_inputs():
    rng = np.random.RandomState(1)
    return rng.randn(N_COLL, 3), rng.randn(N_COLL, 3)


def _rows(a, rank, world):
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


def collective_losses(x, w):
    """{name: (forward value, this rank's loss)} of three functions whose losses summed
    over the ranks are the one-process loss on the concatenated rows."""
    n = x.shape[0]
    out = {}
    s = mesh.axis_pmean((x ** 2).mean(0))
    out["pmean"] = (s, (torch.sin(x * s) * w).sum())
    s = mesh.axis_psum((x ** 3).sum(0))
    out["psum"] = (s, (torch.cos(x + 0.1 * s) * w).sum())
    y = mesh.all_gather_rows(x)
    z = (y - y.mean(0))[mesh.rank() * n:(mesh.rank() + 1) * n]
    out["gather"] = (y, (torch.tanh(z) * w).sum())
    return out


def collectives_case(rank, world):
    X, Wt = coll_inputs()
    res = {}
    for name in ("pmean", "psum", "gather"):
        x = torch.tensor(_rows(X, rank, world), requires_grad=True)
        value, loss = collective_losses(x, torch.tensor(_rows(Wt, rank, world)))[name]
        (g,) = torch.autograd.grad(loss, x, create_graph=True)
        (gg,) = torch.autograd.grad((g ** 2).sum(), x)
        res.update({f"coll/{name}/value": value.detach().numpy(), f"coll/{name}/loss": loss.detach().numpy(),
                    f"coll/{name}/grad": g.detach().numpy(), f"coll/{name}/grad2": gg.numpy()})
    return res


def synth(rng, n, res=RES):
    return {"depth": rng.uniform(2.0, 79.0, (n, 1, *res)).astype(np.float32),
            "mask": (rng.rand(n, 1, *res) > 0.1).astype(np.float32)}


def make_trainer(d):
    from dusty_gan_v2_tpu_torch.training import Trainer

    return Trainer(json.loads(d["cfg"].item()), device="cpu", angle=torch.from_numpy(d["angle"]))


def _state_flat(state, prefix):
    out = {}
    for name in ("G", "G_ema", "D"):
        for k, v in getattr(state, name).state_dict().items():
            out[f"{prefix}/{name}.{k}"] = v.detach().numpy().copy()
    for f in ("p", "sign_cum", "n_pred_cum"):
        out[f"{prefix}/ada.{f}"] = getattr(state.ada, f).numpy().copy()
    out[f"{prefix}/pl_ema"] = state.pl_ema.numpy().copy()
    return out


def ops_case(d, rank, world):
    """minibatch-stddev (values, gradients, double backward), the D's R1 gradients, a
    train-mode G forward's buffers and images, ADA's sums."""
    from dusty_gan_v2_tpu_torch.ops.normalize import minibatch_stddev
    from dusty_gan_v2_tpu_torch.training import r1_penalty

    res = {}
    x = torch.tensor(_rows(d["mb_x"], rank, world), requires_grad=True)
    y = minibatch_stddev(x, group=4)
    (g,) = torch.autograd.grad((torch.sin(y) * torch.tensor(_rows(d["mb_w"], rank, world))).sum(), x,
                               create_graph=True)
    (gg,) = torch.autograd.grad((g ** 2).sum(), x)
    res.update({"mb/value": y.detach().numpy(), "mb/grad": g.detach().numpy(), "mb/grad2": gg.numpy()})

    tr = make_trainer(d)
    state = tr.init_state(0)
    xr = torch.from_numpy(_rows(d["reals"], rank, world))
    res["D/logits"] = state.D(xr, blur_fuse=False).detach().numpy()
    state.D.zero_grad(set_to_none=True)
    r1_penalty(state.D, xr).backward()  # R1's double backward through the gathered statistic
    mesh.pmean_grads_(state.D.parameters())
    res.update({f"r1/{k}": p.grad.numpy().copy() for k, p in state.D.named_parameters() if p.grad is not None})

    st = ReplayStream([d["z"], d["shift"], d["noise"]], rank=rank, world=world).with_batch(B // world)
    res["G/image"] = tr._fake(state, st).detach().numpy()
    res.update({f"G/{k}": b.numpy().copy() for k, b in state.G.named_buffers() if k.endswith(("w_avg", "ema_var"))})
    ada = tr.ada.cumulate(state.ada, torch.from_numpy(_rows(d["y_real"], rank, world)))
    res["ada/sums"] = torch.stack([ada.sign_cum, ada.n_pred_cum]).numpy()
    return res


def trainer_case(d, rank, world):
    """Every step variant (SEQ) from the trainer's own generator, then each REPLAY variant
    from the JAX pre-state on its draws replayed by global id."""
    from dusty_gan_v2_tpu_torch.training.checkpoint import load_state_payload

    res = {}
    tr = make_trainer(d)
    state = tr.init_state(0)
    for it in SEQ:
        m = tr.step(state, {k: _rows(v, rank, world) for k, v in synth(np.random.RandomState(it), B).items()}, it)
        res.update({f"seq/{it}/{k}": v.numpy() for k, v in m.items()})
    res.update(_state_flat(state, "seq"))
    pre = torch.load(d["pre_path"].item(), map_location="cpu", weights_only=True)
    batch = {"depth": _rows(d["jbatch_depth"], rank, world), "mask": _rows(d["jbatch_mask"], rank, world)}
    for it in REPLAY:
        state = load_state_payload(tr.init_state(0), pre)
        draws = [d[f"draws/{it}/{i}"] for i in range(int(d[f"draws/{it}/n"]))]
        rs = ReplayStream(draws, rank=rank, world=world)
        m = tr.step(state, batch, it, draws=rs)
        assert rs.remaining == 0, "the port drew less than the JAX step"
        res.update({f"replay/{it}/{k}": v.numpy() for k, v in m.items()})
        res.update(_state_flat(state, f"replay/{it}"))
    return res


def semseg_model(kw):
    from dusty_gan_v2_tpu_torch.semseg import SqueezeSegV2

    return SqueezeSegV2(**{**kw, "dtype": torch.float64}).double()


def semseg_case(d, rank, world):
    """One float64 SemsegTrainer step, the dropout masks drawn by the rank-aware stream."""
    from dusty_gan_v2_tpu_torch.semseg.train_step import SemsegTrainer
    from dusty_gan_v2_tpu_torch.utils.config import Config

    cfg = json.loads(d["sem_cfg"].item())
    trainer = SemsegTrainer(semseg_model(cfg.pop("model")), Config(cfg), "cpu")
    batch = {k[len("sem/"):]: torch.from_numpy(_rows(v, rank, world)) for k, v in d.items() if k.startswith("sem/")}
    loss, _ = trainer.forward_backward(batch, 1)
    res = {"semseg/loss": mesh.pmean_(loss.clone()).numpy()}
    res.update({f"semseg/grad/{k}": p.grad.numpy().copy() for k, p in trainer.model.named_parameters()})
    trainer.update(1)
    res.update({f"semseg/param/{k}": p.detach().numpy().copy() for k, p in trainer.model.named_parameters()})
    res.update({f"semseg/stat/{k}": b.numpy().copy() for k, b in trainer.model.named_buffers()
                if k.endswith(("running_mean", "running_var"))})
    return res


# ------------------------------------------------------------------ the JAX side
class GlobalDraws:
    """Seeded numpy draws for the JAX step on a `world`-device mesh, keyed by the sample's
    global id: each call records one global array of (len(ids) * world, *shape) rows and
    returns the rows of `ids` (a concatenated reals ++ fakes batch of 2b rows has ids in
    [0, 2 b world)). The port replays the global arrays, every rank keeping its rows."""

    def __init__(self, world):
        self.world, self.rng, self.log, self.n = world, np.random.RandomState(0), [], None

    def start(self, seed):
        self.rng, self.log = np.random.RandomState(seed), []

    def take(self, a, ids):
        import jax.numpy as jnp

        self.log.append(a)
        return jnp.asarray(a)[ids]

    def rows(self, ids):
        return ids.shape[0] * self.world

    def normal(self, ids, shape):
        return self.take(self.rng.randn(self.rows(ids), *shape).astype(np.float32), ids)

    def uniform(self, ids, shape, minval=0.0, maxval=1.0):
        return self.take(self.rng.uniform(minval, maxval, (self.rows(ids), *shape)).astype(np.float32), ids)

    def randint(self, ids, shape, minval=0, maxval=2):
        return self.take(self.rng.randint(minval, maxval, (self.rows(ids), *shape)).astype(np.int32), ids)

    def logistic(self, n, shape, eps=1e-7):
        import jax.numpy as jnp

        u = self.rng.uniform(eps, 1.0 - eps, (n, *shape)).astype(np.float32)
        a = (np.log(u) - np.log1p(-u)).astype(np.float32)
        self.log.append(a)
        return jnp.asarray(a)


def patch_global_draws(mp, src):
    """tests/test_torch_trainer.py::_patch with draws keyed by global id."""
    import jax.numpy as jnp
    from dusty_gan_v2_tpu.augment import ada as jada
    from dusty_gan_v2_tpu.models import dusty_v1 as jdusty_v1
    from dusty_gan_v2_tpu.models import dusty_v2 as jdusty_v2
    from dusty_gan_v2_tpu.ops import pad as jpad
    from dusty_gan_v2_tpu.ops import shift as jshift
    from dusty_gan_v2_tpu.parallel import persample as jps
    from dusty_gan_v2_tpu.training import trainer as jtrainer

    mp.setattr(jtrainer, "ps_normal", lambda key, ids, shape, dtype=jnp.float32: src.normal(ids, shape))

    def warmup(x, rng, dropout_ratio, raydrop_const, blur_kernel=None, ids=None):
        ids = jps.global_ids(x.shape[0]) if ids is None else ids
        if blur_kernel is not None:
            x = jpad.filter2d(x, blur_kernel)
        keep = (src.uniform(ids, x.shape[1:]) < 1.0 - dropout_ratio).astype(x.dtype)
        return keep * x + (1.0 - keep) * raydrop_const

    mp.setattr(jtrainer, "warmup_fn", warmup)
    mp.setattr(jdusty_v2, "ps_uniform", lambda key, ids, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0:
               src.uniform(ids, shape, minval, maxval))

    def per_sample_keys(key, ids):  # the global ids in place of keys, for the lookup below
        src.n = src.rows(ids)
        return ids

    mp.setattr(jdusty_v1, "per_sample_keys", per_sample_keys)
    mp.setattr(jdusty_v1, "sample_logistic", lambda k, shape, dtype=jnp.float32: src.logistic(src.n, shape)[k])

    class Stream:
        def __init__(self, key, ids):
            self.keys = self.ids = ids  # ADA reads the batch from keys.shape[0]

        def normal(self, shape=(), dtype=jnp.float32):
            return src.normal(self.ids, shape)

        def uniform(self, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
            return src.uniform(self.ids, shape, minval, maxval)

        def randint(self, shape=(), minval=0, maxval=2, dtype=jnp.int32):
            return src.randint(self.ids, shape, minval, maxval)

        def bernoulli(self, p, shape=()):
            return src.uniform(self.ids, shape) < p

    mp.setattr(jada, "PerSampleStream", Stream)
    mp.setattr(jshift, "_SHIFT_IMPL", "gather")  # see tests/test_torch_trainer.py::_patch


def jax_two_device_steps():
    """JAX Trainer.step on a 2-device submesh: two steps from its init (iterations 0 and 4,
    the REPLAY variant's, so that one compiled step serves all; Adam's moments are then
    populated: a first Adam step from zero moments turns a gradient's last bits into its
    sign), ADA's p set to 0.5 (the pre-state), then each REPLAY variant from it. Returns
    (cfg, angle, batch, pre, {it: (new state, metrics, draws)})."""
    import functools

    import jax
    import jax.numpy as jnp

    from dusty_gan_v2_tpu.parallel import make_mesh
    from dusty_gan_v2_tpu.training import Trainer as JTrainer
    from test_trainer import make_angle, synth_batch, tiny_cfg

    cfg = tiny_cfg()
    cfg.training.batch_size = B
    src = GlobalDraws(WORLD)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_global_draws(mp, src)
        t = JTrainer(cfg, mesh=make_mesh(jax.devices()[:WORLD]), angle=make_angle(RES))
        state = jax.jit(t.init_state)(jax.random.PRNGKey(0))
        batch = {k: np.asarray(v) for k, v in synth_batch(np.random.RandomState(0), B, RES).items()}
        traced = {}

        def step(s, it):
            src.start(1000 + it)
            skip = t.warmup_params(it) == (0.0, 0.0)
            with pytest.MonkeyPatch.context() as mp2:  # the ADA input gradient: tests/test_torch_trainer.py
                mp2.setattr(jax, "jit", functools.partial(jax.jit, compiler_options={
                    "xla_backend_optimization_level": 0}))
                key = (*t.get_step_fn(it, skip_warmup=skip)[1:], skip)
                new, m = t.step(jax.tree_util.tree_map(jnp.copy, s), batch, jax.random.PRNGKey(1), it)
            if src.log:
                traced[key] = src.log
            return new, {k: float(v) for k, v in m.items()}, traced[key]

        for it in (0, 4):
            state, _, _ = step(state, it)
        # the replaced p keeps the state's sharding, or the step compiles anew
        pre = state.replace(ada=state.ada._replace(p=jax.device_put(jnp.asarray(0.5, jnp.float32),
                                                                    state.ada.p.sharding)))
        for it in REPLAY:
            out[it] = step(pre, it)
    return cfg, np.asarray(make_angle(RES)), batch, pre, out


def semseg_inputs():
    from test_torch_semseg import CRF, LOGIT_BIAS

    rng = np.random.RandomState(20)
    shape = (8, 32)
    cfg = {"arch": {"name": "squeezeseg_v2", "inputs": ["xyz", "depth"]}, "dataset": {"num_classes": 3},
           "random_seed": 0,
           "loss": {"name": "focal_loss", "focal_gamma": 2, "cls_loss_coef": 15.0, "cls_weight": [0.33, 1.0, 3.5]},
           "training": {"lr": 0.05, "lr_momentum": 0.9, "lr_decay": 0.5, "lr_decay_steps": 10000,
                        "weight_decay": 1e-4, "max_grad_norm": 1.0},
           "model": {"inputs": ["xyz", "depth"], "num_classes": 3, "use_crf": True,
                     "crf_kwargs": {**CRF, "num_iters": 1}, "logit_bias": list(LOGIT_BIAS)}}
    n = 4
    batch = {"sem/xyz": rng.randn(n, 3, *shape), "sem/depth": rng.randn(n, 1, *shape),
             "sem/mask": (rng.rand(n, *shape) > 0.2).astype(np.uint8),
             "sem/label": rng.randint(0, 3, (n, *shape)).astype(np.uint8)}
    return json.dumps(cfg), batch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX 2-device steps, the inputs written for the workers, the two workers' results
    and the one-process results of the same cases (no group bound)."""
    import jax

    from dusty_gan_v2_tpu_torch.convert import load_jax_train_state
    from dusty_gan_v2_tpu_torch.training import Trainer
    from dusty_gan_v2_tpu_torch.training.checkpoint import state_payload

    tmp = tmp_path_factory.mktemp("parallel")
    cfg, angle, jbatch, pre, jout = jax_two_device_steps()
    tr = Trainer(cfg.to_dict(), device="cpu", angle=torch.from_numpy(angle))
    st = load_jax_train_state(tr.init_state(), jax.tree_util.tree_map(np.asarray, pre))
    torch.save(state_payload(st), tmp / "pre.pt")
    rng = np.random.RandomState(3)
    sem_cfg, sem_batch = semseg_inputs()
    d = {"cfg": np.array(json.dumps(cfg.to_dict())), "angle": angle, "pre_path": np.array(str(tmp / "pre.pt")),
         "jbatch_depth": jbatch["depth"], "jbatch_mask": jbatch["mask"],
         "mb_x": rng.randn(8, 4, 2, 3), "mb_w": rng.randn(8, 5, 2, 3),
         "reals": rng.uniform(-1, 1, (B, 1, *RES)).astype(np.float32),
         "z": rng.randn(B, 16).astype(np.float32), "shift": rng.rand(B).astype(np.float32),
         "noise": rng.logistic(size=(B, 1, *RES)).astype(np.float32), "y_real": rng.randn(B, 1).astype(np.float32),
         "sem_cfg": np.array(sem_cfg), **sem_batch}
    for it, (_, _, draws) in jout.items():
        d[f"draws/{it}/n"] = np.array(len(draws))
        d.update({f"draws/{it}/{i}": a for i, a in enumerate(draws)})
    np.savez(tmp / "inputs.npz", **d)
    spawn([tmp])
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    one = {**collectives_case(0, 1), **ops_case(d, 0, 1), **semseg_case(d, 0, 1), **trainer_case(d, 0, 1)}
    return {"ranks": ranks, "one": one, "jax": jout, "pre": pre, "d": d}


def _cat(runs, key):
    return np.concatenate([r[key] for r in runs["ranks"]])


def _same(runs, key):
    """The value every rank holds (they must agree bit for bit)."""
    vals = [r[key] for r in runs["ranks"]]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0], err_msg=key)
    return vals[0]


# ------------------------------------------------------------------ tests
def test_collectives_are_the_identity_with_no_group():
    assert not mesh.bound() and mesh.rank() == 0 and mesh.world_size() == 1 and mesh.local_batch(6) == 6
    x = torch.randn(3, 2, requires_grad=True)
    for f in (mesh.axis_pmean, mesh.axis_psum, mesh.all_gather_rows):
        assert f(x) is x
    t = torch.ones(2)
    assert mesh.psum_(t) is t and torch.equal(t, torch.ones(2))
    mesh.barrier()
    if not torch.cuda.is_available():  # the card is the default: no quiet gloo in its place
        with pytest.raises(RuntimeError, match="is_available"):
            mesh.init_distributed("localhost:1", 1, 0)
    with pytest.raises(ValueError, match="together"):
        mesh.init_distributed("localhost:1", device="cpu")
    assert not mesh.bound()


@pytest.mark.parametrize("name", ["pmean", "psum", "gather"])
def test_collective_matches_one_process(runs, name):
    """Forward, backward and double backward of each collective, concatenated over the
    ranks, against the one-process computation on the concatenated rows (float64)."""
    one, k = runs["one"], f"coll/{name}/"
    if name == "gather":
        np.testing.assert_array_equal(_same(runs, k + "value"), one[k + "value"])
    else:
        np.testing.assert_allclose(_same(runs, k + "value"), one[k + "value"], rtol=1e-14)
    assert abs(sum(float(r[k + "loss"]) for r in runs["ranks"]) - float(one[k + "loss"])) <= 1e-13
    np.testing.assert_allclose(_cat(runs, k + "grad"), one[k + "grad"], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(_cat(runs, k + "grad2"), one[k + "grad2"], rtol=1e-12, atol=1e-14)


def test_raw_reductions(runs):
    np.testing.assert_array_equal(_same(runs, "raw/pmean"), np.full(3, 1.5, np.float32))
    np.testing.assert_array_equal(_same(runs, "raw/psum_int"), np.arange(3) * 3)
    np.testing.assert_array_equal(_same(runs, "raw/flat"), np.array([0.5] * 4 + [1.0] * 3, np.float32))


@pytest.mark.parametrize("draw", ["normal", "uniform", "randint", "bernoulli", "logistic"])
@pytest.mark.parametrize("layout", ["plain", "reals++fakes", "pl"])
def test_stream_rows_concatenate_to_one_process(draw, layout):
    """Rank k's rows of each draw, put back into the global layout, are the one-process
    draw from the same generator seed; ReplayStream hands each rank the same rows of a
    given global array."""
    n_global, shape = 8, (2, 3)
    args = {"normal": (shape,), "uniform": (shape,), "randint": (shape, 0, 5), "bernoulli": (0.3, shape),
            "logistic": (shape,)}[draw]

    def draw_from(rank, world, arrays=None):
        n = n_global // world
        st = (PerSampleStream(n, torch.Generator().manual_seed(11), "cpu", rank, world) if arrays is None
              else ReplayStream(arrays, rank=rank, world=world))
        st = {"plain": lambda: st.with_batch(n), "pl": lambda: st.with_batch(n // 2),
              "reals++fakes": lambda: st.with_batch(2 * n, parts=2)}[layout]()
        return getattr(st, draw)(*args)

    def regroup(parts):  # reals++fakes: each rank holds [its reals; its fakes]
        if layout != "reals++fakes":
            return torch.cat(parts)
        h = parts[0].shape[0] // 2
        return torch.cat([p[:h] for p in parts] + [p[h:] for p in parts])

    one = draw_from(0, 1)
    assert torch.equal(regroup([draw_from(r, WORLD) for r in range(WORLD)]), one)
    src = torch.arange(float(one.shape[0] * 6)).reshape(one.shape[0], *shape)
    assert torch.equal(regroup([draw_from(r, WORLD, [src]) for r in range(WORLD)]), draw_from(0, 1, [src]))


def test_replay_stream_checks_the_global_shape():
    rs = ReplayStream([np.zeros((8, 2), np.float32)], rank=1, world=2).with_batch(4)
    assert rs.normal((2,)).shape == (4, 2)
    with pytest.raises(ValueError, match="asks for"):
        ReplayStream([np.zeros((4, 2), np.float32)], rank=1, world=2).with_batch(4).normal((2,))


def test_minibatch_stddev_matches_one_process(runs):
    """The statistic over the gathered global batch: values, input gradients and the
    double backward (float64)."""
    one = runs["one"]
    for k in ("mb/value", "mb/grad", "mb/grad2"):
        np.testing.assert_allclose(_cat(runs, k), one[k], rtol=1e-10, atol=1e-12, err_msg=k)


def test_r1_gradient_through_gathered_stddev_matches_one_process(runs):
    """The D's logits, and its parameters' R1 gradients (a double backward through the
    gathered minibatch-stddev, averaged over the ranks), equal one process's on the
    whole batch (float32: 1e-5 of each tensor's largest magnitude)."""
    one = runs["one"]
    np.testing.assert_allclose(_cat(runs, "D/logits"), one["D/logits"], rtol=1e-5, atol=1e-6)
    keys = [k for k in one if k.startswith("r1/")]
    assert len(keys) >= 8
    for k in keys:
        g = _same(runs, k)
        assert np.abs(g - one[k]).max() <= 1e-5 * np.abs(one[k]).max(), k
    assert max(np.abs(one[k]).max() for k in keys) > 0


def test_generator_statistics_and_ada_sums_match_one_process(runs):
    """A train-mode G forward on each rank's rows: ModConv's ema_var and w_avg are the
    global batch's on every rank, and the images are one process's rows; ADA's sums."""
    one = runs["one"]
    keys = [k for k in one if k.startswith("G/") and k != "G/image"]
    assert any(k.endswith("w_avg") for k in keys) and sum(k.endswith("ema_var") for k in keys) >= 4
    for k in keys:
        np.testing.assert_allclose(_same(runs, k), one[k], rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(_cat(runs, "G/image"), one["G/image"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_same(runs, "ada/sums"), one["ada/sums"])


def _invariance(runs, prefix):
    """Every array under `prefix`: the same on each rank, and one process's within JAX's
    invariance bars on parameters (rtol 1e-4, atol 1e-5)."""
    one = runs["one"]
    keys = [k for k in one if k.startswith(prefix + "/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(_same(runs, k), one[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("it", SEQ)
def test_trainer_step_two_processes_equal_one(runs, it):
    """The step's metrics at each iteration of the own-generator run (warmup, PL, ADA, R1,
    steady), 2 processes against 1, at JAX's invariance bars; the final states (G, G_ema,
    D, ADA, pl_ema) at its parameter bars."""
    one = runs["one"]
    keys = [k for k in one if k.startswith(f"seq/{it}/")]
    sched = {1: 5, 2: 8, 3: 5, 4: 9, 1000: 9, 1001: 5, 1002: 8}[it]  # metrics: PL adds 2, R1 1, ADA rt 1
    assert len(keys) == sched, keys
    for k in keys:
        np.testing.assert_allclose(_same(runs, k), one[k], rtol=2e-4, atol=2e-5, err_msg=k)
    if it == SEQ[-1]:
        _invariance(runs, "seq")


@pytest.mark.parametrize("it", REPLAY)
def test_trainer_step_matches_jax_two_device_submesh(runs, it):
    """One step from the JAX pre-state on draws replayed by global id: the 2-process port
    against JAX Trainer.step on a 2-device submesh (metrics 1e-4, each parameter's update
    within 1e-3 of its largest), and against the 1-process port at the invariance bars."""
    import jax

    from test_torch_trainer import _jflat, _update_err

    jnew, jm, _ = runs["jax"][it]
    ref = _jflat(jnew)
    old = _jflat(runs["pre"])
    got = {k[len(f"replay/{it}/"):]: v for k, v in runs["ranks"][0].items() if k.startswith(f"replay/{it}/")}
    for k, v in jm.items():
        g = float(_same(runs, f"replay/{it}/{k}"))
        assert abs(g - v) <= 1e-4 * max(1.0, abs(v)), (k, g, v)
    st = make_trainer(runs["d"]).init_state(0)
    upd_keys = [f"{net}.{k}" for net in ("G", "D") for k, _ in getattr(st, net).named_parameters()]
    err = _update_err(got, ref, old, upd_keys)
    assert err <= 1e-3, err
    ja = jax.tree_util.tree_map(np.asarray, jnew.ada)
    for f in ("p", "sign_cum", "n_pred_cum"):
        assert abs(float(got[f"ada.{f}"]) - float(getattr(ja, f))) <= 1e-4, f
    for k in ref:
        if k.endswith(("w_avg", "ema_var")):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    _invariance(runs, f"replay/{it}")


def test_semseg_float64_step_two_processes_equal_one(runs):
    """SqueezeSegV2 + CRF, one float64 step with the clip and SGD, dropout masks drawn
    by global rows: loss, gradients, parameters and running statistics."""
    one = runs["one"]
    np.testing.assert_allclose(_same(runs, "semseg/loss"), one["semseg/loss"], rtol=1e-12, atol=1e-13)
    for part, (rtol, atol) in (("grad", (1e-7, 1e-8)), ("param", (1e-7, 1e-8)), ("stat", (1e-9, 1e-12))):
        keys = [k for k in one if k.startswith(f"semseg/{part}/")]
        assert keys
        for k in keys:
            np.testing.assert_allclose(_same(runs, k), one[k], rtol=rtol, atol=atol, err_msg=k)


def _worker(rank, world, port, tmp):
    torch.set_num_threads(1)
    mesh.init_distributed(f"localhost:{port}", world, rank, device="cpu", timeout=60)
    try:
        assert (mesh.rank(), mesh.world_size(), mesh.bound()) == (rank, world, True)
        d = dict(np.load(Path(tmp) / "inputs.npz"))
        res = collectives_case(rank, world)
        t = torch.full((3,), float(rank + 1))
        res["raw/pmean"] = mesh.pmean_(t.clone()).numpy()
        res["raw/psum_int"] = mesh.psum_(torch.arange(3) * (rank + 1)).numpy()
        grads = [torch.full((2, 2), float(rank)), torch.full((3,), 2.0 * rank)]
        mesh.pmean_flat_(grads)
        res["raw/flat"] = torch.cat([g.reshape(-1) for g in grads]).numpy()
        mesh.barrier()
        res.update(ops_case(d, rank, world))
        res.update(semseg_case(d, rank, world))
        res.update(trainer_case(d, rank, world))
        np.savez(Path(tmp) / f"rank{rank}.npz", **res)
    finally:
        mesh.shutdown()


if __name__ == "__main__" and "--worker" in sys.argv:
    _i = sys.argv.index("--worker")
    _worker(*map(int, sys.argv[_i + 1:_i + 4]), sys.argv[_i + 4])
    sys.exit(0)
