"""Checkpoints of the port's training state (dusty_gan_v2_tpu_torch/training/checkpoint.py)
and the step's draws keyed by (seed, iteration), on the CPU.

- save -> load into a fresh template restores every tensor exactly: G, G_ema and D
  (parameters and buffers), both Adams' moments and step counts, the ADA state, pl_ema
  and the iteration; the file holds only what torch.load(weights_only=True) reads;
- k + m steps equal k steps, a save, a load into a fresh Trainer and m steps, bit for
  bit (tiny config with PL, R1, ADA and warmup on);
- iteration i's draws do not depend on which iterations ran before it.
"""

import copy

import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu_torch.parallel import fold_seed
from dusty_gan_v2_tpu_torch.training import Trainer, load_checkpoint, save_checkpoint
from dusty_gan_v2_tpu_torch.training.checkpoint import state_payload

from test_trainer import RES, make_angle, synth_batch, tiny_cfg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()  # loss.pl 1, lazy pl 2 / gp 4 / ada 2, warmup over 125 iterations
    angle = torch.from_numpy(np.array(make_angle(RES)))
    batches = [{k: np.array(v) for k, v in synth_batch(np.random.RandomState(s), 8, RES).items()} for s in range(6)]
    return cfg, angle, batches


def _trainer(setup, seed=3):
    cfg, angle, _ = setup
    return Trainer(cfg.to_dict(), device="cpu", angle=angle, seed=seed)


def assert_states_equal(a, b):
    """Every tensor of two TrainStates bit for bit, and the iteration."""
    pa, pb = state_payload(a), state_payload(b)

    def walk(x, y, where):
        if isinstance(x, dict):
            assert set(x) == set(y), where
            for k in x:
                walk(x[k], y[k], f"{where}.{k}")
        elif torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), where
        else:
            assert x == y, where

    walk(pa, pb, "state")


def _allowed_types(obj):
    if isinstance(obj, dict):
        return all(isinstance(k, (str, int)) and _allowed_types(v) for k, v in obj.items())
    return isinstance(obj, (torch.Tensor, str, int))


def test_round_trip_is_exact(setup, tmp_path):
    cfg, _, batches = setup
    tr = _trainer(setup)
    st = tr.init_state(seed=1)
    for it in range(3):  # PL and R1 at 0, PL at 2: both Adams and pl_ema populated
        tr.step(st, batches[it], it)
    path = tmp_path / "c.ckpt"
    save_checkpoint(str(path), cfg, st, tr.angle, num_imgs=3 * 8)
    assert not (tmp_path / "c.ckpt.tmp").exists()
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert _allowed_types(payload) and set(payload) == {"cfg", "step", "angle", "state"}

    fresh = _trainer(setup, seed=9).init_state(seed=5)
    got_cfg, loaded, angle, num_imgs = load_checkpoint(str(path), fresh)
    assert loaded is fresh and num_imgs == 24 and loaded.step == 3
    assert got_cfg == cfg and torch.equal(angle, tr.angle)
    assert_states_equal(loaded, st)
    assert float(loaded.pl_ema) > 0 and float(loaded.opt_G.state[next(loaded.G.parameters())]["step"]) == 5.0
    # without a template: the file's state dict
    _, raw, _, _ = load_checkpoint(str(path))
    assert raw["iteration"] == 3 and set(raw) == {"G", "G_ema", "D", "opt_G", "opt_D", "ada", "pl_ema", "iteration"}
    # a state dict that does not fit the template fails
    raw["G"]["extra"] = torch.zeros(1)
    torch.save({**payload, "state": raw}, tmp_path / "bad.ckpt")
    with pytest.raises(RuntimeError):
        load_checkpoint(str(tmp_path / "bad.ckpt"), _trainer(setup).init_state())


@pytest.mark.parametrize("k,m", [(3, 2), (2, 3)])
def test_k_plus_m_steps_equal_resumed_steps(setup, tmp_path, k, m):
    cfg, _, batches = setup
    tr = _trainer(setup)
    straight = tr.init_state(seed=1)
    for it in range(k + m):
        tr.step(straight, batches[it], it)

    tr_a = _trainer(setup)
    first = tr_a.init_state(seed=1)
    for it in range(k):
        tr_a.step(first, batches[it], it)
    save_checkpoint(str(tmp_path / "k.ckpt"), cfg, first, tr_a.angle, num_imgs=k * 8)
    tr_b = _trainer(setup)  # a fresh trainer, whose generator has drawn nothing
    _, resumed, _, num_imgs = load_checkpoint(str(tmp_path / "k.ckpt"), tr_b.init_state(seed=7))
    for it in range(num_imgs // 8, k + m):
        tr_b.step(resumed, batches[it], it)
    assert_states_equal(resumed, straight)


def test_draws_keyed_by_seed_and_iteration(setup):
    _, _, batches = setup
    tr = _trainer(setup)
    s0 = tr.init_state(seed=1)
    for it in range(2):
        tr.step(s0, batches[it], it)
    # trainer A takes iteration 9 right away; trainer B after iterations 5 and 6 on
    # another state, which move its generator
    tr_a, tr_b = _trainer(setup), _trainer(setup)
    a, b, other = copy.deepcopy(s0), copy.deepcopy(s0), copy.deepcopy(s0)
    tr_b.step(other, batches[2], 5)
    tr_b.step(other, batches[3], 6)
    ma, mb = tr_a.step(a, batches[4], 9), tr_b.step(b, batches[4], 9)
    assert all(torch.equal(ma[key], mb[key]) for key in ma)
    assert_states_equal(a, b)
    # another iteration, or another seed, draws otherwise
    assert not torch.equal(tr_a.stream(4, 9).normal((3,)), tr_a.stream(4, 10).normal((3,)))
    assert not torch.equal(tr_a.stream(4, 9).normal((3,)), _trainer(setup, seed=4).stream(4, 9).normal((3,)))
    assert torch.equal(tr_a.stream(4, 9).normal((3,)), tr_b.stream(4, 9).normal((3,)))


def test_fold_seed():
    seeds = {fold_seed(s, i) for s in range(4) for i in range(64)} | {fold_seed(s) for s in range(4)}
    assert len(seeds) == 4 * 64 + 4 and all(0 <= x < 2**64 for x in seeds)
    assert fold_seed(0, 1, 2) != fold_seed(0, 2, 1)
    assert fold_seed(5, 2**40) != fold_seed(5, 2**40 + 1)
