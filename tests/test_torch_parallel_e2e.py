"""The port's two training command lines data parallel on the CPU: two gloo processes
against one.

Two worker processes run this file itself with --worker (tests/test_torch_parallel.py
starts them) and drive, in one interpreter each:
- train_gan --distributed at world 2 on the fabricated KITTI Raw tree and tiny config of
  tests/test_torch_gan_e2e.py (4 iterations at a global batch of 8: warmup, ADA, lazy R1
  and PL, checkpoints at 2 and 4), then a world-2 --resume from the checkpoint at 2;
- train_semseg --distributed at world 2 on tests/test_torch_semseg_e2e.py's fabricated
  frontal tree (KITTI frontal frames without flips: the GTA datasets draw their ray drop
  from numpy's global generator in the loader's threads, so no two runs of them load the
  same batches), one step at a global batch of 4 and the validation.
The test process runs the same at world 1. Each rank gets a log directory of its own;
the chief's must hold what world 1 writes (stats within JAX's invariance bars, the final
state within its parameter bars) and every other rank's must not exist. The resumed
world-2 run ends on the uninterrupted world-2 run's state bit for bit.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dusty_gan_v2_tpu_torch.cli import train_gan, train_semseg

GAN_B = 8


def _common(rank, world, port):
    return ["--distributed", "--coordinator", f"localhost:{port}", "--num_processes", str(world), "--process_id",
            str(rank), "--device", "cpu", "--num_workers", "2"]


def _worker(rank, world, port, tmp):
    torch.set_num_threads(1)
    tmp = Path(tmp)
    a = json.loads((tmp / "args.json").read_text())
    sfx = "" if rank == 0 else f"_rank{rank}"
    train_gan.main(["--config", a["gan_cfg"], "--log_dir", str(tmp / f"g2{sfx}")] + _common(rank, world, port))
    mid = tmp / "g2" / "models" / f"checkpoint_{2 * GAN_B:010d}.ckpt"
    train_gan.main(["--config", a["gan_cfg"], "--log_dir", str(tmp / f"g2r{sfx}"), "--resume", str(mid)]
                   + _common(rank, world, a["port2"]))
    train_semseg.main(["--config", a["sem_cfg"], "--log_dir", str(tmp / f"s2{sfx}")] + _common(rank, world, a["port3"]))


if __name__ == "__main__" and "--worker" in sys.argv:
    _i = sys.argv.index("--worker")
    _worker(*map(int, sys.argv[_i + 1:_i + 4]), sys.argv[_i + 4])
    sys.exit(0)


from test_torch_gan_e2e import _assert_equal_trees, _payload, kitti_root  # noqa: E402,F401
from test_torch_gan_e2e import tiny_cfg as gan_cfg  # noqa: E402
from test_torch_parallel import free_port, spawn  # noqa: E402
from test_torch_semseg_e2e import tree, write_cfg  # noqa: E402,F401


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(kitti_root, tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_e2e")
    (tmp / "gan.yaml").write_text(yaml.safe_dump(gan_cfg(kitti_root)))
    sem = write_cfg(tmp / "sem.yaml", tree, max_steps=1)
    cfg = yaml.safe_load(sem.read_text())
    cfg["dataset"].update(name="kitti_raw_frontal", random_flip=False)
    sem.write_text(yaml.safe_dump(cfg))
    (tmp / "args.json").write_text(json.dumps({"gan_cfg": str(tmp / "gan.yaml"), "sem_cfg": str(sem),
                                               "port2": free_port(), "port3": free_port()}))
    spawn([tmp], script=__file__)
    common = ["--device", "cpu", "--num_workers", "2"]
    train_gan.main(["--config", str(tmp / "gan.yaml"), "--log_dir", str(tmp / "g1")] + common)
    train_semseg.main(["--config", str(sem), "--log_dir", str(tmp / "s1")] + common)
    return tmp


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _close_rows(a, b, skip=("stats/imgs_per_sec",)):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert set(ra) == set(rb)
        for k in ra:
            if k not in skip:
                np.testing.assert_allclose(ra[k], rb[k], rtol=2e-4, atol=2e-5, err_msg=k)


def _close_trees(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _close_trees(a[k], b[k], f"{where}.{k}")
    elif torch.is_tensor(a):
        np.testing.assert_allclose(a.double().numpy(), b.double().numpy(), rtol=1e-4, atol=1e-5, err_msg=where)
    else:
        assert a == b, where


def test_train_gan_world_two_writes_what_world_one_writes(runs):
    """Stats rows at every iteration (losses, D outputs, PL, R1, ADA) and the two
    checkpoints' states: the chief's run against the one-process run."""
    _close_rows(_rows(runs / "g2" / "stats.jsonl"), _rows(runs / "g1" / "stats.jsonl"))
    for n in (2, 4):
        name = f"checkpoint_{n * GAN_B:010d}.ckpt"
        a, b = _payload(runs / "g2" / "models" / name), _payload(runs / "g1" / "models" / name)
        assert a["step"] == b["step"] == n * GAN_B
        _close_trees(a["state"], b["state"])
    assert sorted(p.name for p in (runs / "g2" / "images").glob("*.npz")) == \
        sorted(p.name for p in (runs / "g1" / "images").glob("*.npz"))


def test_only_the_chief_writes(runs):
    for d in ("g2", "g2r", "s2"):
        assert (runs / d).is_dir()
        assert not (runs / f"{d}_rank1").exists(), d


def test_train_gan_world_two_resume_is_bit_exact(runs):
    name = f"checkpoint_{4 * GAN_B:010d}.ckpt"
    a, b = _payload(runs / "g2r" / "models" / name), _payload(runs / "g2" / "models" / name)
    _assert_equal_trees(a["state"], b["state"])
    assert [r["iteration"] for r in _rows(runs / "g2r" / "stats.jsonl")] == [3, 4]


def test_train_semseg_world_two_writes_what_world_one_writes(runs):
    """The step's stats (loss, train IoU) and the BatchNorm statistics of its forward
    against world 1 at JAX's invariance bars: they depend on every row of the global
    batch, so they show that the ranks loaded world 1's batch. The updated parameters
    are not compared in float32: at this model's init float32 parts two runs whose
    arithmetic differs in its last bits (tests/test_torch_semseg_e2e.py; here world 1
    itself lands up to 0.8% of an update away from the float64 step), and
    tests/test_torch_parallel.py holds the update's math, world 2 against world 1, in
    float64 within 1e-7. The chief's validation row is the validation of the checkpoint
    it wrote (its IoU counts argmax decisions, which those bits flip)."""
    from dusty_gan_v2_tpu_torch.semseg.train_step import load_checkpoint, load_model_state

    a, b = _rows(runs / "s2" / "stats.jsonl"), _rows(runs / "s1" / "stats.jsonl")
    assert [r["step"] for r in a] == [r["step"] for r in b] == [1, 1]
    _close_rows(a[:1], b[:1])
    name = "checkpoint_step-0000000001.ckpt"
    cfg, pa = load_checkpoint(str(runs / "s2" / "models" / name))
    _, pb = load_checkpoint(str(runs / "s1" / "models" / name))
    assert set(pa["params"]) == set(pb["params"])
    _close_trees(pa["batch_stats"], pb["batch_stats"])
    model = load_model_state(train_semseg.build_model(cfg), pa)
    _, val_ds = train_semseg.build_dataset(cfg)
    conf = train_semseg.validate(model, val_ds, tuple(cfg.arch.inputs), int(cfg.training.batch_size),
                                 int(cfg.dataset.num_classes), torch.device("cpu"), 2)
    assert a[1]["val/iou"] == train_semseg.iou_of(conf).tolist()
