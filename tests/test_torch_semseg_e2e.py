"""The port's semseg slice as a whole, on the CPU: the training step against the JAX
step's math (train_semseg.py's step_fn built from its pieces), and the command lines end
to end on fabricated frames (the port's twin of tests/test_semseg_e2e.py).

The training step: one step in float64 (the JAX model under enable_x64 with its logits
kept in float64, the port in double) holds the loss, every gradient, the updated
parameters and the running statistics to 1e-8 of their largest magnitude. Three float32
steps cross a learning-rate decay boundary with the clip active; each starts both sides
from the same state (JAX's parameters, statistics and momentum carried into the port),
because two float32 trajectories of this model part within a step: its gradients at
init are ~1e5 in norm, and a 7e-6 difference in the parameters after step 1 moved step
2's loss by 9% (measured). The head's dropout masks are JAX's, injected.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from jax import enable_x64

import dusty_gan_v2_tpu.semseg as jsem
import dusty_gan_v2_tpu.semseg.squeezeseg as jsqueezeseg
from dusty_gan_v2_tpu.semseg import KITTIRawFrontal as JaxKITTIRawFrontal
from dusty_gan_v2_tpu.utils.config import Config as JaxConfig
from dusty_gan_v2_tpu_torch.cli import test_semseg as port_test_semseg
from dusty_gan_v2_tpu_torch.cli import train_semseg as port_train_semseg
from dusty_gan_v2_tpu_torch.semseg import SqueezeSegV2
from dusty_gan_v2_tpu_torch.semseg.train_step import SemsegTrainer, confusion_device, load_checkpoint
from dusty_gan_v2_tpu_torch.utils.config import Config
from test_torch_semseg import CRF, LOGIT_BIAS, _frontal_frame, fixed_dropout_keys, flat, keep_mask, t, to_flax

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (16, 64)  # the training shape; frames on disk are 64 x 512
B = 4


def _load_jax_cli(name):
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}_torch_semseg_e2e",
                                                  os.path.join(_REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_cfg(lr_decay_steps=10000, max_grad_norm=1.0):
    return Config({
        "arch": {"name": "squeezeseg_v2", "inputs": ["xyz", "depth"]}, "dataset": {"num_classes": 3},
        "random_seed": 0,
        "loss": {"name": "focal_loss", "focal_gamma": 2, "cls_loss_coef": 15.0, "cls_weight": [0.33, 1.0, 3.5]},
        "training": {"lr": 0.05, "lr_momentum": 0.9, "lr_decay": 0.5, "lr_decay_steps": lr_decay_steps,
                     "weight_decay": 1e-4, "max_grad_norm": max_grad_norm},
    })


def step_batch(seed=20):
    rng = np.random.RandomState(seed)
    return {"xyz": rng.randn(B, 3, *SHAPE).astype(np.float32), "depth": rng.randn(B, 1, *SHAPE).astype(np.float32),
            "mask": (rng.rand(B, *SHAPE) > 0.2).astype(np.uint8),
            "label": rng.randint(0, 3, (B, *SHAPE)).astype(np.uint8)}


class _KeepFloat64:
    """Stands in for jnp inside the JAX squeezeseg module: its logit cast to float32
    becomes one to float64, so that the float64 step stays float64 end to end."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


# the steps' CRF runs one mean-field iteration (the configs' three repeat the same code),
# which cuts JAX's trace and compile of the float64 step by a third
STEP_CRF = dict(CRF, num_iters=1)


def jax_step(cfg, dtype, use_crf=True):
    """train_semseg.py's step_fn on one device (no shard_map; pmean is the identity), from
    its pieces: the model, loss_of and the optax chain. Returns (tx, step) with step(params,
    stats, opt_state, batch) -> (params, stats, opt_state, loss, grads, global norm)."""
    model = jsem.SqueezeSegV2(inputs=("xyz", "depth"), num_classes=3, use_crf=use_crf,
                              crf_kwargs=STEP_CRF if use_crf else None, logit_bias=LOGIT_BIAS, dtype=dtype)
    tr = cfg.training
    sched = optax.exponential_decay(tr.lr, transition_steps=tr.lr_decay_steps, decay_rate=tr.lr_decay,
                                    staircase=True)
    tx = optax.chain(optax.clip_by_global_norm(tr.max_grad_norm), optax.add_decayed_weights(tr.weight_decay),
                     optax.sgd(sched, momentum=tr.lr_momentum))
    cls_weight = jnp.asarray(cfg.loss.cls_weight, jnp.float32)

    def step(params, stats, opt_state, batch):
        xyz, mask = batch["xyz"].astype(jnp.float32), batch["mask"].astype(jnp.float32)
        label = batch["label"].astype(jnp.int32)
        inputs = jnp.concatenate([batch["xyz"].astype(jnp.float32), batch["depth"].astype(jnp.float32)], axis=1)

        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, inputs, xyz, mask, train=True,
                                   mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
            pl = jsem.focal_loss(out, label, 2.0, cls_weight)
            return jsem.masked_seg_loss(pl, mask) * cfg.loss.cls_loss_coef, mut["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss, grads, optax.global_norm(grads)

    return tx, step


def port_model(dtype=torch.float32, use_crf=True):
    """SqueezeSegV2 + CAM (+ CRF) at its init (float32 draws); a float64 model computes in
    float64 (its policy dtype) on float64 copies of the same parameters."""
    model = SqueezeSegV2(("xyz", "depth"), 3, use_crf=use_crf, crf_kwargs=STEP_CRF if use_crf else None,
                         logit_bias=LOGIT_BIAS, dtype=dtype)
    return model.double() if dtype == torch.float64 else model


def test_float64_step_matches_jax():
    """Loss, gradients, updated parameters and running statistics <= 1e-8 of their largest
    magnitude; the transposed convs' weights move (the JAX chain has no mask)."""
    cfg = step_cfg()
    model = port_model(torch.float64)
    tree = to_flax(model)
    batch = step_batch()
    with enable_x64(), fixed_dropout_keys(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsqueezeseg, "jnp", _KeepFloat64())
        f64 = lambda tr: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tr)  # noqa: E731
        params, stats = f64(tree["params"]), f64(tree["batch_stats"])
        tx, step = jax_step(cfg, jnp.float64)
        opt_state = jax.jit(tx.init)(params)
        new_params, new_stats, _, loss, grads, _ = jax.jit(step)(params, stats, opt_state, batch)
        keep = keep_mask(B, 64)
    trainer = SemsegTrainer(model, cfg, "cpu")
    tb = {k: t(v) for k, v in batch.items()}
    tl, logit = trainer.forward_backward(tb, 1, keep=t(keep))
    assert logit.dtype == torch.float64
    got_grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    trainer.update(1)

    def check(ours, theirs, what):
        theirs = flat(theirs)
        assert ours.keys() == theirs.keys(), what
        big = max(np.abs(v).max() for v in theirs.values())
        err = max(np.abs(ours[k].detach().numpy() - theirs[k]).max() for k in ours)
        assert err <= 1e-8 * big, (what, err, big)

    assert abs(float(tl) - float(loss)) <= 1e-8 * abs(float(loss))
    check(got_grads, grads, "gradients")
    check(dict(trainer.model.named_parameters()), new_params, "parameters")
    stat_names = set(flat(new_stats))
    check({k: v for k, v in trainer.model.named_buffers() if k in stat_names}, new_stats, "running statistics")
    for name in ("fire10.upsample.weight", "fire13.upsample.weight"):
        before = flat(tree["params"])[name]
        assert not np.allclose(flat(new_params)[name], before)
        assert not np.allclose(trainer.model.get_parameter(name).detach().numpy(), before)


def test_float32_steps_across_a_decay_boundary_match_jax():
    """Steps 1-3 with lr_decay_steps 2 (lr 0.05, 0.05, 0.025) and the clip active (global
    norm far above 1), each from JAX's state: loss <= 1e-4 (relative), updated parameters
    <= 1e-4 of their largest magnitude; the momentum carries across steps. Without the CRF
    (the float64 step has it), to halve JAX's trace and compile."""
    cfg = step_cfg(lr_decay_steps=2, max_grad_norm=1.0)
    model = port_model(use_crf=False)
    tree = to_flax(model)
    trainer = SemsegTrainer(model, cfg, "cpu")
    params, stats = tree["params"], tree["batch_stats"]
    tx, step = jax_step(cfg, jnp.float32, use_crf=False)
    opt_state = jax.jit(tx.init)(params)
    assert [trainer.lr(s) for s in (1, 2, 3, 4, 5)] == [0.05, 0.05, 0.025, 0.025, 0.0125]
    with fixed_dropout_keys():
        fn = jax.jit(step)
        for s in (1, 2, 3):
            batch = step_batch(30 + s)
            # the port starts from JAX's state: parameters, statistics, momentum
            trainer.model.load_state_dict({k: t(v) for k, v in {**flat(params), **flat(stats)}.items()})
            if s > 1:
                trace = flat(opt_state[2][0].trace)
                for name, p in trainer.model.named_parameters():
                    trainer.opt.state[p]["momentum_buffer"] = t(trace[name])
            new_params, new_stats, new_opt, loss, _, norm = fn(params, stats, opt_state, batch)
            assert float(norm) > 10 * cfg.training.max_grad_norm
            tl, _ = trainer.forward_backward({k: t(v) for k, v in batch.items()}, s, keep=t(keep_mask(B, 64)))
            trainer.update(s)
            assert abs(float(tl) - float(loss)) <= 1e-4 * abs(float(loss)), (s, float(tl), float(loss))
            ref = flat(new_params)
            big = max(np.abs(v).max() for v in ref.values())
            err = max(np.abs(p.detach().numpy() - ref[n]).max() for n, p in trainer.model.named_parameters())
            assert err <= 1e-4 * big, (s, err, big)
            moved = flat(new_params)["fire13.upsample.weight"] - flat(params)["fire13.upsample.weight"]
            assert np.abs(moved).max() > 0
            params, stats, opt_state = new_params, new_stats, new_opt


def test_confusion_counts_match_the_host_and_jax():
    """confusion_device equals train_semseg's evaluate_confusion on the host and the JAX
    CLI's on-device counts; a label outside [0, C) counts for no class."""
    rng = np.random.RandomState(21)
    label = rng.randint(0, 4, (2, 8, 16))
    pred = rng.randint(0, 3, (2, 8, 16))
    got = confusion_device(t(label), t(pred), 3).numpy()
    host = np.stack(port_train_semseg.evaluate_confusion(label, pred, 3))
    jcli = _load_jax_cli("train_semseg")
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, np.asarray(jcli.confusion_device(label, pred, 3)))


# ------------------------------------------------------------------------- command lines


def _gta_frame(rng):
    f = _frontal_frame(rng)
    return np.concatenate([f[..., :3], f[..., 4:5], f[..., 5:6] % 3], axis=-1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """KITTI frontal frames (8 train, 4 val) and GTA frames with DUSty v2 drop maps at the
    training shape, in the release's layout (tests/test_semseg_e2e.py)."""
    root = tmp_path_factory.mktemp("kitti_raw_frontal_port")
    rng = np.random.RandomState(0)
    (root / "lidar_2d").mkdir()
    (root / "ImageSet").mkdir()
    names = [f"2011_09_26_drive_0001_{i:010d}" for i in range(12)]
    for n in names:
        np.save(root / "lidar_2d" / f"{n}.npy", _frontal_frame(rng))
    (root / "ImageSet" / "train.txt").write_text("\n".join(names[:8]) + "\n")
    (root / "ImageSet" / "val.txt").write_text("\n".join(names[8:]) + "\n")
    (root / "GTAV" / "seq0").mkdir(parents=True)
    (root / "GTAV_noise_v2" / "seq0").mkdir(parents=True)
    for i in range(8):
        np.save(root / "GTAV" / "seq0" / f"{i:06d}.npy", _gta_frame(rng))
        np.save(root / "GTAV_noise_v2" / "seq0" / f"{i:06d}.npy", rng.uniform(0.6, 1.0, SHAPE).astype(np.float32))
    return root


def write_cfg(path, root, inputs=("xyz", "depth"), max_steps=2, use_crf=True):
    cfg = yaml.safe_load(open(os.path.join(_REPO, "configs", "semseg", "sim2real_w_gan_noise_dustyv2.yaml")))
    cfg["arch"].update(inputs=list(inputs), use_crf=use_crf, pretrained_weights=False)
    cfg["dataset"].update(root=str(root), shape=list(SHAPE), upload_dtype="float16")
    cfg["training"].update(max_steps=max_steps, batch_size=B, checkpoint={"test": 2, "stats": 1, "image": 2})
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("semseg_port_run")
    cfg = write_cfg(tmp / "e2e.yaml", tree)
    trainer = port_train_semseg.main(["--config", str(cfg), "--log_dir", str(tmp / "logs"), "--num_workers", "2",
                                      "--device", "cpu"])
    return tmp, trainer


def test_train_writes_checkpoint_and_stats(trained):
    """Two steps of the f32 CRF config: a stats row per step, a validation row and one
    checkpoint at step 2 that loads equal to the trainer's final state."""
    tmp, trainer = trained
    rows = [json.loads(line) for line in (tmp / "logs" / "stats.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 2] and "val/iou/mean" in rows[-1]
    assert all(np.isfinite(r["train/loss"]) for r in rows[:2])
    ckpts = sorted((tmp / "logs" / "models").glob("*.ckpt"))
    assert [c.name for c in ckpts] == ["checkpoint_step-0000000002.ckpt"]
    cfg, payload = load_checkpoint(str(ckpts[0]))
    assert payload["step"] == 2 and cfg.dataset.shape == list(SHAPE)
    state = trainer.model.state_dict()
    assert set(payload["params"]) | set(payload["batch_stats"]) == set(state)
    assert "crf.label_compatibility" in payload["params"] and "conv1b.bn.running_mean" in payload["batch_stats"]
    for k, v in {**payload["params"], **payload["batch_stats"]}.items():
        assert torch.equal(v, state[k]), k


def test_eval_table_equals_the_jax_pipeline(trained, tree, tmp_path, capsys):
    """test_semseg --knn on the checkpoint: IoU / precision / recall equal (<= 1e-6) to JAX's
    test_semseg.py pipeline on the same weights and val frames (JAX build_model + apply,
    cyclist omitted, knn2d, evaluate_confusion)."""
    tmp, _ = trained
    ckpt = next((tmp / "logs" / "models").glob("*.ckpt"))
    out = tmp_path / "scores.json"
    scores, info = port_test_semseg.main(["--ckpt_path", str(ckpt), "--dataset_root", str(tree), "--batch_size", "4",
                                          "--knn", "--out", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == scores and info["frames"] == 4
    assert "mean" in capsys.readouterr().out

    cfg, payload = load_checkpoint(str(ckpt))
    model = port_train_semseg.build_model(cfg)
    model.load_state_dict({**payload["params"], **payload["batch_stats"]})
    variables = to_flax(model)
    jcli = _load_jax_cli("train_semseg")
    jmodel = jcli.build_model(JaxConfig(cfg.to_dict()))
    predict = jax.jit(lambda x, xyz, mask: jnp.argmax(jmodel.apply(variables, x, xyz, mask), axis=1))
    ds = JaxKITTIRawFrontal(root=str(tree), split="val", shape=SHAPE, omit_cyclist=True)
    items = [ds[i] for i in range(len(ds))]
    raw = {k: np.stack([it[k] for it in items]) for k in items[0]}
    pred = predict(jcli.make_inputs(raw, ("xyz", "depth")), raw["xyz"], raw["mask"])
    pred = jsem.knn2d(jnp.asarray(raw["depth"]), jnp.where(pred == 3, 0, pred), 3)
    conf = np.stack(jcli.evaluate_confusion(raw["label"] * raw["mask"], np.asarray(pred) * raw["mask"], 3))
    ref = port_test_semseg.scores_of(conf)
    for k in ("iou", "precision", "recall"):
        np.testing.assert_allclose(scores[k], ref[k], rtol=0, atol=1e-6)


def test_train_with_mask_input(tree, tmp_path):
    """[depth, mask] as the inputs (mask ships as a uint8 plane and is re-expanded): one step."""
    cfg = write_cfg(tmp_path / "mask.yaml", tree, inputs=("depth", "mask"), max_steps=1, use_crf=False)
    trainer = port_train_semseg.main(["--config", str(cfg), "--log_dir", str(tmp_path / "logs"), "--num_workers",
                                      "2", "--device", "cpu"])
    assert trainer.model.in_ch == 2 and sorted((tmp_path / "logs" / "models").glob("*.ckpt"))


@pytest.mark.parametrize("config", sorted(os.listdir(os.path.join(_REPO, "configs", "semseg"))))
def test_dry_run_matches_jax_cli(config, monkeypatch, capsys):
    path = os.path.join(_REPO, "configs", "semseg", config)
    assert port_train_semseg.main(["--config", path, "--dry_run"]) is None
    ours = capsys.readouterr().out
    jax_cli = _load_jax_cli("train_semseg")
    monkeypatch.setattr(sys, "argv", ["train_semseg.py", "--config", path, "--dry_run"])
    jax_cli.main()
    assert capsys.readouterr().out == ours


@pytest.mark.parametrize("arch", [{"pool_impl": "reduce_window"}, {"pool_impl": "shift"}, {"bn_one_pass": False}])
def test_build_model_raises_for_the_tpu_forms(arch):
    cfg = Config(yaml.safe_load(open(os.path.join(_REPO, "configs", "semseg", "sim2real_w_gan_noise_dustyv2.yaml"))))
    cfg.arch.update(arch)
    with pytest.raises(NotImplementedError, match=next(iter(arch))):
        port_train_semseg.build_model(cfg)


def test_entry_points_need_a_card_unless_told(trained, tree, tmp_path):
    tmp, _ = trained
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda"):
        port_train_semseg.main(["--config", str(tmp / "e2e.yaml"), "--log_dir", str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="cuda"):
        port_test_semseg.main(["--ckpt_path", str(next((tmp / "logs" / "models").glob("*.ckpt"))),
                               "--dataset_root", str(tree)])


def test_clis_import_no_jax():
    code = (
        "import sys\n"
        "import dusty_gan_v2_tpu_torch.cli.train_semseg, dusty_gan_v2_tpu_torch.cli.test_semseg\n"
        "import dusty_gan_v2_tpu_torch.semseg.train_step, dusty_gan_v2_tpu_torch.convert\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dusty_gan_v2_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
