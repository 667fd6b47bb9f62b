"""Checkpoints of the JAX package and of the reference implementation read by the port,
against the JAX package on the CPU.

- The JAX CLI's single-file checkpoint (dusty_gan_v2_tpu/training/checkpoint.py's
  save_checkpoint on tests/test_torch_gan_e2e.py's tiny config, its Adam moments, ADA
  state and PL baseline set to seeded values): G, G_ema and D read without a template
  give JAX `apply`'s outputs within 1e-4; read into a template, every tensor of the state
  comes across equal; `train_gan --resume` from it ends, bit for bit, where a resume from
  the port's own file of the same state ends; `save_jax_checkpoint` writes what JAX's
  load_checkpoint restores.
- Reference `.pth` state_dicts of every arch (dusty_v2 G with noise injection, dusty_v1
  and vanilla G, both D, SqueezeSeg v1 and v2), built from JAX variables through
  convert/torch_weights.py::reference_state_dict: JAX's convert_* gives the original tree
  back exactly, the port's converter loads them strictly, and the outputs match JAX
  `apply` within 1e-4; autoload_ckpt reads a reference GAN file, and a pickled OmegaConf
  config raises a clear error.
- A JAX CLI semseg checkpoint (train_semseg.py's msgpack) and a reference SqueezeSeg
  `.pth` reach the port's test_semseg with the scores of the port's own file.
"""

import json
import sys
import types

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dusty_gan_v2_tpu.convert import torch_weights as jtw
from dusty_gan_v2_tpu.models import build_discriminator as j_build_discriminator
from dusty_gan_v2_tpu.models import build_generator as j_build_generator
from dusty_gan_v2_tpu.parallel import make_mesh
from dusty_gan_v2_tpu.semseg import squeezeseg as jsem
from dusty_gan_v2_tpu.training import Trainer as JTrainer
from dusty_gan_v2_tpu.training.checkpoint import load_checkpoint as j_load_checkpoint
from dusty_gan_v2_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
from dusty_gan_v2_tpu.utils.config import Config as JConfig
from dusty_gan_v2_tpu_torch.cli import test_semseg as port_test_semseg
from dusty_gan_v2_tpu_torch.cli import train_gan as port_train_gan
from dusty_gan_v2_tpu_torch.cli.train_semseg import build_model as build_semseg_model
from dusty_gan_v2_tpu_torch.convert import (
    convert_discriminator_state, convert_generator_state, convert_squeezeseg_state, flatten_variables,
    load_jax_variables, reference_state_dict,
)
from dusty_gan_v2_tpu_torch.models import build_discriminator, build_generator
from dusty_gan_v2_tpu_torch.pretrained import autoload_ckpt
from dusty_gan_v2_tpu_torch.semseg import SqueezeSegV1, SqueezeSegV2
from dusty_gan_v2_tpu_torch.semseg.train_step import load_checkpoint as semseg_load_checkpoint
from dusty_gan_v2_tpu_torch.semseg.train_step import save_checkpoint as semseg_save_checkpoint
from dusty_gan_v2_tpu_torch.training import Trainer
from dusty_gan_v2_tpu_torch.training.checkpoint import (
    checkpoint_format, load_checkpoint, save_checkpoint, save_jax_checkpoint, state_payload,
)
from dusty_gan_v2_tpu_torch.utils.config import Config

from test_torch_gan_e2e import B, RES, _assert_equal_trees, kitti_root, tiny_cfg  # noqa: F401  (a fixture)
from test_torch_generator import SMALL_CFG, _seeded_variables
from test_torch_other_archs import RES_V, _g_cfg, _redraw
from test_torch_semseg import CRF, LOGIT_BIAS, to_flax
from test_torch_semseg_e2e import tree, write_cfg  # noqa: F401  (a fixture)
from test_trainer import make_angle


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ------------------------------------------------------------------ the JAX CLI's file
@pytest.fixture(scope="module")
def jax_ckpt(kitti_root, tmp_path_factory):  # noqa: F811
    """The JAX CLI's checkpoint of a state two iterations old on tests/test_torch_gan_e2e.py's
    config: the init's variables, seeded Adam moments (count 3), ADA and PL values."""
    cfg = JConfig(tiny_cfg(kitti_root))
    t = JTrainer(cfg, mesh=make_mesh(jax.devices()[:1]), angle=make_angle(RES))
    st = jax.jit(t.init_state)(jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)

    def moments(opt):
        adam = opt[0]
        mu = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32) * 1e-3, adam.mu)
        nu = jax.tree_util.tree_map(lambda a: rng.rand(*a.shape).astype(np.float32) * 1e-5, adam.nu)
        return (adam._replace(count=jnp.asarray(3, jnp.int32), mu=mu, nu=nu),) + tuple(opt[1:])

    st = st.replace(step=jnp.asarray(2, jnp.int32), opt_G=moments(st.opt_G), opt_D=moments(st.opt_D),
                    ada=st.ada._replace(p=jnp.float32(0.25), sign_cum=jnp.float32(0.5), n_pred_cum=jnp.float32(8.0)),
                    pl_ema=jnp.float32(0.125))
    path = tmp_path_factory.mktemp("jax_ckpt") / "checkpoint.ckpt"
    j_save_checkpoint(str(path), cfg, st, t.angle, num_imgs=2 * B)
    return path, _np(st), t


def test_jax_file_models_match_jax_apply(jax_ckpt):
    path, js, t = jax_ckpt
    assert checkpoint_format(str(path)) == "msgpack"
    cfg, state, angle, num_imgs = load_checkpoint(str(path))
    assert num_imgs == 2 * B and state["iteration"] == 2 and cfg.model.generator.arch == "dusty_v2"
    np.testing.assert_array_equal(angle.numpy(), np.asarray(t.angle))
    ck = autoload_ckpt(str(path), "cpu")
    rng = np.random.RandomState(1)
    z = rng.randn(3, 16).astype(np.float32)
    u = np.clip(rng.rand(3, 1, *RES), 1e-6, 1 - 1e-6)
    gumbel = (np.log(u) - np.log1p(-u)).astype(np.float32)
    g_apply = jax.jit(lambda v, z, n: t.G.apply(v, z, t.angle, truncation_psi=0.7, gumbel_noise=n))
    for name, params, stats in (("G", js.params_G, js.stats_G), ("G_ema", js.params_G_ema, js.stats_G_ema)):
        v = {"params": params, "stats": stats, "consts": js.consts_G}
        assert set(state[name]) == set(flatten_variables(v))
        for k, a in flatten_variables(v).items():
            np.testing.assert_array_equal(state[name][k].numpy(), a, err_msg=k)
        ref = g_apply(v, z, gumbel)
        with torch.no_grad():
            got = ck[name](_t(z), ck["angle"], truncation_psi=0.7, gumbel_noise=_t(gumbel))
        for k in ("image_orig", "raydrop_logit"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-4, err_msg=(name, k))
    x = np.tanh(rng.randn(4, 1, *RES)).astype(np.float32)
    ref = jax.jit(t.D.apply)({"params": js.params_D}, x)
    with torch.no_grad():
        got = ck["D"](_t(x), blur_fuse=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_jax_file_state_comes_across_equal(jax_ckpt):
    path, js, t = jax_ckpt
    cfg, _, angle, _ = load_checkpoint(str(path))
    tr = Trainer(cfg.to_dict(), device="cpu", angle=angle)
    st = load_checkpoint(str(path), tr.init_state(seed=9))[1]
    assert st.step == 2 and float(st.pl_ema) == 0.125
    assert (float(st.ada.p), float(st.ada.sign_cum), float(st.ada.n_pred_cum)) == (0.25, 0.5, 8.0)
    for opt, net, jopt in ((st.opt_G, st.G, js.opt_G), (st.opt_D, st.D, js.opt_D)):
        mu, nu = flatten_variables({"params": jopt[0].mu}), flatten_variables({"params": jopt[0].nu})
        for k, p in net.named_parameters():
            s = opt.state[p]
            assert float(s["step"]) == 3.0
            np.testing.assert_array_equal(s["exp_avg"].numpy(), mu[k], err_msg=k)
            np.testing.assert_array_equal(s["exp_avg_sq"].numpy(), nu[k], err_msg=k)


def test_save_jax_checkpoint_round_trips_through_jax(jax_ckpt, tmp_path):
    """The port writes the JAX CLI's format: JAX's load_checkpoint restores it into its
    template, every leaf equal to the state the port read from JAX's own file."""
    path, js, t = jax_ckpt
    cfg, _, angle, num_imgs = load_checkpoint(str(path))
    st = load_checkpoint(str(path), Trainer(cfg.to_dict(), device="cpu", angle=angle).init_state(seed=9))[1]
    out = tmp_path / "port_written.ckpt"
    save_jax_checkpoint(str(out), cfg, st, angle, num_imgs)
    jcfg, jstate, jangle, jn = j_load_checkpoint(str(out), js)  # js: a GANTrainState, the template's structure
    assert jn == num_imgs and jcfg.to_dict() == cfg.to_dict()
    np.testing.assert_array_equal(np.asarray(jangle), np.asarray(t.angle))
    got, ref = jax.tree_util.tree_leaves_with_path(_np(jstate)), dict(jax.tree_util.tree_leaves_with_path(js))
    assert len(got) == len(ref)
    for p, a in got:
        np.testing.assert_array_equal(a, ref[p], err_msg=jax.tree_util.keystr(p))
    # the bytes JAX's own save_checkpoint writes for what it restored
    again = tmp_path / "jax_written.ckpt"
    j_save_checkpoint(str(again), jcfg, jstate, jangle, jn)
    assert again.read_bytes() == out.read_bytes()


def test_resume_from_the_jax_file(jax_ckpt, kitti_root, tmp_path):  # noqa: F811
    """train_gan --resume from the JAX file runs iterations 3-4 and ends where a resume from
    the port's own file of the state it read ends, bit for bit."""
    path, _, _ = jax_ckpt
    cfg, _, angle, num_imgs = load_checkpoint(str(path))
    st = load_checkpoint(str(path), Trainer(cfg.to_dict(), device="cpu", angle=angle).init_state(seed=9))[1]
    own = tmp_path / "own.ckpt"
    save_checkpoint(str(own), cfg, st, angle, num_imgs)
    assert checkpoint_format(str(own)) == "torch"
    cfg_path = tmp_path / "gan.yaml"
    cfg_path.write_text(yaml.safe_dump(tiny_cfg(kitti_root)))
    ends = {}
    for name, ck in (("jax", path), ("own", own)):
        _, state = port_train_gan.main(["--config", str(cfg_path), "--num_workers", "2", "--device", "cpu",
                                        "--log_dir", str(tmp_path / name), "--resume", str(ck)])
        rows = [json.loads(line) for line in (tmp_path / name / "stats.jsonl").read_text().splitlines()]
        assert [r["iteration"] for r in rows] == [3, 4] and state.step == 4
        ends[name] = state_payload(state)
    _assert_equal_trees(ends["jax"], ends["own"], "state")


# ------------------------------------------------------------------ reference state_dicts
def _assert_trees_equal(got, ref, where=""):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), (where, sorted(got), sorted(ref))
        for k in ref:
            _assert_trees_equal(got[k], ref[k], f"{where}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=where)
        assert np.asarray(got).shape == np.asarray(ref).shape, where


NOISE_CFG = {**SMALL_CFG, "synthesis_kwargs": {**SMALL_CFG["synthesis_kwargs"], "use_noise": True}}
D_CFGS = {"dusty_v2": {"arch": "dusty_v2", "layer_kwargs": {"in_ch": 1, "ring": True, "ch_base": 4, "ch_max": 16,
                                                            "resolution": (8, 64), "mbdis_group": 4, "mbdis_feat": 1,
                                                            "pre_blur": True}},
          "vanilla": {"arch": "vanilla", "layer_kwargs": {"in_ch": 1, "ring": True, "ch_base": 8, "ch_max": 64,
                                                          "resolution": RES_V}}}


@pytest.mark.parametrize("arch", ["dusty_v2", "dusty_v1", "vanilla"])
def test_reference_generator_state(arch):
    """dusty_v2 with noise injection (its noise weights non-zero), dusty_v1 and vanilla."""
    rng = np.random.RandomState(2)
    if arch == "dusty_v2":
        cfg, res, z_dim = NOISE_CFG, SMALL_CFG["synthesis_kwargs"]["resolution"], 16
        angle = make_angle(res)
        jG = j_build_generator(cfg)
        v = _seeded_variables(jG, angle, seed=0)
    else:
        cfg, res, z_dim, angle = _g_cfg(arch, True), RES_V, 64, None
        jG = j_build_generator(cfg)
        init = jax.jit(lambda a: jG.init({"params": jax.random.PRNGKey(1), "gumbel": jax.random.PRNGKey(2)}, a))
        v = _np(_redraw(init(np.zeros((2, 64), np.float32)), seed=2))
    port = load_jax_variables(build_generator(cfg, device="cpu"), v)
    ref = reference_state_dict(port.state_dict(), "G", arch)
    assert all(not k.startswith(("synthesis_network.b", "mapping_network.fc")) for k in ref)
    p, s, c = jtw.convert_generator_state(ref, arch)
    _assert_trees_equal({k: x for k, x in (("params", p), ("stats", s), ("consts", c)) if x}, v)
    G = build_generator(cfg, device="cpu", seed=7)
    G.load_state_dict(convert_generator_state(ref, arch), strict=True)
    z = rng.randn(3, z_dim).astype(np.float32)
    gumbel = rng.logistic(size=(3, 1, *res)).astype(np.float32)
    kw = {"truncation_psi": 0.7, "gumbel_noise": gumbel}
    if arch == "dusty_v2":
        maps = [[rng.randn(1, 1, *m.shape[-2:]).astype(np.float32) for m in b]
                for b in G.synthesis_network.draw_noise(type("S", (), {"normal": lambda self, s: torch.zeros(1, *s)})())]
        ref_o = jax.jit(lambda v: jG.apply(v, z, angle, fixed_noise=maps, **kw))(v)
        with torch.no_grad():
            got = G(_t(z), _t(angle), noise=[[_t(m) for m in b] for b in maps], truncation_psi=0.7,
                    gumbel_noise=_t(gumbel))
        keys = ("image_orig", "raydrop_logit")
    else:
        ref_o = jax.jit(lambda v: jG.apply(v, z, **kw))(v)
        with torch.no_grad():
            got = G(_t(z), truncation_psi=0.7, gumbel_noise=_t(gumbel))
        keys = ("image",) + (("raydrop_logit",) if arch == "dusty_v1" else ())
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref_o[k]), rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", ["dusty_v2", "vanilla"])
def test_reference_discriminator_state(arch):
    cfg = D_CFGS[arch]
    res = cfg["layer_kwargs"]["resolution"]
    jD = j_build_discriminator(cfg)
    x = np.tanh(np.random.RandomState(3).randn(4, 1, *res)).astype(np.float32)
    v = _np(_redraw(jax.jit(jD.init)(jax.random.PRNGKey(2), x), seed=4))
    port = load_jax_variables(build_discriminator(cfg, device="cpu"), v)
    ref = reference_state_dict(port.state_dict(), "D", arch)
    _assert_trees_equal({"params": jtw.convert_discriminator_state(ref, arch)}, v)
    D = build_discriminator(cfg, device="cpu", seed=7)
    D.load_state_dict(convert_discriminator_state(ref, arch), strict=True)
    with torch.no_grad():
        got = D(_t(x), blur_fuse=False).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jD.apply)(v, x)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["squeezeseg_v1", "squeezeseg_v2"])
def test_reference_squeezeseg_state(arch):
    """From a port model's init (BN statistics redrawn) as the flax tree: JAX's converter
    gives it back; the port's converter loads strictly; logits as JAX `apply`'s."""
    rng = np.random.RandomState(4)
    if arch == "squeezeseg_v2":
        model = SqueezeSegV2(("xyz", "depth"), 3, use_crf=True, crf_kwargs=CRF, logit_bias=LOGIT_BIAS)
        jm = jsem.SqueezeSegV2(inputs=("xyz", "depth"), num_classes=3, use_crf=True, crf_kwargs=CRF,
                               logit_bias=LOGIT_BIAS)
        with torch.no_grad():
            for k, b in model.named_buffers():
                b.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, b.shape).astype(np.float32)) if "var" in k
                        else torch.from_numpy(rng.randn(*b.shape).astype(np.float32) * 0.1))
    else:
        model, jm = SqueezeSegV1(("xyz", "depth"), 3), jsem.SqueezeSegV1(inputs=("xyz", "depth"), num_classes=3)
    v = to_flax(model)
    ref = reference_state_dict(model.state_dict(), "squeezeseg", arch)
    p, s = jtw.convert_squeezeseg_state(ref, arch)
    _assert_trees_equal({"params": p, "batch_stats": s}, {k: x for k, x in v.items()})
    params, stats = convert_squeezeseg_state(ref, arch)
    fresh = (SqueezeSegV2(("xyz", "depth"), 3, use_crf=True, crf_kwargs=CRF, logit_bias=LOGIT_BIAS, seed=9)
             if arch == "squeezeseg_v2" else SqueezeSegV1(("xyz", "depth"), 3, seed=9))
    fresh.load_state_dict({**params, **stats}, strict=True)
    x = rng.randn(2, 4, 16, 64).astype(np.float32)
    mask = (rng.rand(2, 16, 64) > 0.2).astype(np.float32)
    if arch == "squeezeseg_v2":
        refo = jax.jit(jm.apply)(v, x, x[:, :3], mask)
        with torch.no_grad():
            got = fresh(_t(x), _t(x[:, :3]), _t(mask))
    else:
        refo = jax.jit(jm.apply)(v, x)
        with torch.no_grad():
            got = fresh(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(refo), rtol=1e-4, atol=1e-4)


def test_autoload_reads_a_reference_file_and_refuses_omegaconf(tmp_path, monkeypatch):
    """A reference GAN `.pth` (cfg as a dict, G / G_ema / D in the reference's keys) loads
    through autoload_ckpt to the same weights; one whose cfg is a pickled OmegaConf
    object raises ValueError naming OmegaConf (nothing unpickled in full)."""
    G = build_generator(NOISE_CFG, device="cpu", seed=3)
    with torch.no_grad():
        for k, prm in G.named_parameters():
            if ".noise" in k:
                prm.normal_(0.0, 0.1)
    D = build_discriminator(D_CFGS["dusty_v2"], device="cpu", seed=4)
    cfg = {"model": {"generator": NOISE_CFG, "discriminator": D_CFGS["dusty_v2"]}, "dataset": {"min_depth": 1.45}}
    cfg = json.loads(json.dumps(cfg))  # tuples as lists, as a saved config holds them
    angle = torch.from_numpy(np.array(make_angle(RES)))
    sd = {"G": reference_state_dict(G.state_dict(), "G", "dusty_v2"), "D": reference_state_dict(D.state_dict(), "D", "dusty_v2")}
    path = tmp_path / "ref.pth"
    torch.save({"cfg": cfg, "angle": angle, "G_ema": sd["G"], **sd}, path)
    ck = autoload_ckpt(str(path), "cpu")
    assert ck["step"] is None and torch.equal(ck["angle"], angle.float())
    for name, net in (("G", G), ("G_ema", G), ("D", D)):
        _assert_equal_trees(ck[name].state_dict(), net.state_dict(), name)

    omegaconf = types.ModuleType("omegaconf")
    dictconfig = types.ModuleType("omegaconf.dictconfig")

    class DictConfig(dict):
        pass

    DictConfig.__module__, DictConfig.__qualname__ = "omegaconf.dictconfig", "DictConfig"
    dictconfig.DictConfig = DictConfig
    monkeypatch.setitem(sys.modules, "omegaconf", omegaconf)
    monkeypatch.setitem(sys.modules, "omegaconf.dictconfig", dictconfig)
    bad = tmp_path / "omegaconf.pth"
    torch.save({"cfg": DictConfig(cfg), "angle": angle, **sd}, bad)
    with pytest.raises(ValueError, match="OmegaConf"):
        autoload_ckpt(str(bad), "cpu")


# ------------------------------------------------------------------ semseg
def test_semseg_checkpoints_reach_test_semseg(tree, tmp_path):  # noqa: F811
    """The same SqueezeSegV2 weights as the port's own file, the JAX CLI's msgpack file
    (train_semseg.py's payload, written with flax) and a reference `.pth`: the loader
    gives equal state_dicts, and test_semseg --knn the same scores."""
    cfg_path = write_cfg(tmp_path / "e2e.yaml", tree)
    cfg = Config(yaml.safe_load(cfg_path.read_text()))
    model = build_semseg_model(cfg)
    rng = np.random.RandomState(6)
    with torch.no_grad():
        for k, b in model.named_buffers():
            if k.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, b.shape).astype(np.float32)))
    files = {"port": tmp_path / "port.ckpt", "jax": tmp_path / "jax.ckpt", "reference": tmp_path / "ref.pth"}
    semseg_save_checkpoint(str(files["port"]), cfg, model, 2)
    v = to_flax(model)
    files["jax"].write_bytes(flax.serialization.msgpack_serialize({
        "cfg_yaml": json.dumps(cfg.to_dict()), "step": np.int64(2), "params": v["params"],
        "batch_stats": v["batch_stats"]}))
    torch.save({"cfg": cfg.to_dict(), "model": reference_state_dict(model.state_dict(), "squeezeseg", "squeezeseg_v2")},
               files["reference"])
    scores = {}
    for name, path in files.items():
        got_cfg, payload = semseg_load_checkpoint(str(path))
        assert got_cfg.to_dict() == cfg.to_dict(), name
        _assert_equal_trees({**payload["params"], **payload["batch_stats"]}, model.state_dict(), name)
        scores[name], _ = port_test_semseg.main(["--ckpt_path", str(path), "--dataset_root", str(tree), "--batch_size",
                                                 "4", "--knn", "--device", "cpu"])
    assert scores["jax"] == scores["port"] == scores["reference"]
