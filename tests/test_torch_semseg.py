"""The port's semseg modules against the JAX package's, on the CPU.

Each port module gets the same weights as its JAX twin (the port's state_dict carried
into a flax variable tree) and the same numpy inputs. Tolerances are stated per test. The
JAX head keys its Dropout2d masks by the sample id (per_sample_keys); the tests replace
those keys with fixed ones, compute the same masks outside and inject them into the
port, which draws batch-wide otherwise.
"""

import contextlib

import jax
import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

import dusty_gan_v2_tpu.semseg as jsem
import dusty_gan_v2_tpu.semseg.common as jcommon
import dusty_gan_v2_tpu.semseg.datasets as jdatasets
from dusty_gan_v2_tpu.semseg.pretrained_init import apply_squeezenet_fire_weights as jax_apply_fire
from dusty_gan_v2_tpu_torch.convert import load_jax_squeezeseg
from dusty_gan_v2_tpu_torch.semseg import (
    CAM, CRFRNN, SqueezeSegV1, SqueezeSegV2, cross_entropy, focal_loss, knn2d, masked_seg_loss,
)
from dusty_gan_v2_tpu_torch.semseg import common as pcommon
from dusty_gan_v2_tpu_torch.semseg import datasets as pdatasets
from dusty_gan_v2_tpu_torch.semseg import pretrained_init as ppre
from dusty_gan_v2_tpu_torch.semseg.squeezeseg import FireV2

B, H, W = 4, 16, 64  # W must divide by 16 (three W-stride-2 pools after conv1a's stride 2)
CRF = dict(kernel_size=(3, 5), init_weight_smoothness=0.02, init_weight_appearance=0.1,
           theta_gamma=(0.9, 0.9, 0.6), theta_alpha=(0.9, 0.9, 0.6), theta_beta=(0.015, 0.015, 0.01), num_iters=3)
LOGIT_BIAS = (0.01, 0.33, 0.33)
KEEP_SEED = 7


def to_flax(module: torch.nn.Module):
    """The port module's state_dict as a flax {"params", "batch_stats"} tree of numpy arrays."""
    params = {n for n, _ in module.named_parameters()}
    out = {"params": {}, "batch_stats": {}}
    for key, value in module.state_dict().items():
        node = out["params" if key in params else "batch_stats"]
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value.detach().numpy().copy()
    return out


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        out.update(flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def fixed_keys(key, ids):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(KEEP_SEED), i))(ids)


@contextlib.contextmanager
def fixed_dropout_keys():
    """The JAX head's per-sample dropout keys replaced by fold_in(PRNGKey(KEEP_SEED), id)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcommon, "per_sample_keys", fixed_keys)
        yield


def keep_mask(n, ch, p=0.5):
    """The (n, ch, 1, 1) keep mask the JAX head draws under fixed_dropout_keys."""
    keys = fixed_keys(None, jnp.arange(n, dtype=jnp.uint32))
    return np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, 1.0 - p, (ch, 1, 1)))(keys))


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def randomize_bn_stats(model, rng):
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(t(rng.randn(*buf.shape).astype(np.float32) * 0.1))
            elif name.endswith("running_var"):
                buf.copy_(t(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))


def rel_err(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / max(np.abs(np.asarray(ref)).max(), 1e-30))


# ------------------------------------------------------------------------- modules


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(train):
    """Output, input and affine gradients, and the new running statistics <= 1e-5."""
    rng = np.random.RandomState(1)
    bn = pcommon.BatchNorm2d(5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(t(rng.uniform(0.5, 1.5, 5).astype(np.float32)))
        bn.bias.copy_(t(rng.randn(5).astype(np.float32)))
    randomize_bn_stats(bn, rng)
    x = (rng.randn(3, 5, 4, 6) * 2 + 1).astype(np.float32)
    r = rng.randn(3, 5, 4, 6).astype(np.float32)
    v = to_flax(bn)
    jbn = jcommon.BatchNorm2d(5, 0.1)

    def f(params, x):
        out, mut = jbn.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=train,
                             mutable=["batch_stats"])
        return jnp.sum(out * r), (out, mut["batch_stats"])

    (_, (out, stats)), (g_params, g_x) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(v["params"], x)
    xt = t(x).requires_grad_()
    yt = bn(xt, train=train)
    (yt * t(r)).sum().backward()
    assert rel_err(yt.detach(), out) <= 1e-5
    assert rel_err(xt.grad, g_x) <= 1e-5
    assert rel_err(bn.weight.grad, g_params["weight"]) <= 1e-5 and rel_err(bn.bias.grad, g_params["bias"]) <= 1e-5
    for k in ("running_mean", "running_var"):
        assert np.abs(getattr(bn, k).numpy() - np.asarray(stats[k])).max() <= 1e-5


# the five pool shapes of tests/test_semseg.py::TestImplReformulations
POOLS = [(7, (1, 1), 3), (3, (1, 2), 1), (3, (2, 2), 1), (2, (2, 2), 0), (4, (1, 3), 2)]


@pytest.mark.parametrize("k,stride,pad", POOLS)
def test_max_pool_values_and_tie_gradients(k, stride, pad):
    """Values bit-equal to torch's 2-D MaxPool2d and JAX's separable pool; on an input
    full of exact ties (post-ReLU zeros, small integers) the gradient equals jax.grad of
    the separable pool (<= 1e-6: it routes to the same elements)."""
    rng = np.random.RandomState(2)
    x = np.maximum(np.round(rng.randn(2, 5, 16, 33) * 2), 0).astype(np.float32)
    ref2d = torch.nn.functional.max_pool2d(t(x), k, stride, pad)
    xt = t(x).requires_grad_()
    got = pcommon.max_pool2d(xt, k, stride, pad)
    jx = jcommon.max_pool2d(jnp.asarray(x), k, stride, pad, impl="separable")
    np.testing.assert_array_equal(got.detach().numpy(), ref2d.numpy())
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(jx))
    r = rng.randn(*got.shape).astype(np.float32)
    (got * t(r)).sum().backward()
    gj = jax.grad(lambda a: jnp.sum(jcommon.max_pool2d(a, k, stride, pad, impl="separable") * r))(jnp.asarray(x))
    assert np.abs(xt.grad.numpy() - np.asarray(gj)).max() <= 1e-6
    if (k, stride) == (3, (1, 2)):
        # a 2-D pool routes tied windows elsewhere: the separable form is what matches
        x2 = t(x).requires_grad_()
        (torch.nn.functional.max_pool2d(x2, k, stride, pad) * t(r)).sum().backward()
        assert np.abs(x2.grad.numpy() - np.asarray(gj)).max() > 1e-3


@pytest.mark.parametrize("exclude_center", [True, False])
def test_unfold_neighbors_equals_jax(exclude_center):
    x = np.random.RandomState(16).randn(2, 3, 5, 7).astype(np.float32)
    ref = np.asarray(jcommon.unfold_neighbors(jnp.asarray(x), (3, 5), exclude_center))
    got = pcommon.unfold_neighbors(t(x), (3, 5), exclude_center).numpy()
    assert got.shape == (2, 3, 14 if exclude_center else 15, 35)
    np.testing.assert_array_equal(got, ref)


def test_deconv_matches_jax_dilated_form():
    """F.conv_transpose2d(stride (1,2), padding (0,1)) on the (I,O,1,4) weight equals JAX's
    flipped-kernel lhs_dilation convolution (<= 1e-5), on the bilinear init and on random
    weights; the inits are equal."""
    rng = np.random.RandomState(3)
    de = pcommon.DeconvReLU(5, 7)
    pcommon.reset_parameters(torch.nn.Sequential(de), torch.Generator().manual_seed(0))
    x = rng.randn(2, 5, 4, 9).astype(np.float32)
    jde = jcommon.DeconvReLU(5, 7)
    init = jde.init(jax.random.PRNGKey(0), x)
    np.testing.assert_array_equal(de.weight.detach().numpy(), np.asarray(init["params"]["weight"]))
    for weights in (None, rng.randn(5, 7, 1, 4).astype(np.float32)):
        if weights is not None:
            with torch.no_grad():
                de.weight.copy_(t(weights))
                de.bias.copy_(t(rng.randn(7).astype(np.float32)))
        got = de(t(x)).detach().numpy()
        ref = np.asarray(jde.apply({"params": to_flax(de)["params"]}, x))
        assert got.shape == (2, 7, 4, 18) and rel_err(got, ref) <= 1e-5


def test_head_conv_bias_init_and_injected_dropout():
    """The logit-bias init is -log((1-p)/p) as JAX's; train mode with JAX's keep masks
    injected and eval mode match JAX <= 1e-5."""
    rng = np.random.RandomState(4)
    head = pcommon.HeadConv(6, 3, 3, 0.5, kernel_init=pcommon.trunc_normal_init(0.1), bias_init_values=LOGIT_BIAS)
    pcommon.reset_parameters(torch.nn.Sequential(head), torch.Generator().manual_seed(0))
    x = rng.randn(B, 6, 8, 16).astype(np.float32)
    jhead = jcommon.HeadConv(6, 3, 3, 0.5, bias_init_values=LOGIT_BIAS)
    jinit = jhead.init(jax.random.PRNGKey(0), x)
    p = np.array(LOGIT_BIAS, np.float32)
    np.testing.assert_allclose(head.bias.detach().numpy(), np.asarray(jinit["params"]["bias"]), rtol=1e-6)
    np.testing.assert_allclose(head.bias.detach().numpy(), -np.log((1 - p) / p), rtol=1e-6)
    v = to_flax(head)
    with fixed_dropout_keys():
        ref = np.asarray(jhead.apply({"params": v["params"]}, x, train=True, rngs={"dropout": jax.random.PRNGKey(9)}))
    keep = keep_mask(B, 6)
    assert 0 < keep.sum() < keep.size
    got = head(t(x), train=True, keep=t(keep)).detach().numpy()
    assert rel_err(got, ref) <= 1e-5
    assert rel_err(head(t(x)).detach().numpy(), jhead.apply({"params": v["params"]}, x)) <= 1e-5
    with pytest.raises(ValueError):
        head(t(x), train=True)


def test_cam_matches_jax():
    """Output and input gradient <= 1e-5."""
    rng = np.random.RandomState(5)
    cam = CAM(32)
    pcommon.reset_parameters(cam, torch.Generator().manual_seed(0))
    x = rng.randn(2, 32, 8, 16).astype(np.float32)
    r = rng.randn(2, 32, 8, 16).astype(np.float32)
    jcam = jsem.CAM(32)
    out, gx = jax.value_and_grad(lambda a: jnp.sum(jcam.apply({"params": to_flax(cam)["params"]}, a) * r))(x)
    xt = t(x).requires_grad_()
    y = cam(xt)
    (y * t(r)).sum().backward()
    assert abs(float((y.detach() * t(r)).sum()) - float(out)) <= 1e-5 * abs(float(out))
    assert rel_err(xt.grad, gx) <= 1e-5


@pytest.mark.parametrize("up", [False, True])
def test_fire_v2_train_mode_matches_jax(up):
    """A train-mode FireV2 (decoder init std 0.1, BN on batch statistics, running
    statistics at their init): output and new running statistics <= 1e-5."""
    rng = np.random.RandomState(6)
    fire = FireV2(32, 8, 16, 16, 0.001, up=up, init_std=0.1)
    pcommon.reset_parameters(fire, torch.Generator().manual_seed(0))
    x = np.maximum(rng.randn(2, 32, 8, 16), 0).astype(np.float32)
    v = to_flax(fire)
    out, mut = jsem.squeezeseg.FireV2(32, 8, 16, 16, 0.001, up=up, init_std=0.1).apply(
        v, x, train=True, mutable=["batch_stats"])
    got = fire(t(x), train=True).detach().numpy()
    assert got.shape == (2, 32, 8, 32 if up else 16) and rel_err(got, out) <= 1e-5
    ref_stats = flat(mut["batch_stats"])
    for k, buf in fire.named_buffers():
        assert np.abs(buf.numpy() - ref_stats[k]).max() <= 1e-5, k


def test_crf_matches_jax():
    """CRF-as-RNN with the configs' per-class thetas on smooth xyz (so that the appearance
    kernel is neither 0 nor 1): output, unary and parameter gradients <= 1e-5."""
    rng = np.random.RandomState(7)
    crf = CRFRNN(3, **CRF)
    with torch.no_grad():
        for p in crf.parameters():
            p.add_(t(rng.randn(*p.shape).astype(np.float32) * 0.05))
    unary = (rng.randn(2, 3, 8, 32) * 2).astype(np.float32)
    xyz = np.cumsum(rng.randn(2, 3, 8, 32).astype(np.float32) * 0.01, axis=-1)
    mask = (rng.rand(2, 8, 32) > 0.2).astype(np.float32)
    r = rng.randn(2, 3, 8, 32).astype(np.float32)
    jcrf = jsem.CRFRNN(num_classes=3, **CRF)

    def f(params, u):
        return jnp.sum(jcrf.apply({"params": params}, u, xyz, mask) * r)

    out, (gp, gu) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(to_flax(crf)["params"], unary)
    ut = t(unary).requires_grad_()
    y = crf(ut, t(xyz), t(mask))
    (y * t(r)).sum().backward()
    assert abs(float((y.detach() * t(r)).sum()) - float(out)) <= 1e-5 * abs(float(out))
    ref = np.asarray(jcrf.apply({"params": to_flax(crf)["params"]}, unary, xyz, mask))
    assert rel_err(y.detach(), ref) <= 1e-5
    assert rel_err(ut.grad, gu) <= 1e-5
    for name, p in crf.named_parameters():
        assert rel_err(p.grad, gp[name]) <= 1e-5, name


@pytest.mark.parametrize("k,ks", [(3, 3), (3, 5), (5, 3), (5, 5)])
def test_knn_labels_equal_jax(k, ks):
    """Labels equal JAX's exactly on normalized depth with masked (negative) pixels, where
    whole windows tie at +inf."""
    rng = np.random.RandomState(8)
    raw = rng.uniform(2.0, 60.0, (2, 1, H, W)).astype(np.float32)
    raw[rng.rand(2, 1, H, W) < 0.2] = 0.0
    depth = (raw - 12.12) / 12.32  # the datasets' normalization: masked and near pixels < 0
    label = rng.randint(0, 3, (2, H, W)).astype(np.int32)
    ref = np.asarray(jsem.knn2d(jnp.asarray(depth), jnp.asarray(label), 3, k=k, kernel_size=(ks, ks)))
    got = knn2d(t(depth), t(label), 3, k=k, kernel_size=(ks, ks))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got.numpy() != label).any()


@pytest.mark.parametrize("kind,weighted", [("focal", False), ("focal", True), ("ce", False), ("ce", True)])
def test_losses_match_jax(kind, weighted):
    """Per-pixel loss, the masked mean and its logit gradient <= 1e-6 (relative)."""
    rng = np.random.RandomState(9)
    logit = (rng.randn(2, 3, 8, 16) * 3).astype(np.float32)
    label = rng.randint(0, 3, (2, 8, 16)).astype(np.int32)
    mask = (rng.rand(2, 8, 16) > 0.3).astype(np.float32)
    w = [0.33, 1.0, 3.5] if weighted else None

    def jloss(lg):
        pl = jsem.focal_loss(lg, label, 2.0, w) if kind == "focal" else jsem.cross_entropy(lg, label, w)
        return jsem.masked_seg_loss(pl, mask), pl

    (jm, jpl), jg = jax.value_and_grad(jloss, has_aux=True)(logit)
    lt = t(logit).requires_grad_()
    pl = focal_loss(lt, t(label), 2.0, w) if kind == "focal" else cross_entropy(lt, t(label), w)
    m = masked_seg_loss(pl, t(mask))
    m.backward()
    assert rel_err(pl.detach(), jpl) <= 1e-6
    assert abs(float(m.detach()) - float(jm)) <= 1e-6 * abs(float(jm))
    assert rel_err(lt.grad, jg) <= 1e-6


# ------------------------------------------------------------------------- the whole model


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(10)
    x = rng.randn(B, 4, H, W).astype(np.float32)
    return {"x": x, "xyz": x[:, :3].copy(), "mask": (rng.rand(B, H, W) > 0.2).astype(np.float32)}


def port_v2(use_crf, dtype=torch.float32, stats_seed=11):
    model = SqueezeSegV2(("xyz", "depth"), 3, use_crf=use_crf, crf_kwargs=CRF if use_crf else None,
                         logit_bias=LOGIT_BIAS, dtype=dtype)
    randomize_bn_stats(model, np.random.RandomState(stats_seed))
    return model


def jax_v2(use_crf, dtype=jnp.float32):
    return jsem.SqueezeSegV2(inputs=("xyz", "depth"), num_classes=3, use_crf=use_crf,
                             crf_kwargs=CRF if use_crf else None, logit_bias=LOGIT_BIAS, dtype=dtype)


def test_converter_matches_the_flax_tree(batch):
    """The port's state_dict, as a flax tree, has the JAX model's collections, paths and
    shapes; load_jax_squeezeseg carries it back bit for bit; a stray collection fails."""
    model = port_v2(True)
    tree = to_flax(model)
    shapes = jax.eval_shape(jax_v2(True).init, jax.random.PRNGKey(0), batch["x"], batch["xyz"], batch["mask"])
    ref = {k: tuple(v.shape) for k, v in flat(jax.tree_util.tree_map(lambda a: np.zeros(a.shape), dict(shapes))).items()}
    assert {k: tuple(v.shape) for k, v in flat(tree).items()} == ref
    fresh = SqueezeSegV2(("xyz", "depth"), 3, use_crf=True, crf_kwargs=CRF, logit_bias=LOGIT_BIAS, seed=5)
    load_jax_squeezeseg(fresh, tree)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    with pytest.raises(ValueError):
        load_jax_squeezeseg(fresh, {**tree, "intermediates": {}})


@pytest.mark.parametrize("use_crf", [False, True])
def test_v2_eval_forward_matches_jax(use_crf, batch):
    """Eval mode (running statistics random) on converted weights: logits <= 1e-4."""
    model = port_v2(use_crf)
    ref = np.asarray(jax.jit(jax_v2(use_crf).apply)(to_flax(model), batch["x"], batch["xyz"], batch["mask"]))
    with torch.no_grad():
        got = model(t(batch["x"]), t(batch["xyz"]), t(batch["mask"])).numpy()
    assert got.dtype == np.float32 and got.shape == (B, 3, H, W)
    assert np.abs(got - ref).max() <= 1e-4


def test_v2_train_forward_matches_jax(batch):
    """Train mode with the CRF on JAX's injected dropout masks, the running statistics at
    their init (train mode reads them only as the one-pass moments' centre). New running
    statistics <= 1e-5. Logits <= 1e-4, or twice the largest shift one ulp (up or down, in
    the input or in every weight) makes to JAX's own logits where that is larger: in
    float32 this BN stack at its init amplifies rounding (here the shifts are 1.2-2.6e-3 of
    logits up to ~19, and JAX eager against JAX jitted differs as much), where the float64
    step of test_torch_semseg_e2e.py agrees to ~1e-13."""
    model = SqueezeSegV2(("xyz", "depth"), 3, use_crf=True, crf_kwargs=CRF, logit_bias=LOGIT_BIAS)
    v = to_flax(model)
    jm = jax_v2(True)
    up = lambda a: np.nextafter(a, np.float32(np.inf))  # noqa: E731
    down = lambda a: np.nextafter(a, np.float32(-np.inf))  # noqa: E731
    with fixed_dropout_keys():
        fn = jax.jit(lambda v, x: jm.apply(v, x, batch["xyz"], batch["mask"], train=True, mutable=["batch_stats"],
                                           rngs={"dropout": jax.random.PRNGKey(0)}))
        ref, mut = fn(v, batch["x"])
        moved = [fn(v, up(batch["x"]))[0], fn(v, down(batch["x"]))[0]]
        moved += [fn({"params": jax.tree_util.tree_map(f, v["params"]), "batch_stats": v["batch_stats"]}, batch["x"])[0]
                  for f in (up, down)]
    got = model(t(batch["x"]), t(batch["xyz"]), t(batch["mask"]), train=True, keep=t(keep_mask(B, 64))).detach()
    ulp_shift = max(float(np.abs(np.asarray(m) - np.asarray(ref)).max()) for m in moved)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= max(1e-4, 2 * ulp_shift)
    ref_stats = flat(mut["batch_stats"])
    for k, buf in model.named_buffers():
        if k in ref_stats:
            assert np.abs(buf.numpy() - ref_stats[k]).max() <= 1e-5, k


def test_v1_forward_matches_jax(batch):
    """SqueezeSegV1 (no BN), eval mode: logits <= 1e-4."""
    model = SqueezeSegV1(("xyz", "depth"), 3)
    jm = jsem.SqueezeSegV1(inputs=("xyz", "depth"), num_classes=3)
    ref = np.asarray(jax.jit(jm.apply)(to_flax(model), batch["x"]))
    with torch.no_grad():
        got = model(t(batch["x"])).numpy()
    assert np.abs(got - ref).max() <= 1e-4


def calibrate_bn(model, x, xyz, mask):
    """Every BN's running statistics set to a batch's (one train-mode pass, momentum 1)."""
    bns = [m for m in model.modules() if isinstance(m, pcommon.BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.momentum = 1.0
        model(t(x), t(xyz), t(mask), train=True, keep=torch.ones((len(x), 64, 1, 1), dtype=torch.bool))
        for bn in bns:
            bn.momentum = 0.001


def test_bf16_policy_against_fp32(batch):
    """The bf16 policy (eval mode, CRF on) on the fp32 model's weights: master parameters
    stay float32 and the logits come back float32. At the init statistics the logits stay
    within 0.02 of the largest |logit| (the JAX package's own bar, tests/test_semseg.py::
    test_bf16_compute_policy; measured 0.002) and within 5e-2 in relative L2 (0.0008). With
    the statistics set to a batch's, bf16 rounding through the 26 BN layers at these weights
    moves the logits by ~0.5 in relative L2 in both frameworks (here the port 0.498, JAX's
    bf16 policy 0.491 against the same fp32 logits): the port's distance stays within a
    factor 2 of JAX's."""
    m32 = SqueezeSegV2(("xyz", "depth"), 3, use_crf=True, crf_kwargs=CRF, logit_bias=LOGIT_BIAS)
    m16 = SqueezeSegV2(("xyz", "depth"), 3, use_crf=True, crf_kwargs=CRF, logit_bias=LOGIT_BIAS, dtype=torch.bfloat16)
    args = (batch["x"], batch["xyz"], batch["mask"])

    def logits():
        m16.load_state_dict(m32.state_dict())
        with torch.no_grad():
            return m32(*map(t, args)), m16(*map(t, args))

    y32, y16 = logits()
    assert y16.dtype == torch.float32 and all(p.dtype == torch.float32 for p in m16.parameters())
    assert float((y16 - y32).abs().max()) <= 0.02 * float(y32.abs().max())
    assert float(torch.linalg.vector_norm(y16 - y32) / torch.linalg.vector_norm(y32)) <= 5e-2
    calibrate_bn(m32, batch["x"][::-1].copy(), batch["xyz"][::-1].copy(), batch["mask"])
    y32, y16 = logits()
    rel = float(torch.linalg.vector_norm(y16 - y32) / torch.linalg.vector_norm(y32))
    j16 = np.asarray(jax.jit(jax_v2(True, jnp.bfloat16).apply)(to_flax(m32), *args))
    jrel = float(np.linalg.norm(j16 - y32.numpy()) / np.linalg.norm(y32.numpy()))
    assert jrel / 2 <= rel <= 2 * jrel, (rel, jrel)


# ------------------------------------------------------------------------- datasets and init


def _frontal_frame(rng, H0=64, W0=512):
    depth = rng.uniform(2.0, 60.0, (H0, W0)).astype(np.float32)
    depth[rng.rand(H0, W0) < 0.15] = 0.0
    azim = np.linspace(np.pi / 4, -np.pi / 4, W0, dtype=np.float32)[None]
    elev = np.linspace(0.03, -0.4, H0, dtype=np.float32)[:, None]
    label = rng.randint(0, 4, (H0, W0)).astype(np.float32)
    label[depth == 0] = 0
    return np.stack([depth * np.cos(elev) * np.cos(azim), depth * np.cos(elev) * np.sin(azim),
                     depth * np.sin(elev), rng.rand(H0, W0).astype(np.float32), depth, label], -1).astype(np.float32)


@pytest.fixture(scope="module")
def frames_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_raw_frontal")
    rng = np.random.RandomState(12)
    (root / "lidar_2d").mkdir()
    (root / "ImageSet").mkdir()
    names = [f"2011_09_26_drive_0001_{i:010d}" for i in range(4)]
    for n in names:
        np.save(root / "lidar_2d" / f"{n}.npy", _frontal_frame(rng))
    (root / "ImageSet" / "train.txt").write_text("\n".join(names) + "\n")
    for d in ("GTAV/seq0", "GTAV_noise_v2/seq0"):
        (root / d).mkdir(parents=True)
    for i in range(4):
        f = _frontal_frame(rng)
        np.save(root / "GTAV" / "seq0" / f"{i:06d}.npy", np.concatenate([f[..., :3], f[..., 4:5], f[..., 5:6] % 3], -1))
        np.save(root / "GTAV_noise_v2" / "seq0" / f"{i:06d}.npy", rng.uniform(0.6, 1.0, (32, 256)).astype(np.float32))
    return root


@pytest.mark.parametrize("name", ["KITTIRawFrontal", "GTALiDAR", "GTALiDAR_GAN"])
def test_dataset_items_equal_jax(name, frames_root):
    """Items equal the JAX package's bit for bit after the same np.random.seed: random flip,
    omit_cyclist, a resize to (32, 256), the Bernoulli ray drop; and with cache='ram'."""
    shape = (32, 256)
    kw = dict(root=str(frames_root), shape=shape, flip=True)
    if name == "KITTIRawFrontal":
        kw.update(split="train", omit_cyclist=True)
    elif name == "GTALiDAR":
        kw.update(raydrop_p=np.random.RandomState(13).uniform(0.5, 1.0, shape).astype(np.float32))
    else:
        kw.update(gan_dir="GTAV_noise_v2")
    for cache in (None, "ram"):
        ours, theirs = getattr(pdatasets, name)(cache=cache, **kw), getattr(jdatasets, name)(cache=cache, **kw)
        assert len(ours) == len(theirs) == 4
        np.random.seed(14)
        got = [ours[i % 4] for i in range(8)]
        np.random.seed(14)
        ref = [theirs[i % 4] for i in range(8)]
        for a, b in zip(got, ref):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])
    assert ours.class_list == theirs.class_list


def test_fire_remap_equals_jax_and_the_loader_reads_local_files_only(tmp_path):
    """The synthetic pickle's 24 (weight, bias) pairs land where JAX's remap puts them;
    a missing file raises FileNotFoundError; a file is read with joblib and checked."""
    rng = np.random.RandomState(15)
    weights = {k: (rng.randn(*ws).astype(np.float32), rng.randn(*bs).astype(np.float32))
               for k, (ws, bs) in ppre.squeezenet_fire_shapes().items()}
    model = port_v2(False)
    before = flat(to_flax(model)["params"])
    ref = flat(jax_apply_fire(to_flax(model)["params"], weights))
    got = flat(to_flax(ppre.apply_squeezenet_fire_weights(model, weights))["params"])
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
    assert sum(not np.array_equal(got[k], before[k]) for k in got) == 48
    with pytest.raises(FileNotFoundError):
        ppre.load_squeezenet_v11(str(tmp_path / "absent.pkl"))
    path = tmp_path / "squeezenet_v1.1.pkl"
    joblib.dump(weights, path)
    loaded = ppre.load_squeezenet_v11(str(path))
    assert all(np.array_equal(loaded[k][0], weights[k][0]) for k in weights)
    joblib.dump({**weights, "fire2/squeeze1x1": (np.zeros((1, 1, 1, 1)), np.zeros(1))}, path)
    with pytest.raises(ValueError):
        ppre.load_squeezenet_v11(str(path))


def test_port_rule_covers_the_semseg_modules():
    """The no-JAX rule of test_torch_ops.py scans the whole package: this slice's files are in it."""
    from test_torch_ops import PORT_DIR, test_port_imports_no_jax

    names = {p.relative_to(PORT_DIR).as_posix() for p in PORT_DIR.rglob("*.py")}
    assert {"semseg/__init__.py", "semseg/common.py", "semseg/crf_as_rnn.py", "semseg/squeezeseg.py",
            "semseg/loss.py", "semseg/knn.py", "semseg/datasets.py", "semseg/pretrained_init.py",
            "semseg/train_step.py", "cli/train_semseg.py", "cli/test_semseg.py",
            "convert/jax_variables.py"} <= names
    test_port_imports_no_jax()
