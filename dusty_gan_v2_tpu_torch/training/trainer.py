"""The GAN training step: G adversarial, lazy path-length regularization, D adversarial,
lazy R1, EMA and the ADA controller, with the warmup schedule.

Counterpart of dusty_gan_v2_tpu/training/trainer.py. The JAX step is one jitted pure
function of a state pytree; here `Trainer.step` runs the same phases eagerly on the live
modules of a `TrainState`, in the JAX step's order, each phase a method of its own so
that a caller can compare one phase's loss and gradients before the optimizer:

    g_phase   z -> G (train) -> warmup -> ADA -> D -> w_gan * G loss; gradients on G
    pl_phase  z -> w (G, eval) -> G (train, input_w) -> path lengths |d sum(img * noise) / dw|
              -> w_pl * mean((len - pl_ema)^2), a double backward; gradients on G, which
              takes a second Adam step in the iteration
    d_phase   G (train, no autograd; its buffers still update) -> reals ++ fakes through
              warmup + ADA as one batch -> D on each half -> w_gan * D loss; on D
    r1_phase  (w_gp / 2) * R1 with warmup + ADA inside D's input; on D
    ema_phase EMA of G's parameters, a copy of its buffers; ADA's p update

Adam is torch.optim.Adam with lr * c and betas ** c, c = lazy / (lazy + 1) for the
network whose regularizer runs lazily, as optax's adam in the JAX step. Every random draw
comes from a stream (parallel/persample.py), in the JAX step's order: batch-wide from
the trainer's torch.Generator, re-seeded at each step with fold_seed(seed, iteration) as
the JAX step folds the iteration into its run key, or replayed from given arrays
(`draws`).

`g_phase_loss`, `d_phase_loss` and `r1_penalty` are the D-side losses as plain functions
of a discriminator and image batches. Every D call takes the unfused route
(blur_fuse=False), as every training call of the JAX step does: on the card that is the
route of the fused chain kernels.

Every arch pair of configs/gans/*.yaml trains: what a generator forward draws and caches
follows its arch, as in the JAX step (dusty_v2: the azimuth shift with aug_coords, the
logistic ray-drop noise and the Fourier-PE cache; dusty_v1: the noise; vanilla:
nothing). A single-style generator's path lengths are (B, 1).

Data parallelism (parallel/mesh.py): with a process group bound, the config's batch_size
is the global batch and each rank steps on its B_local = batch_size / world rows. The
step's draws are the global batch's rows (every rank draws them all and keeps its own),
the models' statistics (ModConv's ema_var, w_avg, minibatch-stddev, ADA's sums) are the
global batch's, each phase's gradients are averaged over the ranks in one flat
collective before its Adam step, as the JAX step pmeans them, and so are PL's mean
length and the returned metrics. Two processes on halves of a global batch take the
step one process takes on all of it. training/checkpoint.py and
training/accumulation.py hold the checkpoint and gradient accumulation.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..augment.ada import AdaptiveAugment
from ..models import build_discriminator, build_generator, build_pe_cache
from ..models.loss import gan_loss_d, gan_loss_g
from ..ops.pad import filter2d
from ..parallel.mesh import bound, local_batch, pmean_, pmean_grads_, rank, world_size
from ..parallel.persample import PerSampleStream, fold_seed
from ..utils import resolve_device, sigmoid_to_tanh
from .train_state import TrainState

__all__ = [
    "g_phase_loss", "d_phase_loss", "r1_penalty", "fetch_reals", "warmup_fn", "make_blur_kernel", "Schedule",
    "Trainer",
]


def g_phase_loss(
    D: nn.Module, x_fake: torch.Tensor, metric: str = "nsgan", x_real: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The generator's adversarial loss on D's logits. Gradients flow to `x_fake` (and
    on to the generator that made it); `x_real`, which only the relativistic objectives
    read, is detached."""
    y_fake = D(x_fake, blur_fuse=False)
    y_real = None if x_real is None else D(x_real.detach(), blur_fuse=False)
    return gan_loss_g(y_real, y_fake, metric)


def d_phase_loss(D: nn.Module, x_real: torch.Tensor, x_fake: torch.Tensor, metric: str = "nsgan") -> torch.Tensor:
    """The discriminator's adversarial loss. Reals and fakes go through D separately:
    the minibatch-stddev statistic must not mix them. Both inputs are detached."""
    y_real = D(x_real.detach(), blur_fuse=False)
    y_fake = D(x_fake.detach(), blur_fuse=False)
    return gan_loss_d(y_real, y_fake, metric)


def r1_penalty(
    D: nn.Module, x_real: torch.Tensor, augment: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
) -> torch.Tensor:
    """mean_b sum_chw (d sum(D(augment(x))) / dx)^2 on real images, built with
    create_graph so that its gradient with respect to D's parameters is a double
    backward through D (and through `augment`, when given)."""
    x = x_real.detach().requires_grad_(True)
    xx = x if augment is None else augment(x)
    (g,) = torch.autograd.grad(D(xx, blur_fuse=False).sum(), x, create_graph=True)
    return g.square().sum(dim=(1, 2, 3)).mean()


def fetch_reals(batch: Dict[str, Any], min_depth: float, max_depth: float, raydrop_const: float, device=None):
    """Depth in metres (+ mask) -> tanh-scaled inverse-depth image with dropped rays
    filled. Without a mask, mask = (depth > 0) (the loader zeroes every channel outside
    it); depth may come as float16. Returns {"image", "raydrop_mask"}, float32."""
    depth = torch.as_tensor(batch["depth"], device=device).float()
    mask = torch.as_tensor(batch["mask"], device=depth.device).float() if "mask" in batch else (depth > 0.0).float()
    valid = ((depth >= min_depth) & (depth <= max_depth) & (depth > 0.0)).float()
    inv_norm = min_depth / torch.where(valid > 0, depth, torch.ones_like(depth)) * valid
    x = sigmoid_to_tanh(inv_norm)
    return {"image": mask * x + (1.0 - mask) * raydrop_const, "raydrop_mask": mask}


def warmup_fn(x: torch.Tensor, stream, dropout_ratio: float, raydrop_const: float, blur_kernel=None) -> torch.Tensor:
    """Warmup: optional gaussian blur (ops/pad.py::filter2d), then input dropout: each
    element is kept with probability 1 - dropout_ratio (one per-sample Bernoulli draw
    from `stream`, whose batch must be x's) and set to raydrop_const otherwise."""
    if stream.n is not None and stream.n != x.shape[0]:
        raise ValueError(f"stream draws for {stream.n} samples, the batch has {x.shape[0]}")
    if blur_kernel is not None:
        x = filter2d(x, blur_kernel)
    keep_p = float(np.float32(1.0) - np.float32(dropout_ratio))  # the JAX step's float32 threshold
    keep = stream.bernoulli(keep_p, tuple(x.shape[1:])).to(x.device, x.dtype)
    return keep * x + (1.0 - keep) * raydrop_const


def make_blur_kernel(blur_sigma: float, blur_init_sigma: float) -> Optional[np.ndarray]:
    """Fixed-size gaussian kernel (its length from the initial sigma); taps beyond the
    current 3 sigma are zero. None without a blur."""
    max_size = int(np.floor(blur_init_sigma * 3))
    if max_size <= 0:
        return None
    t = np.arange(-max_size, max_size + 1, dtype=np.float32)
    if blur_sigma <= 0:
        return (t == 0).astype(np.float32)
    size = int(np.floor(blur_sigma * 3))
    k = np.exp2(-((t / blur_sigma) ** 2))
    k[np.abs(t) > size] = 0.0
    return k


def _zero_fill_grads(net: nn.Module) -> None:
    """A zero gradient where a loss does not reach a parameter (R1 does not reach the last
    biases): Adam then counts the step for every parameter and decays its moments, as
    optax does with the zeros jax.grad returns, instead of skipping it."""
    for p in net.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)


class Schedule(NamedTuple):
    """What one iteration runs: its warmup, its lazy regularizers and its EMA decay."""

    dropout_ratio: float
    blur_kernel: Optional[np.ndarray]
    skip_warmup: bool  # warmup has faded: the warmup op is the identity and draws nothing
    do_pl: bool
    do_r1: bool
    do_ada: bool
    ema_decay: float


class Trainer:
    """Builds the models and optimizers from a config and runs the training step.

        trainer = Trainer(full_train_cfg(bf16=True))           # CUDA by default
        state = trainer.init_state(seed=0)
        metrics = trainer.step(state, {"depth": depth}, iteration)

    `cfg` is the JAX package's schema as nested dicts, the "dataset", "training" and
    "model" sections of configs/gans/*.yaml (sampling.py::full_train_cfg). `angle` is the
    (1, 2, H, W) laser-angle grid (default: the dataset's LUT at the model's
    resolution); the step's draws come from the trainer's torch.Generator, seeded at
    each step with fold_seed(seed, iteration). `batch_size` is the config's, the global
    batch; `B_local` is this rank's share of it."""

    def __init__(self, cfg: Dict[str, Any], device="cuda", angle: Optional[torch.Tensor] = None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        tr, ds = cfg["training"], cfg["dataset"]
        g_cfg = cfg["model"]["generator"]
        self.resolution = tuple(g_cfg["synthesis_kwargs"]["resolution"])
        # the single-style archs map z by the identity: z is the synthesis input
        self.z_dim = g_cfg["mapping_kwargs" if "mapping_kwargs" in g_cfg else "synthesis_kwargs"]["in_ch"]
        self.batch_size = int(tr["batch_size"])

        aug = tr["augment"]
        self.ada = AdaptiveAugment(p_init=aug["p_init"], p_target=aug["p_target"], kimg=aug["kimg"], **aug["policy"])

        loss, lazy = tr["loss"], tr["lazy"]
        self.w_gan = float(loss["gan"])
        self.lazy_gp, self.lazy_pl, self.lazy_ada = int(lazy["gp"]), int(lazy["pl"]), int(lazy["ada"])
        self.w_gp = float(loss["gp"]) * self.lazy_gp if loss.get("gp", 0) > 0 else 0.0
        self.w_pl = float(loss["pl"]) * self.lazy_pl if loss.get("pl", 0) > 0 else 0.0
        c_G = self.lazy_pl / (self.lazy_pl + 1.0) if self.w_pl > 0 else 1.0
        c_D = self.lazy_gp / (self.lazy_gp + 1.0) if self.w_gp > 0 else 1.0
        self.adam_G = self._adam_kwargs(tr["lr"]["generator"], c_G)
        self.adam_D = self._adam_kwargs(tr["lr"]["discriminator"], c_D)

        self.gan_objective = tr["gan_objective"]
        self.use_real_in_g = self.gan_objective in ("ragan", "rahinge", "ralsgan")
        self.raydrop_const = float(ds["raydrop_const"])
        self.min_depth, self.max_depth = float(ds["min_depth"]), float(ds["max_depth"])
        wu = tr["warmup"]
        self.warmup_fade_imgs = float(wu["fade_kimg"]) * 1e3
        self.blur_init_sigma = float(wu["blur_init_sigma"])
        self.dropout_init_ratio = float(wu["dropout_init_ratio"])

        if angle is None:
            from ..sampling import load_angle

            if ds["name"] != "kitti_raw":
                raise ValueError(f"no angle LUT for dataset {ds['name']!r}; pass angle")
            angle = load_angle(self.resolution, self.device)
        self.angle = angle.to(self.device)
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(fold_seed(self.seed))
        self._pe_cache = None

    @staticmethod
    def _adam_kwargs(lr_cfg, c: float) -> Dict[str, Any]:
        return {"lr": lr_cfg["alpha"] * c, "betas": (lr_cfg["beta1"] ** c, lr_cfg["beta2"] ** c), "eps": 1e-8}

    # ------------------------------------------------------------------ state
    def init_state(self, seed: int = 0) -> TrainState:
        """G, its EMA copy and D with weights drawn from `seed`, fresh Adams, ADA at p_init."""
        m = self.cfg["model"]
        G = build_generator(m["generator"], device=self.device, seed=seed)
        D = build_discriminator(m["discriminator"], device=self.device, seed=seed + 1)
        G_ema = copy.deepcopy(G)
        for p in G_ema.parameters():
            p.requires_grad_(False)
        return TrainState(
            G=G, G_ema=G_ema, D=D,
            opt_G=torch.optim.Adam(G.parameters(), **self.adam_G),
            opt_D=torch.optim.Adam(D.parameters(), **self.adam_D),
            ada=self.ada.init_state(self.device),
            pl_ema=torch.zeros((), device=self.device),
        )

    # ------------------------------------------------------------------ schedule
    def warmup_params(self, iteration: int):
        """(blur sigma, dropout ratio), both fading linearly to 0 over warmup.fade_kimg."""
        num_imgs = iteration * self.batch_size
        if self.warmup_fade_imgs > 0:
            f = max(1.0 - num_imgs / self.warmup_fade_imgs, 0.0)
            return f * self.blur_init_sigma, f * self.dropout_init_ratio
        return 0.0, 0.0

    def ema_decay(self, iteration: int) -> float:
        tr = self.cfg["training"]
        ema_imgs = tr["ema_kimg"] * 1e3
        rampup = tr.get("ema_rampup", None)
        if rampup is not None:
            ema_imgs = min(ema_imgs, iteration * self.batch_size * rampup)
        return 0.5 ** (self.batch_size / max(ema_imgs, 1e-8))

    def schedule(self, iteration: int) -> Schedule:
        blur_sigma, dropout_ratio = self.warmup_params(iteration)
        return Schedule(
            dropout_ratio=dropout_ratio,
            blur_kernel=make_blur_kernel(blur_sigma, self.blur_init_sigma),
            skip_warmup=dropout_ratio == 0.0 and blur_sigma == 0.0,
            do_pl=self.w_pl > 0 and iteration % self.lazy_pl == 0,
            do_r1=self.w_gp > 0 and iteration % self.lazy_gp == 0,
            do_ada=iteration % self.lazy_ada == 0,
            ema_decay=self.ema_decay(iteration),
        )

    def pe_cache_for(self, state: TrainState):
        """The generator's Fourier-PE volumes: they depend only on the fixed angle grid
        and the frozen frequency buffers, so they are built again only when G or one of
        those buffers changed (a new state, or weights loaded into it). None for an arch
        without Fourier PE."""
        sig = (id(state.G),) + tuple(
            (b.data_ptr(), b._version) for name, b in state.G.named_buffers() if name.endswith((".freqs", ".phase"))
        )
        if self._pe_cache is None or self._pe_cache[0] != sig:
            self._pe_cache = (sig, build_pe_cache(state.G, self.angle))
        return self._pe_cache[1]

    @property
    def B_local(self) -> int:
        """This rank's share of the batch (the batch with no process group bound)."""
        return local_batch(self.batch_size)

    def stream(self, n: Optional[int] = None, *fold: int) -> PerSampleStream:
        """A stream of draws for this rank's n samples (default: B_local) of a global
        batch of n * world from the trainer's generator; given `fold` ints, the generator
        is first seeded with fold_seed(seed, *fold) (the step's stream: fold =
        (iteration,))."""
        if fold:
            self.generator.manual_seed(fold_seed(self.seed, *fold))
        return PerSampleStream(n or self.B_local, self.generator, self.device, rank(), world_size())

    # ------------------------------------------------------------------ phases
    def _warmup(self, x, st, sched: Schedule):
        if sched.skip_warmup:
            return x
        blur = sched.blur_kernel if self.blur_init_sigma > 0 else None
        return warmup_fn(x, st, sched.dropout_ratio, self.raydrop_const, blur)

    def _g_draws(self, G, st, train: bool):
        """The draws of one generator forward from st, in the JAX step's order: the
        azimuth shift (train mode with aug_coords), the noise maps of each block (with
        use_noise), the logistic ray-drop noise (where G has a measurement model). An
        arch without them draws nothing."""
        syn = G.synthesis_network
        draws = {"aug_shift": st.uniform() if train and syn.aug_coords else None}
        if getattr(syn, "use_noise", False):
            draws["noise"] = syn.draw_noise(st)
        draws["gumbel_noise"] = st.logistic((1, *self.resolution)) if G.has_raydrop else None
        return draws

    def _fake(self, state: TrainState, st) -> torch.Tensor:
        """One train-mode generator forward on draws from st: z, then the forward's own."""
        G = state.G
        z = st.normal((self.z_dim,))
        o = G(z, None, pe_cache=self.pe_cache_for(state), train=True, **self._g_draws(G, st, True))
        return o["image"]

    def g_phase(self, state: TrainState, x_real: torch.Tensor, st, sched: Schedule) -> torch.Tensor:
        """G's adversarial step before its optimizer: returns w_gan * loss and leaves the
        gradients in G's .grad (D's parameters take none)."""
        B = x_real.shape[0]
        D = state.D
        D.requires_grad_(False)
        try:
            x_fake = self.ada(self._warmup(self._fake(state, st), st, sched), state.ada.p, st)
            x_r = None
            if self.use_real_in_g:
                with torch.no_grad():
                    x_r = self.ada(self._warmup(x_real, st.with_batch(B), sched), state.ada.p, st.with_batch(B))
            loss = self.w_gan * g_phase_loss(D, x_fake, self.gan_objective, x_r)
        finally:
            D.requires_grad_(True)
        params = [p for p in state.G.parameters() if p.requires_grad]
        for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True)):
            p.grad = g
        _zero_fill_grads(state.G)
        pmean_grads_(state.G.parameters())
        return loss.detach()

    def pl_phase(self, state: TrainState, st) -> torch.Tensor:
        """The lazy path-length step before its optimizer, on B_local // 2 samples of each
        rank (as the JAX step, not half the global batch): styles w of
        an eval-mode forward (no autograd), then a train-mode forward from w (its buffers
        update) and the path lengths |d sum(img * noise) / dw| over the style axis,
        noise ~ N(0, 1 / (H W)). pl_ema moves 0.01 of the way to their mean; the
        penalty mean((len - pl_ema)^2) is weighted by w_pl and differentiated through
        the input gradient; the mean length and the gradients are averaged over the
        ranks. Returns this rank's penalty; G's gradients are in .grad and state.pl_ema is
        the new baseline."""
        G = state.G
        sp = st.with_batch(max(self.B_local // 2, 1))
        pe_cache = self.pe_cache_for(state)
        z = sp.normal((self.z_dim,))
        with torch.no_grad():
            w = G(z, None, pe_cache=pe_cache, **self._g_draws(G, sp, False))["w"]
        noise = sp.normal((1, *self.resolution)) / math.sqrt(float(np.prod(self.resolution)))
        w = w.detach().requires_grad_(True)
        img = G(w, None, pe_cache=pe_cache, train=True, input_w=True, **self._g_draws(G, sp, True))["image"]
        (gw,) = torch.autograd.grad((img * noise).sum(), w, create_graph=True)
        lengths = gw.square().sum(dim=-1).sqrt()
        pl_ema = state.pl_ema + 0.01 * (pmean_(lengths.mean().detach().clone()) - state.pl_ema)
        penalty = (lengths - pl_ema).square().mean()
        params = [p for p in G.parameters() if p.requires_grad]
        for p, g in zip(params, torch.autograd.grad(self.w_pl * penalty, params, allow_unused=True)):
            p.grad = g
        _zero_fill_grads(G)
        pmean_grads_(G.parameters())
        state.pl_ema = pl_ema
        return penalty.detach()

    def d_phase(self, state: TrainState, x_real: torch.Tensor, st, sched: Schedule):
        """D's adversarial step before its optimizer: G makes fakes without autograd (its
        buffers update), reals ++ fakes go through warmup + ADA as one batch, D scores
        each half. Returns (w_gan * loss, y_real, y_fake) with D's gradients in .grad."""
        B = x_real.shape[0]
        with torch.no_grad():
            x_fake = self._fake(state, st)
            st2 = st.with_batch(2 * B, parts=2)  # reals and fakes keep ids of their own
            xcat = self.ada(self._warmup(torch.cat([x_real, x_fake]), st2, sched), state.ada.p, st2)
        D = state.D
        D.zero_grad(set_to_none=True)
        y_real = D(xcat[:B], blur_fuse=False)
        y_fake = D(xcat[B:], blur_fuse=False)
        loss = self.w_gan * gan_loss_d(y_real, y_fake, self.gan_objective)
        loss.backward()
        _zero_fill_grads(D)
        pmean_grads_(D.parameters())
        return loss.detach(), y_real.detach(), y_fake.detach()

    def r1_phase(self, state: TrainState, x_real: torch.Tensor, st, sched: Schedule) -> torch.Tensor:
        """The lazy R1 step before its optimizer: warmup + ADA inside D's input, weight
        w_gp / 2. Returns the penalty; D's gradients are in .grad."""
        p = state.ada.p
        D = state.D
        D.zero_grad(set_to_none=True)
        penalty = r1_penalty(D, x_real, lambda x: self.ada(self._warmup(x, st, sched), p, st))
        ((self.w_gp / 2.0) * penalty).backward()
        _zero_fill_grads(D)
        pmean_grads_(D.parameters())
        return penalty.detach()

    @torch.no_grad()
    def ema_phase(self, state: TrainState, sched: Schedule):
        """G_ema's parameters move toward G's by the schedule's decay (float32, as the
        JAX step); its buffers become G's; ADA's p moves on an ADA iteration. Returns the
        ADA statistic rt of that update, else None."""
        d32 = np.float32(sched.ema_decay)
        ema, params = list(state.G_ema.parameters()), list(state.G.parameters())
        torch._foreach_mul_(ema, float(d32))
        torch._foreach_add_(ema, torch._foreach_mul(params, float(np.float32(1.0) - d32)))
        for be, b in zip(state.G_ema.buffers(), state.G.buffers()):
            be.copy_(b)
        if sched.do_ada:
            state.ada, rt = self.ada.update_p(state.ada)
            return rt
        return None

    # ------------------------------------------------------------------ the step
    def step(
        self, state: TrainState, batch: Dict[str, Any], iteration: int, draws=None,
        on_phase: Optional[Callable[[str, TrainState, Dict[str, torch.Tensor]], None]] = None,
    ) -> Dict[str, torch.Tensor]:
        """One training iteration on this rank's B_local rows of the global batch, in place
        on `state`; returns the metrics (averaged over the ranks) as 0-dim tensors on the
        device (no host synchronization). `draws` replaces the trainer's generator as the
        source of every random draw (a parallel.ReplayStream of global arrays on the
        trainer's device, with this rank's rank and world). `on_phase(name, state, values)` is called after each of the
        "g", "pl", "d" and "r1" phases, with its gradients in .grad, before the optimizer
        steps; values holds the phase's loss (and D's outputs, or the penalty and
        pl_ema)."""
        hook = on_phase or (lambda name, st, values: None)
        sched = self.schedule(iteration)
        B = self.B_local
        st = (self.stream(None, iteration) if draws is None else draws).with_batch(B)
        x_real = fetch_reals(batch, self.min_depth, self.max_depth, self.raydrop_const, self.device)["image"]
        if x_real.shape[0] != B:
            raise ValueError(f"batch of {x_real.shape[0]}, this rank's share of the config's batch_size "
                             f"{self.batch_size} is {B}")
        m = {}
        loss_G = self.g_phase(state, x_real, st, sched)
        hook("g", state, {"loss": loss_G})
        state.opt_G.step()
        state.G.zero_grad(set_to_none=True)
        m["loss/G/adversarial"] = loss_G / self.w_gan

        if sched.do_pl:
            m["loss/G/path_length"] = self.pl_phase(state, st)
            m["loss/G/path_length/baseline"] = state.pl_ema
            hook("pl", state, {"penalty": m["loss/G/path_length"], "pl_ema": state.pl_ema})
            state.opt_G.step()
            state.G.zero_grad(set_to_none=True)

        loss_D, y_real, y_fake = self.d_phase(state, x_real, st, sched)
        hook("d", state, {"loss": loss_D, "y_real": y_real, "y_fake": y_fake})
        state.opt_D.step()
        state.ada = self.ada.cumulate(state.ada, y_real)
        m["loss/D/adversarial"] = loss_D / self.w_gan
        m["loss/D/output/real"], m["loss/D/output/fake"] = y_real.mean(), y_fake.mean()

        if sched.do_r1:
            m["loss/D/gradient_penalty"] = self.r1_phase(state, x_real, st, sched)
            hook("r1", state, {"penalty": m["loss/D/gradient_penalty"]})
            state.opt_D.step()
        state.D.zero_grad(set_to_none=True)

        rt = self.ema_phase(state, sched)
        if rt is not None:
            m["stats/ada_rt"] = rt
        m["stats/ada_p"] = state.ada.p
        state.step += 1
        if bound():  # one collective for every metric
            vals = pmean_(torch.stack([v.float().reshape(()) for v in m.values()]))
            m = dict(zip(m, vals.unbind()))
        return m

    def augment_reals(self, state: TrainState, batch: Dict[str, Any], iteration: int, stream=None) -> torch.Tensor:
        """Reals -> warmup -> ADA at the current p (the augmented-reals panel)."""
        x = fetch_reals(batch, self.min_depth, self.max_depth, self.raydrop_const, self.device)["image"]
        blur_sigma, dropout_ratio = self.warmup_params(iteration)
        kernel = make_blur_kernel(blur_sigma, self.blur_init_sigma)
        st = (PerSampleStream(x.shape[0], self.generator, self.device) if stream is None else stream
              ).with_batch(x.shape[0])
        with torch.no_grad():
            return self.ada(warmup_fn(x, st, dropout_ratio, self.raydrop_const, kernel), state.ada.p, st)

    @torch.no_grad()
    def sample(self, state: TrainState, z: torch.Tensor, ema: bool = True, **kwargs) -> Dict[str, torch.Tensor]:
        """An eval-mode forward of G_ema (or G); without gumbel_noise the noise is drawn
        from `generator` (default: the trainer's)."""
        kwargs.setdefault("generator", self.generator)
        return (state.G_ema if ema else state.G)(z, self.angle, **kwargs)
