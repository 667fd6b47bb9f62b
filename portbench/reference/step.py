"""The reference's GAN training step: G's adversarial phase, D's adversarial phase, lazy
R1, the two Adam steps, EMA and ADA's controller, in the order and with the draws of the
configuration's step (nsgan, warmup, ADA, R1; no path-length regularizer and no other
objective: neither benchmarked configuration sets one).

    ref = RefTrainer(cfg, angle, device)
    state = ref.init_state(weights, ada_p)      # the benchmark's seeded weights
    out = ref.step(state, batch, iteration, stream, on_phase)

`on_phase(name, state, values)` is called after the "g", "d" and "r1" phases with the
gradients in .grad, before the optimizer steps, as the program's hook is; the "d" phase's
values hold D's outputs on the reals and the fakes.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from .ada import AdaptiveAugment, AdaState
from .models import build_discriminator, build_generator, build_pe_cache, gan_loss_d, gan_loss_g
from .ops import filter2d

__all__ = ["RefState", "RefTrainer", "fetch_reals"]


def fetch_reals(depth: torch.Tensor, mask: torch.Tensor, min_depth: float, max_depth: float,
                raydrop_const: float) -> torch.Tensor:
    """Depth in metres and a mask -> the tanh-scaled inverse-depth image, dropped rays
    filled with raydrop_const."""
    depth, mask = depth.float(), mask.float()
    valid = ((depth >= min_depth) & (depth <= max_depth) & (depth > 0.0)).float()
    inv_norm = min_depth / torch.where(valid > 0, depth, torch.ones_like(depth)) * valid
    x = inv_norm * 2.0 - 1.0
    return mask * x + (1.0 - mask) * raydrop_const


def make_blur_kernel(blur_sigma: float, blur_init_sigma: float) -> Optional[np.ndarray]:
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


def r1_penalty(D: nn.Module, x_real: torch.Tensor, augment: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """mean_b sum_chw (d sum(D(augment(x))) / dx)^2, built for a double backward."""
    x = x_real.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(D(augment(x)).sum(), x, create_graph=True)
    return g.square().sum(dim=(1, 2, 3)).mean()


def _zero_fill_grads(net: nn.Module) -> None:
    for p in net.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)


@dataclasses.dataclass
class RefState:
    G: nn.Module
    G_ema: nn.Module
    D: nn.Module
    opt_G: torch.optim.Optimizer
    opt_D: torch.optim.Optimizer
    ada: AdaState


class RefTrainer:
    def __init__(self, cfg: Dict[str, Any], angle: torch.Tensor, device):
        self.cfg, self.device = cfg, torch.device(device)
        tr, ds, g_cfg = cfg["training"], cfg["dataset"], cfg["model"]["generator"]
        self.resolution = tuple(g_cfg["synthesis_kwargs"]["resolution"])
        self.z_dim = g_cfg["mapping_kwargs" if "mapping_kwargs" in g_cfg else "synthesis_kwargs"]["in_ch"]
        self.batch_size = int(tr["batch_size"])
        aug = tr["augment"]
        self.ada = AdaptiveAugment(p_init=aug["p_init"], p_target=aug["p_target"], kimg=aug["kimg"], **aug["policy"])
        loss, lazy = tr["loss"], tr["lazy"]
        if loss.get("pl", 0) > 0:
            raise NotImplementedError("the reference has no path-length regularizer")
        self.w_gan = float(loss["gan"])
        self.lazy_gp, self.lazy_ada = int(lazy["gp"]), int(lazy["ada"])
        self.w_gp = float(loss["gp"]) * self.lazy_gp if loss.get("gp", 0) > 0 else 0.0
        c_D = self.lazy_gp / (self.lazy_gp + 1.0) if self.w_gp > 0 else 1.0
        self.adam_G = self._adam(tr["lr"]["generator"], 1.0)
        self.adam_D = self._adam(tr["lr"]["discriminator"], c_D)
        if tr["gan_objective"] != "nsgan":
            raise NotImplementedError("the reference's objective is nsgan")
        self.raydrop_const = float(ds["raydrop_const"])
        self.min_depth, self.max_depth = float(ds["min_depth"]), float(ds["max_depth"])
        wu = tr["warmup"]
        self.fade_imgs = float(wu["fade_kimg"]) * 1e3
        self.blur_init_sigma = float(wu["blur_init_sigma"])
        self.dropout_init_ratio = float(wu["dropout_init_ratio"])
        self.angle = angle.to(self.device)
        self._pe = None

    @staticmethod
    def _adam(lr_cfg, c: float) -> Dict[str, Any]:
        return {"lr": lr_cfg["alpha"] * c, "betas": (lr_cfg["beta1"] ** c, lr_cfg["beta2"] ** c), "eps": 1e-8,
                "foreach": False}

    def init_state(self, weights: Dict[str, Dict[str, torch.Tensor]], ada_p: float) -> RefState:
        """Models built from the configuration with `weights` ({"G": state dict, "D": ...};
        G_ema starts as G), fresh Adams, ADA's controller at p = ada_p."""
        m = self.cfg["model"]
        G = build_generator(m["generator"], self.device)
        G.load_state_dict(weights["G"])
        D = build_discriminator(m["discriminator"], self.device)
        D.load_state_dict(weights["D"])
        G_ema = copy.deepcopy(G)
        for p in G_ema.parameters():
            p.requires_grad_(False)
        self._pe = build_pe_cache(G, self.angle)
        return RefState(G=G, G_ema=G_ema, D=D, opt_G=torch.optim.Adam(G.parameters(), **self.adam_G),
                        opt_D=torch.optim.Adam(D.parameters(), **self.adam_D),
                        ada=AdaState.create(ada_p, self.device))

    # the schedule of an iteration
    def warmup(self, iteration: int):
        f = max(1.0 - iteration * self.batch_size / self.fade_imgs, 0.0) if self.fade_imgs > 0 else 0.0
        return f * self.blur_init_sigma, f * self.dropout_init_ratio

    def ema_decay(self, iteration: int) -> float:
        tr = self.cfg["training"]
        ema_imgs = tr["ema_kimg"] * 1e3
        if tr.get("ema_rampup", None) is not None:
            ema_imgs = min(ema_imgs, iteration * self.batch_size * tr["ema_rampup"])
        return 0.5 ** (self.batch_size / max(ema_imgs, 1e-8))

    def _warmup(self, x, st, iteration):
        blur_sigma, ratio = self.warmup(iteration)
        if ratio == 0.0 and blur_sigma == 0.0:
            return x
        if self.blur_init_sigma > 0:
            x = filter2d(x, make_blur_kernel(blur_sigma, self.blur_init_sigma))
        keep_p = float(np.float32(1.0) - np.float32(ratio))
        keep = st.bernoulli(keep_p, tuple(x.shape[1:])).to(x.device, x.dtype)
        return keep * x + (1.0 - keep) * self.raydrop_const

    def fake(self, state: RefState, st) -> torch.Tensor:
        """One train-mode G forward on draws from st: z, the azimuth shift, the ray-drop noise."""
        G = state.G
        syn = G.synthesis_network
        z = st.normal((self.z_dim,))
        kw = {"aug_shift": st.uniform() if syn.aug_coords else None}
        kw["gumbel_noise"] = st.logistic((1, *self.resolution)) if G.has_raydrop else None
        return G(z, None, pe_cache=self._pe, train=True, **kw)["image"]

    def step(self, state: RefState, depth: torch.Tensor, mask: torch.Tensor, iteration: int, stream,
             on_phase: Optional[Callable[[str, RefState, Dict[str, torch.Tensor]], None]] = None) -> Dict[str, torch.Tensor]:
        hook = on_phase or (lambda name, st, values: None)
        B = self.batch_size
        st = stream.with_batch(B)
        x_real = fetch_reals(depth, mask, self.min_depth, self.max_depth, self.raydrop_const)
        G, D, p = state.G, state.D, state.ada.p
        out = {}

        D.requires_grad_(False)
        x_fake = self.ada(self._warmup(self.fake(state, st), st, iteration), p, st)
        loss_G = self.w_gan * gan_loss_g(D(x_fake))
        loss_G.backward()
        D.requires_grad_(True)
        _zero_fill_grads(G)
        hook("g", state, {"loss": loss_G.detach()})
        state.opt_G.step()
        G.zero_grad(set_to_none=True)
        out["g"] = loss_G.detach() / self.w_gan

        with torch.no_grad():
            x_fake = self.fake(state, st)
            st2 = st.with_batch(2 * B, parts=2)
            xcat = self.ada(self._warmup(torch.cat([x_real, x_fake]), st2, iteration), p, st2)
        D.zero_grad(set_to_none=True)
        y_real, y_fake = D(xcat[:B]), D(xcat[B:])
        loss_D = self.w_gan * gan_loss_d(y_real, y_fake)
        loss_D.backward()
        _zero_fill_grads(D)
        hook("d", state, {"loss": loss_D.detach(), "y_real": y_real.detach(), "y_fake": y_fake.detach()})
        state.opt_D.step()
        state.ada = self.ada.cumulate(state.ada, y_real)
        out["d"] = loss_D.detach() / self.w_gan

        if self.w_gp > 0 and iteration % self.lazy_gp == 0:
            D.zero_grad(set_to_none=True)
            penalty = r1_penalty(D, x_real, lambda x: self.ada(self._warmup(x, st, iteration), p, st))
            ((self.w_gp / 2.0) * penalty).backward()
            _zero_fill_grads(D)
            hook("r1", state, {"penalty": penalty.detach()})
            state.opt_D.step()
            out["r1"] = penalty.detach()
        D.zero_grad(set_to_none=True)

        with torch.no_grad():
            d32 = np.float32(self.ema_decay(iteration))
            for pe, pg in zip(state.G_ema.parameters(), G.parameters()):
                pe.mul_(float(d32)).add_(pg * float(np.float32(1.0) - d32))
            for be, bg in zip(state.G_ema.buffers(), G.buffers()):
                be.copy_(bg)
        if iteration % self.lazy_ada == 0:
            state.ada, _ = self.ada.update_p(state.ada)
        return out
