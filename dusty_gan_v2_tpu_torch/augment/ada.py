"""Adaptive discriminator augmentation (StyleGAN2-ADA) for LiDAR range images.

Counterpart of dusty_gan_v2_tpu/augment/ada.py. The geometric part (flips, integer and
fractional translations, isotropic scale) is a 2x wavelet upsample, an inverse-affine
bilinear warp (wrapping along the periodic azimuth W, reflect-then-zero along H) and a
2x wavelet downsample. Every stage is linear and factorizes per axis, so, as in the JAX
module, the H chain collapses into one per-sample (H, H) matrix built from rows of a
constant up operator, and the W chain runs as constant matmuls around a fractional wrap
(`ops/shift.py`). The constant operators are built once per (H, W) in numpy
(`_warp_chain_mats`). Then the colour transform (4x4 homogeneous, projected onto one
channel), the per-sample wavelet-band filter, additive noise and cutout.

Every parameter draw comes from a stream of ops/../parallel/persample.py, in the JAX
module's order (sample_affine, sample_color, filter, noise, cutout), so that a
ReplayStream feeds both packages the same numbers. Everything is torch ops on the image,
so the augmentation differentiates twice (R1 runs through it).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F

from ..ops.pad import pad_axis
from ..ops.resample import upfirdn2d
from ..ops.shift import fractional_wrap_lerp

__all__ = ["AdaptiveAugment", "AdaState", "SYM2", "SYM6", "apply_imgfilter", "cutout_mask"]

# Daubechies symlet coefficients (public wavelet constants)
SYM2 = np.array([-0.12940952255092145, 0.22414386804185735, 0.836516303737469, 0.48296291314469025])
SYM6 = np.array([
    0.015404109327027373, 0.0034907120842174702, -0.11799011114819057, -0.048311742585633,
    0.4910559419267466, 0.787641141030194, 0.3379294217276218, -0.07263752278646252,
    -0.021060292512300564, 0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
])
_AXIS = (1 / math.sqrt(3),) * 3


def _make_fbank() -> np.ndarray:
    """4-band wavelet filter bank for imgfilter, (4, taps) float32."""
    Hz_lo = SYM2
    Hz_hi = Hz_lo * ((-1) ** np.arange(Hz_lo.size))
    Hz_lo2 = np.convolve(Hz_lo, Hz_lo[::-1]) / 2
    Hz_hi2 = np.convolve(Hz_hi, Hz_hi[::-1]) / 2
    fbank = np.eye(4, 1)
    for i in range(1, fbank.shape[0]):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(fbank.shape[0], -1)[:, :-1]
        fbank = scipy.signal.convolve(fbank, [Hz_lo2])
        fbank[i, (fbank.shape[1] - Hz_hi2.size) // 2: (fbank.shape[1] + Hz_hi2.size) // 2] += Hz_hi2
    return fbank.astype(np.float32)


@dataclasses.dataclass
class AdaState:
    """The adaptive-p controller's state: 0-dim float32 tensors on the training device."""

    p: torch.Tensor
    sign_cum: torch.Tensor
    n_pred_cum: torch.Tensor

    @classmethod
    def create(cls, p_init: float = 0.0, device="cpu") -> "AdaState":
        z = lambda v: torch.tensor(float(v), dtype=torch.float32, device=device)  # noqa: E731
        return cls(p=z(p_init), sign_cum=z(0.0), n_pred_cum=z(0.0))


def _eye(n, B, device):
    return torch.eye(n, device=device).expand(B, n, n).clone()


def _t2d(tx, ty):
    m = _eye(3, tx.shape[0], tx.device)
    m[:, 0, 2], m[:, 1, 2] = tx, ty
    return m


def _s2d(sx, sy):
    m = _eye(3, sx.shape[0], sx.device)
    m[:, 0, 0], m[:, 1, 1] = sx, sy
    return m


def _t3d(tx, ty, tz):
    m = _eye(4, tx.shape[0], tx.device)
    m[:, 0, 3], m[:, 1, 3], m[:, 2, 3] = tx, ty, tz
    return m


def _s3d(sx, sy, sz):
    m = _eye(4, sx.shape[0], sx.device)
    m[:, 0, 0], m[:, 1, 1], m[:, 2, 2] = sx, sy, sz
    return m


def _axis4(device):
    return torch.tensor(_AXIS + (0.0,), dtype=torch.float32, device=device)


def _luma_flip(i):
    a = _axis4(i.device)
    return torch.eye(4, device=i.device) - 2.0 * torch.outer(a, a)[None] * i[:, None, None]


def _saturation_mat(i):
    a = _axis4(i.device)
    aa = torch.outer(a, a)[None]
    return aa + (torch.eye(4, device=i.device)[None] - aa) * i[:, None, None]


def _rotate3d(theta):
    ux, uy, uz = _AXIS
    dev = theta.device
    eye = torch.eye(3, device=dev)[None]
    cross = torch.tensor([[0, -uz, uy], [uz, 0, -ux], [-uy, ux, 0]], dtype=torch.float32, device=dev)[None]
    a = torch.tensor(_AXIS, dtype=torch.float32, device=dev)
    outer = torch.outer(a, a)[None]
    s, c = torch.sin(theta)[:, None, None], torch.cos(theta)[:, None, None]
    out = _eye(4, theta.shape[0], dev)
    out[:, :3, :3] = c * eye + s * cross + (1 - c) * outer
    return out


def _inv3x3(m):
    """Closed-form batched 3x3 inverse (adjugate over determinant), as the JAX module."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    A, B_, C = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * A + b * B_ + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B_, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[:, None, None]


@functools.lru_cache(maxsize=8)
def _warp_chain_mats(H: int, W: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Constant operators of the separable warp chain, indexed [out, in], float32:
      Uh (Hs, H): reflect pad (H - 1 each side) -> 2x up-FIR along H (flipped SYM6)
      Dh (H, Ho): 2x down-FIR along H with the crop pads (Ho = warp canvas rows)
      Uw (Ws, W): circular pad -> 2x up-FIR along W (flipped SYM6), Ws = 2W exactly
      Dw (W, Wo): 2x down-FIR along W with the crop pads
    Built by pushing identity bases through a float64 pad + upfirdn."""
    k = SYM6
    kl = len(k)
    pad_k = kl // 4  # 3
    kc = k[::-1]
    up0, up1 = (kl + 2 - 1) // 2, (kl - 2) // 2
    c = kl  # circular margin along W: the filter never sees a synthetic W edge
    d_p = -pad_k * 2
    dn0, dn1 = d_p + (kl - 2 + 1) // 2, d_p + (kl - 2) // 2
    Ho, Wo = (H + 2 * pad_k) * 2, (W + 2 * pad_k) * 2

    eh = np.pad(np.eye(H), ((H - 1, H - 1), (0, 0)), mode="reflect")  # basis vectors along rows
    Uh = upfirdn2d(eh, kc.reshape(-1, 1), up=(2, 1), pad=(0, 0, up0, up1))
    Dh = upfirdn2d(np.eye(Ho), k.reshape(-1, 1), down=(2, 1), pad=(0, 0, dn0, dn1))
    ew = np.pad(np.eye(W), ((0, 0), (c, c)), mode="wrap")  # basis vectors along columns
    Uw = upfirdn2d(ew, kc.reshape(1, -1), up=(1, 2), pad=(up0 - 2 * c, up1 - 2 * c, 0, 0)).T
    Dw = upfirdn2d(np.eye(Wo), k.reshape(1, -1), down=(1, 2), pad=(dn0, dn1, 0, 0)).T
    return tuple(m.astype(np.float32) for m in (Uh, Dh, Uw, Dw))


@functools.lru_cache(maxsize=16)
def _warp_chain_on(H: int, W: int, device: torch.device):
    return tuple(torch.from_numpy(m).to(device) for m in _warp_chain_mats(H, W))


def _maybe(st, p, mat, prev):
    """With probability p per sample apply `mat`, else the identity; compose onto prev."""
    sel = (st.uniform((1, 1)) < p).to(mat.dtype)
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)[None]
    return (sel * mat + (1 - sel) * eye) @ prev


class AdaptiveAugment:
    """Stateless transform executor and the adaptive-p controller.

        ada = AdaptiveAugment(p_target=0.6, kimg=500, lr_flip=1, ...)
        img_aug = ada(img, state.p, stream)     # stream: PerSampleStream / ReplayStream
        state = ada.cumulate(state, d_real_logits)
        state, rt = ada.update_p(state)         # every lazy.ada steps
    """

    POLICY = ("lr_flip", "ud_flip", "int_trans", "iso_scale", "frac_trans", "brightness", "contrast",
              "luma_flip", "hue", "saturation", "imgfilter", "noise", "cutout")

    def __init__(
        self, p_init: float = 0.0, p_target: Optional[float] = 0.6, p_max: float = 0.9, kimg: float = 500,
        wonly_trans: bool = False, **policy,
    ):
        self.p_init = float(p_init)
        self.p_target = p_target
        self.p_max = float(p_max)
        self.kimg = float(kimg) * 1000.0
        self.mul = {name: float(policy.pop(name, 0.0)) for name in self.POLICY}
        self.h_trans_factor = 0.0 if wonly_trans else 1.0
        self.Hz_fbank = _make_fbank()
        self.imgfilter_bands = (1.0, 1.0, 1.0, 1.0)
        self.imgfilter_std = 1.0

    def init_state(self, device="cpu") -> AdaState:
        return AdaState.create(self.p_init, device)

    # ----------------------------------------------------------------- p control
    @staticmethod
    @torch.no_grad()
    def cumulate(state: AdaState, y_real: torch.Tensor) -> AdaState:
        """Accumulate sign(D(real)) over the batch (on the device, no host sync)."""
        s = torch.sign(y_real.detach().float()).sum()
        return dataclasses.replace(
            state, sign_cum=state.sign_cum + s, n_pred_cum=state.n_pred_cum + float(y_real.shape[0])
        )

    @torch.no_grad()
    def update_p(self, state: AdaState) -> Tuple[AdaState, torch.Tensor]:
        """Move p toward p_target by sign(rt - target) * n / kimg; reset the sums."""
        rt = state.sign_cum / torch.clamp(state.n_pred_cum, min=1.0)
        p = state.p
        if self.p_target is not None:
            adjust = torch.sign(rt - self.p_target) * state.n_pred_cum / self.kimg
            p = torch.clamp(state.p + adjust, 0.0, self.p_max)
        z = torch.zeros_like(state.p)
        return AdaState(p=p, sign_cum=z, n_pred_cum=z.clone()), rt

    # ----------------------------------------------------------------- transforms
    def sample_affine(self, st, B: int, height: int, width: int, p, device) -> torch.Tensor:
        G = _eye(3, B, device)
        ones = torch.ones(B, device=device)
        m = self.mul
        if m["lr_flip"] > 0:
            flip = st.randint().float()
            G = _maybe(st, p * m["lr_flip"], _s2d(1 - 2 * flip, ones), G)
        if m["ud_flip"] > 0:
            flip = st.randint().float()
            G = _maybe(st, p * m["ud_flip"], _s2d(ones, 1 - 2 * flip), G)
        if m["int_trans"] > 0:
            tr = st.uniform((2,), minval=-0.125, maxval=0.125).T
            ty = torch.round(tr[0] * height) * self.h_trans_factor
            tx = torch.round(tr[1] * width)
            G = _maybe(st, p * m["int_trans"], _t2d(tx, ty), G)
        if m["iso_scale"] > 0:
            s = torch.exp(st.normal() * (0.2 * math.log(2.0)))
            G = _maybe(st, p * m["iso_scale"], _s2d(ones, s), G)
        if m["frac_trans"] > 0:
            tr = st.normal((2,)).T * 0.125
            ty = tr[0] * height * self.h_trans_factor
            tx = tr[1] * width
            G = _maybe(st, p * m["frac_trans"], _t2d(tx, ty), G)
        return G

    def sample_color(self, st, B: int, p, device) -> torch.Tensor:
        C = _eye(4, B, device)
        m = self.mul
        if m["brightness"] > 0:
            b = st.normal() * 0.2
            C = _maybe(st, p * m["brightness"], _t3d(b, b, b), C)
        if m["contrast"] > 0:
            c = torch.exp(st.normal() * (0.5 * math.log(2.0)))
            C = _maybe(st, p * m["contrast"], _s3d(c, c, c), C)
        if m["luma_flip"] > 0:
            f = st.randint().float()
            C = _maybe(st, p * m["luma_flip"], _luma_flip(f), C)
        if m["hue"] > 0:
            theta = st.uniform(minval=-math.pi, maxval=math.pi)
            C = _maybe(st, p * m["hue"], _rotate3d(theta), C)
        if m["saturation"] > 0:
            s = torch.exp(st.normal() * math.log(2.0))
            C = _maybe(st, p * m["saturation"], _saturation_mat(s), C)
        return C

    def _geometric(self, img: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
        """2x wavelet upsample -> inverse-affine bilinear warp (wrap W / reflect + zero H)
        -> 2x wavelet downsample, in composed-operator form (module docstring). The
        sampled affines are axis-aligned (no rotation or shear), so the warp factorizes
        into a W and an H resampling."""
        B, C, H, W = img.shape
        dev, dtype = img.device, img.dtype
        pad_k = len(SYM6) // 4
        Uh, Dh, Uw, Dw = _warp_chain_on(H, W, dev)
        Hs, Ws = Uh.shape[0], Uw.shape[0]
        diag = lambda *v: torch.diag(torch.tensor(v, dtype=torch.float32, device=dev))  # noqa: E731
        half = lambda s: torch.tensor([[1, 0, s], [0, 1, s], [0, 0, 1]], dtype=torch.float32, device=dev)  # noqa: E731
        G_inv = diag(2.0, 2.0, 1.0)[None] @ _inv3x3(G) @ diag(0.5, 0.5, 1.0)[None]
        G_inv = half(-0.5)[None] @ G_inv @ half(0.5)[None]
        Ho, Wo = (H + 2 * pad_k) * 2, (W + 2 * pad_k) * 2
        Gn = diag(2.0 / Ws, 2.0 / Hs, 1.0)[None] @ G_inv @ diag(Wo / 2.0, Ho / 2.0, 1.0)[None]
        xt = (2.0 * torch.arange(Wo, device=dev, dtype=torch.float32) + 1.0) / Wo - 1.0
        yt = (2.0 * torch.arange(Ho, device=dev, dtype=torch.float32) + 1.0) / Ho - 1.0
        u = ((Gn[:, 0, 0, None] * xt[None] + Gn[:, 0, 2, None] + 1.0) * Ws - 1.0) / 2.0
        v = ((Gn[:, 1, 1, None] * yt[None] + Gn[:, 1, 2, None] + 1.0) * Hs - 1.0) / 2.0

        # the per-sample H operator Ah = Dh @ (bilinear row mix of Uh's rows), zero
        # outside [0, Hs) as grid_sample's zeros padding
        v0 = torch.floor(v)
        fv = v - v0
        v0i = v0.long()
        v1i = v0i + 1
        w0 = (1.0 - fv) * ((v0i >= 0) & (v0i < Hs)).float()
        w1 = fv * ((v1i >= 0) & (v1i < Hs)).float()
        M = Uh[v0i.clamp(0, Hs - 1)] * w0[..., None] + Uh[v1i.clamp(0, Hs - 1)] * w1[..., None]  # (B, Ho, H)
        Ah = torch.matmul(Dh, M)  # (B, H, H)
        img = torch.matmul(Ah.to(dtype)[:, None], img)

        # the W chain: up-FIR -> fractional wrap -> down-FIR
        y = torch.matmul(img, Uw.t().to(dtype))  # (B, C, H, Ws)
        u0 = torch.floor(u)
        fu = (u - u0).to(dtype)[:, None, None, :]
        i0 = torch.remainder(u0.long(), Ws)
        z = fractional_wrap_lerp(y, i0, fu)  # (B, C, H, Wo)
        return torch.matmul(z, Dw.t().to(dtype))

    def __call__(self, img: torch.Tensor, p, stream) -> torch.Tensor:
        """Augment a batch (NCHW float32) at strength p (a float or 0-dim tensor). Every
        draw comes from `stream`, whose batch must be img's."""
        B, C, H, W = img.shape
        if stream.n is not None and stream.n != B:
            raise ValueError(f"stream draws for {stream.n} samples, the batch has {B}")
        dev = img.device
        G = self.sample_affine(stream, B, H, W, p, dev)
        img = self._geometric(img, G)

        # colour transform (4x4 homogeneous), projected onto a single channel
        Cmat = self.sample_color(stream, B, p, dev)
        flat = img.reshape(B, C, H * W)
        if C == 3:
            flat = Cmat[:, :3, :3] @ flat + Cmat[:, :3, 3:]
        elif C == 1:
            Cm = Cmat[:, :3, :].mean(dim=1, keepdim=True)  # (B, 1, 4)
            flat = flat * Cm[:, :, :3].sum(dim=2, keepdim=True) + Cm[:, :, 3:]
        img = flat.reshape(B, C, H, W)

        if self.mul["imgfilter"] > 0:
            img = apply_imgfilter(img, self.imgfilter_gains(p, stream, B, dev))
        if self.mul["noise"] > 0:
            sigma = torch.abs(stream.normal((1, 1, 1))) * 0.1
            on = stream.uniform((1, 1, 1)) < self.mul["noise"] * p
            sigma = torch.where(on, sigma, torch.zeros_like(sigma))
            img = img + stream.normal(tuple(img.shape[1:])) * sigma
        if self.mul["cutout"] > 0:
            size = torch.full((B, 2, 1, 1, 1), 0.5, device=dev)
            on = stream.uniform((1, 1, 1, 1)) < self.mul["cutout"] * p
            size = torch.where(on, size, torch.zeros_like(size))
            center = stream.uniform((2, 1, 1, 1))
            img = img * cutout_mask(center, size, H, W).to(img.dtype)
        return img

    def imgfilter_gains(self, p, st, B: int, device) -> torch.Tensor:
        """Per-sample combined amplification filter (B, taps): per-band log-normal gains
        with 1/f power normalization."""
        fbank = torch.from_numpy(self.Hz_fbank).to(device)
        num_bands = fbank.shape[0]
        expected_power = torch.tensor(np.array([10, 1, 1, 1]) / 13, dtype=torch.float32, device=device)
        g = torch.ones(B, num_bands, device=device)
        for i, band_strength in enumerate(self.imgfilter_bands):
            t_i = torch.exp2(st.normal() * self.imgfilter_std)
            on = st.uniform() < self.mul["imgfilter"] * p * band_strength
            t_i = torch.where(on, t_i, torch.ones_like(t_i))
            t = torch.ones(B, num_bands, device=device)
            t[:, i] = t_i
            t = t / torch.sqrt((expected_power * t**2).sum(dim=-1, keepdim=True))
            g = g * t
        return g @ fbank


def apply_imgfilter(img: torch.Tensor, Hz_prime: torch.Tensor) -> torch.Tensor:
    """Separable per-sample FIR (Hz_prime (B, taps)), circular-W / reflect-H padded: one
    grouped convolution per axis."""
    B, C, H, W = img.shape
    taps = Hz_prime.shape[-1]
    pp = taps // 2
    x = pad_axis(pad_axis(img, -1, pp, pp, "circular"), -2, pp, pp, "reflect")
    k = Hz_prime.to(img.dtype).repeat_interleave(C, dim=0)  # (B * C, taps)
    x = x.reshape(1, B * C, *x.shape[-2:])
    x = F.conv2d(x, k.reshape(B * C, 1, 1, taps), groups=B * C)
    x = F.conv2d(x, k.reshape(B * C, 1, taps, 1), groups=B * C)
    return x.reshape(B, C, H, W)


def cutout_mask(center: torch.Tensor, size: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, 1, H, W) keep-mask of a rectangular cutout; center and size (B, 2, 1, 1, 1) in
    normalized [0, 1] coordinates."""
    cx = torch.arange(W, device=center.device).reshape(1, 1, 1, -1)
    cy = torch.arange(H, device=center.device).reshape(1, 1, -1, 1)
    mx = torch.abs((cx + 0.5) / W - center[:, 0]) >= size[:, 0] / 2
    my = torch.abs((cy + 0.5) / H - center[:, 1]) >= size[:, 1] / 2
    return mx | my
