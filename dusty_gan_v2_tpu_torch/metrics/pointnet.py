"""PointNet classifier feature extractor for FPD/KPD (counterpart of
dusty_gan_v2_tpu/metrics/pointnet.py).

STN3d + a 1024-d max-pool backbone; the forward returns the 1024 + 512 + 256 + k
concatenated features. It always runs in eval mode: batch norm uses its running
statistics (eps 1e-5) and is never updated. The submodule names are those of the
released SpareNet classifier (`cls_model_39.pth`), so its state dict loads by name.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import full_float32, resolve_device

__all__ = ["PointNetFeatures", "build_pointnet", "load_torch_state_dict", "FEATURE_DIM"]

_BN_EPS = 1e-5
FEATURE_DIM = 1024 + 512 + 256 + 16


class _FrozenBatchNorm(nn.Module):
    """Batch norm over channel axis 1 with fixed running statistics."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias, training=False, eps=_BN_EPS
        )


class _Conv1x1(nn.Module):
    """Pointwise convolution over (B, C, N); weight (O, I) as in the JAX pytree."""

    def __init__(self, i: int, o: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i))
        self.bias = nn.Parameter(torch.empty(o))

    def forward(self, x):
        return torch.matmul(self.weight, x) + self.bias[None, :, None]


class _STN3d(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.conv2, self.conv3 = _Conv1x1(3, 64), _Conv1x1(64, 128), _Conv1x1(128, 1024)
        self.fc1, self.fc2, self.fc3 = nn.Linear(1024, 512), nn.Linear(512, 256), nn.Linear(256, 9)
        for i, c in enumerate((64, 128, 1024, 512, 256), start=1):
            setattr(self, f"bn{i}", _FrozenBatchNorm(c))

    def forward(self, x):  # (B, 3, N) -> (B, 3, 3)
        h = F.relu_(self.bn1(self.conv1(x)))
        h = F.relu_(self.bn2(self.conv2(h)))
        h = F.relu_(self.bn3(self.conv3(h)))
        h = h.amax(dim=2)
        h = F.relu_(self.bn4(self.fc1(h)))
        h = F.relu_(self.bn5(self.fc2(h)))
        return self.fc3(h).reshape(-1, 3, 3) + torch.eye(3, dtype=h.dtype, device=h.device)


class _Feat(nn.Module):
    def __init__(self):
        super().__init__()
        self.stn = _STN3d()
        self.conv1, self.conv2, self.conv3 = _Conv1x1(3, 64), _Conv1x1(64, 128), _Conv1x1(128, 1024)
        self.bn1, self.bn2, self.bn3 = _FrozenBatchNorm(64), _FrozenBatchNorm(128), _FrozenBatchNorm(1024)

    def forward(self, x):  # (B, 3, N) -> (B, 1024)
        trans = self.stn(x)
        x = torch.einsum("bcn,bcd->bdn", x, trans)
        h = F.relu_(self.bn1(self.conv1(x)))
        h = F.relu_(self.bn2(self.conv2(h)))
        return self.bn3(self.conv3(h)).amax(dim=2)


class PointNetFeatures(nn.Module):
    """x: (B, 3, N) point clouds -> (B, 1024 + 512 + 256 + k) features.

    Weights are drawn uniformly in +-1/sqrt(fan_in) from `seed` (the role of the JAX
    package's init_pointnet_params: feature values then mean nothing, run times do);
    trained ones come from load_torch_state_dict or convert/jax_variables.py."""

    def __init__(self, k: int = 16, seed: int = 0):
        super().__init__()
        self.feat = _Feat()
        self.fc1, self.fc2, self.fc3 = nn.Linear(1024, 512), nn.Linear(512, 256), nn.Linear(256, k)
        self.bn1, self.bn2 = _FrozenBatchNorm(512), _FrozenBatchNorm(256)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (_Conv1x1, nn.Linear)):
                    bound = 1.0 / math.sqrt(m.weight.shape[1])
                    m.weight.copy_((torch.rand(m.weight.shape, generator=gen) * 2 - 1) * bound)
                    m.bias.copy_((torch.rand(m.bias.shape, generator=gen) * 2 - 1) * bound)
        self.requires_grad_(False).eval()

    def train(self, mode: bool = True):
        return super().train(False)  # frozen: the statistics are never updated

    @torch.no_grad()
    def forward(self, x):
        with full_float32():
            x1 = self.feat(x.float())
            x2 = F.relu_(self.bn1(self.fc1(x1)))
            x3 = F.relu_(self.bn2(self.fc2(x2)))
            x4 = self.fc3(x3)
        return torch.cat([x1, x2, x3, x4], dim=1)


def load_torch_state_dict(model: PointNetFeatures, path: str) -> PointNetFeatures:
    """Load a SpareNet-style classifier state dict from a local file (strict): Conv1d
    weights (O, I, 1) lose their last axis, `num_batches_tracked` entries are dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model_state_dict"):
        if isinstance(sd, dict) and wrapper in sd:
            sd = sd[wrapper]
    out = {}
    for key, val in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        out[key] = val[..., 0] if key.endswith("weight") and val.ndim == 3 else val
    model.load_state_dict(out, strict=True)
    return model


def build_pointnet(device="cuda", seed: int = 0, state_dict_path=None) -> PointNetFeatures:
    """A PointNetFeatures on `device`: seeded random weights, or a local state dict."""
    device = resolve_device(device)
    model = PointNetFeatures(seed=seed)
    if state_dict_path is not None:
        load_torch_state_dict(model, state_dict_path)
    return model.to(device)
