"""Generator ops of the PyTorch port (counterparts of dusty_gan_v2_tpu/ops)."""

from .act import FusedLeakyReLU, fused_bias_act, fused_bias_act_cuda, fused_leaky_relu
from .fourier import FourierFeature, fourier_out_ch
from .gumbel import gumbel_sigmoid, sample_logistic
from .linear import EqualLRDense
from .modconv import ModConv2d
from .normalize import pixel_norm
from .pad import pad_axis
from .resample import ResamplePlan, make_resample, resample

__all__ = [
    "FusedLeakyReLU", "fused_bias_act", "fused_bias_act_cuda", "fused_leaky_relu",
    "FourierFeature", "fourier_out_ch",
    "gumbel_sigmoid", "sample_logistic",
    "EqualLRDense", "ModConv2d", "pixel_norm", "pad_axis",
    "ResamplePlan", "make_resample", "resample",
]
