"""Plain ops of the reference."""

from .act import FusedLeakyReLU, fused_leaky_relu
from .chain import fused_act_resample, fused_resample
from .fourier import FourierFeature, fourier_out_ch
from .gumbel import gumbel_sigmoid, sample_logistic
from .linear import EqualLRConv2d, EqualLRConvTranspose2d, EqualLRDense, RingConv2d
from .modconv import ModConv2d
from .normalize import minibatch_stddev, pixel_norm
from .pad import conv_ring_fast, convT4x4s2_ring_fast, filter2d, pad2d, pad_axis
from .resample import ResamplePlan, blur_vh, make_resample, resample, resample_sumsq, upfirdn2d
from .shift import circular_translate_w, fractional_wrap_lerp

__all__ = [
    "FusedLeakyReLU", "fused_leaky_relu", "fused_act_resample", "fused_resample", "FourierFeature", "fourier_out_ch",
    "gumbel_sigmoid", "sample_logistic", "EqualLRConv2d", "EqualLRConvTranspose2d", "EqualLRDense", "RingConv2d",
    "ModConv2d", "minibatch_stddev", "pixel_norm", "conv_ring_fast", "convT4x4s2_ring_fast",
    "filter2d", "pad2d", "pad_axis", "ResamplePlan", "blur_vh", "make_resample", "resample", "resample_sumsq",
    "upfirdn2d", "circular_translate_w", "fractional_wrap_lerp",
]
