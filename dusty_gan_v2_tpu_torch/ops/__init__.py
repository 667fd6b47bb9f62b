"""Ops of the PyTorch port (counterparts of dusty_gan_v2_tpu/ops)."""

from .act import FusedLeakyReLU, fused_bias_act, fused_bias_act_cuda, fused_leaky_relu
from .blurconv import blur_conv1x1s2_ring, blur_conv3x3s2_ring, blur_conv_fusable
from .fourier import FourierFeature, fourier_out_ch
from .fused_chain import (
    fused_act_resample, fused_act_resample_bwd_plain, fused_act_resample_plain, fused_chain_bwd_cuda,
    fused_chain_fwd_cuda, fused_resample, fused_resample_plain,
)
from .gumbel import gumbel_sigmoid, sample_logistic
from .linear import EqualLRConv2d, EqualLRConvTranspose2d, EqualLRDense, RingConv2d
from .modconv import ModConv2d
from .normalize import minibatch_stddev, pixel_norm
from .pad import conv3x3_ring_fast, conv_ring_fast, convT4x4s2_ring_fast, filter2d, pad2d, pad_axis
from .resample import ResamplePlan, blur_vh, make_resample, resample, resample_sumsq, upfirdn2d
from .shift import circular_translate_w, fractional_wrap_lerp

__all__ = [
    "FusedLeakyReLU", "fused_bias_act", "fused_bias_act_cuda", "fused_leaky_relu",
    "blur_conv1x1s2_ring", "blur_conv3x3s2_ring", "blur_conv_fusable",
    "FourierFeature", "fourier_out_ch",
    "fused_act_resample", "fused_act_resample_bwd_plain", "fused_act_resample_plain", "fused_chain_bwd_cuda",
    "fused_chain_fwd_cuda", "fused_resample", "fused_resample_plain",
    "gumbel_sigmoid", "sample_logistic",
    "EqualLRConv2d", "EqualLRConvTranspose2d", "EqualLRDense", "RingConv2d", "ModConv2d", "minibatch_stddev", "pixel_norm",
    "conv3x3_ring_fast", "conv_ring_fast", "convT4x4s2_ring_fast", "filter2d", "pad2d", "pad_axis",
    "ResamplePlan", "blur_vh", "make_resample", "resample", "resample_sumsq", "upfirdn2d",
    "circular_translate_w", "fractional_wrap_lerp",
]
