"""The SqueezeSeg sim2real vertical of the port (counterpart of dusty_gan_v2_tpu/semseg):
SqueezeSeg V1/V2 with CAM and CRF-as-RNN, the losses, the kNN post-filter, the datasets,
the SqueezeNet Fire-weight init, and the training step (train_step.py)."""

from .common import setup_in_ch
from .crf_as_rnn import CRFRNN
from .datasets import GTALiDAR, GTALiDAR_GAN, KITTIRawFrontal
from .knn import knn2d
from .loss import cross_entropy, focal_loss, masked_seg_loss
from .pretrained_init import apply_squeezenet_fire_weights, load_squeezenet_v11
from .squeezeseg import CAM, SqueezeSegV1, SqueezeSegV2

__all__ = [
    "setup_in_ch",
    "CRFRNN",
    "GTALiDAR",
    "GTALiDAR_GAN",
    "KITTIRawFrontal",
    "knn2d",
    "cross_entropy",
    "focal_loss",
    "masked_seg_loss",
    "CAM",
    "SqueezeSegV1",
    "SqueezeSegV2",
    "apply_squeezenet_fire_weights",
    "load_squeezenet_v11",
]
