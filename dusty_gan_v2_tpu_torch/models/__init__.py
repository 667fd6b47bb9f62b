"""Generator models of the PyTorch port (counterparts of dusty_gan_v2_tpu/models)."""

from .builder import build_generator
from .dusty_v1 import apply_raydrop
from .dusty_v2 import Generator, build_pe_cache
from .heads import resolve_act

__all__ = ["build_generator", "apply_raydrop", "Generator", "build_pe_cache", "resolve_act"]
