"""The port's training step against the JAX package's with ADA's full policy on the CPU:
imgfilter, noise and cutout on as well, which the shipped configs leave off (as
tests/test_trainer.py::TestFullPolicyStep does for the JAX step alone). The method and
bars are tests/test_torch_trainer.py's."""

import pytest

from dusty_gan_v2_tpu.utils.config import Config

from test_torch_trainer import JaxSide, _cfg, _compare_step, _one_torch_thread, _pre_state  # noqa: F401 (autouse)


def test_step_with_full_ada_policy_matches_jax():
    """imgfilter, noise and cutout on (H > 21 for imgfilter's reflect pad), every
    iteration an R1 + ADA + warmup step: one compiled variant for both pre-steps and the
    compared step."""
    res = (32, 64)
    cfg = _cfg(imgfilter=1, noise=1, cutout=1)
    cfg.training.lazy = Config({"gp": 1, "pl": 1, "ada": 1})
    cfg.model.generator.synthesis_kwargs.resolution = list(res)
    cfg.model.discriminator.layer_kwargs.resolution = list(res)
    mp = pytest.MonkeyPatch()
    try:
        side = JaxSide(cfg, res, mp)
        side.pre = _pre_state(side)
        _compare_step(side, 2, cfg, res)
    finally:
        mp.undo()
