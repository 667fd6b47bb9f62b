"""The port's config module (dusty_gan_v2_tpu_torch/utils/config.py) against the JAX
package's: every file under configs/ read, and written, the same way; the save -> load
round trip; attribute access. Equality is exact and typed (an int is not a float, a
bool not an int)."""

import glob
import os

import pytest
import yaml

from dusty_gan_v2_tpu.utils import config as jconfig
from dusty_gan_v2_tpu_torch.utils.config import Config, load_config, save_config

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, _REPO) for p in glob.glob(os.path.join(_REPO, "configs", "*", "*.yaml")))


def assert_same(got, ref, where="root"):
    """Equal values of equal types, recursively (NaN equals NaN)."""
    assert type(got) is type(ref), (where, got, ref)
    if isinstance(ref, dict):
        assert list(got) == list(ref), where  # key order too: --dry_run prints in it
        for k in ref:
            assert_same(got[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{where}[{i}]")
    elif isinstance(ref, float) and ref != ref:
        assert got != got, where
    else:
        assert got == ref, (where, got, ref)


def test_all_eleven_configs_are_covered():
    assert len(CONFIGS) == 11


@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_equals_jax(path):
    full = os.path.join(_REPO, path)
    cfg = load_config(full)
    assert isinstance(cfg, Config)
    assert_same(cfg.to_dict(), jconfig.load_config(full).to_dict())


@pytest.mark.parametrize("path", CONFIGS)
def test_save_config_round_trip(path, tmp_path):
    cfg = load_config(os.path.join(_REPO, path))
    out, ref = tmp_path / "cfg.yaml", tmp_path / "jax.yaml"
    save_config(cfg, str(out))
    assert_same(load_config(str(out)).to_dict(), cfg.to_dict())
    # the same text as the JAX package writes for the same config
    jconfig.save_config(jconfig.load_config(os.path.join(_REPO, path)), str(ref))
    assert out.read_text() == ref.read_text()


def test_config_attribute_access_and_copy():
    cfg = Config({"training": {"loss": {"pl": 0}}, "heads": [{"a": 1}]})
    assert cfg.training.loss.pl == 0 and cfg.heads[0].a == 1
    assert cfg.get_path("training.loss.pl") == 0 and cfg.get_path("training.x.y", 5) == 5
    cfg.training.loss.pl = 2
    dup = cfg.copy()
    dup.training.loss.pl = 3
    assert cfg.training.loss.pl == 2 and isinstance(dup.training, Config)
    with pytest.raises(AttributeError):
        cfg.missing
    assert cfg.to_dict() == {"training": {"loss": {"pl": 2}}, "heads": [{"a": 1}]}
    assert type(cfg.to_dict()["training"]) is dict
