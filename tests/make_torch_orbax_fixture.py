"""Write tests/data/torch_orbax_tiny/, an orbax checkpoint directory of the JAX package,
and tests/data/torch_orbax_tiny.json, each leaf's path, dtype, shape and sha256 as the JAX
package's load_checkpoint restores it into the state's template (without a template,
orbax gives its scalars the shape (1,)).

    python tests/make_torch_orbax_fixture.py

The state is the tiny Trainer state of tests/test_trainer.py::tiny_cfg after its init,
with seeded Adam moments (count 3), ADA state and PL baseline, written by
dusty_gan_v2_tpu/training/checkpoint.py::save_checkpoint_orbax. The directory is what
the port's orbax reader is held to, on the CPU (tests/test_torch_orbax.py) and on the
card's host (chip_smoke.py phase 17), where neither JAX nor orbax is installed. This
script imports the JAX package, so it lives beside the tests; pytest does not collect it
(its name does not start with test_).
"""

import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from dusty_gan_v2_tpu.parallel import make_mesh  # noqa: E402
from dusty_gan_v2_tpu.training import Trainer  # noqa: E402
from dusty_gan_v2_tpu.training.checkpoint import (  # noqa: E402
    load_checkpoint, save_checkpoint_orbax, wait_for_checkpoints,
)

from test_trainer import RES, make_angle, tiny_cfg  # noqa: E402

OUT = HERE / "data" / "torch_orbax_tiny"
DIGESTS = HERE / "data" / "torch_orbax_tiny.json"
NUM_IMGS = 24


def seeded_state():
    """The tiny Trainer's initial state with seeded Adam moments, ADA state and PL baseline,
    and the trainer (for its angle)."""
    cfg = tiny_cfg()
    t = Trainer(cfg, mesh=make_mesh(jax.devices()[:1]), angle=make_angle(RES))
    st = jax.jit(t.init_state)(jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)

    def moments(opt):
        adam = opt[0]
        mu = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32) * 1e-3, adam.mu)
        nu = jax.tree_util.tree_map(lambda a: rng.rand(*a.shape).astype(np.float32) * 1e-5, adam.nu)
        return (adam._replace(count=jnp.asarray(3, jnp.int32), mu=mu, nu=nu),) + tuple(opt[1:])

    st = st.replace(step=jnp.asarray(3, jnp.int32), opt_G=moments(st.opt_G), opt_D=moments(st.opt_D),
                    ada=st.ada._replace(p=jnp.float32(0.25), sign_cum=jnp.float32(0.5), n_pred_cum=jnp.float32(8.0)),
                    pl_ema=jnp.float32(0.125))
    return cfg, t, st


def digests(tree, prefix=()):
    """[{"path": [...], "dtype", "shape", "sha256"} or {"path": [...], "empty": true}] of a
    restored nested dict, in sorted key order."""
    out = []
    for k in sorted(tree):
        v, path = tree[k], [*prefix, k]
        if isinstance(v, dict):
            out.extend(digests(v, path) if v else [{"path": path, "empty": True}])
        else:
            a = np.array(v, order="C")  # (np.ascontiguousarray would make a 0-d array 1-d)
            out.append({"path": path, "dtype": a.dtype.name, "shape": list(a.shape),
                        "sha256": hashlib.sha256(a.tobytes()).hexdigest()})
    return out


def main():
    import flax.serialization

    cfg, t, st = seeded_state()
    shutil.rmtree(OUT, ignore_errors=True)
    save_checkpoint_orbax(str(OUT), cfg, st, t.angle, NUM_IMGS)
    wait_for_checkpoints()
    restored = flax.serialization.to_state_dict(load_checkpoint(str(OUT), st)[1])  # restored into the template
    rows = digests(restored)
    assert rows == digests(flax.serialization.to_state_dict(st)), "the directory does not restore the state written"
    DIGESTS.write_text('{"num_imgs": %d, "leaves": [\n%s\n]}\n' % (NUM_IMGS, ",\n".join(json.dumps(r) for r in rows)))
    size = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"{OUT}: {size} bytes, {len(rows)} leaves; {DIGESTS}")


if __name__ == "__main__":
    main()
