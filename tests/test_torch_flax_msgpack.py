"""The port's flax msgpack decoder and encoder (convert/flax_msgpack.py) against
flax.serialization on the CPU: every leaf type a checkpoint holds, byte for byte both
ways, a chunked array (flax's MAX_CHUNK_SIZE patched small) and a file read through
`load` whose tensors share the one buffer it read."""

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu_torch.convert import flax_msgpack


def _leaves():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 5).astype(np.float32),
        "f64": rng.randn(4).astype(np.float64),
        "bf16": np.asarray(jnp.asarray(rng.randn(2, 7), jnp.bfloat16)),
        "f16": rng.randn(6).astype(np.float16),
        "i32": rng.randint(-2**31, 2**31 - 1, (5,), dtype=np.int64).astype(np.int32),
        "i64": np.array([-2**40, 7], np.int64),
        "u8": rng.randint(0, 255, (3, 3)).astype(np.uint8),
        "u32": rng.randint(0, 2**32 - 1, (4,), dtype=np.uint64).astype(np.uint32),
        "bool": rng.rand(2, 3) > 0.5,
        "empty": np.zeros((0, 3), np.float32),
        "scalar0d": np.asarray(np.float32(2.5)),
        "np_f32": np.float32(-1.25),
        "np_i64": np.int64(2**40),
        "np_bool": np.bool_(True),
        "big_array": rng.randn(300).astype(np.float32),  # bin16 and ext16 heads
    }


def _header():
    return {
        "none": None, "t": True, "f": False, "float": 1.5, "neg": -5, "negfix": -20, "neg16": -300,
        "neg32": -70000, "neg64": -2**40, "u8": 200, "u16": 60000, "u32": 2**31, "u64": 2**63, "str": "x" * 40,
        "str8": "é" * 100, "bytes": b"\x00\x01ab", "long_list": list(range(20)), "nested": [1, [2, [3.5, "a"]]],
        "map16": {f"k{i:02d}": i for i in range(20)},
    }


def _check_equal(got, ref, where="tree"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), (where, sorted(got), sorted(ref))
        for k in ref:
            _check_equal(got[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            _check_equal(g, r, f"{where}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)):
        ref = np.asarray(ref)
        assert isinstance(got, torch.Tensor), (where, type(got))
        assert tuple(got.shape) == ref.shape, (where, got.shape, ref.shape)
        if ref.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, where
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), ref.view(np.int16), err_msg=where)
        else:
            assert got.dtype == flax_msgpack._DTYPES[ref.dtype.name], (where, got.dtype, ref.dtype)
            if ref.dtype.name in ("uint16", "uint32", "uint64"):  # no numpy() for these tensors
                np.testing.assert_array_equal(got.to(torch.int64).numpy(), ref.astype(np.int64), err_msg=where)
            else:
                np.testing.assert_array_equal(got.numpy(), ref, err_msg=where)
    else:
        assert type(got) is type(ref) and got == ref, (where, got, ref)


@pytest.mark.parametrize("part", ["leaves", "header"])
def test_decoder_reads_flax_bytes(part):
    tree = _leaves() if part == "leaves" else _header()
    blob = flax.serialization.msgpack_serialize(tree)
    _check_equal(flax_msgpack.loads(blob), flax.serialization.msgpack_restore(blob))


@pytest.mark.parametrize("part", ["leaves", "header"])
def test_encoder_writes_flax_bytes(part):
    tree = _leaves() if part == "leaves" else _header()
    assert flax_msgpack.dumps(tree) == flax.serialization.msgpack_serialize(tree)


def test_encoder_takes_tensors_and_tuples_as_flax_state_dicts():
    """Tensors (bfloat16 and uint32 too) encode as the numpy arrays they hold; a tuple
    (an optax chain state) as flax's to_state_dict maps it, {"0": ..., "1": ...}."""
    rng = np.random.RandomState(1)
    a32, ab = rng.randn(4, 3).astype(np.float32), np.asarray(jnp.asarray(rng.randn(5), jnp.bfloat16))
    au = rng.randint(0, 2**32 - 1, (3,), dtype=np.uint64).astype(np.uint32)
    tensors = {"a": torch.from_numpy(a32), "b": torch.from_numpy(ab.view(np.int16).copy()).view(torch.bfloat16),
               "u": torch.from_numpy(au.astype(np.int64)).to(torch.uint32), "opt": (torch.zeros(2), {"n": 3})}
    ref = {"a": a32, "b": ab, "u": au, "opt": flax.serialization.to_state_dict((np.zeros(2, np.float32), {"n": 3}))}
    assert flax_msgpack.dumps(tensors) == flax.serialization.msgpack_serialize(ref)


def test_chunked_array_both_ways(monkeypatch):
    """An array over MAX_CHUNK_SIZE bytes goes as flax's chunked map (the limit patched
    down to 64 bytes on both sides), at the top of a tree and inside it."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(2)
    tree = {"big": rng.randn(7, 11).astype(np.float32), "small": rng.randn(3).astype(np.float32),
            "deep": {"bf16": np.asarray(jnp.asarray(rng.randn(50), jnp.bfloat16))}}
    blob = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    _check_equal(flax_msgpack.loads(blob), flax.serialization.msgpack_restore(blob))
    assert flax_msgpack.dumps(tree) == blob
    top = rng.randn(40).astype(np.float32)
    assert flax_msgpack.dumps(top) == flax.serialization.msgpack_serialize(top)
    np.testing.assert_array_equal(flax_msgpack.loads(flax.serialization.msgpack_serialize(top)).numpy(), top)


def test_load_shares_one_buffer(tmp_path):
    """`load` reads the file once: its tensors are views of one buffer (nothing copied
    per array), and they are writable tensors of the right values."""
    tree = _leaves()
    path = tmp_path / "x.msgpack"
    with open(path, "wb") as f:
        flax_msgpack.dump(tree, f)
    assert path.read_bytes() == flax.serialization.msgpack_serialize(tree)
    got = flax_msgpack.load(str(path))
    _check_equal(got, flax.serialization.msgpack_restore(path.read_bytes()))
    starts = sorted(t.data_ptr() for t in got.values() if t.numel())
    assert starts[-1] - starts[0] < path.stat().st_size, "the arrays do not lie in one buffer"
    got["f32"].add_(1.0)  # writable: no read-only aliasing
    np.testing.assert_allclose(got["f32"].numpy(), tree["f32"] + 1.0)


def test_rejects_malformed_input():
    blob = flax.serialization.msgpack_serialize({"a": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(blob[:-3])
    with pytest.raises(ValueError, match="after the object"):
        flax_msgpack.loads(blob + b"\x00")
    with pytest.raises(TypeError, match="cannot write"):
        flax_msgpack.dumps({"a": object()})
