"""Orbax checkpoint directories in the port (the JAX CLI's --ckpt_backend orbax), against
zstandard, tensorstore, orbax and the JAX package on the CPU.

- convert/zstd.py: the port's decoder (csrc/zstd_decode.cpp) equals zstandard's output on
  levels 1, 3 and 19 (and a fast negative level), empty / small / multi-block inputs of
  random, repetitive, float32-weight and text bytes, with and without a content size and a
  checksum, streamed frames, frames back to back and skippable frames; the raw-block
  writer reads back in zstandard; corrupt frames raise.
- convert/ocdbt.py and convert/zarr2.py against tensorstore: a B-tree four levels deep
  (a small max_decoded_node_bytes), indirect values, more versions than the manifest
  holds inline; zarr arrays of every supported dtype in several chunks with edge chunks
  and missing chunks; what the port writes, read by tensorstore.
- The JAX package's save_checkpoint_orbax of the tiny Trainer state (seeded Adam moments,
  ADA state, PL baseline) reads bit-equal to the port's read of JAX's msgpack file of the
  same state, empty optax states included, and into a port TrainState bit-equal; the
  port's save_checkpoint_orbax restores in the JAX package's load_checkpoint with and
  without a template, bit-equal. The committed fixture (tests/data/torch_orbax_tiny,
  tests/make_torch_orbax_fixture.py) matches its digests.
- train_gan --ckpt_backend orbax and --resume from its directory give the uninterrupted
  run's rows and final state bit for bit; autoload_ckpt, quick_demo and test_gan take
  the directory. A corrupted node, a missing key, an unknown dtype and a failed
  background write raise.
"""

import hashlib
import json
import os
import shutil
from pathlib import Path

import flax.serialization
import jax
import numpy as np
import pytest
import tensorstore as ts
import torch
import yaml
import zstandard

from dusty_gan_v2_tpu.training.checkpoint import load_checkpoint as j_load_checkpoint
from dusty_gan_v2_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
from dusty_gan_v2_tpu.training.checkpoint import save_checkpoint_orbax as j_save_checkpoint_orbax
from dusty_gan_v2_tpu.training.checkpoint import wait_for_checkpoints as j_wait_for_checkpoints
from dusty_gan_v2_tpu_torch.cli import quick_demo
from dusty_gan_v2_tpu_torch.cli import test_gan as port_test_gan
from dusty_gan_v2_tpu_torch.cli import train_gan as port_train_gan
from dusty_gan_v2_tpu_torch.convert import flax_msgpack, ocdbt, orbax, zarr2, zstd
from dusty_gan_v2_tpu_torch.pretrained import autoload_ckpt
from dusty_gan_v2_tpu_torch.training import Trainer
from dusty_gan_v2_tpu_torch.training import checkpoint as pckpt
from dusty_gan_v2_tpu_torch.training.checkpoint import (
    checkpoint_format, load_checkpoint, save_checkpoint_orbax, state_payload, wait_for_checkpoints,
)

from make_torch_orbax_fixture import DIGESTS, NUM_IMGS, OUT as FIXTURE, seeded_state
from test_torch_gan_e2e import B, _assert_equal_trees, kitti_root, tiny_cfg  # noqa: F401  (a fixture)

PORT_DIR = Path(__file__).resolve().parent.parent / "dusty_gan_v2_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ zstd
def _inputs():
    rng = np.random.RandomState(0)
    return {
        "empty": b"", "small": b"hello, zstd", "random": rng.bytes(300_000),
        "repetitive": b"abcabcabd" * 40_000 + bytes(50_000),
        "f32_weights": (rng.randn(160_000) * 0.02).astype(np.float32).tobytes(),
        "text": (PORT_DIR / "csrc" / "zstd_decode.cpp").read_bytes() * 4,
    }


def test_zstd_decoder_matches_zstandard():
    """Every level, input and frame form: the port's decoder gives zstandard's bytes, and
    zstandard reads the port's raw-block frames."""
    inputs = _inputs()
    for level in (1, 3, 19, -3):
        for name, data in inputs.items():
            for size, check in ((True, False), (False, True), (True, True), (False, False)):
                frame = zstandard.ZstdCompressor(level=level, write_content_size=size,
                                                 write_checksum=check).compress(data)
                assert bytes(zstd.decompress(frame)) == data, (level, name, size, check)
                assert zstd.content_size(frame) == (len(data) if size else None)
            co = zstandard.ZstdCompressor(level=level).compressobj()  # a streamed frame of several blocks
            frame = b"".join([co.compress(data[i : i + 50_000]) for i in range(0, len(data), 50_000)] + [co.flush()])
            assert bytes(zstd.decompress(frame)) == data, (level, name, "streamed")
    a, b = inputs["repetitive"], inputs["f32_weights"]
    skippable = (0x184D2A5E).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    both = zstandard.ZstdCompressor(level=3).compress(a) + skippable + zstandard.ZstdCompressor(level=1).compress(b)
    assert bytes(zstd.decompress(both)) == a + b and zstd.content_size(both) == len(a) + len(b)
    out = bytearray(len(a) + len(b))
    assert zstd.decompress_into(both, out) == len(out) and out == a + b
    for name, data in inputs.items():
        raw = zstd.compress_raw(data)
        assert len(raw) == len(data) + 13 + 3 * max(1, -(-len(data) // zstd.BLOCK_MAX)), name
        assert zstandard.ZstdDecompressor().decompress(raw) == data, name
        assert bytes(zstd.decompress(raw)) == data, name


def test_zstd_rejects_corrupt_frames(monkeypatch, tmp_path):
    data = _inputs()["f32_weights"]
    good = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    bad_checksum = good[:-1] + bytes([good[-1] ^ 1])
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bad_checksum)
    magic = b"\x28\xb5\x2f\xfd"
    # single segment, a 1-byte dictionary id 7, content size 3, a last raw block "abc"
    with pytest.raises(ValueError, match="dictionar"):
        zstd.decompress(magic + bytes([0x21, 0x07, 0x03, 0x19, 0, 0]) + b"abc")
    assert zstd.decompress(magic + bytes([0x21, 0x00, 0x03, 0x19, 0, 0]) + b"abc") == b"abc"  # id 0: none
    with pytest.raises(ValueError, match="reserved block type"):
        zstd.decompress(magic + bytes([0x20, 0x03, 0x1F, 0, 0]))
    with pytest.raises(ValueError, match="truncated|past|end"):
        zstd.decompress(good[: len(good) // 2])
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"not a zstd frame")
    with pytest.raises(zstd.OutputTooSmall, match="larger than the buffer"):
        zstd.decompress_into(good, bytearray(len(data) - 1))
    corrupt = bytearray(good)
    corrupt[len(good) // 3] ^= 0x5A
    with pytest.raises(ValueError):
        zstd.decompress(bytes(corrupt))
    # the decoder is built from the repository's source; a source that does not compile raises
    bad = tmp_path / "zstd_decode.cpp"
    bad.write_text("int zstd_decompress( {\n")
    monkeypatch.setattr(zstd, "SOURCE", bad)
    monkeypatch.setattr(zstd, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        zstd.library()


def test_port_loads_no_system_zstd():
    """The decoder is the repository's: no module of the port finds or loads a system
    libzstd (ctypes.util.find_library, a libzstd path)."""
    for path in PORT_DIR.rglob("*.py"):
        text = path.read_text()
        assert "find_library" not in text and "libzstd" not in text, path
    assert zstd.library()._name.startswith(str(PORT_DIR / "_build" / "libdusty_zstd-"))


# ------------------------------------------------------------------ OCDBT and zarr
def _ts_kv(root, **config):
    spec = {"driver": "ocdbt", "base": f"file://{os.path.abspath(root)}/"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def test_ocdbt_and_zarr_match_tensorstore(tmp_path):
    # a deep B-tree with inline and indirect values, written over 41 versions (16 inline)
    deep = tmp_path / "deep"
    kv = _ts_kv(deep, max_decoded_node_bytes=200, max_inline_value_bytes=20)
    for i in range(40):
        kv.write(f"key{i:03d}/abc", (b"v%d" % i) * (i % 9 + 1)).result()
    db = ocdbt.Database(deep)
    want = {k: kv.read(k).result().value for k in kv.list().result()}
    assert len(want) == 40 and {k: db.get(k) for k in db.keys()} == want
    assert db.generation == 41 and db.config["max_decoded_node_bytes"] == 200
    # zarr v2 arrays in chunks with edge chunks, every supported dtype, a missing chunk
    import ml_dtypes

    rng = np.random.RandomState(1)
    arrays = {
        "f4": (rng.randn(37, 53).astype(np.float32), [8, 16]), "i8": (rng.randint(-9, 9, (5, 7, 3)), [2, 3, 2]),
        "b1": (rng.rand(11) > 0.5, [4]), "bf16": (rng.randn(9, 4).astype(ml_dtypes.bfloat16), [4, 4]),
        "f8": (np.full((), 3.5), []), "u4": (rng.randint(0, 2**31, 6).astype(np.uint32), [6]),
        "i4": (rng.randint(-9, 9, 10).astype(np.int32), [3]),
    }
    store = tmp_path / "zarr"
    for name, (a, chunks) in arrays.items():
        dtype = "bfloat16" if a.dtype == ml_dtypes.bfloat16 else a.dtype.str
        t = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{store}/", "path": name + "/"},
                     "metadata": {"shape": list(a.shape), "chunks": chunks, "dtype": dtype,
                                  "compressor": {"id": "zstd", "level": 3}, "dimension_separator": "."},
                     "create": True}).result()
        if name == "i4":  # chunk 1 of 4 is never written: it reads as the fill value
            t[0:3], t[6:10] = a[0:3], a[6:10]
            a[3:6] = 0
        else:
            t[...] = a
    db = ocdbt.Database(store)
    assert zarr2.chunk_key("i4", (1,)) not in db and zarr2.chunk_key("f4", (4, 3)) in db
    tensors = {}
    for name, (a, _) in arrays.items():
        got = zarr2.read_array(db, name)
        want = (torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) if name == "bf16"
                else torch.from_numpy(np.asarray(a)))
        assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want), name
        tensors[name] = got
    # the port's writer, read by tensorstore as a key-value store and as zarr arrays
    out = tmp_path / "port"
    entries = {b"small": b"x" * 1024, b"large": [b"y" * 600, memoryview(rng.bytes(600))]}
    for name, t in tensors.items():
        entries.update(zarr2.encode_array(name, t))
    stats = ocdbt.write_database(out, entries)
    kv = _ts_kv(out)
    assert sorted(kv.list().result()) == sorted(entries) == ocdbt.Database(out).keys()
    assert kv.read(b"small").result().value == b"x" * 1024
    assert kv.read(b"large").result().value == b"y" * 600 + bytes(entries[b"large"][1])
    assert stats["num_keys"] == len(entries)
    for name, (a, _) in arrays.items():
        r = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{out}/", "path": name + "/"}}
                    ).result().read().result()
        assert r.dtype == a.dtype and r.shape == a.shape and r.tobytes() == np.asarray(a).tobytes(), name
    assert json.loads(kv.read(b"f4/.zarray").result().value)["chunks"] == [37, 53]


# ------------------------------------------------------------------ the JAX package's directories
@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """The seeded tiny Trainer state written by the JAX package as an orbax directory and
    as a msgpack file."""
    cfg, t, st = seeded_state()
    tmp = tmp_path_factory.mktemp("jax_orbax")
    j_save_checkpoint_orbax(str(tmp / "ckpt_dir"), cfg, st, t.angle, NUM_IMGS)
    j_wait_for_checkpoints()
    j_save_checkpoint(str(tmp / "ckpt_file"), cfg, st, t.angle, NUM_IMGS)
    return tmp, st, t


def _assert_same_tree(a, b, where="state"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (where, sorted(a), sorted(b))
        for k in b:
            _assert_same_tree(a[k], b[k], f"{where}.{k}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), where


def test_jax_directory_reads_as_its_msgpack_file(jax_written):
    """The port reads JAX's directory as the msgpack file of the same state, every leaf
    bit-equal, the empty optax states as empty dicts; both load into a port TrainState
    the same, Adam's moments included."""
    tmp, _, t = jax_written
    d, f = str(tmp / "ckpt_dir"), str(tmp / "ckpt_file")
    assert checkpoint_format(d) == "orbax" and checkpoint_format(f) == "msgpack"
    tree = orbax.read_item(tmp / "ckpt_dir" / "state")
    ref = flax_msgpack.load(f)["state"]
    _assert_same_tree(tree, ref)
    assert tree["opt_G"]["1"] == {} and tree["opt_D"]["1"] == {}
    cfg_d, plain_d, angle_d, n_d = load_checkpoint(d)
    cfg_f, plain_f, angle_f, n_f = load_checkpoint(f)
    assert cfg_d.to_dict() == cfg_f.to_dict() and n_d == n_f == NUM_IMGS and torch.equal(angle_d, angle_f)
    _assert_equal_trees(plain_d, plain_f, "plain")
    np.testing.assert_array_equal(angle_d.numpy(), np.asarray(t.angle))
    template = lambda: Trainer(cfg_d.to_dict(), device="cpu", angle=angle_d).init_state(seed=9)  # noqa: E731
    st_d, st_f = load_checkpoint(d, template())[1], load_checkpoint(f, template())[1]
    assert st_d.step == 3 and float(st_d.pl_ema) == 0.125
    _assert_equal_trees(state_payload(st_d), state_payload(st_f), "template")


def test_port_directory_restores_in_jax(jax_written, tmp_path):
    """save_checkpoint_orbax of the port's TrainState restores in the JAX package's
    load_checkpoint, into a template and without one, every leaf equal to the JAX state."""
    tmp, js, _ = jax_written
    cfg, _, angle, num_imgs = load_checkpoint(str(tmp / "ckpt_file"))
    st = load_checkpoint(str(tmp / "ckpt_file"), Trainer(cfg.to_dict(), device="cpu", angle=angle).init_state(seed=9))[1]
    out = tmp_path / "port_dir.ckpt"
    save_checkpoint_orbax(str(out), cfg, st, angle, num_imgs)
    wait_for_checkpoints()
    assert sorted(p.name for p in out.iterdir()) == ["meta.msgpack", "state"] and not out.with_name(
        out.name + ".tmp").exists()
    ref = flax.serialization.to_state_dict(js)
    ref_leaves = dict(jax.tree_util.tree_leaves_with_path(ref))
    for template in (js, None):
        jcfg, jstate, jangle, jn = j_load_checkpoint(str(out), template)
        assert jn == num_imgs and jcfg.to_dict() == cfg.to_dict()
        np.testing.assert_array_equal(np.asarray(jangle), angle.numpy())
        got = jax.tree_util.tree_leaves_with_path(
            flax.serialization.to_state_dict(jstate) if template is not None else jstate)
        assert len(got) == len(ref_leaves) == 268
        for p, a in got:
            want = np.asarray(ref_leaves[p])
            a = np.asarray(a)
            assert a.dtype == want.dtype and a.shape == want.shape, jax.tree_util.keystr(p)
            np.testing.assert_array_equal(a, want, err_msg=jax.tree_util.keystr(p))
    # and the port reads its own directory back as JAX's
    _assert_same_tree(orbax.read_item(out / "state"), orbax.read_item(tmp / "ckpt_dir" / "state"))


def test_committed_fixture_matches_its_digests():
    """tests/data/torch_orbax_tiny, written by the JAX package, read by the port: every
    leaf's dtype, shape and sha256 as the fixture's JSON records them."""
    tree = orbax.read_item(FIXTURE / "state")
    rows = json.loads(DIGESTS.read_text())["leaves"]
    assert len(rows) == 270 and sum(1 for r in rows if r.get("empty")) == 2
    for row in rows:
        v = tree
        for k in row["path"]:
            v = v[k]
        if row.get("empty"):
            assert v == {}, row["path"]
            continue
        assert str(v.dtype).removeprefix("torch.") == row["dtype"] and list(v.shape) == row["shape"], row["path"]
        assert hashlib.sha256(v.contiguous().reshape(-1).view(torch.uint8).numpy()).hexdigest() == row["sha256"]
    cfg, _, angle, num_imgs = load_checkpoint(str(FIXTURE))
    assert num_imgs == json.loads(DIGESTS.read_text())["num_imgs"] and angle.shape == (1, 2, 8, 64)
    assert max(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file()) < 2**20


def test_corrupt_directories_and_failed_writes_raise(tmp_path, monkeypatch):
    """No partial state: a node that fails its crc32c, a missing key, an unknown dtype, a
    directory without meta.msgpack; a background write that fails raises at
    wait_for_checkpoints() and at the next save."""
    copy = tmp_path / "copy.ckpt"
    shutil.copytree(FIXTURE, copy)
    node = next(p for p in sorted((copy / "state" / "d").iterdir()))
    raw = bytearray(node.read_bytes())
    raw[20] ^= 0x01
    node.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        load_checkpoint(str(copy))
    db = ocdbt.Database(FIXTURE / "state")
    with pytest.raises(KeyError, match="no key"):
        db.get(b"params_G.missing/.zarray")
    with pytest.raises(ValueError, match="unsupported dtype"):
        zarr2.parse_zarray(b'{"zarr_format": 2, "dtype": ">f4", "shape": [], "chunks": []}', "x")
    meta = json.loads((FIXTURE / "state" / "_METADATA").read_text())
    meta["tree_metadata"]["('missing',)"] = {"key_metadata": [{"key": "missing", "key_type": 2}],
                                             "value_metadata": {"value_type": "jax.Array"}}
    other = tmp_path / "other"
    shutil.copytree(FIXTURE / "state", other / "state")
    (other / "state" / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(KeyError, match="missing"):
        orbax.read_item(other / "state")
    with pytest.raises(ValueError, match="meta.msgpack"):
        load_checkpoint(str(other))
    # a failed background write
    cfg, _, angle, num_imgs = load_checkpoint(str(FIXTURE))
    st = load_checkpoint(str(FIXTURE), Trainer(cfg.to_dict(), device="cpu", angle=angle).init_state(seed=9))[1]
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    save_checkpoint_orbax(str(blocker / "ckpt"), cfg, st, angle, num_imgs)
    with pytest.raises(OSError):
        wait_for_checkpoints()
    wait_for_checkpoints()  # the error was raised once
    calls = []
    monkeypatch.setattr(pckpt.orbax, "write_item", lambda *a: calls.append(1) or 1 / 0)
    save_checkpoint_orbax(str(tmp_path / "x.ckpt"), cfg, st, angle, num_imgs)
    pckpt._pending[0].exception()  # the write has failed
    with pytest.raises(ZeroDivisionError):  # raised by the next save, which writes nothing
        save_checkpoint_orbax(str(tmp_path / "y.ckpt"), cfg, st, angle, num_imgs)
    save_checkpoint_orbax(str(tmp_path / "z.ckpt"), cfg, st, angle, num_imgs)
    with pytest.raises(ZeroDivisionError):
        wait_for_checkpoints()
    assert len(calls) == 2 and not any((tmp_path / f"{n}.ckpt").exists() for n in "xyz")


# ------------------------------------------------------------------ the command lines
def test_train_gan_orbax_resume_and_readers(kitti_root, tmp_path):  # noqa: F811
    """train_gan --ckpt_backend orbax writes directories and trains as the default run does;
    --resume from the middle directory gives the rows of a resume from the default run's
    middle file and the uninterrupted run's final state, bit for bit. autoload_ckpt,
    quick_demo and test_gan read the directory as they read the port's own file."""
    cfg_path = tmp_path / "gan.yaml"
    cfg_path.write_text(yaml.safe_dump(tiny_cfg(kitti_root)))
    common = ["--config", str(cfg_path), "--num_workers", "2", "--device", "cpu"]
    _, state_a = port_train_gan.main(common + ["--log_dir", str(tmp_path / "a"), "--ckpt_backend", "orbax"])
    _, state_f = port_train_gan.main(common + ["--log_dir", str(tmp_path / "f")])
    models = tmp_path / "a" / "models"
    names = sorted(p.name for p in models.iterdir())
    assert names == [f"checkpoint_{2 * B:010d}.ckpt", f"checkpoint_{4 * B:010d}.ckpt"], names
    assert all(p.is_dir() and checkpoint_format(str(p)) == "orbax" for p in models.iterdir())
    _, state_b = port_train_gan.main(common + ["--log_dir", str(tmp_path / "b"), "--resume", str(models / names[0])])
    _, state_c = port_train_gan.main(common + ["--log_dir", str(tmp_path / "c"), "--resume",
                                               str(tmp_path / "f" / "models" / names[0])])

    def rows(k):
        return [{n: v for n, v in json.loads(x).items() if n != "stats/imgs_per_sec"}
                for x in (tmp_path / k / "stats.jsonl").read_text().splitlines()]

    assert rows("a") == rows("f") and [r["iteration"] for r in rows("b")] == [3, 4] and rows("b") == rows("c")
    for st in (state_f, state_b, state_c):
        _assert_equal_trees(state_payload(st), state_payload(state_a), "final")
    final = models / names[1]
    own = tmp_path / "own.ckpt"
    cfg, _, angle, num_imgs = load_checkpoint(str(final))
    pckpt.save_checkpoint(str(own), cfg, state_a, angle, num_imgs)
    a, b = autoload_ckpt(str(final), "cpu"), autoload_ckpt(str(own), "cpu")
    assert a["step"] == b["step"] == 4 * B and torch.equal(a["angle"], b["angle"])
    _assert_equal_trees(a["G_ema"].state_dict(), b["G_ema"].state_dict(), "G_ema")
    _assert_equal_trees(a["G_ema"].state_dict(), state_a.G_ema.state_dict(), "G_ema")
    q = {k: quick_demo.main(["--ckpt_path", str(p), "--out", str(tmp_path / f"{k}.png"), "--batch_size", "4",
                             "--device", "cpu"]) for k, p in (("dir", final), ("file", own))}
    assert (tmp_path / "dir.png").read_bytes() == (tmp_path / "file.png").read_bytes(), q
    scores = {k: port_test_gan.main(["--ckpt_path", str(p), "--metrics", "jsd", "--num_samples", "16",
                                     "--num_subsample", "16", "--batch_size", "8", "--pairwise_batch", "8",
                                     "--dataset_root", str(kitti_root), "--device", "cpu"])[0]
              for k, p in (("dir", final), ("file", own))}
    assert scores["dir"] == scores["file"], scores
