"""The port's checkpoints against the JAX package's, on the CPU.

A checkpoint written by either package restores in the other, bit for
bit: the tree of the JAX package's own round-trip test (bf16, int32, a
scalar) and smoke h2o-danube-1.8b train states under AdamW and
Adafactor, filled with seeded numpy values, under both codecs (zstd, and
zlib by patching the writer's ``DEFAULT_CODEC``). The port's manifest
equals JAX's for the same tree but for ``created``, and its decompressed
shard is byte-equal to ``msgpack.packb(payload, use_bin_type=True)``.
The port's own msgpack codec is held against ``msgpack`` at every
header boundary, and the checkpoint module runs with ``msgpack``
blocked. Then the counterparts of the JAX package's checkpoint tests.
Every comparison is exact.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import msgpack
import zstandard

from repro.ckpt import checkpoint as jc
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.train.optimizer import Adafactor as JaxAdafactor
from repro.train.optimizer import AdamW as JaxAdamW
from repro.train.schedule import constant_schedule as jax_constant
from repro.train.train_step import init_train_state as jax_init_train_state
from repro_torch.ckpt import checkpoint as tc
from repro_torch.ckpt import msgpack_map as mm
from repro_torch.configs.registry import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.train.optimizer import Adafactor, AdamW
from repro_torch.train.schedule import constant_schedule
from repro_torch.train.train_step import init_train_state
from repro_torch.tree import tree_flatten_with_paths, tree_map

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
ARCH = "h2o-danube-1.8b"
TREES = ["infra", "adamw", "adafactor"]
CODECS = ["zstd", "zlib"]


def infra_tree():
    """The tree of ``tests/test_train_infra.py``'s round trip."""
    return {"a": jnp.arange(12).reshape(3, 4).astype(jnp.bfloat16),
            "b": {"c": jnp.ones((2,), jnp.int32)},
            "step": jnp.asarray(7)}


def seeded_like(tree, seed):
    """``tree``'s structure, shapes and dtypes with seeded numpy values."""
    rng = np.random.RandomState(seed)

    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return jnp.asarray(rng.randint(0, 1000, x.shape).astype(x.dtype))
        return jnp.asarray(rng.randn(*x.shape).astype(np.float32)).astype(x.dtype)

    return jax.tree.map(fill, tree)


def jax_tree(which):
    if which == "infra":
        return infra_tree()
    opt = (JaxAdamW if which == "adamw" else JaxAdafactor)(jax_constant(1e-3))
    state = jax_init_train_state(jax_smoke_config(ARCH), opt, jax.random.PRNGKey(0))
    return seeded_like(state, 3)


def to_port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def port_zeros(tree):
    """A port tree of ``tree``'s structure, every leaf a float32 zero:
    restore must take shapes and dtypes from the manifest."""
    return tree_map(lambda _: torch.zeros(()), to_port(tree))


def leaf_bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def assert_bit_equal(port_tree, jax_tree_):
    """Same keys in the same order, same dtype names and shapes, same bytes."""
    got = tree_flatten_with_paths(port_tree)
    want = jc._flatten_with_paths(jax_tree_)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, t), (_, j) in zip(got, want):
        j = np.asarray(j)
        assert tc._NAMES[t.dtype] == str(j.dtype), key
        assert list(t.shape) == list(j.shape), key
        assert leaf_bytes(t) == j.tobytes(), key


def read_manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def shard_payload(d, step, codec):
    """The shard's decompressed bytes, decompressed in one call as the
    JAX package does."""
    with open(os.path.join(d, f"step_{step:08d}", tc.SHARD), "rb") as f:
        blob = f.read()
    if codec == "zstd":
        return zstandard.ZstdDecompressor().decompress(blob)
    import zlib
    return zlib.decompress(blob)


# ---------------------------------------------------------------------------
# JAX -> port and port -> JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", TREES)
@pytest.mark.parametrize("codec", CODECS)
def test_jax_checkpoint_restores_bit_equal_in_the_port(tmp_path, monkeypatch, codec, which):
    monkeypatch.setattr(jc, "DEFAULT_CODEC", codec)
    tree = jax_tree(which)
    jc.save_checkpoint(str(tmp_path), 7, tree)
    assert read_manifest(tmp_path, 7)["codec"] == codec
    restored, step = tc.restore_checkpoint(str(tmp_path), port_zeros(tree))
    assert step == 7
    assert_bit_equal(restored, tree)
    assert all(t.device.type == "cpu" for _, t in tree_flatten_with_paths(restored))


@pytest.mark.parametrize("which", TREES)
@pytest.mark.parametrize("codec", CODECS)
def test_port_checkpoint_restores_bit_equal_in_jax(tmp_path, monkeypatch, codec, which):
    monkeypatch.setattr(tc, "DEFAULT_CODEC", codec)
    monkeypatch.setattr(jc, "DEFAULT_CODEC", codec)
    tree = jax_tree(which)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tc.save_checkpoint(port_dir, 7, to_port(tree))
    jc.save_checkpoint(jax_dir, 7, tree)

    restored, step = jc.restore_checkpoint(port_dir, jax.tree.map(jnp.zeros_like, tree))
    assert step == 7
    assert_bit_equal(to_port(restored), tree)

    mine, theirs = read_manifest(port_dir, 7), read_manifest(jax_dir, 7)
    mine.pop("created"), theirs.pop("created")
    assert mine == theirs
    payload = {k: np.asarray(v).tobytes() for k, v in jc._flatten_with_paths(tree)}
    raw = shard_payload(port_dir, 7, codec)
    assert raw == msgpack.packb(payload, use_bin_type=True)
    if codec == "zstd":   # the streamed frame carries its size
        with open(os.path.join(port_dir, "step_00000007", tc.SHARD), "rb") as f:
            assert zstandard.get_frame_parameters(f.read()).content_size == len(raw)


def test_port_keys_are_jax_checkpoint_keys():
    """AdamW: 37 leaves, Adafactor: 25, from ``opt_state/...`` to ``step``."""
    for opt, jopt, n in ((AdamW, JaxAdamW, 37), (Adafactor, JaxAdafactor, 25)):
        state = init_train_state(smoke_config(ARCH), opt(constant_schedule(1e-3)), 0, "cpu")
        jstate = jax_init_train_state(jax_smoke_config(ARCH), jopt(jax_constant(1e-3)),
                                      jax.random.PRNGKey(0))
        keys = [k for k, _ in tree_flatten_with_paths(state)]
        assert keys == [k for k, _ in jc._flatten_with_paths(jstate)]
        assert len(keys) == n and keys[-1] == "step"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_dump_reads_back_in_the_other_package(tmp_path, writer):
    dump = {"resource_version": 42, "objects": [
        {"kind": "ResourceClaim", "name": "train", "spec": {"count": 8}},
        {"kind": "Workload", "name": "train-job", "status": {"ready": True}}]}
    tree = infra_tree()
    if writer == "jax":
        jc.save_checkpoint(str(tmp_path), 3, tree, store_dump=dump)
        got = tc.load_store_dump(str(tmp_path))
    else:
        tc.save_checkpoint(str(tmp_path), 3, to_port(tree), store_dump=dump)
        got = jc.load_store_dump(str(tmp_path))
        other = tmp_path / "jax"
        jc.save_checkpoint(str(other), 3, tree, store_dump=dump)
        step_dir = tmp_path / "step_00000003"
        assert (step_dir / "store.json").read_bytes() == \
            (other / "step_00000003" / "store.json").read_bytes()
    assert got == dump
    assert read_manifest(tmp_path, 3)["store"] == {
        "file": "store.json", "resource_version": 42, "objects": 2}
    assert tc.load_store_dump(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# The msgpack subset
# ---------------------------------------------------------------------------

def packb(payload):
    """The port's packing of ``payload``, joined."""
    return b"".join(bytes(c) for c in mm.packed_chunks(len(payload), payload.items()))


def _payload(key_len=3, value_len=5, entries=1):
    return {(f"{i:0{key_len}d}" if entries > 1 else "k" * key_len): bytes(
        (i + j) % 251 for j in range(value_len)) for i in range(entries)}


CODEC_CASES = {
    # str: fixstr / str8 / str16 / str32 boundaries, and a multi-byte key
    **{f"key{n}": dict(key_len=n) for n in (0, 31, 32, 255, 256, 65535, 65536)},
    # bin: bin8 / bin16 / bin32 boundaries
    **{f"value{n}": dict(value_len=n) for n in (0, 255, 256, 65535, 65536)},
    # map: fixmap / map16 / map32 boundaries
    **{f"map{n}": dict(key_len=6, value_len=1, entries=n)
       for n in (15, 16, 65535, 65536)},
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_msgpack_codec_matches_msgpack_at_header_boundaries(case):
    payload = _payload(**CODEC_CASES[case])
    packed = packb(payload)
    assert packed == msgpack.packb(payload, use_bin_type=True)
    assert mm.packed_size([(k, len(v)) for k, v in payload.items()]) == len(packed)
    assert msgpack.unpackb(packed, raw=False) == payload
    theirs = mm.unpackb(msgpack.packb(payload, use_bin_type=True))
    assert list(theirs) == list(payload)
    assert {k: bytes(v) for k, v in theirs.items()} == payload


def test_msgpack_codec_takes_multibyte_keys():
    payload = {"é" * 20: b"x", "λ/μ": b"yz"}    # 40 bytes: str8, not fixstr
    assert packb(payload) == msgpack.packb(payload, use_bin_type=True)
    assert {k: bytes(v) for k, v in mm.unpackb(packb(payload)).items()} == payload


@pytest.mark.parametrize("bad", [
    msgpack.packb([1, 2]),                              # not a map
    msgpack.packb({"a": "text"}),                       # str value, not bin
    msgpack.packb({1: b"x"}),                           # int key
    msgpack.packb({"a": b"xyz"}, use_bin_type=True)[:-1],   # truncated
    msgpack.packb({"a": b"x"}, use_bin_type=True) + b"\x00",  # trailing
    b""])
def test_msgpack_codec_rejects_other_shards(bad):
    with pytest.raises(ValueError):
        mm.unpackb(bad)


def test_msgpack_codec_refuses_lengths_past_u32():
    with pytest.raises(ValueError):
        mm.bin_header(1 << 32)


def test_checkpoints_work_with_msgpack_blocked(tmp_path):
    code = f"""
import sys
sys.modules["msgpack"] = None
sys.path.insert(0, {str(SRC.parent)!r})
import torch
from repro_torch.ckpt import checkpoint as c
tree = {{"w": torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16),
         "n": {{"i": torch.tensor([1, 2], dtype=torch.int32)}}}}
for codec in ("zlib",) + (("zstd",) if c.zstandard is not None else ()):
    c.DEFAULT_CODEC = codec
    d = {str(tmp_path)!r} + "/" + codec
    c.save_checkpoint(d, 1, tree)
    out, step = c.restore_checkpoint(d, tree)
    assert step == 1 and torch.equal(out["w"], tree["w"]) and torch.equal(out["n"]["i"], tree["n"]["i"])
assert "jax" not in sys.modules and "repro" not in sys.modules
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_port_imports_no_msgpack_and_zstandard_only_as_the_codec():
    imp = re.compile(r"^\s*(import|from)\s+(msgpack|zstandard)(\.|\s|$)", re.M)
    found = {f.relative_to(SRC).as_posix(): sorted(m.group(2) for m in imp.finditer(f.read_text()))
             for f in SRC.rglob("*.py") if imp.search(f.read_text())}
    assert found == {"ckpt/checkpoint.py": ["zstandard"]}


# ---------------------------------------------------------------------------
# Counterparts of the JAX package's checkpoint tests
# ---------------------------------------------------------------------------

def port_tree():
    return to_port(infra_tree())


def test_roundtrip(tmp_path):
    tree = port_tree()
    tc.save_checkpoint(str(tmp_path), 7, tree)
    restored, step = tc.restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    for (k, a), (_, b) in zip(tree_flatten_with_paths(tree), tree_flatten_with_paths(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_commit_marker_crash_safety(tmp_path):
    tree = {"a": torch.ones(2, 2)}
    tc.save_checkpoint(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_00000002")         # a partial write
    os.makedirs(tmp_path / "step_00000003.tmp")     # a dying writer's temp dir
    (tmp_path / "step_00000003.tmp" / tc.COMMIT_MARKER).write_text("3")
    assert tc.list_checkpoints(str(tmp_path)) == [1]
    _, step = tc.restore_checkpoint(str(tmp_path), tree)
    assert step == 1
    assert tc.CheckpointManager(str(tmp_path)).latest_step() == 1


def test_rotation_and_async(tmp_path):
    tree = {"a": torch.ones(4)}
    mgr = tc.CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.wait()
    assert tc.list_checkpoints(str(tmp_path)) == [3, 4]
    assert jc.list_checkpoints(str(tmp_path)) == [3, 4]


@pytest.mark.parametrize("async_save", [True, False])
def test_save_snapshots_before_it_returns(tmp_path, async_save):
    tree = {"a": torch.arange(8, dtype=torch.float32), "s": torch.tensor(3, dtype=torch.int32)}
    mgr = tc.CheckpointManager(str(tmp_path), async_save=async_save)
    mgr.save(1, tree)
    tree["a"].add_(100.0)        # the trainer moves on in place
    tree["s"].fill_(9)
    out, _ = mgr.restore_latest(tree)
    assert torch.equal(out["a"], torch.arange(8, dtype=torch.float32))
    assert int(out["s"]) == 3


def test_wait_reraises_the_writer_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = tc.CheckpointManager(str(blocker), async_save=True)
    mgr.save(1, {"a": torch.ones(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()     # the error is raised once


def test_store_provider_is_sampled_at_save(tmp_path):
    version = [5]
    mgr = tc.CheckpointManager(str(tmp_path), async_save=True,
                               store_provider=lambda: {"resource_version": version[0],
                                                       "objects": []})
    mgr.save(1, {"a": torch.ones(2)})
    version[0] = 6
    mgr.wait()
    assert tc.load_store_dump(str(tmp_path))["resource_version"] == 5


def test_zstd_checkpoint_without_zstandard_raises_as_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jc, "DEFAULT_CODEC", "zstd")
    tree = infra_tree()
    jc.save_checkpoint(str(tmp_path), 1, tree)
    monkeypatch.setattr(tc, "zstandard", None)
    monkeypatch.setattr(jc, "zstandard", None)
    with pytest.raises(RuntimeError) as mine:
        tc.restore_checkpoint(str(tmp_path), port_zeros(tree))
    with pytest.raises(RuntimeError) as theirs:
        jc.restore_checkpoint(str(tmp_path), tree)
    assert str(mine.value) == str(theirs.value)


def test_restore_raises_on_a_missing_leaf_and_ignores_extra_ones(tmp_path):
    tree = port_tree()
    tc.save_checkpoint(str(tmp_path), 1, tree)
    out, _ = tc.restore_checkpoint(str(tmp_path), {"b": {"c": torch.zeros(())}})
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    with pytest.raises(KeyError, match="checkpoint missing leaf 'b/d'"):
        tc.restore_checkpoint(str(tmp_path), {"b": {"d": torch.zeros(())}})


def test_restore_raises_on_an_unknown_dtype_name(tmp_path):
    tc.save_checkpoint(str(tmp_path), 1, port_tree())
    path = tmp_path / "step_00000001" / "manifest.json"
    manifest = json.loads(path.read_text())
    manifest["leaves"][0]["dtype"] = "torch.bfloat16"
    path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="unknown checkpoint leaf dtype"):
        tc.restore_checkpoint(str(tmp_path), port_tree())


def test_manifest_names_numpy_dtypes(tmp_path):
    tree = {"b": torch.ones(2, dtype=torch.bfloat16), "f": torch.ones(2),
            "h": torch.ones(2, dtype=torch.float16), "i": torch.ones(2, dtype=torch.int16),
            "m": torch.ones(2, dtype=torch.bool), "u": torch.ones(2, dtype=torch.uint8)}
    tc.save_checkpoint(str(tmp_path), 1, tree)
    names = {e["key"]: e["dtype"] for e in read_manifest(tmp_path, 1)["leaves"]}
    assert names == {"b": "bfloat16", "f": "float32", "h": "float16", "i": "int16",
                     "m": "bool", "u": "uint8"}
    out, _ = jc.restore_checkpoint(str(tmp_path), {k: jnp.zeros(()) for k in tree})
    for k, v in tree.items():
        assert np.asarray(out[k]).tobytes() == leaf_bytes(v), k
    with pytest.raises(ValueError, match="no checkpoint dtype"):
        tc.save_checkpoint(str(tmp_path), 2, {"c": torch.ones(2, dtype=torch.complex64)})
