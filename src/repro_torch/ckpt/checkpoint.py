"""Compressed, async checkpointing in the JAX package's on-disk format.

The port of the JAX package's ``ckpt/checkpoint.py``. A checkpoint
written by either package restores in the other. Layout (one directory
per step):

  step_000100/
    manifest.json        # step, leaves (key, shape, dtype), created, codec
    store.json           # optional: control-plane ApiStore dump
    shard_00000.msgpack.zst   # msgpack map {key: leaf bytes}, compressed
    _COMMITTED           # written last: crash-safe commit marker

A checkpoint is readable iff _COMMITTED exists; partial writes from a
dying trainer are ignored by restore. The directory is written as
``step_%08d.tmp`` and renamed.

What the format fixes, and the port keeps:

* keys are the dict path joined by ``/``, in sorted-key order
  (:func:`repro_torch.tree.tree_flatten_with_paths`);
* dtype names are numpy's (``"bfloat16"``, ``"float32"``, ``"int32"``),
  the bytes the tensor's own, little-endian; bf16 is its raw 2-byte bits;
* the shard is what ``msgpack.packb(payload, use_bin_type=True)`` writes
  (:mod:`.msgpack_map`; the port needs no ``msgpack``), compressed with
  the codec the manifest names: ``"zstd"`` when ``zstandard`` imports,
  else ``"zlib"``. Restore uses the manifest's codec whatever this
  process prefers.

The shard is streamed, leaf by leaf, into the compressor; a zstd frame
carries the payload's size in its header (the JAX package decompresses
it in one call, which needs that size).

A sharded state (``DTensor`` leaves, training under a mesh) is saved in
the same format: every rank gathers each leaf with ``full_tensor()``, in
the same order, on the calling thread, and rank 0 alone writes. Restore
reads the full leaf on every rank and places it back on the ``tree_like``
leaf's mesh and placements (``distribute_tensor``), so a checkpoint
restores sharded or unsharded whichever way it was written.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..tree import tree_flatten_with_paths, tree_leaves, tree_map, tree_unflatten
from .msgpack_map import packed_chunks, packed_size, unpackb

try:
    import zstandard
except ImportError:  # optional dep: fall back to stdlib zlib
    zstandard = None

__all__ = ["COMMIT_MARKER", "DEFAULT_CODEC", "save_checkpoint",
           "list_checkpoints", "load_store_dump", "restore_checkpoint",
           "CheckpointManager"]

COMMIT_MARKER = "_COMMITTED"
SHARD = "shard_00000.msgpack.zst"

# Preferred codec is recorded in the manifest so restore always uses the
# codec the checkpoint was written with, whatever this process has.
DEFAULT_CODEC = "zstd" if zstandard is not None else "zlib"

# numpy's dtype names, as the manifest stores them
DTYPES: Dict[str, torch.dtype] = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}

_CHUNK = 64 << 20   # bytes handed to the compressor, or read, at a time


def _dtype_name(t: torch.Tensor) -> str:
    try:
        return _NAMES[t.dtype]
    except KeyError:
        raise ValueError(f"no checkpoint dtype for {t.dtype}; "
                         f"known: {sorted(DTYPES)}") from None


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown checkpoint leaf dtype {name!r}; "
                         f"known: {sorted(DTYPES)}") from None


def _gathered(tree: Any) -> Tuple[Any, bool]:
    """``tree`` with every ``DTensor`` leaf gathered into its full tensor
    (a collective: every rank calls this on the same tree), and whether
    there was one."""
    sharded = any(isinstance(t, DTensor) for t in tree_leaves(tree))
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t,
                    tree), sharded


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _writer(sharded: bool) -> bool:
    """Whether this process writes a checkpoint: every process for an
    unsharded tree, rank 0 alone for a gathered sharded one."""
    return not (sharded and _grouped() and dist.get_rank() != 0)


def _host_bytes(leaf: torch.Tensor) -> Any:
    """The leaf's bytes as a flat uint8 array on the host (a view where
    the leaf is already a contiguous CPU tensor)."""
    t = leaf.detach().to("cpu").contiguous()
    return t.reshape(-1).view(torch.uint8).numpy()


def _write_compressed(path: str, chunks: Iterator[Any], size: int,
                      codec: str, level: int) -> None:
    with open(path, "wb") as f:
        if codec == "zstd":
            # size= puts the content size in the frame header
            with zstandard.ZstdCompressor(level=level).stream_writer(
                    f, size=size, closefd=False) as w:
                for c in chunks:
                    w.write(c)
        elif codec == "zlib":
            z = zlib.compressobj(level)
            for c in chunks:
                mv = memoryview(c).cast("B")
                for i in range(0, len(mv), _CHUNK):
                    f.write(z.compress(mv[i:i + _CHUNK]))
            f.write(z.flush())
        else:
            raise ValueError(f"unknown checkpoint codec {codec!r}")


def _read_decompressed(path: str, codec: str) -> bytearray:
    """The shard's packed payload, in a writable buffer."""
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with zstd but the 'zstandard' "
                "module is not installed")
        d = zstandard.ZstdDecompressor().decompressobj()
    elif codec == "zlib":
        d = zlib.decompressobj()
    else:
        raise ValueError(f"unknown checkpoint codec {codec!r}")
    out = bytearray()
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            out += d.decompress(chunk)
    if codec == "zlib":
        out += d.flush()
        if not d.eof:
            raise ValueError(f"truncated zlib stream in {path}")
    return out


def save_checkpoint(directory: str, step: int, tree: Any,
                    compress_level: int = 3,
                    store_dump: Optional[Dict[str, Any]] = None) -> str:
    """Write one committed checkpoint of ``tree`` (a nested dict of
    tensors, on any device; ``DTensor`` leaves are gathered, and then
    rank 0 alone writes); returns its path.

    ``store_dump`` (a control-plane store dump dict) lands as
    ``store.json`` and is referenced from the manifest, making the
    control plane's object state part of the atomic commit.
    """
    path = os.path.join(directory, f"step_{step:08d}")
    tree, sharded = _gathered(tree)
    if not _writer(sharded):
        return path
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    leaves = tree_flatten_with_paths(tree)
    manifest = {"step": step, "leaves": [], "created": time.time(),
                "codec": DEFAULT_CODEC}
    sizes = []
    for key, leaf in leaves:
        manifest["leaves"].append({
            "key": key, "shape": list(leaf.shape), "dtype": _dtype_name(leaf)})
        sizes.append((key, leaf.numel() * leaf.element_size()))
    # one leaf on the host at a time
    payload = ((key, _host_bytes(leaf)) for key, leaf in leaves)
    _write_compressed(os.path.join(tmp, SHARD), packed_chunks(len(leaves), payload),
                      packed_size(sizes), DEFAULT_CODEC, compress_level)
    if store_dump is not None:
        with open(os.path.join(tmp, "store.json"), "w") as f:
            json.dump(store_dump, f, sort_keys=True, separators=(",", ":"))
        manifest["store"] = {
            "file": "store.json",
            "resource_version": store_dump.get("resource_version", 0),
            "objects": len(store_dump.get("objects", ()))}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, COMMIT_MARKER), "w") as f:
        f.write(str(step))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def list_checkpoints(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        full = os.path.join(directory, name)
        if (name.startswith("step_") and not name.endswith(".tmp")
                and os.path.exists(os.path.join(full, COMMIT_MARKER))):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def load_store_dump(directory: str,
                    step: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """The store dump co-checkpointed at ``step`` (newest if None).

    Returns None when the checkpoint carries no network state — callers
    fall back to a fresh control plane.
    """
    steps = list_checkpoints(directory)
    if not steps:
        return None
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        entry = manifest.get("store")
        if not entry:
            return None
        with open(os.path.join(path, entry["file"])) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def restore_checkpoint(directory: str, tree_like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``tree_like`` (a nested dict of
    tensors; newest step if None). Each leaf takes the manifest's dtype
    and shape and lands on the device of ``tree_like``'s leaf at the same
    path, and where that leaf is a ``DTensor``, on its mesh with its
    placements; leaves of the checkpoint that ``tree_like`` lacks are
    ignored."""
    steps = list_checkpoints(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    codec = manifest.get("codec", "zstd")  # pre-tag checkpoints were zstd
    packed = _read_decompressed(os.path.join(path, SHARD), codec)
    payload = unpackb(packed)
    by_key = {e["key"]: e for e in manifest["leaves"]}

    restored = []
    for key, leaf in tree_flatten_with_paths(tree_like):
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        meta = by_key[key]
        dtype = _torch_dtype(meta["dtype"])
        shape = meta["shape"]
        n = math.prod(shape) * dtype.itemsize
        raw = payload[key]
        if len(raw) != n:
            raise ValueError(f"leaf {key!r}: {len(raw)} bytes in the shard, "
                             f"{n} for {meta['dtype']} {shape}")
        if n == 0:
            full = torch.empty(shape, dtype=dtype, device=leaf.device)
        else:
            # bytes at any offset: copy them as uint8 (aligned) before the view
            data = torch.frombuffer(raw, dtype=torch.uint8).to(leaf.device,
                                                               copy=True)
            full = data.view(dtype).reshape(shape)
        if isinstance(leaf, DTensor):
            full = distribute_tensor(full, leaf.device_mesh, leaf.placements)
        restored.append(full)
    return tree_unflatten(tree_like, restored), step


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


@dataclass
class CheckpointManager:
    """Rotation + async save + resume, driven by trainer NRI hooks.

    ``save`` copies the tree to the host before it returns (gathering
    ``DTensor`` leaves first, on every rank, on the calling thread); with
    ``async_save`` a background thread then writes the files, and the
    next ``save``, ``wait`` or ``restore_latest`` joins it (re-raising
    its error). Of a sharded tree rank 0 alone writes, and ``wait``
    ends in a barrier, so no rank reads a checkpoint before it commits.
    ``store_provider`` is sampled synchronously at each ``save`` so the
    network state in the checkpoint is consistent with the step being
    written, even when the file write itself is async.
    ``compress_level`` is the codec's level for every save (the port's
    own field; the JAX package's manager always writes level 3).
    """

    directory: str
    keep: int = 3
    async_save: bool = True
    store_provider: Optional[Callable[[], Dict[str, Any]]] = None
    compress_level: int = 3
    _thread: Optional[threading.Thread] = field(default=None, repr=False)
    _error: Optional[BaseException] = field(default=None, repr=False)
    _barrier: bool = field(default=False, repr=False)

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        # snapshot to host BEFORE returning (async writes the files only)
        tree, sharded = _gathered(tree)
        self._barrier = sharded
        if not _writer(sharded):
            return
        host_tree = tree_map(_host_copy, tree)
        store_dump = (self.store_provider()
                      if self.store_provider is not None else None)
        if self.async_save:
            def work():
                try:
                    save_checkpoint(self.directory, step, host_tree,
                                    compress_level=self.compress_level,
                                    store_dump=store_dump)
                    self._rotate()
                except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            save_checkpoint(self.directory, step, host_tree,
                            compress_level=self.compress_level,
                            store_dump=store_dump)
            self._rotate()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            # every rank saved the same sharded tree: the others wait
            # here until rank 0's write has committed
            self._barrier = False
            if _grouped():
                dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _rotate(self) -> None:
        steps = list_checkpoints(self.directory)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, tree_like: Any) -> Tuple[Any, int]:
        self.wait()
        return restore_checkpoint(self.directory, tree_like)

    def latest_step(self) -> Optional[int]:
        steps = list_checkpoints(self.directory)
        return steps[-1] if steps else None
