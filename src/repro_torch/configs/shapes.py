"""The assigned input-shape suite and its abstract inputs, ``input_specs()``.

Four shapes per LM architecture (40 cells total):
  train_4k     seq 4096   x global_batch 256   -> train_step
  prefill_32k  seq 32768  x global_batch 32    -> prefill
  decode_32k   seq 32768  x global_batch 128   -> serve_step (1 token, KV cache)
  long_500k    seq 524288 x global_batch 1     -> serve_step; sub-quadratic only

The port of the JAX package's ``configs/shapes.py``. Where JAX returns
``ShapeDtypeStruct``s, :func:`input_specs` and :func:`cache_specs` return
``meta`` tensors: the same shapes and dtypes, never an allocation, for
the dry run (``launch/dryrun.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models.config import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "input_specs", "shape_applicable",
           "cache_specs"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k requires a sub-quadratic arch."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full quadratic attention at 524288 ctx is infeasible "
                       "(O(L^2) scores; KV cache alone is fine but prefill/"
                       "attention cost is not) — skipped per assignment")
    return True, ""


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_spec(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.frontend == "audio":
        return _meta((batch, seq, cfg.num_codebooks), torch.int32)
    return _meta((batch, seq), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Model inputs of the cell as ``meta`` tensors."""
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "vision":
            # patches replace the first num_patches positions of the seq
            s_text = S - cfg.num_patches
            specs["patch_embeds"] = _meta((B, cfg.num_patches, cfg.vit_dim),
                                          torch.bfloat16)
            specs["tokens"] = _token_spec(cfg, B, s_text)
            if shape.kind == "train":
                specs["labels"] = _meta((B, s_text), torch.int32)
        else:
            specs["tokens"] = _token_spec(cfg, B, S)
            if shape.kind == "train":
                specs["labels"] = _token_spec(cfg, B, S)
        return specs
    # decode: one new token against a primed cache of size seq_len
    return {"tokens": _token_spec(cfg, B, 1)}


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """The decode cells' KV/SSD cache as ``meta`` tensors."""
    from ..models import lm
    return lm.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
