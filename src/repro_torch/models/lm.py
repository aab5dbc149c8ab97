"""Full language models, PyTorch: params, forward, loss, prefill, decode.

The port of the JAX package's ``models/lm.py``. The per-layer body is

  dense   : x += attn(n1(x));  x += mlp(n2(x))
  moe     : x += attn(n1(x));  x += moe(n2(x))   (+ aux losses)
  ssm     : x += ssd(n1(x))                       (attention-free)
  hybrid  : x += (attn(n1(x)) + ssd(n1(x)))/2;  x += mlp(n2(x))  (hymba)

and the vlm and audio families run the dense body behind their
frontends, which take precomputed embeddings as in JAX:

  vision (internvl2): patch embeddings (B, P, vit_dim) -> MLP projector ->
    prepended to the text sequence; labels on text only.
  audio (musicgen): codebook token streams (B, S, ncb) -> summed
    embeddings; per-codebook logit heads.

Parameters keep the JAX tree: layer parameters are stacked with a
leading ``L`` dimension under ``layers``, and where JAX scans over that
dimension the port loops over indexed slices. Caches are updated in
place where the JAX serving path donates them. ``forward``'s ``remat``
checkpoints each layer body as JAX's ``jax.checkpoint`` does.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor import zeros as dt_zeros
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..obs import span
from ..parallel.sharding import (active_mesh, constrain, current_rules, from_local_shard,
                                 local_einsum, local_shard, logical_to_pspec, placements,
                                 replicated_like, use_rules)
from .config import ModelConfig
from .layers import (_matmul, _qkv, _rows, _shard_offset, attention_apply, attention_decode,
                     attention_decode_paged, build_attention, build_mlp,
                     build_moe, build_rmsnorm, build_ssd, init_kv_cache,
                     init_ssd_cache, mlp_apply, moe_apply, rmsnorm, ssd_apply,
                     ssd_decode, ssd_decode_chunk)
from .modules import Builder, Mode, normal_init

Params = Dict[str, Any]
Device = Union[str, torch.device, None]


def _has_ssd(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def _layer(tree: Any, li: int) -> Any:
    """Layer ``li`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    return tree[li]


def _unstacked(tree: Any, L: int) -> list:
    """The L layers of a stacked tree, one ``unbind`` per leaf (views):
    the backward stacks the layers' gradients once, where indexing each
    layer would add L stack-sized tensors of zeros."""
    if isinstance(tree, dict):
        per_key = {k: _unstacked(v, L) for k, v in tree.items()}
        return [{k: v[li] for k, v in per_key.items()} for li in range(L)]
    return list(torch.unbind(tree, 0))


# ---------------------------------------------------------------------------
# Parameter tree
# ---------------------------------------------------------------------------


def build_layer(b: Builder, cfg: ModelConfig) -> Params:
    p: Params = {"norm1": build_rmsnorm(b, "norm1", cfg.d_model)}
    if cfg.family == "ssm":
        p["ssd"] = build_ssd(b, cfg)
        return p
    p["attn"] = build_attention(b, cfg)
    if cfg.hybrid:
        p["ssd"] = build_ssd(b, cfg)
    p["norm2"] = build_rmsnorm(b, "norm2", cfg.d_model)
    if cfg.num_experts > 0:
        p["moe"] = build_moe(b, cfg)
    else:
        p["mlp"] = build_mlp(b, cfg)
    return p


def build_params(b: Builder, cfg: ModelConfig) -> Params:
    p: Params = {}
    with b.scope("model"):
        if cfg.frontend == "audio":
            p["embed"] = b.param("embed", (cfg.num_codebooks, cfg.vocab_size,
                                           cfg.d_model),
                                 ("codebooks", "vocab_tp", "embed"),
                                 normal_init(0.02))
            p["head"] = b.param("head", (cfg.num_codebooks, cfg.d_model,
                                         cfg.vocab_size),
                                ("codebooks", "embed", "vocab_tp"),
                                normal_init(0.02))
        else:
            p["embed"] = b.param("embed", (cfg.vocab_size, cfg.d_model),
                                 ("vocab_tp", "embed"), normal_init(0.02))
            if not cfg.tie_embeddings:
                p["head"] = b.param("head", (cfg.d_model, cfg.vocab_size),
                                    ("embed", "vocab_tp"), normal_init(0.02))
        if cfg.frontend == "vision":
            with b.scope("projector"):
                p["proj_in"] = b.param("in", (cfg.vit_dim, cfg.d_model),
                                       ("vit", "embed"), normal_init(0.02))
                p["proj_hidden"] = b.param("hidden", (cfg.d_model, cfg.d_model),
                                           ("embed", "act_embed"), normal_init(0.02))
        with b.scope("layers"), b.stacked(cfg.num_layers):
            p["layers"] = build_layer(b, cfg)
        p["final_norm"] = build_rmsnorm(b, "final_norm", cfg.d_model)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device: Device = None) -> Params:
    """Random parameters made on ``device`` from per-path generators
    seeded by ``seed`` (``device=None`` = the GPU)."""
    b = Builder(Mode.INIT, seed, cfg.param_torch_dtype(), resolve_device(device))
    return build_params(b, cfg)


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree as ``meta`` tensors: shapes and dtypes only."""
    return build_params(Builder(Mode.SHAPE, param_dtype=cfg.param_torch_dtype()), cfg)


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter tree's logical axes, one tuple per parameter."""
    return build_params(Builder(Mode.SPEC, param_dtype=cfg.param_torch_dtype()), cfg)


# ---------------------------------------------------------------------------
# Layer body (shared by train forward / prefill)
# ---------------------------------------------------------------------------


def _residual(cfg: ModelConfig, lp: Params, x: torch.Tensor,
              att: Optional[torch.Tensor], y_ssd: Optional[torch.Tensor],
              real: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The rest of a layer once its mixers have run: ``x + ssd`` (ssm),
    ``x + att`` (dense, moe) or ``x + (att + ssd)/2`` (hybrid), then the
    MLP or MoE block where the family has one. ``att`` is None for the
    ssm family, ``y_ssd`` None for dense and moe; ``real`` marks the rows
    that take the MoE's capacity first. Returns the new x and the MoE's
    aux losses ({} for the other families)."""
    if cfg.family == "ssm":
        return x + y_ssd, {}
    if cfg.hybrid:
        att = 0.5 * (att + y_ssd)
    x = x + att
    h2 = rmsnorm(lp["norm2"], x, cfg.norm_eps)
    with span("model.mlp") as s:
        h2 = s.inputs(h2)
        if cfg.num_experts > 0:
            y, aux = moe_apply(cfg, lp["moe"], h2, real)
        else:
            y, aux = mlp_apply(cfg, lp["mlp"], h2), {}
        y = s.output(y)
    return x + y, aux


def _layer_body(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                positions: torch.Tensor, attention_impl: str,
                return_state: bool
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                           Optional[Dict[str, torch.Tensor]]]:
    """One layer: the new x, its aux losses and, with ``return_state``,
    the SSD cache state that ``ssd_apply`` leaves after the sequence
    (None without an SSD). Under a mesh the normed rows' sequence is
    gathered once for both mixers, so that their gradients meet in one
    sum, in the order they meet without a mesh."""
    h = _rows(rmsnorm(lp["norm1"], x, cfg.norm_eps))
    att = y_ssd = st = None
    if _has_ssd(cfg):
        with span("model.ssd") as s:
            # the attention reads the marked rows too, so that the two
            # mixers' gradients meet in one sum, in the order they meet
            # unmarked
            h = s.inputs(h)
            if return_state:
                y_ssd, st = ssd_apply(cfg, lp["ssd"], h, return_state=True)
            else:
                y_ssd = ssd_apply(cfg, lp["ssd"], h)
            y_ssd = s.output(y_ssd)
    if cfg.family != "ssm":
        with span("model.attention") as s:
            att = s.output(attention_apply(cfg, lp["attn"], s.inputs(h), positions,
                                           attention_impl))
    x, aux = _residual(cfg, lp, x, att, y_ssd)
    return x, aux, st


def layer_apply(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                positions: torch.Tensor, attention_impl: str = "auto"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x, aux, _ = _layer_body(cfg, lp, x, positions, attention_impl, False)
    return x, aux


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` as ``F.embedding``: its backward sums repeated
    tokens in f32 (indexing's sums in the table's dtype). Under a mesh the
    lookup runs on this rank's columns of the table (its vocab dim whole,
    its embedding dim split as it is) for every token, and the rows come
    back split in their last dim: each rank's gradient is then its columns'
    exact sum over all tokens, whatever the number of ranks (DTensor's own
    choice between this and a vocab-split lookup follows the sizes, and
    the latter leaves masked sums that a fake tensor cannot resolve)."""
    if not isinstance(tokens, DTensor) and not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = (tokens if isinstance(tokens, DTensor) else table).device_mesh
    rep = [Replicate()] * mesh.ndim
    cols = [q if q == Shard(1) else Replicate()
            for q in (table.placements if isinstance(table, DTensor) else rep)]
    rows = F.embedding(local_shard(tokens, mesh, rep), local_shard(table, mesh, cols))
    return from_local_shard(rows, mesh, [Shard(rows.dim() - 1) if q == Shard(1) else q
                                         for q in cols],
                            tuple(tokens.shape) + (table.shape[-1],))


def embed_tokens(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,D), positions (S,)); with ``patch_embeds`` (vision)
    S counts the image prefix. Tokens must lie in [0, vocab): ``jnp.take``
    fills the row of an out-of-range id with NaN (and wraps -1 to the
    last row), torch indexing raises on the CPU and asserts on the
    device, so the serving engine rejects such ids at submit."""
    cdt = cfg.compute_torch_dtype()
    tokens = batch["tokens"].long()
    if cfg.frontend == "audio":                                  # (B,S,ncb)
        # JAX sums the codebooks onto zeros; 0 + e is e, so the first
        # codebook starts the sum (no plain zeros beside a DTensor)
        x = _embed(p["embed"][0], tokens[..., 0]).to(cdt)
        for c in range(1, cfg.num_codebooks):
            x = x + _embed(p["embed"][c], tokens[..., c]).to(cdt)
    else:
        x = _embed(p["embed"], tokens).to(cdt)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(cdt)                       # (B,P,vit)
        img = F.gelu(_matmul(pe, p["proj_in"].to(cdt)), approximate="tanh")  # jax.nn.gelu
        x = torch.cat([_matmul(img, p["proj_hidden"].to(cdt)), x], dim=1)
    S = x.shape[1]
    x = constrain(x, "batch", "seq", "act_embed")
    return x, torch.arange(S, dtype=torch.int32, device=x.device)


def lm_head(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """(B,S,V); audio (B,S,ncb,V)."""
    cdt = cfg.compute_torch_dtype()
    if cfg.frontend == "audio":
        logits = local_einsum("bsd,cdv->bscv", x, p["head"].to(cdt))
        return constrain(logits, "batch", "seq", None, "act_vocab")
    w = p["embed"].T if cfg.tie_embeddings else p["head"]
    logits = local_einsum("bsd,dv->bsv", x, w.to(cdt))
    return constrain(logits, "batch", "seq", "act_vocab")


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``: keep the results of matrix products without batch
    dimensions (``mm``/``addmm``, as JAX's
    ``checkpoint_dots_with_no_batch_dims``) and recompute the rest; the
    kernels' outputs are recomputed with it, since their launches are no
    ATen op this policy could keep."""
    if op in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(remat: str, body):
    """The layer body under ``remat``: ``none``; ``full`` keeps only its
    inputs and recomputes the rest in the backward; ``dots`` keeps the
    products of :func:`_save_dots` as well."""
    if remat == "none":
        return body
    if remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"unknown remat {remat!r}; none, dots or full")


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            attention_impl: str = "auto", remat: str = "full"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Logits (B,S,V) (audio (B,S,ncb,V)) and the MoE aux losses. The
    layer bodies are checkpointed by ``remat`` only where a gradient is
    being recorded; the values do not depend on it. Every family runs
    under a mesh as without one."""
    with span("model.embed"):
        x, positions = embed_tokens(cfg, params, batch)
    # JAX sums the layers' aux losses onto zeros; the first layer's start
    # the sum here (0 + v is v), so that no plain zero meets a DTensor
    aux_acc: Dict[str, torch.Tensor] = {}
    rules = current_rules()

    def body(lp: Params, h: torch.Tensor):
        # remat recomputes the body in the backward pass, which on CUDA
        # runs on autograd's device thread: the rules go with the body
        with use_rules(rules):
            return layer_apply(cfg, lp, h, positions, attention_impl)

    if torch.is_grad_enabled():
        body = _remat(remat, body)
    for lp in _unstacked(params["layers"], cfg.num_layers):
        x, aux = body(lp, x)
        for name, v in aux.items():
            aux_acc[name] = aux_acc[name] + v if name in aux_acc else v
    with span("model.head"):
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return lm_head(cfg, params, x), aux_acc


def cross_entropy(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy (weighted by ``weights``); under a
    mesh :func:`train_loss` takes :func:`_cross_entropy_sharded` instead
    (DTensor's own gather would make its backward's zeros at the global
    shape on every rank)."""
    nll = _nll(logits, labels)
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def _cross_entropy_sharded(logits: torch.Tensor, labels: torch.Tensor,
                           weights: Optional[torch.Tensor], prefix: int = 0
                           ) -> torch.Tensor:
    """:func:`cross_entropy` of a ``DTensor``'s logits on this rank's rows
    (the vocab whole), each rank's part met in a sum across the ranks.
    ``labels`` (and ``weights``) cover the logits' positions from
    ``prefix`` on (the vision frontend's image prefix scores nothing);
    audio labels keep their codebook dim (the mean is over every
    codebook, as the unsharded path's flattened one). A rank's part is
    its rows' mean scaled by their share of the rows, so that one rank
    gives the unsharded bits."""
    mesh = logits.device_mesh
    rows = [Replicate() if q == Shard(logits.dim() - 1) else q for q in logits.placements]
    summed = [Partial() if isinstance(q, Shard) else Replicate() for q in rows]
    first = _shard_offset(logits.shape[1], mesh, rows, 1)     # this rank's sequence shard
    lo = max(prefix - first, 0)
    lf = local_shard(logits, mesh, rows)[:, lo:]              # its text positions
    t0 = first + lo - prefix
    whole = [q if q == Shard(0) else Replicate() for q in rows]  # the batch rows, S whole
    lab = local_shard(labels, mesh, whole)[:, t0:t0 + lf.shape[1]]
    nll = _nll(lf, lab)
    if weights is None:
        part = nll.mean() * (nll.numel() / labels.numel()) if nll.numel() else nll.sum()
        return from_local_shard(part, mesh, summed, ())
    w = local_shard(weights, mesh, whole)[:, t0:t0 + lf.shape[1]].float()
    w = w.reshape(w.shape + (1,) * (nll.dim() - w.dim()))
    num, den = (from_local_shard(t, mesh, summed, ())
                for t in ((nll * w).sum(), w.expand_as(nll).sum()))
    return num / torch.clamp(den, min=1.0)


def train_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
               attention_impl: str = "auto", remat: str = "full"
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy plus the MoE aux losses; vision
    scores the text positions only, audio every codebook."""
    logits, aux = forward(cfg, params, batch, attention_impl, remat)
    labels = batch["labels"]
    weights = batch.get("weights")
    # logits cover [img_tokens, text] (vision); labels are text-only
    prefix = logits.shape[1] - labels.shape[1]
    with span("model.loss"):
        if isinstance(logits, DTensor):
            loss = _cross_entropy_sharded(logits, labels, weights, prefix)
        elif cfg.frontend == "audio":
            loss = cross_entropy(
                cfg, logits.reshape(logits.shape[0], -1, logits.shape[-1]),
                labels.reshape(labels.shape[0], -1),
                None if weights is None
                else weights.repeat_interleave(cfg.num_codebooks, dim=-1))
        else:
            loss = cross_entropy(cfg, logits[:, prefix:] if prefix else logits, labels,
                                 weights)
    metrics = {"ce_loss": loss}
    for name, v in aux.items():
        loss = loss + v  # aux coefficients already applied per layer
        metrics[name] = v
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _stacked_ssd_cache(cfg: ModelConfig, slots: int, dev: torch.device
                       ) -> Dict[str, torch.Tensor]:
    """Per-layer SSD state (L,slots,H,N,P) f32 and conv window
    (L,slots,k-1,d_inner+2N): real zero tensors, written in place
    (JAX's ``broadcast_to`` views would alias every layer)."""
    sc = init_ssd_cache(cfg, slots, dev)
    return {name: torch.zeros((cfg.num_layers,) + a.shape, dtype=a.dtype, device=dev)
            for name, a in sc.items()}


def cache_axes(shape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
    """The logical axes of a stacked cache leaf, as the JAX package's dry
    run places the cache (``launch/dryrun.py:cache_shardings``): a 5-d
    leaf whose dim 3 exceeds 1 (the KV cache (L,B,S,K,hd), and so also the
    SSD state (L,B,H,N,P)) as (None, batch, seq_kv, act_kv, None), any
    other of 2 dims or more on its batch dim 1; ``pos`` replicated."""
    if len(shape) == 5 and shape[3] > 1:
        return (None, "batch", "seq_kv", "act_kv", None)
    if len(shape) >= 2:
        return (None, "batch") + (None,) * (len(shape) - 2)
    return (None,) * len(shape)


def _zeros(shape: Tuple[int, ...], dtype: torch.dtype, dev: torch.device
           ) -> torch.Tensor:
    """A cache leaf of zeros; under rules with a mesh a ``DTensor`` placed
    by :func:`cache_axes`, made shard by shard."""
    mesh = active_mesh()
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=dev)
    pl = placements(logical_to_pspec(cache_axes(shape), current_rules(), shape), mesh)
    return dt_zeros(shape, dtype=dtype, device_mesh=mesh, placements=pl)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Device = None) -> Dict[str, Any]:
    """Dense per-slot decode cache; ``pos`` is a per-slot clock (B,).
    Under rules with a mesh every leaf is a ``DTensor`` placed by
    :func:`cache_axes` (``pos`` replicated)."""
    dev = resolve_device(device)
    cache: Dict[str, Any] = {"pos": _zeros((batch,), torch.int32, dev)}
    L = cfg.num_layers
    if cfg.family != "ssm":
        kv = init_kv_cache(cfg, batch, max_len, torch.device("meta"))
        cache["kv"] = {name: _zeros((L,) + tuple(a.shape), a.dtype, dev)
                       for name, a in kv.items()}
    if _has_ssd(cfg):
        sc = init_ssd_cache(cfg, batch, torch.device("meta"))
        cache["ssd"] = {name: _zeros((L,) + tuple(a.shape), a.dtype, dev)
                        for name, a in sc.items()}
    return cache


def init_paged_cache(cfg: ModelConfig, slots: int, num_blocks: int,
                     block_size: int, device: Device = None) -> Dict[str, Any]:
    """Paged decode cache: a physical KV block pool + per-slot SSD state.

    kv k/v are (L, num_blocks, block_size, K, hd) — one pool shared by
    all slots; block 0 is the reserved always-zero sentinel that empty
    block-table entries point at. The ssm and hybrid families add
    ``ssd`` (state and conv window per slot, see
    :func:`_stacked_ssd_cache`); the ssm family has no pool. Position
    clocks and block tables live host-side in
    :class:`repro_torch.serve.kvcache.KVCacheManager` and are passed to
    :func:`decode_chunk` per tick.
    """
    dev = resolve_device(device)
    cache: Dict[str, Any] = {}
    if cfg.family != "ssm":
        shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dt = cfg.compute_torch_dtype()
        cache["kv"] = {"k": torch.zeros(shape, dtype=dt, device=dev),
                       "v": torch.zeros(shape, dtype=dt, device=dev)}
    if _has_ssd(cfg):
        cache["ssd"] = _stacked_ssd_cache(cfg, slots, dev)
    return cache


def _write_layer(tree: Dict[str, torch.Tensor], li: int,
                 new: Dict[str, torch.Tensor]) -> None:
    """Write one layer's new SSD state into the stacked cache, in place."""
    for name, a in tree.items():
        a[li].copy_(new[name])


def decode_chunk(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 cache: Dict[str, Any], block_table: torch.Tensor,
                 pos: torch.Tensor, adv: torch.Tensor,
                 zero_blocks: Optional[torch.Tensor] = None,
                 reset_slots: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Continuous-batching step: C tokens per slot against the paged cache.

    tokens: (B,C) [audio: (B,C,ncb)]; block_table: (B,nb); pos: (B,)
    per-slot clocks; adv: (B,) real tokens this chunk (0 = idle slot). One call serves mixed
    phases. ``zero_blocks`` (fixed width, padded with NB) zero-epochs
    recycled physical blocks; ``reset_slots`` (B,) bool zeroes recycled
    slots' SSD state and conv window (state is cumulative: masking
    alone cannot protect it). The pool and the SSD state are updated in
    place (the JAX engine donates them) and returned in the cache dict.
    Returns (logits (B,C,V) [audio (B,C,ncb,V)], cache).
    """
    kv = cache.get("kv")
    ssd = cache.get("ssd")
    if zero_blocks is not None and kv is not None:
        NB = kv["k"].shape[1]
        # padding entries (NB) go to the sentinel block 0, which is zero
        zb = torch.where(zero_blocks < NB, zero_blocks,
                         torch.zeros_like(zero_blocks)).long()
        kv["k"][:, zb] = 0.0
        kv["v"][:, zb] = 0.0
    if reset_slots is not None and ssd is not None:
        for a in ssd.values():
            a.masked_fill_(reset_slots.reshape((1, -1) + (1,) * (a.dim() - 2)), 0)

    with span("model.embed"):
        x, _ = embed_tokens(cfg, params, {"tokens": tokens})
    # the chunk's real rows: they take the MoE's capacity before padding
    real = (torch.arange(tokens.shape[1], device=adv.device)[None, :] < adv[:, None]
            if cfg.num_experts > 0 else None)
    for li in range(cfg.num_layers):
        lp = _layer(params["layers"], li)
        hn = rmsnorm(lp["norm1"], x, cfg.norm_eps)
        att = y_ssd = None
        if _has_ssd(cfg):
            with span("model.ssd"):
                y_ssd, new_ssd = ssd_decode_chunk(cfg, lp["ssd"], hn, _layer(ssd, li), adv)
                _write_layer(ssd, li, new_ssd)
        if cfg.family != "ssm":
            with span("model.attention"):
                att, _ = attention_decode_paged(cfg, lp["attn"], hn, _layer(kv, li),
                                                block_table, pos, adv)
        x, _ = _residual(cfg, lp, x, att, y_ssd, real)
    with span("model.head"):
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return lm_head(cfg, params, x), cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One AR step for the whole stack against the dense cache.
    tokens: (B,1) [audio: (B,1,ncb)]. The cache's K/V and SSD state are written in place;
    ``pos`` advances in the returned dict."""
    x, _ = embed_tokens(cfg, params, {"tokens": tokens})
    pos = cache["pos"]
    for li in range(cfg.num_layers):
        lp = _layer(params["layers"], li)
        hn = rmsnorm(lp["norm1"], x, cfg.norm_eps)
        att = y_ssd = None
        if _has_ssd(cfg):
            y_ssd, new_ssd = ssd_decode(cfg, lp["ssd"], hn, _layer(cache["ssd"], li))
            _write_layer(cache["ssd"], li, new_ssd)
        if cfg.family != "ssm":
            att, _ = attention_decode(cfg, lp["attn"], hn, _layer(cache["kv"], li), pos)
        x, _ = _residual(cfg, lp, x, att, y_ssd)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_head(cfg, params, x)
    return logits, {**cache, "pos": pos + 1}


def _seq_whole(e: torch.Tensor, fn) -> torch.Tensor:
    """``fn(e)`` for stacked cache entries (L,B,n,K,hd) that ``fn`` changes
    along dim 2 alone; a ``DTensor`` on its local shards with dim 2 whole
    (torch 2.11's DTensor has no rule for ``roll``)."""
    if not isinstance(e, DTensor):
        return fn(e)
    mesh = e.device_mesh
    pl = [Replicate() if q == Shard(2) else q for q in e.placements]
    out = fn(local_shard(e, mesh, pl))
    shape = list(e.shape)
    shape[2] = out.shape[2]
    return from_local_shard(out, mesh, pl, shape)


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            attention_impl: str = "auto", max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process a full prompt, return last-position logits + primed cache.

    ``max_len`` sizes the KV cache (must exceed S by the planned
    generation length for full-attention archs; SWA archs allocate the
    window regardless). The SSD state is primed from the layer's own
    ``ssd_apply(return_state=True)``: JAX runs ``ssd_apply`` a second
    time inside ``layer_apply`` for the layer's output, the port reuses
    the one result (the same numbers, one SSD kernel launch per
    layer). With ``patch_embeds`` (vision) the image prefix is cached
    like the text: S and the clocks count it."""
    x, positions = embed_tokens(cfg, params, batch)
    B, S, _ = x.shape
    max_len = max_len or S
    emitted: Dict[str, list] = {"k": [], "v": [], "state": [], "conv": []}
    for li in range(cfg.num_layers):
        lp = _layer(params["layers"], li)
        if cfg.family != "ssm":
            hn = rmsnorm(lp["norm1"], x, cfg.norm_eps)
            _, k_, v_ = _qkv(cfg, lp["attn"], hn, positions[None, :])
            if cfg.sliding_window > 0 and S > cfg.sliding_window:
                k_ = k_[:, -cfg.sliding_window:]
                v_ = v_[:, -cfg.sliding_window:]
            emitted["k"].append(k_)
            emitted["v"].append(v_)
        x, _, st = _layer_body(cfg, lp, x, positions, attention_impl, True)
        if st is not None:
            emitted["state"].append(st["state"])
            emitted["conv"].append(st["conv"])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_head(cfg, params, x[:, -1:])

    cache = init_cache(cfg, B, max(max_len, 1), x.device)
    sharded = isinstance(x, DTensor)
    if "kv" in cache:
        Scache = cache["kv"]["k"].shape[2]
        for name in ("k", "v"):
            e = torch.stack(emitted[name])                     # (L,B,n,K,hd)
            if e.shape[2] > Scache:
                e = e[:, :, -Scache:]
            n = e.shape[2]
            if cfg.sliding_window > 0 and (S - n) % Scache:
                # ring-buffer alignment: position p lives at slot p % Scache;
                # entries cover positions [S-n, S): roll index 0 -> slot (S-n) % Scache
                e = _seq_whole(e, lambda t: torch.roll(t, (S - n) % Scache, dims=2))
            c = cache["kv"][name]
            if sharded:
                # a DTensor cache is made from the entries, placed as the
                # cache (a sharded slice cannot be written in place)
                if n < Scache:
                    e = _seq_whole(e, lambda t: F.pad(t, (0, 0, 0, 0, 0, Scache - n)))
                cache["kv"][name] = e.to(c.dtype).redistribute(c.device_mesh, c.placements)
            else:
                c[:, :, :n] = e.to(c.dtype)
    if "ssd" in cache:
        for name, a in cache["ssd"].items():
            e = torch.stack(emitted[name])
            if sharded:
                cache["ssd"][name] = e.to(a.dtype).redistribute(a.device_mesh, a.placements)
            else:
                a.copy_(e)
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    cache["pos"] = replicated_like(pos, x)
    return logits, cache
