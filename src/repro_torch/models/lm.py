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
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..parallel.sharding import constrain, current_rules, use_rules, whole_dims
from .config import ModelConfig
from .layers import (_qkv, _rows, attention_apply, attention_decode,
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
              att: Optional[torch.Tensor], y_ssd: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The rest of a layer once its mixers have run: ``x + ssd`` (ssm),
    ``x + att`` (dense, moe) or ``x + (att + ssd)/2`` (hybrid), then the
    MLP or MoE block where the family has one. ``att`` is None for the
    ssm family, ``y_ssd`` None for dense and moe. Returns the new x and
    the MoE's aux losses ({} for the other families)."""
    if cfg.family == "ssm":
        return x + y_ssd, {}
    if cfg.hybrid:
        att = 0.5 * (att + y_ssd)
    x = x + att
    h2 = rmsnorm(lp["norm2"], x, cfg.norm_eps)
    if cfg.num_experts > 0:
        y, aux = moe_apply(cfg, lp["moe"], h2)
        return x + y, aux
    return x + mlp_apply(cfg, lp["mlp"], h2), {}


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
        if return_state:
            y_ssd, st = ssd_apply(cfg, lp["ssd"], h, return_state=True)
        else:
            y_ssd = ssd_apply(cfg, lp["ssd"], h)
    if cfg.family != "ssm":
        att = attention_apply(cfg, lp["attn"], h, positions, attention_impl)
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
    """``table[tokens]`` as ``F.embedding``, with or without a mesh: its
    backward sums repeated tokens in f32 (indexing's sums in the table's
    dtype), and DTensor propagates it. A ``DTensor`` table has its vocab
    dim made whole first (DTensor's vocab-sharded lookup leaves pending
    masked sums)."""
    return F.embedding(tokens, whole_dims(table, 0))


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
        img = F.gelu(pe @ p["proj_in"].to(cdt), approximate="tanh")  # jax.nn.gelu
        x = torch.cat([img @ p["proj_hidden"].to(cdt), x], dim=1)
    S = x.shape[1]
    x = constrain(x, "batch", "seq", "act_embed")
    return x, torch.arange(S, dtype=torch.int32, device=x.device)


def lm_head(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """(B,S,V); audio (B,S,ncb,V)."""
    cdt = cfg.compute_torch_dtype()
    x = _rows(x)
    if cfg.frontend == "audio":
        # the product flattens (codebooks, vocab) of the head: its vocab
        # dim is made whole first (torch 2.11's DTensor flattens sharded
        # dims only where the sharded one leads)
        logits = torch.einsum("bsd,cdv->bscv", x, whole_dims(p["head"], 2).to(cdt))
        return constrain(logits, "batch", "seq", None, "act_vocab")
    w = p["embed"].T if cfg.tie_embeddings else p["head"]
    logits = torch.einsum("bsd,dv->bsv", x, w.to(cdt))
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
    for li in range(cfg.num_layers):
        x, aux = body(_layer(params["layers"], li), x)
        for name, v in aux.items():
            aux_acc[name] = aux_acc[name] + v if name in aux_acc else v
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_head(cfg, params, x), aux_acc


def cross_entropy(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def train_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
               attention_impl: str = "auto", remat: str = "full"
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy plus the MoE aux losses; vision
    scores the text positions only, audio every codebook."""
    logits, aux = forward(cfg, params, batch, attention_impl, remat)
    labels = batch["labels"]
    weights = batch.get("weights")
    if cfg.frontend == "vision":
        # logits cover [img_tokens, text]; labels are text-only. Under a
        # mesh the sequence is made whole before it is cut, and before
        # the audio logits' (S, codebooks) are flattened
        logits = whole_dims(logits, 1)[:, logits.shape[1] - labels.shape[1]:]
    if cfg.frontend == "audio":
        logits = whole_dims(logits, 1)
        loss = cross_entropy(
            cfg, logits.reshape(logits.shape[0], -1, logits.shape[-1]),
            labels.reshape(labels.shape[0], -1),
            None if weights is None
            else weights.repeat_interleave(cfg.num_codebooks, dim=-1))
    else:
        loss = cross_entropy(cfg, logits, labels, weights)
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


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Device = None) -> Dict[str, Any]:
    """Dense per-slot decode cache; ``pos`` is a per-slot clock (B,)."""
    dev = resolve_device(device)
    cache: Dict[str, Any] = {"pos": torch.zeros((batch,), dtype=torch.int32,
                                                device=dev)}
    L = cfg.num_layers
    if cfg.family != "ssm":
        kv = init_kv_cache(cfg, batch, max_len, dev)
        cache["kv"] = {name: torch.zeros((L,) + a.shape, dtype=a.dtype, device=dev)
                       for name, a in kv.items()}
    if _has_ssd(cfg):
        cache["ssd"] = _stacked_ssd_cache(cfg, batch, dev)
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

    x, _ = embed_tokens(cfg, params, {"tokens": tokens})
    for li in range(cfg.num_layers):
        lp = _layer(params["layers"], li)
        hn = rmsnorm(lp["norm1"], x, cfg.norm_eps)
        att = y_ssd = None
        if _has_ssd(cfg):
            y_ssd, new_ssd = ssd_decode_chunk(cfg, lp["ssd"], hn, _layer(ssd, li), adv)
            _write_layer(ssd, li, new_ssd)
        if cfg.family != "ssm":
            att, _ = attention_decode_paged(cfg, lp["attn"], hn, _layer(kv, li),
                                            block_table, pos, adv)
        x, _ = _residual(cfg, lp, x, att, y_ssd)
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
    if "kv" in cache:
        Scache = cache["kv"]["k"].shape[2]
        for name in ("k", "v"):
            e = torch.stack(emitted[name])[:, :, -Scache:]    # (L,B,n,K,hd)
            n = e.shape[2]
            if cfg.sliding_window > 0:
                # ring-buffer alignment: position p lives at slot p % Scache;
                # entries cover positions [S-n, S): roll index 0 -> slot (S-n) % Scache
                e = torch.roll(e, (S - n) % Scache, dims=2)
            cache["kv"][name][:, :, :n] = e.to(cache["kv"][name].dtype)
    if "ssd" in cache:
        for name, a in cache["ssd"].items():
            a.copy_(torch.stack(emitted[name]))
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, cache
