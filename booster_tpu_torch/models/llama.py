"""Decoder forward pass for the llama architecture, in torch.

Port of the llama branch of ``booster_tpu/models/llama.py``.  The layers run
as a Python loop that hands the layer index to the kernels (a stacked
QTensor's ``at(i)`` view, the cache's layer): no per-layer copy of weights
or cache.  Two forms, as in the JAX package:

- T > 1 (prefill): each layer writes its new rows into the cache
  (``kv_cache.update_layer``, quantized for an int8 cache) and attends: over
  an int8 cache, where ``prefill_supported`` takes the shape, with the
  chunked-prefill kernel (``ops.prefill_attention``), which reads the
  cache, this chunk included, as int8 (the reference's fused-prefill gate,
  ``booster_tpu/models/llama.py:666-670``); otherwise with the masked plain
  attention over the (dequantized) cache.
- T = 1 (decode) over the stacked cache: attention (``ops.decode_attention``,
  the CUDA kernel) reads the cache as it was before this token and folds the
  new row in as a self term (live where ``n_valid > 0``); the rows of all
  layers land in one launch after the loop (``ops.kv_append``).

A ``PagedKVCache`` (``ops.paged_kv``) takes the reference's paged branch:
prefill writes each layer's rows through the page table
(``append_paged_layer``), then attends with the masked plain attention over
slot-dense views gathered back from the pool (``gather_layer``, dequantized
for an int8 pool), so the prompt's own rows come back after the storage
round trip; the fused prefill kernel is off for pools, as in the reference.
Decode with a page size that is a multiple of 128 (the reference's
``_use_fused_decode`` gate) is the stacked paged path: the paged attention
kernel (``ops.paged_attention``) with the deferred self term, then one
``kv_append_all_layers_paged`` after the loop.  Other page sizes decode
through the prefill form, as the reference's XLA path does.

Routed experts (Mixtral; arch ``llama`` with experts, or ``mixtral``) take
the reference's MoE FFN (``booster_tpu/models/llama.py:147-214``): the
grouped dispatch of ``ops.moe`` over the expert stacks as the loader keeps
them (lane-major i4p or i8, or dense); stacks of other kinds raise.

A T = 1 step decodes stacked only where the reference's gate
``_use_fused_decode`` lets it; otherwise it takes the reference's layer
loop with a mask: each layer writes its row with
``kv_cache.update_layer`` (the per-layer append kernel where the cache
length is a multiple of 128, plain writes elsewhere; through the page table
for a pool) and attends with the masked plain attention.  ALiBi closes the
fused gate, so MPT (arch ``mpt``: mean-centred LayerNorm with optional
biases, a fused qkv projection with optional ``clamp_kqv``, ALiBi in place
of rope, an ungated tanh-GELU FFN) always decodes so; ALiBi also keeps the
fused chunked prefill off, as in the reference.

Gemma (arch ``gemma``) is the llama forward with the reference's quirks
(``booster_tpu/models/config.py:187-193``): the embedding scaled by
sqrt(n_embd), RMSNorm by (1 + w), a gated tanh-GELU FFN (the fused gate-up
takes its GELU epilogue, ``ops.qmm.qmm_gateup(x, w, "gelu")``), a head dim
of 256 stored at 256 lanes, and the head tied to the token table
(``tied_head``).  gemma2's post norms, softcaps and windows are not ported.

The cache is updated in place and returned.  Other architectures and the
llama family's options (shared experts, expert groups, MLA, biases,
sliding-window patterns) are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from booster_tpu_torch.models.config import ModelConfig
from booster_tpu_torch.ops.attention import alibi_slopes, attention, build_mask
from booster_tpu_torch.ops.decode_attention import decode_attention_stacked
from booster_tpu_torch.ops.kv_append import kv_append, kv_append_all_layers_paged
from booster_tpu_torch.ops.kv_cache import dequant_kv, update_layer
from booster_tpu_torch.ops.linear import qlinear
from booster_tpu_torch.ops.mlp import qmm_mlp
from booster_tpu_torch.ops.moe import moe_ffn_grouped, moe_supported
from booster_tpu_torch.ops.paged_attention import paged_decode_attention_stacked, paged_decode_prep
from booster_tpu_torch.ops.paged_kv import PagedKVCache, append_paged_layer, gather_layer
from booster_tpu_torch.ops.prefill_attention import prefill_attention, prefill_supported
from booster_tpu_torch.ops.qmm import act_mul, gelu, qmm_gateup, silu
from booster_tpu_torch.ops.rope import apply_rope_tables, rope_tables
from booster_tpu_torch.quant.qtensor import QTensor


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float, add_one: bool = False) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    wf = w.float()
    if add_one:
        wf = 1.0 + wf
    return (normed * wf).to(x.dtype)


def layer_norm(x: torch.Tensor, w: Optional[torch.Tensor], b: Optional[torch.Tensor],
               eps: float) -> torch.Tensor:
    """Mean-centred LayerNorm in f32, rounded to x's dtype; `w` and `b` optional."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _norm(x: torch.Tensor, lp: dict, key: str, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_type == "layer":
        return layer_norm(x, lp.get(key), lp.get(f"{key}_b"), cfg.rms_eps)
    return rms_norm(x, lp[key], cfg.rms_eps, cfg.norm_eps_add_one)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The FFN's activation: tanh-approximate GELU in f32 as jax.nn.gelu
    writes it, rounded to x's dtype (ops.qmm.gelu); or SiLU (ops.qmm.silu)."""
    return gelu(x) if kind == "gelu" else silu(x)


def _check_ported(cfg: ModelConfig) -> None:
    moe_ok = not cfg.n_experts or (
        0 < cfg.n_experts_used <= cfg.n_experts and not cfg.n_shared_experts
        and cfg.n_expert_groups <= 1 and cfg.moe_scale == 1.0 and not cfg.n_dense_layers)
    llama = (cfg.arch in ("llama", "mixtral") and cfg.act == "silu" and cfg.norm_type == "rms"
             and not cfg.alibi_max_bias and not cfg.clamp_kqv)
    mpt = (cfg.arch == "mpt" and cfg.act == "gelu" and cfg.norm_type == "layer"
           and not cfg.n_experts)
    # gemma: gated tanh-GELU, RMSNorm by (1 + w), the embedding scaled by
    # sqrt(n_embd), the head tied; gemma2's softcaps and windows are not ported
    gemma = (cfg.arch == "gemma" and cfg.act == "gelu" and cfg.norm_type == "rms"
             and cfg.norm_eps_add_one and cfg.tie_embeddings and not cfg.n_experts
             and not cfg.alibi_max_bias and not cfg.clamp_kqv and not cfg.attn_logit_softcap
             and not cfg.final_logit_softcap and not cfg.sliding_window)
    if (not (llama or mpt or gemma) or not moe_ok
            or cfg.kv_lora_rank or cfg.head_dim_v not in (0, cfg.head_dim)
            or cfg.parallel_residual or cfg.post_norms or cfg.sliding_window_pattern > 1
            or cfg.heads_per_layer or cfg.q_norm or cfg.n_heads % cfg.n_kv_heads
            or cfg.residual_scale != 1.0):
        raise NotImplementedError(f"{cfg.arch} with these options: not ported yet")


@functools.lru_cache(maxsize=8)
def _alibi_slopes(n_heads: int, max_bias: float, device: torch.device) -> torch.Tensor:
    """The slopes on `device`, made once: a copy from the host per step
    would make a decode dispatch wait for the card."""
    return alibi_slopes(n_heads, max_bias, device)


def _use_fused_decode(cfg: ModelConfig, T: int, S: int, page_size: int = 0) -> bool:
    """The reference's gate of the decode attention kernel (``booster_tpu/
    models/llama.py:76-102``): single-token steps, whole query groups, no
    per-layer head counts, no ALiBi, no MLA, and a tileable cache (pages of
    a multiple of 128 rows, or a dense length that is one).  Where it is
    closed, a step takes the masked layer loop."""
    if T != 1 or cfg.n_heads % cfg.n_kv_heads != 0 or cfg.heads_per_layer:
        return False
    if cfg.alibi_max_bias > 0 or (cfg.head_dim_v and cfg.head_dim_v != cfg.head_dim):
        return False
    return page_size % 128 == 0 if page_size else S % 128 == 0


def moe_route(router_logits: torch.Tensor, cfg: ModelConfig):
    """softmax over all experts (f32) → top-k → renormalized over the
    selected when ``moe_norm_topk``: (topv [.., k] f32, topi [.., k] int32).
    Equal probabilities (bf16 logits tie often) rank the lower expert first,
    as ``jax.lax.top_k`` does: a stable descending sort."""
    z = router_logits.float()
    e = torch.exp(z - z.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.n_experts_used
    topv, topi = v[..., :k], i[..., :k].to(torch.int32)
    if cfg.moe_norm_topk:
        topv = topv / topv.sum(-1, keepdim=True)
    return topv, topi


def _moe_ffn(x: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    """The routed experts' FFN: the grouped dispatch (ops.moe).  The loader
    keeps expert stacks lane-major (i4p, i8) or dense, which it takes."""
    if not moe_supported(lp):
        kinds = [getattr(lp.get(n), "kind", None) for n in ("gate_exps", "up_exps", "down_exps")]
        raise NotImplementedError(f"expert stacks of kinds {kinds}: not ported yet")
    return moe_ffn_grouped(x, lp, cfg)


def _layer_view(layers: dict[str, Any], i: int) -> dict[str, Any]:
    return {k: (v.at(i) if isinstance(v, QTensor) else v[i]) for k, v in layers.items()}


def _layer(x, lp, i, cache, positions, cos, sin, mask, offsets, kv_valid, cfg,
           decode: bool, self_ok=None, fused_prefill: bool = False, prep=None, slopes=None):
    """One decoder layer; returns (x, (k, v)) with the layer's new roped rows.
    `slopes` [H] f32: the ALiBi slopes of the masked attention."""
    B, T, C = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    h = _norm(x, lp, "attn_norm", cfg)
    if "wqkv" in lp:
        qkv = qlinear(h, lp["wqkv"]).reshape(B, T, H + 2 * Hkv, D)
    else:
        qkv = torch.cat([qlinear(h, lp[k_]) for k_ in ("wq", "wk", "wv")], dim=-1
                        ).reshape(B, T, H + 2 * Hkv, D)
    if cfg.clamp_kqv > 0:  # mpt: q, k and v clamped alike
        qkv = torch.clamp(qkv, -cfg.clamp_kqv, cfg.clamp_kqv)
    # q and k heads rotate together (one elementwise pass instead of two)
    qk = apply_rope_tables(qkv[:, :, :H + Hkv], cos, sin, cfg.rope_style)
    q, k = qk[:, :, :H], qk[:, :, H:]
    v = qkv[:, :, H + Hkv:]

    scale = cfg.attn_scale if cfg.attn_scale > 0 else 1.0 / (D ** 0.5)
    window = cfg.sliding_window if cfg.sliding_window > 0 else None
    ks = None if cache.k_scale is None else cache.k_scale[i]
    vs = None if cache.v_scale is None else cache.v_scale[i]
    paged = isinstance(cache, PagedKVCache)
    if decode and paged:
        attn_out = paged_decode_attention_stacked(
            q, cache.k, cache.v, cache.k_scale, cache.v_scale, cache.table, i, kv_valid,
            scale=scale, logit_softcap=cfg.attn_logit_softcap, window=window,
            self_kv=(k.reshape(B, Hkv, D), v.reshape(B, Hkv, D), self_ok), prep=prep)
    elif decode:
        attn_out = decode_attention_stacked(
            q, cache.k, cache.v, i, kv_valid, scale=scale,
            logit_softcap=cfg.attn_logit_softcap, window=window,
            self_kv=(k.reshape(B, Hkv, D), v.reshape(B, Hkv, D), self_ok),
            k_scale=cache.k_scale, v_scale=cache.v_scale)
    elif paged:
        append_paged_layer(cache.k[i], cache.v[i], k, v, offsets, cache.table, ks, vs)

        def view(pool):
            return None if pool is None else gather_layer(pool, cache.table)

        attn_out = attention(
            q, dequant_kv(view(cache.k[i])[..., :D], view(ks), x.dtype),
            dequant_kv(view(cache.v[i])[..., :D], view(vs), x.dtype), positions, kv_valid,
            scale=scale, logit_softcap=cfg.attn_logit_softcap, mask=mask, alibi_slopes=slopes)
    else:
        update_layer(cache.k[i], cache.v[i], k, v, offsets, ks, vs)
        if fused_prefill:
            attn_out = prefill_attention(q, cache.k[i], cache.v[i], ks, vs, kv_valid,
                                         scale=scale, logit_softcap=cfg.attn_logit_softcap,
                                         window=window, pos0=offsets)
        else:
            attn_out = attention(
                q, dequant_kv(cache.k[i][..., :D], ks, x.dtype),
                dequant_kv(cache.v[i][..., :D], vs, x.dtype), positions, kv_valid,
                scale=scale, logit_softcap=cfg.attn_logit_softcap, mask=mask,
                alibi_slopes=slopes)
    x = x + qlinear(attn_out.reshape(B, T, -1), lp["wo"])

    h = _norm(x, lp, "ffn_norm", cfg)
    if cfg.n_experts > 0 and "gate_exps" in lp:
        ffn_out = _moe_ffn(h, lp, cfg)
    elif "w_gateup" in lp:
        # the reference's order (booster_tpu/models/llama.py:552-580): the
        # whole-MLP kernel (ops.mlp.qmm_mlp), then act·mul inside the
        # gate-up kernel (ops.qmm.qmm_gateup), then unfused; None = not taken
        ffn_out = qmm_mlp(h, lp["w_gateup"], lp["w_down"], cfg.act)
        if ffn_out is None:
            mid = qmm_gateup(h, lp["w_gateup"], cfg.act)
            if mid is None:
                gu = qlinear(h, lp["w_gateup"])
                ff = gu.shape[-1] // 2
                mid = act_mul(gu[..., :ff], gu[..., ff:], cfg.act)
            ffn_out = qlinear(mid, lp["w_down"])
    elif "w_gate" in lp:
        ffn_out = qlinear(_act(qlinear(h, lp["w_gate"]), cfg.act) * qlinear(h, lp["w_up"]),
                          lp["w_down"])
    else:  # no gate (mpt): up → act → down
        ffn_out = qlinear(_act(qlinear(h, lp["w_up"]), cfg.act), lp["w_down"])
    x = x + ffn_out
    return x, (k, v)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache,
            last_only: bool = False, gather_idx: Optional[torch.Tensor] = None,
            n_valid: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, Any]:
    """Run the decoder over a KVCache or a PagedKVCache: (logits [B, T or 1,
    V] f32, the cache updated in place).  Token positions are
    cache.lengths[b] + t; with `n_valid`, rows are right-padded and only the
    first n_valid[b] tokens advance the cache."""
    _check_ported(cfg)
    B, T = tokens.shape
    dev = tokens.device
    offsets = cache.lengths
    positions = offsets[:, None] + torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    adv = (torch.clamp(n_valid, max=T).to(torch.int32) if n_valid is not None
           else torch.full((B,), T, dtype=torch.int32, device=dev))
    emb = params["tok_embd"]
    x = emb[tokens.long()].to(torch.bfloat16)
    if cfg.embedding_scale != 1.0:
        x = (x.float() * cfg.embedding_scale).to(x.dtype)
    cos, sin = rope_tables(positions, params["rope"]["inv_freq"], params["rope"]["mscale"])
    S = cache.max_len
    layers = params["layers"]
    paged = isinstance(cache, PagedKVCache)
    page = cache.page_size if paged else 0

    # the reference's second gate (_use_stacked_decode, booster_tpu/models/
    # llama.py:48-73) holds wherever this one is open: the port pads every
    # cache to a storage width of a multiple of 128, a pool's length is whole
    # pages, and MLA is refused
    if _use_fused_decode(cfg, T, S, page):
        self_ok = (adv > 0).to(torch.int32)
        prep = None
        if paged:  # the layer-invariant lengths and window, once per step
            window = cfg.sliding_window if cfg.sliding_window > 0 else None
            prep = paged_decode_prep(offsets, window, B=B, P=cache.page_size,
                                     MAXP=cache.table.shape[1])
        new_k, new_v = [], []
        for i in range(cfg.n_layers):
            x, (k, v) = _layer(x, _layer_view(layers, i), i, cache, positions, cos, sin,
                               None, offsets, offsets, cfg, decode=True, self_ok=self_ok,
                               prep=prep)
            new_k.append(k.reshape(B, cfg.n_kv_heads, -1))
            new_v.append(v.reshape(B, cfg.n_kv_heads, -1))
        append = kv_append_all_layers_paged if paged else kv_append
        append(cache.k, cache.v, torch.stack(new_k), torch.stack(new_v), offsets,
               *((cache.table,) if paged else ()), cache.k_scale, cache.v_scale)
    else:  # prefill, and a decode step the gates keep from the stacked form
        kv_valid = offsets + adv
        fused = (cache.quantized and not paged and not cfg.alibi_max_bias
                 and prefill_supported(T, S, cache.k.shape[-1], cfg.n_heads, cfg.n_kv_heads))
        mask = None if fused else build_mask(
            positions, kv_valid, S, cfg.sliding_window if cfg.sliding_window > 0 else None)
        slopes = (_alibi_slopes(cfg.n_heads, cfg.alibi_max_bias, dev)
                  if cfg.alibi_max_bias > 0 else None)
        for i in range(cfg.n_layers):
            x, _ = _layer(x, _layer_view(layers, i), i, cache, positions, cos, sin,
                          mask, offsets, kv_valid, cfg, decode=False, fused_prefill=fused,
                          slopes=slopes)
    return _finish(params, cfg, x, emb, cache, gather_idx, last_only, adv)


def tied_head(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits [.., V] f32: bf16 x against the bf16 token
    table [V, C] with f32 accumulation and f32 output, the reference's
    ``dot_general(..., preferred_element_type=f32)`` (llama.py:905-913), a
    plain large product that it leaves to XLA.  On the card one cuBLAS
    product with an f32 output (``torch.mm(..., out_dtype=torch.float32)``),
    reading the table as it lies; on the CPU (tests) the f32 product of the
    widened operands.  No per-call copy of the table on the card."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    table = emb.to(torch.bfloat16)
    if x2.device.type == "cpu":
        y = x2.float() @ table.float().t()
    else:
        y = torch.mm(x2, table.t(), out_dtype=torch.float32)
    return y.reshape(*lead, table.shape[0])


def _finish(params, cfg, x, emb, cache, gather_idx, last_only, adv):
    """Final norm, lm head, cache length advance."""
    B = x.shape[0]
    x = _norm(x, params, "output_norm", cfg)
    if gather_idx is not None:
        x = x[torch.arange(B, device=x.device), gather_idx.long()][:, None, :]
    elif last_only:
        x = x[:, -1:, :]
    out_w = params.get("output")
    logits = qlinear(x, out_w) if out_w is not None else tied_head(x, emb)
    logits = logits.float()
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap > 0:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    cache.lengths = cache.lengths + adv
    return logits, cache
