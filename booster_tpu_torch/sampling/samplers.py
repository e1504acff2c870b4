"""The standard sampler chain over a batch of logit rows, in torch.

Port of ``booster_tpu/sampling/samplers.py`` (reference semantics:
llama.cpp/src/llama-sampling.cpp): repetition penalties over the recent
token ring, then the filters in the params' order (top-k, tail-free,
typical, top-p, min-p, temperature), each masking logits to -inf instead of
shrinking a candidate list, then a draw — or the argmax when temp <= 0.
Draws use one ``torch.Generator`` per slot, seeded from the request's seed;
they give other numbers than the JAX package's PRNG keys, so only the
greedy path compares token for token.  Mirostat is not ported yet (Janus
lives in the engine's not-ported branch).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from booster_tpu_torch.sampling.params import SamplingParams

NEG_INF = float("-inf")


_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product a·b, for a constant a
    and an int64 tensor b of 32-bit values, without overflowing int64."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    mid = a_hi * b_lo + a_lo * b_hi  # < 2^33
    t = a_lo * b_lo + ((mid & 0xFFFF) << 16)  # < 2^33
    return (a_hi * b_hi + (mid >> 16) + (t >> 32)) & _MASK32, t & _MASK32


def philox4x32(counter, key, rounds: int = 10):
    """Philox4x32 (Salmon et al., SC'11) over int64 tensors holding 32-bit
    values: counter (c0, c1, c2, c3), key (k0, k1) → 4 words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def philox_uniform(seed: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """f32 uniforms in [0, 1) (24 random bits) from Philox4x32-10 keyed by
    `seed` at counter (step, 0, 0, 0); int64 tensors of one shape."""
    seed = seed.to(torch.int64)
    step = step.to(torch.int64)
    zero = torch.zeros_like(step)
    c0, _, _, _ = philox4x32((step & _MASK32, (step >> 32) & _MASK32, zero, zero),
                             (seed & _MASK32, (seed >> 32) & _MASK32))
    return (c0 >> 8).to(torch.float32) * (1.0 / (1 << 24))


def draw_categorical(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[B] indices drawn from softmax(logits [B, N]) (-inf = excluded) by
    the inverse CDF at the uniforms u [B]; never an excluded index."""
    probs = torch.softmax(logits.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    idx = torch.searchsorted(cum, (u[:, None] * cum[:, -1:]).contiguous(), right=True)[:, 0]
    n = logits.shape[-1]
    last = torch.where(probs > 0, torch.arange(n, device=logits.device), 0).amax(-1)
    return torch.minimum(idx, last)


@dataclass
class SamplerState:
    """Per-slot sampler state: the ring of the last N accepted tokens
    (prompt tokens seeded in), the count of accepted tokens, how many came
    from the prompt, and each slot's seed and draw count (its generator)."""

    prev_tokens: torch.Tensor  # [B, N] int32 (-1 = empty)
    prev_pos: torch.Tensor  # [B] int32
    prompt_len: torch.Tensor  # [B] int32
    seed: torch.Tensor  # [B] int64
    step: torch.Tensor  # [B] int64: draws taken by the slot


def make_sampler_state(batch: int, window: int, seed: int = 0, device="cpu") -> SamplerState:
    """Empty rings; slot s draws from seed `seed + s` until reset."""
    z = torch.zeros(batch, dtype=torch.int32, device=device)
    return SamplerState(torch.full((batch, window), -1, dtype=torch.int32, device=device),
                        z, z.clone(),
                        int(seed) + torch.arange(batch, dtype=torch.int64, device=device),
                        torch.zeros(batch, dtype=torch.int64, device=device))


def seed_prompt_row(state: SamplerState, row: int, ids) -> SamplerState:
    """Seed one slot's ring with its prompt tokens (in place; reference
    parity: every prompt token is accepted, so penalties see the prompt)."""
    N = state.prev_tokens.shape[1]
    n = len(ids)
    ring = torch.full((N,), -1, dtype=torch.int32)
    for p in range(max(0, n - N), n):
        ring[p % N] = ids[p]
    state.prev_tokens[row] = ring.to(state.prev_tokens.device)
    state.prev_pos[row] = n
    state.prompt_len[row] = n
    return state


def make_seeded_state(batch: int, window: int, seed: int, ids, device) -> SamplerState:
    """State for `batch` slots with slot 0's ring seeded with the prompt
    `ids` (reference parity: every prompt token is accepted)."""
    return seed_prompt_row(make_sampler_state(batch, window, seed, device), 0, ids)


def accept_token(state: SamplerState, tokens: torch.Tensor) -> SamplerState:
    """Push sampled tokens into the penalty history ring (in place)."""
    B, N = state.prev_tokens.shape
    idx = (state.prev_pos % N).long()
    state.prev_tokens[torch.arange(B, device=tokens.device), idx] = tokens.to(torch.int32)
    state.prev_pos += 1
    return state


def history_window_mask(prev_tokens, prev_pos, last_n) -> torch.Tensor:
    """[B, N] bool: ring entries within the last `last_n` accepted tokens
    (an int, or a [B] tensor per slot; < 0 → whole ring)."""
    B, N = prev_tokens.shape
    idx = torch.arange(N, device=prev_tokens.device)[None, :]
    recency = torch.remainder(prev_pos[:, None] - 1 - idx, N)
    if torch.is_tensor(last_n):
        ln = torch.where(last_n < 0, N, last_n)[:, None]
    else:
        ln = N if last_n < 0 else last_n
    return (prev_tokens >= 0) & (recency < ln) & (recency < prev_pos[:, None])


def apply_penalties(logits, prev_tokens, penalty_repeat, penalty_freq, penalty_present,
                    prev_pos=None, last_n=-1):
    """llama_sample_repetition_penalties_impl over the last `last_n` tokens.
    The penalties are floats, or [B, 1] tensors (and `last_n` a [B] tensor)
    for per-row values."""
    B, V = logits.shape
    valid = (history_window_mask(prev_tokens, prev_pos, last_n) if prev_pos is not None
             else prev_tokens >= 0)
    tok = torch.where(valid, prev_tokens, torch.zeros_like(prev_tokens)).long()
    counts = torch.zeros(B, V, dtype=torch.float32, device=logits.device)
    counts.scatter_add_(1, tok, valid.to(torch.float32))
    seen = counts > 0
    if torch.is_tensor(penalty_repeat) or penalty_repeat != 1.0:
        scaled = torch.where(logits <= 0, logits * penalty_repeat, logits / penalty_repeat)
        logits = torch.where(seen, scaled, logits)
    return logits - counts * penalty_freq - seen.to(torch.float32) * penalty_present


def top_k_filter(logits, k: int):
    V = logits.shape[-1]
    if k <= 0 or k >= V:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def _cutoff(logits, sorted_logits, keep_sorted):
    n_keep = keep_sorted.sum(dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, -1, n_keep - 1)
    return torch.where(logits < cutoff, torch.full_like(logits, NEG_INF), logits)


def top_p_filter(logits, p: float, min_keep: int = 1):
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    keep[..., :min_keep] = True
    return _cutoff(logits, sorted_logits, keep)


def min_p_filter(logits, min_p: float, min_keep: int = 1):
    if min_p <= 0.0:
        return logits
    max_logit = logits.amax(dim=-1, keepdim=True)
    thresh = max_logit + torch.log(torch.tensor(min_p, device=logits.device))
    kth = torch.topk(logits, max(min_keep, 1), dim=-1).values[..., -1:]
    return torch.where(logits < torch.minimum(thresh, kth),
                       torch.full_like(logits, NEG_INF), logits)


def tfs_filter(logits, z: float, min_keep: int = 1):
    """Tail-free sampling: drop the tail by curvature of the sorted probs."""
    if z >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    d2 = torch.abs(torch.diff(probs, n=2, dim=-1))
    norm = d2.sum(dim=-1, keepdim=True)
    d2 = torch.where(norm > 0, d2 / torch.clamp_min(norm, 1e-20),
                     torch.full_like(d2, 1.0 / d2.shape[-1]))
    cum = torch.cumsum(d2, dim=-1)
    keep2 = cum < z
    keep = torch.cat([torch.ones_like(keep2[..., :1]), keep2, cum[..., -1:] < z], dim=-1)
    keep[..., :min_keep] = True
    return _cutoff(logits, sorted_logits, keep)


def typical_filter(logits, p: float, min_keep: int = 1):
    if p >= 1.0:
        return logits
    lp = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(lp)
    ent = -torch.where(probs > 0, probs * lp, torch.zeros_like(lp)).sum(dim=-1, keepdim=True)
    shifted = torch.abs(-lp - ent)
    order = torch.argsort(shifted, dim=-1, stable=True)
    probs_sorted = torch.gather(probs, -1, order)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = (cum - probs_sorted) < p
    keep_sorted[..., :min_keep] = True
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def apply_temp(logits, params: SamplingParams):
    t = params.temp
    if params.dynatemp_range > 0.0:
        t_min = max(0.0, t - params.dynatemp_range)
        t_max = t + params.dynatemp_range
        lp = torch.log_softmax(logits, dim=-1)
        probs = torch.exp(lp)
        ent = -torch.where(probs > 0, probs * lp, torch.zeros_like(lp)).sum(dim=-1, keepdim=True)
        n_valid = torch.isfinite(logits).sum(dim=-1, keepdim=True)
        max_ent = torch.log(torch.clamp_min(n_valid.float(), 2.0))
        norm_ent = torch.clamp(ent / torch.clamp_min(max_ent, 1e-9), 0.0, 1.0)
        dyn_t = t_min + (t_max - t_min) * norm_ent ** params.dynatemp_exponent
        return logits / torch.clamp_min(dyn_t, 1e-9)
    if t <= 0.0:
        return logits
    return logits / t


def apply_filters(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """The filter chain in the params' order (``samplers_sequence``) over
    [B, V] f32 logits: what the draw sees."""
    for ch in params.samplers_sequence:
        if ch == "k":
            logits = top_k_filter(logits, params.top_k)
        elif ch == "f":
            logits = tfs_filter(logits, params.tfs_z)
        elif ch == "y":
            logits = typical_filter(logits, params.typical_p)
        elif ch == "p":
            logits = top_p_filter(logits, params.top_p)
        elif ch == "m":
            logits = min_p_filter(logits, params.min_p)
        elif ch == "t":
            logits = apply_temp(logits, params)
    return logits


def sample(logits: torch.Tensor, state: SamplerState, params: SamplingParams,
           nl_token: int = -1) -> tuple[torch.Tensor, SamplerState]:
    """Full chain: penalties → filters (params order) → temp → draw (or
    argmax when temp <= 0).  Returns (tokens [B] int32, updated state)."""
    if params.mirostat in (1, 2):
        raise NotImplementedError("mirostat sampling: not ported yet")
    logits = logits.float()
    if params.penalty_repeat != 1.0 or params.penalty_freq != 0.0 or params.penalty_present != 0.0:
        nl_saved = logits[:, nl_token].clone() if (not params.penalize_nl and nl_token >= 0) else None
        logits = apply_penalties(logits, state.prev_tokens, params.penalty_repeat,
                                 params.penalty_freq, params.penalty_present,
                                 prev_pos=state.prev_pos, last_n=params.penalty_last_n)
        if nl_saved is not None:
            logits[:, nl_token] = nl_saved
    if params.temp <= 0.0:
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        u = philox_uniform(state.seed, state.step)
        tokens = draw_categorical(apply_filters(logits, params), u).to(torch.int32)
        state.step += 1
    return tokens, accept_token(state, tokens)
