"""Per-slot vectorized sampling: every parameter is a [B] tensor, so one
decode step serves a continuous batch of requests with different temp /
top-k / top-p / min-p / tail-free / typical / dynatemp / penalties.

Port of ``booster_tpu/sampling/vector.py``: the filters reproduce
llama-sampling.cpp's queue (top-k → tail-free → typical → top-p → min-p,
each renormalizing over the survivors) as boolean masks over one
descending top-256 shortlist, and rows whose filters keep the shortlist's
support sample in shortlist space.  ``features`` is the engine's set of
what some slot uses: "nopenalties" skips the [B, V] penalty pass, "exttail"
runs tail-free/typical/dynatemp, "fullv" samples rows with no subset filter
over the whole vocabulary (the reference then samples every row over the
vocabulary, from the same distribution; the port keeps the other rows'
shortlist draws, so a row's draws do not depend on its neighbours).  Janus, mirostat and classifier-free guidance in
the batch are not ported yet.

The shortlist is ``torch.topk`` (exact; the JAX package's approximate top-k
is verified exact before use, so both give the same set).  Each slot draws
one uniform per step from its own counter-based generator (Philox4x32-10
keyed by the slot's seed at counter = the slot's step count,
``samplers.philox_uniform``), all slots in one pass on the device; a masked
row neither draws nor advances its step or its history ring, so a slot's
tokens do not depend on the other slots.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from booster_tpu_torch.sampling.params import SamplingParams
from booster_tpu_torch.sampling.samplers import (
    SamplerState,
    apply_penalties,
    draw_categorical,
    philox_uniform,
)

NEG_INF = float("-inf")
SHORTLIST = 256
_DTYPES = {"top_k": np.int32, "penalty_last_n": np.int32, "penalize_nl": bool}  # else f32


def topk_shortlist(lg: torch.Tensor, K: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-K shortlist: (descending values, their indices) [B, K]."""
    return torch.topk(lg, K, dim=-1, largest=True, sorted=True)


@dataclass
class VectorSampling:
    """Per-slot sampling knobs, [B] tensors on the engine's device."""

    temp: torch.Tensor  # f32; <= 0 → greedy
    top_k: torch.Tensor  # i32; <= 0 → disabled
    top_p: torch.Tensor  # f32; >= 1 → disabled
    min_p: torch.Tensor  # f32; <= 0 → disabled
    tfs_z: torch.Tensor  # f32; >= 1 → disabled
    typical_p: torch.Tensor  # f32; >= 1 → disabled
    dynatemp_range: torch.Tensor  # f32; <= 0 → disabled
    dynatemp_exponent: torch.Tensor  # f32
    penalty_repeat: torch.Tensor  # f32; 1.0 → disabled
    penalty_freq: torch.Tensor
    penalty_present: torch.Tensor
    penalty_last_n: torch.Tensor  # i32; window over the history ring (-1 → all)
    penalize_nl: torch.Tensor  # bool; False → NL logit restored post-penalty

    @classmethod
    def from_params(cls, plist: list[SamplingParams], device="cpu") -> "VectorSampling":
        def arr(name):
            a = np.array([getattr(p, name) for p in plist], _DTYPES.get(name, np.float32))
            return torch.from_numpy(a).to(device)

        return cls(**{f.name: arr(f.name) for f in fields(cls)})

    def set_slot(self, slot: int, p: SamplingParams) -> "VectorSampling":
        """Write one slot's knobs (in place; returns self)."""
        for f in fields(self):
            getattr(self, f.name)[slot] = getattr(p, f.name)
        return self


def chain_cutoff(lg: torch.Tensor, vp: VectorSampling) -> torch.Tensor:
    """Per-row logit cutoff [B, 1] combining top-k/top-p/min-p over the
    top-K shortlist; disabled filters contribute -inf."""
    B, V = lg.shape
    K = min(SHORTLIST, V)
    sorted_lg, _ = topk_shortlist(lg, K)
    probs = torch.softmax(sorted_lg, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    k = torch.clamp(vp.top_k, 1, K)
    k_cut = torch.gather(sorted_lg, 1, (k - 1).long()[:, None])
    k_cut = torch.where(vp.top_k[:, None] <= 0, NEG_INF, k_cut)
    keep_sorted = (cum - probs) < vp.top_p[:, None]
    n_keep = torch.clamp_min(keep_sorted.sum(-1), 1)
    p_cut = torch.gather(sorted_lg, 1, (n_keep - 1)[:, None])
    p_cut = torch.where(vp.top_p[:, None] >= 1.0, NEG_INF, p_cut)
    m_cut = sorted_lg[:, :1] + torch.log(torch.clamp_min(vp.min_p[:, None], 1e-20))
    m_cut = torch.where(vp.min_p[:, None] <= 0, NEG_INF, m_cut)
    return torch.maximum(torch.maximum(k_cut, p_cut), m_cut)


def _chain_keep(sorted_lg: torch.Tensor, vp: VectorSampling, features: tuple = ()) -> torch.Tensor:
    """[B, K] survivor mask of the queue k → tfs → typical → top-p → min-p
    over the descending shortlist, renormalized after each filter
    (``vector.py:203-268``); tfs and typical run only with "exttail"."""
    B, K = sorted_lg.shape
    dev = sorted_lg.device
    pos = torch.arange(K, device=dev)[None, :]

    def renorm(keep):
        return torch.softmax(torch.where(keep, sorted_lg, NEG_INF), dim=-1)

    k = torch.where(vp.top_k <= 0, K, torch.clamp(vp.top_k, 1, K))
    keep = pos < k[:, None]

    if "exttail" in features:
        p = renorm(keep)
        d2 = torch.abs(p[:, :-2] - 2.0 * p[:, 1:-1] + p[:, 2:])
        norm = d2.sum(-1, keepdim=True)
        d2 = torch.where(norm > 0, d2 / torch.clamp_min(norm, 1e-20),
                         torch.full_like(d2, 1.0 / (K - 2)))
        cum = torch.cumsum(d2, dim=-1)
        keep_f = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=dev),
                            cum < vp.tfs_z[:, None], cum[:, -1:] < vp.tfs_z[:, None]], dim=-1)
        keep = keep & (keep_f | (vp.tfs_z >= 1.0)[:, None])

        p = renorm(keep)
        lp = torch.log(torch.clamp_min(p, 1e-38))
        ent = -torch.where(keep, p * lp, 0.0).sum(-1, keepdim=True)
        shifted = torch.where(keep, torch.abs(-lp - ent), float("inf"))
        order = torch.argsort(shifted, dim=-1, stable=True)
        p_srt = torch.gather(p, 1, order)
        cum = torch.cumsum(p_srt, dim=-1)
        keep_srt = (cum - p_srt) < torch.clamp_min(vp.typical_p, 1e-9)[:, None]
        keep_y = torch.zeros_like(keep).scatter(1, order, keep_srt)
        keep = keep & (keep_y | (vp.typical_p >= 1.0)[:, None])

    p = renorm(keep)
    cum = torch.cumsum(p, dim=-1)
    keep_p = (cum - p) < torch.clamp_min(vp.top_p, 1e-9)[:, None]
    keep = keep & (keep_p | (vp.top_p >= 1.0)[:, None])

    p = renorm(keep)
    pmax = p.amax(-1, keepdim=True)
    keep_m = (p >= vp.min_p[:, None] * pmax) | (p == pmax)
    return keep & (keep_m | (vp.min_p <= 0.0)[:, None])


def _any_subset(vp: VectorSampling) -> torch.Tensor:
    """[B] bool: the row has a subset filter enabled (its support then fits
    the shortlist)."""
    return ((vp.top_k > 0) | (vp.top_p < 1.0) | (vp.min_p > 0.0)
            | (vp.tfs_z < 1.0) | (vp.typical_p < 1.0))


def chain_filter(logits: torch.Tensor, vp: VectorSampling, features: tuple = ()) -> torch.Tensor:
    """[B, V] logits at -inf outside the queue's survivors; rows with every
    subset filter disabled keep the whole vocabulary."""
    B, V = logits.shape
    sorted_lg, sorted_idx = topk_shortlist(logits, min(SHORTLIST, V))
    keep = _chain_keep(sorted_lg, vp, features)
    keep_v = torch.zeros(B, V, dtype=torch.bool, device=logits.device).scatter(1, sorted_idx, keep)
    keep_v = keep_v | ~_any_subset(vp)[:, None]
    return torch.where(keep_v, logits, NEG_INF)


def effective_temp(filtered: torch.Tensor, vp: VectorSampling, features: tuple = ()) -> torch.Tensor:
    """[B, 1] sampling temperature: dynatemp's entropy scaling where a row
    enables it ("exttail"), else the row's temp."""
    t = torch.clamp_min(vp.temp, 1e-6)[:, None]
    if "exttail" not in features:
        return t
    lp = torch.log_softmax(filtered, dim=-1)
    probs = torch.exp(lp)
    ent = -torch.where(probs > 0, probs * lp, 0.0).sum(-1, keepdim=True)
    n_valid = torch.isfinite(filtered).sum(-1, keepdim=True)
    max_ent = torch.log(torch.clamp_min(n_valid.float(), 2.0))
    norm_ent = torch.clamp(ent / torch.clamp_min(max_ent, 1e-9), 0.0, 1.0)
    t_min = torch.clamp_min(vp.temp - vp.dynatemp_range, 0.0)[:, None]
    t_max = (vp.temp + vp.dynatemp_range)[:, None]
    dyn_t = t_min + (t_max - t_min) * norm_ent ** vp.dynatemp_exponent[:, None]
    return torch.where((vp.dynatemp_range > 0)[:, None], torch.clamp_min(dyn_t, 1e-9), t)


def apply_penalties_vec(lg: torch.Tensor, state: SamplerState, vp: VectorSampling,
                        nl_token: int = -1) -> torch.Tensor:
    """Repetition/frequency/presence penalties with per-row parameters over
    each row's last penalty_last_n accepted tokens (``vector.py:355-370``)."""
    out = apply_penalties(lg, state.prev_tokens, vp.penalty_repeat[:, None],
                          vp.penalty_freq[:, None], vp.penalty_present[:, None],
                          prev_pos=state.prev_pos, last_n=vp.penalty_last_n)
    if nl_token >= 0:
        out[:, nl_token] = torch.where(vp.penalize_nl, out[:, nl_token], lg[:, nl_token])
    return out


def sample_vectorized(logits: torch.Tensor, state: SamplerState, vp: VectorSampling,
                      mask=None, features: tuple = (), nl_token: int = -1,
                      u=None) -> tuple[torch.Tensor, SamplerState]:
    """One token per row ([B] int32) and the state advanced in place for the
    rows of `mask` (all rows when None).  `u` [B] are the rows' uniforms
    when the caller drew them ahead (the decode chunk); else each row draws
    philox_uniform(seed, step)."""
    for f in ("janus", "mirostat", "cfg"):
        if f in features:
            raise NotImplementedError(f"{f} in the batched sampler: not ported yet")
    B, V = logits.shape
    lg = logits.float()
    if "nopenalties" not in features:
        lg = apply_penalties_vec(lg, state, vp, nl_token)
    if u is None:
        u = philox_uniform(state.seed, state.step)
    sorted_lg, sorted_idx = topk_shortlist(lg, min(SHORTLIST, V))
    keep = _chain_keep(sorted_lg, vp, features)
    slg = torch.where(keep, sorted_lg, NEG_INF)
    t = effective_temp(slg, vp, features)
    sampled = torch.gather(sorted_idx, 1, draw_categorical(slg / t, u)[:, None])[:, 0]
    if "fullv" in features:
        # rows with no subset filter draw over the whole vocabulary; the
        # others keep their shortlist draw, so a row's tokens do not depend
        # on whether another slot asked for this feature
        full = draw_categorical(lg / effective_temp(lg, vp, features), u)
        sampled = torch.where(_any_subset(vp), sampled, full)
    # argmax from the shortlist: the smallest vocab index among ties
    is_top = sorted_lg == sorted_lg[:, :1]
    greedy = torch.where(is_top, sorted_idx, V).amin(-1)
    greedy = torch.where(is_top.any(-1), greedy, sorted_idx[:, 0])
    tokens = torch.where(vp.temp <= 0, greedy, sampled).to(torch.int32)

    N = state.prev_tokens.shape[1]
    rows = torch.arange(B, device=lg.device)
    idx = (state.prev_pos % N).long()
    live = torch.ones(B, dtype=torch.bool, device=lg.device) if mask is None else mask
    state.prev_tokens[rows, idx] = torch.where(live, tokens, state.prev_tokens[rows, idx])
    state.prev_pos += live.to(state.prev_pos.dtype)
    state.step += live.to(state.step.dtype)
    return tokens, state
