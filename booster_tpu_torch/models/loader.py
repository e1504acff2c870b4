"""Load a GGUF model into the port's params (QTensors and torch tensors,
layers stacked on a leading axis).

Port of the llama path of ``booster_tpu/models/loader.py``: every Q4_0 or
Q8_0 weight is repacked losslessly (quant.qtensor) or, with ``weights="bf16"``,
dequantized exactly to dense bf16 (``"auto"`` picks as the JAX loader
does), the q/k rows of
interleaved-rope models are de-interleaved so rope runs in the neox form
(exact), q/k/v and gate/up rows are fused into one matmul each, layers are
stacked, and the stacks are transposed to the K-major i4t / i8t layout with
bf16 scale planes where the kernels take the shape.  ``params_from_numpy`` turns
the JAX package's params (as numpy arrays) into the same structure.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.gguf import GGMLType, GGUFReader
from booster_tpu_torch.models.config import ROPE_NEOX, ROPE_NORM, ModelConfig
from booster_tpu_torch.ops.qmm import transposable
from booster_tpu_torch.ops.rope import rope_inv_freq, yarn_params
from booster_tpu_torch.quant import dequantize, repack_gguf_tensor
from booster_tpu_torch.quant.qtensor import (
    QTensor,
    compact_scales,
    prepare_kernel_scales,
    repack_weights,
    to_torch,
    transpose_qtensor,
)
from booster_tpu_torch.tokenizer import Tokenizer

# GGUF layer-tensor name → param key (the llama family's tensors)
_LAYER_MAP = {
    "attn_norm.weight": "attn_norm",
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_norm.weight": "ffn_norm",
    "ffn_gate.weight": "w_gate",
    "ffn_up.weight": "w_up",
    "ffn_down.weight": "w_down",
}
_NORM_KEYS = {"attn_norm", "ffn_norm"}
_PORTED_ARCHS = {"llama"}


# weights="auto" takes bf16 only when the whole file fits in this many bytes
# as bf16: the JAX loader's default (booster_tpu/models/loader.py:296)
WEIGHTS_BF16_MAX_BYTES = 6 << 30


def _stack_qtensors(qts: list[QTensor]) -> QTensor:
    """Stack per-layer QTensors along a new leading axis."""
    q0 = qts[0]
    for q in qts[1:]:
        if (q.kind, q.group, q.shape, q.zero) != (q0.kind, q0.group, q0.shape, q0.zero):
            raise ValueError("cannot stack heterogeneous layer tensors")
    return QTensor(
        kind=q0.kind,
        qw=np.stack([np.asarray(q.qw) for q in qts]),
        scales=None if q0.scales is None else np.stack([np.asarray(q.scales) for q in qts]),
        mins=None if q0.mins is None else np.stack([np.asarray(q.mins) for q in qts]),
        group=q0.group,
        shape=q0.shape,
        source_type=q0.source_type,
        zero=q0.zero,
    )


def _concat_rows(qts: list[QTensor]) -> Optional[QTensor]:
    """Fuse weights along out-features (q+k+v → qkv, gate+up → gateup);
    None when the parts differ in kind, group, in-features or zero point."""
    q0 = qts[0]
    for q in qts[1:]:
        if (q.kind, q.group, q.shape[1], q.zero) != (q0.kind, q0.group, q0.shape[1], q0.zero):
            return None
        if (q.scales is None) != (q0.scales is None) or (q.mins is None) != (q0.mins is None):
            return None

    def cat(name):
        if getattr(q0, name) is None:
            return None
        return np.concatenate([np.asarray(getattr(q, name)) for q in qts], axis=0)

    return QTensor(kind=q0.kind, qw=cat("qw"), scales=cat("scales"), mins=cat("mins"),
                   group=q0.group, shape=(sum(q.shape[0] for q in qts), q0.shape[1]),
                   source_type=q0.source_type, zero=q0.zero)


def deinterleave_perm(n_heads: int, head_dim: int, d_rot: int) -> np.ndarray:
    """Row permutation turning interleaved-rope ("norm" style) q/k weights
    into the split-half (neox) order: within each head, new[i] = old[2i] and
    new[half + i] = old[2i + 1] for the rotated prefix.  Applied to wq and wk
    alike it leaves every q·k score unchanged."""
    half = d_rot // 2
    within = np.arange(head_dim)
    within[:half] = 2 * np.arange(half)
    within[half:d_rot] = 2 * np.arange(half) + 1
    return (np.arange(n_heads)[:, None] * head_dim + within[None, :]).reshape(-1)


def _permute_rows(t: QTensor, perm: np.ndarray) -> QTensor:
    return dataclasses.replace(
        t,
        qw=np.asarray(t.qw)[perm],
        scales=None if t.scales is None else np.asarray(t.scales)[perm],
        mins=None if t.mins is None else np.asarray(t.mins)[perm],
    )


def _kernel_layout(qt: QTensor, dev: Optional[torch.device] = None) -> QTensor:
    """Prepared scales, then K-major (i4p → i4t, i8 → i8t) with bf16 scale
    planes where the kernel takes the shape; with `dev`, the tensor moves
    there first and is transposed there."""
    qt = prepare_kernel_scales(qt)
    if transposable(qt):
        if dev is not None:
            qt = to_torch(qt, dev)
        qt = compact_scales(transpose_qtensor(qt))
    return qt


@dataclasses.dataclass
class LoadedModel:
    cfg: ModelConfig
    params: dict[str, Any]
    tokenizer: Optional[Tokenizer]
    metadata: dict[str, Any]
    device: torch.device


def resolve_weights(reader: GGUFReader, weights: str, batch_hint: int) -> str:
    """The weight format `load_model` uses: "auto" keeps the file's
    quantization for small decode batches (0 < batch_hint < 8, where the
    4-bit matvec kernels win) and takes bf16 otherwise, when the file fits
    in WEIGHTS_BF16_MAX_BYTES as bf16 (``booster_tpu/models/loader.py:292-305``)."""
    if weights != "auto":
        return weights
    if 0 < batch_hint < 8:
        return "native"
    n_elems = sum(int(np.prod(info.shape)) for info in reader.tensors.values())
    return "bf16" if 2 * n_elems <= WEIGHTS_BF16_MAX_BYTES else "native"


def load_model(path: str, device="cuda", weights: str = "native",
               batch_hint: int = 0) -> LoadedModel:
    """Read a GGUF file and build the params on `device` (CUDA by default;
    raises when CUDA is absent and the CPU was not asked for).  `weights` is
    "native", "bf16" or "auto" (see resolve_weights; `batch_hint` is the
    expected decode batch, 0 = unknown)."""
    dev = resolve_device(device)
    if weights not in ("native", "bf16", "auto"):
        raise NotImplementedError(f"weights={weights!r}: not ported yet")
    reader = GGUFReader(path)
    try:
        cfg = ModelConfig.from_gguf_metadata(reader.metadata)
        if cfg.arch not in _PORTED_ARCHS:
            raise NotImplementedError(f"architecture {cfg.arch!r}: not ported yet")
        weights = resolve_weights(reader, weights, batch_hint)
        tokenizer = None
        if "tokenizer.ggml.tokens" in reader.metadata:
            tokenizer = Tokenizer.from_gguf_metadata(reader.metadata)

        def load_dense(name: str) -> Optional[np.ndarray]:
            info = reader.tensors.get(name)
            if info is None:
                return None
            return dequantize(reader.tensor_bytes(info), info.ggml_type,
                              shape=info.shape).astype(np.float32)

        def load_q(name: str) -> Optional[QTensor]:
            info = reader.tensors.get(name)
            if info is None:
                return None
            qt = repack_gguf_tensor(reader.tensor_bytes(info), info.ggml_type, info.shape)
            return repack_weights(qt, weights)

        params: dict[str, Any] = {}
        emb = load_dense("token_embd.weight")
        if emb is None:
            raise ValueError("model has no token_embd.weight")
        params["tok_embd"] = torch.from_numpy(emb).to(torch.bfloat16)
        params["output_norm"] = torch.from_numpy(load_dense("output_norm.weight"))
        out_q = load_q("output.weight")
        params["output"] = None if out_q is None else _kernel_layout(out_q, dev)
        rope_factors = load_dense("rope_freqs.weight")
        inv_freq = rope_inv_freq(cfg, rope_factors)
        pos_scale, mscale = yarn_params(cfg)
        params["rope"] = {"inv_freq": (inv_freq * pos_scale).astype(np.float32),
                          "mscale": float(mscale)}

        deint = cfg.rope_style == ROPE_NORM and cfg.rope_dims > 1
        layer_dicts = []
        for i in range(cfg.n_layers):
            lp: dict[str, Any] = {}
            for suffix, key in _LAYER_MAP.items():
                name = f"blk.{i}.{suffix}"
                if name not in reader.tensors:
                    continue
                lp[key] = load_dense(name) if key in _NORM_KEYS else load_q(name)
            if {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"} - set(lp):
                raise NotImplementedError(f"layer {i}: tensor set not ported yet")
            if deint:
                lp["wq"] = _permute_rows(lp["wq"], deinterleave_perm(
                    cfg.n_heads, cfg.head_dim, cfg.rope_dims))
                lp["wk"] = _permute_rows(lp["wk"], deinterleave_perm(
                    cfg.n_kv_heads, cfg.head_dim, cfg.rope_dims))
            fused = _concat_rows([lp["wq"], lp["wk"], lp["wv"]])
            if fused is not None:
                lp["wqkv"] = fused
                del lp["wq"], lp["wk"], lp["wv"]
            fused = _concat_rows([lp["w_gate"], lp["w_up"]])
            if fused is not None:
                lp["w_gateup"] = fused
                del lp["w_gate"], lp["w_up"]
            layer_dicts.append(lp)
        if deint:
            cfg = dataclasses.replace(cfg, rope_style=ROPE_NEOX, rope_deinterleaved=True)

        layers: dict[str, Any] = {}
        for key in sorted(layer_dicts[0]):
            vals = [lp[key] for lp in layer_dicts]
            if isinstance(vals[0], QTensor):
                layers[key] = _kernel_layout(_stack_qtensors(vals), dev)
                for lp in layer_dicts:  # the per-layer parts are stacked now
                    del lp[key]
            else:
                layers[key] = np.stack(vals)
        params["layers"] = layers
        metadata = dict(reader.metadata)
    finally:
        reader.close()
    return LoadedModel(cfg=cfg, params=_to_device(params, dev), tokenizer=tokenizer,
                       metadata=metadata, device=dev)


def _to_device(params: dict, dev: torch.device) -> dict:
    def conv(v):
        if isinstance(v, QTensor):
            return to_torch(v, dev)
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if v is None or isinstance(v, float):
            return v
        return (v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))).to(dev)

    return conv(params)


def _np_to_torch(a) -> torch.Tensor:
    """numpy → torch; bfloat16 arrays (no numpy-native dtype) go through
    their 16-bit pattern."""
    a = np.array(a)  # a writable copy: arrays read from JAX are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(params: dict, cfg: ModelConfig, device="cpu") -> dict:
    """The JAX package's loaded params, given as numpy arrays (QTensor
    fields included), → the port's params on `device`.  QTensors are
    duck-typed by their fields; the JAX class is not imported."""
    dev = resolve_device(device)

    def conv(v):
        if hasattr(v, "kind") and hasattr(v, "qw"):
            if v.kind not in ("i4p", "i4t", "i8", "i8t", "dense"):
                raise NotImplementedError(f"QTensor kind {v.kind!r}: not ported yet")
            return QTensor(
                kind=v.kind,
                qw=_np_to_torch(v.qw).to(dev),
                scales=None if v.scales is None else _np_to_torch(v.scales).to(dev),
                mins=None if v.mins is None else _np_to_torch(v.mins).to(dev),
                group=int(v.group), shape=tuple(int(s) for s in v.shape),
                source_type=GGMLType(int(v.source_type)), zero=int(v.zero))
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if v is None:
            return None
        a = np.asarray(v)
        if a.ndim == 0 and a.dtype.name != "bfloat16":
            return float(a)
        return _np_to_torch(a).to(dev)

    out = conv(params)
    n = out["layers"]["attn_norm"].shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"params hold {n} layers, config says {cfg.n_layers}")
    return out
