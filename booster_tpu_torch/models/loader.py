"""Load a GGUF model into the port's params (QTensors and torch tensors,
layers stacked on a leading axis).

Port of the llama path of ``booster_tpu/models/loader.py``: every Q4_0,
Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K or Q6_K weight is repacked losslessly
(quant.qtensor; Q4_K to i4 with four scale planes, the halves' scales and
mins; Q2_K to i4 at group 16 with four, Q3_K at group 16 with two and a
zero of 4; Q5_K and
Q5_1 to int8 codes with two, the scales and mins) or, with ``weights="bf16"``,
dequantized exactly to dense bf16 (``"auto"`` picks as the JAX loader
does), or with ``weights="i8"`` widened exactly to int8; with
``weights="i8c"`` each layer's fused weights and the output head are
requantized per output channel at stack time (lossy; on the load's
device), the routed experts and a dense router excepted; the q/k rows of
interleaved-rope models are de-interleaved so rope runs in the neox form
(exact), q/k/v and gate/up rows are fused into one matmul each, layers are
stacked, and the stacks are transposed to the K-major i4t / i8t layout with
bf16 scale planes where the kernels take the shape (else they stay
lane-major, with bf16 planes where the lane-major kernel takes them: the
Q8_0 ffn_down of a Q6_K file whose ff is not a multiple of 256, as the
reference keeps it).  The routed experts of a
MoE model (Mixtral) keep the file's quantization whatever `weights` says,
lane-major (``[E·Ne, K]``, the grouped kernel's layout) with bf16 scale
planes; they are repacked on the device, and every stack is filled there one
layer at a time, so the host holds about one layer beside the result.
A Gemma file (arch ``gemma``) holds the llama tensor set without
``output.weight``: the head is tied to ``token_embd`` (llama.cpp writes it
Q6_K in its Q4_0 mix), dequantized to a dense bf16 table as the reference
loads it (``booster_tpu/models/loader.py:340-343``).
An MPT file (arch ``mpt``) holds a fused ``attn_qkv``, split into q, k and v
rows and fused again as the reference does, an ungated FFN (``ffn_up``,
``ffn_down``), and LayerNorms whose optional biases (``attn_norm.bias``,
``ffn_norm.bias``, ``output_norm.bias``) load as dense tensors; other bias
tensors are not ported yet.  ``params_from_numpy`` turns the JAX package's
params (as numpy arrays) into the same structure.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.gguf import GGMLType, GGUFReader
from booster_tpu_torch.models.config import ROPE_NEOX, ROPE_NORM, ModelConfig
from booster_tpu_torch.ops.qmm import lane_supported, transposable
from booster_tpu_torch.ops.rope import rope_inv_freq, yarn_params
from booster_tpu_torch.quant import dequantize, repack_gguf_tensor
from booster_tpu_torch.quant.qtensor import (
    QTensor,
    channel_quantize,
    compact_scales,
    dequantize as dequantize_qtensor,
    prepare_kernel_scales,
    repack_weights,
    to_torch,
    transpose_qtensor,
)
from booster_tpu_torch.tokenizer import Tokenizer

# GGUF layer-tensor name → param key (the llama family's tensors)
_LAYER_MAP = {
    "attn_norm.weight": "attn_norm",
    "attn_norm.bias": "attn_norm_b",
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_norm.weight": "ffn_norm",
    "ffn_norm.bias": "ffn_norm_b",
    "ffn_gate.weight": "w_gate",
    "ffn_up.weight": "w_up",
    "ffn_down.weight": "w_down",
    "ffn_gate_inp.weight": "router",
    "ffn_gate_exps.weight": "gate_exps",
    "ffn_up_exps.weight": "up_exps",
    "ffn_down_exps.weight": "down_exps",
}
_NORM_KEYS = {"attn_norm", "ffn_norm", "attn_norm_b", "ffn_norm_b"}
_EXPERT_KEYS = {"gate_exps", "up_exps", "down_exps"}
_ATTN_KEYS = {"wq", "wk", "wv", "wo"}
_FFN_KEYS = {"w_gate", "w_up", "w_down"}
_UNGATED_FFN_KEYS = {"w_up", "w_down"}  # mpt
# mixtral: the HF converter's name for llama + experts; gemma: the llama
# tensor set with the head tied to token_embd (no output.weight)
_PORTED_ARCHS = {"llama", "mixtral", "mpt", "gemma"}


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


def _split_rows(qt: QTensor, sizes: list[int]) -> list[QTensor]:
    """Split a QTensor along out-features (a fused qkv → q, k, v)."""
    if sum(sizes) != qt.shape[0]:
        raise ValueError(f"split sizes {sizes} != rows {qt.shape[0]}")
    out, start = [], 0
    for n in sizes:
        rows = slice(start, start + n)
        out.append(dataclasses.replace(
            qt, qw=np.asarray(qt.qw)[rows],
            scales=None if qt.scales is None else np.asarray(qt.scales)[rows],
            mins=None if qt.mins is None else np.asarray(qt.mins)[rows], shape=(n, qt.shape[1])))
        start += n
    return out


def _permute_rows(t: QTensor, perm: np.ndarray) -> QTensor:
    return dataclasses.replace(
        t,
        qw=np.asarray(t.qw)[perm],
        scales=None if t.scales is None else np.asarray(t.scales)[perm],
        mins=None if t.mins is None else np.asarray(t.mins)[perm],
    )


def _kernel_layout(qt: QTensor, dev: Optional[torch.device] = None,
                   key: Optional[str] = None) -> QTensor:
    """Prepared scales, then K-major (i4p → i4t, i8 → i8t) with bf16 scale
    planes where the kernel takes the shape; an expert stack (`key` one of
    _EXPERT_KEYS) and a weight that the lane-major kernel takes stay
    lane-major with bf16 scale planes.  With `dev`, the tensor moves there
    first and is transposed there."""
    qt = prepare_kernel_scales(qt)
    expert = key in _EXPERT_KEYS
    if expert or transposable(qt) or lane_supported(qt):
        if dev is not None:
            qt = to_torch(qt, dev)
        if transposable(qt) and not expert:
            qt = transpose_qtensor(qt)
        qt = compact_scales(qt)
    return qt


def _channel_quantize_on(qt: QTensor, dev: torch.device) -> QTensor:
    """weights="i8c" for one tensor (``booster_tpu/models/loader.py:366-368,
    535-539``): an i4p or i8 weight is requantized per output channel on
    `dev`, from the file's f32 scales; other kinds (dense) are kept."""
    return channel_quantize(to_torch(qt, dev)) if qt.kind in ("i4p", "i8") else qt


class _Stacks:
    """Per-key layer stacks [L, ...], filled one layer at a time: the fields
    of a QTensor in tensors on the device, allocated when layer 0 arrives,
    other arrays (the norms) stacked in numpy.  With `i8c`, every layer
    tensor but the routed experts is requantized per channel on the device
    as it arrives."""

    def __init__(self, n_layers: int, dev: torch.device, i8c: bool = False):
        self.n, self.dev, self.i8c = n_layers, dev, i8c
        self.q: dict[str, QTensor] = {}
        self.arrays: dict[str, list] = {}

    def put(self, i: int, key: str, v) -> None:
        if not isinstance(v, QTensor):
            self.arrays.setdefault(key, []).append(v)
            return
        if self.i8c and key not in _EXPERT_KEYS:
            v = _channel_quantize_on(v, self.dev)
        v = to_torch(prepare_kernel_scales(v), self.dev)
        if key in _EXPERT_KEYS:  # stored with bf16 planes from the start (half the bytes)
            v = compact_scales(v)
        st = self.q.get(key)
        if st is None:

            def empty(t):
                return None if t is None else torch.empty((self.n, *t.shape), dtype=t.dtype,
                                                          device=self.dev)

            st = self.q[key] = dataclasses.replace(v, qw=empty(v.qw), scales=empty(v.scales),
                                                   mins=empty(v.mins))
        elif (v.kind, v.group, v.shape, v.zero, v.qw.shape) != (
                st.kind, st.group, st.shape, st.zero, st.qw.shape[1:]):
            raise ValueError(f"{key}: cannot stack heterogeneous layer tensors")
        for f in ("qw", "scales", "mins"):
            if getattr(v, f) is not None:
                getattr(st, f)[i].copy_(getattr(v, f))

    def result(self) -> dict[str, Any]:
        out: dict[str, Any] = {k: np.stack(v) for k, v in self.arrays.items()}
        for key, st in self.q.items():
            out[key] = _kernel_layout(st, self.dev, key)
        return out


# quantized types whose torch repack then dequantize forms the same f32
# values as quant.formats.dequantize, bit for bit ((d·sc)·q, or (q - 8)·d)
_TABLE_REPACKS = (GGMLType.Q4_0, GGMLType.Q8_0, GGMLType.Q6_K)


def dense_table(reader: GGUFReader, name: str, dev: torch.device) -> torch.Tensor:
    """A token table as the dense bf16 [V, C] the reference loads
    (``dequantize(...).astype(bfloat16)``).  For the card, a quantized table
    is repacked and dequantized there by torch (the same f32 values, then
    one rounding to bf16): Gemma-2B's Q6_K table of 524 M weights takes
    about half a minute of numpy on the host."""
    info = reader.tensors[name]
    if dev.type == "cuda" and info.ggml_type in _TABLE_REPACKS:
        raw = torch.from_numpy(np.frombuffer(reader.tensor_bytes(info), np.uint8).copy())
        qt = repack_gguf_tensor(raw, info.ggml_type, info.shape, device=dev)
        return dequantize_qtensor(qt, torch.bfloat16)
    w = dequantize(reader.tensor_bytes(info), info.ggml_type, shape=info.shape)
    return torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)


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
    "native", "bf16", "i8" (exact), "i8c" (per-channel int8, lossy) or
    "auto" (see resolve_weights; `batch_hint` is the expected decode batch,
    0 = unknown)."""
    return load_from_reader(GGUFReader(path), device, weights, batch_hint)


def load_from_reader(reader: GGUFReader, device="cuda", weights: str = "native",
                     batch_hint: int = 0) -> LoadedModel:
    """load_model on an open GGUFReader (closed when it returns)."""
    dev = resolve_device(device)
    if weights not in ("native", "bf16", "i8", "i8c", "auto"):
        reader.close()
        raise ValueError(f"unknown weights mode {weights!r}")
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
            # i8c waits for the stacks: the q/k de-interleave and the row
            # fusions come first, as in the reference (loader.py:332-335)
            return qt if weights == "i8c" else repack_weights(qt, weights)

        staging: list = []  # one pinned host buffer, reused for every expert stack

        def load_experts(name: str) -> QTensor:
            """An expert stack [E, out, in] → [E·out, in] in the file's own
            quantization (reference loader.py:332), repacked on the device;
            on a GPU its bytes go there through the pinned staging buffer,
            read from the file (so the map's pages do not stay resident)."""
            info = reader.tensors[name]
            raw = reader.tensor_bytes(info)
            if dev.type == "cuda" and info.ggml_type in (GGMLType.Q4_0, GGMLType.Q8_0,
                                                         GGMLType.Q4_K, GGMLType.Q5_K,
                                                         GGMLType.Q5_1):
                if not staging or staging[0].numel() < info.nbytes:
                    staging[:] = [torch.empty(info.nbytes, dtype=torch.uint8, pin_memory=True)]
                raw = staging[0][:info.nbytes]
                reader.read_into(info, raw.numpy())
            return repack_gguf_tensor(raw, info.ggml_type, info.shape, device=dev)

        params: dict[str, Any] = {}
        if "token_embd.weight" not in reader.tensors:
            raise ValueError("model has no token_embd.weight")
        params["tok_embd"] = dense_table(reader, "token_embd.weight", dev)
        params["output_norm"] = torch.from_numpy(load_dense("output_norm.weight"))
        out_norm_b = load_dense("output_norm.bias")
        if out_norm_b is not None:
            params["output_norm_b"] = torch.from_numpy(out_norm_b)
        out_q = load_q("output.weight")
        if out_q is not None and weights == "i8c":
            out_q = _channel_quantize_on(out_q, dev)
        params["output"] = None if out_q is None else _kernel_layout(out_q, dev)
        rope_factors = load_dense("rope_freqs.weight")
        inv_freq = rope_inv_freq(cfg, rope_factors)
        pos_scale, mscale = yarn_params(cfg)
        params["rope"] = {"inv_freq": (inv_freq * pos_scale).astype(np.float32),
                          "mscale": float(mscale)}

        deint = cfg.rope_style == ROPE_NORM and cfg.rope_dims > 1
        ffn_keys = ({"router"} | _EXPERT_KEYS if cfg.n_experts
                    else _UNGATED_FFN_KEYS if cfg.arch == "mpt" else _FFN_KEYS)
        other_ffn = (_FFN_KEYS | {"router"} | _EXPERT_KEYS) - ffn_keys
        stacks = _Stacks(cfg.n_layers, dev, i8c=weights == "i8c")
        for i in range(cfg.n_layers):
            lp: dict[str, Any] = {}
            prefix = f"blk.{i}."
            for suffix, key in _LAYER_MAP.items():
                name = prefix + suffix
                if name not in reader.tensors:
                    continue
                lp[key] = (load_dense(name) if key in _NORM_KEYS
                           else load_experts(name) if key in _EXPERT_KEYS else load_q(name))
            if "wq" not in lp and prefix + "attn_qkv.weight" in reader.tensors:
                # fused projection (mpt): split as the reference does (loader.py:434-447)
                d_q, d_kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
                lp["wq"], lp["wk"], lp["wv"] = _split_rows(load_q(prefix + "attn_qkv.weight"),
                                                           [d_q, d_kv, d_kv])
            biases = [n for n in reader.tensors if n.startswith(prefix) and n.endswith(".bias")
                      and n[len(prefix):] not in _LAYER_MAP]
            if (_ATTN_KEYS | ffn_keys) - set(lp) or other_ffn & set(lp) or biases:
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
            if "w_gate" in lp:
                fused = _concat_rows([lp["w_gate"], lp["w_up"]])
                if fused is not None:
                    lp["w_gateup"] = fused
                    del lp["w_gate"], lp["w_up"]
            for key, v in lp.items():
                stacks.put(i, key, v)
            del lp
        if deint:
            cfg = dataclasses.replace(cfg, rope_style=ROPE_NEOX, rope_deinterleaved=True)
        layers = stacks.result()
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
    duck-typed by their fields; the JAX class is not imported.  Expert
    stacks and the lane-major weights that the lane-major kernel takes get
    bf16 scale planes, as the port's loader gives them (exact through the
    kernel, which rounds scales to bf16)."""
    dev = resolve_device(device)

    def conv(v, key=None):
        if hasattr(v, "kind") and hasattr(v, "qw"):
            if v.kind not in ("i4p", "i4t", "i8", "i8t", "i8c", "dense"):
                raise NotImplementedError(f"QTensor kind {v.kind!r}: not ported yet")
            qt = QTensor(
                kind=v.kind,
                qw=_np_to_torch(v.qw).to(dev),
                scales=None if v.scales is None else _np_to_torch(v.scales).to(dev),
                mins=None if v.mins is None else _np_to_torch(v.mins).to(dev),
                group=int(v.group), shape=tuple(int(s) for s in v.shape),
                source_type=GGMLType(int(v.source_type)), zero=int(v.zero))
            lane = qt.prepared and not qt.transposed
            return compact_scales(qt) if lane and (
                key in _EXPERT_KEYS or lane_supported(qt)) else qt
        if isinstance(v, dict):
            return {k: conv(x, k) for k, x in v.items()}
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
