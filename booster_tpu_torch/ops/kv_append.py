"""Deferred decode append: all layers' new KV rows in one launch.

Counterpart of ``kv_append_all_layers`` in ``booster_tpu/ops/pallas_kv.py``:
after the layer loop of a T = 1 step, the new rows [L, B, H, d] land at row
``offsets[b]`` (clamped to S - 1) of every layer of the stacked cache
[L, B, H, S, D], zero-padded to the storage width D.  For an int8 cache
(scales given) each padded row is quantized first (``kv_cache._quantize_kv``:
scale = amax/127 in f32, payload round-half-even(x / max(scale, 1e-12))) and
its scale lands beside it.  ``kv_append`` runs a kernel of
``csrc/kv_append.cu`` on CUDA tensors and ``kv_append_plain`` on CPU
tensors; the two are bit-exact.  Both update the cache in place (the JAX
version returns new arrays) and write only row ``offsets[b]``.

``kv_append_layer`` is one layer's T = 1 append (counterpart of
``kv_append_decode_stacked`` at one layer and of its L = 1 view
``kv_append_decode``): the same row function on a layer view of the
stacked cache, [B, H, S, D], made inside the layer loop where decode takes
the masked attention (``kv_cache.update_layer`` dispatches to it).  Its
kernels are in ``csrc/kv_append.cu``, its plain version
``kv_append_layer_plain``.

The kernels run one warp a row, 8 rows a block (the header of
``csrc/kv_append.cu`` gives the design).

``kv_append_all_layers_paged`` is the same append into a paged pool
[L, Np, H, P, D] through the slots' page tables (counterpart of the JAX
function of that name): the paged kernels of ``csrc/kv_append.cu`` on CUDA
tensors, ``ops.paged_kv.paged_append_all_layers`` (the JAX scatter) on CPU
tensors.  The two agree bit for bit on every page but the scratch page 0,
where a row past the table lands at row 0 (kernel) or at row offset % P
(scatter).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from booster_tpu_torch.ops import kernels
from booster_tpu_torch.ops.kv_cache import _quantize_kv
from booster_tpu_torch.ops.paged_kv import paged_append_all_layers

_SIGNATURES = {
    "bt_kv_append": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "bt_kv_append_i8": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "bt_kv_append_layer": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "bt_kv_append_layer_i8": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "bt_kv_append_paged": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "bt_kv_append_paged_i8": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}


def kv_append_plain(k_all, v_all, new_k, new_v, offsets, k_scale_all=None,
                    v_scale_all=None) -> None:
    """k_all/v_all [L, B, H, S, D] (in place), new_k/new_v [L, B, H, d],
    offsets [B], scales [L, B, H, S, 1] f32 for an int8 cache."""
    L, B, H, S, D = k_all.shape
    off = offsets.to(torch.int64).clamp(0, S - 1)
    b = torch.arange(B, device=k_all.device)
    for cache, scales, new in ((k_all, k_scale_all, new_k), (v_all, v_scale_all, new_v)):
        row = F.pad(new, (0, D - new.shape[-1]))  # [L, B, H, D]
        if scales is not None:
            row, s = _quantize_kv(row)
            scales[:, b, :, off, :] = s.permute(1, 0, 2, 3)
        cache[:, b, :, off, :] = row.to(cache.dtype).permute(1, 0, 2, 3)


def kv_append(k_all, v_all, new_k, new_v, offsets, k_scale_all=None,
              v_scale_all=None) -> None:
    """Kernel-level entry: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if k_all.device.type == "cpu":
        return kv_append_plain(k_all, v_all, new_k, new_v, offsets, k_scale_all, v_scale_all)
    return _launch_all(k_all, v_all, new_k, new_v, offsets, k_scale_all, v_scale_all)


def _launch_all(k_all, v_all, new_k, new_v, offsets, k_scale_all, v_scale_all) -> None:
    L, B, H, S, D = k_all.shape
    d = new_k.shape[-1]
    quant = k_scale_all is not None
    dt = torch.int8 if quant else torch.bfloat16
    if k_all.dtype != dt or v_all.dtype != dt or v_all.shape != k_all.shape:
        raise ValueError("kv_append kernel: the cache must be bf16 k/v of one shape, "
                         "or int8 k/v with scales")
    if not (k_all.is_contiguous() and v_all.is_contiguous()):
        raise ValueError("kv_append kernel: the cache must be contiguous")
    if new_k.shape != (L, B, H, d) or new_v.shape != new_k.shape or d > D:
        raise ValueError("kv_append kernel: new rows must be [L, B, H, d <= D]")
    new_k = new_k.to(torch.bfloat16).contiguous()
    new_v = new_v.to(torch.bfloat16).contiguous()
    offsets = offsets.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(k_all.device).cuda_stream
    lib = kernels.library("kv_append", _SIGNATURES)
    suffix = "_d256" if D == 256 else ""  # the 256-lane forms count under their own names
    if quant:
        if (v_scale_all is None or k_scale_all.shape != (L, B, H, S, 1)
                or v_scale_all.shape != k_scale_all.shape
                or k_scale_all.dtype != torch.float32 or v_scale_all.dtype != torch.float32
                or not (k_scale_all.is_contiguous() and v_scale_all.is_contiguous())):
            raise ValueError("kv_append kernel: scales must be contiguous f32 [L, B, H, S, 1]")
        if D not in (128, 256):
            raise NotImplementedError(f"kv_append int8 kernel: storage head dim {D}: "
                                      "not ported yet (the 128- and 256-lane widths are)")
        rc = lib.bt_kv_append_i8(k_all.data_ptr(), v_all.data_ptr(), k_scale_all.data_ptr(),
                                 v_scale_all.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
                                 offsets.data_ptr(), L, B, H, S, D, d, stream)
        kernels.check(rc, "kv_append_i8" + suffix)
        kernels.count("kv_append_i8" + suffix)
        return
    rc = lib.bt_kv_append(k_all.data_ptr(), v_all.data_ptr(), new_k.data_ptr(),
                          new_v.data_ptr(), offsets.data_ptr(), L, B, H, S, D, d, stream)
    kernels.check(rc, "kv_append" + suffix)
    kernels.count("kv_append" + suffix)


def kv_append_layer_plain(k_layer, v_layer, new_k, new_v, offsets, k_scale=None,
                          v_scale=None) -> None:
    """k_layer/v_layer [B, H, S, D] (in place), new_k/new_v [B, 1, H, d],
    offsets [B], scales [B, H, S, 1] f32 for an int8 cache."""
    B, H = k_layer.shape[:2]
    kv_append_plain(k_layer[None], v_layer[None], new_k.reshape(1, B, H, -1),
                    new_v.reshape(1, B, H, -1), offsets,
                    None if k_scale is None else k_scale[None],
                    None if v_scale is None else v_scale[None])


def kv_append_layer(k_layer, v_layer, new_k, new_v, offsets, k_scale=None,
                    v_scale=None) -> None:
    """Kernel-level entry for one layer's T = 1 append: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if k_layer.device.type == "cpu":
        return kv_append_layer_plain(k_layer, v_layer, new_k, new_v, offsets, k_scale, v_scale)
    return _launch_layer(k_layer, v_layer, new_k, new_v, offsets, k_scale, v_scale)


def _launch_layer(k_layer, v_layer, new_k, new_v, offsets, k_scale, v_scale) -> None:
    B, H, S, D = k_layer.shape
    d = new_k.shape[-1]
    quant = k_scale is not None
    dt = torch.int8 if quant else torch.bfloat16
    if k_layer.dtype != dt or v_layer.dtype != dt or v_layer.shape != k_layer.shape:
        raise ValueError("kv_append_layer kernel: the cache must be bf16 k/v of one shape, "
                         "or int8 k/v with scales")
    if not (k_layer.is_contiguous() and v_layer.is_contiguous()):
        raise ValueError("kv_append_layer kernel: the layer views must be contiguous")
    if new_k.shape != (B, 1, H, d) or new_v.shape != new_k.shape or d > D:
        raise ValueError("kv_append_layer kernel: new rows must be [B, 1, H, d <= D]")
    new_k = new_k.to(torch.bfloat16).contiguous()
    new_v = new_v.to(torch.bfloat16).contiguous()
    offsets = offsets.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(k_layer.device).cuda_stream
    lib = kernels.library("kv_append", _SIGNATURES)
    if quant:
        if (v_scale is None or k_scale.shape != (B, H, S, 1) or v_scale.shape != k_scale.shape
                or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                or not (k_scale.is_contiguous() and v_scale.is_contiguous())):
            raise ValueError("kv_append_layer kernel: scales must be contiguous f32 [B, H, S, 1]")
        if D % 128 or D > 1024:
            raise NotImplementedError(f"kv_append_layer int8 kernel: storage head dim {D}: "
                                      "not ported yet (multiples of 128 up to 1024 are)")
        rc = lib.bt_kv_append_layer_i8(k_layer.data_ptr(), v_layer.data_ptr(),
                                       k_scale.data_ptr(), v_scale.data_ptr(), new_k.data_ptr(),
                                       new_v.data_ptr(), offsets.data_ptr(), B, H, S, D, d,
                                       stream)
        kernels.check(rc, "kv_append_layer_i8")
        kernels.count("kv_append_layer_i8")
        return
    rc = lib.bt_kv_append_layer(k_layer.data_ptr(), v_layer.data_ptr(), new_k.data_ptr(),
                                new_v.data_ptr(), offsets.data_ptr(), B, H, S, D, d, stream)
    kernels.check(rc, "kv_append_layer")
    kernels.count("kv_append_layer")


def kv_append_all_layers_paged(pool_k, pool_v, new_k, new_v, offsets, table, pool_ks=None,
                               pool_vs=None) -> None:
    """Kernel-level entry: pool_k/pool_v [L, Np, H, P, D] (in place), new rows
    [L, B, H, d], offsets [B], table [B, MAXP], scales [L, Np, H, P, 1] f32
    for an int8 pool.  The plain version for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    if pool_k.device.type == "cpu":
        return paged_append_all_layers(pool_k, pool_v, new_k, new_v, offsets, table,
                                       pool_ks, pool_vs)
    return _launch_paged(pool_k, pool_v, new_k, new_v, offsets, table, pool_ks, pool_vs)


def _launch_paged(pool_k, pool_v, new_k, new_v, offsets, table, pool_ks, pool_vs) -> None:
    L, Np, H, P, D = pool_k.shape
    B, maxp = table.shape
    d = new_k.shape[-1]
    quant = pool_ks is not None
    dt = torch.int8 if quant else torch.bfloat16
    if pool_k.dtype != dt or pool_v.dtype != dt or pool_v.shape != pool_k.shape:
        raise ValueError("kv_append_all_layers_paged kernel: the pool must be bf16 k/v of "
                         "one shape, or int8 k/v with scales")
    if not (pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("kv_append_all_layers_paged kernel: the pool must be contiguous")
    if new_k.shape != (L, B, H, d) or new_v.shape != new_k.shape or d > D:
        raise ValueError("kv_append_all_layers_paged kernel: new rows must be [L, B, H, d <= D]")
    if D not in (128, 256):
        raise NotImplementedError(f"kv_append_all_layers_paged kernel: storage head dim {D}: "
                                  "not ported yet (the 128- and 256-lane pools are)")
    new_k = new_k.to(torch.bfloat16).contiguous()
    new_v = new_v.to(torch.bfloat16).contiguous()
    offsets = offsets.to(torch.int32).contiguous()
    table = table.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(pool_k.device).cuda_stream
    lib = kernels.library("kv_append", _SIGNATURES)
    suffix = "_d256" if D == 256 else ""
    if quant:
        if (pool_vs is None or pool_ks.shape != (L, Np, H, P, 1)
                or pool_vs.shape != pool_ks.shape
                or pool_ks.dtype != torch.float32 or pool_vs.dtype != torch.float32
                or not (pool_ks.is_contiguous() and pool_vs.is_contiguous())):
            raise ValueError("kv_append_all_layers_paged kernel: scales must be contiguous "
                             "f32 [L, Np, H, P, 1]")
        rc = lib.bt_kv_append_paged_i8(pool_k.data_ptr(), pool_v.data_ptr(), pool_ks.data_ptr(),
                                       pool_vs.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
                                       offsets.data_ptr(), table.data_ptr(), L, B, H, Np, P,
                                       maxp, D, d, stream)
        kernels.check(rc, "kv_append_paged_i8" + suffix)
        kernels.count("kv_append_paged_i8" + suffix)
        return
    rc = lib.bt_kv_append_paged(pool_k.data_ptr(), pool_v.data_ptr(), new_k.data_ptr(),
                                new_v.data_ptr(), offsets.data_ptr(), table.data_ptr(), L, B, H,
                                Np, P, maxp, D, d, stream)
    kernels.check(rc, "kv_append_paged" + suffix)
    kernels.count("kv_append_paged" + suffix)
