"""Microbenchmarks of the decode step's kernels on the H100.

Counterpart of ``tools/kernel_micro.py``, at its shapes (the 1.1B bench
model's batch: L 22, B 64, H 32, Hkv 4, S 512, D 128): where the decode
step's time goes.  Rungs, each timed cold and warm (``tools.timing``):

- the loop floor: one tiny elementwise kernel;
- the raw u8 read: column sums of an [11264, 1024] u8 array in i32
  (``ops.probes.colsum``; the JAX tool's Pallas read kernel);
- the dense bf16 gate-up [11264 x 2048] through ``torch.matmul`` (XLA's
  product in the JAX tool: a library yardstick);
- the int8 decode attention of one layer (``decode_attention_stacked`` at
  layer 3, lens S / 2; csrc/decode_attn.cu) and the per-layer int8 append
  (``kv_append_layer``; csrc/kv_append.cu);
- ``qlinear`` for Q4_0 and Q8_0 at the 1.1B shapes (qkv 2048 -> 2560, wo,
  gate-up 2048 -> 11264, down 5632 -> 2048), M = 64, lane-major weights as
  ``repack_gguf_tensor`` gives them (csrc/qmm_lane.cu).

The attention, dense and qmm steps feed their output back as the next
input, as the JAX tool's scan carry does; the append's carry is the caches.
Inputs from ``np.random.default_rng(0)``.

    python -m booster_tpu_torch.tools.kernel_micro [--device cuda|cpu] [--layers L --batch B
        --seq S --rows R --qmm-shapes N:K:label,...]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.ops import probes
from booster_tpu_torch.ops import qmm as tq
from booster_tpu_torch.ops.decode_attention import decode_attention_stacked
from booster_tpu_torch.ops.kv_append import kv_append_layer
from booster_tpu_torch.ops.linear import qlinear
from booster_tpu_torch.tools.qmm_clean import FORMATS, kernel_name, nbytes, plain, weight
from booster_tpu_torch.tools.timing import F32_OPS_PER_S, Ladder, emit

L, B, H, Hkv, S, D = 22, 64, 32, 4, 512, 128
READ_ROWS, READ_COLS = 11264, 1024
QMM_SHAPES = ((2560, 2048, "qkv"), (2048, 2048, "wo"), (11264, 2048, "gateup"),
              (2048, 5632, "down"))
LAYER = 3


def _shapes(v: str) -> list:
    return [(int(n), int(k), lab) for n, k, lab in (s.split(":") for s in v.split(","))]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--layers", type=int, default=L)
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--seq", type=int, default=S)
    ap.add_argument("--rows", type=int, default=READ_ROWS, help="rows of the u8 read")
    ap.add_argument("--qmm-shapes", type=_shapes, default=list(QMM_SHAPES))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    nl, b, s = args.layers, args.batch, args.seq
    rng = np.random.default_rng(0)
    lad = Ladder("kernel_micro", dev)

    floor = torch.zeros(8, 128, device=dev)
    lad.rung("identity (loop floor)", lambda: floor.add_(1.0), None, 0, 2 * floor.numel() * 4, 0)

    big = torch.from_numpy(rng.integers(0, 255, (args.rows, READ_COLS), dtype=np.uint8)).to(dev)
    nbig = big.numel()
    lad.rung(f"raw u8 read {nbig / 1e6:.1f}MB", lambda: probes.colsum(big, "i32"),
             lambda: probes.colsum_plain(big, "i32"), nbig, nbig + 4 * READ_COLS, nbig,
             F32_OPS_PER_S, exact=True, kernel="probe_colsum")

    wd = torch.from_numpy(rng.normal(size=(11264, 2048)).astype(np.float32)).to(
        dev, torch.bfloat16)
    xd = torch.from_numpy(rng.normal(size=(b, 2048)).astype(np.float32)).to(dev, torch.bfloat16)

    def dense_step():
        xd.copy_(torch.matmul(xd, wd.t())[:, :2048])

    lad.rung("dense bf16 gateup [11264x2048] (torch.matmul)", lambda: torch.matmul(xd, wd.t()),
             None, wd.numel() * 2, wd.numel() * 2 + xd.numel() * 2 + b * 11264 * 2,
             2 * b * 2048 * 11264, step=dense_step)
    del wd

    kc = torch.from_numpy(rng.integers(-127, 127, (nl, b, Hkv, s, D), dtype=np.int8)).to(dev)
    vc = torch.from_numpy(rng.integers(-127, 127, (nl, b, Hkv, s, D), dtype=np.int8)).to(dev)
    ks = torch.from_numpy(rng.random((nl, b, Hkv, s, 1)).astype(np.float32)).to(dev)
    vs = torch.from_numpy(rng.random((nl, b, Hkv, s, 1)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.normal(size=(b, 1, H, D)).astype(np.float32)).to(dev, torch.bfloat16)
    lens = torch.full((b,), s // 2, dtype=torch.int32, device=dev)

    def attn():
        return decode_attention_stacked(q, kc, vc, LAYER, lens, scale=0.125, k_scale=ks,
                                        v_scale=vs)

    layer_bytes = 2 * b * Hkv * (s // 2) * (D + 4)  # the valid rows' k, v and scales
    lad.rung("decode_attention (1 layer)", attn, None, layer_bytes,
             layer_bytes + 2 * 2 * q.numel(), 4 * b * H * (s // 2) * D,
             step=lambda: q.copy_(attn()), kernel="decode_attn_i8")

    new_k = torch.from_numpy(rng.normal(size=(b, 1, Hkv, D)).astype(np.float32)).to(
        dev, torch.bfloat16)
    offs = torch.from_numpy(rng.integers(0, s - 1, (b,)).astype(np.int32)).to(dev)

    def append():
        kv_append_layer(kc[LAYER], vc[LAYER], new_k, new_k, offs, ks[LAYER], vs[LAYER])

    row_bytes = 2 * b * Hkv * (D + 4)
    lad.rung("kv_append (1 layer)", append, None, row_bytes, row_bytes + 2 * new_k.numel(), 0,
             kernel="kv_append_layer_i8")
    del kc, vc, ks, vs

    for tag in ("q4_0", "q8_0"):  # the JAX tool's formats (tools/kernel_micro.py:140)
        gt = FORMATS[tag]
        for N, K, label in args.qmm_shapes:
            w = rng.normal(size=(N, K)).astype(np.float32) * 0.05
            qt = weight(w, gt, "lane", dev)
            x = torch.from_numpy(rng.normal(size=(b, K)).astype(np.float32)).to(
                dev, torch.bfloat16)

            def mm_step(qt=qt, x=x, N=N, K=K):
                y = qlinear(x.reshape(b, 1, K), qt).reshape(b, N)
                x.copy_(y[:, :K] if N >= K else F.pad(y, (0, K - N)))

            qbytes = qt.qw.numel() * qt.qw.element_size()
            lad.rung(f"qmm {tag} {label} [{N}x{K}]", lambda qt=qt, x=x: tq.qmm(x, qt),
                     lambda qt=qt, x=x: plain(x, qt), qbytes,
                     nbytes(qt) + 2 * b * K + 2 * b * N, 2 * b * N * K, step=mm_step,
                     kernel=kernel_name(qt, b))
    return lad.result()


if __name__ == "__main__":
    emit(main())
