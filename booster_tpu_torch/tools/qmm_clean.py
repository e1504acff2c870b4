"""Clean per-matmul throughput of the port's qlinear at the 8B / 1B shapes.

Counterpart of ``tools/qmm_clean.py`` on the H100: Q4_K, Q4_0 and Q8_0
weights (``quant.formats.quantize`` of seeded normals,
``repack_gguf_tensor``) in both layouts, "lane" (lane-major i4p / i8:
csrc/qmm_lane.cu; Q4_K with its mins planes) and "kmaj"
(``transpose_qtensor``'s K-major i4t / i8t: csrc/qmm_i4t.cu, qmm_i8t.cu),
through ``ops.qmm.qmm`` at M = ``--bm`` rows, each held against its plain
version and timed cold and warm (``tools.timing``, the counterpart of the
JAX tool's ``timeit``).  ``--dense`` adds the bf16 ``torch.matmul``
yardstick at the same shapes.

    python -m booster_tpu_torch.tools.qmm_clean [--device cuda|cpu] [--bm 1] [--shapes 8b|1b]
        [--fmts q4_K,q4_0,q8_0] [--label qkv] [--dense]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.gguf import GGMLType
from booster_tpu_torch.ops import qmm as tq
from booster_tpu_torch.quant.formats import quantize
from booster_tpu_torch.quant.qtensor import (QTensor, compact_scales, prepare_kernel_scales,
                                             repack_gguf_tensor, to_torch, transpose_qtensor)
from booster_tpu_torch.tools.timing import BF16_OPS_PER_S, Ladder, emit

SHAPES = {"8b": ((6144, 4096, "qkv"), (4096, 4096, "wo"), (28672, 4096, "gateup"),
                 (4096, 14336, "down")),
          "1b": ((2560, 2048, "qkv"), (11264, 2048, "gateup"), (2048, 5632, "down"))}
FORMATS = {"q4_K": GGMLType.Q4_K, "q4_0": GGMLType.Q4_0, "q8_0": GGMLType.Q8_0}


def weight(w: np.ndarray, gt: GGMLType, layout: str, device) -> QTensor:
    """A seeded [N, K] f32 matrix quantized to `gt`, repacked, its kernel
    scale planes prepared (bf16), lane-major or K-major, on `device`."""
    qt = prepare_kernel_scales(repack_gguf_tensor(quantize(w, gt), gt, w.shape))
    if layout == "kmaj":
        qt = transpose_qtensor(qt)
    return to_torch(compact_scales(qt), device)


def kernel_name(w: QTensor, M: int) -> str:
    """The launch counter ops.qmm.qmm adds one to for this weight at M rows."""
    if w.kind in ("i4p", "i8"):
        return "qmm_i4p" if w.kind == "i4p" else tq.lane_i8_count_name(
            tq.lane_i8_plan(M, w.shape[1], w.shape[0]))
    return f"qmm_{w.kind}_{'gd' if M == 1 else 'dq'}"


def plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    return tq.qmm_lane_plain(x, w) if w.kind in ("i4p", "i8") else tq.qmm_plain(x, w)


def nbytes(w: QTensor) -> int:
    return sum(t.numel() * t.element_size() for t in (w.qw, w.scales) if t is not None)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--bm", type=int, default=1)
    ap.add_argument("--shapes", default="8b", help="8b, 1b, or N:K:label,...")
    ap.add_argument("--fmts", default="q4_K,q4_0,q8_0",
                    help="comma list of formats to measure")
    ap.add_argument("--label", default="", help="only measure shapes whose label contains this")
    ap.add_argument("--dense", action="store_true", help="include the bf16 reference")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    fmts = args.fmts.split(",")
    if set(fmts) - set(FORMATS):
        ap.error(f"formats are {sorted(FORMATS)}")
    shapes = SHAPES.get(args.shapes) or tuple(
        (int(n), int(k), lab) for n, k, lab in (s.split(":") for s in args.shapes.split(",")))
    shapes = [s for s in shapes if args.label in s[2]]
    BM = args.bm
    rng = np.random.default_rng(0)
    lad = Ladder("qmm_clean", dev)
    floor = torch.zeros(8, 128, device=dev)
    lad.rung("identity (floor)", lambda: floor.add_(1.0), None, 0, 2 * floor.numel() * 4, 0)
    for tag in fmts:
        for N, K, label in shapes:
            w = rng.normal(size=(N, K)).astype(np.float32) * 0.05
            x = torch.from_numpy(rng.normal(size=(BM, K)).astype(np.float32)).to(
                dev, torch.bfloat16)
            for lay in ("lane", "kmaj"):
                qt = weight(w, FORMATS[tag], lay, dev)
                qbytes = qt.qw.numel() * qt.qw.element_size()
                lad.rung(f"{tag} {label} {lay} [{N}x{K}]", lambda qt=qt, x=x: tq.qmm(x, qt),
                         lambda qt=qt, x=x: plain(x, qt), qbytes,
                         nbytes(qt) + 2 * BM * K + 4 * BM * N, 2 * BM * N * K,
                         kernel=kernel_name(qt, BM))
                del qt
    for N, K, label in (shapes if args.dense else ()):
        wd = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32)).to(dev, torch.bfloat16)
        x = torch.from_numpy(rng.normal(size=(BM, K)).astype(np.float32)).to(dev, torch.bfloat16)
        lad.rung(f"dense bf16 {label} [{N}x{K}]", lambda wd=wd, x=x: torch.matmul(x, wd.t()),
                 None, N * K * 2, N * K * 2 + 2 * BM * K + 2 * BM * N, 2 * BM * N * K,
                 BF16_OPS_PER_S)
    return lad.result()


if __name__ == "__main__":
    emit(main())
