"""Quantized linear layer: y = x @ W^T with W a QTensor.

Port of ``booster_tpu/ops/linear.py``: dense (bf16) weights take a plain
matmul with f32 accumulation, as the JAX package leaves them to XLA (on the
card ``torch.matmul`` of bf16 operands, which cuBLAS accumulates in f32; on
the CPU the same products in f32); quantized weights take ``ops.qmm.qmm``,
which runs the i4t kernel (or its plain version on the CPU) and sends shapes
the kernel does not take to the dequantize-matmul path.  The output is cast
to x's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from booster_tpu_torch.ops.qmm import qmm
from booster_tpu_torch.quant.qtensor import QTensor


def qlinear(x: torch.Tensor, w: QTensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., in] @ w[out, in]^T → [..., out] in x.dtype."""
    if w.kind == "dense":
        wd = w.resolved().qw
        if x.device.type == "cuda":
            y = torch.matmul(x.to(torch.bfloat16), wd.to(torch.bfloat16).t())
        else:
            y = x.to(torch.bfloat16).float() @ wd.to(torch.bfloat16).float().t()
    else:
        y = qmm(x, w)
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)
