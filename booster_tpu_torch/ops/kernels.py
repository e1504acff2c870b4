"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``booster_tpu_torch/csrc/`` is compiled on first use by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface and
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The
library name carries a hash of its source, the shared headers (``*.cuh``)
and the flags, so an edited source builds anew.  Libraries go to ``build/booster_tpu_torch/`` beside the
package.  A build failure raises; nothing falls back.

``launch_counts`` holds one plain integer per kernel (one per Pallas
function it replaces): a wrapper adds one where it launches its kernel and
nowhere else, so a run can show that the main path went through the
kernels.  ``shape_counts`` splits the matmul counts by weight shape.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "booster_tpu_torch"

# library name → source file in csrc/
SOURCES = {
    "qmm_i4t": "qmm_i4t.cu",
    "decode_attn": "decode_attn.cu",
    "kv_append": "kv_append.cu",
    "prefill_attn": "prefill_attn.cu",
    "qmm_i8t": "qmm_i8t.cu",
    "qmm_i8t_gelu": "qmm_i8t_gelu.cu",
    "mlp_i8t": "mlp_i8t.cu",
    "mlp_i8t_gelu": "mlp_i8t_gelu.cu",
    "qmm_lane": "qmm_lane.cu",
    "qmm_lane_i8": "qmm_lane_i8.cu",
    "qmm_i8c": "qmm_i8c.cu",
    "probe_i8": "probe_i8.cu",
    "probe_i4": "probe_i4.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

# kernel name → launches made by its wrapper (reset by callers that count);
# _gd is the M = 1 group-dot form, _dq the M > 1 dequantize form (i4t at
# group 16: _g16m with mins, _g16 without; _gelu a gate-up's GELU epilogue;
# ops.qmm.i4t_count_name, and on the i8t gate-up ops.qmm.i8t_count_name;
# the whole MLP's _g16 and _gelu forms likewise,
# ops.mlp.mlp_count_name), _i8 the int8-cache form, _d256 the attention and
# append forms over a 256-lane cache or pool (head dims 129-256: Gemma), _layer the
# per-layer T = 1 append, paged_ the paged-pool
# forms, moe_ the grouped (routed expert) form of the lane-major matmul; the
# i8c matmul's _mv is its M = 1 streaming matvec, _mm its M > 1 tensor-core form,
# and the int8 lane-major matmul's (no tile table) its matvec at few rows and
# its wgmma tile above (ops.qmm.lane_i8_count_name);
# probe_ the probe tools' kernels (ops/probes.py, ops/probes_i4.py), on no
# serving path, and probe_qmm_i4t_ the serving path's i4t kernel launched by
# a probe tool
launch_counts = {
    "qmm_i4t_gd": 0,
    "qmm_i4t_dq": 0,
    "qmm_i4t_gateup_gd": 0,
    "qmm_i4t_gateup_dq": 0,
    "qmm_i4t_g16m_gd": 0,
    "qmm_i4t_g16m_dq": 0,
    "qmm_i4t_gateup_g16m_gd": 0,
    "qmm_i4t_gateup_g16m_dq": 0,
    "qmm_i4t_g16_gd": 0,
    "qmm_i4t_g16_dq": 0,
    "qmm_i4t_gateup_g16_gd": 0,
    "qmm_i4t_gateup_g16_dq": 0,
    "qmm_i4t_gateup_gelu_gd": 0,
    "qmm_i4t_gateup_gelu_dq": 0,
    "decode_attn": 0,
    "kv_append": 0,
    "decode_attn_i8": 0,
    "kv_append_i8": 0,
    "prefill_attn_i8": 0,
    "decode_attn_d256": 0,
    "decode_attn_i8_d256": 0,
    "prefill_attn_i8_d256": 0,
    "kv_append_d256": 0,
    "kv_append_i8_d256": 0,
    "qmm_i8t_gd": 0,
    "qmm_i8t_dq": 0,
    "qmm_i8t_gateup_gd": 0,
    "qmm_i8t_gateup_dq": 0,
    "qmm_i8t_gateup_gelu_gd": 0,
    "qmm_i8t_gateup_gelu_dq": 0,
    "mlp_i8t": 0,
    "mlp_i8t_gelu": 0,
    "mlp_i8t_g16": 0,
    "mlp_i8t_g16_gelu": 0,
    "paged_attn": 0,
    "paged_attn_i8": 0,
    "kv_append_paged": 0,
    "kv_append_paged_i8": 0,
    "paged_attn_d256": 0,
    "paged_attn_i8_d256": 0,
    "kv_append_paged_d256": 0,
    "kv_append_paged_i8_d256": 0,
    "qmm_i4p": 0,
    "qmm_i8": 0,
    "qmm_i8_mv": 0,
    "qmm_i8_mm": 0,
    "moe_qmm_i4p": 0,
    "moe_qmm_i8": 0,
    "qmm_i8c_mv": 0,
    "qmm_i8c_mm": 0,
    "kv_append_layer": 0,
    "kv_append_layer_i8": 0,
    "probe_colsum": 0,
    "probe_i8mm": 0,
    "probe_s8mm": 0,
    "probe_i8mm_group": 0,
    "probe_blocksum": 0,
    "probe_expand": 0,
    "probe_nibble": 0,
    "probe_i4mm": 0,
    "probe_gd": 0,
    "probe_qmm_i4t_gd": 0,
    "probe_qmm_i4t_dq": 0,
}
# (kernel name, (K, N)) → launches, for the matmul kernels; the probes key
# theirs (kernel name, (form, rows, columns))
shape_counts: dict = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()  # wrappers run on the server's executor threads too


def reset_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0
        shape_counts.clear()


def count(name: str, shape=None) -> None:
    with _count_lock:
        launch_counts[name] += 1
        if shape is not None:
            shape_counts[(name, shape)] = shape_counts.get((name, shape), 0) + 1


def recount(name: str, as_name: str, shape=None) -> None:
    """Move the launch just counted under `name` to `as_name`: a probe tool's
    launch of a serving kernel is counted as the probe's."""
    with _count_lock:
        launch_counts[name] -= 1
        launch_counts[as_name] += 1
        if shape is not None:
            left = shape_counts.pop((name, shape)) - 1
            if left:
                shape_counts[(name, shape)] = left
            shape_counts[(as_name, shape)] = shape_counts.get((as_name, shape), 0) + 1


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared by several sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named sources (all by default) that are not built yet,
    one nvcc process per source, all started together.  Returns, per
    library, its path, the seconds its build took (0 when it was already
    built) and the compiler's report (registers, spills).  Raises if any
    build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    report = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"path": str(out), "seconds": 0.0, "log": ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"path": str(out), "seconds": secs, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library `name` (built if needed), with `signatures`
    ({function: argtypes}) declared; every function returns a CUDA error
    code as int.  Wrappers of one library may declare different functions."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            if f.argtypes is None:
                f.argtypes = argtypes
                f.restype = ctypes.c_int
        return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
