"""Measurement tools of the port, each the counterpart of a JAX tool under
``tools/`` of the repository (the i8 stream probes and their timer):

- ``timing`` — device milliseconds per call from CUDA graphs (the
  counterpart of ``tools/qmm_clean.py``'s ``timeit``), the card's bounds;
- ``qmm_clean`` — the port's ``qlinear`` at the 8B / 1B shapes, Q4_0 and
  Q8_0, lane-major and K-major;
- ``kernel_micro`` — the decode step's kernels at the 1.1B batch shape and
  the raw u8 read;
- ``cast_probe``, ``mmq_probe``, ``qmm_gap``, ``qmm_probe`` — the rungs of
  the i8 stream ladder (``ops.probes``' kernels).

Run one with ``python -m booster_tpu_torch.tools.<name> [--device cuda|cpu]``:
on the card (the default) every rung is timed at the JAX tool's full
shapes; with ``--device cpu`` each rung runs once through the plain
versions and every time reads "not measured".
"""
