"""Measurement tools of the port, each the counterpart of a JAX tool under
``tools/`` of the repository (the probe tools and their timer):

- ``timing`` — device milliseconds per call from CUDA graphs (the
  counterpart of ``tools/qmm_clean.py``'s ``timeit``), the card's bounds;
- ``qmm_clean`` — the port's ``qlinear`` at the 8B / 1B shapes, Q4_0 and
  Q8_0, lane-major and K-major;
- ``kernel_micro`` — the decode step's kernels at the 1.1B batch shape and
  the raw u8 read;
- ``cast_probe``, ``mmq_probe``, ``qmm_gap``, ``qmm_probe`` — the rungs of
  the i8 stream ladder (``ops.probes``' kernels);
- ``expander_probe`` — the scale expansion alone and the N-major i8 matvec
  under each way of expanding its scales (``ops.probes_i4.expand``,
  ``ops.probes``);
- ``tqmm_probe``, ``nibble_probe``, ``groupdot_probe`` — the i4 rungs: the
  K-major i8 and split-half i4 dequant matmuls at M = 8 and 64, the nibble
  unpacks at the 1.1B gate-up shape, the M = 1 group-dot with f32 scales
  (``ops.probes_i4``), each beside the serving path's own ``qmm_i4t.cu``
  kernel on the same payload.

Run one with ``python -m booster_tpu_torch.tools.<name> [--device cuda|cpu]``:
on the card (the default) every rung is timed at the JAX tool's full
shapes; with ``--device cpu`` each rung runs once through the plain
versions and every time reads "not measured" (pass a tool's size options,
e.g. ``--n 256 --k 512``, for a tiny run).  On the card,
``python3 chip_smoke.py --phases build,probes`` runs every tool's main
after checking each kernel against its plain version.
"""
