#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (booster_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases build,kernels,probes,parity,generate,batch,generate_i8,
                           generate_gemma,batch_gemma,generate_gemma_i8,generate_gemma_q6k,
                           batch_gemma_q6k,server_gemma,generate_gemma7b_i8,
                           batch_gemma7b_i8,generate_q8,batch_q8,server,
                           generate_i8c,batch_i8c,generate_q6k,batch_q6k,generate_q5k,
                           batch_q5k,generate_mpt,batch_mpt,generate_q4k,generate_q2k,
                           batch_q2k,generate_moe,batch_moe]

Phases, each printing one JSON line with its seconds:

1. build — compile every CUDA kernel of the paths from csrc/ (one nvcc per
   source, all at once); print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them.
2. kernels — each kernel against its plain torch version on the same inputs,
   with the tolerance stated at CHECKS, at the paths' shapes.  The i4t
   matmul of csrc/qmm_i4t.cu at TinyLlama's widths (M = 1 streaming matvec
   of csrc/i4mv.cuh, M = 16 tensor-core tile; with synthetic mins planes
   too), its fused gate-up at M = 1, 16, 64 and 64·BATCH_MPT_T (bit-equal to
   the matmul + silu·mul, and each output within the gate-up limit or an
   output of one-ulp roundings of g and u), MPT-7B's qkv, wo, up and down at
   generate_mpt's M = 1 and batch_mpt's M = 64 and 64·BATCH_MPT_T,
   Mixtral's qkv and wo at generate_moe's M = 1 and its lm head at M = 64,
   the M = 1 rows equal to themselves on a second launch, each wrong kernel
   of booster_tpu_torch.testing.qmm_i4t_mutants (nibbles swapped, a scale
   row from the next group, the zero ignored, the mins dropped, one K
   split's partial dropped: at M = 1 the plan's last split, or its last
   group where it has one) 8x past the limit.
   TinyLlama-1.1B (batch 1 for the Q4_0 kernels and bf16-cache attention,
   batch 64 over a 512-row int8 cache for int8 decode attention, the
   quantizing append, and chunked-prefill attention at both prompt buckets,
   T = 16 and the batch phase's T = 32), and the Mistral-7B layout of config
   3 (32 layers, 8 kv heads of 4 query heads, head dim 128 filling every
   cache lane: the same attention kernels and appends, prefill at T = 32;
   the i8t matmul at M = 1 (group-dot; also at TinyLlama's i8 widths,
   generate_i8's qkv, wo and lm head) and M = 64 / 2048 (tensor-core
   dequant), the i8t gate-up at M = 2048 and the whole-MLP kernel at
   M = 1, 16 and 64 on a 32-layer stack through the layer view), and the
   paged kernels at the server phase's layout (the 7B model's 32 layers,
   pages of 256 rows, 64 slots of up to 16 pages whose pages lie scattered,
   slots 0-15 sharing their first two): paged decode attention over a bf16
   and an int8 pool, with and without the self term, with a window and a
   softcap, and the paged all-layer append, bit-exact off the scratch
   page 0 (offsets on a page boundary and past the table included).  Fused
   kernels are held against the unfused kernels bit for bit: the gate-ups
   against qmm + silu·mul, the MLP against the i8t gate-up (its dequant
   form) + silu·mul + the dequant matmul, timed beside it (unfused_ms), its
   workspace zero after the launch.  Each attention check must see the
   wrong kernels of booster_tpu_torch.testing (a dropped self term, a missed
   last column, a column read past the end, ignored v scales, and at head
   dim 128 ignored lanes 64-127; for the paged kernel the table ignored, a
   page off by one, the in-page row ignored and the scales of the wrong
   page) at 8x its limit.  The lane-major matmul of csrc/qmm_lane.cu in its
   grouped form (the routed experts), i4p and i8, at Mixtral-8x7B's expert
   shapes under seeded routings (one decode token, 64, and the 64 x 32
   prefill), and in its plain form at M = 1, 64 and 2048 on the 7B's qkv
   and down shapes (the int8 one on csrc/qmm_lane_i8.cu, its matvec and
   its wgmma tile): within 2e-4 of the largest output of its plain
   version, zero on the padding tiles it skips, and each wrong kernel (the
   tile table ignored, the expert off by one, the nibble halves swapped, a
   group's scale from its neighbour, one K split's partial dropped) past 8x
   that limit.  The per-channel
   int8 matmul of csrc/qmm_i8c.cu (weights="i8c") at the 7B shapes (qkv,
   wo, gate-up 4096 → 28672, down through the layer view of 2-layer
   stacks; the 2-D lm head) at M = 1, 64 and 2048: within 2e-4 of the
   largest output of its plain version, equal to itself on a second launch,
   and each wrong kernel (the rescale dropped, a neighbour column's scale,
   the layer off by one, K rows [0, 256) dropped, the payload read N-major)
   past 8x that limit.  The Q6_K slice's kernels at the DeepSeek-Coder-1.3B
   shape: the i8t matvec and dequant matmul at group 16 (qkv 2048 → 6144,
   wo, the lm head 2048 → 32256, and llama.cpp's Q4_0 lm head 2048 → 32000)
   at M = 1, 64 and 2048; the gate-up at group 16 at M = 64 and 2048; the
   M = 1 fused gate-up (csrc/qmm_i8t.cu gateup_gd_kernel, the port of
   _gateup_i8_gd_kernel) at (K 2048, ff 5504, G 16), at the 7B's (4096,
   14336, G 32) and with a synthetic mins plane, equal to the matvec
   kernel + silu·mul bit for bit; the lane-major i8 matmul of the Q8_0
   down (5504 → 2048) at M = 1, 64 and 2048 (csrc/qmm_lane_i8.cu: the
   matvec at one row, the wgmma tile above); every wrong kernel (a
   neighbour group's scale, the group read as the other one, the mins
   dropped, the up half read for the gate, silu left out) past 8x the
   limit; and the attention kernels at the 1.3B model's MHA layout (24
   layers, 16 kv heads, G = 1, head dim 128; prefill at T = 16 and 32).
   The per-layer T = 1 append (csrc/kv_append.cu bt_kv_append_layer and
   _i8, the port of _append_kernel_plain and _append_kernel_quant) at
   MPT-7B's generate shape (B 1, 32 heads, S 1024, head dim 128, bf16) and
   batch shape (B 64, S 512, int8), each also with rows of d = 64 < D:
   bit-exact with its plain version, and each wrong append (the layer off
   by one, the offset not clamped, the row at offset - 1; for int8 the
   scales not written and scale = amax) seen to leave another cache.  The
   appends' launch floor (csrc/kv_append.cu at one bf16 row) is timed and
   printed beside every append row (launch_floor_ms).  Config 2's rows on
   real Q4_K weights (random blocks repacked by the port: four planes, the
   halves' scales then their mins, the min term as large as the scaled
   term): qmm_i4t.cu's qkv, wo, down and fused gate-up at the Llama-3-8B
   shapes at M = 1 and at M = 128 (bench's prompt's prefill), its lm head at
   M = 1 and its qkv at the 8192-row prefill of the long prompt, each with
   the mins dropped and the mins taken with the wrong sign among its wrong
   kernels; and csrc/qmm_lane.cu's i4p form with mins on Q4_K expert stacks
   of Mixtral-8x7B's width, grouped at 2 and 128 real rows and dense over
   one expert at M = 1, with the same mins mutants beside the table, expert,
   nibble, scale and K-split ones.  llama.cpp's Q5_K_S mix on real planes
   (random Q5_K and Q5_1 blocks repacked by the port; two planes, the
   scales then the mins): the int8 K-major forms with mins at the
   DeepSeek-Coder-1.3B shape (qkv, wo and the fused gate-up: the M = 1
   matvec, the wgmma tile of csrc/i8k_tile.cuh at M = 16, 64 and 2048),
   the lane-major Q5_1 down (5504 → 2048) at M = 1, 16, 64 and 2048, the
   whole MLP with mins on both weights at the Llama-3-8B width at M = 1,
   16 and 64, and the grouped i8 form with mins on Q5_K expert stacks of
   Mixtral's width at 2 and 128 real rows; each held against its plain
   version with the mins dropped and taken with the wrong sign among its
   wrong kernels, the gate-up and the MLP equal to their unfused kernels
   bit for bit, and each timed beside the same kernel with the weight's
   mins plane dropped (no_mins_ms).  llama.cpp's Q2_K mix on real planes
   (random Q2_K and Q3_K blocks repacked by the port): qmm_i4t.cu at group
   16 (i4mv.cuh's matvec and gate-up at M = 1, the tile above) at the
   Llama-3-8B shapes, Q2_K's four planes (mins) on q 4096 → 4096, k 4096
   → 1024 and the fused gate-up 4096 → 2·14336, Q3_K's two (zero 4, scales
   of either sign) on wo 4096 → 4096 and down 14336 → 4096, at M = 1, 16,
   64 and 2048 (batch_q2k's prefill: the tile at 128 rows a block) and at
   128 (on no path, beside the Q4_K rows), and the gate-up's zero-4 form
   on random Q3_K weights (on no path) at M = 1, 64 and 2048; the same
   checks and wrong kernels as the Q4_K
   rows, counted under each group-16 form's own name
   (ops.qmm.i4t_count_name).  Gemma-2B's forms (_gemma_kernels): the i4t
   gate-up with the GELU epilogue on a Q4_0 [2048, 2·16384] weight at
   M = 1, 16, 64 and 64·BATCH_GEMMA_T (bit-equal to the matmul + gelu·mul;
   the SiLU epilogue among its wrong kernels), and the attention and append
   kernels at the 256-lane cache (GEMMA_ATTN: bf16 decode at B = 1, lens
   150 and 500; int8 decode at B = 64; the 32-row prefill at G = 8; the
   all-layer appends at L 18; lanes 128-255 dropped among the attention's
   wrong kernels), counted under their _d256 names; the 256-lane decode
   where a slice spans several stages (_multi_stage_checks: Gemma-2B's 64
   slots, Gemma-7B's 16 kv heads; against the plain version and the CPU
   mirror, untimed); and the tied head at
   V = 256000 (a torch product, timed beside its bound; no kernel).
   Gemma-2B's int8 forms (_gemma_mlp_kernels): mlp_i8t_gelu.cu (the whole
   MLP's GELU epilogue) at K 2048, ff 16384, C 2048 at group 32 (Q4_0 widened by
   weights="i8"), at group 32 with mins planes (on no path) and at group 16
   (Q6_K), M = 1, 16, 64 and 2048, each equal to its unfused sequence bit
   for bit, its mid too, the SiLU epilogue (on mid) and the tile's wrong
   gate-up kernels 8x past their limits (the SiLU form at group 16 too, at
   M = 1 and 64, on no path); and the paged decode attention
   and append at Gemma-2B's 256-lane pool (18 layers, one kv head of 8
   query heads, the 7B's page pattern; int8 and bf16, with and without the
   self term; lanes 128-255 dropped among the wrong kernels), counted
   under their _d256 names.  Gemma-7B's forms (_gemma7b_kernels, GEMMA_7B:
   K 3072, ff 24576): qmm_i8t_gelu.cu's gate-up with the GELU epilogue in the
   tile (dq_kernel with act 1) at M = 256 and 2048 at group 32 (the two
   paths' prefills), and at M = 2048 with mins planes and at group 16 (on
   no path), and in the M = 1 matvec pair (i8mv::kGateUpGelu) at group 32,
   32 with mins and 16 (reached by parity (r) only), each equal to
   qmm_i8t + gelu·mul bit for bit, within the gate-up's limit of its plain
   version per element, and the SiLU epilogue and a dropped group of K
   (with the tile's and the matvec's wrong kernels) 8x past that limit
   per element; the whole MLP with GELU at M = 1 and 64
   (_gemma_mlp_kernels at GEMMA7B_MLP); the 256-lane attention and append
   kernels at 16 kv heads of 256, G = 1 (GEMMA7B_ATTN: bf16 at B = 1,
   generate's lengths; int8 at B = 64; the 32-row prefill; the appends at
   L 4); the tied head at 256000 x 3072.
   Median times of kernel,
   plain version and one library call (the yardstick), each call after an
   L2 scrub (cold, as on the decode path), and the kernel's time warm
   (booster_tpu_torch.tools.timing: the one timer of this script and the
   probe tools).
2b. probes — the i8 stream probes: each of the 21 Pallas functions of the
   JAX package's tools/kernel_micro.py, cast_probe.py, mmq_probe.py,
   qmm_gap.py and qmm_probe.py through its kernel in csrc/probe_i8.cu
   (column sums; the int8-weight dot, K-major or N-major, bf16 or int8 x,
   with no scale, a scale plane, group scales or v5's reordered ones; its
   per-group rescale form; the int8 x int8 N-major dot on wgmma, also at
   M = 8 and 100, where a lost stage of K must be seen) against its plain
   version at the tools' full shapes: exact for the column sums and the
   integer dots, within
   CHECKS["qmm"] for the others, and each wrong kernel (a neighbour
   column's sum, the weight read in the other layout, a neighbour group's
   scale, v5 read as v3, v7's groups taken as 32, the rescale dropped) 8x
   past that limit; timed cold and warm with the plain version and, where
   one torch call computes the same function, the library call
   (torch.sum, torch._int_mm).  Then each port tool's main on the card
   (booster_tpu_torch.tools: kernel_micro, cast_probe, mmq_probe, qmm_gap
   with v0-v7, qmm_probe, and qmm_clean at the 1B shapes), one JSON line
   each; a tool must launch its own kernels and no other, as many times
   as its rungs say.  The same for the scale-expansion and i4 probes'
   Pallas functions (tools/expander_probe.py, tqmm_probe.py,
   nibble_probe.py, groupdot_probe.py) at their tools' full shapes:
   csrc/probe_i4.cu's expansion (repeat, tile, repeat of bf16; exact),
   dequantized nibble tiles (exact), split-half i4 tensor-core matmul (the
   current, i8mask and affine roundings, and the current one under three
   more unpack sequences) and M = 1 group-dot with f32 scales (i4, i4 with
   mins, i8), and probe_i8.cu's new forms (periodic and f32 scales in
   both layouts, the group form through transposed scales, castonly's
   block sum, exact), each wrong kernel (a neighbour group's scale, repeat
   read as tile, the high nibble taken as the low, the zero or the mins
   dropped, the last K split left out, tiles of 512 rows) 8x past the
   limit; qmm_i4t.cu's own kernel on the i4 payloads (bf16 planes),
   counted under keys of its own; then expander_probe, tqmm_probe,
   nibble_probe and groupdot_probe's main on the card.
3. parity — 2-layer models on the CPU (plain versions) and on the card
   (kernels), both fed the CPU's greedy tokens: (a) TinyLlama width, batch
   1, Q4_0, bf16 cache: prefill, then 16 decode steps; (b) TinyLlama width,
   the batched path: bf16 weights, int8 cache, 4 slots of which 2 are live,
   prefill, then 16 decode steps; (c) the 7B width, Q8_0 (native i8t): the
   batched path over an int8 cache (4 slots, 2 live, T = 32 prompts) and
   the single-stream path over a bf16 cache, 2 decode steps each; (d) the
   same model over the server's paged pool (``Engine(paged=True,
   page_size=256)``, its allocator giving the pages), an int8 pool and a
   bf16 one, 4 slots of which 2 live, 2 decode steps; (e) the Mixtral-8x7B
   width (8 experts of ff 14336, 2 used) with Q4_0 and then Q8_0 weights,
   the single-stream path over a bf16 cache, 2 decode steps (a step where
   the two devices routed the compared token to other experts at a
   near-tie of its bf16 router logits is left out; at most one); (f) the
   7B-width file with weights="i8c" and the TinyLlama-width file with
   weights="i8" and "i8c", loaded on both devices: every requantized
   tensor bit-equal between the CPU's load and the card's (channel_quantize
   on each), the reciprocal multiply amax · f32(1/127) seen to differ on
   rows of the Q4_0 file (and counted, with torch's CUDA division by a
   scalar, per file), then the single-stream path over a bf16 cache, 3
   decode steps (i8c 7B, i8 TinyLlama); (g) the DeepSeek-Coder-1.3B width
   as llama.cpp's Q6_K file (Q8_0 ffn_down), loaded with the reference's
   kinds on both devices: the single-stream path over a bf16 cache and
   the batched path over an int8 cache (4 slots, 2 live, T = 32), 6
   decode steps each; (h) MPT-7B's width (Q4_0 with a Q6_K head, ALiBi,
   LayerNorm, GELU) at 2 layers: the single-stream path over a bf16 cache
   of 256 rows and the batched path over an int8 cache (4 slots, 2 live),
   whose steps launch the per-layer append once a layer (counted) and no
   stacked decode kernel, and a bf16 cache of 200 rows (the plain row
   writes), 2 decode steps each; (i) the Llama-3-8B width (config 2) in
   Q4_K, every weight i4t with four planes, the single-stream path over a
   bf16 cache, 2 decode steps; (j) the Mixtral-8x7B width in Q4_K (the
   expert stacks lane-major i4p with mins), as (e) runs it, its card
   launches counted as the path "parity (j)"; (k) the Llama-3-8B width in
   llama.cpp's Q5_K_S mix (Q5_K with mins planes, a Q6_K head), the
   single-stream path over a bf16 cache, 2 decode steps: the whole-MLP
   kernel with mins on both weights at its 16-row prefill and at each step
   (its rows counted; the card's launches are the path "parity (k)"); (l)
   the DeepSeek-Coder-1.3B width in the same mix (the ffn_down Q5_1,
   lane-major), the single-stream path and the batched path over an int8
   cache (4 slots, 2 live, T = 32), 6 decode steps each; (m) the
   Llama-3-8B width in llama.cpp's Q2_K mix (q, k and the gate-up i4t at
   group 16 with mins, wo and down at group 16 with zero 4, v Q4_K, the
   head Q6_K; q, k and v three matmuls), loaded with those kinds on both
   devices, the single-stream path over a bf16 cache, 2 decode steps, whose
   card launches (the path "parity (m)") must hold every group-16 form of
   the path at M = 1 and in the tile; (n) Gemma-2B's width (the GELU
   gate-up, the 256-lane cache, the tied head) loaded on the card and its
   params moved to the CPU, the first 4096 rows of its token table held
   against the file's numpy dequantization, the single-stream path over a
   bf16 cache and the batched path over an int8 cache (4 slots, 2 live, T
   = 32), 2 decode steps each, its card launches (the path "parity (n)")
   holding every new form and no SiLU gate-up; (o) the same Gemma file
   with weights="i8" (the whole MLP with GELU at group 32 at every M; its
   cases as (n)'s, and a paged int8 pool of 4 slots, 2 live: the paged
   attention and append at 256 lanes) and (p) llama.cpp's Q6_K mix of
   Gemma-2B (the MLP at group 16), their card launches (the paths
   "parity (o)" and "parity (p)") holding those forms and no 4-bit kernel
   or int8 gate-up; (q) Gemma-7B's width (GEMMA_7B: q width 4096 beside a
   hidden 3072, 16 kv heads of 256, ff 24576) with weights="i8", loaded on
   the card and moved to the CPU as (n), the single-stream path over a
   bf16 cache with a prompt in the 256-row bucket (the whole MLP declines
   from 142 rows: the int8 gate-up with GELU, qmm_i8t_gelu.cu's dq_kernel with
   act 1) and 2 decode steps (the whole MLP with GELU), its card launches
   the path "parity (q)"; (r) two narrow Gemma-shaped files (GEMMA_MIX:
   hidden 512, 4 heads of 256 over 4 kv heads) whose ffn_down is Q6_K
   (group 16) beside Q8_0 or Q5_K gate/up (group 32, the latter with
   mins) in every layer, so the whole MLP declines at every M: the
   single-stream path over a bf16 cache (a 16-row prefill, then 3 steps
   through the M = 1 gate-up with GELU, i8mv::kGateUpGelu), the card's
   Engine.generate on the same prompt (its tokens the CPU's greedy ones),
   and the 4-stream batch over an int8 cache (the prefill at 64 rows),
   each file's card launches a path ("parity (r) q8_0", "parity (r)
   q5_k").  (c), (d) and (f)'s 7B width run last: they read the first 2
   layers of the 32-layer Q8_0 file, which the writer draws last.  (a),
   (b), (c), (d), (e)'s Q4_0 Mixtral, (f), (g), (h), (i), (l), (m), (n),
   (o), (p) and (q) read the first 2 layers of their full-depth file
   (PARITY_SHARED) in place of a 2-layer file.  The
   live slots' logits agree within the stated tolerance at every step, and
   the greedy tokens wherever the CPU's top-2 margin exceeds it.
4. generate — the full 22-layer TinyLlama-shaped Q4_0 GGUF (random weights
   from a seed, built by booster_tpu_torch.testing.make_model and cached
   under build/; every full-depth GGUF is written by one background
   process, started at once, in the order the phases need them),
   ``load_model(device="cuda")`` and
   ``Engine(max_batch=1, max_seq=1024, decode_chunk=128).generate`` of 128
   greedy tokens, with the kernels' launch counts reset just before and read
   just after; every kernel of the path must have launched, at the expected
   counts, and no other.  A 32-token generate (decode_chunk 32) runs under
   torch.profiler: kernel time and launches per token, and the device busy
   share against the same generate's wall time unprofiled.
5. batch — the same GGUF through ``load_model(weights="auto",
   batch_hint=64)``, which must resolve to bf16 weights, and
   ``Engine(max_batch=64, max_seq=512, kv_quantized=True, decode_chunk=32)``
   driven as bench.py's bench_batch drives the reference: 64 slots with
   ``SamplingParams(temp=0.8, top_k=40, seed=s)`` and prompts
   ``f"stream {s} benchmark prompt"``, ``prefill_slots``, one warm chunk,
   then pipelined chunks to 128 tokens.  One warm-up run to 32 tokens first; the counts
   are reset just before the measured run and read just after, and must be
   exact: 22 int8 decode attentions per step, one quantizing append per
   step, 22 prefill attentions per prefill chunk, no 4-bit matmul.  It
   prints aggregate and per-stream tok/s, prefill ms, and (a run to 32
   tokens, the prefill and 64 steps, under torch.profiler) the device busy
   share and the top kernels.
6. generate_q8 — bench.py's config 3 model: the full 32-layer Mistral-7B
   shape (hidden 4096, 32 heads over 8 kv heads, ff 14336, vocab 32000)
   with Q8_0 weights, built as bench.py builds it (7.7 GB, cached under
   build/; its build and load seconds are printed), loaded once with
   ``load_model(weights="auto")``, which must keep native i8t weights; the
   single-stream generate of phase 4 on it (bf16 cache).  Exact launch
   counts, derived from the reference's gates (pallas_qmm.py: qmm sends i8t
   to the group-dot kernel at M = 1 and the dequant kernel otherwise,
   :602; llama.py:552-580 tries qmm_mlp first, whose tile rule
   _pick_bf_mlp :1281 takes the 7B MLP at M <= 64, M = 1 included, but
   not at M = 2048, where qmm_gateup takes it): per decode step 2·32 + 1
   group-dot matmuls (qkv and
   wo of each layer, the lm head), 32 MLP kernels, 32 bf16 decode
   attentions and one append; at the 16-row prefill 64 dequant matmuls,
   32 MLP kernels and one group-dot lm head (the last row).
7. batch_q8 — the same loaded model through phase 5's bench_batch (config
   3: 64 streams, int8 KV).  Exact counts: per decode step (M = 64) 65
   dequant matmuls (qkv, wo, the lm head), 32 MLP kernels, 32 int8 decode
   attentions, one quantizing append; at the prefill chunk (64 slots x
   T = 32 = 2048 rows) 97 dequant matmuls (qkv, wo and down of each layer,
   the lm head over the 64 gathered rows), 32 i8t gate-ups and 32 prefill
   attentions; no 4-bit kernel.  It prints the same figures as phase 5 and
   the peak device memory.
8. server — ``python -m booster_tpu_torch --server --paged-kv --kv-quant
   --slots 64 --context 4K`` on the same model, through the port's own
   ``serve`` on a thread (phase_server): warmup, one chat completion whose
   system message fills two 256-row pages, then 64 requests at once (48
   chat completions with that system message, 8 streamed as SSE, 4 Ollama
   chats as NDJSON, 4 /jobs polled by GET, one cancelled while it runs),
   every response checked.  Exact counts for those 64, derived from the
   reference's gates: a paged pool with P % 128 == 0 takes the stacked
   paged decode (llama.py:63-68) with the deferred append always on
   (:705-707), whose attention is the merged paged kernel
   (pallas_paged_attention.py:673) once per layer and whose append is
   kv_append_all_layers_paged once per step (:799-814); a paged prefill
   writes through the table and attends over gathered views, with no
   kernel (:439-459, fused prefill off for pools :666-670).  So 32 int8
   paged attentions and one int8 paged append per decode step (chunks
   dispatched x 8 steps), and no dense decode attention, dense append or
   prefill attention.  It prints aggregate and per-stream tok/s, TTFT and
   latency percentiles, /health, the pages in use at the peak, the peak
   device memory, whether a decode dispatch made the host wait (torch's
   sync check, which must find none), and (one more round of the 64 under
   torch.profiler) the device busy share and the top kernels.

   generate_i8 (between batch and generate_q8) — phase 4 on the same GGUF
   loaded with ``weights="i8"`` (the nibbles widened to int8: K-major i8t
   at group 32, the Q8_0 kernels at TinyLlama's widths).  Exact counts, as
   generate_q8's rule gives them at 22 layers: per decode step 2·22 + 1
   i8t group-dot matmuls and 22 whole-MLP kernels; at the prefill 44
   dequant matmuls, 22 MLP kernels and the lm head; no 4-bit kernel and no
   dequantize-path matmul (ops.qmm's fallback, counted).
   generate_i8c and batch_i8c (after server) — phases 6 and 7 on the 7B
   GGUF loaded with ``weights="i8c"`` (every dense weight and the lm head
   requantized per output channel on the card; the load's seconds and peak
   card memory printed).  The reference takes the i8c kernel for every
   weight of this shape and declines the fused gate-up and the whole MLP
   for kind i8c (pallas_qmm.py:1606, :1039, :1320), so the MLP runs
   gate-up, silu·mul, down: 4·32 + 1 = 129 i8c matmuls per decode token or
   step (the M = 1 matvec in generate, the tensor-core form at M = 64),
   4·32 at generate's prefill plus its M = 1 lm head, 129 at the batch
   prefill; no i8t, MLP or dequantize-path matmul; batch_i8c's decode
   dispatches under torch's synchronization check, which must find none.
9. generate_moe — the Mixtral-8x7B shape of the public
   mistralai/Mixtral-8x7B-v0.1 config (the 7B attention, 8 experts of ff
   14336 with 2 used, rope base 1e6, vocab 32000) cut from 32 layers to
   20 (L below: the machine with the card takes 45 GiB of writes to its
   disk a call; every phase's GGUFs with a 32-layer Mixtral came to 49
   GiB, and the Q2_K mix's files took the room of 4 more of its layers) as
   a Q4_0 GGUF of 16.5 GB whose blocks are drawn from the seed (make_model
   draw="blocks"; written by the background writer, under build/smoke/),
   loaded once with ``load_model(weights="auto")`` (native: i4t attention,
   lane-major i4p expert stacks repacked on the card; the load's peak
   anonymous RSS printed), then phase 4's generate on it.  Exact counts
   (the reference's _moe_ffn takes the grouped dispatch, llama.py:540 and
   :188): per decode step 2·L + 1 i4t group-dot matmuls, 3·L grouped
   expert matmuls, L bf16 decode attentions and one append; at the
   16-row prefill 2·L i4t dequant matmuls, 3·L grouped ones and the lm head.
10. batch_moe — the same model through phase 5's bench_batch (load_model
   (weights="auto", batch_hint=64) resolves to native for a file that is
   70 GB as bf16: the same loaded model), 64 streams, int8 KV.  Exact
   counts: per decode step and per prefill chunk 2·L + 1 i4t dequant
   matmuls and 3·L grouped ones; L int8 decode attentions and one append
   per step, L prefill attentions per chunk.  Every decode dispatch runs
   under torch's synchronization check, which must find no host sync.

   generate_q6k and batch_q6k (after batch_i8c) — the DeepSeek-Coder-1.3B
   shape of the public deepseek-ai/deepseek-coder-1.3b-base config (24
   layers, hidden 2048, 16 heads over 16 kv heads of 128, ff 5504, vocab
   32256, rope base 1e5 with linear scaling 4) as llama.cpp's Q6_K file:
   Q6_K blocks drawn from the seed, every ffn_down Q8_0 (1.2 GB, written by
   the background writer), loaded once with ``load_model(weights=
   "native")`` (i8t at group 16, the down lane-major i8 at group 32); phase
   4's generate and phase 5's bench_batch on it.  Exact counts, from the
   reference's dispatch (qmm_mlp declines the group-16 gate-up beside a
   group-32 lane-major down, pallas_qmm.py:1320, :1338; qmm_gateup takes
   it, at M = 1 in the group-dot form :1083): per decode step of generate
   2·24 + 1 group-dot matvecs (24 qkv, 24 wo, the lm head, counted by
   shape), 24 fused M = 1 gate-ups, 24 lane-major downs, 24 bf16 decode
   attentions and one append, and no whole-MLP kernel; at its 16-row
   prefill 48 dequant matmuls, 24 dequant gate-ups, 24 downs and the lm
   head; per batch step and prefill chunk 2·24 + 1 dequant matmuls, 24
   dequant gate-ups and 24 downs, with 24 int8 decode attentions and one
   append a step and 24 prefill attentions (G = 1) a chunk; no host sync
   in a decode dispatch.

   generate_q5k and batch_q5k (after batch_q6k) — the same 24-layer
   DeepSeek-Coder-1.3B shape as llama.cpp's Q5_K_S file (Q5_K blocks drawn
   from the seed, the token embedding Q5_K, output.weight Q6_K, every
   ffn_down Q5_1: its rows of 5504 hold no super-block; 0.95 GB, written by
   the background writer), loaded once with ``load_model(weights=
   "native")`` (wqkv, wo and w_gateup K-major i8t at group 32 with a mins
   plane, w_down lane-major i8 with one, the head i8t at group 16); phase
   4's generate and phase 5's bench_batch on it.  Exact counts by kernel
   and shape, from the reference's dispatch as for Q6_K (qmm_mlp declines a
   lane-major down; qmm_gateup takes the gate-up): per generate step 2·24 +
   1 mins-form matvecs (qkv, wo; the head without mins), 24 M = 1 gate-ups
   and 24 lane-major Q5_1 downs; at its 16-row prefill the wgmma tile's
   mins form for qkv, wo and the gate-up, and the downs; per batch step and
   prefill chunk the same forms at M = 64 and 2048; no dequantize-path
   matmul, no host sync in a decode dispatch; the profile windows watch the
   mins forms' kernels by name.

   generate_mpt and batch_mpt (after batch_q5k) — MPT-7B as the public
   mosaicml/mpt-7b config gives it (32 layers, d_model 4096, 32 heads of
   128, ff 16384, vocab 50432, ALiBi with max bias 8, no biases) as
   llama.cpp's Q4_0 file (Q4_0 blocks drawn from the seed, a Q6_K
   output.weight; 3.9 GB, written by the background writer) with a seeded
   byte-level BPE vocabulary, loaded once with ``load_model(weights=
   "native")``; phase 4's generate and phase 5's bench_batch on it.  ALiBi
   closes the reference's fused decode gate (llama.py:96) and its fused
   prefill (:666-670), so every step takes the masked layer loop, whose
   update_layer writes each layer's row through the per-layer append
   (kv_cache.py:137-143) and whose attention is plain.  Exact counts: per
   generate step 4·32 i4t group-dot matvecs (qkv, wo, up, down; counted by
   shape), the Q6_K head's group-16 matvec and 32 per-layer bf16 appends;
   at its prefill 4·32 dequant matmuls and the head; per batch step and
   prefill chunk 4·32 i4t dequant matmuls and the head's, 32 per-layer
   int8 appends a step; no decode attention, prefill attention or
   all-layer append; no host sync in a decode dispatch.  batch_mpt's
   warm-up runs chunks of 4 steps (a chunk of any length runs the same ops).

   generate_q4k (after batch_mpt) — bench.py's config 2: the 32-layer
   Llama-3-8B shape (hidden 4096, 32 heads over 8 kv heads, ff 14336,
   vocab 32000) with every weight Q4_K (blocks drawn from the seed, 4.6 GB,
   written by the background writer), loaded once with
   ``load_model(weights="auto")`` (native: i4t with four planes), then
   ``Engine(max_batch=1, max_seq=8192, decode_chunk=64)`` and, after bench's
   warm-up, a generate of 128 tokens of bench's prompt with
   ``SamplingParams(temp=0.8, janus=1, seed=0)``.  Exact counts, from the
   reference's dispatch as phase 4's: per decode step 3·32 + 1 i4t
   group-dot matvecs (qkv, wo, down, the lm head; counted by shape) and 32
   fused M = 1 gate-ups, 32 bf16 decode attentions and one append; at the
   128-row prefill 3·32 dequant matmuls, 32 dequant gate-ups and the lm
   head; no dequantize-path matmul.  A 32-token window under torch.profiler
   gives the busy share.  Then the long run: a prompt of Q4K_LONG ids (the
   8192-row bucket; decode attention over ~7,000 rows) with 32 new tokens
   (one 64-step chunk), its counts exact by the same rule; its TTFT and
   tok/s printed.

   generate_q2k and batch_q2k (after generate_q4k) — the same 32-layer
   Llama-3-8B shape as llama.cpp's Q2_K mix (LLAMA3_8B_Q2K: Q2_K blocks,
   Q3_K attn_output and ffn_down, a Q4_K attn_v, a Q6_K head; 2.7 GB,
   written by the background writer), loaded once with ``load_model(
   weights="native")`` (every layer weight K-major i4t: q, k and w_gateup
   at group 16 with four planes, wo and w_down at group 16 with zero 4, wv
   at group 32 with four; the head i8t at group 16); phase 4's generate
   (128 greedy tokens) and phase 5's bench_batch on it.  Exact counts by
   kernel form and shape, from the reference's dispatch (q, k and v unfused
   as its _concat_rows leaves them; qmm_gateup takes the gate-up at every
   M): per generate step 2·32 group-16 matvecs with mins (q, k), 32 Q4_K
   matvecs (v), 2·32 with zero 4 (wo, down), 32 M = 1 gate-ups with mins
   and the head's matvec; at its 16-row prefill the tile's same forms and
   the head; per batch step and prefill chunk the same forms of the tile
   at M = 64 and 2048; no dequantize-path matmul, no host sync in a decode
   dispatch; the profile windows watch the group-16 kernels by name.

   generate_gemma and batch_gemma (after batch_q2k) — Gemma-2B (the public
   google/gemma-2b config: GEMMA_2B) at its full 18 layers as llama.cpp's
   Q4_0 mix writes it (Q4_0 layers, a Q6_K token table, no output.weight:
   1.54 GB), loaded once with ``load_model(weights="native")`` (every layer
   weight K-major i4t; the table dense bf16, dequantized on the card);
   phase 4's generate (128 greedy tokens, a 16-row prefill) and phase 5's
   bench_batch (64 streams, T = BATCH_GEMMA_T) on it.  Exact counts by
   kernel form and shape: per generate step 3·18 i4t matvecs (qkv, wo,
   down) and 18 M = 1 gate-ups with the GELU epilogue, 18 bf16 decode
   attentions and one append at 256 lanes; at the prefill the tile's forms;
   per batch step and prefill chunk the same at M = 64 and 2048 with the
   int8 forms; the tied head a torch product (no kernel); the profile
   windows watch the GELU gate-ups and the 256-lane kernels by name and
   fail on a SiLU gate-up or a 128-lane attention.

   generate_gemma_i8, generate_gemma_q6k, batch_gemma_q6k and server_gemma
   (after batch_gemma; the Gemma phases run before generate_q8, so that
   the writer's 7B file, its slowest, comes late) — the same Gemma-2B
   file loaded with ``weights="i8"`` (i8t at group 32), and llama.cpp's
   Q6_K mix of the same config (GEMMA_2B_Q6K: every 2-D weight and the
   token table Q6_K, 2.06 GB, i8t at group 16 throughout), through phase
   4's generate and (Q6_K) phase 5's bench_batch.  The reference's gate
   takes the whole MLP at every M of these widths, so exact counts: per
   generate step 2·18 int8 matvecs (qkv, wo) and 18 whole MLPs with GELU
   (mlp_i8t_gelu, mlp_i8t_g16_gelu), 18 bf16 decode attentions and one
   append at 256 lanes, at the prefill the tile's qkv and wo and 18 MLPs;
   per batch step and prefill chunk 2·18 tile matmuls and 18 MLPs at
   group 16 (M 64 and 2048), the int8 256-lane attention and append; no
   4-bit kernel, int8 gate-up or SiLU MLP (the profiles fail on them).
   server_gemma: phase 8 on generate_gemma's Q4_0 model (no second load),
   its 256-lane paged pool: per decode step 18 int8 paged attentions and
   one paged append (their _d256 forms), nothing else of the cache's.

   generate_gemma7b_i8 and batch_gemma7b_i8 (after server_gemma) —
   Gemma-7B (the public google/gemma-7b config: GEMMA_7B) as llama.cpp's
   Q4_0 mix writes it, cut to LAYERS["gemma7b"] = 4 of its 28 layers (the
   card machine's 45 GiB of writes a call: 1.27 GB), loaded once with
   ``weights="i8"`` (i8t at group 32; the 256000 x 3072 table dense bf16,
   the tied head).  generate: phase 4's with a prompt of GEMMA7B_PREFILL_M
   = 256 rows (the reference's whole-MLP gate declines from 142 rows at
   these widths, so the prefill runs the int8 gate-up with GELU, then the
   down, beside qkv and wo in the tile) and 128 greedy steps (2·L int8
   matvecs, L whole MLPs with GELU, L bf16 decode attentions at 16 kv heads
   of 256, G = 1, and one append a step).  batch: phase 5's bench_batch on
   the same model (64 streams, T = BATCH_GEMMA_T: the prefill's 2048 rows
   through the GELU gate-up, each step's 64 through the whole MLP, the
   int8 256-lane attention and append).  Exact counts by form and shape;
   the profile windows watch the GELU dq_kernel, the MLP and the 256-lane
   decode attention by name and fail on a SiLU gate-up, a SiLU MLP, a
   4-bit kernel or a 128-lane attention.  At 4 layers the rates are the
   tied head's and the host's more than the layers'.

Then one ``{"kernels": [...]}`` line (each kernel's launches are those of
the path that runs it: generate / generate_q8 for the M = 1 kernels and
bf16-cache attention, batch / batch_q8 for the int8 ones, server for the
paged ones, generate_moe / batch_moe for the grouped ones, generate_i8c /
batch_i8c for the i8c ones, generate_q6k / batch_q6k for the group-16
forms, the M = 1 fused gate-up and the 1.3B down, generate_q5k /
batch_q5k for the int8 forms with mins at the 1.3B shapes, parity (k) for
the whole MLP with mins, generate_q2k / batch_q2k for the i4t forms at
group 16, generate_gemma / batch_gemma for the GELU gate-up and the
256-lane attention and appends, generate_gemma_i8 / parity (o) and
generate_gemma_q6k / batch_gemma_q6k for the whole MLP with GELU at
groups 32 and 16, generate_gemma7b_i8 / batch_gemma7b_i8 for the int8
gate-up with GELU at 256 and 2048 rows and the Gemma-7B shapes, parity (r)
q8_0 / q5_k for its M = 1 form, server_gemma for the 256-lane paged forms,
generate_mpt /
batch_mpt for the per-layer appends, generate_q4k for config 2's Q4_K rows
(its long run, generate_q4k_8k, for the 8192-row qkv), parity (j) for the
lane-major mins form's grouped rows; the bf16-pool
paged forms, the plain lane-major forms at the 7B shapes and the i4t
gate-up's zero-4 form launch no time there; the line also holds the sizes
of the GGUFs the run wrote, against the card machine's 45 GiB of writes)
and, last,
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import re
import subprocess
import sys
import time
import traceback
import tracemalloc
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
if not (ROOT / "booster_tpu_torch" / "csrc").is_dir():
    sys.exit("chip_smoke.py: booster_tpu_torch/ not found beside this script "
             "(run it from a checkout of the repository)")
sys.path.insert(0, str(ROOT))
# device ms per call (CUDA graphs of 20 calls, each after an L2 scrub) and
# the card's bounds: one timer for the kernels phase and the probe tools
from booster_tpu_torch.tools.timing import bound, release as release_scrub, timed  # noqa: E402
PHASES = ("build", "kernels", "probes", "parity", "generate", "batch", "generate_i8",
          "generate_gemma", "batch_gemma", "generate_gemma_i8", "generate_gemma_q6k",
          "batch_gemma_q6k", "server_gemma", "generate_gemma7b_i8", "batch_gemma7b_i8",
          "generate_q8", "batch_q8", "server",
          "generate_i8c", "batch_i8c", "generate_q6k", "batch_q6k", "generate_q5k", "batch_q5k",
          "generate_mpt", "batch_mpt", "generate_q4k", "generate_q2k", "batch_q2k",
          "generate_moe", "batch_moe")

# TinyLlama-1.1B (config 1 of bench.py), Q4_0
TINYLLAMA = dict(vocab_size=32000, hidden=2048, heads=32, kv_heads=4, ff=5632,
                 seed=0, weight_scale=0.05)
# the Mistral-7B shape of bench.py's config 3 (bench.py:63-68), Q8_0
MISTRAL7B = dict(vocab_size=32000, hidden=4096, heads=32, kv_heads=8, ff=14336,
                 seed=0, weight_scale=0.05)
# the public mistralai/Mixtral-8x7B-v0.1 config.json: the 7B attention (32
# heads over 8 kv heads of 128), 8 experts of ff 14336 of which 2 are used,
# rope_theta 1e6, 32K context; its quantized blocks drawn directly from the
# seed (make_model draw="blocks"), 26 GB as Q4_0 at 32 layers (the full-size
# phases run 20: LAYERS)
MIXTRAL = dict(vocab_size=32000, hidden=4096, heads=32, kv_heads=8, ff=14336, experts=8,
               experts_used=2, rope_base=1e6, context=32768, seed=0, weight_scale=0.05,
               draw="blocks")
# the public deepseek-ai/deepseek-coder-1.3b-base config.json: 24 layers,
# hidden 2048, 16 heads over 16 kv heads of 128 (MHA), ff 5504, vocab 32256,
# rope_theta 1e5 with linear scaling 4, rms_norm_eps 1e-6, 16K context,
# untied head; as llama.cpp quantizes it to Q6_K (every ffn_down, whose rows
# of 5504 hold no 256-element super-block, falls back to Q8_0), its blocks
# drawn from the seed; the SPM test vocab stands in for its BPE one
DEEPSEEK = dict(vocab_size=32256, hidden=2048, heads=16, kv_heads=16, ff=5504,
                rope_base=100000.0, rope_scaling=("linear", 4.0), rms_eps=1e-6,
                context=16384, seed=0, weight_scale=0.05, draw="blocks")
# the public mosaicml/mpt-7b config.json: d_model 4096, 32 layers, 32 heads
# (MHA, head dim 128), expansion_ratio 4 (ff 16384), vocab 50432, max_seq_len
# 2048, ALiBi with alibi_bias_max 8, no clip_qkv, no_bias, LayerNorm eps 1e-5;
# as llama.cpp's Q4_0 mix writes it (Q4_0 blocks, a Q6_K output.weight),
# blocks drawn from the seed; a seeded byte-level BPE vocabulary of 50432
# tokens (pre-tokenizer mpt) stands in for GPT-NeoX-20B's
MPT7B = dict(vocab_size=50432, hidden=4096, heads=32, kv_heads=32, ff=16384, arch="mpt",
             context=2048, rms_eps=1e-5, alibi_max_bias=8.0, output_quant="Q6_K", seed=0,
             weight_scale=0.05, draw="blocks")
# the Llama-3-8B shape of bench.py's config 2 (bench.py:57-62): 4096 wide,
# 32 heads over 8 kv heads of 128, ff 14336, vocab 32000, every 2-D weight
# Q4_K (tools/make_test_model.py's rule: rows of a multiple of 256 take the
# chosen type), its blocks drawn from the seed (4.6 GB)
LLAMA3_8B = dict(vocab_size=32000, hidden=4096, heads=32, kv_heads=8, ff=14336, seed=0,
                 weight_scale=0.05, draw="blocks")
# llama.cpp's Q5_K_S mix (llama_tensor_get_type): every 2-D weight Q5_K, the
# token embedding too, output.weight Q6_K, and Q5_1 where a weight's rows
# hold no 256-element super-block (make_model's fallback): on the
# DeepSeek-Coder-1.3B shape every ffn_down (rows of 5504) is Q5_1, and
# lane-major ((5504/32) % 8 = 4), the rest K-major int8 with mins planes;
# on the Llama-3-8B width (ff 14336) every weight but the head is Q5_K and
# K-major, so the whole MLP takes its mins form (parity (k), 2 layers: ~5 GB
# at 32 would pass the chip machine's writes)
DEEPSEEK_Q5KS = dict(DEEPSEEK, output_quant="Q6_K")
LLAMA3_8B_Q5KS = dict(LLAMA3_8B, output_quant="Q6_K")
# llama.cpp's Q2_K mix (after llama_tensor_get_type in llama.cpp's
# src/llama.cpp; testing.q2k_mix(32, 8) gives the same types, which
# tests/test_torch_q2k.py holds): on the Llama-3-8B shape (n_head / n_head_kv =
# 4) token_embd, attn_q, attn_k, ffn_gate and ffn_up Q2_K, attn_v Q4_K,
# attn_output and ffn_down Q3_K, output.weight Q6_K; every layer weight
# K-major i4t (Q2_K at group 16 with mins, Q3_K at group 16 with zero 4,
# Q4_K at group 32 with mins), q, k and v three matmuls (their kinds
# differ: the loader does not fuse them); 2.7 GB of blocks at 32 layers
LLAMA3_8B_Q2K = dict(LLAMA3_8B, output_quant="Q6_K",
                     tensor_quant={"attn_v.weight": "Q4_K", "attn_output.weight": "Q3_K",
                                   "ffn_down.weight": "Q3_K"})
# the public google/gemma-2b config.json: hidden 2048, 18 layers, 8 heads over
# 1 kv head of 256 (G = 8, the 256-lane cache), ff 16384 (gelu_pytorch_tanh:
# the gated tanh-GELU), vocab 256000, rms_norm_eps 1e-6, rope_theta 10000,
# 8192 context, the head tied to the token table; as llama.cpp's Q4_0 mix
# writes it (every 2-D layer weight Q4_0; no output.weight, so token_embd
# takes Q6_K), blocks drawn from the seed (1.54 GB); the SPM test vocab
# stands in for Gemma's own
GEMMA_2B = dict(vocab_size=256000, hidden=2048, heads=8, kv_heads=1, head_dim=256, ff=16384,
                arch="gemma", embd_quant="Q6_K", rms_eps=1e-6, rope_base=10000.0,
                context=8192, seed=0, weight_scale=0.05, draw="blocks")
# the same config as llama.cpp's Q6_K mix writes it: every 2-D weight Q6_K
# (2048 and 16384 are multiples of 256: no fallback type), the token table
# too; every layer weight K-major i8t at group 16 (2.06 GB at 18 layers)
GEMMA_2B_Q6K = dict(GEMMA_2B)
# the public google/gemma-7b config.json: hidden 3072, 28 layers, 16 heads
# over 16 kv heads of 256 (G = 1, the 256-lane cache; the q width 4096
# beside the hidden 3072, so wo takes K = 4096), ff 24576
# (gelu_pytorch_tanh), vocab 256000, rms_norm_eps 1e-6, rope_theta 10000,
# 8192 context, the head tied to the token table; as llama.cpp's Q4_0 mix
# writes it (Q4_0 layers, a Q6_K token table, no output.weight), blocks
# drawn from the seed: 0.156 GB a layer beside the table's 0.645 GB
# (LAYERS cuts it to 4 of its 28)
GEMMA_7B = dict(vocab_size=256000, hidden=3072, heads=16, kv_heads=16, head_dim=256, ff=24576,
                arch="gemma", embd_quant="Q6_K", rms_eps=1e-6, rope_base=10000.0,
                context=8192, seed=0, weight_scale=0.05, draw="blocks")
# generate_gemma7b_i8's prompt: its 182 ids on the seeded SPM vocab take
# the 256-row bucket (phase_generate checks it), past the 141 rows up to
# which the reference's whole MLP takes Gemma-7B's widths (_pick_bf_mlp)
GEMMA7B_PROMPT = "benchmark " * 20
GEMMA7B_PREFILL_M = 256
# parity (r)'s narrow Gemma-shaped files: hidden 512, 4 heads of 256 over 4
# kv heads (Gemma-7B's G = 1), ff 512, vocab 512, a Q6_K token table; the
# ffn_down Q6_K (group 16) in every layer beside Q8_0 or (GGUFS
# "gemma_mix_q5k") Q5_K gate/up (group 32): the whole MLP wants one group,
# so the reference runs the int8 gate-up with GELU at every M (a few MB)
GEMMA_MIX = dict(vocab_size=512, hidden=512, heads=4, kv_heads=4, head_dim=256, ff=512,
                 arch="gemma", embd_quant="Q6_K", rms_eps=1e-6, seed=0, weight_scale=0.05,
                 draw="blocks", tensor_quant={"ffn_down.weight": "Q6_K"})
# config 2's run (bench.py:72-100): its prompt, engine and sampling
Q4K_PROMPT = "benchmark " * 12
Q4K_MAX_SEQ, Q4K_CHUNK = 8192, 64
# the prompt's bucket, the prefill's rows: its 110 ids on the seeded SPM vocab
# take the 128-row bucket (phase_generate_q4k checks it)
Q4K_PREFILL_M = 128
Q4K_LONG = 7000  # the long prompt's token ids: the 8192-row bucket, cache lens ~7,000
# batch_mpt's prompt bucket: its prefill runs the i4t matmuls at M = 64·T
# (the kernels phase times them there; phase_batch checks the bucket)
BATCH_MPT_T = 16
# batch_q2k's prompt bucket: its prefill runs the group-16 tile at M = 64·T,
# 128 rows a block (the kernels phase times it there; phase_batch checks it)
BATCH_Q2K_T = 32
# batch_gemma's prompt bucket (its 64 prompts on the 256000-token vocab): the
# GELU gate-up at M = 64·T and the 256-lane prefill attention at T rows
BATCH_GEMMA_T = 32
# parity (e)'s decode steps after its prefill: on the CPU each step
# dequantizes every routed expert of its 2 layers, so the steps are few
# (cut from 8 to 3, then to 2 when MPT-7B's phases came)
MOE_PARITY_STEPS = 2
# parity (c)-(d)'s decode steps (the 7B width on the CPU takes 2-3 s a step:
# cut from 8 to 4, then to 2 when MPT-7B's phases came, to hold the
# script near half its time limit).  2 is the floor for (c)-(e): a step that
# reads the prefill's rows and one that reads a decoded row
PARITY_7B_STEPS = 2
# the attention kernels' layouts on the two models' paths: the bf16-cache
# generate (batch 1, S1 rows) and the int8-cache batch (B slots, S rows)
TINY_ATTN = dict(name="TinyLlama", L=22, Hkv=4, G=8, D=64, Dc=128, S1=1024, B=64, S=512,
                 prefill_T=(16, 32), gen_path="generate", batch_path="batch")
MISTRAL_ATTN = dict(name="7B", L=32, Hkv=8, G=4, D=128, Dc=128, S1=1024, B=64, S=512,
                    prefill_T=(32,), gen_path="generate_q8", batch_path="batch_q8")
DEEPSEEK_ATTN = dict(name="1.3B", L=24, Hkv=16, G=1, D=128, Dc=128, S1=1024, B=64, S=512,
                     prefill_T=(16, 32), gen_path="generate_q6k", batch_path="batch_q6k")
# Gemma-2B: one kv head of 8 query heads, head dim 256 at 256 lanes (the
# attention and append kernels' _d256 forms); generate's cache lengths 15-143
# (mean ~80) and a long context's ~500, the batch's after its 26-token prompts
GEMMA_ATTN = dict(name="Gemma-2B", L=18, Hkv=1, G=8, D=256, Dc=256, S1=1024, B=64, S=512,
                  prefill_T=(BATCH_GEMMA_T,), gen_path="generate_gemma",
                  batch_path="batch_gemma", gen_lens=(150, 500), batch_lens=(150, 500))
# Gemma-7B at its 4 layers: 16 kv heads of one query head each, head dim 256;
# generate's cache lengths 182-310 (its 182-token prompt, 128 steps)
GEMMA7B_ATTN = dict(name="Gemma-7B", L=4, Hkv=16, G=1, D=256, Dc=256, S1=1024, B=64, S=512,
                    prefill_T=(BATCH_GEMMA_T,), gen_path="generate_gemma7b_i8",
                    batch_path="batch_gemma7b_i8", gen_lens=(246, 310), batch_lens=(150, 500))
PROMPT = "hello world and the end"  # 15 tokens: the 16-row prefill bucket

# the i4t gate-up's M = 1 matvec pair by its epilogue (the profile names the
# i8mv::Out template argument as a cast number or as the enumerator)
GELU_MV = r"re:i4mv::mv_kernel<32, false, [^>]*(3|kGateUpGelu)>"
SILU_MV = r"i4mv::mv_kernel<32, false, [^>]*(2|kGateUp)>"

# tolerances of kernel vs plain version on the card, and why
CHECKS = {
    # f32 sums of the same exact products in another order
    "qmm": "max|kernel - plain| <= 2e-4 * max|plain|",
    # bf16 outputs: g or u may round the other way where their f32 sums differ
    "gateup": "|kernel - plain| <= 2^-7 |plain| + 1e-5 max|plain| per element",
    # online softmax over chunks vs one pass: bf16(p) is rounded against
    # another running max, so a weight may move by 2^-8 of itself
    # (booster_tpu_torch.testing.decode_attn_limit); the check must see a
    # dropped self term, a missed last column and one read past the end
    "attention": "|kernel - plain| <= 2^-8 * 1.01 * (sum_j p_j |v_j|) / l + 1e-5 max|plain| "
                 "per element; each of three wrong kernels exceeds it 8x",
    "append": "exact",
    # the int8 forms: the same bound with the v scale in the weight,
    # 2^-8 * 1.01 * (sum_j p_j |vs_j v_j|) / l; must see the same wrong
    # kernels and one that ignores the v scales, each 8x
    "attention_i8": "|kernel - plain| <= 2^-8 * 1.01 * (sum_j p_j |vs_j v_j|) / l "
                    "+ 1e-5 max|plain| per element; each of four wrong kernels exceeds it 8x",
    "prefill": "|kernel - plain| <= 2^-8 * 1.01 * (sum_j p_j |vs_j v_j|) / l "
               "+ 1e-5 max|plain| per element; each of four wrong kernels exceeds it 8x",
    "append_i8": "exact (payload and scales)",
    # the paged forms: decode attention's bound over the valid columns read
    # through the table; must see four wrong kernels (table ignored, a page
    # off by one, the in-page row ignored, the scales of the wrong page) 8x
    "paged_attention": "|kernel - plain| <= 2^-8 * 1.01 * (sum_j p_j |vs_j v_j|) / l "
                       "+ 1e-5 max|plain| per element; each wrong kernel exceeds it 8x",
    # the i8t gate-up at M = 2048 (29 M outputs): g and u may both round
    # the other way, each by one bf16 ulp (up to 2^-7 of itself), and the
    # two later roundings (of g·sg and of the product) move up to 2^-8 each
    "gateup_i8": "|kernel - plain| <= 2^-5 |plain| + 1e-5 max|plain| per element",
    # bf16 outputs after a down sum of ff products: a flip of one mid
    # element (see gateup) moves every output by up to 2^-8 of that product
    "mlp": "max|kernel - plain| <= 2^-7 * max|plain|",
    # two bf16 roundings of any intermediate may differ and propagate
    "logits": "max|cuda - cpu| <= 2^-5 * max|cpu logit|",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def host_us(fn, reps: int = 200) -> float:
    """Host µs per call to enqueue `fn` (its Python, checks, allocations and
    launch), timed before the card is waited for: what one call costs the
    host thread that dispatches a decode step."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


class _Laps:
    """Seconds between the named points of a phase, summed by name (the
    phase's "part_s"): where a phase's time goes on the host it ran on."""

    def __init__(self):
        self.t, self.parts = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self.t
        self.t = now


# -- phase 1 -----------------------------------------------------------------


def _warm_profiler() -> float:
    """The card's context and torch.profiler's first trace (its CUDA
    tracing set up: about 10 s the first time), on a thread while nvcc
    builds the kernels, so the first path's profile does not pay them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    x = torch.ones(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (x + 1).sum().item()
    sum(1 for _ in prof.profiler.kineto_results.events())
    return time.perf_counter() - t0


def phase_build() -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from booster_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:
        warm = ex.submit(_warm_profiler)
        report = kernels.build()
        warm_s = warm.result()
    libs = {}
    for name, r in report.items():
        lines = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        # each kernel that spills: its entry line, then the spill line after it
        spilling = [(lines[i - 1][-120:], ln) for i, ln in enumerate(lines)
                    if "spill" in ln and not ln.startswith("0 bytes stack frame, 0 bytes spill")
                    and i > 0]
        libs[name] = {"seconds": round(r["seconds"], 2),
                      "ptxas": [ln for ln in lines if "Compiling entry" not in ln][:8],
                      "spilling": spilling,
                      "warnings": [ln.strip()[-200:] for ln in r["log"].splitlines()
                                   if "warning" in ln.lower()][:6]}
    mins = {}
    for name in ("qmm_i4t", "qmm_i8t", "qmm_i8t_gelu", "mlp_i8t", "mlp_i8t_gelu"):
        if name in report:
            mins.update(_mins_forms_ptxas(report[name]["log"]))
    return {"phase": "build", "seconds": time.perf_counter() - t0, "libraries": libs,
            "mins_forms": mins, "profiler_warm_s": warm_s}


# The M > 1 tiles' instantiations with mins (their template arguments: the
# i4t tile's mm_kernel<BM, GATEUP, G, ACT, MINS>, the int8 tile's
# dq_kernel<BM, G, GATEUP, MINS, ACT> and mlp_kernel<BM, G, MINS, ACT>)
_MINS_FORM = re.compile(r"(mm_kernel|dq_kernel|mlp_kernel)I((?:L[ib]\d+E)+)E")
_MINS_ARG = {"mm_kernel": 4, "dq_kernel": 3, "mlp_kernel": 2}  # the MINS argument's place


def _mins_forms_ptxas(log: str) -> dict:
    """`nvcc -Xptxas -v`'s registers and spills of each mins instantiation
    of the M > 1 tiles in a library's build log: {"dq_kernel<256,32,0,1,0>":
    {"registers": 168, "spill": "0 bytes stack frame, ..."}, ...}."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            f = _MINS_FORM.search(m.group(1))
            args = re.findall(r"L[ib](\d+)E", f.group(2)) if f else []
            cur = (f"{f.group(1)}<{','.join(args)}>"
                   if f and args[_MINS_ARG[f.group(1)]] == "1" else None)
            if cur:
                out[cur] = {}
        elif cur and "spill stores" in ln:
            out[cur]["spill"] = ln.strip()
        elif cur and (r := re.search(r"Used (\d+) registers", ln)):
            out[cur]["registers"] = int(r.group(1))
    return out


# -- phase 2 -----------------------------------------------------------------


def _stacked_i4t(L, K, N, gen, mins=False):
    """A random i4t weight [L, K/2, N] made on the card: Q4_0's form (zero
    point 8, two bf16 scale planes), or with `mins` four planes and zero 0."""
    import torch

    from booster_tpu_torch.gguf import GGMLType
    from booster_tpu_torch.quant.qtensor import QTensor

    qw = torch.randint(0, 256, (L, K // 2, N), dtype=torch.uint8, device="cuda", generator=gen)
    s = (torch.rand((L, 4 if mins else 2, K // 64, N), device="cuda", generator=gen) * 0.02
         + 1e-3)
    return QTensor("i4t", qw, s.to(torch.bfloat16), None, 32, (N, K), GGMLType.Q4_0,
                   zero=0 if mins else 8)


def _i4t_split_groups(M, K, N, G=32):
    """Groups [g0, g1) of each half that a wrong qmm_i4t.cu launch at (M, K,
    N) and group G leaves out in testing.qmm_i4t_mutants: the last K split
    of ops.qmm.i4t_mv_plan's launch at M = 1 (testing.i4t_mv_last: the last
    group where it has one split), of i4t_plan's above (whole stages of 32
    rows of k of each half: 32/G groups a stage)."""
    from booster_tpu_torch.ops import qmm as tq
    from booster_tpu_torch.testing import i4t_mv_last

    ngh = K // (2 * G)
    if M == 1:
        return i4t_mv_last(ngh, tq.i4t_mv_plan(K, N, G))
    ks, nst = tq.i4t_plan(M, K, N)[1], K // 64
    return (ks - 1) * nst // ks * (32 // G), ngh


def _i4t_row(entries, failures, label, w, M, gen, path, gateup=False, trials=5,
             mins_on_path=False, on_path=True, act="silu"):
    """One i4t kernel row: qmm_i4t (or the fused gate-up) on x [M, K] against
    its plain version (2e-4 of the largest output; the gate-up per element,
    and bit-equal to the unfused kernel + silu·mul), equal to itself on a
    second launch at M = 1, each wrong kernel of testing.qmm_i4t_mutants
    (and, with mins, of qmm_mins_mutants) 8x past the limit, timed cold and
    warm with the plain version and the bf16 library call.  A row with mins
    counts its launches on `path` where `mins_on_path` (Q4_K's path), else
    under a key no path counts; a row at a shape no path runs (`on_path`
    false) likewise.  A gate-up's `act` is its epilogue ("gelu": Gemma's
    tanh-GELU, whose wrong kernel the SiLU epilogue is)."""
    import torch

    from booster_tpu_torch.ops import qmm as tq
    from booster_tpu_torch.quant.qtensor import dequantize
    from booster_tpu_torch.testing import (gateup_flips, qmm_i4t_mutants, qmm_mins_mutants,
                                           without_mins)

    N, K = w.shape
    R, G = w.resolved().scales.shape[0], w.group
    x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
    flips = None  # gate-up outputs that one-ulp roundings of g and u explain
    if gateup:
        ff = N // 2

        def kern(x_, w_):
            return tq.qmm_i4t_gateup(x_, w_, act)

        def plain(x_, w_):
            return tq.qmm_gateup_plain(x_, w_, act=act)

        got, want = kern(x, w), plain(x, w)
        limit = 2 ** -7 * want.float().abs() + 1e-5 * want.float().abs().max()
        gu = tq.qmm_i4t(x, w)
        gp = tq.qmm_plain(x, w)
        if float((gu - gp).abs().max()) > 2e-4 * float(gp.abs().max()):
            failures.append(f"{label} M={M}: the gate-up's f32 sums past qmm's limit")
        gu = gu.to(torch.bfloat16)
        if not torch.equal(got, tq.act_mul(gu[:, :ff], gu[:, ff:], act)):
            failures.append(f"{label} M={M}: fused gate-up != qmm + {act}·mul")
        flips = gateup_flips(got, gp[:, :ff].to(torch.bfloat16), gp[:, ff:].to(torch.bfloat16),
                             act)
        name, out_bytes = tq.i4t_count_name(True, M, G, R == 4, act), M * ff * 2
    else:
        kern, plain = tq.qmm_i4t, tq.qmm_plain
        got, want = kern(x, w), plain(x, w)
        limit = 2e-4 * want.abs().max()
        name, out_bytes = tq.i4t_count_name(False, M, G, R == 4), M * N * 4

    def share(y, flips=None):  # the largest error as a share of the limit
        s = (y.float() - want.float()).abs() / limit
        return float((s if flips is None else s.masked_fill(flips, 0.0)).max())

    err = float((got.float() - want.float()).abs().max())
    if not (share(got, flips) <= 1 and torch.isfinite(got.float()).all()):
        failures.append(f"{name} {label} M={M}: max err {err} past the limit")
    if M == 1 and not torch.equal(got, kern(x, w)):
        failures.append(f"{name} {label} M={M}: a second launch differs")
    mutants = {**qmm_i4t_mutants(x, w, _i4t_split_groups(M, K, N, G)),
               **qmm_mins_mutants(x, w)}
    seen = {what: share(plain(xm, wm)) for what, (xm, wm) in mutants.items()}
    if gateup and act == "gelu":  # the epilogue's own wrong kernel
        seen["SiLU in place of GELU"] = share(tq.qmm_gateup_plain(x, w, act="silu"))
    for what, v in seen.items():
        if v < 8:
            failures.append(f"{name} {label} M={M}: the check cannot see {what} ({v})")
    lib_ms = matmul_ms = no_mins_ms = None
    if not gateup or R == 4:
        deq = dequantize(w, torch.bfloat16)
        if gateup:  # beside the mins forms: the bf16 product on the fused weight
            matmul_ms = timed(lambda: torch.matmul(x, deq.t()), trials=trials)
        else:
            lib_ms = timed(lambda: torch.matmul(x, deq.t()), trials=trials)
        del deq
    if R == 4:  # the same kernel on the weight without its mins plane
        wn = without_mins(w)
        no_mins_ms = timed(lambda: kern(x, wn), trials=trials)
        del wn
    nbytes = K // 2 * N + R * (K // (2 * G)) * N * 2 + M * K * 2 + out_bytes
    b_ms, b_by = bound(nbytes, 2 * M * K * N)
    entries.append({
        "name": name, "shape": f"{label} M={M} K={K} N={N}" + (" R=4" if R == 4 else "")
        + (f" G={G} zero={w.zero}" if G != 32 else ""),
        # a synthetic mins form, or a row count, that no path runs: a key no
        # launch counts under
        "key": (name, (K, N) + (("mins",) if R == 4 and not mins_on_path else ())
                + (() if on_path else ("no path",))),
        "path": path,
        "route": "cuda", "source": "booster_tpu_torch/csrc/qmm_i4t.cu",
        "replaces": "booster_tpu/ops/pallas_qmm.py:" + {
            (False, True): "393", (False, False): "469", (True, True): "932",
            (True, False): "798"}[gateup, M == 1],
        "max_abs_err": err, "max_err_of_limit": share(got, flips),
        "share_before_flips": None if flips is None else share(got),
        "outputs_of_flips": None if flips is None else int((flips & (got != want)).sum()),
        "min_wrong_kernel_of_limit": min(seen.values()),
        "ms": timed(lambda: kern(x, w), trials=trials),
        "warm_ms": timed(lambda: kern(x, w), trials=trials, cold=False),
        "plain_ms": timed(lambda: plain(x, w), reps=3, trials=3),
        "no_mins_ms": no_mins_ms, "matmul_ms": matmul_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "library": (f"null: no one torch call (gate-up + {'GELU' if act == 'gelu' else 'SiLU'}"
                    "·mul; matmul_ms: torch.matmul on the fused dequantized weight)" if gateup
                    else "torch.matmul on the dequantized bf16 weight"),
        "check": (CHECKS["gateup"] + ", or an output of one-ulp roundings of g and u; "
                  f"equal to qmm_i4t + {act}·mul, whose f32 sums hold qmm's check" if gateup
                  else CHECKS["qmm"]) + "; wrong kernels at 8x"})


def phase_kernels(entries: list) -> dict:
    import torch

    from booster_tpu_torch.ops import qmm as tq
    from booster_tpu_torch.quant.qtensor import dequantize

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    C, ff, V = 2048, 5632, 32000
    Hkv, D = 4, 64
    # two layers of each stacked weight (the calls take layer 1's view, as
    # the path takes layer i's); the lm head is one 2-D matrix; "qkv mins"
    # has synthetic mins planes (R = 4, zero 0: Q4_K's form, on no path yet)
    weights = {
        "qkv": _stacked_i4t(2, C, C + 2 * Hkv * D, gen),
        "wo": _stacked_i4t(2, C, C, gen),
        "down": _stacked_i4t(2, ff, C, gen),
        "gateup": _stacked_i4t(2, C, 2 * ff, gen),
        "lm_head": _stacked_i4t(1, C, V, gen),
        "qkv mins": _stacked_i4t(2, C, C + 2 * Hkv * D, gen, mins=True),
    }
    failures = []

    for M in (1, 16):
        for label, w in weights.items():
            if M > 1 and label == "lm_head":
                continue  # the lm head sees one gathered row at prefill too
            _i4t_row(entries, failures, f"TinyLlama {label}", w.at(w.qw.shape[0] - 1), M, gen,
                     "generate", gateup=label == "gateup")
    # the fused gate-up against the unfused kernel at a batch step and a
    # batch prefill's rows (no path runs an i4t gate-up there yet)
    for M in (64, 64 * BATCH_MPT_T):
        _i4t_row(entries, failures, "TinyLlama gateup", weights["gateup"].at(1), M, gen,
                 "batch_mpt", gateup=True, trials=3)
    del weights
    torch.cuda.empty_cache()
    # MPT-7B's widths at a generate_mpt step (M = 1), a batch_mpt decode step
    # (M = 64) and its prefill (64 prompts of T rows); Mixtral-8x7B's qkv and
    # wo at a generate_moe step and its lm head at a batch_moe step
    for label, K, N in (("qkv", 4096, 12288), ("wo", 4096, 4096), ("up", 4096, 16384),
                        ("down", 16384, 4096)):
        w = _stacked_i4t(2, K, N, gen)
        for M in (1, 64, 64 * BATCH_MPT_T):
            _i4t_row(entries, failures, f"MPT-7B {label}", w.at(1), M, gen,
                     "generate_mpt" if M == 1 else "batch_mpt", trials=3)
        del w
        torch.cuda.empty_cache()
    C7 = MIXTRAL["hidden"]
    for label, N, M, path in (("qkv", C7 + 2 * MIXTRAL["kv_heads"] * (C7 // MIXTRAL["heads"]), 1,
                               "generate_moe"), ("wo", C7, 1, "generate_moe"),
                              ("lm_head", V, 64, "batch_moe")):
        w = _stacked_i4t(1, C7, N, gen)
        _i4t_row(entries, failures, f"Mixtral {label}", w.at(0), M, gen, path, trials=3)
        del w
        torch.cuda.empty_cache()
    for lay in (TINY_ATTN, MISTRAL_ATTN, DEEPSEEK_ATTN):
        _bf16_attn_kernels(entries, failures, lay)
        _int8_kernels(entries, failures, lay)
    paged_checks: dict = {}
    _paged_kernels(entries, failures, paged_checks)
    append_checks: dict = {}
    _layer_append_kernels(entries, failures, append_checks)
    _i8t_kernels(entries, failures)
    _i8c_kernels(entries, failures)
    _q6k_kernels(entries, failures)
    _moe_kernels(entries, failures)
    _q4k_kernels(entries, failures)
    _q4k_lane_kernels(entries, failures)
    _q5k_kernels(entries, failures)
    _q2k_kernels(entries, failures)
    _gemma_kernels(entries, failures)
    _gemma_mlp_kernels(entries, failures)
    _paged_kernels(entries, failures, paged_checks, PAGED_GEMMA)
    _gemma7b_kernels(entries, failures)
    multi_stage = _multi_stage_checks(failures)
    min_term = _min_term_checks(failures)
    tied = _tied_head_row(failures)
    tied_7b = _tied_head_row(failures, GEMMA_7B)
    floor = _append_floor()
    for e in entries:  # beside every append row: a row near it sits at the launch floor
        if e["name"].startswith("kv_append"):
            e.update(floor)
    release_scrub()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("kernel checks failed: " + "; ".join(failures))
    return {"phase": "kernels", "seconds": time.perf_counter() - t0,
            "checks": {e["name"] + " " + e["shape"]: e["max_abs_err"] for e in entries},
            "paged_checks": paged_checks, "layer_append_checks": append_checks,
            "append": floor, "tied_head": tied, "tied_head_gemma7b": tied_7b,
            "multi_stage_checks": multi_stage, "min_term_checks": min_term}


def _gemma_kernels(entries: list, failures: list) -> None:
    """Gemma-2B's new kernel forms: qmm_i4t.cu's gate-up with the GELU
    epilogue on a Q4_0 [2048, 2·16384] weight at generate_gemma's M = 1 and
    16-row prefill and batch_gemma's M = 64 and 64·BATCH_GEMMA_T (the SiLU
    epilogue among its wrong kernels), and decode_attn.cu, prefill_attn.cu
    and kv_append.cu at the 256-lane cache (GEMMA_ATTN: bf16 at B = 1, lens
    150 and 500; int8 at B = 64; the 32-row prefill; the appends at L 18;
    lanes 128-255 dropped among the attention's wrong kernels)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    C, ff = GEMMA_2B["hidden"], GEMMA_2B["ff"]
    w = _stacked_i4t(2, C, 2 * ff, gen)
    for M, path in ((1, "generate_gemma"), (16, "generate_gemma"), (64, "batch_gemma"),
                    (64 * BATCH_GEMMA_T, "batch_gemma")):
        _i4t_row(entries, failures, "Gemma-2B gateup", w.at(1), M, gen, path, gateup=True,
                 trials=3, act="gelu")
    del w
    torch.cuda.empty_cache()
    _bf16_attn_kernels(entries, failures, GEMMA_ATTN)
    _int8_kernels(entries, failures, GEMMA_ATTN)


# the whole MLP's GELU rows of _gemma_mlp_kernels: the model, its widths, its
# forms (label, group, mins, the path of M <= 16, of M > 16) and rows M
GEMMA2B_MLP = dict(name="Gemma-2B", conf=GEMMA_2B, Ms=(1, 16, 64, 2048), forms=(
    ("g32", 32, False, "generate_gemma_i8", "parity (o)"), ("g32 mins", 32, True, None, None),
    ("g16", 16, False, "generate_gemma_q6k", "batch_gemma_q6k")))
GEMMA7B_MLP = dict(name="Gemma-7B", conf=GEMMA_7B, Ms=(1, 64), forms=(
    ("g32", 32, False, "generate_gemma7b_i8", "batch_gemma7b_i8"),))


def _gemma_mlp_kernels(entries: list, failures: list, lay: dict = GEMMA2B_MLP) -> None:
    """csrc/mlp_i8t_gelu.cu's forms at Gemma-2B's widths (K 2048, ff 16384,
    C 2048; random weights on the card; or lay's: GEMMA7B_MLP, Gemma-7B's K
    3072, ff 24576 at group 32, M = 1 and 64): group 32 (Q4_0 widened by
    weights="i8", as Q8_0), group 32 with mins planes (real Q5_K planes,
    testing.q5k_weight; on no path) and group 16 (Q6_K), each at M = 1 and
    16 (generate's steps and
    prefill), 64 and 2048 (a batch step and its prefill: the reference's
    gate takes the whole MLP there too, 256 rows a tile).  Each equal bit
    for bit to its unfused sequence (the dequant matmul on the fused weight,
    gelu·mul, the dequant matmul on mid, a cast), its mid to gelu·mul of the
    unfused sums, within the MLP's limit of its plain version (mid within
    the gate-up's, or an output of one-ulp roundings of g and u), its
    workspace zero after the launch; the SiLU epilogue 8x past the mid's
    limit and the tile's wrong gate-up kernels (testing.qmm_i8k_mutants: a
    group read as the other among them; with mins, the mins dropped or of
    the wrong sign on either weight, testing.qmm_mins_mutants, as the Q5_K
    8B rows) 8x past the output's; timed beside the unfused sequence.  And the
    SiLU form at group 16 (a uniform Q6_K llama's; on no path) at M = 1 and
    64, equal to its unfused sequence."""
    import torch

    from booster_tpu_torch.ops import mlp as tm
    from booster_tpu_torch.ops import qmm as tq
    from booster_tpu_torch.testing import (gateup_flips, q5k_weight, qmm_i8k_mutants,
                                           qmm_mins_mutants, without_mins)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    C, ff = lay["conf"]["hidden"], lay["conf"]["ff"]
    bf = torch.bfloat16
    for label, G, mins, path1, path2 in lay["forms"]:
        if mins:
            gu = q5k_weight(2 * ff, C, seed=220, device="cuda")
            dn = q5k_weight(C, ff, seed=221, device="cuda")
        else:
            gu = _stacked_i8t(2, C, 2 * ff, gen, G).at(1)
            dn = _stacked_i8t(2, ff, C, gen, G).at(1)
        name = tm.mlp_count_name(G, "gelu")
        sbytes = sum(w.resolved().qw.numel() + w.resolved().scales.numel() * 2 for w in (gu, dn))

        def unfused(x):
            g = tq.qmm_i8t(x, gu, dq=True).to(bf)
            return tq.qmm_i8t(tq.gelu(g[:, :ff]) * g[:, ff:], dn, dq=True).to(bf)

        for M in lay["Ms"]:
            tag = f"{lay['name']} mlp {label} M={M}"
            x = torch.randn(M, C, device="cuda", generator=gen).to(bf)
            got, mid_k = tm._run(x, gu, dn, act="gelu")
            want = tm.qmm_mlp_plain(x, gu, dn, "gelu").float()
            err = float((got.float() - want).abs().max())
            limit = 2 ** -7 * float(want.abs().max())
            if not (torch.isfinite(got).all() and err <= limit):
                failures.append(f"{name} {tag}: max err {err}")
            g = tq.qmm_i8t(x, gu, dq=True).to(bf)
            if not torch.equal(mid_k, tq.gelu(g[:, :ff]) * g[:, ff:]):
                failures.append(f"{name} {tag}: mid != qmm_i8t (dq) + gelu·mul")
            if not torch.equal(got, unfused(x)):
                failures.append(f"{name} {tag}: != qmm_i8t (dq) + gelu·mul + qmm_i8t (dq)")
            torch.cuda.synchronize()
            if int(tq._tickets[x.device].abs().sum()):
                failures.append(f"{name} {tag}: its workspace is not zero after the launch")
            gp = tq.qmm_plain(x, gu, dq=True).to(bf)
            midp = (tq.gelu(gp[:, :ff]) * gp[:, ff:]).float()
            mlim = 2 ** -7 * midp.abs() + 1e-5 * midp.abs().max()
            flips = gateup_flips(mid_k, gp[:, :ff], gp[:, ff:], "gelu")
            if not bool((((mid_k.float() - midp).abs() <= mlim) | flips).all()):
                failures.append(f"{name} {tag}: mid past the gate-up limit")
            seen = {"SiLU for GELU (mid)": float(((tq.silu(gp[:, :ff]) * gp[:, ff:]).float()
                                                   - midp).abs().div(mlim).max())}
            nst, ks = C // 64, tq.i8k_plan(M, C, 2 * ff)[1]
            if mins:
                mutants = {f"gate-up: {k}": (xm, wm, dn)
                           for k, (xm, wm) in qmm_mins_mutants(x, gu).items()}
                mutants |= {f"down: {k}": (x, gu, wm)
                            for k, (_, wm) in qmm_mins_mutants(mid_k, dn).items()}
            else:
                mutants = {k: (xm, wm, dn) for k, (xm, wm) in
                           qmm_i8k_mutants(x, gu, ((ks - 1) * nst // ks, nst)).items()}
            for what, margs in mutants.items():
                seen[what] = float((tm.qmm_mlp_plain(*margs, "gelu").float()
                                    - want).abs().max()) / limit
            for what, v in seen.items():
                if v < 8:
                    failures.append(f"{name} {tag}: the check cannot see {what} ({v})")
            del gp, midp, mlim, flips, g, want
            b_ms, b_by = bound(sbytes + M * C * 2 + M * C * 2, 2 * M * C * 2 * ff + 2 * M * ff * C)
            path = path1 if M <= 16 else path2
            row = {
                "name": name, "shape": f"{lay['name']} mlp {label} M={M} K={C} ff={ff} C={C}",
                "key": (name, (C, C)), "path": path or "batch_gemma_q6k", "route": "cuda",
                "source": "booster_tpu_torch/csrc/mlp_i8t_gelu.cu",
                "replaces": "booster_tpu/ops/pallas_qmm.py:1172",
                "max_abs_err": err,
                "min_wrong_kernel_of_limit": min(seen.values()),
                "ms": timed(lambda: tm.qmm_mlp_i8t(x, gu, dn, "gelu"), trials=3),
                "warm_ms": timed(lambda: tm.qmm_mlp_i8t(x, gu, dn, "gelu"), trials=3, cold=False),
                "plain_ms": timed(lambda: tm.qmm_mlp_plain(x, gu, dn, "gelu"), reps=3, trials=3),
                "unfused_ms": timed(lambda: unfused(x), trials=3),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library": "none: no one torch call (gate-up, GELU·mul, down)",
                "check": CHECKS["mlp"] + "; equal to qmm_i8t (dq) + gelu·mul + qmm_i8t (dq); "
                         "mid per CHECKS['gateup'] or one-ulp flips; workspace zero; wrong "
                         "kernels at 8x"}
            if mins:  # the same kernel on both weights without their mins planes
                gun, dnn = without_mins(gu), without_mins(dn)
                row["no_mins_ms"] = timed(lambda: tm.qmm_mlp_i8t(x, gun, dnn, "gelu"), trials=3)
                del gun, dnn
            if path is None:  # counted under the form without mins' name
                row["launches_note"] = ("on no path (no Q5_K Gemma file); read on "
                                        "batch_gemma_q6k, which runs the group-16 form")
            entries.append(row)
            del x, got, mid_k
        if G == 16:  # the SiLU form at group 16 (a uniform Q6_K llama; on no path here)
            for M in (1, 64):
                x = torch.randn(M, C, device="cuda", generator=gen).to(bf)
                got = tm.qmm_mlp_i8t(x, gu, dn)
                g = tq.qmm_i8t(x, gu, dq=True).to(bf)
                want = tm.qmm_mlp_plain(x, gu, dn).float()
                err, limit = float((got.float() - want).abs().max()), 2 ** -7 * float(
                    want.abs().max())
                if not (err <= limit and torch.equal(got, tq.qmm_i8t(
                        tq.silu(g[:, :ff]) * g[:, ff:], dn, dq=True).to(bf))):
                    failures.append(f"mlp_i8t_g16 M={M}: max err {err}, or != its unfused "
                                    "sequence")
                b_ms, b_by = bound(sbytes + 4 * M * C, 2 * M * C * 2 * ff + 2 * M * ff * C)
                entries.append({
                    "name": "mlp_i8t_g16", "shape": f"Gemma-2B widths mlp g16 SiLU M={M}",
                    "key": ("mlp_i8t_g16", (C, C)), "path": "batch_gemma_q6k", "route": "cuda",
                    "source": "booster_tpu_torch/csrc/mlp_i8t.cu",
                    "replaces": "booster_tpu/ops/pallas_qmm.py:1172", "max_abs_err": err,
                    "ms": timed(lambda: tm.qmm_mlp_i8t(x, gu, dn), trials=3),
                    "warm_ms": timed(lambda: tm.qmm_mlp_i8t(x, gu, dn), trials=3, cold=False),
                    "plain_ms": timed(lambda: tm.qmm_mlp_plain(x, gu, dn), reps=3, trials=3),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "library": "none: no one torch call (gate-up, SiLU·mul, down)",
                    "launches_note": "on no path (no Q6_K llama with ff a multiple of 256)",
                    "check": CHECKS["mlp"] + "; equal to qmm_i8t (dq) + silu·mul + qmm_i8t (dq)"})
                del x, got, g, want
        del gu, dn
        torch.cuda.empty_cache()


def _gemma7b_kernels(entries: list, failures: list) -> None:
    """Gemma-7B's int8 gate-up with the GELU epilogue (qmm_i8t_gelu.cu) on a
    [3072, 2·24576] weight (GEMMA_7B): the tile (dq_kernel, act 1) at
    generate_gemma7b_i8's 256-row prefill and batch_gemma7b_i8's 2048 at
    group 32, and at 2048 rows with mins planes (real Q5_K planes,
    testing.q5k_weight) and at group 16 (on no path); the M = 1 matvec pair
    (i8mv::kGateUpGelu) at group 32, 32 with mins and 16 (parity (r) runs
    the first two at its narrow width; no full-size path reaches it).  Each
    equal to the unfused kernel of its form + gelu·mul bit for bit, within
    the gate-up limit of its plain version per element (or an output of
    one-ulp roundings of g and u: testing.gateup_flips), and each wrong
    kernel 8x past that limit per element: the SiLU epilogue, a group of K
    dropped, the up half read for the gate, the tile's or the matvec's
    wrong kernels (testing.qmm_i8k_mutants, qmm_mv_mutants) and, with
    mins, testing.qmm_mins_mutants.  Then the whole MLP with GELU at M = 1
    and 64 (GEMMA7B_MLP), the 256-lane attention and appends at 16 kv
    heads, G = 1 (GEMMA7B_ATTN)."""
    import dataclasses

    import torch

    from booster_tpu_torch.ops import qmm as tq
    from booster_tpu_torch.quant.qtensor import dequantize
    from booster_tpu_torch.testing import (gateup_flips, q5k_weight, qmm_i8k_mutants,
                                           qmm_mins_mutants, qmm_mv_mutants, without_mins)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    C, ff = GEMMA_7B["hidden"], GEMMA_7B["ff"]
    bf = torch.bfloat16

    def unfused(x, w):  # the unfused kernel of the form, then gelu·mul
        g = tq.qmm_i8t(x, w).to(bf)
        return tq.gelu(g[:, :ff]) * g[:, ff:]

    # (label, group, mins, M, path: None on no path)
    cases = (("g32", 32, False, 256, "generate_gemma7b_i8"),
             ("g32", 32, False, 2048, "batch_gemma7b_i8"),
             ("g32 mins", 32, True, 2048, None), ("g16", 16, False, 2048, None),
             ("g32", 32, False, 1, "parity (r) q8_0"), ("g32 mins", 32, True, 1, "parity (r) q5_k"),
             ("g16", 16, False, 1, None))
    weights = {}
    for label, G, mins, M, path in cases:
        if label not in weights:
            weights[label] = (q5k_weight(2 * ff, C, seed=230, device="cuda") if mins
                              else _stacked_i8t(2, C, 2 * ff, gen, G).at(1))
        w = weights[label]
        r = w.resolved()
        x = torch.randn(M, C, device="cuda", generator=gen).to(bf)
        name = tq.i8t_count_name(True, M == 1, "gelu")
        tag = f"{name} {label} M={M}"
        got = tq.qmm_i8t_gateup(x, w, "gelu")
        want = tq.qmm_gateup_plain(x, w, act="gelu").float()
        gp = tq.qmm_plain(x, w).to(bf)  # the plain sums (the gd form at M = 1)
        tol = 2 ** -7 if M == 1 else 2 ** -5  # CHECKS "gateup" / "gateup_i8"
        limit = tol * want.abs() + 1e-5 * want.abs().max()
        d = (got.float() - want).abs()
        ok = (d <= limit) | gateup_flips(got, gp[:, :ff], gp[:, ff:], "gelu")
        if not (bool(ok.all()) and torch.isfinite(got.float()).all()):
            failures.append(f"{tag}: max err {float(d.max())}, {int((~ok).sum())} outputs past "
                            "the limit and no one-ulp rounding")
        if not torch.equal(got, unfused(x, w)):
            failures.append(f"{tag}: fused != qmm_i8t + gelu·mul")
        del ok
        s = r.scales
        g0 = s.shape[-2] // 2  # a group of K in the middle
        dropped = s.clone()
        dropped[..., g0, :] = 0
        wrong = {"SiLU for GELU": tq.silu(gp[:, :ff]) * gp[:, ff:],
                 "a group of K dropped": tq.qmm_gateup_plain(
                     x, dataclasses.replace(r, scales=dropped), act="gelu"),
                 "the up half read for the gate": tq.qmm_gateup_plain(x, dataclasses.replace(
                     r, qw=torch.cat([r.qw[:, ff:], r.qw[:, ff:]], 1),
                     scales=torch.cat([s[..., ff:], s[..., ff:]], -1)), act="gelu")}
        del dropped
        if M == 1:
            mutants = qmm_mv_mutants(x, r)
        else:
            nst, ks = C // 64, tq.i8k_plan(M, C, 2 * ff)[1]
            mutants = qmm_i8k_mutants(x, r, ((ks - 1) * nst // ks, nst))
        if mins:
            mutants |= qmm_mins_mutants(x, r)
        seen = {}
        for what, m in wrong.items():
            seen[what] = float(((m.float() - want).abs() / limit).max())
        del wrong
        for what, (xm, wm) in mutants.items():
            seen[what] = float(((tq.qmm_gateup_plain(xm, wm, act="gelu").float() - want).abs()
                                / limit).max())
        del mutants
        for what, v in seen.items():
            if v < 8:
                failures.append(f"{tag}: the check cannot see {what} ({v} of the limit)")
        sbytes = r.qw.numel() + 2 * s.numel()
        b_ms, b_by = bound(sbytes + M * C * 2 + M * ff * 2, 2 * M * C * 2 * ff)
        trials = 3 if M > 256 else 5
        row = {
            "name": name, "shape": f"Gemma-7B gateup {label} M={M} K={C} N={2 * ff} G={G}",
            "key": (name, None if path and path.startswith("parity (r)") else (
                (C, 2 * ff) + (() if path else (label,)))),
            "path": path or "batch_gemma7b_i8", "route": "cuda",
            "source": "booster_tpu_torch/csrc/qmm_i8t_gelu.cu",
            "replaces": "booster_tpu/ops/pallas_qmm.py:" + ("873" if M == 1 else "726"),
            "max_abs_err": float(d.max()), "max_err_of_limit": float((d / limit).max()),
            "min_wrong_kernel_of_limit": min(seen.values()),
            "ms": timed(lambda: tq.qmm_i8t_gateup(x, w, "gelu"), trials=trials),
            "warm_ms": timed(lambda: tq.qmm_i8t_gateup(x, w, "gelu"), trials=trials, cold=False),
            "silu_ms": timed(lambda: tq.qmm_i8t_gateup(x, w), trials=trials),
            "unfused_ms": timed(lambda: unfused(x, w), trials=trials),
            "plain_ms": timed(lambda: tq.qmm_gateup_plain(x, w, act="gelu"), reps=3, trials=3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": "null: no one torch call (gate-up + GELU·mul)",
            "check": (CHECKS["gateup"] if M == 1 else CHECKS["gateup_i8"])
            + " or one-ulp flips of g and u; equal to qmm_i8t + gelu·mul; wrong kernels "
              "(SiLU, a group dropped) at 8x per element"}
        if mins and M > 1:  # the same kernel without the mins plane; the bf16 product
            wn = without_mins(w)
            row["no_mins_ms"] = timed(lambda: tq.qmm_i8t_gateup(x, wn, "gelu"), trials=trials)
            deq = dequantize(w, bf)
            row["matmul_ms"] = timed(lambda: torch.matmul(x, deq.t()), trials=trials)
            del wn, deq
        if path is None:
            row["launches_note"] = "on no path (no full-size file gives this form)"
        elif M == 1:
            row["launches_note"] = ("launched at parity (r)'s narrow width (K 512, ff 512); no "
                                    "full-size path reaches the M = 1 form")
        entries.append(row)
        del x, got, want, gp, d, limit
        torch.cuda.empty_cache()
    del weights
    torch.cuda.empty_cache()
    _gemma_mlp_kernels(entries, failures, GEMMA7B_MLP)
    _bf16_attn_kernels(entries, failures, GEMMA7B_ATTN)
    _int8_kernels(entries, failures, GEMMA7B_ATTN)


def _min_term_checks(failures: list) -> dict:
    """The min term alone of the M > 1 tiles with mins, at path shapes: the
    i4t tile on real Q4_K (config 2's qkv at M = 128 and 8192: 64 and 128
    rows a block) and Q2_K planes (the 8B q at 64 and 2048: group 16), the
    int8 tile on real Q5_K (the 1.3B qkv at 16, 64 and 2048: 16, 64 and
    256 rows a block), each on its weight with every nibble or byte at the
    zero point (testing.min_term_weight), so the kernel's output is
    -sum_g xs·f32(bf16 m).  Each output's error against the f64 product, as
    a share of 2^-16 of sum_g |xs_g·m_g| (testing.min_term_reference): the
    kernel's (at most 1), the plain split's with three, two and one bf16
    parts (testing.min_term_alone), and the wrong kernels'
    (testing.qmm_min_term_mutants: the one-part split, the next group's
    mins, the min term dropped; each past 1)."""
    import torch

    from booster_tpu_torch.ops import qmm as tq
    from booster_tpu_torch.testing import (min_term_alone, min_term_reference, min_term_weight,
                                           q2k_weight, q4k_weight, q5k_weight,
                                           qmm_min_term_mutants)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    C8 = LLAMA3_8B["hidden"]
    n8 = C8 + 2 * LLAMA3_8B["kv_heads"] * (C8 // LLAMA3_8B["heads"])
    C1 = DEEPSEEK["hidden"]
    n1 = C1 + 2 * DEEPSEEK["kv_heads"] * (C1 // DEEPSEEK["heads"])
    forms = (("Q4_K qkv", q4k_weight, C8, n8, tq.qmm_i4t, (Q4K_PREFILL_M, Q4K_MAX_SEQ)),
             ("Q2_K q", q2k_weight, C8, C8, tq.qmm_i4t, (64, 64 * BATCH_Q2K_T)),
             ("Q5_K qkv", q5k_weight, C1, n1, tq.qmm_i8t, (16, 64, 2048)))
    out = {}
    for i, (label, make, K, N, kern, ms) in enumerate(forms):
        w = make(N, K, seed=240 + i, device="cuda")
        wz = min_term_weight(w)
        for M in ms:
            x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
            ref, bnd = min_term_reference(x, w)

            def of_bound(y):
                return float(((y.double() - ref).abs() / bnd).max())

            row = {"kernel": of_bound(kern(x, wz))}
            row |= {f"plain_{p}_parts": of_bound(min_term_alone(x, w, p)) for p in (3, 2, 1)}
            row["wrong_kernels"] = {what: of_bound(y)
                                    for what, y in qmm_min_term_mutants(x, w).items()}
            tag = f"min term alone {label} M={M}"
            if not row["kernel"] <= 1:
                failures.append(f"{tag}: {row['kernel']} of the 2^-16 bound")
            for what, v in row["wrong_kernels"].items():
                if not v > 1:
                    failures.append(f"{tag}: the check cannot see {what} ({v})")
            out[f"{label} M={M} K={K} N={N}"] = row
            del x, ref, bnd
        del w, wz
        torch.cuda.empty_cache()
    return out


def _multi_stage_checks(failures: list) -> dict:
    """decode_attn.cu at 256 lanes where a slice spans several stages (few
    slices against lens): Gemma-2B's 64 slots over a 512-row cache (2
    slices; lens 150 and 500) and Gemma-7B's 16 kv heads at B = 1 (8
    slices; lens 2000), bf16 and int8, each held within its limit of the
    plain version and of the CPU mirror (testing.decode_attn_split, run on
    the card): max error over each."""
    import torch

    from booster_tpu_torch.ops import decode_attention as da
    from booster_tpu_torch.testing import decode_attn_case, decode_attn_limit, decode_attn_split

    out = {}
    for quant in (False, True):
        for label, B, Hkv, G, S, lens in (("Gemma-2B B=64", 64, 1, 8, 512, [150, 500] * 32),
                                          ("Gemma-7B B=1", 1, 16, 1, 2048, [2000])):
            nsplit = da.decode_splits(B, Hkv, S, quant, 256)
            args = decode_attn_case(2, B, Hkv, G, S, 256, 256, lens, "cuda", seed=B + Hkv,
                                    quantized=quant)
            got, limit = da.decode_attn(*args), decode_attn_limit(args)
            errs = [(got - ref).abs() for ref in (da.decode_attn_plain(*args),
                                                  decode_attn_split(args, nsplit))]
            name = f"decode_attn{'_i8' if quant else ''}_d256 {label} nsplit={nsplit}"
            if not (torch.isfinite(got).all() and all(bool((d <= limit).all()) for d in errs)):
                failures.append(f"{name}: max err {[float(d.max()) for d in errs]} "
                                "(plain, mirror) past its limit")
            out[name] = {"plain": float(errs[0].max()), "mirror": float(errs[1].max())}
    return out


def _tied_head_row(failures: list, conf: dict = GEMMA_2B) -> dict:
    """Gemma-2B's (or `conf`'s: GEMMA_7B) tied head at one row and at
    batch_gemma's 64: a torch
    product of the bf16 x and the bf16 [256000, 2048] token table with f32
    accumulation and output (models.llama.tied_head; no kernel of the
    port's: the reference leaves it to XLA), timed as the kernel rows are
    and beside its byte bound, held against the f32 product of the same
    operands on the card; and the card's memory it takes beside its output
    (no f32 copy of the table)."""
    import torch

    from booster_tpu_torch.models.llama import tied_head

    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    V, C = conf["vocab_size"], conf["hidden"]
    emb = (torch.randn(V, C, device="cuda", generator=gen) * 0.05).to(torch.bfloat16)
    out = {"shape": f"V={V} C={C}", "source": "torch.mm(x, table.t(), out_dtype=torch.float32)"}
    for M in (1, 64):
        x = torch.randn(M, 1, C, device="cuda", generator=gen).to(torch.bfloat16)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = tied_head(x, emb)
        extra = torch.cuda.max_memory_allocated() - before - got.numel() * 4
        want = x.float().reshape(M, C) @ emb.float().t()
        err = float((got.reshape(M, V) - want).abs().max())
        if err > 1e-5 * float(want.abs().max()) or extra > 64 << 20:
            failures.append(f"tied head M={M}: err {err}, {extra} bytes beside its output")
        b_ms, b_by = bound(V * C * 2 + M * C * 2 + M * V * 4, 2 * M * V * C)
        out[f"M={M}"] = {"ms": timed(lambda: tied_head(x, emb), trials=3),
                         "warm_ms": timed(lambda: tied_head(x, emb), trials=3, cold=False),
                         "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                         "bytes_beside_output": extra}
        del want
    del emb
    torch.cuda.empty_cache()
    return out


def _append_floor() -> dict:
    """The appends' launch floor: csrc/kv_append.cu at its smallest launch,
    one bf16 row of 128 lanes (the per-layer append at B = H = 1), timed as
    the append rows are (tools/timing.py: cold, and warm)."""
    import torch

    from booster_tpu_torch.ops import kv_append as ka

    k = torch.zeros(1, 1, 8, 128, device="cuda", dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    row = torch.ones(1, 1, 1, 128, device="cuda", dtype=torch.bfloat16)
    off = torch.full((1,), 3, dtype=torch.int32, device="cuda")
    return {"launch_floor_ms": timed(lambda: ka.kv_append_layer(k, v, row, row, off)),
            "launch_floor_warm_ms": timed(lambda: ka.kv_append_layer(k, v, row, row, off),
                                          cold=False),
            "launch_floor": "kv_append_layer at one bf16 row (B 1, H 1, D 128)"}


def _bf16_attn_kernels(entries: list, failures: list, lay: dict) -> None:
    """Decode attention and the all-layer append over a bf16 cache at one
    layout (batch 1, the generate paths)."""
    import torch
    import torch.nn.functional as F

    from booster_tpu_torch.ops import decode_attention as da
    from booster_tpu_torch.ops import kv_append as ka
    from booster_tpu_torch.testing import (decode_attn_case, decode_attn_limit,
                                           decode_attn_mutants)

    L, Hkv, G, D, Dc, S = (lay[k] for k in ("L", "Hkv", "G", "D", "Dc", "S1"))
    sfx = "_d256" if Dc == 256 else ""  # the 256-lane forms count under their own names
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # decode attention over layer L - 1 of an [L, 1, Hkv, 1024, Dc] cache with
    # the deferred-append self term, at the generate phase's mean cache
    # length (15-token prompt + 0..127 tokens: 79) and late in a 1024-token
    # context; at the 7B width also over an 8192-row cache at length 8192
    # (config 2's context; 2 layers: the kernel reads one); inputs on which
    # a dropped self term or a column missed or read past the end shows
    # (booster_tpu_torch.testing).  At B = 1 the kernel splits each range
    # over da.decode_splits(1, Hkv, S, False) blocks, merged by the last one
    cases = ([(L, S, n) for n in lay.get("gen_lens", (79, 1000))]
             + ([(2, 8192, 8192)] if lay is MISTRAL_ATTN else []))
    for L, S, lens_v in cases:
        args = decode_attn_case(L, 1, Hkv, G, S, D, Dc, [lens_v], "cuda", seed=lens_v)

        def mutants(a):  # at lens = S no column lies past the end to be read
            return {k: m for k, m in decode_attn_mutants(a).items()
                    if not (k == "column past the end read" and lens_v == S)}
        err, share, seen = _attn_check(f"decode_attn lens={lens_v}", da.decode_attn,
                                       da.decode_attn_plain, args, decode_attn_limit,
                                       mutants, failures)
        reset = _split_replay_check(lambda: da.decode_attn(*args), failures,
                                    f"decode_attn lens={lens_v}")
        ms = timed(lambda: da.decode_attn(*args))
        warm_ms = timed(lambda: da.decode_attn(*args), cold=False)
        plain_ms = timed(lambda: da.decode_attn_plain(*args), reps=5, trials=3)
        q, kc, vc, layer, _, _, _, sk, sv, _ = args
        qs = q[..., :D].reshape(1, Hkv * G, 1, D).contiguous()
        kcat = torch.cat([kc[layer, :, :, :lens_v, :D], sk[:, :, None, :D]], dim=2)
        vcat = torch.cat([vc[layer, :, :, :lens_v, :D], sv[:, :, None, :D]], dim=2)
        try:
            lib_ms = timed(lambda: F.scaled_dot_product_attention(
                qs, kcat, vcat, scale=1.0, enable_gqa=True))
        except TypeError:  # older torch: no enable_gqa — expand the kv heads first
            kx, vx = kcat.repeat_interleave(G, 1), vcat.repeat_interleave(G, 1)
            lib_ms = timed(lambda: F.scaled_dot_product_attention(qs, kx, vx, scale=1.0))

        def attn_bytes(width):  # q, the valid K/V rows, self k/v, out
            return (Hkv * G * width * 2 + 2 * Hkv * lens_v * width * 2
                    + 2 * Hkv * width * 2 + Hkv * G * width * 4)
        # the function needs the head dim D: q's pad lanes are zero and the
        # output's are sliced off; the Dc figure is what the padded layout moves
        b_ms, b_by = bound(attn_bytes(D), 4 * Hkv * G * (lens_v + 1) * D)
        entries.append({
            "name": "decode_attn" + sfx,
            "shape": f"{lay['name']} L={L} B=1 Hkv={Hkv} G={G} S={S} D={D} Dc={Dc} lens={lens_v}",
            "key": ("decode_attn" + sfx, None), "path": lay["gen_path"], "route": "cuda",
            "source": "booster_tpu_torch/csrc/decode_attn.cu",
            "replaces": "booster_tpu/ops/pallas_attention.py:177",
            "max_abs_err": err, "max_err_of_limit": share, "min_wrong_kernel_of_limit": seen,
            "nsplit": da.decode_splits(1, Hkv, S, False, Dc), "split_replays_equal": reset,
            "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_ms_at_Dc": bound(attn_bytes(Dc), 0)[0],
            "library_ms": lib_ms, "check": CHECKS["attention"]})
        del args, kcat, vcat
        torch.cuda.empty_cache()
    L, S = lay["L"], lay["S1"]
    args = decode_attn_case(L, 1, Hkv, G, S, D, Dc, [lay.get("gen_lens", (1000,))[-1]], "cuda",
                            seed=1000)
    kc, vc = args[1], args[2]

    # all-layer append of one token into the same cache
    nk = torch.randn(L, 1, Hkv, D, device="cuda", generator=gen).to(torch.bfloat16)
    nv = torch.randn(L, 1, Hkv, D, device="cuda", generator=gen).to(torch.bfloat16)
    off = torch.tensor([79], dtype=torch.int32, device="cuda")
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    ka.kv_append(k1, v1, nk, nv, off)
    ka.kv_append_plain(k2, v2, nk, nv, off)
    err = max(float((k1.float() - k2.float()).abs().max()),
              float((v1.float() - v2.float()).abs().max()))
    if err != 0.0:
        failures.append(f"kv_append{sfx}: max err {err}")
    ms = timed(lambda: ka.kv_append(k1, v1, nk, nv, off))
    warm_ms = timed(lambda: ka.kv_append(k1, v1, nk, nv, off), cold=False)
    plain_ms = timed(lambda: ka.kv_append_plain(k2, v2, nk, nv, off))
    # yardstick: the same rows written by torch's indexing assignment
    idx = (torch.arange(L, device="cuda")[:, None], torch.zeros(1, 1, dtype=torch.long,
                                                                 device="cuda"),
           torch.arange(Hkv, device="cuda")[None, :], off.long().expand(1, 1))
    nk_pad, nv_pad = F.pad(nk[:, 0], (0, Dc - D)), F.pad(nv[:, 0], (0, Dc - D))
    lib_ms = timed(lambda: (k2.index_put_(idx, nk_pad), v2.index_put_(idx, nv_pad)))
    # the new rows read and written at the head dim D (the pad lanes of the
    # cache are zero already); the Dc figure writes the padded rows
    b_ms, b_by = bound(2 * L * Hkv * 2 * D * 2, 0)
    entries.append({
        "name": "kv_append" + sfx, "shape": f"{lay['name']} L={L} B=1 H={Hkv} S={S} Dc={Dc} d={D}",
        "key": ("kv_append" + sfx, None), "path": lay["gen_path"], "route": "cuda",
        "source": "booster_tpu_torch/csrc/kv_append.cu",
        "replaces": "booster_tpu/ops/pallas_kv.py:246",
        "max_abs_err": err, "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_ms_at_Dc": bound(2 * L * Hkv * (D + Dc) * 2, 0)[0],
        "library_ms": lib_ms, "library": "index_put_ of the padded rows into k and v",
        "check": CHECKS["append"]})
    del args, kc, vc, k1, v1, k2, v2
    torch.cuda.empty_cache()


def _split_replay_check(fn, failures: list, name: str) -> bool:
    """A decode attention call's tickets reset: the output of a CUDA graph
    of the call, replayed three times, equals the eager call's bit for bit
    (the slices merge in slice order, whatever block is last), and the
    ticket buffer is zero after.  True when it holds (or the call does not
    split)."""
    import torch

    from booster_tpu_torch.ops import qmm as tq

    first = fn()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    same = True
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        same = same and torch.equal(out, first)
    tickets = tq._tickets.get(first.device)
    zero = tickets is None or int(tickets.abs().sum()) == 0
    del g, out
    if not (same and zero):
        failures.append(f"{name}: split tickets not reset across graph replays "
                        f"(outputs equal {same}, tickets zero {zero})")
    return same and zero


def _attn_check(name, kern, plain, args, limit_fn, mutants_fn, failures) -> tuple:
    """Kernel against plain version within the per-element limit, and every
    wrong kernel of `mutants_fn` at 8x it or more: (max error, its share of
    the limit, the smallest mutant share)."""
    import torch

    got, want = kern(*args), plain(*args)
    limit = limit_fn(args)
    d = (got - want).abs()
    if not (bool((d <= limit).all()) and torch.isfinite(got).all()):
        failures.append(f"{name}: max err {float(d.max())}, {float((d / limit).max())} of its limit")
    seen_min = None
    for what, margs in mutants_fn(args).items():
        seen = float(((plain(*margs) - want).abs() / limit).max())
        seen_min = seen if seen_min is None else min(seen_min, seen)
        if seen < 8:
            failures.append(f"{name}: the check cannot see {what} ({seen} of the limit)")
    return float(d.max()), float((d / limit).max()), seen_min


def _int8_kernels(entries: list, failures: list, lay: dict) -> None:
    """The batched path's attention kernels at one layout: B = 64 slots over
    a 512-row int8 cache (TinyLlama: 22 layers, 4 kv heads of 8 query heads,
    head dim 64 stored at 128 lanes; 7B: 32 layers, 8 kv heads of 4, head
    dim 128)."""
    import torch
    import torch.nn.functional as F

    from booster_tpu_torch.ops import decode_attention as da
    from booster_tpu_torch.ops import kv_append as ka
    from booster_tpu_torch.ops import prefill_attention as pa
    from booster_tpu_torch.ops.decode_attention import self_row
    from booster_tpu_torch.testing import (decode_attn_case, decode_attn_limit,
                                           decode_attn_mutants, prefill_attn_case,
                                           prefill_attn_limit, prefill_attn_mutants)

    L, B, Hkv, G, D, Dc, S = (lay[k] for k in ("L", "B", "Hkv", "G", "D", "Dc", "S"))
    sfx = "_d256" if Dc == 256 else ""  # the 256-lane forms count under their own names
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def sdpa(q, k, v, mask=None):  # the kv heads expanded to the query heads ahead
        kx, vx = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
        return timed(lambda: F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask,
                                                            scale=1.0))

    # K4: int8 decode attention over layer L - 1, every slot at one length
    # (a short and a long context), the self term live
    for lens_v in lay.get("batch_lens", (30, 500)):
        args = decode_attn_case(L, B, Hkv, G, S, D, Dc, [lens_v] * B, "cuda", seed=lens_v,
                                quantized=True)
        err, share, seen = _attn_check(f"decode_attn_i8 lens={lens_v}", da.decode_attn,
                                       da.decode_attn_plain, args, decode_attn_limit,
                                       decode_attn_mutants, failures)
        ms = timed(lambda: da.decode_attn(*args))
        warm_ms = timed(lambda: da.decode_attn(*args), cold=False)
        plain_ms = timed(lambda: da.decode_attn_plain(*args), reps=3, trials=3)
        q, kc, vc, layer, _, _, _, sk, sv, _, ks, vs = args
        # yardstick: SDPA over a bf16 copy dequantized ahead (the valid rows
        # plus the self row as the cache will hold it)
        kd = torch.cat([(kc[layer, :, :, :lens_v].float() * ks[layer, :, :, :lens_v]),
                        self_row(sk, True)[:, :, None]], 2)[..., :D].to(torch.bfloat16)
        vd = torch.cat([(vc[layer, :, :, :lens_v].float() * vs[layer, :, :, :lens_v]),
                        self_row(sv, True)[:, :, None]], 2)[..., :D].to(torch.bfloat16)
        lib_ms = sdpa(q[..., :D].reshape(B, Hkv * G, 1, D).contiguous(), kd, vd)
        nbytes = (B * Hkv * G * D * 2 + 2 * B * Hkv * lens_v * (D + 4)
                  + 2 * B * Hkv * D * 2 + B * Hkv * G * D * 4)
        b_ms, b_by = bound(nbytes, 4 * B * Hkv * G * (lens_v + 1) * D)
        entries.append({
            "name": "decode_attn_i8" + sfx,
            "shape": f"{lay['name']} L={L} B={B} Hkv={Hkv} G={G} S={S} D={D} Dc={Dc} lens={lens_v}",
            "key": ("decode_attn_i8" + sfx, None), "path": lay["batch_path"], "route": "cuda",
            "source": "booster_tpu_torch/csrc/decode_attn.cu",
            "replaces": "booster_tpu/ops/pallas_attention.py:177",
            "max_abs_err": err, "max_err_of_limit": share, "min_wrong_kernel_of_limit": seen,
            "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "library": "scaled_dot_product_attention over a pre-dequantized bf16 copy",
            "check": CHECKS["attention_i8"]})
        del args, q, kc, vc, sk, sv, ks, vs, kd, vd
        torch.cuda.empty_cache()

    # K5: the quantizing all-layer append of one step, into the same cache
    kc = torch.zeros(L, B, Hkv, S, Dc, dtype=torch.int8, device="cuda")
    ksc = torch.zeros(L, B, Hkv, S, 1, device="cuda")
    nk = (torch.randn(L, B, Hkv, D, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    nv = (torch.randn(L, B, Hkv, D, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    nk[0, 0, 0] = 0  # a zero row
    off = torch.randint(0, S, (B,), dtype=torch.int32, device="cuda", generator=gen)
    out = [(kc.clone(), kc.clone(), ksc.clone(), ksc.clone()) for _ in range(2)]
    ka.kv_append(out[0][0], out[0][1], nk, nv, off, out[0][2], out[0][3])
    ka.kv_append_plain(out[1][0], out[1][1], nk, nv, off, out[1][2], out[1][3])
    exact = all(torch.equal(a, b) for a, b in zip(*out))
    if not exact:
        failures.append(f"kv_append_i8{sfx}: payload or scales differ from the plain version")
    k1, v1, ks1, vs1 = out[0]
    ms = timed(lambda: ka.kv_append(k1, v1, nk, nv, off, ks1, vs1))
    warm_ms = timed(lambda: ka.kv_append(k1, v1, nk, nv, off, ks1, vs1), cold=False)
    plain_ms = timed(lambda: ka.kv_append_plain(k1, v1, nk, nv, off, ks1, vs1))
    # the new rows read, the int8 rows (at the head dim D) and scales written
    b_ms, b_by = bound(2 * L * B * Hkv * D * 2 + 2 * L * B * Hkv * (D + 4), 0)
    entries.append({
        "name": "kv_append_i8" + sfx,
        "shape": f"{lay['name']} L={L} B={B} H={Hkv} S={S} Dc={Dc} d={D}",
        "key": ("kv_append_i8" + sfx, None), "path": lay["batch_path"], "route": "cuda",
        "source": "booster_tpu_torch/csrc/kv_append.cu",
        "replaces": "booster_tpu/ops/pallas_kv.py:218",
        "max_abs_err": 0.0 if exact else None, "ms": ms, "warm_ms": warm_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "bound_ms_at_Dc": bound(2 * L * B * Hkv * D * 2 + 2 * L * B * Hkv * (Dc + 4), 0)[0],
        "library_ms": None, "check": CHECKS["append_i8"]})
    del out, k1, v1, ks1, vs1, kc, ksc

    # K6: chunked-prefill attention of a T-row chunk per slot over one layer,
    # at the prompt buckets (the batch phases' prompts take T = 32: two query
    # tiles per (slot, kv head) at G = 8, one at G = 4), each as the first
    # chunk (pos0 = 0) and as a chunk late in the cache; n_valid of 1 to T
    # rows per slot
    rng = torch.Generator().manual_seed(2)
    for T, pos in ((T, pos) for T in lay["prefill_T"] for pos in (0, 200)):
        n_valid = [int(x) for x in torch.randint(1, T + 1, (B,), generator=rng)]
        args = prefill_attn_case(B, Hkv, G, T, S, D, Dc, [pos] * B, n_valid, "cuda", seed=pos)
        err, share, seen = _attn_check(f"prefill_attn_i8 T={T} pos0={pos}", pa.prefill_attn,
                                       pa.prefill_attn_plain, args, prefill_attn_limit,
                                       prefill_attn_mutants, failures)
        ms = timed(lambda: pa.prefill_attn(*args))
        warm_ms = timed(lambda: pa.prefill_attn(*args), cold=False)
        plain_ms = timed(lambda: pa.prefill_attn_plain(*args), reps=3, trials=3)
        q, k, v, ks, vs, p0, lens, win, _ = args
        hi = int(lens.max())
        kd = (k[:, :hi].float() * ks[:, :hi, None])[..., :D].to(torch.bfloat16)
        vd = (v[:, :hi].float() * vs[:, :hi, None])[..., :D].to(torch.bfloat16)
        col = torch.arange(hi, device="cuda")
        qpos = p0[:, None] + torch.arange(T, device="cuda")[None, :]  # [BH, T]
        valid = (col[None, None] <= qpos[..., None]) & (col[None, None] < lens[:, None, None])
        mask = valid.reshape(B, Hkv, 1, T, hi)[:, 0]  # the kv heads of a slot agree
        lib_ms = sdpa(q.reshape(B, Hkv * G, T, Dc)[..., :D].contiguous(),
                      kd.reshape(B, Hkv, hi, D), vd.reshape(B, Hkv, hi, D), mask)
        live_cols = int(torch.minimum(p0 + T, lens).sum())  # columns a block reads
        n_pairs = int(valid.sum()) * G  # (query row, valid column) pairs
        nbytes = B * Hkv * G * T * D * 2 + 2 * live_cols * (D + 4) + B * Hkv * G * T * D * 4
        b_ms, b_by = bound(nbytes, 4 * n_pairs * D)
        entries.append({
            "name": "prefill_attn_i8" + sfx,
            "shape": f"{lay['name']} B={B} Hkv={Hkv} G={G} T={T} S={S} D={D} Dc={Dc} pos0={pos}",
            "key": ("prefill_attn_i8" + sfx, None), "path": lay["batch_path"], "route": "cuda",
            "source": "booster_tpu_torch/csrc/prefill_attn.cu",
            "replaces": "booster_tpu/ops/pallas_attention.py:552",
            "max_abs_err": err, "max_err_of_limit": share, "min_wrong_kernel_of_limit": seen,
            "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "library": "scaled_dot_product_attention with a boolean mask over a "
                       "pre-dequantized bf16 copy",
            "check": CHECKS["prefill"]})
        del args, q, k, v, ks, vs, kd, vd, mask
        torch.cuda.empty_cache()


def _layer_append_kernels(entries: list, failures: list, checks: dict) -> None:
    """The per-layer T = 1 append (csrc/kv_append.cu bt_kv_append_layer, _i8)
    at MPT-7B's two paths: generate's bf16 cache (B 1, 32 heads, S 1024,
    head dim 128) and the batch's int8 cache (B 64, S 512), each also with
    rows of d = 64 < D = 128.  Layer L - 2 of a 2-layer stack (so a layer
    off by one lands on a checked layer), at several offset vectors (0,
    mid-window, S - 1 and past it, where the append clamps): bit-exact with
    the plain version on every row, and each wrong append of
    booster_tpu_torch.testing.kv_append_layer_mutants (the layer off by
    one, the offset not clamped, the row at offset - 1; for int8 the scales
    not written and scale = amax) leaves another cache.  Timed cold at d =
    128 with the launch's byte bound; the bf16 form beside index_put_ of
    the padded rows."""
    import torch

    from booster_tpu_torch.ops import kv_append as ka
    from booster_tpu_torch.testing import kv_append_layer_case, kv_append_layer_check

    L, H, D = 2, 32, 128
    for quant, B, S, path in ((False, 1, 1024, "generate_mpt"), (True, 64, 512, "batch_mpt")):
        name = "kv_append_layer_i8" if quant else "kv_append_layer"
        gen = torch.Generator().manual_seed(B)
        offsets = ([[0], [13], [S - 1], [S + 5]] if B == 1 else
                   [[0, 13, S - 1, S + 5] + torch.randint(0, S, (B - 4,), generator=gen).tolist()])
        seen_all: dict = {}
        exact_all = True
        for d in (D, 64):
            for k, offs in enumerate(offsets):
                args = kv_append_layer_case(L, B, H, S, D, d, offs, "cuda", seed=k + d,
                                            quantized=quant)
                k_all, v_all, lay, nk, nv, off, ks, vs = args
                got = [None if t is None else t.clone() for t in (k_all, v_all, ks, vs)]
                views = [None if t is None else t[lay] for t in got]
                ka.kv_append_layer(views[0], views[1], nk, nv, off, views[2], views[3])
                exact, seen = kv_append_layer_check(args, got)
                exact_all &= exact
                if not exact:
                    failures.append(f"{name} d={d} offsets={offs[:4]}: differs from the plain "
                                    "version")
                for m, ok in seen.items():  # seen by the check as a whole
                    seen_all[m] = seen_all.get(m, False) or ok
                del got, views
        missed = [m for m, ok in seen_all.items() if not ok]
        if missed:
            failures.append(f"{name}: the check does not see the wrong appends {missed}")
        checks[name] = {"wrong_appends_seen": seen_all}
        # timed at d = D on the layer view of the cache, one step's rows
        k_all, v_all, lay, nk, nv, off, ks, vs = kv_append_layer_case(
            L, B, H, S, D, D, offsets[-1], "cuda", quantized=quant)
        kl, vl = k_all[lay], v_all[lay]
        ksl, vsl = (None, None) if ks is None else (ks[lay], vs[lay])
        ms = timed(lambda: ka.kv_append_layer(kl, vl, nk, nv, off, ksl, vsl))
        warm_ms = timed(lambda: ka.kv_append_layer(kl, vl, nk, nv, off, ksl, vsl), cold=False)
        plain_ms = timed(lambda: ka.kv_append_layer_plain(kl, vl, nk, nv, off, ksl, vsl))
        lib_ms = None
        if not quant:  # yardstick: torch's indexing assignment of the padded rows
            idx = (torch.arange(B, device="cuda")[:, None], torch.arange(H, device="cuda")[None],
                   off.long().clamp(0, S - 1)[:, None])
            nk1, nv1 = nk[:, 0], nv[:, 0]  # [B, H, D]: d = D, no pad
            lib_ms = timed(lambda: (kl.index_put_(idx, nk1), vl.index_put_(idx, nv1)))
        rows = B * H  # the new rows read (bf16, d = D) and written (int8 + an f32 scale)
        b_ms, b_by = bound(2 * rows * D * 2 + 2 * rows * (D + 4 if quant else 2 * D), 0)
        entries.append({
            "name": name, "shape": f"MPT-7B B={B} H={H} S={S} D={D} d={D}",
            "key": (name, None), "path": path, "route": "cuda",
            "source": "booster_tpu_torch/csrc/kv_append.cu",
            "replaces": "booster_tpu/ops/pallas_kv.py:" + ("74" if quant else "104"),
            "max_abs_err": 0.0 if exact_all else None,
            "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "library": None if quant else "index_put_ of the rows into the layer's k and v",
            "check": CHECKS["append_i8" if quant else "append"]
            + "; each wrong append of kv_append_layer_mutants differs"})
        del k_all, v_all, ks, vs, kl, vl, ksl, vsl
        torch.cuda.empty_cache()


# the server paths' pool layouts: (kv heads, G, head dim) of a layer, its layers
PAGED_7B = dict(name="7B", L=32, Hkv=8, G=4, D=128, path="server")
PAGED_GEMMA = dict(name="Gemma-2B", L=18, Hkv=1, G=8, D=256, path="server_gemma")


def _paged_kernels(entries: list, failures: list, checks: dict, lay: dict = PAGED_7B) -> None:
    """Paged decode attention and the paged all-layer append at a server
    path's layout (`lay`): the 7B model's 32 layers of 8 kv heads (G = 4,
    head dim 128) or Gemma-2B's 18 layers of one kv head (G = 8, head dim
    256: the _d256 forms, the four cases of self term and pool type only),
    pages of 256 rows, 64 slots of up to 16 pages (4096 rows).  The
    slots' pages lie scattered over the pool, slots 0-15 share their first
    two pages, and the lengths end mid-page, on a page boundary, at one row
    and at the full 4096 (``booster_tpu_torch.testing.paged_attn_case``).
    Attention over a bf16 and an int8 pool, with and without the self term,
    and with a window and a softcap, each held against its plain version
    within the limit of ``paged_attn_limit`` and against the wrong kernels of
    ``paged_attn_mutants`` at 8x it; the append bit for bit against its plain
    version on every page but the scratch page 0.  The untimed cases'
    results go to `checks`."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from booster_tpu_torch.ops import kv_append as ka
    from booster_tpu_torch.ops import paged_attention as pa
    from booster_tpu_torch.ops.decode_attention import self_row
    from booster_tpu_torch.ops.paged_kv import gather_layer, paged_append_all_layers
    from booster_tpu_torch.testing import (paged_attn_case, paged_attn_limit,
                                           paged_attn_mutants)

    L, Hkv, G, D, P, B, MAXP = lay["L"], lay["Hkv"], lay["G"], lay["D"], 256, 64, 16
    sfx, where = ("_d256" if D == 256 else ""), lay["name"]
    rng = np.random.default_rng(4)
    lens = ([600 + 53 * i for i in range(16)]  # the slots that share two pages
            + [1, 256, 512, 4096, 300, 255, 257, 1000, 2047, 700, 128, 2, 3000, 768, 511, 1025]
            + [int(x) for x in rng.integers(1, MAXP * P + 1, B - 32)])
    # and the lengths of the server phase's decode: 56 slots 630-740 long
    # that share their first two pages (one system message), 8 short ones
    server_lens = [630 + 2 * i for i in range(56)] + [20 + 20 * i for i in range(8)]
    src = "booster_tpu_torch/csrc/decode_attn.cu"
    cases = (("int8 self", lens, 16, True, True, 0, 0.0),
             ("bf16 self", lens, 16, False, True, 0, 0.0),
             ("int8 self server lengths", server_lens, 56, True, True, 0, 0.0),
             ("int8 no-self", lens, 16, True, False, 0, 0.0),
             ("bf16 no-self", lens, 16, False, False, 0, 0.0),
             ("int8 window 300 softcap 30", lens, 16, True, True, 300, 30.0))
    if D == 256:
        cases = cases[:2] + cases[3:5]
    for label, lens, shared, quant, with_self, win, softcap in cases:
        args = paged_attn_case(L, B, Hkv, G, P, MAXP, D, D, lens, "cuda", seed=5, quantized=quant,
                               shared=shared, win=win, softcap=softcap)
        if not with_self:
            args = (*args[:8], None, None, None, *args[11:])
        name = ("paged_attn_i8" if quant else "paged_attn") + sfx

        def limit(a):
            if a[8] is None:  # no self term: the limit of the case with it dropped
                return paged_attn_limit((*a[:8], torch.zeros_like(q_self), torch.zeros_like(q_self),
                                         torch.zeros_like(ok0), *a[11:]))
            return paged_attn_limit(a)

        q_self = torch.zeros(B, Hkv, D, dtype=torch.bfloat16, device="cuda")
        ok0 = torch.zeros(B, dtype=torch.int32, device="cuda")
        err, share, seen = _attn_check(f"{name} {label}", pa.paged_attn, pa.paged_attn_plain,
                                       args, limit, paged_attn_mutants, failures)
        if "no-self" in label or "window" in label:  # the path's forms are timed
            checks[f"{name} {label}"] = {"max_abs_err": err, "max_err_of_limit": share,
                                         "min_wrong_kernel_of_limit": seen}
            del args
            continue
        ms = timed(lambda: pa.paged_attn(*args))
        warm_ms = timed(lambda: pa.paged_attn(*args), cold=False)
        plain_ms = timed(lambda: pa.paged_attn_plain(*args), reps=3, trials=3)
        q, kc, vc, table, layer, lens_t, _, _, sk, sv, _, *scales = args
        # yardstick: SDPA over the gathered bf16 (dequantized) K/V of the
        # layer and the self row, the invalid columns masked
        hi = max(lens) + 1

        def view(pool):  # the layer's slot-dense view and one more column
            return F.pad(gather_layer(pool[layer], table).float(), (0, 0, 0, 1))[:, :, :hi]

        kd, vd = view(kc), view(vc)
        if quant:
            kd, vd = kd * view(scales[0]), vd * view(scales[1])
        col = torch.arange(hi, device="cuda")
        kd[torch.arange(B), :, lens_t.long()] = self_row(sk, quant)
        vd[torch.arange(B), :, lens_t.long()] = self_row(sv, quant)
        mask = (col[None] <= lens_t[:, None])[:, None, None, :]
        kx = kd[..., :D].to(torch.bfloat16).repeat_interleave(G, 1)
        vx = vd[..., :D].to(torch.bfloat16).repeat_interleave(G, 1)
        qs = q[..., :D].reshape(B, Hkv * G, 1, D).contiguous()
        del kd, vd
        lib_ms = timed(lambda: F.scaled_dot_product_attention(qs, kx, vx, attn_mask=mask,
                                                              scale=1.0))
        cols = sum(lens)  # every cache column is valid (no window)
        # the bytes: each distinct (page, row) that a slot's valid columns
        # map read once, though slots that share a page each attend over it
        j = torch.arange(MAXP * P, device="cuda")
        pool_rows = table.long()[:, j // P] * P + j % P
        rows = int(torch.unique(pool_rows[j[None] < lens_t[:, None]]).numel())
        per_col = 2 * D * (1 if quant else 2) + (8 if quant else 0)
        other = B * Hkv * G * D * 2 + 2 * B * Hkv * D * 2 + B * Hkv * G * D * 4
        b_ms, b_by = bound(other + Hkv * rows * per_col, 4 * Hkv * G * (cols + B) * D)
        per_slot_ms, _ = bound(other + Hkv * cols * per_col, 0)
        entries.append({
            "name": name, "shape": f"{where} L={L} B={B} Hkv={Hkv} G={G} P={P} MAXP={MAXP} "
                                   f"D={D} {label} cols={cols} distinct_rows={rows}",
            "key": (name, None), "path": lay["path"], "route": "cuda", "source": src,
            "replaces": "booster_tpu/ops/pallas_paged_attention.py:348",
            "max_abs_err": err, "max_err_of_limit": share, "min_wrong_kernel_of_limit": seen,
            "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_note": "bytes of each distinct pool row read once; "
                                            "operations per slot",
            "bound_ms_rows_per_slot": per_slot_ms,
            "library_ms": lib_ms,
            "library": "scaled_dot_product_attention with a boolean mask over the gathered, "
                       "dequantized bf16 K/V",
            "check": CHECKS["paged_attention"]})
        del args, q, kc, vc, table, kx, vx, qs, mask, scales
        torch.cuda.empty_cache()

    # the paged all-layer append of one step: each slot's target page lies
    # scattered in the pool, offsets on a page boundary, mid-page, on a
    # page's last row, and one past the table (to the scratch page 0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    Np = 1 + B
    target = torch.from_numpy(1 + rng.permutation(B)).to("cuda", torch.int32)
    off = torch.tensor([P * (b % MAXP) + (0, 137, P - 1, 5)[b % 4] for b in range(B)],
                       dtype=torch.int32, device="cuda")
    off[B - 1] = MAXP * P + 5
    table = torch.zeros(B, MAXP, dtype=torch.int32, device="cuda")
    table[torch.arange(B), (off.long() // P).clamp_max(MAXP - 1)] = target
    nk = (torch.randn(L, B, Hkv, D, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    nv = (torch.randn(L, B, Hkv, D, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    nk[0, 0, 0] = 0  # a zero row
    for quant in (False, True):
        dt = torch.int8 if quant else torch.bfloat16
        pools = [[torch.zeros(L, Np, Hkv, P, D, dtype=dt, device="cuda") for _ in range(2)]
                 + ([torch.zeros(L, Np, Hkv, P, 1, device="cuda") for _ in range(2)] if quant
                    else [None, None]) for _ in range(2)]
        ka.kv_append_all_layers_paged(pools[0][0], pools[0][1], nk, nv, off, table,
                                      pools[0][2], pools[0][3])
        paged_append_all_layers(pools[1][0], pools[1][1], nk, nv, off, table, pools[1][2],
                                pools[1][3])
        exact = all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(*pools) if a is not None)
        wrote = bool(pools[0][0][:, 1:].abs().sum() > 0)
        name = ("kv_append_paged_i8" if quant else "kv_append_paged") + sfx
        if not (exact and wrote):
            failures.append(f"{name}: differs from the plain version off the scratch page")
        k1, v1, ks1, vs1 = pools[0]
        ms = timed(lambda: ka.kv_append_all_layers_paged(k1, v1, nk, nv, off, table, ks1, vs1))
        warm_ms = timed(lambda: ka.kv_append_all_layers_paged(k1, v1, nk, nv, off, table, ks1,
                                                              vs1), cold=False)
        k2, v2, ks2, vs2 = pools[1]
        plain_ms = timed(lambda: paged_append_all_layers(k2, v2, nk, nv, off, table, ks2, vs2))
        lib_ms = None
        if not quant:  # yardstick: torch's indexing assignment of the same rows
            lp = off.long() // P
            page = torch.where(lp < MAXP, table.long()[torch.arange(B), lp.clamp_max(MAXP - 1)], 0)
            o = torch.where(lp < MAXP, off.long() % P, 0)
            idx = (torch.arange(L, device="cuda")[:, None, None], page[None, :, None],
                   torch.arange(Hkv, device="cuda")[None, None, :], o[None, :, None])
            lib_ms = timed(lambda: (k2.index_put_(idx, nk), v2.index_put_(idx, nv)))
        rows = L * B * Hkv
        b_ms, b_by = bound(2 * rows * D * 2 + 2 * rows * (D + 4 if quant else 2 * D), 0)
        entries.append({
            "name": name, "shape": f"{where} L={L} B={B} H={Hkv} P={P} MAXP={MAXP} d={D}",
            "key": (name, None), "path": lay["path"], "route": "cuda",
            "source": "booster_tpu_torch/csrc/kv_append.cu",
            "replaces": "booster_tpu/ops/pallas_kv.py:" + ("415" if quant else "447"),
            "max_abs_err": 0.0 if exact else None, "ms": ms, "warm_ms": warm_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library": "index_put_ of the rows into the pool's k and v" if not quant else None,
            "check": CHECKS["append_i8" if quant else "append"] + " (page 0 excluded)"})
        del pools, k1, v1, ks1, vs1, k2, v2, ks2, vs2
        torch.cuda.empty_cache()


def _stacked_i8t(L, K, N, gen, group=32):
    """A random stacked i8t weight [L, K, N] (Q8_0's form: int8 payload, one
    bf16 scale plane [L, 1, K/32, N]; Q6_K's at group 16), made on the
    card."""
    import torch

    from booster_tpu_torch.gguf import GGMLType
    from booster_tpu_torch.quant.qtensor import QTensor

    qw = torch.randint(-127, 128, (L, K, N), dtype=torch.int8, device="cuda", generator=gen)
    s = torch.rand((L, 1, K // group, N), device="cuda", generator=gen) * 2e-3 + 1e-4
    return QTensor("i8t", qw, s.to(torch.bfloat16), None, group, (N, K),
                   GGMLType.Q6_K if group == 16 else GGMLType.Q8_0)


def _i8t_kernels(entries: list, failures: list) -> None:
    """The Q8_0 kernels at config 3's shapes (hidden 4096, ff 14336, 32 heads
    over 8 kv heads of 128, vocab 32000): K7's group-dot form at M = 1 (qkv,
    wo, lm head: generate_q8's decode; and TinyLlama's qkv 2048 → 2560, wo
    and lm head 2048 → 32000: generate_i8's), its dequant form at M = 64
    (the same: batch_q8's decode) and at M = 2048 (qkv, wo, down: batch_q8's
    prefill), K8 at M = 2048 and K9 at M = 1, 16 and 64, on layer 31 of
    32-layer stacks.  The M = 1 rows must repeat bit for bit on a second
    launch.  K8 must equal K7-dq + silu·mul and K9 must equal the gate-up
    (K7-dq, then silu·mul; K8 itself where M > 1) followed by K7-dq, bit for
    bit."""
    import dataclasses

    import torch

    from booster_tpu_torch.ops import mlp as tm
    from booster_tpu_torch.ops import qmm as tq
    from booster_tpu_torch.quant.qtensor import dequantize
    from booster_tpu_torch.testing import qmm_i8k_mutants, qmm_mv_mutants
    from booster_tpu_torch.tools.mlp_sched import unfused as mlp_unfused

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    C, ff, V = MISTRAL7B["hidden"], MISTRAL7B["ff"], MISTRAL7B["vocab_size"]
    nqkv = C + 2 * MISTRAL7B["kv_heads"] * (C // MISTRAL7B["heads"])
    gu, down = _stacked_i8t(32, C, 2 * ff, gen), _stacked_i8t(32, ff, C, gen)
    weights = {"qkv": _stacked_i8t(2, C, nqkv, gen).at(1), "wo": _stacked_i8t(2, C, C, gen).at(1),
               "lm_head": _stacked_i8t(1, C, V, gen).at(0).resolved(), "down": down.at(31),
               "gateup": gu.at(31)}
    src = "booster_tpu_torch/csrc/qmm_i8t.cu"
    bf = torch.bfloat16

    def x_of(M, K):
        return torch.randn(M, K, device="cuda", generator=gen).to(bf)

    def sbytes(K, N):  # payload and bf16 scales
        return K * N + (K // 32) * N * 2

    def last_split(M, K, N):  # stages of 64 rows that the launch's last K split covers
        nst = K // 64
        ks = tq.i8k_plan(M, K, N)[1]
        return (ks - 1) * nst // ks, nst

    def mutants(x, w):  # the M = 1 matvec's splits and chunks, or the M > 1 tile's
        if x.shape[0] == 1:
            return qmm_mv_mutants(x, w)
        return qmm_i8k_mutants(x, w, last_split(x.shape[0], w.shape[1], w.shape[0]))

    # generate_i8's matvecs: TinyLlama's qkv, wo and lm head widened to Q8_0
    tiny = {"TinyLlama qkv": _stacked_i8t(2, 2048, 2560, gen).at(1),
            "TinyLlama wo": _stacked_i8t(2, 2048, 2048, gen).at(1),
            "TinyLlama lm_head": _stacked_i8t(1, 2048, 32000, gen).at(0).resolved()}
    # K7: the matmul, group-dot at M = 1, dequant (tensor cores) above; the
    # M = 16 rows (generate_q8's prefill) timed with fewer repeats
    for M, labels, path in ((1, ("qkv", "wo", "lm_head"), "generate_q8"),
                            (1, tuple(tiny), "generate_i8"),
                            (16, ("qkv", "wo"), "generate_q8"),
                            (64, ("qkv", "wo", "lm_head"), "batch_q8"),
                            (2048, ("qkv", "wo", "down"), "batch_q8")):
        trials = 3 if M == 16 else 5
        for label in labels:
            w = tiny[label] if label in tiny else weights[label]
            N, K = w.shape
            x = x_of(M, K)
            got, want = tq.qmm_i8t(x, w), tq.qmm_plain(x, w)
            d = (got - want).abs()
            limit = 2e-4 * float(want.abs().max())
            name = "qmm_i8t_gd" if M == 1 else "qmm_i8t_dq"
            if not (d.max() <= limit and torch.isfinite(got).all()):
                failures.append(f"{name} {label} M={M}: max err {float(d.max())}")
            if M == 1 and not torch.equal(got, tq.qmm_i8t(x, w)):
                failures.append(f"{name} {label} M={M}: a second launch differs")
            seen = {what: float((tq.qmm_plain(xm, wm) - want).abs().max()) / limit
                    for what, (xm, wm) in mutants(x, w).items()}
            for what, v in seen.items():
                if v < 8:
                    failures.append(f"{name} {label} M={M}: the check cannot see {what} ({v})")
            deq = dequantize(w, bf)
            b_ms, b_by = bound(sbytes(K, N) + M * K * 2 + M * N * 4, 2 * M * K * N)
            entries.append({
                "name": name, "shape": (label if label in tiny else f"7B {label}")
                + f" M={M} K={K} N={N}",
                "key": (name, (K, N)), "path": path, "route": "cuda", "source": src,
                "replaces": "booster_tpu/ops/pallas_qmm.py:" + ("361" if M == 1 else "432"),
                "host_us": host_us(lambda: tq.qmm_i8t(x, w), reps=50 if M == 16 else 200),
                "max_abs_err": float(d.max()), "min_wrong_kernel_of_limit": min(seen.values()),
                "ms": timed(lambda: tq.qmm_i8t(x, w), trials=trials),
                "warm_ms": timed(lambda: tq.qmm_i8t(x, w), trials=trials, cold=False),
                "plain_ms": timed(lambda: tq.qmm_plain(x, w), reps=3, trials=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timed(lambda: torch.matmul(x, deq.t()), trials=trials),
                "library": "torch.matmul on the dequantized bf16 weight",
                "check": CHECKS["qmm"] + "; wrong kernels at 8x"})
            del x, got, want, d, deq
    del tiny
    torch.cuda.empty_cache()

    # K8: the fused gate-up at the batch prefill's M = 2048
    w = weights["gateup"]
    M, K = 2048, C
    x = x_of(M, K)
    got, want = tq.qmm_i8t_gateup(x, w), tq.qmm_gateup_plain(x, w)
    d = (got.float() - want.float()).abs()
    scale = want.float().abs() + 1e-5 * 2 ** 5 * want.float().abs().max()
    if not bool((d <= 2 ** -5 * scale).all()):
        failures.append(f"qmm_i8t_gateup_dq: max err {float(d.max())}, "
                        f"{float((d / scale).max() * 2 ** 5)} of its limit, "
                        f"{int((d > 2 ** -7 * scale).sum())} outputs over 2^-7")
    gf = tq.qmm_i8t(x, w)  # the unfused sums: within qmm's limit of the plain ones
    e = float((gf - tq.qmm_plain(x, w)).abs().max())
    if not e <= 2e-4 * float(gf.abs().max()):
        failures.append(f"qmm_i8t_dq gateup M={M}: max err {e}")
    g = gf.to(bf)
    if not torch.equal(got, tq.silu(g[:, :ff]) * g[:, ff:]):
        failures.append("qmm_i8t_gateup_dq: fused != qmm_i8t (dq) + silu·mul")
    wr = w.resolved()
    wrong = {what: tq.qmm_gateup_plain(xm, wm)
             for what, (xm, wm) in qmm_i8k_mutants(x, wr, last_split(M, K, 2 * ff)).items()}
    wrong["the up half read for the gate"] = tq.qmm_gateup_plain(x, dataclasses.replace(
        wr, qw=torch.cat([wr.qw[:, ff:], wr.qw[:, ff:]], 1),
        scales=torch.cat([wr.scales[..., ff:], wr.scales[..., ff:]], -1)))
    seen = {what: float(((m.float() - want.float()).abs() / scale).max() * 2 ** 5)
            for what, m in wrong.items()}
    del wrong
    for what, v in seen.items():
        if v < 8:
            failures.append(f"qmm_i8t_gateup_dq M={M}: the check cannot see {what} ({v})")
    b_ms, b_by = bound(sbytes(K, 2 * ff) + M * K * 2 + M * ff * 2, 2 * M * K * 2 * ff)
    entries.append({
        "name": "qmm_i8t_gateup_dq", "shape": f"7B gateup M={M} K={K} N={2 * ff}",
        "key": ("qmm_i8t_gateup_dq", (K, 2 * ff)), "path": "batch_q8", "route": "cuda",
        "source": src, "replaces": "booster_tpu/ops/pallas_qmm.py:726",
        "max_abs_err": float(d.max()), "min_wrong_kernel_of_limit": min(seen.values()),
        "ms": timed(lambda: tq.qmm_i8t_gateup(x, w)),
        "warm_ms": timed(lambda: tq.qmm_i8t_gateup(x, w), cold=False),
        "plain_ms": timed(lambda: tq.qmm_gateup_plain(x, w), reps=3, trials=3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "check": CHECKS["gateup_i8"] + "; equal to qmm_i8t (dq) + silu·mul; wrong kernels at 8x"})
    del x, got, want, d, g, gf, scale
    torch.cuda.empty_cache()

    # K9: the whole MLP at the decode and single-stream prefill shapes
    wg, wd = weights["gateup"], weights["down"]
    for M, path in ((1, "generate_q8"), (16, "generate_q8"), (64, "batch_q8")):
        x = x_of(M, C)
        got, want = tm.qmm_mlp_i8t(x, wg, wd), tm.qmm_mlp_plain(x, wg, wd)
        d = (got.float() - want.float()).abs()
        if not bool(d.max() <= 2 ** -7 * want.float().abs().max()):
            failures.append(f"mlp_i8t M={M}: max err {float(d.max())}")
        g = tq.qmm_i8t(x, wg, dq=True).to(bf)
        mid = tq.silu(g[:, :ff]) * g[:, ff:]
        if M > 1 and not torch.equal(mid, tq.qmm_i8t_gateup(x, wg)):
            failures.append(f"qmm_i8t_gateup_dq M={M}: fused != qmm_i8t (dq) + silu·mul")
        if not torch.equal(got, tq.qmm_i8t(mid, wd, dq=True).to(bf)):
            failures.append(f"mlp_i8t M={M}: != gate-up + silu·mul + qmm_i8t (dq)")
        torch.cuda.synchronize()
        if int(tq._tickets[x.device].abs().sum()):
            failures.append(f"mlp_i8t M={M}: its workspace is not zero after the launch")
        b_ms, b_by = bound(sbytes(C, 2 * ff) + sbytes(ff, C) + M * C * 2 + M * C * 2,
                           2 * M * C * 2 * ff + 2 * M * ff * C)
        entries.append({
            "name": "mlp_i8t", "shape": f"7B mlp M={M} K={C} ff={ff} C={C}",
            "key": ("mlp_i8t", (C, C)), "path": path, "route": "cuda",
            "source": "booster_tpu_torch/csrc/mlp_i8t.cu",
            "replaces": "booster_tpu/ops/pallas_qmm.py:1172",
            "host_us": host_us(lambda: tm.qmm_mlp_i8t(x, wg, wd)),
            "max_abs_err": float(d.max()), "ms": timed(lambda: tm.qmm_mlp_i8t(x, wg, wd)),
            "warm_ms": timed(lambda: tm.qmm_mlp_i8t(x, wg, wd), cold=False),
            "plain_ms": timed(lambda: tm.qmm_mlp_plain(x, wg, wd), reps=3, trials=3),
            "unfused_ms": timed(lambda: mlp_unfused(x, wg, wd)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "check": CHECKS["mlp"] + "; equal to the gate-up + qmm_i8t (dq); workspace zero"})
        del x, got, want, d, g, mid
    del weights, gu, down, wg, wd, w
    torch.cuda.empty_cache()


def _stacked_i8c(L, K, N, gen):
    """A random stacked i8c weight [L, K, N] (int8 payload, f32 channel
    scales [L, 1, N]), made on the card."""
    import torch

    from booster_tpu_torch.gguf import GGMLType
    from booster_tpu_torch.quant.qtensor import QTensor

    qw = torch.randint(-127, 128, (L, K, N), dtype=torch.int8, device="cuda", generator=gen)
    s = torch.rand((L, 1, N), device="cuda", generator=gen) * 2e-3 + 1e-4
    return QTensor("i8c", qw, s, None, K, (N, K), GGMLType.Q8_0)


def _i8c_kernels(entries: list, failures: list) -> None:
    """The per-channel int8 matmul (csrc/qmm_i8c.cu) at the 7B shapes of
    weights="i8c" (qkv 4096 → 6144, wo 4096 → 4096, gate-up 4096 → 28672,
    down 14336 → 4096: layer 1 of 2-layer stacks, through the layer view;
    the lm head 4096 → 32000, 2-D): the streaming matvec at M = 1
    (generate_i8c's decode), the tensor-core form at M = 64 (batch_i8c's
    decode and the lm head of its prefill) and M = 2048 (batch_i8c's
    prefill).  Each is held against its plain version within 2e-4 of the
    largest output, and every wrong kernel (the rescale dropped, a
    neighbour column's scale, the layer off by one, the payload read
    N-major; at M = 1 the matvec's last split (or last warp's chunks) and
    one chunk dropped, above K rows [0, 256)) must move the plain output past 8x that
    limit; a second launch must repeat the first bit for bit."""
    import dataclasses

    import torch

    from booster_tpu_torch.ops import qmm as tq
    from booster_tpu_torch.quant.qtensor import dequantize
    from booster_tpu_torch.testing import qmm_mv_mutants

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    C, ff, V = MISTRAL7B["hidden"], MISTRAL7B["ff"], MISTRAL7B["vocab_size"]
    nqkv = C + 2 * MISTRAL7B["kv_heads"] * (C // MISTRAL7B["heads"])
    stacks = {"qkv": _stacked_i8c(2, C, nqkv, gen), "wo": _stacked_i8c(2, C, C, gen),
              "gateup": _stacked_i8c(2, C, 2 * ff, gen), "down": _stacked_i8c(2, ff, C, gen)}
    weights = {k: v.at(1) for k, v in stacks.items()}
    weights["lm_head"] = _stacked_i8c(1, C, V, gen).at(0).resolved()
    src = "booster_tpu_torch/csrc/qmm_i8c.cu"

    def mutants(label, w):
        w2 = w.resolved()
        N, K = w2.shape
        out = {"rescale dropped": dataclasses.replace(w2, scales=torch.ones_like(w2.scales)),
               "a neighbour column's scale": dataclasses.replace(
                   w2, scales=torch.roll(w2.scales, 1, -1)),
               "payload read N-major": dataclasses.replace(
                   w2, qw=w2.qw.reshape(N, K).t().contiguous())}
        if label != "lm_head":
            out["layer off by one"] = stacks[label].at(0)
        return out

    for M, labels, path in ((1, ("qkv", "wo", "gateup", "down", "lm_head"), "generate_i8c"),
                            (16, ("qkv", "wo"), "generate_i8c"),
                            (64, ("qkv", "wo", "gateup", "down", "lm_head"), "batch_i8c"),
                            (2048, ("qkv", "wo", "gateup", "down"), "batch_i8c")):
        trials = 3 if M == 16 else 5
        for label in labels:
            w = weights[label]
            N, K = w.shape
            x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
            got, want = tq.qmm_i8c(x, w), tq.qmm_i8c_plain(x, w)
            limit = 2e-4 * float(want.abs().max())
            err = float((got - want).abs().max())
            name = "qmm_i8c_mv" if M == 1 else "qmm_i8c_mm"
            if not (err <= limit and torch.isfinite(got).all()):
                failures.append(f"{name} {label} M={M}: max err {err} over {limit}")
            if not torch.equal(got, tq.qmm_i8c(x, w)):
                failures.append(f"{name} {label} M={M}: a second launch differs")
            seen = {what: float((tq.qmm_i8c_plain(x, m) - want).abs().max()) / limit
                    for what, m in mutants(label, w).items()}
            if M == 1:  # a split's or a chunk's sum missing (csrc/i8mv.cuh)
                for what, (xm, wm) in qmm_mv_mutants(x, w).items():
                    seen[what] = float((tq.qmm_i8c_plain(xm, wm) - want).abs().max()) / limit
            else:
                x0 = x.clone()
                x0[:, :256] = 0  # the partial sum of the first rows missing
                seen["K rows [0, 256) dropped"] = float(
                    (tq.qmm_i8c_plain(x0, w) - want).abs().max()) / limit
            for what, v in seen.items():
                if v < 8:
                    failures.append(f"{name} {label} M={M}: the check cannot see {what} "
                                    f"({v} of the limit)")
            deq = dequantize(w, torch.bfloat16)
            b_ms, b_by = bound(N * K + 2 * M * K + 4 * M * N + 4 * N, 2 * M * N * K)
            entries.append({
                "name": name, "shape": f"7B {label} M={M} K={K} N={N}",
                "key": (name, (K, N)), "path": path, "route": "cuda", "source": src,
                "replaces": "booster_tpu/ops/pallas_qmm.py:1451",
                "host_us": host_us(lambda: tq.qmm_i8c(x, w), reps=50 if M == 16 else 200),
                "max_abs_err": err, "min_wrong_kernel_of_limit": min(seen.values()),
                "ms": timed(lambda: tq.qmm_i8c(x, w), trials=trials),
                "warm_ms": timed(lambda: tq.qmm_i8c(x, w), trials=trials, cold=False),
                "plain_ms": timed(lambda: tq.qmm_i8c_plain(x, w), reps=3, trials=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timed(lambda: torch.matmul(x, deq.t()), trials=trials),
                "library": "torch.matmul on the dequantized bf16 weight",
                "check": CHECKS["qmm"]})
            del x, got, want, deq
        torch.cuda.empty_cache()
    del stacks, weights
    torch.cuda.empty_cache()


def _q6k_kernels(entries: list, failures: list) -> None:
    """The Q6_K slice's matmuls at the DeepSeek-Coder-1.3B shape (hidden
    2048, 16 heads over 16 kv heads of 128, ff 5504, vocab 32256): the i8t
    kernels at group 16 (the matvec at M = 1 on qkv 2048 → 6144, wo and the
    lm head, and the lm head of llama.cpp's Q4_0 files, 2048 → 32000; the
    dequant matmul at M = 64 and 2048; the gate-up at M = 64 and 2048), the
    new M = 1 fused gate-up (_gateup_i8_gd_kernel) at (K 2048, ff 5504, G
    16), at the 7B's (4096, 14336, G 32) and with a mins plane, and the
    lane-major i8 matmul of the Q8_0 ffn_down (5504 → 2048, G 32) at M = 1,
    64 and 2048.  Matmuls within 2e-4 of the largest output of their plain
    version, gate-ups per element within bf16 rounding of it and equal to
    the unfused kernels + silu·mul bit for bit; every wrong kernel (a
    neighbour group's scale, the group read as the other one, the mins
    dropped, the up half read for the gate, silu left out) past 8x the
    limit."""
    import dataclasses

    import torch

    from booster_tpu_torch.gguf import GGMLType
    from booster_tpu_torch.ops import qmm as tq
    from booster_tpu_torch.quant.qtensor import QTensor, dequantize
    from booster_tpu_torch.testing import qmm_lane_i8_mutants, qmm_mv_mutants

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    C, ff, V = DEEPSEEK["hidden"], DEEPSEEK["ff"], DEEPSEEK["vocab_size"]
    nqkv = C + 2 * DEEPSEEK["kv_heads"] * (C // DEEPSEEK["heads"])
    src = "booster_tpu_torch/csrc/qmm_i8t.cu"
    bf = torch.bfloat16

    def i8t(L, K, N, G, mins=False):
        """A random stacked i8t weight (Q6_K's codes -32..31), layer L - 1's
        view; with `mins` a mins plane of the scales' size times the codes'."""
        qw = torch.randint(-32, 32, (L, K, N), dtype=torch.int8, device="cuda", generator=gen)
        s = torch.rand((L, 2 if mins else 1, K // G, N), device="cuda", generator=gen) * 2e-3
        s[:, 0] += 1e-4
        if mins:
            s[:, 1] *= 16
        return QTensor("i8t", qw, s.to(bf), None, G, (N, K), GGMLType.Q6_K).at(L - 1)

    def regrouped(w):  # the group read as the other one
        w = w.resolved()
        K, s = w.shape[1], w.scales
        if w.group == 16:
            return "group 16 read as 32", dataclasses.replace(
                w, group=32, scales=s[:, :K // 32].contiguous())
        return "group 32 read as 16", dataclasses.replace(
            w, group=16, scales=torch.cat([s, torch.zeros_like(s)], -2))

    def qmm_mutants(w):
        r = w.resolved()
        label, wg = regrouped(w)
        return {"a neighbour group's scale": dataclasses.replace(
            r, scales=torch.roll(r.scales, 1, -2)), label: wg}

    def sbytes(w):  # payload and bf16 planes
        r = w.resolved()
        return r.qw.numel() + 2 * r.scales.numel()

    def qmm_entry(name, label, w, M, path, replaces):
        N, K = w.shape
        x = torch.randn(M, K, device="cuda", generator=gen).to(bf)
        got, want = tq.qmm_i8t(x, w), tq.qmm_plain(x, w)
        limit = 2e-4 * float(want.abs().max())
        err = float((got - want).abs().max())
        if not (err <= limit and torch.isfinite(got).all()):
            failures.append(f"{name} G16 {label} M={M}: max err {err} over {limit}")
        if M == 1 and not torch.equal(got, tq.qmm_i8t(x, w)):
            failures.append(f"{name} G16 {label} M={M}: a second launch differs")
        seen = {what: float((tq.qmm_plain(x, m) - want).abs().max()) / limit
                for what, m in qmm_mutants(w).items()}
        if M == 1:  # the matvec's last split and one chunk dropped (csrc/i8mv.cuh)
            seen |= {what: float((tq.qmm_plain(xm, wm) - want).abs().max()) / limit
                     for what, (xm, wm) in qmm_mv_mutants(x, w).items()}
        for what, v in seen.items():
            if v < 8:
                failures.append(f"{name} G16 {label} M={M}: the check cannot see {what} ({v})")
        deq = dequantize(w, bf)
        b_ms, b_by = bound(sbytes(w) + M * K * 2 + M * N * 4, 2 * M * K * N)
        entries.append({
            "name": name, "shape": f"{label} M={M} K={K} N={N} G=16",
            "key": (name, (K, N)), "path": path, "route": "cuda", "source": src,
            "replaces": replaces, "host_us": host_us(lambda: tq.qmm_i8t(x, w)),
            "max_abs_err": err, "min_wrong_kernel_of_limit": min(seen.values()),
            "ms": timed(lambda: tq.qmm_i8t(x, w)),
            "warm_ms": timed(lambda: tq.qmm_i8t(x, w), cold=False),
            "plain_ms": timed(lambda: tq.qmm_plain(x, w), reps=3, trials=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timed(lambda: torch.matmul(x, deq.t())),
            "library": "torch.matmul on the dequantized bf16 weight", "check": CHECKS["qmm"]})
        del x, got, want, deq

    # the group-16 matmuls of the 1.3B model's paths (and the 2048 → 32000 lm
    # head of llama.cpp's Q4_0 files, whose output.weight is Q6_K)
    weights = {"qkv": i8t(2, C, nqkv, 16), "wo": i8t(2, C, C, 16), "lm_head": i8t(1, C, V, 16),
               "lm_head 32000": i8t(1, C, 32000, 16)}
    for M, labels, path in ((1, ("qkv", "wo", "lm_head", "lm_head 32000"), "generate_q6k"),
                            (64, ("qkv", "wo", "lm_head"), "batch_q6k"),
                            (2048, ("qkv", "wo"), "batch_q6k")):
        for label in labels:
            name = "qmm_i8t_gd" if M == 1 else "qmm_i8t_dq"
            qmm_entry(name, f"1.3B {label}", weights[label], M, path,
                      "booster_tpu/ops/pallas_qmm.py:" + ("361" if M == 1 else "432"))
    del weights
    torch.cuda.empty_cache()

    def gu_plain_mutants(w, x, f):
        """Outputs of the plain gate-up that wrong kernels would give."""
        r = w.resolved()
        s, q = r.scales, r.qw
        out = {}
        for what, m in qmm_mutants(w).items():
            out[what] = tq.qmm_gateup_plain(x, m)
        if s.shape[0] == 2:
            out["mins dropped"] = tq.qmm_gateup_plain(x, dataclasses.replace(
                r, scales=s[:1].contiguous()))
        out["the up half read for the gate"] = tq.qmm_gateup_plain(x, dataclasses.replace(
            r, qw=torch.cat([q[:, f:], q[:, f:]], 1), scales=torch.cat([s[..., f:], s[..., f:]], -1)))
        gu = tq.qmm_plain(x, r).to(bf)
        out["silu left out"] = gu[:, :f] * gu[:, f:]
        return out

    # the fused gate-up: M = 1 (the new kernel) and the dequant form above
    cases = (("1.3B gateup", C, ff, 16, False, 1, "generate_q6k"),
             ("7B gateup", MISTRAL7B["hidden"], MISTRAL7B["ff"], 32, False, 1, "generate_q6k"),
             ("1.3B gateup, synthetic mins plane", C, ff, 16, True, 1, "generate_q6k"),
             ("1.3B gateup", C, ff, 16, False, 64, "batch_q6k"),
             ("1.3B gateup", C, ff, 16, False, 2048, "batch_q6k"))
    for label, K, f, G, mins, M, path in cases:
        w = i8t(2, K, 2 * f, G, mins)
        x = torch.randn(M, K, device="cuda", generator=gen).to(bf)
        name = "qmm_i8t_gateup_gd" if M == 1 else "qmm_i8t_gateup_dq"
        got, want = tq.qmm_i8t_gateup(x, w), tq.qmm_gateup_plain(x, w)
        tol = 2 ** -7 if M == 1 else 2 ** -5  # CHECKS "gateup" / "gateup_i8"
        limit = tol * want.float().abs() + 1e-5 * want.float().abs().max()
        d = (got.float() - want.float()).abs()
        if not (bool((d <= limit).all()) and torch.isfinite(got.float()).all()):
            failures.append(f"{name} {label} M={M}: max err {float(d.max())}, "
                            f"{float((d / limit).max())} of its limit")
        gu = tq.qmm_i8t(x, w).to(bf)  # the unfused kernel of the same form
        if not torch.equal(got, tq.silu(gu[:, :f]) * gu[:, f:]):
            failures.append(f"{name} {label} M={M}: fused != qmm_i8t + silu·mul")
        e = float((tq.qmm_i8t(x, w) - tq.qmm_plain(x, w)).abs().max())
        if not e <= 2e-4 * float(gu.float().abs().max()):
            failures.append(f"qmm_i8t {label} M={M}: the unfused sums' max err {e}")
        seen = {what: float(((m.float() - want.float()).abs() / limit).max())
                for what, m in gu_plain_mutants(w, x, f).items()}
        for what, v in seen.items():
            if v < 8:
                failures.append(f"{name} {label} M={M}: the check cannot see {what} ({v})")
        b_ms, b_by = bound(sbytes(w) + M * K * 2 + M * f * 2, 2 * M * K * 2 * f)
        entries.append({
            "name": name, "shape": f"{label} M={M} K={K} N={2 * f} G={G}",
            # the mins form runs on no path: a key no launch counts under
            "key": (name, (K, 2 * f) + (("mins",) if mins else ())), "path": path,
            "route": "cuda", "source": src,
            "replaces": "booster_tpu/ops/pallas_qmm.py:" + ("873" if M == 1 else "726"),
            "host_us": host_us(lambda: tq.qmm_i8t_gateup(x, w)),
            "max_abs_err": float(d.max()), "max_err_of_limit": float((d / limit).max()),
            "min_wrong_kernel_of_limit": min(seen.values()),
            "ms": timed(lambda: tq.qmm_i8t_gateup(x, w)),
            "warm_ms": timed(lambda: tq.qmm_i8t_gateup(x, w), cold=False),
            "unfused_ms": timed(lambda: tq.qmm_i8t(x, w)),
            "plain_ms": timed(lambda: tq.qmm_gateup_plain(x, w), reps=3, trials=3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": "null: no one torch call (gate-up + SiLU·mul)",
            "check": (CHECKS["gateup"] if M == 1 else CHECKS["gateup_i8"])
            + "; equal to qmm_i8t + silu·mul; wrong kernels at 8x"})
        del w, x, got, want, gu, d, limit
        torch.cuda.empty_cache()

    # the lane-major i8 matmul of the Q8_0 ffn_down (its K/G = 172 is not a
    # multiple of 8, so it stays lane-major in both packages)
    w = _lane_weight("i8", C, ff, gen)
    deq = dequantize(w, bf)
    for M, path in ((1, "generate_q6k"), (64, "batch_q6k"), (2048, "batch_q6k")):
        x = torch.randn(M, ff, device="cuda", generator=gen).to(bf)
        got, want = tq.qmm_lane(x, w), tq.qmm_lane_plain(x, w)
        limit = 2e-4 * float(want.abs().max())
        err = float((got - want).abs().max())
        if not (err <= limit and torch.isfinite(got).all()):
            failures.append(f"qmm_i8 1.3B down M={M}: max err {err} over {limit}")
        plan = tq.lane_i8_plan(M, ff, C)
        seen = {what: float((tq.qmm_lane_plain(xm, wm) - want).abs().max()) / limit
                for what, (xm, wm) in qmm_lane_i8_mutants(x, w, plan).items()}
        for what, v in seen.items():
            if v < 8:
                failures.append(f"qmm_i8 1.3B down M={M}: the check cannot see {what} ({v})")
        b_ms, b_by = bound(C * ff + C * (ff // 32) * 2 + M * ff * 2 + M * C * 4, 2 * M * C * ff)
        entries.append({
            "name": "qmm_i8", "shape": f"1.3B down M={M} K={ff} N={C} G=32",
            "key": (tq.lane_i8_count_name(plan), (ff, C)), "path": path, "route": "cuda",
            "source": "booster_tpu_torch/csrc/qmm_lane_i8.cu", "form": list(plan),
            "replaces": "booster_tpu/ops/pallas_qmm.py:135",
            "max_abs_err": err, "min_wrong_kernel_of_limit": min(seen.values()),
            "ms": timed(lambda: tq.qmm_lane(x, w)),
            "warm_ms": timed(lambda: tq.qmm_lane(x, w), cold=False),
            "plain_ms": timed(lambda: tq.qmm_lane_plain(x, w), reps=3, trials=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timed(lambda: torch.matmul(x, deq.t())),
            "library": "torch.matmul on the dequantized bf16 weight", "check": CHECKS["qmm"]})
        del x, got, want
    del w, deq
    torch.cuda.empty_cache()


def _lane_weight(kind, R, K, gen):
    """A random lane-major weight [R, K] made on the card: Q4_0's i4p (u8
    payload [R, K/2], zero point 8, bf16 scale planes [R, 2, K/64]) or
    Q8_0's i8 (int8 [R, K], planes [R, 1, K/32])."""
    import torch

    from booster_tpu_torch.gguf import GGMLType
    from booster_tpu_torch.quant.qtensor import QTensor

    if kind == "i4p":
        qw = torch.randint(0, 256, (R, K // 2), dtype=torch.uint8, device="cuda", generator=gen)
        s = torch.rand((R, 2, K // 64), device="cuda", generator=gen) * 0.02 + 1e-3
        return QTensor("i4p", qw, s.to(torch.bfloat16), None, 32, (R, K), GGMLType.Q4_0, zero=8)
    qw = torch.randint(-127, 128, (R, K), dtype=torch.int8, device="cuda", generator=gen)
    s = torch.rand((R, 1, K // 32), device="cuda", generator=gen) * 2e-3 + 1e-4
    return QTensor("i8", qw, s.to(torch.bfloat16), None, 32, (R, K), GGMLType.Q8_0)


def _lane_split_stages(M, K, N, kind, E=0):
    """(stages [s0, s1), columns a stage) that the last K split of
    qmm_lane.cu's launch covers (ops.qmm.lane_plan; all of K in one stage
    in a tree without it, whose kernel did not split K)."""
    from booster_tpu_torch.ops import qmm as tq

    plan = getattr(tq, "lane_plan", None)
    if plan is None:
        return (0, 1), K
    bm, ks = plan(M, K, N, E)
    sk = tq.lane_stage(bm, kind)
    nst = K // sk
    return ((ks - 1) * nst // ks, nst), sk


def timed_eager(fn, reps: int = 3) -> float:
    """Device ms per call between CUDA events, without a graph (for plain
    versions that read back from the card) and without an L2 scrub."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _grouped_yardstick(xp, wd, start, used):
    """One PyTorch call computing the grouped matmul on the same inputs:
    torch._grouped_mm over the pre-dequantized bf16 stack [E, Ne, K] with
    route_pad's group offsets, where the installed torch has it and takes
    these operands; else the per-expert torch.matmul calls, summed.
    Returns (ms, what)."""
    import torch

    x = xp[:used]
    offs = start[1:].contiguous()
    refused = []
    for b in (wd.transpose(1, 2), wd.transpose(1, 2).contiguous()):
        try:
            torch._grouped_mm(x, b, offs=offs)
            torch.cuda.synchronize()
            return (timed(lambda: torch._grouped_mm(x, b, offs=offs)),
                    "torch._grouped_mm over the dequantized bf16 stack")
        except Exception as e:  # noqa: BLE001 — the yardstick only
            refused.append(repr(e)[:200])
    bounds = start.tolist()
    pieces = [(xp[a:b], wd[e]) for e, (a, b) in enumerate(zip(bounds, bounds[1:])) if b > a]
    return (timed(lambda: [torch.matmul(a, w.t()) for a, w in pieces]),
            "torch.matmul per expert over the dequantized bf16 stack, summed "
            f"(torch._grouped_mm refused: {refused})")


def _lane_check(failures: list, name, got, want, mutants: dict, plain) -> tuple[float, float]:
    """A lane-major row's check: within 2e-4 of the largest output of its
    plain version, and each wrong kernel (`mutants`: what → the arguments
    of `plain`) 8x past that; (max error, the least wrong kernel's share of
    the limit)."""
    import torch

    limit = 2e-4 * float(want.abs().max())
    err = float((got - want).abs().max())
    if not (err <= limit and torch.isfinite(got).all()):
        failures.append(f"{name}: max err {err} over {limit}")
    seen = {what: float((plain(m) - want).abs().max()) / limit for what, m in mutants.items()}
    for what, v in seen.items():
        if v < 8:
            failures.append(f"{name}: the check cannot see {what} ({v} of the limit)")
    return err, min(seen.values())


def _moe_kernels(entries: list, failures: list) -> None:
    """The grouped expert matmul (csrc/qmm_lane.cu with a tile table), i4p
    and i8, at Mixtral-8x7B's expert shapes (gate and up [8 x 14336, 4096],
    down [8 x 4096, 14336]) under routings of seeded logits: one decode
    token (2 rows), 64 (128 rows) and the 64 x 32 prefill (4096 rows),
    through route_pad as the path runs it; then the plain lane-major form
    (no tile table) at M = 1, 64 and 2048 on the 7B's qkv and down shapes.
    Each is held against its plain version within 2e-4 of the largest
    output, must be exactly zero on the padding tiles it skips, and every
    wrong kernel (the tile table ignored, the expert off by one, the nibble
    halves swapped, a group's scale from its neighbour) must move the
    output past 8x that limit."""
    import torch

    from booster_tpu_torch.ops import moe
    from booster_tpu_torch.ops import qmm as tq
    from booster_tpu_torch.quant.qtensor import dequantize
    from booster_tpu_torch.testing import qmm_lane_i8_mutants, qmm_lane_mutants

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    E, k, C, ff = MIXTRAL["experts"], MIXTRAL["experts_used"], MIXTRAL["hidden"], MIXTRAL["ff"]
    src = "booster_tpu_torch/csrc/qmm_lane.cu"
    routings = (("decode B=1", 1, "generate_moe"), ("decode B=64", 64, "batch_moe"),
                ("prefill 64x32", 64 * 32, "batch_moe"))

    def check(name, got, want, mutants, plain):
        return _lane_check(failures, name, got, want, mutants, plain)

    for kind in ("i4p", "i8"):
        name = f"moe_qmm_{kind}"
        for label, Ne, K in (("gate/up", ff, C), ("down", C, ff)):
            w = _lane_weight(kind, E * Ne, K, gen)
            wd = dequantize(w, torch.bfloat16).reshape(E, Ne, K)
            for rlabel, n_tok, path in routings:
                x = torch.randn(n_tok, K, device="cuda", generator=gen).to(torch.bfloat16)
                logits = torch.randn(n_tok, E, device="cuda", generator=gen)
                topi = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]
                xp, pos, te, used = moe.route_pad(x, topi.to(torch.int32), E)
                got = moe.grouped_qmm(xp, w, te, E, used)
                want = moe.grouped_qmm_plain(xp, w, te, E, used)
                n_used = int(used[0])
                if got[n_used:].any():
                    failures.append(f"{name} {label} {rlabel}: padding tiles not zero")

                def plain(m):  # (x, weight, tile table)
                    return moe.grouped_qmm_plain(*m, E, used)

                stages, sk = _lane_split_stages(xp.shape[0], K, Ne, kind, E)
                mutants = {"tile table ignored": (xp, w, torch.zeros_like(te)),
                           "expert off by one": (xp, w, (te + 1) % E),
                           **{what: (xm, wm, te)
                              for what, (xm, wm) in qmm_lane_mutants(xp, w, stages,
                                                                     sk).items()}}
                err, seen = check(f"{name} {label} {rlabel}", got, want, mutants, plain)
                counts = torch.zeros(E, dtype=torch.int32, device="cuda").index_add_(
                    0, topi.reshape(-1), torch.ones(n_tok * k, dtype=torch.int32, device="cuda"))
                start = torch.cat([torch.zeros(1, dtype=torch.int32, device="cuda"),
                                   torch.cumsum((counts + 31) // 32 * 32, 0, dtype=torch.int32)])
                live = int((counts > 0).sum())  # experts with at least one real row
                w_bytes = Ne * (K // 2 if kind == "i4p" else K) + Ne * (K // 32) * 2
                b_ms, b_by = bound(live * w_bytes + n_used * K * 2 + n_used * Ne * 4,
                                   2 * n_tok * k * Ne * K)
                lib_ms, lib = _grouped_yardstick(xp, wd, start, n_used)
                entries.append({
                    "name": name, "shape": f"Mixtral {label} E={E} Ne={Ne} K={K} {rlabel}: "
                                           f"{n_tok * k} rows of Mp={xp.shape[0]}, "
                                           f"{n_used} in {live} experts' tiles",
                    "key": (name, (K, Ne)), "path": path, "route": "cuda", "source": src,
                    "replaces": "booster_tpu/ops/pallas_moe.py:" + (
                        "113" if kind == "i4p" else "150"),
                    "max_abs_err": err, "min_wrong_kernel_of_limit": seen,
                    "ms": timed(lambda: moe.grouped_qmm(xp, w, te, E, used)),
                    "warm_ms": timed(lambda: moe.grouped_qmm(xp, w, te, E, used), cold=False),
                    "plain_ms": timed_eager(lambda: moe.grouped_qmm_plain(xp, w, te, E, used)),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "bound_note": "payload and scales of each expert a real row routes to, "
                                  "x and out of the tiles that hold real rows; operations of "
                                  "the real rows",
                    "library_ms": lib_ms, "library": lib, "check": CHECKS["qmm"]})
                del x, xp, pos, te, used, got, want
            del w, wd
            torch.cuda.empty_cache()

    # the plain lane-major form on the 7B's shapes (qkv 4096 → 6144, down
    # 14336 → 4096): no Mixtral weight takes it, every one is transposable
    nqkv = C + 2 * MIXTRAL["kv_heads"] * (C // MIXTRAL["heads"])
    for kind in ("i4p", "i8"):
        name = "qmm_i4p" if kind == "i4p" else "qmm_i8"
        for label, N, K in (("qkv", nqkv, C), ("down", C, ff)):
            w = _lane_weight(kind, N, K, gen)
            deq = dequantize(w, torch.bfloat16)
            for M in (1, 64, 2048):
                x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
                got, want = tq.qmm_lane(x, w), tq.qmm_lane_plain(x, w)
                plan = tq.lane_i8_plan(M, K, N) if kind == "i8" else ("lane",)
                if plan[0] != "lane":  # csrc/qmm_lane_i8.cu in the plan's form
                    key, source = tq.lane_i8_count_name(plan), src.replace(".cu", "_i8.cu")
                    mutants = qmm_lane_i8_mutants(x, w, plan)
                else:  # csrc/qmm_lane.cu: the i4p form, and the i8 one where the plan keeps it
                    key, source = name, src
                    mutants = qmm_lane_mutants(x, w, *_lane_split_stages(M, K, N, kind))
                err, seen = check(f"{name} {label} M={M}", got, want, mutants,
                                  lambda m: tq.qmm_lane_plain(*m))
                w_bytes = N * (K // 2 if kind == "i4p" else K) + N * (K // 32) * 2
                b_ms, b_by = bound(w_bytes + M * K * 2 + M * N * 4, 2 * M * N * K)
                entries.append({
                    "name": name, "shape": f"7B {label} M={M} K={K} N={N}",
                    "key": (key, (K, N)), "path": "generate_moe", "route": "cuda",
                    "source": source, "replaces": "booster_tpu/ops/pallas_qmm.py:" + (
                        "225" if kind == "i4p" else "265"),
                    "max_abs_err": err, "min_wrong_kernel_of_limit": seen,
                    "ms": timed(lambda: tq.qmm_lane(x, w)),
                    "warm_ms": timed(lambda: tq.qmm_lane(x, w), cold=False),
                    "plain_ms": timed(lambda: tq.qmm_lane_plain(x, w), reps=3, trials=3),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": timed(lambda: torch.matmul(x, deq.t())),
                    "library": "torch.matmul on the dequantized bf16 weight",
                    "check": CHECKS["qmm"]})
                del x, got, want
            del w, deq
    torch.cuda.empty_cache()


def _q4k_kernels(entries: list, failures: list) -> None:
    """Config 2's i4t rows (qmm_i4t.cu with four planes, zero 0) on real Q4_K
    weights (testing.q4k_weight: random blocks repacked by the port on the
    card, the min term as large as the scaled term) at the Llama-3-8B
    shapes: qkv, wo, down and the fused gate-up at a decode step (M = 1)
    and at the prefill of bench.py's prompt (M = 128), the lm head at M = 1,
    and the qkv at the long prompt's 8192-row prefill; each through
    _i4t_row (the mins dropped and taken with the wrong sign among its wrong
    kernels), counted on generate_q4k's runs."""
    import dataclasses

    import torch

    from booster_tpu_torch.testing import q4k_weight

    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    C, ff, V = LLAMA3_8B["hidden"], LLAMA3_8B["ff"], LLAMA3_8B["vocab_size"]
    nqkv = C + 2 * LLAMA3_8B["kv_heads"] * (C // LLAMA3_8B["heads"])
    rows = (("qkv", C, nqkv, (1, Q4K_PREFILL_M, Q4K_MAX_SEQ)), ("wo", C, C, (1, Q4K_PREFILL_M)),
            ("down", ff, C, (1, Q4K_PREFILL_M)), ("gateup", C, 2 * ff, (1, Q4K_PREFILL_M)),
            ("lm_head", C, V, (1,)))
    for i, (label, K, N, ms) in enumerate(rows):
        w = q4k_weight(N, K, seed=100 + i, device="cuda")
        w = dataclasses.replace(w, qw=w.qw[None], scales=w.scales[None]).at(0)  # a layer view
        for M in ms:
            _i4t_row(entries, failures, f"Llama-3-8B Q4_K {label}", w, M, gen,
                     "generate_q4k_8k" if M == Q4K_MAX_SEQ else "generate_q4k",
                     gateup=label == "gateup", trials=3, mins_on_path=True)
        del w
        torch.cuda.empty_cache()


def _q2k_kernels(entries: list, failures: list) -> None:
    """The Q2_K mix's i4t rows at group 16 (qmm_i4t.cu: i4mv.cuh's matvec
    and gate-up at M = 1, the tile above) on real planes (testing.q2k_weight
    and q3k_weight: random blocks repacked by the port on the card) at the
    Llama-3-8B shapes: Q2_K (four planes, mins) q 4096 → 4096, k 4096 →
    1024 and the fused gate-up 4096 → 2·14336; Q3_K (two planes, zero 4,
    scales of either sign) wo 4096 → 4096 and down 14336 → 4096; each at a
    decode step (M = 1), generate_q2k's 16-row prefill, batch_q2k's 64-row
    step and its 64·BATCH_Q2K_T-row prefill (the tile at 128 rows a block),
    and at the 128-row prefill bucket of config 2, which no Q2_K path runs
    (beside its Q4_K rows at group 32, counted under a key no launch
    takes); and the gate-up's zero-4 form on random Q3_K weights (a Q3_K
    gate/up: the form the kernels take that no path reaches) at M = 1, 64
    and 64·BATCH_Q2K_T.  Each through _i4t_row (the mins dropped or with
    the wrong sign, the zero ignored, a group's scale row from the next
    group, the nibbles swapped, the last split's groups left out, among its
    wrong kernels), counted on generate_q2k's and batch_q2k's runs."""
    import dataclasses

    import torch

    from booster_tpu_torch.testing import q2k_weight, q3k_weight

    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    C, ff = LLAMA3_8B["hidden"], LLAMA3_8B["ff"]
    nkv = LLAMA3_8B["kv_heads"] * (C // LLAMA3_8B["heads"])
    rows = (("Q2_K q", q2k_weight, C, C), ("Q2_K k", q2k_weight, C, nkv),
            ("Q3_K wo", q3k_weight, C, C), ("Q2_K gateup", q2k_weight, C, 2 * ff),
            ("Q3_K down", q3k_weight, ff, C))
    for i, (label, make, K, N) in enumerate(rows):
        w = make(N, K, seed=200 + i, device="cuda")
        w = dataclasses.replace(w, qw=w.qw[None], scales=w.scales[None]).at(0)  # a layer view
        for M in (1, 16, 64, Q4K_PREFILL_M, 64 * BATCH_Q2K_T):
            on_path = M != Q4K_PREFILL_M
            _i4t_row(entries, failures,
                     f"Llama-3-8B {label}" + ("" if on_path else " (no path)"), w, M, gen,
                     "generate_q2k" if M < 64 else "batch_q2k",
                     gateup=label.endswith("gateup"), trials=3, mins_on_path=True,
                     on_path=on_path)
        del w
        torch.cuda.empty_cache()
    w = q3k_weight(2 * ff, C, seed=210, device="cuda")
    for M in (1, 64, 64 * BATCH_Q2K_T):  # a Q3_K gate-up: the zero-4 form, on no path
        _i4t_row(entries, failures, "Llama-3-8B Q3_K gateup (no path)", w, M, gen,
                 "generate_q2k" if M == 1 else "batch_q2k", gateup=True, trials=3)
    del w
    torch.cuda.empty_cache()


def _q4k_lane_kernels(entries: list, failures: list) -> None:
    """The lane-major i4p form with mins (csrc/qmm_lane.cu, the port of
    _qmm_i4_kernel with has_mins) on real Q4_K expert stacks at
    Mixtral-8x7B's width (gate/up [8 x 14336, 4096], down [8 x 4096,
    14336]): grouped under seeded routings of one decode token (2 real
    rows) and of 64 (128), and dense (no tile table) over one expert's rows
    at M = 1.  Within 2e-4 of the largest output of the plain version, zero
    on the skipped padding tiles, and each wrong kernel (the tile table
    ignored, the expert off by one, the nibble halves swapped, a group's
    scale from its neighbour, the mins dropped, the mins with the wrong
    sign, the last K split's partial dropped) 8x past that limit.  The
    grouped rows count their launches on parity (j), the 2-layer Q4_K
    Mixtral; no path runs the dense form."""
    import dataclasses

    import torch

    from booster_tpu_torch.ops import moe
    from booster_tpu_torch.ops import qmm as tq
    from booster_tpu_torch.quant.qtensor import dequantize
    from booster_tpu_torch.testing import q4k_weight, qmm_lane_mutants

    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    E, k, C, ff = MIXTRAL["experts"], MIXTRAL["experts_used"], MIXTRAL["hidden"], MIXTRAL["ff"]
    src = "booster_tpu_torch/csrc/qmm_lane.cu"

    def check(name, got, want, mutants, plain):
        if not {"mins dropped", "mins with the wrong sign"} <= set(mutants):
            failures.append(f"{name}: the mins mutants did not run")
        return _lane_check(failures, name, got, want, mutants, plain)

    for i, (label, Ne, K) in enumerate((("gate/up", ff, C), ("down", C, ff))):
        w = q4k_weight(E * Ne, K, seed=200 + i, device="cuda", kmajor=False)
        wb = (w.qw.numel() + 2 * w.scales.numel()) // E  # payload and planes of an expert
        wd = dequantize(w, torch.bfloat16).reshape(E, Ne, K)
        for rlabel, n_tok in (("decode B=1", 1), ("decode B=64", 64)):
            x = torch.randn(n_tok, K, device="cuda", generator=gen).to(torch.bfloat16)
            logits = torch.randn(n_tok, E, device="cuda", generator=gen)
            topi = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]
            xp, pos, te, used = moe.route_pad(x, topi.to(torch.int32), E)
            got = moe.grouped_qmm(xp, w, te, E, used)
            want = moe.grouped_qmm_plain(xp, w, te, E, used)
            n_used = int(used[0])
            if got[n_used:].any():
                failures.append(f"moe_qmm_i4p Q4_K {label} {rlabel}: padding tiles not zero")

            def plain(m):  # (x, weight, tile table)
                return moe.grouped_qmm_plain(*m, E, used)

            stages, sk = _lane_split_stages(xp.shape[0], K, Ne, "i4p", E)
            mutants = {"tile table ignored": (xp, w, torch.zeros_like(te)),
                       "expert off by one": (xp, w, (te + 1) % E),
                       **{what: (xm, wm, te)
                          for what, (xm, wm) in qmm_lane_mutants(xp, w, stages, sk).items()}}
            err, seen = check(f"moe_qmm_i4p Q4_K {label} {rlabel}", got, want, mutants, plain)
            counts = torch.bincount(topi.reshape(-1), minlength=E)
            start = torch.cat([torch.zeros(1, dtype=torch.int32, device="cuda"),
                               torch.cumsum((counts + 31) // 32 * 32, 0, dtype=torch.int32)])
            live = int((counts > 0).sum())
            b_ms, b_by = bound(live * wb + n_used * K * 2 + n_used * Ne * 4,
                               2 * n_tok * k * Ne * K)
            lib_ms, lib = _grouped_yardstick(xp, wd, start, n_used)
            entries.append({
                "name": "moe_qmm_i4p",
                "shape": f"Mixtral Q4_K {label} E={E} Ne={Ne} K={K} R=4 {rlabel}: "
                         f"{n_tok * k} rows of Mp={xp.shape[0]}, {n_used} in {live} experts' "
                         "tiles",
                "key": ("moe_qmm_i4p", (K, Ne)), "path": "parity (j)", "route": "cuda",
                "source": src, "replaces": "booster_tpu/ops/pallas_qmm.py:96 (has_mins, via "
                                           "booster_tpu/ops/pallas_moe.py:113)",
                "max_abs_err": err, "min_wrong_kernel_of_limit": seen,
                "ms": timed(lambda: moe.grouped_qmm(xp, w, te, E, used)),
                "warm_ms": timed(lambda: moe.grouped_qmm(xp, w, te, E, used), cold=False),
                "plain_ms": timed_eager(lambda: moe.grouped_qmm_plain(xp, w, te, E, used)),
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_note": "payload and four planes of each expert a real row routes to, "
                              "x and out of the tiles that hold real rows; operations of the "
                              "real rows",
                "library_ms": lib_ms, "library": lib, "check": CHECKS["qmm"]})
            del x, xp, pos, te, used, got, want
        # the dense form over expert 0's rows at a decode step
        w0 = dataclasses.replace(w, qw=w.qw[:Ne], scales=w.scales[:Ne], shape=(Ne, K))
        deq = wd[0]
        x = torch.randn(1, K, device="cuda", generator=gen).to(torch.bfloat16)
        got, want = tq.qmm_lane(x, w0), tq.qmm_lane_plain(x, w0)
        err, seen = check(f"qmm_i4p Q4_K {label} M=1", got, want,
                          qmm_lane_mutants(x, w0, *_lane_split_stages(1, K, Ne, "i4p")),
                          lambda m: tq.qmm_lane_plain(*m))
        b_ms, b_by = bound(wb + K * 2 + Ne * 4, 2 * Ne * K)
        entries.append({
            "name": "qmm_i4p", "shape": f"Mixtral Q4_K {label} (one expert) M=1 K={K} N={Ne} R=4",
            "key": ("qmm_i4p", (K, Ne, "mins")), "path": "parity (j)", "route": "cuda",
            "source": src, "replaces": "booster_tpu/ops/pallas_qmm.py:96 (has_mins, via "
                                       "_qmm_i4 :225)",
            "max_abs_err": err, "min_wrong_kernel_of_limit": seen,
            "ms": timed(lambda: tq.qmm_lane(x, w0)),
            "warm_ms": timed(lambda: tq.qmm_lane(x, w0), cold=False),
            "plain_ms": timed(lambda: tq.qmm_lane_plain(x, w0), reps=3, trials=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timed(lambda: torch.matmul(x, deq.t())),
            "library": "torch.matmul on the dequantized bf16 weight", "check": CHECKS["qmm"]})
        del w, w0, wd, deq, x, got, want
        torch.cuda.empty_cache()


def _q5k_kernels(entries: list, failures: list) -> None:
    """llama.cpp's Q5_K_S mix on real planes (testing.q5k_weight and
    q5_1_weight: random blocks repacked by the port on the card; Q5_K's min
    term as large as its scaled term, Q5_1's mins -m near 16·d): at the
    DeepSeek-Coder-1.3B shape the K-major int8 forms with mins (qkv 2048 →
    6144 and wo: the M = 1 matvec, the wgmma tile at 16, 64 and 2048; the
    fused gate-up [2048, 2·5504] likewise) and the lane-major down (Q5_1,
    5504 → 2048) at M = 1, 16, 64 and 2048; the whole MLP with mins on both
    weights at the Llama-3-8B width (ff 14336) at M = 1, 16 and 64; the
    grouped i8 form with mins on Q5_K expert stacks of Mixtral's width at 2
    and 128 real rows.  Each within CHECKS of its plain version, every wrong
    kernel (the form's own mutants, the mins dropped, the mins with the
    wrong sign) 8x past the limit; the gate-up and the MLP equal to their
    unfused kernels bit for bit; each row timed beside the same kernel on
    the same weight with its mins plane dropped (the form without mins:
    no_mins_ms).  The 1.3B rows count their launches on generate_q5k (M = 1,
    16) and batch_q5k (64, 2048), the MLP rows on parity (k) (whose steps
    run M = 1 and 16), the grouped rows under a key no path counts (no
    Q5_K MoE file runs)."""
    import dataclasses

    import torch

    from booster_tpu_torch.ops import mlp as tm
    from booster_tpu_torch.ops import moe
    from booster_tpu_torch.ops import qmm as tq
    from booster_tpu_torch.quant.qtensor import dequantize
    from booster_tpu_torch.testing import (q5_1_weight, q5k_weight, qmm_i8k_mutants,
                                           qmm_lane_i8_mutants, qmm_lane_mutants,
                                           qmm_mins_mutants, qmm_mv_mutants, without_mins)
    from booster_tpu_torch.tools.mlp_sched import unfused as mlp_unfused

    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    bf = torch.bfloat16
    C, ff = DEEPSEEK["hidden"], DEEPSEEK["ff"]
    nqkv = C + 2 * DEEPSEEK["kv_heads"] * (C // DEEPSEEK["heads"])
    src = "booster_tpu_torch/csrc/qmm_i8t.cu"

    def wbytes(w):  # payload and bf16 planes
        r = w.resolved()
        return r.qw.numel() + 2 * r.scales.numel()

    def x_of(M, K):
        return torch.randn(M, K, device="cuda", generator=gen).to(bf)

    def path_of(M):
        return "generate_q5k" if M <= 16 else "batch_q5k"

    def seen_of(name, want, limit, mutants, plain):
        seen = {what: float((plain(*m).float() - want.float()).abs().max()) / limit
                for what, m in mutants.items()}
        if not {"mins dropped", "mins with the wrong sign"} <= set(seen):
            failures.append(f"{name}: the mins mutants did not run")
        for what, v in seen.items():
            if v < 8:
                failures.append(f"{name}: the check cannot see {what} ({v})")
        return min(seen.values())

    # the K-major matmuls: the group-dot matvec at M = 1, the wgmma tile above
    for i, (label, N) in enumerate((("qkv", nqkv), ("wo", C))):
        w = q5k_weight(N, C, seed=300 + i, device="cuda")
        wn = without_mins(w)
        deq = dequantize(w, bf)
        for M in (1, 16, 64, 2048):
            x = x_of(M, C)
            name = "qmm_i8t_gd" if M == 1 else "qmm_i8t_dq"
            tag = f"{name} Q5_K 1.3B {label} M={M}"
            got, want = tq.qmm_i8t(x, w), tq.qmm_plain(x, w)
            limit = 2e-4 * float(want.abs().max())
            err = float((got - want).abs().max())
            if not (err <= limit and torch.isfinite(got).all()):
                failures.append(f"{tag}: max err {err} over {limit}")
            if M == 1 and not torch.equal(got, tq.qmm_i8t(x, w)):
                failures.append(f"{tag}: a second launch differs")
            nst = C // 64
            ks = tq.i8k_plan(M, C, N)[1]
            form = (qmm_mv_mutants(x, w) if M == 1
                    else qmm_i8k_mutants(x, w, ((ks - 1) * nst // ks, nst)))
            seen = seen_of(tag, want, limit, {**form, **qmm_mins_mutants(x, w)}, tq.qmm_plain)
            b_ms, b_by = bound(wbytes(w) + M * C * 2 + M * N * 4, 2 * M * C * N)
            entries.append({
                "name": name, "shape": f"Q5_K 1.3B {label} M={M} K={C} N={N} G=32 mins",
                "key": (name, (C, N)), "path": path_of(M), "route": "cuda", "source": src,
                "replaces": "booster_tpu/ops/pallas_qmm.py:" + ("361" if M == 1 else "432")
                            + " (has_mins)",
                "max_abs_err": err, "min_wrong_kernel_of_limit": seen,
                "ms": timed(lambda: tq.qmm_i8t(x, w), trials=3),
                "warm_ms": timed(lambda: tq.qmm_i8t(x, w), trials=3, cold=False),
                "no_mins_ms": timed(lambda: tq.qmm_i8t(x, wn), trials=3),
                "plain_ms": timed(lambda: tq.qmm_plain(x, w), reps=3, trials=3),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": timed(lambda: torch.matmul(x, deq.t()), trials=3),
                "library": "torch.matmul on the dequantized bf16 weight",
                "check": CHECKS["qmm"] + "; wrong kernels (the mins dropped, with the wrong "
                                         "sign) at 8x"})
            del x, got, want
        del w, wn, deq
    torch.cuda.empty_cache()

    # the fused gate-up: the group-dot form at M = 1, the tile's above
    w = q5k_weight(2 * ff, C, seed=310, device="cuda")
    wn = without_mins(w)
    deq = dequantize(w, bf)
    for M in (1, 16, 64, 2048):
        x = x_of(M, C)
        name = "qmm_i8t_gateup_gd" if M == 1 else "qmm_i8t_gateup_dq"
        tag = f"{name} Q5_K 1.3B gateup M={M}"
        got, want = tq.qmm_i8t_gateup(x, w), tq.qmm_gateup_plain(x, w)
        tol = 2 ** -7 if M == 1 else 2 ** -5  # CHECKS "gateup" / "gateup_i8"
        limit = tol * want.float().abs() + 1e-5 * want.float().abs().max()
        d = (got.float() - want.float()).abs()
        if not (bool((d <= limit).all()) and torch.isfinite(got.float()).all()):
            failures.append(f"{tag}: max err {float(d.max())}, {float((d / limit).max())} of "
                            "its limit")
        gu = tq.qmm_i8t(x, w, dq=M > 1)
        e = float((gu - tq.qmm_plain(x, w, dq=M > 1)).abs().max())
        if not e <= 2e-4 * float(gu.abs().max()):
            failures.append(f"{tag}: the unfused sums' max err {e}")
        gu = gu.to(bf)
        if not torch.equal(got, tq.silu(gu[:, :ff]) * gu[:, ff:]):
            failures.append(f"{tag}: fused != qmm_i8t + silu·mul")
        seen = {what: float(((tq.qmm_gateup_plain(xm, wm, dq=M > 1).float() - want.float()).abs()
                             / limit).max()) for what, (xm, wm) in qmm_mins_mutants(x, w).items()}
        for what, v in seen.items():
            if v < 8:
                failures.append(f"{tag}: the check cannot see {what} ({v})")
        b_ms, b_by = bound(wbytes(w) + M * C * 2 + M * ff * 2, 2 * M * C * 2 * ff)
        entries.append({
            "name": name, "shape": f"Q5_K 1.3B gateup M={M} K={C} N={2 * ff} G=32 mins",
            "key": (name, (C, 2 * ff)), "path": path_of(M), "route": "cuda", "source": src,
            "replaces": "booster_tpu/ops/pallas_qmm.py:" + ("873" if M == 1 else "726")
                        + " (has_mins)",
            "max_abs_err": float(d.max()), "max_err_of_limit": float((d / limit).max()),
            "min_wrong_kernel_of_limit": min(seen.values()),
            "ms": timed(lambda: tq.qmm_i8t_gateup(x, w), trials=3),
            "warm_ms": timed(lambda: tq.qmm_i8t_gateup(x, w), trials=3, cold=False),
            "no_mins_ms": timed(lambda: tq.qmm_i8t_gateup(x, wn), trials=3),
            "matmul_ms": timed(lambda: torch.matmul(x, deq.t()), trials=3) if M > 1 else None,
            "unfused_ms": timed(lambda: tq.qmm_i8t(x, w, dq=M > 1), trials=3),
            "plain_ms": timed(lambda: tq.qmm_gateup_plain(x, w), reps=3, trials=3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": "null: no one torch call (gate-up + SiLU·mul)",
            "check": (CHECKS["gateup"] if M == 1 else CHECKS["gateup_i8"])
            + "; equal to qmm_i8t + silu·mul; the mins mutants at 8x"})
        del x, got, want, gu, d, limit
    del w, wn, deq
    torch.cuda.empty_cache()

    # the lane-major down: Q5_1 (mins -m), 5504 → 2048
    w = q5_1_weight(C, ff, seed=320, device="cuda")
    wn = without_mins(w)
    deq = dequantize(w, bf)
    for M in (1, 16, 64, 2048):
        x = x_of(M, ff)
        tag = f"qmm_i8 Q5_1 1.3B down M={M}"
        plan = tq.lane_i8_plan(M, ff, C)
        got, want = tq.qmm_lane(x, w), tq.qmm_lane_plain(x, w)
        mutants = qmm_lane_i8_mutants(x, w, plan)
        err, seen = _lane_check(failures, tag, got, want, mutants,
                                lambda m: tq.qmm_lane_plain(*m))
        if not {"mins dropped", "mins with the wrong sign",
                "each group's min from the next group"} <= set(mutants):
            failures.append(f"{tag}: the mins mutants did not run")
        # the same form on the weight without its mins plane (the Q8_0 down's form)
        _lane_check(failures, f"{tag} without mins", tq.qmm_lane(x, wn), tq.qmm_lane_plain(x, wn),
                    qmm_lane_i8_mutants(x, wn, plan), lambda m: tq.qmm_lane_plain(*m))
        b_ms, b_by = bound(wbytes(w) + M * ff * 2 + M * C * 4, 2 * M * C * ff)
        entries.append({
            "name": "qmm_i8", "shape": f"Q5_1 1.3B down M={M} K={ff} N={C} G=32 mins",
            "key": (tq.lane_i8_count_name(plan), (ff, C)), "path": path_of(M), "route": "cuda",
            "source": "booster_tpu_torch/csrc/qmm_lane_i8.cu", "form": list(plan),
            "replaces": "booster_tpu/ops/pallas_qmm.py:135 (has_mins, via _qmm_i8 :265)",
            "max_abs_err": err, "min_wrong_kernel_of_limit": seen,
            "ms": timed(lambda: tq.qmm_lane(x, w), trials=3),
            "warm_ms": timed(lambda: tq.qmm_lane(x, w), trials=3, cold=False),
            "no_mins_ms": timed(lambda: tq.qmm_lane(x, wn), trials=3),
            "plain_ms": timed(lambda: tq.qmm_lane_plain(x, w), reps=3, trials=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timed(lambda: torch.matmul(x, deq.t()), trials=3),
            "library": "torch.matmul on the dequantized bf16 weight",
            "check": CHECKS["qmm"] + "; wrong kernels (the mins dropped, with the wrong sign, "
                                     "from the next group among them) at 8x"})
        del x, got, want
    del w, wn, deq
    torch.cuda.empty_cache()

    # the whole MLP with mins on both weights at the Llama-3-8B width
    C8, ff8 = LLAMA3_8B["hidden"], LLAMA3_8B["ff"]
    wg = q5k_weight(2 * ff8, C8, seed=330, device="cuda")
    wd = q5k_weight(C8, ff8, seed=331, device="cuda")
    wgn, wdn = without_mins(wg), without_mins(wd)
    for M in (1, 16, 64):
        x = x_of(M, C8)
        tag = f"mlp_i8t Q5_K 8B M={M}"
        if not tm.mlp_supported(wg, wd, C8, M):
            failures.append(f"{tag}: the reference's gate declines it")
        got, want = tm.qmm_mlp_i8t(x, wg, wd), tm.qmm_mlp_plain(x, wg, wd)
        d = (got.float() - want.float()).abs()
        limit = 2 ** -7 * float(want.float().abs().max())
        if not bool(d.max() <= limit):
            failures.append(f"{tag}: max err {float(d.max())}")
        g = tq.qmm_i8t(x, wg, dq=True).to(bf)
        mid = tq.silu(g[:, :ff8]) * g[:, ff8:]
        if M > 1 and not torch.equal(mid, tq.qmm_i8t_gateup(x, wg)):
            failures.append(f"{tag}: the gate-up != qmm_i8t (dq) + silu·mul")
        if not torch.equal(got, tq.qmm_i8t(mid, wd, dq=True).to(bf)):
            failures.append(f"{tag}: != gate-up + silu·mul + qmm_i8t (dq)")
        torch.cuda.synchronize()
        if int(tq._tickets[x.device].abs().sum()):
            failures.append(f"{tag}: its workspace is not zero after the launch")
        mutants = {f"gate-up: {k}": (xm, wm, wd) for k, (xm, wm) in qmm_mins_mutants(x, wg).items()}
        mutants |= {f"down: {k}": (x, wg, wm) for k, (_, wm) in qmm_mins_mutants(mid, wd).items()}
        seen = {what: float((tm.qmm_mlp_plain(*m).float() - want.float()).abs().max()) / limit
                for what, m in mutants.items()}
        for what, v in seen.items():
            if v < 8:
                failures.append(f"{tag}: the check cannot see {what} ({v})")
        b_ms, b_by = bound(wbytes(wg) + wbytes(wd) + M * C8 * 2 + M * C8 * 2,
                           2 * M * C8 * 2 * ff8 + 2 * M * ff8 * C8)
        entries.append({
            "name": "mlp_i8t", "shape": f"Q5_K 8B mlp M={M} K={C8} ff={ff8} C={C8} mins",
            # parity (k) runs M = 1 and 16; no path runs the 8B mins MLP at 64
            "key": ("mlp_i8t", (C8, C8) + (() if M <= 16 else ("M=64",))),
            "path": "parity (k)",
            "route": "cuda", "source": "booster_tpu_torch/csrc/mlp_i8t.cu",
            "replaces": "booster_tpu/ops/pallas_qmm.py:1172 (has_mins, d_has_mins)",
            "max_abs_err": float(d.max()), "min_wrong_kernel_of_limit": min(seen.values()),
            "ms": timed(lambda: tm.qmm_mlp_i8t(x, wg, wd), trials=3),
            "warm_ms": timed(lambda: tm.qmm_mlp_i8t(x, wg, wd), trials=3, cold=False),
            "no_mins_ms": timed(lambda: tm.qmm_mlp_i8t(x, wgn, wdn), trials=3),
            "unfused_ms": timed(lambda: mlp_unfused(x, wg, wd), trials=3),
            "plain_ms": timed(lambda: tm.qmm_mlp_plain(x, wg, wd), reps=3, trials=3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": "null: no one torch call (gate-up, SiLU·mul, down)",
            "check": CHECKS["mlp"] + "; equal to the gate-up + qmm_i8t (dq); workspace zero; "
                                     "the mins mutants of either weight at 8x"})
        del x, got, want, d, g, mid
    del wg, wd, wgn, wdn
    torch.cuda.empty_cache()

    # the grouped i8 form with mins on Q5_K expert stacks of Mixtral's width
    E, k, CM, ffm = MIXTRAL["experts"], MIXTRAL["experts_used"], MIXTRAL["hidden"], MIXTRAL["ff"]
    for i, (label, Ne, K) in enumerate((("gate/up", ffm, CM), ("down", CM, ffm))):
        w = q5k_weight(E * Ne, K, seed=340 + i, device="cuda", kmajor=False)
        wn = without_mins(w)
        wb = wbytes(w) // E
        wdq = dequantize(w, bf).reshape(E, Ne, K)
        for rlabel, n_tok in (("decode B=1", 1), ("decode B=64", 64)):
            x = x_of(n_tok, K)
            logits = torch.randn(n_tok, E, device="cuda", generator=gen)
            topi = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]
            xp, pos, te, used = moe.route_pad(x, topi.to(torch.int32), E)
            tag = f"moe_qmm_i8 Q5_K {label} {rlabel}"
            got = moe.grouped_qmm(xp, w, te, E, used)
            want = moe.grouped_qmm_plain(xp, w, te, E, used)
            n_used = int(used[0])
            if got[n_used:].any():
                failures.append(f"{tag}: padding tiles not zero")
            stages, sk = _lane_split_stages(xp.shape[0], K, Ne, "i8", E)
            mutants = {"tile table ignored": (xp, w, torch.zeros_like(te)),
                       "expert off by one": (xp, w, (te + 1) % E),
                       **{what: (xm, wm, te)
                          for what, (xm, wm) in qmm_lane_mutants(xp, w, stages, sk).items()}}
            if not {"mins dropped", "mins with the wrong sign"} <= set(mutants):
                failures.append(f"{tag}: the mins mutants did not run")
            err, seen = _lane_check(failures, tag, got, want, mutants,
                                    lambda m: moe.grouped_qmm_plain(*m, E, used))
            counts = torch.bincount(topi.reshape(-1), minlength=E)
            start = torch.cat([torch.zeros(1, dtype=torch.int32, device="cuda"),
                               torch.cumsum((counts + 31) // 32 * 32, 0, dtype=torch.int32)])
            live = int((counts > 0).sum())
            b_ms, b_by = bound(live * wb + n_used * K * 2 + n_used * Ne * 4,
                               2 * n_tok * k * Ne * K)
            lib_ms, lib = _grouped_yardstick(xp, wdq, start, n_used)
            entries.append({
                "name": "moe_qmm_i8",
                "shape": f"Mixtral Q5_K {label} E={E} Ne={Ne} K={K} mins {rlabel}: "
                         f"{n_tok * k} rows of Mp={xp.shape[0]}, {n_used} in {live} experts' "
                         "tiles",
                # no Q5_K MoE file runs on a path: a key no launch counts under
                "key": ("moe_qmm_i8", (K, Ne, "mins")), "path": "batch_moe", "route": "cuda",
                "source": "booster_tpu_torch/csrc/qmm_lane.cu",
                "replaces": "booster_tpu/ops/pallas_moe.py:72 (the i8 branch :150, has_mins)",
                "max_abs_err": err, "min_wrong_kernel_of_limit": seen,
                "ms": timed(lambda: moe.grouped_qmm(xp, w, te, E, used)),
                "warm_ms": timed(lambda: moe.grouped_qmm(xp, w, te, E, used), cold=False),
                "no_mins_ms": timed(lambda: moe.grouped_qmm(xp, wn, te, E, used)),
                "plain_ms": timed_eager(lambda: moe.grouped_qmm_plain(xp, w, te, E, used)),
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_note": "payload and two planes of each expert a real row routes to, "
                              "x and out of the tiles that hold real rows; operations of the "
                              "real rows",
                "library_ms": lib_ms, "library": lib, "check": CHECKS["qmm"]})
            del x, xp, pos, te, used, got, want
        del w, wn, wdq
        torch.cuda.empty_cache()


# -- phase 2b: probes ---------------------------------------------------------

# the JAX tools' Pallas functions: file:line of each kernel body
PROBE_REPLACES = {
    "_read_kernel": "tools/kernel_micro.py:71", "k_sum_i32": "tools/cast_probe.py:82",
    "k_sum_f32": "tools/cast_probe.py:96", "k_sum_bf16": "tools/cast_probe.py:109",
    "k_dot": "tools/cast_probe.py:125", "k_dot_sub": "tools/cast_probe.py:144",
    "k_dot_i8": "tools/cast_probe.py:168", "k_dot_mixed": "tools/cast_probe.py:190",
    "int_mm.kern": "tools/mmq_probe.py:37", "v0_kern": "tools/qmm_gap.py:86",
    "v1_kern": "tools/qmm_gap.py:94", "v2_kern": "tools/qmm_gap.py:107",
    "v3_kern": "tools/qmm_gap.py:120", "v4_kern": "tools/qmm_gap.py:137",
    "v5_kern": "tools/qmm_gap.py:157", "v6_kern": "tools/qmm_gap.py:172",
    "v7_kern": "tools/qmm_gap.py:189", "v_current": "tools/qmm_probe.py:82",
    "v_cast_only": "tools/qmm_probe.py:93", "v_dot_only": "tools/qmm_probe.py:104",
    "v_group_dots": "tools/qmm_probe.py:116",
    "part1.reshape": "tools/expander_probe.py:84", "part1.jrepeat": "tools/expander_probe.py:91",
    "part1.take": "tools/expander_probe.py:97", "part1.ptile": "tools/expander_probe.py:103",
    "part1.dot16": "tools/expander_probe.py:110",
    "make_qmm.dot_f32": "tools/expander_probe.py:167",
    "make_qmm.dot_bf16": "tools/expander_probe.py:174",
    "make_qmm.reshape": "tools/expander_probe.py:182",
    "make_qmm.jrepeat": "tools/expander_probe.py:187",
    "make_qmm.take": "tools/expander_probe.py:190", "make_qmm.ptile": "tools/expander_probe.py:193",
    "make_qmm.noscale": "tools/expander_probe.py:196",
    "make_qmm.castonly": "tools/expander_probe.py:200",
    "make_qmm.gloop": "tools/expander_probe.py:154",
    "tqmm_i8.sub_reshape": "tools/tqmm_probe.py:84", "tqmm_i8.sub_repeat": "tools/tqmm_probe.py:88",
    "tqmm_i8.sub_ptile": "tools/tqmm_probe.py:91", "tqmm_i8.noscale": "tools/tqmm_probe.py:93",
    "tqmm_i4": "tools/tqmm_probe.py:127",
    "make_step.current": "tools/nibble_probe.py:106",
    "make_step.i8mask_sub": "tools/nibble_probe.py:113",
    "make_step.i8mask_affine": "tools/nibble_probe.py:121",
    "check.current": "tools/nibble_probe.py:187", "check.i8mask_sub": "tools/nibble_probe.py:187",
    "check.i8mask_affine": "tools/nibble_probe.py:187",
    "_gd_i4_kernel": "tools/groupdot_probe.py:53", "_gd_i4m_kernel": "tools/groupdot_probe.py:87",
    "_gd_i8_kernel": "tools/groupdot_probe.py:120",
    "_gd_i8_kernel.raw": "tools/groupdot_probe.py:120",
    # rungs that are no Pallas function: the unpacks nibble_probe's main never
    # runs (unpack_i8_shift's sequence and two of the port's), and the serving
    # path's own i4t kernel on a probe's payload
    "unpack.xor88": "tools/nibble_probe.py:142 (no pallas_call from main)",
    "unpack.magic_f32": "tools/nibble_probe.py:106 (the current function)",
    "unpack.magic_bf16": "tools/nibble_probe.py:106 (the current function)",
    "qmm_i4t.dq": "booster_tpu/ops/pallas_qmm.py:469",
    "qmm_i4t.gd": "booster_tpu/ops/pallas_qmm.py:393",
}
# each probe kernel's source
PROBE_SOURCES = {"probe_colsum": "probe_i8.cu", "probe_i8mm": "probe_i8.cu",
                 "probe_s8mm": "probe_i8.cu",
                 "probe_i8mm_group": "probe_i8.cu", "probe_blocksum": "probe_i8.cu",
                 "probe_expand": "probe_i4.cu", "probe_nibble": "probe_i4.cu",
                 "probe_i4mm": "probe_i4.cu", "probe_gd": "probe_i4.cu",
                 "probe_qmm_i4t_dq": "qmm_i4t.cu", "probe_qmm_i4t_gd": "qmm_i4t.cu"}
# the tools the phase runs on the card, with their arguments
PROBE_TOOLS = (("kernel_micro", []), ("cast_probe", []), ("mmq_probe", []),
               ("qmm_gap", ["--variants", "v0,v1,v2,v3,v4,v5,v6,v7"]), ("qmm_probe", []),
               ("qmm_clean", ["--shapes", "1b", "--dense"]), ("expander_probe", []),
               ("tqmm_probe", []), ("nibble_probe", []), ("groupdot_probe", []))


def _probe_inputs(gen):
    """Random draws on the card: ints(*shape) int8 in [-127, 127) (or u8),
    normal(*shape) bf16, scales(*shape) in [0.5, 1.5)."""
    import torch

    def ints(*shape, lo=-127, hi=127, dtype=torch.int8):
        return torch.randint(lo, hi, shape, dtype=dtype, device="cuda", generator=gen)

    def normal(*shape):
        return torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)

    def scales(*shape):
        return (torch.rand(shape, device="cuda", generator=gen) + 0.5).to(torch.bfloat16)

    return ints, normal, scales


_NO_LIB = "no one torch call takes an int8 weight against a bf16 x"
_NO_LIB_GROUP = "no one torch call (per-group i32 dots, each rescaled)"
_NO_LIB_I4 = "no one torch call takes a 4-bit weight"
M_PROBE = 64  # rows of x in every probe tool


def _colsum_cases(gen) -> list:
    """A: kernel_micro's u8 read, cast_probe's three sums over i8."""
    import torch

    from booster_tpu_torch.ops import probes as pr
    from booster_tpu_torch.tools.timing import F32_OPS_PER_S

    ints, _, _ = _probe_inputs(gen)
    cases = []
    for fn, q, mode in (("_read_kernel", ints(11264, 1024, lo=0, hi=255, dtype=torch.uint8),
                         "i32"),
                        ("k_sum_i32", ints(11264, 4096), "i32"),
                        ("k_sum_f32", ints(11264, 4096), "f32"),
                        ("k_sum_bf16", ints(11264, 4096), "bf16")):
        R, C = q.shape
        cases.append(((fn,), f"{mode} {str(q.dtype)[6:]} [{R},{C}]",
                      lambda q=q, mode=mode: pr.colsum(q, mode),
                      lambda q=q, mode=mode: pr.colsum_plain(q, mode), True,
                      {"neighbour column": lambda q=q, mode=mode: torch.roll(
                          pr.colsum_plain(q, mode), 1, 1)},
                      lambda q=q: torch.sum(q, 0, dtype=torch.int32), R * C + 4 * C, R * C,
                      F32_OPS_PER_S, ("probe_colsum",
                                      (f"{mode}.{'u8' if q.dtype == torch.uint8 else 'i8'}",
                                       R, C))))
    return cases


def _cast_cases(gen) -> list:
    """B over cast_probe's N-major [11264, 4096]: the bf16 dots, the s8 one."""
    import torch

    from booster_tpu_torch.ops import probes as pr
    from booster_tpu_torch.tools.timing import BF16_OPS_PER_S, INT8_OPS_PER_S

    ints, normal, _ = _probe_inputs(gen)
    N, K, M = 11264, 4096, M_PROBE
    q = ints(N, K)
    cases = []
    for fns, x, lib in ((("k_dot", "k_dot_sub", "k_dot_mixed"), normal(M, K), _NO_LIB),
                        (("k_dot_i8",), ints(M, K),
                         "no one torch call (the i32 product, then f32)")):
        i8 = x.dtype == torch.int8
        cases.append((fns, f"{'int8' if i8 else 'bf16'} x [{M},{K}] @ q [{N},{K}]^T",
                      lambda x=x: pr.i8mm(x, q, n_major=True),
                      lambda x=x: pr.i8mm_plain(x, q, n_major=True), i8,
                      {"weight read K-major": lambda x=x: pr.i8mm_plain(x, q.view(K, N))},
                      lib, N * K + M * K * (1 if i8 else 2) + 4 * M * N, 2 * M * N * K,
                      INT8_OPS_PER_S if i8 else BF16_OPS_PER_S,
                      ("probe_s8mm" if i8 else "probe_i8mm",
                       (f"{'i8' if i8 else 'bf16'}.n.none", K, N))))
    return cases


def _s8_cases(gen) -> list:
    """E (the s8 kernel) at the probes' small M = 8 and a ragged M = 100, at
    v_dot_only's [11264, 2048] (i32) and k_dot_i8's [11264, 4096] (f32):
    exact, and a kernel that lost a stage of K (its last, testing.s8mm_stages)
    or read the weight K-major must land past 8x the qmm limit."""
    import torch

    from booster_tpu_torch.ops import probes as pr
    from booster_tpu_torch.testing import s8mm_stages
    from booster_tpu_torch.tools.timing import INT8_OPS_PER_S

    ints, _, _ = _probe_inputs(gen)
    N = 11264
    cases = []
    for fn, K, i32 in (("v_dot_only", 2048, True), ("k_dot_i8", 4096, False)):
        q = ints(N, K)
        for M in (8, 100):
            x = ints(M, K)
            cases.append(((fn,), f"int8 x [{M},{K}] @ q [{N},{K}]^T -> {'i32' if i32 else 'f32'}",
                          lambda x=x, q=q, i32=i32: pr.i8mm(x, q, n_major=True, out_i32=i32),
                          lambda x=x, q=q, i32=i32: pr.i8mm_plain(x, q, n_major=True,
                                                                  out_i32=i32), True,
                          {"weight read K-major": lambda x=x, q=q, i32=i32, K=K: pr.i8mm_plain(
                              x, q.view(K, N), out_i32=i32),
                           "a stage of K dropped": lambda x=x, q=q, i32=i32, K=K: s8mm_stages(
                               x, q, i32, drop=K // 128 - 1)},
                          (lambda x=x, q=q: torch._int_mm(x, q.t())) if i32 and M > 16 else
                          "torch._int_mm takes more than 16 rows" if i32 else
                          "no one torch call (the i32 product, then f32)",
                          N * K + M * K + 4 * M * N, 2 * M * N * K, INT8_OPS_PER_S,
                          ("probe_s8mm", (f"i8.n.none{'.i32' if i32 else ''}", K, N))))
    return cases


def _mmq_cases(gen) -> list:
    """B over mmq_probe's K-major 7B shapes: (a) int8 x -> i32, (b) bf16 x."""
    import torch

    from booster_tpu_torch.ops import probes as pr
    from booster_tpu_torch.tools.timing import BF16_OPS_PER_S, INT8_OPS_PER_S

    ints, normal, _ = _probe_inputs(gen)
    M = M_PROBE
    cases = []
    for N, K, label in (6144, 4096, "qkv"), (28672, 4096, "gateup"), (4096, 14336, "down"):
        w = ints(K, N)
        xq, xb = ints(M, K), normal(M, K)
        cases.append((("int_mm.kern",), f"(a) int8 x -> i32, {label} [{K},{N}]",
                      lambda xq=xq, w=w: pr.i8mm(xq, w, out_i32=True),
                      lambda xq=xq, w=w: pr.i8mm_plain(xq, w, out_i32=True), True,
                      {"weight read N-major": lambda xq=xq, w=w, N=N, K=K: pr.i8mm_plain(
                          xq, w.view(N, K), n_major=True, out_i32=True)},
                      lambda xq=xq, w=w: torch._int_mm(xq, w), N * K + M * K + 4 * M * N,
                      2 * M * N * K, INT8_OPS_PER_S, ("probe_i8mm", ("i8.k.none.i32", K, N))))
        cases.append((("int_mm.kern",), f"(b) bf16 x -> f32, {label} [{K},{N}]",
                      lambda xb=xb, w=w: pr.i8mm(xb, w), lambda xb=xb, w=w: pr.i8mm_plain(xb, w),
                      False, {"weight read N-major": lambda xb=xb, w=w, N=N, K=K: pr.i8mm_plain(
                          xb, w.view(N, K), n_major=True)},
                      _NO_LIB, N * K + 2 * M * K + 4 * M * N, 2 * M * N * K, BF16_OPS_PER_S,
                      ("probe_i8mm", ("bf16.k.none", K, N))))
    return cases


def _gap_cases(gen) -> list:
    """qmm_gap's ladder at its defaults (M 64, K = N = 4096, bk 2048)."""
    import torch

    from booster_tpu_torch.ops import probes as pr
    from booster_tpu_torch.tools.timing import BF16_OPS_PER_S, INT8_OPS_PER_S

    ints, normal, scales = _probe_inputs(gen)
    M, N, K, BK = M_PROBE, 4096, 4096, 2048
    w = ints(K, N)
    x, xq = normal(M, K), ints(M, K)
    s_small, s_big = scales(K // 32, N), scales(K, N)
    ng = torch.roll(s_small, 1, 0)  # each group takes its neighbour's scale
    small = s_small.numel() * 2
    base = K * N + 2 * M * K + 4 * M * N
    ops = 2 * M * N * K
    mm, mmp, gm, gmp = pr.i8mm, pr.i8mm_plain, pr.i8mm_group, pr.i8mm_group_plain
    return [
        (("v0_kern", "v1_kern"), f"bf16 x @ w [{K},{N}]", lambda: mm(x, w), lambda: mmp(x, w),
         False, {"weight read N-major": lambda: mmp(x, w.t())}, _NO_LIB, base, ops,
         BF16_OPS_PER_S, ("probe_i8mm", ("bf16.k.none", K, N))),
        (("v2_kern",), f"bf16 x @ bf16(q * S), S bf16 [{K},{N}]",
         lambda: mm(x, w, s=s_big, scale="plane"), lambda: mmp(x, w, s=s_big, scale="plane"),
         False, {"neighbour row's scale": lambda: mmp(x, w, s=torch.roll(s_big, 1, 0),
                                                      scale="plane")},
         _NO_LIB, base + s_big.numel() * 2, ops, BF16_OPS_PER_S,
         ("probe_i8mm", ("bf16.k.plane", K, N))),
        (("v3_kern",), f"bf16 x @ bf16(q * s[k // 32]), s bf16 [{K // 32},{N}]",
         lambda: mm(x, w, s=s_small, scale="group"), lambda: mmp(x, w, s=s_small, scale="group"),
         False, {"neighbour group's scale": lambda: mmp(x, w, s=ng, scale="group")}, _NO_LIB,
         base + small, ops, BF16_OPS_PER_S, ("probe_i8mm", ("bf16.k.group", K, N))),
        (("v4_kern",), "int8 x, groups of 32: i32 dots * s, f32 sum", lambda: gm(xq, w, s_small),
         lambda: gmp(xq, w, s_small), False,
         {"rescale dropped": lambda: gmp(xq, w, torch.ones_like(s_small)),
          "neighbour group's scale": lambda: gmp(xq, w, ng)}, _NO_LIB_GROUP,
         base - M * K + small, ops, INT8_OPS_PER_S, ("probe_i8mm_group", ("i8.k.g32", K, N))),
        (("v5_kern",), f"bf16 x @ bf16(q * s[reordered rows]), bk {BK}",
         lambda: mm(x, w, s=s_small, scale="reorder", bk=BK),
         lambda: mmp(x, w, s=s_small, scale="reorder", bk=BK), False,
         {"read as v3": lambda: mmp(x, w, s=s_small, scale="group")}, _NO_LIB, base + small,
         ops, BF16_OPS_PER_S, ("probe_i8mm", ("bf16.k.reorder", K, N))),
        (("v6_kern",), "bf16 x, groups of 32: f32 dots * s, f32 sum", lambda: gm(x, w, s_small),
         lambda: gmp(x, w, s_small), False,
         {"rescale dropped": lambda: gmp(x, w, torch.ones_like(s_small)),
          "neighbour group's scale": lambda: gmp(x, w, ng)}, _NO_LIB, base + small, ops,
         BF16_OPS_PER_S, ("probe_i8mm_group", ("bf16.k.g32", K, N))),
        (("v7_kern",), "bf16 x, groups of 128 (scale row 4g)",
         lambda: gm(x, w, s_small, group=128), lambda: gmp(x, w, s_small, group=128), False,
         {"groups taken as 32": lambda: gmp(x, w, s_small, group=32)}, _NO_LIB, base + small,
         ops, BF16_OPS_PER_S, ("probe_i8mm_group", ("bf16.k.g128", K, N))),
    ]


def _qmm_probe_cases(gen) -> list:
    """qmm_probe's gate-up shape: N-major [11264, 2048], f32 scales [11264, 64]."""
    import torch

    from booster_tpu_torch.ops import probes as pr
    from booster_tpu_torch.tools.timing import BF16_OPS_PER_S, INT8_OPS_PER_S

    ints, normal, _ = _probe_inputs(gen)
    M, N, K = M_PROBE, 11264, 2048
    q = ints(N, K)
    s = torch.rand(N, K // 32, device="cuda", generator=gen) * 0.01
    sn = torch.roll(s, 1, 1)
    xb, xq = normal(M, K), ints(M, K)
    base = N * K + 4 * M * N
    ops = 2 * M * N * K
    mm, mmp, gm, gmp = pr.i8mm, pr.i8mm_plain, pr.i8mm_group, pr.i8mm_group_plain
    return [
        (("v_current",), "bf16 x @ (bf16(q) * bf16(s expanded))^T",
         lambda: mm(xb, q, n_major=True, s=s, scale="group"),
         lambda: mmp(xb, q, n_major=True, s=s, scale="group"), False,
         {"neighbour group's scale": lambda: mmp(xb, q, n_major=True, s=sn, scale="group")},
         _NO_LIB, base + 2 * M * K + s.numel() * 4, ops, BF16_OPS_PER_S,
         ("probe_i8mm", ("bf16.n.group.f32", K, N))),
        (("v_cast_only",), "bf16 x @ bf16(q)^T", lambda: mm(xb, q, n_major=True),
         lambda: mmp(xb, q, n_major=True), False,
         {"weight read K-major": lambda: mmp(xb, q.view(K, N))}, _NO_LIB, base + 2 * M * K,
         ops, BF16_OPS_PER_S, ("probe_i8mm", ("bf16.n.none", K, N))),
        (("v_dot_only",), "int8 x @ q^T -> i32", lambda: mm(xq, q, n_major=True, out_i32=True),
         lambda: mmp(xq, q, n_major=True, out_i32=True), True,
         {"weight read K-major": lambda: mmp(xq, q.view(K, N), out_i32=True)},
         lambda: torch._int_mm(xq, q.t()), base + M * K, ops, INT8_OPS_PER_S,
         ("probe_s8mm", ("i8.n.none.i32", K, N))),
        (("v_group_dots",), "int8 x, groups of 32: i32 dots * s (f32)",
         lambda: gm(xq, q, s, n_major=True), lambda: gmp(xq, q, s, n_major=True), False,
         {"rescale dropped": lambda: gmp(xq, q, torch.ones_like(s), n_major=True),
          "neighbour group's scale": lambda: gmp(xq, q, sn, n_major=True)}, _NO_LIB_GROUP,
         base + M * K + s.numel() * 4, ops, INT8_OPS_PER_S,
         ("probe_i8mm_group", ("i8.n.g32", K, N))),
    ]


def _expander_cases(gen) -> list:
    """expander_probe: part 1's expansion (s [8, 128] f32 -> [8, 256], g 32)
    and part 2's N-major i8 matvec [4096, 4096] at BM 8, f32 scales."""
    import torch

    from booster_tpu_torch.ops import probes as pr
    from booster_tpu_torch.ops import probes_i4 as p4
    from booster_tpu_torch.tools.timing import BF16_OPS_PER_S, F32_OPS_PER_S

    ints, normal, _ = _probe_inputs(gen)
    BN, SG, g, SUB = 8, 128, 32, 256
    s1 = torch.randn(BN, SG, device="cuda", generator=gen)
    eb, eb_tile = (p4.expand_bytes(BN, SG, g, SUB, tile) for tile in (False, True))
    ex, exp = p4.expand, p4.expand_plain
    cases = [
        (("part1.reshape", "part1.jrepeat", "part1.take"), "repeat [8,128] -> [8,256]",
         lambda: ex(s1, g, SUB), lambda: exp(s1, g, SUB), True,
         {"repeat read as tile": lambda: exp(s1, g, SUB, tile=True)},
         lambda: torch.repeat_interleave(s1[:, :SUB // g], g, dim=1), eb, 0, F32_OPS_PER_S,
         ("probe_expand", ("repeat", BN, SUB))),
        (("part1.ptile",), "tile [8,128] -> [8,256]", lambda: ex(s1, g, SUB, tile=True),
         lambda: exp(s1, g, SUB, tile=True), True,
         {"tile read as repeat": lambda: exp(s1, g, SUB)}, lambda: s1.repeat(1, SUB // SG),
         eb_tile, 0, F32_OPS_PER_S, ("probe_expand", ("tile", BN, SUB))),
        (("part1.dot16",), "repeat of bf16(s)", lambda: ex(s1, g, SUB, bf16=True),
         lambda: exp(s1, g, SUB, bf16=True), True,
         {"repeat read as tile": lambda: exp(s1, g, SUB, tile=True, bf16=True)},
         "no one torch call (the rounding to bf16, then the repeat)", eb, 0, F32_OPS_PER_S,
         ("probe_expand", ("repeat.bf16", BN, SUB))),
    ]
    M, N, K = 8, 4096, 4096
    q = ints(N, K)
    x = normal(M, K)
    s = torch.rand(N, K // 32, device="cuda", generator=gen) * 0.02
    s_t = s.t().contiguous()  # gloop's [K/32, N]
    ng = torch.roll(s, 1, 1)
    base = N * K + 2 * M * K + 4 * M * N
    sb = s.numel() * 4
    ops = 2 * M * N * K
    mm, mmp = pr.i8mm, pr.i8mm_plain
    cases += [
        (("make_qmm.dot_f32", "make_qmm.dot_bf16", "make_qmm.reshape", "make_qmm.jrepeat",
          "make_qmm.take"), f"M {M}: x @ (bf16(q) * bf16(s[n, k // 32]))^T, q [{N},{K}]",
         lambda: mm(x, q, n_major=True, s=s, scale="group"),
         lambda: mmp(x, q, n_major=True, s=s, scale="group"), False,
         {"neighbour group's scale": lambda: mmp(x, q, n_major=True, s=ng, scale="group")},
         _NO_LIB, base + sb, ops, BF16_OPS_PER_S, ("probe_i8mm", ("bf16.n.group.f32", K, N))),
        (("make_qmm.ptile",), f"M {M}: the same with s[n, k % {K // 32}]",
         lambda: mm(x, q, n_major=True, s=s, scale="tile"),
         lambda: mmp(x, q, n_major=True, s=s, scale="tile"), False,
         {"tile read as repeat": lambda: mmp(x, q, n_major=True, s=s, scale="group")}, _NO_LIB,
         base + sb, ops, BF16_OPS_PER_S, ("probe_i8mm", ("bf16.n.tile.f32", K, N))),
        (("make_qmm.noscale",), f"M {M}: x @ bf16(q)^T", lambda: mm(x, q, n_major=True),
         lambda: mmp(x, q, n_major=True), False,
         {"weight read K-major": lambda: mmp(x, q.view(K, N))}, _NO_LIB, base, ops,
         BF16_OPS_PER_S, ("probe_i8mm", ("bf16.n.none", K, N))),
        (("make_qmm.castonly",), "block sums, BN 1024, SUB 1024",
         lambda: pr.blocksum(q, M, 1024, 1024),
         lambda: pr.blocksum_plain(q, M, 1024, 1024), True,
         {"tiles of 512 rows": lambda: pr.blocksum_plain(q, M, 512, 1024)},
         "no one torch call (block sums, then their scaled sum per tile)", N * K + 4 * M * N,
         N * K, F32_OPS_PER_S, ("probe_blocksum", ("bn1024.sub1024", K, N))),
        (("make_qmm.gloop",), f"M {M}: groups of 32, f32 dots * s, s [{K // 32},{N}]",
         lambda: pr.i8mm_group(x, q, s_t.t(), n_major=True),
         lambda: pr.i8mm_group_plain(x, q, s_t.t(), n_major=True), False,
         {"rescale dropped": lambda: pr.i8mm_group_plain(x, q, torch.ones_like(s), n_major=True),
          "scales read [N, K/32]": lambda: pr.i8mm_group_plain(x, q, s_t.view(N, K // 32),
                                                               n_major=True)},
         _NO_LIB_GROUP, base + sb, ops, BF16_OPS_PER_S,
         ("probe_i8mm_group", ("bf16.n.g32.sT", K, N))),
    ]
    return cases


def _i4_payload(gen, rows, cols):
    import torch

    return torch.randint(0, 256, (rows, cols), dtype=torch.uint8, device="cuda", generator=gen)


def _swap_nibbles(q):
    return (q >> 4) | (q << 4)  # u8: the high nibble taken as the low


def _tqmm_cases(gen) -> list:
    """tqmm_probe at [4096, 4096], G 32, M 64: K-major int8 with f32 scales,
    the split-half i4 on the tensor cores and qmm_i4t.cu's M > 1 tile."""
    import torch

    from booster_tpu_torch.ops import probes as pr
    from booster_tpu_torch.ops import probes_i4 as p4
    from booster_tpu_torch.tools.timing import BF16_OPS_PER_S

    ints, normal, _ = _probe_inputs(gen)
    M, N, K = M_PROBE, 4096, 4096
    half = K // 2
    q, x = ints(K, N), normal(M, K)
    s = torch.rand(K // 32, N, device="cuda", generator=gen) * 0.02
    ng = torch.roll(s, 1, 0)
    base = N * K + 2 * M * K + 4 * M * N
    ops = 2 * M * N * K
    mm, mmp = pr.i8mm, pr.i8mm_plain
    p = _i4_payload(gen, half, N)
    s4 = torch.rand(2, half // 32, N, device="cuda", generator=gen) * 0.02 + 0.001
    x3 = normal(M, 2, half)
    w4 = p4.i4t_weight(p, s4)  # qmm_i4t.cu's bf16 planes, outside the timed call
    b4 = N * half + 2 * M * K + 4 * M * N
    return [
        (("tqmm_i8.sub_reshape", "tqmm_i8.sub_repeat"),
         f"M {M}: x @ (bf16(q) * bf16(s[k // 32, n])), q [{K},{N}]",
         lambda: mm(x, q, s=s, scale="group"), lambda: mmp(x, q, s=s, scale="group"), False,
         {"neighbour group's scale": lambda: mmp(x, q, s=ng, scale="group")}, _NO_LIB,
         base + s.numel() * 4, ops, BF16_OPS_PER_S, ("probe_i8mm", ("bf16.k.group.f32", K, N))),
        (("tqmm_i8.sub_ptile",), f"M {M}: the same with s[k % {K // 32}, n]",
         lambda: mm(x, q, s=s, scale="tile"), lambda: mmp(x, q, s=s, scale="tile"), False,
         {"tile read as repeat": lambda: mmp(x, q, s=s, scale="group")}, _NO_LIB,
         base + s.numel() * 4, ops, BF16_OPS_PER_S, ("probe_i8mm", ("bf16.k.tile.f32", K, N))),
        (("tqmm_i8.noscale",), f"M {M}: x @ bf16(q), K-major", lambda: mm(x, q),
         lambda: mmp(x, q), False, {"weight read N-major": lambda: mmp(x, q.view(N, K).t())},
         _NO_LIB, base, ops, BF16_OPS_PER_S, ("probe_i8mm", ("bf16.k.none", K, N))),
        (("tqmm_i4",), f"M {M}: split-half i4, payload [{half},{N}], f32 scales",
         lambda: p4.i4mm(x3, p, s4), lambda: p4.i4mm_plain(x3, p, s4), False,
         {"high nibble taken as the low": lambda: p4.i4mm_plain(x3, _swap_nibbles(p), s4),
          "neighbour group's scale": lambda: p4.i4mm_plain(x3, p, torch.roll(s4, 1, 1))},
         _NO_LIB_I4, b4 + s4.numel() * 4, ops, BF16_OPS_PER_S,
         ("probe_i4mm", ("current.i32", K, N))),
        (("qmm_i4t.dq",),
         f"M {M}: qmm_i4t.cu (tensor-core tile) on the tqmm_i4 payload, bf16 planes",
         lambda: p4.qmm_i4t(x3, w4), lambda: p4.qmm_i4t_plain(x3, w4), False,
         {"high nibble taken as the low": lambda: p4.qmm_i4t_plain(
             x3, p4.i4t_weight(_swap_nibbles(p), s4))},
         _NO_LIB_I4, b4 + s4.numel() * 2, ops, BF16_OPS_PER_S, ("probe_qmm_i4t_dq", (K, N))),
    ]


def _nibble_cases(gen) -> list:
    """nibble_probe at N 11264, K 2048, M 64: the three unpacks of its main
    and the port's three more of the current function, qmm_i4t.cu's kernel,
    and the check's dequantized tiles."""
    import torch

    from booster_tpu_torch.ops import probes_i4 as p4
    from booster_tpu_torch.tools.timing import BF16_OPS_PER_S, F32_OPS_PER_S

    _, normal, _ = _probe_inputs(gen)
    M, N, K = M_PROBE, 11264, 2048
    half = K // 2
    q = _i4_payload(gen, half, N)
    s0 = torch.randn(half // 32, N, device="cuda", generator=gen)
    s1 = torch.randn(half // 32, N, device="cuda", generator=gen)
    rows = {"current": torch.stack([s0, s1]), "i8mask": torch.stack([s0, s1 / 16]),
            "affine": torch.stack([s0, s1 / 16, 8 * s0])}
    x3 = normal(M, 2, half)
    base = N * half + 2 * M * K + 4 * M * N
    ops = 2 * M * N * K
    i4, i4p = p4.i4mm, p4.i4mm_plain
    cur = rows["current"]
    swapped = _swap_nibbles(q)
    cases = [
        (("make_step.current",), f"M {M}: (nib - 8) * s, rows [s0, s1]",
         lambda: i4(x3, q, cur), lambda: i4p(x3, q, cur), False,
         {"high nibble taken as the low": lambda: i4p(x3, swapped, cur),
          "neighbour group's scale": lambda: i4p(x3, q, torch.roll(cur, 1, 1))}, _NO_LIB_I4,
         base + cur.numel() * 4, ops, BF16_OPS_PER_S, ("probe_i4mm", ("current.i32", K, N))),
        (("make_step.i8mask_sub",), f"M {M}: byte ^ 0x80, rows [s0, s1/16]",
         lambda: i4(x3, q, rows["i8mask"], "i8mask"),
         lambda: i4p(x3, q, rows["i8mask"], "i8mask"), False,
         {"rows [s0, s1] (16x the high half)": lambda: i4p(x3, q, cur, "i8mask")}, _NO_LIB_I4,
         base + cur.numel() * 4, ops, BF16_OPS_PER_S, ("probe_i4mm", ("i8mask.i32", K, N))),
        (("make_step.i8mask_affine",), f"M {M}: lo unsigned, rows [s0, s1/16, 8 s0]",
         lambda: i4(x3, q, rows["affine"], "affine"),
         lambda: i4p(x3, q, rows["affine"], "affine"), False,
         {"the zero dropped": lambda: i4p(x3, q, torch.cat([rows["affine"][:2], 0 * s0[None]]),
                                          "affine")},
         _NO_LIB_I4, base + rows["affine"].numel() * 4, ops, BF16_OPS_PER_S,
         ("probe_i4mm", ("affine.i32", K, N))),
    ]
    for unpack in ("xor88", "magic_f32", "magic_bf16"):
        cases.append(((f"unpack.{unpack}",), f"M {M}: the current function, unpack {unpack}",
                      lambda unpack=unpack: i4(x3, q, cur, "current", unpack),
                      lambda: i4p(x3, q, cur), False,
                      {"high nibble taken as the low": lambda: i4p(x3, swapped, cur)},
                      _NO_LIB_I4, base + cur.numel() * 4, ops, BF16_OPS_PER_S,
                      ("probe_i4mm", (f"current.{unpack}", K, N))))
    w4 = p4.i4t_weight(q, cur)  # qmm_i4t.cu's bf16 planes, outside the timed call
    cases.append((("qmm_i4t.dq",), f"M {M}: qmm_i4t.cu (tensor-core tile), bf16 planes",
                  lambda: p4.qmm_i4t(x3, w4), lambda: p4.qmm_i4t_plain(x3, w4), False,
                  {"high nibble taken as the low": lambda: p4.qmm_i4t_plain(
                      x3, p4.i4t_weight(swapped, cur))},
                  _NO_LIB_I4, base + cur.numel() * 2, ops, BF16_OPS_PER_S,
                  ("probe_qmm_i4t_dq", (K, N))))
    qs = q[:256, :128].contiguous()
    for name, mode in (("i8mask_sub", "i8mask"), ("i8mask_affine", "affine"),
                       ("current", "current")):
        sc = rows[mode][:, :8, :128].contiguous()
        cases.append(((f"check.{name}",), f"dequantized tiles u8 [256,128], {mode}",
                      lambda sc=sc, mode=mode: torch.stack(p4.nibble_tiles(qs, sc, mode)),
                      lambda sc=sc, mode=mode: torch.stack(p4.nibble_tiles_plain(qs, sc, mode)),
                      True, {"high nibble taken as the low":
                             lambda sc=sc, mode=mode: torch.stack(
                                 p4.nibble_tiles_plain(_swap_nibbles(qs), sc, mode))},
                      "no one torch call (the nibble unpack and its roundings)",
                      qs.numel() + sc.numel() * 4 + 2 * qs.numel() * 4, 2 * qs.numel(),
                      F32_OPS_PER_S, ("probe_nibble", (mode, 256, 128))))
    return cases


def _groupdot_cases(gen) -> list:
    """groupdot_probe at its 1b shapes, gate-up [11264 <- 2048] and down
    [2048 <- 5632]: the i4, i4-with-mins and i8 group-dots with f32 scales,
    and qmm_i4t.cu's M = 1 kernel on the i4 payloads with bf16 planes."""
    import torch

    from booster_tpu_torch.ops import probes_i4 as p4
    from booster_tpu_torch.tools.timing import F32_OPS_PER_S

    ints, normal, _ = _probe_inputs(gen)
    gd, gdp = p4.groupdot, p4.groupdot_plain
    cases = []
    for N, K, label in ((11264, 2048, "gate-up"), (2048, 5632, "down")):
        half = K // 2
        p = _i4_payload(gen, half, N)
        s4 = torch.rand(4, half // 32, N, device="cuda", generator=gen) * 0.02 + 0.01
        s2 = s4[:2].contiguous()
        x3 = normal(1, 2, half)
        cut = p.clone()
        cut[-256:] = 0x88  # the last K split (256 payload rows) contributes nothing
        for fns, fmt, s, wrong in (
                (("_gd_i4_kernel",), "i4", s2,
                 {"the zero dropped": lambda p=p, x3=x3, s2=s2: gdp(
                     x3, p, torch.cat([s2, 0 * s2]), "i4m"),
                  "the last K split left out": lambda cut=cut, x3=x3, s2=s2: gdp(
                      x3, cut, s2, "i4")}),
                (("_gd_i4m_kernel",), "i4m", s4,
                 {"the mins dropped": lambda p=p, x3=x3, s4=s4: gdp(
                     x3, p, torch.cat([s4[:2], 0 * s4[2:]]), "i4m")})):
            qb = p.numel() + s.numel() * 4
            cases.append((fns, f"M 1, {fmt}, {label} [{N}x{K}], f32 scales",
                          lambda p=p, x3=x3, s=s, fmt=fmt: gd(x3, p, s, fmt),
                          lambda p=p, x3=x3, s=s, fmt=fmt: gdp(x3, p, s, fmt), False, wrong,
                          _NO_LIB_I4, qb + 2 * K + 4 * N, 2 * N * K, F32_OPS_PER_S,
                          ("probe_gd", (fmt, K, N))))
            zero = 8 if fmt == "i4" else 0
            w4 = p4.i4t_weight(p, s, zero)  # bf16 planes, outside the timed call
            cases.append((("qmm_i4t.gd",),
                          f"M 1, qmm_i4t.cu on the {fmt} payload, bf16 planes, {label}",
                          lambda x3=x3, w4=w4: p4.qmm_i4t(x3, w4),
                          lambda x3=x3, w4=w4: p4.qmm_i4t_plain(x3, w4),
                          False, {"high nibble taken as the low":
                                  lambda p=p, x3=x3, s=s, zero=zero: p4.qmm_i4t_plain(
                                      x3, p4.i4t_weight(_swap_nibbles(p), s, zero))},
                          _NO_LIB_I4, p.numel() + s.numel() * 2 + 2 * K + 4 * N, 2 * N * K,
                          F32_OPS_PER_S, ("probe_qmm_i4t_gd", (K, N))))
        q8 = ints(K, N)
        s8 = torch.rand(1, K // 32, N, device="cuda", generator=gen) * 0.02 + 0.01
        x = normal(1, K)
        cut8 = q8.clone()
        cut8[-256:] = 0
        cases.append((("_gd_i8_kernel", "_gd_i8_kernel.raw"), f"M 1, i8, {label} [{N}x{K}]",
                      lambda q8=q8, x=x, s8=s8: gd(x, q8, s8, "i8"),
                      lambda q8=q8, x=x, s8=s8: gdp(x, q8, s8, "i8"), False,
                      {"neighbour group's scale": lambda q8=q8, x=x, s8=s8: gdp(
                          x, q8, torch.roll(s8, 1, 1), "i8"),
                       "the last K split left out": lambda cut8=cut8, x=x, s8=s8: gdp(
                           x, cut8, s8, "i8")},
                      "no one torch call (per-group dots, each rescaled)",
                      q8.numel() + s8.numel() * 4 + 2 * K + 4 * N, 2 * N * K, F32_OPS_PER_S,
                      ("probe_gd", ("i8", K, N))))
    return cases


def _probe_check(case, entries: list, keys: list, failures: list) -> None:
    """One case of _probe_cases' lists: the kernel against its plain version
    and its wrong kernels, then its times; one entry per Pallas function
    that the call computes."""
    import torch

    fns, label, call, plain, exact, wrong, lib, nbytes, ops, rate, key = case
    keys.append((fns[0], key))
    got = call()
    want = plain()
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    limit = 2e-4 * float(want.double().abs().max())
    ok = (torch.equal(got, want) if exact else err <= limit) and bool(
        torch.isfinite(got.double()).all())
    if not ok:
        failures.append(f"{fns[0]} {label}: max err {err} (limit {0 if exact else limit})")
    seen = {}
    for what, mutant in wrong.items():
        d = float((got.double() - mutant().double()).abs().max())
        seen[what] = d / limit
        if d < 8 * limit:
            failures.append(f"{fns[0]} {label}: the wrong kernel '{what}' is only "
                            f"{d / limit:.2f}x the limit")
    del got, want
    b_ms, b_by = bound(nbytes, ops, rate)
    t = {"ms": timed(call), "warm_ms": timed(call, cold=False),
         "plain_ms": timed(plain, reps=3, trials=3),
         "library_ms": timed(lib) if callable(lib) else None}
    for fn in fns:
        entries.append({
            "name": key[0], "function": fn, "shape": label, "key": key, "path": "probes",
            "route": "cuda", "source": f"booster_tpu_torch/csrc/{PROBE_SOURCES[key[0]]}",
            "replaces": PROBE_REPLACES[fn], "max_abs_err": err, **t,
            "bound_ms": b_ms, "bound_by": b_by, "library_reason": None if callable(lib) else lib,
            "check": "exact" if exact else CHECKS["qmm"], "wrong_x_limit": seen})


def phase_probes(entries: list) -> dict:
    """The probe tools: each Pallas function of the JAX package's
    kernel_micro, cast_probe, mmq_probe, qmm_gap, qmm_probe, expander_probe,
    tqmm_probe, nibble_probe and groupdot_probe tools through its kernel
    (csrc/probe_i8.cu, csrc/probe_i4.cu) against its plain version at the
    tools' full shapes, exact (column sums, integer dots, the expansion,
    the block sums, the nibble tiles) or within CHECKS["qmm"], and each
    wrong kernel 8x past that limit (for the exact forms, past 8x the qmm
    limit); then each port tool's main on the card
    (booster_tpu_torch.tools), which must launch its own kernels and no
    other, as many times as its rungs say.  One tool's inputs at a time
    live on the card."""
    import importlib

    import torch

    from booster_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    laps = _Laps()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    failures = []
    keys = []
    # each case: (functions, label, kernel call, plain call, exact, wrong
    # kernels {name: plain call}, library call or the reason there is none,
    # bytes, operations, their rate, the kernel's count key); the inputs of
    # one tool at a time live on the card
    for cases in (_colsum_cases, _cast_cases, _s8_cases, _mmq_cases, _gap_cases, _qmm_probe_cases,
                  _expander_cases, _tqmm_cases, _nibble_cases, _groupdot_cases):
        for case in cases(gen):
            _probe_check(case, entries, keys, failures)
        torch.cuda.empty_cache()
    laps("checks")
    counts_all: dict = {}
    shapes_all: dict = {}
    for tool, extra in PROBE_TOOLS:
        mod = importlib.import_module(f"booster_tpu_torch.tools.{tool}")
        kernels.reset_counts()
        res = mod.main(["--device", "cuda", *extra])
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts.items() if v}
        expected: dict = {}
        for r in res["rungs"]:
            if r["kernel"] is not None:
                expected[r["kernel"]] = expected.get(r["kernel"], 0) + r["launches"]
        if counts != expected:
            failures.append(f"{tool}: launched {counts}, expected {expected}")
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v
        for k, v in kernels.shape_counts.items():
            shapes_all[k] = shapes_all.get(k, 0) + v
        emit({"tool": tool, "card": res["card"], "launches": counts,
              "rungs": [{k: r[k] for k in ("name", "ms", "warm_ms", "gb_s", "share_of_bound",
                                           "bound_ms", "bound_by", "max_abs_err", "limit")}
                        for r in res["rungs"]]})
        laps(tool)
    failures += [f"{fn}: its kernel {key} was not launched by the tools"
                 for fn, key in keys if not shapes_all.get(key)]
    release_scrub()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("probe checks failed: " + "; ".join(failures))
    return {"phase": "probes", "seconds": time.perf_counter() - t0,
            "part_s": laps.parts, "launches": counts_all, "_shape_counts": shapes_all,
            "checks": {e["function"] + " " + e["shape"]: e["max_abs_err"] for e in entries
                       if e.get("path") == "probes"}}


# -- phase 3 -----------------------------------------------------------------


# the smoke run's GGUFs: file stem, make_model arguments, weight type
GGUFS = {"tiny": ("tinyllama-shape-q4_0", "TINYLLAMA", "Q4_0"),
         "q8": ("mistral7b-shape-q8_0", "MISTRAL7B", "Q8_0"),
         "moe": ("mixtral8x7b-shape-q4_0", "MIXTRAL", "Q4_0"),
         "moe_q8": ("mixtral8x7b-shape-q8_0", "MIXTRAL", "Q8_0"),
         "q6k": ("deepseek-coder-1.3b-shape-q6_k", "DEEPSEEK", "Q6_K"),
         "mpt": ("mpt-7b-shape-q4_0", "MPT7B", "Q4_0"),
         "q4k": ("llama3-8b-shape-q4_k", "LLAMA3_8B", "Q4_K"),
         "moe_q4k": ("mixtral8x7b-shape-q4_k", "MIXTRAL", "Q4_K"),
         "q5k": ("deepseek-coder-1.3b-shape-q5_k_s", "DEEPSEEK_Q5KS", "Q5_K"),
         "q5k_8b": ("llama3-8b-shape-q5_k_s", "LLAMA3_8B_Q5KS", "Q5_K"),
         "q2k": ("llama3-8b-shape-q2_k", "LLAMA3_8B_Q2K", "Q2_K"),
         "gemma": ("gemma-2b-shape-q4_0", "GEMMA_2B", "Q4_0"),
         "gemma_q6k": ("gemma-2b-shape-q6_k", "GEMMA_2B_Q6K", "Q6_K"),
         "gemma7b": ("gemma-7b-shape-q4_0", "GEMMA_7B", "Q4_0"),
         "gemma_mix": ("gemma-narrow-q8_0-q6_k-down", "GEMMA_MIX", "Q8_0"),
         "gemma_mix_q5k": ("gemma-narrow-q5_k-q6_k-down", "GEMMA_MIX", "Q5_K")}
# each model's depth on its full-size phases
# (Mixtral cut to 20 of its 32: the card's machine takes 45 GiB of disk writes
# a call; with config 2's files a 32-layer Mixtral came to 49 GiB, and at 24
# layers the Q2_K mix's 2.8 GB did not fit beside the rest; Gemma-7B cut to
# 4 of its 28, 1.27 GB, the room that parity's 2-layer Q8_0 file gave back)
LAYERS = {"tiny": 22, "q8": 32, "moe": 20, "q6k": 24, "mpt": 32, "q4k": 32, "q5k": 24,
          "q2k": 32, "gemma": 18, "gemma_q6k": 18, "gemma7b": 4}


def _gguf_path(layers: int, model: str = "tiny") -> Path:
    return ROOT / "build" / "smoke" / f"{GGUFS[model][0]}-L{layers}-seed0.gguf"


def _gguf(layers: int, model: str = "tiny") -> str:
    """The GGUF of `model` (GGUFS: the TinyLlama-shaped Q4_0, bench.py's
    config-3 Mistral-7B-shaped Q8_0, the Mixtral-8x7B-shaped Q4_0 or Q8_0)
    at `layers` layers: built once from its seed and cached under
    build/smoke/."""
    from booster_tpu_torch.gguf import GGMLType
    from booster_tpu_torch.testing import make_model

    path = _gguf_path(layers, model)
    path.parent.mkdir(parents=True, exist_ok=True)
    if not path.exists():
        tmp = path.with_suffix(".tmp")
        _, shape, quant = GGUFS[model]
        kw = dict(globals()[shape])
        for key in ("output_quant", "embd_quant"):
            if key in kw:
                kw[key] = GGMLType[kw[key]]
        if "tensor_quant" in kw:
            kw["tensor_quant"] = {k: GGMLType[v] for k, v in kw["tensor_quant"].items()}
        make_model(str(tmp), layers=layers, quant=GGMLType[quant], **kw)
        tmp.replace(path)
    return str(path)


def _gguf_sizes() -> dict:
    """The GGUFs under build/smoke/ (those this run wrote, on the card's
    machine) by name in GB, and their sum in GiB: the card machine takes
    45 GiB of writes a call."""
    files = sorted((ROOT / "build" / "smoke").glob("*.gguf"))
    sizes = {f.name: f.stat().st_size / 1e9 for f in files}
    return {"files_gb": sizes, "total_gib": sum(f.stat().st_size for f in files) / 2**30}


# parity's 2-layer models that are the first 2 layers of a full-depth file
# (testing.load_first_layers): the card's machine takes 45 GiB of writes a
# call, and a 2-layer file of its own would cost Mixtral's 1.78 GB, the 7B
# Q8_0's 0.74 (which pays for Gemma-7B's file), Gemma's 0.49, MPT-7B's 0.51,
# the 8B Q4_K's 0.39 and Q2_K's 0.31, the 1.3B Q6_K's 0.20 and Q5_K_S's
# 0.17, TinyLlama's 0.12 (the last five pay for Gemma-2B's Q6_K file; the
# writer writes these files before parity needs them, the 7B's last, and
# parity's cases on it come last)
PARITY_SHARED = ("tiny", "moe", "gemma", "gemma_q6k", "q6k", "mpt", "q4k", "q5k", "q2k",
                 "gemma7b", "q8")


def _parity_model(model: str, dev: str, **kw):
    """load_model of parity's 2-layer `model` on `dev`: the first 2 layers of
    its full-depth file where PARITY_SHARED has it, else its own file."""
    from booster_tpu_torch.models import load_model
    from booster_tpu_torch.testing import load_first_layers

    if model in PARITY_SHARED:
        return load_first_layers(_wait_gguf(model, LAYERS[model])[0], 2, device=dev, **kw)
    return load_model(_wait_gguf(model, 2)[0], device=dev, **kw)


def _both(load) -> dict:
    """{"cpu": load("cpu"), "cuda": load("cuda")}, the two loads at once in
    two threads: the CPU's repack (numpy and torch CPU ops, which let go of
    the GIL) overlaps the card's (file reads, then device ops)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as ex:
        futures = {dev: ex.submit(load, dev) for dev in ("cpu", "cuda")}
        return {dev: f.result() for dev, f in futures.items()}


# parity's 2-layer loads (model, load_model's keywords) in the order its
# cases take them: while a case runs, the next one's load runs on a thread
# (_parity_models)
_NATIVE = (("weights", "native"),)
PARITY_LOADS = (("tiny", ()), ("tiny", (("weights", "bf16"),)), ("tiny", (("weights", "i8"),)),
                ("tiny", (("weights", "i8c"),)), ("moe", _NATIVE), ("moe_q8", _NATIVE),
                ("q6k", _NATIVE), ("mpt", _NATIVE), ("q4k", _NATIVE), ("moe_q4k", _NATIVE),
                ("q5k_8b", _NATIVE), ("q5k", _NATIVE), ("q2k", _NATIVE), ("q8", _NATIVE),
                ("q8", (("weights", "i8c"),)))
_prefetch: dict = {}  # "pool": the loading thread; PARITY_LOADS entry → its future


def _parity_models(model: str, **kw) -> dict:
    """Both devices' 2-layer `model` (_both of _parity_model) for a parity
    case, taken from the thread that loaded it while the case before ran;
    as it returns, the next case's load (PARITY_LOADS) starts on that
    thread.  The CPU forwards of one case and the loads of the next use the
    host's cores together."""
    from concurrent.futures import ThreadPoolExecutor

    key = (model, tuple(sorted(kw.items())))
    fut = _prefetch.pop(key, None)
    models = fut.result() if fut is not None else _both(
        lambda dev: _parity_model(model, dev, **kw))
    i = PARITY_LOADS.index(key) if key in PARITY_LOADS else len(PARITY_LOADS)
    if i + 1 < len(PARITY_LOADS):
        nm, nkw = PARITY_LOADS[i + 1]
        pool = _prefetch.setdefault("pool", ThreadPoolExecutor(1))
        _prefetch[PARITY_LOADS[i + 1]] = pool.submit(
            _both, lambda dev: _parity_model(nm, dev, **dict(nkw)))
    return models


def _teacher_forced(models, caches, prompts, T, live, laps, tag, steps=16) -> list:
    """Prefill `prompts` (one per slot, [] for an idle slot) in one T-row
    batch, then `steps` decode steps with the live slots fed the CPU's
    greedy token, on every device of `models`; returns per device the live
    slots' logits [steps + 1, n_live, V] on the CPU.  Each device's seconds
    go to `laps` as "<tag> cpu" and "<tag> cuda" (the caller laps just
    before)."""
    import torch

    from booster_tpu_torch.models.llama import forward

    B = len(prompts)
    arr = torch.zeros(B, T, dtype=torch.int32)
    nv = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    for b, ids in enumerate(prompts):
        arr[b, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    rows = torch.tensor(live).nonzero()[:, 0]
    logits = {}
    for dev, m in models.items():
        lg, caches[dev] = forward(m.params, m.cfg, arr.to(dev), caches[dev],
                                  gather_idx=torch.clamp_min(nv - 1, 0).to(dev),
                                  n_valid=nv.to(dev))
        logits[dev] = [lg[rows, -1].float().cpu()]
        laps(f"{tag} {dev}")
    step_nv = torch.tensor(live, dtype=torch.int32)
    for _ in range(steps):
        tok = torch.zeros(B, 1, dtype=torch.int32)
        tok[rows, 0] = torch.argmax(logits["cpu"][-1], -1).to(torch.int32)
        for dev, m in models.items():
            lg, caches[dev] = forward(m.params, m.cfg, tok.to(dev), caches[dev],
                                      last_only=True, n_valid=step_nv.to(dev))
            logits[dev].append(lg[rows, -1].float().cpu())
            laps(f"{tag} {dev}")
    return [torch.stack(logits[dev]) for dev in ("cuda", "cpu")]


def _compare_logits(name, got, want, tol) -> dict:
    """Card logits against CPU logits, [steps, rows, V]: within `tol` of the
    largest CPU logit at every step, the greedy tokens equal wherever the
    CPU's top-2 margin exceeds it."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"parity {name}: non-finite logits on the card")
    scale = want.abs().amax(-1)  # [steps, rows]
    errs = (got - want).abs().amax(-1) / scale
    top2 = torch.topk(want, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]) / scale
    same = torch.argmax(got, -1) == torch.argmax(want, -1)
    if bool((~same & (margin > tol)).any()):
        raise AssertionError(f"parity {name}: a greedy token differs at a margin over {tol}")
    if float(errs.max()) > tol:
        raise AssertionError(f"parity {name}: logits differ by {float(errs.max())} > {tol}")
    return {"prefill_rel_err": float(errs[0].max()), "first_decode_rel_err": float(errs[1].max()),
            "max_rel_err": float(errs.max()),
            "greedy_tokens_equal": f"{int(same.sum())}/{same.numel()}"}


def phase_parity() -> dict:
    try:
        return _phase_parity()
    finally:  # a failed case leaves the next one's load behind
        pool = _prefetch.pop("pool", None)
        _prefetch.clear()
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)


def _phase_parity() -> dict:
    from booster_tpu_torch.ops.kv_cache import KVCache

    t0 = time.perf_counter()
    laps = _Laps()
    _wait_gguf("tiny", LAYERS["tiny"])
    tol = 2 ** -5
    out = {"phase": "parity", "layers": 2, "tolerance": CHECKS["logits"]}
    # (a) batch 1, Q4_0 weights, bf16 cache (the generate path)
    laps("a wait")
    models = _parity_models("tiny")
    cfg = models["cpu"].cfg
    ids = models["cpu"].tokenizer.encode(PROMPT)
    T = max(16, 1 << (len(ids) - 1).bit_length())  # the engine's prompt bucket
    caches = {dev: KVCache.create(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim, dev)
              for dev in models}
    laps("a load")
    got, want = _teacher_forced(models, caches, [ids], T, [True], laps, "a")
    out["q4_0_bf16_cache_1_slot"] = _compare_logits("q4_0", got, want, tol)
    # (b) the batched path: bf16 weights, int8 cache, 4 slots, 2 of them live
    models = _parity_models("tiny", weights="bf16")
    tok = models["cpu"].tokenizer
    prompts = [tok.encode("stream 0 benchmark prompt"), [],
               tok.encode("stream 2 benchmark prompt"), []]
    T = max(16, 1 << (max(len(p) for p in prompts) - 1).bit_length())
    caches = {dev: KVCache.create(cfg.n_layers, 4, 512, cfg.n_kv_heads, cfg.head_dim, dev,
                                  quantized=True) for dev in models}
    laps("b load")
    got, want = _teacher_forced(models, caches, prompts, T, [True, False, True, False], laps,
                                "b")
    out["bf16_int8_cache_4_slots_2_live"] = _compare_logits("batched", got, want, tol)
    lengths = [caches[dev].lengths.tolist() for dev in ("cpu", "cuda")]
    expect = [len(prompts[0]) + 16, 0, len(prompts[2]) + 16, 0]
    if lengths != [expect, expect]:
        raise AssertionError(f"parity batched: cache lengths {lengths} != {expect}")
    ids = tok.encode(PROMPT)
    del models, caches
    laps("b check")
    out.update(_parity_i8(tol, laps, ids, (("tiny", "i8"), ("tiny", "i8c"))))
    out.update(_parity_moe(tol, laps))
    out.update(_parity_q6k(tol, laps))
    out.update(_parity_mpt(tol, laps))
    out.update(_parity_q4k(tol, laps))
    out.update(_parity_moe(tol, laps, ("moe_q4k",), "j"))
    out.update(_parity_q5k(tol, laps, out))
    out.update(_parity_q2k(tol, laps, out))
    out.update(_parity_gemma(tol, laps, out))
    out.update(_parity_gemma8(tol, laps, out, "o"))
    out.update(_parity_gemma8(tol, laps, out, "p"))
    out.update(_parity_gemma7b(tol, laps, out))
    out.update(_parity_gemma_mix(tol, laps, out))
    # the 7B width last: its 32-layer Q8_0 file is the writer's last
    out.update(_parity_q8(tol, laps))
    out.update(_parity_i8(tol, laps, ids, (("q8", "i8c"),)))
    recip = sum(v["scale_rows"]["reciprocal_multiply_differs"] for k, v in out.items()
                if isinstance(v, dict) and "scale_rows" in v)
    if not recip:
        raise AssertionError("parity (f): the reciprocal multiply differs on no row; "
                             "the bit-equality of the scales cannot see it")
    out["seconds"] = time.perf_counter() - t0
    out["part_s"] = laps.parts
    return out


def _parity_q8(tol: float, laps) -> dict:
    """(c) the 7B width, Q8_0 weights (native i8t): the batched path over an
    int8 cache at the T = 32 bucket, then the single-stream path over a
    bf16 cache; PARITY_7B_STEPS each; (d) the same model over the server
    path's paged pool."""
    from booster_tpu_torch.ops.kv_cache import KVCache
    from booster_tpu_torch.serving import Engine

    out = {}
    laps("c wait")
    models = _parity_models("q8", weights="native")
    cfg = models["cpu"].cfg
    kinds = {v.kind for v in models["cuda"].params["layers"].values() if hasattr(v, "kind")}
    if kinds != {"i8t"} or models["cuda"].params["output"].kind != "i8t":
        raise AssertionError(f"parity q8_0: weights are {kinds}, not i8t")
    tok = models["cpu"].tokenizer
    prompts = [tok.encode("stream 0 benchmark prompt"), [],
               tok.encode("stream 2 benchmark prompt"), []]
    T = max(16, 1 << (max(len(p) for p in prompts) - 1).bit_length())
    caches = {dev: KVCache.create(cfg.n_layers, 4, 512, cfg.n_kv_heads, cfg.head_dim, dev,
                                  quantized=True) for dev in models}
    laps("c load")
    got, want = _teacher_forced(models, caches, prompts, T, [True, False, True, False], laps,
                                "c", steps=PARITY_7B_STEPS)
    out["q8_0_7b_width_int8_cache_4_slots_2_live"] = _compare_logits("q8_0 batched", got, want,
                                                                     tol)
    ids = tok.encode(PROMPT)
    caches = {dev: KVCache.create(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim, dev)
              for dev in models}
    laps("c check")
    got, want = _teacher_forced(models, caches, [ids], 16, [True], laps, "c",
                                steps=PARITY_7B_STEPS)
    out["q8_0_7b_width_bf16_cache_1_slot"] = _compare_logits("q8_0 single", got, want, tol)
    # (d) the same model over the server path's paged pool: an Engine with
    # pages of 256 rows (the paged prefill through gathered views, then the
    # paged decode kernels), 4 slots of which 2 live, their pages given by
    # the engine's allocator (slot 2 first); an int8 pool, then a bf16 one
    for quant in (True, False):
        caches = {}
        for dev, m in models.items():
            eng = Engine(m, max_batch=4, max_seq=512, kv_quantized=quant, paged=True,
                         page_size=256)
            eng.init_batch_state()
            for s_ in (2, 0):
                eng.ensure_slot_pages(s_, T + 8)
            caches[dev] = eng.cache
        laps("d engines")
        got, want = _teacher_forced(models, caches, prompts, T, [True, False, True, False],
                                    laps, "d", steps=PARITY_7B_STEPS)
        key = f"q8_0_7b_width_paged_{'int8' if quant else 'bf16'}_pool_4_slots_2_live"
        out[key] = _compare_logits(key, got, want, tol)
        lengths = [caches[dev].lengths.tolist() for dev in ("cpu", "cuda")]
        expect = [len(prompts[0]) + PARITY_7B_STEPS, 0, len(prompts[2]) + PARITY_7B_STEPS, 0]
        if lengths != [expect, expect]:
            raise AssertionError(f"parity paged: cache lengths {lengths} != {expect}")
    del models, caches
    laps("d check")
    return out


def _i8c_scale_rows(path: str, device: str = "cuda", layers: int = 2) -> dict:
    """For each weight of the GGUF at `path` that weights="i8c" requantizes
    (every non-expert Q4_0/Q8_0 tensor of its first `layers` layers), the rows of its channel scale
    max|w| / 127 computed on the card three ways: as channel_quantize does
    (dividing by a tensor: IEEE), as ``amax · f32(1/127)`` (the reciprocal
    multiply), and as ``amax / 127.0`` (torch's CUDA division by a Python
    scalar).  Returns the rows where each of the latter two differs from
    the first, summed over the file."""
    import torch

    from booster_tpu_torch.gguf import GGMLType, GGUFReader
    from booster_tpu_torch.quant.qtensor import dequantize, repack_gguf_tensor

    rows = {"rows": 0, "reciprocal_multiply_differs": 0, "scalar_division_differs": 0}
    reader = GGUFReader(path)
    try:
        for name, info in reader.tensors.items():
            requantized = name == "output.weight" or (
                name.startswith("blk.") and "_exps" not in name
                and int(name.split(".")[1]) < layers)
            if info.ggml_type not in (GGMLType.Q4_0, GGMLType.Q8_0) or not requantized:
                continue
            qt = repack_gguf_tensor(reader.tensor_bytes(info), info.ggml_type, info.shape,
                                    device=device)
            amax = dequantize(qt, torch.float32).abs().amax(dim=1, keepdim=True)
            ieee = amax / torch.full_like(amax, 127.0)
            recip = amax * torch.tensor(1 / 127, dtype=torch.float32, device=device)
            rows["rows"] += amax.numel()
            rows["reciprocal_multiply_differs"] += int((recip != ieee).sum())
            rows["scalar_division_differs"] += int((amax / 127.0 != ieee).sum())
    finally:
        reader.close()
    return rows


def _parity_i8(tol: float, laps, ids: list, cases) -> dict:
    """(f) of `cases` ((model, weights)): the 7B-width file with
    weights="i8c" and the TinyLlama-width file with weights="i8" (and
    "i8c"), loaded on the CPU and on the card: every
    i8c tensor (requantized on each device) bit-equal between the two, and
    the i8c / i8 single-stream path over a bf16 cache, a 16-row prefill and
    3 decode steps, the CPU (plain versions) against the card (the i8c and
    i8t kernels).  The reciprocal multiply amax · f32(1/127) must differ
    from the scales on at least one row of the Q4_0 file (Q8_0 rows hold
    127·d, whose two quotients agree), so the bit-equality can see it: the
    caller checks that over every case's "scale_rows"."""
    import torch

    from booster_tpu_torch.ops.kv_cache import KVCache

    out = {}
    for model, weights in cases:
        tag = f"f {model} {weights}"
        models = _parity_models(model, weights=weights)
        laps(f"{tag} load")
        cfg = models["cpu"].cfg
        want_kind = "i8c" if weights == "i8c" else "i8t"
        ps = {dev: m.params for dev, m in models.items()}
        keys = ["wqkv", "wo", "w_gateup", "w_down"]
        for key in keys + ["output"]:
            a, b = ((p_["output"] if key == "output" else p_["layers"][key])
                    for p_ in (ps["cpu"], ps["cuda"]))
            if a.kind != want_kind or b.kind != want_kind:
                raise AssertionError(f"parity {tag}: {key} is {a.kind} / {b.kind}")
            if not (torch.equal(a.qw, b.qw.cpu()) and torch.equal(a.scales, b.scales.cpu())):
                raise AssertionError(f"parity {tag}: {key} differs between the devices")
        res = {"tensors_bit_equal": keys + ["output"]}
        if weights == "i8c":
            res["scale_rows"] = _i8c_scale_rows(
                _wait_gguf(model, LAYERS[model] if model in PARITY_SHARED else 2)[0])
            laps(f"{tag} repack check")
        if (model, weights) != ("tiny", "i8c"):  # its forward is parity (f) q8's at another width
            caches = {dev: KVCache.create(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim,
                                          dev) for dev in models}
            got, want = _teacher_forced(models, caches, [ids], 16, [True], laps, tag, steps=3)
            res.update(_compare_logits(tag, got, want, tol))
        out[f"{model}_{weights}_bf16_cache_1_slot"] = res
        del models, ps
        laps(f"{tag} check")
    return out


def _parity_moe(tol: float, laps, files=("moe", "moe_q8"), case: str = "e") -> dict:
    """(e) the Mixtral-8x7B width at 2 layers, Q4_0 and then Q8_0 (so that
    the grouped kernel's i8 branch runs on a model path), and (j) the same
    width in Q4_K (the expert stacks lane-major i4p with their mins planes:
    the lane-major kernel's mins form; its card launches are counted as the
    path "parity (j)"): the single-stream path over a bf16 cache, a 16-row
    prefill and MOE_PARITY_STEPS decode steps, the CPU (plain versions)
    against the card (kernels).  A router's logits are bf16, so the two
    devices may route a token to other experts where its k-th and (k+1)-th
    logits tie within their f32 summation difference; such a step's logits
    (only that step's) are left out of the comparison, each flip must be
    such a near-tie, and at most one step may have one."""
    import numpy as np
    import torch

    from booster_tpu_torch.models import llama
    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.ops.kv_cache import KVCache

    out = {}
    k = MIXTRAL["experts_used"]
    for model in files:
        tag = f"{case} {model}"
        laps(f"{tag} wait")
        models = _parity_models(model, weights="native")
        cfg = models["cpu"].cfg
        lay = models["cuda"].params["layers"]
        kinds = {key: lay[key].kind for key in ("wqkv", "wo", "gate_exps", "down_exps")}
        want_kinds = ({"wqkv": "i4t", "wo": "i4t", "gate_exps": "i4p", "down_exps": "i4p"}
                      if model in ("moe", "moe_q4k") else
                      {"wqkv": "i8t", "wo": "i8t", "gate_exps": "i8", "down_exps": "i8"})
        if kinds != want_kinds or cfg.n_experts != MIXTRAL["experts"]:
            raise AssertionError(f"parity {model}: weights {kinds}, experts {cfg.n_experts}")
        if model == "moe_q4k" and {lay[key].scales.shape[-2] for key in (
                "gate_exps", "up_exps", "down_exps")} != {4}:
            raise AssertionError(f"parity {model}: the expert stacks lack their mins planes")
        routed = {"cpu": [], "cuda": []}
        route = llama.moe_route

        def spy(logits, cfg_):
            routed[logits.device.type].append(logits.float().cpu())
            return route(logits, cfg_)

        ids = models["cpu"].tokenizer.encode(PROMPT)
        caches = {dev: KVCache.create(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim, dev)
                  for dev in models}
        llama.moe_route = spy
        laps(f"{tag} load")
        kernels.reset_counts()
        try:
            got, want = _teacher_forced(models, caches, [ids], 16, [True], laps, tag,
                                        steps=MOE_PARITY_STEPS)
        finally:
            llama.moe_route = route
        card_launches = {k: v for k, v in kernels.launch_counts.items() if v}
        if case == "j":  # the card's launches (the CPU runs the plain versions)
            out.setdefault("_paths", {})["parity (j)"] = (dict(kernels.launch_counts),
                                                          dict(kernels.shape_counts))
            if not card_launches.get("moe_qmm_i4p"):
                raise AssertionError("parity moe_q4k: the grouped kernel did not launch")
        L = cfg.n_layers
        flips, keep = [], []
        for step in range(got.shape[0]):
            row = len(ids) - 1 if step == 0 else 0  # the row whose logits are compared
            flipped = False
            for layer in range(L):
                a = routed["cpu"][step * L + layer][row]
                b = routed["cuda"][step * L + layer][row]
                ta = torch.sort(a, descending=True, stable=True)
                tb = torch.sort(b, descending=True, stable=True)
                if set(ta.indices[:k].tolist()) == set(tb.indices[:k].tolist()):
                    continue
                d = float((a - b).abs().max())
                gaps = [float(t.values[k - 1] - t.values[k]) for t in (ta, tb)]
                if d > tol * float(a.abs().max()) or max(gaps) > 2 * d:
                    raise AssertionError(f"parity {model}: step {step} layer {layer} routes "
                                         f"{a.tolist()} / {b.tolist()} apart")
                flips.append({"step": step, "layer": layer, "router_diff": d, "gaps": gaps})
                flipped = True
            if not flipped:
                keep.append(step)
        if len(got) - len(keep) > 1:
            raise AssertionError(f"parity {model}: routing flips at {flips}")
        res = _compare_logits(model, got[keep], want[keep], tol)
        if keep[:2] != [0, 1]:  # its first two compared steps are not prefill and decode 1
            res["prefill_rel_err"] = res["first_decode_rel_err"] = None
        res.update(steps_compared=keep, routing_flips_at_near_ties=flips,
                   card_launches=card_launches)
        out[f"{model}_mixtral_width_bf16_cache_1_slot"] = res
        del models, caches
        laps(f"{tag} check")
    return out


def _parity_q4k(tol: float, laps) -> dict:
    """(i) the Llama-3-8B width (config 2) at 2 layers in Q4_K, loaded
    native on both devices (every weight K-major i4t with four planes): the
    single-stream path over a bf16 cache, a 16-row prefill and
    PARITY_7B_STEPS decode steps, the CPU's plain versions against the
    card's kernels."""
    from booster_tpu_torch.ops.kv_cache import KVCache

    laps("i wait")
    models = _parity_models("q4k", weights="native")
    cfg = models["cpu"].cfg
    lay = models["cuda"].params["layers"]
    planes = {k: (v.kind, v.scales.shape[-3]) for k, v in lay.items() if hasattr(v, "kind")}
    if set(planes.values()) != {("i4t", 4)} or models["cuda"].params["output"].kind != "i4t":
        raise AssertionError(f"parity q4_k: weights {planes}, not i4t with four planes")
    ids = models["cpu"].tokenizer.encode(PROMPT)
    caches = {dev: KVCache.create(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim, dev)
              for dev in models}
    laps("i load")
    got, want = _teacher_forced(models, caches, [ids], 16, [True], laps, "i",
                                steps=PARITY_7B_STEPS)
    res = _compare_logits("q4_k", got, want, tol)
    del models, caches
    laps("i check")
    return {"q4_k_llama3_8b_width_bf16_cache_1_slot": res}


def _parity_q5k(tol: float, laps, out: dict) -> dict:
    """(k) the Llama-3-8B width at 2 layers in llama.cpp's Q5_K_S mix (every
    weight K-major i8t with a mins plane, the head Q6_K at group 16): the
    single-stream path over a bf16 cache, a 16-row prefill and
    PARITY_7B_STEPS decode steps, whose MLP is the whole-MLP kernel with
    mins on both weights (counted: its rows at M = 16 and 1 on the card;
    the card's launches are the path "parity (k)"); (l) the
    DeepSeek-Coder-1.3B width at 2 layers in the same mix (its ffn_down
    Q5_1, lane-major), the single-stream path and the batched path over an
    int8 cache (4 slots, 2 live, T = 32), 6 decode steps each.  The CPU
    (plain versions) against the card (kernels), fed the CPU's greedy
    tokens."""
    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.ops import mlp as tm
    from booster_tpu_torch.ops.kv_cache import KVCache

    res = {}
    for case, model in (("k", "q5k_8b"), ("l", "q5k")):
        laps(f"{case} wait")
        models = _parity_models(model, weights="native")
        cfg = models["cpu"].cfg
        for dev, m in models.items():
            lay = m.params["layers"]
            got = {k: (lay[k].kind, lay[k].group, lay[k].scales.shape[
                -3 if lay[k].kind == "i8t" else -2]) for k in ("wqkv", "wo", "w_gateup", "w_down")}
            got["output"] = (m.params["output"].kind, m.params["output"].group,
                             m.params["output"].scales.shape[-3])
            want = dict.fromkeys(("wqkv", "wo", "w_gateup"), ("i8t", 32, 2)) | {
                "w_down": ("i8t" if case == "k" else "i8", 32, 2), "output": ("i8t", 16, 1)}
            if got != want:
                raise AssertionError(f"parity q5_k_s ({case}) on {dev}: weights {got}")
        tok = models["cpu"].tokenizer
        caches = {dev: KVCache.create(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim, dev)
                  for dev in models}
        laps(f"{case} load")
        mlp_rows = []
        orig = tm.qmm_mlp_i8t

        def spy(x, w_gu, w_down, *act):
            if x.is_cuda:
                mlp_rows.append(x.shape[0])
            return orig(x, w_gu, w_down, *act)

        tm.qmm_mlp_i8t = spy
        kernels.reset_counts()
        try:
            got, want = _teacher_forced(models, caches, [tok.encode(PROMPT)], 16, [True], laps,
                                        case, steps=PARITY_7B_STEPS if case == "k" else 6)
        finally:
            tm.qmm_mlp_i8t = orig
        label = "llama3_8b" if case == "k" else "1.3b"
        key = f"q5_k_s_{label}_width_bf16_cache_1_slot"
        res[key] = _compare_logits(f"q5_k_s ({case}) single", got, want, tol)
        res[key]["card_launches"] = {k: v for k, v in kernels.launch_counts.items() if v}
        L = cfg.n_layers
        if case == "k":
            out.setdefault("_paths", {})["parity (k)"] = (dict(kernels.launch_counts),
                                                          dict(kernels.shape_counts))
            if mlp_rows != [16] * L + [1] * L * PARITY_7B_STEPS:
                raise AssertionError(f"parity q5_k_s (k): the MLP kernel ran at rows {mlp_rows}")
            res[key]["mlp_kernel_rows"] = mlp_rows
        else:
            prompts = [tok.encode("stream 0 benchmark prompt"), [],
                       tok.encode("stream 2 benchmark prompt"), []]
            T = max(16, 1 << (max(len(p) for p in prompts) - 1).bit_length())
            caches = {dev: KVCache.create(cfg.n_layers, 4, 512, cfg.n_kv_heads, cfg.head_dim,
                                          dev, quantized=True) for dev in models}
            laps(f"{case} check")
            got, want = _teacher_forced(models, caches, prompts, T, [True, False, True, False],
                                        laps, case, steps=6)
            res[f"q5_k_s_{label}_width_int8_cache_4_slots_2_live"] = _compare_logits(
                f"q5_k_s ({case}) batched", got, want, tol)
        del models, caches
        laps(f"{case} check")
    return res


def _parity_q2k(tol: float, laps, out: dict) -> dict:
    """(m) the Llama-3-8B width at 2 layers in llama.cpp's Q2_K mix (q, k
    and the gate-up i4t at group 16 with mins, wo and down at group 16 with
    zero 4, v Q4_K's group 32, the head Q6_K; q, k and v three matmuls),
    loaded native on both devices with those kinds: the single-stream path
    over a bf16 cache, a 16-row prefill and PARITY_7B_STEPS decode steps,
    the CPU's plain versions against the card's kernels (its launches are
    the path "parity (m)", and must hold both group-16 forms at M = 1 and
    in the tile)."""
    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.ops.kv_cache import KVCache

    laps("m wait")
    models = _parity_models("q2k", weights="native")
    cfg = models["cpu"].cfg
    want = {"wq": (16, 4, 0), "wk": (16, 4, 0), "wv": (32, 4, 0), "wo": (16, 2, 4),
            "w_gateup": (16, 4, 0), "w_down": (16, 2, 4)}
    for dev, m in models.items():
        lay = m.params["layers"]
        got = {k: (lay[k].group, lay[k].scales.shape[-3], lay[k].zero) for k in want
               if k in lay and lay[k].kind == "i4t"}
        if got != want or "wqkv" in lay or m.params["output"].kind != "i8t":
            raise AssertionError(f"parity q2_k (m) on {dev}: weights {got}")
    caches = {dev: KVCache.create(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim, dev)
              for dev in models}
    laps("m load")
    kernels.reset_counts()
    got, want_l = _teacher_forced(models, caches, [models["cpu"].tokenizer.encode(PROMPT)], 16,
                                  [True], laps, "m", steps=PARITY_7B_STEPS)
    res = _compare_logits("q2_k (m)", got, want_l, tol)
    counts = dict(kernels.launch_counts)
    res["card_launches"] = {k: v for k, v in counts.items() if v}
    need = ("qmm_i4t_g16m_gd", "qmm_i4t_g16_gd", "qmm_i4t_gateup_g16m_gd", "qmm_i4t_g16m_dq",
            "qmm_i4t_g16_dq", "qmm_i4t_gateup_g16m_dq")
    if not all(counts[k] for k in need):
        raise AssertionError(f"parity q2_k (m): the card's launches {res['card_launches']} "
                             f"lack a group-16 form of {need}")
    out.setdefault("_paths", {})["parity (m)"] = (counts, dict(kernels.shape_counts))
    del models, caches
    laps("m check")
    return {"q2_k_llama3_8b_width_bf16_cache_1_slot": res}


def _parity_gemma(tol: float, laps, out: dict) -> dict:
    """(n) Gemma-2B at 2 layers: the first 2 layers of generate_gemma's
    18-layer file (testing.load_first_layers), loaded on the card (Q4_0 i4t,
    the Q6_K token table dequantized there) and its params moved to the CPU
    (a CPU load of the 256000-row table takes about half a minute of numpy;
    the CPU tests hold the two loads equal at a small width, and the first
    4096 rows of the card's table are held here against the file's numpy
    dequantization); then the single-stream path over a bf16 cache (a
    16-row prefill, then decode steps: the GELU gate-up's matvec pair, the
    256-lane decode attention and append) and the batched path over an
    int8 cache (4 slots, 2 live, T = 32: the GELU tile, the 256-lane
    chunked prefill and int8 decode), the CPU's plain versions against the
    card's kernels (launches: the path "parity (n)")."""
    import dataclasses

    import torch

    from booster_tpu_torch.gguf import GGUFReader
    from booster_tpu_torch.models.loader import _to_device
    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.ops.kv_cache import KVCache
    from booster_tpu_torch.quant import dequantize

    laps("n wait")
    card = _parity_model("gemma", "cuda", weights="native")
    models = {"cpu": dataclasses.replace(card, params=_to_device(card.params, torch.device("cpu")),
                                         device=torch.device("cpu")), "cuda": card}
    reader = GGUFReader(_gguf_path(LAYERS["gemma"], "gemma"))
    try:
        info = reader.tensors["token_embd.weight"]
        n = 4096 * info.shape[-1]
        rows = dequantize(reader.tensor_bytes(info)[:n * info.nbytes // (info.shape[0]
                                                                        * info.shape[-1])],
                          info.ggml_type, shape=(4096, info.shape[-1]))
    finally:
        reader.close()
    table = card.params["tok_embd"][:4096].cpu()
    if not torch.equal(table, torch.from_numpy(rows).to(torch.bfloat16)):
        raise AssertionError("parity gemma (n): the card's token table differs from the file's")
    cfg = card.cfg
    if card.params["output"] is not None or cfg.head_dim != 256 or cfg.act != "gelu":
        raise AssertionError(f"parity gemma (n): head {card.params['output']}, {cfg}")
    laps("n load")
    kernels.reset_counts()
    ids = models["cpu"].tokenizer.encode(PROMPT)
    caches = {dev: KVCache.create(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim, dev)
              for dev in models}
    got, want = _teacher_forced(models, caches, [ids], 16, [True], laps, "n",
                                steps=PARITY_7B_STEPS)
    res = {"single": _compare_logits("gemma (n) single", got, want, tol)}
    tok = models["cpu"].tokenizer
    prompts = [tok.encode("stream 0 benchmark prompt"), [],
               tok.encode("stream 2 benchmark prompt"), []]
    caches = {dev: KVCache.create(cfg.n_layers, 4, 512, cfg.n_kv_heads, cfg.head_dim, dev,
                                  quantized=True) for dev in models}
    got, want = _teacher_forced(models, caches, prompts, 32, [True, False, True, False], laps,
                                "n", steps=PARITY_7B_STEPS)
    res["batched"] = _compare_logits("gemma (n) batched", got, want, tol)
    counts = dict(kernels.launch_counts)
    res["card_launches"] = {k: v for k, v in counts.items() if v}
    need = ("qmm_i4t_gateup_gelu_gd", "qmm_i4t_gateup_gelu_dq", "decode_attn_d256",
            "kv_append_d256", "decode_attn_i8_d256", "kv_append_i8_d256", "prefill_attn_i8_d256")
    if not all(counts[k] for k in need) or counts["qmm_i4t_gateup_gd"] or counts[
            "qmm_i4t_gateup_dq"]:
        raise AssertionError(f"parity gemma (n): the card's launches {res['card_launches']}")
    out.setdefault("_paths", {})["parity (n)"] = (counts, dict(kernels.shape_counts))
    del models, caches, card
    laps("n check")
    return {"gemma_2b_width_bf16_cache_1_slot_and_int8_cache_4_slots": res}


def _parity_gemma8(tol: float, laps, out: dict, case: str) -> dict:
    """(o) Gemma-2B at 2 layers with weights="i8" (the first 2 layers of the
    18-layer Q4_0 file, the nibbles widened on the card to i8t at group 32)
    and (p) in llama.cpp's Q6_K mix (the first 2 layers of the 18-layer
    Q6_K file: i8t at group 16), loaded on the card and their params moved
    to the CPU, as (n): the single-stream path over a bf16 cache (the whole
    MLP with GELU at the 16-row prefill and at each step, the 256-lane
    decode attention and append) and the batched path over an int8 cache
    (4 slots, 2 live, T = 32: the MLP at 128 and 4 rows, the 256-lane
    chunked prefill and int8 decode); (o) also over a paged int8 pool of 4
    slots, 2 live (``Engine(paged=True, page_size=256)``: the paged
    attention and append at 256 lanes).  The CPU's plain versions against
    the card's kernels; the card's launches (the path "parity (o)" or
    "parity (p)") hold the MLP's GELU form at its group and no 4-bit
    kernel, int8 gate-up or other MLP form."""
    import dataclasses

    import torch

    from booster_tpu_torch.models.loader import _to_device
    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.ops.kv_cache import KVCache
    from booster_tpu_torch.ops.mlp import mlp_count_name
    from booster_tpu_torch.serving import Engine

    model, weights, G = ("gemma", "i8", 32) if case == "o" else ("gemma_q6k", "native", 16)
    laps(f"{case} wait")
    card = _parity_model(model, "cuda", weights=weights)
    models = {"cpu": dataclasses.replace(card, params=_to_device(card.params, torch.device("cpu")),
                                         device=torch.device("cpu")), "cuda": card}
    cfg = card.cfg
    kinds = {(v.kind, v.group) for v in card.params["layers"].values() if hasattr(v, "kind")}
    if kinds != {("i8t", G)} or card.params["output"] is not None or cfg.act != "gelu":
        raise AssertionError(f"parity gemma ({case}): weights {kinds}, head "
                             f"{card.params['output']}, act {cfg.act}")
    laps(f"{case} load")
    kernels.reset_counts()
    tok = models["cpu"].tokenizer
    caches = {dev: KVCache.create(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim, dev)
              for dev in models}
    got, want = _teacher_forced(models, caches, [tok.encode(PROMPT)], 16, [True], laps, case,
                                steps=PARITY_7B_STEPS)
    res = {"single": _compare_logits(f"gemma ({case}) single", got, want, tol)}
    prompts = [tok.encode("stream 0 benchmark prompt"), [],
               tok.encode("stream 2 benchmark prompt"), []]
    caches = {dev: KVCache.create(cfg.n_layers, 4, 512, cfg.n_kv_heads, cfg.head_dim, dev,
                                  quantized=True) for dev in models}
    got, want = _teacher_forced(models, caches, prompts, 32, [True, False, True, False], laps,
                                case, steps=PARITY_7B_STEPS)
    res["batched"] = _compare_logits(f"gemma ({case}) batched", got, want, tol)
    need = [mlp_count_name(G, "gelu"), "qmm_i8t_gd", "qmm_i8t_dq", "decode_attn_d256",
            "kv_append_d256", "decode_attn_i8_d256", "kv_append_i8_d256", "prefill_attn_i8_d256"]
    if case == "o":  # the server's paged int8 pool at 256 lanes, as (d) runs the 7B's
        caches = {}
        for dev, m in models.items():
            eng = Engine(m, max_batch=4, max_seq=512, kv_quantized=True, paged=True,
                         page_size=256)
            eng.init_batch_state()
            for s_ in (2, 0):
                eng.ensure_slot_pages(s_, 32 + 8)
            caches[dev] = eng.cache
        got, want = _teacher_forced(models, caches, prompts, 32, [True, False, True, False],
                                    laps, case, steps=PARITY_7B_STEPS)
        res["paged_int8_pool"] = _compare_logits(f"gemma ({case}) paged", got, want, tol)
        lengths = [caches[dev].lengths.tolist() for dev in ("cpu", "cuda")]
        expect = [len(prompts[0]) + PARITY_7B_STEPS, 0, len(prompts[2]) + PARITY_7B_STEPS, 0]
        if lengths != [expect, expect]:
            raise AssertionError(f"parity gemma ({case}) paged: cache lengths {lengths}")
        need += ["paged_attn_i8_d256", "kv_append_paged_i8_d256"]
    counts = dict(kernels.launch_counts)
    res["card_launches"] = {k: v for k, v in counts.items() if v}
    wrong = [k for k, v in counts.items() if v and (k.startswith(("qmm_i4t", "qmm_i8t_gateup"))
                                                  or k.startswith("mlp_i8t") and k != need[0])]
    if not all(counts[k] for k in need) or wrong:
        raise AssertionError(f"parity gemma ({case}): the card's launches {res['card_launches']}")
    out.setdefault("_paths", {})[f"parity ({case})"] = (counts, dict(kernels.shape_counts))
    del models, caches, card
    laps(f"{case} check")
    return {{"o": "gemma_2b_width_i8_weights", "p": "gemma_2b_width_q6_k"}[case]
            + "_bf16_cache_1_slot_and_int8_cache_4_slots": res}


def _parity_gemma7b(tol: float, laps, out: dict) -> dict:
    """(q) Gemma-7B at 2 layers with weights="i8": the first 2 layers of the
    4-layer Q4_0 file (the nibbles widened on the card to i8t at group 32),
    loaded on the card and its params moved to the CPU, as (n); the
    single-stream path over a bf16 cache with GEMMA7B_PROMPT, whose ids
    take the 256-row bucket (the reference's whole MLP declines from 142
    rows at these widths: the int8 gate-up with GELU, then the down), and
    PARITY_7B_STEPS decode steps (the whole MLP with GELU, the 256-lane
    decode attention at 16 kv heads, G = 1).  The CPU's plain versions
    against the card's kernels; the card's launches (the path "parity
    (q)") hold the gate-up's GELU tile form and the MLP's GELU form, and
    no 4-bit kernel, SiLU gate-up or SiLU MLP."""
    import dataclasses

    import torch

    from booster_tpu_torch.models.loader import _to_device
    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.ops.kv_cache import KVCache
    from booster_tpu_torch.ops.mlp import mlp_count_name
    from booster_tpu_torch.serving.engine import _bucket

    laps("q wait")
    card = _parity_model("gemma7b", "cuda", weights="i8")
    models = {"cpu": dataclasses.replace(card, params=_to_device(card.params, torch.device("cpu")),
                                         device=torch.device("cpu")), "cuda": card}
    cfg = card.cfg
    kinds = {(v.kind, v.group) for v in card.params["layers"].values() if hasattr(v, "kind")}
    shape = (cfg.n_embd, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_ff, cfg.act)
    if kinds != {("i8t", 32)} or card.params["output"] is not None or shape != (
            GEMMA_7B["hidden"], GEMMA_7B["heads"], GEMMA_7B["kv_heads"], GEMMA_7B["head_dim"],
            GEMMA_7B["ff"], "gelu"):
        raise AssertionError(f"parity gemma-7b (q): weights {kinds}, head "
                             f"{card.params['output']}, (C, H, Hkv, D, ff, act) {shape}")
    laps("q load")
    ids = models["cpu"].tokenizer.encode(GEMMA7B_PROMPT)
    T = _bucket(len(ids), 512)
    if T != GEMMA7B_PREFILL_M:
        raise AssertionError(f"parity gemma-7b (q): {len(ids)} ids take the {T}-row bucket, "
                             f"not {GEMMA7B_PREFILL_M}")
    kernels.reset_counts()
    caches = {dev: KVCache.create(cfg.n_layers, 1, 512, cfg.n_kv_heads, cfg.head_dim, dev)
              for dev in models}
    got, want = _teacher_forced(models, caches, [ids], T, [True], laps, "q",
                                steps=PARITY_7B_STEPS)
    res = {"single": _compare_logits("gemma-7b (q) single", got, want, tol), "prefill_T": T}
    counts = dict(kernels.launch_counts)
    res["card_launches"] = {k: v for k, v in counts.items() if v}
    need = ["qmm_i8t_gateup_gelu_dq", mlp_count_name(32, "gelu"), "qmm_i8t_gd", "qmm_i8t_dq",
            "decode_attn_d256", "kv_append_d256"]
    wrong = [k for k, v in counts.items() if v and (
        k.startswith(("qmm_i4t", "mlp_i8t")) and k != need[1]
        or k.startswith("qmm_i8t_gateup") and k != need[0])]
    if not all(counts[k] for k in need) or wrong:
        raise AssertionError(f"parity gemma-7b (q): the card's launches {res['card_launches']}")
    out.setdefault("_paths", {})["parity (q)"] = (counts, dict(kernels.shape_counts))
    del models, caches, card
    laps("q check")
    return {"gemma_7b_width_i8_weights_bf16_cache_1_slot_256_rows": res}


def _parity_gemma_mix(tol: float, laps, out: dict) -> dict:
    """(r) the narrow Gemma-shaped files of GEMMA_MIX (ffn_down Q6_K at group
    16 beside Q8_0, then Q5_K with mins, gate/up at group 32: the whole MLP
    declines at every M), loaded on both devices: the single-stream path
    over a bf16 cache (a 16-row prefill in the gate-up's tile form, then 3
    steps in its M = 1 matvec pair with GELU), the card's Engine.generate
    of 4 greedy tokens on the same prompt (equal to the CPU's greedy
    tokens up to a near-tie of the CPU's logits), and the 4-stream batched
    path over an int8 cache (the 64-row prefill, steps at M = 4), the CPU's
    plain versions against the card's kernels.  Each file's card launches
    (the paths "parity (r) q8_0" and "parity (r) q5_k") hold both GELU
    gate-up forms and no MLP kernel, SiLU gate-up or 4-bit kernel."""
    import torch

    from booster_tpu_torch.models import load_model
    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.ops.kv_cache import KVCache
    from booster_tpu_torch.sampling import SamplingParams
    from booster_tpu_torch.serving import Engine

    res = {}
    for model, tag, planes in (("gemma_mix", "q8_0", 1), ("gemma_mix_q5k", "q5_k", 2)):
        case = f"r {tag}"
        laps(f"{case} wait")
        path = _wait_gguf(model, 2)[0]
        models = _both(lambda dev: load_model(path, device=dev))
        card, cfg = models["cuda"], models["cuda"].cfg
        lay = card.params["layers"]
        forms = {k: (lay[k].kind, lay[k].group, lay[k].scales.shape[-3])
                 for k in ("w_gateup", "w_down")}
        if forms != {"w_gateup": ("i8t", 32, planes), "w_down": ("i8t", 16, 1)} \
                or (cfg.n_kv_heads, cfg.head_dim, cfg.act) != (4, 256, "gelu"):
            raise AssertionError(f"parity gemma ({case}): weights {forms}, {cfg}")
        laps(f"{case} load")
        kernels.reset_counts()
        tok = models["cpu"].tokenizer
        ids = tok.encode(PROMPT)
        caches = {dev: KVCache.create(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim, dev)
                  for dev in models}
        got, want = _teacher_forced(models, caches, [ids], 16, [True], laps, case, steps=3)
        r = {"single": _compare_logits(f"gemma ({case}) single", got, want, tol)}
        gen = Engine(card, max_batch=1, max_seq=256, decode_chunk=4).generate(
            ids, SamplingParams(temp=0.0), max_new_tokens=4)
        w = want[:, 0]  # [steps + 1, V]: the CPU's logits along its own greedy tokens
        top2 = torch.topk(w, 2, dim=-1).values
        clear = ((top2[:, 0] - top2[:, 1]) / w.abs().amax(-1) > tol).tolist()
        cpu_tokens = torch.argmax(w, -1).tolist()
        n_same = next((i for i, (a, b) in enumerate(zip(gen.token_ids, cpu_tokens)) if a != b),
                      len(cpu_tokens))
        if len(gen.token_ids) != 4 or n_same < 4 and clear[n_same]:
            raise AssertionError(f"parity gemma ({case}): the card's generate gave "
                                 f"{gen.token_ids}, the CPU's greedy tokens {cpu_tokens}")
        r["generate_tokens_equal"] = f"{n_same}/4"
        prompts = [tok.encode(f"stream {s} the end") for s in range(4)]
        caches = {dev: KVCache.create(cfg.n_layers, 4, 256, cfg.n_kv_heads, cfg.head_dim, dev,
                                      quantized=True) for dev in models}
        got, want = _teacher_forced(models, caches, prompts, 16, [True] * 4, laps, case,
                                    steps=2)
        r["batched"] = _compare_logits(f"gemma ({case}) batched", got, want, tol)
        counts = dict(kernels.launch_counts)
        r["card_launches"] = {k: v for k, v in counts.items() if v}
        need = ("qmm_i8t_gateup_gelu_gd", "qmm_i8t_gateup_gelu_dq")
        wrong = [k for k, v in counts.items() if v and (
            k.startswith(("qmm_i4t", "mlp_i8t")) or k.startswith("qmm_i8t_gateup")
            and k not in need)]
        if not all(counts[k] for k in need) or wrong:
            raise AssertionError(f"parity gemma ({case}): the card's launches "
                                 f"{r['card_launches']}")
        out.setdefault("_paths", {})[f"parity (r) {tag}"] = (counts, dict(kernels.shape_counts))
        res[tag] = r
        del models, caches, card
        laps(f"{case} check")
    return {"gemma_narrow_q6_k_down_bf16_cache_1_slot_and_int8_cache_4_slots": res}


def _parity_q6k(tol: float, laps) -> dict:
    """(g) the DeepSeek-Coder-1.3B width at 2 layers as llama.cpp's Q6_K
    file (Q8_0 ffn_down): loaded on the CPU and the card with the
    reference's kinds (wqkv, wo, w_gateup and the head K-major i8t at group
    16, w_down lane-major i8 at group 32), then the single-stream path over
    a bf16 cache (a 16-row prefill, 6 decode steps: the M = 1 fused gate-up,
    the group-16 matvecs, the lane-major down, decode attention at G = 1)
    and the batched path over an int8 cache (4 slots, 2 live, T = 32: the
    dequant forms at group 16 and prefill attention at G = 1), the CPU
    (plain versions) against the card (kernels), fed the CPU's greedy
    tokens."""
    from booster_tpu_torch.ops.kv_cache import KVCache

    laps("g wait")
    models = _parity_models("q6k", weights="native")
    cfg = models["cpu"].cfg
    for dev, m in models.items():
        lay = m.params["layers"]
        got = {k: (lay[k].kind, lay[k].group) for k in ("wqkv", "wo", "w_gateup", "w_down")}
        got["output"] = (m.params["output"].kind, m.params["output"].group)
        want = dict.fromkeys(("wqkv", "wo", "w_gateup", "output"), ("i8t", 16)) | {
            "w_down": ("i8", 32)}
        if got != want or (cfg.rope_scaling, cfg.rope_scale) != ("linear", 4.0):
            raise AssertionError(f"parity q6k on {dev}: weights {got}, rope "
                                 f"{cfg.rope_scaling} {cfg.rope_scale}")
    laps("g load")
    tok = models["cpu"].tokenizer
    out = {}
    caches = {dev: KVCache.create(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim, dev)
              for dev in models}
    got, want = _teacher_forced(models, caches, [tok.encode(PROMPT)], 16, [True], laps, "g",
                                steps=6)
    out["q6_k_1.3b_width_bf16_cache_1_slot"] = _compare_logits("q6_k single", got, want, tol)
    prompts = [tok.encode("stream 0 benchmark prompt"), [],
               tok.encode("stream 2 benchmark prompt"), []]
    T = max(16, 1 << (max(len(p) for p in prompts) - 1).bit_length())
    caches = {dev: KVCache.create(cfg.n_layers, 4, 512, cfg.n_kv_heads, cfg.head_dim, dev,
                                  quantized=True) for dev in models}
    laps("g check")
    got, want = _teacher_forced(models, caches, prompts, T, [True, False, True, False], laps,
                                "g", steps=6)
    out["q6_k_1.3b_width_int8_cache_4_slots_2_live"] = _compare_logits("q6_k batched", got,
                                                                      want, tol)
    del models, caches
    laps("g check")
    return out


def _parity_mpt(tol: float, laps) -> dict:
    """(h) MPT-7B's width at 2 layers (Q4_0, a Q6_K head, ALiBi, LayerNorm,
    GELU), loaded natively on the CPU and the card: the single-stream path
    over a bf16 cache of 256 rows and the batched path over an int8 cache
    (4 slots, 2 live, 512 rows), where each decode step writes each layer's
    row with the per-layer append (counted on the card: 2 a step, and no
    stacked decode attention or all-layer append), and a bf16 cache of 200
    rows (no multiple of 128: the plain row writes); 2 decode steps each,
    the CPU (plain versions) against the card (kernels), fed the CPU's
    greedy tokens."""
    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.ops.kv_cache import KVCache

    laps("h wait")
    models = _parity_models("mpt", weights="native")
    cfg = models["cpu"].cfg
    for dev, m in models.items():
        lay = m.params["layers"]
        got = {k: (lay[k].kind, lay[k].group) for k in ("wqkv", "wo", "w_up", "w_down")}
        got["output"] = (m.params["output"].kind, m.params["output"].group)
        want = dict.fromkeys(("wqkv", "wo", "w_up", "w_down"), ("i4t", 32)) | {
            "output": ("i8t", 16)}
        if got != want or (cfg.arch, cfg.alibi_max_bias, cfg.norm_type) != ("mpt", 8.0, "layer"):
            raise AssertionError(f"parity mpt on {dev}: weights {got}, config {cfg.arch} "
                                 f"{cfg.alibi_max_bias} {cfg.norm_type}")
    laps("h load")
    tok = models["cpu"].tokenizer
    prompts = [tok.encode("stream 0 benchmark prompt"), [],
               tok.encode("stream 2 benchmark prompt"), []]
    cases = (("mpt_7b_width_bf16_cache_1_slot", [tok.encode(PROMPT)], [True], 256, False),
             ("mpt_7b_width_int8_cache_4_slots_2_live", prompts, [True, False, True, False],
              512, True),
             ("mpt_7b_width_bf16_cache_of_200_rows", [tok.encode(PROMPT)], [True], 200, False))
    steps = 2
    out = {}
    for key, ps, live, S, quant in cases:
        T = max(16, 1 << (max(len(p) for p in ps) - 1).bit_length())
        caches = {dev: KVCache.create(cfg.n_layers, len(ps), S, cfg.n_kv_heads, cfg.head_dim, dev,
                                      quantized=quant) for dev in models}
        kernels.reset_counts()
        got, want = _teacher_forced(models, caches, ps, T, live, laps, "h", steps=steps)
        out[key] = _compare_logits(key, got, want, tol)
        counts = {k: v for k, v in kernels.launch_counts.items()
                  if v and k.startswith(("kv_append", "decode_attn", "prefill_attn"))}
        expect = ({} if S % 128 else
                  {"kv_append_layer_i8" if quant else "kv_append_layer": cfg.n_layers * steps})
        if counts != expect:
            raise AssertionError(f"parity {key}: cache kernels {counts} != {expect}")
        out[key]["cache_kernel_launches"] = counts
    del models, caches
    laps("h check")
    return out


# -- phase 4 -----------------------------------------------------------------


def _profile(run, steps: int, watch=(), forbid=()) -> dict:
    """One more run of a path under torch.profiler: the kernels' device time (the
    sum over CUDA kernel events; one stream, so they do not overlap), their
    count per decoded token, the kernels that take the most time, and for
    each name in `watch` the time, count and share of the kernel time of the
    kernels whose names hold it (a name "re:<pattern>": whose names match
    the regular expression); a kernel whose name matches a pattern of
    `forbid` fails the run (a form the path must not take).  The
    profiler stretches the host side, so shares are taken against the wall
    time of the unprofiled run by the caller.  The device events are summed
    from the trace's own records: key_averages() first builds a Python event
    tree of every record, up to half a minute a trace on these paths."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # kernels only: a
        run()  # trace of the host ops too takes minutes to sum at ~1,400 launches a step
    t1 = time.perf_counter()
    by_name: dict = {}  # kernel name → [ns, count]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            acc = by_name.setdefault(e.name(), [0, 0])
            acc[0] += e.duration_ns()
            acc[1] += 1
    rows = sorted(((k[:70], ns / 1e6, n) for k, (ns, n) in by_name.items()), key=lambda r: -r[1])
    secs = {"trace_s": t1 - t0, "sum_s": time.perf_counter() - t1}
    if not rows:
        return {"kernel_ms": None, "note": "the trace held no device events", **secs}
    kernel_ms = sum(r[1] for r in rows)

    def hit(w, k):
        return re.search(w[3:], k) is not None if w.startswith("re:") else w in k

    watched = {}
    for w in watch:
        ms = sum(ns for k, (ns, _) in by_name.items() if hit(w, k)) / 1e6
        watched[w] = {"ms": ms, "launches": sum(n for k, (_, n) in by_name.items() if hit(w, k)),
                      "share_of_kernel_ms": ms / kernel_ms}
        if not watched[w]["launches"]:  # the path's counts saw it: the name is wrong
            raise AssertionError(f"profile: no kernel named like {w!r} in the trace")
    for f in forbid:
        seen = [k for k in by_name if re.search(f, k)]
        if seen:
            raise AssertionError(f"profile: the path launched {seen[:3]}, a form it must not take")
    return {**secs, "kernel_ms": kernel_ms,
            "kernel_launches_per_decoded_token": sum(r[2] for r in rows) / steps,
            "top_kernels_ms": [[k, round(ms, 3), n] for k, ms, n in rows[:12]],
            **({"watched": watched} if watch else {})}


_writer: dict = {}  # "proc": the process writing the GGUFs the phases need
_big: dict = {}  # model → the full-depth model, loaded once for its phases


def _start_writer(jobs: list) -> None:
    """Write the GGUFs of `jobs` ((model, layers) in the order the phases
    need them) one after another in a process of its own while the earlier
    phases run: the TinyLlama's seeded normal draws take ~30 s of numpy, the
    7B's 3 minutes, the Mixtral's 16.5 GB of blocks under a minute."""
    todo = [f"{m}:{n}" for m, n in jobs if not _gguf_path(n, m).exists()]
    if todo:
        _writer["proc"] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--write-gguf", ",".join(todo)],
            stdout=subprocess.DEVNULL)


def _write_ggufs(jobs: str) -> None:
    """The writer process: each GGUF of `jobs` ("model:layers,..."), then
    the seconds it took beside it (<file>.seconds)."""
    for job in jobs.split(","):
        model, layers = job.split(":")
        t0 = time.perf_counter()
        path = _gguf(int(layers), model)
        Path(path + ".seconds").write_text(str(time.perf_counter() - t0))


def _wait_gguf(model: str, layers: int) -> tuple[str, Optional[float]]:
    """The GGUF's path once it is there, and the seconds its writer took
    (None when this process wrote it)."""
    path = _gguf_path(layers, model)
    proc = _writer.get("proc")
    while proc is not None and not path.exists() and proc.poll() is None:
        time.sleep(0.2)
    if proc is not None and not path.exists() and proc.returncode:
        raise RuntimeError(f"writing the GGUFs failed ({proc.returncode})")
    seconds = Path(str(path) + ".seconds")
    return _gguf(layers, model), float(seconds.read_text()) if seconds.exists() else None


def _rss_gb() -> tuple[float, str]:
    """This process's resident memory in GB and the /proc/self/status field
    it came from: RssAnon (numpy and torch host buffers, the GGUF's mapped
    pages excluded) where the kernel reports it, else VmRSS."""
    fields = dict(line.split(":", 1) for line in
                  Path("/proc/self/status").read_text().splitlines() if ":" in line)
    key = "RssAnon" if "RssAnon" in fields else "VmRSS"
    return int(fields[key].split()[0]) / 2**20, key


def _big_model(model: str, layers: int = 32, weights: str = "auto"):
    """A full-depth model through load_model(weights=`weights`) with no batch
    hint: "auto", as bench.py loads it, gives config 3's 7B Q8_0 model
    ("q8", native i8t throughout) or the Mixtral-8x7B shape ("moe": i4t
    attention and lm head, lane-major i4p expert stacks); "i8c" the 7B
    model requantized per channel on the card.  Loaded once per (model,
    weights); beside the load, the peak of its resident memory is sampled
    (which counts the GGUF's pages where the kernel reports no RssAnon),
    tracemalloc's peak of the host memory it holds in numpy arrays and
    Python objects, and the card's peak memory."""
    import threading

    import torch

    from booster_tpu_torch.models import load_model

    key = (model, weights)
    if key not in _big:
        t0 = time.perf_counter()
        path, build_s = _wait_gguf(model, layers)
        t1 = time.perf_counter()
        rss0, field = _rss_gb()
        peak, done = [rss0], threading.Event()

        def sample():
            while not done.wait(0.02):
                peak[0] = max(peak[0], _rss_gb()[0])

        watcher = threading.Thread(target=sample, daemon=True)
        watcher.start()
        tracemalloc.start()
        torch.cuda.reset_peak_memory_stats()
        try:
            m = load_model(path, device="cuda", weights=weights)
        finally:
            traced_peak = tracemalloc.get_traced_memory()[1] / 2**30
            tracemalloc.stop()
            done.set()
            watcher.join()
        # wait_s: how long this phase waited for the file (the writer's
        # seconds that the earlier phases did not cover)
        _big[key] = dict(model=m, build_s=t1 - t0 if build_s is None else build_s,
                         wait_s=t1 - t0, load_s=time.perf_counter() - t1,
                         load_rss_gb={"field": field, "before": rss0, "peak": peak[0],
                                      "after": _rss_gb()[0],
                                      "numpy_and_python_peak": traced_peak},
                         load_max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30)
        kinds = {k: (v.kind, v.group) for k, v in m.params["layers"].items()
                 if hasattr(v, "kind")}
        if m.params["output"] is not None:  # Gemma ties its head to the token table
            kinds["output"] = (m.params["output"].kind, m.params["output"].group)
        if weights == "i8c":
            kinds = {k: kind for k, (kind, _) in kinds.items()}
            want = dict.fromkeys(kinds, "i8c")
        elif model == "q8":
            want = dict.fromkeys(kinds, ("i8t", 32))
        elif model == "q6k":  # the reference's kinds for llama.cpp's Q6_K mix
            want = dict.fromkeys(kinds, ("i8t", 16)) | {"w_down": ("i8", 32)}
        elif model == "q5k":  # llama.cpp's Q5_K_S mix: Q5_K, a Q6_K head, a Q5_1 down
            want = dict.fromkeys(kinds, ("i8t", 32)) | {"w_down": ("i8", 32),
                                                         "output": ("i8t", 16)}
            planes = {k: v.scales.shape[-3 if v.kind == "i8t" else -2]
                      for k, v in m.params["layers"].items() if hasattr(v, "kind")}
            if set(planes.values()) != {2} or m.params["output"].scales.shape[-3] != 1:
                raise AssertionError(f"{model}: scale planes {planes}, not two (scales, mins)")
        elif model == "mpt":  # llama.cpp's Q4_0 mix: Q4_0 layers, a Q6_K head
            want = dict.fromkeys(kinds, ("i4t", 32)) | {"output": ("i8t", 16)}
        elif model == "q2k":  # llama.cpp's Q2_K mix: i4t at group 16 (Q2_K with mins,
            # Q3_K with zero 4), the Q4_K v at 32, a Q6_K head; q, k, v unfused
            want = {"wq": ("i4t", 16), "wk": ("i4t", 16), "wv": ("i4t", 32),
                    "wo": ("i4t", 16), "w_gateup": ("i4t", 16), "w_down": ("i4t", 16),
                    "output": ("i8t", 16)}
            lay = m.params["layers"]
            forms = {k: (lay[k].scales.shape[-3], lay[k].zero) for k in want if k != "output"}
            if forms != {"wq": (4, 0), "wk": (4, 0), "wv": (4, 0), "wo": (2, 4),
                         "w_gateup": (4, 0), "w_down": (2, 4)}:
                raise AssertionError(f"{model}: (planes, zero) {forms}")
        elif model in ("gemma", "gemma_q6k", "gemma7b"):  # llama.cpp's Q4_0 mix (with
            # weights="i8" widened to i8t at group 32) or Q6_K mix (i8t at group 16),
            # no head: the bf16 token table
            want = dict.fromkeys(kinds, ("i8t", 32) if weights == "i8" else (
                ("i8t", 16) if model == "gemma_q6k" else ("i4t", 32)))
            emb = m.params["tok_embd"]
            conf = GEMMA_7B if model == "gemma7b" else GEMMA_2B
            if m.params["output"] is not None or emb.dtype != torch.bfloat16 or tuple(
                    emb.shape) != (conf["vocab_size"], conf["hidden"]):
                raise AssertionError(f"{model}: head {m.params['output']}, table {emb.shape}")
        elif model == "q4k":  # every weight K-major i4t with Q4_K's four planes
            want = dict.fromkeys(kinds, ("i4t", 32))
            planes = {k: v.scales.shape[-3] for k, v in m.params["layers"].items()
                      if hasattr(v, "kind")} | {"output": m.params["output"].scales.shape[-3]}
            if set(planes.values()) != {4}:
                raise AssertionError(f"{model}: scale planes {planes}, not four (scales, mins)")
        else:
            want = dict.fromkeys(kinds, ("i4t", 32)) | {
                "router": ("dense", 1), "gate_exps": ("i4p", 32), "up_exps": ("i4p", 32),
                "down_exps": ("i4p", 32)}
        if kinds != want:
            raise AssertionError(f"{model}: weights={weights} gave {kinds}, not {want}")
    return _big[key]


class _FallbackCount:
    """Counts the dequantize-matmul fallbacks of ops.qmm.qmm (its calls of
    dequantize) while it is entered."""

    def __enter__(self):
        from booster_tpu_torch.ops import qmm as tq

        self.mod, self.orig, self.calls = tq, tq.dequantize, 0

        def counted(*a, **kw):
            self.calls += 1
            return self.orig(*a, **kw)

        tq.dequantize = counted
        return self

    def __exit__(self, *exc):
        self.mod.dequantize = self.orig


# the engine phases: phase → (model, load_model's weights; None: the phase's own rule)
GENERATE = {"generate": ("tiny", None), "generate_q8": ("q8", None),
            "generate_moe": ("moe", None), "generate_i8": ("tiny", "i8"),
            "generate_i8c": ("q8", "i8c"), "generate_q6k": ("q6k", "native"),
            "generate_q5k": ("q5k", "native"), "generate_mpt": ("mpt", "native"),
            "generate_q2k": ("q2k", "native"), "generate_gemma": ("gemma", "native"),
            "generate_gemma_i8": ("gemma", "i8"), "generate_gemma_q6k": ("gemma_q6k", "native"),
            "generate_gemma7b_i8": ("gemma7b", "i8")}
BATCH = {"batch": ("tiny", None), "batch_q8": ("q8", None), "batch_moe": ("moe", None),
         "batch_i8c": ("q8", "i8c"), "batch_q6k": ("q6k", "native"),
         "batch_q5k": ("q5k", "native"), "batch_mpt": ("mpt", "native"),
         "batch_q2k": ("q2k", "native"), "batch_gemma": ("gemma", "native"),
         "batch_gemma_q6k": ("gemma_q6k", "native"), "batch_gemma7b_i8": ("gemma7b", "i8")}


def phase_generate(layers: int, model_name: str = "tiny", weights: Optional[str] = None) -> dict:
    """The single-stream generate: TinyLlama Q4_0 ("tiny"; with weights
    "i8", phase generate_i8), the 7B Q8_0 model ("q8", phase generate_q8;
    with weights "i8c", phase generate_i8c), the DeepSeek-Coder-1.3B Q6_K
    mix ("q6k", native, phase generate_q6k) or its Q5_K_S mix ("q5k", native,
    phase generate_q5k), MPT-7B ("mpt", native, phase generate_mpt), the
    Mixtral-8x7B shape ("moe", phase generate_moe), Gemma-2B ("gemma",
    "gemma_q6k") or Gemma-7B ("gemma7b" with weights "i8": a prompt of
    GEMMA7B_PREFILL_M rows)."""
    import torch

    from booster_tpu_torch.models import load_model
    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.ops.mlp import mlp_count_name
    from booster_tpu_torch.sampling import SamplingParams
    from booster_tpu_torch.serving import Engine
    from booster_tpu_torch.serving.engine import _bucket

    t0 = time.perf_counter()
    laps = _Laps()
    t_wait = load_rss = None
    name = {v: k for k, v in GENERATE.items()}[(model_name, weights)]
    q8, moe, q6k = model_name == "q8" and weights is None, model_name == "moe", model_name == "q6k"
    mpt, q5k, q2k = model_name == "mpt", model_name == "q5k", model_name == "q2k"
    gemma7b = model_name == "gemma7b"
    gemma = model_name in ("gemma", "gemma_q6k", "gemma7b")
    gemma8 = gemma and (weights == "i8" or model_name == "gemma_q6k")  # int8 weights
    load_gpu_gb = None
    torch.cuda.reset_peak_memory_stats()
    if model_name in ("q8", "moe", "q6k", "mpt", "q5k", "q2k", "gemma", "gemma_q6k", "gemma7b"):
        big = _big_model(model_name, layers, weights or "auto")
        model, t_build, t_load = big["model"], big["build_s"], big["load_s"]
        t_wait, load_rss = big["wait_s"], big["load_rss_gb"]
        load_gpu_gb = big["load_max_memory_allocated_gb"]
    else:
        path, t_build = _wait_gguf("tiny", layers)
        t_wait = time.perf_counter() - t0
        model = load_model(path, device="cuda", weights=weights or "native")
        t_load = time.perf_counter() - t0 - t_wait
    eng = Engine(model, max_batch=1, max_seq=1024, decode_chunk=128)
    ids = model.tokenizer.encode(GEMMA7B_PROMPT if gemma7b else PROMPT)
    if gemma7b and _bucket(len(ids), eng.max_seq) != GEMMA7B_PREFILL_M:
        raise AssertionError(f"{name}: {len(ids)} prompt ids do not take the "
                             f"{GEMMA7B_PREFILL_M}-row bucket the kernels phase times")
    sp = SamplingParams(temp=0.0)
    laps("load")
    eng.generate(ids, sp, max_new_tokens=128)  # warm-up: first calls of every op
    torch.cuda.synchronize()
    laps("warm-up")
    kernels.reset_counts()
    t_run = time.perf_counter()
    with _FallbackCount() as fallbacks:
        res = eng.generate(ids, sp, max_new_tokens=128)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t_run)
    counts = dict(kernels.launch_counts)
    shape_counts = dict(kernels.shape_counts)
    shapes = {f"{k[0]}:{k[1][0]}x{k[1][1]}": v for k, v in shape_counts.items()}
    steps = 128  # one chunk of decode_chunk steps runs whatever the host keeps
    L = layers
    mlp_gelu = mlp_count_name(16 if model_name == "gemma_q6k" else 32, "gelu")
    if gemma7b:  # Gemma-7B's 256-row prefill: qkv, wo, the int8 gate-up with GELU (the
        # whole MLP declines from 142 rows at these widths) and the down in the tile;
        # per step qkv and wo on the int8 matvec, the whole MLP with GELU, the 256-lane
        # decode attention and append; the tied head one torch product (no kernel)
        expected = dict.fromkeys(counts, 0) | {
            "qmm_i8t_gd": 2 * L * steps, "qmm_i8t_dq": 3 * L, "qmm_i8t_gateup_gelu_dq": L,
            mlp_gelu: L * steps, "decode_attn_d256": L * steps, "kv_append_d256": steps}
    elif gemma8:  # qkv and wo on the int8 matvec, the whole MLP with GELU at every M (group
        # 32: Q4_0 widened by weights="i8"; 16: Q6_K), the 256-lane decode attention
        # and append; the tied head one torch product (no kernel)
        expected = dict.fromkeys(counts, 0) | {
            "qmm_i8t_gd": 2 * L * steps, "qmm_i8t_dq": 2 * L, mlp_gelu: L * (steps + 1),
            "decode_attn_d256": L * steps, "kv_append_d256": steps}
    elif q8 or weights == "i8":  # qkv and wo per layer + the lm head, and the whole MLP
        expected = dict.fromkeys(counts, 0) | {
            "qmm_i8t_gd": (2 * L + 1) * steps + 1, "qmm_i8t_dq": 2 * L,
            "mlp_i8t": L * steps + L, "decode_attn": L * steps, "kv_append": steps}
    elif moe:  # qkv and wo per layer + the lm head; gate, up, down of the experts
        expected = dict.fromkeys(counts, 0) | {
            "qmm_i4t_gd": (2 * L + 1) * steps + 1, "qmm_i4t_dq": 2 * L,
            "moe_qmm_i4p": 3 * L * (steps + 1), "decode_attn": L * steps, "kv_append": steps}
    elif weights == "i8c":  # qkv, wo, gate-up, down per layer + the lm head, unfused
        expected = dict.fromkeys(counts, 0) | {
            "qmm_i8c_mv": (4 * L + 1) * steps + 1, "qmm_i8c_mm": 4 * L,
            "decode_attn": L * steps, "kv_append": steps}
    elif q6k or q5k:  # the reference's dispatch for a K-major gate-up beside a
        # lane-major down (qmm_mlp declines, pallas_qmm.py:1320, :1338;
        # qmm_gateup takes M = 1 in the group-dot form, :1083): per step the
        # qkv, wo and lm head matvecs, the fused gate-up and the lane-major
        # down of each layer (Q5_K_S: the mins forms, the head's G16 without)
        expected = dict.fromkeys(counts, 0) | {
            "qmm_i8t_gd": (2 * L + 1) * steps + 1, "qmm_i8t_dq": 2 * L,
            "qmm_i8t_gateup_gd": L * steps, "qmm_i8t_gateup_dq": L,
            "qmm_i8_mv": L * (steps + 1), "decode_attn": L * steps, "kv_append": steps}
    elif q2k:  # llama.cpp's Q2_K mix: per step q and k (G16 with mins), v (Q4_K's
        # G32), wo and down (G16, zero 4) and the fused gate-up (G16 with mins)
        # on the M = 1 kernels, the Q6_K head in the group-16 i8t matvec; at
        # the prefill the tile's forms and the head on the last row
        expected = dict.fromkeys(counts, 0) | {
            "qmm_i4t_g16m_gd": 2 * L * steps, "qmm_i4t_gd": L * steps,
            "qmm_i4t_g16_gd": 2 * L * steps, "qmm_i4t_gateup_g16m_gd": L * steps,
            "qmm_i4t_g16m_dq": 2 * L, "qmm_i4t_dq": L, "qmm_i4t_g16_dq": 2 * L,
            "qmm_i4t_gateup_g16m_dq": L, "qmm_i8t_gd": steps + 1,
            "decode_attn": L * steps, "kv_append": steps}
    elif gemma:  # qkv, wo and down on the M = 1 matvec, the gate-up with its GELU
        # epilogue; at the 16-row prefill the tile's forms; the 256-lane decode
        # attention and append; the tied head one torch product (no kernel)
        expected = dict.fromkeys(counts, 0) | {
            "qmm_i4t_gd": 3 * L * steps, "qmm_i4t_dq": 3 * L,
            "qmm_i4t_gateup_gelu_gd": L * steps, "qmm_i4t_gateup_gelu_dq": L,
            "decode_attn_d256": L * steps, "kv_append_d256": steps}
    elif mpt:  # ALiBi closes the fused decode gate (llama.py:96): each step runs the
        # masked layer loop, whose update_layer takes the per-layer append
        # (kv_cache.py:137-143) and whose attention is plain; qkv, wo, up and
        # down per layer (no gate), the Q6_K head in the group-16 matvec
        expected = dict.fromkeys(counts, 0) | {
            "qmm_i4t_gd": 4 * L * steps, "qmm_i4t_dq": 4 * L, "qmm_i8t_gd": steps + 1,
            "kv_append_layer": L * steps}
    else:
        expected = dict.fromkeys(counts, 0) | {
            "qmm_i4t_gd": (3 * L + 1) * steps + 1, "qmm_i4t_dq": 3 * L,
            "qmm_i4t_gateup_gd": L * steps, "qmm_i4t_gateup_dq": L,
            "decode_attn": L * steps, "kv_append": steps}
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    if mpt:  # per shape: qkv, wo, up and down each step; the head each step and at the prefill
        C, V, FF = model.cfg.n_embd, model.cfg.n_vocab, model.cfg.n_ff
        by = {k: v for k, v in shape_counts.items() if k[0] in ("qmm_i4t_gd", "qmm_i8t_gd")}
        want = {("qmm_i4t_gd", (C, 3 * C)): L * steps, ("qmm_i4t_gd", (C, C)): L * steps,
                ("qmm_i4t_gd", (C, FF)): L * steps, ("qmm_i4t_gd", (FF, C)): L * steps,
                ("qmm_i8t_gd", (C, V)): steps + 1}
        if by != want:
            raise AssertionError(f"{name}: group-dot launches by shape {by} != {want}")
    if q6k:  # per shape: qkv and wo each step, the lm head each step and at the prefill
        C, V = model.cfg.n_embd, model.cfg.n_vocab
        gd = {k[1]: v for k, v in shape_counts.items() if k[0] == "qmm_i8t_gd"}
        want = {(C, 3 * C): L * steps, (C, C): L * steps, (C, V): steps + 1}
        if gd != want:
            raise AssertionError(f"{name}: group-dot launches by shape {gd} != {want}")
    if q5k:  # every matmul launch by shape: the mins forms at M = 1 (each step) and
        # at the 16-row prefill, the Q6_K head's matvec (each step and the prefill)
        C, V, FF = model.cfg.n_embd, model.cfg.n_vocab, model.cfg.n_ff
        want = {("qmm_i8t_gd", (C, 3 * C)): L * steps, ("qmm_i8t_gd", (C, C)): L * steps,
                ("qmm_i8t_gd", (C, V)): steps + 1, ("qmm_i8t_dq", (C, 3 * C)): L,
                ("qmm_i8t_dq", (C, C)): L, ("qmm_i8t_gateup_gd", (C, 2 * FF)): L * steps,
                ("qmm_i8t_gateup_dq", (C, 2 * FF)): L, ("qmm_i8_mv", (FF, C)): L * (steps + 1)}
        if shape_counts != want:
            raise AssertionError(f"{name}: launches by shape {shape_counts} != {want}")
    if q2k:  # every matmul launch by shape: q 4096 → 4096 and wo share a shape, not a form
        C, V, FF = model.cfg.n_embd, model.cfg.n_vocab, model.cfg.n_ff
        nkv = model.cfg.n_kv_heads * model.cfg.head_dim
        want = {}
        for form, n in (("gd", L * steps), ("dq", L)):
            want |= {(f"qmm_i4t_g16m_{form}", (C, C)): n, (f"qmm_i4t_g16m_{form}", (C, nkv)): n,
                     (f"qmm_i4t_{form}", (C, nkv)): n, (f"qmm_i4t_g16_{form}", (C, C)): n,
                     (f"qmm_i4t_g16_{form}", (FF, C)): n,
                     (f"qmm_i4t_gateup_g16m_{form}", (C, 2 * FF)): n}
        want[("qmm_i8t_gd", (C, V))] = steps + 1
        if shape_counts != want:
            raise AssertionError(f"{name}: launches by shape {shape_counts} != {want}")
    if gemma8:  # every launch by shape: qkv and wo each step and at the prefill, the MLP
        C, Dh = model.cfg.n_embd, model.cfg.head_dim
        nq, nqkv = model.cfg.n_heads * Dh, (model.cfg.n_heads + 2 * model.cfg.n_kv_heads) * Dh
        want = {("qmm_i8t_gd", (C, nqkv)): L * steps, ("qmm_i8t_gd", (nq, C)): L * steps,
                ("qmm_i8t_dq", (C, nqkv)): L, ("qmm_i8t_dq", (nq, C)): L,
                (mlp_gelu, (C, C)): L * (steps + 1)}
        if gemma7b:  # the prefill's gate-up and down in place of its MLP
            FF = model.cfg.n_ff
            want |= {(mlp_gelu, (C, C)): L * steps, ("qmm_i8t_gateup_gelu_dq", (C, 2 * FF)): L,
                     ("qmm_i8t_dq", (FF, C)): L}
        if shape_counts != want:
            raise AssertionError(f"{name}: launches by shape {shape_counts} != {want}")
    elif gemma:  # every matmul launch by shape: qkv, wo, down and the GELU gate-up
        C, FF, Dh = model.cfg.n_embd, model.cfg.n_ff, model.cfg.head_dim
        nq, nqkv = model.cfg.n_heads * Dh, (model.cfg.n_heads + 2 * model.cfg.n_kv_heads) * Dh
        want = {}
        for form, n in (("gd", L * steps), ("dq", L)):
            want |= {(f"qmm_i4t_{form}", (C, nqkv)): n, (f"qmm_i4t_{form}", (nq, C)): n,
                     (f"qmm_i4t_{form}", (FF, C)): n,
                     (f"qmm_i4t_gateup_gelu_{form}", (C, 2 * FF)): n}
        if shape_counts != want:
            raise AssertionError(f"{name}: launches by shape {shape_counts} != {want}")
    if weights and fallbacks.calls:
        raise AssertionError(f"{name}: {fallbacks.calls} matmuls took the dequantize path")
    # the trace covers a 32-token generate: summing one of 128 tokens (130 K
    # to 440 K kernel events) took up to a minute of the script's time limit
    laps("run")
    short = Engine(model, max_batch=1, max_seq=1024, decode_chunk=32)
    short.generate(ids, sp, max_new_tokens=32)
    torch.cuda.synchronize()
    t_short = time.perf_counter()
    short.generate(ids, sp, max_new_tokens=32)
    torch.cuda.synchronize()
    prof_wall = 1e3 * (time.perf_counter() - t_short)
    laps("window")
    # the i4t M = 1 kernels (matvec and gate-up) on the paths with 4-bit
    # K-major weights
    watch = (("i4mv::mv_kernel",) if weights is None and model_name in ("tiny", "moe") or mpt
             else ())
    if q5k:  # the mins forms: the matvec and gate-up, the lane-major down, the prefill's tile
        watch = ("i8mv::mv_kernel<32, true", "lane_mv_kernel<1, true>",
                 "dq_kernel<16, 32, false, true, 0>", "dq_kernel<16, 32, true, true, 0>")
    if q6k:  # the lane-major Q8_0 down on csrc/qmm_lane_i8.cu's matvec
        watch = ("lane_mv_kernel<1, false>",)
    if q2k:  # the group-16 matvecs (with mins, with zero 4), the prefill's tile at G 16
        watch = ("i4mv::mv_kernel<16, true", "i4mv::mv_kernel<16, false",
                 "mm_kernel<32, true, 16,", "mm_kernel<32, false, 16,")
    forbid = ()
    if q5k or q6k:  # the int8 down never on qmm_lane.cu's kernel
        forbid = (r"lane_kernel<false",)
    if gemma7b:  # the int8 gate-up's GELU tile at the 256-row prefill, the whole MLP's
        # GELU form at the steps' M = 1, the 256-lane decode attention; no SiLU gate-up
        # or MLP, no 4-bit kernel, no 128-lane attention
        watch = (r"re:dq_kernel<\d+, 32, true, false, 1>", "mlp_kernel<16, 32, false, 1>",
                 "decode_attn_kernel<false, false, 256>")
        forbid = (r"mlp_kernel<\d+, \d+, \w+, 0>", r"i4mv::|mm_kernel<",
                  r"dq_kernel<\d+, \d+, true, \w+, 0>", r"decode_attn_kernel<.*128>")
    elif gemma8:  # the whole MLP's GELU form at the steps' M = 1 and the 16-row prefill (both
        # 16 rows a tile), the 256-lane decode attention; no SiLU MLP, no 4-bit kernel,
        # no int8 gate-up, no 128-lane attention
        G = 16 if model_name == "gemma_q6k" else 32
        watch = (f"mlp_kernel<16, {G}, false, 1>", "decode_attn_kernel<false, false, 256>")
        forbid = (r"mlp_kernel<\d+, \d+, \w+, 0>", r"i4mv::|mm_kernel<",
                  r"dq_kernel<\d+, \d+, true",
                  r"decode_attn_kernel<.*128>")
    elif gemma:  # the GELU gate-up's matvec pair (i8mv::kGateUpGelu) and prefill tile (act
        # 1), the 256-lane decode attention; no SiLU gate-up, no 128-lane attention
        watch = (GELU_MV, "mm_kernel<32, true, 32, 1, false>",
                 "decode_attn_kernel<false, false, 256>")
        forbid = (SILU_MV, r"mm_kernel<\d+, true, 32, 0,", r"decode_attn_kernel<.*128>")
    prof = _profile(lambda: short.generate(ids, sp, max_new_tokens=32), steps=32,
                    watch=watch + (("::kv_append_kernel",) if mpt else ()), forbid=forbid)
    prof["window"] = "a 32-token generate (decode_chunk 32)"
    del short
    laps("profile")
    if prof["kernel_ms"] is not None:
        prof["device_busy_share"] = prof["kernel_ms"] / prof_wall
    V = model.cfg.n_vocab
    if not (len(res.token_ids) >= 1 and all(0 <= t < V for t in res.token_ids)):
        raise AssertionError("generate: bad token ids")
    if res.n_generated != 128 and res.finish_reason != "stop":
        raise AssertionError(f"generate: {res.n_generated} tokens, {res.finish_reason}")
    return {"phase": name, "seconds": time.perf_counter() - t0, "layers": layers,
            "weights": {"generate": "q4_0 (i4t)", "generate_q8": "q8_0 (i8t)",
                        "generate_moe": "q4_0 (i4t attention, i4p experts)",
                        "generate_i8": "q4_0 widened to int8 (i8t)",
                        "generate_i8c": "q8_0 requantized per channel (i8c)",
                        "generate_q6k": "q6_k (i8t g16) with q8_0 ffn_down (lane-major i8)",
                        "generate_q5k": "q5_k_s: q5_k (i8t g32 with mins), q5_1 ffn_down "
                                        "(lane-major i8 with mins), a q6_k head (i8t g16)",
                        "generate_mpt": "q4_0 (i4t) with a q6_k head (i8t g16)",
                        "generate_q2k": "q2_k mix: q2_k (i4t g16 with mins), q3_k wo and "
                                        "ffn_down (i4t g16, zero 4), a q4_k attn_v (i4t g32 "
                                        "with mins), a q6_k head (i8t g16)",
                        "generate_gemma": "q4_0 (i4t; the gate-up's GELU epilogue), a q6_k "
                                          "token table (dense bf16: the tied head)",
                        "generate_gemma_i8": "q4_0 widened to int8 (i8t g32; the whole MLP "
                                             "with GELU), a q6_k token table (the tied head)",
                        "generate_gemma_q6k": "q6_k (i8t g16; the whole MLP with GELU), a "
                                              "q6_k token table (the tied head)",
                        "generate_gemma7b_i8": "q4_0 widened to int8 (i8t g32; the gate-up "
                                               "with GELU at the 256-row prefill, the whole "
                                               "MLP with GELU at each step), a q6_k token "
                                               "table (the tied head)"}[name],
            "gguf_build_s": t_build, "gguf_wait_s": t_wait, "load_s": t_load,
            "load_rss_gb": load_rss, "load_max_memory_allocated_gb": load_gpu_gb,
            "dequantize_fallbacks": fallbacks.calls,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
            "n_prompt": res.n_prompt, "n_generated": res.n_generated,
            "finish_reason": res.finish_reason,
            "decode_tok_per_s": 1000.0 / res.gen_ms_per_token,
            "decode_ms_per_token": res.gen_ms_per_token,
            "prompt_ms_per_token": res.prompt_ms_per_token, "ttft_ms": res.ttft_ms,
            "launches": counts, "launches_per_decoded_token": {
                k: v / steps for k, v in counts.items() if k.endswith("_gd") or k in (
                    "decode_attn", "kv_append", "moe_qmm_i4p", "qmm_i8c_mv", "qmm_i8",
                    "kv_append_layer", "decode_attn_d256", "kv_append_d256")
                or k.startswith("mlp_i8t")},
            "launches_by_shape": shapes, "tokens_head": res.token_ids[:16],
            "wall_ms": wall_ms, "profile": prof, "part_s": laps.parts,
            "_shape_counts": shape_counts}


def phase_generate_q4k(layers: int) -> dict:
    """bench.py's config 2 on the port: the 32-layer Llama-3-8B-shaped Q4_K
    GGUF through ``load_model(weights="auto")`` (native: i4t with four
    planes), ``Engine(max_batch=1, max_seq=8192, decode_chunk=64)`` and a
    generate of 128 tokens of bench's prompt with ``SamplingParams(temp=0.8,
    janus=1, seed=0)`` after bench's warm-up; exact launch counts per kernel
    and per shape, no dequantize-path matmul; a 32-token window under
    torch.profiler (busy share); then the long run: a prompt of Q4K_LONG
    token ids (the 8192-row bucket; decode attention over ~7,000 cached
    rows) with 32 new tokens, after one warm-up of its prefill, its counts
    exact too."""
    import torch

    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.sampling import SamplingParams
    from booster_tpu_torch.serving import Engine
    from booster_tpu_torch.serving.engine import _bucket

    t0 = time.perf_counter()
    laps = _Laps()
    torch.cuda.reset_peak_memory_stats()
    big = _big_model("q4k", layers, "auto")
    model = big["model"]
    cfg = model.cfg
    L, C, FF, V = layers, cfg.n_embd, cfg.n_ff, cfg.n_vocab
    nqkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    eng = Engine(model, max_batch=1, max_seq=Q4K_MAX_SEQ, decode_chunk=Q4K_CHUNK)
    ids = eng.tokenizer.encode(Q4K_PROMPT)
    if _bucket(len(ids), Q4K_MAX_SEQ) != Q4K_PREFILL_M:
        raise AssertionError(f"bench's prompt: {len(ids)} ids do not take the "
                             f"{Q4K_PREFILL_M}-row bucket the kernels phase times")
    sp = SamplingParams(temp=0.8, janus=1, seed=0)
    laps("load")
    eng.generate(ids, sp, max_new_tokens=eng.decode_chunk + 1)  # bench.py's warm-up
    torch.cuda.synchronize()
    laps("warm-up")

    def expect(steps: int) -> tuple[dict, dict]:
        """Launch counts of a generate whose decode runs `steps` steps (the
        reference's dispatch, as phase_generate's Q4_0 rule: per step qkv,
        wo, down and the lm head in the group-dot matvec and the fused M = 1
        gate-up; at the prefill, of any bucket, the dequant tile for qkv, wo,
        down and the gate-up, the lm head on the last row), and the matmuls'
        counts by (kernel, (K, N))."""
        counts = {"qmm_i4t_gd": (3 * L + 1) * steps + 1, "qmm_i4t_dq": 3 * L,
                  "qmm_i4t_gateup_gd": L * steps, "qmm_i4t_gateup_dq": L,
                  "decode_attn": L * steps, "kv_append": steps}
        shapes = {("qmm_i4t_gd", (C, nqkv)): L * steps, ("qmm_i4t_gd", (C, C)): L * steps,
                  ("qmm_i4t_gd", (FF, C)): L * steps, ("qmm_i4t_gd", (C, V)): steps + 1,
                  ("qmm_i4t_gateup_gd", (C, 2 * FF)): L * steps,
                  ("qmm_i4t_dq", (C, nqkv)): L, ("qmm_i4t_dq", (C, C)): L,
                  ("qmm_i4t_dq", (FF, C)): L, ("qmm_i4t_gateup_dq", (C, 2 * FF)): L}
        return counts, {k: v for k, v in shapes.items() if v}

    def measured(run, tag: str, steps: int):
        kernels.reset_counts()
        t_run = time.perf_counter()
        with _FallbackCount() as fallbacks:
            res = run()
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t_run)
        counts, shapes = dict(kernels.launch_counts), dict(kernels.shape_counts)
        want, want_shapes = expect(steps)
        if counts != dict.fromkeys(counts, 0) | want:
            raise AssertionError(f"{tag}: launch counts {counts} != expected {want}")
        if {k: v for k, v in shapes.items() if v} != want_shapes:
            raise AssertionError(f"{tag}: launches by shape {shapes} != {want_shapes}")
        if fallbacks.calls:
            raise AssertionError(f"{tag}: {fallbacks.calls} matmuls took the dequantize path")
        if not (res.token_ids and all(0 <= t < V for t in res.token_ids)):
            raise AssertionError(f"{tag}: bad token ids")
        return res, wall, counts, shapes

    # one chunk of 64 steps is dispatched ahead of the host: 128 tokens run
    # 128 steps, the long run's 32 tokens one chunk of 64
    steps = 128
    res, wall_ms, counts, shape_counts = measured(
        lambda: eng.generate(ids, sp, max_new_tokens=steps), "generate_q4k", steps)
    if res.n_generated != steps and res.finish_reason != "stop":
        raise AssertionError(f"generate_q4k: {res.n_generated} tokens, {res.finish_reason}")
    laps("run")
    short = Engine(model, max_batch=1, max_seq=Q4K_MAX_SEQ, decode_chunk=32)
    short.generate(ids, sp, max_new_tokens=32)
    torch.cuda.synchronize()
    t_short = time.perf_counter()
    short.generate(ids, sp, max_new_tokens=32)
    torch.cuda.synchronize()
    prof_wall = 1e3 * (time.perf_counter() - t_short)
    laps("window")
    prof = _profile(lambda: short.generate(ids, sp, max_new_tokens=32), steps=32,
                    watch=("i4mv::mv_kernel",))
    prof["window"] = "a 32-token generate (decode_chunk 32)"
    if prof["kernel_ms"] is not None:
        prof["device_busy_share"] = prof["kernel_ms"] / prof_wall
    del short
    laps("profile")
    # the long prompt: bench's ids repeated to Q4K_LONG, the 8192-row bucket
    long_ids = (ids * (Q4K_LONG // len(ids) + 1))[:Q4K_LONG]
    if _bucket(len(long_ids), Q4K_MAX_SEQ) != Q4K_MAX_SEQ:
        raise AssertionError("the long prompt does not take the 8192-row bucket")
    eng.generate(long_ids, sp, max_new_tokens=1)  # its prefill's first calls (no decode)
    torch.cuda.synchronize()
    laps("long warm-up")
    lres, lwall, lcounts, lshapes = measured(
        lambda: eng.generate(long_ids, sp, max_new_tokens=32), "generate_q4k 8K", Q4K_CHUNK)
    laps("long run")
    return {"phase": "generate_q4k", "seconds": time.perf_counter() - t0, "layers": layers,
            "weights": "q4_k (i4t, four planes: scales, mins)",
            "engine": f"max_batch 1, max_seq {Q4K_MAX_SEQ}, decode_chunk {Q4K_CHUNK}",
            "sampling": "temp 0.8, janus 1, seed 0",
            "gguf_build_s": big["build_s"], "gguf_wait_s": big["wait_s"],
            "load_s": big["load_s"], "load_rss_gb": big["load_rss_gb"],
            "load_max_memory_allocated_gb": big["load_max_memory_allocated_gb"],
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
            "n_prompt": res.n_prompt, "n_generated": res.n_generated,
            "finish_reason": res.finish_reason,
            "decode_tok_per_s": 1000.0 / res.gen_ms_per_token,
            "decode_ms_per_token": res.gen_ms_per_token,
            "prompt_ms_per_token": res.prompt_ms_per_token, "ttft_ms": res.ttft_ms,
            "launches": counts, "launches_per_decoded_token": {
                k: v / steps for k, v in counts.items() if k.endswith("_gd") or k in (
                    "decode_attn", "kv_append")},
            "launches_by_shape": {f"{k[0]}:{k[1][0]}x{k[1][1]}": v
                                  for k, v in shape_counts.items()},
            "tokens_head": res.token_ids[:16], "wall_ms": wall_ms, "profile": prof,
            "long": {"n_prompt": lres.n_prompt, "prefill_rows": Q4K_MAX_SEQ,
                     "n_generated": lres.n_generated, "finish_reason": lres.finish_reason,
                     "decode_steps": Q4K_CHUNK, "ttft_ms": lres.ttft_ms,
                     "prompt_ms_per_token": lres.prompt_ms_per_token,
                     "decode_tok_per_s": 1000.0 / lres.gen_ms_per_token,
                     "decode_ms_per_token": lres.gen_ms_per_token, "wall_ms": lwall,
                     "launches": lcounts, "tokens_head": lres.token_ids[:16]},
            "part_s": laps.parts, "_shape_counts": shape_counts,
            "_paths": {"generate_q4k_8k": (lcounts, lshapes)}}


# -- phase 5 -----------------------------------------------------------------


def _bench_batch(eng, tokenizer, n_streams: int, n_tokens: int, chunk: int = 32) -> dict:
    """bench.py's bench_batch on the port: claim every slot, prefill the
    prompts in one batch, one warm chunk, then pipelined chunks to n_tokens
    (each chunk enqueued before the previous one is read), all of `chunk`
    steps."""
    import torch

    from booster_tpu_torch.sampling import SamplingParams

    t_start = time.perf_counter()
    eng.init_batch_state()
    prompts = {}
    for s in range(n_streams):
        eng.reset_slot(s, SamplingParams(temp=0.8, top_k=40, seed=s), seed=s)
        prompts[s] = tokenizer.encode(f"stream {s} benchmark prompt")
    t0 = time.perf_counter()
    first = eng.prefill_slots(prompts)  # ends in the first tokens' readback
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    last = dict(first)
    toks, _ = eng.decode_slots(last, n_steps=chunk)  # the warm chunk
    rows = {s: [first[s]] + toks[s] for s in prompts}
    slots = list(prompts)
    t0 = time.perf_counter()
    done_tokens = 0
    steps = chunk
    handle = eng.decode_slots_start(slots, n_steps=chunk)
    while steps < n_tokens:
        nxt = eng.decode_slots_start(slots, n_steps=chunk)  # pipelined
        toks, _ = eng.decode_slots_finish(handle)
        done_tokens += sum(len(r) for r in toks.values())
        for s, r in toks.items():
            rows[s] += r
        handle = nxt
        steps += chunk
    toks, _ = eng.decode_slots_finish(handle)
    done_tokens += sum(len(r) for r in toks.values())
    for s, r in toks.items():
        rows[s] += r
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"agg_tok_per_s": done_tokens / dt, "per_stream_tok_per_s": done_tokens / dt / n_streams,
            "prefill_ms": prefill_ms, "decode_s": dt, "decoded_tokens": done_tokens,
            "wall_ms": 1e3 * (time.perf_counter() - t_start), "decode_steps": steps + chunk,
            "prompt_tokens": {s: len(p) for s, p in prompts.items()}, "rows": rows}


class _SyncCheck:
    """Wraps eng.decode_slots_start so that each decode dispatch runs with
    torch's synchronization check on; counts the dispatches, the syncs the
    check warns of, and the dispatches that found the chunk before them
    still on the card (the pipelining of chunks).  ``del
    eng.decode_slots_start`` restores the class's method."""

    def __init__(self, eng):
        import torch

        self.dispatch = eng.decode_slots_start
        self.reset()

        def counted(*a, **kw):
            import warnings

            prev = self.last
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    handle = self.dispatch(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            self.host_syncs += sum("synchroniz" in str(w.message) for w in caught)
            self.chunks += 1
            self.prev_chunk_busy += int(prev is not None and not prev.query())
            self.last = handle[-1]  # the chunk's event
            return handle

        eng.decode_slots_start = counted

    def reset(self) -> None:
        self.chunks = self.host_syncs = self.prev_chunk_busy = 0
        self.last = None


def phase_batch(layers: int, model_name: str = "tiny", weights: Optional[str] = None) -> dict:
    """bench.py's bench_batch: config 1's model (TinyLlama, bf16 weights), or
    config 3's ("q8": the 7B Q8_0 model, native i8t; phase batch_q8; with
    weights "i8c", requantized per channel: phase batch_i8c), the
    DeepSeek-Coder-1.3B Q6_K mix ("q6k", native: i8t at group 16 and the
    lane-major Q8_0 down; phase batch_q6k) or its Q5_K_S mix ("q5k", native:
    the int8 forms with mins; phase batch_q5k), MPT-7B ("mpt", native; phase
    batch_mpt), the Mixtral-8x7B shape ("moe": native i4t and i4p; phase
    batch_moe), Gemma-2B ("gemma", "gemma_q6k") or Gemma-7B ("gemma7b" with
    weights "i8", generate_gemma7b_i8's model).  The decode dispatches of batch_moe, batch_i8c, batch_q6k,
    batch_q5k and batch_mpt run under torch's synchronization check."""
    import torch

    from booster_tpu_torch.gguf import GGUFReader
    from booster_tpu_torch.models import load_model
    from booster_tpu_torch.models.loader import resolve_weights
    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.serving import Engine

    t0 = time.perf_counter()
    laps = _Laps()
    name = {v: k for k, v in BATCH.items()}[(model_name, weights)]
    q8, moe, i8c = model_name == "q8" and weights is None, model_name == "moe", weights == "i8c"
    q6k, mpt, q5k = model_name == "q6k", model_name == "mpt", model_name == "q5k"
    q2k, gemma = model_name == "q2k", model_name in ("gemma", "gemma_q6k", "gemma7b")
    gemma16 = model_name == "gemma_q6k"  # int8 weights at group 16: the whole MLP
    gemma7b = model_name == "gemma7b"  # int8 weights at group 32: the MLP, the GELU gate-up
    torch.cuda.reset_peak_memory_stats()
    if q8 or moe or i8c or q6k or mpt or q5k or q2k or gemma:
        big = _big_model(model_name, layers, weights or "auto")
        model, t_load = big["model"], big["load_s"]
        reader = GGUFReader(_gguf_path(layers, model_name))
        try:  # bench_batch's load_model(weights="auto", batch_hint=64): the same model
            # (the 1.3B file fits 6 GiB as bf16, so "auto" would take bf16
            # there: batch_q6k asks for native weights, to run the Q6_K kernels)
            # (the 8B Q2_K file is loaded native too: its kernels are the phase's point;
            # so is Gemma-2B's, which "auto" would take as bf16 at 64 streams)
            if not (i8c or q6k or q5k or q2k or gemma) and resolve_weights(
                    reader, "auto", 64) != "native":
                raise AssertionError(f"{model_name}: weights=auto at batch_hint=64 is not native")
        finally:
            reader.close()
    else:
        path, _ = _wait_gguf("tiny", layers)
        t_load = time.perf_counter()
        model = load_model(path, device="cuda", weights="auto", batch_hint=64)
        t_load = time.perf_counter() - t_load
        kinds = {k: v.kind for k, v in model.params["layers"].items() if hasattr(v, "kind")}
        kinds["output"] = model.params["output"].kind
        if set(kinds.values()) != {"dense"}:
            raise AssertionError(f"batch: weights=auto at batch_hint=64 gave {kinds}, not bf16")
    B, n_tokens = 64, 128
    eng = Engine(model, max_batch=B, max_seq=512, kv_quantized=True, decode_chunk=32)
    laps("load")
    # warm-up: the first calls of every op (the prefill, the warm chunk and
    # one pipelined chunk; a run to n_tokens took up to 22 s at Mixtral).
    # MPT's chunks are of 4 steps here: a step is ~250 ms at MPT-7B, and a
    # chunk of any length runs the same ops
    _bench_batch(eng, model.tokenizer, B, *((4, 4) if mpt else (32,)))
    laps("warm-up")
    syncs = _SyncCheck(eng) if moe or i8c or q6k or mpt or q5k or q2k or gemma else None
    kernels.reset_counts()
    with _FallbackCount() as fallbacks:
        res = _bench_batch(eng, model.tokenizer, B, n_tokens)
    counts = dict(kernels.launch_counts)
    if syncs is not None:
        del eng.decode_slots_start  # the class's method again
        if syncs.host_syncs or not syncs.chunks:
            raise AssertionError(f"batch: {syncs.host_syncs} host syncs in {syncs.chunks} "
                                 "decode dispatches")
    steps = res["decode_steps"]
    T = max(16, 1 << (max(res["prompt_tokens"].values()) - 1).bit_length())
    if mpt and T != BATCH_MPT_T:
        raise AssertionError(f"batch_mpt: prompt bucket {T}, the kernels phase times "
                             f"{BATCH_MPT_T}")
    if q2k and T != BATCH_Q2K_T:
        raise AssertionError(f"batch_q2k: prompt bucket {T}, the kernels phase times "
                             f"{BATCH_Q2K_T}")
    if gemma and T != BATCH_GEMMA_T:
        raise AssertionError(f"batch_gemma: prompt bucket {T}, the kernels phase times "
                             f"{BATCH_GEMMA_T}")
    prefill_chunks = 1  # every prompt fits one chunk of the engine's 512
    sfx = "_d256" if gemma else ""  # Gemma's 256-lane cache: the attention's _d256 forms
    expected = dict.fromkeys(counts, 0) | ({} if mpt else {
        "decode_attn_i8" + sfx: layers * steps, "kv_append_i8" + sfx: steps,
        "prefill_attn_i8" + sfx: layers * prefill_chunks})
    if q8:  # M = 64 a step; M = 64·T at the prefill, its lm head on 64 rows
        expected |= {"qmm_i8t_dq": (2 * layers + 1) * steps + (3 * layers + 1) * prefill_chunks,
                     "mlp_i8t": layers * steps, "qmm_i8t_gateup_dq": layers * prefill_chunks}
    if moe:  # qkv, wo (and the lm head) at M = 64 and 64·T; the experts' three
        expected |= {"qmm_i4t_dq": (2 * layers + 1) * (steps + prefill_chunks),
                     "moe_qmm_i4p": 3 * layers * (steps + prefill_chunks)}
    if i8c:  # qkv, wo, gate-up, down (and the lm head) at M = 64 and 64·T, unfused
        expected |= {"qmm_i8c_mm": (4 * layers + 1) * (steps + prefill_chunks)}
    if mpt:  # no fused prefill (ALiBi, llama.py:666-670) nor decode kernel (:96): the
        # per-layer int8 append in each layer of each step; qkv, wo, up, down
        # (and the Q6_K head) at M = 64 and 64·T
        expected |= {"kv_append_layer_i8": layers * steps,
                     "qmm_i4t_dq": 4 * layers * (steps + prefill_chunks),
                     "qmm_i8t_dq": steps + prefill_chunks}
    if q6k or q5k:  # qkv, wo (and the lm head), the gate-up and the lane-major down at
        # M = 64 and 64·T (Q5_K_S: the mins forms, the head's G16 without)
        expected |= {"qmm_i8t_dq": (2 * layers + 1) * (steps + prefill_chunks),
                     "qmm_i8t_gateup_dq": layers * (steps + prefill_chunks),
                     "qmm_i8_mm": layers * (steps + prefill_chunks)}
    if q2k:  # q and k, v, wo and down, the gate-up (and the Q6_K head) at M = 64 and 64·T
        n = steps + prefill_chunks
        expected |= {"qmm_i4t_g16m_dq": 2 * layers * n, "qmm_i4t_dq": layers * n,
                     "qmm_i4t_g16_dq": 2 * layers * n, "qmm_i4t_gateup_g16m_dq": layers * n,
                     "qmm_i8t_dq": n}
    if gemma16:  # qkv and wo on the int8 tile and the whole MLP with GELU at group 16, at
        # M = 64 and 64·T (the reference's gate takes the MLP at both); the tied head
        n = steps + prefill_chunks
        expected |= {"qmm_i8t_dq": 2 * layers * n, "mlp_i8t_g16_gelu": layers * n}
    elif gemma7b:  # qkv and wo on the int8 tile at M = 64 and 64·T; the whole MLP with
        # GELU at each step's 64 rows; at the 2048-row prefill (past the reference's
        # whole-MLP gate, 141 rows at these widths) the GELU gate-up and the down
        n = steps + prefill_chunks
        expected |= {"qmm_i8t_dq": 2 * layers * n + layers * prefill_chunks,
                     "mlp_i8t_gelu": layers * steps,
                     "qmm_i8t_gateup_gelu_dq": layers * prefill_chunks}
    elif gemma:  # qkv, wo, down and the GELU gate-up at M = 64 and 64·T; the tied head a
        # torch product
        n = steps + prefill_chunks
        expected |= {"qmm_i4t_dq": 3 * layers * n, "qmm_i4t_gateup_gelu_dq": layers * n}
    if counts != expected or (kernels.shape_counts and not (q8 or moe or i8c or q6k or mpt
                                                             or q5k or q2k or gemma)):
        raise AssertionError(f"batch: launch counts {counts} != expected {expected}")
    if q5k:  # every matmul launch by shape, at the decode steps and the prefill chunk
        C, V, FF, n = model.cfg.n_embd, model.cfg.n_vocab, model.cfg.n_ff, steps + prefill_chunks
        want = {("qmm_i8t_dq", (C, 3 * C)): layers * n, ("qmm_i8t_dq", (C, C)): layers * n,
                ("qmm_i8t_dq", (C, V)): n, ("qmm_i8t_gateup_dq", (C, 2 * FF)): layers * n,
                ("qmm_i8_mm", (FF, C)): layers * n}
        if kernels.shape_counts != want:
            raise AssertionError(f"{name}: launches by shape {kernels.shape_counts} != {want}")
    if q2k:  # every matmul launch by shape, at the decode steps and the prefill chunk
        C, V, FF, n = model.cfg.n_embd, model.cfg.n_vocab, model.cfg.n_ff, steps + prefill_chunks
        nkv = model.cfg.n_kv_heads * model.cfg.head_dim
        want = {("qmm_i4t_g16m_dq", (C, C)): layers * n, ("qmm_i4t_g16m_dq", (C, nkv)): layers * n,
                ("qmm_i4t_dq", (C, nkv)): layers * n, ("qmm_i4t_g16_dq", (C, C)): layers * n,
                ("qmm_i4t_g16_dq", (FF, C)): layers * n,
                ("qmm_i4t_gateup_g16m_dq", (C, 2 * FF)): layers * n, ("qmm_i8t_dq", (C, V)): n}
        if kernels.shape_counts != want:
            raise AssertionError(f"{name}: launches by shape {kernels.shape_counts} != {want}")
    if gemma:  # every matmul launch by shape, at the decode steps and the prefill chunk
        C, FF, Dh, n = model.cfg.n_embd, model.cfg.n_ff, model.cfg.head_dim, steps + prefill_chunks
        nq, nqkv = model.cfg.n_heads * Dh, (model.cfg.n_heads + 2 * model.cfg.n_kv_heads) * Dh
        if gemma16:
            want = {("qmm_i8t_dq", (C, nqkv)): layers * n, ("qmm_i8t_dq", (nq, C)): layers * n,
                    ("mlp_i8t_g16_gelu", (C, C)): layers * n}
        elif gemma7b:
            want = {("qmm_i8t_dq", (C, nqkv)): layers * n, ("qmm_i8t_dq", (nq, C)): layers * n,
                    ("mlp_i8t_gelu", (C, C)): layers * steps,
                    ("qmm_i8t_gateup_gelu_dq", (C, 2 * FF)): layers * prefill_chunks,
                    ("qmm_i8t_dq", (FF, C)): layers * prefill_chunks}
        else:
            want = {("qmm_i4t_dq", (C, nqkv)): layers * n, ("qmm_i4t_dq", (nq, C)): layers * n,
                    ("qmm_i4t_dq", (FF, C)): layers * n,
                    ("qmm_i4t_gateup_gelu_dq", (C, 2 * FF)): layers * n}
        if kernels.shape_counts != want:
            raise AssertionError(f"{name}: launches by shape {kernels.shape_counts} != {want}")
    if (i8c or q6k or mpt or q5k or q2k or gemma) and fallbacks.calls:
        raise AssertionError(f"{name}: {fallbacks.calls} matmuls took the dequantize path")
    shape_counts = dict(kernels.shape_counts)
    V = model.cfg.n_vocab
    lengths = eng.cache.lengths.tolist()
    for s, row in res["rows"].items():
        if not all(0 <= t < V for t in row):
            raise AssertionError(f"batch: slot {s} sampled a token id out of range")
        # a slot emits every step of a chunk until an end-of-generation
        # token (the next chunk resumes it, as in the reference); its cache
        # advances once per emitted step
        emitted = len(row) - 1  # the first token is sampled at prefill
        stopped = any(t in model.tokenizer.vocab.eog_ids for t in row)
        if lengths[s] != res["prompt_tokens"][s] + emitted or not (emitted == steps or stopped):
            raise AssertionError(f"batch: slot {s} length {lengths[s]} after {emitted} steps")
    # the trace covers the prefill and 64 steps (bench_batch to 32 tokens)
    laps("run")
    short = _bench_batch(eng, model.tokenizer, B, 32)
    laps("window")
    watch = ("::kv_append_i8_kernel",) if mpt else ()
    if q5k:  # the mins forms at the decode steps' M = 64 (and the 2048-row prefill's tile)
        watch = ("dq_kernel<64, 32, false, true, 0>", "dq_kernel<64, 32, true, true, 0>",
                 "lane_mm_kernel<64, true>", "dq_kernel<256, 32, true, true, 0>")
    if q6k:  # the lane-major Q8_0 down on csrc/qmm_lane_i8.cu's tile at M = 64
        watch = ("lane_mm_kernel<64, false>",)
    if q2k:  # the tile at G 16 at the decode steps' M = 64 and the 2048-row prefill
        watch = ("mm_kernel<64, false, 16,", "mm_kernel<64, true, 16,",
                 "mm_kernel<128, false, 16,")
    forbid = ()
    if q5k or q6k:  # the int8 down never on qmm_lane.cu's kernel
        forbid = (r"lane_kernel<false",)
    if gemma7b:  # the int8 gate-up's GELU tile at the 2048-row prefill, the whole MLP's
        # GELU form at M = 64, the 256-lane int8 attention at 16 kv heads (G = 1) and
        # append; no SiLU gate-up or MLP, no 4-bit kernel, no 128-lane form
        watch = (r"re:dq_kernel<\d+, 32, true, false, 1>", "mlp_kernel<64, 32, false, 1>",
                 "decode_attn_kernel<true, false, 256>", r"re:prefill_attn_kernel<\d+, 256>",
                 "kv_append_i8_kernel<2>")
        forbid = (r"mlp_kernel<\d+, \d+, \w+, 0>", r"i4mv::|mm_kernel<",
                  r"dq_kernel<\d+, \d+, true, \w+, 0>", r"attn_kernel<.*128>",
                  r"kv_append_i8_kernel<1>")
    elif gemma16:  # the whole MLP's GELU form at group 16 at M = 64 and the 2048-row prefill
        # (256 rows a tile), the 256-lane int8 attention and append; no SiLU MLP, no
        # 4-bit kernel, no int8 gate-up, no 128-lane form
        watch = ("mlp_kernel<64, 16, false, 1>", "mlp_kernel<256, 16, false, 1>",
                 "decode_attn_kernel<true, false, 256>", "prefill_attn_kernel<2, 256>",
                 "kv_append_i8_kernel<2>")
        forbid = (r"mlp_kernel<\d+, \d+, \w+, 0>", r"i4mv::|mm_kernel<",
                  r"dq_kernel<\d+, \d+, true",
                  r"attn_kernel<.*128>", r"kv_append_i8_kernel<1>")
    elif gemma:  # the GELU gate-up tile at M = 64 and the 2048-row prefill, the 256-lane
        # int8 decode and prefill attention (64 rows a block: 4 m16 tiles, 2 warps
        # a tile) and append (two passes a row); no SiLU gate-up, no 128-lane form
        watch = ("mm_kernel<64, true, 32, 1, false>", "mm_kernel<128, true, 32, 1, false>",
                 "decode_attn_kernel<true, false, 256>", "prefill_attn_kernel<2, 256>",
                 "kv_append_i8_kernel<2>")
        forbid = (r"mm_kernel<\d+, true, 32, 0,", r"attn_kernel<.*128>", r"kv_append_i8_kernel<1>")
    prof = _profile(lambda: _bench_batch(eng, model.tokenizer, B, 32),
                    steps=short["decode_steps"], watch=watch, forbid=forbid)
    laps("profile")
    prof["window"] = f"bench_batch to 32 tokens ({short['decode_steps']} steps)"
    if prof["kernel_ms"] is not None:
        prof["device_busy_share"] = prof["kernel_ms"] / short["wall_ms"]
    return {"phase": name, "seconds": time.perf_counter() - t0, "layers": layers,
            "weights": {"batch": "bf16", "batch_q8": "q8_0 (i8t)",
                        "batch_moe": "q4_0 (i4t attention, i4p experts)",
                        "batch_i8c": "q8_0 requantized per channel (i8c)",
                        "batch_q6k": "q6_k (i8t g16) with q8_0 ffn_down (lane-major i8)",
                        "batch_q5k": "q5_k_s: q5_k (i8t g32 with mins), q5_1 ffn_down "
                                     "(lane-major i8 with mins), a q6_k head (i8t g16)",
                        "batch_mpt": "q4_0 (i4t) with a q6_k head (i8t g16)",
                        "batch_q2k": "q2_k mix: q2_k (i4t g16 with mins), q3_k wo and "
                                     "ffn_down (i4t g16, zero 4), a q4_k attn_v (i4t g32 with "
                                     "mins), a q6_k head (i8t g16)",
                        "batch_gemma": "q4_0 (i4t; the gate-up's GELU epilogue), a q6_k "
                                       "token table (dense bf16: the tied head)",
                        "batch_gemma_q6k": "q6_k (i8t g16; the whole MLP with GELU), a q6_k "
                                           "token table (the tied head)",
                        "batch_gemma7b_i8": "q4_0 widened to int8 (i8t g32; the gate-up with "
                                            "GELU at the 2048-row prefill, the whole MLP "
                                            "with GELU at each step), a q6_k token table "
                                            "(the tied head)"}[name],
            "load_s": t_load, "dequantize_fallbacks": fallbacks.calls,
            "host_syncs_in_dispatches": None if syncs is None else syncs.host_syncs,
            "decode_dispatches_checked": None if syncs is None else syncs.chunks,
            "dispatches_with_previous_chunk_still_running":
                None if syncs is None else syncs.prev_chunk_busy,
            "streams": B, "prefill_T": T,
            "agg_tok_per_s": res["agg_tok_per_s"],
            "per_stream_tok_per_s": res["per_stream_tok_per_s"],
            "prefill_ms": res["prefill_ms"], "decode_s": res["decode_s"],
            "decoded_tokens": res["decoded_tokens"], "decode_steps": steps,
            "wall_ms": res["wall_ms"], "launches": counts, "expected_launches": expected,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
            "tokens_head_slot0": res["rows"][0][:16], "profile": prof, "part_s": laps.parts,
            "_shape_counts": shape_counts}


# -- phase 8 -----------------------------------------------------------------

# a system message of a little over 600 tokens of the synthetic vocabulary,
# so that a prompt that starts with it fills two full 256-row pages
SYSTEM = ("You are the helpful assistant of the hello world company. Answer in the order "
          "of the questions and the end of each answer is a short summary. ") * 6


def _request(port: int, method: str, path: str, body=None, timeout: float = 600.0) -> dict:
    """One HTTP request from a fresh connection: status, the parsed body (a
    JSON object, or the list of SSE/NDJSON records of a stream), the latency
    and, for a stream, the time to its first piece of content."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = {"status": resp.status, "ttft_s": None}
        if resp.getheader("Transfer-Encoding") == "chunked":
            records = []
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.decode().strip()
                if not line:
                    continue
                rec = line[6:] if line.startswith("data: ") else line
                rec = rec if rec == "[DONE]" else json.loads(rec)
                content = (rec["choices"][0]["delta"].get("content") if "choices" in rec
                           else rec.get("message", {}).get("content")) if rec != "[DONE]" else None
                if content and out["ttft_s"] is None:
                    out["ttft_s"] = time.perf_counter() - t0
                records.append(rec)
            out["body"] = records
        else:
            out["body"] = json.loads(resp.read())
        out["latency_s"] = time.perf_counter() - t0
        return out
    finally:
        conn.close()


def _server_traffic(port: int, tag: str) -> dict:
    """Step 2 of the server phase: 64 requests at once from client threads
    (48 OpenAI chat completions that share the system message, 8 streamed
    ones (SSE) with it, 4 streamed Ollama chats (NDJSON), 4 /jobs polled by
    GET, one of them cancelled while it runs); every response is checked.
    Returns the responses and the wall time."""
    import threading
    import uuid
    from concurrent.futures import ThreadPoolExecutor

    sampling = {"temperature": 0.8, "top_k": 40}
    start = threading.Barrier(64)

    def chat(i, stream):
        question = f"{tag} question {i}: what is {i} and {i}?"
        body = {"messages": [{"role": "system", "content": SYSTEM},
                             {"role": "user", "content": question}],
                "max_tokens": 128, "seed": i, "stream": stream, **sampling}
        start.wait()
        r = _request(port, "POST", "/v1/chat/completions", body)
        if r["status"] != 200:
            raise AssertionError(f"chat {i}: status {r['status']}")
        if stream:
            recs = r["body"]
            if recs[-1] != "[DONE]" or recs[-2]["choices"][0]["delta"] != {}:
                raise AssertionError(f"chat stream {i}: bad end {recs[-2:]}")
            r["finish_reason"] = recs[-2]["choices"][0]["finish_reason"]
            r["text"] = "".join(x["choices"][0]["delta"].get("content", "") for x in recs[:-1])
        else:
            b = r["body"]
            if (b["object"] != "chat.completion"
                    or b["choices"][0]["message"]["role"] != "assistant"):
                raise AssertionError(f"chat {i}: bad body {b}")
            r["finish_reason"] = b["choices"][0]["finish_reason"]
            r["completion_tokens"] = b["usage"]["completion_tokens"]
            if not 1 <= r["completion_tokens"] <= 128:
                raise AssertionError(f"chat {i}: {r['completion_tokens']} tokens")
        r["kind"] = "sse" if stream else "chat"
        return r

    def ollama(i):
        body = {"messages": [{"role": "user", "content": f"{tag} ollama {i}: hello world"}],
                "options": {**sampling, "seed": i, "num_predict": 128}}
        start.wait()
        r = _request(port, "POST", "/api/chat", body)
        recs = r["body"]
        if r["status"] != 200 or recs[-1]["done"] is not True or any(x["done"] for x in recs[:-1]):
            raise AssertionError(f"ollama {i}: status {r['status']}, bad stream end")
        r["finish_reason"] = recs[-1]["done_reason"]
        r["kind"] = "ndjson"
        return r

    def job(i, cancel):
        jid = str(uuid.uuid4())
        start.wait()
        t0 = time.perf_counter()
        r = _request(port, "POST", "/jobs", {"id": jid, "prompt": f"{tag} job {i}: the end",
                                             "max_tokens": 128, "sampling": {**sampling,
                                                                             "seed": i}})
        if r["status"] != 201 or r["body"]["status"] != "queued":
            raise AssertionError(f"job {i}: {r}")
        cancelled = False
        while True:
            g = _request(port, "GET", f"/jobs/{jid}")
            b = g["body"]
            if g["status"] != 200:
                raise AssertionError(f"job {i}: GET status {g['status']}")
            if cancel and not cancelled and b["status"] == "processing" \
                    and b["completion_tokens"] >= 1:
                d = _request(port, "DELETE", f"/jobs/{jid}")
                if d["status"] != 200 or d["body"] != {"status": "stopped"}:
                    raise AssertionError(f"job {i}: DELETE {d}")
                cancelled = True
            if b["status"] in ("finished", "stopped"):
                break
            time.sleep(0.05)
        want = ("stopped", "cancelled") if cancel else ("finished", None)
        if b["status"] != want[0] or (cancel and b["finish_reason"] != want[1]):
            raise AssertionError(f"job {i}: ended {b['status']} / {b['finish_reason']}")
        return {"kind": "job", "status": 200, "latency_s": time.perf_counter() - t0,
                "finish_reason": b["finish_reason"], "completion_tokens": b["completion_tokens"],
                "cancelled": cancel, "ttft_s": None}

    calls = ([(chat, i, False) for i in range(48)] + [(chat, 48 + i, True) for i in range(8)]
             + [(ollama, 56 + i) for i in range(4)] + [(job, 60 + i, i == 0) for i in range(4)])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=64) as pool:
        futs = [pool.submit(*c) for c in calls]
        results = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    for r in results:
        ok = ("stopped", "cancelled") if r.get("cancelled") else ("stop", "length")
        if r["finish_reason"] not in ok:
            raise AssertionError(f"{r['kind']}: finish_reason {r['finish_reason']}")
    return {"results": results, "wall_s": wall}


def phase_server(model_name: str = "q8") -> dict:
    """The HTTP server of ``python -m booster_tpu_torch --server --paged-kv
    --kv-quant --slots 64`` on config 3's model (phase server), or on
    Gemma-2B's Q4_0 model that generate_gemma loaded ("gemma": phase
    server_gemma, its 256-lane pool: the paged kernels' _d256 forms, 18
    layers), through the port's own
    ``serve`` (on a thread of its own, ``ServerThread``), with the CLI's
    default sampling and limits: a paged int8 pool of 256-row pages at a
    4096-token context, decode chunks of 8 steps.  ``warmup`` first; then
    one chat completion whose system message fills two pages (its pages are
    published when it finishes), then 64 requests at once (_server_traffic).
    The launch counts are reset just before those 64 and read when the
    scheduler is idle again: each decode step of each dispatched chunk
    launches a paged attention a layer (32 at the 7B, 18 at Gemma-2B) and one
    paged append, and nothing launches
    the dense decode attention, the dense appends or the prefill attention
    kernel (a paged prefill attends over views gathered from the pool).  The
    decode dispatches run with torch's synchronization check on: a dispatch
    that made the host wait for the device would show as a host sync."""
    import threading

    import torch

    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.serving import Engine
    from booster_tpu_torch.serving.config import build_arg_parser, config_from_args
    from booster_tpu_torch.serving.scheduler import Scheduler
    from booster_tpu_torch.serving.server import ServerThread

    t0 = time.perf_counter()
    laps = _Laps()
    torch.cuda.reset_peak_memory_stats()
    gemma = model_name == "gemma"
    model = (_big_model("gemma", LAYERS["gemma"], "native") if gemma else _big_model("q8"))["model"]
    L = model.cfg.n_layers
    sfx = "_d256" if gemma else ""  # the 256-lane pool's forms
    n_sys = len(model.tokenizer.encode(SYSTEM))
    if not 2 * 256 < n_sys < 3 * 256:
        raise AssertionError(f"the system message is {n_sys} tokens, not two pages and some")
    # the CLI's defaults: `--server --paged-kv --kv-quant --slots 64 --context 4K`
    cfg = config_from_args(build_arg_parser().parse_args(
        ["--server", "--paged-kv", "--kv-quant", "--slots", "64", "--context", "4K"]))
    spec = cfg.models["default"]
    eng = Engine(model, max_batch=64, max_seq=spec.context, kv_quantized=True, paged=True,
                 page_size=256, decode_chunk=8)
    laps("engine")
    eng.warmup()
    laps("warm-up")
    sched = Scheduler(eng, prompt_spec=cfg.prompts["default"],
                      default_sampling=cfg.samplings["default"],
                      default_max_tokens=spec.predict, deadline_s=cfg.deadline)

    syncs = _SyncCheck(eng)  # the decode chunks, their host syncs, their pipelining
    srv = ServerThread(sched, cfg, model_name=GGUFS[model_name][0])
    peak_pages = [0]
    sampling_on = threading.Event()

    def watch_pages():
        while not sampling_on.wait(0.02):
            peak_pages[0] = max(peak_pages[0], eng.page_alloc.n_pages - eng.page_alloc.n_free)

    watcher = threading.Thread(target=watch_pages, daemon=True)
    watcher.start()
    try:
        first = _request(srv.port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "system", "content": SYSTEM},
                         {"role": "user", "content": "the first question"}],
            "max_tokens": 128})
        if first["status"] != 200 or not first["body"]["usage"]["completion_tokens"] <= 128:
            raise AssertionError(f"the first request: {first}")

        def idle():
            for _ in range(600):
                h = _request(srv.port, "GET", "/health")["body"]
                if h["slots_busy"] == 0 and h["jobs_queued"] == 0:
                    time.sleep(0.2)
                    return h
                time.sleep(0.1)
            raise AssertionError("the scheduler did not become idle")

        idle()
        laps("first request")
        kernels.reset_counts()
        syncs.reset()
        run = _server_traffic(srv.port, "a")
        health = idle()
        counts = dict(kernels.launch_counts)
        chunks = syncs.chunks
        measured = {"host_syncs": syncs.host_syncs, "prev_chunk_busy": syncs.prev_chunk_busy}
        steps = chunks * eng.decode_chunk
        delivered = srv.call(lambda: sum(j.n_generated for j in list(sched.jobs.values())[-64:]))
        expected = {f"paged_attn_i8{sfx}": L * steps, f"kv_append_paged_i8{sfx}": steps}
        expected |= {k: 0 for k in counts if k.startswith(
            ("paged_attn", "kv_append", "decode_attn", "prefill_attn")) and k not in expected}
        got = {k: counts[k] for k in expected}
        if got != expected or steps == 0:
            raise AssertionError(f"server: launch counts {got} != {expected} ({chunks} chunks)")
        if measured["host_syncs"]:
            raise AssertionError(f"server: {measured['host_syncs']} host syncs in "
                                 f"{chunks} decode dispatches")
        if health["slots_total"] != 64 or health["prefix_hits"] < 48:
            raise AssertionError(f"server: /health {health}")
        laps("run")
        prof = _profile(lambda: _server_traffic(srv.port, "b"), steps=steps,
                        watch=("kv_append_i8_kernel<2>", "decode_attn_kernel<true, true, 256>")
                        if gemma else ("::kv_append_i8_kernel",),
                        forbid=(r"attn_kernel<.*128>", r"kv_append_i8_kernel<1>") if gemma else ())
        laps("profile")
        if prof["kernel_ms"] is not None:
            prof["device_busy_share"] = prof["kernel_ms"] / (1e3 * run["wall_s"])
    finally:
        sampling_on.set()
        srv.stop()
        del eng.decode_slots_start
    res = run["results"]
    ttft = sorted(r["ttft_s"] for r in res if r["ttft_s"] is not None)
    lat = sorted(r["latency_s"] for r in res)

    def pct(xs, q):
        return 1e3 * xs[min(len(xs) - 1, int(q * len(xs)))]

    return {"phase": "server_gemma" if gemma else "server", "seconds": time.perf_counter() - t0,
            "part_s": laps.parts,
            "warmup_s": laps.parts["warm-up"],
            "system_message_tokens": n_sys, "requests": len(res), "step2_wall_s": run["wall_s"],
            "tokens_delivered": delivered, "agg_tok_per_s": delivered / run["wall_s"],
            "per_stream_tok_per_s": delivered / run["wall_s"] / 64,
            "ttft_ms_p50_p99_streamed": [pct(ttft, 0.5), pct(ttft, 0.99)],
            "latency_ms_p50_p99": [pct(lat, 0.5), pct(lat, 0.99)],
            "health": health, "peak_pages_in_use": peak_pages[0], "n_pages": eng.n_pages,
            "decode_chunks": chunks, "decode_steps": steps,
            "dispatches_with_previous_chunk_still_running": measured["prev_chunk_busy"],
            "host_syncs_in_dispatches": measured["host_syncs"],
            "launches": counts, "expected_launches": expected,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
            "first_request_ms": 1e3 * first["latency_s"], "profile": prof}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--write-gguf", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.write_gguf:  # the background writer of _start_writer
        _write_ggufs(args.write_gguf)
        return 0
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES):
        ap.error(f"phases are {PHASES}")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    entries: list = []
    t_all = time.perf_counter()
    failed: list = []

    def run(name, fn):
        """One phase; a failure is reported and the later phases still run
        (the script then exits non-zero without a result)."""
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — reported, and the run fails
            traceback.print_exc()
            emit({"phase": name, "failed": repr(e)[:4000]})
            failed.append(name)
            return None

    # parity reads the first 2 layers of the full-depth files of
    # PARITY_SHARED, so those come early, in the order of its cases; the
    # rest of its files are 2-layer files of their own; the 7B Q8_0 file,
    # the slowest to draw (its normal draws), last, as parity's cases on it
    parity = ["tiny", "moe", "moe_q8", "q6k", "mpt", "q4k", "moe_q4k", "q5k_8b", "q5k", "q2k",
              "gemma", "gemma_q6k", "gemma7b", "gemma_mix", "gemma_mix_q5k", "q8"]
    gemma_phases = {"generate_gemma", "batch_gemma", "generate_gemma_i8", "server_gemma"}
    jobs = (([(m, LAYERS[m] if m in PARITY_SHARED else 2) for m in parity]
             if "parity" in phases else [])
            + ([("tiny", 22)] if {"generate", "batch", "generate_i8"} & set(phases) else [])
            + ([("gemma", LAYERS["gemma"])] if gemma_phases & set(phases) else [])
            + ([("gemma_q6k", LAYERS["gemma_q6k"])]
               if {"generate_gemma_q6k", "batch_gemma_q6k"} & set(phases) else [])
            + ([("gemma7b", LAYERS["gemma7b"])]
               if {"generate_gemma7b_i8", "batch_gemma7b_i8"} & set(phases) else [])
            + ([("q8", 32)] if {"generate_q8", "batch_q8", "server", "generate_i8c",
                                "batch_i8c"} & set(phases) else [])
            + ([("q6k", 24)] if {"generate_q6k", "batch_q6k"} & set(phases) else [])
            + ([("q5k", 24)] if {"generate_q5k", "batch_q5k"} & set(phases) else [])
            + ([("mpt", 32)] if {"generate_mpt", "batch_mpt"} & set(phases) else [])
            + ([("q4k", 32)] if "generate_q4k" in phases else [])
            + ([("q2k", 32)] if {"generate_q2k", "batch_q2k"} & set(phases) else [])
            + ([("moe", LAYERS["moe"])] if {"generate_moe", "batch_moe"} & set(phases)
               else []))
    _start_writer(list(dict.fromkeys(jobs)))
    try:
        return _run_phases(phases, run, entries, failed, t_all)
    finally:
        proc = _writer.pop("proc", None)
        if proc is not None and proc.poll() is None:  # a phase failed before its model was needed
            proc.kill()
        if proc is not None:
            proc.wait()
        _big.clear()


def _run_phases(phases, run, entries, failed, t_all) -> int:
    import torch

    path_counts: dict = {}  # path → its measured run's launch counts
    path_shapes: dict = {}  # path → its matmul launches by (kernel, (K, N))
    if "build" in phases:
        res = run("build", phase_build)
        if res is None:
            print("chip_smoke.py: the kernels do not build", file=sys.stderr)
            return 1
        emit(res)
    print(smi_line(), flush=True)
    for name, fn in (("kernels", lambda: phase_kernels(entries)),
                     ("probes", lambda: phase_probes(entries)), ("parity", phase_parity)):
        if name in phases:
            res = run(name, fn)
            if res is not None:
                if "_shape_counts" in res:  # the probe tools' run: the probes' launches
                    path_shapes[name] = res.pop("_shape_counts")
                    path_counts[name] = res["launches"]
                for path, (c, sh) in res.pop("_paths", {}).items():  # parity's counted cases
                    path_counts[path], path_shapes[path] = c, sh
                emit(res)
    # the Gemma-2B phases come before the 7B's: the 7B file, the writer's
    # slowest (its normal draws), is written after parity's full-depth files
    for name in PHASES[PHASES.index("generate"):]:
        phase = (phase_generate if name in GENERATE else phase_batch if name in BATCH
                 else (lambda layers, *_: phase_generate_q4k(layers))
                 if name == "generate_q4k" else None)
        model, weights = (GENERATE.get(name) or BATCH.get(name)
                          or (("q4k", "auto") if name == "generate_q4k"
                              else ("gemma", "native") if name == "server_gemma"
                              else ("q8", None)))
        if model == "q8":  # the Gemma models (about 13 GB on the card), done with
            for key in [k for k in _big if k[0] in ("gemma", "gemma_q6k", "gemma7b")]:
                _big.pop(key)
        if weights == "i8c":
            _big.pop(("q8", "auto"), None)  # the native 7B model's 8 GB, done with
        if model == "q6k":
            _big.pop(("q8", "i8c"), None)
        if model == "q5k":
            _big.pop(("q6k", "native"), None)
        if model == "mpt":
            _big.pop(("q5k", "native"), None)
        if model == "q4k":
            _big.pop(("mpt", "native"), None)
        if model == "q2k":
            _big.pop(("q4k", "auto"), None)
        if model == "moe":
            _big.clear()  # the 7B models make room for the Mixtral's 16.5 GB
        if name not in phases:
            continue
        if phase is None:
            res = run(name, lambda: phase_server(model))
        else:
            res = run(name, lambda: phase(LAYERS[model], model, weights))
        if res is not None:
            if "_shape_counts" in res:
                path_shapes[name] = res.pop("_shape_counts")
            path_counts[name] = res["launches"]
            for path, (c, sh) in res.pop("_paths", {}).items():  # a phase's second run
                path_counts[path], path_shapes[path] = c, sh
            emit(res)
        gc.collect()  # a phase's engine may sit in a reference cycle (a patched method)
        torch.cuda.empty_cache()
    _big.clear()
    if entries:
        from booster_tpu_torch.ops import kernels

        for e in entries:
            name, shape = e.pop("key")
            path = e.pop("path", "generate")
            counts = path_counts.get(path)
            if counts is None:
                e["launches"] = None
            elif shape is None:
                e["launches"] = counts[name]
            else:
                e["launches"] = path_shapes[path].get((name, shape), 0)
            e["launches_on"] = path
        emit({"kernels": entries, "seconds_total": time.perf_counter() - t_all,
              "counted_kernels": sorted(kernels.launch_counts), "gguf_written": _gguf_sizes()})
    if failed:
        print(f"chip_smoke.py: phases failed: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
