#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It needs nothing built beforehand and imports nothing of the JAX package.
Phases, in order; any failure raises and the script exits nonzero:

1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. the build: the grouped-matmul, paged-attention and packed-attention
   kernels from ``csrc/``, one ``nvcc`` each for ``sm_90a``, all started
   together;
3. the multiproc path: the port's ``run_live`` on the 40-image microscopy
   smoke stream, workers as forked OS processes each running the ``torch``
   payload on the card, once at the default payload size and once at full
   width, each held to the parity bands of the port's ``simulate``.  The
   workers send their kernel launch counts and per-message device ms back
   to the master, and each run's launches are summed from a count of 0.
   It runs in a child process: this one has touched CUDA, and forked
   workers of such a process cannot use it;
4. the grouped-matmul kernel against its plain PyTorch version on the
   card, on the kernel test shapes, empty and ragged bins and both payload
   shapes, each case naming the path it took (``tma``: bf16 on the tensor
   cores; ``simt``: f32 and the bf16 shapes TMA cannot take) and held to
   it by the kernel's tile census; then its bf16 entry at the MoE layer's
   shapes (``qwen3-moe-30b-a3b`` bins of a decode step and of a prefill,
   gate/up and down) on the tensor-core path, with rows past the bins 0, a
   second launch bitwise equal to the first, the tile census equal to
   ``ref.tile_census`` and two planted faults above the limit, and the
   kernel's, the plain version's and ``torch.bmm``'s times beside the
   card's bound;
5. the streaming slice at full size: ``run_live`` in-process on the full
   767-image microscopy stream, one grouped matmul of
   ``qwen3-moe-30b-a3b`` width per message (128 experts, 128-row bins,
   d = f = 2048, f32), with the kernel's launch count reset before the run
   and read after it.  Its worker target at the last dispatch is held to
   that of a witness run of the ``sleep`` payload on the same stream and
   scale, made just before it;
6. the paged-decode-attention kernel against its plain version on the
   card at the serving run's decode shape (8 sequences of ragged lengths in
   64-1056 and one of 0, 32 query over 8 KV heads of 128, 16-token pages in
   a 1024-page pool, one -1 table entry inside a live range, NaN in every
   unreferenced page), f32 and bf16, a second launch right after the first
   bitwise equal to it (the split counters reset), with the kernel's, the
   plain version's and ``scaled_dot_product_attention``'s times beside the
   bound; then bf16 at ``qwen3-moe-30b-a3b``'s decode shape (32 query over
   4 KV heads, G = 8); then qwen3-8b's decode shape with a sliding window
   of 256 tokens in bf16 and f32 (phase 10b's), NaN in every page wholly
   before a window unread, timed beside the same call without the window;
7. the packed-attention kernels, forward and backward, against the
   autograd of their plain version in bf16 (float32 beside bf16 on the card
   must raise and launch nothing), at the train shape (the segment ids of the first
   batch the ``StreamingPipeline`` packs at 4096 tokens, 4 rows, plus one
   fully padded row; 16 heads of 128), at the first later batch of that
   stream whose rows each hold two documents or more, and at the serving
   prefill shape (8 x 1024, 32 query over 8 KV heads).  Output and
   gradients are held by relative l2 over the whole tensor and over each
   64-row tile of one head, beside the readings of two planted faults (a
   key tile hidden, delta = 0 in dQ) that must exceed the limits; at the
   train shape a second forward and backward must give the same bits; the
   forward writes its output's residual (the training forward)
   and must write the same output as without it (the serving forward); the
   tile pairs each kernel skipped, computed masked and computed unmasked,
   counted by the kernels themselves (``kernel.tile_census``), must equal
   ``ref.tile_schedule``'s count (the same rule in PyTorch) times the heads,
   and their shares are printed per shape; the kernels', the plain version's and
   ``scaled_dot_product_attention``'s (causal, forward and backward) times
   stand beside the bounds (the forward's with and without the residual),
   and each shape's record goes into the kernels
   line under ``by_shape``; then the forward alone at ``qwen3-moe-30b-a3b``'s
   prefill shape (8 x 1024, 32 query over 4 KV heads);
7b. the packed kernels' float32 instances (3xTF32 on the tensor cores,
   no residual), forward and backward, against the autograd of their plain
   version in fp32 (TF32 off: ``PACKED_F32_TOLS``, ``PACKED_F32_REL_L2``,
   phase 7's planted faults above them and, at 2 x 1024 and D = 128, one
   pass of plain TF32 (``ref.packed_attention_tf32``) as a third, a second
   launch bitwise equal, the tile census equal to ``ref.tile_schedule``'s at
   every head dim): olmo-1b's train shape cut to the 2 rows phase 11d
   trains, the serving prefill shape, then D = 16, 32, 64 and 128 at 2 x
   1024; times beside two bounds (fp32 on the CUDA cores, 67 TFLOP/s, and
   3xTF32 on the tensor cores, 165 TFLOP/s), each as TFLOP/s of visible
   work and its share of both, and sdpa in fp32 with TF32 off;
8. the attention block at full width: the first layer's
   ``layers.attention`` of ``olmo-1b`` and of ``qwen3-8b`` on that
   multi-document batch, output and gradients of its input and its four
   projections, against the same block built on the plain
   ``flash_attention``;
9. the serving entry point: ``launch.serve.run_local`` on ``qwen3-8b`` at
   full width and depth in bf16 (weights drawn on the card from a seed), 8
   prompts and 16 decode steps over a 1024-page First-Fit paged cache,
   with the paged kernel's launches held to 36 layers x 16 steps and the
   packed forward's to 36 in the prefill;
9b. the same in float32 (``run_local(dtype=torch.float32)``, the JAX
   package's serving dtype: 32.8 GB of weights) through the kernels'
   float32 instances, then on the plain route (the plain flash path and the
   plain paged version on the card): the launches held as in phase 9 (none
   on the plain route), the prefill's logits within ``F32_SERVE_TOL`` of
   max |logit| and all 17 greedy tokens of each sequence equal;
10. ragged serving: 8 prompts of 64-1024 tokens through ``prefill`` (36
   packed-forward launches) and 32 paged decode steps (launches held to
   36 x 32), the First-Fit watermark, and the first decode step's logits
   held to the port's own prefill of prompt + token, then two more decode
   steps under ``torch.profiler`` (one paged launch per layer and step);
10b. the same prompts and weights with ``sliding_window`` set to 256 by
   ``dataclasses.replace`` (a check of the semantics: no config sets one):
   the prefill (36 packed launches, the kernel's window) and 8 decode steps
   (36 paged launches a step, the paged kernel's window), the first step
   held to the port's windowed prefill of prompt + token within
   ``FIRST_STEP_TOL``, and read further from the unwindowed prefill;
11. training: ``launch.train.run`` on ``olmo-1b`` at full width and depth,
   ``train_4k`` rows of 4096 tokens, batch 4, 8 steps, remat ``"nothing"``,
   bf16 compute over fp32 masters, checkpointing into a temporary directory
   it removes after; the packed kernels' launches held to 8 x 16 x 2
   forward and 8 x 16 backward, then one more step under ``torch.profiler``;
11d. float32 training (``[train-f32]`` lines, run after 11): olmo-1b at full
   width and depth in float32 compute over fp32 masters, 2 train_4k rows,
   remat "nothing", TF32 off (printed): step 1's loss and named gradients
   on the kernels' float32 instances against the plain route (loss within
   ``F32_LOSS_REL``, gradients within ``F32_GRAD_REL``) beside the plain
   route's one-ulp witness and a planted fault (documents merged), then 3
   steps of ``launch.train.run(compute_dtype=torch.float32)``: 32 packed
   forward and 16 backward launches a step, losses, step ms, peak memory;
11b. the distributed layer (``[distributed]`` lines), olmo-1b at full width
   as in phase 11: (a) the first 3 of its batches through ``make_train_step``
   with ``GradCompressor(stochastic=False)`` and without it, from the same
   drawn weights: step ms p50 of each, the peak memory, the error-feedback
   state's bytes; on step 1's gradients, every leaf's max |g - deq| <=
   scale / 2, the error feedback equal to g - deq, two ``apply`` calls with
   ``stochastic=True`` giving the same bits (the reference's same-seed
   rule) and the compressor's device ms (CUDA events); the compressed run's
   step-1 loss equal to the uncompressed run's; (b) ``launch.train.run``
   with ``--mesh local`` (a (1, 1) DTensor mesh, the step inside
   ``activation_sharding``), 3 steps: its step-1 loss bitwise equal to the
   uncompressed run's, its step ms, the packed kernels' launches a step
   (the DTensor rule runs them on the local shards), and the host time
   DTensor adds (step ms p50 and a profiled step's wall less device time,
   each against the plain run's); its checkpoint goes to a temporary
   directory removed after;
11c. the dry-run (``[dryrun]`` lines): the CLI's olmo-1b ``decode_32k``
   cell on both production meshes of a ``fake`` process group, then steps
   counted on meta stand-ins on a (1, 1) mesh and held to the same steps
   on the card: phase 11's train step, phase 10's ragged decode step, and
   two prefill cells of 8 full rows of 1024 tokens (``DRYRUN_PREFILL``:
   qwen3-8b, its write plan read from the shapes, and xlstm-125m, its
   scans counted from one chunk of 128 steps for all 8 against
   ``FlopCounterMode`` over the full loop), and phase 15's xlstm-125m
   train step (4 x 256, counted on the (1, 1) mesh, its scans' forward,
   recompute and backward counted from one chunk of 2): the FLOPs
   equal, no measured step faster than its roofline, the predicted peak
   within ``DRYRUN_MEM_TOL`` of the card's;
12. MoE serving: ``qwen3-moe-30b-a3b`` at full width and depth in bf16
   (weights drawn on the card from a seed, after every earlier phase's
   tensors are freed), each MoE layer's experts through the grouped
   matmul's bf16 entry (3 launches a layer, 144 a forward): first
   ``launch.serve.run_local`` (8 prompts, 16 decode steps), then 8 prompts
   of 64-1024 tokens through ``prefill`` (packed forward 48) and 32 paged
   decode steps (paged 48 a step); the first decode step run again on a
   copy of the post-prefill cache must give the same bits, and its logits
   are read (not held) against the port's prefill of prompt + token;
   ``moe_layer``'s kernel route is held to its plain route on the real
   hidden states of the first and last layers, at the prefill and at a
   decode step, beside two planted faults; two decode steps and then one
   prefill run under ``torch.profiler`` after the timed ones, each profile
   giving the device time, the busy share and the grouped matmul's share;
13. the other families at full width (``[family]`` lines), after every
   earlier phase's tensors are freed: first each kernel at their new shapes
   against its plain version (the packed forward and backward at
   seamless-m4t-medium's encoder, 8 x 1024 over 16 heads of 64 not causal,
   and its cross attention, 64 queries against 1024 keys not causal with
   separate, padded segment ids, at internvl2-1b's prefill, 8 x 320 over
   14 query and 2 KV heads of 64, and at seamless's decoder as phase 15
   trains it, 4 rows of 512 tokens over 1024 frames cut into two documents
   a side, causal self attention and cross attention; the paged kernel in
   bf16 at G = 1 and
   G = 7, D = 64; the grouped matmul's bf16 entry at jamba-v0.1-52b's bins,
   E = 16, top-2, C = 128 and 1280, d 4096 and 14336, gate/up and down),
   each within phase 7's, 6's or 4's limits, a second launch bitwise equal,
   the tile census equal to its rule, phase 7's planted faults above the
   limits at internvl2-1b's causal prefill, and its times beside the bound
   and the library call; then four families served: xlstm-125m (12 layers;
   ``run_local``, then 8 prompts of 1024 tokens and 32 decode steps; no
   kernel launched), seamless-m4t-medium (12 + 12 layers; ``run_local``,
   then 1024 encoder frames and 64-token prompts: 36 packed launches in the
   prefill, 24 paged a step), internvl2-1b (24 layers; ``run_local`` must
   raise the ValueError of 256 patch rows against 16-token prompts, as the
   JAX package's does; then 256 patch rows + 64 tokens: 24 packed, 24 paged
   a step) and jamba-v0.1-52b cut to 16 of its 32 layers (``run_local``,
   then 8 x 1024 and 32 steps: 2 packed, 2 paged a step, 24 grouped-matmul
   launches a forward; the first step repeated bitwise on a copy of the
   cache; a profiled step and prefill with the Mamba blocks' and scan's
   shares of device time and the MoE drop fractions).  Each family's first
   decode step is read against the port's prefill of prompt + token beside
   a witness (the embedding table moved by one bf16 ulp), and held within
   ``FIRST_STEP_TOL`` in fp32 (xlstm) or with the attention projections
   tempered to a fan-in init's scale (``_tempered``; jamba on 8 x 64
   prompts within ``JAMBA_FIRST_STEP_TOL``), beside planted faults (the
   recurrent states or the K/V pages lost) that must read above the
   limit.  The kernels line's
   ``by_shape`` gains ``seamless-m4t-medium encoder``, ``seamless-m4t-medium
   cross``, ``internvl2-1b prefill``, ``seamless-m4t-medium decoder self``,
   ``seamless-m4t-medium decoder cross`` (packed forward and backward),
   ``seamless-m4t-medium G=1``, ``internvl2-1b G=7`` (paged) and ``jamba
   decode gate/up bf16``, ``jamba decode down bf16``, ``jamba prefill
   gate/up bf16``, ``jamba prefill down bf16`` (grouped matmul).

14. the four examples (``[examples]`` lines).  First each kernel at the
   examples' shapes against its plain version, as phase 13 holds them
   (``EXAMPLE_PACKED``: lm-100m's packed rows of 256, D = 64; olmo-1b and
   qwen3-8b at smoke size, D = 16, the mma.sync route, and in float32, as
   the serving example runs it; ``EXAMPLE_PAGED``: qwen3-8b smoke decode
   over pages of 4, bf16 and f32); ``by_shape`` gains ``lm-100m
   train stream``, ``olmo-1b smoke``, ``qwen3-8b smoke prefill`` (packed
   forward and backward, each beside phase 7's planted faults) and
   ``qwen3-8b smoke G=4`` (paged).  Then each example in a child
   interpreter with its own time limit and a fresh temporary directory:
   ``examples/torch_quickstart.py``; ``torch_train_stream.py --steps 100
   --fail-at 60`` (lm-100m, ~130M parameters, bf16 over fp32 masters),
   which must restart once, reach step 100 and see its loss fall;
   ``torch_serve_microscopy.py`` and ``torch_fault_tolerance.py --backend
   both``, each whole.  Each exits 0, and each kernel on its path (the
   packed forward and backward in training, the packed forward and the
   paged kernel in serving) must show launches, read from the example's
   own ``kernel launches:`` line.

15. the other families trained at full width (``[family-train]`` lines),
   after every earlier phase's tensors are freed: xlstm-125m cut to 6 of
   its 12 layers (one period: 4 x 256 tokens, fp32, 2 steps) and
   jamba-v0.1-52b cut to its first layer (a Mamba
   block and a dense SwiGLU MLP, 2 x 1024) through ``launch.train.run`` on
   its pipeline's rows, seamless-m4t-medium (12 + 12 layers, 4 x 512
   tokens over 1024 frames) and internvl2-1b (24 layers, 4 rows of 256
   patch rows + 256 tokens) through ``make_train_step`` on ``make_batch``
   batches cut into two documents a row, bf16 over fp32 masters but
   xlstm, remat "nothing", AdamW.  For each: step 1's loss and named
   gradients, the trained route (the packed kernels; the scans in chunks
   under checkpoints) against the plain route (the plain flash path; each
   scan one chunk) within ``FT_LIMITS``, beside the
   plain route with every weight moved by one ulp and a planted fault (a
   segment boundary dropped; the scan's carry reset at its first chunk
   boundary) that must read above the limit; for the attention families,
   the first layer's attention calls caught on the kernel route and their
   dQ, dK, dV held to fp64 (``FT_FP64_LIMIT``) beside the plain path's,
   sdpa's and fp64's with the kernels' roundings, and in a cross attention
   a planted fault (the forward's residual zeroed: delta from the
   bf16 output) above that limit; seamless's plain route also runs the 3
   steps, its losses beside the kernels'; the
   packed launches a step (2 x 36 forward and 36 backward for seamless, 48
   and 24 for internvl2, none for the recurrent two), held on the step and
   on the main path's own run, whose count a step the kernels line
   prints; 3 steps' ms and losses (xlstm's 2), the peak memory, and one more step
   under ``torch.profiler``: device ms, busy share and, for the recurrent
   ones, the scans' forward share of device time.

Each phase prints its wall time; a failing phase raises with its name.
The serving phases run before training, so that no ``torch.profiler``
session precedes their host-bound decode steps (the profiler may leave the
host's launch path slower for the rest of the process).
The line before the last is ``{"kernels": [...]}``: the grouped matmul,
the paged kernel, the packed forward and backward (bf16), their float32
instances and the paged kernel's windowed launch (each with its record,
launches by path and by_shape); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
MP_FLAG = "--multiproc-phase"  # runs phase 3 in this child interpreter

# the bands of tests/test_backend_parity.py for the microscopy scenario
UTIL_TOL, TARGET_TOL, MAKESPAN_RATIO = 0.15, 2, 1.6
PAYLOAD_FULL = {"experts": 128, "rows": 128, "dim": 2048}
# the multiproc runs: (name, payload kwargs, wall seconds per scenario
# second).  Each forked worker builds its payload (and initialises CUDA and
# loads the kernel) while its 15 s boot delay runs, so the delay must cover
# that in wall time: under a second at the default size, and about 12 s of
# seeded draws for the full-width weights.
MP_RUNS = (("default", {}, 0.2), ("full", PAYLOAD_FULL, 2.0))
# the full-size in-process run (peak ~55 msgs/s); the card must stay at
# most this busy over it, so that its time fits inside the scaled messages
FULL_TIME_SCALE, MAX_DEVICE_BUSY = 0.05, 0.4

# H100 SXM data sheet, dense: fp32 on the CUDA cores, bf16 on the tensor
# cores, device-memory bandwidth; "tf32x3": fp32 products as three TF32
# products on the tensor cores (495 TFLOP/s of TF32, a third of it), the
# packed kernels' float32 route
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12

# the paged kernel at the serving run's decode shape: 8 sequences, qwen3-8b's
# 32 query heads over 8 KV heads of 128, 16-token pages, a 1024-page pool
DECODE = {"B": 8, "H": 32, "KVH": 8, "D": 128, "page_size": 16,
          "num_pages": 1024, "max_pages": 128}
PAGED_TOLS = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}  # test_kernels TOLS
PREFILL = {"B": 8, "S": 1024, "H": 32, "KVH": 8, "D": 128}  # the serving prefill
# olmo-1b at train_4k: rows of 4096 tokens, 16 heads of 128 (MHA); the
# global batch of 256 rows is cut to 4 for one card and the time limit
TRAIN = {"B": 4, "S": 4096, "H": 16, "KVH": 16, "D": 128}
TRAIN_STEPS = 8
TRAIN_ARGV = ["--arch", "olmo-1b", "--shape", "train_4k", "--steps", str(TRAIN_STEPS),
              "--batch-size", str(TRAIN["B"]), "--remat", "nothing",
              "--ckpt-every", "1000", "--mesh", "none"]
# phase 11b: the same run's first DIST_STEPS steps with the int8 gradient
# compressor and without it (make_train_step), then through --mesh local
DIST_STEPS = 3
# |g - deq| <= scale / 2 holds in exact arithmetic; in fp32 x = g / scale
# and deq = q x scale each round once, by up to 2^-24 of |x| <= 127 steps,
# so the bound is read with 2 x 127 x 2^-24 of a step, doubled (3.0e-5)
QUANT_SLACK = 127 * 2.0 ** -22
DIST_ARGV = ["--arch", "olmo-1b", "--shape", "train_4k", "--steps", str(DIST_STEPS),
             "--batch-size", str(TRAIN["B"]), "--remat", "nothing",
             "--ckpt-every", "1000", "--mesh", "local"]
# The packed kernels against the autograd of their plain version, in bf16
# (their float32 instances: phase 7b, PACKED_F32_*).  The output is
# held elementwise to test_kernels' bf16 TOLS.  The output and the gradients
# are also held by ``rel_l2`` (kernels/packed_attention/ref.py): the whole
# tensor's ||err|| / ||ref||, and the worst of the same ratio over the
# 64-row tiles of one head, so that an error confined to the later tiles,
# whose entries are small beside the first queries' and keys', shows at its
# own scale.  The kernels round p to bf16 before P.V, P and dS before the
# backward's products, and take delta from the bf16 output, where the plain
# version keeps fp32 until its own cast to bf16; bf16 keeps 8 significant
# bits, so each rounding leaves about 2^-9 relative, independent between
# entries.  On an H100 80GB HBM3 at 700 W the three shapes read 2.0e-3 to
# 3.3e-3 whole and at most 4.4e-3 on a tile.
# Two planted faults built from the plain version are read with the same
# measure and must exceed the limits: a key tile hidden (a skipped tile;
# it read 1.65e-2 whole and 0.26 on a tile at least) and delta = 0 in dQ
# (0.45 whole at least).
PACKED_TOLS = (2e-2, 2e-2)          # (rtol, atol), test_kernels TOLS in bf16
PACKED_REL_L2 = (1e-2, 2e-2)        # (whole tensor, worst 64-row tile of a head)
MULTI_SEGMENT_SEARCH = 16           # packed batches searched for 2+ documents a row
# The packed kernels' float32 instances (phase 7b; 3xTF32 on the tensor
# cores, no residual) against the plain version's autograd in fp32 (TF32
# off): the two differ in the order of their sums and in the kernels'
# dropped lo.lo partial products (about 2^-22 of each product).  The
# forward is held elementwise to test_kernels' f32 TOLS; the output and dQ,
# dK, dV by relative l2 within PACKED_F32_REL_L2, far under the planted
# faults (a key tile hidden, delta = 0 in dQ, and one pass of plain TF32),
# which must read above it.  olmo-1b's train shape, cut to the
# 2 rows the fp32 training phase takes, and the serving prefill shape, then
# each head dim at 2 rows of 1024 tokens, 8 query over 2 KV heads, two
# documents a row.
PACKED_F32_TOLS = (2e-5, 2e-5)
PACKED_F32_REL_L2 = (1e-5, 1e-4)
# where phase 7b plants one pass of plain TF32 as a fault, which must read
# above PACKED_F32_REL_L2
F32_TF32_FAULT_CASE = "f32 D=128"
F32_TRAIN_ROWS = 2
F32_HEAD_DIMS = (16, 32, 64, 128)
# The attention block at full width in bf16 (phase 8), kernels against the
# plain flash_attention, on that multi-document batch: both paths share the
# bf16 projections, RoPE and norms, and their attention cores both round p
# to bf16 before P.V; they differ in where the backward rounds (the kernels
# round P and dS to bf16 for the tensor cores, the plain path rounds dP to
# bf16 in its autograd) and in summation order.  The output and the input's
# gradient are read per tensor and per 64-token tile, the four projections'
# gradients per tensor.  olmo-1b's init gives large scores and a nearly
# one-hot softmax, where bf16 is at its least accurate: there both bf16
# paths sit 0.27 (whole) from the same block in fp32, and 8.3e-3 whole and
# 1.1e-2 on a tile from each other (same card); qwen3-8b's qk-norm keeps
# them within 6.8e-3 of fp32.  Hence twice the kernel limits, still far
# under the planted faults' readings; and the kernels may be no further
# from fp32 than FP32_RATIO x the plain path's distance (measured 1.00 and
# below).
BLOCK_REL_L2 = (2e-2, 4e-2)
FP32_RATIO = 1.5
SERVE_ARGV = ["--backend", "local", "--arch", "qwen3-8b", "--requests", "8",
              "--gen-tokens", "16", "--pages", "1024"]
RAGGED_STEPS = 32
PROFILE_STEPS = 2  # decode steps under torch.profiler, after the timed ones
# phase 11c: the dry-run's count of a step on meta stand-ins against the
# same step on the card.  The peak it predicts is its arguments plus the
# most bytes its dispatched ops hold live at once; the card's is
# max_memory_allocated() over the step less what the process holds beside
# the step's arguments.  They part where the caching allocator gives a block
# more than was asked (each rounded up to 512 bytes, and a block of over
# 1 MB left unsplit when less than 1 MB would remain: at most ~1 MB a live
# block, a few hundred live blocks at the train step's peak) and where a
# kernel allocates scratch the operators' fakes do not (the packed
# backward's delta, B H S fp32, 1 MB at the train shape); cuBLAS's
# workspaces and the paged kernel's split scratch are allocated by the
# warm-up step before it.  So the two agree to a few hundred MB of ~34 GB
# (the train step) and ~19 GB (the decode step): 5% holds that with room,
# and a step the count got wrong by one activation of a layer (~0.5 GB
# in 34) would still read inside it, so the FLOPs and the roofline are held
# exactly and by a bound instead.
DRYRUN_MEM_TOL = 0.05
# the ragged decode step counted on stand-ins: phase 10's 8 sequences, its
# 1024-page pool and 128-page tables (seq_len 2048 = 128 pages of 16)
DRYRUN_DECODE = {"B": 8, "S": 2048}
# two prefill cells counted on stand-ins and run on the card: 8 full rows of
# 1024 tokens (phase 10's longest prompt) for qwen3-8b, whose write plan is
# read from the shapes, and for xlstm-125m, whose scans the count runs for
# one chunk of 128 steps and counts for all 8
DRYRUN_PREFILL = {"B": 8, "S": 1024, "archs": ("qwen3-8b", "xlstm-125m")}
# The first paged decode step against the port's prefill of prompt + token,
# both bf16 at full width: max |dlogit| <= FIRST_STEP_TOL * max |logit|.
# bf16 keeps 8 significant bits; the two paths round at different places
# (GEMMs of 1 row against S+1 rows, fp32 p in the kernel against bf16 p in
# the flash prefill) in each of 36 layers.  On the CPU, at qwen3-8b's
# attention shape and full depth with a narrowed MLP, the gap measured 0.72%
# of max |logit|, and 0.0065 relative in l2; 5% leaves about 7x.  Losing the
# generated tokens' K/V, the JAX package's prefill-to-decode fault, moves
# the logits by 23% of max |logit| at its smoke size.
FIRST_STEP_TOL = 0.05
# Phase 9b: run_local on qwen3-8b in float32 (the JAX package's serving
# dtype) through the kernels' float32 instances, against the same run on
# the plain route (the plain flash path and the plain paged version):
# prefill logits within F32_SERVE_TOL of max |logit|, every greedy token
# equal.  Both compute in fp32 and differ in summation order only.
F32_SERVE_TOL = 1e-4
# Phase 10b: qwen3-8b's ragged serve with a sliding window set by
# dataclasses.replace (no config of either package sets one: a check of
# the semantics, not a model users run), WINDOW_STEPS decode steps; its
# first step held to the port's windowed prefill of prompt + token within
# FIRST_STEP_TOL, as phase 10's.
SERVE_WINDOW = 256
WINDOW_STEPS = 8
# Phase 11d: olmo-1b trained in float32 compute at full width and depth,
# train_4k rows, F32_TRAIN_ROWS of them (as many as fit beside phase 11's
# cut; the bf16 phase peaks at 42.5 GiB with 4), remat "nothing", 3 steps.
# Step 1's loss within F32_LOSS_REL of the plain route's (the plain flash
# path), its named gradients within F32_GRAD_REL (relative l2), with the
# attention projections tempered to a fan-in init's scale (``_tempered``,
# as phase 15 holds the attention families).  At the JAX init's own scale
# the scores reach the thousands and the softmax is near one-hot, so the
# fp32 rounding of each score's sum (~1e-3 absolute) moves the near-tied
# weights: on an H100 80GB HBM3 at 700 W the kernels read 1.3e-3 from the
# plain route in loss and ~1.6 in the gradients, and the plain route
# with every weight moved by one fp32 ulp 9.9e-5 and ~1.7 (printed, not
# held).  A planted fault (a key tile hidden) must read above the limits.
F32_TRAIN_STEPS = 3
F32_LOSS_REL = 1e-5
F32_GRAD_REL = 1e-4
F32_TRAIN_LEAVES = ["embed", "blocks/0/mixer/wq[0]", "blocks/0/mixer/wk[0]",
                    "blocks/0/mixer/wv[0]", "blocks/0/mixer/wo[0]", "blocks/0/ffn/w_down[0]"]
L2_FLUSH_BYTES = 256 << 20  # over the 50 MB L2: each timed launch finds it cold
# MoE serving (phase 12): qwen3-moe-30b-a3b at its published shape
# (configs/qwen3_moe_30b_a3b.py, hf:Qwen/Qwen3-30B-A3B: 48 layers, d 2048,
# 32 query over 4 KV heads of 128, 128 experts top-8 of expert d_ff 768;
# 30.5 B parameters, 56.9 GiB in bf16), 8 prompts of 64-1024 tokens (the
# longest 1024, so the prefill is 8 x 1024) and 32 decode steps
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_SERVE_ARGV = ["--backend", "local", "--arch", MOE_ARCH, "--requests", "8",
                  "--gen-tokens", "16", "--pages", "1024"]
MOE_STEPS = 32
MOE_DECODE = dict(DECODE, KVH=4)    # the paged kernel at G = 8
MOE_PREFILL = dict(PREFILL, KVH=4)  # the packed forward at G = 8
# The grouped matmul's bf16 entry at the MoE layer's shapes: (name, E, C, d,
# f, tokens), each token's top-8 experts drawn at random, so the bins hold
# a decode step's 0-3 rows of 128 or a prefill's ~512 of 640.
MOE_GMM = (("decode gate/up", 128, 128, 2048, 768, 8),
           ("prefill gate/up", 128, 640, 2048, 768, 8 * 1024),
           ("prefill down", 128, 640, 768, 2048, 8 * 1024))
GMM_BF16_TOLS = (5e-2, 5e-1)  # test_kernels.py's bf16 (rtol, atol) for the grouped matmul
# Relative l2, ||a - b|| / ||b||, of bf16 results that should differ by
# rounding only.  Two fp32 sums of the same bf16 products, rounded once to
# bf16, differ by one bf16 ulp where they straddle a rounding boundary; one
# ulp is at most 2^-7 of a value, so even every entry one ulp off would read
# under 7.8e-3.  (The bf16 entry's tensor-core path sums each k16 step in
# the hardware's own order and the plain version sums in k order, so the
# two read above 0 here, about 1e-4 to 1e-3 expected.)  Two planted faults
# built from the plain version must read above the limit at each MoE bin:
# the last live row of each bin dropped (as below) and one 64-deep k box
# left out (about sqrt(64 / d): 0.18 at d = 2048, 0.29 at 768).
# ``moe_layer``'s two routes share the
# router (fp32, the same tokens kept) and differ in the three products
# (the plain route's are cuBLAS bf16 GEMMs), each rounded to bf16: the same
# limit holds for each stage; they read 5e-4 to 7e-4.  Planted faults read
# above it: each bin one row short (its last token loses that expert; about
# 0.05 at a prefill, where a bin holds ~512 rows, and near 0.9 at a decode
# step, where it holds 1-3) and the router's gates replaced by 1/K (0.36 to
# 0.54).
MOE_REL_L2 = 1e-2


@contextlib.contextmanager
def _phase(name: str):
    """Print the phase's wall time; re-raise a failure with its name."""
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except Exception as e:
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s: "
              f"{type(e).__name__}: {e}", flush=True)
        raise RuntimeError(f"phase {name!r} failed: {type(e).__name__}: {e}") from e
    print(f"[{name}] done in {time.perf_counter() - t0:.1f} s", flush=True)


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    raise SystemExit(1)


def _target_at_last_dispatch(res) -> int:
    """The worker target at the first control tick at or after the last
    message's dispatch (its start on a PE): the IRM's ask while the last of
    the stream was being placed, before the drain.  After it only the
    stream's last PEs finish and idle out, and where their idle-outs fall
    against the packing runs sets the final target (2, 4 or 5 on the sound
    runs of ``tools/final_target_witness.py``)."""
    import numpy as np

    last = max(m.start_t for m in res.messages)
    i = min(int(np.searchsorted(res.times, last)), len(res.times) - 1)
    return int(res.target_workers[i])


def _assert_parity(sim, live, target, ref, what):
    """The bands of ``tests/test_backend_parity.py::_assert_parity``.

    ``target`` is the live run's worker target at one instant and ``ref =
    (who, which, value)`` the reference's at the same instant: on the smoke
    stream the simulator's final target; on the full stream a live run of
    the ``sleep`` payload on the same stream and scale, both read at their
    last dispatch (``_target_at_last_dispatch``), where the final target
    is a drain transient of the live runtime, whatever its payload.
    """
    ref_who, which, ref_target = ref
    checks = {
        "live completes >= 90%": live["completed"] >= 0.9 * live["total"],
        "sim completes >= 90%": sim["completed"] >= 0.9 * sim["total"],
        "utilization within 0.15": abs(
            live["mean_scheduled_utilization_active"]
            - sim["mean_scheduled_utilization_active"]) <= UTIL_TOL,
        "max target within 2": abs(
            live["max_target_workers"] - sim["max_target_workers"]
        ) <= TARGET_TOL,
        f"{which} within 2 of the {ref_who}'s": abs(target - ref_target) <= TARGET_TOL,
        "makespan within 1.6x": (
            sim["makespan_s"] / MAKESPAN_RATIO
            <= live["makespan_s"]
            <= MAKESPAN_RATIO * sim["makespan_s"]),
    }
    keys = ("completed", "total", "makespan_s",
            "mean_scheduled_utilization_active", "max_target_workers")
    for who, summary in (("sim ", sim), ("live", live)):
        print(f"[{what}] {who} {json.dumps({k: summary[k] for k in keys})}")
    print(f"[{what}] {which}: live {target}, {ref_who} {ref_target}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{what}: outside the parity bands: {bad}")


def _microscopy(smoke: bool):
    """(stream, SimConfig, first-fit IRMConfig) factories for microscopy."""
    from repro_torch.scenarios.registry import get_scenario

    scn = get_scenario("microscopy")
    overrides = scn.smoke_overrides if smoke else {}

    def stream():
        return scn.make_stream(0, **overrides)

    def sim_config():
        cfg = scn.sim_config()
        if smoke:
            cfg.t_max = scn.smoke_t_max
        return cfg

    def irm_config():
        ic = scn.irm_config()
        ic.allocator.algorithm = "first-fit"
        return ic

    return stream, sim_config, irm_config


def _simulate(stream, sim_config, irm_config):
    from repro_torch.core.irm import IRM
    from repro_torch.core.sim import simulate
    from repro_torch.scenarios.engine import summarize_result

    cfg = sim_config()
    res = simulate(stream(), cfg, irm=IRM(irm_config()))
    return summarize_result(res, cfg.dt), res


def multiproc_phase() -> None:
    """Phase 3, in a child process that never touches CUDA itself."""
    import numpy as np

    from repro_torch.core.irm import IRM
    from repro_torch.kernels.grouped_matmul import ops
    from repro_torch.runtime import RuntimeConfig, run_live
    from repro_torch.scenarios.engine import summarize_result

    stream, sim_config, irm_config = _microscopy(smoke=True)
    sim, sim_res = _simulate(stream, sim_config, irm_config)
    for size, kwargs, scale in MP_RUNS:
        what = f"multiproc {size}"
        cfg = sim_config()
        stats: dict = {}
        ops.launches = 0  # the forked workers start from this count
        res = run_live(
            stream(), cfg, irm=IRM(irm_config()),
            runtime=RuntimeConfig(time_scale=scale, payload="torch",
                                  payload_kwargs=dict(kwargs),
                                  transport="multiproc"),
            stats=stats,
        )
        live = summarize_result(res, cfg.dt)
        launches = stats["transport"]["payload_kernel_launches"]
        dev_ms = np.array(stats["payload_device_ms"])
        if not res.completed == res.total == 40:
            raise AssertionError(f"{what}: {res.completed}/{res.total} completed")
        if launches < res.completed:
            raise AssertionError(
                f"{what}: {launches} kernel launches for {res.completed} messages")
        if len(dev_ms) != res.completed or not (dev_ms > 0).all():
            raise AssertionError(
                f"{what}: {len(dev_ms)} device times for {res.completed} messages")
        _assert_parity(sim, live, int(res.target_workers[-1]),
                       ("sim", "final target", int(sim_res.target_workers[-1])), what)
        print(json.dumps({"multiproc": {
            "payload": size, "completed": int(res.completed),
            "total": int(res.total), "launches": int(launches),
            "time_scale": scale, "wall_s": stats["wall_s"],
            "msgs_per_s": stats["messages_per_s"],
            "device_ms_mean": float(dev_ms.mean()),
            "device_ms_p99": float(np.percentile(dev_ms, 99)),
            "workers_spawned": stats["transport"]["workers_spawned"],
        }}))


def _time_ms(torch, fn, reps: int, flush) -> float:
    """Median over ``reps`` of one call timed by CUDA events, each call made
    after ``flush`` has evicted the L2 cache (outside the events)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _bound(x, w, gs):
    """(bound ms, what bounds it): the work these bins need, counted once."""
    E, C, d = x.shape
    f = w.shape[2]
    g = gs.clamp(0, C).cpu().tolist()
    flops = 2.0 * sum(g) * d * f
    item = x.element_size()
    nbytes = (sum(g) * d + sum(1 for v in g if v > 0) * d * f
              + E * C * f) * item + 4 * E
    dtype = str(x.dtype).replace("torch.", "")
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _payload_inputs(torch):
    """The full payload shape's (x, w, group_sizes), made on the card from
    seed 0: every row of every bin live."""
    dev = torch.device("cuda")
    E, C, d = PAYLOAD_FULL["experts"], PAYLOAD_FULL["rows"], PAYLOAD_FULL["dim"]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((E, C, d), generator=gen, device=dev)
    w = torch.randn((E, d, d), generator=gen, device=dev)
    return x, w, torch.full((E,), C, dtype=torch.int32, device=dev)


def _bmm_yardstick(torch, x, w, gs):
    """One library call for the same function: ``torch.bmm`` and the row
    mask (timed beside the kernel, used nowhere in the port)."""
    valid = (torch.arange(x.shape[1], device=x.device)[None, :] < gs[:, None])[..., None]
    return lambda: torch.bmm(x, w).masked_fill_(~valid, 0.0)


def kernel_phase(torch, np):
    """Phase 4: the kernel against its plain version; returns the payload
    shape's record for the kernels line."""
    from repro_torch.kernels.grouped_matmul.kernel import grouped_matmul
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    # (name, E, C, d, f, dtype, group sizes or None for random, rtol, atol)
    # f32 2e-4 and bf16 (5e-2, 5e-1) are tests/test_kernels.py's own.  At the
    # full payload shape both versions sum 2048 fp32 products of unit normals
    # in different orders: each output's rounding error is about
    # u*sqrt(d)*|out| ~ 6e-8*45*45 ~ 1.2e-4, and the largest of 33.5M outputs
    # stays near 1e-3, so atol 1e-2 leaves a 10x margin and still catches
    # any wrong tile (errors of order |out| ~ 45).
    cases = []
    for E, C, d, f in ((4, 256, 128, 256), (2, 128, 256, 128), (8, 128, 64, 64)):
        cases.append((f"test {E}x{C}x{d}x{f} f32", E, C, d, f, f32, None, 2e-4, 2e-4))
        cases.append((f"test {E}x{C}x{d}x{f} bf16", E, C, d, f, bf16, None, 5e-2, 5e-1))
    cases += [
        ("empty bins gs=[0,0,64,0]", 4, 128, 64, 64, f32, [0, 0, 64, 0], 2e-4, 2e-4),
        ("ragged 3x100x70x90 f32", 3, 100, 70, 90, f32, [0, 37, 100], 2e-4, 2e-4),
        ("ragged 3x100x70x90 bf16", 3, 100, 70, 90, bf16, [0, 37, 100], 5e-2, 5e-1),
        ("ragged 2x300x520x136 bf16", 2, 300, 520, 136, bf16, [300, 77], 5e-2, 5e-1),
        ("payload default 4x64x64x64", 4, 64, 64, 64, f32, [64] * 4, 2e-4, 2e-4),
    ]
    rng = np.random.default_rng(0)
    paths = set()
    for name, E, C, d, f, dtype, sizes, rtol, atol in cases:
        gs_np = (rng.integers(0, C + 1, size=E) if sizes is None
                 else np.asarray(sizes))
        x_np = rng.normal(size=(E, C, d)) * (
            np.arange(C)[None, :] < gs_np[:, None])[..., None]
        x = torch.tensor(x_np, device=dev).to(dtype)
        w = torch.tensor(rng.normal(size=(E, d, f)), device=dev).to(dtype)
        gs = torch.tensor(gs_np, dtype=torch.int32, device=dev)
        which = _gmm_path(x, w)
        out, census = _with_census(lambda: grouped_matmul(x, w, gs))
        ref = grouped_matmul_ref(x, w, gs)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        pad = torch.arange(C, device=dev)[None, :] >= gs[:, None]
        pad_max = out.float().abs()[pad].max().item() if pad.any() else 0.0
        ok = torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)
        took = census == _expected_census(which, dtype, gs, C, f)
        print(f"[kernel] {name} ({which} path): max_abs_err={err:.3e} (rtol={rtol}, "
              f"atol={atol}) padding_max={pad_max} census {census} "
              f"{'ok' if ok and took else 'MISMATCH'}")
        if not ok or pad_max != 0.0 or not took:
            raise AssertionError(f"kernel disagrees with its plain version or took "
                                 f"another path: {name}")
        paths.add((which, str(dtype)))
    if paths != {("simt", "torch.float32"), ("simt", "torch.bfloat16"),
                 ("tma", "torch.bfloat16")}:
        raise AssertionError(f"phase 4 did not hold every path: {sorted(paths)}")

    # the full payload shape, data made on the card from a seed
    x, w, gs = _payload_inputs(torch)
    E, C, d = x.shape
    out = grouped_matmul(x, w, gs)
    ref = grouped_matmul_ref(x, w, gs)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    print(f"[kernel] payload full {E}x{C}x{d}x{d} f32: max_abs_err={err:.3e} "
          f"(atol=1e-2)")
    if not err <= 1e-2:
        raise AssertionError(f"kernel disagrees at the payload shape: {err}")
    del out, ref
    library = _bmm_yardstick(torch, x, w, gs)
    reps = 20
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    ms = _time_ms(torch, lambda: grouped_matmul(x, w, gs), reps, flush)
    plain_ms = _time_ms(torch, lambda: grouped_matmul_ref(x, w, gs), reps, flush)
    library_ms = _time_ms(torch, library, reps, flush)
    ms_again = _time_ms(torch, lambda: grouped_matmul(x, w, gs), reps, flush)
    bound_ms, bound_by = _bound(x, w, gs)
    flops = 2.0 * E * C * d * d
    print(f"[kernel] payload full: kernel {ms:.4f} ms (again {ms_again:.4f}), "
          f"plain {plain_ms:.4f} ms, torch.bmm+mask {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); kernel "
          f"{flops / ms / 1e9:.2f} TFLOP/s, {bound_ms / ms:.3f} of bound")
    del x, w
    torch.cuda.empty_cache()
    record = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }
    by_shape = {"payload full f32": record}
    for name, E, C, d, f, tokens in MOE_GMM:
        by_shape[f"moe {name} bf16"] = _gmm_moe_case(
            torch, grouped_matmul, grouped_matmul_ref, flush, name, E, C, d, f, tokens)
    return record, by_shape


def _moe_bins(torch, gen, E, C, tokens, top_k=8):
    """Rows per bin when each of ``tokens`` tokens picks ``top_k`` distinct
    experts of ``E`` at random; a bin keeps at most ``C``."""
    dev = gen.device
    picks = torch.rand((tokens, E), generator=gen, device=dev).argsort(dim=1)[:, :top_k]
    counts = torch.zeros(E, dtype=torch.int32, device=dev).index_add_(
        0, picks.reshape(-1), torch.ones(picks.numel(), dtype=torch.int32, device=dev))
    return counts.clamp(max=C)


def _moe_gmm_inputs(torch, E, C, d, f, tokens, top_k=8):
    """One MoE bin shape's bf16 (x, w, group_sizes, live rows), made on the
    card from seed 41: x zero past each bin's size, as the dispatch leaves
    it, and w scaled for outputs of unit variance."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    gs = _moe_bins(torch, gen, E, C, tokens, top_k)
    live = torch.arange(C, device=dev)[None, :] < gs[:, None]
    x = torch.randn((E, C, d), generator=gen, device=dev) * live[..., None]
    x = x.to(torch.bfloat16)
    w = (torch.randn((E, d, f), generator=gen, device=dev) / d ** 0.5).to(torch.bfloat16)
    return x, w, gs, live


def _gmm_path(x, w) -> str:
    """The path ``kernel.grouped_matmul`` takes for these inputs (its output
    is a fresh allocation, always aligned)."""
    from repro_torch.kernels.grouped_matmul import kernel

    return kernel.path(x.dtype, x.shape[2], w.shape[2], x.data_ptr(), w.data_ptr())


def _with_census(fn):
    """``fn()``'s result and the grouped matmul's tile census of it: the
    counting instances run only inside, never in a timed launch."""
    from repro_torch.kernels.grouped_matmul import kernel

    kernel.tile_census(True)
    try:
        out = fn()
    finally:
        counts = kernel.tile_census(False)
    return out, counts


def _expected_census(which, dtype, gs, C, f):
    """What the census must read for one launch: ``ref.tile_census`` on the
    tensor-core path, one SIMT call for bf16 on the SIMT path, else nothing."""
    import torch
    from repro_torch.kernels.grouped_matmul.ref import tile_census

    none = {"zero_tiles": 0, "halves_computed": 0, "halves_skipped": 0}
    if which == "tma":
        return {**tile_census(gs.cpu(), C, f), "simt_calls": 0}
    return {**none, "simt_calls": int(dtype == torch.bfloat16)}


def _gmm_moe_case(torch, grouped_matmul, grouped_matmul_ref, flush, name, E, C, d, f,
                  tokens, top_k=8):
    """The bf16 entry against its plain version at one MoE shape, held to
    ``GMM_BF16_TOLS`` and ``MOE_REL_L2`` beside two planted faults, with its
    rows past the bins 0, a second launch bitwise equal to the first and its
    tile census equal to ``ref.tile_census``; its times beside the bound."""
    x, w, gs, live = _moe_gmm_inputs(torch, E, C, d, f, tokens, top_k)
    which = _gmm_path(x, w)
    out, census = _with_census(lambda: grouped_matmul(x, w, gs))
    again = grouped_matmul(x, w, gs)
    ref = grouped_matmul_ref(x, w, gs)
    torch.cuda.synchronize()
    want_census = _expected_census(which, torch.bfloat16, gs, C, f)

    def rel_l2(a):
        return ((a.float() - ref.float()).norm() / ref.float().norm()).item()

    err = (out.float() - ref.float()).abs().max().item()
    rl2 = rel_l2(out)
    # planted faults, read against the plain version as the kernel is
    short = grouped_matmul_ref(x, w, (gs - 1).clamp(min=0))
    hole = x.clone()
    hole[..., d // 2:d // 2 + 64] = 0
    planted = {"last live row dropped": rel_l2(short),
               "a 64-deep k box left out": rel_l2(grouped_matmul_ref(hole, w, gs))}
    del short, hole
    pad = ~live
    pad_max = out.float().abs()[pad].max().item() if pad.any() else 0.0
    rtol, atol = GMM_BF16_TOLS
    checks = {"tensor-core path": which == "tma",
              "within TOLS": torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol),
              f"rel l2 <= {MOE_REL_L2}": rl2 <= MOE_REL_L2,
              "rows past the bins 0": pad_max == 0.0,
              "a second launch bitwise equal": torch.equal(again, out),
              "census equal to ref.tile_census": census == want_census,
              "planted faults above the limit": all(v > MOE_REL_L2 for v in planted.values())}
    rows, occupied = int(gs.sum()), int((gs > 0).sum())
    print(f"[kernel] moe {name} {E}x{C}x{d}x{f} bf16 ({which} path; {tokens} tokens' "
          f"top-{top_k}: {rows} live rows in {occupied} bins, most {int(gs.max())}): "
          f"max_abs_err={err:.3e} rel_l2={rl2:.3e} planted {json.dumps(planted)} "
          f"census {json.dumps(census)} {checks}")
    if not all(checks.values()):
        raise AssertionError(f"the bf16 entry disagrees with its plain version at "
                             f"the MoE {name} shape: {checks}")
    del out, again, ref
    library = _bmm_yardstick(torch, x, w, gs)
    reps = 20
    ms = _time_ms(torch, lambda: grouped_matmul(x, w, gs), reps, flush)
    plain_ms = _time_ms(torch, lambda: grouped_matmul_ref(x, w, gs), reps, flush)
    library_ms = _time_ms(torch, library, reps, flush)
    ms_again = _time_ms(torch, lambda: grouped_matmul(x, w, gs), reps, flush)
    bound_ms, bound_by = _bound(x, w, gs)
    useful = 2.0 * rows * d * f
    print(f"[kernel] moe {name}: kernel {ms:.4f} ms (again {ms_again:.4f}), plain "
          f"{plain_ms:.4f} ms, torch.bmm+mask {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); kernel {useful / ms / 1e9:.2f} TFLOP/s "
          f"of live rows, {bound_ms / ms:.3f} of bound, {ms / library_ms:.3f}x bmm")
    del x, w, library
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "rel_l2": rl2, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "live_rows": rows, "occupied_bins": occupied, "path": which,
            "census": census, "planted": planted}


def full_phase(torch, np):
    """Phase 5: the full microscopy stream in-process; returns launches."""
    from repro_torch.core.irm import IRM
    from repro_torch.kernels.grouped_matmul import ops
    from repro_torch.runtime import RuntimeConfig, run_live
    from repro_torch.scenarios.engine import summarize_result

    stream, sim_config, irm_config = _microscopy(smoke=False)
    sim, sim_res = _simulate(stream, sim_config, irm_config)
    witness = run_live(
        stream(), sim_config(), irm=IRM(irm_config()),
        runtime=RuntimeConfig(time_scale=FULL_TIME_SCALE, payload="sleep"),
    )
    print(f"[full] time_scale={FULL_TIME_SCALE}; sleep witness: "
          f"{witness.completed}/{witness.total} completed, target at the last "
          f"dispatch {_target_at_last_dispatch(witness)}, final target "
          f"{int(witness.target_workers[-1])}; sim: target at the last dispatch "
          f"{_target_at_last_dispatch(sim_res)}, final {int(sim_res.target_workers[-1])}")

    cfg = sim_config()
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    ops.launches = 0
    res = run_live(
        stream(), cfg, irm=IRM(irm_config()),
        runtime=RuntimeConfig(time_scale=FULL_TIME_SCALE, payload="torch",
                              payload_kwargs=dict(PAYLOAD_FULL)),
        stats=stats,
    )
    launches = ops.launches
    peak_mem = torch.cuda.max_memory_allocated()
    live = summarize_result(res, cfg.dt)
    if not res.completed == res.total == 767:
        raise AssertionError(f"full: {res.completed}/{res.total} completed")
    if launches < res.completed:
        raise AssertionError(
            f"full: {launches} kernel launches for {res.completed} messages")
    print(f"[full] final target: live {int(res.target_workers[-1])}, sleep witness "
          f"{int(witness.target_workers[-1])} (a drain transient, not held)")
    _assert_parity(sim, live, _target_at_last_dispatch(res),
                   ("sleep witness", "target at the last dispatch",
                    _target_at_last_dispatch(witness)), "full")
    lat = np.array([m.done_t - m.arrival for m in res.messages])
    dev_ms = np.array(stats["payload_device_ms"])
    busy = float(dev_ms.sum() / 1e3 / stats["wall_s"])
    print("[full] " + json.dumps({
        "completed": int(res.completed), "launches": launches,
        "time_scale": FULL_TIME_SCALE, "wall_s": stats["wall_s"],
        "msgs_per_s": stats["messages_per_s"],
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "latency_p50_wall_s": float(np.percentile(lat, 50)) * FULL_TIME_SCALE,
        "latency_p99_wall_s": float(np.percentile(lat, 99)) * FULL_TIME_SCALE,
        "device_ms_mean": float(dev_ms.mean()),
        "device_ms_p99": float(np.percentile(dev_ms, 99)),
        "device_busy_share": busy,
        "peak_device_mem_gib": peak_mem / 2**30,
        "irm_step_ms_p99": stats["irm_step_ms_p99"],
    }))
    if not busy <= MAX_DEVICE_BUSY:
        raise AssertionError(
            f"full: the card was {busy:.3f} busy, over {MAX_DEVICE_BUSY}")
    return launches


def _decode_inputs(torch, np, dtype, shape=DECODE):
    """The decode-shape inputs: ragged lengths in 64-1056 and one of 0,
    pages dealt from a permutation of pages 1..P-1, one -1 inside a live
    range (it reads page 0), and NaN in every page no entry refers to."""
    dev = torch.device("cuda")
    B, H, KVH, D = shape["B"], shape["H"], shape["KVH"], shape["D"]
    ps, P, maxp = shape["page_size"], shape["num_pages"], shape["max_pages"]
    rng = np.random.default_rng(13)
    lens = rng.integers(*shape.get("lens", (64, 1057)), size=B)
    lens[3] = 0
    perm = rng.permutation(np.arange(1, P))
    table = np.full((B, maxp), -1, np.int32)
    off = 0
    for b, n in enumerate(-(-lens // ps)):
        table[b, :n] = perm[off:off + n]
        off += n
    hole = int(np.argmax(lens))
    table[hole, 1] = -1
    referenced = set(table[table >= 0].tolist()) | {0}
    unreferenced = [p for p in range(P) if p not in referenced]
    gen = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
    k_pool = torch.randn((P, ps, KVH, D), generator=gen, device=dev).to(dtype)
    v_pool = torch.randn((P, ps, KVH, D), generator=gen, device=dev).to(dtype)
    k_pool[unreferenced] = float("nan")
    v_pool[unreferenced] = float("nan")
    return (q, k_pool, v_pool, torch.tensor(table, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev)), lens


def _sdpa_yardstick(torch, args, lens, window=0):
    """One library call for the same function: ``scaled_dot_product_attention``
    on K/V gathered beforehand to the longest live length (the gather is
    left out of its time), masked to each sequence's tokens (its last
    ``window`` with a window)."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.ref import gather_pages

    q, k_pool, v_pool, table, lens_t = args
    n_live = -(-int(lens.max()) // k_pool.shape[1])
    k_d = gather_pages(k_pool, table[:, :n_live]).transpose(1, 2).contiguous()
    v_d = gather_pages(v_pool, table[:, :n_live]).transpose(1, 2).contiguous()
    t = torch.arange(k_d.shape[2], device=q.device)[None, :]
    mask = t < lens_t[:, None]
    if window > 0:
        mask &= t >= lens_t[:, None] - window
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q4, k_d, v_d, attn_mask=mask,
                                                  enable_gqa=True)


def _paged_bound(args, lens, window=0):
    """(bound ms, what bounds it, bytes, flops) of a call: the live tokens'
    (each sequence's last ``window`` with a window) K and V, q, out, the
    table and the lengths, each moved once."""
    q, k_pool, _, table, _ = args
    B, H, D = q.shape
    KVH = k_pool.shape[2]
    item = q.element_size()
    tokens = int((lens if window <= 0 else lens.clip(max=window)).sum())
    nbytes = (2 * tokens * KVH * D + 2 * B * H * D) * item + table.numel() * 4 + B * 4
    flops = 4.0 * tokens * H * D
    dtype = str(q.dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def _paged_case(torch, np, key, shape, name, flush, window=0):
    """The paged kernel against its plain version at one decode shape in
    ``name``'s dtype, over each sequence's last ``window`` tokens with a
    window; in bf16 (the serving dtype), and with a window, its times beside
    the bound and the library yardstick (with a window, the same call's
    time without one too), returned as its record (else None).  With a
    window, NaN in every page wholly before it must not reach the output."""
    from repro_torch.kernels.paged_attention.kernel import paged_decode_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    dtype = getattr(torch, name)
    args, lens = _decode_inputs(torch, np, dtype, shape)
    out = paged_decode_attention(*args, window)
    ref = paged_attention_ref(*args, window)
    torch.cuda.synchronize()
    rtol, atol = PAGED_TOLS[name]
    err = (out.float() - ref.float()).abs().max().item()
    zero_row = int(np.flatnonzero(lens == 0)[0])
    again = paged_decode_attention(*args, window)  # back to back: the counters reset
    checks = {
        "within TOLS": torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol),
        "finite": bool(torch.isfinite(out).all()),
        "length-0 row is 0": bool((out[zero_row] == 0).all()),
        "a second launch gives the same bits": torch.equal(again, out),
    }
    if window > 0:
        q, k_pool, v_pool, table, lens_t = args
        ps = k_pool.shape[1]
        before = [int(table[b, i]) for b, n in enumerate(lens.tolist())
                  for i in range(max(n - window, 0) // ps) if table[b, i] > 0]
        kn, vn = k_pool.clone(), v_pool.clone()
        kn[before], vn[before] = float("nan"), float("nan")
        checks[f"{len(before)} pages before the windows unread"] = torch.equal(
            paged_decode_attention(q, kn, vn, table, lens_t, window), out)
        del kn, vn
    label = f"{key} {name}" + (f" window {window}" if window else "")
    print(f"[paged] {label}: lens={lens.tolist()} max_abs_err={err:.3e} "
          f"(rtol={rtol}, atol={atol}) {checks}")
    if not all(checks.values()):
        raise AssertionError(f"paged kernel disagrees with its plain version "
                             f"at {label}: {checks}")
    if name != "bfloat16" and not window:
        return None
    # the serving dtype, or a window: times, bound and library yardstick
    library = _sdpa_yardstick(torch, args, lens, window)
    reps = 50
    ms = _time_ms(torch, lambda: paged_decode_attention(*args, window), reps, flush)
    plain_ms = _time_ms(torch, lambda: paged_attention_ref(*args, window), reps, flush)
    library_ms = _time_ms(torch, library, reps, flush)
    ms_again = _time_ms(torch, lambda: paged_decode_attention(*args, window), reps, flush)
    bound_ms, bound_by, nbytes, flops = _paged_bound(args, lens, window)
    record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    if window:
        record["window"] = window
        record["unwindowed_ms"] = _time_ms(torch, lambda: paged_decode_attention(*args),
                                           reps, flush)
    print(f"[paged] {label} at the decode shape: kernel {ms:.4f} ms (again "
          f"{ms_again:.4f}), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB of "
          f"live K/V, q, out, table; {flops / 1e9:.3f} GFLOP); kernel at "
          f"{bound_ms / ms:.3f} of the bound, {nbytes / ms / 1e6:.1f} GB/s, "
          f"{ms / library_ms:.3f}x sdpa"
          + (f"; without the window {record['unwindowed_ms']:.4f} ms" if window else ""))
    return record


def paged_kernel_phase(torch, np):
    """Phase 6: the paged kernel against its plain version at the decode
    shapes of qwen3-8b (f32 and bf16) and qwen3-moe-30b-a3b (bf16); returns
    each bf16 shape's record for the kernels line."""
    dev = torch.device("cuda")
    records = {}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for arch, shape, name in (("qwen3-8b", DECODE, "float32"),
                              ("qwen3-8b", DECODE, "bfloat16"),
                              (MOE_ARCH, MOE_DECODE, "bfloat16")):
        key = f"{arch} G={shape['H'] // shape['KVH']}"
        record = _paged_case(torch, np, key, shape, name, flush)
        if record is not None:
            records[key] = record
    # qwen3-8b's decode shape with phase 10b's sliding window, both dtypes
    window = {}
    for name in ("bfloat16", "float32"):
        key = f"qwen3-8b G=4 window {SERVE_WINDOW} {name}"
        window[key] = _paged_case(torch, np, "qwen3-8b G=4", DECODE, name, flush,
                                  SERVE_WINDOW)

    del flush
    torch.cuda.empty_cache()
    return records, window


def _train_batches(B=TRAIN["B"]):
    """The batches of ``B`` rows the training pipeline packs for olmo-1b at
    4096 tokens (``launch/train.py``'s stream: the same documents, seed)."""
    from repro_torch.configs import get_config
    from repro_torch.data import StreamingPipeline, synthetic_documents

    S = TRAIN["S"]
    return iter(StreamingPipeline(
        synthetic_documents(get_config("olmo-1b").vocab_size, mean_len=S // 3,
                            max_len=4 * S, seed=0),
        seq_len=S, batch_size=B, prefetch=0))


def _multi_segment_batch():
    """(index, batch): the first batch of that stream whose rows each hold
    at least two documents, as most of the train run's rows do."""
    for i, pb in zip(range(MULTI_SEGMENT_SEARCH), _train_batches()):
        if (pb.segment_ids.max(axis=1) >= 2).all():
            return i, pb
    raise AssertionError(f"none of the first {MULTI_SEGMENT_SEARCH} packed batches "
                         "holds two documents in every row")


def _visible_pairs(np, seg):
    """The (query, key) pairs causal packed attention must compute: per row
    and segment id > 0 that occurs n times, n (n + 1) / 2."""
    pairs = 0
    for row in seg:
        _, counts = np.unique(row[row > 0], return_counts=True)
        pairs += int((counts * (counts + 1) // 2).sum())
    return pairs


def _packed_flops(kind, pairs, H, D):
    """The visible work: 4 D flops a visible pair and head forward (S = QK^T
    and P.V), 10 D backward (S recomputed, dP, dV, dK, dQ)."""
    return (4.0 if kind == "fwd" else 10.0) * D * H * pairs


def _packed_bound(kind, pairs, B, S, H, KVH, D, dtype, Skv=None, residual=False, peak=None):
    """(bound ms, what bounds it) for the forward (``fwd``) or the backward
    (``bwd``): ``_packed_flops`` over the peak of ``dtype`` (or of ``peak``,
    a key of PEAK_FLOPS: ``tf32x3`` for the float32 kernels' tensor-core
    route), each input read once and each output written once: in bf16 the
    forward writes the output's residual too when ``residual`` (a training
    forward), the backward always reads it; in float32 there is none."""
    f32 = dtype == "float32"
    item = 4 if f32 else 2
    lo = 0 if f32 else 1  # the residual's tensors
    Skv = S if Skv is None else Skv  # S is the queries' length
    q_el, kv_el = B * S * H * D, B * Skv * KVH * D
    seg_b, lse_b = (B * S + B * Skv) * 4, B * H * S * 4
    flops = _packed_flops(kind, pairs, H, D)
    if kind == "fwd":
        nbytes = ((2 + lo * residual) * q_el + 2 * kv_el) * item + seg_b + lse_b
    else:
        nbytes = ((4 + lo) * q_el + 4 * kv_el) * item + seg_b + lse_b
    t_ops, t_bytes = flops / PEAK_FLOPS[peak or dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _within(readings, limits) -> bool:
    """Every (tensor, worst tile) reading within the (tensor, tile) limits."""
    return all(w <= limits[0] and t <= limits[1] for w, t in readings.values())


def _fmt(readings) -> str:
    return "{" + ", ".join(f"{n} {w:.2e}/{t:.2e}" for n, (w, t) in readings.items()) + "}"


def _plain_rows(torch, packed_ops, q, k, v, g, seg_q, seg_kv, causal=True):
    """The plain version's output and (dq, dk, dv), one row of the batch at
    a time (its scores are dense fp32)."""
    out, grads = torch.empty_like(q), [torch.empty_like(t) for t in (q, k, v)]
    for b in range(q.shape[0]):
        rs = [t[b:b + 1].clone().requires_grad_(True) for t in (q, k, v)]
        ref = packed_ops.packed_attention_plain(*rs, seg_q[b:b + 1], seg_kv[b:b + 1],
                                                causal=causal)
        ref.backward(g[b:b + 1])
        out[b:b + 1] = ref.detach()
        for i in range(3):
            grads[i][b:b + 1] = rs[i].grad
        del rs, ref
    return out, grads


def _planted_faults(torch, packed_ops, rel_l2, q, k, v, g, seg, ref_out, ref_grads):
    """What the error measure reads for two faults a kernel could have,
    built from the plain version: the key tile at S/2 hidden from every
    query (a skipped tile: its dk and dv are 0, and the later queries of its
    document lose it), and dQ taken with delta = 0 (dS = P dP instead of
    P (dP - delta): dq + scale delta (P K), where P K is the attention
    output with K for V)."""
    S, D = q.shape[1], q.shape[3]
    hidden = seg.clone()
    hidden[:, S // 2:S // 2 + 64] = int(seg.max()) + 1  # an id no query holds
    out_h, grads_h = _plain_rows(torch, packed_ops, q, k, v, g, seg, hidden)
    tile = {n: rel_l2(a, b) for n, a, b in zip(
        ("out", "dq", "dk", "dv"), (out_h, *grads_h), (ref_out, *ref_grads))}
    del out_h, grads_h
    dq0 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for b in range(q.shape[0]):
        with torch.no_grad():
            pk = packed_ops.packed_attention_plain(q[b:b + 1], k[b:b + 1], k[b:b + 1],
                                                   seg[b:b + 1], seg[b:b + 1])
        delta = (g[b:b + 1].float() * ref_out[b:b + 1].float()).sum(-1, keepdim=True)
        dq0[b:b + 1] = ref_grads[0][b:b + 1].float() + delta * pk.float() / D ** 0.5
    return {"key tile hidden": tile, "delta = 0": {"dq": rel_l2(dq0, ref_grads[0])}}


def _tf32_fault(torch, rel_l2, q, k, v, g, seg, ref_out, ref_grads):
    """What the error measure reads for the float32 kernels' products taken
    as one pass of plain TF32 (hi.hi: ``ref.packed_attention_tf32`` and
    ``ref.packed_attention_bwd_tf32`` with ``passes=1``, causal, a row of
    the batch at a time), against the plain version's output and gradients:
    the fault 3xTF32 exists to avoid."""
    from repro_torch.kernels.packed_attention.ref import (
        packed_attention_bwd_tf32,
        packed_attention_tf32,
    )

    out = torch.empty_like(ref_out, dtype=torch.float32)
    grads = [torch.empty_like(t, dtype=torch.float32) for t in ref_grads]
    for b in range(q.shape[0]):
        rows = [t[b:b + 1] for t in (q, k, v)]
        o, lse = packed_attention_tf32(*rows, seg[b:b + 1], seg[b:b + 1], passes=1)
        out[b:b + 1] = o
        for dst, x in zip(grads, packed_attention_bwd_tf32(
                *rows, seg[b:b + 1], seg[b:b + 1], o, g[b:b + 1], lse, passes=1)):
            dst[b:b + 1] = x
    return {n: rel_l2(a, b) for n, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads),
                                               (ref_out, *ref_grads))}


def _kernel_run(packed_ops, q, k, v, g, seg, seg_kv=None, causal=True):
    """The kernels' output and (dq, dk, dv) through ``ops.packed_attention``."""
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = packed_ops.packed_attention(*ts, seg, seg if seg_kv is None else seg_kv,
                                      causal=causal)
    out.backward(g)
    return out.detach(), [t.grad for t in ts]


def packed_kernel_phase(torch, np):
    """Phase 7: the packed kernels against the autograd of their plain
    version at the train shapes and the prefill shape; returns each shape's
    records (forward, backward) for the kernels line, the train shape's
    first."""
    import torch.nn.functional as F

    from repro_torch.kernels.packed_attention import kernel as pk
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.kernels.packed_attention.ref import census_rule, rel_l2, tile_shares

    dev = torch.device("cuda")
    # the kernels take q, k, v all bf16 or all float32: float32 beside bf16
    # on the card raises and launches nothing
    z = torch.zeros((1, 64, 1, 64), device=dev)
    ones = torch.ones((1, 64), dtype=torch.int32, device=dev)
    before = (packed_ops.launches_fwd, packed_ops.launches_bwd)
    try:
        packed_ops.packed_attention(z, z.bfloat16(), z.bfloat16(), ones, ones)
        refused = False
    except TypeError:
        refused = True
    if not refused or (packed_ops.launches_fwd, packed_ops.launches_bwd) != before:
        raise AssertionError("float32 beside bf16 on the card did not raise, or launched")
    print("[packed] float32 q beside bf16 k, v on the card: TypeError, no launch")

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    first = np.concatenate([next(_train_batches()).segment_ids,
                            np.zeros((1, TRAIN["S"]), np.int32)])  # + a padded row
    multi_idx, multi = _multi_segment_batch()
    shapes = (("train", dict(TRAIN, B=TRAIN["B"] + 1), first),
              (f"train batch {multi_idx}", TRAIN, multi.segment_ids),
              ("prefill", PREFILL, np.ones((PREFILL["B"], PREFILL["S"]), np.int32)))
    rtol, atol = PACKED_TOLS
    records = {}
    for shape_name, shp, seg_np in shapes:
        B, S, H, KVH, D = (shp[k] for k in ("B", "S", "H", "KVH", "D"))
        seg = torch.tensor(seg_np, device=dev)
        pairs = _visible_pairs(np, seg_np)
        print(f"[packed] {shape_name}: B={B} S={S} H={H} KVH={KVH} D={D}; "
              f"segments per row {[int(r.max()) for r in seg_np]}; visible pairs "
              f"{pairs} of {B * S * (S + 1) // 2} causal")
        gen = torch.Generator(device=dev).manual_seed(23)
        q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                      for shape in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D),
                                    (B, S, H, D)))
        out, grads = _kernel_run(packed_ops, q, k, v, g, seg)
        ref_out, ref_grads = _plain_rows(torch, packed_ops, q, k, v, g, seg, seg)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_g = [(a.float() - b.float()).abs().max().item()
                 for a, b in zip(grads, ref_grads)]
        readings = {n: rel_l2(a, b) for n, a, b in zip(
            ("out", "dq", "dk", "dv"), (out, *grads), (ref_out, *ref_grads))}
        faults = _planted_faults(torch, packed_ops, rel_l2, q, k, v, g, seg,
                                 ref_out, ref_grads)
        checks = {
            "out within TOLS": torch.allclose(out.float(), ref_out.float(),
                                              rtol=rtol, atol=atol),
            f"out, dq, dk, dv within rel l2 {PACKED_REL_L2}": _within(
                readings, PACKED_REL_L2),
            "each planted fault reads above the limits": all(
                not _within(f, PACKED_REL_L2) for f in faults.values()),
            "finite": all(bool(torch.isfinite(t).all()) for t in (out, *grads)),
        }
        pad = seg == 0
        if bool(pad.all(dim=1).any()):
            checks["padded row: output and gradients 0"] = bool(
                (out[pad] == 0).all()) and all(bool((t[pad] == 0).all()) for t in grads)
        print(f"[packed] {shape_name} bf16: max_abs_err out {err_out:.3e}, dq/dk/dv "
              f"{[f'{e:.3e}' for e in err_g]}; rel l2 (tensor/worst tile) "
              f"{_fmt(readings)}; planted faults " + "; ".join(
                  f"{n} {_fmt(f)}" for n, f in faults.items()) + f" {checks}")
        if not all(checks.values()):
            raise AssertionError(f"packed kernels disagree with their plain version "
                                 f"at the {shape_name} shape: {checks}")
        if shape_name == "train":
            # the kernels use no atomics: a second forward and backward on the
            # same inputs give the same bits
            out2, grads2 = _kernel_run(packed_ops, q, k, v, g, seg)
            same = torch.equal(out, out2) and all(
                torch.equal(a, b) for a, b in zip(grads, grads2))
            print(f"[packed] {shape_name}: a second forward and backward bitwise equal "
                  f"to the first: {same}")
            if not same:
                raise AssertionError("the packed kernels are not deterministic")
            del out2, grads2
        del out, grads, ref_out, ref_grads
        torch.cuda.empty_cache()
        # the tiles each kernel classed, counted by the kernels, against the
        # rule in PyTorch once per head (per KV head in dK/dV), with the
        # training forward's residual; the serving forward (no residual)
        # writes the same output
        pk.tile_census(on=True)
        o, lse, lo = pk.packed_flash_attention(q, k, v, seg, seg, residual=True)
        pk.packed_flash_attention_bwd(q, k, v, seg, seg, o, lo, g, lse)
        census = pk.tile_census(on=False)
        rule = census_rule(seg, seg, H, KVH)
        tiles = {kern: tile_shares(census[kern]) for kern in census}
        same_out = torch.equal(o, pk.packed_flash_attention(q, k, v, seg, seg)[0])
        print(f"[packed] {shape_name}: tile pairs in range skipped/full/masked, counted "
              f"by the kernels (tile census) " + "; ".join(
                  f"{kern} {x['skipped']:.3f}/{x['full']:.3f}/{x['masked']:.3f} of "
                  f"{x['tiles']}" for kern, x in tiles.items())
              + f"; equal to ref.tile_schedule's x heads: {census == rule}; the forward "
              f"without the residual bitwise the same output: {same_out}")
        if census != rule or not same_out:
            raise AssertionError(f"the kernels' tile census {census} differs from "
                                 f"ref.tile_schedule's {rule} at the {shape_name} shape, "
                                 f"or the residual changed the output ({same_out})")
        # times, bounds and the library yardstick: the training forward
        # (with the residual), and the serving forward beside it
        reps = 5
        fwd_ms = _time_ms(torch, lambda: pk.packed_flash_attention(
            q, k, v, seg, seg, residual=True), reps, flush)
        bwd_ms = _time_ms(torch, lambda: pk.packed_flash_attention_bwd(
            q, k, v, seg, seg, o, lo, g, lse), reps, flush)
        ps = [t.clone().requires_grad_(True) for t in (q, k, v)]
        with torch.no_grad():
            plain_fwd_ms = _time_ms(torch, lambda: packed_ops.packed_attention_plain(
                *ps, seg, seg), 3, flush)
        ref = packed_ops.packed_attention_plain(*ps, seg, seg)
        plain_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
            ref, ps, g, retain_graph=True), 3, flush)
        del ref, ps
        torch.cuda.empty_cache()
        hs = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
        gt = g.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(*hs, is_causal=True,
                                                  enable_gqa=H != KVH)

        with torch.no_grad():
            sdpa_fwd_ms = _time_ms(torch, sdpa, reps, flush)
        sd = sdpa()
        sdpa_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
            sd, hs, gt, retain_graph=True), reps, flush)
        fwd_again = _time_ms(torch, lambda: pk.packed_flash_attention(
            q, k, v, seg, seg, residual=True), reps, flush)
        serve_ms = _time_ms(torch, lambda: pk.packed_flash_attention(q, k, v, seg, seg),
                            reps, flush)
        del sd, hs, o, lse, lo
        fb, fb_by = _packed_bound("fwd", pairs, B, S, H, KVH, D, "bfloat16", residual=True)
        sb, sb_by = _packed_bound("fwd", pairs, B, S, H, KVH, D, "bfloat16")
        bb, bb_by = _packed_bound("bwd", pairs, B, S, H, KVH, D, "bfloat16")
        useful = 4.0 * D * H * pairs
        print(f"[packed] {shape_name} bf16: forward with the residual {fwd_ms:.4f} ms "
              f"(again {fwd_again:.4f}; {useful / fwd_ms / 1e9:.1f} TFLOP/s of visible "
              f"work), plain {plain_fwd_ms:.4f} ms, sdpa causal {sdpa_fwd_ms:.4f} ms, "
              f"bound {fb:.4f} ms ({fb_by}); without the residual {serve_ms:.4f} ms, "
              f"bound {sb:.4f} ms ({sb_by}); backward {bwd_ms:.4f} ms "
              f"({2.5 * useful / bwd_ms / 1e9:.1f} TFLOP/s), plain {plain_bwd_ms:.4f} ms, "
              f"sdpa causal {sdpa_bwd_ms:.4f} ms, bound {bb:.4f} ms ({bb_by})")
        records[shape_name] = (
            {"max_abs_err": err_out, "ms": fwd_ms, "plain_ms": plain_fwd_ms,
             "bound_ms": fb, "bound_by": fb_by, "library_ms": sdpa_fwd_ms,
             "no_residual_ms": serve_ms, "tiles": tiles["forward"]},
            {"max_abs_err": max(err_g), "ms": bwd_ms, "plain_ms": plain_bwd_ms,
             "bound_ms": bb, "bound_by": bb_by, "library_ms": sdpa_bwd_ms,
             "tiles": tiles["dk/dv"]},
        )
        del q, k, v, g
        torch.cuda.empty_cache()
    moe_record = _packed_forward_case(torch, pk, packed_ops, rel_l2, flush, MOE_PREFILL)
    del flush
    torch.cuda.empty_cache()
    return records, moe_record


def _packed_forward_case(torch, pk, packed_ops, rel_l2, flush, shp):
    """The packed forward alone against its plain version, one document a
    row (a serving prefill); returns its record for the kernels line."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    B, S, H, KVH, D = (shp[k] for k in ("B", "S", "H", "KVH", "D"))
    seg = torch.ones((B, S), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(43)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    with torch.no_grad():
        out = packed_ops.packed_attention(q, k, v, seg, seg)
        ref = torch.cat([packed_ops.packed_attention_plain(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], seg[b:b + 1], seg[b:b + 1])
            for b in range(B)])
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    reading = rel_l2(out, ref)
    rtol, atol = PACKED_TOLS
    checks = {"out within TOLS": torch.allclose(out.float(), ref.float(),
                                                rtol=rtol, atol=atol),
              f"rel l2 within {PACKED_REL_L2}": _within({"out": reading}, PACKED_REL_L2),
              "finite": bool(torch.isfinite(out).all())}
    print(f"[packed] {MOE_ARCH} prefill forward B={B} S={S} H={H} KVH={KVH} D={D}: "
          f"max_abs_err {err:.3e}, rel l2 (tensor/worst tile) {_fmt({'out': reading})} "
          f"{checks}")
    if not all(checks.values()):
        raise AssertionError(f"the packed forward disagrees with its plain version at "
                             f"{MOE_ARCH}'s prefill shape: {checks}")
    del out, ref
    reps = 5
    ms = _time_ms(torch, lambda: pk.packed_flash_attention(q, k, v, seg, seg), reps, flush)
    with torch.no_grad():
        plain_ms = _time_ms(torch, lambda: packed_ops.packed_attention_plain(
            q, k, v, seg, seg), 3, flush)
        hs = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        sdpa_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            *hs, is_causal=True, enable_gqa=True), reps, flush)
    pairs = B * S * (S + 1) // 2
    bound, bound_by = _packed_bound("fwd", pairs, B, S, H, KVH, D, "bfloat16")
    print(f"[packed] {MOE_ARCH} prefill forward: {ms:.4f} ms ({4.0 * D * H * pairs / ms / 1e9:.1f} "
          f"TFLOP/s), plain {plain_ms:.4f} ms, sdpa causal {sdpa_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({bound_by})")
    del q, k, v, hs
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": sdpa_ms}


def packed_f32_phase(torch, np):
    """Phase 7b: the packed kernels' float32 instances, forward and
    backward, against the autograd of their plain version in fp32
    (``_family_packed_case`` at phase 7b's limits, beside phase 7's planted
    faults): olmo-1b's train shape cut to ``F32_TRAIN_ROWS`` rows (the
    first batch phase 11d trains on), the serving prefill shape, then each
    head dim; returns the by_shape records (forward, backward), the train
    shape's first."""
    from repro_torch.kernels.packed_attention import kernel as pk
    from repro_torch.kernels.packed_attention import ops as packed_ops

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("the plain version's fp32 products must not run in TF32")
    dev = torch.device("cuda")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = next(_train_batches(F32_TRAIN_ROWS)).segment_ids
    S, H, KVH, D = (TRAIN[k] for k in ("S", "H", "KVH", "D"))
    cases = [("train f32", F32_TRAIN_ROWS, S, H, KVH, D, rows, True),
             ("prefill f32", PREFILL["B"], PREFILL["S"], PREFILL["H"], PREFILL["KVH"],
              PREFILL["D"], None, False)]
    cases += [(f"f32 D={d}", 2, 1024, 8, 2, d, _two_document_ids(np, 2, 1024, 1024), True)
              for d in F32_HEAD_DIMS]
    fwd, bwd = {}, {}
    for name, B, S_, H_, KVH_, D_, seg, trained in cases:
        fwd[name], bwd[name] = _family_packed_case(
            torch, np, pk, packed_ops, name, B, S_, S_, H_, KVH_, D_, True, flush,
            trained=trained, seg=seg, tag="packed-f32", dtype=torch.float32,
            tf32_fault=name == F32_TF32_FAULT_CASE)
    del flush
    torch.cuda.empty_cache()
    return fwd, bwd


class _PlainPaged:
    """Stands in for ``kernels.paged_attention.ops`` in ``models.layers``:
    the plain version, on the card (the plain route)."""

    @staticmethod
    def paged_attention(q, k_pool, v_pool, page_table, seq_lens, *, window=0):
        from repro_torch.kernels.paged_attention.ref import paged_attention_ref

        return paged_attention_ref(q, k_pool, v_pool, page_table, seq_lens, window)


def serve_f32_phase(torch):
    """Phase 9b: ``launch.serve.run_local`` on qwen3-8b at full width and
    depth in float32 (weights and pool), as the JAX package's ``run_local``
    serves, through the kernels' float32 instances; then the same run on the
    plain route (the plain flash path and the plain paged version, on the
    card).  Every greedy token equal, the prefill's logits within
    ``F32_SERVE_TOL`` of max |logit|; returns the (paged, packed forward)
    launches of the kernels' run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.launch import serve
    from repro_torch.models import layers

    cfg = get_config("qwen3-8b")
    runs = {}
    for route in ("kernels", "plain"):
        logits = []

        def recording(lg, greedy=serve.greedy):
            logits.append(lg.detach().clone())
            return greedy(lg)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.ExitStack() as stack:
            stack.enter_context(_patched(serve, "greedy", recording))
            if route == "plain":
                stack.enter_context(_routed(packed=_PlainPacked))
                stack.enter_context(_patched(layers, "paged_ops", _PlainPaged))
            _zero_counts()
            stats = serve.run_local(serve.parse_args(SERVE_ARGV), dtype=torch.float32)
            torch.cuda.synchronize()
            counts = _counts()
        runs[route] = (stats, logits, counts, torch.cuda.max_memory_allocated() / 2**30)
    (got, got_logits, counts, peak), (ref, ref_logits, ref_counts, ref_peak) = (
        runs["kernels"], runs["plain"])
    n = cfg.n_layers
    scale = ref_logits[0].abs().max().item()
    prefill_gap = (got_logits[0] - ref_logits[0]).abs().max().item()
    step_gaps = [(a - b).abs().max().item() for a, b in zip(got_logits[1:], ref_logits[1:])]
    same_tokens = torch.equal(got["tokens"], ref["tokens"])
    print("[serve-f32] " + json.dumps({
        "dtype": "float32", "launches": counts, "plain_route_launches": ref_counts,
        "prefill_s": got["prefill_s"], "plain_prefill_s": ref["prefill_s"],
        "decode_ms_per_step": got["decode_s"] / got["gen_tokens"] * 1e3,
        "plain_decode_ms_per_step": ref["decode_s"] / ref["gen_tokens"] * 1e3,
        "tokens_per_s": got["sequences"] * got["gen_tokens"] / got["seconds"],
        "peak_device_mem_gib": peak, "plain_peak_device_mem_gib": ref_peak,
        "pages_used": got["pages_used"], "max_abs_logit": scale,
        "prefill_max_abs_dlogit": prefill_gap, "decode_max_abs_dlogit": step_gaps,
        "tokens_equal": same_tokens}))
    checks = {
        f"paged launches == {n} x {got['gen_tokens']}": counts["paged"] == n * got["gen_tokens"],
        f"packed launches (forward, backward) == ({n}, 0)": (
            counts["packed"], counts["packed_bwd"]) == (n, 0),
        "the plain route launched nothing": not any(ref_counts.values()),
        "all logits finite": got["logits_finite"] and all(
            bool(torch.isfinite(x).all()) for x in got_logits),
        f"prefill logits within {F32_SERVE_TOL} of max |logit|":
            prefill_gap <= F32_SERVE_TOL * scale,
        f"greedy tokens equal for {got['gen_tokens']} steps": same_tokens,
        "tokens (8, 17)": tuple(got["tokens"].shape) == (8, 17),
    }
    print(f"[serve-f32] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"float32 serving: {checks}")
    del got_logits, ref_logits, runs
    torch.cuda.empty_cache()
    return counts["paged"], counts["packed"]


def train_f32_phase(torch, np):
    """Phase 11d: olmo-1b trained in float32 compute at full width and depth
    (``F32_TRAIN_ROWS`` train_4k rows, remat "nothing", the packed kernels'
    float32 instances): step 1's loss and named gradients on the kernels
    against the plain route (the plain flash path) from the same masters and
    batch, beside the plain route's one-ulp witness and a planted fault (a
    segment boundary dropped); then ``F32_TRAIN_STEPS`` steps of
    ``launch.train.run`` with ``compute_dtype=torch.float32`` from the same
    masters.  Returns the packed (forward, backward) launches of the run."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    print(f"[train-f32] torch.backends.cuda.matmul.allow_tf32 = {tf32[0]}, "
          f"torch.backends.cudnn.allow_tf32 = {tf32[1]}; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held before the phase")
    params = train.make_params(model, 0, dev)
    first = next(_train_batches(F32_TRAIN_ROWS))
    batch = {k: torch.from_numpy(getattr(first, k)).to(dev)
             for k in ("tokens", "labels", "segment_ids", "positions")}
    n = cfg.n_layers
    per_step = {"gmm": 0, "paged": 0, "packed": 2 * n, "packed_bwd": n}
    plain = {"packed": _PlainPacked}
    # at the JAX init's scale (read, not held: chaotic, see F32_LOSS_REL),
    # then with the attention projections tempered (held)
    init_scale, _ = _family_routes(
        torch, "olmo-1b f32 init scale", model, params, batch, torch.float32,
        F32_TRAIN_LEAVES, plain, None, per_step, F32_GRAD_REL)
    with _tempered(params, None) as (tempered, _):
        routes, checks = _family_routes(
            torch, "olmo-1b f32", model, tempered, batch, torch.float32, F32_TRAIN_LEAVES,
            plain, {"packed": _HiddenKeyTile}, per_step, F32_GRAD_REL)
    loss_rel = routes["trained_vs_plain"]["loss"]
    checks[f"olmo-1b f32: step 1 loss within {F32_LOSS_REL} (relative) of the plain "
           "route"] = loss_rel <= F32_LOSS_REL
    print("[train-f32] step 1 routes at the init's scale (read): " + json.dumps(init_scale))
    print("[train-f32] step 1 routes, attention projections tempered (held): "
          + json.dumps(routes))
    del batch
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train_f32_", dir=ROOT / "build")
    argv = ["--arch", "olmo-1b", "--shape", "train_4k", "--steps", str(F32_TRAIN_STEPS),
            "--batch-size", str(F32_TRAIN_ROWS), "--remat", "nothing", "--mesh", "none",
            "--ckpt-every", "1000", "--ckpt-dir", ckpt]
    try:
        stats = train.run(train.parse_args(argv), params=params,
                          compute_dtype=torch.float32)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    fwd, bwd = stats["launches_fwd"], stats["launches_bwd"]
    print("[train-f32] " + json.dumps({
        "arch": stats["arch"], "compute_dtype": "float32", "allow_tf32": tf32[0],
        "seq_len": stats["seq_len"], "batch_size": stats["batch_size"],
        "steps": stats["steps"], "step_ms": stats["step_ms"],
        "step_ms_p50": stats["step_ms_p50"],
        "tokens_per_s_p50_step": stats["tokens_per_s_p50_step"],
        "losses": stats["losses"], "grad_norms": stats["grad_norms"],
        "launches_fwd": fwd, "launches_bwd": bwd,
        "segments_per_row": stats["segments_per_row"],
        "peak_device_mem_gib": stats["peak_device_mem_gib"]}))
    checks.update({
        f"olmo-1b f32: {F32_TRAIN_STEPS} steps, losses and grad norms finite":
            stats["steps"] == F32_TRAIN_STEPS
            and _finite(stats["losses"] + stats["grad_norms"]),
        f"olmo-1b f32: forward launches == {n} x 2 x {F32_TRAIN_STEPS}":
            fwd == 2 * n * F32_TRAIN_STEPS,
        f"olmo-1b f32: backward launches == {n} x {F32_TRAIN_STEPS}":
            bwd == n * F32_TRAIN_STEPS,
        "TF32 off": not tf32[0],
    })
    print(f"[train-f32] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"float32 training: {checks}")
    del params
    torch.cuda.empty_cache()
    return fwd, bwd


def block_phase(torch, np):
    """Phase 8: the first layer's attention block of olmo-1b and qwen3-8b at
    full width on a packed batch whose rows each hold several documents,
    through the kernels (``layers.attention`` on CUDA tensors) and through
    the plain ``flash_attention``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.kernels.packed_attention.ref import rel_l2
    from repro_torch.models.layers import (
        _out_proj,
        _project_qkv,
        attention,
        attention_specs,
        flash_attention,
        rope,
    )
    from repro_torch.models.params import init_params

    dev = torch.device("cuda")
    idx, pb = _multi_segment_batch()
    seg = torch.tensor(pb.segment_ids, device=dev)
    pos = torch.tensor(pb.positions, device=dev)
    B, S = seg.shape
    print(f"[block] batch {idx} of the train stream: segments per row "
          f"{[int(r.max()) for r in pb.segment_ids]}")
    for arch in ("olmo-1b", "qwen3-8b"):
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(29)
        p = init_params(attention_specs(cfg), gen, torch.bfloat16, dev)
        x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)

        def kernels(pp, xx):
            return attention(pp, cfg, xx, seg, pos)[0]

        def plain(pp, xx):
            q, k, v = _project_qkv(pp, cfg, xx)
            q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
            out = flash_attention(q, k, v, seg, seg, window=cfg.sliding_window)
            return _out_proj(out, pp["wo"])

        def run(block, dtype=torch.bfloat16):
            pp = {n: t.to(dtype) for n, t in p.items()}
            ws = {n: pp[n].clone().requires_grad_(True) for n in ("wq", "wk", "wv", "wo")}
            xx = x.to(dtype, copy=True).requires_grad_(True)
            out = block(dict(pp, **ws), xx)
            out.backward(g.to(dtype))
            return {"out": out.detach(), "dx": xx.grad,
                    **{n: w.grad for n, w in ws.items()}}

        def readings(a, b):
            # (B, S, d) in 64-token tiles; the weight gradients as whole tensors
            return {n: rel_l2(a[n].unsqueeze(2), b[n].unsqueeze(2))
                    if n in ("out", "dx") else rel_l2(a[n], b[n], block=0) for n in a}

        packed_ops.launches_fwd = packed_ops.launches_bwd = 0
        got = run(kernels)
        torch.cuda.synchronize()
        launches = (packed_ops.launches_fwd, packed_ops.launches_bwd)
        want = run(plain)
        exact = run(plain, torch.float32)  # the same block in fp32: the yardstick
        torch.cuda.synchronize()
        vs_plain, vs_fp32 = readings(got, want), readings(got, exact)
        plain_vs_fp32 = readings(want, exact)
        checks = {f"kernels vs plain within rel l2 {BLOCK_REL_L2}":
                  _within(vs_plain, BLOCK_REL_L2),
                  f"kernels within {FP32_RATIO}x the plain path's distance to fp32":
                  all(w <= FP32_RATIO * pw and t <= FP32_RATIO * pt for (w, t), (pw, pt)
                      in zip(vs_fp32.values(), plain_vs_fp32.values())),
                  "finite": all(bool(torch.isfinite(t).all()) for t in got.values()),
                  "one forward, one backward launch": launches == (1, 1)}
        print(f"[block] {arch} (H={cfg.n_heads}, KVH={cfg.n_kv_heads}, "
              f"qk_norm={cfg.qk_norm}): rel l2 (tensor/worst tile) kernels vs plain "
              f"{_fmt(vs_plain)}; kernels vs fp32 {_fmt(vs_fp32)}; plain vs fp32 "
              f"{_fmt(plain_vs_fp32)} {checks}")
        if not all(checks.values()):
            raise AssertionError(f"the {arch} attention block disagrees with the "
                                 f"plain flash path: {checks}")
        del p, x, g, got, want, exact
        torch.cuda.empty_cache()


def _profile_train_step(torch, step_fn, params, opt_state, batch):
    """Device time of one more train step by kernel, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    device_ms = sum(ms for ms, _, _ in kernels)
    packed = {name: sum(ms for ms, _, key in kernels if name in key)
              for name in ("packed_attn_fwd", "packed_attn_dkdv", "packed_attn_dq",
                           "packed_attn_delta")}
    return {
        "device_ms": device_ms,
        "profiled_wall_ms": wall_ms,
        "kernel_launches": sum(n for _, n, _ in kernels),
        "packed_kernels_ms": packed,
        "top_kernels_ms": [[key[:60], ms] for ms, _, key in kernels[:8]],
    }


def train_phase(torch, np):
    """Phase 11: olmo-1b training at full width and depth through
    ``launch.train.run``; returns the packed kernels' (forward, backward)
    launches of the controller's steps."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.launch import train

    cfg = get_config("olmo-1b")
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build")
    seen: dict = {}

    def after_run(step_fn, params, opt_state, batches):
        # the controller's steps are done: read the counts, then profile
        seen["launches"] = (packed_ops.launches_fwd, packed_ops.launches_bwd)
        seen["profile"] = _profile_train_step(torch, step_fn, params, opt_state,
                                              next(batches))

    try:
        packed_ops.launches_fwd = packed_ops.launches_bwd = 0
        stats = train.run(train.parse_args(TRAIN_ARGV + ["--ckpt-dir", ckpt_dir]),
                          after_run=after_run)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    fwd, bwd = seen["launches"]
    prof = seen["profile"]
    prof["device_busy_share"] = prof["device_ms"] / stats["step_ms_p50"]
    ck = stats["checkpoint"]
    print("[train] " + json.dumps({
        "arch": stats["arch"], "seq_len": stats["seq_len"],
        "batch_size": stats["batch_size"], "steps": stats["steps"],
        "step_ms": stats["step_ms"], "step_ms_p50": stats["step_ms_p50"],
        "tokens_per_s": stats["tokens_per_s"],
        "tokens_per_s_p50_step": stats["tokens_per_s_p50_step"],
        "losses": stats["losses"],
        "grad_norms": stats["grad_norms"], "launches_fwd": fwd, "launches_bwd": bwd,
        "segments_per_row": stats["segments_per_row"], "token_fill": stats["token_fill"],
        "peak_device_mem_gib": stats["peak_device_mem_gib"],
        "checkpoint_gb": ck.get("bytes", 0) / 1e9,
        "checkpoint_snapshot_s": ck.get("snapshot_s"),
        "checkpoint_write_s": ck.get("write_s"),
    }))
    print("[train] step profile: " + json.dumps(prof))
    n = cfg.n_layers * TRAIN_STEPS
    checks = {
        "8 steps": stats["steps"] == TRAIN_STEPS == len(stats["losses"]),
        "losses and grad norms finite": bool(np.isfinite(stats["losses"]).all()
                                             and np.isfinite(stats["grad_norms"]).all()),
        f"forward launches == {n} x 2": fwd == 2 * n,
        f"backward launches == {n}": bwd == n,
        "rows hold several segments": stats["segments_per_row"] >= 2,
        "the final checkpoint was written": ck.get("step") == TRAIN_STEPS
        and ck.get("write_s") is not None,
    }
    print(f"[train] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"training: {checks}")
    torch.cuda.empty_cache()
    return fwd, bwd


def _bf16_grads(torch, model, params, batch):
    """The gradients ``make_train_step`` takes by default: through the bf16
    compute copy of the fp32 masters (loss, bf16 gradient tree)."""
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.training.train_step import cast_params_for_compute

    leaves = [t.detach().requires_grad_(True)
              for t in tree_leaves(cast_params_for_compute(params))]
    with torch.enable_grad():
        loss, _ = model.loss(tree_unflatten(params, leaves), batch, remat_policy="nothing")
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def _event_ms(torch, fn):
    """(result, ms) of one call of ``fn`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _compressor_checks(torch, model, params, batch):
    """Phase 11b (a), on step 1's gradients: the error bound, the error
    feedback identity, the same-seed repeat and the compressor's device ms."""
    from repro_torch.distributed import GradCompressor
    from repro_torch.models.params import tree_leaves

    _, grads = _bf16_grads(torch, model, params, batch)
    comp = GradCompressor(stochastic=False)
    comp.apply(grads, None)  # warm up
    times = []
    for _ in range(3):
        (deq, ef), ms = _event_ms(torch, lambda: comp.apply(grads, None))
        times.append(ms)
    worst_ratio, ef_identity = 0.0, True
    for g, d, e in zip(tree_leaves(grads), tree_leaves(deq), tree_leaves(ef)):
        g = g.float()
        scale = torch.clamp(g.abs().amax(), min=1e-12) / 127.0
        worst_ratio = max(worst_ratio, float((g - d).abs().amax() / scale))
        ef_identity &= bool(torch.equal(e, g - d))
    del deq, ef
    noisy = GradCompressor(stochastic=True)
    first = noisy.apply(grads, None)
    second = noisy.apply(grads, None)
    repeat = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(first[0]) + tree_leaves(first[1]),
        tree_leaves(second[0]) + tree_leaves(second[1])))
    del first, second, grads
    torch.cuda.empty_cache()
    times.sort()
    return {"compressor_ms": times[1], "compressor_ms_all": times,
            "max_err_over_scale": worst_ratio, "ef_is_g_minus_deq": ef_identity,
            "stochastic_repeat_bitwise": repeat}


def _census_step(torch, step_fn, params, opt_state, batch):
    """The packed kernels' tile census over one more step on ``batch``."""
    from repro_torch.kernels.packed_attention import kernel as pk

    pk.tile_census(True)
    try:
        out = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        del out
    finally:
        census = pk.tile_census(False)
    return census


def _timed_steps(torch, step_fn, params, opt_state, batches):
    """Run ``step_fn`` over ``batches``: (losses, step ms, final state)."""
    losses, ms = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    return losses, ms, params, opt_state


def distributed_phase(torch, np):
    """Phase 11b: olmo-1b at full width with the int8 gradient compressor
    and through ``launch.train --mesh local``; returns the packed kernels'
    (forward, backward) launches of each path."""
    import math
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.distributed import GradCompressor, batch_shardings, make_rules
    from repro_torch.distributed.sharding import distribute
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step

    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    dev = torch.device("cuda")
    params = train.make_params(model, 0, dev)  # launch.train's weights
    batches = []
    for pb in _train_batches():
        batches.append({k: torch.from_numpy(getattr(pb, k)).to(dev)
                        for k in ("tokens", "labels", "segment_ids", "positions")})
        if len(batches) == DIST_STEPS:
            break
    opt_cfg = OptimizerConfig(decay_steps=100)  # launch.train's at 3 steps
    checks = _compressor_checks(torch, model, params, batches[0])

    # (a) the same batches with the compressor and without it
    runs, launches = {}, {}
    for name, comp in (("compressed", GradCompressor(stochastic=False)), ("plain", None)):
        step_fn = make_train_step(model, opt_cfg, remat_policy="nothing", compressor=comp)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        packed_ops.launches_fwd = packed_ops.launches_bwd = 0
        losses, ms, p, o = _timed_steps(torch, step_fn, params, init_opt_state(params),
                                        batches)
        launches[name] = (packed_ops.launches_fwd, packed_ops.launches_bwd)
        runs[name] = {"losses": losses, "step_ms": ms, "step_ms_p50": sorted(ms)[1],
                      "peak_device_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        if comp is not None:
            runs[name]["ef_bytes"] = sum(t.numel() * t.element_size()
                                         for t in tree_leaves(o["ef"]))
        else:
            runs[name]["profile"] = _profile_train_step(torch, step_fn, p, o, batches[0])
            runs[name]["census"] = _census_step(torch, step_fn, p, o, batches[0])
        del p, o
    del params
    torch.cuda.empty_cache()

    # (b) launch.train through --mesh local
    ckpt_dir = tempfile.mkdtemp(prefix="dist_ckpt_", dir=ROOT / "build")
    seen: dict = {}

    def after_run(step_fn, p, o, stream):
        seen["launches"] = (packed_ops.launches_fwd, packed_ops.launches_bwd)
        # the plain run's profiled batch, laid out on the run's mesh
        mesh = tree_leaves(p)[0].device_mesh
        b_shard = batch_shardings(batches[0], mesh, make_rules(mesh))
        batch0 = {k: distribute(v, b_shard[k]) for k, v in batches[0].items()}
        seen["profile"] = _profile_train_step(torch, step_fn, p, o, batch0)
        seen["census"] = _census_step(torch, step_fn, p, o, batch0)
        seen["placements"] = sorted({str(tuple(t.placements)) for t in tree_leaves(p)})

    try:
        packed_ops.launches_fwd = packed_ops.launches_bwd = 0
        stats = train.run(train.parse_args(DIST_ARGV + ["--ckpt-dir", ckpt_dir]),
                          after_run=after_run)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches["mesh local"] = seen["launches"]
    mesh_prof, plain_prof = seen["profile"], runs["plain"].pop("profile")
    mesh_census, plain_census = seen["census"], runs["plain"].pop("census")
    plain, comp_run = runs["plain"], runs["compressed"]
    mesh_host_ms = mesh_prof["profiled_wall_ms"] - mesh_prof["device_ms"]
    plain_host_ms = plain_prof["profiled_wall_ms"] - plain_prof["device_ms"]
    print("[distributed] compressor " + json.dumps({
        **checks, **{f"{k}_compressed": v for k, v in comp_run.items()},
        **{f"{k}_plain": v for k, v in plain.items()},
        "compression_adds_ms_p50": comp_run["step_ms_p50"] - plain["step_ms_p50"],
        "launches_fwd_bwd": launches}))
    print("[distributed] mesh local " + json.dumps({
        "mesh": stats["mesh"], "placements": seen["placements"],
        "losses": stats["losses"], "step_ms": stats["step_ms"],
        "step_ms_p50": stats["step_ms_p50"],
        "packed_launches_per_step": [n / DIST_STEPS for n in launches["mesh local"]],
        "dtensor_adds_ms_p50": stats["step_ms_p50"] - plain["step_ms_p50"],
        "profiled_batch": "the plain run's first", "profile_mesh": mesh_prof,
        "profile_plain": plain_prof, "tile_census_mesh": mesh_census,
        "tile_census_plain": plain_census,
        "host_ms_mesh": mesh_host_ms, "host_ms_plain": plain_host_ms,
        "dtensor_adds_host_ms": mesh_host_ms - plain_host_ms,
        "peak_device_mem_gib": stats["peak_device_mem_gib"],
        "loss1_bitwise_plain": stats["losses"][0] == plain["losses"][0],
        "loss1_rel_to_plain": abs(stats["losses"][0] - plain["losses"][0])
        / abs(plain["losses"][0])}))
    n = cfg.n_layers * DIST_STEPS
    ok = {
        "compressed |g - deq| <= scale / 2": checks["max_err_over_scale"]
        <= 0.5 + QUANT_SLACK,
        "error feedback == g - deq": checks["ef_is_g_minus_deq"],
        "stochastic apply repeats bitwise": checks["stochastic_repeat_bitwise"],
        "losses finite": all(math.isfinite(x) for x in comp_run["losses"] + plain["losses"]
                             + stats["losses"]),
        "compressed step-1 loss == plain": comp_run["losses"][0] == plain["losses"][0],
        "mesh step-1 loss within 1e-6 of plain": abs(stats["losses"][0] - plain["losses"][0])
        <= 1e-6 * abs(plain["losses"][0]),
        "mesh (1, 1)": stats["mesh"] == {"data": 1, "model": 1},
        f"packed launches == ({2 * n}, {n}) on every path": all(
            v == (2 * n, n) for v in launches.values()),
        "both profiles' batch: the same tile census": mesh_census == plain_census,
    }
    print(f"[distributed] checks: {ok}")
    if not all(ok.values()):
        raise AssertionError(f"distributed: {ok}")
    torch.cuda.empty_cache()
    return launches


def _roofline_reading(rec, measured_ms):
    """A count's roofline terms beside a measured step."""
    return {k: rec[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s",
                                "dominant", "roofline_step_s", "flops_per_dev",
                                "dot_bytes_per_dev")} | {
        "eager_bytes": rec["eager_cost"]["eager_bytes"],
        "measured_ms": measured_ms,
        "measured_over_roofline": measured_ms / 1e3 / rec["roofline_step_s"]}


def dryrun_phase(torch, np, smi, decode_reading):
    """Phase 11c: the dry-run.  The JAX package's test cell through the
    CLI (olmo-1b at decode_32k on the 256- and 512-rank meshes of a fake
    process group); then two steps that earlier phases run, counted on meta
    stand-ins on the one-card (1, 1) mesh and held to the same steps on the
    card: phase 11's olmo-1b train step (run here once more from the same
    weights and batch) and phase 10's qwen3-8b ragged decode step
    (``decode_reading``); then the two prefill cells (``_prefill_cells``).
    The FLOPs must be equal, each measured step no faster than its
    roofline bound, the predicted peak within ``DRYRUN_MEM_TOL`` of the
    card's."""
    import os

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun, train
    from repro_torch.models import build_model
    from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step

    # (a) the JAX package's dry-run test cell
    out = ROOT / "build" / "dryrun.json"
    out.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmo-1b",
         "--shape", "decode_32k", "--multi-pod", "both", "--out", str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
        text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith(("[OK]", "[FAIL]")):
            print(f"[dryrun] {line}")
    print(f"[dryrun] the CLI took {cli_s:.1f} s")
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise RuntimeError(f"the dry-run exited with {proc.returncode}")
    records = json.loads(out.read_text())
    cell_ok = len(records) == 2 and all(
        "error" not in r and r["chips"] in (256, 512) and r["memory"]["total_hbm_bytes"] > 0
        and r["flops_per_dev"] > 0 and r["collectives"]["total"] > 0
        and r["dominant"] in ("compute", "memory", "collective") for r in records) and any(
        r["mesh"] == "2x16x16" and r["chips"] == 512 for r in records)
    for r in records:
        print("[dryrun] " + json.dumps({k: r.get(k) for k in (
            "mesh", "chips", "flops_per_dev", "t_compute_s", "t_memory_s",
            "t_collective_s", "dominant", "roofline_step_s")} | {
            "hbm_per_dev_gb": r["memory"]["total_hbm_bytes"] / 1e9,
            "collectives_gb": {k: v / 1e9 for k, v in r["collectives"].items()
                               if k != "count"}}))

    # (b) the two steps counted on meta stand-ins on the one-card mesh
    t0 = time.perf_counter()
    dryrun.fake_process_group(1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        train_rec = dryrun.lower_cell(
            "olmo-1b", "train_4k", mesh=mesh, remat_policy="nothing",
            shape=ShapeConfig("train_4k", "train", TRAIN["S"], TRAIN["B"]))
        dec_rec = dryrun.lower_cell(
            "qwen3-8b", "decode", mesh=mesh, shape=ShapeConfig(
                "ragged decode", "decode", DRYRUN_DECODE["S"], DRYRUN_DECODE["B"]))
    finally:
        dist.destroy_process_group()
    count_s = time.perf_counter() - t0

    # (c) phase 11's train step on the card: a warm-up, one counted, one timed
    model = build_model(get_config("olmo-1b"))
    dev = torch.device("cuda")
    params = train.make_params(model, 0, dev)
    batch = {k: torch.from_numpy(getattr(next(_train_batches()), k)).to(dev)
             for k in ("tokens", "labels", "segment_ids", "positions")}
    step_fn = make_train_step(model, OptimizerConfig(), remat_policy="nothing")
    opt_state = init_opt_state(params)
    _, ms, params, opt_state = _timed_steps(torch, step_fn, params, opt_state, [batch])
    flops, peak_bytes, res = _step_reading(
        torch, lambda: step_fn(params, opt_state, batch), (params, opt_state, batch))
    del res
    _, ms2, params, opt_state = _timed_steps(torch, step_fn, params, opt_state, [batch])
    train_ms = min(ms + ms2)
    del params, opt_state, batch
    torch.cuda.empty_cache()

    readings = {}
    for name, rec, real_flops, real_peak, step_ms in (
            ("olmo-1b train 4 x 4096", train_rec, flops, peak_bytes, train_ms),
            ("qwen3-8b ragged decode, 8 sequences", dec_rec, decode_reading["flops"],
             decode_reading["peak_bytes"], decode_reading["step_ms_p50"])):
        pred = rec["memory"]["peak_memory_in_bytes"]
        readings[name] = {
            "card": smi, "flops_fake": rec["flops_per_dev"], "flops_real": real_flops,
            **_roofline_reading(rec, step_ms),
            "peak_pred_gib": pred / 2**30, "peak_card_gib": real_peak / 2**30,
            "peak_rel_err": (pred - real_peak) / real_peak}
        if "decode" in name:
            readings[name]["device_ms"] = decode_reading["device_ms"]
            readings[name]["device_over_roofline"] = (
                decode_reading["device_ms"] / 1e3 / rec["roofline_step_s"])
        print(f"[dryrun] one card: {name}: " + json.dumps(readings[name]))
    print(f"[dryrun] the two counts took {count_s:.1f} s")
    readings.update(_prefill_cells(torch, np, smi))
    readings.update(_recurrent_train_cell(torch, smi))
    checks = {"the decode_32k cell on both meshes": cell_ok}
    for name, r in readings.items():
        checks[f"{name}: FLOPs on stand-ins == on the card"] = r["flops_fake"] == r["flops_real"]
        checks[f"{name}: no faster than its roofline"] = r["measured_over_roofline"] >= 1.0
        checks[f"{name}: peak within {DRYRUN_MEM_TOL}"] = abs(r["peak_rel_err"]) <= DRYRUN_MEM_TOL
    print(f"[dryrun] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"dry-run: {checks}")


def _prefill_cells(torch, np, smi):
    """Phase 11c's prefill cells (``DRYRUN_PREFILL``): each counted on meta
    stand-ins on a (1, 1) mesh, then run on the card from bf16 weights
    drawn there, into the cache ``cache_specs`` gives the count, zeroed on
    the card: a warm-up, one prefill under ``FlopCounterMode`` and two
    timed.  The readings, as the train and decode steps'."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun, serve
    from repro_torch.models import build_model, cache_specs

    B, S = DRYRUN_PREFILL["B"], DRYRUN_PREFILL["S"]
    shape = ShapeConfig(f"prefill {B} x {S}", "prefill", S, B)
    dev = torch.device("cuda")
    readings = {}
    for arch in DRYRUN_PREFILL["archs"]:
        t0 = time.perf_counter()
        dryrun.fake_process_group(1)
        try:
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            rec = dryrun.lower_cell(arch, "prefill", mesh=mesh, shape=shape)
        finally:
            dist.destroy_process_group()
        count_s = time.perf_counter() - t0

        cfg = get_config(arch)
        model = build_model(cfg)
        params = serve.make_params(model, 0, dev)
        rng = np.random.default_rng(31)
        batch = {"tokens": torch.tensor(rng.integers(1, cfg.vocab_size, size=(B, S)),
                                        dtype=torch.int32, device=dev),
                 "segment_ids": torch.ones((B, S), dtype=torch.int32, device=dev),
                 "positions": torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)}

        def prefill():
            cache = cache_specs(cfg, shape, serve.DTYPE, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.prefill(params, batch, cache)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        with torch.no_grad():
            prefill()
            cache = cache_specs(cfg, shape, serve.DTYPE, dev)
            flops, peak, (logits, _) = _step_reading(
                torch, lambda: model.prefill(params, batch, cache), (params, batch, cache))
            finite = bool(torch.isfinite(logits).all())
            del cache, logits
            ms = [prefill()[1] for _ in range(2)]
        pred = rec["memory"]["peak_memory_in_bytes"]
        name = f"{arch} prefill {B} x {S}"
        readings[name] = {
            "card": smi, "flops_fake": rec["flops_per_dev"], "flops_real": flops,
            **_roofline_reading(rec, min(ms)), "prefill_ms": ms,
            "peak_pred_gib": pred / 2**30, "peak_card_gib": peak / 2**30,
            "peak_rel_err": (pred - peak) / peak, "count_s": count_s,
            "logits_finite": finite}
        print(f"[dryrun] one card: {name}: " + json.dumps(readings[name]))
        if not finite:
            raise AssertionError(f"{name}: logits not finite")
        del params, model, batch
        torch.cuda.empty_cache()
    return readings


def _recurrent_train_cell(torch, smi):
    """Phase 11c's recurrent train cell: phase 15's xlstm-125m step (4 x
    256 tokens, ``FT_XLSTM``; bf16 compute over fp32 masters, remat
    "nothing"), counted on meta stand-ins on the one-card (1, 1) mesh, its
    scans counted from one chunk of 128 for both (forward, recompute and
    backward), then run on the card over the full loop from weights drawn
    there on the first rows of its pipeline: one step under
    ``FlopCounterMode`` (the first), one timed.  The readings, as the other
    cells'."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun, train
    from repro_torch.models import build_model
    from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step

    arch, B, S = "xlstm-125m", FT_XLSTM["B"], FT_XLSTM["S"]
    shape = ShapeConfig(f"train {B} x {S}", "train", S, B)
    cfg = get_config(arch)
    model = build_model(cfg)
    step_fn = make_train_step(model, OptimizerConfig(), remat_policy="nothing")
    t0 = time.perf_counter()
    dryrun.fake_process_group(1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        rec = dryrun.lower_cell(arch, "train_4k", mesh=mesh, remat_policy="nothing",
                                shape=shape)
    finally:
        dist.destroy_process_group()
    count_s = time.perf_counter() - t0

    dev = torch.device("cuda")
    params = train.make_params(model, 0, dev)
    first = next(_token_rows(cfg.vocab_size, S, B))
    batch = {k: torch.from_numpy(getattr(first, k)).to(dev)
             for k in ("tokens", "labels", "segment_ids", "positions")}
    opt_state = init_opt_state(params)
    flops, peak, res = _step_reading(  # the first step, the warm-up too
        torch, lambda: step_fn(params, opt_state, batch), (params, opt_state, batch))
    del res
    _, ms, params, opt_state = _timed_steps(torch, step_fn, params, opt_state, [batch])
    pred = rec["memory"]["peak_memory_in_bytes"]
    name = f"{arch} train {B} x {S}"
    reading = {
        "card": smi, "flops_fake": rec["flops_per_dev"], "flops_real": flops,
        **_roofline_reading(rec, ms[0]), "step_ms": ms,
        "peak_pred_gib": pred / 2**30, "peak_card_gib": peak / 2**30,
        "peak_rel_err": (pred - peak) / peak, "count_s": count_s}
    print(f"[dryrun] one card: {name}: " + json.dumps(reading))
    del params, opt_state, batch, model
    torch.cuda.empty_cache()
    return {name: reading}


def serve_phase(torch):
    """Phase 9: the serving entry point at full width; returns the paged
    kernel's launches and the packed forward's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.launch import serve

    cfg = get_config("qwen3-8b")
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0
    packed_ops.launches_fwd = packed_ops.launches_bwd = 0
    stats = serve.run_local(serve.parse_args(SERVE_ARGV))
    launches = ops.launches
    packed = (packed_ops.launches_fwd, packed_ops.launches_bwd)
    want = cfg.n_layers * stats["gen_tokens"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print("[serve] " + json.dumps({
        "launches": launches, "packed_launches_fwd_bwd": packed,
        "prefill_s": stats["prefill_s"],
        "decode_ms_per_step": stats["decode_s"] / stats["gen_tokens"] * 1e3,
        "tokens_per_s": stats["sequences"] * stats["gen_tokens"] / stats["seconds"],
        "peak_device_mem_gib": peak, "pages_used": stats["pages_used"],
    }))
    if launches != want:
        raise AssertionError(f"{launches} paged-kernel launches, want {want}")
    if packed != (cfg.n_layers, 0):
        raise AssertionError(f"packed-attention launches (forward, backward) "
                             f"{packed}, want ({cfg.n_layers}, 0): one prefill")
    if not stats["logits_finite"] or stats["tokens"].shape != (8, 17):
        raise AssertionError(f"bad output: finite={stats['logits_finite']}, "
                             f"tokens {tuple(stats['tokens'].shape)}")
    torch.cuda.empty_cache()
    return launches, packed[0]


def _profile_decode(torch, model, params, tok, cache, step_wall_ms):
    """Device time of PROFILE_STEPS more decode steps by kernel, from
    ``torch.profiler``, against the unprofiled wall time of a step."""
    from repro_torch.launch import serve

    state = {"tok": tok, "cache": cache}

    def step():
        logits, state["cache"] = model.decode_step(params, {"tokens": state["tok"]},
                                                   state["cache"])
        state["tok"] = serve.greedy(logits)

    return _device_profile(torch, step, PROFILE_STEPS, step_wall_ms)


def _device_profile(torch, step, n, step_wall_ms, ranges=()):
    """Device time per call of ``step`` by kernel, from ``torch.profiler``
    over ``n`` calls, against the unprofiled wall time of one call; and for
    each name of ``ranges`` (a ``record_function`` range inside ``step``)
    the device time of the kernels launched inside it, and its share.  The
    profiler's raw events are read, each kernel placed in a range by the op
    that launched it: ``key_averages`` spends ~0.9 ms of host time on each
    kernel, minutes for a step of a recurrent model."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    spans = {name: [] for name in ranges}
    launched_at, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name in spans:
                spans[name].append((e.start_ns(), e.end_ns()))
            else:
                launched_at[e.correlation_id()] = e.start_ns()
        elif name not in spans:  # a range's own span on the device is no kernel
            kernels.append((name, e.linked_correlation_id(), e.duration_ns()))
    by_name = {}
    for name, _, ns in kernels:
        row = by_name.setdefault(name, [0, 0])
        row[0] += ns / 1e6 / n
        row[1] += 1 / n
    device_ms = sum(ms for ms, _ in by_name.values())

    def ms_inside(intervals):
        intervals.sort()
        starts = [lo for lo, _ in intervals]
        total = 0
        for _, corr, ns in kernels:
            t = launched_at.get(corr)
            i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if i >= 0 and t <= intervals[i][1]:
                total += ns
        return total / 1e6 / n

    extra = {}
    for name, intervals in spans.items():
        ms = ms_inside(intervals)
        extra[f"{name} ms per step"] = ms
        extra[f"{name} share of device time"] = ms / device_ms

    def kernel(*keys):
        rows = [row for name, row in by_name.items() if any(k in name for k in keys)]
        return sum(ms for ms, _ in rows), sum(k for _, k in rows)

    paged_ms, paged_n = kernel("paged_attn_kernel")
    gmm_ms, gmm_n = kernel("gmm_kernel", "gmm_tc_kernel")
    top = sorted(((ms, name) for name, (ms, _) in by_name.items()), reverse=True)[:6]
    return {
        **extra,
        "device_ms_per_step": device_ms,
        "wall_ms_per_step": step_wall_ms,
        "device_busy_share": device_ms / step_wall_ms,
        "kernel_launches_per_step": sum(k for _, k in by_name.values()),
        "paged_kernel_ms_per_step": paged_ms,
        "paged_kernel_launches_per_step": paged_n,
        "gmm_kernel_ms_per_step": gmm_ms,
        "gmm_kernel_launches_per_step": gmm_n,
        "gmm_share_of_device_time": gmm_ms / device_ms,
        "top_kernels_ms_per_step": [[name[:60], ms] for ms, name in top],
    }


def _storage_bytes(torch, tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    from torch.utils._pytree import tree_leaves

    seen = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}
    return sum(seen.values())


def _step_reading(torch, step, args):
    """One call of ``step()`` on the card under ``FlopCounterMode``: (its
    FLOPs, the peak bytes the process allocated during it less what it held
    beside ``args``, the step's arguments; the step's result).  Garbage is
    collected first: a train step leaves ~4.4 GiB of tensors in reference
    cycles, which the collector may free in the middle of the next step,
    under what was read as held beside it."""
    import gc

    from torch.utils.flop_counter import FlopCounterMode

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    beside = torch.cuda.memory_allocated() - _storage_bytes(torch, args)
    with FlopCounterMode(display=False) as fc:
        out = step()
        torch.cuda.synchronize()
    return fc.get_total_flops(), torch.cuda.max_memory_allocated() - beside, out


def ragged_phase(torch, np):
    """Phase 10: ragged prompts through prefill and paged decode at full
    width, then (10b) the same prompts with a sliding window; returns the
    decode launches, the packed forward's, phase 11c's decode reading and
    10b's launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cfg = get_config("qwen3-8b")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = serve.make_params(model, 0, dev)
    torch.cuda.synchronize()
    print(f"[ragged] weights drawn on the card in {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(21)
    B = 8
    lens = rng.integers(64, 1025, size=B)
    S = int(lens.max())
    tokens = np.zeros((B, S + 1), np.int32)
    seg = np.zeros((B, S + 1), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(1, cfg.vocab_size, size=n)
        seg[b, :n] = 1
    prompts = tokens.copy(), seg.copy()  # 10b's
    positions = torch.arange(S + 1, dtype=torch.int32, device=dev).expand(B, S + 1)

    def batch(width):
        return {"tokens": torch.tensor(tokens[:, :width], device=dev),
                "segment_ids": torch.tensor(seg[:, :width], device=dev),
                "positions": positions[:, :width]}

    def new_cache(model=model):
        return model.init_paged_cache(serve.paged_layout(cfg, 1024), serve.DTYPE, dev)

    cache = new_cache()
    torch.cuda.synchronize()
    packed_ops.launches_fwd = packed_ops.launches_bwd = 0
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch(S), cache)
    tok = serve.greedy(logits)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_packed = (packed_ops.launches_fwd, packed_ops.launches_bwd)

    ops.launches = 0
    finite = torch.isfinite(logits).all()
    first = None
    step_ms = []
    for i in range(RAGGED_STEPS):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, {"tokens": tok}, cache)
        if i == 0:
            first, tok0 = logits.clone(), tok.clone()
        finite &= torch.isfinite(logits).all()
        tok = serve.greedy(logits)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = ops.launches
    alloc = cache["alloc"]
    layout = alloc.layout
    watermark, used = alloc.highest_used_page(), alloc.used_pages
    need = sum(layout.pages_for(int(n) + RAGGED_STEPS) for n in lens)
    profile = _profile_decode(torch, model, params, tok, cache,
                              sum(step_ms) / RAGGED_STEPS)
    # one more step counted by FlopCounterMode, for phase 11c
    flops, peak_bytes, (logits, cache) = _step_reading(
        torch, lambda: model.decode_step(params, {"tokens": tok}, cache),
        (params, tok, cache))
    decode_reading = {"flops": flops, "peak_bytes": peak_bytes,
                      "step_ms_p50": sorted(step_ms)[RAGGED_STEPS // 2],
                      "device_ms": profile["device_ms_per_step"]}
    del cache, logits

    # the port's own prefill of prompt + first generated token
    for b, n in enumerate(lens):
        tokens[b, n] = int(tok0[b, 0])
        seg[b, n] = 1
    ref, _ = model.prefill(params, batch(S + 1), new_cache())
    delta = (first - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel_l2 = ((first - ref).norm() / ref.norm()).item()
    peak = torch.cuda.max_memory_allocated() / 2**30
    decode_s = sum(step_ms) / 1e3
    print("[ragged] " + json.dumps({
        "prompt_lens": lens.tolist(), "prefill_ms": prefill_ms,
        "decode_ms_per_step": decode_s * 1e3 / RAGGED_STEPS,
        "decode_ms_p50": sorted(step_ms)[RAGGED_STEPS // 2],
        "tokens_per_s": B * RAGGED_STEPS / decode_s,
        "launches": launches, "prefill_packed_launches_fwd_bwd": prefill_packed,
        "watermark": watermark, "pages_used": used,
        "pages_needed": need, "utilization": alloc.utilization(),
        "first_step_max_abs_dlogit": delta, "max_abs_logit": scale,
        "first_step_rel_l2": rel_l2, "peak_device_mem_gib": peak,
    }))
    print("[ragged] decode profile: " + json.dumps(profile))
    checks = {
        f"launches == {cfg.n_layers} x {RAGGED_STEPS}":
            launches == cfg.n_layers * RAGGED_STEPS,
        f"prefill: {cfg.n_layers} packed forward launches":
            prefill_packed == (cfg.n_layers, 0),
        "all logits finite": bool(finite),
        "First-Fit keeps the pool dense": watermark == used == need,
        f"profiled step: {cfg.n_layers} paged launches, no combine launch":
            profile["paged_kernel_launches_per_step"] == cfg.n_layers,
        f"first step within {FIRST_STEP_TOL} of max |logit|":
            delta <= FIRST_STEP_TOL * scale,
    }
    print(f"[ragged] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"ragged serving: {checks}")

    # 10b. the same prompts with a sliding window: the packed forward's
    # window in the prefill, the paged kernel's in each decode step
    cfg_w = dataclasses.replace(cfg, sliding_window=SERVE_WINDOW)
    model_w = build_model(cfg_w)
    tokens[:], seg[:] = prompts
    _zero_counts()
    logits, cache = model_w.prefill(params, batch(S), new_cache(model_w))
    tok = serve.greedy(logits)
    torch.cuda.synchronize()
    prefill_w = _counts()
    _zero_counts()
    finite = torch.isfinite(logits).all()
    step_ms = []
    for i in range(WINDOW_STEPS):
        t0 = time.perf_counter()
        logits, cache = model_w.decode_step(params, {"tokens": tok}, cache)
        if i == 0:
            first, tok0 = logits.clone(), tok.clone()
        finite &= torch.isfinite(logits).all()
        tok = serve.greedy(logits)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts_w = _counts()
    del cache, logits
    # the port's windowed prefill of prompt + first token, and a witness:
    # the unwindowed prefill of the same tokens
    for b, n in enumerate(lens):
        tokens[b, n] = int(tok0[b, 0])
        seg[b, n] = 1
    ref, _ = model_w.prefill(params, batch(S + 1), new_cache(model_w))
    full, _ = model.prefill(params, batch(S + 1), new_cache())
    delta, scale = (first - ref).abs().max().item(), ref.abs().max().item()
    witness = (first - full).abs().max().item()
    print("[ragged-window] " + json.dumps({
        "sliding_window": SERVE_WINDOW, "prompt_lens": lens.tolist(),
        "decode_ms_per_step": sum(step_ms) / WINDOW_STEPS,
        "decode_ms_p50": sorted(step_ms)[WINDOW_STEPS // 2],
        "prefill_launches": prefill_w, "decode_launches": counts_w,
        "first_step_max_abs_dlogit": delta, "max_abs_logit": scale,
        "unwindowed_prefill_max_abs_dlogit": witness}))
    checks = {
        f"prefill: {cfg.n_layers} packed forward launches": (
            prefill_w["packed"], prefill_w["packed_bwd"]) == (cfg.n_layers, 0),
        f"paged launches == {cfg.n_layers} x {WINDOW_STEPS}":
            counts_w["paged"] == cfg.n_layers * WINDOW_STEPS,
        "all logits finite": bool(finite),
        f"first step within {FIRST_STEP_TOL} of max |logit| of the windowed prefill":
            delta <= FIRST_STEP_TOL * scale,
        "the unwindowed prefill reads further (the window acts)": witness > delta,
    }
    print(f"[ragged-window] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"windowed ragged serving: {checks}")
    del params, first, ref, full
    torch.cuda.empty_cache()
    return launches, prefill_packed[0], decode_reading, counts_w["paged"]


@contextlib.contextmanager
def _patched(module, name, value):
    """``module.name`` set to ``value`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _recording(transformer, drops, captured=None, tag="", layers=()):
    """``transformer.moe_layer`` replaced by one that also appends each
    call's drop fraction (a device scalar) to ``drops`` and keeps a copy of
    its input at the given layers (counted from the first call) under
    ``captured[(tag, layer)]``."""
    real, calls = transformer.moe_layer, [0]

    def moe_layer(p, cfg, x, **kw):
        if calls[0] in layers:
            captured[(tag, calls[0])] = x.clone()
        calls[0] += 1
        out, aux = real(p, cfg, x, **kw)
        drops.append(aux["moe_drop_fraction"])
        return out, aux

    return _patched(transformer, "moe_layer", moe_layer)


def _moe_routes(torch, cfg, params, captured):
    """``moe_layer``'s kernel route against its plain route
    (``use_gmm_kernel=False``) on each captured hidden state, beside two
    planted faults through the kernel route: each bin's group size one short,
    and the router's gates replaced by 1/K."""
    from repro_torch.kernels.packed_attention.ref import rel_l2
    from repro_torch.models import moe

    def one_short(x, w_gate, w_up, w_down, group_sizes):
        return real_ffn(x, w_gate, w_up, w_down, (group_sizes - 1).clamp(min=0))

    def flat_gates(probs, k):
        vals, idx = real_top_k(probs, k)
        return torch.ones_like(vals), idx

    real_ffn, real_top_k = moe.expert_ffn_swiglu, moe._top_k_iterative
    E, K, factor = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    readings = {}
    for (tag, layer), h in sorted(captured.items()):
        p = {k: t[layer] for k, t in params["blocks"]["0"]["ffn"].items()}
        T = h.shape[0] * h.shape[1]
        got, aux = moe.moe_layer(p, cfg, h)
        want, aux_plain = moe.moe_layer(p, cfg, h, use_gmm_kernel=False)
        with _patched(moe, "expert_ffn_swiglu", one_short):
            short = moe.moe_layer(p, cfg, h)[0]
        with _patched(moe, "_top_k_iterative", flat_gates):
            flat = moe.moe_layer(p, cfg, h)[0]
        readings[f"{tag} layer {layer}"] = {
            "tokens": T,
            "capacity_kernel_plain": [moe.expert_capacity(T, E, K, factor, 128),
                                      moe.expert_capacity(T, E, K, factor, 8)],
            "drop_fraction_kernel_plain": [aux["moe_drop_fraction"].item(),
                                           aux_plain["moe_drop_fraction"].item()],
            "rel_l2": rel_l2(got, want, block=0)[0],
            "planted_one_row_short": rel_l2(short, want, block=0)[0],
            "planted_flat_gates": rel_l2(flat, want, block=0)[0],
        }
        del got, want, short, flat
    return readings


def moe_phase(torch, np):
    """Phase 12: qwen3-moe-30b-a3b served at full width, through the entry
    point (``run_local``) and then through ragged prefill and paged decode;
    returns each path's launches of the grouped matmul (``gmm``), the paged
    kernel and the packed forward."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model, transformer

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    cfg = get_config(MOE_ARCH)
    model = build_model(cfg)
    n = cfg.n_layers
    launches = {}

    # the serving entry point, as phase 9 drives it for qwen3-8b
    gmm_ops.launches = paged_ops.launches = 0
    packed_ops.launches_fwd = packed_ops.launches_bwd = 0
    stats = serve.run_local(serve.parse_args(MOE_SERVE_ARGV))
    gen = stats["gen_tokens"]
    launches["moe serve run_local"] = {
        "gmm": gmm_ops.launches, "paged": paged_ops.launches,
        "packed": packed_ops.launches_fwd}
    print("[moe] run_local " + json.dumps({
        "launches": launches["moe serve run_local"],
        "packed_backward": packed_ops.launches_bwd, "prefill_s": stats["prefill_s"],
        "decode_ms_per_step": stats["decode_s"] / gen * 1e3,
        "tokens_per_s": stats["sequences"] * gen / stats["seconds"],
        "pages_used": stats["pages_used"]}))
    want = {"gmm": 3 * n * (1 + gen), "paged": n * gen, "packed": n}
    if launches["moe serve run_local"] != want or packed_ops.launches_bwd:
        raise AssertionError(f"run_local launches {launches['moe serve run_local']}, "
                             f"want {want}")
    if not stats["logits_finite"] or stats["tokens"].shape != (8, 1 + gen):
        raise AssertionError(f"run_local: bad output: finite={stats['logits_finite']}, "
                             f"tokens {tuple(stats['tokens'].shape)}")
    del stats
    gc.collect()
    torch.cuda.empty_cache()

    # ragged prompts through prefill and paged decode
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = serve.make_params(model, 0, dev)
    torch.cuda.synchronize()
    print(f"[moe] {held:.2f} GiB held before the phase; weights drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    rng = np.random.default_rng(21)
    B = 8
    lens = rng.integers(64, 1025, size=B)
    lens[0] = 1024  # the prefill is 8 x 1024
    S = int(lens.max())
    tokens = np.zeros((B, S + 1), np.int32)
    seg = np.zeros((B, S + 1), np.int32)
    for b, m in enumerate(lens):
        tokens[b, :m] = rng.integers(1, cfg.vocab_size, size=m)
        seg[b, :m] = 1
    positions = torch.arange(S + 1, dtype=torch.int32, device=dev).expand(B, S + 1)

    def batch(width):
        return {"tokens": torch.tensor(tokens[:, :width], device=dev),
                "segment_ids": torch.tensor(seg[:, :width], device=dev),
                "positions": positions[:, :width]}

    def new_cache():
        return model.init_paged_cache(serve.paged_layout(cfg, 1024), serve.DTYPE, dev)

    cache = new_cache()
    captured: dict = {}
    torch.cuda.synchronize()
    gmm_ops.launches = paged_ops.launches = 0
    packed_ops.launches_fwd = packed_ops.launches_bwd = 0
    prefill_drops, decode_drops = [], []
    with _recording(transformer, prefill_drops, captured, "prefill", (0, n - 1)):
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch(S), cache)
        tok = serve.greedy(logits)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill = {"gmm": gmm_ops.launches, "paged": paged_ops.launches,
               "packed": (packed_ops.launches_fwd, packed_ops.launches_bwd)}
    finite = torch.isfinite(logits).all()
    snapshot = _copy_cache(torch, cache)

    gmm_ops.launches = paged_ops.launches = 0
    step_ms = []
    with _recording(transformer, decode_drops):
        for i in range(MOE_STEPS):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, {"tokens": tok}, cache)
            if i == 0:
                first, tok0 = logits.clone(), tok.clone()
            finite &= torch.isfinite(logits).all()
            tok = serve.greedy(logits)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    decode = {"gmm": gmm_ops.launches, "paged": paged_ops.launches}
    alloc = cache["alloc"]
    watermark, used = alloc.highest_used_page(), alloc.used_pages
    need = sum(alloc.layout.pages_for(int(m) + MOE_STEPS) for m in lens)
    p50 = sorted(step_ms)[MOE_STEPS // 2]
    profile = _profile_decode(torch, model, params, tok, cache, p50)
    del cache
    prefill_profile = _device_profile(
        torch, lambda: model.prefill(params, batch(S), new_cache()), 1, prefill_ms)

    # the first decode step again, on the copy of the post-prefill cache
    with _recording(transformer, [], captured, "decode", (0, n - 1)):
        again, snapshot = model.decode_step(params, {"tokens": tok0}, snapshot)
    bitwise = torch.equal(again, first)
    del snapshot, again
    # read, not held: the port's own prefill of prompt + first token routes
    # 8 more tokens through bins of another capacity, so its drops differ
    for b, m in enumerate(lens):
        tokens[b, m] = int(tok0[b, 0])
        seg[b, m] = 1
    ref_drops = []
    with _recording(transformer, ref_drops):
        ref, _ = model.prefill(params, batch(S + 1), new_cache())
    vs_prefill = {"max_abs_dlogit_over_max_logit":
                  ((first - ref).abs().max() / ref.abs().max()).item(),
                  "rel_l2": ((first - ref).norm() / ref.norm()).item(),
                  "prefill_drop_fraction": torch.stack(ref_drops).mean().item()}
    del ref
    routes = _moe_routes(torch, cfg, params, captured)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print("[moe] " + json.dumps({
        "arch": MOE_ARCH, "prompt_lens": lens.tolist(), "prefill_ms": prefill_ms,
        "decode_ms_per_step": sum(step_ms) / MOE_STEPS, "decode_ms_p50": p50,
        "tokens_per_s": B * MOE_STEPS / (sum(step_ms) / 1e3),
        "prefill_launches": prefill, "decode_launches": decode,
        "drop_fraction_prefill": torch.stack(prefill_drops).mean().item(),
        "drop_fraction_decode_max": torch.stack(decode_drops).max().item(),
        "watermark": watermark, "pages_used": used, "pages_needed": need,
        "peak_device_mem_gib": peak,
        "first_step_again_bitwise_equal": bitwise,
        "first_step_vs_prefill_of_prompt_and_token": vs_prefill,
    }))
    print("[moe] routes (kernel vs plain, relative l2): " + json.dumps(routes))
    print("[moe] decode profile: " + json.dumps(profile))
    print("[moe] prefill profile: " + json.dumps(prefill_profile))
    checks = {
        f"prefill: {3 * n} grouped-matmul, {n} packed forward launches":
            prefill["gmm"] == 3 * n and prefill["packed"] == (n, 0),
        f"decode: {3 * n} x {MOE_STEPS} grouped-matmul launches":
            decode["gmm"] == 3 * n * MOE_STEPS,
        f"decode: {n} x {MOE_STEPS} paged launches": decode["paged"] == n * MOE_STEPS,
        f"profiled step: {3 * n} grouped-matmul and {n} paged launches":
            profile["gmm_kernel_launches_per_step"] == 3 * n
            and profile["paged_kernel_launches_per_step"] == n,
        f"profiled prefill: {3 * n} grouped-matmul launches":
            prefill_profile["gmm_kernel_launches_per_step"] == 3 * n,
        "all logits finite": bool(finite),
        "the first step again gives the same bits": bitwise,
        "First-Fit keeps the pool dense": watermark == used == need,
        "routes: equal drops": all(r["drop_fraction_kernel_plain"][0]
                                   == r["drop_fraction_kernel_plain"][1]
                                   for r in routes.values()),
        f"routes: rel l2 <= {MOE_REL_L2}": all(r["rel_l2"] <= MOE_REL_L2
                                               for r in routes.values()),
        "routes: each planted fault reads above the limit": all(
            r["planted_one_row_short"] > MOE_REL_L2 and r["planted_flat_gates"] > MOE_REL_L2
            for r in routes.values()),
        "routes: prefill and decode of the first and last layer":
            len(routes) == 4,
    }
    print(f"[moe] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"MoE serving: {checks}")
    del params, captured
    torch.cuda.empty_cache()
    launches["moe serve prefill"] = {"gmm": prefill["gmm"], "packed": prefill["packed"][0]}
    launches["moe serve decode"] = {"gmm": decode["gmm"], "paged": decode["paged"]}
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the hybrid, recurrent, encoder-decoder and vision families
# ---------------------------------------------------------------------------

# The packed kernels at the new families' shapes: (name, B, Sq, Skv, H, KVH,
# D, causal, layout).  seamless-m4t-medium's encoder (1024 frames, 16 heads
# of 64, not causal) and its decoder's cross attention (64 queries against
# the 1024 frames; the frame and prompt segment ids each pad some rows), and
# internvl2-1b's prefill (256 patch rows + 64 tokens, 14 query over 2 KV
# heads of 64: G = 7); then seamless's decoder as phase 15 trains it (4
# rows of 512 tokens over 1024 frames, each side cut into two documents at
# ``_cuts``): its causal self attention and its cross attention.  The
# limits are phase 7's.
FAMILY_PACKED = (("seamless-m4t-medium encoder", 8, 1024, 1024, 16, 16, 64, False, None),
                 ("seamless-m4t-medium cross", 8, 64, 1024, 16, 16, 64, False, None),
                 ("internvl2-1b prefill", 8, 320, 320, 14, 2, 64, True, None),
                 ("seamless-m4t-medium decoder self", 4, 512, 512, 16, 16, 64, True,
                  "two documents"),
                 ("seamless-m4t-medium decoder cross", 4, 512, 1024, 16, 16, 64, False,
                  "two documents"))  # the last two trained: forward timed with the residual
# the paged kernel at their decode shapes (phase 6's inputs and limits)
FAMILY_PAGED = (("seamless-m4t-medium G=1", dict(DECODE, H=16, KVH=16, D=64)),
                ("internvl2-1b G=7", dict(DECODE, H=14, KVH=2, D=64)))
# jamba-v0.1-52b's MoE bins (16 experts, top-2, capacity factor 1.25): a
# decode step of 8 tokens (C = 128) and an 8 x 1024 prefill (C = 1280), d
# 4096 and expert d_ff 14336 (phase 4's inputs and limits)
JAMBA_GMM = (("decode gate/up", 16, 128, 4096, 14336, 8),
             ("decode down", 16, 128, 14336, 4096, 8),
             ("prefill gate/up", 16, 1280, 4096, 14336, 8 * 1024),
             ("prefill down", 16, 1280, 14336, 4096, 8 * 1024))
FAMILY_STEPS = 32
FAMILY_PROMPT = 1024   # the recurrent families' equal-length prompts
SEAMLESS_FRAMES, SEAMLESS_PROMPT = 1024, 64
INTERNVL_PROMPT = 64   # text tokens after the 256 patch rows
# jamba-v0.1-52b (configs/jamba_v0_1_52b.py; arXiv:2403.19887, hf
# ai21labs/Jamba-v0.1: 32 layers of the period MMMMAMMM, d 4096, 32 query
# over 8 KV heads of 128, Mamba d_state 16 / d_conv 4 / expand 2, MoE 16
# experts top-2 of d_ff 14336 on every other layer) is 51.6 B parameters,
# 96 GiB in bf16: more than one card holds.  Its depth is cut to two
# periods, 16 of 32 layers (26.05 B parameters, 48.5 GiB), at full width.
JAMBA_LAYERS = 16
# jamba's first step is held on prompts of 64 tokens: an 8 x 64 prefill and
# its 8 x 65 reference both get MoE bins of 128 rows (an 8 x 1024 prefill
# gets 1280 and its 8 x 1025 reference 1408, so their drops differ and the
# two caches with them)
JAMBA_HELD_PROMPT = 64
# jamba's first step against its prefill of prompt + token, both bf16 with
# the attention projections tempered (``_tempered``): its decode step
# rounds dt x to bf16 before the scan where its prefill keeps fp32 (the
# JAX package's ``mamba_decode_step`` and ``mamba_forward``), so each of
# its 14 Mamba layers parts the two paths anew.  Measured on an H100 (the
# hidden state of the last token, relative l2, layer by layer): 0.50% after
# layer 0, rising steadily to 2.4% at layer 14 and 3.4% after the last
# (one token's experts flipped by a near tie there); max |dlogit| 5.9% of
# max |logit|.  Twice FIRST_STEP_TOL; a lost state or lost K/V reads far
# above it (the planted faults).
JAMBA_FIRST_STEP_TOL = 0.1


def _family_packed_case(torch, np, pk, packed_ops, name, B, Sq, Skv, H, KVH, D, causal,
                        flush, trained, seg=None, tag="family", dtype=None, tf32_fault=False):
    """The packed kernels, forward and backward, against the autograd of
    their plain version at one of the new shapes: TOLS and relative l2 as in
    phase 7 (phase 7b's in float32), a second launch bitwise equal, the tile
    census equal to ``ref.tile_schedule``'s (in bf16 at D = 64 and 128, the
    D = 16 and 32 kernels keeping none, which must read 0; in float32 at
    every D); times beside the bound and sdpa, the
    forward's with the residual where the shape is ``trained`` (the
    training forward), without it where it is served, both printed.  ``seg``
    (B, Sq), when given, is the segment ids of queries and keys alike
    (packed rows), a pair of them those of the queries and of the keys;
    else every row is one segment.  Causal self-attention also gets phase
    7's planted faults, which must read above the limits; ``tf32_fault``
    adds one more, the float32 kernels' products as one pass of plain TF32
    (``ref.packed_attention_tf32`` with ``passes=1``).  ``dtype``: bf16 (the
    default) or float32, whose readings also stand beside the 3xTF32
    bound and as TFLOP/s of visible work."""
    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    (rtol, atol), limits = ((PACKED_F32_TOLS, PACKED_F32_REL_L2) if f32 else
                            (PACKED_TOLS, PACKED_REL_L2))
    import torch.nn.functional as F

    from repro_torch.kernels.packed_attention.ref import census_rule, rel_l2, visible_mask

    dev = torch.device("cuda")
    if isinstance(seg, tuple):
        seg_q_np, seg_kv_np = (np.asarray(s, np.int32) for s in seg)
    else:
        seg_q_np = np.ones((B, Sq), np.int32) if seg is None else np.asarray(seg, np.int32)
        seg_kv_np = np.ones((B, Skv), np.int32) if seg is None else seg_q_np.copy()
    if seg is None and Sq != Skv:  # separate segment ids, each with padded tails
        seg_kv_np[1, Skv - 200:] = 0
        seg_kv_np[5, Skv - 37:] = 0
        seg_q_np[2, Sq - 9:] = 0
    seg_q, seg_kv = torch.tensor(seg_q_np, device=dev), torch.tensor(seg_kv_np, device=dev)
    mask = visible_mask(seg_q, seg_kv, causal=causal)
    pairs = int(mask.sum())
    gen = torch.Generator(device=dev).manual_seed(47)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D),
                                (B, Sq, H, D)))
    out, grads = _kernel_run(packed_ops, q, k, v, g, seg_q, seg_kv, causal)
    out2, grads2 = _kernel_run(packed_ops, q, k, v, g, seg_q, seg_kv, causal)
    same = torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    del out2, grads2
    ref_out, ref_grads = _plain_rows(torch, packed_ops, q, k, v, g, seg_q, seg_kv, causal)
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_g = [(a.float() - b.float()).abs().max().item() for a, b in zip(grads, ref_grads)]
    readings = {n: rel_l2(a, b) for n, a, b in zip(
        ("out", "dq", "dk", "dv"), (out, *grads), (ref_out, *ref_grads))}
    pk.tile_census(on=True)
    o, lse, lo = pk.packed_flash_attention(q, k, v, seg_q, seg_kv, causal=causal,
                                           residual=True)
    pk.packed_flash_attention_bwd(q, k, v, seg_q, seg_kv, o, lo, g, lse, causal=causal)
    census = pk.tile_census(on=False)
    rule = (census_rule(seg_q, seg_kv, H, KVH, causal=causal) if D >= 64 or f32 else
            {kern: dict.fromkeys(pk.CENSUS_CLASSES, 0) for kern in pk.CENSUS_KERNELS})
    pad_q = seg_q == 0
    checks = {
        "out within TOLS": torch.allclose(out.float(), ref_out.float(), rtol=rtol, atol=atol),
        f"out, dq, dk, dv within rel l2 {limits}": _within(readings, limits),
        "finite": all(bool(torch.isfinite(t).all()) for t in (out, *grads)),
        "padded queries: output and dq 0": bool((out[pad_q] == 0).all())
        and bool((grads[0][pad_q] == 0).all()),
        "padded keys: dk and dv 0": all(bool((t[seg_kv == 0] == 0).all())
                                        for t in grads[1:]),
        "a second forward and backward bitwise equal": same,
        "tile census equal to ref.tile_schedule's": census == rule,
    }
    faults = {}
    if causal and Sq == Skv:
        faults = _planted_faults(torch, packed_ops, rel_l2, q, k, v, g, seg_q,
                                 ref_out, ref_grads)
        if tf32_fault:
            faults["plain TF32 (1 pass)"] = _tf32_fault(torch, rel_l2, q, k, v, g, seg_q,
                                                        ref_out, ref_grads)
        checks["each planted fault reads above the limits"] = all(
            not _within(f, limits) for f in faults.values())
    print(f"[{tag}] packed {name}: B={B} Sq={Sq} Skv={Skv} H={H} KVH={KVH} D={D} "
          f"causal={causal}; visible pairs {pairs}; max_abs_err out {err_out:.3e}, "
          f"dq/dk/dv {[f'{e:.3e}' for e in err_g]}; rel l2 (tensor/worst tile) "
          f"{_fmt(readings)}; planted faults " + "; ".join(
              f"{n} {_fmt(f)}" for n, f in faults.items())
          + f"; census {json.dumps(census)} {checks}")
    if not all(checks.values()):
        raise AssertionError(f"packed kernels disagree with their plain version at "
                             f"{name}: {checks}")
    del out, grads, ref_out, ref_grads
    torch.cuda.empty_cache()
    reps = 5
    fwd_ms = {res: _time_ms(torch, lambda: pk.packed_flash_attention(
        q, k, v, seg_q, seg_kv, causal=causal, residual=res), reps, flush)
        for res in (True, False)}
    bwd_ms = _time_ms(torch, lambda: pk.packed_flash_attention_bwd(
        q, k, v, seg_q, seg_kv, o, lo, g, lse, causal=causal), reps, flush)
    ps = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.no_grad():
        plain_fwd_ms = _time_ms(torch, lambda: packed_ops.packed_attention_plain(
            *ps, seg_q, seg_kv, causal=causal), 3, flush)
    ref = packed_ops.packed_attention_plain(*ps, seg_q, seg_kv, causal=causal)
    plain_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
        ref, ps, g, retain_graph=True), 3, flush)
    del ref, ps
    hs = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
    gt = g.transpose(1, 2).contiguous()
    # sdpa with the same visibility: causal by its flag, padding by a mask
    attn_mask = None if bool(mask.all()) or causal else mask[:, None]

    def sdpa():
        return F.scaled_dot_product_attention(*hs, attn_mask=attn_mask, is_causal=causal,
                                              enable_gqa=H != KVH)

    with torch.no_grad():
        sdpa_fwd_ms = _time_ms(torch, sdpa, reps, flush)
    sd = sdpa()
    sdpa_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
        sd, hs, gt, retain_graph=True), reps, flush)
    del sd, hs, gt, o, lse, lo
    dname = str(dtype).replace("torch.", "")
    fb, fb_by = _packed_bound("fwd", pairs, B, Sq, H, KVH, D, dname, Skv, trained)
    bb, bb_by = _packed_bound("bwd", pairs, B, Sq, H, KVH, D, dname, Skv)
    other = "without" if trained else "with"
    print(f"[{tag}] packed {name}: forward {fwd_ms[trained]:.4f} ms ({other} the "
          f"residual {fwd_ms[not trained]:.4f}), plain {plain_fwd_ms:.4f} ms, "
          f"sdpa {sdpa_fwd_ms:.4f} ms, bound {fb:.4f} ms ({fb_by}); backward "
          f"{bwd_ms:.4f} ms, plain {plain_bwd_ms:.4f} ms, sdpa {sdpa_bwd_ms:.4f} ms, "
          f"bound {bb:.4f} ms ({bb_by})")
    fwd_rec = {"max_abs_err": err_out, "ms": fwd_ms[trained], "plain_ms": plain_fwd_ms,
               "bound_ms": fb, "bound_by": fb_by, "library_ms": sdpa_fwd_ms,
               "residual": trained, f"{other}_residual_ms": fwd_ms[not trained],
               "rel_l2": readings["out"], "census": census["forward"]}
    bwd_rec = {"max_abs_err": max(err_g), "ms": bwd_ms, "plain_ms": plain_bwd_ms,
               "bound_ms": bb, "bound_by": bb_by, "library_ms": sdpa_bwd_ms,
               "rel_l2": {n: readings[n] for n in ("dq", "dk", "dv")},
               "census": census["dk/dv"]}
    if f32:
        # the same readings against the route's own ceiling: 3xTF32 on the
        # tensor cores, beside the CUDA cores' fp32 bound above
        for kind, rec, bound in (("fwd", fwd_rec, fb), ("bwd", bwd_rec, bb)):
            b3, b3_by = _packed_bound(kind, pairs, B, Sq, H, KVH, D, dname, Skv,
                                      trained and kind == "fwd", peak="tf32x3")
            rec.update({"tflops": _packed_flops(kind, pairs, H, D) / rec["ms"] / 1e9,
                        "bound_tf32x3_ms": b3, "bound_tf32x3_by": b3_by,
                        "share_of_bound": bound / rec["ms"],
                        "share_of_bound_tf32x3": b3 / rec["ms"]})
        print(f"[{tag}] packed {name}: " + "; ".join(
            f"{kind} {rec['tflops']:.1f} TFLOP/s of visible work, "
            f"{rec['share_of_bound']:.3f} of the fp32 bound ({rec['bound_ms']:.4f} ms at "
            f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s), {rec['share_of_bound_tf32x3']:.3f} "
            f"of the 3xTF32 bound ({rec['bound_tf32x3_ms']:.4f} ms at "
            f"{PEAK_FLOPS['tf32x3'] / 1e12:.0f} TFLOP/s)"
            for kind, rec in (("forward", fwd_rec), ("backward", bwd_rec))))
    del q, k, v, g
    torch.cuda.empty_cache()
    return fwd_rec, bwd_rec


def _cuts(n, B):
    """Where phase 15 starts each row's second document in a side of ``n``
    tokens or frames: row b at n (b + 1) / (B + 1)."""
    return [n * (b + 1) // (B + 1) for b in range(B)]


def _two_document_ids(np, B, Sq, Skv):
    """Segment ids of ``B`` rows cut into two documents at ``_cuts``: one
    array for self attention, (queries', keys') for Sq != Skv."""
    seg_q, seg_kv = np.ones((B, Sq), np.int32), np.ones((B, Skv), np.int32)
    for b, (cq, ck) in enumerate(zip(_cuts(Sq, B), _cuts(Skv, B))):
        seg_q[b, cq:], seg_kv[b, ck:] = 2, 2
    return seg_q if Sq == Skv else (seg_q, seg_kv)


def family_kernels(torch, np):
    """Phase 13, part 1: each kernel at the new families' shapes against its
    plain version; returns the by_shape records (packed forward, packed
    backward, paged, grouped matmul)."""
    from repro_torch.kernels.grouped_matmul.kernel import grouped_matmul
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    from repro_torch.kernels.packed_attention import kernel as pk
    from repro_torch.kernels.packed_attention import ops as packed_ops

    dev = torch.device("cuda")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    fwd, bwd, paged, gmm = {}, {}, {}, {}
    for name, B, Sq, Skv, H, KVH, D, causal, layout in FAMILY_PACKED:
        seg = None if layout is None else _two_document_ids(np, B, Sq, Skv)
        fwd[name], bwd[name] = _family_packed_case(
            torch, np, pk, packed_ops, name, B, Sq, Skv, H, KVH, D, causal, flush,
            trained=layout is not None, seg=seg)
    for key, shape in FAMILY_PAGED:
        paged[key] = _paged_case(torch, np, key, shape, "bfloat16", flush)
    for name, E, C, d, f, tokens in JAMBA_GMM:
        gmm[f"jamba {name} bf16"] = _gmm_moe_case(
            torch, grouped_matmul, grouped_matmul_ref, flush, f"jamba {name}", E, C, d, f,
            tokens, top_k=2)
    del flush
    torch.cuda.empty_cache()
    return fwd, bwd, paged, gmm


def _counts():
    """The three kernels' launch counters: (gmm, paged, packed forward,
    packed backward)."""
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops

    return {"gmm": gmm_ops.launches, "paged": paged_ops.launches,
            "packed": packed_ops.launches_fwd, "packed_bwd": packed_ops.launches_bwd}


def _zero_counts():
    from repro_torch.kernels.grouped_matmul import ops as gmm_ops
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops

    gmm_ops.launches = paged_ops.launches = 0
    packed_ops.launches_fwd = packed_ops.launches_bwd = 0


def _family_run_local(torch, tag, argv, want):
    """``launch.serve.run_local`` on ``argv`` with every launch counter set
    to 0 just before; its launches held to ``want``."""
    from repro_torch.launch import serve

    _zero_counts()
    stats = serve.run_local(serve.parse_args(argv))
    got = _counts()
    gen = stats["gen_tokens"]
    print(f"[family] {tag} run_local " + json.dumps({
        "launches": got, "prefill_s": stats["prefill_s"],
        "decode_ms_per_step": stats["decode_s"] / gen * 1e3,
        "tokens_per_s": stats["sequences"] * gen / stats["seconds"],
        "pages_used": stats["pages_used"]}))
    if got != want:
        raise AssertionError(f"{tag} run_local launches {got}, want {want}")
    if not stats["logits_finite"] or stats["tokens"].shape != (8, 1 + gen):
        raise AssertionError(f"{tag} run_local: bad output: finite="
                             f"{stats['logits_finite']}, tokens {tuple(stats['tokens'].shape)}")
    return got


def _copy_cache(torch, cache):
    """A copy of a paged cache (pools, allocators, recurrent states) that the
    copied-from cache cannot change."""
    import copy

    def one(v):
        if torch.is_tensor(v):
            return v.clone()
        if isinstance(v, dict):
            return {k: one(x) for k, x in v.items()}
        if isinstance(v, list):
            return [one(x) for x in v]
        return copy.deepcopy(v)

    return one(cache)


def _gap(got, want):
    """max |got - want| / max |want| and the relative l2 of two logit sets."""
    return {"max_abs_dlogit_over_max_logit": ((got - want).abs().max()
                                              / want.abs().max()).item(),
            "rel_l2": ((got - want).norm() / want.norm()).item()}


def _ulp_moved(torch, table):
    """``table`` with every entry moved by about one ulp of its dtype, up or
    down at random (seed 0)."""
    gen = torch.Generator(device=table.device).manual_seed(0)
    sign = torch.randint(0, 2, table.shape, generator=gen, device=table.device) * 2 - 1
    eps = torch.finfo(table.dtype).eps
    return (table.float() * (1 + eps * sign)).to(table.dtype)


def _first_step(model, params, batch, new_cache, tok0, faults):
    """The first decode step after the prefill of ``batch(None)`` with the
    token ``tok0``, the prefill of ``batch(tok0)``, and the same step again
    with each planted fault done to the post-prefill cache: (step logits,
    prefill logits, {fault: step logits})."""

    def step(fault):
        _, cache = model.prefill(params, batch(None), new_cache())
        if fault is not None:
            fault(cache)
        return model.decode_step(params, {"tokens": tok0}, cache)[0]

    ref, _ = model.prefill(params, batch(tok0), new_cache())
    return step(None), ref, {name: step(f) for name, f in faults.items()}


def _states_lost(cache):
    """Planted fault: every recurrent state zeroed (a lost hand-off)."""
    for state in cache["state"]:
        for t in state.values():
            t.zero_()


def _kv_lost(cache):
    """Planted fault: the prompt's K/V pages zeroed."""
    cache["k"].zero_()
    cache["v"].zero_()


@contextlib.contextmanager
def _in_fp32(params, new_cache32):
    """An fp32 copy of the served weights, and a cache factory in fp32."""
    from repro_torch.models.params import tree_map

    yield tree_map(lambda t: t.float(), params), new_cache32


@contextlib.contextmanager
def _tempered(params, new_cache):
    """The served weights with every attention block's projections brought
    to the scale of a fan-in init in place (exactly; undone on exit).

    The JAX package's init rule takes a leaf's fan-in from ``shape[-2]``
    (ROADMAP queue 3): a (d, H, hd) projection is drawn with std
    1/sqrt(H), not 1/sqrt(d), and wo (H, hd, d) with 1/sqrt(hd), not
    1/sqrt(H hd).  At full width that makes wq and wk 8-11x too large (the
    scores 64-128x, the softmax saturated) and wv and wo 2-22x (attention's
    output outweighs the residual stream it is added to), so that the
    random-weight models are chaotic in bf16: any two roundings of the same
    sums end far apart (``one_ulp_embed_witness``).  Each of wq, wk, wv, wo
    is scaled by the power of two nearest sqrt(its JAX fan-in / its input
    width), exact in bf16; the first step then reads the serving path
    rather than the init's chaos."""
    import math

    import torch

    def attn_blocks(tree):
        if isinstance(tree, dict):
            if "wq" in tree and "wo" in tree:
                yield tree
            else:
                for v in tree.values():
                    yield from attn_blocks(v)

    scaled = []
    for blk in attn_blocks(params):
        for name in ("wq", "wk", "wv", "wo"):
            t = blk[name]  # stacked: (n, d, heads, hd) or (n, H, hd, d)
            fan_in = t.shape[-3] if name != "wo" else t.shape[-3] * t.shape[-2]
            scaled.append((t, 2.0 ** round(0.5 * math.log2(t.shape[-2] / fan_in))))
    with torch.no_grad():
        for t, f in scaled:
            t.mul_(f)
    try:
        yield params, new_cache
    finally:
        with torch.no_grad():
            for t, f in scaled:
                t.mul_(1.0 / f)


def _family_serve(torch, tag, model, params, batch, new_cache, steps, want_prefill,
                  want_step, held, repeat=False, profile_ranges=None):
    """Prefill ``batch(None)``, then ``steps`` greedy decode steps; the
    first step's logits against the port's own prefill of prompt + that
    step's token (``batch(token)``), read on the served weights and held
    within ``held["tol"]`` on those of ``held["weights"]`` (a context
    manager factory taking the params and giving (params, cache factory)),
    on ``held["batch"]``'s prompts if given, beside ``held["faults"]``
    (planted in the post-prefill cache; each must read above the limit);
    launch counts held to ``want_prefill`` and ``want_step`` a step.  With ``repeat`` the first step is run again
    on a copy of the post-prefill cache and must give the same bits; with
    ``profile_ranges`` one decode step and one prefill run under
    ``torch.profiler``, with those ranges' shares.  Returns the readings."""
    from repro_torch.launch import serve

    torch.cuda.synchronize()
    cache = new_cache()
    _zero_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch(None), cache)
    tok = serve.greedy(logits)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill = _counts()
    finite = torch.isfinite(logits).all()
    snapshot = _copy_cache(torch, cache) if repeat else None
    _zero_counts()
    step_ms = []
    for i in range(steps):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, {"tokens": tok}, cache)
        if i == 0:
            first, tok0 = logits.clone(), tok.clone()
        finite &= torch.isfinite(logits).all()
        tok = serve.greedy(logits)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    decode = _counts()
    p50 = sorted(step_ms)[steps // 2]
    B = tok.shape[0]
    out = {"prefill_ms": prefill_ms, "decode_ms_per_step": sum(step_ms) / steps,
           "decode_ms_p50": p50, "tokens_per_s": B * steps / (sum(step_ms) / 1e3),
           "prefill_launches": prefill, "decode_launches": decode}
    if profile_ranges is not None:
        state = {"tok": tok, "cache": cache}

        def step():
            lg, state["cache"] = model.decode_step(params, {"tokens": state["tok"]},
                                                   state["cache"])
            state["tok"] = serve.greedy(lg)

        out["decode_profile"] = _device_profile(torch, step, 1, p50, profile_ranges)
        del state
    del cache
    if profile_ranges is not None:
        out["prefill_profile"] = _device_profile(
            torch, lambda: model.prefill(params, batch(None), new_cache()), 1, prefill_ms,
            profile_ranges)
    if repeat:
        again, snapshot = model.decode_step(params, {"tokens": tok0}, snapshot)
        out["first_step_again_bitwise_equal"] = torch.equal(again, first)
        del snapshot, again
    # the first step against the port's prefill of prompt + token: read on
    # the served weights, and beside it the same prefill with the embedding
    # table moved by about one bf16 ulp (how far rounding alone moves these
    # logits); held on the weights of ``held``
    ref, _ = model.prefill(params, batch(tok0), new_cache())
    noisy, _ = model.prefill(dict(params, embed=_ulp_moved(torch, params["embed"])),
                             batch(tok0), new_cache())
    out.update({"first_step_vs_prefill": _gap(first, ref),
                "one_ulp_embed_witness": _gap(noisy, ref)})
    del ref, first, noisy
    held_batch, tol = held.get("batch"), held["tol"]
    with held["weights"](params) as (hparams, hcache):
        if held_batch is None:
            held_batch, held_tok = batch, tok0
        else:  # its own prompts: the first step's token greedy from their prefill
            held_tok = serve.greedy(model.prefill(hparams, held_batch(None), hcache())[0])
        got, want, planted = _first_step(model, hparams, held_batch, hcache, held_tok,
                                         held["faults"])
        out["held"] = dict(_gap(got, want), weights=held["label"], tol=tol,
                           planted={n: _gap(p, want) for n, p in planted.items()})
        del got, want, planted
    out["peak_device_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    reading = "max_abs_dlogit_over_max_logit"
    checks = {
        f"prefill launches {want_prefill}": prefill == want_prefill,
        f"decode launches {steps} x {want_step}": decode == {
            k: steps * n for k, n in want_step.items()},
        "all logits finite": bool(finite),
        f"first step within {tol} of max |logit| ({held['label']})":
            out["held"][reading] <= tol,
        f"each planted fault reads above {tol}": all(
            g[reading] > tol for g in out["held"]["planted"].values()),
    }
    if repeat:
        checks["the first step again gives the same bits"] = out[
            "first_step_again_bitwise_equal"]
    print(f"[family] {tag} " + json.dumps(out))
    print(f"[family] {tag} checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} serving: {checks}")
    return out


def _token_batch(torch, np, vocab, B, S, seed, extra=None):
    """``batch(tok)``: B equal-length prompts of S random tokens (one
    document a row), with ``tok`` (B, 1) appended when given; ``extra``
    entries are added as they are."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    prompts = torch.tensor(rng.integers(1, vocab, size=(B, S)).astype(np.int32), device=dev)

    def batch(tok):
        t = prompts if tok is None else torch.cat([prompts, tok], dim=1)
        n = t.shape[1]
        return {"tokens": t,
                "segment_ids": torch.ones((B, n), dtype=torch.int32, device=dev),
                "positions": torch.arange(n, dtype=torch.int32, device=dev).expand(B, n),
                **(extra or {})}

    return batch


def families_phase(torch, np):
    """Phase 13: xlstm-125m, seamless-m4t-medium, internvl2-1b and
    jamba-v0.1-52b (16 of 32 layers) served at full width; returns each
    path's launches of the three kernels."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model, ssm, transformer

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[family] {torch.cuda.memory_allocated() / 2**30:.2f} GiB held before the phase")
    launches, readings = {}, {}
    pages = ["--requests", "8", "--gen-tokens", "16", "--pages", "1024"]

    def params_of(model):
        t0 = time.perf_counter()
        params = serve.make_params(model, 0, dev)
        torch.cuda.synchronize()
        print(f"[family] {model.cfg.name}: weights drawn on the card in "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
        return params

    def cache_of(model, cfg, dtype=serve.DTYPE):
        return lambda: model.init_paged_cache(serve.paged_layout(cfg, 1024), dtype, dev)

    def noise(shape, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).float()

    none = {"gmm": 0, "paged": 0, "packed": 0, "packed_bwd": 0}

    # xlstm-125m: full width and depth; no TPU kernel on its path
    arch = "xlstm-125m"
    cfg = get_config(arch)
    launches[f"{arch} run_local"] = _family_run_local(
        torch, arch, ["--backend", "local", "--arch", arch] + pages, none)
    model = build_model(cfg)
    params = params_of(model)
    torch.cuda.reset_peak_memory_stats()
    readings[arch] = _family_serve(
        torch, arch, model, params,
        _token_batch(torch, np, cfg.vocab_size, 8, FAMILY_PROMPT, 31),
        cache_of(model, cfg), FAMILY_STEPS, none, none,
        held={"label": "fp32", "tol": FIRST_STEP_TOL, "faults": {"states lost": _states_lost},
              "weights": lambda p: _in_fp32(p, cache_of(model, cfg, torch.float32))})
    del params, model
    gc.collect()
    torch.cuda.empty_cache()

    # seamless-m4t-medium: 12 encoder + 12 decoder layers
    arch = "seamless-m4t-medium"
    cfg = get_config(arch)
    L = cfg.n_layers
    launches[f"{arch} run_local"] = _family_run_local(
        torch, arch, ["--backend", "local", "--arch", arch] + pages,
        dict(none, packed=cfg.n_encoder_layers + 2 * L, paged=2 * L * 16))
    model = build_model(cfg)
    params = params_of(model)
    torch.cuda.reset_peak_memory_stats()
    enc = {"enc_embeds": noise((8, SEAMLESS_FRAMES, cfg.d_model), 32),
           "enc_segment_ids": torch.ones((8, SEAMLESS_FRAMES), dtype=torch.int32,
                                         device=dev)}
    readings[arch] = _family_serve(
        torch, arch, model, params,
        _token_batch(torch, np, cfg.vocab_size, 8, SEAMLESS_PROMPT, 33, enc),
        cache_of(model, cfg), FAMILY_STEPS,
        dict(none, packed=cfg.n_encoder_layers + 2 * L), dict(none, paged=2 * L),
        held={"label": "bf16, attention projections tempered", "tol": FIRST_STEP_TOL,
              "faults": {"K/V lost": _kv_lost},
              "weights": lambda p: _tempered(p, cache_of(model, cfg))})
    launches[f"{arch} prefill"] = readings[arch]["prefill_launches"]
    launches[f"{arch} decode"] = readings[arch]["decode_launches"]
    del params, model, enc
    gc.collect()
    torch.cuda.empty_cache()

    # internvl2-1b: 256 patch rows + 64 text tokens; run_local's 16-token
    # prompts cannot hold the 256 rows, and it raises as the JAX package does
    arch = "internvl2-1b"
    cfg = get_config(arch)
    L = cfg.n_layers
    _zero_counts()
    try:
        serve.run_local(serve.parse_args(["--backend", "local", "--arch", arch] + pages))
        raised = None
    except ValueError as e:
        raised = str(e)
    print(f"[family] {arch} run_local at full width: ValueError {raised!r}")
    if raised is None or "256" not in raised or "16" not in raised:
        raise AssertionError(f"{arch} run_local did not raise the 256-rows-in-16 "
                             f"ValueError: {raised!r}")
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    params = params_of(model)
    torch.cuda.reset_peak_memory_stats()
    vis = {"vision_embeds": noise((8, cfg.frontend_tokens, cfg.d_model), 34)}
    readings[arch] = _family_serve(
        torch, arch, model, params,
        _token_batch(torch, np, cfg.vocab_size, 8, cfg.frontend_tokens + INTERNVL_PROMPT,
                     35, vis),
        cache_of(model, cfg), FAMILY_STEPS, dict(none, packed=L), dict(none, paged=L),
        held={"label": "bf16, attention projections tempered", "tol": FIRST_STEP_TOL,
              "faults": {"K/V lost": _kv_lost},
              "weights": lambda p: _tempered(p, cache_of(model, cfg))})
    launches[f"{arch} prefill"] = readings[arch]["prefill_launches"]
    launches[f"{arch} decode"] = readings[arch]["decode_launches"]
    del params, model, vis
    gc.collect()
    torch.cuda.empty_cache()

    # jamba-v0.1-52b at full width, 16 of 32 layers
    arch = "jamba-v0.1-52b"
    cfg = dataclasses.replace(get_config(arch), n_layers=JAMBA_LAYERS)
    n_attn = cfg.pattern.count("A") * cfg.n_periods
    n_moe = sum(cfg.moe.is_moe_layer(pos) for pos in range(len(cfg.pattern))
                if cfg.pattern[pos] in "AM") * cfg.n_periods
    print(f"[family] {arch}: reduced n_layers 32 -> {JAMBA_LAYERS} (one card: "
          f"{cfg.param_counts()[0] / 1e9:.2f} B parameters); {n_attn} attention, "
          f"{n_moe} MoE layers")
    launches[f"{arch} run_local"] = _family_run_local(
        torch, arch, ["--backend", "local", "--arch", arch, "--n-layers",
                      str(JAMBA_LAYERS)] + pages,
        dict(none, gmm=3 * n_moe * 17, paged=n_attn * 16, packed=n_attn))
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    params = params_of(model)
    torch.cuda.reset_peak_memory_stats()
    drops = []

    def timed(name, fn):
        def inner(*args, **kw):
            with torch.autograd.profiler.record_function(name):
                return fn(*args, **kw)
        return inner

    forward, step = transformer._RECURRENT["M"]
    with _recording(transformer, drops), \
            _patched(ssm, "_ssm_scan", timed("mamba scan", ssm._ssm_scan)), \
            _patched(transformer, "_RECURRENT", dict(
                transformer._RECURRENT, M=(timed("mamba block", forward),
                                           timed("mamba block", step)))):
        readings[arch] = _family_serve(
            torch, arch, model, params,
            _token_batch(torch, np, cfg.vocab_size, 8, FAMILY_PROMPT, 36),
            cache_of(model, cfg), FAMILY_STEPS,
            dict(none, gmm=3 * n_moe, packed=n_attn), dict(none, gmm=3 * n_moe, paged=n_attn),
            held={"label": f"bf16, attention projections tempered, 8 x {JAMBA_HELD_PROMPT} "
                           "prompts", "tol": JAMBA_FIRST_STEP_TOL,
                  "faults": {"states lost": _states_lost, "K/V lost": _kv_lost},
                  "weights": lambda p: _tempered(p, cache_of(model, cfg)),
                  "batch": _token_batch(torch, np, cfg.vocab_size, 8, JAMBA_HELD_PROMPT, 37)},
            repeat=True, profile_ranges=("mamba block", "mamba scan"))
    readings[arch]["drop_fraction_by_forward"] = [
        round(torch.stack(drops[i:i + n_moe]).mean().item(), 6)
        for i in range(0, len(drops), n_moe)]
    print(f"[family] {arch} MoE drop fraction per forward (prefill, 32 steps, profiled "
          f"step, profiled prefill, repeat, prefill of prompt + token, the same with the "
          f"embedding moved, then tempered on 8 x {JAMBA_HELD_PROMPT} prompts: prefill for "
          f"the token, prefill, step, prefill of prompt + token): "
          f"{readings[arch]['drop_fraction_by_forward']}")
    launches[f"{arch} prefill"] = readings[arch]["prefill_launches"]
    launches[f"{arch} decode"] = readings[arch]["decode_launches"]
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, readings


# ---------------------------------------------------------------------------
# Phase 14: the four torch examples
# ---------------------------------------------------------------------------

# The kernels at the examples' shapes, held to their plain versions before
# the examples run: (name, B, Sq, Skv, H, KVH, D, causal, segments); the
# first two are trained (the forward timed with the residual), the last
# served.
# torch_train_stream's lm-100m (4 packed rows of 256 tokens from its own
# stream, 10 heads of 64: the wgmma route), torch_fault_tolerance's olmo-1b
# smoke (2 rows of 64, 4 heads of 16: the mma.sync route) and
# torch_serve_microscopy's qwen3-8b smoke prefill (4 prompts of 12, 4 query
# over 1 KV head of 16).  The limits are phase 7's.
EXAMPLE_PACKED = (("lm-100m train stream", 4, 256, 256, 10, 10, 64, True, "stream"),
                  ("olmo-1b smoke", 2, 64, 64, 4, 4, 16, True, None),
                  ("qwen3-8b smoke prefill", 4, 12, 12, 4, 1, 16, True, None))
# torch_serve_microscopy serves in float32 (the JAX example's dtype): its
# prefill through the float32 instances, phase 7b's limits
SERVE_EXAMPLE = "torch_serve_microscopy"
EXAMPLE_PACKED_F32 = (("qwen3-8b smoke prefill f32", 4, 12, 12, 4, 1, 16, True, None),)
# torch_serve_microscopy's decode: qwen3-8b smoke over pages of 4 tokens, 16
# a sequence, a 64-page pool; lengths 13-60 (its 12-token prompts and 8
# generated tokens, and past them to the table's end).  Phase 6's limits.
EXAMPLE_PAGED = (("qwen3-8b smoke G=4", {"B": 4, "H": 4, "KVH": 1, "D": 16,
                                         "page_size": 4, "num_pages": 64,
                                         "max_pages": 16, "lens": (13, 61)}),)


def _example_stream_segments(np):
    """The segment ids of the first of torch_train_stream's packed batches
    (its documents, seed, rows and width) in which all rows but one hold
    two documents or more (the first three hold one long document a row)."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        from torch_train_stream import LM_100M
    finally:
        sys.path.pop(0)
    from repro_torch.data import StreamingPipeline, synthetic_documents

    _, B, S = EXAMPLE_PACKED[0][:3]
    stream = StreamingPipeline(
        synthetic_documents(LM_100M.vocab_size, mean_len=180, max_len=1024, seed=0,
                            limit=None), seq_len=S, batch_size=B, prefetch=0)
    for _, pb in zip(range(MULTI_SEGMENT_SEARCH), stream):
        if (pb.segment_ids.max(axis=1) >= 2).sum() >= B - 1:
            return pb.segment_ids
    raise AssertionError(f"none of the train stream's first {MULTI_SEGMENT_SEARCH} "
                         "batches holds two documents in all rows but one")


def example_kernels(torch, np):
    """Phase 14, part 1: the packed kernels (forward and backward) and the
    paged kernel at the examples' shapes against their plain versions, the
    serving example's in float32 too; returns the by_shape records (packed
    forward, packed backward, paged, packed float32 forward and backward)."""
    from repro_torch.kernels.packed_attention import kernel as pk
    from repro_torch.kernels.packed_attention import ops as packed_ops

    dev = torch.device("cuda")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    fwd, bwd, paged = {}, {}, {}
    for name, B, Sq, Skv, H, KVH, D, causal, seg in EXAMPLE_PACKED:
        seg = _example_stream_segments(np) if seg == "stream" else None
        fwd[name], bwd[name] = _family_packed_case(
            torch, np, pk, packed_ops, name, B, Sq, Skv, H, KVH, D, causal, flush,
            trained="prefill" not in name, seg=seg, tag="examples")
    fwd32, bwd32 = {}, {}
    for name, B, Sq, Skv, H, KVH, D, causal, _ in EXAMPLE_PACKED_F32:
        fwd32[name], bwd32[name] = _family_packed_case(
            torch, np, pk, packed_ops, name, B, Sq, Skv, H, KVH, D, causal, flush,
            trained=False, tag="examples", dtype=torch.float32)
    for key, shape in EXAMPLE_PAGED:
        paged[key] = _paged_case(torch, np, key, shape, "bfloat16", flush)
        _paged_case(torch, np, key, shape, "float32", flush)
    del flush
    torch.cuda.empty_cache()
    return fwd, bwd, paged, fwd32, bwd32


def _launch_line(out: str, name: str) -> dict:
    """The kernel launches an example printed on its ``kernel launches:``
    line, by kernel (``packed_fwd``, ``packed_bwd``, ``paged``); every such
    line summed."""
    import re

    names = {"packed attention forward": "packed_fwd",
             "backward": "packed_bwd", "paged decode attention": "paged"}
    counts = {}
    for line in out.splitlines():
        if line.startswith("kernel launches:"):
            for label, n in re.findall(r"([a-z ]+?) (\d+)", line.split(":", 1)[1]):
                key = names[label.strip()]
                counts[key] = counts.get(key, 0) + int(n)
    if not counts:
        raise AssertionError(f"{name} printed no kernel launches line")
    return counts


def examples_phase(torch):
    """Phase 14, part 2: the four torch examples, each in a child
    interpreter with its own time limit and a fresh temporary directory
    (``TMPDIR``, and ``--ckpt-dir`` for the train stream); returns each
    example's kernel launches, read from its output."""
    import os
    import re
    import shutil
    import tempfile

    runs = (
        ("torch_quickstart", [], 120, {}),
        ("torch_train_stream", ["--steps", "100", "--fail-at", "60"], 600,
         {"packed_fwd", "packed_bwd"}),
        ("torch_serve_microscopy", [], 300, {"packed_fwd", "paged"}),
        ("torch_fault_tolerance", ["--backend", "both"], 600,
         {"packed_fwd", "packed_bwd"}),
    )
    launches, checks, walls = {}, {}, {}
    for name, argv, limit, want in runs:
        tmp = tempfile.mkdtemp(prefix=f"{name}_")
        if name == "torch_train_stream":
            argv = argv + ["--ckpt-dir", os.path.join(tmp, "ckpt")]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, str(ROOT / "examples" / f"{name}.py"), *argv],
                cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC), TMPDIR=tmp),
                capture_output=True, text=True, timeout=limit)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        walls[name] = time.perf_counter() - t0
        out = proc.stdout
        print(f"[examples] {name} {' '.join(argv[:4])}: exit {proc.returncode} "
              f"in {walls[name]:.1f} s")
        for line in out.splitlines():
            if line.startswith(("final step", "loss:", "run ", "generated", "page allocator",
                                "prefill", "step time", "[", "injected", "restored",
                                "placement", "kernel launches", "model:")):
                print(f"[examples]   {line}")
        if proc.returncode != 0:
            sys.stderr.write(out[-3000:] + proc.stderr[-4000:])
            raise RuntimeError(f"{name} exited with {proc.returncode}")
        if want:
            launches[name] = _launch_line(out, name)
            for k in sorted(want):
                checks[f"{name}: {k} launches > 0"] = launches[name].get(k, 0) > 0
        if name == "torch_train_stream":
            done = re.search(r"final step: (\d+)  restarts: (\d+)", out)
            checks["torch_train_stream: final step 100, one restart"] = (
                done is not None and done.groups() == ("100", "1"))
            loss = re.search(r"loss: ([\d.]+) -> ([\d.]+)", out)
            checks["torch_train_stream: the loss fell"] = (
                loss is not None and float(loss[2]) < float(loss[1]))
        if name == "torch_fault_tolerance":
            checks["torch_fault_tolerance: scenario 1 restarted and finished step 12"] = (
                "restarts: 1, completed step 12" in out)
            checks["torch_fault_tolerance: every backend completed 80/80"] = (
                out.count("completed 80/80") == 2)
    print("[examples] " + json.dumps({"launches": launches, "wall_s": walls}))
    print(f"[examples] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"examples: {checks}")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: the other families trained at full width
# ---------------------------------------------------------------------------

# xlstm-125m on 4 rows of 256 tokens (train_4k's 256 x 4096 cut for time:
# its scans are Python loops of ~20 launches a step and layer) in fp32, as
# phase 13 serves it; jamba-v0.1-52b cut to its first layer (one Mamba
# block and a dense SwiGLU MLP: layer 1 is an MoE layer, and the grouped
# matmul has no backward in either package) on 2 x 1024; both through
# ``launch.train.run`` on its pipeline's rows.  seamless-m4t-medium on 4 x
# 512 decoder tokens over 1024 encoder frames and internvl2-1b on 4 rows of
# 256 patch rows + 256 tokens, through ``make_train_step`` on
# ``make_batch`` batches, each row cut into two documents.
# xlstm-125m cut to one period of its layer pattern (6 of 12 layers) and
# from FT_STEPS to 2 steps (PR 25: the script's new phases took ~90 s of
# its 1200, and a slow host read 1210 s; xlstm's step at full depth is
# 13-21 s, host-bound, and its phase ~150-200 s)
FT_XLSTM = {"B": 4, "S": 256, "layers": 6, "steps": 2}
FT_JAMBA = {"B": 2, "S": 1024, "layers": 1}
FT_SEAMLESS = {"B": 4, "frames": 1024, "tokens": 512}
FT_INTERNVL = {"B": 4, "S": 512}
FT_STEPS = 3
# Step 1's loss and named gradients, the trained route (the packed kernels;
# the scans in chunks of 128 under checkpoints) against the plain route
# (the plain flash path; each scan one chunk), by relative l2 from the same
# weights and batch; a planted fault must read above each limit.  The
# limits follow what can part the two routes, read on an NVIDIA H100 80GB
# HBM3 at 700 W before they were set (PERF.md §6).  The attention
# families' kernels round P and dS to bf16 for their products, where the
# plain path keeps dS in fp32 (and rounds dP): 0.8e-2 to 2.6e-2 read,
# against 3e-2 to 1e-1 for the plain route with every weight moved by one
# bf16 ulp; limit 5e-2, every leaf.  The recurrent routes run the same ops
# in the same order, bar the sum over chunks of the gradients of weights a step closes
# over (fp32): read 0 (bitwise) for both; limit 1e-4, under the carry
# reset's 1.9e-2 (jamba's state forgets in a few steps) and 0.76 (xlstm).
FT_LIMITS = {"xlstm-125m": 1e-4, "seamless-m4t-medium": 5e-2, "internvl2-1b": 5e-2,
             "jamba-v0.1-52b": 1e-4}
# The first layer's attention calls of step 1, the kernels' dQ, dK and dV
# against fp64 from the same inputs (``_packed_truth``): within phase 7's
# whole-tensor limit, and so with each segment's keys centred.  Seamless's
# cross attention is where delta matters: its keys (the encoder's output)
# hold most of their energy in their segments' mean, which a row of dS
# (summing to zero) cancels only with a delta as exact as the output's
# fp32 one.  With delta from the bf16 output alone (before the forward
# wrote its residual) it read, on an H100 80GB HBM3 at 700 W:
# keys 94% in their mean, the kernels' dQ 0.303 from fp64 (fp64 with delta
# from the bf16 output 0.303, with dS in bf16 alone 3.7e-3, the plain path
# 6.7e-3), and the gradient of the decoder's first cross-attention wq
# 0.297 against the plain route.  That arithmetic stays as a planted
# fault (the residual zeroed), which must read above the limit there.
# The residual makes out + out_lo the fp32 output with P's rounded weights
# renormalised to sum to one (``csrc/packed_attention.cu``): the fp32
# output itself, which rounding P moves by the values' mean times the sum
# of P's rounding errors, read 1.46e-2 there.
FT_FP64_LIMIT = PACKED_REL_L2[0]
# The leaves held (``path[0]``: the first layer of a stacked leaf): the
# embedding, the first attention's projections (seamless: the encoder's and
# both of the decoder's queries) or the first mixer's, the last norm.
FT_LEAVES = {
    "xlstm-125m": ["embed", "blocks/0/mixer/up[0]", "blocks/0/mixer/wq[0]",
                   "blocks/5/mixer/wr[0]", "final_norm/scale"],
    "seamless-m4t-medium": ["embed", "enc_blocks/self_attn/wq[0]", "enc_blocks/self_attn/wk[0]",
                            "enc_blocks/self_attn/wv[0]", "enc_blocks/self_attn/wo[0]",
                            "dec_blocks/self_attn/wq[0]", "dec_blocks/cross_attn/wq[0]",
                            "final_norm/scale"],
    "internvl2-1b": ["embed", "blocks/0/mixer/wq[0]", "blocks/0/mixer/wk[0]",
                     "blocks/0/mixer/wv[0]", "blocks/0/mixer/wo[0]", "blocks/0/ffn/w_down[0]"],
    "jamba-v0.1-52b": ["embed", "blocks/0/mixer/in_proj[0]", "blocks/0/mixer/A_log[0]",
                       "blocks/0/mixer/out_proj[0]", "final_norm/scale"],
}


class _PlainPacked:
    """Stands in for ``kernels.packed_attention.ops`` in ``models.layers``:
    the plain chunked flash path, on the card (the plain route)."""

    @staticmethod
    def packed_attention(q, k, v, segment_ids, segment_ids_kv, *, causal, window):
        from repro_torch.models.layers import flash_attention

        return flash_attention(q, k, v, segment_ids, segment_ids_kv, causal=causal,
                               window=window)


class _HiddenKeyTile:
    """Planted fault: the kernels with each row's keys S/2 .. S/2 + 63
    hidden from every query (phase 7's skipped tile)."""

    @staticmethod
    def packed_attention(q, k, v, segment_ids, segment_ids_kv, **kw):
        from repro_torch.kernels.packed_attention import ops

        S = segment_ids_kv.shape[1]
        hidden = segment_ids_kv.clone()
        hidden[:, S // 2:S // 2 + 64] = int(segment_ids_kv.max()) + 1
        return ops.packed_attention(q, k, v, segment_ids, hidden, **kw)


class _MergedSegments:
    """Planted fault: the kernels with each row's second document merged
    into its first (a segment boundary dropped)."""

    @staticmethod
    def packed_attention(q, k, v, segment_ids, segment_ids_kv, **kw):
        from repro_torch.kernels.packed_attention import ops

        def merged(s):
            return s.masked_fill(s == 2, 1)

        return ops.packed_attention(q, k, v, merged(segment_ids), merged(segment_ids_kv),
                                    **kw)


def _one_chunk(step, init, xs, *, chunk_size):
    """The plain route's scan: every step in one chunk."""
    from repro_torch.models.scan_utils import chunked_scan

    return chunked_scan(step, init, xs, chunk_size=1 << 30)


def _carry_reset(step, init, xs, *, chunk_size):
    """Planted fault: the scan's carry reset to its initial value at the
    first chunk boundary."""
    import torch

    from repro_torch.models.scan_utils import _leaves, _map, chunked_scan

    c = chunk_size
    if _leaves(xs)[0].shape[0] <= c:
        return chunked_scan(step, init, xs, chunk_size=c)
    _, ys0 = chunked_scan(step, init, _map(lambda x: x[:c], xs), chunk_size=c)
    carry, ys1 = chunked_scan(step, init, _map(lambda x: x[c:], xs), chunk_size=c)
    return carry, _map(lambda a, b: torch.cat([a, b]), ys0, ys1)


@contextlib.contextmanager
def _routed(scan=None, packed=None):
    """The mixers' scan and the layers' packed-attention entry replaced."""
    from repro_torch.models import layers, ssm, xlstm

    with contextlib.ExitStack() as stack:
        if scan is not None:
            stack.enter_context(_patched(ssm, "chunked_scan", scan))
            stack.enter_context(_patched(xlstm, "chunked_scan", scan))
        if packed is not None:
            stack.enter_context(_patched(layers, "packed_ops", packed))
        yield


def _step1_grads(torch, model, params, batch, dtype, names):
    """Step 1's loss and the gradients of ``names`` (``path[0]``: the first
    layer of a stacked leaf), through the ``dtype`` compute copy of the
    fp32 masters with remat "nothing", as ``make_train_step`` takes them."""
    from repro_torch.models.params import tree_leaves, tree_paths, tree_unflatten
    from repro_torch.training.train_step import cast_params_for_compute

    leaves = [t.detach().requires_grad_(True)
              for t in tree_leaves(cast_params_for_compute(params, dtype))]
    with torch.enable_grad():
        loss, _ = model.loss(tree_unflatten(params, leaves), batch, remat_policy="nothing")
        grads = torch.autograd.grad(loss, leaves)
    by_path = {"/".join(p): g for (p, _), g in zip(tree_paths(params), grads)}
    out = {"loss": loss.detach().float().reshape(1)}
    for name in names:
        path, first = (name[:-3], True) if name.endswith("[0]") else (name, False)
        g = by_path[path]
        out[name] = (g[0] if first else g).float()
    return out


def _rel(a, b):
    """Relative l2 of each entry of two ``_step1_grads`` readings."""
    return {k: ((a[k] - b[k]).norm() / b[k].norm()).item() for k in b}


def _moved(torch, params, dtype):
    """The masters with every entry moved by about one ulp of ``dtype``, up
    or down at random (seed 0): the plain route's noise witness."""
    from repro_torch.models.params import tree_map

    gen = torch.Generator(device="cuda").manual_seed(0)
    eps = torch.finfo(dtype).eps

    def one(t):
        sign = torch.randint(0, 2, t.shape, generator=gen, device=t.device) * 2 - 1
        return t * (1 + eps * sign)

    return tree_map(one, params)


def _family_routes(torch, tag, model, params, batch, dtype, names, plain, fault, want,
                   limit=None):
    """Step 1 through the trained route and the plain route from the same
    weights and batch, the plain route's one-ulp witness and a planted
    fault: the readings of the loss and ``names``, the trained route's
    launches (held to ``want``); ``limit`` (``FT_LIMITS[tag]``) holds the
    trained route to the plain one."""
    limit = FT_LIMITS[tag] if limit is None else limit
    _zero_counts()
    got = _step1_grads(torch, model, params, batch, dtype, names)
    torch.cuda.synchronize()
    launches = _counts()
    with _routed(**plain):
        ref = _step1_grads(torch, model, params, batch, dtype, names)
        witness = _step1_grads(torch, model, _moved(torch, params, dtype), batch, dtype,
                               names)
    r = {"trained_vs_plain": _rel(got, ref), "plain_one_ulp_witness": _rel(witness, ref),
         "limit": limit, "launches_step": launches, "loss_step1": got["loss"].item()}
    checks = {
        f"{tag}: trained route within {limit} of the plain route":
            max(r["trained_vs_plain"].values()) <= limit,
        f"{tag}: launches a step {want}": launches == want,
        f"{tag}: loss and gradients finite": all(
            bool(torch.isfinite(t).all()) for t in got.values()),
    }
    if fault is not None:
        with _routed(**fault):
            planted = _step1_grads(torch, model, params, batch, dtype, names)
        r["planted"] = _rel(planted, ref)
        checks[f"{tag}: the planted fault reads above the limit"] = (
            max(r["planted"].values()) > limit)
    return r, checks


def _packed_truth(torch, model, params, batch, dtype):
    """The first layer's attention calls of step 1 on the kernel route (its
    causal self attention and, in an encoder-decoder, its cross attention),
    their inputs and output gradient caught: dQ, dK and dV of the kernels
    and of the plain flash path from those inputs, each by relative l2 to
    the same function in fp64; the kernels again with each segment's keys
    centred (their mean subtracted: the same attention, held to its own
    fp64); the kernels with the forward's residual zeroed (delta
    from the bf16 output: a planted fault); ``sdpa`` (the library's flash
    backward) one document at a time; dQ in fp64 with the kernels'
    roundings put back (delta = rowsum(dO O) from the bf16 output, or from
    it and its rounding residual; dS rounded to bf16 before dS K); and the
    share of the keys' energy in their segments' means."""
    import torch.nn.functional as F

    from repro_torch.kernels.packed_attention import kernel as pk
    from repro_torch.kernels.packed_attention import ops
    from repro_torch.kernels.packed_attention.ref import visible_mask
    from repro_torch.models.layers import flash_attention

    calls, arrived = [], [0]

    class Catch(torch.autograd.Function):
        """The identity; its backward keeps the gradient and its order."""

        @staticmethod
        def forward(ctx, out, rec):
            ctx.rec = rec
            return out.view_as(out)

        @staticmethod
        def backward(ctx, g):
            ctx.rec["dout"], ctx.rec["order"] = g.detach(), arrived[0]
            arrived[0] += 1
            return g, None

    class Recorder:
        @staticmethod
        def packed_attention(q, k, v, segment_ids, segment_ids_kv, **kw):
            rec = {"q": q.detach(), "k": k.detach(), "v": v.detach(), "seg_q": segment_ids,
                   "seg_kv": segment_ids_kv, **kw}
            calls.append(rec)
            return Catch.apply(ops.packed_attention(q, k, v, segment_ids, segment_ids_kv,
                                                    **kw), rec)

    with _routed(packed=Recorder):
        _step1_grads(torch, model, params, batch, dtype, [])
    first = {}  # the backward reaches the first layer's calls last
    for c in calls:
        kind = ("self" if c["causal"] else
                "cross" if c["q"].shape[1] != c["k"].shape[1] else None)
        if kind and "dout" in c and c["order"] > first.get(kind, {"order": -1})["order"]:
            first[kind] = c
    del calls

    def grads(fn, q, k, v, dout, dt):
        ts = [t.detach().to(dt).clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*ts)
        return torch.autograd.grad(out, ts, dout.to(out.dtype))

    def rel(got, want):
        return {n: ((a.double() - b).norm() / b.norm()).item()
                for n, a, b in zip(("dq", "dk", "dv"), got, want)}

    readings = {}
    for kind, c in first.items():
        assert c["window"] == 0
        q, k, v, dout, sq, skv, causal = (c[n] for n in (
            "q", "k", "v", "dout", "seg_q", "seg_kv", "causal"))
        mask = visible_mask(sq, skv, causal=causal)[:, None]  # (B, 1, Sq, Skv)
        seen = mask.any(-1, keepdim=True)

        def exact(q, k, v):
            G = q.shape[2] // k.shape[2]
            k, v = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
            s = s.masked_fill(~mask, float("-inf")).masked_fill(~seen, 0.0)
            return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1) * mask, v)

        def kernel(q, k, v):
            return ops.packed_attention(q, k, v, sq, skv, causal=causal, window=0)

        def plain(q, k, v):
            return flash_attention(q, k, v, sq, skv, causal=causal, window=0)

        def bf16_delta():  # the kernels, delta from the bf16 output alone
            args = [t.contiguous() for t in (q, k, v)] + [
                t.to(torch.int32).contiguous() for t in (sq, skv)]
            out, lse, lo = pk.packed_flash_attention(*args, causal=causal, residual=True)
            return pk.packed_flash_attention_bwd(*args, out, torch.zeros_like(lo),
                                                 dout.contiguous(), lse, causal=causal)

        def library():  # each row's documents, one sdpa call each
            got = [torch.zeros_like(t) for t in (q, k, v)]
            for b in range(q.shape[0]):
                for sid in sq[b].unique().tolist():
                    mq, mk = sq[b] == sid, skv[b] == sid
                    ts = [t[b, m].transpose(0, 1)[None].clone().requires_grad_(True)
                          for t, m in ((q, mq), (k, mk), (v, mk))]
                    out = F.scaled_dot_product_attention(
                        *ts, is_causal=causal, enable_gqa=q.shape[2] != k.shape[2])
                    gs = torch.autograd.grad(out, ts, dout[b, mq].transpose(0, 1)[None])
                    for dst, m, g in zip(got, (mq, mk, mk), gs):
                        dst[b, m] = g[0].transpose(0, 1)
            return got

        def dq64(bf16_out, bf16_ds):
            """dQ written out in fp64, with the roundings put back: the
            output for delta rounded to bf16 (``bf16_out`` "hi") or to bf16
            and its rounding residual ("hi+lo"), dS to bf16."""
            G = q.shape[2] // k.shape[2]
            q64, g64 = q.double(), dout.double()
            k64, v64 = (t.double().repeat_interleave(G, 2) for t in (k, v))
            scale = q.shape[-1] ** -0.5
            sc = torch.einsum("bqhd,bkhd->bhqk", q64, k64) * scale
            sc = sc.masked_fill(~mask, float("-inf")).masked_fill(~seen, 0.0)
            p = torch.softmax(sc, -1) * mask
            o = torch.einsum("bhqk,bkhd->bqhd", p, v64)
            if bf16_out:
                hi = o.to(torch.bfloat16).double()
                o = hi + (o - hi).to(torch.bfloat16).double() if bf16_out == "hi+lo" else hi
            delta = (g64 * o).sum(-1).transpose(1, 2)[..., None]  # (B, H, Sq, 1)
            ds = p * (torch.einsum("bqhd,bkhd->bhqk", g64, v64) - delta)
            if bf16_ds:
                ds = ds.to(torch.bfloat16).double()
            return torch.einsum("bhqk,bkhd->bqhd", ds, k64) * scale

        kc = k.float()
        for sid in skv.unique().tolist():
            if sid:
                m = (skv == sid)[:, :, None, None]
                mean = (k.float() * m).sum(1, keepdim=True) / m.sum(1, keepdim=True)
                kc = torch.where(m, kc - mean, kc)
        share = 1.0 - (kc.norm() / k.float().norm()).item() ** 2
        kc = kc.to(k.dtype)
        truth = grads(exact, q, k, v, dout, torch.float64)
        truth_c = grads(exact, q, kc, v, dout, torch.float64)
        roundings = {name: ((dq64(*flags) - truth[0]).norm() / truth[0].norm()).item()
                     for name, flags in (("none (dQ written out)", (None, False)),
                                         ("delta from the bf16 output", ("hi", False)),
                                         ("dS in bf16", (None, True)),
                                         ("both", ("hi", True)),
                                         ("delta from the bf16 output and its residual, "
                                          "dS in bf16", ("hi+lo", True)))}
        readings[kind] = {
            "shape": {"B": q.shape[0], "Sq": q.shape[1], "Skv": k.shape[1], "H": q.shape[2],
                      "KVH": k.shape[2], "D": q.shape[3], "causal": causal,
                      "documents": int(sq.max())},
            "kernel_vs_fp64": rel(grads(kernel, q, k, v, dout, dtype), truth),
            "plain_vs_fp64": rel(grads(plain, q, k, v, dout, dtype), truth),
            "kernel_centred_keys_vs_fp64": rel(grads(kernel, q, kc, v, dout, dtype), truth_c),
            "planted_kernel_delta_from_the_bf16_output_vs_fp64": rel(bf16_delta(), truth),
            "sdpa_by_document_vs_fp64": rel(library(), truth),
            "fp64_dq_with_the_kernels_rounding_vs_fp64": roundings,
            "key_mean_energy_share": share}
        del truth, truth_c, kc, mask, seen
    del first
    torch.cuda.empty_cache()
    return readings


def _family_profile(torch, step, wall_ms, recurrent):
    """One step under ``torch.profiler`` (``_device_profile``): device ms,
    busy share, launches, and for a recurrent family the share of device
    time of the kernels launched inside the scans' forward runs (the first
    pass and both recomputes; their backward is in no range)."""
    from repro_torch.models import scan_utils

    real = scan_utils._scan

    def ranged(*a, **kw):
        with torch.autograd.profiler.record_function("scan forward"):
            return real(*a, **kw)

    with _patched(scan_utils, "_scan", ranged) if recurrent else contextlib.nullcontext():
        prof = _device_profile(torch, step, 1, wall_ms, ("scan forward",) if recurrent else ())
    return {k: v for k, v in prof.items() if not k.startswith(("paged", "gmm"))}


def _token_rows(vocab, S, B):
    """The rows ``launch.train.run``'s pipeline packs at ``S`` tokens."""
    from repro_torch.data import StreamingPipeline, synthetic_documents

    return iter(StreamingPipeline(
        synthetic_documents(vocab, mean_len=S // 3, max_len=4 * S, seed=0),
        seq_len=S, batch_size=B, prefetch=0))


def _two_documents(torch, batch, cuts, frames=None):
    """``batch`` (numpy-drawn, on the CPU) with row b cut into two documents
    at token ``cuts[b]`` (and, for an encoder-decoder batch, at frame
    ``frames[b]``): segment ids 1 then 2, positions restarting at the cut."""
    out = dict(batch)
    seg, pos = batch["segment_ids"].clone(), batch["positions"].clone()
    for b, c in enumerate(cuts):
        seg[b, c:] = 2
        pos[b, c:] = torch.arange(seg.shape[1] - c, dtype=pos.dtype)
    out["segment_ids"], out["positions"] = seg, pos
    if frames is not None:
        enc = batch["enc_segment_ids"].clone()
        for b, c in enumerate(frames):
            enc[b, c:] = 2
        out["enc_segment_ids"] = enc
    return out


def _train_tokens(torch, tag, cfg, shape, dtype, names, none):
    """A token family: step 1's routes from the drawn masters on the first
    row batch of ``launch.train.run``'s pipeline, then ``FT_STEPS`` steps
    (``shape["steps"]`` where given) of
    ``launch.train.run`` (--mesh none) from the same masters, and one more
    step profiled after the run."""
    import shutil
    import tempfile

    from repro_torch.launch import train
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    model = build_model(cfg)
    params = train.make_params(model, 0, dev)
    first = next(_token_rows(cfg.vocab_size, shape["S"], shape["B"]))
    batch = {k: torch.from_numpy(getattr(first, k)).to(dev)
             for k in ("tokens", "labels", "segment_ids", "positions")}
    routes, checks = _family_routes(torch, tag, model, params, batch, dtype, names,
                                    {"scan": _one_chunk}, {"scan": _carry_reset}, none)
    del batch
    seen = {}

    def after_run(step_fn, p, o, batches):
        seen["launches"] = _counts()
        seen["step"] = (step_fn, p, o, next(batches))

    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="family_train_", dir=ROOT / "build")
    steps = shape.get("steps", FT_STEPS)
    argv = ["--arch", cfg.name, "--steps", str(steps),
            "--seq-len", str(shape["S"]), "--batch-size", str(shape["B"]),
            "--remat", "nothing", "--mesh", "none", "--ckpt-every", "1000",
            "--ckpt-dir", ckpt]
    _zero_counts()
    try:
        stats = train.run(train.parse_args(argv), params=params, compute_dtype=dtype,
                          cfg=cfg, after_run=after_run)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    step_fn, p, o, nxt = seen.pop("step")
    seen["profile"] = _family_profile(torch, lambda: step_fn(p, o, nxt),
                                      stats["step_ms_p50"], True)
    del step_fn, p, o, nxt
    out = {"routes": routes, "steps": stats["steps"], "losses": stats["losses"],
           "step_ms": stats["step_ms"], "step_ms_p50": stats["step_ms_p50"],
           "tokens_per_s_p50_step": stats["tokens_per_s_p50_step"],
           "peak_device_mem_gib": stats["peak_device_mem_gib"],
           "launches_run": seen["launches"], "profile": seen["profile"]}
    checks.update({
        f"{tag}: {steps} steps, losses finite": stats["steps"] == steps and _finite(
            stats["losses"] + stats["grad_norms"]),
        f"{tag}: the run launched no kernel": seen["launches"] == none,
    })
    return out, checks


def _finite(values) -> bool:
    import math

    return all(math.isfinite(v) for v in values)


def _train_batches_of(torch, tag, model, batches, names, n_attn, none, kinds,
                      plain_curve=False):
    """An attention family through ``make_train_step`` on ``batches`` (on
    the card), the attention projections tempered (``_tempered``): step 1's
    routes on the first batch, its first layer's attention calls (``kinds``)
    against fp64, ``FT_STEPS`` steps with their launches, and one more step
    profiled; with ``plain_curve``, the same steps from the same weights on
    the plain route too (its losses beside the kernels')."""
    from repro_torch.launch import train
    from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step

    dev = torch.device("cuda")
    params = train.make_params(model, 0, dev)
    per_step = dict(none, packed=2 * n_attn, packed_bwd=n_attn)
    with _tempered(params, None) as (params, _):
        routes, checks = _family_routes(
            torch, tag, model, params, batches[0], torch.bfloat16, names,
            {"packed": _PlainPacked}, {"packed": _MergedSegments}, per_step)
        truth = _packed_truth(torch, model, params, batches[0], torch.bfloat16)
        step_fn = make_train_step(model, OptimizerConfig(), remat_policy="nothing")
        opt_state = init_opt_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        losses, ms, p, o = _timed_steps(torch, step_fn, params, opt_state,
                                        batches[:FT_STEPS])
        got = _counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        p50 = sorted(ms)[len(ms) // 2]
        prof = _family_profile(torch, lambda: step_fn(p, o, batches[0]), p50, False)
        del p, o
        plain_losses = None
        if plain_curve:
            with _routed(packed=_PlainPacked):
                plain_losses, _, p, o = _timed_steps(torch, step_fn, params,
                                                     init_opt_state(params),
                                                     batches[:FT_STEPS])
            del p, o
            print(f"[family-train] {tag}: losses over {FT_STEPS} steps, kernels {losses}, "
                  f"plain route {plain_losses}")
        del opt_state, step_fn
    tokens = batches[0]["tokens"].numel()
    out = {"routes": routes, "packed_vs_fp64": truth, "losses": losses,
           "losses_plain_route": plain_losses, "step_ms": ms,
           "step_ms_p50": p50,
           "tokens_per_s_p50_step": tokens / (p50 / 1e3), "peak_device_mem_gib": peak,
           "launches_run": got, "profile": prof}
    checks[f"{tag}: the first layer's {kinds} attention caught"] = set(truth) == set(kinds)
    for kind, r in truth.items():
        for n, err in r["kernel_vs_fp64"].items():
            checks[f"{tag}: {kind} attention {n}, kernels within {FT_FP64_LIMIT} of "
                   "fp64"] = err <= FT_FP64_LIMIT
        checks[f"{tag}: {kind} attention, kernels on centred keys within {FT_FP64_LIMIT} "
               "of fp64"] = max(r["kernel_centred_keys_vs_fp64"].values()) <= FT_FP64_LIMIT
        if kind == "cross":
            checks[f"{tag}: cross attention dq with delta from the bf16 output (planted) "
                   f"above {FT_FP64_LIMIT} of fp64"] = (
                r["planted_kernel_delta_from_the_bf16_output_vs_fp64"]["dq"] > FT_FP64_LIMIT)
    checks.update({
        f"{tag}: losses finite": _finite(losses),
        f"{tag}: launches over {FT_STEPS} steps {FT_STEPS} x {per_step}": got == {
            k: FT_STEPS * v for k, v in per_step.items()},
    })
    return out, checks


def family_train_phase(torch, np, smi):
    """Phase 15: xlstm-125m, seamless-m4t-medium, internvl2-1b and
    jamba-v0.1-52b's first layer trained at full width (``FT_*``); returns
    each path's packed launches a step and the readings."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, make_batch

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[family-train] {smi}; {torch.cuda.memory_allocated() / 2**30:.2f} GiB held "
          "before the phase")
    none = {"gmm": 0, "paged": 0, "packed": 0, "packed_bwd": 0}
    readings, checks, launches = {}, {}, {}

    def done(tag, t0, result):
        out, ok = result
        out["seconds"] = time.perf_counter() - t0
        readings[tag] = out
        checks.update(ok)
        # a step of the main path's own run, counted from 0 just before it
        # (held to its steps x the step's count above)
        launches[f"{tag} train step"] = {k: v // len(out["losses"])
                                         for k, v in out["launches_run"].items()}
        print(f"[family-train] {tag} " + json.dumps(out))
        gc.collect()
        torch.cuda.empty_cache()

    # xlstm-125m cut to one period of its pattern (6 of 12 layers: five
    # mLSTM blocks and the sLSTM), d 768, in fp32; no kernel on its path
    arch = "xlstm-125m"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=FT_XLSTM["layers"])
    print(f"[family-train] {arch}: reduced n_layers 12 -> {cfg.n_layers} (pattern "
          f"{cfg.pattern!r}), {FT_XLSTM['steps']} steps")
    done(arch, t0, _train_tokens(
        torch, arch, cfg, FT_XLSTM, torch.float32, FT_LEAVES[arch], none))

    # seamless-m4t-medium: 12 + 12 layers; 36 packed calls a forward
    arch = "seamless-m4t-medium"
    t0 = time.perf_counter()
    cfg = get_config(arch)
    B, F, T = FT_SEAMLESS["B"], FT_SEAMLESS["frames"], FT_SEAMLESS["tokens"]
    batches = []
    for seed in range(FT_STEPS):
        b = make_batch(cfg, "train", B, 2 * F, seed=seed)  # F frames, F tokens: cut to T
        b = {k: (v[:, :T] if k in ("tokens", "labels", "segment_ids", "positions") else v)
             for k, v in b.items()}
        b = _two_documents(torch, b, _cuts(T, B), _cuts(F, B))
        batches.append({k: v.to(dev) for k, v in b.items()})
    done(arch, t0, _train_batches_of(
        torch, arch, build_model(cfg), batches, FT_LEAVES[arch],
        cfg.n_encoder_layers + 2 * cfg.n_layers, none, ("self", "cross"), plain_curve=True))
    del batches

    # internvl2-1b: 24 layers, 14 query over 2 KV heads of 64
    arch = "internvl2-1b"
    t0 = time.perf_counter()
    cfg = get_config(arch)
    B, S = FT_INTERNVL["B"], FT_INTERNVL["S"]
    text = cfg.frontend_tokens
    batches = [{k: v.to(dev) for k, v in _two_documents(
        torch, make_batch(cfg, "train", B, S, seed=seed),
        [text + c for c in _cuts(S - text, B)]).items()}
        for seed in range(FT_STEPS)]
    done(arch, t0, _train_batches_of(
        torch, arch, build_model(cfg), batches, FT_LEAVES[arch], cfg.n_layers, none,
        ("self",)))
    del batches

    # jamba-v0.1-52b cut to its first layer: one Mamba block, a dense MLP
    arch = "jamba-v0.1-52b"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=FT_JAMBA["layers"],
                              layer_pattern=get_config(arch).pattern[:FT_JAMBA["layers"]])
    print(f"[family-train] {arch}: reduced n_layers 32 -> {cfg.n_layers} (pattern "
          f"{cfg.pattern!r}, MoE layers {sum(cfg.moe.is_moe_layer(i) for i in range(cfg.n_layers))}"
          f"; {cfg.param_counts()[0] / 1e9:.3f} B parameters)")
    done(arch, t0, _train_tokens(
        torch, arch, cfg, FT_JAMBA, torch.bfloat16, FT_LEAVES[arch], none))

    print(f"[family-train] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"family training: {checks}")
    return launches, readings


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        _fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    if sys.argv[1:] == [MP_FLAG]:
        multiproc_phase()
        return
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[card] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # 2. the build: one nvcc per source, all started together
    from repro_torch.kernels.grouped_matmul import kernel as gmm_kernel
    from repro_torch.kernels.packed_attention import kernel as packed_kernel
    from repro_torch.kernels.paged_attention import kernel as paged_kernel

    def timed_build(kernel):
        t0 = time.perf_counter()
        return kernel.build(), time.perf_counter() - t0

    with _phase("build"):
        kernels = (gmm_kernel, paged_kernel, packed_kernel)
        with ThreadPoolExecutor(len(kernels)) as pool:
            builds = list(pool.map(timed_build, kernels))
        for lib, secs in builds:
            print(f"[build] {lib.relative_to(ROOT)} in {secs:.2f} s")

    # 3. the multiproc path, in a child process
    with _phase("multiproc"):
        child = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), MP_FLAG],
            capture_output=True, text=True, timeout=600,
        )
        sys.stdout.write(child.stdout)
        sys.stderr.write(child.stderr[-4000:])
        if child.returncode != 0:
            raise RuntimeError(f"the child exited with {child.returncode}")
        mp_runs = [json.loads(line)["multiproc"]
                   for line in child.stdout.splitlines()
                   if line.startswith('{"multiproc"')]
        if [r["payload"] for r in mp_runs] != [size for size, _, _ in MP_RUNS]:
            raise RuntimeError(f"the child reported {mp_runs}")

    # 4. the grouped matmul against its plain version
    with _phase("kernel grouped_matmul"):
        gmm_record, gmm_by_shape = kernel_phase(torch, np)

    # 5. the streaming slice at full size
    with _phase("full stream"):
        gmm_launches = full_phase(torch, np)

    # 6. the paged kernel against its plain version
    with _phase("kernel paged_attention"):
        paged_records, window_records = paged_kernel_phase(torch, np)
        paged_record = paged_records["qwen3-8b G=4"]

    # 7. the packed-attention kernels against their plain version
    with _phase("kernel packed_attention"):
        packed_records, packed_moe_record = packed_kernel_phase(torch, np)
        packed_fwd_record, packed_bwd_record = packed_records["train"]

    # 7b. the packed kernels' float32 instances against their plain version
    with _phase("kernel packed_attention f32"):
        f32_fwd, f32_bwd = packed_f32_phase(torch, np)

    # 8. the attention block at full width, kernels against the plain path
    with _phase("attention block"):
        block_phase(torch, np)

    # 9. the serving entry point at full width
    with _phase("serve run_local"):
        serve_launches, serve_packed = serve_phase(torch)

    # 9b. the serving entry point in float32, kernels against the plain route
    with _phase("serve run_local f32"):
        serve_f32_paged, serve_f32_packed = serve_f32_phase(torch)

    # 10. ragged prompts through prefill and paged decode; 10b with a window
    with _phase("ragged serve"):
        ragged_launches, ragged_packed, decode_reading, window_launches = ragged_phase(
            torch, np)

    # 11. training at full width and depth
    with _phase("train"):
        train_fwd, train_bwd = train_phase(torch, np)

    # 11d. training in float32 compute at full width and depth
    with _phase("train f32"):
        train_f32_fwd, train_f32_bwd = train_f32_phase(torch, np)

    # 11b. the distributed layer: gradient compression, --mesh local
    with _phase("distributed"):
        dist_launches = distributed_phase(torch, np)

    # 11c. the dry-run, and its count of four steps against the card
    with _phase("dry-run"):
        dryrun_phase(torch, np, smi, decode_reading)

    # 12. MoE serving at full width and depth
    with _phase("moe serve"):
        moe_launches = moe_phase(torch, np)

    # 13. the hybrid, recurrent, encoder-decoder and vision families
    with _phase("families"):
        fam_fwd, fam_bwd, fam_paged, fam_gmm = family_kernels(torch, np)
        fam_launches, _ = families_phase(torch, np)

    # 14. the four torch examples, each in a child interpreter
    with _phase("examples"):
        ex_fwd, ex_bwd, ex_paged, ex_fwd32, ex_bwd32 = example_kernels(torch, np)
        ex_launches = examples_phase(torch)
    ex_path = {f"example {name}": c for name, c in ex_launches.items()}

    # 15. the other families trained at full width
    with _phase("family train"):
        ft_launches, _ = family_train_phase(torch, np, smi)

    print(json.dumps({"kernels": [{
        "name": "grouped_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/grouped_matmul/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul/kernel.py:31",
        "launches": gmm_launches,
        "launches_by_path": {
            **{f"multiproc {r['payload']}": r["launches"] for r in mp_runs},
            "inproc full": gmm_launches,
            **{path: c["gmm"] for path, c in moe_launches.items()},
            **{path: c["gmm"] for path, c in fam_launches.items()},
            **{path: c["gmm"] for path, c in ft_launches.items()},
        },
        **gmm_record,
        "by_shape": {**gmm_by_shape, **fam_gmm},
    }, {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:39",
        "launches": serve_launches,
        "launches_by_path": {"serve run_local": serve_launches,
                             "serve run_local f32": serve_f32_paged,
                             "ragged serve": ragged_launches,
                             **{path: c["paged"] for path, c in moe_launches.items()
                                if "paged" in c},
                             **{path: c["paged"] for path, c in fam_launches.items()},
                             **{p: c["paged"] for p, c in ex_path.items() if "paged" in c},
                             **{path: c["paged"] for path, c in ft_launches.items()}},
        **paged_record,
        "by_shape": {**paged_records, **fam_paged, **ex_paged},
    }, {
        "name": "packed_flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/packed_attention/csrc/packed_attention.cu",
        "replaces": "src/repro/kernels/packed_attention/kernel.py:39",
        "launches": train_fwd,
        "launches_by_path": {"train": train_fwd, "serve run_local": serve_packed,
                             "train f32": train_f32_fwd,
                             "serve run_local f32": serve_f32_packed,
                             **{f"distributed {k}": v[0] for k, v in dist_launches.items()},
                             "ragged serve": ragged_packed,
                             **{path: c["packed"] for path, c in moe_launches.items()
                                if "packed" in c},
                             **{path: c["packed"] for path, c in fam_launches.items()},
                             **{p: c["packed_fwd"] for p, c in ex_path.items()
                                if SERVE_EXAMPLE not in p},
                             **{p: c["packed"] for p, c in ft_launches.items()}},
        **packed_fwd_record,
        "by_shape": {**{n: fwd for n, (fwd, _) in packed_records.items()},
                     f"{MOE_ARCH} prefill": packed_moe_record, **fam_fwd,
                     **ex_fwd},
    }, {
        "name": "packed_flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/packed_attention/csrc/packed_attention.cu",
        "replaces": "src/repro/models/layers.py:147",
        "launches": train_bwd,
        "launches_by_path": {"train": train_bwd, "serve run_local": 0,
                             "train f32": train_f32_bwd, "serve run_local f32": 0,
                             **{f"distributed {k}": v[1] for k, v in dist_launches.items()},
                             "ragged serve": 0,
                             **{path: 0 for path, c in moe_launches.items()
                                if "packed" in c},
                             **{path: c["packed_bwd"] for path, c in fam_launches.items()},
                             **{p: c.get("packed_bwd", 0) for p, c in ex_path.items()
                                if SERVE_EXAMPLE not in p},
                             **{p: c["packed_bwd"] for p, c in ft_launches.items()}},
        **packed_bwd_record,
        "by_shape": {**{n: bwd for n, (_, bwd) in packed_records.items()}, **fam_bwd,
                     **ex_bwd},
    }, {
        "name": "packed_flash_attention_f32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/packed_attention/csrc/packed_attention.cu",
        "replaces": "src/repro/kernels/packed_attention/kernel.py:39",
        "launches": train_f32_fwd,
        "launches_by_path": {"train f32": train_f32_fwd,
                             "serve run_local f32": serve_f32_packed,
                             **{p: c["packed_fwd"] for p, c in ex_path.items()
                                if SERVE_EXAMPLE in p}},
        **f32_fwd["train f32"],
        "by_shape": {**f32_fwd, **ex_fwd32},
    }, {
        "name": "packed_flash_attention_bwd_f32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/packed_attention/csrc/packed_attention.cu",
        "replaces": "src/repro/models/layers.py:147",
        "launches": train_f32_bwd,
        "launches_by_path": {"train f32": train_f32_bwd, "serve run_local f32": 0,
                             **{p: c.get("packed_bwd", 0) for p, c in ex_path.items()
                                if SERVE_EXAMPLE in p}},
        **f32_bwd["train f32"],
        "by_shape": {**f32_bwd, **ex_bwd32},
    }, {
        "name": "paged_decode_attention_window",
        "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:39",
        "launches": window_launches,
        "launches_by_path": {"ragged serve window": window_launches},
        **window_records[f"qwen3-8b G=4 window {SERVE_WINDOW} bfloat16"],
        "by_shape": window_records,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
