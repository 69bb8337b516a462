#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--sf 10] [--seed 0] [--out chiprun_out/chip_smoke.json]

Phases, each of which must pass for the exit code to be 0:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the segreduce, flash-attention forward and backward and WKV6
   forward and backward CUDA kernels from their sources under
   src/repro_torch/kernels/*/csrc, one nvcc each, started together;
3. kernel against its plain PyTorch version on the card: fused_segreduce
   and segreduce for sum/max/min over int32/f32/bf16, masked and unmasked,
   N in {0, 1, 5000, 60M} and K in {1, 100, 100001, 2000001}, plus whole
   groups of those columns in one launch, each case run twice and required
   to be bitwise equal; each (N, K) prints the regime its launches took
   (with a float sum: K = 1 and 100 in per-warp tables, larger K after a
   partition by key range, or in one launch where N times its key ranges
   is at most kernel.SMALL_READS;
   without one: K = 1 and 100 in per-block tables, larger K with one table
   or fewer rows than keys straight into the outputs, else after a
   partition by key range).  Integers, min/max and presence
   must match exactly; bf16 within rtol 1e-2 after its f32 accumulation; f32
   sums within rtol 1e-5 of the plain version run on the same values in
   float64 (at 60M rows in one key the plain version's own f32 atomic sum
   drifts by more than 1e-5, so it cannot be the yardstick there);
4. the query engine's main path at TPC-H scale factor ``--sf`` (spec
   v3.0.1, §4.2 cardinalities; data generated with numpy from ``--seed``
   after the §4.2.3 value distributions) through ``repro_torch.Session()``
   with its defaults: Q15's revenue view, Q13's inner count as SQL and as
   MapReduce (a plan-cache hit), Q13's count through its customer join, and
   Q2's inner minimum.  Each must choose agg_method='kernel', move the
   kernel's launch counters, and agree with a numpy float64 oracle (counts
   and minimums exactly, revenue within rtol 1e-4);
5. the kernel at the shapes the main path gave it: its regime, its time
   and each pass's, its bound, the plain version's time, one PyTorch
   library call's time (a scatter over the first column) and that of one
   scatter a table, presence included (the whole function);
6. the flash-attention kernel against its plain version
   (flash_attention_plain) on the card: f32 and bf16, head dim
   64/80/112/128/256 (80, hubert's, and 112, zamba2's, through the
   zero-padded route to 128; not at 8191), causal or not,
   GQA groups 1/2/12, causal or not, window 0/32/4096, softcap 0/50 and
   softcap 50 with q scaled by 32 (scores up to about 3x the cap),
   (Sq, Sk) in (1, 2112), (8, 128), (129, 129), (200, 1000), (1000, 1000),
   (2047, 2047), (8191, 8191) (129 crosses the bf16 kernel's 128-query
   tile; 200 over 1000 puts the causal offset inside one); held to
   ``ref.KERNEL_TOL`` (per element rtol 2e-3 for f32
   and 3e-2 for bf16 plus a small fraction of the output's rms, and a
   relative Frobenius limit), each case run twice and required to be
   bitwise equal; and the bf16 kernel's tile configuration as the library
   states it against ``kernel.TILES``;
7. the LM serving path at gemma2-9b's full published width (42 layers,
   d_model 3584, 9.24 B parameters drawn on the card from ``--seed``):
   ``serve.step.generate``, greedy, for (a) 8 requests of 2048 prompt tokens
   and 64 new ones, (b) one request of 8192 prompt tokens (twice the local
   window) and 16 new ones; each run twice with bitwise-equal tokens, 42
   flash launches per prefill, every flash call of (a)'s prefills and the
   first and last layers' calls of (b)'s held against the plain version at
   its shape (``ref.KERNEL_TOL``), finite logits, and
   for (b) the first decode step's logits against prefill_forward of the
   prompt plus that token, within rtol/atol 0.15 and within DECODE_REL of
   the largest logit; each scenario decoded once more eagerly, its greedy
   tokens bitwise equal to the CUDA graph's (the decode step is one graph,
   serve/step.py); then, for (a), the profiler's device time of one
   prefill and, for the eager and the graph decode step, device time by
   kernel against the step's wall time (the card's idle share), and the
   eager step's device time by PyTorch op;
8. the flash kernel at the serving path's shapes: its time, its bound, the
   plain version's time, and scaled_dot_product_attention's (which has no
   softcap and no window) beside the kernel's own time without them; the
   achieved TFLOP/s (the bound's FLOPs over the kernel's time), kernel over
   SDPA, the serving call over the call without softcap and window, and
   the ptxas report of the bf16 kernel at head dim 256;
9. the WKV6 kernel against its plain version (wkv6_plain) on the card: head
   size 16/64, S in {1, 16, 53, 100, 207, 208, 209, 256, 2048, 16385} (some
   at segment boundaries), (B, H) in {(2, 3), (8, 40), (1, 40)} ((1, 40)
   alone at 16385), r/k/v in
   bf16, log_w = -exp(N(0, 1)) or the constants -5, -54.6 (the clip's
   strongest decay) and -3.4e-4 (its weakest), S0 zero or random; y and the
   final state held to ``ref.KERNEL_TOL``, each case run twice and required
   to be bitwise equal; where the launch cuts the sequence into segments,
   the plain form of its passes (wkv6_segmented_plain) held against both;
   then what each instance of the chunked kernel takes (chunk length L,
   registers, shared bytes, blocks an SM, spills: the scan and the states
   pass) and each pass's device ms a launch at 8 x 2048 and 1 x 16385;
10. the LM serving path at rwkv6-3b's full published width (32 layers,
   d_model 2560, 40 heads of 64, 3.07 B parameters drawn on the card from
   ``--seed``, with the tensors the model initialises to zeros drawn too, so
   that log_w spans the clip range): as phase 7, for (a) 8 requests of 2048
   prompt tokens and 64 new ones and (b) one request of 16384 prompt tokens
   and 16 new ones, with 32 wkv6 launches per prefill and every wkv6 call
   of the prefills held against the plain version (y and the final state);
   (b)'s consistency prefill of 16385 tokens runs the ragged tail;
11. the WKV6 kernel at the serving path's shapes: its time, each pass's
   device ms a launch with its L, blocks an SM and registers, its bound and
   what bounds it, the plain version's time (no PyTorch call computes the
   recurrence, so there is no library time), and on the inputs of the
   serving call that read worst, the kernel's and the plain version's
   readings against the exact scan in f64;
12. the partitioned backend at phase 4's size: phase 4's five queries
   through ``Session(backend='partitioned')`` with worker-pool dispatch (one
   CUDA stream a worker) and chunk kernels captured in CUDA graphs, once
   with the planner's K and schedule and once with K = 8 under 'guided';
   every query against the oracle, counts and minimums also against phase
   4's rows, and the same plan run with serial dispatch bitwise equal on
   the kernel path; cold and warm wall, the synchronized ``plan.run``
   time of both dispatches, the card's idle share, captures/hits/overflows,
   per op its chunks, their time and the worker imbalance; then the
   segreduce launch of each chunk shape (the first chunk of each shape held
   against the plain version) with its regime, time, bound and one
   ``index_add_``/``scatter_reduce_``'s time;
13. the multi-tenant QueryServer: a table of lineitem's row count whose
   group key is Zipf-skewed (s = 1.1 over 100,000 keys, from ``--seed``);
   its GROUP BY through a feedback Session whose SplitPolicy splits
   partitions mid-run, against the serial unsplit run (bitwise); then 4
   tenants submitting phase 4's five queries and the Zipf query at once
   through one QueryServer (one SharedChunkPool, feedback on), each result
   against the oracle or the serial run; admissions, plan-cache hits,
   splits, re-plans and pool scale events;
14. the flash backward kernel (dq, dk, dv), given the forward kernel's
   output and row statistics, against its plain version
   (flash_attention_bwd_plain) in float64 given the forward's output,
   held to ``ref.BWD_TOL``, and against the exact gradient (autograd of
   attention_ref in f32) within ``ref.BWD_EXACT_REL``, on the same bf16
   inputs: head dim 16/32/64/80/112/128/256 (16 padded to 32, 80 and 112
   to 128; 256 with its own tiles), GQA
   groups 1/12, causal or not, window 0/100, softcap 0/50, S in {128, 200,
   1000, 2048} (200 and 1000 ragged against its tiles), each case run
   twice and required to be bitwise equal;
   then the kernel at each FLASH_BWD_SHAPES training microbatch:
   starcoder2-3b's (2 x 2048 tokens, 24 heads over 2 kv heads of 128,
   causal), hubert-xlarge's (2 x 4096, 16 heads of 80, not causal),
   zamba2-7b's shared block's (2 x 2048, 32 heads of 112, causal) and
   gemma3-4b's (2 x 2048, 8 heads over 4 of 256, causal, with its local
   window of 1024 and without): its time and each launch's (dq, dkv, the
   sum of the heads' partials), its bound (the gradient's five products, 10
   D FLOPs a pair), the plain version's time,
   scaled_dot_product_attention's backward (given the window's mask where
   there is one), and at starcoder2-3b's the forward's time with and
   without its statistics;
15. training starcoder2-3b at its published width and depth (30 layers,
   d_model 3072, vocab 49152, 3.03 B parameters drawn on the card from
   ``--seed``) through launch/train.py's model and train_step: data from
   the port's pipeline over Zipf documents from ``--seed`` packed at 2048,
   global batch 8 in 4 microbatches, remat on, the JAX package's
   launch/train.py AdamWConfig with f32 state; 6 steps, each launching the flash backward
   once per layer and microbatch and the plain backward never; the loss
   finite and falling; per step (under the profiler) its ms, tokens/s,
   model-FLOP share of the bf16 peak, peak memory, the card's idle share,
   the flash kernels' share of device time and the backward's launches';
16. the training CLI on the card: ``python -m repro_torch.launch.train
   --reduced --steps 40 --ckpt-every 10 --fail-at 25`` in a temporary
   directory, for starcoder2-3b and for rwkv6-3b, resumes from step 20,
   ends at 40 and restores its final checkpoint bitwise equal to the state
   in memory;
17. the WKV6 backward kernel (dr, dk, dv, dlog_w, du, dS0) against its
   plain version (wkv6_bwd_plain) in float64, held to ``ref.BWD_TOL`` with
   each element's terms' magnitudes, and against torch autograd of
   wkv6_scan in float64 within each output's ``BWD_TOL["rel"]`` up to S =
   208, on bf16 r, k, v and u: head size 16/64, S in {1, 16, 53, 208,
   2048, 16385}, (B, H) in {(2, 3), (2, 40), (1, 40)}, log_w = -exp(N(0,
   1)), -5, -54.6 and -3.4e-4, S0 and dS_out zero or random
   (all (B, H) at each S but 16385, which runs (1, 40) at head size 64
   only, random and -54.6 decays; ``wkv6_bwd_cases``), each case run twice and
   required to be bitwise equal; then the kernel at rwkv6-3b's training
   microbatch (2 x 2048, 40 heads of 64): its time and each launch's (the
   states pass, the carries, the chunk pass, du's sum), its bound, what
   each pass takes on the card, the plain version's time and the
   forward's (no PyTorch call computes this gradient);
18. training rwkv6-3b at its published width and depth (32 layers,
   d_model 2560, 40 heads of 64, vocab 65536, 3.07 B parameters drawn on
   the card from ``--seed``, its zero-initialised tensors drawn too) as
   phase 15 trains starcoder2-3b: every wkv6 call through the autograd
   Function, the backward kernel once per layer and microbatch (128 a
   step), the plain backward never, every leaf of every layer a finite,
   nonzero gradient each step, one real layer's backward call a step
   within ``ref.BWD_TOL`` of the plain backward in float64; per step its
   ms, tokens/s, model-FLOP share (6 per parameter and token and the WKV's
   12 K^2 a token, head and layer), peak memory, idle share and the
   backward's share of device time;
19. the MoE models at their published widths (experts, top-k, capacity
   factor 1.25 and vocabulary as published; random weights drawn on the
   card from ``--seed``) over the most whole periods of layers whose
   weights fit MOE_WEIGHT_GIB (``moe_depth``, from the port's parameter
   definitions; printed): dbrx-132b for (a) 8 requests of 2048 prompt
   tokens and 64 new ones, llama4-scout-17b-a16e for (a) and (b) one
   request of 16384 tokens (twice its chunk: its chunked layers fold the
   chunks into the batch) and 16 new ones, as phase 7 runs them: reruns
   and the eager decode bitwise equal to the CUDA graph's, one flash
   launch per layer and prefill, every flash call held against the plain
   version, finite logits; the first decode step against prefill_forward
   of prompt plus token on (a)'s first request at a capacity factor of E /
   K, where C = T (at 1.25 a prefill drops choices by design and a decode
   step never does; the count dropped at 1.25 is printed beside it; at
   (b) the reference's chunked decode reads its ring of the last 8192
   positions, where its prefill attends within the chunk, so the two
   differ by design); TF32 off for the router's f32 product; per scenario
   the busiest expert's load over the mean and the share of choices
   dropped, and one prefill's device time split into the flash kernel,
   the expert products, dispatch/combine, the router and the rest;
20. training dbrx-132b at its published width over one layer (its
   pattern's whole period; the port's training state at 14 bytes a
   parameter with int8 AdamW moments: ``TRAIN_CASES["moe"]``) as phase
   15 trains starcoder2-3b: the loss finite and falling at a peak rate
   of 1e-4 (at the launcher's 3e-3 the routing collapses and the loss
   reaches nan), lb_loss and router_z finite and in the loss
   each step, the flash backward once per layer and microbatch and the
   plain backward never, every leaf and each expert's slice of every
   expert stack and router a finite nonzero gradient each step; its ms,
   tokens/s, model-FLOP share over the active parameters (top-4 of 16
   experts), peak memory and idle share;
21. the serving path at zamba2-7b's full published width and depth (81
   Mamba2 layers, d_model 3584, 112 SSM heads of 64, d_state 64; two shared
   attention blocks of 32 heads of 112 invoked after every 6th layer; 7.01
   B parameters drawn on the card from ``--seed``, with a_log, dt_bias,
   conv_b and norm drawn as Mamba2 publishes them): as phase 7, for (a) 8
   requests of 2048 prompt tokens and 64 new ones and (b) one request of
   16384 prompt tokens and 16 new ones, with 13 flash launches per prefill
   (one a shared invocation), every flash call held against the plain
   version at head dim 112, reruns and the eager decode bitwise equal to
   the graph's, finite logits, and (b)'s first decode step against a
   prefill of 16385 tokens; TF32 off for the SSD's f32 products; (a)'s
   prefill's device time split into flash, the SSD, the conv, the Mamba2
   in/out projections, the shared blocks' MLP and the rest; then phase 8's
   reading of the flash kernel at zamba2's shapes (SDPA computes the same
   function there: causal, no softcap, no window);
22. the audio encoder hubert-xlarge at its published width and depth (48
   layers, d_model 1280, 16 heads of 80, d_ff 5120 with the exact gelu, 504
   units; 0.946 B parameters drawn on the card from ``--seed``) through
   ``Model.forward`` under inference mode, as the reference's dry run takes
   an audio prefill, on frames drawn from the seed: (a) 16 utterances of
   1,500 frames (30 s at 50 frames a second), (b) one of 32,768 (the
   reference's prefill_32k); 48 flash launches a forward, not causal,
   every call of (a) and the first and last layers' calls of (b) held
   against the plain version, a rerun's logits bitwise equal and finite;
   the forward's ms and frames/s, its device ms by part (flash, the MLP,
   the projections, the rest), and phase 8's reading of the flash kernel
   at both shapes (SDPA not causal computes the same function);
23. training hubert-xlarge at its published width and depth as phase 15
   trains starcoder2-3b, on 4,096-frame utterances (the reference's
   train_4k), global batch 8 in 4 microbatches, f32 AdamW state at a peak
   rate of 3e-4, 6 steps; its data HuBERT's masked unit prediction
   (arXiv:2106.07447 §IV): frames drawn from the seed, labels the nearest
   of 500 fixed centroids drawn from it, the loss on spans of 10 frames
   masked from starts drawn at p = 0.08 (``hubert_batches``); the flash
   backward at head dim 80 once per layer and microbatch, the plain
   backward never, every leaf a finite nonzero gradient, the loss falling;
24. training gemma3-4b at its published width (2560 wide, 8 heads over 4
   of 256, QK-norm, 5:1 local:global with window 1024, vocabulary 262,144)
   as phase 20 trains dbrx (int8 AdamW moments, 2 x 2048 microbatches, 6
   steps, the launcher's rate of 3e-3) over every layer when the reckoned
   peak (``train_gib``: 14 bytes a parameter and the loss's logits) fits
   72 GiB, else over the whole periods that do (the depth is printed): the
   flash backward at head dim 256 once per layer and microbatch, its checks
   those of phase 15;
25. training zamba2-7b at its published width (d_model 3584, 112 SSM heads
   of 64, two shared blocks of 32 heads of 112) as phase 24 trains gemma3-4b
   (int8 AdamW moments, 6 steps of 8 x 2048 in 4 microbatches) over the
   whole scan steps (6 Mamba2 layers and one shared invocation, the two
   shared blocks alternating) whose reckoned peak fits 72 GiB
   (``train_gib`` and a recomputed step's Mamba2 activations,
   ``TRAIN_CASES["zamba2"]``; the depth is printed), a_log, dt_bias,
   conv_b and norm drawn as phase 21 draws them: the flash backward at
   head dim 112 once a shared invocation and microbatch, the plain
   backward never, one call at the first and last steps within
   ``ref.BWD_TOL`` of the plain backward in float64 (SDPA's backward on
   its inputs printed beside it), every leaf (each layer's and each shared
   block's slice) a finite nonzero gradient, the loss falling;
26. the serving path at qwen2-vl-72b's published width (d_model 8192, 64
   heads over 8 kv heads of 128, vocabulary 152,064) over the layers whose
   weights fit MOE_WEIGHT_GIB (``moe_depth``; printed), each prompt led by
   a 16 x 16 grid of patch embeddings drawn from ``--seed`` (the stub
   frontend's ``patch_embeds`` and ``patch_mask``) with 3-axis M-RoPE
   positions: (a) 8 requests of 2048 prompt tokens and 64 new ones, run
   twice with bitwise-equal tokens and once eagerly (equal to the graph's),
   one flash launch a layer and prefill, every flash call held against the
   plain version, every step's logits finite; then the one-card mesh: a
   (1, 1) DeviceMesh over ("data", "model") on a one-process NCCL group
   (``launch/mesh.make_smoke_mesh``), the specs the JAX package's dry run
   installs for a prefill cell (``sharding.prefill_specs``: the hidden
   layout, and the MoE pins) installed, and a reduced dbrx-132b's and
   zamba2-7b's forward and prefill bitwise equal to those without them;
27. the serving path at starcoder2-15b's published width and depth (40
   layers, d_model 6144, 48 heads over 4 kv heads of 128; 15.96 B
   parameters, ~32 GB in bf16) with phase 26's checks;
28. the dry run's reckoning (``launch/dryrun.run_cell`` on the meta
   device, H100 SXM5 constants) against the card: on the (1, 1) stand-in at
   each phase's own shape, phase 15's starcoder2-3b train step (8 x 2048 in
   4 microbatches, remat) and gemma2-9b's and rwkv6-3b's prefill at (a)
   (run once more here, after a warm-up, with the weights the model
   declares): each kernel's calls equal to the card's launches for that
   step or prefill, the reckoned peak_device_bytes within 10% of
   max_memory_allocated over it, the reckoned bound max(compute, memory)
   no greater than its device time; then one production cell of each
   kind on both meshes (starcoder2-15b train_4k, gemma2-9b prefill_32k,
   zamba2-7b decode_32k, rwkv6-3b long_500k) with its trace time and
   terms; the records go to the ``reckoning`` folder beside ``--out``;
29. the port's examples and tools, in process through each file's
   ``main(argv)``: examples/torch_quickstart.py (SQL, MapReduce as a
   plan-cache hit, the raw plan and the ReferenceInterpreter agree; each
   query's agg_method and segreduce launches printed);
   examples/torch_bigdata_sql.py at 2,000,000 rows (the size the JAX
   package's example names), its 9 queries and 2 MapReduce jobs each held
   against a numpy oracle (``weblog_oracle``: integers exactly, float sums
   within rtol 1e-4), the repeated url query and the url MapReduce job
   plan-cache hits, the scheduler's coverage; examples/torch_serve_lm.py
   --full (gemma2-9b at published width, 4 x 2048 + 32) run twice: 42 flash
   launches a prefill, the first run's prefills' first and last layers'
   calls held against the plain version, the second run unchecked (its
   times are the ones reported), greedy tokens bitwise equal, finite
   logits, the int8 cache's bytes and error printed;
   examples/torch_train_lm.py --full (75.9M parameters, head dim 64) over
   75 steps with a failure at 60 in a temporary directory: the first
   step's first and last layers' flash calls held against the plain
   version, and one backward call of the first and of the last step
   against the plain backward in float64, one restore from step 50, the
   end at 75, a finite falling loss, the flash backward once a layer and
   step and the plain backward never, the final checkpoint restored
   bitwise; then
   scripts/torch_irlint.py --demo's exit code, scripts/torch_trace_summary.py
   over a trace the quickstart's session saved under ``Session.profile()``,
   and scripts/torch_probe.py starcoder2-3b train_4k.

Phases 12 and 13 count their own segreduce launches (a CUDA graph's replay
counts the launches it captured); the kernels' line adds them to phase 4's,
and phase 18's wkv6 forward launches to phase 10's; phases 19-24's flash
launches join phases 7 and 15's, phases 20 and 23-25's backward phase
15's, and phase 29's segreduce, flash and flash backward launches join
them too; the flash entries list each head dim with its launches, its
costliest shape's time, bound, plain and library times.

What is cut from TPC-H: Q15 keeps only its revenue view (no outer max or
supplier join); Q13 keeps its inner aggregate (no outer join's zero-count
customers, no comment filter); Q2 keeps only its inner MIN (no region
joins); dbgen is replaced by numpy.  Nothing of gemma2-9b, rwkv6-3b,
starcoder2-3b, starcoder2-15b or hubert-xlarge is cut, nor zamba2-7b's
serving; their weights are random, and hubert's frames are drawn, its conv
waveform frontend a stub as in the reference, as are qwen2-vl's patch
embeddings.

What is cut to keep the script inside its time with phases 22-24 added:
phase 6 runs f32 only up to 2047 (bf16, the serving type, at 8191 too);
phases 7, 10, 19 and 21 hold every kernel call of (a)'s prefills but only
the first and last layers' calls of (b)'s (and of its consistency prefill)
against the plain version, and read where the card time goes for (a)
only; phase 9 runs the 16385-token prompt at head size 64 only (rwkv6-3b's);
phase 12 runs K = 8 'guided' over Q15 and Q13 SQL only; phase 17 runs S =
2048 at (B, H) = (2, 40) only; phases 23-25 hold one backward call
against the plain backward in float64 at their first and last steps;
phases 26 and 27 serve scenario (a) only, and do not read where the card
time goes (no profile).  dbrx-132b (132 B
parameters), llama4-scout (109 B) and qwen2-vl-72b (72.7 B) do not fit one
card: phases 19, 20 and 26 cut their depth only, to the layers printed;
zamba2-7b's training state (14 bytes a parameter, 98 GB) does not either:
phase 25 trains the whole scan steps printed.  Phase 29 holds the web-log
results against numpy, not against the ReferenceInterpreter, which walks
rows in Python (seconds a query at 2,000,000 rows; tests/test_torch_examples.py
holds ``weblog_oracle`` against it on the CPU), and holds only the first and
last layers' flash calls of the first serving run's prefills and of the
training run's first step, and two of its 1,020 backward calls.

The last lines are the kernels' JSON record and {"ok": true, "device": ...}.
The script exits non-zero, printing neither, without a CUDA device or
outside a checkout of the repository.  Details go to ``--out``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

if os.path.isdir(os.path.join(SRC, "repro_torch")):
    sys.path.insert(0, SRC)
try:  # the H100 SXM's device memory rate and bf16 dense tensor-core peak, kept with the roofline's
    from repro_torch.roofline.analysis import HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS as BF16_OPS_PER_S
except ImportError:  # outside a checkout: main() says so and exits
    HBM_BYTES_PER_S = BF16_OPS_PER_S = None
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM tf32 tensor cores, dense
DECODE_TOL = 0.15           # the JAX package's decode-consistency tolerance
PHASE_BUDGET_S = 1050       # the phases' aim, inside the 1,200 s limit with the machine's own start
# the first decode step's largest logit error over its largest |logit|, as
# read on sound runs: 0.0122 / 0.539 = 0.023 (gemma2-9b, scenario (b), seed 0,
# NVIDIA H100 80GB HBM3 at 700 W)
DECODE_REL = 0.05
FLASH_SHAPES = ((1, 2112), (8, 128), (129, 129), (200, 1000), (1000, 1000), (2047, 2047), (8191, 8191))  # (Sq, Sk)
# (softcap, q multiplier): with q x 32 the scaled scores are N(0, 32^2), up to
# about 3x the cap of 50 over a row, where tanh bends and the kernel's
# approximate tanh differs most from the plain version's
FLASH_CAPS = ((0.0, 1), (50.0, 1), (50.0, 32))
# phase 6's head dims: the kernel's own, and hubert's 80 and zamba2's 112
# (zero-padded to 128) at every shape but the longest (the plain version
# takes ~27 s a dtype there; phases 21 and 22 hold every 112 call at 16384
# and the first and last 80 calls at 32768 against it)
FLASH_HEAD_DIMS = (64, 80, 112, 128, 256)
FLASH_LONG_HEAD_DIMS = (64, 128, 256)
SERVE_ARCH = "gemma2-9b"
SERVE_SCENARIOS = {"a": (8, 2048, 64), "b": (1, 8192, 16)}  # batch, prompt, new tokens
RWKV_ARCH = "rwkv6-3b"
RWKV_SCENARIOS = {"a": (8, 2048, 64), "b": (1, 16384, 16)}
# phase 19: llama4's (b) is twice its chunk of 8192, so its chunked layers
# fold the chunks into the batch and decode through their ring caches
MOE_SCENARIOS = {"dbrx-132b": {"a": (8, 2048, 64)},
                 "llama4-scout-17b-a16e": {"a": (8, 2048, 64), "b": (1, 16384, 16)}}
# the MoE models' serving weights on the 80 GB card; the rest holds a
# prefill's expert buffers and activations (8 x 2048 tokens, dbrx: the
# (16, 5120, 10752) bf16 products, 1.76 GB each)
MOE_WEIGHT_GIB = 56.0
# phase 21: zamba2 is subquadratic, so (b) is twice gemma2's prompt
ZAMBA2_ARCH = "zamba2-7b"
ZAMBA2_SCENARIOS = {"a": (8, 2048, 64), "b": (1, 16384, 16)}
# phases 26 and 27: qwen2-vl-72b at published width over the layers whose
# weights fit MOE_WEIGHT_GIB (``moe_depth``), its prompts led by a
# VLM_GRID x VLM_GRID grid of patch embeddings; starcoder2-15b whole
VLM_ARCH = "qwen2-vl-72b"
VLM_SCENARIOS = {"a": (8, 2048, 64)}
VLM_GRID = 16
CODE_ARCH = "starcoder2-15b"
CODE_SCENARIOS = {"a": (8, 2048, 64)}
# phase 26's mesh check: reduced models forward with and without the specs
MESH_ARCHS = ("dbrx-132b", "zamba2-7b")
WKV6_HEAD_SIZES = (16, 64)
# 53 = 3 L + 5 and 207-209 = 13 L - 1, 13 L, 13 L + 1 for segments of
# L = 16 tokens (the shortest the sequence-parallel form cuts: one long
# prompt of 40 heads is cut in 13 segments, a few heads in more)
WKV6_LENGTHS = (1, 16, 53, 100, 207, 208, 209, 256, 2048, 16385)
WKV6_BATCH_HEADS = ((2, 3), (8, 40), (1, 40))
WKV6_LONG = 16385  # one long prompt: only (B, H) = (1, 40), rwkv6-3b's (b)
# log_w: -exp(N(0, 1)), strong, the clip's strongest (-e^4), its weakest (-e^-8)
WKV6_DECAYS = {"random": None, "-5": -5.0, "-54.6": -54.6, "-3.4e-4": -3.4e-4}

# TPC-H dates as int32 day numbers since 1970-01-01
START_DATE = int(np.datetime64("1992-01-01", "D").astype(np.int64))
END_DATE = int(np.datetime64("1998-12-31", "D").astype(np.int64))
Q15_LO = int(np.datetime64("1996-01-01", "D").astype(np.int64))
Q15_HI = int(np.datetime64("1996-04-01", "D").astype(np.int64))


class Failures:
    def __init__(self) -> None:
        self.items: list = []

    def check(self, ok: bool, what: str) -> bool:
        if not ok:
            self.items.append(what)
            print(f"FAIL {what}", flush=True)
        return ok


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def retail_price(partkey: np.ndarray) -> np.ndarray:
    """P_RETAILPRICE (§4.2.3), in dollars."""
    pk = partkey.astype(np.int64)
    return (90000 + (pk // 10) % 20001 + 100 * (pk % 1000)) / 100.0


def tpch_tables(sf: float, seed: int) -> dict:
    """The columns the smoke queries read, at scale factor ``sf``."""
    rng = np.random.default_rng(seed)
    n_orders, n_cust = int(1_500_000 * sf), int(150_000 * sf)
    n_part, n_supp = int(200_000 * sf), int(10_000 * sf)
    # O_ORDERKEY is sparse: of every 32 keys only the first 8 are used
    i = np.arange(n_orders, dtype=np.int64)
    o_orderkey = ((i // 8) * 32 + i % 8 + 1).astype(np.int32)
    # O_CUSTKEY uniform over customers, never a multiple of 3
    cust = rng.integers(1, n_cust + 1, n_orders)
    o_custkey = np.where(cust % 3 == 0, cust - 1, cust).astype(np.int32)
    o_orderdate = rng.integers(START_DATE, END_DATE - 151 + 1, n_orders)
    # 1..7 lineitems per order
    per_order = rng.integers(1, 8, n_orders)
    n_li = int(per_order.sum())
    l_partkey = rng.integers(1, n_part + 1, n_li)
    corner = rng.integers(0, 4, n_li)
    l_suppkey = ((l_partkey + corner * (n_supp // 4 + (l_partkey - 1) // n_supp)) % n_supp + 1)
    l_quantity = rng.integers(1, 51, n_li)
    l_extendedprice = (l_quantity * retail_price(l_partkey)).astype(np.float32)
    l_discount = (rng.integers(0, 11, n_li) / 100.0).astype(np.float32)
    l_shipdate = (np.repeat(o_orderdate, per_order) + rng.integers(1, 122, n_li)).astype(np.int32)
    ps_partkey = np.repeat(np.arange(1, n_part + 1, dtype=np.int32), 4)
    ps_supplycost = (rng.integers(100, 100_001, 4 * n_part) / 100.0).astype(np.float32)
    return {
        "lineitem": dict(
            l_suppkey=l_suppkey.astype(np.int32), l_extendedprice=l_extendedprice,
            l_discount=l_discount, l_shipdate=l_shipdate,
        ),
        "orders": dict(o_orderkey=o_orderkey, o_custkey=o_custkey),
        "customer": dict(c_custkey=np.arange(1, n_cust + 1, dtype=np.int32)),
        "partsupp": dict(ps_partkey=ps_partkey, ps_supplycost=ps_supplycost),
    }


Q15 = (
    "SELECT l_suppkey, SUM(l_extendedprice * (1 - l_discount)) FROM lineitem "
    "WHERE l_shipdate >= :lo AND l_shipdate < :hi GROUP BY l_suppkey"
)
Q13 = "SELECT o_custkey, COUNT(o_orderkey) FROM orders GROUP BY o_custkey"
Q13_JOIN = (
    "SELECT c.c_custkey, COUNT(o.o_orderkey) FROM customer c, orders o "
    "WHERE c.c_custkey = o.o_custkey GROUP BY c.c_custkey"
)
Q2 = "SELECT ps_partkey, MIN(ps_supplycost) FROM partsupp GROUP BY ps_partkey"


def oracle(tables: dict) -> dict:
    """The three answers in numpy float64, independent of the engine."""
    li = tables["lineitem"]
    m = (li["l_shipdate"] >= Q15_LO) & (li["l_shipdate"] < Q15_HI)
    rev = li["l_extendedprice"].astype(np.float64) * (1.0 - li["l_discount"].astype(np.float64))
    sup = li["l_suppkey"][m]
    rev_sum = np.bincount(sup, weights=rev[m])
    rev_keys = np.nonzero(np.bincount(sup))[0]
    counts = np.bincount(tables["orders"]["o_custkey"])
    cnt_keys = np.nonzero(counts)[0]
    ps = tables["partsupp"]
    order = np.lexsort((ps["ps_supplycost"], ps["ps_partkey"]))
    pk, cost = ps["ps_partkey"][order], ps["ps_supplycost"][order]
    first = np.r_[True, pk[1:] != pk[:-1]]
    return {
        "q15": (rev_keys, rev_sum[rev_keys]),
        "q13": (cnt_keys, counts[cnt_keys]),
        "q2": (pk[first].astype(np.int64), cost[first]),
    }


def rows_match(rows, keys, vals, rtol: float) -> bool:
    if rows is None or len(rows) != len(keys):
        return False
    got = sorted(rows)
    gk = np.array([r[0] for r in got], np.int64)
    gv = np.array([r[1] for r in got], np.float64)
    if not np.array_equal(gk, keys):
        return False
    if rtol == 0:
        return bool(np.array_equal(gv, np.asarray(vals, np.float64)))
    return bool(np.allclose(gv, vals, rtol=rtol, atol=0))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def device_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n: int, num_keys: int, value_bytes: int, n_tables: int, masked: bool) -> tuple:
    """(bound_ms, bound_by): every input byte read once and every output
    byte written once over the memory rate, against one op per row and
    table over the f32 rate."""
    nbytes = n * (4 + (1 if masked else 0) + value_bytes) + num_keys * n_tables * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * n_tables / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------


def bitwise_equal(torch, a, b) -> bool:
    if a.dtype in (torch.bfloat16, torch.float16):
        a, b = a.view(torch.int16), b.view(torch.int16)
    elif a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def kernel_matrix(torch, ops, ref, fails: Failures, big_n: int, seed: int) -> list:
    from repro_torch.kernels.segreduce import kernel as kern

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    results = []
    for n in (0, 1, 5000, big_n):
        for num_keys in (1, 100, 100_001, 2_000_001):
            t0 = time.perf_counter()
            keys = torch.randint(0, num_keys, (n,), device=dev, dtype=torch.int32, generator=gen)
            mask = torch.rand(n, device=dev, generator=gen) < 0.6
            cols = {
                "int32": torch.randint(-1000, 1000, (n,), device=dev, dtype=torch.int32, generator=gen),
                "float32": torch.rand(n, device=dev, generator=gen),
                "bfloat16": torch.randn(n, device=dev, generator=gen).to(torch.bfloat16),
            }
            bad = 0
            for dname, vals in cols.items():
                for op in ("sum", "max", "min"):
                    for m in (None, mask):
                        what = f"N={n} K={num_keys} {op} {dname} masked={m is not None}"
                        (a1,), p1 = ops.fused_segreduce(keys, (vals,), (op,), num_keys, mask=m)
                        (a2,), p2 = ops.fused_segreduce(keys, (vals,), (op,), num_keys, mask=m)
                        plain_vals = vals.double() if (dname == "float32" and op == "sum") else vals
                        (want,), want_p = ref.fused_segreduce_ref(keys, (plain_vals,), (op,), num_keys, mask=m)
                        singles = []
                        if m is None:
                            singles = [ops.segreduce(keys, vals, num_keys, op) for _ in range(2)]
                        torch.cuda.synchronize()
                        ok = bitwise_equal(torch, a1, a2) and torch.equal(p1, p2)
                        ok = ok and torch.equal(p1, want_p) and close(torch, a1, want, dname, op)
                        if singles:
                            ok = ok and bitwise_equal(torch, *singles)
                            ok = ok and close(torch, singles[0], want, dname, op)
                        bad += not fails.check(ok, what)
            # whole groups in one launch: every column at once (a float sum
            # among them), and the columns without a float sum
            groups = {
                "all": [(d, op) for d in cols for op in ("sum", "max", "min")],
                "no-float-sum": [(d, op) for d in cols for op in ("sum", "max", "min")
                                 if op != "sum" or d == "int32"],
            }
            for gname, members in groups.items():
                for m in (None, mask):
                    vals = tuple(cols[d] for d, _ in members)
                    gops = tuple(op for _, op in members)
                    a1, p1 = ops.fused_segreduce(keys, vals, gops, num_keys, mask=m)
                    a2, p2 = ops.fused_segreduce(keys, vals, gops, num_keys, mask=m)
                    plain = tuple(
                        v.double() if (d == "float32" and op == "sum") else v
                        for v, (d, op) in zip(vals, members)
                    )
                    want, want_p = ref.fused_segreduce_ref(keys, plain, gops, num_keys, mask=m)
                    torch.cuda.synchronize()
                    ok = torch.equal(p1, p2) and torch.equal(p1, want_p)
                    for x, y, w, (d, op) in zip(a1, a2, want, members):
                        ok = ok and bitwise_equal(torch, x, y) and close(torch, x, w, d, op)
                    what = f"N={n} K={num_keys} group {gname} masked={m is not None}"
                    bad += not fails.check(ok, what)
            n_cases = 18 + 2 * len(groups)
            dt = time.perf_counter() - t0
            # the regime each kind of launch took: a float sum with presence,
            # one int32 sum alone (segreduce), and the group without a float sum
            no_fs = groups["no-float-sum"]
            paths = {
                "float sum": kernel_regime(torch, kern, keys, (cols["float32"],), ("sum",), num_keys, True),
                "int32 sum alone": kernel_regime(torch, kern, keys, (cols["int32"],), ("sum",), num_keys, False),
                "no-float-sum group": kernel_regime(torch, kern, keys, tuple(cols[d] for d, _ in no_fs),
                                                    tuple(op for _, op in no_fs), num_keys, True),
            }
            results.append({"n": n, "num_keys": num_keys, "cases": n_cases, "failed": bad, "seconds": dt,
                            "regimes": paths})
            print(f"  kernel N={n:>9} K={num_keys:>8}: {n_cases - bad}/{n_cases} cases agree ({dt:.1f} s); "
                  "regimes " + ", ".join(f"{k} {v}" for k, v in paths.items()), flush=True)
            del keys, mask, cols
    return results


def close(torch, got, want, dname: str, op: str) -> bool:
    if dname == "int32" or op != "sum":
        if dname == "bfloat16":
            return bool(torch.equal(got.float(), want.float()))
        return bool(torch.equal(got, want))
    rtol = 1e-2 if dname == "bfloat16" else 1e-5
    return bool(torch.allclose(got.double(), want.double(), rtol=rtol, atol=rtol))


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


class Recorder:
    """Keeps the arguments of the wrapper calls the main path makes.  With
    ``first_only`` it keeps copies of the first call of each label and shape
    (a chunk kernel's inputs are buffers that later chunks overwrite), and
    skips the calls a CUDA graph capture makes, which launch nothing."""

    def __init__(self, ops, name: str, first_only: bool = False) -> None:
        self.ops, self.name = ops, name
        self.orig = getattr(ops, name)
        self.calls: list = []
        self.label = ""
        self.first_only = first_only
        self._seen: set = set()

    def __enter__(self):
        import torch

        def copy(x):
            if isinstance(x, torch.Tensor):
                return x.clone()
            if isinstance(x, (tuple, list)):
                return type(x)(copy(y) for y in x)
            return x

        def record(*args, **kw):
            if not self.first_only:
                self.calls.append((self.label, args, kw))
            elif not torch.cuda.is_current_stream_capturing():
                key = (self.label, shape_key(self.name, args, kw))
                if key not in self._seen:
                    self._seen.add(key)
                    self.calls.append((self.label, copy(args), {k: copy(v) for k, v in kw.items()}))
            return self.orig(*args, **kw)

        setattr(self.ops, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.orig)
        return False


def run_query(session, label: str, submit, recorders) -> dict:
    for r in recorders:
        r.label = label
    times = {}
    result = None
    for kind in ("cold", "warm"):
        with session.profile() as qt:
            t0 = time.perf_counter()
            result = submit()
            wall = (time.perf_counter() - t0) * 1e3
        stages = {name: st["total_ms"] for name, st in qt.stage_times().items()}
        compute = stages.get("torch.compute", 0.0)
        times[kind] = {
            "wall_ms": wall,
            "device_ms": compute,
            "host_ms": wall - compute,
            # before the query span opens, the Session re-hashes every table
            # (revalidate='content') to detect changed data
            "revalidate_ms": wall - stages.get("query", 0.0),
            "upload_ms": stages.get("torch.upload", 0.0),
            "densify_ms": stages.get("densify", 0.0),
            "stages_ms": stages,
            "cache_hit": result.cache_hit,
        }
    return {"result": result, "times": times}


def smoke_queries(repro_torch) -> list:
    """(label, submit(session), oracle answer, rtol) of the main path's five
    queries."""
    return [
        ("q15", lambda s: s.sql(Q15, params={"lo": Q15_LO, "hi": Q15_HI}), "q15", 1e-4),
        ("q13_sql", lambda s: s.sql(Q13), "q13", 0),
        ("q13_mapreduce", lambda s: s.mapreduce(repro_torch.MapReduceSpec.count("orders", "o_custkey")),
         "q13", 0),
        ("q13_join", lambda s: s.sql(Q13_JOIN), "q13", 0),
        ("q2", lambda s: s.sql(Q2), "q2", 0),
    ]


def main_path(torch, repro_torch, ops, tables: dict, want: dict, fails: Failures, rows_out: dict) -> tuple:
    session = repro_torch.Session()
    for name, cols in tables.items():
        session.register(name, **cols)
    recorders = [Recorder(ops, "fused_segreduce"), Recorder(ops, "segreduce")]
    queries = [(label, (lambda f=f: f(session)), answer, rtol)
               for label, f, answer, rtol in smoke_queries(repro_torch)]
    report = {}
    ops.reset_launches()
    with recorders[0], recorders[1]:
        for label, submit, answer, rtol in queries:
            before = dict(ops.LAUNCHES)
            out = run_query(session, label, submit, recorders)
            res = out["result"]
            launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
            chosen = res.decision.chosen
            fails.check(chosen.agg_method == "kernel", f"{label}: agg_method={chosen.agg_method}")
            fails.check(sum(launched.values()) > 0, f"{label}: no kernel launch")
            keys, vals = want[answer]
            fails.check(rows_match(res.rows, keys, vals, rtol), f"{label}: rows disagree with the oracle")
            rows_out[label] = sorted(res.rows or [])
            if label == "q13_mapreduce":
                fails.check(out["times"]["cold"]["cache_hit"], "q13_mapreduce: not a plan-cache hit")
            report[label] = {
                "agg_method": chosen.agg_method,
                "join_method": chosen.join_method,
                "launches": launched,
                "rows": len(res.rows or []),
                **out["times"],
            }
            c, w = out["times"]["cold"], out["times"]["warm"]
            print(
                f"  {label:<14} kernel launches {launched}  cold {c['wall_ms']:.1f} ms "
                f"(device {c['device_ms']:.1f}, host {c['host_ms']:.1f})  warm {w['wall_ms']:.1f} ms "
                f"(device {w['device_ms']:.1f}, host {w['host_ms']:.1f}: revalidate {w['revalidate_ms']:.1f}, "
                f"densify {w['densify_ms']:.1f})",
                flush=True,
            )
    launches = dict(ops.LAUNCHES)
    for name, count in launches.items():
        fails.check(count > 0, f"main path never launched {name}")
    return report, launches, recorders


# ---------------------------------------------------------------------------
# phase 5: the kernel at the main path's shapes
# ---------------------------------------------------------------------------


def shape_key(name: str, args, kw) -> tuple:
    """(N, K[, columns, masked]) of one captured wrapper call."""
    if name == "fused_segreduce":
        return (int(args[0].shape[0]), args[3], len(args[1]), kw.get("mask") is not None)
    return (int(args[0].shape[0]), args[2])


def kernel_regime(torch, kern, keys, values, op_names, num_keys: int, with_presence: bool) -> str:
    """The regime (``kernel.table_layout``) a launch on these inputs takes,
    '1s' for regime 1's one-launch path."""
    index = keys.device.index if keys.device.index is not None else torch.cuda.current_device()
    float_sum = any(op == "sum" and v.dtype.is_floating_point for v, op in zip(values, op_names))
    lay = kern.table_layout(int(keys.shape[0]), num_keys, len(values) + int(with_presence),
                            kern.library().segreduce_smem_limit(index),
                            torch.cuda.get_device_properties(index).multi_processor_count, float_sum)
    return f"{lay.regime}{'s' if lay.small else ''}"


def time_call(torch, ops, ref, name: str, args, kw) -> dict:
    """Kernel, plain version and library calls on one captured input."""
    from repro_torch.kernels.segreduce import kernel as kern

    if name == "fused_segreduce":
        keys, values, op_names, num_keys = args
        mask = kw.get("mask")
        with_presence = kw.get("with_presence", True)

        def kernel():
            return ops.fused_segreduce(keys, values, op_names, num_keys, mask=mask, with_presence=with_presence)

        def plain():
            return ref.fused_segreduce_ref(keys, values, op_names, num_keys, mask=mask, with_presence=with_presence)
    else:
        keys, v, num_keys = args[:3]
        op = kw.get("op", args[3] if len(args) > 3 else "sum")
        values, op_names, mask, with_presence = (v,), (op,), None, False

        def kernel():
            return ops.segreduce(keys, v, num_keys, op)

        def plain():
            return ref.segreduce_ref(keys, v, num_keys, op)

    got, want = kernel(), plain()
    got_accs = got[0] if isinstance(got, tuple) else (got,)
    want_accs = want[0] if isinstance(want, tuple) else (want,)
    err, ok = 0.0, True
    for g, w, op in zip(got_accs, want_accs, op_names):
        err = max(err, float((g.double() - w.double()).abs().max()) if g.numel() else 0.0)
        if g.dtype.is_floating_point and op == "sum":
            ok = ok and bool(torch.allclose(g, w, rtol=1e-5, atol=1e-5))
        else:
            ok = ok and bool(torch.equal(g, w))
    if isinstance(got, tuple) and got[1] is not None:
        ok = ok and bool(torch.equal(got[1], want[1]))

    # the library yardsticks: one scatter call over the first aggregate
    # (``library``), and one a table, presence included (``library_all``:
    # the whole function), masked rows given the identity beforehand
    lib_keys = keys.long()
    scatters = []
    tables = [(v, op) for v, op in zip(values, op_names)]
    if with_presence:
        tables.append((torch.ones(keys.shape, dtype=torch.int32, device=keys.device), "sum"))
    for lib_vals, op in tables:
        ident = ref.op_identity(op, lib_vals.dtype)
        if mask is not None:
            lib_vals = torch.where(mask, lib_vals, torch.tensor(ident, dtype=lib_vals.dtype, device=lib_vals.device))
        table = torch.full((num_keys,), ident, dtype=lib_vals.dtype, device=lib_vals.device)
        if op == "sum":
            scatters.append(lambda t=table, x=lib_vals: t.clone().index_add_(0, lib_keys, x))
        else:
            reduce = "amax" if op == "max" else "amin"
            scatters.append(lambda t=table, x=lib_vals, rd=reduce: t.clone().scatter_reduce_(
                0, lib_keys, x, reduce=rd, include_self=True))

    def library():
        return scatters[0]()

    def library_all():
        return [call() for call in scatters]

    n = int(keys.shape[0])
    passes = kernel_passes(torch, kernel)
    t_bound, bound_by = bound(
        n, num_keys, sum(v.element_size() for v in values),
        len(values) + (1 if with_presence else 0), mask is not None,
    )
    return {
        "n": n,
        "num_keys": num_keys,
        "n_aggs": len(values),
        "masked": mask is not None,
        "ok": ok,
        "max_abs_err": err,
        "ms": device_ms(torch, kernel),
        "plain_ms": device_ms(torch, plain, reps=3, warmup=1),
        "library_ms": device_ms(torch, library),
        "library_all_ms": device_ms(torch, library_all),
        "bound_ms": t_bound,
        "bound_by": bound_by,
        "passes_ms": passes,
        "regime": kernel_regime(torch, kern, keys, values, op_names, num_keys, with_presence),
    }


class DeviceTotal:
    """A device kernel's (or copy's, or fill's) totals over a trace, read as
    a row of ``key_averages()``: ``key``, ``count`` and
    ``device_time_total`` (us)."""

    __slots__ = ("key", "count", "device_time_total")

    def __init__(self, key: str) -> None:
        self.key, self.count, self.device_time_total = key, 0, 0.0


def device_totals(prof):
    """The trace's device events summed by name, read from the profiler's
    raw events without building ``key_averages()``' event tree (~10 s a
    training step of tens of thousands of launches)."""
    from torch.autograd import DeviceType

    rows: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        row = rows.get(ev.name())
        if row is None:
            row = rows[ev.name()] = DeviceTotal(ev.name())
        row.count += 1
        row.device_time_total += ev.duration_ns() / 1e3
    return list(rows.values())


def trace_card(torch, fn, reps: int = 1):
    """Call ``fn`` ``reps`` times under the profiler: the averages of the
    card's kernels, copies and fills, or None when the profiler cannot
    trace the card (``fn`` runs all the same).  Only the profiler's start
    and stop are guarded: a failure inside ``fn`` (a kernel that does not
    launch) fails the run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.start()
    except (RuntimeError, AssertionError) as e:
        print(f"    (the profiler cannot trace the card: {e})", flush=True)
        prof = None
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        if prof is not None:
            try:
                prof.stop()
            except (RuntimeError, AssertionError) as e:
                print(f"    (the profiler cannot trace the card: {e})", flush=True)
                prof = None
    return None if prof is None else device_totals(prof)


def device_us(ev) -> float:
    us = getattr(ev, "device_time_total", None)
    return us if us is not None else getattr(ev, "cuda_time_total", 0.0)


def traced_launches(torch, fn, needle: str, reps: int) -> dict:
    """{name: (device ms a launch, launches recorded)} of each CUDA kernel
    whose name holds ``needle``, from the profiler's trace of ``reps`` calls
    of ``fn`` (empty when the profiler cannot trace the card).  The profiler
    may miss the launches at the start of its window (on the H100 machine it
    dropped a backward's first launch, and in a long run all of a call's),
    so the window opens with a pause of the host and each kernel's time is
    averaged over the launches it recorded."""
    def run():
        time.sleep(0.1)
        for _ in range(reps):
            fn()

    events = trace_card(torch, run)
    if events is None:
        return {}
    return {ev.key.split("(")[0].removeprefix("void "): (device_us(ev) / 1e3 / ev.count, ev.count)
            for ev in events if needle in ev.key and ev.count > 0}


def launch_times(torch, fn, needle: str, reps: int = 5) -> dict:
    """Device ms a launch of each CUDA kernel whose name holds ``needle``
    (``traced_launches``)."""
    return {name: ms for name, (ms, _) in traced_launches(torch, fn, needle, reps).items()}


def kernel_passes(torch, fn, reps: int = 20, prefixes=("seg_", "Memset")) -> dict:
    """{name: {"ms": device ms a launch, "per_call": launches a call}} of each
    CUDA kernel (and memset) ``fn`` launches whose name starts with one of
    ``prefixes``, after one warm call, from ``traced_launches`` over
    ``reps`` calls, each after one launch of a marker kernel (an in-place
    bitwise not of one int16).  The time is over the launches the trace
    recorded, and launches a call are those recorded over the markers
    recorded, not over the calls made: late in a long run the profiler kept
    35-80% of the launches of a 20-call window (and none of a 3-call one).
    ``per_call`` is None where no marker was recorded; empty when the
    profiler cannot trace the card or recorded nothing."""
    flag = torch.zeros(1, dtype=torch.int16, device="cuda")

    def call():
        flag.bitwise_not_()
        fn()

    fn()
    traced = traced_launches(torch, call, "", reps)
    calls = sum(count for name, (_, count) in traced.items() if "bitwise_not" in name)
    return {name: {"ms": ms, "per_call": count / calls if calls else None}
            for name, (ms, count) in traced.items() if ms > 0 and name.startswith(prefixes)}


def passes_text(passes: dict, digits: int = 4) -> str:
    """``kernel_passes``' reading as 'name ms-a-launch x launches-a-call',
    then the call's device ms, the sum of ms x launches (left out where the
    launches a call are not known)."""
    if not passes:
        return "(the profiler recorded no launch)"
    known = all(p["per_call"] is not None for p in passes.values())
    text = "  ".join(f"{name.split('<')[0]} {p['ms']:.{digits}f} x"
                     + (f"{p['per_call']:.3g}" if p["per_call"] is not None else "?") for name, p in passes.items())
    if known:
        text += f"; {sum(p['ms'] * p['per_call'] for p in passes.values()):.{digits}f} ms a call"
    return text


# ---------------------------------------------------------------------------
# phase 12: the partitioned backend at the main path's size
# ---------------------------------------------------------------------------

# (label, Session knobs): the planner's K and schedule, then K pinned to 8
# under guided self-scheduling
# (label, Session knobs, the queries it runs: all of phase 4's where None;
# K = 8 'guided' runs Q15 and Q13 SQL only, for time)
PART_CONFIGS = (("planner", {}, None), ("k8_guided", {"n_partitions": 8, "schedule": "guided"}, ("q15", "q13_sql")))


def card_busy(torch, fn, wall_ms: float) -> dict:
    """The card's busy device ms over one call of ``fn`` (the profiler's sum
    over kernels, copies and fills) and its idle share against ``wall_ms``,
    the call's synchronized wall time without the profiler."""
    events = trace_card(torch, fn)
    if events is None:
        return {"device_ms": None, "idle_share": None}
    busy = sum(device_us(ev) for ev in events) / 1e3
    return {"device_ms": busy, "idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms else None}


def timed_run(torch, plan, params) -> float:
    """One synchronized ``plan.run``, wall ms on the host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan.run(params)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def partitioned_path(torch, repro_torch, ops, tables: dict, want: dict, main_rows: dict,
                     fails: Failures, recorders) -> dict:
    """Phase 4's five queries through ``Session(backend='partitioned')`` with
    worker-pool dispatch and captured chunk kernels, and beside each run the
    same plan's serial dispatch, which must give the same bits."""
    report = {}
    params = {"q15": {"lo": Q15_LO, "hi": Q15_HI}}
    for cname, kw, only in PART_CONFIGS:
        sessions = {}
        for mode in ("async", "serial"):
            sessions[mode] = repro_torch.Session(backend="partitioned", async_dispatch=mode == "async", **kw)
            for name, cols in tables.items():
                sessions[mode].register(name, **cols)
        for label, submit, answer, rtol in smoke_queries(repro_torch):
            if only is not None and label not in only:
                continue
            what = f"partitioned {cname} {label}"
            out = run_query(sessions["async"], f"{cname}:{label}", lambda: submit(sessions["async"]), recorders)
            res = out["result"]
            plan = res.plan
            chosen = res.decision.chosen
            keys, vals = want[answer]
            fails.check(rows_match(res.rows, keys, vals, rtol), f"{what}: rows disagree with the oracle")
            if label != "q15":  # counts and minimums: the same rows as the 'torch' backend's
                fails.check(sorted(res.rows or []) == main_rows.get(label), f"{what}: rows differ from phase 4's")
            ser = submit(sessions["serial"])
            same = sorted(ser.rows or []) == sorted(res.rows or [])
            if chosen.agg_method == "kernel":
                fails.check(same, f"{what}: serial and async dispatch differ on the kernel path")
            p = params.get(answer)
            run_ms = {mode: timed_run(torch, s_res.plan, p) for mode, s_res in (("async", res), ("serial", ser))}
            busy = card_busy(torch, lambda: plan.run(p), run_ms["async"])
            rep = plan.runtime_report()
            jit = rep["jit"]
            fails.check(jit["compiles"] > 0 and jit["hits"] > 0, f"{what}: no captured chunk kernel replayed ({jit})")
            report[f"{cname}:{label}"] = {
                "k": plan.k, "schedule": plan.choices.schedule, "agg_method": chosen.agg_method,
                "join_method": chosen.join_method, "rows": len(res.rows or []),
                "serial_equal": same, **out["times"], "compute_ms": run_ms["async"],
                "serial_compute_ms": run_ms["serial"], "async_over_serial": run_ms["async"] / run_ms["serial"],
                **busy, "jit": jit,
                "ops": [{k: o[k] for k in ("op", "n_chunks", "rows", "t_ms", "achieved_imbalance")}
                        for o in rep["ops"]],
                "queue_ms": rep["queue_wait_ms"], "n_workers": rep["n_workers"],
            }
            c, w = out["times"]["cold"], out["times"]["warm"]
            print(f"  {cname:<9} {label:<14} K={plan.k} {plan.choices.schedule:<6} agg={chosen.agg_method:<6} "
                  f"cold {c['wall_ms']:.1f} ms  warm {w['wall_ms']:.1f} ms (revalidate {w['revalidate_ms']:.1f})  "
                  f"compute {run_ms['async']:.1f} ms (serial {run_ms['serial']:.1f}, ratio "
                  f"{run_ms['async'] / run_ms['serial']:.2f})  device {busy['device_ms'] or 0:.1f} ms idle "
                  f"{busy['idle_share'] if busy['idle_share'] is not None else float('nan'):.3f}  "
                  f"captures {jit['compiles']} hits {jit['hits']} overflows {jit['overflows']}  "
                  f"serial==async {same}", flush=True)
            for o in rep["ops"]:
                print(f"    {o['op']:<34} chunks {o['n_chunks']:>3} rows {o['rows']:>9} t {o['t_ms']:.1f} ms "
                      f"imbalance {o['achieved_imbalance']:.3f}", flush=True)
            print(f"    queue {rep['queue_wait_ms']:.1f} ms over {rep['n_dispatches']} dispatches, "
                  f"{rep['n_workers']} workers", flush=True)
        del sessions
        torch.cuda.empty_cache()
    return report


def chunk_shapes(torch, ops, ref, recorders, fails: Failures) -> list:
    """The segreduce launches of the chunk kernels, one per label and chunk
    shape: the first chunk's inputs held against the plain version, and the
    kernel's regime, time (events around eager calls, which at a small chunk
    may read the host's launch time), each pass's device ms a launch from
    the profiler's trace, bound and one library call's time there."""
    rows = []
    for rec in recorders:
        for label, cargs, ckw in rec.calls:
            t = time_call(torch, ops, ref, rec.name, cargs, ckw)
            fails.check(t["ok"], f"{rec.name} at chunk {label} disagrees with its plain version")
            rows.append({"name": rec.name, "query": label, **t})
            print(f"  {rec.name:<16} {label:<26} N={t['n']:>8} K={t['num_keys']:>8} regime {t['regime']} "
                  f"kernel {t['ms']:.4f} ms  bound {t['bound_ms']:.4f} ms  plain {t['plain_ms']:.3f} ms  "
                  f"library {t['library_ms']:.3f} ms (every table {t['library_all_ms']:.3f} ms)", flush=True)
            print("    passes (ms a launch x launches a call) " + passes_text(t["passes_ms"]), flush=True)
        rec.calls.clear()
    return rows


# ---------------------------------------------------------------------------
# phase 13: the multi-tenant QueryServer
# ---------------------------------------------------------------------------

ZIPF_S = 1.1             # Zipf exponent of the skewed table's group key
ZIPF_KEYS = 100_000      # its key space: SF10's supplier count
QZ = "SELECT zk, SUM(zv), MIN(zv), MAX(zv), COUNT(zk) FROM zipf GROUP BY zk"


def zipf_table(n: int, seed: int) -> dict:
    """``n`` rows whose group key follows a Zipf law of exponent ZIPF_S over
    ZIPF_KEYS keys (ranks drawn by the inverse CDF, then given shuffled key
    ids), with int32 values."""
    rng = np.random.default_rng(seed + 13)
    w = 1.0 / np.arange(1, ZIPF_KEYS + 1, dtype=np.float64) ** ZIPF_S
    cdf = np.cumsum(w / w.sum())
    ranks = np.minimum(np.searchsorted(cdf, rng.random(n)), ZIPF_KEYS - 1)
    ids = rng.permutation(ZIPF_KEYS).astype(np.int32)
    return {"zk": ids[ranks], "zv": rng.integers(-1000, 1000, n).astype(np.int32)}


def zipf_oracle(t: dict) -> list:
    k, v = t["zk"].astype(np.int64), t["zv"].astype(np.int64)
    order = np.argsort(k, kind="stable")
    ks, vs = k[order], v[order]
    starts = np.r_[0, np.nonzero(ks[1:] != ks[:-1])[0] + 1]
    sums = np.add.reduceat(vs, starts)
    sums = ((sums + 2**31) % 2**32 - 2**31)  # int32 SUM wraps
    return sorted(zip(ks[starts].tolist(), sums.tolist(), np.minimum.reduceat(vs, starts).tolist(),
                      np.maximum.reduceat(vs, starts).tolist(), np.diff(np.r_[starts, len(ks)]).tolist()))


def server_path(torch, repro_torch, tables: dict, want: dict, fails: Failures, n_tenants: int = 4) -> dict:
    """The Zipf query through a feedback Session whose SplitPolicy splits
    partitions mid-run, against the serial unsplit run; then ``n_tenants``
    tenants submit phase 4's five queries and the Zipf query at once through
    one QueryServer (one SharedChunkPool, feedback on; the shared pool runs
    chunk sets as they are and never splits)."""
    import threading

    from repro_torch.backends.partitioned import SplitPolicy

    zipf = tables["zipf"]
    t0 = time.perf_counter()
    zwant = zipf_oracle(zipf)
    print(f"  zipf oracle {time.perf_counter() - t0:.1f} s", flush=True)
    out: dict = {}
    # K = 8 and 'fixed' chunks (N/64 rows), pinned: a split needs chunks
    # still pending after the first ones finish, which the planner's K and
    # static chunks (one or two a partition, all taken by 8 workers at once)
    # would not leave
    pinned = dict(backend="partitioned", n_partitions=8, schedule="fixed")
    serial = repro_torch.Session(async_dispatch=False, **pinned)
    serial.register("zipf", **zipf)
    base = serial.sql(QZ)
    fails.check(sorted(base.rows) == zwant, "zipf query: the serial run disagrees with the oracle")
    # the split at SplitPolicy's default factor of 4 (counted: chunks of one
    # size take about one time, so it may flag none), then at factor 0,
    # which flags every partition once two chunks are done
    for factor in (SplitPolicy().threshold_factor, 0.0):
        split = repro_torch.Session(async_dispatch=True, feedback=True, **pinned)
        split._split_policy = SplitPolicy(threshold_factor=factor)
        split.register("zipf", **zipf)
        t0 = time.perf_counter()
        r = split.sql(QZ)
        wall = (time.perf_counter() - t0) * 1e3
        n_split = split.metrics_registry.counter_total("replan.splits")
        ok = repr(r.results) == repr(base.results)
        fails.check(ok, f"zipf query split (factor {factor}) differs from the serial unsplit run")
        out[f"split_factor_{factor:g}"] = {"splits": n_split, "bitwise_equal": ok, "wall_ms": wall,
                                           "chunks": len(r.plan.dispatch_log)}
        print(f"  zipf split at factor {factor:g}: {n_split} splits, {len(r.plan.dispatch_log)} chunks, "
              f"bitwise equal to serial unsplit {ok}, {wall:.1f} ms", flush=True)
        del split
    fails.check(out["split_factor_0"]["splits"] > 0, "SplitPolicy never split a partition")

    srv = repro_torch.QueryServer(feedback=True, max_pending=2 * n_tenants, admission="block")
    try:
        for name, cols in tables.items():
            srv.register(name, **cols)
        errors: list = []
        results: dict = {}

        class Tenant:
            """One tenant's view of the server, shaped like a Session for
            ``smoke_queries``."""

            def __init__(self, name: str) -> None:
                self.name = name

            def sql(self, q, params=None):
                return srv.submit(q, params, tenant=self.name)

            def mapreduce(self, spec):
                return srv.submit(spec, tenant=self.name)

        def tenant(tn: str) -> None:
            try:
                for label, submit, answer, rtol in smoke_queries(repro_torch):
                    results[(tn, label)] = (submit(Tenant(tn)).rows, answer, rtol)
                results[(tn, "zipf")] = (srv.submit(QZ, tenant=tn).results, None, 0)
            except Exception as e:  # noqa: BLE001 — every tenant's failure is reported
                errors.append(f"{tn}: {type(e).__name__}: {e}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=tenant, args=(f"tenant{i}",)) for i in range(n_tenants)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = (time.perf_counter() - t0) * 1e3
        fails.check(not errors and not any(t.is_alive() for t in threads), f"server tenants failed: {errors}")
        for (tn, label), (rows, answer, rtol) in sorted(results.items()):
            if label == "zipf":
                fails.check(repr(rows) == repr(base.results), f"server {tn} zipf: differs from the serial run")
            else:
                keys, vals = want[answer]
                fails.check(rows_match(rows, keys, vals, rtol), f"server {tn} {label}: rows disagree with the oracle")
        st = srv.stats()

        def total(name: str) -> float:
            return srv.metrics.counter_total(name)

        out["server"] = {
            "tenants": n_tenants, "queries": len(results), "wall_ms": wall,
            "admitted": total("serve.admitted"), "blocked": total("serve.blocked"),
            "rejected": total("serve.rejected"), "plan_cache": st["plan_cache"],
            "splits": total("replan.splits"),
            "replans": total("replan.drift"), "profiles": total("replan.profiles"),
            "pool": st["pool"], "scale_up": total("serve.pool.scale_up"),
            "scale_down": total("serve.pool.scale_down"),
        }
        s = out["server"]
        print(f"  server: {n_tenants} tenants, {len(results)} queries in {wall:.1f} ms; admitted {s['admitted']:g} "
              f"blocked {s['blocked']:g} rejected {s['rejected']:g}; plan cache {st['plan_cache']}; "
              f"splits {s['splits']:g} replans {s['replans']:g}; pool {st['pool']['n_workers']} workers, "
              f"scale up {s['scale_up']:g} down {s['scale_down']:g}", flush=True)
    finally:
        srv.close()
    return out


# ---------------------------------------------------------------------------
# phase 2: the builds, one nvcc per source, started together
# ---------------------------------------------------------------------------


def build_all(libraries: dict) -> dict:
    """Build (or load) every kernel library in parallel; seconds per build."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(libraries)) as pool:
        futures = {name: pool.submit(lib.load) for name, lib in libraries.items()}
        for fut in futures.values():
            fut.result()
    return {name: lib.build_seconds for name, lib in libraries.items()}


# ---------------------------------------------------------------------------
# phase 6: the flash kernel against its plain version
# ---------------------------------------------------------------------------


def unmasked_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Query-key pairs the mask leaves, summed over the query rows."""
    q = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(q + 1, sk) if causal else np.full(sq, sk, np.int64)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_flops(B: int, sq: int, sk: int, H: int, D: int, causal: bool, window: int) -> float:
    """4*D FLOPs per unmasked query-key pair and head: the two products."""
    return 4.0 * D * unmasked_pairs(sq, sk, causal, window) * B * H


def flash_bound(B: int, sq: int, sk: int, H: int, Hkv: int, D: int, elem: int,
                causal: bool, window: int, bf16: bool) -> tuple:
    """(bound_ms, bound_by): flash_flops against the card's peak for the
    input type, and q, k, v, o each moved once."""
    flops = flash_flops(B, sq, sk, H, D, causal, window)
    nbytes = (2 * B * sq * H * D + 2 * B * sk * Hkv * D) * elem
    t_ops = flops / (BF16_OPS_PER_S if bf16 else F32_OPS_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_cases(torch, dtype, sq: int, sk: int, gen):
    """Phase 6's cases at one (Sq, Sk): (q, k, v, kw, q_mul, label) over head
    dims, GQA groups, causal, window and FLASH_CAPS, inputs drawn from gen."""
    dev = gen.device
    B, Hkv = (2, 2) if sk <= 2112 and sq <= 8 else (1, 1)
    for D in FLASH_HEAD_DIMS:
        if D not in FLASH_LONG_HEAD_DIMS and sq >= 8191:
            continue
        for G in (1, 2, 12):
            q = torch.randn(B, sq, Hkv * G, D, device=dev, generator=gen).to(dtype)
            k = torch.randn(B, sk, Hkv, D, device=dev, generator=gen).to(dtype)
            v = torch.randn(B, sk, Hkv, D, device=dev, generator=gen).to(dtype)
            for causal in (True, False):
                for window in (0, 32, 4096):
                    for cap, q_mul in FLASH_CAPS:
                        kw = dict(causal=causal, window=window, scale=D ** -0.5, logit_softcap=cap)
                        label = (f"Sq={sq} Sk={sk} D={D} G={G} causal={causal} window={window} "
                                 f"softcap={cap} q*{q_mul}")
                        yield (q * q_mul if q_mul != 1 else q), k, v, kw, q_mul, label


def flash_matrix(torch, flash_ops, plain, agreement, fails: Failures, seed: int) -> list:
    gen = torch.Generator(device=torch.device("cuda"))
    gen.manual_seed(seed)
    results = []
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for sq, sk in FLASH_SHAPES:
            if dname == "float32" and sq >= 8191:
                continue  # cut for time: bf16 (the path's type) only at the longest shape
            t0 = time.perf_counter()
            n_cases = bad = 0
            worst = {"max_abs_err": 0.0, "worst": 0.0, "rel": 0.0}
            bent = {"worst": 0.0, "rel": 0.0}  # the cases whose scores reach past the cap
            for q, k, v, kw, q_mul, label in flash_cases(torch, dtype, sq, sk, gen):
                a = flash_ops.flash_attention(q, k, v, **kw)
                b = flash_ops.flash_attention(q, k, v, **kw)
                want = plain(q, k, v, **kw)
                torch.cuda.synchronize()
                agree = agreement(a, want)
                ok = agree["ok"] and bitwise_equal(torch, a, b)
                worst = {x: max(worst[x], agree[x]) for x in worst}
                if q_mul != 1:
                    bent = {x: max(bent[x], agree[x]) for x in bent}
                n_cases += 1
                what = (f"flash {dname} {label}: max_abs_err {agree['max_abs_err']:.3g}, "
                        f"worst/limit {agree['worst']:.3g}, rel {agree['rel']:.3g}")
                bad += not fails.check(ok, what)
            dt = time.perf_counter() - t0
            results.append({"dtype": dname, "sq": sq, "sk": sk, "cases": n_cases, "failed": bad,
                            **worst, "past_cap": bent, "seconds": dt})
            print(f"  flash {dname:<8} Sq={sq:>5} Sk={sk:>5}: {n_cases - bad}/{n_cases} cases agree "
                  f"(max_abs_err {worst['max_abs_err']:.3g}, worst/limit {worst['worst']:.3g}, "
                  f"rel {worst['rel']:.3g}; scores past the cap: worst/limit {bent['worst']:.3g}, "
                  f"rel {bent['rel']:.3g}; {dt:.1f} s)", flush=True)
    return results


# ---------------------------------------------------------------------------
# phases 7 and 10: an LM serving path at full width
# ---------------------------------------------------------------------------


class CallRecorder:
    """Wraps ``ops.<name>`` while a serving path runs: every call is held
    against the plain version on its own inputs (``compare(args, kw, out)``
    gives an agreement dict), under the signature ``key(label, args, kw)``,
    and the inputs of the call of each signature that read worst are kept
    for the timing phase.  ``paused()`` restores the wrapper for an unchecked run.
    ``hold(label, n)``, where set, picks the calls held by their number n
    under the label since ``seen`` was last cleared; the others only run."""

    def __init__(self, ops, name: str, compare, key, fails: Failures) -> None:
        self.ops, self.name, self.compare, self.key, self.fails = ops, name, compare, key, fails
        self.orig = getattr(ops, name)
        self.label = ""
        self.stats: dict = {}
        self.inputs: dict = {}
        self.hold = None
        self.seen: dict = {}

    def __enter__(self):
        def record(*args, **kw):
            out = self.orig(*args, **kw)
            n = self.seen[self.label] = self.seen.get(self.label, -1) + 1
            if self.hold is not None and not self.hold(self.label, n):
                return out
            agree = self.compare(args, kw, out)
            key = self.key(self.label, args, kw)
            st = self.stats.setdefault(key, {"calls": 0, "ok": True, "max_abs_err": 0.0, "worst": 0.0, "rel": 0.0})
            if key not in self.inputs or agree["worst"] > st["worst"]:
                self.inputs[key] = (tuple(a.detach().clone() if hasattr(a, "clone") else a for a in args), dict(kw))
            st["calls"] += 1
            st["ok"] = st["ok"] and agree["ok"]
            for x in ("max_abs_err", "worst", "rel"):
                st[x] = max(st[x], agree[x])
            self.fails.check(agree["ok"], f"{self.name} at {key}: kernel and plain version disagree ({agree})")
            return out

        setattr(self.ops, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.orig)
        return False

    @contextlib.contextmanager
    def paused(self):
        held = getattr(self.ops, self.name)
        setattr(self.ops, self.name, self.orig)
        try:
            yield
        finally:
            setattr(self.ops, self.name, held)


def flash_recorder(flash_ops, plain, agreement, fails: Failures) -> CallRecorder:
    import torch

    def compare(args, kw, out):
        with torch.no_grad():  # a training forward's check adds nothing to its graph
            return agreement(out.detach(), plain(*args, **kw))

    def key(label, args, kw):
        q, k = args[0], args[1]
        return (label, tuple(q.shape), tuple(k.shape), str(q.dtype).split(".")[-1],
                bool(kw.get("causal", True)), int(kw.get("window", 0)),
                float(kw.get("logit_softcap", 0.0)), float(kw.get("scale", 1.0)))

    return CallRecorder(flash_ops, "flash_attention", compare, key, fails)


def wkv6_recorder(wkv6_ops, plain, agreement, fails: Failures) -> CallRecorder:
    """y and the final state both held to the wkv6 kernel's tolerance."""

    def compare(args, kw, out):
        want = plain(*args, **kw)
        ay, ast = agreement(out[0], want[0]), agreement(out[1], want[1])
        return {"ok": ay["ok"] and ast["ok"], **{x: max(ay[x], ast[x]) for x in ("worst", "rel", "max_abs_err")}}

    def key(label, args, kw):
        return (label, tuple(args[0].shape), str(args[0].dtype).split(".")[-1])

    return CallRecorder(wkv6_ops, "wkv6", compare, key, fails)


def decode_ops(torch, step, n_steps: int):
    """The device ms per decode step of each PyTorch op that launched
    kernels in it (the profiler's CPU ops with their self device time), the
    costliest first; None when the profiler cannot trace the card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                step()
            torch.cuda.synchronize()
    except (RuntimeError, AssertionError) as e:
        print(f"    (the profiler cannot trace the card: {e})", flush=True)
        return None
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = us if us is not None else getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0 and ev.key.startswith("aten::"):
            rows.append({"op": ev.key, "ms": us / 1e3 / n_steps, "calls": ev.count / n_steps})
    return sorted(rows, key=lambda r: -r["ms"])


def serve_breakdown(torch, model, prompts, kernel: str, n_steps: int = 4, prefill_reading=None,
                    by_op: bool = True) -> dict:
    """Where a batch's card time goes: the profiler's device ms of one
    prefill and the share of the kernels whose name holds ``kernel``; then,
    for the decode step run eagerly and replayed as a CUDA graph, the wall
    ms of a step on the host clock (synchronized, without the profiler),
    the device ms the profiler sees in a step, and the card's idle share of
    the step, 1 - device / wall, with the step's costliest kernels; and for
    the eager step the PyTorch ops that launch its device time (``by_op``).
    ``prefill_reading`` (``ranged_prefill``'s), where given, stands for the
    prefill's trace: the prefill then runs untraced."""
    from repro_torch.serve.step import make_decode_step, pad_cache

    B, S = prompts.shape
    held = {}

    def prefill():
        held["out"] = model.prefill({"tokens": prompts})

    out: dict = {}
    if prefill_reading is not None:
        prefill()
        events = None
        if prefill_reading:
            total, ours = prefill_reading["device_ms"], prefill_reading["flash_ms"]
            out.update(device_ms=total, kernel_ms=ours, kernel_share=ours / total if total else 0.0,
                       prefill_top=prefill_reading["prefill_top"])
    else:
        events = trace_card(torch, prefill)
    logits, pcache = held.pop("out")
    if events is not None:
        total = sum(device_us(ev) for ev in events)
        ours = sum(device_us(ev) for ev in events if kernel in ev.key)  # every dtype's instance
        out.update(device_ms=total / 1e3, kernel_ms=ours / 1e3, kernel_share=ours / total if total else 0.0)
        top = sorted(((device_us(ev) / 1e3, ev.count, ev.key) for ev in events if device_us(ev) > 0), reverse=True)
        out["prefill_top"] = [{"kernel": key[:90], "ms": ms, "launches": n} for ms, n, key in top[:8]]
    cache = pad_cache(pcache, model.cache_init(B, S + 6 * n_steps + 4))
    state = {"tok": torch.argmax(logits[:, -1].float(), dim=-1)[:, None].to(torch.int32), "pos": S, "cache": cache}
    del logits, pcache, cache
    for mode in ("eager", "graph"):
        decode = make_decode_step(model, graph=mode == "graph")

        def step():
            state["tok"], _, state["cache"] = decode(state["cache"], state["tok"], state["pos"])
            state["pos"] += 1

        for _ in range(2):  # the graph: one eager step, then the capture
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        row = {"decode_wall_ms": (time.perf_counter() - t0) * 1e3 / n_steps}
        events = trace_card(torch, step, reps=n_steps)
        if events is not None:
            per = sorted(((device_us(ev) / 1e3 / n_steps, ev.key) for ev in events if device_us(ev) > 0),
                         reverse=True)
            busy = sum(ms for ms, _ in per)
            row.update(decode_device_ms=busy, decode_idle_share=max(0.0, 1.0 - busy / row["decode_wall_ms"]),
                       decode_top=[{"kernel": key[:90], "ms": ms} for ms, key in per[:6]])
        if mode == "eager" and by_op:
            row["decode_ops"] = decode_ops(torch, step, n_steps)
        out[mode] = row
        del decode
    return out


def spread_rwkv_zero_inits(torch, model, gen) -> None:
    """rwkv6 initialises mu_*, w0, w_lora_b, u and ln_x to zeros, which
    gives log_w = -1 everywhere, no bonus and no token shift.  Draw them
    from ``gen`` instead: w0 uniform over the clip range [-8, 4] (so that
    log_w spans [-e^4, -e^-8]), u 0.3 N(0, 1), mu_* U(0, 1), w_lora_b
    0.01 N(0, 1), ln_x 0.1 N(0, 1)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.split(".")[-1]
            shape, dev = p.shape, p.device
            if leaf == "w0":
                p.copy_(torch.rand(shape, generator=gen, device=dev) * 12.0 - 8.0)
            elif leaf == "u":
                p.copy_(0.3 * torch.randn(shape, generator=gen, device=dev))
            elif leaf.startswith("mu_"):
                p.copy_(torch.rand(shape, generator=gen, device=dev))
            elif leaf == "w_lora_b":
                p.copy_(0.01 * torch.randn(shape, generator=gen, device=dev))
            elif leaf == "ln_x":
                p.copy_(0.1 * torch.randn(shape, generator=gen, device=dev))


def first_step_vs_prefill(torch, model, prompts, res, ops, rec: CallRecorder, n_layers: int, fails: Failures,
                          what: str) -> dict:
    """The first decode step's logits (``res.logits[1]``, from
    ``generate(model, prompts, ..., keep_logits=True)``) against
    prefill_forward of the prompt plus the token it fed: within rtol/atol
    DECODE_TOL and DECODE_REL of the largest logit; the prefill launches the
    kernel ``n_layers`` times (once per layer that runs it)."""
    rec.label = f"{what}+1"
    before = ops.LAUNCHES
    tok0 = res.tokens[:, prompts.shape[1] : prompts.shape[1] + 1]
    with torch.inference_mode():
        full, _ = model.prefill({"tokens": torch.cat([prompts, tok0], dim=1)})
    fails.check(ops.LAUNCHES - before == n_layers, f"serve {what}: consistency prefill: launches")
    got, want = res.logits[1].float(), full[:, -1].float()
    err, top = float((got - want).abs().max()), float(want.abs().max())
    ok = bool(torch.allclose(got, want, rtol=DECODE_TOL, atol=DECODE_TOL))
    ok = ok and bool(torch.isfinite(want).all()) and err <= DECODE_REL * top
    fails.check(ok, f"serve {what}: first decode step against prefill: max_abs_err {err:.3g}, "
                    f"{err / top:.3g} of the largest logit {top:.3g}")
    return {"decode_vs_prefill_max_abs_err": err, "logit_abs_max": top}


def serve_path(torch, arch: str, scenarios_spec: dict, ops, rec: CallRecorder, kernel: str, fails: Failures,
               seed: int, record: dict, prepare=None, n_layers: int = 0, moe=None, per_prefill=None,
               breakdown=None, inputs=None, profile: bool = True, all_logits: bool = False):
    """``generate`` at ``arch``'s full width (over its first ``n_layers``
    layers where given) for each scenario (batch, prompt, new tokens),
    twice, through the kernel that ``rec`` wraps on ``ops``: one launch per
    layer and prefill (``per_prefill(cfg)`` launches where given), every
    call held against the plain version,
    bitwise-equal tokens, finite logits, and for (b) the first decode step
    against a prefill of prompt + token (``first_step_vs_prefill``); then
    where the card time goes (``serve_breakdown``).  ``prepare(model,
    gen)`` adjusts the drawn weights.  ``moe`` (the models/moe module), for
    an MoE model: the consistency check runs instead on (a)'s first request
    at a capacity with C = T (``moe_consistency``), and each scenario also
    reads its routing (``moe_routing``) and its prefill's device time by
    part (``moe_breakdown``).  ``breakdown(model, prompts)``, where given,
    reads the first scenario's prefill by part (a dict with ``device_ms``,
    printed by ``print_parts``; one profile of a whole prefill with its
    host ops takes ~15 s at zamba2's size).  ``inputs(cfg, B, S)``, where
    given, makes the prefill's inputs beside the tokens (a VLM's patches and
    3-axis positions; scenario (b)'s consistency prefill does not take
    them).  ``profile=False`` leaves out where the card time goes;
    ``all_logits`` holds every scenario's logits finite (else (b)'s, which
    it keeps for its consistency check)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Model
    from repro_torch.serve.step import generate

    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n_layers = cfg.n_layers
    launches_per_prefill = per_prefill(cfg) if per_prefill is not None else n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model = Model(cfg).init_params(gen)
    if prepare is not None:
        prepare(model, gen)
    torch.cuda.synchronize()
    n_params = model.n_params()
    print(f"  {arch}: {n_params:,} parameters drawn on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    rng = np.random.default_rng(seed)
    scenarios = {
        name: (rng.integers(4, cfg.vocab_size, (B, S)).astype(np.int32), new)
        for name, (B, S, new) in scenarios_spec.items()
    }
    report: dict = {"arch": arch, "n_params": n_params, "layers": n_layers}
    # at the long prompt (b) and its consistency prefill, the first and
    # last layers' calls of each prefill are held (the plain version takes
    # ~0.4 s a call at 16384 tokens)
    rec.hold = lambda label, n: not (label == "b" or label.endswith("(b)+1")) or \
        n % launches_per_prefill in (0, launches_per_prefill - 1)
    rec.seen.clear()
    ops.reset_launches()
    with rec:
        for name, (prompt_np, new) in scenarios.items():
            t_scenario = time.perf_counter()
            prompts = torch.from_numpy(prompt_np).cuda()
            extra = inputs(cfg, *prompt_np.shape) if inputs is not None else None
            assert extra is None or name != "b", "scenario (b)'s consistency prefill takes tokens only"
            runs = []
            keep = name == "b" or all_logits
            for run in ("checked", "timed", "eager"):
                rec.label = name
                before = ops.LAUNCHES
                if run == "checked":
                    res = generate(model, prompts, new, keep_logits=keep, inputs=extra)
                else:
                    with rec.paused():
                        res = generate(model, prompts, new, keep_logits=keep, graph=run != "eager", inputs=extra)
                launched = ops.LAUNCHES - before
                fails.check(launched == launches_per_prefill,
                            f"serve {arch} ({name}, {run}): {launched} {rec.name} launches, "
                            f"not {launches_per_prefill}")
                finite = all(bool(torch.isfinite(lg).all()) for lg in res.logits) if res.logits else True
                fails.check(finite, f"serve {arch} ({name}): non-finite logits")
                runs.append(res)
            fails.check(bool(torch.equal(runs[0].tokens, runs[1].tokens)),
                        f"serve {arch} ({name}): two runs gave different tokens")
            fails.check(bool(torch.equal(runs[1].tokens, runs[2].tokens)),
                        f"serve {arch} ({name}): the graph decode's tokens differ from the eager decode's")
            eager = runs[2]
            res = runs[1]
            B = prompts.shape[0]
            entry = {
                "batch": B, "prompt": int(prompts.shape[1]), "new": new,
                "prefill_ms": res.prefill_s * 1e3,
                "decode_ms_per_token": res.decode_s * 1e3 / max(new - 1, 1),
                "eager_decode_ms_per_token": eager.decode_s * 1e3 / max(new - 1, 1),
                "decode_tok_s": B * (new - 1) / res.decode_s if res.decode_s > 0 else 0.0,
                "tok_s": B * new / (res.prefill_s + res.decode_s),
                "prefill_tok_s": B * prompts.shape[1] / res.prefill_s,
                "graph_tokens_equal_eager": bool(torch.equal(res.tokens, eager.tokens)),
            }
            if name == "b" and moe is None:
                # the first decode step against a prefill of the prompt plus its token
                entry.update(first_step_vs_prefill(torch, model, prompts, runs[1], ops, rec, launches_per_prefill,
                                                   fails, f"{arch} (b)"))
            if name == "a" and moe is not None:
                entry.update(moe_consistency(torch, model, prompts[:1], ops, rec, n_layers, fails, arch))
            report[name] = entry
            entry["seconds"] = time.perf_counter() - t_scenario
            print(f"  ({name}) batch {B} x {prompts.shape[1]} prompt + {new} new ({entry['seconds']:.0f} s): "
                  f"prefill {entry['prefill_ms']:.1f} ms, "
                  f"decode {entry['decode_ms_per_token']:.2f} ms/token as a CUDA graph (eager "
                  f"{entry['eager_decode_ms_per_token']:.2f}), {entry['decode_tok_s']:.1f} decode tok/s, "
                  f"{entry['tok_s']:.1f} tok/s overall; tokens equal across runs and to the eager decode's",
                  flush=True)
    launches = ops.LAUNCHES
    report["launches"] = launches
    report["launches_by_dim"] = dict(getattr(ops, "LAUNCHES_BY_DIM", {}))
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {rec.name} launches on the serving path: {launches}; peak memory {report['peak_gib']:.1f} GiB",
          flush=True)
    for name, b in report.items():
        if isinstance(b, dict) and "decode_vs_prefill_max_abs_err" in b:
            print(f"  ({name}) first decode step vs prefill of prompt+token" + (
                f" (its first request at capacity factor {b['capacity_factor']:g}, C = T = {b['capacity']}; "
                f"{b['dropped_at_published']} of {b['choices']} choices dropped at the published "
                f"{b['published_capacity_factor']:g})" if "capacity" in b else "") + ": max_abs_err "
                f"{b['decode_vs_prefill_max_abs_err']:.4g}, logits up to {b['logit_abs_max']:.4g} (ratio "
                f"{b['decode_vs_prefill_max_abs_err'] / b['logit_abs_max']:.4g}; limits {DECODE_TOL} and "
                f"{DECODE_REL} of the largest logit)", flush=True)
    # where the first scenario's card time goes (these launches are not
    # counted; (b)'s readings are cut for time)
    with torch.inference_mode():
        for name, (prompt_np, _) in list(scenarios.items())[:1 if profile else 0]:
            t_profile = time.perf_counter()
            if moe is not None:
                prompts = torch.from_numpy(prompt_np).cuda()
                report[name]["routing"] = moe_routing(torch, moe, model, prompts)
                report[name]["prefill_parts"] = moe_breakdown(torch, moe, model, prompts, kernel)
                print_moe_reading(name, report[name])
            parts = None
            if breakdown is not None:
                parts = report[name]["prefill_parts"] = breakdown(model, torch.from_numpy(prompt_np).cuda())
                print_parts(name, parts)
            prof = serve_breakdown(torch, model, torch.from_numpy(prompt_np).cuda(), kernel, prefill_reading=parts,
                                   by_op=breakdown is None)
            report[name]["profile"] = prof
            prof["seconds"] = time.perf_counter() - t_profile
            if "device_ms" in prof:
                print(f"  ({name}, read in {prof['seconds']:.0f} s) prefill device time {prof['device_ms']:.1f} ms, "
                      f"{rec.name} kernel "
                      f"{prof['kernel_ms']:.1f} ms ({100 * prof['kernel_share']:.1f}%); costliest: " + "; ".join(
                          f"{t['kernel'][:48]} {t['ms']:.1f} ({t['launches']})" for t in prof["prefill_top"][:6]),
                      flush=True)
            for mode in ("eager", "graph"):
                row = prof[mode]
                line = f"  ({name}) {mode} decode step wall {row['decode_wall_ms']:.2f} ms"
                if "decode_device_ms" in row:
                    line += (f", device {row['decode_device_ms']:.2f} ms, card idle "
                             f"{100 * row['decode_idle_share']:.1f}%; costliest: "
                             + "; ".join(f"{t['kernel'][:48]} {t['ms']:.2f}" for t in row["decode_top"][:4]))
                print(line, flush=True)
            if prof["eager"].get("decode_ops"):
                print(f"  ({name}) eager decode step's device time by op: " + "; ".join(
                    f"{r['op']} {r['ms']:.2f} ms ({r['calls']:.0f} calls)" for r in prof["eager"]["decode_ops"][:8]),
                    flush=True)
    bad_calls = [k for k, st in rec.stats.items() if not st["ok"]]
    fails.check(not bad_calls, f"{rec.name} calls disagreeing with the plain version: {bad_calls}")
    rec.hold = None
    record[f"serve_{arch}"] = report
    del model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 19: the MoE models at published width over the layers that fit
# ---------------------------------------------------------------------------


def moe_depth(cfg, budget_gib: float, period: int) -> tuple:
    """(layers, bytes a layer, bytes of the embedding and head): the most
    whole periods of ``period`` layers whose weights, with the embedding and
    the head, fit ``budget_gib``, from the port's own parameter definitions
    (bf16 weights, the f32 router)."""
    import math

    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import block_defs, model_defs

    def nbytes(defs) -> int:
        return sum(math.prod(d.shape) * d.dtype.itemsize for _, d in tree_leaves(defs))

    layer = max(nbytes(block_defs(cfg, kind)) for kind in set(cfg.layer_kinds()))
    outer = nbytes({k: v for k, v in model_defs(cfg).items() if k not in ("groups", "remainder")})
    n = int((budget_gib * 2**30 - outer) // layer) // period * period
    return max(n, period), layer, outer


def moe_consistency(torch, model, prompts, ops, rec: CallRecorder, n_layers: int, fails: Failures,
                    arch: str) -> dict:
    """The first decode step against a prefill of prompt + token for one
    request, at a capacity factor of E / K, where C = T and no expert drops
    a token: at the published 1.25 a prefill drops by design (decode never
    does, C >= T there), so the two would differ where it dropped.  Also the
    choices the published capacity drops on the same prompt."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.serve.step import generate

    cfg = model.cfg
    m = cfg.moe
    factor = m.n_experts / m.top_k
    T = int(prompts.numel())
    dropped = moe_routing(torch, moe, model, prompts)["dropped"]
    model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(m, capacity_factor=factor))
    try:
        assert moe.capacity(model.cfg, T + 1)[1] == T + 1 and moe.capacity(model.cfg, T)[1] == T
        rec.label = "a[0]"
        before = ops.LAUNCHES
        res = generate(model, prompts, 2, keep_logits=True)
        fails.check(ops.LAUNCHES - before == n_layers, f"serve {arch}: consistency generate: launches")
        out = first_step_vs_prefill(torch, model, prompts, res, ops, rec, n_layers, fails, f"{arch} (a)[0]")
    finally:
        model.cfg = cfg
    return dict(out, capacity_factor=factor, capacity=T + 1, published_capacity_factor=m.capacity_factor,
                dropped_at_published=dropped, choices=T * m.top_k * n_layers)


def moe_routing(torch, moe, model, prompts) -> dict:
    """One prefill of ``prompts``, each block's routing read: the load of
    the busiest expert over the mean load (choices before the capacity
    cut), the share of choices dropped at the model's capacity, and their
    count, over the layers (each layer's load, and the busiest layer)."""
    held = []
    orig = moe.route

    def recorded(logits, **kw):
        r = orig(logits, **kw)
        held.append((r.expert_ids.reshape(-1), r.keep.reshape(-1), kw["E"]))
        return r

    moe.route = recorded
    try:
        with torch.inference_mode():
            model.prefill({"tokens": prompts})
    finally:
        moe.route = orig
    loads, drops, dropped = [], [], 0
    for ids, keep, E in held:
        counts = torch.bincount(ids, minlength=E).float()
        loads.append(float(counts.max() / counts.mean()))
        n_drop = int((~keep).sum())
        dropped += n_drop
        drops.append(n_drop / keep.numel())
    return {"max_over_mean_load": loads, "dropped_share": drops, "dropped": dropped,
            "worst_load": max(loads), "mean_dropped_share": sum(drops) / len(drops)}


MOE_PARTS = ("router_logits", "route", "dispatch", "experts", "shared_expert", "combine")


def ranged_prefill(torch, parts: dict, run, kernel: str) -> dict:
    """The profiler's device ms of one prefill, ``run()`` (the model warmed
    by the serving runs before it), split by function: ``parts`` maps a label to
    (module, function name); each part is the device time of the kernels
    launched inside a ``record_function`` range around that function
    (wrapped for this reading only), ``flash_ms`` that of the kernels whose
    name holds ``kernel``.  Returns {"device_ms", "flash_ms", "parts_ms":
    {label: ms}, "prefill_top": the costliest kernels}; empty when the
    profiler cannot trace the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    origs = {label: (mod, fname, getattr(mod, fname)) for label, (mod, fname) in parts.items()}

    def ranged(label, fn):
        def call(*a, **kw):
            with record_function(f"part.{label}"):
                return fn(*a, **kw)
        return call

    for label, (mod, fname, fn) in origs.items():
        setattr(mod, fname, ranged(label, fn))
    try:
        with torch.inference_mode():
            torch.cuda.synchronize()
            try:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    time.sleep(0.1)
                    run()
                    torch.cuda.synchronize()
            except (RuntimeError, AssertionError) as e:
                print(f"    (the profiler cannot trace the card: {e})", flush=True)
                return {}
    finally:
        for label, (mod, fname, fn) in origs.items():
            setattr(mod, fname, fn)
    events = prof.key_averages()
    # the ranges also appear on the device's timeline as annotations: the
    # kernels are the device's other events, a range's time its host
    # event's device time (the kernels launched inside it)
    kernels = [ev for ev in events if ev.device_type == DeviceType.CUDA and not ev.key.startswith("part.")]
    total = sum(device_us(ev) for ev in kernels) / 1e3
    if total <= 0:
        print("    (the profiler recorded no device time)", flush=True)
        return {}
    ranges = {ev.key: device_us(ev) / 1e3 for ev in events
              if ev.key.startswith("part.") and ev.device_type == DeviceType.CPU}
    top = sorted(((device_us(ev) / 1e3, ev.count, ev.key) for ev in kernels if device_us(ev) > 0), reverse=True)
    return {"device_ms": total, "flash_ms": sum(device_us(ev) for ev in kernels if kernel in ev.key) / 1e3,
            "parts_ms": {label: ranges.get(f"part.{label}", 0.0) for label in parts},
            "prefill_top": [{"kernel": key[:90], "ms": ms, "launches": n} for ms, n, key in top[:8]]}


def moe_breakdown(torch, moe, model, prompts, kernel: str) -> dict:
    """One prefill's device ms (``ranged_prefill``) split into the flash
    kernel, the expert products (``moe.experts`` and the shared expert),
    dispatch and combine (``moe.route``'s sorts, searchsorted and gathers,
    ``moe.dispatch``'s copy into the expert buffers, ``moe.combine``), the
    router (its f32 product) and the rest."""
    out = ranged_prefill(torch, {name: (moe, name) for name in MOE_PARTS},
                         lambda: model.prefill({"tokens": prompts}), kernel)
    if not out:
        return {}
    total, part = out["device_ms"], out["parts_ms"]
    out.update({"experts_ms": part["experts"] + part["shared_expert"],
                "dispatch_combine_ms": part["route"] + part["dispatch"] + part["combine"],
                "router_ms": part["router_logits"]})
    out["rest_ms"] = total - out["flash_ms"] - out["experts_ms"] - out["dispatch_combine_ms"] - out["router_ms"]
    return out


# phase 21: the prefill's parts, by the function that launches them
ZAMBA2_PARTS = {"ssd": ("mamba2", "ssd_batched"), "conv": ("mamba2", "_causal_conv1d"),
                "in_proj": ("mamba2", "in_proj"), "out_proj": ("mamba2", "out_proj"),
                "shared_mlp": ("transformer", "mlp_block")}


def zamba2_breakdown(torch, model, prompts, kernel: str) -> dict:
    """One zamba2 prefill's device ms split into the flash kernel, the SSD
    (``mamba2.ssd_batched``), the conv, the Mamba2 in and out projections,
    the shared blocks' MLP (the only ``mlp_block`` of zamba2) and the rest
    (norms, gates, the shared blocks' projections, the head)."""
    from repro_torch.models import mamba2, transformer

    mods = {"mamba2": mamba2, "transformer": transformer}
    out = ranged_prefill(torch, {k: (mods[m], f) for k, (m, f) in ZAMBA2_PARTS.items()},
                         lambda: model.prefill({"tokens": prompts}), kernel)
    if out:
        out["rest_ms"] = out["device_ms"] - out["flash_ms"] - sum(out["parts_ms"].values())
    return out


def print_parts(name: str, b: dict, what: str = "prefill") -> None:
    if not b:
        return
    t = b["device_ms"]
    print(f"  ({name}) {what} device time {t:.1f} ms: flash {b['flash_ms']:.1f} ({100 * b['flash_ms'] / t:.1f}%), "
          + ", ".join(f"{k} {v:.1f} ({100 * v / t:.1f}%)" for k, v in b["parts_ms"].items())
          + f", rest {b['rest_ms']:.1f} ({100 * b['rest_ms'] / t:.1f}%)", flush=True)


def shared_invocations(cfg) -> int:
    """zamba2's shared-block invocations in one pass: one flash launch each."""
    return cfg.n_layers // cfg.shared_attn_period


def print_moe_reading(name: str, entry: dict) -> None:
    r = entry["routing"]
    print(f"  ({name}) routing of one prefill: busiest expert {r['worst_load']:.3f}x the mean load (per layer "
          + ", ".join(f"{x:.2f}" for x in r["max_over_mean_load"]) + f"); {100 * r['mean_dropped_share']:.2f}% of "
          f"choices dropped at the model's capacity ({r['dropped']} choices)", flush=True)
    b = entry["prefill_parts"]
    if b:
        t = b["device_ms"]
        print(f"  ({name}) prefill device time {t:.1f} ms: flash {b['flash_ms']:.1f} ({100 * b['flash_ms'] / t:.1f}%), "
              f"expert products {b['experts_ms']:.1f} ({100 * b['experts_ms'] / t:.1f}%), dispatch/combine "
              f"{b['dispatch_combine_ms']:.1f} ({100 * b['dispatch_combine_ms'] / t:.1f}%), router "
              f"{b['router_ms']:.2f} ({100 * b['router_ms'] / t:.2f}%), rest {b['rest_ms']:.1f} "
              f"({100 * b['rest_ms'] / t:.1f}%); by function: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in b["parts_ms"].items()), flush=True)


# ---------------------------------------------------------------------------
# phase 8: the flash kernel at the serving path's shapes
# ---------------------------------------------------------------------------


def time_flash(torch, F, flash_ops, plain, agreement, key, inputs) -> dict:
    label, qs, ks, dname, causal, window, cap, scale = key
    (q, k, v), kw = inputs
    B, sq, H, D = qs
    sk, Hkv = ks[1], ks[2]
    bf16 = dname == "bfloat16"
    t_bound, bound_by = flash_bound(B, sq, sk, H, Hkv, D, q.element_size(), causal, window, bf16)
    reps = 3 if sq * sk * B * H > 2**31 else 10
    out = {
        "scenario": label, "q": list(qs), "k": list(ks), "dtype": dname, "causal": causal,
        "window": window, "softcap": cap,
        "ms": device_ms(torch, lambda: flash_ops.flash_attention(q, k, v, **kw), reps=reps),
        "plain_ms": device_ms(torch, lambda: plain(q, k, v, **kw), reps=1, warmup=1),
        "bound_ms": t_bound, "bound_by": bound_by,
    }
    # the yardstick: SDPA is attention (causal or not, as the call) with
    # neither softcap nor window, so it computes this function only where
    # both are off; beside it, the kernel's own time on that function
    same_fn = cap == 0.0 and unmasked_pairs(sq, sk, causal, window) == unmasked_pairs(sq, sk, causal, 0)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True)

    out["sdpa_ms"] = device_ms(torch, sdpa, reps=reps)
    kw0 = dict(causal=causal, window=0, scale=scale, logit_softcap=0.0)
    out["kernel_nocap_ms"] = device_ms(torch, lambda: flash_ops.flash_attention(q, k, v, **kw0), reps=reps)
    agree = agreement(flash_ops.flash_attention(q, k, v, **kw0), sdpa().transpose(1, 2))
    out["sdpa_agrees"], out["sdpa_agreement"] = agree["ok"], agree
    out["tflops"] = flash_flops(B, sq, sk, H, D, causal, window) / (out["ms"] * 1e9)
    out["nocap_tflops"] = flash_flops(B, sq, sk, H, D, causal, 0) / (out["kernel_nocap_ms"] * 1e9)
    out["kernel_over_sdpa"] = out["kernel_nocap_ms"] / out["sdpa_ms"]
    out["serve_over_nocap"] = out["ms"] / out["kernel_nocap_ms"]
    out["library_ms"] = out["sdpa_ms"] if same_fn else None
    out["library_note"] = ("scaled_dot_product_attention computes this function" if same_fn else
                           "no single PyTorch call computes this function (softcap/window); "
                           "sdpa_ms is SDPA's attention without them, beside kernel_nocap_ms")
    return out


def flash_at_shapes(torch, flash_ops, plain, agreement, rec, fails: Failures) -> list:
    import torch.nn.functional as F

    rows = []
    for key, inputs in rec.inputs.items():
        t = time_flash(torch, F, flash_ops, plain, agreement, key, inputs)
        st = rec.stats[key]
        t.update(calls=st["calls"], max_abs_err=st["max_abs_err"], worst=st["worst"], rel=st["rel"])
        fails.check(t["sdpa_agrees"], f"flash at {key}: kernel without softcap/window and SDPA disagree "
                                      f"({t['sdpa_agreement']})")
        rows.append(t)
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.3f} ms"
        print(f"  flash ({t['scenario']}) q={t['q']} window={t['window']} softcap={t['softcap']:g} "
              f"calls {t['calls']}: kernel {t['ms']:.3f} ms  bound {t['bound_ms']:.3f} ms ({t['bound_by']})  "
              f"plain {t['plain_ms']:.3f} ms  library {lib}  |  {'causal' if t['causal'] else 'not causal'}, "
              f"without softcap/window: kernel {t['kernel_nocap_ms']:.3f} ms, SDPA {t['sdpa_ms']:.3f} ms  "
              f"max_abs_err {t['max_abs_err']:.3g}, worst/limit {t['worst']:.3g}, rel {t['rel']:.3g}", flush=True)
        print(f"    {t['tflops']:.1f} TFLOP/s ({t['nocap_tflops']:.1f} without softcap/window); "
              f"kernel / SDPA {t['kernel_over_sdpa']:.2f}; serving call / call without softcap "
              f"{t['serve_over_nocap']:.2f}", flush=True)
        rec.inputs[key] = None
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 9: the wkv6 kernel against its plain version
# ---------------------------------------------------------------------------


def wkv6_bound(B: int, S: int, H: int, K: int, elem: int, u_elem: int, with_state: bool, chunk: int) -> tuple:
    """(bound_ms, bound_by): the larger of the time the operations of the
    chunked form take and the time its bytes take.  Operations, per token
    and head (V = K): the two K x V products (the state's share of y and the
    state's update, 4 K V FLOPs) on the tensor cores in split TF32, three
    products each, at the TF32 rate; then, on the CUDA cores at the f32
    rate, the weights within a chunk of L tokens ((L - 1) / 2 pairs of K
    terms, each a difference, an exp, a product and an FMA: 5 operations),
    the bonus and the decayed operands (7 K) and the state's decay once a
    chunk (2 K V / L).  Bytes: r, k, v (``elem`` bytes), log_w and y (f32),
    u, S0 (when given) and S_out each moved once.  (The per-token scan's
    count, 5 K V f32 operations a token, read 0.200 ms at 8 x 2048 x 40 x
    64.)"""
    n = B * S * H
    t_tensor = n * 3 * 4 * K * K / TF32_OPS_PER_S * 1e3
    t_cuda = n * ((chunk - 1) / 2 * K * 5 + 7 * K + 2 * K * K / chunk) / F32_OPS_PER_S * 1e3
    t_ops = t_tensor + t_cuda
    nbytes = n * K * (3 * elem + 4 + 4) + H * K * u_elem + B * H * K * K * 4 * (2 if with_state else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def wkv6_passes(torch, kern, args) -> dict:
    """Each pass of one launch (device ms a launch, ``kernel_passes``) with
    the chunk length, segments and what each kernel instance takes on the
    card (registers, blocks an SM)."""
    r = args[0]
    B, S, H, K = r.shape
    sms = torch.cuda.get_device_properties(r.device).multi_processor_count
    passes = kernel_passes(torch, lambda: kern.launch(*args), prefixes=("wkv6_",))
    info = {name: kern.library_info(r.dtype, K, with_y)
            for name, with_y in (("scan", True), ("states", False))}
    return {"chunk": kern.CHUNK, "segments": kern.segments(B, H, S, K, sms), "passes_ms": passes, "info": info}


def passes_line(p: dict) -> str:
    info = p["info"]
    return ("L=" + str(p["chunk"]) + f", {p['segments']} segment(s); passes (ms a launch x launches a call) "
            + passes_text(p["passes_ms"]) + "; "
            + ", ".join(f"{k} {v['registers']} registers, {v['blocks_per_sm']} blocks an SM" for k, v in info.items()))


def wkv6_matrix(torch, wkv6_ops, plain, agreement, fails: Failures, seed: int) -> list:
    """Phase 9.  Where the launch cuts the sequence into segments, the
    plain form of its three passes (``ref.wkv6_segmented_plain`` at the
    launch's segment length) is held too, on the random decays from S0:
    against the plain version, and the kernel against it."""
    from repro_torch.kernels.wkv6 import kernel as kern
    from repro_torch.kernels.wkv6.ref import wkv6_segmented_plain

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    results = []
    for K in WKV6_HEAD_SIZES:
        for S in WKV6_LENGTHS:
            for B, H in ((((1, 40),) if K == 64 else ()) if S == WKV6_LONG else WKV6_BATCH_HEADS):
                t0 = time.perf_counter()
                r, k, v = (0.5 * torch.randn(B, S, H, K, device=dev, generator=gen)).to(torch.bfloat16), \
                    (0.5 * torch.randn(B, S, H, K, device=dev, generator=gen)).to(torch.bfloat16), \
                    (0.5 * torch.randn(B, S, H, K, device=dev, generator=gen)).to(torch.bfloat16)
                u = 0.3 * torch.randn(H, K, device=dev, generator=gen)
                s0 = torch.randn(B, H, K, K, device=dev, generator=gen)
                n_cases = bad = 0
                worst = {"max_abs_err": 0.0, "worst": 0.0, "rel": 0.0}
                n_seg = kern.segments(B, H, S, K, sms)
                seg_len = kern.segment_length(S, n_seg)
                for dname, value in WKV6_DECAYS.items():
                    if value is None:
                        lw = -torch.exp(torch.randn(B, S, H, K, device=dev, generator=gen))
                    else:
                        lw = torch.full((B, S, H, K), value, device=dev)
                    for state in (None, s0):
                        y1, st1 = wkv6_ops.wkv6(r, k, v, lw, u, state)
                        y2, st2 = wkv6_ops.wkv6(r, k, v, lw, u, state)
                        want_y, want_s = plain(r, k, v, lw, u, state)
                        torch.cuda.synchronize()
                        ay, ast = agreement(y1, want_y), agreement(st1, want_s)
                        ok = ay["ok"] and ast["ok"] and bitwise_equal(torch, y1, y2) and bitwise_equal(torch, st1, st2)
                        worst = {x: max(worst[x], ay[x], ast[x]) for x in worst}
                        n_cases += 1
                        what = (f"wkv6 K={K} S={S} B={B} H={H} log_w={dname} S0={state is not None}: "
                                f"y worst/limit {ay['worst']:.3g} rel {ay['rel']:.3g}, state worst/limit "
                                f"{ast['worst']:.3g} rel {ast['rel']:.3g}")
                        bad += not fails.check(ok, what)
                        if n_seg > 1 and value is None and state is not None:
                            seg_y, seg_s = wkv6_segmented_plain(r, k, v, lw, u, state, seg_len=seg_len)
                            for got, want, who in ((seg_y, want_y, "segmented plain y"),
                                                   (seg_s, want_s, "segmented plain state"),
                                                   (y1, seg_y, "kernel y against the segmented plain"),
                                                   (st1, seg_s, "kernel state against the segmented plain")):
                                agree = agreement(got, want)
                                n_cases += 1
                                bad += not fails.check(agree["ok"], f"wkv6 K={K} S={S} B={B} H={H} {n_seg} "
                                                       f"segments: {who} worst/limit {agree['worst']:.3g}")
                            del seg_y, seg_s
                        del y1, y2, st1, st2, want_y, want_s
                    del lw
                del r, k, v
                dt = time.perf_counter() - t0
                results.append({"K": K, "S": S, "B": B, "H": H, "segments": n_seg, "segment_length": seg_len,
                                "cases": n_cases, "failed": bad, **worst, "seconds": dt})
                print(f"  wkv6 K={K:>3} S={S:>5} B={B} H={H:>2} segments {n_seg:>2} of {seg_len:>5}: "
                      f"{n_cases - bad}/{n_cases} cases agree "
                      f"(max_abs_err {worst['max_abs_err']:.3g}, worst/limit {worst['worst']:.3g}, "
                      f"rel {worst['rel']:.3g}; {dt:.1f} s)", flush=True)
                torch.cuda.empty_cache()
    return results


def wkv6_pass_report(torch, seed: int) -> dict:
    """Phase 9's last part: each pass of the launch (L, segments, device ms
    a launch, registers and blocks an SM of the scan and the states pass)
    at rwkv6-3b's two serving shapes, K = 64, bf16."""
    from repro_torch.kernels.wkv6 import kernel as kern

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = {}
    for B, S in ((8, 2048), (1, 16385)):
        r, k, v = ((0.5 * torch.randn(B, S, 40, 64, device="cuda", generator=gen)).bfloat16() for _ in range(3))
        lw = -torch.exp(torch.randn(B, S, 40, 64, device="cuda", generator=gen))
        u = 0.3 * torch.randn(40, 64, device="cuda", generator=gen)
        p = wkv6_passes(torch, kern, (r, k, v, lw, u, None))
        out[f"{B}x{S}"] = p
        print(f"  wkv6 passes at {B} x {S} x 40 x 64: " + passes_line(p), flush=True)
        del r, k, v, lw
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 11: the wkv6 kernel at the serving path's shapes
# ---------------------------------------------------------------------------


def wkv6_witness(torch, wkv6_ops, plain, scan, agreement, args) -> dict:
    """Which side of the kernel-versus-plain gap rounds more: the kernel's
    and the plain version's y and final state, each held to the same
    limits against the exact scan in f64 on the same inputs."""
    want_y, want_s = scan(*args, dtype=torch.float64)
    out = {}
    for who, (y, st) in (("kernel", wkv6_ops.wkv6(*args)), ("plain", plain(*args))):
        ay, ast = agreement(y, want_y), agreement(st, want_s)
        out[who] = {x: max(ay[x], ast[x]) for x in ("worst", "rel", "max_abs_err")}
    del want_y, want_s
    return out


def wkv6_at_shapes(torch, wkv6_ops, plain, scan, agreement, rec: CallRecorder) -> list:
    """Each serving shape's kernel, plain and bound times, on the inputs of
    the call that read worst against the plain version, with the f64
    witness of that call (``wkv6_witness``)."""
    from repro_torch.kernels.wkv6 import kernel as kern

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for key, (args, _) in rec.inputs.items():
        label, shape, dname = key
        r, k, v, lw, u, s0 = args
        B, S, H, K = shape
        n_seg = kern.segments(B, H, S, K, sms)
        t_bound, bound_by = wkv6_bound(B, S, H, K, r.element_size(), u.element_size(), s0 is not None, kern.CHUNK)
        st = rec.stats[key]
        row = {
            "scenario": label, "shape": list(shape), "dtype": dname, "calls": st["calls"], "segments": n_seg,
            "ms": device_ms(torch, lambda: wkv6_ops.wkv6(*args)),
            "plain_ms": device_ms(torch, lambda: plain(*args), reps=1, warmup=1),
            "bound_ms": t_bound, "bound_by": bound_by,
            # no single PyTorch call computes the WKV6 recurrence
            "library_ms": None,
            "max_abs_err": st["max_abs_err"], "worst": st["worst"], "rel": st["rel"],
            "witness_f64": wkv6_witness(torch, wkv6_ops, plain, scan, agreement, args),
            "passes": wkv6_passes(torch, kern, args),
        }
        rows.append(row)
        print(f"  wkv6 ({label}) B={B} S={S} H={H} K={K} {dname} calls {st['calls']} segments {n_seg}: "
              f"kernel {row['ms']:.3f} ms  "
              f"bound {t_bound:.3f} ms ({bound_by})  plain {row['plain_ms']:.3f} ms  library n/a  "
              f"max_abs_err {st['max_abs_err']:.3g}, worst/limit {st['worst']:.3g}, rel {st['rel']:.3g}",
              flush=True)
        print("    " + passes_line(row["passes"]), flush=True)
        wit = row["witness_f64"]
        print(f"    that call against the f64 scan: kernel worst/limit {wit['kernel']['worst']:.3g}, "
              f"rel {wit['kernel']['rel']:.3g}; plain worst/limit {wit['plain']['worst']:.3g}, "
              f"rel {wit['plain']['rel']:.3g}", flush=True)
        rec.inputs[key] = None
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 17: the WKV6 backward kernel against its plain version
# ---------------------------------------------------------------------------

# S of phase 17's cases (1 and 16 one stage or less, 53 and 208 ragged and
# whole against the 16-token chunk, 2048 the training length, 16385 one
# long sequence with a ragged tail).  Every (B, H), decay and state runs at
# each S but the longest, which runs one sequence of 40 heads (each (B, H)
# is a grid of the same blocks, which 2048 covers; the plain version's
# walk in f64 takes ~4 s a case there, whatever B and H)
WKV6_BWD_LENGTHS = (1, 16, 53, 208, 2048, 16385)
WKV6_BWD_LONG = 16385
WKV6_BWD_LONG_DECAYS = ("random", "-54.6")  # the long sequence's f64 walk takes ~6 s a case
WKV6_BWD_SHAPES = ((2, 3), (2, 40), (1, 40))


def wkv6_bwd_cases(S: int, K: int) -> tuple:
    """The (B, H) pairs phase 17 runs at length S and head size K: the long
    sequence only at rwkv6-3b's head size (its f64 walk takes ~4 s a case)."""
    if S == WKV6_BWD_LONG:
        return ((1, 40),) if K == 64 else ()
    if S >= 2048:
        return ((2, 40),)  # cut for time: rwkv6-3b's heads only
    return WKV6_BWD_SHAPES


# the f64 autograd of wkv6_scan keeps every step's state: only up to this S;
# each output is held there within its type's ref.BWD_TOL["rel"] (relative
# Frobenius): the kernel's f32 sums, and the bf16 outputs' one rounding
WKV6_BWD_AUTOGRAD_MAX_S = 208


def wkv6_bwd_counts(B: int, S: int, H: int, K: int, elem: int, u_elem: int, with_state: bool,
                    chunk: int) -> dict:
    """The chunked gradient's least times, ms: ``ops_ms`` its operations,
    ``bytes_ms`` its bytes, and ``walk_ops_ms`` the f32 count of the
    token-by-token walk it replaced.  Operations, per token and head (V =
    K), counted as ``wkv6_bound`` counts the forward's: the five K x V
    products (the chunk's state product of the rebuild, dr~, dk~, r~^T dy
    and k~ dS', 10 K V FLOPs) on the tensor cores in split TF32, three
    products each, at the TF32 rate; on the CUDA cores at the f32 rate, A
    as the forward's ((L - 1) / 2 pairs of K terms, 5 operations each), dA
    and A^T dy ((L + 1) / 2 pairs of K, an FMA each, 2 operations), the
    pairs' shares of dr, dk and dlog_w's (d) ((L - 1) / 2 pairs of K, 7
    operations), the per-key terms (20 K) and the decays of the carried
    state and gradient (2 x 2 K V / L).  Bytes: r, k, v (``elem``) and
    log_w, dy (f32) read once; dr, dk, dv (``elem``) and dlog_w (f32)
    written once; u read and du written (``u_elem``); S0, dS_out read and
    dS0 written when a state is given (f32).  The walk: about six K x K
    products a token and head, 12 K^2 FLOPs on the f32 CUDA cores."""
    n = B * S * H
    t_tensor = n * 3 * 10 * K * K / TF32_OPS_PER_S * 1e3
    t_cuda = n * ((chunk - 1) / 2 * K * (5 + 7) + (chunk + 1) / 2 * K * 2 * 2 + 20 * K
                  + 4 * K * K / chunk) / F32_OPS_PER_S * 1e3
    nbytes = n * K * (6 * elem + 3 * 4) + 2 * H * K * u_elem + (3 * B * H * K * K * 4 if with_state else 0)
    return {"ops_ms": t_tensor + t_cuda, "tensor_ms": t_tensor, "cuda_core_ms": t_cuda,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "walk_ops_ms": n * 12.0 * K * K / F32_OPS_PER_S * 1e3}


def wkv6_bwd_bound(B: int, S: int, H: int, K: int, elem: int, u_elem: int, with_state: bool) -> tuple:
    """(bound_ms, bound_by): the larger of the chunked gradient's operations'
    time and its bytes' time (``wkv6_bwd_counts``)."""
    from repro_torch.kernels.wkv6.ref import CHUNK

    c = wkv6_bwd_counts(B, S, H, K, elem, u_elem, with_state, CHUNK)
    return (c["ops_ms"], "operations") if c["ops_ms"] >= c["bytes_ms"] else (c["bytes_ms"], "bytes")


def wkv6_bwd_inputs(torch, gen, B: int, S: int, H: int, K: int, decay, with_state: bool, dtype) -> list:
    """r, k, v 0.5 N(0, 1) in ``dtype``, log_w -exp(N(0, 1)) or the
    constant ``decay``, u 0.3 N(0, 1) in ``dtype``, S0 N(0, 1) or None, dy
    N(0, 1), dS_out N(0, 1) or None (f32), on the card from ``gen``."""
    dev = torch.device("cuda")

    def n(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    r, k, v = ((0.5 * n(B, S, H, K)).to(dtype) for _ in range(3))
    lw = -torch.exp(n(B, S, H, K)) if decay is None else torch.full((B, S, H, K), decay, device=dev)
    u = (0.3 * n(H, K)).to(dtype)
    s0 = n(B, H, K, K) if with_state else None
    dy = n(B, S, H, K)
    ds = n(B, H, K, K) if with_state else None
    return [r, k, v, lw, u, s0, dy, ds]


def wkv6_bwd_matrix(torch, wkv6_kernel, plain_bwd, scan, bwd_agreement, fails: Failures, seed: int) -> list:
    """Phase 17.  The backward kernel (kernel.launch_bwd) against
    wkv6_bwd_plain in float64 under ref.BWD_TOL, every output, bf16 r, k, v
    and u: K 16 and 64; S in WKV6_BWD_LENGTHS; (B, H) (2, 3), (2, 40) and
    (1, 40); log_w -exp(N(0, 1)), -5, -54.6 and -3.4e-4; S0 and dS_out zero
    or random (``wkv6_bwd_cases`` says which (B, H) each S runs).
    Each case runs twice, bitwise equal.  Up to WKV6_BWD_AUTOGRAD_MAX_S the
    kernel is also held against torch autograd of wkv6_scan in float64,
    each output within its type's BWD_TOL["rel"] (Frobenius)."""
    from repro_torch.kernels.wkv6.ref import BWD_TOL

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 17)
    rows = []
    for K in WKV6_HEAD_SIZES:
        for S in WKV6_BWD_LENGTHS:
            for B, H in wkv6_bwd_cases(S, K):
                t0 = time.perf_counter()
                n_cases = bad = 0
                worst = {"max_abs_err": 0.0, "worst": 0.0, "rel": 0.0, "autograd_rel": 0.0}
                for dname, value in WKV6_DECAYS.items():
                    if S == WKV6_BWD_LONG and dname not in WKV6_BWD_LONG_DECAYS:
                        continue
                    for with_state in (False, True):
                        args = wkv6_bwd_inputs(torch, gen, B, S, H, K, value, with_state, torch.bfloat16)
                        got = wkv6_kernel.launch_bwd(*args)
                        again = wkv6_kernel.launch_bwd(*args)
                        want, scales = plain_bwd(*args, dtype=torch.float64, with_scales=True)
                        torch.cuda.synchronize()
                        agree = bwd_agreement(got, want, scales)
                        same = all(bitwise_equal(torch, a, b) for a, b in zip(got, again))
                        what = (f"wkv6 backward K={K} S={S} B={B} H={H} log_w={dname} state={with_state}: "
                                f"worst/limit {agree['worst']:.3g} rel {agree['rel']:.3g}, reruns bitwise {same}")
                        ok = agree["ok"] and same
                        if S <= WKV6_BWD_AUTOGRAD_MAX_S:
                            r, k, v, lw, u, s0, dy, ds = args
                            leaves = [t.double().requires_grad_() for t in (r, k, v, lw, u)]
                            s64 = None if s0 is None else s0.double().requires_grad_()
                            y, s_out = scan(*leaves, s64, dtype=torch.float64)
                            loss = (y * dy.double()).sum() + (0.0 if ds is None else (s_out * ds.double()).sum())
                            wrt = leaves + ([] if s64 is None else [s64])
                            exact = [torch.zeros_like(x) if g is None else g for g, x in zip(
                                torch.autograd.grad(loss, wrt, allow_unused=True), wrt)]  # log_w unused at S = 1
                            rels = [(float((g.double() - e).norm() / e.norm()) if e.norm() > 0
                                     else float(g.double().norm()), BWD_TOL[g.dtype]["rel"])
                                    for g, e in zip(got, exact)]
                            rel = max(x for x, _ in rels)
                            worst["autograd_rel"] = max(worst["autograd_rel"], rel)
                            ok = ok and all(x <= limit for x, limit in rels)
                            what += f", against autograd of wkv6_scan in f64 rel {rel:.3g}"
                            del leaves, s64, y, s_out, exact
                        worst.update({x: max(worst[x], agree[x]) for x in ("max_abs_err", "worst", "rel")})
                        n_cases += 1
                        bad += not fails.check(ok, what)
                        del args, got, again, want, scales
                dt = time.perf_counter() - t0
                rows.append({"K": K, "S": S, "B": B, "H": H, "cases": n_cases, "failed": bad, **worst,
                             "seconds": dt})
                print(f"  wkv6 backward K={K:>3} S={S:>5} B={B} H={H:>2}: {n_cases - bad}/{n_cases} cases agree "
                      f"(max_abs_err {worst['max_abs_err']:.3g}, worst/limit {worst['worst']:.3g}, rel "
                      f"{worst['rel']:.3g}" + (f", autograd rel {worst['autograd_rel']:.3g}"
                                               if S <= WKV6_BWD_AUTOGRAD_MAX_S else "") + f"; {dt:.1f} s)",
                      flush=True)
                torch.cuda.empty_cache()
    return rows


def wkv6_bwd_at_train_shape(torch, wkv6_kernel, plain_bwd, bwd_agreement, seed: int) -> dict:
    """The backward kernel at rwkv6-3b's training microbatch (2 x 2048, 40
    heads of 64, bf16, log_w -exp(N(0, 1)), no state): its time by events
    and each launch's (the states pass, the carries, the chunk pass, du's
    sum) by the profiler, its bound (with the operations' counts beside it),
    what each pass takes on the card, the plain version's time (f32, on the
    card), the forward kernel's time on the same inputs, and the agreement
    with the plain version in float64.  No PyTorch call computes this
    gradient."""
    from repro_torch.kernels.wkv6.ref import CHUNK

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 18)
    B, S, H, K = TRAIN_GLOBAL_BATCH // TRAIN_MICROBATCHES, TRAIN_SEQ, 40, 64
    args = wkv6_bwd_inputs(torch, gen, B, S, H, K, None, False, torch.bfloat16)
    r, k, v, lw, u, s0, dy, ds = args
    t_bound, bound_by = wkv6_bwd_bound(B, S, H, K, 2, 2, False)
    counts = wkv6_bwd_counts(B, S, H, K, 2, 2, False, CHUNK)
    got = wkv6_kernel.launch_bwd(*args)
    agree = bwd_agreement(got, *plain_bwd(*args, dtype=torch.float64, with_scales=True))
    row = {"shape": [B, S, H, K], "dtype": "bf16",
           "ms": device_ms(torch, lambda: wkv6_kernel.launch_bwd(*args), reps=10),
           "plain_ms": device_ms(torch, lambda: plain_bwd(*args), reps=1, warmup=0),
           "bound_ms": t_bound, "bound_by": bound_by, "counts": counts, "library_ms": None, "agreement": agree,
           "forward_ms": device_ms(torch, lambda: wkv6_kernel.launch(r, k, v, lw, u, None), reps=10),
           "launch_ms": launch_times(torch, lambda: wkv6_kernel.launch_bwd(*args), "wkv6_bwd", reps=20),
           "segments": wkv6_kernel.bwd_segments(S), "segment_tokens": wkv6_kernel.BWD_SEGMENT,
           "info": {name: wkv6_kernel.bwd_library_info(torch.bfloat16, K, chunks)
                    for name, chunks in (("chunks", True), ("states", False))},
           "work_mib": wkv6_kernel.bwd_work_floats(B, S, H, K) * 4 / 2**20}
    print(f"  wkv6 backward at {RWKV_ARCH}'s training microbatch {row['shape']} bf16: kernel {row['ms']:.3f} ms  "
          f"bound {t_bound:.3f} ms ({bound_by}; operations {counts['ops_ms']:.3f}: split TF32 "
          f"{counts['tensor_ms']:.3f}, CUDA cores {counts['cuda_core_ms']:.3f}; the f32 walk's count "
          f"{counts['walk_ops_ms']:.3f})  plain {row['plain_ms']:.1f} ms  library none  forward "
          f"{row['forward_ms']:.3f} ms  workspace {row['work_mib']:.0f} MiB  {row['segments']} segments of "
          f"{row['segment_tokens']}  max_abs_err {agree['max_abs_err']:.3g}, worst/limit {agree['worst']:.3g}, "
          f"rel {agree['rel']:.3g}", flush=True)
    print("    launches: " + "  ".join(f"{name.split('<')[0]} {ms:.3f} ms" for name, ms in row["launch_ms"].items())
          + "; " + ", ".join(f"{n} {i['registers']} registers, {i['smem']} B shared, {i['blocks_per_sm']} "
                              f"blocks an SM, {i['spill_bytes']} B spilled" for n, i in row["info"].items()),
          flush=True)
    del args, r, k, v, lw, u, dy, got
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 14: the flash backward kernel against its plain version
# ---------------------------------------------------------------------------

# (causal, window) of phase 14's cases; (Sq = Sk) lengths, 200 and 1000
# ragged against the kernels' 64-row and 32-column tiles
FLASH_BWD_MASKS = ((True, 0), (True, 100), (False, 0), (False, 100))
FLASH_BWD_LENGTHS = (128, 200, 1000, 2048)
# (softcap, q multiplier): q scaled by 32 and 64 puts the scores at several
# times the cap, where the cap's derivative 1 - (s/c)^2 is far from 1 (at
# q x 1 the scores are about N(0, 1) and the derivative is within 1e-3 of 1)
FLASH_BWD_CAPS = ((0.0, 1), (50.0, 1), (50.0, 32), (50.0, 64))
# starcoder2-3b's training shape: (microbatch, S, heads, kv heads, head dim)
TRAIN_ARCH = "starcoder2-3b"
TRAIN_SEQ = 2048
TRAIN_GLOBAL_BATCH = 8
TRAIN_MICROBATCHES = 4
TRAIN_STEPS = 6
TRAIN_DOCS = 1500


def flash_bwd_bound(B: int, S: int, H: int, Hkv: int, D: int, causal: bool, window: int) -> tuple:
    """(bound_ms, bound_by, flops): the gradient's five products (s, dp,
    dq, dk, dv: 10 D FLOPs a pair and head) against the bf16 peak; q, k,
    v, dout, out read and dq, dk, dv written once (bf16) and the forward's
    lse read (f32).  The kernel's recomputed s and dp and dq's second
    product (16 D issued a pair) are not counted."""
    flops = 10.0 * D * unmasked_pairs(S, S, causal, window) * B * H
    nbytes = 2 * (4 * B * S * H * D + 4 * B * S * Hkv * D) + 4 * B * S * H
    t_ops = flops / BF16_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")) + (flops,)


def flash_bwd_matrix(torch, flash_kernel, plain_bwd, attention_ref, bwd_agreement, bwd_exact_agreement,
                     fails: Failures, seed: int) -> list:
    """Phase 14: dq, dk, dv of the backward kernel (kernel.launch_bwd, after
    the forward kernel's output and row statistics) against flash_attention_bwd_plain in
    float64 given the same output, within ref.BWD_TOL, and against the
    exact gradient (autograd of attention_ref in f32; dv only where q is
    scaled) within ref.BWD_EXACT_REL, on the same bf16 inputs, over
    FLASH_BWD_MASKS, FLASH_BWD_CAPS (q scaled so the softcap's derivative
    matters) and FLASH_BWD_LENGTHS; each case run twice and required to be
    bitwise equal."""
    gen = torch.Generator(device=torch.device("cuda"))
    gen.manual_seed(seed)
    rows = []
    for S in FLASH_BWD_LENGTHS:
        t0 = time.perf_counter()
        n_cases = bad = 0
        worst = {"max_abs_err": 0.0, "worst": 0.0, "rel": 0.0}
        worst_ref = {"rel": 0.0}
        B, Hkv = (1, 2) if S >= 1000 else (2, 2)
        for D in flash_kernel.BWD_HEAD_DIMS:
            for G in (1, 12):
                q0 = torch.randn(B, S, Hkv * G, D, device="cuda", generator=gen).to(torch.bfloat16)
                k, v = (torch.randn(B, S, Hkv, D, device="cuda", generator=gen).to(torch.bfloat16)
                        for _ in range(2))
                dout = torch.randn(B, S, Hkv * G, D, device="cuda", generator=gen).to(torch.bfloat16)
                for causal, window in FLASH_BWD_MASKS:
                    for cap, q_mul in FLASH_BWD_CAPS:
                        kw = dict(causal=causal, window=window, scale=D ** -0.5, logit_softcap=cap)
                        q = q0 * q_mul
                        out, lse = flash_kernel.launch(q, k, v, **kw, with_lse=True)
                        a = flash_kernel.launch_bwd(q, k, v, out, dout, lse, **kw)
                        b = flash_kernel.launch_bwd(q, k, v, out, dout, lse, **kw)
                        want = plain_bwd(q.double(), k.double(), v.double(), dout.double(), out.double(), **kw)
                        ref = [t.float().requires_grad_() for t in (q, k, v)]
                        attention_ref(*ref, **kw).backward(dout.float())
                        torch.cuda.synchronize()
                        agree = bwd_agreement(a, want)
                        # saturated scores (q x 32, 64): only dv against the
                        # exact gradient, as in tests/test_torch_cuda.py
                        held = slice(None) if q_mul == 1 else slice(2, 3)
                        agree_ref = bwd_exact_agreement(a[held], [t.grad for t in ref][held])
                        same = all(bitwise_equal(torch, x, y) for x, y in zip(a, b))
                        worst = {x: max(worst[x], agree[x]) for x in worst}
                        worst_ref = {x: max(worst_ref[x], agree_ref[x]) for x in worst_ref}
                        n_cases += 1
                        label = f"S={S} D={D} G={G} causal={causal} window={window} softcap={cap} q*{q_mul}"
                        bad += not fails.check(
                            agree["ok"] and agree_ref["ok"] and same,
                            f"flash backward {label}: against float64 worst/limit {agree['worst']:.3g} rel "
                            f"{agree['rel']:.3g}; against autograd of attention_ref rel {agree_ref['rel']:.3g}; "
                            f"reruns bitwise equal: {same}")
                        del q, out, lse, a, b, want, ref
        dt = time.perf_counter() - t0
        rows.append({"S": S, "cases": n_cases, "failed": bad, **worst, "against_autograd": worst_ref,
                     "seconds": dt})
        print(f"  flash backward S={S:>5}: {n_cases - bad}/{n_cases} cases agree (against float64 given the "
              f"forward's output: max_abs_err {worst['max_abs_err']:.3g}, worst/limit {worst['worst']:.3g}, rel "
              f"{worst['rel']:.3g}; against autograd of attention_ref: rel {worst_ref['rel']:.3g}; reruns "
              f"bitwise equal; {dt:.1f} s)", flush=True)
        torch.cuda.empty_cache()
    return rows


# phase 14's timing shapes, each a training microbatch that uses the head
# dim: (label, arch, microbatch, S, causal, window); the heads, kv heads and
# head dim are the arch's (starcoder2-3b's 128, hubert's 80 and zamba2's
# shared blocks' 112 padded to 128, gemma3-4b's 256 on its local layers'
# window and its global layers')
FLASH_BWD_SHAPES = (
    ("starcoder2-3b", TRAIN_ARCH, 2, TRAIN_SEQ, True, 0),
    ("hubert-xlarge", "hubert-xlarge", 2, 4096, False, 0),
    ("zamba2-7b shared", "zamba2-7b", 2, 2048, True, 0),
    ("gemma3-4b local", "gemma3-4b", 2, 2048, True, 1024),
    ("gemma3-4b global", "gemma3-4b", 2, 2048, True, 0),
)


def flash_bwd_at_train_shapes(torch, flash_kernel, plain_bwd, bwd_agreement, seed: int) -> list:
    """The backward kernel at each of FLASH_BWD_SHAPES, no softcap, given
    the forward kernel's output and row statistics: its time and each
    launch's (dq, dkv, the sum of the heads' partials), its bound, the
    plain version's time (f32, on the card) and SDPA's backward on the same
    inputs (the library call; with a window, SDPA given the mask), with the
    agreement to the plain version; at the first shape also the forward's
    time with and without its statistics."""
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config

    gen = torch.Generator(device=torch.device("cuda"))
    gen.manual_seed(seed)
    rows = []
    for i, (label, arch, B, S, causal, window) in enumerate(FLASH_BWD_SHAPES):
        cfg = get_config(arch)
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q = torch.randn(B, S, H, D, device="cuda", generator=gen).to(torch.bfloat16)
        k, v = (torch.randn(B, S, Hkv, D, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(2))
        dout = torch.randn(B, S, H, D, device="cuda", generator=gen).to(torch.bfloat16)
        kw = dict(causal=causal, window=window, scale=D ** -0.5, logit_softcap=0.0)
        out, lse = flash_kernel.launch(q, k, v, **kw, with_lse=True)
        t_bound, bound_by, flops = flash_bwd_bound(B, S, H, Hkv, D, causal, window)
        got = flash_kernel.launch_bwd(q, k, v, out, dout, lse, **kw)
        agree = bwd_agreement(got, plain_bwd(q, k, v, dout, out, **kw))
        row = {"label": label, "arch": arch, "q": [B, S, H, D], "kv_heads": Hkv, "causal": causal, "window": window,
               "softcap": 0.0, "head_dim": D,
               "ms": device_ms(torch, lambda: flash_kernel.launch_bwd(q, k, v, out, dout, lse, **kw), reps=10),
               "plain_ms": device_ms(torch, lambda: plain_bwd(q, k, v, dout, out, **kw), reps=1, warmup=1),
               "bound_ms": t_bound, "bound_by": bound_by, "agreement": agree, "max_abs_err": agree["max_abs_err"]}
        if i == 0:
            row["forward_ms"] = device_ms(torch, lambda: flash_kernel.launch(q, k, v, **kw), reps=10)
            row["forward_lse_ms"] = device_ms(torch, lambda: flash_kernel.launch(q, k, v, **kw, with_lse=True),
                                              reps=10)
        # each launch's device ms: dq, dkv and the sum of the heads' partials
        row["launch_ms"] = launch_times(torch, lambda: flash_kernel.launch_bwd(q, k, v, out, dout, lse, **kw),
                                        "flash_bwd")
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        sdpa_kw = dict(is_causal=causal)
        if window:
            at = torch.arange(S, device="cuda")
            sdpa_kw = dict(attn_mask=(at[None] <= at[:, None]) & (at[:, None] - at[None] < window))
        try:
            o = F.scaled_dot_product_attention(qt, kt, vt, scale=kw["scale"], enable_gqa=True, **sdpa_kw)
            dot = dout.transpose(1, 2)
            row["library_ms"] = device_ms(torch, lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                                                             retain_graph=True), reps=10)
        except RuntimeError as e:
            row["library_ms"], row["library_note"] = None, f"SDPA's backward did not run here: {e}"[:200]
            o = None
        row["tflops"] = flops / (row["ms"] * 1e9)
        row["tflops_issued"] = row["tflops"] * 16 / 10  # s and dp in both launches, dq's product twice
        sdpa = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.3f} ms"
        print(f"  flash backward at {label}'s training shape q={row['q']} kv heads {Hkv} "
              f"{'causal' if causal else 'not causal'}{f' window {window}' if window else ''}: kernel "
              f"{row['ms']:.3f} ms ({row['tflops']:.1f} TFLOP/s of the bound's work)  bound {t_bound:.3f} ms "
              f"({bound_by}: the gradient's 10 D FLOPs a pair and head)  plain {row['plain_ms']:.3f} ms  SDPA "
              f"backward {sdpa}  max_abs_err {agree['max_abs_err']:.3g}, worst/limit {agree['worst']:.3g}, rel "
              f"{agree['rel']:.3g}", flush=True)
        print("    launches: " + "  ".join(f"{k} {v:.3f} ms" for k, v in row["launch_ms"].items()) + (
            f"; forward {row['forward_ms']:.3f} ms, with its statistics {row['forward_lse_ms']:.3f} ms"
            if i == 0 else ""), flush=True)
        rows.append(row)
        del q, k, v, dout, out, lse, got, qt, kt, vt, o
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 15: training starcoder2-3b at full width
# ---------------------------------------------------------------------------


def zipf_documents(n_docs: int, vocab_words: int, seed: int) -> list:
    """Documents of 200-1200 words drawn Zipf (s = 1.1) over ``vocab_words``
    words, from ``seed``."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_words + 1, dtype=np.float64)
    p = ranks ** -1.1
    p /= p.sum()
    lengths = rng.integers(200, 1200, n_docs)
    words = rng.choice(vocab_words, size=int(lengths.sum()), p=p)
    out, at = [], 0
    for n in lengths:
        out.append(" ".join(f"t{w}" for w in words[at:at + n]))
        at += n
    return out


def train_flops(n_params: int, cfg, tokens: int, B: int, S: int) -> float:
    """Model FLOPs of one training step: 6 per parameter and token, and the
    attention's 4 D a pair and head forward, three times that with the
    backward (the recomputation of remat not counted); a layer's pairs are
    its mask's (causal, or all of them in a bidirectional layer; a local
    layer's window)."""
    pairs = sum(unmasked_pairs(S, S, kind != "bidir", cfg.window if kind == "local" else 0)
                for kind in cfg.layer_kinds())
    return 6.0 * n_params * tokens + 3 * 4.0 * cfg.resolved_head_dim * pairs * cfg.n_heads * B


class BackwardProbe:
    """Wraps ``ops._backward`` while the training steps run.  Of each
    step's calls, the one numbered ``pick(step)`` keeps clones of its
    tensor arguments (a real layer's inputs and the gradient that reached
    it) and of the kernel's outputs; ``check`` holds them against the plain
    backward in float64 through ``judge(args, got)`` after the step (its
    activations freed).  The wrapped call still launches the kernel once
    and counts once."""

    def __init__(self, ops, pick, judge) -> None:
        self.ops, self.pick, self.judge = ops, pick, judge
        self.orig = ops._backward
        self.step = self.calls = 0
        self.held = None

    def __enter__(self):
        def record(*args):
            grads = self.orig(*args)
            if self.calls == self.pick(self.step):
                keep = [a.clone() if hasattr(a, "clone") else a for a in args]
                self.held = (keep, [g.clone() for g in grads], self.calls)
            self.calls += 1
            return grads

        self.ops._backward = record
        return self

    def __exit__(self, *exc):
        self.ops._backward = self.orig
        return False

    def check(self) -> dict:
        """The kept call of the step just run against the plain version;
        then the next step's calls count from 0."""
        if self.held is None:
            raise RuntimeError(f"step {self.step}: call {self.pick(self.step)} of the backward never came "
                               f"({self.calls} calls)")
        args, got, n = self.held
        agree = dict(self.judge(args, got), call=n)
        self.held = None
        self.step += 1
        self.calls = 0
        return agree

    def skip(self) -> dict:
        """A step with no call held: the next step's calls count from 0."""
        self.step += 1
        self.calls = 0
        return {}


def flash_judge(args, got) -> dict:
    """A flash backward call (``flash/ops._backward``'s arguments) against
    flash_attention_bwd_plain in float64 given the same output, under
    ref.BWD_TOL, beside SDPA's backward on the same inputs against the
    plain backward given SDPA's output (reported, not held)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash.ref import bwd_agreement, flash_attention_bwd_plain as plain_bwd

    q, k, v, out, _, dout, causal, window, scale, cap = args
    want = plain_bwd(q.double(), k.double(), v.double(), dout.double(), out.double(), causal=causal,
                     window=window, scale=scale, logit_softcap=cap)
    agree = dict(bwd_agreement(got, want), q=list(q.shape), kv_heads=k.shape[2])
    if window == 0 and cap == 0.0:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True)
        lib = [g.transpose(1, 2) for g in torch.autograd.grad(o, (qt, kt, vt), dout.transpose(1, 2))]
        lib_want = plain_bwd(q.double(), k.double(), v.double(), dout.double(),
                             o.detach().transpose(1, 2).double(), causal=causal, window=0, scale=scale)
        agree["library"] = bwd_agreement(lib, lib_want)
    return agree


def wkv6_judge(args, got) -> dict:
    """A WKV6 backward call (``wkv6/ops._backward``'s arguments: a real
    layer's bf16 r, k, v and u, its log_w across the clip's range, and the
    f32 gradient of y from the group norm) against wkv6_bwd_plain in
    float64 with its terms' magnitudes, under ref.BWD_TOL; the plain
    version in f32 on the same inputs read beside it (not held)."""
    import torch

    from repro_torch.kernels.wkv6.ref import bwd_agreement, wkv6_bwd_plain

    r, k, v, lw, u, s0, dy, ds = args
    want, scales = wkv6_bwd_plain(r, k, v, lw, u, s0, dy, ds, dtype=torch.float64, with_scales=True)
    plain = bwd_agreement(wkv6_bwd_plain(r, k, v, lw, u, s0, dy, ds), want, scales)
    return dict(bwd_agreement(got, want, scales), q=list(r.shape), log_w_range=[float(lw.min()), float(lw.max())],
                plain_f32={n: {x: p[x] for x in ("worst", "rel")} for n, p in plain["parts"].items()})


class GradWitness:
    """Wraps ``train/step.value_and_grad`` while the training steps run and
    holds each step's accumulated gradient, loss and metrics; ``read``,
    called after the step's clock, keeps the leaves (a stacked leaf's layers
    one by one, and an MoE leaf's experts one by one: each expert's slice of
    the expert stacks and its column of the router) that are not finite or
    are all zero, and lets the gradient go."""

    def __init__(self, step_module) -> None:
        self.mod = step_module
        self.orig = step_module.value_and_grad
        self.grads = None
        self.loss = self.metrics = None
        self.bad: list = []
        self.leaves = 0

    def __enter__(self):
        def wrapped(*a, **kw):
            out = self.orig(*a, **kw)
            self.loss, self.metrics, self.grads = out
            return out

        self.mod.value_and_grad = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.value_and_grad = self.orig
        return False

    @staticmethod
    def _parts(path: str, g):
        """(rows, names): one row a layer of a stacked leaf, and one a layer
        and expert of an MoE leaf."""
        stacked = path.startswith(("groups.", "shared."))  # layers, or zamba2's shared blocks
        g = g if stacked else g[None]
        leaf = path.split(".")[-1]
        if ".moe." in path and leaf == "router":
            g = g.transpose(-1, -2)  # (layers, experts, d)
        if ".moe." in path and (leaf == "router" or leaf.startswith("w_")):
            rows = g.reshape(g.shape[0] * g.shape[1], -1)
            return rows, [f"{path}[{r}][expert {e}]" for r in range(g.shape[0]) for e in range(g.shape[1])]
        return g.reshape(g.shape[0], -1), [f"{path}[{r}]" for r in range(g.shape[0])] if stacked else [path]

    def read(self) -> None:
        import torch

        flags, names = [], []
        for path, g in self.grads.items():
            parts, part_names = self._parts(path, g)
            flags.append(torch.isfinite(parts).all(1) & (parts != 0).any(1))
            names += part_names
        ok = torch.cat(flags).cpu().tolist()
        self.grads = None
        self.leaves = len(names)
        self.bad = [n for n, f in zip(names, ok) if not f]


def zamba2_train_flops(n_params: int, cfg, tokens: int, B: int, S: int) -> float:
    """Model FLOPs of one zamba2 training step: 6 per parameter and token,
    and each shared invocation's causal attention, 12 D a pair and head
    with the backward (the SSD's products and remat not counted)."""
    return (6.0 * n_params * tokens
            + 3 * 4.0 * cfg.resolved_head_dim * unmasked_pairs(S, S, True, 0) * cfg.n_heads * B
            * shared_invocations(cfg))


def layer_calls(cfg) -> tuple:
    """The kernel's calls in one forward: (in the repeats, which remat
    recomputes; in the remainder), one a layer."""
    (pattern, repeats), remainder = cfg.scan_groups()
    return repeats * len(pattern), len(remainder)


def shared_calls(cfg) -> tuple:
    """zamba2's flash calls in one forward: one a shared invocation, (in the
    repeats, in the remainder)."""
    from repro_torch.models.transformer import _shared_layout

    (_, repeats), _ = cfg.scan_groups()
    per_step, rem = _shared_layout(cfg)
    return repeats * per_step, rem


def spread_mamba2_inits(torch, model, gen) -> None:
    """a_log, dt_bias, conv_b and norm drawn as Mamba2 publishes them
    (phase 21's draw)."""
    from repro_torch.models import mamba2

    mamba2.spread_zero_inits_(model.named_parameters(), gen)


def rwkv6_train_flops(n_params: int, cfg, tokens: int, B: int, S: int) -> float:
    """Model FLOPs of one rwkv6 training step: 6 per parameter and token,
    and the WKV's two state products (4 K^2 a token and head forward),
    three times that with the backward: 12 K^2 a token, head and layer
    (the recomputation of remat not counted)."""
    K = cfg.ssm.head_size
    return 6.0 * n_params * tokens + 12.0 * K * K * (cfg.d_model // K) * tokens * cfg.n_layers


def moe_train_flops(n_params: int, cfg, tokens: int, B: int, S: int) -> float:
    """Model FLOPs of one MoE training step over its active parameters:
    ``train_flops`` without the (E - K) / E of the expert stacks that a
    token does not run."""
    m = cfg.moe
    stacks = 3 * m.n_experts * cfg.d_model * m.d_ff_expert * cfg.n_layers
    return train_flops(int(n_params - stacks * (m.n_experts - m.top_k) / m.n_experts), cfg, tokens, B, S)


# What phases 15, 18, 20 and 23-25 train, and what each watches: the kernel ops
# whose forward and backward launches a step are counted, the names of the
# device kernels of its forward and of its backward in a trace, the
# probe's judge, the model FLOPs, what is drawn after the weights
# (``prepare``), the kernel's calls a forward (``calls``, one a layer
# unless named), AdamW's peak rate, and where the card cannot hold the
# whole model, the layers kept and the optimizer state's type.  rwkv6 takes AdamWConfig's own default peak: at the
# JAX launcher's 3e-3 its drawn weights' first step (gradient norm ~4e4)
# doubles the loss and six steps end above the first even through the
# exact (float64) WKV6 backward, so the check failed a right gradient;
# at 3e-4 that backward's last loss is below its first, and so is the
# kernel's at two seeds with dy nudged by 2^-20 either way
# (scripts/wkv6_train_sensitivity.py).
TRAIN_CASES = {
    "flash": dict(arch=TRAIN_ARCH, ops="repro_torch.kernels.flash.ops",
                  fwd_parts=("flash_fwd_kernel", "flash_fwd_wgmma_kernel"),
                  bwd_parts=("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dkv_sum_kernel"),
                  judge=flash_judge, flops=train_flops, lr_peak=3e-3),
    "wkv6": dict(arch="rwkv6-3b", ops="repro_torch.kernels.wkv6.ops",
                 fwd_parts=("wkv6_chunks", "wkv6_states", "wkv6_carry"),
                 bwd_parts=("wkv6_bwd_states", "wkv6_bwd_carry", "wkv6_bwd_chunks", "wkv6_bwd_du"),
                 judge=wkv6_judge, flops=rwkv6_train_flops, prepare=spread_rwkv_zero_inits, lr_peak=3e-4),
    # dbrx-132b at one layer (one whole period of its pattern): the port's
    # training keeps bf16 weights, f32 gradient accumulators and f32 master
    # weights, and bf16 gradients until they are added in, 12 bytes a
    # parameter, and AdamW's m and v, 8 more in f32 or 2 in int8.  One layer
    # with the embedding and head is 4.49 B parameters: 90 GB with f32
    # state, 63 GB with int8 state; two layers are 7.75 B, 109 GB.  Its
    # peak rate is 1e-4: at the launcher's 3e-3 the router sends every
    # choice to four experts by step 2 and the loss reaches nan by step 4,
    # and at 3e-4 the loss falls but experts go without a token in two of
    # the six steps (scripts/moe_train_rates.py)
    "moe": dict(arch="dbrx-132b", ops="repro_torch.kernels.flash.ops",
                fwd_parts=("flash_fwd_kernel", "flash_fwd_wgmma_kernel"),
                bwd_parts=("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dkv_sum_kernel"),
                judge=flash_judge, flops=moe_train_flops, lr_peak=1e-4, layers=1,
                state_dtype="int8"),
    # hubert-xlarge on the reference's train_4k length, on HuBERT's masked
    # unit prediction (``hubert_batches``), with f32 AdamW state (0.946 B
    # parameters, 19 GB) at AdamWConfig's own peak rate
    "hubert": dict(arch="hubert-xlarge", ops="repro_torch.kernels.flash.ops",
                   fwd_parts=("flash_fwd_kernel", "flash_fwd_wgmma_kernel"),
                   bwd_parts=("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dkv_sum_kernel"),
                   judge=flash_judge, flops=train_flops, lr_peak=3e-4, data="frames", seq=4096,
                   probe_steps=(0, TRAIN_STEPS - 1)),
    # gemma3-4b as dbrx trains: int8 AdamW moments, 14 bytes a parameter;
    # every layer if ``train_gib``'s reckoning fits max_gib, else the whole
    # periods of its 5:1 local:global pattern that do; AdamWConfig's own
    # peak rate: at the launcher's 3e-3 the loss fell for three steps and
    # then rose to 670 (12.47 -> 11.70 -> 40.5 -> 670 as the warmup passed
    # 1.2e-3; NVIDIA H100 80GB HBM3, 700 W)
    "gemma3": dict(arch="gemma3-4b", ops="repro_torch.kernels.flash.ops",
                   fwd_parts=("flash_fwd_kernel", "flash_fwd_wgmma_kernel"),
                   bwd_parts=("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dkv_sum_kernel"),
                   judge=flash_judge, flops=train_flops, lr_peak=3e-4, state_dtype="int8",
                   max_gib=72.0, probe_steps=(0, TRAIN_STEPS - 1)),
    # zamba2-7b as gemma3-4b trains, over whole scan steps (6 Mamba2 layers
    # and one shared invocation, the two shared blocks alternating): the
    # flash backward at head dim 112 once a shared invocation and
    # microbatch; its a_log, dt_bias, conv_b and norm drawn as phase 21
    # draws them.  Its peak rate is 1e-5: at 3e-4, 1e-4 and 3e-5 the loss
    # fell for two to four steps and then rose (to 29.9 at 3e-4, whose last
    # step's gradient was nan), at 1e-5 it fell at every step
    # (scripts/zamba2_train_rates.py; NVIDIA H100 80GB HBM3, 700 W).  The
    # reckoning adds ``act_gib`` for what train_gib leaves out and zamba2
    # holds: the recomputed step's Mamba2 activations (the SSD's f32 chunk
    # matrices, states and inputs, the conv's partial sums; 48 layers
    # reckoned at 59.8 GiB without them peaked at 73.3 GiB on that card)
    "zamba2": dict(arch="zamba2-7b", ops="repro_torch.kernels.flash.ops",
                   fwd_parts=("flash_fwd_kernel", "flash_fwd_wgmma_kernel"),
                   bwd_parts=("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dkv_sum_kernel"),
                   judge=flash_judge, flops=zamba2_train_flops, prepare=spread_mamba2_inits, calls=shared_calls,
                   lr_peak=1e-5, state_dtype="int8", max_gib=72.0, act_gib=14.0,
                   probe_steps=(0, TRAIN_STEPS - 1)),
}


def train_gib(cfg, state_dtype: str, microbatch: int, seq: int) -> float:
    """The training peak reckoned before the model is built: 12 bytes a
    parameter (bf16 weights, bf16 gradients until they are added in, f32
    accumulators and master weights), AdamW's moments (8 bytes in f32, 2
    in int8), and the loss's working set over a microbatch's logits (bf16
    logits, their f32 copy, the f32 temporary of logsumexp's exp and the
    f32 and bf16 gradients: 16 bytes a logit); the activations remat keeps
    (a layer's input each, one layer's recomputed) are left out."""
    from repro_torch.models.common import param_count
    from repro_torch.models.transformer import model_defs

    per = 12 + (2 if state_dtype == "int8" else 8)
    return (param_count(model_defs(cfg)) * per + 16 * microbatch * seq * cfg.vocab_size) / 2**30


HUBERT_UNITS = 500      # HuBERT's k-means units (arXiv:2106.07447 §IV): the labels' classes
HUBERT_MASK_P = 0.08    # a frame starts a masked span with this probability
HUBERT_MASK_SPAN = 10   # frames a span


def hubert_batches(torch, cfg, seq: int, seed: int):
    """batch(step) of TRAIN_GLOBAL_BATCH utterances of ``seq`` frames drawn
    on the card from ``seed``: frames N(0, 1) in d_model, ``labels`` the
    nearest of HUBERT_UNITS fixed centroids drawn from the seed (HuBERT's
    k-means units, so the loss can fall), and ``label_mask`` HuBERT's span
    mask: each frame starts a span of HUBERT_MASK_SPAN masked frames with
    probability HUBERT_MASK_P; the loss counts the masked frames."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 7)
    centroids = torch.randn(HUBERT_UNITS, cfg.d_model, device="cuda", generator=gen)
    half_sq = 0.5 * (centroids * centroids).sum(1)

    def batch(step: int) -> dict:
        frames = torch.randn(TRAIN_GLOBAL_BATCH, seq, cfg.d_model, device="cuda", generator=gen)
        labels = (frames @ centroids.T - half_sq).argmax(-1).to(torch.int32)  # the nearest centroid
        starts = (torch.rand(TRAIN_GLOBAL_BATCH, seq, device="cuda", generator=gen) < HUBERT_MASK_P).int()
        ends = torch.nn.functional.pad(starts.cumsum(1), (HUBERT_MASK_SPAN, 0))[:, :seq]
        return {"frames": frames, "labels": labels, "label_mask": starts.cumsum(1) - ends > 0}

    return batch


def train_path(torch, case: str, fails: Failures, seed: int, record: dict) -> dict:
    """Phases 15, 18, 20 and 23-25.  ``TRAIN_CASES[case]``'s arch at its published
    config (bf16, weights drawn from ``seed``; the tensors rwkv6 and zamba2
    initialise to constants drawn too, the case's ``prepare``), trained TRAIN_STEPS
    steps through launch/train.py's model and step: data from the port's
    pipeline over Zipf documents from ``seed`` packed at TRAIN_SEQ, global
    batch TRAIN_GLOBAL_BATCH in TRAIN_MICROBATCHES microbatches, remat on,
    the JAX package's launch/train.py AdamWConfig at the case's peak
    rate with f32 state (int8 state, said so, if the card cannot hold
    f32).  Checks: finite loss that falls from the first step to the last, the kernel's backward launches =
    its calls a forward x microbatches a step and its forward twice that (remat), no
    plain backward, every leaf (each layer of a stacked one) a finite,
    nonzero gradient each step (GradWitness), and one backward kernel call
    a step (a real layer's inputs and gradient) within its ref.BWD_TOL of
    the plain backward in float64 (BackwardProbe).  Per step, each under
    the profiler: ms, tokens/s, the model-FLOP share of the card's bf16
    peak, peak memory, the card's idle share and the kernels' share of
    device time."""
    import dataclasses
    import gc
    import importlib

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import PipelineConfig, ShardedLoader, build_dataset
    from repro_torch.launch.train import batch_on, build_model
    from repro_torch.train import step as step_module
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.step import TrainSpec, make_train_step

    spec_ = TRAIN_CASES[case]
    arch, kops = spec_["arch"], importlib.import_module(spec_["ops"])
    kname = spec_["ops"].split(".")[-2]  # the kernel's package: flash, wkv6
    seq = spec_.get("seq", TRAIN_SEQ)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    cuts = []
    layers = spec_.get("layers")
    if spec_.get("max_gib"):
        period, mb = len(cfg.layer_pattern), TRAIN_GLOBAL_BATCH // TRAIN_MICROBATCHES
        act = spec_.get("act_gib", 0.0)
        reckon = [(n, train_gib(dataclasses.replace(cfg, n_layers=n), spec_["state_dtype"], mb, seq) + act)
                  for n in range(cfg.n_layers, 0, -1) if n == cfg.n_layers or n % period == 0]
        layers, gib = next(((n, g) for n, g in reckon if g <= spec_["max_gib"]), reckon[-1])
        print(f"  reckoned peak at {cfg.n_layers} layers: {reckon[0][1]:.1f} GiB (14 bytes a parameter with "
              f"{spec_['state_dtype']} moments and the loss's logits over a {mb} x {seq} microbatch"
              + (f", and {act:g} GiB of a recomputed step's activations" if act else "") + "), limit "
              f"{spec_['max_gib']:g} GiB: {layers} layers ({gib:.1f} GiB)", flush=True)
        if layers == cfg.n_layers:
            layers = None
    if layers:
        cuts.append(f"{layers} of {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    print(f"  {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the model "
          f"(the models before it are freed)", flush=True)
    t0 = time.perf_counter()
    if spec_.get("data") == "frames":
        next_batch = hubert_batches(torch, cfg, seq, seed)
        print(f"  data: {TRAIN_GLOBAL_BATCH} utterances of {seq} frames a step drawn on the card, labels the "
              f"nearest of {HUBERT_UNITS} fixed centroids, spans of {HUBERT_MASK_SPAN} frames masked from starts "
              f"at p = {HUBERT_MASK_P}", flush=True)
    else:
        docs = zipf_documents(TRAIN_DOCS, cfg.vocab_size - 8, seed)
        ds = build_dataset(docs, PipelineConfig(seq_len=seq, min_doc_tokens=8, vocab_size=cfg.vocab_size,
                                                device="cuda"))
        loader = ShardedLoader(ds, global_batch=TRAIN_GLOBAL_BATCH, seed=seed)
        print(f"  data: {len(docs)} documents, {ds.n_tokens:,} tokens packed in {len(ds)} rows of {seq}, "
              f"vocab {ds.vocab.size:,} (of the model's {cfg.vocab_size:,}) in {time.perf_counter() - t0:.1f} s",
              flush=True)

        def next_batch(step: int) -> dict:
            return batch_on(loader, step, torch.device("cuda"))
    spec = TrainSpec(microbatches=TRAIN_MICROBATCHES, remat=True)
    report: dict = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
                    "vocab": cfg.vocab_size, "seq": seq, "global_batch": TRAIN_GLOBAL_BATCH,
                    "microbatches": TRAIN_MICROBATCHES, "remat": True, "cuts": cuts}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, torch.device("cuda"), seed)
    if spec_.get("prepare"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + 1)
        spec_["prepare"](torch, model, gen)
    params = model.params
    n_params = model.n_params()
    state_dtype = spec_.get("state_dtype", "f32")
    if state_dtype != "f32":
        cuts.append(f"optimizer state {state_dtype} (f32 does not fit: TRAIN_CASES)")
    opt_cfg = AdamWConfig(lr_peak=spec_["lr_peak"], warmup_steps=10, total_steps=TRAIN_STEPS,
                          state_dtype=state_dtype)
    try:
        opt_state = adamw_init(params, state_dtype)
    except torch.cuda.OutOfMemoryError:
        state_dtype = "int8"
        gc.collect()
        torch.cuda.empty_cache()
        print("  the card cannot hold f32 AdamW state beside the model: int8 state "
              "(AdamWConfig.state_dtype='int8')", flush=True)
        opt_cfg = AdamWConfig(lr_peak=spec_["lr_peak"], warmup_steps=10, total_steps=TRAIN_STEPS,
                              state_dtype="int8")
        opt_state = adamw_init(params, state_dtype)
        report["cuts"].append("optimizer state int8 (f32 did not fit)")
    report.update(n_params=n_params, state_dtype=state_dtype)
    step_fn = make_train_step(model, opt_cfg, spec)
    torch.cuda.synchronize()
    print(f"  {arch}: {n_params:,} parameters and {state_dtype} AdamW state on the card in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size} "
          f"({'; '.join(cuts) if cuts else 'nothing cut'})", flush=True)
    remat_calls, rem_calls = spec_.get("calls", layer_calls)(cfg)
    tokens = TRAIN_GLOBAL_BATCH * seq
    unit = "frames" if spec_.get("data") == "frames" else "tokens"
    flops = spec_["flops"](n_params, cfg, tokens, TRAIN_GLOBAL_BATCH, seq)
    steps = []
    # one call a step held against the plain backward, a different layer
    # and microbatch each step
    per_step = (remat_calls + rem_calls) * TRAIN_MICROBATCHES
    probed = spec_.get("probe_steps", range(TRAIN_STEPS))
    probe = BackwardProbe(kops, lambda s: s * per_step // TRAIN_STEPS if s in probed else -1, spec_["judge"])
    witness = GradWitness(step_module)
    path_check = {"calls": 0, "max_abs_err": 0.0, "worst": 0.0, "rel": 0.0}
    kops.reset_launches()
    for s in range(TRAIN_STEPS):
        batch = next_batch(s)
        before = (kops.LAUNCHES, kops.BWD_LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        held = {}

        def one():
            held["t0"] = time.perf_counter()
            held["out"] = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            held["t1"] = time.perf_counter()

        # each step under the profiler (CUDA activity only); its wall time
        # is taken inside the profiled window, without the profiler's start
        # and stop; the witness reads the gradient after the step's clock
        with probe, witness:
            events = trace_card(torch, one)
        witness.read()
        params, opt_state, metrics = held["out"]
        agree = probe.check() if s in probed else probe.skip()
        if agree:
            path_check["calls"] += 1
            path_check.update({x: max(path_check[x], agree[x]) for x in ("max_abs_err", "worst", "rel")})
            fails.check(agree["ok"], f"train step {s}: {kname} backward call {agree['call']} (shape {agree['q']}) "
                                     f"disagrees with the plain backward in float64 ({agree})")
        fails.check(not witness.bad and witness.leaves > 0,
                    f"train step {s}: {len(witness.bad)} of {witness.leaves} leaves have a zero or non-finite "
                    f"gradient: {witness.bad[:8]}")
        aux = {}
        if cfg.moe is not None:
            # lb_loss and router_z finite, and in the loss: the step's loss
            # is the nll plus 0.01 lb_loss + router_z_loss router_z (means
            # over the microbatches)
            aux = {k: float(witness.metrics[k]) for k in ("loss", "lb_loss", "router_z")}
            total = float(witness.loss)
            want = aux["loss"] + 0.01 * aux["lb_loss"] + cfg.moe.router_z_loss * aux["router_z"]
            fails.check(all(np.isfinite(list(aux.values()))) and abs(total - want) <= 1e-5 * abs(total),
                        f"train step {s}: aux losses {aux} not finite or not in the loss {total}")
        dt = held["t1"] - held["t0"]
        loss = float(metrics["loss"])
        fwd, bwd = kops.LAUNCHES - before[0], kops.BWD_LAUNCHES - before[1]
        row = {"step": s, "loss": loss, "ms": dt * 1e3, "tokens_per_s": tokens / dt,
               "model_flop_share_of_bf16_peak": flops / dt / BF16_OPS_PER_S,
               "grad_norm": float(metrics["grad_norm"]), "lr": float(metrics["lr"]),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "fwd_launches": fwd, "bwd_launches": bwd,
               "leaves_with_gradient": witness.leaves - len(witness.bad), "leaves": witness.leaves,
               "bwd_check": agree, **({"nll": aux["loss"], "lb_loss": aux["lb_loss"],
                                       "router_z": aux["router_z"]} if aux else {})}
        line = ""
        total = sum(device_us(ev) for ev in events) / 1e3 if events is not None else 0.0
        if total > 0:
            row["fwd_launch_ms"], row["bwd_launch_ms"] = (
                {part: sum(device_us(ev) for ev in events if part in ev.key) / 1e3 for part in spec_[parts]}
                for parts in ("fwd_parts", "bwd_parts"))
            fwd_ms, bwd_ms = sum(row["fwd_launch_ms"].values()), sum(row["bwd_launch_ms"].values())
            top = sorted(((device_us(ev) / 1e3, ev.key) for ev in events if device_us(ev) > 0), reverse=True)[:6]
            row.update(device_ms=total, idle_share=max(0.0, 1 - total / row["ms"]), fwd_ms=fwd_ms,
                       bwd_ms=bwd_ms, fwd_share=fwd_ms / total, bwd_share=bwd_ms / total,
                       top=[{"kernel": k[:90], "ms": ms} for ms, k in top])
            line = (f"  device {total:.1f} ms, card idle {100 * row['idle_share']:.1f}%, {kname} forward "
                    f"{100 * row['fwd_share']:.1f}% and backward {100 * row['bwd_share']:.1f}% of "
                    f"device time (backward launches: " + ", ".join(
                        f"{k} {v:.1f} ms" for k, v in row["bwd_launch_ms"].items()) + ")")
        steps.append(row)
        fails.check(bwd == (remat_calls + rem_calls) * TRAIN_MICROBATCHES,
                    f"train step {s}: {bwd} {kname} backward launches, not {remat_calls + rem_calls} x "
                    f"{TRAIN_MICROBATCHES}")
        fails.check(fwd == (2 * remat_calls + rem_calls) * TRAIN_MICROBATCHES,
                    f"train step {s}: {fwd} {kname} forward launches, not (2 x {remat_calls} + {rem_calls}) x "
                    f"{TRAIN_MICROBATCHES} (remat recomputes each repeat's forward, not the remainder's)")
        print(f"  step {s}: loss {loss:.4f}  {row['ms']:.1f} ms  {row['tokens_per_s']:.0f} {unit}/s  "
              f"model FLOPs {100 * row['model_flop_share_of_bf16_peak']:.1f}% of the bf16 peak (989 TFLOP/s)  "
              f"peak {row['peak_gib']:.1f} GiB  grad norm {row['grad_norm']:.3g}  lr {row['lr']:.2e}  " + (
                  f"lb_loss {aux['lb_loss']:.4f}  router_z {aux['router_z']:.4f}  " if aux else "") + f"{kname} "
              f"launches {fwd} forward, {bwd} backward; {row['leaves_with_gradient']}/{row['leaves']} leaves "
              f"with a finite nonzero gradient; " + (
                  f"backward call {agree['call']} against float64: worst/limit {agree['worst']:.3g}, rel "
                  f"{agree['rel']:.3g}" if agree else "no backward call held this step") + (
                  f" (SDPA's backward on its inputs: worst/limit {agree['library']['worst']:.3g}, rel "
                  f"{agree['library']['rel']:.3g})" if "library" in agree else "") + (
                  " (the plain backward in f32 on its inputs: worst/limit " + ", ".join(
                      f"{n} {p['worst']:.3g}" for n, p in agree["plain_f32"].items()) + ")"
                  if "plain_f32" in agree else "") + ";" + line, flush=True)
        del held
    losses = [r["loss"] for r in steps]
    fails.check(all(np.isfinite(losses)), f"train {arch}: non-finite loss {losses}")
    fails.check(losses[-1] < losses[0], f"train {arch}: the loss did not fall ({losses[0]:.4f} -> {losses[-1]:.4f})")
    fails.check(kops.PLAIN_BWD_CALLS == 0, f"train {arch}: the plain backward ran {kops.PLAIN_BWD_CALLS} times")
    report["steps"] = steps
    report["bwd_check"] = path_check
    report["launches"] = {"forward": kops.LAUNCHES, "backward": kops.BWD_LAUNCHES,
                          "plain_bwd": kops.PLAIN_BWD_CALLS}
    report["launches_by_dim"] = {"forward": dict(getattr(kops, "LAUNCHES_BY_DIM", {})),
                                 "backward": dict(getattr(kops, "BWD_LAUNCHES_BY_DIM", {}))}
    if steps[-1].get("top"):
        print("  costliest kernels of the last step: " + "; ".join(
            f"{t['kernel'][:48]} {t['ms']:.1f} ms" for t in steps[-1]["top"][:5]), flush=True)
    report["peak_gib"] = max(r["peak_gib"] for r in steps)
    print(f"  {arch} trained {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
          f"{np.median([r['ms'] for r in steps]):.1f} ms (median); peak memory {report['peak_gib']:.1f} GiB; "
          f"launches {report['launches']}; on {nvidia_smi_line()}", flush=True)
    record["train" if case == "flash" else f"train_{case}"] = report
    del model, params, opt_state, step_fn, next_batch
    gc.collect()
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 16: the training CLI with a failure and a restart
# ---------------------------------------------------------------------------


def cli_path(fails: Failures, record: dict, arch: str = TRAIN_ARCH) -> dict:
    """``python -m repro_torch.launch.train --arch ARCH --reduced --steps 40
    --ckpt-every 10 --fail-at 25`` on the card in a temporary directory: it
    must resume from step 20, finish at 40, and restore its final
    checkpoint bitwise equal to the state in memory."""
    import tempfile

    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--reduced", "--steps", "40",
           "--ckpt-every", "10", "--fail-at", "25"]
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=SRC)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + ["--ckpt-dir", os.path.join(tmp, "ckpt")], capture_output=True, text=True,
                              env=env, cwd=tmp, timeout=600)
        dt = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("[train] summary"):
            print("  " + line, flush=True)
    summary = {}
    if proc.returncode == 0 and lines and lines[-1].startswith("[train] summary "):
        summary = json.loads(lines[-1][len("[train] summary "):])
    ok = (proc.returncode == 0 and summary.get("resumed_from") == [20] and summary.get("final_step") == 40
          and summary.get("restores_bitwise") is True)
    fails.check(ok, f"launch.train with --fail-at 25: exit {proc.returncode}, summary "
                    f"{ {k: summary.get(k) for k in ('resumed_from', 'final_step', 'restores_bitwise')} }; "
                    f"stderr {proc.stderr[-2000:]}")
    losses = summary.get("losses") or [float("nan")]
    print(f"  {' '.join(cmd[1:])}: exit {proc.returncode} in {dt:.1f} s, resumed from {summary.get('resumed_from')}, "
          f"final step {summary.get('final_step')}, final checkpoint restores bitwise: "
          f"{summary.get('restores_bitwise')}, loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    record.setdefault("cli", {})[arch] = {"cmd": cmd, "returncode": proc.returncode, "seconds": dt, **summary}
    return record["cli"][arch]


# ---------------------------------------------------------------------------
# phase 22: hubert-xlarge, the audio encoder, at published width and depth
# ---------------------------------------------------------------------------

HUBERT_ARCH = "hubert-xlarge"
# (utterances, frames): 30 s of audio at 50 frames a second, and the
# reference's prefill_32k length (its dry run takes an audio "prefill")
HUBERT_SCENARIOS = {"a": (16, 1500), "b": (1, 32768)}


def hubert_breakdown(torch, model, batch: dict, kernel: str) -> dict:
    """One forward's device ms (``ranged_prefill``) split into flash (its
    kernel and the wrapper's pad copies to head dim 128 and back), the MLP
    (``mlp_block``: w_in, the exact gelu, w_out), the projections (the rest
    of ``attention_block``: q, k, v, o and RoPE) and the rest (norms,
    residual adds, the frontend and the head).  The flash kernel launches
    through its library, not through a PyTorch op, so no range's device
    time holds it (on the H100 the flash range read the pad copies alone):
    flash is its kernel's time and its range's."""
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.models import transformer

    parts = {"attention": (transformer, "attention_block"), "mlp": (transformer, "mlp_block"),
             "flash": (flash_ops, "flash_attention")}
    out = ranged_prefill(torch, parts, lambda: model(batch), kernel)
    if out:
        part = out["parts_ms"]
        out["flash_range_ms"], out["attention_range_ms"] = part["flash"], part["attention"]
        out["flash_ms"] += part["flash"]
        out["parts_ms"] = {"mlp": part["mlp"], "projections": part["attention"] - part["flash"]}
        out["rest_ms"] = out["device_ms"] - out["flash_ms"] - part["mlp"] - out["parts_ms"]["projections"]
    return out


def encoder_path(torch, flash_ops, plain, agreement, fails: Failures, seed: int, record: dict) -> tuple:
    """Phase 22: hubert-xlarge at its published width and depth (weights
    drawn on the card from ``seed``) through ``Model.forward`` under
    inference mode, for each of HUBERT_SCENARIOS on frames drawn from the
    seed: one flash launch a layer, not causal; every call of (a) and the
    first and last layers' calls of (b) held against the plain version; a
    rerun's logits bitwise equal; logits (B, S, 504) finite; the rerun's
    wall ms and frames/s; one forward's device ms by part
    (``hubert_breakdown``); then the flash kernel at each scenario's shape
    (``flash_at_shapes``: SDPA not causal computes the same function).
    Returns (flash launches, the timing rows)."""
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Model

    cfg = get_config(HUBERT_ARCH)
    n_layers = cfg.n_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model = Model(cfg).init_params(gen)
    torch.cuda.synchronize()
    n_params = model.n_params()
    print(f"  {HUBERT_ARCH}: {n_params:,} parameters drawn on the card in {time.perf_counter() - t0:.1f} s "
          f"({n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff}, {cfg.vocab_size} units; nothing cut)", flush=True)
    rec = flash_recorder(flash_ops, plain, agreement, fails)
    rec.hold = lambda label, n: label == "a" or n in (0, n_layers - 1)
    report: dict = {"arch": HUBERT_ARCH, "n_params": n_params, "layers": n_layers}
    flash_ops.reset_launches()
    with torch.inference_mode(), rec:
        for name, (B, S) in HUBERT_SCENARIOS.items():
            t_scenario = time.perf_counter()
            batch = {"frames": torch.randn(B, S, cfg.d_model, device="cuda", generator=gen)}
            outs, walls = [], []
            for run in ("checked", "timed"):
                rec.label = name
                rec.seen.clear()
                before = flash_ops.LAUNCHES
                with (contextlib.nullcontext() if run == "checked" else rec.paused()):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    logits, _ = model(batch)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t1)
                launched = flash_ops.LAUNCHES - before
                fails.check(launched == n_layers, f"{HUBERT_ARCH} ({name}, {run}): {launched} flash launches, "
                                                  f"not {n_layers}")
                outs.append(logits)
            fails.check(tuple(outs[0].shape) == (B, S, cfg.vocab_size) and bool(torch.isfinite(outs[0]).all()),
                        f"{HUBERT_ARCH} ({name}): logits {tuple(outs[0].shape)} not finite or not (B, S, V)")
            fails.check(bool(torch.equal(outs[0], outs[1])), f"{HUBERT_ARCH} ({name}): a rerun's logits differ")
            held = sum(st["calls"] for key, st in rec.stats.items() if key[0] == name)
            fails.check(held == (n_layers if name == "a" else 2),
                        f"{HUBERT_ARCH} ({name}): {held} flash calls held against the plain version")
            entry = {"batch": B, "frames": S, "forward_ms": walls[1] * 1e3, "checked_forward_ms": walls[0] * 1e3,
                     "frames_per_s": B * S / walls[1], "held_calls": held}
            report[name] = entry
            del outs, logits
            entry["seconds"] = time.perf_counter() - t_scenario
            print(f"  ({name}) {B} x {S} frames ({entry['seconds']:.0f} s): forward {entry['forward_ms']:.1f} ms, "
                  f"{entry['frames_per_s']:.0f} frames/s; {n_layers} flash launches a forward, not causal, "
                  f"{held} of them held against the plain version; a rerun's logits bitwise equal, finite",
                  flush=True)
    report["launches"] = flash_ops.LAUNCHES
    report["launches_by_dim"] = dict(flash_ops.LAUNCHES_BY_DIM)
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # where one forward's card time goes (these launches are not counted)
    for name, (B, S) in HUBERT_SCENARIOS.items():
        with torch.inference_mode():
            batch = {"frames": torch.randn(B, S, cfg.d_model, device="cuda", generator=gen)}
            report[name]["parts"] = hubert_breakdown(torch, model, batch, "flash_fwd")
        print_parts(name, report[name]["parts"], "forward")
    print(f"flash kernel at {HUBERT_ARCH}'s shapes (head dim 80, padded to 128; not causal):", flush=True)
    rows = flash_at_shapes(torch, flash_ops, plain, agreement, rec, fails)
    bad_calls = [k for k, st in rec.stats.items() if not st["ok"]]
    fails.check(not bad_calls, f"flash calls disagreeing with the plain version: {bad_calls}")
    print(f"  flash launches on the path: {report['launches']}; peak memory {report['peak_gib']:.1f} GiB", flush=True)
    record[f"serve_{HUBERT_ARCH}"] = report
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return report["launches"], rows


# ---------------------------------------------------------------------------
# phases 26 and 27: serving qwen2-vl-72b and starcoder2-15b; the one-card mesh
# ---------------------------------------------------------------------------


def vlm_inputs(torch, seed: int):
    """inputs(cfg, B, S) for serve_path: each request's positions 1 to
    VLM_GRID^2 hold an image's patch embeddings (the reference's stub
    frontend merges them by ``patch_mask``), drawn on the card from
    ``seed`` at the embedding table's scale; M-RoPE positions (3, B, S)
    give the image's patches (1, 1 + row, 1 + column) and every text token
    its index on all three axes (where decode goes on)."""
    def make(cfg, B: int, S: int) -> dict:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + 11)
        n = VLM_GRID * VLM_GRID
        embeds = torch.randn(B, S, cfg.d_model, device="cuda", generator=gen).mul_(cfg.vocab_size ** -0.5)
        mask = torch.zeros(B, S, dtype=torch.bool, device="cuda")
        mask[:, 1:1 + n] = True
        pos = torch.arange(S, dtype=torch.int32, device="cuda").repeat(3, 1)
        grid = torch.arange(n, dtype=torch.int32, device="cuda")
        pos[:, 1:1 + n] = torch.stack([torch.ones_like(grid), 1 + grid // VLM_GRID, 1 + grid % VLM_GRID])
        return {"patch_embeds": embeds.to(torch.bfloat16), "patch_mask": mask,
                "positions": pos[:, None].expand(3, B, S).contiguous()}

    return make


def mesh_path(torch, fails: Failures, seed: int, record: dict) -> dict:
    """The one-card DeviceMesh (launch/mesh.make_smoke_mesh: a one-process
    NCCL group from a HashStore) with the specs the JAX package's dry run
    installs for a prefill cell (``sharding.prefill_specs``: the hidden
    layout, and the MoE pins for an MoE arch), and a reduced forward and
    prefill of each of MESH_ARCHS with and without them: bitwise equal."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding
    from repro_torch.models import shardctx
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import Model

    started = not dist.is_initialized()
    mesh = mesh_mod.make_smoke_mesh()
    report = {"mesh": str(mesh), "backend": dist.get_backend()}
    try:
        for arch in MESH_ARCHS:
            cfg = reduced_config(get_config(arch))
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            model = Model(cfg).init_params(gen)
            toks = torch.randint(4, cfg.vocab_size, (4, 96), device="cuda", generator=gen, dtype=torch.int32)
            specs = sharding.prefill_specs(mesh, cfg)
            outs = []
            for installed in ({}, specs):
                with shardctx.installed(installed, mesh), torch.inference_mode():
                    logits, _ = model({"tokens": toks})
                    last, cache = model.prefill({"tokens": toks})
                outs.append([logits, last] + [t for _, t in tree_leaves(cache)])
            equal = all(bool(torch.equal(a, b)) for a, b in zip(*outs))
            fails.check(equal and len(outs[0]) == len(outs[1]),
                        f"mesh: reduced {arch}'s outputs differ with the one-device specs installed")
            report[arch] = {"specs": {k: list(v) for k, v in specs.items()}, "bitwise_equal": equal}
            print(f"  reduced {arch} on {mesh} ({report['backend']}): forward and prefill with "
                  f"{sorted(specs)} installed bitwise equal to without: {equal}", flush=True)
            del model
    finally:
        if started:
            dist.destroy_process_group()
    record["mesh"] = report
    return report


# ---------------------------------------------------------------------------
# phase 28: the dry run's reckoning against the card
# ---------------------------------------------------------------------------

# the reckoned peak against the card's max_memory_allocated over the step
RECKON_PEAK_TOL = 0.10
# one cell of each kind on both production meshes
RECKON_PRODUCTION = (("starcoder2-15b", "train_4k"), ("gemma2-9b", "prefill_32k"), ("zamba2-7b", "decode_32k"),
                     ("rwkv6-3b", "long_500k"))


def reckon_one_card(arch: str, cell, out_dir: str, probe=None) -> dict:
    """launch/dryrun.run_cell of ``arch`` at ``cell`` on the (1, 1) stand-in
    of the production axes, its record written to ``out_dir``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ProductionMesh

    return dryrun.run_cell(arch, cell, False, out_dir, probe=probe, tag="one_card",
                           mesh=ProductionMesh(("data", "model"), (1, 1)))


def card_prefill(torch, arch: str, B: int, S: int, kops, seed: int) -> dict:
    """One prefill of ``arch`` at full width on B x S tokens (weights as the
    model declares them, not drawn: the memory, the launches and the time
    do not depend on their values), after one to warm up: its kernel
    launches, the card's max_memory_allocated over it and its device ms."""
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import Model

    gc.collect()
    torch.cuda.empty_cache()
    model = Model(get_config(arch))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = torch.randint(4, model.cfg.vocab_size, (B, S), dtype=torch.int32, device="cuda", generator=gen)

    def prefill():
        with torch.inference_mode():
            out = model.prefill({"tokens": tokens})
        torch.cuda.synchronize()
        return out

    prefill()  # to warm up; its outputs are dropped
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = kops.LAUNCHES
    events = trace_card(torch, prefill)
    reading = {"launches": kops.LAUNCHES - before, "peak_bytes": torch.cuda.max_memory_allocated(),
               "device_ms": sum(device_us(ev) for ev in events) / 1e3 if events is not None else None}
    del model, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return reading


def reckoning_path(torch, fails: Failures, record: dict, train_report: dict, flash_ops, wkv6_ops, seed: int,
                   out_dir: str) -> dict:
    """Phase 28: launch/dryrun.run_cell reckons three one-card cells that
    earlier phases run, on the (1, 1) stand-in at each phase's own shape,
    and each is held against the card: phase 15's starcoder2-3b train step
    (its steps' readings), and gemma2-9b's and rwkv6-3b's prefill at (a)
    (run here once more).  Each kernel's calls equal the card's launches,
    the reckoned peak_device_bytes lies within RECKON_PEAK_TOL of
    max_memory_allocated over the step, and the reckoned bound, max(compute,
    memory) from the H100 SXM5 constants, is no greater than the step's
    device time.  Then one production cell of each kind on both meshes,
    with its trace time and terms."""
    import dataclasses

    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis

    report: dict = {"cells": [], "production": []}
    cells = [
        ("starcoder2-3b", ShapeCell("phase15_train", TRAIN_SEQ, TRAIN_GLOBAL_BATCH, "train"),
         {"microbatches": TRAIN_MICROBATCHES}, None),
        (SERVE_ARCH, ShapeCell("phase7_prefill_a", SERVE_SCENARIOS["a"][1], SERVE_SCENARIOS["a"][0], "prefill"),
         None, flash_ops),
        (RWKV_ARCH, ShapeCell("phase10_prefill_a", RWKV_SCENARIOS["a"][1], RWKV_SCENARIOS["a"][0], "prefill"),
         None, wkv6_ops),
    ]
    for arch, cell, probe, kops in cells:
        rec = reckon_one_card(arch, cell, out_dir, probe)
        row = analysis.analyze_record(rec, cell=cell)
        bound_ms = max(row.compute_s, row.memory_s) * 1e3
        calls = {k: v["calls"] for k, v in rec["ops"]["kernels"].items()}
        if kops is None:  # phase 15's steps after the first (the accumulators held)
            steps = train_report["steps"][1:]
            last = steps[-1]
            card = {"launches": {"flash_attention": last["fwd_launches"], "flash_attention_bwd": last["bwd_launches"]},
                    "peak_bytes": last["peak_gib"] * 2**30, "device_ms": last.get("device_ms"),
                    "steps_peak_gib": [r["peak_gib"] for r in steps]}
        else:
            reading = card_prefill(torch, arch, cell.global_batch, cell.seq_len, kops, seed)
            name = "flash_attention" if kops is flash_ops else "wkv6"
            card = dict(reading, launches={name: reading["launches"]})
        peak = rec["memory"]["peak_device_bytes"]
        entry = {"arch": arch, "cell": dataclasses.asdict(cell), "t_trace_s": rec["t_trace_s"], "calls": calls,
                 "card": card, "reckoned_peak_bytes": peak, "peak_ratio": peak / card["peak_bytes"],
                 "compute_ms": row.compute_s * 1e3, "memory_ms": row.memory_s * 1e3,
                 "memory_fused_ms": row.memory_fused_s * 1e3, "bound_ms": bound_ms,
                 "bound_over_device": bound_ms / card["device_ms"] if card["device_ms"] else None}
        report["cells"].append(entry)
        fails.check(calls == {k: float(v) for k, v in card["launches"].items()},
                    f"reckoning {arch} {cell.name}: kernel calls {calls} differ from the card's launches "
                    f"{card['launches']}")
        fails.check(abs(entry["peak_ratio"] - 1) <= RECKON_PEAK_TOL,
                    f"reckoning {arch} {cell.name}: reckoned peak {peak / 2**30:.2f} GiB is not within "
                    f"{RECKON_PEAK_TOL:.0%} of the card's {card['peak_bytes'] / 2**30:.2f} GiB")
        fails.check(card["device_ms"] is not None and bound_ms <= card["device_ms"],
                    f"reckoning {arch} {cell.name}: the reckoned bound {bound_ms:.1f} ms exceeds the device time "
                    f"{card['device_ms']} ms")
        device = "not measured" if card["device_ms"] is None else (
            f"{card['device_ms']:.1f} ms of device time (ratio {entry['bound_over_device']:.4f})")
        print(f"  {arch} {cell.name} ({cell.global_batch} x {cell.seq_len}; traced in {rec['t_trace_s']} s): "
              f"kernel calls {calls}, card {card['launches']}; peak reckoned {peak / 2**30:.2f} GiB, card "
              f"{card['peak_bytes'] / 2**30:.2f} GiB (ratio {entry['peak_ratio']:.4f}); bound {bound_ms:.1f} ms "
              f"(compute {entry['compute_ms']:.1f}, memory {entry['memory_ms']:.1f}, fused "
              f"{entry['memory_fused_ms']:.1f}) against {device}", flush=True)
    for arch, shape in RECKON_PRODUCTION:
        for multi_pod in (False, True):
            rec = dryrun.run_cell(arch, shape, multi_pod, out_dir)
            row = analysis.analyze_record(rec)
            entry = {"arch": arch, "shape": shape, "mesh": rec["mesh"], "t_trace_s": rec["t_trace_s"],
                     "peak_gb": row.peak_gb, "compute_s": row.compute_s, "memory_s": row.memory_s,
                     "memory_fused_s": row.memory_fused_s, "collective_s": row.collective_s,
                     "dominant": row.dominant}
            report["production"].append(entry)
            print(f"  {arch} {shape} on {rec['mesh']} (H100 SXM5 constants; traced in {rec['t_trace_s']} s): "
                  f"{row.peak_gb:.2f} GB a device, compute {row.compute_s:.4f} s, memory {row.memory_s:.4f} s "
                  f"(fused {row.memory_fused_s:.4f}), collective {row.collective_s:.4f} s: {row.dominant}",
                  flush=True)
    record["reckoning"] = report
    return report


# ---------------------------------------------------------------------------
# phase 29: the port's examples and command-line tools on the card
# ---------------------------------------------------------------------------

EXAMPLE_ROWS = 2_000_000  # the size examples/bigdata_sql.py's header names
EXAMPLE_SERVE = ["--full", "--batch", "4", "--prompt-len", "2048", "--new", "32"]
EXAMPLE_TRAIN_STEPS, EXAMPLE_TRAIN_FAIL = 75, 60
EXAMPLE_TRAIN = ["--full", "--steps", str(EXAMPLE_TRAIN_STEPS), "--fail-at-step", str(EXAMPLE_TRAIN_FAIL)]
EXAMPLE_TRAIN_RESTORE = 50  # the latest checkpoint at step 60 (one every 25 steps)
# the steps run: up to the failure, then again from the restored checkpoint
EXAMPLE_TRAIN_RUN = EXAMPLE_TRAIN_FAIL + EXAMPLE_TRAIN_STEPS - EXAMPLE_TRAIN_RESTORE
EXAMPLE_PROBE = ["starcoder2-3b", "train_4k", "phase29"]
# scripts/irlint.py --demo of the JAX package exits 1 (three lint warnings);
# tests/test_torch_examples.py holds the port's tool to it
IRLINT_DEMO_RC = 1
WEBLOG_RTOL = 1e-4  # float sums against float64


def load_file(rel: str):
    """A file of the repo's examples/ or scripts/ (neither is a package) as a
    module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(os.path.splitext(os.path.basename(rel))[0], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def weblog_oracle(tables: dict) -> list:
    """The results of examples/torch_bigdata_sql.py's 9 queries and 2
    MapReduce jobs, in their order, by numpy from its tables: lists of row
    tuples (a url as its dictionary code, its place among the sorted
    distinct urls; float sums in float64), the SUM of bytes an int wrapped
    to int32 as the engine wraps it (ROADMAP C5), and for the top-5 query
    ``{"limit": 5, "counts": {url: count}}``."""
    logs, servers, mirrors = tables["logs"], tables["servers"], tables["mirrors"]
    urls = logs["url"].tolist()
    code = {u: i for i, u in enumerate(sorted(set(urls)))}
    url = np.fromiter(map(code.__getitem__, urls), dtype=np.int64, count=len(urls))
    status, sid = logs["status"], logs["server_id"]
    latency = logs["latency"].astype(np.float64)

    def by_key(keys, *aggs) -> list:
        ks, inv = np.unique(keys, return_inverse=True)
        cols = []
        for how, v in aggs:
            if how == "count":
                cols.append(np.bincount(inv, minlength=len(ks)).tolist())
            elif how == "sum":
                cols.append(np.bincount(inv, weights=v, minlength=len(ks)).tolist())
            else:
                m = np.full(len(ks), -np.inf)
                np.maximum.at(m, inv, v)
                cols.append(m.tolist())
        return [tuple([k] + [c[i] for c in cols]) for i, k in enumerate(ks.tolist())]

    # the star join: each log row's server's region (ids unique)
    region = np.full(int(servers["id"].max()) + 1, -1, dtype=np.int64)
    region[servers["id"]] = servers["region"]
    r = region[sid]
    joined = r >= 0
    q0 = by_key(r[joined], ("count", None), ("sum", latency[joined]))
    # the mirrors join: every mirror row of each status-500 log row's server
    sel = status == 500
    order = np.argsort(mirrors["id"], kind="stable")
    ids, hosts = mirrors["id"][order], mirrors["host"][order]
    lo = np.searchsorted(ids, sid[sel], "left")
    n = np.searchsorted(ids, sid[sel], "right") - lo
    first = np.repeat(lo, n) + np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    q1 = list(zip(np.repeat(url[sel], n).tolist(), hosts[first].tolist()))
    url_counts = by_key(url, ("count", None))
    total = int(logs["bytes"][status == 200].sum(dtype=np.int64))
    return [
        q0, q1, url_counts,
        by_key(status, ("count", None)),
        by_key(status, ("sum", latency)),
        [(u,) for u in url[sel].tolist()],
        (total + 2**31) % 2**32 - 2**31,
        {"limit": 5, "counts": dict(url_counts)},
        url_counts, url_counts,
        by_key(status, ("max", latency)),
    ]


def weblog_agree(got, want, rtol: float = WEBLOG_RTOL) -> bool:
    """One query's result against ``weblog_oracle``'s: integers exactly,
    floats within ``rtol``, rows as multisets (sorted by their integer
    columns); a top-k result holds the k largest counts, each at a url that
    has it."""
    if isinstance(want, dict):
        counts = sorted(want["counts"].values(), reverse=True)[:want["limit"]]
        return (isinstance(got, list) and sorted((c for _, c in got), reverse=True) == counts
                and all(want["counts"].get(u) == c for u, c in got))
    if not isinstance(want, list):
        return got == want
    if not isinstance(got, list) or len(got) != len(want):
        return False
    if not want:
        return True
    floats = np.array([isinstance(b, float) for b in want[0]])
    g, w = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)  # ints < 2^53 stay exact
    if g.shape != w.shape:
        return False
    keys = [g[:, j] for j in reversed(np.flatnonzero(~floats))]
    g = g[np.lexsort(keys)] if keys else g
    w = w[np.lexsort([w[:, j] for j in reversed(np.flatnonzero(~floats))])] if keys else w
    return bool(np.array_equal(g[:, ~floats], w[:, ~floats])
                and np.all(np.abs(g[:, floats] - w[:, floats]) <= rtol * np.abs(w[:, floats])))


def run_example(fails: Failures, label: str, main, argv: list, **kw):
    """``main(argv, **kw)`` of an example or tool, its printed lines
    indented under ``label``; None (and a failure) where it raised."""
    import io
    import traceback

    buf = io.StringIO()
    t0 = time.perf_counter()
    out = None
    try:
        with contextlib.redirect_stdout(buf):
            out = main(argv, **kw)
    except Exception:  # recorded as the phase's failure; the phase goes on
        fails.check(False, f"{label} {' '.join(argv)} raised:\n{traceback.format_exc()}")
    dt = time.perf_counter() - t0
    print(f"  {label} {' '.join(argv)} ({dt:.1f} s):", flush=True)
    for line in buf.getvalue().splitlines():
        print("    " + line, flush=True)
    return out, dt


def examples_path(torch, flash_ops, plain, agreement, fails: Failures, record: dict, out_dir: str) -> dict:
    """Phase 29: the port's examples and tools, in process, through their
    ``main(argv)``: the quickstart; the web-log session at EXAMPLE_ROWS,
    every result against ``weblog_oracle``, the repeated url query and the
    url MapReduce job plan-cache hits, the scheduler's coverage; gemma2-9b
    served at published width (EXAMPLE_SERVE) twice, 42 flash launches a
    prefill, the first run's prefills' first and last layers' calls held
    against the plain version, the second run unchecked (its prefill and
    decode times are the ones reported), the greedy tokens of both runs
    bitwise equal, finite logits; the 75.9M-parameter training run
    (EXAMPLE_TRAIN) in a temporary directory: the first step's first and
    last layers' forward calls held against the plain version, and one
    backward call of the first step (the last layer's) and of the last
    step (the first layer's) against the plain backward in float64
    (BackwardProbe), one restore from step EXAMPLE_TRAIN_RESTORE, the end
    at its last step, a finite and falling loss, the flash backward once a
    layer and step and the plain backward never, the final checkpoint
    restored bitwise equal to the state in memory; irlint's demo exit code, a
    summary of a trace the quickstart's session saved under
    ``Session.profile()``, and the probe of EXAMPLE_PROBE.  Returns the
    kernels' launches in the phase."""
    import gc
    import tempfile

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.segreduce import ops as segreduce_ops
    from repro_torch.launch.train import states_equal
    from repro_torch.train.checkpoint import CheckpointManager

    report: dict = {}
    seg0 = dict(segreduce_ops.LAUNCHES)
    fwd0, bwd0, plain0 = flash_ops.LAUNCHES, flash_ops.BWD_LAUNCHES, flash_ops.PLAIN_BWD_CALLS
    fwd_dim0, bwd_dim0 = dict(flash_ops.LAUNCHES_BY_DIM), dict(flash_ops.BWD_LAUNCHES_BY_DIM)

    # the quickstart, then a trace of its session's query
    quick = load_file("examples/torch_quickstart.py")
    qs, dt = run_example(fails, "torch_quickstart", quick.main, [])
    trace_path = os.path.join(out_dir, "quickstart_trace.json.gz")
    if qs is not None:
        fails.check(qs["cache_hit"] and qs["rows"] == qs["mr_rows"] == qs["raw_rows"] == qs["reference_rows"],
                    "torch_quickstart: SQL, MapReduce, the raw plan and the ReferenceInterpreter disagree")
        with qs["session"].profile() as qt:
            qs["session"].sql(quick.QUERY)
        os.makedirs(out_dir, exist_ok=True)
        qt.save(trace_path)
        report["quickstart"] = {"seconds": dt, "agg_methods": qs["agg_methods"], "launches": qs["launches"],
                                "cache_stats": qs["cache_stats"]}
    del qs

    # the web-log session at the reference header's size
    weblog = load_file("examples/torch_bigdata_sql.py")
    bd, dt = run_example(fails, "torch_bigdata_sql", weblog.main, ["--rows", str(EXAMPLE_ROWS)])
    if bd is not None:
        t0 = time.perf_counter()
        want = weblog_oracle(bd["tables"])
        rows = []
        for entry, w in zip(bd["queries"], want):
            res = next(iter(entry["results"].values()))
            ok = fails.check(weblog_agree(res, w), f"torch_bigdata_sql: {entry['label']} disagrees with numpy")
            rows.append({"label": entry["label"], "ok": ok, "plan": entry["plan"], "launches": entry["launches"],
                         "ms": entry["elapsed_s"] * 1e3, "cache_hit": entry["cache_hit"]})
        fails.check(len(rows) == len(want), f"torch_bigdata_sql ran {len(rows)} of {len(want)} queries")
        hits = [r["cache_hit"] for r in rows]
        fails.check(hits[8:10] == [True, True], f"torch_bigdata_sql: the repeated url query and the url "
                                                f"MapReduce job are not plan-cache hits ({hits})")
        fails.check(bd["coverage"], "torch_bigdata_sql: the chunked execution's coverage fails")
        print(f"  {len(rows)} results against numpy at {EXAMPLE_ROWS} rows in {time.perf_counter() - t0:.1f} s: "
              f"{sum(r['ok'] for r in rows)} agree; cache hits {hits}", flush=True)
        report["bigdata_sql"] = {"seconds": dt, "session_ms": bd["session_ms"], "queries": rows,
                                 "cache_stats": bd["cache_stats"], "distribution": str(bd["distribution"]),
                                 "schedule": bd["schedule"]}
    del bd
    gc.collect()
    torch.cuda.empty_cache()

    # gemma2-9b at published width, twice
    serve = load_file("examples/torch_serve_lm.py")
    layers = get_config(SERVE_ARCH).n_layers  # EXAMPLE_SERVE serves it unreduced
    rec = flash_recorder(flash_ops, plain, agreement, fails)
    rec.hold = lambda label, n: n % layers in (0, layers - 1)
    runs = []
    with rec:
        for i in range(2):
            rec.label = f"example run {i}"
            # run 0 checked; run 1 unchecked, so that its times hold no check
            with (contextlib.nullcontext() if i == 0 else rec.paused()):
                out, dt = run_example(fails, "torch_serve_lm", serve.main, EXAMPLE_SERVE)
            gc.collect()
            torch.cuda.empty_cache()
            if out is None:
                continue
            out["wall_s"] = dt
            runs.append(out)
            fails.check(out["flash_launches"] == {"generate": layers, "prefill": layers},
                        f"torch_serve_lm: flash launches {out['flash_launches']}, not {layers} a prefill")
            fails.check(out["prefill_logits_finite"], "torch_serve_lm: non-finite logits")
    bad = [k for k, st in rec.stats.items() if not st["ok"]]
    fails.check(not bad and len(rec.stats) > 0, f"torch_serve_lm: flash calls disagreeing with the plain version "
                                                f"{bad} (held {len(rec.stats)})")
    if len(runs) == 2:
        fails.check(bool(torch.equal(runs[0]["tokens"], runs[1]["tokens"])),
                    "torch_serve_lm: two runs gave different greedy tokens")
        report["serve_lm"] = {k: runs[1][k] for k in ("n_params", "prefill_ms", "decode_ms_per_token",
                                                      "cache_bytes", "int8_cache_bytes", "max_abs_err", "k_path")}
        report["serve_lm"]["seconds"] = [r["wall_s"] for r in runs]
        report["serve_lm"]["checked_run"] = {k: runs[0][k] for k in ("prefill_ms", "decode_ms_per_token")}
        report["serve_lm"]["flash_held"] = {str(k): st for k, st in rec.stats.items()}

    # the 75.9M-parameter training run with one failure
    train = load_file("examples/torch_train_lm.py")
    bwd_before, plain_before = flash_ops.BWD_LAUNCHES, flash_ops.PLAIN_BWD_CALLS
    fwd_before = flash_ops.LAUNCHES
    # the first step's first and last layers' forward calls against the
    # plain version; one backward call of the first step (the last layer's)
    # and of the last (the first layer's) against the plain backward in
    # float64, each judged after its step
    train_layers: dict = {}
    trec = flash_recorder(flash_ops, plain, agreement, fails)
    trec.label = "train"
    trec.hold = lambda label, n: n in (0, train_layers["n"] - 1)
    last = EXAMPLE_TRAIN_RUN - 1
    probe = BackwardProbe(flash_ops, lambda s: {0: 0, last: train_layers["n"] - 1}.get(s, -1), flash_judge)
    bwd_checks: list = []
    check_s = [0.0]
    make_step = train.make_train_step

    def probed_step(model, opt_cfg, spec):
        step_fn = make_step(model, opt_cfg, spec)
        train_layers["n"] = model.cfg.n_layers

        def step(*a):
            out = step_fn(*a)
            if probe.step in (0, last):
                t0 = time.perf_counter()
                bwd_checks.append(dict(probe.check(), step=probe.step - 1))
                check_s[0] += time.perf_counter() - t0
            else:
                probe.skip()
            return out

        return step

    compare = trec.compare

    def timed_compare(args, kw, out):
        t0 = time.perf_counter()
        agree = compare(args, kw, out)
        check_s[0] += time.perf_counter() - t0
        return agree

    trec.compare = timed_compare
    train.make_train_step = probed_step
    with tempfile.TemporaryDirectory() as tmp:
        with trec, probe:
            tr, dt = run_example(fails, "torch_train_lm", train.main, EXAMPLE_TRAIN + ["--ckpt-dir", tmp])
        if tr is not None:
            losses = tr["losses"]
            fails.check(len(losses) == EXAMPLE_TRAIN_RUN, f"torch_train_lm ran {len(losses)} steps, not "
                                                          f"{EXAMPLE_TRAIN_RUN}")
            fwd_bad = [k for k, st in trec.stats.items() if not st["ok"]]
            fails.check(not fwd_bad and sum(st["calls"] for st in trec.stats.values()) == 2,
                        f"torch_train_lm: forward calls disagreeing with the plain version {fwd_bad} "
                        f"(held {trec.stats})")
            fails.check([c["step"] for c in bwd_checks] == [0, last] and all(c["ok"] for c in bwd_checks),
                        f"torch_train_lm: backward calls against the plain backward in float64: {bwd_checks}")
            fails.check(tr["restored_from"] == [EXAMPLE_TRAIN_RESTORE] and tr["final_step"] == EXAMPLE_TRAIN_STEPS,
                        f"torch_train_lm: restored from {tr['restored_from']}, ended at {tr['final_step']}")
            fails.check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                        f"torch_train_lm: loss {losses[0]} -> {losses[-1]}")
            n_layers = tr["n_layers"]
            fwd, bwd = flash_ops.LAUNCHES - fwd_before, flash_ops.BWD_LAUNCHES - bwd_before
            fails.check(fwd == bwd == n_layers * len(losses) and flash_ops.PLAIN_BWD_CALLS == plain_before,
                        f"torch_train_lm: {fwd} flash and {bwd} backward launches over {len(losses)} steps of "
                        f"{n_layers} layers, {flash_ops.PLAIN_BWD_CALLS - plain_before} plain backward calls")
            t0 = time.perf_counter()
            _, final = CheckpointManager(tmp).restore(tr["state"], tr["final_step"])
            restore_s = time.perf_counter() - t0
            bitwise = states_equal(tr["state"], final)
            fails.check(bitwise, "torch_train_lm: the final checkpoint does not restore bitwise")
            report["train_lm"] = {"seconds": dt, "train_s": tr["seconds"], "steps_run": len(losses),
                                  "step_ms": tr["seconds"] * 1e3 / len(losses), "check_s": check_s[0],
                                  "tok_s": tr["tok_s"], "loss": [losses[0], losses[-1]],
                                  "restored_from": tr["restored_from"], "restore_s": restore_s,
                                  "restores_bitwise": bitwise, "n_params": tr["n_params"], "flash": fwd,
                                  "flash_bwd": bwd, "flash_held": {str(k): st for k, st in trec.stats.items()},
                                  "bwd_check": bwd_checks}
            print(f"  {len(losses)} steps in {tr['seconds']:.1f} s ({report['train_lm']['step_ms']:.1f} ms a step "
                  f"with checkpoints and {check_s[0]:.2f} s of checks); {fwd} flash, {bwd} flash backward "
                  f"launches; forward calls held {[st['worst'] for st in trec.stats.values()]} (worst/limit), "
                  f"backward calls of steps {[c['step'] for c in bwd_checks]} against float64: worst/limit "
                  f"{[c['worst'] for c in bwd_checks]}; final checkpoint restored in {restore_s:.2f} s, "
                  f"bitwise: {bitwise}", flush=True)
        del tr
    gc.collect()
    torch.cuda.empty_cache()

    # the tools
    irlint = load_file("scripts/torch_irlint.py")
    rc, _ = run_example(fails, "torch_irlint", irlint.main, ["--demo"])
    fails.check(rc == IRLINT_DEMO_RC, f"torch_irlint --demo exited {rc}, not {IRLINT_DEMO_RC}")
    summary = load_file("scripts/torch_trace_summary.py")
    rc_ts, _ = run_example(fails, "torch_trace_summary", summary.main, [trace_path, "--dispatch"])
    fails.check(rc_ts == 0, f"torch_trace_summary exited {rc_ts}")
    probe = load_file("scripts/torch_probe.py")
    pr, _ = run_example(fails, "torch_probe", probe.main, EXAMPLE_PROBE)
    fails.check(pr is not None and pr["memory"]["peak_device_bytes"] > 0, "torch_probe printed no record")
    report["tools"] = {"irlint_rc": rc, "trace_summary_rc": rc_ts,
                       "probe": None if pr is None else {"t_trace_s": pr["t_trace_s"], "memory": pr["memory"]}}

    launches = {
        "segreduce": {k: v - seg0[k] for k, v in segreduce_ops.LAUNCHES.items()},
        "flash": flash_ops.LAUNCHES - fwd0,
        "flash_bwd": flash_ops.BWD_LAUNCHES - bwd0,
        "flash_by_dim": {d: n - fwd_dim0.get(d, 0) for d, n in flash_ops.LAUNCHES_BY_DIM.items()},
        "flash_bwd_by_dim": {d: n - bwd_dim0.get(d, 0) for d, n in flash_ops.BWD_LAUNCHES_BY_DIM.items()},
    }
    fails.check(flash_ops.PLAIN_BWD_CALLS == plain0, "phase 29 called the plain flash backward")
    report["launches"] = launches
    record["examples"] = report
    print(f"  launches in the phase: segreduce {launches['segreduce']}, flash {launches['flash']}, flash backward "
          f"{launches['flash_bwd']}", flush=True)
    return launches


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return lines[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=10.0, help="TPC-H scale factor of the main path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "chip_smoke.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — the port's smoke run needs one card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")) or HBM_BYTES_PER_S is None:
        print(f"chip_smoke: {SRC}/repro_torch not found — run from a checkout", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash.ref import (
        agreement,
        attention_ref,
        bwd_agreement,
        bwd_exact_agreement,
        flash_attention_bwd_plain,
        flash_attention_plain,
    )
    from repro_torch.kernels.segreduce import kernel, ops, ref
    from repro_torch.kernels.wkv6 import kernel as wkv6_kernel
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.kernels.wkv6.ref import agreement as wkv6_agreement
    from repro_torch.kernels.wkv6.ref import bwd_agreement as wkv6_bwd_agreement
    from repro_torch.kernels.wkv6.ref import wkv6_bwd_plain, wkv6_plain, wkv6_scan

    t_start = time.perf_counter()
    phase_start: dict = {}  # seconds from the start to each phase's start
    fails = Failures()
    record: dict = {"sf": args.sf, "seed": args.seed}

    # 1. environment
    phase_start[1] = time.perf_counter() - t_start
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}", flush=True)
    print(smi, flush=True)
    record["card"] = smi
    record["torch"] = torch.__version__

    # 2. build
    phase_start[2] = time.perf_counter() - t_start
    t0 = time.perf_counter()
    record["build_s"] = build_all({"segreduce": kernel.LIBRARY, "flash": flash_kernel.LIBRARY,
                                   "flash_bwd": flash_kernel.BWD_LIBRARY, "wkv6": wkv6_kernel.LIBRARY,
                                   "wkv6_bwd": wkv6_kernel.BWD_LIBRARY})
    print("build: " + ", ".join(f"{n} library in {t:.1f} s" for n, t in record["build_s"].items())
          + f" (in parallel; all loaded in {time.perf_counter() - t0:.1f} s)", flush=True)

    # 3. kernel against plain
    phase_start[3] = time.perf_counter() - t_start
    print("kernel against its plain version:", flush=True)
    big_n = int(6_000_000 * args.sf)
    record["matrix"] = kernel_matrix(torch, ops, ref, fails, big_n, args.seed)
    torch.cuda.empty_cache()

    # 4. main path
    phase_start[4] = time.perf_counter() - t_start
    print(f"main path at TPC-H SF{args.sf:g}:", flush=True)
    t0 = time.perf_counter()
    tables = tpch_tables(args.sf, args.seed)
    rows = {t: len(next(iter(c.values()))) for t, c in tables.items()}
    print(f"  data {rows} in {time.perf_counter() - t0:.1f} s", flush=True)
    record["tables"] = rows
    t0 = time.perf_counter()
    want = oracle(tables)
    print(f"  oracle {time.perf_counter() - t0:.1f} s", flush=True)
    main_rows: dict = {}
    report, launches, recorders = main_path(torch, repro_torch, ops, tables, want, fails, main_rows)
    record["queries"] = report
    record["launches"] = dict(launches)

    # 5. the kernel at the main path's shapes (these launches are not counted)
    phase_start[5] = time.perf_counter() - t_start
    print("kernel at the main path's shapes:", flush=True)
    shapes = {}
    for rec in recorders:
        seen = set()
        for label, cargs, ckw in rec.calls:
            key = shape_key(rec.name, cargs, ckw)
            if key in seen:
                continue
            seen.add(key)
            t = time_call(torch, ops, ref, rec.name, cargs, ckw)
            fails.check(t["ok"], f"{rec.name} at {label}'s shape disagrees with its plain version")
            shapes.setdefault(rec.name, []).append({"query": label, **t})
            print(f"  {rec.name:<16} {label:<14} N={t['n']:>9} K={t['num_keys']:>8} regime {t['regime']} "
                  f"kernel {t['ms']:.3f} ms  bound {t['bound_ms']:.3f} ms  plain {t['plain_ms']:.3f} ms  "
                  f"library {t['library_ms']:.3f} ms (every table {t['library_all_ms']:.3f} ms)  "
                  f"max_abs_err {t['max_abs_err']:.3g}", flush=True)
            print("    passes (ms a launch x launches a call) " + passes_text(t["passes_ms"], 3), flush=True)
        rec.calls.clear()
    record["shapes"] = shapes
    torch.cuda.empty_cache()

    # 6. flash against its plain version
    phase_start[6] = time.perf_counter() - t_start
    print("flash kernel against its plain version:", flush=True)
    record["flash_matrix"] = flash_matrix(torch, flash_ops, flash_attention_plain, agreement, fails, args.seed)
    record["flash_config"] = {d: flash_kernel.library_config(d) for d in flash_kernel.HEAD_DIMS}
    for d, built in record["flash_config"].items():
        fails.check({x: built[x] for x in flash_kernel.TILES[d]} == flash_kernel.TILES[d]
                    and built["smem"] == flash_kernel.smem_bytes(d),
                    f"flash library's tiles at D={d} {built} differ from kernel.TILES {flash_kernel.TILES[d]}")
    print("  bf16 tiles (q x k, stages, shared bytes): " + ", ".join(
        f"D={d} {c['q_block']}x{c['kv_block']}, {c['stages']}, {c['smem']}" for d, c in record["flash_config"].items()),
        flush=True)
    torch.cuda.empty_cache()

    # 7. the serving path at full width
    phase_start[7] = time.perf_counter() - t_start
    print(f"serving path: {SERVE_ARCH} at full width:", flush=True)
    flash_rec = flash_recorder(flash_ops, flash_attention_plain, agreement, fails)
    flash_launches = serve_path(torch, SERVE_ARCH, SERVE_SCENARIOS, flash_ops, flash_rec, "flash_fwd", fails,
                                args.seed, record)

    # 8. flash at the serving path's shapes (these launches are not counted)
    phase_start[8] = time.perf_counter() - t_start
    print("flash kernel at the serving path's shapes:", flush=True)
    record["flash_ptxas_d256"] = flash_kernel.ptxas_report(256)
    for line in record["flash_ptxas_d256"] or ["ptxas: the flash library was not built in this run"]:
        print("  " + line, flush=True)
    flash_rows = flash_at_shapes(torch, flash_ops, flash_attention_plain, agreement, flash_rec, fails)
    record["flash_shapes"] = flash_rows

    # 9. wkv6 against its plain version
    phase_start[9] = time.perf_counter() - t_start
    print("wkv6 kernel against its plain version:", flush=True)
    record["wkv6_matrix"] = wkv6_matrix(torch, wkv6_ops, wkv6_plain, wkv6_agreement, fails, args.seed)
    record["wkv6_passes"] = wkv6_pass_report(torch, args.seed)

    # 10. the rwkv6 serving path at full width
    phase_start[10] = time.perf_counter() - t_start
    print(f"serving path: {RWKV_ARCH} at full width:", flush=True)
    wkv6_rec = wkv6_recorder(wkv6_ops, wkv6_plain, wkv6_agreement, fails)
    wkv6_launches = serve_path(torch, RWKV_ARCH, RWKV_SCENARIOS, wkv6_ops, wkv6_rec, "wkv6_", fails,
                               args.seed, record, prepare=lambda m, g: spread_rwkv_zero_inits(torch, m, g))

    # 11. wkv6 at the serving path's shapes (these launches are not counted)
    phase_start[11] = time.perf_counter() - t_start
    print("wkv6 kernel at the serving path's shapes:", flush=True)
    wkv6_rows = wkv6_at_shapes(torch, wkv6_ops, wkv6_plain, wkv6_scan, wkv6_agreement, wkv6_rec)
    record["wkv6_shapes"] = wkv6_rows

    # 12. the partitioned backend at the main path's size
    phase_start[12] = time.perf_counter() - t_start
    print(f"partitioned backend at TPC-H SF{args.sf:g}:", flush=True)
    chunk_recorders = [Recorder(ops, "fused_segreduce", first_only=True),
                       Recorder(ops, "segreduce", first_only=True)]
    ops.reset_launches()
    with chunk_recorders[0], chunk_recorders[1]:
        record["partitioned"] = partitioned_path(torch, repro_torch, ops, tables, want, main_rows, fails,
                                                 chunk_recorders)
    part_launches = dict(ops.LAUNCHES)
    record["partitioned_launches"] = part_launches
    print(f"  segreduce launches on this path: {part_launches}", flush=True)
    fails.check(part_launches["fused_segreduce"] > 0, "the partitioned path never launched fused_segreduce")
    print("segreduce at the chunk shapes:", flush=True)
    record["chunk_shapes"] = chunk_shapes(torch, ops, ref, chunk_recorders, fails)
    torch.cuda.empty_cache()

    # 13. the multi-tenant QueryServer
    phase_start[13] = time.perf_counter() - t_start
    print("QueryServer: tenants over one shared chunk pool:", flush=True)
    t0 = time.perf_counter()
    tables["zipf"] = zipf_table(rows["lineitem"], args.seed)
    print(f"  zipf table of {rows['lineitem']} rows in {time.perf_counter() - t0:.1f} s", flush=True)
    ops.reset_launches()
    record["server"] = server_path(torch, repro_torch, tables, want, fails)
    server_launches = dict(ops.LAUNCHES)
    record["server_launches"] = server_launches
    print(f"  segreduce launches on this path: {server_launches}", flush=True)
    fails.check(sum(server_launches.values()) > 0, "the server path never launched segreduce")
    for kname in launches:
        launches[kname] += part_launches[kname] + server_launches[kname]
    torch.cuda.empty_cache()

    # 14. the flash backward against its plain version
    phase_start[14] = time.perf_counter() - t_start
    print("flash backward kernel against its plain version:", flush=True)
    record["flash_bwd_matrix"] = flash_bwd_matrix(torch, flash_kernel, flash_attention_bwd_plain, attention_ref,
                                                  bwd_agreement, bwd_exact_agreement, fails, args.seed)
    bwd_rows = flash_bwd_at_train_shapes(torch, flash_kernel, flash_attention_bwd_plain, bwd_agreement, args.seed)
    bwd_row = bwd_rows[0]
    record["flash_bwd_shapes"] = bwd_rows

    # 15. training starcoder2-3b at full width
    phase_start[15] = time.perf_counter() - t_start
    print(f"training path: {TRAIN_ARCH} at full width:", flush=True)
    train = train_path(torch, "flash", fails, args.seed, record)
    flash_launches += train["launches"]["forward"]
    bwd_launches = train["launches"]["backward"]

    # 16. the training CLI: a failure and a restart from the checkpoint
    phase_start[16] = time.perf_counter() - t_start
    print("training CLI with a simulated failure:", flush=True)
    cli_path(fails, record)
    cli_path(fails, record, RWKV_ARCH)

    # 17. the wkv6 backward against its plain version
    phase_start[17] = time.perf_counter() - t_start
    print("wkv6 backward kernel against its plain version:", flush=True)
    record["wkv6_bwd_matrix"] = wkv6_bwd_matrix(torch, wkv6_kernel, wkv6_bwd_plain, wkv6_scan, wkv6_bwd_agreement,
                                                fails, args.seed)
    wkv6_bwd_row = wkv6_bwd_at_train_shape(torch, wkv6_kernel, wkv6_bwd_plain, wkv6_bwd_agreement, args.seed)
    record["wkv6_bwd_shape"] = wkv6_bwd_row

    # 18. training rwkv6-3b at full width
    phase_start[18] = time.perf_counter() - t_start
    print(f"training path: {RWKV_ARCH} at full width:", flush=True)
    rwkv_train = train_path(torch, "wkv6", fails, args.seed, record)
    wkv6_launches += rwkv_train["launches"]["forward"]
    wkv6_bwd_launches = rwkv_train["launches"]["backward"]
    print(f"phases 1-18 in {time.perf_counter() - t_start:.0f} s", flush=True)

    # 19. the MoE models at published width over the layers that fit
    phase_start[19] = time.perf_counter() - t_start
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe

    fails.check(not torch.backends.cuda.matmul.allow_tf32,
                "TF32 is on for f32 products: the MoE router's product must run in f32")
    for arch, scenarios in MOE_SCENARIOS.items():
        cfg = get_config(arch)
        layers, layer_b, outer_b = moe_depth(cfg, MOE_WEIGHT_GIB, len(cfg.layer_pattern))
        print(f"serving path: {arch} at published width over {layers} of {cfg.n_layers} layers "
              f"({layer_b / 1e9:.3f} GB a layer, {outer_b / 1e9:.3f} GB embedding and head: {layers} layers fit "
              f"{MOE_WEIGHT_GIB:g} GiB of weights; widths, experts, top-k, capacity and vocabulary as published):",
              flush=True)
        t0 = time.perf_counter()
        flash_launches += serve_path(torch, arch, scenarios, flash_ops, flash_rec, "flash_fwd", fails, args.seed,
                                     record, n_layers=layers, moe=moe)
        flash_rec.inputs.clear()  # phase 8 timed the serving shapes; these are held only
        print(f"  {arch}: {time.perf_counter() - t0:.0f} s", flush=True)

    # 20. training dbrx-132b at published width over the layers that fit
    phase_start[20] = time.perf_counter() - t_start
    print(f"training path: {TRAIN_CASES['moe']['arch']} at published width:", flush=True)
    t0 = time.perf_counter()
    moe_train = train_path(torch, "moe", fails, args.seed, record)
    flash_launches += moe_train["launches"]["forward"]
    bwd_launches += moe_train["launches"]["backward"]
    print(f"  {time.perf_counter() - t0:.0f} s; phases 1-20 in {time.perf_counter() - t_start:.0f} s", flush=True)

    # 21. zamba2-7b at its published width and depth
    phase_start[21] = time.perf_counter() - t_start
    from repro_torch.models import mamba2

    print(f"serving path: {ZAMBA2_ARCH} at full width and depth:", flush=True)
    fails.check(not torch.backends.cuda.matmul.allow_tf32 and torch.get_float32_matmul_precision() == "highest",
                "TF32 is on for f32 products: the Mamba2 SSD's products must run in f32")
    t0 = time.perf_counter()
    zamba_rec = flash_recorder(flash_ops, flash_attention_plain, agreement, fails)
    flash_launches += serve_path(
        torch, ZAMBA2_ARCH, ZAMBA2_SCENARIOS, flash_ops, zamba_rec, "flash_fwd", fails, args.seed, record,
        prepare=lambda m, g: spread_mamba2_inits(torch, m, g), per_prefill=shared_invocations,
        breakdown=lambda m, p: zamba2_breakdown(torch, m, p, "flash_fwd"))
    print(f"flash kernel at {ZAMBA2_ARCH}'s shapes (head dim 112, padded to 128; SSD chunk 64, states passed "
          f"{mamba2.STATE_BLOCK} chunks a product):", flush=True)
    zamba_rows = flash_at_shapes(torch, flash_ops, flash_attention_plain, agreement, zamba_rec, fails)
    record["flash_shapes_zamba2"] = zamba_rows
    flash_rows = flash_rows + zamba_rows
    print(f"  {time.perf_counter() - t0:.0f} s; phases 1-21 in {time.perf_counter() - t_start:.0f} s", flush=True)

    # 22. hubert-xlarge, the audio encoder, at its published width and depth
    phase_start[22] = time.perf_counter() - t_start
    print(f"encoder path: {HUBERT_ARCH} at full width and depth:", flush=True)
    t0 = time.perf_counter()
    hubert_launches, hubert_rows = encoder_path(torch, flash_ops, flash_attention_plain, agreement, fails, args.seed,
                                                record)
    record["flash_shapes_hubert"] = hubert_rows
    flash_launches += hubert_launches
    flash_rows = flash_rows + hubert_rows
    print(f"  {time.perf_counter() - t0:.0f} s", flush=True)

    # 23. training hubert-xlarge at its published width and depth
    phase_start[23] = time.perf_counter() - t_start
    print(f"training path: {HUBERT_ARCH} at full width and depth:", flush=True)
    t0 = time.perf_counter()
    hubert_train = train_path(torch, "hubert", fails, args.seed, record)
    flash_launches += hubert_train["launches"]["forward"]
    bwd_launches += hubert_train["launches"]["backward"]
    print(f"  {time.perf_counter() - t0:.0f} s", flush=True)

    # 24. training gemma3-4b at its published width
    phase_start[24] = time.perf_counter() - t_start
    print(f"training path: {TRAIN_CASES['gemma3']['arch']} at published width:", flush=True)
    t0 = time.perf_counter()
    gemma3_train = train_path(torch, "gemma3", fails, args.seed, record)
    flash_launches += gemma3_train["launches"]["forward"]
    bwd_launches += gemma3_train["launches"]["backward"]
    print(f"  {time.perf_counter() - t0:.0f} s; phases 1-24 in {time.perf_counter() - t_start:.0f} s", flush=True)

    # 25. training zamba2-7b at its published width over the scan steps that fit
    phase_start[25] = time.perf_counter() - t_start
    print(f"training path: {ZAMBA2_ARCH} at published width:", flush=True)
    t0 = time.perf_counter()
    zamba2_train = train_path(torch, "zamba2", fails, args.seed, record)
    flash_launches += zamba2_train["launches"]["forward"]
    bwd_launches += zamba2_train["launches"]["backward"]
    print(f"  {time.perf_counter() - t0:.0f} s", flush=True)

    # 26. qwen2-vl-72b at published width over the layers that fit, and the
    # one-card mesh
    phase_start[26] = time.perf_counter() - t_start
    t0 = time.perf_counter()
    cfg = get_config(VLM_ARCH)
    layers, layer_b, outer_b = moe_depth(cfg, MOE_WEIGHT_GIB, len(cfg.layer_pattern))
    print(f"serving path: {VLM_ARCH} at published width over {layers} of {cfg.n_layers} layers "
          f"({layer_b / 1e9:.3f} GB a layer, {outer_b / 1e9:.3f} GB embedding and head: {layers} layers fit "
          f"{MOE_WEIGHT_GIB:g} GiB of weights), prompts led by {VLM_GRID} x {VLM_GRID} patch embeddings with "
          f"3-axis positions:", flush=True)
    vlm_rec = flash_recorder(flash_ops, flash_attention_plain, agreement, fails)
    flash_launches += serve_path(torch, VLM_ARCH, VLM_SCENARIOS, flash_ops, vlm_rec, "flash_fwd", fails, args.seed,
                                 record, n_layers=layers, inputs=vlm_inputs(torch, args.seed), profile=False,
                                 all_logits=True)
    print(f"one-card mesh with a prefill cell's specs: on {nvidia_smi_line()}", flush=True)
    mesh_path(torch, fails, args.seed, record)
    print(f"  {time.perf_counter() - t0:.0f} s", flush=True)

    # 27. starcoder2-15b at its published width and depth
    phase_start[27] = time.perf_counter() - t_start
    print(f"serving path: {CODE_ARCH} at full width and depth:", flush=True)
    t0 = time.perf_counter()
    code_rec = flash_recorder(flash_ops, flash_attention_plain, agreement, fails)
    flash_launches += serve_path(torch, CODE_ARCH, CODE_SCENARIOS, flash_ops, code_rec, "flash_fwd", fails,
                                 args.seed, record, profile=False, all_logits=True)
    print(f"  {time.perf_counter() - t0:.0f} s; phases 1-27 in {time.perf_counter() - t_start:.0f} s; on "
          f"{nvidia_smi_line()}", flush=True)
    # 28. the dry run's reckoning against the card
    phase_start[28] = time.perf_counter() - t_start
    print("the dry run's reckoning (launch/dryrun.py, meta device) against the card:", flush=True)
    t0 = time.perf_counter()
    reckoning_path(torch, fails, record, train, flash_ops, wkv6_ops, args.seed,
                   os.path.join(os.path.dirname(args.out), "reckoning"))
    print(f"  {time.perf_counter() - t0:.0f} s; on {nvidia_smi_line()}", flush=True)

    # 29. the port's examples and command-line tools
    phase_start[29] = time.perf_counter() - t_start
    print("the port's examples and tools (examples/torch_*.py, scripts/torch_*.py), in process:", flush=True)
    t0 = time.perf_counter()
    example_launches = examples_path(torch, flash_ops, flash_attention_plain, agreement, fails, record,
                                     os.path.dirname(args.out))
    for kname in launches:
        launches[kname] += example_launches["segreduce"][kname]
    flash_launches += example_launches["flash"]
    bwd_launches += example_launches["flash_bwd"]
    print(f"  {time.perf_counter() - t0:.0f} s; on {nvidia_smi_line()}", flush=True)
    trains = (train, moe_train, hubert_train, gemma3_train, zamba2_train)
    fwd_by_dim = dict(example_launches["flash_by_dim"])
    bwd_by_dim = dict(example_launches["flash_bwd_by_dim"])
    for rep_ in [v for k, v in record.items() if k.startswith("serve_")]:
        for d, n in rep_.get("launches_by_dim", {}).items():
            fwd_by_dim[d] = fwd_by_dim.get(d, 0) + n
    for tr in trains:
        for d, n in tr["launches_by_dim"]["forward"].items():
            fwd_by_dim[d] = fwd_by_dim.get(d, 0) + n
        for d, n in tr["launches_by_dim"]["backward"].items():
            bwd_by_dim[d] = bwd_by_dim.get(d, 0) + n
    print(f"flash launches by head dim: forward {dict(sorted(fwd_by_dim.items()))}, backward "
          f"{dict(sorted(bwd_by_dim.items()))}", flush=True)

    # the JSON record: each kernel at the largest shape the main path gave it
    entries = []
    meta = {
        "fused_segreduce": "src/repro/kernels/segreduce/kernel.py:111",
        "segreduce": "src/repro/kernels/segreduce/kernel.py:170",
    }
    for kname, replaces in meta.items():
        runs = shapes.get(kname, [])
        if not fails.check(bool(runs), f"no main-path shape recorded for {kname}"):
            continue
        top = max(runs, key=lambda t: t["n"])
        entries.append({
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/kernels/segreduce/csrc/segreduce.cu",
            "replaces": replaces,
            "launches": launches.get(kname, 0),
            "max_abs_err": max(t["max_abs_err"] for t in runs),
            "ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
        })
    if fails.check(bool(flash_rows), "no serving-path shape recorded for flash_attention"):
        top = max(flash_rows, key=lambda t: t["bound_ms"])
        # each head dim at its costliest serving shape, with its launches
        per_dim = {}
        for t in flash_rows:
            d = t["q"][3]
            if d not in per_dim or t["bound_ms"] > per_dim[d]["bound_ms"]:
                per_dim[d] = t
        entries.append({
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash/csrc/flash_fwd.cu",
            "replaces": "src/repro/kernels/flash/kernel.py:74",
            "launches": flash_launches,
            "max_abs_err": max(t["max_abs_err"] for t in flash_rows),
            "ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "head_dims": [{"head_dim": d, "shape": {"scenario": t["scenario"], "q": t["q"], "k": t["k"],
                                                    "causal": t["causal"], "window": t["window"],
                                                    "softcap": t["softcap"]},
                           "launches": fwd_by_dim.get(d, 0), "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                           "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                           "library_ms": t["library_ms"]} for d, t in sorted(per_dim.items())],
        })
    fails.check(flash_launches > 0, "the serving path never launched flash_attention")
    if fails.check(bool(wkv6_rows), "no serving-path shape recorded for wkv6"):
        top = max(wkv6_rows, key=lambda t: t["bound_ms"])
        entries.append({
            "name": "wkv6",
            "route": "cuda",
            "source": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6/kernel.py:57",
            "launches": wkv6_launches,
            "max_abs_err": max(t["max_abs_err"] for t in wkv6_rows),
            "ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": None,
        })
    fails.check(wkv6_launches > 0, "the rwkv6 serving path never launched wkv6")
    entries.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash/csrc/flash_bwd.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel: the reference differentiates flash_attention_jnp "
                         "(src/repro/models/attention.py:54) by autodiff",
        "launches": bwd_launches,
        "max_abs_err": max([r["max_abs_err"] for r in record["flash_bwd_matrix"] + bwd_rows]
                           + [tr["bwd_check"]["max_abs_err"] for tr in trains]),
        "train_path_check": {tr["arch"]: tr["bwd_check"] for tr in trains},
        "ms": bwd_row["ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
        "head_dims": [{"head_dim": r["head_dim"], "shape": {"label": r["label"], "q": r["q"], "kv_heads": r["kv_heads"],
                                                            "causal": r["causal"], "window": r["window"]},
                       "launches": bwd_by_dim.get(r["head_dim"], 0), "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                       "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                       "library_ms": r["library_ms"]} for r in bwd_rows],
    })
    entries.append({
        "name": "wkv6_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/wkv6/csrc/wkv6_bwd.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel: the reference differentiates _wkv_chunked "
                         "(src/repro/models/rwkv6.py:148) by autodiff",
        "launches": wkv6_bwd_launches,
        "max_abs_err": max([r["max_abs_err"] for r in record["wkv6_bwd_matrix"]]
                           + [wkv6_bwd_row["agreement"]["max_abs_err"], rwkv_train["bwd_check"]["max_abs_err"]]),
        "train_path_check": rwkv_train["bwd_check"],
        "ms": wkv6_bwd_row["ms"],
        "plain_ms": wkv6_bwd_row["plain_ms"],
        "bound_ms": wkv6_bwd_row["bound_ms"],
        "bound_by": wkv6_bwd_row["bound_by"],
        "library_ms": None,
    })
    fails.check(bwd_launches > 0, "the training path never launched the flash backward")
    fails.check(wkv6_bwd_launches > 0, "the rwkv6 training path never launched the wkv6 backward")
    fails.check(wkv6_bwd_row["agreement"]["ok"], f"wkv6 backward at the training shape disagrees with its plain "
                                                 f"version ({wkv6_bwd_row['agreement']})")
    for r in bwd_rows:
        fails.check(r["agreement"]["ok"], f"flash backward at {r['label']}'s training shape disagrees with its "
                                          f"plain version ({r['agreement']})")
    ends = sorted(phase_start.items()) + [(None, time.perf_counter() - t_start)]
    record["phase_seconds"] = {n: ends[i + 1][1] - t for i, (n, t) in enumerate(ends[:-1])}
    print("seconds a phase: " + ", ".join(f"{n} {t:.0f}" for n, t in record["phase_seconds"].items()), flush=True)
    print(f"sum of phases: {sum(record['phase_seconds'].values()):.0f} s (aim: at most {PHASE_BUDGET_S} s of the "
          f"1,200 s limit)", flush=True)
    record["failures"] = fails.items
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1, default=str)

    if fails.items:
        print(f"chip_smoke: {len(fails.items)} failure(s)", file=sys.stderr)
        for f in fails.items:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
