#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one CUDA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  -- the card's name, count and power limit; TF32 off for matmul
              and cuDNN, so every fp32 comparison is fp32; cudnn.benchmark
              off; CUBLAS_WORKSPACE_CONFIG set before torch is imported.
2. build   -- the seven CUDA sources compiled from src/repro_torch/kernels/csrc
              (in parallel), with nvcc's -Xptxas -v report; the registers
              and spills of each instance of the fused kernel (16), of the
              per-phase kernel (10, (layout, R, ks)), of the implicit-GEMM
              kernel (1) and of the dx kernels (rich on gm and folding
              act', and poor at R 1-4), which must all spill nothing, of
              the pair kernel (8 instances, R x D), of the dw kernels (2 rich
              tiles on gm and folding act', 4 poor R) and of the decode
              kernel (7: bf16 by head dimension, fp32 by G), and of the
              projection's forward, dW and dz kernels, which must spill
              nothing.
3. check   -- each forward kernel against its plain PyTorch version at the
              four DCGAN layer shapes at batch 8 and at odd geometries, the
              GEMM kernel also at GEMM_SHAPES' own (DCGAN and EB-GAN L0 at
              batch 1, an unsplit contraction, every copy width), and
              the fused kernel also at FUSED_SHAPES (DCGAN L1 and L3 at
              batch 1, EB-GAN L4 and L5, a shape of uneven Cin splits) and at
              VARIANT_SHAPES, which launch every instance the geometry can
              choose with every copy width, with every epilogue, within
              1e-4 * max|ref| + 1e-5.
4. times   -- per DCGAN layer at batch 8 and at batch 1, by
              CUDA events after warm-up and by a CUDA graph's replay (host
              taken out): the fused and GEMM kernels, their plain versions
              (batch 8), a one-call library yardstick (F.conv_transpose2d +
              activation, which the port never calls) and the roofline
              bound; then the whole generator per bucket through the kernels
              (eagerly and as the engine's CUDA graph) and through two
              PyTorch baselines, and torch.profiler passes giving the
              device's busy time and idle share per generator call, eager
              and graphed, with the host wall of one graphed and one eager
              call that ends in a sync.
5. engine  -- GanEngine serving full-width DCGAN (random weights from a
              seed, buckets 1/2/4/8; one CUDA graph per bucket): warm-up
              (device memory before and after), each bucket's graph
              bitwise equal to its eager call and counting its launches, a
              replayed trace of 32 requests of 1-4 samples, then the
              serving checks (every request done, conservation, no builds
              after warm-up, finite outputs, the launch counts exactly the
              sum of the batches' eager counts, each request bitwise equal
              to its own unbatched call, agreement with a unified_reshape
              plan); then the latent projection at DCGAN's shape: whether
              one batched cuBLAS matmul gives each row the bits of its
              one-row call (1-8 rows), whether the projection kernel gives
              each row its batch-128 bits at batches 1-8, 64 and 128 (a
              gate), its forward, dW and dz against float64 within
              tolerance (a gate), and by graph replay the kernel against
              the per-row cuBLAS path and one batched cuBLAS call at
              buckets 1, 8, 64 and batch 128, dW against the per-row
              products summed and one cuBLAS call, with the bounds.
6. serving -- throughput and latency over open-loop Poisson traces of
              SERVE_WINDOW_S seconds at each of SERVE_RATES requests/s
              (same request mix), each on a freshly warmed engine, through
              its graphs, then through eager executables as a yardstick.
              The 32-request replay of phase 5 is a check, too short to
              rate.
7. bwd     -- each backward kernel (epilogue-grad, dx, dw with db) against
              its plain version at the same shapes and epilogues and at
              BWD_SHAPES' extra shapes (every dx and dw instance, every dx
              copy width), and dx with gm and the kernel 4 bytes off
              16-byte alignment at DX_UNALIGNED_SHAPES, same tolerance; the
              standalone epilogue-grad kernel bitwise its plain version; and
              a hard gate: dx and dw given g, y and the epilogue (act'
              folded into their staging, as the training path runs them)
              bitwise equal in dx, dw and db to the standalone epilogue-grad
              -> dx -> dw route, at every BWD_SHAPES shape and epilogue and
              with y 4 bytes off alignment at DX_UNALIGNED_SHAPES.
8. autograd -- the full-width DCGAN generator's parameter gradients of a
              scalar loss through the backward kernels against those of the
              plan pinned to bwd="autograd" (cuDNN), same tolerance.
9. bwd times -- per DCGAN layer at batch 8: each backward kernel, its plain
              version, a one-call library yardstick and the bound, with
              dx's instance and splits and dw's splits; the folded dx and dw
              (events and graph us, with their bounds) beside the
              three-kernel route of the same run, each whole route as one
              graph, and the gm bytes the fold no longer allocates.
10. pair check -- the per-phase kernel against its plain version at the
              four DCGAN shapes, ODD_SHAPES and PHASE_VARIANT_SHAPES (every
              compiled instance, both copy widths) with every epilogue, and
              each sample of a batch-8 call bitwise equal to its own batch-1
              call at the DCGAN shapes; the pair
              kernel against its plain version at both DCGAN pairs (batch
              8), EB-GAN's two legal head pairs (batch 1) and odd
              geometries (every compiled (R, d) instance), with interface
              and output epilogues; EB-GAN's
              64x64x128->64->64 tail pair refused (over the shared-memory
              budget); same tolerance. For each checked pair, the
              clusters of its instance the card runs at once
              (cudaOccupancyMaxActiveClusters).
11. pair times -- per DCGAN pair at batch 8: the pair kernel and the port's
              own back-to-back kernels in turns (and both at batch 1), its
              plain version, a library yardstick (two F.conv_transpose2d +
              activation) and the bound, with graph-replay device times at
              batch 8 and 1; per DCGAN layer: the per-phase kernel and the fused
              kernel in turns, by events and by graph replay (like for like:
              both are built from the same ring, copies and register
              micro-tile, and differ only in the unification, so
              fused_over_phase reads on the paper's unified-over-segregated
              claim; recorded, not claimed), the plain version, the library
              call (by events and by graph replay) and the bound; the
              whole generator per bucket
              through fused pairs and per layer, in turns, eagerly and as
              the engines' CUDA graphs; a profiled fused generator call.
12. fused engine -- GanEngine(fuse="force") on full-width DCGAN: each
              bucket's graph against its eager call as in phase 5, the 32
              requests of phase 5, the pair launches exactly the batches'
              eager counts, each request
              bitwise equal to its own unbatched fused call and within
              tolerance of the per-layer generator; save_plans, then a fresh
              engine's warmup(registry_path=...) gives equal plans and
              bitwise equal outputs; then phase 6's windows on fused engines.
13. pair autograd -- the full-width generator's parameter gradients through
              a fused-pair plan and through a plan pinned to method="phase",
              each against the per-layer plan, same tolerance; the launches
              of each run.
14. decode check -- the decode attention kernel against its plain version
              at the Llama-3-8B (S = 1024 as phase 16 serves it, 4096, and
              32768 as phase 16's long step runs it), Qwen2-0.5B, Yi-9B,
              CodeQwen1.5 (MHA), DBRX (G 6), Whisper's decoder (KV 20, G 1,
              448 rows), an odd shape and a cache of 40 splits
              (DECODE_CHECKS), fp32 and bf16, kv_len holding 1, S and
              lengths off the split grid (one past 32 splits among them),
              one ending inside a tile and one on a tile's edge, within
              1e-4 * max|ref| + 1e-5.
15. decode times -- at DECODE_TIMES (Llama-3-8B at S = 4096 and 32768,
              Qwen2-0.5B at 32768, and Llama-3-8B at the served S = 1024;
              bf16, kv_len = S): the kernel, its plain
              version and a one-call library yardstick
              (F.scaled_dot_product_attention with enable_gqa and a kv_len
              mask, which the port never calls), each by CUDA events and by
              a CUDA graph's replay (host taken out), and the bytes bound;
              a yardstick that SDPA refuses fails the run.
16. LM serve -- full-width Llama-3-8B, bf16, random weights from a seed on
              the card, ServeEngine(slots=8, max_len=1024) (its decode step
              one CUDA graph; device memory before and after) serving 16
              requests (prompts of 16-256 tokens, 16-64 new tokens, from a
              seed): every request done at its length, every token in the
              vocabulary, every step's logits finite, decode-kernel launches
              n_layers x engine steps; tokens/s; the same requests through
              the eager decode step give the same tokens (and its tokens/s);
              a decode step at 8 slots through the graph bitwise equal to
              the eager step, both timed and profiled; then the same at
              kv_len 32768 over a (8, 32768) cache of random K/V (34.4 GB),
              its logits finite.
17. LM parity -- the same architecture in fp32 (32 GB of weights):
              teacher-forced decode_step logits, through the kernel, against
              the full-sequence apply logits (plain direct attention) at
              batch 2, 40 tokens prefilled and 8 decoded, rtol/atol 2e-3.
18. zoo    -- every method name of transpose_conv2d (the baselines, auto
              and the Pallas spellings), with a bias and relu, at the paper's
              Table-2 shapes (224 x 224 x 3 images at batch 4, kernels 5/4/3,
              P = 2) and at every distinct Table-4 layer of the four GANs at
              batch 1, against the tap-by-tap oracle on the card; the fused
              and per-phase kernels against their plain versions at the
              Table-2 shapes with every epilogue; the segregated dilated
              convolution against the dense one at (4, 224, 224, 3) with a
              3x3 kernel; same tolerance.
19. paper  -- the paper's three claims, fp32, TF32 off, each forward by
              graph replay (host taken out). Tables 2-3: the tap-by-tap
              oracle ("naive"), the entry's baselines, the fused kernel
              ("pallas"), the per-phase kernel and auto at the Table-2 shapes,
              per image and per dataset (Table 1's sample counts), with the
              mean over n of t(conventional) / t(proposed) for the fused
              kernel and for unified; the fused and per-phase kernels also by
              events, with their plain versions, F.conv_transpose2d and the
              bound. Table 4: every layer of the four GANs at batch 1, each
              forward, and the backward and full step (autograd of .sum()) of
              conventional, unified and auto; per model t(naive) / t(auto)
              and t(conventional) / t(auto), and their means. Memory: one
              eager EB-GAN generator call at batch 1 and one Table-2 image
              through conventional, unified and the default plan: the peak,
              the bytes allocated and (from the allocator's history) each
              allocation of 256 KiB or more, beside the analytic saving and
              the padded upsampled buffers found among conventional's.
20. train  -- deterministic algorithms on (a bit-exact resume needs them;
              phases 3-19 run and are timed without them), then GanTrainer on
              full-width DCGAN (GanTrainerConfig defaults, global batch 8;
              each step one CUDA graph): 3 graphed steps bitwise equal to 3
              eager ones; 6 steps checkpointing every 3 whose launch counts
              are exactly 6 eager steps', with one capture, no standalone
              epilogue-grad launch and act' folded into every dx and dw
              launch of a layer with an activation; a
              resume from step 3 bitwise equal to the uninterrupted run
              (losses, params, moments); a NaN step that leaves the state
              bitwise untouched; the time a step's inputs take to draw;
              TRAIN_WINDOWS alternating windows of 30 timed steps through
              the graphed step, the graphed step with the plan pinned to
              bwd="autograd", and the eager step; one profiled step each
              way.
21. obs and replicas -- (a) phase 6's 2000 req/s window on the per-layer
              engine with the tracer off, on, on and off (a fresh engine
              each), each counting exactly its batches' eager launches:
              samples/s, latency, batches, the replay's sleep a batch; from
              the first traced one, the medians over requests of the timelines'
              queue_s / dispatch_s / execute_s and, per batch, of the
              serve.pack / serve.dispatch / serve.slice span walls, the
              batch period and its rest; every timeline complete and
              reconciled with conservation(), the Chrome trace
              (chiprun_out/obs_trace.json) valid, the Prometheus text
              round-trips; (b) the same window through a ReplicaSupervisor
              over two replicas (zero retries and timeouts, no builds after
              warm-up, dispatches within 1 of round robin, 64 requests
              bitwise their unbatched calls); (c) 32 requests under a fault
              plan (a crash, a NaN plane, a transient error, a 60 ms hang,
              then the second replica's crash and the inline fallback):
              every request served bitwise, flight dumps under
              chiprun_out/flight/ that load; (d) six traced graphed training
              steps (spans, observations, launches exactly a warm-up and six
              eager steps'), a NaN step's nan_guard dump and untouched state,
              a kill's crash dump and a bitwise resume.
22. autotune -- the autotuner's races on the card
              (repro_torch.kernels.autotune, CUDA-graph replay of each
              candidate's whole layer) into a hermetic cache,
              chiprun_out/autotune.json, its audit trail beside it: every
              layer of full-width DCGAN at batches 1, 2, 4 and 8 (and bwd
              and step at 8), then its two pairs at 1/2/4/8 (the other
              GANs' races are left out to keep the phase under 60 s); each
              record's candidates in graph us, winner, margin and
              batch-variant flags; each DCGAN layer's serving choice with
              no bucket histogram, then weighted by the histogram of a
              2000 req/s window on the cold plan (record_traffic); the
              tuned plans' describe() at every bucket, fused ("auto") and
              per layer. Gates: the serving plans' methods equal at every
              bucket; a reload from the file gives the same plans; one
              audit record per race; GanEngine(fuse="auto") on the tuned
              cache: every bucket's graph bitwise its eager call with equal
              launches, 32 requests each bitwise its unbatched call under
              the same cache; three tuned training steps, graph against
              eager, bitwise. Recorded, not gated: six 2000 req/s windows,
              cold and tuned in turns (C T T C C T), and 20 tuned then 20
              cold training steps (host clock). Every other phase
              runs on an empty cache (build/autotune_cold.json): the cold
              plans, so each hand-written kernel is still launched and held
              against its plain version whatever the races pick.
23. graph failure -- a capture that reads a device value on the host
              raises, and the card goes on working.
24. LM train -- full-width Qwen2-0.5B (bf16, 494 M parameters, random
              weights from a seed), seq 4096 (train_4k's length) at batch 4,
              AdamW with fp32 moments, through the LM Trainer (each step one
              CUDA graph, under deterministic algorithms). Gates: the first
              loss finite and within 1 nat of ln V; 3 graphed steps bitwise
              equal to 3 eager ones (metrics, params, moments); 6 steps
              checkpointing every 3, launching none of the hand-written
              kernels; a run killed after step 3's checkpoint and resumed
              bitwise equal to the uninterrupted one; the loss falling by
              0.3 over the 16 recorded steps; a NaN-poisoned step skipped
              with the state bitwise untouched. Recorded: LM_TRAIN_TIMED
              graphed steps' ms (host clock) beside the eager steps', tokens/s,
              model FLOPs a step and their share of the bf16 dense peak, one
              profiled step (device time by kernel and by kind, idle share)
              and the peak device memory.
25. entry points -- python -m repro_torch.launch.train (reduced
              Qwen2-0.5B, 20 steps, checkpoints, --mesh host: its log's
              last line must name the one-rank NCCL group) and the five
              examples/torch_*.py
              (torch_train_lm.py: 20 steps of its reduced xLSTM), run at once
              as processes on the card; each must exit 0 within
              ENTRY_TIMEOUT_S (logs in chiprun_out/entry/).
26. LM families -- (run right after phase 17, while the card's memory
              is as the LM phases leave it) bf16 at full width, random
              weights from seeds, each model freed before the next
              (FAMILY_SERVE, FAMILY_PREFILL,
              FAMILY_PARITY list the cuts): DBRX (4 layers), Jamba (one
              period, 8 experts) and xLSTM-125M served as phase 16 serves
              Llama-3-8B (the same 16 requests and gates, decode launches =
              attention layers x steps, xLSTM's 0; tokens/s, memory, a
              profiled step); Jamba (at capacity E / k) and xLSTM: a request
              in a recycled slot serves the tokens it serves alone in a fresh
              engine; Whisper-large-v3 (8 x 1500 frames + 416 tokens) and
              LLaVA-NeXT-Mistral-7B (4 x 2880 patches + 192 tokens): prefill,
              then 32 greedy decode steps through one CUDA graph, bitwise the
              eager steps, decode launches counted; then fp32 parity as in
              phase 17 for each family (MoE at capacity E / k; DBRX 2 layers,
              Jamba one period of 3 experts with a 256-token prompt).
27. distribution -- (run after phase 23, before phase 24) (a) under
              make_host_mesh(), a 1x1 (data, model) mesh over a one-rank
              NCCL group: full-width DCGAN through shard_plan_apply at
              buckets 1 and 8, per layer and fuse="force", bitwise the
              unsharded calls with equal launches (and one all-gather a
              call); Replica(shard=True, mesh=...) per bucket, each graph
              bitwise its eager sharded call and the unsharded replica's
              graph, counting its launches; GanTrainer(data_parallel=True)
              under the mesh: 3 graphed steps bitwise the data_parallel=False
              steps, with equal launches; the MoE's expert-parallel path at
              DBRX width (2 layers, 4 of 16 experts, fp32, capacity E / k,
              its FSDP gather of the expert slices) within 1e-4 * max|ref| +
              1e-5 of the no-mesh moe (a layer, and the model's logits), and
              ServeEngine's graphed decode step under the mesh bitwise its
              eager step. Times (CUDA events over graph replays, in turns):
              the bucket-8 generator with and without the mesh, the training
              step with and without it. (b) two processes on the one card
              over gloo (DIST_PROCS_TIMEOUT_S): full-width DCGAN at batch 8
              on a data = 2 mesh, each rank running the kernels on its 4
              images; the gathered output bitwise the unsharded call on
              both ranks; the parameter gradients through the region
              within 1e-4 * max|ref| + 1e-5 of the unsharded ones; the
              run's wall (host clock). (c) python -m repro_torch.launch.train
              --mesh single-pod exits non-zero with the ValueError naming
              256 ranks (phase 25 runs --mesh host through the one-rank
              group). NCCL's and gloo's kernels are no hand-written kernels:
              the launch counters do not count them.
28. placement -- (run third, right after the build, on an empty card:
              the placed training's states and graphs do not fit in what the
              later phases leave fragmented; the launch counts are set to 0
              after it) the LM state placed over a mesh as DTensors.
              (a) The decode kernel's log-sum-exp output against its plain
              version at phase 14's shapes, fp32 and bf16, with a kv_len 0
              row each (out 0, lse -inf), within 1e-4 * max|ref| + 1e-5, and
              the lse variant timed at Llama-3-8B S 4096 beside its plain
              version, SDPA and the bound. (b) The cross-rank decode combine
              on one card: the kernel on the two halves of a 32768-row
              Llama-3-8B cache, kv_len clipped to each (three rows leave the
              second half empty), combined by their lse, within tolerance
              of the whole cache's call. (c) Under make_host_mesh(), the
              parameters placed (distribute_params): full-width Llama-3-8B
              at 2 layers, fp32, in its serving mode: the prefill and 16
              decode steps through the placed ServeEngine's graph within
              tolerance of the unplaced prefill and engine, each graphed step
              bitwise the placed eager step, decode launches counted; the
              graphed step timed placed and unplaced. Full-depth Qwen2-0.5B
              (bf16, seq 1024, batch 4) in its fsdp training mode: 3 graphed
              Trainer steps bitwise the placed eager steps, each against the
              unplaced step from the same state (metrics within 1e-3; each
              parameter leaf within 2 lr + 2^-7 of its largest, the moments
              within 2^-5 and 2^-4: bf16 sums in another order); the graphed
              step timed both ways; full-width xLSTM-125M (bf16, seq 256,
              batch 4) in its training mode (tp) alike. (d) Run before (c):
              Jamba (one period, 8 experts), xLSTM-125M and Whisper-large-v3
              (phase 26's cuts, bf16) placed on the host mesh beside the same
              parameters unplaced: the placed prefill's logits and cache
              bitwise the unplaced ones; 8 greedy decode steps through the
              placed engine's graph, each bitwise the unplaced engine's
              graphed step and the placed eager step from the same state
              (recurrent states restored between the two), with equal
              decode launches; 5 requests through both engines' 4 slots
              (one slot recycled), the same tokens; the graphed step timed
              placed and unplaced. (e) python -m repro_torch.launch.dryrun
              as processes, one a cell of DRYRUN_CELLS (Qwen2-0.5B train_4k,
              Llama-3-8B decode_32k, Jamba long_500k, xLSTM-125M and
              Whisper-large-v3 decode_32k, --mesh single; no card; started
              at the phase's start, on the host's cores), exit 0; logs and
              reports in chiprun_out/dryrun/.
29. result -- each phase's seconds, a JSON line of per-kernel numbers, then
              the last line {"ok": true, "device": {...}}.

Full results also go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

BATCH = 8
TOL_REL, TOL_ABS = 1e-4, 1e-5   # fp32 sums of up to 16384 terms, reordered
DCGAN_SHAPES = [  # (B, N, n, P, Cin, Cout) of DCGAN L0..L3 at batch 8
    (BATCH, 4, 4, 2, 1024, 512), (BATCH, 8, 4, 2, 512, 256),
    (BATCH, 16, 4, 2, 256, 128), (BATCH, 32, 4, 2, 128, 3),
]
ODD_SHAPES = [
    (2, 7, 3, 0, 37, 19),    # n = 3, P = 0: odd M = 11; Cout not a tile multiple
    (2, 6, 5, 1, 20, 70),    # n = 5, odd P: M = 9
    (1, 9, 3, 3, 33, 5),     # n = 3, odd P: M = 21
    (2, 5, 5, 3, 9, 130),    # n = 5, P = 3: M = 11, Cout = 130
]
FUSED_SHAPES = [  # beside DCGAN_SHAPES and ODD_SHAPES, the fused kernel's own
    (1, 8, 4, 2, 512, 256),  # DCGAN L1 at batch 1: Cin in 4 splits
    (1, 32, 4, 2, 128, 3),   # DCGAN L3 at batch 1: the poor layout, 8 splits
    (1, 64, 4, 2, 128, 64),  # EB-GAN L4
    (1, 128, 4, 2, 64, 64),  # EB-GAN L5
    (3, 6, 3, 1, 100, 70),   # 13 chunks in 8 uneven splits, 4-byte copies
]
# Two shapes per compiled instance (layout, R, d) of the fused kernel: n = 2R
# or 2R - 1, an odd and an even P, Cout <= 4 for the poor layout; Cin and
# Cout multiples of 4 or not, for each copy width.
VARIANT_SHAPES = [(2, 3 + n, n, pad, cin, cout)
                  for n in (2, 4, 5, 7) for pad in (n - 1, n - 2)
                  for cin, cout in ((12, 6), (10, 8), (8, 4), (5, 3))]
# Two shapes per compiled instance (layout, R, ks) of the per-phase kernel:
# n = 2R or 2R - 1 with an odd and an even P, on 6 x 6 inputs (rich ks = 1,
# and poor for Cout <= 4) and on 2 x 2 inputs (planes of at most 4 x 4: rich
# ks = 4); Cin and Cout multiples of 4 or not, for each copy width.
PHASE_VARIANT_SHAPES = (
    [(2, 6, n, pad, cin, cout) for n in (2, 4, 5, 7)
     for pad, (cin, cout) in ((n - 1, (12, 8)), (n - 2, (10, 6)),
                              (n - 1, (8, 4)), (n - 2, (5, 3)))]
    + [(2, 2, n, pad, cin, cout) for n, pads in ((2, (1, 0)), (4, (2, 3)))
       for pad, (cin, cout) in zip(pads, ((24, 8), (18, 6)))])
SERVE_RATES = (250.0, 1000.0, 2000.0)   # offered requests/s, open loop
SERVE_WINDOW_S = 5.0
OBS_RATE = 2000.0   # offered requests/s of phase 21's windows, open loop
TRAIN_TIMED_STEPS, TRAIN_WARMUP_STEPS, TRAIN_WINDOWS = 30, 5, 3
BWD_CU = "src/repro_torch/kernels/csrc/transpose_conv2d_bwd.cu"
SOURCES = {
    "fused": ("src/repro_torch/kernels/csrc/transpose_conv2d_fused.cu",
              "src/repro/kernels/transpose_conv2d.py:257"),
    "gemm": ("src/repro_torch/kernels/csrc/transpose_conv2d_gemm.cu",
             "src/repro/kernels/transpose_conv2d_gemm.py:234"),
    "epilogue_grad": (BWD_CU, "src/repro/kernels/transpose_conv2d_bwd.py:194"),
    "dx": (BWD_CU, "src/repro/kernels/transpose_conv2d_bwd.py:306"),
    "dw": (BWD_CU, "src/repro/kernels/transpose_conv2d_bwd.py:485"),
    "phase": ("src/repro_torch/kernels/csrc/transpose_conv2d_phase.cu",
              "src/repro/kernels/transpose_conv2d.py:395"),
    "pair": ("src/repro_torch/kernels/csrc/transpose_conv2d_pair.cu",
             "src/repro/kernels/transpose_conv2d_pair.py:348"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:84"),
}
# The GEMM kernel's check: with DCGAN_SHAPES and ODD_SHAPES, the zoo head
# layers at batch 1 (split contractions, a warp past the batch), a
# contraction too short to split, and 4-byte input with 16-byte weight
# copies (the other three copy widths are among the rest).
GEMM_SHAPES = DCGAN_SHAPES + ODD_SHAPES + [
    (1, 4, 4, 2, 1024, 512),    # DCGAN L0 at bucket 1: 17 splits, 272 blocks
    (1, 4, 4, 2, 2048, 1024),   # EB-GAN L0 at bucket 1
    (3, 5, 4, 2, 30, 12),       # Cin ragged, Cout a multiple of 4
    (2, 3, 2, 1, 8, 8),         # R = 1, one step: no split
]
FORWARD = ("fused", "gemm")
# the training path's kernels; epilogue-grad runs folded into dx and dw
TRAINING = ("fused", "gemm", "epilogue_grad_folded", "dx", "dw")
DCGAN_PAIRS = [  # (B, N, n, P, C0, C1, C2): DCGAN L0-1 and L2-3 at batch 8
    (BATCH, 4, 4, 2, 1024, 512, 256), (BATCH, 16, 4, 2, 256, 128, 3),
]
PAIR_CHECKS = DCGAN_PAIRS + [
    (1, 4, 4, 2, 2048, 1024, 512),   # EB-GAN L0-1
    (1, 16, 4, 2, 512, 256, 128),    # EB-GAN L2-3: 177 KB of shared memory
    (2, 5, 3, 1, 13, 21, 7),         # n = 3, odd P, C2 not a tile multiple
    (2, 7, 5, 3, 9, 12, 5),          # n = 5, odd P = 3
    (1, 6, 3, 0, 17, 35, 6),         # n = 3, P = 0, 9 cluster blocks
    # with the rows above, one shape for each compiled (R, d) instance
    (2, 3, 2, 1, 8, 8, 8),           # R = 1, d = 0
    (2, 4, 2, 0, 6, 10, 5),          # R = 1, d = 1
    (1, 5, 6, 2, 10, 9, 7),          # R = 3, d = 1
    (1, 4, 8, 3, 6, 10, 4),          # R = 4, d = 0: idle threads on a 3x3 plane
    (1, 5, 7, 2, 5, 6, 3),           # R = 4, d = 1
]
PAIR_OVER_BUDGET = (1, 64, 4, 2, 128, 64, 64)   # EB-GAN L4-5
# The backward check's shapes: with DCGAN_SHAPES and ODD_SHAPES, one for
# each poor dx and dw instance (Cout <= 4) at R = 1, 3 and 4, and a poor dx
# with 16-byte gm pixels and dx stores (Cout 4, Cin a multiple of 4).
BWD_SHAPES = DCGAN_SHAPES + ODD_SHAPES + [
    (2, 5, 2, 1, 7, 3),      # R = 1
    (2, 6, 5, 2, 9, 4),      # R = 3
    (1, 9, 7, 3, 6, 2),      # R = 4, two Cin quads ragged
    (2, 6, 4, 2, 12, 4),     # R = 2, 16-byte copies and stores
]
# dx with gm and the kernel as views 4 bytes into larger buffers: 4-byte
# copies at a Cout that is a multiple of 4 (the poor layout at Cout 4, the
# rich tile at Cout 8)
DX_UNALIGNED_SHAPES = [(2, 6, 4, 2, 12, 4), (2, 5, 3, 1, 9, 8)]
DECODE_CHECKS = [  # (B, S, KV, G, hd) of the decode kernel's check
    (8, 1024, 8, 4, 128),    # Llama-3-8B as phase 16 serves it (max_len 1024)
    (8, 4096, 8, 4, 128),    # Llama-3-8B
    (8, 32768, 8, 4, 128),   # Llama-3-8B at decode_32k: 32 splits to combine
    (8, 4096, 2, 7, 64),     # Qwen2-0.5B
    (8, 4096, 4, 8, 128),    # Yi-9B
    (2, 1024, 32, 1, 128),   # CodeQwen1.5-7B (MHA)
    (3, 1000, 2, 3, 64),     # S not a multiple of the split, odd G
    (4, 40000, 2, 4, 64),    # 40 splits: a lane of the combine takes two
    (8, 1024, 8, 6, 128),    # DBRX as phase 26 serves it (G 6: fp32 rounds G to 8)
    (8, 448, 20, 1, 64),     # Whisper's decoder self-attention, 448 rows
]
DECODE_TIMES = [(8, 4096, 8, 4, 128), (8, 32768, 8, 4, 128), (8, 32768, 2, 7, 64),
                (8, 1024, 8, 4, 128)]   # the last: Llama-3-8B as phase 16 serves it
# The paper's Tables 2-3 workload (its own copy of benchmarks/table2_flowers.py
# and table3_coco_pascal.py): 224 x 224 x 3 images at batch 4, kernels 5/4/3,
# P = 2, 3 output channels; each dataset's total is its sample count times the
# time an image takes, so the speedup per kernel does not depend on the group
PAPER_BATCH = 4
TABLE2_SHAPES = [(PAPER_BATCH, 224, n, 2, 3, 3) for n in (5, 4, 3)]
TABLE2_GROUPS = {"sunflower": 734, "tulip": 984, "daisy": 769, "rose": 784,
                 "dandelion": 1052}
TABLE3_DATASETS = {"mscoco2017_10pct": 11828,
                   "pascal_voc2012_classification": 17125,
                   "pascal_voc2012_segmentation": 2913}
# the forwards the paper phase times: the tap-by-tap oracle (the paper's
# naive baseline) and the entry's methods, "pallas" the fused kernel
PAPER_FORWARDS = ("naive", "conventional", "xla", "grouped", "unified",
                  "unified_reshape", "unified_fused", "unified_matmul", "pallas",
                  "pallas_phase", "auto")
PAPER_TRAINING = ("conventional", "unified", "auto")
LM_ARCH = "llama3-8b"
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS = 8, 1024, 16
LM_LONG = 32768          # the decode_32k cache length of one timed step
LM_PARITY = (2, 48, 40)  # batch, tokens, of which prefilled
LM_RTOL = LM_ATOL = 2e-3  # tests/test_consistency.py's prefill-then-decode tolerance
LM_TRAIN_ARCH = "qwen2-0.5b"
LM_TRAIN_SEQ, LM_TRAIN_BATCH = 4096, 4   # train_4k's length; its batch of 256 cut to 4
LM_TRAIN_TIMED = 10      # graphed steps timed after the 6 checked ones
LM_LOSS_DROP = 0.3       # tests/test_archs_smoke.py::test_train_step_decreases_loss
ENTRY_TIMEOUT_S = 300
# Phase 26's configurations: full width, bf16; cut in depth (and Jamba's
# experts) to fit one card beside the engine. (arch, cut, why)
FAMILY_SERVE = [
    ("dbrx-132b", {"n_layers": 4}, "4 of 40 layers"),
    ("jamba-1.5-large-398b", {"n_layers": 8, "n_experts": 8},
     "one period (8 of 72 layers: 7 Mamba, 1 attention, 4 MoE, 4 dense); experts "
     "16 -> 8 (one period with 16 is 84.27 GiB in bf16)"),
    ("xlstm-125m", {}, "none (12 layers)"),
]
# (arch, batch, text prompt, greedy steps, why): Whisper's 448 rows are its
# decoder's own limit; LLaVA's 2880 patches + 192 tokens divide into the
# chunked attention's 1024-row tiles
FAMILY_PREFILL = [
    ("whisper-large-v3", 8, 416, 32, "none (32 + 32 layers, 1500 frames); a cache of "
     "416 + 32 = 448 rows"),
    ("llava-next-mistral-7b", 4, 192, 32, "none (32 layers, 2880 patches + 192 tokens)"),
]
# fp32 parity at full width: (arch, cut, batch, tokens, prefilled, forward
# tokens or None, why); MoE at capacity E / k. Jamba's prompt is one 256-token
# Mamba chunk, its forward two
FAMILY_PARITY = [
    ("dbrx-132b", {"n_layers": 2}, 2, 48, 40, None, "2 of 40 layers (fp32)"),
    ("jamba-1.5-large-398b", {"n_layers": 8, "n_experts": 3}, 2, 264, 256, 512,
     "one period, experts 16 -> 3 (fp32: 4 would not fit beside the init)"),
    ("xlstm-125m", {}, 2, 48, 40, None, "none"),
    ("whisper-large-v3", {}, 2, 48, 40, None, "none"),
    ("llava-next-mistral-7b", {}, 2, 48, 40, None, "none (2880 patches + 48 tokens)"),
]
# the prefills profiled: the Mamba scan's and the sLSTM loop's library calls
FAMILY_PROFILED_PREFILL = ("jamba-1.5-large-398b", "xlstm-125m")
# Phase 27: the buckets sharded, the replays a time takes, the two-process
# run's time limit, and the MoE parity's cut (arch, cut, batch, tokens, why)
DIST_BUCKETS = (1, 8)
DIST_TIMED_CALLS = 50
DIST_PROCS_TIMEOUT_S = 300
DIST_MOE = ("dbrx-132b", {"n_layers": 2, "n_experts": 4}, 2, 48,
            "2 of 40 layers, experts 16 -> 4 (fp32, before phase 24's graphs)")


def log(*args) -> None:
    print(*args, flush=True)


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device(torch) -> dict:
    smi = _smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    info = {
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    log(f"[device] {info['name']} x{info['count']}  torch {info['torch']} "
        f"cuda {info['cuda']}")
    log(smi)
    log(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    _log_determinism(torch, "device")
    return info


def _log_determinism(torch, tag) -> None:
    log(f"[{tag}] deterministic algorithms "
        f"{torch.are_deterministic_algorithms_enabled()}, CUBLAS_WORKSPACE_CONFIG="
        f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}, cudnn.benchmark="
        f"{torch.backends.cudnn.benchmark}, fill_uninitialized_memory="
        f"{torch.utils.deterministic.fill_uninitialized_memory}")


def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build("transpose_conv2d_fused", "transpose_conv2d_gemm",
                        "transpose_conv2d_bwd", "transpose_conv2d_phase",
                        "transpose_conv2d_pair", "decode_attention", "gan_project",
                        "rgb_head")
    log(f"[build] eight sources in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():   # registers, shared memory, spills
        for line in text.splitlines():
            if line.strip():
                log(f"[build] {name}: {line.strip()}")
    fused = {}
    for fn, rep in _build.ptxas_report(logs["transpose_conv2d_fused"]).items():
        if "fused_kernelI" not in fn:
            continue
        ncg, npg, tw, ci, r, d = _build.template_args(fn.split("fused_kernelI", 1)[1])
        key = f"{'rich' if ncg > 1 else 'poor'} R{r} d{d}"
        fused[key] = {"ncg": ncg, "npg": npg, "tw": tw, "ci": ci, **rep}
        log(f"[build] fused_kernel {key} ({ncg * npg} threads, chunk {ci}): "
            f"{rep['registers']} registers, {rep['stack']} bytes stack, "
            f"{rep['spill_stores']} bytes spill stores, {rep['spill_loads']} "
            f"bytes spill loads")
    if len(fused) != 16:
        raise AssertionError(f"expected 16 fused kernel instances, got {sorted(fused)}")
    spilled = [k for k, v in fused.items() if v["spill_stores"] or v["spill_loads"]]
    if spilled:
        raise AssertionError(f"fused kernel instances spill: {spilled}")
    # the per-phase, pair, dw and decode kernels: every instance's registers
    # and spills (a per-phase instance must spill nothing; PERF.md explains
    # any other spill)
    instances = {}
    for src, kernel, label, want in (
            ("transpose_conv2d_phase", "phase_kernelI", "phase {} R{} ks{}", 10),
            ("transpose_conv2d_gemm", "gemm_kernel", "gemm", 1),
            ("transpose_conv2d_bwd", "dx_kernelI", "dx rich fold{}", 2),
            ("transpose_conv2d_bwd", "dx_poor_kernelI", "dx poor R{}", 4),
            ("transpose_conv2d_pair", "pair_kernelI", "pair R{} D{}", 8),
            ("transpose_conv2d_bwd", "dw_kernelI", "dw rich {}x{} fold{}", 4),
            ("transpose_conv2d_bwd", "dw_poor_kernelI", "dw poor R{}", 4),
            ("decode_attention", "split_kernelI", "decode {} G{} hd{}", 7),
            ("gan_project", "project_relu_kernel", "project relu", 1),
            ("gan_project", "project_dw_kernel", "project dw", 1),
            ("gan_project", "project_dz_kernel", "project dz", 1),
            ("rgb_head", "rgb_head_kernelI", "rgb head K/32 {}", 2),
            ("rgb_head", "rgb_head_dx_kernelI", "rgb head dx K/32 {}", 2),
            ("rgb_head", "rgb_head_dw_kernelI", "rgb head dw K/32 {}", 2),
            ("rgb_head", "rgb_head_sum_kernel", "rgb head sum", 1)):
        found = {}
        for fn, rep in _build.ptxas_report(logs[src]).items():
            if kernel not in fn:
                continue
            args = (_build.template_args(fn.split(kernel, 1)[1])
                    if kernel.endswith("I") else ())
            if kernel == "phase_kernelI":
                args = ("rich" if args[0] == 0 else "poor",) + args[1:]
            elif kernel == "split_kernelI":
                args = ("bf16" if "bfloat16" in fn else "fp32",) + args
            key = label.format(*args)
            found[key] = rep
            log(f"[build] {key}: {rep['registers']} registers, {rep['stack']} bytes "
                f"stack, {rep['spill_stores']} bytes spill stores, "
                f"{rep['spill_loads']} bytes spill loads")
        if len(found) != want:
            raise AssertionError(f"expected {want} {kernel} instances, got {sorted(found)}")
        instances.update(found)
    spilled = [k for k, v in instances.items()
               if k.startswith(("phase", "gemm", "dx", "project", "rgb")) and (
                   v["spill_stores"] or v["spill_loads"])]
    if spilled:
        raise AssertionError(f"per-phase, GEMM, dx, projection or RGB head kernels "
                             f"spill: {spilled}")
    return {"logs": logs, "fused_ptxas": fused, "ptxas": instances}


def _inputs(torch, shape, seed):
    b, n_in, n_k, _, cin, cout = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n_in, n_in, cin), device="cuda", generator=g)
    k = torch.randn((n_k, n_k, cin, cout), device="cuda", generator=g)
    k *= (n_k * n_k * cin) ** -0.5
    bias = 0.1 * torch.randn((cout,), device="cuda", generator=g)
    return x, k, bias


def kernels(names=tuple(SOURCES)):
    """``{name: (wrapper, plain version)}`` of the kernels ``names``."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import transpose_conv2d as tcf
    from repro_torch.kernels import transpose_conv2d_bwd as bw
    from repro_torch.kernels import transpose_conv2d_gemm as tcg
    from repro_torch.kernels import transpose_conv2d_pair as tcp

    every = {
        "fused": (tcf.transpose_conv2d_fused, tcf.transpose_conv2d_fused_plain),
        "gemm": (tcg.transpose_conv2d_gemm, tcg.transpose_conv2d_gemm_plain),
        "epilogue_grad": (bw.epilogue_grad, bw.epilogue_grad_plain),
        "dx": (bw.transpose_conv2d_dx, bw.transpose_conv2d_dx_plain),
        "dw": (bw.transpose_conv2d_dw, bw.transpose_conv2d_dw_plain),
        "phase": (tcf.transpose_conv2d_phase, tcf.transpose_conv2d_phase_plain),
        "pair": (tcp.transpose_conv2d_pair, tcp.transpose_conv2d_pair_plain),
        "decode_attention": (da.decode_attention, da.decode_attention_ref),
    }
    return {name: every[name] for name in names}


def epilogues():
    """Every epilogue: none, bias, and bias with each activation."""
    from repro_torch.kernels.epilogue import Epilogue

    return [None, Epilogue(True), Epilogue(True, "relu"), Epilogue(True, "tanh"),
            Epilogue(True, "leaky_relu", 0.2)]


def phase_check(torch) -> dict:
    from repro_torch.kernels import transpose_conv2d as tcf

    epis = epilogues()
    worst = {}
    common = DCGAN_SHAPES + ODD_SHAPES
    fused_shapes = common + FUSED_SHAPES + VARIANT_SHAPES
    geos = [tcf.fused_geometry(*s) for s in fused_shapes]
    if ({g.variant for g in geos} != tcf.fused_variants()
            or len({(g.vx, g.vw) for g in geos}) != 4):
        raise AssertionError("the check shapes miss an instance of the fused kernel")
    from repro_torch.kernels import transpose_conv2d_gemm as tcg

    for name, (launch, plain) in kernels(FORWARD).items():
        worst[name] = 0.0
        for i, shape in enumerate(fused_shapes if name == "fused" else GEMM_SHAPES):
            x, k, bias = _inputs(torch, shape, seed=i)
            pad = shape[3]
            for epi in epis:
                b = bias if epi is not None else None
                got = launch(x, k, pad, epilogue=epi, bias=b)
                want = plain(x, k, pad, epilogue=epi, bias=b)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                tol = TOL_REL * scale + TOL_ABS
                tag = epi.tag() if epi else "none"
                variant = (f" {geos[i].variant} splits {geos[i].splits}"
                           if name == "fused" else
                           f" splits {tcg.gemm_geometry(*shape).splits}")
                log(f"[check] {name} {shape}{variant} {tag}: max abs err {err:.3e} "
                    f"rel {err / max(scale, 1e-30):.3e} (tol {tol:.3e})")
                if not (got.shape == want.shape and err <= tol):
                    raise AssertionError(
                        f"{name} kernel disagrees with its plain version at "
                        f"{shape} {tag}: {err} > {tol}")
                worst[name] = max(worst[name], err)
    return worst


def _limits(flops, nbytes) -> dict:
    """The least time for ``flops`` fp32 operations on ``nbytes`` moved once:
    the larger of the two over the card's peak rates."""
    from repro_torch.launch.roofline import HBM_BW, PEAK_FP32_FLOPS

    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / HBM_BW * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": t_ops,
            "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _bound(shape) -> dict:
    from repro_torch.core.segregation import flop_count, output_size

    b, n_in, n_k, pad, cin, cout = shape
    m = output_size(n_in, n_k, pad)
    flops = 2 * b * flop_count(n_in, n_k, cin, cout, pad)
    nbytes = 4 * (b * n_in * n_in * cin + n_k * n_k * cin * cout + cout
                  + b * m * m * cout)
    return _limits(flops, nbytes)


def _layer_row(torch, i, shape, plain: bool) -> dict:
    """DCGAN layer ``i`` at ``shape``: the fused and GEMM kernels and the
    library call, by CUDA events and by graph replay, the plain versions
    (by events, if ``plain``) and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.epilogue import Epilogue
    from repro_torch.kernels.plan import cold_method
    from repro_torch.kernels.transpose_conv2d_gemm import gemm_geometry
    from repro_torch.timing import time_cuda

    b, n_in, n_k, pad, cin, cout = shape
    x, k, bias = _inputs(torch, shape, seed=100 + i)
    epi = Epilogue(True, "tanh" if i == len(DCGAN_SHAPES) - 1 else "relu")
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    w_t = torch.flip(k, (0, 1)).permute(2, 3, 0, 1).contiguous()
    act = torch.tanh if epi.act == "tanh" else torch.relu

    def library(xx, ww, bb, _pad=n_k - 1 - pad, _act=act):
        return _act(F.conv_transpose2d(xx, ww, bb, stride=2, padding=_pad))

    row = {"layer": f"L{i}", "shape": shape, "path": cold_method(n_in, n_k, pad),
           **_bound(shape),
           "library_ms": time_cuda(library, x_nchw, w_t, bias),
           "device_us": {"library": _device_us(torch, library, x_nchw, w_t, bias)}}
    for name, (launch, plain_fn) in kernels(FORWARD).items():
        row[f"{name}_ms"] = time_cuda(launch, x, k, pad, epilogue=epi, bias=bias)
        row["device_us"][name] = _device_us(torch, launch, x, k, pad, epilogue=epi,
                                            bias=bias)
        if plain:
            row[f"{name}_plain_ms"] = time_cuda(plain_fn, x, k, pad, epilogue=epi,
                                                bias=bias, iters=5)
    # the fused kernel again with the Cin split aiming at twice the blocks:
    # what the batch-free split rule trades between batch 1 and batch 8
    from repro_torch.kernels import transpose_conv2d as tcf

    target = tcf.SPLIT_TARGET
    try:
        tcf.SPLIT_TARGET = 2 * target
        tcf.fused_geometry.cache_clear()
        row["splits_2x_target"] = tcf.fused_geometry(*shape).splits
        row["device_us"]["fused_2x_target"] = _device_us(
            torch, kernels(("fused",))["fused"][0], x, k, pad, epilogue=epi, bias=bias)
    finally:
        tcf.SPLIT_TARGET = target
        tcf.fused_geometry.cache_clear()
    row["splits"] = tcf.fused_geometry(*shape).splits
    row["gemm_splits"] = gemm_geometry(*shape).splits
    dev = row["device_us"]
    log(f"[times] L{i} {shape} fused splits {row['splits']}: {dev['fused']:.2f} us; "
        f"at {2 * target} blocks an image, splits {row['splits_2x_target']}: "
        f"{dev['fused_2x_target']:.2f} us (device-only)")
    log(f"[times] L{i} {shape} path={row['path']}: fused {row['fused_ms']:.4f} ms"
        f" gemm (splits {row['gemm_splits']}) {row['gemm_ms']:.4f} ms library "
        f"{row['library_ms']:.4f} ms"
        + (f" | plain fused {row['fused_plain_ms']:.4f} gemm "
           f"{row['gemm_plain_ms']:.4f}" if plain else "")
        + f" | device-only us: fused {dev['fused']:.2f} gemm {dev['gemm']:.2f} "
        f"library {dev['library']:.2f} | bound {row['bound_ms'] * 1e3:.2f} us "
        f"({row['bound_by']}); fused at {row['bound_ms'] * 1e3 / dev['fused']:.1%}"
        f" of it")
    return row


def phase_times(torch) -> dict:
    from repro_torch.models import gan
    from repro_torch.timing import time_cuda

    layers = [_layer_row(torch, i, shape, plain=True)
              for i, shape in enumerate(DCGAN_SHAPES)]
    # batch 1, the bucket where latency is felt; L0 too, for the cold rule
    layers_b1 = [_layer_row(torch, i, (1,) + shape[1:], plain=False)
                 for i, shape in enumerate(DCGAN_SHAPES)]

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    eng = _warm_engine(cfg, params)
    generator = []
    for bucket in (1, 2, 4, 8):
        z = torch.randn((bucket, cfg.z_dim), device="cuda")
        row = {"bucket": bucket}
        for method in ("auto", "unified_reshape", "xla"):
            plan = gan.generator_plan(cfg, bucket, method=method)
            row[method] = time_cuda(gan.generator_apply, params, cfg, z, plan=plan)
        # the engine's executable: one CUDA graph of the auto plan
        row["graph"] = time_cuda(eng._executable(cfg.name, bucket), params, z)
        generator.append(row)
        log(f"[times] generator b{bucket}: kernels {row['auto']:.4f} ms, "
            f"unified_reshape {row['unified_reshape']:.4f} ms, xla {row['xla']:.4f} ms; "
            f"the kernels' CUDA graph {row['graph']:.4f} ms (CUDA events, 20 calls)")
    return {"layers": layers, "layers_b1": layers_b1, "generator": generator}


def _warm_engine(cfg, params, fuse="off", registry_path=None):
    """A GanEngine over full-width ``cfg`` at buckets 1/2/4/8, warmed (from
    the plan registry at ``registry_path``, if given): one CUDA graph per
    bucket."""
    from repro_torch.serve import BucketPolicy, GanEngine

    eng = GanEngine(BucketPolicy(buckets=(1, 2, 4, 8), max_wait_s=0.002,
                                 max_queue=256), fuse=fuse)
    eng.register(cfg, params)
    eng.warmup(registry_path=registry_path)
    return eng


def _call_wall_us(torch, fn, *args, calls: int = 50) -> float:
    """Median host microseconds of one call of ``fn`` that ends in a
    synchronise, as a served batch does."""
    import numpy as np

    walls = []
    for _ in range(calls + 3):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(walls[3:]))


def _kernel_times(prof) -> dict:
    """Device microseconds by kernel name. Only the device's own events
    count: a host-side range (an aten op, an autograd Function) also
    reports the device time of the kernels it launched, which would count
    them twice."""
    from torch.autograd import DeviceType

    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def phase_profile(torch) -> dict:
    """Device busy time of the generator through the kernels, from
    torch.profiler over 10 calls at batch 1 and 8: per-call device time,
    the share of the (profiled) wall the device sat idle, top kernels."""
    from repro_torch.models import gan

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    eng = _warm_engine(cfg, params)
    out = {}
    for bucket in (1, 2, 4, BATCH):
        z = torch.randn((bucket, cfg.z_dim), device="cuda")
        plan = gan.generator_plan(cfg, bucket)
        fn = eng._executable(cfg.name, bucket)
        graphed = out[f"graph_{bucket}"] = _profile_step(torch, fn, params, z, calls=10,
                                                         top=6)
        graphed["call_wall_us"] = _call_wall_us(torch, fn, params, z)
        # the profiler's own cost inflates its wall: the idle share of a
        # call that ends in a sync, by the host clock, leaves it out
        graphed["call_idle_share"] = 1 - graphed["device_us"] / graphed["call_wall_us"]
        out[f"eager_{bucket}_call_wall_us"] = _call_wall_us(
            torch, lambda zz: gan.generator_apply(params, cfg, zz, plan=plan), z)
        _log_profile(f"profile b{bucket} graph", graphed)
        log(f"[profile b{bucket}] one call ending in a sync, median of 50: graph "
            f"{graphed['call_wall_us']:.1f} us (idle share "
            f"{graphed['call_idle_share']:.3f}), eager "
            f"{out[f'eager_{bucket}_call_wall_us']:.1f} us (host clock)")
        if bucket in (1, BATCH):
            eager = out[bucket] = _profile_step(torch, gan.generator_apply, params, cfg,
                                                z, plan=plan, calls=10, top=6)
            eager["call_idle_share"] = (1 - eager["device_us"]
                                        / out[f"eager_{bucket}_call_wall_us"])
            _log_profile(f"profile b{bucket} eager", eager)
            log(f"[profile b{bucket}] eager call's idle share by the host clock "
                f"{eager['call_idle_share']:.3f}")
    return out


def _count_delta(fn, *args, **kwargs):
    """``(fn(...), the launch counts the call added)``."""
    before = _read_counts()
    out = fn(*args, **kwargs)
    after = _read_counts()
    return out, {k: after[k] - before[k] for k in after}


def _graphs_against_eager(torch, eng, cfg, params, tag) -> dict:
    """Each bucket's executable (one CUDA graph) bitwise equal to the eager
    call of its plan on the same latents, and counting that call's
    launches: ``{bucket: the eager call's launch counts}``."""
    from repro_torch.models import gan

    slot = eng.registry[cfg.name]
    gen = torch.Generator(device="cuda").manual_seed(11)
    counts = {}
    for bucket in eng.policy.buckets:
        z = torch.randn((bucket, cfg.z_dim), device="cuda", generator=gen)
        want, counts[bucket] = _count_delta(gan.generator_apply, params, cfg, z,
                                            plan=slot.plans[bucket])
        got, replayed = _count_delta(eng._executable(cfg.name, bucket), params, z)
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}: bucket {bucket}'s graph differs from its eager "
                                 f"call by {(got - want).abs().max().item()}")
        if replayed != counts[bucket]:
            raise AssertionError(f"{tag}: bucket {bucket}'s replay counted {replayed}, "
                                 f"its eager call {counts[bucket]}")
    log(f"[{tag}] every bucket's graph bitwise equal to its eager call, and counting "
        f"its launches: {counts}")
    return counts


def _replay_counted(eng, reqs, arrivals, per_bucket, tag) -> dict:
    """Replay the trace, recording each batch's bucket; the launch counts of
    the replay must equal, exactly, the sum of each batch's eager counts."""
    buckets = []
    execute = eng._execute

    def recording(name, batch, bucket):
        buckets.append(bucket)
        execute(name, batch, bucket)

    eng._execute = recording
    gc.collect()   # earlier work's garbage (engines, graphs) freed before the replay
    _reset_counts()
    eng.replay(reqs, arrivals)
    launches = _read_counts()
    del eng._execute   # the class's method again, with no cycle through the instance
    want = {k: sum(per_bucket[b][k] for b in buckets) for k in launches}
    if launches != want:
        raise AssertionError(f"{tag}: the replays counted {launches}, their batches' "
                             f"eager calls {want}")
    return launches


def _memory(torch) -> dict:
    """Device bytes held by tensors, their peak, and held by the caching
    allocator (a graph's pool keeps its intermediates' blocks reserved)."""
    torch.cuda.synchronize()
    return {"allocated": torch.cuda.memory_allocated(),
            "peak": torch.cuda.max_memory_allocated(),
            "reserved": torch.cuda.memory_reserved()}


def phase_engine(torch) -> dict:
    from repro_torch.models import gan

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    torch.cuda.reset_peak_memory_stats()
    mem = {"before_warmup": _memory(torch)}
    t0 = time.perf_counter()
    eng = _warm_engine(cfg, params)
    warm_s = time.perf_counter() - t0
    mem["after_warmup"] = _memory(torch)
    per_bucket = _graphs_against_eager(torch, eng, cfg, params, "engine")
    reqs, arrivals = _dcgan_requests(cfg)
    launches = _replay_counted(eng, reqs, arrivals, per_bucket, "engine")

    summary = eng.metrics.summary()
    cons = eng.conservation()
    if not all(r.done for r in reqs):
        raise AssertionError("not every request was served")
    if not cons["ok"]:
        raise AssertionError(f"conservation failed: {cons}")
    if eng.metrics.recompiles != eng.warmup_recompiles:
        raise AssertionError("executables were built after warm-up")
    if not all(bool(torch.isfinite(r.output).all()) for r in reqs):
        raise AssertionError("non-finite output")
    if min(launches[name] for name in FORWARD) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    for r in reqs:
        one = gan.generator_apply(params, cfg, r.z).cpu()
        if not torch.equal(one, r.output):
            raise AssertionError(
                f"request {r.rid} (n={r.n}) differs from its unbatched call "
                f"by {(one - r.output).abs().max().item()}")
    z = torch.randn((BATCH, cfg.z_dim), device="cuda")
    got = gan.generator_apply(params, cfg, z, plan=gan.generator_plan(cfg, BATCH))
    want = gan.generator_apply(params, cfg, z, plan=gan.generator_plan(
        cfg, BATCH, method="unified_reshape"))
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = TOL_REL * want.abs().max().item() + TOL_ABS
    if err > tol:
        raise AssertionError(f"kernels vs unified_reshape plan: {err} > {tol}")
    lat = summary["latency_s"]
    log(f"[engine] {torch.cuda.get_device_name(0)}: {summary['requests']} requests"
        f" / {summary['samples']} samples in {summary['batches']} batches, "
        f"{summary['samples_per_s']:.1f} samples/s, latency p50 "
        f"{lat['p50'] * 1e3:.3f} ms p99 {lat['p99'] * 1e3:.3f} ms, pad waste "
        f"{summary['pad_waste']:.3f}, warm-up {warm_s:.2f} s (4 graphs captured)")
    log(f"[engine] device memory before / after warm-up {mem['before_warmup']} / "
        f"{mem['after_warmup']} (bytes)")
    log(f"[engine] launches during serving {launches}, exactly the batches' eager "
        f"counts; bitwise batch-invariant; vs unified_reshape max abs err {err:.3e}; "
        f"conservation {cons}")
    return {"summary": {k: v for k, v in summary.items() if k != "per_model"},
            "launches": launches, "eager_launches_per_bucket": per_bucket,
            "warmup_s": warm_s, "memory": mem, "vs_unified_reshape": err}


PROJECTION_BATCHES = (1, 8, 64, 128)   # buckets 1, 8 and 64; the training batch


def phase_projection(torch) -> dict:
    """The latent projection at DCGAN's shape (W 100 x 16384): whether one
    batched cuBLAS ``z @ w`` gives each row the bits of its one-row call
    (1-8 rows: it does not, which is why the port has its own kernels);
    whether the projection kernel gives each row the bits of that row at
    batch 128 (every batch 1-8, 64, 128: it must), and its forward, dW and
    dz within tolerance of float64; then, by graph replay, the kernel
    against the per-row cuBLAS path it replaced and one batched cuBLAS call
    (each with relu) at buckets 1, 8, 64 and batch 128, dW against the
    per-row path's 128 one-row products summed in turn and one cuBLAS
    ``z^T @ gm``, each beside its bound."""
    from repro_torch.kernels import project as proj
    from repro_torch.models import gan

    cfg = gan.DCGAN
    h0, c0, _ = cfg.layers[0]
    k, n = cfg.z_dim, h0 * h0 * c0
    g = torch.Generator(device="cuda").manual_seed(7)
    w = 0.02 * torch.randn((k, n), device="cuda", generator=g)
    z = torch.randn((128, k), device="cuda", generator=g)
    gy = torch.randn((128, n), device="cuda", generator=g)
    rows = torch.cat([z[i : i + 1] @ w for i in range(8)])
    out = {"cublas": {}, "kernel": {}, "times": {}}
    for m in range(1, 9):
        batched = z[:m] @ w
        out["cublas"][m] = {"bitwise": bool(torch.equal(batched, rows[:m])),
                            "max_abs_diff": (batched - rows[:m]).abs().max().item()}
        log(f"[projection] batched z[:{m}] @ w vs one-row calls: bitwise "
            f"{out['cublas'][m]['bitwise']}, max abs diff "
            f"{out['cublas'][m]['max_abs_diff']:.3e}")
    full = proj.project_relu_fwd(z, w)
    for m in (*range(1, 9), 64, 128):
        same = bool(torch.equal(proj.project_relu_fwd(z[:m], w), full[:m]))
        out["kernel"][m] = same
        if not same:
            raise AssertionError(f"projection kernel: rows at batch {m} differ from "
                                 f"batch 128's")
    log("[projection] kernel: every row at batch 1-8, 64 and 128 bitwise that row "
        "at batch 128 (bitwise invariant: True)")
    y = full
    gm = torch.where(y <= 0, 0.0, gy)
    errs = {}
    for name, got, want in (
            ("forward", y, torch.relu(z.double() @ w.double())),
            ("dw", proj.project_relu_dw(z, y, gy), z.double().t() @ gm.double()),
            ("dz", proj.project_relu_dz(w, y, gy), gm.double() @ w.double().t())):
        errs[name] = (got.double() - want).abs().max().item()
        tol = TOL_REL * want.abs().max().item() + TOL_ABS
        if errs[name] > tol:
            raise AssertionError(f"projection {name} vs float64: {errs[name]} > {tol}")
    out["max_abs_err"] = errs
    log(f"[projection] kernel vs float64 max abs err {errs}")

    def per_row_dw(zz, gg):
        dw = zz[0:1].t() @ gg[0:1]
        for i in range(1, zz.shape[0]):
            dw = dw + zz[i : i + 1].t() @ gg[i : i + 1]
        return dw

    card = torch.cuda.get_device_name(0)
    for m in PROJECTION_BATCHES:
        zm = z[:m]
        row = {
            "kernel_us": _device_us(torch, proj.project_relu_fwd, zm, w),
            "per_row_us": _device_us(torch, lambda a: torch.relu(proj.project_rows(a, w)),
                                     zm),
            "cublas_us": _device_us(torch, lambda a: torch.relu(a @ w), zm),
            **_limits(2 * m * k * n, 4 * (m * k + k * n + m * n)),
        }
        if m == 128:
            row.update({
                "dw_kernel_us": _device_us(torch, proj.project_relu_dw, zm, y, gy),
                "dw_per_row_us": _device_us(torch, per_row_dw, zm, gm),
                "dw_cublas_us": _device_us(torch, lambda a, b: a.t() @ b, zm, gm),
                "dw_bound": _limits(2 * m * k * n, 4 * (m * k + 2 * m * n + k * n)),
            })
        out["times"][m] = row
        log(f"[projection] {card} batch {m}: kernel {row['kernel_us']:.2f} us, per-row "
            f"cuBLAS + relu {row['per_row_us']:.2f} us, one cuBLAS call + relu "
            f"{row['cublas_us']:.2f} us, bound {row['bound_ms'] * 1e3:.2f} us "
            f"({row['bound_by']})")
        if m == 128:
            log(f"[projection] {card} dW at batch 128: kernel {row['dw_kernel_us']:.2f} us"
                f", per-row products summed {row['dw_per_row_us']:.2f} us, one cuBLAS "
                f"call {row['dw_cublas_us']:.2f} us, bound "
                f"{row['dw_bound']['bound_ms'] * 1e3:.2f} us "
                f"({row['dw_bound']['bound_by']})")
    return out


HEAD_SHAPE = (64, 256, 64, 3)   # EB-GAN's head in its cell: batch, side, K, C
HEAD_BUCKETS = (1, 8, 64)


def phase_rgb_head(torch) -> dict:
    """EB-GAN's RGB head at its cell's shape (batch 64, 256^2 pixels,
    64 -> 3): the forward, dx and dW/db kernels within tolerance of
    float64 (1e-4 of the largest entry: a wrong sum, tap or tanh' is off
    by far more); each sample at buckets 1, 8 and 64 bitwise that sample
    at batch 64, forward and dx; one launch a call (dW two: its sum
    pass), and through the autograd function one forward, one dx, one dW
    and one sum; then, by graph replay, each kernel against its plain
    version (the wrapper's eager ``head_plain`` / ``head_dx_plain`` /
    ``head_dw_plain``) and one cuBLAS call (``addmm`` + tanh forward; dx
    and dW the product alone, given ``g * (1 - y^2)``), beside its bound."""
    from repro_torch.kernels import rgb_head as head
    from repro_torch.models import gan

    b, hw, k, c = HEAD_SHAPE
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.relu(torch.randn((b, hw, hw, k), device="cuda", generator=g))
    w = torch.randn((k, c), device="cuda", generator=g) * k ** -0.5
    bias = 0.1 * torch.randn((c,), device="cuda", generator=g)
    gy = torch.randn((b, hw, hw, c), device="cuda", generator=g)
    out = {"shape": HEAD_SHAPE, "times": {}}

    fns = (head.rgb_head_fwd, head.rgb_head_dx, head.rgb_head_dw)

    def counts():
        return [f.launches for f in fns] + [head.rgb_head_dw.reduce_launches]

    before = counts()
    y = head.rgb_head_fwd(x, w, bias)
    dx = head.rgb_head_dx(gy, y, w)
    dw, db = head.rgb_head_dw(x, gy, y)
    calls = [a - n for a, n in zip(counts(), before)]
    xx = x.clone().requires_grad_(True)
    ww, bb = w.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    before = counts()
    (gan.rgb_head(xx, ww, bb) * gy).sum().backward()
    function = [a - n for a, n in zip(counts(), before)]
    out["launches"] = {"wrappers": calls, "function": function}
    if calls != [1, 1, 1, 1] or function != [1, 1, 1, 1]:
        raise AssertionError(f"RGB head launches (forward, dx, dW, sum): wrappers {calls}, "
                             f"function {function}; want one each")
    if not (torch.equal(xx.grad, dx) and torch.equal(ww.grad, dw) and torch.equal(bb.grad, db)):
        raise AssertionError("the RGB head's function differs from its wrappers")
    del xx, ww, bb
    log(f"[rgb-head] launches a call (forward, dx, dW, sum): wrappers {calls}, the autograd "
        f"function's forward and backward {function}")

    for n in HEAD_BUCKETS:
        if not (torch.equal(head.rgb_head_fwd(x[:n].clone(), w, bias), y[:n])
                and torch.equal(head.rgb_head_dx(gy[:n].clone(), y[:n].clone(), w), dx[:n])):
            raise AssertionError(f"RGB head: rows at batch {n} differ from batch {b}'s")
    out["bitwise_buckets"] = list(HEAD_BUCKETS)
    log(f"[rgb-head] forward and dx: every sample at batch {HEAD_BUCKETS} bitwise that "
        f"sample at batch {b} (bitwise invariant: True)")

    errs = {}
    x64, w64 = x.double().reshape(-1, k), w.double()
    y64 = torch.tanh(x64 @ w64 + bias.double())
    gm64 = gy.double().reshape(-1, c) * (1 - y.double().reshape(-1, c) ** 2)
    for name, got, want in (("forward", y.reshape(-1, c), y64),
                            ("dx", dx.reshape(-1, k), gm64 @ w64.t()),
                            ("dw", dw, x64.t() @ gm64), ("db", db, gm64.sum(0))):
        errs[name] = (got.double() - want).abs().max().item()
        tol = TOL_REL * want.abs().max().item() + TOL_ABS
        log(f"[rgb-head] {name} vs float64: max abs err {errs[name]:.3e} (tol {tol:.3e})")
        if errs[name] > tol:
            raise AssertionError(f"RGB head {name} vs float64: {errs[name]} > {tol}")
    out["max_abs_err"] = errs
    del x64, y64, gm64

    px = b * hw * hw
    flops = 2 * px * k * c
    gm = head.tanh_grad(gy, y)
    x2, gm2 = x.reshape(-1, k), gm.reshape(-1, c)
    card = torch.cuda.get_device_name(0)
    rows = {
        "forward": (lambda: head.rgb_head_fwd(x, w, bias), lambda: head.head_plain(x, w, bias),
                    lambda: torch.tanh(torch.addmm(bias, x2, w)),
                    _limits(flops, 4 * (px * k + k * c + c + px * c))),
        "dx": (lambda: head.rgb_head_dx(gy, y, w), lambda: head.head_dx_plain(gy, y, w),
               lambda: gm2 @ w.t(), _limits(flops, 4 * (2 * px * c + k * c + px * k))),
        "dw": (lambda: head.rgb_head_dw(x, gy, y), lambda: head.head_dw_plain(x, gy, y),
               lambda: x2.t() @ gm2, _limits(flops, 4 * (px * k + 2 * px * c + k * c + c))),
    }
    for name, (kernel, plain, library, bound) in rows.items():
        row = {"kernel_us": _device_us(torch, kernel, calls=10),
               "plain_us": _device_us(torch, plain, calls=10),
               "library_us": _device_us(torch, library, calls=10), **bound}
        row["roofline"] = row["bound_ms"] * 1e3 / row["kernel_us"]
        out["times"][name] = row
        log(f"[rgb-head] {card} {name} at {HEAD_SHAPE}: kernel {row['kernel_us']:.2f} us "
            f"({100 * row['roofline']:.1f}% of its bound), plain {row['plain_us']:.2f} us, "
            f"one cuBLAS call {row['library_us']:.2f} us, bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
    step = 2 * out["times"]["forward"]["kernel_us"] + out["times"]["dx"]["kernel_us"] \
        + out["times"]["dw"]["kernel_us"]
    out["step_us"] = step
    log(f"[rgb-head] {card} a training step's head (two forwards, dx, dW): {step:.2f} us")
    del x, gy, y, dx, gm, x2, gm2
    torch.cuda.empty_cache()
    return out


def phase_serving(torch, fuse="off", eager=False) -> list:
    """Open-loop windows at SERVE_RATES through the engine's CUDA graphs;
    with ``eager``, through executables that run the generator eagerly (the
    engine's path before it captured graphs), as a yardstick."""
    import numpy as np

    from repro_torch.models import gan
    from repro_torch.serve import GenRequest

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    path = "eager" if eager else "graph"
    rows = []
    for rate in SERVE_RATES:
        eng = _warm_engine(cfg, params, fuse)
        if eager:
            slot = eng.registry[cfg.name]
            for bucket, plan in slot.plans.items():
                slot.apply[bucket] = (lambda p, z, _plan=plan:
                                      gan.generator_apply(p, cfg, z, plan=_plan))
        rng = np.random.default_rng(int(rate))
        count = int(rate * SERVE_WINDOW_S)
        sizes = rng.integers(1, 5, size=count)
        zs = rng.standard_normal((int(sizes.sum()), cfg.z_dim)).astype(np.float32)
        ends = np.cumsum(sizes)
        reqs = [GenRequest("dcgan", zs[e - n : e]) for n, e in zip(sizes, ends)]
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=count)).tolist()
        t0 = time.perf_counter()
        eng.replay(reqs, arrivals)
        wall_s = time.perf_counter() - t0
        cons = eng.conservation()
        if not cons["ok"] or cons["failed"] or cons["expired"]:
            raise AssertionError(f"serving at {rate} req/s: {cons}")
        if eng.metrics.recompiles != eng.warmup_recompiles:
            raise AssertionError("executables were built after warm-up")
        s = eng.metrics.summary()
        lat = s["latency_s"]
        row = {"fuse": fuse, "path": path, "offered_requests_per_s": rate,
               "offered_samples_per_s": rate * float(sizes.mean()),
               "window_s": SERVE_WINDOW_S, "wall_s": wall_s,
               "requests": count, "done": s["requests"], "rejected": s["rejected"],
               "samples": s["samples"], "batches": s["batches"],
               "samples_per_s": s["samples_per_s"],
               "requests_per_s": s["requests_per_s"], "pad_waste": s["pad_waste"],
               "latency_ms": {k: v * 1e3 for k, v in lat.items()}}
        rows.append(row)
        log(f"[serve] fuse={fuse} {path} {torch.cuda.get_device_name(0)} offered {rate} req/s "
            f"({row['offered_samples_per_s']} samples/s) for {SERVE_WINDOW_S} s:"
            f" {s['requests']} done, {s['rejected']} rejected, {s['samples']} "
            f"samples in {s['batches']} batches, {s['samples_per_s']} samples/s,"
            f" latency ms p50 {lat['p50'] * 1e3} p95 {lat['p95'] * 1e3} p99 "
            f"{lat['p99'] * 1e3} max {lat['max'] * 1e3}, pad waste "
            f"{s['pad_waste']}, replay wall {wall_s} s")
        del eng, reqs
    return rows


def _bwd_inputs(torch, shape, seed):
    """x, kernel, bias and a cotangent ``g`` of the layer's output."""
    x, k, bias = _inputs(torch, shape, seed)
    b, n_in, n_k, pad, _, cout = shape
    m = 2 * n_in - n_k + 2 * pad
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    return x, k, bias, torch.randn((b, m, m, cout), device="cuda", generator=gen)


def _worst(name, shape, tag, pairs, worst) -> None:
    """Raise unless each (kernel, plain) pair agrees within the tolerance;
    keep the worst error per kernel."""
    for got, want in pairs:
        err = (got - want).abs().max().item()
        tol = TOL_REL * want.abs().max().item() + TOL_ABS
        if not (got.shape == want.shape and err <= tol):
            raise AssertionError(f"{name} kernel disagrees with its plain version "
                                 f"at {shape} {tag}: {err} > {tol}")
        worst[name] = max(worst[name], err)


def _offset_view(torch, t, offset=1):
    """A contiguous copy of ``t`` that starts ``offset`` elements into a
    larger buffer, so its first element is not 16-byte aligned."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def _fold_gate(torch, bw, x, k, g, y, epi, shape, tag) -> None:
    """Raise unless dx, dw and db of the kernels given ``g``, ``y`` and the
    epilogue (act' folded into their staging) are bitwise those of the
    standalone epilogue-grad kernel, then dx and dw on the gm it wrote;
    count that the folded launches are two where there is an activation
    and that no standalone epilogue-grad kernel runs in them."""
    n_in, n_k, pad = shape[1], shape[2], shape[3]
    with_db = epi is not None and epi.bias
    gm = bw.epilogue_grad(g, y, epi)
    want = [bw.transpose_conv2d_dx(gm, k, n_in, pad)]
    want += list(bw.transpose_conv2d_dw(x, gm, n_k, pad, with_db=True))
    before = (bw.epilogue_grad.launches, bw.epilogue_grad.folded_launches)
    got = [bw.transpose_conv2d_dx(g, k, n_in, pad, y=y, epilogue=epi)]
    got += list(bw.transpose_conv2d_dw(x, g, n_k, pad, with_db=True, y=y, epilogue=epi))
    torch.cuda.synchronize()
    folded = 2 if epi is not None and epi.act != "none" else 0
    after = (bw.epilogue_grad.launches, bw.epilogue_grad.folded_launches)
    if after != (before[0], before[1] + folded):
        raise AssertionError(f"fold at {shape} {tag}: counters {before} -> {after}")
    for name, a, b in zip(("dx", "dw", "db"), got, want):
        if name == "db" and not with_db:
            continue
        if not torch.equal(a, b):
            raise AssertionError(
                f"fold at {shape} {tag}: {name} is not bitwise the three-kernel "
                f"route's (max abs diff {(a - b).abs().max().item():.3e})")


def phase_bwd_check(torch) -> dict:
    """Each backward kernel against its plain version. The plain forward
    gives ``y``; the plain epilogue-grad gives the ``gm`` that both dx and
    dw versions take, so each error is the kernel's own. Then the fold of
    act' into dx and dw against the three-kernel route, bitwise."""
    from repro_torch.kernels import transpose_conv2d as tcf

    from repro_torch.kernels import transpose_conv2d_bwd as bw

    bwd = kernels(("epilogue_grad", "dx", "dw"))
    if {bw.bwd_geometry(*s).dw_variant for s in BWD_SHAPES} != bw.dw_variants():
        raise AssertionError("the backward check shapes miss an instance of dw")
    if {bw.bwd_geometry(*s).dx_variant for s in BWD_SHAPES} != bw.dx_variants():
        raise AssertionError("the backward check shapes miss an instance of dx")
    worst = dict.fromkeys(bwd, 0.0)
    for i, shape in enumerate(BWD_SHAPES):
        x, k, bias, g = _bwd_inputs(torch, shape, seed=200 + i)
        b, n_in, n_k, pad, _, _ = shape
        for epi in epilogues():
            tag = epi.tag() if epi else "none"
            with_db = epi is not None and epi.bias
            y = tcf.transpose_conv2d_fused_plain(x, k, pad, epilogue=epi,
                                                 bias=bias if epi else None)
            gm = bwd["epilogue_grad"][1](g, y, epi)
            got = bwd["epilogue_grad"][0](g, y, epi)
            if not torch.equal(got, gm):
                raise AssertionError(f"epilogue_grad at {shape} {tag} is not bitwise "
                                     f"its plain version")
            _worst("epilogue_grad", shape, tag, [(got, gm)], worst)
            _worst("dx", shape, tag,
                   [(bwd["dx"][0](gm, k, n_in, pad), bwd["dx"][1](gm, k, n_in, pad))],
                   worst)
            got = bwd["dw"][0](x, gm, n_k, pad, with_db=with_db)
            want = bwd["dw"][1](x, gm, n_k, pad, with_db=with_db)
            _worst("dw", shape, tag,
                   list(zip(got, want)) if with_db else [(got, want)], worst)
            _fold_gate(torch, bw, x, k, g, y, epi, shape, tag)
        torch.cuda.synchronize()
        geo = bw.bwd_geometry(*shape)
        log(f"[bwd-check] {shape} dx {geo.dx_variant} splits {geo.dx_splits}, dw "
            f"{geo.dw_variant} splits {geo.dw_splits}: every epilogue within "
            f"tolerance, epilogue-grad bitwise its plain version, folded dx/dw/db "
            f"bitwise the three-kernel route; worst so far "
            + ", ".join(f"{n} {e:.3e}" for n, e in worst.items()))
    for i, shape in enumerate(DX_UNALIGNED_SHAPES):
        _, k, _, gm = _bwd_inputs(torch, shape, seed=300 + i)
        n_in, pad = shape[1], shape[3]
        gu, ku = _offset_view(torch, gm), _offset_view(torch, k)
        if bw.dx_copy_widths(gu, ku)[0] or not bw.dx_copy_widths(gm, k)[0]:
            raise AssertionError(f"dx at {shape} does not reach 4-byte copies "
                                 "through unaligned operands")
        _worst("dx", shape, "unaligned",
               [(bwd["dx"][0](gu, ku, n_in, pad), bwd["dx"][1](gm, k, n_in, pad))],
               worst)
        # y 4 bytes off alignment: g and y take the 4-byte copies in dx and dw
        x, k, bias, g = _bwd_inputs(torch, shape, seed=400 + i)
        epi = epilogues()[3]
        y = tcf.transpose_conv2d_fused_plain(x, k, pad, epilogue=epi, bias=bias)
        yu = _offset_view(torch, y)
        if bw.dx_copy_widths(g, k, yu)[0] or not bw.dx_copy_widths(g, k, y)[0]:
            raise AssertionError(f"the fold at {shape} does not reach 4-byte copies "
                                 "through an unaligned y")
        _fold_gate(torch, bw, x, k, g, yu, epi, shape, "unaligned y")
        torch.cuda.synchronize()
        log(f"[bwd-check] {shape} dx {bw.bwd_geometry(*shape).dx_variant} with "
            f"unaligned gm and kernel: within tolerance; worst dx {worst['dx']:.3e}; "
            f"with an unaligned y the folded dx/dw/db bitwise the three-kernel route")
    return worst


def _live(params):
    return {k: {n: t.detach().requires_grad_(True) for n, t in v.items()}
            for k, v in params.items()}


def phase_autograd(torch) -> dict:
    """The generator's parameter gradients through the backward kernels
    against the plan pinned to ``bwd="autograd"``."""
    from repro_torch.models import gan

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    hw, c = cfg.out_hw(cfg.layers[-1][0]), cfg.layers[-1][2]
    z = torch.randn((BATCH, cfg.z_dim), device="cuda", generator=gen)
    r = torch.randn((BATCH, hw, hw, c), device="cuda", generator=gen)
    grads = {}
    for bwd in ("segregated", "autograd"):
        live = _live(params)
        plan = gan.generator_plan(cfg, BATCH, bwd=bwd)
        (gan.generator_apply(live, cfg, z, plan=plan) * r).sum().backward()
        grads[bwd] = {f"{k}.{n}": t.grad for k, v in live.items()
                      for n, t in v.items()}
    out = {}
    for key, want in grads["autograd"].items():
        got = grads["segregated"][key]
        err = (got - want).abs().max().item()
        tol = TOL_REL * want.abs().max().item() + TOL_ABS
        out[key] = {"max_abs_err": err, "tol": tol}
        log(f"[autograd] d{key}: segregated vs autograd max abs err {err:.3e} "
            f"(tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"generator gradient {key}: {err} > {tol}")
    return out


def _bwd_bounds(shape) -> dict:
    """Least times of the three backward kernels at ``shape``: dx and dw do
    the forward's MACs; epilogue-grad reads g and y and writes gm (3
    operations an element at most: tanh's). The folded dx and dw read g and
    y where the others read gm and do those operations too; the backward
    (either route) reads g, y, x and the kernel once and writes dx, dw and
    db once."""
    from repro_torch.core.segregation import flop_count, output_size

    b, n_in, n_k, pad, cin, cout = shape
    m = output_size(n_in, n_k, pad)
    flops = 2 * b * flop_count(n_in, n_k, cin, cout, pad)
    x_b, g_b, w_b = 4 * b * n_in * n_in * cin, 4 * b * m * m * cout, 4 * n_k * n_k * cin * cout
    act = 3 * b * m * m * cout
    return {"dx": _limits(flops, g_b + w_b + x_b),
            "dw": _limits(flops, x_b + g_b + w_b + 4 * cout),
            "epilogue_grad": _limits(act, 3 * g_b),
            "dx_folded": _limits(flops + act, 2 * g_b + w_b + x_b),
            "dw_folded": _limits(flops + act, x_b + 2 * g_b + w_b + 4 * cout),
            "bwd": _limits(2 * flops + act, 2 * x_b + 2 * g_b + 2 * w_b + 4 * cout)}


def phase_bwd_times(torch) -> list:
    """Per DCGAN layer at batch 8, by CUDA events: each backward kernel,
    its plain version, one library call of the same function (never called
    by the port) and the bound; the folded dx and dw (act' applied as they
    stage g) beside them, and each whole route, three kernels or two, as
    one graph, timed in turns (three, folded, folded, three)."""
    from repro_torch.kernels import transpose_conv2d_bwd as bw
    from repro_torch.kernels.transpose_conv2d import transpose_conv2d_fused
    from repro_torch.models import gan
    from repro_torch.timing import time_cuda

    conv_bwd = torch.ops.aten.convolution_backward
    rows = []
    for i, shape in enumerate(DCGAN_SHAPES):
        b, n_in, n_k, pad, cin, cout = shape
        x, k, bias, g = _bwd_inputs(torch, shape, seed=300 + i)
        epi = gan.generator_epilogues(gan.DCGAN)[i]
        y = transpose_conv2d_fused(x, k, pad, epilogue=epi, bias=bias)
        gm = bw.epilogue_grad(g, y, epi)
        # the F.conv_transpose2d form: NCHW, flipped (Cin, Cout, n, n) kernel
        g_nchw = gm.permute(0, 3, 1, 2).contiguous()
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_t = torch.flip(k, (0, 1)).permute(2, 3, 0, 1).contiguous()
        pt = n_k - 1 - pad
        conv_args = (g_nchw, x_nchw, w_t, [cout], [2, 2], [pt, pt], [1, 1], True,
                     [0, 0], 1)
        if epi.act == "tanh":
            def eager(gg, yy):
                return gg * (1 - yy * yy)
        else:
            def eager(gg, yy):
                return torch.where(yy > 0, gg, 0.0)
        row = {"layer": f"L{i}", "shape": shape, "act": epi.act,
               "bounds": _bwd_bounds(shape),
               "epilogue_grad_ms": time_cuda(bw.epilogue_grad, g, y, epi),
               "epilogue_grad_plain_ms": time_cuda(bw.epilogue_grad_plain, g, y, epi,
                                                   iters=5),
               "epilogue_grad_library_ms": time_cuda(eager, g, y),
               "dx_ms": time_cuda(bw.transpose_conv2d_dx, gm, k, n_in, pad),
               "dx_plain_ms": time_cuda(bw.transpose_conv2d_dx_plain, gm, k, n_in,
                                        pad, iters=5),
               "dx_library_ms": time_cuda(conv_bwd, *conv_args, [True, False, False]),
               "dw_ms": time_cuda(bw.transpose_conv2d_dw, x, gm, n_k, pad,
                                  with_db=True),
               "dw_plain_ms": time_cuda(bw.transpose_conv2d_dw_plain, x, gm, n_k, pad,
                                        with_db=True, iters=5),
               "dw_library_ms": time_cuda(conv_bwd, *conv_args, [False, True, True]),
               "geometry": {"dx_variant": bw.bwd_geometry(*shape).dx_variant,
                            "dx_splits": bw.bwd_geometry(*shape).dx_splits,
                            "dw_splits": bw.bwd_geometry(*shape).dw_splits}}
        # the events above also hold each call's host cost where that
        # exceeds the kernel's; a graph replay gives the device's own time
        row["device_us"] = {
            "epilogue_grad": _device_us(torch, bw.epilogue_grad, g, y, epi),
            "dx": _device_us(torch, bw.transpose_conv2d_dx, gm, k, n_in, pad),
            "dw": _device_us(torch, bw.transpose_conv2d_dw, x, gm, n_k, pad,
                             with_db=True),
            "epilogue_grad_library": _device_us(torch, eager, g, y),
            "dx_library": _device_us(torch, conv_bwd, *conv_args, [True, False, False]),
            "dw_library": _device_us(torch, conv_bwd, *conv_args, [False, True, True]),
        }
        # act' folded into dx and dw, as the training path runs them
        folded = dict(y=y, epilogue=epi)
        row["dx_folded_ms"] = time_cuda(bw.transpose_conv2d_dx, g, k, n_in, pad, **folded)
        row["dw_folded_ms"] = time_cuda(bw.transpose_conv2d_dw, x, g, n_k, pad,
                                        with_db=True, **folded)
        row["device_us"]["dx_folded"] = _device_us(torch, bw.transpose_conv2d_dx, g, k,
                                                   n_in, pad, **folded)
        row["device_us"]["dw_folded"] = _device_us(torch, bw.transpose_conv2d_dw, x, g,
                                                   n_k, pad, with_db=True, **folded)

        def three(x, k, g, y):   # the standalone epilogue-grad, then dx and dw
            gm = bw.epilogue_grad(g, y, epi)
            return (bw.transpose_conv2d_dx(gm, k, n_in, pad),
                    bw.transpose_conv2d_dw(x, gm, n_k, pad, with_db=True))

        def two(x, k, g, y):     # the composer: the folded dx and dw
            return bw.transpose_conv2d_bwd(x, k, g, pad, epilogue=epi, y=y)

        abba = [_device_us(torch, fn, x, k, g, y) for fn in (three, two, two, three)]
        row["route_us_abba"] = abba
        row["device_us"]["route_three"] = (abba[0] + abba[3]) / 2
        row["device_us"]["route_folded"] = (abba[1] + abba[2]) / 2
        row["route_three_ms"] = time_cuda(three, x, k, g, y)
        row["route_folded_ms"] = time_cuda(two, x, k, g, y)
        row["gm_bytes_not_allocated"] = gm.numel() * gm.element_size()
        rows.append(row)
        log(f"[bwd-times] L{i} {shape}: " + " | ".join(
            f"{n} {row[n + '_ms'] * 1e3:.2f} us (plain {row[n + '_plain_ms'] * 1e3:.2f},"
            f" library {row[n + '_library_ms'] * 1e3:.2f}, bound "
            f"{row['bounds'][n]['bound_ms'] * 1e3:.2f} {row['bounds'][n]['bound_by']})"
            for n in ("epilogue_grad", "dx", "dw")) + f" splits {row['geometry']}")
        log(f"[bwd-times] L{i} device-only us (graph replay): {row['device_us']}")
        du = row["device_us"]
        log(f"[bwd-fold] L{i} {epi.act}: graph us three-kernel route "
            f"{du['epilogue_grad']:.2f} + {du['dx']:.2f} + {du['dw']:.2f} = "
            f"{du['epilogue_grad'] + du['dx'] + du['dw']:.2f}, folded "
            f"{du['dx_folded']:.2f} + {du['dw_folded']:.2f} = "
            f"{du['dx_folded'] + du['dw_folded']:.2f} (bounds dx "
            f"{row['bounds']['dx_folded']['bound_ms'] * 1e3:.2f}, dw "
            f"{row['bounds']['dw_folded']['bound_ms'] * 1e3:.2f}); whole route as one "
            f"graph, three {du['route_three']:.2f} against folded "
            f"{du['route_folded']:.2f} (in turns {[round(a, 2) for a in abba]}; bound "
            f"{row['bounds']['bwd']['bound_ms'] * 1e3:.2f}); events ms three "
            f"{row['route_three_ms']:.5f} folded {row['route_folded_ms']:.5f}; gm not "
            f"allocated {row['gm_bytes_not_allocated']} B")
    return rows


def _device_us(torch, fn, *args, calls: int = 20, **kwargs) -> float:
    """Device microseconds per call of ``fn`` (every kernel it launches, a
    reduce pass included) with the host taken out: one CUDA graph of
    ``calls`` calls, timed by CUDA events around its replay, after a
    warm-up on a side stream and one untimed replay. (torch.profiler's
    per-kernel sums can come up short: one H100 run's trace held 3 of 5
    calls of the decode kernel.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(*args, **kwargs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn(*args, **kwargs)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


class _NanAt:
    """Data whose batch is all NaN at the given step indices."""

    def __init__(self, data, steps):
        self.data, self.steps = data, set(steps)

    def batch(self, i):
        x = self.data.batch(i)
        return x.new_full(x.shape, float("nan")) if i in self.steps else x


def _counters():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import transpose_conv2d_bwd as bw

    wrappers = {name: fns[0] for name, fns in kernels().items()}
    return wrappers, {"fused_reduce": wrappers["fused"],
                      "gemm_reduce": wrappers["gemm"],
                      "phase_reduce": wrappers["phase"],
                      "dx_reduce": bw.transpose_conv2d_dx,
                      "dw_reduce": bw.transpose_conv2d_dw,
                      "decode_reduce": da.decode_attention}


def _reset_counts() -> None:
    wrappers, reducers = _counters()
    for fn in wrappers.values():
        fn.launches = 0
    for fn in reducers.values():
        fn.reduce_launches = 0
    wrappers["epilogue_grad"].folded_launches = 0


def _read_counts() -> dict:
    """Every counter: each wrapper's launches, each second pass's, and
    ``epilogue_grad_folded``, the dx and dw launches that apply act' as
    they stage g."""
    wrappers, reducers = _counters()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    counts.update({name: fn.reduce_launches for name, fn in reducers.items()})
    counts["epilogue_grad_folded"] = wrappers["epilogue_grad"].folded_launches
    return counts


@contextlib.contextmanager
def _counts_held():
    """The launch counts as they stand before the block, put back after it:
    launches made to compare the path with are not the path's."""
    wrappers, reducers = _counters()
    held = ([(fn, fn.launches) for fn in wrappers.values()],
            [(fn, fn.reduce_launches) for fn in reducers.values()],
            wrappers["epilogue_grad"].folded_launches)
    try:
        yield
    finally:
        for fn, n in held[0]:
            fn.launches = n
        for fn, n in held[1]:
            fn.reduce_launches = n
        wrappers["epilogue_grad"].folded_launches = held[2]


def _bitwise(a, b) -> bool:
    """Every leaf of two trees equal in dtype, shape and bits (a NaN equals
    itself)."""
    import torch

    from repro_torch.tree import tree_leaves

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(ints[x.element_size()]), y.view(ints[y.element_size()]))
        for x, y in zip(la, lb))


class _ResetCountsAt:
    """Trainer hooks that set the launch counts to 0 as step ``at`` starts."""

    def __init__(self, at):
        self.at = at

    def on_step_start(self, step):
        if step == self.at:
            _reset_counts()


def _eager_steps(tr, state, steps: int) -> list:
    """``steps`` steps through the trainer's eager step (no graph), each as
    ``run`` takes it: inputs drawn, the step, its scalars read back, the NaN
    guard. Host milliseconds a step."""
    import numpy as np

    walls = []
    for i in range(steps):
        t0 = time.perf_counter()
        reals, zs = tr._batches(i)
        new, stats = tr._step_eager(state, reals, zs)
        if all(np.isfinite(stats.tolist())):
            state = new
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def phase_train(torch) -> dict:
    """GanTrainer on full-width DCGAN, with deterministic algorithms on:
    the path's checks, then timings. Each step replays the trainer's CUDA
    graph."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.data import SyntheticImages
    from repro_torch.models import gan
    from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig
    from repro_torch.tree import tree_map

    torch.use_deterministic_algorithms(True)
    # deterministic mode would also fill every torch.empty with NaN: a
    # debugging aid that adds a fill kernel to each wrapper's output
    torch.utils.deterministic.fill_uninitialized_memory = False
    _log_determinism(torch, "train")
    cfg = gan.DCGAN
    tcfg = GanTrainerConfig(ckpt_every=3)
    data = SyntheticImages(cfg.out_hw(cfg.layers[-1][0]), cfg.layers[-1][2],
                           tcfg.global_batch)
    quiet = lambda *a: None  # noqa: E731

    def trainer(ckpt_dir=None, d=data, bwd=None, hooks=None):
        tr = GanTrainer(cfg, tcfg, d, ckpt_dir=ckpt_dir, log_fn=quiet, hooks=hooks)
        if bwd is not None:
            tr.train_plan = gan.generator_plan(cfg, tr.micro, bwd=bwd)
        return tr, tr.init_state(torch.Generator().manual_seed(0))

    out = {"plan": gan.generator_plan(cfg, tcfg.global_batch).describe()}
    log("[train] " + out["plan"].replace("\n", "\n[train] "))
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        tr, state = trainer(d1)
        # three graphed steps against three eager ones from the same state;
        # the graph is captured at the first, before the counted run below
        eager_state, graph_state = state, state
        for step in range(3):
            reals, zs = tr._batches(step)
            (eager_state, stats), eager_step = _count_delta(tr._step_eager, eager_state,
                                                            reals, zs)
            graph_state, metrics = tr._step_fn(graph_state, reals, zs)
            if ([metrics[k] for k in ("g_loss", "d_loss", "g_gnorm", "d_gnorm")]
                    != stats.tolist() or not _bitwise(graph_state, eager_state)):
                raise AssertionError(f"train: graphed step {step} is not bitwise the "
                                     f"eager step")
        log(f"[train] 3 graphed steps bitwise equal to 3 eager steps (scalars, params, "
            f"moments); an eager step's launches {eager_step}")
        graph = tr._graph
        torch.cuda.synchronize()
        _reset_counts()
        full, hist = tr.run(state, steps=6)   # the fresh state, copied in
        torch.cuda.synchronize()
        launches = _read_counts()
        if not all(np.isfinite([h["g_loss"], h["d_loss"]]).all() and not h["skipped"]
                   for h in hist):
            raise AssertionError(f"non-finite or skipped step: {hist}")
        want = {k: 6 * v for k, v in eager_step.items()}
        if launches != want or min(launches[n] for n in TRAINING) < 1:
            raise AssertionError(f"6 graphed training steps counted {launches}, 6 eager "
                                 f"steps {want}")
        # every generator layer has an activation: its backward is dx and dw
        # with act' folded in, and no standalone epilogue-grad pass
        if (launches["epilogue_grad"] != 0 or launches["epilogue_grad_folded"]
                != launches["dx"] + launches["dw"]):
            raise AssertionError(f"train: epilogue-grad not folded into every dx and "
                                 f"dw launch: {launches}")
        if tr._graph is not graph:
            raise AssertionError("train: the step's graph was captured again")
        log(f"[train] 6 steps, losses {[(h['g_loss'], h['d_loss']) for h in hist]}")
        log(f"[train] launches in those 6 steps {launches}, exactly 6 eager steps'; "
            f"one capture")
        shutil.copy(os.path.join(d1, "step_00000003.npz"), d2)
        tr2, state = trainer(d2)
        resumed, hist2 = tr2.run(state, steps=6)
        if tr2.resumed_step != 3 or hist2 != hist[3:] or not _bitwise(resumed, full):
            raise AssertionError(
                f"resume from step 3 is not bitwise the uninterrupted run: "
                f"{hist2} vs {hist[3:]}")
        log("[train] resume from step 3: losses, params and moments bitwise equal "
            "to the uninterrupted run")
    tr3, state = trainer(d=_NanAt(data, (0,)))
    before = tree_map(torch.clone, state)
    after, hist3 = tr3.run(state, steps=1)
    if hist3[0]["skipped"] != 1 or tr3.skipped_steps != 1 or not _bitwise(before, after):
        raise AssertionError("a NaN step changed the state or was not skipped")
    log("[train] NaN step skipped, state bitwise untouched, skipped_steps 1")
    out.update({"launches_6_steps": launches, "eager_step_launches": eager_step,
                "losses": hist, "graph_bitwise_eager": True, "resume_bitwise": True,
                "nan_step_skipped": True})

    tr, _ = trainer()
    tr._batches(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_TIMED_STEPS):
        tr._batches(i)
    torch.cuda.synchronize()
    out["inputs_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED_STEPS
    log(f"[train] drawing a step's reals and latents on the card: "
        f"{out['inputs_ms_per_step']:.4f} ms a step (host clock, {TRAIN_TIMED_STEPS} "
        f"steps, one sync)")

    steps = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    windows = {"segregated": [], "autograd": [], "segregated_eager": []}
    for w in range(TRAIN_WINDOWS):   # alternate, so drift hits all alike
        for kind in windows:
            bwd = kind.split("_")[0]
            tr, state = trainer(bwd=bwd, hooks=_ResetCountsAt(TRAIN_WARMUP_STEPS))
            if kind.endswith("eager"):   # the step as it ran before it was a graph
                _reset_counts()
                walls = np.asarray(_eager_steps(tr, state, steps)[TRAIN_WARMUP_STEPS:])
            else:
                state, _ = tr.run(state, steps=steps)
                walls = np.asarray(tr.timer.steps[TRAIN_WARMUP_STEPS:]) * 1e3
            counts = _read_counts()
            per = steps if kind.endswith("eager") else TRAIN_TIMED_STEPS
            windows[kind].append({
                "step_ms_median": float(np.median(walls)),
                "step_ms_p90": float(np.percentile(walls, 90)),
                "step_ms": walls.tolist(),
                "launches_per_step": {n: c / per for n, c in counts.items()}})
            log(f"[train] window {w} {kind}: {TRAIN_TIMED_STEPS} steps after "
                f"{TRAIN_WARMUP_STEPS} warm-up, step ms median "
                f"{windows[kind][-1]['step_ms_median']:.3f} p90 "
                f"{windows[kind][-1]['step_ms_p90']:.3f} (host clock; each step "
                f"ends in a sync), launches per step "
                f"{windows[kind][-1]['launches_per_step']}")
            if kind == "segregated" and w == 0:   # one profiled step each way
                reals, zs = tr._batches(steps)
                out["profile"] = _profile_step(torch, tr._step_fn, state, reals, zs,
                                               top=15)
                _log_profile("train graph", out["profile"])
                out["eager_profile"] = _profile_step(
                    torch, lambda: tr._step_eager(state, reals, zs)[1].tolist(), top=15)
                _log_profile("train eager", out["eager_profile"])
    out["windows"] = windows
    for kind, prof in (("segregated", out["profile"]),
                       ("segregated_eager", out["eager_profile"])):
        wall_us = 1e3 * float(np.median([w["step_ms_median"] for w in windows[kind]]))
        out[f"{kind}_step_idle_share"] = 1 - prof["device_us"] / wall_us
        log(f"[train] {kind}: a step's device time {prof['device_us']:.1f} us in a "
            f"median step of {wall_us:.1f} us: idle share "
            f"{out[f'{kind}_step_idle_share']:.3f} (host clock)")
    return out


def _pair_inputs(torch, shape, seed):
    """x, k1, k2 (fan-in scaled) and the two biases of a pair shape."""
    b, n_in, n_k, _, c0, c1, c2 = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n_in, n_in, c0), device="cuda", generator=g)
    k1 = torch.randn((n_k, n_k, c0, c1), device="cuda", generator=g)
    k1 *= (n_k * n_k * c0) ** -0.5
    k2 = torch.randn((n_k, n_k, c1, c2), device="cuda", generator=g)
    k2 *= (n_k * n_k * c1) ** -0.5
    b1 = 0.1 * torch.randn((c1,), device="cuda", generator=g)
    b2 = 0.1 * torch.randn((c2,), device="cuda", generator=g)
    return x, k1, k2, b1, b2


def _tag(epi) -> str:
    return epi.tag() if epi is not None else "none"


def phase_pair_check(torch) -> tuple:
    """The per-phase kernel (at every compiled instance, and bitwise batch
    invariant at the DCGAN shapes) and the pair kernel against their plain
    versions; the over-budget pair refused. Returns the worst errors and,
    per checked pair shape, its cluster size and how many such clusters
    the card runs at once."""
    from repro_torch.kernels import transpose_conv2d as tcf
    from repro_torch.kernels.epilogue import Epilogue
    from repro_torch.kernels.transpose_conv2d_pair import (
        max_active_clusters,
        pair_launch_geometry,
        pair_smem_bytes,
        pair_variants,
    )

    worst = {"phase": 0.0, "pair": 0.0}
    clusters = {}
    launch, plain = kernels(("phase",))["phase"]
    phase_shapes = DCGAN_SHAPES + ODD_SHAPES + PHASE_VARIANT_SHAPES
    geos = [tcf.phase_geometry(*s) for s in phase_shapes]
    if ({g.variant for g in geos} != tcf.phase_variants() or any(
            not {(g.vx, g.vw) for g in geos if g.variant == v} >= {(True, True), (False, False)}
            for v in tcf.phase_variants())):
        raise AssertionError("the check shapes miss an instance or a copy width of the "
                             "per-phase kernel")
    for i, shape in enumerate(phase_shapes):
        x, k, bias = _inputs(torch, shape, seed=400 + i)
        pad = shape[3]
        for epi in epilogues():
            b = bias if epi is not None else None
            _worst("phase", shape, _tag(epi),
                   [(launch(x, k, pad, epilogue=epi, bias=b),
                     plain(x, k, pad, epilogue=epi, bias=b))], worst)
        torch.cuda.synchronize()
        g = geos[i]
        log(f"[pair-check] phase {shape} {g.variant} splits {g.splits} vx {int(g.vx)} "
            f"vw {int(g.vw)}: every epilogue within tolerance; worst so far "
            f"{worst['phase']:.3e}")
        if shape in DCGAN_SHAPES:   # each sample's bits are its own batch-1 call's
            epi = Epilogue(True, "tanh" if shape == DCGAN_SHAPES[-1] else "relu")
            batched = launch(x, k, pad, epilogue=epi, bias=bias)
            for j in range(shape[0]):
                if not torch.equal(launch(x[j:j + 1], k, pad, epilogue=epi, bias=bias)[0],
                                   batched[j]):
                    raise AssertionError(f"per-phase kernel at {shape}: sample {j} of the "
                                         "batch differs from its own batch-1 call")
            log(f"[pair-check] phase {shape}: every sample bitwise equal to its "
                f"batch-1 call")
    launch, plain = kernels(("pair",))["pair"]
    if ({pair_launch_geometry(*s[1:3], s[3], *s[4:]).variant for s in PAIR_CHECKS}
            != pair_variants()):
        raise AssertionError("the pair check shapes miss an instance of the pair kernel")
    relu, tanh = Epilogue(True, "relu"), Epilogue(True, "tanh")
    epi_pairs = [(relu, relu), (relu, tanh), (None, None),
                 (Epilogue(True, "leaky_relu", 0.2), Epilogue(True))]
    for i, shape in enumerate(PAIR_CHECKS):
        x, k1, k2, b1, b2 = _pair_inputs(torch, shape, seed=500 + i)
        pad = shape[3]
        for e1, e2 in epi_pairs:
            kw = dict(epilogue1=e1, bias1=b1 if e1 else None, epilogue2=e2,
                      bias2=b2 if e2 else None)
            _worst("pair", shape, f"{_tag(e1)}/{_tag(e2)}",
                   [(launch(x, k1, k2, pad, **kw), plain(x, k1, k2, pad, **kw))],
                   worst)
        torch.cuda.synchronize()
        g = pair_launch_geometry(*shape[1:3], pad, *shape[4:])
        active = max_active_clusters(*shape[1:3], pad, *shape[4:])
        clusters[str(shape)] = {"cl": g.cl, "r": g.r, "d": g.d,
                                "smem_bytes": g.smem_bytes, "max_active": active}
        log(f"[pair-check] pair {shape}, {pair_smem_bytes(*shape[1:3], *shape[4:], pad)}"
            f" B of shared memory a block, clusters of {g.cl} (instance R{g.r} "
            f"D{g.d}), {active} at once: every epilogue pair within tolerance;"
            f" worst so far {worst['pair']:.3e}")
    x, k1, k2, b1, b2 = _pair_inputs(torch, PAIR_OVER_BUDGET, seed=599)
    try:
        launch(x, k1, k2, PAIR_OVER_BUDGET[3], epilogue1=relu, bias1=b1,
               epilogue2=relu, bias2=b2)
    except ValueError as e:
        log(f"[pair-check] {PAIR_OVER_BUDGET} refused: {e}")
    else:
        raise AssertionError(f"the pair {PAIR_OVER_BUDGET} over the shared-memory "
                             "budget launched")
    return worst, clusters


def _pair_bound(shape) -> dict:
    from repro_torch.core.segregation import flop_count, output_size

    b, n_in, n_k, pad, c0, c1, c2 = shape
    m1 = output_size(n_in, n_k, pad)
    m2 = output_size(m1, n_k, pad)
    flops = 2 * b * (flop_count(n_in, n_k, c0, c1, pad)
                     + flop_count(m1, n_k, c1, c2, pad))
    nbytes = 4 * (b * n_in * n_in * c0 + n_k * n_k * (c0 * c1 + c1 * c2)
                  + c1 + c2 + b * m2 * m2 * c2)
    return _limits(flops, nbytes)


def _flipped(torch, k):
    """An HWIO kernel as F.conv_transpose2d's (Cin, Cout, n, n) kernel."""
    return torch.flip(k, (0, 1)).permute(2, 3, 0, 1).contiguous()


def phase_pair_times(torch) -> dict:
    """Per DCGAN pair and per DCGAN layer at batch 8, by CUDA events: the
    pair kernel, the per-phase kernel beside the fused kernel, their plain
    versions, library yardsticks and bounds; then the whole generator per
    bucket through fused pairs and per layer, and a profiled fused call."""
    import torch.nn.functional as F

    from repro_torch.kernels import plan as planlib
    from repro_torch.kernels import transpose_conv2d as tcf
    from repro_torch.kernels.epilogue import Epilogue
    from repro_torch.kernels.transpose_conv2d_pair import pair_smem_bytes
    from repro_torch.models import gan
    from repro_torch.timing import time_cuda

    relu, tanh = Epilogue(True, "relu"), Epilogue(True, "tanh")
    pair, pair_plain = kernels(("pair",))["pair"]
    pairs = []
    for i, shape in enumerate(DCGAN_PAIRS):
        b, n_in, n_k, pad, c0, c1, c2 = shape
        x, k1, k2, b1, b2 = _pair_inputs(torch, shape, seed=600 + i)
        e2 = tanh if i == len(DCGAN_PAIRS) - 1 else relu
        kw = dict(epilogue1=relu, bias1=b1, epilogue2=e2, bias2=b2)
        lp1 = planlib.plan_layer(b, n_in, n_k, c0, c1, pad, epilogue=relu)
        lp2 = planlib.plan_layer(b, 2 * n_in - n_k + 2 * pad, n_k, c1, c2, pad,
                                 epilogue=e2)
        act = torch.tanh if e2.act == "tanh" else torch.relu

        def back_to_back(xx, kk1, kk2, bb1, bb2, _lp1=lp1, _lp2=lp2):
            y1 = planlib.execute_layer(_lp1, xx, kk1, bias=bb1)
            return planlib.execute_layer(_lp2, y1, kk2, bias=bb2)

        def library(xx, w1, w2, bb1, bb2, _pad=n_k - 1 - pad, _act=act):
            h = torch.relu(F.conv_transpose2d(xx, w1, bb1, stride=2, padding=_pad))
            return _act(F.conv_transpose2d(h, w2, bb2, stride=2, padding=_pad))

        lib_args = (x.permute(0, 3, 1, 2).contiguous(), _flipped(torch, k1),
                    _flipped(torch, k2), b1, b2)
        # in turns, so drift hits both alike: pair, back to back, again, pair
        turns = {"pair": [], "back_to_back": []}
        for name in ("pair", "back_to_back", "back_to_back", "pair"):
            turns[name].append(time_cuda(pair, x, k1, k2, pad, **kw) if name == "pair"
                               else time_cuda(back_to_back, x, k1, k2, b1, b2))
        row = {"pair": f"L{2 * i}-L{2 * i + 1}", "shape": shape, **_pair_bound(shape),
               "back_to_back_methods": [lp1.method, lp2.method],
               "smem_bytes": pair_smem_bytes(n_in, n_k, c0, c1, c2, pad),
               **{f"{n}_ms": sum(t) / 2 for n, t in turns.items()},
               **{f"{n}_turns_ms": t for n, t in turns.items()},
               "pair_plain_ms": time_cuda(pair_plain, x, k1, k2, pad, **kw, iters=5),
               "library_ms": time_cuda(library, *lib_args)}
        # one batch item: one cluster, the batch-8 launch's per-cluster work
        row["pair_b1_ms"] = time_cuda(pair, x[:1], k1, k2, pad, **kw)
        row["back_to_back_b1_ms"] = time_cuda(back_to_back, x[:1], k1, k2, b1, b2)
        x1 = x[:1].contiguous()
        row["library_b1_ms"] = time_cuda(library, lib_args[0][:1].contiguous(), *lib_args[1:])
        row["device_us"] = {
            "pair": _device_us(torch, pair, x, k1, k2, pad, **kw),
            "back_to_back": _device_us(torch, back_to_back, x, k1, k2, b1, b2),
            "library": _device_us(torch, library, *lib_args),
            "pair_b1": _device_us(torch, pair, x1, k1, k2, pad, **kw),
            "back_to_back_b1": _device_us(torch, back_to_back, x1, k1, k2, b1, b2),
            "library_b1": _device_us(torch, library, lib_args[0][:1].contiguous(),
                                     *lib_args[1:])}
        pairs.append(row)
        log(f"[pair-times] {row['pair']} {shape}: pair {row['pair_ms'] * 1e3:.2f} us "
            f"{[round(t * 1e3, 2) for t in turns['pair']]}, back-to-back "
            f"{'+'.join(row['back_to_back_methods'])} "
            f"{row['back_to_back_ms'] * 1e3:.2f} us "
            f"{[round(t * 1e3, 2) for t in turns['back_to_back']]}, plain {row['pair_plain_ms'] * 1e3:.2f}"
            f" us, library {row['library_ms'] * 1e3:.2f} us, bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}); at batch 1 pair "
            f"{row['pair_b1_ms'] * 1e3:.2f} us, back-to-back "
            f"{row['back_to_back_b1_ms'] * 1e3:.2f} us, library "
            f"{row['library_b1_ms'] * 1e3:.2f} us; device-only us "
            f"{row['device_us']}; {row['smem_bytes']} B shared memory a block")

    phase, phase_plain = kernels(("phase",))["phase"]
    fused = kernels(("fused",))["fused"][0]
    layers = []
    for i, shape in enumerate(DCGAN_SHAPES):
        b, n_in, n_k, pad, cin, cout = shape
        x, k, bias = _inputs(torch, shape, seed=700 + i)
        epi = tanh if i == len(DCGAN_SHAPES) - 1 else relu
        act = torch.tanh if epi.act == "tanh" else torch.relu

        def library(xx, ww, bb, _pad=n_k - 1 - pad, _act=act):
            return _act(F.conv_transpose2d(xx, ww, bb, stride=2, padding=_pad))

        # in turns, so drift hits both alike: phase, fused, fused, phase,
        # by events and by graph replay
        turns = {"phase": [], "fused": []}
        graph = {"phase": [], "fused": []}
        for name in ("phase", "fused", "fused", "phase"):
            fn = phase if name == "phase" else fused
            turns[name].append(time_cuda(fn, x, k, pad, epilogue=epi, bias=bias))
            graph[name].append(_device_us(torch, fn, x, k, pad, epilogue=epi, bias=bias))
        g = tcf.phase_geometry(*shape)
        row = {"layer": f"L{i}", "shape": shape, **_bound(shape),
               "phase_variant": list(g.variant), "phase_splits": g.splits,
               "phase_turns_ms": turns["phase"], "fused_turns_ms": turns["fused"],
               "phase_graph_turns_us": graph["phase"], "fused_graph_turns_us": graph["fused"],
               "phase_ms": sum(turns["phase"]) / 2, "fused_ms": sum(turns["fused"]) / 2,
               "phase_plain_ms": time_cuda(phase_plain, x, k, pad, epilogue=epi,
                                           bias=bias, iters=5),
               "library_ms": time_cuda(library, x.permute(0, 3, 1, 2).contiguous(),
                                       _flipped(torch, k), bias),
               "device_us": {
                   "phase": sum(graph["phase"]) / 2, "fused": sum(graph["fused"]) / 2,
                   "library": _device_us(torch, library,
                                         x.permute(0, 3, 1, 2).contiguous(),
                                         _flipped(torch, k), bias)}}
        row["fused_over_phase"] = row["fused_ms"] / row["phase_ms"]
        row["fused_over_phase_graph"] = row["device_us"]["fused"] / row["device_us"]["phase"]
        layers.append(row)
        log(f"[pair-times] L{i} {shape}: phase {g.variant} splits {g.splits} "
            f"{row['phase_ms'] * 1e3:.2f} us "
            f"{[round(t * 1e3, 2) for t in turns['phase']]}, fused "
            f"{row['fused_ms'] * 1e3:.2f} us {[round(t * 1e3, 2) for t in turns['fused']]}"
            f" (fused / phase {row['fused_over_phase']:.3f}; graph "
            f"{[round(t, 2) for t in graph['phase']]} against "
            f"{[round(t, 2) for t in graph['fused']]}, fused / phase "
            f"{row['fused_over_phase_graph']:.3f}), plain "
            f"{row['phase_plain_ms'] * 1e3:.2f} us, library {row['library_ms'] * 1e3:.2f}"
            f" us, bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}); device-only"
            f" us {row['device_us']}")

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    engines = {"per_layer": _warm_engine(cfg, params),
               "pairs": _warm_engine(cfg, params, fuse="force")}
    generator = []
    for bucket in (1, 2, 4, 8):
        z = torch.randn((bucket, cfg.z_dim), device="cuda")
        plans = {"per_layer": gan.generator_plan(cfg, bucket),
                 "pairs": gan.generator_plan(cfg, bucket, fuse="force")}
        turns = {"per_layer": [], "pairs": []}
        graph_turns = {"per_layer": [], "pairs": []}
        for name in ("per_layer", "pairs", "pairs", "per_layer"):
            turns[name].append(time_cuda(gan.generator_apply, params, cfg, z,
                                         plan=plans[name]))
            graph_turns[name].append(time_cuda(
                engines[name]._executable(cfg.name, bucket), params, z))
        row = {"bucket": bucket, **{f"{n}_ms": sum(t) / 2 for n, t in turns.items()},
               **{f"{n}_turns_ms": t for n, t in turns.items()},
               **{f"graph_{n}_ms": sum(t) / 2 for n, t in graph_turns.items()},
               **{f"graph_{n}_turns_ms": t for n, t in graph_turns.items()}}
        generator.append(row)
        log(f"[pair-times] generator b{bucket}: fused pairs {row['pairs_ms']:.4f} ms "
            f"{turns['pairs']}, per layer {row['per_layer_ms']:.4f} ms "
            f"{turns['per_layer']}; as CUDA graphs: fused pairs "
            f"{row['graph_pairs_ms']:.4f} ms {graph_turns['pairs']}, per layer "
            f"{row['graph_per_layer_ms']:.4f} ms {graph_turns['per_layer']}")
    del engines

    z = torch.randn((BATCH, cfg.z_dim), device="cuda")
    plan = gan.generator_plan(cfg, BATCH, fuse="force")
    profiled = _profile_step(torch, gan.generator_apply, params, cfg, z, plan=plan,
                             calls=10, top=6)
    _log_profile(f"pair-times fused generator b{BATCH}", profiled)
    return {"pairs": pairs, "layers": layers, "generator": generator,
            "profile": profiled}


def _dcgan_requests(cfg):
    """The 32 requests of phases 5 and 12 and their arrival offsets, drawn
    anew from the same seed."""
    import numpy as np

    from repro_torch.serve import GenRequest

    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 5, size=32)
    reqs = [GenRequest("dcgan", rng.standard_normal((int(n), cfg.z_dim))
                       .astype(np.float32)) for n in sizes]
    return reqs, np.cumsum(rng.exponential(1e-3, size=len(reqs))).tolist()


def phase_fused_engine(torch) -> dict:
    """GanEngine(fuse="force") on full-width DCGAN: each bucket's graph
    against its eager call, the 32-request replay through the pair kernel
    and its checks, then a registry warm start."""
    import tempfile

    from repro_torch.kernels.plan import FusedPairPlan
    from repro_torch.models import gan

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    t0 = time.perf_counter()
    eng = _warm_engine(cfg, params, fuse="force")
    warm_s = time.perf_counter() - t0
    plans = eng.registry["dcgan"].plans
    if not all(isinstance(e, FusedPairPlan) for p in plans.values() for e in p.entries):
        raise AssertionError("a fused engine plan is not all pairs")
    per_bucket = _graphs_against_eager(torch, eng, cfg, params, "fused-engine")
    reqs, arrivals = _dcgan_requests(cfg)
    launches = _replay_counted(eng, reqs, arrivals, per_bucket, "fused-engine")
    summary = eng.metrics.summary()
    cons = eng.conservation()
    if not all(r.done for r in reqs) or not cons["ok"]:
        raise AssertionError(f"fused engine: not every request served: {cons}")
    if eng.metrics.recompiles != eng.warmup_recompiles:
        raise AssertionError("executables were built after warm-up")
    if not all(bool(torch.isfinite(r.output).all()) for r in reqs):
        raise AssertionError("non-finite output")
    if launches["pair"] < 1:
        raise AssertionError(f"the pair kernel never launched: {launches}")
    worst = 0.0
    for r in reqs:
        one = gan.generator_apply(params, cfg, r.z, plan=gan.generator_plan(
            cfg, r.n, fuse="force")).cpu()
        if not torch.equal(one, r.output):
            raise AssertionError(
                f"request {r.rid} (n={r.n}) differs from its unbatched fused call "
                f"by {(one - r.output).abs().max().item()}")
        flat = gan.generator_apply(params, cfg, r.z).cpu()
        err = (flat - r.output).abs().max().item()
        tol = TOL_REL * flat.abs().max().item() + TOL_ABS
        if err > tol:
            raise AssertionError(f"request {r.rid}: fused vs per-layer {err} > {tol}")
        worst = max(worst, err)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "plans.json")
        eng.save_plans(path)
        warm = _warm_engine(cfg, params, fuse="force", registry_path=path)
    if warm.registry["dcgan"].plans != plans:
        raise AssertionError("the registry warm start gave other plans")
    again, _ = _dcgan_requests(cfg)
    warm.replay(again, arrivals)
    if not all(torch.equal(a.output, r.output) for a, r in zip(again, reqs)):
        raise AssertionError("the registry warm start's outputs differ")
    lat = summary["latency_s"]
    log(f"[fused-engine] {summary['requests']} requests / {summary['samples']} samples "
        f"in {summary['batches']} batches, latency p50 {lat['p50'] * 1e3:.3f} ms, "
        f"warm-up {warm_s:.2f} s; launches {launches}, exactly the batches' eager "
        f"counts; bitwise batch-invariant; vs per-layer max abs err {worst:.3e}; "
        f"registry warm start: equal plans, bitwise equal outputs")
    log("[fused-engine] " + plans[BATCH].describe().replace("\n", "\n[fused-engine] "))
    return {"summary": {k: v for k, v in summary.items() if k != "per_model"},
            "launches": launches, "eager_launches_per_bucket": per_bucket,
            "warmup_s": warm_s, "vs_per_layer": worst, "registry_warm_start": True,
            "plan": plans[BATCH].describe()}


def phase_pair_autograd(torch) -> dict:
    """The generator's parameter gradients through a fused-pair plan and a
    ``phase`` plan against the per-layer plan; the launches of each run."""
    from repro_torch.models import gan

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    hw, c = cfg.out_hw(cfg.layers[-1][0]), cfg.layers[-1][2]
    z = torch.randn((BATCH, cfg.z_dim), device="cuda", generator=gen)
    r = torch.randn((BATCH, hw, hw, c), device="cuda", generator=gen)
    plans = {"per_layer": gan.generator_plan(cfg, BATCH),
             "pair": gan.generator_plan(cfg, BATCH, fuse="force"),
             "phase": gan.generator_plan(cfg, BATCH, method="phase")}
    grads, launches = {}, {}
    for name, plan in plans.items():
        live = _live(params)
        _reset_counts()
        (gan.generator_apply(live, cfg, z, plan=plan) * r).sum().backward()
        torch.cuda.synchronize()
        launches[name] = _read_counts()
        grads[name] = {f"{k}.{n}": t.grad for k, v in live.items()
                       for n, t in v.items()}
    for name in ("pair", "phase"):
        if launches[name][name] < 1:
            raise AssertionError(f"the {name} plan never launched its kernel: "
                                 f"{launches[name]}")
    out = {"launches": launches, "errors": {}}
    for name in ("pair", "phase"):
        for key, want in grads["per_layer"].items():
            err = (grads[name][key] - want).abs().max().item()
            tol = TOL_REL * want.abs().max().item() + TOL_ABS
            out["errors"][f"{name}:{key}"] = {"max_abs_err": err, "tol": tol}
            if not err <= tol:
                raise AssertionError(f"{name} plan gradient {key}: {err} > {tol}")
        log(f"[pair-autograd] {name} plan vs per-layer plan: every parameter "
            f"gradient within tolerance, worst "
            f"{max(v['max_abs_err'] for k, v in out['errors'].items() if k.startswith(name)):.3e};"
            f" launches {launches[name]}")
    return out


def _decode_inputs(torch, shape, dtype, seed):
    """q, k, v of a decode shape ``(B, S, KV, G, hd)`` in ``dtype``, and a
    kv_len (int32) holding 1, S and, from three rows on, a length just past
    a split boundary (inside a tile), from four rows on one just past 32
    splits (where a lane of the combine pass takes two splits), from five
    rows on one on a tile's edge inside a split, from six rows on one inside
    a tile of a split's second half; the other rows random."""
    import numpy as np

    from repro_torch.kernels.decode_attention import decode_geometry

    b, s_len, kvh, g, hd = shape
    geo = decode_geometry(s_len, hd, g, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(sh, device="cuda", generator=gen).to(dtype)
               for sh in ((b, kvh, g, hd), (b, s_len, kvh, hd), (b, s_len, kvh, hd)))
    lens = np.random.default_rng(seed).integers(1, s_len + 1, size=b)
    lens[0], lens[-1] = 1, s_len
    special = [geo.split_len + 3, 32 * geo.split_len + 5, geo.split_len + 2 * geo.tile,
               3 * geo.split_len + geo.split_len // 2 + 7]
    for i, n in enumerate(special[: b - 2]):
        lens[1 + i] = min(n, s_len)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device="cuda")


def phase_decode_check(torch) -> dict:
    """The decode kernel against its plain version at DECODE_CHECKS, fp32
    and bf16. Both compute in fp32 from the same inputs, so bf16 inputs keep
    the fp32 tolerance."""
    launch, plain = kernels(("decode_attention",))["decode_attention"]
    rows = []
    for i, shape in enumerate(DECODE_CHECKS):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, kv_len = _decode_inputs(torch, shape, dtype, seed=800 + i)
            got, want = launch(q, k, v, kv_len), plain(q, k, v, kv_len)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = TOL_REL * want.abs().max().item() + TOL_ABS
            log(f"[decode-check] {shape} {str(dtype)[6:]} kv_len {kv_len.tolist()}: "
                f"max abs err {err:.3e} (tol {tol:.3e})")
            if not (got.shape == want.shape and err <= tol):
                raise AssertionError(f"decode kernel disagrees with its plain version "
                                     f"at {shape} {dtype}: {err} > {tol}")
            rows.append({"shape": shape, "dtype": str(dtype)[6:], "max_abs_err": err,
                         "tol": tol})
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return {"rows": rows, "worst": max(r["max_abs_err"] for r in rows),
            "llama_4k": max(r["max_abs_err"] for r in rows
                            if r["shape"] == DECODE_TIMES[0])}


def _decode_bound(shape, kv_len, elem) -> dict:
    """Bytes: q, the K and V rows up to kv_len and the fp32 output, each
    once (and kv_len); operations: the two fp32 dot products a position."""
    b, _, kvh, g, hd = shape
    rows = int(sum(kv_len)) * kvh
    nbytes = elem * b * kvh * g * hd + 2 * elem * rows * hd + 4 * b * kvh * g * hd + 4 * b
    return _limits(4 * rows * g * hd, nbytes)


def phase_decode_times(torch) -> list:
    """The decode kernel at DECODE_TIMES (bf16, kv_len = S): the kernel,
    its plain version and the one-call library yardstick, each by CUDA
    events over back-to-back calls and by a CUDA graph's replay (the device
    time with the host taken out, :func:`_device_us`), and the bound. The
    kernels line takes the device-only times: at S 4096 SDPA's call is
    host-bound, so its events time the host. A yardstick that no SDPA
    backend takes fails the run."""
    import torch.nn.functional as F

    from repro_torch.timing import time_cuda

    launch, plain = kernels(("decode_attention",))["decode_attention"]

    def library(qq, kk, vv, mask):
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                              enable_gqa=True)

    rows = []
    for i, shape in enumerate(DECODE_TIMES):
        b, s_len, kvh, g, hd = shape
        q, k, v, _ = _decode_inputs(torch, shape, torch.bfloat16, seed=900 + i)
        kv_len = torch.full((b,), s_len, dtype=torch.int32, device="cuda")
        # SDPA's layout: (B, H, 1, hd) queries, (B, KV, S, hd) views of the cache
        lib_args = (q.reshape(b, kvh * g, 1, hd), k.permute(0, 2, 1, 3),
                    v.permute(0, 2, 1, 3),
                    (torch.arange(s_len, device="cuda") < kv_len[:, None])[:, None, None])
        row = {"shape": shape, "dtype": "bfloat16", **_decode_bound(shape, [s_len] * b, 2),
               "events_ms": time_cuda(launch, q, k, v, kv_len),
               "plain_events_ms": time_cuda(plain, q, k, v, kv_len, iters=5),
               "library_events_ms": time_cuda(library, *lib_args),
               "device_us": _device_us(torch, launch, q, k, v, kv_len),
               "plain_device_us": _device_us(torch, plain, q, k, v, kv_len, calls=5),
               "library_device_us": _device_us(torch, library, *lib_args)}
        for key in ("", "plain_", "library_"):
            row[f"{key}ms"] = row[f"{key}device_us"] * 1e-3
        row["library_vs_kernel_max_abs"] = (
            library(*lib_args).reshape(b, kvh, g, hd).float()
            - launch(q, k, v, kv_len)).abs().max().item()
        row["bytes_per_s"] = row["bytes"] / (row["ms"] * 1e-3)
        rows.append(row)
        log(f"[decode-times] {shape} bf16 kv_len=S, device-only (events): kernel "
            f"{row['device_us']:.2f} ({row['events_ms'] * 1e3:.2f}) us, "
            f"{row['bytes_per_s'] / 1e12:.3f} TB/s; plain {row['plain_device_us']:.2f} "
            f"({row['plain_events_ms'] * 1e3:.2f}) us; library "
            f"{row['library_device_us']:.2f} ({row['library_events_ms'] * 1e3:.2f}) us, "
            f"max abs diff {row['library_vs_kernel_max_abs']:.3e}; bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
    return rows


def _profile_step(torch, step, *args, calls: int = 1, top: int = 10, **kwargs) -> dict:
    """``calls`` profiled calls of ``step`` after one unprofiled call, per
    call: wall, device busy time, the share of the (profiled) wall the
    device sat idle, and the top kernels by device time and host ops by
    host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(*args, **kwargs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            step(*args, **kwargs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = _kernel_times(prof)
    busy = sum(dev.values())
    kernels_top = sorted(dev.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])[:top]
    return {"calls": calls, "wall_us": wall_us / calls, "device_us": busy / calls,
            "idle_share": 1 - busy / wall_us,
            "kinds": {k: us / calls for k, us in _kernel_kinds(prof).items()},
            "top": [[name[:90], us / calls] for name, us in kernels_top],
            "host_top": [[name[:60], us / calls, n / calls] for name, us, n in host]}


def _log_profile(tag, prof) -> None:
    log(f"[{tag}] profiled: device {prof['device_us']:.1f} us a call of "
        f"{prof['wall_us']:.1f} us wall ({prof['calls']} calls), idle share "
        f"{prof['idle_share']:.3f}")
    log(f"[{tag}] device us by kind: "
        + ", ".join(f"{k} {us:.1f}" for k, us in prof["kinds"].items()))
    for name, us in prof["top"]:
        log(f"[{tag}]   {us:9.1f} us  {name}")
    for name, us, n in prof["host_top"]:
        log(f"[{tag}]   host {us:9.1f} us in {n:g} calls  {name}")


def _lm_requests(cfg):
    """Phase 16's 16 requests, drawn anew from the same seed."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        size=int(rng.integers(16, 257))).tolist(),
                    max_new_tokens=int(rng.integers(16, 65)))
            for _ in range(LM_REQUESTS)]


def _serve_lm(torch, eng, cfg, decode) -> dict:
    """Serve phase 16's requests through ``decode`` (as ``eng._decode``) with
    every step's logits checked finite on the card: the requests, the
    launch counts, the steps and the wall."""
    finite = torch.ones((), dtype=torch.bool, device="cuda")

    def checked(*args):   # every step's logits finite, kept on the card
        logits, cache = decode(*args)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, cache

    reqs = _lm_requests(cfg)
    own, steps0 = eng._decode, eng.steps
    eng._decode = checked
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    eng._decode = own
    if not all(r.done and len(r.output) == r.max_new_tokens for r in reqs):
        raise AssertionError("LM serve: a request was not served to its length")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise AssertionError("LM serve: a token outside the vocabulary")
    if not bool(finite):
        raise AssertionError("LM serve: non-finite logits")
    return {"reqs": reqs, "launches": counts, "steps": eng.steps - steps0, "wall_s": wall}


def _cache_tensors(cache) -> list:
    """Every tensor of a serving cache: a list of KVCaches and state dicts
    (decoder-only) or a dict of KVCaches (encoder-decoder)."""
    if isinstance(cache, dict):
        return [t for v in cache.values() for t in _cache_tensors(v)]
    if isinstance(cache, (list, tuple)):
        return [t for v in cache for t in _cache_tensors(v)]
    return [cache]


def _attn_layers(model) -> int:
    """Layers whose decode runs the decode kernel: an LM's attention
    layers, an encoder-decoder's decoder self-attention layers."""
    cfg = model.cfg
    if cfg.encoder_layers:
        return cfg.n_layers
    return cfg.n_periods * sum(k == "attn" for k in model.mixer_kinds)


def _init_lm(torch, model, seed) -> tuple:
    """Random parameters from ``seed`` on the card, and their counts."""

    from repro_torch.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    return params, {"arch": model.cfg.name, "dtype": model.cfg.dtype,
                    "init_s": time.perf_counter() - t0,
                    "params": sum(t.numel() for t in leaves),
                    "param_bytes": sum(t.numel() * t.element_size() for t in leaves)}


def _decode_step_fns(torch, model, params, vocab, seed=3):
    """``(tok, step, graph_step, bitwise)`` over 8 slots: a seeded token a
    slot, the eager decode step on a cache, the engine's graphed step, and
    the gate that the graphed step's logits at ``pos`` are finite and
    bitwise the eager step's on the engine's cache."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tok = torch.randint(0, vocab, (LM_SLOTS, 1), device="cuda", generator=gen).int()

    def step(tokens, pos, cache):
        return model.decode_step(params, cache, {"tokens": tokens, "pos": pos})

    def graph_step(engine, pos):
        return engine._decode(params, engine.cache, {"tokens": tok, "pos": pos})

    def bitwise(engine, pos, where, tag):
        if not hasattr(engine._decode, "graph"):
            raise AssertionError(f"{tag}: the engine's decode step is not its graph")
        # a step rewrites its K/V rows with the same bits, but advances a
        # recurrent state: the eager step starts from the state the graph did
        states = [t for c in engine.cache if isinstance(c, dict) for t in c.values()]
        before = [t.clone() for t in states]
        got = graph_step(engine, pos)[0].clone()
        for t, b in zip(states, before):
            t.copy_(b)
        want = step(tok, pos, engine.cache)[0]
        if got.shape != (LM_SLOTS, 1, vocab) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag}: the graphed step's logits at {where} are not "
                                 f"finite or of shape {tuple(got.shape)}")
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}: the graphed decode step at {where} differs "
                                 f"from the eager one by {(got - want).abs().max().item()}")

    return tok, step, graph_step, bitwise


def _engine_serve(torch, model, params, tag) -> tuple:
    """ServeEngine(slots=8, max_len=1024) over ``params``: the 16 seeded
    requests through the decode graph (every request done at its length,
    tokens in the vocabulary, logits finite, decode-kernel launches =
    attention layers x engine steps), then through the eager step (the same
    tokens); tokens/s, device memory; a decode step at pos 320 through the
    graph bitwise the eager step, both timed and profiled. Returns the
    numbers and the engine."""
    from repro_torch.serve import ServeEngine
    from repro_torch.timing import time_cuda

    cfg = model.cfg
    out = {}
    torch.cuda.reset_peak_memory_stats()
    mem = {"before_engine": _memory(torch)}
    eng = ServeEngine(model, params, slots=LM_SLOTS, max_len=LM_MAX_LEN)
    mem["after_engine"] = _memory(torch)
    mem["cache_bytes"] = sum(t.numel() * t.element_size() for t in _cache_tensors(eng.cache))
    graphed = _serve_lm(torch, eng, cfg, eng._decode)
    want = _attn_layers(model) * graphed["steps"]
    if graphed["launches"]["decode_attention"] != want:
        raise AssertionError(f"{tag}: {graphed['launches']['decode_attention']} decode "
                             f"launches in {graphed['steps']} steps, want {want}")
    eager = _serve_lm(torch, eng, cfg, model.decode_step)
    if [r.output for r in eager["reqs"]] != [r.output for r in graphed["reqs"]]:
        raise AssertionError(f"{tag}: the eager decode step served other tokens")
    mem["after_serving"] = _memory(torch)
    reqs = graphed["reqs"]
    generated = sum(len(r.output) for r in reqs)
    fed = sum(len(r.prompt) for r in reqs) + generated
    for name, run in (("", graphed), ("eager_", eager)):
        out.update({f"{name}wall_s": run["wall_s"],
                    f"{name}tokens_per_s": generated / run["wall_s"],
                    f"{name}fed_tokens_per_s": fed / run["wall_s"]})
    out.update({"requests": len(reqs), "steps": graphed["steps"],
                "generated_tokens": generated, "fed_tokens": fed,
                "launches": graphed["launches"], "eager_launches": eager["launches"],
                "memory": mem, "prompt_lens": [len(r.prompt) for r in reqs],
                "new_tokens": [r.max_new_tokens for r in reqs]})
    log(f"[{tag}] {cfg.name} {cfg.dtype}: {len(reqs)} requests, {graphed['steps']} "
        f"engine steps, {generated} tokens generated ({fed} fed); through the decode "
        f"graph {graphed['wall_s']:.3f} s: {out['tokens_per_s']:.1f} generated tokens/s, "
        f"{out['fed_tokens_per_s']:.1f} fed tokens/s; eagerly {eager['wall_s']:.3f} s: "
        f"{out['eager_tokens_per_s']:.1f} / {out['eager_fed_tokens_per_s']:.1f} (host "
        f"clock), the same tokens; decode launches {graphed['launches']['decode_attention']}")
    log(f"[{tag}] device memory before / after the engine (its {mem['cache_bytes']} B "
        f"cache and decode graph) / after serving {mem['before_engine']} / "
        f"{mem['after_engine']} / {mem['after_serving']} (bytes)")

    tok, step, graph_step, bitwise = _decode_step_fns(torch, model, params,
                                                      cfg.vocab_size)
    pos = torch.full((LM_SLOTS,), 320, dtype=torch.int32, device="cuda")
    bitwise(eng, pos, "pos 320", tag)
    out["step_ms"] = time_cuda(step, tok, pos, eng.cache)
    out["graph_step_ms"] = time_cuda(graph_step, eng, pos)
    out["step_profile"] = _profile_step(torch, step, tok, pos, eng.cache)
    out["graph_step_profile"] = _profile_step(torch, graph_step, eng, pos)
    for name in ("", "eager_"):   # a served step's wall against a step's device time
        per_step_us = 1e6 * out[f"{name}wall_s"] / out["steps"]
        out[f"{name}served_step_idle_share"] = (
            1 - out["graph_step_profile"]["device_us"] / per_step_us)
    log(f"[{tag}] decode step at {LM_SLOTS} slots, pos 320, max_len {LM_MAX_LEN}: "
        f"graph {out['graph_step_ms']:.4f} ms, eager {out['step_ms']:.4f} ms (CUDA "
        f"events, 20 steps); graph bitwise equal to the eager step; a served step's "
        f"idle share (host clock) graph {out['served_step_idle_share']:.3f}, eager "
        f"{out['eager_served_step_idle_share']:.3f}")
    _log_profile(f"{tag} graph", out["graph_step_profile"])
    _log_profile(f"{tag} eager", out["step_profile"])
    return out, eng


def phase_lm_serve(torch) -> dict:
    """Full-width Llama-3-8B in bf16 served by ServeEngine through its
    decode graph (:func:`_engine_serve`), then one decode step over a full
    32k cache both ways."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeEngine
    from repro_torch.timing import time_cuda

    model = build_model(get_config(LM_ARCH))
    params, out = _init_lm(torch, model, seed=0)
    log(f"[lm-serve] {LM_ARCH}, {out['params']} params ({out['param_bytes'] / 1e9:.2f} "
        f"GB, init {out['init_s']:.1f} s)")
    served, eng = _engine_serve(torch, model, params, "lm-serve")
    out.update(served)
    del eng
    torch.cuda.empty_cache()
    tok, step, graph_step, bitwise = _decode_step_fns(torch, model, params,
                                                      model.cfg.vocab_size)
    gen = torch.Generator(device="cuda").manual_seed(4)
    long_eng = ServeEngine(model, params, slots=LM_SLOTS, max_len=LM_LONG)
    for t in _cache_tensors(long_eng.cache):
        t.normal_(generator=gen)
    torch.cuda.synchronize()
    pos = torch.full((LM_SLOTS,), LM_LONG - 1, dtype=torch.int32, device="cuda")
    out["long_cache_bytes"] = sum(t.numel() * t.element_size()
                                  for t in _cache_tensors(long_eng.cache))
    bitwise(long_eng, pos, f"kv_len {LM_LONG}", "lm-serve")
    out["long_step_ms"] = time_cuda(step, tok, pos, long_eng.cache, iters=5, warmup=1)
    out["long_graph_step_ms"] = time_cuda(graph_step, long_eng, pos, iters=5, warmup=1)
    out["long_step_profile"] = _profile_step(torch, step, tok, pos, long_eng.cache)
    out["long_graph_step_profile"] = _profile_step(torch, graph_step, long_eng, pos)
    log(f"[lm-serve] decode step at {LM_SLOTS} slots, kv_len {LM_LONG} "
        f"({out['long_cache_bytes'] / 1e9:.1f} GB of random K/V): graph "
        f"{out['long_graph_step_ms']:.4f} ms, eager {out['long_step_ms']:.4f} ms (CUDA "
        f"events, 5 steps); graph bitwise equal to the eager step; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    _log_profile("lm-serve 32k graph", out["long_graph_step_profile"])
    _log_profile("lm-serve 32k eager", out["long_step_profile"])
    del long_eng, params
    torch.cuda.empty_cache()
    return out


def _pad_kv(cache, n: int):
    """A prefill cache with ``n`` zero rows more in every decoder KV cache
    (an encoder-decoder's cross K/V and recurrent states as they are)."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L

    def pad(kv):
        return L.KVCache(*(F.pad(t, (0, 0, 0, 0, 0, n)) for t in kv))

    if isinstance(cache, dict):
        return {"self": pad(cache["self"]), "cross": cache["cross"]}
    return [c if isinstance(c, dict) else pad(c) for c in cache]


def _lm_parity(torch, model, tag, batch, n_tok, n_pre, seed=1, extra=None,
               n_full=None, profile=False) -> dict:
    """Teacher-forced fp32 ``decode_step`` logits (through the decode
    kernel) against the full-sequence ``apply`` logits: ``batch`` rows of
    ``n_tok`` seeded tokens (``n_full`` for the forward, when longer),
    ``n_pre`` prefilled, rtol/atol LM_RTOL/LM_ATOL; ``extra`` (patch
    embeddings or frames) goes to the forward and the prefill. Checks the
    decode launches; times the prefill (host clock, synced) and, with
    ``profile``, profiles it."""
    cfg = model.cfg
    params, info = _init_lm(torch, model, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (batch, n_full or n_tok), device="cuda",
                         generator=gen)
    extra = extra or {}
    full, _ = model.apply(params, {"tokens": toks, **extra})
    off = cfg.n_patches if "patch_embeds" in extra else 0   # text after the patches
    worst = {"err": 0.0, "excess": 0.0}

    def compare(got, want, where):
        err = (got - want).abs()
        excess = (err - (LM_ATOL + LM_RTOL * want.abs())).max().item()
        worst["err"] = max(worst["err"], err.max().item())
        worst["excess"] = max(worst["excess"], excess)
        if excess > 0:
            raise AssertionError(f"{tag} at {where}: decode logits off the full "
                                 f"forward by {err.max().item()} (rtol/atol {LM_RTOL})")

    inputs = {"tokens": toks[:, :n_pre], **extra}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, inputs)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    compare(logits[:, 0], full[:, off + n_pre - 1], "the prefill")
    cache = _pad_kv(cache, n_tok - n_pre)
    _reset_counts()
    for t in range(n_pre, n_tok):
        logits, cache = model.decode_step(params, cache, {
            "tokens": toks[:, t : t + 1],
            "pos": torch.full((batch,), off + t, device="cuda")})
        compare(logits[:, 0], full[:, off + t], f"position {t}")
    launches = _read_counts()["decode_attention"]
    if launches != _attn_layers(model) * (n_tok - n_pre):
        raise AssertionError(f"{tag}: {launches} decode launches")
    out = {**info, "batch": batch, "tokens": n_tok, "prefill": n_pre,
           "forward_tokens": n_full or n_tok, "prefill_s": prefill_s,
           "max_abs_err": worst["err"],
           "max_logit": full.abs().max().item(), "rtol": LM_RTOL, "atol": LM_ATOL,
           "decode_launches": launches}
    log(f"[{tag}] {cfg.name} fp32, {out['params']} params, {cfg.n_layers} layers: "
        f"prefill {n_pre} + {n_tok - n_pre} decoded at batch {batch} vs apply over "
        f"{out['forward_tokens']}: max abs err {worst['err']:.3e} (max |logit| "
        f"{out['max_logit']:.3f}; rtol/atol {LM_RTOL}); decode launches {launches}; "
        f"the prefill {prefill_s:.3f} s (host clock)")
    if profile:
        del cache
        out["prefill_profile"] = _profile_step(torch, model.prefill, params, inputs)
        _log_profile(f"{tag} prefill", out["prefill_profile"])
        cache = None
    del params, cache, full
    torch.cuda.empty_cache()
    return out


def phase_lm_parity(torch) -> dict:
    """Full-width Llama-3-8B in fp32: teacher-forced decode_step logits
    (through the decode kernel) against the full-sequence apply logits."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model

    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    batch, n_tok, n_pre = LM_PARITY
    return _lm_parity(torch, build_model(cfg), "lm-parity", batch, n_tok, n_pre)


def _family_cfg(arch, dtype="bfloat16", no_drops=False, **cut):
    """``arch``'s full config in ``dtype``, cut by ``cut`` (``n_layers``,
    ``n_experts``), with capacity for every token when ``no_drops``
    (``capacity_factor = n_experts / top_k``, so ``C >= T``)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    moe = cfg.moe
    if "n_experts" in cut:
        moe = dataclasses.replace(moe, n_experts=cut.pop("n_experts"))
    if no_drops and moe.n_experts:
        moe = dataclasses.replace(moe, capacity_factor=moe.n_experts / moe.top_k)
    return dataclasses.replace(cfg, dtype=dtype, moe=moe, **cut)


def _slot_reset(torch, model, params, tag) -> dict:
    """Three seeded requests through two slots, so the third enters the
    slot the first left (its recurrent state zeroed at admission); the
    third request alone in a fresh engine gives the same tokens."""
    import numpy as np

    from repro_torch.serve import Request, ServeEngine

    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, model.cfg.vocab_size, size=n).tolist(),
                    max_new_tokens=k) for n, k in ((24, 8), (40, 16), (32, 12))]
    ServeEngine(model, params, slots=2, max_len=LM_MAX_LEN).run(reqs)
    alone = Request(prompt=reqs[2].prompt, max_new_tokens=reqs[2].max_new_tokens)
    ServeEngine(model, params, slots=2, max_len=LM_MAX_LEN).run([alone])
    if not all(r.done for r in reqs) or alone.output != reqs[2].output:
        raise AssertionError(f"{tag}: a request in a recycled slot served "
                             f"{reqs[2].output}, alone {alone.output}")
    log(f"[{tag}] slot reset: the third of three requests through two slots "
        f"(a recycled slot) served the tokens it serves alone in a fresh engine")
    torch.cuda.empty_cache()
    return {"tokens": alone.output, "equal": True}


def _prefill_decode(torch, model, params, tag, batch, n_prompt, n_gen, extra) -> dict:
    """Prefill of ``batch`` seeded prompts of ``n_prompt`` tokens after
    ``extra`` (frames or patch embeddings), its cache copied into a cache of
    the prefill's length + ``n_gen`` rows, then ``n_gen`` greedy decode
    steps through one CUDA graph and again eagerly over the same cache:
    every step's logits bitwise equal, finite, the same tokens, decode
    launches = attention layers x steps. Times the prefill (host clock,
    synced) and a decode step (CUDA events), profiles one."""
    from repro_torch.graphs import CudaGraph
    from repro_torch.timing import time_cuda

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (batch, n_prompt), device="cuda",
                         generator=gen)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, pre = model.prefill(params, {"tokens": toks, **extra})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    s0 = n_prompt + (cfg.n_patches if "patch_embeds" in extra else 0)
    max_len = s0 + n_gen
    cache = model.init_cache(batch, max_len)
    for full, part in zip(_cache_tensors(cache), _cache_tensors(pre)):
        full[:, :, : part.shape[2]].copy_(part)
    del pre
    tok0 = logits[:, -1].argmax(-1)[:, None].int()
    pos0 = torch.full((batch,), s0, dtype=torch.int32, device="cuda")

    def step(tok, pos):
        return model.decode_step(params, cache, {"tokens": tok, "pos": pos})[0]

    # the warm-up writes the first step's own row: the same bits it writes
    graph = CudaGraph(step, tok0, pos0)

    def greedy(run):
        tok, out_toks, out_logits = tok0, [], []
        for i in range(n_gen):
            lg = run(tok, pos0 + i).clone()
            out_logits.append(lg)
            tok = lg[:, -1].argmax(-1)[:, None].int()
            out_toks.append(tok)
        return torch.cat(out_toks, 1), out_logits

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_toks, g_logits = greedy(graph)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    launches = _read_counts()["decode_attention"]
    e_toks, e_logits = greedy(step)
    if launches != _attn_layers(model) * n_gen:
        raise AssertionError(f"{tag}: {launches} decode launches in {n_gen} steps")
    if not all(bool(torch.isfinite(x).all()) for x in g_logits):
        raise AssertionError(f"{tag}: non-finite decode logits")
    if not (torch.equal(g_toks, e_toks) and all(torch.equal(a, b)
                                                for a, b in zip(g_logits, e_logits))):
        raise AssertionError(f"{tag}: the graphed greedy decode differs from the eager one")
    if int(g_toks.min()) < 0 or int(g_toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{tag}: a token outside the vocabulary")
    out = {"batch": batch, "prompt": n_prompt, "prefill_tokens": s0,
           "decode_steps": n_gen, "cache_rows": max_len, "prefill_s": prefill_s,
           "graph_decode_s": graph_s, "decode_launches": launches,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "step_ms": time_cuda(step, tok0, pos0),
           "graph_step_ms": time_cuda(graph, tok0, pos0),
           "graph_step_profile": _profile_step(torch, graph, tok0, pos0)}
    log(f"[{tag}] {cfg.name}: prefill of {batch} x {s0} tokens {prefill_s:.3f} s (host "
        f"clock); {n_gen} greedy decode steps over {max_len} cache rows through one "
        f"graph {graph_s:.3f} s, bitwise the eager steps (logits and tokens); decode "
        f"launches {launches}; a step graph {out['graph_step_ms']:.4f} ms, eager "
        f"{out['step_ms']:.4f} ms (CUDA events); peak {out['peak_bytes'] / 1e9:.1f} GB")
    _log_profile(f"{tag} graph", out["graph_step_profile"])
    del cache, graph
    torch.cuda.empty_cache()
    return out


def phase_lm_families(torch) -> dict:
    """The families beyond the dense decoder at full width, bf16, random
    weights from seeds, each freed before the next: DBRX, Jamba and xLSTM
    served by ServeEngine (:func:`_engine_serve`), the recycled-slot check
    on Jamba (at capacity ``E / k``) and xLSTM; Whisper's and LLaVA's
    prefill then a graphed greedy decode; then each family's fp32 parity of
    teacher-forced decode against the forward (:func:`_lm_parity`), MoE at
    capacity ``E / k``. FAMILY_SERVE, FAMILY_PREFILL and FAMILY_PARITY list
    the configurations and their cuts."""
    from repro_torch.models.lm import build_model

    out = {"serve": {}, "prefill_decode": {}, "parity": {}}
    for arch, cut, why in FAMILY_SERVE:
        tag = f"lm-families {arch}"
        model = build_model(_family_cfg(arch, **cut))
        params, info = _init_lm(torch, model, seed=7)
        log(f"[{tag}] bf16, {info['params']} params ({info['param_bytes'] / 2 ** 30:.2f}"
            f" GiB, init {info['init_s']:.1f} s); cut: {why}")
        served, eng = _engine_serve(torch, model, params, tag)
        del eng
        torch.cuda.empty_cache()
        row = {**info, "cut": why, **served}
        if model.mixer_kinds != ["attn"]:   # recurrent state: the slot-reset check
            row["slot_reset"] = _slot_reset(
                torch, build_model(_family_cfg(arch, no_drops=True, **cut)), params, tag)
        out["serve"][arch] = row
        del params
        torch.cuda.empty_cache()
    for arch, batch, n_prompt, n_gen, why in FAMILY_PREFILL:
        tag = f"lm-families {arch}"
        model = build_model(_family_cfg(arch))
        params, info = _init_lm(torch, model, seed=8)
        cfg = model.cfg
        gen = torch.Generator(device="cuda").manual_seed(9)
        if cfg.encoder_layers:
            extra = {"frames": torch.randn((batch, cfg.n_frames, cfg.d_model), device="cuda",
                                           generator=gen).to(torch.bfloat16)}
        else:
            extra = {"patch_embeds": torch.randn((batch, cfg.n_patches, cfg.d_model),
                                                 device="cuda", generator=gen
                                                 ).to(torch.bfloat16)}
        log(f"[{tag}] bf16, {info['params']} params ({info['param_bytes'] / 2 ** 30:.2f}"
            f" GiB); cut: {why}")
        out["prefill_decode"][arch] = {**info, "cut": why, **_prefill_decode(
            torch, model, params, tag, batch, n_prompt, n_gen, extra)}
        del params, extra
        torch.cuda.empty_cache()
    for arch, cut, batch, n_tok, n_pre, n_full, why in FAMILY_PARITY:
        model = build_model(_family_cfg(arch, dtype="float32", no_drops=True, **cut))
        cfg = model.cfg
        gen = torch.Generator(device="cuda").manual_seed(10)
        extra = None
        if cfg.encoder_layers:
            extra = {"frames": torch.randn((batch, cfg.n_frames, cfg.d_model),
                                           device="cuda", generator=gen)}
        elif cfg.n_patches:
            extra = {"patch_embeds": torch.randn((batch, cfg.n_patches, cfg.d_model),
                                                 device="cuda", generator=gen)}
        log(f"[lm-families parity {arch}] cut: {why}")
        out["parity"][arch] = {"cut": why, **_lm_parity(
            torch, model, f"lm-families parity {arch}", batch, n_tok, n_pre,
            extra=extra, n_full=n_full, profile=arch in FAMILY_PROFILED_PREFILL)}
        del extra
        torch.cuda.empty_cache()
    out["decode_launches"] = (
        sum(r["launches"]["decode_attention"] for r in out["serve"].values())
        + sum(r["decode_launches"] for r in out["prefill_decode"].values()))
    return out


def _zoo_layer_shapes():
    """``{model: [(1, N, n, P, Cin, Cout), ...]}``: every Table-4 layer of
    the four GANs at batch 1."""
    from repro_torch.models import gan

    return {name: [(1, hw, cfg.kernel, cfg.padding, cin, cout)
                   for hw, cin, cout in cfg.layers]
            for name, cfg in gan.GAN_ZOO.items()}


def _max_err(torch, got, want) -> tuple:
    """The largest absolute difference and its tolerance
    ``TOL_REL * max|want| + TOL_ABS``; a shape mismatch raises."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    torch.cuda.synchronize()
    return ((got - want).abs().max().item(),
            TOL_REL * want.abs().max().item() + TOL_ABS)


def phase_zoo_check(torch) -> dict:
    """Every method name of ``transpose_conv2d`` (with a bias and relu) at
    the Table-2 shapes and at every distinct Table-4 layer at batch 1,
    against the tap-by-tap oracle on the card; the fused and per-phase
    kernels against their plain versions at the Table-2 shapes with every
    epilogue; the segregated dilated convolution against the dense one."""
    from repro_torch.core import transpose_conv as tc
    from repro_torch.core.dilated_conv import dilated_conv2d
    from repro_torch.kernels.ref import conventional_ref

    names = sorted(tc.METHODS) + sorted(tc.KERNEL_METHODS)
    shapes = TABLE2_SHAPES + sorted({s for layers in _zoo_layer_shapes().values()
                                     for s in layers})
    worst = {}
    for i, shape in enumerate(shapes):
        x, k, bias = _inputs(torch, shape, seed=900 + i)
        pad = shape[3]
        want = torch.relu(conventional_ref(x, k, pad) + bias)
        errs = {}
        for name in names:
            got = tc.transpose_conv2d(x, k, pad, method=name, bias=bias, act="relu")
            err, tol = _max_err(torch, got, want)
            if not err <= tol:
                raise AssertionError(f"transpose_conv2d(method={name!r}) misses the "
                                     f"oracle at {shape}: {err} > {tol}")
            errs[name] = err
            worst[name] = max(worst.get(name, 0.0), err)
        log(f"[zoo] {shape}: {len(names)} methods within {tol:.3e} of the oracle, "
            f"worst {max(errs, key=errs.get)} {max(errs.values()):.3e}")
    for name, (launch, plain) in kernels(("fused", "phase")).items():
        for i, shape in enumerate(TABLE2_SHAPES):
            x, k, bias = _inputs(torch, shape, seed=950 + i)
            for epi in epilogues():
                b = bias if epi is not None else None
                err, tol = _max_err(torch, launch(x, k, shape[3], epilogue=epi, bias=b),
                                    plain(x, k, shape[3], epilogue=epi, bias=b))
                if not err <= tol:
                    raise AssertionError(f"{name} kernel disagrees with its plain "
                                         f"version at {shape} {_tag(epi)}: {err} > {tol}")
                worst[f"{name}_table2"] = max(worst.get(f"{name}_table2", 0.0), err)
        log(f"[zoo] {name} kernel at the Table-2 shapes, every epilogue: max abs err "
            f"{worst[f'{name}_table2']:.3e} against its plain version")
    x, k, _ = _inputs(torch, (PAPER_BATCH, 224, 3, 0, 3, 3), seed=999)
    err, tol = _max_err(torch, dilated_conv2d(x, k, method="segregated"),
                        dilated_conv2d(x, k, method="conventional"))
    if not err <= tol:
        raise AssertionError(f"segregated dilated conv misses the dense one: {err} > {tol}")
    worst["dilated"] = err
    log(f"[zoo] dilated conv (4, 224, 224, 3) * 3x3: segregated against dense "
        f"{err:.3e} (tol {tol:.3e}); zoo check passed")
    return worst


def _paper_forwards(pad: int) -> dict:
    """``{name: fn(x, k)}`` of PAPER_FORWARDS at padding ``pad``."""
    import functools

    from repro_torch.core import transpose_conv as tc
    from repro_torch.kernels.ref import conventional_ref

    fns = {"naive": functools.partial(conventional_ref, padding=pad)}
    for name in PAPER_FORWARDS[1:]:
        fns[name] = functools.partial(tc.transpose_conv2d, padding=pad, method=name)
    return fns


def _vjp(x, k, g, *, pad, method):
    """The forward and its vector-Jacobian product with ``g``, as
    ``jax.vjp(f, x, k)[1](g)`` runs under jit."""
    import torch

    from repro_torch.core import transpose_conv as tc

    return torch.autograd.grad(tc.transpose_conv2d(x, k, pad, method=method), (x, k), g)


def _step(x, k, *, pad, method):
    """Value and gradients of ``sum(tconv(x, k))``, as ``value_and_grad``."""
    import torch

    from repro_torch.core import transpose_conv as tc

    y = tc.transpose_conv2d(x, k, pad, method=method).sum()
    return (y,) + torch.autograd.grad(y, (x, k))


def _call_memory(torch, fn, *args, **kwargs) -> dict:
    """Device memory of one eager call under ``inference_mode``, after one
    warm-up call: the peak above what was allocated before it, the bytes it
    allocated in all (``allocated_bytes.all.allocated``'s growth), and, from
    the allocator's history of the call, each allocation size of 256 KiB or
    more with its count (largest first) and the bytes of the smaller ones."""
    with torch.inference_mode():
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
        torch.cuda.memory._record_memory_history(enabled="all", context=None,
                                                 stacks="python", clear_history=True)
        try:
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            trace = torch.cuda.memory._snapshot()["device_traces"]
        finally:
            torch.cuda.memory._record_memory_history(enabled=None)
        peak = torch.cuda.max_memory_allocated() - base
        total = torch.cuda.memory_stats()["allocated_bytes.all.allocated"] - before
    del out
    sizes = [e["size"] for dev in trace for e in dev if e["action"] == "alloc"]
    large = {}
    for size in sizes:
        if size >= 1 << 18:
            large[size] = large.get(size, 0) + 1
    return {"peak_bytes": peak, "allocated_bytes": total,
            "large_allocations": sorted(large.items(), reverse=True),
            "small_allocated_bytes": sum(x for x in sizes if x < 1 << 18)}


def _found_bytes(reading: dict, sizes) -> int:
    """The bytes of ``sizes`` among a call's allocations of 256 KiB or more,
    each size matched to one allocation at most."""
    left = dict(reading["large_allocations"])
    found = 0
    for size in sizes:
        if left.get(size, 0):
            left[size] -= 1
            found += size
    return found


def _memory_saved(torch, fn) -> dict:
    """Both readings of ``fn(method)`` for ``conventional``, ``unified`` (the
    same PyTorch convolutions and post-ops without the upsampled map) and
    ``auto`` (the default plan: the GEMM and fused kernels), and what each
    of the last two saves against ``conventional`` in each reading."""
    got = {m: _call_memory(torch, fn, m) for m in ("conventional", "unified", "auto")}
    for m in ("unified", "auto"):
        for reading in ("peak_bytes", "allocated_bytes"):
            got[m][f"{reading}_saved"] = (got["conventional"][reading]
                                          - got[m][reading])
    return got


def phase_paper(torch) -> dict:
    """The paper's three claims on the card. Tables 2-3: each forward of
    PAPER_FORWARDS at TABLE2_SHAPES by graph replay (host taken out), per
    image and per dataset, the speedups over n with the fused kernel and
    with ``unified`` as the proposed method, the fused and per-phase kernels
    also by events with their plain versions, the library call and the
    bound. Table 4: every layer of the four GANs at batch 1, each forward,
    and the backward and full step of PAPER_TRAINING. Memory: one eager
    EB-GAN generator call and one Table-2 image (:func:`_memory_saved`)."""
    import torch.nn.functional as F

    from repro_torch.core import transpose_conv as tc
    from repro_torch.core.segregation import memory_savings_bytes, output_size
    from repro_torch.models import gan
    from repro_torch.timing import time_cuda

    table2 = []
    for i, shape in enumerate(TABLE2_SHAPES):
        b, n_in, n_k, pad, cin, cout = shape
        x, k, _ = _inputs(torch, shape, seed=1000 + i)
        dev = {name: _device_us(torch, fn, x, k)
               for name, fn in _paper_forwards(pad).items()}
        x_nchw, w_t = x.permute(0, 3, 1, 2).contiguous(), _flipped(torch, k)

        def library(xx, ww, _pad=n_k - 1 - pad):
            return F.conv_transpose2d(xx, ww, stride=2, padding=_pad)

        dev["library"] = _device_us(torch, library, x_nchw, w_t)
        per_image = {name: us / b for name, us in dev.items()}
        row = {"n": n_k, "shape": shape, **_bound(shape), "device_us": dev,
               "per_image_us": per_image,
               "events_us": {"pallas": time_cuda(tc.transpose_conv2d, x, k, pad,
                                                 method="pallas") * 1e3,
                             "pallas_phase": time_cuda(tc.transpose_conv2d, x, k, pad,
                                                       method="pallas_phase") * 1e3,
                             "library": time_cuda(library, x_nchw, w_t) * 1e3},
               "plain_us": {name: time_cuda(plain, x, k, pad, iters=5) * 1e3
                            for name, (_, plain) in kernels(("fused", "phase")).items()},
               "speedup": {p: dev["conventional"] / dev[p] for p in ("pallas", "unified")},
               "naive_ratio": {p: dev["naive"] / dev[p] for p in ("pallas", "unified")},
               "datasets_s": {group: {name: per_image[name] * count * 1e-6
                                      for name in ("naive", "conventional", "unified",
                                                   "pallas")}
                              for group, count in {**TABLE2_GROUPS,
                                                   **TABLE3_DATASETS}.items()}}
        table2.append(row)
        log(f"[paper] Table 2 n={n_k} {shape}: device us a call ({b} images) "
            + ", ".join(f"{name} {us:.2f}" for name, us in dev.items())
            + f" | bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: "
            f"{row['bytes']} B, {row['flops']} FLOP) | events us {row['events_us']} "
            f"plain us {row['plain_us']}")
        log(f"[paper] Table 2 n={n_k}: conventional / pallas "
            f"{row['speedup']['pallas']:.3f}, conventional / unified "
            f"{row['speedup']['unified']:.3f}; naive / pallas "
            f"{row['naive_ratio']['pallas']:.3f}, naive / unified "
            f"{row['naive_ratio']['unified']:.3f}")
        for group, secs in row["datasets_s"].items():
            log(f"[paper] Table {2 if group in TABLE2_GROUPS else 3} {group} n={n_k}: "
                + ", ".join(f"{name} {t:.6f} s" for name, t in secs.items()))
    claims = {f"table2_{ratio}_{p}": sum(r[ratio][p] for r in table2) / len(table2)
              for ratio in ("speedup", "naive_ratio") for p in ("pallas", "unified")}
    log(f"[paper] Tables 2-3, mean over n of t(conventional) / t(proposed): pallas "
        f"{claims['table2_speedup_pallas']:.3f}, unified "
        f"{claims['table2_speedup_unified']:.3f} (the paper: 2.03); naive / proposed: "
        f"pallas {claims['table2_naive_ratio_pallas']:.3f}, unified "
        f"{claims['table2_naive_ratio_unified']:.3f}")

    table4 = {}
    for model, shapes in _zoo_layer_shapes().items():
        layers = []
        for i, shape in enumerate(shapes):
            b, n_in, n_k, pad, cin, cout = shape
            x, k, _ = _inputs(torch, shape, seed=1100 + i)
            fwd = {name: _device_us(torch, fn, x, k)
                   for name, fn in _paper_forwards(pad).items()}
            m = output_size(n_in, n_k, pad)
            xg, kg = x.requires_grad_(True), k.requires_grad_(True)
            g = torch.randn((b, m, m, cout), device=x.device,
                            generator=torch.Generator(x.device).manual_seed(i))
            bwd = {m: _device_us(torch, _vjp, xg, kg, g, pad=pad, method=m)
                   for m in PAPER_TRAINING}
            step = {m: _device_us(torch, _step, xg, kg, pad=pad, method=m)
                    for m in PAPER_TRAINING}
            layers.append({"layer": f"L{i}", "shape": shape, "fwd_us": fwd,
                           "bwd_us": bwd, "step_us": step,
                           "mem_savings_bytes": memory_savings_bytes(
                               n_in, cin, 4, pad, mode="buffer")})
            log(f"[paper] Table 4 {model} L{i} {shape}: fwd us "
                + ", ".join(f"{n} {t:.2f}" for n, t in fwd.items())
                + " | bwd us " + ", ".join(f"{n} {t:.2f}" for n, t in bwd.items())
                + " | step us " + ", ".join(f"{n} {t:.2f}" for n, t in step.items()))
        tot = {key: {n: sum(r[key][n] for r in layers) for n in layers[0][key]}
               for key in ("fwd_us", "bwd_us", "step_us")}
        ratios = {"naive_over_auto": tot["fwd_us"]["naive"] / tot["fwd_us"]["auto"],
                  "conventional_over_auto": (tot["fwd_us"]["conventional"]
                                             / tot["fwd_us"]["auto"]),
                  "step_conventional_over_auto": (tot["step_us"]["conventional"]
                                                  / tot["step_us"]["auto"])}
        table4[model] = {"layers": layers, "totals": tot, **ratios,
                         "mem_savings_bytes": sum(r["mem_savings_bytes"] for r in layers)}
        log(f"[paper] Table 4 {model} total: fwd us "
            + ", ".join(f"{n} {t:.2f}" for n, t in tot["fwd_us"].items())
            + f" | step us {tot['step_us']} | naive / auto "
            f"{ratios['naive_over_auto']:.3f}, conventional / auto "
            f"{ratios['conventional_over_auto']:.3f}, step conventional / auto "
            f"{ratios['step_conventional_over_auto']:.3f}")
    for key in ("naive_over_auto", "conventional_over_auto",
                "step_conventional_over_auto"):
        claims[f"table4_{key}"] = sum(m[key] for m in table4.values()) / len(table4)
    log(f"[paper] Table 4, mean over the four models: naive / auto "
        f"{claims['table4_naive_over_auto']:.3f}, conventional / auto "
        f"{claims['table4_conventional_over_auto']:.3f}, step conventional / auto "
        f"{claims['table4_step_conventional_over_auto']:.3f} (the paper: 3.5)")

    cfg = gan.EBGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    z = torch.randn((1, cfg.z_dim), generator=torch.Generator().manual_seed(0))
    memory = {"ebgan": _memory_saved(
        torch, lambda method: gan.generator_apply(params, cfg, z, method=method))}
    memory["ebgan"]["analytic_bytes"] = gan.generator_memory_savings(cfg)
    memory["ebgan"]["upsampled_found_bytes"] = _found_bytes(
        memory["ebgan"]["conventional"],
        [4 * (2 * hw - 1 + 2 * cfg.padding) ** 2 * cin for hw, cin, _ in cfg.layers])
    memory["ebgan"]["analytic_with_epilogue_bytes"] = gan.generator_memory_savings(
        cfg, include_epilogue=True)
    for i, shape in enumerate(TABLE2_SHAPES):
        _, n_in, n_k, pad, cin, _ = shape
        x, k, _ = _inputs(torch, (1,) + shape[1:], seed=1200 + i)
        memory[f"table2_n{n_k}"] = _memory_saved(
            torch, lambda method: tc.transpose_conv2d(x, k, pad, method=method))
        memory[f"table2_n{n_k}"]["analytic_bytes"] = memory_savings_bytes(n_in, cin, 4, pad)
        memory[f"table2_n{n_k}"]["upsampled_found_bytes"] = _found_bytes(
            memory[f"table2_n{n_k}"]["conventional"], [4 * (2 * n_in - 1 + 2 * pad) ** 2 * cin])
    for name, m in memory.items():
        log(f"[paper] memory {name}: " + "; ".join(
            f"{meth} peak {m[meth]['peak_bytes']} B, allocated "
            f"{m[meth]['allocated_bytes']} B"
            + (f" (saves {m[meth]['peak_bytes_saved']} B of peak, "
               f"{m[meth]['allocated_bytes_saved']} B allocated)"
               if meth != "conventional" else "")
            for meth in ("conventional", "unified", "auto"))
            + f"; analytic (the upsampled buffers never made) {m['analytic_bytes']} B; "
            f"the padded upsampled buffers among conventional's allocations "
            f"{m['upsampled_found_bytes']} B")
        for meth in ("conventional", "unified", "auto"):
            log(f"[paper] memory {name} {meth}: allocations of 256 KiB or more "
                f"[size B, count] {m[meth]['large_allocations']}, smaller ones "
                f"{m[meth]['small_allocated_bytes']} B in all")
    del params
    return {"table2": table2, "table4": table4, "memory": memory, "claims": claims}



def _obs_requests(cfg, rate):
    """An open-loop Poisson trace of SERVE_WINDOW_S seconds at ``rate``
    requests/s, drawn as phase 6 draws it (the same seed, sizes and
    latents)."""
    import numpy as np

    from repro_torch.serve import GenRequest

    rng = np.random.default_rng(int(rate))
    count = int(rate * SERVE_WINDOW_S)
    sizes = rng.integers(1, 5, size=count)
    zs = rng.standard_normal((int(sizes.sum()), cfg.z_dim)).astype(np.float32)
    ends = np.cumsum(sizes)
    reqs = [GenRequest("dcgan", zs[e - n : e]) for n, e in zip(sizes, ends)]
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=count)).tolist()
    return reqs, arrivals, float(sizes.mean())


def _obs_window(torch, eng, cfg, rate, per_bucket, tag) -> dict:
    """One open-loop window through ``eng`` (a GanEngine or a supervisor),
    its batches' buckets recorded and its sleeps timed: the serving row,
    and the launch counts of the window equal, exactly, the sum of its
    batches' eager counts (a replay, traced or not, launches what its eager
    call does)."""
    reqs, arrivals, mean_n = _obs_requests(cfg, rate)
    buckets, slept = [], []
    execute = eng._execute

    def recording(name, batch, bucket):
        buckets.append(bucket)
        execute(name, batch, bucket)

    def timed_sleep(s):
        t0 = time.perf_counter()
        time.sleep(s)
        slept.append(time.perf_counter() - t0)

    eng._execute = recording
    # earlier work's garbage (engines and their graphs, in reference cycles)
    # freed now: a collection that frees graphs inside the window stalls one
    # dispatch for ~200 ms, past the supervisor's 50 ms deadline
    gc.collect()
    _reset_counts()
    t0 = time.perf_counter()
    eng.replay(reqs, arrivals, sleep=timed_sleep)
    wall_s = time.perf_counter() - t0
    launches = _read_counts()
    del eng._execute   # the class's method again, with no cycle through the instance
    want = {k: sum(per_bucket[b][k] for b in buckets) for k in launches}
    if launches != want or min(launches[n] for n in FORWARD) < 1:
        raise AssertionError(f"{tag}: the window counted {launches}, its batches' "
                             f"eager calls {want}")
    # a request refused at admission (the queue bound, when the loop falls
    # behind) is counted and reported; every admitted one must be served
    cons = eng.conservation()
    if not cons["ok"] or cons["failed"] or cons["expired"]:
        raise AssertionError(f"{tag}: {cons}")
    if not all(r.done for r in reqs if not r.rejected):
        raise AssertionError(f"{tag}: an admitted request was not served")
    s = eng.metrics.summary()
    lat = s["latency_s"]
    return {"tag": tag, "offered_requests_per_s": rate,
            "offered_samples_per_s": rate * mean_n, "window_s": SERVE_WINDOW_S,
            "wall_s": wall_s, "requests": len(reqs), "done": s["requests"],
            "rejected": s["rejected"],
            "samples": s["samples"], "batches": s["batches"],
            "bucket_batches": s["bucket_batches"],
            "samples_per_s": s["samples_per_s"], "pad_waste": s["pad_waste"],
            "latency_ms": {k: v * 1e3 for k, v in lat.items()},
            "batch_period_ms_mean": wall_s * 1e3 / s["batches"],
            "sleep_ms_per_batch_mean": sum(slept) * 1e3 / s["batches"],
            "launches": launches, "reqs": reqs}


def _log_window(card, row) -> None:
    lat = row["latency_ms"]
    log(f"[obs] {row['tag']} on {card}: offered {row['offered_requests_per_s']} req/s "
        f"({row['offered_samples_per_s']} samples/s) for {row['window_s']} s: "
        f"{row['done']}/{row['requests']} done, {row['rejected']} rejected at "
        f"admission, {row['samples_per_s']} samples/s, "
        f"{row['batches']} batches, latency ms p50 {lat['p50']} p95 {lat['p95']} "
        f"p99 {lat['p99']}, pad waste {row['pad_waste']}; a batch every "
        f"{row['batch_period_ms_mean']} ms (mean; of it asleep "
        f"{row['sleep_ms_per_batch_mean']} ms); launches {row['launches']}, exactly "
        f"the batches' eager counts (host clock)")


def _host_loop_split(tracer, eng, row) -> dict:
    """The traced window's host loop: per request the medians of the
    timeline segments, per batch the medians (and means) of the
    serve.pack / serve.dispatch / serve.slice span walls, of the batch
    period (one serve.pack start to the next) and of the rest of it."""
    import numpy as np

    spans = {n: [s for s in tracer.spans if s["name"] == n]
             for n in ("serve.pack", "serve.dispatch", "serve.slice")}
    n = len(spans["serve.pack"])
    if not n == len(spans["serve.dispatch"]) == len(spans["serve.slice"]) \
            == row["batches"]:
        raise AssertionError(f"obs: spans {[len(v) for v in spans.values()]} for "
                             f"{row['batches']} batches")
    walls = {k: np.array([s["dur"] for s in v]) * 1e3 for k, v in spans.items()}
    starts = np.array([s["ts"] for s in spans["serve.pack"]])
    period = np.diff(starts) * 1e3
    rest = period - sum(w[:-1] for w in walls.values())
    segments = [tl.segments() for tl in eng.timeline.timelines()
                if tl.terminal_event == "reply"]
    out = {"per_request_ms_median": {
        k: float(np.median([s[k] for s in segments])) * 1e3
        for k in ("queue_s", "dispatch_s", "execute_s", "total_s")}}
    out["per_batch_ms_median"] = {k.split(".")[1]: float(np.median(w))
                                  for k, w in walls.items()}
    out["per_batch_ms_median"].update(period=float(np.median(period)),
                                      rest=float(np.median(rest)))
    out["per_batch_ms_mean"] = {k.split(".")[1]: float(w.mean())
                                for k, w in walls.items()}
    out["per_batch_ms_mean"].update(period=float(period.mean()),
                                    rest=float(rest.mean()),
                                    asleep=row["sleep_ms_per_batch_mean"])
    return out


def _bitwise_unbatched(torch, params, cfg, reqs, tag) -> None:
    from repro_torch.models import gan

    for r in reqs:
        one = gan.generator_apply(params, cfg, r.z).cpu()
        if not torch.equal(one, r.output):
            raise AssertionError(f"{tag}: request {r.rid} (n={r.n}) differs from its "
                                 f"unbatched call by {(one - r.output).abs().max().item()}")


def phase_obs(torch, dev, per_bucket, train) -> dict:
    """Observability and replicas: the engine's 2000 req/s window with the
    tracer off and on (the host loop's split), a clean two-replica
    supervised window, a chaos run with flight dumps and the inline
    fallback, and six traced training steps with their fault dumps."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.data import SyntheticImages
    from repro_torch.models import gan
    from repro_torch.obs import trace as obs
    from repro_torch.obs.export import (
        metric_name,
        parse_prometheus_text,
        prometheus_text,
        validate_chrome_trace,
        write_chrome_trace,
    )
    from repro_torch.obs.flight_recorder import FlightRecorder
    from repro_torch.obs.timeline import TimelineStore
    from repro_torch.serve import BucketPolicy, GenRequest, Replica, ReplicaSupervisor
    from repro_torch.serve.fault_injection import ServeFaultInjector, ServeFaultPlan
    from repro_torch.train.fault_injection import (
        FaultInjector,
        FaultPlan,
        NaNInjectionData,
        SimulatedCrash,
    )
    from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    card = f"{torch.cuda.get_device_name(0)} ({dev['nvidia_smi']})"
    out_dir = os.path.join(ROOT, "chiprun_out")   # absent from a fresh checkout
    flight_dir = os.path.join(out_dir, "flight")
    shutil.rmtree(flight_dir, ignore_errors=True)
    os.makedirs(out_dir, exist_ok=True)
    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    rate = OBS_RATE
    out = {"card": card}

    def isolated_tracer():
        tracer = obs.Tracer()
        obs.set_tracer(tracer)
        obs.enable()
        return tracer

    # 1. the engine's window, tracer off and on in turns (the loop runs near
    # its capacity at this rate, so one pair alone would read run-to-run
    # swings); the first traced window is split and exported
    windows = []
    for traced in (False, True, True, False):
        eng = _warm_engine(cfg, params)
        eng.timeline = TimelineStore(capacity=int(rate * SERVE_WINDOW_S) + 16)
        tracer = isolated_tracer() if traced else None
        try:
            row = _obs_window(torch, eng, cfg, rate, per_bucket,
                              "engine traced" if traced else "engine untraced")
        finally:
            obs.disable()
        reqs = row.pop("reqs")
        _log_window(card, row)
        if traced and "split" not in out:
            if len(eng.timeline) != len(reqs) or eng.timeline.incomplete():
                raise AssertionError(f"obs: {len(eng.timeline)} timelines for "
                                     f"{len(reqs)} requests, "
                                     f"{len(eng.timeline.incomplete())} incomplete")
            rec = eng.timeline.reconcile(eng.conservation())
            if not rec["ok"]:
                raise AssertionError(f"obs: timelines do not reconcile: {rec}")
            row["split"] = out["split"] = _host_loop_split(tracer, eng, row)
            path = os.path.join(out_dir, "obs_trace.json")
            write_chrome_trace(tracer, path, timeline=eng.timeline)
            with open(path) as f:
                problems = validate_chrome_trace(json.load(f))
            if problems:
                raise AssertionError(f"obs: the Chrome trace is malformed: {problems[:5]}")
            eng.metrics.publish(tracer)
            parsed = parse_prometheus_text(prometheus_text(tracer))["metrics"]
            for name, value in {**tracer.counters, **tracer.gauges}.items():
                if parsed[metric_name(name)] != value:
                    raise AssertionError(f"obs: {name} {value} read back as "
                                         f"{parsed[metric_name(name)]}")
            for name, series in tracer.observations.items():
                if parsed[metric_name(name) + "_count"] != len(series):
                    raise AssertionError(f"obs: {name} count read back wrong")
            row.update(trace_path=os.path.relpath(path, ROOT),
                       trace_bytes=os.path.getsize(path),
                       spans=tracer.span_names(), counters=dict(tracer.counters),
                       prometheus_metrics=len(parsed))
            split = row["split"]
            log(f"[obs] host loop at {rate} req/s on {card}, per request (median of "
                f"{row['done']} served requests' timelines): queue_s {split['per_request_ms_median']['queue_s']}"
                f" ms, dispatch_s {split['per_request_ms_median']['dispatch_s']} ms, "
                f"execute_s {split['per_request_ms_median']['execute_s']} ms, total "
                f"{split['per_request_ms_median']['total_s']} ms")
            log(f"[obs] host loop on {card}, per batch (ms) median "
                f"{split['per_batch_ms_median']}; mean {split['per_batch_ms_mean']} "
                f"(rest = period - pack - dispatch - slice; asleep: the replay's "
                f"sleeps; host clock)")
            log(f"[obs] Chrome trace {row['trace_path']} ({row['trace_bytes']} B) "
                f"valid; spans {row['spans']}; Prometheus text of "
                f"{row['prometheus_metrics']} samples round-trips; timelines "
                f"complete and reconcile with conservation()")
        row["traced"] = traced
        windows.append(row)
        del eng, reqs
    out["engine"] = windows

    # 2. a clean supervised window: two replicas on the card
    replicas = [Replica(f"r{i}") for i in range(2)]
    sup = ReplicaSupervisor(replicas, BucketPolicy(buckets=(1, 2, 4, 8),
                                                   max_wait_s=0.002, max_queue=256))
    sup.register(cfg, params)
    sup.warmup()
    warm = dict(sup.replica_recompiles)
    row = _obs_window(torch, sup, cfg, rate, per_bucket, "supervisor (2 replicas)")
    reqs = row.pop("reqs")
    _log_window(card, row)
    m = sup.metrics
    dispatches = {r.replica_id: r.dispatches for r in replicas}
    if m.retries or m.timeouts or m.requeues or m.nonfinite or m.recompiles:
        raise AssertionError(f"supervisor: a clean window retried, timed out or "
                             f"built: {m.summary()}")
    if sup.replica_recompiles != warm or warm != {"r0": 4, "r1": 4}:
        raise AssertionError(f"supervisor: recompiles {warm} -> "
                             f"{sup.replica_recompiles}")
    if abs(dispatches["r0"] - dispatches["r1"]) > 1 \
            or sum(dispatches.values()) != m.batches:
        raise AssertionError(f"supervisor: dispatches {dispatches} for {m.batches} "
                             f"batches")
    served = [r for r in reqs if r.done]
    checked = served[:: max(1, len(served) // 64)][:64]
    _bitwise_unbatched(torch, params, cfg, checked, "supervisor")
    row.update(dispatches=dispatches, timeouts_s={
        str(b): sup.timeout_for(cfg.name, b) for b in sup.policy.buckets},
        baselines_ms={f"{rid}:{b}": s.replica.baseline_s[(cfg.name, b)] * 1e3
                      for rid, s in sup.rslots.items() for b in sup.policy.buckets})
    log(f"[obs] supervisor on {card}: dispatches {dispatches}, 0 retries, 0 "
        f"timeouts, recompiles {sup.replica_recompiles} as after warm-up, "
        f"{len(checked)} served requests bitwise their unbatched calls; warm-up "
        f"synced call ms {row['baselines_ms']}, timeouts s {row['timeouts_s']}")
    log(f"[obs] at {rate} req/s on {card}, samples/s and p95 ms (rejected), in "
        f"turns: " + "; ".join(
            f"engine {'traced' if w['traced'] else 'untraced'} {w['samples_per_s']}, "
            f"{w['latency_ms']['p95']} ({w['rejected']})" for w in windows)
        + f"; supervisor {row['samples_per_s']}, {row['latency_ms']['p95']} "
        f"({row['rejected']})")
    out["supervisor"] = row
    del sup, replicas, reqs

    # 3. chaos: crash, NaN plane, transient error, a 60 ms hang, then the
    # second replica's crash leaves the inline fallback
    plan = ServeFaultPlan(crash_at=(("r0", 3), ("r1", 9)), nan_at=(("r1", 6),),
                          transient_at=(("r1", 2),), hang_at=(("r1", 4, 0.06),))
    inj = ServeFaultInjector(plan)   # the real clock: the hang sleeps
    recorder = FlightRecorder(dump_dir=flight_dir)
    replicas = [Replica(f"r{i}", dispatch_hook=inj.hook) for i in range(2)]
    sup = ReplicaSupervisor(replicas, BucketPolicy(buckets=(1, 2, 4, 8),
                                                   max_wait_s=0.0),
                            retry_budget=8, recorder=recorder)
    sup.register(cfg, params)
    sup.warmup()
    warm = dict(sup.replica_recompiles)
    tracer = isolated_tracer()
    rng = np.random.default_rng(5)
    reqs = []
    try:
        for i in range(32):
            r = GenRequest("dcgan", rng.standard_normal(
                (int(rng.integers(1, 5)), cfg.z_dim)).astype(np.float32))
            reqs.append(r)
            sup.serve([r])
    finally:
        obs.disable()
    fired = [f[0] for f in inj.fired]
    if sorted(set(fired)) != ["crash", "hang", "nan", "transient"]:
        raise AssertionError(f"chaos: fired {inj.fired}")
    if not all(r.done for r in reqs) or not sup.conservation()["ok"]:
        raise AssertionError(f"chaos: {sup.conservation()}")
    if not all(bool(torch.isfinite(r.output).all()) for r in reqs):
        raise AssertionError("chaos: a non-finite output was served")
    _bitwise_unbatched(torch, params, cfg, reqs, "chaos")
    inline = [r for r in reqs if r.replica == "inline"]
    inline_buckets = {sup.policy.bucket_for(r.n) for r in inline}
    if (sup.replica_states() != {"r0": "DEAD", "r1": "DEAD"} or not inline
            or sup.metrics.recompiles != len(inline_buckets)
            or len(sup.registry[cfg.name].apply) != len(inline_buckets)
            or sup.replica_recompiles != warm):
        raise AssertionError(
            f"chaos: states {sup.replica_states()}, {len(inline)} inline requests in "
            f"buckets {inline_buckets}, recompiles {sup.metrics.recompiles}, "
            f"replicas {sup.replica_recompiles}")
    dumps = {}
    for path in recorder.dumps:
        blob = FlightRecorder.load(path)
        dumps[os.path.relpath(path, ROOT)] = {"trigger": blob["trigger"],
                                              "events": blob["n_events"]}
    triggers = {d["trigger"] for d in dumps.values()}
    if not {"replica_dead:r0", "replica_dead:r1", "nonfinite:r1"} <= triggers:
        raise AssertionError(f"chaos: dumps {dumps}")
    m = sup.metrics
    out["chaos"] = {"fired": inj.fired, "dumps": dumps,
                    "transitions": list(m.transitions),
                    "summary": {k: v for k, v in m.summary().items() if k != "per_model"},
                    "inline_requests": len(inline), "inline_buckets": sorted(inline_buckets),
                    "spans": tracer.span_names(),
                    "events": len(tracer.instants)}
    log(f"[obs] chaos on {card}: fired {inj.fired}; {len(reqs)} requests served "
        f"bitwise their unbatched calls, none non-finite, conservation ok; retries "
        f"{m.retries}, requeues {m.requeues}, timeouts {m.timeouts}, non-finite "
        f"{m.nonfinite}, probes {m.probes} ({m.probe_failures} failed); transitions "
        f"{m.transition_counts}; {len(inline)} requests inline after both replicas "
        f"died, recompiles {m.recompiles} (its captures, buckets "
        f"{sorted(inline_buckets)}), replicas {sup.replica_recompiles} as after "
        f"warm-up; spans {tracer.span_names()}")
    log(f"[obs] chaos flight dumps (loaded): {dumps}")
    del sup, replicas, reqs

    # 4. the trainer: six traced graphed steps, then its NaN and crash dumps
    tcfg = GanTrainerConfig(ckpt_every=3)
    data = SyntheticImages(cfg.out_hw(cfg.layers[-1][0]), cfg.layers[-1][2],
                           tcfg.global_batch)
    recorder = FlightRecorder(dump_dir=flight_dir)
    quiet = lambda *a: None  # noqa: E731

    def trainer(ckpt_dir=None, d=data, hooks=None):
        tr = GanTrainer(cfg, tcfg, d, ckpt_dir=ckpt_dir, log_fn=quiet, hooks=hooks,
                        recorder=recorder)
        return tr, tr.init_state(torch.Generator().manual_seed(0))

    eager_step = train["eager_step_launches"]
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        tr, state = trainer(d1)
        tracer = isolated_tracer()
        _reset_counts()
        try:
            full, hist = tr.run(state, steps=6)
        finally:
            obs.disable()
        launches = _read_counts()
        # the capture's eager warm-up at the first step, then six replays
        want = {k: 7 * v for k, v in eager_step.items()}
        names = tracer.span_names()
        if (names.get("train.step") != 6 or names.get("train.batch") != 6
                or names.get("train.step_fn") != 6
                or len(tracer.observations.get("train.step_s", ())) != 6
                or tracer.counters.get("train.steps") != 6.0):
            raise AssertionError(f"train: spans {names}, observations "
                                 f"{ {k: len(v) for k, v in tracer.observations.items()} }")
        if launches != want or min(launches[n] for n in TRAINING) < 1:
            raise AssertionError(f"train: 6 traced steps counted {launches}, a warm-up "
                                 f"and 6 eager steps {want}")
        if any(h["skipped"] for h in hist):
            raise AssertionError(f"train: a traced step was skipped: {hist}")
        walls = {k: [s["dur"] * 1e3 for s in tracer.spans if s["name"] == k]
                 for k in ("train.step", "train.batch", "train.step_fn")}
        out["train"] = {"spans": names, "launches": launches,
                        "span_ms": walls,
                        "step_s": list(tracer.observations["train.step_s"])}
        log(f"[obs] train on {card}: 6 traced graphed steps, spans {names}, "
            f"train.step_s observed {len(tracer.observations['train.step_s'])}x; "
            f"launches {launches}, exactly the capture's warm-up and 6 eager steps'; "
            f"span ms (host clock) step {walls['train.step']}, batch "
            f"{walls['train.batch']}, step_fn {walls['train.step_fn']}")

        tr_nan, state = trainer(d=NaNInjectionData(data, (0,)))
        before = tree_map(torch.clone, state)
        n_dumps = len(recorder.dumps)
        after, hist_nan = tr_nan.run(state, steps=1)
        if (hist_nan[0]["skipped"] != 1 or not _bitwise(before, after)
                or len(recorder.dumps) != n_dumps + 1
                or FlightRecorder.load(recorder.dumps[-1])["trigger"] != "nan_guard"):
            raise AssertionError("train: the NaN step changed the state or did not "
                                 "dump nan_guard")
        inj = FaultInjector(FaultPlan(kill_at_step=4))
        tr_crash, state = trainer(d2, hooks=inj)
        try:
            tr_crash.run(state, steps=6)
        except SimulatedCrash:
            pass
        else:
            raise AssertionError("train: the injected kill did not fire")
        crash_dump = FlightRecorder.load(recorder.dumps[-1])
        if crash_dump["trigger"] != "crash:SimulatedCrash" \
                or crash_dump["extra"]["step"] != 4:
            raise AssertionError(f"train: crash dump {crash_dump['trigger']}")
        tr_res, state = trainer(d2)
        resumed, hist_res = tr_res.run(state, steps=6)
        if tr_res.resumed_step != 3 or hist_res != hist[3:] \
                or not _bitwise(resumed, full):
            raise AssertionError(f"train: the resume after the kill is not bitwise "
                                 f"the clean run: {hist_res} vs {hist[3:]}")
    out["train"]["dumps"] = [os.path.relpath(p, ROOT) for p in recorder.dumps]
    log(f"[obs] train on {card}: a NaN step dumped nan_guard and left the state "
        f"bitwise untouched; a kill at step 4 dumped crash:SimulatedCrash and the "
        f"run resumed from step 3 bitwise equal to the clean one (losses, params, "
        f"moments); dumps {out['train']['dumps']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[obs] phase 21 took {out['seconds']:.1f} s")
    return out



def _tune_pairs(autotune, planlib, cfg, batch, repeats) -> int:
    """Race every pair the plan pass would fuse in ``cfg`` at ``batch``
    (``fuse="force"``'s pairs); returns the number of races."""
    from repro_torch.models import gan

    plan = planlib.compile_plan(cfg, batch, epilogues=gan.generator_epilogues(cfg),
                                fuse="force")
    races = 0
    for e in plan.entries:
        if isinstance(e, planlib.FusedPairPlan):
            a, z = e.first, e.second
            autotune.tune_pair(batch, a.n_in, a.n_k, a.cin, a.cout, z.cout, a.padding,
                               epilogue1=a.epilogue, epilogue2=z.epilogue,
                               repeats=repeats)
            races += 1
    return races


def _use_cache(autotune, path) -> None:
    """Point the autotuner at the cache file ``path`` and drop the view."""
    os.environ["REPRO_AUTOTUNE_CACHE"] = path
    autotune.clear_cache(memory_only=True)


def _train_step_ms(tr, state, steps) -> list:
    """Host milliseconds of ``steps`` graphed trainer steps after
    TRAIN_WARMUP_STEPS, each ending in the read-back of its losses."""
    import numpy as np

    tr.run(state, steps=TRAIN_WARMUP_STEPS + steps)
    return (np.asarray(tr.timer.steps[TRAIN_WARMUP_STEPS:]) * 1e3).tolist()


def phase_autotune(torch, dev, cold_cache) -> dict:
    """The autotuner's races on the card into a hermetic cache
    (chiprun_out/autotune.json, its audit trail beside it), then the tuned
    plans under the port's gates: served samples bitwise their unbatched
    calls, graphs bitwise their eager calls (serving and training), a
    reload giving the same plans, one audit record per race. Tuned against
    cold serving windows and training steps are recorded, not gated."""
    import numpy as np

    from repro_torch.data import SyntheticImages
    from repro_torch.kernels import autotune
    from repro_torch.kernels import plan as planlib
    from repro_torch.models import gan
    from repro_torch.obs.audit import AuditTrail, audit_path, set_trail
    from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig

    t_phase = time.perf_counter()
    card = f"{torch.cuda.get_device_name(0)} ({dev['nvidia_smi']})"
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "autotune.json")
    _use_cache(autotune, path)
    for stale in (path, audit_path()):
        if os.path.exists(stale):
            os.remove(stale)
    trail = AuditTrail(path="auto")   # the ring, and the JSONL beside the cache
    prev_trail = set_trail(trail)
    # the races time what serving runs: phases 3-19's settings
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    cfg = gan.DCGAN
    buckets = (1, 2, 4, BATCH)
    repeats = 3
    races = 0
    try:
        # layers first at every batch, then the pairs, so that each
        # back-to-back candidate runs its layers' final serving choice
        t0 = time.perf_counter()
        for records in (
                autotune.tune_gan_zoo(batches=(1, 2, 4), configs=(cfg,), pairs=False,
                                      repeats=repeats),
                autotune.tune_gan_zoo(batches=(BATCH,), configs=(cfg,), train=True,
                                      pairs=False, repeats=repeats)):
            races += sum(len(rec) for rec in records.values())   # a race a direction
        for b in buckets:
            races += _tune_pairs(autotune, planlib, cfg, b, repeats)
        race_s = time.perf_counter() - t0
        out = {"cache": os.path.relpath(path, ROOT), "races": races,
               "race_s": race_s, "records": []}
        for rec in trail.records:
            cands = {c["method"]: c["time_s"] * 1e6 for c in rec["candidates"]}
            entry = autotune.lookup(rec["key"])[rec["direction"]]
            variant = entry.get("batch_variant", [])
            out["records"].append({"key": rec["key"], "direction": rec["direction"],
                                   "winner": rec["winner"], "source": rec["source"],
                                   "graph_us": cands, "margin": rec["margin"],
                                   "batch_variant": variant})
            log(f"[autotune] {rec['key']} {rec['direction']}: winner {rec['winner']} "
                f"({rec['source']}), margin {rec['margin']}, graph us "
                + ", ".join(f"{m} {t:.1f}" for m, t in cands.items())
                + (f"; batch-variant {variant}" if variant else ""))
        log(f"[autotune] {races} races in {race_s:.1f} s on {card} (CUDA-graph replay "
            f"of {autotune.GRAPH_CALLS} calls, median of {repeats})")
        variant_any = sorted({(r["key"], m) for r in out["records"]
                              for m in r["batch_variant"]})
        log(f"[autotune] candidates that failed the batch-invariance check: "
            f"{variant_any or 'none'}")
        out["batch_variant"] = [list(v) for v in variant_any]

        # the serving choice of each layer shape, one for every bucket: first
        # with no bucket histogram (the sum, held by the cold rule at bucket
        # 8), then weighted by the histogram of a cold-plan window
        def serving_choices(stage):
            out["serving"][stage] = {}
            for (hw, cin, cout), epi in zip(cfg.layers, gan.generator_epilogues(cfg)):
                choice = autotune.best_method(1, hw, cfg.kernel, cin, cout,
                                              cfg.padding, epilogue=epi)
                out["serving"][stage][f"{hw}x{hw}x{cin}->{cout}"] = choice
                log(f"[autotune] serving choice ({stage}) {hw}x{hw}x{cin}->{cout} "
                    f"{epi.tag()}: {choice['method']} by rule {choice['rule']} over "
                    f"batches {choice['batches']}"
                    + (f" weighted {choice['weights']}, graph us of that traffic "
                       if "weights" in choice else ", graph us summed ")
                    + ", ".join(
                        f"{m} {t * 1e6:.1f}" for m, t in
                        sorted(choice["candidates"].items(), key=lambda kv: kv[1])))

        out["serving"] = {}
        serving_choices("no histogram")
        params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
        _use_cache(autotune, cold_cache)
        cold_eng = _warm_engine(cfg, params, fuse="auto")
        cold_counts = _graphs_against_eager(torch, cold_eng, cfg, params,
                                            "autotune cold")
        windows = [_obs_window(torch, cold_eng, cfg, OBS_RATE, cold_counts,
                               "autotune cold")]
        _log_window(card, windows[0])
        hist = windows[0]["bucket_batches"]
        _use_cache(autotune, path)
        autotune.record_traffic(hist)
        out["traffic"] = autotune.traffic()
        log(f"[autotune] bucket histogram of the first cold window {hist}, recorded "
            f"as the cache's traffic")
        serving_choices("traffic")
        plans = {}
        for fuse in ("auto", "off"):
            for b in buckets:
                plan = gan.generator_plan(cfg, b, fuse=fuse)
                plans[f"{fuse}:{b}"] = plan
                log(f"[autotune] tuned plan fuse={fuse} b{b}:\n[autotune]   "
                    + plan.describe().replace("\n", "\n[autotune]   "))
        plans["train:8"] = gan.generator_plan(cfg, BATCH, train=True)
        log("[autotune] tuned training plan:\n[autotune]   "
            + plans["train:8"].describe().replace("\n", "\n[autotune]   "))
        out["plans"] = {k: p.describe() for k, p in plans.items()}
        if len({tuple(lp.method for lp in plans[f"auto:{b}"]) for b in buckets}) != 1:
            raise AssertionError("autotune: the serving plans' methods differ by bucket")

        # gate: a reload from the file gives the same plans
        autotune.clear_cache(memory_only=True)
        for key, plan in plans.items():
            fuse, b = key.split(":")
            again = (gan.generator_plan(cfg, int(b), train=True) if fuse == "train"
                     else gan.generator_plan(cfg, int(b), fuse=fuse))
            if again != plan or again.describe() != plan.describe():
                raise AssertionError(f"autotune: the reloaded cache gives another "
                                     f"plan for {key}")
        log("[autotune] after clear_cache(memory_only=True) the reloaded file gives "
            "the same plans")

        # gate: one audit record per race, in the ring and beside the cache
        jsonl = AuditTrail.load(audit_path())
        if len(trail.records) != races or len(jsonl) != races:
            raise AssertionError(f"autotune: {races} races, {len(trail.records)} audit "
                                 f"records, {len(jsonl)} in {audit_path()}")
        log(f"[autotune] one audit record per race: {races} in "
            f"{os.path.relpath(audit_path(), ROOT)}")

        # gates: the tuned engine (fuse="auto") serves bitwise
        eng = _warm_engine(cfg, params, fuse="auto")
        per_bucket = _graphs_against_eager(torch, eng, cfg, params, "autotune")
        reqs, arrivals = _dcgan_requests(cfg)
        launches = _replay_counted(eng, reqs, arrivals, per_bucket, "autotune")
        if not all(r.done for r in reqs) or not eng.conservation()["ok"]:
            raise AssertionError("autotune: a request was not served")
        for r in reqs:
            one = gan.generator_apply(params, cfg, r.z,
                                      plan=gan.generator_plan(cfg, r.n)).cpu()
            if not torch.equal(one, r.output):
                raise AssertionError(
                    f"autotune: request {r.rid} (n={r.n}) differs from its unbatched "
                    f"call by {(one - r.output).abs().max().item()}")
        out["engine_launches"] = launches
        log(f"[autotune] GanEngine(fuse='auto') on the tuned cache: 32 requests over "
            f"buckets {buckets}, each bitwise its unbatched call under the same "
            f"cache; launches {launches}, exactly the batches' eager counts")

        # recorded: 2000 req/s windows, cold and tuned in turns (C T T C C T),
        # each engine warmed once and its metrics reset before each window
        engines = {"cold": (cold_eng, cold_counts), "tuned": (eng, per_bucket)}
        for kind in ("tuned", "tuned", "cold", "cold", "tuned"):
            e, counts = engines[kind]
            e.metrics.reset()
            windows.append(_obs_window(torch, e, cfg, OBS_RATE, counts,
                                       f"autotune {kind}"))
            _log_window(card, windows[-1])
        for row in windows:
            row.pop("reqs")
        out["windows"] = windows
        for kind in ("cold", "tuned"):
            sps = [r["samples_per_s"] for r in windows if r["tag"].endswith(kind)]
            log(f"[autotune] {kind} windows in turn order: samples/s {sps}, median "
                f"{float(np.median(sps))}")

        # gates and records: training on the tuned cache, then cold
        torch.use_deterministic_algorithms(True)
        tcfg = GanTrainerConfig()
        data = SyntheticImages(cfg.out_hw(cfg.layers[-1][0]), cfg.layers[-1][2],
                               tcfg.global_batch)
        out["train_step_ms"] = {}
        for kind in ("tuned", "cold"):
            _use_cache(autotune, path if kind == "tuned" else cold_cache)
            tr = GanTrainer(cfg, tcfg, data, log_fn=lambda *a: None)
            state = tr.init_state(torch.Generator().manual_seed(0))
            if kind == "tuned":
                eager_state = graph_state = state
                for step in range(3):
                    reals, zs = tr._batches(step)
                    eager_state, stats = tr._step_eager(eager_state, reals, zs)
                    graph_state, metrics = tr._step_fn(graph_state, reals, zs)
                    if ([metrics[k] for k in ("g_loss", "d_loss", "g_gnorm", "d_gnorm")]
                            != stats.tolist() or not _bitwise(graph_state, eager_state)):
                        raise AssertionError(f"autotune: tuned graphed step {step} is "
                                             f"not bitwise the eager step")
                log("[autotune] 3 tuned training steps through the graph bitwise equal "
                    "to 3 eager ones; plan:\n[autotune]   "
                    + tr.train_plan.describe().replace("\n", "\n[autotune]   "))
                out["train_plan"] = tr.train_plan.describe()
            walls = _train_step_ms(tr, state, 20)
            out["train_step_ms"][kind] = {"median": float(np.median(walls)),
                                          "p90": float(np.percentile(walls, 90)),
                                          "steps": walls}
            log(f"[autotune] {kind} training step: median "
                f"{np.median(walls):.3f} ms, p90 {np.percentile(walls, 90):.3f} ms over "
                f"20 graphed steps after {TRAIN_WARMUP_STEPS} (host clock)")
    finally:
        set_trail(prev_trail)
        _use_cache(autotune, cold_cache)
        torch.use_deterministic_algorithms(deterministic)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[autotune] phase 22 took {out['seconds']:.1f} s")
    return out


def _kernel_kinds(prof) -> dict:
    """Device microseconds of a profile by kind of kernel (from its name):
    fp32 GEMMs (cuBLAS SIMT and FFMA tiles), bf16 GEMMs, elementwise,
    reductions, indexing and sorting, and the rest."""
    kinds = {"gemm_fp32": 0.0, "gemm_bf16": 0.0, "elementwise": 0.0,
             "reduce": 0.0, "index_sort": 0.0, "other": 0.0}
    for name, us in _kernel_times(prof).items():
        low = name.lower()
        if "gemm" in low and ("f32f32" in low or "sgemm" in low):
            kind = "gemm_fp32"
        elif "gemm" in low or "nvjet" in low:
            kind = "gemm_bf16"
        elif "elementwise" in low:
            kind = "elementwise"
        elif "reduce" in low or "softmax" in low:
            kind = "reduce"
        elif any(k in low for k in ("index", "scatter", "gather", "sort", "radix")):
            kind = "index_sort"
        else:
            kind = "other"
        kinds[kind] += us
    return kinds


def phase_lm_train(torch) -> dict:
    """Full-width Qwen2-0.5B trained through the LM Trainer, each step one
    CUDA graph (checks, then timings)."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import roofline
    from repro_torch.models.lm import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(LM_TRAIN_ARCH)
    model = build_model(cfg)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=2, total_steps=30)
    data = SyntheticTokens(cfg.vocab_size, LM_TRAIN_SEQ, LM_TRAIN_BATCH)
    tokens = LM_TRAIN_SEQ * LM_TRAIN_BATCH
    quiet = lambda *a: None  # noqa: E731
    out = {"arch": cfg.name, "params": cfg.param_count(), "seq": LM_TRAIN_SEQ,
           "batch": LM_TRAIN_BATCH, "dtype": cfg.dtype, "remat": cfg.remat,
           "optimizer": "AdamW, fp32 moments, lr 1e-3, warmup 2, cosine to 30",
           "reduced": f"global batch {LM_TRAIN_BATCH} of train_4k's 256"}
    log(f"[lm-train] {cfg.name}: {out['params'] / 1e6:.1f} M params, {cfg.dtype}, "
        f"{cfg.n_layers} layers, V {cfg.vocab_size}, seq {LM_TRAIN_SEQ}, batch "
        f"{LM_TRAIN_BATCH}, remat {cfg.remat}")

    def fresh():
        return init_train_state(model, torch.Generator(device="cuda").manual_seed(0), tc)

    torch.cuda.reset_peak_memory_stats()
    state = fresh()
    out["state_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(list(state)))
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        tr = Trainer(model, make_train_step(model, tc), data, ckpt_dir=d1, ckpt_every=3,
                     log_fn=quiet)
        eager, eager_ms = [], []
        e = state
        for i in range(3):   # the eager steps first, kept for the comparison
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, o, m = tr.step_eager(*e, data.batch(i))
            vals = dict(zip(m, torch.stack(list(m.values())).tolist()))
            eager_ms.append((time.perf_counter() - t0) * 1e3)
            e = (p, o)
            eager.append((p, o, vals))
        first = eager[0][2]["loss"]
        if not (np.isfinite(first) and abs(first - np.log(cfg.vocab_size)) < 1.0):
            raise AssertionError(f"lm-train: first loss {first} is not within 1 nat of "
                                 f"ln V = {np.log(cfg.vocab_size):.3f}")
        g = state
        for i in range(3):
            p, o, vals = tr._step_fn(*g, data.batch(i))
            g = (p, o)
            ep, eo, evals = eager[i]
            if vals != evals or not _bitwise(p, ep) or not _bitwise(o, eo):
                raise AssertionError(f"lm-train: graphed step {i} is not bitwise the "
                                     f"eager step: {vals} vs {evals}")
        log(f"[lm-train] first loss {first:.4f} (ln V {np.log(cfg.vocab_size):.4f}); 3 "
            f"graphed steps bitwise equal to 3 eager steps (metrics, params, moments); "
            f"eager step ms {[round(x, 1) for x in eager_ms]}")
        del eager, e, g, p, o, ep, eo
        gc.collect()
        torch.cuda.empty_cache()

        torch.cuda.synchronize()
        _reset_counts()
        full_p, full_o, hist = tr.run(*state, steps=6)   # the fresh state, copied in
        torch.cuda.synchronize()
        launches = _read_counts()
        if len(hist) != 6 or not all(np.isfinite(hist)) or tr.skipped_steps:
            raise AssertionError(f"lm-train: 6 steps gave {hist}, skipped "
                                 f"{tr.skipped_steps}")
        if any(launches.values()):
            raise AssertionError(f"lm-train: the LM step launched a port kernel: "
                                 f"{launches}")
        log(f"[lm-train] 6 graphed steps through Trainer.run, checkpoints at 3 and 6: "
            f"losses {hist}; hand-written kernel launches {sum(launches.values())}")
        shutil.copy(os.path.join(d1, "step_00000003.npz"), d2)
        del state
        tr2 = Trainer(model, make_train_step(model, tc), data, ckpt_dir=d2,
                      ckpt_every=3, log_fn=quiet)
        res_p, res_o, hist2 = tr2.run(*fresh(), steps=6)
        if tr2.resumed_step != 3 or hist2 != hist[3:] or not (
                _bitwise(res_p, full_p) and _bitwise(res_o, full_o)):
            raise AssertionError(f"lm-train: resume from step 3 is not bitwise the "
                                 f"uninterrupted run: {hist2} vs {hist[3:]}")
        log("[lm-train] killed after step 3's checkpoint and resumed: losses, params and "
            "moments bitwise equal to the uninterrupted run")
        del tr2, res_p, res_o
        gc.collect()
        torch.cuda.empty_cache()

    tr.ckpt_dir = None   # the timed window, continuing the run
    p, o, hist3 = tr.run(full_p, full_o, steps=6 + LM_TRAIN_TIMED, start_step=6)
    walls = np.asarray(tr.timer.steps) * 1e3
    losses = hist + hist3
    if not losses[-1] < losses[0] - LM_LOSS_DROP:
        raise AssertionError(f"lm-train: the loss fell less than {LM_LOSS_DROP} over "
                             f"{len(losses)} steps: {losses}")
    median_s = float(np.median(walls)) / 1e3
    flops = (6 * out["params"] * tokens
             + 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * LM_TRAIN_SEQ * tokens)
    out.update({
        "first_loss": first, "ln_vocab": float(np.log(cfg.vocab_size)),
        "losses": losses, "graph_bitwise_eager": True, "resume_bitwise": True,
        "launches_6_steps": launches,
        "eager_step_ms": eager_ms, "eager_step_ms_median": float(np.median(eager_ms)),
        "graph_step_ms": walls.tolist(), "graph_step_ms_median": median_s * 1e3,
        "graph_step_ms_p90": float(np.percentile(walls, 90)),
        "tokens_per_s": tokens / median_s,
        "model_flops_per_step": flops,
        "model_flops_formula": "6*N*T + 12*L*H*hd*S*T (N params with the tied head "
                               "once, T = B*S tokens, full S x S attention)",
        "bf16_peak_share": flops / median_s / roofline.PEAK_BF16_FLOPS,
    })
    log(f"[lm-train] {LM_TRAIN_TIMED} graphed steps (host clock, each ending in the "
        f"metrics' read): median {median_s * 1e3:.1f} ms, p90 "
        f"{out['graph_step_ms_p90']:.1f} ms; eager median "
        f"{out['eager_step_ms_median']:.1f} ms; {out['tokens_per_s']:.1f} tokens/s; "
        f"model FLOPs {flops:.4g} a step ({out['model_flops_formula']}), "
        f"{out['bf16_peak_share']:.4f} of the bf16 dense peak")
    log(f"[lm-train] losses over {len(losses)} steps: {[round(x, 4) for x in losses]}")

    batch = data.batch(6 + LM_TRAIN_TIMED)

    def profiled():
        nonlocal p, o
        p, o, _ = tr._step_fn(p, o, batch)

    out["profile"] = _profile_step(torch, profiled, top=15)
    _log_profile("lm-train graph", out["profile"])
    # the idle share against the profiled step's own wall: under the
    # profiler the kernels run a little slower, so their sum can pass the
    # unprofiled median, and that ratio is kept beside it
    out["idle_share"] = out["profile"]["idle_share"]
    out["device_over_median_wall"] = out["profile"]["device_us"] / (median_s * 1e6)
    log(f"[lm-train] a profiled step: device time {out['profile']['device_us']:.1f} us "
        f"in {out['profile']['wall_us']:.1f} us: idle share {out['idle_share']:.4f}; "
        f"device time / unprofiled median step {out['device_over_median_wall']:.4f}")

    # a NaN-poisoned step: one embedding row of a token in the batch
    poison = data.batch(6 + LM_TRAIN_TIMED + 2)
    with torch.no_grad():
        p["embed"]["w"][poison["tokens"][0, 0]] = float("nan")
    before = tree_map(torch.clone, [p, o])
    p, o, hist4 = tr.run(p, o, steps=6 + LM_TRAIN_TIMED + 3,
                         start_step=6 + LM_TRAIN_TIMED + 2)
    if hist4 or tr.skipped_steps != 1 or not _bitwise(before, [p, o]):
        raise AssertionError("lm-train: a NaN step changed the state or was not skipped")
    log("[lm-train] NaN-poisoned step skipped, params and moments bitwise untouched, "
        "skipped_steps 1")
    out["nan_step_skipped"] = True
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[lm-train] peak device memory {out['peak_memory_bytes'] / 2**30:.2f} GiB "
        f"(state {out['state_bytes'] / 2**30:.2f} GiB)")
    del tr, p, o, before
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _count_collectives(fn, *args, **kwargs):
    """``(fn(...), {"all_gather": n, "all_reduce": n})``: the collectives
    of :mod:`repro_torch.distributed.collectives` the call ran."""
    from repro_torch.distributed import collectives as col

    calls = {"all_gather": 0, "all_reduce": 0}
    orig = {name: getattr(col, name) for name in calls}

    def counting(name):
        def call(*a, **k):
            calls[name] += 1
            return orig[name](*a, **k)
        return call

    for name in calls:
        setattr(col, name, counting(name))
    try:
        return fn(*args, **kwargs), calls
    finally:
        for name in calls:
            setattr(col, name, orig[name])


def _graph_us(torch, graph, calls: int = DIST_TIMED_CALLS) -> float:
    """Device microseconds a replay of ``graph`` (a ``torch.cuda.CUDAGraph``):
    CUDA events around ``calls`` replays, after one untimed replay."""
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def _in_turns(torch, graphs: dict) -> dict:
    """Each graph's replay us, timed in turns (a b b a), and the median of
    its two."""
    import numpy as np

    names = list(graphs)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(_graph_us(torch, graphs[n]))
    return {n: {"us": t, "median_us": float(np.median(t))} for n, t in times.items()}


def _dist_generator(torch, mesh) -> dict:
    """Full-width DCGAN through shard_plan_apply on the host mesh, per layer
    and through fused pairs, at DIST_BUCKETS: bitwise the unsharded calls,
    the same launches, one all-gather a call."""
    from repro_torch.distributed.sharding import shard_plan_apply
    from repro_torch.models import gan

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator(device="cuda").manual_seed(21)

    def apply_fn(p, z, pl):
        return gan.generator_apply(p, cfg, z, plan=pl)

    out = {}
    for fuse in ("off", "force"):
        for bucket in DIST_BUCKETS:
            plan = gan.generator_plan(cfg, bucket, fuse=fuse)
            z = torch.randn((bucket, cfg.z_dim), device="cuda", generator=gen)
            want, counts = _count_delta(apply_fn, params, z, plan)
            (got, sharded), calls = _count_collectives(
                _count_delta, shard_plan_apply, apply_fn, params, z, plan, mesh=mesh)
            tag = f"fuse={fuse} bucket {bucket}"
            if not torch.equal(got, want):
                raise AssertionError(f"distribution: sharded generator ({tag}) differs "
                                     f"by {(got - want).abs().max().item()}")
            if sharded != counts or calls != {"all_gather": 1, "all_reduce": 0}:
                raise AssertionError(f"distribution: sharded generator ({tag}) launched "
                                     f"{sharded} with collectives {calls}, unsharded "
                                     f"{counts}")
            out[f"{fuse}_b{bucket}"] = {"launches": counts, "collectives": calls}
    log(f"[distribution] shard_plan_apply on the host mesh: full-width DCGAN per layer "
        f"and fused at buckets {DIST_BUCKETS} bitwise the unsharded calls, the same "
        f"launches, one all-gather a call: {out}")
    return out


def _dist_replica(torch, mesh, card) -> dict:
    """Replica(shard=True, mesh=...) beside an unsharded replica: each
    bucket's graph bitwise its eager sharded call and the unsharded graph,
    counting its launches; the bucket-8 graphs timed in turns."""
    from repro_torch.distributed.sharding import shard_plan_apply
    from repro_torch.models import gan
    from repro_torch.serve import Replica

    cfg = gan.DCGAN
    params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
    sharded, plain = (Replica("dp", fuse="off", shard=True, mesh=mesh),
                      Replica("plain", fuse="off"))
    for rep in (sharded, plain):
        rep.register(cfg, params)
        rep.warmup(DIST_BUCKETS)
    gen = torch.Generator(device="cuda").manual_seed(22)
    out = {}
    for bucket in DIST_BUCKETS:
        z = torch.randn((bucket, cfg.z_dim), device="cuda", generator=gen)
        plan = sharded.registry[cfg.name].plans[bucket]
        want, counts = _count_delta(
            shard_plan_apply, lambda p, zz, pl: gan.generator_apply(p, cfg, zz, plan=pl),
            params, z, plan, mesh=mesh)
        got, replayed = _count_delta(sharded._executable(cfg.name, bucket), params, z)
        got = got.clone()
        unsharded = plain._executable(cfg.name, bucket)(params, z).clone()
        served = sharded.execute(cfg.name, z, bucket)
        if not (torch.equal(got, want) and torch.equal(got, unsharded)
                and torch.equal(served, got.cpu())):
            raise AssertionError(f"distribution: the sharded replica's bucket {bucket} "
                                 f"graph is not bitwise its eager call and the "
                                 f"unsharded graph")
        if replayed != counts:
            raise AssertionError(f"distribution: the sharded replica's bucket {bucket} "
                                 f"replay counted {replayed}, its eager call {counts}")
        out[f"b{bucket}"] = {"launches": counts}
    if sharded.recompiles != len(DIST_BUCKETS):
        raise AssertionError(f"distribution: {sharded.recompiles} builds, want "
                             f"{len(DIST_BUCKETS)}")
    top = max(DIST_BUCKETS)
    out["graph_us"] = _in_turns(torch, {
        "unsharded": plain._executable(cfg.name, top).graph.graph,
        "host_mesh": sharded._executable(cfg.name, top).graph.graph})
    log(f"[distribution] Replica(shard=True) on the host mesh: each bucket's graph "
        f"bitwise its eager sharded call and the unsharded replica's, counting its "
        f"launches {[out[f'b{b}']['launches'] for b in DIST_BUCKETS]}; "
        f"{sharded.recompiles} builds")
    log(f"[distribution] bucket-{top} DCGAN call, one graph replay (CUDA events, "
        f"{DIST_TIMED_CALLS} replays, in turns): unsharded "
        f"{out['graph_us']['unsharded']['median_us']:.1f} us, through the host mesh "
        f"{out['graph_us']['host_mesh']['median_us']:.1f} us, on {card}")
    return out


def _dist_train(torch, mesh, card) -> dict:
    """GanTrainer(data_parallel=True) under the host mesh against
    data_parallel=False: 3 graphed steps bitwise, with equal launches; the
    two step graphs timed in turns."""
    from repro_torch.data import SyntheticImages
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import gan
    from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig

    cfg = gan.DCGAN
    data = SyntheticImages(cfg.out_hw(cfg.layers[-1][0]), cfg.layers[-1][2],
                           GanTrainerConfig().global_batch)
    quiet = lambda *a: None  # noqa: E731
    with use_mesh(mesh):
        dp = GanTrainer(cfg, GanTrainerConfig(), data, log_fn=quiet)
    plain = GanTrainer(cfg, GanTrainerConfig(data_parallel=False), data, log_fn=quiet)
    s_dp = dp.init_state(torch.Generator().manual_seed(0))
    s_pl = plain.init_state(torch.Generator().manual_seed(0))
    out = {"steps": []}
    for step in range(3):
        reals, zs = dp._batches(step)
        with use_mesh(mesh):
            (s_dp, m_dp), c_dp = _count_delta(dp._step_fn, s_dp, reals, zs)
        (s_pl, m_pl), c_pl = _count_delta(plain._step_fn, s_pl, reals, zs)
        if m_dp != m_pl or not _bitwise(s_dp, s_pl) or c_dp != c_pl:
            raise AssertionError(f"distribution: data-parallel step {step} under the host "
                                 f"mesh is not bitwise the plain step ({m_dp} vs {m_pl}; "
                                 f"launches {c_dp} vs {c_pl})")
        out["steps"].append({"metrics": m_dp, "launches": c_dp})
    out["graph_us"] = _in_turns(torch, {"plain": plain._graph.graph,
                                        "host_mesh": dp._graph.graph})
    log(f"[distribution] GanTrainer(data_parallel=True) under the host mesh: 3 graphed "
        f"steps bitwise the data_parallel=False steps (scalars, params, moments), equal "
        f"launches; a step's graph replay (CUDA events, {DIST_TIMED_CALLS} replays, in "
        f"turns): plain {out['graph_us']['plain']['median_us']:.1f} us, host mesh "
        f"{out['graph_us']['host_mesh']['median_us']:.1f} us, on {card}")
    return out


def _dist_moe(torch, mesh) -> dict:
    """The MoE's expert-parallel path at DBRX width under the host mesh (its
    FSDP gather of the expert slices included): a layer and the model's
    logits against the no-mesh ``moe`` and forward, then ServeEngine's
    graphed decode step under the mesh bitwise its eager step."""
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeEngine
    from repro_torch.tree import tree_map

    arch, cut, batch, n_tok, why = DIST_MOE
    cfg = _family_cfg(arch, dtype="float32", no_drops=True, **dict(cut))
    model = build_model(cfg)
    params, info = _init_lm(torch, model, seed=12)
    gen = torch.Generator(device="cuda").manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (batch, n_tok), device="cuda", generator=gen)
    x = torch.randn((batch, n_tok, cfg.d_model), device="cuda", generator=gen) * 0.5
    p0 = tree_map(lambda t: t[0], params["layers"][0]["ffn"])
    out = {**info, "cut": why, "fsdp": cfg.fsdp}

    def close(got, want, what):
        err = (got - want).abs().max().item()
        tol = TOL_REL * want.abs().max().item() + TOL_ABS
        out[what] = {"max_abs_err": err, "tol": tol}
        if not err <= tol:
            raise AssertionError(f"distribution: the expert-parallel {what} is off the "
                                 f"no-mesh one by {err} > {tol}")

    want_layer, want_aux = L.moe(p0, cfg, x)
    want_logits, _ = model.apply(params, {"tokens": toks})
    with use_mesh(mesh):
        if not L._moe_supported_by_shard_map(cfg, batch):
            raise AssertionError("distribution: the host mesh did not take the MoE's "
                                 "expert-parallel path")
        (got_layer, got_aux), calls = _count_collectives(L.moe, p0, cfg, x)
        got_logits, _ = model.apply(params, {"tokens": toks})
    close(got_layer, want_layer, "layer")
    close(got_aux, want_aux, "aux")
    close(got_logits, want_logits, "logits")
    out["collectives"] = calls
    del got_logits, want_logits
    torch.cuda.empty_cache()   # the decode graph's warm-up on a cache of no large blocks
    with use_mesh(mesh):
        eng = ServeEngine(model, params, slots=LM_SLOTS, max_len=64)
        _, _, _, bitwise = _decode_step_fns(torch, model, params, cfg.vocab_size)
        bitwise(eng, torch.full((LM_SLOTS,), 5, dtype=torch.int32, device="cuda"),
                "pos 5", "distribution moe")
    del eng, bitwise
    log(f"[distribution] MoE expert-parallel path on the host mesh, {cfg.name} fp32 "
        f"({why}; {info['params']} params, fsdp {cfg.fsdp}), collectives a layer "
        f"{calls}: layer max abs err {out['layer']['max_abs_err']:.3e} (tol "
        f"{out['layer']['tol']:.3e}), logits {out['logits']['max_abs_err']:.3e} (tol "
        f"{out['logits']['tol']:.3e}) of the no-mesh path; the graphed decode step under "
        f"the mesh bitwise its eager step")
    return out


def gloo_worker(rank: int, world: int, port: int, out_path: str) -> int:
    """One rank of phase 27's two-process run on the one card over gloo:
    full-width DCGAN at batch 8 on a ``data`` mesh of ``world`` ranks, its
    output and parameter gradients against the unsharded call's; the
    result as JSON at ``out_path``."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, SRC)
    from repro_torch.distributed.sharding import shard_plan_apply
    from repro_torch.models import gan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DIST_PROCS_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
        cfg = gan.DCGAN
        params = gan.generator_init(torch.Generator().manual_seed(0), cfg)
        gen = torch.Generator(device="cuda").manual_seed(23)
        z = torch.randn((BATCH, cfg.z_dim), device="cuda", generator=gen)
        plan = gan.generator_plan(cfg, BATCH)

        def apply_fn(p, zz, pl):
            return gan.generator_apply(p, cfg, zz, plan=pl)

        _reset_counts()
        want = apply_fn(params, z, plan)
        full = _read_counts()
        _reset_counts()
        got = shard_plan_apply(apply_fn, params, z, plan, mesh=mesh)
        torch.cuda.synchronize()
        mine = _read_counts()
        r = torch.randn(want.shape, device="cuda", generator=gen)
        grads = {}
        for name, fn in (("unsharded", lambda p: apply_fn(p, z, plan)),
                         ("sharded", lambda p: shard_plan_apply(apply_fn, p, z, plan,
                                                                mesh=mesh))):
            live = _live(params)
            (fn(live) * r).sum().backward()
            grads[name] = {f"{k}.{n}": t.grad for k, v in live.items() for n, t in v.items()}
        errs = {}
        for key, ref in grads["unsharded"].items():
            errs[key] = {"max_abs_err": (grads["sharded"][key] - ref).abs().max().item(),
                         "tol": TOL_REL * ref.abs().max().item() + TOL_ABS}
        result = {"rank": rank, "bitwise": torch.equal(got, want),
                  "max_abs_err": (got - want).abs().max().item(),
                  "launches_unsharded": full, "launches_sharded": mine,
                  "grads": errs, "backend": dist.get_backend()}
        with open(out_path, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


def _dist_two_process(torch, card) -> dict:
    """Phase 27(b): two processes on the one card over gloo (gloo_worker),
    spawned with a time limit; logs in chiprun_out/dist/."""
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    logs = os.path.join(ROOT, "chiprun_out", "dist")
    os.makedirs(logs, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC)
    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        files = [open(os.path.join(logs, f"rank{r}.log"), "w") for r in range(world)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--gloo-rank", str(r),
             "--gloo-world", str(world), "--gloo-port", str(port), "--gloo-out",
             os.path.join(tmp, f"rank{r}.json")],
            cwd=ROOT, env=env, stdout=files[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=max(DIST_PROCS_TIMEOUT_S - (time.perf_counter() - t0), 1))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"distribution: the two-process gloo run did not end "
                                 f"in {DIST_PROCS_TIMEOUT_S} s (logs in chiprun_out/dist)")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in files:
                f.close()
        wall = time.perf_counter() - t0
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(f"distribution: gloo ranks exited "
                                 f"{[p.returncode for p in procs]} (logs in "
                                 f"chiprun_out/dist)")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for res in ranks:
        bad = {k: v for k, v in res["grads"].items() if not v["max_abs_err"] <= v["tol"]}
        if not res["bitwise"] or bad:
            raise AssertionError(f"distribution: gloo rank {res['rank']}: output bitwise "
                                 f"{res['bitwise']} (max abs err {res['max_abs_err']}), "
                                 f"gradients off {bad}")
        if min(res["launches_sharded"][n] for n in FORWARD) < 1:
            raise AssertionError(f"distribution: gloo rank {res['rank']} launched "
                                 f"{res['launches_sharded']}")
    worst = max(v["max_abs_err"] / v["tol"] for res in ranks for v in res["grads"].values())
    log(f"[distribution] two processes on the one card over {ranks[0]['backend']}, "
        f"full-width DCGAN at batch {BATCH} on a data = {world} mesh: each rank's "
        f"gathered output bitwise the unsharded call; each rank launched "
        f"{ranks[0]['launches_sharded']} for its {BATCH // world} images (unsharded "
        f"{ranks[0]['launches_unsharded']}); parameter gradients through the region "
        f"within tolerance (worst err / tol {worst:.3f}); the run's wall {wall:.1f} s "
        f"(host clock, two processes started, built kernels loaded, joined), on {card}")
    return {"world": world, "ranks": ranks, "wall_s": wall}


def _dist_entry() -> dict:
    """Phase 27(c): ``launch.train --mesh single-pod`` on one card exits
    non-zero with the ValueError that names 256 ranks."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-0.5b",
           "--reduced", "--steps", "1", "--mesh", "single-pod"]
    res = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=ENTRY_TIMEOUT_S)
    last = (res.stderr.strip().splitlines() or [""])[-1]
    if res.returncode == 0 or "ValueError" not in last or "256 ranks" not in last:
        raise AssertionError(f"distribution: --mesh single-pod exited {res.returncode}: "
                             f"{last}")
    log(f"[distribution] launch.train --mesh single-pod on one card: exit "
        f"{res.returncode}: {last}")
    return {"rc": res.returncode, "last": last}


def phase_distribution(torch) -> dict:
    """Phase 27: the sharded paths on the card (see the module docstring)."""

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    gc.collect()
    torch.cuda.empty_cache()
    owned = not dist.is_initialized()
    mesh = make_host_mesh()
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "backend": dist.get_backend(), "nvidia_smi": _smi()}
    card = out["nvidia_smi"]
    log(f"[distribution] host mesh {out['mesh']} over {dist.get_world_size()} "
        f"{out['backend']} rank; card {out['nvidia_smi']}")
    try:   # the MoE's large buffers first, on an empty cache, then released
        out["moe"] = _dist_moe(torch, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        out["generator"] = _dist_generator(torch, mesh)
        out["replica"] = _dist_replica(torch, mesh, card)
        out["train"] = _dist_train(torch, mesh, card)
        torch.cuda.synchronize()
    finally:
        # the graphs (and their pools) go before the group their
        # collectives ran on; then every segment the phase reserved goes
        # back, so phase 24's allocations do not land in its large ones
        gc.collect()
        if owned:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
    out["two_process"] = _dist_two_process(torch, card)
    out["entry"] = _dist_entry()
    return out


def phase_entry_points() -> dict:
    """``python -m repro_torch.launch.train`` (reduced Qwen2-0.5B) and each
    port example (``torch_train_lm.py`` 20 steps of its reduced xLSTM), run
    at once as processes on the card; each must exit 0.
    Their output goes to chiprun_out/entry/."""
    import subprocess
    import tempfile

    py = sys.executable
    runs = {
        "launch_train": [py, "-m", "repro_torch.launch.train", "--arch", "qwen2-0.5b",
                         "--reduced", "--steps", "20", "--batch", "8", "--seq", "128",
                         "--ckpt-every", "10", "--mesh", "host"],
        "torch_quickstart": [py, "examples/torch_quickstart.py"],
        "torch_serve_gan": [py, "examples/torch_serve_gan.py", "--requests", "32",
                            "--sequential"],
        "torch_train_dcgan": [py, "examples/torch_train_dcgan.py", "--steps", "20"],
        "torch_serve_lm": [py, "examples/torch_serve_lm.py"],
        "torch_train_lm": [py, "examples/torch_train_lm.py", "--steps", "20"],
    }
    logs = os.path.join(ROOT, "chiprun_out", "entry")
    os.makedirs(logs, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC)
    out, procs = {}, {}
    with tempfile.TemporaryDirectory() as ckpt:
        runs["launch_train"] += ["--ckpt-dir", os.path.join(ckpt, "launch_train")]
        runs["torch_train_lm"] += ["--ckpt-dir", os.path.join(ckpt, "torch_train_lm")]
        t0 = time.perf_counter()
        try:
            for name, cmd in runs.items():
                f = open(os.path.join(logs, f"{name}.log"), "w")
                procs[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f,
                                                stderr=subprocess.STDOUT), f)
            for name, (proc, f) in procs.items():
                left = max(ENTRY_TIMEOUT_S - (time.perf_counter() - t0), 1)
                try:
                    rc = proc.wait(timeout=left)
                except subprocess.TimeoutExpired:
                    rc = "timeout"
                f.close()
                with open(f.name) as g:
                    tail = g.read().strip().splitlines()[-1:] or [""]
                out[name] = {"rc": rc, "s": time.perf_counter() - t0, "last": tail[0]}
                log(f"[entry] {name}: exit {rc} after {out[name]['s']:.1f} s: {tail[0]}")
        finally:
            for proc, f in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                f.close()
    bad = {k: v["rc"] for k, v in out.items() if v["rc"] != 0}
    if bad:
        raise AssertionError(f"entry points failed (logs in chiprun_out/entry): {bad}")
    if "mesh host" not in out["launch_train"]["last"] or "1 nccl" not in out[
            "launch_train"]["last"]:
        raise AssertionError(f"launch.train did not run under the one-rank NCCL host "
                             f"mesh: {out['launch_train']['last']}")
    return out


def phase_graph_failure(torch) -> dict:
    """A function that reads a device value on the host cannot be captured:
    building its graph raises (nothing falls back to eager launches), and
    the card goes on working."""
    from repro_torch.graphs import CudaGraph

    x = torch.ones(4, device="cuda")
    try:
        CudaGraph(lambda t: t * t.sum().item(), x)
    except RuntimeError as e:
        message = str(e).strip().splitlines()[0]
    else:
        raise AssertionError("a capture that synchronises did not raise")
    if (x + 1).sum().item() != 8.0:
        raise AssertionError("the card did not recover from a failed capture")
    log(f"[graph-failure] a capture that reads a device value raised: {message}")
    return {"raised": message}


def _entry(name, launches, err, rows, times_of, bound_of) -> dict:
    """One kernel's line of the result: times summed over the DCGAN layers
    it runs at batch 8 (``rows``; ``times_of(row, suffix)`` and
    ``bound_of(row)`` read them)."""
    ops = sum(bound_of(r)["ops_ms"] for r in rows)
    byt = sum(bound_of(r)["bytes_ms"] for r in rows)
    source, replaces = SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": sum(times_of(r, "_ms") for r in rows),
        "plain_ms": sum(times_of(r, "_plain_ms") for r in rows),
        "bound_ms": sum(bound_of(r)["bound_ms"] for r in rows),
        "bound_by": "operations" if ops >= byt else "bytes",
        "library_ms": sum(times_of(r, "_library_ms") for r in rows),
    }


PLACE_ARCH, PLACE_LAYERS = "llama3-8b", 2   # full width, 2 layers, fp32
PLACE_SLOTS, PLACE_PROMPT, PLACE_MAX_LEN, PLACE_DECODE = 8, 64, 1024, 16
PLACE_TRAIN_SEQ, PLACE_TRAIN_BATCH = 1024, 4   # Qwen2-0.5B, full depth, bf16
PLACE_TRAIN_STEPS = 3
PLACE_XLSTM_TRAIN = ("xlstm-125m", 256, 4)   # arch, seq, batch: the sLSTM loops over seq
PLACE_LSE_KV = 32768   # the two-half combine: Llama-3-8B's decode_32k cache
# the families served placed beside themselves unplaced, at phase 26's cuts
PLACE_FAMILIES = [
    ("jamba-1.5-large-398b", {"n_layers": 8, "n_experts": 8},
     "one period (8 of 72 layers), experts 16 -> 8, as phase 26"),
    ("xlstm-125m", {}, "none (12 layers)"),
    ("whisper-large-v3", {}, "none (32 + 32 layers, 1500 frames)"),
]
PLACE_FAM_SLOTS, PLACE_FAM_PROMPT, PLACE_FAM_DECODE, PLACE_FAM_MAX_LEN = 4, 64, 8, 128
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k"), ("llama3-8b", "decode_32k"),
                ("jamba-1.5-large-398b", "long_500k"), ("xlstm-125m", "decode_32k"),
                ("whisper-large-v3", "decode_32k"))
DRYRUN_TIMEOUT_S = 600


def _dryrun_procs() -> list:
    """The dry-run cells as processes (``python -m repro_torch.launch.dryrun``,
    no card), started now and read at the end of phase 28; their logs in
    chiprun_out/dryrun/."""
    logs = os.path.join(ROOT, "chiprun_out", "dryrun")
    os.makedirs(logs, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        log_path = os.path.join(logs, f"{arch}_{shape}.log")
        f = open(log_path, "w")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--mesh", "single", "--out", logs]
        procs.append((arch, shape, cmd, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT), f, log_path))
    return procs


def _dryrun_results(procs) -> list:
    """Wait for the dry-run processes; each must exit 0 and write its
    report (per-rank bytes and collectives, arithmetic over a fake 256-rank
    world)."""
    out = []
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    try:
        for arch, shape, cmd, p, f, log_path in procs:
            try:
                rc = p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"placement: {' '.join(cmd[1:])} did not finish in "
                                     f"{DRYRUN_TIMEOUT_S} s")
            f.close()
            if rc != 0:
                with open(log_path) as g:
                    tail = g.read()[-2000:]
                raise AssertionError(f"placement: {' '.join(cmd[1:])} exited {rc}:\n{tail}")
            with open(os.path.join(os.path.dirname(log_path), f"{arch}_{shape}_256.json")) as g:
                rep = json.load(g)
            row = {"arch": arch, "shape": shape, "mode": rep["mode"],
                   "trace_s": rep["trace_s"], "flops": rep["flops"],
                   "memory": rep["memory"], "collectives": rep["collectives"]}
            out.append(row)
            log(f"[placement] dry run {arch} {shape} on a fake 16x16 world ({rep['mode']}, "
                f"traced in {rep['trace_s']} s, no card): per rank "
                f"{rep['memory']['argument_size_in_bytes']} argument bytes, "
                f"{rep['flops']:.4g} FLOPs, {rep['collectives']['total']:.4g} collective "
                f"wire bytes (arithmetic, not a measurement); exit 0")
    finally:
        for *_, p, f, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    return out


def _lse_check(torch) -> dict:
    """The decode kernel's log-sum-exp output against its plain version at
    phase 14's shapes and with kv_len 0 rows (out 0, lse -inf), then the
    lse variant timed at Llama-3-8B S 4096 beside its plain version and
    SDPA, with the bound."""
    import torch.nn.functional as F

    launch, plain = kernels(("decode_attention",))["decode_attention"]
    rows = []
    for i, shape in enumerate(DECODE_CHECKS):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, kv_len = _decode_inputs(torch, shape, dtype, seed=2800 + i)
            kv_len[0] = 0   # a row with no valid key
            (got, lse), (want, wlse) = (launch(q, k, v, kv_len, return_lse=True),
                                        plain(q, k, v, kv_len, return_lse=True))
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = TOL_REL * want.abs().max().item() + TOL_ABS
            finite = torch.isfinite(wlse)
            lerr = (lse[finite] - wlse[finite]).abs().max().item()
            ltol = TOL_REL * wlse[finite].abs().max().item() + TOL_ABS
            empty_ok = bool((lse[0] == -torch.inf).all() and (got[0] == 0).all()
                            and torch.equal(torch.isfinite(lse), finite))
            if not (err <= tol and lerr <= ltol and empty_ok):
                raise AssertionError(f"placement: the decode kernel's lse output disagrees "
                                     f"at {shape} {dtype}: out {err} > {tol}, lse {lerr} > "
                                     f"{ltol}, or the kv_len 0 row is not (0, -inf)")
            rows.append({"shape": shape, "dtype": str(dtype)[6:], "max_abs_err": err,
                         "lse_max_abs_err": lerr, "tol": tol, "lse_tol": ltol})
            del q, k, v, got, want, lse, wlse
    log(f"[placement] decode kernel lse output at {len(DECODE_CHECKS)} shapes x 2 dtypes, "
        f"a kv_len 0 row each: out worst {max(r['max_abs_err'] for r in rows):.3e}, lse "
        f"worst {max(r['lse_max_abs_err'] for r in rows):.3e} (tol {TOL_REL} * max|ref| + "
        f"{TOL_ABS}); kv_len 0 gives out 0, lse -inf")
    shape = DECODE_TIMES[0]
    b, s_len, kvh, g, hd = shape
    q, k, v, _ = _decode_inputs(torch, shape, torch.bfloat16, seed=2900)
    kv_len = torch.full((b,), s_len, dtype=torch.int32, device="cuda")

    def library(qq, kk, vv, mask):
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, enable_gqa=True)

    lib_args = (q.reshape(b, kvh * g, 1, hd), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                (torch.arange(s_len, device="cuda") < kv_len[:, None])[:, None, None])
    # timed as phase 15 times them: without the deterministic algorithms
    # phase 20 turned on (under them SDPA takes its slow math backend)
    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(False)
    bound = _decode_bound(shape, [s_len] * b, 2)
    try:
        timed = {**_limits(bound["flops"], bound["bytes"] + 4 * b * kvh * g),   # + the lse
                 "shape": shape,
                 "device_us": _device_us(torch, launch, q, k, v, kv_len, return_lse=True),
                 "plain_device_us": _device_us(torch, plain, q, k, v, kv_len, calls=5,
                                               return_lse=True),
                 "library_device_us": _device_us(torch, library, *lib_args),
                 "no_lse_device_us": _device_us(torch, launch, q, k, v, kv_len)}
    finally:
        torch.use_deterministic_algorithms(deterministic[0], warn_only=deterministic[1])
    for key in ("", "plain_", "library_"):
        timed[f"{key}ms"] = timed[f"{key}device_us"] * 1e-3
    log(f"[placement] decode kernel with lse at {shape} bf16 kv_len=S, device-only: "
        f"{timed['device_us']:.2f} us (without lse {timed['no_lse_device_us']:.2f}), plain "
        f"{timed['plain_device_us']:.2f} us, SDPA {timed['library_device_us']:.2f} us, "
        f"bound {timed['bound_ms'] * 1e3:.2f} us ({timed['bound_by']})")
    return {"rows": rows, "worst": max(r["max_abs_err"] for r in rows),
            "lse_worst": max(r["lse_max_abs_err"] for r in rows), "times": timed}


def _two_half_combine(torch) -> dict:
    """The cross-rank decode combine on one card: the kernel on the two
    halves of a Llama-3-8B cache at kv_len 32768 (bf16, 8 slots), kv_len
    clipped to each half, combined by their log-sum-exp as the placed decode
    combines the model ranks', against the whole cache's kernel call;
    rows whose length ends in the first half leave the second with no
    valid key."""
    launch, _ = kernels(("decode_attention",))["decode_attention"]
    b, kvh, g, hd = LM_SLOTS, 8, 4, 128
    S, half = PLACE_LSE_KV, PLACE_LSE_KV // 2
    gen = torch.Generator(device="cuda").manual_seed(2950)
    q = torch.randn((b, kvh, g, hd), device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn((b, S, kvh, hd), device="cuda", generator=gen).bfloat16()
            for _ in range(2))
    kv_len = torch.tensor([S, S, 1, half, half + 1, 5000, 20000, 32000],
                          dtype=torch.int32, device="cuda")
    want = launch(q, k, v, kv_len)
    outs, lses = [], []
    for h in range(2):
        clip = (kv_len - h * half).clamp(0, half).to(torch.int32)
        o, lse = launch(q, k[:, h * half:(h + 1) * half].contiguous(),
                        v[:, h * half:(h + 1) * half].contiguous(), clip, return_lse=True)
        outs.append(o)
        lses.append(lse)
    lse = torch.stack(lses)
    m = lse.amax(0)
    w = torch.exp(lse - m)
    got = (torch.stack(outs) * w[..., None]).sum(0) / w.sum(0)[..., None]
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = TOL_REL * want.abs().max().item() + TOL_ABS
    empty = int((lses[1] == -torch.inf).all(dim=(1, 2)).sum().item())
    want_empty = int((kv_len <= half).sum().item())   # 1, 16384 and 5000
    if not (err <= tol and empty == want_empty == 3):
        raise AssertionError(f"placement: the two-half combine differs from the whole "
                             f"cache by {err} (tol {tol}), or {empty} rows, not "
                             f"{want_empty}, left the second half empty")
    log(f"[placement] decode combine across two halves of a {S}-row Llama-3-8B cache "
        f"(bf16, {b} slots, kv_len {kv_len.tolist()}): max abs err {err:.3e} against the "
        f"whole cache (tol {tol:.3e}); {empty} rows with no valid key in the second half")
    del q, k, v, outs, want, got
    torch.cuda.empty_cache()
    return {"kv_len": kv_len.tolist(), "max_abs_err": err, "tol": tol, "empty_rows": empty}


def _placed_serve(torch, mesh, card) -> dict:
    """Full-width Llama-3-8B (PLACE_LAYERS layers, fp32) placed on the host
    mesh in its serving mode: the prefill's logits and PLACE_DECODE decode
    steps through the placed engine's graph, within TOL of the unplaced
    prefill and the unplaced engine's graphed steps on the same tokens and
    cache contents; each placed graphed step bitwise the placed eager step.
    The decode steps are timed both ways (CUDA events). The launch counts
    cover the placed run only."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import _whole_logits
    from repro_torch.timing import time_cuda

    cfg = dataclasses.replace(get_config(PLACE_ARCH), n_layers=PLACE_LAYERS, dtype="float32")
    model = build_model(cfg)
    params, out = _init_lm(torch, model, seed=28)
    mode = sharding.parallelism_for(cfg, "decode", PLACE_SLOTS, mesh)
    sharding.set_parallelism(mode)
    gen = torch.Generator(device="cuda").manual_seed(2801)
    prompt = torch.randint(0, cfg.vocab_size, (PLACE_SLOTS, PLACE_PROMPT), device="cuda",
                           generator=gen)
    want, wcache = model.prefill(params, {"tokens": prompt})
    plain = ServeEngine(model, params, slots=PLACE_SLOTS, max_len=PLACE_MAX_LEN)
    for c, w in zip(plain.cache, wcache):
        c.k[:, :, :PLACE_PROMPT] = w.k
        c.v[:, :, :PLACE_PROMPT] = w.v
    toks, plain_logits = [], []
    tok = want[:, -1].argmax(-1, keepdim=True).int()
    for i in range(PLACE_DECODE):   # the unplaced engine's graphed steps
        pos = torch.full((PLACE_SLOTS,), PLACE_PROMPT + i, dtype=torch.int32, device="cuda")
        lg = plain._decode(params, plain.cache, {"tokens": tok, "pos": pos})[0].clone()
        toks.append(tok)
        plain_logits.append(lg)
        tok = lg[:, -1].argmax(-1, keepdim=True).int()
    _reset_counts()   # the placed path, counted
    placed = sharding.distribute_params(params, mesh, cfg.fsdp)
    got, gcache = model.prefill(placed, {"tokens": prompt})
    got = got.full_tensor()
    eng = ServeEngine(model, placed, slots=PLACE_SLOTS, max_len=PLACE_MAX_LEN)
    for c, w in zip(eng.cache, gcache):
        c.k.to_local()[:, :, :PLACE_PROMPT] = w.k.full_tensor()
        c.v.to_local()[:, :, :PLACE_PROMPT] = w.v.full_tensor()
    eager = _whole_logits(model.decode_step)
    errs = []
    for i in range(PLACE_DECODE):
        pos = torch.full((PLACE_SLOTS,), PLACE_PROMPT + i, dtype=torch.int32, device="cuda")
        batch = {"tokens": toks[i], "pos": pos}
        g = eng._decode(placed, eng.cache, batch)[0].clone()
        e = eager(placed, eng.cache, batch)[0]   # rewrites the step's rows with the same bits
        if not torch.equal(g, e):
            raise AssertionError(f"placement: the placed graphed decode step {i} is not "
                                 f"bitwise the placed eager step "
                                 f"({(g - e).abs().max().item()})")
        errs.append((g - plain_logits[i]).abs().max().item())
        tol = TOL_REL * plain_logits[i].abs().max().item() + TOL_ABS
        if not errs[-1] <= tol:
            raise AssertionError(f"placement: placed decode step {i} differs from the "
                                 f"unplaced one by {errs[-1]} (tol {tol})")
    out["launches"] = _read_counts()
    want_launches = PLACE_LAYERS * (2 * PLACE_DECODE + 1)   # graph + eager + capture warm-up
    if out["launches"]["decode_attention"] != want_launches:
        raise AssertionError(f"placement: {out['launches']['decode_attention']} decode "
                             f"launches on the placed path, want {want_launches}")
    perr = (got - want).abs().max().item()
    ptol = TOL_REL * want.abs().max().item() + TOL_ABS
    if not perr <= ptol:
        raise AssertionError(f"placement: the placed prefill differs by {perr} (tol {ptol})")
    pos = torch.full((PLACE_SLOTS,), PLACE_PROMPT, dtype=torch.int32, device="cuda")
    batch = {"tokens": toks[0], "pos": pos}
    times = {}
    for name in ("unplaced", "placed", "placed", "unplaced"):   # in turns
        e_, p_ = (plain, params) if name == "unplaced" else (eng, placed)
        times.setdefault(name, []).append(time_cuda(
            lambda t, e_=e_, p_=p_: e_._decode(p_, e_.cache, {"tokens": t, "pos": pos}),
            toks[0], iters=20, warmup=2))
    out.update({"mode": mode, "prefill_max_abs_err": perr, "prefill_tol": ptol,
                "decode_max_abs_err": max(errs),
                "graph_step_ms": {k: min(v) for k, v in times.items()},
                "graph_step_ms_turns": times,
                "eager_step_ms": time_cuda(lambda t: eager(placed, eng.cache, batch),
                                           toks[0], iters=5, warmup=1),
                "plain_eager_step_ms": time_cuda(
                    lambda t: model.decode_step(params, plain.cache, batch), toks[0],
                    iters=5, warmup=1)})
    log(f"[placement] {cfg.name} full width, {PLACE_LAYERS} layers, fp32, placed on the "
        f"host mesh ({mode}): prefill of {PLACE_SLOTS} x {PLACE_PROMPT} within "
        f"{perr:.3e} (tol {ptol:.3e}) of the unplaced; {PLACE_DECODE} decode steps through "
        f"the placed engine's graph, each bitwise the placed eager step, worst "
        f"{max(errs):.3e} from the unplaced engine's; decode launches "
        f"{out['launches']['decode_attention']}")
    log(f"[placement] a graphed decode step (CUDA events, 20 replays, in turns): placed "
        f"{out['graph_step_ms']['placed']:.4f} ms, unplaced "
        f"{out['graph_step_ms']['unplaced']:.4f} ms; eager: placed "
        f"{out['eager_step_ms']:.3f} ms, unplaced {out['plain_eager_step_ms']:.3f} ms; on "
        f"{card}")
    del eng, plain, params, placed, wcache, gcache
    sharding.set_parallelism("tp")
    return out


def _placed_train(torch, mesh, card, arch=LM_TRAIN_ARCH, seq=PLACE_TRAIN_SEQ,
                  batch=PLACE_TRAIN_BATCH) -> dict:
    """Full-depth ``arch`` (bf16, ``seq``, ``batch``: Qwen2-0.5B at seq
    PLACE_TRAIN_SEQ, batch PLACE_TRAIN_BATCH, by default) placed on the host
    mesh in its training mode (Qwen's fsdp, xLSTM's tp):
    PLACE_TRAIN_STEPS steps through the Trainer's graph, then the same steps
    eagerly from the same seeded state, bitwise (each step's metrics, and
    the state after the last).
    Each graphed step is held against the unplaced step taken from the same
    state (gathered whole): loss, ce and grad norm within 1e-3 relative;
    each new parameter within 2 lr + 2^-7 of its leaf's largest (two bf16
    ulps there): Adam's early steps move a weight by about lr whatever its
    gradient's size, so a near-zero gradient summed in another order can
    reverse one weight's step; the first moments within 2^-5 of each
    leaf's largest and the second within 2^-4 (squares): a bf16 gradient
    of a weight used in several places (the tied embedding: its gather and
    the head's loss chunks) sums its bf16 terms in another order placed,
    a few bf16 ulps (2^-8) of the largest term each. Steps are compared one
    at a time because in bf16 a weight that rounds the other way moves
    every later gradient. The graphed step is timed unplaced, then placed
    (CUDA events; each graph alone on the card)."""

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.distributed import sharding
    from repro_torch.models.lm import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.timing import time_cuda
    from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    model = build_model(cfg)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=2, total_steps=30)
    data = SyntheticTokens(cfg.vocab_size, seq, batch)
    quiet = lambda *a: None  # noqa: E731
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)  # noqa: E731

    def whole(state):   # a placed state gathered, as plain tensors of its own (a
        # one-rank gather may alias the graph's static state, which a step rewrites)
        return tuple(tree_map(lambda t: (t.full_tensor() if hasattr(t, "full_tensor")
                                         else t).clone(), x) for x in state)

    def vals_of(m):
        return dict(zip(m, torch.stack(list(m.values())).tolist()))

    # the unplaced graphed step first, timed and released: a second graph's
    # warm-up and pool would not fit beside the placed state's on a card
    # the earlier phases left fragmented
    batch_t = data.batch(PLACE_TRAIN_STEPS)
    plain_tr = Trainer(model, make_train_step(model, tc), data, log_fn=quiet)
    s = init_train_state(model, gen(), tc)
    plain_tr._step_fn(*s, data.batch(0))
    s = (plain_tr._graph.inputs[0], plain_tr._graph.inputs[1])
    times = {"unplaced": time_cuda(lambda t: plain_tr._graph(*s, batch_t), batch_t["tokens"],
                                   iters=3, warmup=1)}
    del plain_tr, s
    gc.collect()
    torch.cuda.empty_cache()
    _reset_counts()   # the placed path
    with sharding.use_mesh(mesh):
        # the graph first, captured on the allocator the phase emptied; the
        # eager steps after it, from the same seeded state drawn again
        g = init_train_state(model, gen(), tc, mesh=mesh, global_batch=batch)
        mode = sharding.get_parallelism()
        tr = Trainer(model, make_train_step(model, tc), data, log_fn=quiet)
        plain = Trainer(model, make_train_step(model, tc), data, log_fn=quiet)   # eager
        worst, plain_metrics, graphed = {"p": 0.0, "m": 0.0, "v": 0.0}, [], []
        for i in range(PLACE_TRAIN_STEPS):
            before = whole(g)
            p, o, vals = tr._step_fn(*g, data.batch(i))
            g = (p, o)
            graphed.append(vals)
            with sharding.use_mesh(None):   # the unplaced step from the same state
                up, uo, um = plain.step_eager(*before, data.batch(i))
            want = vals_of(um)
            plain_metrics.append(want)
            for k in ("loss", "grad_norm", "ce"):
                if not abs(vals[k] - want[k]) <= 1e-3 * abs(want[k]) + 1e-6:
                    raise AssertionError(f"placement: placed step {i}'s {k} {vals[k]} is "
                                         f"not within 1e-3 of the unplaced {want[k]}")
            if not torch.equal(g[1]["count"], uo["count"]):
                raise AssertionError("placement: the step counts differ")
            pairs = [(a, b, "p") for a, b in zip(tree_leaves(g[0]), tree_leaves(up))]
            for key in ("m", "v"):
                pairs += [(a, b, key) for a, b in zip(tree_leaves(g[1][key]),
                                                      tree_leaves(uo[key]))]
            for a, b, kind in pairs:
                a = a.full_tensor()   # read at once, before the next step rewrites it
                err = max((x.float() - y.float()).abs().max().item()   # in row blocks
                          for x, y in zip(a.split(8192), b.split(8192)))
                scale = b.float().abs().max().item()
                tol = {"p": 2 * vals["lr"] + 2 ** -7 * scale, "m": 2 ** -5 * scale + 1e-8,
                       "v": 2 ** -4 * scale + 1e-12}[kind]
                worst[kind] = max(worst[kind], err / tol)
                if not err <= tol:
                    raise AssertionError(f"placement: placed step {i}: a leaf "
                                         f"{tuple(a.shape)} differs by {err} from the "
                                         f"unplaced step's (tol {tol})")
            del pairs, a, before, up, uo
        e = init_train_state(model, gen(), tc, mesh=mesh, global_batch=batch)
        eager = []
        for i in range(PLACE_TRAIN_STEPS):   # only the last state is kept
            p, o, m = tr.step_eager(*e, data.batch(i))
            e = (p, o)
            eager.append(vals_of(m))
            if eager[i] != graphed[i]:
                raise AssertionError(f"placement: placed graphed train step {i} is not "
                                     f"bitwise the placed eager step: {graphed[i]} vs "
                                     f"{eager[i]}")
        if not _bitwise(sharding.full_tree(list(g)), sharding.full_tree(list(e))):
            raise AssertionError("placement: the placed graphed steps' state is not bitwise "
                                 "the placed eager steps'")
        out = {"mode": mode, "launches": _read_counts(), "metrics": plain_metrics,
               "placed_metrics": eager, "worst_err_over_tol": worst}
        del e
        gc.collect()
        torch.cuda.empty_cache()
        times["placed"] = time_cuda(lambda t: tr._graph(*g, batch_t), batch_t["tokens"],
                                    iters=3, warmup=1)
    out["graph_step_ms"] = times
    log(f"[placement] {cfg.name} full depth, bf16, seq {seq}, batch "
        f"{batch}, placed on the host mesh ({mode}): {PLACE_TRAIN_STEPS} graphed "
        f"steps bitwise the placed eager steps; each against the unplaced step from the "
        f"same state: metrics within 1e-3, worst err / tol: params {worst['p']:.3f}, first "
        f"moments {worst['m']:.3f}, second {worst['v']:.3f}; losses "
        f"{[round(v['loss'], 4) for v in out['placed_metrics']]}")
    log(f"[placement] a graphed train step (CUDA events, 3 replays; unplaced first, then "
        f"placed, each graph alone on the card): placed "
        f"{out['graph_step_ms']['placed']:.2f} ms, unplaced "
        f"{out['graph_step_ms']['unplaced']:.2f} ms, on {card}")
    del tr, plain, g
    gc.collect()
    torch.cuda.empty_cache()
    sharding.set_parallelism("tp")
    return out


def _fill_cache(cache, prefill) -> None:
    """``cache``'s leaves (placed or not; on one rank a placed leaf's local
    tensor is the whole) from a prefill's, in place: a leaf of the same
    shape copied, an attention cache in its first rows."""
    from repro_torch.distributed import sharding

    local = lambda t: t.to_local() if hasattr(t, "to_local") else t  # noqa: E731
    for full, part in zip(sharding.state_leaves(cache), sharding.state_leaves(prefill)):
        full, part = local(full), local(part)
        if full.shape == part.shape:
            full.copy_(part)
        else:
            full[:, :, :part.shape[2]].copy_(part)


def _placed_family(torch, mesh, card, arch, cut, why) -> dict:
    """``arch`` at phase 26's cut (bf16, random weights from a seed) served
    placed on the host mesh beside the same parameters unplaced: the placed
    prefill's logits and cache bitwise the unplaced ones; PLACE_FAM_DECODE
    greedy steps through the placed engine's graph over a cache holding the
    prefill, each bitwise the unplaced engine's graphed step on the same
    tokens and the placed eager step from the same state (the recurrent
    states put back between the two, since a step advances them), with
    equal decode launches; PLACE_FAM_SLOTS + 1 requests through both
    engines' slots (the last in a recycled slot, its state zeroed at
    admission), the same tokens. The graphed step is timed in turns and
    profiled both ways. The launch counts cover the placed run."""
    import numpy as np

    from repro_torch.distributed import sharding
    from repro_torch.models.lm import build_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.engine import _whole_logits
    from repro_torch.timing import time_cuda

    tag = f"placement {arch}"
    model = build_model(_family_cfg(arch, **cut))
    cfg = model.cfg
    B, P, N = PLACE_FAM_SLOTS, PLACE_FAM_PROMPT, PLACE_FAM_DECODE
    mode = sharding.parallelism_for(cfg, "decode", B, mesh)
    sharding.set_parallelism(mode)
    params, out = _init_lm(torch, model, seed=28)
    gen = torch.Generator(device="cuda").manual_seed(2802)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, P), device="cuda", generator=gen)}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn((B, cfg.n_frames, cfg.d_model), device="cuda",
                                      generator=gen).to(torch.bfloat16)
    want, wcache = model.prefill(params, batch)
    placed = sharding.distribute_params(params, mesh, cfg.fsdp)
    _reset_counts()   # the placed path, counted
    got, gcache = model.prefill(placed, batch)
    if not (torch.equal(got.full_tensor(), want) and _bitwise(
            [t.full_tensor() for t in sharding.state_leaves(gcache)],
            sharding.state_leaves(wcache))):
        raise AssertionError(f"{tag}: the placed prefill's logits or cache are not bitwise "
                             f"the unplaced prefill's")
    with _counts_held():   # its graph's warm-up is not the placed path's
        plain = ServeEngine(model, params, slots=B, max_len=PLACE_FAM_MAX_LEN)
    eng = ServeEngine(model, placed, slots=B, max_len=PLACE_FAM_MAX_LEN)
    _fill_cache(plain.cache, wcache)
    _fill_cache(eng.cache, gcache)
    del wcache, gcache
    eager = _whole_logits(model.decode_step)
    states = [t.to_local() for e in (eng.cache if isinstance(eng.cache, list) else ())
              if isinstance(e, dict) for t in e.values()]
    tok = want[:, -1].argmax(-1, keepdim=True).int()
    launches = []
    for i in range(N):
        step = {"tokens": tok, "pos": torch.full((B,), P + i, dtype=torch.int32, device="cuda")}
        with _counts_held():   # the unplaced engine's step is not the placed path
            lp = plain._decode(params, plain.cache, step)[0].clone()
        before = [t.clone() for t in states]
        c0 = _read_counts()["decode_attention"]
        lg = eng._decode(placed, eng.cache, step)[0].clone()
        c1 = _read_counts()["decode_attention"]
        after = [t.clone() for t in states]
        for t, b in zip(states, before):
            t.copy_(b)
        le = eager(placed, eng.cache, step)[0]
        c2 = _read_counts()["decode_attention"]
        launches.append((c1 - c0, c2 - c1))
        if not (torch.equal(lg, lp) and torch.equal(lg, le) and _bitwise(states, after)
                and c1 - c0 == c2 - c1 == _attn_layers(model)):
            raise AssertionError(
                f"{tag}: placed graphed decode step {i} is not bitwise the unplaced graphed "
                f"step ({(lg - lp).abs().max().item()}) and the placed eager step "
                f"({(lg - le).abs().max().item()}), or its launches {launches[-1]} are not "
                f"{_attn_layers(model)} each")
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{tag}: non-finite decode logits")
        tok = lg[:, -1].argmax(-1, keepdim=True).int()
    rng = np.random.default_rng(28)
    specs = [(int(rng.integers(8, 33)), int(rng.integers(8, 17))) for _ in range(B + 1)]
    served = {}
    for name, e_ in (("unplaced", plain), ("placed", eng)):
        reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).tolist(), max_new_tokens=k)
                for n, k in specs] if name == "unplaced" else [
            Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens) for r in served["unplaced"]]
        with (_counts_held() if name == "unplaced" else contextlib.nullcontext()):
            e_.run(reqs)
        if not all(r.done and len(r.output) == r.max_new_tokens for r in reqs):
            raise AssertionError(f"{tag}: a request was not served to its length")
        served[name] = reqs
    if [r.output for r in served["placed"]] != [r.output for r in served["unplaced"]]:
        raise AssertionError(f"{tag}: the placed engine served other tokens than the unplaced "
                             f"one through a recycled slot")
    out["launches"] = _read_counts()
    step = {"tokens": tok, "pos": torch.full((B,), P + N, dtype=torch.int32, device="cuda")}
    times = {}
    for name in ("unplaced", "placed", "placed", "unplaced"):   # in turns
        e_, p_ = (plain, params) if name == "unplaced" else (eng, placed)
        times.setdefault(name, []).append(time_cuda(
            lambda t, e_=e_, p_=p_: e_._decode(p_, e_.cache, step), tok, iters=20, warmup=2))
    for name in ("placed", "unplaced"):   # where the placed step's time goes
        e_, p_ = (plain, params) if name == "unplaced" else (eng, placed)
        out[f"{name}_graph_profile"] = _profile_step(
            torch, lambda t, e_=e_, p_=p_: e_._decode(p_, e_.cache, step), tok)
    out.update({"cut": why, "mode": mode, "slots": B, "prompt": P, "decode_steps": N,
                "step_launches": launches, "requests": len(specs),
                "tokens": [r.output for r in served["placed"]],
                "graph_step_ms": {k: min(v) for k, v in times.items()},
                "graph_step_ms_turns": times})
    log(f"[placement] {cfg.name} bf16 ({why}; {out['params']} params), placed on the host "
        f"mesh ({mode}): prefill of {B} x {P} tokens bitwise the unplaced (logits and "
        f"cache); {N} decode steps through the placed engine's graph, each bitwise the "
        f"unplaced engine's graphed step and the placed eager step, decode launches "
        f"{launches[0][0]} a step both ways; {len(specs)} requests through {B} slots (one "
        f"recycled) served the unplaced engine's tokens")
    log(f"[placement] {cfg.name}: a graphed decode step at {B} slots, pos {P + N} (CUDA "
        f"events, 20 replays, in turns): placed {out['graph_step_ms']['placed']:.4f} ms, "
        f"unplaced {out['graph_step_ms']['unplaced']:.4f} ms; on {card}")
    for name in ("placed", "unplaced"):
        _log_profile(f"{tag} {name} graph", out[f"{name}_graph_profile"])
    del eng, plain, placed, params, served, e_, p_
    gc.collect()
    torch.cuda.empty_cache()
    sharding.set_parallelism("tp")
    return out


def phase_placement(torch) -> dict:
    """Phase 28: the LM state placed (see the module docstring)."""

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    procs = _dryrun_procs()   # on the host's cores, while the card works
    try:
        gc.collect()
        torch.cuda.empty_cache()
        out = {"nvidia_smi": _smi()}
        card = out["nvidia_smi"]
        out["lse"] = _lse_check(torch)
        out["combine"] = _two_half_combine(torch)
        owned = not dist.is_initialized()
        mesh = make_host_mesh()
        out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        log(f"[placement] host mesh {out['mesh']} over {dist.get_world_size()} "
            f"{dist.get_backend()} rank; card {card}")
        try:
            # the families first: placed Jamba (~62 GiB at its peak, its
            # one-rank gathers copies beside the weights) needs the card as
            # the build leaves it
            out["families"] = {}
            for arch, cut, why in PLACE_FAMILIES:
                out["families"][arch] = _placed_family(torch, mesh, card, arch, cut, why)
            gc.collect()
            torch.cuda.empty_cache()
            out["serve"] = _placed_serve(torch, mesh, card)
            gc.collect()
            torch.cuda.empty_cache()
            out["train"] = _placed_train(torch, mesh, card)
            gc.collect()
            torch.cuda.empty_cache()
            arch, seq, batch = PLACE_XLSTM_TRAIN
            out["train_xlstm"] = _placed_train(torch, mesh, card, arch, seq, batch)
            torch.cuda.synchronize()
        finally:
            gc.collect()
            if owned:
                dist.destroy_process_group()
            torch.cuda.empty_cache()
    finally:
        out_dry = _dryrun_results(procs)
    out["dryrun"] = out_dry
    return out


def main(argv) -> int:
    # cuBLAS is deterministic only with a fixed workspace, set before it starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if argv[:1] == ["--gloo-rank"]:   # one rank of phase 27's two-process run
        opts = dict(zip(argv[::2], argv[1::2]))
        return gloo_worker(int(opts["--gloo-rank"]), int(opts["--gloo-world"]),
                           int(opts["--gloo-port"]), opts["--gloo-out"])
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    # every phase but 22 runs on an empty autotune cache: the cold plans
    cold_cache = os.path.join(ROOT, "build", "autotune_cold.json")
    os.makedirs(os.path.dirname(cold_cache), exist_ok=True)
    with open(cold_cache, "w") as f:
        json.dump({"version": 4, "entries": {}}, f)
    os.environ["REPRO_AUTOTUNE_CACHE"] = cold_cache
    t_start = time.perf_counter()
    seconds = {}

    def run(name, fn, *args, **kwargs):
        """``fn(...)``, its wall seconds kept under ``name`` and logged."""
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
        log(f"[seconds] {name} {seconds[name]:.1f} s "
            f"({time.perf_counter() - t_start:.1f} s in all)")
        return result

    dev = run("1 device", phase_device, torch)
    build = run("2 build", phase_build)
    # on the card as the build leaves it: the placed training's two states
    # and graphs do not fit in what the later phases leave fragmented
    placement = run("28 placement", phase_placement, torch)
    _reset_counts()   # the later phases count from zero, as after the build
    worst = run("3 check", phase_check, torch)
    times = run("4 times", phase_times, torch)
    profiled = run("4 profile", phase_profile, torch)
    engine = run("5 engine", phase_engine, torch)
    projection = run("5 projection", phase_projection, torch)
    rgb_head = run("5 rgb head", phase_rgb_head, torch)
    serving = run("6 serving", lambda: phase_serving(torch)
                  + phase_serving(torch, eager=True))
    worst.update(run("7 bwd", phase_bwd_check, torch))
    grads = run("8 autograd", phase_autograd, torch)
    bwd_times = run("9 bwd times", phase_bwd_times, torch)
    pair_worst, pair_clusters = run("10 pair check", phase_pair_check, torch)
    worst.update(pair_worst)
    pair_times = run("11 pair times", phase_pair_times, torch)
    fused_engine = run("12 fused engine", phase_fused_engine, torch)
    fused_serving = run("12 fused serving", phase_serving, torch, fuse="force")
    pair_grads = run("13 pair autograd", phase_pair_autograd, torch)
    decode_check = run("14 decode check", phase_decode_check, torch)
    worst["decode_attention"] = decode_check["worst"]
    decode_times = run("15 decode times", phase_decode_times, torch)
    lm_serve = run("16 LM serve", phase_lm_serve, torch)
    lm_parity = run("17 LM parity", phase_lm_parity, torch)
    # the LM families need up to ~62 GB at once: they run while the card's
    # memory is as phases 16-17 leave it, before the GAN phases' graphs
    families = run("26 LM families", phase_lm_families, torch)
    zoo = run("18 zoo", phase_zoo_check, torch)
    paper = run("19 paper", phase_paper, torch)
    train = run("20 train", phase_train, torch)
    obs_replicas = run("21 obs", phase_obs, torch, dev,
                       engine["eager_launches_per_bucket"], train)
    tuned = run("22 autotune", phase_autotune, torch, dev, cold_cache)
    graph_failure = run("23 graph failure", phase_graph_failure, torch)
    distribution = run("27 distribution", phase_distribution, torch)
    lm_train = run("24 LM train", phase_lm_train, torch)
    entry = run("25 entry points", phase_entry_points)

    entries = []
    for name in FORWARD:   # launches: the serving run of phase 5
        rows = [r for r in times["layers"] if r["path"] == name]
        entries.append(_entry(
            name, engine["launches"][name], worst[name], rows,
            lambda r, k, n=name: r["library_ms" if k == "_library_ms" else n + k],
            lambda r: r))
    # launches: the phase-pinned gradient run and the fused engine's replay
    entries.append(_entry("phase", pair_grads["launches"]["phase"]["phase"],
                          worst["phase"], pair_times["layers"],
                          lambda r, k: r["library_ms" if k == "_library_ms" else "phase" + k],
                          lambda r: r))
    entries.append(_entry("pair", fused_engine["launches"]["pair"], worst["pair"],
                          pair_times["pairs"],
                          lambda r, k: r["library_ms" if k == "_library_ms" else "pair" + k],
                          lambda r: r))
    for name in ("epilogue_grad", "dx", "dw"):   # launches: the 6-step training run
        entry = _entry(name, train["launches_6_steps"][name], worst[name], bwd_times,
                       lambda r, k, n=name: r[n + k], lambda r, n=name: r["bounds"][n])
        if name == "epilogue_grad":
            # the training path runs it folded into dx and dw: its launches
            # are those (the standalone kernel's, 0, beside them), its times
            # the standalone kernel's, with both routes' of the same run
            folded = train["launches_6_steps"]["epilogue_grad_folded"]
            entry.update({
                "launches": entry["launches"] + folded,
                "standalone_launches": entry["launches"], "folded_launches": folded,
                "folded_into": "dx_kernel, dx_poor_kernel<R>, dw_kernel<BM,BN>, "
                               "dw_poor_kernel<R> (act != 0); standalone "
                               "epilogue_grad_kernel",
                "three_kernel_route_ms": sum(r["route_three_ms"] for r in bwd_times),
                "folded_route_ms": sum(r["route_folded_ms"] for r in bwd_times),
                "three_kernel_route_graph_us": sum(r["device_us"]["route_three"]
                                                   for r in bwd_times),
                "folded_route_graph_us": sum(r["device_us"]["route_folded"]
                                             for r in bwd_times),
            })
        entries.append(entry)
    # launches: the LM serving runs (phase 16's and phase 26's graphed
    # serving and greedy decodes, phase 28's placed decodes); numbers:
    # Llama-3-8B, S 4096, device-only
    d4k = decode_times[0]
    source, replaces = SOURCES["decode_attention"]
    entries.append({"name": "decode_attention", "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": (lm_serve["launches"]["decode_attention"]
                                 + families["decode_launches"]
                                 + placement["serve"]["launches"]["decode_attention"]
                                 + sum(f["launches"]["decode_attention"]
                                       for f in placement["families"].values())),
                    "max_abs_err": decode_check["llama_4k"], "ms": d4k["ms"],
                    "plain_ms": d4k["plain_ms"], "bound_ms": d4k["bound_ms"],
                    "bound_by": d4k["bound_by"], "library_ms": d4k["library_ms"],
                    "lse_ms": placement["lse"]["times"]["ms"],
                    "lse_plain_ms": placement["lse"]["times"]["plain_ms"],
                    "lse_max_abs_err": placement["lse"]["lse_worst"]})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": dev, "fused_ptxas": build["fused_ptxas"],
                   "ptxas": build["ptxas"], "pair_clusters": pair_clusters,
                   "kernels": entries, "times": times,
                   "profile": profiled, "engine": engine, "projection": projection,
                   "rgb_head": rgb_head,
                   "serving": serving, "max_abs_err": worst, "grads": grads,
                   "bwd_times": bwd_times, "pair_times": pair_times,
                   "fused_engine": fused_engine, "fused_serving": fused_serving,
                   "pair_grads": pair_grads, "decode_check": decode_check,
                   "decode_times": decode_times, "lm_serve": lm_serve,
                   "lm_parity": lm_parity, "zoo_check": zoo, "paper": paper,
                   "train": train, "obs": obs_replicas, "autotune": tuned,
                   "graph_failure": graph_failure, "lm_train": lm_train,
                   "entry_points": entry, "lm_families": families,
                   "distribution": distribution, "placement": placement,
                   "phase_seconds": seconds,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
