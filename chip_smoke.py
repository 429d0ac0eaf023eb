#!/usr/bin/env python3
"""Drive the PyTorch port's control tick (cold and steady-state), its serving
pool and replay CLI, its language and tactile encoders, GelSight force
sequences and warm-replan quality, its episode data path (capture,
distillation, ``.epc`` caches, training from them), its residual
controllers' training and evaluation, the README's two walkthroughs
(``examples/torch_full_pipeline.py``, ``torch_planning_pipeline.py``),
RDT-1B finetuning, its planner and the planner's LLM training, the
planner's VLM, the training and evaluation of the planner's tactile
encoder, and multi-device training and serving (world 1 over NCCL, two
ranks sharing the card over Gloo) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``vla_touch_tpu_torch/csrc``
   (one nvcc per source, in parallel), prints ptxas's register and spill
   lines of K1's, K8's and K2's kernels (and fails on a spill) and the
   card's name and power limit.
2. Holds each kernel against its plain PyTorch version on the card at every
   shape the tick gives it (K1 flash attention: SigLIP, DinoV2 and the three
   RDT-1B attentions, plus a ragged and a fully masked language mask, with
   q/k/v laid out as the modules pass them, and head dims 8, 12, 20, 96,
   128 and the walkthroughs' shapes; K2 fused residual block: the 12
   BRIDGeR block shapes, the 12 at horizons 64 and 48 (three and four m16
   time tiles), and check-only at horizon 32) and times kernel,
   plain version, a library yardstick (SDPA for K1) and the bound.  Kernel,
   plain and library times are device times (calls captured in a CUDA
   graph and replayed); the eager back-to-back loop, which the host's
   per-call work bounds at batch 1, is printed beside them.  The
   ``kernels`` line sums each time over the calls of one tick.
3. Runs the full-width cold tick with seeded random weights — SigLIP-so400m
   on 6 frames -> RDT-1B 5-step chunk -> DinoV2-small pair + GelSight marker
   force -> BRIDGeR 10-step refine — through the entry points a user calls,
   with the launch counts zeroed just before and read just after; then the
   same tick through the plain versions, and the stage correlations; then
   a checked tick, in which every K1 and K2 call is held to its plain
   version on the tick's own operands; then the tick's p50, and its stage
   times from ticks that synchronise after each stage.
   One more tick runs under ``torch.profiler``: the device's busy time,
   its idle share and the kernels with the most time.
4. Holds the int8/int4 serving kernels against their plain versions at
   every shape the quantized tick gives them (K6 a8w8 and K8 w4a8 at the
   eight (M, K, N) linears; K3 and K4, flash attention over the int8 K/V
   cache in its two layouts, at the image and ragged-language shapes, plus
   check-only shapes at a fully masked row and at the kernel's split
   boundaries), timed as K1 is, with ``torch._int_mm`` (K6's GEMM
   alone) and SDPA on the dequantized bf16 cache (K3/K4) as yardsticks.
   Then the two kernels no module dispatches, as the JAX package
   dispatches neither: K7 (``a8w8_matmul_large``) at the 4374-token
   condition products (the image adaptor and the image K/V projection),
   with ``torch._int_mm`` as yardstick, and K5 (``w8a16_matmul``) at the
   eight linears and the planner's M = 1 int8 linears, with ``F.linear``
   on bf16 weights dequantized ahead of time as yardstick.
5. Runs the quantized tick (RDT-1B quantized on the card from the same
   seeded bf16 runner, same inputs and noise) in six configurations:
   (a) int8 weights + int8 K/V cache (K3), (b) int8 + transposed int8 cache
   (K4), (c) int8 + int8x cache (dequantized, K1), (d) int4 fc1/fc2 and
   int8 elsewhere + bf16 cache, (e) int4 weights, chunk only, (f) as (a)
   with int8 condition K/V projections (``kv_proj='int8'``).  Each is run
   with the launch counts zeroed before and read after (and asserted; K5
   and K7 must make none), then through the plain versions (corr gates),
   then as a checked tick (every K1-K4, K6, K8 call against its plain
   version on its own operands; in (a) and (f) also K5 on every K6 call's
   operands and K7 on every plain ``qdense`` call at M > 512, 870 and 2 or
   16 shadow calls); the int8 chunks are held to the bf16 tick's chunk
   (corr > 0.999).  One more tick goes through
   ``create_model(rdt=...).step``.  Configuration (a) is timed by stage and
   profiled, and (b) profiled.  The checked ticks also hold K2's output
   channels and K3/K4's (row, head) vectors each to its own norm.
6. The steady-state tick, in bf16 and in (a): ``create_model(...,
   cache_frames=True).step(prior_actions=, skip_steps=2)`` on a moving
   scene, the prior the previous cold chunk shifted by 16 ticks and padded,
   as the chunk scheduler shifts it.  The launch counts of the seeding call
   and of a call that hits the frame-token cache are asserted, then the
   kernel tick against the plain tick, a checked tick, ``skip_steps=0``
   against the cold chunk (bit for bit), the warm-vs-cold chunk corr at
   skips 3, 2 and 1 (printed: the weights are random), the p50 at skip 2
   in turns with the cold tick and at the largest skip above 0.999, stage
   times and a profile.  Then SigLIP's serving twin in bf16 and int8 on 3
   and 6 frames (token corr gates, K1's launches, ms beside the module's)
   and one warm tick through each, and the reference-style chunk (the full
   model every step, K1 280 launches) against the cached chunk.
   Then the deployment entry points.  ``serving_phase``: the multi-robot
   pool (``runtime/serving_pool.py::from_policy``) on the bf16 runner and
   on the int8 twin, one batch per bucket (1, 2, 3 and 7 requests into
   buckets 1, 2, 4, 8; instructions of 20-64 tokens padded to 1024), its
   launches asserted (K1 307; the twin's K6 868, and 18 at bucket 8 where
   the blocks' linears pass 512 rows), every row equal to the direct
   batched ``policy_step`` on the same padded batch and noise bit for bit
   and held to the request alone at bucket 1 (corr > CHUNK_CORR_MIN), the
   int8 rows to the bf16 rows (> INT8_CHUNK_CORR_MIN), each batch also a
   checked run; then 8 robot threads x 4 requests with the 3 ms window
   (requests/s, latency p50/p95, buckets dispatched, batch ms).
   ``replay_phase``: an npz episode, the bf16 runner written as an
   HF-layout safetensors checkpoint (validated against the rdt_1b
   manifest, read back bit for bit; bytes and seconds), BRIDGeR and LSTM
   checkpoints, then ``replay_cli.main`` for 48 steps with the refiner
   none, bridge (warm skip 2) and lstm (launch and stage counts asserted)
   and one bridge replan as a checked run.
7. The residual controllers (``controllers_phase``): BRIDGeR (``down_dims``
   (256, 512, 512), hidden 256, force and the DinoV2-small pair at 384^2)
   and the LSTM controller (hidden 256, 2 layers) trained 30 steps each at
   horizon 32 and the trainers' batch sizes (128, 256) through their
   trainer classes on seeded windows held in memory (launch counts
   asserted: K1 in DinoV2), the loss fall gated, TF32 as the trainers set
   it (off); one ``prepare_batch`` of each trainer at its batch size as a
   checked run (every K1 call against its plain version); one step on the
   card against the port's CPU step; both checkpoints through the
   port's msgpack writer and reader, bit for bit; ``bridge_test`` ('vs' and
   'bs') and ``lstm_step_test`` with their launch counts and as checked
   runs (every K1/K2 call against its plain version); the LSTM's
   step-by-step rollout against its sequence mode; step ms, samples/s,
   peak memory, the DinoV2 share of a step and the refine ms.
   Then RDT finetuning (``rdt_train_phase``): RDT-1B at full width and
   RDT_DEPTH blocks and SigLIP So400m at batch 4 x accumulation 4 on seeded
   synthetic npz episodes (384^2 frames, a 32-token instruction) through
   ``RDTTrainer.train`` for RDT_STEPS steps, one sampling eval and the final
   checkpoint, with K1's launches asserted a step (SigLIP 27, then 2 a block
   in each micro-batch) and for the eval (2 a block a solver step); before
   it K1's autograd route against the plain autograd at
   the three RDT training shapes and a depth-2 card step against the CPU
   step; after it the probe's loss fall (gated), the checkpoint read back
   bit for bit, JAX's committed two-process orbax checkpoint read to its
   npz, the state written as ``state.orbax``, resumed from it in place
   through ``load_checkpoint`` and held against the written trees bit for
   bit, one step from that state as a checked run and one profiled; step
   ms, samples/s, TFLOP/s, SigLIP's share, optimizer ms, both checkpoints'
   bytes and seconds, libzstd's version, peak memory.  K1_SHAPES carries
   the training shapes, timed per step.
8. The planner: holds K9 (w4 SwiGLU MLP) and K10 (w4 post-attention) at
   Qwen2.5-7B width (M 1, 8, 24 and 1, 8), K8 at the planner's w4 linears
   (decode and prompt-pass M; per prompt pass of 72 and 442 tokens summed,
   with ``torch._int_mm`` at the same shapes as a yardstick of the int8
   rate), K6 at the int8 request's linears and K1 at
   CLIP ViT-B/16's self-attention against their plain versions, timed as
   above; builds the planner at full width from seeded weights
   (Qwen2.5-7B in grouped int4, quantized layer by layer, its fused twin and
   an int8 tree; CLIP ViT-B/16 with adapters and classifier; the
   projector) and serves ``describe``, ``guess``, ``ask`` (a 24-token
   prompt, so K9 runs in the prompt pass) and ``reason_llm`` (a greedy
   turn, then best-of-8 sampling) on the fused tree with ``MEGAKERNELS`` on,
   PLAN_TOKENS new tokens each, with the K1/K8/K9/K10 launches asserted from the
   code, plus one int8 request (K6); then the tactile feature corr and the
   teacher-forced per-step logits corr against the plain versions; every
   request again at 2 tokens (the int8 request too) with each kernel
   call held to its plain version on its own operands; the decode tiers
   (unfused, fused, fused + megakernels),
   best-of-8 throughput and a profiled decode.
   Then the planner's LLM training (``llm_train_phase``) on the same
   fused w4 tree and CLIP encoder: PR 16's seeded PhysiCLeAR tree, its QA
   flattened by ``chat_rows_to_llm_rows`` (LLM_ROWS rows, 150-495 tokens)
   and two short rows (22 tokens); ``train_projection_and_lora`` (rank 8
   on the seven targets, lr 1e-3, 3 epochs) with every step's launches
   asserted from the code (K8 on each w4 linear and the lm_head at M <=
   512 under ``W4A8MatmulFn``, none above; K1 per encoded video), the loss
   fall gated, the frozen base bit for bit, the B factors moved, both
   msgpack files read back bit for bit; one step as a checked run, one with
   the backwards (the plain vjp) timed, one profiled; ``test_llm`` with the
   adapter in bf16 (launches asserted); ``train_projection`` on the short
   rows (K9 in every layer under ``W4SwigluFn``, K8 on qkv, o and the
   lm_head), a checked and a timed step, its file, ``test_llm`` (K9, K10);
   a depth-2 step on the card against the CPU's; step times, peak memory.
9. The planner's VLM (``vlm_phase``): K1 at the Qwen2-VL vision tower's
   shapes (frames as the batch, 1024 patches, 16 heads of 80; one 448^2
   image, and a 448^2 beside a 336^2 one with its keys masked past 576),
   timed beside SDPA; Qwen2-VL-7B built at full width and depth from
   seeded weights (the decoder in grouped int4 layer by layer, its fused
   twin and an int8 tree; the tower as float32 copies of bf16-rounded
   weights); request A (one image, 64 greedy tokens) and request B (both
   images in one tower run, VLM_TOKENS tokens) on the fused tree with
   ``MEGAKERNELS`` on, request C (A on the int8 tree, 16 tokens), each
   with its launches asserted from ``planner_launches`` (K1 one per vision
   block a tower run; K8/K9/K10 per prompt pass and step, none in a prompt
   pass above 512 rows; K6 per int8 linear); the vision-token corr against
   the tower with float32 attention and the teacher-forced logits corr at
   the M-RoPE positions; A, B and C at 2 tokens as checked runs;
   the tower ms, TTFT and decode ms a token; a three-turn planner session
   (``PlannerSession``, the VLM over request A's image and the messages,
   feedback from the marker-tracked force of a GelSight frame and the
   tactile service's ``describe``), its log, launches and its
   ``trial_row`` re-driven through ``replay_trial``; and an HF-layout
   checkpoint at full width cut to 2 decoder layers and 2 vision blocks,
   written by the port's writer, checked against the qwen2_vl_7b manifest
   and read back in bf16, int4 and int8 bit for bit.
10. The planner's tactile encoder (``tactile_encoder_phase``): K1's
   autograd route against the plain autograd at the contrastive step's
   shapes (32 frames, 201 and 197 tokens, 12 heads of 64); a seeded raw
   PhysiCLeAR tree (16 train and 4 test objects, both procedures, 8 frames
   of 240 x 320) through ``extract_physiclear``, ``build_samples_json``,
   both PhysiCLeAR QA generators, ``write_qa_file`` and
   ``TactileLLMDataset``; ``train_vificlip_contrastive`` at full width
   (CLIP ViT-B/16 and the B/16 text tower, 4 prompts to depth 9, the
   512-wide projections; batches of 8 videos x 4 frames with seeded
   captions, lr 1e-4, 20 steps, text frozen) with K1's launches asserted
   (one a vision block a step, none in the text tower), the loss fall
   gated, the frozen text tower bit for bit, one step as a checked run, a
   depth-2 step against the CPU's, the step's p50, videos/s and a profile
   (K1's share of the device time); then ``train_property_encoder`` and
   ``evaluate_encoder`` on the processed samples (launches asserted, the
   metrics printed) and the saved encoder read back bit for bit, serving
   the same features; the peak memory.
11. The encoders off the tick and the offline tools (``encoders_phase``,
   right after the replay): T5-XXL (seeded, bf16, 9.5 GB, built on the
   card) through ``LanguageEncoder(NativeT5Embedder(...))`` on instructions
   of 8-64 byte tokens and one of 1024, the dict saved and read back, one
   embedding as the language of a cold bf16 RDT-1B ``policy_step`` (K1 307),
   encode ms at 32 and 1024 tokens, and the 2-layer cut on the card in bf16
   against float32 on the CPU (gated; two planted bucket-bias faults must
   fail the gate); Sparsh ViT-B/16 on 32 frame pairs of 240^2 x 6 (K1 12,
   CLS corr against the plain-version encoder, a checked run, ms, K1's
   share, K1 at (32, 226, 12, 64) against its plain version and SDPA);
   ``estimate_force_sequence`` on 600 GelSight frames of 240 x 320 in the
   standard and HSR modes against the planted shifts and per-frame
   ``estimate_force`` (bit for bit), frames/s; the warm-replan quality
   protocol (``eval/warm_quality.py``) in bf16: K1 at its training and
   solver shapes (D 32) against its plain version and SDPA, the run's
   asserts and K1's launches, and one training step and one cold and warm
   chunk as a checked run.
12. The episode data path (``data_phase``, right after the encoders): a
   capture directory written with OpenCV (3 episodes of 40 steps, two
   480 x 640 cameras, GelSight 240 x 320 with planted marker shifts),
   ``precompute_instructions`` with T5-XXL (bf16, 4096 wide),
   ``process_gelsight`` on the card (within FORCE_TOL px of the plant),
   ``convert_to_hdf5`` to npz, the distillation pass over every timestep
   with the tick's RDT-1B and SigLIP policy (K1 asserted: the cold tick
   without refine per timestep; one tick a checked run), ``pack_dataset``
   in both codecs (bytes against npz) and with ``--use_resized``; frames/s
   of nvJPEG into device memory, nvJPEG plus the copy to the host and
   ``cv2.imdecode`` on the host's threads (a yardstick), nvJPEG's frames
   against cv2's; the consumer's samples/s from npz and ``.epc`` at 0 and 4
   threads; ``rdt_loop`` (RDT-1B) and ``bridge_train`` (DinoV2 on K1, 2
   prefetch threads) from ``.epc``, K1 asserted, their losses equal to the
   npz runs' step by step; ``process_dataset`` from both.
   Then the README's walkthroughs (``examples_phase``, under
   ``build/examples``): both through their own ``main`` on the card, each
   stage's seconds, launches by kernel and K1's by head dim, the JAX
   walkthrough test's assertions; one walkthrough tick and one BRIDGeR
   evaluation batch as checked runs, and each against float32 plain
   attention (corr); and BRIDGeR at its deployment width
   over the 64-step chunk (10 SDE steps, K2 120) against the plain UNet
   path (corr) and as a checked run.
13. Multi-device training and serving (``parallel_phase``, after the
   tactile encoder): K1 at the 16-head TP shapes against its plain version
   and SDPA; RDT-1B at full depth through ``rdt_loop.main`` with
   ``--coordinator`` at world 1 over NCCL (in this process, each run
   starting and destroying its group), ZeRO-2 and ``--zero3``, losses and grad norms
   equal to the one-device run's bit for bit and K1 a step asserted; two
   ranks sharing the card over Gloo (``--parallel-rank``; PAR_DEPTH blocks
   at full width): DP2 ZeRO-2 / ZeRO-3 and TP2 steps against one process, the
   ZeRO-3 checkpoint gathered, written by rank 0 and read back, TP2
   serving, a checked TP2 step and chunk, the planner's TP2 decode (tokens
   equal) and T5's TP2 encode against float32.
14. Prints one ``kernels`` JSON line (ten kernels; K1's launches are the
   tick's, the serving pool's, the replay's, the controllers phase's, RDT
   finetuning's, the VLM's, the tactile encoder's, the T5-embedded tick's,
   Sparsh's, the warm-quality run's, the data path's (distillation, RDT-1B
   and BRIDGeR from ``.epc``), the parallel path's and the walkthroughs',
   K2's the tick's, the replay's, the controllers' and the walkthroughs'
   (with the horizon-64 refine), K6's tick (a)'s, the serving pool's and the VLM's, K8's
   tick (e)'s, the VLM's and the LLM training's, K9's and K10's the
   planner's, the VLM's and the LLM training's,
   each path counted from 0 (``launches_by_path``); K1 also carries its
   sums over an RDT training step's calls (``train_step``) and over a
   contrastive step's (``contrastive_step``), K8 over a LoRA step's
   (``llm_train_step``) and K8's and K9's backward ms a step;
   K5's and K7's are the shadow calls of (f)'s checked tick), a line of
   every phase's wall seconds before it, the ``nvidia-smi`` line, and as
   the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, without a result line, when CUDA is absent, when the port
package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (data sheet)
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor cores
INT8_OPS = 1979e12                 # H100 SXM dense int8 tensor cores
L2_BYTES = 50 * 1024 * 1024

# K1's max abs error is held to K1_TOL x max|plain| at each shape, since the
# outputs' scale runs from ~0.13 (4374 keys) to ~2 (64 keys).  The
# kernel's output and its p in p.v are bf16 (2^-8 relative): a sound kernel
# reads 2e-3..6e-3 of the max, one KV tile dropped or the mask ignored
# 0.17..0.82 (tools/torch_k1_fault_control.py).
K1_TOL = 2e-2
# K2 at the block shapes, on N(0, 1) inputs: bf16 output of O(1..5)
# activations vs the f32 plain version, max abs error.
K2_TOL = 3e-2
# K2 on the tick's own operands (checked_tick), whose scale the random-weight
# chunk sets (outputs reach the hundreds): max abs error <= K2_TICK_TOL x
# max|plain|, as K1's.
K2_TICK_TOL = 2e-2
# A second, tighter measure on the checked tick, beside the gates above: the
# error's norm in each group of a kernel's outputs against that group's own
# norm, the worst group of the worst call <= GROUP_TOL.  Groups: K2's output
# channels (over the batch and time), K3/K4's (row, head) vectors.  On the
# tick, where a few large outputs set max|plain|, those gates read K2's
# FiLM-ignored and one-split GroupNorm faults at 0.46 and 0.20 and a dropped
# K3/K4 image tile at 0.47 of their tolerance.  This one reads sound K2 at
# 3.9e-3 and the two faults at 0.204 and 0.0214; sound K3/K4 at 2.7e-3, the
# last (22-key) image tile dropped at 7.2e-3 and a whole 64-key tile at
# 1.3e-2 (tools/torch_k2_fault_control.py, tools/torch_quant_fault_control.py;
# the RMS over groups in place of the worst group separated both less).  A
# group whose norm is under a tenth of the groups' RMS norm is measured
# against that tenth (a channel near 0 has no scale of its own).
K2_GROUP_TOL = 1e-2
Q8_GROUP_TOL = 4.5e-3
# Kernel tick vs plain tick.  SigLIP tokens and DinoV2 features read
# 0.99993-0.99995 sound and 0.9991-0.9993 with K1's last KV tile dropped.
# The chunk and refined actions are compared divided by the action scale
# (action_corr); on robot units the gripper's 255 hid a K6 fault that cost
# the chunk 3.5 % of its corr with the bf16 chunk
# (tools/torch_quant_fault_control.py).  checked_tick holds every kernel
# call of the tick to its plain version.
TOKEN_CORR_MIN = 0.9998
CHUNK_CORR_MIN = 0.9995
REFINED_CORR_MIN = 0.9995
# K5-K8 max abs error <= QMM_TOL x max|plain| at each shape and on the
# tick's own operands: the int8 codes and int32 sums are exact, so only the
# bf16 rounding of the output (2^-8 relative) and the float32 order of K8's
# cross-group sum (K5's float32 sum) separate kernel and plain version.
QMM_TOL = 1e-2
# K6 and K7 compute what their plain versions compute, operation for
# operation: exact int8 codes and int32 sums, then the plain version's
# float32 epilogue in its order.  So every bf16 output must equal the plain
# float32 output rounded to bf16, per shape and on the tick's own operands
# (none unlike in any of 70 M outputs on an H100 at 700 W).  That sees a
# one-ulp fault QMM_TOL cannot: K7's rows scaled by amax / 127 in place of
# amax * (1/127) move 5-20 outputs per shape
# (tools/torch_quant_fault_control.py).
EXACT_KERNELS = ("K6", "K7")
# K3/K4 as K1: bf16 p and output against the float32 plain version.
Q8_TOL = 2e-2
# K9/K10 max abs error <= MK_TOL x max|plain| at each shape and on the
# planner's own operands: the x, att and h codes are exact, but the bf16
# g/u and activation round where the float32 sums of kernel and plain
# version (in other orders) straddle a rounding edge, the activation's int8
# quantization can move such an element by one code, and K10's bf16
# residual add makes one-ulp differences of up to 2^-7 of the output's max.
# Sound reads at most 0.41 of it; the nearest planted fault (K10's norm
# weight ignored) reads 1.4 x per shape at M 8
# (tools/torch_quant_fault_control.py).  The per-shape gate may sit that
# close because the same fault fails the checked decode (6 x) and the
# teacher-forced logits gate (0.976).
MK_TOL = 2e-2
# Planner, kernel run vs plain run: the tactile feature corr (K1 in the CLIP
# tower) and the teacher-forced per-step logits corr (K8/K9/K10).
FEATURE_CORR_MIN = 0.9998
LOGITS_CORR_MIN = 0.995
# The int8 chunk (configurations a-c, f) against the bf16 tick's chunk, on the
# actions divided by the policy's action scale: the JAX package's parity
# gate for its int8 tier (quant_serve.py:83-85).
INT8_CHUNK_CORR_MIN = 0.999


_T0 = time.perf_counter()


def log(*a):
    """A line of output, after the seconds since this module was loaded."""
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` call over ``reps`` back-to-back
    calls, CUDA events around the whole run."""
    import torch

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


def graph_time_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events.  Unlike
    :func:`cuda_time_ms` this leaves out the host's per-call work (Python
    wrapper, checks, allocation, launch), which at batch 1 is slower than
    the small kernels themselves."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    return ms


# replays of a plain version's captured calls when it is timed (its
# kernel's take the default 5)
PLAIN_REPLAYS = 2


def corr(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.corrcoef(a, b)[0, 1])


def action_corr(t, a, b) -> float:
    """corr of two action arrays (..., 10) divided by the policy's action
    scale: in robot units the gripper (scale 255) would stand for the
    whole chunk."""
    scale = np.asarray(t["pcfg"].state_scale, np.float32)
    return corr(a / scale, b / scale)


def hold(what, got, want, rel_tol, mask=None):
    """(max abs error, tolerance) of a kernel's ``got`` against its plain
    ``want``, the tolerance ``rel_tol`` x max|want|; raises on a miss, and
    when a query row that ``mask`` leaves no key is not 0."""
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max())
    tol = rel_tol * float(want.abs().max())
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"{what}: max abs err {err} > {tol} ({rel_tol} x max|plain|)")
    empty = mask is not None and not bool(mask.any(dim=1).all())
    if empty and float(got[~mask.any(dim=1)].float().abs().max()) != 0.0:
        raise AssertionError(f"{what}: fully masked rows must be 0")
    return err, tol


# kernel number -> (module under vla_touch_tpu_torch.ops, wrapper name)
WRAPPERS = {"K1": ("flash_attention", "flash_attention"),
            "K2": ("unet_kernels", "resblock_fused"),
            "K3": ("flash_attention_q8", "flash_attention_q8"),
            "K4": ("flash_attention_q8", "flash_attention_q8t"),
            "K5": ("quant_matmul", "w8a16_matmul"),
            "K6": ("quant_matmul", "a8w8_matmul"),
            "K7": ("quant_matmul", "a8w8_matmul_large"),
            "K8": ("quant_matmul", "w4a8_matmul"),
            "K9": ("w4_fused", "w4_swiglu_mlp"),
            "K10": ("w4_fused", "w4_postattn_fused")}


def wrapper_home(kernel):
    """(module, attribute name) of a kernel's wrapper."""
    import importlib

    mod, name = WRAPPERS[kernel]
    return importlib.import_module(f"vla_touch_tpu_torch.ops.{mod}"), name


def kernel_fns() -> dict:
    """The kernel wrappers by kernel number (each carries ``launches``)."""
    return {k: getattr(*wrapper_home(k)) for k in WRAPPERS}


def zero_counts():
    for fn in kernel_fns().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_fns().items()}


@contextlib.contextmanager
def swapped(**fns):
    """Put ``fns`` (kernel number -> stand-in) in the wrappers' places in
    their modules for the block."""
    where = {k: wrapper_home(k) for k in fns}
    orig = {k: getattr(*where[k]) for k in fns}
    for k, fn in fns.items():
        setattr(*where[k], fn)
    try:
        yield
    finally:
        for k, fn in orig.items():
            setattr(*where[k], fn)


@contextlib.contextmanager
def plain_kernels():
    """Route every wrapper to its plain version (comparison runs only)."""
    from vla_touch_tpu_torch.ops import flash_attention as FA
    from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ
    from vla_touch_tpu_torch.ops import quant_matmul as QM
    from vla_touch_tpu_torch.ops import unet_kernels as UK
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    def ref(x, cond, p, *, n_groups=8, eps=1e-5):
        return UK.resblock_ref(x, cond, p, n_groups=n_groups, eps=eps).to(x.dtype)

    with swapped(K1=FA.attention_plain, K2=ref, K3=FQ.attention_q8_plain,
                 K4=FQ.attention_q8t_plain, K6=QM.a8w8_plain, K8=QM.w4a8_plain,
                 K9=k9_plain, K10=k10_plain):
        yield


def k9_plain(x, gu, down):
    """K9's plain version on the operands its wrapper takes (x as bf16)."""
    import torch

    from vla_touch_tpu_torch.ops import w4_fused as W4F

    return W4F.w4_swiglu_plain(x.to(torch.bfloat16), gu, down)


def k10_plain(x, att, o, gu, down, norm_w, eps=1e-6):
    """K10's plain version on the operands its wrapper takes."""
    import torch

    from vla_touch_tpu_torch.ops import w4_fused as W4F

    bf16 = torch.bfloat16
    return W4F.w4_postattn_plain(x.to(bf16), att.to(bf16), o, gu, down, norm_w, eps)


def group_share(got, want, dims, group_tol) -> float:
    """The largest share of ``group_tol`` that any group's relative error
    takes: a group is one index of ``want``'s dimensions outside ``dims``,
    its error ||got - want|| / max(||want||, a tenth of the groups' RMS
    norm)."""
    e = (got.float() - want.float()).square().sum(dim=dims).sqrt()
    w = want.float().square().sum(dim=dims).sqrt()
    floor = 0.1 * float(w.square().mean().sqrt())
    if floor == 0.0:
        return 0.0 if float(e.max()) == 0.0 else float("inf")
    rel = float((e / w.clamp_min(floor)).max())
    return rel / group_tol if np.isfinite(rel) else float("inf")


def checked_run(run, shadow: bool = False) -> dict:
    """``run()`` with every kernel call also running its plain version on
    the same operands: the main path's own data, strides and masks.  Per
    kernel: the calls, and the call whose max abs error takes the largest
    share of its tolerance, rel_tol x max|plain| (K1_TOL, K2_TICK_TOL,
    Q8_TOL for K3/K4, QMM_TOL for K5-K8, MK_TOL for K9/K10); for
    EXACT_KERNELS also the bf16 outputs unlike the plain version's; for K2
    and K3/K4 also the largest :func:`group_share` (K2_GROUP_TOL,
    Q8_GROUP_TOL).

    ``shadow`` also holds K5 and K7, which no module dispatches, on the
    run's operands in their regimes: every K6 call's through K5, and every
    plain ``ops/quant.py::qdense`` call at M > 512 (the image adaptor, and
    the condition K/V projections of an int8 ``kv_proj``) through K7.  The
    run's own routing and outputs stay as they are."""
    import math

    from vla_touch_tpu_torch.ops import flash_attention as FA
    from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ
    from vla_touch_tpu_torch.ops import quant as Q
    from vla_touch_tpu_torch.ops import quant_matmul as QM
    from vla_touch_tpu_torch.ops import unet_kernels as UK
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    import torch

    seen = {k: dict(calls=0, share=0.0) for k in WRAPPERS}
    for k in EXACT_KERNELS:
        seen[k]["unlike"] = 0

    def note(kernel, got, want, rel_tol, group=None):
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        s = seen[kernel]
        s["calls"] += 1
        if kernel in EXACT_KERNELS:
            s["unlike"] += int((got != want.to(got.dtype)).sum())
        share = err / (rel_tol * scale) if np.isfinite(err) and scale > 0 else (
            0.0 if err == 0.0 else float("inf"))
        if share >= s["share"]:
            s.update(share=share, err=err, max_plain=scale, tol=rel_tol * scale)
        if group is not None:
            s["group_share"] = max(s.get("group_share", 0.0), group_share(got, want, *group))

    k1, k2 = FA.flash_attention, UK.resblock_fused
    k3, k4 = FQ.flash_attention_q8, FQ.flash_attention_q8t
    k6, k8 = QM.a8w8_matmul, QM.w4a8_matmul
    k9, k10 = W4F.w4_swiglu_mlp, W4F.w4_postattn_fused

    def k1_checked(q, k, v, kv_mask=None, scale=None):
        got = k1(q, k, v, kv_mask=kv_mask, scale=scale)
        note("K1", got, FA.attention_plain(q, k, v, kv_mask=kv_mask, scale=scale).float(),
             K1_TOL)
        return got

    def k2_checked(x, cond, p, *, n_groups=8, eps=1e-5):
        got = k2(x, cond, p, n_groups=n_groups, eps=eps)
        note("K2", got, UK.resblock_ref(x, cond, p, n_groups=n_groups, eps=eps),
             K2_TICK_TOL, ((1, 2), K2_GROUP_TOL))
        return got

    def k3_checked(q, *cache, kv_mask=None, scale=None):
        got = k3(q, *cache, kv_mask=kv_mask, scale=scale)
        note("K3", got, FQ.attention_q8_plain(q.float(), *cache, kv_mask, scale), Q8_TOL,
             ((3,), Q8_GROUP_TOL))
        return got

    def k4_checked(q, *cache, kv_mask=None, scale=None):
        got = k4(q, *cache, kv_mask=kv_mask, scale=scale)
        note("K4", got, FQ.attention_q8t_plain(q.float(), *cache, kv_mask, scale), Q8_TOL,
             ((3,), Q8_GROUP_TOL))
        return got

    def k6_checked(x, *leaf):
        got = k6(x, *leaf)
        note("K6", got, QM.a8w8_plain(x, *leaf, out_dtype=torch.float32), QMM_TOL)
        if shadow:
            note("K5", QM.w8a16_matmul(x, *leaf),
                 QM.w8a16_plain(x, *leaf, out_dtype=torch.float32), QMM_TOL)
        return got

    qdense = Q.qdense

    def qdense_shadowed(x, qp, out_dtype=torch.bfloat16):
        if math.prod(x.shape[:-1]) > 512:
            leaf = (qp.w_i8, qp.scale, qp.bias)
            if not QM.a8w8_large_takes(x.shape[-1], qp.w_i8.shape[0]):
                raise AssertionError(f"K7 does not take a qdense call of {tuple(x.shape)} x "
                                     f"{tuple(qp.w_i8.shape)}")
            note("K7", QM.a8w8_matmul_large(x, *leaf),
                 QM.a8w8_large_plain(x, *leaf, out_dtype=torch.float32), QMM_TOL)
        return qdense(x, qp, out_dtype=out_dtype)

    def k8_checked(x, *leaf):
        got = k8(x, *leaf)
        note("K8", got, QM.w4a8_plain(x, *leaf, out_dtype=torch.float32), QMM_TOL)
        return got

    def k9_checked(x, gu, down):
        got = k9(x, gu, down)
        note("K9", got, W4F.w4_swiglu_plain(x.to(torch.bfloat16), gu, down,
                                            out_dtype=torch.float32), MK_TOL)
        return got

    def k10_checked(x, att, o, gu, down, norm_w, eps=1e-6):
        got = k10(x, att, o, gu, down, norm_w, eps=eps)
        note("K10", got, k10_plain(x, att, o, gu, down, norm_w, eps), MK_TOL)
        return got

    # each wrapper bumps the count of the function its module name holds,
    # so the stand-ins carry counts of their own and the kernels' stay as
    # the main path left them
    stand_ins = dict(K1=k1_checked, K2=k2_checked, K3=k3_checked, K4=k4_checked,
                     K6=k6_checked, K8=k8_checked, K9=k9_checked, K10=k10_checked)
    for fn in stand_ins.values():
        fn.launches = 0
    if shadow:
        Q.qdense = qdense_shadowed
    try:
        with swapped(**stand_ins):
            run()
    finally:
        Q.qdense = qdense
    return seen


def checked_tick(t, shadow=False, **tick_kw) -> dict:
    """One tick (``run_tick(t, **tick_kw)``) under :func:`checked_run`."""
    return checked_run(lambda: run_tick(t, **tick_kw), shadow)


# ---- K1 ----------------------------------------------------------------------

# (name, B, Lq, Lkv, H, D, layout, mask kind, calls per tick).  The layout
# is that of the operands on the main path: "vit" separate q/k/v
# projections, all contiguous (models/encoders/vit.py); "fused" strided
# views of one fused qkv projection (models/encoders/vit_serve.py); "self" the fused
# qkv projection of ops/nn.py's SelfAttention (q, k normed copies, v a
# strided view); "cross" a q projection and the fused kv projection of
# CrossAttention / CrossAttentionSized (k a normed copy, v a strided view).
K1_SHAPES = [
    ("siglip_self", 6, 729, 729, 16, 72, "vit", None, 27),
    ("dinov2_self", 2, 730, 730, 6, 64, "vit", None, 12),
    ("rdt_self", 1, 67, 67, 32, 64, "self", None, 140),
    ("rdt_image_cross", 1, 67, 4374, 32, 64, "cross", None, 70),
    ("rdt_lang_cross", 1, 67, 64, 32, 64, "cross", "ragged", 70),
    ("rdt_lang_cross_empty_row", 2, 67, 64, 32, 64, "cross", "empty", 0),
    # check only: the kernel's split boundaries (a ragged last tile at
    # several splits, a mask that kills one whole split, B 2 where row 0
    # keeps its first third of keys, across several splits and ending inside
    # a tile, and row 1 none) and a split long-query call
    ("split_ragged_1000", 1, 67, 1000, 32, 64, "cross", None, 0),
    ("image_dead_split", 1, 67, 4374, 32, 64, "cross", "dead_split", 0),
    ("image_b2_empty_row", 2, 67, 4374, 32, 64, "cross", "empty_wide", 0),
    ("dinov2_dead_split", 2, 730, 730, 6, 64, "vit", "dead_split", 0),
    # check only: the SigLIP serving twin's layout (q, k, v strided views of
    # one fused projection) on the warm tick's 3 frames and a cold tick's 6
    ("siglip_serve_self_3", 3, 729, 729, 16, 72, "fused", None, 0),
    ("siglip_serve_self_6", 6, 729, 729, 16, 72, "fused", None, 0),
    # check only: the serving pool's bucket 8 (serving_phase): SigLIP over
    # 48 frames, and RDT-1B's attentions at B 8 with the language condition
    # padded to 1024 keys, 20-62 valid and none in the last (pad) row
    ("pool_siglip_self_b48", 48, 729, 729, 16, 72, "vit", None, 0),
    ("pool_rdt_self_b8", 8, 67, 67, 32, 64, "self", None, 0),
    ("pool_image_cross_b8", 8, 67, 4374, 32, 64, "cross", None, 0),
    ("pool_lang_cross_b8", 8, 67, 1024, 32, 64, "cross", "pool", 0),
    # RDT finetuning (rdt_train_phase), calls per training step of
    # batch_size 4 x grad_accum 4: the forward of each micro-batch (28
    # self-attentions, 14 image and 14 language cross-attentions over the
    # collated 1024 keys, a RDT_LANG_LEN-token instruction) and SigLIP over
    # the step's 16 x 6 frames
    ("rdt_train_self", 4, 67, 67, 32, 64, "self", None, 112),
    ("rdt_train_image_cross", 4, 67, 4374, 32, 64, "cross", None, 56),
    ("rdt_train_lang_cross", 4, 67, 1024, 32, 64, "cross", "short", 56),
    ("siglip_train_b96", 96, 729, 729, 16, 72, "vit", None, 27),
    # the tactile encoder's contrastive step (tactile_encoder_phase): the
    # prompt-learned CLIP ViT-B/16 over 8 videos x 4 frames, 197 patch
    # tokens + 4 prompts in the 9 blocks before the prompt depth, 197 in
    # the 3 after
    ("vificlip_prompt_self", 32, 201, 201, 12, 64, "vit", None, 9),
    ("vificlip_self", 32, 197, 197, 12, 64, "vit", None, 3),
    # the head dims the JAX package takes (any D <= 128; D 72 is SigLIP's
    # above): D not a multiple of 8 runs on zero-padded columns.  Timed once
    # each at a SigLIP-sized call, and the examples phase's shapes: the full
    # walkthrough's ViT (D 12, 4 patches) and cut DinoV2 (D 96, 5 tokens),
    # the planning walkthrough's CLIP (D 8, 5 tokens)
    ("vit_d8", 6, 729, 729, 16, 8, "vit", None, 1),
    ("vit_d12", 6, 729, 729, 16, 12, "vit", None, 1),
    ("cross_d20_ragged", 1, 67, 4374, 32, 20, "cross", "ragged", 1),
    ("fused_d20", 6, 729, 729, 16, 20, "fused", None, 1),
    ("vit_d96", 2, 730, 730, 4, 96, "vit", None, 1),
    ("vit_d128", 6, 729, 729, 8, 128, "vit", None, 1),
    ("walk_vit_d12", 6, 4, 4, 4, 12, "vit", None, 0),
    ("walk_dino_d96", 2, 5, 5, 4, 96, "vit", None, 0),
    ("walk_clip_d8", 3, 5, 5, 4, 8, "vit", None, 0),
    # above D 128 (CTAs of 128-column pieces of V): D 160 at a SigLIP-sized
    # call and D 256 at the image cross-attention's shape, timed once each;
    # D 200 ragged over several splits, check only.  RDT-170M's bf16 tick
    # (rdt170m_ticks): its D 72 self-attention and image cross-attention,
    # check only (the tick's checked run holds every call)
    ("vit_d160", 6, 729, 729, 8, 160, "vit", None, 1),
    ("cross_d256", 1, 67, 4374, 16, 256, "cross", None, 1),
    ("cross_d200_ragged", 2, 67, 1000, 8, 200, "cross", "empty_wide", 0),
    ("rdt170m_self", 1, 67, 67, 16, 72, "self", None, 0),
    ("rdt170m_image_cross", 1, 67, 4374, 16, 72, "cross", None, 0),
]
# the rows whose calls are per training step, not per tick: an RDT training
# step's, a contrastive step of the tactile encoder's, and the warm-replan
# protocol's training step and cold chunk (K1_WARM_SHAPES)
K1_STEP_ROWS = {"rdt_train_self": "train_step", "rdt_train_image_cross": "train_step",
                "rdt_train_lang_cross": "train_step", "siglip_train_b96": "train_step",
                "vificlip_prompt_self": "contrastive_step", "vificlip_self": "contrastive_step",
                "warm_train_self": "warm_train_step", "warm_train_lang_cross": "warm_train_step",
                "warm_train_image_cross": "warm_train_step", "warm_chunk_self": "warm_chunk",
                "warm_chunk_lang_cross": "warm_chunk", "warm_chunk_image_cross": "warm_chunk",
                "vit_d8": "head_dims", "vit_d12": "head_dims", "cross_d20_ragged": "head_dims",
                "fused_d20": "head_dims", "vit_d96": "head_dims", "vit_d128": "head_dims",
                "vit_d160": "head_dims", "cross_d256": "head_dims"}


def k1_operands(gen, B, Lq, Lkv, H, D, layout):
    """One bf16 (q, k, v) on the card, laid out as ``layout`` says."""
    import torch

    def mk(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    if layout == "vit":
        return mk(B, Lq, H, D), mk(B, Lkv, H, D), mk(B, Lkv, H, D)
    if layout == "self":
        assert Lq == Lkv
        qkv = mk(B, Lq, 3, H, D)
        return qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous(), qkv[:, :, 2]
    if layout == "fused":
        assert Lq == Lkv
        qkv = mk(B, Lq, 3, H, D)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    kv = mk(B, Lkv, 2, H, D)
    return mk(B, Lq, H, D), kv[:, :, 0].contiguous(), kv[:, :, 1]


def k1_splits(B, Lq, Lkv, H, D=64):
    """(splits, tiles per split) the K1 wrapper picks on this card."""
    from vla_touch_tpu_torch.ops import flash_attention as FA

    return FA.card_plan(B, Lq, Lkv, H, D)[1:]


def dead_split_mask(B, Lkv, plan):
    """A (B, Lkv) mask with every key of the second split of ``plan``
    (splits, tiles per split) masked."""
    import torch

    splits, tps = plan
    if splits < 3:
        raise AssertionError(f"dead_split needs 3 splits or more, the plan has {splits}")
    mask = torch.ones((B, Lkv), dtype=torch.bool, device="cuda")
    mask[:, tps * 64:2 * tps * 64] = False
    return mask


def k1_mask(B, Lq, Lkv, H, kind):
    """None, or a (B, Lkv) mask: row 0 keeps 50 keys ("ragged"), and row 1
    keeps none as well ("empty"); row 0 keeps its first Lkv // 3 keys and
    row 1 none ("empty_wide"); "short", every row keeps its first
    RDT_LANG_LEN keys; "pool", row i keeps its first 20 + 7 i keys and the
    last row none (a serving pool's padded batch); "vlm", row 1 keeps its
    first VLM_PATCHES_B keys (the 336^2 image beside a 448^2 one); "all",
    every key valid (a mask the main path passes with nothing masked); or
    "dead_split", every
    key of K1's second split (at D 64) masked."""
    import torch

    if kind is None:
        return None
    if kind == "all":
        return torch.ones((B, Lkv), dtype=torch.bool, device="cuda")
    if kind == "pool":
        mask = torch.zeros((B, Lkv), dtype=torch.bool, device="cuda")
        for i in range(B - 1):
            mask[i, :20 + 7 * i] = True
        return mask
    if kind == "short":
        mask = torch.zeros((B, Lkv), dtype=torch.bool, device="cuda")
        mask[:, :RDT_LANG_LEN] = True
        return mask
    if kind == "vlm":
        mask = torch.ones((B, Lkv), dtype=torch.bool, device="cuda")
        mask[1, VLM_PATCHES_B:] = False
        return mask
    if kind == "dead_split":
        return dead_split_mask(B, Lkv, k1_splits(B, Lq, Lkv, H))
    mask = torch.ones((B, Lkv), dtype=torch.bool, device="cuda")
    mask[0, Lkv // 3 if kind == "empty_wide" else 50:] = False
    if kind in ("empty", "empty_wide"):
        mask[1, :] = False
    return mask


def k1_check(name, q, k, v, mask):
    """K1 against its plain version on the same operands; returns (max abs
    error, tolerance) and raises on a miss."""
    from vla_touch_tpu_torch.ops import flash_attention as FA

    got = FA.flash_attention(q, k, v, kv_mask=mask)
    return hold(f"K1 {name}", got, FA.attention_plain(q, k, v, kv_mask=mask).float(),
                K1_TOL, mask)


def k1_bound_ms(B, Lq, Lkv, H, D, masked):
    """(bytes ms, operations ms): q, k, v, mask read once, out written once;
    the two matmuls' 4 B H Lq Lkv D operations at the bf16 peak."""
    nbytes = 2 * (2 * B * Lq * H * D + 2 * B * Lkv * H * D) + (B * Lkv if masked else 0)
    flops = 4.0 * B * H * Lq * Lkv * D
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / BF16_FLOPS


def check_k1(gen, shapes=None):
    """Every K1 shape held to its plain version and timed.  Returns (rows,
    the tick's sums over its calls, with those of K1_STEP_ROWS' calls per
    training step under the step's name: "train_step" for RDT finetuning,
    "contrastive_step" for the tactile encoder)."""
    import torch.nn.functional as F

    from vla_touch_tpu_torch.ops import flash_attention as FA

    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0,
               bytes_ms=0.0, ops_ms=0.0)
    for step in set(K1_STEP_ROWS.values()):
        tot[step] = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, calls=0)
    for name, B, Lq, Lkv, H, D, layout, mask_kind, calls in shapes or K1_SHAPES:
        # enough distinct operand sets that a timing loop misses the L2 cache
        n_sets = max(1, min(8, -(-2 * L2_BYTES // (2 * 2 * B * Lkv * H * D))))
        sets = [k1_operands(gen, B, Lq, Lkv, H, D, layout) for _ in range(n_sets)]
        mask = k1_mask(B, Lq, Lkv, H, mask_kind)
        err, tol = k1_check(name, *sets[0], mask)
        tot["err"] = max(tot["err"], err)
        splits, tps = k1_splits(B, Lq, Lkv, H, D)
        where = (f"K1 {name:26s} B{B} Lq{Lq} Lkv{Lkv} H{H} D{D} {layout:5s} splits {splits} x "
                 f"{tps} tiles")
        if calls == 0:
            log(f"{where}: err {err:.3e} (tol {tol:.3e}), fully masked rows 0; "
                f"check only")
            continue
        it = [0]

        def nxt():
            it[0] = (it[0] + 1) % n_sets
            return sets[it[0]]

        def run_kernel():
            FA.flash_attention(*nxt(), kv_mask=mask)

        def run_plain():
            FA.attention_plain(*nxt(), kv_mask=mask)

        sdpa_mask = None if mask is None else mask[:, None, None, :]

        def run_library():
            qq, kk, vv = nxt()
            F.scaled_dot_product_attention(qq.transpose(1, 2), kk.transpose(1, 2),
                                           vv.transpose(1, 2), attn_mask=sdpa_mask)

        ms = graph_time_ms(run_kernel)
        eager_ms = cuda_time_ms(run_kernel)
        plain_ms = graph_time_ms(run_plain, calls=5, replays=PLAIN_REPLAYS)
        lib_ms = graph_time_ms(run_library)
        b_ms, o_ms = k1_bound_ms(B, Lq, Lkv, H, D, mask is not None)
        bound = max(b_ms, o_ms)
        rows.append(dict(shape=name, B=B, Lq=Lq, Lkv=Lkv, H=H, D=D, layout=layout,
                         calls=calls, splits=splits, max_abs_err=err, tol=tol, ms=ms, eager_ms=eager_ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound))
        step = K1_STEP_ROWS.get(name)
        log(f"{where}: err {err:.3e} "
            f"(tol {tol:.3e}) kernel {ms:.4f} ms (eager loop {eager_ms:.4f}) "
            f"plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms bound {bound:.4f} ms "
            f"x{calls}/{step or 'tick'}")
        if step:
            tot[step]["calls"] += calls
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bound_ms", bound)):
                tot[step][key] += calls * v
            continue
        tot["ms"] += calls * ms
        tot["plain_ms"] += calls * plain_ms
        tot["library_ms"] += calls * lib_ms
        tot["bound_ms"] += calls * bound
        tot["bytes_ms"] += calls * b_ms
        tot["ops_ms"] += calls * o_ms
    return rows, tot


# ---- K2 ----------------------------------------------------------------------



def k2_unet_shapes(horizon: int) -> list:
    """(name, T, Cin, C) of the 12 blocks of one BRIDGeR UNet pass at its
    deployment width, down_dims (256, 512, 512), over ``horizon`` steps."""
    h2, h4 = horizon // 2, horizon // 4
    return [("down0_res0", horizon, 10, 256), ("down0_res1", horizon, 256, 256),
            ("down1_res0", h2, 256, 512), ("down1_res1", h2, 512, 512),
            ("down2_res0", h4, 512, 512), ("down2_res1", h4, 512, 512),
            ("mid0", h4, 512, 512), ("mid1", h4, 512, 512),
            ("up0_res0", h4, 1024, 512), ("up0_res1", h4, 512, 512),
            ("up1_res0", h2, 1024, 256), ("up1_res1", h2, 256, 256)]


# S = 2, B = 1: the tick refines 16 steps
K2_SHAPES = k2_unet_shapes(16)
K2_G, K2_K, K2_S, K2_STEPS = 512, 5, 2, 10
# the horizons the JAX BRIDGeR takes above K2's first two m16 tiles: the
# reference's 64-step chunk (its first level four tiles) and 48 (three),
# held against plain and timed per UNet pass (summed over its 12 blocks)
K2_HORIZONS = (64, 48)
# check only: the first level of a horizon-32 UNet (the trainers' default
# horizon; the controllers phase's evaluation runs it at B 50) and a time
# axis that ends inside the second m16 tile
K2_CHECK_ONLY = [("h32_down0_res0", 32, 10, 256, 1), ("h32_down0_res1", 32, 256, 256, 1),
                 ("h32_b50_down0_res1", 32, 256, 256, 50), ("t20_ragged", 20, 256, 512, 1),
                 ("t200_ragged", 200, 256, 512, 1), ("wide_t128_b2", 128, 1024, 1024, 2)]
# past the 64-step time chunk and past one SM's shared memory, each block
# timed once (summed in tot["long"]): horizon 128's first level (two time
# chunks) and horizon 256's first two, and the widest blocks of the UNet's
# default down_dims (256, 512, 1024) at horizon 256 (its third level, T 64:
# C 1024, and the up path's 2048 input channels), which take splits of at
# most 256 input channels and stream the norm items' values
K2_LONG = [("h128_down0_res0", 128, 10, 256), ("h128_down0_res1", 128, 256, 256),
           ("h256_down0_res1", 256, 256, 256), ("h256_down1_res0", 128, 256, 512),
           ("wide_c1024_t64", 64, 1024, 1024), ("wide_cin2048_t64", 64, 2048, 1024)]


def k2_params(gen, S, Cin, C, G, K):
    import torch

    def w(*shape, scale):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    p = {"w0": w(S, K, Cin, C, scale=(K * Cin) ** -0.5), "b0": w(S, C, scale=0.1),
         "g0w": 1 + w(S, C, scale=0.1), "g0b": w(S, C, scale=0.1),
         "fw": w(S, G, 2 * C, scale=G ** -0.5), "fb": w(S, 2 * C, scale=0.1),
         "w1": w(S, K, C, C, scale=(K * C) ** -0.5), "b1": w(S, C, scale=0.1),
         "g1w": 1 + w(S, C, scale=0.1), "g1b": w(S, C, scale=0.1)}
    if Cin != C:
        p["wr"] = w(S, Cin, C, scale=Cin ** -0.5)
        p["br"] = w(S, C, scale=0.1)
    return p


def k2_bound_ms(S, B, T, Cin, C, G, K):
    """(bytes ms, operations ms): every weight, x, cond read once, out
    written once; the conv, residual and FiLM multiply-adds at the bf16
    peak."""
    params = S * (K * Cin * C + K * C * C + G * 2 * C + 2 * C + 6 * C
                  + ((Cin * C + C) if Cin != C else 0))
    nbytes = 2 * (params + S * B * T * Cin + S * B * G + S * B * T * C)
    flops = 2.0 * S * B * (T * (K * Cin * C + K * C * C + (Cin * C if Cin != C else 0))
                           + G * 2 * C)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / BF16_FLOPS


def check_k2(gen):
    import torch

    from vla_touch_tpu_torch.ops import unet_kernels as UK

    def sums():
        return dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, bytes_ms=0.0, ops_ms=0.0)

    rows = []
    tot = sums()
    S, B, G, K = K2_S, 1, K2_G, K2_K
    # the tick's blocks (K2_STEPS calls each a tick, summed in ``tot``), then
    # each horizon's UNet pass (each block once, summed in tot["h<horizon>"]);
    # the plain version of a horizon's block is timed over fewer calls
    passes = [("", K2_SHAPES, K2_STEPS, tot)] + [
        (f"h{h}", k2_unet_shapes(h), 0, tot.setdefault(f"h{h}", sums())) for h in K2_HORIZONS] \
        + [("long", K2_LONG, 0, tot.setdefault("long", sums()))]
    for label, shapes, calls, acc in passes:
        for name, T, Cin, C in shapes:
            shape = f"{label}_{name}" if label else name
            x = torch.randn((S, B, T, Cin), generator=gen, device="cuda").to(torch.bfloat16)
            cond = torch.randn((S, B, G), generator=gen, device="cuda").to(torch.bfloat16)
            # the block's weights per tick are streamed once per SDE step;
            # keep enough copies that the timing loop misses the L2 cache
            sets = [k2_params(gen, S, Cin, C, G, K) for _ in range(4)]
            want = UK.resblock_ref(x, cond, sets[0])
            max_plain = float(want.abs().max())
            err, _ = hold(f"K2 {shape}", UK.resblock_fused(x, cond, sets[0]), want,
                          K2_TOL / max_plain)
            it = [0]

            def nxt():
                it[0] = (it[0] + 1) % len(sets)
                return sets[it[0]]

            ms = graph_time_ms(lambda: UK.resblock_fused(x, cond, nxt()))
            eager_ms = cuda_time_ms(lambda: UK.resblock_fused(x, cond, nxt())) if calls else None
            plain_ms = graph_time_ms(
                lambda: UK.resblock_ref(x, cond, nxt()).to(torch.bfloat16),
                **({} if calls else dict(calls=5, replays=PLAIN_REPLAYS)))
            b_ms, o_ms = k2_bound_ms(S, B, T, Cin, C, G, K)
            bound = max(b_ms, o_ms)
            rows.append(dict(shape=shape, T=T, Cin=Cin, C=C, calls=calls, max_abs_err=err,
                             max_plain=max_plain, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                             bound_ms=bound))
            log(f"K2 {shape:20s} S{S} B{B} T{T:3d} Cin{Cin:5d} C{C}: err {err:.3e} "
                f"(tol {K2_TOL}, max|plain| {max_plain:.2f}) kernel {ms:.4f} ms"
                + (f" (eager loop {eager_ms:.4f})" if calls else "")
                + f" plain {plain_ms:.4f} ms bound {bound:.4f} ms"
                + (f" x{calls}/tick" if calls else ""))
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                           ("bytes_ms", b_ms), ("ops_ms", o_ms)):
                acc[key] += (calls or 1) * v
            acc["err"] = max(acc["err"], err)
        if label:
            log(f"K2 {'long and wide blocks' if label == 'long' else 'horizon ' + label[1:]}"
                f" ({len(shapes)} blocks): kernel {acc['ms']:.4f} ms "
                f"plain {acc['plain_ms']:.4f} ms bound {acc['bound_ms']:.4f} ms")
    for name, T, Cin, C, Bc in K2_CHECK_ONLY:
        x = torch.randn((S, Bc, T, Cin), generator=gen, device="cuda").to(torch.bfloat16)
        cond = torch.randn((S, Bc, G), generator=gen, device="cuda").to(torch.bfloat16)
        p = k2_params(gen, S, Cin, C, G, K)
        got = UK.resblock_fused(x, cond, p)
        again = UK.resblock_fused(x, cond, p)
        want = UK.resblock_ref(x, cond, p)
        err, _ = hold(f"K2 {name}", got, want, K2_TOL / float(want.abs().max()))
        if not torch.equal(got, again):
            raise AssertionError(f"K2 {name}: a second call gave other bits")
        log(f"K2 {name:18s} S{S} B{Bc} T{T:2d} Cin{Cin:5d} C{C}: err {err:.3e} "
            f"(tol {K2_TOL}, check only)")
    return rows, tot


# ---- K3 / K4 -----------------------------------------------------------------

# (name, B, Lq, Lkv, H, D, mask kind, calls per tick) of the quantized tick's
# cross-attentions over the int8 condition cache: q is the q_norm output
# (contiguous), the cache is quantize_kv(_t) of a normed k copy and a
# strided v view of the fused kv projection.  The check-only rows (0 calls)
# hold the kernel's split boundaries: a ragged last tile at several splits
# (1000 keys), a mask that kills one whole split, and B 2 where row 0 keeps
# 50 keys (its other splits all masked) and row 1 none.
Q8_SHAPES = [
    ("rdt_image_cross", 1, 67, 4374, 32, 64, None, 70),
    ("rdt_lang_cross", 1, 67, 64, 32, 64, "ragged", 70),
    ("rdt_lang_cross_empty_row", 2, 67, 64, 32, 64, "empty", 0),
    ("split_ragged_1000", 1, 67, 1000, 32, 64, None, 0),
    ("image_dead_split", 1, 67, 4374, 32, 64, "dead_split", 0),
    ("image_b2_empty_row", 2, 67, 4374, 32, 64, "empty", 0),
]
# other head dims, timed once each (summed in tot["head_dims"]): RDT-170M's
# int8 cache (16 heads of D 72: K3 only, as JAX's K4 asserts D % 32, which
# the port's K4 refuses too) and D 160 (fewer query rows a CTA); check only:
# RDT-170M's ragged language cache and D 160 over several splits with an
# empty row
Q8_HEAD_DIM_SHAPES = [
    ("rdt170m_image_cross", 1, 67, 4374, 16, 72, None, 1),
    ("rdt170m_lang_cross", 1, 67, 64, 16, 72, "ragged", 0),
    ("d160_image_cross", 1, 67, 4374, 8, 160, None, 1),
    ("d160_split_empty_row", 2, 67, 1000, 8, 160, "empty", 0),
]


def q8_splits(B, Lq, Lkv, H):
    """(splits, tiles per split) the K3/K4 wrapper picks on this card."""
    import torch

    from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ

    return FQ.split_plan(B, Lq, Lkv, H, torch.cuda.get_device_properties(0).multi_processor_count)


def q8_mask(B, Lq, Lkv, H, kind):
    """:func:`k1_mask`'s kinds, "dead_split" by the K3/K4 plan."""
    if kind != "dead_split":
        return k1_mask(B, Lq, Lkv, H, kind)
    return dead_split_mask(B, Lkv, q8_splits(B, Lq, Lkv, H))


def q8_operands(gen, B, Lq, Lkv, H, D, transposed):
    """(q, k_i8, k_scale, v_i8, v_scale) on the card, the cache in K3's
    (B, L, H, D) or K4's (B, H, D, L) layout."""
    import torch

    from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ

    q = torch.randn((B, Lq, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    kv = torch.randn((B, Lkv, 2, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    quant = FQ.quantize_kv_t if transposed else FQ.quantize_kv
    return (q,) + quant(kv[:, :, 0].contiguous(), kv[:, :, 1])


def q8_check(kernel, ops, mask):
    """K3 or K4 against its plain version on ``ops``; returns (max abs
    error, tolerance) and raises on a miss."""
    from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ

    fn, plain = ((FQ.flash_attention_q8t, FQ.attention_q8t_plain) if kernel == "K4" else
                 (FQ.flash_attention_q8, FQ.attention_q8_plain))
    got = fn(*ops, kv_mask=mask)
    return hold(kernel, got, plain(ops[0].float(), *ops[1:], kv_mask=mask), Q8_TOL, mask)


def q8_bound_ms(B, Lq, Lkv, H, D, masked):
    """(bytes ms, operations ms): bf16 q and out, int8 K and V, their float32
    scales and the mask moved once; the two products' 4 B H Lq Lkv D
    operations at the bf16 peak (the int8 tiles feed bf16 tensor cores)."""
    nbytes = (2 * 2 * B * Lq * H * D + 2 * B * Lkv * H * D + 2 * 4 * B * H * D
              + (B * Lkv if masked else 0))
    flops = 4.0 * B * H * Lq * Lkv * D
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / BF16_FLOPS


def check_q8(gen, kernel):
    import torch
    import torch.nn.functional as F

    from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ

    transposed = kernel == "K4"
    fn, plain = ((FQ.flash_attention_q8t, FQ.attention_q8t_plain) if transposed else
                 (FQ.flash_attention_q8, FQ.attention_q8_plain))
    def sums():
        return dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0,
                    bytes_ms=0.0, ops_ms=0.0)

    rows = []
    tot = sums()
    tot["head_dims"] = sums()
    for name, B, Lq, Lkv, H, D, mask_kind, calls in Q8_SHAPES + Q8_HEAD_DIM_SHAPES:
        acc = tot if (name, B, Lq, Lkv, H, D, mask_kind, calls) in Q8_SHAPES else \
            tot["head_dims"]
        if transposed and D % 16:
            try:
                fn(*q8_operands(gen, 1, 1, 16, 1, D, True))
            except ValueError as e:
                log(f"{kernel} {name}: D {D} refused, as JAX's kernel refuses it ({e})")
                continue
            raise AssertionError(f"{kernel} took D {D}: JAX's K4 asserts D % 32")
        n_sets = max(1, min(8, -(-2 * L2_BYTES // (2 * B * Lkv * H * D))))
        sets = [q8_operands(gen, B, Lq, Lkv, H, D, transposed) for _ in range(n_sets)]
        mask = q8_mask(B, Lq, Lkv, H, mask_kind)
        err, tol = q8_check(kernel, sets[0], mask)
        acc["err"] = max(acc["err"], err)
        splits, tps = q8_splits(B, Lq, Lkv, H)
        where = (f"{kernel} {name:26s} B{B} Lq{Lq} Lkv{Lkv} H{H} D{D} splits {splits} x "
                 f"{tps} tiles")
        if calls == 0:
            log(f"{where}: err {err:.3e} (tol {tol:.3e}), fully masked rows 0; check only")
            continue
        it = [0]

        def nxt():
            it[0] = (it[0] + 1) % n_sets
            return sets[it[0]]

        # the yardstick: SDPA on the cache dequantized to bf16 beforehand
        deq = []
        for q, k8, sk, v8, sv in sets:
            if transposed:
                k8, v8 = k8.permute(0, 3, 1, 2), v8.permute(0, 3, 1, 2)
            deq.append((q.transpose(1, 2),
                        (k8.float() * sk[:, None]).to(torch.bfloat16).transpose(1, 2),
                        (v8.float() * sv[:, None]).to(torch.bfloat16).transpose(1, 2)))
        sdpa_mask = None if mask is None else mask[:, None, None, :]

        def run_library():
            F.scaled_dot_product_attention(*deq[it[0]], attn_mask=sdpa_mask)
            nxt()

        ms = graph_time_ms(lambda: fn(*nxt(), kv_mask=mask))
        eager_ms = cuda_time_ms(lambda: fn(*nxt(), kv_mask=mask))
        plain_ms = graph_time_ms(lambda: plain(*nxt(), kv_mask=mask), calls=5,
                                 replays=PLAIN_REPLAYS)
        lib_ms = graph_time_ms(run_library)
        b_ms, o_ms = q8_bound_ms(B, Lq, Lkv, H, D, mask is not None)
        bound = max(b_ms, o_ms)
        rows.append(dict(shape=name, B=B, Lq=Lq, Lkv=Lkv, H=H, D=D, calls=calls,
                         splits=splits, max_abs_err=err, tol=tol, ms=ms, eager_ms=eager_ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound))
        log(f"{where}: err {err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms (eager loop "
            f"{eager_ms:.4f}) plain {plain_ms:.4f} ms sdpa-on-dequantized {lib_ms:.4f} ms "
            f"bound {bound:.4f} ms x{calls}/tick")
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bound_ms", bound), ("bytes_ms", b_ms), ("ops_ms", o_ms)):
            acc[key] += calls * v
    tot["err"] = max(tot["err"], tot["head_dims"]["err"])
    return rows, tot


# ---- K5 / K6 / K7 / K8 ---------------------------------------------------------

# (M, K, N, calls per tick) of the quantized chunk's linears at M <= 512: per
# denoise step (x5) the 28 blocks' qkv (67, 2048, 6144) and proj, q, cross
# proj, fc1, fc2 (67, 2048, 2048), the final head (67, 2048, 2048) and
# (67, 2048, 128), the action adaptor (64, 256 | 2048, 2048); once per chunk
# the language adaptor (64, 4096 | 2048, 2048) and the state adaptor
# (1, 256 | 2048, 2048).  870 calls; the image adaptor (M = 4374) takes the
# plain route.
QMM_SHAPES = [
    (67, 2048, 6144, 140), (67, 2048, 2048, 705), (67, 2048, 128, 5),
    (64, 4096, 2048, 1), (64, 2048, 2048, 11), (64, 256, 2048, 5),
    (1, 256, 2048, 1), (1, 2048, 2048, 2),
]
# (M, K, N, calls per chunk of configuration (f)) of the plain qdense calls
# at M > 512 that K7 is held to: the image adaptor over 4374 tokens (1152 ->
# 2048, 2048 -> 2048; every int8 configuration), and the 14 image K/V
# projections of quantize_rdt_params(kv_proj='int8')
K7_SHAPES = [(4374, 1152, 2048, 1), (4374, 2048, 2048, 1), (4374, 2048, 4096, 14)]


def qmm_fns(kernel):
    """(wrapper, plain version) of K5, K6, K7 or K8."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    return {"K5": (QM.w8a16_matmul, QM.w8a16_plain), "K6": (QM.a8w8_matmul, QM.a8w8_plain),
            "K7": (QM.a8w8_matmul_large, QM.a8w8_large_plain),
            "K8": (QM.w4a8_matmul, QM.w4a8_plain)}[kernel]


def qmm_bound_ms(kernel, M, K, N):
    """(bytes ms, operations ms): bf16 x in and out written once; int8
    weights (K5-K7) or 0.5 byte per weight plus scale4 (K8); scale and
    bias; 2 M K N operations at the int8 peak, or the bf16 peak for K5,
    whose int8 weights feed bf16 tensor cores."""
    from vla_touch_tpu_torch.ops.quant import pick_group_size

    wbytes = N * K if kernel != "K8" else N * K // 2 + 4 * N * (K // pick_group_size(K))
    nbytes = 2 * M * K + wbytes + 2 * 4 * N + 2 * M * N
    peak = BF16_FLOPS if kernel == "K5" else INT8_OPS
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * 2.0 * M * K * N / peak


def qmm_check(gen, kernel, M, K, N):
    """K5, K6, K7 or K8 against its plain version at (M, K, N) on a
    quantized random linear and x ~ N(0, 4) in bf16; returns (x, weights,
    max abs error, tolerance, bf16 outputs unlike the plain version's
    rounded to bf16) and raises on a miss."""
    import torch

    from vla_touch_tpu_torch.ops import quant as Q

    fn, plain = qmm_fns(kernel)
    lin = torch.nn.Linear(K, N, device="cuda")
    with torch.no_grad():
        lin.weight.copy_(torch.randn((N, K), generator=gen, device="cuda") * K ** -0.5)
        lin.bias.copy_(torch.randn((N,), generator=gen, device="cuda") * 0.1)
    leaf = Q.quantize_linear_w4(lin) if kernel == "K8" else Q.quantize_linear(lin)
    wts = ((leaf.w4_pack, leaf.scale4, leaf.bias) if kernel == "K8" else
           (leaf.w_i8, leaf.scale, leaf.bias))
    del lin, leaf
    x = (torch.randn((M, K), generator=gen, device="cuda") * 2).to(torch.bfloat16)
    got = fn(x, *wts)
    want = plain(x, *wts, out_dtype=torch.float32)
    err, tol = hold(f"{kernel} ({M}, {K}, {N})", got, want, QMM_TOL)
    n_diff = int((got != want.to(torch.bfloat16)).sum())
    if kernel in EXACT_KERNELS and n_diff:
        raise AssertionError(f"{kernel} ({M}, {K}, {N}): {n_diff} bf16 outputs unlike the "
                             f"plain version's rounded to bf16 (must be 0)")
    if kernel == "K7":
        stray = k7_stray_writes(x, *wts, got)
        if stray:
            raise AssertionError(f"K7 ({M}, {K}, {N}): {stray} elements of the "
                                 f"{K7_GUARD_ROWS} guard rows past M written (must be 0)")
    return x, wts, err, tol, n_diff


# K7's stores are masked to M; the guard rows past a call's output that
# k7_stray_writes watches (its last row tile's rows past M fall in them)
K7_GUARD_ROWS = 128
K7_CANARY = 0x7FC1                 # a bf16 NaN's bits: no output of a finite x has them


def k7_stray_writes(x, w_i8, scale, bias, got):
    """K7's C entry on (x, w_i8, scale, bias) with its output at the start
    of a buffer whose K7_GUARD_ROWS rows past M hold K7_CANARY: how many
    guard elements it changed (the wrapper's own output ends in allocator
    slack that nothing reads, so a store past M would go unseen there).
    Raises unless the first M rows equal the wrapper's output ``got``."""
    import ctypes

    import torch

    from vla_touch_tpu_torch.csrc import build

    (M, K), N = x.shape, w_i8.shape[0]
    buf = torch.full((M + K7_GUARD_ROWS, N), K7_CANARY, dtype=torch.int16, device=x.device)
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    rs = torch.empty((M,), dtype=torch.float32, device=x.device)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib, f = build.entry("a8w8_matmul_large", [P, I, L, P, P, P, P, P, P, I, I, I, P])
    err = f(x.data_ptr(), int(x.dtype == torch.float32), x.stride(0), w_i8.data_ptr(),
            scale.data_ptr(), None if bias is None else bias.data_ptr(), xq.data_ptr(),
            rs.data_ptr(), buf.data_ptr(), M, N, K, torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "a8w8_matmul_large")
    torch.cuda.synchronize()
    if not torch.equal(buf[:M].view(torch.bfloat16), got):
        raise AssertionError(f"K7 ({M}, {K}, {N}): the C entry's output is not the wrapper's")
    return int((buf[M:] != K7_CANARY).sum())


def qmm_library(kernel, x, sets):
    """The yardstick of K5-K7 on ``x`` and the weight sets, as a function
    of the set, or None (K8): ``torch._int_mm`` of x's int8 codes (the GEMM
    alone) for K6/K7, ``F.linear`` on bf16 weights dequantized ahead of
    time (twice K5's weight bytes) for K5."""
    import torch
    import torch.nn.functional as F

    from vla_touch_tpu_torch.ops import quant as Q

    if kernel == "K8":
        return None
    if kernel == "K5":
        deq = [((w.float() * s[:, None]).to(torch.bfloat16), b.to(torch.bfloat16))
               for w, s, b in sets]
        return lambda i: F.linear(x, *deq[i])
    xq = Q.quantize_rows(x)[0]
    xq = torch.nn.functional.pad(xq, (0, 0, 0, max(0, 32 - x.shape[0])))   # cuBLASLt: M > 16
    return lambda i: torch._int_mm(xq, sets[i][0].t())


def check_qmm(gen, kernel, shapes=None):
    import torch

    fn, plain = qmm_fns(kernel)
    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0,
               bytes_ms=0.0, ops_ms=0.0)
    for M, K, N, calls in shapes or QMM_SHAPES:
        x, wts, err, tol, n_diff = qmm_check(gen, kernel, M, K, N)
        tot["err"] = max(tot["err"], err)
        # distinct weight sets, >= 2x the L2 cache in all, so that the
        # timing loop streams the weights from device memory as the tick does
        wbytes = wts[0].numel() + 4 * wts[1].numel()
        n_sets = max(1, min(64, -(-2 * L2_BYTES // wbytes)))
        sets = [tuple(torch.randint(-127, 128, w.shape, generator=gen, device="cuda",
                                    dtype=torch.int8) if w.dtype == torch.int8 else
                      w.clone() for w in wts) for _ in range(n_sets)]
        it = [0]

        def nxt():
            it[0] = (it[0] + 1) % n_sets
            return sets[it[0]]

        library = qmm_library(kernel, x, sets)

        def run_library():
            library(it[0])
            nxt()

        ms = graph_time_ms(lambda: fn(x, *nxt()))
        eager_ms = cuda_time_ms(lambda: fn(x, *nxt()))
        plain_ms = graph_time_ms(lambda: plain(x, *nxt()), calls=5, replays=PLAIN_REPLAYS)
        lib_ms = None if library is None else graph_time_ms(run_library)
        del library, sets
        int_mm_ms = int_mm_yardstick_ms(gen, x, N) if kernel == "K8" and M in K8_PROMPT_MS \
            else None
        b_ms, o_ms = qmm_bound_ms(kernel, M, K, N)
        bound = max(b_ms, o_ms)
        plan = card_plan(kernel, M, K, N, wts[1])
        rows.append(dict(M=M, K=K, N=N, calls=calls, plan=plan, max_abs_err=err, tol=tol,
                         bf16_unlike_plain=n_diff, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, int_mm_ms=int_mm_ms, bound_ms=bound,
                         bytes_ms=b_ms, ops_ms=o_ms,
                         bound_by=bound_by(dict(bytes_ms=b_ms, ops_ms=o_ms))))
        lib = "" if lib_ms is None else (
            f" {'F.linear (bf16 weights)' if kernel == 'K5' else 'torch._int_mm (GEMM only)'} "
            f"{lib_ms:.4f} ms")
        if int_mm_ms is not None:
            lib += f" (yardstick of the int8 rate: torch._int_mm, int8 weights, {int_mm_ms:.4f} ms)"
        how = {"K5": f" plan (mt, wn, splits) {plan}", "K6": f" plan (mt, wn, splits) {plan}",
               "K7": f" tile (rows, columns) {plan}", "K8": f" plan (mt, splits) {plan}"}[kernel]
        log(f"{kernel} M{M:4d} K{K:5d} N{N:6d}{how}: err {err:.3e} (tol {tol:.3e}; bf16 outputs "
            f"unlike the plain version's {n_diff} of {M * N}) kernel {ms:.4f} ms (eager loop "
            f"{eager_ms:.4f}) plain {plain_ms:.4f} ms{lib} bound {bound:.4f} ms x{calls}/tick")
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                       ("bytes_ms", b_ms), ("ops_ms", o_ms)):
            tot[key] += calls * v
        if lib_ms is not None:
            tot["library_ms"] += calls * lib_ms
    if kernel == "K8":
        tot["library_ms"] = None
    return rows, tot


def card_plan(kernel, M, K, N, scale):
    """The plan a K5-K8 call takes on this card: K5's and K6's (mt, wn,
    splits), K7's tile (rows, columns), K8's (mt, splits); ``scale`` is
    the leaf's scale (K8: scale4, whose rows are its groups)."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    if kernel == "K5":
        return QM.k5_card_plan(M, N, K, 0)
    if kernel == "K7":
        return QM.K7_BM, QM.K7_BN
    if kernel == "K8":
        return k8_card_plan(M, K, N, scale.shape[0])
    return k6_card_plan(M, K, N)


def k6_card_plan(M, K, N):
    """K6's split plan (16-row tiles per CTA, warps across columns, K
    splits) on this card."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM
    from vla_touch_tpu_torch.utils.device import sm_count

    return QM.k6_plan(M, N, K, sm_count(0))


def k8_card_plan(M, K, N, G):
    """K8's plan (mt, splits) on this card."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM
    from vla_touch_tpu_torch.utils.device import sm_count

    return QM.k8_plan(M, N, K, G, sm_count(0))


def int_mm_yardstick_ms(gen, x, N):
    """Device ms of ``torch._int_mm`` of x's int8 codes against random int8
    (N, K) weights (enough sets to miss the L2 cache): a yardstick of the
    card's int8 rate at K8's prompt-pass shapes, not K8's function (no
    int4 unpacking, no group scales)."""
    import torch

    from vla_touch_tpu_torch.ops import quant as Q

    xq = Q.quantize_rows(x)[0]
    K = x.shape[1]
    n_sets = max(1, min(64, -(-2 * L2_BYTES // (N * K))))
    sets = [torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
            for _ in range(n_sets)]
    it = [0]

    def run():
        it[0] = (it[0] + 1) % n_sets
        torch._int_mm(xq, sets[it[0]].t())

    return graph_time_ms(run)


def k8_prompt_pass(rows, M) -> dict:
    """K8's per-shape figures summed over the calls of one prompt pass of M
    tokens (the K8_LLM_SHAPES rows at that M), the ``_int_mm`` yardstick
    beside them."""
    tot = dict(M=M, calls=0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
               int_mm_ms=0.0)
    for r in rows:
        if r["M"] != M:
            continue
        tot["calls"] += r["calls"]
        for key in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms", "int_mm_ms"):
            tot[key] += r["calls"] * r[key]
    tot["bound_by"] = bound_by(tot)
    return tot


def bound_by(tot) -> str:
    return "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"


# ---- the cold tick -------------------------------------------------------------

def build_tick(seed: int = 0):
    """Full-width models with seeded random weights and one tick's inputs."""
    import torch

    from vla_touch_tpu_torch.config import BridgeControllerConfig
    from vla_touch_tpu_torch.models.controllers import bridge as BR
    from vla_touch_tpu_torch.models.encoders.vit import (DINOV2_SMALL, DinoV2Encoder,
                                                         init_vit)
    from vla_touch_tpu_torch.ops import marker_tracking as MT
    from vla_touch_tpu_torch.runtime import policy as P

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pcfg = P.franka_eef_policy_config()
    model = P.create_model(pcfg, seed=seed, cache_frames=False)
    # the zero-initialised final projection would make every chunk 0
    fc2 = model.rdt.model.final_ffn.fc2.weight
    fc2.copy_((torch.randn(fc2.shape, generator=gen, device=dev) * 0.02).to(fc2.dtype))
    dino = init_vit(DinoV2Encoder, DINOV2_SMALL, seed=seed + 3, device=dev)
    bcfg = BridgeControllerConfig(inference_dtype="bfloat16", horizon=16)
    bridge = BR.deployable(BR.init_bridge_controller(bcfg, seed=seed + 1, device=dev))
    stacked = BR.stacked_vs(bridge)            # once per set of weights
    stats = {"vla_mins": np.zeros(10, np.float32), "vla_maxs": np.ones(10, np.float32),
             "action_mins": np.zeros(10, np.float32),
             "action_maxs": np.ones(10, np.float32)}
    S = pcfg.image_size
    m = pcfg.rdt.model
    text_mask = np.zeros((1, 64), bool)
    text_mask[0, :50] = True                    # a ragged language mask
    gel0 = torch.as_tensor(rng.integers(0, 256, (240, 320)).astype(np.float32), device=dev)
    inp = dict(
        frames=[rng.integers(0, 256, (S, S, 3)).astype(np.uint8) for _ in range(6)],
        proprio=rng.normal(size=(10,)).astype(np.float32),
        text=rng.normal(size=(1, 64, m.lang_token_dim)).astype(np.float32),
        text_mask=text_mask,
        init_noise=torch.randn((1, m.horizon, m.output_dim), generator=gen, device=dev),
        dino_frames=torch.as_tensor(rng.integers(0, 256, (2, 384, 384, 3)).astype(np.uint8),
                                    device=dev),
        gel=torch.as_tensor(rng.integers(0, 256, (240, 320)).astype(np.float32), device=dev),
        baseline=MT.calibrate(gel0),            # once per episode
        state10=torch.as_tensor(rng.normal(size=(1, 10)).astype(np.float32), device=dev),
        noise_seq=torch.randn((bcfg.interpolant.diffusion_steps, 1, bcfg.horizon, 10),
                              generator=gen, device=dev))
    return dict(pcfg=pcfg, model=model, dino=dino, bcfg=bcfg, bridge=bridge,
                stacked=stacked, stats=stats, inp=inp)


def policy_inputs(t):
    """The tensors ``step`` hands ``policy_step`` for this tick's inputs
    (all six frames present, already 384 square)."""
    import torch

    inp = t["inp"]
    return dict(
        proprio=torch.as_tensor(inp["proprio"].reshape(1, -1), device="cuda"),
        images=torch.as_tensor(np.stack(inp["frames"])[None], device="cuda"),
        image_mask=torch.ones((1, 6), dtype=torch.bool, device="cuda"),
        text_embeds=torch.as_tensor(inp["text"], device="cuda"),
        text_mask=torch.as_tensor(inp["text_mask"], device="cuda"))


def run_tick(t, stage_ms=None, rdt=None, kv_cache="bf16", refine=True, model=None,
             frames=None, prior=None, skip=0, noise=None,
             siglip_stage="siglip_6_frames") -> dict:
    """One control tick through the user entry points: cold, or with
    ``prior`` and ``skip`` > 0 the warm replan.

    ``rdt`` None: ``model.step`` (default ``t["model"]``, whose runner
    decides the chunk's path) on ``frames`` (default the tick's six), with
    ``prior_actions=prior, skip_steps=skip``.  A quantized runner:
    ``policy_step(..., kv_cache=...)`` on it with ``t["model"]``'s vision
    tower.  ``noise`` replaces the tick's starting noise.  ``refine`` False
    stops after the chunk.  With a ``stage_ms`` dict, every stage ends in a
    synchronise and its host ms is appended to ``stage_ms[stage]``; the end
    of SigLIP (``siglip_stage``) is marked by a forward hook on the vision
    tower."""
    import torch

    from vla_touch_tpu_torch.models.controllers import bridge as BR
    from vla_touch_tpu_torch.ops import marker_tracking as MT
    from vla_touch_tpu_torch.runtime import policy as P
    from vla_touch_tpu_torch.utils.image import imagenet_normalize

    marks = []

    def mark(stage):
        if stage_ms is not None:
            torch.cuda.synchronize()
            marks.append((stage, time.perf_counter()))

    inp = t["inp"]
    model = t["model"] if model is None else model
    noise = inp["init_noise"] if noise is None else noise
    hook = None
    if stage_ms is not None:
        hook = model.vision.register_forward_hook(lambda *_: mark(siglip_stage))
    mark("start")
    try:
        if rdt is None:
            actions = model.step(inp["proprio"], inp["frames"] if frames is None else frames,
                                 inp["text"], inp["text_mask"], prior_actions=prior,
                                 skip_steps=skip, init_noise=noise)
        else:
            actions = P.policy_step(t["pcfg"], rdt, model.vision, **policy_inputs(t),
                                    init_noise=noise, kv_cache=kv_cache).cpu().numpy()
    finally:
        if hook is not None:
            hook.remove()
    mark(f"rdt_chunk_{t['pcfg'].rdt.noise.num_inference_timesteps - skip}_steps")
    out = dict(actions=actions)
    if refine:
        with torch.inference_mode():
            feats = t["dino"](imagenet_normalize(inp["dino_frames"]).to(torch.bfloat16)).float()
        mark("dinov2_pair")
        force = MT.estimate_force(inp["gel"], inp["baseline"])["force"]
        mark("marker_force")
        vla10 = torch.as_tensor(actions[:, : t["bcfg"].horizon], device="cuda")
        refined = BR.bridge_predict(t["bcfg"], t["bridge"], t["stats"], inp["state10"],
                                    vla10, feats[:1], feats[1:], force[None],
                                    stacked=t["stacked"], noise_seq=inp["noise_seq"])
        mark("bridger_refine_10_steps")
        out.update(dino=feats.cpu().numpy(), force=force.cpu().numpy(),
                   refined=refined.cpu().numpy())
    torch.cuda.synchronize()
    for (_, t0), (stage, t1) in zip(marks, marks[1:]):
        stage_ms.setdefault(stage, []).append(1e3 * (t1 - t0))
    return out


# (kernel, library) whose ptxas report kernel_ptxas holds: no register spills
PTXAS_CHECKED = (("K1", "flash_attention"), ("K8", "w4a8_matmul"), ("K2", "resblock"),
                 ("K5", "w8a16_matmul"), ("K7", "a8w8_matmul_large"),
                 ("K3", "flash_attention_q8"))


def kernel_ptxas():
    """Print ptxas's register and spill lines for the kernels of
    PTXAS_CHECKED (from the report kept beside each built library); raise
    if any spills."""
    from vla_touch_tpu_torch.csrc import build

    for kernel, name in PTXAS_CHECKED:
        report = build.ptxas_report(name)
        lines = [ln.strip() for ln in report.splitlines()
                 if "Compiling entry function" in ln or "spill" in ln or "registers" in ln]
        if not lines:
            raise AssertionError(f"{kernel}'s ptxas report names no kernel")
        for ln in lines:
            log(f"{kernel} ptxas: {ln}")
        spills = [ln for ln in lines
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln))]
        if spills:
            raise AssertionError(f"{kernel} spills registers: {spills}")


def siglip_tokens(t):
    import torch

    from vla_touch_tpu_torch.runtime import policy as P

    frames = torch.as_tensor(np.stack(t["inp"]["frames"])[None], device="cuda")
    mask = torch.ones((1, 6), dtype=torch.bool, device="cuda")
    return P.encode_frames(t["pcfg"], t["model"].vision, frames, mask).float().cpu().numpy()


PROFILE_GROUPS = (("K1 flash_fwd_kernel", "flash_fwd_kernel"),
                  ("K1 flash_combine_kernel", "flash_combine_kernel"),
                  ("K2 resblock_*", "resblock_"),
                  ("K3/K4 flash_q8_kernel", "flash_q8_kernel"),
                  ("K3/K4 flash_q8_combine_kernel", "flash_q8_combine_kernel"),
                  ("K6 a8w8_gemm_kernel", "a8w8_gemm_kernel"),
                  ("K8 w4a8_*", "w4a8_"),
                  ("K6/K8 quantize_rows_kernel", "quantize_rows_kernel"),
                  ("K9 w4_swiglu_kernel", "w4_swiglu_kernel"),
                  ("K10 w4_postattn_kernel", "w4_postattn_kernel"))


def profile_tick(t, top: int = 12, **tick_kw) -> dict:
    """One tick (``run_tick(t, **tick_kw)``) under :func:`profile_run`."""
    return profile_run(lambda: run_tick(t, **tick_kw), top)


def profile_run(run, top: int = 12) -> dict:
    """``run()`` under ``torch.profiler``: the
    device's busy time (kernel durations summed; one stream, so they do not
    overlap), its idle share of the run's host wall time, the device time
    of each kernel of the port (PROFILE_GROUPS) and of everything else, the
    kernels with the most device time, and the host's waits on the device
    (``host_syncs``: CUDA runtime synchronise calls; ``htod_copies``: host
    to device copies, each a wait when its source is pageable).  The
    profiler's raw events are read: ``prof.events()`` would first build an
    event tree of every host op, seconds of host time a step of a large
    model."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    host_syncs = 0
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        if e.device_type() == DeviceType.CUDA:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
        elif e.name() in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaEventSynchronize"):
            host_syncs += 1
    htod = sum(n for name, (_, n) in by_name.items() if "HtoD" in name)
    busy = sum(ms for ms, _ in by_name.values())
    if busy == 0.0:
        raise AssertionError("the profiler saw no CUDA kernel: device time not measured")
    groups = {g: 0.0 for g, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    for name, (ms, _) in by_name.items():
        key = next((g for g, pat in PROFILE_GROUPS if pat in name), "other")
        groups[key] += ms
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(wall_ms=wall_ms, device_busy_ms=busy, idle_share=1.0 - busy / wall_ms,
                host_syncs=host_syncs, htod_copies=htod, groups_ms=groups,
                top=[dict(name=n[:90], ms=ms, calls=c) for n, (ms, c) in ranked])


# ---- the quantized tick ----------------------------------------------------------

# (name, runner, kv_cache, refine, launches the tick must make (every other
# kernel must make none, K5 and K7 included: no module dispatches them),
# shadow calls of its checked tick).  Per chunk: 870 quantized linears at
# M <= 512 (K6 for int8 leaves, K8 for int4), 140 cross-attentions over the
# condition cache (K3 for int8, K4 for int8t, K1 for bf16 and int8x), 140
# self-attentions (K1); SigLIP's 27 and DinoV2's 12 layers (K1) and the
# 120 UNet blocks of the refine (K2).  Runner "int8_kv" is int8 with int8
# condition K/V projections (kv_proj='int8'), which run the plain qdense
# and so launch nothing.  In (a) and (f) the checked tick also holds K5 on
# the 870 K6 operands and K7 on the plain qdense calls at M > 512: the two
# image-adaptor products, and in (f) the 14 image K/V projections.
QUANT_CONFIGS = [
    ("a", "int8", "int8", True, {"K1": 179, "K2": 120, "K3": 140, "K6": 870},
     {"K5": 870, "K7": 2}),
    ("b", "int8", "int8t", True, {"K1": 179, "K2": 120, "K4": 140, "K6": 870}, {}),
    ("c", "int8", "int8x", True, {"K1": 319, "K2": 120, "K6": 870}, {}),
    ("d", "mixed", "bf16", True, {"K1": 319, "K2": 120, "K6": 590, "K8": 280}, {}),
    ("e", "int4", "bf16", False, {"K1": 307, "K8": 870}, {}),
    ("f", "int8_kv", "int8", True, {"K1": 179, "K2": 120, "K3": 140, "K6": 870},
     {"K5": 870, "K7": 16}),
]
INT8_RUNNERS = ("int8", "int8_kv")


def check_outputs(out, refine=True):
    shapes = {"actions": (1, 64, 10)}
    if refine:
        shapes.update(dino=(2, 384), force=(3,), refined=(1, 16, 10))
    for key, shape in shapes.items():
        if out[key].shape != shape or not np.all(np.isfinite(out[key])):
            raise AssertionError(f"{key}: shape {out[key].shape}, finite "
                                 f"{np.all(np.isfinite(out[key]))}")
    if float(np.abs(out["actions"]).max()) == 0.0:
        raise AssertionError("actions are all zero")


def check_counts(what, counts, need):
    want = {k: need.get(k, 0) for k in counts}
    log(f"{what} launches: " + json.dumps(counts) + " (need " + json.dumps(want) + ")")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, need {want}")


def check_chk(what, chk, need):
    log(f"{what}: each kernel call against its plain version on the same operands "
        "(worst call): " + json.dumps({k: v for k, v in chk.items() if v["calls"]}))
    for kernel, s in chk.items():
        if s["calls"] != need.get(kernel, 0) or not s["share"] <= 1.0 or s.get("unlike") \
                or not s.get("group_share", 0.0) <= 1.0:
            raise AssertionError(f"{what}: {kernel} on the tick's own operands: {s}")


def quant_runners(rdt) -> dict:
    """The quantized runners of QUANT_CONFIGS, from the bf16 runner."""
    from vla_touch_tpu_torch.models.rdt import quant_serve as QS

    return {"int8": QS.quantize_rdt_params(rdt, "int8"),
            "int4": QS.quantize_rdt_params(rdt, "int4"),
            "mixed": QS.quantize_rdt_params(rdt, "mixed",
                                            w4_select=QS.make_w4_select(kinds=("fc1", "fc2"))),
            "int8_kv": QS.quantize_rdt_params(rdt, "int8", kv_proj="int8")}


def shadow_checked_tick(t, shadows, **kw):
    """:func:`checked_tick` with K5 and K7 shadowed, their launch counts
    zeroed before and read after; returns (checked, launches), each launch
    one shadow call."""
    fns = kernel_fns()
    for k in ("K5", "K7"):
        fns[k].launches = 0
    chk = checked_tick(t, shadow=True, **kw)
    launches = {k: fns[k].launches for k in ("K5", "K7")}
    if launches != shadows or any(chk[k]["calls"] != n for k, n in shadows.items()):
        raise AssertionError(f"shadow calls {launches}, checked "
                             f"{ {k: chk[k]['calls'] for k in shadows} }, need {shadows}")
    return chk, launches


def quant_ticks(t, bf16_actions) -> dict:
    """Every configuration of QUANT_CONFIGS: the counted tick, the plain
    tick and its corr gates, the checked tick (with K5 and K7 shadowed in
    (a) and (f)), the corr against the bf16 chunk and the p50 of three
    ticks; then one tick through ``create_model(rdt=...).step``."""
    from vla_touch_tpu_torch.runtime import policy as P

    t0 = time.perf_counter()
    runners = quant_runners(t["model"].rdt)
    log(f"quantized the bf16 RDT-1B runner four ways on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    res = {}
    for name, weights, kv, refine, need, shadows in QUANT_CONFIGS:
        kw = dict(rdt=runners[weights], kv_cache=kv, refine=refine)
        what = f"quant tick ({name}) runner={weights} kv_cache={kv}"
        run_tick(t, **kw)                            # warm-up
        zero_counts()
        out = run_tick(t, **kw)
        counts = read_counts()
        check_counts(what, counts, need)
        check_outputs(out, refine)
        with plain_kernels():
            out_p = run_tick(t, **kw)
        c_chunk = action_corr(t, out["actions"], out_p["actions"])
        c_ref = action_corr(t, out["refined"], out_p["refined"]) if refine else None
        c_bf16 = action_corr(t, out["actions"], bf16_actions)
        log(f"{what}: kernel vs plain chunk corr {c_chunk:.6f} (min {CHUNK_CORR_MIN})"
            + (f", refined corr {c_ref:.6f} (min {REFINED_CORR_MIN})" if refine else "")
            + f"; chunk vs the bf16 tick's chunk corr {c_bf16:.6f}"
            + (f" (min {INT8_CHUNK_CORR_MIN})" if weights in INT8_RUNNERS else " (no gate)"))
        if not (c_chunk > CHUNK_CORR_MIN and (not refine or c_ref > REFINED_CORR_MIN)):
            raise AssertionError(f"{what}: kernel tick disagrees with the plain tick")
        if weights in INT8_RUNNERS and not c_bf16 > INT8_CHUNK_CORR_MIN:
            raise AssertionError(f"{what}: int8 chunk vs bf16 chunk corr {c_bf16}")
        if shadows:
            chk, shadow_launches = shadow_checked_tick(t, shadows, **kw)
        else:
            chk, shadow_launches = checked_tick(t, **kw), {}
        check_chk(what, chk, {**need, **shadows})
        ticks = []
        for _ in range(3):
            t1 = time.perf_counter()
            run_tick(t, **kw)
            ticks.append(1e3 * (time.perf_counter() - t1))
        log(f"{what}: tick p50 {np.median(ticks):.2f} ms (ticks "
            f"{[round(x, 2) for x in ticks]})")
        res[name] = dict(runner=weights, kv_cache=kv, refine=refine, launches=counts,
                         corr_vs_plain=c_chunk, refined_corr_vs_plain=c_ref,
                         corr_vs_bf16_chunk=c_bf16, p50_ms=float(np.median(ticks)),
                         shadow_launches=shadow_launches,
                         checked={k: v for k, v in chk.items() if v["calls"]})
    # the user entry point: a model built on the int8 runner dispatches to
    # the twin from step() (bf16 condition cache: step passes no kv_cache)
    qmodel = P.create_model(t["pcfg"], rdt=runners["int8"], vision=t["model"].vision,
                            cache_frames=False)
    run_tick(t, model=qmodel)
    zero_counts()
    out = run_tick(t, model=qmodel)
    check_counts("create_model(rdt=int8 runner).step tick", read_counts(),
                 {"K1": 319, "K2": 120, "K6": 870})
    check_outputs(out)
    res["step"] = dict(launches=read_counts())
    res["runners"] = runners
    return res


# ---- RDT-170M's cold tick ---------------------------------------------------------

# RDT-170M (config.rdt_170m: 1152 x 28 blocks, 16 heads of D 72) as the
# tick's chunk, SigLIP and BRIDGeR as the RDT-1B tick's: bf16 through
# ``create_model(cfg).step`` and tier (a) (int8 weights, the int8 condition
# cache: K3 at D 72) through ``policy_step``; the launches of RDT-1B's
# ticks, its structure being the same
RDT170M_TICKS = (("bf16", None, None, {"K1": 319, "K2": 120}),
                 ("a", "int8", "int8", {"K1": 179, "K2": 120, "K3": 140, "K6": 870}))


def rdt170m_ticks(t) -> dict:
    """RDT-170M's cold tick, bf16 and (a), each counted, checked against
    its plain version (chunk and refine corr), as a checked run, timed
    (p50 of two) and once with a synchronise after each stage; (a)'s chunk
    against the bf16 chunk's corr; then the bf16 tick of RDT-1B and of
    RDT-170M timed in turns (1B, 170M, 170M, 1B)."""
    import torch

    from vla_touch_tpu_torch.config import rdt_170m
    from vla_touch_tpu_torch.models.rdt import quant_serve as QS
    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.runtime import policy as P

    pcfg = P.franka_eef_policy_config(rdt=R.RDTRunnerConfig(model=rdt_170m()))
    model = P.create_model(pcfg, seed=0, vision=t["model"].vision, cache_frames=False)
    # the zero-initialised final projection would make every chunk 0
    gen = torch.Generator(device="cuda").manual_seed(170)
    fc2 = model.rdt.model.final_ffn.fc2.weight
    fc2.copy_((torch.randn(fc2.shape, generator=gen, device="cuda") * 0.02).to(fc2.dtype))
    t170 = dict(t, pcfg=pcfg, model=model)
    res = {}
    for name, weights, kv, need in RDT170M_TICKS:
        kw = {} if weights is None else dict(
            rdt=QS.quantize_rdt_params(model.rdt, weights), kv_cache=kv)
        what = f"RDT-170M tick ({name})"
        run_tick(t170, **kw)                         # warm-up
        zero_counts()
        out = run_tick(t170, **kw)
        counts = read_counts()
        check_counts(what, counts, need)
        check_outputs(out)
        with plain_kernels():
            out_p = run_tick(t170, **kw)
        c_chunk = action_corr(t170, out["actions"], out_p["actions"])
        c_ref = action_corr(t170, out["refined"], out_p["refined"])
        c_bf16 = action_corr(t170, out["actions"], res["bf16"]["actions"]) if kw else None
        log(f"{what}: kernel vs plain chunk corr {c_chunk:.6f} (min {CHUNK_CORR_MIN}), "
            f"refined corr {c_ref:.6f} (min {REFINED_CORR_MIN})"
            + (f"; chunk vs the bf16 chunk corr {c_bf16:.6f} (min {INT8_CHUNK_CORR_MIN})"
               if kw else ""))
        if not (c_chunk > CHUNK_CORR_MIN and c_ref > REFINED_CORR_MIN):
            raise AssertionError(f"{what}: kernel tick disagrees with the plain tick")
        if kw and not c_bf16 > INT8_CHUNK_CORR_MIN:
            raise AssertionError(f"{what}: int8 chunk vs bf16 chunk corr {c_bf16}")
        chk = checked_tick(t170, **kw)
        check_chk(f"{what} checked", chk, need)
        ticks = []
        for _ in range(2):
            t1 = time.perf_counter()
            run_tick(t170, **kw)
            ticks.append(1e3 * (time.perf_counter() - t1))
        stages = {}
        run_tick(t170, stage_ms=stages, **kw)
        log(f"{what}: tick p50 {np.median(ticks):.2f} ms (ticks "
            f"{[round(x, 2) for x in ticks]}); stage ms (a synchronise after each): "
            + json.dumps({k: round(v[0], 3) for k, v in stages.items()}))
        res[name] = dict(launches=counts, corr_vs_plain=c_chunk, refined_corr_vs_plain=c_ref,
                         corr_vs_bf16_chunk=c_bf16, p50_ms=float(np.median(ticks)),
                         stage_ms={k: v[0] for k, v in stages.items()},
                         checked={k: v for k, v in chk.items() if v["calls"]},
                         actions=out["actions"])
    for r in res.values():
        r.pop("actions")
    turns = {"rdt_1b": [], "rdt_170m": []}
    for who in ("rdt_1b", "rdt_170m", "rdt_170m", "rdt_1b"):
        t1 = time.perf_counter()
        run_tick(t if who == "rdt_1b" else t170)
        turns[who].append(1e3 * (time.perf_counter() - t1))
    log("bf16 tick in turns (1B, 170M, 170M, 1B), ms: " + json.dumps(turns))
    res["bf16_in_turns_ms"] = turns
    return res


# ---- the steady-state tick -------------------------------------------------------

# The replan interval of the chunk scheduler (runtime/control_loop.py): the
# prior is the previous chunk shifted by this many executed ticks
WARM_SHIFT = 16
WARM_SKIP = 2                      # the solver steps a warm replan skips
# bench.py's warm-vs-cold quality mark: the warm chunk's corr with the cold
# chunk at the same noise.  With random weights it is a printed finding, not
# a gate.
WARM_CORR_MARK = 0.999
# The int8 SigLIP tier's tokens against the bf16 module's: the JAX bench's
# token gate for it
VIT_INT8_TOKEN_CORR_MIN = 0.999


def warm_need(t, skip, quant, seeding=False) -> dict:
    """Launches of one warm tick at ``skip`` through the frame-token cache:
    SigLIP on the 3 new frames (both windows' 6 on the seeding call, whose
    t-1 tokens miss the cache), the solver's last ``steps - skip`` steps,
    DinoV2's pair, the refine's 120 UNet blocks.  Per step the bf16 runner
    makes 2 x depth K1 calls (self- and cross-attention); the int8 twin with
    the int8 cache ((a)) depth K1 and depth K3 calls, and its K6 calls are
    the cold tick's per-step share for each step run plus its once-a-chunk
    share: per step 6 linears a block (qkv, proj, q, cross proj, fc1, fc2),
    the final head's 2 and the action adaptor's; once the language and
    state adaptors' (the image adaptor, at 4374 rows, takes the plain
    route)."""
    from vla_touch_tpu_torch.models.encoders.vit import DINOV2_SMALL

    m = t["pcfg"].rdt.model
    steps = t["pcfg"].rdt.noise.num_inference_timesteps
    siglip = t["pcfg"].vision.num_layers * (2 if seeding else 1)
    left = steps - skip
    need = {"K2": 12 * K2_STEPS}
    if not quant:
        need["K1"] = siglip + left * 2 * m.depth + DINOV2_SMALL.num_layers
        return need
    rdt = t["model"].rdt
    per_step = 6 * m.depth + 2 + rdt.state_adaptor.depth
    once = rdt.lang_adaptor.depth + rdt.state_adaptor.depth
    cold_k6 = dict(QUANT_CONFIGS[0][4])["K6"]
    if steps * per_step + once != cold_k6:
        raise AssertionError(f"K6 per step {per_step} x {steps} + once {once} is not the "
                             f"cold tick's {cold_k6}")
    need.update(K1=siglip + left * m.depth + DINOV2_SMALL.num_layers, K3=left * m.depth,
                K6=left * per_step + once)
    return need


def warm_feed(t, n: int, seed: int = 7) -> list:
    """``n`` six-frame windows of a moving scene: window i holds frame
    triples i and i + 1, so each call's t-1 frames are the previous call's t
    frames and hit the model's token cache."""
    rng = np.random.default_rng(seed)
    S = t["pcfg"].image_size
    triples = [list(t["inp"]["frames"][:3]), list(t["inp"]["frames"][3:])] + [
        [rng.integers(0, 256, (S, S, 3)).astype(np.uint8) for _ in range(3)]
        for _ in range(n - 1)]
    return [triples[i] + triples[i + 1] for i in range(n)]


def host_p50(run, n: int = 3):
    ticks = []
    for _ in range(n):
        t1 = time.perf_counter()
        run()
        ticks.append(1e3 * (time.perf_counter() - t1))
    return float(np.median(ticks)), [round(x, 2) for x in ticks]


def warm_config(t, what, model, quant) -> dict:
    """The steady-state tick of ``model`` (``create_model(...,
    cache_frames=True)``): its launches asserted on a seeding call and a
    cache hit, the kernel tick against the plain tick, the checked tick,
    ``skip_steps=0`` against the cold chunk, the warm-vs-cold corr at skips
    3, 2 and 1, the p50 at WARM_SKIP and at the largest skip that passes the
    mark, the stage p50 and one profiled tick."""
    import torch

    from vla_touch_tpu_torch.runtime.control_loop import shift_prior

    feed = warm_feed(t, 26)
    gen = torch.Generator(device="cuda").manual_seed(11)
    m = t["pcfg"].rdt.model
    noise_b = torch.randn((1, m.horizon, m.output_dim), generator=gen, device="cuda")
    model.reset()
    cold0 = run_tick(t, model=model, frames=feed[0], refine=False)
    prior = shift_prior(cold0["actions"][0], WARM_SHIFT)
    kw = dict(model=model, prior=prior, skip=WARM_SKIP)

    # seeding call (cache miss after reset), then a hit
    model.reset()
    zero_counts()
    run_tick(t, frames=feed[1], **kw)
    check_counts(f"{what} seeding call", read_counts(), warm_need(t, WARM_SKIP, quant, True))
    zero_counts()
    out = run_tick(t, frames=feed[2], **kw)
    counts = read_counts()
    check_counts(f"{what} (cache hit)", counts, warm_need(t, WARM_SKIP, quant))
    check_outputs(out)

    with plain_kernels():
        model.reset()
        run_tick(t, frames=feed[1], **kw)
        out_p = run_tick(t, frames=feed[2], **kw)
    c_chunk = action_corr(t, out["actions"], out_p["actions"])
    c_ref = action_corr(t, out["refined"], out_p["refined"])
    log(f"{what}: kernel vs plain warm tick: chunk corr {c_chunk:.6f} (min {CHUNK_CORR_MIN}), "
        f"refined corr {c_ref:.6f} (min {REFINED_CORR_MIN})")
    if not (c_chunk > CHUNK_CORR_MIN and c_ref > REFINED_CORR_MIN):
        raise AssertionError(f"{what}: kernel warm tick disagrees with the plain warm tick")

    model.reset()
    run_tick(t, frames=feed[1], **kw)
    chk = checked_run(lambda: run_tick(t, frames=feed[2], **kw))
    check_chk(f"{what} checked tick", chk, warm_need(t, WARM_SKIP, quant))

    # skip 0 with a prior is the cold chunk, bit for bit
    model.reset()
    cold = run_tick(t, model=model, frames=feed[1], noise=noise_b, refine=False)["actions"]
    model.reset()
    warm0 = run_tick(t, model=model, frames=feed[1], noise=noise_b, prior=prior, skip=0,
                     refine=False)["actions"]
    if not np.array_equal(cold, warm0):
        raise AssertionError(f"{what}: skip_steps=0 with a prior differs from the cold chunk "
                             f"(max {float(np.abs(cold - warm0).max())})")

    # warm vs cold at the same noise (bench.py:439-455), the prior from the
    # chunk of window 0 at the tick's noise
    model.reset()
    cold_b = run_tick(t, model=model, frames=feed[1], noise=noise_b)
    quality = {}
    for skip in (3, 2, 1):
        model.reset()
        w = run_tick(t, model=model, frames=feed[1], noise=noise_b, prior=prior, skip=skip)
        quality[skip] = dict(chunk_corr=action_corr(t, w["actions"], cold_b["actions"]),
                             refined_corr=action_corr(t, w["refined"], cold_b["refined"]))
    passed = max((k for k, q in quality.items() if q["chunk_corr"] > WARM_CORR_MARK),
                 default=None)
    log(f"{what}: warm vs cold chunk at the same noise (mark {WARM_CORR_MARK}, random "
        f"weights: a finding, not a gate): " + json.dumps(quality) + "; largest skip above "
        f"the mark: " + ("none passed" if passed is None else str(passed)))

    # times: a run of cache hits from window 3 on, the warm tick at
    # WARM_SKIP in turns with the cold tick through the same cache (the
    # host's speed drifts within a call)
    model.reset()
    run_tick(t, frames=feed[2], **kw)
    it = iter(range(3, len(feed)))
    ticks = {"cold": [], WARM_SKIP: []}
    for _ in range(5):
        for key in ticks:
            t1 = time.perf_counter()
            run_tick(t, frames=feed[next(it)], **(kw if key == WARM_SKIP else dict(model=model)))
            ticks[key].append(1e3 * (time.perf_counter() - t1))
    times = {k: float(np.median(v)) for k, v in ticks.items()}
    log(f"{what}: warm tick (skip {WARM_SKIP}) p50 {times[WARM_SKIP]:.2f} ms "
        f"(ticks {[round(x, 2) for x in ticks[WARM_SKIP]]})"
        + ("" if quality[WARM_SKIP]["chunk_corr"] > WARM_CORR_MARK
           else ", failing the quality check")
        + f"; in turns with the cold tick through the same token cache, p50 "
        f"{times['cold']:.2f} ms (ticks {[round(x, 2) for x in ticks['cold']]})")
    if passed is not None and passed != WARM_SKIP:
        p50, ticks = host_p50(lambda: run_tick(t, frames=feed[next(it)], model=model,
                                               prior=prior, skip=passed))
        times[passed] = p50
        log(f"{what}: warm tick (skip {passed}, the largest passing) p50 {p50:.2f} ms "
            f"(ticks {ticks})")
    stages = {}
    for _ in range(3):
        run_tick(t, frames=feed[next(it)], stage_ms=stages, siglip_stage="siglip_3_frames",
                 **kw)
    stages = {k: round(float(np.median(v)), 3) for k, v in stages.items()}
    log(f"{what}: stage p50 ms (ticks with a synchronise after each stage): "
        + json.dumps(stages))
    prof = profile_run(lambda: run_tick(t, frames=feed[next(it)], **kw))
    log(f"{what}: profile: " + json.dumps(prof))
    return dict(launches=counts, corr_vs_plain=c_chunk, refined_corr_vs_plain=c_ref,
                checked={k: v for k, v in chk.items() if v["calls"]}, quality=quality,
                passed_skip=passed, p50_ms=times, stage_ms=stages,
                busy_ms=prof["device_busy_ms"], idle_share=prof["idle_share"],
                host_syncs=prof["host_syncs"])


def vit_tiers(t, feed) -> dict:
    """The SigLIP serving twin's bf16 and int8 tiers on the warm tick's 3
    new frames and a cold tick's 6: tokens against the bf16 module's
    (bf16 > TOKEN_CORR_MIN, int8 > VIT_INT8_TOKEN_CORR_MIN), K1's 27
    launches an encode (the int8 linears, at M 2187 and 4374, take the
    plain qdense: no K6), and the ms of an encode beside the module's."""
    import torch

    from vla_touch_tpu_torch.models.encoders import vit_serve as VS
    from vla_touch_tpu_torch.runtime import policy as P

    pcfg, vision = t["pcfg"], t["model"].vision
    twins = {tier: VS.quantize_vit_params(vision, tier) for tier in ("bf16", "int8")}
    layers = pcfg.vision.num_layers
    res = {}
    for nf in (3, 6):
        frames = torch.as_tensor(np.stack(feed[1][6 - nf:])[None], device="cuda")
        mask = torch.ones((1, nf), dtype=torch.bool, device="cuda")
        want = P.encode_frames(pcfg, vision, frames, mask).float().cpu().numpy()
        row = {"module_ms": cuda_time_ms(lambda: P.encode_frames(pcfg, vision, frames, mask),
                                         reps=5, warmup=1)}
        for tier, twin in twins.items():
            zero_counts()
            got = P.encode_frames(pcfg, twin, frames, mask).float().cpu().numpy()
            check_counts(f"SigLIP {tier} tier, {nf} frames", read_counts(), {"K1": layers})
            c = corr(got, want)
            gate = TOKEN_CORR_MIN if tier == "bf16" else VIT_INT8_TOKEN_CORR_MIN
            if not (got.shape == want.shape and np.all(np.isfinite(got)) and c > gate):
                raise AssertionError(f"SigLIP {tier} tier, {nf} frames: token corr {c}, "
                                     f"shape {got.shape}")
            ms = cuda_time_ms(lambda: P.encode_frames(pcfg, twin, frames, mask), reps=5,
                              warmup=1)
            row[tier] = dict(token_corr=c, min=gate, ms=ms)
        res[nf] = row
        log(f"SigLIP tiers, {nf} frames: " + json.dumps(row))
    return res, twins


def reference_style_chunk(t, feed) -> dict:
    """The reference's sampler once at full width (every step re-runs the
    full model, 28 blocks' K/V over the 4374 image tokens recomputed):
    K1 5 x 56 launches, its chunk against the cached chunk on the same
    inputs and noise, and both chunks' host ms."""
    import torch

    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.runtime import policy as P

    pcfg, rdt = t["pcfg"], t["model"].rdt
    m = pcfg.rdt.model
    inp = t["inp"]
    frames = torch.as_tensor(np.stack(feed[1])[None], device="cuda")
    tokens = P.encode_frames(pcfg, t["model"].vision, frames,
                             torch.ones((1, 6), dtype=torch.bool, device="cuda"))
    state = torch.zeros((1, 1, m.state_token_dim), device="cuda")
    idx = list(pcfg.state_indices)
    state[0, 0, idx] = torch.as_tensor(inp["proprio"], device="cuda")
    amask = torch.zeros((1, 1, m.state_token_dim), device="cuda")
    amask[0, 0, idx] = 1.0
    args = (pcfg.rdt, rdt, torch.as_tensor(inp["text"], device="cuda").to(m.compute_dtype),
            torch.as_tensor(inp["text_mask"], device="cuda"), tokens, state.to(m.compute_dtype),
            amask, torch.full((1,), pcfg.control_frequency, device="cuda"))
    steps = pcfg.rdt.noise.num_inference_timesteps
    res = {}
    for name, fn in (("reference_style", R.rdt_predict_action_reference_style),
                     ("cached", R.rdt_predict_action)):
        fn(*args, init_noise=inp["init_noise"])                   # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t1 = time.perf_counter()
        chunk = fn(*args, init_noise=inp["init_noise"])
        torch.cuda.synchronize()
        res[name] = dict(ms=1e3 * (time.perf_counter() - t1), launches=read_counts(),
                         chunk=chunk[0, :, idx].float().cpu().numpy())
    check_counts("reference-style chunk", res["reference_style"]["launches"],
                 {"K1": steps * 2 * m.depth})
    c = corr(res["reference_style"]["chunk"], res["cached"]["chunk"])
    log(f"reference-style chunk: {res['reference_style']['ms']:.2f} ms against the "
        f"condition-K/V-cached chunk's {res['cached']['ms']:.2f} ms (host clock, one chunk "
        f"each); chunk corr {c:.6f} (min {CHUNK_CORR_MIN})")
    if not c > CHUNK_CORR_MIN:
        raise AssertionError(f"reference-style chunk vs cached chunk corr {c}")
    return dict(ms=res["reference_style"]["ms"], cached_ms=res["cached"]["ms"], corr=c)


def warm_phase(t, int8_runner) -> dict:
    """The steady-state control tick at full width: bf16 and configuration
    (a) (int8 weights + int8 cache) through ``create_model(...,
    cache_frames=True).step(prior_actions=, skip_steps=)``, the SigLIP
    serving tiers and one warm tick through each, and the reference-style
    chunk."""
    from vla_touch_tpu_torch.runtime import policy as P

    pcfg, vision, rdt = t["pcfg"], t["model"].vision, t["model"].rdt
    res = {"bf16": warm_config(t, "warm tick bf16",
                               P.create_model(pcfg, rdt=rdt, vision=vision, cache_frames=True),
                               quant=False)}
    res["a"] = warm_config(t, "warm tick (a) int8 + int8 cache",
                           P.create_model(pcfg, rdt=int8_runner, vision=vision,
                                          cache_frames=True, kv_cache="int8"), quant=True)
    feed = warm_feed(t, 4)
    res["vit_tiers"], twins = vit_tiers(t, feed)
    from vla_touch_tpu_torch.runtime.control_loop import shift_prior

    base = P.create_model(pcfg, rdt=rdt, vision=vision, cache_frames=True)
    prior = shift_prior(run_tick(t, model=base, frames=feed[0], refine=False)["actions"][0],
                        WARM_SHIFT)
    for tier, twin in twins.items():
        outs = {}
        for name, vis in (("module", vision), (tier, twin)):
            model = P.create_model(pcfg, rdt=rdt, vision=vis, cache_frames=True)
            run_tick(t, model=model, frames=feed[1], prior=prior, skip=WARM_SKIP)
            zero_counts()
            outs[name] = run_tick(t, model=model, frames=feed[2], prior=prior, skip=WARM_SKIP)
            if name == tier:
                check_counts(f"warm tick, SigLIP {tier} tier", read_counts(),
                             warm_need(t, WARM_SKIP, quant=False))
                check_outputs(outs[name])
        c = action_corr(t, outs[tier]["actions"], outs["module"]["actions"])
        res["vit_tiers"][f"warm_tick_{tier}_chunk_corr_vs_module"] = c
        log(f"warm tick through the SigLIP {tier} tier: chunk corr vs the module's {c:.6f}")
    res["reference_style"] = reference_style_chunk(t, feed)
    return res


# ---- the deployment entry points: the serving pool and the replay CLI ---------------

# (bucket, requests) of the serving phase's deterministic batches: buckets 4
# and 8 carry one zero pad row each
SERVE_BATCHES = ((1, 1), (2, 2), (4, 3), (8, 7))
SERVE_WAIT_MS = 200.0              # the deterministic batches' coalescing window
SERVE_ROBOTS = 8
SERVE_ROUNDS = 2                   # requests per robot thread, one after another
SERVE_TIMEOUT_S = 120.0


def serving_requests(t, n: int, seed: int = 11) -> list:
    """``n`` robots' requests at full width: six 384^2 frames, a 20-64
    token instruction of 4096-wide embeddings (padded to the model's 1024
    by the pool), the 10-D state."""
    rng = np.random.default_rng(seed)
    S, D = t["pcfg"].image_size, t["pcfg"].rdt.model.lang_token_dim
    out = []
    for _ in range(n):
        L = int(rng.integers(20, 65))
        out.append(dict(proprio=rng.normal(size=(10,)).astype(np.float32),
                        images=rng.integers(0, 256, (6, S, S, 3)).astype(np.uint8),
                        image_mask=np.ones((6,), bool),
                        text_embeds=rng.normal(size=(L, D)).astype(np.float32),
                        text_mask=np.ones((L,), bool)))
    return out


def pool_batch(t, rdt, reqs, seed: int) -> np.ndarray:
    """``reqs`` through a fresh ``from_policy`` pool (seeded ``seed``), all
    submitted within its coalescing window: one batch; each future's row."""
    from vla_touch_tpu_torch.runtime import serving_pool as SP

    with SP.from_policy(t["pcfg"], rdt, t["model"].vision, seed=seed,
                        max_wait_ms=SERVE_WAIT_MS) as pool:
        futs = [pool.submit(**r) for r in reqs]
        return np.stack([f.result(timeout=SERVE_TIMEOUT_S) for f in futs])


def padded_batch(t, reqs, bucket: int) -> dict:
    """The tensors the pool hands ``policy_step`` for ``reqs`` at
    ``bucket``: zero pad rows, text padded to ``max_lang_cond_len``."""
    import torch

    from vla_touch_tpu_torch.runtime import serving_pool as SP

    L = t["pcfg"].rdt.model.max_lang_cond_len
    return {k: torch.as_tensor(SP._pad_rows([r[k] for r in reqs], bucket,
                                            L if k.startswith("text") else None),
                               device="cuda") for k in reqs[0]}


def pool_noise(t, bucket: int, seed: int):
    """The first draw of a pool seeded ``seed``: its first batch's noise."""
    import torch

    m = t["pcfg"].rdt.model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((bucket, m.horizon, m.output_dim), generator=gen, device="cuda")


def serve_need(t, bucket: int, quant: bool) -> dict:
    """Launches of one pool batch: SigLIP's layers (one encode of 6 x
    bucket frames), 2 x depth K1 calls a solver step.  The int8 twin's K6
    calls are its linears at M <= 512 (``qdense_kernel_a8w8``; above, the
    plain route): per step the blocks' 6 (qkv, proj, q, cross proj, fc1,
    fc2) and the final head's 2 at M = 67 x bucket, and the action
    adaptor's at M = 64 x bucket; once, the state adaptor's at M = bucket,
    the language adaptor's at M = 1024 x bucket and the image adaptor's at
    M = 4374 x bucket (at RDT-1B's widths those two take the plain
    route)."""
    m = t["pcfg"].rdt.model
    steps = t["pcfg"].rdt.noise.num_inference_timesteps
    need = {"K1": t["pcfg"].vision.num_layers + steps * 2 * m.depth}
    if quant:
        rdt = t["model"].rdt

        def k6(M, calls):
            return calls if M <= 512 else 0

        per_step = (k6(bucket * (m.horizon + 3), 6 * m.depth + 2)
                    + k6(bucket * m.horizon, rdt.state_adaptor.depth))
        need["K6"] = (steps * per_step + k6(bucket, rdt.state_adaptor.depth)
                      + k6(bucket * m.max_lang_cond_len, rdt.lang_adaptor.depth)
                      + k6(bucket * m.img_cond_len, rdt.img_adaptor.depth))
    return need


def serving_phase(t, int8_runner) -> dict:
    """The multi-robot serving pool at full width (SigLIP-so400m, RDT-1B):
    one deterministic batch per bucket through ``from_policy`` on the bf16
    runner and on the int8 twin, each row held to the direct batched
    ``policy_step`` on the same padded batch and noise (bit for bit) and to
    the request served alone at bucket 1 with its noise row (chunk corr >
    CHUNK_CORR_MIN), the int8 rows to the bf16 rows (> INT8_CHUNK_CORR_MIN),
    each batch also a checked run; then SERVE_ROBOTS robot threads with the
    default 3 ms window.  Returns the launch counts of the pool runs."""
    import threading

    import torch

    from vla_touch_tpu_torch.runtime import policy as P
    from vla_touch_tpu_torch.runtime import serving_pool as SP

    pcfg, vision = t["pcfg"], t["model"].vision
    reqs = serving_requests(t, max(n for _, n in SERVE_BATCHES))
    total = {k: 0 for k in WRAPPERS}
    res = {"batches": {}}
    bf16_rows = {}

    def count(counts):
        for k, v in counts.items():
            total[k] += v

    for name, rdt, quant in (("bf16", t["model"].rdt, False), ("int8", int8_runner, True)):
        for bucket, n in SERVE_BATCHES:
            what = f"serving {name} bucket {bucket} ({n} requests)"
            seed = 100 + bucket
            zero_counts()
            rows = pool_batch(t, rdt, reqs[:n], seed)
            counts = read_counts()
            count(counts)
            check_counts(what, counts, serve_need(t, bucket, quant))
            batch = padded_batch(t, reqs[:n], bucket)
            noise = pool_noise(t, bucket, seed)
            direct = P.policy_step(pcfg, rdt, vision, **batch, init_noise=noise).cpu().numpy()
            if not np.isfinite(direct).all():
                raise AssertionError(f"{what}: a row of the direct batch is not finite")
            diff = float(np.abs(rows - direct[:n]).max())
            if diff != 0.0:
                raise AssertionError(f"{what}: pool rows differ from the direct batched call "
                                     f"by {diff}")
            alone = []
            for i in range(n):
                one = padded_batch(t, reqs[i:i + 1], 1)
                alone.append(P.policy_step(pcfg, rdt, vision, **one,
                                           init_noise=noise[i:i + 1]).cpu().numpy()[0])
            c_alone = min(action_corr(t, rows[i], alone[i]) for i in range(n))
            if not c_alone > CHUNK_CORR_MIN:
                raise AssertionError(f"{what}: a row against its request served alone at "
                                     f"bucket 1: corr {c_alone} <= {CHUNK_CORR_MIN}")
            entry = {"pool_vs_direct_max_abs": diff, "min_corr_vs_alone": c_alone,
                     "launches": counts}
            if quant:
                c8 = min(action_corr(t, rows[i], bf16_rows[bucket][i]) for i in range(n))
                if not c8 > INT8_CHUNK_CORR_MIN:
                    raise AssertionError(f"{what}: int8 vs bf16 rows corr {c8} <= "
                                         f"{INT8_CHUNK_CORR_MIN}")
                entry["min_corr_vs_bf16"] = c8
            else:
                bf16_rows[bucket] = rows
            need = serve_need(t, bucket, quant)
            chk = checked_run(lambda: pool_batch(t, rdt, reqs[:n], seed))
            check_chk(f"{what} checked", chk, need)
            entry["checked"] = {k: v for k, v in chk.items() if v["calls"]}
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                P.policy_step(pcfg, rdt, vision, **batch, init_noise=noise).cpu()
                ms.append(1e3 * (time.perf_counter() - t1))
            entry["batch_ms_p50"] = float(np.median(ms))
            log(f"{what}: rows = direct call (max abs {diff}), min corr vs alone "
                f"{c_alone:.6f}" + (f", vs bf16 {entry['min_corr_vs_bf16']:.6f}" if quant else "")
                + f", batch p50 {entry['batch_ms_p50']:.2f} ms ({[round(x, 2) for x in ms]})")
            res["batches"][f"{name}_b{bucket}"] = entry

    # SERVE_ROBOTS robots, each submitting SERVE_ROUNDS requests one after
    # another, through one pool with the default window
    robot_reqs = serving_requests(t, SERVE_ROBOTS * SERVE_ROUNDS, seed=12)
    lat, dispatched, errors = [], [], []
    pool = SP.from_policy(pcfg, t["model"].rdt, vision, seed=7)
    inner = pool._fn

    def timed(proprio, *a):
        t1 = time.perf_counter()
        out = inner(proprio, *a)
        torch.cuda.synchronize()
        dispatched.append((int(proprio.shape[0]), 1e3 * (time.perf_counter() - t1)))
        return out

    pool._fn = timed
    results = [None] * len(robot_reqs)

    def robot(r):
        try:
            for k in range(SERVE_ROUNDS):
                i = r * SERVE_ROUNDS + k
                t1 = time.perf_counter()
                results[i] = pool.submit(**robot_reqs[i]).result(timeout=SERVE_TIMEOUT_S)
                lat.append(1e3 * (time.perf_counter() - t1))
        except Exception as e:                       # noqa: BLE001
            errors.append(e)

    zero_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=robot, args=(r,)) for r in range(SERVE_ROBOTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    pool.close()
    counts = read_counts()
    count(counts)
    if errors:
        raise errors[0]
    shape = (pcfg.rdt.model.horizon, len(pcfg.state_indices))
    for i, row in enumerate(results):
        if row is None or row.shape != shape or not np.isfinite(row).all():
            raise AssertionError(f"robot request {i}: {None if row is None else row.shape}")
    check_counts("serving robots", counts,
                 {"K1": serve_need(t, 1, False)["K1"] * len(dispatched)})
    hist = {b: sum(1 for x, _ in dispatched if x == b) for b in (1, 2, 4, 8)}
    res["robots"] = {
        "robots": SERVE_ROBOTS, "requests": len(results), "wall_s": wall,
        "requests_per_s": len(results) / wall,
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p95": float(np.percentile(lat, 95)),
        "buckets_dispatched": hist,
        "batch_ms_p50": {b: float(np.median([ms for x, ms in dispatched if x == b]))
                         for b in hist if hist[b]}}
    log("serving robots: " + json.dumps(res["robots"]))
    res["launches"] = total
    return res


REPLAY_STEPS = 32
REPLAY_EPISODE_STEPS = 96


def replay_need(t, refiner: str, warm_skip: int) -> dict:
    """Launches of one replay of REPLAY_STEPS steps (a replan every 16):
    each replan encodes both frames' cameras (two SigLIP encodes: the t-1
    frames never equal the previous replan's t frames) and runs the solver
    (2 x depth K1 calls a step; a warm replan skips ``warm_skip`` steps);
    BRIDGeR adds the DinoV2 pair and 120 UNet blocks a replan, the LSTM the
    DinoV2 pair at each replan."""
    from vla_touch_tpu_torch.models.encoders.vit import DINOV2_SMALL

    m, steps = t["pcfg"].rdt.model, t["pcfg"].rdt.noise.num_inference_timesteps
    replans = -(-REPLAY_STEPS // 16)
    siglip = 2 * t["pcfg"].vision.num_layers
    warm = replans - 1 if warm_skip else 0
    k1 = replans * siglip + 2 * m.depth * ((replans - warm) * steps + warm * (steps - warm_skip))
    need = {"K1": k1}
    if refiner != "none":
        need["K1"] += replans * 2 * DINOV2_SMALL.num_layers
    if refiner == "bridge":
        need["K2"] = replans * 12 * K2_STEPS
    return need


def replay_phase(t) -> dict:
    """The replay CLI at full width: an npz episode (REPLAY_EPISODE_STEPS
    steps, 384^2 cameras, a 64 x 4096 instruction), the bf16 runner written
    as an HF-layout RDT-1B checkpoint (validated against the rdt_1b
    manifest, read back bit for bit), BRIDGeR and LSTM checkpoints with a
    persisted DinoV2, then ``replay_cli.main`` over REPLAY_STEPS steps with
    the refiner none, bridge (warm replans, skip 2) and lstm, launch counts
    and stage counts asserted; one bridge replan as a checked run."""
    import argparse
    import logging
    import shutil

    import torch

    from vla_touch_tpu_torch.config import BridgeControllerConfig, LSTMControllerConfig
    from vla_touch_tpu_torch.data.episode import write_synthetic_episode
    from vla_touch_tpu_torch.models.controllers import bridge as BR
    from vla_touch_tpu_torch.models.controllers import lstm as LC
    from vla_touch_tpu_torch.models.encoders import dinov2_runtime as dino
    from vla_touch_tpu_torch.runtime import replay_cli as RC
    from vla_touch_tpu_torch.runtime.control_loop import EpisodeReplay
    from vla_touch_tpu_torch.utils import checkpoint_manifest as CM
    from vla_touch_tpu_torch.utils import torch_port as TP

    out = os.path.join(ROOT, "build", "replay")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    res = {}
    level = logging.getLogger().level         # the CLI's main sets INFO
    try:
        ep = os.path.join(out, "episode.npz")
        write_synthetic_episode(ep, num_steps=REPLAY_EPISODE_STEPS,
                                img_size=t["pcfg"].image_size, lang_len=64,
                                lang_dim=t["pcfg"].rdt.model.lang_token_dim, with_vla=False)
        rdt = t["model"].rdt
        ckpt = os.path.join(out, "model.safetensors")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        TP.save_rdt_checkpoint(ckpt, rdt)
        write_s = time.perf_counter() - t1
        diff = CM.validate_checkpoint(ckpt, "rdt_1b")
        log("replay checkpoint: " + diff.summary("rdt_1b"))
        if not diff.ok:
            raise AssertionError("the written RDT-1B checkpoint fails the rdt_1b manifest")
        t1 = time.perf_counter()
        loaded = TP.load_rdt_runner(ckpt, t["pcfg"].rdt)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t1
        want = rdt.state_dict()
        for name, v in loaded.state_dict().items():
            if v.dtype != want[name].dtype or not torch.equal(v, want[name]):
                raise AssertionError(f"checkpoint round trip: {name} differs")
        del loaded
        res["checkpoint"] = {"bytes": os.path.getsize(ckpt), "write_s": write_s,
                             "read_s": read_s}
        log("replay checkpoint: " + json.dumps(res["checkpoint"]))
        stats = t["stats"]
        bdir, ldir = os.path.join(out, "bridge"), os.path.join(out, "lstm")
        bst = BR.init_bridge_controller(BridgeControllerConfig(inference_dtype="bfloat16",
                                                               horizon=16), seed=21)
        bst.stats = stats
        BR.save_bridge_controller(bdir, bst)
        lst = LC.init_lstm_controller(LSTMControllerConfig(), seed=22)
        lst.stats = stats
        LC.save_lstm_controller(ldir, lst)
        enc = dino.init_params("dinov2-small", seed=23)
        for d in (bdir, ldir):
            dino.save_params(d, "dinov2-small", enc)
        del bst, lst, enc

        base = ["--episode", ep, "--rdt_checkpoint", ckpt, "--steps", str(REPLAY_STEPS),
                "--bridge_ckpt", bdir, "--lstm_ckpt", ldir]
        runs = (("none", []), ("bridge", ["--warm_skip", str(WARM_SKIP)]), ("lstm", []))
        total = {k: 0 for k in WRAPPERS}
        res["runs"] = {}
        for refiner, extra in runs:
            zero_counts()
            report = RC.main(base + ["--refiner", refiner] + extra)
            counts = read_counts()
            for k, v in counts.items():
                total[k] += v
            warm = WARM_SKIP if extra else 0
            check_counts(f"replay {refiner}", counts, replay_need(t, refiner, warm))
            replans = -(-REPLAY_STEPS // 16)
            stage_need = ({"vla_plan": 1, "vla_plan_warm": replans - 1} if warm
                          else {"vla_plan": replans})
            stage_need.update({"bridge": {"bridge_refine": replans},
                               "lstm": {"lstm_step": REPLAY_STEPS}}.get(refiner, {}))
            got = {k: v["count"] for k, v in report["stages"].items()}
            if got != stage_need or report["steps"] != REPLAY_STEPS \
                    or not np.isfinite(report["tracking_mse"]):
                raise AssertionError(f"replay {refiner}: stages {got} (need {stage_need}), "
                                     f"report {report}")
            log(f"replay {refiner} report: " + json.dumps(report))
            res["runs"][refiner] = report
        # one replan of the bridge run (its first tick) as a checked run
        args = argparse.Namespace(rdt_checkpoint=ckpt, refiner="bridge", bridge_ckpt=bdir,
                                  lstm_ckpt=None, replan_interval=16, refine_horizon=16,
                                  gripper_deadband=2.0, warm_skip=WARM_SKIP, device=None)
        replay = EpisodeReplay(ep)
        sched = RC.build_scheduler(args, replay)
        acts = []
        chk = checked_run(lambda: acts.append(sched.tick(replay.observation(0))))
        if not np.isfinite(acts[0]).all():
            raise AssertionError("replay checked replan: the action is not finite")
        need = replay_need(t, "bridge", 0)
        replans = -(-REPLAY_STEPS // 16)
        check_chk("replay bridge replan checked", chk,
                  {k: v // replans for k, v in need.items()})
        res["checked_replan"] = {k: v for k, v in chk.items() if v["calls"]}
        res["launches"] = total
    finally:
        shutil.rmtree(out, ignore_errors=True)
        logging.getLogger().setLevel(level)
    return res


# ---- the planner: K9 / K10, and K8 and K1 at its shapes ---------------------------

QWEN_D, QWEN_F = 3584, 18944        # Qwen2.5-7B hidden and MLP widths
# the rows of the LLM training steps' forwards (llm_train_phase): the LoRA
# run's four PhysiCLeAR rows and the projector run's short rows (asserted
# against the data)
K8_TRAIN_MS = (495, 150, 178, 210, 22)
K9_MS = (1, 8, 22, 24)
K10_MS = (1, 8)
# (M, K, N, calls per decode token or prompt pass) of the planner's w4
# linears through K8: the unfused tree's q and o (3584 -> 3584), k and v
# (-> 512), gate and up (-> 18944) and down (18944 -> 3584, 148 groups);
# the fused tree's qkv (-> 4608) and gateup (-> 37888); the lm_head (->
# 152064).  M = 1 greedy, M = 8 the best-of-8 decode; M = 72 and 442 the
# prompt passes of describe and guess (qkv, o, gateup and down, rolled G);
# then the LLM training steps' forwards (llm_train_phase, calls per step):
# the LoRA run's rows (K8_TRAIN_MS but the last) on every linear and the
# lm_head, the projector run's short rows on qkv, o and the lm_head (K9
# takes their MLPs).
K8_PROMPT_MS = (72, 442)
K8_LLM_SHAPES = [
    (1, 3584, 3584, 56), (1, 3584, 512, 56), (1, 3584, 18944, 56), (1, 18944, 3584, 28),
    (1, 3584, 4608, 28), (1, 3584, 37888, 28), (1, 3584, 152064, 1),
    (8, 3584, 4608, 28), (8, 3584, 152064, 1),
] + [(M, K, N, 28) for M in K8_PROMPT_MS
     for K, N in ((3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584))] + [
    (M, K, N, n) for M in K8_TRAIN_MS
    for K, N, n in ((3584, 4608, 28), (3584, 3584, 28), (3584, 37888, 28), (18944, 3584, 28),
                    (3584, 152064, 1)) if M > 32 or (K, N) not in ((3584, 37888), (18944, 3584))]
# (M, K, N, calls per prompt pass or decode token) of the int8 request's
# linears through K6 (the unfused int8 tree, a 24-token prompt): q and o,
# k and v, gate and up, down; the lm_head at M = 1.
K6_LLM_SHAPES = [(M, K, N, n) for M in (24, 1)
                 for K, N, n in ((3584, 3584, 56), (3584, 512, 56), (3584, 18944, 56),
                                 (18944, 3584, 28))] + [(1, 3584, 152064, 1)]
# K5 at the twin's linears (calls: the shadow calls of one checked tick),
# and at the int8 request's M = 1 linears, all of whose K and N are
# multiples of 128 (no call: the planner does not reach K5)
K5_SHAPES = QMM_SHAPES + [(1, K, N, 0) for M, K, N, _ in K6_LLM_SHAPES
                          if M == 1 and K % 128 == 0 and N % 128 == 0]
# CLIP ViT-B/16 self-attention: the frames of one encode, 197 tokens
K1_CLIP_SHAPES = [("clip_self", 4, 197, 197, 12, 64, "vit", None, 12)]
ASK_QUERY = "Which feels softer, A/B?"      # 24 byte tokens: K9 in the prompt pass
assert len(ASK_QUERY.encode()) == 24
PLAN_TOKENS = 16
PLAN_SAMPLES = 8


def mk_leaf(gen, N, K):
    """A grouped-int4 leaf (N, K) of a random linear ~ N(0, 1/K)."""
    import torch

    from vla_touch_tpu_torch.ops import quant as Q

    lin = torch.nn.Linear(K, N, bias=False, device="cuda")
    with torch.no_grad():
        lin.weight.copy_(torch.randn((N, K), generator=gen, device="cuda") * K ** -0.5)
    return Q.quantize_linear_w4(lin)


def mk_bound_ms(kernel, M):
    """(bytes ms, operations ms) of K9 or K10 at Qwen2.5-7B width: x (and
    att, norm weight) read and out written once; 0.5 byte per weight and 4
    per (group, column) of scale4; the int8 products at the int8 peak."""
    from vla_touch_tpu_torch.ops.quant import pick_group_size

    D, F = QWEN_D, QWEN_F

    def w4(N, K):
        return N * K // 2 + 4 * N * (K // pick_group_size(K))

    nbytes = 2 * M * D + w4(2 * F, D) + w4(D, F) + 2 * M * D
    ops = 2.0 * M * (D * 2 * F + F * D)
    if kernel == "K10":
        nbytes += 2 * M * D + w4(D, D) + 4 * D
        ops += 2.0 * M * D * D
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT8_OPS


def mk_operands(gen, kernel, M, leaves):
    import torch

    x = (torch.randn((M, QWEN_D), generator=gen, device="cuda") * 2).to(torch.bfloat16)
    if kernel == "K9":
        return (x, leaves["gu"], leaves["down"])
    att = (torch.randn((M, QWEN_D), generator=gen, device="cuda") * 2).to(torch.bfloat16)
    return (x, att, leaves["o"], leaves["gu"], leaves["down"], leaves["norm_w"])


def mk_leaves(gen):
    import torch

    return dict(gu=mk_leaf(gen, 2 * QWEN_F, QWEN_D), down=mk_leaf(gen, QWEN_D, QWEN_F),
                o=mk_leaf(gen, QWEN_D, QWEN_D),
                norm_w=1 + 0.1 * torch.randn((QWEN_D,), generator=gen, device="cuda"))


def mk_check(kernel, ops):
    """K9 or K10 against its plain version on ``ops``; (max abs error,
    tolerance), raising on a miss."""
    import torch

    from vla_touch_tpu_torch.ops import w4_fused as W4F

    if kernel == "K9":
        got = W4F.w4_swiglu_mlp(*ops)
        want = W4F.w4_swiglu_plain(*ops, out_dtype=torch.float32)
    else:
        got = W4F.w4_postattn_fused(*ops)
        want = W4F.w4_postattn_plain(*ops, out_dtype=torch.float32)
    return hold(f"{kernel} M{ops[0].shape[0]}", got, want, MK_TOL)


def check_mk(gen, kernel, leaves):
    """K9 (M in K9_MS) or K10 (K10_MS) at Qwen2.5-7B width against the plain
    version, timed: kernel (graph replay; the eager loop beside it), plain,
    bound.  No single PyTorch call computes either function."""
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    fn, plain = ((W4F.w4_swiglu_mlp, W4F.w4_swiglu_plain) if kernel == "K9" else
                 (W4F.w4_postattn_fused, W4F.w4_postattn_plain))
    rows = {}
    for M in (K9_MS if kernel == "K9" else K10_MS):
        ops = mk_operands(gen, kernel, M, leaves)
        err, tol = mk_check(kernel, ops)
        ms = graph_time_ms(lambda: fn(*ops))
        eager_ms = cuda_time_ms(lambda: fn(*ops))
        plain_ms = graph_time_ms(lambda: plain(*ops), calls=2, replays=2)
        b_ms, o_ms = mk_bound_ms(kernel, M)
        rows[M] = dict(M=M, max_abs_err=err, tol=tol, ms=ms, eager_ms=eager_ms,
                       plain_ms=plain_ms, bound_ms=max(b_ms, o_ms), bytes_ms=b_ms, ops_ms=o_ms,
                       library_ms=None)
        log(f"{kernel} M{M:2d} D{QWEN_D} F{QWEN_F}: err {err:.3e} (tol {tol:.3e}) kernel "
            f"{ms:.4f} ms (eager loop {eager_ms:.4f}) plain {plain_ms:.4f} ms bound "
            f"{max(b_ms, o_ms):.4f} ms")
    return rows


def write_video(path, seed, n=8, size=224, width=None, varied=False):
    """A synthetic GelSight press as PNG frames of size x width (default
    square): a textured field, then a contact blob that grows over frames
    3..6 (the salient span).  ``varied``: the texture's frequencies, the
    blob's centre and the colour drawn from ``seed`` (one object's
    recording unlike another's)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    yy, xx = np.mgrid[:size, :width or size] / np.array([size, width or size])[:, None, None]
    fx, fy, cx, cy, tint = 12.0, 9.0, 0.5, 0.45, np.array([1.0, 0.6, 0.3])
    if varied:
        fx, fy = rng.uniform(3.0, 30.0, 2)
        cx, cy = rng.uniform(0.25, 0.75, 2)
        tint = rng.uniform(0.2, 1.2, 3)
    base = 110 + 40 * np.sin(fx * xx) * np.cos(fy * yy)
    frames = []
    for i in range(n):
        amp = 90.0 * min(max(i - 2, 0), 4) / 4
        blob = amp * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 0.02)
        img = base[..., None] + blob[..., None] * tint
        img = np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)
        # zlib level 1: the same pixels, written 4 x faster than level 6
        Image.fromarray(img).save(os.path.join(path, f"{i:03d}.png"), compress_level=1)
        frames.append(img)
    return np.stack(frames)


def build_planner(seed: int = 0) -> dict:
    """The planner at full width from seeded weights, on the card: the
    Qwen2.5-7B decoder in grouped int4 (quantized layer by layer), its fused
    twin (shared embedding and lm_head) and an int8 tree from the same
    draw; CLIP ViT-B/16 with adapters and classifier; the projector; and a
    tactile video written as PNG frames to a temporary directory."""
    import tempfile

    import torch

    from vla_touch_tpu_torch.planning import encoder as PE
    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning.llm_splice import init_tactile_projector

    cfg = L.qwen25_7b()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    w4 = L.init_llm(cfg, seed, dtype=torch.bfloat16, weights="int4")
    fused = L.fuse_quantized_layers(w4)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    i8 = L.init_llm(cfg, seed, dtype=torch.bfloat16, weights="int8")
    # norm weights of a trained model are not all 1: draw them, so that a
    # kernel that ignores its norm weight shows on the main path
    for tree in (w4, i8):
        g = torch.Generator(device="cuda").manual_seed(seed + 3)
        with torch.no_grad():
            for w in [p for lp in tree.layers for p in (lp.input_norm, lp.post_norm)] + [
                    tree.final_norm]:
                w.copy_(1 + 0.1 * torch.randn(w.shape, generator=g, device="cuda"))
    enc = PE.init_tactile_encoder(seed=seed + 1)
    proj = init_tactile_projector(enc.feature_dim, cfg.hidden_size, seed=seed + 2)
    tmp = tempfile.mkdtemp(prefix="planner_")
    video = os.path.join(tmp, "cup_0", "tactile")
    frames = write_video(video, seed)
    torch.cuda.synchronize()
    log(f"planner built: Qwen2.5-7B w4 + fused twin {t1 - t0:.1f} s, int8 tree, CLIP "
        f"ViT-B/16, projector {time.perf_counter() - t1:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    return dict(cfg=cfg, w4=w4, fused=fused, i8=i8, enc=enc, proj=proj, tmp=tmp,
                video=video, frames=frames)


@contextlib.contextmanager
def recording_generate():
    """Record every decode (B, Lp, N, T, prompt embeds and positions,
    tokens) and the logits of each step, by wrapping ``planning/llm.py``'s
    ``_generate_impl`` and ``lm_logits``."""
    import torch

    from vla_touch_tpu_torch.planning import llm as L

    calls = []
    gen_impl, logits_fn = L._generate_impl, L.lm_logits

    def lm_logits(cfg, params, hidden):
        out = logits_fn(cfg, params, hidden)
        if calls and isinstance(calls[-1]["logits"], list):
            calls[-1]["logits"].append(out.float())
        return out

    def generate_impl(cfg, params, prompt_embeds, max_new_tokens, *args, **kw):
        B, Lp, _ = prompt_embeds.shape
        rec = dict(B=B, Lp=Lp, N=kw.get("num_return_sequences", 1), T=max_new_tokens,
                   embeds=prompt_embeds, params=params, logits=[],
                   positions=kw.get("prompt_positions"))
        calls.append(rec)
        out = gen_impl(cfg, params, prompt_embeds, max_new_tokens, *args, **kw)
        rec["tokens"] = out[0]
        # (B, T, V) for a greedy decode; a sampled one's first logits are
        # the prompt's (B rows), the steps' B * N
        rec["logits"] = torch.stack(rec["logits"], dim=1) if rec["N"] == 1 else None
        return out

    L._generate_impl, L.lm_logits = generate_impl, lm_logits
    try:
        yield calls
    finally:
        L._generate_impl, L.lm_logits = gen_impl, logits_fn


def planner_launches(calls, layers: int, encodes: int, clip_layers: int = 12,
                     vision_blocks: int = 0) -> list:
    """(kernel, M, launches) that the planner requests must make on the
    fused w4 tree with MEGAKERNELS on, from the code.  Per decode of T
    tokens over B prompts of Lp tokens, N samples each: the prompt pass (M
    = B Lp) runs qkv and o through K8 and the MLP through K9 (M <= 32) or
    K8's gateup and down, and above 512 rows none of them (the plain
    ``qdense_w4``, as JAX's dispatcher sends it to XLA); then the lm_head
    (K8, M = B); each of the T - 1 steps (M = B N) runs qkv through K8 and
    K10 per layer, plus the lm_head.  K1: one per CLIP layer per tactile
    encode, and one per Qwen2-VL vision block per tower run
    (``vision_blocks`` in all)."""
    out = [("K1", None, clip_layers * encodes + vision_blocks)]
    for c in calls:
        Mp, Ms, steps = c["B"] * c["Lp"], c["B"] * c["N"], c["T"] - 1
        if Mp <= 512:
            out += [("K8", Mp, 2 * layers),
                    ("K9", Mp, layers) if Mp <= 32 else ("K8", Mp, 2 * layers)]
        out += [("K8", c["B"], 1),
                ("K8", Ms, steps * (layers + 1)), ("K10", Ms, steps * layers)]
    return out


def planner_need(launches) -> dict:
    """Launches per kernel of a :func:`planner_launches` list."""
    need = {}
    for kernel, _, n in launches:
        need[kernel] = need.get(kernel, 0) + n
    return need


def planner_requests(P, T=PLAN_TOKENS):
    """The user's requests through the entry points, on the fused w4 tree:
    ``describe`` and ``guess`` (TactileDescriptionService over
    ``make_llm_interface``), one ``ask`` of 24 tokens, and ``reason_llm`` on
    one scenario (a greedy description turn, then a best-of-8 final turn at
    temperature 0.7).  Returns (results, per-request outputs)."""
    from vla_touch_tpu_torch.planning import run_llm as RL
    from vla_touch_tpu_torch.planning.serving import TactileDescriptionService

    iface = RL.make_llm_interface(P["cfg"], P["fused"], max_new_tokens=T)
    svc = TactileDescriptionService(P["enc"],
                                    llm_fn=lambda s: iface.generate_fn(iface.embed_text(s)))
    row = {"info": {"scenario": "pick", "target": "sponge", "tactile": [P["video"]],
                    "num_candidates": 3},
           "chat": [{"role": "user", "content": "Object 1: <tact_tokens>. Describe it."},
                    {"role": "assistant", "content": "It feels soft and smooth."},
                    {"role": "user", "content": "Which is it? A) sponge B) mug C) towel"},
                    {"role": "assistant", "content": "A) sponge"}]}
    out = dict(describe=svc.describe(P["frames"]),
               guess=svc.guess(P["frames"], ["sponge", "mug", "towel"]),
               ask=svc.ask(ASK_QUERY),
               reason=RL.reason_llm(P["enc"], iface, P["proj"], [row], P["tmp"],
                                    reasoning_sampling_num=PLAN_SAMPLES,
                                    reasoning_temperature=0.7,
                                    reasoning_selection_type="best_of_n"))
    return out, iface


def teacher_forced(P, call):
    """Per-step logits corr of a recorded greedy decode against the plain
    versions fed the kernel run's tokens (one forward over prompt + tokens,
    at the recorded prompt positions and the decode's after them),
    and how many greedy tokens the plain logits would pick alike."""
    import torch

    from vla_touch_tpu_torch.planning import llm as L

    cfg, params = P["cfg"], call["params"]
    toks = call["tokens"][0]
    pos, pp = None, call["positions"]
    if pp is not None:
        # the decode resumes at max(prompt position) + 1, every component alike
        tail = int(pp.max()) + 1 + torch.arange(len(toks) - 1, device=pp.device)
        pos = torch.cat([pp, tail.expand(*pp.shape[:-1], -1)], dim=-1)
    with plain_kernels(), torch.no_grad():
        seq = torch.cat([call["embeds"][0], L.embed_tokens(params, toks[:-1])], dim=0)
        hidden = L.llm_forward(cfg, params, seq[None], positions=pos)[0, call["Lp"] - 1:]
        plain = L.lm_logits(cfg, params, hidden).float()
    kern = call["logits"][0]
    corrs = [corr(kern[t].cpu().numpy(), plain[t].cpu().numpy()) for t in range(len(toks))]
    agree = float((plain.argmax(-1) == toks).float().mean())
    return min(corrs), agree, corrs[0], float(np.median(corrs))


def planner_phase(gen) -> dict:
    """Everything of the planner slice; returns what the kernels line and
    the log need."""
    import torch

    from vla_touch_tpu_torch.planning import encoder as PE
    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning import run_llm as RL
    from vla_touch_tpu_torch.planning.datasets import clip_preprocess

    t_phase = time.perf_counter()
    default_megakernels = L.MEGAKERNELS
    res = {}
    # ---- per-shape checks at the planner's widths
    leaves = mk_leaves(gen)
    res["k9_rows"] = check_mk(gen, "K9", leaves)
    res["k10_rows"] = check_mk(gen, "K10", leaves)
    del leaves
    res["k8_llm_rows"], _ = check_qmm(gen, "K8", K8_LLM_SHAPES)
    res["k8_prompt"] = [k8_prompt_pass(res["k8_llm_rows"], M) for M in K8_PROMPT_MS]
    for tot in res["k8_prompt"]:
        log(f"K8 per prompt pass of {tot['M']} tokens ({tot['calls']} calls): kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({tot['bound_by']}); torch._int_mm at the same (M, K, N), int8 weights (a "
            f"yardstick of the int8 rate, not K8's function) {tot['int_mm_ms']:.4f} ms")
    res["k6_llm_rows"], _ = check_qmm(gen, "K6", K6_LLM_SHAPES)
    res["k1_clip_rows"], _ = check_k1(gen, K1_CLIP_SHAPES)

    # ---- the requests at full width, counted
    P = build_planner(seed=0)
    cfg = P["cfg"]
    L.MEGAKERNELS = True
    planner_requests(P, T=4)                                 # warm-up
    zero_counts()
    t0 = time.perf_counter()
    with recording_generate() as calls:
        out, iface = planner_requests(P)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    clip_layers = P["enc"].cfg.num_layers
    res["launches"] = planner_launches(calls, cfg.num_layers, encodes=3, clip_layers=clip_layers)
    check_counts("planner requests (fused w4, MEGAKERNELS)", counts,
                 planner_need(res["launches"]))
    res["counts"] = counts
    res["calls"] = [dict(B=c["B"], Lp=c["Lp"], N=c["N"], T=c["T"]) for c in calls]
    log(f"planner requests: {len(calls)} decodes {res['calls']} in {wall:.2f} s; describe "
        f"{json.dumps(out['describe'])[:160]}; guess option {out['guess']['option']}; "
        f"reason final {json.dumps(next(iter(out['reason'].values()))[0]['final_generation'])[:80]}")
    for c in calls:
        finite = c["logits"] is None or bool(torch.isfinite(c["logits"]).all())
        if not finite or c["tokens"].shape != (c["B"] * c["N"], c["T"]):
            raise AssertionError(f"planner decode: tokens {tuple(c['tokens'].shape)}, "
                                 f"finite logits {finite}")

    # ---- the int8 tree: one short request through K6, then checked
    nl = cfg.num_layers
    i8 = RL.make_llm_interface(cfg, P["i8"], max_new_tokens=16)
    i8.generate_fn(i8.embed_text(ASK_QUERY))
    zero_counts()
    i8.generate_fn(i8.embed_text(ASK_QUERY))
    check_counts("int8 request (16 tokens)", read_counts(), {"K6": 16 * (7 * nl + 1)})
    i8 = RL.make_llm_interface(cfg, P["i8"], max_new_tokens=2)
    chk8 = checked_run(lambda: i8.generate_fn(i8.embed_text(ASK_QUERY)))
    check_chk("int8 checked request (2 tokens)", chk8, {"K6": 2 * (7 * nl + 1)})

    # ---- kernel vs plain on the same requests
    pre = clip_preprocess(P["frames"][2:6], 224)[None]
    feats_k = PE.encode_tactile_video(P["enc"], pre)
    props_k = PE.classify_properties(P["enc"], feats_k)
    with plain_kernels():
        feats_p = PE.encode_tactile_video(P["enc"], pre)
        props_p = PE.classify_properties(P["enc"], feats_p)
    c_feat = corr(feats_k.cpu().numpy(), feats_p.cpu().numpy())
    d_props = float((props_k - props_p).abs().max())
    log(f"planner kernel vs plain: tactile feature corr {c_feat:.6f} (min {FEATURE_CORR_MIN}); "
        f"classifier {props_k.tolist()} vs {props_p.tolist()} (max diff {d_props:.3e}, "
        f"limit {2e-2 * float(props_p.abs().max()) + 1e-3:.3e})")
    if not (c_feat > FEATURE_CORR_MIN and d_props <= 2e-2 * float(props_p.abs().max()) + 1e-3):
        raise AssertionError("tactile encoder: kernel run disagrees with the plain run")
    # greedy decodes whose prompt + tokens stay within the kernels' M <= 512
    tf = [(c["Lp"],) + teacher_forced(P, c) for c in calls
          if c["N"] == 1 and c["Lp"] + c["T"] - 1 <= 512]
    log("teacher-forced logits, per greedy decode (prompt tokens, min per-step corr, "
        f"token agreement, first-step corr, median corr): {tf} (corr min {LOGITS_CORR_MIN}; "
        "agreement not gated)")
    if not all(t[1] > LOGITS_CORR_MIN for t in tf):
        raise AssertionError("planner: kernel logits disagree with the plain versions'")
    # every request again, 2 tokens each (a prompt pass and a decode step),
    # with every kernel call held to its plain version on its own operands:
    # each prompt pass's M, both decode M
    with recording_generate() as calls4:
        chk = checked_run(lambda: planner_requests(P, T=2))
    check_chk("planner checked requests (2 tokens each)", chk,
              planner_need(planner_launches(calls4, nl, encodes=3, clip_layers=clip_layers)))
    res.update(feature_corr=c_feat, teacher_forced=tf,
               checked={k: v for k, v in chk.items() if v["calls"]},
               checked_int8={k: v for k, v in chk8.items() if v["calls"]})

    # ---- timing: three tiers, best-of-8, one profiled decode
    def timed(fn, reps=2):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t1))
        return float(np.median(ts))

    eos = iface.tokenizer.EOS
    ask = iface.embed_text(ASK_QUERY)[None]
    long_prompt = iface.embed_text("x" * 430)[None]
    tiers = {}
    for name, tree, mega in (("unfused", P["w4"], False), ("fused", P["fused"], False),
                             ("fused+megakernels", P["fused"], True)):
        L.MEGAKERNELS = mega
        L.greedy_generate(cfg, tree, ask, max_new_tokens=PLAN_TOKENS, eos_id=eos)
        ttft = timed(lambda: L.greedy_generate(cfg, tree, ask, max_new_tokens=1, eos_id=eos))
        ttft_long = timed(lambda: L.greedy_generate(cfg, tree, long_prompt, max_new_tokens=1,
                                                    eos_id=eos))
        full = timed(lambda: L.greedy_generate(cfg, tree, ask, max_new_tokens=PLAN_TOKENS,
                                               eos_id=eos))
        tiers[name] = dict(ttft_ms_24_tokens=ttft, ttft_ms_430_tokens=ttft_long,
                           decode_ms_per_token=(full - ttft) / (PLAN_TOKENS - 1),
                           decode_tok_s=1e3 * (PLAN_TOKENS - 1) / (full - ttft),
                           request_ms=full)
        log(f"tier {name}: " + json.dumps(tiers[name]))
    fastest = min(tiers, key=lambda k: tiers[k]["decode_ms_per_token"])
    L.MEGAKERNELS = True
    best8 = timed(lambda: L.sample_generate(cfg, P["fused"], ask, seed=1,
                                            max_new_tokens=PLAN_TOKENS, eos_id=eos,
                                            temperature=0.7, num_return_sequences=PLAN_SAMPLES),
                  reps=2)
    prof = profile_run(lambda: L.greedy_generate(cfg, P["fused"], ask, max_new_tokens=16,
                                                 eos_id=eos))
    log(f"decode tiers (batch 1, 24-token prompt, {PLAN_TOKENS} tokens): fastest {fastest}; "
        f"best-of-{PLAN_SAMPLES} sampled: {best8:.2f} ms, aggregate "
        f"{1e3 * PLAN_SAMPLES * PLAN_TOKENS / best8:.1f} tok/s")
    log("planner decode profile (fused w4, MEGAKERNELS, 16 tokens): " + json.dumps(prof))
    res.update(tiers=tiers, fastest=fastest, best_of_8_ms=best8, profile=prof)
    L.MEGAKERNELS = default_megakernels
    log(f"planner phases: {time.perf_counter() - t_phase:.1f} s")
    # the planner's trees and encoder go on to llm_train_phase
    res["P"] = P
    return res


def planner_kernel_totals(res, kernel) -> dict:
    """K9's or K10's per-shape figures summed over the calls of the planner
    requests (each call at its own M), as the kernels line reports them."""
    rows = res["k9_rows"] if kernel == "K9" else res["k10_rows"]
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0, library_ms=None,
               err=max(r["max_abs_err"] for r in rows.values()))
    for k, M, n in res["launches"]:
        if k != kernel or n == 0:
            continue
        if M not in rows:
            raise AssertionError(f"{kernel}: no per-shape row at M = {M}")
        for key in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"):
            tot[key] += n * rows[M][key]
    return tot


# ---- the planner's LLM training: the projector and LoRA through the w4 base -------

# The LoRA run (train_projection_and_lora at its defaults: rank 8 on the
# seven targets, lr 1e-3): the first LLM_ROWS rows of the seeded PhysiCLeAR
# tree's QA (PR 16's tactile_data, flattened by qa.chat_rows_to_llm_rows)
# for LLM_EPOCHS epochs, one row a step.  The projector run
# (train_projection at its default lr 1e-4) on LLM_SHORT's rows, as short
# as examples/planning_pipeline.py's, so that each fits K9's 32 rows.
LLM_ROWS = 4
LLM_EPOCHS = 3
LLM_LR = 1e-3
LLM_RANK = 8
LLM_PROJ_LR = 1e-4
LLM_PROJ_EPOCHS = 2
LLM_SHORT = (("the surface is <tact>", "soft"), ("the surface is <tact>", "hard"))
LLM_TEST_TOKENS = 8
# The LoRA run's loss fall, mean of the first epoch's losses minus the
# last's (the same rows), in nats; written before the first run on the
# card from the controls of tools/torch_qlora_loss_fall.py (the 2-layer
# cut on the CPU, bf16, the vocabulary cut to LLM_CUT_VOCAB): sound 0.145
# (the fall is over by the second epoch: random weights, the final norm
# caps the logits), lr 0 exactly 0.
LLM_FALL_MIN = 0.05
# The depth-2 step on the card (bf16, the kernels) against the CPU's in
# float32 and in bf16 (the plain program), vocabulary cut to LLM_CUT_VOCAB,
# on the first short row (22 tokens).  Its loss is stable: bf16 against
# float32 on the CPU reads 7.6e-4..7.3e-3 over five draws of the weights
# (tools/torch_qlora_bf16_step.py), so the loss is gated at LLM_LOSS_RTOL.
# Its gradient is not: every quantized product passes its input's gradient
# through each row's amax alone, the lm_head's too, so the whole backward
# enters the network through one element a row and moves with which element
# is largest.  The same tool reads the gradient's corr 0.42..0.999 between
# bf16 and float32, and 0.64..0.999 between two bf16 steps whose projectors
# differ by 2e-3 of their weights; so the card's gradient is printed, and
# only held to be finite and nonzero.  The kernels' backwards are held
# exactly on equal operands instead (tests/test_torch_cuda.py).
LLM_CUT_VOCAB = 4096
LLM_LOSS_RTOL = 2e-2


def llm_rows(samples_root: str, out_dir: str) -> dict:
    """The phase's datasets: the seeded tree's QA files (``tactile_data``
    under ``samples_root``) read through ``TactileLLMDataset``, flattened
    by ``chat_rows_to_llm_rows``, the first LLM_ROWS written as one QA file
    and read back; LLM_SHORT over the first two of those rows' recordings
    likewise.  Returns both datasets."""
    from vla_touch_tpu_torch.planning import datasets as D
    from vla_touch_tpu_torch.planning import qa as QA

    qa_dir = os.path.join(samples_root, "qa")
    chat = D.TactileLLMDataset([os.path.join(qa_dir, f) for f in
                                ("description_ranking.json", "scenario.json")], "train")
    rows = QA.chat_rows_to_llm_rows([chat[i] for i in range(len(chat))])[:LLM_ROWS]
    short = [{"question": q, "answer": a, "tactile": [rows[i]["tactile"][0]]}
             for i, (q, a) in enumerate(LLM_SHORT)]
    long_path = QA.write_qa_file(rows, os.path.join(out_dir, "llm_rows.json"))
    short_path = QA.write_qa_file(short, os.path.join(out_dir, "llm_short_rows.json"))
    return dict(long=D.TactileLLMDataset([long_path]), short=D.TactileLLMDataset([short_path]))


def llm_row_tokens(row, tok) -> tuple:
    """(prompt rows, rows of the loss's forward) of a QA row: the question's
    bytes with each ``<tact>`` three rows (start, feature, end), then the
    answer + EOS less the last token."""
    from vla_touch_tpu_torch.planning.llm_splice import TACTILE_PLACEHOLDER

    q = row["question"]
    n = q.count(TACTILE_PLACEHOLDER)
    Lp = len(tok.encode(q.replace(TACTILE_PLACEHOLDER, ""))) + 3 * n
    return Lp, Lp + len(tok.encode(row["answer"]))


def llm_step_need(M: int, layers: int, lora_mlp: bool, videos: int, clip_layers: int) -> dict:
    """Launches of one training step whose forward runs M rows, from the
    code: K1 one a CLIP layer a video (the frozen encoder); at M <= 512 K8
    on qkv and o and the lm_head, and on gate|up and down unless the MLP
    takes K9 (M <= 32, no LoRA on it: W4SwigluFn); above 512 rows none (the
    plain qdense_w4, the lm_head too)."""
    need = {"K1": clip_layers * videos}
    if M <= 512:
        mlp_k9 = M <= 32 and not lora_mlp
        need["K8"] = (2 if mlp_k9 else 4) * layers + 1
        need["K9"] = layers if mlp_k9 else 0
    return need


def lora_decode_need(Lp: int, T: int, layers: int) -> dict:
    """Launches of a greedy decode of T tokens with LoRA on every target (no
    K9 or K10: the adapters block both), from the code: the prompt pass's
    qkv, o, gate|up and down through K8 at Lp <= 512, then the lm_head;
    each of the T - 1 steps the four per layer and the lm_head."""
    per = 4 * layers + 1
    return {"K8": (T - 1) * per + (per if Lp <= 512 else 1)}


def add_need(total: dict, need: dict) -> dict:
    for k, v in need.items():
        total[k] = total.get(k, 0) + v
    return total


@contextlib.contextmanager
def recording_steps():
    """Each logged step of the run_llm trainers: the host time at its log
    line (which reads the loss, so it follows the step's work on the
    device) and the kernels' launches since the step before (the counts
    are zeroed after each)."""
    from vla_touch_tpu_torch.planning import run_llm as RL

    steps = []
    log_step = RL._log_step

    def logged(*a):
        log_step(*a)
        steps.append((time.perf_counter(), read_counts()))
        zero_counts()

    RL._log_step = logged
    try:
        yield steps
    finally:
        RL._log_step = log_step


@contextlib.contextmanager
def timed_backwards():
    """Device ms of W4A8MatmulFn's and W4SwigluFn's backwards (the plain
    vjp), CUDA events around each call, summed per Function."""
    import torch

    from vla_touch_tpu_torch.ops import quant_matmul as QM
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    events = {"K8": [], "K9": []}
    orig = {"K8": QM.W4A8MatmulFn.backward, "K9": W4F.W4SwigluFn.backward}

    def wrap(kernel):
        fn = orig[kernel]

        def backward(ctx, *g):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            out = fn(ctx, *g)
            end.record()
            events[kernel].append((start, end))
            return out
        return staticmethod(backward)

    QM.W4A8MatmulFn.backward, W4F.W4SwigluFn.backward = wrap("K8"), wrap("K9")
    ms = {}
    try:
        yield ms
    finally:
        QM.W4A8MatmulFn.backward = staticmethod(orig["K8"])
        W4F.W4SwigluFn.backward = staticmethod(orig["K9"])
        torch.cuda.synchronize()
        for k, ev in events.items():
            ms[k] = dict(calls=len(ev), ms=sum(a.elapsed_time(b) for a, b in ev))


def qlora_step_grads(cfg, tree, projector, lora, feats, row) -> tuple:
    """(loss, the trainables' gradient as one float64 vector) of one
    ``train_projection_and_lora`` step's loss on ``row`` with its tactile
    features ``feats`` given (the frozen encoder left out), on ``tree``'s
    device and in its embeddings' dtype."""
    import torch

    from vla_touch_tpu_torch.planning import run_llm as RL
    from vla_touch_tpu_torch.planning.llm_splice import process_user_input

    iface = RL.make_llm_interface(cfg, tree)
    leaves = list(projector.parameters()) + [ab[k] for lp in lora["layers"]
                                             for ab in lp.values() for k in ("A", "B")]
    for t in leaves:
        t.grad = None
        t.requires_grad_(True)
    embeds = process_user_input(row["question"], feats, iface.embed_text, lambda f: f,
                                RL._projected(projector, iface.start_embed),
                                iface.start_embed, iface.end_embed)
    loss = iface.loss_fn(embeds, row["answer"],
                         lora_override=RL.lora_in(lora, iface.start_embed.dtype))
    loss.backward()
    grads = torch.cat([t.grad.double().flatten().cpu() for t in leaves])
    for t in leaves:
        t.requires_grad_(False)
    return float(loss.detach()), grads


def qlora_depth2(seed: int = 0, device="cuda", vocab: int = LLM_CUT_VOCAB):
    """(cfg, the fused grouped-int4 tree in bf16 on ``device``, projector,
    LoRA factors with B drawn) of the depth-2 cut of Qwen2.5-7B (full
    widths, the vocabulary cut to ``vocab``): what the card-vs-CPU step
    and tools/torch_qlora_bf16_step.py differentiate."""
    import dataclasses

    import torch

    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning.llm_splice import init_tactile_projector

    cfg = dataclasses.replace(L.qwen25_7b(), num_layers=2, vocab_size=vocab)
    tree = L.fuse_quantized_layers(L.init_llm(cfg, seed, device=device, dtype=torch.bfloat16,
                                              weights="int4"))
    proj = init_tactile_projector(768, cfg.hidden_size, seed=seed + 2, device=device)
    lora = L.init_lora(cfg, rank=LLM_RANK, seed=seed + 3, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    for lp in lora["layers"]:
        for ab in lp.values():
            ab["B"].normal_(0.0, 0.01, generator=gen)
    return cfg, tree, proj, lora


def qlora_to(tree, proj, lora, device, dtype):
    """Copies of the depth-2 trainables and tree on ``device``, the tree's
    embeddings in ``dtype`` (its quantized leaves and norms as they are)."""
    import copy

    tree = copy.deepcopy(tree).to(device)
    tree.embed.data = tree.embed.data.to(dtype)
    lora = {"layers": [{t: {k: ab[k].detach().to(device).clone() for k in ab}
                        for t, ab in lp.items()} for lp in lora["layers"]],
            "scale": lora["scale"]}
    return tree, copy.deepcopy(proj).to(device), lora


def llm_step_vs_cpu(feats, row, M: int) -> dict:
    """One ``train_projection_and_lora`` step's loss and gradient on the
    depth-2 cut (:func:`qlora_depth2`) on the card in bf16 (K8 under
    W4A8MatmulFn) against the CPU's in float32 and in bf16 (the plain
    program), the same quantized leaves, trainables and features."""
    import torch

    from vla_touch_tpu_torch.ops import quant_matmul as QM

    cfg, tree, proj, lora = qlora_depth2()
    before = QM.w4a8_matmul.launches
    l_card, a = qlora_step_grads(cfg, tree, proj, lora, feats, row)
    k8 = QM.w4a8_matmul.launches - before
    res = {"loss_card": l_card, "k8_launches": k8}
    for name, dt in (("cpu", torch.float32), ("cpu_bf16", torch.bfloat16)):
        l_cpu, b = qlora_step_grads(cfg, *qlora_to(tree, proj, lora, "cpu", dt),
                                    [f.cpu() for f in feats], row)
        res[name] = dict(loss=l_cpu, loss_rel_err=abs(l_card - l_cpu) / abs(l_cpu),
                         grad_l2_rel=float((a - b).norm() / b.norm()),
                         grad_corr=float(torch.corrcoef(torch.stack([a, b]))[0, 1]))
    res["grad_finite_nonzero"] = bool(torch.isfinite(a).all()) and bool(a.any())
    log("LLM depth-2 step, card (bf16) vs CPU (float32, bf16): " + json.dumps(res) +
        f" (the losses within {LLM_LOSS_RTOL}; the gradients printed, not gated)")
    if not (res["cpu"]["loss_rel_err"] <= LLM_LOSS_RTOL
            and res["cpu_bf16"]["loss_rel_err"] <= LLM_LOSS_RTOL
            and res["grad_finite_nonzero"]
            and k8 == llm_step_need(M, cfg.num_layers, True, 0, 0)["K8"]):
        raise AssertionError(f"LLM training: the card's step disagrees with the CPU's: {res}")
    return res


@contextlib.contextmanager
def lora_step(enc, cfg, tree, projector, lora, row):
    """The LoRA trainer's step on ``row`` as a function (``RL.joint_loss``,
    backward, the AdamW update, the loss read), without the trainer's file
    writes: for the checked, timed and profiled steps."""
    from vla_touch_tpu_torch.planning import run_llm as RL
    from vla_touch_tpu_torch.train import optim

    iface = RL.make_llm_interface(cfg, tree)
    leaves = list(projector.parameters()) + [ab[k] for lp in lora["layers"]
                                             for ab in lp.values() for k in ("A", "B")]
    for t in leaves:
        t.requires_grad_(True)
    opt = optim.AdamW(leaves, weight_decay=RL.ADAMW_DECAY)

    def step():
        loss = RL.joint_loss(iface, projector, lora, enc, row)
        loss.backward()
        opt.step(LLM_LR)
        opt.zero_grad()
        return float(loss.detach())

    try:
        yield step
    finally:
        for t in leaves:
            t.requires_grad_(False)


def epoch_fall(losses, epochs: int) -> float:
    """Mean loss of the first epoch minus the last's (the same rows), nats."""
    per = len(losses) // epochs
    return float(np.mean(losses[:per]) - np.mean(losses[-per:]))


def read_losses(path: str) -> list:
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


def llm_train_phase(P, gen) -> dict:
    """The planner's LLM training at Qwen2.5-7B's full width on the
    planner's fused grouped-int4 tree and CLIP encoder (``build_planner``):
    ``train_projection_and_lora`` and ``train_projection`` through the
    frozen base with K8 and K9 under their autograd Functions, launches
    asserted from the code step by step, a checked step each, the loss
    fall, the frozen base bit for bit, the files read back; ``test_llm``
    after each; the depth-2 step against the CPU's; times, the backwards'
    ms and a profile."""
    import copy
    import shutil

    import torch

    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning import run_llm as RL
    from vla_touch_tpu_torch.utils import checkpoint as ckpt
    from vla_touch_tpu_torch.utils import from_flax as FF

    t_phase = time.perf_counter()
    card = gpu_line()
    cfg, tree, enc = P["cfg"], P["fused"], P["enc"]
    nl, clip_layers = cfg.num_layers, enc.cfg.num_layers
    tok = L.ByteTokenizer()
    L.MEGAKERNELS = True
    torch.cuda.reset_peak_memory_stats()
    res, parts = {}, {}
    root = os.path.join(ROOT, "build", "llm_train")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t1 = time.perf_counter()
        data = tactile_data(os.path.join(root, "tree"))
        sets = llm_rows(os.path.join(root, "tree"), root)
        long, short = sets["long"], sets["short"]
        lens = [llm_row_tokens(long[i], tok) for i in range(len(long))]
        slens = [llm_row_tokens(short[i], tok) for i in range(len(short))]
        Ms = [m for _, m in lens] + [m for _, m in slens]
        if not set(Ms) <= set(K8_TRAIN_MS):
            raise AssertionError(f"LLM training rows of {Ms} tokens: K8_TRAIN_MS {K8_TRAIN_MS}")
        res["rows"] = dict(lora=[dict(prompt=p, tokens=m, videos=len(long[i]["tactile"]))
                                 for i, (p, m) in enumerate(lens)],
                           projector=[dict(prompt=p, tokens=m) for p, m in slens],
                           at_most_512=sum(m <= 512 for m in Ms),
                           above_512=sum(m > 512 for m in Ms), data=data)
        log(f"LLM training rows [{card}]: " + json.dumps(res["rows"]))
        parts["data"] = time.perf_counter() - t1

        # ---- train_projection_and_lora, counted step by step
        frozen = {n: t.clone() for n, t in tree.state_dict().items()}
        proj0 = copy.deepcopy(P["proj"])
        lora0 = L.init_lora(cfg, rank=LLM_RANK, seed=5, device=tree.embed.device)
        need_step = [llm_step_need(m, nl, True, len(long[i]["tactile"]), clip_layers)
                     for i, (_, m) in enumerate(lens)]
        out_lora = os.path.join(root, "lora_run")
        with recording_steps() as logged:
            zero_counts()
            t0 = time.perf_counter()
            proj, lora = RL.train_projection_and_lora(
                enc, cfg, tree, long, out_lora, epochs=LLM_EPOCHS, lr=LLM_LR,
                lora_rank=LLM_RANK, projector=proj0, lora=lora0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = LLM_EPOCHS * len(long)
        if len(logged) != steps:
            raise AssertionError(f"LoRA run: {len(logged)} steps logged of {steps}")
        stamps = [t0] + [t for t, _ in logged]
        total = {}
        for s, (_, got) in enumerate(logged):
            need = need_step[s % len(long)]
            check_counts(f"LoRA run step {s} ({lens[s % len(long)][1]} rows) [{card}]", got,
                         need)
            add_need(total, got)
        losses = read_losses(os.path.join(out_lora, "llm_training.jsonl"))
        fall = epoch_fall(losses, LLM_EPOCHS)
        log(f"LoRA run losses: {[round(x, 4) for x in losses]}; fall {fall:.4f} nats "
            f"(min {LLM_FALL_MIN})")
        if not (np.all(np.isfinite(losses)) and fall >= LLM_FALL_MIN):
            raise AssertionError(f"LoRA run: the loss does not fall ({fall})")
        bad = [n for n, t in tree.state_dict().items() if not torch.equal(t, frozen[n])]
        if bad:
            raise AssertionError(f"LoRA run: the frozen base changed: {bad[:4]}")
        del frozen
        if not all(bool(ab["B"].any()) for lp in lora["layers"] for ab in lp.values()):
            raise AssertionError("LoRA run: a B factor is still 0")
        dev = tree.embed.device
        got_p = FF.tactile_projector(ckpt.load_pytree(os.path.join(out_lora,
                                                                   "projection.msgpack")), dev)
        check_round_trip("projection.msgpack", got_p.state_dict(), proj.state_dict())
        got_l = FF.llm_lora(ckpt.load_pytree(os.path.join(out_lora, "lora.msgpack")), dev)
        check_round_trip("lora.msgpack", {f"{i}.{t}.{k}": ab[k] for i, lp in
                                          enumerate(got_l["layers"]) for t, ab in lp.items()
                                          for k in ab},
                         {f"{i}.{t}.{k}": ab[k] for i, lp in enumerate(lora["layers"])
                          for t, ab in lp.items() for k in ab})
        if got_l["scale"] != lora["scale"]:
            raise AssertionError("lora.msgpack: scale differs")
        step_ms = list(1e3 * np.diff(stamps))
        res["lora"] = dict(steps=steps, losses=losses, fall=fall, wall_s=wall,
                           step_ms=step_ms, step_ms_p50=float(np.median(step_ms)),
                           rows_per_s=1e3 / float(np.median(step_ms)), launches=total,
                           file_bytes={f: os.path.getsize(os.path.join(out_lora, f))
                                       for f in ("projection.msgpack", "lora.msgpack")})
        log(f"LoRA run [{card}]: " + json.dumps({k: v for k, v in res["lora"].items()
                                                 if k != "losses"}))

        parts["lora_run"] = time.perf_counter() - t0
        # ---- one step as a checked run, one with its backwards timed, one profiled
        t1 = time.perf_counter()
        need1 = llm_step_need(lens[1][1], nl, True, len(long[1]["tactile"]), clip_layers)
        with lora_step(enc, cfg, tree, proj, lora, long[1]) as one_lora_step:
            chk = checked_run(one_lora_step)
            check_chk(f"LoRA run checked step [{card}]", chk, need1)
            with timed_backwards() as bw:
                one_lora_step()
            if bw["K8"]["calls"] != need1["K8"]:
                raise AssertionError(f"LoRA step: {bw['K8']['calls']} K8 backwards, need "
                                     f"{need1['K8']}")
            prof = profile_run(one_lora_step)
        res["lora"].update(checked={k: v for k, v in chk.items() if v["calls"]},
                           backward_ms=bw, profile=prof,
                           k8_share_of_busy=prof["groups_ms"]["K8 w4a8_*"]
                           / prof["device_busy_ms"])
        log(f"LoRA step [{card}]: backwards {json.dumps(bw)}; profile busy "
            f"{prof['device_busy_ms']:.2f} ms, idle {prof['idle_share']:.3f}, K8 "
            f"{prof['groups_ms']['K8 w4a8_*']:.3f} ms")

        parts["lora_step_checks"] = time.perf_counter() - t1
        # ---- test_llm with the trained adapter, in bf16
        t1 = time.perf_counter()
        T = LLM_TEST_TOKENS
        lora16 = RL.lora_in(lora, torch.bfloat16)
        iface = RL.make_llm_interface(cfg, tree, lora=lora16, max_new_tokens=T)
        zero_counts()
        preds = RL.test_llm(enc, iface, proj, long, os.path.join(root, "test_lora"))
        need = {"K1": clip_layers * sum(len(long[i]["tactile"]) for i in range(len(long)))}
        for p, _ in lens:
            add_need(need, lora_decode_need(p, T, nl))
        check_counts(f"test_llm after the LoRA run [{card}]", read_counts(), need)
        check_predictions(os.path.join(root, "test_lora"), preds, long)
        res["lora"]["test_llm"] = dict(launches=need, predictions=[p["prediction"][:60]
                                                                   for p in preds])

        parts["test_llm_lora"] = time.perf_counter() - t1
        # ---- train_projection on the short rows: K9 in every layer
        t1 = time.perf_counter()
        proj_s = copy.deepcopy(P["proj"])
        base_if = RL.make_llm_interface(cfg, tree)
        need_s = [llm_step_need(m, nl, False, 1, clip_layers) for _, m in slens]
        zero_counts()
        t0 = time.perf_counter()
        proj_s = RL.train_projection(enc, base_if, short, os.path.join(root, "proj_run"),
                                     epochs=LLM_PROJ_EPOCHS, lr=LLM_PROJ_LR, projector=proj_s)
        torch.cuda.synchronize()
        proj_wall = time.perf_counter() - t0
        got = read_counts()
        need = {}
        for _ in range(LLM_PROJ_EPOCHS):
            for n in need_s:
                add_need(need, n)
        check_counts(f"train_projection, {LLM_PROJ_EPOCHS * len(short)} steps [{card}]",
                     got, need)
        got_p = FF.tactile_projector(ckpt.load_pytree(os.path.join(root, "proj_run",
                                                                   "projection.msgpack")), dev)
        check_round_trip("train_projection's projection.msgpack", got_p.state_dict(),
                         proj_s.state_dict())
        chk_s = checked_run(lambda: RL.train_projection(
            enc, base_if, [short[0]], os.path.join(root, "proj_step"), epochs=1,
            lr=LLM_PROJ_LR, projector=proj_s))
        check_chk(f"train_projection checked step [{card}]", chk_s, need_s[0])
        with timed_backwards() as bw_s:
            RL.train_projection(enc, base_if, [short[0]], os.path.join(root, "proj_step"),
                                epochs=1, lr=LLM_PROJ_LR, projector=proj_s)
        if bw_s["K9"]["calls"] != nl or bw_s["K8"]["calls"] != need_s[0]["K8"]:
            raise AssertionError(f"train_projection step backwards {bw_s}")
        res["projector"] = dict(steps=LLM_PROJ_EPOCHS * len(short), wall_s=proj_wall,
                                step_ms=1e3 * proj_wall / (LLM_PROJ_EPOCHS * len(short)),
                                launches=got, backward_ms=bw_s,
                                checked={k: v for k, v in chk_s.items() if v["calls"]})
        iface = RL.make_llm_interface(cfg, tree, max_new_tokens=T)
        zero_counts()
        with recording_generate() as calls:
            preds = RL.test_llm(enc, iface, got_p, short, os.path.join(root, "test_proj"))
        need = planner_need(planner_launches(calls, nl, encodes=len(short),
                                             clip_layers=clip_layers))
        check_counts(f"test_llm after train_projection [{card}]", read_counts(), need)
        check_predictions(os.path.join(root, "test_proj"), preds, short)
        res["projector"]["test_llm"] = dict(launches=need, predictions=[
            p["prediction"][:60] for p in preds])
        log(f"train_projection [{card}]: " + json.dumps(res["projector"]))
        parts["projector"] = time.perf_counter() - t1

        # ---- the depth-2 step against the CPU's, on a short row (the CPU's
        # int32 products take seconds a step there, ~30 s at 150 rows)
        t1 = time.perf_counter()
        with torch.no_grad():
            feats = [RL._encode_video(enc, v, 224) for v in short[0]["tactile"]]
        res["step_vs_cpu"] = llm_step_vs_cpu(feats, short[0], slens[0][1])
        parts["step_vs_cpu"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["counts"] = add_need(dict(res["lora"]["launches"]), res["projector"]["launches"])
    for what in ("lora", "projector"):
        add_need(res["counts"], res[what]["test_llm"]["launches"])
    res["phase_s"] = time.perf_counter() - t_phase
    res["parts_s"] = parts
    log(f"LLM training phase [{card}]: {res['phase_s']:.1f} s ({json.dumps(parts)}), peak "
        f"{res['peak_gib']:.2f} GiB, launches {json.dumps(res['counts'])}")
    return res


def llm_step_totals(rows, M: int) -> dict:
    """K8's per-shape figures (the K8_LLM_SHAPES rows at M) summed over the
    calls of one LoRA training step of M rows."""
    tot = dict(M=M, calls=0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    for r in rows:
        if r["M"] == M:
            tot["calls"] += r["calls"]
            for key in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"):
                tot[key] += r["calls"] * r[key]
    tot["bound_by"] = bound_by(tot)
    return tot


def check_predictions(out_dir: str, preds: list, dataset) -> None:
    """``predictions.json`` holds one row a dataset row: its question and
    answer, and the decoded text ``test_llm`` returned."""
    with open(os.path.join(out_dir, "predictions.json")) as f:
        rows = json.load(f)
    if rows != preds or len(rows) != len(dataset) or any(
            r["question"] != dataset[i]["question"] or r["answer"] != dataset[i]["answer"]
            or not isinstance(r["prediction"], str) for i, r in enumerate(rows)):
        raise AssertionError(f"test_llm: predictions.json disagrees: {rows[:1]}")


# ---- the planner's VLM: Qwen2-VL-7B --------------------------------------------

# Request A: one 448^2 image, a (1, 32, 32) patch grid (1024 patches, 256
# merged tokens); request B: that image and a 336^2 one, (1, 24, 24) (576
# patches, 144 merged tokens), in one tower run.  The instructions keep each
# prompt + its 64 tokens within 512 rows, so the prompt pass runs K8 and the
# teacher-forced plain forward the same quantized product.
VLM_GRID_A = (1, 32, 32)
VLM_GRID_B = (1, 24, 24)
VLM_PATCHES_B = 576
VLM_TEXT_A = ("Describe the object in the image, then name the one primitive action "
              "the robot should take next to test how ripe it is without bruising it.")
VLM_TEXT_B = "Which mango is riper?"
VLM_TOKENS = 16
VLM_INT8_TOKENS = 16
VLM_SESSION_TOKENS = 16
VLM_SESSION_TURNS = 3
# the depth cut of the HF-layout round trip (full width, full embedding and head)
VLM_RT_LAYERS, VLM_RT_BLOCKS = 2, 2
# K1 at the tower's attention: frames as the batch, D 80; calls per tower
# run of request A / B (one per block)
K1_VLM_SHAPES = [("qwen2vl_vision_a", 1, 1024, 1024, 16, 80, "vit", None, 32),
                 ("qwen2vl_vision_b", 2, 1024, 1024, 16, 80, "vit", "vlm", 32)]


def draw_small_params(module, gen):
    """Every 1-D parameter drawn: norm weights 1 + N(0, 0.1^2), biases
    N(0, 0.1^2), so that a kernel or a loader that drops one shows."""
    import torch

    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                z = 0.1 * torch.randn(p.shape, generator=gen, device=p.device)
                p.copy_(z if name.endswith("bias") else 1 + z)


def build_vlm(seed: int = 0) -> dict:
    """Qwen2-VL-7B at full width and depth from seeded weights, on the card:
    the decoder in grouped int4 (quantized layer by layer), its fused twin
    and an int8 tree from the same draw, norms and biases drawn; the vision
    tower (32 x 1280) as float32 copies of bf16-rounded weights, as JAX's
    loader tree promotes them; seeded patches of the two images."""
    import torch

    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning import qwen2vl as VL

    tcfg, vcfg = L.backbone("qwen2-vl-7b")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    trees = {}
    for weights in ("int4", "int8"):
        tree = L.init_llm(tcfg, seed, dtype=torch.bfloat16, weights=weights)
        g = torch.Generator(device="cuda").manual_seed(seed + 3)
        with torch.no_grad():
            for w in [p for lp in tree.layers for p in (lp.input_norm, lp.post_norm)] + [
                    tree.final_norm]:
                w.copy_(1 + 0.1 * torch.randn(w.shape, generator=g, device="cuda"))
        trees[weights] = tree
    fused = L.fuse_quantized_layers(trees["int4"])
    tower = VL.init_vision(vcfg, seed + 4, dtype=torch.bfloat16)
    draw_small_params(tower, torch.Generator(device="cuda").manual_seed(seed + 5))
    tower = tower.float()
    rng = np.random.default_rng(seed + 6)
    patches = {g: torch.as_tensor(rng.normal(size=(g[0] * g[1] * g[2], vcfg.patch_dim))
                                  .astype(np.float32), device="cuda")
               for g in (VLM_GRID_A, VLM_GRID_B)}
    torch.cuda.synchronize()
    log(f"VLM built: Qwen2-VL-7B decoder w4 + fused twin + int8 tree, vision tower "
        f"{vcfg.depth} x {vcfg.embed_dim} (float32 copies of bf16 values) in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    return dict(cfg=tcfg, vcfg=vcfg, w4=trees["int4"], i8=trees["int8"], fused=fused,
                tower=tower, patches=patches)


def vlm_prompt(V, params, parts):
    """The prompt of ``parts`` [("text", str) | ("image", grid)]: one tower
    run over its images (their frames one K1 batch), the merged tokens
    spliced in place of byte-tokenizer pad placeholders, and its M-RoPE
    positions.  Returns (embeds (1, L, D), positions (3, 1, L), vision
    tokens)."""
    import torch

    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning import qwen2vl as VL

    tok, m = L.ByteTokenizer(), V["vcfg"].spatial_merge_size
    grids = [spec for kind, spec in parts if kind == "image"]
    vtok = VL.vision_forward(V["vcfg"], V["tower"],
                             torch.cat([V["patches"][g] for g in grids]),
                             VL.vision_rot_pos_ids(grids, m), VL.vision_segment_ids(grids))
    ids, segs, spans = [], [], []
    for kind, spec in parts:
        if kind == "text":
            t = tok.encode(spec)
            ids += t
            segs.append(("text", len(t)))
        else:
            n = spec[0] * spec[1] * spec[2] // m ** 2
            spans.append((len(ids), n))
            ids += [tok.PAD] * n
            segs.append(("image", spec))
    emb, at = L.embed_tokens(params, ids), 0
    for start, n in spans:
        emb = VL.splice_embeds(emb, vtok[at:at + n], start)
        at += n
    pos = torch.as_tensor(VL.mrope_positions(segs, m), device="cuda")[:, None, :]
    return emb[None], pos, vtok


def vlm_request(V, params, parts, T):
    """One greedy request: the prompt, then T tokens on ``params``."""
    from vla_touch_tpu_torch.planning import llm as L

    emb, pos, vtok = vlm_prompt(V, params, parts)
    toks, _, _ = L.greedy_generate(V["cfg"], params, emb, max_new_tokens=T,
                                   eos_id=L.ByteTokenizer.EOS, prompt_positions=pos)
    return toks, vtok


REQ_A = [("text", "user: "), ("image", VLM_GRID_A), ("text", f"\n{VLM_TEXT_A}\nassistant:")]
REQ_B = [("text", "user: "), ("image", VLM_GRID_A), ("text", " and "), ("image", VLM_GRID_B),
         ("text", f"\n{VLM_TEXT_B}\nassistant:")]


def vlm_requests(V, T=VLM_TOKENS) -> dict:
    """Requests A and B on the fused w4 tree (MEGAKERNELS on)."""
    return {name: vlm_request(V, V["fused"], parts, T)
            for name, parts in (("A", REQ_A), ("B", REQ_B))}


@contextlib.contextmanager
def plain_vision():
    """The tower's attention as JAX computes it: float32 operands, no bf16
    rounding for K1 (comparison runs only; the tower is the block's one
    caller of ``ops/attention.py``)."""
    from vla_touch_tpu_torch.ops import attention as A
    from vla_touch_tpu_torch.ops import flash_attention as FA

    orig = A.dot_product_attention
    A.dot_product_attention = FA.attention_plain
    try:
        yield
    finally:
        A.dot_product_attention = orig


def marker_frame(shift, rows=7, cols=9, H=140, W=180, radius=3):
    """A GelSight-style frame: dark marker dots on a bright field, the grid
    shifted by ``shift`` pixels."""
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.full((H, W), 200.0, np.float32)
    ch, cw = H // rows, W // cols
    for r in range(rows):
        for c in range(cols):
            d2 = (yy - (r * ch + ch / 2 + shift[1])) ** 2 + (xx - (c * cw + cw / 2 + shift[0])) ** 2
            img[d2 <= radius ** 2] = 40.0
    return img


def vlm_session(V, out_dir: str, seed: int = 0) -> dict:
    """A planner session (mango, three turns) whose VLM is Qwen2-VL over
    request A's image and the messages as ``role: content`` lines, its
    feedback the marker-tracked force of a seeded GelSight frame and the
    tactile service's ``describe`` of a tactile video (CLIP, K1).  Returns
    the session, its summary, the replies, and the tower runs and
    describes it made."""
    import torch

    from vla_touch_tpu_torch.ops import marker_tracking as MT
    from vla_touch_tpu_torch.planning import encoder as PE
    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning.planner import (PlannerConfig, PlannerSession,
                                                       TactileFeedback)
    from vla_touch_tpu_torch.planning.serving import TactileDescriptionService

    tok = L.ByteTokenizer()
    enc = PE.init_tactile_encoder(seed=seed + 1)
    frames = write_video(os.path.join(out_dir, "tactile"), seed)
    svc = TactileDescriptionService(enc)
    mcfg = MT.TrackerConfig(grid_rows=7, grid_cols=9, min_cell_mass=4.0)
    baseline = MT.calibrate(torch.as_tensor(marker_frame((0.0, 0.0)), device="cuda"), mcfg)
    rng = np.random.default_rng(seed + 7)
    replies, n = [], dict(tower=0, describe=0)

    def vlm_fn(messages):
        text = "\n".join(f"{m['role']}: {m['content']}" for m in messages) + "\nassistant:"
        toks, _ = vlm_request(V, V["fused"], [("image", VLM_GRID_A), ("text", "\n" + text)],
                              VLM_SESSION_TOKENS)
        n["tower"] += 1
        ids = [int(t) for t in toks[0].tolist()]
        reply = tok.decode(ids[:ids.index(tok.EOS)] if tok.EOS in ids else ids)
        replies.append(reply)
        return reply

    fb = TactileFeedback()

    def feedback_fn(action, turn):
        shift = (float(rng.uniform(0.5, 3.0)), float(rng.uniform(-1.0, 1.0)))
        force = MT.estimate_force(torch.as_tensor(marker_frame(shift), device="cuda"),
                                  baseline, mcfg)["force"]
        desc = svc.describe(frames)
        n["describe"] += 1
        return (fb.from_force(force.cpu().numpy()) + " "
                + fb.from_properties(desc["hardness"], desc["roughness"]))

    cfg = PlannerConfig("mango", max_turns=VLM_SESSION_TURNS,
                        results_dir=os.path.join(out_dir, "results"), session_name="vlm")
    session = PlannerSession(cfg, vlm_fn, fb)
    summary = session.run(feedback_fn)
    return dict(session=session, summary=summary, replies=replies, **n)


def check_session(S):
    """The session's jsonl log against its messages and replies, then its
    transcript row re-driven through ``replay_trial``: the same steps."""
    from vla_touch_tpu_torch.planning import transcripts as TR

    session, summary = S["session"], S["summary"]
    rows = [json.loads(line) for line in open(summary["log_path"])]
    roles = [r["role"] for r in rows]
    want_roles = ["assistant"] + ["user", "assistant"] * (len(S["replies"]) - 1)
    if roles != want_roles or [r["content"] for r in rows if r["role"] == "assistant"] \
            != S["replies"]:
        raise AssertionError(f"session log: roles {roles}, want {want_roles}")
    feedback = [r["content"] for r in rows if r["role"] == "user"]
    if not all("Force measurement" in f and "Tactile properties" in f for f in feedback):
        raise AssertionError(f"session feedback lacks a channel: {feedback}")
    done = any("DONE" in r.upper() for r in S["replies"])
    if summary["turns"] != len(S["replies"]) or summary["completed"] != done or (
            not done and len(S["replies"]) != VLM_SESSION_TURNS + 1):
        raise AssertionError(f"session summary {summary}, {len(S['replies'])} replies")
    trial = TR.trial_row(session, trial_number=1, image="request_a_448.png")
    again = TR.replay_trial(trial, os.path.dirname(summary["log_path"]))
    if again["steps"] != trial["steps"] or again["initial_prompt"] != trial["initial_prompt"]:
        raise AssertionError("replay_trial did not give the session's steps back")
    return dict(rows=len(rows), turns=summary["turns"], completed=summary["completed"],
                steps=len(trial["steps"]), replies=[r[:40] for r in S["replies"]])


def vlm_round_trip(V, out_dir: str, seed: int = 0) -> dict:
    """Qwen2-VL-7B at full width, depth cut to VLM_RT_LAYERS decoder layers
    and VLM_RT_BLOCKS vision blocks (embedding and lm_head full): built on
    the card in bf16, written as an HF-layout safetensors file by the port's
    writer, validated against the qwen2_vl_7b manifest (the only
    differences the cut layers' and blocks' keys), and read back through
    ``load_qwen2vl_from_hf`` in bf16, int4 and int8: bit for bit the built
    trees and ``quantize_llm_params`` of them, and the lm_head (quantized in
    row chunks) the leaf one quantizer call makes of the whole head."""
    import dataclasses

    import torch

    from vla_touch_tpu_torch.ops import quant as Q
    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning import qwen2vl as VL
    from vla_touch_tpu_torch.utils import checkpoint_manifest as TM
    from vla_touch_tpu_torch.utils import safetensors_io as ST

    tcfg = dataclasses.replace(V["cfg"], num_layers=VLM_RT_LAYERS)
    vcfg = dataclasses.replace(V["vcfg"], depth=VLM_RT_BLOCKS)
    dec = L.init_llm(tcfg, seed + 11, dtype=torch.bfloat16)
    draw_small_params(dec, torch.Generator(device="cuda").manual_seed(seed + 12))
    tower = VL.init_vision(vcfg, seed + 13, dtype=torch.bfloat16)
    draw_small_params(tower, torch.Generator(device="cuda").manual_seed(seed + 14))
    dsd, vsd = dec.state_dict(), tower.state_dict()
    tensors = {hf: dsd[name] for hf, name in L.hf_key_map(tcfg).items()}
    for hf, (name, tf) in VL.vision_hf_key_map(vcfg).items():
        t = vsd[name]
        tensors[hf] = t.reshape(t.shape[0], vcfg.in_channels, vcfg.temporal_patch_size,
                                vcfg.patch_size, vcfg.patch_size) if tf == "conv" else t
    path = os.path.join(out_dir, "model.safetensors")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = ST.save_file(tensors, path)
    write_s = time.perf_counter() - t0
    del tensors
    diff = TM.validate_checkpoint(out_dir, "qwen2_vl_7b")
    cut = [k for k in diff.missing
           if not any(k.startswith(f"{p}.{i}.") for p in ("model.layers", "visual.blocks")
                      for i in range(VLM_RT_LAYERS if p == "model.layers" else VLM_RT_BLOCKS))
           and (k.startswith("model.layers.") or k.startswith("visual.blocks."))]
    if diff.extra or diff.shape_mismatch or sorted(cut) != sorted(diff.missing):
        raise AssertionError("round-trip file vs the qwen2_vl_7b manifest: " + diff.summary(
            "qwen2_vl_7b"))

    def same(what, got, want):
        g, w = got.state_dict(), want.state_dict()
        bad = [k for k in w if k not in g or g[k].dtype != w[k].dtype or not torch.equal(g[k], w[k])]
        if set(g) != set(w) or bad:
            raise AssertionError(f"round trip {what}: {len(bad)} tensors differ, e.g. {bad[:4]}, "
                                 f"names {sorted(set(g) ^ set(w))[:4]}")

    res = dict(bytes=nbytes, write_s=write_s, tensors=len(dsd) + len(vsd))
    torch.cuda.empty_cache()
    for weights in (None, "int4", "int8"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got_t, got_v = VL.load_qwen2vl_from_hf(tcfg, vcfg, out_dir, weights=weights)
        torch.cuda.synchronize()
        key = weights or "bf16"
        res[f"read_s_{key}"] = time.perf_counter() - t0
        res[f"peak_gib_{key}"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        res[f"tree_gib_{key}"] = (torch.cuda.memory_allocated() - base) / 2**30
        same(f"{key} decoder", got_t, dec if weights is None else L.quantize_llm_params(dec, weights))
        same(f"{key} tower", got_v, tower)
        if weights is not None:
            # the 152064-row head, quantized in row chunks, against one call
            whole = (Q.quantize_linear_w4 if weights == "int4" else Q.quantize_linear)(dec.lm_head)
            same(f"{key} lm_head in one call", got_t.lm_head, whole)
            del whole
        del got_t, got_v
    log(f"VLM HF round trip ({VLM_RT_LAYERS} decoder layers, {VLM_RT_BLOCKS} vision blocks, "
        f"full width, embedding and head): {nbytes} bytes written in {write_s:.2f} s, read "
        f"bf16 / int4 / int8 in {res['read_s_bf16']:.2f} / {res['read_s_int4']:.2f} / "
        f"{res['read_s_int8']:.2f} s, peak device memory above the resident trees "
        f"{res['peak_gib_bf16']:.2f} / {res['peak_gib_int4']:.2f} / {res['peak_gib_int8']:.2f} "
        f"GiB (trees {res['tree_gib_bf16']:.2f} / {res['tree_gib_int4']:.2f} / "
        f"{res['tree_gib_int8']:.2f} GiB); manifest: only the {len(diff.missing)} cut keys "
        f"missing; every tensor bit for bit [{gpu_line()}]")
    return res


def vlm_phase(gen) -> dict:
    """Everything of the planner's VLM slice; returns what the kernels line
    and the log need."""
    import shutil

    import torch

    from vla_touch_tpu_torch.planning import llm as L

    t_phase = time.perf_counter()
    default_megakernels = L.MEGAKERNELS
    L.MEGAKERNELS = True
    card = gpu_line()
    res = {}
    res["k1_vlm_rows"], _ = check_k1(gen, K1_VLM_SHAPES)
    V = build_vlm(seed=0)
    cfg, nl, depth = V["cfg"], V["cfg"].num_layers, V["vcfg"].depth
    vlm_requests(V, T=4)                                    # warm-up

    # ---- requests A and B, counted
    zero_counts()
    with recording_generate() as calls:
        out = vlm_requests(V)
    torch.cuda.synchronize()
    counts_ab = read_counts()
    res["launches"] = planner_launches(calls, nl, encodes=0, vision_blocks=2 * depth)
    check_counts(f"VLM requests A and B (fused w4, MEGAKERNELS) [{card}]", counts_ab,
                 planner_need(res["launches"]))
    res["calls"] = [dict(B=c["B"], Lp=c["Lp"], N=c["N"], T=c["T"]) for c in calls]
    for (name, (toks, vtok)), c in zip(out.items(), calls):
        ok = (toks.shape == (1, VLM_TOKENS) and bool(torch.isfinite(vtok).all())
              and bool(torch.isfinite(c["logits"]).all()) and c["Lp"] + VLM_TOKENS - 1 <= 512)
        if not ok:
            raise AssertionError(f"VLM request {name}: tokens {tuple(toks.shape)}, vision "
                                 f"tokens {tuple(vtok.shape)}, prompt {c['Lp']}")
    log(f"VLM requests: {res['calls']}; vision tokens A {tuple(out['A'][1].shape)}, B "
        f"{tuple(out['B'][1].shape)}")

    # ---- request C: request A on the int8 tree (K6)
    zero_counts()
    toks_c, _ = vlm_request(V, V["i8"], REQ_A, VLM_INT8_TOKENS)
    torch.cuda.synchronize()
    counts_c = read_counts()
    check_counts(f"VLM request C (int8, {VLM_INT8_TOKENS} tokens) [{card}]", counts_c,
                 {"K1": depth, "K6": VLM_INT8_TOKENS * (7 * nl + 1)})

    # ---- kernel vs plain: vision tokens, teacher-forced logits
    with plain_kernels(), plain_vision():
        plain_vtok = {name: vlm_prompt(V, V["fused"], parts)[2]
                      for name, parts in (("A", REQ_A), ("B", REQ_B))}
    res["vision_corr"] = {k: corr(out[k][1].cpu().numpy(), plain_vtok[k].cpu().numpy())
                          for k in out}
    P = dict(cfg=cfg)
    res["teacher_forced"] = [(c["Lp"],) + teacher_forced(P, c) for c in calls]
    log(f"VLM kernel vs plain [{card}]: vision-token corr {res['vision_corr']} (min "
        f"{TOKEN_CORR_MIN}); teacher-forced logits (prompt tokens, min per-step corr, token "
        f"agreement, first-step corr, median corr) {res['teacher_forced']} (corr min "
        f"{LOGITS_CORR_MIN})")
    if not (all(v > TOKEN_CORR_MIN for v in res["vision_corr"].values())
            and all(t[1] > LOGITS_CORR_MIN for t in res["teacher_forced"])):
        raise AssertionError("VLM: the kernel run disagrees with the plain run")

    # ---- checked runs: A, B and C at 2 tokens
    with recording_generate() as calls4:
        chk = checked_run(lambda: vlm_requests(V, T=2))
    check_chk(f"VLM checked requests A and B (2 tokens) [{card}]", chk,
              planner_need(planner_launches(calls4, nl, encodes=0, vision_blocks=2 * depth)))
    chk8 = checked_run(lambda: vlm_request(V, V["i8"], REQ_A, 2))
    check_chk(f"VLM checked request C (int8, 2 tokens) [{card}]", chk8,
              {"K1": depth, "K6": 2 * (7 * nl + 1)})
    res.update(checked={k: v for k, v in chk.items() if v["calls"]},
               checked_int8={k: v for k, v in chk8.items() if v["calls"]})

    # ---- times
    def timed(fn, reps=3):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t1))
        return float(np.median(ts))

    times = {}
    for name, parts in (("A", REQ_A), ("B", REQ_B)):
        grids = [spec for kind, spec in parts if kind == "image"]
        vis = timed(lambda: vlm_prompt(V, V["fused"], parts))
        ttft = timed(lambda: vlm_request(V, V["fused"], parts, 1))
        full = timed(lambda: vlm_request(V, V["fused"], parts, VLM_TOKENS), reps=2)
        times[name] = dict(patches=sum(g[0] * g[1] * g[2] for g in grids), vision_ms=vis,
                           ttft_ms=ttft, decode_ms_per_token=(full - ttft) / (VLM_TOKENS - 1),
                           request_ms=full)
    times["C_int8_request_ms"] = timed(lambda: vlm_request(V, V["i8"], REQ_A,
                                                           VLM_INT8_TOKENS), reps=2)
    log(f"VLM times [{card}]: " + json.dumps(times))
    res["times"] = times

    # ---- the planner session, then the HF round trip
    work = os.path.join(ROOT, "build", "vlm")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        zero_counts()
        with recording_generate() as scalls:
            t1 = time.perf_counter()
            S = vlm_session(V, work)
            torch.cuda.synchronize()
            session_s = time.perf_counter() - t1
        counts_s = read_counts()
        need = planner_need(planner_launches(scalls, nl, encodes=S["describe"],
                                             vision_blocks=S["tower"] * depth))
        check_counts(f"VLM planner session [{card}]", counts_s, need)
        res["session"] = check_session(S)
        res["session"].update(calls=[dict(Lp=c["Lp"], T=c["T"]) for c in scalls],
                              wall_s=session_s, s_per_turn=session_s / len(S["replies"]))
        log(f"VLM planner session [{card}]: " + json.dumps(res["session"]))
        del S
        del V
        torch.cuda.empty_cache()
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        res["round_trip"] = vlm_round_trip(dict(cfg=cfg, vcfg=L.backbone("qwen2-vl-7b")[1]),
                                           work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["counts"] = {k: counts_ab[k] + counts_c[k] + counts_s[k] for k in counts_ab}
    L.MEGAKERNELS = default_megakernels
    log(f"VLM phase: {time.perf_counter() - t_phase:.1f} s")
    return res


# ---- the planner's tactile encoder, trained and evaluated ----------------------

# The JAX trainers' defaults: batches of 8 videos x 4 frames at 224^2, lr
# 1e-4; the prompt-learned towers with 4 prompts to depth 9 in both, and
# CLIP's 512-wide projections (ViT-B/16's 768 beside the text tower's 512).
TACT_BATCH = 8
TACT_FRAMES = 4
TACT_LR = 1e-4
TACT_PROMPTS = 4
TACT_DEPTH = 9
TACT_PROJ = 512
# the raw PhysiCLeAR tree: 16 train and 4 test objects, a recording of each
# under both exploratory procedures, 8 frames of a 240 x 320 GelSight
# image; so 32 train samples, 4 contrastive batches, 20 steps in 5 epochs
TACT_TRAIN_OBJECTS = 16
TACT_TEST_OBJECTS = 4
TACT_RAW = (8, 240, 320)
TACT_EPOCHS = 5
TACT_PROP_EPOCHS = 2
TACT_SOT, TACT_EOS, TACT_FILLER = 49406, 49407, 343    # CLIP's start, end and "x" ids
# The contrastive loss fall over the 20 steps (loss_fall: the first 3
# steps' mean against the last 5's), written before the first run on the
# card: 4 batches seen 5 times each, so a sound trainer memorises them,
# and one that does not update keeps the first and last steps' means
# within the batches' spread.  Controls on the 2-layer cut (CPU,
# tools/torch_vificlip_loss_fall.py): sound 0.397, every recording the same
# press 0.014, lr 0 -0.003.
TACT_FALL_MIN = 0.2
# A depth-cut (2-layer) step on the card in bf16 against the CPU's in
# float32: bf16 against float32 on the CPU reads loss 9.5e-5, gradient
# L2 2.2e-2, corr 0.99977 at this model and batch
# (tools/torch_vificlip_bf16_step.py full).
TACT_LOSS_RTOL = 2e-3
TACT_GRAD_L2_TOL = 6e-2
TACT_GRAD_CORR_MIN = 0.999
K1_TACT_GRAD_SHAPES = [("vificlip_prompt_self", 32, 201, 201, 12, 64, "vit", None),
                       ("vificlip_self", 32, 197, 197, 12, 64, "vit", None)]


def tactile_objects() -> tuple:
    """(train, test) object ids of the raw tree: the scenario targets of
    the train split first, then the train split in order; the first test
    objects."""
    from vla_touch_tpu_torch.planning import physiclear as PC

    targets = [t for sc in PC.SCENARIOS.values() for t in sc["target_sample"]
               if t in PC.TRAIN_OBJECTS]
    train = list(dict.fromkeys(targets + PC.TRAIN_OBJECTS))[:TACT_TRAIN_OBJECTS]
    return train, PC.TEST_OBJECTS[:TACT_TEST_OBJECTS]


def tactile_data(root: str) -> dict:
    """The PhysiCLeAR pipeline on a seeded raw tree: recordings written,
    extracted into sample dirs, the split registries built, both QA
    generators' files written and read back through ``TactileLLMDataset``;
    returns the paths, counts and seconds."""
    from vla_touch_tpu_torch.planning import datasets as D
    from vla_touch_tpu_torch.planning import process_datasets as PD
    from vla_touch_tpu_torch.planning import qa as QA

    train, test = tactile_objects()
    raw, samples = os.path.join(root, "raw"), os.path.join(root, "samples")
    n, H, W = TACT_RAW
    t0 = time.perf_counter()
    for e, ep in enumerate(("pressing", "sliding")):
        for i, obj in enumerate(train + test):
            write_video(os.path.join(raw, ep, f"{obj[len('physiclear_'):]}_{e}"),
                        seed=100 * e + i, n=n, size=H, width=W, varied=True)
    t1 = time.perf_counter()
    count = PD.extract_physiclear(raw, samples)
    regs = PD.build_samples_json(samples, *(os.path.join(root, f"{s}_samples.json")
                                            for s in ("train", "val", "test")))
    if count != 2 * (len(train) + len(test)) or sorted(regs["train"]) != sorted(train) \
            or sorted(regs["test"]) != sorted(test) or regs["val"]:
        raise AssertionError(f"tactile data: {count} samples, registries "
                             f"{ {k: len(v) for k, v in regs.items()} }")
    desc = QA.generate_physiclear_description_ranking_qa(regs["train"], 32, seed=0)
    scen = QA.generate_physiclear_scenario_qa(regs["train"], 4, seed=0)
    paths = [QA.write_qa_file(desc, os.path.join(root, "qa", "description_ranking.json")),
             QA.write_qa_file(scen, os.path.join(root, "qa", "scenario.json"))]
    ds = D.TactileLLMDataset(paths, "train")
    rows = [ds[i] for i in range(len(ds))]
    missing = [p for r in rows for p in r["info"]["tactile"] if not os.path.isdir(p)]
    if len(rows) != len(desc) + len(scen) or len(scen) != 4 or missing:
        raise AssertionError(f"tactile QA: {len(rows)} rows read back of "
                             f"{len(desc)} + {len(scen)}, missing recordings {missing[:2]}")
    return dict(samples=samples, train_samples=2 * len(train), test_samples=2 * len(test),
                qa_rows=len(rows), write_s=t1 - t0, process_s=time.perf_counter() - t1)


def caption_batch(rng, B: int, L: int = 77):
    """Seeded caption ids: start, the 4 filler slots the text prompts
    overwrite, 6..40 random ids, end; zeros after, the mask through the
    end token."""
    ids = np.zeros((B, L), np.int64)
    mask = np.zeros((B, L), np.int64)
    for b in range(B):
        k = int(rng.integers(6, 41))
        row = [TACT_SOT] + [TACT_FILLER] * TACT_PROMPTS + list(rng.integers(1, TACT_SOT, k)) \
            + [TACT_EOS]
        ids[b, :len(row)] = row
        mask[b, :len(row)] = 1
    return ids, mask


def contrastive_batches(samples: str) -> list:
    """The train samples as contrastive batches: the regression dataset's
    frames (224^2, 4 frames, one shuffled pass) with a seeded caption per
    video."""
    from vla_touch_tpu_torch.planning import datasets as D

    ds = D.TactilePropertyRegressionDataset(samples, "train", ["physiclear"], frame_size=224,
                                            max_frames=TACT_FRAMES, seed=0)
    rng = np.random.default_rng(7)
    out = []
    for b in ds.batches(TACT_BATCH):
        ids, mask = caption_batch(rng, len(b["paths"]))
        out.append({"frames": b["frames"], "input_ids": ids, "attention_mask": mask})
    return out


def tactile_step_vs_cpu(batch) -> dict:
    """One contrastive loss and gradient of a depth-cut (2-layer) full-width
    model on the card in bf16 against the CPU's in float32 (master weights
    equal, text frozen): the loss's relative error, the gradient's
    relative L2 error and corr, K1's launches on the card."""
    import copy
    import dataclasses

    import torch

    from vla_touch_tpu_torch.models.encoders import clip_text as CT
    from vla_touch_tpu_torch.models.encoders import vit as V
    from vla_touch_tpu_torch.ops import flash_attention as FA
    from vla_touch_tpu_torch.planning import encoder as PE
    from vla_touch_tpu_torch.planning import train_encoder as TE

    vc = dataclasses.replace(V.CLIP_VIT_B16, num_layers=2)
    tc = dataclasses.replace(CT.CLIP_TEXT_B16, num_layers=2)
    cpu = PE.init_vificlip_model(vc, tc, seed=1, device="cpu", prompt_learning=True,
                                 num_prompts=TACT_PROMPTS, prompt_depth_vision=TACT_DEPTH,
                                 prompt_depth_text=TACT_DEPTH, projection_dim=TACT_PROJ)
    card = copy.deepcopy(cpu).cuda()
    out = {}
    for name, m, dt, dev in (("card", card, torch.bfloat16, "cuda"),
                             ("cpu", cpu, torch.float32, "cpu")):
        V.master_weights_(m, dt).requires_grad_(True)
        m.text.requires_grad_(False)
        before = FA.flash_attention.launches
        loss = TE.contrastive_loss(m, batch, dev)
        loss.backward()
        grads = torch.cat([p.grad.double().flatten().cpu() for p in m.parameters()
                           if p.grad is not None])
        out[name] = (float(loss.detach()), grads, FA.flash_attention.launches - before)
    (l_card, a, k1), (l_cpu, b, _) = out["card"], out["cpu"]
    res = dict(loss_card=l_card, loss_cpu=l_cpu, loss_rel_err=abs(l_card - l_cpu) / abs(l_cpu),
               grad_l2_rel=float((a - b).norm() / b.norm()),
               grad_corr=float(torch.corrcoef(torch.stack([a, b]))[0, 1]), k1_launches=k1)
    log("tactile depth-2 step, card (bf16) vs CPU (float32): " + json.dumps(res) +
        f" (tolerances: loss {TACT_LOSS_RTOL}, L2 {TACT_GRAD_L2_TOL}, corr min "
        f"{TACT_GRAD_CORR_MIN})")
    if not (res["loss_rel_err"] <= TACT_LOSS_RTOL and res["grad_l2_rel"] <= TACT_GRAD_L2_TOL
            and res["grad_corr"] >= TACT_GRAD_CORR_MIN and k1 == vc.num_layers):
        raise AssertionError(f"tactile encoder: the card's step disagrees with the CPU's: {res}")
    return res


def check_encoder_round_trip(st, path: str, frames) -> dict:
    """``load_tactile_encoder`` of the trainer's saved directory: every
    tensor of the CLIP tower, the adapters and the classifier with the
    trained state's dtype and bits, and one ``encode_tactile_video`` equal
    to the trained state's."""
    import torch

    from vla_touch_tpu_torch.planning import encoder as PE

    t0 = time.perf_counter()
    loaded = PE.load_tactile_encoder(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for what in ("clip", "adapters", "classifier"):
        check_round_trip(f"tactile encoder {what}", getattr(loaded, what).state_dict(),
                         getattr(st, what).state_dict())
    frames = torch.as_tensor(frames, device="cuda")
    if not torch.equal(PE.encode_tactile_video(loaded, frames),
                       PE.encode_tactile_video(st, frames)):
        raise AssertionError("tactile encoder: the loaded encoder serves other features")
    nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    return dict(bytes=nbytes, load_s=load_s)


def tactile_encoder_phase(gen) -> dict:
    """The planner's tactile encoder trained and evaluated at full width
    (CLIP ViT-B/16 and the B/16 text tower, prompt-learned, seeded weights):
    K1's autograd route at the contrastive step's shapes; the PhysiCLeAR
    data pipeline on a seeded raw tree; ``train_vificlip_contrastive`` for
    20 steps (text frozen) with K1's launches asserted (one a vision
    block a step, none in the text tower), the loss fall gated, the frozen
    text tower bit for bit, one step as a checked run, a depth-cut step
    against the CPU's, the step's times and profile; then
    ``train_property_encoder`` and ``evaluate_encoder`` on the processed
    samples (launches asserted) and the saved encoder read back bit for
    bit."""
    import math
    import shutil

    import torch

    from vla_touch_tpu_torch.planning import encoder as PE
    from vla_touch_tpu_torch.planning import train_encoder as TE

    t_phase = time.perf_counter()
    card = gpu_line()
    torch.cuda.reset_peak_memory_stats()
    res = {"k1_autograd": k1_grad_check(gen, K1_TACT_GRAD_SHAPES)}
    root = os.path.join(ROOT, "build", "tactile")
    shutil.rmtree(root, ignore_errors=True)
    try:
        data = tactile_data(root)
        batches = contrastive_batches(data["samples"])
        res["data"] = data
        log(f"tactile data [{card}]: " + json.dumps(data))

        # ---- the contrastive trainer, counted
        model = PE.init_vificlip_model(
            seed=0, prompt_learning=True, num_prompts=TACT_PROMPTS,
            prompt_depth_vision=TACT_DEPTH, prompt_depth_text=TACT_DEPTH,
            projection_dim=TACT_PROJ)
        text0 = {n: t.clone() for n, t in model.text.state_dict().items()}
        blocks = model.vision.cfg.num_layers
        steps = TACT_EPOCHS * len(batches)
        zero_counts()
        t1 = time.perf_counter()
        model, losses = TE.train_vificlip_contrastive(batches, model=model, epochs=TACT_EPOCHS,
                                                      lr=TACT_LR)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        counts_c = read_counts()
        check_counts(f"tactile contrastive training, {steps} steps [{card}]", counts_c,
                     {"K1": blocks * steps})
        check_round_trip("tactile contrastive: the frozen text tower",
                         model.text.state_dict(), text0)
        fall = loss_fall(losses)
        log(f"tactile contrastive losses: {[round(x, 4) for x in losses]}; fall {fall:.4f} "
            f"(min {TACT_FALL_MIN})")
        if not (np.all(np.isfinite(losses)) and fall >= TACT_FALL_MIN):
            raise AssertionError(f"tactile contrastive: the loss does not fall ({fall})")
        res["contrastive"] = dict(steps=steps, losses=losses, fall=fall, train_s=train_s,
                                  launches=counts_c["K1"])

        # ---- one step as a checked run; the depth-cut step against the CPU
        chk = checked_run(lambda: TE.train_vificlip_contrastive([batches[0]], model=model,
                                                                lr=TACT_LR))
        check_chk(f"tactile checked contrastive step [{card}]", chk, {"K1": blocks})
        res["checked"] = {k: v for k, v in chk.items() if v["calls"]}
        res["step_vs_cpu"] = tactile_step_vs_cpu(batches[0])

        # ---- times: one trainer step a call, and one profiled
        def step(i=[0]):
            i[0] += 1
            TE.train_vificlip_contrastive([batches[i[0] % len(batches)]], model=model,
                                          lr=TACT_LR)

        ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t1))
        prof = profile_run(step)
        k1_ms = prof["groups_ms"]["K1 flash_fwd_kernel"] + prof["groups_ms"][
            "K1 flash_combine_kernel"]
        res["contrastive"].update(
            step_ms=ms[1:], step_ms_p50=float(np.median(ms[1:])),
            videos_per_s=TACT_BATCH / (float(np.median(ms[1:])) / 1e3),
            k1_share_of_busy=k1_ms / prof["device_busy_ms"], profile=prof)
        log(f"tactile contrastive step [{card}]: p50 {res['contrastive']['step_ms_p50']:.2f} ms "
            f"({res['contrastive']['videos_per_s']:.1f} videos/s), K1 {k1_ms:.3f} ms of "
            f"{prof['device_busy_ms']:.3f} ms busy, idle {prof['idle_share']:.3f}")
        del model
        torch.cuda.empty_cache()

        # ---- the property encoder: training, evaluation, the saved encoder
        out_dir = os.path.join(root, "encoder_run")
        prop_steps = TACT_PROP_EPOCHS * math.ceil(data["train_samples"] / TACT_BATCH)
        zero_counts()
        t1 = time.perf_counter()
        st = TE.train_property_encoder(data["samples"], out_dir, epochs=TACT_PROP_EPOCHS,
                                       batch_size=TACT_BATCH, lr=TACT_LR, frame_size=224,
                                       max_frames=TACT_FRAMES, seed=0)
        torch.cuda.synchronize()
        prop_s = time.perf_counter() - t1
        counts_p = read_counts()
        check_counts(f"tactile property training, {prop_steps} steps [{card}]", counts_p,
                     {"K1": blocks * prop_steps})
        zero_counts()
        t1 = time.perf_counter()
        metrics = TE.evaluate_encoder(st, data["samples"], split="test", frame_size=224,
                                      max_frames=TACT_FRAMES)
        eval_ms = 1e3 * (time.perf_counter() - t1)
        counts_e = read_counts()
        check_counts(f"tactile encoder evaluation [{card}]", counts_e,
                     {"K1": blocks * math.ceil(data["test_samples"] / 8)})
        if metrics["num_samples"] != data["test_samples"] or not np.isfinite(metrics["mse"]):
            raise AssertionError(f"tactile evaluation: {metrics}")
        res["property"] = dict(steps=prop_steps, train_s=prop_s,
                               step_ms=1e3 * prop_s / prop_steps, eval_ms=eval_ms,
                               metrics=metrics,
                               round_trip=check_encoder_round_trip(
                                   st, os.path.join(out_dir, "encoder"),
                                   batches[0]["frames"][:2]))
        log(f"tactile property encoder [{card}]: " + json.dumps(res["property"]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["counts"] = {k: counts_c[k] + counts_p[k] + counts_e[k] for k in counts_c}
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"tactile encoder phase: {res['phase_s']:.1f} s, peak {res['peak_gib']:.2f} GiB")
    return res


# ---- the residual controllers -------------------------------------------------

# Training steps per controller, the steps before the timed ones, and the
# learning rate of the smoke run (the trainers' CLI flag; their default 1e-4
# moves a randomly initialised net too little in 30 steps to see).
CTRL_STEPS = 20
CTRL_WARMUP = 5
CTRL_LR = 1e-3
CTRL_HORIZON = 32                  # bridge_train / lstm_train main's default
CTRL_EVAL_SAMPLES = 50             # bridge_test / lstm_step_test's default
CTRL_CHECK_ROWS = 16               # rows of the card-vs-CPU step
# The loss must fall: (mean of the first 3 steps - mean of the last 5) /
# |mean of the first 3| at least CTRL_FALL_MIN.  On an H100 a sound run
# reads 0.997 (BRIDGeR) and 0.946 (LSTM); the planted faults of
# tools/torch_controller_fault_control.py, the optimizer step skipped and
# the learning rate at 0, read 0.001 and -0.001.
CTRL_FALL_MIN = {"bridger": 0.5, "lstm": 0.5}
# Card step vs the port's CPU eager step on the same parameters, batch and
# draws (TF32 off for matmuls and cuDNN, as the trainers set it): the loss to CTRL_LOSS_RTOL, each
# gradient leaf's max abs error to CTRL_GRAD_TOL x max(its max |grad|, 1e-3
# x the largest |grad| of the model) (leaves whose gradient is 0 but for
# rounding, the conv biases that GroupNorm cancels, get the floor).
CTRL_LOSS_RTOL = 1e-4
CTRL_GRAD_TOL = 1e-3
# The LSTM's step-by-step rollout against its sequence mode: the same cell
# arithmetic; the head's Linear on (B, h) rows against (B, T, h) may sum in
# another order.
LSTM_SEQ_TOL = 1e-5


class MemoryEpisodes:
    """Seeded numpy controller windows held in memory, with
    ``ControllerDataset``'s ``__len__``, ``__getitem__`` (numpy items),
    ``batches`` (here: dicts of tensors on the card) and ``stats``.  The
    expert chunk is the VLA chunk plus a learnable function of the current
    state and force; images index a pool of seeded 384^2 frames per camera
    (on the card for the batches).  The frames are drawn in [0, 215]: their
    mean, 0.42, sits well below ``encode_images``' 0.5 threshold, on the
    side of camera frames (ImageNet's channel means are 0.41-0.49), so every
    batch takes the same branch."""

    def __init__(self, n: int, horizon: int, ctx: int = 2, size: int = 384, pool: int = 32,
                 seed: int = 0):
        import torch

        rng = np.random.default_rng(seed)
        T = ctx + horizon
        self.n, self.ctx = n, ctx
        states = (np.cumsum(rng.normal(0, 0.02, (n, T, 10)), axis=1)
                  + rng.normal(0, 0.3, (n, 1, 10))).astype(np.float32)
        states[..., -1] = np.clip(128 + 400 * states[..., -1], 0, 255)   # raw gripper
        forces = rng.normal(0, 0.5, (n, T, 3)).astype(np.float32)
        future = states[:, ctx:].copy()
        future[..., -1] /= 255.0
        vla = future + rng.normal(0, 0.02, future.shape).astype(np.float32)
        a, f = rng.normal(0, 0.5, (10, 10)), rng.normal(0, 0.5, (3, 10))
        ramp = np.linspace(0.2, 1.0, horizon)[None, :, None]
        now = states[:, ctx - 1].copy()
        now[:, -1] /= 255.0
        delta = 0.1 * np.tanh(now @ a)[:, None] + 0.1 * np.tanh(forces[:, ctx - 1] @ f)[:, None]
        self.arrays = {"states": states, "vla_actions": vla,
                       "expert_actions": (vla + delta * ramp).astype(np.float32),
                       "forces": forces, "disps": rng.normal(0, 0.1, (n, T, 2)).astype(np.float32)}
        self.frames = [rng.integers(0, 216, (pool, size, size, 3), dtype=np.uint8)
                       for _ in range(2)]
        self.frame_idx = rng.integers(0, pool - ctx, n)
        self.dev = {k: torch.as_tensor(v, device="cuda") for k, v in self.arrays.items()}
        self.dev_frames = [torch.as_tensor(p, device="cuda") for p in self.frames]
        e, v = self.arrays["expert_actions"], self.arrays["vla_actions"]
        self.stats = {"action_mins": e.min((0, 1)), "action_maxs": e.max((0, 1)),
                      "vla_mins": v.min((0, 1)), "vla_maxs": v.max((0, 1))}

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> dict:
        out = {k: v[i] for k, v in self.arrays.items()}
        j = self.frame_idx[i]
        for c in (1, 2):
            out[f"images_cam{c}"] = self.frames[c - 1][j:j + self.ctx].astype(np.float32) / 255.0
        return out

    def batches(self, batch_size, rng, shuffle=True, drop_last=True, workers=0):
        import torch

        order = rng.permutation(self.n) if shuffle else np.arange(self.n)
        for i in range(0, self.n - batch_size + 1, batch_size):
            idx = torch.as_tensor(order[i:i + batch_size], device="cuda")
            out = {k: v[idx] for k, v in self.dev.items()}
            fi = torch.as_tensor(self.frame_idx, device="cuda")[idx]
            steps = fi[:, None] + torch.arange(self.ctx, device="cuda")
            for c in (1, 2):
                out[f"images_cam{c}"] = self.dev_frames[c - 1][steps].float() / 255.0
            yield out


def train_loop(trainer, data, steps: int, lr: float, lstm: bool) -> dict:
    """``steps`` trainer steps (``prepare_batch`` then ``step``), each
    synchronised: the losses, the step ms and the DinoV2 (``prepare_batch``)
    ms of each."""
    import torch

    rng = np.random.default_rng(0)
    batches = data.batches(trainer.tcfg.batch_size, rng)
    losses, step_ms, dino_ms = [], [], []
    for _ in range(steps):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prep = trainer.prepare_batch(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = trainer.step(prep) if lstm else trainer.step(prep, lr)
        loss = float(out if lstm else out["loss"])
        t2 = time.perf_counter()
        losses.append(loss)
        step_ms.append(1e3 * (t2 - t0))
        dino_ms.append(1e3 * (t1 - t0))
    return dict(losses=losses, step_ms=step_ms, dino_ms=dino_ms)


def loss_fall(losses) -> float:
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-5:]))
    return (first - last) / abs(first)


def step_vs_cpu(what, module, loss_fn, batch: dict, draws: dict) -> dict:
    """One loss + backward of ``module`` on the card and of its CPU copy on
    the same batch and draws: the loss's relative error and the worst
    gradient leaf's share of its tolerance (CTRL_LOSS_RTOL, CTRL_GRAD_TOL)."""
    import copy

    import torch

    module.zero_grad(set_to_none=True)
    cpu = copy.deepcopy(module).cpu()
    dev_loss = loss_fn(module, batch, draws)
    dev_loss.backward()
    cpu_loss = loss_fn(cpu, {k: v.cpu() for k, v in batch.items()},
                       {k: v.cpu() for k, v in draws.items()})
    cpu_loss.backward()
    grads = {n: p.grad.cpu() for n, p in module.named_parameters()}
    want = {n: p.grad for n, p in cpu.named_parameters()}
    module.zero_grad(set_to_none=True)
    top = max(float(g.abs().max()) for g in want.values())
    share, worst = 0.0, None
    for n, w in want.items():
        tol = CTRL_GRAD_TOL * max(float(w.abs().max()), 1e-3 * top)
        sh = float((grads[n] - w).abs().max()) / tol
        if sh >= share:
            share, worst = sh, n
    rel = abs(float(dev_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    res = dict(loss_card=float(dev_loss), loss_cpu=float(cpu_loss), loss_rel_err=rel,
               grad_share=share, worst_leaf=worst, leaves=len(want))
    log(f"{what} card step vs CPU step: " + json.dumps(res))
    if not (rel <= CTRL_LOSS_RTOL and share <= 1.0):
        raise AssertionError(f"{what}: the card's step disagrees with the CPU step: {res}")
    return res


def check_round_trip(what, got: dict, want: dict):
    """Every tensor of ``want`` in ``got`` with the same dtype and bits."""
    import torch

    bad = [n for n, t in want.items()
           if n not in got or got[n].dtype != t.dtype or not torch.equal(got[n], t)]
    if set(got) != set(want) or bad:
        raise AssertionError(f"{what}: checkpoint round trip differs: {bad[:4]}")


def controllers_phase() -> dict:
    """Train BRIDGeR and the LSTM controller at the deployment widths
    through their trainer classes, check one step on the card against the
    CPU, round-trip both checkpoints, evaluate both (BRIDGeR's 'vs' and 'bs'
    SDEs) with the launch counts asserted and every K1/K2 call held to its
    plain version, and time the refine."""
    import shutil

    import torch

    from vla_touch_tpu_torch.config import (BridgeControllerConfig, BridgeTrainConfig,
                                            LSTMControllerConfig, LSTMTrainConfig)
    from vla_touch_tpu_torch.eval import bridge_test as BE
    from vla_touch_tpu_torch.eval import lstm_step_test as LE
    from vla_touch_tpu_torch.models.controllers import bridge as BR
    from vla_touch_tpu_torch.models.controllers import interpolants as SI
    from vla_touch_tpu_torch.models.controllers import lstm as L
    from vla_touch_tpu_torch.models.encoders import dinov2_runtime as dino
    from vla_touch_tpu_torch.train import bridge_train as BT
    from vla_touch_tpu_torch.train import lstm_train as LT
    from vla_touch_tpu_torch.utils.normalization import normalize_actions

    out_dir = os.path.join(ROOT, "build", "controllers")
    shutil.rmtree(out_dir, ignore_errors=True)
    res = {"launches": {}}
    counts = {"K1": 0, "K2": 0}
    bcfg = BridgeControllerConfig(horizon=CTRL_HORIZON)
    btc = BridgeTrainConfig(horizon=CTRL_HORIZON, learning_rate=CTRL_LR)
    lcfg, ltc = LSTMControllerConfig(), LSTMTrainConfig(horizon=CTRL_HORIZON,
                                                         learning_rate=CTRL_LR)
    data = MemoryEpisodes(btc.batch_size * CTRL_STEPS, CTRL_HORIZON, seed=11)
    val = MemoryEpisodes(2 * CTRL_EVAL_SAMPLES, CTRL_HORIZON, seed=12)
    dm = type("DM", (), dict(train_dataset=data, val_dataset=val))()

    def run_counted(name, fn, need):
        zero_counts()
        r = fn()
        got = read_counts()
        check_counts(name, got, need)
        for k in counts:
            counts[k] += got[k]
        return r

    # ---- training
    log("controllers: BRIDGeR (down_dims (256, 512, 512), hidden 256, force + DinoV2-small "
        f"pair at 384^2) and LSTM (hidden 256, 2 layers, dropout 0.1), horizon {CTRL_HORIZON}")
    torch.cuda.reset_peak_memory_stats()
    # PyTorch's defaults (cuDNN's convolutions may take TF32): the trainers
    # must set the precision they run in themselves
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    bt = BT.DiffusionControllerTrainer(bcfg, btc, os.path.join(out_dir, "bridge"), data.stats,
                                       seed=0)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the BRIDGeR trainer left TF32 on")
    dino_layers = dino.config_for(bcfg.image_model).num_layers
    tr = run_counted("BRIDGeR training", lambda: train_loop(bt, data, CTRL_STEPS, CTRL_LR, False),
                     {"K1": 2 * dino_layers * CTRL_STEPS})
    b_mem = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cudnn.allow_tf32 = True
    lt = LT.LSTMControllerTrainer(lcfg, ltc, os.path.join(out_dir, "lstm"), data.stats,
                                  image_encoder=bt.img, seed=0)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the LSTM trainer left TF32 on")
    lstm_data = MemoryEpisodes(ltc.batch_size * CTRL_STEPS, CTRL_HORIZON, seed=13)
    tl = run_counted("LSTM training", lambda: train_loop(lt, lstm_data, CTRL_STEPS, CTRL_LR, True),
                     {"K1": 2 * dino_layers * CTRL_STEPS})
    l_mem = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, r, bs, mem in (("bridger", tr, btc.batch_size, b_mem),
                             ("lstm", tl, ltc.batch_size, l_mem)):
        fall = loss_fall(r["losses"])
        ms = float(np.median(r["step_ms"][CTRL_WARMUP:]))
        share = float(np.median(np.array(r["dino_ms"][CTRL_WARMUP:])
                                / np.array(r["step_ms"][CTRL_WARMUP:])))
        res[name] = dict(batch=bs, loss_first=r["losses"][0], loss_last=r["losses"][-1],
                         loss_fall=fall, step_ms_p50=ms, samples_per_s=bs * 1e3 / ms,
                         dinov2_share=share, dinov2_ms_p50=float(np.median(
                             r["dino_ms"][CTRL_WARMUP:])), peak_mem_gib=mem)
        log(f"{name} training: losses {[round(x, 4) for x in r['losses']]}")
        log(f"{name} training: " + json.dumps(res[name]))
        if not fall >= CTRL_FALL_MIN[name]:
            raise AssertionError(f"{name}: the loss fell by {fall:.3f} of its start, "
                                 f"need {CTRL_FALL_MIN[name]}")

    # ---- one prepare_batch of each trainer at its own batch size, every K1
    # call (DinoV2 at B 128 and 256 per camera) held to its plain version
    for name, trainer, d in (("BRIDGeR", bt, data), ("LSTM", lt, lstm_data)):
        b = next(d.batches(trainer.tcfg.batch_size, np.random.default_rng(7)))
        check_chk(f"{name} prepare_batch B {trainer.tcfg.batch_size} checked",
                  checked_run(lambda: trainer.prepare_batch(b)), {"K1": 2 * dino_layers})

    # ---- one step on the card against the CPU
    batch = next(data.batches(CTRL_CHECK_ROWS, np.random.default_rng(5)))
    prep = bt.prepare_batch(batch)
    g = torch.Generator().manual_seed(3)
    draws = SI.training_draws(CTRL_CHECK_ROWS, prep["expert_act"].shape, "cpu", g)
    res["bridger"]["card_vs_cpu"] = step_vs_cpu(
        "BRIDGeR", bt.state.module,
        lambda m, b, d: BR.bridge_train_loss(bcfg, m, b, {k: v.to(b["state"].device)
                                                          for k, v in d.items()})[0],
        prep, draws)
    lprep = lt.prepare_batch(next(lstm_data.batches(CTRL_CHECK_ROWS, np.random.default_rng(6))))
    keep = {"keep": LT.dropout_keep(lcfg, {"vla_act": lprep["vla_act"].cpu()}, g)}
    res["lstm"]["card_vs_cpu"] = step_vs_cpu(
        "LSTM", lt.state.module,
        lambda m, b, d: LT._loss_with_obs(lcfg, m, b, d["keep"].to(b["state"].device)),
        lprep, keep)

    # ---- checkpoints: the port's msgpack writer and reader, bit for bit
    ck = os.path.join(out_dir, "bridge", "final")
    t0 = time.perf_counter()
    bt._save(ck)
    back = BR.load_bridge_controller(ck)
    img = dino.load_params(ck, bcfg.image_model, dtype=bt.img.vit.pos_embed.dtype)
    check_round_trip("BRIDGeR params", dict(back.module.state_dict()),
                     dict(bt.state.module.state_dict()))
    check_round_trip("BRIDGeR EMA", back.ema.shadow, bt.state.ema.shadow)
    check_round_trip("DinoV2", dict(img.state_dict()), dict(bt.img.state_dict()))
    if int(back.ema.num_updates) != int(bt.state.ema.num_updates):
        raise AssertionError("BRIDGeR EMA counter differs after the round trip")
    lck = os.path.join(out_dir, "lstm", "final")
    lt._save(lck)
    check_round_trip("LSTM params", dict(L.load_lstm_controller(lck).module.state_dict()),
                     dict(lt.state.module.state_dict()))
    mb = sum(os.path.getsize(os.path.join(d, f)) for d in (ck, lck) for f in os.listdir(d))
    res["checkpoints"] = dict(bytes=mb, save_load_s=time.perf_counter() - t0,
                              ema_updates=int(back.ema.num_updates))
    log("checkpoints round-trip bit for bit: " + json.dumps(res["checkpoints"]))
    del back, img

    # ---- evaluation: launch counts, then every K1/K2 call held to its plain version
    import dataclasses

    blocks = 4 * len(bcfg.unet_down_dims)
    need_b = {"K1": 2 * dino_layers,
              "K2": blocks * bcfg.interpolant.diffusion_steps}
    sde_cfg = {sde: dataclasses.replace(bcfg, inference_dtype="bfloat16",
                                        interpolant=dataclasses.replace(bcfg.interpolant,
                                                                        sde_type=sde))
               for sde in ("vs", "bs")}
    for sde in ("vs", "bs"):
        def ev(sde=sde):
            return BE.test_diffusion_controller(
                ck, None, CTRL_EVAL_SAMPLES, state=dataclasses.replace(bt.state, cfg=sde_cfg[sde]),
                data_module=dm, image_encoder=bt.img)
        res[f"bridge_test_{sde}"] = run_counted(f"bridge_test {sde}", ev, need_b)
        check_chk(f"bridge_test {sde} checked", checked_run(ev), need_b)

    def lev():
        return LE.test_lstm_controller(lck, None, CTRL_EVAL_SAMPLES, CTRL_HORIZON,
                                       state=lt.state, data_module=dm, image_encoder=bt.img)

    res["lstm_step_test"] = run_counted("lstm_step_test", lev, {"K1": 2 * dino_layers})
    check_chk("lstm_step_test checked", checked_run(lev), {"K1": 2 * dino_layers})

    # the LSTM's step-by-step rollout against its sequence mode
    eb = BE.eval_batch(val, CTRL_EVAL_SAMPLES, 0)
    dev = torch.device("cuda")
    f1, f2 = (dino.encode_images(bt.img, torch.as_tensor(eb[f"images_cam{c}"][:, -1],
                                                         device=dev)) for c in (1, 2))
    lm = lt.state.module.eval()
    with torch.no_grad():
        obs = lm.encode_obs(torch.as_tensor(eb["states"][:, 1], device=dev), f1, f2)
        vla = torch.as_tensor(eb["vla_actions"], device=dev)
        force = torch.as_tensor(eb["forces"][:, 1:1 + CTRL_HORIZON], device=dev)
        stepwise = L.lstm_predict_sequence(lcfg, lm, lt.state.stats, obs, vla, force)
        seq = lm(obs, normalize_actions(vla, lt.state.stats, "vla"), force)
        stepwise_n = normalize_actions(stepwise, lt.state.stats, "expert")
    err = float((stepwise_n - seq).abs().max())
    res["lstm_step_vs_sequence"] = dict(max_abs_err=err, max_abs=float(seq.abs().max()))
    log("LSTM step-by-step rollout vs sequence mode: " + json.dumps(res["lstm_step_vs_sequence"]))
    if not err <= LSTM_SEQ_TOL * float(seq.abs().max()):
        raise AssertionError(f"LSTM step-by-step rollout differs from its sequence mode: {err}")

    # ---- refine ms (B = CTRL_EVAL_SAMPLES, 10 SDE steps, bf16 K2) per SDE
    state = torch.as_tensor(eb["states"][:, 1], device=dev)
    forces = torch.as_tensor(eb["forces"][:, 1], device=dev)
    for sde in ("vs", "bs"):
        cfg = sde_cfg[sde]
        mod = BR.deployable(dataclasses.replace(bt.state, cfg=cfg))
        stacked = BR.stacked_vs(mod) if sde == "vs" else BR.stacked_bs(mod)
        gen = torch.Generator(device=dev).manual_seed(0)

        def refine():
            return BR.bridge_predict(cfg, mod, bt.state.stats, state, vla, f1, f2, forces,
                                     stacked=stacked, generator=gen)

        refine()
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            refine()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        res[f"refine_{sde}_ms_p50"] = float(np.median(ms))
    log(f"BRIDGeR refine at B {CTRL_EVAL_SAMPLES}, horizon {CTRL_HORIZON}, 10 steps: "
        f"'vs' {res['refine_vs_ms_p50']:.2f} ms, 'bs' {res['refine_bs_ms_p50']:.2f} ms p50")
    res["launches"] = counts
    shutil.rmtree(out_dir, ignore_errors=True)
    return res


# ---- RDT finetuning -------------------------------------------------------------

# trainer steps of the main path (24 until the orbax resume joined the
# phase; the loss plateaus from step 8)
RDT_STEPS = 8
RDT_DEPTH = 8                      # RDT-1B blocks of the main path (full width)
RDT_LANG_LEN = 32                  # instruction tokens of the synthetic episodes
RDT_EPISODES, RDT_EP_STEPS = 3, 48
RDT_SEED = 0
# The main path's loss fall on a fixed probe batch (fixed noise and
# timesteps): (probe loss before - after RDT_STEPS steps) / before, at least
# RDT_FALL_MIN.  On an H100 a sound run reads 0.971; the planted faults of
# tools/torch_rdt_train_fault_control.py, the optimizer's updates zeroed and
# the learning rate 0, read 0.0 and 0.0.
RDT_FALL_MIN = 0.5
# bf16 parity of one RDT loss + gradient, the tolerances of
# tests/test_torch_rdt_train.py (the port against JAX at rdt_tiny in bf16,
# where the measured spread and a wrong cast map's readings are stated):
# the loss's relative error, each gradient leaf's max abs error over its
# max |grad|, and the whole gradient's relative L2 error.  Here: the card's
# step against the CPU's (an H100 reads 0, 4.3e-3 and 2.0e-3).
RDT_LOSS_RTOL_BF16 = 2e-4
RDT_GRAD_LEAF_TOL_BF16 = 5e-2
RDT_GRAD_L2_TOL_BF16 = 6e-3
# K1's autograd Function against attention_plain's autograd on the card:
# each of dq, dk, dv's max abs error over its max |plain grad| (the
# backward is the plain program recomputed: equal but for reduction order)
RDT_K1_GRAD_TOL = 1e-3
# (name, B, Lq, Lkv, H, D, layout, mask kind): the RDT training attentions
K1_GRAD_SHAPES = [("rdt_train_self", 4, 67, 67, 32, 64, "self", None),
                  ("rdt_train_image_cross", 4, 67, 4374, 32, 64, "cross", None),
                  ("rdt_train_lang_cross", 4, 67, 1024, 32, 64, "cross", "short")]


def rdt_k1_need(m, tcfg, siglip_layers: int, steps: int = 5) -> dict:
    """K1 launches of one training step (SigLIP, then two attentions a block
    in each micro-batch's forward, twice with remat) and of one
    ``sample_metrics`` (two a block at each of ``steps`` solver steps)."""
    per_micro = 2 * m.depth * (2 if m.remat_blocks else 1)
    return {"step": siglip_layers + tcfg.grad_accum * per_micro,
            "sample": steps * 2 * m.depth}


def rdt_tflop(m, samples: int, lang_len: int, vcfg, frames: int) -> dict:
    """Model TFLOP of one training step from the shapes (2 per multiply-add;
    attention 4 B H Lq Lkv D): the RDT forward over ``samples`` samples
    times 3 (forward and a backward of twice its work), and SigLIP's
    forward over ``frames`` frames."""
    H, x = m.hidden_size, m.horizon + 3

    def lin(rows, k, n):
        return 2.0 * rows * k * n

    fwd = (lin(m.horizon + 1, 2 * m.state_token_dim, H) + 2 * lin(m.horizon + 1, H, H)
           + lin(lang_len, m.lang_token_dim, H) + lin(lang_len, H, H)
           + lin(m.img_cond_len, m.img_token_dim, H) + lin(m.img_cond_len, H, H)
           + 2 * (lin(1, 256, H) + lin(1, H, H)))
    for i in range(m.depth):
        L = lang_len if i % 2 == 0 else m.img_cond_len
        fwd += (lin(x, H, 3 * H) + 4.0 * x * x * H + lin(x, H, H)          # self-attention
                + lin(x, H, H) + lin(L, H, 2 * H) + 4.0 * x * L * H + lin(x, H, H)
                + 2 * lin(x, H, H))                                          # cross, MLP
    fwd += lin(x, H, H) + lin(x, H, m.output_dim)
    D, n = vcfg.hidden_size, (vcfg.image_size // vcfg.patch_size) ** 2
    sig = lin(n, vcfg.patch_size ** 2 * 3, D) + vcfg.num_layers * (
        lin(n, D, 3 * D) + 4.0 * n * n * D + lin(n, D, D) + 2 * lin(n, D, vcfg.mlp_dim))
    return {"rdt": 3 * samples * fwd / 1e12, "siglip": frames * sig / 1e12}


def rdt_episodes(root: str) -> list:
    from vla_touch_tpu_torch.data.episode import make_synthetic_dataset

    return make_synthetic_dataset(root, n_episodes=RDT_EPISODES, num_steps=RDT_EP_STEPS,
                                  img_size=384, chunk=64, lang_len=RDT_LANG_LEN,
                                  with_vla=False)


def rdt_configs(depth=RDT_DEPTH, **train_kw):
    """RDT-1B at ``depth`` blocks, the JAX package's default recipe
    (f32 master, AdamW, batch 4 x accumulation 4, f32 accumulator and EMA,
    lr 1e-4) without the 500-step warm-up (it would hold the rate at or
    under 24/500 of 1e-4 for the whole run), one sampling eval and no
    checkpoint before the final one; the data as the JAX default (no image
    augmentation) on 384^2 frames."""
    from vla_touch_tpu_torch.config import (DataConfig, NoiseSchedulerConfig, TrainConfig,
                                            rdt_1b)
    from vla_touch_tpu_torch.models.rdt import runner as R

    m = rdt_1b(depth=depth)
    rcfg = R.RDTRunnerConfig(model=m, noise=NoiseSchedulerConfig())
    tcfg = TrainConfig(**dict(dict(lr_warmup_steps=0, max_train_steps=RDT_STEPS,
                                   sample_period=RDT_STEPS, checkpointing_period=10 ** 9,
                                   checkpoints_total_limit=2, seed=RDT_SEED), **train_kw))
    dcfg = DataConfig(chunk_size=m.horizon, image_size=384, image_aug=False)
    return rcfg, tcfg, dcfg


def rdt_probe(trainer, vision, files, seed: int = 99) -> dict:
    """A fixed batch (a dataset of its own seed) through SigLIP, with fixed
    noise and timesteps, shaped for ``train_step``."""
    import torch

    from vla_touch_tpu_torch.data.consumer import VLAConsumerDataset, collate
    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.train import rdt_loop as RL

    tcfg, rcfg = trainer.tcfg, trainer.rcfg
    ds = VLAConsumerDataset(trainer.dcfg, seed=seed, file_paths=files)
    batch = collate([ds.sample() for _ in range(tcfg.batch_size * tcfg.grad_accum)],
                    max_lang_len=rcfg.model.max_lang_cond_len)
    flat = RL.device_batch(batch, "cuda")
    img = RL.encode_images(vision, flat.pop("images"), flat.pop("image_mask"))
    shape = (tcfg.grad_accum, -1)
    dev = {k: v.reshape(shape + tuple(v.shape[1:])) for k, v in flat.items()
           if k != "state_norm"}
    dev["img_tokens"] = img.reshape(shape + tuple(img.shape[1:]))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draws = R.loss_draws(rcfg, (tcfg.grad_accum * tcfg.batch_size,)
                         + tuple(dev["action_gt"].shape[2:]), "cuda", gen)
    return dict(batch=batch, dev=dev, flat=flat, img=img,
                noise=draws["noise"].reshape(dev["action_gt"].shape),
                timesteps=draws["timesteps"].reshape(dev["action_gt"].shape[:2]))


def rdt_probe_loss(rcfg, module, probe) -> float:
    import torch

    from vla_touch_tpu_torch.models.rdt import runner as R

    dev = probe["dev"]
    with torch.no_grad():
        losses = [float(R.rdt_compute_loss(rcfg, module, {k: v[i] for k, v in dev.items()},
                                           noise=probe["noise"][i],
                                           timesteps=probe["timesteps"][i]))
                  for i in range(dev["action_gt"].shape[0])]
    return float(np.mean(losses))


def rdt_fall_run(vision, files, out_dir, learning_rate=None, skip_step=False) -> dict:
    """The main path's training run alone (tools/torch_rdt_train_fault_control.py):
    the probe loss before and after RDT_STEPS steps of a fresh RDT-1B, with
    the learning rate replaced or the optimizer's update zeroed."""
    import torch

    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.train import rdt_loop as RL
    from vla_touch_tpu_torch.train.optim import RDTOptimizer

    kw = {} if learning_rate is None else dict(learning_rate=learning_rate)
    rcfg, tcfg, dcfg = rdt_configs(**kw)
    trainer = RL.RDTTrainer(rcfg, tcfg, dcfg, out_dir)
    # the controls read the probe only: no final checkpoint
    trainer.save_checkpoint = lambda state, step: {}
    module = R.init_rdt_train(rcfg, RDT_SEED, "cuda")
    probe = rdt_probe(trainer, vision, files)
    before = rdt_probe_loss(rcfg, module, probe)
    update = RDTOptimizer.update
    if skip_step:
        def zero(self, grads, state, params, g_norm=None):
            u, new = update(self, grads, state, params, g_norm)
            return {n: torch.zeros_like(v) for n, v in u.items()}, new
        RDTOptimizer.update = zero
    try:
        state = trainer.train(file_paths=files, resume_from=None, vision=vision,
                              init_module=module)
    finally:
        RDTOptimizer.update = update
    after = rdt_probe_loss(rcfg, state.module, probe)
    return dict(probe_before=before, probe_after=after, fall=(before - after) / before)


def k1_grad_check(gen, shapes=None) -> list:
    """K1's autograd Function against attention_plain's autograd on the
    card at ``shapes`` (default the RDT training shapes; q, k, v as the modules lay them out,
    requiring grad; a random cotangent), and the guard: a direct wrapper
    call with grad-requiring operands raises, the attention entry returns
    an output with a grad_fn."""
    import torch

    from vla_touch_tpu_torch.ops import attention as A
    from vla_touch_tpu_torch.ops import flash_attention as FA

    rows = []
    for name, B, Lq, Lkv, H, D, layout, mask_kind in shapes or K1_GRAD_SHAPES:
        ops = [t.detach().clone().requires_grad_(True)
               for t in k1_operands(gen, B, Lq, Lkv, H, D, layout)]
        mask = k1_mask(B, Lq, Lkv, H, mask_kind)
        cot = torch.randn((B, Lq, H, D), generator=gen, device="cuda")
        out = A.dot_product_attention(*ops, kv_mask=mask)
        if out.grad_fn is None:
            raise AssertionError(f"K1 {name}: the attention output has no grad_fn")
        got = torch.autograd.grad((out.float() * cot).sum(), ops)
        want = torch.autograd.grad(
            (FA.attention_plain(*ops, kv_mask=mask).float() * cot).sum(), ops)
        share = {}
        for what, g, w in zip("qkv", got, want):
            share[f"d{what}"] = float((g.float() - w.float()).abs().max()) / (
                RDT_K1_GRAD_TOL * float(w.float().abs().max()))
        try:
            FA.flash_attention(*ops, kv_mask=mask)
            raised = False
        except RuntimeError:
            raised = True
        rows.append(dict(shape=name, B=B, Lkv=Lkv, share_of_tol=share,
                         direct_call_raises=raised))
        log(f"K1 {name} autograd: grads' error as a share of {RDT_K1_GRAD_TOL} x max|plain "
            f"grad| {json.dumps(share)}; a direct grad-requiring call raises: {raised}")
        if not raised or max(share.values()) > 1.0 or not all(
                np.isfinite(v) for v in share.values()):
            raise AssertionError(f"K1 {name}: the autograd route fails its check")
    return rows


def rdt_grad_compare(what, got: dict, want: dict, loss_got: float, loss_want: float) -> dict:
    """The bf16 parity measures of a loss + gradient against another."""
    import torch

    leaf = max(float((got[n].float() - w.float()).abs().max()) / max(
        float(w.float().abs().max()), 1e-30) for n, w in want.items())
    num = sum(float(torch.sum(torch.square(got[n].double() - w.double()))) for n, w in want.items())
    den = sum(float(torch.sum(torch.square(w.double()))) for w in want.values())
    res = dict(loss_rel_err=abs(loss_got - loss_want) / abs(loss_want), grad_leaf_max=leaf,
               grad_l2_rel=(num / den) ** 0.5, leaves=len(want))
    log(f"{what}: " + json.dumps(res) + f" (tolerances: loss {RDT_LOSS_RTOL_BF16}, leaf "
        f"{RDT_GRAD_LEAF_TOL_BF16}, L2 {RDT_GRAD_L2_TOL_BF16})")
    return res


def rdt_step_vs_cpu(vision, files) -> dict:
    """One loss + gradient of a depth-2 RDT-1B (full width, batch 1,
    accumulation 1) on the card and on the CPU: the same float32 master
    weights, batch, SigLIP tokens, noise and timesteps."""
    import copy

    import torch

    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.train import rdt_loop as RL

    rcfg, tcfg, dcfg = rdt_configs(depth=2, batch_size=1, grad_accum=1)
    trainer = RL.RDTTrainer(rcfg, tcfg, dcfg, os.path.join(ROOT, "build", "rdt_train",
                                                           "d2"))
    module = R.init_rdt_train(rcfg, RDT_SEED + 5, "cuda")
    probe = rdt_probe(trainer, vision, files, seed=7)
    mb = {k: v[0] for k, v in probe["dev"].items()}
    noise, ts = probe["noise"][0], probe["timesteps"][0]
    cpu = copy.deepcopy(module).cpu()
    names = [n for n, _ in module.named_parameters()]
    loss = R.rdt_compute_loss(rcfg, module, mb, noise=noise, timesteps=ts)
    grads = torch.autograd.grad(loss, list(module.parameters()))
    t0 = time.perf_counter()
    loss_c = R.rdt_compute_loss(rcfg, cpu, {k: v.cpu() for k, v in mb.items()},
                                noise=noise.cpu(), timesteps=ts.cpu())
    grads_c = torch.autograd.grad(loss_c, list(cpu.parameters()))
    cpu_s = time.perf_counter() - t0
    res = rdt_grad_compare("RDT-1B depth 2 card step vs CPU step",
                           {n: g.cpu() for n, g in zip(names, grads)}, dict(zip(names, grads_c)),
                           float(loss.detach()), float(loss_c.detach()))
    res["cpu_s"] = cpu_s
    log(f"  the CPU side took {cpu_s:.1f} s")
    if not (res["loss_rel_err"] <= RDT_LOSS_RTOL_BF16
            and res["grad_leaf_max"] <= RDT_GRAD_LEAF_TOL_BF16
            and res["grad_l2_rel"] <= RDT_GRAD_L2_TOL_BF16):
        raise AssertionError(f"RDT card step disagrees with the CPU step: {res}")
    return res


def rdt_recipes_check(vision, files) -> dict:
    """The options the main path leaves off, at depth 2 (full width, batch 1
    x accumulation 2): ``remat_blocks`` (the same loss and gradients bit for
    bit; K1 launched twice a block a micro-batch) and the bf16 recipe (8-bit
    AdamW, bf16 parameters, accumulator and EMA: one step finite, the state
    in its dtypes)."""
    import dataclasses

    import torch

    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.ops import flash_attention as FA
    from vla_touch_tpu_torch.train import rdt_loop as RL
    from vla_touch_tpu_torch.train import rdt_train as T

    rcfg, tcfg, dcfg = rdt_configs(depth=2, batch_size=1, grad_accum=2)
    trainer = RL.RDTTrainer(rcfg, tcfg, dcfg, os.path.join(ROOT, "build", "rdt_train",
                                                           "recipes"))
    probe = rdt_probe(trainer, vision, files, seed=11)
    mb = {k: v[0] for k, v in probe["dev"].items()}
    module = R.init_rdt_train(rcfg, RDT_SEED + 7, "cuda")
    out = {}
    for remat in (False, True):
        module.model.cfg = dataclasses.replace(rcfg.model, remat_blocks=remat)
        k = FA.flash_attention.launches
        loss = R.rdt_compute_loss(rcfg, module, mb, noise=probe["noise"][0],
                                  timesteps=probe["timesteps"][0])
        grads = torch.autograd.grad(loss, list(module.parameters()))
        out[remat] = (loss.detach(), grads, FA.flash_attention.launches - k)
    module.model.cfg = rcfg.model
    need = {r: rdt_k1_need(dataclasses.replace(rcfg.model, remat_blocks=r),
                           dataclasses.replace(tcfg, grad_accum=1), 0)["step"]
            for r in (False, True)}
    same = torch.equal(out[False][0], out[True][0]) and all(
        torch.equal(a, b) for a, b in zip(out[False][1], out[True][1]))
    res = dict(remat_k1={str(r): out[r][2] for r in out},
               remat_k1_need={str(r): need[r] for r in need}, remat_equal=same)
    if not same or any(out[r][2] != need[r] for r in out):
        raise AssertionError(f"rdt remat_blocks: {res}")
    del out
    bf = dataclasses.replace(tcfg, use_8bit_adam=True, param_dtype="bfloat16",
                             accum_dtype="bfloat16", ema_dtype="bfloat16")
    state = T.init_train_state(rcfg, bf, module=module)
    state, metrics = T.train_step(rcfg, bf, state, probe["dev"],
                                  generator=torch.Generator(device="cuda").manual_seed(5))
    ok = (np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
          and all(p.dtype == torch.bfloat16 and bool(torch.isfinite(p).all())
                  for p in state.params.values())
          and all(q.dtype == torch.int8 for q in state.opt_state.m_q.values())
          and all(e.dtype == torch.bfloat16 for e in state.ema.shadow.values()))
    res.update(bf16_recipe_loss=float(metrics["loss"]),
               bf16_recipe_grad_norm=float(metrics["grad_norm"]), bf16_recipe_ok=ok)
    log("rdt recipes at depth 2: " + json.dumps(res))
    if not ok:
        raise AssertionError(f"rdt bf16 recipe: {res}")
    return res


def trees_equal(a, b, where: str):
    """Trees ``a`` and ``b`` (tensors on the card or the host, numpy
    arrays) equal leaf for leaf, bit for bit and dtype; keys compared as
    strings.  A pair with a card side is compared on the card (the host
    side copied there)."""
    import torch

    if isinstance(b, dict):
        if set(map(str, a)) != set(map(str, b)):
            raise AssertionError(f"{where}: keys differ")
        for k in b:
            trees_equal(a[str(k)], b[k], f"{where}/{k}")
        return
    got, want = (x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
                 for x in (a, b))
    dev = got.device if got.is_cuda else want.device
    if got.dtype != want.dtype or not torch.equal(got.to(dev), want.to(dev)):
        raise AssertionError(f"{where}: trees differ")


def rdt_round_trip(path: str, trees: dict):
    """Every leaf of the checkpoint at ``path`` equal, bit for bit and
    dtype, to the state's own tree."""
    from vla_touch_tpu_torch.utils import checkpoint as ckpt

    for k in ("params", "ema", "opt_state"):
        trees_equal(ckpt.load_pytree(os.path.join(path, f"{k}.msgpack")), trees[k], k)
    meta = ckpt.load_json(os.path.join(path, "meta.json"))
    if meta != trees["meta"]:
        raise AssertionError(f"meta.json {meta} != {trees['meta']}")


ORBAX_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "orbax_2proc")


def orbax_fixture_check() -> dict:
    """JAX's bytes on this host: the committed two-process orbax checkpoint
    (``tests/make_orbax_fixture.py``) read by the port's reader, every leaf
    held against the committed npz of JAX's restore, bit for bit."""
    from vla_touch_tpu_torch.utils import checkpoint as ckpt

    t0 = time.perf_counter()
    tree = ckpt.load_pytree_orbax(os.path.join(ORBAX_FIXTURE, "checkpoint-1", "state.orbax"))
    read_s = time.perf_counter() - t0
    with np.load(os.path.join(ORBAX_FIXTURE, "expected.npz")) as z:
        want = {k: z[k] for k in z.files}
    got = {}

    def flat(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                flat(v, f"{prefix}{k}/")
            elif v is not None:
                got[f"{prefix}{k}"] = v

    flat(tree, "")
    if set(got) != set(want):
        raise AssertionError(f"orbax fixture: leaves differ: {sorted(set(got) ^ set(want))[:8]}")
    for k in want:
        trees_equal(got[k], want[k], f"orbax fixture {k}")
    log(f"orbax fixture: {len(want)} leaves of JAX's two-process checkpoint read bit for bit "
        f"in {read_s:.3f} s")
    return dict(leaves=len(want), read_s=read_s)


def rdt_orbax_resume(trainer, state, root: str) -> dict:
    """The full-width state through orbax: the host trees of
    ``rdt_train_state_to_flax`` written as ``checkpoint-N/state.orbax`` +
    ``meta.json`` (``save_pytree_orbax``), the state's own tensors zeroed,
    then resumed in place through ``trainer.load_checkpoint`` (no second
    state on the card) and every parameter, EMA and optimizer tensor held
    against the written trees bit for bit.  Returns bytes and seconds."""
    import shutil

    import torch

    from vla_touch_tpu_torch.train import rdt_loop as RL
    from vla_touch_tpu_torch.utils import checkpoint as ckpt
    from vla_touch_tpu_torch.utils import from_flax as FF
    from vla_touch_tpu_torch.utils import zstd

    trees = FF.rdt_train_state_to_flax(state, trainer.optimizer)
    t0 = time.perf_counter()
    host = {k: RL._to_host(trees[k]) for k in ("params", "ema", "opt_state")}
    snapshot_s = time.perf_counter() - t0
    meta = dict(trees["meta"])
    del trees
    path = os.path.join(root, "orbax", f"checkpoint-{meta['step']}")
    t0 = time.perf_counter()
    nbytes = ckpt.save_pytree_orbax(os.path.join(path, "state.orbax"), host)
    ckpt.save_json(os.path.join(path, "meta.json"), meta)
    write_s = time.perf_counter() - t0
    with torch.no_grad():
        for p in state.module.parameters():
            p.zero_()
        for t in state.ema.shadow.values():
            t.zero_()
        for name in ("mu", "nu", "m_q", "m_s", "v_q", "v_s"):
            for t in getattr(state.opt_state, name, {}).values():
                t.zero_()
    step = state.step
    state.step = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = trainer.load_checkpoint(state, path)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    if back is not state or state.step != step:
        raise AssertionError("orbax resume: not the phase's state, or the step differs")
    t0 = time.perf_counter()
    got = FF.rdt_train_state_to_flax(state, trainer.optimizer)
    for k in ("params", "ema", "opt_state"):
        trees_equal(got[k], host[k], f"orbax resume {k}")
    if got["meta"] != meta:
        raise AssertionError(f"orbax resume: meta {got['meta']} != {meta}")
    compare_s = time.perf_counter() - t0
    del got, host
    shutil.rmtree(os.path.join(root, "orbax"))
    out = dict(bytes=nbytes, snapshot_s=snapshot_s, write_s=write_s, load_checkpoint_s=read_s,
               compare_s=compare_s, zstd_version=zstd.version_number(),
               zstd_library=zstd.find_library())
    log(f"rdt orbax: {json.dumps(out)}; resumed in place bit for bit")
    return out


def rdt_train_phase() -> dict:
    """Finetune RDT-1B at full width (RDT_DEPTH blocks) through
    ``RDTTrainer.train`` on seeded
    synthetic npz episodes (batch 4 x accumulation 4, SigLIP So400m on the
    16 x 6 frames of a step): K1's autograd route checked at the training
    shapes, one depth-2 step on the card against the CPU, the main path
    (RDT_STEPS steps, one sampling eval, the final checkpoint) with K1's
    launches asserted a step, the probe's loss fall gated, the checkpoint
    read back bit for bit, one step as a checked run; step ms, samples/s,
    TFLOP/s, SigLIP's share, the optimizer's ms, the checkpoint's bytes and
    seconds, the peak memory."""
    import gc
    import shutil

    import torch

    from vla_touch_tpu_torch.models.encoders.vit import (SIGLIP_SO400M,
                                                         SiglipVisionEncoder, init_vit)
    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.ops import flash_attention as FA
    from vla_touch_tpu_torch.train import rdt_loop as RL
    from vla_touch_tpu_torch.utils import from_flax as FF

    root = os.path.join(ROOT, "build", "rdt_train")
    shutil.rmtree(root, ignore_errors=True)
    res = {}
    try:
        t0 = time.perf_counter()
        files = rdt_episodes(os.path.join(root, "episodes"))
        log(f"rdt: {len(files)} npz episodes written in {time.perf_counter() - t0:.1f} s")
        gen = torch.Generator(device="cuda").manual_seed(4321)
        res["k1_autograd"] = k1_grad_check(gen)
        vision = init_vit(SiglipVisionEncoder, SIGLIP_SO400M, RDT_SEED + 1, "cuda")
        res["step_vs_cpu"] = rdt_step_vs_cpu(vision, files)
        res["recipes"] = rdt_recipes_check(vision, files)
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the main path
        rcfg, tcfg, dcfg = rdt_configs()
        m = rcfg.model
        trainer = RL.RDTTrainer(rcfg, tcfg, dcfg, os.path.join(root, "out"))
        module = R.init_rdt_train(rcfg, RDT_SEED, "cuda")
        probe = rdt_probe(trainer, vision, files)
        before = rdt_probe_loss(rcfg, module, probe)
        need = rdt_k1_need(m, tcfg, SIGLIP_SO400M.num_layers)
        marks, step_k1, losses = [], [], []

        def on_step(step, state, metrics):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            step_k1.append(FA.flash_attention.launches)
            losses.append(float(metrics["loss"]))

        saves, samples = [], []
        save, sample = trainer.save_checkpoint, RL.sample_metrics

        def timed_save(state, step):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sizes = save(state, step)
            saves.append(dict(bytes=sizes, s=time.perf_counter() - t1))
            return sizes

        def timed_sample(*a, **kw):
            torch.cuda.synchronize()
            k = FA.flash_attention.launches
            t1 = time.perf_counter()
            out = sample(*a, **kw)
            samples.append(dict(out, ms=1e3 * (time.perf_counter() - t1),
                                k1=FA.flash_attention.launches - k))
            return out

        trainer.save_checkpoint, RL.sample_metrics = timed_save, timed_sample
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t_run = time.perf_counter()
        try:
            state = trainer.train(file_paths=files, resume_from=None, vision=vision,
                                  init_module=module, on_step=on_step)
        finally:
            RL.sample_metrics = sample
        run_s = time.perf_counter() - t_run
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        per_step = np.diff([0] + step_k1).tolist()
        want = {"K1": RDT_STEPS * need["step"] + need["sample"]}
        log(f"rdt main path: {RDT_STEPS} steps in {run_s:.1f} s; K1 a step {per_step} "
            f"(want {need['step']}), sample eval {samples[0]['k1'] if samples else None} "
            f"(want {need['sample']})")
        if any(k != need["step"] for k in per_step) or len(samples) != 1 \
                or samples[0]["k1"] != need["sample"]:
            raise AssertionError("rdt: K1 launches a step or a sampling eval are off")
        check_counts("rdt main path", counts, want)
        if not all(np.isfinite([samples[0]["sample_mse"], samples[0]["sample_l2err"]])):
            raise AssertionError(f"rdt: sample metrics not finite: {samples[0]}")
        after = rdt_probe_loss(rcfg, state.module, probe)
        fall = (before - after) / before
        log(f"rdt probe loss {before:.5f} -> {after:.5f}: fall {fall:.4f} "
            f"(min {RDT_FALL_MIN}); step losses {[round(x, 5) for x in losses]}")
        if not (np.isfinite(after) and fall >= RDT_FALL_MIN):
            raise AssertionError("rdt: the probe loss did not fall")

        # ---- the final checkpoint, read back
        path = os.path.join(root, "out", f"checkpoint-{RDT_STEPS}")
        t1 = time.perf_counter()
        rdt_round_trip(path, FF.rdt_train_state_to_flax(state, trainer.optimizer))
        read_s = time.perf_counter() - t1
        ck = dict(bytes=sum(saves[-1]["bytes"].values()), per_tree=saves[-1]["bytes"],
                  save_s=saves[-1]["s"], read_and_compare_s=read_s)
        log(f"rdt checkpoint: {json.dumps(ck)}; read back bit for bit")
        shutil.rmtree(path)

        # ---- the same state through orbax: JAX's bytes read, then the
        # full-width state written, resumed in place and checked
        res["orbax_fixture"] = orbax_fixture_check()
        gc.collect()
        res["orbax"] = orbax = rdt_orbax_resume(trainer, state, root)
        log(f"rdt checkpoint bytes / write s / read s: msgpack {ck['bytes']} / "
            f"{ck['save_s']:.2f} / {ck['read_and_compare_s']:.2f} (read + compare), orbax "
            f"{orbax['bytes']} / {orbax['write_s']:.2f} / {orbax['load_checkpoint_s']:.2f} "
            f"(load_checkpoint to the card; compare {orbax['compare_s']:.2f}); libzstd "
            f"{orbax['zstd_version']} ({orbax['zstd_library']})")

        # ---- one step as a checked run, from the state resumed from orbax
        ds_batch = probe["batch"]
        chk = checked_run(lambda: trainer.step(state, ds_batch, vision,
                                               torch.Generator(device="cuda").manual_seed(3)))
        check_chk("rdt checked step", chk, {"K1": need["step"]})

        # ---- times
        step_ms = 1e3 * np.diff(marks)
        p50 = float(np.median(step_ms))
        n = tcfg.batch_size * tcfg.grad_accum
        frames = n * dcfg.img_history_size * dcfg.num_cameras
        tf = rdt_tflop(m, n, m.max_lang_cond_len, SIGLIP_SO400M, frames)
        images = torch.as_tensor(ds_batch["images"], device="cuda")
        image_mask = torch.as_tensor(ds_batch["image_mask"], device="cuda")
        siglip_ms = cuda_time_ms(lambda: RL.encode_images(vision, images, image_mask),
                                 reps=3, warmup=1)
        grads = {k: torch.randn_like(p) * 1e-3 for k, p in state.params.items()}
        params = state.params

        def opt_step():
            u, _ = trainer.optimizer.update(grads, state.opt_state, params)
            torch._foreach_add(list(params.values()), list(u.values()))

        opt_ms = cuda_time_ms(opt_step, reps=3, warmup=1)
        del grads
        prof = profile_run(lambda: trainer.step(state, ds_batch, vision), top=15)
        log("rdt step profile: " + json.dumps(prof))
        res.update(
            steps=RDT_STEPS, step_ms=[round(x, 3) for x in step_ms.tolist()], step_ms_p50=p50,
            samples_per_s=n / (p50 / 1e3), tflop_per_step=tf, tflops=sum(tf.values()) / (p50 / 1e3),
            siglip_ms=siglip_ms, siglip_share=siglip_ms / p50, optimizer_ms=opt_ms,
            sample_eval=samples[0], checkpoint=ck, peak_gib=peak, profile=prof,
            probe_loss_before=before,
            probe_loss_after=after, loss_fall=fall, checked=chk, launches=counts,
            k1_need=need, run_s=run_s)
        log(f"rdt step p50 {p50:.1f} ms, {res['samples_per_s']:.2f} samples/s, "
            f"{res['tflops']:.1f} TFLOP/s of {sum(tf.values()):.2f} TFLOP a step "
            f"({json.dumps(tf)}), SigLIP {siglip_ms:.1f} ms ({100 * siglip_ms / p50:.1f} %), "
            f"optimizer {opt_ms:.1f} ms, sample eval {samples[0]['ms']:.1f} ms, "
            f"peak {peak:.2f} GiB")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return res


# ---- the encoders off the tick and the offline tools ------------------------------------

T5_SEED = 0
# instructions of 8 to 64 byte tokens (EOS included), and one of 1024 (T5_LONG)
T5_INSTRUCTIONS = ("wipe it",
                   "pick up the mango",
                   "pick up the ripe mango and put it into the bowl",
                   "press the soft sponge gently, then lift the arm back up")
T5_LONG = 1024
T5_POLICY_INSTRUCTION = 2          # the one whose embedding drives the tick
# The card's bf16 encoder against the port's float32 encoder on the CPU:
# T5-XXL at full width cut to T5_GATE_LAYERS layers, the same (bf16) weights
# and ids, an instruction of T5_GATE_TOKENS tokens (every bucket of the map).
# Gate: the hidden states' relative L2 error.  The CPU's own bf16 run of the
# same cut reads T5_CPU_BF16_REL over seeds 0-3, and bf16 with a planted
# fault (the bucket map shifted by one; the bias transposed to (L_k, L_q))
# T5_CPU_FAULT_REL (tools/torch_t5_bf16_gate.py): the gate sits 3.4 x above
# the first and 7.8 x below the second.
T5_GATE_LAYERS = 2
T5_GATE_TOKENS = 200
T5_REL_TOL = 2e-2
T5_CPU_BF16_REL = (5.90e-3, 5.98e-3)
T5_CPU_FAULT_REL = (0.155, 0.176)
T5_FAULTS = ("bucket_shift", "bias_transposed")
# Sparsh ViT-B/16 on 6-channel 240^2 frame pairs: 226 tokens with CLS
SPARSH_BATCH = 32
K1_SPARSH_SHAPES = [("sparsh_self", SPARSH_BATCH, 226, 226, 12, 64, "vit", None, 12)]
# the warm-replan protocol's rdt_tiny (eval/warm_quality.py; hidden 128, 4
# heads of 32, depth 2: block 0 crosses the 4 language tokens, all valid,
# block 1 the 24 image tokens; 11 query tokens): calls per training step at
# batch 64 (forward only: the backward is the plain program) and per cold
# chunk of 5 solver steps at 16 rows
K1_WARM_SHAPES = [
    ("warm_train_self", 64, 11, 11, 4, 32, "self", None, 2),
    ("warm_train_lang_cross", 64, 11, 4, 4, 32, "cross", "all", 1),
    ("warm_train_image_cross", 64, 11, 24, 4, 32, "cross", None, 1),
    ("warm_chunk_self", 16, 11, 11, 4, 32, "self", None, 10),
    ("warm_chunk_lang_cross", 16, 11, 4, 4, 32, "cross", "all", 5),
    ("warm_chunk_image_cross", 16, 11, 24, 4, 32, "cross", None, 5),
]
# GelSight force sequences: an episode of FORCE_T frames at the tick's size;
# the recovered displacement within FORCE_TOL px of the planted shift (the
# tracker tests' tolerance)
FORCE_T, FORCE_H, FORCE_W = 600, 240, 320
FORCE_TOL = 0.5


class ByteT5Tokenizer:
    """A seeded stand-in for T5's SentencePiece vocabulary: each byte maps to
    one id of a seeded permutation of [3, vocab) (0, 1, 2 stay pad, EOS and
    unk), EOS appended; called as an HF tokenizer is."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.ids = np.random.default_rng(seed).permutation(np.arange(3, vocab_size))[:256]

    def __call__(self, text, truncation=True, max_length=1024):
        ids = [int(self.ids[b]) for b in text.encode()]
        if truncation:
            ids = ids[: max_length - 1]
        ids.append(1)
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}


def byte_text(n: int, seed: int = 0) -> str:
    """``n`` printable bytes of seeded words."""
    rng = np.random.default_rng(seed)
    words = ["move", "the", "gripper", "left", "slowly", "until", "it", "touches", "cup",
             "then", "squeeze", "soft", "object", "and", "lift"]
    out = ""
    while len(out) < n:
        out += words[int(rng.integers(len(words)))] + " "
    return out[:n]


def t5_phase_encoder(cfg, seed: int, device):
    """Seeded T5 in bf16 (``init_t5_encoder``), then T5's own scales: q
    times d_kv^-0.5 (T5 folds the attention's 1/sqrt(d) into q's init) and
    the bucket table times 10, N(0, 1) as a trained table's order.  With
    JAX's lecun q and k the logits' spread (8) makes the attention near one
    hot, and a bucket fault would move nothing."""
    import torch

    from vla_touch_tpu_torch.models.encoders import t5_native as TT

    enc = TT.init_t5_encoder(cfg, seed, device, torch.bfloat16)
    with torch.no_grad():
        for layer in enc.layers:
            layer.q.weight.mul_(cfg.d_kv ** -0.5)
        enc.rel_bias.mul_(10.0)
    return enc


def t5_cut(enc, layers: int):
    """A T5Encoder holding ``enc``'s first ``layers`` layers and its tables
    (the same tensors)."""
    import dataclasses

    import torch

    from vla_touch_tpu_torch.models.encoders import t5_native as TT

    with torch.device("meta"):
        cut = TT.T5Encoder(dataclasses.replace(enc.cfg, num_layers=layers))
    cut.embed, cut.rel_bias, cut.final_norm = enc.embed, enc.rel_bias, enc.final_norm
    cut.layers = torch.nn.ModuleList(enc.layers[:layers])
    return cut.eval()


@contextlib.contextmanager
def t5_fault(kind):
    """A planted fault in the bucket bias for the block: the bucket map
    shifted by one ("bucket_shift"), or the bias laid out (L_k, L_q)
    ("bias_transposed")."""
    from vla_touch_tpu_torch.models.encoders import t5_native as TT

    orig = TT.relative_position_buckets

    def bucket_shift(q, k, nb, md, device=None):
        return (orig(q, k, nb, md, device) + 1) % nb

    def bias_transposed(q, k, nb, md, device=None):
        return orig(k, q, nb, md, device).T

    TT.relative_position_buckets = {"bucket_shift": bucket_shift,
                                    "bias_transposed": bias_transposed}[kind]
    try:
        yield
    finally:
        TT.relative_position_buckets = orig


def rel_l2(got, want) -> float:
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def t5_bf16_vs_float32(cut, ids) -> dict:
    """``cut`` (bf16, on its device) against its float32 copy on the CPU on
    (1, L) ``ids``: the relative L2 error and corr of the hidden states, and
    the relative L2 error under each planted fault."""
    import torch

    from vla_touch_tpu_torch.models.encoders import t5_native as TT

    cfg = cut.cfg
    with torch.device("meta"):
        ref = TT.T5Encoder(cfg)
    ref = ref.to_empty(device="cpu").requires_grad_(False)
    ref.load_state_dict({k: v.float().cpu() for k, v in cut.state_dict().items()})
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        want = TT.t5_encode(cfg, ref, ids, mask)
        got = TT.t5_encode(cfg, cut, ids, mask)
        out = {"rel_err": rel_l2(got, want), "corr": corr(got.float().cpu(), want)}
        for kind in T5_FAULTS:
            with t5_fault(kind):
                out[kind] = rel_l2(TT.t5_encode(cfg, cut, ids, mask), want)
    return out


def language_path(t, gen) -> dict:
    """T5-XXL (seeded, bf16, on the card) through ``LanguageEncoder`` and
    ``NativeT5Embedder``: the instruction dict saved and read back, one
    embedding as the language of a cold bf16 RDT-1B ``policy_step``, encode
    times, and the gate of the 2-layer cut against float32 on the CPU."""
    import shutil

    import torch

    from vla_touch_tpu_torch.models.encoders import t5 as T5
    from vla_touch_tpu_torch.models.encoders import t5_native as TT
    from vla_touch_tpu_torch.runtime import policy as P

    card = gpu_line()
    res = {}
    cfg = TT.t5_v1_1_xxl()
    t1 = time.perf_counter()
    enc = t5_phase_encoder(cfg, T5_SEED, "cuda")
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t1
    res["weights_gib"] = sum(p.numel() * p.element_size() for p in enc.parameters()) / 2 ** 30
    res["parameters"] = sum(p.numel() for p in enc.parameters())
    tok = ByteT5Tokenizer(cfg.vocab_size, T5_SEED)
    emb = TT.NativeT5Embedder(cfg, enc, tok)
    lang = T5.LanguageEncoder(emb)
    texts = list(T5_INSTRUCTIONS) + [byte_text(T5_LONG - 1)]
    lang.encode_instructions(texts[:1])                     # warm-up
    d = lang.encode_instructions(texts)
    lens = [d[x].shape[0] for x in texts]
    if lens[-1] != T5_LONG or not all(8 <= n <= 64 for n in lens[:-1]):
        raise AssertionError(f"instruction lengths {lens}")
    for x in texts:
        if d[x].shape[1] != cfg.d_model or not np.all(np.isfinite(d[x])):
            raise AssertionError(f"embedding of {x[:20]!r}: {d[x].shape}, finite "
                                 f"{np.all(np.isfinite(d[x]))}")
    res["tokens"] = lens
    work = os.path.join(ROOT, "build", "encoders")
    os.makedirs(work, exist_ok=True)
    try:
        path = os.path.join(work, "instructions.npz")
        T5.save_instruction_dict(path, d)
        back = T5.load_instruction_dict(path)
        if back["all_instructions"] != texts or not all(
                np.array_equal(back[x], d[x]) for x in texts):
            raise AssertionError("the instruction dict read back differs")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for n, text in ((32, texts[3][:31]), (T5_LONG, texts[-1])):
        if len(tok(text)["input_ids"]) != n:
            raise AssertionError(f"{n}-token instruction")
        ms, _ = host_p50(lambda: emb.get_text_embeddings([text]))
        res[f"encode_ms_{n}"] = ms

    # the tick with the instruction's embedding as its language
    ins = texts[T5_POLICY_INSTRUCTION]
    pin = policy_inputs(t)
    pin["text_embeds"] = torch.as_tensor(d[ins][None], device="cuda")
    pin["text_mask"] = torch.ones((1, d[ins].shape[0]), dtype=torch.bool, device="cuda")
    rdt, vision = t["model"].rdt, t["model"].vision
    zero_counts()
    actions = P.policy_step(t["pcfg"], rdt, vision, **pin,
                            init_noise=t["inp"]["init_noise"]).cpu().numpy()
    counts = read_counts()
    check_counts(f"T5-embedded cold bf16 policy_step [{card}]", counts, {"K1": 307})
    if actions.shape != (1, 64, 10) or not np.all(np.isfinite(actions)):
        raise AssertionError(f"T5-embedded chunk {actions.shape}")
    rand = P.policy_step(t["pcfg"], rdt, vision, **policy_inputs(t),
                         init_noise=t["inp"]["init_noise"]).cpu().numpy()
    res["tick_launches"] = counts
    res["chunk_corr_vs_random_language"] = action_corr(t, actions, rand)

    # bf16 on the card vs float32 on the CPU, the depth-cut model
    gate_ids = torch.as_tensor([tok(byte_text(T5_GATE_TOKENS - 1, seed=1))["input_ids"]],
                               device="cuda")
    g = t5_bf16_vs_float32(t5_cut(enc, T5_GATE_LAYERS), gate_ids)
    res["gate"] = g
    log(f"T5 2-layer cut, card bf16 vs CPU float32: rel L2 {g['rel_err']:.4e} (tol "
        f"{T5_REL_TOL}; CPU bf16 {T5_CPU_BF16_REL}), corr {g['corr']:.6f}; planted faults "
        + ", ".join(f"{k} {g[k]:.4e}" for k in T5_FAULTS) + f" [{card}]")
    if not g["rel_err"] <= T5_REL_TOL:
        raise AssertionError(f"T5 bf16 on the card vs float32: {g['rel_err']} > {T5_REL_TOL}")
    for kind in T5_FAULTS:
        if not g[kind] > T5_REL_TOL:
            raise AssertionError(f"T5 gate misses the planted fault {kind}: {g[kind]}")
    del emb, lang, enc
    torch.cuda.empty_cache()
    return res


def marker_frames(shifts, H=FORCE_H, W=FORCE_W, rows=7, cols=9, radius=3, bg=200.0,
                  fg=40.0, gains=None):
    """(T, H, W) float32 GelSight-style frames on the card: ``marker_frame``'s
    grid of dark dots, frame t shifted by ``shifts[t]`` (x, y) pixels and
    scaled by ``gains[t]`` (clipped to 255).  Each pixel is tested against
    its nearest marker only (the dots are far apart)."""
    import torch

    s = torch.as_tensor(np.asarray(shifts, np.float32), device="cuda")
    sx, sy = s[:, 0, None, None], s[:, 1, None, None]
    ch, cw = H // rows, W // cols
    yy = torch.arange(H, dtype=torch.float32, device="cuda")[None, :, None]
    xx = torch.arange(W, dtype=torch.float32, device="cuda")[None, None, :]
    r = torch.clamp(torch.round((yy - ch / 2 - sy) / ch), 0, rows - 1)
    c = torch.clamp(torch.round((xx - cw / 2 - sx) / cw), 0, cols - 1)
    d2 = (yy - (r * ch + ch / 2 + sy)) ** 2 + (xx - (c * cw + cw / 2 + sx)) ** 2
    img = torch.where(d2 <= radius ** 2, fg, bg)
    if gains is not None:
        g = torch.as_tensor(np.asarray(gains, np.float32), device="cuda")
        img = torch.clamp(img * g[:, None, None], 0, 255)
    return img


def force_path() -> dict:
    """``estimate_force_sequence`` on an episode of FORCE_T frames, standard
    and HSR, against the planted shifts and against per-frame
    ``estimate_force`` (equal bit for bit); frames/s of both."""
    import torch

    from vla_touch_tpu_torch.ops import marker_tracking as MT

    card = gpu_line()
    t = np.arange(FORCE_T)
    shifts = np.stack([2.5 * np.sin(2 * np.pi * t / FORCE_T),
                       1.5 * np.sin(4 * np.pi * t / FORCE_T)], axis=1)
    res = {}
    for version, kw in (("standard", {}),
                        ("hsr", dict(bg=120.0, fg=30.0, gains=1.0 + 0.15 * t / FORCE_T))):
        cfg = MT.TrackerConfig(gelsight_version=version)
        frames = marker_frames(shifts, **kw)
        base = MT.calibrate(frames[0], cfg)
        if int(base["valid"].sum()) != cfg.grid_rows * cfg.grid_cols:
            raise AssertionError(f"{version}: {int(base['valid'].sum())} valid cells")
        MT.estimate_force_sequence(frames[:8], base, cfg)          # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        seq = MT.estimate_force_sequence(frames, base, cfg)
        end.record()
        torch.cuda.synchronize()
        seq_ms = start.elapsed_time(end)
        t1 = time.perf_counter()
        one = torch.stack([MT.estimate_force(frames[i], base, cfg)["force"]
                           for i in range(FORCE_T)])
        torch.cuda.synchronize()
        per_ms = 1e3 * (time.perf_counter() - t1)
        disp = seq["displacements"].cpu().numpy()
        err = float(np.abs(disp - shifts).max())
        unlike = int((one != seq["forces"]).any(dim=1).sum())
        res[version] = dict(frames=FORCE_T, max_disp_err_px=err, unlike_frames=unlike,
                            batched_ms=seq_ms, batched_frames_per_s=1e3 * FORCE_T / seq_ms,
                            per_frame_ms=per_ms, per_frame_frames_per_s=1e3 * FORCE_T / per_ms)
        log(f"force sequence {version}: {FORCE_T} frames {FORCE_H}x{FORCE_W}, displacement "
            f"err {err:.3f} px (tol {FORCE_TOL}), frames unlike per-frame estimate_force "
            f"{unlike}; batched {seq_ms:.2f} ms ({1e3 * FORCE_T / seq_ms:.0f} frames/s), "
            f"per-frame loop {per_ms:.1f} ms [{card}]")
        if not err <= FORCE_TOL or unlike:
            raise AssertionError(f"force sequence {version}: err {err}, unlike {unlike}")
        del frames
    return res


def sparsh_path(gen) -> dict:
    """Sparsh ViT-B/16 (seeded, bf16) on SPARSH_BATCH frame pairs: K1's
    launches, the CLS against the plain-version encoder, a checked run,
    ms, K1's share of the device time; K1 at the shape against its plain
    version and SDPA."""
    import torch

    from vla_touch_tpu_torch.models.encoders import sparsh as TS

    card = gpu_line()
    res = {}
    res["k1_sparsh_rows"], _ = check_k1(gen, K1_SPARSH_SHAPES)
    sp = TS.load_pretrained_encoder(None, seed=0, device="cuda")
    c = TS.SPARSH_VIT_B
    x = torch.randn((SPARSH_BATCH, c.image_size, c.image_size, c.num_channels),
                    generator=gen, device="cuda").to(torch.bfloat16)

    def encode():
        with torch.inference_mode():
            return sp(x)

    encode()                                                     # warm-up
    zero_counts()
    cls = encode()
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(f"Sparsh ViT-B/16, {SPARSH_BATCH} frame pairs [{card}]", counts,
                 {"K1": c.num_layers})
    with plain_kernels():
        cls_p = encode()
    res["launches"] = counts
    res["cls_corr"] = corr(cls.float().cpu(), cls_p.float().cpu())
    if cls.shape != (SPARSH_BATCH, c.hidden_size) or not res["cls_corr"] > TOKEN_CORR_MIN:
        raise AssertionError(f"Sparsh CLS {tuple(cls.shape)}, corr {res['cls_corr']} "
                             f"(min {TOKEN_CORR_MIN})")
    check_chk("Sparsh checked run", checked_run(encode), {"K1": c.num_layers})
    res["ms"] = cuda_time_ms(encode, reps=10)
    prof = profile_run(encode)
    k1_ms = prof["groups_ms"]["K1 flash_fwd_kernel"] + prof["groups_ms"]["K1 flash_combine_kernel"]
    res["k1_share"] = k1_ms / prof["device_busy_ms"]
    res["profile"] = {k: prof[k] for k in ("device_busy_ms", "idle_share", "groups_ms")}
    row = res["k1_sparsh_rows"][0]
    log(f"Sparsh: {res['ms']:.3f} ms a call of {SPARSH_BATCH} pairs, K1 {row['ms']:.4f} ms "
        f"x12 ({res['k1_share']:.3f} of the profiled device time), SDPA "
        f"{row['library_ms']:.4f} ms at the shape, CLS corr {res['cls_corr']:.6f} [{card}]")
    del sp
    return res


def warm_quality_path(gen) -> dict:
    """``eval/warm_quality.py``'s protocol on the card in bf16 (K1 in the
    tiny RDT's attention): K1 at the protocol's shapes against its plain
    version and SDPA; the run, its four asserts and K1's launches (two a
    block in each training step's forward; two a block at each solver step
    of the first cold chunk and of REPLANS cold and warm replans); then, on
    a fresh model, one training step and one cold and one warm chunk as a
    checked run."""
    from vla_touch_tpu_torch.config import rdt_tiny
    from vla_touch_tpu_torch.eval import warm_quality as WQ
    from vla_touch_tpu_torch.runtime.control_loop import shift_prior

    card = gpu_line()
    m = rdt_tiny()
    shapes = {(B, Lq, Lkv, H, D) for _, B, Lq, Lkv, H, D, *_ in K1_WARM_SHAPES}
    want = {(B, m.horizon + 3, Lkv, m.num_heads, m.hidden_size // m.num_heads)
            for B in (WQ.BATCH, WQ.ROWS) for Lkv in (m.horizon + 3, 4, m.img_cond_len)}
    if shapes != want or m.depth != 2:
        raise AssertionError(f"K1_WARM_SHAPES {sorted(shapes)} are not the protocol's "
                             f"{sorted(want)} (depth {m.depth})")
    res = {}
    res["k1_warm_rows"], tot = check_k1(gen, K1_WARM_SHAPES)
    res["k1_warm_ms"] = {k: tot[k] for k in ("warm_train_step", "warm_chunk")}
    per_pass = 2 * m.depth
    need = per_pass * (WQ.STEPS + 5 * (1 + WQ.REPLANS) + (5 - WQ.WARM_SKIP) * WQ.REPLANS)
    zero_counts()
    r = WQ.run(device="cuda", dtype="bfloat16")
    counts = read_counts()
    check_counts(f"warm-replan quality, rdt_tiny bf16 [{card}]", counts, {"K1": need})
    log("warm-replan quality: " + json.dumps(r) + f" [{card}]")
    WQ.check(r)
    res.update(r, launches=counts)

    p = WQ.Protocol("cuda", "bfloat16")
    check_chk("warm-quality training step checked", checked_run(p.train_step),
              {"K1": per_pass})
    phase = WQ.make_batch(p.rng, p.m, WQ.ROWS)[0]
    t0 = np.full((WQ.ROWS,), 20.0)

    def replan():
        prior = np.stack([shift_prior(c, WQ.SHIFT) for c in p.chunk(phase, t0)])
        p.chunk(phase, t0 + WQ.SHIFT, prior=prior, skip=WQ.WARM_SKIP)

    check_chk("warm-quality cold and warm chunk checked", checked_run(replan),
              {"K1": per_pass * (5 + 5 - WQ.WARM_SKIP)})
    return res


def encoders_phase(t, gen) -> dict:
    """The language path (T5-XXL into the tick), Sparsh, the force
    sequences and the warm-replan quality; each path counted from 0."""
    t_phase = time.perf_counter()
    res = {}
    for name, run in (("language", lambda: language_path(t, gen)),
                      ("sparsh", lambda: sparsh_path(gen)), ("force", force_path),
                      ("warm_quality", lambda: warm_quality_path(gen))):
        t1 = time.perf_counter()
        res[name] = run()
        res[name]["phase_s"] = time.perf_counter() - t1
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# ---- the episode data path ------------------------------------------------------------

# The capture: DATA_EPISODES episodes of DATA_STEPS steps, two RGB cameras at
# the reference's Franka frame size and a GelSight camera at the tracker's.
# An episode is 40 steps, not fewer: the RDT sampler draws a step in
# [onset - 1, T - 32) for RDT-1B's 64-step chunk (data/vla_dataset.py), so
# T must pass 32 + onset; the robot moves from step DATA_ONSET on.
DATA_EPISODES, DATA_STEPS, DATA_ONSET = 3, 40, 1
DATA_CAM_H, DATA_CAM_W = 480, 640
DATA_DATASET = "capture"
DATA_INSTRUCTIONS = ("wipe the table with the sponge",
                     "press the soft toy gently until it yields",
                     "pick up the mango and place it in the bowl")
# BRIDGeR from the distilled, resized frames: the tick's horizon (16), batch
# 8 over the train split's windows (5 steps an epoch at these episodes)
DATA_BRIDGE_HORIZON, DATA_BRIDGE_BATCH, DATA_BRIDGE_STEPS = 16, 8, 5
# RDT-1B steps from each source: step 1's loss does not depend on the frames
# (it reads the same on the JPEG cache), so steps 2 and 3 carry the
# comparison
DATA_RDT_STEPS = 2
# samples/s through the consumer: batches of the RDT trainer's micro-batch
# (4 samples), the rate read from the batches that arrive after batch
# DATA_SAMPLE_SKIP, past the prefetcher's first fill (4 threads + depth 2
# batches start at once)
DATA_SAMPLE_BATCHES, DATA_SAMPLE_BATCH, DATA_SAMPLE_SKIP = 24, 4, 6
DATA_DECODE_REPS = 3
# nvJPEG's frames against cv2.imdecode's (libjpeg, through OpenCV) on the
# same blobs, in uint8 levels: the two decoders' inverse DCT, chroma
# upsampling and colour conversion round differently.  The first reading on
# an H100 (NVIDIA H100 80GB HBM3, 700 W): max 4, mean 0.5359 over 240
# frames of 480 x 640; the bounds leave 2 x for another nvJPEG backend's
# rounding.  The same frames with R and B swapped read far above
# (``vs_cv2_rb_swapped``, printed beside).
NVJPEG_MAX_ABS = 8
NVJPEG_MEAN_ABS = 1.0


def capture_scene(ep: int, t: int, cam: int) -> np.ndarray:
    """A 480 x 640 RGB frame of a moving scene: a gradient field and a bright
    blob that moves along the episode, per camera."""
    yy, xx = np.mgrid[0:DATA_CAM_H, 0:DATA_CAM_W].astype(np.float32)
    ph = 0.7 * ep + 1.3 * cam
    cx = DATA_CAM_W * (0.5 + 0.3 * np.sin(2 * np.pi * t / DATA_STEPS + ph))
    cy = DATA_CAM_H * (0.5 + 0.3 * np.cos(2 * np.pi * t / DATA_STEPS + ph))
    blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 60.0 ** 2))
    img = np.stack([40 + 150 * xx / DATA_CAM_W + 60 * blob,
                    50 + 120 * yy / DATA_CAM_H + 90 * blob,
                    80 + 40 * np.sin(xx / 37.0 + ph) + 100 * blob], axis=-1)
    return np.clip(img, 0, 255).astype(np.uint8)


def capture_poses(ep: int):
    """(T, 7) ee poses (xyz + xyzw quaternion), still until DATA_ONSET, and
    (T,) gripper readings on the 0..255 scale."""
    t = np.arange(DATA_STEPS)
    ramp = np.clip((t - DATA_ONSET) / (DATA_STEPS - DATA_ONSET), 0, 1)[:, None]
    rng = np.random.default_rng(100 + ep)
    pos = 0.4 + 0.15 * np.sin(2 * np.pi * t[:, None] / DATA_STEPS
                              * rng.uniform(0.5, 1.5, 3)) * ramp
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = 0.6 * ramp[:, 0]
    quat = np.concatenate([axis * np.sin(ang / 2)[:, None], np.cos(ang / 2)[:, None]], -1)
    grip = 200.0 - 150.0 * ramp[:, 0]
    return np.concatenate([pos, quat], -1), grip


def write_capture(root: str) -> dict:
    """The capture directory: per episode ``camera1/``, ``camera2/`` (JPEG,
    480 x 640), ``gelsight/`` (240 x 320 marker frames, the grid shifted
    along a planted path), ``ee_poses.npy``, ``gripper_pos.npy``; the
    planted GelSight shifts per episode."""
    import cv2

    t = np.arange(DATA_STEPS)
    shifts = {}
    for ep in range(DATA_EPISODES):
        d = os.path.join(root, f"episode_{ep}")
        for sub in ("camera1", "camera2", "gelsight"):
            os.makedirs(os.path.join(d, sub))
        s = np.stack([1.8 * np.sin(np.pi * t / DATA_STEPS) * (1 + 0.2 * ep),
                      -1.2 * np.sin(2 * np.pi * t / DATA_STEPS)], axis=1)
        s -= s[0]                                        # frame 0 is the calibration
        shifts[ep] = s
        gel = marker_frames(s).round().clamp(0, 255).byte().cpu().numpy()
        for i in range(DATA_STEPS):
            for cam in (1, 2):
                cv2.imwrite(os.path.join(d, f"camera{cam}", f"{i:06d}.jpg"),
                            capture_scene(ep, i, cam)[:, :, ::-1])
            cv2.imwrite(os.path.join(d, "gelsight", f"{i:06d}.jpg"),
                        np.repeat(gel[i][:, :, None], 3, axis=2))
        ee, grip = capture_poses(ep)
        np.save(os.path.join(d, "ee_poses.npy"), ee)
        np.save(os.path.join(d, "gripper_pos.npy"), grip)
    return shifts


def decode_routes(epc_paths: list) -> dict:
    """Frames/s of the three decode routes over every camera stream of the
    JPEG caches: nvJPEG into device memory, nvJPEG and one copy to the host,
    and, as a yardstick only, ``cv2.imdecode`` on a thread pool of the
    host's cores; nvJPEG's frames against cv2's (max and mean abs uint8)."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import torch

    from vla_touch_tpu_torch.runtime import native_loader as NL

    caches = [NL.EpisodeCache(p) for p in epc_paths]
    streams = [(c, cam) for c in caches for cam in range(c.n_cams)]
    frames = sum(c.T for c, _ in streams)
    workers = os.cpu_count() or 1

    def nvjpeg():
        return [c.decode_frames(cam, 0, c.T, device="cuda") for c, cam in streams]

    def nvjpeg_host():
        return [c.decode_frames(cam, 0, c.T, device="cuda").cpu().numpy()
                for c, cam in streams]

    blobs = []
    for c, cam in streams:
        ptrs, lens = c.frame_blobs(cam, 0, c.T)
        blobs += [np.frombuffer(ctypes.string_at(int(p), int(n)), np.uint8)
                  for p, n in zip(ptrs, lens)]
    pool = ThreadPoolExecutor(max_workers=workers)

    def imdecode():
        return list(pool.map(lambda b: cv2.imdecode(b, cv2.IMREAD_COLOR)[:, :, ::-1], blobs))

    res = {"frames": frames, "size": [caches[0].H, caches[0].W], "host_threads": workers}
    try:
        for name, run in (("nvjpeg_device", nvjpeg), ("nvjpeg_to_host", nvjpeg_host),
                          ("cv2_imdecode_threads", imdecode)):
            run()                                                  # warm-up
            ts = []
            for _ in range(DATA_DECODE_REPS):
                t1 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t1)
            res[name] = {"frames_per_s": frames / float(np.median(ts)),
                         "s": [round(x, 4) for x in ts]}
        dev = np.concatenate(nvjpeg_host())
        ref = np.stack(imdecode())
    finally:
        pool.shutdown()
        for c in caches:
            c.close()
    diff = np.abs(dev.astype(np.int16) - ref.astype(np.int16))
    res["vs_cv2"] = {"max_abs": int(diff.max()), "mean_abs": float(diff.mean()),
                     "share_unlike": float((diff > 0).mean())}
    swapped = np.abs(dev[..., ::-1].astype(np.int16) - ref.astype(np.int16))
    res["vs_cv2_rb_swapped"] = {"max_abs": int(swapped.max()),
                                "mean_abs": float(swapped.mean())}
    return res


def consumer_rates(data_roots: dict) -> dict:
    """Steady-state samples/s of ``UnifiedVLADataset`` through
    ``data/consumer.py``: the RDT trainer's micro-batches
    (``VLAConsumerDataset`` forks, ``collate``) built by ``PrefetchLoader``
    on 0 and 4 threads, per data source, over the batches after the first
    DATA_SAMPLE_SKIP."""
    from vla_touch_tpu_torch.config import DataConfig
    from vla_touch_tpu_torch.data.consumer import VLAConsumerDataset, collate
    from vla_touch_tpu_torch.data.pipeline import PrefetchLoader

    res = {}
    for name, (root, fmt) in data_roots.items():
        dcfg = DataConfig(data_root=root, dataset_names=(DATA_DATASET,), data_format=fmt,
                          chunk_size=64, image_size=384)
        ds = VLAConsumerDataset(dcfg, seed=0)

        def make(i):
            part = ds.fork((0, i))
            return collate([part.sample() for _ in range(DATA_SAMPLE_BATCH)],
                           max_lang_len=1024)

        for workers in (0, 4):
            make(0)                                                # warm-up
            shapes, arrived = [], []
            with PrefetchLoader(make, workers=workers, num_batches=DATA_SAMPLE_BATCHES) as ld:
                for b in ld:
                    shapes.append(tuple(b["images"].shape))
                    arrived.append(time.perf_counter())
            if shapes != [(DATA_SAMPLE_BATCH, 6, 384, 384, 3)] * DATA_SAMPLE_BATCHES:
                raise AssertionError(f"consumer batches from {name}: {shapes}")
            n = DATA_SAMPLE_BATCHES - 1 - DATA_SAMPLE_SKIP
            res[f"{name}_workers{workers}"] = (n * DATA_SAMPLE_BATCH
                                               / (arrived[-1] - arrived[DATA_SAMPLE_SKIP]))
    return res


@contextlib.contextmanager
def recorded(module, name: str, out: list, value):
    """``module.name`` wrapped for the block: each call's ``value(result)``
    and host time (after a synchronise) appended to ``out``."""
    import torch

    orig = getattr(module, name)

    def wrapper(*a, **kw):
        t1 = time.perf_counter()
        r = orig(*a, **kw)
        torch.cuda.synchronize()
        out.append((value(r), time.perf_counter(), 1e3 * (time.perf_counter() - t1)))
        return r

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, orig)


def rdt_from(root: str, fmt: str, out_dir: str) -> dict:
    """``rdt_loop.main`` on RDT-1B (the JAX recipe's batch 4 x accumulation
    4, seeded weights and SigLIP) for DATA_RDT_STEPS steps from ``root``:
    each step's loss and host ms, K1's launches.  The final checkpoint
    (19.65 GB; written and read back by ``rdt_train_phase``) is recorded,
    not written."""
    import gc

    import torch

    from vla_touch_tpu_torch.train import rdt_loop as RL

    steps, saved = [], []
    orig_save = RL.RDTTrainer.save_checkpoint
    RL.RDTTrainer.save_checkpoint = lambda self, state, step: saved.append(step) or {}
    try:
        with recorded(RL.T, "train_step", steps, lambda r: float(r[1]["loss"])):
            zero_counts()
            t1 = time.perf_counter()
            RL.main(["--data_root", root, "--dataset_name", DATA_DATASET, "--data_format", fmt,
                     "--output_dir", out_dir, "--max_train_steps", str(DATA_RDT_STEPS),
                     "--sample_period", "1000000", "--checkpointing_period", "1000000",
                     "--lr_warmup_steps", "0", "--dataloader_num_workers", "2", "--seed", "0"])
            run_s = time.perf_counter() - t1
            counts = read_counts()
    finally:
        RL.RDTTrainer.save_checkpoint = orig_save
    gc.collect()
    torch.cuda.empty_cache()
    if saved != [DATA_RDT_STEPS] or len(steps) != DATA_RDT_STEPS:
        raise AssertionError(f"rdt from {fmt}: steps {len(steps)}, final save {saved}")
    return {"losses": [s[0] for s in steps], "step_ms": [s[2] for s in steps],
            "run_s": run_s, "launches": counts}


def bridge_from(data_dir: str, fmt: str, out_dir: str) -> dict:
    """``bridge_train.main`` (BRIDGeR at its defaults with the DinoV2-small
    pair at 384^2, horizon DATA_BRIDGE_HORIZON, batch DATA_BRIDGE_BATCH, one
    epoch, 2 prefetch threads) from ``data_dir``: each step's loss and host
    ms, the validation batches, K1's launches.  cuDNN is held to its
    deterministic algorithms for the run: its default convolution backwards
    sum in an order that varies from run to run, so two runs on the same
    batches part after the first step (by 2e-7 relative on an H100)."""
    import torch

    from vla_touch_tpu_torch.train import bridge_train as BT

    steps = []
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with recorded(BT, "_train_step", steps, lambda r: float(r["loss"])):
            zero_counts()
            t1 = time.perf_counter()
            _, trainer = BT.main(["--data_dir", data_dir, "--output_dir", out_dir,
                                  "--horizon", str(DATA_BRIDGE_HORIZON),
                                  "--batch_size", str(DATA_BRIDGE_BATCH), "--epochs", "1",
                                  "--data_format", fmt, "--prefetch_workers", "2"])
            run_s = time.perf_counter() - t1
            counts = read_counts()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    del trainer
    torch.cuda.empty_cache()
    return {"losses": [s[0] for s in steps], "step_ms": [s[2] for s in steps],
            "run_s": run_s, "launches": counts}


def same_losses(what: str, got: dict, want: dict) -> dict:
    """``got``'s losses against ``want``'s: equal, step by step."""
    a, b = np.asarray(got["losses"]), np.asarray(want["losses"])
    out = {"losses": got["losses"], "reference": want["losses"],
           "equal": bool(a.shape == b.shape and np.array_equal(a, b))}
    log(f"{what}: losses {got['losses']} against {want['losses']}: equal {out['equal']}")
    if not out["equal"] or not np.all(np.isfinite(a)):
        raise AssertionError(f"{what}: losses {got['losses']} unlike {want['losses']}")
    return out


def data_phase(t) -> dict:
    """The episode data path at the deployment's sizes, each step's K1
    launches counted from 0: a capture directory (DATA_EPISODES x
    DATA_STEPS, two 480 x 640 cameras, GelSight 240 x 320), its
    instructions embedded by T5-XXL (bf16, seeded), GelSight force on the
    card, npz episodes, the distillation pass with the tick's RDT-1B policy
    and SigLIP (``t``'s bf16 model, every timestep; K1 counted, one tick a
    checked run), ``.epc`` caches in both codecs, the three decode routes,
    the consumer's samples/s, RDT-1B and BRIDGeR trained from ``.epc``
    against the npz run, and the dataset statistics."""
    import gc
    import shutil

    import torch

    from vla_touch_tpu_torch.config import DataConfig
    from vla_touch_tpu_torch.csrc import build as KB
    from vla_touch_tpu_torch.data import capture as CP
    from vla_touch_tpu_torch.data import distill as DS
    from vla_touch_tpu_torch.data import episode as EP
    from vla_touch_tpu_torch.data import stats as ST
    from vla_touch_tpu_torch.data.controller_dataset import ControllerDataModule
    from vla_touch_tpu_torch.data.pack_epc import pack_dataset
    from vla_touch_tpu_torch.models.encoders import t5_native as TT
    from vla_touch_tpu_torch.models.encoders.vit import DINOV2_SMALL
    from vla_touch_tpu_torch.runtime import native_loader as NL

    card = gpu_line()
    root = os.path.join(ROOT, "build", "data")
    shutil.rmtree(root, ignore_errors=True)
    res = {"has_libjpeg": NL.has_libjpeg()}
    marks = {}
    t_phase = time.perf_counter()
    try:
        res["has_nvjpeg"] = KB.buildable("jpeg_decode")
        log(f"data: jpeglib.h on the host {res['has_libjpeg']}, nvjpeg.h in the toolkit "
            f"{res['has_nvjpeg']} [{card}]")
        if not res["has_nvjpeg"]:
            raise AssertionError("the CUDA toolkit has no nvJPEG: JPEG caches cannot be "
                                 "decoded on this card")
        # 1. the capture
        cap = os.path.join(root, "capture")
        t1 = time.perf_counter()
        shifts = write_capture(cap)
        CP.label_instructions(cap, {f"episode_{e}": DATA_INSTRUCTIONS[e]
                                    for e in range(DATA_EPISODES)})
        marks["capture_s"] = time.perf_counter() - t1

        # 2. instructions through T5-XXL
        t1 = time.perf_counter()
        cfg = TT.t5_v1_1_xxl()
        enc = t5_phase_encoder(cfg, T5_SEED, "cuda")
        emb = TT.NativeT5Embedder(cfg, enc, ByteT5Tokenizer(cfg.vocab_size, T5_SEED))
        written = CP.precompute_instructions(cap, emb)
        lens = [np.load(p).shape for p in written]
        del emb, enc
        gc.collect()
        torch.cuda.empty_cache()
        marks["instructions_s"] = time.perf_counter() - t1
        if len(written) != DATA_EPISODES or any(s[1] != cfg.d_model for s in lens):
            raise AssertionError(f"instruction embeddings {lens}")
        res["instruction_shapes"] = lens

        # 3. GelSight force on the card
        t1 = time.perf_counter()
        err = 0.0
        for ep in range(DATA_EPISODES):
            f = CP.process_gelsight(os.path.join(cap, f"episode_{ep}"))
            err = max(err, float(np.abs(f["displacements"] - shifts[ep]).max()))
        marks["force_s"] = time.perf_counter() - t1
        res["force_max_disp_err_px"] = err
        log(f"data: GelSight force of {DATA_EPISODES} x {DATA_STEPS} frames on the card, "
            f"displacement within {err:.3f} px of the planted path (tol {FORCE_TOL})")
        if not err <= FORCE_TOL:
            raise AssertionError(f"GelSight force: {err} px off the planted path")

        # 4. npz episodes
        t1 = time.perf_counter()
        raw_dir = os.path.join(root, "raw", f"{DATA_DATASET}_hdf5_gelsight")
        for ep in range(DATA_EPISODES):
            CP.convert_to_hdf5(os.path.join(cap, f"episode_{ep}"),
                               os.path.join(raw_dir, f"episode_{ep}.npz"))
        marks["episodes_s"] = time.perf_counter() - t1

        # 5. the distillation pass: the cold bf16 tick without refine
        model = t["model"]
        need = {"K1": t["pcfg"].vision.num_layers
                + t["pcfg"].rdt.noise.num_inference_timesteps * 2 * t["pcfg"].rdt.model.depth}
        if need["K1"] != warm_need(t, 0, False)["K1"] - DINOV2_SMALL.num_layers:
            raise AssertionError(f"the cold tick's K1 need {need} is not warm_need's")
        ticks = []

        def policy_step(proprio, images, text):
            ticks.append(images)
            return model.step(proprio, images, text)

        npz_root = os.path.join(root, "npz")
        npz_dir = os.path.join(npz_root, f"{DATA_DATASET}_hdf5_gelsight")
        zero_counts()
        t1 = time.perf_counter()
        outs = DS.record_vla_actions_for_dataset(raw_dir, npz_dir, policy_step, image_size=384)
        torch.cuda.synchronize()
        marks["distill_s"] = time.perf_counter() - t1
        counts = read_counts()
        log(f"data: distillation of {len(ticks)} timesteps in {marks['distill_s']:.1f} s "
            f"({len(ticks) / marks['distill_s']:.2f} ticks/s) [{card}]")
        n_ticks = DATA_EPISODES * DATA_STEPS
        check_counts(f"distillation, {n_ticks} cold bf16 ticks without refine [{card}]",
                     counts, {"K1": n_ticks * need["K1"]})
        res["distill"] = {"ticks": len(ticks), "launches": counts,
                          "ticks_per_s": len(ticks) / marks["distill_s"]}
        horizon = t["pcfg"].rdt.model.horizon
        for p in outs:
            with EP.EpisodeFile(p) as f:
                vla = np.asarray(f["vla_action"])
                r1 = np.asarray(f["camera1_resized"])
            if vla.shape != (DATA_STEPS, horizon, 10) or not np.all(np.isfinite(vla)) \
                    or r1.shape != (DATA_STEPS, 384, 384, 3):
                raise AssertionError(f"{p}: vla_action {vla.shape}, resized {r1.shape}")
        last = ticks[-1]
        with EP.EpisodeFile(outs[-1]) as f:
            qpos = EP.qpos_from_episode(f)
            text = np.array(np.asarray(f["instruct_embeddings"])[0])
        check_chk("distillation tick checked",
                  checked_run(lambda: model.step(qpos[-1], last, text)), need)

        # 6. the caches
        t1 = time.perf_counter()
        epc_root = {codec: os.path.join(root, f"epc_{codec}") for codec in ("jpeg", "raw")}
        epc = {codec: pack_dataset(npz_dir, os.path.join(r, f"{DATA_DATASET}_hdf5_gelsight"),
                                   codec=codec)
               for codec, r in epc_root.items()}
        ctrl_dir = os.path.join(root, "ctrl_epc")
        pack_dataset(npz_dir, ctrl_dir, codec="raw", use_resized=True)
        marks["pack_s"] = time.perf_counter() - t1
        size = {"npz": sum(os.path.getsize(p) for p in outs)}
        for codec, paths in epc.items():
            size[f"epc_{codec}"] = sum(os.path.getsize(p) for p in paths)
        res["bytes"] = size
        log(f"data: bytes {json.dumps(size)} ({DATA_EPISODES} episodes) [{card}]")

        # 7. decode routes
        t1 = time.perf_counter()
        dec = decode_routes(epc["jpeg"])
        marks["decode_s"] = time.perf_counter() - t1
        res["decode"] = dec
        log(f"data: decode {dec['frames']} frames of {dec['size']}: nvJPEG to device "
            f"{dec['nvjpeg_device']['frames_per_s']:.0f} frames/s, nvJPEG + copy to host "
            f"{dec['nvjpeg_to_host']['frames_per_s']:.0f}, cv2.imdecode on "
            f"{dec['host_threads']} threads {dec['cv2_imdecode_threads']['frames_per_s']:.0f}; "
            f"nvJPEG vs cv2 max abs {dec['vs_cv2']['max_abs']} (bound {NVJPEG_MAX_ABS}), mean "
            f"abs {dec['vs_cv2']['mean_abs']:.4f} (bound {NVJPEG_MEAN_ABS}); R and B swapped: max "
            f"{dec['vs_cv2_rb_swapped']['max_abs']}, mean "
            f"{dec['vs_cv2_rb_swapped']['mean_abs']:.2f} [{card}]")
        if not (dec["vs_cv2"]["max_abs"] <= NVJPEG_MAX_ABS
                and dec["vs_cv2"]["mean_abs"] <= NVJPEG_MEAN_ABS):
            raise AssertionError(f"nvJPEG frames unlike cv2's: {dec['vs_cv2']}")
        c = NL.EpisodeCache(epc["jpeg"][0])
        res["datasets_decode_on"] = "host (libjpeg)" if c.host_decode else \
            "card (nvJPEG), one copy back"
        c.close()

        # 8. samples/s through the consumer
        t1 = time.perf_counter()
        res["samples_per_s"] = consumer_rates({"npz": (npz_root, "h5"),
                                               "epc_jpeg": (epc_root["jpeg"], "epc"),
                                               "epc_raw": (epc_root["raw"], "epc")})
        marks["samples_s"] = time.perf_counter() - t1
        log(f"data: consumer samples/s {json.dumps(res['samples_per_s'])} [{card}]")

        # 9. training from .epc against npz
        t1 = time.perf_counter()
        from vla_touch_tpu_torch.config import TrainConfig, rdt_1b

        m = rdt_1b()
        step_k1 = rdt_k1_need(m, TrainConfig(), t["pcfg"].vision.num_layers)["step"]
        rdt = {}
        for name, r in (("npz", npz_root), ("epc_raw", epc_root["raw"]),
                        ("epc_jpeg", epc_root["jpeg"])):
            rdt[name] = rdt_from(r, "h5" if name == "npz" else "epc",
                                 os.path.join(root, f"rdt_{name}"))
            log(f"data: RDT-1B from {name}: step ms {rdt[name]['step_ms']}, run "
                f"{rdt[name]['run_s']:.1f} s [{card}]")
            check_counts(f"RDT-1B, {DATA_RDT_STEPS} steps from {name} [{card}]",
                         rdt[name]["launches"], {"K1": DATA_RDT_STEPS * step_k1})
        res["rdt"] = rdt
        res["rdt_epc_vs_npz"] = same_losses("RDT-1B from the raw .epc against npz",
                                            rdt["epc_raw"], rdt["npz"])
        # the comparison sees the frames: the JPEG cache's pixels differ, and
        # so does each of its losses after step 1
        jpeg, npz = np.asarray(rdt["epc_jpeg"]["losses"]), np.asarray(rdt["npz"]["losses"])
        if not np.all(np.isfinite(jpeg)) or np.any(jpeg[1:] == npz[1:]):
            raise AssertionError(f"RDT-1B from the JPEG .epc: losses {list(jpeg)} against "
                                 f"npz's {rdt['npz']['losses']}: the frames do not reach them")
        dm = ControllerDataModule(ctrl_dir, horizon=DATA_BRIDGE_HORIZON, data_format="epc")
        n_train = len(dm.train_dataset) // DATA_BRIDGE_BATCH
        n_val = len(dm.val_dataset) // min(DATA_BRIDGE_BATCH, len(dm.val_dataset))
        if n_train != DATA_BRIDGE_STEPS:
            raise AssertionError(f"BRIDGeR: {n_train} steps an epoch, want {DATA_BRIDGE_STEPS}")
        bridge = {}
        for name, d, fmt in (("npz", npz_dir, "h5"), ("epc_raw", ctrl_dir, "epc")):
            bridge[name] = bridge_from(d, fmt, os.path.join(root, f"bridge_{name}"))
            log(f"data: BRIDGeR from {name}: step ms "
                f"{[round(x, 2) for x in bridge[name]['step_ms']]}, run "
                f"{bridge[name]['run_s']:.1f} s [{card}]")
            check_counts(f"BRIDGeR, {n_train} steps and {n_val} validation batches from "
                         f"{name} [{card}]", bridge[name]["launches"],
                         {"K1": 2 * DINOV2_SMALL.num_layers * (n_train + n_val)})
        res["bridge"] = bridge
        res["bridge_epc_vs_npz"] = same_losses("BRIDGeR from the raw .epc against npz",
                                               bridge["epc_raw"], bridge["npz"])
        marks["train_s"] = time.perf_counter() - t1

        # 10. dataset statistics
        t1 = time.perf_counter()
        stats = {}
        for name, (r, fmt) in (("npz", (npz_root, "h5")), ("epc_raw", (epc_root["raw"], "epc"))):
            stats[name] = ST.process_dataset(
                DataConfig(data_root=r, dataset_names=(DATA_DATASET,), data_format=fmt),
                os.path.join(root, f"stats_{name}.json"))[DATA_DATASET]
        if stats["npz"] != stats["epc_raw"] or not stats["npz"]["num_steps"]:
            raise AssertionError("dataset statistics from .epc differ from npz")
        res["stats_num_steps"] = stats["npz"]["num_steps"]
        marks["stats_s"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["marks"] = marks
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"data phase: {res['phase_s']:.1f} s ({json.dumps(marks)}) [{card}]")
    return res



# ---- the README's walkthroughs on the port ------------------------------------------

EXAMPLES_DIR = os.path.join(ROOT, "examples")
BRIDGE_H64 = 64                    # the reference's chunk: K2's first UNet level, four m16 tiles
# A float32 module attends through K1 on q, k, v rounded to bf16
# (ops/attention.py); JAX's default computes that attention in float32.  The
# walkthrough tick's RDT hidden states (its output layer starts at zero) and
# the BRIDGeR evaluation's refined actions, each against a run with float32
# plain attention: corr above this, the refined-action gate
# (REFINED_CORR_MIN).
F32_ATTN_CORR_MIN = REFINED_CORR_MIN


def example_module(name: str):
    """``examples/<name>.py`` imported as a module."""
    import importlib

    sys.path.insert(0, EXAMPLES_DIR)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(EXAMPLES_DIR)


@contextlib.contextmanager
def stage_clock(stages: dict):
    """Standard output passed through; the host seconds from each line that
    starts with "== " (a walkthrough's stage header) to the next one, or to
    the block's end, under that line's text."""
    class Clock:
        def __init__(self):
            self.head, self.t0, self.pending = None, time.perf_counter(), ""

        def close(self):
            if self.head is not None:
                stages[self.head] = round(time.perf_counter() - self.t0, 3)

        def write(self, text):
            sys.__stdout__.write(text)
            self.pending += text
            *lines, self.pending = self.pending.split("\n")
            for line in lines:
                if line.startswith("== "):
                    self.close()
                    self.head, self.t0 = line[3:].split(";")[0].strip(), time.perf_counter()
            return len(text)

        def flush(self):
            sys.__stdout__.flush()

    clock = Clock()
    with contextlib.redirect_stdout(clock):
        yield
    clock.close()


@contextlib.contextmanager
def k1_by_head_dim(by_d: dict):
    """K1's launches in the block counted by head dim into ``by_d`` (the
    wrapper's own count moves as always)."""
    from vla_touch_tpu_torch.ops import flash_attention as FA

    k1 = FA.flash_attention

    def counted(q, k, v, kv_mask=None, scale=None):
        before = counted.launches
        out = k1(q, k, v, kv_mask=kv_mask, scale=scale)
        if counted.launches > before:
            by_d[q.shape[-1]] = by_d.get(q.shape[-1], 0) + 1
        return out

    # the wrapper bumps the count of the function its module name holds
    counted.launches = 0
    try:
        with swapped(K1=counted):
            yield
    finally:
        k1.launches += counted.launches


def counted_and_checked(what: str, run) -> dict:
    """``run()`` once counted from 0, then once under :func:`checked_run`,
    which must see the same kernel calls, each within its tolerance of its
    plain version on its own operands."""
    zero_counts()
    run()
    need = {k: n for k, n in read_counts().items() if n}
    check_chk(what, checked_run(run), need)
    return need


def bridge_h64_refine(t, actions) -> dict:
    """BRIDGeR at its deployment width (down_dims 256/512/512), horizon 64,
    bf16: one full-width refine (10 SDE steps, stacked v/s) of the tick's
    64-step chunk through ``bridge_predict``, K2 120 launches, against the
    card's plain UNet path (corr > REFINED_CORR_MIN) and as a checked run;
    host ms p50 of 3."""
    import torch

    from vla_touch_tpu_torch.config import BridgeControllerConfig
    from vla_touch_tpu_torch.models.controllers import bridge as BR
    from vla_touch_tpu_torch.ops import marker_tracking as MT
    from vla_touch_tpu_torch.utils.image import imagenet_normalize

    inp, dev = t["inp"], torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(64)
    bcfg = BridgeControllerConfig(inference_dtype="bfloat16", horizon=BRIDGE_H64)
    bridge = BR.deployable(BR.init_bridge_controller(bcfg, seed=64, device=dev))
    stacked = BR.stacked_vs(bridge)
    with torch.inference_mode():
        feats = t["dino"](imagenet_normalize(inp["dino_frames"]).to(torch.bfloat16)).float()
    force = MT.estimate_force(inp["gel"], inp["baseline"])["force"]
    vla = torch.as_tensor(actions[:, :BRIDGE_H64], device=dev)
    noise = torch.randn((bcfg.interpolant.diffusion_steps, 1, BRIDGE_H64, 10), generator=gen,
                        device=dev)

    def refine():
        out = BR.bridge_predict(bcfg, bridge, t["stats"], inp["state10"], vla, feats[:1],
                                feats[1:], force[None], stacked=stacked, noise_seq=noise)
        torch.cuda.synchronize()
        return out

    refine()                                    # warm-up
    zero_counts()
    got = refine()
    counts = read_counts()
    check_counts("bridger horizon-64 refine", counts, {"K2": 120})
    with plain_kernels():
        want = refine()
    c = action_corr(t, got.float().cpu().numpy(), want.float().cpu().numpy())
    log(f"bridger horizon-64 refine: kernel vs plain corr {c:.6f} (min {REFINED_CORR_MIN})")
    if not (got.shape == (1, BRIDGE_H64, 10) and c > REFINED_CORR_MIN):
        raise AssertionError(f"bridger horizon-64 refine: shape {tuple(got.shape)}, corr {c}")
    check_chk("bridger horizon-64 checked refine", checked_run(refine), {"K2": 120})
    p50, runs = host_p50(refine, 3)
    with plain_kernels():
        plain_p50, _ = host_p50(refine, 1)
    return dict(corr=c, launches=counts["K2"], ms_p50=p50, ms=runs, plain_ms=plain_p50)


def final_hidden(model, run):
    """``run()``'s inputs to the policy's RDT output layer, every solver
    step stacked (that layer starts at zero, so a random policy's actions
    are 0 whatever its attention computes)."""
    import torch

    hs = []
    hook = model.rdt.model.final_ffn.register_forward_pre_hook(
        lambda m, a: hs.append(a[0].detach().float().cpu()))
    try:
        run()
    finally:
        hook.remove()
    return torch.stack(hs).numpy()


def refined_actions(run):
    """The refined actions that ``run()``'s BRIDGeR evaluation reports."""
    from vla_touch_tpu_torch.eval import bridge_test as BT

    got, report = [], BT.report

    def recorded_report(what, refined, *a, **kw):
        got.append(np.asarray(refined))
        return report(what, refined, *a, **kw)

    BT.report = recorded_report
    try:
        run()
    finally:
        BT.report = report
    return got[0]


def examples_phase(t, actions) -> dict:
    """The README's two walkthroughs through their own ``main`` on the card
    (``examples/torch_full_pipeline.py``, ``torch_planning_pipeline.py`` at
    its default 100 epochs), under ``build/examples`` (removed after): each
    stage's seconds, the launches by kernel and K1's by head dim (the full
    one's ViT D 12, ``rdt_tiny`` D 32, DinoV2 D 96; the planning one's CLIP
    D 8), ``tests/test_examples.py``'s assertions and a finite
    ``summary.json``; one walkthrough tick and one BRIDGeR evaluation batch
    as checked runs, and each against a run with float32 plain attention
    (F32_ATTN_CORR_MIN); then :func:`bridge_h64_refine`."""
    import shutil

    from vla_touch_tpu_torch.eval import bridge_test as BT
    from vla_touch_tpu_torch.models.encoders import dinov2_runtime as dino
    from vla_touch_tpu_torch.ops import flash_attention as FA
    from vla_touch_tpu_torch.runtime import policy as P
    from vla_touch_tpu_torch.runtime.control_loop import EpisodeReplay

    t0 = time.perf_counter()
    full_w, plan_w = example_module("torch_full_pipeline"), example_module(
        "torch_planning_pipeline")
    root = os.path.join(ROOT, "build", "examples")
    shutil.rmtree(root, ignore_errors=True)
    dino_cfg = dino._CONFIGS["dinov2-small"]
    res = {}
    try:
        # ---- the full walkthrough
        zero_counts()
        by_d, stages = {}, {}
        with k1_by_head_dim(by_d), stage_clock(stages):
            summary = full_w.main(os.path.join(root, "full"), device="cuda")
        counts = {k: n for k, n in read_counts().items() if n}
        with open(os.path.join(root, "full", "summary.json")) as f:
            written = json.load(f)
        nums = [v for ev in ("bridge_eval", "lstm_eval") for v in written[ev].values()
                if not isinstance(v, str)] + [written["replay_tracking_mse"]]
        if not (written == json.loads(json.dumps(summary)) and all(np.isfinite(nums))
                and written["replay_steps"] == 12
                and written["bridge_eval"]["num_samples"] == 12
                and written["bridge_eval"]["inference_dtype"] == "bfloat16"):
            raise AssertionError(f"full walkthrough: summary {written}")
        if not (set(counts) == {"K1", "K2"} and {12, 32, 96} <= set(by_d)
                and sum(by_d.values()) == counts["K1"]):
            raise AssertionError(f"full walkthrough: launches {counts}, K1 by D {by_d}")
        res["full"] = dict(stages_s=stages, launches=counts, k1_by_head_dim=by_d,
                           summary=written)
        log("examples: full walkthrough " + json.dumps(res["full"]))

        # ---- one walkthrough tick and one BRIDGeR evaluation batch, checked
        ep = EpisodeReplay(os.path.join(root, "full", "episodes", "episode_0.npz"))
        model = P.create_model(full_w.policy_config(), seed=0, device="cuda")
        obs = [ep.observation(9), ep.observation(10)]
        images = [im for o in obs for im in o.images]
        text = full_w.instruction()
        def tick():
            model.reset()                       # every frame encoded, as the first tick
            model.generator.manual_seed(0)
            return model.step(obs[1].state, images, text)

        def evaluate():
            return BT.test_diffusion_controller(
                os.path.join(root, "full", "bridge_ckpt", "final"),
                os.path.join(root, "full", "episodes"), num_samples=12, device="cuda")

        res["checked_tick"] = counted_and_checked("walkthrough checked tick", tick)
        res["checked_eval"] = counted_and_checked(
            "walkthrough checked bridger evaluation batch", evaluate)
        # the float32 towers' attention on K1 (q, k, v rounded to bf16)
        # against JAX's float32 attention (the plain version, no K1 launch)
        f32 = {}
        for what, run in (("tick_hidden", lambda: final_hidden(model, tick)),
                          ("eval_refined", lambda: refined_actions(evaluate))):
            got = run()
            k1 = FA.flash_attention.launches
            with plain_vision():
                want = run()
            if FA.flash_attention.launches != k1 or got.shape != want.shape:
                raise AssertionError(f"float32 attention {what}: K1 launched or shapes differ")
            f32[what] = corr(got, want)
        res["f32_attention_corr"] = f32
        log(f"examples: K1 on bf16-rounded q, k, v vs float32 plain attention: corr "
            f"{json.dumps(f32)} (min {F32_ATTN_CORR_MIN})")
        if not all(c > F32_ATTN_CORR_MIN for c in f32.values()):
            raise AssertionError(f"float32 attention: corr {f32}")
        dino._CONFIGS["dinov2-small"] = dino_cfg

        # ---- the planning walkthrough
        zero_counts()
        by_d, stages = {}, {}
        with k1_by_head_dim(by_d), stage_clock(stages):
            out = plan_w.main(os.path.join(root, "plan"), device="cuda")
        counts = {k: n for k, n in read_counts().items() if n}
        llm_out = os.path.join(root, "plan", "llm_out")
        with open(os.path.join(llm_out, "predictions.json")) as f:
            preds = json.load(f)
        with open(os.path.join(llm_out, "reason", "sorting_sponge.json")) as f:
            rec = json.load(f)[0]
        if not (len(preds) == 1 and isinstance(preds[0]["prediction"], str)
                and rec["final_true_answer"] == "A" and rec["reasoning_sampling_num"] == 4
                and os.path.exists(os.path.join(llm_out, "llm_training.jsonl"))
                and all(np.isfinite(out["losses"]))):
            raise AssertionError(f"planning walkthrough: predictions {preds}, record {rec}")
        if not (set(counts) == {"K1"} and set(by_d) == {8}):
            raise AssertionError(f"planning walkthrough: launches {counts}, K1 by D {by_d}")
        res["planning"] = dict(stages_s=stages, launches=counts, k1_by_head_dim=by_d,
                               loss_first_last=[out["losses"][0], out["losses"][-1]],
                               prediction=preds[0]["prediction"],
                               option_counts=rec["option_counts"])
        log("examples: planning walkthrough " + json.dumps(res["planning"]))
    finally:
        dino._CONFIGS["dinov2-small"] = dino_cfg
        shutil.rmtree(root, ignore_errors=True)

    # ---- BRIDGeR at full width over the 64-step chunk
    res["bridge_h64"] = bridge_h64_refine(t, actions)
    res["launches"] = {k: res["full"]["launches"].get(k, 0) + res["planning"]["launches"].get(k, 0)
                       + (res["bridge_h64"]["launches"] if k == "K2" else 0)
                       for k in ("K1", "K2")}
    res["phase_s"] = time.perf_counter() - t0
    return res


# ---- multi-device training and serving ----------------------------------------------

PAR_STEPS = 2                      # rdt_loop steps of each world-1 run
PAR_DEPTH = 2                      # RDT-1B / Qwen2.5-7B / T5-XXL blocks of the two-rank runs
PAR_TRAIN_STEPS = 2                # sharded steps of each two-rank mode
PAR_LR = 1e-4
PAR_DECODE = 8                     # planner tokens
PAR_T5_TOKENS = 32
# Two ranks against one process at bf16 compute.  Gates: every step's loss
# to RDT_LOSS_RTOL_BF16 (the card-vs-CPU bf16 gate of one step) and the
# grad norm to PAR_GNORM_RTOL against one process on the global batch; and
# the relative L2 of the parameters' update over the two steps.  Adam's
# first update is lr * sign(g) an element, so a gradient within the bf16
# noise of 0 moves by 2 lr whenever a GEMM rounds otherwise: one process
# with each micro-batch's rows in two micro-batches of half (DP2's row
# groups; on an H100, DP2 read 0.066 against the ungrouped update) is the
# noise floor.  DP2 modes: against that regrouped process, under
# PAR_UPDATE_REL (the same GEMMs; only the gradient sums' order differs);
# TP2 (other GEMMs: row-parallel partial sums): against the ungrouped
# process, under PAR_NOISE_FACTOR x the regrouped process's own distance
# from it (on the CPU in float32 at rdt_tiny, TP2 read 1.84 x).  TP
# serving: the chunk's corr above CHUNK_CORR_MIN.  T5 (the phase's T5
# scales, ``t5_phase_encoder``): the TP2 bf16 hidden states against a
# float32 copy, relative L2 under T5_REL_TOL, the gate that holds the
# unsharded bf16 encoder against float32 (TP reorders bf16 roundings; with
# lecun q the attention is near one-hot and a bf16 TP run read 0.039
# against unsharded bf16 on an H100).
PAR_GNORM_RTOL = 2e-3
PAR_UPDATE_REL = 1e-2
PAR_NOISE_FACTOR = 3.0
PAR_T5_REL = T5_REL_TOL
PAR_RANK_TIMEOUT_S = 400
PAR_DEVICE = "cuda:0"              # the two ranks share this card
# K1 at the two-rank runs' shapes (16 heads: TP2 of RDT-1B's 32): per TP2
# training step (batch 4 x accumulation 2, depth PAR_DEPTH: PAR_DEPTH self
# and PAR_DEPTH / 2 image and language cross-attentions a micro-batch), per
# TP2 serving chunk
# (B 1, 5 solver steps, the condition K/V once)
K1_TP_SHAPES = [
    ("tp_train_self", 4, 67, 67, 16, 64, "self", None, 2 * PAR_DEPTH),
    ("tp_train_image_cross", 4, 67, 4374, 16, 64, "cross", None, PAR_DEPTH),
    ("tp_train_lang_cross", 4, 67, 1024, 16, 64, "cross", "short", PAR_DEPTH),
    ("tp_serve_self", 1, 67, 67, 16, 64, "self", None, 5 * PAR_DEPTH // 2),
    ("tp_serve_image_cross", 1, 67, 4374, 16, 64, "cross", None, 5 * PAR_DEPTH // 4),
    ("tp_serve_lang_cross", 1, 67, 1024, 16, 64, "cross", "short", 5 * PAR_DEPTH // 4),
]
K1_STEP_ROWS.update({n: ("tp_train_step" if "train" in n else "tp_chunk")
                     for n, *_ in K1_TP_SHAPES})


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def record_rdt_loop(argv: list) -> dict:
    """``rdt_loop.main(argv)`` (what ``python -m
    vla_touch_tpu_torch.train.rdt_loop`` runs) with each step's loss, grad
    norm, host ms and K1 launches recorded; the final checkpoint (RDT-1B:
    19.65 GB) taken through ``save_checkpoint`` with the files it would
    write recorded, not written (``meta.json`` is written), and its state
    left on the card.  The counts start at 0."""
    import torch

    from vla_touch_tpu_torch.ops import flash_attention as FA
    from vla_touch_tpu_torch.train import rdt_loop as RL
    from vla_touch_tpu_torch.train import rdt_train as T
    from vla_touch_tpu_torch.utils import checkpoint as ckpt

    steps, saved, files = [], [], []
    step, save = RL.RDTTrainer.step, RL.RDTTrainer.save_checkpoint
    writers = (ckpt.save_pytree, ckpt.save_pytree_orbax, T.gather_train_state)

    def recorded_step(self, state, batch, vision, generator=None):
        torch.cuda.synchronize()
        k, t1 = FA.flash_attention.launches, time.perf_counter()
        out = step(self, state, batch, vision, generator)
        m = out[1]
        steps.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                          ms=1e3 * (time.perf_counter() - t1),
                          k1=FA.flash_attention.launches - k))
        return out

    def recorded_save(self, state, s):
        saved.append(s)
        return save(self, state, s)

    def record(path, tree, **kw):
        files.append(os.path.basename(path))
        return 0

    RL.RDTTrainer.step, RL.RDTTrainer.save_checkpoint = recorded_step, recorded_save
    ckpt.save_pytree = ckpt.save_pytree_orbax = record
    T.gather_train_state = lambda state, to_host=True: writers[2](state, to_host=False)
    try:
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        state = RL.main(argv)
        run_s = time.perf_counter() - t1
    finally:
        RL.RDTTrainer.step, RL.RDTTrainer.save_checkpoint = step, save
        ckpt.save_pytree, ckpt.save_pytree_orbax, T.gather_train_state = writers
    res = dict(steps=steps, saved=saved, files=files, run_s=run_s, launches=read_counts(),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               zero3=bool(state.plan is not None and state.plan.zero3),
               sharded=state.plan is not None)
    return res


def par_batch(m, tcfg, device, seed: int = 5) -> tuple:
    """A seeded global (accumulation, rows, ...) batch at RDT-1B's widths
    (the language padded to 1024 with RDT_LANG_LEN valid tokens, SigLIP's
    4374 bf16 image tokens) and its draws, made on the card."""
    import torch

    from vla_touch_tpu_torch.models.rdt import runner as R

    g = torch.Generator(device=device).manual_seed(seed)
    A, B = tcfg.grad_accum, tcfg.batch_size

    def rn(*s, dtype=torch.float32):
        return torch.randn((A, B) + s, generator=g, device=device).to(dtype)

    mask = torch.zeros((A, B, m.max_lang_cond_len), dtype=torch.bool, device=device)
    mask[..., :RDT_LANG_LEN] = True
    batch = dict(lang_tokens=rn(m.max_lang_cond_len, m.lang_token_dim), lang_mask=mask,
                 img_tokens=rn(m.img_cond_len, m.img_token_dim, dtype=torch.bfloat16),
                 state_tokens=rn(1, m.state_token_dim), action_gt=rn(m.horizon, m.output_dim),
                 action_mask=(torch.rand((A, B, 1, m.output_dim), generator=g,
                                         device=device) > 0.3).float(),
                 ctrl_freqs=torch.full((A, B), 25.0, device=device))
    d = R.loss_draws(R.RDTRunnerConfig(model=m), (A * B, m.horizon, m.output_dim), device, g)
    draws = {"noise": d["noise"].reshape(A, B, m.horizon, m.output_dim),
             "timesteps": d["timesteps"].reshape(A, B)}
    return batch, draws


def par_orbax(rank: int, d: str, rcfg, tcfg, state, full, step_fn, batch, draws, b, dr,
              device) -> dict:
    """The DP2 ZeRO-3 state after PAR_TRAIN_STEPS steps as ``state.orbax``
    (``RDTTrainer.save_checkpoint`` at world 2: each rank its own shards,
    nothing gathered), synchronously, then with ``async_save`` while the
    uninterrupted run takes its next two steps; the synchronous one
    resumed by one process (rank 0: the gathered ``full`` parameters bit
    for bit) and the asynchronous one at DP1 x TP2 (each rank reading the
    chunks its regions overlap), each for the same two steps, their losses
    against the uninterrupted run's to RDT_LOSS_RTOL_BF16."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from vla_touch_tpu_torch.config import DataConfig
    from vla_touch_tpu_torch.parallel import launch
    from vla_touch_tpu_torch.parallel import mesh as mesh_lib
    from vla_touch_tpu_torch.train import rdt_loop as RL
    from vla_touch_tpu_torch.train import rdt_train as T
    from vla_touch_tpu_torch.utils import checkpoint as ckpt
    from vla_touch_tpu_torch.utils import from_flax as FF
    from vla_touch_tpu_torch.utils import ocdbt

    def trainer(name, t, mesh):
        tr = RL.RDTTrainer(rcfg, t, DataConfig(), os.path.join(d, name), device=device,
                           mesh=mesh)
        tr.optimizer = T.make_optimizer(t, state.module)
        return tr

    def shard_bytes(st, opt):
        def size(tree):
            if isinstance(tree, dict):
                return sum(size(v) for v in tree.values())
            return tree.local.numel() * tree.local.element_size() \
                if isinstance(tree, ckpt.Shard) else 0
        trees = FF.rdt_train_state_shards(st, opt)
        return sum(size(trees[k]) for k in ("params", "ema", "opt_state"))

    def losses(run):
        out = []
        for _ in range(2):
            _, m = run()
            out.append(float(m["loss"]))
        return out

    step = PAR_TRAIN_STEPS
    res = {}
    sync = trainer("orbax_sync", tcfg, state.plan.mesh)
    res["shard_bytes"] = shard_bytes(state, sync.optimizer)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res["write_bytes"] = sync.save_checkpoint(state, step)["state.orbax"]
    res["write_s"] = time.perf_counter() - t1
    res["write_gb_s"] = res["shard_bytes"] / res["write_s"] / 1e9
    sync_path = os.path.join(d, "orbax_sync", f"checkpoint-{step}")

    asy = trainer("orbax_async", dataclasses.replace(tcfg, async_save=True), state.plan.mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    asy.save_checkpoint(state, step)
    res["async_return_s"] = time.perf_counter() - t1
    in_flight = os.path.exists(os.path.join(asy.output_dir, f"checkpoint-{step}", "meta.json"))
    k1 = kernel_fns()["K1"].launches
    res["after"] = losses(lambda: step_fn(state, b, draws=dr))
    res["k1_after"] = kernel_fns()["K1"].launches - k1
    asy._wait_ckpt()
    res["async_s"] = time.perf_counter() - t1
    async_path = os.path.join(d, "orbax_async", f"checkpoint-{step}")
    res["async_bytes"] = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(
        os.path.join(async_path, "state.orbax", f"ocdbt.process_{rank}")) for f in fs)
    if in_flight or sorted(os.listdir(async_path)) != ["meta.json", "state.orbax"]:
        raise AssertionError(f"rank {rank}: async checkpoint {os.listdir(async_path)}, "
                             f"meta before the steps: {in_flight}")
    dist.barrier()

    # the asynchronous checkpoint at DP1 x TP2, each rank its regions
    mesh = mesh_lib.make_mesh(1, 2)
    t_tp = dataclasses.replace(tcfg, zero3=False)
    step_tp, plan = T.make_sharded_train_step(mesh, rcfg, t_tp)
    st = T.shard_train_state(mesh, T.init_train_state(rcfg, t_tp, 1, device), plan)
    tp = trainer("orbax_tp2", t_tp, mesh)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st = tp.load_checkpoint(st, async_path)
    torch.cuda.synchronize()
    res["resume_s"] = time.perf_counter() - t1
    res["resume_bytes"] = shard_bytes(st, tp.optimizer)
    res["resume_gb_s"] = res["resume_bytes"] / res["resume_s"] / 1e9
    res["chunks_read"] = tp.load_stats["chunks_read"]
    res["chunks_overlapped"] = tp.load_stats["chunks_overlapped"]
    with ocdbt.Database(os.path.join(async_path, "state.orbax")) as db:
        res["chunks_total"] = sum(not k.endswith(b"/.zarray") for k in db)
    b_tp = launch.host_local_batch(mesh, batch, spec=(None, "data"), device=device)
    dr_tp = launch.host_local_batch(mesh, draws, spec=(None, "data"), device=device)
    k1 = kernel_fns()["K1"].launches
    res["resumed_tp2"] = losses(lambda: step_tp(st, b_tp, draws=dr_tp))
    res["k1_resumed"] = kernel_fns()["K1"].launches - k1
    del st, step_tp, plan, b_tp, dr_tp
    torch.cuda.empty_cache()
    if rank == 0:
        # the synchronous checkpoint in one process, read whole
        t_one = dataclasses.replace(tcfg, zero3=False)
        one = trainer("orbax_one", t_one, None)
        back = one.load_checkpoint(T.init_train_state(rcfg, t_one, 1, device), sync_path)
        if any(not torch.equal(back.params[n], p) for n, p in full["params"].items()):
            raise AssertionError("two-rank ZeRO-3 state.orbax: read back unequal")
        res["resumed_one"] = losses(lambda: T.train_step(rcfg, t_one, back, batch,
                                                         draws=draws))
        del back
        torch.cuda.empty_cache()
    dist.barrier()
    res["loss_rel"] = {k: [abs(a - w) / abs(w) for a, w in zip(res[k], res["after"])]
                       for k in ("resumed_tp2", "resumed_one") if k in res}
    if max(x for v in res["loss_rel"].values() for x in v) > RDT_LOSS_RTOL_BF16:
        raise AssertionError(f"rank {rank}: resumed losses against the uninterrupted run's: "
                             f"{res}")
    if not (res["chunks_read"] == res["chunks_overlapped"] < res["chunks_total"]):
        raise AssertionError(f"rank {rank}: TP2 resume read {res['chunks_read']} chunks, "
                             f"its regions overlap {res['chunks_overlapped']} of "
                             f"{res['chunks_total']}")
    log(f"rank {rank} state.orbax: wrote {res['write_bytes']} bytes ({res['shard_bytes']} "
        f"bytes of shards) in {res['write_s']:.2f} s ({res['write_gb_s']:.2f} GB/s); async: "
        f"returned after {res['async_return_s']:.2f} s, landed after {res['async_s']:.2f} s "
        f"with two steps in flight, {res['async_bytes']} bytes; TP2 resume "
        f"{res['resume_s']:.2f} s for {res['resume_bytes']} bytes "
        f"({res['resume_gb_s']:.2f} GB/s), chunks read {res['chunks_read']} of the "
        f"{res['chunks_overlapped']} its regions overlap ({res['chunks_total']} in the "
        f"checkpoint); losses after {res['after']}, resumed at TP2 {res['resumed_tp2']}"
        + (f", in one process {res['resumed_one']}" if "resumed_one" in res else ""))
    return res


def par_train_modes(rank: int, d: str, device) -> dict:
    """The two-rank RDT-1B steps (depth PAR_DEPTH, full width, batch 4 x
    accumulation 2): one process's train_step (rank 0), then DP2 ZeRO-2,
    DP2 ZeRO-3 (its state written as state.orbax by both ranks and resumed:
    ``par_orbax``) and TP2, each from the same seeded state, against it."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from vla_touch_tpu_torch.config import DataConfig, TrainConfig, rdt_1b
    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.parallel import launch
    from vla_touch_tpu_torch.parallel import mesh as mesh_lib
    from vla_touch_tpu_torch.train import rdt_loop as RL
    from vla_touch_tpu_torch.train import rdt_train as T

    m = rdt_1b(depth=PAR_DEPTH)
    rcfg = R.RDTRunnerConfig(model=m)
    tcfg = TrainConfig(batch_size=4, grad_accum=2, lr_warmup_steps=0, learning_rate=PAR_LR)
    batch, draws = par_batch(m, tcfg, device)
    p0 = {n: p.detach().clone() for n, p in
          R.init_rdt_train(rcfg, 0, device).named_parameters()}

    def one_process(b, dr):
        st = T.init_train_state(rcfg, tcfg, 0, device)
        metrics = []
        for _ in range(PAR_TRAIN_STEPS):
            st, mt = T.train_step(rcfg, tcfg, st, b, draws=dr)
            metrics.append((float(mt["loss"]), float(mt["grad_norm"])))
        return dict(metrics=metrics, params={n: p.detach().clone()
                                             for n, p in st.params.items()})

    def halves(t):
        return t.reshape((2 * t.shape[0], t.shape[1] // 2) + tuple(t.shape[2:]))

    def update_rel(params, want):
        num = den = 0.0
        for n, p in params.items():
            du, dw = p.float() - p0[n].float(), want[n].float() - p0[n].float()
            num += float((du - dw).square().sum())
            den += float(dw.square().sum())
        return (num / max(den, 1e-30)) ** 0.5

    res, ref = {}, None
    if rank == 0:
        ref = one_process(batch, draws)
        grouped = one_process({k: halves(v) for k, v in batch.items()},
                              {k: halves(v) for k, v in draws.items()})
        res["regrouped_update_rel_l2"] = update_rel(grouped["params"], ref["params"])
        torch.cuda.empty_cache()
    dist.barrier()
    for mode, shape, zero3 in (("dp2_zero2", (2, 1), False), ("dp2_zero3", (2, 1), True),
                               ("tp2", (1, 2), False)):
        mesh = mesh_lib.make_mesh(*shape)
        t = dataclasses.replace(tcfg, zero3=zero3)
        step_fn, plan = T.make_sharded_train_step(mesh, rcfg, t)
        state = T.shard_train_state(mesh, T.init_train_state(rcfg, t, 0, device), plan)
        b = launch.host_local_batch(mesh, batch, spec=(None, "data"), device=device)
        dr = launch.host_local_batch(mesh, draws, spec=(None, "data"), device=device)
        metrics, ms = [], []
        k1 = kernel_fns()["K1"].launches
        for _ in range(PAR_TRAIN_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, mt = step_fn(state, b, draws=dr)
            metrics.append((float(mt["loss"]), float(mt["grad_norm"])))
            ms.append(1e3 * (time.perf_counter() - t1))
        row = dict(metrics=metrics, step_ms=ms, k1=kernel_fns()["K1"].launches - k1)
        full = T.gather_train_state(state, to_host=False)
        if rank == 0:
            row["update_rel_l2"] = update_rel(full["params"], ref["params"])
            row["loss_rel"] = [abs(a[0] - w[0]) / abs(w[0]) for a, w in
                               zip(metrics, ref["metrics"])]
            row["grad_norm_rel"] = [abs(a[1] - w[1]) / abs(w[1]) for a, w in
                                    zip(metrics, ref["metrics"])]
            if shape[0] == 2:
                row["update_rel_l2_regrouped"] = update_rel(full["params"], grouped["params"])
                update_ok = row["update_rel_l2_regrouped"] <= PAR_UPDATE_REL
            else:
                update_ok = (row["update_rel_l2"]
                             <= PAR_NOISE_FACTOR * res["regrouped_update_rel_l2"])
            if (not update_ok or max(row["loss_rel"]) > RDT_LOSS_RTOL_BF16
                    or max(row["grad_norm_rel"]) > PAR_GNORM_RTOL):
                raise AssertionError(f"two-rank {mode} against one process: {row}")
        if zero3:
            row["orbax"] = par_orbax(rank, d, rcfg, t, state, full, step_fn, batch, draws,
                                     b, dr, device)
        if mode == "tp2":
            # K1 on the TP step's own operands (16 heads a rank)
            need = {"K1": row["k1"] // PAR_TRAIN_STEPS}
            check_chk(f"rank {rank} TP2 checked step",
                      checked_run(lambda: step_fn(state, b, draws=dr)), need)
        res[mode] = row
        log(f"rank {rank} {mode}: " + json.dumps(row))
        del state, b, dr, step_fn, plan, full
        torch.cuda.empty_cache()
    return res


def par_serving(rank: int, device) -> dict:
    """TP2 ``rdt_predict_action`` on bf16 RDT-1B blocks (depth PAR_DEPTH)
    against the same module unsharded."""
    import torch

    from vla_touch_tpu_torch.config import rdt_1b
    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.parallel import mesh as mesh_lib
    from vla_touch_tpu_torch.parallel import tp as tp_lib

    m = rdt_1b(depth=PAR_DEPTH)
    rcfg = R.RDTRunnerConfig(model=m)
    module = R.init_rdt(rcfg, 0, device)
    g = torch.Generator(device=device).manual_seed(9)
    bf16 = torch.bfloat16
    # the zero-initialised head would make every chunk the same
    fc2 = module.model.final_ffn.fc2.weight
    fc2.copy_(0.02 * torch.randn(fc2.shape, generator=g, device=device))

    def rn(*s):
        return torch.randn(s, generator=g, device=device)

    mask = torch.zeros((1, m.max_lang_cond_len), dtype=torch.bool, device=device)
    mask[:, :RDT_LANG_LEN] = True
    args = (rn(1, m.max_lang_cond_len, m.lang_token_dim).to(bf16), mask,
            rn(1, m.img_cond_len, m.img_token_dim).to(bf16), rn(1, 1, m.state_token_dim),
            torch.ones((1, 1, m.output_dim), device=device), torch.full((1,), 25.0, device=device))
    noise = rn(1, m.horizon, m.output_dim)
    want = R.rdt_predict_action(rcfg, module, *args, init_noise=noise)
    k = kernel_fns()["K1"].launches
    tp_lib.shard_rdt_tp_(module, mesh_lib.make_mesh(1, 2))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = R.rdt_predict_action(rcfg, module, *args, init_noise=noise)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t1)
    k = kernel_fns()["K1"].launches - k
    c = corr(got.float().cpu(), want.float().cpu())
    if not (np.isfinite(c) and c > CHUNK_CORR_MIN):
        raise AssertionError(f"TP2 serving chunk corr {c} (min {CHUNK_CORR_MIN})")
    check_chk(f"rank {rank} TP2 checked chunk", checked_run(
        lambda: R.rdt_predict_action(rcfg, module, *args, init_noise=noise)), {"K1": k})
    return dict(chunk_corr=c, max_abs=float((got - want).abs().max()), ms=ms, k1=k)


def par_planner(device) -> dict:
    """Qwen2.5-7B's widths (4 layers, the full vocabulary, bf16): TP2
    greedy decode against the unsharded tree's."""
    import dataclasses

    import torch

    from vla_touch_tpu_torch.parallel import mesh as mesh_lib
    from vla_touch_tpu_torch.planning import llm as L

    cfg = dataclasses.replace(L.qwen25_7b(), num_layers=PAR_DEPTH)
    tree = L.init_llm(cfg, 0, device, dtype=torch.bfloat16)
    g = torch.Generator(device=device).manual_seed(3)
    prompt = (torch.randn((1, 24, cfg.hidden_size), generator=g, device=device)
              * 0.02).to(torch.bfloat16)
    want, went, _ = L.greedy_generate(cfg, tree, prompt, max_new_tokens=PAR_DECODE, eos_id=-1)
    sharded = L.shard_llm_params(mesh_lib.make_mesh(1, 2), tree)
    del tree
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok, ent, _ = L.greedy_generate(cfg, sharded, prompt, max_new_tokens=PAR_DECODE, eos_id=-1)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t1)
    if not torch.equal(tok, want):
        raise AssertionError(f"TP2 planner tokens {tok.tolist()} != {want.tolist()}")
    return dict(tokens=tok.tolist(), entropy_max_rel=float(((ent - went).abs()
                                                          / went.abs().clamp_min(1e-6)).max()),
                decode_ms=ms)


def par_t5(device) -> dict:
    """T5-XXL's widths (4 layers, bf16, ``t5_phase_encoder``'s scales): TP2
    encode of PAR_T5_TOKENS tokens against a float32 copy on the card,
    beside the unsharded bf16 module's error."""
    import dataclasses

    import torch

    from vla_touch_tpu_torch.models.encoders import t5_native as T5
    from vla_touch_tpu_torch.parallel import mesh as mesh_lib

    cfg = dataclasses.replace(T5.t5_v1_1_xxl(), num_layers=PAR_DEPTH)
    module = t5_phase_encoder(cfg, 0, device)
    with torch.device("meta"):
        ref = T5.T5Encoder(cfg)
    ref = ref.to_empty(device=device).requires_grad_(False)
    ref.load_state_dict({k: v.float() for k, v in module.state_dict().items()})
    g = torch.Generator(device=device).manual_seed(4)
    ids = torch.randint(0, cfg.vocab_size, (1, PAR_T5_TOKENS), generator=g, device=device)
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        want = T5.t5_encode(cfg, ref, ids, mask)
        one = rel_l2(T5.t5_encode(cfg, module, ids, mask), want)
    del ref
    T5.shard_t5_(module, mesh_lib.make_mesh(1, 2))
    with torch.inference_mode():
        got = T5.t5_encode(cfg, module, ids, mask)
    rel = rel_l2(got, want)
    if not rel <= PAR_T5_REL:
        raise AssertionError(f"TP2 T5 encode (bf16) against float32: rel L2 {rel} (max "
                             f"{PAR_T5_REL}; one process {one})")
    return dict(rel_l2=rel, one_process_rel_l2=one)


def parallel_rank(rank: int, world: int, d: str) -> int:
    """One of the two ranks sharing ``cuda:0`` over Gloo (NCCL refuses two
    ranks on one card): the sharded training modes, TP serving, the
    planner's and T5's TP; its report in ``d/rank<rank>.json``."""
    import torch

    sys.path.insert(0, ROOT)
    from vla_touch_tpu_torch.parallel import launch

    device = torch.device(PAR_DEVICE)
    launch.initialize(f"file://{os.path.join(d, 'store')}", world, rank, device=device,
                      backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    res = dict(rank=rank, train=par_train_modes(rank, d, device),
               serving=par_serving(rank, device), planner=par_planner(device),
               t5=par_t5(device))
    # the sharded paths' launches (not the one-process references')
    res["launches"] = {"K1": sum(r["k1"] + r.get("orbax", {}).get("k1_after", 0)
                                 + r.get("orbax", {}).get("k1_resumed", 0)
                                 for r in res["train"].values() if isinstance(r, dict))
                       + res["serving"]["k1"]}
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    launch.shutdown()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def run_ranks(world: int, d: str) -> list:
    """``world`` processes of :func:`parallel_rank`, started together; a
    rank that fails or hangs fails the phase."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                               str(r), str(world), d], cwd=ROOT)
             for r in range(world)]
    t0 = time.perf_counter()
    try:
        # a rank that fails leaves the others waiting in a collective
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.perf_counter() - t0 > PAR_RANK_TIMEOUT_S):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"parallel ranks exited {[p.returncode for p in procs]}")
    out = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def parallel_phase(gen) -> dict:
    """Multi-device training and serving (``parallel/``): K1 at the TP
    shapes against its plain version; RDT-1B (full depth and width) through
    ``rdt_loop``'s distributed flags at world 1 over NCCL, ZeRO-2 and then
    ``--zero3``, PAR_STEPS steps each, against the one-device trainer on the
    same seed and data (losses and grad norms bit for bit, K1 a step
    asserted); then two ranks sharing the card over Gloo (depth cut to
    PAR_DEPTH): DP2 ZeRO-2, DP2 ZeRO-3 and TP2 training steps against one
    process, the ZeRO-3 state written as state.orbax by both ranks (no
    gather; sync and async) and resumed at TP2 and in one process, TP2
    serving, a checked TP2 step and chunk, the planner's TP2 greedy decode
    and T5's TP2 encode.  The world-1 runs' final checkpoints take the
    msgpack route."""
    import gc
    import shutil

    import torch

    from vla_touch_tpu_torch.config import TrainConfig, rdt_1b

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "parallel")
    shutil.rmtree(root, ignore_errors=True)
    res = {}
    try:
        tp_rows, tp_tot = check_k1(gen, K1_TP_SHAPES)
        res["k1_tp_rows"] = tp_rows
        res["k1_tp"] = {k: tp_tot[k] for k in ("tp_train_step", "tp_chunk")}
        rdt_episodes(os.path.join(root, "data", "mango_hdf5_gelsight"))
        args = ["--data_root", os.path.join(root, "data"), "--max_train_steps",
                str(PAR_STEPS), "--sample_period", "1000000", "--checkpointing_period",
                "1000000", "--lr_warmup_steps", "0", "--dataloader_num_workers", "2",
                "--seed", "0"]
        need = rdt_k1_need(rdt_1b(), TrainConfig(), 27)["step"]
        need3 = rdt_k1_need(rdt_1b(remat_blocks=True), TrainConfig(), 27)["step"]
        ref = record_rdt_loop(args + ["--output_dir", os.path.join(root, "one")])
        gc.collect()
        torch.cuda.empty_cache()
        runs = {}
        for mode, extra in (("world1_zero2", []), ("world1_zero3", ["--zero3"])):
            # in this process: rdt_loop starts the NCCL group and destroys it
            r = runs[mode] = record_rdt_loop(
                args + ["--output_dir", os.path.join(root, mode), "--coordinator",
                        f"127.0.0.1:{free_port()}", "--num_processes", "1", "--process_id",
                        "0", *extra])
            gc.collect()
            torch.cuda.empty_cache()
            k1 = [s["k1"] for s in r["steps"]]
            want_k1 = need3 if extra else need
            same = [(s["loss"], s["grad_norm"]) for s in r["steps"]] == [
                (s["loss"], s["grad_norm"]) for s in ref["steps"]]
            log(f"parallel {mode}: losses {[s['loss'] for s in r['steps']]} grad norms "
                f"{[s['grad_norm'] for s in r['steps']]} (one device: "
                f"{[(s['loss'], s['grad_norm']) for s in ref['steps']]}); bit for bit {same}; "
                f"K1 a step {k1} (want {want_k1}); step ms "
                f"{[round(s['ms'], 1) for s in r['steps']]} (one device "
                f"{[round(s['ms'], 1) for s in ref['steps']]}); peak {r['peak_gib']:.2f} GiB "
                f"(one device {ref['peak_gib']:.2f}); run {r['run_s']:.1f} s")
            if not (r["sharded"] and r["zero3"] == bool(extra)):
                raise AssertionError(f"{mode}: rdt_loop did not take the sharded step")
            if not same:
                raise AssertionError(f"{mode}: losses / grad norms differ from one device")
            if k1 != [want_k1] * PAR_STEPS or r["saved"] != [PAR_STEPS]:
                raise AssertionError(f"{mode}: K1 a step {k1}, final save {r['saved']}")
            # world 1 writes msgpack, as the JAX trainer at one process
            if sorted(r["files"]) != ["ema.msgpack", "opt_state.msgpack", "params.msgpack"]:
                raise AssertionError(f"{mode}: the final checkpoint wrote {r['files']}")
        res["world1"] = dict(runs, one_device=ref)
        ranks = run_ranks(2, root)
        for rk in ranks:
            log(f"parallel rank {rk['rank']}: " + json.dumps(
                {k: rk[k] for k in ("train", "serving", "planner", "t5", "peak_gib")}))
            log(f"parallel rank {rk['rank']}: K1 launches {rk['launches']['K1']}")
        res["ranks"] = ranks
        res["launches"] = {"K1": runs["world1_zero2"]["launches"]["K1"]
                           + runs["world1_zero3"]["launches"]["K1"]
                           + sum(rk["launches"]["K1"] for rk in ranks)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t0
    log(f"parallel phase: {res['phase_s']:.1f} s; K1 launches {res['launches']['K1']}")
    return res


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vla_touch_tpu_torch.csrc import build

    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    # every phase's wall seconds, printed before the kernels line
    phase_s, since = {}, [t0]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = round(now - since[0], 1)
        since[0] = now

    build.build_all(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    kernel_ptxas()
    card = gpu_line()
    log(f"gpu: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    lap("build")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1_rows, k1 = check_k1(gen)
    k2_rows, k2 = check_k2(gen)
    k3_rows, k3 = check_q8(gen, "K3")
    k4_rows, k4 = check_q8(gen, "K4")
    k6_rows, k6 = check_qmm(gen, "K6")
    k8_rows, k8 = check_qmm(gen, "K8")
    k7_rows, k7 = check_qmm(gen, "K7", K7_SHAPES)
    k5_rows, k5 = check_qmm(gen, "K5", K5_SHAPES)
    lap("kernel_checks")

    # ---- the bf16 tick
    t = build_tick(seed=0)
    run_tick(t)                                  # warm-up (allocator, cuBLAS)
    zero_counts()
    out = run_tick(t)
    counts = read_counts()
    check_counts("bf16 tick", counts, {"K1": 319, "K2": 120})
    check_outputs(out)

    tok_k = siglip_tokens(t)
    with plain_kernels():
        tok_p = siglip_tokens(t)
        out_p = run_tick(t)
    c_tok = corr(tok_k, tok_p)
    c_chunk = action_corr(t, out["actions"], out_p["actions"])
    c_dino = corr(out["dino"], out_p["dino"])
    c_ref = action_corr(t, out["refined"], out_p["refined"])
    log(f"kernel vs plain tick: siglip token corr {c_tok:.6f} (min {TOKEN_CORR_MIN}), "
        f"chunk corr {c_chunk:.6f} (min {CHUNK_CORR_MIN}), dinov2 corr {c_dino:.6f} "
        f"(min {TOKEN_CORR_MIN}), refined corr {c_ref:.6f} (min {REFINED_CORR_MIN})")
    if not (c_tok > TOKEN_CORR_MIN and c_dino > TOKEN_CORR_MIN
            and c_chunk > CHUNK_CORR_MIN and c_ref > REFINED_CORR_MIN):
        raise AssertionError("kernel tick disagrees with the plain tick")
    check_chk("bf16 checked tick", checked_tick(t), {"K1": 319, "K2": 120})

    ticks = []
    for _ in range(3):
        t1 = time.perf_counter()
        run_tick(t)
        ticks.append(1e3 * (time.perf_counter() - t1))
    with plain_kernels():
        t1 = time.perf_counter()
        run_tick(t)
        plain_tick = 1e3 * (time.perf_counter() - t1)
    stages = {}
    for _ in range(3):
        run_tick(t, stage_ms=stages)
    log(f"cold tick p50 {np.median(ticks):.2f} ms (ticks {[round(x, 2) for x in ticks]}); "
        f"plain-version tick {plain_tick:.2f} ms")
    log("stage p50 ms (ticks with a synchronise after each stage): " + json.dumps(
        {k: round(float(np.median(v)), 3) for k, v in stages.items()}))
    prof = profile_tick(t)
    log("tick profile: " + json.dumps(prof))
    if not prof["groups_ms"]["K1 flash_combine_kernel"] > 0.0:
        raise AssertionError("the bf16 tick ran no K1 combine launch: no split call")

    lap("tick")

    # ---- the quantized tick
    q = quant_ticks(t, out["actions"])
    qa = dict(rdt=q["runners"]["int8"], kv_cache="int8")
    stages = {}
    for _ in range(3):
        run_tick(t, stage_ms=stages, **qa)
    log("quant tick (a) stage p50 ms (ticks with a synchronise after each stage): "
        + json.dumps({k: round(float(np.median(v)), 3) for k, v in stages.items()}))
    log("quant tick (a) profile: " + json.dumps(profile_tick(t, **qa)))
    log("quant tick (b) profile: " + json.dumps(
        profile_tick(t, rdt=q["runners"]["int8"], kv_cache="int8t")))
    log("quant ticks: " + json.dumps({k: v for k, v in q.items() if k != "runners"}))
    lap("quant_ticks")

    # ---- RDT-170M's cold tick, bf16 and (a)
    r170 = rdt170m_ticks(t)
    log("rdt170m ticks: " + json.dumps(r170))
    lap("rdt170m_ticks")

    # ---- the steady-state tick
    warm = warm_phase(t, q["runners"]["int8"])
    log("warm ticks: " + json.dumps(warm))
    lap("warm")

    # ---- the deployment entry points: the serving pool and the replay CLI
    t1 = time.perf_counter()
    serve = serving_phase(t, q["runners"]["int8"])
    log(f"serving phase: {time.perf_counter() - t1:.1f} s")
    log("serving: " + json.dumps({k: v for k, v in serve.items()}))
    lap("serving")
    t1 = time.perf_counter()
    rep = replay_phase(t)
    log(f"replay phase: {time.perf_counter() - t1:.1f} s")
    log("replay: " + json.dumps(rep))
    lap("replay")

    # ---- the encoders off the tick (T5-XXL into the tick, Sparsh), force
    # sequences and the warm-replan quality
    enc = encoders_phase(t, gen)
    log(f"encoders phase: {enc['phase_s']:.1f} s")
    log("encoders: " + json.dumps(enc))
    lap("encoders")

    # ---- the episode data path: capture, distillation with the tick's
    # policy, .epc caches, decode routes, training from .epc
    data = data_phase(t)
    log("data: " + json.dumps(data))
    lap("data")

    # ---- the README's walkthroughs on the card, and BRIDGeR over the
    # 64-step chunk at full width
    ex = examples_phase(t, out["actions"])
    log(f"examples phase: {ex['phase_s']:.1f} s")
    log("examples: " + json.dumps({k: ex[k] for k in ("checked_tick", "checked_eval",
                                                      "bridge_h64", "launches")}))
    lap("examples")
    del q["runners"], qa, t

    # ---- the residual controllers, trained and evaluated
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ctrl = controllers_phase()
    log(f"controllers phase: {time.perf_counter() - t1:.1f} s")
    log("controllers: " + json.dumps({k: v for k, v in ctrl.items()}))
    torch.cuda.empty_cache()
    lap("controllers")

    # ---- RDT finetuning
    t1 = time.perf_counter()
    rdt = rdt_train_phase()
    log(f"rdt_train phase: {time.perf_counter() - t1:.1f} s")
    log("rdt_train: " + json.dumps(rdt))
    lap("rdt_train")

    # ---- the planner, its LLM training on the same trees, then its VLM
    pl = planner_phase(gen)
    lap("planner")
    lt = llm_train_phase(pl.pop("P"), gen)
    torch.cuda.empty_cache()
    lap("llm_train")
    vl = vlm_phase(gen)
    torch.cuda.empty_cache()
    lap("vlm")

    # ---- the planner's tactile encoder, trained and evaluated
    te = tactile_encoder_phase(gen)
    gc.collect()
    torch.cuda.empty_cache()
    lap("tactile_encoder")

    # ---- multi-device training and serving
    par = parallel_phase(gen)
    log("parallel: " + json.dumps({k: par[k] for k in ("k1_tp", "launches", "phase_s")}))
    lap("parallel")
    for name, rows in (("k1", k1_rows), ("k2", k2_rows), ("k3", k3_rows), ("k4", k4_rows),
                       ("k5", k5_rows), ("k6", k6_rows), ("k7", k7_rows), ("k8", k8_rows),
                       ("k8 llm", pl["k8_llm_rows"]),
                       ("k6 llm", pl["k6_llm_rows"]),
                       ("k1 clip", pl["k1_clip_rows"]), ("k1 vlm", vl["k1_vlm_rows"]),
                       ("k1 sparsh", enc["sparsh"]["k1_sparsh_rows"]),
                       ("k1 tp", par["k1_tp_rows"]),
                       ("k9", list(pl["k9_rows"].values())),
                       ("k10", list(pl["k10_rows"].values()))):
        log(f"{name} shapes: " + json.dumps(rows))
    log("planner: " + json.dumps({k: pl[k] for k in ("counts", "calls", "feature_corr",
                                                     "k8_prompt",
                                                     "teacher_forced", "checked",
                                                     "checked_int8", "tiers",
                                                     "fastest", "best_of_8_ms")}))
    log("vlm: " + json.dumps({k: vl[k] for k in ("counts", "calls", "vision_corr",
                                                 "teacher_forced", "checked", "checked_int8",
                                                 "times", "session", "round_trip")}))
    log("tactile_encoder: " + json.dumps(te))
    log("llm_train: " + json.dumps(lt))

    def entry(name, source, replaces, launches, tot, **extra):
        return dict(name=name, route="cuda", source=f"vla_touch_tpu_torch/csrc/{source}",
                    replaces=f"vla_touch_tpu/{replaces}", launches=launches,
                    max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
                    bound_ms=tot["bound_ms"], bound_by=bound_by(tot),
                    library_ms=tot.get("library_ms"), **extra)

    # K1 runs on fifteen main paths, K2 on five: the cold tick, the serving
    # pool, the replay CLI, the controllers phase (training and evaluation),
    # RDT finetuning, the README's walkthroughs (and K2's horizon-64 refine),
    # RDT-170M's ticks
    # and (K1) the planner's VLM, its tactile encoder's
    # training and evaluation, its LLM training, the T5-embedded tick, Sparsh,
    # the warm-replan quality run, and the data path's distillation and its
    # RDT-1B and BRIDGeR training from .epc, each counted from 0; K3 on
    # quantized tick (a) of RDT-1B and of RDT-170M; K6 on those, the serving
    # pool's int8 batches and the VLM's int8
    # request; K8 on tick (e) and the VLM; K9 and K10 on the planner and the
    # VLM
    by_path = {k: {"tick": counts[k], "serving": serve["launches"][k],
                   "replay": rep["launches"][k], "controllers": ctrl["launches"][k],
                   "rdt_train": rdt["launches"][k]} for k in ("K1", "K2")}
    by_path["K1"]["vlm"] = vl["counts"]["K1"]
    by_path["K1"]["tactile_encoder"] = te["counts"]["K1"]
    by_path["K1"]["llm_train"] = lt["counts"].get("K1", 0)
    by_path["K1"]["t5_tick"] = enc["language"]["tick_launches"]["K1"]
    by_path["K1"]["sparsh"] = enc["sparsh"]["launches"]["K1"]
    by_path["K1"]["warm_quality"] = enc["warm_quality"]["launches"]["K1"]
    by_path["K1"]["data_distill"] = data["distill"]["launches"]["K1"]
    by_path["K1"]["data_rdt_epc"] = sum(data["rdt"][k]["launches"]["K1"]
                                        for k in ("epc_raw", "epc_jpeg"))
    by_path["K1"]["data_bridge_epc"] = data["bridge"]["epc_raw"]["launches"]["K1"]
    by_path["K1"]["parallel"] = par["launches"]["K1"]
    for k in ("K1", "K2"):
        by_path[k]["examples"] = ex["launches"][k]
        by_path[k]["rdt170m"] = sum(r170[c]["launches"][k] for c in ("bf16", "a"))
    by_path["K3"] = {"tick_a": q["a"]["launches"]["K3"], "rdt170m_a": r170["a"]["launches"]["K3"]}
    by_path["K6"] = {"tick_a": q["a"]["launches"]["K6"], "serving": serve["launches"]["K6"],
                     "replay": rep["launches"]["K6"], "vlm": vl["counts"]["K6"],
                     "rdt170m_a": r170["a"]["launches"]["K6"]}
    by_path["K8"] = {"tick_e": q["e"]["launches"]["K8"], "vlm": vl["counts"]["K8"],
                     "llm_train": lt["counts"].get("K8", 0)}
    for k in ("K9", "K10"):
        by_path[k] = {"planner": pl["counts"][k], "vlm": vl["counts"][k],
                      "llm_train": lt["counts"].get(k, 0)}
    kernels = [
        entry("flash_attention", "flash_attention.cu", "ops/pallas_attention.py:126",
              sum(by_path["K1"].values()), k1, launches_by_path=by_path["K1"],
              train_step=k1["train_step"], contrastive_step=k1["contrastive_step"],
              head_dims=k1["head_dims"]),
        entry("resblock_fused", "resblock.cu", "ops/pallas_unet.py:203",
              sum(by_path["K2"].values()), k2, launches_by_path=by_path["K2"],
              long_and_wide=k2["long"]),
        entry("flash_attention_q8", "flash_attention_q8.cu", "ops/pallas_attention.py:275",
              sum(by_path["K3"].values()), k3, launches_by_path=by_path["K3"],
              head_dims=k3["head_dims"]),
        entry("flash_attention_q8t", "flash_attention_q8.cu", "ops/pallas_attention.py:424",
              q["b"]["launches"]["K4"], k4, head_dims=k4["head_dims"]),
        # K5 and K7: no module dispatches them (0 launches on every main path
        # run above); their launches are the shadow calls of (f)'s checked tick
        entry("w8a16_matmul", "w8a16_matmul.cu", "ops/pallas_matmul.py:98",
              q["f"]["shadow_launches"]["K5"], k5),
        entry("a8w8_matmul", "a8w8_matmul.cu", "ops/pallas_matmul.py:192",
              sum(by_path["K6"].values()), k6, launches_by_path=by_path["K6"]),
        entry("a8w8_matmul_large", "a8w8_matmul_large.cu", "ops/pallas_matmul.py:272",
              q["f"]["shadow_launches"]["K7"], k7),
        entry("w4a8_matmul", "w4a8_matmul.cu", "ops/pallas_matmul.py:395",
              sum(by_path["K8"].values()), k8, launches_by_path=by_path["K8"],
              llm_train_step=llm_step_totals(pl["k8_llm_rows"], lt["rows"]["lora"][1]["tokens"]),
              llm_train_backward_ms=lt["lora"]["backward_ms"]["K8"]["ms"]),
        entry("w4_swiglu_mlp", "w4_swiglu.cu", "ops/pallas_matmul.py:648",
              sum(by_path["K9"].values()), planner_kernel_totals(pl, "K9"),
              launches_by_path=by_path["K9"],
              llm_train_backward_ms=lt["projector"]["backward_ms"]["K9"]["ms"]),
        entry("w4_postattn_fused", "w4_postattn.cu", "ops/pallas_matmul.py:858",
              sum(by_path["K10"].values()), planner_kernel_totals(pl, "K10"),
              launches_by_path=by_path["K10"]),
    ]
    phase_s["total"] = round(time.perf_counter() - t0, 1)
    log("phase seconds: " + json.dumps(phase_s))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
