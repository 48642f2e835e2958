#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each of which raises on failure (nothing is caught):

1. environment: the card's name and power limit; TF32 off for f32 matmuls
   and convolutions;
2. build: the five CUDA kernels from ``src/repro_torch/kernels/csrc`` (each
   library with its backward entry points, ``flash_attention.cu`` with B11's
   decode; ``adamw.cu``'s three) and an empty
   one-thread kernel (``launch_floor.cu``), one nvcc per source started
   together, for sm_90a, printing what ptxas reports;
3. kernels: the launch floor (the empty kernel's time, taken as the
   kernels' are); each kernel against its plain PyTorch version on the
   card, at the shapes the serving paths give it and at longer ones, with
   the kernel's, the plain version's and (where one PyTorch call computes
   the same function) a library call's times, and the least time the card
   could take; each rmsnorm case twice for bit-identical output, with its
   launch plan (route, grid, warps a block, rows a warp, load width), its
   share of the bound and its time above the launch floor, then the warp
   route's element-at-a-time form and its walks past one wave held untimed
   (rows one element off 16 bytes, strided rows, D 100 / 1001 / 2047, T 1
   to 6341); each ``moe_matmul`` case also with its launch plan (route,
   tiles, stages, grid, shared memory) and called twice for bit-identical
   output, each ``ssd_intra_chunk`` case with its launch plan; the cases
   include every shape that phase 4's ``hymba-1.5b`` runs give rmsnorm
   (d 1600 and the SSM's d_inner 3200), flash attention (H 25 / KV 5) and
   ``ssd_intra_chunk`` (50 heads, N 16), in bf16 and f32, every forward
   shape of phase 6's LM training (granite 4 x 256: moe_matmul at C 256;
   mamba2 and hymba 2 x 512: ``ssd_intra_chunk`` at Q 256 on four chunks),
   and the score, prefill and LM shapes of ``llama3-8b``, ``glm4-9b``,
   ``internvl2-1b`` and ``whisper-medium`` (rmsnorm at D 896, 1024 and
   4096; flash at GQA g 4, 7 and 16, head dim 128, and non-causal over
   whisper's 1500 frames); B11, attention over keys of their own length
   (whisper's decoder over its 1500 frames: prefill 4 x 128, LM 2 x 448, the
   decode-vs-forward checks, in bf16 and f32; tails S 1 and 65, Sk 1 and 63,
   GQA g 4 and 7, head dim 128), and its decode form over the FLAT
   [4, 1500, 1024] caches (bf16, f32, d 128, fewer keys than the cache,
   called twice for bit-identical output), each with its plan; the f32
   attention cases (flash at B4 H32 S160 causal, B4 H15 S1024, B2 H8 S1000
   d 128 and whisper's f32 encoder B4 H16 S1500, non-causal) run the
   split-TF32 route (``"tf32x3"``), each with its plan, and phase 5 holds
   their backward (the route's dq and dkdv) too; the f32 ``moe_matmul``
   cases (granite's LM gate/up and down, score, decode, a mesh rank's
   experts, ragged) run its split-TF32 route on ``wgmma`` (``"tf32x3"``)
   and the f32 ``ssd_intra_chunk`` cases its three-piece bf16 route
   (``"mma3"``); both routes' launches are counted apart in every run, every
   launch of an f32 run on them and none of a bf16 one;
4. serving at full width on seeded random bf16 weights.  Each path runs
   with the launch counts set to 0 just before it and checked just after
   against the counts its depth implies: greedy generation (4 requests x
   (128 prompt + 32 new)) with ``smollm-360m``, ``granite-moe-3b-a800m``,
   ``mamba2-130m``, the hybrid ``hymba-1.5b``, the dense ``llama3-8b`` and
   ``glm4-9b`` (built one at a time, each freed before the next), the vlm
   ``internvl2-1b`` (256 stub patch embeddings ahead of each prompt) and the
   encoder-decoder ``whisper-medium`` (over 1500 stub frames) through
   ``repro_torch.launch.serve``, each with the last decode step's logits
   held against a full forward over the same tokens (granite on a copy of
   its config whose capacity drops nothing; mamba2 and hymba also on an
   f32 copy of the weights; whisper's forward is ``encode`` and the
   teacher-forced ``decode_train`` over the same frames); scoring (8 x 160)
   with ``llama3.2-1b``, ``granite-moe-3b-a800m``, ``mamba2-130m``,
   ``hymba-1.5b``, ``llama3-8b``, ``glm4-9b`` and ``internvl2-1b`` (text
   only) through ``Engine.score``; the wall time of one prefill and one
   decode step of each generating model, and ``torch.profiler`` over one
   warm generation and one warm score call of each model (device busy
   share, device operations, the top kernels; for whisper the host's
   operations too, so that the device time of its cross-attention, B11's
   kernels inside the ``cross_attention`` profiler range, is read from the
   trace and printed beside its reading before B11, when it was plain
   PyTorch); every (kernel, shape) that the hymba runs and the four new
   models' runs launch is held against its plain version: by one of phase
   3's cases, or where no case covers it, at once on fresh inputs
   (``hold_at_shape``);
5. backward kernels: flash attention's dq and dk/dv kernels, B11's (keys of
   their own length: in bf16 its statistics pass and one pass, in f32 B5's
   kernels at Sk; GQA g 1, 4, 7, S and Sk ragged, d 64 and 128, the dQ
   partials in shared memory and in the global scratch, and timed at
   whisper's LM shape, twice bit-identical), RMSNorm's dx
   (a warp per row, and a block per row past D 2048) and dweight kernels,
   moe_matmul's dbuf and dw kernels (bf16 on ``wgmma`` fed by TMA, f32 on
   their split-TF32 route ``"tf32x3"``, rows that are not 16-byte aligned on
   CUDA-core FMAs; the f32 route's launches counted apart) and
   ``ssd_intra_chunk``'s kernel and
   reduce against autograd through their plain versions, over grids of
   types, head dims, masks, GQA groups, lengths, capacities, widths, state
   sizes, chunk lengths, zero, absent and non-zero chunk-state gradients and
   a strong decay, GQA g 1-16, timed at the training paths' shapes (the
   four new models' LM runs too) and longer ones
   beside their bounds, the plain versions and the library's gradient
   (``sdpa``, ``F.rms_norm``, ``torch.bmm``; none for the SSD), each timed
   kernel called twice for bit-identical results; then AdamW (B9): 41 leaves
   in two tables (every (param, grad) dtype pair, tails, a leaf 2 bytes off
   16 bytes) and the whole table of leaves of each of phases 6 and 7's
   training runs, laid out as they launch it, each held against the plain
   version in one step (given the same scalars p, m and v bit-identical,
   gnorm within 1e-6, two calls bit-identical; ``hold_adamw``, which makes
   each leaf again from its seed rather than keep a copy, so granite's 32
   layers fit), and each run's whole step timed (norm,
   finish and update apart) beside its bound, the plain version and
   ``torch._foreach_norm`` + ``torch._fused_adamw_``;
6. training at full width on seeded random bf16 weights, with exact launch
   counts: GRPO (the paper's loop without the control plane:
   ``smollm-360m`` generates 4 prompts x group 4, 128 prompt + 32 sampled
   tokens; ``llama3.2-1b`` scores them; group advantages; three
   ``make_grpo_step`` steps), checking that the positive-advantage
   sequences gain log-probability over the negative ones; and LM training
   through ``repro_torch.launch.train``, three steps each: ``llama3.2-1b``
   (4 x 256, through ``main``), and through ``trainer_from_config`` and ``train``
   ``granite-moe-3b-a800m`` (4 x 256 at full depth: AdamW updates its
   moments in place), ``mamba2-130m`` and
   ``hymba-1.5b`` (2 x 512: two SSD chunks a sequence, so the chunk-state
   gradient is live), ``internvl2-1b`` (4 x (256 patches + 256)),
   ``whisper-medium`` (2 x (1500 frames + 448), both at full depth) and
   ``llama3-8b`` and ``glm4-9b`` (4 x 256, 4 layers each), with finite
   losses (falling over the three steps for the last four); every optimizer
   step through the B9 kernels (the plain AdamW raises on a CUDA tensor
   through phase 7); one warm step of each profiled, with its peak memory and
   AdamW's device ms, beside the readings of the same step with the literal
   AdamW (whisper's with its cross-attention's device time, forward and
   backward, from the trace, beside its reading before B11);
   every step rematerialises its layers (the configs' ``remat``, as in JAX:
   each layer's forward kernels launch again in the backward, counted), and
   llama3.2-1b, granite, hymba and whisper also profile one warm step with
   remat off, printed beside the remat-on step (``[remat]`` lines: wall,
   device ms, busy share, peak memory); llama3.2-1b and whisper compare one
   step's gradients both ways (bit-identical or not, and the largest
   difference relative to each leaf's largest magnitude); every (kernel,
   shape) that these runs launch, under recompute too, is held against its
   plain version, by phases 3 and 5's cases or at once;
7. the closed loop at full width, as ``examples/agentic_rl_e2e.py`` runs it:
   three ``LiveGrpoDriver.run_step`` calls (``smollm-360m`` rolls out 4
   prompts x group 4, 8 + 16 sampled tokens; each of the 16 sequences is one
   ``llama3.2-1b`` judge action that Tangram schedules on its GPU pool, its
   measured wall the action's duration; one GRPO step), each on a fresh
   Tangram, with exact launch counts, all 16 actions finished and none
   failed, finite losses, and the measured walls replayed as fixed
   durations through a fresh Tangram that must decide the same (equal
   launch traces); per step its loss, mean reward, mean ACT, EOE hits and
   the rollout, reward and update walls; a fourth step, checked the same
   way, under ``torch.profiler`` for the device busy share of a step;
8. live mode (``repro_torch.core.live``): the ``live_smoke`` scenario (4
   pools x 6 actions) on real time, one CUDA stream per pool, each action's
   payload the RMSNorm kernel (f32 [64, 64]) launched from its pool's thread
   on its pool's stream until the action's scaled duration has passed;
   the live run's structural trace must equal the sim's, every launch is
   counted (per stream, and by the kernel's own counter), and each stream's
   last output is held against the plain version; the run is made under
   ``torch.profiler``, and the streams' overlap is printed twice: from the
   payloads' CUDA events (each action's first launch to its drain) and
   from the kernels the profiler saw.  Then the ``remote_round`` twin's three modes (serial, loopback, worker
   processes started by ``spawn``) with equal launch traces and their wire
   bytes, and the dense DP's ``backend="torch"`` scan on the card,
   bit-identical to the NumPy path;
9. agreement on a small input: nine reduced configs in f32 on the card
   against the same weights on the CPU (plain versions), serving; for
   ``smollm-360m``, one GRPO and one LM step's loss and gradients; for the
   reduced ``granite-moe-3b-a800m``, ``mamba2-130m``, ``hymba-1.5b``,
   ``internvl2-1b``, ``whisper-medium``, ``llama3-8b`` and ``glm4-9b``, one
   LM step's loss and gradients with its exact launch counts;
10. the multi-device layer (``[mesh]``): six gloo ranks on a (data 2, model 3)
   ``DeviceMesh``, all on the one card (``launch.mesh.run_ranks``; NCCL
   refuses two ranks on one device), serve ``granite-moe-3b-a800m`` (its
   drop-free copy, at 8 of its layers), ``llama3.2-1b``, ``mamba2-130m``,
   ``hymba-1.5b``, ``whisper-medium`` (over 1500 stub frames) and
   ``internvl2-1b`` (after 256 stub patches) at full width in bf16 and f32
   copies, and the reduced ``kimi-k2-1t-a32b``, through ``Engine`` with the
   rules; take one f32 train step each of the reduced granite (10 experts)
   and llama3.2-1b, and at full width of mamba2-130m, hymba-1.5b (8 of its
   layers), whisper-medium (4 + 4 layers over its frames) and internvl2-1b
   (4 of its layers), one bf16 train step each of granite (4 layers,
   drop-free), mamba2-130m and whisper-medium (4 + 4 layers), what each
   rank holds of each step's model reckoned and printed first, and one GRPO
   step (``make_grpo_step`` with the rules) of a reduced f32 llama3.2-1b
   policy (4 x 64, its rollout log-probs scored unsharded); each rank's
   launches must be ``path_launches``'s on the mesh (B4 and B8 on each
   rank's heads of mamba2's mixer, split over its heads, and on its batch
   block of hymba's, repeated, each printed with the heads B4 saw; B11's
   forward on its batch block, and in bf16 its own backward; no B11 decode
   where whisper's cross caches' rows are split), the parent holds the
   logits against the same weights unsharded on the card, rank 0 the losses
   and gradients (bf16 steps also against the f32 step on the same
   weights), every (kernel, shape) a rank launched is held against its plain
   version, and it prints each rank's peak memory, walls (gloo through one
   host: not multi-card speed) and collectives by kind (the optimizer's
   apart: one all-reduce a step; mamba2's beside its repeated mixer's);
   then the dry-run of granite's train_4k on the 16 x 16 mesh once.

It prints one JSON line of per-kernel numbers, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits with code 2 before building anything.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import os
import random
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack, nullcontext
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): the bounds below use them.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
TF32_TENSOR_FLOPS = 494.7e12
F32_FLOPS = 67e12  # CUDA-core FMAs

BF16_TOL = 2e-2
RMSNORM_F32_TOL = 1e-5
FLASH_F32_TOL = 2e-5
# B11's row log-sum-exp (f32, what its backward reads) against the plain one, relative
CROSS_LSE_TOL = 1e-5
F32_TOL = 1e-4  # moe_matmul and ssd_intra_chunk in f32 (tests/test_kernels.py)
# Backward kernels against autograd through the plain versions: max error
# relative to the reference gradient's largest magnitude, as
# tests/test_torch_gpu.py holds them.  bf16: one rounding step, 2**-8, and
# the reference rounds P, dS and its einsum outputs at other places.
# f32: summation order only, over at most 2048 terms (~3e-6 relative).
GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# A reference gradient that is exactly zero has no magnitude to be relative
# to: dq and dk at S = 1, where each query sees one key and the softmax
# passes no gradient.  The kernel's values there are the f32 rounding of
# dP - D, two sums of d products of unit-normal inputs (~1e-6), and are
# held to this absolute limit.  B11's dk at Sk = 1 (one key) sums that rounding over the
# S * g queries that read the key: its limit grows as their random walk, ZERO_GRAD_ABS *
# sqrt(S * g) (1.39e-5 was seen at S 65, g 4, d 128 in f32).
ZERO_GRAD_ABS = 1e-5
# Full-width serving, last decode step vs a full forward over the same
# tokens, absolute, on logits of at most ~3.5.  In bf16 the two paths round
# differently at every layer: dense, decode_attention (plain torch) against
# the flash kernel, both rounding the softmax weights to bf16, 0.043 seen
# on smollm-360m; moe, the same plus routing, 0.044-0.059 seen on granite's
# drop-free copy; for both the argmax must agree exactly.  ssm, the O(1)
# recurrence against the chunked scan, 1.120 seen on mamba2-130m with an
# ssd_intra_chunk kernel whose f32 arithmetic matched the plain version's
# bit for bit, 1.534 with the tensor-core kernel (split-bf16 products,
# ~1e-5 relative), on the same seeded weights: the two bf16 paths round
# differently and drift apart in the JAX reference too
# (tests/test_torch_ssm.py holds the port's drift to the reference's on the
# same weights), and 24 layers compound it.  Its limit is 1.5x the first
# reading, its argmax may differ only where the forward's top two lie
# within twice the error, and the same check runs again on an f32 copy of
# the weights, where only the summation order differs (4.1e-4 seen).
# hybrid, by the ssm rule: half of each layer is the same SSM, each branch
# normed before the fusion; 0.3525 was the first reading on hymba-1.5b
# (argmax 4/4; 9.3e-5 on the f32 copy), above the dense 0.1, so its limit
# is 1.5x that reading.
# vlm and audio: the dense rule (the vlm is the dense decoder after its patches; the audio
# decoder's cross-attention is one plain-PyTorch path in both, over the same encoder output).
SERVE_BF16_LOGIT_TOL = {"dense": 0.1, "vlm": 0.1, "audio": 0.1, "moe": 0.15, "ssm": 1.7,
                        "hybrid": 0.53}
# dense at d 4096, by the hybrid's rule: 0.336 (llama3-8b) and 0.376 (glm4-9b) were the first
# readings, above the dense 0.1, where f32 copies of the weights agreed to 8.3e-5 and 8.5e-5 and
# the same bf16 forward, batch 4 against each row alone (cuBLAS picks other kernels and summation
# orders), differed from itself by 0.290 and 0.357 (logits up to ~6.5).  Their limits are 1.5x
# the first readings; the argmax may differ only where the forward's top two lie within twice
# the error.
SERVE_BF16_MODEL_TOL = {"llama3-8b": 0.50, "glm4-9b": 0.56}
# The slice's models also hold an f32 copy of the weights to SERVE_F32_LOGIT_TOL, and print the
# bf16 forward's own noise (batch 4 against each row alone), which must stay within the model's
# bf16 limit.
SERVE_F32_LOGIT_TOL = 0.02
SSM_FAMILIES = ("ssm", "hybrid")  # bf16 decode runs the O(1) recurrence beside the chunked scan
# Reduced configs, f32, card vs CPU: summation order only.
SMALL_F32_TOL = 1e-3

PROMPT, NEW = 128, 32  # generation: 4 requests x (128 prompt + 32 new tokens)
HYBRID = "hymba-1.5b"  # phase 4 records every (kernel, shape) of its runs
SCORE_SHAPE = (8, 160)
PROMPTS, GROUP, GRPO_STEPS = 4, 4, 3  # GRPO: 4 prompts x group 4, three steps
# the closed loop, as examples/agentic_rl_e2e.py runs it: 4 prompts x group 4,
# 8-token prompts, 16 new tokens (LiveGrpoDriver's GenerationConfig), three steps
LOOP_PROMPTS, LOOP_GROUP, LOOP_PROMPT, LOOP_NEW, LOOP_STEPS = 4, 4, 8, 16, 3
# its kernel shapes: the rollout's prefill [N, 8] and decode rows [N, 1]; each
# judge action scores one whole sequence [1, 24]; old_logp and the GRPO step
# run on the N whole sequences [N, 24]
LOOP_N, LOOP_SEQ = LOOP_PROMPTS * LOOP_GROUP, LOOP_PROMPT + LOOP_NEW

# live mode (phase 8): live_smoke_spec's 4 pools x 6 actions (durations 0.6-1.62 s, three waves 2 s
# apart) compiled at this time scale, so that the run takes about 4 s of the phase
LIVE_TIME_SCALE = 0.5
LM_ARGS = ["--arch", "llama3.2-1b", "--full", "--steps", "3", "--batch", "4", "--seq", "256"]
# the other families' LM training, (arch, batch, seq, layers or None for full depth): the SSM
# families at 2 x 512, so that each sequence has two chunks of 256 and the backward's
# chunk-state gradient is live.  granite-moe-3b-a800m at full depth and width: AdamW updates
# its moments in place, so its 3.37 B parameters hold ~12 bytes each (bf16 weights and
# gradients, f32 moments), ~40 GB of the card's 80
LM_FAMILY_RUNS = (("granite-moe-3b-a800m", 4, 256, None), ("mamba2-130m", 2, 512, None),
                  ("hymba-1.5b", 2, 512, None))
# The remaining one-card models: the dense llama3-8b (32 H / 8 KV) and glm4-9b (32 H / 2 KV, GQA
# g 16), head dim 128 and d 4096; the vlm internvl2-1b (14 H / 2 KV, g 7; 256 stub patch
# embeddings ahead of each prompt); the audio whisper-medium (24 + 24 layers, 16 H, over 1500
# stub frames, its encoder_seq: one 30 s window).  (arch, seed) of each generate 4 x (128 + 32)
# and score 8 x 160 at full width; whisper-medium is not scored (the JAX package cannot score an
# encoder-decoder).  Every (kernel, shape) they launch must be one of phases 3 and 5's cases.
SLICE_GENERATE = (("llama3-8b", 14), ("glm4-9b", 15), ("internvl2-1b", 16), ("whisper-medium", 17))
SLICE_SCORE = (("llama3-8b", 18), ("glm4-9b", 19), ("internvl2-1b", 20))
# their LM training, three steps each, (arch, batch, text tokens, layers or None for full depth):
# internvl2-1b 4 x (256 patches + 256 tokens); whisper-medium 2 x (1500 frames + 448 tokens, its
# decoder_seq); llama3-8b and glm4-9b 4 x 256 at 4 of their 32 and 40 layers, widths published:
# at ~12 bytes a parameter their full depths' 8.0 and 9.4 B parameters would need 96-113 GB
SLICE_LM_RUNS = (("internvl2-1b", 4, 256, None), ("whisper-medium", 2, 448, None),
                 ("llama3-8b", 4, 256, 4), ("glm4-9b", 4, 256, 4))
SLICE = {arch for arch, _ in SLICE_GENERATE}
# the same one-card steps with the literal AdamW (new f32 moments each step, ~15 f32 passes a
# leaf): (device busy ms, max_memory_allocated GiB) under torch.profiler on an NVIDIA H100 80GB
# HBM3 at 700 W, as PERF.md section 5 records them; granite then trained 24 of its 32 layers
LITERAL_ADAMW_STEPS = {
    "grpo step smollm-360m": (54.70, 10.69),
    "lm step llama3.2-1b": (118.04, 28.11), "lm step llama3.2-1b remat off": (116.15, 28.11),
    "lm step granite-moe-3b-a800m": (296.32, 62.00),
    "lm step granite-moe-3b-a800m remat off": (283.56, 62.00),
    "lm step mamba2-130m": (35.69, 3.02),
    "lm step hymba-1.5b": (191.71, 35.94), "lm step hymba-1.5b remat off": (182.01, 35.93),
    "lm step internvl2-1b": (77.08, 13.78),
    "lm step whisper-medium": (161.90, 20.84), "lm step whisper-medium remat off": (144.27, 20.84),
    "lm step llama3-8b": (160.45, 40.29), "lm step glm4-9b": (171.27, 43.90),
}
# whisper-medium's cross-attention before B11 (plain PyTorch): (device ms inside the
# ``cross_attention`` profiler range, backward included, device busy ms of the call) under
# torch.profiler on an NVIDIA H100 80GB HBM3 at 700 W, as PERF.md section 5 records them
CROSS_RANGE_BEFORE = {"generate whisper-medium": (103.27, 224.00),
                      "lm step whisper-medium": (30.74, 95.00)}
# phase 6 trains with the layers rematerialised (every config's default, as in JAX); these
# models' LM steps are also profiled with remat off (llama3.2-1b's through the launcher), and
# these have one step's gradients compared both ways
REMAT_BOTH_WAYS = {"granite-moe-3b-a800m", "hymba-1.5b", "whisper-medium"}
REMAT_GRADS = {"whisper-medium"}


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters=30):
    """Mean device milliseconds per call, by CUDA events.

    The calls queue up behind a ~20 ms device sleep, so they run back to
    back and the events time the device, not the host's launch rate.
    """
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)  # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters=30):
    """Mean wall milliseconds per call, host launch cost included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(t_bytes, t_ops):
    """(ms, by) of the larger of the bytes' and the operations' least times, in seconds."""
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rmsnorm_bound(T, D, elem):
    """Read x and w once, write out once; ~4 f32 operations per element."""
    return bound((2 * T * D + D) * elem / HBM_BYTES_PER_S, 4 * T * D / F32_FLOPS)


def attention_ops_s(ops, elem):
    """Least seconds for the products of attention and moe_matmul: bf16 on the bf16 tensor
    cores; f32 as their split-TF32 routes run them, three TF32 products a product (hi hi +
    hi lo + lo hi)."""
    return ops / BF16_TENSOR_FLOPS if elem == 2 else 3 * ops / TF32_TENSOR_FLOPS


def flash_bound(B, H, KV, S, d, causal, elem, Sk=None):
    """q, k, v read once, out written once; 4*d operations per scored pair (keys of
    their own length ``Sk``: B11, non-causal), f32 at the split-TF32 rate."""
    Sk = S if Sk is None else Sk
    pairs = S * (S + 1) // 2 if causal else S * Sk
    return bound((2 * B * H * S * d + 2 * B * KV * Sk * d) * elem / HBM_BYTES_PER_S,
                 attention_ops_s(4 * d * B * H * pairs, elem))


def cross_lse_err(q, k, lse):
    """B11's row log-sum-exp against the plain one (f32 scores of the same q and k):
    the largest error relative to each row's magnitude (at least 1)."""
    import torch

    B, H, S, d = q.shape
    KV = k.shape[1]
    scores = torch.einsum("bngqd,bnkd->bngqk", q.float().reshape(B, KV, H // KV, S, d),
                          k.float()) / math.sqrt(d)
    want = torch.logsumexp(scores, -1).reshape(B, H, S)
    return ((lse - want).abs() / want.abs().clamp_min(1.0)).max().item()


def decode_bound(B, H, KV, n, d, elem):
    """B11's decode: q and n keys of K and V read once, out written once; 4*d operations
    per scored pair, against the peak of the inputs' type (bf16: the tensor cores)."""
    peak = BF16_TENSOR_FLOPS if elem == 2 else F32_FLOPS
    return bound((2 * B * KV * n * d + 2 * B * H * d) * elem / HBM_BYTES_PER_S,
                 4 * d * B * H * n / peak)


def moe_bound(E, C, D, F, elem):
    """buf and w read once, out written once; 2*D operations per output element, f32 at the
    split-TF32 rate (the ``"tf32x3"`` route)."""
    return bound((E * C * D + E * D * F + E * C * F) * elem / HBM_BYTES_PER_S,
                 attention_ops_s(2 * E * C * D * F, elem))


def ssd_bound(BNC, H, Q, hd, N, elem):
    """x, b, c, cum read once, y and the f32 state written once.  Operations
    over the causal pairs q >= j: C.B (2N each) once per chunk, since the
    heads share B and C; per (chunk, head) the decay (1) and S.x (2 hd
    each), then the state (2 hd N per row plus the decay weights); all on
    f32 operands: bf16 x against the f32 peak; f32 x as its route (``"mma3"``) runs them,
    six bf16 tensor-core products of three-piece operands a product (``ssd_fma_bound`` keeps
    the f32 peak for comparison with the earlier rows)."""
    t_bytes, ops = ssd_bytes_ops(BNC, H, Q, hd, N, elem)
    return bound(t_bytes, ops / F32_FLOPS if elem == 2 else 6 * ops / BF16_TENSOR_FLOPS)


def ssd_bytes_ops(BNC, H, Q, hd, N, elem):
    """(least seconds for ``ssd_intra_chunk``'s bytes, its operations) as ``ssd_bound`` counts them."""
    pairs = Q * (Q + 1) // 2
    t_bytes = (2 * BNC * H * Q * hd * elem
               + 4 * (2 * BNC * Q * N + BNC * H * Q + BNC * H * hd * N)) / HBM_BYTES_PER_S
    return t_bytes, BNC * 2 * N * pairs + BNC * H * ((1 + 2 * hd) * pairs + 2 * Q * hd * N + Q * hd)


def ssd_fma_bound(BNC, H, Q, hd, N, elem):
    """``ssd_bound`` with every operation on the f32 FMAs' peak."""
    t_bytes, ops = ssd_bytes_ops(BNC, H, Q, hd, N, elem)
    return bound(t_bytes, ops / F32_FLOPS)


def flash_bwd_bounds(B, H, KV, S, d, causal, elem, Sk=None):
    """(dq kernel, dkdv kernel, whole backward) bounds; ``Sk``: the keys' own length.

    Only the function's own inputs and outputs count; the D = rowsum(dO o)
    that the dq kernel hands to the dkdv kernel is an intermediate and
    counts in neither.  dq reads q, k, v, o, dO and the lse and writes dQ;
    its products are Q K^T, dO V^T and dS K (6 d per scored pair).  dkdv
    reads q, k, v, dO and the lse and writes dK and dV; Q K^T, dO V^T,
    P^T dO and dS^T Q (8 d).  The whole backward reads q, k, v, o, dO and
    the lse and writes the three gradients, with 10 d per pair (2.5x the
    forward's 4 d).  f32 products at the split-TF32 rate (``attention_ops_s``).
    """
    Sk = S if Sk is None else Sk
    pairs = S * (S + 1) // 2 if causal else S * Sk
    q_bytes, kv_bytes, stat = B * H * S * d * elem, B * KV * Sk * d * elem, 4 * B * H * S
    return (
        bound((4 * q_bytes + 2 * kv_bytes + stat) / HBM_BYTES_PER_S,
              attention_ops_s(6 * d * B * H * pairs, elem)),
        bound((2 * q_bytes + 4 * kv_bytes + stat) / HBM_BYTES_PER_S,
              attention_ops_s(8 * d * B * H * pairs, elem)),
        bound((4 * q_bytes + 4 * kv_bytes + stat) / HBM_BYTES_PER_S,
              attention_ops_s(10 * d * B * H * pairs, elem)),
    )


def cross_bwd_bounds(B, H, KV, S, Sk, d, elem):
    """B11's bf16 backward: (statistics pass, one pass, both) bounds.

    The statistics pass reads o, dO and the lse and writes D and the lse
    times log2(e) (8 bytes a row); its operations are a few a value.  The
    one pass reads q, k, v, dO and those stats and writes dQ, dK and dV,
    with the five products (10 d per scored pair) on the bf16 tensor cores.
    Both: flash_bwd_bounds' whole backward (the stats are an intermediate).
    """
    q_bytes, kv_bytes, rows = B * H * S * d * elem, B * KV * Sk * d * elem, B * H * S
    peak = BF16_TENSOR_FLOPS if elem == 2 else F32_FLOPS
    return (bound((2 * q_bytes + 4 * rows + 8 * rows) / HBM_BYTES_PER_S, 4 * d * rows / F32_FLOPS),
            bound((3 * q_bytes + 4 * kv_bytes + 8 * rows) / HBM_BYTES_PER_S, 10 * d * B * H * S * Sk / peak),
            flash_bwd_bounds(B, H, KV, S, d, False, elem, Sk)[2])


def cross_bwd_stats_ref(out, lse, dout):
    """The statistics pass's plain version: [2, B, H, S] f32, D = rowsum(dout out) and the
    lse times log2(e)."""
    import torch

    return torch.stack([(dout.float() * out.float()).sum(-1), lse * math.log2(math.e)])


def rmsnorm_bwd_bounds(T, D, elem):
    """(dx kernel, dweight reduce, whole backward) bounds, from what the
    gradient needs: read x, dy and w, write dx and dweight, ~10 operations
    per element.  The f32 per-block partials that the dx kernel hands to the
    reduce are an intermediate and count nowhere.  The split: the dx kernel
    does all the reads, all the operations and the dx write; the reduce only
    the dweight write."""
    return (bound((3 * T * D + D) * elem / HBM_BYTES_PER_S, 10 * T * D / F32_FLOPS),
            bound(D * elem / HBM_BYTES_PER_S, 0.0),
            bound((3 * T * D + 2 * D) * elem / HBM_BYTES_PER_S, 10 * T * D / F32_FLOPS))


def moe_bwd_bounds(E, C, D, F, elem):
    """(dbuf kernel, dw kernel, whole backward) bounds.  dbuf = dout w^T reads dout and w
    and writes dbuf; dw = buf^T dout reads buf and dout and writes dw; 2 C D F operations
    per expert each, f32 at the split-TF32 rate (the ``"tf32x3"`` route; ``moe_fma_ms``
    keeps the FMA rate beside it).  The whole backward reads buf, w and dout once and writes
    both."""
    ops_one = attention_ops_s(2 * E * C * D * F, elem)
    buf, w, out = E * C * D * elem, E * D * F * elem, E * C * F * elem
    return (bound((out + w + buf) / HBM_BYTES_PER_S, ops_one),
            bound((buf + out + w) / HBM_BYTES_PER_S, ops_one),
            bound((2 * buf + 2 * w + out) / HBM_BYTES_PER_S, 2 * ops_one))


def moe_fma_ms(E, C, D, F):
    """The least ms of one f32 moe_matmul product (2 C D F operations per expert) at the
    CUDA cores' FMA rate, the f32 routes' bound before they ran on the tensor cores."""
    return 1e3 * 2 * E * C * D * F / F32_FLOPS


def ssd_bwd_bounds(BNC, H, Q, hd, N, elem):
    """(main kernel, reduce, whole backward) bounds.  The gradient reads x, dy (x's
    type), b, c, cum and dstate (f32) and writes dx (x's type), db, dc and dcum (f32).
    Operations over the causal pairs q >= k.  Once per chunk, since the heads share B and
    C: C B^T (2N), then dC = (sum_h dM_h o L_h) B and its transpose's product with C for dB
    (2N each).  Per (chunk, head): L, M, dM o L and P (4), the add of dM o L into the head
    sum (1), dM = dy x^T and M^T dy (2 hd each) and the two sums of P (2); per row the
    chunk-state terms: B dstate^T and (x o w) dstate (2 hd N each), w o (B dstate^T) and
    x.(B dstate^T) (3 hd).  All f32 operands, so against the f32 peak.  The f32 partials
    that the main kernel hands to the reduce count nowhere: the main kernel does the reads,
    the operations and the dx write; the reduce only the writes of db, dc and dcum."""
    pairs = Q * (Q + 1) // 2
    x_bytes = BNC * H * Q * hd * elem
    reads = 2 * x_bytes + 4 * (2 * BNC * Q * N + BNC * H * Q + BNC * H * hd * N)
    writes_f32 = 4 * (2 * BNC * Q * N + BNC * H * Q)
    ops = BNC * 6 * N * pairs + BNC * H * ((4 * hd + 7) * pairs + 4 * Q * hd * N + 3 * Q * hd)
    return (bound((reads + x_bytes) / HBM_BYTES_PER_S, ops / F32_FLOPS),
            bound(writes_f32 / HBM_BYTES_PER_S, 0.0),
            bound((reads + x_bytes + writes_f32) / HBM_BYTES_PER_S, ops / F32_FLOPS))


def ssd_bwd_split_bound(BNC, H, Q, hd, N):
    """The bf16 route's own bound for the whole backward: the bytes of ``ssd_bwd_bounds``, and
    its products on the bf16 tensor cores as it splits them (an f32 operand in two bf16 pieces:
    three products for f32 x f32, two for f32 x bf16 and one for bf16 x bf16): C B^T, dC and
    dB's S^T C once per chunk (three each), dM = dy x^T (one) and M^T dy (two) per head, and the
    chunk-state terms B dstate^T and (x o w) dstate (three each)."""
    pairs = Q * (Q + 1) // 2
    x_bytes = BNC * H * Q * hd * 2
    moved = 3 * x_bytes + 4 * (4 * BNC * Q * N + 2 * BNC * H * Q + BNC * H * hd * N)
    ops = 3 * BNC * 6 * N * pairs + BNC * H * (3 * 2 * hd * pairs + 3 * 4 * Q * hd * N)
    return bound(moved / HBM_BYTES_PER_S, ops / BF16_TENSOR_FLOPS)


ADAMW_OPS = 16  # f32 operations an element of the update: 11 products and sums, 3 divisions, a sqrt


def adamw_bounds(leaves):
    """(norm, finish, update, whole step) bounds of AdamW over ``leaves`` ((shape, p dtype, g
    dtype) each).  The norm reads g (2 operations an element); the finish reads the f64
    partials and writes gnorm and the scale; the update reads p, g, m and v and writes p,
    m and v (f32 moments).  The whole step, as a function, reads each input once and writes
    each output once: the update's bytes (22 a bf16 parameter), ~ADAMW_OPS + 2 operations
    an element."""
    import math

    from repro_torch.kernels.adamw import NORM_BLOCKS

    n = [math.prod(sh) for sh, _, _ in leaves]
    g_bytes = sum(k * g.itemsize for k, (_, _, g) in zip(n, leaves))
    upd_bytes = sum(k * (2 * p.itemsize + g.itemsize + 16) for k, (_, p, g) in zip(n, leaves))
    total = sum(n)
    return (bound(g_bytes / HBM_BYTES_PER_S, 2 * total / F32_FLOPS),
            bound((8 * NORM_BLOCKS + 8) / HBM_BYTES_PER_S, NORM_BLOCKS / F32_FLOPS),
            bound(upd_bytes / HBM_BYTES_PER_S, ADAMW_OPS * total / F32_FLOPS),
            bound(upd_bytes / HBM_BYTES_PER_S, (ADAMW_OPS + 2) * total / F32_FLOPS))


def grad_err(name, got, want, tol, zero_abs=ZERO_GRAD_ABS):
    """(max |got - want|, that over max |want|, or None where want is all zero).

    Raises where the relative error exceeds tol, where a zero reference's
    error exceeds ``zero_abs``, or on a non-finite value.
    """
    import torch

    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    if scale == 0.0:
        if err > zero_abs:
            raise AssertionError(f"{name}: {err:.3e} where the reference is 0 (limit {zero_abs})")
        return err, None
    if err > tol * scale:
        raise AssertionError(f"{name}: max abs err {err:.3e} beyond {tol} x {scale:.3e}")
    return err, err / scale


def assert_close(name, got, want, tol, rel=True):
    """Max abs error; raises where it exceeds tol (+ tol * |want| if rel)."""
    import torch

    err = (got.float() - want.float()).abs()
    bad = err > (tol + tol * want.float().abs() if rel else tol)
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e} beyond tol {tol}")
    return err.max().item()


def wall_ms(fn):
    """(result, wall milliseconds of one call, device work included)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_kernels(prof):
    """{device operation name: [device microseconds, count]} of a finished torch.profiler trace."""
    import torch

    kernels = {}
    for e in prof.profiler.kineto_results.events():
        # a gpu_user_annotation (a profiler range's span on the device) is no device work
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += e.duration_ns() / 1e3
            k[1] += 1
    return kernels


def range_device_ms(prof, name):
    """(forward, backward) device milliseconds of the work that a finished trace (host and
    CUDA activity) ran inside ``record_function(name)`` ranges (a recompute's forward
    among them) and in their backward.  A device operation counts where the host
    operation it is linked to (the profiler's linked correlation id, as
    ``torch.autograd.profiler`` links them) or the runtime call that launched it (the
    same CUDA correlation id: the port's kernels launch through ctypes, outside any
    operator) ran inside such a range on its thread, or inside the backward node (same
    sequence number, forward thread the range's) of an autograd operation that did."""
    import bisect

    import torch

    device, host, launch = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(e)
        elif e.name().startswith(("cuda", "cuLaunch")):  # a runtime call
            launch[e.correlation_id()] = e
        elif e.linked_correlation_id() == 0:  # a host operation or range
            host.append(e)

    def spans(events):
        """{thread: (starts, ends)} of the events' merged [start, end] intervals."""
        by_thread = {}
        for e in events:
            by_thread.setdefault(e.start_thread_id(), []).append((e.start_ns(), e.end_ns()))
        out = {}
        for t, iv in by_thread.items():
            merged = []
            for a, b in sorted(iv):
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            out[t] = ([a for a, _ in merged], [b for _, b in merged])
        return out

    def inside(e, sp):
        starts, ends = sp.get(e.start_thread_id(), ((), ()))
        i = bisect.bisect_right(starts, e.start_ns()) - 1
        return i >= 0 and e.end_ns() <= ends[i]

    ranges = spans(e for e in host if e.name() == name)
    fwd = [e for e in host if inside(e, ranges)]
    nodes = {(e.sequence_nr(), e.start_thread_id()) for e in fwd if e.sequence_nr() >= 0}
    bwd = spans(e for e in host if (e.sequence_nr(), e.fwd_thread_id()) in nodes)
    fwd_ops = {e.correlation_id() for e in fwd}
    bwd_ops = {e.correlation_id() for e in host if inside(e, bwd)} - fwd_ops
    ns = [0, 0]
    for e in device:
        call = launch.get(e.correlation_id())
        if e.linked_correlation_id() in fwd_ops or (call is not None and inside(call, ranges)):
            ns[0] += e.duration_ns()
        elif e.linked_correlation_id() in bwd_ops or (call is not None and inside(call, bwd)):
            ns[1] += e.duration_ns()
    if not ns[0]:  # what the trace held, to find why a range came out empty
        print(f"[profile] range {name}: {sum(len(v[0]) for v in ranges.values())} spans, "
              f"{len(fwd)} host events inside, {len(launch)} runtime calls "
              f"({sum(inside(c, ranges) for c in launch.values())} inside), {len(device)} device "
              f"operations ({sum(e.linked_correlation_id() == 0 for e in device)} unlinked)")
    return ns[0] / 1e6, ns[1] / 1e6


def profiled(label, fn, card, rows=10, ranges=(), stats=None):
    """One warm call of fn under torch.profiler: its device busy share and top kernels.
    Returns {range: (forward, backward) device ms} of the named ``record_function`` ranges
    (whose trace records the host's operations too), each of which must hold some device work;
    ``stats`` (a dict) receives the call's wall and device busy milliseconds.

    Only device activity is traced where no range is named, and the raw device events are
    summed by name: ``key_averages`` builds a Python object per event, which took
    20-25 s over the 47k-110k device operations of one generation.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
    with profile(activities=activities) as prof:
        _, ms = wall_ms(fn)
    t1 = time.perf_counter()
    kernels = device_kernels(prof)
    in_ranges = {r: range_device_ms(prof, r) for r in ranges}
    print(f"[time] profile {label}: {t1 - t0 - ms / 1e3:.1f}s to stop the trace, "
          f"{time.perf_counter() - t1:.1f}s to sum it")
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    ops = sum(n for _, n in kernels.values())
    if ops == 0:
        raise AssertionError(f"[profile] {label}: the profiler saw no device operation")
    traced = " (host operations traced too)" if ranges else ""
    print(f"[profile] {label}: wall {ms:.2f} ms under the profiler{traced}; device busy "
          f"{busy_ms:.2f} ms = {100 * busy_ms / ms:.1f}% of wall; {ops} device operations [{card}]")
    for key, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:rows]:
        print(f"[profile] {label}   {us / 1e3:9.3f} ms {n:6d}x  {key[:90]}")
    ours = {}  # the port's own kernels, by template name
    for key, (us, n) in kernels.items():
        head = key.split("<")[0].replace("(anonymous namespace)", "")
        base = head.split("(")[0].split("::")[-1].strip()
        if base.startswith(PORT_KERNEL_PREFIXES):
            acc = ours.setdefault(base, [0.0, 0])
            acc[0] += us
            acc[1] += n
    for base, (us, n) in sorted(ours.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] {label} port kernel {base}: {us / 1e3:.3f} ms over {n} launches, "
              f"{100 * us / 1e3 / busy_ms:.1f}% of device busy")
    opt = [v for base, v in ours.items() if base.startswith("adamw_")]
    if opt:
        opt_ms = sum(us for us, _ in opt) / 1e3
        print(f"[profile] {label} AdamW (B9: norm, finish and update kernels): {opt_ms:.3f} device "
              f"ms over {sum(n for _, n in opt)} launches, {100 * opt_ms / busy_ms:.1f}% of device "
              f"busy [{card}]")
    for r, (f_ms, b_ms) in in_ranges.items():
        if not f_ms > 0:
            raise AssertionError(f"[profile] {label}: no device work found inside range {r}")
        print(f"[profile] {label} range {r}: {f_ms + b_ms:.3f} device ms ({f_ms:.3f} inside it, "
              f"{b_ms:.3f} in its backward), {100 * (f_ms + b_ms) / busy_ms:.1f}% of device busy "
              f"{busy_ms:.2f} ms [{card}]")
    if stats is not None:
        stats.update(wall_ms=ms, busy_ms=busy_ms,
                     adamw_ms=sum(us for b, (us, _) in ours.items() if b.startswith("adamw_")) / 1e3)
    return in_ranges


PORT_KERNEL_PREFIXES = ("rmsnorm", "flash_", "moe_matmul", "ssd_", "adamw_")


FWD_F32_TOL = {"rmsnorm": RMSNORM_F32_TOL, "flash_attention": FLASH_F32_TOL,
               "cross_attention": FLASH_F32_TOL, "flash_decode": FLASH_F32_TOL,
               "moe_matmul": F32_TOL, "ssd_intra_chunk": F32_TOL}


# AdamW (B9) is held at step 3 of this config's schedule, past the clip (gradients ~N(0, 3)
# a leaf), on moments of the sizes training gives them; the plain version runs on slices of at
# most ADAMW_SLICE elements of a leaf (it is elementwise: a slice's update is the leaf's)
ADAMW_CFG = dict(lr=1e-3, warmup_steps=10, total_steps=100)
ADAMW_STEP = 3
ADAMW_SLICE = 1 << 26
ADAMW_GNORM_TOL = 1e-6  # relative: the norm's sums run in another order than torch's


def adamw_scalars(dev):
    """(config, lr, bc1, bc2) of the held AdamW step, f32 scalars on ``dev`` as the optimizer
    forms them."""
    import torch

    from repro_torch.training.optimizer import AdamWConfig, lr_schedule

    cfg = AdamWConfig(**ADAMW_CFG)
    step = torch.tensor(ADAMW_STEP, dtype=torch.int32, device=dev)
    return (cfg, lr_schedule(cfg, step), 1 - cfg.beta1 ** step.to(torch.float32),
            1 - cfg.beta2 ** step.to(torch.float32))


def adamw_inputs(leaves, dev, gen):
    """Fresh (params, grads, m, v) of ``leaves`` ((shape, p dtype, g dtype) each)."""
    import torch

    def randn(shape, dtype, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    ps = [randn(s, pdt, 1.0) for s, pdt, _ in leaves]
    gs = [randn(s, gdt, 3.0) for s, _, gdt in leaves]
    ms = [randn(s, torch.float32, 0.01) for s, _, _ in leaves]
    vs = [randn(s, torch.float32, 0.01).square_() for s, _, _ in leaves]
    return ps, gs, ms, vs


def adamw_maker(leaves, dev, seed):
    """make(i): fresh (p, g, m, v) of leaf i of ``leaves``, from a generator of its own
    seeded from ``seed`` and i, so that every call makes the same tensors."""
    import torch

    def make(i):
        gen = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + i)
        return tuple(t[0] for t in adamw_inputs([leaves[i]], dev, gen))

    return make


def adamw_table(make, n):
    """[params, grads, m, v] of n leaves made by ``make``."""
    return [list(ts) for ts in zip(*(make(i) for i in range(n)))]


def hold_adamw(label, table, make, dev):
    """Hold ``ops.adamw_update_`` on ``table`` ([params, grads, m, v] of leaves made by
    ``make``, as laid out there) in two calls, each on the leaves made afresh and updated in
    place.  After each call, every leaf's p, m and v must be bit-identical to the plain
    update (``ref.adamw_leaf_ref``, slice by slice, on the leaf made again) given the
    kernel's scale and the same lr and bias corrections, so the two calls are bit-identical
    too; gnorm and scale must be equal in both calls and gnorm within ADAMW_GNORM_TOL of the
    plain f32 norm (``optimizer.global_norm``).  Beyond the table it holds one leaf at a
    time.  Returns the readings (gnorm's absolute error, its relative error, the largest
    |kernel - plain| over p, m and v); raises beyond a limit."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.training.optimizer import global_norm

    ps, gs, ms, vs = table
    cfg, lr, bc1, bc2 = adamw_scalars(dev)
    kw = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay)

    def slices(t):
        flat = t.view(-1)
        return [flat[i:i + ADAMW_SLICE] for i in range(0, flat.numel(), ADAMW_SLICE)]

    calls = []
    upd_err = torch.zeros((), dtype=torch.float32, device=dev)
    for call in range(2):
        if call:  # the leaves as they were
            for i, (p, m, v) in enumerate(zip(ps, ms, vs)):
                p0, _, m0, v0 = make(i)
                for t, t0 in ((p, p0), (m, m0), (v, v0)):
                    t.copy_(t0)
                del p0, m0, v0
        gnorm, scale = ops.adamw_update_(ps, gs, ms, vs, lr, bc1, bc2, grad_clip=cfg.grad_clip, **kw)
        calls.append((gnorm.clone(), scale.clone()))
        for i in range(len(ps)):
            p0, g0, m0, v0 = make(i)
            if not torch.equal(g0, gs[i]):
                raise AssertionError(f"{label}: leaf {i}'s gradient changed")
            both = (p0, g0, m0, v0, ps[i], ms[i], vs[i])
            for sp, sg, sm, sv, kp, km, kv in zip(*(slices(t) for t in both)):
                ref.adamw_leaf_ref(sp, sg, sm, sv, scale, lr, bc1, bc2, **kw)
                for what, a, b in (("p", kp, sp), ("m", km, sm), ("v", kv, sv)):
                    d = (a.to(torch.float32) - b.to(torch.float32)).abs().max()
                    upd_err = torch.maximum(upd_err, d)
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"{label}: call {call + 1}, leaf {i} {tuple(ps[i].shape)} {what} "
                            f"differs from the plain update given the same scalars at "
                            f"{int((a != b).sum())} elements, by up to {d.item():.3e}")
            del p0, g0, m0, v0
    if not all(torch.equal(a, b) for a, b in zip(*calls)):
        raise AssertionError(f"{label}: two calls differ in gnorm or scale: {calls}")
    gnorm = calls[0][0].item()
    want = global_norm(gs).item()
    g_abs = abs(gnorm - want)
    if not g_abs <= ADAMW_GNORM_TOL * want:
        raise AssertionError(f"{label}: gnorm {gnorm} vs the plain {want} "
                             f"({g_abs / want:.2e} beyond {ADAMW_GNORM_TOL})")
    return g_abs, g_abs / want, upd_err.item()


def plain_adamw_refused():
    """A patch under which the plain AdamW raises where it is handed a CUDA tensor: the
    training runs' optimizer steps must take the B9 kernels."""
    from repro_torch.kernels import ref

    plain = ref.adamw_update_ref

    def refused(params, *args, **kwargs):
        if params[0].is_cuda:
            raise AssertionError("a CUDA tensor reached the plain AdamW")
        return plain(params, *args, **kwargs)

    return mock.patch.object(ref, "adamw_update_ref", refused)


def hold_at_shape(kernel, key, dev, gen):
    """Hold ``kernel`` at the shape ``key`` against its plain version on fresh inputs from
    ``gen``, as phases 3 and 5 hold their cases.  ``kernel`` is a recorded wrapper's name: a
    forward kernel, run through ``ops`` against ``ref`` at phase 3's tolerance, or its
    backward (``..._bwd``), autograd through ``ops`` against autograd through ``ref`` at
    GRAD_TOL; ``key`` is the recorded shape key, its dtype last.  Returns the max abs error
    (forward) or the largest error relative to a reference gradient's largest magnitude
    (backward); raises beyond the limit."""
    import torch

    from repro_torch.kernels import ops, ref

    if kernel == "adamw_update_":  # key: (leaf shape, p dtype, g dtype); gnorm's relative error
        seed = int(torch.randint(1 << 30, (1,), generator=gen, device=gen.device))
        make = adamw_maker([key], dev, seed)
        return hold_adamw(f"adamw_update_ {key} (held where it was launched)", adamw_table(make, 1),
                          make, dev)[1]
    *dims, dt = key
    bwd = kernel.endswith("_bwd")
    name = kernel.removesuffix("_bwd")

    def randn(*shape, dtype=dt, scale=1.0):
        t = (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)
        return t.requires_grad_(bwd)

    if name == "flash_attention":
        B, H, KV, S, d, causal = dims
        inputs = (randn(B, H, S, d), randn(B, KV, S, d), randn(B, KV, S, d))
        fn = lambda *t: ops.flash_attention_op(*t, causal=causal)  # noqa: E731
        plain = lambda *t: ref.flash_attention_ref(*t, causal)  # noqa: E731
    elif name == "cross_attention":
        B, H, KV, S, Sk, d = dims
        inputs = (randn(B, H, S, d), randn(B, KV, Sk, d), randn(B, KV, Sk, d))
        fn, plain = ops.cross_attention_op, lambda *t: ref.flash_attention_ref(*t, False)
    elif name == "flash_decode":
        B, H, KV, Sk, n, d = dims
        inputs = (randn(B, H, 1, d), randn(B, Sk, KV * d), randn(B, Sk, KV * d))
        fn = lambda *t: ops.decode_attention_op(*t, n)  # noqa: E731
        plain = lambda *t: ref.decode_attention_ref(*t, n)  # noqa: E731
    elif name == "rmsnorm":
        T, D = dims
        w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(dt).requires_grad_(bwd)
        inputs, fn, plain = (randn(T, D, scale=3.0), w), ops.rmsnorm_op, ref.rmsnorm_ref
    elif name == "moe_matmul":
        E, C, D, Fd = dims
        inputs = (randn(E, C, D), randn(E, D, Fd, scale=0.05))
        fn, plain = ops.moe_matmul_op, ref.moe_matmul_ref
    elif name == "ssd_intra_chunk":
        BNC, H, Q, hd, N = dims
        cum = -torch.cumsum(0.1 * torch.rand(BNC, H, Q, generator=gen, device=dev), -1)
        inputs = (randn(BNC, H, Q, hd, scale=0.5), randn(BNC, Q, N, dtype=torch.float32, scale=0.5),
                  randn(BNC, Q, N, dtype=torch.float32, scale=0.5), cum.requires_grad_(bwd))
        fn, plain = ops.ssd_intra_chunk_op, ref.ssd_intra_chunk_ref
    else:
        raise ValueError(f"no plain version to hold {kernel} against")
    label = f"{kernel} {key} (held where it was launched)"
    got, want = fn(*inputs), plain(*inputs)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    if not bwd:  # ssd's second output, the chunk state, is f32 whatever x's type
        tol = BF16_TOL if dt == torch.bfloat16 else FWD_F32_TOL[name]
        return max(assert_close(label, a, b, tol if i == 0 else F32_TOL)
                   for i, (a, b) in enumerate(zip(got, want)))
    douts = [torch.randn(o.shape, generator=gen, device=dev).to(o.dtype) for o in want]
    g_got = torch.autograd.grad(got, inputs, douts)
    g_want = torch.autograd.grad(want, inputs, douts)
    return max(grad_err(f"{label} input {i}", a, b, GRAD_TOL[str(dt)[6:]])[1] or 0.0
               for i, (a, b) in enumerate(zip(g_got, g_want)))


def hold_unchecked(label, shapes, checked, hold):
    """Hold every recorded (kernel, shape key) in ``shapes`` that ``checked`` ({kernel: keys
    held so far}, phases 3 and 5's cases to begin with) lacks with ``hold(kernel, key)``,
    then add it to ``checked``.  Returns the pairs held here."""
    held = sorted((s for s in shapes if s[1] not in checked.get(s[0], ())), key=str)
    for kernel, key in held:
        err = hold(kernel, key)
        checked.setdefault(kernel, set()).add(key)
        print(f"[{label}] held {kernel} {key} against its plain version here: err {err:.2e}")
    print(f"[{label}] all {len(shapes)} (kernel, shape) pairs held against their plain "
          f"versions: {len(shapes) - len(held)} by phases 3 and 5's cases, {len(held)} here")
    return held


# the shape key of each recorded wrapper's call, its dtype last
def flash_key(q, k, v, *_, causal=True, **__):
    return (*q.shape[:2], k.shape[1], *q.shape[2:], causal, q.dtype)


def cross_key(q, k, *_, **__):
    """(B, H, KV, S, Sk, d, dtype) of a B11 call over keys of their own length."""
    return (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3], q.dtype)


def decode_key(q, k_cache, v_cache, n):
    """(B, H, KV, Sk, n, d, dtype) of a B11 decode call over FLAT caches."""
    return (*q.shape[:2], k_cache.shape[2] // q.shape[3], k_cache.shape[1], n, q.shape[3], q.dtype)


def rms_key(x, *_, **__):
    return (*x.shape, x.dtype)


def ssd_key(x, b, *_):
    return (*x.shape, b.shape[2], x.dtype)


def moe_key(buf, w, *_, **__):
    return (*buf.shape, w.shape[2], buf.dtype)


def adamw_keys(params, grads, *_, **__):
    """A key per leaf of an AdamW step: (shape, p dtype, g dtype)."""
    return [(tuple(p.shape), p.dtype, g.dtype) for p, g in zip(params, grads)]


def kernel_wrappers(train=False):
    """(module, wrapper, shape key) of the forward wrappers that serving records, or with
    ``train`` of every wrapper a training step launches (moe_matmul's forward among them)."""
    from repro_torch.kernels import adamw as adamw_k
    from repro_torch.kernels import flash_attention as flash_k
    from repro_torch.kernels import moe_matmul as moe_k
    from repro_torch.kernels import rmsnorm as rms_k
    from repro_torch.kernels import ssd_scan as ssd_k

    fwd = ((flash_k, "flash_attention", flash_key), (rms_k, "rmsnorm", rms_key),
           (ssd_k, "ssd_intra_chunk", ssd_key), (flash_k, "cross_attention", cross_key),
           (flash_k, "flash_decode", decode_key))
    if not train:
        return fwd
    return (*fwd, (moe_k, "moe_matmul", moe_key), (flash_k, "flash_attention_bwd", flash_key),
            (flash_k, "cross_attention_bwd", cross_key),
            (rms_k, "rmsnorm_bwd", rms_key), (moe_k, "moe_matmul_bwd", moe_key),
            (ssd_k, "ssd_intra_chunk_bwd", ssd_key), (adamw_k, "adamw_update_", adamw_keys))


def recording(shapes, wrappers):
    """Patches that add (wrapper, shape key) to ``shapes`` at every call of the wrappers (a
    key function may give a list: a key for each leaf of an AdamW step)."""
    stack = ExitStack()
    for mod, fname, key in wrappers:
        def call(*a, _fn=getattr(mod, fname), _name=fname, _key=key, **kw):
            k = _key(*a, **kw)
            shapes.update((_name, x) for x in (k if isinstance(k, list) else [k]))
            return _fn(*a, **kw)

        stack.enter_context(mock.patch.object(mod, fname, call))
    return stack


# phase 10: six ranks share the card on a (data 2, model 3) mesh over gloo (NCCL refuses two
# ranks on one device).  Serving, generation 4 x (128 prompt + 9 new: one prefill and 8 decode
# steps) with the caches 138 long past internvl2-1b's 256 stub patches (``mesh_cache``: a
# multiple of the model extent, so that their sequence shards on it): granite at full width in
# bf16 at 8 of its 32 layers, on a copy of its config whose capacity drops nothing, as phase 4's
# checks run it (its 40 experts pad to 42, 14 a model rank), and llama3.2-1b at full width and
# depth in bf16 (32 H / 8 KV pad to 9 KV x g 4, 12 heads a rank); f32 copies of both held to
# summation order; the reduced f32 kimi.  mamba2-130m at full width and depth (its 24 SSM heads,
# d_inner 1536 and vocabulary 50280 shard 8 / 512 / 16760 a model rank: the mixer is split over
# its heads, ``ssm.splits``), hymba-1.5b at full width and depth (3 divides none of its 50 SSM
# heads, d_inner 3200, d_ff 5504 or vocabulary 32001: they replicate, its mixer is repeated on
# every model rank, and its 25 H / 5 KV pad to 5 KV x g 6), whisper-medium at full width and
# depth over 1500 stub frames (16 MHA heads pad to 18; its vocabulary 51865 replicates; the cross
# caches' 1500 rows shard on the model axis, so decode combines them plainly), internvl2-1b at
# full width and depth after 256 stub patches (14 H / 2 KV pad to 2 KV x g 9, 6 heads a rank;
# its d_ff 4864 and vocabulary 151655 replicate, as in JAX), bf16 and f32 copies.  One f32 train
# step each of the reduced granite with 10 experts (padded to 12), the reduced llama3.2-1b,
# mamba2-130m at full width and 4 of its 24 layers, hymba-1.5b at full width and 8 of its
# layers (an f32 step holds ~16 bytes a parameter, replicated on six ranks: its 32 layers would
# need ~150 GiB, 8 hold ~7 GiB a rank), whisper-medium at full width and 4 + 4 layers over its 1500 frames and
# internvl2-1b at full width and 4 of its 24 layers after its 256 patches (every rank holds
# all its 332 M parameters, 272 M of them the replicated 151655-row embedding and head:
# ``mesh_rank_params``); and bf16 steps of granite at full width and 4 layers (drop-free: 3
# does not divide its 40 experts, so every rank holds all of them, ~99 M parameters a layer,
# and pads them to 42 at run time; at 8 layers the six ranks' ~56 GiB of state did not fit
# beside the parent's), mamba2-130m at full width and 2 layers and whisper-medium at 4 + 4
# layers, on 4 x 64 tokens.  mamba2's random stack carries any last-bit difference (the
# products' shapes: its mixer split over three ranks, 2 rows a data rank against 4) further
# with each layer: its steps run where six seeds' readings stand apart from a fault (f32: the
# split under 2e-4 of the per-shard step at 4 layers, 4.6e-4 at 6; bf16: the unsharded bf16
# step within 0.06-0.10 of the f32 one at 2 layers, 0.18-7.0 at 4; PERF.md).  The MoE
# configs drop nothing: where capacity drops assignments, each data shard's own capacity drops
# others than the global one does, in JAX too (tests/test_torch_sharded_equivalence.py holds
# the dropping dispatch against JAX's on (2, 3) and (2, 4); PERF.md gives the drops that the
# capacity factor 4.0 makes in the train step's config).
# (label, arch, seed, dtype, layers or None for the config's depth; whisper's encoder too)
MESH_SHAPE, MESH_WORLD = (2, 3), 6
MESH_NEW, MESH_CACHE = 9, 138
MESH_SERVE = (("granite-moe-3b-a800m 8L", "granite-moe-3b-a800m", 21, "bfloat16", 8),
              ("llama3.2-1b", "llama3.2-1b", 22, "bfloat16", None),
              ("granite-moe-3b-a800m f32 8L", "granite-moe-3b-a800m", 21, "float32", 8),
              ("llama3.2-1b f32", "llama3.2-1b", 22, "float32", None),
              ("kimi-k2-1t-a32b reduced", "kimi-k2-1t-a32b", 23, "float32", None),
              ("mamba2-130m", "mamba2-130m", 31, "bfloat16", None),
              ("mamba2-130m f32", "mamba2-130m", 31, "float32", None),
              ("hymba-1.5b", "hymba-1.5b", 32, "bfloat16", None),
              ("hymba-1.5b f32", "hymba-1.5b", 32, "float32", None),
              ("whisper-medium", "whisper-medium", 33, "bfloat16", None),
              ("whisper-medium f32", "whisper-medium", 33, "float32", None),
              ("internvl2-1b", "internvl2-1b", 41, "bfloat16", None),
              ("internvl2-1b f32", "internvl2-1b", 41, "float32", None))
MESH_TRAIN = (("granite-moe-3b-a800m reduced E10", "granite-moe-3b-a800m", 24, "float32", None),
              ("llama3.2-1b reduced", "llama3.2-1b", 25, "float32", None),
              ("mamba2-130m 4L", "mamba2-130m", 34, "float32", 4),
              ("hymba-1.5b 8L", "hymba-1.5b", 35, "float32", 8),
              ("whisper-medium 4+4L", "whisper-medium", 36, "float32", 4),
              ("internvl2-1b 4L", "internvl2-1b", 40, "float32", 4),
              ("granite-moe-3b-a800m 4L bf16", "granite-moe-3b-a800m", 37, "bfloat16", 4),
              ("mamba2-130m 2L bf16", "mamba2-130m", 38, "bfloat16", 2),
              ("whisper-medium 4+4L bf16", "whisper-medium", 39, "bfloat16", 4))
MESH_TRAIN_SHAPE = (4, 64)
# one GRPO step of a reduced f32 policy on the mesh, 4 x 64 (label, arch, seed, dtype, layers)
MESH_GRPO = ("llama3.2-1b reduced policy", "llama3.2-1b", 26, "float32", None)
# sharded vs unsharded f32 train step: loss (abs) and each gradient (rel. to max)
MESH_GRAD_TOL = 2e-4
# bf16 generation, sharded vs unsharded on the same weights, each row until its tokens part:
# 1.5x the largest reading of `tools/torch_mesh_probe.py bf16` over seeds 21, 22, 31-34 (granite
# 0.0571-0.0811, llama3.2-1b 0.0945-0.1112; llama's own bf16 forward, batch 4 against each row
# alone, differs from itself by 0.097-0.104 on the same seeds; hymba-1.5b 0.3265-0.7615,
# whisper-medium 0.0687-0.0731; internvl2-1b 0.0814-0.0962; mamba2-130m 0.5713-1.4220 with its
# mixer split over its heads, 0.1758-0.7435 when it was repeated).  mamba2's and hymba's
# readings are large where their own bf16 forward, batch 4 against each row alone, moves by 0
# and 1.3e-5: a last-bit difference anywhere (mamba2's out-projection summed in f32 over three
# ranks and rounded once, hymba's decode projections at 2 rows a rank against 4) is carried
# forward by their SSM layers, and f32 copies agree to ~5e-4 and 1.8e-4; the ratio below holds
# them.
MESH_BF16_TOL = {"moe": 0.12, "dense": 0.17, "ssm": 2.14, "hybrid": 1.15, "audio": 0.11,
                 "vlm": 0.15}
# ... and the sharded bf16 logits, against an f32 forward of the same weights teacher-forced on
# their tokens, may lie at most this many times as far from it as the unsharded bf16 logits do
# (0.796-1.423 over the same twelve readings; mamba2 0.967-1.189 split, 0.991-1.190 repeated,
# hymba 0.693-1.470, whisper 0.872-1.126, internvl2-1b 1.001-1.077 over their six).  The bf16
# train steps' gradients are held to the same ratio against the f32 step on the same weights
# (granite at 8 layers 0.919-1.247, at 4 layers 0.704-1.748, mamba2 at 2 layers 0.882-1.061,
# whisper 4 + 4 L 0.934-1.049 over the six).
MESH_ANCHOR_RATIO = 2.0
# bf16 train steps, sharded vs the unsharded bf16 step on the same weights: (the loss's abs
# error, each gradient's relative to the leaf's largest magnitude), against the whole batch's
# step and, where the loss is a mean over the rows, each data shard's rows' step: 1.5x the
# largest of both readings of `tools/torch_mesh_probe.py bf16` over seeds 21, 22, 31-34
# (granite at 8 and 4 layers: loss 4.8e-6-6.46e-4, grads 0.0347-0.0701; whisper 4 + 4 L: loss
# 1.05e-5-6.57e-4, grads 0.0164-0.0191; mamba2-130m at 2 layers: loss 4.8e-6-7.06e-5, grads
# 0.0144-0.0194).
MESH_BF16_TRAIN_TOL = {"moe": (9.7e-4, 0.11), "ssm": (1.06e-4, 0.029), "audio": (9.9e-4, 0.029)}


def mesh_config(label, arch, dtype, layers):
    """The config phase 10 runs under ``label``: full width, or reduced where the label says so
    (granite's reduced copy with 10 experts), at ``layers`` (whisper's encoder too); MoE copies
    drop nothing (capacity factor E / K)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if "reduced" in label:
        cfg = cfg.reduced()
        if "E10" in label:
            cfg = dataclasses.replace(cfg, num_experts=10)
    cfg = dataclasses.replace(cfg, dtype=dtype, num_layers=layers or cfg.num_layers)
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, encoder_layers=layers or cfg.encoder_layers)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    return cfg


def mesh_batch(cfg, seed, shape):
    """A run's inputs drawn on the CPU from ``seed`` (equal on every rank and in the parent):
    tokens of ``shape`` and, for the audio family, ``cfg.encoder_seq`` stub frames a row, for
    the vlm ``cfg.num_patches`` stub patch embeddings ahead of them."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(shape[0], cfg.encoder_seq, cfg.d_model, generator=gen)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(shape[0], cfg.num_patches, cfg.d_model, generator=gen)
    return batch


def mesh_cache(cfg):
    """A generation's cache length: MESH_CACHE past the vlm's patches, rounded up to a multiple
    of the model extent (so that the caches' sequence shards on it)."""
    M = MESH_SHAPE[1]
    n = MESH_CACHE + (cfg.num_patches if cfg.family == "vlm" else 0)
    return -(-n // M) * M


def mesh_rank_params(cfg, mesh=MESH_SHAPE):
    """The parameters one rank of a (data, model) mesh of extents ``mesh`` holds of ``cfg``'s
    model: each leaf's block under its spec (the largest where a dim does not divide evenly)."""
    from repro_torch.models import build_model
    from repro_torch.models.layers import map_schema
    from repro_torch.sharding.rules import AbstractMesh, make_rules

    rules = make_rules(AbstractMesh(tuple(mesh), ("data", "model")))
    total = 0

    def count(pdef):
        nonlocal total
        n, spec = 1, rules.spec(pdef.shape, pdef.dims)  # trailing replicated dims dropped
        for size, entry in zip(pdef.shape, spec + (None,) * (len(pdef.shape) - len(spec))):
            axes = entry if isinstance(entry, tuple) else (entry,) if entry else ()
            n *= -(-size // math.prod(rules.axis_sizes[a] for a in axes))
        total += n

    map_schema(count, build_model(cfg).schema)
    return total


def on(batch, dev):
    return {k: v.to(dev) for k, v in batch.items()}


def mesh_rank(rank, world, shape, device, serve, train, grpo, raw=False):
    """One rank of phase 10 (started by ``run_ranks``): the sharded serving runs of ``serve``,
    train steps of ``train`` ((label, seed, config) each) and GRPO steps of ``grpo`` ((label,
    seed, config, batch on the CPU) each), each with the launch counts set to 0 just before it
    and read just after, every (kernel, shape) it launches recorded, and the collectives of one
    prefill, one decode step, one train step and one GRPO step counted.  Returns what the
    parent checks (rank 0 also the logits, the GRPO losses, gradients and metrics).  Rank 0
    reads each train step against the unsharded step on its own device
    (``mesh_train_errors``; the gradients stay in the rank) and returns the readings, which
    the parent holds (``mesh_train_line``); with ``raw``, the loss and the gathered
    gradients on the CPU instead."""
    import logging
    import warnings

    t_rank = time.time()
    import torch
    import torch.distributed as dist

    warnings.filterwarnings("ignore")
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.dryrun import CollectiveCounter
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Engine, GenerationConfig
    from repro_torch.sharding.rules import make_rules
    from repro_torch.training import AdamWConfig, grpo_loss, make_grpo_step
    from repro_torch.training.optimizer import adamw_update, init_adamw
    from repro_torch.training.train_step import TrainState, grads_of

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        for k in _build.KERNELS:
            _build.load(k)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rules = make_rules(device_mesh(dev.type, shape, ("data", "model")))
    # DTensor's first import and dispatch take seconds a rank: paid here by all at once, not
    # by each in turn in the first ``in_turn``
    rules.distribute(torch.zeros(world, device=dev), ("batch",))
    # "spans": (what, start, its parameters drawn, end) on the host's clock: each run from its
    # init to its results
    out = {"shapes": set(), "launches": {}, "routes": {}, "walls": {}, "collectives": {},
           "peak_gib": {}, "ssd_heads": {}, "spans": [("start", t_rank, t_rank, time.time())]}
    if cuda:
        plain_adamw_refused().start()
    active = {}
    step_ = ops.adamw_update_

    def optimizer_step(*args, **kwargs):
        """``ops.adamw_update_`` with its collectives recorded under "optimizer <label>"."""
        counter = active["counter"]
        before = {k: (counter.counts[k], counter.collectives[k]) for k in counter.counts}
        res = step_(*args, **kwargs)
        out["collectives"][f"optimizer {active['label']}"] = collective_counts(counter, before)
        return res

    def run(label, fn, engine=None):
        """``fn`` with the launch counts set to 0 just before it and read just after, and its
        collectives counted (one prefill and one decode step apart, through ``engine``; the
        optimizer's within a step)."""
        sync()
        dist.barrier()
        ops.reset_launch_counts()
        counter = CollectiveCounter(bytes_accessed=False)
        active.update(counter=counter, label=label)
        if engine is not None:
            engine.api = FirstCalls(engine.api, counter, out["collectives"], label)
        t0 = time.perf_counter()
        shapes = set()
        with (recording(shapes, kernel_wrappers(train=True)), counter.mode,
              mock.patch.object(ops, "adamw_update_", optimizer_step)):
            res = fn()
        sync()
        out["walls"][label] = time.perf_counter() - t0
        out["launches"][label] = ops.launch_counts()
        out["routes"][label] = ops.route_launch_counts()
        out["shapes"] |= shapes
        # the heads of each B4 launch: the rank's block of the split mixer, or all of them
        out["ssd_heads"][label] = sorted({k[1] for n, k in shapes if n == "ssd_intra_chunk"})
        if engine is None:
            out["collectives"][label] = collective_counts(counter, {})
        return res

    def in_turn(fn):
        """``fn`` on one rank at a time: each draws whole leaves before keeping its blocks."""
        res = None
        for r in range(world):
            if r == rank:
                res = fn()
                sync()
                if cuda:  # the whole leaves' blocks go back to the card for the next rank
                    torch.cuda.empty_cache()
            dist.barrier()
        return res

    for label, seed, cfg in serve:
        t_run = time.time()
        api = build_model(cfg)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        params = in_turn(lambda: api.init(torch.Generator(device=dev).manual_seed(seed), dev,
                                          rules=rules))
        t_init = time.time()
        batch = on(mesh_batch(cfg, seed, (4, PROMPT)), dev)
        engine = Engine(api, params, GenerationConfig(max_new_tokens=MESH_NEW,
                                                      cache_len=mesh_cache(cfg)), rules)
        g = run(f"generate {label}", lambda: engine.generate(batch), engine)
        if cuda:
            out["peak_gib"][label] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.empty_cache()
        if rank == 0:
            out[label] = (g.tokens.cpu(), g.logits.cpu())
        del params, engine
        out["spans"].append((f"generate {label}", t_run, t_init, time.time()))

    opt = AdamWConfig()
    for label, seed, cfg in train:
        t_run = time.time()
        api = build_model(cfg)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        params = in_turn(lambda: api.init(torch.Generator(device=dev).manual_seed(seed), dev,
                                          trainable=True, rules=rules))
        t_init = time.time()
        batch = on(mesh_batch(cfg, seed, MESH_TRAIN_SHAPE), dev)

        def step():
            loss, _ = api.loss_fn(params, batch, rules)
            grads = grads_of(loss, params)
            adamw_update(opt, params, grads, init_adamw(params))
            return loss, grads

        loss, grads = run(f"train step {label}", step)
        if cuda:
            out["peak_gib"][f"train {label}"] = torch.cuda.max_memory_allocated() / 2**30
        # every rank joins the gathers; rank 0 holds the gradients on the card
        got = (float(loss), {k: rules.full(g).cpu() if raw else rules.full(g)
                             for k, g in grads.items()})
        del params, grads
        if cuda:
            torch.cuda.empty_cache()
        if rank == 0:
            out[f"train {label}"] = got if raw else mesh_train_errors(label, seed, cfg, got, dev)
        del got
        out["spans"].append((f"train step {label}", t_run, t_init, time.time()))

    for label, seed, cfg, cpu_batch in grpo:
        t_run = time.time()
        api = build_model(cfg)
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev, trainable=True,
                          rules=rules)
        batch = {k: v.to(dev) for k, v in cpu_batch.items()}
        loss, _ = grpo_loss(params, batch, api, rules)  # the gradients the step takes
        grads = {k: rules.full(g) for k, g in grads_of(loss, params).items()}
        if rank == 0:
            out[f"grpo {label}"] = (float(loss), {k: g.cpu() for k, g in grads.items()})
        del grads
        state = TrainState(params, init_adamw(params))
        _, metrics = run(f"grpo step {label}", lambda: make_grpo_step(api, opt, rules)(state, batch))
        out[f"grpo metrics {label}"] = {k: float(v) for k, v in metrics.items()}
        del params, state
        out["spans"].append((f"grpo step {label}", t_run, t_run, time.time()))
    out["spans"].append(("return", time.time(), time.time(), time.time()))
    return out


def mesh_grpo_batch(cfg, seed, dev):
    """Phase 10's GRPO batch on the CPU: tokens from ``seed``, the rollout log-probs of the
    unsharded policy (the weights every rank draws from ``seed``) scored on ``dev``, a
    reference 0.05 away from them, the second half of each row generated, advantages
    +-1 and +-0.5."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.training.grpo import token_logprobs

    api = build_model(cfg)
    tokens = mesh_batch(cfg, seed, MESH_TRAIN_SHAPE)["tokens"]
    with torch.no_grad():
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev)
        old = token_logprobs(params, tokens.to(dev), api).cpu()
    N, S = tokens.shape
    mask = torch.zeros(N, S - 1)
    mask[:, S // 2:] = 1.0
    noise = torch.randn(old.shape, generator=torch.Generator().manual_seed(seed))
    return {"tokens": tokens, "mask": mask, "advantages": torch.tensor([1.0, -1.0, 0.5, -0.5]),
            "old_logp": old, "ref_logp": old + 0.05 * noise}


def collective_counts(counter, before):
    """{kind: (count, bytes)} of the collectives ``counter`` saw since ``before`` ({kind:
    (count, bytes)} then)."""
    return {k: (counter.counts[k] - before.get(k, (0, 0))[0],
                counter.collectives[k] - before.get(k, (0, 0))[1])
            for k in counter.counts if counter.counts[k] > before.get(k, (0, 0))[0]}


class FirstCalls:
    """A model api whose first ``prefill`` and first ``decode_step`` record the collectives
    that ``counter`` saw during them, under "prefill <label>" and "decode step <label>"."""

    def __init__(self, api, counter, into, label):
        self.api, self.counter, self.into = api, counter, into
        self.label = label.removeprefix("generate ")

    def __getattr__(self, name):
        return getattr(self.api, name)

    def _counted(self, what, fn, *args, **kwargs):
        before = {k: (self.counter.counts[k], self.counter.collectives[k]) for k in self.counter.counts}
        res = fn(*args, **kwargs)
        self.into.setdefault(f"{what} {self.label}", collective_counts(self.counter, before))
        return res

    def prefill(self, *args, **kwargs):
        return self._counted("prefill", self.api.prefill, *args, **kwargs)

    def decode_step(self, *args, **kwargs):
        return self._counted("decode step", self.api.decode_step, *args, **kwargs)


def mesh_full_logits(params, cfg, seq, first, extra):
    """The f32 logits of a full forward over ``seq`` [B, S] at its positions ``first``..;
    ``extra`` holds the batch's other inputs: the audio family's is ``encode`` of its
    ``frames`` and the teacher-forced ``decode_train`` over seq, the vlm's ``patch_embeds``
    come ahead of seq."""
    import torch

    from repro_torch.models import encdec
    from repro_torch.models.layers import logits_fn
    from repro_torch.models.transformer import arange_positions, embed_tokens, forward, with_patches

    with torch.inference_mode():
        if cfg.family == "audio":
            h = encdec.decode_train(params, seq, encdec.encode(params, extra["frames"], cfg), cfg)
        else:
            x, P = with_patches(embed_tokens(params, seq, cfg), extra, cfg)
            h, _ = forward(params, x, arange_positions(*x.shape[:2], seq.device), cfg)
            first += P
        return logits_fn(params, h[:, first:], cfg)


def mesh_serve_errors(cfg, params, batch, got, ref):
    """What a sharded generation (``got``: its tokens [B, N] and logits [B, N, V] on the CPU)
    is held to against the unsharded one on the same weights (``ref``, a Generation), both
    from ``batch`` (the prompt's tokens and the audio family's frames or the vlm's
    patches, on the card):

    * ``rows``: each row's max abs logit error, step by step until that row's tokens part
      (that step included: its logits came from equal inputs), and ``steps``, the steps
      compared per row; ``parted``: for each row whose tokens part, (row, step, the error
      there, the reference's gap between its top two logits there);
    * bf16 only: ``noise``, the unsharded bf16 forward over the reference's sequence, batch 4
      against each row alone (the same weights through other shapes of the same products),
      and ``anchor``, the max abs error of the sharded and of the unsharded logits against
      an f32 forward of the same weights teacher-forced on each one's tokens.
    """
    import torch

    from repro_torch.models.convert import tree_from_flat

    toks, logits = got
    rt, rl = ref.tokens.cpu(), ref.logits.cpu().float()
    rows, steps, parted = [], [], []
    for r in range(toks.shape[0]):
        differ = (toks[r] != rt[r]).nonzero()
        n = int(differ[0]) + 1 if len(differ) else toks.shape[1]
        err = (logits[r, :n].float() - rl[r, :n]).abs()
        rows.append(err.max().item())
        steps.append(n)
        if len(differ):
            top2 = rl[r, n - 1].topk(2).values
            parted.append((r, n - 1, err[n - 1].max().item(), (top2[0] - top2[1]).item()))
    res = {"rows": rows, "steps": steps, "parted": parted}
    if cfg.dtype == "float32":
        return res
    prompt = batch["tokens"]
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    P, dev = prompt.shape[1], prompt.device
    seq = torch.cat([prompt, rt[:, :-1].to(dev)], dim=1)
    alone = torch.cat([mesh_full_logits(params, cfg, seq[i:i + 1], P - 1,
                                        {k: v[i:i + 1] for k, v in extra.items()})
                       for i in range(len(seq))])
    res["noise"] = (alone - mesh_full_logits(params, cfg, seq, P - 1, extra)).abs().max().item()
    # leaf by leaf, as phase 4 makes its f32 copies
    f32 = tree_from_flat({k.replace(".", "/"): v.float() for k, v in params.state_dict().items()})
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    anchor = []
    for t, lg in ((toks, logits), (rt, rl)):
        want = mesh_full_logits(f32, cfg32, torch.cat([prompt, t[:, :-1].to(dev)], dim=1), P - 1,
                                extra)
        anchor.append((lg.float() - want.cpu()).abs().max().item())
    res["anchor"] = tuple(anchor)
    return res


def check_mesh_serve(label, cfg, res):
    """Raises where ``mesh_serve_errors``'s readings break phase 10's limits; returns the tol."""
    tol = SMALL_F32_TOL if cfg.dtype == "float32" else MESH_BF16_TOL[cfg.family]
    if max(res["rows"]) > tol:
        raise AssertionError(f"[mesh] {label}: sharded vs unsharded logits {max(res['rows']):.3e} "
                             f"beyond {tol}")
    for r, step, err, gap in res["parted"]:
        if gap > 2 * err:
            raise AssertionError(f"[mesh] {label}: row {r}'s tokens part at step {step} on a clear "
                                 f"argmax (top-two gap {gap:.3e}, error {err:.3e})")
    if "anchor" in res and res["anchor"][0] > MESH_ANCHOR_RATIO * res["anchor"][1]:
        raise AssertionError(f"[mesh] {label}: the sharded bf16 logits lie {res['anchor'][0]:.3e} "
                             f"from the f32 forward, the unsharded {res['anchor'][1]:.3e}")
    return tol


# B3's, B7's and B4's f32 routes and the kernels they run, counted apart within the kernels'
# launches
F32_ROUTES = {"moe_matmul_tf32x3": "moe_matmul", "moe_matmul_bwd_dbuf_tf32x3": "moe_matmul_bwd_dbuf",
              "moe_matmul_bwd_dw_tf32x3": "moe_matmul_bwd_dw", "ssd_intra_chunk_mma3": "ssd_intra_chunk"}


def check_f32_routes(label, counts, routes, f32=None):
    """Raises unless each route of ``F32_ROUTES`` counted all of its kernel's launches in
    ``counts`` (an f32 run: ``f32`` True) or none (bf16: False); ``f32`` None takes either."""
    for route, kernel in F32_ROUTES.items():
        want = {True: (counts[kernel],), False: (0,), None: (0, counts[kernel])}[f32]
        if routes[route] not in want:
            raise AssertionError(f"{label}: {routes[route]} of {counts[kernel]} {kernel} launches "
                                 f"on its f32 route {route}, expected {' or '.join(map(str, want))}")


def mesh_launches(ranks, cfgs):
    """Raises unless every rank's launches in each of phase 10's runs ("generate <label>",
    "train step <label>", "grpo step <label>") equal ``path_launches`` on the mesh for the
    run's config (``cfgs[label]``), each of B3's, B7's and B4's f32 routes counting all of its
    kernel's launches in an f32 run and none in a bf16 one; returns the launches summed over
    the ranks and runs."""
    total = {}
    for r, res in enumerate(ranks):
        for what, counts in res["launches"].items():
            kind, label = what.split(" ", 1) if what.startswith("generate") else what.split(" step ", 1)
            cfg = cfgs[label]
            expect = (path_launches(cfg, 1, MESH_NEW - 1, mesh=MESH_SHAPE) if kind == "generate"
                      else path_launches(cfg, 0, 0, 1, opt_steps=1, mesh=MESH_SHAPE))
            if counts != expect:
                raise AssertionError(f"[mesh] rank {r} {what}: launches {counts}, expected {expect}")
            check_f32_routes(f"[mesh] rank {r} {what}", counts, res["routes"][what],
                             cfg.dtype == "float32")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    return total


def mesh_timeline(spans, walls, t0, t1):
    """Where a rank's time went: its start (spawn, imports, the kernels loaded) from ``t0``,
    each run's span (its parameters drawn in turn, the run, its results gathered back and,
    for a train step, held) beside its init and wall, and from its return to ``t1`` (its
    results pickled to the parent)."""
    parts = [f"started at {spans[0][3] - t0:.1f}s"]
    for what, a, b, c in spans[1:-1]:
        parts.append(f"{what} {c - a:.1f}s (init {b - a:.1f}, wall {walls[what]:.1f})")
    parts.append(f"results back {t1 - spans[-1][1]:.1f}s after the last run")
    return ", ".join(parts)


def mesh_reference(seed, cfg, got, dev):
    """``mesh_serve_errors`` of phase 10's sharded generation ``got`` against the same weights
    (drawn from ``seed``) unsharded on ``dev``."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.serving.engine import Engine, GenerationConfig

    api = build_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(seed), dev)
    batch = on(mesh_batch(cfg, seed, (4, PROMPT)), dev)
    ref = Engine(api, params, GenerationConfig(max_new_tokens=MESH_NEW, cache_len=mesh_cache(cfg))
                 ).generate(batch)
    return mesh_serve_errors(cfg, params, batch, got, ref)


def hold_mesh_generate(label, seed, cfg, got, dev):
    """Raises where phase 10's sharded generation breaks its limits (``check_mesh_serve``);
    returns its line."""
    res = mesh_reference(seed, cfg, got, dev)
    tol = check_mesh_serve(label, cfg, res)
    extra = ""
    if "anchor" in res:
        extra = (f"; against the f32 forward of the same weights teacher-forced on each one's "
                 f"tokens: sharded {res['anchor'][0]:.3e}, unsharded {res['anchor'][1]:.3e} "
                 f"(limit {MESH_ANCHOR_RATIO}x the unsharded); the unsharded bf16 forward's "
                 f"own noise, batch 4 vs each row alone: {res['noise']:.3e}")
    depth = f"L={cfg.num_layers}" + (f"+{cfg.encoder_layers} encoder" if cfg.family == "audio" else "")
    prompt = f"({cfg.num_patches} patches+{PROMPT})" if cfg.family == "vlm" else PROMPT
    return (f"[mesh] generate {label} ({depth}, d {cfg.d_model}, {cfg.dtype}) 4x{prompt}+{MESH_NEW}"
            f" on the mesh vs unsharded on the card: max abs logit err {max(res['rows']):.3e} (abs "
            f"tol {tol}) over {res['steps']} steps a row, each row until its tokens part{extra}")


def mesh_train_reference(cfg, seed, dev, shards=1, f32=False):
    """(loss, {leaf: gradient}) of the unsharded step on phase 10's train batch for
    ``cfg`` and ``seed``, the same weights as the ranks'; with ``shards`` > 1 taken on each
    data shard's rows apart (the shapes a data rank computes), the losses and gradients
    averaged: the same step where the loss is a mean over the rows; with ``f32``, the f32
    step on an f32 copy of those weights."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.convert import tree_from_flat
    from repro_torch.training.train_step import grads_of

    api = build_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(seed), dev, trainable=True)
    if f32:  # leaf by leaf, as phase 4 makes its f32 copies
        params = tree_from_flat({k.replace(".", "/"): v.detach().float()
                                 for k, v in params.state_dict().items()}, trainable=True)
        api = build_model(dataclasses.replace(cfg, dtype="float32"))
    batch = on(mesh_batch(cfg, seed, MESH_TRAIN_SHAPE), dev)
    n = MESH_TRAIN_SHAPE[0] // shards
    loss, grads = 0.0, {}
    for i in range(shards):
        part = api.loss_fn(params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})[0]
        for k, g in grads_of(part, params).items():
            grads[k] = grads.get(k, 0) + g / shards
        loss += float(part) / shards
    return loss, grads


def train_step_errors(a, b):
    """(loss abs err, the largest gradient err relative to its leaf's largest magnitude in
    ``b``, that leaf) of the step ``a`` against the step ``b`` ((loss, {leaf: gradient}) each);
    raises on a non-finite gradient of ``a`` or an error where ``b``'s leaf is all zero."""
    worst = (0.0, None)
    for k, g in b[1].items():
        e = grad_err(f"[mesh] grad {k}", a[1][k], g, math.inf)[1] or 0.0
        worst = max(worst, (e, k), key=lambda t: t[0])
    return (abs(a[0] - b[0]), *worst)


def mesh_train_errors(label, seed, cfg, got, dev):
    """The readings of phase 10's sharded train step ``got`` (rank 0's loss and gathered
    gradients) against the unsharded step on the same weights (``train_step_errors`` each):

    * ``whole``: against the unsharded step on the whole batch, in the step's own type;
    * ``shards``: where the loss is a mean over the batch's rows (every family but moe,
      whose aux losses are global to the batch), against the unsharded step taken on each
      data shard's rows apart (``mesh_train_reference``: the products in the shapes a data
      rank computes them); ``noise``: that reference against the whole batch's;
    * bf16 only: ``anchor``, the largest gradient error of the sharded and of the unsharded
      bf16 step against the f32 step on an f32 copy of the same weights."""
    whole = mesh_train_reference(cfg, seed, dev)
    res = {"whole": train_step_errors(got, whole)}
    if cfg.family != "moe":
        shards = mesh_train_reference(cfg, seed, dev, MESH_SHAPE[0])
        res["shards"] = train_step_errors(got, shards)
        res["noise"] = train_step_errors(shards, whole)
        del shards
    if cfg.dtype == "bfloat16":
        f32 = mesh_train_reference(cfg, seed, dev, f32=True)
        res["anchor"] = (train_step_errors(got, f32)[1], train_step_errors(whole, f32)[1])
    return res


def check_mesh_train(label, cfg, res):
    """Raises where ``mesh_train_errors``'s readings break phase 10's limits; returns the
    limits ((loss, grads) against the data shards' steps, against the whole batch's).

    f32: the step lies within MESH_GRAD_TOL of the per-shard step (the products in the
    shapes a data rank computes them), and within max(MESH_GRAD_TOL, MESH_ANCHOR_RATIO
    times the noise) of the whole batch's, the noise being the per-shard step's own
    distance from the whole batch's: how far the card's own f32 arithmetic moves the step
    through other shapes of the same products.  bf16: the loss and the gradients within
    MESH_BF16_TRAIN_TOL of both, and the gradients no more than MESH_ANCHOR_RATIO times as
    far from the f32 step as the unsharded bf16 step's."""
    if cfg.dtype == "bfloat16":
        tol_shards = tol_whole = MESH_BF16_TRAIN_TOL[cfg.family]
    else:
        tol_shards = (MESH_GRAD_TOL, MESH_GRAD_TOL)
        whole = max(MESH_GRAD_TOL, MESH_ANCHOR_RATIO * max(res["noise"][:2])) if "noise" in res \
            else MESH_GRAD_TOL
        tol_whole = (whole, whole)
    for what, (tol_loss, tol_grad) in (("shards", tol_shards), ("whole", tol_whole)):
        if what not in res:
            continue
        e_loss, e_grad, leaf = res[what]
        if not (e_loss <= tol_loss and e_grad <= tol_grad):
            raise AssertionError(f"[mesh] train {label} vs the unsharded step ({what}): loss err "
                                 f"{e_loss:.3e} (tol {tol_loss:.3g}), grad {leaf} err "
                                 f"{e_grad:.3e} (tol {tol_grad:.3g})")
    if "anchor" in res and not res["anchor"][0] <= MESH_ANCHOR_RATIO * res["anchor"][1]:
        raise AssertionError(f"[mesh] train {label}: the sharded bf16 gradients lie "
                             f"{res['anchor'][0]:.3e} from the f32 step, the unsharded "
                             f"{res['anchor'][1]:.3e}")
    return tol_shards, tol_whole


def mesh_train_line(label, cfg, res):
    """Raises where phase 10's sharded train step breaks its limits (``check_mesh_train`` on
    rank 0's readings, ``mesh_train_errors``); returns its line."""
    tol_shards, tol_whole = check_mesh_train(label, cfg, res)

    def tol(t):
        return f"tol {t[0]:.3g}" if t[0] == t[1] else f"tol loss {t[0]:.3g}, grads {t[1]:.3g}"

    line = (f"[mesh] train step {label} {cfg.dtype} {MESH_TRAIN_SHAPE[0]}x{MESH_TRAIN_SHAPE[1]}"
            f" on the mesh")
    if "shards" in res:
        line += (f" vs the unsharded step on each data shard's rows: loss err "
                 f"{res['shards'][0]:.2e}, grads err {res['shards'][1]:.2e} ({tol(tol_shards)}); "
                 f"those against the whole batch's (the card's own noise): loss "
                 f"{res['noise'][0]:.2e}, grads {res['noise'][1]:.2e};")
    line += (f" vs the unsharded step on the whole batch: loss err {res['whole'][0]:.2e}, grads "
             f"err {res['whole'][1]:.2e} ({res['whole'][2]}) of each leaf's largest magnitude "
             f"({tol(tol_whole)})")
    if "anchor" in res:
        line += (f"; against the f32 step on the same weights: sharded {res['anchor'][0]:.3e}, "
                 f"unsharded {res['anchor'][1]:.3e} (limit {MESH_ANCHOR_RATIO}x the unsharded)")
    return line


def mesh_ssm_heads(cfg, mesh=MESH_SHAPE):
    """The SSM heads each rank's B4 and B8 launches run on a (data, model) mesh of extents
    ``mesh`` (``ssm.heads_a_rank``: a block of them where the mixer splits over its heads,
    else all of them)."""
    from repro_torch.models.ssm import heads_a_rank
    from repro_torch.sharding.rules import AbstractMesh, make_rules

    return heads_a_rank(make_rules(AbstractMesh(tuple(mesh), ("data", "model"))), cfg)


def path_launches(cfg, prefills, decode_steps, train_steps=0, opt_steps=0, mesh=None, rows=4):
    """Kernel launches of ``prefills`` full forwards, ``decode_steps`` decode
    steps, ``train_steps`` forward-and-backward steps and ``opt_steps`` AdamW
    steps (B9: ``adamw.step_launches`` over the config's parameter leaves, one
    norm and one update launch a table of up to 32 leaves, and the finish).

    Norms per layer: two pre-norms (dense, vlm, moe); the pre-norm and the
    SSM's out_norm over d_inner (ssm); the hybrid's two pre-norms of its
    parallel heads, the SSM's out_norm, the two output norms of the fusion
    and the FFN's pre-norm; then the final norm.  The audio family's full
    forward runs the encoder (two pre-norms a layer, its final norm, a
    non-causal flash attention a layer) and the decoder (three pre-norms a
    layer, the final norm, a causal flash attention and B11's
    cross-attention a layer); its decode step the decoder's norms and one
    B11 decode launch a layer.  A
    training step runs each forward kernel once and, in its backward:
    each norm's dx kernel (the warp route up to D 2048, the block route
    above) and dweight reduce; flash attention's dq and dk/dv kernels, and
    B11's (the audio decoder's cross-attention: in bf16 its statistics pass
    and one pass, in f32 B5's dq and dk/dv kernels at Sk);
    moe_matmul's dbuf and dw kernels for each of its three products;
    ssd_intra_chunk's kernel and its reduce.  With ``cfg.remat`` the
    backward first runs each layer's body again (``layers.remat_layer``):
    every forward kernel inside a layer launches once more a step — its
    norms, its flash attention and cross-attention, its three moe_matmul
    products, its ssd_intra_chunk — and the final norms (the decoder's, and the
    encoder's) and everything outside the layers do not.  No layer's
    recompute stops early: the last op of each that saves a tensor for the
    backward comes after its last kernel (the FFN's products save the
    FFN pre-norm's output; the MoE combine saves the gathered expert
    outputs).  tests/test_torch_hybrid.py and tests/test_torch_backward.py
    hold these counts to the calls the model code makes, with remat on and off.

    ``mesh`` (the (data, model) extents of a mesh): each rank's launches there,
    decoding ``rows`` requests.  A rank runs every kernel of the unsharded path
    once on its own block, as many times: the SSM mixer, split over its heads
    or repeated on every model rank (``ssm.splits``; ``mesh_ssm_heads``),
    launches ssd_intra_chunk (and in training its backward and reduce) L times
    a forward on each rank, and its out_norm runs on whole rows gathered over
    the model axis; the audio decoder's cross-attention is repeated (B11's
    forward L times a forward).  One thing changes: where the audio family's
    cross caches' rows are split over the model axis
    (``encdec.decode_state_specs``: the rows fill the data axes and the
    frames divide the model extent, as 1500 do 3), its decode steps combine
    the rows' softmax in plain PyTorch (``layers._combine_rows``) and launch
    no B11 decode.
    """
    from repro_torch.kernels.adamw import step_launches
    from repro_torch.kernels.rmsnorm import BWD_WARP_MAX_DIM  # wider rows take the block route
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import flat_named

    L, steps, full = cfg.num_layers, prefills + decode_steps + train_steps, prefills + train_steps
    ssm, moe, attn = cfg.family in SSM_FAMILIES, cfg.family == "moe", not cfg.attention_free
    cross = L if cfg.family == "audio" else 0  # B11: the decoder's cross-attention
    # B11's backward: in bf16 its own two kernels, in f32 B5's dq and dkdv at Sk
    cross_own, cross_b5 = (cross, 0) if cfg.dtype == "bfloat16" else (0, cross)
    cross_decode = cross
    if mesh is not None and cross:
        from repro_torch.models.encdec import decode_state_specs
        from repro_torch.sharding.rules import AbstractMesh, make_rules

        spec = decode_state_specs(cfg, make_rules(AbstractMesh(tuple(mesh), ("data", "model"))),
                                  rows, 1).cross_k
        cross_decode = 0 if len(spec) > 2 and spec[2] is not None else cross
    if cfg.family == "audio":
        norms, decode_norms, flash = 2 * cfg.encoder_layers + 3 * L + 2, 3 * L + 1, cfg.encoder_layers + L
        finals = 2
    else:
        norms = decode_norms = (6 if cfg.family == "hybrid" else 2) * L + 1
        flash, finals = L if attn else 0, 1
    again = train_steps if cfg.remat else 0  # the layers' forward kernels under recompute
    inner = L if ssm else 0  # the out_norms over d_inner
    wide = ((inner if cfg.d_inner > BWD_WARP_MAX_DIM else 0)
            + (norms - inner if cfg.d_model > BWD_WARP_MAX_DIM else 0))
    return {
        "rmsnorm": norms * full + decode_norms * decode_steps + (norms - finals) * again,
        "rmsnorm_bwd": (norms - wide) * train_steps,
        "rmsnorm_bwd_wide": wide * train_steps,
        "rmsnorm_bwd_dweight": norms * train_steps,
        "flash_attention": flash * (full + again),
        "flash_attention_bwd_dq": (flash + cross_b5) * train_steps,
        "flash_attention_bwd_dkdv": (flash + cross_b5) * train_steps,
        "cross_attention": cross * (full + again),
        "cross_attention_bwd_stats": cross_own * train_steps,
        "cross_attention_bwd_fused": cross_own * train_steps,
        "flash_decode": cross_decode * decode_steps,
        "moe_matmul": 3 * L * (steps + again) if moe else 0,
        "moe_matmul_bwd_dbuf": 3 * L * train_steps if moe else 0,
        "moe_matmul_bwd_dw": 3 * L * train_steps if moe else 0,
        "ssd_intra_chunk": L * (full + again) if ssm else 0,
        "ssd_intra_chunk_bwd": L * train_steps if ssm else 0,
        "ssd_intra_chunk_bwd_reduce": L * train_steps if ssm else 0,
        **{k: n * opt_steps for k, n in step_launches(
            len(flat_named(build_model(cfg).abstract_params()))).items()},
    }


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was built or run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch

    if Path(repro_torch.__file__).resolve().parent != ROOT / "src" / "repro_torch":
        raise RuntimeError(f"repro_torch imported from {repro_torch.__file__}, not this checkout")
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import adamw as adamw_k
    from repro_torch.kernels import flash_attention as flash_k
    from repro_torch.kernels import moe_matmul as moe_k
    from repro_torch.kernels import rmsnorm as rms_k
    from repro_torch.kernels import ssd_scan as ssd_k
    from repro_torch.launch.serve import build_server, timed_generate
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.train import next_batch, train, trainer_from_config
    from repro_torch.models import build_model
    from repro_torch.models import encdec
    from repro_torch.models.convert import flat_from_params, params_from_flat, tree_from_flat
    from repro_torch.models.layers import CROSS_ATTENTION_RANGE, logits_fn
    from repro_torch.models.transformer import arange_positions, embed_tokens, forward, with_patches
    from repro_torch.serving.engine import Engine, GenerationConfig
    from repro_torch.training import (
        AdamWConfig,
        group_advantages,
        grpo_loss,
        init_train_state,
        make_grpo_step,
    )
    from repro_torch.training.grpo import token_logprobs
    from repro_torch.training.optimizer import flat_named, global_norm, init_adamw
    from repro_torch.training.train_step import TrainState, grads_of, make_train_step

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

    # ---- 1. environment -------------------------------------------------
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] nvidia-smi: {card}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()}")
    print(f"[env] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    for k in _build.KERNELS:
        _build.load(k)
    # the entry points of the backward kernels, bound once here
    rms_k._entries(), flash_k._entries(), moe_k._bwd_entry(), ssd_k._bwd_entries()
    adamw_k._entries()
    print(f"[build] {', '.join(_build.KERNELS)} built and loaded in "
          f"{time.perf_counter() - t0:.1f}s into {_build.BUILD_DIR}; backward entry points: "
          f"rmsnorm_bwd, rmsnorm_bwd_dweight, flash dq, dkdv, B11's statistics pass and one pass, "
          f"flash decode (B11), "
          f"moe_matmul_bwd, "
          f"ssd_intra_chunk_bwd, ssd_intra_chunk_bwd_reduce; AdamW: adamw_norm, "
          f"adamw_norm_finish, adamw_update")

    print(f"[time] phase 2 done at {time.perf_counter() - t_start:.1f}s")

    # ---- 3. kernels vs plain versions -----------------------------------
    gen = torch.Generator(device=dev).manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32

    # hymba-1.5b's shapes (d 1600 and the SSM's d_inner 3200; H 25 / KV 5, hd 64; SSM 50
    # heads x 64, N 16): generation's prefill 4 x 128 and decode 4 x 1, scoring 8 x 160, and
    # the full forward over 4 x 159 tokens that its decode-vs-forward checks run, in bf16 and
    # on the f32 copy of the weights.  Phase 4 fails on any hybrid launch outside them.
    hyb = get_config(HYBRID)
    H_, KV_, hd_, SH, SN = (hyb.num_heads, hyb.num_kv_heads, hyb.resolved_head_dim, hyb.ssm_heads,
                            hyb.ssm_state)
    check_S, score_T = PROMPT + NEW - 1, SCORE_SHAPE[0] * SCORE_SHAPE[1]
    hybrid_rms_cases = [(T, D, dt, f"hymba {what}") for D in (hyb.d_model, hyb.d_inner)
                        for T, dt, what in ((4 * PROMPT, bf16, "prefill"), (4, bf16, "decode"),
                                            (score_T, bf16, "score"), (4 * check_S, bf16, "check"),
                                            (4 * PROMPT, f32, "f32 check prefill"),
                                            (4, f32, "f32 check decode"),
                                            (4 * check_S, f32, "f32 check"))]
    hybrid_flash_cases = [
        (4, H_, KV_, PROMPT, hd_, True, bf16, "hymba prefill"),
        (SCORE_SHAPE[0], H_, KV_, SCORE_SHAPE[1], hd_, True, bf16, "hymba score"),
        (4, H_, KV_, check_S, hd_, True, bf16, "hymba check"),
        (4, H_, KV_, PROMPT, hd_, True, f32, "hymba f32 check prefill"),
        (4, H_, KV_, check_S, hd_, True, f32, "hymba f32 check"),
    ]
    # the forward shapes of phase 6's LM training (4 x 256 granite, 2 x 512 mamba2 and hymba:
    # 1024 rows each; two chunks of 256 a sequence, so four chunks in all)
    lm_rms_cases = [(1024, D, bf16, f"{what} LM") for D, what in (
        (1536, "granite, mamba2 out_norm"), (768, "mamba2"), (1600, "hymba"), (3200, "hymba out_norm"))]
    lm_flash_cases = [(4, 24, 8, 256, 64, True, bf16, "granite LM"),
                      (2, H_, KV_, 512, hd_, True, bf16, "hymba LM")]
    lm_moe_cases = [(40, 256, 1536, 512, bf16, "granite LM gate/up"),
                    (40, 256, 512, 1536, bf16, "granite LM down")]
    lm_ssd_cases = [(2, 2, 256, 24, 128, bf16, "mamba2 LM"), (2, 2, 256, 24, 128, f32, ""),
                    (2, 2, 256, SH, SN, bf16, "hymba LM"), (2, 2, 256, SH, SN, f32, "")]
    # mamba2's block on each rank of phase 10's mesh, its mixer split over its heads (8 of 24):
    # 2 rows of the batch, one chunk of the prefill's 128 tokens and of the train step's 64
    MH = mesh_ssm_heads(get_config("mamba2-130m"))
    mesh_ssd_cases = [(2, 1, PROMPT, MH, 128, bf16, "mamba2 mesh rank prefill"),
                      (2, 1, PROMPT, MH, 128, f32, "mamba2 mesh rank prefill"),
                      (2, 1, MESH_TRAIN_SHAPE[1], MH, 128, bf16, "mamba2 mesh rank train"),
                      (2, 1, MESH_TRAIN_SHAPE[1], MH, 128, f32, "mamba2 mesh rank train")]
    hybrid_ssd_cases = [  # one chunk each: Q = S <= ssm_chunk (256)
        (4, 1, PROMPT, SH, SN, bf16, "hymba prefill"),
        (SCORE_SHAPE[0], 1, SCORE_SHAPE[1], SH, SN, bf16, "hymba score"),
        (4, 1, check_S, SH, SN, bf16, "hymba check"),
        (4, 1, PROMPT, SH, SN, f32, "hymba f32 check prefill"),
        (SCORE_SHAPE[0], 1, SCORE_SHAPE[1], SH, SN, f32, ""),
        (4, 1, check_S, SH, SN, f32, "hymba f32 check"),
    ]

    # the slice's models (llama3-8b and glm4-9b: d 4096, 32 H / 8 and 2 KV, hd 128; internvl2-1b:
    # d 896, 14 H / 2 KV, 256 patches; whisper-medium: d 1024, 16 H / 16 KV over 1500 frames) at
    # their score, prefill and LM shapes, forward here and backward in phase 5.  Every other
    # shape their runs launch (decode rows, the checks' batches, the f32 copies, whisper's
    # decoder) is held against its plain version where it is launched (hold_at_shape).
    ivl_T = 256 + PROMPT  # internvl's prefill: the patches ahead of the prompt
    slice_rms_cases = [(score_T, 4096, bf16, "llama3-8b, glm4-9b score"),
                       (4, 4096, bf16, "llama3-8b, glm4-9b decode"),
                       (4 * 1500, 1024, bf16, "whisper-medium encoder"),
                       (4 * ivl_T, 896, bf16, "internvl2-1b prefill")]
    slice_flash_cases = [(SCORE_SHAPE[0], 32, 8, SCORE_SHAPE[1], 128, True, bf16, "llama3-8b score"),
                         (SCORE_SHAPE[0], 32, 2, SCORE_SHAPE[1], 128, True, bf16, "glm4-9b score"),
                         (4, 16, 16, 1500, 64, False, bf16, "whisper-medium encoder"),
                         (4, 14, 2, ivl_T, 64, True, bf16, "internvl2-1b prefill"),
                         (4, 32, 8, 256, 128, True, bf16, "llama3-8b LM"),
                         (4, 32, 2, 256, 128, True, bf16, "glm4-9b LM")]
    slice_flash_bwd_cases = [(2, 16, 16, 1500, 64, False, bf16, "whisper-medium LM encoder"),
                             (4, 14, 2, 512, 64, True, bf16, "internvl2-1b LM"),
                             (4, 32, 8, 256, 128, True, bf16, "llama3-8b LM"),
                             (4, 32, 2, 256, 128, True, bf16, "glm4-9b LM")]
    slice_rms_bwd_cases = [(4 * 512, 896, bf16, "internvl2-1b LM"),
                           (2 * 1500, 1024, bf16, "whisper-medium LM encoder"),
                           (1024, 4096, bf16, "llama3-8b, glm4-9b LM")]

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def measure(fn, plain, library, bnd, plain_iters=30):
        """Kernel device ms, one call's wall ms, plain ms, library ms (or None), bound."""
        ms, wall = cuda_ms(fn), call_ms(fn)
        plain_ms = cuda_ms(plain, iters=plain_iters)
        lib = cuda_ms(library) if library is not None else None
        return dict(ms=ms, wall=wall, plain_ms=plain_ms, library_ms=lib, bound_ms=bnd[0],
                    bound_by=bnd[1])

    def report(label, err, tol, m, lib_name):
        """err: a max abs error, or grad_err's (abs, relative) pairs of the gradients."""
        if isinstance(err, list):
            err = (f"{max(e for e, _ in err):.2e} abs, "
                   f"{max(r for _, r in err if r is not None):.2e} of the reference's largest")
        else:
            err = f"{err:.2e}"
        lib = f"{lib_name} {m['library_ms']:.4f} ms" if m["library_ms"] is not None else lib_name
        print(f"[kernel] {label}: err {err} (tol {tol}) kernel {m['ms']:.4f} ms (one call "
              f"{m['wall']:.4f} ms wall) plain {m['plain_ms']:.4f} ms {lib} bound "
              f"{m['bound_ms']:.4f} ms ({m['bound_by']}) [{card}]")

    def row(err, m):
        return dict(max_abs_err=err, **{k: v for k, v in m.items() if k != "wall"})

    # the floor under every launch: a one-thread kernel that does nothing
    empty = _build.load("launch_floor").launch_floor_empty
    empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    floor_ms = cuda_ms(lambda: _build.check("launch_floor", empty(stream)))
    print(f"[kernel] launch floor: one-thread empty kernel {floor_ms:.4f} ms [{card}]")

    rms_rows = {}
    rms_cases = [  # (T, D, dtype, what)
        (4 * 128, 960, torch.bfloat16, "smollm prefill"),
        (4, 960, torch.bfloat16, "smollm decode"),
        (8 * 160, 2048, torch.bfloat16, "llama score"),
        (8 * 160, 1536, torch.bfloat16, "granite score, mamba2 out_norm prefill"),
        (LOOP_N, 960, torch.bfloat16, "closed loop decode"),
        (LOOP_N * LOOP_PROMPT, 960, torch.bfloat16, "closed loop prefill"),
        (LOOP_SEQ, 2048, torch.bfloat16, "closed loop judge"),
        (LOOP_N * LOOP_SEQ, 960, torch.bfloat16, "closed loop old_logp, GRPO"),
        *hybrid_rms_cases,
        *lm_rms_cases,
        *slice_rms_cases,
        (1000, 2048, torch.bfloat16, ""),
        (1000, 960, torch.bfloat16, ""),
        (1000, 2048, torch.float32, ""),
        (1000, 960, torch.float32, ""),
        (64, 64, torch.float32, "live payload"),
        (8, 64, torch.float32, "live warm-up"),
    ]
    for T, D, dt, what in rms_cases:
        x = randn(T, D, dtype=dt) * 3
        w = (1 + 0.1 * randn(D, dtype=torch.float32)).to(dt)
        tol = BF16_TOL if dt == torch.bfloat16 else RMSNORM_F32_TOL
        got = ops.rmsnorm_op(x, w)
        if not torch.equal(got, ops.rmsnorm_op(x, w)):
            raise AssertionError(f"rmsnorm {T}x{D} {dt}: two calls differ")
        err = assert_close(f"rmsnorm {T}x{D} {dt}", got, ref.rmsnorm_ref(x, w), tol)
        m = measure(lambda: ops.rmsnorm_op(x, w), lambda: ref.rmsnorm_ref(x, w),
                    lambda: F.rms_norm(x, (D,), w, 1e-5), rmsnorm_bound(T, D, x.element_size()))
        rms_rows[(T, D, dt)] = row(err, m)
        report(f"rmsnorm T={T} D={D} {str(dt)[6:]} {what}", err, tol, m, "F.rms_norm")
        plan = rms_k.fwd_plan(T, D, dt)
        print(f"[kernel]   rmsnorm plan: route {plan.route}, {plan.blocks} blocks of {plan.warps} "
              f"warps, {plan.rows_per_warp} row(s) a warp, {plan.vec} elements a load; "
              f"{100 * m['bound_ms'] / m['ms']:.1f}% of its bound, {m['ms'] - floor_ms:+.4f} ms against "
              f"the launch floor {floor_ms:.4f} ms (a dependent launch may start under the one "
              f"before it); two calls bit-identical")
    decode_ms = rms_rows[(4, 960, torch.bfloat16)]["ms"]
    print(f"[kernel] rmsnorm smollm decode [4, 960]: {decode_ms:.4f} ms, "
          f"{1e3 * (decode_ms - floor_ms):+.2f} us against the launch floor [{card}]")
    # the warp route's element-at-a-time form (D off the vector, rows off 16 bytes) and its
    # walks of several rows a warp, which the models' shapes do not reach: held, not timed
    for T, D, lay in ((1, 2048, "offset"), (3, 100, "dense"), (257, 1001, "strided"),
                      (5000, 2047, "dense"), (6341, 960, "offset"), (6341, 960, "strided")):
        for dt in (torch.bfloat16, torch.float32):
            base = randn(T * (D + 3) + 1, dtype=dt) * 3
            x = (base[1:T * D + 1].view(T, D) if lay == "offset" else
                 base[:T * (D + 3)].view(T, D + 3)[:, :D] if lay == "strided" else base[:T * D].view(T, D))
            w = (1 + 0.1 * randn(D, dtype=torch.float32)).to(dt)
            got = rms_k.rmsnorm(x, w)
            if not torch.equal(got, rms_k.rmsnorm(x, w)):
                raise AssertionError(f"rmsnorm {T}x{D} {lay} {dt}: two calls differ")
            assert_close(f"rmsnorm {T}x{D} {lay} {dt}", got, ref.rmsnorm_ref(x, w),
                         BF16_TOL if dt == torch.bfloat16 else RMSNORM_F32_TOL)
    print(f"[kernel] rmsnorm warp route held in its element-at-a-time form and past one wave "
          f"(6 shapes x bf16, f32: offset and strided rows, D 100 / 1001 / 2047; T 1 to 6341), "
          f"each twice bit-identical [{card}]")

    flash_rows = {}
    flash_cases = [  # (B, H, KV, S, d, causal, dtype, what)
        (4, 15, 5, 128, 64, True, torch.bfloat16, "smollm prefill"),
        (8, 32, 8, 160, 64, True, torch.bfloat16, "llama score"),
        (8, 24, 8, 160, 64, True, torch.bfloat16, "granite score"),
        (LOOP_N, 15, 5, LOOP_PROMPT, 64, True, torch.bfloat16, "closed loop prefill"),
        (1, 32, 8, LOOP_SEQ, 64, True, torch.bfloat16, "closed loop judge"),
        (LOOP_N, 15, 5, LOOP_SEQ, 64, True, torch.bfloat16, "closed loop old_logp, GRPO"),
        *hybrid_flash_cases,
        *lm_flash_cases,
        *slice_flash_cases,
    ]
    for S in (160, 1024, 2048):
        for H, KV in ((32, 8), (15, 5)):
            for causal in (True, False):
                flash_cases.append((4, H, KV, S, 64, causal, torch.bfloat16, ""))
    flash_cases += [  # f32: the split-TF32 route ("tf32x3")
        (4, 32, 8, 160, 64, True, torch.float32, ""),
        (4, 15, 5, 1024, 64, False, torch.float32, ""),
        (2, 8, 2, 1000, 128, True, torch.bfloat16, "ragged S, d=128"),
        (2, 8, 2, 1000, 128, False, torch.float32, "ragged S, d=128"),
        (4, 16, 16, 1500, 64, False, torch.float32, "whisper f32 encoder"),
    ]
    for B, H, KV, S, d, causal, dt, what in flash_cases:
        q = randn(B, H, S, d, dtype=dt)
        k = randn(B, KV, S, d, dtype=dt)
        v = randn(B, KV, S, d, dtype=dt)
        tol = BF16_TOL if dt == torch.bfloat16 else FLASH_F32_TOL
        got = ops.flash_attention_op(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal)
        err = assert_close(f"flash {B},{H},{KV},{S},{d} causal={causal} {dt}", got, want, tol)
        # the model's layout: [B,S,H,d] tensors as transposed views, read in place
        qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
        assert torch.equal(ops.flash_attention_op(qs, ks, vs, causal=causal), got)
        m = measure(lambda: ops.flash_attention_op(q, k, v, causal=causal),
                    lambda: ref.flash_attention_ref(q, k, v, causal),
                    lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                           enable_gqa=True),
                    flash_bound(B, H, KV, S, d, causal, q.element_size()), plain_iters=5)
        flash_rows[(B, H, KV, S, d, causal, dt)] = row(err, m)
        report(f"flash B={B} H={H} KV={KV} S={S} d={d} causal={causal} {str(dt)[6:]} {what}",
               err, tol, m, "sdpa")
        if dt == torch.float32:
            plan = flash_k.launch_plan(B, H, S, d, dt)
            print(f"[kernel]   f32 plan: {plan.route}, {plan.block_q} query rows a block, K/V tiles "
                  f"of {plan.block_k} keys, grid {plan.grid}, {plan.threads} threads, "
                  f"{plan.smem_bytes} bytes of shared memory")
    del q, k, v, qs, ks, vs, got, want

    # B11: attention over keys of their own length (whisper's decoder over its encoder's 1500
    # frames) at the prefill, LM and decode-vs-forward check shapes, bf16 and on the f32 copy,
    # with tails of S and Sk, GQA g 4 and 7 and head dim 128; then its decode form over FLAT
    # caches, read in place as the model holds them
    t_b11 = time.perf_counter()
    cross_rows, decode_rows = {}, {}
    cross_cases = [  # (B, H, KV, S, Sk, d, dtype, what)
        (4, 16, 16, PROMPT, 1500, 64, bf16, "whisper prefill"),
        (2, 16, 16, 448, 1500, 64, bf16, "whisper LM"),
        (4, 16, 16, check_S, 1500, 64, bf16, "whisper check"),
        (1, 16, 16, check_S, 1500, 64, bf16, "whisper check, a row alone"),
        (4, 16, 16, PROMPT, 1500, 64, f32, "whisper f32 check prefill"),
        (4, 16, 16, check_S, 1500, 64, f32, "whisper f32 check"),
        (2, 16, 16, 448, 1500, 64, f32, ""),
        (2, 4, 4, 1, 1500, 64, bf16, "S 1"),
        (2, 8, 2, 65, 63, 64, bf16, "S 65, Sk 63, g 4"),
        (2, 14, 2, 65, 1, 64, bf16, "Sk 1, g 7"),
        (2, 14, 2, 160, 1500, 64, bf16, "g 7"),
        (2, 8, 2, 100, 1500, 128, bf16, "d 128, g 4"),
        (2, 8, 2, 65, 63, 64, f32, "S 65, Sk 63, g 4"),
        (2, 14, 2, 160, 1500, 128, f32, "g 7, d 128"),
    ]
    for B, H, KV, S, Sk, d, dt, what in cross_cases:
        # the model's layout: [B, S, H, d] and [B, Sk, KV, d] memory as transposed views
        q, k, v = (randn(B, n, h, d, dtype=dt).transpose(1, 2) for n, h in ((S, H), (Sk, KV), (Sk, KV)))
        tol = BF16_TOL if dt == bf16 else FLASH_F32_TOL
        got = ops.cross_attention_op(q, k, v)
        err = assert_close(f"cross {B},{H},{KV},{S},{Sk},{d} {dt}", got,
                           ref.flash_attention_ref(q, k, v, False), tol)
        if not torch.equal(ops.cross_attention_op(q, k, v), got):  # a fixed combine order
            raise AssertionError(f"cross {B},{H},{KV},{S},{Sk},{d} {dt}: two calls differ")
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        m = measure(lambda: ops.cross_attention_op(q, k, v),
                    lambda: ref.flash_attention_ref(q, k, v, False),
                    lambda: F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True),
                    flash_bound(B, H, KV, S, d, False, q.element_size(), Sk), plain_iters=5)
        cross_rows[(B, H, KV, S, Sk, d, dt)] = row(err, m)
        report(f"cross_attention B={B} H={H} KV={KV} S={S} Sk={Sk} d={d} {str(dt)[6:]} {what}",
               err, tol, m, "sdpa")
        plan = flash_k.cross_plan(B, H, KV, S, Sk, d, dt)
        print(f"[kernel]   cross plan: {plan.route}, {plan.block_q} query rows a block, "
              f"{plan.splits} splits of {plan.chunk} keys (a cluster), grid {plan.grid}, "
              f"{plan.threads} threads, {plan.smem_bytes} bytes of shared memory; two calls "
              f"bit-identical")
        if (B, S, dt) == (2, 448, bf16):  # the LM shape: the lse the backward reads
            _, lse = flash_k.cross_attention(q, k, v, lse=True)
            err = cross_lse_err(q, k, lse)
            if not err <= CROSS_LSE_TOL:
                raise AssertionError(f"cross lse {B},{H},{S},{Sk}: {err:.2e} > {CROSS_LSE_TOL}")
            print(f"[kernel]   cross lse at the LM shape vs the plain log-sum-exp: {err:.2e} of "
                  f"each row's magnitude (tol {CROSS_LSE_TOL})")
    # B11's kernel at whisper's encoder shape S = Sk = 1500, where B2 runs (not routed):
    # beside B2's row of the same shape above and sdpa
    q, k, v = (randn(4, 1500, 16, 64, dtype=bf16).transpose(1, 2) for _ in range(3))
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    err = assert_close("cross 4,16,16,1500,1500,64 (encoder shape)", flash_k.cross_attention(q, k, v),
                       ref.flash_attention_ref(q, k, v, False), BF16_TOL)
    m = measure(lambda: flash_k.cross_attention(q, k, v),
                lambda: ref.flash_attention_ref(q, k, v, False),
                lambda: F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True),
                flash_bound(4, 16, 16, 1500, 64, False, 2), plain_iters=5)
    report("cross_attention B=4 H=16 KV=16 S=1500 Sk=1500 d=64 bf16 whisper encoder shape "
           f"(not routed; B2 {flash_rows[(4, 16, 16, 1500, 64, False, bf16)]['ms']:.4f} ms)",
           err, BF16_TOL, m, "sdpa")
    decode_cases = [  # (B, H, KV, Sk, n, d, dtype, what): n of the cache's Sk keys attended
        (4, 16, 16, 1500, 1500, 64, bf16, "whisper decode"),
        (4, 16, 16, 1500, 1500, 64, f32, "whisper f32 check decode"),
        (4, 16, 4, 1500, 1500, 128, bf16, "d 128, g 4"),
        (4, 16, 16, 1500, 700, 64, bf16, "700 of 1500 keys"),
        (2, 14, 2, 777, 777, 64, bf16, "g 7"),
        (2, 8, 2, 1, 1, 64, f32, "one key"),
    ]
    for B, H, KV, Sk, n, d, dt, what in decode_cases:
        q = randn(B, 1, H, d, dtype=dt).transpose(1, 2)  # the model's q [B, 1, H, d] as a view
        kc, vc = randn(B, Sk, KV * d, dtype=dt), randn(B, Sk, KV * d, dtype=dt)
        tol = BF16_TOL if dt == bf16 else FLASH_F32_TOL
        got = ops.decode_attention_op(q, kc, vc, n)
        err = assert_close(f"decode {B},{H},{KV},{Sk},{n},{d} {dt}", got,
                           ref.decode_attention_ref(q, kc, vc, n), tol)
        if not torch.equal(ops.decode_attention_op(q, kc, vc, n), got):  # a fixed combine order
            raise AssertionError(f"decode {B},{H},{KV},{Sk},{n},{d} {dt}: two calls differ")
        kv_view, vv_view = (t[:, :n].view(B, n, KV, d).transpose(1, 2) for t in (kc, vc))
        m = measure(lambda: ops.decode_attention_op(q, kc, vc, n),
                    lambda: ref.decode_attention_ref(q, kc, vc, n),
                    lambda: F.scaled_dot_product_attention(q, kv_view, vv_view, enable_gqa=True),
                    decode_bound(B, H, KV, n, d, q.element_size()))
        decode_rows[(B, H, KV, Sk, n, d, dt)] = row(err, m)
        plan = flash_k.decode_plan(B, H, KV, n, d)
        report(f"flash_decode B={B} H={H} KV={KV} Sk={Sk} n={n} d={d} {str(dt)[6:]} {what}",
               err, tol, m, "sdpa")
        print(f"[kernel]   decode plan: {plan.splits} splits of {plan.chunk} keys (a cluster), "
              f"{plan.rows} query rows a block, grid {plan.grid}, {plan.threads} threads, "
              f"{plan.smem_bytes} bytes of shared memory; two calls bit-identical")
    del q, kc, vc, got, kv_view, vv_view
    print(f"[time] B11's {len(cross_cases)} forward cases, the encoder-shape row and "
          f"{len(decode_cases)} decode cases took "
          f"{time.perf_counter() - t_b11:.1f}s")

    moe_rows = {}
    moe_cases = [  # (E, C, D, F, dtype, what): granite's experts at its three capacities
        (40, 128, 1536, 512, torch.bfloat16, "granite prefill gate/up"),
        (40, 128, 512, 1536, torch.bfloat16, "granite prefill down"),
        (40, 8, 1536, 512, torch.bfloat16, "granite decode gate/up"),
        (40, 8, 512, 1536, torch.bfloat16, "granite decode down"),
        (40, 384, 1536, 512, torch.bfloat16, "granite score gate/up"),
        (40, 384, 512, 1536, torch.bfloat16, "granite score down"),
        *lm_moe_cases,
        # f32 (the "tf32x3" route): granite's LM gate/up and down, score, decode and a mesh rank's
        # experts (42 padded experts over 3 model ranks, 2 rows x 128 tokens drop-free)
        (40, 256, 1536, 512, torch.float32, "granite LM gate/up in f32"),
        (40, 256, 512, 1536, torch.float32, "granite LM down in f32"),
        (40, 1024, 1536, 512, torch.bfloat16, "longer"),
        (40, 384, 1536, 512, torch.float32, ""),
        (40, 8, 1536, 512, torch.float32, "granite decode gate/up in f32"),
        (14, 256, 1536, 512, torch.float32, "granite f32 mesh rank gate/up"),
        (5, 130, 200, 72, torch.float32, "ragged"),
        (3, 130, 264, 200, torch.bfloat16, "partial C, D and F tiles"),
        (3, 70, 100, 36, torch.bfloat16, "ragged, unaligned rows"),
    ]
    for E, C, D, Fd, dt, what in moe_cases:
        buf = randn(E, C, D, dtype=dt)
        w = randn(E, D, Fd, dtype=dt) * 0.05
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        got = ops.moe_matmul_op(buf, w)
        plan = moe_k.last_plan  # the plan this call launched
        err = assert_close(f"moe_matmul {E},{C},{D},{Fd} {dt}", got, ref.moe_matmul_ref(buf, w), tol)
        if not torch.equal(ops.moe_matmul_op(buf, w), got):  # one summation order, no atomics
            raise AssertionError(f"moe_matmul {E},{C},{D},{Fd} {dt}: two calls differ")
        m = measure(lambda: ops.moe_matmul_op(buf, w), lambda: ref.moe_matmul_ref(buf, w),
                    lambda: torch.bmm(buf, w), moe_bound(E, C, D, Fd, buf.element_size()))
        moe_rows[(E, C, D, Fd, dt)] = row(err, m)
        report(f"moe_matmul E={E} C={C} D={D} F={Fd} {str(dt)[6:]} {what}", err, tol, m, "bmm")
        print(f"[kernel]   launch plan: route {plan.route}, tile {plan.block_m} x {plan.block_n} x "
              f"{plan.block_k}, {plan.stages} stages, {plan.threads} threads, grid {plan.grid} for "
              f"{plan.tiles} tiles, {plan.smem_bytes} bytes of shared memory; two calls bit-identical")
    del buf, w, got

    ssd_rows = {}
    ssd_cases = [  # (B, NC, Q, H, N, dtype, what), hd = 64; BNC = B*NC
        (4, 1, 128, 24, 128, torch.bfloat16, "mamba2 prefill"),
        (8, 1, 160, 24, 128, torch.bfloat16, "mamba2 score"),
        (2, 4, 128, 24, 128, torch.bfloat16, ""),
        (2, 3, 160, 24, 128, torch.bfloat16, ""),
        (4, 4, 256, 24, 128, torch.bfloat16, "4 x 1024 tokens"),
        (2, 4, 128, 24, 128, torch.float32, ""),
        (2, 3, 160, 24, 128, torch.float32, ""),
        (4, 4, 256, 24, 128, torch.float32, "4 x 1024 tokens"),
        *hybrid_ssd_cases,
        *lm_ssd_cases,
        *mesh_ssd_cases,
    ]
    hd = 64
    for B, NC, Q, H, N, dt, what in ssd_cases:
        BNC = B * NC
        x = randn(BNC, H, Q, hd, dtype=dt) * 0.5
        b = randn(BNC, Q, N, dtype=torch.float32) * 0.5
        c = randn(BNC, Q, N, dtype=torch.float32) * 0.5
        cum = -torch.cumsum(0.1 * torch.rand(BNC, H, Q, generator=gen, device=dev), dim=-1)
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        y, st = ops.ssd_intra_chunk_op(x, b, c, cum)
        y_ref, st_ref = ref.ssd_intra_chunk_ref(x, b, c, cum)
        err = max(assert_close(f"ssd y B={B} NC={NC} Q={Q} {dt}", y, y_ref, tol),
                  assert_close(f"ssd state B={B} NC={NC} Q={Q} {dt}", st, st_ref, F32_TOL))
        m = measure(lambda: ops.ssd_intra_chunk_op(x, b, c, cum),
                    lambda: ref.ssd_intra_chunk_ref(x, b, c, cum), None,
                    ssd_bound(BNC, H, Q, hd, N, x.element_size()))
        ssd_rows[(BNC, H, Q, N, dt)] = row(err, m)
        report(f"ssd_intra_chunk B={B} NC={NC} Q={Q} H={H} hd={hd} N={N} {str(dt)[6:]} {what}",
               err, f"{tol} y, {F32_TOL} state", m, "no single PyTorch call computes it")
        plan = ssd_k.launch_plan(BNC, H, Q, hd, N, dt)  # the kernel refuses any other
        fma_ms = ssd_fma_bound(BNC, H, Q, hd, N, x.element_size())[0]
        print(f"[kernel]   launch plan: route {plan.route}, {plan.heads_per_block} heads per y "
              f"block, {plan.y_blocks} y and {plan.state_blocks} state blocks per chunk, grid "
              f"{plan.grid}, {plan.threads} threads, {plan.smem_bytes} bytes of shared memory"
              + ("" if dt == torch.bfloat16 else f"; the FMA-rate bound {fma_ms:.4f} ms"))
    del x, b, c, cum, y, st, y_ref, st_ref
    torch.cuda.empty_cache()

    print(f"[time] phase 3 done at {time.perf_counter() - t_start:.1f}s")

    # every (kernel, shape) that a guarded run launches must be one that phase 3 (or, for the
    # backward kernels, phase 5) held against its plain version
    checked_shapes = {
        "flash_attention": {c[:7] for c in flash_cases},
        "cross_attention": {c[:7] for c in cross_cases},
        "flash_decode": {c[:7] for c in decode_cases},
        "rmsnorm": {c[:3] for c in rms_cases},
        "ssd_intra_chunk": {(B * NC, H, Q, 64, N, dt) for B, NC, Q, H, N, dt, _ in ssd_cases},
    }
    forward_wrappers = kernel_wrappers()

    def assert_checked(label, shapes):
        hold_unchecked(label, shapes, checked_shapes, lambda k, key: hold_at_shape(k, key, dev, gen))

    # ---- 4. serving at full width -----------------------------------------
    launches = dict.fromkeys(ops.launch_counts(), 0)
    route_launches = dict.fromkeys(ops.route_launch_counts(), 0)  # the f32 routes' kernels

    def check_counts(label, counts, expect):
        if counts != expect:
            raise AssertionError(f"{label} launches {counts}, expected {expect}")
        for k, v in counts.items():
            launches[k] += v
        routes = ops.route_launch_counts()  # read with counts, before any reset
        check_f32_routes(label, counts, routes)
        for k, v in routes.items():
            route_launches[k] += v

    def full_logits_last(params, cfg, batch, seq):
        """The last position's logits of a full forward over the prompt's inputs and seq:
        ``forward`` after the vlm's patches, or the audio family's ``encode`` and
        teacher-forced ``decode_train`` over the same frames."""
        with torch.inference_mode():
            if cfg.family == "audio":
                enc = encdec.encode(params, batch["frames"], cfg)
                h = encdec.decode_train(params, seq, enc, cfg)
            else:
                x, _ = with_patches(embed_tokens(params, seq, cfg), batch, cfg)
                h, _ = forward(params, x, arange_positions(*x.shape[:2], dev), cfg)
            return logits_fn(params, h[:, -1:], cfg)[:, 0]

    def run_generate(arch, seed):
        """4 x (PROMPT + NEW) greedy at full width through the launcher's server."""
        marks = [time.perf_counter()]
        server = build_server(arch, requests=4, prompt_len=PROMPT, new=NEW, full=True,
                              device=dev, seed=seed, frames=get_config(arch).encoder_seq)
        cfg = server.cfg
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out, cold_s = timed_generate(server)
        counts = ops.launch_counts()
        check_counts(f"generate {cfg.name}", counts, path_launches(cfg, 1, NEW - 1))
        mem = torch.cuda.max_memory_allocated() / 2**30
        if out.tokens.shape != (4, NEW) or not bool(torch.isfinite(out.logits).all()):
            raise AssertionError(f"generate {cfg.name}: wrong shape or non-finite logits")
        _, warm_s = timed_generate(server)
        marks.append(time.perf_counter())
        params, prompts, batch = server.engine.params, server.prompts, server.batch

        def last_step_error(check_cfg, check_params, tol, label, exact_argmax=True):
            """Generate with check_cfg, then hold the last decode step against a full forward."""
            check = out
            if check_cfg is not cfg:
                engine = Engine(build_model(check_cfg), check_params, server.engine.gen)
                check = engine.generate(batch)
            seq = torch.cat([prompts, check.tokens[:, :-1]], dim=1)
            full = full_logits_last(check_params, check_cfg, batch, seq)
            last = check.logits[:, -1]
            err = assert_close(f"{cfg.name} decode vs forward logits, {label}", last, full, tol,
                               rel=False)
            differ = last.argmax(-1) != full.argmax(-1)
            if cfg.family not in SSM_FAMILIES and exact_argmax and bool(differ.any()):
                raise AssertionError(f"{cfg.name}: decode and forward disagree on the argmax")
            # ssm, hybrid and the d-4096 dense models (SERVE_BF16_MODEL_TOL): argmax may differ
            # only where the forward's top two lie within 2 err
            top2 = full.topk(2, dim=-1).values
            if bool((differ & (top2[:, 0] - top2[:, 1] > 2 * err)).any()):
                raise AssertionError(f"{cfg.name}: decode and forward disagree on a clear argmax")
            return (f"{label}: max abs err {err:.3e} (abs tol {tol:.4g}, |logits| max "
                    f"{full.abs().max().item():.2f}), argmax agrees on {int((~differ).sum())}/4")

        tol = SERVE_BF16_MODEL_TOL.get(arch, SERVE_BF16_LOGIT_TOL[cfg.family])
        if cfg.family == "moe":  # capacity C >= T: nothing is dropped in prefill, decode or forward
            nodrop = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
            checks = [last_step_error(nodrop, params, tol, "bf16, drop-free config copy")]
        else:
            checks = [last_step_error(cfg, params, tol, "bf16",
                                      exact_argmax=arch not in SERVE_BF16_MODEL_TOL)]
        if arch in SLICE:  # the bf16 forward's own noise: the same forward, each row alone
            seq = torch.cat([prompts, out.tokens[:, :-1]], dim=1)
            rows = torch.cat([full_logits_last(params, cfg, {k: v[i:i + 1] for k, v in batch.items()},
                                               seq[i:i + 1]) for i in range(seq.shape[0])])
            noise = (rows - full_logits_last(params, cfg, batch, seq)).abs().max().item()
            if noise > tol:
                raise AssertionError(f"{cfg.name}: the bf16 forward, batch 4 against each row "
                                     f"alone, differs by {noise:.3e}, beyond {tol}")
            checks.append(f"the bf16 forward's own noise, batch 4 vs each row alone: {noise:.3e} "
                          f"(limit {tol:.4g})")
        if cfg.family in SSM_FAMILIES or arch in SLICE:
            # leaf by leaf: a deep copy of the 9.4 B bf16 weights and its f32 would not fit
            f32_params = tree_from_flat({k.replace(".", "/"): v.float()
                                         for k, v in params.state_dict().items()})
            checks.append(last_step_error(dataclasses.replace(cfg, dtype="float32"), f32_params,
                                          SERVE_F32_LOGIT_TOL, "f32 copy of the weights"))
            del f32_params
        marks.append(time.perf_counter())
        inputs = {"vlm": f" after {cfg.num_patches} patches",
                  "audio": f" over {batch.get('frames', prompts).shape[1]} frames (encoder "
                           f"L={cfg.encoder_layers})"}.get(cfg.family, "")
        print(f"[serve] generate {cfg.name} full (L={cfg.num_layers}) 4x{PROMPT}+{NEW}{inputs}: "
              f"launches {counts}; last-step logits vs forward: {'; '.join(checks)}")
        print(f"[serve] generate {cfg.name} {4 * NEW / cold_s:.1f} tok/s first call ({cold_s:.3f}s), "
              f"{4 * NEW / warm_s:.1f} tok/s second call ({warm_s:.3f}s), "
              f"max_memory_allocated {mem:.2f} GiB [{name}; {card}]")
        # where the time of a warm generation goes
        api = server.api
        with torch.inference_mode():
            (logits, state), prefill_ms = wall_ms(
                lambda: api.prefill(params, batch, cache_len=server.engine.gen.cache_len))
            _, step_ms = wall_ms(lambda: api.decode_step(params, state, logits.argmax(-1)[:, None]))
        print(f"[profile] generate {cfg.name}: prefill {prefill_ms:.2f} ms, one decode step "
              f"{step_ms:.2f} ms wall [{card}]")
        marks.append(time.perf_counter())
        # whisper's cross-attention (B11's kernels) read from the trace: its profiler range
        stats = {}
        res = profiled(f"generate {cfg.name}", lambda: server.engine.generate(batch), card,
                       ranges=(CROSS_ATTENTION_RANGE,) if cfg.family == "audio" else (), stats=stats)
        if cfg.family == "audio":
            cross_range(f"generate {cfg.name}", res[CROSS_ATTENTION_RANGE], stats["busy_ms"])
        marks.append(time.perf_counter())
        steps = [b - a for a, b in zip(marks, marks[1:])]
        print(f"[time] generate {cfg.name}: " + ", ".join(
            f"{what} {t:.1f}s" for what, t in zip(
                ("set-up", "two timed generations", "decode-vs-forward checks",
                 "prefill and step", "profiled generation"), steps)))

    def cross_range(label, ms, busy):
        """The ``cross_attention`` range's device ms beside its reading before B11."""
        was, was_busy = CROSS_RANGE_BEFORE[label]
        print(f"[b11] {label}: cross_attention range {sum(ms):.3f} device ms ({ms[0]:.3f} inside "
              f"it, {ms[1]:.3f} in its backward), {100 * sum(ms) / busy:.1f}% of {busy:.2f} busy; "
              f"before B11 (plain PyTorch) {was:.2f} of {was_busy:.2f} ({100 * was / was_busy:.1f}%) "
              f"[{name}; {card}]")

    def run_score(arch, seed):
        """SCORE_SHAPE sequences scored at full width through Engine.score."""
        cfg = get_config(arch)
        api = build_model(cfg)
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev)
        engine = Engine(api, params, GenerationConfig())
        toks = torch.randint(0, cfg.vocab_size, SCORE_SHAPE, generator=gen, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        scores = engine.score({"tokens": toks})
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        check_counts(f"score {cfg.name}", counts, path_launches(cfg, 1, 0))
        mem = torch.cuda.max_memory_allocated() / 2**30
        if scores.shape != (SCORE_SHAPE[0],) or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"score {cfg.name}: wrong shape or non-finite")
        t0 = time.perf_counter()
        engine.score({"tokens": toks})
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"[serve] score {cfg.name} full (L={cfg.num_layers}) {SCORE_SHAPE[0]}x{SCORE_SHAPE[1]}:"
              f" launches {counts}; latency {cold_s * 1e3:.1f} ms first call, {warm_s * 1e3:.1f} ms "
              f"second call, max_memory_allocated {mem:.2f} GiB [{name}; {card}]")
        profiled(f"score {cfg.name}", lambda: engine.score({"tokens": toks}), card)

    hybrid_shapes = set()  # every (kernel, shape) of the hybrid's runs, checks included
    slice_serve_shapes = set()  # and of the slice's models (llama3-8b, glm4-9b, internvl, whisper)

    def shapes_of(arch):
        if arch == HYBRID:
            return recording(hybrid_shapes, forward_wrappers)
        return recording(slice_serve_shapes, forward_wrappers) if arch in SLICE else nullcontext()

    # the 8-9 B servers one at a time: each is freed (run_generate's and run_score's locals)
    # and the cache emptied before the next is built
    for arch, seed in (("smollm-360m", 0), ("granite-moe-3b-a800m", 3), ("mamba2-130m", 4),
                       (HYBRID, 12), *SLICE_GENERATE):
        t0 = time.perf_counter()
        with shapes_of(arch):
            run_generate(arch, seed)
        torch.cuda.empty_cache()
        print(f"[time] generate {arch} done at {time.perf_counter() - t_start:.1f}s "
              f"({time.perf_counter() - t0:.1f}s)")
    for arch, seed in (("llama3.2-1b", 1), ("granite-moe-3b-a800m", 5), ("mamba2-130m", 6),
                       (HYBRID, 13), *SLICE_SCORE):
        t0 = time.perf_counter()
        with shapes_of(arch):
            run_score(arch, seed)
        torch.cuda.empty_cache()
        print(f"[time] score {arch} done at {time.perf_counter() - t_start:.1f}s "
              f"({time.perf_counter() - t0:.1f}s)")
    assert_checked(HYBRID, hybrid_shapes)
    assert_checked("serving " + ", ".join(sorted(SLICE)), slice_serve_shapes)

    print(f"[time] phase 4 done at {time.perf_counter() - t_start:.1f}s")

    # ---- 5. backward kernels vs autograd through the plain versions --------
    def grads(fn, inputs, dout):
        return torch.autograd.grad(fn(*inputs), inputs, dout)

    def leaves(dt, *shapes, scale=1.0):
        return [(randn(*s, dtype=torch.float32) * scale).to(dt).requires_grad_() for s in shapes]

    checked, worst = 0, {}  # (what, dtype) -> (largest relative error, largest zero-reference error)

    def keep(what, dt, errs):
        rel, zero = worst.get((what, str(dt)[6:]), (0.0, 0.0))
        for e, r in errs:
            rel, zero = (max(rel, r), zero) if r is not None else (rel, max(zero, e))
        worst[(what, str(dt)[6:])] = (rel, zero)

    # GQA g (internvl2-1b's 7 and glm4-9b's 16 too) and S (ragged and whole tiles), then S on
    # either side of the 128-row and
    # 128-key tiles and of S = 256, where the bf16 plans go from one warpgroup to two
    grid = [(g, S) for g in (1, 3, 4, 5, 7, 16) for S in (1, 63, 65, 160, 1024)]
    grid += [(g, S) for g in (1, 4) for S in (127, 129, 255, 257)]
    for dt in (torch.bfloat16, torch.float32):
        for g, S in grid:
            for d in (64, 128):
                for causal in (True, False):
                    q, k, v = leaves(dt, (2, 2 * g, S, d), (2, 2, S, d), (2, 2, S, d))
                    dout = randn(2, 2 * g, S, d, dtype=dt)
                    got = grads(lambda *t: ops.flash_attention_op(*t, causal=causal), (q, k, v), dout)
                    want = grads(lambda *t: ref.flash_attention_ref(*t, causal), (q, k, v), dout)
                    for n, a, b in zip("qkv", got, want):
                        keep(f"flash d{n}", dt, [grad_err(
                            f"flash d{n} g={g} S={S} d={d} causal={causal} {dt}", a, b,
                            GRAD_TOL[str(dt)[6:]])])
                    checked += 1
    # B11: keys of their own length, non-causal: GQA g 1, 4 and 7, (S, Sk) with ragged tiles on
    # either side (one query, one key, S 448 over whisper's 1500 frames, Sk across 256), head
    # dim 64 and 128.  bf16 runs B11's one pass: its dQ partials in shared memory (g 1 up to
    # S 448 at d 64) or in the global scratch (g 4 and 7, d 128, and S 1024 at g 1)
    t_b11 = time.perf_counter()
    for dt in (torch.bfloat16, torch.float32):
        for g in (1, 4, 7):
            lengths = [(1, 1500), (65, 63), (65, 1), (160, 1500), (448, 1500), (129, 257)]
            for S, Sk in lengths + ([(1024, 1500)] if g == 1 else []):
                for d in (64, 128):
                    q, k, v = leaves(dt, (2, 2 * g, S, d), (2, 2, Sk, d), (2, 2, Sk, d))
                    dout = randn(2, 2 * g, S, d, dtype=dt)
                    got = grads(ops.cross_attention_op, (q, k, v), dout)
                    want = grads(lambda *t: ref.flash_attention_ref(*t, False), (q, k, v), dout)
                    for n, a, b in zip("qkv", got, want):
                        keep(f"cross_attention d{n}", dt, [grad_err(
                            f"cross_attention d{n} g={g} S={S} Sk={Sk} d={d} {dt}", a, b,
                            GRAD_TOL[str(dt)[6:]], ZERO_GRAD_ABS * math.sqrt(S * g))])
                    checked += 1
    print(f"[time] B11's backward grid took {time.perf_counter() - t_b11:.1f}s")
    for dt in (torch.bfloat16, torch.float32):
        for T, D in ((2560, 960), (1024, 2048), (1, 960), (7, 960), (3, 100), (300, 64)):
            x, w = leaves(dt, (T, D), scale=3.0)[0], (1 + 0.1 * randn(D, dtype=torch.float32)).to(dt)
            w.requires_grad_()
            dy = randn(T, D, dtype=dt)
            got, want = grads(ops.rmsnorm_op, (x, w), dy), grads(ref.rmsnorm_ref, (x, w), dy)
            for n, a, b in zip(("dx", "dweight"), got, want):
                keep(f"rmsnorm {n}", dt, [grad_err(f"rmsnorm {n} {T}x{D} {dt}", a, b,
                                                   GRAD_TOL[str(dt)[6:]])])
            checked += 1
    # rows past 2048: the ring route (hymba's 3200, the d-4096 models, 2056 just past the warp
    # route, the limit 8192; one row, fewer rows than SMs, rows strided by a 16-byte multiple)
    # and the block route (D 2049 ragged, rows starting off 16 bytes)
    for dt in (torch.bfloat16, torch.float32):
        for T, D, lay in ((1, 3200, ""), (7, 3200, ""), (1024, 3200, ""), (1, 4096, ""), (7, 4096, ""),
                          (1024, 4096, ""), (7, 2049, ""), (300, 2049, ""), (64, 8192, ""),
                          (1, 2056, ""), (131, 2056, ""), (1, 8192, ""), (200, 8192, ""),
                          (300, 3200, "strided"), (300, 3200, "unaligned")):
            if lay:  # x a view: every row 8 elements further on, or the rows one element in
                base = leaves(dt, (T, D + 8), scale=3.0)[0].detach()
                x = (base[:, :D] if lay == "strided" else base[:, 1:D + 1]).requires_grad_()
            else:
                x = leaves(dt, (T, D), scale=3.0)[0]
            w = (1 + 0.1 * randn(D, dtype=torch.float32)).to(dt)
            w.requires_grad_()
            dy = randn(T, D, dtype=dt)
            before = ops.launch_counts()["rmsnorm_bwd_wide"]
            got, want = grads(ops.rmsnorm_op, (x, w), dy), grads(ref.rmsnorm_ref, (x, w), dy)
            if ops.launch_counts()["rmsnorm_bwd_wide"] != before + 1:
                raise AssertionError(f"rmsnorm {T}x{D}: the wide backward kernel did not run")
            for n, a, b in zip(("dx", "dweight"), got, want):
                keep(f"rmsnorm wide {n}", dt, [grad_err(f"rmsnorm wide {n} {T}x{D} {lay} {dt}", a, b,
                                                        GRAD_TOL[str(dt)[6:]])])
            first, again = (rms_k.rmsnorm_bwd(x.detach(), w.detach(), dy) for _ in range(2))
            if not (torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])):
                raise AssertionError(f"rmsnorm wide {T}x{D} {lay} {dt}: two calls differ")
            checked += 1
    # moe_matmul: capacities ragged and whole, 8 through 384; granite's widths (gate/up, down),
    # the reduced config's, partial tiles, and rows TMA cannot read (the fma route in bf16)
    for dt in (torch.bfloat16, torch.float32):
        for C in (8, 130, 256, 384):
            for E, D, Fd in ((40, 1536, 512), (40, 512, 1536), (4, 256, 128), (3, 264, 200), (3, 100, 36)):
                buf, w = leaves(dt, (E, C, D))[0], leaves(dt, (E, D, Fd), scale=0.05)[0]
                dout = randn(E, C, Fd, dtype=dt)
                got = grads(ops.moe_matmul_op, (buf, w), dout)
                want = grads(ref.moe_matmul_ref, (buf, w), dout)
                for n, a, b in zip(("dbuf", "dw"), got, want):
                    keep(f"moe_matmul {n}", dt, [grad_err(f"moe_matmul {n} E={E} C={C} D={D} F={Fd} {dt}",
                                                          a, b, GRAD_TOL[str(dt)[6:]])])
                first, again = (moe_k.moe_matmul_bwd(buf.detach(), w.detach(), dout) for _ in range(2))
                if not (torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])):
                    raise AssertionError(f"moe_matmul bwd E={E} C={C} D={D} F={Fd} {dt}: two calls differ")
                checked += 1
        # one operand contiguous but one element off 16 bytes: the launch that reads it takes
        # the fma route's element loads
        for which in ("buf", "w", "dout"):
            E, C, D, Fd = 3, 40, 64, 72
            shapes = {"buf": (E, C, D), "w": (E, D, Fd), "dout": (E, C, Fd)}
            t = {k: ((randn(int(np.prod(s_)) + 1, dtype=torch.float32) * (0.05 if k == "w" else 1.0)
                      ).to(dt)[1:].view(s_) if k == which
                     else (randn(*s_, dtype=torch.float32) * (0.05 if k == "w" else 1.0)).to(dt))
                 for k, s_ in shapes.items()}
            if t[which].data_ptr() % 16 == 0 or not t[which].is_contiguous():
                raise AssertionError(f"moe_matmul unaligned {which}: the operand is aligned")
            got = moe_k.moe_matmul_bwd(t["buf"], t["w"], t["dout"])
            buf, w = t["buf"].clone().requires_grad_(), t["w"].clone().requires_grad_()
            want = torch.autograd.grad(ref.moe_matmul_ref(buf, w), (buf, w), t["dout"])
            for n, a, b in zip(("dbuf", "dw"), got, want):
                keep(f"moe_matmul {n}", dt, [grad_err(f"moe_matmul {n} unaligned {which} {dt}", a, b,
                                                      GRAD_TOL[str(dt)[6:]])])
            checked += 1
    # ssd_intra_chunk: mamba2's and hymba's heads and state sizes, the reduced configs' hd 32,
    # N 64; Q 32 through 256 with ragged tiles; the chunk-state gradient absent (one chunk:
    # nothing reads the state), zero and non-zero; then a strong decay (~600 over a chunk)
    ssd_modes = ("absent", "zero", "non-zero")
    for dt in (torch.bfloat16, torch.float32):
        for H, shd, N in ((24, 64, 128), (50, 64, 16), (4, 32, 16), (3, 32, 64), (2, 64, 64)):
            for Q in (32, 100, 256):
                for mode in ssd_modes:
                    xs = leaves(dt, (2, H, Q, shd), scale=0.5)[0]
                    bs, cs = leaves(torch.float32, (2, Q, N), (2, Q, N), scale=0.5)
                    cum = (-torch.cumsum(0.1 * torch.rand(2, H, Q, generator=gen, device=dev), -1)
                           ).requires_grad_()
                    dy = randn(2, H, Q, shd, dtype=dt)
                    dst = (None if mode == "absent" else torch.zeros(2, H, shd, N, device=dev)
                           if mode == "zero" else randn(2, H, shd, N, dtype=torch.float32))

                    def ssd_loss(fn):
                        y, st = fn(xs, bs, cs, cum)
                        return (y.float() * dy.float()).sum() + ((st * dst).sum() if dst is not None else 0)

                    got = torch.autograd.grad(ssd_loss(ops.ssd_intra_chunk_op), (xs, bs, cs, cum))
                    want = torch.autograd.grad(ssd_loss(ref.ssd_intra_chunk_ref), (xs, bs, cs, cum))
                    for n, a, b in zip(("dx", "db", "dc", "dcum"), got, want):
                        keep(f"ssd_intra_chunk {n}", dt, [grad_err(
                            f"ssd_intra_chunk {n} H={H} hd={shd} N={N} Q={Q} dstate {mode} {dt}", a, b,
                            GRAD_TOL[str(dt)[6:]])])
                    checked += 1
        for Q in (64, 256):  # strong decay: exp overflows above the diagonal, underflows below
            x_, b_, c_ = (randn(*s_, dtype=torch.float32) * 0.5 for s_ in ((2, 3, Q, 64), (2, Q, 16), (2, Q, 16)))
            cum = -torch.cumsum(20.0 * torch.rand(2, 3, Q, generator=gen, device=dev), -1)
            dy, dst = randn(2, 3, Q, 64, dtype=dt), randn(2, 3, 64, 16, dtype=torch.float32)
            got = ssd_k.ssd_intra_chunk_bwd(x_.to(dt), b_, c_, cum, dy, dst)
            want = ref.ssd_intra_chunk_bwd_ref(*(t.double() for t in (x_.to(dt), b_, c_, cum, dy, dst)))
            for n, a, b in zip(("dx", "db", "dc", "dcum"), got, want):
                keep(f"ssd_intra_chunk strong decay {n}", dt, [grad_err(
                    f"ssd_intra_chunk strong decay {n} Q={Q} {dt} (vs the f64 closed form)", a, b,
                    GRAD_TOL[str(dt)[6:]])])
            checked += 1
    print(f"[bwd] {checked} backward cases match their plain versions (bf16 {GRAD_TOL['bfloat16']}, "
          f"f32 {GRAD_TOL['float32']} of the reference's largest magnitude; {ZERO_GRAD_ABS} "
          f"absolute where the reference is 0, times sqrt(S g) for B11's)")
    for (what, dt), (rel, zero) in sorted(worst.items()):
        print(f"[bwd] {what} {dt}: largest error {rel:.3e} of the reference's largest magnitude"
              f" (tol {GRAD_TOL[dt]}); largest |got| where the reference is 0: {zero:.3e}")

    bwd_rows = {}
    flash_bwd_cases = [  # (B, H, KV, S, d, causal, dtype, what)
        (16, 15, 5, 160, 64, True, torch.bfloat16, "smollm GRPO"),
        (LOOP_N, 15, 5, LOOP_SEQ, 64, True, torch.bfloat16, "closed loop GRPO"),
        (4, 32, 8, 256, 64, True, torch.bfloat16, "llama LM"),
        *lm_flash_cases,
        *slice_flash_bwd_cases,
        (4, 32, 8, 1024, 64, True, torch.bfloat16, ""),
        (4, 15, 5, 1024, 64, True, torch.bfloat16, ""),
        (4, 32, 8, 2048, 64, True, torch.bfloat16, ""),
        (4, 15, 5, 2048, 64, True, torch.bfloat16, ""),
        (4, 32, 8, 2048, 64, False, torch.bfloat16, ""),
        # f32 (the split-TF32 route): phase 3's f32 forward cases
        (4, 32, 8, 160, 64, True, torch.float32, ""),
        (4, 15, 5, 1024, 64, False, torch.float32, ""),
        (2, 8, 2, 1000, 128, False, torch.float32, "ragged S, d=128"),
        (4, 16, 16, 1500, 64, False, torch.float32, "whisper f32 encoder"),
    ]
    for B, H, KV, S, d, causal, dt, what in flash_bwd_cases:
        q, k, v = leaves(dt, (B, H, S, d), (B, KV, S, d), (B, KV, S, d))
        dout = randn(B, H, S, d, dtype=dt)
        with torch.no_grad():
            out, lse = flash_k.flash_attention(q, k, v, causal=causal, lse=True)
        dq, delta = flash_k.flash_attention_bwd_dq(q, k, v, out, lse, dout, causal=causal)
        dk, dv = flash_k.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, causal=causal)
        again = flash_k.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):  # no atomics
            raise AssertionError(f"flash bwd B={B} H={H} S={S}: two calls differ")
        ref_out = ref.flash_attention_ref(q, k, v, causal)
        lib_out = F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
        tol = GRAD_TOL[str(dt)[6:]]
        want = torch.autograd.grad(ref_out, (q, k, v), dout, retain_graph=True)
        errs = [grad_err(f"flash bwd d{n} B={B} H={H} S={S}", a, b, tol)
                for n, a, b in zip("qkv", (dq, dk, dv), want)]
        b_dq, b_dkdv, b_all = flash_bwd_bounds(B, H, KV, S, d, causal, q.element_size())
        m_dq = measure(
            lambda: flash_k.flash_attention_bwd_dq(q, k, v, out, lse, dout, causal=causal),
            lambda: torch.autograd.grad(ref_out, (q,), dout, retain_graph=True),
            lambda: torch.autograd.grad(lib_out, (q,), dout, retain_graph=True), b_dq, plain_iters=5)
        m_dkdv = measure(
            lambda: flash_k.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, causal=causal),
            lambda: torch.autograd.grad(ref_out, (k, v), dout, retain_graph=True),
            lambda: torch.autograd.grad(lib_out, (k, v), dout, retain_graph=True), b_dkdv,
            plain_iters=5)
        m_all = measure(
            lambda: flash_k.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal),
            lambda: torch.autograd.grad(ref_out, (q, k, v), dout, retain_graph=True),
            lambda: torch.autograd.grad(lib_out, (q, k, v), dout, retain_graph=True), b_all,
            plain_iters=5)
        key = (B, H, KV, S, d, causal, dt)
        bwd_rows[("flash_attention_bwd_dq",) + key] = row(errs[0][0], m_dq)
        bwd_rows[("flash_attention_bwd_dkdv",) + key] = row(max(errs[1][0], errs[2][0]), m_dkdv)
        label = f"B={B} H={H} KV={KV} S={S} d={d} causal={causal} {str(dt)[6:]} {what}"
        report(f"flash bwd dq {label}", errs[:1], tol, m_dq, "sdpa grad q")
        report(f"flash bwd dkdv {label}", errs[1:], tol, m_dkdv, "sdpa grad k, v")
        report(f"flash bwd both {label}", errs, tol, m_all, "sdpa grad q, k, v")
        del q, k, v, dout, out, lse, dq, dk, dv, delta, again, ref_out, lib_out, want
    # B11's backward at whisper's LM shape (2 x 448 tokens over 1500 frames), timed: in bf16
    # its own two kernels (the row statistics, then the one pass), in f32 B5's dq and dkdv
    t_b11 = time.perf_counter()
    cross_bwd_cases = [(2, 16, 16, 448, 1500, 64, torch.bfloat16, "whisper LM"),
                       (2, 16, 16, 448, 1500, 64, torch.float32, "")]
    for B, H, KV, S, Sk, d, dt, what in cross_bwd_cases:
        q, k, v = leaves(dt, (B, H, S, d), (B, KV, Sk, d), (B, KV, Sk, d))
        dout = randn(B, H, S, d, dtype=dt)
        with torch.no_grad():
            out, lse = flash_k.cross_attention(q, k, v, lse=True)
        got = flash_k.cross_attention_bwd(q, k, v, out, lse, dout)
        again = flash_k.cross_attention_bwd(q, k, v, out, lse, dout)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):  # sums in a fixed order
            raise AssertionError(f"cross bwd B={B} H={H} S={S} Sk={Sk} {dt}: two calls differ")
        ref_out = ref.flash_attention_ref(q, k, v, False)
        lib_out = F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
        tol = GRAD_TOL[str(dt)[6:]]
        want = torch.autograd.grad(ref_out, (q, k, v), dout, retain_graph=True)
        errs = [grad_err(f"cross bwd d{n} B={B} H={H} S={S} Sk={Sk}", a, b, tol)
                for n, a, b in zip("qkv", got, want)]
        b_stats, b_fused, b_all = cross_bwd_bounds(B, H, KV, S, Sk, d, q.element_size())
        plain_all = lambda: torch.autograd.grad(ref_out, (q, k, v), dout, retain_graph=True)  # noqa: E731
        lib_all = lambda: torch.autograd.grad(lib_out, (q, k, v), dout, retain_graph=True)  # noqa: E731
        m_all = measure(lambda: flash_k.cross_attention_bwd(q, k, v, out, lse, dout), plain_all, lib_all,
                        b_all, plain_iters=5)
        label = f"B={B} H={H} KV={KV} S={S} Sk={Sk} d={d} {str(dt)[6:]} {what}"
        if dt == torch.bfloat16:
            stats, counters = flash_k.cross_attention_bwd_stats(q, k, v, out, lse, dout)
            n = flash_k.stats_row(S)
            want_stats = cross_bwd_stats_ref(out, lse, dout)
            stats_err = max(((stats[i, ..., :S] - want_stats[i]).abs() / want_stats[i].abs().clamp_min(1.0))
                            .max().item() for i in range(2))  # relative past magnitude 1
            if stats_err > 1e-4 or stats.shape[-1] != n:
                raise AssertionError(f"cross bwd stats {label}: err {stats_err:.2e}")
            m_stats = measure(lambda: flash_k.cross_attention_bwd_stats(q, k, v, out, lse, dout),
                              lambda: cross_bwd_stats_ref(out, lse, dout), None, b_stats)
            m_fused = measure(lambda: flash_k.cross_attention_bwd_fused(q, k, v, dout, stats, counters),
                              plain_all, lib_all, b_fused, plain_iters=5)
            key = (B, H, KV, S, Sk, d, dt)
            bwd_rows[("cross_attention_bwd_stats",) + key] = row(stats_err, m_stats)
            bwd_rows[("cross_attention_bwd_fused",) + key] = row(max(e for e, _ in errs), m_fused)
            report(f"cross_attention bwd stats {label}", stats_err, 1e-4, m_stats, "(no library call)")
            report(f"cross_attention bwd one pass {label}", errs, tol, m_fused, "sdpa grad q, k, v")
            plan = flash_k.cross_bwd_plan(B, H, KV, S, Sk, d)
            print(f"[bwd]   cross bwd plan: {plan.splits} splits of {plan.key_tiles} key tiles of "
                  f"{plan.block_k}, grid {plan.grid} of {plan.threads} threads, dQ partials in "
                  f"{plan.region} ({plan.rows} rows), {plan.smem_bytes} B; statistics pass "
                  f"{plan.stats_blocks} blocks; two calls bit-identical")
        report(f"cross_attention bwd both launches {label}", errs, tol, m_all, "sdpa grad q, k, v")
        del q, k, v, dout, out, lse, got, again, ref_out, lib_out, want
    print(f"[time] B11's timed backward cases took {time.perf_counter() - t_b11:.1f}s")
    rms_bwd_cases = [  # (T, D, dtype, what); past D 2048 the wide (block) route
        (16 * 160, 960, torch.bfloat16, "smollm GRPO"),
        (LOOP_N * LOOP_SEQ, 960, torch.bfloat16, "closed loop GRPO"),
        (4 * 256, 2048, torch.bfloat16, "llama LM"),
        (4 * 256, 2048, torch.float32, ""),
        *lm_rms_cases,
        *slice_rms_bwd_cases,
        (1024, 3200, torch.float32, ""),
        (1024, 4096, torch.float32, ""),
    ]
    for T, D, dt, what in rms_bwd_cases:
        x = leaves(dt, (T, D), scale=3.0)[0]
        w = (1 + 0.1 * randn(D, dtype=torch.float32)).to(dt).requires_grad_()
        dy = randn(T, D, dtype=dt)
        dx, part = rms_k.rmsnorm_bwd_dx(x, w, dy)
        dw = rms_k.rmsnorm_bwd_dweight(part, dt)
        again = rms_k.rmsnorm_bwd(x, w, dy)
        if not (torch.equal(dx, again[0]) and torch.equal(dw, again[1])):  # fixed-order sums
            raise AssertionError(f"rmsnorm bwd {T}x{D}: two calls differ")
        ref_out, lib_out = ref.rmsnorm_ref(x, w), F.rms_norm(x, (D,), w, 1e-5)
        tol = GRAD_TOL[str(dt)[6:]]
        want = torch.autograd.grad(ref_out, (x, w), dy, retain_graph=True)
        errs = [grad_err(f"rmsnorm bwd {n} {T}x{D}", a, b, tol)
                for n, a, b in zip(("dx", "dweight"), (dx, dw), want)]
        b_dx, b_dw, b_all = rmsnorm_bwd_bounds(T, D, x.element_size())
        m_dx = measure(lambda: rms_k.rmsnorm_bwd_dx(x, w, dy),
                       lambda: torch.autograd.grad(ref_out, (x, w), dy, retain_graph=True),
                       lambda: torch.autograd.grad(lib_out, (x, w), dy, retain_graph=True), b_dx)
        m_dw = measure(lambda: rms_k.rmsnorm_bwd_dweight(part, dt), lambda: part.sum(0).to(dt),
                       lambda: torch.sum(part, 0), b_dw)
        m_all = measure(lambda: rms_k.rmsnorm_bwd_dweight(rms_k.rmsnorm_bwd_dx(x, w, dy)[1], dt),
                        lambda: torch.autograd.grad(ref_out, (x, w), dy, retain_graph=True),
                        lambda: torch.autograd.grad(lib_out, (x, w), dy, retain_graph=True), b_all)
        rplan = rms_k.bwd_plan(T, D, dt)
        kname = "rmsnorm_bwd" if rplan.route == "warp" else "rmsnorm_bwd_wide"
        bwd_rows[(kname, T, D, dt)] = row(errs[0][0], m_dx)
        bwd_rows[("rmsnorm_bwd_dweight", T, D, dt)] = row(errs[1][0], m_dw)
        label = f"T={T} D={D} {str(dt)[6:]} {what} ({rplan.route} route)"
        report(f"rmsnorm bwd dx+partials {label}", errs[:1], tol, m_dx, "F.rms_norm grad x, w")
        report(f"rmsnorm bwd dweight reduce {label}", errs[1:], tol, m_dw, "torch.sum")
        report(f"rmsnorm bwd both {label}", errs, tol, m_all, "F.rms_norm grad x, w")
        if rplan.route != "warp":
            print(f"[bwd]   launch plan: route {rplan.route}, {rplan.blocks} blocks of {rplan.threads} "
                  f"threads, {rplan.rows_per_block} rows a block, {rplan.stages} rows in flight "
                  f"({rplan.teams} teams, {rplan.ring_chunks} 16-byte chunks a thread), "
                  f"{rplan.smem_bytes} bytes of shared memory")
        del x, w, dy, part, dx, dw, again, ref_out, lib_out, want
    # (E, C, D, F, dtype, what): f32 (the "tf32x3" route) at granite's LM products, a phase 10
    # rank's f32 granite step (reduced, 10 experts padded to 12 over 3 model ranks; 2 rows x 64
    # tokens drop-free) and the reduced widths at a ragged C
    moe_bwd_cases = [*lm_moe_cases,
                     (40, 256, 1536, 512, torch.float32, "gate/up"),
                     (40, 256, 512, 1536, torch.float32, "down"),
                     (4, 128, 256, 128, torch.float32, "mesh rank gate/up"),
                     (4, 128, 128, 256, torch.float32, "mesh rank down"),
                     (4, 130, 256, 128, torch.float32, "reduced, ragged C")]
    for E, C, D, Fd, dt, what in moe_bwd_cases:
        buf, w = leaves(dt, (E, C, D))[0], leaves(dt, (E, D, Fd), scale=0.05)[0]
        dout = randn(E, C, Fd, dtype=dt)
        dbuf, dw = moe_k.moe_matmul_bwd(buf, w, dout)
        again = moe_k.moe_matmul_bwd(buf, w, dout)
        if not (torch.equal(dbuf, again[0]) and torch.equal(dw, again[1])):  # no atomics
            raise AssertionError(f"moe_matmul bwd E={E} C={C} D={D} F={Fd}: two calls differ")
        ref_out = ref.moe_matmul_ref(buf, w)
        tol = GRAD_TOL[str(dt)[6:]]
        want = torch.autograd.grad(ref_out, (buf, w), dout, retain_graph=True)
        errs = [grad_err(f"moe_matmul bwd {n} E={E} C={C} D={D} F={Fd}", a, b, tol)
                for n, a, b in zip(("dbuf", "dw"), (dbuf, dw), want)]
        b_dbuf, b_dw, b_all = moe_bwd_bounds(E, C, D, Fd, buf.element_size())
        def plain(*of):
            return lambda: torch.autograd.grad(ref_out, of, dout, retain_graph=True)

        m_dbuf = measure(lambda: moe_k.moe_matmul_bwd(buf, w, dout, dw=False), plain(buf),
                         lambda: torch.bmm(dout, w.transpose(1, 2)), b_dbuf)
        m_dw = measure(lambda: moe_k.moe_matmul_bwd(buf, w, dout, dbuf=False), plain(w),
                       lambda: torch.bmm(buf.transpose(1, 2), dout), b_dw)
        m_all = measure(lambda: moe_k.moe_matmul_bwd(buf, w, dout), plain(buf, w),
                        lambda: (torch.bmm(dout, w.transpose(1, 2)), torch.bmm(buf.transpose(1, 2), dout)),
                        b_all)
        key = (E, C, D, Fd, dt)
        bwd_rows[("moe_matmul_bwd_dbuf",) + key] = row(errs[0][0], m_dbuf)
        bwd_rows[("moe_matmul_bwd_dw",) + key] = row(errs[1][0], m_dw)
        plan = moe_k.bwd_plan(E, C, D, Fd, dt)
        label = f"E={E} C={C} D={D} F={Fd} {str(dt)[6:]} {what} ({plan.route} route)"
        report(f"moe_matmul bwd dbuf {label}", errs[:1], tol, m_dbuf, "bmm dout w^T")
        report(f"moe_matmul bwd dw {label}", errs[1:], tol, m_dw, "bmm buf^T dout")
        report(f"moe_matmul bwd both {label}", errs, tol, m_all, "two bmm")
        for which, lp in (("dbuf", plan.dbuf), ("dw", plan.dw)):
            print(f"[bwd]   launch plan {which}: route {lp.route}, tile {lp.block_m} x {lp.block_n} x "
                  f"{lp.block_k}, {lp.stages} stages, {lp.threads} threads, grid {lp.grid} for "
                  f"{lp.tiles} tiles, {lp.smem_bytes} bytes of shared memory"
                  + (f"; the FMA-rate bound {moe_fma_ms(E, C, D, Fd):.4f} ms"
                     if dt == torch.float32 else ""))
        del buf, w, dout, dbuf, dw, again, ref_out, want
    ssd_bwd_cases = [(B * NC, H, Q, 64, N, dt, what)
                     for B, NC, Q, H, N, dt, what in lm_ssd_cases + mesh_ssd_cases[2:]]
    for BNC, H, Q, shd, N, dt, what in ssd_bwd_cases:
        xs = leaves(dt, (BNC, H, Q, shd), scale=0.5)[0]
        bs, cs = leaves(torch.float32, (BNC, Q, N), (BNC, Q, N), scale=0.5)
        cum = (-torch.cumsum(0.1 * torch.rand(BNC, H, Q, generator=gen, device=dev), -1)).requires_grad_()
        dy, dst = randn(BNC, H, Q, shd, dtype=dt), randn(BNC, H, shd, N, dtype=torch.float32)
        args = (xs, bs, cs, cum, dy, dst)
        got = ssd_k.ssd_intra_chunk_bwd(*args)
        again = ssd_k.ssd_intra_chunk_bwd(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):  # fixed-order sums
            raise AssertionError(f"ssd_intra_chunk bwd BNC={BNC} H={H} Q={Q} N={N}: two calls differ")
        y_ref, st_ref = ref.ssd_intra_chunk_ref(xs, bs, cs, cum)
        tol = GRAD_TOL[str(dt)[6:]]
        want = torch.autograd.grad((y_ref, st_ref), (xs, bs, cs, cum), (dy, dst), retain_graph=True)
        errs = [grad_err(f"ssd_intra_chunk bwd {n} BNC={BNC} H={H} Q={Q} N={N}", a, b, tol)
                for n, a, b in zip(("dx", "db", "dc", "dcum"), got, want)]
        b_main, b_red, b_all = ssd_bwd_bounds(BNC, H, Q, shd, N, xs.element_size())
        plain = lambda: torch.autograd.grad((y_ref, st_ref), (xs, bs, cs, cum), (dy, dst),
                                            retain_graph=True)
        plan = ssd_k.bwd_plan(BNC, H, Q, shd, N, dt)
        split_b = ssd_bwd_split_bound(BNC, H, Q, shd, N)
        parts = ssd_k.ssd_intra_chunk_bwd_main(*args)[1]
        m_main = measure(lambda: ssd_k.ssd_intra_chunk_bwd_main(*args), plain, None, b_main,
                         plain_iters=5)
        m_red = measure(lambda: ssd_k.ssd_intra_chunk_bwd_reduce(parts), plain, None, b_red,
                        plain_iters=5)
        m_all = measure(lambda: ssd_k.ssd_intra_chunk_bwd(*args), plain, None, b_all, plain_iters=5)
        key = (BNC, H, Q, shd, N, dt)
        bwd_rows[("ssd_intra_chunk_bwd",) + key] = row(max(e for e, _ in errs), m_main)
        bwd_rows[("ssd_intra_chunk_bwd_reduce",) + key] = row(max(e for e, _ in errs[1:]), m_red)
        label = f"BNC={BNC} H={H} Q={Q} hd={shd} N={N} {str(dt)[6:]} {what}"
        report(f"ssd_intra_chunk bwd main {label}", errs, tol, m_main, "no single PyTorch call")
        report(f"ssd_intra_chunk bwd reduce {label}", errs[1:], tol, m_red, "no single PyTorch call")
        report(f"ssd_intra_chunk bwd both {label}", errs, tol, m_all, "no single PyTorch call")
        print(f"[bwd]   launch plan: route {plan.route}, head group {plan.heads_per_block} "
              f"({plan.groups} groups), grid {plan.grid}, {plan.threads} threads, {plan.smem_bytes} "
              f"bytes of shared memory, {plan.blocks_per_sm} blocks an SM by it; scratch "
              f"{plan.scratch_bytes} bytes; reduce grid {plan.reduce_grid} of {plan.reduce_threads}"
              + (f"; the route's split-product bound {split_b[0]:.4f} ms ({split_b[1]})"
                 if dt == torch.bfloat16 else ""))
        del xs, bs, cs, cum, dy, dst, got, again, y_ref, st_ref, want, parts
    print(f"[bwd] determinism: every timed backward kernel gave bit-identical gradients in two "
          f"calls ({len(flash_bwd_cases)} flash, {len(cross_bwd_cases)} cross_attention, "
          f"{len(rms_bwd_cases)} rmsnorm, "
          f"{len(moe_bwd_cases)} moe_matmul, {len(ssd_bwd_cases)} ssd_intra_chunk shapes)")
    torch.cuda.empty_cache()

    # B9, AdamW: 41 leaves in two tables (every (p, g) dtype pair, tails, a leaf 2 bytes off
    # 16), then the whole table of each training run of phases 6 and 7 (every (leaf shape, p
    # dtype, g dtype) they launch, laid out as they launch it), held against the plain version
    # in one step; and each run's step timed
    adamw_runs = [("smollm-360m", None), ("llama3.2-1b", None)] + [
        (arch, layers) for arch, _, _, layers in LM_FAMILY_RUNS + SLICE_LM_RUNS]
    run_leaves = {}
    for arch, layers in adamw_runs:
        cfg = get_config(arch)
        cfg = cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)
        api = build_model(cfg)
        run_leaves[arch] = [(tuple(t.shape), api.dtype, api.dtype)
                            for t in flat_named(api.abstract_params()).values()]
    mixed = [((1 + 37 * i, 3 + i % 5), (f32, bf16)[i % 2], (f32, bf16)[(i // 2) % 2])
             for i in range(40)] + [((4097,), bf16, bf16)]
    make = adamw_maker(mixed, dev, 26)
    table = adamw_table(make, len(mixed))
    off = torch.empty(4097 + 8, dtype=bf16, device=dev)[1:4098]  # 2 bytes off 16
    table[0][-1] = off.copy_(table[0][-1])
    g_abs, g_rel, u_err = hold_adamw("adamw 41 leaves", table, make, dev)
    print(f"[adamw] 41 leaves in two tables, every (p, g) dtype pair, tails and a leaf 2 bytes "
          f"off 16: p, m, v bit-identical to the plain update given the same scalars (max |diff| "
          f"{u_err:.1e}) in two calls, gnorm {g_rel:.2e} from the plain version's (tol "
          f"{ADAMW_GNORM_TOL})")
    del table, off
    adamw_keys_held = sorted({k for leaves in run_leaves.values() for k in leaves}, key=str)
    adamw_rows = {}
    acfg, lr, bc1, bc2 = adamw_scalars(dev)
    akw = dict(beta1=acfg.beta1, beta2=acfg.beta2, eps=acfg.eps, weight_decay=acfg.weight_decay)
    for run, (arch, layers) in enumerate(adamw_runs):
        leaves = run_leaves[arch]
        make = adamw_maker(leaves, dev, 100 + run)
        ps, gs, ms, vs = table = adamw_table(make, len(leaves))
        g_abs, g_rel, u_err = hold_adamw(f"adamw {arch} ({len(leaves)} leaves)", table, make, dev)
        print(f"[adamw] held {arch}'s {len(leaves)} leaves as one step: p, m, v bit-identical to "
              f"the plain update given the same scalars (max |diff| {u_err:.1e}) in two calls, "
              f"gnorm {g_rel:.2e} from the plain version's")
        b_norm, b_fin, b_upd, b_all = adamw_bounds(leaves)
        step = lambda: ops.adamw_update_(ps, gs, ms, vs, lr, bc1, bc2, grad_clip=acfg.grad_clip, **akw)
        ms_all, wall_all = cuda_ms(step, iters=10), call_ms(step, iters=10)
        parts = adamw_k.norm_partials(gs, [True] * len(gs))
        out = adamw_k.norm_finish(parts, acfg.grad_clip)

        def plain_finish():  # the finish's plain version, on the kernel's partials
            gnorm = torch.sqrt(parts.sum()).to(f32)
            return gnorm, torch.clamp(acfg.grad_clip / (gnorm + 1e-9), max=1.0)

        fin_err = max((a - b).abs().item() for a, b in zip(out, plain_finish()))
        m_norm = cuda_ms(lambda: adamw_k.norm_partials(gs, [True] * len(gs)), iters=10)
        m_fin = cuda_ms(lambda: adamw_k.norm_finish(parts, acfg.grad_clip), iters=10)
        m_upd = cuda_ms(lambda: adamw_k.update(ps, gs, ms, vs, out[1:], lr, bc1, bc2, **akw), iters=10)
        # the library: torch._foreach_norm, then torch._fused_adamw_ with the clip scale as its
        # grad_scale (which divides, and writes the scaled gradients back), on bf16 moments of
        # its own: it takes every list in the parameters' dtype
        em, ev = [torch.zeros_like(p) for p in ps], [torch.zeros_like(p) for p in ps]
        steps = [torch.full((), float(ADAMW_STEP), dtype=f32, device=dev) for _ in ps]

        def lib_norm():
            gnl = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)).float())
            return torch.clamp(acfg.grad_clip / (gnl + 1e-9), max=1.0)

        def lib_update(scale):
            torch._fused_adamw_(ps, gs, em, ev, [], steps, lr=acfg.lr, beta1=acfg.beta1,
                                beta2=acfg.beta2, weight_decay=acfg.weight_decay, eps=acfg.eps,
                                amsgrad=False, maximize=False, grad_scale=1 / scale, found_inf=None)

        lib_scale = lib_norm()
        l_norm, l_upd = cuda_ms(lib_norm, iters=10), cuda_ms(lambda: lib_update(lib_scale), iters=10)
        l_all = cuda_ms(lambda: lib_update(lib_norm()), iters=10)
        del em, ev, steps
        torch.cuda.empty_cache()
        plain_step = lambda: ref.adamw_update_ref(ps, gs, ms, vs, lr, bc1, bc2,  # noqa: E731
                                                  grad_clip=acfg.grad_clip, **akw)
        p_all = cuda_ms(plain_step, iters=3)
        p_norm = cuda_ms(lambda: global_norm(gs), iters=3)
        p_fin = cuda_ms(plain_finish)
        p_upd = cuda_ms(lambda: [ref.adamw_leaf_ref(*t, out[1], lr, bc1, bc2, **akw)
                                 for t in zip(ps, gs, ms, vs)], iters=3)
        n = sum(math.prod(sh) for sh, _, _ in leaves)
        print(f"[adamw] {arch}{'' if layers is None else f' ({layers} L)'} step over {len(leaves)} "
              f"leaves, {n / 1e9:.3f} B parameters ({str(leaves[0][1])[6:]} params and grads, f32 "
              f"moments): kernel {ms_all:.3f} ms (one call {wall_all:.3f} ms wall; norm "
              f"{m_norm:.3f}, finish {m_fin:.4f}, update {m_upd:.3f}) plain {p_all:.3f} ms "
              f"(norm {p_norm:.3f}, update {p_upd:.3f}) library _foreach_norm + _fused_adamw_ "
              f"{l_all:.3f} ms (norm {l_norm:.3f}, update {l_upd:.3f}; bf16 moments) bound "
              f"{b_all[0]:.3f} ms ({b_all[1]}; the norm's second read of g adds "
              f"{b_norm[0]:.3f}); launches {adamw_k.step_launches(len(leaves))}; |gnorm - plain| "
              f"{g_abs:.3e} ({g_rel:.2e}), the finish's {fin_err:.3e} [{card}]")
        # max_abs_err: the norm's, |gnorm - the plain f32 norm| of the held step; the finish's,
        # against its plain version on the same partials; the update's, max |kernel - plain|
        adamw_rows[arch] = {
            "adamw_norm": dict(ms=m_norm, plain_ms=p_norm, library_ms=l_norm, bound_ms=b_norm[0],
                               bound_by=b_norm[1], max_abs_err=g_abs),
            "adamw_norm_finish": dict(ms=m_fin, plain_ms=p_fin, library_ms=None, bound_ms=b_fin[0],
                                      bound_by=b_fin[1], max_abs_err=fin_err),
            "adamw_update": dict(ms=m_upd, plain_ms=p_upd, library_ms=l_upd, bound_ms=b_upd[0],
                                 bound_by=b_upd[1], max_abs_err=u_err)}
        del ps, gs, ms, vs, table, make, parts, out, step, plain_step
        torch.cuda.empty_cache()

    print(f"[time] phase 5 done at {time.perf_counter() - t_start:.1f}s")

    # ---- 6. training at full width ------------------------------------------
    refused = plain_adamw_refused()  # through phase 7: every optimizer step takes B9
    refused.start()

    def count_run(label, fn, expect):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        check_counts(label, ops.launch_counts(), expect)
        return out

    def profiled_step(label, fn, ranges=(), stats=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = wall_ms(fn)[1]  # each call advances the moments in place; its new step is dropped
        mem = torch.cuda.max_memory_allocated() / 2**30
        print(f"[train] {label}: one warm step {ms:.1f} ms wall, max_memory_allocated "
              f"{mem:.2f} GiB [{name}; {card}]")
        stats = {} if stats is None else stats
        stats.update(step_ms=ms, peak_gib=mem)
        res = profiled(label, fn, card, rows=14, ranges=ranges, stats=stats)
        if label in LITERAL_ADAMW_STEPS:
            was_ms, was_gib = LITERAL_ADAMW_STEPS[label]
            print(f"[train] {label}: device busy {stats['busy_ms']:.2f} ms (AdamW "
                  f"{stats['adamw_ms']:.3f}), max_memory_allocated {mem:.2f} GiB; with the literal "
                  f"AdamW {was_ms:.2f} ms, {was_gib:.2f} GiB{' at 24 layers' if 'granite' in label else ''} "
                  f"[{name}; {card}]")
        return res

    def remat_off(trainer, batch, on):
        """The trainer's step with its layers keeping every activation (``remat=False``),
        profiled as ``profiled_step`` profiled it with remat on (``on``: its readings), and
        both printed on one line."""
        cfg = trainer.cfg
        off_api = build_model(dataclasses.replace(cfg, remat=False))
        step = make_train_step(off_api, AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=3))
        off = {}
        profiled_step(f"lm step {cfg.name} remat off", lambda: step(trainer.state, batch), stats=off)
        print(f"[remat] lm step {cfg.name} (L={cfg.num_layers}) " + "; ".join(
            f"remat {w}: {r['step_ms']:.1f} ms wall, {r['busy_ms']:.2f} device ms "
            f"({100 * r['busy_ms'] / r['wall_ms']:.1f}% busy under the profiler), "
            f"max_memory_allocated {r['peak_gib']:.2f} GiB" for w, r in (("on", on), ("off", off)))
            + f"; remat saves {off['peak_gib'] - on['peak_gib']:.2f} GiB for "
            f"{on['busy_ms'] - off['busy_ms']:.2f} device ms [{name}; {card}]")

    def remat_grads(trainer, batch):
        """One step's gradients on ``batch`` with remat on and off, same weights: whether
        they are bit-identical, and the largest difference of a leaf relative to its
        largest magnitude."""
        cfg, params = trainer.cfg, trainer.state.params
        grads = {}
        for remat in (True, False):
            api = build_model(dataclasses.replace(cfg, remat=remat))
            grads[remat] = grads_of(api.loss_fn(params, batch)[0], params)
        same = all(torch.equal(g, grads[False][k]) for k, g in grads[True].items())
        worst = max(((g.float() - grads[False][k].float()).abs().max()
                     / grads[False][k].float().abs().max().clamp_min(1e-30)).item()
                    for k, g in grads[True].items())
        print(f"[remat] lm {cfg.name}: one step's gradients with remat on vs off, same batch and "
              f"weights, {len(grads[True])} leaves: bit-identical {same}; largest difference "
              f"{worst:.3e} of a leaf's largest magnitude [{name}; {card}]")
        del grads
        torch.cuda.empty_cache()

    # GRPO: the policy rolls out, the judge scores, three GRPO steps
    marks = [time.perf_counter()]
    pcfg = get_config("smollm-360m")
    papi = build_model(pcfg)
    state = init_train_state(papi, torch.Generator(device=dev).manual_seed(7), dev)
    jcfg = get_config("llama3.2-1b")
    japi = build_model(jcfg)
    judge = Engine(japi, japi.init(torch.Generator(device=dev).manual_seed(8), dev),
                   GenerationConfig())
    policy = Engine(papi, state.params, GenerationConfig(max_new_tokens=NEW, temperature=1.0,
                                                         cache_len=PROMPT + NEW))
    prompts = torch.randint(0, pcfg.vocab_size, (PROMPTS, PROMPT), generator=gen, device=dev)
    rep_prompts = prompts.repeat_interleave(GROUP, dim=0)  # [16, 128], each prompt GROUP times
    N = PROMPTS * GROUP
    rollout = count_run(
        "grpo rollout", lambda: policy.generate({"tokens": rep_prompts},
                                                torch.Generator(device=dev).manual_seed(9)),
        path_launches(pcfg, 1, NEW - 1))
    seqs = torch.cat([rep_prompts, rollout.tokens], dim=1)  # [16, 160]
    rewards = count_run("grpo judge score", lambda: judge.score({"tokens": seqs}),
                        path_launches(jcfg, 1, 0))
    adv = group_advantages(rewards.view(PROMPTS, GROUP)).view(-1)
    with torch.no_grad():
        old_logp = count_run("grpo old_logp", lambda: token_logprobs(state.params, seqs, papi),
                             path_launches(pcfg, 1, 0))
    mask = torch.zeros(N, PROMPT + NEW - 1, device=dev)
    mask[:, PROMPT - 1:] = 1.0  # only generated positions train
    batch = {"tokens": seqs, "mask": mask, "advantages": adv, "old_logp": old_logp,
             "ref_logp": old_logp}
    grpo_step = make_grpo_step(papi, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100))
    marks.append(time.perf_counter())
    step_metrics = []
    for i in range(GRPO_STEPS):
        state, m = count_run(f"grpo step {i}", lambda: grpo_step(state, batch),
                             path_launches(pcfg, 0, 0, train_steps=1, opt_steps=1))
        step_metrics.append({k: float(v) for k, v in m.items()})
    marks.append(time.perf_counter())
    with torch.no_grad():
        new_logp = token_logprobs(state.params, seqs, papi)
    gain = ((new_logp - old_logp) * mask).sum(1) / mask.sum(1)  # per sequence
    pos, neg = gain[adv > 0].mean().item(), gain[adv < 0].mean().item()
    losses = [m["loss"] for m in step_metrics]
    if not all(math.isfinite(x) for x in losses) or not pos > neg:
        raise AssertionError(f"GRPO: losses {losses}, log-prob gain {pos} (adv > 0) vs {neg}")
    print(f"[train] grpo {pcfg.name} full (L={pcfg.num_layers}) {N}x{PROMPT + NEW} judged by "
          f"{jcfg.name}: rewards {rewards.min().item():.2f}..{rewards.max().item():.2f}; steps: "
          + "; ".join(f"loss {m['loss']:.5f} kl {m['kl']:.5f} ratio {m['ratio_mean']:.4f} "
                      f"grad_norm {m['grad_norm']:.4f} lr {m['lr']:.2e}" for m in step_metrics))
    print(f"[train] grpo: masked log-prob gain {pos:.4f} (positive advantage) > {neg:.4f} "
          f"(negative); rollout+score+old_logp {marks[1] - marks[0]:.2f}s, three steps "
          f"{marks[2] - marks[1]:.2f}s wall [{card}]")
    profiled_step(f"grpo step {pcfg.name}", lambda: grpo_step(state, batch))
    del state, judge, policy, rollout, batch, old_logp, new_logp, m
    torch.cuda.empty_cache()
    print(f"[time] grpo done at {time.perf_counter() - t_start:.1f}s")

    # LM training through the launcher
    lm_cfg = get_config("llama3.2-1b")
    steps = int(LM_ARGS[LM_ARGS.index("--steps") + 1])
    trainer, lm_metrics = count_run(
        "lm train", lambda: train_main(LM_ARGS + ["--device", str(dev)]),
        path_launches(lm_cfg, 0, 0, train_steps=steps, opt_steps=steps))
    lm_losses = [m["loss"] for m in lm_metrics]
    if not all(math.isfinite(x) for x in lm_losses):
        raise AssertionError(f"LM training: losses {lm_losses}")
    print(f"[train] lm {lm_cfg.name} full (L={lm_cfg.num_layers}) 4x256: losses "
          + ", ".join(f"{x:.4f}" for x in lm_losses)
          + f" (ln V = {math.log(lm_cfg.vocab_size):.4f}); grad_norm "
          + ", ".join(f"{m['grad_norm']:.3f}" for m in lm_metrics))
    lm_batch = next_batch(trainer)
    on = {}
    profiled_step(f"lm step {lm_cfg.name}",
                  lambda: trainer.step(trainer.state, lm_batch), stats=on)
    remat_off(trainer, lm_batch, on)
    remat_grads(trainer, lm_batch)
    del trainer, lm_batch
    torch.cuda.empty_cache()

    # the moe, ssm and hybrid families through the same launcher, every (kernel, shape) recorded
    checked_shapes.update(
        moe_matmul={c[:5] for c in moe_cases},
        flash_attention_bwd={c[:7] for c in flash_bwd_cases},
        cross_attention_bwd={c[:7] for c in cross_bwd_cases},
        rmsnorm_bwd={c[:3] for c in rms_bwd_cases},
        moe_matmul_bwd={c[:5] for c in moe_bwd_cases},
        ssd_intra_chunk_bwd={c[:6] for c in ssd_bwd_cases},
        adamw_update_=set(adamw_keys_held),
    )
    train_wrappers = kernel_wrappers(train=True)
    for arch, batch, seq, layers in LM_FAMILY_RUNS + SLICE_LM_RUNS:
        cfg = get_config(arch)
        if layers is not None:  # a depth cut; the widths stay published
            cfg = dataclasses.replace(cfg, num_layers=layers)
        frames = cfg.encoder_seq  # the audio family's stub frames a sequence: one 30 s window

        one_batch = arch in SLICE  # the slice's runs take their three steps on one batch

        def lm_train(cfg=cfg, batch=batch, seq=seq, one_batch=one_batch):
            trainer = trainer_from_config(cfg, steps=3, batch=batch, seq=seq, device=dev,
                                          frames=frames)
            if not one_batch:
                return trainer, train(trainer, 3)
            # the stream's batch-to-batch spread (0.05 on whisper-medium) exceeds what three
            # warm-up steps (lr 1e-4 to 3e-4) move a new batch's loss; on one batch each
            # step must descend
            one, metrics = next_batch(trainer), []
            for _ in range(3):
                trainer.state, m = trainer.step(trainer.state, one)
                metrics.append(m)
            return trainer, [{k: float(v) for k, v in m.items()} for m in metrics]

        train_shapes = set()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recording(train_shapes, train_wrappers):
            trainer, metrics = count_run(f"lm train {arch}", lm_train,
                                         path_launches(cfg, 0, 0, train_steps=3, opt_steps=3))
        wall_s = time.perf_counter() - t0
        mem = torch.cuda.max_memory_allocated() / 2**30
        losses = [m["loss"] for m in metrics]
        if not all(math.isfinite(m[k]) for m in metrics for k in ("loss", "grad_norm")):
            raise AssertionError(f"LM training {arch}: metrics {metrics}")
        if one_batch and not losses[-1] < losses[0]:
            raise AssertionError(f"LM training {arch}: one batch's loss did not fall, {losses}")
        inputs = {"vlm": f" after {trainer.patches} patches",
                  "audio": f" over {frames} frames (encoder L={cfg.encoder_layers})"}.get(cfg.family, "")
        print(f"[train] lm {arch} full (L={cfg.num_layers}) {batch}x{seq}{inputs}: "
              f"{trainer.api.param_count() / 1e9:.3f} B parameters; "
              f"{'one batch' if one_batch else 'the stream'}'s losses "
              + ", ".join(f"{x:.4f}" for x in losses)
              + f" (ln V = {math.log(cfg.vocab_size):.4f}); grad_norm "
              + ", ".join(f"{m['grad_norm']:.3f}" for m in metrics)
              + (f"; load_balance {metrics[-1]['load_balance']:.4f}" if cfg.family == "moe" else "")
              + f"; launches as expected; set-up and three steps {wall_s:.2f}s wall, "
              f"max_memory_allocated {mem:.2f} GiB [{name}; {card}]")
        assert_checked(f"lm {arch}", train_shapes)
        lm_batch = next_batch(trainer)
        on = {}
        res = profiled_step(f"lm step {arch}", lambda: trainer.step(trainer.state, lm_batch),
                            ranges=(CROSS_ATTENTION_RANGE,) if cfg.family == "audio" else (), stats=on)
        if cfg.family == "audio":
            cross_range(f"lm step {arch}", res[CROSS_ATTENTION_RANGE], on["busy_ms"])
        if arch in REMAT_BOTH_WAYS:
            remat_off(trainer, lm_batch, on)
        if arch in REMAT_GRADS:
            remat_grads(trainer, lm_batch)
        del trainer, lm_batch, metrics
        torch.cuda.empty_cache()
        print(f"[time] lm {arch} done at {time.perf_counter() - t_start:.1f}s "
              f"({time.perf_counter() - t0:.1f}s)")

    print(f"[time] phase 6 done at {time.perf_counter() - t_start:.1f}s")

    # ---- 7. the closed loop: GRPO with the judge's actions through Tangram --
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cluster import paper_testbed
    from repro_torch.core.telemetry import decision_trace
    from repro_torch.rl.driver import LiveGrpoDriver, build_tangram, judge_action

    def loop_tangram():
        return build_tangram(paper_testbed(cpu_nodes=1, gpu_nodes=1), services=["judge"],
                             service_state_gb=1.0)

    pcfg, jcfg = get_config("smollm-360m"), get_config("llama3.2-1b")
    driver = LiveGrpoDriver(pcfg, jcfg, group_size=LOOP_GROUP, seed=11, device=dev)
    N, new = LOOP_N, LOOP_NEW
    if driver.gen_cfg.max_new_tokens != new:
        raise AssertionError(f"LiveGrpoDriver makes {driver.gen_cfg.max_new_tokens} new tokens; "
                             f"phases 3 and 5 checked the kernels at the shapes of {new}")
    parts = (path_launches(pcfg, 1, new - 1), *[path_launches(jcfg, 1, 0)] * N,
             path_launches(pcfg, 1, 0), path_launches(pcfg, 0, 0, train_steps=1, opt_steps=1))
    expect = {k: sum(part[k] for part in parts) for k in parts[0]}  # rollout, judges, old_logp, step
    loop_rng = np.random.default_rng(0)

    # every shape the loop gives a kernel must be one phases 3 and 5 held against its plain
    # version (checked_shapes holds the backward cases since phase 6)
    loop_shapes = set()
    print(f"[time] closed loop set up at {time.perf_counter() - t_start:.1f}s")
    step_walls = []
    shape_recorders = recording(loop_shapes, (
        (flash_k, "flash_attention", flash_key), (flash_k, "flash_attention_bwd", flash_key),
        (rms_k, "rmsnorm", rms_key), (rms_k, "rmsnorm_bwd", rms_key),
        (adamw_k, "adamw_update_", adamw_keys)))
    for step in range(LOOP_STEPS + 1):  # the last step again under torch.profiler
        profiling = step == LOOP_STEPS
        tangram = loop_tangram()
        loop_prompts = loop_rng.integers(0, pcfg.vocab_size, size=(LOOP_PROMPTS, LOOP_PROMPT))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) if profiling else nullcontext() as prof:
            rep, step_ms = wall_ms(lambda: driver.run_step(loop_prompts.astype(np.int32), tangram))
        check_counts(f"closed loop step {step}", ops.launch_counts(), expect)
        recs, gpu = tangram.telemetry.records, tangram.managers["gpu"]
        if (len(recs) != N or any(r.failed for r in recs) or not np.all(rep.judge_s > 0)
                or gpu.stats["hits"] + gpu.stats["misses"] != N):
            raise AssertionError(f"closed loop step {step}: {len(recs)} judge records "
                                 f"({sum(r.failed for r in recs)} failed), EOE {gpu.stats}, "
                                 f"walls {rep.judge_s}; expected {N} finished")
        if not all(math.isfinite(x) for x in (rep.grpo_loss, rep.mean_reward, rep.mean_act)):
            raise AssertionError(f"closed loop step {step}: {rep}")
        replay = loop_tangram()  # the measured walls as fixed durations
        for i, d in enumerate(rep.judge_s):
            replay.submit(judge_action(i, lambda dop, d=float(d): d))
        replay.run()
        if decision_trace(replay.telemetry.records) != decision_trace(recs):
            raise AssertionError(f"closed loop step {step}: the replay with the measured "
                                 f"durations decided differently from the live run")
        print(f"[loop] step {step}{' (under torch.profiler)' if profiling else ''}: {pcfg.name} "
              f"full (L={pcfg.num_layers}) {N}x({LOOP_PROMPT}+{new}) judged by {jcfg.name} full "
              f"(L={jcfg.num_layers}) in {N} Tangram actions: grpo_loss {rep.grpo_loss:+.6f}, "
              f"mean reward {rep.mean_reward:.3f}, mean ACT {rep.mean_act * 1e3:.3f} ms (judge "
              f"walls {rep.judge_s.min() * 1e3:.2f}..{rep.judge_s.max() * 1e3:.2f} ms), EOE hits "
              f"{gpu.stats['hits']}/{N}; walls: rollout {rep.rollout_wall_s * 1e3:.1f} ms, reward "
              f"{rep.reward_wall_s * 1e3:.1f} ms (judge calls {rep.judge_s.sum() * 1e3:.1f}, "
              f"Tangram's own host time {(rep.reward_wall_s - rep.judge_s.sum()) * 1e3:.2f}), "
              f"update {rep.update_wall_s * 1e3:.1f} ms, step "
              f"{step_ms:.1f} ms; replay trace equal; launches as expected [{name}; {card}]")
        if not profiling:
            step_walls.append(step_ms)
    shape_recorders.close()
    assert_checked("loop", loop_shapes)
    kernels = device_kernels(prof)
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    mean_ms = sum(step_walls) / len(step_walls)
    print(f"[loop] device busy {busy_ms:.2f} ms over {sum(n for _, n in kernels.values())} device "
          f"operations in the profiled step: {100 * busy_ms / step_ms:.1f}% of its wall "
          f"({step_ms:.1f} ms under the profiler), {100 * busy_ms / mean_ms:.1f}% of the "
          f"unprofiled steps' mean wall ({mean_ms:.1f} ms); launches per step {expect} [{card}]")
    del driver, rep, prof
    torch.cuda.empty_cache()
    refused.stop()

    print(f"[time] phase 7 done at {time.perf_counter() - t_start:.1f}s")

    # ---- 8. live mode on the card's streams; the remote half; the DP scan --
    from repro_torch.core.dparrange import (
        BasicDPOperator,
        DPTask,
        GpuChunkDPOperator,
        dp_arrange_prefixes_dense,
    )
    from repro_torch.core.live import ensure_devices, lane_overlap, run_live_scenario
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.core.scenarios import (
        build_fair_share,
        build_managers,
        compile_scenario,
        install_scenario,
        live_smoke_spec,
        structural_trace,
    )
    from repro_torch.core.scheduler import ElasticScheduler
    from repro_torch.core.simulator import EventLoop
    from repro_torch.examples import remote_round

    t_phase = time.perf_counter()
    spec = live_smoke_spec()
    compiled = compile_scenario(spec, time_scale=LIVE_TIME_SCALE)
    sim_loop = EventLoop()
    sim = Orchestrator(build_managers(spec, sim_loop), loop=sim_loop, policy=ElasticScheduler(),
                       fair_share=build_fair_share(spec), incremental=True)
    install_scenario(compiled, sim)
    sim.run()
    sim.close()
    streams = ensure_devices(len(spec.pools))  # one CUDA stream per pool

    # one live run under torch.profiler, checked: launches (per stream, and by the kernel's own
    # counter), the structural trace against the sim's, each stream's last output against the
    # plain version; then the streams' overlap from the payloads' events and from the kernels
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        live, live_ms = wall_ms(lambda: run_live_scenario(compiled, devices=streams,
                                                          wall_limit_s=120.0))
    payload = live.payload
    per_stream = [payload.launches.get(i, 0) for i in range(len(streams))]
    expect = dict.fromkeys(ops.launch_counts(), 0)
    expect["rmsnorm"] = sum(per_stream) + len(streams)  # the payloads' and a warm-up a stream
    check_counts("live", ops.launch_counts(), expect)
    recs = live.telemetry.records
    if min(per_stream) == 0 or len(recs) != len(sim.telemetry.records) or any(r.failed for r in recs):
        raise AssertionError(f"live: {len(recs)} records ({sum(r.failed for r in recs)} failed) "
                             f"against the sim's {len(sim.telemetry.records)}, launches a stream "
                             f"{per_stream}")
    if structural_trace(recs) != structural_trace(sim.telemetry.records):
        raise AssertionError("live: the structural trace differs from the sim's")
    errs = [assert_close(f"live stream {i} rmsnorm {tuple(x.shape)}", out,
                         ref.rmsnorm_ref(x, w), RMSNORM_F32_TOL)
            for i, (x, w, out) in sorted(payload.outputs.items())]
    if len(errs) != len(streams):
        raise AssertionError(f"live: outputs of {len(errs)} of {len(streams)} streams")
    ov = lane_overlap(payload.windows)
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()
                and "rmsnorm" in e.name()):
            spans.setdefault(e.device_resource_id(), []).append(
                (e.start_ns() / 1e6, (e.start_ns() + e.duration_ns()) / 1e6))
    kov = lane_overlap(spans)
    n_kernels = sum(len(v) for v in spans.values())
    print(f"[live] {spec.name} at time_scale {LIVE_TIME_SCALE} under torch.profiler: "
          f"{len(recs)} actions over {len(streams)} CUDA streams, mean ACT "
          f"{live.telemetry.mean_act() * 1e3:.1f} ms, wall {live_ms:.1f} ms; structural trace "
          f"equal to the sim's; rmsnorm f32 [64, 64] launches a stream {per_stream} "
          f"(+{len(streams)} warm-up, {sum(per_stream) + len(streams)} in all, as its counter "
          f"says); each stream's last output vs plain max abs err {max(errs):.2e} (tol "
          f"{RMSNORM_F32_TOL}) [{card}]")
    print(f"[live] streams' device windows (actions' first launch to drained, CUDA events): busy "
          f"{ov['busy_ms']:.1f} ms summed over streams, {ov['any_ms']:.1f} ms with any stream "
          f"busy, {ov['two_or_more_ms']:.1f} ms with two or more; mean concurrency "
          f"{ov['concurrency']:.2f} of {len(streams)}")
    print(f"[live] kernels (torch.profiler): {n_kernels} rmsnorm kernels on {len(spans)} streams, "
          f"{kov['busy_ms']:.2f} device-ms in all ({1e3 * kov['busy_ms'] / max(n_kernels, 1):.2f} "
          f"us each), {kov['any_ms']:.2f} ms with a kernel running, "
          f"{kov['two_or_more_ms']:.3f} ms with kernels of two or more streams at once")
    del live, payload, prof

    wire_bytes, remote_ms = wall_ms(lambda: remote_round.main(["--start-method", "spawn"]))
    print(f"[live] remote_round twin: serial == loopback == process (spawn) launch traces; wire "
          f"bytes {wire_bytes}; {remote_ms:.0f} ms")

    dp_rng = random.Random(3)  # tests/test_dense_dp.py's draws and _random_tasks

    def dp_tasks(n, pool):
        out = []
        for i in range(n):
            units = tuple(sorted(dp_rng.sample(pool, dp_rng.randint(1, min(4, len(pool))))))
            out.append(DPTask(f"t{i}", units, tuple(round(dp_rng.uniform(0.1, 60.0), 4)
                                                    for _ in units)))
        return out

    dp_cases = []
    for _ in range(10):
        capacity = dp_rng.randint(1, 16)
        dp_cases.append((dp_tasks(dp_rng.randint(1, 4), list(range(1, 9))),
                         BasicDPOperator(capacity)))
    dp_cases.append((dp_tasks(3, [1, 2, 4, 8]), GpuChunkDPOperator((8, 4, 2, 1), total_devices=8)))
    t0 = time.perf_counter()
    for i, (tasks, op) in enumerate(dp_cases):
        got = dp_arrange_prefixes_dense(tasks, op, backend="torch", device=str(dev))
        if got != dp_arrange_prefixes_dense(tasks, op, backend="numpy"):
            raise AssertionError(f"dense DP case {i}: the torch scan on {dev} differs from NumPy")
    print(f"[live] dense DP backend='torch' on {dev}: {len(dp_cases)} cases bit-identical to the "
          f"NumPy path ({(time.perf_counter() - t0) * 1e3:.0f} ms)")
    print(f"[live] phase took {time.perf_counter() - t_phase:.1f}s")
    print(f"[time] phase 8 done at {time.perf_counter() - t_start:.1f}s")

    # ---- 9. agreement with the CPU on a small input (reduced, f32) -------
    def small_inputs(cfg, B):
        """The vlm's stub patches or the audio family's stub frames (12, within its reduced
        encoder_seq of 16) on the card."""
        n = {"vlm": cfg.num_patches, "audio": 12}.get(cfg.family)
        if n is None:
            return {}
        x = torch.randn(B, n, cfg.d_model, generator=gen, device=dev)
        return {"patch_embeds" if cfg.family == "vlm" else "frames": x}

    for arch in ("smollm-360m", "llama3.2-1b", "granite-moe-3b-a800m", "mamba2-130m", HYBRID,
                 "internvl2-1b", "whisper-medium", "llama3-8b", "glm4-9b"):
        cfg = get_config(arch).reduced()
        api = build_model(cfg)
        p_gpu = api.init(torch.Generator(device=dev).manual_seed(2), dev)
        p_cpu = params_from_flat(flat_from_params(p_gpu), cfg, "cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen, device=dev)
        extra = small_inputs(cfg, 2)
        g_cfg = GenerationConfig(max_new_tokens=6, cache_len=40 + cfg.num_patches)
        a = Engine(api, p_gpu, g_cfg).generate({"tokens": toks, **extra})
        b = Engine(api, p_cpu, g_cfg).generate({"tokens": toks.cpu(),
                                                **{k: v.cpu() for k, v in extra.items()}})
        e1 = assert_close(f"{cfg.name} generate logits card vs cpu", a.logits.cpu(), b.logits,
                          SMALL_F32_TOL)
        if not torch.equal(a.tokens.cpu(), b.tokens):
            raise AssertionError(f"{cfg.name}: greedy tokens differ between card and CPU")
        scored = "not scored (an encoder-decoder, as in JAX)"
        if cfg.family != "audio":
            sa = Engine(api, p_gpu, g_cfg).score({"tokens": toks})
            sb = Engine(api, p_cpu, g_cfg).score({"tokens": toks.cpu()})
            scored = f"score err {assert_close(f'{cfg.name} score card vs cpu', sa.cpu(), sb, SMALL_F32_TOL):.2e}"
        print(f"[small] {cfg.name} f32 card vs cpu: generate logits err {e1:.2e}, "
              f"tokens equal, {scored} (tol {SMALL_F32_TOL})")

    # one GRPO and one LM step's loss and gradients, reduced smollm in f32
    cfg = get_config("smollm-360m").reduced()
    api = build_model(cfg)
    p_gpu = api.init(torch.Generator(device=dev).manual_seed(3), dev, trainable=True)
    p_cpu = params_from_flat(flat_from_params(p_gpu), cfg, "cpu").requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (4, 24), generator=gen, device=dev)
    with torch.no_grad():
        old = token_logprobs(p_cpu, toks.cpu(), api)
    small = {"tokens": toks.cpu(), "mask": (torch.arange(23) >= 11).float().expand(4, 23),
             "advantages": torch.tensor([1.0, -1.0, 0.5, -0.5]), "old_logp": old,
             "ref_logp": old + 0.05}
    for kind, loss_fn, b in (
        ("grpo", lambda p, bb: grpo_loss(p, bb, api), small),
        ("lm", api.loss_fn, {"tokens": toks.cpu()}),
    ):
        counts_before = ops.launch_counts()["flash_attention_bwd_dkdv"]
        lg, lc = (loss_fn(p, {k: v.to(p["embed"].device) for k, v in b.items()})[0]
                  for p in (p_gpu, p_cpu))
        gg, g_cpu = grads_of(lg, p_gpu), grads_of(lc, p_cpu)
        if ops.launch_counts()["flash_attention_bwd_dkdv"] != counts_before + cfg.num_layers:
            raise AssertionError(f"small {kind} step: the card's backward skipped the kernels")
        e_loss = assert_close(f"small {kind} loss", lg.detach().cpu(), lc.detach(), SMALL_F32_TOL)
        e_grad = max(grad_err(f"small {kind} grad {k}", gg[k].cpu(), g_cpu[k], SMALL_F32_TOL)[1] or 0.0
                     for k in g_cpu)
        print(f"[small] {cfg.name} f32 {kind} step card vs cpu: loss err {e_loss:.2e}, grads err "
              f"{e_grad:.2e} of each leaf's largest magnitude (tol {SMALL_F32_TOL})")

    # one LM step of the reduced moe, ssm, hybrid, vlm, audio and d-4096 dense configs in f32 (the
    # SSM families on two chunks a sequence), with the launches of one training step
    for arch in ("granite-moe-3b-a800m", "mamba2-130m", HYBRID, "internvl2-1b", "whisper-medium",
                 "llama3-8b", "glm4-9b"):
        cfg = get_config(arch).reduced()
        api = build_model(cfg)
        p_gpu = api.init(torch.Generator(device=dev).manual_seed(4), dev, trainable=True)
        p_cpu = params_from_flat(flat_from_params(p_gpu), cfg, "cpu").requires_grad_(True)
        seq = 2 * cfg.ssm_chunk if cfg.family in SSM_FAMILIES else 24
        toks = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen, device=dev)
        extra = small_inputs(cfg, 2)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        lg = api.loss_fn(p_gpu, {"tokens": toks, **extra})[0]
        gg = grads_of(lg, p_gpu)
        torch.cuda.synchronize()
        counts, expect = ops.launch_counts(), path_launches(cfg, 0, 0, train_steps=1)
        if counts != expect:
            raise AssertionError(f"small lm {cfg.name}: launches {counts}, expected {expect}")
        check_f32_routes(f"small lm {cfg.name}", counts, ops.route_launch_counts(), True)
        lc = api.loss_fn(p_cpu, {"tokens": toks.cpu(), **{k: v.cpu() for k, v in extra.items()}})[0]
        g_cpu = grads_of(lc, p_cpu)
        e_loss = assert_close(f"small lm {cfg.name} loss", lg.detach().cpu(), lc.detach(), SMALL_F32_TOL)
        e_grad = max(grad_err(f"small lm {cfg.name} grad {k}", gg[k].cpu(), g_cpu[k], SMALL_F32_TOL)[1] or 0.0
                     for k in g_cpu)
        print(f"[small] {cfg.name} f32 lm step 2x{seq} card vs cpu: loss err {e_loss:.2e}, grads err "
              f"{e_grad:.2e} of each leaf's largest magnitude (tol {SMALL_F32_TOL}); launches as "
              f"expected")

    print(f"[time] phase 9 done at {time.perf_counter() - t_start:.1f}s")

    # ---- 10. the multi-device layer: six ranks share the card -------------------------
    from repro_torch.launch.mesh import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mesh] the parent holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved) as the ranks start")
    t10, t10_host = time.perf_counter(), time.time()
    # the dry-run on this machine's torch (the fake process group stands for 256 ranks), on the
    # CPU beside the ranks
    dry_dir = tempfile.TemporaryDirectory()
    dry_err = open(Path(dry_dir.name) / "stderr", "w+")
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "granite-moe-3b-a800m",
         "--shape", "train_4k", "--mesh", "single", "--out", dry_dir.name],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=dry_err,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    try:
        rows = MESH_SERVE + MESH_TRAIN + (MESH_GRPO,)
        cfgs = {label: mesh_config(label, arch, dt, layers) for label, arch, _, dt, layers in rows}
        if len(cfgs) != len(rows):
            raise ValueError("phase 10's runs need labels of their own")
        serve = [(label, seed, cfgs[label]) for label, _, seed, _, _ in MESH_SERVE]
        train_runs = [(label, seed, cfgs[label]) for label, _, seed, _, _ in MESH_TRAIN]
        grpo_label, _, grpo_seed, _, _ = MESH_GRPO
        grpo_runs = [(grpo_label, grpo_seed, cfgs[grpo_label],
                      mesh_grpo_batch(cfgs[grpo_label], grpo_seed, dev))]
        # what a rank holds of each train step's model, reckoned before the runs: ~12 bytes a
        # parameter in bf16 (bf16 weights and gradients, f32 moments), ~16 in f32
        for label, _, cfg in train_runs:
            n = mesh_rank_params(cfg)
            per = 12 if cfg.dtype == "bfloat16" else 16
            print(f"[mesh] train step {label}: a rank holds {n / 1e6:.1f} M of its "
                  f"{build_model(cfg).param_count() / 1e6:.1f} M parameters, ~{per * n / 2**30:.2f}"
                  f" GiB at ~{per} bytes a parameter before activations; six ranks "
                  f"~{6 * per * n / 2**30:.2f} GiB")
        ranks = run_ranks(mesh_rank, MESH_WORLD,
                          (MESH_SHAPE, str(dev), serve, train_runs, grpo_runs),
                          device=dev, timeout=900)
        t_back = time.time()
    except BaseException:
        dry.kill()
        dry.wait()
        raise
    print(f"[mesh] backend gloo (torch.distributed over tcp://localhost), DeviceMesh (data "
          f"{MESH_SHAPE[0]}, model {MESH_SHAPE[1]}) of {MESH_WORLD} ranks, every rank on cuda:0; "
          f"{time.perf_counter() - t10:.1f}s for the ranks' runs [{card}]")
    for what, n in mesh_launches(ranks, cfgs).items():
        launches[what] += n
    for res in ranks:  # the f32 routes' launches, within those
        for counts in res["routes"].values():
            for what, n in counts.items():
                route_launches[what] += n
    for r, res in enumerate(ranks):
        print(f"[mesh] rank {r}: peak memory " + ", ".join(
            f"{a} {g:.2f} GiB" for a, g in res["peak_gib"].items()) + "; walls (gloo on one card, "
            "collectives counted; not multi-card speed) " + ", ".join(
            f"{k} {v:.3f}s" for k, v in res["walls"].items()))
    print("[mesh] rank 0's runs on the host's clock from the parent's start of the ranks: "
          + mesh_timeline(ranks[0]["spans"], ranks[0]["walls"], t10_host, t_back))
    for label, cfg in cfgs.items():  # the SSM mixer's route, from the heads its B4 launches saw
        if cfg.family not in SSM_FAMILIES:
            continue
        want = mesh_ssm_heads(cfg)
        for r, res in enumerate(ranks):
            for what, heads in res["ssd_heads"].items():
                if what in (f"generate {label}", f"train step {label}") and heads != [want]:
                    raise AssertionError(f"[mesh] rank {r} {what}: B4 ran on {heads} heads, "
                                         f"expected {want}")
        route = "split over its heads" if want < cfg.ssm_heads else "repeated on every model rank"
        print(f"[mesh] {label}: the SSM mixer {route}, B4 and B8 on {want} of {cfg.ssm_heads} "
              f"heads a rank (every rank, every run)")
    print(f"[mesh] every rank's launches as path_launches gives them, per run: "
          + "; ".join(f"{k} {dict((n, c) for n, c in v.items() if c)}"
                      for k, v in ranks[0]["launches"].items()))
    for what, kinds in ranks[0]["collectives"].items():
        print(f"[mesh] rank 0 collectives of one {what}: " + ", ".join(
            f"{k} x{n} ({b / 2**20:.4f} MiB)" for k, (n, b) in kinds.items()))
    col = ranks[0]["collectives"]
    print("[mesh] the optimizer's collectives a step (one all-reduce of the norm's partials), "
          "within the steps' all-reduces: " + "; ".join(
              f"{k.removeprefix('optimizer ')}: {col[k].get('all-reduce', (0, 0))[0]} of "
              f"{col[k.replace('optimizer ', '', 1)].get('all-reduce', (0, 0))[0]}"
              for k in col if k.startswith("optimizer ")) + " (the literal AdamW's steps took "
          "58 / 36 / 39 all-reduces: train granite E10, train llama, GRPO llama)")

    for label, seed, cfg in serve:
        print(hold_mesh_generate(label, seed, cfg, ranks[0][label], dev))
        torch.cuda.empty_cache()
    for label, _, cfg in train_runs:  # read on rank 0 (``mesh_rank``)
        print(mesh_train_line(label, cfg, ranks[0][f"train {label}"]))
    for label, seed, cfg, cpu_batch in grpo_runs:
        api = build_model(cfg)
        batch = {k: v.to(dev) for k, v in cpu_batch.items()}
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev, trainable=True)
        loss = grpo_loss(params, batch, api)[0]
        grads = grads_of(loss, params)
        got_loss, got_grads = ranks[0][f"grpo {label}"]
        e_loss = assert_close(f"[mesh] grpo {label} loss", torch.tensor(got_loss),
                              loss.detach().cpu(), MESH_GRAD_TOL, rel=False)
        e_grad = max(grad_err(f"[mesh] grpo {label} grad {k}", got_grads[k], g.cpu(),
                              MESH_GRAD_TOL)[1] or 0.0 for k, g in grads.items())
        del grads
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev, trainable=True)
        _, want = make_grpo_step(api, AdamWConfig())(TrainState(params, init_adamw(params)), batch)
        e_metric = 0.0
        for r, res in enumerate(ranks):
            got = res[f"grpo metrics {label}"]
            if got.keys() != want.keys():
                raise AssertionError(f"[mesh] grpo {label} rank {r}: metrics {sorted(got)}")
            for k, w in want.items():
                err = abs(got[k] - float(w)) / max(1.0, abs(float(w)))
                if not err <= MESH_GRAD_TOL:
                    raise AssertionError(f"[mesh] grpo {label} rank {r} {k}: {got[k]} vs {float(w)}")
                e_metric = max(e_metric, err)
        print(f"[mesh] grpo step {label} f32 {tuple(cpu_batch['tokens'].shape)} (make_grpo_step "
              f"with the rules) on the mesh vs unsharded on the card: loss err {e_loss:.2e}, grads "
              f"err {e_grad:.2e} of each leaf's largest magnitude, every rank's step metrics "
              f"within {e_metric:.2e} (tol {MESH_GRAD_TOL})")
        del params
    assert_checked("mesh", set().union(*(res["shapes"] for res in ranks)))

    try:
        rc = dry.wait(timeout=600)
        dry_err.seek(0)
        if rc != 0:
            raise AssertionError(f"[mesh] the dry-run failed:\n{dry_err.read()[-3000:]}")
        rec = json.loads((Path(dry_dir.name) / "granite-moe-3b-a800m_train_4k_single.json").read_text())
    finally:
        dry.kill()
        dry_err.close()
        dry_dir.cleanup()
    if not rec.get("ok"):
        raise AssertionError(f"[mesh] the dry-run's record failed: {rec.get('error')}")
    col = rec["collectives"]
    print(f"[mesh] dry-run granite-moe-3b-a800m train_4k 16x16 (fsdp {rec['fsdp']}): state "
          f"{rec['state_bytes_per_dev'] / 1e9:.3f} GB/device, batch {rec['batch_bytes_per_dev']:.0f} "
          f"B/device, {rec['cost_analysis']['flops']:.4e} FLOPs/device, {col['count']} collectives ("
          + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in col.items() if k != "count" and v)
          + f"), traced in {rec['lower_s']:.1f}s on the CPU")
    print(f"[time] phase 10 done at {time.perf_counter() - t_start:.1f}s "
          f"({time.perf_counter() - t10:.1f}s)")

    # ---- report ---------------------------------------------------------
    kernels = [
        dict(name="rmsnorm", route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:19", launches=launches["rmsnorm"],
             **rms_rows[(8 * 160, 2048, torch.bfloat16)]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:72",
             launches=launches["flash_attention"],
             **flash_rows[(8, 32, 8, 160, 64, True, torch.bfloat16)]),
        dict(name="moe_matmul", route="cuda", source="src/repro_torch/kernels/csrc/moe_matmul.cu",
             replaces="src/repro/kernels/moe_matmul.py:36", launches=launches["moe_matmul"],
             **moe_rows[(40, 384, 1536, 512, torch.bfloat16)]),
        dict(name="ssd_intra_chunk", route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:39", launches=launches["ssd_intra_chunk"],
             **ssd_rows[(8, 24, 160, 128, torch.bfloat16)]),
        # B11 has no TPU kernel: "replaces" names the JAX einsums (XLA) it computes
        dict(name="cross_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/models/layers.py:195", launches=launches["cross_attention"],
             **cross_rows[(4, 16, 16, PROMPT, 1500, 64, torch.bfloat16)]),
        dict(name="flash_decode", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/models/layers.py:328", launches=launches["flash_decode"],
             **decode_rows[(4, 16, 16, 1500, 1500, 64, torch.bfloat16)]),
    ]
    grpo_shape = (16, 15, 5, 160, 64, True, torch.bfloat16)
    for kname, key, src, of in (
        ("flash_attention_bwd_dq", grpo_shape, "flash_attention", "src/repro/kernels/flash_attention.py:72"),
        ("flash_attention_bwd_dkdv", grpo_shape, "flash_attention", "src/repro/kernels/flash_attention.py:72"),
        ("cross_attention_bwd_stats", (2, 16, 16, 448, 1500, 64, torch.bfloat16), "flash_attention",
         "src/repro/models/layers.py:195"),
        ("cross_attention_bwd_fused", (2, 16, 16, 448, 1500, 64, torch.bfloat16), "flash_attention",
         "src/repro/models/layers.py:195"),
        ("rmsnorm_bwd", (16 * 160, 960, torch.bfloat16), "rmsnorm", "src/repro/kernels/rmsnorm.py:19"),
        ("rmsnorm_bwd_dweight", (16 * 160, 960, torch.bfloat16), "rmsnorm", "src/repro/kernels/rmsnorm.py:19"),
        ("rmsnorm_bwd_wide", (1024, 3200, torch.bfloat16), "rmsnorm", "src/repro/kernels/rmsnorm.py:19"),
        ("moe_matmul_bwd_dbuf", (40, 256, 1536, 512, torch.bfloat16), "moe_matmul",
         "src/repro/kernels/moe_matmul.py:36"),
        ("moe_matmul_bwd_dw", (40, 256, 1536, 512, torch.bfloat16), "moe_matmul",
         "src/repro/kernels/moe_matmul.py:36"),
        ("ssd_intra_chunk_bwd", (4, 24, 256, 64, 128, torch.bfloat16), "ssd_scan",
         "src/repro/kernels/ssd_scan.py:39"),
        ("ssd_intra_chunk_bwd_reduce", (4, 24, 256, 64, 128, torch.bfloat16), "ssd_scan",
         "src/repro/kernels/ssd_scan.py:39"),
    ):
        # the TPU kernel has no backward: "replaces" names the kernel whose gradient this is
        kernels.append(dict(name=kname, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}.cu",
                            replaces=of, launches=launches[kname], **bwd_rows[(kname,) + key]))
    # the f32 route's kernels (split TF32 on the tensor cores), counted apart within B2's, B11's
    # and B5's launches, at whisper's f32 encoder shape
    f32_enc = (4, 16, 16, 1500, 64, False, torch.float32)
    for kname, rows_ in (("flash_attention_tf32x3", flash_rows[f32_enc]),
                         ("flash_attention_bwd_dq_tf32x3", bwd_rows[("flash_attention_bwd_dq",) + f32_enc]),
                         ("flash_attention_bwd_dkdv_tf32x3",
                          bwd_rows[("flash_attention_bwd_dkdv",) + f32_enc])):
        kernels.append(dict(name=kname, route="cuda",
                            source="src/repro_torch/kernels/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:72",
                            launches=route_launches[kname], **rows_))
    # B3's, B7's and B4's f32 routes, counted apart within moe_matmul's, its backward's and
    # ssd_intra_chunk's launches: granite's f32 LM gate/up (split TF32 on wgmma; B7 "replaces"
    # the kernel whose gradient it is) and mamba2's f32 LM chunks (three bf16 pieces)
    f32_lm = (40, 256, 1536, 512, torch.float32)
    for kname, src, of, rows_ in (
        ("moe_matmul_tf32x3", "moe_matmul", "src/repro/kernels/moe_matmul.py:36", moe_rows[f32_lm]),
        ("moe_matmul_bwd_dbuf_tf32x3", "moe_matmul", "src/repro/kernels/moe_matmul.py:36",
         bwd_rows[("moe_matmul_bwd_dbuf",) + f32_lm]),
        ("moe_matmul_bwd_dw_tf32x3", "moe_matmul", "src/repro/kernels/moe_matmul.py:36",
         bwd_rows[("moe_matmul_bwd_dw",) + f32_lm]),
        ("ssd_intra_chunk_mma3", "ssd_scan", "src/repro/kernels/ssd_scan.py:39",
         ssd_rows[(4, 24, 256, 128, torch.float32)]),
    ):
        kernels.append(dict(name=kname, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}.cu",
                            replaces=of, launches=route_launches[kname], **rows_))
    for kname in ("adamw_norm", "adamw_norm_finish", "adamw_update"):
        # no TPU kernel: "replaces" names the JAX function whose step these launches compute
        kernels.append(dict(name=kname, route="cuda", source="src/repro_torch/kernels/csrc/adamw.cu",
                            replaces="src/repro/training/optimizer.py:72", launches=launches[kname],
                            **adamw_rows["llama3.2-1b"][kname]))
    for k in kernels:
        k["pass"] = ("optimizer" if k["name"].startswith("adamw") else
                     "backward" if "_bwd" in k["name"] else "forward")
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels the main path never launched: {idle}")
    print("[report] per-kernel numbers, bf16: forward at the score shapes, rmsnorm [1280, 2048] and "
          "flash B=8 H=32 KV=8 S=160 d=64 causal (llama3.2-1b), moe_matmul E=40 C=384 D=1536 "
          "F=512 (granite-moe-3b-a800m gate/up), ssd_intra_chunk BNC=8 H=24 Q=160 hd=64 N=128 "
          "(mamba2-130m); backward at the GRPO shape (smollm-360m, 16 x 160): flash B=16 H=15 "
          "KV=5 S=160 d=64 causal (plain and library: the gradient of the same inputs), rmsnorm "
          "[2560, 960]; B11 (whisper-medium's cross-attention over 1500 frames): the forward at "
          "its prefill B=4 H=16 S=128 Sk=1500 d=64, the backward's statistics pass and one pass at "
          "its LM shape B=2 S=448 (library: sdpa's whole backward), the "
          "decode over [4, 1500, 1024] caches (library: sdpa on the same views); at the LM "
          "shapes: the wide rmsnorm backward [1024, 3200] (hymba-1.5b's "
          "out_norm), moe_matmul's dbuf and dw E=40 C=256 D=1536 F=512 (granite gate/up; library "
          "torch.bmm), ssd_intra_chunk's backward and reduce BNC=4 H=24 Q=256 hd=64 N=128 "
          "(mamba2-130m 2 x 512); AdamW (B9) over llama3.2-1b's 11 leaves (1.236 B bf16 "
          "parameters and grads, f32 moments; library torch._foreach_norm and "
          "torch._fused_adamw_ on bf16 moments); the f32 attention route's forward, dq and dkdv "
          "(split TF32, counted apart within B2's, B11's and B5's launches) at whisper's f32 "
          "encoder shape B=4 H=16 S=1500 d=64 non-causal; moe_matmul's forward and backward (dbuf, "
          "dw) and ssd_intra_chunk's f32 routes (split TF32 on wgmma; three bf16 pieces a value), "
          "counted apart within their kernels' launches, at granite's f32 LM gate/up E=40 C=256 "
          "D=1536 F=512 (library torch.bmm) and mamba2's f32 LM chunks BNC=4 H=24 Q=256 hd=64 "
          "N=128; launches summed over the eight serving runs, the "
          "training runs, the closed loop's four steps (three plus the profiled one), the mesh's "
          "ranks and live mode's payloads")
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
