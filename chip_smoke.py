#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each of which raises on failure (nothing is caught):

1. environment: the card's name and power limit; TF32 off for f32 matmuls
   and convolutions;
2. build: the four CUDA kernels from ``src/repro_torch/kernels/csrc`` (each
   library with its backward entry points) and an empty one-thread kernel
   (``launch_floor.cu``), one nvcc per source started together, for sm_90a,
   printing what ptxas reports;
3. kernels: the launch floor (the empty kernel's time, taken as the
   kernels' are); each kernel against its plain PyTorch version on the
   card, at the shapes the serving paths give it and at longer ones, with
   the kernel's, the plain version's and (where one PyTorch call computes
   the same function) a library call's times, and the least time the card
   could take; each ``moe_matmul`` case also with its launch plan (route,
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
   whisper's 1500 frames);
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
   operations too, so that the device time of its cross-attention, plain
   PyTorch inside the ``cross_attention`` profiler range, is read from the
   trace); every (kernel, shape) that the hymba runs and the four new
   models' runs launch is held against its plain version: by one of phase
   3's cases, or where no case covers it, at once on fresh inputs
   (``hold_at_shape``);
5. backward kernels: flash attention's dq and dk/dv kernels, RMSNorm's dx
   (a warp per row, and a block per row past D 2048) and dweight kernels,
   moe_matmul's dbuf and dw kernels and ``ssd_intra_chunk``'s kernel and
   reduce against autograd through their plain versions, over grids of
   types, head dims, masks, GQA groups, lengths, capacities, widths, state
   sizes, chunk lengths, zero, absent and non-zero chunk-state gradients and
   a strong decay, GQA g 1-16, timed at the training paths' shapes (the
   four new models' LM runs too) and longer ones
   beside their bounds, the plain versions and the library's gradient
   (``sdpa``, ``F.rms_norm``, ``torch.bmm``; none for the SSD), each timed
   kernel called twice for bit-identical results;
6. training at full width on seeded random bf16 weights, with exact launch
   counts: GRPO (the paper's loop without the control plane:
   ``smollm-360m`` generates 4 prompts x group 4, 128 prompt + 32 sampled
   tokens; ``llama3.2-1b`` scores them; group advantages; three
   ``make_grpo_step`` steps), checking that the positive-advantage
   sequences gain log-probability over the negative ones; and LM training
   through ``repro_torch.launch.train``, three steps each: ``llama3.2-1b``
   (4 x 256, through ``main``), and through ``trainer_from_config`` and ``train``
   ``granite-moe-3b-a800m`` (4 x 256; 24 of its 32 layers, as its full
   depth's training state does not fit the card), ``mamba2-130m`` and
   ``hymba-1.5b`` (2 x 512: two SSD chunks a sequence, so the chunk-state
   gradient is live), ``internvl2-1b`` (4 x (256 patches + 256)),
   ``whisper-medium`` (2 x (1500 frames + 448), both at full depth) and
   ``llama3-8b`` and ``glm4-9b`` (4 x 256, 4 layers each), with finite
   losses (falling over the three steps for the last four); one warm step
   of each profiled, with its peak memory (whisper's with its
   cross-attention's device time, forward and backward, from the trace);
   every (kernel, shape) that these runs launch is held against its plain
   version, by phases 3 and 5's cases or at once;
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
   drop-free copy) and ``llama3.2-1b`` at full width in bf16, f32 copies of
   both (granite at 8 of its layers), and the reduced ``kimi-k2-1t-a32b``
   through ``Engine`` with the rules, and take one train step each of the
   reduced granite (10 experts) and llama3.2-1b; each rank's launches must
   be ``path_launches``'s, the parent holds the logits, losses and
   gradients against the same weights unsharded on the card and every
   (kernel, shape) a rank launched against its plain version, and prints
   each rank's peak memory, walls (gloo through one host: not multi-card
   speed) and collectives by kind; then the dry-run of granite's train_4k
   on the 16 x 16 mesh once.

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
F32_FLOPS = 67e12

BF16_TOL = 2e-2
RMSNORM_F32_TOL = 1e-5
FLASH_F32_TOL = 2e-5
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
# held to this absolute limit.
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
# chunk-state gradient is live.  granite-moe-3b-a800m keeps 24 of its 32 layers at full width:
# at full depth the literal AdamW's f32 moments and temporaries (its stacked expert leaves hold
# 1.0 B elements each) ran out of the card's 80 GB
LM_FAMILY_RUNS = (("granite-moe-3b-a800m", 4, 256, 24), ("mamba2-130m", 2, 512, None),
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
# the literal AdamW's ~20 bytes a parameter come to 38-41 GB for the cut models' 1.9 and 2.1 B
# parameters, where full depth would need 160-190 GB
SLICE_LM_RUNS = (("internvl2-1b", 4, 256, None), ("whisper-medium", 2, 448, None),
                 ("llama3-8b", 4, 256, 4), ("glm4-9b", 4, 256, 4))
SLICE = {arch for arch, _ in SLICE_GENERATE}


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


def flash_bound(B, H, KV, S, d, causal, elem):
    """q, k, v read once, out written once; 4*d operations per scored pair."""
    pairs = S * (S + 1) // 2 if causal else S * S
    peak = BF16_TENSOR_FLOPS if elem == 2 else F32_FLOPS
    return bound((2 * B * H * S * d + 2 * B * KV * S * d) * elem / HBM_BYTES_PER_S,
                 4 * d * B * H * pairs / peak)


def moe_bound(E, C, D, F, elem):
    """buf and w read once, out written once; 2*D operations per output element."""
    peak = BF16_TENSOR_FLOPS if elem == 2 else F32_FLOPS
    return bound((E * C * D + E * D * F + E * C * F) * elem / HBM_BYTES_PER_S,
                 2 * E * C * D * F / peak)


def ssd_bound(BNC, H, Q, hd, N, elem):
    """x, b, c, cum read once, y and the f32 state written once.  Operations
    over the causal pairs q >= j: C.B (2N each) once per chunk, since the
    heads share B and C; per (chunk, head) the decay (1) and S.x (2 hd
    each), then the state (2 hd N per row plus the decay weights); all on
    f32 operands, so against the f32 peak."""
    pairs = Q * (Q + 1) // 2
    t_bytes = (2 * BNC * H * Q * hd * elem
               + 4 * (2 * BNC * Q * N + BNC * H * Q + BNC * H * hd * N)) / HBM_BYTES_PER_S
    ops = BNC * 2 * N * pairs + BNC * H * ((1 + 2 * hd) * pairs + 2 * Q * hd * N + Q * hd)
    return bound(t_bytes, ops / F32_FLOPS)


def flash_bwd_bounds(B, H, KV, S, d, causal, elem):
    """(dq kernel, dkdv kernel, whole backward) bounds.

    Only the function's own inputs and outputs count; the D = rowsum(dO o)
    that the dq kernel hands to the dkdv kernel is an intermediate and
    counts in neither.  dq reads q, k, v, o, dO and the lse and writes dQ;
    its products are Q K^T, dO V^T and dS K (6 d per scored pair).  dkdv
    reads q, k, v, dO and the lse and writes dK and dV; Q K^T, dO V^T,
    P^T dO and dS^T Q (8 d).  The whole backward reads q, k, v, o, dO and
    the lse and writes the three gradients, with 10 d per pair (2.5x the
    forward's 4 d).
    """
    pairs = S * (S + 1) // 2 if causal else S * S
    peak = BF16_TENSOR_FLOPS if elem == 2 else F32_FLOPS
    q_bytes, kv_bytes, stat = B * H * S * d * elem, B * KV * S * d * elem, 4 * B * H * S
    return (
        bound((4 * q_bytes + 2 * kv_bytes + stat) / HBM_BYTES_PER_S, 6 * d * B * H * pairs / peak),
        bound((2 * q_bytes + 4 * kv_bytes + stat) / HBM_BYTES_PER_S, 8 * d * B * H * pairs / peak),
        bound((4 * q_bytes + 4 * kv_bytes + stat) / HBM_BYTES_PER_S, 10 * d * B * H * pairs / peak),
    )


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
    per expert each.  The whole backward reads buf, w and dout once and writes both."""
    peak = BF16_TENSOR_FLOPS if elem == 2 else F32_FLOPS
    ops_one = 2 * E * C * D * F / peak
    buf, w, out = E * C * D * elem, E * D * F * elem, E * C * F * elem
    return (bound((out + w + buf) / HBM_BYTES_PER_S, ops_one),
            bound((buf + out + w) / HBM_BYTES_PER_S, ops_one),
            bound((2 * buf + 2 * w + out) / HBM_BYTES_PER_S, 2 * ops_one))


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


def grad_err(name, got, want, tol):
    """(max |got - want|, that over max |want|, or None where want is all zero).

    Raises where the relative error exceeds tol, where a zero reference's
    error exceeds ZERO_GRAD_ABS, or on a non-finite value.
    """
    import torch

    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    if scale == 0.0:
        if err > ZERO_GRAD_ABS:
            raise AssertionError(f"{name}: {err:.3e} where the reference is 0 (limit {ZERO_GRAD_ABS})")
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
    """Device milliseconds of the work that a finished trace (host and CUDA activity) ran
    inside ``record_function(name)`` ranges, their backward included.  Each device
    operation is charged to the host operation that launched it (the profiler's linked
    correlation id, as ``torch.autograd.profiler`` links them), and that operation counts
    where it ran inside such a range on its thread, or inside the backward node (same
    sequence number, forward thread the range's) of an autograd operation that did."""
    import bisect

    import torch

    device_ns, host = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                c = e.linked_correlation_id()
                device_ns[c] = device_ns.get(c, 0) + e.duration_ns()
        elif e.linked_correlation_id() == 0:  # a host operation or range, not a runtime call
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
    ops = {e.correlation_id() for e in fwd} | {e.correlation_id() for e in host if inside(e, bwd)}
    return sum(device_ns.get(c, 0) for c in ops) / 1e6


def profiled(label, fn, card, rows=10, ranges=()):
    """One warm call of fn under torch.profiler: its device busy share and top kernels.
    Returns {range: device ms} of the named ``record_function`` ranges (whose trace
    records the host's operations too), each of which must hold some device work.

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
    for r, r_ms in in_ranges.items():
        if not r_ms > 0:
            raise AssertionError(f"[profile] {label}: no device work found inside range {r}")
        print(f"[profile] {label} range {r}: {r_ms:.3f} device ms, {100 * r_ms / busy_ms:.1f}% "
              f"of device busy {busy_ms:.2f} ms [{card}]")
    return in_ranges


PORT_KERNEL_PREFIXES = ("rmsnorm", "flash_", "moe_matmul", "ssd_")


FWD_F32_TOL = {"rmsnorm": RMSNORM_F32_TOL, "flash_attention": FLASH_F32_TOL,
               "moe_matmul": F32_TOL, "ssd_intra_chunk": F32_TOL}


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


def rms_key(x, *_, **__):
    return (*x.shape, x.dtype)


def ssd_key(x, b, *_):
    return (*x.shape, b.shape[2], x.dtype)


def moe_key(buf, w, *_, **__):
    return (*buf.shape, w.shape[2], buf.dtype)


def kernel_wrappers(train=False):
    """(module, wrapper, shape key) of the forward wrappers that serving records, or with
    ``train`` of every wrapper a training step launches (moe_matmul's forward among them)."""
    from repro_torch.kernels import flash_attention as flash_k
    from repro_torch.kernels import moe_matmul as moe_k
    from repro_torch.kernels import rmsnorm as rms_k
    from repro_torch.kernels import ssd_scan as ssd_k

    fwd = ((flash_k, "flash_attention", flash_key), (rms_k, "rmsnorm", rms_key),
           (ssd_k, "ssd_intra_chunk", ssd_key))
    if not train:
        return fwd
    return (*fwd, (moe_k, "moe_matmul", moe_key), (flash_k, "flash_attention_bwd", flash_key),
            (rms_k, "rmsnorm_bwd", rms_key), (moe_k, "moe_matmul_bwd", moe_key),
            (ssd_k, "ssd_intra_chunk_bwd", ssd_key))


def recording(shapes, wrappers):
    """Patches that add (wrapper, shape key) to ``shapes`` at every call of the wrappers."""
    stack = ExitStack()
    for mod, fname, key in wrappers:
        def call(*a, _fn=getattr(mod, fname), _name=fname, _key=key, **kw):
            shapes.add((_name, _key(*a, **kw)))
            return _fn(*a, **kw)

        stack.enter_context(mock.patch.object(mod, fname, call))
    return stack


# phase 10: six ranks share the card on a (data 2, model 3) mesh over gloo (NCCL refuses two
# ranks on one device).  Serving, generation 4 x (128 prompt + 9 new: one prefill and 8 decode
# steps) with the caches 138 long (a multiple of the model extent, so that their sequence shards
# on it): granite at full width in bf16 at 8 of its 32 layers, on a copy of its config whose
# capacity drops nothing, as phase 4's checks run it (its 40 experts pad to 42, 14 a model rank),
# and llama3.2-1b at full width and depth in bf16 (32 H / 8 KV pad to 9 KV x g 4, 12 heads a
# rank); f32 copies of both held to summation order; the reduced f32 kimi.  One train step each
# of the reduced f32 granite with 10 experts (padded to 12) and the reduced llama3.2-1b on 4 x 64
# tokens.  The MoE configs drop nothing: where capacity drops assignments, each data shard's own
# capacity drops others than the global one does, in JAX too (tests/test_torch_sharded_
# equivalence.py holds the dropping dispatch against JAX's on (2, 3) and (2, 4); PERF.md gives
# the drops that the capacity factor 4.0 makes in the train step's config).
# (label, arch, seed, dtype, layers or None for the config's depth)
MESH_SHAPE, MESH_WORLD = (2, 3), 6
MESH_NEW, MESH_CACHE = 9, 138
MESH_SERVE = (("granite-moe-3b-a800m 8L", "granite-moe-3b-a800m", 21, "bfloat16", 8),
              ("llama3.2-1b", "llama3.2-1b", 22, "bfloat16", None),
              ("granite-moe-3b-a800m f32 8L", "granite-moe-3b-a800m", 21, "float32", 8),
              ("llama3.2-1b f32", "llama3.2-1b", 22, "float32", None),
              ("kimi-k2-1t-a32b reduced", "kimi-k2-1t-a32b", 23, "float32", None))
MESH_TRAIN = (("granite-moe-3b-a800m reduced E10", "granite-moe-3b-a800m", 24, "float32", None),
              ("llama3.2-1b reduced", "llama3.2-1b", 25, "float32", None))
MESH_TRAIN_SHAPE = (4, 64)
MESH_GRAD_TOL = 2e-4  # sharded vs unsharded train step: loss (abs) and each gradient (rel. to max)
# bf16 generation, sharded vs unsharded on the same weights, each row until its tokens part:
# 1.5x the largest reading of `tools/torch_mesh_probe.py bf16` over seeds 21, 22, 31-34 (granite
# 0.0571-0.0811, llama3.2-1b 0.0945-0.1112; llama's own bf16 forward, batch 4 against each row
# alone, differs from itself by 0.097-0.104 on the same seeds).
MESH_BF16_TOL = {"moe": 0.12, "dense": 0.17}
# ... and the sharded bf16 logits, against an f32 forward of the same weights teacher-forced on
# their tokens, may lie at most this many times as far from it as the unsharded bf16 logits do
# (0.796-1.423 over the same twelve readings).
MESH_ANCHOR_RATIO = 2.0


def mesh_config(label, arch, dtype, layers):
    """The config phase 10 runs under ``label``: full width, or reduced where the label says so
    (granite's reduced copy with 10 experts); MoE copies drop nothing (capacity factor E / K)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if "reduced" in label:
        cfg = cfg.reduced()
        if "E10" in label:
            cfg = dataclasses.replace(cfg, num_experts=10)
    cfg = dataclasses.replace(cfg, dtype=dtype, num_layers=layers or cfg.num_layers)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    return cfg


def mesh_batch(cfg, seed, shape):
    """Tokens drawn on the CPU from ``seed`` (equal on every rank and in the parent)."""
    import torch

    return torch.randint(0, cfg.vocab_size, shape, generator=torch.Generator().manual_seed(seed))


def mesh_rank(rank, world, shape, device, serve, train):
    """One rank of phase 10 (started by ``run_ranks``): the sharded serving runs of ``serve`` and
    train steps of ``train`` ((label, seed, config) each), each with the launch counts set to 0
    just before it and read just after, every (kernel, shape) it launches recorded, and the
    collectives of one prefill, one decode step and one train step counted.  Returns what the
    parent checks (rank 0 also the logits, the loss and the gradients)."""
    import logging
    import warnings

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
    from repro_torch.training import AdamWConfig
    from repro_torch.training.optimizer import adamw_update, init_adamw
    from repro_torch.training.train_step import grads_of

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        for k in _build.KERNELS:
            _build.load(k)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rules = make_rules(device_mesh(dev.type, shape, ("data", "model")))
    out = {"shapes": set(), "launches": {}, "walls": {}, "collectives": {}, "peak_gib": {}}

    def run(label, fn, engine=None):
        """``fn`` with the launch counts set to 0 just before it and read just after, and its
        collectives counted (one prefill and one decode step apart, through ``engine``)."""
        sync()
        dist.barrier()
        ops.reset_launch_counts()
        counter = CollectiveCounter(bytes_accessed=False)
        if engine is not None:
            engine.api = FirstCalls(engine.api, counter, out["collectives"], label)
        t0 = time.perf_counter()
        with recording(out["shapes"], kernel_wrappers(train=True)), counter.mode:
            res = fn()
        sync()
        out["walls"][label] = time.perf_counter() - t0
        out["launches"][label] = ops.launch_counts()
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
        api = build_model(cfg)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        params = in_turn(lambda: api.init(torch.Generator(device=dev).manual_seed(seed), dev,
                                          rules=rules))
        batch = {"tokens": mesh_batch(cfg, seed, (4, PROMPT)).to(dev)}
        engine = Engine(api, params, GenerationConfig(max_new_tokens=MESH_NEW, cache_len=MESH_CACHE),
                        rules)
        g = run(f"generate {label}", lambda: engine.generate(batch), engine)
        if cuda:
            out["peak_gib"][label] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.empty_cache()
        if rank == 0:
            out[label] = (g.tokens.cpu(), g.logits.cpu())
        del params, engine

    opt = AdamWConfig()
    for label, seed, cfg in train:
        api = build_model(cfg)
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev, trainable=True,
                          rules=rules)
        batch = {"tokens": mesh_batch(cfg, seed, MESH_TRAIN_SHAPE).to(dev)}

        def step():
            loss, _ = api.loss_fn(params, batch, rules)
            grads = grads_of(loss, params)
            adamw_update(opt, params, grads, init_adamw(params))
            return loss, grads

        loss, grads = run(f"train step {label}", step)
        if rank == 0:
            out[f"train {label}"] = (float(loss), {k: rules.full(g).cpu() for k, g in grads.items()})
        else:
            for g in grads.values():  # every rank joins the gathers
                rules.full(g)
        del params, grads
    return out


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


def mesh_full_logits(params, cfg, seq, first):
    """The f32 logits of a full forward over ``seq`` [B, S] at positions ``first``.."""
    import torch

    from repro_torch.models.layers import logits_fn
    from repro_torch.models.transformer import arange_positions, embed_tokens, forward

    with torch.inference_mode():
        x = embed_tokens(params, seq, cfg)
        h, _ = forward(params, x, arange_positions(*seq.shape, seq.device), cfg)
        return logits_fn(params, h[:, first:], cfg)


def mesh_serve_errors(cfg, params, prompt, got, ref):
    """What a sharded generation (``got``: its tokens [B, N] and logits [B, N, V] on the CPU)
    is held to against the unsharded one on the same weights (``ref``, a Generation):

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
    P, dev = prompt.shape[1], prompt.device
    seq = torch.cat([prompt, rt[:, :-1].to(dev)], dim=1)
    alone = torch.cat([mesh_full_logits(params, cfg, seq[i:i + 1], P - 1) for i in range(len(seq))])
    res["noise"] = (alone - mesh_full_logits(params, cfg, seq, P - 1)).abs().max().item()
    # leaf by leaf, as phase 4 makes its f32 copies
    f32 = tree_from_flat({k.replace(".", "/"): v.float() for k, v in params.state_dict().items()})
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    anchor = []
    for t, lg in ((toks, logits), (rt, rl)):
        want = mesh_full_logits(f32, cfg32, torch.cat([prompt, t[:, :-1].to(dev)], dim=1), P - 1)
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


def path_launches(cfg, prefills, decode_steps, train_steps=0):
    """Kernel launches of ``prefills`` full forwards, ``decode_steps`` decode
    steps and ``train_steps`` forward-and-backward steps.

    Norms per layer: two pre-norms (dense, vlm, moe); the pre-norm and the
    SSM's out_norm over d_inner (ssm); the hybrid's two pre-norms of its
    parallel heads, the SSM's out_norm, the two output norms of the fusion
    and the FFN's pre-norm; then the final norm.  The audio family's full
    forward runs the encoder (two pre-norms a layer, its final norm, a
    non-causal flash attention a layer) and the decoder (three pre-norms a
    layer, the final norm, a causal flash attention a layer); its decode
    step the decoder's norms alone, and its cross-attention no kernel.  A
    training step runs each forward kernel once more and, in its backward:
    each norm's dx kernel (the warp route up to D 2048, the block route
    above) and dweight reduce; flash attention's dq and dk/dv kernels;
    moe_matmul's dbuf and dw kernels for each of its three products;
    ssd_intra_chunk's kernel and its reduce.  tests/test_torch_hybrid.py and
    tests/test_torch_backward.py hold these counts to the calls the model
    code makes.
    """
    from repro_torch.kernels.rmsnorm import BWD_WARP_MAX_DIM  # wider rows take the block route

    L, steps, full = cfg.num_layers, prefills + decode_steps + train_steps, prefills + train_steps
    ssm, moe, attn = cfg.family in SSM_FAMILIES, cfg.family == "moe", not cfg.attention_free
    if cfg.family == "audio":
        norms, decode_norms, flash = 2 * cfg.encoder_layers + 3 * L + 2, 3 * L + 1, cfg.encoder_layers + L
    else:
        norms = decode_norms = (6 if cfg.family == "hybrid" else 2) * L + 1
        flash = L if attn else 0
    inner = L if ssm else 0  # the out_norms over d_inner
    wide = ((inner if cfg.d_inner > BWD_WARP_MAX_DIM else 0)
            + (norms - inner if cfg.d_model > BWD_WARP_MAX_DIM else 0))
    return {
        "rmsnorm": norms * full + decode_norms * decode_steps,
        "rmsnorm_bwd": (norms - wide) * train_steps,
        "rmsnorm_bwd_wide": wide * train_steps,
        "rmsnorm_bwd_dweight": norms * train_steps,
        "flash_attention": flash * full,
        "flash_attention_bwd_dq": flash * train_steps,
        "flash_attention_bwd_dkdv": flash * train_steps,
        "moe_matmul": 3 * L * steps if moe else 0,
        "moe_matmul_bwd_dbuf": 3 * L * train_steps if moe else 0,
        "moe_matmul_bwd_dw": 3 * L * train_steps if moe else 0,
        "ssd_intra_chunk": L * full if ssm else 0,
        "ssd_intra_chunk_bwd": L * train_steps if ssm else 0,
        "ssd_intra_chunk_bwd_reduce": L * train_steps if ssm else 0,
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
    from repro_torch.training.train_step import grads_of

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
    print(f"[build] {', '.join(_build.KERNELS)} built and loaded in "
          f"{time.perf_counter() - t0:.1f}s into {_build.BUILD_DIR}; backward entry points: "
          f"rmsnorm_bwd, rmsnorm_bwd_dweight, flash dq, dkdv, moe_matmul_bwd, "
          f"ssd_intra_chunk_bwd, ssd_intra_chunk_bwd_reduce")

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
        err = assert_close(f"rmsnorm {T}x{D} {dt}", ops.rmsnorm_op(x, w), ref.rmsnorm_ref(x, w), tol)
        m = measure(lambda: ops.rmsnorm_op(x, w), lambda: ref.rmsnorm_ref(x, w),
                    lambda: F.rms_norm(x, (D,), w, 1e-5), rmsnorm_bound(T, D, x.element_size()))
        rms_rows[(T, D, dt)] = row(err, m)
        report(f"rmsnorm T={T} D={D} {str(dt)[6:]} {what}", err, tol, m, "F.rms_norm")
    decode_ms = rms_rows[(4, 960, torch.bfloat16)]["ms"]
    print(f"[kernel] rmsnorm smollm decode [4, 960]: {decode_ms:.4f} ms, "
          f"{1e3 * (decode_ms - floor_ms):.2f} us above the launch floor [{card}]")

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
    flash_cases += [
        (4, 32, 8, 160, 64, True, torch.float32, ""),
        (4, 15, 5, 1024, 64, False, torch.float32, ""),
        (2, 8, 2, 1000, 128, True, torch.bfloat16, "ragged S, d=128"),
        (2, 8, 2, 1000, 128, False, torch.float32, "ragged S, d=128"),
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
    del q, k, v, qs, ks, vs, got, want

    moe_rows = {}
    moe_cases = [  # (E, C, D, F, dtype, what): granite's experts at its three capacities
        (40, 128, 1536, 512, torch.bfloat16, "granite prefill gate/up"),
        (40, 128, 512, 1536, torch.bfloat16, "granite prefill down"),
        (40, 8, 1536, 512, torch.bfloat16, "granite decode gate/up"),
        (40, 8, 512, 1536, torch.bfloat16, "granite decode down"),
        (40, 384, 1536, 512, torch.bfloat16, "granite score gate/up"),
        (40, 384, 512, 1536, torch.bfloat16, "granite score down"),
        *lm_moe_cases,
        (40, 256, 1536, 512, torch.float32, "granite LM gate/up in f32 (fma route)"),
        (40, 1024, 1536, 512, torch.bfloat16, "longer"),
        (40, 384, 1536, 512, torch.float32, ""),
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
        print(f"[kernel]   launch plan: route {plan.route}, {plan.heads_per_block} heads per y "
              f"block, {plan.y_blocks} y and {plan.state_blocks} state blocks per chunk, grid "
              f"{plan.grid}, {plan.threads} threads, {plan.smem_bytes} bytes of shared memory")
    del x, b, c, cum, y, st, y_ref, st_ref
    torch.cuda.empty_cache()

    print(f"[time] phase 3 done at {time.perf_counter() - t_start:.1f}s")

    # every (kernel, shape) that a guarded run launches must be one that phase 3 (or, for the
    # backward kernels, phase 5) held against its plain version
    checked_shapes = {
        "flash_attention": {c[:7] for c in flash_cases},
        "rmsnorm": {c[:3] for c in rms_cases},
        "ssd_intra_chunk": {(B * NC, H, Q, 64, N, dt) for B, NC, Q, H, N, dt, _ in ssd_cases},
    }
    forward_wrappers = kernel_wrappers()

    def assert_checked(label, shapes):
        hold_unchecked(label, shapes, checked_shapes, lambda k, key: hold_at_shape(k, key, dev, gen))

    # ---- 4. serving at full width -----------------------------------------
    launches = dict.fromkeys(ops.launch_counts(), 0)

    def check_counts(label, counts, expect):
        if counts != expect:
            raise AssertionError(f"{label} launches {counts}, expected {expect}")
        for k, v in counts.items():
            launches[k] += v

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
        # whisper's cross-attention (plain PyTorch) read from the trace: its profiler range
        profiled(f"generate {cfg.name}", lambda: server.engine.generate(batch), card,
                 ranges=(CROSS_ATTENTION_RANGE,) if cfg.family == "audio" else ())
        marks.append(time.perf_counter())
        steps = [b - a for a, b in zip(marks, marks[1:])]
        print(f"[time] generate {cfg.name}: " + ", ".join(
            f"{what} {t:.1f}s" for what, t in zip(
                ("set-up", "two timed generations", "decode-vs-forward checks",
                 "prefill and step", "profiled generation"), steps)))

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
          f"absolute where the reference is 0)")
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
        (4, 32, 8, 160, 64, True, torch.float32, ""),
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
    moe_bwd_cases = [*lm_moe_cases,  # (E, C, D, F, dtype, what)
                     (40, 256, 1536, 512, torch.float32, "gate/up"),
                     (40, 256, 512, 1536, torch.float32, "down")]
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
                  f"{lp.tiles} tiles, {lp.smem_bytes} bytes of shared memory")
        del buf, w, dout, dbuf, dw, again, ref_out, want
    ssd_bwd_cases = [(B * NC, H, Q, 64, N, dt, what) for B, NC, Q, H, N, dt, what in lm_ssd_cases]
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
          f"calls ({len(flash_bwd_cases)} flash, {len(rms_bwd_cases)} rmsnorm, "
          f"{len(moe_bwd_cases)} moe_matmul, {len(ssd_bwd_cases)} ssd_intra_chunk shapes)")
    torch.cuda.empty_cache()

    print(f"[time] phase 5 done at {time.perf_counter() - t_start:.1f}s")

    # ---- 6. training at full width ------------------------------------------
    def count_run(label, fn, expect):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        check_counts(label, ops.launch_counts(), expect)
        return out

    def profiled_step(label, fn, ranges=()):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = wall_ms(fn)[1]  # the step's returned state is dropped at once: it holds new moments
        mem = torch.cuda.max_memory_allocated() / 2**30
        print(f"[train] {label}: one warm step {ms:.1f} ms wall, max_memory_allocated "
              f"{mem:.2f} GiB [{name}; {card}]")
        return profiled(label, fn, card, rows=14, ranges=ranges)

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
                             path_launches(pcfg, 0, 0, train_steps=1))
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
        path_launches(lm_cfg, 0, 0, train_steps=steps))
    lm_losses = [m["loss"] for m in lm_metrics]
    if not all(math.isfinite(x) for x in lm_losses):
        raise AssertionError(f"LM training: losses {lm_losses}")
    print(f"[train] lm {lm_cfg.name} full (L={lm_cfg.num_layers}) 4x256: losses "
          + ", ".join(f"{x:.4f}" for x in lm_losses)
          + f" (ln V = {math.log(lm_cfg.vocab_size):.4f}); grad_norm "
          + ", ".join(f"{m['grad_norm']:.3f}" for m in lm_metrics))
    lm_batch = next_batch(trainer)
    profiled_step(f"lm step {lm_cfg.name}",
                  lambda: trainer.step(trainer.state, lm_batch))
    del trainer, lm_batch
    torch.cuda.empty_cache()

    # the moe, ssm and hybrid families through the same launcher, every (kernel, shape) recorded
    checked_shapes.update(
        moe_matmul={c[:5] for c in moe_cases},
        flash_attention_bwd={c[:7] for c in flash_bwd_cases},
        rmsnorm_bwd={c[:3] for c in rms_bwd_cases},
        moe_matmul_bwd={c[:5] for c in moe_bwd_cases},
        ssd_intra_chunk_bwd={c[:6] for c in ssd_bwd_cases},
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
                                         path_launches(cfg, 0, 0, train_steps=3))
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
        profiled_step(f"lm step {arch}", lambda: trainer.step(trainer.state, lm_batch),
                      ranges=(CROSS_ATTENTION_RANGE,) if cfg.family == "audio" else ())
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
             path_launches(pcfg, 1, 0), path_launches(pcfg, 0, 0, train_steps=1))
    expect = {k: sum(part[k] for part in parts) for k in parts[0]}  # rollout, judges, old_logp, step
    loop_rng = np.random.default_rng(0)

    # every shape the loop gives a kernel must be one phases 3 and 5 held against its plain
    # version (checked_shapes holds the backward cases since phase 6)
    loop_shapes = set()
    print(f"[time] closed loop set up at {time.perf_counter() - t_start:.1f}s")
    step_walls = []
    shape_recorders = recording(loop_shapes, (
        (flash_k, "flash_attention", flash_key), (flash_k, "flash_attention_bwd", flash_key),
        (rms_k, "rmsnorm", rms_key), (rms_k, "rmsnorm_bwd", rms_key)))
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
    t10 = time.perf_counter()
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
        cfgs = {label: mesh_config(label, arch, dt, layers)
                for label, arch, _, dt, layers in MESH_SERVE + MESH_TRAIN}
        serve = [(label, seed, cfgs[label]) for label, _, seed, _, _ in MESH_SERVE]
        train_runs = [(label, seed, cfgs[label]) for label, _, seed, _, _ in MESH_TRAIN]
        ranks = run_ranks(mesh_rank, MESH_WORLD, (MESH_SHAPE, str(dev), serve, train_runs),
                          device=dev, timeout=900)
    except BaseException:
        dry.kill()
        dry.wait()
        raise
    print(f"[mesh] backend gloo (torch.distributed over tcp://localhost), DeviceMesh (data "
          f"{MESH_SHAPE[0]}, model {MESH_SHAPE[1]}) of {MESH_WORLD} ranks, every rank on cuda:0; "
          f"{time.perf_counter() - t10:.1f}s for the ranks' runs [{card}]")
    for r, res in enumerate(ranks):
        for what, counts in res["launches"].items():
            kind, label = what.split(" ", 1) if what.startswith("generate") else ("train", what[11:])
            cfg = cfgs[label]
            expect = path_launches(cfg, 0, 0, 1) if kind == "train" else path_launches(cfg, 1, MESH_NEW - 1)
            if counts != expect:
                raise AssertionError(f"[mesh] rank {r} {what}: launches {counts}, expected {expect}")
            for k, v in counts.items():
                launches[k] += v
        print(f"[mesh] rank {r}: peak memory " + ", ".join(
            f"{a} {g:.2f} GiB" for a, g in res["peak_gib"].items()) + "; walls (gloo on one card, "
            "collectives counted; not multi-card speed) " + ", ".join(
            f"{k} {v:.3f}s" for k, v in res["walls"].items()))
    print(f"[mesh] every rank's launches as path_launches gives them, per run: "
          + "; ".join(f"{k} {dict((n, c) for n, c in v.items() if c)}"
                      for k, v in ranks[0]["launches"].items()))
    for what, kinds in ranks[0]["collectives"].items():
        print(f"[mesh] rank 0 collectives of one {what}: " + ", ".join(
            f"{k} x{n} ({b / 2**20:.2f} MiB)" for k, (n, b) in kinds.items()))

    for label, seed, cfg in serve:
        api = build_model(cfg)
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev)
        prompt = mesh_batch(cfg, seed, (4, PROMPT)).to(dev)
        ref = Engine(api, params, GenerationConfig(max_new_tokens=MESH_NEW, cache_len=MESH_CACHE)
                     ).generate({"tokens": prompt})
        res = mesh_serve_errors(cfg, params, prompt, ranks[0][label], ref)
        tol = check_mesh_serve(label, cfg, res)
        extra = ""
        if "anchor" in res:
            extra = (f"; against the f32 forward of the same weights teacher-forced on each one's "
                     f"tokens: sharded {res['anchor'][0]:.3e}, unsharded {res['anchor'][1]:.3e} "
                     f"(limit {MESH_ANCHOR_RATIO}x the unsharded); the unsharded bf16 forward's "
                     f"own noise, batch 4 vs each row alone: {res['noise']:.3e}")
        print(f"[mesh] generate {label} (L={cfg.num_layers}, d {cfg.d_model}, {cfg.dtype}) "
              f"4x{PROMPT}+{MESH_NEW} on the mesh vs unsharded on the card: max abs logit err "
              f"{max(res['rows']):.3e} (abs tol {tol}) over {res['steps']} steps a row, each row "
              f"until its tokens part{extra}")
        del params, ref
        torch.cuda.empty_cache()
    for label, seed, cfg in train_runs:
        api = build_model(cfg)
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev, trainable=True)
        loss = api.loss_fn(params, {"tokens": mesh_batch(cfg, seed, MESH_TRAIN_SHAPE).to(dev)})[0]
        grads = grads_of(loss, params)
        got_loss, got_grads = ranks[0][f"train {label}"]
        e_loss = assert_close(f"[mesh] train {label} loss", torch.tensor(got_loss),
                              loss.detach().cpu(), MESH_GRAD_TOL, rel=False)
        e_grad = max(grad_err(f"[mesh] train {label} grad {k}", got_grads[k], g.cpu(),
                              MESH_GRAD_TOL)[1] or 0.0 for k, g in grads.items())
        print(f"[mesh] train step {label} f32 {MESH_TRAIN_SHAPE[0]}x{MESH_TRAIN_SHAPE[1]} on the "
              f"mesh vs unsharded on the card: loss err {e_loss:.2e}, grads err {e_grad:.2e} of "
              f"each leaf's largest magnitude (tol {MESH_GRAD_TOL})")
        del params, grads
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
    ]
    grpo_shape = (16, 15, 5, 160, 64, True, torch.bfloat16)
    for kname, key, src, of in (
        ("flash_attention_bwd_dq", grpo_shape, "flash_attention", "src/repro/kernels/flash_attention.py:72"),
        ("flash_attention_bwd_dkdv", grpo_shape, "flash_attention", "src/repro/kernels/flash_attention.py:72"),
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
    for k in kernels:
        k["pass"] = "backward" if "_bwd" in k["name"] else "forward"
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels the main path never launched: {idle}")
    print("[report] per-kernel numbers, bf16: forward at the score shapes, rmsnorm [1280, 2048] and "
          "flash B=8 H=32 KV=8 S=160 d=64 causal (llama3.2-1b), moe_matmul E=40 C=384 D=1536 "
          "F=512 (granite-moe-3b-a800m gate/up), ssd_intra_chunk BNC=8 H=24 Q=160 hd=64 N=128 "
          "(mamba2-130m); backward at the GRPO shape (smollm-360m, 16 x 160): flash B=16 H=15 "
          "KV=5 S=160 d=64 causal (plain and library: the gradient of the same inputs), rmsnorm "
          "[2560, 960]; at the LM shapes: the wide rmsnorm backward [1024, 3200] (hymba-1.5b's "
          "out_norm), moe_matmul's dbuf and dw E=40 C=256 D=1536 F=512 (granite gate/up; library "
          "torch.bmm), ssd_intra_chunk's backward and reduce BNC=4 H=24 Q=256 hd=64 N=128 "
          "(mamba2-130m 2 x 512); launches summed over the eight serving runs, the training runs, "
          "the closed loop's four steps (three plus the profiled one) and live mode's payloads")
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
