#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each of which raises on failure (nothing is caught):

1. environment: the card's name and power limit; TF32 off for f32 matmuls
   and convolutions;
2. build: the four CUDA kernels from ``src/repro_torch/kernels/csrc`` and
   an empty one-thread kernel (``launch_floor.cu``), one nvcc per source
   started together, for sm_90a, printing what ptxas reports;
3. kernels: the launch floor (the empty kernel's time, taken as the
   kernels' are); each kernel against its plain PyTorch version on the
   card, at the shapes the serving paths give it and at longer ones, with
   the kernel's, the plain version's and (where one PyTorch call computes
   the same function) a library call's times, and the least time the card
   could take; each ``moe_matmul`` case also with its launch plan (route,
   tiles, stages, grid, shared memory) and called twice for bit-identical
   output;
4. serving at full width on seeded random bf16 weights.  Each path runs
   with the launch counts set to 0 just before it and checked just after
   against the counts its depth implies: greedy generation (4 requests x
   (128 prompt + 32 new)) with ``smollm-360m``, ``granite-moe-3b-a800m``
   and ``mamba2-130m`` through ``repro_torch.launch.serve``, each with the
   last decode step's logits held against a full forward over the same
   tokens (granite on a copy of its config whose capacity drops nothing);
   scoring (8 x 160) with ``llama3.2-1b``, ``granite-moe-3b-a800m`` and
   ``mamba2-130m`` through ``Engine.score``; the wall time of one prefill
   and one decode step of each generating model, and ``torch.profiler``
   over one warm generation and one warm score call of each model (device
   busy share, device operations, the top kernels);
5. backward kernels: flash attention's dq and dk/dv kernels and RMSNorm's
   dx and dweight kernels against autograd through their plain versions,
   over a grid of types, head dims, masks, GQA groups and lengths (236
   cases), timed at the training paths' shapes and longer ones beside their
   bounds, the plain versions and the library's gradient (``sdpa``,
   ``F.rms_norm``), each timed pair called twice for bit-identical results;
6. training at full width on seeded random bf16 weights, with exact launch
   counts: GRPO (the paper's loop without the control plane:
   ``smollm-360m`` generates 4 prompts x group 4, 128 prompt + 32 sampled
   tokens; ``llama3.2-1b`` scores them; group advantages; three
   ``make_grpo_step`` steps), checking that the positive-advantage
   sequences gain log-probability over the negative ones; and LM training
   through ``repro_torch.launch.train`` (``llama3.2-1b``, 4 x 256, three
   steps); one warm step of each profiled;
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
8. agreement on a small input: the four reduced configs in f32 on the card
   against the same weights on the CPU (plain versions), serving and, for
   ``smollm-360m``, one GRPO and one LM step's loss and gradients.

It prints one JSON line of per-kernel numbers, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits with code 2 before building anything.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import json
import math
import subprocess
import sys
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
SERVE_BF16_LOGIT_TOL = {"dense": 0.1, "moe": 0.15, "ssm": 1.7}
SERVE_F32_LOGIT_TOL = 0.02
# Reduced configs, f32, card vs CPU: summation order only.
SMALL_F32_TOL = 1e-3

PROMPT, NEW = 128, 32  # generation: 4 requests x (128 prompt + 32 new tokens)
SCORE_SHAPE = (8, 160)
PROMPTS, GROUP, GRPO_STEPS = 4, 4, 3  # GRPO: 4 prompts x group 4, three steps
# the closed loop, as examples/agentic_rl_e2e.py runs it: 4 prompts x group 4,
# 8-token prompts, 16 new tokens (LiveGrpoDriver's GenerationConfig), three steps
LOOP_PROMPTS, LOOP_GROUP, LOOP_PROMPT, LOOP_NEW, LOOP_STEPS = 4, 4, 8, 16, 3
# its kernel shapes: the rollout's prefill [N, 8] and decode rows [N, 1]; each
# judge action scores one whole sequence [1, 24]; old_logp and the GRPO step
# run on the N whole sequences [N, 24]
LOOP_N, LOOP_SEQ = LOOP_PROMPTS * LOOP_GROUP, LOOP_PROMPT + LOOP_NEW
LM_ARGS = ["--arch", "llama3.2-1b", "--full", "--steps", "3", "--batch", "4", "--seq", "256"]


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
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += e.duration_ns() / 1e3
            k[1] += 1
    return kernels


def profiled(label, fn, card, rows=10):
    """One warm call of fn under torch.profiler: its device busy share and top kernels.

    Only device activity is traced, and the raw device events are summed by
    name: ``key_averages`` builds a Python object per event, which took
    20-25 s over the 47k-110k device operations of one generation.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, ms = wall_ms(fn)
    t1 = time.perf_counter()
    kernels = device_kernels(prof)
    print(f"[time] profile {label}: {t1 - t0 - ms / 1e3:.1f}s to stop the trace, "
          f"{time.perf_counter() - t1:.1f}s to sum it")
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    ops = sum(n for _, n in kernels.values())
    if ops == 0:
        raise AssertionError(f"[profile] {label}: the profiler saw no device operation")
    print(f"[profile] {label}: wall {ms:.2f} ms under the profiler; device busy {busy_ms:.2f} ms "
          f"= {100 * busy_ms / ms:.1f}% of wall; {ops} device operations [{card}]")
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


PORT_KERNEL_PREFIXES = ("rmsnorm", "flash_", "moe_matmul", "ssd_")


def path_launches(cfg, prefills, decode_steps, train_steps=0):
    """Kernel launches of ``prefills`` full forwards, ``decode_steps`` decode
    steps and ``train_steps`` forward-and-backward steps (dense family)."""
    L, steps = cfg.num_layers, prefills + decode_steps + train_steps
    norms = 2 * L + 1  # two pre-norms (or pre-norm + SSM out_norm) + final
    return {
        "rmsnorm": norms * steps,
        "rmsnorm_bwd": norms * train_steps,
        "rmsnorm_bwd_dweight": norms * train_steps,
        "flash_attention": 0 if cfg.attention_free else L * (prefills + train_steps),
        "flash_attention_bwd_dq": L * train_steps,
        "flash_attention_bwd_dkdv": L * train_steps,
        "moe_matmul": 3 * L * steps if cfg.family == "moe" else 0,
        "ssd_intra_chunk": L * prefills if cfg.family == "ssm" else 0,
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
    from repro_torch.launch.serve import build_server, timed_generate
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.train import next_batch
    from repro_torch.models import build_model
    from repro_torch.models.convert import flat_from_params, params_from_flat
    from repro_torch.models.layers import logits_fn
    from repro_torch.models.transformer import arange_positions, embed_tokens, forward
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
    print(f"[build] {', '.join(_build.KERNELS)} built and loaded in "
          f"{time.perf_counter() - t0:.1f}s into {_build.BUILD_DIR}")

    print(f"[time] phase 2 done at {time.perf_counter() - t_start:.1f}s")

    # ---- 3. kernels vs plain versions -----------------------------------
    gen = torch.Generator(device=dev).manual_seed(1234)

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
        (1000, 2048, torch.bfloat16, ""),
        (1000, 960, torch.bfloat16, ""),
        (1000, 2048, torch.float32, ""),
        (1000, 960, torch.float32, ""),
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
    ssd_cases = [  # (B, NC, Q, dtype, what): mamba2-130m's H=24, hd=64, N=128; BNC = B*NC
        (4, 1, 128, torch.bfloat16, "mamba2 prefill"),
        (8, 1, 160, torch.bfloat16, "mamba2 score"),
        (2, 4, 128, torch.bfloat16, ""),
        (2, 3, 160, torch.bfloat16, ""),
        (4, 4, 256, torch.bfloat16, "4 x 1024 tokens"),
        (2, 4, 128, torch.float32, ""),
        (2, 3, 160, torch.float32, ""),
        (4, 4, 256, torch.float32, "4 x 1024 tokens"),
    ]
    H, hd, N = 24, 64, 128
    for B, NC, Q, dt, what in ssd_cases:
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
        ssd_rows[(BNC, Q, dt)] = row(err, m)
        report(f"ssd_intra_chunk B={B} NC={NC} Q={Q} H={H} hd={hd} N={N} {str(dt)[6:]} {what}",
               err, f"{tol} y, {F32_TOL} state", m, "no single PyTorch call computes it")
    del x, b, c, cum, y, st, y_ref, st_ref
    torch.cuda.empty_cache()

    print(f"[time] phase 3 done at {time.perf_counter() - t_start:.1f}s")

    # ---- 4. serving at full width -----------------------------------------
    launches = dict.fromkeys(ops.launch_counts(), 0)

    def check_counts(label, counts, expect):
        if counts != expect:
            raise AssertionError(f"{label} launches {counts}, expected {expect}")
        for k, v in counts.items():
            launches[k] += v

    def run_generate(arch, seed):
        """4 x (PROMPT + NEW) greedy at full width through the launcher's server."""
        marks = [time.perf_counter()]
        server = build_server(arch, requests=4, prompt_len=PROMPT, new=NEW, full=True,
                              device=dev, seed=seed)
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
        params, prompts = server.engine.params, server.prompts

        def last_step_error(check_cfg, check_params, tol, label):
            """Generate with check_cfg, then hold the last decode step against a full forward."""
            check = out
            if check_cfg is not cfg:
                engine = Engine(build_model(check_cfg), check_params, server.engine.gen)
                check = engine.generate({"tokens": prompts})
            with torch.inference_mode():
                seq = torch.cat([prompts, check.tokens[:, :-1]], dim=1)
                h, _ = forward(check_params, embed_tokens(check_params, seq, check_cfg),
                            arange_positions(*seq.shape, dev), check_cfg)
                full = logits_fn(check_params, h[:, -1:], check_cfg)[:, 0]
            last = check.logits[:, -1]
            err = assert_close(f"{cfg.name} decode vs forward logits, {label}", last, full, tol,
                               rel=False)
            differ = last.argmax(-1) != full.argmax(-1)
            if cfg.family != "ssm" and bool(differ.any()):
                raise AssertionError(f"{cfg.name}: decode and forward disagree on the argmax")
            # ssm in bf16: argmax may differ only where the forward's top two lie within 2 err
            top2 = full.topk(2, dim=-1).values
            if bool((differ & (top2[:, 0] - top2[:, 1] > 2 * err)).any()):
                raise AssertionError(f"{cfg.name}: decode and forward disagree on a clear argmax")
            return (f"{label}: max abs err {err:.3e} (abs tol {tol}, |logits| max "
                    f"{full.abs().max().item():.2f}), argmax agrees on {int((~differ).sum())}/4")

        if cfg.family == "moe":  # capacity C >= T: nothing is dropped in prefill, decode or forward
            nodrop = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
            checks = [last_step_error(nodrop, params, SERVE_BF16_LOGIT_TOL["moe"],
                                      "bf16, drop-free config copy")]
        else:
            checks = [last_step_error(cfg, params, SERVE_BF16_LOGIT_TOL[cfg.family], "bf16")]
        if cfg.family == "ssm":
            checks.append(last_step_error(dataclasses.replace(cfg, dtype="float32"),
                                          copy.deepcopy(params).float(), SERVE_F32_LOGIT_TOL,
                                          "f32 copy of the weights"))
        marks.append(time.perf_counter())
        print(f"[serve] generate {cfg.name} full (L={cfg.num_layers}) 4x{PROMPT}+{NEW}: launches "
              f"{counts}; last-step logits vs forward: {'; '.join(checks)}")
        print(f"[serve] generate {cfg.name} {4 * NEW / cold_s:.1f} tok/s first call ({cold_s:.3f}s), "
              f"{4 * NEW / warm_s:.1f} tok/s second call ({warm_s:.3f}s), "
              f"max_memory_allocated {mem:.2f} GiB [{name}; {card}]")
        # where the time of a warm generation goes
        api, batch = server.api, {"tokens": prompts}
        with torch.inference_mode():
            (logits, state), prefill_ms = wall_ms(
                lambda: api.prefill(params, batch, cache_len=PROMPT + NEW))
            _, step_ms = wall_ms(lambda: api.decode_step(params, state, logits.argmax(-1)[:, None]))
        print(f"[profile] generate {cfg.name}: prefill {prefill_ms:.2f} ms, one decode step "
              f"{step_ms:.2f} ms wall [{card}]")
        marks.append(time.perf_counter())
        profiled(f"generate {cfg.name}", lambda: server.engine.generate(batch), card)
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

    for arch, seed in (("smollm-360m", 0), ("granite-moe-3b-a800m", 3), ("mamba2-130m", 4)):
        run_generate(arch, seed)
        torch.cuda.empty_cache()
        print(f"[time] generate {arch} done at {time.perf_counter() - t_start:.1f}s")
    for arch, seed in (("llama3.2-1b", 1), ("granite-moe-3b-a800m", 5), ("mamba2-130m", 6)):
        run_score(arch, seed)
        torch.cuda.empty_cache()
        print(f"[time] score {arch} done at {time.perf_counter() - t_start:.1f}s")

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

    # GQA g and S (ragged and whole tiles), then S on either side of the 128-row and
    # 128-key tiles and of S = 256, where the bf16 plans go from one warpgroup to two
    grid = [(g, S) for g in (1, 3, 4, 5) for S in (1, 63, 65, 160, 1024)]
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
    rms_bwd_cases = [  # (T, D, dtype, what)
        (16 * 160, 960, torch.bfloat16, "smollm GRPO"),
        (LOOP_N * LOOP_SEQ, 960, torch.bfloat16, "closed loop GRPO"),
        (4 * 256, 2048, torch.bfloat16, "llama LM"),
        (4 * 256, 2048, torch.float32, ""),
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
        bwd_rows[("rmsnorm_bwd", T, D, dt)] = row(errs[0][0], m_dx)
        bwd_rows[("rmsnorm_bwd_dweight", T, D, dt)] = row(errs[1][0], m_dw)
        label = f"T={T} D={D} {str(dt)[6:]} {what}"
        report(f"rmsnorm bwd dx+partials {label}", errs[:1], tol, m_dx, "F.rms_norm grad x, w")
        report(f"rmsnorm bwd dweight reduce {label}", errs[1:], tol, m_dw, "torch.sum")
        report(f"rmsnorm bwd both {label}", errs, tol, m_all, "F.rms_norm grad x, w")
        del x, w, dy, part, dx, dw, again, ref_out, lib_out, want
    print(f"[bwd] determinism: every timed backward pair gave bit-identical gradients in two calls "
          f"({len(flash_bwd_cases)} flash, {len(rms_bwd_cases)} rmsnorm shapes)")
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

    def profiled_step(label, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, ms = wall_ms(fn)
        mem = torch.cuda.max_memory_allocated() / 2**30
        print(f"[train] {label}: one warm step {ms:.1f} ms wall, max_memory_allocated "
              f"{mem:.2f} GiB [{name}; {card}]")
        profiled(label, fn, card, rows=14)

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

    # every shape the loop gives a kernel must be one phases 3 and 5 held against its plain version
    def flash_key(q, k, v, *_, causal=True, **__):
        return (*q.shape[:2], k.shape[1], *q.shape[2:], causal, q.dtype)

    def rms_key(x, *_, **__):
        return (*x.shape, x.dtype)

    checked_shapes = {
        "flash_attention": {c[:7] for c in flash_cases},
        "flash_attention_bwd": {c[:7] for c in flash_bwd_cases},
        "rmsnorm": {c[:3] for c in rms_cases},
        "rmsnorm_bwd": {c[:3] for c in rms_bwd_cases},
    }
    loop_shapes = set()

    def recording(mod, fname, key):
        fn = getattr(mod, fname)

        def call(*a, **kw):
            loop_shapes.add((fname, key(*a, **kw)))
            return fn(*a, **kw)

        return mock.patch.object(mod, fname, call)

    print(f"[time] closed loop set up at {time.perf_counter() - t_start:.1f}s")
    step_walls = []
    shape_recorders = ExitStack()
    for mod, fname, key in ((flash_k, "flash_attention", flash_key),
                            (flash_k, "flash_attention_bwd", flash_key),
                            (rms_k, "rmsnorm", rms_key), (rms_k, "rmsnorm_bwd", rms_key)):
        shape_recorders.enter_context(recording(mod, fname, key))
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
    unchecked = sorted(str(s) for s in loop_shapes if s[1] not in checked_shapes[s[0]])
    if unchecked:
        raise AssertionError(f"closed loop: kernels launched at shapes no phase held against "
                             f"their plain versions: {unchecked}")
    print(f"[loop] all {len(loop_shapes)} (kernel, shape) pairs of the loop were held against "
          f"their plain versions in phases 3 and 5")
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

    # ---- 8. agreement with the CPU on a small input (reduced, f32) -------
    for arch in ("smollm-360m", "llama3.2-1b", "granite-moe-3b-a800m", "mamba2-130m"):
        cfg = get_config(arch).reduced()
        api = build_model(cfg)
        p_gpu = api.init(torch.Generator(device=dev).manual_seed(2), dev)
        p_cpu = params_from_flat(flat_from_params(p_gpu), cfg, "cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen, device=dev)
        g_cfg = GenerationConfig(max_new_tokens=6, cache_len=40)
        a = Engine(api, p_gpu, g_cfg).generate({"tokens": toks})
        b = Engine(api, p_cpu, g_cfg).generate({"tokens": toks.cpu()})
        e1 = assert_close(f"{cfg.name} generate logits card vs cpu", a.logits.cpu(), b.logits,
                          SMALL_F32_TOL)
        if not torch.equal(a.tokens.cpu(), b.tokens):
            raise AssertionError(f"{cfg.name}: greedy tokens differ between card and CPU")
        sa = Engine(api, p_gpu, g_cfg).score({"tokens": toks})
        sb = Engine(api, p_cpu, g_cfg).score({"tokens": toks.cpu()})
        e2 = assert_close(f"{cfg.name} score card vs cpu", sa.cpu(), sb, SMALL_F32_TOL)
        print(f"[small] {cfg.name} f32 card vs cpu: generate logits err {e1:.2e}, "
              f"tokens equal, score err {e2:.2e} (tol {SMALL_F32_TOL})")

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
        gg, gc = grads_of(lg, p_gpu), grads_of(lc, p_cpu)
        if ops.launch_counts()["flash_attention_bwd_dkdv"] != counts_before + cfg.num_layers:
            raise AssertionError(f"small {kind} step: the card's backward skipped the kernels")
        e_loss = assert_close(f"small {kind} loss", lg.detach().cpu(), lc.detach(), SMALL_F32_TOL)
        e_grad = max(grad_err(f"small {kind} grad {k}", gg[k].cpu(), gc[k], SMALL_F32_TOL)[1] or 0.0
                     for k in gc)
        print(f"[small] {cfg.name} f32 {kind} step card vs cpu: loss err {e_loss:.2e}, grads err "
              f"{e_grad:.2e} of each leaf's largest magnitude (tol {SMALL_F32_TOL})")

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
             **ssd_rows[(8, 160, torch.bfloat16)]),
    ]
    grpo_shape = (16, 15, 5, 160, 64, True, torch.bfloat16)
    for kname, key, src, of in (
        ("flash_attention_bwd_dq", grpo_shape, "flash_attention", "src/repro/kernels/flash_attention.py:72"),
        ("flash_attention_bwd_dkdv", grpo_shape, "flash_attention", "src/repro/kernels/flash_attention.py:72"),
        ("rmsnorm_bwd", (16 * 160, 960, torch.bfloat16), "rmsnorm", "src/repro/kernels/rmsnorm.py:19"),
        ("rmsnorm_bwd_dweight", (16 * 160, 960, torch.bfloat16), "rmsnorm", "src/repro/kernels/rmsnorm.py:19"),
    ):
        # the TPU kernel has no backward: "replaces" names the kernel whose gradient this is
        kernels.append(dict(name=kname, route="cuda", source=f"src/repro_torch/kernels/csrc/{src}.cu",
                            replaces=of, launches=launches[kname], **bwd_rows[(kname,) + key]))
    for k in kernels:
        k["pass"] = "backward" if "_bwd" in k["name"] else "forward"
    print("[report] per-kernel numbers, bf16: forward at the score shapes, rmsnorm [1280, 2048] and "
          "flash B=8 H=32 KV=8 S=160 d=64 causal (llama3.2-1b), moe_matmul E=40 C=384 D=1536 "
          "F=512 (granite-moe-3b-a800m gate/up), ssd_intra_chunk BNC=8 H=24 Q=160 hd=64 N=128 "
          "(mamba2-130m); backward at the GRPO shape (smollm-360m, 16 x 160): flash B=16 H=15 "
          "KV=5 S=160 d=64 causal (plain and library: the gradient of the same inputs), rmsnorm "
          "[2560, 960]; launches summed over the six serving runs, the training runs and the "
          "closed loop's four steps (three plus the profiled one)")
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
