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
   could take;
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
5. agreement on a small input: the four reduced configs in f32 on the card
   against the same weights on the CPU (plain versions).

It prints one JSON line of per-kernel numbers, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits with code 2 before building anything.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): the bounds below use them.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

BF16_TOL = 2e-2
RMSNORM_F32_TOL = 1e-5
FLASH_F32_TOL = 2e-5
F32_TOL = 1e-4  # moe_matmul and ssd_intra_chunk in f32 (tests/test_kernels.py)
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
    kernels = {}  # name -> [device microseconds, count]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += e.duration_ns() / 1e3
            k[1] += 1
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


def path_launches(cfg, prefills, decode_steps):
    """Kernel launches of ``prefills`` full forwards and ``decode_steps`` decode steps."""
    L, steps = cfg.num_layers, prefills + decode_steps
    return {
        "rmsnorm": (2 * L + 1) * steps,  # two pre-norms (or pre-norm + SSM out_norm) + final
        "flash_attention": 0 if cfg.attention_free else L * prefills,
        "moe_matmul": 3 * L * steps if cfg.family == "moe" else 0,
        "ssd_intra_chunk": L * prefills if cfg.family == "ssm" else 0,
    }


def main() -> int:
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
    from repro_torch.launch.serve import build_server, timed_generate
    from repro_torch.models import build_model
    from repro_torch.models.convert import flat_from_params, params_from_flat
    from repro_torch.models.layers import logits_fn
    from repro_torch.models.transformer import arange_positions, embed_tokens, forward
    from repro_torch.serving.engine import Engine, GenerationConfig

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
        lib = f"{lib_name} {m['library_ms']:.4f} ms" if m["library_ms"] is not None else lib_name
        print(f"[kernel] {label}: err {err:.2e} (tol {tol}) kernel {m['ms']:.4f} ms (one call "
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
        (3, 70, 100, 36, torch.bfloat16, "ragged, unaligned rows"),
    ]
    for E, C, D, Fd, dt, what in moe_cases:
        buf = randn(E, C, D, dtype=dt)
        w = randn(E, D, Fd, dtype=dt) * 0.05
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        err = assert_close(f"moe_matmul {E},{C},{D},{Fd} {dt}", ops.moe_matmul_op(buf, w),
                           ref.moe_matmul_ref(buf, w), tol)
        m = measure(lambda: ops.moe_matmul_op(buf, w), lambda: ref.moe_matmul_ref(buf, w),
                    lambda: torch.bmm(buf, w), moe_bound(E, C, D, Fd, buf.element_size()))
        moe_rows[(E, C, D, Fd, dt)] = row(err, m)
        report(f"moe_matmul E={E} C={C} D={D} F={Fd} {str(dt)[6:]} {what}", err, tol, m, "bmm")
    del buf, w

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
                h = forward(check_params, embed_tokens(check_params, seq, check_cfg),
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

    # ---- 5. agreement with the CPU on a small input (reduced, f32) -------
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
    print("[report] per-kernel numbers at the score shapes, bf16: rmsnorm [1280, 2048] and flash "
          "B=8 H=32 KV=8 S=160 d=64 causal (llama3.2-1b), moe_matmul E=40 C=384 D=1536 F=512 "
          "(granite-moe-3b-a800m gate/up), ssd_intra_chunk BNC=8 H=24 Q=160 hd=64 N=128 "
          "(mamba2-130m); launches summed over the six serving runs")
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
