#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each of which raises on failure (nothing is caught):

1. environment: the card's name and power limit; TF32 off for f32 matmuls
   and convolutions;
2. build: both CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a, printing what ptxas reports;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it and at longer ones, with the
   kernel's, the plain version's and a PyTorch library call's times;
4. serving at full width on seeded random bf16 weights: greedy generation
   with ``smollm-360m`` through ``repro_torch.launch.serve``, and scoring
   with ``llama3.2-1b`` through ``Engine.score``, with each kernel's launch
   count checked against the count the depth implies, and the last decode
   step's logits held against a full forward over the same tokens; then
   the wall time of one prefill and one decode step, and ``torch.profiler``
   over one warm generation and one warm score call (device busy share,
   device operations, the kernels that take the most device time);
5. agreement on a small input: the reduced configs in f32 on the card
   against the same weights on the CPU (plain versions).

It prints one JSON line of per-kernel numbers, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits with code 2 before building anything.
"""

from __future__ import annotations

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
# Full-width bf16 serving: decode (plain torch, softmax weights rounded to
# bf16 before P.V) and the full forward (flash kernel, P kept f32) round
# differently at every one of the 32 layers.  Logits of these random
# weights are at most ~3; an absolute error of 0.043 was seen on the card,
# and the limit is about twice that, with no relative part.
SERVE_BF16_LOGIT_TOL = 0.1
# Reduced configs, f32, card vs CPU: summation order only.
SMALL_F32_TOL = 1e-3


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


def rmsnorm_bound(T, D, elem):
    """(ms, by): read x and w once, write out once; ~4 f32 operations per element."""
    t_bytes = (2 * T * D + D) * elem / HBM_BYTES_PER_S
    t_ops = 4 * T * D / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_bound(B, H, KV, S, d, causal, elem):
    """(ms, by): q, k, v read once, out written once; 4*d operations per scored pair."""
    pairs = S * (S + 1) // 2 if causal else S * S
    t_bytes = (2 * B * H * S * d + 2 * B * KV * S * d) * elem / HBM_BYTES_PER_S
    peak = BF16_TENSOR_FLOPS if elem == 2 else F32_FLOPS
    t_ops = 4 * d * B * H * pairs / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
    """One warm call of fn under torch.profiler: its device busy share and top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, ms = wall_ms(fn)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    ops = sum(e.count for e in events)
    if ops == 0:
        raise AssertionError(f"[profile] {label}: the profiler saw no device operation")
    print(f"[profile] {label}: wall {ms:.2f} ms under the profiler; device busy {busy_ms:.2f} ms "
          f"= {100 * busy_ms / ms:.1f}% of wall; {ops} device operations [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:rows]:
        print(f"[profile] {label}   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
              f"{e.key[:90]}")


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

    # ---- 3. kernels vs plain versions -----------------------------------
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    rms_rows = {}
    rms_cases = [  # (T, D, dtype, what)
        (4 * 128, 960, torch.bfloat16, "smollm prefill"),
        (4, 960, torch.bfloat16, "smollm decode"),
        (8 * 160, 2048, torch.bfloat16, "llama score"),
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
        ms = cuda_ms(lambda: ops.rmsnorm_op(x, w))
        wall = call_ms(lambda: ops.rmsnorm_op(x, w))
        plain = cuda_ms(lambda: ref.rmsnorm_ref(x, w))
        lib = cuda_ms(lambda: F.rms_norm(x, (D,), w, 1e-5))
        bound, by = rmsnorm_bound(T, D, x.element_size())
        rms_rows[(T, D, dt)] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                                   bound_ms=bound, bound_by=by)
        print(f"[kernel] rmsnorm T={T} D={D} {str(dt)[6:]} {what}: err {err:.2e} (tol {tol}) "
              f"kernel {ms:.4f} ms (one call {wall:.4f} ms wall) plain {plain:.4f} ms "
              f"F.rms_norm {lib:.4f} ms bound {bound:.4f} ms ({by}) [{card}]")

    flash_rows = {}
    flash_cases = [  # (B, H, KV, S, d, causal, dtype, what)
        (4, 15, 5, 128, 64, True, torch.bfloat16, "smollm prefill"),
        (8, 32, 8, 160, 64, True, torch.bfloat16, "llama score"),
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
        ms = cuda_ms(lambda: ops.flash_attention_op(q, k, v, causal=causal))
        wall = call_ms(lambda: ops.flash_attention_op(q, k, v, causal=causal))
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal), iters=5)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                             enable_gqa=True))
        bound, by = flash_bound(B, H, KV, S, d, causal, q.element_size())
        flash_rows[(B, H, KV, S, d, causal, dt)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                                       library_ms=lib, bound_ms=bound, bound_by=by)
        print(f"[kernel] flash B={B} H={H} KV={KV} S={S} d={d} causal={causal} {str(dt)[6:]} "
              f"{what}: err {err:.2e} (tol {tol}) kernel {ms:.4f} ms (one call {wall:.4f} ms "
              f"wall) plain {plain:.4f} ms sdpa {lib:.4f} ms bound {bound:.4f} ms ({by}) [{card}]")
    del q, k, v, qs, ks, vs, got, want
    torch.cuda.empty_cache()

    # ---- 4. serving at full width -----------------------------------------
    launches = {"rmsnorm": 0, "flash_attention": 0}

    # generate: smollm-360m, 4 requests, prompt 128, 32 new tokens, greedy
    P, NEW = 128, 32
    server = build_server("smollm-360m", requests=4, prompt_len=P, new=NEW, full=True,
                          device=dev, seed=0)
    L = server.cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out, cold_s = timed_generate(server)
    counts = ops.launch_counts()
    expect = {"rmsnorm": (2 * L + 1) * NEW, "flash_attention": L}  # 1 prefill + NEW-1 steps
    if counts != expect:
        raise AssertionError(f"generate launches {counts}, expected {expect}")
    launches = {k: launches[k] + v for k, v in counts.items()}
    gen_mem = torch.cuda.max_memory_allocated() / 2**30
    if out.tokens.shape != (4, NEW) or not bool(torch.isfinite(out.logits).all()):
        raise AssertionError("generate: wrong shape or non-finite logits")
    _, warm_s = timed_generate(server)
    # the last decode step's logits vs a full forward over the same tokens
    with torch.inference_mode():
        seq = torch.cat([server.prompts, out.tokens[:, :-1]], dim=1)
        params = server.engine.params
        h = forward(params, embed_tokens(params, seq, server.cfg),
                    arange_positions(*seq.shape, dev), server.cfg)
        full = logits_fn(params, h[:, -1:], server.cfg)[:, 0]
    last = out.logits[:, -1]
    err = assert_close("decode vs forward logits", last, full, SERVE_BF16_LOGIT_TOL, rel=False)
    if not torch.equal(last.argmax(-1), full.argmax(-1)):
        raise AssertionError("decode and forward disagree on the argmax")
    print(f"[serve] generate {server.cfg.name} full (L={L}) 4x{P}+{NEW}: launches {counts}; "
          f"last-step logits vs forward max abs err {err:.3e} (abs tol {SERVE_BF16_LOGIT_TOL}, "
          f"|logits| max {full.abs().max().item():.2f}), argmax agrees")
    print(f"[serve] generate {4 * NEW / cold_s:.1f} tok/s first call ({cold_s:.3f}s), "
          f"{4 * NEW / warm_s:.1f} tok/s second call ({warm_s:.3f}s), "
          f"max_memory_allocated {gen_mem:.2f} GiB [{name}; {card}]")
    # where the time of a warm generation goes
    api, batch = server.api, {"tokens": server.prompts}
    with torch.inference_mode():
        (logits, state), prefill_ms = wall_ms(lambda: api.prefill(params, batch, cache_len=P + NEW))
        _, step_ms = wall_ms(lambda: api.decode_step(params, state, logits.argmax(-1)[:, None]))
    print(f"[profile] generate: prefill {prefill_ms:.2f} ms, one decode step {step_ms:.2f} ms "
          f"wall [{card}]")
    profiled("generate", lambda: server.engine.generate(batch), card)
    del server, out, params, h, full, last, seq, logits, state
    torch.cuda.empty_cache()

    # score: llama3.2-1b, 8 sequences of 160 tokens
    cfg = get_config("llama3.2-1b")
    api = build_model(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(1), dev)
    engine = Engine(api, params, GenerationConfig())
    toks = torch.randint(0, cfg.vocab_size, (8, 160), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    scores = engine.score({"tokens": toks})
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    L = cfg.num_layers
    expect = {"rmsnorm": 2 * L + 1, "flash_attention": L}
    if counts != expect:
        raise AssertionError(f"score launches {counts}, expected {expect}")
    launches = {k: launches[k] + v for k, v in counts.items()}
    score_mem = torch.cuda.max_memory_allocated() / 2**30
    if scores.shape != (8,) or not bool(torch.isfinite(scores).all()):
        raise AssertionError("score: wrong shape or non-finite")
    t0 = time.perf_counter()
    engine.score({"tokens": toks})
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"[serve] score {cfg.name} full (L={L}) 8x160: launches {counts}; "
          f"latency {cold_s * 1e3:.1f} ms first call, {warm_s * 1e3:.1f} ms second call, "
          f"max_memory_allocated {score_mem:.2f} GiB [{name}; {card}]")
    profiled("score", lambda: engine.score({"tokens": toks}), card)
    del engine, params, scores
    torch.cuda.empty_cache()

    # ---- 5. agreement with the CPU on a small input (reduced, f32) -------
    for arch in ("smollm-360m", "llama3.2-1b"):
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
    rms = rms_rows[(8 * 160, 2048, torch.bfloat16)]
    fl = flash_rows[(8, 32, 8, 160, 64, True, torch.bfloat16)]
    kernels = [
        dict(name="rmsnorm", route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:19", launches=launches["rmsnorm"], **rms),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:72",
             launches=launches["flash_attention"], **fl),
    ]
    print("[report] per-kernel numbers at the llama3.2-1b score shapes "
          "(rmsnorm [1280, 2048], flash B=8 H=32 KV=8 S=160 d=64 causal), bf16")
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
