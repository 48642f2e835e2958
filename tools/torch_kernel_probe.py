#!/usr/bin/env python3
"""Probes of the port's flash and SSD kernels on one NVIDIA card.

    python3 tools/torch_kernel_probe.py time        # flash and ssd_intra_chunk vs plain and library
    python3 tools/torch_kernel_probe.py ssd-roles   # ssd_intra_chunk's y and state blocks alone
    python3 tools/torch_kernel_probe.py ssm-check   # mamba2's bf16 decode-vs-forward reading

``time`` checks each kernel against its plain version and times it as
``chip_smoke.py`` does (CUDA events behind a device sleep), at the serving
shapes and the long ones.  ``ssd-roles`` builds two variants of
``csrc/ssd_scan.cu`` into ``build/probe``, one whose state blocks return at
once and one whose y blocks do, and times each beside the whole kernel.
``ssm-check`` reads ``chip_smoke.py``'s mamba2-130m bf16 check (last decode
step against a full forward, seeded weights) with the kernel, with the
plain version, and with the plain version's f32 outputs perturbed by
relative Gaussian noise before rounding, to show how far the reading moves
with changes far below bf16's precision.  Run from the repository root.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import cuda_ms, flash_bound, ssd_bound  # noqa: E402
from repro_torch.kernels import _build, ops, ref, ssd_scan  # noqa: E402

H, HD, N = 24, 64, 128  # mamba2-130m


def ssd_inputs(gen, BNC, Q, dtype):
    dev = gen.device
    x = (torch.randn(BNC, H, Q, HD, generator=gen, device=dev) * 0.5).to(dtype)
    b = torch.randn(BNC, Q, N, generator=gen, device=dev) * 0.5
    c = torch.randn(BNC, Q, N, generator=gen, device=dev) * 0.5
    cum = -torch.cumsum(0.1 * torch.rand(BNC, H, Q, generator=gen, device=dev), dim=-1)
    return x, b, c, cum


def time_kernels(gen):
    import torch.nn.functional as F

    for B, Hq, KV, S, d, causal in [(8, 32, 8, 160, 64, True), (8, 24, 8, 160, 64, True),
                                    (4, 15, 5, 128, 64, True), (4, 32, 8, 2048, 64, True),
                                    (4, 32, 8, 2048, 64, False), (2, 8, 2, 1000, 128, True)]:
        q, k, v = (torch.randn(B, h, S, d, generator=gen, device=gen.device).bfloat16()
                   for h in (Hq, KV, KV))
        err = (ops.flash_attention_op(q, k, v, causal=causal).float()
               - ref.flash_attention_ref(q, k, v, causal).float()).abs().max().item()
        ms = cuda_ms(lambda: ops.flash_attention_op(q, k, v, causal=causal))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                              enable_gqa=True))
        print(f"flash B{B} H{Hq} KV{KV} S{S} d{d} causal={causal} bf16: err {err:.3e} kernel "
              f"{ms:.4f} ms sdpa {sdpa:.4f} ms bound {flash_bound(B, Hq, KV, S, d, causal, 2)[0]:.4f} ms")
    for BNC, Q, dt in [(4, 128, torch.bfloat16), (8, 160, torch.bfloat16), (16, 256, torch.bfloat16),
                       (8, 128, torch.float32), (6, 160, torch.float32), (16, 256, torch.float32)]:
        x, b, c, cum = ssd_inputs(gen, BNC, Q, dt)
        (y, st), (yr, sr) = ops.ssd_intra_chunk_op(x, b, c, cum), ref.ssd_intra_chunk_ref(x, b, c, cum)
        ms = cuda_ms(lambda: ops.ssd_intra_chunk_op(x, b, c, cum))
        print(f"ssd BNC{BNC} Q{Q} {str(dt)[6:]}: {ssd_scan.launch_plan(BNC, H, Q, HD, N, dt)} y err "
              f"{(y.float() - yr.float()).abs().max().item():.3e} state err "
              f"{(st - sr).abs().max().item():.3e} kernel {ms:.4f} ms bound "
              f"{ssd_bound(BNC, H, Q, HD, N, x.element_size())[0]:.4f} ms")


def ssd_roles(gen):
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    state_call, y_call = "    state_block<HD>(", "    y_block<HD>("
    if src.count(state_call) != 2 or src.count(y_call) != 2:
        raise RuntimeError("ssd_scan.cu no longer calls each block role once per route")
    variants = {"whole": src, "y blocks only": src.replace(state_call, "    if (0) state_block<HD>("),
                "state blocks only": src.replace(y_call, "    if (0) y_block<HD>(")}
    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    entries = {}
    for i, (name, text) in enumerate(variants.items()):
        cu, so = out_dir / f"ssd_{i}.cu", out_dir / f"ssd_{i}.so"
        cu.write_text(text)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                       capture_output=True)
        fn = ctypes.CDLL(str(so)).ssd_intra_chunk_fwd
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, i32, p, p, p, p, p, p, i32, i32, i32, i32, i32, i32, ctypes.c_int64, p]
        entries[name] = fn
    for BNC, Q, dt in [(4, 128, torch.bfloat16), (8, 160, torch.bfloat16), (16, 256, torch.bfloat16),
                       (8, 160, torch.float32), (16, 256, torch.float32)]:
        x, b, c, cum = ssd_inputs(gen, BNC, Q, dt)
        y, st = torch.empty_like(x), torch.empty(BNC, H, HD, N, device=x.device)
        plan = ssd_scan.launch_plan(BNC, H, Q, HD, N, dt)
        for name, fn in entries.items():
            def call(fn=fn):
                _build.check("ssd_scan", fn(ssd_scan.DTYPES[dt], HD, x.data_ptr(), b.data_ptr(),
                                            c.data_ptr(), cum.data_ptr(), y.data_ptr(), st.data_ptr(),
                                            BNC, H, Q, N, plan.heads_per_block, plan.grid[0],
                                            plan.smem_bytes, torch.cuda.current_stream().cuda_stream))
            print(f"ssd BNC{BNC} Q{Q} {str(dt)[6:]} {name}: {cuda_ms(call):.4f} ms")


def ssm_check(gen):
    from repro_torch.launch.serve import build_server
    from repro_torch.models.layers import logits_fn
    from repro_torch.models.transformer import arange_positions, embed_tokens, forward

    dev = gen.device
    server = build_server("mamba2-130m", requests=4, prompt_len=128, new=32, full=True, device=dev,
                          seed=4)  # chip_smoke.py's generate run
    cfg, params, prompts = server.cfg, server.engine.params, server.prompts

    def reading():
        out = server.engine.generate({"tokens": prompts})
        with torch.inference_mode():
            seq = torch.cat([prompts, out.tokens[:, :-1]], dim=1)
            h, _ = forward(params, embed_tokens(params, seq, cfg), arange_positions(*seq.shape, dev), cfg)
            full = logits_fn(params, h[:, -1:], cfg)[:, 0]
        return (out.logits[:, -1].float() - full.float()).abs().max().item()

    def perturbed_plain(noise, seed):
        g = torch.Generator(device=dev).manual_seed(seed)

        def fn(x, b, c, cum):
            y, st = ref.ssd_intra_chunk_ref(x.float(), b, c, cum)  # y in f32 before rounding
            if noise:
                y = y * (1 + noise * torch.randn(y.shape, generator=g, device=dev))
                st = st * (1 + noise * torch.randn(st.shape, generator=g, device=dev))
            return y.to(x.dtype), st
        return fn

    kernel = ops.ssd_intra_chunk_op
    print(f"mamba2-130m bf16 decode vs forward, kernel: max abs err {reading():.4f}")
    try:
        for noise, seeds in ((0.0, (0,)), (1e-5, (1, 2, 3)), (1e-6, (1, 2, 3))):
            for s in seeds:
                ops.ssd_intra_chunk_op = perturbed_plain(noise, s)
                print(f"  plain version, f32 y and state times (1 + {noise:g} N(0,1)), seed {s}: "
                      f"max abs err {reading():.4f}")
    finally:
        ops.ssd_intra_chunk_op = kernel


def main() -> int:
    if len(sys.argv) != 2 or sys.argv[1] not in ("time", "ssd-roles", "ssm-check"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[{sys.argv[1]}] {card}, torch {torch.__version__}")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    {"time": time_kernels, "ssd-roles": ssd_roles, "ssm-check": ssm_check}[sys.argv[1]](gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
