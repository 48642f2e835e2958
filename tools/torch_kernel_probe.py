#!/usr/bin/env python3
"""Probes of the port's kernels on one NVIDIA card.

    python3 tools/torch_kernel_probe.py time        # flash and ssd_intra_chunk vs plain and library
    python3 tools/torch_kernel_probe.py moe [--tree DIR]  # moe_matmul at granite's six shapes vs bmm
    python3 tools/torch_kernel_probe.py moe-parts   # moe_matmul with parts of its work taken out
    python3 tools/torch_kernel_probe.py bwd [--tree DIR]  # the backward pairs vs the library gradients
    python3 tools/torch_kernel_probe.py ssd-bwd [--tree DIR]  # ssd_intra_chunk's backward (B8) alone
    python3 tools/torch_kernel_probe.py ssd-sass    # static SASS counts of B8's two kernels
    python3 tools/torch_kernel_probe.py ssd-parts   # B8's main launch with parts taken out
    python3 tools/torch_kernel_probe.py bwd-parts   # the bf16 flash backward with parts taken out
    python3 tools/torch_kernel_probe.py moe-bwd-tiles  # moe_matmul's bf16 backward at each tile width
    python3 tools/torch_kernel_probe.py moe-bwd-fma    # its f32 dbuf at one and two blocks an SM
    python3 tools/torch_kernel_probe.py rms-parts      # the wide RMSNorm dx with parts taken out
    python3 tools/torch_kernel_probe.py ssd-roles   # ssd_intra_chunk's y and state blocks alone
    python3 tools/torch_kernel_probe.py ssm-check   # mamba2's bf16 decode-vs-forward reading
    python3 tools/torch_kernel_probe.py live-rate   # live mode's payload loop on 1 and 4 threads

``time`` checks each kernel against its plain version and times it as
``chip_smoke.py`` does (CUDA events behind a device sleep), at the serving
shapes and the long ones.  ``bwd`` does the same for the backward kernels
at ``chip_smoke.py`` phase 5's timed shapes: each kernel, each pair, and
the gradient of ``sdpa`` / ``F.rms_norm`` on the same inputs, then
``moe_matmul``'s dbuf and dw at granite-moe-3b-a800m's LM products (C 256;
gate/up and down; bf16 and f32) beside ``torch.bmm`` and the wide-row
RMSNorm dx at [1024, 3200] and [1024, 4096] (bf16 and f32) beside
``F.rms_norm``'s gradient, each the median of three taken in turns with
its library call, and last what ``ssd-bwd`` reads; with ``--tree DIR`` it
imports ``repro_torch`` from the checkout DIR instead (built into DIR's own
``build/``), so that one call can time two trees.
``ssd-bwd`` checks ``ssd_intra_chunk``'s backward against the plain
closed form, calls it twice for bit-identical gradients, and times its main
launch, its reduce and the two together at mamba2-130m's and hymba-1.5b's
LM shapes (four chunks of 256), bf16 and f32, the median of three taken in
turns (the main launch also without dstate), beside the plain version and
the bound; ``--tree`` as for ``bwd``.  ``ssd-sass`` counts the instructions
of the backward's kernels in the built library by opcode (``cuobjdump
-sass``): the loops are unrolled, so the counts stand for the work a block
issues.  ``ssd-parts`` builds variants of ``csrc/ssd_scan.cu`` into
``build/probe`` whose backward main kernel leaves out one part (the exp of
the decay, the G, dM or dx products, the row sums of P or the S tile sent
out) and times each beside the whole at the bf16 LM shapes, in turns; the
variants' gradients are wrong by design.  Two more variants take one head a
block (the plan's head group of one), at two and at three blocks an SM, one
takes three blocks an SM at two heads a block, and four time the reduce alone without its S tiles, its rows of B or C, its dbs
terms or its dcum.
``moe-bwd-tiles`` builds variants of ``csrc/moe_matmul.cu`` into
``build/probe`` whose bf16 backward takes one tile width (64, 128 or 256
columns) for every launch, and times dbuf and dw at granite's two LM
products at each width beside the plan's own choice, in turns.
``moe-bwd-fma`` builds variants of ``csrc/moe_matmul.cu`` whose f32
backward kernel states one or two blocks an SM as its launch bound (the
kernel as it is states none) and times them beside the kernel at granite's
f32 LM products, in turns, outputs compared bit for bit.
``rms-parts`` builds variants of ``csrc/rmsnorm.cu`` into ``build/probe``
whose ring-route dx kernel leaves out its dx stores, or its dweight
partials, or both, and times each beside the whole kernel at [1024, 3200]
and [1024, 4096], bf16 and f32, in turns; the variants' outputs are wrong
by design.
``moe`` checks ``moe_matmul`` against its plain version and times it
beside ``torch.bmm`` and its bound at granite-moe-3b-a800m's six bf16
shapes (gate/up and down at decode C = 8, prefill C = 128 and score
C = 384), calls it twice for bit-identical output; each time is the
median of three taken in turns with the others.  It also times the host:
microseconds per ``ops.moe_matmul_op`` call (and per ``torch.bmm``) while
200 calls queue behind a device sleep, so the host never waits for the
card, and per call of 1,000 back-to-back calls with one synchronisation
at the end, and where the tree's module has the parts, what a call's
pieces take alone.  ``--tree`` as for ``bwd`` (a tree whose module reports no
launch plan prints none).
``moe-parts`` builds variants of ``csrc/moe_matmul.cu`` into
``build/probe`` whose TMA routes leave out their products, their epilogue
(staging and stores), or the dependent launch, or whose ``wgmma`` route
takes the other tile width (128 columns for gate/up, 256 for down; its
output must equal the kernel's bit for bit), and times each beside the
whole kernel at the same six shapes, in turns; the variants' outputs are
wrong by design except the last two's.
``bwd-parts`` builds variants of ``csrc/flash_attention.cu`` into
``build/probe`` whose bf16 backward kernels leave out one part of their
work (the exp2, the register-A products dQ/dV/dK while keeping the P and
dS arithmetic that feeds them, or that arithmetic, by feeding the products
constant fragments) and times each beside the whole kernels; the variants'
gradients are wrong by design.
``ssd-roles`` builds two variants of ``csrc/ssd_scan.cu`` into
``build/probe``, one whose state blocks return at once and one whose y
blocks do, and times each beside the whole kernel.
``ssm-check`` reads ``chip_smoke.py``'s mamba2-130m bf16 check (last decode
step against a full forward, seeded weights) with the kernel, with the
plain version, and with the plain version's f32 outputs perturbed by
relative Gaussian noise before rounding, to show how far the reading moves
with changes far below bf16's precision.
``live-rate`` runs live mode's RMSNorm payload (f32 [64, 64], one CUDA
stream a pool, a launch and a stream wait an iteration) for 0.25 s on one
thread, then on four threads at once, each on its own stream, and prints
the iterations a second of each thread.  Run from the repository root.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TREE = Path(sys.argv[sys.argv.index("--tree") + 1]).resolve() if "--tree" in sys.argv else ROOT
sys.path[:0] = [str(TREE / "src"), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    BF16_TOL, GRAD_TOL, assert_close, cuda_ms, flash_bound, flash_bwd_bounds, grad_err, moe_bound,
    moe_bwd_bounds, rmsnorm_bwd_bounds, ssd_bound, ssd_bwd_bounds)
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


def time_backward(gen):
    """The backward kernels at chip_smoke.py phase 5's timed shapes, beside the library gradients."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk

    dev = gen.device
    print(f"[bwd] repro_torch from {Path(fk.__file__).resolve().parents[2]}")

    def leaves(dt, *shapes, scale=1.0):
        return [(torch.randn(*s, generator=gen, device=dev) * scale).to(dt).requires_grad_()
                for s in shapes]

    for B, Hq, KV, S, d, causal, dt in [
            (16, 15, 5, 160, 64, True, torch.bfloat16), (4, 32, 8, 256, 64, True, torch.bfloat16),
            (4, 32, 8, 1024, 64, True, torch.bfloat16), (4, 15, 5, 1024, 64, True, torch.bfloat16),
            (4, 32, 8, 2048, 64, True, torch.bfloat16), (4, 15, 5, 2048, 64, True, torch.bfloat16),
            (4, 32, 8, 2048, 64, False, torch.bfloat16), (4, 32, 8, 160, 64, True, torch.float32)]:
        q, k, v = leaves(dt, (B, Hq, S, d), (B, KV, S, d), (B, KV, S, d))
        dout = torch.randn(B, Hq, S, d, generator=gen, device=dev).to(dt)
        with torch.no_grad():
            out, lse = fk.flash_attention(q, k, v, causal=causal, lse=True)
        dq, delta = fk.flash_attention_bwd_dq(q, k, v, out, lse, dout, causal=causal)
        dk, dv = fk.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, causal=causal)
        want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, causal), (q, k, v), dout)
        errs = [grad_err(f"d{n}", a, b, GRAD_TOL[str(dt)[6:]]) for n, a, b in zip("qkv", (dq, dk, dv), want)]
        lib_out = F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
        ms_dq = cuda_ms(lambda: fk.flash_attention_bwd_dq(q, k, v, out, lse, dout, causal=causal))
        ms_dkdv = cuda_ms(lambda: fk.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, causal=causal))
        ms_pair = cuda_ms(lambda: fk.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal))
        lib = cuda_ms(lambda: torch.autograd.grad(lib_out, (q, k, v), dout, retain_graph=True))
        bounds = flash_bwd_bounds(B, Hq, KV, S, d, causal, q.element_size())
        print(f"[bwd] flash B{B} H{Hq} KV{KV} S{S} d{d} causal={causal} {str(dt)[6:]}: dq {ms_dq:.4f} "
              f"dkdv {ms_dkdv:.4f} pair {ms_pair:.4f} ms, sdpa grad q,k,v {lib:.4f} ms, bound "
              f"{bounds[2][0]:.4f} ms ({bounds[2][1]}); rel err "
              + ", ".join(f"{r:.2e}" if r is not None else f"{e:.1e} abs" for e, r in errs))
        del q, k, v, dout, out, lse, dq, delta, dk, dv, want, lib_out
    for T, D, dt in [(2560, 960, torch.bfloat16), (1024, 2048, torch.bfloat16), (1024, 2048, torch.float32)]:
        x = leaves(dt, (T, D), scale=3.0)[0]
        w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(dt).requires_grad_()
        dy = torch.randn(T, D, generator=gen, device=dev).to(dt)
        dx, part = rk.rmsnorm_bwd_dx(x, w, dy)
        dw = rk.rmsnorm_bwd_dweight(part, dt)
        want = torch.autograd.grad(ref.rmsnorm_ref(x, w), (x, w), dy)
        errs = [grad_err(n, a, b, GRAD_TOL[str(dt)[6:]]) for n, a, b in zip(("dx", "dw"), (dx, dw), want)]
        lib_out = F.rms_norm(x, (D,), w, 1e-5)
        ms_dx = cuda_ms(lambda: rk.rmsnorm_bwd_dx(x, w, dy))
        ms_dw = cuda_ms(lambda: rk.rmsnorm_bwd_dweight(part, dt))
        ms_pair = cuda_ms(lambda: rk.rmsnorm_bwd(x, w, dy))
        lib = cuda_ms(lambda: torch.autograd.grad(lib_out, (x, w), dy, retain_graph=True))
        bound = rmsnorm_bwd_bounds(T, D, x.element_size())[2]
        print(f"[bwd] rmsnorm [{T}, {D}] {str(dt)[6:]}: dx {ms_dx:.4f} dweight {ms_dw:.4f} pair "
              f"{ms_pair:.4f} ms, F.rms_norm grad x,w {lib:.4f} ms, bound {bound[0]:.4f} ms; rel err "
              + ", ".join(f"{r:.2e}" for _, r in errs))
    time_b7_b10(gen)


def medians(calls, rounds=3):
    """Median device ms of each call, taken in turns so that a slow spell hits all alike."""
    times = {k: [] for k in calls}
    for _ in range(rounds):
        for k, fn in calls.items():
            times[k].append(cuda_ms(fn))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


MOE_LM = [(40, 256, 1536, 512, "gate/up"), (40, 256, 512, 1536, "down")]  # granite's LM products


def time_b7_b10(gen):
    """moe_matmul's backward (B7) and the wide-row RMSNorm dx (B10) at the LM shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import moe_matmul as mk
    from repro_torch.kernels import rmsnorm as rk

    dev = gen.device
    for dt in (torch.bfloat16, torch.float32):
        for E, C, D, Fd, what in MOE_LM:
            buf = torch.randn(E, C, D, generator=gen, device=dev).to(dt)
            w = (torch.randn(E, D, Fd, generator=gen, device=dev) * 0.05).to(dt)
            dout = torch.randn(E, C, Fd, generator=gen, device=dev).to(dt)
            dbuf, dw = mk.moe_matmul_bwd(buf, w, dout)
            again = mk.moe_matmul_bwd(buf, w, dout)
            if not (torch.equal(dbuf, again[0]) and torch.equal(dw, again[1])):
                raise AssertionError(f"moe_matmul_bwd {what} {dt}: two calls differ")
            bl, wl = buf.clone().requires_grad_(), w.clone().requires_grad_()
            want = torch.autograd.grad(ref.moe_matmul_ref(bl, wl), (bl, wl), dout)
            errs = [grad_err(n, a, b, GRAD_TOL[str(dt)[6:]])
                    for n, a, b in zip(("dbuf", "dw"), (dbuf, dw), want)]
            ms = medians({"dbuf": lambda: mk.moe_matmul_bwd(buf, w, dout, dw=False),
                          "bmm dout w^T": lambda: torch.bmm(dout, w.transpose(1, 2)),
                          "dw": lambda: mk.moe_matmul_bwd(buf, w, dout, dbuf=False),
                          "bmm buf^T dout": lambda: torch.bmm(buf.transpose(1, 2), dout)})
            b_dbuf, b_dw, _ = moe_bwd_bounds(E, C, D, Fd, buf.element_size())
            print(f"[bwd] moe_matmul_bwd E{E} C{C} D{D} F{Fd} {what} {str(dt)[6:]}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f" ms; bounds {b_dbuf[0]:.4f} / {b_dw[0]:.4f} ms ({b_dbuf[1]}); rel err "
                  + ", ".join(f"{r:.2e}" for _, r in errs) + "; bit-identical")
            del buf, w, dout, dbuf, dw, again, bl, wl, want
        for T, D in ((1024, 3200), (1024, 4096)):
            x = (torch.randn(T, D, generator=gen, device=dev) * 3).to(dt)
            w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(dt)
            dy = torch.randn(T, D, generator=gen, device=dev).to(dt)
            got = rk.rmsnorm_bwd(x, w, dy)
            again = rk.rmsnorm_bwd(x, w, dy)
            if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                raise AssertionError(f"rmsnorm_bwd [{T}, {D}] {dt}: two calls differ")
            xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
            want = torch.autograd.grad(ref.rmsnorm_ref(xl, wl), (xl, wl), dy)
            errs = [grad_err(n, a, b, GRAD_TOL[str(dt)[6:]]) for n, a, b in zip(("dx", "dw"), got, want)]
            lib_out = F.rms_norm(xl, (D,), wl, 1e-5)
            ms = medians({"dx": lambda: rk.rmsnorm_bwd_dx(x, w, dy),
                          "pair": lambda: rk.rmsnorm_bwd(x, w, dy),
                          "F.rms_norm grad x,w": lambda: torch.autograd.grad(lib_out, (xl, wl), dy,
                                                                             retain_graph=True)})
            b_dx = rmsnorm_bwd_bounds(T, D, x.element_size())[0]
            print(f"[bwd] rmsnorm wide [{T}, {D}] {str(dt)[6:]}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f" ms; dx bound {b_dx[0]:.4f} ms ({100 * b_dx[0] / ms['dx']:.0f}% of it); plan "
                  f"{rk.bwd_plan(T, D, dt)}; rel err " + ", ".join(f"{r:.2e}" for _, r in errs)
                  + "; bit-identical")
            del x, w, dy, got, again, xl, wl, want, lib_out


SSD_LM = [(4, 24, 256, 64, 128, "mamba2 LM"), (4, 50, 256, 64, 16, "hymba LM")]  # BNC, H, Q, hd, N


def time_ssd_bwd(gen):
    """ssd_intra_chunk's backward (B8): main, reduce and both at the LM shapes, bf16 and f32."""
    dev = gen.device
    print(f"[ssd-bwd] repro_torch from {Path(ssd_scan.__file__).resolve().parents[2]}")
    for dt in (torch.bfloat16, torch.float32):
        for BNC, Hh, Q, hd, Ns, what in SSD_LM:
            x = (torch.randn(BNC, Hh, Q, hd, generator=gen, device=dev) * 0.5).to(dt)
            b, c = (torch.randn(BNC, Q, Ns, generator=gen, device=dev) * 0.5 for _ in range(2))
            cum = -torch.cumsum(0.1 * torch.rand(BNC, Hh, Q, generator=gen, device=dev), -1)
            dy = torch.randn(BNC, Hh, Q, hd, generator=gen, device=dev).to(dt)
            ds = torch.randn(BNC, Hh, hd, Ns, generator=gen, device=dev)
            args = (x, b, c, cum, dy, ds)
            got = ssd_scan.ssd_intra_chunk_bwd(*args)
            again = ssd_scan.ssd_intra_chunk_bwd(*args)
            if not all(torch.equal(p, q) for p, q in zip(got, again)):
                raise AssertionError(f"ssd_intra_chunk_bwd {what} {dt}: two calls differ")
            want = ref.ssd_intra_chunk_bwd_ref(*(t.double() for t in args))
            errs = [grad_err(f"ssd bwd {n} {what} {dt}", a.double(), w, GRAD_TOL[str(dt)[6:]])
                    for n, a, w in zip(("dx", "db", "dc", "dcum"), got, want)]
            parts = ssd_scan.ssd_intra_chunk_bwd_main(*args)[1]
            ms = medians({"main": lambda: ssd_scan.ssd_intra_chunk_bwd_main(*args),
                          "reduce": lambda: ssd_scan.ssd_intra_chunk_bwd_reduce(parts),
                          "both": lambda: ssd_scan.ssd_intra_chunk_bwd(*args),
                          "main without dstate": lambda: ssd_scan.ssd_intra_chunk_bwd_main(*args[:5])})
            plain = cuda_ms(lambda: ref.ssd_intra_chunk_bwd_ref(*args), iters=5)
            b_all = ssd_bwd_bounds(BNC, Hh, Q, hd, Ns, x.element_size())[2]
            print(f"[ssd-bwd] BNC{BNC} H{Hh} Q{Q} hd{hd} N{Ns} {str(dt)[6:]} {what}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f" ms; plain {plain:.4f} ms; bound {b_all[0]:.4f} ms ({b_all[1]}); rel err "
                  + ", ".join(f"{r:.2e}" for _, r in errs) + "; bit-identical")
            del x, b, c, cum, dy, ds, args, got, again, want, parts


def ssd_parts(gen):
    """B8's main launch with one part of its work taken out at a time, timed beside the whole."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    never = "if (N == 12345) "  # a guard the kernel never passes: the inputs stay computed
    parts = {
        "no exp": [("__expf(cqv.x - ck[hh][hr])", "(cqv.x - ck[hh][hr])"),
                   ("__expf(cqv.y - ck[hh][hr])", "(cqv.y - ck[hh][hr])")],
        "no G product": [("mma_pieces<P>(gt[2 * nj]", never + "mma_pieces<P>(gt[2 * nj]"),
                         ("mma_pieces<P>(gt[2 * nj + 1]", never + "mma_pieces<P>(gt[2 * nj + 1]")],
        "no dM product": [("mma_pieces<P>(dm[0], a, yb, 0)", never + "mma_pieces<P>(dm[0], a, yb, 0)"),
                          ("mma_pieces<P>(dm[1], a, yb, 1)", never + "mma_pieces<P>(dm[1], a, yb, 1)")],
        "no dx product": [("mma_pieces<P>(dxa[hh][2 * dn], am", never + "mma_pieces<P>(dxa[hh][2 * dn], am"),
                          ("mma_pieces<P>(dxa[hh][2 * dn + 1], am",
                           never + "mma_pieces<P>(dxa[hh][2 * dn + 1], am")],
        "no row sums of P out": [("if (!(g & 1) && q < Q) rowp[", "if (!(g & 1) && q == -1) rowp[")],
        "no S tile out": [("          *reinterpret_cast<float2*>(s_out + ",
                           "          if (N == 12345) *reinterpret_cast<float2*>(s_out + ")],
    }
    # and two variants with one head a block (bf16), at two and three blocks an SM
    one_head = [("template <> struct Route<bf16> { static constexpr int P = 2, PX = 1, kMaxHeads = 2; };",
                 "template <> struct Route<bf16> { static constexpr int P = 2, PX = 1, kMaxHeads = 1; };")]
    bounds = ("__global__ void __launch_bounds__(kThreads, 2)\nssd_bwd_main(",
              "__global__ void __launch_bounds__(kThreads, 3)\nssd_bwd_main(")
    parts.update({"three blocks an SM": [bounds], "one head a block": one_head,
                  "one head a block, three blocks an SM": one_head + [bounds]})
    # the reduce, timed alone, without one of its parts
    reduce_parts = {
        "reduce: no S tiles in": [("cp_async16(Sg + 4 * f, base",
                                   "if (N == 12345) cp_async16(Sg + 4 * f, base")],
        "reduce: no B or C rows in": [("if (g0 == 0) load_f32<kTeam>(to, vo, tid);",
                                       "if (g0 == 0 && N == 12345) load_f32<kTeam>(to, vo, tid);")],
        "reduce: no dbs terms": [("    if (role == 1 && dbs != nullptr) {",
                                  "    if (role == 1 && dbs != nullptr && N == 1) {")],
        "reduce: no dcum": [("  } else if (role == 1) {", "  } else if (role == 1 && N == 1) {")],
    }
    parts.update(reduce_parts)
    texts = {"whole": src}
    for label, subs in parts.items():
        text = src
        for a, b in subs:
            if text.count(a) != 1:
                raise RuntimeError(f"ssd_scan.cu no longer has the part {label!r} takes out: {a!r}")
            text = text.replace(a, b)
        texts[label] = text
    out_dir = ROOT / "build" / "probe" / "ssd_parts"
    jobs = {}
    for i, (label, text) in enumerate(texts.items()):
        vdir = out_dir / str(i)
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "ssd_scan.cu").write_text(text)
        (vdir / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
        _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
        jobs[label] = (vdir, _build._start("ssd_scan"))
    for label, (vdir, job) in jobs.items():
        if job is not None:
            with contextlib.redirect_stdout(io.StringIO()):  # ptxas -v reports
                _build._finish("ssd_scan", job)
    dev = gen.device
    for BNC, Hh, Q, hd, Ns, what in SSD_LM:
        x = (torch.randn(BNC, Hh, Q, hd, generator=gen, device=dev) * 0.5).bfloat16()
        b, c = (torch.randn(BNC, Q, Ns, generator=gen, device=dev) * 0.5 for _ in range(2))
        cum = -torch.cumsum(0.1 * torch.rand(BNC, Hh, Q, generator=gen, device=dev), -1)
        dy = torch.randn(BNC, Hh, Q, hd, generator=gen, device=dev).bfloat16()
        ds = torch.randn(BNC, Hh, hd, Ns, generator=gen, device=dev)
        calls = {}
        for label, (vdir, _) in jobs.items():
            _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
            _build._loaded.pop("ssd_scan", None)
            ssd_scan._bwd_entries.cache_clear()
            entries = ssd_scan._bwd_entries()

            plan = ssd_scan.bwd_plan(BNC, Hh, Q, hd, Ns, torch.bfloat16)
            if label.startswith("one head"):
                plan = dataclasses.replace(
                    plan, heads_per_block=1, groups=Hh, grid=(Hh, BNC, plan.row_tiles),
                    smem_bytes=2 * (2 * 2 * 64 * 72 + 2 * 64 * (hd + 8)) + 4 * 64,
                    scratch=(BNC, Hh) + plan.scratch[2:])

            def call(entries=entries, plan=plan):
                with _patched(ssd_scan, "_bwd_entries", lambda: entries), \
                        _patched(ssd_scan, "bwd_plan", lambda *a: plan):
                    return ssd_scan.ssd_intra_chunk_bwd_main(x, b, c, cum, dy, ds)[1]
            bwd_parts_ = call()
            calls[label] = call
            if label == "whole" or label in reduce_parts:
                def reduce(entries=entries, bwd_parts_=bwd_parts_):
                    with _patched(ssd_scan, "_bwd_entries", lambda: entries):
                        ssd_scan.ssd_intra_chunk_bwd_reduce(bwd_parts_)
                calls[("reduce", label)] = reduce
        ms = medians(calls)
        print(f"[ssd-parts] BNC{BNC} H{Hh} Q{Q} N{Ns} bf16 {what}, main launch: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items() if isinstance(k, str)
                          and k not in reduce_parts) + " ms")
        print(f"[ssd-parts] BNC{BNC} H{Hh} Q{Q} N{Ns} bf16 {what}, reduce launch: "
              + ", ".join(f"{k[1]} {v:.4f}" for k, v in ms.items() if isinstance(k, tuple)) + " ms")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def ssd_sass(gen):
    """Static instruction counts of ssd_scan's backward kernels, by opcode, from cuobjdump -sass."""
    import collections
    import re

    _build.build_all(["ssd_scan"])
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build._library_path("ssd_scan"))],
                          capture_output=True, text=True, check=True).stdout
    for body in sass.split("Function : ")[1:]:
        name = body.split("\n", 1)[0].strip()
        if "ssd_bwd" not in name:
            continue
        ops = collections.Counter(m.group(1).split(".")[0] for m in
                                  re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body))
        keep = ("HMMA", "LDSM", "LDS", "STS", "LDG", "STG", "LDGSTS", "LDL", "STL", "MUFU", "SHFL", "BAR",
                "FFMA", "FMUL", "FADD", "F2FP", "PRMT", "IMAD", "ISETP", "FSETP", "FSEL", "BRA")
        print(f"[ssd-sass] {name[:90]}: {sum(ops.values())} instructions; "
              + ", ".join(f"{k} {ops[k]}" for k in keep if ops[k]))


def _moe_variant_dirs(texts, name):
    """Build variants of moe_matmul.cu ({label: source}) into build/probe/<name>/<i>."""
    out_dir = ROOT / "build" / "probe" / name
    jobs = {}
    for i, (label, text) in enumerate(texts.items()):
        vdir = out_dir / str(i)
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "moe_matmul.cu").write_text(text)
        (vdir / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
        _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
        jobs[label] = (vdir, _build._start("moe_matmul"))
    for label, (vdir, job) in jobs.items():
        if job is not None:
            with contextlib.redirect_stdout(io.StringIO()):  # ptxas -v reports
                _build._finish("moe_matmul", job)
    return {label: vdir for label, (vdir, _) in jobs.items()}


def _use_moe_variant(mk, vdir):
    """Point moe_matmul's backward entry at the variant built into vdir."""
    _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
    _build._loaded.pop("moe_matmul", None)
    mk._bwd_entry.cache_clear()
    mk.bwd_plan.cache_clear()
    return mk._bwd_entry()


def moe_bwd_fma(gen):
    from repro_torch.kernels import moe_matmul as mk

    src = (_build.CSRC / "moe_matmul.cu").read_text()
    bounds = "__launch_bounds__(kFmaThreads)\nmoe_matmul_bwd_fma("
    if src.count(bounds) != 1:
        raise RuntimeError("moe_matmul.cu no longer has the launch bound this probe changes")
    stated = "__launch_bounds__(kFmaThreads, {})\nmoe_matmul_bwd_fma("
    dirs = _moe_variant_dirs({"as is": src, **{f"{n} block(s) an SM": src.replace(bounds, stated.format(n))
                                               for n in (1, 2)}}, "moe_bwd_fma")
    dev = gen.device
    for E, C, D, Fd, what in MOE_LM:
        buf = torch.randn(E, C, D, generator=gen, device=dev)
        w = torch.randn(E, D, Fd, generator=gen, device=dev) * 0.05
        dout = torch.randn(E, C, Fd, generator=gen, device=dev)
        calls, outs = {}, {}
        for label, vdir in dirs.items():
            _use_moe_variant(mk, vdir)
            for which in ("dbuf", "dw"):
                # bound to this variant's entry now: each call below launches its own library
                entry = mk._bwd_entry()
                lp = getattr(mk.bwd_plan(E, C, D, Fd, torch.float32), which)
                a, b = (buf, dout) if which == "dw" else (dout, w)
                out = torch.empty(*(w.shape if which == "dw" else buf.shape), device=dev)
                args = (int(which == "dw"), 0, mk._plan_args(lp), a.data_ptr(), b.data_ptr(),
                        out.data_ptr(), E, C, D, Fd, torch._C._cuda_getCurrentRawStream(dev.index or 0))

                def call(entry=entry, args=args):
                    err = entry(*args)
                    if err:
                        raise RuntimeError(f"moe_matmul_bwd f32 variant launch failed: error {err}")
                call()
                calls[(which, label)], outs[(which, label)] = call, out
        for which in ("dbuf", "dw"):
            ms = medians({label: calls[(which, label)] for label in dirs})
            same = all(torch.equal(outs[(which, label)], outs[(which, "as is")]) for label in dirs)
            print(f"[moe-bwd-fma] E{E} C{C} D{D} F{Fd} {what} f32 {which}: "
                  + ", ".join(f"{label} {v:.4f} ms" for label, v in ms.items())
                  + f"; bit-identical: {same}")
        del buf, w, dout, calls, outs


def rms_parts(gen):
    from repro_torch.kernels import rmsnorm as rk

    src = (_build.CSRC / "rmsnorm.cu").read_text()
    store = "      if (chunk(j) < nchunks) op[chunk(j)] = o;"
    part = "        part[(chunk(j) * VEC + e) / 4] ="
    if src.count(store) != 1 or src.count(part) != 1:
        raise RuntimeError("rmsnorm.cu no longer has the parts this probe takes out")
    no_store = ("      if (chunk(j) < nchunks && eps < 0.f) op[chunk(j)] = o;  // never: eps > 0")
    no_part = "        if (eps < 0.f) " + part.strip()
    variants = {"whole": src, "no dx stores": src.replace(store, no_store),
                "no partials": src.replace(part, no_part),
                "neither": src.replace(store, no_store).replace(part, no_part)}
    out_dir = ROOT / "build" / "probe" / "rms_parts"
    jobs = {}
    for i, (label, text) in enumerate(variants.items()):
        vdir = out_dir / str(i)
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "rmsnorm.cu").write_text(text)
        (vdir / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
        _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
        jobs[label] = (vdir, _build._start("rmsnorm"))
    for label, (vdir, job) in jobs.items():
        if job is not None:
            with contextlib.redirect_stdout(io.StringIO()):  # ptxas -v reports
                _build._finish("rmsnorm", job)
    dev = gen.device
    for dt in (torch.bfloat16, torch.float32):
        for T, D in ((1024, 3200), (1024, 4096)):
            x = (torch.randn(T, D, generator=gen, device=dev) * 3).to(dt)
            w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(dt)
            dy = torch.randn(T, D, generator=gen, device=dev).to(dt)
            calls = {}
            for label, (vdir, _) in jobs.items():
                _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
                _build._loaded.pop("rmsnorm", None)
                rk._entries.cache_clear()
                fn = rk._entries()[1]  # this variant's dx entry, bound now
                plan = rk.bwd_plan(T, D, dt)
                dx = torch.empty_like(x)
                parts = torch.empty(plan.blocks, D, device=dev)
                args = (rk.DTYPES[dt], x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                        parts.data_ptr(), T, D, x.stride(0), plan.rows_per_block, plan.blocks,
                        plan.smem_bytes, plan.threads, plan.stages, plan.ring_chunks, plan.teams,
                        1e-5, torch._C._cuda_getCurrentRawStream(dev.index or 0))

                def call(fn=fn, args=args, label=label):
                    err = fn(*args)
                    if err:
                        raise RuntimeError(f"rmsnorm_bwd {label} variant launch failed: error {err}")
                call()
                calls[label] = call
            ms = medians(calls)
            bound = rmsnorm_bwd_bounds(T, D, x.element_size())[0][0]
            print(f"[rms-parts] [{T}, {D}] {str(dt)[6:]} ({plan.route}, {plan.teams} teams, "
                  f"{plan.threads} threads, {plan.stages} stages): "
                  + ", ".join(f"{label} {v:.4f} ms" for label, v in ms.items())
                  + f"; bound {bound:.4f} ms")
    # the whole kernel by rows: one row a block (T <= 132) up to 16, against the library
    import torch.nn.functional as F

    _build.CSRC, _build.BUILD_DIR = jobs["whole"][0], jobs["whole"][0] / "lib"
    _build._loaded.pop("rmsnorm", None)
    rk._entries.cache_clear()
    for T in (128, 256, 512, 1024, 2048):
        x = (torch.randn(T, 3200, generator=gen, device=dev) * 3).bfloat16()
        w = (1 + 0.1 * torch.randn(3200, generator=gen, device=dev)).bfloat16()
        dy = torch.randn(T, 3200, generator=gen, device=dev).bfloat16()
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        lib_out = F.rms_norm(xl, (3200,), wl, 1e-5)
        ms = medians({"dx": lambda: rk.rmsnorm_bwd_dx(x, w, dy),
                      "F.rms_norm grad": lambda: torch.autograd.grad(lib_out, (xl, wl), dy,
                                                                     retain_graph=True)})
        print(f"[rms-parts] by rows: [{T}, 3200] bfloat16 ({rk.bwd_plan(T, 3200).rows_per_block} rows a "
              f"block): " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f"; dx bound {rmsnorm_bwd_bounds(T, 3200, 2)[0][0]:.4f} ms")


def moe_bwd_tiles(gen):
    from repro_torch.kernels import moe_matmul as mk

    src = (_build.CSRC / "moe_matmul.cu").read_text()
    head = "int bwd_tile_n(int64_t E, int64_t M, int64_t N, int64_t K) {"
    if src.count(head) != 1:
        raise RuntimeError("moe_matmul.cu no longer has the tile choice this probe forces")
    widths = (64, 128, 256)
    dirs = _moe_variant_dirs({bn: src.replace(head, head + f"\n  if (E > 0) return {bn};")
                              for bn in widths}, "moe_bwd_tiles")
    choose = mk._bwd_tile_n
    dev = gen.device
    data = {what: tuple(torch.randn(*s_, generator=gen, device=dev).bfloat16()
                        for s_ in ((E, C, D), (E, D, Fd), (E, C, Fd)))
            for E, C, D, Fd, what in MOE_LM}
    calls, outs = {}, {}
    for bn, vdir in dirs.items():
        mk._bwd_tile_n = lambda E, M, N, K, bn=bn: bn
        entry = _use_moe_variant(mk, vdir)  # bound now, to this variant's library
        for what, (buf, w, dout) in data.items():
            for which in ("dbuf", "dw"):
                lp = getattr(mk.bwd_plan(*buf.shape, w.shape[2], torch.bfloat16), which)
                a, b = (buf, dout) if which == "dw" else (dout, w)
                out = torch.empty(*(w.shape if which == "dw" else buf.shape), dtype=torch.bfloat16,
                                  device=dev)
                args = (int(which == "dw"), 1, mk._plan_args(lp), a.data_ptr(), b.data_ptr(),
                        out.data_ptr(), buf.shape[0], buf.shape[1], buf.shape[2], w.shape[2],
                        torch._C._cuda_getCurrentRawStream(dev.index or 0))

                def call(entry=entry, args=args, bn=bn):
                    err = entry(*args)
                    if err:
                        raise RuntimeError(f"moe_matmul_bwd tile {bn} launch failed: error {err}")
                call()
                calls[(what, which, bn)], outs[(what, which, bn)] = call, out
    mk._bwd_tile_n = choose
    for what, (buf, w, dout) in data.items():
        E, C, D = buf.shape
        Fd = w.shape[2]
        for which, (M, N, K) in (("dbuf", (C, D, Fd)), ("dw", (D, Fd, C))):
            ms = medians({bn: calls[(what, which, bn)] for bn in widths})
            same = all(torch.equal(outs[(what, which, bn)], outs[(what, which, 128)]) for bn in widths)
            print(f"[moe-bwd-tiles] E{E} C{C} D{D} F{Fd} {what} {which} (M {M} N {N} K {K}): "
                  + ", ".join(f"BN {bn} {v:.4f} ms" for bn, v in ms.items())
                  + f"; the plan takes BN {choose(E, M, N, K)}; widths bit-identical: {same}")
def host_us(fn, n=200, rounds=5):
    """Median host microseconds per call, the calls queued behind a device sleep."""
    fn()
    res = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)  # clock cycles: longer than the n calls take to enqueue
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        res.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return sorted(res)[len(res) // 2]


def back_to_back_us(fn, n=1000):
    """Wall microseconds per call of n calls in a row, one synchronisation at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def time_moe(gen, rounds=3):
    from repro_torch.kernels import moe_matmul as mk

    dev = gen.device
    print(f"[moe] repro_torch from {Path(mk.__file__).resolve().parents[2]}")
    for E, C, D, F, what in MOE_SHAPES:
        buf = torch.randn(E, C, D, generator=gen, device=dev).bfloat16()
        w = (torch.randn(E, D, F, generator=gen, device=dev) * 0.05).bfloat16()
        got = ops.moe_matmul_op(buf, w)
        err = assert_close(f"moe_matmul {E},{C},{D},{F}", got, ref.moe_matmul_ref(buf, w), BF16_TOL)
        if not torch.equal(ops.moe_matmul_op(buf, w), got):
            raise AssertionError(f"moe_matmul {E},{C},{D},{F}: two calls differ")
        plan = getattr(mk, "last_plan", None)  # the plan the calls above launched
        calls = {"kernel": lambda: ops.moe_matmul_op(buf, w), "bmm": lambda: torch.bmm(buf, w)}
        times = {k: [] for k in calls}
        for _ in range(rounds):  # in turns, so that a slow spell of the card hits all alike
            for k, fn in calls.items():
                times[k].append(cuda_ms(fn))
        ms = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        bnd = moe_bound(E, C, D, F, 2)[0]
        print(f"[moe] E{E} C{C} D{D} F{F} {what}: kernel {ms['kernel']:.4f} ms bmm {ms['bmm']:.4f} ms "
              f"bound {bnd:.4f} ms ({100 * bnd / ms['kernel']:.0f}% of bound), err {err:.2e}, "
              f"bit-identical; medians of {rounds} in turns; {plan}")
        print(f"[moe]   host us per call, queued behind a device sleep / 1000 back to back: "
              f"moe_matmul_op {host_us(calls['kernel']):.2f} / {back_to_back_us(calls['kernel']):.2f}, "
              f"bmm {host_us(calls['bmm']):.2f} / {back_to_back_us(calls['bmm']):.2f}")
        if hasattr(mk, "_launch"):  # where the host time of one call goes
            out, entry = torch.empty_like(got), mk._entry()
            refused = dataclasses.replace(plan, stages=plan.stages + 1)  # returns at the plan check
            parts = {"torch.empty": lambda: torch.empty((E, C, F), dtype=buf.dtype, device=dev),
                     "torch.cuda.current_stream()": lambda: torch.cuda.current_stream().cuda_stream,
                     "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index or 0),
                     "ctypes call refused at the plan check": lambda: mk._launch(entry, refused, buf, w, out),
                     "ctypes call that launches": lambda: mk._launch(entry, plan, buf, w, out),
                     "mk.moe_matmul": lambda: mk.moe_matmul(buf, w)}
            print("[moe]   host us per call, queued: " + ", ".join(
                f"{k} {host_us(fn):.2f}" for k, fn in parts.items()))
        del buf, w, got


def moe_parts(gen, rounds=3):
    from repro_torch.kernels import moe_matmul as mk

    src = (_build.CSRC / "moe_matmul.cu").read_text()
    products = ["wgmma_ss_n256<1>(acc, da, db, kt | kk);", "wgmma_ss_n128<1>(acc, da, db, kt | kk);",
                "wgmma_ss_n8_ta(acc, desc_mn(Wt, 64, 0, kk), desc_k(Xt, kTRows, 0, kk), kt | kk);"]
    epilogues = [("    if (c0 + wg * 64 >= C) continue;", "    if (c0 + wg * 64 >= C || C > 0) continue;"),
                 ("    unsigned char* st = sm + L::out + (stores++ & 1)",
                  "    if (C > 0) continue;\n    unsigned char* st = sm + L::out + (stores++ & 1)")]
    dependent = ("  err = hopper::launch_dependent(kKernel, dim3(p.grid_x), dim3(p.threads), p.smem, stream, ta, tw, to,\n"
                 "                                 E, C, D, F);")
    plain = "  kKernel<<<p.grid_x, p.threads, p.smem, stream>>>(ta, tw, to, E, C, D, F);\n  err = cudaSuccess;"
    width = "  const int bn = d > f ? 256 : 128;"
    if (any(src.count(x) != 1 for x in products) or any(src.count(a) != 1 for a, _ in epilogues)
            or src.count(dependent) != 1 or src.count(width) != 1):
        raise RuntimeError("moe_matmul.cu no longer has the parts this probe takes out")
    no_products = src
    for x in products:
        no_products = no_products.replace(x, "{ if (C < 0) " + x + " }")  # kept, never run
    no_epilogue = src
    for a, b in epilogues:
        no_epilogue = no_epilogue.replace(a, b)
    variants = {"whole": src, "no products": no_products, "no epilogue": no_epilogue,
                "no dependent launch": src.replace(dependent, plain),
                "other tile width": src.replace(width, "  const int bn = d > f ? 128 : 256;")}
    out_dir = ROOT / "build" / "probe" / "moe_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
    procs = {}
    for i, (name, text) in enumerate(variants.items()):
        cu, so = out_dir / f"moe_{i}.cu", out_dir / f"moe_{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    entries = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant: {proc.stderr.read().decode()}")
        lib = ctypes.CDLL(str(so))
        fn, err_fn = lib.moe_matmul_fwd, lib.moe_matmul_error_string
        fn.argtypes, fn.restype = mk._entry().argtypes, ctypes.c_int
        err_fn.argtypes, err_fn.restype = [ctypes.c_int], ctypes.c_char_p
        entries[name] = (fn, err_fn)
    dev = gen.device
    for E, C, D, F, what in MOE_SHAPES:
        buf = torch.randn(E, C, D, generator=gen, device=dev).bfloat16()
        w = (torch.randn(E, D, F, generator=gen, device=dev) * 0.05).bfloat16()
        out = torch.empty(E, C, F, dtype=buf.dtype, device=dev)
        plan = mk.launch_plan(E, C, D, F, torch.bfloat16)
        plans = dict.fromkeys(entries, plan)
        if plan.route == "wgmma":
            plans["other tile width"] = mk._tma_plan("wgmma", E, C, F, 384 - plan.block_n)
        else:  # the variant differs only on the wgmma route
            del plans["other tile width"]

        def call(name, out=out):
            fn, err_fn = entries[name]
            err = mk._launch(fn, plans[name], buf, w, out)
            if err:
                raise RuntimeError(f"moe_matmul {name} variant launch failed: {err_fn(err).decode()}")
        if plan.route == "wgmma":  # both widths sum each element in one order
            other = torch.empty_like(out)
            call("other tile width", other)
            if not torch.equal(other, ops.moe_matmul_op(buf, w)):
                raise AssertionError(f"moe_matmul E{E} C{C} D{D} F{F}: the other tile width differs")
        times = {name: [] for name in plans}
        for _ in range(rounds):
            for name in plans:
                times[name].append(cuda_ms(lambda name=name: call(name)))
        print(f"[moe-parts] E{E} C{C} D{D} F{F} {what} ({plan.route}): " + ", ".join(
            f"{name} {sorted(v)[len(v) // 2]:.4f} ms" for name, v in times.items()))
        del buf, w, out


def bwd_parts(gen):
    from repro_torch.kernels import flash_attention as fk

    src = (_build.CSRC / "flash_attention.cu").read_text()
    hdr = (_build.CSRC / "hopper.cuh").read_text()
    exp = "exp2_ftz(fmaf("
    products = ["wgmma_rs_n64<1>(acc[c], a[kk]", "wgmma_rs_n64<1>(dva[c], pa[kk]",
                "wgmma_rs_n64<1>(dka[c], sa[kk]"]
    frag = "  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);"
    if src.count(exp) != 2 or any(src.count(p) != 1 for p in products) or hdr.count(frag) != 1:
        raise RuntimeError("flash_attention.cu no longer has the parts this probe takes out")
    const = "  a[0] = a[1] = a[2] = a[3] = 0x3f803f80u;  // bf16 1.0 pairs\n  return;\n" + frag
    variants = {
        "whole": (src, hdr),
        "no exp2": (src.replace(exp, "(fmaf("), hdr),
        "no register-A products (P, dS still computed)": (_guard_all(src, products), hdr),
        "constant A fragments (no P, dS arithmetic)": (src, hdr.replace(frag, const)),
    }
    out_dir = ROOT / "build" / "probe" / "flash_parts"
    jobs = {}
    for i, (name, (text, header)) in enumerate(variants.items()):
        vdir = out_dir / str(i)
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "flash_attention.cu").write_text(text)
        (vdir / "hopper.cuh").write_text(header)
        _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
        jobs[name] = (vdir, _build._start("flash_attention"))
    for name, (vdir, job) in jobs.items():
        if job is not None:
            with contextlib.redirect_stdout(io.StringIO()):  # ptxas -v reports
                _build._finish("flash_attention", job)
    cases = [(16, 15, 5, 160, True), (4, 32, 8, 2048, True)]  # GRPO shape, long S
    data = {}
    for c in cases:
        B, Hq, KV, S, causal = c
        q, k, v, do = (torch.randn(B, h, S, 64, generator=gen, device=gen.device).bfloat16()
                       for h in (Hq, KV, KV, Hq))
        data[c] = (q, k, v, do)
    for name, (vdir, _) in jobs.items():
        _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
        _build._loaded.pop("flash_attention", None)
        fk._entries.cache_clear()
        row = []
        for c in cases:
            q, k, v, do = data[c]
            out, lse = fk.flash_attention(q, k, v, causal=c[4], lse=True)
            _, delta = fk.flash_attention_bwd_dq(q, k, v, out, lse, do, causal=c[4])
            ms_dq = cuda_ms(lambda: fk.flash_attention_bwd_dq(q, k, v, out, lse, do, causal=c[4]))
            ms_kv = cuda_ms(lambda: fk.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=c[4]))
            row.append(f"B{c[0]} H{c[1]} KV{c[2]} S{c[3]}: dq {ms_dq:.4f} dkdv {ms_kv:.4f} ms")
        print(f"[bwd-parts] {name}: " + "; ".join(row))


def _guard_all(src, products):
    """Skip each register-A product at run time (scale is never 12345), so the
    compiler keeps the P and dS arithmetic that feeds it."""
    for p in products:
        src = src.replace(p, "if (scale == 12345.f) " + p)
    return src


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


def live_rate(gen):
    """Live mode's payload loop: launch-and-wait iterations a second, one thread against four."""
    import threading

    from repro_torch.core.live import ensure_devices, kernel_payload_factory, warm_devices
    from repro_torch.core.scenarios import ActionTemplate

    streams = ensure_devices(4)
    warm_devices(streams)
    for n_threads in (1, len(streams)):
        payloads = kernel_payload_factory(streams, {f"p{k}": k for k in range(len(streams))})
        fns = [payloads(ActionTemplate(name="probe", rtype=f"p{k}", units=(1,), base_duration=0.25))
               for k in range(n_threads)]
        threads = [threading.Thread(target=fn) for fn in fns]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        print(f"[live-rate] {n_threads} thread(s) at once for 0.25 s: "
              f"{[payloads.launches[k] * 4 for k in range(n_threads)]} launch-and-wait iterations "
              f"a second a stream")


def main() -> int:
    modes = {"time": time_kernels, "moe": time_moe, "moe-parts": moe_parts, "bwd": time_backward,
             "ssd-bwd": time_ssd_bwd, "ssd-sass": ssd_sass, "ssd-parts": ssd_parts, "bwd-parts": bwd_parts, "ssd-roles": ssd_roles, "ssm-check": ssm_check,
             "moe-bwd-tiles": moe_bwd_tiles, "moe-bwd-fma": moe_bwd_fma, "rms-parts": rms_parts,
             "live-rate": live_rate}
    if len(sys.argv) not in (2, 4) or sys.argv[1] not in modes or (len(sys.argv) == 4 and sys.argv[2] != "--tree"):
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
    modes[sys.argv[1]](gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
