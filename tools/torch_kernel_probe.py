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
    python3 tools/torch_kernel_probe.py rms-parts      # the wide RMSNorm dx with parts taken out
    python3 tools/torch_kernel_probe.py rms-fwd [--parent DIR]  # B1's forward vs the parent's, by plan
    python3 tools/torch_kernel_probe.py ssd-roles   # ssd_intra_chunk's y and state blocks alone
    python3 tools/torch_kernel_probe.py ssm-check   # mamba2's bf16 decode-vs-forward reading
    python3 tools/torch_kernel_probe.py live-rate   # live mode's payload loop on 1 and 4 threads
    python3 tools/torch_kernel_probe.py cross [--tree DIR]  # B11's forward at whisper's shapes
    python3 tools/torch_kernel_probe.py fwd-bounds  # B2's bf16 forward at two launch bounds
    python3 tools/torch_kernel_probe.py cross-parts  # B11's forward with parts taken out
    python3 tools/torch_kernel_probe.py cross-bwd [--tree DIR]  # B11's backward at whisper's LM shape
    python3 tools/torch_kernel_probe.py cross-bwd-parts  # B11's one-pass backward with parts taken out
    python3 tools/torch_kernel_probe.py f32-attn [--parent DIR]  # the f32 attention kernels vs the parent's
    python3 tools/torch_kernel_probe.py f32-sass    # static SASS counts of the f32 attention kernels
    python3 tools/torch_kernel_probe.py f32-dp      # the f32 backward's dP sum at 0, 1, 2, 4 k-steps
    python3 tools/torch_kernel_probe.py f32-lo      # the f32 split's lo truncated or rounded
    python3 tools/torch_kernel_probe.py f32-gemm [--parent DIR]  # B3's and B4's f32 routes vs the parent's
    python3 tools/torch_kernel_probe.py f32-bwd [--parent DIR]  # B7's f32 route (dbuf, dw) vs the parent's

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
``rms-parts`` builds variants of ``csrc/rmsnorm.cu`` into ``build/probe``
whose ring-route dx kernel leaves out its dx stores, or its dweight
partials, or both, and times each beside the whole kernel at [1024, 3200]
and [1024, 4096], bf16 and f32, in turns; the variants' outputs are wrong
by design.
``rms-fwd`` times B1's forward (``rmsnorm``) at every shape of ``chip_smoke.py``
phase 3, the median of three rounds taken in turns: the kernel through its
plan, the parent's kernel (``--parent DIR``: a checkout of the parent commit,
whose ``csrc/rmsnorm.cu`` is built into ``build/probe/rms_fwd`` and called
through its own entry, a block of 128 threads per row), the warp route at the
plan's alternatives for warps a block and rows a warp (a variant built with
the entry's plan check off: 4, 8 and 16 warps a block, each on a grid of at
most one block an SM and with a row a warp), the warp route without its
programmatic dependent launch (a variant launched plainly, whose kernel does
not wait on the grid before it), ``F.rms_norm``, the plain version (timed
apart), the bound and the launch floor.  The kernel must hold against the plain version, and every
variant's output and the parent's must equal the kernel's bit for bit.  Then, at the decode rows, each
launch behind its predecessor in a decode layer (the residual add), with and
without the dependent launch.
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
the iterations a second of each thread.
``cross`` holds B11's forward (``flash_attention.cross_attention``) against
the plain version at whisper's prefill, LM and check shapes and the chip
phases' tails (bf16 and f32; out, and lse against the plain log-sum-exp),
calls it twice for bit-identical output, and times it at the prefill and
LM shapes and at whisper's encoder shape S = Sk = 1500 (a shape it is not
routed at) beside ``sdpa``, the plain version and the bound, each the
median of three in turns, with B11's backward pair and decode (which the
forward's redesign leaves as they are); where the tree's module has ``cross_plan`` it
prints each plan and times every split count the kernel
takes at the prefill and LM shapes through the entry point directly.
``--tree`` as for ``bwd``: run it on the parent and on this tree in turns.
``cross-parts`` builds variants of ``csrc/flash_attention.cu`` into
``build/probe`` whose B11 forward leaves out one part of its work (the K
and V loads after the ring's first fill, the exp2 of the softmax, the P V
products, or every key tile but a block's first: what is left is the
block's fixed cost), and one that launches a cluster at one split too, and
times each beside the whole kernel at whisper's prefill
and LM shapes, through the plan of ``cross_plan``, in turns; the variants'
outputs are wrong by design.
``fwd-bounds`` builds a variant of ``csrc/flash_attention.cu`` into
``build/probe`` whose bf16 forward template states no blocks an SM (the
kernel as it is states four at d = 64) and times B2's rows (llama score,
the d-128 score rows, S 2048) with each, in turns, outputs compared bit
for bit.
``f32-attn`` holds the f32 attention route (B2's forward, B5's dq and dkdv, and
B11's f32 forward and backward, which run them at keys of their own length)
at ``chip_smoke.py`` phase 3's f32 shapes, whisper's f32 encoder shape (B4 H16
S1500, non-causal) and its LM cross shape (B2 H16 S448 Sk1500): the forward
against the plain version (2e-5), the pair's gradients against autograd
through it (1e-4 of the largest) and bit-identical over two calls, and
``sdpa``'s f32 output and gradients against the same references; then it
times, the median of three rounds in turns, the forward, the pair and its dq
and dkdv launches apart, the parent's (``--parent DIR``: a checkout of the parent commit, whose
``csrc/flash_attention.cu`` is built into ``build/probe/f32_attn`` and run
through the parent's own module and plans), ``sdpa`` and autograd through it,
beside the plain versions and the bounds (the split-TF32 bound of
``chip_smoke.py`` and the CUDA-core FMA one), and names the CUDA kernels that
one f32 ``sdpa`` forward and backward launch under ``torch.profiler``.
``f32-sass`` counts the instructions of those kernels in the built library by
opcode, as ``ssd-sass`` does for B8.  ``f32-dp`` builds variants of the
f32 backward whose dP sums 0 (all), 1, 2 or 4 k-steps of products on the
tensor cores before each f32 add (``kDpGroup``), reads each where the
reference gradient is 0 (one key a row) and at S 2, and times each pair at
whisper's f32 encoder and LM cross shapes, in turns.  ``f32-lo`` builds a
variant whose split rounds lo to nearest (``kRoundLo``; the kernel leaves it
to the tensor cores' truncation) and holds and times it beside the kernel at
``f32-attn``'s shapes and at one key (the reference gradient 0), in turns.
``f32-gemm`` holds B3's and B4's f32 routes (``"tf32x3"``, ``"mma3"``) against
their plain versions at 1e-4, two calls bit-identical, at granite's f32 expert
products (LM gate/up and down, score, decode, a mesh rank's) and mamba2's and
hymba's chunk shapes (LM, score, a mesh rank's prefill), and times them, the
median of three rounds in turns, beside the parent's kernels (``--parent
DIR``, built into ``build/probe/f32_gemm`` and run through the parent's own
modules and plans), ``torch.bmm`` (B3), the bf16 route on the same values
and the f32 route at the other head count a y block (B4), with the
split-product and FMA-rate bounds; then ``moe_matmul``'s f32 route at 128 x 64
tiles and with parts of its stage loop taken out (variants built into
``build/probe``); then it counts each f32 kernel's SASS
instructions a tensor-core instruction (``cuobjdump -sass``) and times
``mma.sync``'s TF32 and bf16 rates in dense loops at 2-16 warps an SM.
``f32-bwd`` holds B7's f32 route (``"tf32x3"``: dbuf and dw on split TF32)
against the plain gradients at 1e-4 of each one's largest magnitude, two
calls bit-identical, at granite's LM gate/up and down (C 256), a phase 10
rank's reduced step and a ragged C, and times dbuf, dw and both, the median of
three rounds in turns, beside the parent's kernels (``--parent DIR``, built
into ``build/probe/f32_bwd/<DIR's name>``: its FMA tiles), ``torch.bmm`` and the
split-TF32 and FMA-rate bounds; the forward's f32 route too, beside the
parent's (bit for bit: the backward shares its loaders).  Then, in turns,
the backward with a grid of one block a tile instead of persistent blocks,
and without its wgmma (the loads and splits alone), its loads and splits
(the wgmma alone) or its stores: variants built into ``build/probe``.
Run from the repository root.
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
    BF16_TOL, FLASH_F32_TOL, GRAD_TOL, assert_close, cross_lse_err, cuda_ms, flash_bound,
    flash_bwd_bounds, grad_err, moe_bound, moe_bwd_bounds, rmsnorm_bwd_bounds, ssd_bound,
    ssd_bwd_bounds)
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
                                    (4, 15, 5, 128, 64, True), (8, 32, 8, 160, 128, True),
                                    (8, 32, 2, 160, 128, True), (4, 32, 8, 2048, 64, True),
                                    (4, 32, 8, 2048, 64, False), (2, 8, 2, 1000, 128, True),
                                    (4, 16, 16, 1500, 64, False)]:
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


# chip_smoke.py phase 3's B1 shapes (T, D, dtype): smollm prefill / decode, llama and granite score,
# the closed loop (decode, prefill, judge, GRPO), hymba's d 1600 and 3200 (prefill, decode, score,
# check; f32 checks), the LM rows, llama3-8b / glm4-9b score and decode, whisper's encoder,
# internvl's prefill, the plain checks and live mode's payload and warm-up
_bf, _f = torch.bfloat16, torch.float32
RMS_FWD_SHAPES = [
    (512, 960, _bf), (4, 960, _bf), (1280, 2048, _bf), (1280, 1536, _bf), (16, 960, _bf),
    (128, 960, _bf), (24, 2048, _bf), (384, 960, _bf),
    *[(T, D, dt) for D in (1600, 3200) for T, dt in ((512, _bf), (4, _bf), (1280, _bf), (636, _bf),
                                                    (512, _f), (4, _f), (636, _f))],
    (1024, 1536, _bf), (1024, 768, _bf), (1024, 1600, _bf), (1024, 3200, _bf),
    (1280, 4096, _bf), (4, 4096, _bf), (6000, 1024, _bf), (1536, 896, _bf),
    (1000, 2048, _bf), (1000, 960, _bf), (1000, 2048, _f), (1000, 960, _f), (64, 64, _f), (8, 64, _f),
]


def _rms_fwd_variants(parent):
    """Build the forward's probe variants of csrc/rmsnorm.cu (and the parent's source) into
    build/probe/rms_fwd/<i>; returns {label: loaded library}."""
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    check = "  if (warps != want_warps || rows_per_warp != want_rpw || blocks != want_blocks ||\n"
    waits = ("  hopper::grid_dependency_wait();  // x and w may be the previous kernel's outputs\n"
             "  hopper::launch_dependents();  // the next dependent grid may start, up to its own wait\n")
    launch = ("  return launch_dependent_fn(fn, dim3(static_cast<unsigned>(blocks)), dim3(32 * warps), "
              "args, stream);\n")
    if src.count(check) != 1 or src.count(waits) != 1 or src.count(launch) != 1:
        raise RuntimeError("rmsnorm.cu no longer has the parts this probe changes")
    free = src.replace(check, "  if (eps < 0.f && (warps != want_warps || rows_per_warp != want_rpw || "
                              "blocks != want_blocks) ||\n")
    plain = free.replace(waits, "").replace(launch, launch.replace(
        "launch_dependent_fn(fn, ", "cudaLaunchKernel(fn, ").replace("args, stream", "args, 0, stream"))
    texts = {"free plan": (free, _build.CSRC), "plain launch": (plain, _build.CSRC)}
    if parent is not None:
        pcsrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
        texts["parent"] = ((pcsrc / "rmsnorm.cu").read_text(), pcsrc)
    out_dir = ROOT / "build" / "probe" / "rms_fwd"
    home = (_build.CSRC, _build.BUILD_DIR)
    jobs = {}
    for i, (label, (text, csrc)) in enumerate(texts.items()):
        vdir = out_dir / str(i)
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "rmsnorm.cu").write_text(text)
        (vdir / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text())
        _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
        jobs[label] = (vdir, _build._start("rmsnorm"))
    libs = {}
    for label, (vdir, job) in jobs.items():
        _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
        if job is not None:
            with contextlib.redirect_stdout(io.StringIO()):  # ptxas -v reports
                _build._finish("rmsnorm", job)
        libs[label] = ctypes.CDLL(str(_build._library_path("rmsnorm")))
    _build.CSRC, _build.BUILD_DIR = home  # the tree's own kernels build where they always do
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    for label, lib in libs.items():
        lib.rmsnorm_fwd.restype = ctypes.c_int
        lib.rmsnorm_fwd.argtypes = ([i, p, p, p, i64, i64, i64, f, p] if label == "parent"
                                    else [i, p, p, p, i64, i64, i64, i, i64, i64, i, f, p])
    return libs


def _rms_alternatives(rk, T, D, dt):
    """(warps, rows a warp) of the warp route other than the plan's: 4, 8 and 16 warps a block
    (no more than the route takes), on a grid of at most one block an SM and a row a warp."""
    plan = rk.fwd_plan(T, D, dt)
    most = rk.fwd_warps(D, dt, plan.vec)
    alts = []
    for w in (4, 8, 16):
        if w > most:
            continue
        for rpw in (-(-T // (w * _build.NUM_SMS)), 1):
            if (w, rpw) != (plan.warps, plan.rows_per_warp) and (w, rpw) not in alts:
                alts.append((w, rpw))
    return alts


def rms_fwd(gen):
    import torch.nn.functional as F

    from chip_smoke import RMSNORM_F32_TOL, rmsnorm_bound
    from repro_torch.kernels import rmsnorm as rk

    parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve() if "--parent" in sys.argv else None
    libs = _rms_fwd_variants(parent)
    empty = _build.load("launch_floor").launch_floor_empty
    empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
    dev = gen.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
    floor_ms = cuda_ms(lambda: _build.check("launch_floor", empty(stream)))
    print(f"[rms-fwd] launch floor: one-thread empty kernel {floor_ms:.4f} ms")

    def call(lib, label, x, w, out, *plan_args):
        T, D = x.shape
        args = (rk.DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(), T, D, x.stride(0),
                *plan_args, 1e-5, stream)

        def fn():
            err = lib.rmsnorm_fwd(*args)
            if err:
                raise RuntimeError(f"rmsnorm_fwd {label} launch failed: error {err}")
        return fn

    for T, D, dt in RMS_FWD_SHAPES:
        x = (torch.randn(T, D, generator=gen, device=dev) * 3).to(dt)
        w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(dt)
        plan = rk.fwd_plan(T, D, dt)
        want = rk.rmsnorm(x, w)
        calls, outs = {"kernel": lambda: rk.rmsnorm(x, w)}, {}
        if "parent" in libs:
            outs["parent"] = torch.empty_like(x)
            calls["parent"] = call(libs["parent"], "parent", x, w, outs["parent"])
        if plan.route == "warp":
            for W, rpw in _rms_alternatives(rk, T, D, dt):
                label = f"{W} warps x {rpw} row(s)"
                outs[label] = torch.empty_like(x)
                calls[label] = call(libs["free plan"], label, x, w, outs[label], W, rpw,
                                    -(-T // (W * rpw)), plan.vec)
            outs["plain launch"] = torch.empty_like(x)
            calls["plain launch"] = call(libs["plain launch"], "plain launch", x, w, outs["plain launch"],
                                         plan.warps, plan.rows_per_warp, plan.blocks, plan.vec)
        calls["F.rms_norm"] = lambda: F.rms_norm(x, (D,), w, 1e-5)
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        assert_close(f"rmsnorm [{T}, {D}] {dt}", want, ref.rmsnorm_ref(x, w),
                     BF16_TOL if dt == torch.bfloat16 else RMSNORM_F32_TOL)
        for label, out in outs.items():
            if not torch.equal(out, want):
                raise AssertionError(f"rms-fwd [{T}, {D}] {dt}: {label}'s output differs from the kernel's")
        ms = medians(calls)
        ms["plain"] = cuda_ms(lambda: ref.rmsnorm_ref(x, w), iters=5)
        bnd = rmsnorm_bound(T, D, x.element_size())[0]
        print(f"[rms-fwd] [{T}, {D}] {str(dt)[6:]} plan {plan.route} {plan.blocks} x {plan.warps} warps x "
              f"{plan.rows_per_warp} row(s), vec {plan.vec}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f" ms; bound {bnd:.4f} ms ({100 * bnd / ms['kernel']:.1f}% of it), floor {floor_ms:.4f} ms"
              + (f"; parent / kernel {ms['parent'] / ms['kernel']:.3f}" if "parent" in ms else "")
              + "; every variant and the parent bit-identical to the kernel")
        del x, w, want, outs, calls
    # the decode rows behind their predecessor in a decode layer, the residual add: each pair timed
    for T, D in ((4, 960), (4, 4096)):
        h, a = (torch.randn(T, D, generator=gen, device=dev).bfloat16() for _ in range(2))
        w = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).bfloat16()
        plan = rk.fwd_plan(T, D, torch.bfloat16)
        out = torch.empty_like(h)
        s = torch.empty_like(h)
        pairs = {"add alone": lambda: torch.add(h, a, out=s),
                 "add + kernel": lambda: (torch.add(h, a, out=s), rk.rmsnorm(s, w))}
        if plan.route == "warp":
            nodep = call(libs["plain launch"], "plain launch", s, w, out, plan.warps,
                         plan.rows_per_warp, plan.blocks, plan.vec)
            pairs["add + plain launch"] = lambda: (torch.add(h, a, out=s), nodep())
        if "parent" in libs:
            par = call(libs["parent"], "parent", s, w, out)
            pairs["add + parent"] = lambda: (torch.add(h, a, out=s), par())
        ms = medians(pairs)
        print(f"[rms-fwd] decode layer [{T}, {D}] bf16, residual add then B1: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + " ms a pair")


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


CROSS_CHECKS = [(4, 16, 16, 128, 1500, 64), (2, 16, 16, 448, 1500, 64), (4, 16, 16, 159, 1500, 64),
                (1, 16, 16, 159, 1500, 64), (2, 4, 4, 1, 1500, 64), (2, 8, 2, 65, 63, 64),
                (2, 14, 2, 65, 1, 64), (2, 14, 2, 160, 1500, 64), (2, 8, 2, 100, 1500, 128),
                (2, 14, 2, 160, 1500, 128)]
CROSS_TIMED = [(4, 16, 16, 128, 1500, 64, "whisper prefill"), (2, 16, 16, 448, 1500, 64, "whisper LM"),
               (4, 16, 16, 1500, 1500, 64, "whisper encoder shape, not routed")]


def _cross_views(gen, B, Hq, KV, S, Sk, d, dt):
    """q, k, v in the model's layout: [B, S, H, d] and [B, Sk, KV, d] memory as views."""
    return [torch.randn(B, n, h, d, generator=gen, device=gen.device).to(dt).transpose(1, 2)
            for n, h in ((S, Hq), (Sk, KV), (Sk, KV))]


def _cross_plans(fk, B, Hq, KV, S, Sk, d):
    """Every bf16 plan the B11 kernel takes at a shape: 1-8 splits, none empty."""
    import dataclasses as dc

    out, key_tiles = [], -(-Sk // fk.cross_key_tile(d))
    base = fk.cross_plan(B, Hq, KV, S, Sk, d, torch.bfloat16)
    for splits in range(1, 9):
        tiles = -(-key_tiles // splits)
        if -(-key_tiles // tiles) == splits:
            out.append(dc.replace(base, grid=(splits, *base.grid[1:]), splits=splits,
                                  chunk=base.block_k * tiles))
    return out


def _cross_call(entries, q, k, v, out, plan):
    """One launch of B11's entry (of the library ``entries`` binds) with a given plan, into out."""
    B, Hq, S, d = q.shape
    args = [1, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, B, Hq, k.shape[1],
            S, k.shape[2], *[s for t in (q, k, v, out) for s in t.stride()[:3]], 1.0 / d ** 0.5,
            plan.block_q, plan.splits, plan.chunk, *plan.grid, plan.smem_bytes,
            torch._C._cuda_getCurrentRawStream(q.device.index)]
    _build.check("flash_attention", entries[4](*args))


def time_cross(gen):
    """B11's forward: checks, in-turn times beside sdpa, and (this tree) every plan it takes."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fk

    print(f"[cross] repro_torch from {Path(fk.__file__).resolve().parents[2]}")
    has_plan = hasattr(fk, "cross_plan")
    for B, Hq, KV, S, Sk, d in CROSS_CHECKS:
        for dt in (torch.bfloat16, torch.float32):
            if dt == torch.float32 and (S, Sk) not in ((448, 1500), (65, 63)):
                continue
            q, k, v = _cross_views(gen, B, Hq, KV, S, Sk, d, dt)
            out, lse = fk.cross_attention(q, k, v, lse=True)
            again, lse2 = fk.cross_attention(q, k, v, lse=True)
            if not (torch.equal(out, again) and torch.equal(lse, lse2)):
                raise AssertionError(f"cross_attention B{B} H{Hq} S{S} Sk{Sk} d{d} {dt}: two calls differ")
            err = assert_close(f"cross B{B} H{Hq} KV{KV} S{S} Sk{Sk} d{d} {dt}", out,
                               ref.flash_attention_ref(q, k, v, False),
                               BF16_TOL if dt == torch.bfloat16 else FLASH_F32_TOL)
            lse_err = cross_lse_err(q, k, lse)
            plan = fk.cross_plan(B, Hq, KV, S, Sk, d, dt) if has_plan else None
            print(f"[cross] B{B} H{Hq} KV{KV} S{S} Sk{Sk} d{d} {str(dt)[6:]}: err {err:.2e}, lse rel err "
                  f"{lse_err:.2e}, two calls bit-identical"
                  + (f"; plan {plan.route} {plan.block_q} rows, {plan.splits} splits of {plan.chunk} "
                     f"keys, grid {plan.grid}, {plan.threads} threads, {plan.smem_bytes} B" if plan else ""))
    # B11's backward pair at the LM shape and its decode over [4, 1500, 1024] caches, which
    # this slice leaves as they are: in turns with the other tree's
    q, k, v = _cross_views(gen, 2, 16, 16, 448, 1500, 64, torch.bfloat16)
    dout = torch.randn_like(q)
    o, lse = fk.cross_attention(q, k, v, lse=True)
    qd = torch.randn(4, 1, 16, 64, generator=gen, device=gen.device).bfloat16().transpose(1, 2)
    kc, vc = (torch.randn(4, 1500, 1024, generator=gen, device=gen.device).bfloat16() for _ in range(2))
    ms = medians({"bwd": lambda: fk.cross_attention_bwd(q, k, v, o, lse, dout),
                  "decode": lambda: fk.flash_decode(qd, kc, vc, 1500)})
    print(f"[cross] B11 backward dq + dkdv B2 H16 S448 Sk1500: {ms['bwd']:.4f} ms; decode B4 H16 over "
          f"1500 keys: {ms['decode']:.4f} ms")
    del q, k, v, dout, o, lse, qd, kc, vc
    for B, Hq, KV, S, Sk, d, what in CROSS_TIMED:
        q, k, v = _cross_views(gen, B, Hq, KV, S, Sk, d, torch.bfloat16)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        ms = medians({"kernel": lambda: fk.cross_attention(q, k, v),
                      "sdpa": lambda: F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True)})
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, False), iters=5)
        bnd = flash_bound(B, Hq, KV, S, d, False, 2, Sk)
        print(f"[cross] B{B} H{Hq} KV{KV} S{S} Sk{Sk} d{d} bf16 {what}: kernel {ms['kernel']:.4f} ms, "
              f"sdpa {ms['sdpa']:.4f} ms, plain {plain:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        if not has_plan:
            continue
        want = ref.flash_attention_ref(q, k, v, False)
        calls = {}
        for plan in _cross_plans(fk, B, Hq, KV, S, Sk, d):
            out = torch.empty_like(q)
            _cross_call(fk._entries(), q, k, v, out, plan)
            assert_close(f"cross plan of {plan.splits} splits", out, want, BF16_TOL)
            calls[(plan.block_q, plan.splits)] = lambda out=out, plan=plan: _cross_call(fk._entries(), q, k, v, out, plan)
        ms = medians(calls)
        print(f"[cross]   every plan at {what} (splits: ms): "
              + ", ".join(f"{s} {t:.4f}" for (_, s), t in ms.items()))


CROSS_BWD_TIMED = [(2, 16, 16, 448, 1500, 64, "whisper LM"), (2, 14, 2, 448, 1500, 128, "g 7 d 128")]


def _cross_bwd_call(fk, q, k, v, o, lse, dout, plan, lib=None):
    """B11's backward, both launches, with a given plan (of the library ``lib``, a variant's
    build, or the tree's) -> (dq, dk, dv)."""
    lib = lib or _build.load("flash_attention")
    p, i, f, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
    st_fn, fn = lib.flash_attention_cross_bwd_stats, lib.flash_attention_cross_bwd
    st_fn.argtypes = [i] + [p] * 5 + [i, i, i, i] + [i64] * 6 + [i, p]
    fn.argtypes = [i] + [p] * 10 + [i, i, i, i, i, p, f, i, i, i, i, i, i64, p]
    st_fn.restype = fn.restype = i
    B, Hq, S, d = q.shape
    KV, stream = k.shape[1], torch._C._cuda_getCurrentRawStream(q.device.index)
    stats = torch.empty((2, B, Hq, fk.stats_row(S)), dtype=torch.float32, device=q.device)
    counters = torch.empty((B, KV, plan.splits), dtype=torch.int32, device=q.device)
    scratch = torch.empty((plan.splits, B, KV, plan.rows, d), dtype=torch.float32, device=q.device)
    _build.check("flash_attention", st_fn(d, o.data_ptr(), dout.data_ptr(), lse.data_ptr(), stats.data_ptr(),
                                          counters.data_ptr(), counters.numel(), B, Hq, S, *o.stride()[:3],
                                          *dout.stride()[:3], plan.stats_blocks, stream))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = fn(d, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), stats.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), counters.data_ptr(), B, Hq, KV, S, k.shape[2],
             fk._strides(q, k, v, dout, dout, dq, dk, dv), 1.0 / d ** 0.5, plan.rows,
             int(plan.region == "smem"), *plan.grid, plan.smem_bytes, stream)
    _build.check("flash_attention", err)
    return dq, dk, dv


def time_cross_bwd(gen):
    """B11's backward: checks, bits over two calls, in-turn times beside sdpa's whole
    backward and the five-product bound, and (where the tree has the one pass) its two
    launches apart and every split count the kernel takes at whisper's LM shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fk

    print(f"[cross-bwd] repro_torch from {Path(fk.__file__).resolve().parents[2]}")
    one_pass = hasattr(fk, "cross_bwd_plan")
    for B, Hq, KV, S, Sk, d, what in CROSS_BWD_TIMED:
        q, k, v = _cross_views(gen, B, Hq, KV, S, Sk, d, torch.bfloat16)
        dout = torch.randn(B, Hq, S, d, generator=gen, device=gen.device).bfloat16()
        o, lse = fk.cross_attention(q, k, v, lse=True)
        got = fk.cross_attention_bwd(q, k, v, o, lse, dout)
        again = fk.cross_attention_bwd(q, k, v, o, lse, dout)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"cross bwd {what}: two calls differ")
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ref.flash_attention_ref(*leaves, False), leaves, dout)
        errs = [grad_err(f"cross bwd d{n} {what}", a, b, GRAD_TOL["bfloat16"])
                for n, a, b in zip("qkv", got, want)]
        lib_leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_leaves, enable_gqa=True)
        calls = {"backward": lambda: fk.cross_attention_bwd(q, k, v, o, lse, dout),
                 "sdpa": lambda: torch.autograd.grad(lib_out, lib_leaves, dout, retain_graph=True)}
        if one_pass:
            stats, counters = fk.cross_attention_bwd_stats(q, k, v, o, lse, dout)
            calls["stats"] = lambda: fk.cross_attention_bwd_stats(q, k, v, o, lse, dout)
            calls["pass"] = lambda: fk.cross_attention_bwd_fused(q, k, v, dout, stats, counters)
        ms = medians(calls)
        bnd = flash_bwd_bounds(B, Hq, KV, S, d, False, 2, Sk)[2]
        plan = fk.cross_bwd_plan(B, Hq, KV, S, Sk, d) if one_pass else None
        print(f"[cross-bwd] B{B} H{Hq} KV{KV} S{S} Sk{Sk} d{d} bf16 {what}: "
              + ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items())
              + f", bound {bnd[0]:.4f} ms ({bnd[1]}); rel err "
              + ", ".join(f"{r:.2e}" for _, r in errs) + "; two calls bit-identical"
              + (f"; plan {plan.splits} splits, {plan.tiles_per_block} key tiles of "
                 f"{plan.block_k} a block, grid {plan.grid}, {plan.threads} threads, dQ partials "
                 f"in {plan.region}, {plan.smem_bytes} B" if plan else ""))
        if one_pass and what == "whisper LM":  # every split count the kernel takes
            calls = {}
            for n in range(1, min(8, plan.key_tiles) + 1):
                alt = dataclasses.replace(plan, splits=n, grid=(n, *plan.grid[1:]),
                                          tiles_per_block=-(-plan.key_tiles // n))
                out = _cross_bwd_call(fk, q, k, v, o, lse, dout, alt)
                for a, b in zip(out, want):
                    grad_err(f"cross bwd at {n} splits", a, b, GRAD_TOL["bfloat16"])
                calls[n] = lambda alt=alt: _cross_bwd_call(fk, q, k, v, o, lse, dout, alt)
            ms = medians(calls)
            print("[cross-bwd]   both launches at each split count (splits: ms): "
                  + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()))
        del q, k, v, dout, o, lse, got, again, want, lib_out, lib_leaves, leaves


def cross_bwd_parts(gen):
    """B11's one-pass backward rebuilt with one part of its work taken out, timed in turns
    with the whole at whisper's LM shape through its plan (outputs wrong by design)."""
    from repro_torch.kernels import flash_attention as fk

    src = (_build.CSRC / "flash_attention.cu").read_text()
    i0 = src.index("// ------------------------------------------------------ B11 bf16 backward --")
    i1 = src.index("}  // namespace xa", i0)
    xb = src[i0:i1]
    never = "if (scale_log2 == 12345.f) "  # a uniform branch the run never takes
    exp = "st[i] = exp2_ftz(fmaf(st[i], scale_log2, -((i & 1) ? lq[i >> 2].y : lq[i >> 2].x)));"
    sdp = ("    wgmma_fence();\n    wgmma_ss_n64_first<0>(st, ", "    wgmma_commit();\n  };\n")
    dv = "for (int c = 0; c < CH; ++c) wgmma_rs_n64<1>(dva[c]"
    dk = "for (int c = 0; c < CH; ++c) wgmma_rs_n64<1>(dka[c]"
    dq = ("        wgmma_fence();\n        wgmma_ss_n64_first<1, 1>(dqp", "        wgmma_commit();\n        wgmma_wait<0>();\n        fence_regs(dqp);")
    rmw = "            *reinterpret_cast<float2*>(fp + col) = x;\n"
    units = "S_pad = n_qt * 64, n_units = g_heads * n_qt;"
    loads = "          mbar_expect_tx(full + s, 2 * 64 * D * 2 + 2 * 64 * 4);\n"
    reduce = "      for (int i = threadIdx.x; i < nr * V4; i += NT) {"
    kv = "        mbar_expect_tx(kvfull, 2 * BK * D * 2);\n"  # in load_kv
    parts = (exp, dv, dk, rmw, units, loads, sdp[0], dq[0], reduce, kv)
    if any(xb.count(p) != 1 for p in parts):
        raise RuntimeError("flash_attention.cu no longer has the parts this probe takes out")

    def guard(text, span):  # the lines from span[0] up to span[1] under the never-taken branch
        a = text.index(span[0])
        b = text.index(span[1], a)
        return text[:a] + "    " + never + "{\n" + text[a:b] + "    }\n" + text[b:]

    variants = {"whole": xb, "no exp2": xb.replace(exp, exp.replace("exp2_ftz(", "(")),
                "no S^T, dP^T products": guard(xb, sdp),
                "no dV product": xb.replace(dv, "for (int c = 0; c < CH; ++c) " + never + "wgmma_rs_n64<1>(dva[c]"),
                "no dK product": xb.replace(dk, "for (int c = 0; c < CH; ++c) " + never + "wgmma_rs_n64<1>(dka[c]"),
                "no dQ product": guard(xb, dq),
                "no partial updates": xb.replace(rmw, "            " + never + rmw.lstrip()),
                "S^T, dP^T of one k-step": xb.replace(
                    "      wgmma_ss_n64<0>(st, desc_k(Ks, BK, wgi * 64, kk)", "      if (kk < 1) wgmma_ss_n64<0>(st, desc_k(Ks, BK, wgi * 64, kk)").replace(
                    "      wgmma_ss_n64<0>(dpt, desc_k(Vs, BK, wgi * 64, kk)", "      if (kk < 1) wgmma_ss_n64<0>(dpt, desc_k(Vs, BK, wgi * 64, kk)"),
                "dV, dK of one k-step": xb.replace(dv, "if (kk < 1) " + dv).replace(dk, "if (kk < 1) " + dk),
                "dQ of one k-step": xb.replace(
                    "          wgmma_ss_n64<1, 1>(dqp, desc_mn(dS, 64, 0, kk)", "          if (kk < 1) wgmma_ss_n64<1, 1>(dqp, desc_mn(dS, 64, 0, kk)"),
                "one unit a key tile": xb.replace(units, "S_pad = n_qt * 64, n_units = 1;"),
                "no Q/dO loads after the first fill": xb.replace(
                    loads, "          if (it >= ST) { mbar_arrive(full + s); continue; }\n" + loads),
                "no final sum": xb.replace(reduce, reduce.replace("i < nr * V4;", "i < nr * V4 && scale_log2 == 12345.f;")),
                "K/V loaded once": xb.replace(kv, "        if (js > 0) { mbar_arrive(kvfull); return; }\n" + kv),
                "no units": xb.replace(units, "S_pad = n_qt * 64, n_units = 0;"),
                "no units, no final sum": xb.replace(units, "S_pad = n_qt * 64, n_units = 0;").replace(
                    reduce, reduce.replace("i < nr * V4;", "i < nr * V4 && scale_log2 == 12345.f;")),
                "no dK, dV stores": xb.replace("          if (key < Sk)\n            *reinterpret_cast<uint4*>(out",
                                               "          if (key < 0)\n            *reinterpret_cast<uint4*>(out"),
                "one unit a key tile, no final sum": xb.replace(units, "S_pad = n_qt * 64, n_units = 1;").replace(
                    reduce, reduce.replace("i < nr * V4;", "i < nr * V4 && scale_log2 == 12345.f;"))}
    out_dir = ROOT / "build" / "probe" / "cross_bwd_parts"
    jobs = {}
    for i, (name, text) in enumerate(variants.items()):
        vdir = out_dir / str(i)
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "flash_attention.cu").write_text(src[:i0] + text + src[i1:])
        (vdir / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
        _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
        jobs[name] = (vdir, _build._start("flash_attention"))
    for name, (vdir, job) in jobs.items():
        if job is not None:
            with contextlib.redirect_stdout(io.StringIO()):  # ptxas -v reports
                _build._finish("flash_attention", job)
    B, Hq, KV, S, Sk, d, what = CROSS_BWD_TIMED[0]
    q, k, v = _cross_views(gen, B, Hq, KV, S, Sk, d, torch.bfloat16)
    dout = torch.randn(B, Hq, S, d, generator=gen, device=gen.device).bfloat16()
    o, lse = fk.cross_attention(q, k, v, lse=True)
    plan = fk.cross_bwd_plan(B, Hq, KV, S, Sk, d)
    calls = {}
    for name, (vdir, _) in jobs.items():
        _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
        _build._loaded.pop("flash_attention", None)
        lib = _build.load("flash_attention")
        calls[name] = lambda lib=lib: _cross_bwd_call(fk, q, k, v, o, lse, dout, plan, lib)
        calls[name]()
    ms = medians(calls)
    print(f"[cross-bwd-parts] B{B} H{Hq} KV{KV} S{S} Sk{Sk} d{d} {what}, {plan.splits} splits, both "
          f"launches: " + ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items()))


def cross_parts(gen):
    from repro_torch.kernels import flash_attention as fk

    src = (_build.CSRC / "flash_attention.cu").read_text()
    i0, i1 = src.index("namespace xa {"), src.index("}  // namespace xa")
    xa = src[i0:i1]
    loads = "        mbar_expect_tx(full + s, 2 * BK * D * 2);\n"
    exp = "          sc[i] = exp2_ftz(x);\n"
    pv = "wgmma_rs_n64<1>(acc[c], pa[kk], desc_mn(Vt, BK, c, kk));"
    tiles = "n_tiles = (min(Sk, k_lo + chunk) - k_lo + BK - 1) / BK;"
    attrs = "  cfg.numAttrs = grid.x > 1 ? 1 : 0;\n"
    launch = src[i1:]
    if any(xa.count(p) != 1 for p in (loads, exp, pv, tiles)) or launch.count(attrs) != 1:
        raise RuntimeError("flash_attention.cu no longer has the parts this probe takes out")
    # after the ring's first fill the producer only signals each stage: the tiles stay as they are
    no_loads = xa.replace(loads, "        if (it >= ST) { mbar_arrive(full + s); continue; }\n" + loads)
    variants = {"whole": xa, "no K/V loads after the first fill": no_loads,
                "no exp2": xa.replace(exp, "          sc[i] = x;\n"),
                "no P V products": xa.replace(pv, "if (scale_log2 == 12345.f) " + pv),
                "one key tile a block": xa.replace(tiles, "n_tiles = 1;")}
    out_dir = ROOT / "build" / "probe" / "cross_parts"
    jobs = {}
    sources = {name: src[:i0] + text + launch for name, text in variants.items()}
    sources["a cluster at one split too"] = src[:i1] + launch.replace(attrs, "  cfg.numAttrs = 1;\n")
    for i, (name, text) in enumerate(sources.items()):
        vdir = out_dir / str(i)
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "flash_attention.cu").write_text(text)
        (vdir / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
        _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
        jobs[name] = (vdir, _build._start("flash_attention"))
    for name, (vdir, job) in jobs.items():
        if job is not None:
            with contextlib.redirect_stdout(io.StringIO()):  # ptxas -v reports
                _build._finish("flash_attention", job)
    for B, Hq, KV, S, Sk, d, what in CROSS_TIMED[:2]:
        q, k, v = _cross_views(gen, B, Hq, KV, S, Sk, d, torch.bfloat16)
        plan = fk.cross_plan(B, Hq, KV, S, Sk, d, torch.bfloat16)
        calls = {}
        for name, (vdir, _) in jobs.items():
            _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
            _build._loaded.pop("flash_attention", None)
            fk._entries.cache_clear()
            out = torch.empty_like(q)
            calls[name] = lambda out=out, e=fk._entries(): _cross_call(e, q, k, v, out, plan)
            calls[name]()
        ms = medians(calls)
        print(f"[cross-parts] B{B} H{Hq} KV{KV} S{S} Sk{Sk} d{d} {what}, plan of {plan.splits} "
              f"splits: " + ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items()))


def fwd_bounds(gen):
    from repro_torch.kernels import flash_attention as fk

    src = (_build.CSRC / "flash_attention.cu").read_text()
    bound = "__launch_bounds__(kThreads, D == 64 ? 4 : 1)\nflash_fwd_bf16("
    if src.count(bound) != 1:
        raise RuntimeError("flash_attention.cu no longer has the launch bound this probe changes")
    variants = {"4 blocks an SM at d 64": src,
                "no blocks stated": src.replace(bound, "__launch_bounds__(kThreads)\nflash_fwd_bf16(")}
    out_dir = ROOT / "build" / "probe" / "fwd_bounds"
    jobs = {}
    for i, (name, text) in enumerate(variants.items()):
        vdir = out_dir / str(i)
        vdir.mkdir(parents=True, exist_ok=True)
        (vdir / "flash_attention.cu").write_text(text)
        (vdir / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
        _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
        jobs[name] = (vdir, _build._start("flash_attention"))
    for name, (vdir, job) in jobs.items():
        if job is not None:
            _build._finish("flash_attention", job)  # ptxas -v: each variant's registers and spills
    entries = {}
    for name, (vdir, _) in jobs.items():
        _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
        _build._loaded.pop("flash_attention", None)
        fk._entries.cache_clear()
        entries[name] = fk._entries()
    for B, Hq, KV, S, d in [(8, 32, 8, 160, 64), (8, 32, 8, 160, 128), (8, 32, 2, 160, 128),
                            (4, 32, 8, 2048, 64), (4, 16, 16, 1500, 64)]:
        causal = S != 1500
        q, k, v = (torch.randn(B, h, S, d, generator=gen, device=gen.device).bfloat16() for h in (Hq, KV, KV))
        calls, outs = {}, {}
        for name, ent in entries.items():
            out = torch.empty_like(q)
            plan = fk.launch_plan(B, Hq, S, d, torch.bfloat16)
            args = [1, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, B, Hq, KV, S, S,
                    *[s for t in (q, k, v, out) for s in t.stride()[:3]], 1.0 / d ** 0.5, int(causal),
                    *plan.grid, plan.smem_bytes, torch._C._cuda_getCurrentRawStream(q.device.index)]
            calls[name] = lambda ent=ent, args=args: _build.check("flash_attention", ent[0](*args))
            calls[name]()
            outs[name] = out
        ms = medians(calls)
        same = all(torch.equal(o, next(iter(outs.values()))) for o in outs.values())
        print(f"[fwd-bounds] flash B{B} H{Hq} KV{KV} S{S} d{d} causal={causal}: "
              + ", ".join(f"{n} {t:.4f} ms" for n, t in ms.items()) + f"; bit-identical: {same}")


F32_ATTN = [  # (B, H, KV, S, Sk, d, causal, what)
    (4, 32, 8, 160, 160, 64, True, "phase 3, llama's heads"),
    (4, 15, 5, 1024, 1024, 64, False, "phase 3, smollm's heads"),
    (2, 8, 2, 1000, 1000, 128, False, "phase 3, ragged S, d 128"),
    (4, 16, 16, 1500, 1500, 64, False, "whisper f32 encoder"),
    (2, 16, 16, 448, 1500, 64, False, "whisper LM cross-attention"),
]


def _kernel_module(name, kernel, cu_text, hopper_text, py_path):
    """A kernel module (the file ``py_path``) whose ``csrc/<kernel>.cu`` is ``cu_text``, built into
    build/probe/<name>."""
    return _kernel_modules({name: (kernel, cu_text, hopper_text, py_path)})[name]


def _kernel_modules(specs):
    """``_kernel_module`` for each {name: (kernel, cu_text, hopper_text, py_path)}, the nvcc
    builds run side by side."""
    import importlib.util
    import types

    jobs = {}
    home = (_build.CSRC, _build.BUILD_DIR)
    try:
        for name, (kernel, cu_text, hopper_text, _) in specs.items():
            vdir = ROOT / "build" / "probe" / name
            vdir.mkdir(parents=True, exist_ok=True)
            (vdir / f"{kernel}.cu").write_text(cu_text)
            (vdir / "hopper.cuh").write_text(hopper_text)
            _build.CSRC, _build.BUILD_DIR = vdir, vdir / "lib"
            jobs[name] = (_build._start(kernel), _build._library_path(kernel))
    finally:
        _build.CSRC, _build.BUILD_DIR = home
    mods = {}
    for name, (job, lib_path) in jobs.items():
        kernel, py_path = specs[name][0], specs[name][3]
        if job is not None:
            with contextlib.redirect_stdout(io.StringIO()):  # ptxas -v reports
                _build._finish(kernel, job)
        lib = ctypes.CDLL(str(lib_path))

        def check(what, err, name=name):
            if err:
                raise RuntimeError(f"{name}'s {what} launch failed: CUDA error {err}")

        spec = importlib.util.spec_from_file_location(f"probe_{name.replace('/', '_')}", py_path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod  # its dataclasses look their module up there
        spec.loader.exec_module(mod)
        mod._build = types.SimpleNamespace(load=lambda _, lib=lib: lib, check=check, NUM_SMS=_build.NUM_SMS,
                                           MAX_SMEM_BYTES=_build.MAX_SMEM_BYTES)
        mods[name] = mod
    return mods


def _flash_module(name, cu_text, hopper_text, py_path):
    return _kernel_module(name, "flash_attention", cu_text, hopper_text, py_path)


def _parent_flash(parent):
    """The parent checkout's flash_attention module, run on its own csrc/flash_attention.cu
    built into build/probe/f32_attn."""
    pk = parent / "src" / "repro_torch" / "kernels"
    return _flash_module("f32_attn", (pk / "csrc" / "flash_attention.cu").read_text(),
                         (pk / "csrc" / "hopper.cuh").read_text(), pk / "flash_attention.py")


def _f32_attn_calls(fk, q, k, v, dout, causal, cross):
    """(forward, backward pair) of a flash_attention module at f32, as the model calls them."""
    if cross:
        o, lse = fk.cross_attention(q, k, v, lse=True)
        return (lambda: fk.cross_attention(q, k, v, lse=True),
                lambda: fk.cross_attention_bwd(q, k, v, o, lse, dout))
    o, lse = fk.flash_attention(q, k, v, causal=causal, lse=True)
    return (lambda: fk.flash_attention(q, k, v, causal=causal, lse=True),
            lambda: fk.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal))


def f32_attn(gen):
    """The f32 attention route against the plain version, sdpa and the parent's kernels."""
    import torch.nn.functional as F

    from chip_smoke import F32_FLOPS
    from repro_torch.kernels import flash_attention as fk

    parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve() if "--parent" in sys.argv else None
    fk._entries()  # this tree's kernels first
    pk = _parent_flash(parent) if parent is not None else None
    plan = fk.launch_plan(1, 1, 64, 64, torch.float32)
    print(f"[f32-attn] repro_torch from {Path(fk.__file__).resolve().parents[2]}; f32 route {plan.route!r}"
          + (f"; the parent's from {parent}" if parent else ""))
    dev = gen.device
    f32 = torch.float32
    for B, Hq, KV, S, Sk, d, causal, what in F32_ATTN:
        cross = Sk != S
        q, k, v = _cross_views(gen, B, Hq, KV, S, Sk, d, f32)  # the model's [B, S, H, d] layout
        dout = torch.randn(B, Hq, S, d, generator=gen, device=dev)
        fwd, bwd = _f32_attn_calls(fk, q, k, v, dout, causal, cross)
        out, lse = fwd()
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        ref_out = ref.flash_attention_ref(*leaves, causal)
        err = assert_close(f"f32 attention {what}", out, ref_out, FLASH_F32_TOL)
        got, again = bwd(), bwd()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"f32 attention backward {what}: two calls differ")
        want = torch.autograd.grad(ref_out, leaves, dout, retain_graph=True)
        errs = [grad_err(f"f32 attention d{n} {what}", a, b, GRAD_TOL["float32"])[1]
                for n, a, b in zip("qkv", got, want)]
        lib_leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_leaves, is_causal=causal, enable_gqa=True)
        lib_err = (lib_out.detach() - ref_out.detach()).abs().max().item()
        lib_ok = bool(((lib_out.detach() - ref_out.detach()).abs()
                       <= FLASH_F32_TOL * (1 + ref_out.detach().abs())).all())
        lib_grads = torch.autograd.grad(lib_out, lib_leaves, dout, retain_graph=True)
        lib_gerr = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(lib_grads, want)]
        out_k, lse_k = fwd()
        dq_k, delta = fk.flash_attention_bwd_dq(q, k, v, out_k, lse_k, dout, causal=causal)
        calls = {"fwd": fwd, "pair": bwd,
                 "dq": lambda: fk.flash_attention_bwd_dq(q, k, v, out_k, lse_k, dout, causal=causal),
                 "dkdv": lambda: fk.flash_attention_bwd_dkdv(q, k, v, dout, lse_k, delta, causal=causal)}
        if pk is not None:
            p_fwd, p_bwd = _f32_attn_calls(pk, q, k, v, dout, causal, cross)
            p_out = p_fwd()[0]
            assert_close(f"the parent's f32 attention {what}", p_out, ref_out, FLASH_F32_TOL)
            calls.update({"parent fwd": p_fwd, "parent pair": p_bwd})
        calls.update({"sdpa": lambda: F.scaled_dot_product_attention(*lib_leaves, is_causal=causal,
                                                                      enable_gqa=True),
                      "sdpa grad": lambda: torch.autograd.grad(lib_out, lib_leaves, dout,
                                                               retain_graph=True)})
        ms = medians(calls)
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal), iters=5)
        plain_grad = cuda_ms(lambda: torch.autograd.grad(ref_out, leaves, dout, retain_graph=True), iters=5)
        pairs = S * (S + 1) // 2 if causal else S * Sk
        b_fwd = flash_bound(B, Hq, KV, S, d, causal, 4, Sk)
        b_bwd = flash_bwd_bounds(B, Hq, KV, S, d, causal, 4, Sk)[2]
        fma = (1e3 * 4 * d * B * Hq * pairs / F32_FLOPS, 1e3 * 10 * d * B * Hq * pairs / F32_FLOPS)
        print(f"[f32-attn] B{B} H{Hq} KV{KV} S{S} Sk{Sk} d{d} causal={causal} {what}: "
              + ", ".join(f"{n} {t:.4f}" for n, t in ms.items())
              + f" ms; plain {plain:.4f} / grad {plain_grad:.4f} ms; bound fwd {b_fwd[0]:.4f} ({b_fwd[1]}) / "
              f"pair {b_bwd[0]:.4f} ({b_bwd[1]}) ms split-TF32, {fma[0]:.4f} / {fma[1]:.4f} ms FMA; "
              f"fwd {100 * b_fwd[0] / ms['fwd']:.1f}% / pair {100 * b_bwd[0] / ms['pair']:.1f}% of the "
              f"bound; sdpa / kernel fwd {ms['sdpa'] / ms['fwd']:.3f}, grad {ms['sdpa grad'] / ms['pair']:.3f}")
        print(f"[f32-attn]   err fwd {err:.2e} (tol {FLASH_F32_TOL}), grads "
              + ", ".join(f"{r:.2e}" for r in errs) + f" of the largest (tol {GRAD_TOL['float32']}); "
              f"pair bit-identical over two calls; sdpa fwd err {lib_err:.2e} "
              f"({'within' if lib_ok else 'BEYOND'} {FLASH_F32_TOL}), sdpa grads "
              + ", ".join(f"{r:.2e}" for r in lib_gerr))
        del q, k, v, dout, out, lse, got, again, want, leaves, ref_out, lib_leaves, lib_out, lib_grads, calls
        del out_k, lse_k, dq_k, delta
    # which kernels f32 sdpa runs, forward and backward
    from torch.profiler import ProfilerActivity, profile

    q, k, v = (torch.randn(2, 16, 448, 64, generator=gen, device=dev).requires_grad_() for _ in range(3))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o = F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
        o.backward(torch.ones_like(o))
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events() if e.device_type.name == "CUDA"})
    print("[f32-attn] f32 sdpa's CUDA kernels, forward and backward: " + " | ".join(n[:160] for n in names))


def f32_sass(gen):
    """Static instruction counts of the f32 attention route's kernels (namespace tf), by
    opcode, from cuobjdump -sass: the loops are unrolled, so the counts stand for a block's
    work on one tile."""
    import collections
    import re

    _build.build_all(["flash_attention"])
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build._library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    for body in sass.split("Function : ")[1:]:
        name = body.split("\n", 1)[0].strip()
        if "2tf" not in name:
            continue
        ops = collections.Counter(m.group(1).split(".")[0] for m in
                                  re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body))
        kernel = re.search(r"2tf\d+(\w+?)I(L[^E]*E(?:L[^E]*E)?)", name)
        label = f"{kernel.group(1)}<{kernel.group(2)}>" if kernel else name[:90]
        print(f"[f32-sass] {label}: {sum(ops.values())} instructions; "
              + ", ".join(f"{k} {n}" for k, n in ops.most_common(24)))


def f32_lo(gen):
    """The split's lo truncated by the tensor cores (the kernel) or rounded to nearest: a
    variant of csrc/flash_attention.cu's kRoundLo built into build/probe/f32_lo, its errors
    against the plain versions and its times beside the kernel's, in turns."""
    from repro_torch.kernels import flash_attention as fk

    src = (_build.CSRC / "flash_attention.cu").read_text()
    line = "constexpr bool kRoundLo = false;"
    if src.count(line) != 1:
        raise RuntimeError("flash_attention.cu no longer has the constant this probe changes")
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    mods = {"truncated": fk, "rounded": _flash_module("f32_lo", src.replace(line, "constexpr bool kRoundLo = true;"),
                                                       hopper, Path(fk.__file__))}
    dev = gen.device
    for B, Hq, KV, S, Sk, d, causal, what in [*F32_ATTN, (2, 32, 2, 1, 1, 128, True, "one key")]:
        q, k, v = _cross_views(gen, B, Hq, KV, S, Sk, d, torch.float32)
        dout = torch.randn(B, Hq, S, d, generator=gen, device=dev)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        ref_out = ref.flash_attention_ref(*leaves, causal)
        want = torch.autograd.grad(ref_out, leaves, dout, retain_graph=True)
        calls, errs = {}, []
        for name, fm in mods.items():
            o, lse = fm.flash_attention(q, k, v, causal=causal, lse=True)
            got = fm.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal)
            # each gradient's error over its largest magnitude, or absolute where that is 0
            errs.append(f"{name} fwd {(o - ref_out).abs().max().item():.2e}, grads " + "/".join(
                f"{((a - b).abs().max() / max(b.abs().max().item(), 1.0 if not b.abs().max() else 0.0)).item():.2e}"
                for a, b in zip(got, want)))
            calls[f"{name} fwd"] = lambda fm=fm: fm.flash_attention(q, k, v, causal=causal, lse=True)
            calls[f"{name} pair"] = lambda fm=fm, o=o, lse=lse: fm.flash_attention_bwd(q, k, v, o, lse, dout,
                                                                                       causal=causal)
        ms = medians(calls)
        print(f"[f32-lo] B{B} H{Hq} KV{KV} S{S} Sk{Sk} d{d} {what}: " + "; ".join(errs) + "; "
              + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()) + " ms")
        del q, k, v, dout, leaves, ref_out, want, calls


def f32_dp(gen):
    """The f32 backward's dP summed over 1, 2 or 4 k-steps (or all, 0) before its f32 add:
    variants of csrc/flash_attention.cu's kDpGroup built into build/probe/f32_dp/<G>, each
    read where the reference gradient is 0 (one key) and timed at whisper's shapes, in turns."""
    from repro_torch.kernels import flash_attention as fk

    src = (_build.CSRC / "flash_attention.cu").read_text()
    line = "constexpr int kDpGroup = 4;"
    if src.count(line) != 1:
        raise RuntimeError("flash_attention.cu no longer has the constant this probe changes")
    hopper = (_build.CSRC / "hopper.cuh").read_text()
    mods = {G: _flash_module(f"f32_dp/{G}", src.replace(line, f"constexpr int kDpGroup = {G};"), hopper,
                             Path(fk.__file__)) for G in (0, 1, 2, 4)}
    dev = gen.device
    for B, Hq, KV, S, d, causal in ((2, 32, 2, 1, 128, True), (2, 32, 2, 1, 64, False),
                                    (2, 8, 2, 2, 128, True)):
        q, k, v, dout = (torch.randn(*shape, generator=gen, device=dev) for shape in
                         ((B, Hq, S, d), (B, KV, S, d), (B, KV, S, d), (B, Hq, S, d)))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ref.flash_attention_ref(*leaves, causal), leaves, dout)
        row = []
        for G, fm in mods.items():
            o, lse = fm.flash_attention(q, k, v, causal=causal, lse=True)
            got = fm.flash_attention_bwd(q, k, v, o, lse, dout, causal=causal)
            row.append(f"G {G}: " + " / ".join(f"{(a - b).abs().max().item():.2e}" for a, b in zip(got, want)))
        print(f"[f32-dp] B{B} H{Hq} KV{KV} S{S} d{d} causal={causal}: largest |dq - ref| / |dk - ref| / "
              f"|dv - ref| (ref max {max(w.abs().max().item() for w in want):.2e}): " + "; ".join(row))
    for B, Hq, KV, S, Sk, d, causal, what in F32_ATTN[3:]:
        q, k, v = _cross_views(gen, B, Hq, KV, S, Sk, d, torch.float32)
        dout = torch.randn(B, Hq, S, d, generator=gen, device=dev)
        calls = {}
        for G, fm in mods.items():
            o, lse = fm.flash_attention(q, k, v, causal=causal, lse=True)
            calls[f"G {G}"] = lambda fm=fm, o=o, lse=lse: fm.flash_attention_bwd(q, k, v, o, lse, dout,
                                                                                   causal=causal)
        ms = medians(calls)
        print(f"[f32-dp] B{B} H{Hq} S{S} Sk{Sk} d{d} {what}: pair " + ", ".join(f"{n} {t:.4f}" for n, t in ms.items())
              + " ms")


F32_GEMM_MOE = [  # (E, C, D, F, what): granite-moe-3b-a800m's experts in f32
    (40, 256, 1536, 512, "LM gate/up"), (40, 256, 512, 1536, "LM down"),
    (40, 384, 1536, 512, "score gate/up"), (40, 8, 1536, 512, "decode gate/up"),
    (14, 256, 1536, 512, "mesh rank gate/up"),
]
F32_GEMM_SSD = [  # (BNC, H, Q, hd, N, what)
    (4, 24, 256, 64, 128, "LM mamba2"), (4, 50, 256, 64, 16, "LM hymba"),
    (8, 24, 160, 64, 128, "mamba2 score"), (2, 8, 128, 64, 128, "mesh rank prefill"),
]

# dense loops of independent mma.sync into registers: the instruction's own rate on this card
MMA_RATE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int kTf32>
__global__ void mma_loop(float* out, int iters) {
  float d[8][4];
  for (int j = 0; j < 8; ++j) for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
  const uint32_t v = __float_as_uint(1.0f + threadIdx.x * 1e-3f) & 0xffffe000u;
  const uint32_t a0 = v, a1 = v ^ 0x2000u, a2 = v ^ 0x4000u, a3 = v ^ 0x6000u, b0 = v ^ 0x8000u,
                 b1 = v ^ 0xa000u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kTf32)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) for (int e = 0; e < 4; ++e) s += d[j][e];
  if (s == 1.2345f) out[0] = s;
}
extern "C" int mma_rate(int tf32, int blocks, int threads, int iters, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tf32) mma_loop<1><<<blocks, threads, 0, st>>>(out, iters);
  else mma_loop<0><<<blocks, threads, 0, st>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def _mma_rates():
    """TFLOP/s of mma.sync m16n8k8 TF32 and m16n8k16 bf16 at 1-16 warps an SM (dense loops of 8
    independent products a warp, no memory), against the data sheet's dense peaks."""
    from chip_smoke import BF16_TENSOR_FLOPS, TF32_TENSOR_FLOPS

    vdir = ROOT / "build" / "probe" / "mma_rate"
    vdir.mkdir(parents=True, exist_ok=True)
    (vdir / "mma_rate.cu").write_text(MMA_RATE_CU)
    lib_path = vdir / "libmma_rate.so"
    subprocess.run([_build._nvcc(), *[f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")],
                    "-o", str(lib_path), str(vdir / "mma_rate.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters = 2048
    for tf32, flops, peak, what in ((1, 2 * 16 * 8 * 8, TF32_TENSOR_FLOPS, "m16n8k8 TF32"),
                                    (0, 2 * 16 * 8 * 16, BF16_TENSOR_FLOPS, "m16n8k16 bf16")):
        row = []
        for warps in (2, 4, 8, 16):  # a block of that many warps on each SM
            blocks, threads = _build.NUM_SMS, 32 * warps
            ms = cuda_ms(lambda: lib.mma_rate(tf32, blocks, threads, iters, ctypes.c_void_p(out.data_ptr()),
                                              ctypes.c_void_p(stream)), iters=5)
            rate = blocks * warps * iters * 8 * flops / (ms * 1e-3)
            row.append(f"{warps} warps/SM {rate / 1e12:.1f} TFLOP/s ({100 * rate / peak:.1f}% of peak)")
        print(f"[f32-gemm] mma.sync {what}: " + ", ".join(row))


def _sass_per_mma(lib_path, match):
    """(name, instructions, tensor-core instructions) of each kernel in lib_path whose mangled
    name holds ``match``, from cuobjdump -sass (static counts: the unrolled loop bodies)."""
    import collections
    import re

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    rows = []
    for body in sass.split("Function : ")[1:]:
        name = body.split("\n", 1)[0].strip()
        if match not in name:
            continue
        ops = collections.Counter(m.group(1).split(".")[0] for m in
                                  re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body))
        rows.append((name, ops))
    return rows


def f32_gemm(gen):
    """B3's and B4's f32 routes (``"tf32x3"``, ``"mma3"``) against the plain versions, two calls
    bit-identical, and timed, the median of three rounds in turns, beside the parent's kernels
    (``--parent DIR``: a checkout of the parent commit whose ``csrc/moe_matmul.cu`` and
    ``csrc/ssd_scan.cu`` are built into build/probe/f32_gemm and run through its own modules and
    plans), ``torch.bmm`` (B3) and the bf16 route on the same values (B4); B4 also at the head
    count a y block the plan does not take (one or two).  Then B3 at 128 x 64 tiles and with
    parts of its loop taken out, the SASS instructions per tensor-core instruction of the f32
    kernels, and mma.sync's own rates."""
    from chip_smoke import F32_FLOPS, F32_TOL, ssd_fma_bound
    from repro_torch.kernels import moe_matmul as mk

    parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve() if "--parent" in sys.argv else None
    mk._entry(), ssd_scan._entry()  # this tree's kernels first
    pm = ps = None
    if parent is not None:
        pk = parent / "src" / "repro_torch" / "kernels"
        hop = (pk / "csrc" / "hopper.cuh").read_text()
        pm = _kernel_module("f32_gemm/moe", "moe_matmul", (pk / "csrc" / "moe_matmul.cu").read_text(), hop,
                            pk / "moe_matmul.py")
        ps = _kernel_module("f32_gemm/ssd", "ssd_scan", (pk / "csrc" / "ssd_scan.cu").read_text(), hop,
                            pk / "ssd_scan.py")
    print(f"[f32-gemm] repro_torch from {Path(mk.__file__).resolve().parents[2]}"
          + (f"; the parent's from {parent}" if parent else ""))
    dev = gen.device
    f32 = torch.float32
    for E, C, D, F, what in F32_GEMM_MOE:
        buf = torch.randn(E, C, D, generator=gen, device=dev)
        w = torch.randn(E, D, F, generator=gen, device=dev) * 0.05
        got = mk.moe_matmul(buf, w)
        plan = mk.last_plan
        err = assert_close(f"moe_matmul f32 {what}", got, ref.moe_matmul_ref(buf, w), F32_TOL)
        if not torch.equal(mk.moe_matmul(buf, w), got):
            raise AssertionError(f"moe_matmul f32 {what}: two calls differ")
        calls = {"kernel": lambda: mk.moe_matmul(buf, w), "bmm": lambda: torch.bmm(buf, w)}
        if pm is not None:
            assert_close(f"the parent's moe_matmul f32 {what}", pm.moe_matmul(buf, w), ref.moe_matmul_ref(buf, w),
                         F32_TOL)
            calls["parent"] = lambda: pm.moe_matmul(buf, w)
        ms = medians(calls)
        b = moe_bound(E, C, D, F, 4)
        fma = 1e3 * 2 * E * C * D * F / F32_FLOPS
        print(f"[f32-gemm] moe_matmul E{E} C{C} D{D} F{F} {what}: route {plan.route} {plan.block_m} x "
              f"{plan.block_n}, grid {plan.grid}; " + ", ".join(f"{n} {t:.4f}" for n, t in ms.items())
              + f" ms; bound {b[0]:.4f} ({b[1]}, split TF32), FMA {fma:.4f}; {100 * b[0] / ms['kernel']:.1f}% "
              f"of the bound; bmm / kernel {ms['bmm'] / ms['kernel']:.3f}; err {err:.2e} (tol {F32_TOL}); "
              "two calls bit-identical")
        del buf, w, got
    for BNC, H, Q, hd, N, what in F32_GEMM_SSD:
        x = torch.randn(BNC, H, Q, hd, generator=gen, device=dev) * 0.5
        b, c = (torch.randn(BNC, Q, N, generator=gen, device=dev) * 0.5 for _ in range(2))
        cum = -torch.cumsum(0.1 * torch.rand(BNC, H, Q, generator=gen, device=dev), -1)
        xb = x.bfloat16()
        y, st = ssd_scan.ssd_intra_chunk(x, b, c, cum)
        y_ref, st_ref = ref.ssd_intra_chunk_ref(x, b, c, cum)
        err = max(assert_close(f"ssd f32 y {what}", y, y_ref, F32_TOL),
                  assert_close(f"ssd f32 state {what}", st, st_ref, F32_TOL))
        again = ssd_scan.ssd_intra_chunk(x, b, c, cum)
        if not (torch.equal(again[0], y) and torch.equal(again[1], st)):
            raise AssertionError(f"ssd_intra_chunk f32 {what}: two calls differ")
        plan = ssd_scan.launch_plan(BNC, H, Q, hd, N, f32)
        calls = {"kernel": lambda: ssd_scan.ssd_intra_chunk(x, b, c, cum),
                 "bf16 route": lambda: ssd_scan.ssd_intra_chunk(xb, b, c, cum)}
        other = 3 - plan.heads_per_block  # the kernel takes one or two heads a y block
        if H > 1:
            g2 = _ssd_heads_call(x, b, c, cum, other)
            g2_out = g2()
            err2 = max(assert_close(f"ssd f32 y {what} {other} heads", g2_out[0], y_ref, F32_TOL),
                       assert_close(f"ssd f32 state {what} {other} heads", g2_out[1], st_ref, F32_TOL))
            calls[f"{other} heads"] = g2
        if ps is not None:
            p_out = ps.ssd_intra_chunk(x, b, c, cum)
            assert_close(f"the parent's ssd f32 y {what}", p_out[0], y_ref, F32_TOL)
            calls["parent"] = lambda: ps.ssd_intra_chunk(x, b, c, cum)
        ms = medians(calls)
        bf = ssd_bound(BNC, H, Q, hd, N, 4)
        print(f"[f32-gemm] ssd_intra_chunk BNC{BNC} H{H} Q{Q} hd{hd} N{N} {what}: route {plan.route}, "
              f"{plan.heads_per_block} heads a y block, grid {plan.grid}, {plan.smem_bytes} B; "
              + ", ".join(f"{n} {t:.4f}" for n, t in ms.items())
              + f" ms; bound {bf[0]:.4f} ({bf[1]}, split products), FMA {ssd_fma_bound(BNC, H, Q, hd, N, 4)[0]:.4f}; "
              f"{100 * bf[0] / ms['kernel']:.1f}% of the bound; err {err:.2e}"
              + (f", {other} heads {err2:.2e}" if H > 1 else "") + f" (tol {F32_TOL}); "
              "two calls bit-identical")
        del x, xb, b, c, cum, y, st, y_ref, st_ref, again
    _tf_widths(gen)
    _tf_parts(gen)
    for lib, match in ((_build._library_path("moe_matmul"), "tf32x3"),
                       (_build._library_path("ssd_scan"), "ssd_kernelIf")):
        for name, ops in _sass_per_mma(lib, match):
            mma = ops["HMMA"] + ops["HGMMA"]  # mma.sync, wgmma
            print(f"[f32-gemm] sass {name[:100]}: {sum(ops.values())} instructions, {mma} tensor-core "
                  f"(HMMA, HGMMA), {sum(ops.values()) / max(mma, 1):.2f} a tensor-core instruction; "
                  + ", ".join(f"{k} {n}" for k, n in ops.most_common(16)))
    _mma_rates()


def _tf_widths(gen):
    """moe_matmul's f32 route with its C > 64 tiles 128 x 64 (two blocks an SM) instead of 128 x
    128: a variant of csrc/moe_matmul.cu (``tf::Wide``) and moe_matmul.py (``TF_WIDE_N``) built
    into build/probe/tf_width, timed beside the kernel at F32_GEMM_MOE's shapes, in turns, each
    held against the plain version."""
    from chip_smoke import F32_TOL
    from repro_torch.kernels import moe_matmul as mk

    cu = (_build.CSRC / "moe_matmul.cu").read_text()
    py = Path(mk.__file__).read_text()
    cu_line, py_line = "using Wide = Shape<128, 128>;", "TF_WIDE_N = 128"
    if cu.count(cu_line) != 1 or py.count(py_line) != 1:
        raise RuntimeError("moe_matmul no longer has the tile width this probe changes")
    vdir = ROOT / "build" / "probe" / "tf_width"
    vdir.mkdir(parents=True, exist_ok=True)
    (vdir / "moe_matmul.py").write_text(py.replace(py_line, "TF_WIDE_N = 64"))
    narrow = _kernel_module("tf_width", "moe_matmul", cu.replace(cu_line, "using Wide = Shape<128, 64>;"),
                            (_build.CSRC / "hopper.cuh").read_text(), vdir / "moe_matmul.py")
    dev = gen.device
    for E, C, D, F, what in F32_GEMM_MOE:
        if C <= 64:
            continue
        buf = torch.randn(E, C, D, generator=gen, device=dev)
        w = torch.randn(E, D, F, generator=gen, device=dev) * 0.05
        assert_close(f"128 x 64 tiles {what}", narrow.moe_matmul(buf, w), ref.moe_matmul_ref(buf, w), F32_TOL)
        ms = medians({"128 x 128": lambda: mk.moe_matmul(buf, w),
                      "128 x 64": lambda: narrow.moe_matmul(buf, w)})
        print(f"[f32-gemm] tf32x3 tiles E{E} C{C} D{D} F{F} {what}: "
              + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()) + " ms")
        del buf, w


def _tf_parts(gen):
    """moe_matmul's f32 route with a part of its stage loop taken out: variants of
    csrc/moe_matmul.cu built into build/probe/tf_parts/<part> without the wgmma (the loads and
    the split alone), or without the loads and the split (the wgmma alone, on whatever the planes
    hold), timed beside the kernel at F32_GEMM_MOE's shapes, in turns; their outputs are wrong
    by design."""
    from repro_torch.kernels import moe_matmul as mk

    cu = (_build.CSRC / "moe_matmul.cu").read_text()
    lines = {"products": "      if (kt > 0) products(u ^ 1);\n",
             "split": "      if (kt < nk) split_stage(u, va[u], vb[u]);\n",
             "loads": "      if (kt + 2 < nk) load(kt + 2, va[u], vb[u]);  // two stages ahead\n"}
    if any(cu.count(line) != 1 for line in lines.values()):
        raise RuntimeError("moe_matmul.cu no longer has the lines this probe takes out")
    hop = (_build.CSRC / "hopper.cuh").read_text()
    variants = {
        "no wgmma": _kernel_module("tf_parts/no_wgmma", "moe_matmul", cu.replace(lines["products"], ""), hop,
                                   Path(mk.__file__)),
        "wgmma alone": _kernel_module("tf_parts/wgmma_alone", "moe_matmul",
                                      cu.replace(lines["split"], "").replace(lines["loads"], ""), hop,
                                      Path(mk.__file__)),
    }
    dev = gen.device
    for E, C, D, F, what in F32_GEMM_MOE:
        buf = torch.randn(E, C, D, generator=gen, device=dev)
        w = torch.randn(E, D, F, generator=gen, device=dev) * 0.05
        ms = medians({"kernel": lambda: mk.moe_matmul(buf, w),
                      **{n: (lambda m=m: m.moe_matmul(buf, w)) for n, m in variants.items()}})
        print(f"[f32-gemm] tf32x3 parts E{E} C{C} D{D} F{F} {what}: "
              + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()) + " ms")
        del buf, w


F32_BWD_MOE = [  # (E, C, D, F, what): B7's f32 launches
    (40, 256, 1536, 512, "LM gate/up"), (40, 256, 512, 1536, "LM down"),
    (4, 128, 256, 128, "mesh rank reduced gate/up"), (4, 130, 256, 128, "reduced, ragged C"),
]


def f32_bwd(gen):
    """B7's f32 route (``"tf32x3"``) held against the plain gradients, two calls bit-identical,
    and timed, the median of three rounds in turns: dbuf, dw and both beside the parent's
    kernels (``--parent DIR``: a checkout of the parent commit whose ``csrc/moe_matmul.cu`` is
    built into build/probe/f32_bwd/<DIR's name> and run through its own module and plans) and
    ``torch.bmm``; the forward's f32 route beside the parent's, bit for bit.  Then the
    backward's variants (``_tf_bwd_variants``) in turns."""
    from chip_smoke import F32_TOL, moe_fma_ms
    from repro_torch.kernels import moe_matmul as mk

    parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve() if "--parent" in sys.argv else None
    mk._entry(), mk._bwd_entry()  # this tree's kernels first
    specs = _tf_bwd_variant_specs()
    if parent is not None:
        pk = parent / "src" / "repro_torch" / "kernels"
        specs[f"f32_bwd/{parent.name}"] = ("moe_matmul", (pk / "csrc" / "moe_matmul.cu").read_text(),
                                           (pk / "csrc" / "hopper.cuh").read_text(), pk / "moe_matmul.py")
    mods = _kernel_modules(specs)
    pm = mods.pop(f"f32_bwd/{parent.name}", None) if parent is not None else None
    print(f"[f32-bwd] repro_torch from {Path(mk.__file__).resolve().parents[2]}"
          + (f"; the parent's from {parent}" if parent else ""))
    dev, tol = gen.device, GRAD_TOL["float32"]
    for E, C, D, F, what in F32_BWD_MOE:
        buf = torch.randn(E, C, D, generator=gen, device=dev)
        w = torch.randn(E, D, F, generator=gen, device=dev) * 0.05
        dout = torch.randn(E, C, F, generator=gen, device=dev)
        plan = mk.bwd_plan(E, C, D, F, torch.float32)
        got, again = mk.moe_matmul_bwd(buf, w, dout), mk.moe_matmul_bwd(buf, w, dout)
        want = ref.moe_matmul_bwd_ref(buf, w, dout)
        errs = [grad_err(f"f32 {n} {what}", a, b, tol)[1] for n, a, b in zip(("dbuf", "dw"), got, want)]
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"moe_matmul_bwd f32 {what}: two calls differ")
        calls = {"dbuf": lambda: mk.moe_matmul_bwd(buf, w, dout, dw=False),
                 "dw": lambda: mk.moe_matmul_bwd(buf, w, dout, dbuf=False),
                 "both": lambda: mk.moe_matmul_bwd(buf, w, dout),
                 "bmm dout w^T": lambda: torch.bmm(dout, w.transpose(1, 2)),
                 "bmm buf^T dout": lambda: torch.bmm(buf.transpose(1, 2), dout)}
        if pm is not None:
            for n, a, b in zip(("dbuf", "dw"), pm.moe_matmul_bwd(buf, w, dout), want):
                grad_err(f"the parent's f32 {n} {what}", a, b, tol)
            calls.update({"parent dbuf": lambda: pm.moe_matmul_bwd(buf, w, dout, dw=False),
                          "parent dw": lambda: pm.moe_matmul_bwd(buf, w, dout, dbuf=False),
                          "parent both": lambda: pm.moe_matmul_bwd(buf, w, dout)})
        ms = medians(calls)
        b_dbuf, b_dw, _ = moe_bwd_bounds(E, C, D, F, 4)
        print(f"[f32-bwd] moe_matmul_bwd E{E} C{C} D{D} F{F} {what}: dbuf {plan.dbuf.block_m} x "
              f"{plan.dbuf.block_n} grid {plan.dbuf.grid[0]} for {plan.dbuf.tiles} tiles, dw "
              f"{plan.dw.block_m} x {plan.dw.block_n} grid {plan.dw.grid[0]} for {plan.dw.tiles} tiles; "
              + ", ".join(f"{n} {t:.4f}" for n, t in ms.items())
              + f" ms; bound {b_dbuf[0]:.4f} / {b_dw[0]:.4f} ({b_dbuf[1]} / {b_dw[1]}, split TF32), FMA "
              f"{moe_fma_ms(E, C, D, F):.4f}; {100 * b_dbuf[0] / ms['dbuf']:.1f}% / "
              f"{100 * b_dw[0] / ms['dw']:.1f}% of the bound; bmm / kernel "
              f"{ms['bmm dout w^T'] / ms['dbuf']:.3f} / {ms['bmm buf^T dout'] / ms['dw']:.3f}; err "
              f"{errs[0]:.2e} / {errs[1]:.2e} of the largest (tol {tol}); two calls bit-identical")
        if pm is not None and C > 64:  # the forward, whose loaders the backward shares
            fwd = mk.moe_matmul(buf, w)
            if not torch.equal(fwd, pm.moe_matmul(buf, w)):
                raise AssertionError(f"moe_matmul f32 {what}: not the parent's bits")
            assert_close(f"moe_matmul f32 {what}", fwd, ref.moe_matmul_ref(buf, w), F32_TOL)
            fms = medians({"forward": lambda: mk.moe_matmul(buf, w),
                           "parent forward": lambda: pm.moe_matmul(buf, w)})
            print(f"[f32-bwd] moe_matmul E{E} C{C} D{D} F{F} {what}: "
                  + ", ".join(f"{n} {t:.4f}" for n, t in fms.items()) + " ms; the parent's bits")
        del buf, w, dout, got, again, want
    _tf_bwd_variants(gen, mods)


TF_BWD_VARIANTS = {"tf_bwd/tiles": "a block a tile", "tf_bwd/no_wgmma": "no wgmma",
                   "tf_bwd/wgmma_alone": "wgmma alone", "tf_bwd/no_stores": "no stores"}


def _tf_bwd_variant_specs():
    """B7's f32 route as variants of csrc/moe_matmul.cu (and moe_matmul.py), for
    ``_kernel_modules`` to build into build/probe/tf_bwd/<name>: one block a tile (a grid of
    every tile, no persistent walk), and without the stage loop's wgmma (the loads and splits
    alone), its loads and splits (the wgmma alone, on whatever the planes hold) or its
    accumulators' stores."""
    from repro_torch.kernels import moe_matmul as mk

    cu = (_build.CSRC / "moe_matmul.cu").read_text()
    py_path = Path(mk.__file__)
    py = py_path.read_text()
    blocks_cu, blocks_py = "constexpr int kBwdWideBlocks = 1, kBwdSmallBlocks = 2;", "TF_BWD_BLOCKS = {128: 1, 64: 2}"
    head, marker, tail = cu.partition("moe_matmul_bwd_tf32x3(const float* __restrict__ a")
    lines = {"products": "      if (st > 0) stage_products<S>(part, planes + (u ^ 1) * S::planes, wg);\n",
             "split": "        A.split(planes + u * S::planes, va[u]);\n"
                      "        B.split(planes + u * S::planes + 2 * S::plane_a, vb[u]);\n",
             "loads": "      if (st + 2 < total) load_next(va[u], vb[u]);  // two stages ahead, into the next tile at its end\n",
             "stores": "          store_tile_tma<BN>(&to, staging, acc, ot % m_tiles * BM, ot / m_tiles % n_tiles * BN,\n"
                       "                             ot / (m_tiles * n_tiles), M, N);\n"}
    if (cu.count(blocks_cu) != 1 or py.count(blocks_py) != 1 or not marker
            or any(tail.count(line) != 1 for line in lines.values())):
        raise RuntimeError("moe_matmul no longer has the lines this probe changes")
    hop = (_build.CSRC / "hopper.cuh").read_text()

    def without(*parts):
        t = tail
        for part in parts:
            t = t.replace(lines[part], "")
        return head + marker + t

    vdir = ROOT / "build" / "probe" / "tf_bwd"
    vdir.mkdir(parents=True, exist_ok=True)
    (vdir / "moe_matmul.py").write_text(py.replace(blocks_py, "TF_BWD_BLOCKS = {128: 1 << 20, 64: 1 << 20}"))
    return {
        "tf_bwd/tiles": ("moe_matmul", cu.replace(
            blocks_cu, "constexpr int kBwdWideBlocks = 1 << 20, kBwdSmallBlocks = 1 << 20;"), hop,
            vdir / "moe_matmul.py"),
        "tf_bwd/no_wgmma": ("moe_matmul", without("products"), hop, py_path),
        "tf_bwd/wgmma_alone": ("moe_matmul", without("split", "loads"), hop, py_path),
        # the sums kept by a shared-memory store that never runs: ptxas drops a wgmma whose
        # result nothing reads
        "tf_bwd/no_stores": ("moe_matmul", head + marker + tail.replace(lines["stores"], (
            "          float sum = 0.f;\n"
            "          for (int i = 0; i < BN / 2; ++i) sum += acc[i];\n"
            "          if (sum == 1e30f) staging[threadIdx.x] = 1;\n")), hop, py_path),
    }


def _tf_bwd_variants(gen, mods):
    """The variants of ``_tf_bwd_variant_specs`` (built: ``mods``), each timed beside the kernel
    at F32_BWD_MOE's shapes, dbuf and dw apart, in turns; one block a tile checked bit-identical
    to the kernel, the others' outputs wrong by design."""
    from repro_torch.kernels import moe_matmul as mk

    variants = {label: mods[name] for name, label in TF_BWD_VARIANTS.items()}
    for name, label in TF_BWD_VARIANTS.items():  # what each variant's kernels still run
        lib = next((ROOT / "build" / "probe" / name / "lib").glob("libmoe_matmul-*.so"))
        for kname, ops_ in _sass_per_mma(lib, "moe_matmul_bwd_tf32x3"):
            print(f"[f32-bwd] sass {label}: {kname[:70]}: {ops_['HGMMA']} HGMMA, {ops_['LDG']} LDG, "
                  f"{ops_['UTMASTG'] + ops_['STG']} global stores, {sum(ops_.values())} instructions")
    dev = gen.device
    for E, C, D, F, what in F32_BWD_MOE:
        buf = torch.randn(E, C, D, generator=gen, device=dev)
        w = torch.randn(E, D, F, generator=gen, device=dev) * 0.05
        dout = torch.randn(E, C, F, generator=gen, device=dev)
        tiles = variants["a block a tile"]
        grid = {n: getattr(tiles.bwd_plan(E, C, D, F, torch.float32), n).grid[0] for n in ("dbuf", "dw")}
        if not all(torch.equal(a, b) for a, b in zip(tiles.moe_matmul_bwd(buf, w, dout),
                                                      mk.moe_matmul_bwd(buf, w, dout))):
            raise AssertionError(f"moe_matmul_bwd f32 {what}: a block a tile gives other bits")
        for which, kw in (("dbuf", {"dw": False}), ("dw", {"dbuf": False})):
            ms = medians({"kernel": lambda kw=kw: mk.moe_matmul_bwd(buf, w, dout, **kw),
                          **{n: (lambda m=m, kw=kw: m.moe_matmul_bwd(buf, w, dout, **kw))
                             for n, m in variants.items()}})
            print(f"[f32-bwd] tf32x3 {which} variants E{E} C{C} D{D} F{F} {what} (a block a tile: grid "
                  f"{grid[which]}): " + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()) + " ms")
        del buf, w, dout


def _ssd_heads_call(x, b, c, cum, g):
    """ssd_intra_chunk's f32 route at g heads a y block (the entry takes 1 or 2 with the grid
    they make), as a call returning (y, state)."""
    BNC, H, Q, hd = x.shape
    N = b.shape[2]
    plan = ssd_scan.launch_plan(BNC, H, Q, hd, N, x.dtype)
    grid_x = -(-Q // 64) * -(-H // g) + H * -(-N // 128)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)

    def call():
        y, st = torch.empty_like(x), torch.empty(BNC, H, hd, N, device=x.device)
        err = ssd_scan._entry()(ssd_scan.DTYPES[x.dtype], hd, x.data_ptr(), b.data_ptr(), c.data_ptr(),
                                cum.data_ptr(), y.data_ptr(), st.data_ptr(), BNC, H, Q, N, g, grid_x,
                                plan.smem_bytes, stream)
        _build.check("ssd_scan", err)
        return y, st
    return call


def main() -> int:
    modes = {"time": time_kernels, "moe": time_moe, "moe-parts": moe_parts, "bwd": time_backward,
             "ssd-bwd": time_ssd_bwd, "ssd-sass": ssd_sass, "ssd-parts": ssd_parts, "bwd-parts": bwd_parts, "ssd-roles": ssd_roles, "ssm-check": ssm_check,
             "moe-bwd-tiles": moe_bwd_tiles, "rms-parts": rms_parts,
             "live-rate": live_rate, "cross": time_cross, "fwd-bounds": fwd_bounds,
             "cross-parts": cross_parts, "cross-bwd": time_cross_bwd, "cross-bwd-parts": cross_bwd_parts,
             "rms-fwd": rms_fwd, "f32-attn": f32_attn, "f32-sass": f32_sass,
             "f32-dp": f32_dp, "f32-lo": f32_lo, "f32-gemm": f32_gemm, "f32-bwd": f32_bwd}
    flag = "--parent" if sys.argv[1] in ("rms-fwd", "f32-attn", "f32-gemm", "f32-bwd") else "--tree"
    if len(sys.argv) not in (2, 4) or sys.argv[1] not in modes or (len(sys.argv) == 4 and sys.argv[2] != flag):
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
