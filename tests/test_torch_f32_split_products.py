"""The f32 routes of ``moe_matmul`` ("tf32x3", forward and backward) and
``ssd_intra_chunk`` ("mma3") against the JAX package, on the CPU.

``csrc/moe_matmul.cu`` runs every f32 product on the tensor cores as three TF32
products of the operands' halves, hi = tf32(x) (``cvt.rna``: round to nearest,
ties away from zero, to 10 mantissa bits) and lo = x - hi, which the tensor
cores read as TF32 by dropping its low 13 bits, the small terms first (lo hi +
hi lo + hi hi), one ``wgmma`` k-step of 8 columns after another, each 32-deep
stage's products from zero and then added to the running f32 sum.
``csrc/ssd_scan.cu`` runs its f32 route on the bf16 tensor cores with every f32
operand (C, B, the decayed scores, x and x o exp(cum_last - cum)) in three bf16
pieces, piece p = bf16(what pieces 0..p-1 left), keeping the six products of
pieces i and j with i + j < 3, each ``mma.sync`` k-step of 16 summed from zero,
the smallest products first, and then added to the running f32 sum.  This file
models both in torch in the kernels' tile and summation order and holds each
model against
``repro.kernels.moe_matmul.moe_matmul`` / ``repro.kernels.ssd_scan.ssd_intra_chunk``
in interpret mode and against ``repro.kernels.ref``'s plain versions, on the
same numpy-seeded inputs, at the limit the card holds the kernels to: 1e-4 of
1 + |reference|.  One TF32 product a product (hi hi) misses it at granite's
depth; three meet it.  ``moe_matmul_bwd``'s f32 route runs the same arithmetic
on its two launches, dbuf = dout wᵀ over F and dw = bufᵀ dout over C; its
model is held against ``jax.vjp`` of ``repro.kernels.ref.moe_matmul_ref`` (the
JAX package differentiates its plain product) at 1e-4 of each gradient's
largest magnitude, the limit the card holds the backward kernels to.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import moe_matmul as jax_moe
from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jax_ssd
from repro_torch.kernels import moe_matmul as moe_mod
from repro_torch.kernels import ssd_scan as ssd_mod

TOL = 1e-4


def within(got: torch.Tensor, want: np.ndarray, tol: float = TOL) -> float:
    """The largest |got - want| / (1 + |want|); asserts it is within ``tol``."""
    want_t = torch.from_numpy(np.array(want, dtype=np.float32))
    ratio = ((got - want_t).abs() / (1 + want_t.abs())).max().item()
    assert ratio <= tol, f"{ratio:.3e} beyond {tol}"
    return ratio


# ---- B3: split TF32 --------------------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, rounding to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """A TF32 operand as the tensor cores read it: the low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def moe_split(buf: torch.Tensor, w: torch.Tensor, products: int = 3) -> torch.Tensor:
    """buf [E, C, D] @ w [E, D, F] as the tf32x3 kernel sums it: per 32-deep stage of D, from
    zero, its four k-steps of 8 columns, each lo hi, hi lo, then hi hi, 8 exact TF32 products
    summed in f32; then the stage's sum added to the running f32 sum.  ``products`` 1: hi hi
    alone."""
    bh, wh = tf32(buf), tf32(w)
    bl, wl = truncate(buf - bh), truncate(w - wh)
    acc = torch.zeros(buf.shape[0], buf.shape[1], w.shape[2])
    for s0 in range(0, buf.shape[2], 32):
        part = torch.zeros_like(acc)
        for k0 in range(s0, min(s0 + 32, buf.shape[2]), 8):
            ks = slice(k0, k0 + 8)
            if products == 3:
                part = part + bl[..., ks] @ wh[:, ks]
                part = part + bh[..., ks] @ wl[:, ks]
            part = part + bh[..., ks] @ wh[:, ks]
        acc = acc + part
    return acc


# (E, C, D, F): granite's widths at a few rows, a decode capacity, and ragged C, D and F
MOE_SHAPES = [(2, 40, 1536, 64), (3, 130, 200, 72), (4, 8, 512, 48), (1, 70, 100, 36)]


def moe_inputs(E, C, D, F):
    rng = np.random.default_rng(E * C + D * F)
    return (rng.standard_normal((E, C, D), dtype=np.float32),
            (0.05 * rng.standard_normal((E, D, F))).astype(np.float32))


@pytest.mark.parametrize("E,C,D,F", MOE_SHAPES)
def test_moe_tf32x3_model_matches_jax(E, C, D, F):
    buf, w = moe_inputs(E, C, D, F)
    assert moe_mod.launch_plan(E, C, D, F, torch.float32).route == "tf32x3"
    got = moe_split(torch.from_numpy(buf), torch.from_numpy(w))
    # one block over the whole product: the Pallas kernel takes block sizes that divide it
    pallas = jax_moe.moe_matmul(jnp.asarray(buf), jnp.asarray(w), block_c=C, block_d=D, block_f=F,
                                interpret=True)
    within(got, pallas)
    within(got, jref.moe_matmul_ref(jnp.asarray(buf), jnp.asarray(w)))


def test_moe_one_tf32_product_misses_the_limit():
    """hi hi alone keeps ~11 bits of each operand: over granite's 1536-deep products it
    strays past 1e-4 where the three products stay well inside it."""
    buf, w = moe_inputs(2, 40, 1536, 64)
    want = jref.moe_matmul_ref(jnp.asarray(buf), jnp.asarray(w))
    three = within(moe_split(torch.from_numpy(buf), torch.from_numpy(w)), want)
    with pytest.raises(AssertionError, match="beyond"):
        within(moe_split(torch.from_numpy(buf), torch.from_numpy(w), products=1), want)
    assert three < TOL / 4


# ---- B7: the backward's two launches in split TF32 -------------------------------


def within_max(got: torch.Tensor, want, tol: float = TOL) -> float:
    """The largest |got - want| over the largest |want|; asserts it is within ``tol``."""
    want_t = torch.from_numpy(np.array(want, dtype=np.float32))
    ratio = ((got - want_t).abs().max() / want_t.abs().max()).item()
    assert ratio <= tol, f"{ratio:.3e} beyond {tol}"
    return ratio


def moe_bwd_split(buf, w, dout, products: int = 3):
    """(dbuf, dw) as the tf32x3 backward sums them: dbuf = dout @ w^T (K = F) and dw = buf^T @
    dout (K = C), each ``moe_split``'s stages over its own K."""
    return (moe_split(dout, w.transpose(1, 2), products),
            moe_split(buf.transpose(1, 2), dout, products))


def moe_vjp(buf, w, dout):
    """(dbuf, dw) from ``jax.vjp`` of the JAX package's plain product."""
    _, pullback = jax.vjp(jref.moe_matmul_ref, jnp.asarray(buf), jnp.asarray(w))
    return pullback(jnp.asarray(dout))


def moe_bwd_inputs(E, C, D, F):
    rng = np.random.default_rng(7 * E + C + 3 * D + F)
    return (rng.standard_normal((E, C, D), dtype=np.float32),
            (0.05 * rng.standard_normal((E, D, F))).astype(np.float32),
            rng.standard_normal((E, C, F), dtype=np.float32))


# (E, C, D, F): granite's LM widths (gate/up, down) at a few experts, a ragged C (130), a small C
# (8), and D and F ragged multiples of 4
MOE_BWD_SHAPES = [(2, 40, 1536, 512), (2, 40, 512, 1536), (3, 130, 200, 72), (4, 8, 512, 48),
                  (1, 70, 100, 36), (2, 130, 36, 1540)]


@pytest.mark.parametrize("E,C,D,F", MOE_BWD_SHAPES)
def test_moe_backward_tf32x3_model_matches_jax(E, C, D, F):
    buf, w, dout = moe_bwd_inputs(E, C, D, F)
    plan = moe_mod.bwd_plan(E, C, D, F, torch.float32)
    assert plan.dbuf.route == plan.dw.route == "tf32x3"
    got = moe_bwd_split(*(torch.from_numpy(t) for t in (buf, w, dout)))
    for g, want in zip(got, moe_vjp(buf, w, dout)):
        within_max(g, want)


@pytest.mark.parametrize("which", ["dbuf", "dw"])
def test_moe_backward_one_tf32_product_misses_the_limit(which):
    """hi hi alone over a 1536-deep reduction (dbuf's F at granite's down product, dw's C
    here) strays past 1e-4 of the gradient's largest magnitude; the three products stay well
    inside it."""
    shape = (2, 40, 512, 1536) if which == "dbuf" else (1, 1536, 128, 64)
    buf, w, dout = moe_bwd_inputs(*shape)
    idx = 0 if which == "dbuf" else 1
    want = moe_vjp(buf, w, dout)[idx]
    args = [torch.from_numpy(t) for t in (buf, w, dout)]
    three = within_max(moe_bwd_split(*args)[idx], want)
    with pytest.raises(AssertionError, match="beyond"):
        within_max(moe_bwd_split(*args, products=1)[idx], want)
    assert three < TOL / 4


# ---- B4: three bf16 pieces, six products -----------------------------------------


def pieces(x: torch.Tensor, n: int):
    """x as n bf16 pieces (in f32): piece p = bf16(what pieces 0..p-1 left)."""
    out, rest = [], x
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def mm_pieces(a: torch.Tensor, b: torch.Tensor, k_step: int = 16, acc=None) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] with both in three bf16 pieces, per k-step of 16: from
    zero, the products of pieces i and j with i + j < 3, the smallest first (i + j = 2, 1,
    then 0), each exact in f32; then the k-step's sum added to the running f32 sum."""
    pa, pb = pieces(a, 3), pieces(b, 3)
    if acc is None:
        acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], k_step):
        ks = slice(k0, k0 + k_step)
        step = torch.zeros_like(acc)
        for total in (2, 1, 0):
            for i in range(total + 1):
                step = step + pa[i][..., ks] @ pb[total - i][..., ks, :]
        acc = acc + step
    return acc


def ssd_mma3(x, b, c, cum):
    """One chunk and head as the mma3 route computes it: x [Q, hd], b, c [Q, N], cum [Q] ->
    (y [Q, hd], state [hd, N]).  y: per 64-row tile and each 64-column tile j0 <= its rows,
    C B^T over N in 64-wide slices, then S = C B^T o L (exp only where q >= j) and y += S x
    over the tile's 16-column steps.  state: (x o exp(cum_last - cum))^T B over the rows j in
    16-row steps."""
    Q = x.shape[0]
    y = torch.zeros_like(x)
    for q0 in range(0, Q, 64):
        rows = slice(q0, min(Q, q0 + 64))
        acc = torch.zeros(rows.stop - q0, x.shape[1])
        for j0 in range(0, min(Q, q0 + 64), 64):
            cols = slice(j0, min(Q, j0 + 64))
            cb = torch.zeros(rows.stop - q0, cols.stop - j0)
            for n0 in range(0, b.shape[1], 64):
                ns = slice(n0, n0 + 64)
                cb = mm_pieces(c[rows, ns], b[cols, ns].T, acc=cb)
            q = torch.arange(q0, rows.stop)[:, None]
            j = torch.arange(j0, cols.stop)[None, :]
            diff = (cum[rows][:, None] - cum[cols][None, :]).masked_fill(q < j, 0.0)
            s = torch.where(q >= j, cb * torch.exp(diff), torch.zeros(()))
            acc = mm_pieces(s, x[cols], acc=acc)
        y[rows] = acc
    xw = x * torch.exp(cum[-1] - cum)[:, None]
    state = mm_pieces(xw.T.contiguous(), b)
    return y, state


# (BNC, H, Q, hd, N): mamba2's N 128 at two row tiles, hymba's N 16, ragged Q, the reduced hd 32
SSD_SHAPES = [(1, 2, 128, 64, 128), (2, 2, 100, 64, 16), (1, 1, 70, 32, 32), (2, 1, 1, 32, 16)]


@pytest.mark.parametrize("BNC,H,Q,hd,N", SSD_SHAPES)
def test_ssd_mma3_model_matches_jax(BNC, H, Q, hd, N):
    rng = np.random.default_rng(BNC * Q + hd * N)
    x = (0.5 * rng.standard_normal((BNC, H, Q, hd))).astype(np.float32)
    b = (0.5 * rng.standard_normal((BNC, Q, N))).astype(np.float32)
    c = (0.5 * rng.standard_normal((BNC, Q, N))).astype(np.float32)
    cum = -np.cumsum(0.1 * rng.random((BNC, H, Q)), -1).astype(np.float32)
    assert ssd_mod.launch_plan(BNC, H, Q, hd, N, torch.float32).route == "mma3"
    py, pst = jax_ssd.ssd_intra_chunk(*(jnp.asarray(t) for t in (x, b, c, cum)), interpret=True)
    tx, tb, tc, tcum = (torch.from_numpy(t) for t in (x, b, c, cum))
    for i in range(BNC):
        for h in range(H):
            y, st = ssd_mma3(tx[i, h], tb[i], tc[i], tcum[i, h])
            within(y, py[i, h])
            within(st, pst[i, h])
            ry, rst = jref.ssd_chunk_ref(*(jnp.asarray(t) for t in (x[i, h], b[i], c[i], cum[i, h])))
            within(y, ry)
            within(st, rst)


def test_three_bf16_pieces_hold_an_f32_value():
    """Three bf16 pieces (8 bits each) hold a normal f32 value's 24 bits exactly, so the
    dropped products (i + j >= 3) are what limits the route: ~2^-24 of each product."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    p0, p1, p2 = pieces(v, 3)
    assert torch.equal(p0 + p1 + p2, v)
    a, b = v[:2048].reshape(32, 64), v[2048:].reshape(64, 32)
    exact = a.double() @ b.double()
    err = ((mm_pieces(a, b).double() - exact).abs() / (a.double().abs() @ b.double().abs())).max()
    assert err < 2 ** -20
