"""B11 on the CPU: attention over keys of their own length, and its decode form.

The plain versions that ``kernels.ops`` runs for CPU tensors (and that
``chip_smoke.py`` holds the CUDA kernels against on the card) against the
JAX package on the same numpy inputs:

- the cross-attention forward through ``layers.multihead_attention(
  kv_override=..., causal=False, use_rope=False)`` on both sides, over
  Sk in {1, S, S + 37, 3 S} and GQA g in {1, 2}: 2e-5 in f32, 2e-2 in bf16
  (the reference's attention tolerances, tests/test_kernels.py);
- the decode over FLAT caches through ``decode_attention(update_cache=False)``
  at pos = Sk - 1, as whisper's decode step calls it: the same tolerances;
- the gradients through the layer against ``jax.vjp``: 1e-4 of the
  reference gradient's largest magnitude (summation order only, f32);
- the launch plans computed in Python: the forward's ``cross_plan`` (the
  keys of each (batch, head, row tile) split over a cluster of 1-8 blocks,
  whole key tiles, none empty, as many as one wave of two blocks an SM
  holds), the backward's dq grid over S and dkdv grid over Sk with
  warpgroups chosen by each length, and the decode's split of the keys over
  a cluster;
- the forward kernel's split-and-combine algorithm, modelled here in f32
  (per split an online softmax over 64-key tiles, then a fixed-order
  combine), against ``jl.multihead_attention`` and the row log-sum-exp
  through JAX at Sk 1500 (1250-2000 for the split counts 1500 keys cannot
  take) and 1-8 splits: 1e-5;
- the bf16 backward's plan (``cross_bwd_plan``: key tiles over 1-8 splits,
  each once and none empty, the dQ partial rows and the final sum's parts
  covering every query row once, shared memory, one block an SM, the split
  count the cost model picks, the partials' place) and its one pass,
  modelled in f32 (statistics, 64-key warpgroups, key tiles added in
  order, the splits' partials summed in split order), against ``jax.vjp``
  of the layer at 1-8 splits, d 64 and 128: 1e-5 of each gradient's
  largest magnitude (~1 s the plan cases, ~4 s the model cases);
- that ``ops`` sends CPU tensors to the plain versions and launches nothing,
  that the kernel wrappers refuse CPU tensors and causal attention over keys
  of another length, and that B2's ``flash_attention`` refuses bf16 keys of
  another length (they are ``cross_attention``'s).

The card's counterparts are in tests/test_torch_gpu.py (marker ``gpu``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as tl

from _torch_parity import chip_smoke, np32, torch_cfg

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
S = 8


def cfg_pair(heads, kv, dtype="float32", head_dim=64, d_model=128):
    jcfg = JaxModelConfig(
        name="cross", family="dense", num_layers=1, d_model=d_model, num_heads=heads,
        num_kv_heads=kv, d_ff=96, vocab_size=100, head_dim=head_dim, dtype=dtype,
        rope_theta=10_000.0,
    )
    return jcfg, torch_cfg(jcfg)


def params(rng, cfg, dtype):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d)}
    p = {k: rng.standard_normal(s, dtype=np.float32) * 0.1 for k, s in shapes.items()}
    jd, td, _ = DTYPES[dtype]
    return ({k: jnp.asarray(v, jd) for k, v in p.items()},
            {k: torch.from_numpy(v).to(td) for k, v in p.items()})


def both(a, dtype):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def close(got, want, tol):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sk", [1, S, S + 37, 3 * S])
@pytest.mark.parametrize("heads,kv", [(2, 2), (4, 2)])  # g 1 and 2
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_forward_matches_jax(Sk, heads, kv, dtype):
    jcfg, tcfg = cfg_pair(heads, kv, dtype)
    rng = np.random.default_rng(Sk * 10 + heads)
    jp, tp = params(rng, jcfg, dtype)
    hd = jcfg.resolved_head_dim
    xj, xt = both(rng.standard_normal((2, S, jcfg.d_model), dtype=np.float32), dtype)
    kj, kt = both(rng.standard_normal((2, Sk, kv, hd), dtype=np.float32), dtype)
    vj, vt = both(rng.standard_normal((2, Sk, kv, hd), dtype=np.float32), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    want = jax.jit(lambda p, x, k, v: jl.multihead_attention(
        p, x, jnp.asarray(pos), jcfg, kv_override=(k, v), causal=False, use_rope=False))(jp, xj, kj, vj)
    ops.reset_launch_counts()
    got = tl.multihead_attention(tp, xt, torch.from_numpy(pos), tcfg, kv_override=(kt, vt),
                                 causal=False, use_rope=False)
    assert got.dtype == xt.dtype and got.shape == (2, S, jcfg.d_model)
    assert not any(ops.launch_counts().values())
    close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("Sk", [1, S, S + 37])
@pytest.mark.parametrize("heads,kv", [(2, 2), (4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_decode_matches_jax(Sk, heads, kv, dtype):
    """One token against FLAT caches it does not update, at pos = Sk - 1 (whisper's decode)."""
    jcfg, tcfg = cfg_pair(heads, kv, dtype)
    rng = np.random.default_rng(Sk * 7 + heads)
    jp, tp = params(rng, jcfg, dtype)
    W = kv * jcfg.resolved_head_dim
    xj, xt = both(rng.standard_normal((2, 1, jcfg.d_model), dtype=np.float32), dtype)
    kj, kt = both(rng.standard_normal((2, Sk, W), dtype=np.float32), dtype)
    vj, vt = both(rng.standard_normal((2, Sk, W), dtype=np.float32), dtype)
    want, _, _ = jax.jit(lambda *a: jl.decode_attention(*a, jcfg, update_cache=False, use_rope=False))(
        jp, xj, jnp.asarray(Sk - 1, jnp.int32), kj, vj)
    got = tl.decode_attention(tp, xt, Sk - 1, (kt, vt), tcfg, update_cache=False, use_rope=False)
    assert got.dtype == xt.dtype and got.shape == (2, 1, jcfg.d_model)
    close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("Sk", [1, S + 37])
@pytest.mark.parametrize("heads,kv", [(2, 2), (4, 2)])
def test_cross_attention_grads_match_jax(Sk, heads, kv):
    """d(x, k, v, wq, wo) of the cross-attention layer against jax.vjp, f32: 1e-4 of the
    reference gradient's largest magnitude."""
    jcfg, tcfg = cfg_pair(heads, kv)
    rng = np.random.default_rng(Sk + heads)
    jp, tp = params(rng, jcfg, "float32")
    hd = jcfg.resolved_head_dim
    x = rng.standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    k = rng.standard_normal((2, Sk, kv, hd), dtype=np.float32)
    v = rng.standard_normal((2, Sk, kv, hd), dtype=np.float32)
    dout = rng.standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()

    def jfn(x, k, v, wq, wo):
        p = {**jp, "wq": wq, "wo": wo}
        return jl.multihead_attention(p, x, jnp.asarray(pos), jcfg, kv_override=(k, v),
                                      causal=False, use_rope=False)

    want = jax.jit(lambda *a: jax.vjp(jfn, *a)[1](jnp.asarray(dout)))(
        *(jnp.asarray(a) for a in (x, k, v)), jp["wq"], jp["wo"])
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, k, v)]
    wq, wo = (tp[n].clone().requires_grad_() for n in ("wq", "wo"))
    out = tl.multihead_attention({**tp, "wq": wq, "wo": wo}, leaves[0], torch.from_numpy(pos), tcfg,
                                 kv_override=(leaves[1], leaves[2]), causal=False, use_rope=False)
    got = torch.autograd.grad(out, [*leaves, wq, wo], torch.from_numpy(dout))
    for name, g, w in zip(("x", "k", "v", "wq", "wo"), got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err, np.abs(w).max())


def test_plain_cross_attention_is_the_einsum_it_replaces():
    """ref.flash_attention_ref at Sk != S is what layers.cross_attention computed before
    B11: f32 scores and softmax, the weights rounded to q's type before P.V (bf16)."""
    rng = np.random.default_rng(3)
    B, H, KV, Sk, d = 2, 6, 2, 45, 64
    q = torch.from_numpy(rng.standard_normal((B, S, H, d), dtype=np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, KV, d), dtype=np.float32)).bfloat16()
            for _ in range(2))
    qg = q.reshape(B, S, KV, H // KV, d)
    scores = torch.einsum("bqngd,bknd->bngqk", qg.float(), k.float()) / math.sqrt(d)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    einsum = torch.einsum("bngqk,bknd->bqngd", w, v).reshape(B, S, H * d)
    got = ops.cross_attention_op(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    close(got.transpose(1, 2).reshape(B, S, H * d), einsum, 1e-2)  # one bf16 step at most
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=False).float(), rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 17, 45])
def test_plain_decode_reads_the_first_n_keys(n):
    """decode_attention_ref over the first n keys equals the masked softmax over all of them."""
    rng = np.random.default_rng(n)
    B, H, KV, Sk, d = 2, 4, 2, 45, 64
    q = torch.from_numpy(rng.standard_normal((B, H, 1, d), dtype=np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((B, Sk, KV * d), dtype=np.float32)) for _ in range(2))
    got = ops.decode_attention_op(q, kc, vc, n)
    qg = q.reshape(B, KV, H // KV, 1, d)
    scores = torch.einsum("bngqd,bknd->bngqk", qg, kc.view(B, Sk, KV, d)) / math.sqrt(d)
    scores = scores.masked_fill(torch.arange(Sk) >= n, ref.NEG_INF)
    want = torch.einsum("bngqk,bknd->bqngd", torch.softmax(scores, -1), vc.view(B, Sk, KV, d))
    assert got.shape == (B, 1, H * d)
    close(got, want.reshape(B, 1, H * d), 1e-6)


# ---------------------------------------------------------------------------
# launch plans, decided in Python and checked again by the kernels on the card
# ---------------------------------------------------------------------------

# (B, H, KV, S, Sk, d): whisper's prefill and training shapes, the chip phases' tails
CROSS_PLAN_SHAPES = [(4, 16, 16, 128, 1500, 64), (2, 16, 16, 448, 1500, 64), (2, 4, 4, 1, 1500, 64),
                     (2, 8, 2, 65, 63, 64), (2, 14, 2, 65, 1, 64), (2, 8, 2, 100, 1500, 128),
                     (2, 2, 2, 300, 200, 64), (2, 2, 2, 200, 300, 64)]


@pytest.mark.parametrize("B,H,KV,S,Sk,d", CROSS_PLAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_launch_plans(B, H, KV, S, Sk, d, dtype):
    fwd = flash_mod.cross_plan(B, H, KV, S, Sk, d, dtype)  # query tiles of S, each split's keys of Sk
    assert math.prod(fwd.grid) == fwd.splits * H * B * -(-S // fwd.block_q)
    dq, dkdv = flash_mod.bwd_plans(B, H, KV, S, d, dtype, Sk)
    assert dq.grid == (H, -(-S // dq.block_q), B)  # a block per (query head, row tile of S)
    assert dkdv.grid == (-(-Sk // dkdv.block_k), KV, B)  # a block per (KV head, key tile of Sk)
    same_q, same_k = (flash_mod.bwd_plans(B, H, KV, n, d, dtype) for n in (S, Sk))
    assert dq == same_q[0]  # dq is planned by S alone
    assert (dkdv.block_k, dkdv.threads, dkdv.smem_bytes) == (
        same_k[1].block_k, same_k[1].threads, same_k[1].smem_bytes)  # dkdv by Sk alone
    if dtype == torch.bfloat16:
        assert dq.block_q == 64 * flash_mod.dq_warpgroups(S)
        assert dkdv.block_k == 64 * flash_mod.dkdv_warpgroups(Sk, d)
        assert dkdv.block_k == (128 if Sk > 256 and d == 64 else 64)
    for plan in (fwd, dq, dkdv):
        assert plan.smem_bytes <= _build.MAX_SMEM_BYTES


WHISPER_CROSS = [(4, 16, 16, 128, 1500, 64), (2, 16, 16, 448, 1500, 64), (4, 16, 16, 159, 1500, 64)]
CROSS_FWD_PLAN_SHAPES = sorted(set(CROSS_PLAN_SHAPES + WHISPER_CROSS) | {
    (2, 8, 2, S, Sk, d) for S in (1, 65, 300) for Sk in (1, 63, 64, 65, 1500) for d in (64, 128)})


@pytest.mark.parametrize("B,H,KV,S,Sk,d", CROSS_FWD_PLAN_SHAPES)
def test_cross_forward_plan_splits_whole_tiles_over_a_cluster(B, H, KV, S, Sk, d):
    plan = flash_mod.cross_plan(B, H, KV, S, Sk, d, torch.bfloat16)
    bk = flash_mod.cross_key_tile(d)  # 128 keys at d 64, 64 at d 128
    assert (plan.route, plan.block_q, plan.block_k, plan.threads) == ("wgmma", 64, bk, 160)
    assert 1 <= plan.splits <= flash_mod.CROSS_MAX_SPLITS  # a portable cluster
    assert plan.chunk % bk == 0 and plan.chunk % 64 == 0  # whole key tiles
    assert (plan.splits - 1) * plan.chunk < Sk <= plan.splits * plan.chunk  # every split holds keys
    # the splits of a (batch, head, row tile) adjacent, then the heads, a KV head's g together
    groups = B * H * -(-S // 64)
    assert plan.grid == (plan.splits, -(-S // 64) * H, B)
    stages = 3 if d == 64 else 2
    ring = max(stages * 2 * 2 * bk * d, 128 * (d // 2 + 4) * 4)  # K/V tiles, then the partials
    assert plan.smem_bytes == 1024 + 2 * 64 * d + ring + 8 * (1 + 2 * stages)
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024  # two blocks an SM, 1 KB reserved each
    assert plan.smem_bytes <= _build.MAX_SMEM_BYTES
    # one wave of two blocks an SM, as many splits as it holds (a second wave costs more)
    slots, key_tiles = flash_mod.CROSS_BLOCKS_PER_SM * _build.NUM_SMS, -(-Sk // bk)
    want = max(1, min(flash_mod.CROSS_MAX_SPLITS, key_tiles, slots // groups))
    assert plan.splits == -(-key_tiles // -(-key_tiles // want))  # then none left empty
    assert math.prod(plan.grid) <= max(slots, groups)
    if (B, H, KV, S, Sk, d) in WHISPER_CROSS:  # whisper: more than half of the slots filled
        assert math.prod(plan.grid) > slots // 2
    if (B, S) == (4, 128):  # the prefill: 128 groups of rows, two splits each
        assert (plan.splits, plan.chunk) == (2, 768)
    f32 = flash_mod.cross_plan(B, H, KV, S, Sk, d, torch.float32)  # B2's split-TF32 plan, one split
    assert (f32.route, f32.splits) == ("tf32x3", 1) and f32.chunk >= Sk
    assert f32.grid == flash_mod.launch_plan(B, H, S, d, torch.float32).grid


def split_combine(q, k, v, splits):
    """The bf16 kernel's algorithm in f32 numpy, without its bf16 roundings: q [B, H, S, d],
    k, v [B, KV, Sk, d] -> (out [B, H, S, d], lse [B, H, S]).  The keys are cut into
    ``splits`` chunks of whole key tiles (128 keys at d 64); each chunk runs an online softmax tile by tile
    (log2 units of the scaled scores), leaving (m, l, unnormalised O); the chunks are then
    combined in order, chunk 0 first."""
    B, H, S, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    scale_log2 = np.float32(math.log2(math.e) / math.sqrt(d))
    bk = flash_mod.cross_key_tile(d)
    tiles = -(-Sk // bk)
    chunk = bk * -(-tiles // splits)
    assert (splits - 1) * chunk < Sk <= splits * chunk
    kh = np.repeat(k, H // KV, axis=1)  # a KV head's g query heads read its keys
    vh = np.repeat(v, H // KV, axis=1)
    parts = []
    for sp in range(splits):
        m = np.full((B, H, S), -np.inf, np.float32)
        l = np.zeros((B, H, S), np.float32)
        o = np.zeros((B, H, S, d), np.float32)
        for k0 in range(sp * chunk, min(Sk, sp * chunk + chunk), bk):
            sc = np.einsum("bhsd,bhkd->bhsk", q, kh[:, :, k0:k0 + bk]).astype(np.float32)
            mx = np.maximum(m, sc.max(-1) * scale_log2)
            p = np.exp2(sc * scale_log2 - mx[..., None]).astype(np.float32)
            alpha = np.exp2(m - mx).astype(np.float32)
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + np.einsum("bhsk,bhkd->bhsd", p, vh[:, :, k0:k0 + bk])
            m = mx
        parts.append((m, l, o))
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = np.maximum(mx, m)
    l_all = np.zeros_like(mx)
    o_all = np.zeros_like(parts[0][2])
    for m, l, o in parts:
        w = np.exp2(m - mx).astype(np.float32)
        l_all = l_all + l * w
        o_all = o_all + o * w[..., None]
    return o_all / l_all[..., None], (mx + np.log2(l_all)) * np.float32(math.log(2))


# 1500 keys are 12 tiles of 128, which no 5, 7 or 8 chunks of whole tiles share without one
# empty: those splits are held at 10, 14 and 16 tiles
@pytest.mark.parametrize("splits,Sk", [(n, 1500) for n in (1, 2, 3, 4, 6)] + [(5, 1250), (7, 1750), (8, 2000)])
def test_split_combine_matches_jax(splits, Sk):
    """The forward kernel's split-and-combine, modelled in f32, against the JAX layer (out,
    projected by wo) and the rows' log-sum-exp through JAX, at whisper's 1500 keys (and
    near it where 1500 cannot be split so): 1e-5."""
    jcfg, tcfg = cfg_pair(4, 2)
    rng = np.random.default_rng(100 + splits)
    jp, _ = params(rng, jcfg, "float32")
    B, H, KV, hd = 1, 4, 2, jcfg.resolved_head_dim
    x = rng.standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    k = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    pos = jnp.asarray(np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)))

    def jfn(p, x, k, v):
        out = jl.multihead_attention(p, x, pos, jcfg, kv_override=(k, v), causal=False, use_rope=False)
        qg = (x @ p["wq"]).reshape(B, S, KV, H // KV, hd)
        scores = jnp.einsum("bqngd,bknd->bngqk", qg, k) / math.sqrt(hd)
        return out, jax.nn.logsumexp(scores, axis=-1).reshape(B, H, S), x @ p["wq"]

    want, want_lse, q = (np.asarray(a) for a in jax.jit(jfn)(jp, x, k, v))
    got, lse = split_combine(q.reshape(B, S, H, hd).transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                             v.transpose(0, 2, 1, 3), splits)
    close(got.transpose(0, 2, 1, 3).reshape(B, S, H * hd) @ np.asarray(jp["wo"]), want, 1e-5)
    close(lse, want_lse, 1e-5)


# (B, H, KV, S, Sk, d): the forward's shapes, whisper's LM shape at its two lengths past the
# rows shared memory holds (S 1024; g 7 at S 448), and Sk across one, two and eight key tiles
CROSS_BWD_PLAN_SHAPES = sorted(set(CROSS_FWD_PLAN_SHAPES) | {
    (2, 16, 16, 1024, 1500, 64), (2, 14, 2, 448, 1500, 64), (2, 14, 2, 160, 1500, 128),
    (1, 2, 2, 64, 1000, 64), (2, 8, 2, 129, 257, 64), (2, 2, 2, 512, 128, 64), (2, 2, 2, 513, 128, 64)})


@pytest.mark.parametrize("B,H,KV,S,Sk,d", CROSS_BWD_PLAN_SHAPES)
def test_cross_backward_plan_covers_every_key_and_row_once(B, H, KV, S, Sk, d):
    """cross_bwd_plan: the splits' key tiles cover Sk once, none empty, at most 8 splits; the
    rows of the dQ partials cover every query row of a KV head's g heads once, and the final
    sum's parts (whole rows) cover them once; shared memory within a block's; one block an
    SM, and the split count that least multiplies the grid's waves by a block's tiles."""
    plan = flash_mod.cross_bwd_plan(B, H, KV, S, Sk, d)
    g, bk = H // KV, 128 if d == 64 else 64
    assert (plan.block_k, plan.warpgroups, plan.threads) == ((128, 2, 384) if d == 64 else (64, 1, 160))
    assert plan.key_tiles == -(-Sk // bk) and plan.grid == (plan.splits, KV, B)
    assert 1 <= plan.splits <= min(8, plan.key_tiles)
    tiles = [list(range(r, plan.key_tiles, plan.splits)) for r in range(plan.splits)]
    assert sorted(t for ts in tiles for t in ts) == list(range(plan.key_tiles))  # each key tile once
    assert all(tiles) and plan.tiles_per_block == max(map(len, tiles))  # no split without keys
    assert plan.rows == g * -(-S // 64) * 64 >= g * S  # each query row of the g heads has a row
    per = -(-plan.rows // plan.splits)  # the final sum's parts, whole rows
    parts = [range(p * per, min(plan.rows, (p + 1) * per)) for p in range(plan.splits)]
    assert sorted(r for p in parts for r in p) == list(range(plan.rows))
    whole = flash_mod.cross_bwd_smem(d, plan.rows)
    assert plan.region == ("smem" if whole <= _build.MAX_SMEM_BYTES else "global")
    assert plan.smem_bytes == (whole if plan.region == "smem" else flash_mod.cross_bwd_smem(d))
    assert plan.smem_bytes <= _build.MAX_SMEM_BYTES
    # one block an SM: 384 threads at 168 registers (64512 of 65536) or 160 at 255
    regs = plan.threads * (168 if d == 64 else 255)
    assert 65536 // 2 < regs <= 65536

    def cost(n):
        return -(-n * KV * B // _build.NUM_SMS) * -(-plan.key_tiles // n)

    assert cost(plan.splits) == min(cost(n) for n in range(1, min(8, plan.key_tiles) + 1))
    assert all(cost(n) > cost(plan.splits) for n in range(1, plan.splits))  # the smallest of equals
    assert plan.stats_blocks == -(-(B * H * S) // (8 * (32 // (d // 8))))
    if (B, H, KV, S, Sk, d) == (2, 16, 16, 448, 1500, 64):  # whisper's LM step: one wave
        assert (plan.splits, plan.tiles_per_block, plan.region) == (4, 3, "smem")
        assert math.prod(plan.grid) == 128 <= _build.NUM_SMS
    if (S, Sk, d) == (1024, 1500, 64) or g * S > 600:  # past the rows shared memory holds
        assert plan.region == "global"


def one_pass_bwd(q, k, v, o, lse, dout, splits, bk):
    """B11's bf16 backward as the kernels run it, modelled in f32: the statistics pass (D,
    lse log2 e), then per (batch, KV head) ``splits`` blocks over 64-row units and key tiles
    of ``bk`` keys (r, r + splits, ...), 64-key warpgroups whose dQ partials the second adds
    to the first's, a block's partials added up over its key tiles in order, and dQ the
    splits' partials summed in split order.  q, o, dout [B, H, S, d]; k, v [B, KV, Sk, d]."""
    f32 = np.float32
    B, H, S, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g, n_qt, key_tiles = H // KV, -(-S // 64), -(-Sk // bk)
    scale = f32(1 / math.sqrt(d))
    l2e = f32(math.log2(math.e))
    delta = (dout * o).sum(-1, dtype=f32)
    lse2 = (lse * l2e).astype(f32)
    dq = np.zeros(q.shape, f32)
    dk, dv = np.zeros(k.shape, f32), np.zeros(v.shape, f32)
    for b in range(B):
        for kvh in range(KV):
            parts = []
            for r in range(splits):
                region = np.zeros((g, n_qt * 64, d), f32)
                for js, kt in enumerate(range(r, key_tiles, splits)):
                    keys = slice(kt * bk, min(Sk, kt * bk + bk))
                    kk, vv = k[b, kvh, keys], v[b, kvh, keys]
                    dka, dva = np.zeros(kk.shape, f32), np.zeros(vv.shape, f32)
                    for hl in range(g):
                        h = kvh * g + hl
                        for qt in range(n_qt):
                            rows = slice(qt * 64, min(S, qt * 64 + 64))
                            qq, dd = q[b, h, rows], dout[b, h, rows]
                            pt = np.exp2(kk @ qq.T * (scale * l2e) - lse2[b, h, rows]).astype(f32)
                            dst = (pt * (vv @ dd.T - delta[b, h, rows])).astype(f32)
                            dva += pt @ dd
                            dka += dst @ qq
                            # each 64-key warpgroup's partial; the second's plus the first's
                            wgs = [dst[w:w + 64].T @ kk[w:w + 64] for w in range(0, kk.shape[0], 64)]
                            part = wgs[0] if len(wgs) == 1 else (wgs[1] + wgs[0]).astype(f32)
                            out = region[hl, rows]
                            region[hl, rows] = part if js == 0 else part + out
                    dk[b, kvh, keys], dv[b, kvh, keys] = dka * scale, dva
                parts.append(region)
            total = parts[0]
            for p in parts[1:]:  # split order
                total = total + p
            for hl in range(g):
                dq[b, kvh * g + hl] = total[hl, :S] * scale
    return dq, dk, dv


# whisper's split count (4) and the others its 1500 frames can take, one split, and d 128
# (64-key tiles, one warpgroup a block) at 1500 and at 700 keys
@pytest.mark.parametrize("splits,Sk,hd", [(4, 1500, 64), (1, 1500, 64), (2, 1500, 64), (3, 1500, 64),
                                          (8, 1500, 64), (8, 1500, 128), (5, 700, 128)])
def test_one_pass_backward_sum_matches_jax(splits, Sk, hd):
    """The one-pass backward's fixed-order sums across warpgroups, key tiles and splits,
    modelled in f32, against jax.vjp of the cross-attention layer (d x through wq, d k, d v)
    at 70 queries (a ragged second query tile), g 2: 1e-5 of each gradient's largest."""
    S70 = 70
    jcfg, _ = cfg_pair(4, 2, head_dim=hd)
    rng = np.random.default_rng(300 + splits + hd)
    jp, _ = params(rng, jcfg, "float32")
    B, H, KV = 1, 4, 2
    x = rng.standard_normal((B, S70, jcfg.d_model), dtype=np.float32)
    k = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    dy = rng.standard_normal((B, S70, jcfg.d_model), dtype=np.float32)
    pos = jnp.asarray(np.broadcast_to(np.arange(S70, dtype=np.int32), (B, S70)))

    def jfn(x, k, v):
        return jl.multihead_attention(jp, x, pos, jcfg, kv_override=(k, v), causal=False, use_rope=False)

    want = jax.jit(lambda *a: jax.vjp(jfn, *a)[1](jnp.asarray(dy)))(x, k, v)
    wq, wo = np.asarray(jp["wq"]), np.asarray(jp["wo"])
    q = (x @ wq).reshape(B, S70, H, hd).transpose(0, 2, 1, 3)
    kt, vt = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    qg = q.astype(np.float64).reshape(B, KV, H // KV, S70, hd)
    scores = np.einsum("bngsd,bnkd->bngsk", qg, kt.astype(np.float64)) / math.sqrt(hd)
    lse = np.log(np.exp(scores - scores.max(-1, keepdims=True)).sum(-1)) + scores.max(-1)
    o = np.einsum("bngsk,bnkd->bngsd", np.exp(scores - lse[..., None]), vt.astype(np.float64))
    dout = (dy @ wo.T).reshape(B, S70, H, hd).transpose(0, 2, 1, 3)
    dq, dk, dv = one_pass_bwd(q, kt, vt, o.reshape(B, H, S70, hd).astype(np.float32),
                              lse.reshape(B, H, S70).astype(np.float32), dout, splits, 128 if hd == 64 else 64)
    dx = dq.transpose(0, 2, 1, 3).reshape(B, S70, H * hd) @ wq.T
    for name, got, w in (("x", dx, want[0]), ("k", dk.transpose(0, 2, 1, 3), want[1]),
                         ("v", dv.transpose(0, 2, 1, 3), want[2])):
        w = np.asarray(w)
        err = np.abs(got - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.mark.parametrize("B,H,KV,n,d", [(4, 16, 16, 1500, 64), (1, 16, 16, 1500, 64), (4, 16, 4, 1500, 128),
                                        (2, 14, 2, 777, 64), (4, 32, 8, 100, 128), (2, 2, 2, 1, 64),
                                        (2, 6, 2, 129, 64), (64, 16, 16, 1500, 64)])
def test_decode_plan_splits_the_keys_over_a_cluster(B, H, KV, n, d):
    plan = flash_mod.decode_plan(B, H, KV, n, d)
    g = H // KV
    assert plan.rows == (1 if g == 1 else 2 if g == 2 else 4)
    tiles = -(-g // plan.rows)
    assert plan.grid == (plan.splits, KV * tiles, B) and plan.threads == 128
    assert 1 <= plan.splits <= 8  # a portable cluster
    assert (plan.splits - 1) * plan.chunk < n <= plan.splits * plan.chunk  # every split has keys
    assert plan.splits == 1 or plan.chunk >= flash_mod.DECODE_KEYS_PER_SPLIT // 2
    assert plan.smem_bytes == 4 * 4 * plan.rows * (2 + d) <= 48 * 1024  # static shared memory
    if (B, H, KV, n) == (4, 16, 16, 1500):  # whisper's decode: 64 pairs, 8 splits of 188 keys
        assert (plan.splits, plan.chunk) == (8, 188)
        assert math.prod(plan.grid) >= 2 * _build.NUM_SMS


# ---------------------------------------------------------------------------
# routing, refusals, counts
# ---------------------------------------------------------------------------


def test_ops_send_cpu_tensors_to_the_plain_versions():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, S, 64), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 45, 64), dtype=np.float32)) for _ in range(2))
    kc, vc = (torch.from_numpy(rng.standard_normal((2, 45, 128), dtype=np.float32)) for _ in range(2))
    ops.reset_launch_counts()
    assert torch.equal(ops.cross_attention_op(q, k, v), ref.flash_attention_ref(q, k, v, causal=False))
    q1 = q[:, :, :1]
    assert torch.equal(ops.decode_attention_op(q1, kc, vc, 45), ref.decode_attention_ref(q1, kc, vc, 45))
    leaf = q.clone().requires_grad_()
    ops.cross_attention_op(leaf, k, v).sum().backward()  # autograd through the plain version
    assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())
    assert not any(ops.launch_counts().values())


def test_kernel_wrappers_refuse_cpu_tensors_and_causal_keys_of_another_length():
    q = torch.zeros(1, 2, 8, 64)
    k = torch.zeros(1, 2, 9, 64)
    with pytest.raises(ValueError, match="causal"):
        flash_mod.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="causal"):
        flash_mod.flash_attention_bwd_dq(q, k, k, q, torch.zeros(1, 2, 8), q, causal=True)
    with pytest.raises(ValueError, match="causal"):
        ref.flash_attention_ref(q, k, k, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.cross_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.flash_attention(q, k, k, causal=False)
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.cross_attention_bwd(q, k, k, q, torch.zeros(1, 2, 8), q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.flash_decode(q[:, :, :1], torch.zeros(1, 9, 128), torch.zeros(1, 9, 128), 9)
    assert not any(ops.launch_counts()[n] for n in ops.launch_counts())


def test_b2_refuses_bf16_keys_of_another_length_and_b11_takes_any():
    """Keys of their own length in bf16 are cross_attention's: B2's flash_attention and B5's
    backward kernels refuse them before they look for a card, and B11 still takes keys of
    q's own length."""
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 9, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cross_attention"):
        flash_mod.flash_attention(q, k, k, causal=False)
    lse = torch.zeros(1, 2, 8)
    for bwd in (lambda: flash_mod.flash_attention_bwd_dq(q, k, k, q, lse, q, causal=False),
                lambda: flash_mod.flash_attention_bwd_dkdv(q, k, k, q, lse, torch.zeros(2, 1, 2, 8),
                                                           causal=False)):
        with pytest.raises(ValueError, match="cross_attention_bwd"):  # so are B5's kernels
            bwd()
    with pytest.raises(ValueError, match="CUDA"):  # the same length: only the CPU is refused
        flash_mod.cross_attention(q, q, q)
    plan = flash_mod.cross_plan(1, 2, 2, 8, 8, 64, torch.bfloat16)
    assert (plan.splits, plan.chunk, plan.grid) == (1, 128, (1, 2, 1))
    rng = np.random.default_rng(5)
    qf = torch.from_numpy(rng.standard_normal((2, 4, S, 64), dtype=np.float32))
    kf = torch.from_numpy(rng.standard_normal((2, 2, S, 64), dtype=np.float32))
    assert torch.equal(ops.cross_attention_op(qf, kf, kf), ref.flash_attention_ref(qf, kf, kf, causal=False))
    assert not any(ops.launch_counts()[n] for n in ops.launch_counts())


@pytest.mark.parametrize("args,err,match", [
    (((1, 2, 1, 64), (1, 9, 128)), ValueError, "1..9 keys"),  # n = 10 past the cache
    (((1, 2, 2, 64), (1, 9, 128)), ValueError, "q \\[B,H,1,d\\]"),  # two queries a row
    (((1, 3, 1, 64), (1, 9, 128)), ValueError, "multiple of kv heads"),  # 3 heads on 2
    (((1, 2, 1, 32), (1, 9, 64)), ValueError, "head dim"),
    (((2, 2, 1, 64), (1, 9, 128)), ValueError, "caches"),  # batch differs
])
def test_decode_kernel_rejects_what_it_does_not_take(args, err, match):
    qs, cs = args
    n = 10 if match == "1..9 keys" else 9
    with pytest.raises(err, match=match):
        flash_mod.flash_decode(torch.zeros(qs), torch.zeros(cs), torch.zeros(cs), n)


def test_whisper_launch_counts_name_b11():
    """chip_smoke.path_launches: whisper's decoder launches B11 once a layer per forward and
    decode step, again under recompute, and its two backward kernels once a layer a step."""
    cfg = get_config("whisper-medium")
    L = cfg.num_layers
    cs = chip_smoke()
    serve = cs.path_launches(cfg, 1, 31)
    assert (serve["cross_attention"], serve["flash_decode"]) == (L, 31 * L)
    assert serve["flash_attention"] == cfg.encoder_layers + L
    train = cs.path_launches(cfg, 0, 0, train_steps=3)
    assert train["cross_attention"] == 2 * 3 * L  # forward, and again under recompute
    assert train["cross_attention_bwd_stats"] == train["cross_attention_bwd_fused"] == 3 * L
    off = cs.path_launches(dataclasses.replace(cfg, remat=False), 0, 0, train_steps=3)
    assert off["cross_attention"] == 3 * L
    llama = cs.path_launches(get_config("llama3.2-1b"), 1, 31, train_steps=1)
    assert not any(llama[k] for k in ("cross_attention", "cross_attention_bwd_stats",
                                      "cross_attention_bwd_fused", "flash_decode"))


def test_chip_smoke_shape_keys_read_as_hold_at_shape_reads_them():
    """The keys that chip_smoke.py records at a wrapper's call, in the model's layouts, are
    the (dims..., dtype) tuples of its phase-3 cases and of hold_at_shape."""
    cs = chip_smoke()
    B, H, KV, S, Sk, d = 2, 6, 2, 5, 11, 16
    q = torch.zeros(B, S, H, d).transpose(1, 2)
    k = torch.zeros(B, Sk, KV, d).transpose(1, 2)
    assert cs.cross_key(q, k, k, lse=True) == (B, H, KV, S, Sk, d, torch.float32)
    kc = torch.zeros(B, Sk, KV * d)
    assert cs.decode_key(q[:, :, :1], kc, kc, 7) == (B, H, KV, Sk, 7, d, torch.float32)
    gen = torch.Generator().manual_seed(1)
    for kernel, key in (("cross_attention", cs.cross_key(q, k, k)),
                        ("cross_attention_bwd", cs.cross_key(q, k, k)),
                        ("flash_decode", cs.decode_key(q[:, :, :1], kc, kc, 7))):
        assert cs.hold_at_shape(kernel, key, "cpu", gen) == 0.0


# chip_smoke.py holds a kernel at any launched shape that no case of its phases covered
HOLD_CASES = [("cross_attention", (2, 4, 2, 9, 21, 16, torch.float32)),
              ("cross_attention_bwd", (1, 4, 2, 7, 30, 16, torch.float32)),
              ("flash_decode", (2, 6, 2, 40, 33, 16, torch.float32))]
HOLD_OPS = {"cross_attention": "cross_attention_op", "flash_decode": "decode_attention_op"}


@pytest.mark.parametrize("kernel,key", HOLD_CASES, ids=[k for k, _ in HOLD_CASES])
def test_chip_smoke_holds_b11_where_it_was_launched(kernel, key, monkeypatch):
    cs = chip_smoke()
    gen = torch.Generator().manual_seed(0)
    assert cs.hold_at_shape(kernel, key, "cpu", gen) == 0.0
    fname = HOLD_OPS[kernel.removesuffix("_bwd")]
    right = getattr(ops, fname)
    monkeypatch.setattr(ops, fname, lambda *a, **kw: right(*a, **kw) * 1.1)
    with pytest.raises(AssertionError, match="held where it was launched"):
        cs.hold_at_shape(kernel, key, "cpu", gen)
