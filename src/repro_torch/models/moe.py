"""Mixture-of-Experts FFN with sort-based static-capacity dispatch.

Torch twin of ``repro.models.moe``'s global path (``_moe_ffn_global``):
token-choice top-k routing, a static per-expert capacity
``C = ceil(T * k / E * capacity_factor)`` (rounded up to 128, or to 8 below
128), dispatch by a stable argsort over expert ids into an ``[E, C, D]``
buffer, the three expert products through ``ops.moe_matmul_op`` (the
hand-written kernel on the card), and a combine weighted by the
renormalised router probabilities.  Assignments past an expert's capacity
are dropped.

With live rules (a DTensor x on a mesh whose data extent G > 1 divides the
batch) ``moe_ffn`` takes the sharded dispatch, ``_moe_ffn_sharded``: each
(data, model) rank routes its own block of tokens and builds only its slice
of E_pad / M experts (E padded to the model extent; dead experts get no
tokens and no gradient), runs the expert products on that slice through
``ops.moe_matmul_op``, combines its slice's contribution and sums the
[T_loc, D] result over the model axis.  The aux losses come from per-shard
partials, as in repro/models/moe.py:177-392.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef
from repro_torch.sharding.rules import is_dtensor


def moe_schema(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    return {
        "router": ParamDef((d, e), ("embed", None)),
        "w_gate": ParamDef((e, d, f), ("expert", "embed", "mlp")),
        "w_up": ParamDef((e, d, f), ("expert", "embed", "mlp")),
        "w_down": ParamDef((e, f, d), ("expert", "mlp", "embed")),
    }


def expert_capacity(tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor)
    if c >= 128:
        return ((c + 127) // 128) * 128
    return max(8, ((c + 7) // 8) * 8)


def moe_ffn(
    params, x: torch.Tensor, cfg: ModelConfig, rules=None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, D] -> (y [B, S, D], {"load_balance", "router_z"} f32 scalars).

    The sharded dispatch exactly where JAX takes it (repro/models/moe.py:79-84):
    a data extent G > 1 that divides B.  Otherwise the global path; a DTensor x
    then runs it whole on every rank of its batch block (aux losses plain
    scalars, equal on every rank).
    """
    B = x.shape[0]
    if rules is not None and is_dtensor(x):
        G = rules.data_extent
        if G > 1 and B % G == 0:
            return _moe_ffn_sharded(params, x, cfg, rules)
        ds = rules.batch_sharded(x)
        local = {k: rules.param(params[k], split=False, data_sharded=ds)
                 for k in ("router", "w_gate", "w_up", "w_down")}
        y, aux = _moe_ffn_global(local, rules.enter(x, ("batch", None, None)), cfg)
        return rules.leave(y, x), aux
    return _moe_ffn_global(params, x, cfg)


def _moe_ffn_global(params, x: torch.Tensor, cfg: ModelConfig):
    B, S, D = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.experts_per_token
    C = expert_capacity(T, cfg)
    xt = x.reshape(T, D)

    # ---- routing: f32 softmax over the router logits, top-k, renormalise
    logits = (xt @ params["router"]).float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)  # [T, K], descending as lax.top_k
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # ---- dispatch: sort (token, slot) pairs by expert.  The sort must be
    # stable: an assignment's rank within its expert (first come, first
    # served) decides which ones the capacity drops.
    flat_e = top_e.reshape(T * K)
    flat_p = top_p.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = order // K  # flat token ids are repeat(arange(T), K)
    sorted_p = flat_p[order]
    counts = torch.zeros(E, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))  # bincount without a host sync

    # ---- aux losses
    density = counts.float() / T
    lb_loss = E * torch.sum(density * probs.mean(dim=0)) / K
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()

    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=x.device) - starts[sorted_e]
    keep = rank < C
    # Slots are unique, so the scatter is a copy; dropped assignments all
    # land on a spill row E*C that is cut off.
    slot = torch.where(keep, sorted_e * C + rank, E * C)
    buf = x.new_zeros(E * C + 1, D)
    buf.index_copy_(0, slot, xt[sorted_tok])
    buf = buf[: E * C].view(E, C, D)

    # ---- expert FFNs, batched over E
    h = F.silu(ops.moe_matmul_op(buf, params["w_gate"])) * ops.moe_matmul_op(buf, params["w_up"])
    out = ops.moe_matmul_op(h, params["w_down"]).view(E * C, D)

    # ---- combine without atomics: gather each assignment's output, weight
    # it, undo the sort and sum the K contributions of each token in f32
    # (XLA's CPU scatter-add sums bf16 in f32 too), rounding once.
    gathered = torch.where(keep[:, None], out[slot.clamp(max=E * C - 1)], 0)
    contrib = gathered * sorted_p[:, None].to(x.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=x.device)
    y = contrib[inv].view(T, K, D).sum(dim=1, dtype=torch.float32).to(x.dtype)
    return y.view(B, S, D), {"load_balance": lb_loss, "router_z": z_loss}


# ---------------------------------------------------------------------------
# sharded dispatch (repro/models/moe.py:177-392)
# ---------------------------------------------------------------------------


def _local_dispatch(xt, router, E, K, C_loc, E_buf=None, e_lo=0, n_slice=None):
    """Per-shard dispatch: xt [T_loc, D] -> (buffer [n_slice, C_loc, D], combine metadata,
    aux partials).

    Routing and ranks within each expert are computed over the local tokens
    only.  ``E_buf >= E`` pads the expert dim (tokens route to the first E
    only); ``[e_lo, e_lo + n_slice)`` is the one slice of experts the buffer
    holds.  The metadata keep global expert coordinates: (inverse sort, sorted
    router weights in x's type, slots, kept).  Aux: (per-expert counts, mean
    router probabilities, mean squared log-sum-exp).
    """
    E_buf = E if E_buf is None else E_buf
    n_slice = E_buf if n_slice is None else n_slice
    T_loc, D = xt.shape
    logits = (xt @ router).float()  # [T_loc, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    flat_e = top_e.reshape(T_loc * K)
    flat_p = top_p.reshape(T_loc * K)
    order = torch.argsort(flat_e, stable=True)  # first come, first served within an expert
    sorted_e = flat_e[order]
    sorted_tok = order // K
    sorted_p = flat_p[order]
    counts = torch.zeros(E, dtype=torch.int64, device=xt.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T_loc * K, device=xt.device) - starts[sorted_e]
    keep = rank < C_loc
    slot = torch.where(keep, sorted_e * C_loc + rank, E_buf * C_loc)
    # this slice's experts only; the others land on a spill row that is cut off
    local = keep & (sorted_e >= e_lo) & (sorted_e < e_lo + n_slice)
    local_slot = torch.where(local, (sorted_e - e_lo) * C_loc + rank, n_slice * C_loc)
    buf = xt.new_zeros(n_slice * C_loc + 1, D)
    buf.index_copy_(0, local_slot, xt[sorted_tok])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T_loc * K, device=xt.device)
    meta = (inv, sorted_p.to(xt.dtype), slot, keep)
    aux = (counts, probs.mean(dim=0), torch.logsumexp(logits, dim=-1).square().mean())
    return buf[: n_slice * C_loc].view(n_slice, C_loc, D), meta, aux


def _local_combine(out, inv, sorted_p, slot, keep, T_loc: int, slot_lo: int = 0):
    """Per-shard combine: the slice's expert outputs [E_l, C_loc, D] -> partial y [T_loc, D]
    in f32 (zeros for assignments outside the slice): gather, weight, undo the sort and
    sum each token's K contributions, as the global path does."""
    E_l, C_loc, D = out.shape
    K = inv.shape[0] // T_loc
    n = E_l * C_loc
    idx = slot - slot_lo
    mine = keep & (idx >= 0) & (idx < n)
    gathered = torch.where(mine[:, None], out.reshape(n, D)[idx.clamp(0, n - 1)], 0)
    contrib = gathered * sorted_p[:, None].to(out.dtype)
    return contrib[inv].view(T_loc, K, D).sum(dim=1, dtype=torch.float32)


def _expert_slice(w, rules, lo: int, hi: int, E: int) -> torch.Tensor:
    """Experts [lo, hi) of an expert-major weight, zeros past the E real ones (``_pad_e``):
    the rank's own block where the weight is sharded just so, else read whole."""
    if rules.kept_range(w, 0) == (lo, hi):
        return rules.param(w, split=True, data_sharded=True, keep_dim=0)
    full = rules.param(w, split=True, data_sharded=True)
    part = full[lo:min(hi, E)]
    if hi > E:
        part = torch.cat([part, part.new_zeros(hi - max(lo, E), *full.shape[1:])])
    return part.contiguous()


def _moe_ffn_sharded(params, x, cfg: ModelConfig, rules):
    B, S, D = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.experts_per_token
    G = rules.data_extent
    T_loc = T // G
    C_loc = expert_capacity(T_loc, cfg)
    M = rules.extent("expert")
    E_pad = -(-E // M) * M
    E_l = E_pad // M
    m = rules.model_rank
    e_lo = m * E_l

    x = rules.constrain(x, ("batch", None, None))
    xt = rules.enter(x, ("batch", None, None), split=True).reshape(T_loc, D)
    router = rules.param(params["router"], split=True, data_sharded=True)
    buf, (inv, p, slot, keep), (counts, rmean, z) = _local_dispatch(
        xt, router, E, K, C_loc, E_buf=E_pad, e_lo=e_lo, n_slice=E_l
    )

    # aux losses from per-shard partials, summed over the mesh in one reduction: model rank 0
    # of each data shard contributes (the other model ranks hold the same routing)
    first = 1.0 if m == 0 else 0.0
    sums = rules.sum_all(torch.cat([counts.float(), rmean, z[None]]) * first)
    density, router_mean, z_loss = sums[:E] / T, sums[E:2 * E] / G, sums[2 * E] / G
    lb_loss = E * torch.sum(density * router_mean) / K

    wg, wu, wd = (_expert_slice(params[n], rules, e_lo, e_lo + E_l, E)
                  for n in ("w_gate", "w_up", "w_down"))
    h = F.silu(ops.moe_matmul_op(buf, wg)) * ops.moe_matmul_op(buf, wu)
    out = ops.moe_matmul_op(h, wd)  # [E_l, C_loc, D]
    y = _local_combine(out, inv, p, slot, keep, T_loc, slot_lo=e_lo * C_loc)
    y = rules.leave(y.view(B // G, S, D), x, split=True).to(x.dtype)
    return rules.constrain(y, ("batch", None, None)), {"load_balance": lb_loss, "router_z": z_loss}
