"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060].

Torch twin of ``repro.models.ssm``.  Prefill and scoring use the chunked
SSD algorithm: the sequence is cut into chunks of length ``Q``; within a
chunk the recurrence is a masked, decay-weighted quadratic form, computed
with the chunk's contribution to the state by ``ops.ssd_intra_chunk_op``
(the hand-written kernel on the card); across chunks a short loop carries
the [H, hd, N] state.  Decode is the O(1) recurrence, in plain torch (the
JAX package has no kernel for it).

On a mesh the mixer is split over its heads on the model axis wherever its
d_inner weights are sharded there in whole heads (``splits``), as JAX shards
``ssm_inner``: each rank projects, scans and decodes its own heads, the
heads' gated outputs are gathered for the output norm over whole rows, and
each rank's columns of the normed rows go through its rows of ``w_out``.

Shapes follow the Mamba-2 conventions:
  d_inner = expand * d_model, H = d_inner / head_dim, N = ssm_state.
Per head h: state S[hd, N];  y_t = C_t . S_t + D x_t,
  S_t = exp(dt_t A_h) S_{t-1} + dt_t * (x_t outer B_t).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef, _f32_product, rms_norm
from repro_torch.sharding.rules import is_dtensor

PARAM_NAMES = ("w_in_z", "w_in_x", "w_in_b", "w_in_c", "w_in_dt", "a_log", "dt_bias", "d_skip",
               "out_norm", "w_out")


def ssm_schema(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, di, h, n = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    return {
        # fused input projection: [z (gate), x, B, C, dt]
        "w_in_z": ParamDef((d, di), ("embed", "ssm_inner")),
        "w_in_x": ParamDef((d, di), ("embed", "ssm_inner")),
        "w_in_b": ParamDef((d, n), ("embed", None)),
        "w_in_c": ParamDef((d, n), ("embed", None)),
        "w_in_dt": ParamDef((d, h), ("embed", None)),
        "a_log": ParamDef((h,), init="zeros"),
        "dt_bias": ParamDef((h,), init="zeros"),
        "d_skip": ParamDef((h,), init="ones"),
        "out_norm": ParamDef((di,), init="ones"),
        "w_out": ParamDef((di, d), ("ssm_inner", "embed")),
    }


def _project(params, x: torch.Tensor, cfg: ModelConfig):
    """x [B,S,D] -> z, xs [B,S,H,hd]; b, c [B,S,N]; dt [B,S,H] f32 (softplus in f32).

    H is the number of heads whose weights ``params`` holds: all of them, or on the
    mesh the rank's own block of them (``_head_params``)."""
    B, S, _ = x.shape
    H, hd = params["w_in_dt"].shape[1], cfg.ssm_head_dim
    z = (x @ params["w_in_z"]).view(B, S, H, hd)
    xs = (x @ params["w_in_x"]).view(B, S, H, hd)
    b = x @ params["w_in_b"]  # shared across heads, Mamba-2 default
    c = x @ params["w_in_c"]
    dt = F.softplus((x @ params["w_in_dt"]).float() + params["dt_bias"].float())
    return z, xs, b, c, dt


def _gate(params, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """D skip and SiLU gate: y, xs, z [B,S,H,hd] -> [B,S,H*hd]."""
    B, S, H, hd = y.shape
    y = y + xs * params["d_skip"].to(xs.dtype)[None, None, :, None]
    return (y * F.silu(z)).reshape(B, S, H * hd)


def _norm_out(params, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The output norm over whole d_inner rows and the projection: [B,S,d_inner] -> [B,S,D]."""
    return rms_norm(y, params["out_norm"], cfg.norm_eps) @ params["w_out"]


def ssd_scan(params, x: torch.Tensor, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """Full-sequence SSD mixer: x [B,S,D] -> [B,S,D].  S % chunk == 0."""
    return ssd_scan_with_state(params, x, cfg, rules)[0]


def _local_params(params, rules, ds: bool):
    """Every weight gathered whole, for the mixer repeated on every model rank."""
    return {n: rules.param(params[n], split=False, data_sharded=ds) for n in PARAM_NAMES}


def splits(params, rules, cfg: ModelConfig) -> bool:
    """True where the mixer splits over its heads on the model axis: where its d_inner
    weights are sharded there (``ssm_inner``, as JAX shards them) in whole heads.  Else
    (3 divides none of hymba-1.5b's 50 heads) they are replicated and the mixer is
    repeated on every model rank.  Read from ``params``' placement of ``w_in_x``, or with
    ``params`` None from the spec that ``rules`` give the schema's ``w_in_x`` (how the
    weights are placed on the mesh), which also serves a mesh without devices."""
    if params is not None:
        sharded = rules.kept_range(params["w_in_x"], 1) is not None
    else:
        w = ssm_schema(cfg)["w_in_x"]
        spec = rules.spec(w.shape, w.dims)
        inner = spec[1] if len(spec) > 1 else None
        sharded = "model" in (inner if isinstance(inner, tuple) else (inner,))
    return sharded and cfg.ssm_heads % rules.model_size == 0


def heads_a_rank(rules, cfg: ModelConfig) -> int:
    """The heads each rank's mixer (its B4 and B8 launches) runs on under ``rules``: its
    block of H / M where the mixer ``splits``, else all H."""
    return cfg.ssm_heads // rules.model_size if splits(None, rules, cfg) else cfg.ssm_heads


def _head_params(params, rules, ds: bool, cfg: ModelConfig):
    """The weights of the rank's own heads -> (them, their columns [lo, hi) of d_inner).

    ``w_in_z`` and ``w_in_x`` keep the rank's columns and ``w_out`` its rows, as they are
    sharded (never gathered); ``w_in_dt``, ``a_log``, ``dt_bias`` and ``d_skip`` are sliced
    to its heads; ``w_in_b`` and ``w_in_c`` (shared by the heads) stay whole: their
    gradients are summed over the model axis.  ``out_norm`` stays whole too: the output norm
    runs alike on every model rank (``_split_out``), and so does its gradient."""
    lo, hi = rules.kept_range(params["w_in_x"], 1)
    h0, h1 = lo // cfg.ssm_head_dim, hi // cfg.ssm_head_dim

    def whole(n):
        return rules.param(params[n], split=True, data_sharded=ds)

    p = {n: rules.param(params[n], split=True, data_sharded=ds, keep_dim=1)
         for n in ("w_in_z", "w_in_x")}
    p["w_out"] = rules.param(params["w_out"], split=True, data_sharded=ds, keep_dim=0)
    p.update({n: whole(n) for n in ("w_in_b", "w_in_c")})
    p["out_norm"] = rules.param(params["out_norm"], split=False, data_sharded=ds)
    p["w_in_dt"] = whole("w_in_dt")[:, h0:h1]
    p.update({n: whole(n)[h0:h1] for n in ("a_log", "dt_bias", "d_skip")})
    return p, (lo, hi)


def _split_out(p, y: torch.Tensor, cols, cfg: ModelConfig, rules, like) -> torch.Tensor:
    """The rank's heads' gated y [B_l,S,H_l*hd] -> the mixer's output, a DTensor laid out as
    ``like``: the heads' rows gathered whole over the model axis, the output norm (B1) over
    them alike on every model rank, the rank's own columns of the normed rows by its rows of
    ``w_out``, and the partial sums reduced.  In training the columns' gradients are
    gathered whole, so that the norm's backward (B6) runs on whole rows alike on every rank,
    as unsharded, and each rank keeps its block of the result."""
    yn = rules.model_columns(rms_norm(rules.gather_model(y), p["out_norm"], cfg.norm_eps), *cols)
    # the partial outputs stay f32 until they are summed, as one product accumulates them
    return rules.leave(_f32_product(yn, p["w_out"]), like, split=True).to(like.dtype)


def ssd_scan_with_state(
    params, x: torch.Tensor, cfg: ModelConfig, rules=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD mixer returning (y [B,S,D], final_state [B,H,hd,N] f32) for prefill.

    ``rules`` and a DTensor x: each rank runs its batch block.  Where ``splits``, the
    mixer is split over its heads on the model axis, as JAX constrains y's d_inner to it
    (repro/models/ssm.py:147-148): each rank projects and scans its own heads, and the
    state returned is its heads' block of its batch block's (plain).  Else the mixer is
    repeated on every model rank, the weights gathered whole, and the state is all heads'.
    """
    if rules is not None and is_dtensor(x):
        ds = rules.batch_sharded(x)
        if not splits(params, rules, cfg):
            local = _local_params(params, rules, ds)
            y, s = _scan(local, rules.enter(x, ("batch", None, None)), cfg)
            return rules.leave(_norm_out(local, y, cfg), x), s
        local, cols = _head_params(params, rules, ds, cfg)
        y, s = _scan(local, rules.enter(x, ("batch", None, None), split=True), cfg)
        return _split_out(local, y, cols, cfg, rules, x), s
    y, s = _scan(params, x, cfg)
    return _norm_out(params, y, cfg), s


def _scan(params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan of the heads whose weights ``params`` holds -> (gated y [B,S,H*hd],
    final state [B,H,hd,N] f32)."""
    B, S, _ = x.shape
    hd, N = cfg.ssm_head_dim, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    NC = S // Q

    z, xs, b, c, dt = _project(params, x, cfg)
    H = dt.shape[2]
    A = -torch.exp(params["a_log"].float())  # [H], negative
    cum = torch.cumsum((dt * A).view(B, NC, Q, H), dim=2)  # [B,NC,Q,H] inclusive within-chunk
    xdt = xs * dt[..., None].to(xs.dtype)  # dt-weighted inputs [B,S,H,hd]

    # ---- intra-chunk output and chunk states, in the kernel's layout:
    # [B,NC,Q,H,hd] -> [B*NC,H,Q,hd], cum [B,NC,Q,H] -> [B*NC,H,Q].
    # Departure: the kernel keeps the decay-weighted scores at f32 precision
    # (in f32, or for bf16 x as two bf16 halves on the tensor cores), where the
    # JAX model rounds them to xs.dtype before the product with x
    # (repro/models/ssm.py:103-105); in f32 the two agree to summation order.
    y_intra, state_chunk = ops.ssd_intra_chunk_op(
        xdt.view(B * NC, Q, H, hd).transpose(1, 2).contiguous(),
        b.view(B * NC, Q, N).float().contiguous(),
        c.view(B * NC, Q, N).float().contiguous(),
        cum.view(B * NC, Q, H).transpose(1, 2).contiguous(),
    )
    y_intra = y_intra.view(B, NC, H, Q, hd).permute(0, 1, 3, 2, 4)  # [B,NC,Q,H,hd]
    state_chunk = state_chunk.view(B, NC, H, hd, N)

    # ---- inter-chunk recurrence over NC (tiny states): the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [B,NC,H]
    s = torch.zeros(B, H, hd, N, dtype=torch.float32, device=x.device)
    entering = []
    for n in range(NC):
        entering.append(s)
        s = s * chunk_decay[:, n, :, None, None] + state_chunk[:, n]
    entering = torch.stack(entering, dim=1)  # [B,NC,H,hd,N]

    # inter-chunk output: C_i . (decay_from_start_i * S_entering)
    c_c = c.view(B, NC, Q, N).float()
    y_inter = torch.einsum("bnim,bnhdm->bnihd", c_c, entering) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter.to(xs.dtype)).reshape(B, S, H, hd)
    return _gate(params, y, xs, z), s


def ssm_decode_state(cfg: ModelConfig, batch: int, device: torch.device | str = "cuda") -> torch.Tensor:
    return torch.zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, device=device)


def _recur(params, x: torch.Tensor, state: torch.Tensor, cfg: ModelConfig):
    """The O(1) step of the heads whose weights ``params`` holds: x [B,1,D], their state
    [B,H,hd,N] f32 -> (gated y [B,1,H*hd], new state)."""
    z, xs, b, c, dt = _project(params, x, cfg)
    A = -torch.exp(params["a_log"].float())
    g = torch.exp(dt[:, 0] * A)  # [B,H]
    xdt = (xs[:, 0] * dt[:, 0, :, None].to(xs.dtype)).float()  # [B,H,hd]
    outer = xdt[..., None] * b[:, 0].float()[:, None, None, :]  # [B,H,hd,N]
    new_state = state * g[:, :, None, None] + outer
    y = torch.einsum("bhdm,bm->bhd", new_state, c[:, 0].float()).to(xs.dtype)
    return _gate(params, y[:, None], xs, z), new_state


def ssd_decode_step(params, x: torch.Tensor, state: torch.Tensor, cfg: ModelConfig):
    """O(1) recurrent step: x [B,1,D], state [B,H,hd,N] f32 -> (y [B,1,D], new state)."""
    y, new_state = _recur(params, x, state, cfg)
    return _norm_out(params, y, cfg), new_state


@torch.no_grad()
def sharded_ssd_decode_step(params, x: torch.Tensor, state: torch.Tensor, h_lo: int,
                            head_dims, cfg: ModelConfig, rules) -> torch.Tensor:
    """``ssd_decode_step`` of a DTensor x [B,1,D] against the rank's block ``state``
    [B_l, H_l, hd, N] of the heads [h_lo, h_lo + H_l), updated in place; ``head_dims``
    are the mesh dims that shard the state's heads.  Where the mixer ``splits``, the
    block holds the rank's own heads, which it projects and updates alone; their gated
    outputs are gathered before the output norm and the rank's columns of the normed row
    go through its rows of ``w_out``, the partial sums reduced.  Else the block holds
    every head and the step is repeated on every model rank.  Returns y as a DTensor
    laid out as x."""
    ds = rules.batch_sharded(x)
    xl = rules.enter(x, ("batch", None, None))
    if not splits(params, rules, cfg):
        if head_dims:
            raise ValueError("the SSM state's heads are split over the mesh, its weights are not")
        local = _local_params(params, rules, ds)
        y, new_state = _recur(local, xl, state, cfg)
        state.copy_(new_state)
        return rules.leave(_norm_out(local, y, cfg), x)
    local, cols = _head_params(params, rules, ds, cfg)
    if (h_lo, h_lo + state.shape[1]) != (cols[0] // cfg.ssm_head_dim, cols[1] // cfg.ssm_head_dim):
        raise ValueError(f"the SSM state block's heads from {h_lo} ({state.shape[1]}) are not "
                         f"the rank's heads of d_inner {cols}")
    y, new_state = _recur(local, xl, state, cfg)
    state.copy_(new_state)
    return _split_out(local, y, cols, cfg, rules, x)
