"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060].

Torch twin of ``repro.models.ssm``.  Prefill and scoring use the chunked
SSD algorithm: the sequence is cut into chunks of length ``Q``; within a
chunk the recurrence is a masked, decay-weighted quadratic form, computed
with the chunk's contribution to the state by ``ops.ssd_intra_chunk_op``
(the hand-written kernel on the card); across chunks a short loop carries
the [H, hd, N] state.  Decode is the O(1) recurrence, in plain torch (the
JAX package has no kernel for it).

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
from repro_torch.models.layers import ParamDef, rms_norm
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
    """x [B,S,D] -> z, xs [B,S,H,hd]; b, c [B,S,N]; dt [B,S,H] f32 (softplus in f32)."""
    B, S, _ = x.shape
    H, hd = cfg.ssm_heads, cfg.ssm_head_dim
    z = (x @ params["w_in_z"]).view(B, S, H, hd)
    xs = (x @ params["w_in_x"]).view(B, S, H, hd)
    b = x @ params["w_in_b"]  # shared across heads, Mamba-2 default
    c = x @ params["w_in_c"]
    dt = F.softplus((x @ params["w_in_dt"]).float() + params["dt_bias"].float())
    return z, xs, b, c, dt


def _gate_norm_out(params, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor, cfg: ModelConfig):
    """D skip, SiLU gate, output norm and projection: y, xs, z [B,S,H,hd] -> [B,S,D]."""
    B, S, H, hd = y.shape
    y = y + xs * params["d_skip"].to(xs.dtype)[None, None, :, None]
    y = (y * F.silu(z)).reshape(B, S, H * hd)
    return rms_norm(y, params["out_norm"], cfg.norm_eps) @ params["w_out"]


def ssd_scan(params, x: torch.Tensor, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """Full-sequence SSD mixer: x [B,S,D] -> [B,S,D].  S % chunk == 0."""
    return ssd_scan_with_state(params, x, cfg, rules)[0]


def _local_params(params, rules, ds: bool):
    return {n: rules.param(params[n], split=False, data_sharded=ds) for n in PARAM_NAMES}


def ssd_scan_with_state(
    params, x: torch.Tensor, cfg: ModelConfig, rules=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD mixer returning (y [B,S,D], final_state [B,H,hd,N] f32) for prefill.

    ``rules`` and a DTensor x: the mixer runs whole on each rank's batch block,
    repeated over the model axis (the state returned is the rank's block's,
    plain); JAX constrains y's d_inner to the model axis
    (repro/models/ssm.py:148), which a repeated mixer has no use for.
    """
    if rules is not None and is_dtensor(x):
        ds = rules.batch_sharded(x)
        y, s = ssd_scan_with_state(_local_params(params, rules, ds), rules.enter(x, ("batch", None, None)), cfg)
        return rules.leave(y, x), s
    B, S, _ = x.shape
    H, hd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    NC = S // Q

    z, xs, b, c, dt = _project(params, x, cfg)
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
    return _gate_norm_out(params, y, xs, z, cfg), s


def ssm_decode_state(cfg: ModelConfig, batch: int, device: torch.device | str = "cuda") -> torch.Tensor:
    return torch.zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, device=device)


def ssd_decode_step(params, x: torch.Tensor, state: torch.Tensor, cfg: ModelConfig):
    """O(1) recurrent step: x [B,1,D], state [B,H,hd,N] f32 -> (y [B,1,D], new state)."""
    z, xs, b, c, dt = _project(params, x, cfg)
    A = -torch.exp(params["a_log"].float())
    g = torch.exp(dt[:, 0] * A)  # [B,H]
    xdt = (xs[:, 0] * dt[:, 0, :, None].to(xs.dtype)).float()  # [B,H,hd]
    outer = xdt[..., None] * b[:, 0].float()[:, None, None, :]  # [B,H,hd,N]
    new_state = state * g[:, :, None, None] + outer
    y = torch.einsum("bhdm,bm->bhd", new_state, c[:, 0].float()).to(xs.dtype)
    return _gate_norm_out(params, y[:, None], xs, z, cfg), new_state


@torch.no_grad()
def sharded_ssd_decode_step(params, x: torch.Tensor, state: torch.Tensor, h_lo: int,
                            head_dims, cfg: ModelConfig, rules) -> torch.Tensor:
    """``ssd_decode_step`` of a DTensor x [B,1,D] against the rank's block ``state``
    [B_l, H_l, hd, N] of the heads [h_lo, h_lo + H_l), updated in place; the heads'
    outputs are gathered over ``head_dims`` (the mesh dims that shard the state's
    heads) before the output norm.  Returns y as a DTensor laid out as x."""
    ds = rules.batch_sharded(x)
    local = _local_params(params, rules, ds)
    xl = rules.enter(x, ("batch", None, None))
    hs = slice(h_lo, h_lo + state.shape[1])
    z, xs, b, c, dt = _project(local, xl, cfg)
    A = -torch.exp(local["a_log"].float())
    g = torch.exp(dt[:, 0, hs] * A[hs])  # [B,H_l]
    xdt = (xs[:, 0, hs] * dt[:, 0, hs, None].to(xs.dtype)).float()  # [B,H_l,hd]
    outer = xdt[..., None] * b[:, 0].float()[:, None, None, :]
    state.copy_(state * g[:, :, None, None] + outer)
    y = torch.einsum("bhdm,bm->bhd", state, c[:, 0].float()).to(xs.dtype)
    if head_dims:
        y = rules.gather(y, 1, head_dims)
    return rules.leave(_gate_norm_out(local, y[:, None], xs, z, cfg), x)
