"""Stand-ins for every model input (the dry-run's; nothing is allocated) and their specs.

Torch twin of ``repro.launch.specs``: tensors on the ``meta`` device take the
place of ``jax.ShapeDtypeStruct``, and a spec is the tuple that
``Rules.spec`` returns (JAX's ``PartitionSpec`` entries).
``input_specs(cfg, shape)`` is the abstract batch of the train and prefill
kinds, ``decode_specs`` the decode kinds'; ``input_shardings`` and
``decode_shardings`` give the matching specs.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.model import ModelApi
from repro_torch.sharding.rules import Rules


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok(b: int, s: int) -> torch.Tensor:
    return _meta((b, s), torch.int32)


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Abstract train/prefill batch for an assigned input shape."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        # seq_len applies to the (stub) encoder frames; the decoder reads its fixed text window
        return {"frames": _meta((B, S, cfg.d_model), torch.float32), "tokens": _tok(B, cfg.decoder_seq)}
    if cfg.family == "vlm":
        return {
            "tokens": _tok(B, S - cfg.num_patches),
            "patch_embeds": _meta((B, cfg.num_patches, cfg.d_model), torch.float32),
        }
    return {"tokens": _tok(B, S)}


def input_shardings(cfg: ModelConfig, shape: InputShape, rules: Rules) -> Dict[str, Any]:
    B = shape.global_batch
    batch_dims = ("batch",) if B % rules.data_extent == 0 else (None,)
    if cfg.family == "audio":
        return {
            "frames": rules.spec((B, shape.seq_len, cfg.d_model), (*batch_dims, None, None)),
            "tokens": rules.spec((B, cfg.decoder_seq), (*batch_dims, None)),
        }
    if cfg.family == "vlm":
        return {
            "tokens": rules.spec((B, shape.seq_len - cfg.num_patches), (*batch_dims, None)),
            "patch_embeds": rules.spec((B, cfg.num_patches, cfg.d_model), (*batch_dims, None, None)),
        }
    return {"tokens": rules.spec((B, shape.seq_len), (*batch_dims, None))}


def decode_specs(api: ModelApi, shape: InputShape) -> Tuple[Any, torch.Tensor]:
    """(abstract decode state, abstract one-token batch)."""
    B, S = shape.global_batch, shape.seq_len
    return api.abstract_decode_state(B, S), _tok(B, 1)


def decode_shardings(api: ModelApi, shape: InputShape, rules: Rules):
    B, S = shape.global_batch, shape.seq_len
    state_specs = api.decode_state_specs(rules, B, S)
    tok_dims = ("batch", None) if B % rules.data_extent == 0 else (None, None)
    return state_specs, rules.spec((B, 1), tok_dims)


def uses_sliding_window(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k decode on attention-bearing archs runs the sliding-window variant
    (sub-quadratic); SSM archs decode natively."""
    return shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm", "hybrid", "audio")
