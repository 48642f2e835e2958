"""Weights across frameworks: flat ``a/b/c`` path keys <-> ParamTree.

The flat keys are those of the JAX package's checkpoints (``embed``,
``final_norm``, ``layers/attn/wq``, ..., stacked over L; for the audio
family ``enc_layers/...``, ``enc_norm`` and ``dec_layers/...``), so
JAX-initialised or JAX-trained weights load into the port unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef, ParamTree, torch_dtype
from repro_torch.models.model import model_schema


def _flat_schema(node, prefix: str = "") -> Dict[str, ParamDef]:
    if isinstance(node, dict):
        out: Dict[str, ParamDef] = {}
        for k, v in node.items():
            out.update(_flat_schema(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: node}


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only needed to hand bf16 back to numpy

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_from_flat(flat: Mapping[str, torch.Tensor], trainable: bool = False) -> ParamTree:
    """A ParamTree from ``a/b/c``-keyed tensors, nested along the keys."""
    tree: Dict[str, Any] = {}
    for key, t in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return ParamTree(tree, trainable)


def params_from_flat(
    flat: Mapping[str, Any], cfg: ModelConfig, device: torch.device | str = "cuda", rules=None
) -> ParamTree:
    """Build the model's ParamTree from flat path-keyed arrays, in ``cfg.dtype``.

    With live ``rules`` each leaf is placed on the mesh by its schema's dims
    (every rank is handed the whole arrays and keeps its block).  Raises
    KeyError on a missing or extra key and ValueError on a shape mismatch.
    """
    want = _flat_schema(model_schema(cfg))
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"{cfg.name}: missing keys {missing}, extra keys {extra}")
    dtype = torch_dtype(cfg)
    tensors = {}
    for key, pdef in want.items():
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(pdef.shape):
            raise ValueError(f"{key}: shape {arr.shape} != expected {pdef.shape}")
        t = _to_tensor(arr).to(device=device, dtype=dtype)
        tensors[key] = t if rules is None else rules.distribute(t, pdef.dims)
    return tree_from_flat(tensors)


def flat_from_params(params: ParamTree) -> Dict[str, np.ndarray]:
    """Flat ``a/b/c``-keyed numpy arrays (the JAX checkpoint layout)."""
    return {k.replace(".", "/"): _to_numpy(v) for k, v in params.state_dict().items()}
