"""Checkpoints: flat-path ``.npz`` snapshots of a parameter tree.

The format of ``repro.training.checkpoint``: one array per leaf under its
``a/b/c`` path key (a ParamTree's ``state_dict`` keys with ``.`` -> ``/``,
as ``models.convert`` maps them) and the step under ``__step__``, written
to a temporary file and renamed.  So a JAX checkpoint loads into the port
and the other way round.  bf16 leaves are stored as f32 (exact), which
either loader casts back to the leaf's dtype.
"""

from __future__ import annotations

import os
import tempfile
from typing import Tuple

import numpy as np
import torch

from repro_torch.models.convert import _to_tensor, tree_from_flat
from repro_torch.models.layers import ParamTree


def _flat(params: ParamTree):
    return {k.replace(".", "/"): v.detach() for k, v in params.state_dict().items()}


def save_checkpoint(path: str, params: ParamTree, step: int = 0) -> None:
    flat = {}
    for key, t in _flat(params).items():
        t = t.float() if t.dtype == torch.bfloat16 else t
        flat[key] = t.cpu().numpy()
    flat["__step__"] = np.asarray(step)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, like: ParamTree) -> Tuple[ParamTree, int]:
    """A copy of ``like`` (dtypes, device, requires_grad) holding the checkpoint's values, and its step."""
    with np.load(path) as data:
        step = int(data["__step__"]) if "__step__" in data else 0
        new = {}
        for key, leaf in _flat(like).items():
            if key not in data:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(leaf.shape)}")
            new[key] = _to_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
    return tree_from_flat(new, any(p.requires_grad for p in like.parameters())), step
