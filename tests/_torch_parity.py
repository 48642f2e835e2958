"""Shared helpers of the port's parity tests: one set of weights in both packages.

Weights are initialised by the JAX package, flattened to its checkpoint
path keys and loaded into the port with ``convert.params_from_flat``, so
both sides compute on identical numbers.  Inputs come from numpy seeds.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.training.checkpoint import _flatten, _path_str
from repro_torch.configs.base import ModelConfig as TorchModelConfig
from repro_torch.models import build_model as torch_build_model
from repro_torch.models.convert import flat_from_params, params_from_flat

# f32 parity tolerance of whole-model outputs: the two frameworks sum in
# different orders, which moves f32 logits of magnitude ~10 by ~1e-5.
MODEL_TOL = 1e-4


def torch_cfg(jax_cfg) -> TorchModelConfig:
    return TorchModelConfig(**dataclasses.asdict(jax_cfg))


@functools.lru_cache(maxsize=None)
def models(arch: str, weight_mult: float = 1.0, seed: int = 0):
    """(jax api, jax params, torch api, torch params) for ``arch`` reduced, in f32.

    ``weight_mult`` scales every non-norm weight, so that logits spread out
    and greedy tokens differ from step to step.  Cached: callers must not
    modify the parameters.
    """
    jcfg = jax_get_config(arch).reduced()
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(seed))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jparams)
    flat = {}
    for path, leaf in leaves:
        key = "/".join(_path_str(p) for p in path)
        flat[key] = np.asarray(leaf) * (1.0 if "norm" in key else weight_mult)
    jparams = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat["/".join(_path_str(p) for p in path)]) for path, _ in leaves]
    )
    assert _flatten(jparams).keys() == flat.keys()
    tcfg = torch_cfg(jcfg)
    return japi, jparams, torch_build_model(tcfg), params_from_flat(flat, tcfg, "cpu")


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def trainable(arch: str):
    """(jax api, jax params, torch api, a fresh trainable copy of the same torch params)."""
    japi, jparams, tapi, tparams = models(arch)
    params = params_from_flat(flat_from_params(tparams), tapi.cfg, "cpu").requires_grad_(True)
    return japi, jparams, tapi, params


def assert_params_after_one_step(params, jparams, lr):
    """Parameters after one AdamW step against JAX's: Adam moves a weight by
    about lr * sign(g) wherever |g| >> eps, so a weight whose true gradient is
    ~0 may move by up to 2 lr differently in the two frameworks.  Every element
    is held within ``2 lr + 1e-6`` and 99.9% of each leaf's within 1e-5."""
    want = _flatten(jparams)
    got = flat_from_params(params)
    assert got.keys() == want.keys()
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        assert diff.max() <= 2 * lr + 1e-6, (k, diff.max())
        assert np.mean(diff <= 1e-5) >= 0.999, (k, np.mean(diff <= 1e-5))
