"""Shared helpers of the port's parity tests: one set of weights in both packages.

Weights are initialised by the JAX package, flattened to its checkpoint
path keys and loaded into the port with ``convert.params_from_flat``, so
both sides compute on identical numbers.  Inputs come from numpy seeds.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.layers import logits_fn as jax_logits_fn
from repro.models.transformer import embed_tokens as jax_embed
from repro.models.transformer import forward as jax_forward
from repro.training.checkpoint import _flatten, _path_str
from repro_torch.configs.base import ModelConfig as TorchModelConfig
from repro_torch.models import build_model as torch_build_model
from repro_torch.models import transformer as tt
from repro_torch.models.convert import flat_from_params, params_from_flat
from repro_torch.models.layers import logits_fn

ROOT = Path(__file__).resolve().parents[1]

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


def family_inputs(cfg, B: int, seed: int = 0, frames: int = 10):
    """What a family's prefill and loss read besides the tokens, as CPU tensors:
    audio stub frames [B, frames, D], vlm stub patches [B, num_patches, D]."""
    rng = np.random.default_rng(seed)
    n = {"audio": frames, "vlm": cfg.num_patches}.get(cfg.family)
    if n is None:
        return {}
    x = torch.from_numpy(rng.standard_normal((B, n, cfg.d_model), dtype=np.float32))
    return {"frames" if cfg.family == "audio" else "patch_embeds": x}


def chip_smoke():
    """``chip_smoke.py`` as a module (its helpers; ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_grads_close_to_max(loss, params, jax_grads, tol=1e-4):
    """d loss / d params against JAX's gradient tree: each leaf within ``tol`` of the
    reference leaf's largest magnitude."""
    names, leaves = zip(*params.named_parameters())
    got = dict(zip((n.replace(".", "/") for n in names), torch.autograd.grad(loss, leaves)))
    want = _flatten(jax_grads)
    assert got.keys() == want.keys()
    for k, w in want.items():
        err = np.abs(np32(got[k]) - w).max()
        assert err <= tol * np.abs(w).max(), (k, err, np.abs(w).max())


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


def bf16_decode_drift(arch: str, seed: int, B: int = 2, P: int = 32, new: int = 32):
    """(port's drift, JAX's drift) of bf16 decode from a full forward, on the same weights.

    ``arch`` reduced in bf16, JAX weights from ``seed``: prefill a P-token
    prompt, decode ``new`` given tokens, and take the largest |logit|
    difference, over every decode step, from a full forward over the same
    tokens.  P and P + new must be multiples of the SSD chunk (32).
    """
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype="bfloat16")
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(seed))
    tcfg = torch_cfg(jcfg)
    tapi = torch_build_model(tcfg)
    tparams = params_from_flat(_flatten(jparams), tcfg, "cpu")
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, P + new))

    logits, state = japi.prefill(jparams, {"tokens": jnp.asarray(toks[:, :P])})
    if state.k_cache is not None:  # JAX's caches are exactly P long: give decode its room
        pad = ((0, 0), (0, 0), (0, new), (0, 0))
        state = state._replace(k_cache=jnp.pad(state.k_cache, pad), v_cache=jnp.pad(state.v_cache, pad))
    step = jax.jit(lambda p, s, t: japi.decode_step(p, s, t))
    jax_dec = []
    for i in range(new):
        logits, state = step(jparams, state, jnp.asarray(toks[:, P + i : P + i + 1], jnp.int32))
        jax_dec.append(np32(logits))
    pos = jnp.broadcast_to(jnp.arange(P + new, dtype=jnp.int32), toks.shape)
    h, _ = jax_forward(jparams, jax_embed(jparams, jnp.asarray(toks), jcfg), pos, jcfg, None)
    jax_full = np32(jax_logits_fn(jparams, h, jcfg))

    t = torch.as_tensor(toks)
    logits, tstate = tapi.prefill(tparams, {"tokens": t[:, :P]}, cache_len=P + new)
    port_dec = []
    for i in range(new):
        logits, tstate = tapi.decode_step(tparams, tstate, t[:, P + i : P + i + 1])
        port_dec.append(np32(logits))
    h, _ = tt.forward(tparams, tt.embed_tokens(tparams, t, tcfg), tt.arange_positions(B, P + new, "cpu"), tcfg)
    port_full = np32(logits_fn(tparams, h, tcfg))

    jax_drift = max(np.abs(jax_dec[i] - jax_full[:, P + i]).max() for i in range(new))
    port_drift = max(np.abs(port_dec[i] - port_full[:, P + i]).max() for i in range(new))
    return port_drift, jax_drift
