"""Rematerialisation of the layer body in training (``layers.remat_layer``), on the CPU.

JAX runs each layer of a training forward under ``jax.checkpoint`` with
``dots_with_no_batch_dims_saveable`` where ``cfg.remat`` (the default of
every config); the port runs it as a selectively checkpointed region.

* For each of the six families (reduced, f32), a training step's gradients
  with remat on equal those with remat off bit for bit, and equal
  ``jax.grad`` of JAX's loss (remat on) within 1e-4 of each leaf's largest
  magnitude.  The bit-for-bit comparison runs under
  ``torch.use_deterministic_algorithms``: without it the CPU's embedding
  backward (an accumulating index) may sum in another order from one run to
  the next, remat or not.
* The policy: between forward and backward a rematerialised dense or MoE
  layer holds its arguments (the input and the positions) and the outputs
  of its products with no batch dimension, and nothing else; its bytes held
  are printed beside those of the same layer without remat.
* On six gloo ranks, the (2, 3) mesh: the sharded loss and gradients of
  reduced llama3.2-1b and granite-moe-3b-a800m with remat on equal those with
  remat off bit for bit, on every rank.
"""

from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import device_mesh, run_ranks
from repro_torch.models import build_model, layers
from repro_torch.models import transformer as tt
from repro.training.checkpoint import _flatten

from _torch_parity import family_inputs, np32, trainable

FAMILIES = {"dense": "llama3.2-1b", "vlm": "internvl2-1b", "moe": "granite-moe-3b-a800m",
            "ssm": "mamba2-130m", "hybrid": "hymba-1.5b", "audio": "whisper-medium"}


def _batch(cfg, B: int = 2):
    seq = 64 if cfg.family in ("ssm", "hybrid") else 16  # two SSD chunks of 32
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(B, seq))
    return {"tokens": torch.as_tensor(toks), **family_inputs(cfg, B)}


def _loss_grads(api, params, batch):
    loss, _ = api.loss_fn(params, batch)
    names, leaves = zip(*params.named_parameters())
    return loss.detach(), dict(zip((n.replace(".", "/") for n in names),
                                   torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_grads_equal_without_and_match_jax(family):
    japi, jparams, tapi, params = trainable(FAMILIES[family])
    assert japi.cfg.remat and tapi.cfg.remat  # the configs' default, kept by reduced()
    batch = _batch(tapi.cfg)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        on = _loss_grads(tapi, params, batch)
        off = _loss_grads(build_model(dataclasses.replace(tapi.cfg, remat=False)), params, batch)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    assert torch.equal(on[0], off[0])
    assert on[1].keys() == off[1].keys()
    for k in on[1]:
        assert torch.equal(on[1][k], off[1][k]), k
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want, jg = jax.value_and_grad(lambda p: japi.loss_fn(p, jbatch)[0])(jparams)
    assert float(on[0]) == pytest.approx(float(want), rel=1e-5, abs=1e-5)
    jg = _flatten(jg)
    assert jg.keys() == on[1].keys()
    for k, w in jg.items():
        err = np.abs(np32(on[1][k]) - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (k, err, np.abs(w).max())


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m"])
def test_remat_holds_the_input_and_the_no_batch_products(arch, monkeypatch, capsys):
    """One reduced layer under ``saved_tensors_hooks``: with remat its region hands the hooks
    its tensor arguments alone, and the policy keeps the outputs of the q/k/v/o projections
    and of the FFN's three products (dense) or of the router (moe: the per-expert products
    are batched over the experts, and recomputed); nothing else is held."""
    from torch.utils.checkpoint import CheckpointPolicy

    cfg = get_config(arch).reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu", trainable=True)
    lp = tt.layer_params(params["layers"])[0]
    B, S, D = 2, 16, cfg.d_model
    T, hd = B * S, cfg.resolved_head_dim
    x = torch.randn(B, S, D, generator=torch.Generator().manual_seed(1), requires_grad=True)
    pos = tt.arange_positions(B, S, "cpu")
    rope = layers.rope_cos_sin(pos, hd, cfg.rope_theta)
    param_storages = {_storage(p) for p in params.parameters()}
    policy = layers.remat_policy
    held, grads = {}, {}
    for remat in (True, False):
        packed, saved = [], []

        def recording(ctx, op, *args, _saved=saved, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                a, b = args[-2:]  # mm(a, b), addmm(bias, a, b)
                _saved.append((op.overloadpacket, (a.shape[0], b.shape[1]),
                               a.shape[0] * b.shape[1] * a.element_size()))
            return decision

        monkeypatch.setattr(layers, "remat_policy", recording)
        c = dataclasses.replace(cfg, remat=remat)
        with torch.autograd.graph.saved_tensors_hooks(lambda t: (packed.append(t), t)[1], lambda t: t):
            y, aux, _ = layers.remat_layer(c, tt.layer_forward, lp, x, pos, c, rope=rope)
        loss = y.square().sum() + (sum(aux.values()) if aux else 0)
        grads[remat] = torch.autograd.grad(loss, [x, *params.parameters()], allow_unused=True)
        storages = {_storage(t): t.untyped_storage().nbytes() for t in packed
                    if _storage(t) not in param_storages}
        if remat:
            assert set(storages) == {_storage(x), _storage(pos)}
            assert all(op is torch.ops.aten.mm for op, _, _ in saved)
            want = [(T, cfg.num_heads * hd), (T, cfg.num_kv_heads * hd), (T, cfg.num_kv_heads * hd),
                    (T, D)]
            want += [(T, cfg.num_experts)] if cfg.family == "moe" else [(T, cfg.d_ff)] * 2 + [(T, D)]
            assert sorted(s for _, s, _ in saved) == sorted(want)
            held[remat] = sum(storages.values()) + sum(n for _, _, n in saved)
        else:
            assert not saved
            held[remat] = sum(storages.values())
    with capsys.disabled():
        print(f"\n[remat] {arch} one layer [{B}, {S}, {D}]: bytes held between forward and "
              f"backward, remat on {held[True]}, remat off {held[False]}")
    assert held[True] < held[False]
    for a, b in zip(*grads.values()):
        assert (a is None and b is None) or torch.equal(a, b)


MESH_ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m")


def _remat_mesh_body(rank, world, archs):
    """Each arch's sharded loss and local gradient blocks, with remat on and off."""
    warnings.simplefilter("ignore")
    torch.use_deterministic_algorithms(True)
    from repro_torch.sharding.rules import make_rules
    from repro_torch.training.train_step import grads_of

    rules = make_rules(device_mesh("cpu", (2, 3), ("data", "model")))
    out = {}
    for arch in archs:
        cfg = get_config(arch).reduced()
        toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(7))
        for remat in (True, False):
            api = build_model(dataclasses.replace(cfg, remat=remat))
            params = api.init(torch.Generator().manual_seed(0), "cpu", trainable=True, rules=rules)
            loss, _ = api.loss_fn(params, {"tokens": toks}, rules)
            out[arch, remat] = (loss.detach(), {k: g.to_local() for k, g in grads_of(loss, params).items()})
    return out


def test_sharded_remat_equals_no_remat_on_the_mesh():
    for rank_out in run_ranks(_remat_mesh_body, 6, (MESH_ARCHS,), device="cpu", timeout=300):
        for arch in MESH_ARCHS:
            (l_on, g_on), (l_off, g_off) = rank_out[arch, True], rank_out[arch, False]
            assert torch.equal(l_on, l_off), arch
            assert g_on.keys() == g_off.keys()
            for k in g_on:
                assert torch.equal(g_on[k], g_off[k]), (arch, k)
