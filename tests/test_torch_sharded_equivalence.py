"""The port's sharded paths on gloo ranks (spawned CPU processes) against
the JAX package's and against the port unsharded.

* The sharded MoE dispatch of JAX's own test case (reduced granite widths,
  E 10, top-4, capacity factor 4.0, B 8, S 16, D 128) on (data 2, model 4)
  and (4, 2): forward and aux losses within 1e-5, gradients of sum(y**2)
  within 2e-4, of JAX's ``_moe_ffn_sharded`` on a mesh of Auto axes (run in
  a subprocess with eight host devices; on jax 0.9 ``jax.make_mesh`` makes
  Explicit axes by default, which ``with_sharding_constraint`` refuses) and
  of its ``_moe_ffn_global``.
* Padded-head attention (6 H / 2 KV, hd 16, on (2, 4): 6 heads do not
  divide 4, so they pad to 8): within 1e-4 of JAX's unsharded attention,
  gradients finite and shaped as the parameters.
* Two sharded train steps of reduced granite-moe-3b-a800m and llama3.2-1b
  on (2, 2) against the port unsharded: losses and parameters within 1e-4.
* Greedy generation of reduced llama3.2-1b, granite-moe-3b-a800m (drop-free),
  kimi-k2-1t-a32b, whisper-medium and hymba-1.5b on (2, 3), batch 4 and 1
  and with a sliding window, against the same engine unsharded: tokens
  equal, logits within 1e-4.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process; the ranks hold torch alone)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.layers import multihead_attention as jax_mha
from repro_torch.launch.mesh import device_mesh, run_ranks


ROOT = Path(__file__).resolve().parents[1]
MOE = dict(num_layers=2, d_model=128, expert_d_ff=64, num_experts=10, experts_per_token=4,
           capacity_factor=4.0)
# capacity factor 0.5: a data shard's capacity is 16 assignments an expert, for 25.6 on average
MOE_DROPS = dict(MOE, capacity_factor=0.5)
DROP_MESHES = ((2, 3), (2, 4))
B, S, D, E, F = 8, 16, 128, 10, 64


def moe_inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((B, S, D)) * 0.1).astype(np.float32)
    shapes = {"router": (D, E), "w_gate": (E, D, F), "w_up": (E, D, F), "w_down": (E, F, D)}
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32) for k, s in shapes.items()}
    return x, params


_JAX_MOE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import dataclasses, jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import moe
from repro.sharding.rules import make_rules
cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"), **%r)
inp = np.load(sys.argv[1])
x = jnp.asarray(inp["x"])
params = {k: jnp.asarray(inp[k]) for k in ("router", "w_gate", "w_up", "w_down")}
out = {}
def grads(fn):
    return jax.jit(jax.grad(lambda p, x: jnp.sum(fn(p, x)[0] ** 2)))(params, x)
y, aux = jax.jit(lambda p, x: moe._moe_ffn_global(p, x, cfg, None))(params, x)
out["global_y"] = y
for k, v in aux.items(): out["global_" + k] = v
for k, v in grads(lambda p, x: moe._moe_ffn_global(p, x, cfg, None)).items(): out["global_g_" + k] = v
drops = dataclasses.replace(cfg, **%r)
for c, tag, shape in ((cfg, "", (2, 4)), (cfg, "", (4, 2)), (drops, "drop_", (2, 3)),
                      (drops, "drop_", (2, 4))):
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])
    rules = make_rules(mesh)
    tag += "%%dx%%d_" %% shape
    with mesh:
        fn = lambda p, x: moe._moe_ffn_sharded(p, x, c, rules)
        y, aux = jax.jit(fn)(params, x)
        g = grads(fn)
    out[tag + "y"] = y
    for k, v in aux.items(): out[tag + k] = v
    for k, v in g.items(): out[tag + "g_" + k] = v
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    x, params = moe_inputs()
    np.savez(d / "in.npz", x=x, **params)
    res = subprocess.run([sys.executable, "-c", _JAX_MOE % (MOE, MOE_DROPS), str(d / "in.npz"), str(d / "out.npz")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _moe_case(rules, fields):
    """The MoE case of ``fields`` on ``rules``: output, aux losses, gradients of sum(y**2),
    and the assignments that this rank's data shard's capacity dropped."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"), **fields)
    x, params = moe_inputs()
    dims = {k: v.dims for k, v in moe.moe_schema(cfg).items()}
    tp = {k: rules.distribute(torch.from_numpy(v), dims[k]).requires_grad_()
          for k, v in params.items()}
    tx = rules.distribute(torch.from_numpy(x), ("batch", None, None))
    dropped = []
    dispatch = moe._local_dispatch

    def counted(xt, router, E, K, C_loc, **kw):
        out = dispatch(xt, router, E, K, C_loc, **kw)
        dropped.append(int((out[2][0] - C_loc).clamp(min=0).sum()))
        return out

    with mock.patch.object(moe, "_local_dispatch", counted):
        y, aux = moe.moe_ffn(tp, tx, cfg, rules)  # B 8 divides the data extent: the sharded path
    rules.full(y.square().sum()).backward()
    res = {"y": rules.full(y).detach().numpy(), "sharded": hasattr(y, "placements"),
           "dropped": sum(dropped)}
    res.update({k: float(v) for k, v in aux.items()})
    res.update({"g_" + k: rules.full(p.grad).numpy() for k, p in tp.items()})
    return res


def _moe_body(rank, world):
    """The MoE case on both meshes of the same 8 ranks, the dropping case on (2, 4), and the
    padded attention on (2, 4)."""
    warnings.simplefilter("ignore")
    from repro_torch.sharding.rules import make_rules

    out = {}
    for mesh_shape in ((2, 4), (4, 2)):
        rules = make_rules(device_mesh("cpu", mesh_shape, ("data", "model")))
        out[mesh_shape] = _moe_case(rules, MOE)
        if mesh_shape == (2, 4):
            out[mesh_shape]["attention"] = _attention(rules)
            out["drop", mesh_shape] = _moe_case(rules, MOE_DROPS)
    return out


def _moe_drop_body(rank, world):
    """The dropping case on (2, 3): 10 experts pad to 12, 4 a model rank."""
    warnings.simplefilter("ignore")
    from repro_torch.sharding.rules import make_rules

    return _moe_case(make_rules(device_mesh("cpu", (2, 3), ("data", "model"))), MOE_DROPS)


ATT = dict(num_layers=2, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16)


def attention_inputs():
    rng = np.random.default_rng(1)
    h, kv, hd, Dm = 6, 2, 16, 96
    x = (rng.standard_normal((4, 16, Dm)) * 0.2).astype(np.float32)
    shapes = {"wq": (Dm, h * hd), "wk": (Dm, kv * hd), "wv": (Dm, kv * hd), "wo": (h * hd, Dm)}
    return x, {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}


def _attention(rules):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.layers import attention_schema, head_plan, multihead_attention

    cfg = dataclasses.replace(get_config("llama3.2-1b"), **ATT)
    x, params = attention_inputs()
    dims = {k: v.dims for k, v in attention_schema(cfg).items()}
    tp = {k: rules.distribute(torch.from_numpy(v), dims[k]).requires_grad_() for k, v in params.items()}
    tx = rules.distribute(torch.from_numpy(x), ("batch", None, None))
    pos = torch.arange(16).expand(4, 16)
    y = multihead_attention(tp, tx, pos, cfg, rules=rules)
    rules.full(y.square().sum()).backward()
    return {"y": rules.full(y).detach().numpy(), "plan": head_plan(cfg, rules),
            "grads": {k: rules.full(p.grad).numpy() for k, p in tp.items()}}


@pytest.fixture(scope="module")
def port_moe():
    out = run_ranks(_moe_body, 8, device="cpu", timeout=300)[0]
    out["drop", (2, 3)] = run_ranks(_moe_drop_body, 6, device="cpu", timeout=300)[0]
    return out


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
def test_moe_sharded_matches_jax_sharded_and_global(jax_moe, port_moe, mesh_shape):
    out = port_moe[mesh_shape]
    assert out["sharded"]
    tag = "%dx%d_" % mesh_shape
    for ref in (tag, "global_"):
        np.testing.assert_allclose(out["y"], jax_moe[ref + "y"], atol=1e-5, rtol=0)
        for k in ("load_balance", "router_z"):
            np.testing.assert_allclose(out[k], jax_moe[ref + k], atol=1e-5, rtol=0)
        for k in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_allclose(out["g_" + k], jax_moe[ref + "g_" + k], atol=2e-4, rtol=0)


@pytest.mark.parametrize("mesh_shape", DROP_MESHES)
def test_moe_sharded_with_drops_matches_jax_sharded(jax_moe, port_moe, mesh_shape):
    """Capacity factor 0.5: each data shard's capacity drops assignments (counted on rank
    0's shard), the same ones as in JAX's ``_moe_ffn_sharded``."""
    out = port_moe["drop", mesh_shape]
    assert out["sharded"] and out["dropped"] > 0
    tag = "drop_%dx%d_" % mesh_shape
    np.testing.assert_allclose(out["y"], jax_moe[tag + "y"], atol=1e-5, rtol=0)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(out[k], jax_moe[tag + k], atol=1e-5, rtol=0)
    for k in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(out["g_" + k], jax_moe[tag + "g_" + k], atol=2e-4, rtol=0)


def test_padded_head_attention_matches_unsharded(port_moe):
    """6 heads on a model axis of 4 pad to (kv 2, g 4); each rank attends with 2 of them."""
    att = port_moe[(2, 4)]["attention"]
    assert tuple(att["plan"]) == (2, 4)
    cfg = dataclasses_replace(jax_get_config("llama3.2-1b"), ATT)
    x, params = attention_inputs()
    pos = jnp.broadcast_to(jnp.arange(16), (4, 16))
    want = jax_mha({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), pos, cfg)
    np.testing.assert_allclose(att["y"], np.asarray(want), atol=1e-4, rtol=0)
    for k, g in att["grads"].items():
        assert g.shape == params[k].shape and np.isfinite(g).all(), k


def dataclasses_replace(cfg, fields):
    import dataclasses

    return dataclasses.replace(cfg, **fields)


def _train_body(rank, world, archs, steps):
    warnings.simplefilter("ignore")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import make_rules
    from repro_torch.training import AdamWConfig
    from repro_torch.training.train_step import init_train_state, make_train_step

    rules = make_rules(device_mesh("cpu", (2, 2), ("data", "model")))
    opt = AdamWConfig(warmup_steps=1)
    runs = {}
    for arch in archs:
        cfg = get_config(arch).reduced()
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, num_experts=10, experts_per_token=4)
        api = build_model(cfg)
        for name, r in (("sharded", rules), ("whole", None)):
            state = init_train_state(api, torch.Generator().manual_seed(0), "cpu", rules=r)
            step = make_train_step(api, opt, r)
            losses = []
            for i in range(steps):
                toks = torch.randint(0, cfg.vocab_size, (4, 16),
                                     generator=torch.Generator().manual_seed(i))
                state, m = step(state, {"tokens": toks})
                losses.append(float(m["loss"]))
            runs[arch, name] = (losses, {k: (r.full(p) if r else p).detach().numpy()
                                         for k, p in state.params.named_parameters()})
    return runs


TRAIN_ARCHS = ("granite-moe-3b-a800m", "llama3.2-1b")


@pytest.fixture(scope="module")
def train_runs():
    return run_ranks(_train_body, 4, (TRAIN_ARCHS, 2), device="cpu", timeout=300)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_steps_match_unsharded(train_runs, arch):
    """granite with 10 experts, top-4 (5 experts a model rank), and llama, two steps each:
    the losses and every rank's parameters after them."""
    for rank_runs in train_runs:
        (ls, ps), (lw, pw) = rank_runs[arch, "sharded"], rank_runs[arch, "whole"]
        np.testing.assert_allclose(ls, lw, atol=1e-4, rtol=0)
        for k in pw:
            np.testing.assert_allclose(ps[k], pw[k], atol=1e-4, rtol=0, err_msg=k)


SERVE_ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "kimi-k2-1t-a32b", "whisper-medium",
               "hymba-1.5b")
SERVE_CASES = ((4, 0), (1, 0), (4, 6))  # (batch, sliding window): batch 1 shards the cache rows on data


def _serve_body(rank, world, archs, prompt, new, cache_len):
    """Greedy generation of reduced f32 configs on (data 2, model 3), the caches' rows
    sharded on the model axis (batch 4) or on data (batch 1), against the same engine
    unsharded on every rank."""
    warnings.simplefilter("ignore")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Engine, GenerationConfig
    from repro_torch.sharding.rules import make_rules

    rules = make_rules(device_mesh("cpu", (2, 3), ("data", "model")))
    out = {}
    for arch in archs:
        cfg = get_config(arch).reduced()
        if cfg.family == "moe":  # drop-free, so that the data shards' capacities drop nothing
            cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
        api = build_model(cfg)
        for B, window in SERVE_CASES:
            gen = torch.Generator().manual_seed(B)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, prompt), generator=gen)}
            if cfg.family == "audio":
                batch["frames"] = torch.randn(B, cfg.encoder_seq, cfg.d_model, generator=gen)
            gcfg = GenerationConfig(max_new_tokens=new, cache_len=cache_len, sliding_window=window)
            for name, r in (("sharded", rules), ("whole", None)):
                params = api.init(torch.Generator().manual_seed(3), "cpu", rules=r)
                g = Engine(api, params, gcfg, r).generate(batch)
                out[arch, B, window, name] = (g.tokens, g.logits)
    return out


@pytest.fixture(scope="module")
def serve_runs():
    return run_ranks(_serve_body, 6, (SERVE_ARCHS, 8, 4, 12), device="cpu", timeout=300)


@pytest.mark.parametrize("case", SERVE_CASES)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_generation_matches_unsharded(serve_runs, arch, case):
    """Prefill writes each rank's cache block from the K/V heads the model ranks projected;
    decode attends over the rows' shards and combines them: the tokens equal, the logits
    of every step within 1e-4, on every rank."""
    for rank_runs in serve_runs:
        (ts, ls), (tw, lw) = rank_runs[(arch, *case, "sharded")], rank_runs[(arch, *case, "whole")]
        assert torch.equal(ts, tw)
        np.testing.assert_allclose(ls.numpy(), lw.numpy(), atol=1e-4, rtol=0)
