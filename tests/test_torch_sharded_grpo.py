"""GRPO and gradient accumulation on a ``DeviceMesh``: six gloo ranks (spawned CPU
processes) on the (data 2, model 3) mesh, against the port unsharded and against
the JAX package's sharded step.

Reduced llama3.2-1b (4 heads on a model axis of 3: padded to 6) and reduced
granite-moe-3b-a800m (4 experts padded to 6, capacity factor 4.0: no
assignment is dropped), f32, weights drawn by the port from one seed:

* ``token_logprobs`` with the rules: the per-token log-probs and the gradient
  of a weighted sum of them within 1e-4 of the unsharded ones, with the
  sharded logits' gather (``layers._sharded_logits``) made to raise, and
  ``Engine.score`` with the rules (the same path, no gradient);
* ``grpo_loss`` with the rules: the loss and metrics within 1e-4 of JAX's
  ``grpo_loss(..., rules)`` on a mesh of Auto axes (run in a subprocess with
  eight host devices) and of the port unsharded; its gradients within 1e-4
  of each leaf's largest magnitude of both;
* ``make_grpo_step(..., rules)``: metrics within 1e-4 of both, parameters
  within 1e-4 of the port unsharded and, against JAX's, as the training suite
  holds one AdamW step (every element within 2 lr + 1e-6, 99.9% within 1e-5);
* ``make_grad_accum_train_step(..., 2, rules)``: metrics and parameters within
  1e-4 of the unsharded step.
"""

from __future__ import annotations

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import device_mesh, run_ranks
from repro_torch.models import build_model
from repro_torch.models.convert import flat_from_params

from _torch_parity import assert_params_after_one_step

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m")
N, S = 4, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)


def _api(arch):
    return build_model(get_config(arch).reduced())


def _inputs(arch):
    """(initial flat parameters, GRPO batch, [2, 2, S] accumulation tokens) as numpy; the
    rollout log-probs come from the port's unsharded policy."""
    from repro_torch.training.grpo import token_logprobs

    api = _api(arch)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, api.cfg.vocab_size, size=(N, S))
    with torch.no_grad():
        old = token_logprobs(params, torch.as_tensor(toks), api).numpy()
    mask = np.ones((N, S - 1), np.float32)
    mask[:, : S // 2] = 0.0
    batch = {"tokens": toks, "mask": mask,
             "advantages": np.array([1.0, -1.0, 0.5, -0.5], np.float32),
             "old_logp": old, "ref_logp": (old + 0.05 * rng.standard_normal(old.shape)).astype(np.float32)}
    accum = rng.integers(0, api.cfg.vocab_size, size=(2, 2, S))
    return flat_from_params(params), batch, accum


def _tensors(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _grpo_body(rank, world, cases):
    warnings.simplefilter("ignore")
    from repro_torch.models import layers
    from repro_torch.serving.engine import Engine, GenerationConfig
    from repro_torch.sharding.rules import make_rules
    from repro_torch.training import AdamWConfig, grpo_loss, make_grad_accum_train_step, make_grpo_step
    from repro_torch.training.grpo import token_logprobs
    from repro_torch.training.train_step import grads_of, init_train_state

    def no_gather(*a, **k):
        raise AssertionError("the sharded logits were gathered")

    layers._sharded_logits = no_gather
    rules = make_rules(device_mesh("cpu", (2, 3), ("data", "model")))
    weights = torch.as_tensor(np.random.default_rng(5).standard_normal((N, S - 1)), dtype=torch.float32)
    out = {}
    for arch, batch, accum in cases:
        api = _api(arch)
        for name, r in (("sharded", rules), ("whole", None)):

            def full(t):
                return (r.full(t) if r else t).detach().numpy()

            def state():
                return init_train_state(api, torch.Generator().manual_seed(0), "cpu", rules=r)

            params = state().params
            lp = token_logprobs(params, torch.as_tensor(batch["tokens"]), api, r)
            obj = ((lp.full_tensor() if r else lp) * weights).sum()
            res = {"logp": full(lp), "logp_grads": {k: full(g) for k, g in grads_of(obj, params).items()}}
            engine = Engine(api, params, GenerationConfig(), r)
            res["score"] = engine.score({"tokens": torch.as_tensor(batch["tokens"])}).numpy()
            loss, m = grpo_loss(params, _tensors(batch), api, r)
            res["grpo"] = {"loss": float(loss), **{k: float(v) for k, v in m.items()}}
            res["grpo_grads"] = {k: full(g) for k, g in grads_of(loss, params).items()}
            st, m = make_grpo_step(api, AdamWConfig(**OPT), r)(state(), _tensors(batch))
            res["step"] = {k: float(v) for k, v in m.items()}
            res["step_params"] = {k: full(p) for k, p in st.params.named_parameters()}
            st, m = make_grad_accum_train_step(api, AdamWConfig(**OPT), 2, r)(
                state(), {"tokens": torch.as_tensor(accum)})
            res["accum"] = {k: float(v) for k, v in m.items()}
            res["accum_params"] = {k: full(p) for k, p in st.params.named_parameters()}
            out[arch, name] = res
    return out


_JAX_GRPO = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import build_model
from repro.sharding.rules import make_rules
from repro.training import grpo, optimizer
from repro.training.checkpoint import _flatten, _path_str
from repro.training.train_step import TrainState
arch, opt = sys.argv[1], optimizer.AdamWConfig(**%r)
inp = np.load(sys.argv[2])
api = build_model(get_config(arch).reduced())
leaves, treedef = jax.tree_util.tree_flatten_with_path(api.init(jax.random.PRNGKey(0)))
params = jax.tree_util.tree_unflatten(
    treedef, [jnp.asarray(inp["p/" + "/".join(_path_str(k) for k in path)]) for path, _ in leaves])
batch = {k: jnp.asarray(inp["b/" + k]) for k in ("tokens", "mask", "advantages", "old_logp", "ref_logp")}
mesh = jax.make_mesh((2, 3), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:6])
rules = make_rules(mesh)
out = {}
with mesh:
    (loss, m), g = jax.jit(jax.value_and_grad(lambda p: grpo.grpo_loss(p, batch, api, rules),
                                              has_aux=True))(params)
    state, sm = jax.jit(grpo.make_grpo_step(api, opt, rules))(
        TrainState(params, optimizer.init_adamw(params)), batch)
out["grpo/loss"] = loss
for k, v in m.items(): out["grpo/" + k] = v
for k, v in _flatten(g).items(): out["grad/" + k] = v
for k, v in sm.items(): out["step/" + k] = v
for k, v in _flatten(state.params).items(): out["param/" + k] = v
np.savez(sys.argv[3], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("grpo")
    inputs = {arch: _inputs(arch) for arch in ARCHS}
    jax_out = {}
    for arch, (flat, batch, _) in inputs.items():
        np.savez(d / f"{arch}.npz", **{"p/" + k: v for k, v in flat.items()},
                 **{"b/" + k: v for k, v in batch.items()})
        res = subprocess.run([sys.executable, "-c", _JAX_GRPO % (OPT,), arch, str(d / f"{arch}.npz"),
                              str(d / f"{arch}_out.npz")], cwd=ROOT, capture_output=True, text=True,
                             timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert res.returncode == 0, res.stderr[-3000:]
        jax_out[arch] = dict(np.load(d / f"{arch}_out.npz"))
    cases = [(arch, batch, accum) for arch, (_, batch, accum) in inputs.items()]
    return run_ranks(_grpo_body, 6, (cases,), device="cpu", timeout=300), jax_out


def _close_to_max(got, want, tol=1e-4):
    assert got.keys() == want.keys()
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= tol * np.abs(w).max(), (k, err, np.abs(w).max())


def _metrics_close(got, want, tol=1e-4):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_token_logprobs_carry_a_gradient_without_gathering_the_logits(runs, arch):
    """The log-probs and their gradient, and ``Engine.score`` (no gradient) through the
    same path, against unsharded."""
    for rank in runs[0]:
        sh, wh = rank[arch, "sharded"], rank[arch, "whole"]
        np.testing.assert_allclose(sh["logp"], wh["logp"], atol=1e-4, rtol=0)
        _close_to_max(sh["logp_grads"], wh["logp_grads"])
        np.testing.assert_allclose(sh["score"], wh["score"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_grpo_matches_jax_sharded_and_unsharded(runs, arch):
    jax_out = runs[1][arch]
    want = {k.split("/", 1)[1]: float(v) for k, v in jax_out.items() if k.startswith("grpo/")}
    jgrads = {k.split("/", 1)[1]: v for k, v in jax_out.items() if k.startswith("grad/")}
    jstep = {k.split("/", 1)[1]: float(v) for k, v in jax_out.items() if k.startswith("step/")}
    jparams = {k.split("/", 1)[1]: v for k, v in jax_out.items() if k.startswith("param/")}
    for rank in runs[0]:
        sh, wh = rank[arch, "sharded"], rank[arch, "whole"]
        for ref, grads in ((want, jgrads), (wh["grpo"], wh["grpo_grads"])):
            _metrics_close(sh["grpo"], ref)
            _close_to_max({k.replace(".", "/"): v for k, v in sh["grpo_grads"].items()},
                          {k.replace(".", "/"): v for k, v in grads.items()})
        _metrics_close(sh["step"], jstep)
        _metrics_close(sh["step"], wh["step"])
        for k, w in wh["step_params"].items():
            np.testing.assert_allclose(sh["step_params"][k], w, atol=1e-4, rtol=0, err_msg=k)
        params = build_model(get_config(arch).reduced()).init(torch.Generator(), "cpu")
        with torch.no_grad():
            for k, p in params.named_parameters():
                p.copy_(torch.as_tensor(sh["step_params"][k]))
        assert_params_after_one_step(params, _nest(jparams), jstep["lr"])


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_grad_accum_matches_unsharded(runs, arch):
    for rank in runs[0]:
        sh, wh = rank[arch, "sharded"], rank[arch, "whole"]
        _metrics_close(sh["accum"], wh["accum"])
        for k, w in wh["accum_params"].items():
            np.testing.assert_allclose(sh["accum_params"][k], w, atol=1e-4, rtol=0, err_msg=k)
