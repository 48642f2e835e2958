"""The port's sharding rules against the JAX package's: specs, pad plans,
parameter counts, and each rank's block of the parameters on a real
(pod 2, data 2, model 2) mesh of gloo ranks.

The JAX rules are built over ``jax.sharding.AbstractMesh`` (no devices);
the port's over its ``AbstractMesh``.  The JAX side of the layout test runs
in a subprocess with eight host devices, as tests/test_sharded_equivalence.py
runs its meshes.
"""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process; the ranks hold torch alone)
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as P

from _hypothesis_compat import given, settings, st
from repro.configs import all_configs as jax_all_configs
from repro.models import build_model as jax_build_model
from repro.models.layers import ParamDef as JaxParamDef
from repro.models.layers import _pad_plan as jax_pad_plan
from repro.sharding.rules import make_rules as jax_make_rules
from repro_torch.configs import all_configs, get_config
from repro_torch.launch.mesh import device_mesh, run_ranks
from repro_torch.models import build_model
from repro_torch.models.layers import _pad_plan
from repro_torch.sharding.rules import AbstractMesh, make_rules

ROOT = Path(__file__).resolve().parents[1]
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
ARCHS = sorted(all_configs())


def jax_rules(shape, names, fsdp=False, seq_shard=False):
    return jax_make_rules(JaxAbstractMesh(shape, names), fsdp=fsdp, seq_shard=seq_shard)


def torch_rules(shape, names, fsdp=False, seq_shard=False):
    return make_rules(AbstractMesh(shape, names), fsdp=fsdp, seq_shard=seq_shard)


def leaves(schema, is_leaf, prefix=""):
    out = {}
    for k, v in schema.items():
        if is_leaf(v):
            out[prefix + k] = v
        else:
            out.update(leaves(v, is_leaf, f"{prefix}{k}/"))
    return out


def schemas(arch):
    jl = leaves(jax_build_model(jax_all_configs()[arch]).schema, lambda v: isinstance(v, JaxParamDef))
    tl = leaves(build_model(get_config(arch)).schema, lambda v: not isinstance(v, dict))
    return jl, tl


def test_every_config_of_the_jax_package_is_registered():
    assert sorted(jax_all_configs()) == ARCHS
    kimi = get_config("kimi-k2-1t-a32b")
    jkimi = jax_all_configs()["kimi-k2-1t-a32b"]
    assert {k: v for k, v in vars(kimi).items() if k != "source"} == {
        k: v for k, v in vars(jkimi).items() if k != "source"}
    assert "2507.20534" in kimi.source and "moonshotai/Kimi-K2-Base" in kimi.source


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch):
    japi, api = jax_build_model(jax_all_configs()[arch]), build_model(get_config(arch))
    assert api.param_count() == japi.param_count()
    assert api.active_param_count() == japi.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("fsdp,seq_shard", [(False, False), (True, False), (False, True), (True, True)])
def test_param_specs_match_jax(arch, mesh, fsdp, seq_shard):
    """Every ParamDef: the same shape and logical dims, and the same spec under the rules."""
    jl, tl = schemas(arch)
    assert sorted(jl) == sorted(tl)
    jr, tr = jax_rules(*mesh, fsdp, seq_shard), torch_rules(*mesh, fsdp, seq_shard)
    for path, jp in jl.items():
        tp = tl[path]
        assert (tuple(tp.shape), tuple(tp.dims), tp.init, tp.scale) == (
            tuple(jp.shape), tuple(jp.dims), jp.init, jp.scale), path
        assert tr.spec(tp.shape, tp.dims) == tuple(jr.spec(jp.shape, jp.dims)), path
    specs = build_model(get_config(arch)).param_specs(tr)
    jspecs = jax_build_model(jax_all_configs()[arch]).param_specs(jr)
    assert leaves(specs, lambda v: isinstance(v, tuple)) == {
        k: tuple(v) for k, v in leaves(jspecs, lambda v: isinstance(v, P)).items()}


@pytest.mark.parametrize("mesh", MESHES, ids=["16x16", "2x16x16"])
def test_rules_extents_match_jax(mesh):
    for fsdp in (False, True):
        jr, tr = jax_rules(*mesh, fsdp), torch_rules(*mesh, fsdp)
        assert tr.data_axes == jr.data_axes and tr.data_extent == jr.data_extent
        for dim in jr.mapping:
            assert tr.extent(dim) == jr.extent(dim), dim
        assert tr.mapping == jr.mapping


LABELS = [None, "batch", "capacity", "kv_seq", "seq", "heads", "kv_heads", "cache_seq", "qkv",
          "mlp", "vocab", "expert", "ssm_inner", "embed", "embed_tp", "layers", "head_dim",
          "ssm_state"]


@settings(max_examples=150, deadline=None)
@given(dims=st.lists(st.tuples(st.sampled_from([1, 2, 3, 8, 15, 16, 24, 32, 40, 48, 512, 4096]),
                               st.sampled_from(LABELS)), min_size=1, max_size=5),
       multi=st.booleans(), fsdp=st.booleans(), seq_shard=st.booleans())
def test_spec_matches_jax_on_random_shapes(dims, multi, fsdp, seq_shard):
    mesh = MESHES[int(multi)]
    shape, labels = [d for d, _ in dims], [lab for _, lab in dims]
    jr, tr = jax_rules(*mesh, fsdp, seq_shard), torch_rules(*mesh, fsdp, seq_shard)
    assert tr.spec(shape, labels) == tuple(jr.spec(shape, labels))


def test_pad_plan_matches_jax():
    for kv in range(1, 17):
        for g in range(1, 17):
            for ext in (1, 2, 3, 4, 8, 16):
                assert _pad_plan(kv, g, ext) == jax_pad_plan(kv, g, ext), (kv, g, ext)


# ---- each rank's blocks on a real mesh --------------------------------------------

LAYOUT_ARCHS = ("granite-moe-3b-a800m", "llama3.2-1b", "hymba-1.5b")
_JAX_LAYOUT = """
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config
from repro.models import build_model
from repro.sharding.rules import make_rules
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("pod", "data", "model"))
rules = make_rules(mesh, fsdp=True)
out = {}
for arch in %r:
    api = build_model(get_config(arch).reduced())
    specs = api.param_specs(rules)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    abstract = jax.tree_util.tree_flatten_with_path(api.abstract_params())[0]
    for (path, spec), (_, aval) in zip(flat, abstract):
        key = arch + ":" + "/".join(p.key for p in path)
        idx = NamedSharding(mesh, spec).devices_indices_map(aval.shape)
        out[key] = {str(d.id): [[s.start or 0, s.stop if s.stop is not None else n]
                                for s, n in zip(sl, aval.shape)] for d, sl in idx.items()}
print(json.dumps(out))
"""


def _blocks_body(rank, world, archs):
    warnings.simplefilter("ignore")
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import make_rules

    rules = make_rules(device_mesh("cpu", (2, 2, 2), ("pod", "data", "model")), fsdp=True)
    out = {}
    for arch in archs:
        api = build_model(get_config(arch).reduced())
        params = api.init(torch.Generator().manual_seed(3), "cpu", rules=rules)
        whole = api.init(torch.Generator().manual_seed(3), "cpu")
        for name, p in params.named_parameters():
            out[f"{arch}:{name.replace('.', '/')}"] = (
                p.to_local().numpy().copy(), whole.get_parameter(name).detach().numpy())
    return out


def test_rank_blocks_match_jax_device_slices():
    """Each of 8 gloo ranks keeps, of every reduced parameter, exactly the slice that
    JAX's ``NamedSharding.devices_indices_map`` gives the device at its mesh position."""
    res = subprocess.run([sys.executable, "-c", _JAX_LAYOUT % (LAYOUT_ARCHS,)], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr
    want = json.loads(res.stdout.strip().splitlines()[-1])
    ranks = run_ranks(_blocks_body, 8, (LAYOUT_ARCHS,), device="cpu", timeout=240)
    assert set(ranks[0]) == set(want)
    sharded = 0
    for rank, blocks in enumerate(ranks):
        for key, (local, whole) in blocks.items():
            sl = tuple(slice(a, b) for a, b in want[key][str(rank)])
            np.testing.assert_array_equal(local, whole[sl], err_msg=f"rank {rank} {key}")
            sharded += local.size < whole.size
    assert sharded > 0  # the layout is not all replication
