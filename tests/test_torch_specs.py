"""The port's launch specs against the JAX package's: the abstract inputs
(shape and dtype) and their specs for every config x input shape x
production mesh, and the analytic state and batch bytes per device that
the two dry-runs record.  Importing ``repro.launch.dryrun`` sets JAX's
device count to 512, so the JAX side of the byte counts runs in a
subprocess.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import all_configs as jax_all_configs
from repro.launch import specs as jspecs
from repro.models import build_model as jax_build_model
from repro.sharding.rules import make_rules as jax_make_rules
from repro_torch.configs import INPUT_SHAPES, all_configs, get_config
from repro_torch.launch import specs
from repro_torch.launch.dryrun import tree_bytes_per_device
from repro_torch.models import build_model
from repro_torch.sharding.rules import AbstractMesh, make_rules
from repro_torch.training.optimizer import abstract_adamw, adamw_state_specs
from repro_torch.training.train_step import TrainState

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(all_configs())
MESHES = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model"))}
JAX_DTYPES = {torch.int32: jnp.int32, torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def rules_pair(mesh, fsdp=False):
    shape, names = MESHES[mesh]
    return (make_rules(AbstractMesh(shape, names), fsdp=fsdp),
            jax_make_rules(JaxAbstractMesh(shape, names), fsdp=fsdp))


def same_abstract(t, j, what):
    assert tuple(t.shape) == tuple(j.shape) and JAX_DTYPES[t.dtype] == j.dtype, (what, t, j)


def test_input_shapes_match_jax():
    assert {k: tuple(vars(v).values()) for k, v in INPUT_SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_input_and_decode_specs_match_jax(arch, mesh):
    cfg, jcfg = get_config(arch), jax_all_configs()[arch]
    api, japi = build_model(cfg), jax_build_model(jcfg)
    tr, jr = rules_pair(mesh)
    for name, shape in INPUT_SHAPES.items():
        jshape = JAX_SHAPES[name]
        assert specs.uses_sliding_window(cfg, shape) == jspecs.uses_sliding_window(jcfg, jshape)
        if shape.kind != "decode":
            got, want = specs.input_specs(cfg, shape), jspecs.input_specs(jcfg, jshape)
            assert sorted(got) == sorted(want)
            for k in got:
                same_abstract(got[k], want[k], (name, k))
            got, want = specs.input_shardings(cfg, shape, tr), jspecs.input_shardings(jcfg, jshape, jr)
            assert got == {k: tuple(v) for k, v in want.items()}, name
            continue
        (state, tok), (jstate, jtok) = specs.decode_specs(api, shape), jspecs.decode_specs(japi, jshape)
        same_abstract(tok, jtok, name)
        assert state._fields == jstate._fields
        for f in state._fields[:-1]:  # the last field is the position: an int here, int32 there
            a, b = getattr(state, f), getattr(jstate, f)
            assert (a is None) == (b is None), (name, f)
            if a is not None:
                same_abstract(a, b, (name, f))
        assert state.pos == 0 and jstate.pos.shape == () and jstate.pos.dtype == jnp.int32
        (sspec, tspec), (jsspec, jtspec) = (specs.decode_shardings(api, shape, tr),
                                            jspecs.decode_shardings(japi, jshape, jr))
        assert tspec == tuple(jtspec)
        for f in state._fields:
            a, b = getattr(sspec, f), getattr(jsspec, f)
            assert (a is None) == (b is None) and (a is None or a == tuple(b)), (name, f, a, b)


_JAX_BYTES = """
import json, sys
sys.path.insert(0, "src")
from repro.launch.dryrun import tree_bytes_per_device
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import decode_shardings, decode_specs, input_shardings, input_specs
from repro.configs import INPUT_SHAPES, all_configs
from repro.models import build_model
from repro.sharding.rules import make_rules
from repro.training.optimizer import abstract_adamw, adamw_state_specs
from repro.training.train_step import TrainState
out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for fsdp in (False, True):
        rules = make_rules(mesh, fsdp=fsdp)
        for arch, cfg in sorted(all_configs().items()):
            api = build_model(cfg)
            pa, ps = api.abstract_params(), api.param_specs(rules)
            for name, shape in INPUT_SHAPES.items():
                key = f"{arch}:{name}:{mp}:{fsdp}"
                if shape.kind == "train":
                    st = tree_bytes_per_device(TrainState(pa, abstract_adamw(pa)),
                                               TrainState(ps, adamw_state_specs(ps)), mesh)
                elif shape.kind == "prefill":
                    st = tree_bytes_per_device(pa, ps, mesh)
                else:
                    sa, _ = decode_specs(api, shape)
                    ss, _ = decode_shardings(api, shape, rules)
                    st = tree_bytes_per_device(pa, ps, mesh) + tree_bytes_per_device(sa, ss, mesh)
                b = None
                if shape.kind != "decode":
                    b = tree_bytes_per_device(input_specs(cfg, shape), input_shardings(cfg, shape, rules), mesh)
                out[key] = [st, b]
print(json.dumps(out))
"""


def port_bytes(arch, name, mp, fsdp):
    cfg, shape = get_config(arch), INPUT_SHAPES[name]
    api = build_model(cfg)
    shape_, names = MESHES["multi" if mp else "single"]
    rules = make_rules(AbstractMesh(shape_, names), fsdp=fsdp)
    sizes = dict(rules.axis_sizes)
    pa, ps = api.abstract_params(), api.param_specs(rules)
    if shape.kind == "train":
        st = tree_bytes_per_device(TrainState(pa, abstract_adamw(pa)), TrainState(ps, adamw_state_specs(ps)), sizes)
    elif shape.kind == "prefill":
        st = tree_bytes_per_device(pa, ps, sizes)
    else:
        sa, _ = specs.decode_specs(api, shape)
        ss, _ = specs.decode_shardings(api, shape, rules)
        st = tree_bytes_per_device(pa, ps, sizes) + tree_bytes_per_device(sa, ss, sizes)
    b = None
    if shape.kind != "decode":
        b = tree_bytes_per_device(specs.input_specs(cfg, shape), specs.input_shardings(cfg, shape, rules), sizes)
    return [st, b]


def test_tree_bytes_per_device_match_jax():
    """State and batch bytes per device, every arch x shape x mesh x FSDP, equal to JAX's."""
    res = subprocess.run([sys.executable, "-c", _JAX_BYTES], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(want) == len(ARCHS) * len(INPUT_SHAPES) * 4
    for key, (st, b) in want.items():
        arch, name, mp, fsdp = key.split(":")
        assert port_bytes(arch, name, mp == "True", fsdp == "True") == [st, b], key
