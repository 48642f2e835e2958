"""``python -m repro_torch.launch.dryrun`` in a subprocess (the fake process
group stands for 256 or 512 ranks): its records carry the JAX record's keys,
its analytic bytes equal the JAX package's for the same inputs (computed in
another subprocess: importing ``repro.launch.dryrun`` sets JAX's device
count to 512), and it reports the collectives of the sharded MoE.  The
llama train step runs once more with ``--remat off``: its peak is higher
than the default's, with the layers rematerialised.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CASES = [("llama3.2-1b", "train_4k", "single", "off"), ("kimi-k2-1t-a32b", "decode_32k", "multi", "on")]
REMAT_OFF = "llama3.2-1b:remat-off"  # CASES[0] with --remat off

_JAX_BYTES = """
import json, sys
sys.path.insert(0, "src")
from repro.launch.dryrun import tree_bytes_per_device
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import decode_shardings, decode_specs, input_shardings, input_specs
from repro.configs import INPUT_SHAPES, get_config
from repro.models import build_model
from repro.sharding.rules import make_rules
from repro.training.optimizer import abstract_adamw, adamw_state_specs
from repro.training.train_step import TrainState
out = {}
for arch, name, mesh, fsdp in %r:
    cfg, shape = get_config(arch), INPUT_SHAPES[name]
    m = make_production_mesh(multi_pod=mesh == "multi")
    rules = make_rules(m, fsdp=fsdp == "on")
    api = build_model(cfg)
    pa, ps = api.abstract_params(), api.param_specs(rules)
    rec = {}
    if shape.kind == "train":
        rec["state_bytes_per_dev"] = tree_bytes_per_device(
            TrainState(pa, abstract_adamw(pa)), TrainState(ps, adamw_state_specs(ps)), m)
        rec["batch_bytes_per_dev"] = tree_bytes_per_device(
            input_specs(cfg, shape), input_shardings(cfg, shape, rules), m)
    else:
        sa, _ = decode_specs(api, shape)
        ss, _ = decode_shardings(api, shape, rules)
        rec["state_bytes_per_dev"] = tree_bytes_per_device(pa, ps, m) + tree_bytes_per_device(sa, ss, m)
    out[arch] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    recs = {}
    for key, (arch, shape, mesh, fsdp), extra in [(c[0], c, []) for c in CASES] + [
            (REMAT_OFF, CASES[0], ["--remat", "off"])]:
        out = tmp_path_factory.mktemp("dryrun")
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                              "--shape", shape, "--mesh", mesh, "--fsdp", fsdp, "--out", str(out),
                              *extra], cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
        assert res.returncode == 0, res.stderr[-3000:]
        assert " ok " in res.stdout, res.stdout[-3000:]
        recs[key] = json.loads((out / f"{arch}_{shape}_{mesh}.json").read_text())
    return recs


def test_records_have_the_jax_keys(records):
    for rec in records.values():
        assert rec["ok"] is True
        for key in ("arch", "shape", "mesh", "devices", "fsdp", "params", "active_params", "kind",
                    "state_bytes_per_dev", "model_flops", "cost_analysis", "collectives",
                    "roofline", "layer_body_cost", "memory_analysis", "remat"):
            assert key in rec, key
        assert rec["layer_body_cost"] is None
        assert rec["cost_analysis"]["flops"] > 0 and rec["roofline"]["compute_s"] > 0
        assert rec["roofline"]["constants"]["peak_flops"] == 989e12
    assert records["llama3.2-1b"]["devices"] == 256 and records["kimi-k2-1t-a32b"]["devices"] == 512


def test_bytes_equal_jax(records):
    res = subprocess.run([sys.executable, "-c", _JAX_BYTES % (CASES,)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for arch, rec in records.items():
        for key, value in want[arch.partition(":")[0]].items():
            assert rec[key] == value, (arch, key, rec[key], value)


def test_sharded_moe_reports_collectives(records):
    """kimi's decode batch (128) divides the data axes (32): the sharded dispatch runs and its
    combines are all-reduces over the model axis, one a layer at least."""
    col = records["kimi-k2-1t-a32b"]["collectives"]
    assert col["count"] >= 61 and col["all-reduce"] > 0
    assert records["llama3.2-1b"]["collectives"]["count"] > 0


def test_remat_lowers_the_train_steps_peak(records):
    """The configs rematerialise by default, as JAX's: the train step holds each layer's
    input and no-batch products, so its peak is below the step that keeps every activation."""
    on, off = records["llama3.2-1b"], records[REMAT_OFF]
    assert on["remat"] is True and off["remat"] is False
    assert records["kimi-k2-1t-a32b"]["remat"] is True
    assert 0 < on["memory_analysis"]["peak_bytes"] < off["memory_analysis"]["peak_bytes"]
