"""The port stands alone: it imports neither JAX nor the JAX package, and
``chip_smoke.py`` refuses to run (and never reports success) without a card.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test process holds both frameworks; the subprocesses do not)
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )


def test_port_imports_no_jax_and_nothing_of_repro():
    modules = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
        for p in (SRC / "repro_torch").rglob("*.py")
    )
    for present in ("repro_torch.kernels.ops", "repro_torch.launch.serve",
                    "repro_torch.core.orchestrator", "repro_torch.rl.driver",
                    "repro_torch.serving.reward_service",
                    "repro_torch.examples.agentic_rl_e2e", "repro_torch.models.encdec",
                    "repro_torch.examples.train_lm", "repro_torch.configs.whisper_medium",
                    "repro_torch.configs.internvl2_1b", "repro_torch.configs.llama3_8b",
                    "repro_torch.core.wire", "repro_torch.core.remote",
                    "repro_torch.core.transport", "repro_torch.core.scenarios",
                    "repro_torch.core.live", "repro_torch.examples.quickstart",
                    "repro_torch.examples.remote_round",
                    "repro_torch.examples.worker_commit_round",
                    "repro_torch.examples.multi_host_round",
                    "repro_torch.sharding.rules", "repro_torch.launch.mesh",
                    "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                    "repro_torch.configs.kimi_k2_1t_a32b"):
        assert present in modules, present
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print('LEAKED', bad) if bad else print('CLEAN')\n"
    )
    res = run(["-c", code], ROOT, {"PYTHONPATH": str(SRC)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "CLEAN", res.stdout


def test_shard_worker_entry_point_loads_no_jax_and_nothing_of_repro():
    """``python -m repro_torch.core.transport`` (the port's shard worker) with
    ``--help``: it answers, and neither jax nor the JAX package was loaded."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['repro_torch.core.transport', '--help']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.core.transport', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print('LEAKED', bad) if bad else print('CLEAN')\n"
    )
    res = run(["-c", code], ROOT, {"PYTHONPATH": str(SRC)})
    assert res.returncode == 0, res.stderr
    assert "--port" in res.stdout and res.stdout.strip().endswith("CLEAN"), res.stdout
    res = run(["-m", "repro_torch.core.transport", "--help"], ROOT, {"PYTHONPATH": str(SRC)})
    assert res.returncode == 0 and "shard" in res.stdout, res.stderr


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from repro." not in src and "import repro\n" not in src


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = run([str(ROOT / "chip_smoke.py")], ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    res = run([str(tmp_path / "chip_smoke.py")], tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
