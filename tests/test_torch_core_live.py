"""Live mode of the port (``repro_torch.core.live``) on CPU lanes, and the
thread-safe kernel build it relies on.

On the CPU each pool gets a :class:`CpuLane` and the payloads run the plain
RMSNorm; on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``) each
pool gets a CUDA stream and the payloads launch the kernel.  Asking for the
card where there is none raises; nothing turns into sleeps or the CPU.
"""

from __future__ import annotations

import ctypes
import os
import stat
import sys
import threading

import pytest
import torch

from repro_torch.core.live import (
    CpuLane,
    LiveModeError,
    ensure_devices,
    kernel_payload_factory,
    lane_overlap,
    run_live_scenario,
    warm_devices,
)
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.scenarios import (
    ActionTemplate,
    build_fair_share,
    build_managers,
    compile_scenario,
    install_scenario,
    live_smoke_spec,
    structural_trace,
)
from repro_torch.core.scheduler import ElasticScheduler
from repro_torch.core.simulator import EventLoop
from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref


def _sim_trace(compiled):
    spec = compiled.spec
    loop = EventLoop()
    orch = Orchestrator(build_managers(spec, loop), loop=loop, policy=ElasticScheduler(),
                        fair_share=build_fair_share(spec), incremental=True)
    install_scenario(compiled, orch)
    orch.run()
    orch.close()
    return structural_trace(orch.telemetry.records)


def test_cpu_lanes():
    lanes = ensure_devices(3, "cpu")
    assert [type(l) for l in lanes] == [CpuLane] * 3
    assert [l.index for l in lanes] == [0, 1, 2]
    assert all(l.device == torch.device("cpu") for l in lanes)
    assert warm_devices(lanes) == 3


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(LiveModeError, match="needs a CUDA card"):
        ensure_devices(4)
    with pytest.raises(LiveModeError, match="needs a CUDA card"):
        ensure_devices(4, "cuda")
    # the runner's default is the card: no card, no run (and no sleeps)
    compiled = compile_scenario(live_smoke_spec(), time_scale=0.01)
    with pytest.raises(LiveModeError):
        run_live_scenario(compiled)


def test_other_devices_refused():
    with pytest.raises(LiveModeError, match="'cuda' or 'cpu'"):
        ensure_devices(2, "meta")


def test_live_run_on_cpu_lanes_reproduces_the_sim():
    compiled = compile_scenario(live_smoke_spec(), time_scale=0.05)
    live = run_live_scenario(compiled, device="cpu", wall_limit_s=60.0)
    assert structural_trace(live.telemetry.records) == _sim_trace(compiled)
    assert len(live.telemetry.records) == 24
    payload = live.payload
    assert sorted(payload.launches) == [0, 1, 2, 3]
    assert all(n > 0 for n in payload.launches.values())
    assert sorted(len(w) for w in payload.windows.values()) == [6, 6, 6, 6]
    for x, w, out in payload.outputs.values():
        assert x.shape == (64, 64) and x.dtype == torch.float32
        torch.testing.assert_close(out, rmsnorm_ref(x, w), rtol=0, atol=0)
    ov = lane_overlap(payload.windows)
    assert ov["two_or_more_ms"] > 0 and 1.0 < ov["concurrency"] <= 4.0


def test_sleep_payloads_only_when_asked():
    compiled = compile_scenario(live_smoke_spec(), time_scale=0.05)
    live = run_live_scenario(compiled, use_kernels=False, wall_limit_s=60.0)
    assert live.payload is None
    assert structural_trace(live.telemetry.records) == _sim_trace(compiled)


def test_payload_runs_on_its_pools_lane_with_seeded_inputs():
    lanes = ensure_devices(2, "cpu")
    factory = kernel_payload_factory(lanes, {"a": 0, "b": 1}, rows=8, cols=16)
    for rtype in ("a", "b", "b"):
        factory(ActionTemplate(name="k", rtype=rtype, units=(1,), base_duration=0.002))()
    assert sorted(factory.launches) == [0, 1]
    assert len(factory.windows[0]) == 1 and len(factory.windows[1]) == 2
    x0 = factory.outputs[0][0]
    x1 = factory.outputs[1][0]
    want = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))
    assert torch.equal(x1, want) and not torch.equal(x0, x1)


def test_lane_overlap_counts():
    windows = {0: [(0.0, 10.0)], 1: [(5.0, 20.0)], 2: [(30.0, 40.0)]}  # ms
    ov = lane_overlap(windows)
    assert ov["busy_ms"] == pytest.approx(35.0)
    assert ov["any_ms"] == pytest.approx(30.0)
    assert ov["two_or_more_ms"] == pytest.approx(5.0)
    assert ov["concurrency"] == pytest.approx(35.0 / 30.0)
    assert lane_overlap({})["concurrency"] == 0.0


# ---------------------------------------------------------------------------
# the kernel build under several threads
# ---------------------------------------------------------------------------


def test_load_builds_once_under_threads(tmp_path, monkeypatch):
    """Eight threads ask for one kernel at the same moment: one compiler
    run, one library, the same handle for all.  The compiler is a stub
    script that takes a while and writes its output, so no nvcc is needed."""
    runs = tmp_path / "runs"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(runs)!r}, 'a').write('run\\n')\n"
        "time.sleep(0.3)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'stub library')\n"
    )
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.rmsnorm_error_string = lambda err: b""

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)

    barrier = threading.Barrier(8)
    libs, errors = [], []

    def first_call():
        try:
            barrier.wait()
            libs.append(_build.load("rmsnorm"))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)
    assert runs.read_text().count("run") == 1
    target = _build._library_path("rmsnorm")
    assert libs[0].path == str(target) and target.read_bytes() == b"stub library"
    assert [p.name for p in (tmp_path / "build").iterdir()] == [target.name]  # no temporaries left
    assert os.access(target, os.R_OK)
