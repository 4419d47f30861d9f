"""Each cell rehearsed end to end on the CPU in a process of its own: a
result line in the benchmark's format, and no module of JAX or of the
JAX package loaded (top-level names compared whole)."""

import json
import shutil
import subprocess
import sys
import types

import pytest

from port_bench.lib import env, spec

ROOT = spec.ROOT
CELLS = [c["name"] for c in spec.benchmark()["workloads"]]
PROBE = (
    "import sys, json; sys.path.insert(0, {root!r}); "
    "from port_bench.lib import env; env.pin_caches(); "
    "from port_bench.lib import harness; rc = harness.execute({argv!r}, 0.0); "
    "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))"
)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_prints_a_result_and_loads_no_jax(cell, trace):
    argv = ["--workload", cell, "--seed", str(2**33 + 7), "--seconds", "1", "--trace", str(trace), "--rehearse"]
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), argv=argv)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    result, modules = json.loads(lines[-2]), json.loads(lines[-1])
    assert {"correct", "attempted", "failed", "metrics", "device", "checks"} <= set(result)
    assert list(result)[-1] == "checks" and result["correct"] is True
    assert not set(modules) & set(env.FORBIDDEN)
    assert "cough_detector_tpu_torch" in modules
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cough_detector_tpu_torch_like", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "cough_detector_tpu.ops", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    found = env.forbidden_modules()
    assert "cough_detector_tpu.ops" in found and "jax.numpy" in found
    assert not any(m.split(".")[0] == "cough_detector_tpu_torch_like" for m in found)


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0", "--rehearse"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
