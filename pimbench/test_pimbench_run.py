"""Runs of every cell on the CPU at a tiny size (the port's plain kernels),
the control and the planted faults that ``correct`` has to catch, and the
command's refusals.  A card-only test runs each cell and its control at the
cell's own size: ``PYTHONPATH=src python3 -m pytest -m gpu pimbench``."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from pimbench import harness, run, spec

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]
CHECK_ALL = {"check_per_size": 2}
SEED = 2**31 + 17


def cpu_run(cell: str, seconds: float = 0.4, trace: bool = False, **kw) -> dict:
    """A run of ``cell`` at its traffic file's ``cpu_rows``."""
    traffic = {"rows": spec.load_cell(cell).traffic["cpu_rows"], **CHECK_ALL}
    result, lines = harness.run_cell(cell, SEED, seconds, trace, t_start=time.perf_counter(),
                                     device="cpu", traffic=traffic, **kw)
    assert lines[-len(result["checks"]):] == [f"check {k} {v['value']} " + (f"<= {v['max']}" if "max" in v
                                                          else f">= {v['min']}")
                          for k, v in result["checks"].items()]
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_run_is_correct(cell):
    result = cpu_run(cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert result["checks"]["wrong_rows"]["value"] == 0
    assert result["checks"]["checked_calls"]["value"] >= 1
    assert list(result)[-1] == "checks"
    # Every end-to-end metric of the cell but the card's memory.
    assert set(result["metrics"]) == {m["name"] for m in spec.load_cell(cell).end_to_end} - {
        "peak_device_gib"}
    assert result["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", ["memristive.f32_bulk", "memristive.int8_bulk"])
def test_cpu_control_is_not_correct(cell):
    result = cpu_run(cell, seconds=0.2, control=True)
    assert not result["correct"]
    assert result["checks"]["wrong_rows"]["value"] > 0


def _unchanged(orig, key, planes, mode="auto"):
    """The crossbar's state comes back as it went in: the last input's planes."""
    from repro_torch.kernels import pim_bitserial
    return planes[-len(pim_bitserial._SCHEDULES[key].output_slots):]


def _half(orig, key, planes, mode="auto"):
    """Half of the rows are left out: their words stay zero."""
    out = orig(key, planes[:, :planes.shape[1] // 2], mode)
    return torch.nn.functional.pad(out, (0, planes.shape[1] - out.shape[1]))


def _altered(orig, key, planes, mode="auto"):
    """One answer is altered where it is produced: the lowest bit of row 0."""
    out = orig(key, planes, mode).clone()
    out[0, 0] ^= 1
    return out


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", ["memristive.f32_bulk", "memristive.int8_bulk"])
def test_planted_faults_are_caught(monkeypatch, cell, fault):
    from repro_torch.kernels import pim_bitserial

    orig = pim_bitserial.run_schedule
    monkeypatch.setattr(pim_bitserial, "run_schedule",
                        lambda key, planes, mode="auto": fault(orig, key, planes, mode))
    result = cpu_run(cell, seconds=0.2)
    assert not result["correct"] and result["checks"]["wrong_rows"]["value"] > 0


def test_a_fault_in_one_call_size_is_caught(monkeypatch):
    """Every size sent is checked: a fault that only the calls of one size
    meet, one call in three, fails the run."""
    from repro_torch.kernels import pim_bitserial

    orig = pim_bitserial.run_schedule

    def rare_size_altered(key, planes, mode="auto"):
        return (_altered if planes.shape[1] == 17 else lambda o, *a: o(*a))(
            orig, key, planes, mode)

    monkeypatch.setattr(pim_bitserial, "run_schedule", rare_size_altered)
    result, _ = harness.run_cell("memristive.resnet50_f32", SEED, 1.5, False,
                                 t_start=time.perf_counter(), device="cpu",
                                 traffic={"rows": [[40, 2], [520, 1]], "check_per_size": 1})
    assert result["attempted"] >= 3 and result["checks"]["unchecked_sizes"]["value"] == 0
    assert not result["correct"] and result["checks"]["wrong_rows"]["value"] > 0


def test_command_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(os, "environ", dict(os.environ))  # the command sets cache paths
    monkeypatch.setattr(sys, "path", list(sys.path))
    assert run.main(["--workload", CELLS[0], "--seed", "3", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_command_refuses_jax_by_whole_names():
    clean = ["torch", "repro_torch.pim", "repro_torch_lookalike", "reproduce", "jaxtyping"]
    assert run.forbidden_modules(clean) == []
    assert run.forbidden_modules([*clean, "jax.numpy", "repro.core", "flax"]) == [
        "flax", "jax", "repro"]


def test_command_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.PKG, tmp_path / "pimbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "pimbench/run.py", "--workload", CELLS[0],
                           "--seed", "3", "--seconds", "1"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_module_imports_jax_or_the_reference():
    """Top-level names compared whole: ``repro_torch`` is not ``repro``."""
    banned = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}
    for path in spec.PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".", 1)[0] not in banned, (path, name)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_card_run_and_control_at_the_cells_size(cuda, cell):
    result, _ = harness.run_cell(cell, SEED, 1.0, False, t_start=time.perf_counter())
    assert result["correct"], result["checks"]
    control, _ = harness.run_cell(cell, SEED, 1.0, False, t_start=time.perf_counter(),
                                  control=True)
    assert not control["correct"] and control["checks"]["wrong_rows"]["value"] > 0
