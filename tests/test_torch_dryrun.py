"""The port's dry run against the reference's, on the CPU.  Smoke configs
of stablelm-3b, deepseek-moe-16b (MoE) and recurrentgemma-9b (recurrent)
are lowered by the reference's ``lower_cell`` in a subprocess with 4 XLA
host devices (its ``get_config`` and ``make_production_mesh`` patched to
the smoke config and a 2×2 mesh) and counted by the port's on a fake 2×2
group.  ``model_flops`` and ``residency`` are equal; the port's
per-device product FLOPs are within 1% of the reference's
``analyze_hlo(...).dot_flops`` (they agree to 0.7% or better), except
recurrentgemma's train step, held to 2%: the reference's convolution rule
counts the depthwise convolution's weight gradient as 2·out·(kernel
elements / feature dim), 32× its work at this width, and the port is
1.4% below it.  Also the twin of ``test_system.py``'s offload analyzer
on a counted smoke train step, and the roofline table's and the offload
report's rows from records the port's CLI writes to a tmp dir."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from _torch_gloo import ROOT
from benchmarks import torch_roofline_table
from repro_torch.configs import get_smoke_config
from repro_torch.core.analyzer import Workload, analyze
from repro_torch.core.roofline import count_step
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import transformer as tfm

CELLS = [("stablelm_3b", "train_4k"), ("stablelm_3b", "decode_32k"),
         ("stablelm_3b", "prefill_32k"), ("deepseek_moe_16b", "train_4k"),
         ("deepseek_moe_16b", "decode_32k"), ("recurrentgemma_9b", "train_4k"),
         ("recurrentgemma_9b", "decode_32k")]
FLOPS_RTOL = {("recurrentgemma_9b", "train_4k"): 0.02}

REF_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.devices()  # the device count is fixed before the dry run's own flag
from repro.launch import dryrun
from repro.launch.mesh import _make_mesh
from repro.configs import get_smoke_config
from repro.core.roofline import analyze_hlo
dryrun.get_config = get_smoke_config
dryrun.make_production_mesh = lambda multi_pod=False: _make_mesh((2, 2), ("data", "model"))
out = {}
for cell in sys.argv[1:]:
    arch, shape = cell.split(":")
    rec, _, compiled = dryrun.lower_cell(arch, shape, multi_pod=False)
    rec["dot_flops"] = analyze_hlo(compiled.as_text(), 4).dot_flops
    out[cell] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_records():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, *(f"{a}:{s}" for a, s in CELLS)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture
def smoke_dryrun(monkeypatch):
    """The port's dry run on smoke configs and a fake 2×2 mesh."""
    if dist.is_initialized():
        dist.destroy_process_group()
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: make_abstract_mesh((2, 2), ("data", "model")))
    yield dryrun
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_counts_match_reference(arch, shape, reference_records, smoke_dryrun):
    ref = reference_records[f"{arch}:{shape}"]
    rec = smoke_dryrun.lower_cell(arch, shape, multi_pod=False)
    assert rec["model_flops"] == ref["model_flops"]
    assert rec["residency"] == ref["residency"]
    assert (rec["mode"], rec["chips"]) == (ref["mode"], ref["chips"])
    rtol = FLOPS_RTOL.get((arch, shape), 0.01)
    assert abs(rec["flops_per_device"] / ref["dot_flops"] - 1) <= rtol, (
        rec["flops_per_device"], ref["dot_flops"])
    # the record has every field of the reference's that a count can fill
    missing = set(ref) - set(rec) - {"dot_flops", "temp_size_in_bytes",
                                     "argument_size_in_bytes", "output_size_in_bytes",
                                     "generated_code_size_in_bytes"}
    assert not missing and rec["source"].startswith("count_step")


def test_offload_analyzer_on_counted_step():
    """A smoke train step's counts wired into the Fig-8 analyzer."""
    cfg = get_smoke_config("stablelm_3b")
    _, opt = steps.choose_optimizer(cfg, "adamw")
    model = tfm.init_params(cfg, 0, "meta")
    state = opt.init(dict(model.named_parameters()))
    batch = {"tokens": torch.empty((4, 32), dtype=torch.int32, device="meta"),
             "labels": torch.empty((4, 32), dtype=torch.int32, device="meta")}
    c = count_step(steps.make_train_step(cfg, opt), model, state, batch)
    v = analyze(Workload("smoke-train", flops=c.dot_flops, hbm_bytes=c.hbm_bytes))
    assert v.gpu_time_s > 0 and v.pim_time_s > 0


def test_cli_records_feed_the_table_and_the_report(tmp_path, smoke_dryrun, capsys):
    out = str(tmp_path / "records")
    smoke_dryrun.main(["--arch", "stablelm-3b", "--out", out])
    smoke_dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k", "--out", out,
                       "--tag", ""])
    text = capsys.readouterr().out
    assert text.count("OK    stablelm_3b") == 3 and "SKIP  stablelm_3b × long_500k" in text
    names = sorted(os.listdir(out))
    assert names == sorted(f"{a}__{s}__16x16.json" for a, s in (
        ("stablelm_3b", "train_4k"), ("stablelm_3b", "prefill_32k"),
        ("stablelm_3b", "decode_32k"), ("mamba2_780m", "long_500k")))
    rows = torch_roofline_table.run(out)
    assert [r["name"] for r in rows] == [f"roofline/{n.split('__16x16')[0]}" for n in names]
    for r in rows:
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r["pim_offload_quadrant"].endswith("-reuse") and r["pim_wins"] in ("True", "False")
    spec = importlib.util.spec_from_file_location(
        "torch_pim_offload_report", os.path.join(ROOT, "examples", "torch_pim_offload_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    verdicts = report.main([out])
    assert len(verdicts) == 4
    assert f"PIM wins {sum(v.pim_wins for v in verdicts)}/4 cells" in capsys.readouterr().out


def test_cli_reports_a_failed_cell_and_exits_1(smoke_dryrun, monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("no sharding strategy")

    monkeypatch.setattr(smoke_dryrun, "lower_cell", broken)
    with pytest.raises(SystemExit) as e:
        smoke_dryrun.main(["--arch", "stablelm-3b", "--shape", "train_4k"])
    assert e.value.code == 1
    assert "FAIL  stablelm_3b × train_4k × single: RuntimeError: no sharding strategy" in \
        capsys.readouterr().out
