"""The port's Fig 3, Fig 4, Fig 5, fused-MAC, Fig 6/7 and executor-mode
tables against the JAX reference benchmarks: every row has the same name
and the same value in every column both tables have (all but the timed
``us_per_call``); the reference's ``tpu_*`` columns become ``h100_*``
columns, which equal their formula from the H100 configuration.  Fig 6/7
run on the same measurements on both sides (``_measure`` patched, in the
test only, to return the port's FLOPs and bytes and a fixed time), so no
model runs; the executor-mode rows agree on the schedule's shape and the
auto mode, with the reference's timing patched out (its Pallas loop kernel
does not run on the installed JAX)."""

import pytest

from benchmarks import exec_modes as ref_exec
from benchmarks import fig3_arith as ref_fig3
from benchmarks import fig4_cc as ref_fig4
from benchmarks import fig5_matmul as ref_fig5
from benchmarks import fig6_cnn_infer as ref_fig6
from benchmarks import fig7_cnn_train as ref_fig7
from benchmarks import fig_fused as ref_fused
from benchmarks import (torch_exec_modes, torch_fig3_arith, torch_fig4_cc, torch_fig5_matmul,
                        torch_fig6_cnn_infer, torch_fig7_cnn_train, torch_fig_fused)
from repro_torch.core.aritpim import op_io_bits
from repro_torch.core.costmodel import H100, MEMRISTIVE_PIM, PAPER_GATE_COUNTS
from repro_torch.models import cnn

FIGURES = {
    "fig3": (ref_fig3, torch_fig3_arith, {"tpu_membound_tops", "tpu_peak_tops"},
             {"h100_membound_tops", "h100_peak_tops"}),
    "fig5": (ref_fig5, torch_fig5_matmul,
             {"tpu_membound_pairs_per_s", "tpu_computebound_pairs_per_s"},
             {"h100_membound_pairs_per_s", "h100_computebound_pairs_per_s"}),
    "fig_fused": (ref_fused, torch_fig_fused, set(), set()),
    "fig4": (ref_fig4, torch_fig4_cc, {"improvement_vs_tpu_membound"},
             {"improvement_vs_h100_membound"}),
}


@pytest.fixture(scope="module", params=list(FIGURES))
def tables(request):
    ref_mod, port_mod, ref_only, port_only = FIGURES[request.param]
    return (request.param, ref_mod.run(), port_mod.run(device="cpu"), ref_only,
            port_only)


def test_rows_equal_reference_on_shared_columns(tables):
    _assert_rows_equal(*tables)


def _assert_rows_equal(name, ref_rows, port_rows, ref_only, port_only):
    assert [r["name"] for r in port_rows] == [r["name"] for r in ref_rows]
    for ref, port in zip(ref_rows, port_rows):
        assert set(ref) - set(port) == ref_only, name
        assert set(port) - set(ref) == port_only, name
        for col in set(ref) & set(port) - {"us_per_call"}:
            assert port[col] == ref[col], (ref["name"], col)
        assert (port["us_per_call"] == "") == (ref["us_per_call"] == "")
        # the port keeps the reference's column order, h100 in place of tpu
        renamed = [c.replace("tpu_", "h100_") for c in ref]
        assert list(port) == renamed


def test_h100_columns_equal_their_formula(tables):
    name, _, port_rows, _, _ = tables
    for row in port_rows:
        if name == "fig5":
            n = int(row["name"].rsplit("n", 1)[1])
            bytes_, flops = 3 * n * n * 4, 2 * n**3
            assert row["h100_membound_pairs_per_s"] == f"{H100.mem_bw / bytes_:.3g}"
            assert row["h100_computebound_pairs_per_s"] == f"{H100.peak_fp32 / flops:.3g}"
        elif name == "fig3":
            nbits = torch_fig3_arith._OPS[row["name"].split("/")[1]][2]
            assert row["h100_membound_tops"] == f"{H100.mem_bw / (3 * nbits // 8) / 1e12:.3f}"
            assert row["h100_peak_tops"] == f"{H100.peak_fp16 / 1e12:.0f}"
        elif name == "fig4":
            op = row["name"].split("/")[1]
            pim = MEMRISTIVE_PIM.op_throughput(PAPER_GATE_COUNTS[op])
            io_bytes = op_io_bits(*torch_fig4_cc._FIG_OPS[op]) // 8
            assert row["improvement_vs_h100_membound"] == f"{pim / (H100.mem_bw / io_bytes):.1f}x"
        else:
            assert not any(c.startswith("h100_") for c in row)


@pytest.mark.parametrize("train", [False, True], ids=["fig6", "fig7"])
def test_cnn_rows_equal_reference_on_shared_columns(train, monkeypatch):
    batch = torch_fig6_cnn_infer.BATCH
    assert batch == ref_fig6.BATCH
    measured = {name: (*cnn.step_cost(name, batch, 224, train), 1234.5)
                for name in torch_fig6_cnn_infer.NAMES}

    def fake(name, train=False, device=None):
        return measured[name]

    monkeypatch.setattr(ref_fig6, "_measure", fake)
    monkeypatch.setattr(torch_fig6_cnn_infer, "_measure", fake)
    ref_rows = ref_fig7.run() if train else ref_fig6.run()
    port_rows = (torch_fig7_cnn_train.run(device="cpu") if train
                 else torch_fig6_cnn_infer.run(device="cpu"))
    for row in port_rows:
        flops, bytes_, _ = measured[row["name"].split("/")[1]]
        t = max(flops / H100.peak_fp32, bytes_ / H100.mem_bw)
        assert row["h100_imgs_per_s"] == f"{batch / t:.1f}"
        assert row["us_per_call"] == "1234"
    _assert_rows_equal("fig7" if train else "fig6", ref_rows, port_rows,
                       {"tpu_imgs_per_s"}, {"h100_imgs_per_s"})


def test_exec_mode_rows_equal_reference_on_schedule_columns(monkeypatch):
    monkeypatch.setattr(ref_exec, "time_fn", lambda *args, **kwargs: 0.0)
    ref_rows = ref_exec.run()
    port_rows = torch_exec_modes.run(device="cpu")
    modes = {"pallas-loop": "cuda-loop", "pallas-unrolled": "cuda-unrolled"}
    assert [r["name"] for r in port_rows] == [
        "/".join(modes.get(part, part) for part in r["name"].split("/")) for r in ref_rows]
    for ref, port in zip(ref_rows, port_rows):
        assert list(port) == list(ref)
        for col in ("gates", "num_cols", "waves", "auto_mode"):
            assert port[col] == ref[col], (port["name"], col)
        assert float(port["us_per_call"]) > 0
    assert {r["auto_mode"] for r in port_rows} == {"loop", "unrolled"}
