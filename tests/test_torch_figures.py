"""The port's Fig 3, Fig 5 and fused-MAC tables against the JAX reference
benchmarks: every row has the same name and the same value in every column
both tables have (all but the timed ``us_per_call``); the reference's
``tpu_*`` columns become ``h100_*`` columns, which equal their formula
from the H100 configuration."""

import pytest

from benchmarks import fig3_arith as ref_fig3
from benchmarks import fig5_matmul as ref_fig5
from benchmarks import fig_fused as ref_fused
from benchmarks import torch_fig3_arith, torch_fig5_matmul, torch_fig_fused
from repro_torch.core.costmodel import H100

FIGURES = {
    "fig3": (ref_fig3, torch_fig3_arith, {"tpu_membound_tops", "tpu_peak_tops"},
             {"h100_membound_tops", "h100_peak_tops"}),
    "fig5": (ref_fig5, torch_fig5_matmul,
             {"tpu_membound_pairs_per_s", "tpu_computebound_pairs_per_s"},
             {"h100_membound_pairs_per_s", "h100_computebound_pairs_per_s"}),
    "fig_fused": (ref_fused, torch_fig_fused, set(), set()),
}


@pytest.fixture(scope="module", params=list(FIGURES))
def tables(request):
    ref_mod, port_mod, ref_only, port_only = FIGURES[request.param]
    return (request.param, ref_mod.run(), port_mod.run(device="cpu"), ref_only,
            port_only)


def test_rows_equal_reference_on_shared_columns(tables):
    name, ref_rows, port_rows, ref_only, port_only = tables
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
        else:
            assert not any(c.startswith("h100_") for c in row)
