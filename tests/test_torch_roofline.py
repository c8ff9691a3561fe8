"""The port's roofline module, on the CPU: the HLO text readers copied from
the reference give the reference's numbers on ``tests/test_costmodel.py``'s
``SAMPLE_HLO`` (exactly); ``build_report``'s terms are the reference's
quantities over the H100's data-sheet rates; ``count_step`` is exact on a
column- then row-parallel product pair on a fake 4×4 mesh (local FLOPs,
bytes by the rules, one all-reduce of 2(g−1)/g × its operand); a loop
counted as one weighted trip equals the loop run in full; and counting one
unit and scaling by the repeats equals counting every layer, at smoke size
(to 1e-12 relative: the same sums in another order)."""

import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro.core import roofline as ref_roofline
from repro.core.costmodel import TPU_V5E
from repro_torch.configs import ShapeCell, get_smoke_config
from repro_torch.core import roofline
from repro_torch.core.costmodel import H100
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import attention, ssm
from repro_torch.parallel import sharding
from test_costmodel import SAMPLE_HLO

P = sharding.P


@pytest.fixture
def fake_group():
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_copied_parsers_equal_reference():
    a, ra = roofline.analyze_hlo(SAMPLE_HLO, 4), ref_roofline.analyze_hlo(SAMPLE_HLO, 4)
    assert (a.dot_flops, a.hbm_bytes) == (ra.dot_flops, ra.hbm_bytes)
    assert a.dot_flops == 10 * 2 * 128 * 256 * 256
    for got, want in ((a.collectives, ra.collectives),
                      (roofline.parse_collectives(SAMPLE_HLO, 4),
                       ref_roofline.parse_collectives(SAMPLE_HLO, 4))):
        assert (got.operand_bytes, got.wire_bytes, got.count, dict(got.by_kind)) == (
            want.operand_bytes, want.wire_bytes, want.count, dict(want.by_kind))
    assert roofline.fused_bytes_estimate(SAMPLE_HLO) == ref_roofline.fused_bytes_estimate(SAMPLE_HLO)
    for kind in roofline.COLLECTIVE_KINDS:
        for g in (1, 2, 16):
            assert roofline._ring_factor(kind, g) == ref_roofline._ring_factor(kind, g)


def test_build_report_in_h100_terms():
    kw = dict(cell="t", chips=256, flops_per_device=1e12, hbm_bytes_per_device=1e9,
              hlo_text=SAMPLE_HLO, model_flops=2.56e14, use_fused_bytes=False)
    r, ref = roofline.build_report(**kw), ref_roofline.build_report(**kw)
    assert r.gpu is H100
    assert r.compute_s * H100.peak_fp16 == pytest.approx(ref.compute_s * TPU_V5E.peak_bf16)
    assert r.memory_s * H100.mem_bw == pytest.approx(ref.memory_s * TPU_V5E.hbm_bw)
    assert r.collective_s * H100.link_bw == pytest.approx(ref.collective_s * TPU_V5E.ici_bw)
    assert r.dominant == "compute" and 0 < r.roofline_fraction <= 1.0 + 1e-6
    assert r.roofline_fraction == pytest.approx(2.56e14 / (256 * H100.peak_fp16) / r.bound_time_s)
    # from count_step's counts: the terms as they are
    col = roofline.CollectiveStats(operand_bytes=4e6, wire_bytes=6e6, count=2)
    c = roofline.build_report("c", 4, 2e12, 3e9, None, 1e12, collectives=col)
    assert c.compute_s == pytest.approx(2e12 / H100.peak_fp16)
    assert c.memory_s == pytest.approx(3e9 / H100.mem_bw)
    assert c.collective_s == pytest.approx(6e6 / H100.link_bw) and c.collective_count == 2


def test_count_step_exact_on_a_column_then_row_parallel_pair(fake_group):
    mesh = make_abstract_mesh((4, 4), ("data", "model"))
    M, D, F = 64, 32, 128
    x = sharding.place(torch.empty(M, D, device="meta"), mesh, P("data", None))
    w1 = sharding.place(torch.empty(D, F, device="meta"), mesh, P(None, "model"))
    w2 = sharding.place(torch.empty(F, D, device="meta"), mesh, P("model", None))

    def step(x, w1, w2):  # the row-parallel product's partial sums reduced
        return ((x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])

    c = roofline.count_step(step, x, w1, w2)
    m, f = M // 4, F // 4  # local rows and columns
    assert c.dot_flops == 2 * m * D * f + 2 * m * f * D
    out = m * D * 4
    inputs = (m * D + D * f + f * D) * 4
    products = (m * D + D * f + m * f) * 4 + (m * f + f * D + m * D) * 4  # operands + output
    assert c.collectives.count == 1
    assert c.collectives.operand_bytes == out
    assert c.collectives.wire_bytes == out * 2 * 3 / 4
    assert dict(c.collectives.by_kind) == {"all-reduce": out * 2 * 3 / 4}
    assert c.hbm_bytes == inputs + products + 2 * out + out  # + the all-reduce's, + output


def test_a_weighted_trip_counts_as_the_whole_loop():
    q = torch.randn(2, 96, 4, 16)
    k = torch.randn(2, 96, 2, 16)
    flash = lambda q, k: attention.flash_attention(q, k, k, bq=32, bk=32)  # noqa: E731
    with torch.no_grad():
        full = roofline.count_step(flash, q, k)  # CPU tensors: every trip runs
        one = roofline.count_step(flash, q.to("meta"), k.to("meta"))
    assert one.dot_flops == full.dot_flops == 9 * 2 * (2 * 2 * 2 * 32 * 32 * 16) * 2
    assert one.hbm_bytes == pytest.approx(full.hbm_bytes, rel=1e-12)
    cfg = dataclasses.replace(get_smoke_config("mamba2_780m"), compute_dtype="float32")
    block = ssm.SSM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 40, cfg.d_model)
    with torch.no_grad():
        full = roofline.count_step(lambda x: ssm.ssm_block(block, x, cfg)[0], x)
        block.to("meta")
        one = roofline.count_step(lambda x: ssm.ssm_block(block, x, cfg)[0], x.to("meta"))
    assert one.dot_flops == pytest.approx(full.dot_flops, rel=1e-12) and full.dot_flops > 0
    assert one.hbm_bytes == pytest.approx(full.hbm_bytes, rel=1e-12)


@pytest.mark.parametrize("arch,kind", [("gemma2_27b", "train"), ("deepseek_moe_16b", "decode"),
                                       ("recurrentgemma_9b", "prefill")])
def test_one_unit_scaled_by_repeats_equals_every_layer(arch, kind, fake_group):
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=3 * len(cfg.unit) + len(cfg.tail))
    cell = ShapeCell("t", 64, 4, kind)
    if kind == "train":
        count = lambda c: dryrun._count_train(c, cell, mesh, "adamw", False)  # noqa: E731
    else:
        count = lambda c: dryrun._count_serve(c, cell, mesh)  # noqa: E731
    whole = count(cfg)
    scaled = count(dryrun._depth(cfg, 1)).scaled(count(dryrun._depth(cfg, 2)), cfg.n_units)
    assert cfg.n_units == 3 and whole.dot_flops > 0
    assert scaled.dot_flops == pytest.approx(whole.dot_flops, rel=1e-12)
    assert scaled.hbm_bytes == pytest.approx(whole.hbm_bytes, rel=1e-12)
    assert scaled.collectives.count == whole.collectives.count
    assert scaled.collectives.wire_bytes == pytest.approx(whole.collectives.wire_bytes, rel=1e-12)
    for kind_, v in whole.collectives.by_kind.items():
        assert scaled.collectives.by_kind[kind_] == pytest.approx(v, rel=1e-12)
