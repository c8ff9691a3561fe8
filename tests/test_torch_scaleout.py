"""The mesh halves of the port's training and serving on the CPU: the
three train-loop tests and the serving test of ``test_system.py`` through
``mesh=make_host_mesh(device="cpu")`` (one gloo rank); a 2×2 gloo train
step (4 processes) equal to the unsharded port (float32: loss within 1e-5
relative, every parameter within 1e-4 of its largest, as ``PERF.md`` §2
bounds card against CPU); a checkpoint saved from the 2×2 mesh restored by
``restore_onto_mesh`` onto 1×1 and 1×4, equal leaf by leaf (exactly);
``plan_rescale`` field-equal to the reference's; and ``make_host_mesh``
with no card raising ``RuntimeError``, and ``ValueError`` for a mesh that
does not hold every rank; a batch of one prompt served on the mesh."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_gloo import run_ranks
from repro.runtime import elastic as ref_elastic
from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh, mesh_axis_sizes, num_chips
from repro_torch.launch.serve import ServeEngine
from repro_torch.runtime import elastic
from repro_torch.runtime.fault_tolerance import FaultInjector, FTConfig
from torch.distributed.tensor import DTensor

LOSS_RTOL, PARAM_TOL = 1e-5, 1e-4


@pytest.fixture
def host_mesh():
    """A 1×1 mesh on a gloo group of one rank, taken down afterwards."""
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = make_host_mesh(device="cpu")
    yield mesh
    if dist.is_initialized():
        dist.destroy_process_group()


def test_host_mesh_is_one_gloo_rank(host_mesh):
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert mesh_axis_sizes(host_mesh) == {"data": 1, "model": 1} and num_chips(host_mesh) == 1
    assert make_host_mesh(4, 4, device="cpu").shape == (1, 1)  # clamped to the ranks there are


def test_make_host_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()


def test_train_loop_loss_decreases_on_a_mesh(host_mesh):
    cfg = get_smoke_config("stablelm_3b")
    run = train.build_run(cfg, optimizer_name="adamw-fast", device="cpu", mesh=host_mesh)
    assert all(isinstance(p, DTensor) for p in run.params.parameters())
    assert all(isinstance(m, DTensor) for m in run.opt_state["m"].values())
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8,
                                        structure=0.9))
    run, hist = train.train_loop(run, stream, 30, log_every=1000)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first, (first, last)


def test_train_restart_after_fault_resumes_from_checkpoint_on_a_mesh(host_mesh, tmp_path):
    cfg = get_smoke_config("musicgen_large")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    run = train.build_run(cfg, device="cpu", mesh=host_mesh)
    run, hist = train.train_loop(
        run, stream, 20, ckpt_dir=str(tmp_path),
        ft=FTConfig(checkpoint_every=5, max_restarts=2),
        injector=FaultInjector({12}), log_every=1000,
    )
    assert run.step == 20
    steps_run = [h["step"] for h in hist]
    assert 12 in steps_run  # the failed step was re-executed after restore
    assert steps_run.count(10) == 2 and steps_run.count(9) == 1  # resumed at 10
    assert store.latest_step(str(tmp_path)) == 20
    assert all(isinstance(p, DTensor) for p in run.params.parameters())


def test_train_cold_resume_on_a_mesh(host_mesh, tmp_path):
    cfg = get_smoke_config("llama3_2_3b")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    run1 = train.build_run(cfg, device="cpu", mesh=host_mesh)
    run1, _ = train.train_loop(run1, stream, 10, ckpt_dir=str(tmp_path),
                               ft=FTConfig(checkpoint_every=5), log_every=1000)
    want = {k: v.full_tensor().clone() for k, v in run1.params.state_dict().items()}
    run2 = train.build_run(cfg, seed=123, device="cpu", mesh=host_mesh)  # overwritten
    run2, hist2 = train.train_loop(run2, stream, 15, ckpt_dir=str(tmp_path),
                                   ft=FTConfig(checkpoint_every=5), log_every=1000)
    assert run2.step == 15
    assert hist2[0]["step"] == 10  # resumed, not restarted
    # a restore lands on the mesh and placements of the tree it restores into
    back = store.restore(str(tmp_path), 10, {"params": run2.params.state_dict()})
    for k, v in want.items():
        got, like = back["params"][k], run2.params.state_dict()[k]
        assert isinstance(got, DTensor) and got.placements == like.placements, k
        assert torch.equal(got.full_tensor(), v), k


def test_serve_generates_batch_on_a_mesh(host_mesh):
    cfg = get_smoke_config("gemma2_27b")
    engine = ServeEngine.build(cfg, max_seq=24, device="cpu", mesh=host_mesh)
    assert engine.mesh is host_mesh
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 8)).astype(np.int32)
    out = engine.generate(prompts, 8, temperature=0.0)
    assert out.shape == (3, 16)
    assert (out[:, :8] == prompts).all()
    # greedy decoding is deterministic, and equal to the meshless engine's
    assert (engine.generate(prompts, 8, temperature=0.0) == out).all()
    plain = ServeEngine.build(cfg, max_seq=24, device="cpu")
    assert (plain.generate(prompts, 8, temperature=0.0) == out).all()


@pytest.mark.parametrize("arch", ["gemma2_27b", "mamba2_780m", "recurrentgemma_9b"])
def test_serve_one_prompt_on_a_mesh(host_mesh, arch):
    """A batch of one prompt on the mesh gives the meshless engine's tokens:
    its batch dim of one element is placed replicated (DTensor refuses to
    fold a sharded dim of size 1 away in ``[1, T, d] @ [d, n]``)."""
    cfg = get_smoke_config(arch)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (1, 9)).astype(np.int32)
    outs = [ServeEngine.build(cfg, max_seq=16, device="cpu", mesh=m).generate(
        prompts, 6, temperature=0.0) for m in (host_mesh, None)]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_plan_rescale_equals_reference():
    for old, new, batch in (({"pod": 2, "data": 16, "model": 16}, {"data": 16, "model": 16}, 256),
                            ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, 48),
                            ({"data": 2, "model": 2}, {"data": 1, "model": 4}, 8)):
        assert dataclasses.asdict(elastic.plan_rescale(old, new, batch)) == dataclasses.asdict(
            ref_elastic.plan_rescale(old, new, batch))


SCRIPT_2X2 = r"""
import dataclasses
import numpy as np
from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime import elastic
init()
cfg = dataclasses.replace(get_smoke_config("stablelm_3b"), compute_dtype="float32")
mesh = make_host_mesh(2, 2, device="cpu")
assert mesh.shape == (2, 2)
try:
    make_host_mesh(1, 2, device="cpu")  # two of the four ranks
    partial_mesh_refused = False
except ValueError:
    partial_mesh_refused = True
run = train.build_run(cfg, "adamw", device="cpu", mesh=mesh)
batch = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)).next_batch(0)
_, _, metrics = run.step_fn(run.params, run.opt_state, batch)
run.step = 1
full = {k: v.full_tensor().numpy() for k, v in run.params.state_dict().items()}
ckpt = os.path.join(OUT, "ckpt")
store.save(train._state(run), ckpt, 1)
dist.barrier()
mesh14 = make_host_mesh(1, 4, device="cpu")
like = {"params": {k: torch.zeros(v.shape) for k, v in full.items()}}
back = elastic.restore_onto_mesh(ckpt, 1, like, mesh14, cfg)
same = all(np.array_equal(back["params"][k].full_tensor().numpy(), v) for k, v in full.items())
local = {k: list(v.to_local().shape) for k, v in back["params"].items()}
if RANK == 0:
    import json
    np.savez(os.path.join(OUT, "step.npz"), loss=float(metrics["loss"]), **full)
    with open(os.path.join(OUT, "restored14.json"), "w") as f:
        json.dump({"same": same, "local": local, "refused": partial_mesh_refused}, f)
dist.destroy_process_group()
"""


def test_2x2_gloo_train_step_equals_unsharded_and_restores_onto_other_meshes(tmp_path):
    out = run_ranks(SCRIPT_2X2, 4, tmp_path)
    got = np.load(os.path.join(out, "step.npz"))
    cfg = dataclasses.replace(get_smoke_config("stablelm_3b"), compute_dtype="float32")
    run = train.build_run(cfg, "adamw", device="cpu")
    batch = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)).next_batch(0)
    _, _, metrics = run.step_fn(run.params, run.opt_state, batch)
    loss = float(metrics["loss"])
    assert abs(float(got["loss"]) - loss) <= LOSS_RTOL * abs(loss)
    for k, v in run.params.state_dict().items():
        assert np.abs(got[k] - v.numpy()).max() <= PARAM_TOL * np.abs(v.numpy()).max(), k
    # 2×2 → 1×4: every leaf equal, wq split 4 ways on its columns, the table on its rows
    with open(os.path.join(out, "restored14.json")) as f:
        restored = json.load(f)
    assert restored["same"] and restored["refused"]
    d, hd = cfg.d_model, cfg.n_heads * cfg.hd
    assert restored["local"]["layers.0.attn.wq"] == [d, hd // 4]
    assert restored["local"]["embed.tok"] == [cfg.vocab // 4, d]
    # 2×2 → 1×1 in this process
    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = make_host_mesh(device="cpu")
    try:
        like = {"params": {k: torch.zeros(v.shape) for k, v in run.params.state_dict().items()}}
        back = elastic.restore_onto_mesh(os.path.join(out, "ckpt"), 1, like, mesh, cfg)
        for k in like["params"]:
            leaf = back["params"][k]
            assert isinstance(leaf, DTensor) and leaf.device_mesh is mesh
            np.testing.assert_array_equal(leaf.full_tensor().numpy(), got[k])
    finally:
        dist.destroy_process_group()
