"""Training driver: data → step → metrics, with checkpoint/restart fault
tolerance and straggler monitoring, on the CUDA card (the CPU when asked),
and, given a ``DeviceMesh``, sharded over its ranks: parameters, optimizer
state and batches are then DTensors placed by ``parallel.sharding``.  On
the card, with or without a mesh, the step is compiled, as the reference
jits it: the first step runs eagerly, then the whole step is captured as a
CUDA graph and replayed (``launch.graphs.GraphedTrainStep``).  On the CPU
(and a gloo mesh) it runs eagerly.
Usage:

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --smoke \
      --steps 50 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --smoke \
      --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import store
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.graphs import GraphedTrainStep
from repro_torch.launch.mesh import check_device
from repro_torch.models import transformer as tfm
from repro_torch.models.spmd import full, on_mesh
from repro_torch.parallel import sharding
from repro_torch.pim.frontend import resolve_device
from repro_torch.runtime.fault_tolerance import (
    FTConfig,
    FaultInjector,
    RestartPolicy,
    StragglerDetector,
)


@dataclasses.dataclass
class TrainRun:
    """Holds the step function and live state; restartable.  ``params`` is
    the model, updated in place by each step; ``mesh`` the mesh it is
    sharded over, if any."""

    cfg: object
    step_fn: object
    params: tfm.Transformer
    opt_state: dict
    step: int
    mesh: object = None


def build_run(cfg, optimizer_name="adamw", seed=0, device=None, mesh=None,
              fsdp=False, compile=True) -> TrainRun:
    """The model drawn from ``seed`` and its optimizer state on ``device``
    (``None`` = the CUDA card; ``RuntimeError`` without one unless
    ``device="cpu"``).  With a ``mesh`` (on ``device``'s type) every rank
    draws the same model; the parameters and the optimizer state (its step
    count stays a whole scalar on the device) keep their shards by
    ``param_specs`` (``fsdp`` also splits the non-TP dim over ``data``), the
    step places each batch by ``batch_specs``, and its metrics are whole on
    every rank.  On the card, with or without a mesh, ``step_fn`` is
    compiled: its first call runs eagerly, later calls replay that step
    captured as a CUDA graph; a capture that fails raises.
    ``compile=False`` runs every step eagerly on the card too, as
    ``jax.disable_jit`` does the reference's."""
    device = resolve_device(device)
    _, optimizer = steps_mod.choose_optimizer(cfg, optimizer_name)
    params = tfm.init_params(cfg, seed, device)
    opt_state = optimizer.init(dict(params.named_parameters()))
    step_fn = steps_mod.make_train_step(cfg, optimizer)
    if mesh is not None:
        check_device(mesh, device)
        sharding.distribute_params(
            params, sharding.param_specs(params.state_dict(), cfg, fsdp=fsdp, mesh=mesh), mesh)
        specs = sharding.param_specs(opt_state, cfg, fsdp=fsdp, mesh=mesh)
        opt_state = {k: v if k == "step" else sharding.place_tree(v, specs[k], mesh)
                     for k, v in opt_state.items()}
        step_fn = _sharded_step(step_fn, mesh)
    if device.type == "cuda" and compile:
        step_fn = GraphedTrainStep(step_fn, mesh)
    return TrainRun(cfg=cfg, step_fn=step_fn, params=params, opt_state=opt_state, step=0,
                    mesh=mesh)


def _sharded_step(step_fn, mesh):
    """``step_fn`` on ``mesh``: the batch placed by ``batch_specs`` (a
    compiled step's static batch is placed already), the metrics gathered
    whole."""
    def step(params, opt_state, batch):
        specs = sharding.batch_specs(batch, mesh=mesh)
        batch = {k: v if isinstance(v, DTensor) else sharding.place(v, mesh, specs[k])
                 for k, v in batch.items()}
        with on_mesh(mesh):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        return params, opt_state, {k: full(v) for k, v in metrics.items()}

    return step


def _state(run: TrainRun) -> dict:
    """What a checkpoint holds: parameters, optimizer state and the step."""
    return {"params": run.params.state_dict(), "opt_state": run.opt_state,
            "step": torch.tensor(run.step, dtype=torch.int32)}


def _restore(run: TrainRun, ckpt_dir: str, step: int) -> None:
    """The checkpoint of ``step`` copied into the run's own parameter and
    optimizer-state tensors (a captured step goes on updating those)."""
    state = store.restore(ckpt_dir, step, _state(run))
    run.params.load_state_dict(state["params"])
    _copy_into(run.opt_state, state["opt_state"])
    run.step = int(state["step"])


@torch.no_grad()
def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k, v in dst.items():
            _copy_into(v, src[k])
    else:
        dst.copy_(src)


def train_loop(
    run: TrainRun,
    stream,
    total_steps: int,
    *,
    ckpt_dir: str | None = None,
    ft: FTConfig | None = None,
    injector: FaultInjector | None = None,
    log_every: int = 10,
    host: str = "host0",
):
    """Fault-tolerant training loop.  Returns (run, history).  A step that
    raises ``RuntimeError`` (a CUDA error or an injected fault among them)
    restarts from the latest checkpoint, within the restart budget; with no
    checkpoint it runs the step again from the state it holds.  The step
    updates the moments and the parameters in place, so a failure there
    (``steps.UpdateInterrupted``) leaves that state partly updated: with no
    checkpoint to go back to, it is raised."""
    ft = ft or FTConfig()
    checkpointer = store.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    detector = StragglerDetector(ft)
    policy = RestartPolicy(max_restarts=ft.max_restarts)
    history = []
    device = next(run.params.parameters()).device

    # resume if a checkpoint exists
    if ckpt_dir:
        last = store.latest_step(ckpt_dir)
        if last is not None:
            _restore(run, ckpt_dir, last)
            print(f"[train] resumed from step {run.step}")

    while run.step < total_steps:
        try:
            t0 = time.time()
            if injector is not None:
                injector.maybe_fail(run.step)
            batch = {k: v.to(device) for k, v in stream.next_batch(run.step).items()}
            run.params, run.opt_state, metrics = run.step_fn(run.params, run.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            is_straggler = detector.report(host, dt)
            history.append({"step": run.step, "loss": loss, "time_s": dt})
            if run.step % log_every == 0:
                print(f"[train] step={run.step} loss={loss:.4f} {dt*1e3:.0f}ms"
                      + (" STRAGGLER" if is_straggler else ""))
            run.step += 1
            if checkpointer and run.step % ft.checkpoint_every == 0:
                checkpointer.save(_state(run), run.step)
        except RuntimeError as e:
            backoff = policy.on_failure(e)  # raises when budget exhausted
            print(f"[train] failure at step {run.step}: {e}; restart #{policy.restarts} "
                  f"after {backoff:.1f}s backoff")
            time.sleep(min(backoff, 0.1))  # clamped for tests
            if checkpointer:
                checkpointer.wait()
            last = store.latest_step(ckpt_dir) if ckpt_dir else None
            if last is not None:
                _restore(run, ckpt_dir, last)
            elif isinstance(e, steps_mod.UpdateInterrupted):
                raise

    if checkpointer:
        if run.step % ft.checkpoint_every:
            checkpointer.save(_state(run), run.step)
        checkpointer.wait()
    return run, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--inject-fault-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run = build_run(cfg, optimizer_name=args.optimizer, device=args.device)
    n_params = sum(p.numel() for p in run.params.parameters())
    device = next(run.params.parameters()).device
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params on {device}")
    stream = SyntheticStream(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.batch)
    )
    injector = FaultInjector({args.inject_fault_at}) if args.inject_fault_at else None
    run, history = train_loop(
        run, stream, args.steps, ckpt_dir=args.ckpt_dir,
        ft=FTConfig(checkpoint_every=10), injector=injector,
    )
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"[train] done: step={run.step} loss {first:.4f} → {last:.4f}")
    return history


if __name__ == "__main__":
    main()
