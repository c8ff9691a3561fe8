"""Multi-pod dry run: count every (arch × shape × mesh) cell's step.

The step runs on the production mesh (16×16, or 2×16×16) of a fake process
group: parameters, optimizer state, batch and caches are DTensors over
``meta`` shards, so sharding propagates and collectives are issued, but no
device is touched.  ``core.roofline.count_step`` counts what each device
does; the record carries the reference's field names, with its
``cost_analysis()`` fields filled from those counts (``source`` says so),
and the three-term roofline in H100 terms.  Layers of one unit position
have equal shapes and specs, so a cell is counted at one and two units and
the second unit's counts are scaled by the unit's repeats.

The fake group is this process's default group, so the dry run runs in a
process of its own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --out build/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.configs.registry import ARCHS
from repro_torch.core.roofline import build_report, count_step
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh, num_chips
from repro_torch.models import transformer as tfm
from repro_torch.parallel import sharding

SOURCE = ("count_step: per-device products, HBM bytes (analyze_hlo's rules on aten ops) and "
          "collectives of the step on DTensors over meta shards on a fake process group; "
          "one unit counted and scaled by its repeats; compile_s is the counting time")

SKIPS: dict[tuple[str, str], str] = {}
for _a in ARCHS:
    _c = get_config(_a)
    if not _c.supports_long_context:
        SKIPS[(_a, "long_500k")] = (
            "full-attention arch: 500k decode requires sub-quadratic "
            "attention (DESIGN.md §6)"
        )


def _depth(cfg, units: int):
    """``cfg`` cut to ``units`` repeats of its unit (the tail kept)."""
    return dataclasses.replace(cfg, n_layers=len(cfg.unit) * units + len(cfg.tail))


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _count_train(cfg, cell, mesh, opt_name: str, use_fsdp: bool):
    _, optimizer = steps_mod.choose_optimizer(cfg, opt_name)
    model = tfm.init_params(cfg, 0, "meta")
    sharding.distribute_params(
        model, sharding.param_specs(model.state_dict(), cfg, fsdp=use_fsdp, mesh=mesh), mesh)
    opt_state = optimizer.init({k: _meta(p) for k, p in model.named_parameters()})
    specs = sharding.param_specs(opt_state, cfg, fsdp=use_fsdp, mesh=mesh)
    opt_state = {k: v if k == "step" else sharding.place_tree(v, specs[k], mesh)
                 for k, v in opt_state.items()}
    batch = dict(input_specs(cfg, cell))
    batch.setdefault("labels", batch["tokens"])
    b_axes = ("data", "model") if cfg.shard_mode == "zero3" else sharding.BATCH_AXES
    batch = sharding.place_tree(batch, sharding.batch_specs(batch, mesh=mesh, axes=b_axes), mesh)
    return count_step(steps_mod.make_train_step(cfg, optimizer), model, opt_state, batch)


def _count_serve(scfg, cell, mesh):
    model = tfm.init_params(scfg, 0, "meta")
    sharding.distribute_params(
        model, sharding.param_specs(model.state_dict(), scfg, fsdp=False, mesh=mesh), mesh)
    specs = dict(input_specs(scfg, cell))
    cross = specs.pop("cross_embeds", None)
    if cross is not None:
        cross = sharding.place(cross, mesh, sharding.batch_specs(cross, mesh=mesh))
    caches = steps_mod.cache_shapes(scfg, cell.global_batch, cell.seq_len)
    caches = sharding.place_tree(caches, sharding.cache_specs(caches, scfg, mesh=mesh), mesh)
    tok = specs["tokens"]
    if cell.kind == "prefill":
        sp = scfg.shard_mode == "dp_sp"
        tok = sharding.place(tok, mesh, sharding.batch_specs(tok, mesh=mesh, seq_parallel=sp))
        step = steps_mod.make_prefill_step(scfg)
        return count_step(lambda p, t, c: step(p, t, c, cross), model, tok, caches)
    tok = sharding.place(tok, mesh, sharding.batch_specs(tok, mesh=mesh))
    step = steps_mod.make_decode_step(scfg)
    position = cell.seq_len - 1  # the last slot: every cache position is live
    return count_step(lambda p, t, c: step(p, t, position, c, cross), model, tok, caches)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool, optimizer_name: str = "auto",
               fsdp: str = "auto", extra_cfg: dict | None = None) -> dict:
    """Count one cell on the production mesh.  Returns its record."""
    cfg = get_config(arch)
    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    cell = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = num_chips(mesh)
    use_fsdp = (cfg.param_count() > 5e9) if fsdp == "auto" else (fsdp == "on")

    t0 = time.time()
    if cell.kind == "train":
        opt_name, _ = steps_mod.choose_optimizer(cfg, optimizer_name)
        count = lambda c: _count_train(c, cell, mesh, opt_name, use_fsdp)  # noqa: E731
        mode = f"train/{opt_name}{'+fsdp' if use_fsdp else ''}"
        run_cfg = cfg
    else:
        run_cfg = steps_mod.serve_config(cfg)
        count = lambda c: _count_serve(c, cell, mesh)  # noqa: E731
        mode = f"{cell.kind}/bf16"
    if run_cfg.n_units > 1:
        counts = count(_depth(run_cfg, 1)).scaled(count(_depth(run_cfg, 2)), run_cfg.n_units)
    else:
        counts = count(run_cfg)
    count_s = time.time() - t0

    mesh_tag = "2x16x16" if multi_pod else "16x16"
    report = build_report(
        cell=f"{arch}×{shape_name}×{mesh_tag}",
        chips=chips,
        flops_per_device=counts.dot_flops,
        hbm_bytes_per_device=counts.hbm_bytes,
        hlo_text=None,
        collectives=counts.collectives,
        model_flops=steps_mod.model_flops_for_cell(cfg, cell),
    )
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_tag,
        "chips": chips,
        "mode": mode,
        "source": SOURCE,
        "compile_s": round(count_s, 1),
        "flops_per_device": counts.dot_flops,
        "raw_bytes_per_device": counts.hbm_bytes,
        "fused_bytes_per_device": report.hbm_bytes_global / chips,
        "collective_wire_bytes_per_dev": report.collective_wire_bytes_per_dev,
        "collective_count": report.collective_count,
        "collectives_by_kind": {k: float(v) for k, v in report.by_kind.items()},
        "compute_s": report.compute_s,
        "memory_s": report.memory_s,
        "collective_s": report.collective_s,
        "dominant": report.dominant,
        "model_flops": report.model_flops,
        "useful_flops_ratio": report.useful_flops_ratio,
        "roofline_fraction": report.roofline_fraction,
    }
    record["residency"] = steps_mod.estimate_residency(
        cfg, cell, chips=chips, fsdp=use_fsdp,
        optimizer=(mode.split("/")[1].split("+")[0] if cell.kind == "train" else "adamw"),
    )
    return record


def _value(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--optimizer", default="auto")
    ap.add_argument("--fsdp", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--out", default=None, help="directory for per-cell json records")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose record already exists in --out")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=val (bool/int/float), e.g. "
                         "--set opt_attn_layout=true")
    ap.add_argument("--tag", default="", help="suffix for output record files")
    args = ap.parse_args(argv)

    extra_cfg = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        extra_cfg[k] = _value(v)

    archs = [args.arch.replace("-", "_").replace(".", "_")] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    failures = 0
    for arch, shape_name, multi in cells:
        tag = f"{arch} × {shape_name} × {'multi' if multi else 'single'}"
        if (arch, shape_name) in SKIPS:
            print(f"SKIP  {tag}: {SKIPS[(arch, shape_name)]}", flush=True)
            continue
        mesh_tag = "2x16x16" if multi else "16x16"
        if args.skip_existing and args.out and os.path.exists(
            os.path.join(args.out, f"{arch}__{shape_name}__{mesh_tag}.json")
        ):
            print(f"HAVE  {tag}", flush=True)
            continue
        try:
            record = lower_cell(arch, shape_name, multi_pod=multi,
                                optimizer_name=args.optimizer, fsdp=args.fsdp,
                                extra_cfg=extra_cfg or None)
            print(
                f"OK    {tag}: compute={record['compute_s']*1e3:.2f}ms "
                f"memory={record['memory_s']*1e3:.2f}ms "
                f"collective={record['collective_s']*1e3:.2f}ms "
                f"dominant={record['dominant']} "
                f"MFU@bound={record['roofline_fraction']:.1%} "
                f"count={record['compile_s']}s", flush=True
            )
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                suffix = f"__{args.tag}" if args.tag else ""
                fname = f"{arch}__{shape_name}__{record['mesh']}{suffix}.json"
                with open(os.path.join(args.out, fname), "w") as f:
                    json.dump(record, f, indent=1)
        except Exception as e:  # noqa: BLE001  a failed cell is reported and counted
            failures += 1
            print(f"FAIL  {tag}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc(limit=4)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
