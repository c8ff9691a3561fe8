"""Sharding rules: parameter-name patterns → per-dimension specs
(DP/FSDP/TP/EP/SP), placed on a ``DeviceMesh`` as DTensor placements.

Axes: ``pod`` (inter-pod DP), ``data`` (DP / FSDP / SP), ``model`` (TP / EP).
A spec is a :class:`PartitionSpec`: one entry per tensor dimension, each
``None`` (replicated), a mesh axis name, or a tuple of names (major first),
so it compares entry for entry with the reference's.  The rules are keyed
by the port's ``state_dict`` names (``layers.{i}.attn.wq``, ``embed.tok``),
matched with ``/`` for ``.``; the port keeps one tensor a layer, so only
names under ``units.`` (Adafactor's stacks of a unit's repeats) carry the
reference's leading stacked dimension.
"""

from __future__ import annotations

import re

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.configs.base import ModelConfig

BATCH_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """Per-dimension mesh axes of one tensor (``jax.sharding.PartitionSpec``'s
    meaning): ``P("model", None)`` shards dim 0 over ``model``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _rules(cfg: ModelConfig, fsdp: bool) -> list[tuple[str, P]]:
    """Ordered (regex, spec); first match wins.  Paths look like
    ``layers/0/attn/wq`` or ``embed/tok``."""
    if cfg.shard_mode == "dp_sp":
        # replicated weights (sequence parallelism carries the model axis)
        d = "data" if fsdp else None
        return [(r".*", P(d))] if fsdp else [(r".*", P())]
    if cfg.shard_mode == "zero3":
        # pure data parallelism with fully-sharded params/grads/optimizer
        # (ZeRO-3): batch over (data, model); params sharded dim0 over both
        # axes; per-layer all-gather on use, reduce-scatter on grads
        return [
            (r"(norm|_norm|lam|A_log|/D$|dt_bias|conv_[wb]|b[qkv]$)", P()),
            (r".*", P(("data", "model"))),
        ]
    d = "data" if fsdp else None  # FSDP shards the non-TP dim over data
    expert_mode = cfg.moe_shard_mode == "expert"
    return [
        # embeddings
        (r"embed/tok$", P("model", d)),
        (r"embed/head$", P(d, "model")),
        # attention
        (r"attn/wq$", P(d, "model")),
        (r"attn/wk$", P(d, "model")),
        (r"attn/wv$", P(d, "model")),
        (r"attn/wo$", P("model", d)),
        (r"attn/b[qkv]$", P("model")),
        # dense mlp + shared experts
        (r"(mlp|shared)/w_(up|gate)$", P(d, "model")),
        (r"(mlp|shared)/w_down$", P("model", d)),
        # MoE experts: EP over model (deepseek) or per-expert TP (grok)
        (r"moe/router$", P()),
        (r"moe/w_(up|gate)$", P("model", d, None) if expert_mode else P(None, d, "model")),
        (r"moe/w_down$", P("model", d, None) if expert_mode else P(None, "model", d)),
        # mamba-2
        (r"ssm/w_in$", P(d, "model")),
        (r"ssm/w_out$", P("model", d)),
        (r"ssm/conv_[wb]$", P()),
        (r"ssm/(A_log|D|dt_bias|norm_w)$", P()),
        # RG-LRU
        (r"rec/w_[xy]$", P(d, "model")),
        (r"rec/w_[ri]$", P(None, "model")),
        (r"rec/w_out$", P("model", d)),
        (r"rec/(conv_[wb]|lam)$", P()),
        # norms and anything small
        (r"(norm|_norm)", P()),
        (r".*", P()),
    ]


def _map_with_path(fn, tree, path=()):
    """``fn(path_str, leaf)`` over nested dicts, lists and tuples of
    tensors; dict keys' dots become path separators."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, (*path, str(i))) for i, v in enumerate(tree))
    return fn("/".join(path).replace(".", "/"), tree)


def sanitize_spec(spec: P, shape, mesh: DeviceMesh | None) -> P:
    """Specs must tile evenly: drop (replicate) any axis whose size doesn't
    divide the dim (e.g. mamba2's vocab 50280 on a 16-way model axis)."""
    if mesh is None:
        return spec
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for i, entry in enumerate(tuple(spec)):
        if entry is None or i >= len(shape):
            out.append(None if i >= len(shape) else entry)
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        total = 1
        for a in axes:
            total *= sizes.get(a, 1)
        out.append(entry if total and shape[i] % total == 0 else None)
    return P(*out)


def param_specs(params_or_shapes, cfg: ModelConfig, fsdp: bool = False,
                mesh: DeviceMesh | None = None):
    """A spec for every tensor of a tree keyed by ``state_dict`` names: the
    parameters, or an optimizer state that mirrors them under ``m``, ``v``
    or ``s`` (``meta`` tensors serve the dry run)."""
    rules = _rules(cfg, fsdp)

    def spec_for(s, leaf):
        # Adafactor's unit stacks carry a leading n_units dim
        stacked = "units/" in s
        for pat, spec in rules:
            if re.search(pat, s):
                spec = _trim_to_rank(spec, leaf, stacked)
                return sanitize_spec(spec, leaf.shape, mesh)
        return P()

    return _map_with_path(spec_for, params_or_shapes)


def _trim_to_rank(spec: P, leaf, stacked: bool) -> P:
    ndim = len(leaf.shape)
    tup = tuple(spec)
    if stacked:
        tup = (None,) + tup  # leading n_units dim
    tup = tup[:ndim]
    tup = tup + (None,) * (ndim - len(tup))
    return P(*tup)


def batch_specs(batch, *, seq_parallel: bool = False, mesh: DeviceMesh | None = None,
                axes: tuple = BATCH_AXES):
    """Input sharding: batch over ``axes``; optional sequence-parallel."""

    def spec_for(name, leaf):
        ndim = len(leaf.shape)
        if ndim == 0:
            return P()
        if name.endswith("position"):
            return P()
        if seq_parallel and ndim >= 2:
            # batch on (pod, data); sequence on the model axis
            spec = P(axes, "model", *([None] * (ndim - 2)))
        else:
            spec = P(axes, *([None] * (ndim - 1)))
        return sanitize_spec(spec, leaf.shape, mesh)

    return _map_with_path(spec_for, batch)


def cache_specs(caches, cfg: ModelConfig, mesh: DeviceMesh | None = None):
    """KV/state cache sharding: batch over (pod, data); kv-heads/feature dims
    over model where they exist.  The port's caches are a list with one dict
    a layer (no stacked dim)."""

    def spec_for(s, leaf):
        ndim = len(leaf.shape)
        tup = [None] * ndim
        if s.endswith("/pos"):
            return P(*tup)
        if s.endswith(("/k", "/v", "/k_scale", "/v_scale")):
            # [B, S, K, hd] (scales: [B, S, K])
            tup[0] = BATCH_AXES
            if cfg.shard_mode == "dp_sp":
                tup[1] = "model"  # cache sequence-sharded
            else:
                tup[2] = "model"  # cache kv-head-sharded
        elif s.endswith("/conv"):
            # [B, W-1, C]: batch only (C is a z/B/C concat; keep replicated)
            tup[0] = BATCH_AXES
        elif s.endswith("/h"):
            # ssm [B, nh, hp, ds] / rec [B, w]: shard heads/width on model
            tup[0] = BATCH_AXES
            tup[1] = "model"
        return P(*tup)

    return _map_with_path(lambda s, leaf: sanitize_spec(spec_for(s, leaf), leaf.shape, mesh),
                          caches)


def filter_spec(spec: P, mesh: DeviceMesh) -> P:
    """Drop axis names the mesh doesn't have (e.g. 'pod' on a single-pod
    mesh) so one rule set serves every mesh."""
    names = set(mesh.mesh_dim_names)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            if not kept:
                return None
            return kept[0] if len(kept) == 1 else kept
        return entry if entry in names else None

    return P(*(keep(e) for e in tuple(spec)))


def to_placements(spec: P, mesh: DeviceMesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim named in entry ``d``, ``Replicate()`` elsewhere.  A tuple entry must
    name its axes in the mesh's order (major first), as plain ``Shard``
    splits them."""
    spec = filter_spec(spec, mesh)
    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in idx:
            placements[i] = Shard(d)
    return tuple(placements)


def place(tensor: torch.Tensor, mesh: DeviceMesh, spec: P) -> DTensor:
    """``tensor`` (the whole, global value) as a DTensor on ``mesh`` by
    ``spec``.  A ``meta`` tensor becomes a DTensor of ``meta`` shards
    without any collective (the dry run); any other is split by
    ``distribute_tensor``."""
    # A dim of one element split one way is that element whole.  DTensor's
    # view rules refuse to fold a sharded dim of size 1 away (a batch of one
    # prompt, [1, T, d] @ [d, n]), so such a dim is placed replicated.
    placements = tuple(
        Replicate() if isinstance(p, Shard) and tensor.shape[p.dim] == 1 and mesh.size(i) == 1
        else p for i, p in enumerate(to_placements(spec, mesh)))
    if tensor.is_meta:
        local, _ = compute_local_shape_and_global_offset(tensor.shape, mesh, placements)
        return DTensor.from_local(torch.empty(local, dtype=tensor.dtype, device="meta"), mesh,
                                  placements, run_check=False, shape=tensor.shape,
                                  stride=tensor.stride())
    return distribute_tensor(tensor.detach(), mesh, placements)


def place_tree(tree, specs, mesh: DeviceMesh):
    """:func:`place` over a tree and its matching tree of specs."""
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, s, mesh) for v, s in zip(tree, specs))
    return place(tree, mesh, specs)


def distribute_params(module: nn.Module, specs: dict, mesh: DeviceMesh) -> nn.Module:
    """Turn each of ``module``'s parameters into a DTensor parameter on
    ``mesh`` by ``specs`` (a spec per ``state_dict`` name), in place."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        setattr(sub, leaf, nn.Parameter(place(p.data, mesh, specs[name]),
                                        requires_grad=p.requires_grad))
    return module

