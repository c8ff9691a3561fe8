"""Carry reference artifacts across to the port as plain numpy/Python data.

``compiled_from_numpy`` rebuilds a :class:`~repro_torch.core.ir.CompiledSchedule`
from the fields of a reference schedule, so a schedule compiled elsewhere
runs through the port's executors unchanged (separating compiler faults
from executor faults).  ``planes_from_numpy``/``planes_to_numpy`` convert
uint32 bit-planes to and from the port's int32 carrier, bit for bit.
``cnn_state_dict`` turns a reference CNN's parameter tree into the port
model's ``state_dict``; ``lm_params``, ``lm_opt_state`` and ``lm_caches`` do
the same for the LM substrate's parameters, optimizer state and serving
caches, unstacking the reference's ``units`` (stacked over repeats of the
layer pattern) plus ``tail`` into the port's flat per-layer order.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.pim.frontend import resolve_device

FIELDS = ("key", "ops", "num_cols", "input_cols", "output_cols", "recorded_len",
          "recorded_gates", "basis", "meta")


def compiled_from_numpy(fields: dict) -> ir.CompiledSchedule:
    """``fields``: ``key``, ``ops`` ([G, 5] ints), ``num_cols``,
    ``input_cols``/``output_cols`` (name → column list), ``recorded_len``,
    ``recorded_gates``, ``basis`` and ``meta``, as numpy/plain Python."""
    missing = [f for f in FIELDS if f not in fields]
    if missing:
        raise KeyError(f"missing schedule fields: {missing}")
    return ir.CompiledSchedule(
        key=str(fields["key"]),
        ops=np.array(fields["ops"], dtype=np.int32).reshape(-1, 5),
        num_cols=int(fields["num_cols"]),
        input_cols={k: [int(c) for c in v] for k, v in fields["input_cols"].items()},
        output_cols={k: [int(c) for c in v] for k, v in fields["output_cols"].items()},
        recorded_len=int(fields["recorded_len"]),
        recorded_gates=int(fields["recorded_gates"]),
        basis=str(fields["basis"]),
        meta=dict(fields["meta"]),
    )


def planes_from_numpy(planes: np.ndarray, device=None) -> torch.Tensor:
    """uint32 (or int32) planes → int32 tensor with the same bits, on
    ``device`` (``None`` = the CUDA card; with no card it raises
    ``RuntimeError`` unless ``device="cpu"``)."""
    device = resolve_device(device)
    planes = np.ascontiguousarray(planes)
    if planes.dtype == np.uint32:
        planes = planes.view(np.int32)
    if planes.dtype != np.int32:
        raise TypeError(f"planes must be 32-bit words, got {planes.dtype}")
    return torch.as_tensor(planes, device=device)


def planes_to_numpy(planes: torch.Tensor) -> np.ndarray:
    """int32 planes tensor → uint32 numpy array with the same bits."""
    return planes.detach().cpu().contiguous().numpy().view(np.uint32)


def cnn_state_dict(name: str, params) -> dict[str, torch.Tensor]:
    """The reference CNN parameter tree ``params`` (nested dicts and lists of
    numpy arrays, as ``repro.models.cnn``'s ``init_<name>`` makes them) as
    the ``state_dict`` of ``repro_torch.models.cnn.MODELS[name]``, float32 on
    the CPU.  Conv weights go from HWIO to OIHW, FC weights from
    ``(cin, cout)`` to ``(cout, cin)``; biases and batch norm's ``scale``,
    ``bias``, ``mean`` and ``var`` keep their values.  Raises ``ValueError``
    unless the keys and shapes are exactly the model's."""
    from repro_torch.models import cnn

    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            leaf = path[-1]
            value = np.array(node, dtype=np.float32)  # a writable copy
            if leaf == "w":
                leaf = "weight"
                value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
            elif leaf == "b":
                leaf = "bias"
            out[".".join([*map(str, path[:-1]), leaf])] = torch.from_numpy(
                np.ascontiguousarray(value))
            return
        for key, child in items:
            walk(child, (*path, key))

    walk(params, ())
    want = {k: tuple(v.shape) for k, v in cnn.MODELS[name](device="meta").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"{name}: parameters do not match the model: {diff[:6]}")
    return out


def _leaves(node, path=()):
    """(dotted path, leaf) of a nested dict tree, in insertion order."""
    if isinstance(node, dict):
        for key, child in node.items():
            yield from _leaves(child, (*path, str(key)))
    else:
        yield ".".join(path), node


def _as_numpy(leaf) -> np.ndarray:
    """A leaf as a numpy array; a 16-bit float type numpy has no name for
    (bfloat16) crosses as float32, which holds it exactly."""
    arr = np.asarray(leaf)
    return arr if arr.dtype.kind in "biuf" else arr.astype(np.float32)


def _per_layer(tree: dict, cfg) -> list[dict]:
    """The reference's ``{"units": [...], "tail": [...]}`` as one flat dict
    of numpy leaves per layer: ``units[pos]`` leaf ``[i]`` is layer
    ``i·len(unit) + pos``, then the tail's layers."""
    U, n = len(cfg.unit), cfg.n_units
    units, tail = tree["units"], tree["tail"]
    if len(units) != U or len(tail) != len(cfg.tail):
        raise ValueError(f"{cfg.name}: {len(units)} unit entries and {len(tail)} tail "
                         f"entries, the config has {U} and {len(cfg.tail)}")
    layers: list[dict] = [{} for _ in range(n * U)]
    for pos, stacked in enumerate(units):
        for name, leaf in _leaves(stacked):
            arr = _as_numpy(leaf)
            if arr.shape[:1] != (n,):
                raise ValueError(f"{cfg.name}: units[{pos}].{name} has shape {arr.shape}, "
                                 f"expected {n} stacked repeats")
            for i in range(n):
                layers[i * U + pos][name] = arr[i]
    layers += [{name: _as_numpy(leaf) for name, leaf in _leaves(t)} for t in tail]
    return layers


def _to_torch(got: dict, want: dict[str, torch.Tensor], what: str) -> dict:
    """``got`` (name → numpy array) as tensors in the dtypes of ``want``
    (name → meta tensor), on the CPU; ``ValueError`` unless keys and shapes
    match exactly."""
    got_shapes = {k: tuple(v.shape) for k, v in got.items()}
    want_shapes = {k: tuple(v.shape) for k, v in want.items()}
    if got_shapes != want_shapes:
        diff = sorted(set(got_shapes.items()) ^ set(want_shapes.items()))
        raise ValueError(f"{what} do not match the port's: {diff[:6]}")
    return {k: torch.from_numpy(np.array(v)).to(want[k].dtype) for k, v in got.items()}


def lm_params(params: dict, cfg) -> dict[str, torch.Tensor]:
    """The reference LM parameter tree ``params`` (nested dicts and lists of
    numpy arrays, as ``repro.models.transformer.init_params`` makes them;
    bf16 leaves may come as float32) as the ``state_dict`` of
    ``repro_torch.models.transformer.Transformer(cfg)``, in the port's
    dtypes on the CPU.  Raises ``ValueError`` unless every key and shape is
    exactly the model's."""
    from repro_torch.models import transformer

    want = transformer.Transformer(cfg, device="meta").state_dict()
    return _to_torch(_lm_flat(params, cfg), want, f"{cfg.name}: parameters")


def _lm_flat(tree: dict, cfg) -> dict[str, np.ndarray]:
    """A tree shaped like the reference's parameters (``embed``,
    ``final_norm``, ``units``, ``tail``; each parameter may be a dict of
    state leaves) as one flat dict keyed like the port's ``state_dict``."""
    flat = {k: _as_numpy(v) for k, v in _leaves(
        {"embed": tree["embed"], "final_norm": tree["final_norm"]})}
    for i, layer in enumerate(_per_layer(tree, cfg)):
        flat.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return flat


def lm_opt_state(opt_state: dict, cfg) -> dict:
    """The reference's optimizer state for ``cfg``'s parameters (numpy
    leaves) as the port's, on the CPU: AdamW's ``m``/``v`` (stacked over
    ``units``, plus ``tail``) unstacked by parameter name as ``lm_params``
    unstacks parameters, or Adafactor's ``s`` as the port's Adafactor keeps
    it under ``transformer.unit_stacks(cfg)``: each unit position's stacked
    state under ``units.{pos}.{name}``, the tail's by parameter name; and
    ``step``.  Raises ``ValueError`` unless every key and shape is the port
    optimizer's."""
    from repro_torch.models import transformer
    from repro_torch.optim import adafactor

    step = torch.tensor(int(np.asarray(opt_state["step"])), dtype=torch.int32)
    params = transformer.Transformer(cfg, device="meta").state_dict()
    if "m" in opt_state:
        want = {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
                for k, p in params.items()}
        moments = {name: _to_torch(_lm_flat(opt_state[name], cfg), want,
                                   f"{cfg.name}: AdamW {name}") for name in ("m", "v")}
        return {**moments, "step": step}
    s = opt_state["s"]
    n_stacked = cfg.n_units * len(cfg.unit)
    flat = {k: _as_numpy(v) for k, v in _leaves(
        {"embed": s["embed"], "final_norm": s["final_norm"]})}
    for prefix, tree in [*((f"units.{pos}", u) for pos, u in enumerate(s["units"])),
                         *((f"layers.{n_stacked + j}", t) for j, t in enumerate(s["tail"]))]:
        flat.update({f"{prefix}.{k}": _as_numpy(v) for k, v in _leaves(tree)})
    opt = adafactor(stacks=transformer.unit_stacks(cfg))
    want = {f"{key}.{leaf}": t for key, state in opt.init(params)["s"].items()
            for leaf, t in state.items()}
    got = _to_torch(flat, want, f"{cfg.name}: Adafactor state")
    out: dict[str, dict] = {}
    for key, t in got.items():
        name, leaf = key.rsplit(".", 1)
        out.setdefault(name, {})[leaf] = t
    return {"s": out, "step": step}


def lm_caches(caches: dict, cfg, batch: int, seq_len: int, device=None) -> list[dict]:
    """The reference's serving caches (``repro.models.transformer.init_caches``
    layout, numpy leaves) as the port's per-layer list, in the port's cache
    dtypes on ``device`` (``None`` = the CUDA card; with no card it raises
    ``RuntimeError`` unless ``device="cpu"``) — to compare cache contents,
    or to decode from a cache the reference filled.  Raises ``ValueError``
    unless every entry's keys and shapes are those of
    ``init_caches(cfg, batch, seq_len)``."""
    from repro_torch.models import transformer

    device = resolve_device(device)
    want = transformer.init_caches(cfg, batch, seq_len, device="meta")
    out = []
    for i, (got, ref) in enumerate(zip(_per_layer(caches, cfg), want, strict=True)):
        out.append({k: v.to(device) for k, v in _to_torch(
            got, ref, f"{cfg.name}: cache of layer {i}").items()})
    return out
