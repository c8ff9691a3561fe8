"""Carry reference artifacts across to the port as plain numpy/Python data.

``compiled_from_numpy`` rebuilds a :class:`~repro_torch.core.ir.CompiledSchedule`
from the fields of a reference schedule, so a schedule compiled elsewhere
runs through the port's executors unchanged (separating compiler faults
from executor faults).  ``planes_from_numpy``/``planes_to_numpy`` convert
uint32 bit-planes to and from the port's int32 carrier, bit for bit.
``cnn_state_dict`` turns a reference CNN's parameter tree into the port
model's ``state_dict``.
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
