"""The compiled step: the port's counterpart of the reference's ``jax.jit``.

A step is captured once as a CUDA graph (``torch.cuda.CUDAGraph``) on
static input buffers, then replayed: each call copies its inputs into the
buffers and launches the whole step at once, instead of enqueuing its
thousands of kernels one by one from Python.  A replay runs the kernels the
eager step launched at capture, on the tensors it launched them on; so

* a step may read nothing back to the host (an ``int()`` of a tensor would
  freeze its value into the graph, and a synchronising call breaks the
  capture);
* what a step updates (caches, parameters, optimizer moments, the step
  count) is written in place, into tensors that live as long as the graph;
* its outputs live in the graph's memory pool and are overwritten by the
  next replay: callers copy what they keep.

As ``jax.jit`` traces once for each input shape, the serving steps are
captured once for each shape: decode for each batch size, prefill for each
(batch size, prompt length).  On a ``DeviceMesh`` of the card the static
inputs are DTensors, placed once as ``parallel.sharding`` places the step's
inputs, and each call copies this rank's shard of its input into them; the
step gathers its outputs whole inside the graph.

Capture happens on the card only; a capture that fails raises, and nothing
falls back to the eager step.  On the CPU (and a gloo mesh) the steps run
eagerly (see ``launch/serve.py`` and ``launch/train.py``).
"""

from __future__ import annotations

import time

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.models import transformer as tfm
from repro_torch.parallel import sharding


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for _, v in sorted(tree.items()) for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@torch.no_grad()
def _storage(t: torch.Tensor) -> int:
    """Where ``t``'s values live: a DTensor's local shard's address."""
    return (t.to_local() if isinstance(t, DTensor) else t).data_ptr()


def _warm(step):
    """``step()`` once on a side stream, so that lazy initialisation
    (cuBLAS's workspaces among it) happens outside the capture; returns
    its result."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = step()
    cur.wait_stream(side)
    return out


def _capture(step, pool=None):
    """``step()`` captured → (the graph, the step's output in the graph's
    memory).  Unsafe calls are refused on this thread only: another thread,
    such as a process group's watchdog querying its events, may go on."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        out = step()
    return graph, out


def _static(t: torch.Tensor, mesh) -> torch.Tensor:
    """A buffer holding a copy of ``t``, placed by ``batch_specs`` on a
    mesh."""
    t = t.clone()
    if mesh is None:
        return t
    return sharding.place(t, mesh, sharding.batch_specs(t, mesh=mesh))


@torch.no_grad()
def _copy_in(static: torch.Tensor, value: torch.Tensor) -> None:
    """``value`` (an input whole, as every rank holds it) into ``static``:
    for a DTensor, this rank's shard of it as ``static`` is placed, copied
    into the local shard without communication."""
    if isinstance(static, DTensor) and not isinstance(value, DTensor):
        shape, offset = compute_local_shape_and_global_offset(
            value.shape, static.device_mesh, static.placements)
        value = value[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        static = static.to_local()
    static.copy_(value)


class GraphedDecode:
    """``decode(tokens, position, caches, cross)`` → logits [B, V] (the
    engine's decode step: on a mesh it runs under ``on_mesh`` and gathers
    the logits whole) captured for one batch: static tokens [B, 1]
    (int64), a 0-d int32 position and ``caches`` of ``max_seq`` positions,
    all on the card and owned here, and, for a model that attends to image
    patches, static ``cross`` embeddings of ``cross_shape``.  On a ``mesh``
    the tokens, caches and embeddings are DTensors placed by
    ``batch_specs`` and ``cache_specs``.  The caller fills the caches
    (reset, then prefill: :class:`GraphedPrefill` writes into these), then
    calls it once a token."""

    def __init__(self, decode, cfg, batch: int, max_seq: int, device, cross_shape=None,
                 cross_dtype=None, *, mesh=None, pool=None):
        self.mesh = mesh
        self.tokens = _static(torch.zeros((batch, 1), dtype=torch.int64, device=device), mesh)
        self.position = torch.zeros((), dtype=torch.int32, device=device)
        self.caches = tfm.init_caches(cfg, batch, max_seq, device)
        if mesh is not None:
            self.caches = sharding.place_tree(
                self.caches, sharding.cache_specs(self.caches, cfg, mesh=mesh), mesh)
        self.cross = None if cross_shape is None else _static(
            torch.zeros(cross_shape, dtype=cross_dtype, device=device), mesh)
        step = lambda: decode(self.tokens, self.position, self.caches, self.cross)  # noqa: E731
        t0 = time.perf_counter()
        _warm(step)
        self.graph, self.logits = _capture(step, pool)
        self.capture_s = time.perf_counter() - t0  # the warm-up step and the capture
        tfm.reset_caches(self.caches)

    def set_cross(self, cross: torch.Tensor) -> None:
        _copy_in(self.cross, cross)

    def __call__(self, tokens: torch.Tensor, position: int) -> torch.Tensor:
        """One decode step of ``tokens`` [B, 1] at ``position`` → logits
        [B, V], a static buffer the next replay overwrites."""
        _copy_in(self.tokens, tokens)
        self.position.fill_(position)
        self.graph.replay()
        return self.logits


class GraphedPrefill:
    """``prefill(tokens, caches, cross)`` → last-position logits [B, V]
    (the engine's prefill step) captured for one prompt shape [B, P] on
    static tokens (int64; on a mesh placed by ``batch_specs``), writing
    into the caches of ``decode``, the :class:`GraphedDecode` of batch B,
    and reading its ``cross`` buffer: decode then goes on from what the
    replayed prefill wrote.  The caller resets those caches first."""

    def __init__(self, prefill, decode: GraphedDecode, prompt_len: int, *, pool=None):
        batch = decode.tokens.shape[0]
        self.tokens = _static(torch.zeros((batch, prompt_len), dtype=torch.int64,
                                          device=decode.position.device), decode.mesh)
        step = lambda: prefill(self.tokens, decode.caches, decode.cross)  # noqa: E731
        t0 = time.perf_counter()
        _warm(step)
        self.graph, self.logits = _capture(step, pool)
        self.capture_s = time.perf_counter() - t0  # the warm-up prefill and the capture

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        """Prefill of ``tokens`` [B, P] into the decode graph's caches →
        last-position logits [B, V], a static buffer the next replay
        overwrites."""
        _copy_in(self.tokens, tokens)
        self.graph.replay()
        return self.logits


class GraphedTrainStep:
    """``step_fn(params, opt_state, batch)`` compiled: its first call runs
    eagerly on a side stream (a real step, counted as one), frees the
    cached blocks it left, and captures the whole step (forward, backward,
    clipping, the update) on that call's ``params`` and ``opt_state`` and on
    static copies of its batch (on a ``mesh``, placed by ``batch_specs``,
    and ``step_fn`` the sharded step, which takes them as placed and
    gathers its metrics whole in the graph); every later call copies its
    batch into them and replays.  The captured step updates those very
    tensors, so a call must pass them (a restore copies into them); the
    returned metrics are copies."""

    def __init__(self, step_fn, mesh=None):
        self.step_fn = step_fn
        self.mesh = mesh
        self.graph = None

    def __call__(self, params, opt_state, batch: dict):
        if self.graph is None:
            return self._first(params, opt_state, batch)
        tensors = [*params.parameters(), *_leaves(opt_state)]
        if params is not self.params or len(tensors) != len(self.tensors) or any(
                a is not b or _storage(a) != ptr
                for a, (b, ptr) in zip(tensors, self.tensors)):
            raise ValueError("the captured train step updates the parameters and optimizer "
                             "state it was captured on: pass those (restore by copying into "
                             "them; another mesh needs a new run)")
        if set(batch) != set(self.batch) or any(
                v.shape != self.batch[k].shape or v.dtype != self.batch[k].dtype
                for k, v in batch.items()):
            raise ValueError(f"the train step was captured for batches "
                             f"{ {k: (tuple(v.shape), v.dtype) for k, v in self.batch.items()} }")
        for k, v in batch.items():
            _copy_in(self.batch[k], v)
        self.graph.replay()
        return params, self.opt_state, {k: v.clone() for k, v in self.metrics.items()}

    def _first(self, params, opt_state, batch):
        self.batch = {k: _static(v, self.mesh) for k, v in batch.items()}
        params, opt_state, metrics = _warm(lambda: self.step_fn(params, opt_state, self.batch))
        # The eager step's transient blocks go back to the driver before the
        # graph's private pool takes its own: both at once could pass the
        # card's memory.
        torch.cuda.current_stream().synchronize()
        torch.cuda.empty_cache()
        self.params, self.opt_state = params, opt_state
        self.tensors = [(t, _storage(t)) for t in (*params.parameters(), *_leaves(opt_state))]
        t0 = time.perf_counter()
        graph, (_, _, self.metrics) = _capture(
            lambda: self.step_fn(params, opt_state, self.batch))
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
        return params, opt_state, metrics
