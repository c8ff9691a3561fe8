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

Capture happens on the card only, with no mesh; a capture that fails
raises, and nothing falls back to the eager step.  On the CPU and on a mesh
the steps run eagerly (see ``launch/serve.py`` and ``launch/train.py``).
"""

from __future__ import annotations

import time

import torch

from repro_torch.models import transformer as tfm


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for _, v in sorted(tree.items()) for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class GraphedDecode:
    """``decode_fn(params, tokens, position, caches, cross_embeds)``
    captured for one batch: static tokens [B, 1] (int64), a 0-d int32
    position and ``caches`` of ``max_seq`` positions, all on the card and
    owned here, and, for a model that attends to image patches, static
    ``cross_embeds`` of ``cross_shape``.  The caller fills the caches (reset
    and prefill, eagerly), then calls it once a token."""

    def __init__(self, decode_fn, params, cfg, batch: int, max_seq: int, device,
                 cross_shape=None, cross_dtype=None):
        self.tokens = torch.zeros((batch, 1), dtype=torch.int64, device=device)
        self.position = torch.zeros((), dtype=torch.int32, device=device)
        self.caches = tfm.init_caches(cfg, batch, max_seq, device)
        self.cross = None if cross_shape is None else torch.zeros(
            cross_shape, dtype=cross_dtype, device=device)
        step = lambda: decode_fn(  # noqa: E731
            params, self.tokens, self.position, self.caches, self.cross)[0]
        t0 = time.perf_counter()
        # One step on a side stream first: lazy initialisation (cuBLAS's
        # workspaces among it) happens outside the capture.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = step()
        self.capture_s = time.perf_counter() - t0  # the warm-up step and the capture
        tfm.reset_caches(self.caches)

    def __call__(self, tokens: torch.Tensor, position: int) -> torch.Tensor:
        """One decode step of ``tokens`` [B, 1] at ``position`` → logits
        [B, V], a static buffer the next call overwrites."""
        self.tokens.copy_(tokens)
        self.position.fill_(position)
        self.graph.replay()
        return self.logits


class GraphedTrainStep:
    """``step_fn(params, opt_state, batch)`` compiled: its first call runs
    eagerly on a side stream (a real step, counted as one), frees the
    cached blocks it left, and captures the whole step (forward, backward,
    clipping, the update) on that call's ``params`` and ``opt_state`` and on
    static copies of its batch; every later call copies its batch into them
    and replays.  The captured step updates those very tensors, so a call
    must pass them (a restore copies into them); the returned metrics are
    copies."""

    def __init__(self, step_fn):
        self.step_fn = step_fn
        self.graph = None

    def __call__(self, params, opt_state, batch: dict):
        if self.graph is None:
            return self._first(params, opt_state, batch)
        if params is not self.params or any(
                a is not b for a, b in zip(_leaves(opt_state), self.state, strict=True)) or any(
                a is not b for a, b in zip(params.parameters(), self.weights, strict=True)):
            raise ValueError("the captured train step updates the parameters and optimizer "
                             "state it was captured on: pass those (restore by copying into "
                             "them)")
        if set(batch) != set(self.batch) or any(
                v.shape != self.batch[k].shape or v.dtype != self.batch[k].dtype
                for k, v in batch.items()):
            raise ValueError(f"the train step was captured for batches "
                             f"{ {k: (tuple(v.shape), v.dtype) for k, v in self.batch.items()} }")
        for k, v in batch.items():
            self.batch[k].copy_(v)
        self.graph.replay()
        return params, self.opt_state, {k: v.clone() for k, v in self.metrics.items()}

    def _first(self, params, opt_state, batch):
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
        cur.wait_stream(side)
        # The eager step's transient blocks go back to the driver before the
        # graph's private pool takes its own: both at once could pass the
        # card's memory.
        cur.synchronize()
        torch.cuda.empty_cache()
        self.params, self.opt_state = params, opt_state
        self.state, self.weights = _leaves(opt_state), list(params.parameters())
        self.batch = {k: v.clone() for k, v in batch.items()}
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _, _, self.metrics = self.step_fn(params, opt_state, self.batch)
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
        return params, opt_state, metrics
