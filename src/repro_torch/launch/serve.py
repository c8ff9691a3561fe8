"""Serving engine: batched prefill + decode with temperature sampling.

The same two steps the reference's serving engine jits, on one CUDA card
(``device=None``) or, when asked, on the CPU.  On the card both steps are
compiled as the reference's are: decode is captured as a CUDA graph once
per batch size (``launch.graphs.GraphedDecode``) on caches the engine owns
and replayed once a token, and prefill once per prompt shape
(``GraphedPrefill``), writing into those caches; sampling runs eagerly.
Given a ``DeviceMesh`` (``launch.mesh.make_host_mesh``), the parameters,
caches and prompts are DTensors placed by ``parallel.sharding``'s
``param_specs``, ``cache_specs`` and ``batch_specs``, and every rank of the
mesh runs the same steps on its shards: captured on the card, eagerly on
the CPU (a gloo mesh), as everything is there.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b --smoke \
      --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.graphs import GraphedDecode, GraphedPrefill
from repro_torch.launch.mesh import check_device
from repro_torch.models import transformer as tfm
from repro_torch.models.spmd import full, on_mesh
from repro_torch.parallel import sharding
from repro_torch.pim.frontend import resolve_device


@dataclasses.dataclass
class ServeEngine:
    """``params`` served with caches of ``max_seq`` positions on ``device``
    (and, with a ``mesh``, sharded over it); ``build`` draws a fresh serving
    model, and the constructor serves a model the caller already holds (any
    dtypes).  ``compile=False`` runs the steps op by op on the card too, as
    ``jax.disable_jit`` does the reference's."""
    cfg: ModelConfig
    params: tfm.Transformer
    max_seq: int
    device: torch.device
    mesh: object = None
    compile: bool = True
    prefill_fn: object = dataclasses.field(init=False, repr=False)
    decode_fn: object = dataclasses.field(init=False, repr=False)
    graphs: dict = dataclasses.field(init=False, repr=False)
    pool: object = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.prefill_fn = steps_mod.make_prefill_step(self.cfg)
        self.decode_fn = steps_mod.make_decode_step(self.cfg)
        # ("decode", batch, cross) → GraphedDecode; ("prefill", batch, prompt
        # length, cross) → GraphedPrefill; cross: the cross_embeds' shape and
        # dtype, or None
        self.graphs = {}
        self.pool = None  # the memory pool the engine's graphs share

    @property
    def compiled(self) -> bool:
        """Whether prefill and decode replay captured steps: on the card,
        with or without a mesh."""
        return self.device.type == "cuda" and self.compile

    @classmethod
    def build(cls, cfg: ModelConfig, max_seq: int, seed: int = 0, device=None, mesh=None,
              compile: bool = True):
        """The serving model (``serve_config(cfg)``: bf16 weights) with
        parameters drawn from a ``torch.Generator`` seeded with ``seed`` on
        ``device`` (``None`` = the CUDA card; ``RuntimeError`` without one
        unless ``device="cpu"``).  Caches hold ``max_seq`` positions.  With
        a ``mesh`` (on ``device``'s type) every rank draws the same model and
        keeps its shards by ``param_specs``."""
        device = resolve_device(device)
        scfg = steps_mod.serve_config(cfg)
        params = tfm.init_params(scfg, seed, device)
        if mesh is not None:
            check_device(mesh, device)
            sharding.distribute_params(
                params, sharding.param_specs(params.state_dict(), scfg, mesh=mesh), mesh)
        return cls(cfg=scfg, params=params, max_seq=max_seq, device=device, mesh=mesh,
                   compile=compile)

    def generate(self, prompts: np.ndarray, gen_len: int, *, temperature: float = 1.0,
                 seed: int = 0, cross_embeds=None, return_logits: bool = False):
        """prompts: [B, P] int.  Returns [B, P+gen_len] int32: the prompts,
        then the sampled tokens.  ``temperature=0`` is greedy; otherwise a
        ``torch.Generator`` seeded with ``seed`` on the device samples (its
        stream is not ``jax.random``'s).  With ``return_logits`` it returns
        the tokens and the ``gen_len`` [B, V] logits each token was drawn
        from (prefill's, then each decode step's), on the device, each its
        own copy.  On the card the steps are replayed: decode captured for
        this batch size on caches it owns, prefill for this prompt shape
        into those caches, which are reset here; the first request of a
        shape pays for its capture."""
        B, P = prompts.shape
        dev = self.device
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64).to(dev)
        cross = None if cross_embeds is None else torch.as_tensor(cross_embeds).to(dev)
        prefill, decode = self._graphed(B, P, cross) if self.compiled else self._eager(B, cross)
        generator = torch.Generator(device=dev).manual_seed(seed)
        out, seen = [tokens], []
        logits = prefill(tokens)
        for i in range(gen_len):
            if i:
                logits = decode(out[-1], P + i - 1)
            if return_logits:  # a replay overwrites its logits
                seen.append(logits.clone())
            out.append(_sample(logits, generator, temperature))
        out = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        return (out, seen) if return_logits else out

    def _graphed(self, batch: int, prompt_len: int, cross):
        """The captured prefill for [batch, prompt_len] and decode for
        ``batch`` (and the VLM's ``cross_embeds`` shape), each captured on
        first use, with the decode caches reset and ``cross`` copied in.

        The engine's graphs share one memory pool: a replay may overwrite
        what another graph of the engine left in it.  That is safe here,
        since the steps never run at once, their caches and inputs live
        outside the pool, and each replay's logits are sampled (or copied)
        before the next replay."""
        key = None if cross is None else (tuple(cross.shape), cross.dtype)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        if ("decode", batch, key) not in self.graphs:
            self.graphs[("decode", batch, key)] = GraphedDecode(
                self._decode, self.cfg, batch, self.max_seq, self.device,
                *(() if cross is None else (cross.shape, cross.dtype)), mesh=self.mesh,
                pool=self.pool)
        decode = self.graphs[("decode", batch, key)]
        if ("prefill", batch, prompt_len, key) not in self.graphs:
            self.graphs[("prefill", batch, prompt_len, key)] = GraphedPrefill(
                self._prefill, decode, prompt_len, pool=self.pool)
        prefill = self.graphs[("prefill", batch, prompt_len, key)]
        tfm.reset_caches(decode.caches)
        if cross is not None:
            decode.set_cross(cross)
        return prefill, decode

    def _eager(self, batch: int, cross):
        """Prefill and decode run op by op on fresh caches (on a mesh placed
        by ``cache_specs``, with each input placed by ``batch_specs``)."""
        caches = tfm.init_caches(self.cfg, batch, self.max_seq, self.device)
        if self.mesh is not None:
            caches = sharding.place_tree(
                caches, sharding.cache_specs(caches, self.cfg, mesh=self.mesh), self.mesh)
            if cross is not None:
                cross = self._batch(cross)
        return (lambda tokens: self._prefill(self._batch(tokens), caches, cross),
                lambda tokens, position: self._decode(self._batch(tokens), position, caches,
                                                      cross))

    def _prefill(self, tokens, caches, cross):
        """The prefill step on placed inputs → last-position logits, whole."""
        with on_mesh(self.mesh):
            return full(self.prefill_fn(self.params, tokens, caches, cross)[0])

    def _decode(self, tokens, position, caches, cross):
        """The decode step on placed inputs → logits, whole."""
        with on_mesh(self.mesh):
            return full(self.decode_fn(self.params, tokens, position, caches, cross)[0])

    def _batch(self, t: torch.Tensor) -> torch.Tensor:
        """An input as the steps take it: placed by ``batch_specs`` on a
        mesh."""
        if self.mesh is None:
            return t
        return sharding.place(t, self.mesh, sharding.batch_specs(t, mesh=self.mesh))


def _sample(logits: torch.Tensor, generator: torch.Generator, temperature: float):
    """[B, V] logits → [B, 1] int64 tokens: argmax (first of equal maxima,
    as ``jnp.argmax``) at temperature 0, else a draw from
    softmax(logits / temperature) in float32."""
    if temperature == 0.0:
        return logits.argmax(dim=-1, keepdim=True)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "vlm":
        raise ValueError(f"{cfg.name} attends to image patch embeddings, which this entry "
                         "point has no frontend for: serve it through "
                         "ServeEngine.generate(prompts, gen_len, cross_embeds=...)")
    engine = ServeEngine.build(cfg, max_seq=args.prompt_len + args.gen, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.gen, temperature=args.temperature)
    dt = time.perf_counter() - t0  # generate returns host numpy: the device is done
    tput = args.batch * args.gen / dt
    print(f"[serve] {cfg.name} on {engine.device}: generated {out.shape} in {dt:.2f}s "
          f"({tput:.1f} tok/s decode throughput)")
    print("[serve] sample:", out[0, -args.gen:].tolist())
    return out


if __name__ == "__main__":
    main()
