"""Shared helpers for the LM tests of the port: the reference's parameters
(every zero- or one-initialised leaf drawn at random, so a swapped or
dropped mapping cannot pass) carried to the port with
``convert.lm_params``, and inputs made with numpy from a seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as ref_T
from repro_torch import convert
from repro_torch.models import transformer as T

# Leaves the reference initialises to zeros or ones (norm deltas, biases).
PERTURB = {"attn_norm", "mlp_norm", "norm", "final_norm", "norm_w", "bq", "bk", "bv",
           "conv_b", "D"}


def f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def to_numpy(tree):
    """A reference tree with numpy leaves; bf16 leaves as float32 (exact)."""
    return jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x), tree)


def _perturbed(tree, rng, key=None):
    if isinstance(tree, dict):
        return {k: _perturbed(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturbed(v, rng, key) for v in tree]
    x = np.asarray(tree)
    if key in PERTURB:
        return (x + rng.normal(0, 0.3, x.shape)).astype(x.dtype)
    if key == "dt_bias":  # dt up to ~24: softplus' linear branch above 20
        return rng.uniform(-4, 24, x.shape).astype(x.dtype)
    if key == "lam":  # softplus(Λ) past 20 on some channels
        return rng.uniform(-8, 24, x.shape).astype(x.dtype)
    return x


def ref_params(cfg, seed: int = 0):
    """The reference's ``init_params`` for ``cfg`` as numpy, perturbed."""
    tree = to_numpy(ref_T.init_params(jax.random.PRNGKey(seed), cfg))
    return _perturbed(tree, np.random.default_rng(seed + 100))


def port_model(cfg, tree) -> T.Transformer:
    model = T.init_params(cfg, 0, "cpu")
    model.load_state_dict(convert.lm_params(tree, cfg))
    return model


def inputs(cfg, batch: int, seq: int, seed: int = 0):
    """(tokens [B,S] int32, cross_embeds [B,L,d] float32 or None)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    cross = None
    if cfg.family == "vlm":
        cross = rng.standard_normal((batch, cfg.cross_kv_len, cfg.d_model)).astype(np.float32)
    return tokens, cross


def t(x):
    """numpy → torch on the CPU (None stays None)."""
    return None if x is None else torch.from_numpy(np.array(x))


def n(x) -> np.ndarray:
    """A JAX or torch array as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), dtype=np.float64)


def rel_err(got, want) -> float:
    """max|got − want| over max|want|."""
    got, want = n(got), n(want)
    return float(np.abs(got - want).max() / np.abs(want).max())
