"""Deterministic, resumable token pipeline.

Batches are synthesized statelessly from (seed, step) — a counter-based
threefry draw — so a restarted job reproduces the exact token stream from
its checkpointed step with no data state to persist.  The draw is JAX's,
bit for bit: ``PRNGKey``, ``fold_in``, ``split``, ``randint`` and
``bernoulli`` with the partitionable threefry counter layout
(``jax_threefry_partitionable``, JAX's default), written out below in numpy
``uint32`` arithmetic on the host, so the port's stream equals the
reference's token for token.  A memmap-backed corpus reader with the same
interface is provided for real tokens.  Batches are int64 CPU tensors; the
train loop moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-ish structure so loss can actually decrease on the synthetic set
    structure: float = 0.7


# ------------------------------------------------------- threefry (JAX's)

def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key`` (2 uint32): two uint32 arrays."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed's bits)."""
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return np.array([0, seed & 0xFFFFFFFF], _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter (0, data)."""
    b0, b1 = threefry2x32(key, np.zeros(1, _U32), np.array([data & 0xFFFFFFFF], _U32))
    return np.concatenate([b0, b1])


def _counters(n: int):
    """A 64-bit iota over ``n`` elements as (high, low) uint32 words."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(_U32), (i & np.uint64(0xFFFFFFFF)).astype(_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (partitionable layout): key i hashes counter i."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element (partitionable layout): the two hash words
    of the element's counter, xor'ed."""
    b0, b1 = threefry2x32(key, *_counters(int(np.prod(shape))))
    return (b0 ^ b1).reshape(shape)


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` into int32: two bit draws (high and low words)
    folded into [minval, maxval) by the span multiplier 2^32 mod span."""
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = maxval - minval if maxval > minval else 1
    multiplier = _U32((2**16 % span) ** 2 % 2**32 % span)  # the square wraps in uint32
    span = _U32(span)
    offset = ((higher % span) * multiplier + lower % span) % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


def uniform(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.uniform`` in float32 on [0, 1): 23 random mantissa bits
    under the exponent of 1.0, minus 1."""
    bits = (random_bits(key, shape) >> _U32(32 - 23)) | np.float32(1.0).view(_U32)
    return np.maximum(np.float32(0.0), bits.view(np.float32) - np.float32(1.0))


def bernoulli(key: np.ndarray, p: float, shape) -> np.ndarray:
    return uniform(key, shape) < np.float32(p)


# ----------------------------------------------------------------- streams

class SyntheticStream:
    """Stateless synthetic LM stream: next_batch(step) is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def next_batch(self, step: int) -> dict:
        c = self.cfg
        k1, k2, _ = split(fold_in(prng_key(c.seed), step), 3)
        base = randint(k1, (c.global_batch, c.seq_len + 1), 0, c.vocab)
        # inject learnable structure: with prob `structure`, token t+1 = f(token t)
        nxt = (base[:, :-1] * 31 + 7) % c.vocab
        use = bernoulli(k2, c.structure, nxt.shape)
        seq = base.copy()
        seq[:, 1:] = np.where(use, nxt, base[:, 1:])
        seq = torch.from_numpy(seq.astype(np.int64))
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def host_batch(self, step: int, host_id: int = 0, num_hosts: int = 1) -> dict:
        """Per-host slice (process-sharded input loading)."""
        full = self.next_batch(step)
        per = self.cfg.global_batch // num_hosts
        return {k: v[host_id * per:(host_id + 1) * per] for k, v in full.items()}


class MemmapCorpus:
    """Token-file-backed stream with the same stateless interface.

    File: raw int32 tokens.  Batch (step) deterministically indexes
    non-overlapping windows modulo corpus length."""

    def __init__(self, path: str, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")

    def next_batch(self, step: int) -> dict:
        c = self.cfg
        n = len(self.tokens)
        span = c.seq_len + 1
        out = np.empty((c.global_batch, span), np.int32)
        for b in range(c.global_batch):
            start = ((step * c.global_batch + b) * span) % max(n - span, 1)
            out[b] = self.tokens[start:start + span]
        out = torch.from_numpy(out.astype(np.int64) % c.vocab)
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}


def make_stream(cfg: DataConfig, path: str | None = None):
    return MemmapCorpus(path, cfg) if path else SyntheticStream(cfg)
