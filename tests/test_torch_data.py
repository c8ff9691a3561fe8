"""The port's token pipeline against the JAX reference, on the CPU: the
threefry draws (``PRNGKey``, ``fold_in``, ``split``, ``randint``,
``uniform``, ``bernoulli``) bit for bit, ``SyntheticStream.next_batch``
token for token over seeds, steps, odd vocab sizes (above 2^16 too, where
``randint``'s multiplier wraps) and lengths, ``host_batch``, and
``MemmapCorpus`` on a temp file."""

import os

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import MemmapCorpus as RefMemmapCorpus
from repro.data.pipeline import SyntheticStream as RefSyntheticStream
from repro_torch.data import pipeline
from repro_torch.data.pipeline import DataConfig, MemmapCorpus, SyntheticStream, make_stream


@pytest.mark.parametrize("seed", [0, 1, 7, -3, 2**31 - 1])
def test_threefry_draws_equal_jax(seed):
    key, ref = pipeline.prng_key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(ref))
    for data in (0, 5, 1000, 2**32 - 1):
        np.testing.assert_array_equal(pipeline.fold_in(key, data),
                                      np.asarray(jax.random.fold_in(ref, data)))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(pipeline.split(key, num),
                                      np.asarray(jax.random.split(ref, num)))
    for lo, hi in ((0, 50304), (0, 100003), (3, 17), (5, 5), (-100, 65537), (0, 2**31 - 1)):
        np.testing.assert_array_equal(pipeline.randint(key, (3, 33), lo, hi),
                                      np.asarray(jax.random.randint(ref, (3, 33), lo, hi)))
    np.testing.assert_array_equal(pipeline.uniform(key, (5, 7)),
                                  np.asarray(jax.random.uniform(ref, (5, 7))))
    np.testing.assert_array_equal(pipeline.bernoulli(key, 0.7, (5, 7)),
                                  np.asarray(jax.random.bernoulli(ref, 0.7, (5, 7))))


def test_prng_key_refuses_a_seed_past_32_bits():
    with pytest.raises(ValueError, match="32 bits"):
        pipeline.prng_key(2**31)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("vocab,seq_len,batch", [(257, 33, 3), (50304, 128, 2), (100003, 17, 5)])
def test_next_batch_equals_reference_token_for_token(seed, vocab, seq_len, batch):
    ref = RefSyntheticStream(RefDataConfig(vocab=vocab, seq_len=seq_len, global_batch=batch,
                                           seed=seed))
    port = SyntheticStream(DataConfig(vocab=vocab, seq_len=seq_len, global_batch=batch,
                                      seed=seed))
    for step in (0, 1, 5, 1000):
        want, got = ref.next_batch(step), port.next_batch(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int64 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), (step, k))


def test_structure_and_host_batch():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=4, seed=1, structure=0.9)
    s = SyntheticStream(cfg)
    a = s.next_batch(5)
    assert torch.equal(a["tokens"], s.next_batch(5)["tokens"])
    assert not torch.equal(a["tokens"], s.next_batch(6)["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])  # next-token shifted
    assert 0 <= int(a["tokens"].min()) and int(a["labels"].max()) < 100
    h0, h1 = s.host_batch(5, 0, 2)["tokens"], s.host_batch(5, 1, 2)["tokens"]
    assert torch.equal(torch.cat([h0, h1]), a["tokens"])
    want = RefSyntheticStream(RefDataConfig(vocab=100, seq_len=16, global_batch=4, seed=1,
                                            structure=0.9)).host_batch(5, 1, 2)
    np.testing.assert_array_equal(h1.numpy(), np.asarray(want["tokens"]))


def test_memmap_corpus_equals_reference(tmp_path):
    path = os.path.join(tmp_path, "tokens.bin")
    np.random.default_rng(0).integers(-5, 70000, 10000, dtype=np.int32).tofile(path)
    for vocab, seq_len, batch in ((50000, 8, 2), (257, 33, 3)):
        ref = RefMemmapCorpus(path, RefDataConfig(vocab=vocab, seq_len=seq_len,
                                                  global_batch=batch))
        port = make_stream(DataConfig(vocab=vocab, seq_len=seq_len, global_batch=batch), path)
        assert isinstance(port, MemmapCorpus)
        for step in (0, 3, 500):
            want, got = ref.next_batch(step), port.next_batch(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), (step, k))
    assert isinstance(make_stream(DataConfig(vocab=8, seq_len=4, global_batch=1)),
                      SyntheticStream)
