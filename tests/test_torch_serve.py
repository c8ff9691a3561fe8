"""The port's serving path against the JAX reference, on the CPU: prefill
caches entry by entry (k/v/pos, ssm conv/h, rglru conv/h), four decode
steps, greedy ``generate`` token for token, a prompt longer than the local
window (the ring wraps), the int8 KV cache, the engine's device rule, the
``python -m repro_torch.launch.serve`` entry point and the serving example.

Bounds (float32 compute): logits within ``TOL`` × max|logit|, cache
contents within ``TOL`` × max|entry|, positions and greedy tokens equal.
The int8 KV codes may differ by one step where the two sides' float32 k/v
straddle a rounding boundary (``KV_CODE_SHARE`` of the codes must be
equal).  The port's own decode parity at the default dtypes keeps the
reference's bound (``tests/test_models.py``: 0.35).
"""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import f32, inputs, port_model, ref_params, rel_err, t, to_numpy
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import serve as ref_serve
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as ref_T
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.analyzer import Workload, analyze
from repro_torch.launch import serve, steps
from repro_torch.models import transformer as T

TOL = 1e-4
KV_CODE_SHARE = 0.999
PARITY_BOUND = 0.35  # the reference's bf16 flash-vs-decode bound
DECODE_ARCHS = ["stablelm_3b", "gemma2_27b", "mamba2_780m", "recurrentgemma_9b",
                "deepseek_moe_16b", "llama_3_2_vision_11b"]
B, P, STEPS = 2, 12, 4
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _assert_caches_close(got: list, want: list, cfg, what: str):
    assert len(got) == len(want) == cfg.n_layers
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (what, i)
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (what, i, k)
            if g[k].is_floating_point():
                scale = max(float(w[k].abs().max()), 1e-30)
                err = float((g[k].double() - w[k].double()).abs().max())
                assert err <= TOL * scale, (what, i, k, err, scale)
            else:
                assert torch.equal(g[k], w[k]), (what, i, k)


def _prefill_and_decode(cfg, prompt_len: int, max_seq: int):
    """Prefill ``prompt_len`` tokens then ``STEPS`` greedy decode steps on
    both sides, the position passed as the reference passes it (a 0-d int32
    array; on the port's side a tensor); caches compared after prefill and
    after the last step."""
    tree = ref_params(cfg)
    model = port_model(cfg, tree)
    tokens, cross = inputs(cfg, B, prompt_len)
    ref_cross = None if cross is None else jnp.asarray(cross)
    ref_caches = ref_T.init_caches(cfg, B, max_seq)
    want, ref_caches = ref_T.prefill(tree, jnp.asarray(tokens), cfg, ref_caches,
                                     cross_embeds=ref_cross)
    caches = T.init_caches(cfg, B, max_seq, "cpu")
    got, caches = T.prefill(model, t(tokens), cfg, caches, cross_embeds=t(cross))
    assert got.shape == (B, cfg.vocab) and rel_err(got, want) <= TOL
    _assert_caches_close(
        caches, convert.lm_caches(to_numpy(ref_caches), cfg, B, max_seq, "cpu"), cfg, "prefill")
    for i in range(STEPS):
        ref_tok = jnp.argmax(want, axis=-1)[:, None].astype(jnp.int32)
        tok = got.argmax(dim=-1, keepdim=True)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
        want, ref_caches = ref_T.decode_step(tree, ref_tok, jnp.asarray(prompt_len + i), cfg,
                                             ref_caches, cross_embeds=ref_cross)
        got, caches = T.decode_step(model, tok, torch.tensor(prompt_len + i, dtype=torch.int32),
                                    cfg, caches, cross_embeds=t(cross))
        assert rel_err(got, want) <= TOL, (i, rel_err(got, want))
    _assert_caches_close(
        caches, convert.lm_caches(to_numpy(ref_caches), cfg, B, max_seq, "cpu"), cfg, "decode")
    return caches, ref_caches


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_caches_and_decode_match_reference(arch):
    _prefill_and_decode(f32(get_smoke_config(arch)), P, P + STEPS)


def test_prefill_longer_than_the_window_wraps_the_ring():
    """gemma2's local layers hold ``min(max_seq, window)`` = 8 slots; a
    13-token prompt takes the ``T >= S_c`` branch and decode wraps on."""
    cfg = f32(get_smoke_config("gemma2_27b"))
    caches, _ = _prefill_and_decode(cfg, 13, 13 + STEPS)
    local = caches[cfg.layer_kinds().index("local")]
    assert local["k"].shape[1] == cfg.window == 8
    assert sorted(local["pos"].tolist()) == list(range(13 + STEPS - 8, 13 + STEPS))


def test_kv_quant_decode_matches_reference():
    """``opt_kv_quant``: int8 codes and float32 scales in the cache, the
    dequantised k/v in the compute dtype."""
    cfg = dataclasses.replace(f32(get_smoke_config("musicgen_large")), opt_kv_quant=True)
    tree = ref_params(cfg)
    model = port_model(cfg, tree)
    tokens, _ = inputs(cfg, B, P + 1)
    ref_caches = ref_T.init_caches(cfg, B, P + 1)
    _, ref_caches = ref_T.prefill(tree, jnp.asarray(tokens[:, :P]), cfg, ref_caches)
    want, ref_caches = ref_T.decode_step(tree, jnp.asarray(tokens[:, P:]), jnp.asarray(P), cfg,
                                         ref_caches)
    caches = T.init_caches(cfg, B, P + 1, "cpu")
    assert caches[0]["k"].dtype == torch.int8
    _, caches = T.prefill(model, t(tokens[:, :P]), cfg, caches)
    got, caches = T.decode_step(model, t(tokens[:, P:]), P, cfg, caches)
    assert rel_err(got, want) <= TOL
    ref = convert.lm_caches(to_numpy(ref_caches), cfg, B, P + 1, "cpu")
    for g, w in zip(caches, ref):
        for k in ("k", "v"):
            diff = (g[k].int() - w[k].int()).abs()
            assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= KV_CODE_SHARE
        for k in ("k_scale", "v_scale"):
            assert rel_err(g[k], w[k]) <= TOL
        assert torch.equal(g["pos"], w["pos"])


@pytest.mark.parametrize("arch", ["stablelm_3b", "gemma2_27b", "mamba2_780m",
                                  "recurrentgemma_9b", "deepseek_moe_16b"])
def test_decode_parity_at_default_dtypes(arch):
    """The reference's own check on the port: prefill S−1 plus one decode
    step equals the full forward at the last position (bf16 compute)."""
    cfg = get_smoke_config(arch)
    if cfg.n_experts:  # drop-free routing: T−1 and T tokens drop differently
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    model = T.init_params(cfg, 0, "cpu")
    tokens, _ = inputs(cfg, 2, 12)
    caches = T.init_caches(cfg, 2, 12, "cpu")
    _, caches = T.prefill(model, t(tokens[:, :11]), cfg, caches)
    got, _ = T.decode_step(model, t(tokens[:, 11:]), 11, cfg, caches)
    with torch.no_grad():
        full, _, _ = T.forward(model, t(tokens), cfg)
    assert float((got.float() - full[:, -1].float()).abs().max()) < PARITY_BOUND


# ------------------------------------------------------------- the engine

@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_greedy_generate_matches_reference(arch):
    """Both engines serve bf16 weights (``serve_config``) with float32
    compute; the reference engine's weights are carried to the port's."""
    cfg = f32(get_smoke_config(arch))
    ref_cfg = f32(ref_smoke(arch))
    ref_engine = ref_serve.ServeEngine.build(ref_cfg, make_host_mesh(), max_seq=P + 6)
    engine = serve.ServeEngine.build(cfg, P + 6, device="cpu")
    assert engine.cfg.param_dtype == "bfloat16" and engine.device.type == "cpu"
    engine.params.load_state_dict(convert.lm_params(to_numpy(ref_engine.params), engine.cfg))
    prompts, cross = inputs(cfg, B, P, seed=1)
    want = ref_engine.generate(prompts, 6, temperature=0.0, cross_embeds=None
                               if cross is None else jnp.asarray(cross))
    got = engine.generate(prompts, 6, temperature=0.0, cross_embeds=cross)
    assert got.dtype == np.int32 and got.shape == (B, P + 6)
    np.testing.assert_array_equal(got, want)


def test_sampling_is_seeded_and_echoes_the_prompt():
    cfg = get_smoke_config("gemma2_27b")
    engine = serve.ServeEngine.build(cfg, 24, device="cpu")
    prompts, _ = inputs(cfg, 3, 8, seed=2)
    a = engine.generate(prompts, 16, temperature=0.8, seed=5)
    b = engine.generate(prompts, 16, temperature=0.8, seed=5)
    c = engine.generate(prompts, 16, temperature=0.8, seed=6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(a[:, :8], prompts)
    assert a.min() >= 0 and a.max() < cfg.vocab


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("stablelm_3b")
    for call in (lambda: serve.ServeEngine.build(cfg, 16),
                 lambda: T.init_params(cfg),
                 lambda: T.init_caches(cfg, 1, 16),
                 lambda: serve.main(["--arch", "stablelm-3b", "--smoke"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert serve.ServeEngine.build(cfg, 16, device="cpu").params.embed.tok.device.type == "cpu"


@pytest.mark.parametrize("arch", ["gemma2-27b", "llama-3.2-vision-11b"])
def test_serve_main_on_the_cpu(arch, capsys):
    """The reference's flags plus ``--device``.  The VLM is refused with a
    pointer to ``ServeEngine.generate(cross_embeds=...)``: the entry point
    has no vision frontend (the reference's ``main`` passes none and fails
    on it)."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--gen", "4", "--temperature", "0"]
    if "vision" in arch:
        with pytest.raises(ValueError, match="cross_embeds"):
            serve.main(argv)
        return
    out = serve.main(argv)
    assert out.shape == (2, 12) and out.dtype == np.int32
    assert "tok/s" in capsys.readouterr().out


def test_step_functions_take_cross_embeddings_positionally():
    cfg = f32(get_smoke_config("llama_3_2_vision_11b"))
    model = T.init_params(cfg, 0, "cpu")
    tokens, cross = inputs(cfg, 2, 6)
    caches = T.init_caches(cfg, 2, 8, "cpu")
    logits, caches = steps.make_prefill_step(cfg)(model, t(tokens), caches, t(cross))
    logits2, _ = steps.make_decode_step(cfg)(
        model, logits.argmax(-1, keepdim=True), 6, caches, t(cross))
    assert logits.shape == logits2.shape == (2, cfg.vocab)
    assert steps.serve_config(cfg).param_dtype == "bfloat16"


def test_lm_caches_rejects_a_mismatch():
    cfg = f32(get_smoke_config("recurrentgemma_9b"))
    ref = to_numpy(ref_T.init_caches(cfg, 2, 16))
    got = convert.lm_caches(ref, cfg, 2, 16, "cpu")
    fresh = T.init_caches(cfg, 2, 16, "cpu")
    assert [sorted(c) for c in got] == [sorted(c) for c in fresh]
    assert all(bool((c["pos"] == -1).all()) for c in fresh if "pos" in c)  # empty slots
    with pytest.raises(ValueError):  # the local ring is min(seq_len, 8) long
        convert.lm_caches(ref, cfg, 2, 4, "cpu")
    with pytest.raises(ValueError):
        convert.lm_caches(ref, cfg, 3, 16, "cpu")
    with pytest.raises(ValueError):
        convert.lm_caches({**ref, "tail": []}, cfg, 2, 16, "cpu")


def test_lm_caches_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = f32(get_smoke_config("stablelm_3b"))
    ref = to_numpy(ref_T.init_caches(cfg, 1, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_caches(ref, cfg, 1, 8)
    assert convert.lm_caches(ref, cfg, 1, 8, device="cpu")[0]["k"].device.type == "cpu"


def test_generate_returns_the_logits_each_token_was_drawn_from():
    """``return_logits``: one [B, V] logits per generated token, greedy
    tokens their argmax, and the same tokens as a plain ``generate``; a
    model the caller holds is served as it is (float32 here)."""
    cfg = f32(get_smoke_config("recurrentgemma_9b"))
    engine = serve.ServeEngine(cfg, T.init_params(cfg, 0, "cpu"), P + 5, torch.device("cpu"))
    prompts, _ = inputs(cfg, B, P, seed=3)
    out, logits = engine.generate(prompts, 5, temperature=0.0, return_logits=True)
    assert len(logits) == 5 and all(lg.shape == (B, cfg.vocab) for lg in logits)
    assert logits[0].dtype == torch.float32
    picked = torch.stack([lg.argmax(-1) for lg in logits], dim=1)
    np.testing.assert_array_equal(out[:, P:], picked.numpy())
    np.testing.assert_array_equal(out, engine.generate(prompts, 5, temperature=0.0))


@pytest.mark.parametrize("gen_len", [0, 1, 3])
def test_generate_returns_exactly_gen_len_logits(gen_len):
    """``gen_len`` tokens and ``gen_len`` logits, none at 0 (the prompts
    come back as they are); the tokens are a prefix of a longer run's."""
    cfg = f32(get_smoke_config("stablelm_3b"))
    engine = serve.ServeEngine(cfg, T.init_params(cfg, 0, "cpu"), P + 3, torch.device("cpu"))
    prompts, _ = inputs(cfg, B, P, seed=4)
    out, logits = engine.generate(prompts, gen_len, temperature=0.0, return_logits=True)
    assert out.shape == (B, P + gen_len) and len(logits) == gen_len
    np.testing.assert_array_equal(out[:, :P], prompts)
    longer = engine.generate(prompts, 3, temperature=0.0)
    np.testing.assert_array_equal(out, longer[:, :P + gen_len])
    for i, lg in enumerate(logits):
        np.testing.assert_array_equal(out[:, P + i], lg.argmax(-1).numpy())


def test_serve_decode_example_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_serve_decode", os.path.join(ROOT, "examples", "torch_serve_decode.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out, verdict = example.main(["--device", "cpu"])
    assert out.shape == (4, 40)
    full = get_config("gemma2_27b")
    n_params = full.param_count()
    want = analyze(Workload("gemma2-27b decode bs=128", flops=2 * n_params * 128,
                            hbm_bytes=2 * n_params + 128 * 2e6))
    assert verdict == want
    text = capsys.readouterr().out
    assert "[serve]" in text and "[analyzer]" in text
