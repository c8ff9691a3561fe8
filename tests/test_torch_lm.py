"""The port's LM substrate against the JAX reference, on the CPU: configs,
sizing and shapes equal; every arch's forward logits agree; and each
numerical pitfall of the layers (blocked flash attention, MoE routing under
capacity drops, tanh GELU, the ``1 + w`` norm, half-split rotary, tied
embeddings, head padding, softplus past 20, the causal conv, the linear
scan) has a case of its own.

Bounds: float32 logits within ``F32_TOL`` × max|logit| (the port and XLA
sum in other orders; measured about 1.4e-6).  At the default dtypes
(bf16 compute) within ``BF16_TOL`` × max|logit|: XLA keeps fused
elementwise intermediates in float32 where eager PyTorch rounds each op to
bf16 (2^-8 relative), measured 0.8 – 3.1 % through these few layers.  A
bf16 rounding can also flip a near-tied top-k router choice, and a flipped
token takes other experts' output; so for MoE archs the bound holds for at
least ``MOE_BF16_SHARE`` of the token positions (routing indices are held
equal in float32 below).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_lm import f32, inputs, n, port_model, ref_params, rel_err, t, to_numpy
from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_T
from repro_torch import configs, convert
from repro_torch.launch import steps
from repro_torch.models import attention, layers, moe, rglru, ssm
from repro_torch.models import transformer as T

F32_TOL = 1e-4
BF16_TOL = 0.05
MOE_BF16_SHARE = 7 / 8


def _ref_forward(cfg, tree, tokens, cross):
    logits, aux, _ = ref_T.forward(tree, jnp.asarray(tokens), cfg, cross_embeds=None
                                   if cross is None else jnp.asarray(cross))
    return logits, aux


def _port_forward(cfg, model, tokens, cross):
    with torch.no_grad():
        logits, aux, _ = T.forward(model, t(tokens), cfg, cross_embeds=t(cross))
    return logits, aux


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_configs_and_sizing_match_reference(arch):
    assert configs.ARCHS == ref_configs.ARCHS
    for port_cfg, ref_cfg in ((configs.get_config(arch), ref_configs.get_config(arch)),
                              (configs.get_smoke_config(arch),
                               ref_configs.get_smoke_config(arch))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        assert port_cfg.param_count() == ref_cfg.param_count()
        assert port_cfg.active_param_count() == ref_cfg.active_param_count()
        assert port_cfg.layer_kinds() == ref_cfg.layer_kinds()
    display = arch.replace("_", "-")
    assert configs.get_config(display).name == ref_configs.get_config(display).name
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    for cell_name, cell in configs.SHAPES.items():
        ref_cell = ref_configs.SHAPES[cell_name]
        assert dataclasses.asdict(cell) == dataclasses.asdict(ref_cell)
        specs, ref_specs = configs.input_specs(cfg, cell), ref_configs.input_specs(ref_cfg,
                                                                                  ref_cell)
        assert list(specs) == list(ref_specs)
        for k, spec in specs.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(ref_specs[k].shape)
            assert _dtype_name(spec.dtype) == str(ref_specs[k].dtype)
        assert steps.model_flops_for_cell(cfg, cell) == ref_steps.model_flops_for_cell(
            ref_cfg, ref_cell)
        for chips, fsdp, opt in ((256, False, "adamw"), (512, True, "adafactor")):
            assert steps.estimate_residency(cfg, cell, chips=chips, fsdp=fsdp,
                                            optimizer=opt) == ref_steps.estimate_residency(
                ref_cfg, ref_cell, chips=chips, fsdp=fsdp, optimizer=opt)


def test_unknown_arch_and_dtype_raise():
    with pytest.raises(KeyError):
        configs.get_config("gpt-5")
    with pytest.raises(ValueError):
        configs.torch_dtype("float8")
    assert configs.torch_dtype("bfloat16") == torch.bfloat16


def _ref_flat(tree, cfg):
    """A reference ``units``/``tail`` tree of shape structs as ``{port
    name: (shape, dtype name)}``, one entry per layer."""
    U, out = len(cfg.unit), {}
    for pos, unit in enumerate(tree["units"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(unit):
            name = ".".join(str(k.key) for k in path)
            for i in range(cfg.n_units):
                out[f"layers.{i * U + pos}.{name}"] = (tuple(leaf.shape[1:]), str(leaf.dtype))
    for j, tail in enumerate(tree["tail"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tail):
            name = ".".join(str(k.key) for k in path)
            out[f"layers.{cfg.n_units * U + j}.{name}"] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ["gemma2_27b", "recurrentgemma_9b", "llama_3_2_vision_11b",
                                  "deepseek_moe_16b", "mamba2_780m"])
def test_param_and_cache_shapes_match_reference(arch):
    """Full-width shapes and dtypes from the ``meta`` device equal the
    reference's ``eval_shape`` trees, unstacked into per-layer order."""
    cfg = steps.serve_config(configs.get_config(arch))
    ref_cfg = ref_steps.serve_config(ref_configs.get_config(arch))
    ref_tree = ref_steps.param_shapes(ref_cfg)
    want = _ref_flat(ref_tree, cfg)
    want.update({f"embed.{k}": (tuple(v.shape), str(v.dtype))
                 for k, v in ref_tree["embed"].items()})
    want["final_norm"] = (tuple(ref_tree["final_norm"].shape), str(ref_tree["final_norm"].dtype))
    shapes = steps.param_shapes(cfg)
    assert all(v.device.type == "meta" for v in shapes.values())
    assert {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in shapes.items()} == want

    caches = steps.cache_shapes(cfg, 4, 544)
    want = _ref_flat(ref_steps.cache_shapes(ref_cfg, 4, 544), cfg)
    got = {f"layers.{i}.{k}": (tuple(v.shape), _dtype_name(v.dtype))
           for i, entry in enumerate(caches) for k, v in entry.items()}
    assert got == want
    assert len(caches) == cfg.n_layers
    assert all(c == {} for c, kind in zip(caches, cfg.layer_kinds()) if kind == "cross")


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_forward_matches_reference_float32(arch):
    cfg = f32(configs.get_smoke_config(arch))
    tree = ref_params(cfg)
    tokens, cross = inputs(cfg, 2, 16)
    want, want_aux = _ref_forward(cfg, tree, tokens, cross)
    got, got_aux = _port_forward(cfg, port_model(cfg, tree), tokens, cross)
    assert got.shape == (2, 16, cfg.vocab) and got.dtype == torch.float32
    assert rel_err(got, want) <= F32_TOL
    np.testing.assert_allclose(n(got_aux["load_balance_loss"]),
                               n(want_aux["load_balance_loss"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_forward_matches_reference_bf16(arch):
    cfg = configs.get_smoke_config(arch)  # float32 parameters, bf16 compute
    tree = ref_params(cfg)
    tokens, cross = inputs(cfg, 2, 16)
    want, _ = _ref_forward(cfg, tree, tokens, cross)
    got, _ = _port_forward(cfg, port_model(cfg, tree), tokens, cross)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    per_token = np.abs(n(got) - n(want)).max(-1) / np.abs(n(want)).max()
    within = float((per_token <= BF16_TOL).mean())
    assert within >= (MOE_BF16_SHARE if cfg.n_experts else 1.0), (within, per_token.max())


# ------------------------------------------------------- attention pieces

@pytest.mark.parametrize("causal,window,cap,bq,bk,dtype", [
    (True, 0, 0.0, 4, 5, np.float32),
    (True, 5, 20.0, 4, 5, np.float32),
    (True, 3, 0.0, 8, 3, np.float32),
    (False, 0, 50.0, 5, 4, np.float32),
    (True, 6, 50.0, 4, 5, "bfloat16"),
])
def test_flash_attention_matches_reference(causal, window, cap, bq, bk, dtype):
    """Blocks that do not divide T (13) or S, GQA (H=4, K=2), a window and a
    softcap; key padding carries ``POS_SENTINEL``."""
    rng = np.random.default_rng(0)
    B, T_, H, K, D = 2, 13, 4, 2, 16
    q, k, v = (rng.standard_normal((B, T_, h, D)).astype(np.float32) for h in (H, K, K))
    kw = dict(causal=causal, window=window, attn_softcap=cap, bq=bq, bk=bk)
    if dtype == "bfloat16":
        ref_in = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
        port_in = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
        tol = 1e-2
    else:
        ref_in, port_in, tol = [jnp.asarray(x) for x in (q, k, v)], [t(x) for x in (q, k, v)], 1e-5
    want = ref_attn.flash_attention(*ref_in, **kw)
    got = attention.flash_attention(*port_in, **kw)
    assert got.dtype == port_in[0].dtype and got.shape == (B, T_, H, D)
    assert rel_err(got, want) <= tol


def test_decode_attention_matches_reference():
    """A ring with empty slots (pos −1), slots past the position, a window
    and a softcap."""
    rng = np.random.default_rng(1)
    B, S, H, K, D = 2, 10, 6, 2, 16
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, D)).astype(np.float32) for _ in range(2))
    pos = np.array([10, 11, 12, 3, 4, 5, 6, 7, -1, -1], np.int32)
    for window, cap in ((0, 0.0), (6, 30.0)):
        want = ref_attn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(pos), jnp.asarray(11), window=window,
                                         attn_softcap=cap)
        got = attention.decode_attention(t(q), t(k), t(v), t(pos), 11, window=window,
                                         attn_softcap=cap)
        assert rel_err(got, want) <= 1e-5


def test_kv_quantisation_matches_reference():
    """Per-(token, head) int8 scales: both round half to even, so the codes
    and the scales are equal."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    x[1, 1, 1] = 0.0  # an all-zero head: the scale floor
    want_q, want_s = ref_attn._quant_kv(jnp.asarray(x))
    got_q, got_s = attention._quant_kv(t(x))
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_pad_heads_is_exact():
    """``pad_heads_to`` with kv-group-aware grafting equals the unpadded
    model exactly, and the padded model equals the reference's."""
    cfg = f32(configs.get_smoke_config("llama3_2_3b"))  # 6 heads, kv=2, G=3
    cfg_p = dataclasses.replace(cfg, pad_heads_to=8, opt_attn_layout=True)
    tree = ref_params(cfg)
    tokens, _ = inputs(cfg, 2, 12)
    base, _ = _port_forward(cfg, port_model(cfg, tree), tokens, None)

    hd, K = cfg.hd, cfg.n_kv_heads
    G_old, G_new = cfg.n_heads // K, 8 // K
    tree_p = {**tree, "units": []}
    for unit in tree["units"]:
        a = unit["attn"]
        wq = np.zeros(a["wq"].shape[:2] + (8 * hd,), np.float32)
        wo = np.zeros((a["wo"].shape[0], 8 * hd, a["wo"].shape[2]), np.float32)
        for i in range(cfg.n_heads):
            s_ = (i // G_old) * G_new + (i % G_old)
            wq[:, :, s_ * hd:(s_ + 1) * hd] = a["wq"][:, :, i * hd:(i + 1) * hd]
            wo[:, s_ * hd:(s_ + 1) * hd, :] = a["wo"][:, i * hd:(i + 1) * hd, :]
        tree_p["units"].append({**unit, "attn": {**a, "wq": wq, "wo": wo}})
    padded, _ = _port_forward(cfg_p, port_model(cfg_p, tree_p), tokens, None)
    assert torch.equal(padded, base)
    want, _ = _ref_forward(cfg_p, tree_p, tokens, None)
    assert rel_err(padded, want) <= F32_TOL


# ------------------------------------------------------------------- MoE

def test_moe_routing_under_capacity_drops():
    """Capacity factor 0.5 drops assignments: the expert indices, the drop
    fraction and the load-balance loss equal the reference's, the output
    agrees within float32 rounding."""
    cfg = dataclasses.replace(f32(configs.get_smoke_config("deepseek_moe_16b")),
                              capacity_factor=0.5)
    p_tree = to_numpy(ref_moe.init_moe(jax.random.PRNGKey(3), cfg))
    x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_moe.apply_moe(p_tree, jnp.asarray(x), cfg)
    p = moe.MoE(cfg, device="cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in convert._leaves(p_tree)})
    with torch.no_grad():
        got, got_aux = moe.apply_moe(p, t(x), cfg)
    assert moe.capacity(32, cfg) == ref_moe.capacity(32, cfg)
    assert float(got_aux["dropped_frac"]) > 0.1
    assert float(got_aux["dropped_frac"]) == float(want_aux["dropped_frac"])
    np.testing.assert_allclose(float(got_aux["load_balance_loss"]),
                               float(want_aux["load_balance_loss"]), rtol=1e-6)
    assert rel_err(got, want) <= 1e-5
    xf = x.reshape(-1, cfg.d_model)
    ref_i = jax.lax.top_k(jax.nn.softmax(jnp.asarray(xf) @ p_tree["router"], axis=-1),
                          cfg.top_k)[1]
    port_i = torch.topk(torch.softmax(t(xf) @ p.router, dim=-1), cfg.top_k).indices
    np.testing.assert_array_equal(port_i.numpy(), np.asarray(ref_i))


# ----------------------------------------------------- layers pitfalls

def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = layers.gelu(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    assert float((got - F.gelu(t(x))).abs().max()) > 1e-4  # the erf form differs
    cfg = f32(configs.get_smoke_config("musicgen_large"))  # non-gated GELU MLP
    p_tree = to_numpy(ref_layers.init_mlp(jax.random.PRNGKey(4), cfg))
    p = layers.MLP(cfg, device="cpu")
    p.load_state_dict({k: t(v) for k, v in p_tree.items()})
    h = np.random.default_rng(4).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    assert rel_err(layers.apply_mlp(p, t(h), cfg),
                   ref_layers.apply_mlp(p_tree, jnp.asarray(h), cfg)) <= 1e-5


def test_norm_rope_and_embedding_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)  # scales by 1 + w
    assert rel_err(layers.rms_norm(t(x), t(w)), ref_layers.rms_norm(jnp.asarray(x),
                                                                     jnp.asarray(w))) <= 1e-6
    assert rel_err(layers.softcap(t(x) * 40, 30.0),
                   ref_layers.softcap(jnp.asarray(x) * 40, 30.0)) <= 1e-6
    q = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.array([0, 1, 7, 4095, 4351], np.int32)
    got = layers.apply_rope(t(q), t(pos)[None].expand(2, 5), 10000.0)
    want = ref_layers.apply_rope(jnp.asarray(q), jnp.asarray(pos)[None] * jnp.ones((2, 1),
                                                                                   jnp.int32),
                                 10000.0)
    assert rel_err(got, want) <= 1e-5
    cfg = configs.get_smoke_config("gemma2_27b")  # tied, bf16 compute, sqrt(64) = 8
    cfg = dataclasses.replace(cfg, d_model=48, n_heads=3, n_kv_heads=1)  # sqrt(48) inexact
    e_tree = to_numpy(ref_layers.init_embed(jax.random.PRNGKey(5), cfg))
    e = layers.Embed(cfg, device="cpu")
    e.load_state_dict({k: t(v) for k, v in e_tree.items()})
    tokens = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    got = layers.embed_tokens(e, t(tokens), cfg)
    want = ref_layers.embed_tokens(e_tree, jnp.asarray(tokens), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(got), n(want))
    h = rng.standard_normal((2, 6, 48)).astype(np.float32)
    assert rel_err(layers.lm_head(e, t(h).to(torch.bfloat16), cfg),
                   ref_layers.lm_head(e_tree, jnp.asarray(h, jnp.bfloat16), cfg)) <= 1e-2


# ---------------------------------------------------- recurrent blocks

def _load(module, tree):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in convert._leaves(tree)})
    return module


def test_ssm_block_matches_reference_with_large_dt():
    """dt_bias up to 24 (softplus past its linear threshold of 20), a
    ragged last chunk, a carried state, then two one-token decodes."""
    cfg = f32(configs.get_smoke_config("mamba2_780m"))
    rng = np.random.default_rng(6)
    p_tree = to_numpy(ref_ssm.init_ssm(jax.random.PRNGKey(6), cfg))
    p_tree["dt_bias"] = rng.uniform(-4, 24, p_tree["dt_bias"].shape).astype(np.float32)
    p_tree["conv_b"] = rng.normal(0, 0.3, p_tree["conv_b"].shape).astype(np.float32)
    p = _load(ssm.SSM(cfg, device="cpu"), p_tree)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    state = to_numpy(ref_ssm.init_ssm_state(cfg, 2))
    state["h"] = rng.standard_normal(state["h"].shape).astype(np.float32)
    state["conv"] = rng.standard_normal(state["conv"].shape).astype(np.float32)
    want, want_s = ref_ssm.ssm_block(p_tree, jnp.asarray(x), cfg, state=state)
    got, got_s = ssm.ssm_block(p, t(x), cfg, state={k: t(v) for k, v in state.items()})
    assert rel_err(got, want) <= 1e-5
    for k in ("conv", "h"):
        assert rel_err(got_s[k], want_s[k]) <= 1e-5
    for step in range(2):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, want_s = ref_ssm.ssm_block(p_tree, jnp.asarray(x1), cfg, state=want_s)
        got, got_s = ssm.ssm_block(p, t(x1), cfg, state=got_s)
        assert rel_err(got, want) <= 1e-5 and rel_err(got_s["h"], want_s["h"]) <= 1e-5


def test_rglru_block_matches_reference_with_large_lambda():
    """softplus(Λ) past 20 on some channels, a carried conv and h state (the
    prefill folds h into the first step), short prompts (T < W−1), decode."""
    cfg = f32(configs.get_smoke_config("recurrentgemma_9b"))
    rng = np.random.default_rng(7)
    p_tree = to_numpy(ref_rglru.init_rglru(jax.random.PRNGKey(7), cfg))
    p_tree["lam"] = rng.uniform(-8, 24, p_tree["lam"].shape).astype(np.float32)
    p_tree["conv_b"] = rng.normal(0, 0.3, p_tree["conv_b"].shape).astype(np.float32)
    p = _load(rglru.RGLRU(cfg, device="cpu"), p_tree)
    for T_ in (11, 2):
        x = rng.standard_normal((2, T_, cfg.d_model)).astype(np.float32)
        state = {"conv": rng.standard_normal((2, cfg.conv_width - 1, cfg.lru_dim)).astype(
            np.float32), "h": rng.standard_normal((2, cfg.lru_dim)).astype(np.float32)}
        want, want_s = ref_rglru.rglru_block(p_tree, jnp.asarray(x), cfg, state=state)
        got, got_s = rglru.rglru_block(p, t(x), cfg, state={k: t(v) for k, v in state.items()})
        assert rel_err(got, want) <= 1e-5
        for k in ("conv", "h"):
            assert rel_err(got_s[k], want_s[k]) <= 1e-5
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, _ = ref_rglru.rglru_block(p_tree, jnp.asarray(x1), cfg, state=want_s)
        got, _ = rglru.rglru_block(p, t(x1), cfg, state=got_s)
        assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("T_", [1, 2, 5, 16, 33])
def test_linear_scan_matches_a_loop_and_the_reference(T_):
    """The log-depth scan against a sequential float64 loop (float32
    rounding: 1e-5) and against ``associative_scan``."""
    rng = np.random.default_rng(T_)
    a = rng.uniform(0, 1, (2, T_, 8)).astype(np.float32)
    b = rng.standard_normal((2, T_, 8)).astype(np.float32)
    got = rglru.linear_scan(t(a), t(b))
    h, want = np.zeros((2, 8)), []
    for i in range(T_):
        h = a[:, i].astype(np.float64) * h + b[:, i]
        want.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-5, atol=1e-5)
    _, ref = jax.lax.associative_scan(lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]),
                                      (jnp.asarray(a), jnp.asarray(b)), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert rel_err(ssm._causal_conv(t(x), t(w), t(b)), want) <= 1e-6


# --------------------------------------------------------------- convert

def test_lm_params_rejects_a_mismatch():
    cfg = f32(configs.get_smoke_config("gemma2_27b"))
    tree = ref_params(cfg)
    assert set(convert.lm_params(tree, cfg)) == set(T.Transformer(cfg, device="meta")
                                                      .state_dict())
    missing = {**tree, "embed": {}}
    with pytest.raises(ValueError):
        convert.lm_params(missing, cfg)
    wrong = {**tree, "final_norm": np.zeros(7, np.float32)}
    with pytest.raises(ValueError):
        convert.lm_params(wrong, cfg)
    with pytest.raises(ValueError):
        convert.lm_params({**tree, "units": tree["units"][:1]}, cfg)
    with pytest.raises(ValueError):
        convert.lm_params(tree, dataclasses.replace(cfg, n_layers=6))
