"""The port's optimizers against the JAX reference, on the CPU: AdamW (with
a schedule, and with a flat lr and weight decay) and Adafactor (with and
without weight decay) fed the same numpy gradients for 5 steps; parameters
and every moment agree within ``TOL`` × the tensor's largest value (both
sides compute the same float32 elementwise formulas; the sums in
Adafactor's means and the clip may take another order); Adafactor with
``stacks`` against the reference's stacked unit.  Also
``global_norm``, ``clip_by_global_norm``, ``warmup_cosine``,
``choose_optimizer``, ``opt_state_shapes`` and twins of
``tests/test_substrate.py``'s optimizer tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as ref_adafactor
from repro.optim import adamw as ref_adamw
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import global_norm as ref_global_norm
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.optim.adamw import apply_updates as ref_apply_updates
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import steps
from repro_torch.optim import adafactor, adamw, clip_by_global_norm, global_norm, warmup_cosine
from repro_torch.optim.adamw import apply_updates

TOL = 1e-6
SHAPES = {"w": (16, 12), "experts": (3, 8, 5), "b": (7,), "scale": ()}

OPTIMIZERS = {
    "adamw-schedule": (lambda: ref_adamw(lr=ref_warmup_cosine(1e-2, 2, 10), weight_decay=0.1),
                       lambda: adamw(lr=warmup_cosine(1e-2, 2, 10), weight_decay=0.1)),
    "adamw-flat": (lambda: ref_adamw(lr=3e-3, b1=0.8, weight_decay=0.0),
                   lambda: adamw(lr=3e-3, b1=0.8, weight_decay=0.0)),
    "adafactor": (lambda: ref_adafactor(lr=1e-2), lambda: adafactor(lr=1e-2)),
    "adafactor-wd": (lambda: ref_adafactor(lr=1e-2, clip_threshold=0.5, weight_decay=0.01),
                     lambda: adafactor(lr=1e-2, clip_threshold=0.5, weight_decay=0.01)),
}


def _close(got: torch.Tensor, want, what):
    want = np.asarray(want, dtype=np.float64)
    assert tuple(got.shape) == want.shape, what
    err = float(np.abs(got.double().numpy() - want).max(initial=0.0))
    assert err <= TOL * max(float(np.abs(want).max(initial=0.0)), 1e-30), (what, err)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference_on_identical_gradients(name):
    make_ref, make_port = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    init = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in SHAPES.items()}
    ref_opt, opt = make_ref(), make_port()
    ref_params = {k: jnp.asarray(v) for k, v in init.items()}
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    for step in range(5):
        # gradients over many magnitudes, a few exactly 0
        grads = {k: np.asarray(rng.standard_normal(s) * 10.0 ** rng.integers(-6, 2, s),
                               np.float32) for k, s in SHAPES.items()}
        grads["w"][0, :3] = 0.0
        ref_up, ref_state = ref_opt.update({k: jnp.asarray(g) for k, g in grads.items()},
                                           ref_state, ref_params)
        ref_params = ref_apply_updates(ref_params, ref_up)
        up, state = opt.update({k: torch.from_numpy(g) for k, g in grads.items()}, state, params)
        assert apply_updates(params, up) is params
        assert int(state["step"]) == int(ref_state["step"]) == step + 1
        for k in SHAPES:
            _close(up[k], ref_up[k], (name, step, "update", k))
            _close(params[k], ref_params[k], (name, step, "param", k))
            if "m" in state:
                _close(state["m"][k], ref_state["m"][k], (name, step, "m", k))
                _close(state["v"][k], ref_state["v"][k], (name, step, "v", k))
            else:
                assert set(state["s"][k]) == set(ref_state["s"][k])
                for leaf in state["s"][k]:
                    _close(state["s"][k][leaf], ref_state["s"][k][leaf], (name, step, leaf, k))


@pytest.mark.parametrize("repeats", [1, 3])
def test_adafactor_stacks_match_reference(repeats):
    """Parameters named in ``stacks`` are updated as the reference updates
    its stacked unit: a stack of vectors factored over the repeats, the RMS
    clip taken over the whole stack; the others stand alone.  5 steps,
    weight decay on, compared as above."""
    rng = np.random.default_rng(repeats)
    unit = {"w": (16, 12), "norm": (7,), "experts": (3, 8, 5)}
    ref_init = {"units": [{k: rng.standard_normal((repeats, *s)).astype(np.float32)
                           for k, s in unit.items()}],
                "embed": rng.standard_normal((10, 6)).astype(np.float32),
                "b": rng.standard_normal(7).astype(np.float32)}
    stacks = {f"units.0.{k}": [f"layers.{i}.{k}" for i in range(repeats)] for k in unit}

    def flat(tree):
        out = {k: tree[k] for k in ("embed", "b")}
        out.update({f"layers.{i}.{k}": v[i] for k, v in tree["units"][0].items()
                    for i in range(repeats)})
        return out

    kw = {"lr": 1e-2, "clip_threshold": 0.5, "weight_decay": 0.01}
    ref_opt, opt = ref_adafactor(**kw), adafactor(**kw, stacks=stacks)
    ref_params = {"units": [{k: jnp.asarray(v) for k, v in ref_init["units"][0].items()}],
                  "embed": jnp.asarray(ref_init["embed"]), "b": jnp.asarray(ref_init["b"])}
    params = {k: torch.from_numpy(np.array(v)) for k, v in flat(ref_init).items()}
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    assert set(state["s"]) == {"embed", "b", *stacks}
    for step in range(5):
        g = {"units": [{k: np.asarray(rng.standard_normal((repeats, *s))
                                      * 10.0 ** rng.integers(-6, 2, (repeats, *s)), np.float32)
                        for k, s in unit.items()}],
             "embed": rng.standard_normal((10, 6)).astype(np.float32),
             "b": rng.standard_normal(7).astype(np.float32)}
        ref_up, ref_state = ref_opt.update(
            {"units": [{k: jnp.asarray(v) for k, v in g["units"][0].items()}],
             "embed": jnp.asarray(g["embed"]), "b": jnp.asarray(g["b"])}, ref_state, ref_params)
        ref_params = ref_apply_updates(ref_params, ref_up)
        up, state = opt.update({k: torch.from_numpy(v) for k, v in flat(g).items()},
                               state, params)
        apply_updates(params, up)
        want_up, want_p = flat(ref_up), flat(ref_params)
        for k in params:
            _close(up[k], want_up[k], (repeats, step, "update", k))
            _close(params[k], want_p[k], (repeats, step, "param", k))
        ref_s = {"embed": ref_state["s"]["embed"], "b": ref_state["s"]["b"],
                 **{f"units.0.{k}": v for k, v in ref_state["s"]["units"][0].items()}}
        for key, leaves in state["s"].items():
            assert set(leaves) == set(ref_s[key]), key
            for leaf, got in leaves.items():
                _close(got, ref_s[key][leaf], (repeats, step, key, leaf))


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((5, 4)).astype(np.float32),
            "b": rng.standard_normal(9).astype(np.float32) * 3}
    port = {k: torch.from_numpy(v) for k, v in tree.items()}
    ref = {k: jnp.asarray(v) for k, v in tree.items()}
    assert float(global_norm(port)) == pytest.approx(float(ref_global_norm(ref)), rel=1e-6)
    for max_norm in (1.0, 1e3):  # clipped, and left alone
        got, norm = clip_by_global_norm(port, max_norm)
        want, ref_norm = ref_clip(ref, max_norm)
        assert float(norm) == pytest.approx(float(ref_norm), rel=1e-6)
        for k in tree:
            _close(got[k], want[k], (max_norm, k))
    bf16 = {"x": torch.ones(4, dtype=torch.bfloat16) * 3}
    clipped, _ = clip_by_global_norm(bf16, 1.0)
    assert clipped["x"].dtype == torch.bfloat16


@pytest.mark.parametrize("peak,warmup,total", [(1e-3, 10, 100), (3e-4, 200, 10000), (1.0, 0, 5)])
def test_warmup_cosine_matches_reference(peak, warmup, total):
    fn, ref_fn = warmup_cosine(peak, warmup, total), ref_warmup_cosine(peak, warmup, total)
    for step in (0, 1, 5, warmup, warmup + 1, total // 2, total, 2 * total):
        want = float(ref_fn(jnp.asarray(step, jnp.int32)))
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_adamw_converges_quadratic():
    opt = adamw(lr=0.1, weight_decay=0.0)
    x = torch.tensor([5.0, -3.0], requires_grad=True)
    params = {"x": x}
    state = opt.init(params)
    for _ in range(200):
        (g,) = torch.autograd.grad(torch.sum(x ** 2), x)
        up, state = opt.update({"x": g}, state, params)
        apply_updates(params, up)
    assert float(x.detach().abs().max()) < 1e-2


def test_adafactor_state_is_factored():
    opt = adafactor()
    params = {"w": torch.ones((64, 32)), "b": torch.ones((7,))}
    st_ = opt.init(params)
    assert st_["s"]["w"]["vr"].shape == (64,)
    assert st_["s"]["w"]["vc"].shape == (32,)
    assert st_["s"]["b"]["v"].shape == (7,)
    g = {k: torch.ones_like(v) for k, v in params.items()}
    up, st2 = opt.update(g, st_, params)
    assert all(up[k].shape == params[k].shape for k in params)


def test_choose_optimizer_and_state_shapes():
    small, grok = get_smoke_config("stablelm_3b"), get_config("grok_1_314b")
    assert steps.choose_optimizer(small)[0] == "adamw"
    assert steps.choose_optimizer(grok)[0] == "adafactor"
    for name in ("adamw", "adamw-fast", "adafactor"):
        assert steps.choose_optimizer(small, name)[0] == name
    with pytest.raises(ValueError):
        steps.choose_optimizer(small, "sgd")
    full = get_config("stablelm_3b")
    shapes = steps.param_shapes(full)
    state = steps.opt_state_shapes(steps.choose_optimizer(full, "adamw")[1], shapes)
    assert all(t.device.type == "meta" for t in state["m"].values())
    assert sum(t.numel() for t in state["v"].values()) == full.param_count()
    fact = steps.opt_state_shapes(adafactor(), shapes)["s"]
    assert set(fact) == set(shapes)
    assert fact["embed.tok"]["vr"].shape == shapes["embed.tok"].shape[:-1]
    # choose_optimizer's Adafactor keeps one state per stacked unit position
    stacked = steps.opt_state_shapes(steps.choose_optimizer(full, "adafactor")[1], shapes)["s"]
    assert stacked["units.0.attn_norm"]["vr"].shape == (full.n_layers,)
    assert stacked["units.0.attn_norm"]["vc"].shape == (full.d_model,)
    assert stacked["units.0.attn.wq"]["vr"].shape == (full.n_layers, full.d_model)
    assert not any(k.startswith("layers.") for k in stacked)
