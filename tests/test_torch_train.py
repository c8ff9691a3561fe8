"""The port's LM training path against the JAX reference, on the CPU: the
loss and every gradient of all ten archs, ``remat`` "full" and "dots"
against none, the train step's optimizer state carried across by
``convert.lm_opt_state``, the losses of three train steps, the
fault-tolerant loop (twins of ``tests/test_system.py``'s train tests, and a
failure partway through the in-place update), the device rule of ``build_run``, ``python -m repro_torch.launch.train`` and
``examples/torch_train_lm.py``.

Bounds.  Gradients in float32 within ``F32_TOL`` × the tensor's largest
|grad| (the two sides sum in other orders; measured at most 4.5e-6).  The
loss within ``LOSS_RTOL`` relative.  Optimizer moments after one step are
linear in the gradients and keep ``F32_TOL``.  Parameters after several
steps are not compared element by element: Adam divides each gradient by
its own magnitude, so a gradient element near 0 whose sign differs between
the two sides by a 1e-6 difference moves by up to 2·lr.  Such elements have
near-zero gradients, so the loss moves by about their |grad| · lr; the
losses of three ``adamw-fast`` steps (lr 3e-3) keep ``STEP_LOSS_RTOL``.
"""

import copy
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_lm import f32, inputs, port_model, ref_params, t, to_numpy
from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_T
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch import steps, train
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import Optimizer
from repro_torch.runtime.fault_tolerance import FTConfig, FaultInjector

F32_TOL = 1e-4
LOSS_RTOL = 1e-5
STEP_LOSS_RTOL = 1e-4
B, S = 2, 16
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _batch(cfg, seed: int = 0):
    """Tokens, labels (some masked with -1) and, for the VLM, patch
    embeddings, as numpy."""
    tokens, cross = inputs(cfg, B, S, seed)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, 3] = -1
    batch = {"tokens": tokens, "labels": labels.astype(np.int32)}
    if cross is not None:
        batch["cross_embeds"] = cross
    return batch


def _ref_loss_and_grads(cfg, tree, batch):
    ref_cfg = dataclasses.replace(cfg, remat="none")
    (loss, aux), grads = jax.value_and_grad(ref_T.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg)
    return float(loss), {k: float(v) for k, v in aux.items()}, to_numpy(grads)


def _port_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def _assert_grads_close(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k)
        assert bool(torch.isfinite(g).all()), (what, k)
        scale = float(w.abs().max())
        err = float((g.double() - w.double()).abs().max())
        assert err <= F32_TOL * max(scale, 1e-30), (what, k, err, scale)


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    cfg = dataclasses.replace(f32(get_smoke_config(arch)), remat="none")
    tree = ref_params(cfg)
    batch = _batch(cfg)
    want_loss, want_aux, want_grads = _ref_loss_and_grads(cfg, tree, batch)
    model = port_model(cfg, tree)
    loss, metrics, grads = steps.loss_and_grads(model, _port_batch(batch), cfg)
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert abs(float(metrics["ce"]) - want_aux["ce"]) <= LOSS_RTOL * abs(want_aux["ce"])
    assert abs(float(metrics["load_balance_loss"]) - want_aux["load_balance_loss"]) <= (
        LOSS_RTOL * max(abs(want_aux["load_balance_loss"]), 1e-30))
    want = {k: v.float() for k, v in convert.lm_params(want_grads, cfg).items()}
    _assert_grads_close(grads, want, arch)
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_remat_gives_the_same_loss_and_gradients(arch, remat):
    cfg = f32(get_smoke_config(arch))
    model = port_model(cfg, ref_params(cfg))
    batch = _port_batch(_batch(cfg, seed=1))
    runs = {r: steps.loss_and_grads(model, batch, dataclasses.replace(cfg, remat=r))
            for r in ("none", remat)}
    (want_loss, _, want), (loss, _, got) = runs["none"], runs[remat]
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    _assert_grads_close(got, want, f"{arch} remat={remat}")


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["stablelm_3b", "recurrentgemma_9b", "deepseek_moe_16b"])
def test_remat_recomputes_what_its_policy_says(arch):
    """Backward recomputes every unit layer's products under "full" and
    none of them under "dots" (they are saved); the tail is never
    checkpointed."""
    cfg = f32(get_smoke_config(arch))
    model = port_model(cfg, ref_params(cfg))
    batch = _port_batch(_batch(cfg))
    products = {}
    for remat in ("none", "full", "dots"):
        loss, _ = T.loss_fn(model, batch, dataclasses.replace(cfg, remat=remat))
        with _CountProducts() as count:
            loss.backward()
        products[remat] = count.mm
        model.zero_grad(set_to_none=True)
    assert products["dots"] == products["none"] < products["full"]
    with pytest.raises(ValueError, match="remat"):
        T.loss_fn(model, batch, dataclasses.replace(cfg, remat="some"))


def test_state_dict_names_are_the_parameters():
    model = T.init_params(get_smoke_config("deepseek_moe_16b"), 0, "cpu")
    assert list(model.state_dict()) == [k for k, _ in model.named_parameters()]


def _ref_steps(cfg, tree, name: str, n_steps: int, seed: int):
    """``n_steps`` reference train steps → (losses, opt states as numpy)."""
    _, opt = ref_steps.choose_optimizer(cfg, name)
    step = jax.jit(ref_steps.make_train_step(cfg, opt))
    params = jax.tree.map(jnp.asarray, tree)
    state = opt.init(params)
    stream = SyntheticStream(DataConfig(cfg.vocab, S, B, seed=seed))
    losses, states = [], []
    for i in range(n_steps):
        batch = {k: jnp.asarray(v.numpy().astype(np.int32))
                 for k, v in stream.next_batch(i).items()}
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        states.append(to_numpy(state))
    return losses, states


@pytest.mark.parametrize("arch,name,n_layers", [
    ("stablelm_3b", "adamw-fast", None), ("gemma2_27b", "adamw", None),
    ("deepseek_moe_16b", "adamw-fast", None), ("stablelm_3b", "adafactor", 1),
    ("recurrentgemma_9b", "adafactor", None), ("stablelm_3b", "adafactor", None),
    ("gemma2_27b", "adafactor", None)])
def test_train_steps_match_reference(arch, name, n_layers):
    """The port's train step from the reference's weights: the first step's
    optimizer state equals the reference's (carried across by
    ``convert.lm_opt_state``), and three steps' losses agree.  Adafactor
    stacks each unit position's repeats as the reference does: stablelm at
    1 layer (one repeat), at 2 (two repeats of a unit of 1), gemma2 (two
    repeats of a unit of 2), recurrentgemma (one repeat of 3 and a tail of
    2, which stands alone)."""
    cfg = dataclasses.replace(f32(get_smoke_config(arch)), remat="none")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    tree = ref_params(cfg)
    want_losses, want_states = _ref_steps(cfg, tree, name, 3, seed=2)
    model = port_model(cfg, tree)
    _, opt = steps.choose_optimizer(cfg, name)
    step = steps.make_train_step(cfg, opt)
    state = opt.init(dict(model.named_parameters()))
    stream = SyntheticStream(DataConfig(cfg.vocab, S, B, seed=2))
    losses = []
    for i in range(3):
        model, state, metrics = step(model, state, stream.next_batch(i))
        losses.append(float(metrics["loss"]))
        assert set(metrics) == {"loss", "ce", "load_balance_loss", "grad_norm"}
        if i == 0:
            want = convert.lm_opt_state(want_states[0], cfg)
            assert int(state["step"]) == int(want["step"]) == 1
            got_flat, want_flat = store._flatten(state), store._flatten(want)
            assert set(got_flat) == set(want_flat)
            for k, w in want_flat.items():
                assert got_flat[k].shape == w.shape, k
                err = float((got_flat[k].double() - w.double()).abs().max())
                assert err <= F32_TOL * max(float(w.abs().max()), 1e-30), (k, err)
    np.testing.assert_allclose(losses, want_losses, rtol=STEP_LOSS_RTOL)


def test_lm_opt_state_rejects_a_mismatch():
    cfg = get_smoke_config("stablelm_3b")
    _, opt = ref_steps.choose_optimizer(cfg, "adamw")
    state = to_numpy(opt.init(ref_T.init_params(jax.random.PRNGKey(0), cfg)))
    state["m"]["final_norm"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="AdamW m"):
        convert.lm_opt_state(state, cfg)


# ------------------------------------------------ the loop (test_system twins)

def test_train_loop_loss_decreases():
    cfg = get_smoke_config("stablelm_3b")
    run = train.build_run(cfg, optimizer_name="adamw-fast", device="cpu")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8,
                                        structure=0.9))
    run, hist = train.train_loop(run, stream, 30, log_every=1000)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first, (first, last)


def test_train_restart_after_fault_resumes_from_checkpoint(tmp_path):
    cfg = get_smoke_config("musicgen_large")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    run = train.build_run(cfg, device="cpu")
    injector = FaultInjector({12})
    run, hist = train.train_loop(
        run, stream, 20, ckpt_dir=str(tmp_path),
        ft=FTConfig(checkpoint_every=5, max_restarts=2),
        injector=injector, log_every=1000,
    )
    assert run.step == 20
    steps_run = [h["step"] for h in hist]
    assert 12 in steps_run  # the failed step was re-executed after restore
    assert steps_run.count(10) == 2 and steps_run.count(9) == 1  # resumed at 10
    assert store.latest_step(str(tmp_path)) == 20


def test_train_cold_resume(tmp_path):
    """A fresh process (new TrainRun) must continue from the checkpoint."""
    cfg = get_smoke_config("llama3_2_3b")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    run1 = train.build_run(cfg, device="cpu")
    run1, _ = train.train_loop(run1, stream, 10, ckpt_dir=str(tmp_path),
                               ft=FTConfig(checkpoint_every=5), log_every=1000)
    want = copy.deepcopy(run1.params.state_dict())
    run2 = train.build_run(cfg, seed=123, device="cpu")  # different init — overwritten
    run2, hist2 = train.train_loop(run2, stream, 10, ckpt_dir=str(tmp_path),
                                   ft=FTConfig(checkpoint_every=5), log_every=1000)
    assert run2.step == 10 and hist2 == []
    for k, v in want.items():
        assert torch.equal(run2.params.state_dict()[k], v), k
    run2, hist2 = train.train_loop(run2, stream, 15, ckpt_dir=str(tmp_path),
                                   ft=FTConfig(checkpoint_every=5), log_every=1000)
    assert run2.step == 15
    assert hist2[0]["step"] == 10  # resumed, not restarted


def test_restart_budget_exhausted_raises(tmp_path):
    cfg = get_smoke_config("stablelm_3b")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2))
    run = train.build_run(cfg, device="cpu")
    injector = FaultInjector({1, 2})
    with pytest.raises(RuntimeError, match="budget exhausted"):
        train.train_loop(run, stream, 4, ft=FTConfig(max_restarts=1), injector=injector,
                         log_every=1000)


def _failing_update(opt, at_call: int):
    """``opt`` whose update at call ``at_call`` updates the first half of
    the tensors in place and then raises, as a CUDA out-of-memory error
    partway through the update would."""
    calls = [0]

    def update(grads, state, params):
        calls[0] += 1
        if calls[0] == at_call:
            opt.update(dict(list(grads.items())[: len(grads) // 2]), state, params)
            raise torch.OutOfMemoryError("injected partway through the update")
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)


@pytest.mark.parametrize("with_checkpoint", [False, True])
def test_train_loop_failure_inside_the_update(tmp_path, with_checkpoint):
    """A failure partway through the in-place update at step 2: with no
    checkpoint the loop raises (the moments and parameters are partly
    updated); with one it restores it, and the run ends with the weights of
    a run without the failure."""
    cfg = get_smoke_config("stablelm_3b")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2))
    run = train.build_run(cfg, "adamw-fast", device="cpu")
    _, opt = steps.choose_optimizer(cfg, "adamw-fast")
    run.step_fn = steps.make_train_step(cfg, _failing_update(opt, 3))
    if not with_checkpoint:
        with pytest.raises(steps.UpdateInterrupted, match="injected"):
            train.train_loop(run, stream, 4, log_every=1000)
        return
    run, hist = train.train_loop(run, stream, 4, ckpt_dir=str(tmp_path),
                                 ft=FTConfig(checkpoint_every=1), log_every=1000)
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    clean, _ = train.train_loop(train.build_run(cfg, "adamw-fast", device="cpu"), stream, 4,
                                log_every=1000)
    for k, v in clean.params.state_dict().items():
        assert torch.equal(run.params.state_dict()[k], v), k


def test_build_run_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("stablelm_3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.build_run(cfg)
    run = train.build_run(cfg, device="cpu")
    assert next(run.params.parameters()).device.type == "cpu"
    assert all(m.device.type == "cpu" for m in run.opt_state["m"].values())


def test_train_main_on_the_cpu(tmp_path, capsys):
    history = train.main(["--smoke", "--device", "cpu", "--steps", "12", "--seq-len", "16",
                          "--batch", "2", "--ckpt-dir", str(tmp_path),
                          "--inject-fault-at", "11"])
    assert [h["step"] for h in history] == list(range(11)) + [10, 11]
    text = capsys.readouterr().out
    assert "failure at step 11" in text and "done: step=12" in text
    assert store.latest_step(str(tmp_path)) == 12


def test_train_example_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", os.path.join(ROOT, "examples", "torch_train_lm.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    hist = example.main(["--device", "cpu", "--steps", "50", "--layers", "2",
                         "--d-model", "64", "--batch", "4", "--seq", "32", "--vocab", "512"])
    assert len(hist) == 50
    losses = [h["loss"] for h in hist]
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert "[example] loss" in capsys.readouterr().out
