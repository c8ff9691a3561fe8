"""What the compiled step (``launch/graphs.py``, a CUDA graph on the card)
needs of the port's step functions, checked on the CPU: the prefill, decode
and train steps read nothing back to the host, with and without a one-rank
gloo mesh (the guard sees DTensor's local ops too); the recurrent decode
states and the optimizer's step count are written in place; prefill into
reset caches equals prefill into fresh ones; a restore copies into the
run's own tensors; and a decode with a tensor position still gives the
reference engine's tokens.  The engine's graph plumbing (prefill captured
per prompt shape into the decode graph's caches, the static inputs, on a
mesh DTensors) runs on the CPU with a stand-in capture whose replay runs
the step again (``fake_graphs``); the graphs themselves are captured and
held against the eager steps on the card (``tests/test_torch_gpu.py``).
The CPU and gloo meshes stay eager.

Tolerances: tokens, ``data_ptr``s and step counts are compared exactly; a
restored CPU run is held to an uninterrupted one exactly (``torch.equal``:
the CPU's kernels are deterministic); decode logits with a tensor position
equal those with an int exactly (the same ops on the same values); so do
caches prefilled after a reset and fresh ones, and the stand-in graphs'
logits and the eager engine's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_lm import f32, inputs, to_numpy
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import serve as ref_serve
from repro.launch.mesh import make_host_mesh
from repro_torch import convert
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch import graphs, serve, steps, train
from repro_torch.launch.mesh import make_host_mesh as torch_host_mesh
from repro_torch.models import attention
from repro_torch.models import transformer as T
from test_torch_serve import DECODE_ARCHS

B, P, STEPS = 2, 10, 4  # a 10-token prompt and 4 steps pass gemma2's 8-slot window


class NoHostRead(TorchDispatchMode):
    """Fails on ``aten._local_scalar_dense``, the op behind every ``int()``,
    ``float()``, ``bool()`` and ``.item()`` of a tensor: on the card such a
    read would freeze a value into a captured graph or break the capture.
    An op on DTensors is handed to DTensor, whose ops on the local shards
    then come through here too."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("the step reads a tensor back to the host")
        return func(*args, **(kwargs or {}))


def test_the_guard_catches_a_host_read():
    with pytest.raises(AssertionError, match="host"), NoHostRead():
        int(torch.arange(3).sum())


@pytest.fixture
def gloo_mesh():
    """A 1×1 mesh on a gloo group of one rank in this process, taken down
    afterwards (a process has one default group)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield torch_host_mesh(device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def test_the_guard_catches_a_host_read_of_a_dtensor(gloo_mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    x = distribute_tensor(torch.arange(6.0), gloo_mesh, [Replicate(), Replicate()])
    with NoHostRead():
        y = (x * 2).sum()
    with pytest.raises(AssertionError, match="host"), NoHostRead():
        float(y)


def _decode_case(arch: str, changes: dict):
    cfg = dataclasses.replace(f32(get_smoke_config(arch)), **changes)
    model = T.init_params(cfg, 0, "cpu")
    tokens, cross = inputs(cfg, B, P + STEPS, seed=1)
    tokens = torch.from_numpy(tokens)
    cross = None if cross is None else torch.from_numpy(cross)
    return cfg, model, tokens, cross


@pytest.mark.parametrize("arch,changes", [pytest.param(a, {}, id=a) for a in ARCHS] + [
    pytest.param("musicgen_large", {"opt_kv_quant": True}, id="musicgen_large-int8_kv")])
def test_decode_step_reads_nothing_back(arch, changes):
    """Every smoke arch (SSM, RG-LRU and MoE among them; gemma2's local rings
    wrap; musicgen once more with int8 KV) decodes ``STEPS`` teacher-forced
    tokens with a 0-d int32 position under the guard, and its logits equal
    those of the same steps given an int."""
    cfg, model, tokens, cross = _decode_case(arch, changes)
    runs = []
    for as_tensor in (True, False):
        caches = T.init_caches(cfg, B, P + STEPS, "cpu")
        _, caches = T.prefill(model, tokens[:, :P], cfg, caches, cross_embeds=cross)
        out = []
        for i in range(STEPS):
            pos = torch.tensor(P + i, dtype=torch.int32) if as_tensor else P + i
            with NoHostRead() if as_tensor else torch.no_grad():
                logits, caches = T.decode_step(model, tokens[:, P + i:P + i + 1], pos, cfg,
                                               caches, cross_embeds=cross)
            out.append(logits)
        runs.append(torch.stack(out))
    assert torch.equal(runs[0], runs[1])
    if "local" in cfg.layer_kinds():
        local = caches[cfg.layer_kinds().index("local")]
        assert local["k"].shape[1] == cfg.window < P + STEPS


def _train_batch(cfg, seed: int = 0) -> dict:
    batch = SyntheticStream(DataConfig(cfg.vocab, 8, 2, seed=seed)).next_batch(0)
    if cfg.family == "vlm":
        batch["cross_embeds"] = torch.randn((2, cfg.cross_kv_len, cfg.d_model),
                                            generator=torch.Generator().manual_seed(seed))
    return batch


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_reads_nothing_back(arch, optimizer):
    """One whole train step (forward under the arch's remat, backward,
    clipping, the update) of every smoke arch under the guard; the step
    count is counted up in place."""
    cfg = get_smoke_config(arch)
    run = train.build_run(cfg, optimizer, device="cpu")
    count = run.opt_state["step"]
    with NoHostRead():
        _, run.opt_state, metrics = run.step_fn(run.params, run.opt_state, _train_batch(cfg))
    assert run.opt_state["step"] is count and int(count) == 1
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_tensor_position_decode_gives_the_reference_engines_tokens(arch):
    """The reference engine's greedy tokens (``tests/test_torch_serve.py``'s
    six archs, its weights carried across), from the port's step functions
    driven as the reference drives its jitted steps: the position a 0-d
    int32 tensor, the decode step under the guard."""
    cfg = f32(get_smoke_config(arch))
    ref_engine = ref_serve.ServeEngine.build(f32(ref_smoke(arch)), make_host_mesh(),
                                             max_seq=P + 6)
    engine = serve.ServeEngine.build(cfg, P + 6, device="cpu")
    engine.params.load_state_dict(convert.lm_params(to_numpy(ref_engine.params), engine.cfg))
    prompts, cross = inputs(cfg, B, P, seed=1)
    want = ref_engine.generate(prompts, 6, temperature=0.0, cross_embeds=None
                               if cross is None else jnp.asarray(cross))
    cross = None if cross is None else torch.from_numpy(cross)
    caches = T.init_caches(engine.cfg, B, P + 6, "cpu")
    logits, caches = engine.prefill_fn(engine.params, torch.from_numpy(prompts).long(), caches,
                                       cross)
    out = [logits.argmax(-1, keepdim=True)]
    for i in range(5):
        with NoHostRead():
            logits, caches = engine.decode_fn(engine.params, out[-1],
                                              torch.tensor(P + i, dtype=torch.int32), caches,
                                              cross)
        out.append(logits.argmax(-1, keepdim=True))
    np.testing.assert_array_equal(torch.cat(out, dim=1).numpy(), want[:, P:])


@pytest.mark.parametrize("arch", ["mamba2_780m", "recurrentgemma_9b"])
def test_recurrent_states_are_written_in_place(arch):
    """Prefill and each decode step leave the SSM's or RG-LRU's new ``conv``
    and ``h`` in the cache tensors they were given: the same objects at the
    same ``data_ptr``, holding new values."""
    cfg, model, tokens, cross = _decode_case(arch, {})
    caches = T.init_caches(cfg, B, P + STEPS, "cpu")
    states = [(i, c) for i, c in enumerate(caches) if "h" in c]
    assert states
    held = [(c["conv"], c["h"], c["conv"].data_ptr(), c["h"].data_ptr()) for _, c in states]
    _, new = T.prefill(model, tokens[:, :P], cfg, caches)
    for i in range(STEPS + 1):
        for (j, _), (conv, h, p_conv, p_h) in zip(states, held):
            assert new[j]["conv"] is conv and new[j]["h"] is h
            assert conv.data_ptr() == p_conv and h.data_ptr() == p_h
        if i == STEPS:
            break
        before = [h.clone() for _, h, _, _ in held]
        _, new = T.decode_step(model, tokens[:, P + i:P + i + 1], P + i, cfg, new)
        assert all(not torch.equal(h, h0) for (_, h, _, _), h0 in zip(held, before))


def test_reset_caches_gives_fresh_caches():
    cfg, model, tokens, _ = _decode_case("recurrentgemma_9b", {})
    caches = T.init_caches(cfg, B, P, "cpu")
    T.prefill(model, tokens[:, :P], cfg, caches)
    T.reset_caches(caches)
    for got, want in zip(caches, T.init_caches(cfg, B, P, "cpu")):
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for _, v in sorted(tree.items()) for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_restore_copies_into_the_runs_tensors(tmp_path, optimizer):
    """``train_loop`` with a fault at step 5 restores the step-4 checkpoint
    into the run's own parameter and optimizer-state tensors (a captured
    step goes on updating those): every one keeps its ``data_ptr``, and the
    run ends exactly where an uninterrupted run ends."""
    from repro_torch.runtime.fault_tolerance import FTConfig, FaultInjector

    cfg = get_smoke_config("gemma2_27b")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2))
    ends = []
    for name, injector in (("faulted", FaultInjector({5})), ("clean", None)):
        run = train.build_run(cfg, optimizer, device="cpu")
        ptrs = [t.data_ptr() for t in (*run.params.parameters(), *_leaves(run.opt_state))]
        run, hist = train.train_loop(run, stream, 7, ckpt_dir=str(tmp_path / name),
                                     ft=FTConfig(checkpoint_every=2), injector=injector,
                                     log_every=1000)
        assert [t.data_ptr() for t in (*run.params.parameters(),
                                       *_leaves(run.opt_state))] == ptrs
        ends.append((run, [h["step"] for h in hist]))
    (faulted, steps_f), (clean, steps_c) = ends
    assert steps_f == [0, 1, 2, 3, 4, 4, 5, 6] and steps_c == list(range(7))
    assert int(faulted.opt_state["step"]) == int(clean.opt_state["step"]) == 7
    for a, b in zip(_leaves(faulted.opt_state), _leaves(clean.opt_state)):
        assert torch.equal(a, b)
    for k, v in clean.params.state_dict().items():
        assert torch.equal(faulted.params.state_dict()[k], v), k


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_step_count_lives_on_the_parameters_device(optimizer):
    """``opt_state_shapes`` on ``meta`` parameters gives a ``meta`` step
    count, and ``build_run`` on the CPU a CPU one: the count follows the
    parameters (on the card it is counted on the card)."""
    cfg = get_smoke_config("stablelm_3b")
    _, opt = steps.choose_optimizer(cfg, optimizer)
    shapes = steps.opt_state_shapes(opt, steps.param_shapes(cfg))
    assert shapes["step"].device.type == "meta" and shapes["step"].dtype == torch.int32
    assert shapes["step"].shape == ()
    run = train.build_run(cfg, optimizer, device="cpu")
    assert run.opt_state["step"].device.type == "cpu"


def test_cpu_steps_run_eagerly_with_widened_products():
    """Nothing is captured on the CPU: the engine decodes eagerly, the run's
    step is the plain train step, and bf16 attention operands are widened
    (the card's bf16 products are for CUDA tensors only)."""
    cfg = get_smoke_config("stablelm_3b")
    engine = serve.ServeEngine.build(cfg, 16, device="cpu")
    assert not engine.compiled
    engine.generate(np.zeros((1, 4), np.int32), 2, temperature=0.0)
    assert engine.graphs == {}
    run = train.build_run(cfg, device="cpu")
    assert run.step_fn.__name__ == "train_step"
    x = torch.zeros((1, 2, 3), dtype=torch.bfloat16)
    assert not attention._tensor_cores(x, x)


# ------------------------------------------------------------ prefill, captured

DECODE_CASES = [pytest.param(a, {}, id=a) for a in ARCHS] + [
    pytest.param("musicgen_large", {"opt_kv_quant": True}, id="musicgen_large-int8_kv")]


@pytest.mark.parametrize("arch,changes", DECODE_CASES)
def test_prefill_step_reads_nothing_back(arch, changes):
    """Prefill of every smoke arch (musicgen once more with int8 KV) under
    the guard: its ``P`` = 10 tokens pass gemma2's 8-slot window, so the
    ring wraps.  Its logits and caches equal those of the same prefill
    outside the guard."""
    cfg, model, tokens, cross = _decode_case(arch, changes)
    runs = []
    for guard in (NoHostRead, torch.no_grad):
        caches = T.init_caches(cfg, B, P + STEPS, "cpu")
        with guard():
            logits, caches = T.prefill(model, tokens[:, :P], cfg, caches, cross_embeds=cross)
        runs.append((logits, caches))
    (got, got_caches), (want, want_caches) = runs
    assert torch.equal(got, want)
    for a, b in zip(got_caches, want_caches):
        assert all(torch.equal(a[k], b[k]) for k in b)
    if "local" in cfg.layer_kinds():
        ring = got_caches[cfg.layer_kinds().index("local")]
        assert ring["k"].shape[1] == cfg.window < P
        assert sorted(ring["pos"].tolist()) == list(range(P - cfg.window, P))


@pytest.mark.parametrize("arch,changes", DECODE_CASES)
def test_prefill_into_reset_caches_equals_fresh(arch, changes):
    """Caches that took another prompt's prefill and two decode steps, then
    ``reset_caches``, take a prefill exactly as fresh caches do, entry by
    entry: the captured prefill writes into the decode graph's caches after
    such a reset."""
    cfg, model, tokens, cross = _decode_case(arch, changes)
    used = T.init_caches(cfg, B, P + STEPS, "cpu")
    _, used = T.prefill(model, tokens[:, STEPS:STEPS + P], cfg, used, cross_embeds=cross)
    for i in range(2):
        _, used = T.decode_step(model, tokens[:, i:i + 1], P + i, cfg, used, cross_embeds=cross)
    got, got_caches = T.prefill(model, tokens[:, :P], cfg, T.reset_caches(used),
                                cross_embeds=cross)
    want, want_caches = T.prefill(model, tokens[:, :P], cfg, T.init_caches(cfg, B, P + STEPS,
                                                                           "cpu"),
                                  cross_embeds=cross)
    assert torch.equal(got, want)
    for a, b in zip(got_caches, want_caches):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in b)


def _guarded(step):
    with NoHostRead():
        return step()


class _Replay:
    """A captured step's stand-in on the CPU: a replay runs the step again,
    under the guard, and writes its output into the tensors the capture
    returned."""

    def __init__(self, step, out):
        self.step, self.out = step, out

    def replay(self):
        for old, new in zip(graphs._leaves(self.out), graphs._leaves(_guarded(self.step))):
            if isinstance(old, torch.Tensor) and old is not new:
                old.copy_(new)


@pytest.fixture
def fake_graphs(monkeypatch):
    """The compiled paths on the CPU: an engine with ``compile`` on replays
    its steps, each capture is a ``_Replay`` (the warm-up runs the step,
    the capture runs it once more), every run of a step that the card
    would capture is under the guard (the host work around it, such as
    copying an input into the static buffers, is not), and the card's
    stream calls do nothing."""
    def capture(step, pool=None):
        out = _guarded(step)
        return _Replay(step, out), out

    monkeypatch.setattr(graphs, "_warm", _guarded)
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(serve.ServeEngine, "compiled", property(lambda self: self.compile))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"synchronize": lambda self: None})())


def _cross_key(cross):
    return None if cross is None else (tuple(cross.shape), cross.dtype)


@pytest.mark.parametrize("arch,changes", DECODE_CASES)
def test_compiled_generate_replays_prefill_into_the_decode_caches(fake_graphs, arch, changes):
    """``generate``'s compiled path with stand-in graphs: prefill captured
    for the prompt shape writes into the caches of the decode graph for the
    batch (the ring wraps), both read one ``cross`` buffer, and decode goes
    on from there; tokens and every step's logits equal the eager engine's
    exactly, and the engine holds one graph of each kind."""
    cfg, model, tokens, cross = _decode_case(arch, changes)
    prompts = tokens[:, :P].numpy()
    runs = []
    for compile in (True, False):
        engine = serve.ServeEngine(cfg, model, P + STEPS, torch.device("cpu"), compile=compile)
        runs.append(engine.generate(prompts, STEPS + 1, temperature=0.0, return_logits=True,
                                    cross_embeds=None if cross is None else cross.numpy()))
        if compile:
            assert set(engine.graphs) == {("decode", B, _cross_key(cross)),
                                          ("prefill", B, P, _cross_key(cross))}
            decode = engine.graphs[("decode", B, _cross_key(cross))]
            assert engine.graphs[("prefill", B, P, _cross_key(cross))].logits.shape == (
                B, cfg.vocab)
        else:
            assert engine.graphs == {}
    (got, got_logits), (want, want_logits) = runs
    np.testing.assert_array_equal(got, want)
    assert all(torch.equal(g, w) for g, w in zip(got_logits, want_logits, strict=True))
    if cross is not None:
        assert torch.equal(decode.cross, cross)


def test_one_compiled_engine_serves_shapes_in_turn_like_fresh_engines(fake_graphs):
    """One engine (stand-in graphs) alternating two prompt lengths and two
    batch sizes gives, request by request, the tokens of a fresh eager
    engine: a prefill graph for each (batch, prompt length), a decode graph
    for each batch, nothing carried from one request to the next."""
    cfg = f32(get_smoke_config("gemma2_27b"))
    model = T.init_params(cfg, 1, "cpu")
    rng = np.random.default_rng(9)
    shapes = [(2, 10), (3, 5), (2, 5), (3, 10), (2, 10)]
    engine = serve.ServeEngine(cfg, model, 16, torch.device("cpu"))
    for shape in shapes:
        prompts = rng.integers(0, cfg.vocab, shape).astype(np.int32)
        fresh = serve.ServeEngine(cfg, model, 16, torch.device("cpu"), compile=False)
        np.testing.assert_array_equal(engine.generate(prompts, 5, temperature=0.0),
                                      fresh.generate(prompts, 5, temperature=0.0))
    assert sorted(engine.graphs) == [("decode", 2, None), ("decode", 3, None),
                                     ("prefill", 2, 5, None), ("prefill", 2, 10, None),
                                     ("prefill", 3, 5, None), ("prefill", 3, 10, None)]


# --------------------------------------------------------------- on a mesh

@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_read_nothing_back(fake_graphs, gloo_mesh, arch):
    """On the one-rank gloo mesh, what the card captures, under the guard
    (``fake_graphs``): the engine's prefill and decode steps (on static
    DTensor tokens, caches and patch embeddings, each call's input copied
    into this rank's shard, the logits gathered whole in the step; the ring
    wraps) and the compiled train step (its eager first step, the capture
    and a replay); the tokens equal the meshless eager engine's."""
    cfg = f32(get_smoke_config(arch))
    prompts, cross = inputs(cfg, B, P, seed=1)
    engine = serve.ServeEngine.build(cfg, P + STEPS, device="cpu", mesh=gloo_mesh)
    got = engine.generate(prompts, STEPS, temperature=0.0, cross_embeds=cross)
    meshless = serve.ServeEngine.build(cfg, P + STEPS, device="cpu", compile=False)
    np.testing.assert_array_equal(got, meshless.generate(prompts, STEPS, temperature=0.0,
                                                         cross_embeds=cross))
    decode = engine.graphs[("decode", B, _cross_key(None if cross is None
                                                    else torch.from_numpy(cross)))]
    assert isinstance(decode.tokens, DTensor)
    assert all(isinstance(t, DTensor) for c in decode.caches for t in c.values())

    run = train.build_run(cfg, "adamw", device="cpu", mesh=gloo_mesh)
    step = graphs.GraphedTrainStep(run.step_fn, gloo_mesh)  # the card's compiled mesh step
    for i in range(2):
        _, run.opt_state, metrics = step(run.params, run.opt_state, _train_batch(cfg, seed=i))
        assert not isinstance(metrics["loss"], DTensor) and np.isfinite(float(metrics["loss"]))
    assert all(isinstance(v, DTensor) for v in step.batch.values())


@pytest.mark.parametrize("on_mesh", [False, True], ids=["meshless", "mesh"])
def test_captured_train_step_refuses_other_tensors(fake_graphs, gloo_mesh, tmp_path, on_mesh):
    """The compiled train step (stand-in capture) replays only on the
    parameters and optimizer state it was captured on: parameters restored
    by ``restore_onto_mesh`` and assigned in their place, or a parameter's
    values moved to another tensor, are refused (``ValueError``), never
    replayed on; values copied into them (``_restore``) are taken."""
    from repro_torch.checkpoint import store
    from repro_torch.runtime import elastic

    cfg = get_smoke_config("stablelm_3b")
    mesh = gloo_mesh if on_mesh else None
    run = train.build_run(cfg, "adamw", device="cpu", mesh=mesh)
    step = graphs.GraphedTrainStep(run.step_fn, mesh)  # the card's compiled step
    batch = _train_batch(cfg)
    step(run.params, run.opt_state, batch)
    run.step = 1
    store.save(train._state(run), str(tmp_path), 1)
    train._restore(run, str(tmp_path), 1)
    step(run.params, run.opt_state, batch)
    if on_mesh:
        state = elastic.restore_onto_mesh(str(tmp_path), 1, {"params": run.params.state_dict()},
                                          mesh, cfg)
        run.params.load_state_dict(state["params"], assign=True)
    else:
        p = next(run.params.parameters())
        p.data = p.data.clone()
    with pytest.raises(ValueError, match="captured on"):
        step(run.params, run.opt_state, batch)


def test_cpu_and_gloo_meshes_stay_eager(gloo_mesh):
    """With no card nothing is captured, on a gloo mesh as without one: the
    engine runs its steps eagerly and keeps no graph, and ``build_run``'s
    step is the eager sharded step."""
    cfg = get_smoke_config("stablelm_3b")
    for mesh in (None, gloo_mesh):
        engine = serve.ServeEngine.build(cfg, 16, device="cpu", mesh=mesh)
        assert engine.compile and not engine.compiled
        engine.generate(np.zeros((1, 4), np.int32), 2, temperature=0.0)
        assert engine.graphs == {} and engine.pool is None
        run = train.build_run(cfg, device="cpu", mesh=mesh)
        assert not isinstance(run.step_fn, graphs.GraphedTrainStep)
        assert run.step_fn.__name__ == ("step" if mesh else "train_step")
