"""Each CUDA kernel against its plain PyTorch version on the card, at small
and at odd widths, and the main path end to end.  Needs a CUDA device and
``nvcc``; every test skips without a card (decided in the fixture, so all
workers collect the same tests).  Where JAX is not installed, skip the
conftest (it imports jax); these tests need only torch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.pim as pim
from repro_torch.core import ir
from repro_torch.kernels import ops, pim_bitserial, pim_matmul

pytestmark = pytest.mark.gpu

MAC = lambda a, b, c: a * b + c  # noqa: E731


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planes(n: int, words: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, (n, words), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


@pytest.mark.parametrize("words", [1, 77, 256, 1000, 3000])
@pytest.mark.parametrize("program,basis,mode", [
    ("f32", "memristive", "loop"), ("f32", "dram", "loop"),
    ("int8", "memristive", "unrolled"), ("int8", "dram", "unrolled"),
    ("f32", "dram", "unrolled"),
])
def test_kernel_matches_plain_version(cuda, program, basis, mode, words):
    compiled = pim.compile(MAC, dtype=getattr(pim, program)).compiled(basis)
    key = pim_bitserial.register_compiled(compiled)
    planes = _planes(len(compiled.input_slots), words, seed=words, device=cuda)
    name = "bitserial_loop" if mode == "loop" else "bitserial_unrolled"
    before = pim_bitserial.LAUNCHES[name]
    got = pim_bitserial.run_schedule(key, planes, mode=mode)
    torch.cuda.synchronize()
    assert pim_bitserial.LAUNCHES[name] > before
    if mode == "loop":
        want = pim_bitserial.loop_plain(compiled, planes)
    else:
        want = pim_bitserial.unrolled_plain(compiled, planes)
    assert got.shape == (len(compiled.output_slots), words)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_gates", [0, 3])
def test_loop_kernel_on_short_schedules(cuda, n_gates):
    """No gates (an empty table: the kernel fetches no stage) and three gates
    (one padded stage), forced onto the loop kernel."""
    full = ir.compile_op("fixed_add", 8)
    compiled = dataclasses.replace(full, key=f"fixed_add8_first{n_gates}",
                                   ops=full.ops[:n_gates])
    key = pim_bitserial.register_compiled(compiled)
    planes = _planes(len(compiled.input_slots), 300, seed=n_gates, device=cuda)
    before = pim_bitserial.LAUNCHES["bitserial_loop"]
    got = pim_bitserial.run_schedule(key, planes, mode="loop")
    torch.cuda.synchronize()
    assert pim_bitserial.LAUNCHES["bitserial_loop"] == before + 1
    assert torch.equal(got, pim_bitserial.loop_plain(compiled, planes))


def test_loop_kernel_stages_unread_and_unwritten_columns(cuda):
    """A table whose last stage stages an input the schedule returns unread
    (copied while the last stage runs), whose other inputs are neither read
    nor returned, and one of whose outputs is a column never written (the
    zero column), on the loop kernel at a width that leaves part of a block
    idle."""
    from _torch_ref import schedule_fields

    from repro_torch import convert
    from repro_torch.core.machine import OP_INIT1

    fields = schedule_fields(ir.compile_op("fixed_add", 8))
    n = fields["num_cols"]
    compiled = convert.compiled_from_numpy(dict(
        fields, key="loop_unread_unwritten", ops=[(OP_INIT1, 0, 0, 0, n - 1)] * 300,
        input_cols={"a": [0], "b": [1], "c": [2]},
        output_cols={"b": [1], "never": [3], "ones": [n - 1]}))
    key = pim_bitserial.register_compiled(compiled)
    planes = _planes(3, 700, seed=5, device=cuda)
    got = pim_bitserial.run_schedule(key, planes, mode="loop")
    torch.cuda.synchronize()
    assert torch.equal(got, pim_bitserial.loop_plain(compiled, planes))
    assert torch.equal(got[0], planes[1]) and not got[1].any() and (got[2] == -1).all()


def test_fixed_add_wrapper_on_card(cuda):
    rng = np.random.default_rng(0)
    a, b = (rng.integers(-2**31, 2**31, 5000).astype(np.int32) for _ in range(2))
    before = pim_bitserial.LAUNCHES["bitserial_unrolled"]
    got = ops.pim_fixed_add(a, b, nbits=32)
    assert got.device.type == "cuda"
    assert pim_bitserial.LAUNCHES["bitserial_unrolled"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), a + b)


def test_f32_mac_main_path_on_card(cuda):
    rng = np.random.default_rng(1)
    x, y, z = (rng.standard_normal(10_001).astype(np.float32) for _ in range(3))
    mac = pim.compile(MAC, dtype=pim.f32)
    before = pim_bitserial.LAUNCHES["bitserial_loop"]
    got = mac(*(torch.from_numpy(v).to(cuda) for v in (x, y, z)), basis="dram")
    assert pim_bitserial.LAUNCHES["bitserial_loop"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  ((x * y) + z).view(np.uint32))


MATMUL_SHAPES = [(1, 128, 128, 128), (2, 256, 384, 512), (3, 128, 256, 128),
                 (1, 33, 17, 65), (1, 512, 512, 512), (4, 32, 32, 32), (2, 17, 100, 9)]
MATMUL_CASES = ([(s, d) for s in MATMUL_SHAPES for d in (torch.float32, torch.bfloat16)]
                + [((70000, 16, 16, 16), torch.float32)])
MATMUL_TOL = {torch.float32: (2e-4, 1.6e-3), torch.bfloat16: (2e-2, 0.16)}
# One small case per kernel variant (G not a multiple of a block's entries
# or of the grid), and the ragged shapes.
VARIANT_CASES = [
    ((37, 16, 16, 16), torch.float32, "f32_small"),
    ((301, 32, 32, 32), torch.float32, "f32_small"),
    ((50, 64, 64, 64), torch.float32, "f32_small"),
    ((3, 128, 256, 384), torch.float32, "f32_simt128"),
    ((37, 16, 16, 16), torch.bfloat16, "bf16_mma"),
    ((301, 32, 32, 32), torch.bfloat16, "bf16_mma"),
    ((50, 64, 64, 64), torch.bfloat16, "bf16_wgmma64"),
    ((3, 64, 128, 256), torch.bfloat16, "bf16_wgmma64"),
    ((3, 128, 256, 384), torch.bfloat16, "bf16_wgmma128"),
    ((1, 33, 17, 65), torch.float32, "general"),
    ((1, 33, 17, 65), torch.bfloat16, "general"),
    ((2, 256, 384, 512), torch.float32, "f32_simt128"),
    ((2, 256, 384, 512), torch.bfloat16, "bf16_wgmma128"),
]


def _matmul_on_card(cuda, shape, dtype):
    G, M, K, N = shape
    rng = np.random.default_rng(G + M + K + N)
    a = torch.from_numpy(rng.standard_normal((G, M, K)).astype(np.float32)).to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal((G, K, N)).astype(np.float32)).to(cuda, dtype)
    variant = pim_matmul.plan(G, M, K, N, dtype)
    before = dict(pim_matmul.LAUNCHES)
    got = ops.pim_matmul_op(a, b)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in pim_matmul.LAUNCHES.items() if v != before[k]}
    assert launched == {variant: 1}
    assert got.shape == (G, M, N) and got.dtype == dtype and got.device.type == "cuda"
    want = pim_matmul.matmul_plain(a, b)
    rtol, atol = MATMUL_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    return variant


@pytest.mark.parametrize("shape,dtype", MATMUL_CASES)
def test_matmul_kernel_matches_plain_version(cuda, shape, dtype):
    """The matmul kernel against its plain version: the reference's shape
    sweep, ragged dims, the largest Fig 5 size and G above the 65 535
    grid-dimension limit, each on the variant ``plan`` names."""
    _matmul_on_card(cuda, shape, dtype)


@pytest.mark.parametrize("shape,dtype,variant", VARIANT_CASES)
def test_matmul_variant_matches_plain_version(cuda, shape, dtype, variant):
    assert _matmul_on_card(cuda, shape, dtype) == variant


@pytest.mark.parametrize("shape,dtype", [((64, 128, 128, 128), torch.float32),
                                         ((64, 128, 128, 128), torch.bfloat16),
                                         ((4096, 16, 16, 16), torch.bfloat16)])
def test_matmul_general_variant_when_named(cuda, shape, dtype):
    """``general`` (the first, untiled kernel, which ``chip_smoke.py`` times
    beside the others) runs any accepted shape when launched by name; a
    variant that does not take the shape raises."""
    G, M, K, N = shape
    rng = np.random.default_rng(M + G)
    a = torch.from_numpy(rng.standard_normal((G, M, K)).astype(np.float32)).to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal((G, K, N)).astype(np.float32)).to(cuda, dtype)
    before = pim_matmul.LAUNCHES["general"]
    got = pim_matmul._launch(a, b, "general")
    torch.cuda.synchronize()
    assert pim_matmul.LAUNCHES["general"] == before + 1
    rtol, atol = MATMUL_TOL[dtype]
    torch.testing.assert_close(got.float(), pim_matmul.matmul_plain(a, b).float(),
                               rtol=rtol, atol=atol)
    with pytest.raises(RuntimeError, match="bf16_mma launch"):
        pim_matmul._launch(a.float(), b.float(), "bf16_mma")


def test_fig5_benchmark_on_card(cuda):
    """The Fig 5 benchmark runs on the card by default and times the matmul
    kernel (one warm-up and two timed launches)."""
    from benchmarks import torch_fig5_matmul

    before = pim_matmul.LAUNCHES["f32_simt128"]
    rows = torch_fig5_matmul.run()
    assert pim_matmul.LAUNCHES["f32_simt128"] == before + 3
    assert [r["name"] for r in rows] == [f"fig5/matmul_n{n}"
                                         for n in torch_fig5_matmul.SIZES]
    assert float(rows[3]["us_per_call"]) > 0


@pytest.mark.parametrize("name,batch,img,train", [
    ("alexnet", 1, 224, False), ("googlenet", 2, 64, False),
    ("resnet50", 2, 64, False), ("resnet50", 2, 96, True)])
def test_cnn_logits_on_card_match_float64(cuda, name, batch, img, train):
    """The CNN in float32 on the card, TF32 off in cuBLAS and cuDNN, against
    the same parameters in float64 on the CPU: max-abs error at most 1e-4
    of the largest logit (a bound TF32's 10-bit products would break)."""
    import copy

    from benchmarks.torch_fig6_cnn_infer import full_precision
    from repro_torch.models import cnn

    model = cnn.MODELS[name](device="cpu").train(train)
    ref_model = copy.deepcopy(model).double()
    x = torch.randn((batch, 3, img, img), generator=torch.Generator().manual_seed(7))
    with torch.no_grad(), full_precision():
        want = ref_model(x.double())
        got = model.to(cuda)(x.to(cuda)).double().cpu()
    assert got.shape == want.shape == (batch, 1000)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["gemma2_27b", "recurrentgemma_9b", "deepseek_moe_16b"])
def test_serve_on_card_matches_cpu(cuda, arch):
    """A smoke LM in float32 (TF32 off) served by the engine's loop: prefill
    12 tokens at batch 2 and 4 greedy decode steps on the card against the
    same weights on the CPU, logits within 1e-4 of the largest, greedy
    tokens equal; then the serving engine on its default device (the card)
    generates the same tokens twice."""
    import copy
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import transformer as lm

    from benchmarks.torch_fig6_cnn_infer import full_precision

    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    model = lm.init_params(cfg, 0, "cpu")
    card = copy.deepcopy(model).to(cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(3))
    prompts = tokens.numpy().astype(np.int32)
    runs = []
    with full_precision():
        for m, dev in ((model, torch.device("cpu")), (card, cuda)):
            out, logits = ServeEngine(cfg, m, 16, dev).generate(
                prompts, 5, temperature=0.0, return_logits=True)
            runs.append(([lg.double().cpu() for lg in logits], out))
    (want, want_tok), (got, got_tok) = runs
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert np.array_equal(got_tok, want_tok)
    engine = ServeEngine.build(cfg, 20)
    assert engine.device.type == "cuda"
    a = engine.generate(prompts, 8, temperature=0.0)
    assert np.array_equal(a, engine.generate(prompts, 8, temperature=0.0))
    assert np.array_equal(a[:, :12], prompts)


@pytest.mark.parametrize("arch", ["stablelm_3b", "mamba2_780m", "deepseek_moe_16b"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """A smoke LM in float32 (TF32 off): the loss and every gradient of one
    batch on the card against the same weights on the CPU (loss within
    1e-5 relative, each gradient within 1e-4 of its largest), then one
    AdamW train step on each (loss and gradient norm within 1e-5), and the
    next batch's loss after it within 1e-4 (Adam turns a tiny gradient
    difference on a near-zero gradient into an lr-sized update)."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.launch import steps
    from repro_torch.models import transformer as lm

    from benchmarks.torch_fig6_cnn_infer import full_precision

    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                              compute_dtype="float32")
    model = lm.init_params(cfg, 0, "cpu")
    card = copy.deepcopy(model).to(cuda)
    stream = SyntheticStream(DataConfig(cfg.vocab, 16, 2, seed=3))
    runs = []
    with full_precision():
        for m, dev in ((model, torch.device("cpu")), (card, cuda)):
            batches = [{k: v.to(dev) for k, v in stream.next_batch(i).items()} for i in (0, 1)]
            loss, _, grads = steps.loss_and_grads(m, batches[0], cfg)
            _, opt = steps.choose_optimizer(cfg, "adamw-fast")
            step = steps.make_train_step(cfg, opt)
            _, state, metrics = step(m, opt.init(dict(m.named_parameters())), batches[0])
            after, _, _ = steps.loss_and_grads(m, batches[1], cfg)
            runs.append((float(loss), {k: g.cpu() for k, g in grads.items()},
                         {k: float(v) for k, v in metrics.items()}, float(after)))
    (want, want_g, want_m, want_after), (got, got_g, got_m, got_after) = runs
    assert abs(got - want) <= 1e-5 * abs(want)
    for k, w in want_g.items():
        assert float((got_g[k] - w).abs().max()) <= 1e-4 * float(w.abs().max()), k
    for k in ("loss", "grad_norm"):
        assert abs(got_m[k] - want_m[k]) <= 1e-5 * abs(want_m[k]), k
    assert abs(got_after - want_after) <= 1e-4 * abs(want_after)


# ------------------------------------------------ the compiled (graphed) step
#
# A replayed CUDA graph launches the kernels the eager step launched at
# capture, so graphed and eager are held to each other exactly: tokens
# equal, float32 logits, losses and parameters within GRAPH_TOL of their
# largest (cuBLAS may pick another algorithm under capture, which moves the
# last bit).  TF32 off throughout.

GRAPH_TOL = 1e-6
GRAPH_ARCHS = ["llama_3_2_vision_11b", "deepseek_moe_16b", "grok_1_314b", "stablelm_3b",
               "llama3_2_3b", "gemma2_27b", "qwen2_5_14b", "mamba2_780m", "musicgen_large",
               "recurrentgemma_9b"]


def _f32_smoke(arch: str, **changes):
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                               compute_dtype="float32", **changes)


def _close(got: torch.Tensor, want: torch.Tensor, tol: float = GRAPH_TOL) -> bool:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max()) <= tol * max(float(want.abs().max()), 1e-30)


def _eager_greedy(model, cfg, prompts, cross, steps: int, dev):
    """Prefill then ``steps`` greedy decode steps through the eager step
    functions → (logits list, tokens [B, steps + 1])."""
    from repro_torch.launch import steps as lm_steps
    from repro_torch.models import transformer as lm

    B, P = prompts.shape
    caches = lm.init_caches(cfg, B, P + steps, dev)
    cross = None if cross is None else cross.to(dev)
    logits, caches = lm_steps.make_prefill_step(cfg)(model, prompts.to(dev), caches, cross)
    decode = lm_steps.make_decode_step(cfg)
    seen, toks = [logits.clone()], [logits.argmax(-1, keepdim=True)]
    for i in range(steps):
        logits, caches = decode(model, toks[-1], P + i, caches, cross)
        seen.append(logits.clone())
        toks.append(logits.argmax(-1, keepdim=True))
    return seen, torch.cat(toks, dim=1).cpu()


@pytest.mark.parametrize("arch,changes", [pytest.param(a, {}, id=a) for a in GRAPH_ARCHS] + [
    pytest.param("musicgen_large", {"opt_kv_quant": True}, id="musicgen_large-int8_kv")])
def test_graphed_decode_matches_eager(cuda, arch, changes):
    """``ServeEngine.generate`` on the card replays the captured decode
    step; it gives the eager step functions' tokens and logits on the same
    weights.  12 prompt tokens and 5 steps pass gemma2's 8-slot local
    window, so its rings wrap."""
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import transformer as lm

    from benchmarks.torch_fig6_cnn_infer import full_precision

    cfg = _f32_smoke(arch, **changes)
    model = lm.init_params(cfg, 0, cuda)
    gen = torch.Generator().manual_seed(5)
    prompts = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    cross = (torch.randn((2, cfg.cross_kv_len, cfg.d_model), generator=gen)
             if cfg.family == "vlm" else None)
    with full_precision():
        want, want_tok = _eager_greedy(model, cfg, prompts, cross, 5, cuda)
        engine = ServeEngine(cfg, model, 17, cuda)
        out, got = engine.generate(prompts.numpy(), 6, temperature=0.0, return_logits=True,
                                   cross_embeds=None if cross is None else cross.numpy())
    assert engine.compiled and sorted(k[0] for k in engine.graphs) == ["decode", "prefill"]
    assert np.array_equal(out[:, 12:], want_tok.numpy())
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert _close(g, w), (i, float((g - w).abs().max()), float(w.abs().max()))


@pytest.mark.parametrize("arch", ["gemma2_27b", "mamba2_780m", "recurrentgemma_9b"])
def test_one_engine_serves_requests_like_fresh_engines(cuda, arch):
    """One engine alternating two prompt lengths and two batch sizes, then
    the first shape again, gives the tokens of a fresh engine for each: a
    prefill graph for each (batch, prompt length) and a decode graph for
    each batch, sharing the engine's memory pool, carry nothing from one
    request to the next (12 tokens pass gemma2's 8-slot window)."""
    from repro_torch.launch.serve import ServeEngine

    cfg = _f32_smoke(arch)
    rng = np.random.default_rng(9)
    shapes = [(2, 12), (3, 5), (2, 5), (3, 12), (2, 12)]
    engine = ServeEngine.build(cfg, 20, seed=1, device=cuda)
    for shape in shapes:
        prompts = rng.integers(0, cfg.vocab, shape).astype(np.int32)
        fresh = ServeEngine.build(cfg, 20, seed=1, device=cuda)
        assert np.array_equal(engine.generate(prompts, 7, temperature=0.0),
                              fresh.generate(prompts, 7, temperature=0.0))
    assert sorted(engine.graphs) == [("decode", 2, None), ("decode", 3, None),
                                     ("prefill", 2, 5, None), ("prefill", 2, 12, None),
                                     ("prefill", 3, 5, None), ("prefill", 3, 12, None)]


@pytest.mark.parametrize("arch,changes", [pytest.param(a, {}, id=a) for a in GRAPH_ARCHS] + [
    pytest.param("musicgen_large", {"opt_kv_quant": True}, id="musicgen_large-int8_kv")])
def test_graphed_prefill_matches_eager(cuda, arch, changes):
    """The engine's captured prefill, replayed into its decode graph's
    reset caches, against the eager prefill step into fresh caches on the
    same weights: logits and every cache entry within ``GRAPH_TOL`` of
    their largest (ring positions and int8 codes equal), the greedy token
    equal.  12 prompt tokens pass gemma2's 8-slot window: the ring wraps."""
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import transformer as lm

    from benchmarks.torch_fig6_cnn_infer import full_precision

    cfg = _f32_smoke(arch, **changes)
    model = lm.init_params(cfg, 0, cuda)
    gen = torch.Generator().manual_seed(6)
    prompts = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    cross = (torch.randn((2, cfg.cross_kv_len, cfg.d_model), generator=gen)
             if cfg.family == "vlm" else None)
    with full_precision():
        engine = ServeEngine(cfg, model, 16, cuda)
        engine.generate(prompts.numpy(), 1, temperature=0.0,
                        cross_embeds=None if cross is None else cross.numpy())
        key = None if cross is None else (tuple(cross.shape), torch.float32)
        decode = engine.graphs[("decode", 2, key)]
        prefill = engine.graphs[("prefill", 2, 12, key)]
        lm.reset_caches(decode.caches)
        if cross is not None:
            decode.set_cross(cross.to(cuda))
        got = prefill(prompts.to(cuda)).clone()
        want, want_caches = engine.prefill_fn(model, prompts.to(cuda),
                                              lm.init_caches(cfg, 2, 16, cuda),
                                              None if cross is None else cross.to(cuda))
    assert _close(got, want), float((got - want).abs().max())
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    for layer, (a, b) in enumerate(zip(decode.caches, want_caches, strict=True)):
        assert set(a) == set(b)
        for name in b:
            assert (torch.equal(a[name], b[name]) if not b[name].is_floating_point()
                    else _close(a[name], b[name])), (layer, name)
    if "local" in cfg.layer_kinds():
        assert decode.caches[cfg.layer_kinds().index("local")]["k"].shape[1] < 12


def test_generate_returns_distinct_logits_each_step(cuda):
    """With ``return_logits`` each step's logits are a copy of their own,
    not the graph's output buffer the next replay overwrites."""
    from repro_torch.launch.serve import ServeEngine

    cfg = _f32_smoke("stablelm_3b")
    engine = ServeEngine.build(cfg, 16, device=cuda)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    out, logits = engine.generate(prompts, 6, temperature=0.0, return_logits=True)
    assert len({lg.data_ptr() for lg in logits}) == 6
    for i in range(1, 6):
        assert not torch.equal(logits[i], logits[i - 1])
        assert np.array_equal(logits[i].argmax(-1).cpu().numpy(), out[:, 8 + i])


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["stablelm_3b", "deepseek_moe_16b", "mamba2_780m"])
def test_graphed_train_steps_match_eager(cuda, arch, optimizer, remat):
    """Three steps of ``build_run``'s compiled step (the first eager, then
    replays of the captured step) against three eager steps from the same
    weights: losses within 1e-6 relative, every parameter within 1e-6 of
    its largest."""
    import copy

    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.launch import graphs, steps, train

    from benchmarks.torch_fig6_cnn_infer import full_precision

    cfg = _f32_smoke(arch, remat=remat)
    run = train.build_run(cfg, optimizer, seed=0, device=cuda)
    assert isinstance(run.step_fn, graphs.GraphedTrainStep)
    model = copy.deepcopy(run.params)
    _, opt = steps.choose_optimizer(cfg, optimizer)
    state = opt.init(dict(model.named_parameters()))
    eager = steps.make_train_step(cfg, opt)
    stream = SyntheticStream(DataConfig(cfg.vocab, 16, 2, seed=4))
    with full_precision():
        for i in range(3):
            batch = {k: v.to(cuda) for k, v in stream.next_batch(i).items()}
            _, state, want = eager(model, state, batch)
            _, run.opt_state, got = run.step_fn(run.params, run.opt_state, batch)
            assert abs(float(got["loss"]) - float(want["loss"])) <= GRAPH_TOL * abs(
                float(want["loss"])), i
    assert run.step_fn.graph is not None
    assert int(run.opt_state["step"]) == 3 and run.opt_state["step"].device.type == "cuda"
    want = dict(model.named_parameters())
    for k, p in run.params.named_parameters():
        assert _close(p, want[k]), k


def test_graphed_train_restore_continues_as_uninterrupted(cuda, tmp_path):
    """``train_loop`` on the compiled step with a fault at step 7 restores
    step 6 by copying into the tensors the graph holds, and ends where an
    uninterrupted compiled run ends."""
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.launch import train
    from repro_torch.runtime.fault_tolerance import FTConfig, FaultInjector

    from benchmarks.torch_fig6_cnn_infer import full_precision

    cfg = _f32_smoke("llama3_2_3b")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    runs = []
    with full_precision():
        for d, injector in ((tmp_path / "a", FaultInjector({7})), (tmp_path / "b", None)):
            run = train.build_run(cfg, "adamw", seed=0, device=cuda)
            ptrs = [p.data_ptr() for p in run.params.parameters()]
            run, hist = train.train_loop(run, stream, 10, ckpt_dir=str(d), injector=injector,
                                         ft=FTConfig(checkpoint_every=3, max_restarts=1),
                                         log_every=1000)
            assert [p.data_ptr() for p in run.params.parameters()] == ptrs
            runs.append((run, [h["loss"] for h in hist]))
    (faulted, losses_f), (clean, losses_c) = runs
    assert len(losses_f) == 11 and len(losses_c) == 10
    assert abs(losses_f[-1] - losses_c[-1]) <= GRAPH_TOL * abs(losses_c[-1])
    want = dict(clean.params.named_parameters())
    for k, p in faulted.params.named_parameters():
        assert _close(p, want[k]), k


def test_replays_read_nothing_back(cuda):
    """``torch.cuda.set_sync_debug_mode("error")`` around a prefill
    replay, a decode replay and a train-step replay: none synchronises with
    the host."""
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.launch import graphs, train
    from repro_torch.launch.serve import ServeEngine

    cfg = _f32_smoke("recurrentgemma_9b")
    engine = ServeEngine.build(cfg, 16, device=cuda)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    engine.generate(prompts, 3, temperature=0.0)
    decode = engine.graphs[("decode", 2, None)]
    prefill = engine.graphs[("prefill", 2, 8, None)]
    tokens = torch.from_numpy(prompts).long().to(cuda)
    tok = torch.zeros((2, 1), dtype=torch.int64, device=cuda)
    moe = _f32_smoke("deepseek_moe_16b")
    run = train.build_run(moe, "adamw", device=cuda)
    stream = SyntheticStream(DataConfig(moe.vocab, 16, 2))
    batches = [{k: v.to(cuda) for k, v in stream.next_batch(i).items()} for i in range(2)]
    run.step_fn(run.params, run.opt_state, batches[0])
    assert isinstance(run.step_fn, graphs.GraphedTrainStep)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prefill(tokens)
        decode(tok, 9)
        run.step_fn(run.params, run.opt_state, batches[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_bf16_attention_products_run_on_the_tensor_cores(cuda):
    """bf16 operands go to ``torch.bmm(..., out_dtype=torch.float32)``: the
    float32 result equals the widened product's within float32 summation
    order (each bf16 product is exact in float32); the backward's gradients
    against the widened autograd's within the same order."""
    from repro_torch.models import attention

    gen = torch.Generator().manual_seed(0)
    a = torch.randn((6, 40, 64), generator=gen).bfloat16().to(cuda).requires_grad_()
    b = torch.randn((6, 64, 72), generator=gen).bfloat16().to(cuda).requires_grad_()
    assert attention._tensor_cores(a, b)
    got = attention._Bf16Product.apply(a, b)
    assert got.dtype == torch.float32
    want = torch.bmm(a.detach().double(), b.detach().double())
    assert _close(got.detach(), want, 1e-5)
    g = torch.randn(got.shape, generator=gen).to(cuda)
    got.backward(g)
    ga = (g.double() @ b.detach().double().transpose(1, 2)).to(torch.bfloat16)
    gb = (a.detach().double().transpose(1, 2) @ g.double()).to(torch.bfloat16)
    assert _close(a.grad, ga, 1e-2) and _close(b.grad, gb, 1e-2)


# ------------------------------------------- the compiled step on a card mesh
#
# A mesh of one NCCL rank on the card: the serving engine and the train step
# are captured on it too, on static DTensor inputs.  Held to the meshless
# graphs (tokens) and to the eager steps on the same mesh (float32 losses and
# parameters within GRAPH_TOL).


@pytest.fixture(scope="module")
def nccl_mesh():
    """A 1×1 mesh on an NCCL group of one rank, shared by this module's
    mesh tests and taken down after them (a process has one default
    group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    yield make_host_mesh(device="cuda")
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graphed_mesh_engine_gives_meshless_tokens(nccl_mesh, arch):
    """``ServeEngine.build(..., mesh=mesh)`` on the card captures prefill and
    decode on static DTensor inputs; its greedy tokens equal the meshless
    engine's and the eager mesh engine's, for a batch of two prompts and of
    one."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.serve import ServeEngine

    from benchmarks.torch_fig6_cnn_infer import full_precision

    cfg = _f32_smoke(arch)
    rng = np.random.default_rng(3)
    with full_precision():
        for batch in (2, 1):
            prompts = rng.integers(0, cfg.vocab, (batch, 12)).astype(np.int32)
            cross = (rng.standard_normal((batch, cfg.cross_kv_len, cfg.d_model)).astype(
                np.float32) if cfg.family == "vlm" else None)
            outs = []
            for mesh, compile in ((None, True), (nccl_mesh, True), (nccl_mesh, False)):
                engine = ServeEngine.build(cfg, 17, seed=0, device="cuda", mesh=mesh,
                                           compile=compile)
                outs.append(engine.generate(prompts, 5, temperature=0.0, cross_embeds=cross))
                assert engine.compiled == compile
                if mesh is not None and compile:
                    key = None if cross is None else (cross.shape, torch.float32)
                    assert isinstance(engine.graphs[("decode", batch, key)].tokens, DTensor)
                    assert ("prefill", batch, 12, key) in engine.graphs
            assert np.array_equal(outs[1], outs[0]) and np.array_equal(outs[2], outs[0])


@pytest.mark.parametrize("arch", ["stablelm_3b", "deepseek_moe_16b", "mamba2_780m"])
def test_graphed_mesh_train_steps_match_eager(nccl_mesh, arch):
    """Three steps of ``build_run(..., mesh=mesh)``'s compiled step (the
    first eager, then replays on static DTensor batches) against three
    eager steps on the same mesh (``compile=False``) from the same weights:
    losses within 1e-6 relative, every parameter within 1e-6 of its
    largest."""
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.launch import graphs, train

    from benchmarks.torch_fig6_cnn_infer import full_precision

    cfg = _f32_smoke(arch)
    stream = SyntheticStream(DataConfig(cfg.vocab, 16, 2, seed=4))
    runs = []
    with full_precision():
        for compile in (True, False):
            run = train.build_run(cfg, "adamw", seed=0, device="cuda", mesh=nccl_mesh,
                                  compile=compile)
            assert isinstance(run.step_fn, graphs.GraphedTrainStep) == compile
            losses = []
            for i in range(3):
                batch = {k: v.cuda() for k, v in stream.next_batch(i).items()}
                _, run.opt_state, metrics = run.step_fn(run.params, run.opt_state, batch)
                losses.append(float(metrics["loss"]))
            runs.append((run, losses))
    (got, got_losses), (want, want_losses) = runs
    assert got.step_fn.graph is not None and int(got.opt_state["step"]) == 3
    for a, b in zip(got_losses, want_losses):
        assert abs(a - b) <= GRAPH_TOL * abs(b), (got_losses, want_losses)
    ref = {k: v.full_tensor() for k, v in want.params.state_dict().items()}
    for k, v in got.params.state_dict().items():
        assert _close(v.full_tensor(), ref[k]), k


def test_graphed_mesh_train_restore_continues_as_uninterrupted(nccl_mesh, tmp_path):
    """``train_loop`` on the compiled mesh step with a fault at step 7
    restores step 6 by copying into the DTensors the graph holds, and ends
    where an uninterrupted compiled mesh run ends."""
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.launch import train
    from repro_torch.runtime.fault_tolerance import FTConfig, FaultInjector

    from benchmarks.torch_fig6_cnn_infer import full_precision

    cfg = _f32_smoke("llama3_2_3b")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    runs = []
    with full_precision():
        for d, injector in ((tmp_path / "a", FaultInjector({7})), (tmp_path / "b", None)):
            run = train.build_run(cfg, "adamw", seed=0, device="cuda", mesh=nccl_mesh)
            run, hist = train.train_loop(run, stream, 10, ckpt_dir=str(d), injector=injector,
                                         ft=FTConfig(checkpoint_every=3, max_restarts=1),
                                         log_every=1000)
            runs.append((run, [h["loss"] for h in hist]))
    (faulted, losses_f), (clean, losses_c) = runs
    assert len(losses_f) == 11 and len(losses_c) == 10
    assert abs(losses_f[-1] - losses_c[-1]) <= GRAPH_TOL * abs(losses_c[-1])
    want = {k: v.full_tensor() for k, v in clean.params.state_dict().items()}
    for k, v in faulted.params.state_dict().items():
        assert _close(v.full_tensor(), want[k]), k


def test_mesh_replays_read_nothing_back(nccl_mesh):
    """``torch.cuda.set_sync_debug_mode("error")`` around the mesh
    engine's prefill and decode replays and a mesh train-step replay: none
    synchronises with the host."""
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.launch import train
    from repro_torch.launch.serve import ServeEngine

    cfg = _f32_smoke("gemma2_27b")
    engine = ServeEngine.build(cfg, 16, device="cuda", mesh=nccl_mesh)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    engine.generate(prompts, 3, temperature=0.0)
    prefill = engine.graphs[("prefill", 2, 10, None)]
    decode = engine.graphs[("decode", 2, None)]
    tokens = torch.from_numpy(prompts).long().cuda()
    tok = torch.zeros((2, 1), dtype=torch.int64, device="cuda")
    run = train.build_run(_f32_smoke("mamba2_780m"), "adamw", device="cuda", mesh=nccl_mesh)
    stream = SyntheticStream(DataConfig(run.cfg.vocab, 16, 2))
    batches = [{k: v.cuda() for k, v in stream.next_batch(i).items()} for i in range(2)]
    run.step_fn(run.params, run.opt_state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prefill(tokens)
        decode(tok, 11)
        run.step_fn(run.params, run.opt_state, batches[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
