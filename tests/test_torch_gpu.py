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
