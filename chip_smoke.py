"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds every kernel from this checkout's sources with ``nvcc`` (sm_90a),
all at once: both bit-serial executors and the MatPIM matmul (one source,
one kernel per variant).  Runs ``repro_torch.pim.compile(lambda a, b, c:
a*b+c)`` on CUDA tensors of 2^24 elements — the f32 MAC on the loop kernel
on both bases, the int8 MAC and a 32-bit fixed add on the straight-line
kernel — and checks every result bit for bit against numpy.  Then it holds
each bit-serial kernel against its plain PyTorch version word for word
(including the 13-segment straight-line f32 MAC) and times each with CUDA
events beside its bound.  The matmul phase drives the paper's Fig 5
benchmark (``benchmarks/torch_fig5_matmul.run()``) and ``ops.pim_matmul_op``
at every Fig 5 size in float32 and bfloat16 (each operand 2^26 elements)
and at ragged shapes; it requires the variant ``pim_matmul.plan`` names to
have launched for each call, holds each result against the plain version,
then times each case beside its bound, its plain version, ``torch.bmm`` and
the first, untiled matmul kernel (kept as the ``general`` variant, named
for the call).  It reads the matmul library's SASS: every bf16 tensor-core
variant must hold ``HMMA`` or ``HGMMA``, no float32 variant either.

The paper's CNN comparison follows: each of AlexNet, GoogLeNet and
ResNet-50 (parameters from seed 0) runs its float32 logits on the card with
TF32 off and is held against the same model in float64 on the CPU (max-abs
error at most ``CNN_TOL`` of the largest logit; the TF32 error is printed
beside it); then Fig 6 and Fig 7 (``benchmarks/torch_fig{6,7}_*.run()``,
batch 8, 224×224), and per model and mode the step time by CUDA events, by
the host clock and to enqueue, the profiler's device-busy time, the share
of the fp32 peak and peak memory.  It prints the Fig 4 rows, runs
``examples/torch_quickstart.py`` on the card (its f32 MAC on the loop
kernel, its analyzer verdicts against the H100) and the Fig 8 verdict of
each measured CNN step.  It runs ``benchmarks/torch_smoke.main()`` at 4096
elements and at 2^24, each with its gate (the straight-line kernel faster
than the loop kernel on the f32 MAC), writing
``build/BENCH_exec_torch_*.json``.  It prints one JSON line of kernels,
with the registers and stack frame of each read from the built library,
and, last, ``{"ok": true, "device": {...}}``.  Any failed check raises;
nothing falls back to the CPU or to a plain version.  Imports nothing of
JAX.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import repro_torch.pim as pim  # noqa: E402
from benchmarks import (torch_fig4_cc, torch_fig5_matmul, torch_fig6_cnn_infer,  # noqa: E402
                        torch_fig7_cnn_train, torch_smoke)
from repro_torch.core.analyzer import Workload, analyze  # noqa: E402
from repro_torch.core.costmodel import H100  # noqa: E402
from repro_torch.kernels import _build, ops, pim_bitserial, pim_matmul  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

N = 1 << 24
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64  # Hopper white paper: 32-bit logic ops per SM per clock
FP32_LANES_PER_SM = 128  # Hopper white paper: FP32 FMAs per SM per clock
BF16_TENSOR_FLOPS = 989e12  # H100 SXM data sheet, dense bf16
MATMUL_ELEMS = 1 << 26  # elements per matmul operand in the kernel checks
MATMUL_TOL = {torch.float32: (2e-4, 1.6e-3), torch.bfloat16: (2e-2, 0.16)}
MATMUL_RAGGED = [(1, 33, 17, 65), (2, 256, 384, 512)]
# The first loop kernel (20-byte gate rows read from device memory, one word
# a thread) is no longer in the tree; PERF.md records its time on an NVIDIA
# H100 80GB HBM3 at a 700 W limit, shown beside the new kernel's for scale.
PERF_MD_FIRST_LOOP = "PERF.md's record of the first loop kernel (H100 80GB HBM3, 700 W)"
PERF_MD_FIRST_LOOP_MS = {"f32 MAC memristive": 40.4022, "f32 MAC dram": 30.3298}
TIMED_LAUNCHES = 20
PLAIN_REPS = 2
# CNN logits on the card (float32, TF32 off) against float64 on the CPU:
# max-abs error at most this share of the largest |logit|.  TF32 rounds each
# product's inputs to 10 mantissa bits (relative 2^-11 = 4.9e-4), which this
# bound is meant to refuse; the run prints the TF32 error beside it.
CNN_TOL = 1e-4
CNN_CHECK_BATCH = 2
CNN_STEP_REPS = 10
EXEC_JSON = {n: os.path.join(ROOT, "build", f"BENCH_exec_torch_{n}.json") for n in (4096, N)}

F32_SPECIALS = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1.1754942e-38,
     3.4028235e38, -3.4028235e38, 1.0, -1.0], dtype=np.float32)


def say(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def f32_inputs(rng) -> tuple[np.ndarray, ...]:
    """Three float32 vectors over a wide exponent range, with ±0, ±inf, NaN
    and subnormals placed at fixed positions of each."""
    arrays = []
    for k in range(3):
        v = (rng.standard_normal(N) * np.exp2(rng.integers(-140, 120, N))).astype(np.float32)
        v[k + np.arange(len(F32_SPECIALS)) * (N // 16)] = np.roll(F32_SPECIALS, k)
        arrays.append(v)
    return tuple(arrays)


def same_f32(got: torch.Tensor, want: np.ndarray) -> bool:
    got = got.cpu().numpy()
    nan = np.isnan(want)
    return bool(np.array_equal(np.isnan(got), nan)
                and np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32)))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(compiled, words: int, int32_ops_per_s: float) -> tuple[float, str]:
    """Least time for ``gates × words`` 32-bit logic ops against reading the
    input planes once and writing the output planes once."""
    ops_ms = compiled.num_gates * words / int32_ops_per_s * 1e3
    bytes_ms = ((len(compiled.input_slots) + len(compiled.output_slots))
                * words * 4 / HBM_BYTES_PER_S * 1e3)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def stacked_planes(fn, arrays, device) -> torch.Tensor:
    return torch.stack([p for t, x in zip(fn.in_types, arrays)
                        for p in t.to_planes(t.cast(x, device))])


def matmul_bound(shape, dtype, fp32_flops: float) -> tuple[float, str]:
    """Least time for a ``[G,M,K] @ [G,K,N]`` call: its FLOPs at the FP32 FMA
    peak (float32) or the bf16 tensor-core peak, against reading both
    operands once and writing the product once."""
    G, M, K, N = shape
    elt = 4 if dtype == torch.float32 else 2
    ops_ms = 2 * G * M * K * N / (fp32_flops if dtype == torch.float32
                                  else BF16_TENSOR_FLOPS) * 1e3
    bytes_ms = G * (M * K + K * N + M * N) * elt / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def matmul_cases() -> list[tuple[str, tuple[int, int, int, int], torch.dtype, bool]]:
    """(label, (G, M, K, N), dtype, is a Fig 5 size): every Fig 5 size in
    both types, each operand 2^26 elements, then the ragged shapes."""
    cases = []
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for n in torch_fig5_matmul.SIZES:
            cases.append((f"{dname} n={n}", (MATMUL_ELEMS // (n * n), n, n, n), dtype, True))
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for shape in MATMUL_RAGGED:
            cases.append((f"{dname} ({','.join(map(str, shape[1:]))})", shape, dtype, False))
    return cases


def matmul_inputs(shape, dtype, seed: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    G, M, K, N = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((G, M, K), generator=gen, device=dev).to(dtype),
            torch.randn((G, K, N), generator=gen, device=dev).to(dtype))


def matmul_phase(dev: torch.device, fp32_flops: float) -> tuple[dict, list[dict]]:
    """Drive the Fig 5 benchmark and ``ops.pim_matmul_op`` at every case on
    the card, each call on the variant ``plan`` names and within tolerance
    of the plain version; then time each case beside its bound, its plain
    version, ``torch.bmm`` and the first kernel (``general``, named).
    Returns the launches of each variant in the driven run and one result
    per case."""
    cases = matmul_cases()
    pim_matmul.reset_launches()
    rows = torch_fig5_matmul.run()
    torch.cuda.synchronize()
    fig5_variant = pim_matmul.plan(2, 128, 128, 128, torch.float32)
    say(f"matmul path: benchmarks/torch_fig5_matmul.run() launches {dict(pim_matmul.LAUNCHES)}")
    require(pim_matmul.LAUNCHES[fig5_variant] == 3,
            f"the Fig 5 benchmark did not launch {fig5_variant} 3 times")
    names = [f"fig5/matmul_n{n}" for n in torch_fig5_matmul.SIZES]
    require([r["name"] for r in rows] == names, f"Fig 5 rows: {[r['name'] for r in rows]}")
    for r in rows:
        say(f"matmul path: {json.dumps(r)}")
        require(set(r) == set(rows[0]), f"Fig 5 row {r['name']} lacks columns")
        for col, v in r.items():
            if col != "us_per_call":
                require(v != "", f"Fig 5 row {r['name']}: empty {col}")
        require((r["us_per_call"] != "") == (r["name"] == "fig5/matmul_n128"),
                f"Fig 5 row {r['name']}: us_per_call {r['us_per_call']!r}")

    results = []
    for seed, (label, shape, dtype, fig5) in enumerate(cases):
        variant = pim_matmul.plan(*shape, dtype)
        a, b = matmul_inputs(shape, dtype, seed, dev)
        before = dict(pim_matmul.LAUNCHES)
        out = ops.pim_matmul_op(a, b)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in pim_matmul.LAUNCHES.items() if v != before[k]}
        require(launched == {variant: 1},
                f"matmul {label}: planned {variant}, launched {launched}")
        ref = pim_matmul.matmul_plain(a, b)
        require(out.shape == ref.shape and out.dtype == dtype, f"matmul {label} shape")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max().item())
        rtol, atol = MATMUL_TOL[dtype]
        require(bool(torch.isfinite(out.float()).all().item()), f"matmul {label} non-finite")
        require(bool((diff <= atol + rtol * ref.float().abs()).all().item()),
                f"matmul {variant} differs from its plain version on {label}: "
                f"max_abs_err {err}")
        say(f"matmul path: {label} {tuple(shape)} on {variant}: within rtol {rtol} "
            f"atol {atol} of plain (max_abs_err {err:.3g})")
        results.append(dict(label=label, shape=shape, dtype=dtype, fig5=fig5,
                            variant=variant, err=err))
        del a, b, out, ref, diff
    launches = dict(pim_matmul.LAUNCHES)
    say(f"matmul path: launches by variant {launches}")
    for variant, count in launches.items():
        require(count > 0, f"matmul variant {variant} never launched on the path")

    for seed, r in enumerate(results):
        a, b = matmul_inputs(r["shape"], r["dtype"], seed, dev)
        r["ms"] = cuda_ms(lambda: pim_matmul.matmul(a, b), 10)  # noqa: B023
        r["plain_ms"] = cuda_ms(lambda: pim_matmul.matmul_plain(a, b), 3)  # noqa: B023
        r["library_ms"] = cuda_ms(lambda: torch.bmm(a, b), 10)  # noqa: B023
        first_ms = cuda_ms(lambda: pim_matmul._launch(a, b, "general"), 10)  # noqa: B023
        r["bound_ms"], r["bound_by"] = matmul_bound(r["shape"], r["dtype"], fp32_flops)
        say(f"kernel pim_matmul/{r['variant']} on {r['label']} (G={r['shape'][0]}): "
            f"{r['ms']:.4f} ms/call, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms, torch.bmm {r['library_ms']:.4f} ms, first kernel "
            f"(general) {first_ms:.4f} ms")
        del a, b
    gen = torch.Generator(device=dev).manual_seed(SEED)
    a, b = (torch.randn((2, 128, 128), generator=gen, device=dev) for _ in range(2))
    say(f"matmul path: the Fig 5 timed instance [2,128,128] f32 back to back: "
        f"{cuda_ms(lambda: ops.pim_matmul_op(a, b), 100):.4f} ms per call over 100 calls")
    return launches, results


def cuobjdump(option: str, lib_path) -> str:
    """``cuobjdump <option>`` of a built library (the toolkit's, beside
    ``nvcc``)."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, option, str(lib_path)], check=True, capture_output=True,
                          text=True, timeout=300).stdout


def check_sass(lib_path) -> dict[str, dict[str, bool]]:
    """Tensor-core instructions per matmul kernel, from ``cuobjdump -sass`` of
    the built library: ``HMMA`` or ``HGMMA`` in every bf16 tensor-core
    variant, neither in any other kernel (no TF32 in float32)."""
    found: dict[str, dict[str, bool]] = {}
    for section in cuobjdump("-sass", lib_path).split("Function : ")[1:]:
        symbol = section.split()[0]
        for variant in pim_matmul.VARIANTS:
            if pim_matmul.kernel_symbol(variant) in symbol:
                seen = found.setdefault(variant, {"HMMA": False, "HGMMA": False})
                for op in seen:
                    seen[op] = seen[op] or op in section
    say(f"sass: tensor-core instructions by matmul variant {found}")
    require(set(found) == set(pim_matmul.VARIANTS), f"sass: kernels found {sorted(found)}")
    for variant, seen in found.items():
        require(any(seen.values()) == (variant in pim_matmul.TENSOR_CORE_VARIANTS),
                f"{variant}: tensor-core instructions {seen}")
    return found


def kernel_resources(lib_path, symbol: str) -> dict[str, int]:
    """Most registers and the largest stack frame (bytes a thread, where
    spills go) over the kernels whose symbol holds ``symbol``, from
    ``cuobjdump -res-usage`` of the built library.  Raises if none does."""
    found = [dict(re.findall(r"([A-Z]+):(\d+)", usage)) for name, usage in re.findall(
        r"Function ([^\s:]+):?\s*\n([^\n]*)", cuobjdump("-res-usage", lib_path))
        if symbol in name]
    require(bool(found) and all("REG" in k and "STACK" in k for k in found),
            f"no resource usage of a kernel {symbol} in {lib_path}")
    return {"registers": max(int(k["REG"]) for k in found),
            "stack_bytes": max(int(k["STACK"]) for k in found)}


def cnn_logits_check(dev: torch.device) -> None:
    """Each CNN's float32 logits on the card (TF32 off) against the same
    model in float64 on the CPU, at batch 2, 224×224, parameters from seed
    0; ResNet-50 in eval and train mode (the others have no batch norm).
    Prints the error with TF32 on beside it."""
    x = torch.randn((CNN_CHECK_BATCH, 3, 224, 224),
                    generator=torch.Generator().manual_seed(SEED + 1))
    for name in torch_fig6_cnn_infer.NAMES:
        model = cnn.MODELS[name](device="cpu", generator=torch.Generator().manual_seed(SEED))
        ref_model = copy.deepcopy(model).double()
        card = model.to(dev)
        for train in ((False, True) if name == "resnet50" else (False,)):
            with torch.no_grad():
                ref = ref_model.train(train)(x.double())
                got = card.train(train)(x.to(dev)).double().cpu()
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
                got_tf32 = card(x.to(dev)).double().cpu()
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            err_tf32 = float((got_tf32 - ref).abs().max())
            mode = "train" if train else "eval"
            require(got.shape == (CNN_CHECK_BATCH, 1000) and bool(torch.isfinite(got).all()),
                    f"{name} {mode}: logits shape {tuple(got.shape)} or non-finite")
            require(err <= CNN_TOL * scale,
                    f"{name} {mode}: card float32 logits off float64 by {err:.3g} "
                    f"(> {CNN_TOL} x {scale:.4g})")
            say(f"cnn: {name} {mode} batch {CNN_CHECK_BATCH} 224x224: float32 on the card "
                f"(TF32 off) within {err / scale:.3g} x max|logit| of float64 on the CPU "
                f"(max|logit| {scale:.4g}, bound {CNN_TOL}); with TF32 on: "
                f"{err_tf32 / scale:.3g} x max|logit|"
                f" ({'fails' if err_tf32 > CNN_TOL * scale else 'passes'} the bound)")
        del model, ref_model, card


def device_busy(step, reps: int) -> tuple[float, list[tuple[str, float]]]:
    """Device time of ``reps`` calls of ``step`` per call — the sum over the
    device-side events (kernels, copies, sets) ``torch.profiler`` saw, not
    over the host ops that launched them (0.0 if it saw none) — and the
    three device events that took most of it (name, ms per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    events = sorted(((e.key, e.self_device_time_total / 1e3 / reps)
                     for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda kv: -kv[1])
    return sum(ms for _, ms in events), events[:3]


def cnn_phase(dev: torch.device, smi: str) -> dict:
    """Fig 6 and Fig 7 on the card at batch 8, 224×224, float32, then per
    model and mode: CUDA-event and host-clock time per step, the host's
    enqueue time, the CUDA-event time with cuDNN's autotuner on, the
    profiler's device-busy time and its three largest device events, FLOP/s
    as a share of the H100's fp32 peak, and the step's peak device memory
    (model, input, activations, gradients and cuDNN workspace, above what
    was allocated before it).  Returns the measured steps: (name, train) ->
    (flops, bytes, event ms)."""
    cnn_logits_check(dev)
    rows = torch_fig6_cnn_infer.run(device=dev) + torch_fig7_cnn_train.run(device=dev)
    want = [f"{tag}/{n}" for tag in ("fig6", "fig7") for n in torch_fig6_cnn_infer.NAMES]
    require([r["name"] for r in rows] == want, f"Fig 6/7 rows: {[r['name'] for r in rows]}")
    for r in rows:
        require(all(v != "" for v in r.values()) and float(r["us_per_call"]) > 0,
                f"Fig 6/7 row {r['name']} incomplete: {r}")
        say(f"cnn: {json.dumps(r)}")
    measured = {}
    for train in (False, True):
        for name in torch_fig6_cnn_infer.NAMES:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # the earlier phases' tensors
            step = torch_fig6_cnn_infer.make_step(name, train, dev)
            flops, bytes_ = cnn.step_cost(name, torch_fig6_cnn_infer.BATCH, 224, train)
            with torch_fig6_cnn_infer.full_precision():
                event_ms = cuda_ms(step, CNN_STEP_REPS)
                t0 = time.perf_counter()
                for _ in range(CNN_STEP_REPS):
                    step()
                enqueue_ms = (time.perf_counter() - t0) * 1e3 / CNN_STEP_REPS
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3 / CNN_STEP_REPS
                busy_ms, top = device_busy(step, 3)
                peak = torch.cuda.max_memory_allocated() - held
                torch.backends.cudnn.benchmark = True  # autotuned in cuda_ms's warm-up
                tuned_ms = cuda_ms(step, CNN_STEP_REPS)
                torch.backends.cudnn.benchmark = False
            bound = max(flops / H100.peak_fp32, bytes_ / H100.mem_bw) * 1e3
            mode = "train" if train else "infer"
            busy = (f"{busy_ms:.4f} ms ({busy_ms / host_ms:.1%} of the host-clock step), "
                    "most in " + "; ".join(f"{k[:60]} {ms:.4f} ms" for k, ms in top)
                    if busy_ms > 0 else "not measured (the profiler saw no device time)")
            say(f"cnn: {name} {mode} batch {torch_fig6_cnn_infer.BATCH}: "
                f"{event_ms:.4f} ms/step by CUDA events (mean of {CNN_STEP_REPS} back to "
                f"back), {host_ms:.4f} ms by the host clock, {enqueue_ms:.4f} ms to enqueue, "
                f"{tuned_ms:.4f} ms by CUDA events with cudnn.benchmark on; "
                f"device busy {busy}; {flops / (event_ms * 1e-3) / 1e12:.2f} TFLOP/s = "
                f"{flops / (event_ms * 1e-3) / H100.peak_fp32:.1%} of the fp32 peak "
                f"{H100.peak_fp32 / 1e12:.0f} TFLOP/s ({smi}); fp32 roofline {bound:.4f} ms; "
                f"peak memory {peak / 2**20:.1f} MiB above the {held / 2**20:.1f} MiB held before")
            measured[(name, train)] = (flops, bytes_, event_ms)
            del step
    return measured


def fig4_fig8_phase(dev: torch.device, measured: dict) -> None:
    """The Fig 4 rows, the quickstart (its f32 MAC on the card and its
    analyzer verdicts against the H100), and the Fig 8 verdict of each CNN
    step measured here."""
    rows = torch_fig4_cc.run()
    require(len(rows) == 4 and all("improvement_vs_h100_membound" in r for r in rows),
            "Fig 4 rows")
    for r in rows:
        say(f"fig4: {json.dumps(r)}")
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", os.path.join(ROOT, "examples", "torch_quickstart.py"))
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    verdicts = quickstart.main(["--device", str(dev)])
    require([v.pim_wins for v in verdicts] == [True, False],
            f"quickstart verdicts: {verdicts}")
    for (name, train), (flops, bytes_, ms) in measured.items():
        v = analyze(Workload(f"{name} {'train' if train else 'infer'}", flops, bytes_))
        say(f"fig8: {v.workload}: reuse {v.reuse:.1f} FLOP/B, {v.quadrant}, modeled PIM "
            f"{v.pim_time_s * 1e3:.4f} ms vs H100 roofline (dense 16-bit) "
            f"{v.gpu_time_s * 1e3:.4f} ms -> PIM {'wins' if v.pim_wins else 'loses'}; "
            f"measured fp32 step {ms:.4f} ms")


def exec_phase() -> None:
    """``torch_smoke.main()`` at 4096 elements (the reference's size: a
    single block, where both kernels are latency-bound) and at 2^24, the
    main path's size, each with its gate: the straight-line kernel faster
    than the loop kernel on the f32 MAC."""
    for elems, path in EXEC_JSON.items():
        pim_bitserial.reset_launches()
        pim_matmul.reset_launches()
        torch_smoke.main(["--elems", str(elems), "--json", path])
        torch.cuda.synchronize()
        launches = {**pim_bitserial.LAUNCHES,
                    **{f"pim_matmul/{k}": v for k, v in pim_matmul.LAUNCHES.items() if v}}
        for kernel in ("bitserial_loop", "bitserial_unrolled", "pim_matmul/f32_simt128"):
            require(launches.get(kernel, 0) > 0,
                    f"torch_smoke at {elems} elements never launched {kernel}")
        with open(path) as f:
            record = json.load(f)
        require(record["elems"] == elems and len(record["rows"]) == 6, f"{path}: {record}")
        loop, unrolled = torch_smoke.f32_mac_times(record["rows"])
        say(f"exec: {elems} elements: the gate holds, straight-line {unrolled:.0f} us vs "
            f"loop {loop:.0f} us per f32 MAC; launches {launches}; rows in "
            f"{os.path.relpath(path, ROOT)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # Full float32 in every matrix product: the kernel checks compare with
    # plain and library products, which must not round through TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int32_ops_per_s = props.multi_processor_count * INT32_LANES_PER_SM * max_sm_mhz * 1e6
    fp32_flops = props.multi_processor_count * FP32_LANES_PER_SM * 2 * max_sm_mhz * 1e6
    say(f"device: {kind} x{torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {props.multi_processor_count} SMs, max SM clock "
        f"{max_sm_mhz:.0f} MHz -> INT32 logic peak {int32_ops_per_s / 1e12:.2f} T ops/s, "
        f"FP32 FMA peak {fp32_flops / 1e12:.2f} TFLOP/s")

    # ---------------------------------------------------------------- build
    f32_mac = pim.compile(lambda a, b, c: a * b + c, dtype=pim.f32)
    int8_mac = pim.compile(lambda a, b, c: a * b + c, dtype=pim.int8)
    fixed_add = ops._fn("add", "fixed", 32)
    f32_mem, f32_dram = f32_mac.compiled("memristive"), f32_mac.compiled("dram")
    int8_c, add_c = int8_mac.compiled(), fixed_add.compiled()
    for c in (f32_mem, f32_dram, int8_c, add_c):
        pim_bitserial.register_compiled(c)
    require(pim_bitserial.resolve_mode(f32_mem) == "loop"
            and pim_bitserial.resolve_mode(f32_dram) == "loop", "f32 MAC auto mode")
    require(pim_bitserial.resolve_mode(int8_c) == "unrolled"
            and pim_bitserial.resolve_mode(add_c) == "unrolled", "int8 MAC auto mode")
    t0 = time.perf_counter()
    _build.build(pim_bitserial.build_jobs([int8_c.key, add_c.key, f32_mem.key])
                 + [pim_matmul.build_job()])
    say(f"build: {time.perf_counter() - t0:.1f} s wall for all kernels, in parallel")
    for lib, entry in _build.BUILD_LOG.items():
        kernels = entry["ptxas"]
        regs = max((k.get("registers", 0) for k in kernels.values()), default=0)
        spills = sum(k.get("spill_stores", 0) for k in kernels.values())
        say(f"build: {entry['name']} ({lib}): {entry['seconds']:.1f} s, "
            f"{len(kernels)} kernel(s), max {regs} registers, {spills} bytes spill stores")
        for name, k in kernels.items():
            say(f"  ptxas {name}: {k}")

    # ------------------------------------------------------------ main path
    rng = np.random.default_rng(SEED)
    x, y, z = f32_inputs(rng)
    a8, b8, c8 = (rng.integers(-128, 128, N).astype(np.int8) for _ in range(3))
    a32, b32 = (rng.integers(-2**31, 2**31, N).astype(np.int32) for _ in range(2))
    xd, yd, zd = (torch.from_numpy(v).to(dev) for v in (x, y, z))
    a8d, b8d, c8d = (torch.from_numpy(v).to(dev) for v in (a8, b8, c8))
    a32d, b32d = (torch.from_numpy(v).to(dev) for v in (a32, b32))
    with np.errstate(over="ignore", invalid="ignore"):
        want_f32 = (x * y) + z
    want_i8 = (a8 * b8 + c8).astype(np.int32)
    want_add = a32 + b32
    torch.cuda.synchronize()

    pim_bitserial.reset_launches()
    t0 = time.perf_counter()
    got = {basis: f32_mac(xd, yd, zd, basis=basis) for basis in ("memristive", "dram")}
    torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    loop_after_f32 = pim_bitserial.LAUNCHES["bitserial_loop"]
    got_i8 = int8_mac(a8d, b8d, c8d)
    unrolled_after_i8 = pim_bitserial.LAUNCHES["bitserial_unrolled"]
    got_add = ops.pim_fixed_add(a32d, b32d, nbits=32)
    torch.cuda.synchronize()
    launches = dict(pim_bitserial.LAUNCHES)
    say(f"main path: launches {launches}; f32 MAC on both bases {f32_s:.2f} s wall "
        "(first calls, including plane packing)")
    require(loop_after_f32 == 2, f"loop kernel launches in the f32 MAC: {loop_after_f32}")
    require(unrolled_after_i8 == 1,
            f"straight-line kernel launches in the int8 MAC: {unrolled_after_i8}")
    require(launches["bitserial_unrolled"] == 2,
            f"straight-line kernel launches in the int8 MAC and fixed add: {launches}")
    for basis, out in got.items():
        require(out.device.type == dev.type and out.shape == (N,), f"f32 MAC {basis} shape")
        require(same_f32(out, want_f32), f"f32 MAC ({basis}) differs from numpy")
        say(f"main path: f32 MAC {basis}: {N} elements bit-equal to numpy (x*y)+z")
    require(np.array_equal(got_i8.cpu().numpy(), want_i8), "int8 MAC differs from numpy")
    say(f"main path: int8 MAC: {N} elements equal to numpy wrapping int8 a*b+c")
    require(np.array_equal(got_add.cpu().numpy(), want_add), "fixed add differs from numpy")
    say(f"main path: pim_fixed_add nbits=32: {N} elements equal to numpy int32 a+b")

    # ------------------------------------------- kernels vs plain versions
    words = N // 32
    f32_planes = stacked_planes(f32_mac, (x, y, z), dev)
    int8_planes = stacked_planes(int8_mac, (a8, b8, c8), dev)
    add_planes = stacked_planes(fixed_add, (a32, b32), dev)
    cases = [  # (label, kernel, compiled, planes, mode)
        ("f32 MAC memristive", "bitserial_loop", f32_mem, f32_planes, "loop"),
        ("f32 MAC dram", "bitserial_loop", f32_dram, f32_planes, "loop"),
        ("int8 MAC memristive", "bitserial_unrolled", int8_c, int8_planes, "unrolled"),
        ("fixed_add32 memristive", "bitserial_unrolled", add_c, add_planes, "unrolled"),
        ("f32 MAC memristive, forced straight-line", "bitserial_unrolled", f32_mem,
         f32_planes, "unrolled"),
    ]
    results = []
    for label, kernel, compiled, planes, mode in cases:
        key = compiled.key
        segments = pim_bitserial._segment_cache(key)
        run = lambda: pim_bitserial.run_schedule(key, planes, mode=mode)  # noqa: E731
        if mode == "loop":
            plain = lambda: pim_bitserial.loop_plain(compiled, planes)  # noqa: E731
        else:
            plain = lambda: pim_bitserial.unrolled_plain(  # noqa: E731
                compiled, planes, segments)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max().item())
        require(torch.equal(out, ref), f"{kernel} differs from its plain version on {label}")
        n_seg = len(segments) if mode == "unrolled" else 1
        ms = cuda_ms(run, TIMED_LAUNCHES)
        plain_ms = cuda_ms(plain, PLAIN_REPS)
        bms, by = bound_ms(compiled, words, int32_ops_per_s)
        earlier = (f"; {PERF_MD_FIRST_LOOP}: {PERF_MD_FIRST_LOOP_MS[label]} ms"
                   if kernel == "bitserial_loop" else "")
        say(f"kernel {kernel} on {label}: {compiled.num_gates} gates, {compiled.num_cols} "
            f"cols, {n_seg} launch(es)/call, W={words} words: equal to plain "
            f"(max_abs_err {err}); {ms:.4f} ms/call, bound {bms:.4f} ms ({by}), "
            f"plain {plain_ms:.2f} ms{earlier}")
        results.append(dict(label=label, kernel=kernel, err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bms, bound_by=by))

    native_ms = cuda_ms(lambda: xd * yd + zd, TIMED_LAUNCHES)
    say(f"yardstick (the paper's GPU side, not a version of either kernel): "
        f"native f32 x*y then +z on {N} unpacked elements: {native_ms:.4f} ms")

    mm_launches, mm_results = matmul_phase(dev, fp32_flops)
    mm_lib = _build.library_path(*pim_matmul.build_job())
    check_sass(mm_lib)

    t0 = time.perf_counter()
    measured = cnn_phase(dev, smi)
    say(f"cnn: phase took {time.perf_counter() - t0:.1f} s wall")
    pim_bitserial.reset_launches()
    pim_matmul.reset_launches()
    fig4_fig8_phase(dev, measured)
    torch.cuda.synchronize()
    say(f"fig8: quickstart launches {dict(pim_bitserial.LAUNCHES)}")
    require(pim_bitserial.LAUNCHES["bitserial_loop"] == 1,
            "the quickstart's f32 MAC did not run on the loop kernel")
    t0 = time.perf_counter()
    exec_phase()
    say(f"exec: phase took {time.perf_counter() - t0:.1f} s wall")

    sources = {  # name: (source, TPU kernel, library, kernel symbol, reported case)
        "bitserial_loop": ("src/repro_torch/kernels/csrc/bitserial_loop.cu",
                           "src/repro/kernels/pim_bitserial.py:93",
                           _build.library_path(*pim_bitserial.build_jobs()[0]),
                           "bitserial_loop_kernel", "f32 MAC memristive"),
        "bitserial_unrolled": ("src/repro_torch/kernels/bitserial_codegen.py",
                               "src/repro/kernels/pim_bitserial.py:233",
                               _build.library_path(*pim_bitserial.build_jobs([int8_c.key])[1]),
                               "bitserial_seg", "int8 MAC memristive"),
    }
    line = []
    for name, (source, replaces, lib, symbol, case) in sources.items():
        r = next(r for r in results if r["label"] == case)
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(
                q["err"] for q in results if q["kernel"] == name),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "case": r["label"],
            **kernel_resources(lib, symbol),
        })
    for variant in pim_matmul.VARIANTS:
        # Each variant reports its largest Fig 5 case, or its last case.
        runs = [r for r in mm_results if r["variant"] == variant]
        r = ([q for q in runs if q["fig5"]] or runs)[-1]
        line.append({
            "name": f"pim_matmul/{variant}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/pim_matmul.cu",
            "replaces": "src/repro/kernels/pim_matmul.py:31", "launches": mm_launches[variant],
            "max_abs_err": max(q["err"] for q in runs),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "case": r["label"],
            **kernel_resources(mm_lib, pim_matmul.kernel_symbol(variant)),
        })
    say(smi)
    say(json.dumps({"kernels": line}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
