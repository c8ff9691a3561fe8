"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds every kernel from this checkout's sources with ``nvcc`` (sm_90a),
all at once: both bit-serial executors, the packing kernels and the MatPIM
matmul (one source, one kernel per variant).  Runs ``repro_torch.pim.compile(lambda a, b, c:
a*b+c)`` on CUDA tensors of 2^24 elements — the f32 MAC on the loop kernel
on both bases, the int8 MAC and a 32-bit fixed add on the straight-line
kernel — and checks every result bit for bit against numpy, and that each
argument went through the packing kernel and each output through the
unpacking kernel (``pim_bitplanes.LAUNCHES``).  Then it holds each
bit-serial kernel against its plain PyTorch version word for word
(including the 13-segment straight-line f32 MAC) and times each with CUDA
events beside its bound, and does the same for the packing kernels at
``PACK_ROWS`` rows (the benchmark's bulk call), f32 and int8, each beside
its bytes bound and the plain path's time.  The same kernel-against-plain
loop holds the loop kernel on the nine-tap program of ``repro_torch.pim.conv``
(19 arguments; 191 live state columns on memristive, 186 on dram, so 288
words, 4.5 warps, a block; at least 256 words required) at VGG-16 D's
smallest and largest calls (``CONV_ROWS``) on both bases, each loop case
printing its live state, block and table groups and counting its launches;
the f32 MAC's and the nine-tap row's groups, stage pads left out, must be
at most ``GROUPS_SHARE`` of program order's (``PROGRAM_ORDER_GROUPS``);
then the conv phase runs one input channel
through ``conv3x3``, equal to ``vgg_reference.conv3x3_chain`` bit for bit,
with its launches counted from zero (one loop kernel, 19 packs, one
unpack); the kernels line carries the conv cases too.  The matmul phase drives the paper's Fig 5
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
``build/BENCH_exec_torch_*.json``.  The LM serving phase follows, with
every kernel count set to 0 before it (it must launch none of the port's
kernels): each arch's smoke config in float32, and gemma2-27b at full width
and depth 2, run prefill and greedy decode on the card and on the CPU with
the same weights through the serving engine's loop (on the card its
captured prefill and decode steps; logits within ``SERVE_TOL`` of the
largest, tokens equal), and each smoke config at its
default dtypes (bf16 compute) runs the forward and prefill plus
teacher-forced decode on both (each position within ``SERVE_BF16_TOL``);
then gemma2-27b at full width and depth (``serve_config``: bf16,
50.7 GiB of weights from seed 0) serves request set A (batch 4, prompt
512, 32 tokens: greedy twice, equal; then at temperature 0.8) and set B
(batch 1, a 4352-token prompt past the 4096 window, 8 tokens), each with
prefill and decode time by CUDA events, the host clock and the enqueue
time beside their bounds, each measured twice, eager (the step functions)
and graphed (the engine's captured steps, with their capture times), with
the host's launches and the device-busy time of a step (greedy tokens
equal between the two, logits within ``SERVE_PARITY_TOL``), the graphs'
memory pool, peak memory, decode parity (prefill P−1 plus a decode step
against prefill P) and the Fig 8 verdict;
then ``examples/torch_serve_decode.py`` on the card.  The LM training
phase follows, its counts also set to 0 before it and required 0 after:
each smoke arch in float32, and stablelm-3b at full width and depth 2 on
2×128 tokens, take the loss and every gradient of one batch and one AdamW
step on the card and on the CPU from the same weights (loss within
``TRAIN_LOSS_RTOL``, each gradient within ``SERVE_TOL`` of its largest);
stablelm-3b at full width and depth (float32 parameters, bf16 compute,
``remat="full"``, AdamW, clip 1.0) trains on one 4096-token sequence a step,
``TRAIN_STEPS`` steps compiled (``build_run``'s step: eager, then replays of
the captured step) and as many eager on the same batches, each after its
first step by CUDA events, the host clock and the enqueue time beside the
step's bound (``train_bound``), the losses agreeing within
``TRAIN_BF16_LOSS_RTOL``, with the capture time, the compiled step's
device-busy time and host launches, peak memory (reckoned before the run,
then measured) and the loss near ln V at step 0; then ``train_loop`` (on
the compiled step) with an injected fault resumes
from its checkpoint, a fresh run resumes cold, and
``examples/torch_train_lm.py`` trains on the card with its loss going
down.  The scale-out phase comes last, its counts also set to 0 before it
and required 0 after: ``make_host_mesh()`` starts a process group of one
NCCL rank; every smoke arch served greedily through ``ServeEngine.build(...,
mesh=mesh)``, compiled (prefill and decode captured on the mesh) and eager,
gives the meshless engine's tokens, and three float32 AdamW steps of
stablelm-3b at full width, depth 2, through ``build_run(..., mesh=mesh)``,
compiled and eager, agree with the meshless run (loss within
``TRAIN_LOSS_RTOL``, parameters within ``SCALE_PARAM_TOL`` of their
largest), each with the host's launches a request or a step;
``compressed_psum_mean`` runs over every gradient leaf of stablelm-3b at
full width, timed by CUDA events beside its bytes bound, its largest leaf
bit-equal to the CPU's; the dry run of ``DRYRUN_CELLS`` on the fake 16x16
mesh runs in subprocesses and feeds the roofline table and the offload
report.  It prints one JSON line of kernels, with the registers and stack
frame of each read from the built library, and, last, ``{"ok": true,
"device": {...}}``.  Any failed check raises; nothing falls back to the CPU
or to a plain version.  Imports nothing of
JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import repro_torch.pim as pim  # noqa: E402
from benchmarks import (torch_fig4_cc, torch_fig5_matmul, torch_fig6_cnn_infer,  # noqa: E402
                        torch_fig7_cnn_train, torch_roofline_table, torch_smoke)
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.core.analyzer import Workload, analyze  # noqa: E402
from repro_torch.core.costmodel import H100  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.core import bitplanes  # noqa: E402
from repro_torch.kernels import _build, ops, pim_bitplanes, pim_bitserial, pim_matmul  # noqa: E402
from repro_torch.launch import steps as lm_steps  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.launch.graphs import GraphedTrainStep  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.serve import ServeEngine  # noqa: E402
from repro_torch.parallel import compression  # noqa: E402
from repro_torch.runtime.fault_tolerance import FTConfig, FaultInjector  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models import vgg_reference  # noqa: E402
from repro_torch.pim import conv  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402

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
# The packing phase: the packing kernels at the benchmark's bulk call size
# (Table 1's 48 GiB machine, one row each), each against its bytes at
# HBM_BYTES_PER_S.
PACK_ROWS = 402_653_184
# CNN logits on the card (float32, TF32 off) against float64 on the CPU:
# max-abs error at most this share of the largest |logit|.  TF32 rounds each
# product's inputs to 10 mantissa bits (relative 2^-11 = 4.9e-4), which this
# bound is meant to refuse; the run prints the TF32 error beside it.
CNN_TOL = 1e-4
CNN_CHECK_BATCH = 2
CNN_STEP_REPS = 10
EXEC_JSON = {n: os.path.join(ROOT, "build", f"BENCH_exec_torch_{n}.json") for n in (4096, N)}
# The LM serving phase.  Card against CPU in float32: logits within
# SERVE_TOL x max|logit| at every step, greedy tokens equal.
SERVE_TOL = 1e-4
SERVE_SMOKE = (2, 12, 4)  # batch, prompt tokens, greedy decode steps: each smoke arch
SERVE_UNIT = (1, 8, 2)  # the same for gemma2-27b at full width, depth 2
SERVE_BF16 = (2, 12, 20)  # batch, prompt tokens, tokens in all: each smoke arch in bf16
SERVE_BF16_TOL = 0.05  # per position, x max|logit|: tests/test_torch_lm.py's bf16 bound
SERVE_MOE_BF16_SHARE = 7 / 8  # of the positions, for MoE archs
SERVE_SET_A = (4, 512, 32)  # batch, prompt tokens, generated tokens: gemma2-27b served
SERVE_SET_B = (1, 4352, 8)  # a prompt past the 4096 window: the local rings wrap
SERVE_TEMPERATURE = 0.8
# bf16 decode parity (prefill P-1 plus one decode step against prefill P at
# the last position): max|delta| over max|logit|, the bound PERF.md states.
SERVE_PARITY_TOL = 0.05
SERVE_PREFILL_REPS = 3
SERVE_BUSY_REPS = 3
# The LM training phase.  Card against CPU in float32: the loss within
# TRAIN_LOSS_RTOL relative, every gradient within SERVE_TOL x its largest.
TRAIN_LOSS_RTOL = 1e-5
# At the archs' default dtypes (float32 parameters, bf16 compute, remat
# "full"), card against CPU from the same weights: the loss within
# TRAIN_BF16_LOSS_RTOL relative, every gradient within TRAIN_BF16_TOL x its
# largest; the control, bf16 on the card against float32 on the CPU, within
# TRAIN_BF16_TOL too.  bf16 against float32 on the CPU, the ten smoke archs
# on 2 x 16 tokens: gradients 2.2 - 6.9 % of their largest, losses 2.8e-5 -
# 4.3e-4 relative (PERF.md).
TRAIN_BF16_TOL = 0.1
TRAIN_BF16_LOSS_RTOL = 2e-3
TRAIN_SMOKE = (2, 16)  # batch, tokens: each smoke arch
TRAIN_UNIT = (2, 128)  # the same for stablelm-3b at full width, depth 2
# stablelm-3b at full width and depth: one sequence of train_4k's length a
# step (its global batch of 256 cut to 1: one card, no accumulation).
TRAIN_ARCH = "stablelm_3b"
TRAIN_SEQ = SHAPES["train_4k"].seq_len
# Steps of each run (compiled and eager): the first is eager in both, the
# later ones are timed; two timed eager steps keep the script near 5 minutes.
TRAIN_STEPS = 3
# Bytes a parameter: AdamW reads p, g, m, v and writes p, m, v (float32);
# clipping reads g for the norm, then reads g and writes the scaled copy.
ADAMW_BYTES, CLIP_BYTES = 28, 12

# The scale-out phase.  A mesh of one NCCL rank: the sharded serving engine's
# greedy tokens, compiled and eager, equal the meshless engine's; three AdamW
# steps of stablelm-3b at full width, depth 2, in float32 (the compiled run's
# first eager, then two replays), compiled and eager, within TRAIN_LOSS_RTOL
# (loss, relative) and SCALE_PARAM_TOL x each parameter's largest of the
# meshless run.
SCALE_PARAM_TOL = 1e-4
SCALE_TRAIN_STEPS = 3
# compressed_psum_mean over every gradient leaf of stablelm-3b at full width:
# it reads g and the residual and writes the mean and the new residual, 16 B
# an element, at 3.35 TB/s (the codes and scales are intermediates).
COMPRESS_BYTES = 16
# The dry-run cells counted on the 16x16 fake mesh, each in its own process.
DRYRUN_CELLS = [("stablelm-3b", "train_4k"), ("stablelm-3b", "decode_32k"),
                ("gemma2-27b", "decode_32k")]
DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun_smoke")

# The nine-tap program of ``repro_torch.pim.conv`` (19 float32 arguments;
# 672 schedule columns on memristive, but 191 live state columns, so 288
# words, a block of 144 threads, an SM) on the loop kernel at VGG-16 D's smallest and largest calls at batch 8, 224² (the
# last group's 8·14²·512 rows, the first group's 8·224²·64); then one input
# channel of its first layer through ``conv3x3``: batch, side, Cout.
CONV_ROWS = (802_816, 25_690_112)
# The loop kernel's table groups, stage pads left out, that program order
# gave (each hazard-free wave chunk cut at four gates), by program and basis;
# the dataflow order must take at most GROUPS_SHARE of them.
PROGRAM_ORDER_GROUPS = {"f32 MAC memristive": 6642, "f32 MAC dram": 4131,
                        "nine-tap conv memristive": 59744, "nine-tap conv dram": 37007}
GROUPS_SHARE = 0.56
CONV_LAYER = (8, 224, 64)

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


def packing_phase(dev: torch.device) -> list[dict]:
    """The packing kernels at PACK_ROWS rows: a f32 and an int8 MAC's three
    arguments packed into one plane buffer as a call packs them, and one
    output unpacked, each first held bit for bit against the plain PyTorch
    path, then timed by CUDA events beside its bytes bound and that path."""
    n, words = PACK_ROWS, bitplanes.num_words(PACK_ROWS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    pim_bitplanes.reset_launches()
    for t in (pim.f32, pim.int8):
        if t.kind == "float32":
            args = [torch.randn(n, generator=gen, device=dev) for _ in range(3)]
            plain_pack = bitplanes.f32_to_planes
            plain_unpack = lambda p: bitplanes.planes_to_f32(p, n).view(torch.int32)  # noqa: E731
        else:
            args = [torch.randint(-128, 128, (n,), generator=gen, device=dev, dtype=torch.int8)
                    for _ in range(3)]
            plain_pack = lambda x: bitplanes.int_to_planes(x, t.nbits)  # noqa: E731
            plain_unpack = lambda p: bitplanes.planes_to_int(p, n, signed=True)  # noqa: E731
        planes = torch.empty((3 * t.width, words), dtype=torch.int32, device=dev)
        result = torch.empty(n, dtype=torch.int32, device=dev)
        out_rows = planes[:t.width]

        def pack():
            for k, x in enumerate(args):
                t.to_planes(x, out=planes[k * t.width:(k + 1) * t.width])

        def unpack():
            pim_bitplanes.unpack(out_rows, n, t.width, t.kind != "float32", result)

        pack()
        unpack()
        for k, x in enumerate(args):
            require(torch.equal(planes[k * t.width:(k + 1) * t.width], torch.stack(plain_pack(x))),
                    f"bitplane_pack differs from the plain path: {t.name} argument {k}")
        require(torch.equal(result, plain_unpack(list(out_rows))),
                f"bitplane_unpack differs from the plain path: {t.name}")
        require(torch.equal(result, args[0].view(torch.int32) if t.kind == "float32"
                            else args[0].to(torch.int32)), f"{t.name}: the round trip")
        in_bytes = 3 * (n * args[0].element_size() + t.width * words * 4)
        out_bytes = t.width * words * 4 + n * 4
        for name, fn, plain, nbytes in (
                ("bitplane_pack", pack, lambda: [plain_pack(x) for x in args], in_bytes),
                ("bitplane_unpack", unpack, lambda: plain_unpack(list(out_rows)), out_bytes)):
            ms = cuda_ms(fn, TIMED_LAUNCHES)
            plain_ms = cuda_ms(plain, PLAIN_REPS)
            bms = nbytes / HBM_BYTES_PER_S * 1e3
            say(f"packing: {name} {t.name}, {'3 arguments' if name == 'bitplane_pack' else '1 output'}"
                f" of {n} rows: equal to the plain path; {ms:.4f} ms/call, bound {bms:.4f} ms "
                f"(bytes, {nbytes / 1e9:.3f} GB), {100 * bms / ms:.1f} % of it, "
                f"{nbytes / ms / 1e6:.0f} GB/s; plain {plain_ms:.2f} ms")
            rows.append(dict(kernel=name, label=f"{t.name}, {n} rows", ms=ms, plain_ms=plain_ms,
                             bound_ms=bms, bound_by="bytes"))
        del args, planes, result, out_rows
        torch.cuda.empty_cache()
    say(f"packing: launches {dict(pim_bitplanes.LAUNCHES)}")
    return rows


def conv_planes(n: int, dev: torch.device) -> torch.Tensor:
    """The nine-tap program's 19 float32 arguments of ``n`` rows over a
    wide exponent range, with the specials at fixed positions, packed."""
    gen = torch.Generator(device=dev).manual_seed(SEED + n)
    specials = torch.from_numpy(F32_SPECIALS).to(dev)
    args = []
    for k in range(len(conv.PROGRAM.in_types)):
        scale = torch.randint(-40, 40, (n,), generator=gen, device=dev).float().exp2()
        v = torch.randn(n, generator=gen, device=dev) * scale
        v[k + torch.arange(len(specials), device=dev) * (n // 16)] = specials.roll(k)
        args.append(v)
    return stacked_planes(conv.PROGRAM, args, dev)


def conv_phase(dev: torch.device) -> dict:
    """One input channel of a CONV_LAYER layer through ``conv3x3`` on
    memristive, bit for bit against ``vgg_reference.conv3x3_chain``, its
    launches counted from zero: one loop launch, 19 packs, one unpack."""
    batch, side, cout = CONV_LAYER
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((batch, 1, side, side), generator=gen, device=dev)
    w = torch.randn((cout, 1, 3, 3), generator=gen, device=dev) * (2 / 9) ** 0.5
    b = torch.randn(cout, generator=gen, device=dev)
    conv.conv3x3(x, w, b, basis="memristive")  # the gate table's upload
    torch.cuda.synchronize()
    pim_bitserial.reset_launches()
    pim_bitplanes.reset_launches()
    spans.reset_counters("conv.")
    got = conv.conv3x3(x, w, b, basis="memristive")
    torch.cuda.synchronize()
    launches = {**dict(pim_bitserial.LAUNCHES), **dict(pim_bitplanes.LAUNCHES),
                **spans.counters("conv.")}
    differing = vgg_reference.differing(got, vgg_reference.conv3x3_chain(x, w, b))
    say(f"conv: conv3x3 of one channel into {cout} at batch {batch}, {side}² "
        f"({got.numel()} rows) on memristive: {differing} elements differ from "
        f"conv3x3_chain; launches {launches}")
    require(differing == 0, f"conv3x3 differs from conv3x3_chain in {differing} elements")
    require(launches == {"bitserial_loop": 1, "bitserial_unrolled": 0, "bitplane_pack": 19,
                         "bitplane_unpack": 1, "conv.waves": 1},
            f"conv3x3's launches for one channel: {launches}")
    return launches


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


def device_busy(step, reps: int) -> tuple[float, list[tuple[str, float]], float, float]:
    """Device time of ``reps`` calls of ``step`` per call — the sum over the
    device-side events (kernels, copies, sets) ``torch.profiler`` saw (0.0
    if it saw none) — the three device events that took most of it (name,
    ms per call), the device events per call, and the host's launches per
    call: the CUDA runtime and driver calls that launch a kernel or a graph
    or start a copy or a set (a graph's replay is one launch for all its
    kernels).  It records the device activity and those calls alone: the
    host ops are not traced, which keeps a call of some 10^5 launches quick
    to profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    device = [e for e in averages if e.device_type == DeviceType.CUDA]
    events = sorted(((e.key, e.self_device_time_total / 1e3 / reps) for e in device),
                    key=lambda kv: -kv[1])
    launches = sum(e.count for e in averages if e.device_type == DeviceType.CPU
                   and re.match(r"cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset)", e.key))
    return (sum(ms for _, ms in events), events[:3], sum(e.count for e in device) / reps,
            launches / reps)


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
                busy_ms, top, _, _ = device_busy(step, 3)
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


def f32_config(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def greedy(model, cfg, tokens, cross, steps: int, device) -> tuple[list, torch.Tensor]:
    """Prefill ``tokens`` then ``steps`` greedy decode steps through the
    serving engine's loop on ``device``: the logits of prefill and of each
    step (float64, on the CPU) and the ``steps + 1`` greedy tokens."""
    B, P = tokens.shape
    engine = ServeEngine(cfg, model, P + steps, device)
    out, logits = engine.generate(tokens.numpy(), steps + 1, temperature=0.0,
                                  cross_embeds=cross, return_logits=True)
    return [lg.double().cpu() for lg in logits], torch.from_numpy(out[:, P:])


def forced(model, cfg, tokens, cross, prompt: int, device) -> torch.Tensor:
    """Prefill ``tokens[:, :prompt]``, then decode each later token of
    ``tokens`` in turn (teacher-forced, so two devices see the same inputs
    whatever their argmax): [B, 1 + T - prompt, V] logits, float64 on the
    CPU."""
    B, T = tokens.shape
    tokens = tokens.to(device)
    cross = None if cross is None else cross.to(device)
    caches = lm.init_caches(cfg, B, T, device)
    logits, caches = lm.prefill(model, tokens[:, :prompt], cfg, caches, cross_embeds=cross)
    out = [logits]
    for pos in range(prompt, T - 1):
        logits, caches = lm.decode_step(model, tokens[:, pos:pos + 1], pos, cfg, caches,
                                        cross_embeds=cross)
        out.append(logits)
    return torch.stack(out, dim=1).double().cpu()


def serve_inputs(cfg, shape, seed: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Seeded prompts [B, P] and, for the VLM, patch embeddings."""
    B, P = shape
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (B, P), generator=gen)
    cross = (torch.randn((B, cfg.cross_kv_len, cfg.d_model), generator=gen)
             if cfg.family == "vlm" else None)
    return tokens, cross


def card_matches_cpu(label: str, cfg, model_cpu, model_card, shape, dev, seed: int) -> None:
    """The same prompts (and VLM patch embeddings) through the CPU model and
    the card's: every step's float32 logits within ``SERVE_TOL`` of the
    largest, greedy tokens equal."""
    B, P, steps = shape
    tokens, cross = serve_inputs(cfg, (B, P), seed)
    t0 = time.perf_counter()
    want, want_tok = greedy(model_cpu, cfg, tokens, cross, steps, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, got_tok = greedy(model_card, cfg, tokens, cross, steps, dev)
    card_s = time.perf_counter() - t0
    require(all(bool(torch.isfinite(g).all()) for g in got), f"serve {label}: non-finite logits")
    errs = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
    require(max(errs) <= SERVE_TOL, f"serve {label}: card logits off the CPU's by {errs}")
    require(torch.equal(got_tok, want_tok),
            f"serve {label}: greedy tokens {got_tok.tolist()} on the card, {want_tok.tolist()} "
            f"on the CPU")
    say(f"serve: {label} ({cfg.family}, {cfg.n_layers} layers {'/'.join(cfg.unit)}, d "
        f"{cfg.d_model}): prefill {P} tokens at batch {B} + {steps} greedy steps in float32: "
        f"card within {max(errs):.3g} x max|logit| of the CPU at every step (bound {SERVE_TOL}),"
        f" greedy tokens equal {got_tok[0].tolist()}; {cpu_s:.1f} s CPU, {card_s:.1f} s card")


def bf16_card_matches_cpu(label: str, cfg, model_cpu, model_card, dev, seed: int) -> dict:
    """At the arch's default dtypes (bf16 compute): the full forward and the
    serving path (prefill, then teacher-forced decode steps) on the card
    against the same weights on the CPU.  Each position's logits within
    ``SERVE_BF16_TOL`` x max|logit| (the bound of ``tests/test_torch_lm.py``
    against the reference), at every position, or at ``SERVE_MOE_BF16_SHARE``
    of them for MoE archs, where a bf16 rounding can flip a near-tied
    router choice."""
    B, P, T = SERVE_BF16
    tokens, cross = serve_inputs(cfg, (B, T), seed)
    readings = {}
    for path in ("forward", "serve"):
        runs = []
        for model, d in ((model_cpu, torch.device("cpu")), (model_card, dev)):
            if path == "forward":
                with torch.no_grad():
                    logits, _, _ = lm.forward(model, tokens.to(d), cfg, cross_embeds=None
                                              if cross is None else cross.to(d))
                runs.append(logits.double().cpu())
            else:
                runs.append(forced(model, cfg, tokens, cross, P, d))
        want, got = runs
        require(bool(torch.isfinite(got).all()), f"serve {label} bf16 {path}: non-finite logits")
        per_pos = (got - want).abs().amax(-1) / want.abs().max()
        share = float((per_pos <= SERVE_BF16_TOL).double().mean())
        need = SERVE_MOE_BF16_SHARE if cfg.n_experts else 1.0
        require(share >= need, f"serve {label} bf16 {path}: {share:.3f} of positions within "
                f"{SERVE_BF16_TOL} x max|logit| (need {need:.3f}), worst "
                f"{float(per_pos.max()):.4g}")
        readings[path] = (float(per_pos.max()), share, per_pos.numel())
    say(f"serve: {label} at default dtypes ({cfg.compute_dtype} compute, {cfg.param_dtype} "
        f"weights), card against the CPU: forward over {B}x{T} tokens worst "
        f"{readings['forward'][0]:.4g} x max|logit|, {readings['forward'][1]:.0%} of "
        f"{readings['forward'][2]} positions within; prefill {P} + {T - P - 1} teacher-forced "
        f"decode steps worst {readings['serve'][0]:.4g}, {readings['serve'][1]:.0%} of "
        f"{readings['serve'][2]} positions within (bound {SERVE_BF16_TOL} at "
        f"{'7/8 of' if cfg.n_experts else 'all'} positions)")
    return {path: r[0] for path, r in readings.items()}


def graph_pool_bytes() -> int:
    """Bytes the card's private memory pools (the CUDA graphs') hold."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def timed(fn) -> tuple[float, float, float, object]:
    """(CUDA-event ms, host-clock ms to the end of the work, host ms to
    enqueue it, result) of one call of ``fn``."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    result = fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    return start.elapsed_time(end), host_ms, enqueue_ms, result


def attn_layers(cfg, S: int) -> list[int]:
    """The cache length of every attention layer at ``S`` positions."""
    return [min(S, cfg.window) if k == "local" else S
            for k in cfg.layer_kinds() if k in ("global", "local", "moe")]


def decode_bytes(cfg, B: int, P: int, steps: int) -> tuple[float, float]:
    """Bytes a decode step must read, averaged over ``steps`` steps from
    position ``P``: every bf16 weight once (the tied embedding is the
    output projection) and the k/v of the filled cache slots."""
    weights = 2.0 * cfg.param_count()
    per_token = 2 * B * cfg.n_kv_heads * cfg.hd * 2  # k and v, bf16
    kv = sum(min(P + i + 1, S_c) * per_token for i in range(steps)
             for S_c in attn_layers(cfg, P + steps)) / steps
    return weights, kv


def prefill_flops(cfg, B: int, T: int) -> tuple[float, float]:
    """(2·N·tokens, the FLOPs this prefill needs): every matrix product at
    2 FLOPs a MAC, the output projection on the last position only, and
    attention over each query's causal (windowed) keys."""
    n, vd = cfg.param_count(), cfg.vocab * cfg.d_model
    work = 2.0 * (n - vd) * B * T + 2.0 * vd * B
    H, hd = cfg.n_heads, cfg.hd
    for S_c, kind in zip(attn_layers(cfg, T),
                         [k for k in cfg.layer_kinds() if k in ("global", "local", "moe")]):
        window = cfg.window if kind == "local" else T
        keys = sum(min(q + 1, window) for q in range(T))
        work += 2 * 2 * B * H * hd * keys  # scores and the weighted sum
    return 2.0 * n * B * T, work


def busy_text(busy_ms: float, host_ms: float, enqueue_ms: float, events: float, top) -> str:
    """``device_busy``'s reading of one call beside its host-clock time."""
    if busy_ms <= 0:
        return "not measured (the profiler saw no device time)"
    return (f"{busy_ms:.4f} ms ({busy_ms / host_ms:.1%} of the host-clock call) in {events:.0f} "
            f"device events ({enqueue_ms / events * 1e3:.1f} us of enqueue each), most in "
            + "; ".join(f"{k[:60]} {ms:.4f} ms" for k, ms in top))


def serve_requests(engine, label: str, shape, dev, smi: str) -> dict:
    """One request set on the served model: greedy generate twice (equal
    tokens, prompts echoed), at temperature 0.8 once (set A), prefill and
    decode timed by CUDA events and the host clock beside their bounds, the
    device-busy share of a decode step, decode parity and peak memory."""
    B, P, G = shape
    cfg = engine.cfg
    eng = dataclasses.replace(engine, max_seq=P + G)
    prompts = np.random.default_rng(SEED + ord(label)).integers(0, cfg.vocab, (B, P)).astype(
        np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = eng.generate(prompts, G, temperature=0.0)
    generate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = eng.generate(prompts, G, temperature=0.0)
    again_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    pools = graph_pool_bytes()
    require(out.shape == (B, P + G) and np.array_equal(out, again),
            f"serve set {label}: two greedy runs differ")
    require(np.array_equal(out[:, :P], prompts), f"serve set {label}: prompts not echoed")
    require(0 <= out.min() and out.max() < cfg.vocab, f"serve set {label}: token out of range")
    say(f"serve: set {label} (batch {B}, prompt {P}, gen {G}): two greedy runs token-equal, "
        f"prompts echoed; generate {generate_s:.3f} s by the host clock "
        f"({B * G / generate_s:.1f} tok/s end to end, the prefill's and decode step's captures "
        f"included), {again_s:.3f} s the second time; the prefill and decode graphs' shared "
        f"pool and any other graph pool on the card {pools / 2**30:.3f} GiB; "
        f"first row {out[0, P:].tolist()}")
    if label == "A":
        sampled = eng.generate(prompts, G, temperature=SERVE_TEMPERATURE, seed=SEED)
        require(np.array_equal(sampled[:, :P], prompts) and sampled.max() < cfg.vocab
                and sampled.min() >= 0, f"serve set {label}: sampled tokens")
        say(f"serve: set {label} at temperature {SERVE_TEMPERATURE}: first row "
            f"{sampled[0, P:].tolist()}")

    tokens = torch.from_numpy(prompts).long().to(dev)
    # The steps the engine captured for this shape in the greedy runs above.
    graphed = eng.graphs[("decode", B, None)]
    graphed_prefill = eng.graphs[("prefill", B, P, None)]
    # Prefill, eager (the step function, op by op from the host, on fresh
    # caches) and graphed (a replay into the decode graph's reset caches).
    prefill = []
    for _ in range(SERVE_PREFILL_REPS):
        caches = lm.init_caches(cfg, B, eng.max_seq, dev)
        ev, host, enq, (logits, caches) = timed(
            lambda: eng.prefill_fn(eng.params, tokens, caches))  # noqa: B023
        prefill.append((ev, host, enq))
    require(bool(torch.isfinite(logits.float()).all()), f"serve set {label}: prefill logits")
    pre_busy_ms, pre_top, pre_events, pre_launches = device_busy(
        lambda: eng.prefill_fn(eng.params, tokens, lm.init_caches(cfg, B, eng.max_seq, dev)), 1)
    g_prefill = []
    for _ in range(SERVE_PREFILL_REPS):
        lm.reset_caches(graphed.caches)
        ev, host, enq, first = timed(lambda: graphed_prefill(tokens))
        g_prefill.append((ev, host, enq))
    gp_busy_ms, gp_top, gp_events, gp_launches = device_busy(lambda: graphed_prefill(tokens), 1)
    require(torch.equal(first.argmax(-1), logits.argmax(-1)), f"serve set {label}: graphed "
            f"prefill's greedy tokens {first.argmax(-1).tolist()} != eager "
            f"{logits.argmax(-1).tolist()}")
    pre_vs_eager = float((first.float() - logits.float()).abs().max() / logits.float().abs().max())
    require(pre_vs_eager <= SERVE_PARITY_TOL, f"serve set {label}: graphed prefill logits off "
            f"the eager step's by {pre_vs_eager:.4g} x max|logit|")
    top2 = logits.float().topk(2, dim=-1).values
    say(f"serve: set {label} last-position logits: max|logit| "
        f"{float(logits.float().abs().max()):.3f} (final softcap {cfg.final_softcap}), "
        f"top-2 gap {float((top2[:, 0] - top2[:, 1]).min()):.3f} to "
        f"{float((top2[:, 0] - top2[:, 1]).max()):.3f} across the batch")

    def decode_loop(step, lg):
        """``G - 1`` greedy steps from the prefill's logits ``lg``: a copy of
        each step's logits."""
        seen = []
        for i in range(G - 1):
            lg = step(lg.argmax(dim=-1, keepdim=True), P + i)
            seen.append(lg.clone())
        return seen

    # Eager: the step functions, op by op from the host.
    dec_ev, dec_host, dec_enq, eager_seen = timed(lambda: decode_loop(
        lambda tok, pos: eng.decode_fn(eng.params, tok, pos, caches)[0], logits))
    steps = G - 1
    tok = eager_seen[-1].argmax(dim=-1, keepdim=True)
    busy_ms, top, n_events, launches = device_busy(
        lambda: eng.decode_fn(eng.params, tok, P + G - 1, caches), SERVE_BUSY_REPS)
    del caches, logits
    # Compiled: the decode graph replayed on its own caches, filled by a
    # replay of the prefill graph.
    lm.reset_caches(graphed.caches)
    first = graphed_prefill(tokens).clone()
    g_ev, g_host, g_enq, graphed_seen = timed(lambda: decode_loop(graphed, first))
    g_busy_ms, g_top, g_events, g_launches = device_busy(lambda: graphed(tok, P + G - 1),
                                                         SERVE_BUSY_REPS)
    for which, seen in (("eager", eager_seen), ("graphed", graphed_seen)):
        require(all(bool(torch.isfinite(lg.float()).all()) for lg in seen),
                f"serve set {label}: {which} decode logits")
    eager_tok = torch.stack([lg.argmax(-1) for lg in eager_seen])
    graphed_tok = torch.stack([lg.argmax(-1) for lg in graphed_seen])
    require(torch.equal(graphed_tok, eager_tok), f"serve set {label}: graphed decode tokens "
            f"{graphed_tok[:, 0].tolist()} != eager {eager_tok[:, 0].tolist()}")
    vs_eager = max(float((g.float() - e.float()).abs().max() / e.float().abs().max())
                   for g, e in zip(graphed_seen, eager_seen))
    require(vs_eager <= SERVE_PARITY_TOL, f"serve set {label}: graphed decode logits off the "
            f"eager step's by {vs_eager:.4g} x max|logit|")
    capture_s, prefill_capture_s = graphed.capture_s, graphed_prefill.capture_s
    del eager_seen, graphed_seen, first, graphed, graphed_prefill

    # decode parity: prefill P-1 plus one decode step against prefill P
    want, _ = eng.prefill_fn(eng.params, tokens, lm.init_caches(cfg, B, P, dev))
    _, caches = eng.prefill_fn(eng.params, tokens[:, :-1], lm.init_caches(cfg, B, P, dev))
    got, _ = eng.decode_fn(eng.params, tokens[:, -1:], P - 1, caches)
    parity = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    require(bool(torch.isfinite(got.float()).all()), f"serve set {label}: parity logits")
    require(parity <= SERVE_PARITY_TOL,
            f"serve set {label}: decode parity {parity:.4g} > {SERVE_PARITY_TOL}")
    del caches, got, want

    model_flops, work = prefill_flops(cfg, B, P)
    weights, kv = decode_bytes(cfg, B, P, steps)
    pre_ms = [r[0] for r in prefill]
    gp_ms = [r[0] for r in g_prefill]
    pre_bound = max(work / BF16_TENSOR_FLOPS, weights / HBM_BYTES_PER_S) * 1e3
    dec_ms = dec_ev / steps
    dec_bound = (weights + kv) / HBM_BYTES_PER_S * 1e3
    say(f"serve: set {label} prefill, eager (the step function) ({B}x{P} tokens): "
        f"{', '.join(f'{m:.2f}' for m in pre_ms)} ms by CUDA events ({SERVE_PREFILL_REPS} runs), "
        f"host clock {', '.join(f'{r[1]:.2f}' for r in prefill)} ms, enqueue "
        f"{', '.join(f'{r[2]:.2f}' for r in prefill)} ms, {pre_launches:.0f} host launches; "
        f"bound {pre_bound:.2f} ms (this run's "
        f"{work / 1e12:.1f} TFLOP at the bf16 peak 989 TFLOP/s; 2·N·tokens "
        f"{model_flops / BF16_TENSOR_FLOPS * 1e3:.2f} ms) -> {pre_bound / pre_ms[-1]:.1%} of "
        f"the bound; device busy "
        f"{busy_text(pre_busy_ms, prefill[-1][1], prefill[-1][2], pre_events, pre_top)} ({smi})")
    say(f"serve: set {label} prefill, graphed (the engine's captured prefill, captured in "
        f"{prefill_capture_s:.3f} s with its eager warm-up): "
        f"{', '.join(f'{m:.2f}' for m in gp_ms)} ms by CUDA events ({SERVE_PREFILL_REPS} "
        f"replays), host clock {', '.join(f'{r[1]:.2f}' for r in g_prefill)} ms, enqueue "
        f"{', '.join(f'{r[2]:.3f}' for r in g_prefill)} ms, {gp_launches:.0f} host launches; "
        f"{pre_bound / gp_ms[-1]:.1%} of the bound, {min(r[1] for r in prefill) / min(r[1] for r in g_prefill):.2f}x "
        f"the eager step by the host clock; greedy tokens equal to eager, logits within "
        f"{pre_vs_eager:.4g} x max|logit| of eager (bound {SERVE_PARITY_TOL}); device busy "
        f"{busy_text(gp_busy_ms, g_prefill[-1][1], g_prefill[-1][2], gp_events, gp_top)} ({smi})")
    g_ms = g_ev / steps
    say(f"serve: set {label} decode, eager (the step functions): {dec_ms:.4f} ms/step by CUDA "
        f"events over {steps} steps, {dec_host / steps:.4f} ms by the host clock, "
        f"{dec_enq / steps:.4f} ms to enqueue, {launches:.0f} host launches a step; "
        f"{B / (dec_ms * 1e-3):.1f} tok/s; bound {dec_bound:.4f} ms ({weights / 1e9:.2f} GB "
        f"of weights + {kv / 1e9:.3f} GB of k/v a step at 3.35 TB/s) -> {dec_bound / dec_ms:.1%}"
        f" of the bound; device busy "
        f"{busy_text(busy_ms, dec_host / steps, dec_enq / steps, n_events, top)} ({smi})")
    say(f"serve: set {label} decode, graphed (the engine's captured step, captured in "
        f"{capture_s:.3f} s): {g_ms:.4f} ms/step by CUDA events over {steps} steps, "
        f"{g_host / steps:.4f} ms by the host clock, {g_enq / steps * 1e3:.1f} us to enqueue, "
        f"{g_launches:.0f} host launches a step (replay, token and position copies); "
        f"{B / (g_ms * 1e-3):.1f} tok/s -> {dec_bound / g_ms:.1%} of the bound, "
        f"{dec_ms / g_ms:.2f}x the eager step; greedy tokens equal to eager, logits within "
        f"{vs_eager:.4g} x max|logit| of eager (bound {SERVE_PARITY_TOL}); device busy "
        f"{busy_text(g_busy_ms, g_host / steps, g_enq / steps, g_events, g_top)} ({smi})")
    say(f"serve: set {label} decode parity (prefill {P - 1} + one decode step against prefill "
        f"{P}): {parity:.4g} x max|logit| (bound {SERVE_PARITY_TOL}), argmax equal in "
        f"{agree:.0%} of rows; peak memory {peak / 2**30:.2f} GiB")
    v = analyze(Workload(f"{cfg.name} decode bs={B} (set {label})",
                         flops=2.0 * cfg.param_count() * B, hbm_bytes=weights + kv))
    say(f"fig8: {v.workload}: reuse {v.reuse:.1f} FLOP/B, {v.quadrant}, modeled PIM "
        f"{v.pim_time_s * 1e3:.4f} ms vs modeled H100 {v.gpu_time_s * 1e3:.4f} ms -> PIM "
        f"{'wins' if v.pim_wins else 'loses'}; measured H100 decode step {g_ms:.4f} ms graphed "
        f"({dec_ms:.4f} ms eager)")
    return {"prefill_ms": pre_ms, "prefill_host_ms": [r[1] for r in prefill],
            "prefill_enqueue_ms": [r[2] for r in prefill], "prefill_busy_ms": pre_busy_ms,
            "prefill_host_launches": pre_launches, "prefill_bound_ms": pre_bound,
            "graphed_prefill_ms": gp_ms, "graphed_prefill_host_ms": [r[1] for r in g_prefill],
            "graphed_prefill_enqueue_ms": [r[2] for r in g_prefill],
            "graphed_prefill_busy_ms": gp_busy_ms, "graphed_prefill_host_launches": gp_launches,
            "graphed_prefill_vs_eager": pre_vs_eager, "prefill_capture_s": prefill_capture_s,
            "decode_ms": dec_ms,
            "decode_host_ms": dec_host / steps, "decode_enqueue_ms": dec_enq / steps,
            "decode_bound_ms": dec_bound, "decode_busy_ms": busy_ms,
            "decode_device_events": n_events, "decode_host_launches": launches,
            "graphed_decode_ms": g_ms, "graphed_decode_host_ms": g_host / steps,
            "graphed_decode_enqueue_us": g_enq / steps * 1e3, "graphed_decode_busy_ms": g_busy_ms,
            "graphed_decode_host_launches": g_launches, "graphed_vs_eager": vs_eager,
            "capture_s": capture_s,
            "tok_per_s": B / (dec_ms * 1e-3), "graphed_tok_per_s": B / (g_ms * 1e-3),
            "generate_s": generate_s, "generate_again_s": again_s,
            "graph_pool_gib": pools / 2**30, "parity": parity, "peak_gib": peak / 2**30}


def serve_phase(dev: torch.device, smi: str) -> None:
    """The LM serving path: every smoke arch in float32 and in bf16, and
    gemma2-27b at full width and depth 2 in float32, on the card against the
    CPU, then gemma2-27b
    served at full width and depth in bf16 on request sets A and
    B.  No kernel of the port runs here (cuBLAS and PyTorch's own kernels):
    the counts must stay 0."""
    pim_bitserial.reset_launches()
    pim_matmul.reset_launches()
    # Full float32 sums in every bf16 product, as XLA's bf16 dots keep them:
    # cuBLAS may otherwise reduce split-K partial sums in bf16.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    bf16 = {}
    for i, arch in enumerate(ARCHS):
        cfg = f32_config(get_smoke_config(arch))
        model_cpu = lm.init_params(cfg, SEED, "cpu")
        card_matches_cpu(arch, cfg, model_cpu, copy.deepcopy(model_cpu).to(dev), SERVE_SMOKE,
                         dev, SEED + i)
        cfg = get_smoke_config(arch)
        model_cpu = lm.init_params(cfg, SEED, "cpu")
        bf16[arch] = bf16_card_matches_cpu(arch, cfg, model_cpu,
                                           copy.deepcopy(model_cpu).to(dev), dev, SEED + i)
    full = get_config("gemma2_27b")
    cfg = dataclasses.replace(f32_config(full), n_layers=2)
    model_card = lm.init_params(cfg, SEED, dev)
    model_cpu = lm.init_params(cfg, SEED, "meta")
    model_cpu.load_state_dict({k: v.cpu() for k, v in model_card.state_dict().items()},
                              assign=True)
    say(f"serve: {cfg.name} at full width, depth 2: {cfg.param_count()} parameters in float32")
    card_matches_cpu(f"{cfg.name} depth 2", cfg, model_cpu, model_card, SERVE_UNIT, dev, SEED)
    del model_card, model_cpu

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    sets = (("A", SERVE_SET_A), ("B", SERVE_SET_B))
    t0 = time.perf_counter()
    engine = ServeEngine.build(full, max_seq=max(P + G for _, (_, P, G) in sets), seed=SEED,
                               device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n = engine.cfg.param_count()
    weight_bytes = sum(p.numel() * p.element_size() for p in engine.params.parameters())
    require(weight_bytes == 2 * n, f"serve: {weight_bytes} bytes of weights for {n} parameters")
    say(f"serve: {full.name} at full width and depth ({full.n_layers} layers, serve_config: "
        f"bf16 weights and compute) built on the card from seed {SEED} in {build_s:.1f} s: {n} "
        f"parameters, {weight_bytes / 2**30:.2f} GiB; {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB allocated, {held / 2**30:.2f} GiB of it held by earlier phases; "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB on the card")
    results = {label: serve_requests(engine, label, shape, dev, smi) for label, shape in sets}
    del engine
    torch.cuda.empty_cache()

    spec = importlib.util.spec_from_file_location(
        "torch_serve_decode", os.path.join(ROOT, "examples", "torch_serve_decode.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out, verdict = example.main(["--device", str(dev)])
    require(out.shape == (4, 40), f"examples/torch_serve_decode.py: {out.shape}")
    torch.cuda.synchronize()
    launches = {**pim_bitserial.LAUNCHES,
                **{f"pim_matmul/{k}": v for k, v in pim_matmul.LAUNCHES.items()}}
    say(f"serve: the port's kernel launches in the serve phase {launches}")
    require(not any(launches.values()), "the serve phase launched a kernel of the port")
    say(f"serve: summary {json.dumps({**results, 'smoke_bf16_worst': bf16})}")


def train_batch(cfg, shape, seed: int, device) -> dict:
    """A ``SyntheticStream`` batch (and, for the VLM, seeded patch
    embeddings) on ``device``."""
    B, T = shape
    batch = SyntheticStream(DataConfig(cfg.vocab, T, B, seed=seed)).next_batch(0)
    if cfg.family == "vlm":
        gen = torch.Generator().manual_seed(seed)
        batch["cross_embeds"] = torch.randn((B, cfg.cross_kv_len, cfg.d_model), generator=gen)
    return {k: v.to(device) for k, v in batch.items()}


def train_matches_cpu(label: str, cfg, model_cpu, model_card, shape, dev, seed: int) -> None:
    """The loss and every gradient of one batch on the CPU and on the card
    from the same weights, then one AdamW train step on each (its loss and
    gradient norm within ``TRAIN_LOSS_RTOL``, every parameter finite)."""
    runs = []
    for model, d in ((model_cpu, torch.device("cpu")), (model_card, dev)):
        batch = train_batch(cfg, shape, seed, d)
        t0 = time.perf_counter()
        loss, _, grads = lm_steps.loss_and_grads(model, batch, cfg)
        _, opt = lm_steps.choose_optimizer(cfg, "adamw")
        state = opt.init(dict(model.named_parameters()))
        _, _, metrics = lm_steps.make_train_step(cfg, opt)(model, state, batch)
        finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
        runs.append((float(loss), {k: g.cpu() for k, g in grads.items()}, metrics,
                     finite, time.perf_counter() - t0))
        del grads, state
    (want_loss, want, want_m, _, cpu_s), (loss, got, got_m, finite, card_s) = runs
    require(finite and np.isfinite(loss), f"train {label}: non-finite loss or parameters")
    loss_err = abs(loss - want_loss) / abs(want_loss)
    require(loss_err <= TRAIN_LOSS_RTOL, f"train {label}: loss {loss} on the card, {want_loss} "
            "on the CPU")
    errs = {k: float((got[k].double() - w.double()).abs().max() / w.abs().max().clamp(min=1e-30))
            for k, w in want.items()}
    worst = max(errs, key=errs.get)
    require(errs[worst] <= SERVE_TOL, f"train {label}: gradient {worst} off the CPU's by "
            f"{errs[worst]:.3g} x its largest")
    for key in ("loss", "grad_norm"):
        err = abs(float(got_m[key]) - float(want_m[key])) / abs(float(want_m[key]))
        require(err <= TRAIN_LOSS_RTOL, f"train {label}: step {key} off the CPU's by {err:.3g}")
    say(f"train: {label} ({cfg.family}, {cfg.n_layers} layers, d {cfg.d_model}), "
        f"{shape[0]}x{shape[1]} tokens in float32: loss {loss:.6f}, within {loss_err:.3g} of "
        f"the CPU's (bound {TRAIN_LOSS_RTOL}); {len(errs)} gradients within "
        f"{errs[worst]:.3g} x their largest (worst {worst}; bound {SERVE_TOL}); an AdamW "
        f"step's loss and grad norm {float(got_m['grad_norm']):.4f} agree; {cpu_s:.1f} s CPU, "
        f"{card_s:.1f} s card")


def bf16_train_matches_cpu(label: str, cfg, model_cpu, model_card, shape, dev,
                           seed: int) -> dict:
    """At the arch's default dtypes (bf16 compute, ``remat`` as configured):
    the loss and every gradient of one batch on the card against the same
    weights on the CPU, within ``TRAIN_BF16_LOSS_RTOL`` and
    ``TRAIN_BF16_TOL`` x each gradient's largest; and the control, the
    card's bf16 gradients against float32 compute on the CPU, within
    ``TRAIN_BF16_TOL``.  Returns the worst readings."""
    cpu = torch.device("cpu")
    runs = {}
    for key, model, d, c in (("cpu", model_cpu, cpu, cfg), ("card", model_card, dev, cfg),
                             ("cpu_f32", model_cpu, cpu, f32_config(cfg))):
        loss, _, grads = lm_steps.loss_and_grads(model, train_batch(c, shape, seed, d), c)
        runs[key] = (float(loss), {k: g.double().cpu() for k, g in grads.items()})
        del grads

    def worst(got, want):
        errs = {k: float((got[k] - w).abs().max() / w.abs().max().clamp(min=1e-30))
                for k, w in want.items()}
        k = max(errs, key=errs.get)
        return errs[k], k

    (want_loss, want), (loss, got), (f32_loss, f32) = runs["cpu"], runs["card"], runs["cpu_f32"]
    require(np.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in got.values()),
            f"train {label} bf16: non-finite loss or gradients")
    read = {"loss": abs(loss - want_loss) / abs(want_loss), "grad": worst(got, want),
            "control": worst(got, f32), "cpu_control": worst(want, f32),
            "loss_control": abs(want_loss - f32_loss) / abs(f32_loss)}
    say(f"train: {label} at default dtypes ({cfg.compute_dtype} compute, {cfg.param_dtype} "
        f"parameters, remat {cfg.remat}), {shape[0]}x{shape[1]} tokens, card against the CPU: "
        f"loss {loss:.6f} within {read['loss']:.3g} (bound {TRAIN_BF16_LOSS_RTOL}); "
        f"{len(want)} gradients within {read['grad'][0]:.4g} x their largest (worst "
        f"{read['grad'][1]}; bound {TRAIN_BF16_TOL}); control, card bf16 against CPU float32: "
        f"{read['control'][0]:.4g} (worst {read['control'][1]}), CPU bf16 against CPU float32 "
        f"{read['cpu_control'][0]:.4g} (worst {read['cpu_control'][1]}), loss "
        f"{read['loss_control']:.3g}")
    require(read["loss"] <= TRAIN_BF16_LOSS_RTOL, f"train {label} bf16: loss {loss} on the "
            f"card, {want_loss} on the CPU")
    require(read["grad"][0] <= TRAIN_BF16_TOL, f"train {label} bf16: gradient "
            f"{read['grad'][1]} off the CPU's by {read['grad'][0]:.4g} x its largest")
    require(read["control"][0] <= TRAIN_BF16_TOL, f"train {label} bf16: gradient "
            f"{read['control'][1]} off float32 by {read['control'][0]:.4g} x its largest")
    return {k: v[0] if isinstance(v, tuple) else v for k, v in read.items()}


def train_bound(cfg, T: int) -> dict:
    """Least time for one training step on ``T`` tokens, in ms, term by
    term: 6·N·T FLOPs and causal attention's forward and backward
    (6·L·T²·d) at the bf16 peak, AdamW's and clipping's bytes at 3.35 TB/s,
    and, apart, the forward that ``remat="full"`` recomputes.  N in the
    products leaves out an untied input embedding, a lookup that multiplies
    nothing; AdamW and clipping move every parameter's bytes."""
    n, L, d = cfg.param_count(), cfg.n_layers, cfg.d_model
    n_mm = n - (0 if cfg.tie_embeddings else cfg.vocab * d)
    terms = {"6NT": 6.0 * n_mm * T / BF16_TENSOR_FLOPS,
             "attention": 6.0 * L * T * T * d / BF16_TENSOR_FLOPS,
             "adamw": ADAMW_BYTES * n / HBM_BYTES_PER_S,
             "clip": CLIP_BYTES * n / HBM_BYTES_PER_S}
    terms = {k: v * 1e3 for k, v in terms.items()}
    terms["bound"] = sum(terms.values())
    terms["remat"] = (2.0 * n_mm * T + 2.0 * L * T * T * d) / BF16_TENSOR_FLOPS * 1e3
    return terms


def train_timed(dev: torch.device, smi: str) -> dict:
    """stablelm-3b at full width and depth (float32 parameters, bf16
    compute, ``remat="full"``, AdamW as ``choose_optimizer`` gives it, grad
    clip 1.0) on one ``TRAIN_SEQ``-token sequence a step, ``TRAIN_STEPS``
    steps from seed ``SEED`` twice on the same batches: compiled (``build_run``'s
    step: the first eager, then replays of the captured step) and eager
    (``steps.make_train_step``), each after its first step by CUDA events,
    the host clock and the enqueue time, the compiled one's device-busy time
    and host launches on one more replay, the capture time and peak memory
    of each; the losses of the two agree step for step."""
    cfg = get_config(TRAIN_ARCH)
    n = cfg.param_count()
    reckoned = {"params, grads, m, v (16 B a parameter)": 16.0 * n,
                "the clipped copy or the updates (4 B a parameter)": 4.0 * n,
                "one recomputed layer's blocked attention (3 [1,H,512,512] float32 a block "
                "pair)": 3.0 * 4 * cfg.n_heads * 512 * 512 * (TRAIN_SEQ // 512) ** 2,
                "logits (bf16, float32, log-softmax, its gradient)": (2 + 4 * 3) * TRAIN_SEQ
                * cfg.vocab}
    say(f"train: {cfg.name} at full width and depth ({cfg.n_layers} layers, {n} parameters, "
        f"{cfg.param_dtype} parameters, {cfg.compute_dtype} compute, remat {cfg.remat}); "
        f"memory reckoned before the run: " + "; ".join(
            f"{k} {v / 1e9:.2f} GB" for k, v in reckoned.items())
        + f"; peak at most {sum(reckoned.values()) / 1e9:.2f} GB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB, in the eager first "
        f"step and again in the captured step (the graph's pool takes the step's transients "
        f"once the first step's cached blocks are freed; both at once would pass the card)")
    stream = SyntheticStream(DataConfig(cfg.vocab, TRAIN_SEQ, 1, seed=SEED))
    batches = [{k: v.to(dev) for k, v in stream.next_batch(i).items()}
               for i in range(TRAIN_STEPS + 1)]
    runs = {}
    for mode in ("graphed", "eager"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        run = lm_train.build_run(cfg, "adamw", seed=SEED, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        step_fn = run.step_fn
        if mode == "eager":
            step_fn = lm_steps.make_train_step(cfg, lm_steps.choose_optimizer(cfg, "adamw")[1])
        require((mode == "graphed") == isinstance(step_fn, GraphedTrainStep),
                f"train {cfg.name}: build_run's step on the card is {step_fn!r}")
        losses, times = [], []
        for i, batch in enumerate(batches[:-1]):
            ev, host, enq, (params, run.opt_state, metrics) = timed(
                lambda: step_fn(run.params, run.opt_state, batch))  # noqa: B023
            losses.append(float(metrics["loss"]))
            require(np.isfinite(losses[-1]), f"train {cfg.name} {mode}: step {i} loss "
                    f"{losses[-1]}")
            times.append((ev, host, enq))
        peak = torch.cuda.max_memory_allocated()
        busy = (0.0, [], 0.0, 0.0)
        profile_s = 0.0
        if mode == "graphed":
            t0 = time.perf_counter()
            busy = device_busy(lambda: step_fn(run.params, run.opt_state, batches[-1]), 1)
            profile_s = time.perf_counter() - t0
        require(all(bool(torch.isfinite(p).all()) for p in run.params.parameters()),
                f"train {cfg.name} {mode}: non-finite parameters")
        runs[mode] = {"losses": losses, "times": times, "peak": peak, "held": held,
                      "build_s": build_s, "busy": busy, "profile_s": profile_s,
                      "capture_s": getattr(step_fn, "capture_s", None)}
        del run, step_fn, params, metrics  # the next run needs the card's memory
    g, e = runs["graphed"], runs["eager"]
    ln_v = float(np.log(cfg.vocab))
    require(abs(g["losses"][0] - ln_v) <= 0.25 * ln_v,
            f"train {cfg.name}: step-0 loss {g['losses'][0]} is not near ln V = {ln_v:.3f}")
    vs_eager = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], e["losses"]))
    require(vs_eager <= TRAIN_BF16_LOSS_RTOL, f"train {cfg.name}: graphed losses {g['losses']} "
            f"against eager {e['losses']}")
    bound = train_bound(cfg, TRAIN_SEQ)
    busy_ms, top, events, launches = g["busy"]
    for mode, r in runs.items():
        ms = [t[0] for t in r["times"][1:]]
        r["ms"] = ms
        say(f"train: {cfg.name} {mode} (built from seed {SEED} in {r['build_s']:.1f} s): losses "
            f"{', '.join(f'{x:.6f}' for x in r['losses'])}; first step (eager"
            + (f", then the capture in {r['capture_s']:.2f} s" if r["capture_s"] else "")
            + f") {r['times'][0][1]:.2f} ms by the host clock; then "
            f"{', '.join(f'{m:.2f}' for m in ms)} ms a step by CUDA events (1x{TRAIN_SEQ} "
            f"tokens), host clock {', '.join(f'{t[1]:.2f}' for t in r['times'][1:])} ms, "
            f"enqueue {', '.join(f'{t[2]:.2f}' for t in r['times'][1:])} ms; "
            f"{bound['bound'] / min(ms):.1%} of the bound, {TRAIN_SEQ / (min(ms) * 1e-3):.0f} "
            f"tokens/s; peak memory {r['peak'] / 1e9:.2f} GB ({r['peak'] / 2**30:.2f} GiB, "
            f"{r['held'] / 2**30:.2f} GiB of it held by earlier phases) of 80 GB ({smi})")
    say(f"train: {cfg.name} step bound {bound['bound']:.2f} ms (6NT {bound['6NT']:.2f} + "
        f"attention 6LT²d {bound['attention']:.2f} at 989 TFLOP/s, AdamW {ADAMW_BYTES} B/param "
        f"{bound['adamw']:.2f} + clip {CLIP_BYTES} B/param {bound['clip']:.2f} at 3.35 TB/s; "
        f"remat's recomputed forward would add {bound['remat']:.2f}); graphed "
        f"{min(e['ms']) / min(g['ms']):.2f}x the eager step, losses within {vs_eager:.3g} "
        f"relative of eager (bound {TRAIN_BF16_LOSS_RTOL}); graphed device busy "
        f"{busy_text(busy_ms, g['times'][-1][1], g['times'][-1][2], events, top)}, "
        f"{launches:.0f} host launches (profiled in {g['profile_s']:.1f} s)")
    torch.cuda.empty_cache()
    return {"step_ms": g["ms"], "host_ms": [t[1] for t in g["times"][1:]],
            "enqueue_ms": [t[2] for t in g["times"][1:]], "capture_s": g["capture_s"],
            "eager_step_ms": e["ms"], "eager_host_ms": [t[1] for t in e["times"][1:]],
            "eager_enqueue_ms": [t[2] for t in e["times"][1:]],
            "busy_ms": busy_ms, "device_events": events, "host_launches": launches,
            "bound_ms": bound, "losses": g["losses"], "eager_losses": e["losses"],
            "graphed_vs_eager": vs_eager, "peak_gb": g["peak"] / 1e9,
            "eager_peak_gb": e["peak"] / 1e9}


def train_restart(dev: torch.device) -> None:
    """``train_loop`` at smoke size on the card with a fault injected at
    step 7 and a checkpoint every 3 steps: it restores step 6 and runs to
    the end; then a fresh run resumes from the last checkpoint."""
    cfg = get_smoke_config("llama3_2_3b")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    with tempfile.TemporaryDirectory() as d:
        run = lm_train.build_run(cfg, "adamw-fast", seed=SEED, device=dev)
        run, hist = lm_train.train_loop(run, stream, 10, ckpt_dir=d,
                                        ft=FTConfig(checkpoint_every=3, max_restarts=1),
                                        injector=FaultInjector({7}), log_every=1000)
        steps_run = [h["step"] for h in hist]
        require(run.step == 10 and steps_run == list(range(7)) + list(range(6, 10)),
                f"train restart: steps {steps_run}")
        require(store.latest_step(d) == 10, f"train restart: latest {store.latest_step(d)}")
        again = lm_train.build_run(cfg, "adamw-fast", seed=SEED + 1, device=dev)
        again, more = lm_train.train_loop(again, stream, 12, ckpt_dir=d,
                                          ft=FTConfig(checkpoint_every=3), log_every=1000)
        require([h["step"] for h in more] == [10, 11], "train restart: cold resume")
        require(next(again.params.parameters()).device.type == dev.type, "train restart: device")
    say(f"train: train_loop on the card ({cfg.name}): fault at step 7 restored step 6 and ran "
        f"to step 10 (steps {steps_run}); a fresh run resumed at step 10; losses "
        f"{hist[0]['loss']:.4f} -> {more[-1]['loss']:.4f}")


def train_phase(dev: torch.device, smi: str) -> dict:
    """The LM training path: every smoke arch and stablelm-3b at full width,
    depth 2 in float32 on the card against the CPU, then stablelm-3b
    trained at full width and depth, the fault-tolerant loop and
    ``examples/torch_train_lm.py``.  No kernel of the port runs here: the
    counts must stay 0."""
    pim_bitserial.reset_launches()
    pim_matmul.reset_launches()
    bf16 = {}
    for i, arch in enumerate(ARCHS):
        cfg = get_smoke_config(arch)  # float32 parameters: one model serves both checks
        model_cpu = lm.init_params(cfg, SEED, "cpu")
        model_card = copy.deepcopy(model_cpu).to(dev)
        bf16[arch] = bf16_train_matches_cpu(arch, cfg, model_cpu, model_card, TRAIN_SMOKE, dev,
                                            SEED + i)
        train_matches_cpu(arch, f32_config(cfg), model_cpu, model_card, TRAIN_SMOKE, dev,
                          SEED + i)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
    model_card = lm.init_params(cfg, SEED, dev)
    model_cpu = lm.init_params(cfg, SEED, "meta")
    model_cpu.load_state_dict({k: v.to("cpu", copy=True)
                               for k, v in model_card.state_dict().items()}, assign=True)
    label = f"{cfg.name} depth 2"
    bf16[label] = bf16_train_matches_cpu(label, cfg, model_cpu, model_card, TRAIN_UNIT, dev, SEED)
    train_matches_cpu(label, f32_config(cfg), model_cpu, model_card, TRAIN_UNIT, dev, SEED)
    del model_card, model_cpu
    say(f"train: bf16 card against CPU, worst readings {json.dumps(bf16)}")

    result = train_timed(dev, smi)
    train_restart(dev)
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", os.path.join(ROOT, "examples", "torch_train_lm.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    hist = example.main(["--device", str(dev)])
    losses = [h["loss"] for h in hist]
    require(np.mean(losses[-10:]) < np.mean(losses[:10]),
            "examples/torch_train_lm.py: the loss did not go down")
    say(f"train: examples/torch_train_lm.py on the card: {len(hist)} steps, loss "
        f"{np.mean(losses[:10]):.4f} -> {np.mean(losses[-10:]):.4f} (means of the first and "
        f"last 10), {np.mean([h['time_s'] for h in hist]) * 1e3:.1f} ms a step")
    torch.cuda.synchronize()
    launches = {**pim_bitserial.LAUNCHES,
                **{f"pim_matmul/{k}": v for k, v in pim_matmul.LAUNCHES.items()}}
    say(f"train: the port's kernel launches in the train phase {launches}")
    require(not any(launches.values()), "the train phase launched a kernel of the port")
    return {**result, "smoke_bf16_worst": bf16}


def scaleout_mesh_runs(dev: torch.device, mesh) -> dict:
    """(a) Every smoke arch served greedily through ``ServeEngine.build(...,
    mesh=mesh)``, compiled (prefill and decode captured on static DTensor
    inputs) and eager (``compile=False``), equals the meshless compiled
    engine token for token, with the host's launches a ``generate`` of each;
    ``SCALE_TRAIN_STEPS`` AdamW steps of stablelm-3b at full width, depth 2
    (float32) through ``build_run(..., mesh=mesh)``, compiled and eager,
    agree with the meshless compiled run, with the host's launches of one
    more step of each."""
    from torch.distributed.tensor import DTensor

    modes = (("meshless", None, True), ("mesh", mesh, True), ("mesh eager", mesh, False))
    engines = {name: [] for name, _, _ in modes}
    for i, arch in enumerate(ARCHS):
        cfg = get_smoke_config(arch)
        tokens, cross = serve_inputs(cfg, SERVE_SMOKE[:2], SEED + i)
        B, P = tokens.shape
        request = (tokens.numpy(), SERVE_SMOKE[2], None if cross is None else cross.numpy())
        outs = {}
        for name, m, compile in modes:
            engine = ServeEngine.build(cfg, P + SERVE_SMOKE[2], seed=SEED, device=dev, mesh=m,
                                       compile=compile)
            outs[name] = engine.generate(request[0], request[1], temperature=0.0,
                                         cross_embeds=request[2])
            engines[name].append((engine, request))
            require(engine.compiled == compile, f"scale-out serve {arch} {name}: compiled "
                    f"{engine.compiled}")
        graphs = engines["mesh"][-1][0].graphs
        require(sorted(k[0] for k in graphs) == ["decode", "prefill"] and all(
            isinstance(g.tokens, DTensor) for g in graphs.values()),
            f"scale-out serve {arch}: the mesh engine's graphs {list(graphs)}")
        for name in ("mesh", "mesh eager"):
            require(np.array_equal(outs[name], outs["meshless"]),
                    f"scale-out serve {arch}: tokens on the mesh ({name}) "
                    f"{outs[name][:, P:].tolist()} != meshless {outs['meshless'][:, P:].tolist()}")
    serve_launches = {}
    for name in ("mesh", "mesh eager"):  # the second request of each engine: captured already
        serve_launches[name] = device_busy(lambda: [  # noqa: B023
            e.generate(r[0], r[1], temperature=0.0, cross_embeds=r[2])
            for e, r in engines[name]], 1)[3] / len(ARCHS)
    del engines
    say(f"scale-out: ServeEngine on the 1x1 mesh, compiled and eager: greedy tokens equal to "
        f"the meshless engine's for all {len(ARCHS)} smoke archs ({SERVE_SMOKE[0]} prompts of "
        f"{SERVE_SMOKE[1]}, {SERVE_SMOKE[2]} tokens: a prefill and {SERVE_SMOKE[2] - 1} decode "
        f"steps); host launches a generate (sampling and copies included), mean over the "
        f"archs: compiled {serve_launches['mesh']:.1f}, eager {serve_launches['mesh eager']:.1f}")
    cfg = f32_config(dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2))
    batches = [train_batch(cfg, TRAIN_UNIT, SEED + i, dev) for i in range(SCALE_TRAIN_STEPS + 1)]
    results, train_launches = {}, {}
    for name, m, compile in modes:
        run = lm_train.build_run(cfg, "adamw", seed=SEED, device=dev, mesh=m, compile=compile)
        require(isinstance(run.step_fn, GraphedTrainStep) == compile,
                f"scale-out train {name}: build_run's step {run.step_fn!r}")
        losses = []
        for batch in batches[:-1]:
            _, run.opt_state, metrics = run.step_fn(run.params, run.opt_state, dict(batch))
            losses.append(float(metrics["loss"]))
        params = {k: (v.full_tensor() if m is not None else v).detach().clone()
                  for k, v in run.params.state_dict().items()}
        results[name] = (losses, params)
        if name != "meshless":
            train_launches[name] = device_busy(
                lambda: run.step_fn(run.params, run.opt_state, dict(batches[-1])), 1)[3]  # noqa: B023
        del run, params
    l0, p0 = results.pop("meshless")
    errs = {}
    for name, (l1, p1) in results.items():
        loss_err = max(abs(a - b) / abs(a) for a, b in zip(l0, l1))
        require(loss_err <= TRAIN_LOSS_RTOL, f"scale-out train {name}: losses {l1} against {l0}")
        param_err = max(float((p1[k] - v).abs().max() / v.abs().max().clamp(min=1e-30))
                        for k, v in p0.items())
        require(param_err <= SCALE_PARAM_TOL,
                f"scale-out train {name}: parameters off by {param_err}")
        errs[name] = (loss_err, param_err)
        say(f"scale-out: build_run on the 1x1 mesh ({name}), {cfg.name} at full width, depth 2, "
            f"float32: {SCALE_TRAIN_STEPS} AdamW steps on {TRAIN_UNIT[0]}x{TRAIN_UNIT[1]} "
            f"tokens, losses {', '.join(f'{x:.6f}' for x in l1)} against meshless compiled "
            f"{', '.join(f'{x:.6f}' for x in l0)} (worst {loss_err:.2e} relative, bound "
            f"{TRAIN_LOSS_RTOL}); parameters within {param_err:.2e} of their largest (bound "
            f"{SCALE_PARAM_TOL}); {train_launches[name]:.0f} host launches a step")
    del results, p0
    torch.cuda.empty_cache()
    return {"train_loss_rel_err": errs["mesh"][0], "train_param_err": errs["mesh"][1],
            "eager_train_loss_rel_err": errs["mesh eager"][0],
            "eager_train_param_err": errs["mesh eager"][1],
            "serve_host_launches": serve_launches["mesh"],
            "eager_serve_host_launches": serve_launches["mesh eager"],
            "train_host_launches": train_launches["mesh"],
            "eager_train_host_launches": train_launches["mesh eager"]}


def scaleout_compression(dev: torch.device, mesh, smi: str) -> dict:
    """(b) ``compressed_psum_mean`` over every gradient leaf of stablelm-3b
    at full width (seeded normal values in each parameter's shape), leaf by
    leaf over the mesh's data group, timed by CUDA events beside the bytes
    bound; the largest leaf on the card equals the same leaf on the CPU (a
    gloo group of this one rank) bit for bit."""
    cfg = get_config(TRAIN_ARCH)
    shapes = lm_steps.param_shapes(cfg)
    group = mesh.get_group("data")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total_ms, n = 0.0, 0
    largest = max(shapes, key=lambda k: shapes[k].numel())
    for name, shape in shapes.items():
        g = torch.randn(shape.shape, generator=gen, device=dev)
        err = torch.zeros_like(g)
        if n == 0:
            compression.compressed_psum_mean(g, err, group)  # warm-up
        torch.cuda.synchronize()
        start.record()
        mean, new_err = compression.compressed_psum_mean(g, err, group)
        end.record()
        end.synchronize()
        total_ms += start.elapsed_time(end)
        n += g.numel()
        require(bool(torch.isfinite(mean).all()), f"compression {name}: non-finite mean")
        if name == largest:
            cpu_group = dist.new_group([0], backend="gloo")
            mean_cpu, err_cpu = compression.compressed_psum_mean(g.cpu(), err.cpu(), cpu_group)
            require(torch.equal(mean.cpu(), mean_cpu) and torch.equal(new_err.cpu(), err_cpu),
                    f"compression {name}: the card differs from the CPU")
            rel = float((mean - g).abs().max() / g.abs().max())
        del g, err, mean, new_err
    require(n == cfg.param_count(), f"compression: {n} elements, not {cfg.param_count()}")
    bound = COMPRESS_BYTES * n / HBM_BYTES_PER_S * 1e3
    say(f"scale-out: compressed_psum_mean over {len(shapes)} gradient leaves of {cfg.name} "
        f"({n} float32 elements) on the data group of one NCCL rank: {total_ms:.3f} ms by CUDA "
        f"events, bound {bound:.3f} ms ({COMPRESS_BYTES} B an element at 3.35 TB/s) -> "
        f"{bound / total_ms:.1%} of the bound; largest leaf {largest} "
        f"{tuple(shapes[largest].shape)} bit-equal to the CPU's, its int8 round trip within "
        f"{rel:.2e} of its largest ({smi})")
    return {"compress_ms": total_ms, "compress_bound_ms": bound, "elements": n}


def scaleout_dryrun() -> dict:
    """(c) The dry run of ``DRYRUN_CELLS`` on the 16x16 fake mesh, each cell
    in a process of its own (the fake group is that process's default
    group), then the roofline table and the offload report from the
    records."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                               "--shape", shape, "--out", DRYRUN_DIR], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for arch, shape in DRYRUN_CELLS]
    try:
        outs = [proc.communicate(timeout=600)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for (arch, shape), proc, out in zip(DRYRUN_CELLS, procs, outs):
        ok = [line for line in out.splitlines() if line.startswith("OK")]
        require(proc.returncode == 0 and len(ok) == 1, f"dry run {arch} x {shape}: {out[-2000:]}")
        say(f"scale-out: dry run {ok[0]}")
    rows = torch_roofline_table.run(DRYRUN_DIR)
    require(len(rows) == len(DRYRUN_CELLS), f"roofline table: {rows}")
    for r in rows:
        say("scale-out: roofline (modeled, H100 data-sheet peaks) " + json.dumps(r))
    spec = importlib.util.spec_from_file_location(
        "torch_pim_offload_report", os.path.join(ROOT, "examples", "torch_pim_offload_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    verdicts = report.main([DRYRUN_DIR])
    require(len(verdicts) == len(DRYRUN_CELLS), "offload report: a record is missing")
    return {r["name"]: r["dominant"] for r in rows}


def scaleout_phase(dev: torch.device, smi: str) -> dict:
    """The scale-out path on the card: a mesh of one NCCL rank
    (``make_host_mesh()``), the sharded serving engine and train step
    against the meshless ones, the int8 compressed all-reduce at
    stablelm-3b's full width, and the dry run with its roofline table and
    offload report.  No kernel of the port runs here: the counts must stay
    0."""
    pim_bitserial.reset_launches()
    pim_matmul.reset_launches()
    mesh = make_host_mesh(device=dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    require(dist.get_backend() == backend and tuple(mesh.shape) == (1, 1),
            f"make_host_mesh(): {dist.get_backend()} {mesh}")
    result = scaleout_mesh_runs(dev, mesh)
    result.update(scaleout_compression(dev, mesh, smi))
    result["dryrun_dominant"] = scaleout_dryrun()
    dist.destroy_process_group()
    torch.cuda.synchronize()
    launches = {**pim_bitserial.LAUNCHES,
                **{f"pim_matmul/{k}": v for k, v in pim_matmul.LAUNCHES.items()}}
    say(f"scale-out: the port's kernel launches in the scale-out phase {launches}")
    require(not any(launches.values()), "the scale-out phase launched a kernel of the port")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    started = time.perf_counter()
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
    conv_c = {basis: conv.PROGRAM.compiled(basis) for basis in ("memristive", "dram")}
    for c in (f32_mem, f32_dram, int8_c, add_c, *conv_c.values()):
        pim_bitserial.register_compiled(c)
    require(pim_bitserial.resolve_mode(f32_mem) == "loop"
            and pim_bitserial.resolve_mode(f32_dram) == "loop", "f32 MAC auto mode")
    require(all(pim_bitserial.resolve_mode(c) == "loop" for c in conv_c.values()),
            "nine-tap auto mode")
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
    pim_bitplanes.reset_launches()
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
    packing = dict(pim_bitplanes.LAUNCHES)
    say(f"main path: launches {launches}, packing {packing}; f32 MAC on both bases "
        f"{f32_s:.2f} s wall (first calls, including plane packing)")
    require(packing == {"bitplane_pack": 2 * 3 + 3 + 2, "bitplane_unpack": 2 + 1 + 1},
            f"packing kernel launches in the main path: {packing}")
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
    conv_in = {n: conv_planes(n, dev) for n in CONV_ROWS}
    cases += [(f"nine-tap conv {basis}, {n} rows", "bitserial_loop", c, planes, "loop")
              for basis, c in conv_c.items() for n, planes in conv_in.items()]
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
        pim_bitserial.reset_launches()
        out, ref = run(), plain()
        torch.cuda.synchronize()
        err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max().item())
        require(torch.equal(out, ref), f"{kernel} differs from its plain version on {label}")
        n_seg = len(segments) if mode == "unrolled" else 1
        case_launches = dict(pim_bitserial.LAUNCHES)
        require(case_launches[kernel] == n_seg and sum(case_launches.values()) == n_seg,
                f"launches of one call on {label}: {case_launches}")
        ms = cuda_ms(run, TIMED_LAUNCHES)
        plain_ms = cuda_ms(plain, PLAIN_REPS)
        words = planes.shape[1]
        bms, by = bound_ms(compiled, words, int32_ops_per_s)
        earlier = (f"; {PERF_MD_FIRST_LOOP}: {PERF_MD_FIRST_LOOP_MS[label]} ms"
                   if label in PERF_MD_FIRST_LOOP_MS else "")
        block, geometry = "", {}
        if mode == "loop":  # one block an SM: its live state fills the shared memory
            table = pim_bitserial._loop_table(key, planes.device)
            warps = table.words / pim_bitserial.LOOP_WORDS_PER_THREAD / 32
            # Each row is a gate or a stage pad, a one-row group of its own.
            real = table.groups - (table.rows.shape[0] - compiled.num_gates)
            geometry = {"state_cols": table.state_cols, "words": table.words,
                        "warps_per_sm": warps, "groups": table.groups, "real_groups": real}
            block = (f", live state {table.state_cols} cols, {table.words} words a block "
                     f"({warps:g} warps an SM), {table.groups} groups ({real} without "
                     f"stage pads, {compiled.num_gates / real:.2f} gates a group)")
            if label.startswith("nine-tap conv"):
                require(table.words >= 256, f"{table.words} words a block on {label}")
            program = PROGRAM_ORDER_GROUPS.get(label.split(",")[0])
            if program:
                require(real <= GROUPS_SHARE * program,
                        f"{real} groups on {label}, program order's {program}")
        say(f"kernel {kernel} on {label}: {compiled.num_gates} gates, {compiled.num_cols} "
            f"cols{block}, {n_seg} launch(es)/call, W={words} words: equal to plain "
            f"(max_abs_err {err}); {ms:.4f} ms/call, bound {bms:.4f} ms ({by}), "
            f"plain {plain_ms:.2f} ms{earlier}")
        results.append(dict(label=label, kernel=kernel, err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bms, bound_by=by, **geometry))

    native_ms = cuda_ms(lambda: xd * yd + zd, TIMED_LAUNCHES)
    say(f"yardstick (the paper's GPU side, not a version of either kernel): "
        f"native f32 x*y then +z on {N} unpacked elements: {native_ms:.4f} ms")
    del cases, conv_in, planes, out, ref
    torch.cuda.empty_cache()
    conv_launches = conv_phase(dev)
    pack_results = packing_phase(dev)

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
    t0 = time.perf_counter()
    serve_phase(dev, smi)
    say(f"serve: phase took {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    trained = train_phase(dev, smi)
    say(f"train: phase took {time.perf_counter() - t0:.1f} s wall; summary "
        f"{json.dumps(trained)}")
    t0 = time.perf_counter()
    scaled = scaleout_phase(dev, smi)
    say(f"scale-out: phase took {time.perf_counter() - t0:.1f} s wall; summary "
        f"{json.dumps(scaled)}")

    sources = {  # name: (source, TPU kernel, library, kernel symbol, reported case)
        "bitserial_loop": ("src/repro_torch/kernels/csrc/bitserial_loop.cu",
                           "src/repro/kernels/pim_bitserial.py:93",
                           _build.library_path(*pim_bitserial.build_jobs()[0]),
                           "bitserial_loop_kernel", "f32 MAC memristive"),
        "bitserial_unrolled": ("src/repro_torch/kernels/bitserial_codegen.py",
                               "src/repro/kernels/pim_bitserial.py:233",
                               _build.library_path(*pim_bitserial.build_jobs([int8_c.key])[-1]),
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
    loop_source, loop_replaces, loop_lib, loop_symbol, _ = sources["bitserial_loop"]
    for r in results:
        if not r["label"].startswith("nine-tap conv"):
            continue
        line.append({
            "name": "bitserial_loop", "route": "cuda", "source": loop_source,
            "replaces": loop_replaces, "launches": conv_launches["bitserial_loop"],
            "pack_launches": {k: conv_launches[k] for k in ("bitplane_pack", "bitplane_unpack")},
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "case": r["label"], "state_cols": r["state_cols"], "words": r["words"],
            "groups": r["groups"], **kernel_resources(loop_lib, loop_symbol),
        })
    pack_lib = _build.library_path(*pim_bitplanes.build_job())
    for r in pack_results:
        if r["label"].startswith("f32"):
            line.append({
                "name": r["kernel"], "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/bitplanes.cu", "replaces": None,
                "launches": packing[r["kernel"]], "max_abs_err": 0, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "case": r["label"],
                **kernel_resources(pack_lib, f"{r['kernel']}_kernel"),
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
    say(f"chip_smoke: {time.perf_counter() - started:.1f} s wall from the first check to here")
    say(smi)
    say(json.dumps({"kernels": line}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
