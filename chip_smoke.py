"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds every kernel from this checkout's sources with ``nvcc`` (sm_90a),
all at once: both bit-serial executors and the MatPIM matmul.  Runs
``repro_torch.pim.compile(lambda a, b, c: a*b+c)`` on CUDA tensors of 2^24
elements — the f32 MAC on the loop kernel on both bases, the int8 MAC and
a 32-bit fixed add on the straight-line kernel — and checks every result
bit for bit against numpy.  Then it holds each bit-serial kernel against
its plain PyTorch version word for word (including the 13-segment
straight-line f32 MAC) and times each with CUDA events beside its bound.
The matmul phase drives the paper's Fig 5 benchmark
(``benchmarks/torch_fig5_matmul.run()``) on the card, then holds the
matmul kernel against its plain version at every Fig 5 size in float32
and bfloat16 (each operand 2^26 elements) and times it beside its bound,
its plain version and ``torch.bmm``.  It prints one JSON line of kernels
and, last, ``{"ok": true, "device": {...}}``.  Any failed check raises;
nothing falls back to the CPU or to a plain version.  Imports nothing of
JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import repro_torch.pim as pim  # noqa: E402
from benchmarks import torch_fig5_matmul  # noqa: E402
from repro_torch.kernels import _build, ops, pim_bitserial, pim_matmul  # noqa: E402

N = 1 << 24
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64  # Hopper white paper: 32-bit logic ops per SM per clock
FP32_LANES_PER_SM = 128  # Hopper white paper: FP32 FMAs per SM per clock
BF16_TENSOR_FLOPS = 989e12  # H100 SXM data sheet, dense bf16
MATMUL_ELEMS = 1 << 26  # elements per matmul operand in the kernel checks
MATMUL_TOL = {torch.float32: (2e-4, 1.6e-3), torch.bfloat16: (2e-2, 0.16)}
MATMUL_MAIN_CASE = "f32 n=512"
TIMED_LAUNCHES = 20
PLAIN_REPS = 2

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


def matmul_phase(dev: torch.device, fp32_flops: float) -> tuple[int, list[dict]]:
    """Drive the Fig 5 benchmark on the card, then hold the matmul kernel
    against its plain version at every Fig 5 size in float32 and bfloat16
    and time it beside its bound and ``torch.bmm``.  Returns the kernel's
    launches in the benchmark run and one result per case."""
    pim_matmul.reset_launches()
    rows = torch_fig5_matmul.run()
    torch.cuda.synchronize()
    mm_launches = pim_matmul.LAUNCHES["pim_matmul"]
    say(f"matmul path: benchmarks/torch_fig5_matmul.run() launches {mm_launches}")
    require(mm_launches > 0, "the Fig 5 benchmark did not launch the matmul kernel")
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

    gen = torch.Generator(device=dev).manual_seed(SEED)
    a, b = (torch.randn((2, 128, 128), generator=gen, device=dev) for _ in range(2))
    say(f"matmul path: the Fig 5 timed instance [2,128,128] f32 back to back: "
        f"{cuda_ms(lambda: ops.pim_matmul_op(a, b), 100):.4f} ms per call over 100 calls")
    results = []
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for n in torch_fig5_matmul.SIZES:
            g = MATMUL_ELEMS // (n * n)
            a = torch.randn((g, n, n), generator=gen, device=dev).to(dtype)
            b = torch.randn((g, n, n), generator=gen, device=dev).to(dtype)
            run = lambda: pim_matmul.matmul(a, b)  # noqa: E731
            plain = lambda: pim_matmul.matmul_plain(a, b)  # noqa: E731
            out, ref = run(), plain()
            torch.cuda.synchronize()
            require(out.shape == (g, n, n) and out.dtype == dtype, f"matmul {dname} n={n} shape")
            diff = (out.float() - ref.float()).abs()
            err = float(diff.max().item())
            rtol, atol = MATMUL_TOL[dtype]
            require(bool(torch.isfinite(out.float()).all().item()),
                    f"matmul {dname} n={n} non-finite")
            require(bool((diff <= atol + rtol * ref.float().abs()).all().item()),
                    f"matmul kernel differs from its plain version, {dname} n={n}: "
                    f"max_abs_err {err}")
            del out, ref, diff
            ms = cuda_ms(run, 10)
            plain_ms = cuda_ms(plain, 3)
            library_ms = cuda_ms(lambda: torch.bmm(a, b), 10)
            ops_ms = 2 * g * n**3 / (fp32_flops if dtype == torch.float32
                                      else BF16_TENSOR_FLOPS) * 1e3
            bytes_ms = 3 * g * n * n * a.element_size() / HBM_BYTES_PER_S * 1e3
            bms, by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
            label = f"{dname} n={n}"
            say(f"kernel pim_matmul on {label} (G={g}): equal to plain within rtol "
                f"{rtol} atol {atol} (max_abs_err {err:.3g}); {ms:.4f} ms/call, bound "
                f"{bms:.4f} ms ({by}), plain {plain_ms:.4f} ms, torch.bmm {library_ms:.4f} ms")
            results.append(dict(label=label, err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by, library_ms=library_ms))
            del a, b
    return mm_launches, results


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
        say(f"kernel {kernel} on {label}: {compiled.num_gates} gates, {compiled.num_cols} "
            f"cols, {n_seg} launch(es)/call, W={words} words: equal to plain "
            f"(max_abs_err {err}); {ms:.4f} ms/call, bound {bms:.4f} ms ({by}), "
            f"plain {plain_ms:.2f} ms")
        results.append(dict(label=label, kernel=kernel, err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bms, bound_by=by))

    native_ms = cuda_ms(lambda: xd * yd + zd, TIMED_LAUNCHES)
    say(f"yardstick (the paper's GPU side, not a version of either kernel): "
        f"native f32 x*y then +z on {N} unpacked elements: {native_ms:.4f} ms")

    mm_launches, mm_results = matmul_phase(dev, fp32_flops)

    sources = {
        "bitserial_loop": ("src/repro_torch/kernels/csrc/bitserial_loop.cu",
                           "src/repro/kernels/pim_bitserial.py:93"),
        "bitserial_unrolled": ("src/repro_torch/kernels/bitserial_codegen.py",
                               "src/repro/kernels/pim_bitserial.py:233"),
    }
    main_case = {"bitserial_loop": "f32 MAC memristive",
                 "bitserial_unrolled": "int8 MAC memristive"}
    line = []
    for name, (source, replaces) in sources.items():
        r = next(r for r in results if r["label"] == main_case[name])
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(
                q["err"] for q in results if q["kernel"] == name),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "case": r["label"],
        })
    r = next(r for r in mm_results if r["label"] == MATMUL_MAIN_CASE)
    line.append({
        "name": "pim_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pim_matmul.cu",
        "replaces": "src/repro/kernels/pim_matmul.py:31", "launches": mm_launches,
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "case": r["label"],
    })
    say(smi)
    say(json.dumps({"kernels": line}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
