"""Paper Fig 6 on the PyTorch/CUDA port: full-precision CNN inference — PIM
upper bound against a GPU.

Methodology as the paper's §5: the PIM number counts only the matmul/conv
MACs (an upper bound); the GPU side is a step measured on the card.  Each
model (AlexNet, GoogLeNet, ResNet-50, ``repro_torch.models.cnn``) runs one
step of ``BATCH`` = 8 images at 224×224 in float32: ``us_per_call`` is the
median CUDA-event time of that step (``torch_common.time_fn``).  Inference
runs under ``torch.inference_mode()``; training (Fig 7) runs forward and
backward of ``(out**2).mean()`` with respect to every parameter.  TF32 is off
in cuBLAS and cuDNN for the run (the paper's full precision); convolutions go
through ``F.conv2d`` (cuDNN), as the reference's go through
``lax.conv_general_dilated`` outside any Pallas kernel.

FLOPs and bytes come from ``cnn.step_cost`` (``FlopCounterMode`` full-tap
FLOPs; analytic fp32 bytes with fused elementwise ops, the definition in
``repro_torch.models.cnn``).  The reference's ``tpu_imgs_per_s`` becomes
``h100_imgs_per_s``: ``BATCH / max(flops / H100.peak_fp32, bytes /
H100.mem_bw)``, the H100's fp32 roofline from its data sheet.

    PYTHONPATH=src python -m benchmarks.torch_fig6_cnn_infer [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib

import torch

from repro_torch.core.analyzer import Workload, pim_time
from repro_torch.core.costmodel import A6000, H100, MEMRISTIVE_PIM
from repro_torch.models import cnn
from repro_torch.pim.frontend import resolve_device

from .torch_common import emit, time_fn

BATCH = 8
IMG = 224
NAMES = ("alexnet", "googlenet", "resnet50")


@contextlib.contextmanager
def full_precision():
    """float32 products without TF32 in cuBLAS and cuDNN, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def make_step(name: str, train: bool, device):
    """One inference (or training, ``train``) step of ``BATCH`` zero images
    on ``device``, as a callable, with the model's parameters made from the
    default seed."""
    model = cnn.MODELS[name](device=device).train(train)
    x = torch.zeros((BATCH, 3, IMG, IMG), device=device)
    if train:
        params = list(model.parameters())

        def step():
            return torch.autograd.grad((model(x) ** 2).mean(), params)
    else:
        def step():
            with torch.inference_mode():
                return model(x)
    return step


def _measure(name: str, train: bool = False, device=None) -> tuple[float, float, float]:
    """(FLOPs, bytes, µs) of one step of ``BATCH`` images."""
    device = resolve_device(device)
    flops, bytes_ = cnn.step_cost(name, BATCH, IMG, train)
    with full_precision():
        us = time_fn(make_step(name, train, device), device=device, warmup=2, iters=5)
    return flops, bytes_, us


def run(train: bool = False, device=None) -> list[dict]:
    rows = []
    for name in NAMES:
        flops, bytes_, us = _measure(name, train=train, device=device)
        w = Workload(name, flops=flops, hbm_bytes=bytes_)
        t_pim = pim_time(w)  # matmul/conv MACs only — paper's upper bound
        t_gpu_comp = flops / A6000.peak_fp32
        t_gpu_mem = bytes_ / A6000.mem_bw
        t_gpu = max(t_gpu_comp, t_gpu_mem)
        t_h100 = max(flops / H100.peak_fp32, bytes_ / H100.mem_bw)
        tag = "fig7" if train else "fig6"
        rows.append({
            "name": f"{tag}/{name}",
            "us_per_call": f"{us:.0f}",
            "flops_per_batch": f"{flops:.3g}",
            "reuse_flops_per_byte": f"{flops/bytes_:.1f}",
            "pim_imgs_per_s": f"{BATCH/t_pim:.1f}",
            "gpu_exp_imgs_per_s": f"{BATCH/t_gpu:.1f}",
            "gpu_theo_imgs_per_s": f"{BATCH/t_gpu_comp:.1f}",
            "h100_imgs_per_s": f"{BATCH/t_h100:.1f}",
            "pim_beats_gpu": str(t_pim < t_gpu),
            "pim_eff_imgs_per_j": f"{BATCH/t_pim/MEMRISTIVE_PIM.max_power_w:.2f}",
            "gpu_eff_imgs_per_j": f"{BATCH/t_gpu/A6000.max_power_w:.2f}",
        })
    return rows


def device_from_argv(argv=None):
    p = argparse.ArgumentParser(description="ConvPIM CNN benchmark (PyTorch/CUDA port)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card)")
    return p.parse_args(argv).device


def main(argv=None):
    emit(run(train=False, device=device_from_argv(argv)))


if __name__ == "__main__":
    main()
