"""The paper's CNN benchmark models (§5): AlexNet, GoogLeNet, ResNet-50.

``nn.Module``s in NCHW with the reference's exact topology (not
torchvision's): no LRN, dropout or auxiliary heads; ResNet-50 v1 with the
stride on the 1×1 ``conv1``; AlexNet flattens its features in (h, w, c)
order.  ``"SAME"`` padding is computed per dimension the way XLA computes it
(``total = max((ceil(n/s)-1)·s + k - n, 0)``, ``low = total // 2``), so a
stride above 1 pads asymmetrically; max-pools pad with ``-inf``.  Batch norm
follows the reference: in training mode it normalises with the batch's mean
and biased variance over (N, H, W), eps 1e-5, and updates nothing; in eval
mode it uses the stored ``mean`` and ``var``.  ``model.train()`` /
``model.eval()`` select the mode.

Every parameter is drawn from an explicit ``torch.Generator`` (default seed
0) on the CPU and moved to ``device`` (``None`` = the CUDA card).  The
parameter names mirror the reference's parameter tree, so
``repro_torch.convert.cnn_state_dict`` maps one onto the other.

Accounting (:func:`step_cost`, :func:`model_flops`):

* **FLOPs** come from ``torch.utils.flop_counter.FlopCounterMode`` over the
  step, run on the ``meta`` device (shapes only).  It counts every tap of a
  convolution, padding included, and every matrix product; the analytic
  :class:`FlopCounter` totals over the layers equal it for a forward pass.
* **Bytes** are counted analytically in fp32 (4 bytes an element).  Each
  conv, linear and max-pool call reads its input once and its weight once
  and writes its output once; bias, batch norm, ReLU, the residual add and
  concatenation count as fused into their producer.  A training step adds,
  for each such layer, a read of the output gradient, the input and the
  weight and a write of the input gradient and the weight gradient — except
  the first layer's input gradient, which no step computes.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.pim.frontend import resolve_device

FP32_BYTES = 4
BN_EPS = 1e-5

# ---------------------------------------------------------------- primitives


def same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's ``"SAME"`` for a dimension of ``n``."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, k: int, stride: int, padding) -> tuple[int, int, int, int]:
    """``F.pad`` order (left, right, top, bottom) for ``"SAME"``,
    ``"VALID"`` or a symmetric int."""
    if padding == "SAME":
        return same_pad(x.shape[3], k, stride) + same_pad(x.shape[2], k, stride)
    p = 0 if padding == "VALID" else int(padding)
    return p, p, p, p


def _normal(shape, std: float, generator: torch.Generator, device: torch.device):
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return (torch.randn(shape, generator=generator) * std).to(device)


class BatchNorm(nn.Module):
    """The reference's batch norm: ``scale``, ``bias`` (parameters) and
    ``mean``, ``var`` (buffers, used in eval mode only)."""

    def __init__(self, c: int, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x):
        if self.training:
            return F.batch_norm(x, None, None, self.scale, self.bias,
                                training=True, eps=BN_EPS)
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                            training=False, eps=BN_EPS)


class Conv(nn.Module):
    """k×k convolution, weight ``[cout, cin, k, k]`` drawn N(0, 2/fan_in),
    with a zero bias or a following batch norm (``bn``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding="SAME",
                 bias: bool = True, bn: bool = False, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding
        self.weight = nn.Parameter(
            _normal((cout, cin, k, k), (2.0 / (k * k * cin)) ** 0.5, generator, device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) if bias else None
        self.bn = BatchNorm(cout, device) if bn else None

    def forward(self, x):
        left, right, top, bottom = _pads(x, self.k, self.stride, self.padding)
        if left == right and top == bottom:
            x = F.conv2d(x, self.weight, self.bias, self.stride, padding=(top, left))
        else:
            x = F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight, self.bias,
                         self.stride)
        return x if self.bn is None else self.bn(x)


class Linear(nn.Module):
    """Fully connected layer, weight ``[cout, cin]`` drawn N(0, 1/cin), zero
    bias."""

    def __init__(self, cin: int, cout: int, *, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(_normal((cout, cin), cin ** -0.5, generator, device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class MaxPool(nn.Module):
    def __init__(self, k: int, stride: int, padding="VALID"):
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding

    def forward(self, x):
        left, right, top, bottom = _pads(x, self.k, self.stride, self.padding)
        if left == right and top == bottom:
            return F.max_pool2d(x, self.k, self.stride, padding=(top, left))
        return F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")),
                            self.k, self.stride)


def _setup(device, generator) -> tuple[torch.device, torch.Generator]:
    return resolve_device(device), generator or torch.Generator().manual_seed(0)


# ------------------------------------------------------------------ AlexNet

ALEXNET = [  # (k, cout, stride, pool_after)
    (11, 96, 4, True), (5, 256, 1, True), (3, 384, 1, False),
    (3, 384, 1, False), (3, 256, 1, True),
]


class AlexNet(nn.Module):
    def __init__(self, n_classes: int = 1000, *, device=None, generator=None):
        super().__init__()
        device, gen = _setup(device, generator)
        kw = dict(device=device, generator=gen)
        self.conv = nn.ModuleList()
        cin = 3
        for k, cout, s, _ in ALEXNET:
            self.conv.append(Conv(cin, cout, k, s, padding="SAME" if k != 11 else 2, **kw))
            cin = cout
        self.pool = MaxPool(3, 2)
        self.fc = nn.ModuleList([Linear(256 * 6 * 6, 4096, **kw), Linear(4096, 4096, **kw),
                                 Linear(4096, n_classes, **kw)])

    def forward(self, x):
        for (_, _, _, pool), conv in zip(ALEXNET, self.conv):
            x = F.relu(conv(x))
            if pool:
                x = self.pool(x)
        x = x.permute(0, 2, 3, 1).flatten(1)  # (h, w, c), the reference's order
        for i, fc in enumerate(self.fc):
            x = fc(x)
            if i < 2:
                x = F.relu(x)
        return x


# ----------------------------------------------------------------- ResNet50

RESNET50_STAGES = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2), (3, 512, 2048, 2)]


class Bottleneck(nn.Module):
    """ResNet v1 bottleneck: the stride sits on the 1×1 ``conv1``."""

    def __init__(self, cin: int, mid: int, cout: int, stride: int, proj: bool, **kw):
        super().__init__()
        self.conv1 = Conv(cin, mid, 1, stride, bias=False, bn=True, **kw)
        self.conv2 = Conv(mid, mid, 3, bias=False, bn=True, **kw)
        self.conv3 = Conv(mid, cout, 1, bias=False, bn=True, **kw)
        self.proj = Conv(cin, cout, 1, stride, bias=False, bn=True, **kw) if proj else None

    def forward(self, x):
        h = F.relu(self.conv1(x))
        h = F.relu(self.conv2(h))
        h = self.conv3(h)
        if self.proj is not None:
            x = self.proj(x)
        return F.relu(x + h)


class ResNet50(nn.Module):
    def __init__(self, n_classes: int = 1000, *, device=None, generator=None):
        super().__init__()
        device, gen = _setup(device, generator)
        kw = dict(device=device, generator=gen)
        self.stem = Conv(3, 64, 7, 2, bias=False, bn=True, **kw)
        self.pool = MaxPool(3, 2, "SAME")
        self.stages = nn.ModuleList()
        cin = 64
        for n_blocks, mid, cout, stride in RESNET50_STAGES:
            blocks = nn.ModuleList()
            for b in range(n_blocks):
                blocks.append(Bottleneck(cin, mid, cout, stride if b == 0 else 1,
                                         proj=b == 0, **kw))
                cin = cout
            self.stages.append(blocks)
        self.fc = Linear(2048, n_classes, **kw)

    def forward(self, x):
        x = self.pool(F.relu(self.stem(x)))
        for blocks in self.stages:
            for block in blocks:
                x = block(x)
        return self.fc(x.mean(dim=(2, 3)))


# ---------------------------------------------------------------- GoogLeNet

# (1x1, 3x3red, 3x3, 5x5red, 5x5, pool_proj) per inception block
INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32), "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64), "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64), "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128), "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


class Inception(nn.Module):
    def __init__(self, cin: int, c1: int, r3: int, c3: int, r5: int, c5: int, pp: int, **kw):
        super().__init__()
        self.b1 = Conv(cin, c1, 1, **kw)
        self.b3r = Conv(cin, r3, 1, **kw)
        self.b3 = Conv(r3, c3, 3, **kw)
        self.b5r = Conv(cin, r5, 1, **kw)
        self.b5 = Conv(r5, c5, 5, **kw)
        self.bp = Conv(cin, pp, 1, **kw)
        self.pool = MaxPool(3, 1, "SAME")

    def forward(self, x):
        b1 = F.relu(self.b1(x))
        b3 = F.relu(self.b3(F.relu(self.b3r(x))))
        b5 = F.relu(self.b5(F.relu(self.b5r(x))))
        bp = F.relu(self.bp(self.pool(x)))
        return torch.cat([b1, b3, b5, bp], dim=1)


class GoogLeNet(nn.Module):
    def __init__(self, n_classes: int = 1000, *, device=None, generator=None):
        super().__init__()
        device, gen = _setup(device, generator)
        kw = dict(device=device, generator=gen)
        self.stem1 = Conv(3, 64, 7, 2, **kw)
        self.stem2 = Conv(64, 64, 1, **kw)
        self.stem3 = Conv(64, 192, 3, **kw)
        self.pool = MaxPool(3, 2, "SAME")
        self.inception = nn.ModuleDict()
        cin = 192
        for name, (c1, r3, c3, r5, c5, pp) in INCEPTION.items():
            self.inception[name] = Inception(cin, c1, r3, c3, r5, c5, pp, **kw)
            cin = c1 + c3 + c5 + pp
        self.fc = Linear(1024, n_classes, **kw)

    def forward(self, x):
        x = self.pool(F.relu(self.stem1(x)))
        x = self.pool(F.relu(self.stem3(F.relu(self.stem2(x)))))
        for name, block in self.inception.items():
            x = block(x)
            if name in ("3b", "4e"):
                x = self.pool(x)
        return self.fc(x.mean(dim=(2, 3)))


MODELS = {"alexnet": AlexNet, "googlenet": GoogLeNet, "resnet50": ResNet50}

# ---------------------------------------------------------------- accounting


@dataclasses.dataclass
class FlopCounter:
    """The reference's analytic count: every tap of a square conv output and
    every weight of a fully connected layer (MAC = 2 FLOPs)."""

    flops: float = 0.0
    weight_bytes: float = 0.0
    act_bytes: float = 0.0

    def conv(self, hw_out, k, cin, cout):
        self.flops += 2.0 * hw_out * hw_out * cout * k * k * cin
        self.weight_bytes += 4.0 * k * k * cin * cout

    def fc(self, cin, cout):
        self.flops += 2.0 * cin * cout
        self.weight_bytes += 4.0 * cin * cout


@dataclasses.dataclass(frozen=True)
class Layer:
    """One conv, linear or max-pool call of a forward pass."""

    kind: str  # "conv", "fc" or "pool"
    in_shape: tuple[int, ...]
    weight_shape: tuple[int, ...]  # () for a pool
    out_shape: tuple[int, ...]

    @property
    def in_elems(self) -> int:
        return math.prod(self.in_shape)

    @property
    def weight_elems(self) -> int:
        return math.prod(self.weight_shape) if self.weight_shape else 0

    @property
    def out_elems(self) -> int:
        return math.prod(self.out_shape)


def _run_counted(name: str, batch: int, img, train: bool) -> tuple[list[Layer], float]:
    """The layers of one step and its FlopCounterMode total, on ``meta``."""
    h, w = (img, img) if isinstance(img, int) else img
    model = MODELS[name](device="meta").train(train)
    layers: list[Layer] = []

    def hook(mod, inputs, out):
        kind = {Conv: "conv", Linear: "fc", MaxPool: "pool"}[type(mod)]
        weight = tuple(mod.weight.shape) if kind != "pool" else ()
        layers.append(Layer(kind, tuple(inputs[0].shape), weight, tuple(out.shape)))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv, Linear, MaxPool))]
    x = torch.empty((batch, 3, h, w), device="meta")
    try:
        with FlopCounterMode(display=False) as counter:
            out = model(x)
            if train:
                torch.autograd.grad((out ** 2).mean(), list(model.parameters()))
    finally:
        for handle in handles:
            handle.remove()
    return layers, float(counter.get_total_flops())


def step_layers(name: str, batch: int = 1, img=224) -> list[Layer]:
    """The conv, linear and max-pool calls of one forward pass, in order."""
    return _run_counted(name, batch, img, train=False)[0]


def step_bytes(layers: list[Layer], train: bool = False) -> float:
    """The fp32 bytes of one step over ``layers`` (see the module docstring)."""
    total = sum(l.in_elems + l.weight_elems + l.out_elems for l in layers)
    if train:
        total += sum(l.out_elems + 2 * l.in_elems + 2 * l.weight_elems for l in layers)
        total -= layers[0].in_elems  # no step computes the image's gradient
    return float(FP32_BYTES * total)


def step_cost(name: str, batch: int, img=224, train: bool = False) -> tuple[float, float]:
    """(FLOPs, bytes) of one inference (or training, ``train``) step of
    ``batch`` images of ``img`` (an int, or (h, w)) pixels."""
    layers, flops = _run_counted(name, batch, img, train)
    return flops, step_bytes(layers, train)


@functools.lru_cache(maxsize=None)
def model_flops(name: str, img: int = 224) -> dict:
    """FLOPs and bytes of a batch-1 forward pass, and the number of stored
    values (parameters and batch-norm statistics), like the reference's."""
    flops, bytes_ = step_cost(name, 1, img)
    model = MODELS[name](device="meta")
    params = sum(t.numel() for t in model.state_dict().values())
    return {"flops": flops, "bytes": bytes_, "params": params}
