"""VGG-16, configuration D (Simonyan & Zisserman, "Very Deep Convolutional
Networks for Large-Scale Image Recognition", arXiv:1409.1556, Table 1
column D), run on the simulated PIM.

Thirteen 3×3 stride-1 pad-1 conv layers of widths 64-64, 128-128,
256-256-256, 512-512-512, 512-512-512, a 2×2 max-pool after each group,
then fully connected layers of 4096, 4096 and 1000.  :data:`CONFIG_D` is
that table as data; batch and image size are arguments (the image a
multiple of 32).  :data:`TINY` has the same pattern at widths of 1 – 2, for
the CPU.

:func:`pim_forward` runs every conv layer through
``repro_torch.pim.conv.conv3x3`` (``Cin`` calls of the nine-tap program
over ``N·H·W·Cout`` rows) and every fully connected layer as f32 MAC waves
through ``repro_torch.pim.compile(lambda a, b, c: a * b + c)``: one wave an
input feature over the ``N·out`` outputs, ``c`` the last wave's result and
the bias at first.  ``repro_torch.models.vgg_reference.forward`` computes
the same sums in the same order in plain PyTorch and equals it bit for bit.

Departures from the published model:

* no dropout: the model runs inference only;
* ReLU and the max-pools run in plain PyTorch on the card between layers;
  they are not simulated on PIM.

Parameters are drawn from an explicit ``torch.Generator`` on the CPU (seed
0 by default), as ``models/cnn.py`` draws them: conv weights He-normal,
N(0, 2/(9·cin)); fully connected weights N(0, 1/cin); every bias zero (the
generator draws none).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

import repro_torch.pim as pim
from repro_torch.pim.conv import conv3x3
from repro_torch.pim.frontend import resolve_device


@dataclasses.dataclass(frozen=True)
class VggConfig:
    groups: tuple[tuple[int, ...], ...]  # conv widths; a 2×2 max-pool after each group
    fc: tuple[int, ...]  # fully connected widths, the last the classes
    in_channels: int = 3


CONFIG_D = VggConfig(groups=((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
                             (512, 512, 512)),
                     fc=(4096, 4096, 1000))
TINY = VggConfig(groups=((1, 1), (2, 2), (1, 1, 1), (2, 2, 2), (2, 2, 2)), fc=(4, 4, 3))


def conv_layers(cfg: VggConfig, image: int) -> list[tuple[int, int, int]]:
    """``(cin, cout, side)`` of each conv layer, ``side`` its square input
    and output."""
    if image % (1 << len(cfg.groups)):
        raise ValueError(f"the image side {image} does not halve {len(cfg.groups)} times")
    layers, cin, side = [], cfg.in_channels, image
    for group in cfg.groups:
        for cout in group:
            layers.append((cin, cout, side))
            cin = cout
        side //= 2
    return layers


def fc_layers(cfg: VggConfig, image: int) -> list[tuple[int, int]]:
    """``(in, out)`` of each fully connected layer."""
    side = image >> len(cfg.groups)
    ins = [cfg.groups[-1][-1] * side * side, *cfg.fc[:-1]]
    return list(zip(ins, cfg.fc))


def conv_waves(cfg: VggConfig, batch: int, image: int) -> list[tuple[int, int]]:
    """``(rows, calls)`` of each conv layer on PIM: ``batch·side²·cout``
    rows a call, one call an input channel."""
    return [(batch * side * side * cout, cin) for cin, cout, side in conv_layers(cfg, image)]


def fc_waves(cfg: VggConfig, batch: int, image: int) -> list[tuple[int, int]]:
    """``(rows, calls)`` of each fully connected layer: ``batch·out`` rows a
    wave, one wave an input feature."""
    return [(batch * out, cin) for cin, out in fc_layers(cfg, image)]


def init_params(cfg: VggConfig, image: int, *, device=None,
                generator: torch.Generator | None = None) -> dict:
    """``{"convs": [[(w, b), ...] a group], "fc": [(w, b), ...]}`` float32 on
    ``device`` (``None`` = the card)."""
    device = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen) * std).to(device)

    layers = iter(conv_layers(cfg, image))
    convs = []
    for group in cfg.groups:
        convs.append([])
        for _ in group:
            cin, cout, _ = next(layers)
            convs[-1].append((normal((cout, cin, 3, 3), (2.0 / (9 * cin)) ** 0.5),
                              torch.zeros(cout, device=device)))
    fc = [(normal((out, cin), cin ** -0.5), torch.zeros(out, device=device))
          for cin, out in fc_layers(cfg, image)]
    return {"convs": convs, "fc": fc}


MAC = pim.compile(lambda a, b, c: a * b + c, dtype=pim.f32)


def linear_waves(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                 basis: str = "memristive") -> torch.Tensor:
    """``x`` ``[N, in]`` times ``w`` ``[out, in]`` plus ``b`` ``[out]`` as
    ``in`` f32 MAC waves over the ``N·out`` outputs."""
    n, cin = x.shape
    shape = (n, w.shape[0])
    ab = torch.empty((2, *shape), dtype=torch.float32, device=x.device)
    c = b.view(1, -1).expand(shape).reshape(-1)
    for i in range(cin):
        ab[0].copy_(x[:, i:i + 1].expand(shape))
        ab[1].copy_(w[:, i].view(1, -1).expand(shape))
        c = MAC(ab[0].view(-1), ab[1].view(-1), c, basis=basis, device=x.device)
    return c.view(shape)


def pim_forward(params: dict, x: torch.Tensor, basis: str = "memristive", *,
                keep: list | None = None) -> torch.Tensor:
    """Logits of ``x`` ``[N, 3, H, W]`` with every conv and fully connected
    layer on PIM; each conv layer's output (before its ReLU) is appended to
    ``keep`` when given."""
    for group in params["convs"]:
        for w, b in group:
            x = conv3x3(x, w, b, basis=basis)
            if keep is not None:
                keep.append(x)
            x = F.relu(x)
        x = F.max_pool2d(x, 2)
    x = x.flatten(1)
    for i, (w, b) in enumerate(params["fc"]):
        x = linear_waves(x, w, b, basis=basis)
        if i < len(params["fc"]) - 1:
            x = F.relu(x)
    return x
