"""A 3×3 convolution lowered onto rows of one nine-tap PIM program.

A row of the simulated crossbar holds one output element's 3×3 window of
one input channel, the nine weights that meet it and the running partial
sum, and computes

    c + a0*w0 + a1*w1 + ... + a8*w8

in float32: one IEEE rounding an operation, the taps in row-major
``(ky, kx)`` order, the sum never leaving the row (19 arguments, one
result).  A stride-1, pad-1 layer of ``Cin`` input channels is ``Cin``
calls of that program, one an input channel in order, each over the
``N·Cout·H·W`` output elements in NCHW order: the first call's ``c`` is the
bias, each later call's ``c`` the last call's result.

    from repro_torch.pim.conv import conv3x3

    y = conv3x3(x, w, b, basis="memristive")   # x [N, Cin, H, W] on the card

:data:`PROGRAM` is traced on import and compiled through the frontend's
compile cache on the first call for a basis; importing this module compiles
nothing, and ``import repro_torch.pim`` does not import it.  Spans:
``conv.layer`` (attrs ``cin``, ``cout``, ``hw``, ``basis``) around a layer
and ``conv.gather`` around building one channel's 19 arguments; the counter
``conv.waves`` counts the calls (``repro_torch.core.spans``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

import repro_torch.pim as pim
from repro_torch.core import spans

TAPS = 9


def nine_tap(c, a0, a1, a2, a3, a4, a5, a6, a7, a8, w0, w1, w2, w3, w4, w5, w6, w7, w8):
    """One row's step: the partial sum plus nine products, left to right."""
    return (c + a0 * w0 + a1 * w1 + a2 * w2 + a3 * w3 + a4 * w4 + a5 * w5 + a6 * w6
            + a7 * w7 + a8 * w8)


PROGRAM = pim.compile(nine_tap, dtype=pim.f32)


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
            basis: str = "memristive") -> torch.Tensor:
    """Stride-1, pad-1 convolution of ``x`` ``[N, Cin, H, W]`` with ``w``
    ``[Cout, Cin, 3, 3]`` and bias ``b`` ``[Cout]``, all float32 on one
    device, as ``Cin`` calls of :data:`PROGRAM` on ``basis``.  Returns
    ``[N, Cout, H, W]`` float32 on ``x``'s device (a CPU tensor runs the
    kernels' plain versions)."""
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3) or tuple(b.shape) != (cout,):
        raise ValueError(f"conv3x3 takes w [Cout, {cin}, 3, 3] and b [Cout], got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if not x.dtype == w.dtype == b.dtype == torch.float32:
        raise TypeError(f"conv3x3 takes float32, got {x.dtype}, {w.dtype}, {b.dtype}")
    shape = (n, cout, h, wd)
    with spans.span("conv.layer", cin=cin, cout=cout, hw=(h, wd), basis=basis):
        xp = F.pad(x, (1, 1, 1, 1))
        sn, sc, sh, sw = xp.stride()
        # [inputs | weights, ky, kx, N, Cout, H, W]: one channel's 18 tap
        # arguments, each a contiguous row of output elements.
        taps = torch.empty((2, 3, 3, *shape), dtype=torch.float32, device=x.device)
        args = taps.view(2 * TAPS, -1)
        c = b.view(1, cout, 1, 1).expand(shape).reshape(-1)
        for ci in range(cin):
            with spans.span("conv.gather"):
                windows = xp.as_strided((3, 3, n, h, wd), (sh, sw, sn, sh, sw),
                                        xp.storage_offset() + ci * sc)
                taps[0].copy_(windows.unsqueeze(3).expand(3, 3, *shape))
                taps[1].copy_(w[:, ci].permute(1, 2, 0)[:, :, None, :, None, None]
                              .expand(3, 3, *shape))
            c = PROGRAM(c, *args, basis=basis, device=x.device)
            spans.count("conv.waves")
    return c.view(shape)
