"""Plain PyTorch reference of VGG-16 as ``repro_torch.models.vgg`` runs it
on the simulated PIM: the bit-exact target of the PIM path.

It imports ``torch`` alone, nothing of the port.  Every sum is the PIM
row's sum in the PIM row's order, with plain float32 element-wise ops: one
rounding a product and one a sum (``acc = acc + x * w``, never a fused
multiply-add), so the PIM path equals it bit for bit, NaN as NaN.

* :func:`conv3x3_chain`: a stride-1, pad-1 3×3 convolution as the bias
  plus, for each input channel in order, its nine taps in row-major
  ``(ky, kx)`` order;
* :func:`fc_chain`: a fully connected layer as the bias plus, for each
  input feature in order, its product;
* :func:`forward`: the whole model on those, with ReLU, 2×2 max-pooling and
  flattening as the PIM path does them;
* :func:`conv3x3_exact`: ``F.conv2d`` in float64, which ties the chain to the
  convolution by an error bound (``tests/test_torch_vgg.py``);
* :func:`differing`: the count of elements that differ bit for bit.

``params`` is ``{"convs": [[(w, b), ...] a group, ...], "fc": [(w, b),
...]}`` with a 2×2 max-pool after each group, as ``vgg.init_params`` makes
it.  The chains use element-wise float32 ops alone and the exact
convolution runs in float64, so TF32 never applies and no setting of it is
needed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv3x3_chain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x`` ``[N, Cin, H, W]``, ``w`` ``[Cout, Cin, 3, 3]``, ``b`` ``[Cout]``
    → ``[N, Cout, H, W]``, summed in the PIM row's order."""
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    xp = F.pad(x, (1, 1, 1, 1))
    acc = b.view(1, cout, 1, 1).expand(n, cout, h, wd).clone()
    for ci in range(cin):
        for ky in range(3):
            for kx in range(3):
                acc = acc + xp[:, ci:ci + 1, ky:ky + h, kx:kx + wd] * w[:, ci, ky, kx].view(
                    1, cout, 1, 1)
    return acc


def fc_chain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x`` ``[N, in]``, ``w`` ``[out, in]``, ``b`` ``[out]`` → ``[N, out]``,
    one input feature at a time."""
    acc = b.view(1, -1).expand(x.shape[0], -1).clone()
    for i in range(x.shape[1]):
        acc = acc + x[:, i:i + 1] * w[:, i].view(1, -1)
    return acc


def conv3x3_exact(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same convolution in float64 (``F.conv2d``)."""
    return F.conv2d(x.double(), w.double(), b.double(), padding=1)


def forward(params: dict, x: torch.Tensor, *, keep: list | None = None) -> torch.Tensor:
    """Logits of the model; each conv layer's output (before its ReLU) is
    appended to ``keep`` when given."""
    for group in params["convs"]:
        for w, b in group:
            x = conv3x3_chain(x, w, b)
            if keep is not None:
                keep.append(x)
            x = F.relu(x)
        x = F.max_pool2d(x, 2)
    x = x.flatten(1)
    for i, (w, b) in enumerate(params["fc"]):
        x = fc_chain(x, w, b)
        if i < len(params["fc"]) - 1:
            x = F.relu(x)
    return x


def differing(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of ``got`` that differ from ``want`` bit for bit, any NaN
    equal to any NaN; every element when the shapes differ."""
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    same = (got.view(torch.int32) == want.view(torch.int32)) | (got.isnan() & want.isnan())
    return int((~same).sum())
