"""Paper Fig 7 on the PyTorch/CUDA port: full-precision CNN training
(forward and backward) — PIM against a GPU.  The columns and their
definitions are Fig 6's (``benchmarks/torch_fig6_cnn_infer.py``).

    PYTHONPATH=src python -m benchmarks.torch_fig7_cnn_train [--device cpu]
"""

from __future__ import annotations

from .torch_common import emit
from .torch_fig6_cnn_infer import device_from_argv
from .torch_fig6_cnn_infer import run as _run


def run(device=None) -> list[dict]:
    return _run(train=True, device=device)


def main(argv=None):
    emit(run(device=device_from_argv(argv)))


if __name__ == "__main__":
    main()
