"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA H100.

Each cell is one simulated PIM machine (``configs/``) under one traffic mix
(``traffic/``) of one element-wise program (``programs/``); ``BENCHMARK.json``
at the repository root names the cells and their metrics, and each metric has
a reader of its own in ``metrics/``.  Every call in the window goes through
the port's public API, ``repro_torch.pim.compile(...)(x, y, z, basis=...)``,
and ``correct`` holds its unpacked result against a plain NumPy reference
(``reference.py``).

    python3 pimbench/run.py --workload memristive.f32_bulk --seed 7 --seconds 10 --trace 0

This package imports ``torch``, ``numpy`` and ``repro_torch`` only.
"""
