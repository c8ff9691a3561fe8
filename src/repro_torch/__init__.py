"""repro_torch — the PyTorch/CUDA port of ``repro``'s bit-serial PIM path.

Trace an element-wise program into a digital-PIM gate schedule and execute
it bit-exactly on packed bit-planes on an NVIDIA GPU:

    import repro_torch.pim as pim

    mac = pim.compile(lambda a, b, c: a * b + c, dtype=pim.f32)
    z = mac(x, y, c)                  # on the card; device="cpu" to opt out

Layout mirrors ``repro``: ``core`` (planes, machine, netlists, compiler,
simulation, cost model, metrics), ``pim`` (frontend), ``kernels`` (CUDA
executors and matmul, wrappers, oracles).
"""
