"""Hand-written CUDA kernels for Hopper: the bit-serial gate-schedule
executors (loop kernel in ``csrc/bitserial_loop.cu``, straight-line kernel
generated per schedule by ``bitserial_codegen``), with ``ops.py`` wrappers
and ``ref.py`` oracles."""
