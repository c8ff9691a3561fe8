"""Hand-written CUDA kernels for Hopper: the bit-serial gate-schedule
executors (loop kernel in ``csrc/bitserial_loop.cu``, straight-line kernel
generated per schedule by ``bitserial_codegen``) and the MatPIM matmul
(``csrc/pim_matmul.cu`` behind ``pim_matmul``), with ``ops.py`` wrappers
and ``ref.py`` oracles."""
