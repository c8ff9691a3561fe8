"""The port's int8 error-feedback all-reduce against the reference, on the
CPU: 8 gloo ranks (one process each) reduce the rows of the reference
test's (8, 1000) case, made here from a numpy seed.  The int8 codes equal
the reference's ``_quantize_rows`` on the same rows (exactly); each rank's
residual is within 1e-6 × the largest gradient entry of the reference's
``shard_map`` run on 8 XLA host devices (the residual is g − dequant(q),
a cancellation: XLA fuses the two and differs by 1 ulp of g) and the mean
within 1e-6 × its largest (XLA sums the contributions in its own order),
and within the reference's 0.05 of the true mean; the residual is
non-zero."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from _torch_gloo import ROOT, run_ranks
from repro.parallel import compression as ref_comp
from repro_torch.parallel import compression

D, N = 8, 1000

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import inspect
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.parallel.compression import compressed_psum_mean
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
_ck = "check_vma" if "check_vma" in inspect.signature(shard_map).parameters else "check_rep"
out = sys.argv[1]
g = jnp.asarray(np.load(os.path.join(out, "g.npy")))
mesh = jax.make_mesh((8,), ("data",))
f = jax.jit(shard_map(lambda gl, el: compressed_psum_mean(gl[0], el[0], "data"),
                      mesh=mesh, in_specs=(P("data", None), P("data", None)),
                      out_specs=(P(None), P("data")), **{_ck: False}))
mean, new_err = f(g, jnp.zeros_like(g))
np.save(os.path.join(out, "ref_mean.npy"), np.asarray(mean))
np.save(os.path.join(out, "ref_err.npy"), np.asarray(new_err).reshape(8, -1))
"""

RANK_SCRIPT = r"""
import numpy as np
from repro_torch.parallel.compression import compressed_psum_mean, uncompressed_psum_mean
init()
g = torch.from_numpy(np.load(os.path.join(OUT, "..", "g.npy"))[RANK])
mean, err = compressed_psum_mean(g, torch.zeros_like(g))
exact = uncompressed_psum_mean(g)
np.save(os.path.join(OUT, f"mean{RANK}.npy"), mean.numpy())
np.save(os.path.join(OUT, f"err{RANK}.npy"), err.numpy())
np.save(os.path.join(OUT, f"exact{RANK}.npy"), exact.numpy())
dist.destroy_process_group()
"""


def _inputs() -> np.ndarray:
    return np.random.default_rng(0).standard_normal((D, N)).astype(np.float32)


def test_quantize_rows_codes_equal_reference():
    g = _inputs()
    seg = -(-N // (D * compression.CHUNK)) * compression.CHUNK
    for row in g:
        flat_p = np.pad(row, (0, D * seg - N)).reshape(D, seg)
        q, s = compression._quantize_rows(torch.from_numpy(flat_p))
        rq, rs = ref_comp._quantize_rows(jnp.asarray(flat_p))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(
            compression._dequantize_rows(q, s).numpy(), np.asarray(ref_comp._dequantize_rows(rq, rs)))


def test_compressed_mean_on_8_gloo_ranks_matches_reference(tmp_path):
    g = _inputs()
    np.save(os.path.join(tmp_path, "g.npy"), g)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    ref = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(tmp_path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    out = run_ranks(RANK_SCRIPT, D, tmp_path)
    ref_mean = np.load(os.path.join(tmp_path, "ref_mean.npy"))
    ref_err = np.load(os.path.join(tmp_path, "ref_err.npy"))
    means = [np.load(os.path.join(out, f"mean{r}.npy")) for r in range(D)]
    for r in range(D):
        np.testing.assert_array_equal(means[r], means[0])  # every rank holds the same mean
        err = np.load(os.path.join(out, f"err{r}.npy"))
        assert np.abs(err - ref_err[r]).max() <= 1e-6 * np.abs(g).max()
    true = g.mean(axis=0)
    np.testing.assert_allclose(np.load(os.path.join(out, "exact0.npy")), true, rtol=0,
                               atol=1e-6 * np.abs(true).max())
    assert np.abs(means[0] - ref_mean).max() <= 1e-6 * np.abs(ref_mean).max()
    rel = np.abs(means[0] - true).max() / np.abs(true).max()
    assert rel < 0.05, rel
    assert np.abs(np.load(os.path.join(out, "err0.npy"))).max() > 0
