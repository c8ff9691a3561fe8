"""The port stands alone: importing ``repro_torch`` and every submodule, the
port's benchmarks ``benchmarks/torch_*.py``, ``examples/torch_quickstart.py``
or ``chip_smoke.py`` loads neither JAX, ml_dtypes nor the reference
package."""

import glob
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")

_CHECK = """
import glob, importlib, os, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
names += sorted("benchmarks." + os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join({root!r}, "benchmarks", "torch_*.py")))
for name in names:
    importlib.import_module(name)
import chip_smoke
import importlib.util
spec = importlib.util.spec_from_file_location(
    "torch_quickstart", os.path.join({root!r}, "examples", "torch_quickstart.py"))
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference():
    code = _CHECK.format(src=os.path.abspath(os.path.join(ROOT, "src")),
                         root=os.path.abspath(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 33  # 22 modules of repro_torch, 11 benchmarks


def _port_sources():
    src = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(src):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))
    yield from glob.glob(os.path.join(ROOT, "benchmarks", "torch_*.py"))
    yield os.path.join(ROOT, "examples", "torch_quickstart.py")
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_name_no_jax_import():
    paths = list(_port_sources())
    assert sum("benchmarks" in p for p in paths) >= 11
    assert sum("examples" in p for p in paths) == 1
    for path in paths:
        text = open(path).read()
        for banned in ("import jax", "from jax", "import ml_dtypes",
                       "from repro.", "import repro.", "from repro import",
                       "from .common", "from benchmarks.common", "import benchmarks.common"):
            assert banned not in text, (path, banned)
