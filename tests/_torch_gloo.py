"""Run a script as the ranks of a gloo process group, one CPU process a
rank, for the port's scale-out tests.  Each rank starts from a fresh
interpreter with ``RANK``, ``WORLD``, ``STORE`` (a file store: no network)
and ``OUT`` (a directory for its results) in its environment; the
script's ``init()`` starts the group.  Every rank has a timeout, so a hung
collective fails the test instead of stalling the suite."""

import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

PRELUDE = """
import os, sys
sys.path[:0] = [{src!r}, {tests!r}]
import torch
import torch.distributed as dist
RANK, WORLD, OUT = int(os.environ["RANK"]), int(os.environ["WORLD"]), os.environ["OUT"]
torch.set_num_threads(1)

def init():
    dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                            rank=RANK, world_size=WORLD)
"""


def run_ranks(script: str, world: int, tmp_path, timeout: float = 240) -> str:
    """Run ``script`` on ``world`` ranks; returns the results directory.
    Fails with every rank's output when a rank fails or times out."""
    out = os.path.join(str(tmp_path), "ranks")
    os.makedirs(out, exist_ok=True)
    code = PRELUDE.format(src=os.path.join(ROOT, "src"), tests=os.path.join(ROOT, "tests")) + script
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(WORLD=str(world), STORE=os.path.join(str(tmp_path), "store"), OUT=out,
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs, failed = [], False
    for r, p in enumerate(procs):
        try:
            text, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            text, _ = p.communicate()
            failed = True
        failed |= p.returncode != 0
        logs.append(f"--- rank {r} (exit {p.returncode})\n{text[-3000:]}")
    assert not failed, "\n".join(logs)
    return out
