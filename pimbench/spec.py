"""The benchmark's description: ``BENCHMARK.json`` and the data files it names.

A cell is found by its name in ``BENCHMARK.json``; its configuration,
traffic mix and program are JSON files under this package, found by name,
and each metric is a reader under ``metrics/`` named as the metric is.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    program: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]

    @property
    def basis(self) -> str:
        return self.config["basis"]

    @property
    def work(self) -> dict:
        """The program's frozen work on this cell's basis."""
        return self.program["work"][self.basis]

    @property
    def machine_rows(self) -> int:
        """Rows of the configured machine."""
        return self.config["num_crossbars"] * self.config["crossbar_rows"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    config_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    traffic = load_json(PKG / "traffic" / f"{w['traffic']}.json")
    end_to_end = tuple(m for m in bench["end_to_end"] if _applies(m, name))
    return Cell(
        name=name,
        chips=w["chips"],
        config=load_json(root / config_file),
        traffic=traffic,
        program=load_json(PKG / "programs" / f"{traffic['program']}.json"),
        end_to_end=end_to_end,
        # Without a list of its own, a per-layer metric is read in every cell
        # that reports the end-to-end metric it moves.
        per_layer=tuple(m for m in bench["per_layer"] if _applies(m, name)
                        and m["moves"] in {e["name"] for e in end_to_end}),
    )


def reader(metric: str):
    """The reader module ``metrics/<metric>.py`` (a name may hold dots, so it
    is loaded from its file, not imported by name)."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"pimbench_metric_{metric}", path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
