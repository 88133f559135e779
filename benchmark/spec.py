"""Everything the harness finds by name, from ``BENCHMARK.json`` at the
root of the checkout: a cell (``workloads`` entry) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``,
whose ``driver`` is a module of ``drivers/``); the cell's own file
(``workloads/<cell>.json``) holds the limits that decide ``correct``; each
per-layer metric is a reader ``metrics/<metric>.py``; each kernel family a
file ``families/<family>.json``. Adding any of them adds files and an entry
in ``BENCHMARK.json`` and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclass
class Cell:
    """One cell and what belongs to it."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def reports(metric: dict, cell: str) -> bool:
    """Whether a cell reports a metric: listed in its ``workloads``, or
    every cell where it has none."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    here = root / HERE.name
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(here / "traffic" / f"{entry['traffic']}.json")
    own = here / "workloads" / f"{name}.json"
    limits = load_json(own)["limits"] if own.exists() else {}
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if reports(m, name)]
    return Cell(name, int(entry["chips"]), entry["config"], entry["traffic"],
                config, traffic, limits, e2e, per_layer)


def metric_reader(name: str, root: Path = ROOT
                  ) -> Callable[[dict], Optional[float]]:
    """``metrics/<name>.py``'s ``read(records)``."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def families(root: Path = ROOT) -> Dict[str, dict]:
    """{family: {"fragments": [...], "conv": bool}} of ``families/``."""
    return {p.stem: load_json(p)
            for p in sorted((root / HERE.name / "families").glob("*.json"))}


def family_of(kernel: str, table: Dict[str, dict]) -> str:
    """The family whose longest fragment in ``kernel``'s name is the
    longest of all; ``other`` where none matches."""
    best, length = "other", 0
    for fam, entry in table.items():
        for frag in entry["fragments"]:
            if frag in kernel and len(frag) > length:
                best, length = fam, len(frag)
    return best
