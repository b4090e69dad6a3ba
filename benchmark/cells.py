"""A cell of ``BENCHMARK.json``, found by name, with its configuration,
traffic mix and metric readers, each in files of its own:

    configs/<config>.json   the model: its frozen .cfg beside it, the serving
                            precision, the heads' objectness offset, the
                            reference and the limits of the comparison that
                            decides ``correct``
    traffic/<traffic>.json  the load: batch, frame size, thresholds, and the
                            warm-up, traced and reference block sizes
    metrics/<metric>.py     one reader a metric, ``read(run) -> float | None``
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    cfg_text: str
    traffic_name: str
    traffic: dict
    end_to_end: list     # the metric entries this cell reports with --trace 0
    per_layer: list      # ... and with --trace 1


def load_json(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    cfg_path = os.path.join(os.path.dirname(os.path.join(root, conf["file"])), config["cfg"])
    with open(cfg_path, "r", encoding="utf-8") as f:
        cfg_text = f.read()
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    return Cell(name, int(w["chips"]), config, cfg_text, w["traffic"], traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
