"""Everything a run finds by name: the cell in ``BENCHMARK.json``, its
configuration (the entry's ``file``), its traffic mix
(``portbench/traffic/<traffic>.json``), the job that the mix names
(``portbench/jobs/<job>.py``, a class ``Job``) and the reader of each
per-layer metric (``portbench/metrics/<metric>.py``, a ``read(run)``
function).

A ``Job(config, mix, seed, device, workdir, trace)`` does the set-up and
keeps ``phases`` (seconds by part of it); ``window(seconds)`` returns the
run, which the metrics' readers read (with ``trace``: ``intervals``,
``window_ns`` and ``busy_s`` besides); ``end_to_end(run)`` gives the
end-to-end values its host clock measured, ``host_spans(run)`` the host's
spans by name for labelling idle gaps; ``close()`` frees what the program
holds, and ``check(run)`` returns each number compared with the
reference, ``{name: {"value", "limit"}}``; ``attempted(run)`` and
``failed(run, checks)`` count the work items.

Adding a configuration, a mix, a job, a metric or a cell is adding files
and entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

#: the checkout: the folder that holds BENCHMARK.json and portbench/
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]     # the metrics this cell reports untraced
    per_layer: List[dict]      # and traced


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, its files read from
    under ``root``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(name, w["chips"], config, traffic, e2e, per_layer)


def _module(root: str, folder: str, name: str):
    path = os.path.join(root, "portbench", folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def job_class(root: str, name: str) -> type:
    """``Job`` of ``<root>/portbench/jobs/<name>.py``."""
    return _module(root, "jobs", name).Job


def metric_reader(root: str, name: str) -> Callable:
    """``read(run)`` of ``<root>/portbench/metrics/<name>.py``."""
    return _module(root, "metrics", name).read


def read_metrics(root: str, metrics: List[dict], run) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of each metric whose reader finds
    something to read (a reader returns None where it finds nothing)."""
    out = {}
    for m in metrics:
        value = metric_reader(root, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
