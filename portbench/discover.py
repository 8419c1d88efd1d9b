"""Finds a cell, its configuration, its traffic mix and its metrics by the
names in ``BENCHMARK.json``. A configuration is
``portbench/configs/<config>.json`` (the file BENCHMARK.json names), a
traffic mix ``portbench/traffic/<traffic>.json`` and a per-layer metric's
reader ``portbench/metrics/<metric>.py`` (one reader for every traffic
suffix of a metric, see ``load_reader``), so a cell or a metric is added
with files and entries alone.
"""
from __future__ import annotations

import importlib.util
import json
import os

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, workload: str, root: str = ROOT) -> dict:
    """The workload's entry with its configuration and traffic loaded:
    {"workload", "config", "traffic", "end_to_end", "per_layer"}."""
    wl = _by_name(bench["workloads"], workload, "workload")
    cfg_entry = _by_name(bench["configs"], wl["config"], "config")
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    return {
        "workload": wl,
        "config": config,
        "traffic": load_traffic(wl["traffic"]),
        "end_to_end": metrics_of(bench["end_to_end"], workload),
        "per_layer": metrics_of(bench["per_layer"], workload),
    }


def metrics_of(entries: list, workload: str) -> list:
    """The metrics a cell reports: those that list it, or list none."""
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def load_traffic(name: str) -> dict:
    with open(os.path.join(PKG_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def load_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``, or, where there
    is none, of the reader of the metric without its traffic suffix:
    ``metrics/commit_phase_s.py`` for ``commit_phase_s.serial``."""
    base = name
    while not os.path.exists(os.path.join(PKG_DIR, "metrics", f"{base}.py")):
        if "." not in base:
            raise KeyError(f"no reader for the metric {name!r}")
        base = base.rsplit(".", 1)[0]
    path = os.path.join(PKG_DIR, "metrics", f"{base}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + base.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
