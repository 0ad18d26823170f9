"""Finds a cell's parts by name: ``BENCHMARK.json`` at the checkout's root,
the cell's file under ``workloads/``, its configuration's file, its traffic
mix under ``traffic/``, the readers of its metrics under ``end_to_end/``
and ``layer_metrics/`` and its family's reference under ``reference/``.
Adding a cell, a mix or a metric adds files; nothing here changes."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # portbench/


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    read: object          # read(run) -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    conf: dict            # the configuration's file
    engine: dict          # engine settings
    mix: dict             # traffic parameters, the cell's load merged over the mix
    check: dict           # how many requests the check samples, the limits
    profile_steps: int
    end_to_end: list[Metric]
    per_layer: list[Metric]


def load_module(path: Path):
    """A module from a file, whatever characters its name holds."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return read_json(root / "BENCHMARK.json")


def _metrics(entries, folder: str, cell: str, reported: set[str] | None) -> list[Metric]:
    out = []
    for m in entries:
        cells = m.get("workloads")
        if cells is not None:
            if cell not in cells:
                continue
        elif reported is not None and m["moves"] not in reported:
            continue
        reader = load_module(HERE / folder / f"{m['name']}.py").read
        out.append(Metric(m["name"], m["unit"], m["better"], m["source"], reader))
    return out


def load_cell(root: Path, name: str) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    conf = read_json(root / conf_entry["file"])
    cell = read_json(HERE / "workloads" / f"{name}.json")
    mix = read_json(HERE / "traffic" / f"{entry['traffic']}.json")
    mix = {**mix, **cell.get("load", {})}
    e2e = _metrics(bench["end_to_end"], "end_to_end", name, None)
    layer = _metrics(bench["per_layer"], "layer_metrics", name, {m.name for m in e2e})
    return Cell(name=name, chips=entry["chips"], conf=conf, engine=cell["engine"],
                mix=mix, check=cell["check"],
                profile_steps=cell.get("profile_steps", 16),
                end_to_end=e2e, per_layer=layer)


def reference(family: str):
    """The plain f32 forward of a family (``reference/<family>.py``)."""
    return importlib.import_module(f"portbench.reference.{family}")
