"""One run of one cell: set-up, the measured window, the traced reading,
the check, and the result line.

Everything that belongs to a cell is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``) and
its traffic (``traffic/<traffic>.json``, whose ``kind`` names the loop in
``kinds/<kind>.py``); ``workloads/<cell>.json`` holds the cell's check
(sample size, profiled units, the limit of each compared number); each
per-layer metric is ``metrics/<metric>.py``.  Adding a cell, a
configuration or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench.traffic import generate

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_files(bench: dict, name: str) -> SimpleNamespace:
    """The cell's entry, configuration, traffic, check spec and kind."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    traffic = generate.load(entry["traffic"])
    return SimpleNamespace(entry=entry, cfg=load_json(ROOT / conf["file"]), traffic=traffic,
                           spec=load_json(HERE / "workloads" / f"{name}.json"),
                           kind=importlib.import_module(f"portbench.kinds.{traffic['kind']}"))


def metric_module(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def window(cell, seconds: float) -> SimpleNamespace:
    """The closed loop: one caller, the next unit when the last returns,
    until the first unit boundary after ``seconds``."""
    i = getattr(cell, "warm_units", 1)
    units = 0
    t0 = time.perf_counter()
    while True:
        cell.run(i + units)
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    cell.finish()
    return SimpleNamespace(units=units, seconds=time.perf_counter() - t0, next=i + units)


class Entries:
    """The per-layer metrics' entry points wrapped for the traced units:
    each call records its facts (its bytes and operations, from its own
    arguments) and runs under a profiler range named after the metric."""

    def __init__(self, metrics: dict):
        self.metrics = {n: m for n, m in metrics.items() if getattr(m, "ENTRY", None)}
        self.calls = {n: [] for n in self.metrics}
        self.saved = []

    def __enter__(self):
        for name, m in self.metrics.items():
            mod_name, attr = m.ENTRY.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            self.saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(name, m.facts, orig))
        return self

    def _wrap(self, name, facts, orig):
        calls = self.calls[name]

        def wrapper(*args, **kwargs):
            calls.append(facts(*args, **kwargs))
            with torch.profiler.record_function(f"pb:{name}"):
                return orig(*args, **kwargs)

        return wrapper

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self.saved):
            setattr(mod, attr, orig)


def traced(cell, files, bench, name: str, unit_s: float, start: int, dev) -> tuple:
    """Profile ``profile_units`` units with the metrics' entries wrapped;
    read every per-layer metric of the cell."""
    from portbench.trace import profiled

    metrics = {m["name"]: metric_module(m["name"]) for m in bench["per_layer"]
               if applies(m, name)}
    for m in bench["per_layer"]:
        if m["name"] in metrics:
            mod = metrics[m["name"]]
            if (mod.LAYER, mod.MOVES) != (m["layer"], m["moves"]):
                raise ValueError(f"{m['name']}: layer/moves differ from BENCHMARK.json")
    units = files.spec["profile_units"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with Entries(metrics) as entries, cell.spans(), profiled() as got:
        for k in range(units):
            cell.run(start + k)
        cell.finish()
    tr = got[0]
    ctx = SimpleNamespace(cfg=files.cfg, traffic=files.traffic, work=cell.work(units),
                          unit_s=unit_s, busy_s=tr.busy_s(), window_s=tr.wall_s,
                          kernels=tr.kernels, range_s=tr.range_s, calls=entries.calls,
                          peak_bytes=torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else 0)
    for n, calls in entries.calls.items():
        print(f"trace: pb:{n}: {len(calls)} calls; {tr.range_report(f'pb:{n}')}",
              file=sys.stderr)
    out = {}
    for m in bench["per_layer"]:
        if m["name"] in metrics:
            value = metrics[m["name"]].read(ctx)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"busy_s": ctx.busy_s, "window_s": ctx.window_s}
    return out, device, tr.breakdown()


def main(argv=None, started: float | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = time.time() if started is None else started
    bench = load_json(ROOT / "BENCHMARK.json")
    files = cell_files(bench, args.workload)
    chips = files.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise SystemExit(f"{args.workload} needs {chips} CUDA device(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"card: {card()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    return run_cell(files, bench, args, dev, started)


def run_cell(files, bench: dict, args, dev, started: float) -> dict:
    """Set-up, window, traced reading (``args.trace``), check; the result."""
    t0 = time.time()
    cell = files.kind.Cell(files.cfg, files.traffic, files.spec, args.seed, dev)
    t1 = time.time()
    cell.warmup()
    cell.finish()
    setup_s = time.time() - started
    print(f"set-up: {t0 - started:.3f} s to the cell, {t1 - t0:.3f} s building it, "
          f"{time.time() - t1:.3f} s warming up", file=sys.stderr, flush=True)
    w = window(cell, args.seconds)
    items = w.units * cell.items_per_unit
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    result = {"correct": None, "attempted": items, "failed": 0, "metrics": {}}
    if args.trace:
        result["metrics"], extra, breakdown = traced(cell, files, bench, files.entry["name"],
                                                     w.seconds / w.units, w.next, dev)
    else:
        for m in bench["end_to_end"]:
            if not applies(m, files.entry["name"]):
                continue
            if m["name"] == "setup_s":
                result["metrics"][m["name"]] = {"value": setup_s, "unit": m["unit"]}
            elif m["unit"] == f"{files.kind.ITEM}/s":
                result["metrics"][m["name"]] = {"value": items / w.seconds, "unit": m["unit"]}
            else:
                raise ValueError(f"the {files.traffic['kind']} kind has no reading of {m['name']}")
        extra, breakdown = {}, None
    print(f"window: {w.units} units, {items} {files.kind.ITEM} in {w.seconds:.3f} s; "
          f"set-up {setup_s:.3f} s; peak {peak} bytes", file=sys.stderr, flush=True)

    cell.release()
    readings = cell.readings()
    checks = {k: {"value": readings[k], "limit": v} for k, v in files.spec["limits"].items()}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                        "count": 1 if dev.type == "cuda" else 0,
                        "memory_peak_bytes": peak, **extra}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    loaded = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "clipcap_tpu"
              or m.startswith("clipcap_tpu.")]
    if loaded:
        raise RuntimeError(f"the benchmark loaded {loaded[:5]}: it must not import JAX or "
                           "the JAX package")
    for k, c in checks.items():
        print(f"check {k}: {c['value']:.6g} (limit {c['limit']:.6g})", file=sys.stderr)
    sys.stderr.flush()
    return result
