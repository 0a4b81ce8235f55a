"""The harness: one run of one cell.

``run.py`` parses the command line and calls ``main``. A cell is
``workloads/<name>.json``: its configuration (``configs/<config>.json``),
its traffic mix (``traffic/<traffic>.json``, whose ``kind`` names the
module ``kinds/<kind>.py`` that drives it) and the limits of its
comparison. Per-layer metrics are the readers ``metrics/<name>.py``. A new
cell, configuration, mix, kind or metric is a new file; nothing here names
one.

A kind's ``run(ctx)`` returns a ``Run``: the end-to-end metrics, what the
per-layer readers read (``record``), the device's peak memory, the compared
numbers with their limits, and, traced, the profiler's summary.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "monorec_tpu")
# One intra-op thread a process: the host's work here is launching and
# Python, and a pool of spinning threads on a shared host only adds noise.
HOST_THREADS = 1


def load_json(*parts: str) -> Dict:
    path = HERE.joinpath(*parts)
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]

    @classmethod
    def load(cls, name: str, overrides: Optional[Dict] = None) -> "Cell":
        spec = load_json("workloads", f"{name}.json")
        config = load_json("configs", f"{spec['config']}.json")
        traffic = load_json("traffic", f"{spec['traffic']}.json")
        unknown = set(traffic) - {"kind", "why"} - set(kind_module(traffic).KEYS)
        if unknown:
            raise ValueError(f"{spec['traffic']}: {traffic['kind']} reads no {sorted(unknown)}")
        for key, value in (overrides or {}).items():
            (config["shape"] if key in config["shape"] else traffic)[key] = value
            if key == "depth_steps":
                config["arch"]["cv_depth_steps"] = value
        if config["arch"]["cv_depth_steps"] != config["shape"]["depth_steps"]:
            raise ValueError(f"{spec['config']}: arch.cv_depth_steps and shape.depth_steps differ")
        return cls(name, spec["chips"], config, traffic, spec["limits"])


@dataclasses.dataclass
class Context:
    """What a kind gets: the cell, the run's arguments, the device, and the
    process's start on the host clock."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    faults: tuple = ()


@dataclasses.dataclass
class Run:
    attempted: int
    failed: int
    metrics: Dict[str, float]
    units: Dict[str, str]
    record: Dict[str, Any]
    memory_peak_bytes: int
    compared: List[Dict[str, Any]]
    device_count: int

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c["value"] <= c["limit"] for c in self.compared)


def gap(value: float) -> float:
    """A compared number; NaN (an answer that says nothing) never passes."""
    return float("inf") if value != value else float(value)


# ----- per-layer metrics -----------------------------------------------------


def metric_readers() -> Dict[str, Any]:
    """Every reader under ``metrics/``, by metric name (the file's name)."""
    readers = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(f"bench_h100_metric_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        readers[path.stem] = module
    return readers


def per_layer(record: Dict) -> Dict[str, Dict[str, Any]]:
    out = {}
    for name, reader in metric_readers().items():
        value = reader.read(record)
        if value is not None:
            out[name] = {"value": float(value), "unit": reader.UNIT}
    return out


# ----- device timing ---------------------------------------------------------


class Spans:
    """Device time of calls into the program, by CUDA events (host clock on
    the CPU): ``wrap(obj, attr, name)`` times every call of ``obj.attr``
    (an instance's method, replaced on the instance only); ``mark`` opens a
    span that ``close`` ends. ``per_item(name)`` sums each item's spans."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.events: Dict[str, List] = {}
        self.item = 0
        self.open: Dict[str, Any] = {}

    def _stamp(self):
        if self.cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _add(self, name, start, end):
        self.events.setdefault(name, []).append((self.item, start, end))

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            start = self._stamp()
            out = fn(*args, **kwargs)
            self._add(name, start, self._stamp())
            return out

        setattr(obj, attr, timed)

    def mark(self, name: str) -> None:
        self.open[name] = self._stamp()

    def close(self, name: str) -> None:
        start = self.open.pop(name, None)
        if start is not None:
            self._add(name, start, self._stamp())

    def per_item(self, below: Optional[int] = None) -> Dict[str, List[float]]:
        """Milliseconds per item (request or step) of each span, over the
        items before ``below`` where given (the window's: the profiler slows
        the items it traces)."""
        out: Dict[str, Dict[int, float]] = {}
        for name, evs in self.events.items():
            acc = out.setdefault(name, {})
            for item, start, end in evs:
                if below is not None and item >= below:
                    continue
                ms = start.elapsed_time(end) if self.cuda else (end - start) * 1e3
                acc[item] = acc.get(item, 0.0) + ms
        return {name: list(acc.values()) for name, acc in out.items()}


class Trace:
    """``torch.profiler`` over requests or steps that a kind runs after its
    window, in two passes, then ``summary``.

    ``device_pass(run_item, items)`` records the card's activity alone
    (kernels, copies, the runtime's calls) and none of the host's
    operators, so the host runs about as it does untraced: its items give
    the device's busy seconds, the pass's length on the host clock (from
    the first launch to the closing sync) and the seconds by kernel name.
    ``label_pass(run_item, items)`` then records the host's operators too,
    only to label the idle gaps of its own items by what the host was
    doing; the profiler's host work lengthens those gaps."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.items = 0
        self.device: Dict[str, Any] = {"kernels": {}, "busy_s": 0.0, "window_s": 0.0}
        self.idle: List[List] = []

    def _profile(self, run_item, items: int, host: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if self.cuda else []
        if host or not self.cuda:
            acts.append(ProfilerActivity.CPU)
        prof = profile(activities=acts)
        prof.start()
        t0 = time.perf_counter()
        for j in range(items):
            run_item(j)
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        prof.stop()
        from torch.autograd import DeviceType

        events = prof.events()
        host_events = [e for e in events if e.device_type == DeviceType.CPU]
        names = {e.name for e in host_events}
        device = [e for e in events if e.device_type != DeviceType.CPU and e.name not in names]
        return host_events, device, host_s

    def device_pass(self, run_item, items: int) -> None:
        _, device, host_s = self._profile(run_item, items, host=False)
        kernels: Dict[str, float] = {}
        for e in device:
            dur = (e.time_range.end - e.time_range.start) / 1e6
            kernels[e.name] = kernels.get(e.name, 0.0) + dur
        busy, _ = _union(sorted((e.time_range.start, e.time_range.end) for e in device))
        self.items = items
        self.device = {"kernels": kernels, "busy_s": busy / 1e6, "window_s": host_s}

    def label_pass(self, run_item, items: int) -> None:
        host, device, _ = self._profile(run_item, items, host=True)
        spans = sorted((e.time_range.start, e.time_range.end) for e in device)
        if not spans or not host:
            return
        t0 = min(e.time_range.start for e in host)
        t1 = max(spans[-1][1], max(e.time_range.end for e in host))
        _, gaps = _union(spans, t0, t1)
        self.idle = self._label_gaps(gaps, host)

    def summary(self) -> Dict[str, Any]:
        return dict(self.device, items=self.items, idle=self.idle)

    @staticmethod
    def _label_gaps(gaps, host) -> List[List]:
        """Idle seconds summed by the innermost host range open at each gap's
        start (the latest-starting one that has not ended): the ten largest."""
        ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in host)
        starts = [r[0] for r in ranges]
        by_label: Dict[str, float] = {}
        for g0, g1 in gaps:
            i = bisect.bisect_right(starts, g0)
            label = next((name for _, end, name in reversed(ranges[max(0, i - 400):i])
                          if end >= g0), "no host range")
            by_label[label] = by_label.get(label, 0.0) + (g1 - g0) / 1e6
        return sorted(([k, v] for k, v in by_label.items()), key=lambda kv: -kv[1])[:10]


def label_items(items: int) -> int:
    """How many items the label pass traces after a device pass of ``items``."""
    return max(2, items // 4)


def _union(spans, t0=None, t1=None):
    """The covered length of sorted (start, end) ``spans`` and the gaps
    between them, within [t0, t1] where given."""
    reach = spans[0][0] if t0 is None and spans else t0
    busy, gaps = 0.0, []
    for s, e in spans:
        if s > reach:
            gaps.append((reach, s))
        busy += max(0.0, e - max(s, reach))
        reach = max(reach, e)
    if t1 is not None and t1 > reach:
        gaps.append((reach, t1))
    return busy, gaps


def device_ops(kernels: Dict[str, float]) -> List[List]:
    return sorted(([k, v] for k, v in kernels.items()), key=lambda kv: -kv[1])[:10]


# ----- the run ---------------------------------------------------------------


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_loaded() -> List[str]:
    """Modules of JAX or of the JAX package in this process, by whole
    top-level name."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def kind_module(traffic: Dict):
    """The module that drives a traffic mix: ``kinds/<kind>.py``, with the
    mix's keys that it reads (``KEYS``) and ``run(ctx)``."""
    return importlib.import_module(f"bench_h100.kinds.{traffic['kind']}")


def run_cell(ctx: Context) -> Run:
    return kind_module(ctx.cell.traffic).run(ctx)


def result_line(ctx: Context, run: Run, device_kind: str) -> Dict:
    if ctx.trace:
        metrics = per_layer(run.record)
    else:
        metrics = {k: {"value": v, "unit": run.units[k]} for k, v in run.metrics.items()}
    device = {"platform": "gpu", "kind": device_kind, "count": run.device_count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    line: Dict[str, Any] = {"correct": run.correct, "attempted": run.attempted,
                            "failed": run.failed, "metrics": metrics, "device": device}
    trace = run.record.get("trace")
    if ctx.trace and trace:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        line["breakdown"] = {"device_ops": device_ops(trace["kernels"]),
                             "idle_gaps": trace["idle"]}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in run.compared}
    return line


def main(args: argparse.Namespace, t_start: float) -> int:
    import torch

    torch.set_num_threads(HOST_THREADS)
    cell = Cell.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); {n} visible", file=sys.stderr)
        return 3
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                  t_start)
    run = run_cell(ctx)
    found = forbidden_loaded()
    if found:
        print(f"the run loaded {', '.join(found)}; the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    line = result_line(ctx, run, torch.cuda.get_device_name(0))
    for c in run.compared:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0
