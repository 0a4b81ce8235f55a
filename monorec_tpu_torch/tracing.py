"""Spans at the port's layer boundaries: one recorder, off by default.

``span(name)`` is a context manager; ``traced(name)`` puts one around every
call of a function or method. Off (the default), ``span`` checks one
module-level reference and returns a shared null context, and ``traced``
calls the function after the same check: no allocation, no CUDA event, no
profiler range.

``capture(cuda)`` is the one way to turn the recorder on: it yields a
``Recorder`` that holds every span opened inside the block and turns the
recorder back to what it was after it. Each span keeps its name, its parent
(the span open when it started), its item (shared by every span of one
request or one step: a span opened with none open starts the next item),
the host's ``perf_counter_ns`` at its start and end and, where ``cuda``, a
pair of CUDA events on the current stream. While a profiler runs, it also
opens ``torch.profiler.record_function(name)``, so the profiler sees the
span as a host range on its own clock, the one it aligns the device's
activity to (outside a profiler the range would cost the host more than the
rest of the span and show nowhere). ``Recorder.collect`` reads the spans,
inside the block or after it. The recorder writes nothing anywhere: whoever
captures reads it. It keeps one stack of open spans, so spans are opened
from one thread.

The spans (``PERF.md`` names the metric that reads each):

=============================  ===============================================
``forward``                    ``MonoRec.forward``
``cost_volume``                ``MonoRec.cost_volume``, ``cost_volume_pair``
``features``, ``mask``,        ``MonoRec.features``, ``.mask``, ``.depth``
``depth``
``depth_prepass``              under ``simple_mask``, the first, no-gradient
                               depth pass of ``MonoRec.forward`` (its
                               ``depth`` span inside it)
``train_step``                 ``Trainer.train_step``
``feed``                       ``Trainer._feed``, ``MonoRecTrainer._feed``
``loss``                       the trainers' call of ``loss_fn``
``backward``                   the step's ``backward()``
``grad_reduce``                ``parallel.reduce_gradients``
``optimizer``                  ``apply_gradients_guarded``, with its guard
``sync.guard``, ``sync.losses``  the host's waits: the guard's ``.item()``,
``sync.metrics``               ``_to_floats``' ``.tolist()``, ``_metrics``'
                               ``.cpu()``
=============================  ===============================================
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

_NULL = contextlib.nullcontext()
_rec: Optional["Recorder"] = None  # the recorder of the innermost capture, None when off


class Recorder:
    """The spans of one ``capture`` block."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.spans: List[_Span] = []  # in the order opened
        self.open: List[_Span] = []  # the spans open now, innermost last
        self.items = 0  # items started

    def collect(self, items: Optional[int] = None) -> Dict[str, Any]:
        """The closed spans of the first ``items`` items (all where None),
        after one synchronisation: ``{"items": n, "spans": {name:
        {"device_ms", "host_ms", "self_device_ms", "calls": [one per
        item]}}}``. An item's entry sums the span's calls in it (0 where it
        had none); ``self_device_ms`` leaves out the device time of child
        spans. On the CPU, where the host does the work, device ms are host
        ms."""
        n = self.items if items is None else min(items, self.items)
        done = [s for s in self.spans if s.t1 is not None and s.item < n]
        if any(s.ev1 is not None for s in done):
            torch.cuda.synchronize()
        device = {s.index: s.ev0.elapsed_time(s.ev1) if s.ev1 is not None
                  else (s.t1 - s.t0) / 1e6 for s in done}
        child_device: Dict[int, float] = {}
        for s in done:
            if s.parent >= 0:
                child_device[s.parent] = child_device.get(s.parent, 0.0) + device[s.index]
        out: Dict[str, Dict[str, List]] = {}
        for s in done:
            e = out.get(s.name)
            if e is None:
                e = out[s.name] = {"calls": [0] * n}
                for key in ("device_ms", "host_ms", "self_device_ms"):
                    e[key] = [0.0] * n
            i = s.item
            e["calls"][i] += 1
            e["device_ms"][i] += device[s.index]
            e["host_ms"][i] += (s.t1 - s.t0) / 1e6
            e["self_device_ms"][i] += device[s.index] - child_device.get(s.index, 0.0)
        return {"items": n, "spans": out}


class _Span:
    __slots__ = ("rec", "name", "index", "parent", "item", "t0", "t1", "ev0", "ev1", "range")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> "_Span":
        rec = self.rec
        if rec.open:
            self.parent, self.item = rec.open[-1].index, rec.open[-1].item
        else:
            self.parent, self.item = -1, rec.items
            rec.items += 1
        self.index = len(rec.spans)
        rec.spans.append(self)
        rec.open.append(self)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t1 = self.ev1 = self.ev0 = None
        if rec.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self.ev1 is not None:
            self.ev1.record()
        if self.rec.open and self.rec.open[-1] is self:
            self.rec.open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A span named ``name`` around a ``with`` block (a shared null context
    while the recorder is off)."""
    rec = _rec
    if rec is None:
        return _NULL
    return _Span(rec, name)


def traced(name: str) -> Callable:
    """Decorator: every call of the function inside ``span(name)``."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = _rec
            if rec is None:
                return fn(*args, **kwargs)
            with _Span(rec, name):
                return fn(*args, **kwargs)

        return call

    return wrap


@contextlib.contextmanager
def capture(cuda: bool) -> Iterator[Recorder]:
    """Record the block's spans into a new ``Recorder``, with CUDA event
    pairs where ``cuda`` (the device the block's work runs on). The recorder
    in force before the block (or none) is back in force after it."""
    global _rec
    saved, _rec = _rec, Recorder(cuda)
    try:
        yield _rec
    finally:
        _rec = saved
