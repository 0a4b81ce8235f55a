"""One launch path and one counter registry for the port's CUDA ops.

``Entry(source, name, argtypes)`` is an ``extern "C"`` entry point of
``cuda/<source>.cu``, bound at its first call. ``entry(*args)`` calls an
entry that launches nothing; ``entry.launch(op, device, *args)`` runs a
launch entry, whose last argument is the stream, on ``device`` and its
current stream, and turns a non-zero code into a ``RuntimeError`` that
names ``op`` and carries the source's own ``<source>_error_string``.

The ops count their launches on attributes of their public functions
(``plane_sweep_sad.launches``, ``photo_error_fwd.launches_by_batch``, ...),
which the decorator ``counted`` creates; ``tally`` makes a keyed count
outside an op (``models/layers.py::pad_counts``). Both hold what they make
here: ``reset()`` zeroes every counter, and ``counts()`` reads them all,
by ``"<op>.<counter>"`` and the tally's name.
"""

from __future__ import annotations

import collections
import ctypes
import types
from typing import Any, Dict, List, Sequence, Tuple

import torch

from monorec_tpu_torch.ops.cuda import build


class Entry:
    """The ``extern "C"`` entry point ``name`` of ``cuda/<source>.cu``, bound
    with its ctypes signature at its first call (``build.load`` builds and
    loads the source then, once for all its entries)."""

    def __init__(self, source: str, name: str, argtypes: Sequence, restype=ctypes.c_int):
        self.source, self.name = source, name
        self.argtypes, self.restype = list(argtypes), restype
        self.fn = None

    def _bind(self):
        fn = getattr(build.load(self.source), self.name)
        fn.argtypes, fn.restype = self.argtypes, self.restype
        self.fn = fn
        return fn

    def __call__(self, *args):
        fn = self.fn
        return (fn if fn is not None else self._bind())(*args)

    def launch(self, op: str, device, *args) -> None:
        """Launch on ``device`` and its current stream; raise on an error."""
        fn = self.fn
        if fn is None:
            fn = self._bind()
        with torch.cuda.device(device):
            # The current stream's raw handle: no ``torch.cuda.Stream`` is
            # made for a launch.
            code = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
        if code != 0:
            error_string = getattr(build.load(self.source), f"{self.source}_error_string")
            error_string.argtypes, error_string.restype = [ctypes.c_int], ctypes.c_char_p
            raise RuntimeError(f"{op} launch failed: {error_string(code).decode()} ({code})")


# Every counter: its name in ``counts()``, the object that holds it, and
# the attribute it is.
_HELD: List[Tuple[str, Any, str]] = []


def _hold(name: str, owner: Any, attr: str, value) -> None:
    setattr(owner, attr, value)
    _HELD.append((name, owner, attr))


def counted(*attrs: str):
    """Decorator: give the op each counter of ``attrs`` as an attribute at
    0, a ``collections.Counter`` (launches by a key) where the name has
    ``_by_`` in it and an int else, and hold them for ``reset``."""

    def register(op):
        for attr in attrs:
            _hold(f"{op.__name__}.{attr}", op, attr,
                  collections.Counter() if "_by_" in attr else 0)
        return op

    return register


def tally(name: str) -> collections.Counter:
    """A ``collections.Counter`` held for ``reset`` under ``name``."""
    holder = types.SimpleNamespace()
    _hold(name, holder, "counter", collections.Counter())
    return holder.counter


def reset() -> None:
    """Zero every counter in place (a Counter keeps its identity)."""
    for _, owner, attr in _HELD:
        value = getattr(owner, attr)
        if isinstance(value, collections.Counter):
            value.clear()
        else:
            setattr(owner, attr, 0)


def counts() -> Dict[str, Any]:
    """Every counter by name, a Counter as a dict."""
    return {name: dict(v) if isinstance(v := getattr(owner, attr), collections.Counter) else v
            for name, owner, attr in _HELD}
