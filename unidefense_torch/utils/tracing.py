"""Named spans of the program's phases, recorded where the work happens.

``span(name)`` marks a phase:

    with span("ud.train.forward"):
        out = model(x)

It costs a flag check and ``torch.autograd._profiler_enabled()`` when
nothing records (one shared no-op object is returned). While
``torch.profiler`` runs, the span is a ``record_function`` of the same name,
so it shows in the profiler's Chrome trace (the engines'
``profile_start_step``). While a recorder is open (``recording()``), the
span appends ``(name, start_ns, end_ns, parent, thread)`` to the recorder's
list: the times on ``time.time_ns()``, the Unix-ns clock on which
``torch.profiler`` stamps its events, ``parent`` the index in the list of
the span open around it on the same thread (-1 for a root), so the spans of
one step or request share their root's index. Nothing is written to disk.

The program's spans:

- ``ud.train.step``: one call of a train step (``train/step``), with, per
  pass, ``ud.train.forward`` (the model, the losses up to the total),
  ``ud.train.backward`` (``total.backward()``) and ``ud.train.update`` (the
  gradient exchange and the optimizer's update), and in the two-pass step
  ``ud.train.perturb`` (pass 2's draws and input) between the passes;
- ``ud.serve.request``: one ``Predictor.predict_frames`` call, with per
  batch ``ud.serve.stage`` (the padded index, the host copy to every
  replica) and ``ud.serve.forward`` (the int8 weights' dequantization and
  the eval step's launches).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional

import torch

_recorder: Optional[list] = None  # the open recorder's list of spans
_local = threading.local()  # .open: this thread's open (list, index) pairs


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "rf", "out", "index")

    def __init__(self, name: str, out: Optional[list]):
        self.name, self.out, self.rf = name, out, None

    # the recorded span holds the profiler's event of the same name
    def __enter__(self):
        if self.out is not None:
            stack = getattr(_local, "open", None)
            if stack is None:
                stack = _local.open = []
            parent = stack[-1][1] if stack and stack[-1][0] is self.out else -1
            self.index = len(self.out)
            self.out.append((self.name, time.time_ns(), None, parent, threading.get_ident()))
            stack.append((self.out, self.index))
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.out is not None:
            name, start, _, parent, tid = self.out[self.index]
            self.out[self.index] = (name, start, time.time_ns(), parent, tid)
            _local.open.pop()
        return False


def span(name: str):
    """A context manager that marks ``name`` for the profiler and the open
    recorder; the shared no-op one when neither is on."""
    out = _recorder
    if out is None and not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return _Span(name, out)


@contextmanager
def recording() -> Iterator[list]:
    """Record every span opened inside into the list it yields (a span
    still open at the end keeps ``end_ns`` None). An inner ``recording()``
    takes the spans until it closes."""
    global _recorder
    outer, out = _recorder, []
    _recorder = out
    try:
        yield out
    finally:
        _recorder = outer
