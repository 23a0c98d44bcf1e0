"""The light traced window: the program's own spans
(``unidefense_torch/utils/tracing.py``) and the card's work, read without
recording the host's operations, so that the host keeps close to its
untraced pace.

``light_window(fn, device)`` runs ``fn`` (which returns its unit count)
with the program's recorder open, under ``torch.profiler`` with CUDA
activity alone: the profiler then keeps the card's kernels, copies and
memsets and the host's CUDA runtime calls, and no aten op. Its events and
the spans share one clock (the Unix ns of ``time.time_ns()``).

``reduce_spans`` turns them into, per span name:

- ``count``, ``wall_ms`` (summed), ``self_ms`` (wall less the part its
  child spans cover);
- ``idle_ms``: the card's idle time inside the span, children included;
  ``self_idle_ms``: the pieces of it that fall to this span as the
  innermost open one (every idle gap is cut at span edges, each piece
  given to the innermost span open over it, or to "outside");
- ``syncs``: runtime calls that block the host (a name with
  ``Synchronize``, a ``cudaMemcpy``/``cuMemcpy`` that is not ``Async``)
  started inside the span, children included; ``self_syncs``: those whose
  innermost span it is.

and ``sync_calls``, the count of each "<innermost span> / <call>".

A program without the recorder (the commit before the spans) gives an
empty ``spans``: its readers then return nothing.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

from perfbench.trace import gaps, union_length

OUTSIDE = "outside"


def is_sync(name: str) -> bool:
    """A CUDA runtime or driver call that blocks the host until the card has
    caught up."""
    return "Synchronize" in name or (name.startswith(("cudaMemcpy", "cuMemcpy"))
                                     and "Async" not in name)


def _recorder():
    """The program's ``recording()``, or one that records nothing."""
    try:
        from unidefense_torch.utils.tracing import recording
    except ImportError:
        return contextlib.nullcontext([])
    return recording()


def light_window(fn, device) -> dict:
    """Run ``fn()`` with the program's spans recorded under a CUDA-only
    profile, and reduce them (``reduce_spans``); on the CPU (the tests) the
    spans alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    traced = profile(activities=[ProfilerActivity.CUDA]) if cuda else contextlib.nullcontext()
    with traced as prof:
        with _recorder() as spans:
            lo = time.time_ns()
            units = fn()
            if cuda:
                torch.cuda.synchronize(device)
            hi = time.time_ns()
    dev_events, runtime = [], []
    for e in prof.profiler.kineto_results.events() if cuda else ():
        event = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            # a span's mirror on the device's timeline is no device work
            if not getattr(e, "is_user_annotation", lambda: False)():
                dev_events.append(event)
        elif e.name().startswith("cu"):
            runtime.append(event)
    return reduce_spans(list(spans), dev_events, runtime, (lo, hi), units)


def _innermost(spans: list, times: list) -> list:
    """For each of the ascending ``times``, the index of the innermost span
    (the latest started) open at it, or None."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][1])
    active, out, k = [], [], 0
    for t in times:
        while k < len(order) and spans[order[k]][1] <= t:
            active.append(order[k])
            k += 1
        active = [i for i in active if spans[i][2] > t]
        out.append(max(active, key=lambda i: spans[i][1]) if active else None)
    return out


def reduce_spans(spans: list, device_events: list, runtime: list, window: tuple,
                 units: int) -> dict:
    """Records of a light window.

    ``spans``: (name, start_ns, end_ns, parent, thread) as the program
    records them (an end of None: still open, taken as the window's end);
    ``device_events``: (name, start_ns, end_ns) of every kernel, copy and
    memset on the card; ``runtime``: (name, start_ns, end_ns) of the host's
    CUDA runtime and driver calls; ``window``: (start_ns, end_ns);
    ``units``: the steps or requests ``fn`` ran."""
    lo, hi = window
    spans = [(n, max(s, lo), min(hi if e is None else e, hi), p) for n, s, e, p, _ in spans]
    busy = [(max(s, lo), min(e, hi)) for _, s, e in device_events if e > lo and s < hi]
    holes = gaps(busy, lo, hi)
    edges = sorted({t for _, s, e, _ in spans for t in (s, e)})
    pieces = []
    for gs, ge in holes:
        cuts = [t for t in edges if gs < t < ge]
        pieces += list(zip([gs] + cuts, cuts + [ge]))
    owners = _innermost(spans, [a for a, _ in pieces])
    self_idle = defaultdict(float)
    for (a, b), i in zip(pieces, owners):
        self_idle[OUTSIDE if i is None else i] += b - a
    syncs = sorted((s, n) for n, s, _ in runtime if is_sync(n) and lo <= s <= hi)
    self_syncs, calls = defaultdict(int), defaultdict(int)
    for i, (_, call) in zip(_innermost(spans, [t for t, _ in syncs]), syncs):
        self_syncs[OUTSIDE if i is None else i] += 1
        calls[f"{OUTSIDE if i is None else spans[i][0]} / {call}"] += 1
    children = defaultdict(list)
    for i, (_, s, e, p) in enumerate(spans):
        if p >= 0:
            children[p].append((s, e))
    out: dict = defaultdict(lambda: dict.fromkeys(
        ("count", "wall_ms", "self_ms", "idle_ms", "self_idle_ms", "syncs", "self_syncs"), 0))
    for i, (name, s, e, _) in enumerate(spans):
        r = out[name]
        r["count"] += 1
        r["wall_ms"] += (e - s) / 1e6
        r["self_ms"] += (e - s - union_length(
            [(max(cs, s), min(ce, e)) for cs, ce in children[i] if ce > s and cs < e])) / 1e6
        r["idle_ms"] += sum(min(ge, e) - max(gs, s) for gs, ge in holes
                            if ge > s and gs < e) / 1e6
        r["self_idle_ms"] += self_idle[i] / 1e6
        r["syncs"] += sum(1 for t, _ in syncs if s <= t < e)
        r["self_syncs"] += self_syncs[i]
    return {"units": units, "window_s": (hi - lo) / 1e9, "busy_s": union_length(busy) / 1e9,
            "spans": dict(out), "sync_calls": dict(calls),
            OUTSIDE: {"idle_ms": self_idle[OUTSIDE] / 1e6, "syncs": self_syncs[OUTSIDE]}}


def span_stat(rec: dict, name: str, key: str):
    """``key`` of span ``name`` in the records' light window, or None."""
    found = (rec.get("spans") or {}).get("spans", {}).get(name)
    return None if not found or not found["count"] else found[key]
