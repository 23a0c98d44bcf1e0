"""The traced run's records: device events from ``torch.profiler`` kept in
memory (no trace file), reduced to the numbers the per-layer readers take.

``KERNEL_GROUPS`` is a frozen copy of ``chip_smoke.KERNEL_GROUPS``
(chip_smoke.py:1065-1076 at the commit that added the benchmark): kernel-name
fragments, first match wins; a kernel no group names is "elementwise and
other", the model's eager glue.

Busy time is the union of the device's kernel, copy and memset intervals,
so kernels that overlap on two streams count once; idle is the traced
window less that union. On four cards every rank traces its card: the
result line's ``busy_s`` and ``window_s`` average them, the per-layer
metrics and the breakdown read rank 0's.
"""

from __future__ import annotations

from collections import defaultdict

KERNEL_GROUPS = (
    ("weight sums (K2-bwd, K3-bwd, K4-bwd)", ("dw_wgmma", "dw_fma", "reduce_splits")),
    ("K2 channel mix", ("sfconv_mix_wgmma", "sfconv_freq_fwd_kernel")),
    ("K3/K4 row-tiled mix", ("rowtiled_mix",)),
    ("Hilbert rows (all SFConv kernels)", ("hilbert_rows",)),
    ("K1 normalize_flip", ("normalize_flip",)),
    ("cuDNN convolutions", ("conv", "xmma", "implicit_gemm", "cudnn", "dgrad", "wgrad")),
    ("cuFFT", ("fft", "regular_fft", "vector_fft")),
    ("GEMM", ("gemm", "cutlass", "cublas")),
    ("optimizer (multi-tensor)", ("multi_tensor", "foreach")),
    ("copies and memsets", ("memcpy", "memset")),
)
GLUE = "elementwise and other"
SPAN_PREFIX = "perfbench."


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), GLUE)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle (start, end) gaps in [lo, hi] that the intervals leave."""
    out, at = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def reduce_events(device_events: list, host_spans: list, window: tuple, units: int) -> dict:
    """Records of a traced window.

    ``device_events``: (name, start_us, end_us) of every kernel, copy and
    memset on the device; ``host_spans``: (name, start_us, end_us) of the
    host's operations and the benchmark's own spans; ``window``: (start_us,
    end_us) of the traced window; ``units``: the steps or batches in it."""
    lo, hi = window
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in device_events if e > lo and s < hi]
    groups_ms: dict = defaultdict(float)
    by_name: dict = defaultdict(float)
    h2d_ms = nccl_ms = 0.0
    for n, s, e in inside:
        groups_ms[group_of(n)] += (e - s) / 1e3
        by_name[n] += (e - s) / 1e6
        low = n.lower()
        if "htod" in low:
            h2d_ms += (e - s) / 1e3
        if "nccl" in low:
            nccl_ms += (e - s) / 1e3
    busy_us = union_length([(s, e) for _, s, e in inside])
    idle = defaultdict(float)
    holes = gaps([(s, e) for _, s, e in inside], lo, hi)
    for (gs, ge), label in zip(holes, host_labels(host_spans, [g[0] for g in holes])):
        idle[label] += (ge - gs) / 1e6
    return {
        "units": units,
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy_us / 1e6,
        "groups_ms": dict(groups_ms),
        "h2d_ms": h2d_ms,
        "nccl_ms": nccl_ms,
        "device_ops": sorted(([n, v] for n, v in by_name.items()), key=lambda t: -t[1])[:10],
        "idle_gaps": sorted(([n, v] for n, v in idle.items()), key=lambda t: -t[1])[:10],
    }


def host_labels(spans: list, times: list) -> list:
    """For each of the ascending ``times``, "<benchmark span> / <host op>":
    the innermost benchmark span and the innermost other host operation
    (the latest started) open at that time."""
    import heapq

    spans = sorted(spans, key=lambda t: t[1])
    active: list = []  # (end, start, name)
    out, i = [], 0
    for t in times:
        while i < len(spans) and spans[i][1] <= t:
            n, s, e = spans[i]
            heapq.heappush(active, (e, s, n))
            i += 1
        while active and active[0][0] < t:
            heapq.heappop(active)
        open_ = [(s, n) for e, s, n in active if e >= t]
        own = max(((s, n) for s, n in open_ if n.startswith(SPAN_PREFIX)), default=None)
        op = max(((s, n) for s, n in open_ if not n.startswith(SPAN_PREFIX)), default=None)
        label = own[1][len(SPAN_PREFIX):] if own else "outside spans"
        out.append(f"{label} / {op[1]}" if op else label)
    return out


def profile_window(fn, device) -> dict:
    """Run ``fn()`` (which returns its unit count) under ``torch.profiler``
    with the events kept in memory, and reduce them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN_PREFIX + "traced_window"):
            units = fn()
            torch.cuda.synchronize(device)
    dev_events, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, t0, t1 = e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            # a span's mirror on the device's timeline is no device work
            mirror = getattr(e, "is_user_annotation", lambda: False)()
            if not (mirror or name.startswith(SPAN_PREFIX)):
                dev_events.append((name, t0, t1))
        elif name == SPAN_PREFIX + "traced_window":
            window = (t0, t1)
        else:
            host.append((name, t0, t1))
    if window is None or not dev_events:
        return {}
    return reduce_events(dev_events, host, window, units)
