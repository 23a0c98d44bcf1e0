#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --quick    # build, then run and check each kernel once

Phases: build the CUDA kernels from ``unidefense_torch/csrc``; hold K1
(normalize_flip), K2 (sfconv_freq forward), K2-bwd (its weight sums, with
K2 on the gradient for x_bar), K3 (sfconv_freq_v4, split output), K3-bwd,
K4 (sfconv_freq_v3, over a materialised double reversal) and K4-bwd
against their plain PyTorch versions on the card at the shapes the serving
and training paths of UDEB4, UDR18 and UDR50 and the per-op A/B tool give
them (``SFCONV_SHAPES``), timing each (K1 warm and with L2 cold, beside a
copy of the same bytes; K2, K3 and K4 also as their Hilbert pass and their
mix apart; every SFConv kernel but K3-bwd and K4-bwd beside a cuBLAS
product of the same shape as a yardstick), checking the block split bit for
bit, and checking that two runs of each bf16 weight-sum kernel agree bit
for bit; serve UDEB4 at 380x380, batch 32, bf16 through ``Predictor`` with
seeded random weights and check that every batch went through K1 and K2;
compare the card's fp32 and bf16 Predictor with the CPU Predictor; train
UDEB4 at 380x380, 10 real + 10 fake, bf16, with the two-pass step and the
optimizer of config_template/forgery/model_udeb4.yml, checking every step's
launches of K1, K2 and K2-bwd; compare one fp32 training step on the card
with the same step on the CPU. Then the same paths on the K3 route
(``v4_widths`` {48, 24} at 380^2, {32, 16} at 256^2), where K3 and K3-bwd
take the SFConv widths listed; the same four paths on the default route for
UDR18 at 256x256 (config_template/ocim/model_udr18.yml) and UDR50 at
380x380 (config_template/uniatt/Prot1/model_udr50.yml), tagged
``-udr18`` and ``-udr50``; and the per-op A/B tool
``unidefense_torch.tools.bench_sfconv``, the path of K4 and K4-bwd; and
the FE engine behind ``python -m unidefense_torch.main`` (``[engine-fe]``):
UDEB4 at 380x380, 10 real + 10 fake, bf16, trained 6 steps with validation,
tested from its best checkpoint and resumed to step 9, on a synthetic FF++
tree of JPEG frames written and decoded by the port's host JPEG library,
checking every train step's and eval batch's launches of K1, K2 and
K2-bwd. Any failure raises, so the exit code is not 0 and no result line is
printed.
The last line is the result object; the line before it the kernel table.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak
SEED = 0

# each model's YAML and the resolution its data YAML crops to:
# config_template/forgery/data_ffc23.yml, ocim/data_m.yml (RandomResizedCrop
# 256) and uniatt/Prot1/data_ffpp.yml (380); each trains at 10 real + 10 fake
MODELS = {
    "UDEB4": ("config_template/forgery/model_udeb4.yml", 380),
    "UDR18": ("config_template/ocim/model_udr18.yml", 256),
    "UDR50": ("config_template/uniatt/Prot1/model_udr50.yml", 380),
}


@functools.lru_cache(maxsize=None)
def model_spec(name: str) -> dict:
    """A model's ``model:`` and ``config:`` sections, as its YAML gives them
    (``registry.build_model`` takes the model keys its class takes), its
    resolution and the ``num_steps`` of the data YAML it names."""
    import yaml

    root = os.path.dirname(os.path.abspath(__file__))
    path, res = MODELS[name]
    with open(os.path.join(root, path)) as f:
        doc = yaml.safe_load(f)
    with open(os.path.join(root, doc["data"]["file"])) as f:
        num_steps = int(yaml.safe_load(f)["num_steps"])
    return dict(res=res, model=doc["model"], config=doc["config"], num_steps=num_steps)


# (H=W, C, launches per forward) of every SFConv frequency branch of a model
# at a resolution, in forward order; the branch runs at the SFConv's input
# size (a strided SFConv pools it after)
SFCONV_SHAPES = {
    ("UDEB4", 380): [(95, 192, 1), (48, 336, 4), (24, 672, 6), (24, 960, 6), (12, 1632, 7)],
    ("UDEB4", 256): [(64, 192, 1), (32, 336, 4), (16, 672, 6), (16, 960, 6), (8, 1632, 7)],
    ("UDR18", 256): [(64, 128, 3), (32, 256, 3), (16, 512, 2)],
    ("UDR18", 380): [(95, 128, 3), (48, 256, 3), (24, 512, 2)],
    ("UDR50", 256): [(64, 128, 1), (32, 128, 3), (32, 256, 1), (16, 256, 5), (16, 512, 1),
                     (8, 512, 1)],
    ("UDR50", 380): [(95, 128, 1), (48, 128, 3), (48, 256, 1), (24, 256, 5), (24, 512, 1),
                     (12, 512, 1)],
}
# the K3 route: SFConv widths given to K3 (sfconv_pallas.py:79's A/B setting
# at 380^2, and the same blocks at 256^2)
V4_WIDTHS = {380: frozenset({48, 24}), 256: frozenset({32, 16})}


def per_forward_launches(model: str, res: int, v4_widths) -> tuple[int, int]:
    """(K2, K3) launches of one forward of ``model`` at res^2 on a route."""
    from unidefense_torch.ops.sfconv_rowtiled import uses_v4

    shapes = SFCONV_SHAPES[model, res]
    k3 = sum(n for hw, c, n in shapes if uses_v4((1, hw, hw, c), v4_widths))
    return sum(n for _, _, n in shapes) - k3, k3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from unidefense_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {sorted(libs)} built for sm_90a in {time.perf_counter() - t0:.2f} s "
        f"(nvcc wall {_build.build_seconds:.2f} s)")
    for name, text in _build.build_logs().items():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers", "spill", "smem", "warning")):
                log(f"[ptxas {name}] {line.strip()}")


def time_queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``iters`` launches of ``fn`` back to back with the
    host ahead of the card: the launches queue behind a spin of about 5 ms
    on the card (``torch.cuda._sleep``), so a kernel shorter than the host's
    cost per call is timed and not the host. The input stays in L2."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_cold_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Median time of ``iters`` launches of ``fn``, each timed alone with L2
    cold: before each, outside its event pair, a 256 MB scratch buffer is
    written, then its first half read back, so that L2 holds none of fn's
    inputs and no dirty line that fn's own writes would have to write back."""
    import torch

    scratch = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for i in range(iters):
        scratch.fill_(float(i))
        scratch[: scratch.numel() // 2].sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


K1_MEAN, K1_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _k1_check(x, flip, dt, tol: float, what: str) -> tuple[float, bool]:
    """K1 against its plain version on the card: (max |err|, bitwise equal);
    raises past ``tol``."""
    import torch

    from unidefense_torch.ops.preprocess import normalize_flip, normalize_flip_plain

    got = normalize_flip(x, flip, K1_MEAN, K1_STD, dt)
    ref = normalize_flip_plain(x, flip, K1_MEAN, K1_STD, dt)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"K1 {what} {dt}: max |err| {err} > {tol}")
    return err, torch.equal(got, ref)


def phase_k1(quick: bool, card: str) -> dict:
    """K1 against its plain version at the serving (b32) and training (b20)
    batches of 380² and 256² and the FE engine's validation (b64) and test
    (b96) batches of 380², each flip pattern and both output dtypes; on a
    contiguous view that is not 16-byte aligned (the scalar path); at small
    shapes with a partial last tile, a vector across rows, and no tile at
    all. Then the times at the four serving and training batches: cold (time_cold_ms, the one
    the bound's share is taken from), queued (time_queued_ms) and warm
    (time_ms, back to back as the host issues them: for a kernel this short
    that is the host's cost per call), beside the plain version's and the
    bytes yardstick ``copy_ms``, one u8 -> out_dtype copy_ of the same
    bytes (not library_ms: it does not compute K1's function)."""
    from functools import partial

    import torch

    from unidefense_torch.ops.preprocess import (
        normalize_flip, normalize_flip_geometry, normalize_flip_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dtypes = ((torch.float32, 1e-5), (torch.bfloat16, 1e-2))
    worst, exact, checks = 0.0, True, 0

    def check(x, flip, dt, tol, what):
        nonlocal worst, exact, checks
        err, same = _k1_check(x, flip, dt, tol, what)
        worst, exact, checks = max(worst, err), exact and same, checks + 1

    batches = [(n, size) for size in (380, 256) for n in (32, 20)]
    # checked, not timed: the FE engine's validation (b64) and test (b96)
    # batches of 380^2; K1's tiles and grid follow the batch
    checked = batches + [(64, 380), (96, 380)]
    inputs = {}
    for n, size in checked:
        x = torch.randint(0, 256, (n, size, size, 3), generator=gen, device="cuda",
                          dtype=torch.uint8)
        mixed = torch.rand(n, generator=gen, device="cuda") < 0.5
        inputs[n, size] = x, mixed
        for flip in (None, torch.ones(n, dtype=torch.bool, device="cuda"), mixed):
            for dt, tol in dtypes:
                check(x, flip, dt, tol, f"{n}x{size}x{size}x3")
        flat = torch.randint(0, 256, (x.numel() + 16,), generator=gen, device="cuda",
                             dtype=torch.uint8)
        view = flat[1:1 + x.numel()].view(x.shape)
        if not (view.is_contiguous() and view.data_ptr() % 16 == 1):
            raise AssertionError("K1: the offset view is not a misaligned contiguous batch")
        for dt, tol in dtypes:
            check(view, mixed, dt, tol, f"{n}x{size}x{size}x3 at a 1-byte offset")
    for shape in ((3, 7, 13), (4, 5, 1), (2, 3, 7), (1, 3, 427)):
        x = torch.randint(0, 256, (*shape, 3), generator=gen, device="cuda", dtype=torch.uint8)
        flip = torch.arange(shape[0], device="cuda") % 3 != 1
        for dt, tol in dtypes:
            check(x, flip, dt, tol, f"{shape}")
            view = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
            check(view, flip, dt, tol, f"{shape} at a 1-byte offset")
    log(f"[K1] {checks} checks ({len(checked)} batches {checked} x 3 flip patterns x 2 dtypes, "
        f"1-byte offsets, small shapes): max |err| {worst:.3g} (tol 1e-5 fp32, 1e-2 bf16), bitwise equal to plain: "
        f"{exact}")
    if quick:
        return dict(max_abs_err=worst)
    main = None
    for n, size in batches:
        x, flip = inputs[n, size]
        for dt, _ in dtypes:
            g = normalize_flip_geometry(n, size, size, dt)
            out_bytes = torch.finfo(dt).bits // 8
            nbytes = x.numel() * (1 + out_bytes) + flip.numel()
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            kernel = partial(normalize_flip, x, flip, K1_MEAN, K1_STD, dt)
            plain = partial(normalize_flip_plain, x, flip, K1_MEAN, K1_STD, dt)

            def copy(x=x, dt=dt):
                return torch.empty(x.shape, dtype=dt, device="cuda").copy_(x)

            t = dict(warm=time_ms(kernel), queued=time_queued_ms(kernel), ms=time_cold_ms(kernel),
                     plain_warm=time_ms(plain), plain_ms=time_cold_ms(plain),
                     copy_warm=time_ms(copy), copy_ms=time_cold_ms(copy))
            log(f"[K1] {n}x{size}x{size}x3 -> {dt} (R {g.rows}, {g.tiles} tiles, {g.tail} scalar "
                f"rows, grid {g.grid}): kernel cold {t['ms']:.4f} ms ({bound / t['ms']:.1%} of "
                f"bound), queued {t['queued']:.4f} ms, warm {t['warm']:.4f} ms; plain cold "
                f"{t['plain_ms']:.4f}, warm {t['plain_warm']:.4f}; copy_ms cold "
                f"{t['copy_ms']:.4f}, warm {t['copy_warm']:.4f} (kernel / copy cold "
                f"{t['ms'] / t['copy_ms']:.3f}); bound {bound:.4f} ms (bytes {nbytes}), {card}")
            if (n, size, dt) == (32, 380, torch.float32):
                main = dict(ms=t["ms"], queued_ms=t["queued"], warm_ms=t["warm"],
                            plain_ms=t["plain_ms"], copy_ms=t["copy_ms"], bound_ms=bound,
                            bound_by="bytes")
    return dict(max_abs_err=worst, **main)


def _sfconv_bound_ms(n, hw, c, hilberts, streams, out_bytes) -> tuple[float, str]:
    # the four C x C channel mixes per pixel and `hilberts` Hilbert products
    # hm@x per image row (K2's hm@x_m is the product at the mirror row m, not
    # a second one); `streams` (N, H, W, C) bf16 tensors read or written
    # once, and `out_bytes` of bf16 blocks read or fp32 sums written
    flops = n * hw * (8 * hw * c * c + 2 * hilberts * hw * hw * c)
    nbytes = streams * n * hw * hw * c * 2 + out_bytes
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sfconv_check_shapes() -> list[tuple[int, int, str]]:
    """(H=W, C, origin) of every shape the SFConv frequency kernels are
    checked at: UDEB4's at 380^2 and 256^2, then those of the per-op A/B
    tool that UDEB4 lacks (80^2/C192 and 12^2/C960), then UDR18's and
    UDR50's (C = 128, 256, 512)."""
    from unidefense_torch.tools.bench_sfconv import SHAPES_256, SHAPES_380

    shapes = {(hw, c): f"UDEB4 {res}^2" for (model, res), ss in SFCONV_SHAPES.items()
              if model == "UDEB4" for hw, c, _ in ss}
    for _, w, c in SHAPES_256 + SHAPES_380:
        shapes.setdefault((w, c), "A/B tool")
    for (model, res), ss in SFCONV_SHAPES.items():
        for hw, c, _ in ss:
            shapes.setdefault((hw, c), f"{model} {res}^2")
    return [(hw, c, origin) for (hw, c), origin in shapes.items()]


def _mix_operand(x, mirrored: bool = True):
    """[x | hx], or with ``mirrored`` [x | hx | R(x) | R(hx)], as one (P, 2C)
    or (P, 4C) matrix, hx = hm @ x per image row: a mix's products as one,
    for the cuBLAS yardsticks."""
    import torch

    from unidefense_torch.ops.sfconv_spatial import double_reversal, hilbert_row_matrix

    hm = hilbert_row_matrix(x.shape[2]).to(device=x.device, dtype=x.dtype)
    hx = torch.einsum("dv,nhvc->nhdc", hm, x)
    parts = [x, hx, double_reversal(x), double_reversal(hx)] if mirrored else [x, hx]
    return torch.cat(parts, dim=-1).reshape(-1, len(parts) * x.shape[-1]).contiguous()


def k2_gemm(x, w):
    """cuBLAS yardstick of K2, never called by the port: (P, 4C) @ (4C, C) in
    x's dtype, the operand materialised beforehand. K4's yardstick too: its
    [x | hx | rx | hr] @ (4C, C) has the same shape."""
    import torch

    a = _mix_operand(x)
    b = torch.randn(a.shape[1], x.shape[-1], device=x.device).to(x.dtype)
    return lambda: torch.matmul(a, b)


def k3_gemm(x, w):
    """cuBLAS yardstick of K3: [x | hx] (P, 2C) @ (2C, 2C), o1 and o2 side by
    side."""
    import torch

    a = _mix_operand(x, mirrored=False)
    b = torch.randn(a.shape[1], a.shape[1], device=x.device).to(x.dtype)
    return lambda: torch.matmul(a, b)


def k2_bwd_gemm(x, g):
    """cuBLAS yardstick of K2-bwd's sums: A^T g with A = [x | hx | R(x) | R(hx)]."""
    import torch

    a, gm = _mix_operand(x), g.reshape(-1, g.shape[-1])
    return lambda: torch.matmul(a.t(), gm)


def k2_parts(x, w):
    """K2's Hilbert pass and its mix as separate calls (bf16; each with
    K2's block split): (the Hilbert pass, the mix on its hx)."""
    from functools import partial

    from unidefense_torch.ops import sfconv_cuda as k2

    hx = k2._launch(x, w, part="hilbert")
    return partial(k2._launch, x, w, part="hilbert"), partial(k2._launch, x, w, part="mix", hx=hx)


def k3_parts(x, w):
    """K3's Hilbert pass and its mix apart, as :func:`k2_parts`."""
    from functools import partial

    from unidefense_torch.ops import sfconv_rowtiled as rt

    hx = rt._launch_v4(x, w, part="hilbert")
    return (partial(rt._launch_v4, x, w, part="hilbert"),
            partial(rt._launch_v4, x, w, part="mix", hx=hx))


def k4_parts(x, w):
    """K4's two Hilbert passes and its mix apart, on a materialised R(x)."""
    from functools import partial

    from unidefense_torch.ops import sfconv_rowtiled as rt
    from unidefense_torch.ops.sfconv_spatial import double_reversal

    rx = double_reversal(x).contiguous()
    hxr = rt._launch_v3(x, rx, w, part="hilbert")
    return (partial(rt._launch_v3, x, rx, w, part="hilbert"),
            partial(rt._launch_v3, x, rx, w, part="mix", hxr=hxr))


def split_check(x, w):
    """The block split on the card against its plain version, bit for bit:
    the forward's and x_bar's blocks, with the fourth block as K2 and K3 take
    it and negated as K4 takes it, from a row-major kernel and from a
    column-major view (as the model passes its weight)."""
    import torch

    from unidefense_torch.ops import sfconv_cuda as k2

    c = x.shape[-1]
    for wv in (w, w.t().contiguous().t()):
        for transposed in (False, True):
            for neg in (False, True):
                for dt in (torch.bfloat16, torch.float32):
                    got = k2._split_blocks(wv, c, dt, transposed, neg)
                    if not torch.equal(got, k2._added_blocks(wv, c, transposed, neg).to(dt)):
                        raise AssertionError(
                            f"block split C{c} {dt} transposed={transposed} negate_last={neg} "
                            f"strides {wv.stride()} differs from its plain version")


def sfconv_kernels() -> list[dict]:
    """The SFConv frequency kernels K2 to K4-bwd: each with its wrapper and
    plain version, its check batch and seed, the terms of its bound, and
    the workload its times are summed over as {(H=W, C): launches}. That is
    one UDEB4 forward or backward at 380^2 on the kernel's route (K2 and
    K2-bwd on the default route, K3 and K3-bwd on V4_WIDTHS), or one pass of
    the A/B tool over its shapes (K4 twice per shape, the forward and x_bar;
    K4-bwd once); K2 and K2-bwd also log their sums over a UDR18 and a UDR50
    forward or backward (``also``). A backward also has its sums kernel
    alone and the plain sums, as factories of (x, g) that return the call
    to time."""
    from functools import partial

    from unidefense_torch.ops import sfconv_cuda as k2
    from unidefense_torch.ops import sfconv_rowtiled as rt
    from unidefense_torch.ops.sfconv_spatial import double_reversal, sfconv_freq_spatial
    from unidefense_torch.tools.bench_sfconv import SHAPES_256, SHAPES_380

    fwd = {(hw, c): n for hw, c, n in SFCONV_SHAPES["UDEB4", 380]}
    udr = {(m, MODELS[m][1]): {(hw, c): n for hw, c, n in SFCONV_SHAPES[m, MODELS[m][1]]}
           for m in ("UDR18", "UDR50")}
    v4 = {k: n for k, n in fwd.items() if rt.uses_v4((1, k[0], k[0], k[1]), V4_WIDTHS[380])}
    ab = [(w, c) for _, w, c in SHAPES_256 + SHAPES_380]
    route = f"on v4_widths {sorted(V4_WIDTHS[380])}"
    ab_pass = f"per A/B tool pass (one fwd+bwd at each of its {len(ab)} shapes) b20"

    def with_rx(f):
        return lambda x, g: partial(f, x, double_reversal(x).contiguous(), g)

    return [
        # also_batches: the FE engine's train (b20), validation (b64) and
        # test (b96) forwards
        dict(name="K2", fn=k2.sfconv_freq, plain=sfconv_freq_spatial, batch=32, seed=SEED + 1,
             also_batches=(20, 64, 96), hilberts=1, streams=2, counts=fwd,
             workload="per UDEB4 forward at 380^2 b32",
             also={f"per {m} forward at {r}^2 b32": c for (m, r), c in udr.items()},
             parts=k2_parts, gemm=k2_gemm, check=split_check),
        dict(name="K2-bwd", fn=k2.sfconv_freq_bwd, plain=k2.sfconv_freq_bwd_plain, batch=20,
             seed=SEED + 4, hilberts=1, streams=2, counts=fwd,
             sums=lambda x, g: partial(k2._launch_dw, x, g),
             sums_plain=lambda x, g: partial(k2.weight_sums_plain, x, g), gemm=k2_bwd_gemm,
             workload="per UDEB4 backward at 380^2 b20",
             also={f"per {m} backward at {r}^2 b20": c for (m, r), c in udr.items()}),
        dict(name="K3", fn=rt.sfconv_freq_v4, plain=rt.sfconv_freq_v4_plain, batch=32,
             seed=SEED + 10, hilberts=1, streams=3, counts=v4, parts=k3_parts, gemm=k3_gemm,
             workload=f"per UDEB4 forward at 380^2 b32 {route}"),
        dict(name="K3-bwd", fn=rt.sfconv_freq_v4_bwd, plain=rt.sfconv_freq_v4_bwd_plain,
             batch=20, seed=SEED + 11, hilberts=1, streams=2, counts=v4,
             sums=lambda x, g: partial(rt._launch_v4_dw, x, g),
             sums_plain=lambda x, g: partial(rt.v4_weight_sums_plain, x, g),
             workload=f"per UDEB4 backward at 380^2 b20 {route}"),
        dict(name="K4", fn=rt.sfconv_freq_v3, plain=rt.sfconv_freq_v3_plain, batch=20,
             seed=SEED + 12, hilberts=2, streams=3, counts={k: 2 for k in ab}, parts=k4_parts,
             gemm=k2_gemm, workload=ab_pass),
        dict(name="K4-bwd", fn=rt.sfconv_freq_v3_bwd, plain=rt.sfconv_freq_v3_bwd_plain,
             batch=20, seed=SEED + 13, hilberts=2, streams=3, counts={k: 1 for k in ab},
             sums=with_rx(rt._launch_v3_dw), sums_plain=with_rx(rt.v3_weight_sums_plain),
             workload=ab_pass),
    ]


def _summed(spec: dict, per_shape: dict, card: str, counts=None, workload=None) -> dict:
    """The per-shape times of a kernel weighted by the launches of its
    workload (``spec``'s, unless given), logged; the extra readings (a
    backward's whole_ms, K2's hilbert_ms and mix_ms, the cuBLAS yardstick
    gemm_ms) are logged only. The sum is bound by operations where the
    shapes bound by operations carry most of its bound."""
    counts, workload = counts or spec["counts"], workload or spec["workload"]
    keys = [key for key in next(iter(per_shape.values())) if key != "by"]
    total = {key: sum(n * per_shape[k][key] for k, n in counts.items()) for key in keys}
    by_ops = sum(n * per_shape[k]["bound_ms"] for k, n in counts.items()
                 if per_shape[k]["by"] == "operations")
    total["bound_by"] = "operations" if 2 * by_ops >= total["bound_ms"] else "bytes"
    names = {"whole_ms": "whole backward", "hilbert_ms": "Hilbert pass", "mix_ms": "mix",
             "gemm_ms": "cuBLAS yardstick"}
    extra = "".join(f"; {names[k]} {total.pop(k):.3f} ms" for k in names if k in total)
    log(f"[{spec['name']}] {workload} ({sum(counts.values())} launches): kernel "
        f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, bound "
        f"{total['bound_ms']:.3f} ms{extra}, {card}")
    return total


def _summaries(spec: dict, per_shape: dict, card: str) -> dict:
    """Each ``also`` workload logged, then the kernel's own, returned."""
    for workload, counts in spec.get("also", {}).items():
        _summed(spec, per_shape, card, counts, workload)
    return _summed(spec, per_shape, card)


def phase_sfconv_fwd(spec: dict, quick: bool, card: str) -> dict:
    """A forward kernel (K2, K3, K4) at every shape of sfconv_check_shapes(),
    in bf16 and fp32 against the plain version in fp32 (within 2e-2 and 1e-4
    of max |ref|), timed beside the plain version in bf16; then, checked
    alone, at each batch of ``spec["also_batches"]`` over UDEB4's shapes at
    380^2 (the row grid follows the batch)."""
    import torch

    name, fn, plain, batch = spec["name"], spec["fn"], spec["plain"], spec["batch"]
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(spec["seed"])
    worst_abs, per_shape = 0.0, {}

    def check(n, hw, c, origin):
        nonlocal worst_abs
        x = torch.randn(n, hw, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn(2 * c, 2 * c, generator=gen, device="cuda") / (2 * c) ** 0.5
        if "check" in spec:
            spec["check"](x, w)
        got = fn(x, w)
        ref = plain(x.float(), w)
        got32 = fn(x.float(), w)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (got.float() - ref).abs().max().item()
        err32 = (got32 - ref).abs().max().item()
        worst_abs = max(worst_abs, err)
        if not (err <= 2e-2 * scale and err32 <= 1e-4 * scale):
            raise AssertionError(f"{name} {n}x{hw}^2/C{c}: bf16 err {err}, fp32 err {err32}, "
                                 f"max |ref| {scale}")
        head = (f"[{name}] {n}x{hw}x{hw}x{c} ({origin}): bf16 max |err| {err:.4g} = "
                f"{err / scale:.3g} of max |ref| (tol 2e-2); fp32 {err32 / scale:.3g} (tol 1e-4)")
        return x, w, head

    for hw, c, origin in sfconv_check_shapes():
        x, w, head = check(batch, hw, c, origin)
        if quick:
            log(head + " ok")
            continue
        ms = time_ms(lambda: fn(x, w), warmup=2, iters=10)
        plain_ms = time_ms(lambda: plain(x, w), warmup=2, iters=10)
        bound, by = _sfconv_bound_ms(batch, hw, c, spec["hilberts"], spec["streams"],
                                     4 * c * c * 2)
        extra = {}
        if "parts" in spec:
            hilbert, mix = spec["parts"](x, w)
            extra.update(hilbert_ms=time_ms(hilbert, warmup=2, iters=10),
                         mix_ms=time_ms(mix, warmup=2, iters=10))
            del hilbert, mix
        if "gemm" in spec:
            extra["gemm_ms"] = time_ms(spec["gemm"](x, w), warmup=2, iters=10)
            torch.cuda.empty_cache()
        parts = "".join(f", {k[:-3]} {v:.4f} ms" for k, v in extra.items())
        log(f"{head}; kernel {ms:.4f} ms{parts}, plain(bf16) {plain_ms:.4f} ms, bound {bound:.4f} "
            f"ms ({by}), {card}")
        per_shape[(hw, c)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, by=by, **extra)
    del x, w
    for n in spec.get("also_batches", ()):
        for hw, c, _ in SFCONV_SHAPES["UDEB4", 380]:
            log(check(n, hw, c, f"UDEB4 380^2 b{n}")[2] + " ok")
        torch.cuda.empty_cache()
    return dict(max_abs_err=worst_abs, **({} if quick else _summaries(spec, per_shape, card)))


def phase_sfconv_bwd(spec: dict, quick: bool, card: str) -> dict:
    """A backward (K2-bwd, K3-bwd, K4-bwd) at every shape of
    sfconv_check_shapes(): x_bar (the forward kernel on the gradient) and
    w_bar (the sums kernel and the repack) in bf16 and fp32 against the
    plain version in fp32, each within 2e-2 and 1e-4 of its own max |ref|.
    The sums kernel is timed alone, the whole backward beside it."""
    import torch

    name, bwd, bwd_plain, batch = spec["name"], spec["fn"], spec["plain"], spec["batch"]
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(spec["seed"])
    worst, per_shape = 0.0, {}
    for hw, c, origin in sfconv_check_shapes():
        x = torch.randn(batch, hw, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
        g = torch.randn(batch, hw, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn(2 * c, 2 * c, generator=gen, device="cuda") / (2 * c) ** 0.5
        ref_x, ref_w = bwd_plain(x.float(), g.float(), w)
        got_x, got_w = bwd(x, g, w)
        got32_x, got32_w = bwd(x.float(), g.float(), w)
        torch.cuda.synchronize()
        errs = []
        for part, ref, got, got32 in (("x_bar", ref_x, got_x, got32_x),
                                      ("w_bar", ref_w, got_w, got32_w)):
            scale = ref.abs().max().item()
            rel, rel32 = ((a.float() - ref).abs().max().item() / scale for a in (got, got32))
            errs.append(f"{part} bf16 {rel:.3g} fp32 {rel32:.3g}")
            worst = max(worst, rel * scale)
            if not (rel <= 2e-2 and rel32 <= 1e-4):
                raise AssertionError(f"{name} {hw}^2/C{c} {part}: bf16 rel err {rel}, "
                                     f"fp32 rel err {rel32}, max |ref| {scale}")
        del ref_x, ref_w, got_x, got_w, got32_x, got32_w
        sums = spec["sums"](x, g)
        if not torch.equal(sums(), sums()):  # split-K with a fixed-order reduction
            raise AssertionError(f"{name} {hw}^2/C{c}: two bf16 sums runs differ")
        head = (f"[{name}] {batch}x{hw}x{hw}x{c} ({origin}): error over max |ref| "
                f"{', '.join(errs)} (tol bf16 2e-2, fp32 1e-4); bf16 sums repeat bit for bit")
        if quick:
            log(head + " ok")
            continue
        ms = time_ms(sums, warmup=2, iters=10)
        plain_ms = time_ms(spec["sums_plain"](x, g), warmup=2, iters=10)
        whole = time_ms(lambda: bwd(x, g, w), warmup=2, iters=10)
        bound, by = _sfconv_bound_ms(batch, hw, c, spec["hilberts"], spec["streams"],
                                     4 * c * c * 4)
        extra = {}
        if "gemm" in spec:
            extra["gemm_ms"] = time_ms(spec["gemm"](x, g), warmup=2, iters=10)
            torch.cuda.empty_cache()
        gemm = f", cuBLAS A^T g {extra['gemm_ms']:.4f} ms" if extra else ""
        log(f"{head}; {name} kernel {ms:.4f} ms, plain(bf16) {plain_ms:.4f} ms{gemm}, bound "
            f"{bound:.4f} ms ({by}); whole backward (x_bar + sums + repack) {whole:.4f} ms, "
            f"{card}")
        per_shape[(hw, c)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, whole_ms=whole, by=by,
                                  **extra)
    return dict(max_abs_err=worst, **({} if quick else _summaries(spec, per_shape, card)))


def _residual_norms(model):
    """The last BatchNorm of every residual branch: an MBConv block's _bn2
    where it has its skip, a BasicBlock's bn2, a Bottleneck's bn3, an
    embedder's norm2 (UDR18) or norm3 (UDR50)."""
    from unidefense_torch.models import efficientnet, resnet

    last = {resnet.BasicBlock: "bn2", resnet.Bottleneck: "bn3",
            resnet.EmbedderRes18Layer1: "norm2", resnet.EmbedderRes18Layer2: "norm2",
            resnet.EmbedderRes50Layer1: "norm3", resnet.EmbedderRes50Layer2: "norm3"}
    for m in model.modules():
        if isinstance(m, efficientnet.MBConvBlock):
            s = m.spec
            if s.id_skip and s.stride == 1 and s.input_filters == s.output_filters:
                yield m._bn2
        elif type(m) in last:
            yield getattr(m, last[type(m)])


def seeded_weights(card: str, model_name: str = "UDEB4", device: str = "cuda") -> dict:
    """A state_dict of ``model_name`` from seeded random weights, set so that
    the network keeps its scale and does not amplify rounding:

    - every sf_coef 0 (the init of -10 weights the frequency branch by 4.5e-5);
    - BatchNorm scales 0.5, and 0.1 on the last BatchNorm of each residual
      branch (``_residual_norms``: a small residual branch at init, as
      zero-init-last-BN schemes do; the ResNets' zero init would leave those
      branches, SFConvs included, out of every check);
    - running statistics calibrated on 8 seeded frames at the model's
      resolution: per-channel mean and variance, and mean 0 and the mean
      square in the bottleneck;
    - the classifier scaled so the logit gap has RMS 0.5 on those frames.

    With the init's unit statistics activations decay until every
    probability is 0.5. With unit BatchNorm scales the random UDEB4
    amplifies the bf16 rounding of its input about 30-fold over the 32
    blocks, past the bf16 parity bound, which no trained weights here can
    show otherwise."""
    import numpy as np
    import torch

    from unidefense_torch.device import nchw
    from unidefense_torch.inference import Predictor
    from unidefense_torch.models.layers import BatchNorm, SFConv

    spec = model_spec(model_name)
    res = spec["res"]
    pred = Predictor(model_name, spec["model"], input_size=res, batch_size=8,
                     dtype=torch.float32, device=device, seed=SEED)
    model = pred.model
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SFConv):
                m.sf_coef.zero_()
            elif isinstance(m, BatchNorm) and m is not model.bottleneck:
                m.weight.fill_(0.5)
        for bn in _residual_norms(model):
            bn.weight.fill_(0.1)

    def calibrate(m, args):
        x = args[0].float()
        if x.dim() == 2:  # the bottleneck, on pooled features
            m.running_mean.zero_()
            m.running_var.copy_(x.pow(2).mean(0))
        else:
            m.running_mean.copy_(x.mean((0, 2, 3)))
            m.running_var.copy_(x.var((0, 2, 3), correction=0))

    frames = np.random.default_rng(SEED + 2).integers(0, 256, (8, res, res, 3), dtype=np.uint8)
    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        with torch.inference_mode():
            out = model(nchw(pred.device_tf(torch.from_numpy(frames).to(device))))
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        gap = out["cls_out"][:, 0] - out["cls_out"][:, 1]
        model.classifier.fc.weight.mul_(0.5 / gap.pow(2).mean().sqrt())
    log(f"[weights] {model_name} seed {SEED}: {sum(p.numel() for p in model.parameters())} "
        f"params, sf_coef 0, {len(hooks)} BatchNorms calibrated on 8 seeded frames at "
        f"{res}^2, {card}")
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _route_wrappers() -> tuple:
    """The wrappers of K1, K2, K2-bwd, K3 and K3-bwd, whose launches the
    serving and training paths count."""
    from unidefense_torch.ops.preprocess import normalize_flip
    from unidefense_torch.ops.sfconv_cuda import sfconv_freq, sfconv_freq_bwd
    from unidefense_torch.ops.sfconv_rowtiled import sfconv_freq_v4, sfconv_freq_v4_bwd

    return normalize_flip, sfconv_freq, sfconv_freq_bwd, sfconv_freq_v4, sfconv_freq_v4_bwd


def _route_counts() -> tuple:
    return tuple(f.launches for f in _route_wrappers())


def _reset_counts() -> None:
    for f in _route_wrappers():
        f.launches = 0


def phase_serve(card: str, weights: dict, model: str = "UDEB4", v4_widths=frozenset(),
                tag: str = "serve") -> None:
    """Serving ``model`` at its resolution, b32 bf16, on a route: 3 requests
    of 64 frames, each batch checked for its K1, K2 and K3 launches."""
    import numpy as np
    import torch

    from unidefense_torch.inference import Predictor

    res = model_spec(model)["res"]
    pred = Predictor(model, model_spec(model)["model"], state_dict=weights, input_size=res,
                     batch_size=32, dtype=torch.bfloat16, device="cuda", v4_widths=v4_widths)
    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, 256, (64, res, res, 3), dtype=np.uint8) for _ in range(3)]
    pred.predict_frames(requests[0][:32])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times, probs = [], []
    for frames in requests:
        t0 = time.perf_counter()
        probs.append(pred.predict_frames(frames))
        times.append(time.perf_counter() - t0)
    k1, k2, k2_bwd, k3, k3_bwd = _route_counts()
    batches = sum(-(-len(f) // 32) for f in requests)
    per_k2, per_k3 = per_forward_launches(model, res, v4_widths)
    want = (batches, per_k2 * batches, 0, per_k3 * batches, 0)
    if (k1, k2, k2_bwd, k3, k3_bwd) != want:
        raise AssertionError(f"launches K1, K2, K2-bwd, K3, K3-bwd = {(k1, k2, k2_bwd, k3, k3_bwd)}; "
                             f"expected {want}")
    p = np.concatenate(probs)
    if p.shape != (192,) or not np.all(np.isfinite(p)) or p.min() < 0 or p.max() > 1:
        raise AssertionError(f"bad probabilities: shape {p.shape}, range [{p.min()}, {p.max()}]")
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_request = statistics.median(times) * 1e3
    route = f"v4_widths {sorted(v4_widths)}" if v4_widths else "default route"
    log(f"[{tag}] {model} {res}^2 b32 bf16 ({route}), 3 requests x 64 frames: "
        f"{192 / sum(times):.2f} img/s, p50 {per_request:.2f} ms per request "
        f"({per_request / 2:.2f} ms per batch), peak memory {peak:.3f} GiB, launches K1 {k1} "
        f"K2 {k2} K3 {k3} over {batches} batches ({per_k2} K2 and {per_k3} K3 per batch), probs "
        f"in [{p.min():.4f}, {p.max():.4f}], {card}")
    phase_profile(card, f"one batch of {model} {res}^2 b32 bf16 ({route})",
                  lambda: pred.predict_frames(requests[0][:32]))


# kernel-name fragments -> group of the device-time breakdown, first match wins
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


def phase_profile(card: str, label: str, fn) -> None:
    """Device time of one call of ``fn`` by kernel group (torch.profiler),
    and the device's busy share of its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"[profile] the profiler recorded no device events: breakdown not measured, {card}")
        return
    groups: dict[str, float] = {}
    for e in kernels:
        name = e.name.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                     "elementwise and other")
        groups[group] = groups.get(group, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(groups.values())
    parts = ", ".join(f"{g} {ms:.2f} ms" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
    log(f"[profile] {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"(busy share {busy / wall_ms:.3f}), {len(kernels)} kernels; {parts}; {card}")


def phase_parity(card: str, weights: dict, model: str = "UDEB4", v4_widths=frozenset(),
                 tag: str = "parity") -> None:
    """The card's fp32 and bf16 Predictor of ``model`` at its resolution
    against the fp32 CPU Predictor on the same route (the CPU takes the
    plain versions), batch 2; each card run checked for its launches."""
    import numpy as np
    import torch

    from unidefense_torch.inference import Predictor

    res, cfg = model_spec(model)["res"], model_spec(model)["model"]
    base = Predictor(model, cfg, state_dict=weights, input_size=res, batch_size=2,
                     dtype=torch.float32, device="cpu", v4_widths=v4_widths)
    frames = np.random.default_rng(SEED + 3).integers(0, 256, (2, res, res, 3), dtype=np.uint8)
    ref = base.predict_frames(frames)
    per_k2, per_k3 = per_forward_launches(model, res, v4_widths)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for dt, tol in ((torch.float32, 1e-3), (torch.bfloat16, 2e-2)):
            gpu = Predictor(model, cfg, state_dict=weights, input_size=res, batch_size=2, dtype=dt,
                            device="cuda", v4_widths=v4_widths)
            _reset_counts()
            got = gpu.predict_frames(frames)
            if _route_counts() != (1, per_k2, 0, per_k3, 0):
                raise AssertionError(f"{tag} {dt}: launches K1, K2, K2-bwd, K3, K3-bwd = "
                                     f"{_route_counts()}; expected {(1, per_k2, 0, per_k3, 0)}")
            d = float(np.abs(got - ref).max())
            log(f"[{tag}] {model} {res}^2 {dt} cuda vs fp32 cpu Predictor (v4_widths "
                f"{sorted(v4_widths)}): probs {got} vs {ref}, max |dprob| {d:.3g} (tol {tol}), "
                f"{card}")
            if not d <= tol:
                raise AssertionError(f"{tag} {dt}: {d} > {tol}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _groups_of(model) -> dict:
    """Parameter groups, each of which must move in a train step: the
    model's top-level modules (a backbone's by its own top level), each
    split into its SFConv frequency kernels (trained through K2-bwd) and
    the rest."""
    groups: dict = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        parts = name.split(".")
        key = parts[0] if parts[0] != "backbone" else ".".join(parts[:2])
        if "freq_conv" in parts:
            key += " (freq_conv)"
        groups.setdefault(key, []).append(p)
    return groups


TRAIN_RATES: dict = {}  # img/s of each [train*] phase of this run


def _train_batch(n_real: int, n_fake: int, size: int, seed: int, device: str):
    import numpy as np
    import torch

    frames = np.random.default_rng(seed).integers(0, 256, (n_real + n_fake, size, size, 3),
                                                  dtype=np.uint8)
    labels = torch.tensor([0] * n_real + [1] * n_fake)
    return {"image": torch.from_numpy(frames).to(device), "label": labels.to(device)}


def phase_train(card: str, weights: dict, model: str = "UDEB4", v4_widths=frozenset(),
                tag: str = "train") -> tuple:
    """The port's two-pass step of ``model`` at its resolution, 10 real + 10
    fake, bf16, its YAML's optimizer and drop rates, on a route: 2 warm-up
    steps, then 5 timed steps, each checked for its exact launches of K1,
    K2, K2-bwd, K3 and K3-bwd (two forwards, and two backwards that launch
    K2 or K3 on the gradient and K2-bwd or K3-bwd). Returns the totals over
    the 5 steps."""
    import torch

    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.train.optim import build_optimizer
    from unidefense_torch.train.step import create_train_state, make_train_step

    spec = model_spec(model)
    res = spec["res"]
    net = build_model(model, spec["model"], dtype=torch.bfloat16, v4_widths=v4_widths)
    net.load_state_dict(weights, strict=True)
    tx, _ = build_optimizer(spec["config"])
    state = create_train_state(net, tx)
    step = make_train_step(tx, spec["config"], spec["num_steps"], 10, 10,
                           preprocess=DevicePipeline(hflip_p=0.5))
    batch = _train_batch(10, 10, res, SEED + 5, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for _ in range(2):  # warm-up: cuDNN plans, the allocator
        step(state, batch, gen)
    groups = _groups_of(state.model)
    before = {k: [p.detach().clone() for p in ps] for k, ps in groups.items()}
    per_k2, per_k3 = per_forward_launches(model, res, v4_widths)
    want = (1, 4 * per_k2, 2 * per_k2, 4 * per_k3, 2 * per_k3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, counts = [], [], (0,) * 5
    for _ in range(5):
        _reset_counts()
        t0 = time.perf_counter()
        _, metrics, cls_out = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = _route_counts()
        if got != want:
            raise AssertionError(f"launches per step K1, K2, K2-bwd, K3, K3-bwd = {got}; "
                                 f"expected {want}")
        counts = tuple(a + b for a, b in zip(counts, got))
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(v == v and abs(v) < float("inf") for v in vals.values()) or \
                not bool(torch.isfinite(cls_out).all()):
            raise AssertionError(f"non-finite training output: {vals}")
        losses.append(vals)
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = {k: [bool((p.detach() != b).any()) for p, b in zip(ps, before[k])]
             for k, ps in groups.items()}
    frozen = [k for k, m in moved.items() if not any(m)]
    if frozen:
        raise AssertionError(f"parameter groups that did not move: {frozen}")
    still = sum(m.count(False) for m in moved.values())
    ms = statistics.median(times) * 1e3
    TRAIN_RATES[tag] = 100 / sum(times)
    route = f"v4_widths {sorted(v4_widths)}" if v4_widths else "default route"
    opt = spec["config"]["optimizer"]
    log(f"[{tag}] {model} {res}^2 b10+10 bf16 two-pass step ({route}), {opt['name']} amsgrad "
        f"{opt['amsgrad']} wd {opt['weight_decay']}, drop_rate {spec['model']['drop_rate']}: "
        f"{100 / sum(times):.2f} img/s over 5 steps, p50 {ms:.2f} ms per step (steps "
        f"{[round(t * 1e3, 2) for t in times]} ms), peak memory {peak:.3f} GiB, launches per step "
        f"K1 {want[0]} K2 {want[1]} K2-bwd {want[2]} K3 {want[3]} K3-bwd {want[4]} (total "
        f"{counts}), all {len(groups)} parameter groups moved ({still} of "
        f"{sum(map(len, moved.values()))} tensors did not), {card}")
    log(f"[{tag}] losses step 1: {losses[0]}; step 5: {losses[-1]}")
    phase_profile(card, f"one train step of {model} {res}^2 b10+10 bf16 ({route})",
                  lambda: step(state, batch, gen))
    return counts


def _parity_step(weights: dict, device: str, v4_widths, model: str = "UDEB4") -> tuple[dict, dict]:
    """One deterministic two-pass step of ``model`` at 256^2, 2 real + 2
    fake, fp32, from the given weights and fixed draws: (losses, gradient
    norms)."""
    import dataclasses

    import torch

    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.train.optim import build_optimizer
    from unidefense_torch.train.perturb import PerturbDraws
    from unidefense_torch.train.step import StepDraws, create_train_state, make_train_step

    spec = model_spec(model)
    cfg = dict(spec["model"], drop_rate=0.0, drop_connect_rate=0.0, feat_drop_rate=0.0)
    # the frequency style branch: CORAL, the FFT amplitude mix, the most code
    draws = PerturbDraws.draw(torch.Generator().manual_seed(SEED + 7), 2, 2, (4, 256, 256, 3))
    draws = StepDraws(flip=torch.tensor([True, False, False, True]),
                      perturb=dataclasses.replace(draws, style=True, freq=True))
    net = build_model(model, cfg, dtype=torch.float32, v4_widths=v4_widths)
    net.load_state_dict(weights, strict=True)
    tx, _ = build_optimizer(spec["config"])
    state = create_train_state(net, tx, device=device)
    step = make_train_step(tx, spec["config"], spec["num_steps"], 2, 2,
                           preprocess=DevicePipeline(hflip_p=0.5))
    _, metrics, _ = step(state, _train_batch(2, 2, 256, SEED + 8, device), None, draws)
    return ({k: float(v) for k, v in metrics.items()},
            {n: float(p.grad.norm()) for n, p in state.model.named_parameters()
             if p.grad is not None})


def phase_train_parity(card: str, weights: dict, model: str = "UDEB4", routes=None) -> None:
    """One deterministic two-pass step of ``model`` at 256^2, 2 real + 2 fake,
    fp32 on the card against the same step on the CPU (default route, plain
    versions), from the same weights and draws: every loss, and each
    parameter's gradient (pass-1 plus pass-2, as update 2 applies it) by
    the norm. The card runs it on each of ``routes`` ((tag, v4_widths)), by
    default the default route (K1, K2, K2-bwd in fp32, [train-parity]) and
    the K3 route {32, 16} ([train-parity-v4]), each checked for its launches
    of K2, K2-bwd, K3 and K3-bwd."""
    import torch

    if routes is None:
        routes = (("train-parity", frozenset()), ("train-parity-v4", V4_WIDTHS[256]))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        lc, gc = _parity_step(weights, "cpu", frozenset(), model)
        total = sum(v * v for v in gc.values()) ** 0.5
        for tag, widths in routes:
            _reset_counts()
            lg, gg = _parity_step(weights, "cuda", widths, model)
            per_k2, per_k3 = per_forward_launches(model, 256, widths)
            want = (4 * per_k2, 2 * per_k2, 4 * per_k3, 2 * per_k3)
            if _route_counts()[1:] != want:
                raise AssertionError(f"{tag}: K2, K2-bwd, K3, K3-bwd launches "
                                     f"{_route_counts()[1:]}; expected {want}")
            loss_err, loss_worst = max((abs(lg[k] - v) / max(abs(v), 1e-12), k)
                                       for k, v in lc.items())
            # a tensor whose gradient is rounding noise (a BatchNorm bias feeding a
            # 1x1 conv and a train-mode BatchNorm, which cancels any shift) is
            # judged against the total norm, the rest against their own
            grad_err, worst = max((abs(gg[n] - v) / (v + 1e-4 * total), n) for n, v in gc.items())
            log(f"[{tag}] {model} 256^2 b2+2 fp32 two-pass step, cuda (v4_widths "
                f"{sorted(widths)}, K2 {want[0]} K2-bwd {want[1]} K3 {want[2]} K3-bwd {want[3]}) "
                f"vs cpu (default route): losses max rel err {loss_err:.3g} at {loss_worst} "
                f"(tol 1e-3); {len(gc)} gradient norms, max |d|g|| / (|g| + 1e-4 |all|) "
                f"{grad_err:.3g} at {worst} (tol 1e-2); total |g| {total:.4g}; {card}")
            if not (loss_err <= 1e-3 and grad_err <= 1e-2):
                raise AssertionError(f"{tag}: losses {lc} vs {lg}; worst gradient {worst}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# the synthetic FF++ tree of [engine-fe]: 4 real and 4 fake videos of 8
# frames of seeded noise at 320^2, the frame layout of the reference's index
FFPP_FRAMES = {0: "original_sequences/youtube/c23/images/{v:03d}/{f:04d}.jpg",
               1: "manipulated_sequences/Deepfakes/c23/images/{v:03d}_x/{f:04d}.jpg"}


def _write_ffpp(root: str, card: str, videos: int = 4, frames: int = 8, size: int = 320) -> None:
    """Encode the tree with the port's JPEG encoder and write the split
    pickles; check the port's encoder and decoder on a smooth frame's round
    trip, and hold its decoder against libjpeg-turbo's (Pillow) through
    _decoder_against_pillow."""
    import numpy as np
    import torch

    from unidefense_torch.data import native

    rng = np.random.default_rng(SEED + 20)
    index, first = [], None
    for label, pattern in FFPP_FRAMES.items():
        for v in range(videos):
            for f in range(frames):
                rel = pattern.format(v=v, f=f)
                frame = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
                blob = native.encode_jpeg(frame, 95)
                os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
                with open(os.path.join(root, rel), "wb") as out:
                    out.write(blob)
                index.append((rel, label))
                first = first or blob
    os.makedirs(os.path.join(root, "pickle_files"))
    for split in ("train", "val", "test"):
        torch.save(index, os.path.join(root, "pickle_files", f"{split}_c23.pickle"))
    yy, xx = np.mgrid[0:size, 0:size]
    smooth = np.stack([xx * 0.7, yy * 0.6, (xx + yy) * 0.35], -1).astype(np.uint8)
    back = native.decode_batch([native.encode_jpeg(smooth, 95)], None, size, size)[0]
    err = float(np.abs(back.astype(np.int32) - smooth).mean())
    if not err < 2.0:
        raise AssertionError(f"a smooth frame comes back {err} levels off on average")
    note = _decoder_against_pillow(first, size)
    log(f"[jpeg] {native.backend()}: {len(index)} noise frames {size}^2 q95 written by the "
        f"port's encoder ({len(first)} bytes the first); a smooth frame's round trip "
        f"{err:.3f} levels from its source on average; {note}; {card}")


def _decoder_against_pillow(blob: bytes, size: int) -> str:
    """The port's decode against libjpeg-turbo's (Pillow's), within 4 levels
    and 0.1 on average: the port's 4:2:0 noise frame whole, then noise
    frames Pillow wrote at an odd size in 4:4:4, 4:2:2, 4:2:0 and grey, in
    one batch whole, cropped to a box inside the frame, and cropped to a
    box that the frame clamps; a blob that starts like a JPEG and does not
    decode raises IOError. Pillow is the reference: without it this fails."""
    import io

    import numpy as np

    from unidefense_torch.data import native

    try:
        from PIL import Image
    except ImportError as e:
        raise AssertionError("[jpeg] Pillow is not installed: no libjpeg-turbo reference for "
                             "the port's decoder") from e

    def pillow(b):
        return np.asarray(Image.open(io.BytesIO(b)).convert("RGB")).astype(np.int32)

    rng = np.random.default_rng(SEED + 21)
    h, w = 251, 317
    layouts = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "grey": None}
    blobs = []
    for name, sub in layouts.items():
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        out = io.BytesIO()
        if sub is None:
            Image.fromarray(frame[:, :, 0]).save(out, "JPEG", quality=95)
        else:
            Image.fromarray(frame).save(out, "JPEG", quality=95, subsampling=sub)
        blobs.append(out.getvalue())
    refs = [pillow(b) for b in blobs]
    inner, clamped = (13, 21, 163, 191), (-7, 200, 120, 400)  # (x1, y1, x2, y2)
    cases = [("the port's frame", native.decode_batch([blob], None, size, size),
              pillow(blob)[None])]
    cases.append(("whole", native.decode_batch(blobs, None, h, w), np.stack(refs)))
    for what, (x1, y1, x2, y2) in (("inner box", inner), ("clamped box", clamped)):
        boxes = np.array([(x1, y1, x2, y2)] * len(blobs), np.int32)
        x1, y1, x2, y2 = max(0, x1), max(0, y1), min(w, x2), min(h, y2)
        got = native.decode_batch(blobs, boxes, y2 - y1, x2 - x1)
        cases.append((what, got, np.stack([r[y1:y2, x1:x2] for r in refs])))
    parts = []
    for what, got, ref in cases:
        for i, name in enumerate(layouts if len(got) == len(layouts) else ["4:2:0"]):
            diff = np.abs(got[i].astype(np.int32) - ref[i])
            if not (diff.max() <= 4 and diff.mean() <= 0.1):
                raise AssertionError(f"[jpeg] {what} {name}: the port's decode is off "
                                     f"libjpeg-turbo's by max {int(diff.max())}, mean "
                                     f"{float(diff.mean())} (tol 4 and 0.1)")
            parts.append(f"{what} {name} max {int(diff.max())} mean {float(diff.mean()):.4f}")
    broken = b"\xff\xd8" + rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    try:
        native.decode_batch([blobs[0], broken], None, h, w)
    except IOError:
        pass
    else:
        raise AssertionError("[jpeg] a blob that does not decode gave no IOError")
    return (f"against libjpeg-turbo's decode (Pillow), tol max 4 and mean 0.1, frames {w}x{h} "
            f"q95 noise: {'; '.join(parts)}; a broken blob raises IOError")


def _engine_configs(root: str, tree: str, run_id: str) -> tuple[str, str]:
    """config_template/forgery/model_udeb4.yml and data_ffc23.yml with the
    tree as root, one fake method, 6 steps logged and validated every 3, a
    fresh id; and the same with resume on and 9 steps."""
    import yaml

    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(repo, MODELS["UDEB4"][0])) as f:
        model = yaml.safe_load(f)
    with open(os.path.join(repo, model["data"]["file"])) as f:
        data = yaml.safe_load(f)
    paths = []
    for steps, resume in ((6, False), (9, True)):
        data.update(root=tree, fake_method=["Deepfakes"], num_steps=steps, log_steps=3,
                    val_steps=3)
        data_path = os.path.join(root, f"data_{steps}.yml")
        with open(data_path, "w") as f:
            yaml.safe_dump(data, f)
        model["data"]["file"] = data_path
        model["config"].update(id=run_id, resume=resume)
        model_path = os.path.join(root, f"model_{steps}.yml")
        with open(model_path, "w") as f:
            yaml.safe_dump(model, f)
        paths.append(model_path)
    return tuple(paths)


def phase_engine_fe(card: str) -> tuple:
    """``python -m unidefense_torch.main --engine FE`` in process: UDEB4 at
    380^2, b10+10, bf16, AdamW amsgrad, StepLR (model_udeb4.yml,
    data_ffc23.yml) on a synthetic FF++ tree. Trains 6 steps (validation at
    3 and 6), tests from the best checkpoint, resumes to step 9. Checks the
    device, the printed lines, the checkpoints, the resume, and every train
    step's launches of K1, K2 and K2-bwd (1, 96, 48) and every eval batch's
    (1, 24); each run's launch totals are read around its main() call.
    Returns the launch totals over the three runs."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from unidefense_torch import main as cli
    from unidefense_torch.data.datasets import FaceForensics
    from unidefense_torch.engines import base

    per_k2, _ = per_forward_launches("UDEB4", 380, frozenset())
    step_want = (1, 4 * per_k2, 2 * per_k2, 0, 0)
    eval_want = (1, per_k2, 0, 0, 0)
    steps: list = []  # (count deltas, start, end) of every train step
    loads: list = []  # (frames, seconds) of every load_item
    evals: list = []  # (batches, seconds) of every score_dataset
    make_train_step, load_item, score_dataset = (
        base.make_train_step, FaceForensics.load_item, base.AbstractEngine.score_dataset)

    def timed_make_train_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def timed(state, batch, generator=None, draws=None):
            torch.cuda.synchronize()
            before, t0 = _route_counts(), time.perf_counter()
            out = step(state, batch, generator, draws)
            torch.cuda.synchronize()
            steps.append((tuple(b - a for a, b in zip(before, _route_counts())), t0,
                          time.perf_counter()))
            return out
        return timed

    def timed_load_item(self, items, labels, *args, **kwargs):
        t0 = time.perf_counter()
        out = load_item(self, items, labels, *args, **kwargs)
        loads.append((len(items), time.perf_counter() - t0))
        return out

    def timed_score_dataset(self, dataset, batch_size, *args, **kwargs):
        t0 = time.perf_counter()
        out = score_dataset(self, dataset, batch_size, *args, **kwargs)
        torch.cuda.synchronize()
        evals.append((-(-len(dataset) // batch_size), time.perf_counter() - t0))
        return out

    cwd, stdout = os.getcwd(), sys.stdout
    root = tempfile.mkdtemp(prefix="ud_engine_fe_")
    totals = (0,) * 5
    try:
        tree = os.path.join(root, "ffpp")
        _write_ffpp(tree, card)
        first, resumed = _engine_configs(root, tree, f"chip-smoke-{os.getpid()}")
        os.chdir(root)  # runs/ lands in the temporary directory
        base.make_train_step = timed_make_train_step
        FaceForensics.load_item = timed_load_item
        base.AbstractEngine.score_dataset = timed_score_dataset
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for argv in (["--config", first, "--engine", "FE", "--offline"],
                     ["--config", first, "--engine", "FE", "--offline", "--test"],
                     ["--config", resumed, "--engine", "FE", "--offline"]):
            n_steps, n_evals = len(steps), len(evals)
            _reset_counts()
            t0 = time.perf_counter()
            engine = cli.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = _route_counts()
            sys.stdout = stdout
            new_steps = steps[n_steps:]
            batches = sum(b for b, _ in evals[n_evals:])
            want = tuple(len(new_steps) * s + batches * e for s, e in zip(step_want, eval_want))
            bad = [i for i, (d, _, _) in enumerate(new_steps) if d != step_want]
            if got != want or bad:
                raise AssertionError(f"[engine-fe] {argv[-1]}: launches K1, K2, K2-bwd, K3, "
                                     f"K3-bwd = {got} over {len(new_steps)} steps and {batches} "
                                     f"eval batches, expected {want}; steps off {bad}")
            if engine.device.type != "cuda":
                raise AssertionError(f"[engine-fe] ran on {engine.device}")
            totals = tuple(a + b for a, b in zip(totals, got))
            runs.append((engine, seconds, len(new_steps), batches))
        peak = torch.cuda.max_memory_allocated() / 2**30
        trained, tested, again = (r[0] for r in runs)
        run_dir = os.path.join(root, trained.run_dir)
        for name in ("best", "latest"):
            if not os.path.isdir(os.path.join(run_dir, "ckpt", name)):
                raise AssertionError(f"[engine-fe] no ckpt/{name} in {run_dir}")
        with open(os.path.join(run_dir, "records.txt")) as f:
            records = f.read()
        with open(os.path.join(run_dir, "test.txt")) as f:
            test_out = f.read()
        iters = [ln for ln in records.splitlines() if ln.startswith("Train Iter")]
        losses = [float(ln.split("Loss ")[1].split(",")[0]) for ln in iters]
        aucs = [float(ln.split("AUC ")[1].split(",")[0]) for ln in
                records.splitlines() + test_out.splitlines()
                if ln.startswith(("Eval Step", "Test |"))]
        if not (len(iters) == 3 and all(np.isfinite(losses))):
            raise AssertionError(f"[engine-fe] Train Iter lines {iters}")
        if not (len(aucs) == 4 and all(0.0 <= a <= 1.0 for a in aucs)):
            raise AssertionError(f"[engine-fe] Eval Step / Test lines give AUC {aucs}")
        if "Resumed from step 6" not in records or again.state.step != 9 or \
                trained.state.step != 6:
            raise AssertionError(f"[engine-fe] resume: steps {trained.state.step}, "
                                 f"{again.state.step}")
        # steady state: steps 2-6 of the first run; the loop's own time from
        # one step's start to the next's, where no validation lies between
        first_steps = steps[:6]
        step_ms = [(t1 - t0) * 1e3 for _, t0, t1 in first_steps[1:]]
        loop_ms = [(b[1] - a[1]) * 1e3 for i, (a, b) in
                   enumerate(zip(first_steps[1:], first_steps[2:]), start=2) if i % 3]
        bs = trained.data_cfg["train_batch_size"]
        train_loads = [s * 1e3 for n, s in loads if n == bs]
        val_ms = [s * 1e3 / b for b, s in evals]
        log(f"[engine-fe] python -m unidefense_torch.main --engine FE: UDEB4 380^2 b10+10 bf16 "
            f"on {trained.device}, {trained.state.step} steps + test + resume to "
            f"{again.state.step}: steps 2-6, each between two synchronises, data waits "
            f"excluded: {2 * bs * len(step_ms) / (sum(step_ms) / 1e3):.2f} img/s, p50 "
            f"{statistics.median(step_ms):.2f} ms per step ({[round(t, 2) for t in step_ms]}); "
            f"the loop, data waits included: {2 * bs * len(loop_ms) / (sum(loop_ms) / 1e3):.2f} "
            f"img/s ({[round(t, 2) for t in loop_ms]} ms between step starts) beside [train] "
            f"{TRAIN_RATES.get('train', float('nan')):.2f} img/s for the bare step; host decode "
            f"p50 {statistics.median(train_loads):.2f} ms per {bs}-frame batch (320^2 -> 380^2, "
            f"{len(train_loads)} batches); validation {[round(v, 2) for v in val_ms]} ms per "
            f"b64/b96 batch with its decode; peak memory {peak:.3f} GiB; runs "
            f"{[round(r[1], 2) for r in runs]} s; {card}")
        log(f"[engine-fe] launches per train step K1 {step_want[0]} K2 {step_want[1]} K2-bwd "
            f"{step_want[2]} and per eval batch K1 1 K2 {per_k2} over {len(steps)} steps and "
            f"{sum(b for b, _ in evals)} eval batches (totals {totals}); losses {losses}; AUC "
            f"{aucs}; ckpt/best and ckpt/latest written; resumed from step 6 to 9; {card}")
    finally:
        base.make_train_step, FaceForensics.load_item = make_train_step, load_item
        base.AbstractEngine.score_dataset = score_dataset
        sys.stdout = stdout
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    return totals


def phase_bench(card: str) -> tuple[int, int]:
    """The per-op A/B tool (path B) at its default shapes, batch 20, bf16,
    2 timed calls per column: checks that K4 ran its forward and x_bar and
    K4-bwd its sums on every call of the v3 column. The [K4] and [K4-bwd]
    phases hold those kernels against their plain versions at these shapes
    and batch, and time them per pass of this tool."""
    from unidefense_torch.ops.sfconv_rowtiled import sfconv_freq_v3, sfconv_freq_v3_bwd
    from unidefense_torch.tools import bench_sfconv

    iters = 2
    shapes = bench_sfconv.SHAPES_256 + bench_sfconv.SHAPES_380
    sfconv_freq_v3.launches = sfconv_freq_v3_bwd.launches = 0
    bench_sfconv.run(iters=iters)
    got = (sfconv_freq_v3.launches, sfconv_freq_v3_bwd.launches)
    calls = (iters + 1) * len(shapes)  # one warm-up call per window
    if got != (2 * calls, calls):
        raise AssertionError(f"bench_sfconv: K4, K4-bwd launches {got}; expected "
                             f"{(2 * calls, calls)}")
    log(f"[bench_sfconv] {len(shapes)} shapes x {iters + 1} fwd+bwd calls per column, n 20 bf16: "
        f"K4 {got[0]} launches, K4-bwd {got[1]}, {card}")
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check each kernel once; no timing or serving")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    phase_build()
    k1 = phase_k1(args.quick, card)
    k2, k2_bwd, k3, k3_bwd, k4, k4_bwd = (
        (phase_sfconv_bwd if "sums" in spec else phase_sfconv_fwd)(spec, args.quick, card)
        for spec in sfconv_kernels())
    if args.quick:
        log("[quick] kernels built and checked; no timing, serving or parity")
        return 0
    weights = seeded_weights(card)
    phase_serve(card, weights)  # asserts its own K1, K2 and K3 launch counts
    phase_parity(card, weights)
    trained = {"train": phase_train(card, weights)}
    phase_serve(card, weights, "UDEB4", V4_WIDTHS[380], "serve-v4")
    phase_parity(card, weights, "UDEB4", V4_WIDTHS[380], "parity-v4")
    _, _, _, k3_launches, k3_bwd_launches = phase_train(card, weights, "UDEB4", V4_WIDTHS[380],
                                                        "train-v4")
    phase_train_parity(card, weights)  # [train-parity] and [train-parity-v4]
    trained["engine-fe"] = phase_engine_fe(card)
    for model in ("UDR18", "UDR50"):
        tag = model.lower()
        weights = seeded_weights(card, model)
        phase_serve(card, weights, model, tag=f"serve-{tag}")
        phase_parity(card, weights, model, tag=f"parity-{tag}")
        trained[f"train-{tag}"] = phase_train(card, weights, model, tag=f"train-{tag}")
        phase_train_parity(card, weights, model, ((f"train-parity-{tag}", frozenset()),))
    k4_launches, k4_bwd_launches = phase_bench(card)
    # K1, K2 and K2-bwd: the launches of the default-route training paths,
    # UDEB4's, UDR18's and UDR50's, 5 steps each, and of the FE engine's
    # three runs (their steps and eval batches)
    k1_launches, k2_launches, k2_bwd_launches = (sum(c[i] for c in trained.values())
                                                 for i in range(3))
    by_path = {name: dict(zip(("K1", "K2", "K2-bwd"), c[:3])) for name, c in trained.items()}

    def line(name, source, replaces, launches, measured):
        key = name.split()[0]
        paths = {p: c[key] for p, c in by_path.items() if key in c}
        return dict(name=name, route="cuda", source=f"unidefense_torch/csrc/{source}",
                    replaces=f"unidefense_tpu/ops/{replaces}", launches=launches,
                    max_abs_err=measured["max_abs_err"], ms=measured["ms"],
                    plain_ms=measured["plain_ms"], bound_ms=measured["bound_ms"],
                    bound_by=measured["bound_by"], library_ms=None,
                    **{k: measured[k] for k in ("queued_ms", "warm_ms", "copy_ms") if k in measured},
                    **({"launches_by_path": paths} if paths else {}))

    lines = [
        line("K1 normalize_flip", "normalize_flip.cu", "pallas_preprocess.py:42", k1_launches, k1),
        line("K2 sfconv_freq_fwd", "sfconv_freq_fwd.cu", "sfconv_pallas.py:169", k2_launches, k2),
        line("K2-bwd sfconv_freq_bwd", "sfconv_freq_bwd.cu", "sfconv_pallas.py:257",
             k2_bwd_launches, k2_bwd),
        line("K3 sfconv_v4_fwd", "sfconv_v4.cu", "sfconv_pallas.py:549", k3_launches, k3),
        line("K3-bwd sfconv_v4_bwd_dw", "sfconv_v4.cu", "sfconv_pallas.py:610", k3_bwd_launches,
             k3_bwd),
        line("K4 sfconv_v3_fwd", "sfconv_v3.cu", "sfconv_pallas.py:370", k4_launches, k4),
        line("K4-bwd sfconv_v3_bwd_dw", "sfconv_v3.cu", "sfconv_pallas.py:437", k4_bwd_launches,
             k4_bwd),
    ]
    log(card)
    log(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
