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
K2-bwd; and the OCIM engine the same way (``[engine-ocim]``): UDR18 at
256x256, three source domains x (10 real + 10 fake), bf16, on a synthetic
face anti-spoofing tree of FrameStores (480x360 JPEG frames, 4p face crops
with a drawn margin, RandomResizedCrop with the host library's bicubic
resize, held against torch's bicubic in its ``[jpeg]`` line); the UE engine
(``[engine-ue]``): UDEB4 at 380x380, 10 real + 10 fake, bf16
(config_template/uniatt/Prot1/model_udeb4.yml and data_ffpp.yml), on a
synthetic UniAttack tree of six FrameStores with frames of six sizes
(Celeb-DF's PNG, as the reference lays it out), RandomResizedCrop with
the bicubic resize, the frame EER threshold of the validation split
applied to the test split, a ``--test`` run on the Protocol I distorted
test split (the host OneOf on every b96 batch), and that validation on
the card against the CPU from the same calibrated weights and batches,
with its ``[jpeg]`` line holding ImageCompression's round trip against
Pillow's (and each encoder's quantisation tables against IJG's), the host
blur against a float64 one and the PNG decoder against Pillow's; and the
device corruption route
(``[corrupt]``: ``DevicePipeline(corrupt=True)`` on the card against the
CPU with the same draws). The reference's weight files and the rest of
serving: ``[ckpt]`` (for UDEB4, UDR18 and UDR50 from their seeded weights:
the reference-format checkpoint served by ``Predictor.from_torch_checkpoint``
bit for bit as the state_dict's Predictor, and the published backbone
naming loaded by ``load_pretrained_extractor``), ``[serve-int8]`` (UDEB4
380x380 b32 bf16 with ``quantize="int8"`` beside ``[serve]``), and in the
engines: FE's ``extractor_weights`` (lukemelas EfficientNet-b4), the export
of its run served alike by ``from_run`` and ``from_torch_checkpoint``, and
its ``--test`` on Celeb-DF and WildDeepfake trees; OCIM's
``extractor_weights`` (torchvision ResNet-18); UE's ``init_weights``. Data
parallelism, two ranks sharing cuda:0 over a gloo group of their own (NCCL
refuses two ranks on one device; these times measure no speed):
``[dp-step]`` (UDR18 256^2 b30+30 per rank fp32: the step of two ranks on
the same batch against the one-process step, then 3 steps on two halves
with the ranks' states equal bitwise) and ``[engine-fe-dp]`` ([engine-fe]'s
FE engine on two ranks, 4 steps: striped validation against one process,
rank 0's checkpoints, the resume on one card bitwise); ``[dp-nccl]`` (the
CLI's ``--num_devices 2`` over NCCL) and ``[serve-dp]``
(``Predictor(num_devices=2)``) where the host has two cards, else a line
that says they did not run. The rest of training's configuration:
``[train-opt]`` (UDR18 256^2 b30+30 bf16 with each of sgd, asgd, adamax,
adadelta, adagrad and rmsprop, 3 steps each with their launches, ms and
peak memory, ASGD's average against the parameters, and each optimizer's
fp32 step on the card against the CPU), ``[train-remat]`` ([train] with
``remat``, its launches, ms and peak memory beside [train]'s, and UDR18's
fp32 step with remat against without) and ``[learn]`` (the port's
learning check, ``unidefense_torch.tools.validate_learning``, 150 steps
of UDR18 at 64^2 through the FE engine; best AUC above 0.95). The 2-D
('data', 'model') mode, ``[mesh2d]``: UDR18 256^2 global b10+10, the 1x1
mesh's bf16 steps bit for bit make_train_step's on one card, and where the
host has two cards or more a 1x2 or 2x2 mesh over NCCL, a rank per card,
held against one card's step (see ``phase_mesh2d``). Any failure
raises, so the exit code is not 0 and no result line is printed.
The last line is the result object; the line before it the kernel table.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak
SEED = 0

# each model's YAML and the resolution its data YAML crops to:
# config_template/forgery/data_ffc23.yml, ocim/data_m.yml (RandomResizedCrop
# 256) and uniatt/Prot1/data_ffpp.yml (380); the [train*] phases take each
# through the bare step at 10 real + 10 fake, the engines at their own
# batches (FE: UDEB4 at 10 + 10; OCIM: UDR18 at 30 + 30, three domains; UE:
# UDEB4 at 10 + 10 from uniatt/Prot1/model_udeb4.yml)
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
    ("UDR18", 64): [(16, 128, 3), (8, 256, 3), (4, 512, 2)],  # [learn]
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
    batches of 380² and 256², the FE engine's validation (b64) and test
    (b96) batches of 380², the OCIM engine's training (b60), validation
    and test batches of 256² and [learn]'s training (b8) and validation
    (b16) batches of 64², each flip pattern and both output dtypes; on a
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
    # checked, not timed: the engines' batches, K1's tiles and grid follow
    # the batch; FE's and UE's validation (b64) and test (b96) at 380^2, OCIM's
    # training (b60), validation and test at 256^2, [learn]'s at 64^2
    checked = batches + [(64, 380), (96, 380), (60, 256), (64, 256), (96, 256), (8, 64),
                         (16, 64)]
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
    UDR50's (C = 128, 256, 512), [learn]'s UDR18 at 64^2 among them."""
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
        # also_batches: the engines' forwards, {(model, res): batches}: FE's
        # and UE's train (b20), validation (b64) and test (b96) of UDEB4,
        # OCIM's train (b60), validation and test of UDR18, [learn]'s train
        # (b8) and validation (b16) of UDR18 at 64^2
        dict(name="K2", fn=k2.sfconv_freq, plain=sfconv_freq_spatial, batch=32, seed=SEED + 1,
             also_batches={("UDEB4", 380): (20, 64, 96), ("UDR18", 256): (60, 64, 96),
                           ("UDR18", 64): (8, 16)},
             hilberts=1, streams=2, counts=fwd,
             workload="per UDEB4 forward at 380^2 b32",
             also={f"per {m} forward at {r}^2 b32": c for (m, r), c in udr.items()},
             parts=k2_parts, gemm=k2_gemm, check=split_check),
        # also_batches: the train backward of UDR18 in the OCIM engine (b60)
        # and in [learn] (b8 at 64^2)
        dict(name="K2-bwd", fn=k2.sfconv_freq_bwd, plain=k2.sfconv_freq_bwd_plain, batch=20,
             seed=SEED + 4, also_batches={("UDR18", 256): (60,), ("UDR18", 64): (8,)},
             hilberts=1, streams=2,
             counts=fwd,
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
    alone, at each batch of ``spec["also_batches"]`` over its model's shapes
    at its resolution (the row grid follows the batch)."""
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
    for (model, res), batches in spec.get("also_batches", {}).items():
        for n in batches:
            for hw, c, _ in SFCONV_SHAPES[model, res]:
                log(check(n, hw, c, f"{model} {res}^2 b{n}")[2] + " ok")
            torch.cuda.empty_cache()
    return dict(max_abs_err=worst_abs, **({} if quick else _summaries(spec, per_shape, card)))


def phase_sfconv_bwd(spec: dict, quick: bool, card: str) -> dict:
    """A backward (K2-bwd, K3-bwd, K4-bwd) at every shape of
    sfconv_check_shapes(): x_bar (the forward kernel on the gradient) and
    w_bar (the sums kernel and the repack) in bf16 and fp32 against the
    plain version in fp32, each within 2e-2 and 1e-4 of its own max |ref|.
    The sums kernel is timed alone, the whole backward beside it. Then,
    checked alone, at each batch of ``spec["also_batches"]`` over its
    model's shapes."""
    import torch

    name, bwd, bwd_plain, batch = spec["name"], spec["fn"], spec["plain"], spec["batch"]
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(spec["seed"])
    worst, per_shape = 0.0, {}

    def check(n, hw, c, origin):
        nonlocal worst
        x = torch.randn(n, hw, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
        g = torch.randn(n, hw, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
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
                raise AssertionError(f"{name} {n}x{hw}^2/C{c} {part}: bf16 rel err {rel}, "
                                     f"fp32 rel err {rel32}, max |ref| {scale}")
        del ref_x, ref_w, got_x, got_w, got32_x, got32_w
        sums = spec["sums"](x, g)
        if not torch.equal(sums(), sums()):  # split-K with a fixed-order reduction
            raise AssertionError(f"{name} {n}x{hw}^2/C{c}: two bf16 sums runs differ")
        head = (f"[{name}] {n}x{hw}x{hw}x{c} ({origin}): error over max |ref| "
                f"{', '.join(errs)} (tol bf16 2e-2, fp32 1e-4); bf16 sums repeat bit for bit")
        return x, g, w, sums, head

    for hw, c, origin in sfconv_check_shapes():
        x, g, w, sums, head = check(batch, hw, c, origin)
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
    del x, g, w, sums
    for (model, res), batches in spec.get("also_batches", {}).items():
        for n in batches:
            for hw, c, _ in SFCONV_SHAPES[model, res]:
                log(check(n, hw, c, f"{model} {res}^2 b{n}")[4] + " ok")
            torch.cuda.empty_cache()
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


def _serve_requests(pred, model: str, res: int, v4_widths, tag: str) -> dict:
    """3 requests of 64 frames through ``pred`` (b32) after a warm-up batch,
    each timed; checks every batch's K1, K2 and K3 launches and the
    probabilities. Returns the rate, the p50 per request, the peak memory
    and the probabilities."""
    import numpy as np
    import torch

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
    counts = _route_counts()
    batches = sum(-(-len(f) // 32) for f in requests)
    per_k2, per_k3 = per_forward_launches(model, res, v4_widths)
    want = (batches, per_k2 * batches, 0, per_k3 * batches, 0)
    if counts != want:
        raise AssertionError(f"[{tag}] launches K1, K2, K2-bwd, K3, K3-bwd = {counts}; "
                             f"expected {want}")
    p = np.concatenate(probs)
    if p.shape != (192,) or not np.all(np.isfinite(p)) or p.min() < 0 or p.max() > 1:
        raise AssertionError(f"[{tag}] bad probabilities: shape {p.shape}, "
                             f"range [{p.min()}, {p.max()}]")
    return dict(rate=192 / sum(times), p50=statistics.median(times) * 1e3,
                peak=torch.cuda.max_memory_allocated() / 2**30, probs=p, batches=batches,
                counts=counts, per_k2=per_k2, per_k3=per_k3, first=requests[0][:32])


def phase_serve(card: str, weights: dict, model: str = "UDEB4", v4_widths=frozenset(),
                tag: str = "serve") -> dict:
    """Serving ``model`` at its resolution, b32 bf16, on a route: 3 requests
    of 64 frames, each batch checked for its K1, K2 and K3 launches.
    Returns the readings of :func:`_serve_requests`."""
    import torch

    from unidefense_torch.inference import Predictor

    res = model_spec(model)["res"]
    pred = Predictor(model, model_spec(model)["model"], state_dict=weights, input_size=res,
                     batch_size=32, dtype=torch.bfloat16, device="cuda", v4_widths=v4_widths)
    r = _serve_requests(pred, model, res, v4_widths, tag)
    p, (k1, k2, _, k3, _) = r["probs"], r["counts"]
    route = f"v4_widths {sorted(v4_widths)}" if v4_widths else "default route"
    log(f"[{tag}] {model} {res}^2 b32 bf16 ({route}), 3 requests x 64 frames: "
        f"{r['rate']:.2f} img/s, p50 {r['p50']:.2f} ms per request "
        f"({r['p50'] / 2:.2f} ms per batch), peak memory {r['peak']:.3f} GiB, launches K1 {k1} "
        f"K2 {k2} K3 {k3} over {r['batches']} batches ({r['per_k2']} K2 and {r['per_k3']} K3 "
        f"per batch), probs in [{p.min():.4f}, {p.max():.4f}], {card}")
    phase_profile(card, f"one batch of {model} {res}^2 b32 bf16 ({route})",
                  lambda: pred.predict_frames(r["first"]))
    return r


INT8_TOL = 0.05  # |dprob| of int8 against the unquantized Predictor: tests/test_quant.py:86


def phase_serve_int8(card: str, weights: dict, served: dict, model: str = "UDEB4") -> None:
    """Serving ``model`` with ``quantize="int8"`` at its resolution, b32
    bf16, from the same weights and requests as [serve] (``served``, its
    readings in this run): the parameter bytes of fp32 and int8, the
    probabilities against the unquantized Predictor's within INT8_TOL, the
    rate, p50 and peak memory beside [serve]'s; every batch dequantizes
    into the model's weights and then runs K1 once and K2 per SFConv."""
    import numpy as np
    import torch

    from unidefense_torch.inference import Predictor

    res, cfg = model_spec(model)["res"], model_spec(model)["model"]
    torch.cuda.empty_cache()
    pred = Predictor(model, cfg, state_dict=weights, input_size=res, batch_size=32,
                     dtype=torch.bfloat16, device="cuda", quantize="int8")
    fp32_bytes = Predictor(model, cfg, state_dict=weights, input_size=res,
                           device="cpu").param_bytes()
    int8_bytes = pred.param_bytes()
    r = _serve_requests(pred, model, res, frozenset(), "serve-int8")
    d = float(np.abs(r["probs"] - served["probs"]).max())
    if not d <= INT8_TOL:
        raise AssertionError(f"[serve-int8] max |dprob| {d} against the unquantized Predictor "
                             f"(tol {INT8_TOL})")
    log(f"[serve-int8] {model} {res}^2 b32 bf16 quantize='int8', 3 requests x 64 frames: "
        f"param_bytes fp32 {fp32_bytes} int8 {int8_bytes} (ratio {int8_bytes / fp32_bytes:.4f}); "
        f"max |dprob| against the unquantized bf16 Predictor {d:.4g} over 192 frames (tol "
        f"{INT8_TOL}); {r['rate']:.2f} img/s, p50 {r['p50']:.2f} ms per request, peak memory "
        f"{r['peak']:.3f} GiB, beside [serve] {served['rate']:.2f} img/s, p50 "
        f"{served['p50']:.2f} ms, peak {served['peak']:.3f} GiB; launches K1 {r['counts'][0]} "
        f"K2 {r['counts'][1]} over {r['batches']} batches ({r['per_k2']} K2 per batch); {card}")


# the published backbones' naming: each model's backbone prefix in the port
BACKBONE_PREFIX = {"UDEB4": "backbone.", "UDR18": "extractor.", "UDR50": "extractor."}
BACKBONE_HEAD = ("_fc.", "layer4.", "fc.")  # in the files, built by no extractor


def _resnet_tail(model: str, rand) -> dict:
    """torchvision's ``layer4`` and ``fc`` of ResNet-18 (BasicBlocks) or
    ResNet-50 (Bottlenecks), which the extractors do not build."""
    bottleneck = model == "UDR50"
    inp, out = (1024, 2048) if bottleneck else (256, 512)
    convs = ((1, 512), (3, 512), (1, out)) if bottleneck else ((3, 512), (3, 512))
    sd = {}

    def bn(key, c):
        sd.update({f"{key}.weight": 1 + rand(c), f"{key}.bias": rand(c),
                   f"{key}.running_mean": rand(c), f"{key}.running_var": 1 + rand(c).abs()})

    for b in range(3 if bottleneck else 2):
        cin = inp if b == 0 else out
        for i, (k, c) in enumerate(convs, start=1):
            sd[f"layer4.{b}.conv{i}.weight"] = rand(c, cin, k, k)
            bn(f"layer4.{b}.bn{i}", c)
            cin = c
        if b == 0:
            sd["layer4.0.downsample.0.weight"] = rand(out, inp, 1, 1)
            bn("layer4.0.downsample.1", out)
    sd["fc.weight"], sd["fc.bias"] = rand(1000, out), rand(1000)
    return sd


def published_backbone(weights: dict, model: str) -> dict:
    """The backbone of ``weights`` as its public source names it, with the
    tensors such files carry and the extractors do not build: lukemelas
    EfficientNet-b4 with a random ``_fc`` head; torchvision ResNet-18 or
    ResNet-50 with a random ``layer4`` and ``fc``. No SFConv-only tensors
    (``freq_conv``, ``sf_coef``): published files lack them."""
    import torch

    from unidefense_torch.models.convert import SF_ONLY

    prefix = BACKBONE_PREFIX[model]
    sd = {k[len(prefix):]: v.clone() for k, v in weights.items()
          if k.startswith(prefix) and not any(s in k for s in SF_ONLY)}
    gen = torch.Generator().manual_seed(SEED + 30)

    def rand(*shape):
        return 0.01 * torch.randn(*shape, generator=gen)

    if model == "UDEB4":
        c = sd["_conv_head.weight"].shape[0]
        sd["_fc.weight"], sd["_fc.bias"] = rand(1000, c), rand(1000)
    else:
        sd.update(_resnet_tail(model, rand))
    return sd


def phase_ckpt(card: str, weights: dict, model: str) -> None:
    """The reference's files on the card, for ``model`` at its resolution
    from its seeded weights: the whole model written by
    ``save_torch_checkpoint`` and served by ``Predictor.from_torch_checkpoint``
    (b32 bf16; a different seed for its init), whose weights equal the
    state_dict's and whose probabilities on 64 frames equal, bit for bit,
    those of the Predictor built from the state_dict, each through K1 and
    K2; and the backbone in its published naming
    (:func:`published_backbone`) loaded by ``load_pretrained_extractor`` into
    a freshly seeded model: every backbone tensor equal to the file's, the
    file's head unused, every other tensor (the SFConv-only ones among
    them) its init."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from unidefense_torch.inference import Predictor
    from unidefense_torch.models.convert import (SF_ONLY, load_pretrained_extractor,
                                                 save_torch_checkpoint)
    from unidefense_torch.models.registry import build_model

    spec = model_spec(model)
    res, cfg = spec["res"], spec["model"]
    tmp = tempfile.mkdtemp(prefix="ud_ckpt_")
    try:
        net = build_model(model, cfg)
        net.load_state_dict(weights, strict=True)
        path = os.path.join(tmp, f"{model}.bin")
        t0 = time.perf_counter()
        save_torch_checkpoint(net, path, step=0)
        write_s = time.perf_counter() - t0
        kw = dict(input_size=res, batch_size=32, dtype=torch.bfloat16, device="cuda")
        frames = np.random.default_rng(SEED + 40).integers(0, 256, (64, res, res, 3),
                                                           dtype=np.uint8)
        _reset_counts()
        ref = Predictor(model, cfg, state_dict=weights, **kw).predict_frames(frames)
        t0 = time.perf_counter()
        served = Predictor.from_torch_checkpoint(path, model, cfg, seed=SEED + 1, **kw)
        load_s = time.perf_counter() - t0
        got_sd = served.model.state_dict()
        off = [k for k, v in weights.items() if not k.endswith("num_batches_tracked")
               and not torch.equal(got_sd[k].cpu(), v)]
        got = served.predict_frames(frames)
        per_k2, _ = per_forward_launches(model, res, frozenset())
        counts = _route_counts()
        if off or not np.array_equal(got, ref) or counts[:2] != (4, 4 * per_k2):
            raise AssertionError(f"[ckpt] {model}: {len(off)} tensors off the state_dict "
                                 f"({off[:3]}), probabilities equal {np.array_equal(got, ref)} "
                                 f"(max |d| {float(np.abs(got - ref).max())}), launches K1, K2 "
                                 f"{counts[:2]}, expected {(4, 4 * per_k2)}")
        size = os.path.getsize(path)
        del served
        torch.cuda.empty_cache()

        prefix = BACKBONE_PREFIX[model]
        pub = published_backbone(weights, model)
        bpath = os.path.join(tmp, f"{model}_backbone.pth")
        torch.save(pub, bpath)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED + 1)
            fresh = build_model(model, cfg)
        before = {k: v.clone() for k, v in fresh.state_dict().items()}
        load_pretrained_extractor(fresh, bpath, model)
        after = fresh.state_dict()
        used = {k for k in pub if prefix + k in after}
        unused = [k for k in pub if k not in used]
        bad = [k for k in used if not torch.equal(after[prefix + k], pub[k])]
        kept = [k for k in after if not (k.startswith(prefix) and k[len(prefix):] in used)]
        moved = [k for k in kept if not torch.equal(after[k], before[k])]
        sf = [k for k in kept if k.startswith(prefix) and any(s in k for s in SF_ONLY)]
        if bad or moved or not sf or not unused or \
                any(not k.startswith(BACKBONE_HEAD) for k in unused):
            raise AssertionError(f"[ckpt] {model} backbone: {len(bad)} tensors off the file "
                                 f"{bad[:3]}, {len(moved)} others moved {moved[:3]}, {len(sf)} "
                                 f"SFConv-only kept, unused {unused[:3]}")
        log(f"[ckpt] {model} {res}^2: save_torch_checkpoint {size} bytes in {write_s:.2f} s; "
            f"Predictor.from_torch_checkpoint on the card in {load_s:.2f} s, its {len(weights)} "
            f"tensors equal to the state_dict's, probabilities on 64 frames b32 bf16 bit for bit "
            f"those of the Predictor built from the state_dict (launches K1 {counts[0]} K2 "
            f"{counts[1]}); the published backbone ({len(pub)} tensors): {len(used)} loaded "
            f"equal to the file's, {len(unused)} of its head unused, {len(sf)} SFConv-only and "
            f"{len(kept) - len(sf)} other tensors kept at their init; {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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


# img/s, p50 ms per step and peak GiB of each [train*] phase of this run
TRAIN_READINGS: dict = {}


def remat_sfconvs(model) -> int:
    """SFConvs per forward inside the rematerialised blocks of ``model``
    (each launches K2 once more in the backward's recompute): every MBConv
    block of a remat EfficientNet, every block of a remat ResNetStage (the
    extractors'; the embedders' SFConvs are not rematerialised, as in
    JAX)."""
    from unidefense_torch.models.efficientnet import EfficientNet
    from unidefense_torch.models.layers import SFConv
    from unidefense_torch.models.resnet import ResNetStage

    n = 0
    for m in model.modules():
        if isinstance(m, (EfficientNet, ResNetStage)) and m.remat:
            blocks = m._blocks if isinstance(m, EfficientNet) else m
            n += sum(isinstance(s, SFConv) for b in blocks for s in b.modules())
    return n


def _train_batch(n_real: int, n_fake: int, size: int, seed: int, device: str):
    import numpy as np
    import torch

    frames = np.random.default_rng(seed).integers(0, 256, (n_real + n_fake, size, size, 3),
                                                  dtype=np.uint8)
    labels = torch.tensor([0] * n_real + [1] * n_fake)
    return {"image": torch.from_numpy(frames).to(device), "label": labels.to(device)}


def phase_train(card: str, weights: dict, model: str = "UDEB4", v4_widths=frozenset(),
                tag: str = "train", remat: bool = False) -> tuple:
    """The port's two-pass step of ``model`` at its resolution, 10 real + 10
    fake, bf16, its YAML's optimizer and drop rates, on a route: 2 warm-up
    steps, then 5 timed steps, each checked for its exact launches of K1,
    K2, K2-bwd, K3 and K3-bwd (two forwards, and two backwards that launch
    K2 or K3 on the gradient and K2-bwd or K3-bwd; with ``remat``, K2 once
    more per pass for each SFConv of a rematerialised block, its forward
    recomputed in the backward). Returns the totals over the 5 steps."""
    import torch

    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.train.optim import build_optimizer
    from unidefense_torch.train.step import create_train_state, make_train_step

    spec = model_spec(model)
    res = spec["res"]
    net = build_model(model, spec["model"], dtype=torch.bfloat16, v4_widths=v4_widths,
                      remat=remat)
    net.load_state_dict(weights, strict=True)
    recomputed = remat_sfconvs(net)
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
    want = (1, 4 * per_k2 + 2 * recomputed, 2 * per_k2, 4 * per_k3, 2 * per_k3)
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
    TRAIN_READINGS[tag] = dict(rate=100 / sum(times), ms=ms, peak=peak)
    route = f"v4_widths {sorted(v4_widths)}" if v4_widths else "default route"
    if remat:
        route += f", remat: {recomputed} SFConvs recomputed per pass"
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


def _parity_step(weights: dict, device: str, v4_widths, model: str = "UDEB4",
                 optimizer: dict = None, remat: bool = False,
                 lr_scale: float = None) -> tuple[dict, dict, dict]:
    """One deterministic two-pass step of ``model`` at 256^2, 2 real + 2
    fake, fp32, from the given weights and fixed draws, with its YAML's
    optimizer or ``optimizer`` (a YAML ``optimizer:`` section), with or
    without ``remat``, its updates scaled by ``lr_scale`` (the plateau
    factor) where given: (losses, gradient norms, BatchNorm running
    statistics and counts on the CPU)."""
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
    net = build_model(model, cfg, dtype=torch.float32, v4_widths=v4_widths, remat=remat)
    net.load_state_dict(weights, strict=True)
    config = dict(spec["config"], **({} if optimizer is None else {"optimizer": optimizer}))
    tx, _ = build_optimizer(config)
    state = create_train_state(net, tx, device=device)
    state.lr_scale = lr_scale
    step = make_train_step(tx, config, spec["num_steps"], 2, 2,
                           preprocess=DevicePipeline(hflip_p=0.5))
    _, metrics, _ = step(state, _train_batch(2, 2, 256, SEED + 8, device), None, draws)
    return ({k: float(v) for k, v in metrics.items()},
            {n: float(p.grad.norm()) for n, p in state.model.named_parameters()
             if p.grad is not None},
            {k: v.detach().cpu() for k, v in state.model.state_dict().items()
             if k.rsplit(".", 1)[-1] in ("running_mean", "running_var", "num_batches_tracked")})


def _parity_errors(ref: tuple, got: tuple) -> tuple:
    """(loss rel err, its loss, gradient-norm err, its tensor, total |g|) of
    one parity step against another: every loss relative to its own size;
    each gradient norm against its own plus 1e-4 of the total norm (a
    tensor whose gradient is rounding noise, a BatchNorm bias feeding a 1x1
    conv and a train-mode BatchNorm, which cancels any shift, is judged
    against the total)."""
    (lc, gc), (lg, gg) = ref[:2], got[:2]
    total = sum(v * v for v in gc.values()) ** 0.5
    loss_err, loss_worst = max((abs(lg[k] - v) / max(abs(v), 1e-12), k) for k, v in lc.items())
    grad_err, worst = max((abs(gg[n] - v) / (v + 1e-4 * total), n) for n, v in gc.items())
    return loss_err, loss_worst, grad_err, worst, total


def phase_train_parity(card: str, weights: dict, model: str = "UDEB4", routes=None,
                       optimizer: dict = None) -> None:
    """One deterministic two-pass step of ``model`` at 256^2, 2 real + 2 fake,
    fp32 on the card against the same step on the CPU (default route, plain
    versions), from the same weights and draws: every loss, and each
    parameter's gradient (pass-1 plus pass-2, as update 2 applies it) by
    the norm. The card runs it on each of ``routes`` ((tag, v4_widths)), by
    default the default route (K1, K2, K2-bwd in fp32, [train-parity]) and
    the K3 route {32, 16} ([train-parity-v4]), each checked for its launches
    of K2, K2-bwd, K3 and K3-bwd. ``optimizer``: a YAML ``optimizer:``
    section in place of the model YAML's, on both devices."""
    import torch

    if routes is None:
        routes = (("train-parity", frozenset()), ("train-parity-v4", V4_WIDTHS[256]))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = _parity_step(weights, "cpu", frozenset(), model, optimizer)
        for tag, widths in routes:
            _reset_counts()
            got = _parity_step(weights, "cuda", widths, model, optimizer)
            per_k2, per_k3 = per_forward_launches(model, 256, widths)
            want = (4 * per_k2, 2 * per_k2, 4 * per_k3, 2 * per_k3)
            if _route_counts()[1:] != want:
                raise AssertionError(f"{tag}: K2, K2-bwd, K3, K3-bwd launches "
                                     f"{_route_counts()[1:]}; expected {want}")
            loss_err, loss_worst, grad_err, worst, total = _parity_errors(ref, got)
            opt = "" if optimizer is None else f" {optimizer['name']}"
            log(f"[{tag}] {model} 256^2 b2+2 fp32 two-pass step{opt}, cuda (v4_widths "
                f"{sorted(widths)}, K2 {want[0]} K2-bwd {want[1]} K3 {want[2]} K3-bwd {want[3]}) "
                f"vs cpu (default route): losses max rel err {loss_err:.3g} at {loss_worst} "
                f"(tol 1e-3); {len(ref[1])} gradient norms, max |d|g|| / (|g| + 1e-4 |all|) "
                f"{grad_err:.3g} at {worst} (tol 1e-2); total |g| {total:.4g}; {card}")
            if not (loss_err <= 1e-3 and grad_err <= 1e-2):
                raise AssertionError(f"{tag}: losses {ref[0]} vs {got[0]}; worst gradient {worst}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# [train-opt]: the optimizers no model YAML names, each at torch.optim's
# default lr with model_udr18.yml's weight decay (sgd: momentum 0.9, 5e-4);
# rmsprop at 1e-3 (Keras's default): its nu starts at 0 with no bias
# correction, so its first update is 10 lr sign(g), and at 0.01 the b30+30
# run diverged (total loss 1.69 -> 24.94 in 3 steps) and a 0.1 step on an
# sf_coef whose gradient's sign is rounding noise put the fp32 card-vs-CPU
# step 0.408 off that gradient's norm
TRAIN_OPTIMIZERS = {
    "sgd": {"name": "sgd", "lr": 0.01, "momentum": 0.9, "weight_decay": 5e-4},
    "asgd": {"name": "asgd", "lr": 0.01, "weight_decay": 5e-5},
    "adamax": {"name": "adamax", "lr": 2e-3, "weight_decay": 5e-5},
    "adadelta": {"name": "adadelta", "lr": 1.0, "weight_decay": 5e-5},
    "adagrad": {"name": "adagrad", "lr": 0.01, "weight_decay": 5e-5},
    "rmsprop": {"name": "rmsprop", "lr": 1e-3, "weight_decay": 5e-5},
}


def phase_train_opt(card: str, weights: dict) -> tuple:
    """[train-opt]: UDR18's two-pass step as model_udr18.yml runs it (256^2,
    30 real + 30 fake, bf16, its drop rates) with each of TRAIN_OPTIMIZERS
    in place of its AdamW: 3 steps each through ``make_train_step``, each
    checked for its launches (K1 1, K2 32, K2-bwd 16) and timed between two
    synchronises, and the peak memory; after them ASGD's
    ``averaged_params`` finite and equal to the parameters (mu stays 1 for
    t0 = 1e6 updates, so ax takes every update's parameters). Then each
    optimizer's fp32 step at 256^2 b2+2 on the card against the CPU
    ([train-parity-udr18]'s path and tolerances). Returns the launch totals
    of the timed steps."""
    import torch

    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.train.optim import averaged_params, build_optimizer
    from unidefense_torch.train.step import create_train_state, make_train_step

    spec = model_spec("UDR18")
    res = spec["res"]
    batch = _train_batch(30, 30, res, SEED + 9, "cuda")
    per_k2, _ = per_forward_launches("UDR18", res, frozenset())
    want = (1, 4 * per_k2, 2 * per_k2, 0, 0)
    totals = (0,) * 5
    for name, opt in TRAIN_OPTIMIZERS.items():
        net = build_model("UDR18", spec["model"], dtype=torch.bfloat16)
        net.load_state_dict(weights, strict=True)
        config = dict(spec["config"], optimizer=opt)
        tx, _ = build_optimizer(config)
        state = create_train_state(net, tx)
        step = make_train_step(tx, config, spec["num_steps"], 30, 30,
                               preprocess=DevicePipeline(hflip_p=0.5))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(3):
            _reset_counts()
            t0 = time.perf_counter()
            _, metrics, cls_out = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            got = _route_counts()
            if got != want:
                raise AssertionError(f"[train-opt] {name}: launches K1, K2, K2-bwd, K3, K3-bwd = "
                                     f"{got}; expected {want}")
            totals = tuple(a + b for a, b in zip(totals, got))
            vals = {k: float(v) for k, v in metrics.items()}
            if not all(v == v and abs(v) < float("inf") for v in vals.values()) or \
                    not bool(torch.isfinite(cls_out).all()):
                raise AssertionError(f"[train-opt] {name}: non-finite training output {vals}")
            losses.append(round(vals["total_loss"], 4))
        peak = torch.cuda.max_memory_allocated() / 2**30
        note = ""
        if name == "asgd":
            ax = averaged_params(state.opt_state)
            params = {n: p.detach() for n, p in state.model.named_parameters() if p.requires_grad}
            if not (ax.keys() == params.keys()
                    and all(bool(torch.isfinite(v).all()) for v in ax.values())
                    and all(torch.equal(v, params[n]) for n, v in ax.items())):
                raise AssertionError("[train-opt] asgd: averaged_params not finite or not the "
                                     "parameters")
            note = (f"; averaged_params: {len(ax)} tensors, finite, equal to the parameters bit "
                    f"for bit (mu {state.opt_state.scalars['mu']})")
        log(f"[train-opt] UDR18 {res}^2 b30+30 bf16 two-pass step, {opt}: 3 steps "
            f"{[round(t, 2) for t in times]} ms, p50 {statistics.median(times):.2f} ms per step, "
            f"{60 * 3 / (sum(times) / 1e3):.2f} img/s, peak memory {peak:.3f} GiB, state slots "
            f"{list(state.opt_state.slots)}; launches per step K1 1 K2 {want[1]} K2-bwd "
            f"{want[2]}; total loss {losses}"
            f"{note}; {card}")
        del net, state, step, tx
        gc.collect()
        torch.cuda.empty_cache()
    for name, opt in TRAIN_OPTIMIZERS.items():
        phase_train_parity(card, weights, "UDR18", ((f"train-opt-parity-{name}", frozenset()),),
                           optimizer=opt)
    return totals


def phase_train_remat(card: str, udeb4: dict, udr18: dict) -> tuple:
    """[train-remat]: [train] (UDEB4 380^2 b10+10 bf16, default route) with
    ``remat``: every MBConv block recomputed in the backward, so each step
    launches K2 once more per SFConv and pass (K1 1, K2 96 + 48, K2-bwd 48);
    its p50 ms per step and peak memory beside [train]'s. Then UDR18's fp32
    step at 256^2 b2+2 with ``remat`` on the card against the same step
    without it: losses and gradient norms within [train-parity]'s
    tolerances and ``num_batches_tracked`` equal; and the two again with
    their updates scaled by 0 (``lr_scale``), so that pass 2 runs on the
    weights pass 1 ran on and the card's backward rounding cannot reach
    the statistics through update 1: running statistics within 1e-6. (With
    the updates they differ by that rounding, logged.) Returns the launch
    totals of the 5 timed steps."""
    import torch

    from unidefense_torch.models.registry import build_model

    counts = phase_train(card, udeb4, "UDEB4", tag="train-remat", remat=True)
    base, now = TRAIN_READINGS["train"], TRAIN_READINGS["train-remat"]
    log(f"[train-remat] beside [train]: p50 {now['ms']:.2f} against {base['ms']:.2f} ms per "
        f"step ({now['ms'] / base['ms']:.3f}x), peak memory {now['peak']:.3f} against "
        f"{base['peak']:.3f} GiB ({now['peak'] / base['peak']:.3f}x); {card}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        plain = _parity_step(udr18, "cuda", frozenset(), "UDR18")
        _reset_counts()
        again = _parity_step(udr18, "cuda", frozenset(), "UDR18", remat=True)
        got = _route_counts()
        held = [_parity_step(udr18, "cuda", frozenset(), "UDR18", remat=r, lr_scale=0.0)
                for r in (False, True)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    per_k2, _ = per_forward_launches("UDR18", 256, frozenset())
    recomputed = remat_sfconvs(build_model("UDR18", model_spec("UDR18")["model"], remat=True))
    want = (1, 4 * per_k2 + 2 * recomputed, 2 * per_k2, 0, 0)
    if got != want:
        raise AssertionError(f"[train-remat] UDR18 fp32 step: launches {got}; expected {want}")
    loss_err, loss_worst, grad_err, worst, total = _parity_errors(plain, again)
    counted = [k for k in plain[2] if k.endswith("num_batches_tracked")]

    def stats_apart(a: dict, b: dict) -> float:
        return max(float((b[k].double() - v.double()).abs().max())
                   for k, v in a.items() if k not in counted)

    stat_err, moved_err = stats_apart(held[0][2], held[1][2]), stats_apart(plain[2], again[2])
    same_counts = all(torch.equal(b[2][k], a[2][k]) for a, b in ((plain, again), held)
                      for k in counted)
    stats = plain[2]
    log(f"[train-remat] UDR18 256^2 b2+2 fp32 two-pass step with remat ({recomputed} SFConvs of "
        f"the extractor's stages recomputed per pass; launches K1 {got[0]} K2 {got[1]} K2-bwd "
        f"{got[2]}) vs without, on the card: losses max rel err {loss_err:.3g} at {loss_worst} "
        f"(tol 1e-3); {len(plain[1])} gradient norms, max |d|g|| / (|g| + 1e-4 |all|) "
        f"{grad_err:.3g} at {worst} (tol 1e-2); {len(stats) - len(counted)} running statistics "
        f"max |d| {stat_err:.3g} with the updates scaled by 0 (tol 1e-6), {moved_err:.3g} with "
        f"them (update 1's rounding); {len(counted)} num_batches_tracked equal: {same_counts}; "
        f"{card}")
    if not (loss_err <= 1e-3 and grad_err <= 1e-2 and stat_err <= 1e-6 and same_counts):
        raise AssertionError(f"[train-remat] remat against no remat: losses {plain[0]} vs "
                             f"{again[0]}; worst gradient {worst}")
    return counts


LEARN_STEPS = 150


def phase_learn(card: str) -> tuple:
    """[learn]: the port's learning check,
    ``unidefense_torch.tools.validate_learning.run``, on the card: UDR18
    through ``get_engine("FE")`` at 64^2, 4 real + 4 fake, AdamW amsgrad
    2e-4, bf16, 150 steps validated at 75 and 150 (12 b16 batches each), on
    smooth blobs with a faint checkerboard on the fakes. Fails unless the
    best AUC is above 0.95 and every step and eval batch launched its K1,
    K2 and K2-bwd (1, 32, 16 a step; 1, 8 a batch). Returns the launch
    totals."""
    from unidefense_torch.tools import validate_learning

    _reset_counts()
    t0 = time.perf_counter()
    best_auc, best_acc = validate_learning.run(steps=LEARN_STEPS, size=64, device="cuda")
    seconds = time.perf_counter() - t0
    got = _route_counts()
    per_k2, _ = per_forward_launches("UDR18", 64, frozenset())
    frames = 2 * 24 * 4  # the tree's real and fake videos of 4 frames
    batches = 2 * -(-frames // 16)
    want = (LEARN_STEPS + batches, LEARN_STEPS * 4 * per_k2 + batches * per_k2,
            LEARN_STEPS * 2 * per_k2, 0, 0)
    log(f"[learn] python -m unidefense_torch.tools.validate_learning on the card: UDR18 64^2 "
        f"b4+4 bf16, {LEARN_STEPS} steps, validated at {LEARN_STEPS // 2} and {LEARN_STEPS} on "
        f"{frames} frames: best AUC {best_auc:.4f} (needs > 0.95), best ACC {best_acc:.4f}; "
        f"{seconds:.2f} s with the tree's writing; launches K1 {got[0]} K2 {got[1]} K2-bwd "
        f"{got[2]} over {LEARN_STEPS} steps and {batches} eval batches; {card}")
    if got != want:
        raise AssertionError(f"[learn] launches {got}; expected {want}")
    if not best_auc > 0.95:
        raise AssertionError(f"[learn] the port failed to learn: best AUC {best_auc}")
    return got


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


def _engine_configs(out_dir: str, model_name: str, run_id: str, model_yml: str = None,
                    model_keys: dict = None, config_keys: dict = None, steps=(6, 9),
                    **data) -> tuple[str, str]:
    """``model_name``'s YAML (or ``model_yml``) with the keys of
    ``model_keys`` and ``config_keys`` set in its ``model:`` and ``config:``
    sections, and the data YAML it names, with the keys of ``data`` set (the
    tree's root, the cadence), ``steps[0]`` steps (6) and a fresh id,
    written into ``out_dir``; and the same with resume on and ``steps[1]``
    steps (9)."""
    import yaml

    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(repo, model_yml or MODELS[model_name][0])) as f:
        model = yaml.safe_load(f)
    model["model"].update(model_keys or {})
    model["config"].update(config_keys or {})
    with open(os.path.join(repo, model["data"]["file"])) as f:
        data_yml = yaml.safe_load(f)
    paths = []
    for num_steps, resume in zip(steps, (False, True)):
        data_yml.update(data, num_steps=num_steps)
        data_path = os.path.join(out_dir, f"data_{num_steps}.yml")
        with open(data_path, "w") as f:
            yaml.safe_dump(data_yml, f)
        model["data"]["file"] = data_path
        model["config"].update(id=run_id, resume=resume)
        model_path = os.path.join(out_dir, f"model_{num_steps}.yml")
        with open(model_path, "w") as f:
            yaml.safe_dump(model, f)
        paths.append(model_path)
    return tuple(paths)


class EngineRuns:
    """``python -m unidefense_torch.main --engine <name>`` in process, three
    times from one pair of configs (:func:`_engine_configs`): train 6 steps,
    ``--test`` from the best checkpoint, resume to step 9; then a ``--test``
    of the first config with each data YAML of ``test_configs``. Around each
    main() call the launch counts are set to 0 and read after; every train
    step is timed between two synchronises with its own launch deltas,
    every host decode (``finish_item``: blob reads, decode, the host
    corruptions), every ``_select_batch`` (a step's selections and plans,
    on the consumer thread: the sampler, the margin and RandomResizedCrop
    draws and the blob and header reads they need) and ``_load_batch``
    call and every ``score_dataset`` are timed. Checks each run's device and launches: ``step_want`` per
    train step and ``eval_want`` per eval batch (K1, K2, K2-bwd, K3,
    K3-bwd); and that every scored frame has a probability in [0, 1]."""

    def __init__(self, tag: str, engine: str, dataset_cls, engine_cls, step_want, eval_want):
        self.tag, self.engine = tag, engine
        self.dataset_cls, self.engine_cls = dataset_cls, engine_cls
        self.step_want, self.eval_want = step_want, eval_want
        self.steps: list = []    # (count deltas, start, end) of every train step
        self.loads: list = []    # (frames, seconds) of every finish_item
        self.batches: list = []  # seconds of every _load_batch (a step's streams)
        self.selects: list = []  # seconds of every _select_batch (a step's plans)
        self.evals: list = []    # (batches, seconds) of every score_dataset
        self.runs: list = []     # (engine, seconds, steps, eval batches) of every main()
        self.totals = (0,) * 5

    def run(self, root: str, first: str, resumed: str, test_argv: tuple = (),
            test_configs: tuple = ()):
        import torch

        from unidefense_torch import main as cli
        from unidefense_torch.engines import base

        make_train_step, finish_item = base.make_train_step, self.dataset_cls.finish_item
        load_batch, score_dataset = self.engine_cls._load_batch, base.AbstractEngine.score_dataset
        select_batch = self.engine_cls._select_batch
        steps, loads, batches, evals = self.steps, self.loads, self.batches, self.evals
        selects = self.selects

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

        def timed_finish_item(ds, plan):
            t0 = time.perf_counter()
            out = finish_item(ds, plan)
            loads.append((len(plan["path"]), time.perf_counter() - t0))
            return out

        def timed_load_batch(engine, sels):
            t0 = time.perf_counter()
            out = load_batch(engine, sels)
            batches.append(time.perf_counter() - t0)
            return out

        def timed_select_batch(engine, cur_step):
            t0 = time.perf_counter()
            out = select_batch(engine, cur_step)
            selects.append(time.perf_counter() - t0)
            return out

        def timed_score_dataset(engine, dataset, batch_size, *args, **kwargs):
            t0 = time.perf_counter()
            out = score_dataset(engine, dataset, batch_size, *args, **kwargs)
            torch.cuda.synchronize()
            evals.append((-(-len(dataset) // batch_size), time.perf_counter() - t0))
            probs = [p for video in out[0].values() for p in video]
            if not (len(probs) == len(dataset) and all(0.0 <= p <= 1.0 for p in probs)):
                raise AssertionError(f"[{self.tag}] {len(probs)} probabilities of "
                                     f"{len(dataset)} frames, not all in [0, 1]")
            return out

        cwd, stdout = os.getcwd(), sys.stdout
        try:
            os.chdir(root)  # runs/ lands in the temporary directory
            base.make_train_step = timed_make_train_step
            self.dataset_cls.finish_item = timed_finish_item
            self.engine_cls._load_batch = timed_load_batch
            self.engine_cls._select_batch = timed_select_batch
            base.AbstractEngine.score_dataset = timed_score_dataset
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            common = ["--engine", self.engine, "--offline"]
            for argv in (["--config", first, *common],
                         ["--config", first, *common, *test_argv, "--test"],
                         ["--config", resumed, *common],
                         *(["--config", first, *common, "--ds_config", ds, "--test"]
                           for ds in test_configs)):
                n_steps, n_evals = len(steps), len(evals)
                _reset_counts()
                t0 = time.perf_counter()
                engine = cli.main(argv)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                got = _route_counts()
                sys.stdout = stdout
                new_steps = steps[n_steps:]
                n_batches = sum(b for b, _ in evals[n_evals:])
                want = tuple(len(new_steps) * s + n_batches * e
                             for s, e in zip(self.step_want, self.eval_want))
                bad = [i for i, (d, _, _) in enumerate(new_steps) if d != self.step_want]
                if got != want or bad:
                    raise AssertionError(
                        f"[{self.tag}] {argv[-1]}: launches K1, K2, K2-bwd, K3, K3-bwd = {got} "
                        f"over {len(new_steps)} steps and {n_batches} eval batches, expected "
                        f"{want}; steps off {bad}")
                if engine.device.type != "cuda":
                    raise AssertionError(f"[{self.tag}] ran on {engine.device}")
                self.totals = tuple(a + b for a, b in zip(self.totals, got))
                self.runs.append((engine, seconds, len(new_steps), n_batches))
            self.peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            base.make_train_step, self.dataset_cls.finish_item = make_train_step, finish_item
            self.engine_cls._load_batch = load_batch
            self.engine_cls._select_batch = select_batch
            base.AbstractEngine.score_dataset = score_dataset
            sys.stdout = stdout
            os.chdir(cwd)

    def check(self, root: str, n_iters: int, eval_lines: int) -> tuple[list, list, list]:
        """The first run's checkpoints, the ``n_iters`` Train Iter lines of
        its run directory (the first run's and the resumed run's) with finite
        losses, ``eval_lines`` Eval Step, Test Step (UE) and Test lines with
        an AUC in [0, 1], and the resume from step 6 to 9: (losses, AUCs,
        those lines)."""
        import numpy as np

        trained, _, again = (r[0] for r in self.runs[:3])
        run_dir = os.path.join(root, trained.run_dir)
        for name in ("best", "latest"):
            if not os.path.isdir(os.path.join(run_dir, "ckpt", name)):
                raise AssertionError(f"[{self.tag}] no ckpt/{name} in {run_dir}")
        with open(os.path.join(run_dir, "records.txt")) as f:
            records = f.read().splitlines()
        with open(os.path.join(run_dir, "test.txt")) as f:
            test_out = f.read().splitlines()
        iters = [ln for ln in records if ln.startswith("Train Iter")]
        losses = [float(ln.split("Loss ")[1].split(",")[0]) for ln in iters]
        reports = ("Eval Step", "Test Step", "Test |")
        scored = [ln for ln in records if ln.startswith(reports)]
        # the test run's reports, each with its indented continuation lines
        for at in (i for i, ln in enumerate(test_out) if ln.startswith(reports)):
            end = next((i for i in range(at + 1, len(test_out))
                        if not test_out[i][:1].isspace()), len(test_out))
            scored.append(" ".join(ln.strip() for ln in test_out[at:end]))
        aucs = [float(ln.split("AUC ")[1].split(",")[0]) for ln in scored]
        if not (len(iters) == n_iters and all(np.isfinite(losses))):
            raise AssertionError(f"[{self.tag}] Train Iter lines {iters}")
        if not (len(aucs) == eval_lines and all(0.0 <= a <= 1.0 for a in aucs)):
            raise AssertionError(f"[{self.tag}] Eval Step / Test lines {scored}")
        if "Resumed from step 6 (best=False)." not in records or again.state.step != 9 or \
                trained.state.step != 6:
            raise AssertionError(f"[{self.tag}] resume: steps {trained.state.step}, "
                                 f"{again.state.step}")
        return losses, aucs, scored

    def rates(self, batch: int) -> dict:
        """Steps 2-6 of the first run: the step rate (each step between two
        synchronises, data waits excluded) and the loop rate (from one step's
        start to the next's where no validation lies between, data waits
        included), as img/s and ms."""
        first = self.steps[:6]
        step_ms = [(t1 - t0) * 1e3 for _, t0, t1 in first[1:]]
        loop_ms = [(b[1] - a[1]) * 1e3 for i, (a, b) in
                   enumerate(zip(first[1:], first[2:]), start=2) if i % 3]
        return dict(step_rate=batch * len(step_ms) / (sum(step_ms) / 1e3), step_ms=step_ms,
                    loop_rate=batch * len(loop_ms) / (sum(loop_ms) / 1e3), loop_ms=loop_ms)


# the cross-dataset --test trees of [engine-fe]: Celeb-DF v2's videos of PNG
# frames, the test videos listed; WildDeepfake's per-split pickles of JPEG
# frame paths
CDF_VIDEOS = {"YouTube-real": ["00000", "00001", "00002"], "Celeb-real": ["id0_0000", "id1_0000"],
              "Celeb-synthesis": ["id0_id1_0000", "id0_id2_0000", "id1_id0_0000", "id1_id2_0000"]}
CDF_TEST = ("YouTube-real/00001", "Celeb-real/id1_0000", "Celeb-synthesis/id0_id2_0000",
            "Celeb-synthesis/id1_id2_0000")


def _write_cdf(root: str, frames: int = 8, size: int = 320) -> int:
    """A Celeb-DF v2 tree: ``<method>/images/<video>/<f>.png`` noise frames
    (Pillow, zlib level 1) and List_of_testing_videos.txt naming CDF_TEST.
    Returns the number of frames."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(SEED + 50)
    n = 0
    for method, videos in CDF_VIDEOS.items():
        for vid in videos:
            os.makedirs(os.path.join(root, method, "images", vid))
            for f in range(frames):
                buf = io.BytesIO()
                Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
                    buf, format="PNG", compress_level=1)
                with open(os.path.join(root, method, "images", vid, f"{f:04d}.png"), "wb") as out:
                    out.write(buf.getvalue())
                n += 1
    with open(os.path.join(root, "List_of_testing_videos.txt"), "w") as f:
        for video in CDF_TEST:
            f.write(f"{int('real' in video)} {video}.mp4\n")
    return n


def _write_wdf(root: str, videos: int = 4, frames: int = 8, size: int = 320) -> int:
    """A WildDeepfake tree: ``<split>/<method>.pickle`` of split-relative
    paths of JPEG noise frames (the port's encoder), ``videos`` real and
    fake videos per split. Returns the number of test frames."""
    import numpy as np
    import torch

    from unidefense_torch.data import native

    rng = np.random.default_rng(SEED + 51)
    for split in ("train", "test"):
        for method in ("real", "fake"):
            items = []
            for v in range(videos):
                for f in range(frames):
                    rel = f"{method}_{v:03d}/{f:04d}.jpg"
                    path = os.path.join(root, split, rel)
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    with open(path, "wb") as out:
                        out.write(native.encode_jpeg(
                            rng.integers(0, 256, (size, size, 3), dtype=np.uint8), 95))
                    items.append(rel)
            torch.save(items, os.path.join(root, split, f"{method}.pickle"))
    return 2 * videos * frames


def _cross_dataset_yml(root: str, name: str, tree: str) -> str:
    """config_template/forgery/data_<name>.yml with its root on ``tree``."""
    import yaml

    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(repo, "config_template", "forgery", f"data_{name}.yml")) as f:
        data = dict(yaml.safe_load(f), root=tree)
    path = os.path.join(root, f"data_{name}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(data, f)
    return path


def _served_alike(run_dir: str, export: str, model: str, card: str) -> str:
    """``Predictor.from_run`` of ``run_dir`` and ``Predictor.from_torch_checkpoint``
    of its export, b32 bf16 on the card: bit-equal probabilities on 32
    frames."""
    import numpy as np
    import torch

    from unidefense_torch.inference import Predictor

    spec = model_spec(model)
    kw = dict(input_size=spec["res"], batch_size=32, dtype=torch.bfloat16, device="cuda")
    frames = np.random.default_rng(SEED + 41).integers(0, 256, (32, spec["res"], spec["res"], 3),
                                                       dtype=np.uint8)
    a = Predictor.from_run(run_dir, model, spec["model"], **kw).predict_frames(frames)
    b = Predictor.from_torch_checkpoint(export, model, spec["model"], seed=SEED + 1,
                                        **kw).predict_frames(frames)
    torch.cuda.empty_cache()
    if not np.array_equal(a, b):
        raise AssertionError(f"[engine-fe] from_run and from_torch_checkpoint of the export "
                             f"differ by {float(np.abs(a - b).max())}")
    return (f"ckpt/best exported by unidefense_torch.tools.export_checkpoint "
            f"({os.path.getsize(export)} bytes): Predictor.from_torch_checkpoint of it and "
            f"Predictor.from_run of the run give bit-equal probabilities on 32 frames b32 bf16 "
            f"(in [{float(a.min()):.4f}, {float(a.max()):.4f}])")


def phase_engine_fe(card: str, weights: dict, root: str) -> tuple:
    """``python -m unidefense_torch.main --engine FE`` in process: UDEB4 at
    380^2, b10+10, bf16, AdamW amsgrad, StepLR (model_udeb4.yml,
    data_ffc23.yml) on a synthetic FF++ tree written under ``root`` (kept for
    ``[engine-fe-dp]``: ``root``/ffpp and the backbone file), its
    ``extractor_weights`` a lukemelas-format EfficientNet-b4 file of the
    seeded backbone (``weights``). Trains 6 steps (validation at 3 and 6), tests from the
    best checkpoint, resumes to step 9; exports ``ckpt/best`` and serves the
    export and the run alike (:func:`_served_alike`); then ``--test`` of the
    run on Celeb-DF (data_cdf.yml, PNG frames) and on WildDeepfake
    (data_wdf.yml). Checks the device, the printed lines (the backbone
    loaded), the checkpoints, the resume, and every train step's launches
    of K1, K2 and K2-bwd (1, 96, 48) and every eval batch's (1, 24); each
    run's launch totals are read around its main() call. Returns the launch
    totals over the five runs."""
    import torch

    from unidefense_torch.data.datasets import AbstractDataset
    from unidefense_torch.engines.forgery import ForgeryEngine
    from unidefense_torch.tools import export_checkpoint

    per_k2, _ = per_forward_launches("UDEB4", 380, frozenset())
    runs = EngineRuns("engine-fe", "FE", AbstractDataset, ForgeryEngine,
                      (1, 4 * per_k2, 2 * per_k2, 0, 0), (1, per_k2, 0, 0, 0))
    tree = os.path.join(root, "ffpp")
    _write_ffpp(tree, card)
    t0 = time.perf_counter()
    n_cdf = _write_cdf(os.path.join(root, "cdf"))
    n_wdf = _write_wdf(os.path.join(root, "wdf"))
    trees_s = time.perf_counter() - t0
    cross = (_cross_dataset_yml(root, "cdf", os.path.join(root, "cdf")),
             _cross_dataset_yml(root, "wdf", os.path.join(root, "wdf")))
    backbone = os.path.join(root, "adv-efficientnet-b4.pth")
    torch.save(published_backbone(weights, "UDEB4"), backbone)
    runs.run(root, *_engine_configs(root, "UDEB4", f"chip-smoke-{os.getpid()}",
                                    model_keys={"extractor_weights": backbone}, root=tree,
                                    fake_method=["Deepfakes"], log_steps=3, val_steps=3),
             test_configs=cross)
    losses, aucs, scored = runs.check(root, n_iters=3, eval_lines=6)
    trained, again = runs.runs[0][0], runs.runs[2][0]
    run_dir = os.path.join(root, trained.run_dir)
    with open(os.path.join(run_dir, "records.txt")) as f:
        if f"Loaded pretrained extractor weights from {backbone}." not in f.read():
            raise AssertionError("[engine-fe] no 'Loaded pretrained extractor weights' line")
    export = os.path.join(root, "export.bin")
    export_checkpoint.main(["--run", run_dir, "--out", export, "--best"])
    served = _served_alike(run_dir, export, "UDEB4", card)
    bs = trained.data_cfg["train_batch_size"]
    r = runs.rates(2 * bs)
    train_loads = [s * 1e3 for n, s in runs.loads if n == bs]
    val_ms = [s * 1e3 / b for b, s in runs.evals]
    log(f"[engine-fe] python -m unidefense_torch.main --engine FE: UDEB4 380^2 b10+10 bf16 "
        f"on {trained.device}, {trained.state.step} steps + test + resume to "
        f"{again.state.step}: steps 2-6, each between two synchronises, data waits "
        f"excluded: {r['step_rate']:.2f} img/s, p50 {statistics.median(r['step_ms']):.2f} ms "
        f"per step ({[round(t, 2) for t in r['step_ms']]}); the loop, data waits included: "
        f"{r['loop_rate']:.2f} img/s ({[round(t, 2) for t in r['loop_ms']]} ms between step "
        f"starts) beside [train] {TRAIN_READINGS.get('train', {}).get('rate', float('nan')):.2f} img/s for the "
        f"bare step; host decode p50 {statistics.median(train_loads):.2f} ms per {bs}-frame "
        f"batch (320^2 -> 380^2, {len(train_loads)} batches); validation and test "
        f"{[round(v, 2) for v in val_ms[:4]]} ms per b64/b96 batch with its decode; peak "
        f"memory {runs.peak:.3f} GiB; runs {[round(x[1], 2) for x in runs.runs[:3]]} s; "
        f"{card}")
    log(f"[engine-fe] launches per train step K1 1 K2 {4 * per_k2} K2-bwd {2 * per_k2} and "
        f"per eval batch K1 1 K2 {per_k2} over {len(runs.steps)} steps and "
        f"{sum(b for b, _ in runs.evals)} eval batches (totals {runs.totals}); losses "
        f"{losses}; AUC {aucs}; extractor_weights {os.path.basename(backbone)} (lukemelas "
        f"naming, its _fc unused) loaded; ckpt/best and ckpt/latest written; resumed from "
        f"step 6 to 9; {served}; {card}")
    # test.txt's reports in run order: FF++, then Celeb-DF and WildDeepfake
    tests = [ln for ln in scored if ln.startswith("Test |")][-2:]
    for (engine, seconds, _, _), (b, s), name, n, line in zip(
            runs.runs[3:], runs.evals[-2:], ("Celeb-DF", "WildDeepfake"), (n_cdf, n_wdf),
            tests):
        log(f"[engine-fe] --test on {name} ({type(engine.test_set).__name__}, "
            f"{len(engine.test_set)} test frames of {n} written, 320^2 -> 380^2, b96): "
            f"{line}; {s * 1e3 / b:.2f} ms per b96 test batch with its decode over {b} "
            f"batches; run {seconds:.2f} s; trees written in {trees_s:.2f} s; {card}")
    return runs.totals


# ------------------------------------------------------------ data parallelism
# One card: NCCL refuses two ranks on one device, so [dp-step] and
# [engine-fe-dp] start two ranks on cuda:0 that meet over gloo in a group of
# their own (parallel.init_data_parallel takes an existing group). Gloo
# carries all_reduce and broadcast of CUDA tensors, all the step, BatchNorm
# and the state broadcast issue. Their times measure no speed.
DP_WORLD = 2
DP_TIMEOUT_S = 900


def _gloo_rank(rank: int, port: int, fn, args: tuple) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=DP_WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def _two_ranks_on_one_card(fn, *args) -> None:
    """``fn(rank, *args)`` in two spawned processes on cuda:0, one gloo
    group. A failing rank terminates the other and raises here; past
    DP_TIMEOUT_S both are killed."""
    import torch.multiprocessing as mp

    from unidefense_torch.parallel.mesh import GRACE_SECONDS, free_port

    ctx = mp.start_processes(_gloo_rank, args=(free_port(), fn, args), nprocs=DP_WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + DP_TIMEOUT_S
    while not ctx.join(timeout=1.0, grace_period=GRACE_SECONDS):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
                p.join()
            raise AssertionError(f"two ranks still running after {DP_TIMEOUT_S} s; killed")


class _Collectives:
    """Counts this process's all_reduce calls and the bytes they reduce,
    while installed (``torch.distributed.all_reduce`` wrapped)."""

    def __init__(self):
        import torch.distributed as dist

        self.calls = self.bytes = 0
        self._dist, self._all_reduce = dist, dist.all_reduce

        def counted(tensor, *args, **kwargs):
            self.calls += 1
            self.bytes += tensor.numel() * tensor.element_size()
            return self._all_reduce(tensor, *args, **kwargs)
        dist.all_reduce = counted

    def read(self) -> tuple:
        out = (self.calls, self.bytes)
        self.calls = self.bytes = 0
        return out


def _state_digest(model, opt_state=None) -> str:
    """sha256 of the model's state_dict and every slot of the optimizer
    state, in order."""
    tensors = list(model.state_dict().values())
    if opt_state is not None:
        tensors += opt_state.tensors()
    return _state_digest_of(tensors)


def _state_digest_of(tensors) -> str:
    """sha256 of the bytes of ``tensors``, in order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dp_state(weights: dict, zero_drop: bool, group=None):
    """UDR18 at 256^2 fp32 from ``weights`` with model_udr18.yml's optimizer
    (drop rates 0 with ``zero_drop``), its BatchNorms synced over ``group``,
    and the two-pass step at 30 + 30 frames with ``group``."""
    import torch

    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.parallel import sync_batchnorm
    from unidefense_torch.train.optim import build_optimizer
    from unidefense_torch.train.step import create_train_state, make_train_step

    spec = model_spec("UDR18")
    cfg = dict(spec["model"], drop_rate=0.0, feat_drop_rate=0.0) if zero_drop else spec["model"]
    net = build_model("UDR18", cfg, dtype=torch.float32)
    net.load_state_dict(weights, strict=True)
    tx, _ = build_optimizer(spec["config"])
    state = create_train_state(net, tx, device="cuda:0")
    sync_batchnorm(state.model, group)
    step = make_train_step(tx, spec["config"], spec["num_steps"], 30, 30,
                           preprocess=DevicePipeline(hflip_p=0.5), group=group)
    return state, step


def _on_card(batch: dict) -> dict:
    return {k: v.to("cuda:0") for k, v in batch.items()}


def _dp_step_rank(rank: int, tmp: str) -> None:
    """[dp-step] on one rank: the exactness step (both ranks the same batch
    and draws, drop rates 0), then 3 steps on this rank's half with its own
    generator and the YAML's drop rates. Saves the state after the first,
    and the launches, times, digests and peak memory."""
    import torch

    from unidefense_torch.parallel import init_data_parallel

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dp = init_data_parallel(device="cuda:0")
    data = torch.load(os.path.join(tmp, "dp_step.pt"), weights_only=False)
    state, step = _dp_state(data["weights"], True, dp.group)
    _reset_counts()
    step(state, _on_card(data["batch"]), None, data["draws"])
    torch.cuda.synchronize()
    exact_counts = _route_counts()
    torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
               os.path.join(tmp, f"exact{rank}.pt"))
    del state, step
    state, step = _dp_state(data["weights"], False, dp.group)
    batch = _on_card(data["halves"][rank])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    reduced = _Collectives()
    for s in range(1, 4):
        gen = torch.Generator(device="cuda:0").manual_seed(SEED + 40 + 100 * rank + s)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t0) * 1e3, counts=_route_counts(),
                          all_reduce=reduced.read(),
                          digest=_state_digest(state.model, state.opt_state),
                          loss=float(metrics["total_loss"])))
    torch.save(dict(exact_counts=exact_counts, steps=steps,
                    peak=torch.cuda.max_memory_allocated() / 2**30),
               os.path.join(tmp, f"rank{rank}.pt"))


# [dp-step]'s tolerances against the one-process step on the same batch: the
# first AdamW updates move each weight by about +-lr whatever its gradient's
# size, so rounding in a gradient near 0 can flip one: 2.2 lr for each of the
# step's two updates (lr 1e-4, model_udr18.yml); running statistics within
# 5e-3 of each tensor's max |value|: the synced n of the duplicated batch is
# 2n, whose unbiased factor 2n/(2n-1) against n/(n-1) moves a running
# variance by m n/((n-1)(2n-1)) per update, at most 1.7e-3 over the step's
# two at the bottleneck's n = 60, plus E[x^2] - E[x]^2's rounding
DP_PARAM_ATOL = 2 * 2.2 * 1e-4
DP_STAT_REL = 5e-3


def phase_dp_step(card: str, weights: dict) -> tuple:
    """[dp-step]: the data-parallel two-pass step of UDR18 at 256^2, 30 real
    + 30 fake per rank, fp32 (TF32 off), two ranks on cuda:0 over gloo.
    (1) Both ranks take the same batch and draws (drop rates 0): each
    rank's parameters and BatchNorm statistics after one step against the
    one-process step on that batch (DP_PARAM_ATOL, DP_STAT_REL). (2) The
    ranks take the two halves of a 60 + 60 batch, each its own generator
    and the YAML's drop rates, for 3 steps: the digests of parameters,
    buffers and optimizer moments equal on both ranks after every step.
    Checks every step's K1, K2 and K2-bwd launches on each rank (1, 32,
    16). Returns the launch totals of the 3 steps on both ranks."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from unidefense_torch.train.perturb import PerturbDraws
    from unidefense_torch.train.step import StepDraws

    per_k2, _ = per_forward_launches("UDR18", 256, frozenset())
    want = (1, 4 * per_k2, 2 * per_k2, 0, 0)
    tmp = tempfile.mkdtemp(prefix="ud_dp_step_")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        draws = PerturbDraws.draw(torch.Generator().manual_seed(SEED + 41), 30, 30,
                                  (60, 256, 256, 3))
        draws = StepDraws(flip=torch.rand(60, generator=torch.Generator().manual_seed(SEED + 42))
                          < 0.5, perturb=dataclasses.replace(draws, style=True, freq=True))
        batch = _train_batch(30, 30, 256, SEED + 43, "cpu")
        both = _train_batch(60, 60, 256, SEED + 44, "cpu")
        halves = [{k: torch.cat([v[30 * r:30 * r + 30], v[60 + 30 * r:90 + 30 * r]])
                   for k, v in both.items()} for r in range(DP_WORLD)]
        torch.save(dict(weights=weights, batch=batch, draws=draws, halves=halves),
                   os.path.join(tmp, "dp_step.pt"))
        # the one-process step on the same batch and draws, here
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        state, step = _dp_state(weights, True)
        step(state, _on_card(batch), None, draws)
        ref = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _two_ranks_on_one_card(_dp_step_rank, tmp)
        seconds = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_WORLD)]
        param_err = stat_err = 0.0
        for r in range(DP_WORLD):
            got = torch.load(os.path.join(tmp, f"exact{r}.pt"))
            for k, v in ref.items():
                if v.dtype != torch.float32:
                    if not torch.equal(got[k], v):
                        raise AssertionError(f"[dp-step] rank {r} {k}: {got[k]} vs {v}")
                    continue
                d = float((got[k] - v).abs().max())
                if "running" in k:
                    stat_err = max(stat_err, d / max(float(v.abs().max()), 1e-12))
                else:
                    param_err = max(param_err, d)
        if not (param_err <= DP_PARAM_ATOL and stat_err <= DP_STAT_REL):
            raise AssertionError(f"[dp-step] two ranks vs one process: params max |d| "
                                 f"{param_err} (tol {DP_PARAM_ATOL}), statistics max rel "
                                 f"{stat_err} (tol {DP_STAT_REL})")
        for r, res in enumerate(ranks):
            bad = [s["counts"] for s in res["steps"] if s["counts"] != want]
            if res["exact_counts"] != want or bad:
                raise AssertionError(f"[dp-step] rank {r} launches K1, K2, K2-bwd, K3, K3-bwd "
                                     f"{res['exact_counts']}, {bad}; expected {want} a step")
        digests = [[s["digest"] for s in res["steps"]] for res in ranks]
        if digests[0] != digests[1]:
            raise AssertionError(f"[dp-step] the ranks' states differ: {digests}")
        totals = tuple(sum(s["counts"][i] for res in ranks for s in res["steps"])
                       for i in range(5))
        calls, nbytes = ranks[0]["steps"][-1]["all_reduce"]
        log(f"[dp-step] UDR18 256^2 b30+30 per rank fp32 (TF32 off), two ranks on cuda:0 over "
            f"gloo: (1) same batch and draws on both: parameters max |d| {param_err:.3g} (tol "
            f"{DP_PARAM_ATOL:.3g}) and running statistics max rel {stat_err:.3g} (tol "
            f"{DP_STAT_REL}) from the one-process step; (2) different halves, 3 steps: "
            f"parameters, buffers and optimizer moments bitwise equal on both ranks after each "
            f"(sha256 {digests[0][-1][:16]}), losses {[round(s['loss'], 5) for s in ranks[0]['steps']]}; "
            f"launches per step and rank K1 {want[0]} K2 {want[1]} K2-bwd {want[2]} (totals "
            f"{totals}); all_reduce per step and rank: {calls} calls, {nbytes} bytes; {card}")
        log(f"[dp-step] not a speed figure (two ranks share one card and meet over gloo): ms "
            f"per step rank 0 {[round(s['ms'], 2) for s in ranks[0]['steps']]}, rank 1 "
            f"{[round(s['ms'], 2) for s in ranks[1]['steps']]}; peak GiB per rank "
            f"{[round(res['peak'], 3) for res in ranks]}; phase {seconds:.2f} s; {card}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(tmp, ignore_errors=True)
    return totals


def _engine_dp_rank(rank: int, root: str, argv: list, out: str) -> None:
    """[engine-fe-dp] on one rank: ``unidefense_torch.main.run(argv,
    "cuda:0")`` in ``root``, each train step timed between two synchronises
    with its launch deltas, each score_dataset's launches, batches and the
    frames it scored per video, each merged validation; then the state's
    digest and the run directory."""
    import torch

    from unidefense_torch import main as cli
    from unidefense_torch.engines import base

    os.chdir(root)
    make_train_step, score_dataset = base.make_train_step, base.AbstractEngine.score_dataset
    gather = base.AbstractEngine.gather_eval_output
    steps, evals, merged = [], [], []

    reduced = _Collectives()

    def timed_make_train_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def timed(state, batch, generator=None, draws=None):
            torch.cuda.synchronize()
            before, t0 = _route_counts(), time.perf_counter()
            reduced.read()
            out = step(state, batch, generator, draws)
            torch.cuda.synchronize()
            steps.append((tuple(b - a for a, b in zip(before, _route_counts())),
                          (time.perf_counter() - t0) * 1e3, reduced.read()))
            return out
        return timed

    def counted_score_dataset(engine, dataset, batch_size, *args, **kwargs):
        before = _route_counts()
        prob, tgt = score_dataset(engine, dataset, batch_size, *args, **kwargs)
        torch.cuda.synchronize()
        n = len(range(engine.dp.rank, len(dataset), engine.n_dev))
        evals.append((-(-n // batch_size), tuple(b - a for a, b in zip(before, _route_counts())),
                      {v: len(p) for v, p in prob.items()}))
        return prob, tgt

    def recorded_gather(engine, prob, tgt):
        result = gather(engine, prob, tgt)
        merged.append(result)
        return result

    base.make_train_step = timed_make_train_step
    base.AbstractEngine.score_dataset = counted_score_dataset
    base.AbstractEngine.gather_eval_output = recorded_gather
    stdout = sys.stdout
    torch.cuda.reset_peak_memory_stats()
    try:
        engine = cli.run(argv, "cuda:0")
    finally:
        sys.stdout = stdout
    torch.cuda.synchronize()
    torch.save(dict(steps=steps, evals=evals, merged=merged, step=engine.state.step,
                    digest=_state_digest(engine.state.model, engine.state.opt_state),
                    run_dir=engine.run_dir, device=str(engine.device), world=engine.n_dev,
                    peak=torch.cuda.max_memory_allocated() / 2**30),
               os.path.join(out, f"rank{rank}.pt"))


def phase_engine_fe_dp(card: str, root: str) -> tuple:
    """[engine-fe-dp]: the FE engine of [engine-fe] (UDEB4 380^2 bf16,
    model_udeb4.yml and data_ffc23.yml on its tree under ``root``, its
    backbone file) on two ranks on cuda:0 over gloo, b10+10 per rank, 4
    steps validated at 2 and 4. Checks every rank's launches per train step
    (1, 96, 48) and per eval batch (1, 24); every validation frame scored
    once over the two stripes; the ranks' states equal bitwise after the
    run and rank 0's ckpt/best and ckpt/latest; then, in this process, the
    run resumed on one card: its restored state bitwise the ranks', its
    score_dataset of the whole split equal to the ranks' merged validation
    of step 4 (every frame within 1e-6, the metrics within 1e-6), and it
    trains on to step 6. Returns the launch totals of both ranks."""
    import numpy as np
    import torch

    from unidefense_torch.config import load_config
    from unidefense_torch.engines import get_engine
    from unidefense_torch.utils.metrics import cal_metrics

    per_k2, _ = per_forward_launches("UDEB4", 380, frozenset())
    step_want, eval_want = (1, 4 * per_k2, 2 * per_k2, 0, 0), (1, per_k2, 0, 0, 0)
    run_id = f"chip-smoke-dp-{os.getpid()}"
    os.makedirs(os.path.join(root, "dp"))
    first, resumed = _engine_configs(
        os.path.join(root, "dp"), "UDEB4", run_id, steps=(4, 6),
        model_keys={"extractor_weights": os.path.join(root, "adv-efficientnet-b4.pth")},
        root=os.path.join(root, "ffpp"), fake_method=["Deepfakes"], log_steps=2, val_steps=2)
    out = os.path.join(root, "dp-out")
    os.makedirs(out)
    gc.collect()  # the earlier phases' engines, before the ranks take the card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _two_ranks_on_one_card(_engine_dp_rank, root, ["--config", first, "--engine", "FE",
                                                   "--offline"], out)
    seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_WORLD)]
    for r, res in enumerate(ranks):
        bad = [c for c, _, _ in res["steps"] if c != step_want]
        eval_bad = [(b, c) for b, c, _ in res["evals"] if c != tuple(b * e for e in eval_want)]
        if res["world"] != DP_WORLD or res["step"] != 4 or len(res["steps"]) != 4 or bad or \
                eval_bad:
            raise AssertionError(f"[engine-fe-dp] rank {r}: world {res['world']}, step "
                                 f"{res['step']}, step launches off {bad}, eval launches off "
                                 f"{eval_bad}")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("[engine-fe-dp] the ranks' states differ after the run")
    if ranks[0]["merged"] != ranks[1]["merged"]:
        raise AssertionError("[engine-fe-dp] the ranks merged different validations")
    run_dir = os.path.join(root, ranks[0]["run_dir"])
    for name in ("best", "latest"):
        if not os.path.isdir(os.path.join(run_dir, "ckpt", name)):
            raise AssertionError(f"[engine-fe-dp] rank 0 wrote no ckpt/{name}")
    # one card: resume the run (step 4) and score the whole split
    cwd, stdout = os.getcwd(), sys.stdout
    os.chdir(root)
    try:
        cfg = load_config(resumed, engine="FE")
        cfg["config"]["offline"] = True
        one = get_engine("FE")(cfg, stage="Train")
        restored = _state_digest(one.state.model, one.state.opt_state)
        prob, tgt = one.score_dataset(one.val_set, one.val_batch_size, {"crop": one.crop}, 4)
        want = one.gather_eval_output(prob, tgt)
        one.train()
    finally:
        sys.stdout = stdout
        os.chdir(cwd)
    if restored != ranks[0]["digest"] or one.state.step != 6:
        raise AssertionError(f"[engine-fe-dp] one card: restored {restored}, the ranks' "
                             f"{ranks[0]['digest']}; step {one.state.step} (expected 6)")
    stripes = [res["evals"][-1][2] for res in ranks]
    scored = {v: sum(s.get(v, 0) for s in stripes) for v in prob}
    if scored != {v: len(p) for v, p in prob.items()} or \
            sum(map(len, prob.values())) != len(one.val_set):
        raise AssertionError(f"[engine-fe-dp] frames scored per video by the stripes {stripes}, "
                             f"by one process {({v: len(p) for v, p in prob.items()})}")
    got = ranks[0]["merged"][-1]
    frame_err = float(np.abs(np.sort(got["frame_prob"]) - np.sort(want["frame_prob"])).max())
    mg = cal_metrics(np.asarray(got["frame_tgt"]), np.asarray(got["frame_prob"]), threshold=0.5)
    mw = cal_metrics(np.asarray(want["frame_tgt"]), np.asarray(want["frame_prob"]),
                     threshold=0.5)
    metric_err = max(abs(mg[k] - mw[k]) for k in ("AUC", "ACC", "EER"))
    if not (frame_err <= 1e-6 and metric_err <= 1e-6):
        raise AssertionError(f"[engine-fe-dp] merged stripes vs one process: frames max |d| "
                             f"{frame_err}, metrics max |d| {metric_err} (tol 1e-6): {mg} vs {mw}")
    totals = tuple(sum(c[i] for res in ranks for c, _, _ in res["steps"]) +
                   sum(c[i] for res in ranks for _, c, _ in res["evals"]) for i in range(5))
    log(f"[engine-fe-dp] python -m unidefense_torch.main --engine FE on two ranks (cuda:0, "
        f"gloo): UDEB4 380^2 b10+10 per rank bf16, 4 steps, validation at 2 and 4 striped "
        f"({[sum(s.values()) for s in stripes]} frames per rank, {len(one.val_set)} in all, each "
        f"once); states bitwise equal on both ranks; rank 0 wrote ckpt/best and ckpt/latest; "
        f"resumed on one card: restored bitwise, its score_dataset against the merged stripes "
        f"max |dprob| {frame_err:.3g}, AUC {mw['AUC']:.4f} ACC {mw['ACC']:.4f} EER "
        f"{mw['EER']:.4f} (max |d| {metric_err:.3g}, tol 1e-6), trained on to step "
        f"{one.state.step}; launches per step and rank K1 1 K2 {4 * per_k2} K2-bwd "
        f"{2 * per_k2}, per eval batch K1 1 K2 {per_k2} (totals {totals}); all_reduce per "
        f"step and rank: {ranks[0]['steps'][-1][2][0]} calls, {ranks[0]['steps'][-1][2][1]} "
        f"bytes; {card}")
    log(f"[engine-fe-dp] not a speed figure (two ranks share one card and meet over gloo): "
        f"ms per step rank 0 {[round(t, 2) for _, t, _ in ranks[0]['steps']]}, rank 1 "
        f"{[round(t, 2) for _, t, _ in ranks[1]['steps']]}; peak GiB per rank "
        f"{[round(res['peak'], 3) for res in ranks]}; two-rank run {seconds:.2f} s; {card}")
    return totals


def phase_dp_cards(card: str, root: str, weights: dict) -> None:
    """[dp-nccl] and [serve-dp], where the host has two cards or more:
    ``python -m unidefense_torch.main --engine FE --num_devices 2`` over
    NCCL (rank r on cuda:r) on [engine-fe]'s tree, 2 steps validated at 2;
    and ``Predictor(num_devices=2)`` against the one-device Predictor on the
    same 64 frames (UDEB4 380^2 b32 bf16). On one card it says so."""
    import numpy as np
    import torch

    from unidefense_torch import main as cli
    from unidefense_torch.inference import Predictor

    n = torch.cuda.device_count()
    if n < 2:
        log(f"[dp-nccl] [serve-dp] not run: this host has {n} card; NCCL refuses two ranks on "
            f"one device, so NCCL training and the two-replica Predictor wait for a host with "
            f"two cards or more; {card}")
        return
    os.makedirs(os.path.join(root, "nccl"))
    first, _ = _engine_configs(
        os.path.join(root, "nccl"), "UDEB4", f"chip-smoke-nccl-{os.getpid()}", steps=(2, 3),
        root=os.path.join(root, "ffpp"), fake_method=["Deepfakes"], log_steps=2, val_steps=2)
    cwd, stdout = os.getcwd(), sys.stdout
    os.chdir(root)
    try:
        t0 = time.perf_counter()
        if cli.main(["--config", first, "--engine", "FE", "--offline", "--num_devices", "2"]) \
                is not None:
            raise AssertionError("[dp-nccl] main with --num_devices 2 returned an engine")
        seconds = time.perf_counter() - t0
    finally:
        sys.stdout = stdout
        os.chdir(cwd)
    run_dir = os.path.join(root, "runs", "UDEB4", f"chip-smoke-nccl-{os.getpid()}")
    with open(os.path.join(run_dir, "records.txt")) as f:
        records = f.read()
    if records.count("Train Iter (2/2)") != 1 or not os.path.isdir(os.path.join(run_dir, "ckpt",
                                                                               "latest")):
        raise AssertionError(f"[dp-nccl] rank 0's records or checkpoint missing in {run_dir}")
    log(f"[dp-nccl] python -m unidefense_torch.main --engine FE --num_devices 2 over NCCL "
        f"(cuda:0, cuda:1): UDEB4 380^2 b10+10 per rank bf16, 2 steps and a validation, "
        f"{seconds:.2f} s with the ranks' start; rank 0's records and ckpt written; {card}")
    spec = model_spec("UDEB4")
    frames = np.random.default_rng(SEED + 45).integers(0, 256, (64, 380, 380, 3), dtype=np.uint8)
    one = Predictor("UDEB4", spec["model"], state_dict=weights, input_size=380, batch_size=32)
    two = Predictor("UDEB4", spec["model"], state_dict=weights, input_size=380, batch_size=32,
                    num_devices=2)
    p1, p2 = one.predict_frames(frames), two.predict_frames(frames)
    t0 = time.perf_counter()
    two.predict_frames(frames)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(p1 - p2).max())
    # [parity]'s bf16 bound: the replicas convolve b16 batches, which cuDNN
    # may take with other algorithms than b32's
    if not err <= 2e-2:
        raise AssertionError(f"[serve-dp] two replicas vs one: max |dprob| {err} (tol 2e-2)")
    log(f"[serve-dp] Predictor(num_devices=2) UDEB4 380^2 b32 bf16 (b16 per card) against one "
        f"device on 64 frames: max |dprob| {err:.3g} (tol 2e-2); {ms:.2f} ms for the 64 frames "
        f"(one sample); {card}")


# [mesh2d]: the 2-D ('data', 'model') mode. The sharded legs need a card per
# rank: NCCL refuses two ranks on one device and gloo gathers no CUDA tensor.
MESH_MP = 2
MESH_TIMEOUT_S = 900


def _mesh_state(weights: dict, dtype, zero_drop: bool, mesh=None, group=None, rows=(10, 10)):
    """UDR18 at 256^2 from ``weights`` in ``dtype`` with model_udr18.yml's
    optimizer (drop rates 0 with ``zero_drop``), on this process's card, and
    the two-pass step over ``rows`` (real, fake): with ``mesh``, the
    global-batch step of the 2-D mode wrapped by ``gspmd_train_step``
    (weights of 65,536 elements or more sharded over 'model'); with
    ``group``, the 1-D mode's step, BatchNorms synced over it."""
    import torch

    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.parallel import sync_batchnorm
    from unidefense_torch.parallel.mesh import gspmd_train_step
    from unidefense_torch.train.optim import build_optimizer
    from unidefense_torch.train.step import create_train_state, make_train_step

    spec = model_spec("UDR18")
    cfg = dict(spec["model"], drop_rate=0.0, feat_drop_rate=0.0) if zero_drop else spec["model"]
    net = build_model("UDR18", cfg, dtype=dtype)
    net.load_state_dict(weights, strict=True)
    tx, _ = build_optimizer(spec["config"])
    state = create_train_state(net, tx, device=f"cuda:{torch.cuda.current_device()}")
    sync_batchnorm(state.model, group)
    step = make_train_step(tx, spec["config"], spec["num_steps"], *rows,
                           preprocess=DevicePipeline(hflip_p=0.5), group=group, mesh=mesh)
    if mesh is not None:
        step = gspmd_train_step(step, mesh, state)
    return state, step


class _Gathers(_Collectives):
    """[dp-step]'s all_reduce count, the all_gather calls (NCCL's
    all_gather_into_tensor, gloo's all_gather) and the bytes they gather
    (the output's size), and the broadcasts and their bytes, while
    installed."""

    def __init__(self):
        super().__init__()
        self.gathers = self.gathered = self.casts = self.cast = 0
        ag, agt, bc = self._dist.all_gather, self._dist.all_gather_into_tensor, self._dist.broadcast

        def broadcast(tensor, *args, **kwargs):
            self.casts += 1
            self.cast += tensor.numel() * tensor.element_size()
            return bc(tensor, *args, **kwargs)

        def into_tensor(out, tensor, *args, **kwargs):
            self.gathers += 1
            self.gathered += out.numel() * out.element_size()
            return agt(out, tensor, *args, **kwargs)

        def into_list(parts, tensor, *args, **kwargs):
            self.gathers += 1
            self.gathered += sum(t.numel() * t.element_size() for t in parts)
            return ag(parts, tensor, *args, **kwargs)
        self._dist.all_gather_into_tensor, self._dist.all_gather = into_tensor, into_list
        self._dist.broadcast = broadcast

    def read_all(self) -> dict:
        out = {"all_gather": (self.gathers, self.gathered), "all_reduce": self.read(),
               "broadcast": (self.casts, self.cast)}
        self.gathers = self.gathered = self.casts = self.cast = 0
        return out


def _grad_norms(model, mesh) -> dict:
    """Each parameter's gradient norm, a sharded one's over its slices."""
    import torch
    import torch.distributed as dist

    sharded = getattr(model, "sharded", None)
    norms = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        sq = p.grad.float().pow(2).sum()
        if sharded is not None and sharded.plan["params"][name] is not None:
            dist.all_reduce(sq, group=mesh.model_group)
        norms[name] = float(torch.sqrt(sq))
    return norms


def _mesh2d_rank(out: str, weights: dict, batch: dict, draws, mp: int) -> None:
    """[mesh2d] on one rank of a (world / mp, mp) mesh over NCCL: (1) one
    fp32 step (TF32 off, drop rates 0) on this rank's rows of the global
    batch with the global draws; (2) the 1-D mode's step on a real-first
    batch of as many rows, 2 steps bf16, for its peak memory; (3) 3 bf16
    steps of the 2-D mode with the YAML's drop rates from one generator
    seed. Saves the launches, the collectives, the gathered state's digest,
    the peaks and, from rank 0, the fp32 step's metrics, gradient norms and
    gathered state."""
    import torch
    import torch.distributed as dist

    from unidefense_torch.parallel.mesh import create_mesh_2d, gather_state

    mesh = create_mesh_2d(None, model_parallel=mp, device="cuda")
    counts = _Gathers()
    n = len(batch["label"])
    rows = mesh.rows(n)
    mine = {k: v[rows].to(mesh.device) for k, v in batch.items()}
    result = {"place": (mesh.data_index, mesh.model_index), "rows": (rows.start, rows.stop)}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        state, step = _mesh_state(weights, torch.float32, True, mesh)
        counts.read_all()
        _reset_counts()
        _, metrics, cls_out = step(state, mine, None, draws)
        torch.cuda.synchronize()
        result["exact"] = dict(counts=_route_counts(), collectives=counts.read_all())
        norms = _grad_norms(state.model, mesh)
        sd, slots = gather_state(state.model, state.opt_state, mesh)
        result["digest"] = _state_digest_of(list(sd.values()) +
                                            [t for s in slots.values() for t in s.values()])
        result["tensors"] = _tensor_digests(sd, slots)
        if mesh.rank == 0:
            result["fp32"] = dict(metrics={k: float(v) for k, v in metrics.items()}, norms=norms,
                                  params={k: v.cpu() for k, v in sd.items()},
                                  cls_out=cls_out.float().cpu())
        del state, step, sd, slots
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    # the 1-D mode on the same ranks and rows per rank, for its memory
    half = (rows.stop - rows.start) // 2
    flat = _train_batch(half, half, 256, SEED + 52 + mesh.rank, f"cuda:{mesh.device.index}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step = _mesh_state(weights, torch.bfloat16, False, group=dist.group.WORLD,
                              rows=(half, half))
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 53 + mesh.rank)
    for _ in range(2):
        step(state, flat, gen)
    torch.cuda.synchronize()
    result["peak_1d"] = torch.cuda.max_memory_allocated() / 2**30
    del state, step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step = _mesh_state(weights, torch.bfloat16, False, mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 54)
    steps = []
    for _ in range(3):
        counts.read_all()
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics, cls_out = step(state, mine, gen)
        torch.cuda.synchronize()
        vals = {k: float(v) for k, v in metrics.items()}
        steps.append(dict(ms=(time.perf_counter() - t0) * 1e3, counts=_route_counts(),
                          collectives=counts.read_all(), loss=vals["total_loss"],
                          finite=all(v == v and abs(v) < float("inf") for v in vals.values())
                          and bool(torch.isfinite(cls_out).all()), rows=cls_out.shape[0]))
    result["bf16"] = steps
    result["peak_2d"] = torch.cuda.max_memory_allocated() / 2**30
    sd, slots = gather_state(state.model, state.opt_state, mesh)
    result["bf16_digest"] = _state_digest_of(list(sd.values()) +
                                             [t for s in slots.values() for t in s.values()])
    result["bf16_tensors"] = _tensor_digests(sd, slots)
    torch.save(result, os.path.join(out, f"rank{mesh.rank}.pt"))


def _tensor_digests(sd: dict, slots: dict) -> dict:
    """Each tensor's sha256 (16 digits) by name, the slots' as slot/name."""
    tensors = {**sd, **{f"{s}/{k}": t for s, d in slots.items() for k, t in d.items()}}
    return {k: _state_digest_of([t])[:16] for k, t in tensors.items()}


def phase_mesh2d(card: str, weights: dict) -> tuple:
    """[mesh2d]: the 2-D mode (``parallel.mesh.create_mesh_2d``,
    ``gspmd_train_step``, the steps' ``mesh``) of UDR18 at 256^2, global
    batch 10 real + 10 fake. (1) The 1x1 mesh on this card: 3 bf16 steps
    with the YAML's drop rates through the 2-D code path from one generator
    seed, against make_train_step's 3 from the same seed: the states
    (parameters, buffers, slots) equal bit for bit after every step, the
    launches of K1, K2 and K2-bwd per step (1, 32, 16). (2) With two cards
    or more, ranks over NCCL, one per card, on a (cards / 2, 2) mesh of
    two or four cards: the fp32 step against this card's make_train_step on
    the global batch and draws (the losses and gradient norms at
    [train-parity-udr18]'s bounds, the gathered parameters and running
    statistics at [dp-step]'s), the ranks' gathered states bitwise equal,
    the launches, all_gather and all_reduce calls and bytes per step and
    rank, the peak memory beside the 1-D mode's on the same ranks, then 3
    bf16 steps, each finite. On one card (2) is a line that says it did not
    run. Returns the launches of K1, K2 and K2-bwd of every 2-D step."""
    import dataclasses
    import shutil
    import tempfile
    import warnings

    import torch

    from unidefense_torch.parallel.mesh import create_mesh_2d
    from unidefense_torch.train.perturb import PerturbDraws
    from unidefense_torch.train.step import StepDraws

    per_k2, _ = per_forward_launches("UDR18", 256, frozenset())
    want = (1, 4 * per_k2, 2 * per_k2, 0, 0)
    batch = _train_batch(10, 10, 256, SEED + 50, "cuda")
    mesh = create_mesh_2d(device="cuda")
    digests, totals = [], (0, 0, 0)
    # the card's backward adds with atomics in places (cuDNN's algorithms,
    # pooling): a bitwise comparison of two runs needs torch's deterministic
    # mode, where each such op that has a deterministic form takes it
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings():
        # adaptive_avg_pool2d's backward has no deterministic form; at the
        # extractor's whole-factor pools it writes each input once
        warnings.filterwarnings("ignore", message=".*not have a deterministic implementation")
        try:
            for use_mesh in (False, True):
                state, step = _mesh_state(weights, torch.bfloat16, False,
                                          mesh if use_mesh else None)
                gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
                run = []
                for _ in range(3):
                    _reset_counts()
                    _, metrics, _ = step(state, batch, gen)
                    torch.cuda.synchronize()
                    if use_mesh and _route_counts() != want:
                        raise AssertionError(f"[mesh2d] 1x1: launches K1, K2, K2-bwd, K3, K3-bwd "
                                             f"{_route_counts()}; expected {want} a step")
                    totals = tuple(a + b for a, b in zip(totals, _route_counts()[:3])) \
                        if use_mesh else totals
                    run.append((_state_digest(state.model, state.opt_state),
                                float(metrics["total_loss"])))
                digests.append(run)
                del state, step
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    if digests[0] != digests[1]:
        raise AssertionError(f"[mesh2d] 1x1 mesh vs make_train_step: {digests}")
    log(f"[mesh2d] 1x1 mesh (one card, no group): UDR18 256^2 b10+10 bf16, the YAML's drop "
        f"rates, 3 two-pass steps through make_train_step(mesh=...) and gspmd_train_step, "
        f"cuDNN and torch in their deterministic modes: "
        f"parameters, buffers and slots bit for bit make_train_step's after each (sha256 "
        f"{digests[1][-1][0][:16]}), losses {[round(l, 5) for _, l in digests[1]]}; launches per "
        f"step K1 {want[0]} K2 {want[1]} K2-bwd {want[2]}; {card}")
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"[mesh2d] the sharded legs (1x2 and 2x2 meshes over NCCL) not run: this host has "
            f"{cards} card; they take a card per rank (NCCL refuses two ranks on one device, "
            f"and gloo gathers no CUDA tensor); {card}")
        return totals
    world = 4 if cards >= 4 else 2
    draws = PerturbDraws.draw(torch.Generator().manual_seed(SEED + 55), 10, 10,
                              (20, 256, 256, 3))
    draws = StepDraws(flip=torch.rand(20, generator=torch.Generator().manual_seed(SEED + 56))
                      < 0.5, perturb=dataclasses.replace(draws, style=True, freq=True))
    tmp = tempfile.mkdtemp(prefix="ud_mesh2d_")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        state, step = _mesh_state(weights, torch.float32, True)
        _, metrics, cls_out = step(state, batch, None, draws)
        ref = ({k: float(v) for k, v in metrics.items()},
               {n: float(p.grad.norm()) for n, p in state.model.named_parameters()
                if p.grad is not None},
               {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
               cls_out.float().cpu())
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        from unidefense_torch.parallel import launch

        t0 = time.perf_counter()
        launch(_mesh2d_rank, world, args=(tmp, weights, {k: v.cpu() for k, v in batch.items()},
                                          draws, MESH_MP), timeout=MESH_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(tmp, ignore_errors=True)
    layout = f"{world // MESH_MP}x{MESH_MP}"
    got = ranks[0]["fp32"]
    loss_err, loss_worst, grad_err, worst, total = _parity_errors(
        ref[:2], (got["metrics"], got["norms"]))
    param_err = stat_err = 0.0
    for k, v in ref[2].items():
        if not v.is_floating_point():
            if not torch.equal(got["params"][k], v):
                raise AssertionError(f"[mesh2d] {layout} {k}: {got['params'][k]} vs {v}")
            continue
        d = float((got["params"][k] - v).abs().max())
        if "running" in k:
            stat_err = max(stat_err, d / max(float(v.abs().max()), 1e-12))
        else:
            param_err = max(param_err, d)
    cls_err = float((got["cls_out"] - ref[3]).abs().max())
    if not (loss_err <= 1e-3 and grad_err <= 1e-2 and param_err <= DP_PARAM_ATOL
            and stat_err <= DP_STAT_REL and got["cls_out"].shape == ref[3].shape):
        raise AssertionError(
            f"[mesh2d] {layout} vs one card: losses max rel {loss_err} at {loss_worst} (tol "
            f"1e-3), gradient norms {grad_err} at {worst} (tol 1e-2), params {param_err} (tol "
            f"{DP_PARAM_ATOL}), statistics {stat_err} (tol {DP_STAT_REL}), cls_out "
            f"{tuple(got['cls_out'].shape)} vs {tuple(ref[3].shape)}")
    for key in ("tensors", "bf16_tensors"):
        differ = sorted(k for k, v in ranks[0][key].items()
                        if any(r[key][k] != v for r in ranks[1:]))
        if differ:
            raise AssertionError(f"[mesh2d] {layout}: the ranks' gathered states differ ({key}) "
                                 f"in {len(differ)} tensors: {differ[:12]}")
    for r, res in enumerate(ranks):
        bad = [s["counts"] for s in res["bf16"] if s["counts"] != want]
        if res["exact"]["counts"] != want or bad:
            raise AssertionError(f"[mesh2d] {layout} rank {r} launches K1, K2, K2-bwd, K3, "
                                 f"K3-bwd {res['exact']['counts']}, {bad}; expected {want}")
        if not all(s["finite"] and s["rows"] == 20 for s in res["bf16"]):
            raise AssertionError(f"[mesh2d] {layout} rank {r}: bf16 steps {res['bf16']}")
    totals = tuple(t + sum(s["counts"][i] for res in ranks
                           for s in [res["exact"]] + res["bf16"]) for i, t in enumerate(totals))
    log(f"[mesh2d] {layout} mesh over NCCL ({world} cards, a rank each, weights of 65536 "
        f"elements or more sharded over 'model'), UDR18 256^2 global b10+10 fp32 (TF32 off), "
        f"one step against this card's make_train_step on the global batch and draws: losses "
        f"max rel {loss_err:.3g} at {loss_worst} (tol 1e-3), {len(ref[1])} gradient norms "
        f"{grad_err:.3g} at {worst} (tol 1e-2), gathered parameters max |d| {param_err:.3g} (tol "
        f"{DP_PARAM_ATOL:.3g}), running statistics max rel {stat_err:.3g} (tol {DP_STAT_REL}), "
        f"global cls_out max |d| {cls_err:.3g}; the ranks' gathered states bitwise equal "
        f"(sha256 {ranks[0]['digest'][:16]}); rows per rank "
        f"{[(r['place'], r['rows']) for r in ranks]}; {card}")
    for r, res in enumerate(ranks):
        col = res["exact"]["collectives"]
        bcol = res["bf16"][-1]["collectives"]
        log(f"[mesh2d] {layout} rank {r} {res['place']}: per step, calls and bytes, fp32 "
            f"all_gather {col['all_gather']}, all_reduce {col['all_reduce']}, broadcast "
            f"{col['broadcast']}; bf16 all_gather {bcol['all_gather']}, all_reduce "
            f"{bcol['all_reduce']}, broadcast {bcol['broadcast']}; launches per step K1 "
            f"{want[0]} K2 {want[1]} K2-bwd {want[2]}; peak GiB 2-D bf16 {res['peak_2d']:.3f} "
            f"against the 1-D mode's {res['peak_1d']:.3f} on the same ranks and rows per rank; "
            f"bf16 losses {[round(s['loss'], 5) for s in res['bf16']]}, ms "
            f"{[round(s['ms'], 2) for s in res['bf16']]} (not a speed figure: one sample); {card}")
    log(f"[mesh2d] {layout}: phase {seconds:.2f} s with the ranks' start; {card}")
    return totals


# the synthetic face anti-spoofing tree of [engine-ocim]: the four OCIM
# domains as config_template/ocim/data_m.yml names them, each a FrameStore of
# 480x360 frames under the reference's _crop keys and two 5-point lists
OCIM_DOMAINS = ("Oulu_NPU", "CASIA_database", "replayattack", "MSU-MFSD")
OCIM_FRAME = (360, 480)  # (H, W)


def _write_fas(root: str, videos: int = 3, frames: int = 8) -> int:
    """Per domain and label, ``videos`` videos of ``frames`` q95 4:2:0 JPEG
    frames of seeded noise, written by the port's encoder into
    ``<root>/lmdb/<domain>.udb``; each frame's face box (x, y, w, h) about
    200^2 at a seeded position, every third frame's within 40 px of an edge,
    so that margins up to 0.5 cross the frame and its crop is clamped.
    Returns the number of frames written."""
    import numpy as np
    import torch

    from unidefense_torch.data import native
    from unidefense_torch.data.store import FrameStoreWriter

    rng = np.random.default_rng(SEED + 30)
    h, w = OCIM_FRAME
    count = 0
    for dom in OCIM_DOMAINS:
        os.makedirs(os.path.join(root, dom, "lists"))
        with FrameStoreWriter(os.path.join(root, "lmdb", f"{dom}.udb")) as store:
            for label in ("real", "fake"):
                items = []
                for v in range(videos):
                    for f in range(frames):
                        rel = f"{dom}/{label}/video_{v}/{f:04d}.jpg"
                        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        store.add(rel.replace(dom, f"{dom}_crop"), native.encode_jpeg(frame, 95))
                        bw, bh = (int(x) for x in rng.integers(180, 221, 2))
                        if (v * frames + f) % 3 == 0:  # within 40 px of an edge
                            x = int(rng.choice([rng.integers(0, 41), w - bw - rng.integers(0, 41)]))
                            y = int(rng.choice([rng.integers(0, 41), h - bh - rng.integers(0, 41)]))
                        else:
                            x = int(rng.integers(41, w - bw - 40))
                            y = int(rng.integers(41, h - bh - 40))
                        items.append(f"{rel} 0 {x} {y} {bw} {bh}")
                        count += 1
                torch.save(items, os.path.join(root, dom, "lists", f"{label}_5points.pickle"))
    return count


def _cubic_against_torch(card: str) -> str:
    """The host library's bicubic crop-and-resize (the RandomResizedCrop
    path) against its plain version, torch's bicubic on the card machine's
    CPU over the frame the library decodes, within 1 level: crops of a
    480x360 q95 noise frame that scale up and down to 256^2, one touching
    the frame's corner, one that the frame clamps; and ``jpeg_dims`` against
    Pillow's reading of the headers and the decoded sizes."""
    import io

    import numpy as np
    from PIL import Image

    from unidefense_torch.data import native
    from unidefense_torch.data.native import INTER_CUBIC
    from unidefense_torch.data.transforms import resize_plain

    rng = np.random.default_rng(SEED + 31)
    sizes = [(360, 480), (251, 317), (97, 120), (33, 601)]
    blobs = []
    for h, w in sizes:
        out = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(out, "JPEG",
                                                                             quality=95)
        blobs.append(out.getvalue())
    dims = native.jpeg_dims(blobs)
    pil = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB")).astype(np.int32) for b in blobs]
    if not dims.tolist() == [list(s) for s in sizes] == [list(p.shape[:2]) for p in pil]:
        raise AssertionError(f"[jpeg] jpeg_dims {dims.tolist()}, Pillow "
                             f"{[p.shape[:2] for p in pil]}, sizes {sizes}")
    for b, (h, w), ref in zip(blobs, dims.tolist(), pil):
        # decoded at its header's size the frame is not resized: it is
        # Pillow's decode within the IDCT's rounding ([jpeg] above)
        d = np.abs(native.decode_batch([b], None, h, w)[0] - ref)
        if not d.max() <= 4:
            raise AssertionError(f"[jpeg] {h}x{w} decoded at its header's size is {d.max()} "
                                 "levels off Pillow's decode")
    h, w = sizes[0]
    whole = native.decode_batch(blobs[:1], None, h, w)[0]
    boxes = {"97x120 up": (200, 150, 320, 247), "300x260 down": (90, 50, 390, 310),
             "whole 480x360 down": (0, 0, 480, 360), "40x50 up, the corner": (440, 310, 480, 360),
             "clamped 230x210": (-30, 150, 200, 400)}
    parts = []
    for what, (x1, y1, x2, y2) in boxes.items():
        got = native.decode_batch(blobs[:1], np.asarray([(x1, y1, x2, y2)], np.int32), 256, 256,
                                  interp=INTER_CUBIC)[0].astype(np.int32)
        src = whole[max(0, y1):min(h, y2), max(0, x1):min(w, x2)]
        d = np.abs(got - resize_plain(src[None], 256, 256, INTER_CUBIC)[0])
        if not d.max() <= 1:
            raise AssertionError(f"[jpeg] bicubic {what}: max {int(d.max())} levels off torch's")
        parts.append(f"{what} max {int(d.max())} mean {float(d.mean()):.2e}")
    return (f"bicubic crop+resize to 256^2 against torch bicubic (tol max 1): {'; '.join(parts)}; "
            f"jpeg_dims equal Pillow's sizes at {sizes}, each frame decoded at them within 4 "
            "levels of Pillow's")


def phase_engine_ocim(card: str, weights: dict) -> tuple:
    """``python -m unidefense_torch.main --engine OCIM`` in process: UDR18 at
    256^2, three source domains (O, C, I) x 10 real + 10 fake = b30+30,
    bf16, AdamW amsgrad (model_udr18.yml, data_m.yml), RandomResizedCrop
    with the bicubic resize, 4p face crops with a margin drawn per batch
    from (0.0, 0.5), on a synthetic FAS tree of FrameStores. Trains 6 steps
    (validation on M at 3 and 6, b64, margin 0.3, video-level EER), tests
    from the best checkpoint (b96), resumes to step 9. Checks as
    [engine-fe], with launches per train step K1 1, K2 32, K2-bwd 16 and per
    eval batch K1 1, K2 8. Its ``extractor_weights``: a torchvision-format
    ResNet-18 file of the seeded backbone (``weights``), whose ``layer4``
    and ``fc`` go unused; the log must show it loaded. Returns the launch
    totals over the three runs."""
    import shutil
    import tempfile

    import torch

    from unidefense_torch.data.datasets import OCIMSubDataset
    from unidefense_torch.engines.ocim import OCIMEngine

    per_k2, _ = per_forward_launches("UDR18", 256, frozenset())
    runs = EngineRuns("engine-ocim", "OCIM", OCIMSubDataset, OCIMEngine,
                      (1, 4 * per_k2, 2 * per_k2, 0, 0), (1, per_k2, 0, 0, 0))
    root = tempfile.mkdtemp(prefix="ud_engine_ocim_")
    try:
        tree = os.path.join(root, "fas")
        t0 = time.perf_counter()
        n_frames = _write_fas(tree)
        note = _cubic_against_torch(card)
        log(f"[jpeg] {n_frames} noise frames {OCIM_FRAME[1]}x{OCIM_FRAME[0]} q95 written by the "
            f"port's encoder into 4 FrameStores in {time.perf_counter() - t0:.2f} s; {note}; "
            f"{card}")
        # test_fpv 6 of each video's 8 frames: the validation and test splits
        # resample, 36 frames each
        backbone = os.path.join(root, "resnet18.pth")
        torch.save(published_backbone(weights, "UDR18"), backbone)
        runs.run(root, *_engine_configs(root, "UDR18", f"chip-smoke-{os.getpid()}",
                                        model_keys={"extractor_weights": backbone}, root=tree,
                                        log_steps=1, val_steps=3, test_fpv=6))
        losses, aucs, scored = runs.check(root, n_iters=9, eval_lines=4)
        with open(os.path.join(root, runs.runs[0][0].run_dir, "records.txt")) as f:
            if f"Loaded pretrained extractor weights from {backbone}." not in f.read():
                raise AssertionError("[engine-ocim] no 'Loaded pretrained extractor weights' line")
        if not (all("EER" in ln and "HTER" in ln for ln in scored) and "APCER" in scored[-1]):
            raise AssertionError(f"[engine-ocim] Eval Step / Test lines {scored}")
        trained, tested, again = (x[0] for x in runs.runs)
        bs = trained.data_cfg["train_batch_size"]
        n_streams = len(trained.batchers)
        r = runs.rates(n_streams * bs)
        val_loads = [s * 1e3 for n, s in runs.loads if n == trained.val_batch_size]
        test_loads = [s * 1e3 for n, s in runs.loads if n == tested.test_batch_size]
        val_ms = [s * 1e3 / b for b, s in runs.evals]
        log(f"[engine-ocim] python -m unidefense_torch.main --engine OCIM: UDR18 256^2 "
            f"b{n_streams // 2 * bs}+{n_streams // 2 * bs} ({n_streams} streams of {bs}) bf16 "
            f"on {trained.device}, {trained.state.step} steps + test + resume to "
            f"{again.state.step}: steps 2-6, each between two synchronises, data waits "
            f"excluded: {r['step_rate']:.2f} img/s, p50 {statistics.median(r['step_ms']):.2f} ms "
            f"per step ({[round(t, 2) for t in r['step_ms']]}); the loop, data waits included: "
            f"{r['loop_rate']:.2f} img/s ({[round(t, 2) for t in r['loop_ms']]} ms between step "
            f"starts) beside [train-udr18] {TRAIN_READINGS.get('train-udr18', {}).get('rate', float('nan')):.2f} "
            f"img/s for the bare step at b10+10; plan p50 "
            f"{statistics.median(runs.selects) * 1e3:.2f} ms per step on the consumer thread "
            f"(the {n_streams} streams' selections, margins and RandomResizedCrop draws, "
            f"FrameStore reads and header sizes; {len(runs.selects)} steps); host decode p50 "
            f"{statistics.median(runs.batches) * 1e3:.2f} ms per step ({n_streams} {bs}-frame stream "
            f"loads on the prefetch threads: 4p crop, RandomResizedCrop, bicubic 480x360 crops "
            f"-> 256^2; {len(runs.batches)} steps), "
            f"{statistics.median(val_loads):.2f} ms per b64 validation batch, "
            f"{statistics.median(test_loads):.2f} ms per b96 test batch (bilinear); validation "
            f"and test {[round(v, 2) for v in val_ms]} ms per batch with its decode; peak memory "
            f"{runs.peak:.3f} GiB; runs {[round(x[1], 2) for x in runs.runs]} s; {card}")
        log(f"[engine-ocim] launches per train step K1 1 K2 {4 * per_k2} K2-bwd {2 * per_k2} and "
            f"per eval batch K1 1 K2 {per_k2} over {len(runs.steps)} steps and "
            f"{sum(b for b, _ in runs.evals)} eval batches (totals {runs.totals}); losses "
            f"{losses}; AUC {aucs}; extractor_weights {os.path.basename(backbone)} (torchvision "
            f"naming, its layer4 and fc unused) loaded; ckpt/best and ckpt/latest written; "
            f"resumed from step 6 to 9; {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs.totals


# the synthetic UniAttack tree of [engine-ue]: the six sub-datasets as
# config_template/uniatt/Prot1/data_ffpp.yml names them, each a FrameStore of
# frames at its own (H, W) under the keys its loader reads with crop nocrop
# (JPEG, and PNG for Celeb-DF as the reference lays it out), and its index
# files
UA_FRAMES = {"FFpp": (320, 320), "CDF": (320, 320), "SeqDF": (256, 256), "HQ": (300, 260),
             "OULU": (400, 320), "SiWMv2": (360, 300)}
UA_STORES = {"FFpp": "FaceForensics++", "CDF": "Celeb-DF", "SeqDF": "Seq-DeepFake",
             "HQ": "HQ_WMCA", "OULU": "Oulu_NPU", "SiWMv2": "SiW-Mv2"}
UA_HQ_ATTACKS = ("Flexiblemask", "Glasses", "Makeup", "Mannequin", "Papermask", "Replay",
                 "Rigidmask", "Tattoo")


def _write_uniattack(root: str, videos: int = 4, frames: int = 8) -> dict:
    """The six sub-datasets under ``root`` of seeded noise frames: FF++ (real
    and four methods, ``videos`` videos each, every split; q95 4:2:0 JPEG
    by the port's encoder) and Celeb-DF (two real and two synthesis videos;
    PNG by Pillow, under ``.png`` paths) of 320^2 frames under their paths;
    Seq-DeepFake, HQ-WMCA (bona fide and the eight attacks, half-length
    videos), Oulu-NPU and SiW-Mv2 training frames of four other sizes, JPEG,
    under their ``_crop`` keys. Returns the data YAML's root keys."""
    import io

    import numpy as np
    import torch
    from PIL import Image

    from unidefense_torch.data import native
    from unidefense_torch.data.store import FrameStoreWriter

    rng = np.random.default_rng(SEED + 40)
    roots = {k: os.path.join(root, k) for k in UA_FRAMES}
    writers = {}
    for sub, store in UA_STORES.items():
        os.makedirs(os.path.join(roots[sub], "lmdb"))
        writers[sub] = FrameStoreWriter(os.path.join(roots[sub], "lmdb", f"{store}.udb"))

    def dump(obj, sub, *parts):
        path = os.path.join(roots[sub], *parts)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(obj, path)

    def video(sub, pattern, key=lambda rel: rel, n=frames):
        out = []
        for f in range(n):
            rel = pattern.format(f=f)
            frame = rng.integers(0, 256, (*UA_FRAMES[sub], 3), dtype=np.uint8)
            if rel.endswith(".png"):  # zlib level 1, cv2.imwrite's default
                buf = io.BytesIO()
                Image.fromarray(frame).save(buf, format="PNG", compress_level=1)
                writers[sub].add(key(rel), buf.getvalue())
            else:
                writers[sub].add(key(rel), native.encode_jpeg(frame, 95))
            out.append(rel)
        return out

    ffpp = []
    for method in ("original_sequences/youtube", "manipulated_sequences/Deepfakes",
                   "manipulated_sequences/Face2Face", "manipulated_sequences/FaceSwap",
                   "manipulated_sequences/NeuralTextures"):
        label = int(method.startswith("manipulated"))
        for v in range(videos):
            pattern = f"{method}/c23/images/{v:03d}/{{f:04d}}.jpg"
            ffpp += [(p, label) for p in video("FFpp", pattern)]
    cdf = []
    for pattern in ("Celeb-real/images/id0_0000", "YouTube-real/images/00000",
                    "Celeb-synthesis/images/id0_id1_0000", "Celeb-synthesis/images/id2_id3_0001"):
        cdf += video("CDF", pattern + "/{f}.png")
    for split in ("train", "val", "test"):
        dump(ffpp, "FFpp", "pickle_files", f"{split}_c23.pickle")
        dump(cdf, "CDF", "pickle_files", f"{split}.pickle")

    def suffixed(rel):
        return rel[:-4] + "_crop.jpg"

    for label in ("real", "fake"):
        dump(video("SeqDF", f"Seq-DeepFake/{label}/v0/{{f}}.jpg", suffixed), "SeqDF",
             "pickle_files", f"train_{label}.pickle")
        dump(video("OULU", f"Oulu_NPU/Train_files/{label}_v0/{{f}}.jpg",
                   lambda rel: rel.replace("Oulu_NPU", "Oulu_NPU_crop")),
             "OULU", "lists", f"{label}_5points.pickle")
    for label, kind in (("live", "live"), ("all", "spoof")):
        dump(video("SiWMv2", f"SiW-Mv2/{kind}_v0/{{f}}.jpg", suffixed), "SiWMv2", "lists",
             f"trainlist_{label}.pickle")
    record, rows = {}, []
    for kind in ("bonafide",) + UA_HQ_ATTACKS:
        record[kind] = video("HQ", f"HQ_WMCA/{kind}/{{f}}.jpg", suffixed, n=frames // 2)
        rows.append(f"s/{kind},0,bonafide,x,train" if kind == "bonafide"
                    else f"s/{kind},1,attack/{kind},x,train")
    dump(record, "HQ", "record.pickle")
    with open(os.path.join(roots["HQ"], "PROTOCOL-grand_test-curated.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    for w in writers.values():
        w.close()
    return {"root": root, **{f"{k}_root": v for k, v in roots.items()}}


def _image_compression_against_pillow(card: str) -> str:
    """ImageCompression's round trip (the port's encoder, then its decoder)
    against Pillow's (libjpeg-turbo: ``save(quality=q, subsampling=2)``,
    then its decode) at the qualities of the Protocol I OneOf's ends and
    middle, 50, 55 and 60, on a 380^2 frame of smoothed noise: each
    encoder's quantisation tables read from its bytes and held against
    IJG's tables scaled to q (libjpeg's ``jpeg_set_quality``), and the
    round trips' max and mean difference held within UA_JPEG_TOL."""
    import io

    import numpy as np
    from PIL import Image

    from unidefense_torch.data import native
    from unidefense_torch.data.transforms import blur_u8

    def pillow(b):
        return np.asarray(Image.open(io.BytesIO(b)).convert("RGB")).astype(np.int32)

    rng = np.random.default_rng(SEED + 41)
    yy, xx = np.mgrid[0:380, 0:380]
    ramp = np.stack([xx * 0.5, yy * 0.4, (xx + yy) * 0.25], -1)
    frame = blur_u8(rng.integers(0, 256, (1, 380, 380, 3), dtype=np.uint8), 9)[0]
    frame = np.clip(frame * 0.5 + ramp, 0, 255).astype(np.uint8)
    parts = []
    for q in (50, 55, 60):
        blob = native.encode_jpeg(frame, q)
        ours = native.decode_batch([blob], None, 380, 380)[0].astype(np.int32)
        out = io.BytesIO()
        Image.fromarray(frame).save(out, "JPEG", quality=q, subsampling=2)
        ref = pillow(out.getvalue())
        want = ijg_tables(q)
        for who, b in (("port", blob), ("Pillow", out.getvalue())):
            tables = dqt_tables(b)
            if tables[:2] != want:
                raise AssertionError(f"[jpeg] q{q}: the {who} encoder's quantisation tables are "
                                     f"not IJG's at quality {q}: {tables} vs {want}")
        d = np.abs(ours - ref)
        # the gap split: both blobs through Pillow's decoder (the encoders
        # alone), Pillow's blob through both decoders (the decoders alone)
        enc = np.abs(pillow(blob) - ref)
        dec = np.abs(native.decode_batch([out.getvalue()], None, 380, 380)[0] - ref)
        parts.append(f"q{q} max {int(d.max())} mean {float(d.mean()):.4f} (the encoders alone "
                     f"max {int(enc.max())} mean {float(enc.mean()):.4f}, the decoders alone max "
                     f"{int(dec.max())} mean {float(dec.mean()):.4f}; from the source: port "
                     f"{float(np.abs(ours - frame).mean()):.4f}, Pillow "
                     f"{float(np.abs(ref - frame).mean()):.4f})")
        if not (d.max() <= UA_JPEG_TOL[0] and d.mean() <= UA_JPEG_TOL[1]):
            raise AssertionError(f"[jpeg] ImageCompression q{q}: the port's round trip is off "
                                 f"Pillow's by max {int(d.max())}, mean {float(d.mean())} "
                                 f"(tol {UA_JPEG_TOL})")
    return (f"ImageCompression round trip ({native.backend()}) against Pillow's at q 50/55/60, "
            f"380^2 4:2:0, tol max {UA_JPEG_TOL[0]} mean {UA_JPEG_TOL[1]}: {'; '.join(parts)}; "
            "both encoders' luma and chroma tables are IJG's at each q")


# max and mean |port - Pillow| of ImageCompression's round trip at q 50-60,
# set from the first run on the card of the encoder that takes libjpeg's
# planes: nvJPEG max 11, 9, 9 and mean 0.1812, 0.1609, 0.1685 at q 50, 55, 60
# (its own RGB conversion had given max 22, mean 1.93; PERF.md section 6);
# libjpeg 0 and 0
UA_JPEG_TOL = (14, 0.25)

# IJG's (JPEG Annex K) luma and chroma quantisation tables in natural order
_IJG_LUMA = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40,
             57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35,
             55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
             100, 103, 99)
_IJG_CHROMA = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99,
               99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99) + (99,) * 32
_ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
           27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
           44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)


def ijg_tables(q: int) -> list:
    """libjpeg's ``jpeg_set_quality(q, force_baseline=TRUE)``: the Annex K
    tables scaled by 5000/q (q < 50) or 200 - 2q, rounded, clamped to
    1..255; luma then chroma, natural order."""
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return [tuple(min(255, max(1, (v * scale + 50) // 100)) for v in base)
            for base in (_IJG_LUMA, _IJG_CHROMA)]


def dqt_tables(blob: bytes) -> list:
    """The quantisation tables of a JPEG's DQT segments, in table-id order,
    natural order (the bitstream stores them zigzag)."""
    tables, i = {}, 2
    while i + 4 <= len(blob) and blob[i] == 0xFF:
        marker, length = blob[i + 1], int.from_bytes(blob[i + 2:i + 4], "big")
        if marker == 0xDA:  # start of scan: no table after it
            break
        if marker == 0xDB:
            j = i + 4
            while j < i + 2 + length:
                precision, tid = blob[j] >> 4, blob[j] & 15
                size = 128 if precision else 64
                raw = blob[j + 1:j + 1 + size]
                vals = ([int.from_bytes(raw[2 * k:2 * k + 2], "big") for k in range(64)]
                        if precision else list(raw))
                natural = [0] * 64
                for k, z in enumerate(_ZIGZAG):
                    natural[z] = vals[k]
                tables[tid] = tuple(natural)
                j += 1 + size
        i += 2 + length
    return [tables[t] for t in sorted(tables)]


def _host_blur_against_float64(card: str) -> str:
    """The distorted OneOf's blur on the host (``transforms.blur_u8``: torch
    on the CPU, the function tests/test_torch_uniattack.py holds within 1
    level of cv2.GaussianBlur) on the card machine, against its plain
    definition run in the same process: a separable float64 numpy
    convolution of cv2's sigma with BORDER_REFLECT_101, rounded; within 1
    level at k 9 and 11 on a 380^2 noise frame."""
    import numpy as np

    from unidefense_torch.data.transforms import blur_u8

    frame = np.random.default_rng(SEED + 42).integers(0, 256, (380, 380, 3), dtype=np.uint8)
    parts = []
    for k in (9, 11):
        sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
        xs = np.arange(k) - (k - 1) / 2
        w = np.exp(-xs ** 2 / (2 * sigma ** 2))
        w /= w.sum()
        p = k // 2
        x = np.pad(frame.astype(np.float64), ((p, p), (p, p), (0, 0)), mode="reflect")
        x = sum(w[i] * x[i:i + 380] for i in range(k))
        x = sum(w[i] * x[:, i:i + 380] for i in range(k))
        ref = np.clip(np.round(x), 0, 255)
        d = np.abs(blur_u8(frame[None], k)[0] - ref)
        if not d.max() <= 1:
            raise AssertionError(f"[jpeg] host blur k{k}: {d.max()} levels off float64")
        parts.append(f"k{k} max {int(d.max())} mean {float(d.mean()):.4f}")
    return ("the OneOf's host blur (transforms.blur_u8, torch on the host) against a float64 "
            f"separable reflect-101 blur, tol max 1: {'; '.join(parts)}")


def _png_against_pillow(card: str) -> str:
    """The host library's PNG decoder (Celeb-DF's frames; code of its own on
    both builds) against Pillow's, bit for bit: 320^2 smoothed noise saved
    by Pillow in its RGB, RGBA, L, LA and P modes, plain and optimised,
    with ``jpeg_dims`` their sizes; a PNG of a JPEG's decode cropped and
    resized to 380^2 (bilinear and bicubic) in a batch that mixes both
    formats, equal to the JPEG's; a damaged PNG raises IOError. Times the
    decode of 16 RGB PNGs in one call."""
    import io

    import numpy as np
    from PIL import Image

    from unidefense_torch.data import native

    rng = np.random.default_rng(SEED + 43)
    noise = rng.integers(0, 256, (322, 322, 3)).astype(np.float64)
    frame = ((noise[:-2, :-2] + noise[1:-1, 1:-1] + noise[2:, 2:]) / 3).astype(np.uint8)
    parts = []
    for mode in ("RGB", "RGBA", "L", "LA", "P"):
        for optimize in (False, True):
            buf = io.BytesIO()
            Image.fromarray(frame).convert(mode).save(buf, format="PNG", optimize=optimize)
            blob = buf.getvalue()
            want = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
            got = native.decode_batch([blob], None, 320, 320)[0]
            if not (np.array_equal(got, want) and native.jpeg_dims([blob]).tolist() == [[320, 320]]):
                raise AssertionError(f"[jpeg] PNG {mode} (optimize {optimize}): "
                                     f"{int(np.abs(got.astype(int) - want).max())} levels off "
                                     f"Pillow, size {native.jpeg_dims([blob]).tolist()}")
        parts.append(mode)
    jpeg = native.encode_jpeg(frame, 95)
    buf = io.BytesIO()
    Image.fromarray(native.decode_batch([jpeg], None, 320, 320)[0]).save(buf, format="PNG")
    png = buf.getvalue()
    boxes = np.asarray([[11, 23, 301, 290], [-9, -9, 400, 400]], np.int32)
    for interp in (native.INTER_LINEAR, native.INTER_CUBIC):
        want = native.decode_batch([jpeg, jpeg], boxes, 380, 380, interp=interp)
        got = native.decode_batch([png, jpeg], boxes, 380, 380, interp=interp)
        if not np.array_equal(got, want):
            raise AssertionError(f"[jpeg] PNG crop+resize (interp {interp}) differs from its "
                                 f"JPEG twin's by {int(np.abs(got.astype(int) - want).max())}")
    broken = bytearray(png)
    broken[len(png) // 2] ^= 0xFF
    try:
        native.decode_batch([png, bytes(broken)], None, 320, 320)
    except IOError:
        pass
    else:
        raise AssertionError("[jpeg] a damaged PNG gave no IOError")
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    batch = [buf.getvalue()] * 16
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        native.decode_batch(batch, None, 320, 320)
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    return (f"PNG decode (host, {native.backend()} build) bit for bit Pillow's in modes "
            f"{'/'.join(parts)}, plain and optimised, 320^2, sizes from the header; a PNG crop+"
            f"resize to 380^2 equal to its JPEG twin's in a mixed batch, bilinear and bicubic; a "
            f"damaged PNG raises IOError; 16 RGB PNGs of {len(batch[0])} bytes in one call, "
            f"median of 5 on the host's clock {ms:.2f} ms")


def phase_corrupt(card: str) -> None:
    """The device corruption route (``DevicePipeline(corrupt=True)``: /255,
    the per-sample OneOf of blur 9/11, noise, contrast and saturation, the
    flip, mean/std; plain torch ops, no K1, as the JAX stage runs no Pallas
    kernel there) on the card against the same call on the CPU, with the
    same draws passed in (every branch and both blur sizes), on a b8 380^2
    batch, fp32 output: within 1e-5. Times both."""
    import torch

    from unidefense_torch.data.transforms import CorruptDraws, DevicePipeline
    from unidefense_torch.ops.preprocess import normalize_flip

    gen = torch.Generator().manual_seed(SEED + 43)
    shape = (8, 380, 380, 3)
    x = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    draws = CorruptDraws.draw(shape, gen)
    draws.branch = torch.arange(8) % 4
    draws.k11 = torch.arange(8) % 8 < 4
    flip = torch.rand(8, generator=gen) < 0.5
    stage = DevicePipeline(mean=K1_MEAN, std=K1_STD, hflip_p=0.5, corrupt=True)
    t0 = time.perf_counter()
    ref = stage(x, flip_mask=flip, draws=draws)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    cuda = CorruptDraws(*(t.cuda() for t in (draws.branch, draws.u, draws.k11, draws.noise)))
    xc, fc = x.cuda(), flip.cuda()
    counts = normalize_flip.launches
    got = stage(xc, flip_mask=fc, draws=cuda)
    if normalize_flip.launches != counts:
        raise AssertionError("[corrupt] the corruption route launched K1")
    err = float((got.cpu() - ref).abs().max())
    if not (got.is_cuda and err <= 1e-5):
        raise AssertionError(f"[corrupt] card vs CPU max |err| {err} (tol 1e-5)")
    ms = time_ms(lambda: stage(xc, flip_mask=fc, draws=cuda))
    log(f"[corrupt] DevicePipeline(corrupt=True) b8 380^2 u8 -> fp32, branches blur9/11, noise, "
        f"contrast, saturation x2, flip: card vs CPU with the same draws max |err| {err:.3g} "
        f"(tol 1e-5); {ms:.3f} ms on the card, {cpu_ms:.1f} ms on the CPU; no K1 launch; {card}")


def _unpadded(eval_step):
    """``eval_step`` over the rows of a batch before its trailing copies of
    the last row, the probabilities of the copies repeated."""
    import torch

    def run(x, *args):
        k = x.shape[0]
        while k > 1 and torch.equal(x[k - 2], x[-1]):
            k -= 1
        probs, cls_out, rec = eval_step(x[:k], *args)
        return torch.cat([probs, probs[-1:].expand(x.shape[0] - k)]), cls_out, rec
    return run


UE_EVAL_TOL = 2e-2  # a probability, bf16 on the card against fp32: [parity]'s bound


def _ue_eval_against_cpu(root: str, model_path: str, data_path: str, weights: dict,
                         card: str) -> str:
    """The UE engine's validation on the card against the same on the CPU:
    the Test-stage engine of the distorted config (its best checkpoint
    restored), with the validation batch of training (b64), scores val-real
    and val-fake, takes their frame EER threshold and applies it to the test
    split (b96, the host OneOf): ``_val_threshold`` then ``_test_metrics``,
    as ``validate`` runs them. The card runs bf16 through K1 and K2 (its
    launches checked per eval batch), the CPU fp32 through the plain
    versions, each engine decoding its own batches: ``score_dataset`` makes
    every draw of the OneOf on its calling thread in batch order, so the
    two engines' uint8 batches must be equal, and are checked to be. The
    same weights in both: the checkpoint's, which 3 steps from random init
    leave with eval-mode BatchNorm statistics that tie every probability
    (threshold inf), are replaced in both by ``weights`` (``seeded_weights``'
    calibrated ones). The CPU scores only the rows of each batch that are
    not padding (``score_dataset`` pads with copies of the last frame, and
    each frame is scored on its own in eval mode). Every frame's
    probability within UE_EVAL_TOL, the threshold finite and within
    UE_EVAL_TOL, the probabilities spread."""
    import numpy as np
    import torch

    from unidefense_torch.config import load_config
    from unidefense_torch.data.datasets import UniAttack
    from unidefense_torch.engines import base
    from unidefense_torch.engines.uniattack import UniAttackEngine

    per_k2, _ = per_forward_launches("UDEB4", 380, frozenset())
    score_dataset, finish_item = base.AbstractEngine.score_dataset, UniAttack.finish_item
    batches, probs, runs, now = {"cuda": {}, "cpu": {}}, {}, {}, {}

    def scored(engine, dataset, batch_size, *args, **kwargs):
        got = score_dataset(engine, dataset, batch_size, *args, **kwargs)
        probs.setdefault(now["device"], []).extend(p for v in got[0].values() for p in v)
        runs[now["device"]][1] += -(-len(dataset) // batch_size)
        return got

    def recorded(ds, plan):
        out = finish_item(ds, plan)
        batches[now["device"]][(ds.split, tuple(plan["path"]))] = out["images"].copy()
        return out

    cwd, stdout = os.getcwd(), sys.stdout
    try:
        os.chdir(root)
        base.AbstractEngine.score_dataset, UniAttack.finish_item = scored, recorded
        for device in ("cuda", "cpu"):
            config = load_config(model_path, engine="UE", ds_config=data_path)
            config["config"]["offline"] = True
            if device == "cpu":
                config["config"]["precision"] = "fp32"
            engine = UniAttackEngine(config, stage="Test", device=device)
            now["device"] = device
            engine.state.model.load_state_dict(weights)
            engine.val_batch_size = config["data"]["val_batch_size"]
            if device == "cpu":
                engine.eval_step = _unpadded(engine.eval_step)
            runs[device] = [None, 0, time.perf_counter()]
            _reset_counts()
            val = engine._val_threshold(-1)
            video, frame = engine._test_metrics(-1, val["Thre"])
            runs[device][0] = (val, video, frame, _route_counts(),
                               time.perf_counter() - runs[device][2])
            sys.stdout = stdout
            del engine
    finally:
        base.AbstractEngine.score_dataset, UniAttack.finish_item = score_dataset, finish_item
        sys.stdout = stdout
        os.chdir(cwd)
    same = batches["cuda"].keys() == batches["cpu"].keys() and all(
        np.array_equal(v, batches["cpu"][k]) for k, v in batches["cuda"].items())
    if not same:
        raise AssertionError(f"[engine-ue] the card's and the CPU's engines decoded different "
                             f"batches ({len(batches['cuda'])} and {len(batches['cpu'])})")
    (val, video, frame, counts, gpu_s), n_batches = runs["cuda"][0], runs["cuda"][1]
    (c_val, c_video, c_frame, _, cpu_s) = runs["cpu"][0]
    want = (n_batches, n_batches * per_k2, 0, 0, 0)
    if counts != want:
        raise AssertionError(f"[engine-ue] card validation: launches {counts}, expected {want}")
    gpu, cpu = np.asarray(probs["cuda"]), np.asarray(probs["cpu"])
    d = float(np.abs(gpu - cpu).max()) if gpu.shape == cpu.shape else float("inf")
    thr, c_thr = val["Thre"], c_val["Thre"]
    if not (d <= UE_EVAL_TOL and np.isfinite(thr) and np.isfinite(c_thr)
            and abs(thr - c_thr) <= UE_EVAL_TOL and np.ptp(cpu) > 10 * UE_EVAL_TOL):
        raise AssertionError(f"[engine-ue] card vs CPU validation: {gpu.shape} vs {cpu.shape} "
                             f"probabilities, max |dprob| {d}, thresholds {thr} and {c_thr}, "
                             f"spread {np.ptp(cpu)} (tol {UE_EVAL_TOL})")
    return (f"validation as training runs it (val b64, its EER threshold on the distorted test "
            f"split b96), card bf16 vs CPU fp32 from the same calibrated weights, each engine "
            f"decoding its own {len(batches['cuda'])} batches, all equal (no replay), "
            f"{len(gpu)} frames in {n_batches} card batches (launches {counts[:2]}): max |dprob| "
            f"{d:.3g} (tol {UE_EVAL_TOL}), probabilities {float(cpu.min()):.4f}-"
            f"{float(cpu.max()):.4f}; threshold {thr:.6f} vs {c_thr:.6f}; val AUC "
            f"{val['AUC']:.4f} vs {c_val['AUC']:.4f}; test frame ACER {frame['ACER']:.4f} vs "
            f"{c_frame['ACER']:.4f}, AUC {frame['AUC']:.4f} vs {c_frame['AUC']:.4f}; video ACER "
            f"{video['ACER']:.4f} vs {c_video['ACER']:.4f}, AUC {video['AUC']:.4f} vs "
            f"{c_video['AUC']:.4f}; {gpu_s:.2f} s on the card, {cpu_s:.2f} s on the CPU")


def phase_engine_ue(card: str, weights: dict) -> tuple:
    """``python -m unidefense_torch.main --engine UE`` in process: UDEB4 at
    380^2, b10+10, bf16, AdamW amsgrad, StepLR, crop nocrop
    (config_template/uniatt/Prot1/model_udeb4.yml, data_ffpp.yml:
    RandomResizedCrop with the bicubic resize, 6 real and 16 fake methods
    over the six sub-datasets) on a synthetic UniAttack tree. Trains 6 steps
    (validation at 3 and 6: the frame EER threshold of val-real and
    val-fake at b64, the test split's video and frame metrics at it, b96),
    tests from the best checkpoint on the test split with ``distorted:
    true`` (the host OneOf on every b96 batch), resumes to step 9. Checks as
    [engine-fe], with launches per train step K1 1, K2 96, K2-bwd 48 and per
    eval batch K1 1, K2 24; times the host OneOf per test batch; holds the
    validation on the card against the CPU (:func:`_ue_eval_against_cpu`).
    Celeb-DF's frames are PNG. The runs' ``config.init_weights`` is a
    reference-format file of the seeded UDEB4 ``weights``; right after the
    first run's build its model must equal them. Returns the launch totals
    over the three runs."""
    import shutil
    import tempfile

    import torch
    import yaml

    from unidefense_torch.models.convert import save_torch_checkpoint
    from unidefense_torch.models.registry import build_model

    from unidefense_torch.data.datasets import UniAttack
    from unidefense_torch.data.transforms import HostPipeline
    from unidefense_torch.engines.uniattack import UniAttackEngine

    per_k2, _ = per_forward_launches("UDEB4", 380, frozenset())
    runs = EngineRuns("engine-ue", "UE", UniAttack, UniAttackEngine,
                      (1, 4 * per_k2, 2 * per_k2, 0, 0), (1, per_k2, 0, 0, 0))
    root = tempfile.mkdtemp(prefix="ud_engine_ue_")
    apply, oneof = HostPipeline.apply, []
    build, built = UniAttackEngine._build_training, []

    def checked_build(engine, *args, **kwargs):
        model = build(engine, *args, **kwargs)
        if not built:  # the first run's fresh build: the file's weights, before any step
            sd = engine.state.model.state_dict()
            built.append([k for k, v in weights.items() if not k.endswith("num_batches_tracked")
                          and not torch.equal(sd[k].cpu(), v)])
        return model

    def timed_apply(host, frames, draws):
        t0 = time.perf_counter()
        out = apply(host, frames, draws)
        if host.distorted_oneof:
            oneof.append((len(frames), time.perf_counter() - t0, [d[1][0] for d in draws]))
        return out

    try:
        t0 = time.perf_counter()
        tree = _write_uniattack(os.path.join(root, "uniattack"))
        written = time.perf_counter() - t0
        log(f"[jpeg] {_image_compression_against_pillow(card)}; "
            f"{_host_blur_against_float64(card)}; {_png_against_pillow(card)}; {card}")
        model_yml = "config_template/uniatt/Prot1/model_udeb4.yml"
        init = os.path.join(root, "init_udeb4.bin")
        net = build_model("UDEB4", model_spec("UDEB4")["model"])
        net.load_state_dict(weights, strict=True)
        save_torch_checkpoint(net, init)
        del net
        first, resumed = _engine_configs(root, "UDEB4", f"chip-smoke-{os.getpid()}",
                                         model_yml=model_yml, config_keys={"init_weights": init},
                                         log_steps=3, val_steps=3, **tree)
        with open(os.path.join(root, "data_6.yml")) as f:
            distorted = dict(yaml.safe_load(f), distorted=True)
        with open(os.path.join(root, "data_distorted.yml"), "w") as f:
            yaml.safe_dump(distorted, f)
        HostPipeline.apply, UniAttackEngine._build_training = timed_apply, checked_build
        try:
            runs.run(root, first, resumed,
                     test_argv=("--ds_config", os.path.join(root, "data_distorted.yml")))
        finally:
            HostPipeline.apply, UniAttackEngine._build_training = apply, build
        losses, aucs, scored = runs.check(root, n_iters=3, eval_lines=12)
        with open(os.path.join(root, runs.runs[0][0].run_dir, "records.txt")) as f:
            logged = f"Initialized full model weights from {init}." in f.read()
        if not (built and not built[0] and logged):
            raise AssertionError(f"[engine-ue] init_weights: logged {logged}, tensors off the "
                                 f"file after the build {built[0][:3] if built else None}")
        # its CPU side scores UDEB4 fp32 at 380^2 (1.4 s a frame on the card
        # machine's cores): 20 frames, one method of each label, one frame a
        # video but val-real's two
        with open(os.path.join(root, "data_parity.yml"), "w") as f:
            yaml.safe_dump(dict(distorted, val_fake_method=["FFpp-DF"],
                                test_method=["FFpp-Real", "FFpp-DF"], val_fake_fpv=1,
                                test_real_fpv=1, test_fake_fpv=1), f)
        parity = _ue_eval_against_cpu(root, first, os.path.join(root, "data_parity.yml"), weights,
                                      card)
        if not (sum("[Frame], ACER" in ln for ln in scored) == 4
                and sum(ln.startswith("Test Step") for ln in scored) == 8):
            raise AssertionError(f"[engine-ue] Eval Step / Test Step lines {scored}")
        trained, tested, again = (x[0] for x in runs.runs)
        if not (tested.test_set.host_tf.distorted_oneof and oneof
                and all(n == tested.test_batch_size for n, _, _ in oneof)):
            raise AssertionError(f"[engine-ue] the distorted test ran the host OneOf on "
                                 f"{[n for n, _, _ in oneof]} frames")
        branches = [b for _, _, bs in oneof for b in bs]
        bs = trained.data_cfg["train_batch_size"]
        r = runs.rates(2 * bs)
        # score_dataset calls in order: val-real, val-fake, test at steps 3
        # and 6, then the distorted test run's three, then step 9's three
        per_batch = [round(s * 1e3 / b, 2) for b, s in runs.evals]
        log(f"[engine-ue] python -m unidefense_torch.main --engine UE: UDEB4 380^2 b10+10 bf16 "
            f"(Prot1 model_udeb4.yml, data_ffpp.yml) on {trained.device}, {trained.state.step} "
            f"steps + distorted test + resume to {again.state.step}: steps 2-6, each between two "
            f"synchronises, data waits excluded: {r['step_rate']:.2f} img/s, p50 "
            f"{statistics.median(r['step_ms']):.2f} ms per step "
            f"({[round(t, 2) for t in r['step_ms']]}); the loop, data waits included: "
            f"{r['loop_rate']:.2f} img/s ({[round(t, 2) for t in r['loop_ms']]} ms between step "
            f"starts) beside [train] {TRAIN_READINGS.get('train', {}).get('rate', float('nan')):.2f} img/s for the "
            f"bare step; plan p50 {statistics.median(runs.selects) * 1e3:.2f} ms per step on the "
            f"consumer thread (two streams' selections and RandomResizedCrop draws, blob reads "
            f"and header sizes over six FrameStores; {len(runs.selects)} steps); host decode p50 "
            f"{statistics.median(runs.batches) * 1e3:.2f} ms per step (two {bs}-frame stream "
            f"loads on the prefetch threads: RandomResizedCrop, bicubic 256^2-400x320 -> 380^2; "
            f"{len(runs.batches)} steps); host OneOf "
            f"{[round(s * 1e3, 2) for _, s, _ in oneof]} ms per b96 test batch after its decode "
            f"(branches JPEG/blur/noise/contrast/saturation "
            f"{[branches.count(c) for c in range(5)]}); ms per eval batch with its decode: "
            f"validation b64 warm (val-real, val-fake at steps 6 and 9) "
            f"{per_batch[3:5] + per_batch[9:11]}, the first {per_batch[:2]}; test b96 at steps "
            f"3, 6, 9 {[per_batch[i] for i in (2, 5, 11)]}; the distorted test run "
            f"{per_batch[6:9]} (val-real, val-fake, test b96 with the OneOf); peak memory "
            f"{runs.peak:.3f} GiB; tree of {written:.2f} s; runs "
            f"{[round(x[1], 2) for x in runs.runs]} s; {card}")
        log(f"[engine-ue] launches per train step K1 1 K2 {4 * per_k2} K2-bwd {2 * per_k2} and "
            f"per eval batch K1 1 K2 {per_k2} over {len(runs.steps)} steps and "
            f"{sum(b for b, _ in runs.evals)} eval batches (totals {runs.totals}); losses "
            f"{losses}; AUC {aucs}; init_weights {os.path.basename(init)} (the seeded weights, "
            f"reference format) loaded, the model equal to it after the build; ckpt/best and "
            f"ckpt/latest written; resumed from step 6 to 9; {card}")
        log(f"[engine-ue] {parity}; {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs.totals


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
    weights = udeb4 = seeded_weights(card)
    phase_ckpt(card, weights, "UDEB4")
    served = phase_serve(card, weights)  # asserts its own K1, K2 and K3 launch counts
    phase_serve_int8(card, weights, served)
    phase_parity(card, weights)
    trained = {"train": phase_train(card, weights)}
    phase_serve(card, weights, "UDEB4", V4_WIDTHS[380], "serve-v4")
    phase_parity(card, weights, "UDEB4", V4_WIDTHS[380], "parity-v4")
    _, _, _, k3_launches, k3_bwd_launches = phase_train(card, weights, "UDEB4", V4_WIDTHS[380],
                                                        "train-v4")
    phase_train_parity(card, weights)  # [train-parity] and [train-parity-v4]
    fe_root = tempfile.mkdtemp(prefix="ud_engine_fe_")
    try:
        trained["engine-fe"] = phase_engine_fe(card, udeb4, fe_root)
        trained["engine-fe-dp"] = phase_engine_fe_dp(card, fe_root)
        phase_dp_cards(card, fe_root, udeb4)
    finally:
        shutil.rmtree(fe_root, ignore_errors=True)
    udr = {}
    for model in ("UDR18", "UDR50"):
        tag = model.lower()
        weights = udr[model] = seeded_weights(card, model)
        phase_ckpt(card, weights, model)
        phase_serve(card, weights, model, tag=f"serve-{tag}")
        phase_parity(card, weights, model, tag=f"parity-{tag}")
        trained[f"train-{tag}"] = phase_train(card, weights, model, tag=f"train-{tag}")
        phase_train_parity(card, weights, model, ((f"train-parity-{tag}", frozenset()),))
    trained["train-opt"] = phase_train_opt(card, udr["UDR18"])
    trained["train-remat"] = phase_train_remat(card, udeb4, udr["UDR18"])
    trained["learn"] = phase_learn(card)
    trained["dp-step"] = phase_dp_step(card, udr["UDR18"])
    trained["mesh2d"] = phase_mesh2d(card, udr["UDR18"])
    trained["engine-ocim"] = phase_engine_ocim(card, udr["UDR18"])
    trained["engine-ue"] = phase_engine_ue(card, udeb4)
    phase_corrupt(card)
    k4_launches, k4_bwd_launches = phase_bench(card)
    # K1, K2 and K2-bwd: the launches of the default-route training paths,
    # UDEB4's, UDR18's and UDR50's, 5 steps each, of [train-opt]'s 18 steps,
    # [train-remat]'s 5 and [learn]'s run, of the engines' runs (their steps
    # and eval batches: FE's five, OCIM's and UE's three), and of the
    # data-parallel paths on both ranks ([dp-step]'s 3 steps,
    # [engine-fe-dp]'s run), and of the 2-D mode's steps ([mesh2d]'s 1x1
    # leg, and its ranks' where the host has two cards or more)
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
