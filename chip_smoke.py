#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --quick    # build, then run and check each kernel once

Phases: build the CUDA kernels from ``unidefense_torch/csrc``; hold K1
(normalize_flip), K2 (sfconv_freq forward) and K2-bwd (its weight sums,
with K2 on the gradient for x_bar) against their plain PyTorch versions on
the card at the shapes the serving and training paths give them, timing
each; serve UDEB4 at 380x380, batch 32, bf16 through ``Predictor`` with
seeded random weights and check that every batch went through K1 and K2;
compare the card's fp32 and bf16 Predictor with the CPU Predictor; train
UDEB4 at 380x380, 10 real + 10 fake, bf16, with the two-pass step and the
optimizer of config_template/forgery/model_udeb4.yml, checking every step's
launches of K1, K2 and K2-bwd; compare one fp32 training step on the card
with the same step on the CPU. Any failure raises, so the exit code is not
0 and no result line is printed. The last line is the result object; the
line before it the kernel table.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak
SEED = 0

# config_template/forgery/model_udeb4.yml (model and config sections) and
# data_ffc23.yml (num_steps, 380x380, train_batch_size 10 real + 10 fake)
UDEB4_MODEL = {"num_classes": 2, "drop_rate": 0.2, "extractor": "efficientnet-b4"}
UDEB4_CONFIG = {
    "warmup_step": 0, "lambda_triplet": 0.1, "lambda_recons": 0.1, "lambda_freq": 1.0,
    "lambda_mask": 0.1, "lambda_fac": 0.1,
    "optimizer": {"name": "adamw", "lr": 1e-4, "betas": [0.9, 0.999], "weight_decay": 5e-6,
                  "amsgrad": True},
    "scheduler": {"name": "StepLR", "step_size": 22500, "gamma": 0.5},
}
NUM_STEPS = 90000

# (H=W, C, launches per UDEB4 forward) of every SFConv frequency branch
SFCONV_SHAPES = {
    380: [(95, 192, 1), (48, 336, 4), (24, 672, 6), (24, 960, 6), (12, 1632, 7)],
    256: [(64, 192, 1), (32, 336, 4), (16, 672, 6), (16, 960, 6), (8, 1632, 7)],
}


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
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[ptxas {name}] {line.strip()}")


def phase_k1(quick: bool, card: str) -> dict:
    import torch

    from unidefense_torch.ops.preprocess import normalize_flip, normalize_flip_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    main = None
    for size in (380, 256):
        x = torch.randint(0, 256, (32, size, size, 3), generator=gen, device="cuda",
                          dtype=torch.uint8)
        flip = torch.rand(32, generator=gen, device="cuda") < 0.5
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            got = normalize_flip(x, flip, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), dt)
            ref = normalize_flip_plain(x, flip, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), dt)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            worst = max(worst, err)
            if not err <= tol:
                raise AssertionError(f"K1 {size}^2 {dt}: max |err| {err} > {tol}")
            nbytes = x.numel() * (1 + got.element_size()) + flip.numel()
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            if quick:
                log(f"[K1] 32x{size}x{size}x3 -> {dt}: max |err| {err:.3g} (tol {tol}) ok")
                continue
            ms = time_ms(lambda: normalize_flip(x, flip, out_dtype=dt))
            plain = time_ms(lambda: normalize_flip_plain(x, flip, out_dtype=dt))
            log(f"[K1] 32x{size}x{size}x3 -> {dt}: max |err| {err:.3g} (tol {tol}); "
                f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms "
                f"(bytes {nbytes}), {card}")
            if size == 380 and dt == torch.float32:
                main = dict(ms=ms, plain_ms=plain, bound_ms=bound)
    return dict(max_abs_err=worst, **(main or {}))


def _k2_bound_ms(n, h, w, c) -> tuple[float, str]:
    # four C x C channel mixes per pixel, and one Hilbert product hm@x per
    # image row: hm@x_m is that product at the mirror row m, not a second one
    flops = n * h * (2 * w * w * c + 8 * w * c * c)
    nbytes = 2 * n * h * w * c * 2 + 4 * c * c * 2
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_k2(quick: bool, card: str) -> dict:
    import torch

    from unidefense_torch.ops.sfconv_cuda import sfconv_freq
    from unidefense_torch.ops.sfconv_spatial import sfconv_freq_spatial

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst_abs, per_forward = 0.0, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for res, shapes in SFCONV_SHAPES.items():
        for hw, c, per_fwd in shapes:
            x = torch.randn(32, hw, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
            w = torch.randn(2 * c, 2 * c, generator=gen, device="cuda") / (2 * c) ** 0.5
            got = sfconv_freq(x, w)
            ref = sfconv_freq_spatial(x.float(), w)
            got32 = sfconv_freq(x.float(), w)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            err = (got.float() - ref).abs().max().item()
            err32 = (got32 - ref).abs().max().item()
            worst_abs = max(worst_abs, err)
            if not (err <= 2e-2 * scale and err32 <= 1e-4 * scale):
                raise AssertionError(f"K2 {hw}^2/C{c}: bf16 err {err}, fp32 err {err32}, "
                                     f"max |ref| {scale}")
            head = (f"[K2] 32x{hw}x{hw}x{c} ({res}^2, x{per_fwd}/fwd): bf16 max |err| "
                    f"{err:.4g} = {err / scale:.3g} of max |ref| (tol 2e-2); fp32 "
                    f"{err32 / scale:.3g} (tol 1e-4)")
            if quick:
                log(head + " ok")
                continue
            ms = time_ms(lambda: sfconv_freq(x, w), warmup=2, iters=10)
            plain = time_ms(lambda: sfconv_freq_spatial(x, w), warmup=2, iters=10)
            bound, by = _k2_bound_ms(32, hw, hw, c)
            log(f"{head}; kernel {ms:.4f} ms, plain(bf16) {plain:.4f} ms, bound {bound:.4f} ms "
                f"({by}), {card}")
            if res == 380:
                per_forward["ms"] += per_fwd * ms
                per_forward["plain_ms"] += per_fwd * plain
                per_forward["bound_ms"] += per_fwd * bound
            del x, w, got, ref, got32
    if not quick:
        log(f"[K2] per UDEB4 forward at 380^2 b32 (24 launches): kernel "
            f"{per_forward['ms']:.3f} ms, plain {per_forward['plain_ms']:.3f} ms, bound "
            f"{per_forward['bound_ms']:.3f} ms, {card}")
    return dict(max_abs_err=worst_abs, **per_forward)


def _k2_bwd_bound_ms(n, h, w, c) -> tuple[float, str]:
    # K2-bwd alone: the four C x C weight sums over N*H*W pixel rows and one
    # Hilbert product hm@x per image row; reads x and g once (bf16), writes
    # the (4C, C) fp32 sums
    flops = n * h * (8 * w * c * c + 2 * w * w * c)
    nbytes = 2 * n * h * w * c * 2 + 4 * c * c * 4
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_k2_bwd(quick: bool, card: str) -> dict:
    """K2-bwd at every SFConv shape of 380^2 and 256^2, batch 20 (the
    training batch): x_bar (K2 on the gradient) and w_bar (K2-bwd and the
    repack) in bf16 and fp32 against the plain version in fp32."""
    import torch

    from unidefense_torch.ops.sfconv_cuda import (
        _launch_dw, sfconv_freq_bwd, sfconv_freq_bwd_plain, weight_sums_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst, per_bwd = 0.0, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "whole_ms": 0.0}
    for res, shapes in SFCONV_SHAPES.items():
        for hw, c, per_fwd in shapes:
            x = torch.randn(20, hw, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
            g = torch.randn(20, hw, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
            w = torch.randn(2 * c, 2 * c, generator=gen, device="cuda") / (2 * c) ** 0.5
            ref_x, ref_w = sfconv_freq_bwd_plain(x.float(), g.float(), w)
            got_x, got_w = sfconv_freq_bwd(x, g, w)
            got32_x, got32_w = sfconv_freq_bwd(x.float(), g.float(), w)
            torch.cuda.synchronize()
            errs = []
            for name, ref, got, got32 in (("x_bar", ref_x, got_x, got32_x),
                                          ("w_bar", ref_w, got_w, got32_w)):
                scale = ref.abs().max().item()
                rel, rel32 = ((a.float() - ref).abs().max().item() / scale for a in (got, got32))
                errs.append(f"{name} bf16 {rel:.3g} fp32 {rel32:.3g}")
                worst = max(worst, rel * scale)
                if not (rel <= 2e-2 and rel32 <= 1e-4):
                    raise AssertionError(f"K2-bwd {hw}^2/C{c} {name}: bf16 rel err {rel}, "
                                         f"fp32 rel err {rel32}, max |ref| {scale}")
            head = (f"[K2-bwd] 20x{hw}x{hw}x{c} ({res}^2, x{per_fwd}/bwd): error over max |ref| "
                    f"{', '.join(errs)} (tol bf16 2e-2, fp32 1e-4)")
            if quick:
                log(head + " ok")
                continue
            ms = time_ms(lambda: _launch_dw(x, g), warmup=2, iters=10)
            plain = time_ms(lambda: weight_sums_plain(x, g), warmup=2, iters=10)
            whole = time_ms(lambda: sfconv_freq_bwd(x, g, w), warmup=2, iters=10)
            bound, by = _k2_bwd_bound_ms(20, hw, hw, c)
            log(f"{head}; K2-bwd kernel {ms:.4f} ms, plain(bf16) {plain:.4f} ms, bound "
                f"{bound:.4f} ms ({by}); whole backward (x_bar + K2-bwd + repack) {whole:.4f} ms, "
                f"{card}")
            if res == 380:
                for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound),
                               ("whole_ms", whole)):
                    per_bwd[key] += per_fwd * v
            del x, g, w, ref_x, ref_w, got_x, got_w, got32_x, got32_w
    if not quick:
        log(f"[K2-bwd] per UDEB4 backward at 380^2 b20 (24 launches): K2-bwd kernel "
            f"{per_bwd['ms']:.3f} ms, plain {per_bwd['plain_ms']:.3f} ms, bound "
            f"{per_bwd['bound_ms']:.3f} ms; whole backward {per_bwd['whole_ms']:.3f} ms, {card}")
    return dict(max_abs_err=worst, **{k: v for k, v in per_bwd.items() if k != "whole_ms"})


def seeded_weights(card: str) -> dict:
    """UDEB4 state_dict from seeded random weights, set so that the network
    keeps its scale and does not amplify rounding:

    - every sf_coef 0 (the init of -10 weights the frequency branch by 4.5e-5);
    - BatchNorm scales 0.5, and 0.1 on the last BatchNorm of each residual
      block (a small residual branch at init, as zero-init-last-BN schemes do);
    - running statistics calibrated on 8 seeded frames: per-channel mean and
      variance in the backbone, mean 0 and the mean square in the bottleneck;
    - the classifier scaled so the logit gap has RMS 0.5 on those frames.

    With the init's unit statistics activations decay until every
    probability is 0.5. With unit BatchNorm scales the random network
    amplifies the bf16 rounding of its input about 30-fold over the 32
    blocks, past the bf16 parity bound, which no trained weights here can
    show otherwise."""
    import numpy as np
    import torch

    from unidefense_torch.device import nchw
    from unidefense_torch.inference import Predictor
    from unidefense_torch.models.layers import BatchNorm, SFConv

    pred = Predictor("UDEB4", input_size=380, batch_size=8, dtype=torch.float32,
                     device="cuda", seed=SEED)
    model = pred.model
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SFConv):
                m.sf_coef.zero_()
            elif isinstance(m, BatchNorm) and m is not model.bottleneck:
                m.weight.fill_(0.5)
        for blk in model.backbone._blocks:
            s = blk.spec
            if s.id_skip and s.stride == 1 and s.input_filters == s.output_filters:
                blk._bn2.weight.fill_(0.1)

    def calibrate(m, args):
        x = args[0].float()
        if x.dim() == 2:  # the bottleneck, on pooled features
            m.running_mean.zero_()
            m.running_var.copy_(x.pow(2).mean(0))
        else:
            m.running_mean.copy_(x.mean((0, 2, 3)))
            m.running_var.copy_(x.var((0, 2, 3), correction=0))

    frames = np.random.default_rng(SEED + 2).integers(0, 256, (8, 380, 380, 3), dtype=np.uint8)
    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        with torch.inference_mode():
            out = model(nchw(pred.device_tf(torch.from_numpy(frames).cuda())))
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        gap = out["cls_out"][:, 0] - out["cls_out"][:, 1]
        model.classifier.fc.weight.mul_(0.5 / gap.pow(2).mean().sqrt())
    log(f"[weights] UDEB4 seed {SEED}: {sum(p.numel() for p in model.parameters())} params, "
        f"sf_coef 0, {len(hooks)} BatchNorms calibrated on 8 seeded frames, {card}")
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def phase_serve(card: str, weights: dict) -> tuple[int, int]:
    import numpy as np
    import torch

    from unidefense_torch.inference import Predictor
    from unidefense_torch.ops.preprocess import normalize_flip
    from unidefense_torch.ops.sfconv_cuda import sfconv_freq

    pred = Predictor("UDEB4", state_dict=weights, input_size=380, batch_size=32,
                     dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, 256, (64, 380, 380, 3), dtype=np.uint8) for _ in range(3)]
    pred.predict_frames(requests[0][:32])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    normalize_flip.launches = 0
    sfconv_freq.launches = 0
    times, probs = [], []
    for frames in requests:
        t0 = time.perf_counter()
        probs.append(pred.predict_frames(frames))
        times.append(time.perf_counter() - t0)
    k1, k2 = normalize_flip.launches, sfconv_freq.launches
    batches = sum(-(-len(f) // 32) for f in requests)
    if k1 != batches or k2 != 24 * batches:
        raise AssertionError(f"launches K1 {k1}, K2 {k2}; expected {batches} and {24 * batches}")
    p = np.concatenate(probs)
    if p.shape != (192,) or not np.all(np.isfinite(p)) or p.min() < 0 or p.max() > 1:
        raise AssertionError(f"bad probabilities: shape {p.shape}, range [{p.min()}, {p.max()}]")
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_request = statistics.median(times) * 1e3
    log(f"[serve] UDEB4 380^2 b32 bf16, 3 requests x 64 frames: {192 / sum(times):.2f} img/s, "
        f"p50 {per_request:.2f} ms per request ({per_request / 2:.2f} ms per batch), peak memory "
        f"{peak:.3f} GiB, launches K1 {k1} K2 {k2} over {batches} batches, probs in "
        f"[{p.min():.4f}, {p.max():.4f}], {card}")
    phase_profile(card, "one batch 380^2 b32 bf16", lambda: pred.predict_frames(requests[0][:32]))
    return k1, k2


# kernel-name fragments -> group of the device-time breakdown, first match wins
KERNEL_GROUPS = (
    ("K2-bwd weight sums", ("dw_wmma", "dw_fma", "reduce_splits")),
    ("K2 channel mix", ("sfconv_mix_wmma", "sfconv_freq_fwd_kernel")),
    ("Hilbert rows (K2, K2-bwd)", ("hilbert_rows",)),
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


def phase_parity(card: str, weights: dict) -> None:
    import numpy as np
    import torch

    from unidefense_torch.inference import Predictor

    base = Predictor("UDEB4", state_dict=weights, input_size=380, batch_size=2,
                     dtype=torch.float32, device="cpu")
    frames = np.random.default_rng(SEED + 3).integers(0, 256, (2, 380, 380, 3), dtype=np.uint8)
    ref = base.predict_frames(frames)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for dt, tol in ((torch.float32, 1e-3), (torch.bfloat16, 2e-2)):
            gpu = Predictor("UDEB4", state_dict=weights, input_size=380, batch_size=2, dtype=dt,
                            device="cuda")
            got = gpu.predict_frames(frames)
            d = float(np.abs(got - ref).max())
            log(f"[parity] {dt} cuda vs fp32 cpu Predictor: probs {got} vs {ref}, "
                f"max |dprob| {d:.3g} (tol {tol}), {card}")
            if not d <= tol:
                raise AssertionError(f"parity {dt}: {d} > {tol}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _groups_of(model) -> dict:
    """Parameter groups, each of which must move in a train step; the
    SFConv frequency kernels (trained through K2-bwd) are a group of their
    own."""
    groups: dict = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        parts = name.split(".")
        key = parts[0] if parts[0] != "backbone" else ".".join(parts[:2])
        if key == "backbone._blocks":
            key = "backbone._blocks (" + ("freq_conv" if "freq_conv" in name else "other") + ")"
        groups.setdefault(key, []).append(p)
    return groups


def _train_batch(n_real: int, n_fake: int, size: int, seed: int, device: str):
    import numpy as np
    import torch

    frames = np.random.default_rng(seed).integers(0, 256, (n_real + n_fake, size, size, 3),
                                                  dtype=np.uint8)
    labels = torch.tensor([0] * n_real + [1] * n_fake)
    return {"image": torch.from_numpy(frames).to(device), "label": labels.to(device)}


def phase_train(card: str, weights: dict) -> tuple[int, int, int]:
    """The port's two-pass UDEB4 step at 380^2, 10 real + 10 fake, bf16, the
    YAML's optimizer and drop rates: 2 warm-up steps, then 5 timed steps,
    each checked for exactly 1 K1, 96 K2 and 48 K2-bwd launches."""
    import torch

    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.ops.preprocess import normalize_flip
    from unidefense_torch.ops.sfconv_cuda import sfconv_freq, sfconv_freq_bwd
    from unidefense_torch.train.optim import build_optimizer
    from unidefense_torch.train.step import create_train_state, make_train_step

    model = build_model("UDEB4", UDEB4_MODEL, dtype=torch.bfloat16)
    model.load_state_dict(weights, strict=True)
    tx, _ = build_optimizer(UDEB4_CONFIG)
    state = create_train_state(model, tx)
    step = make_train_step(tx, UDEB4_CONFIG, NUM_STEPS, 10, 10,
                           preprocess=DevicePipeline(hflip_p=0.5))
    batch = _train_batch(10, 10, 380, SEED + 5, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for _ in range(2):  # warm-up: cuDNN plans, the allocator
        step(state, batch, gen)
    groups = _groups_of(state.model)
    before = {k: [p.detach().clone() for p in ps] for k, ps in groups.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, counts = [], [], (0, 0, 0)
    for _ in range(5):
        normalize_flip.launches = sfconv_freq.launches = sfconv_freq_bwd.launches = 0
        t0 = time.perf_counter()
        _, metrics, cls_out = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = (normalize_flip.launches, sfconv_freq.launches, sfconv_freq_bwd.launches)
        if got != (1, 96, 48):
            raise AssertionError(f"launches per step K1, K2, K2-bwd = {got}; expected (1, 96, 48)")
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
    log(f"[train] UDEB4 380^2 b10+10 bf16 two-pass step, adamw amsgrad: {100 / sum(times):.2f} "
        f"img/s over 5 steps, p50 {ms:.2f} ms per step (steps {[round(t * 1e3, 2) for t in times]}"
        f" ms), peak memory {peak:.3f} GiB, launches per step K1 1 K2 96 K2-bwd 48 (total "
        f"{counts}), all {len(groups)} parameter groups moved ({still} of "
        f"{sum(map(len, moved.values()))} tensors did not), {card}")
    log(f"[train] losses step 1: {losses[0]}; step 5: {losses[-1]}")
    phase_profile(card, "one train step 380^2 b10+10 bf16", lambda: step(state, batch, gen))
    return counts


def phase_train_parity(card: str, weights: dict) -> None:
    """One deterministic two-pass step of UDEB4 at 256^2, 2 real + 2 fake,
    fp32 on the card (K1, K2 and K2-bwd in fp32) against the same step on
    the CPU, from the same weights and draws: every loss, and each
    parameter's gradient (pass-1 plus pass-2, as update 2 applies it) by
    the norm."""
    import dataclasses

    import torch

    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.train.optim import build_optimizer
    from unidefense_torch.train.perturb import PerturbDraws
    from unidefense_torch.train.step import StepDraws, create_train_state, make_train_step

    cfg = dict(UDEB4_MODEL, drop_rate=0.0, drop_connect_rate=0.0, feat_drop_rate=0.0)
    # the frequency style branch: CORAL, the FFT amplitude mix, the most code
    draws = PerturbDraws.draw(torch.Generator().manual_seed(SEED + 7), 2, 2, (4, 256, 256, 3))
    draws = StepDraws(flip=torch.tensor([True, False, False, True]),
                      perturb=dataclasses.replace(draws, style=True, freq=True))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    runs = {}
    try:
        for device in ("cpu", "cuda"):
            model = build_model("UDEB4", cfg, dtype=torch.float32)
            model.load_state_dict(weights, strict=True)
            tx, _ = build_optimizer(UDEB4_CONFIG)
            state = create_train_state(model, tx, device=device)
            step = make_train_step(tx, UDEB4_CONFIG, NUM_STEPS, 2, 2,
                                   preprocess=DevicePipeline(hflip_p=0.5))
            _, metrics, _ = step(state, _train_batch(2, 2, 256, SEED + 8, device), None, draws)
            runs[device] = ({k: float(v) for k, v in metrics.items()},
                            {n: float(p.grad.norm()) for n, p in state.model.named_parameters()
                             if p.grad is not None})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (lc, gc), (lg, gg) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(lg[k] - v) / max(abs(v), 1e-12) for k, v in lc.items())
    total = sum(v * v for v in gc.values()) ** 0.5
    # a tensor whose gradient is rounding noise (a BatchNorm bias feeding a
    # 1x1 conv and a train-mode BatchNorm, which cancels any shift) is
    # judged against the total norm, the rest against their own
    grad_err, worst = max((abs(gg[n] - v) / (v + 1e-4 * total), n) for n, v in gc.items())
    log(f"[train-parity] UDEB4 256^2 b2+2 fp32 two-pass step, cuda vs cpu: losses max rel err "
        f"{loss_err:.3g} (tol 1e-3); {len(gc)} gradient norms, max |d|g|| / (|g| + 1e-4 |all|) "
        f"{grad_err:.3g} at {worst} (tol 1e-2); total |g| {total:.4g}; {card}")
    if not (loss_err <= 1e-3 and grad_err <= 1e-2):
        raise AssertionError(f"train parity: losses {lc} vs {lg}; worst gradient {worst}")


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
    k2 = phase_k2(args.quick, card)
    k2_bwd = phase_k2_bwd(args.quick, card)
    if args.quick:
        log("[quick] kernels built and checked; no timing, serving or parity")
        return 0
    weights = seeded_weights(card)
    phase_serve(card, weights)  # asserts its own K1 and K2 launch counts
    phase_parity(card, weights)
    k1_launches, k2_launches, k2_bwd_launches = phase_train(card, weights)
    phase_train_parity(card, weights)

    lines = [
        dict(name="K1 normalize_flip", route="cuda", source="unidefense_torch/csrc/normalize_flip.cu",
             replaces="unidefense_tpu/ops/pallas_preprocess.py:42", launches=k1_launches,
             max_abs_err=k1["max_abs_err"], ms=k1["ms"], plain_ms=k1["plain_ms"],
             bound_ms=k1["bound_ms"], bound_by="bytes", library_ms=None),
        dict(name="K2 sfconv_freq_fwd", route="cuda", source="unidefense_torch/csrc/sfconv_freq_fwd.cu",
             replaces="unidefense_tpu/ops/sfconv_pallas.py:169", launches=k2_launches,
             max_abs_err=k2["max_abs_err"], ms=k2["ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by="operations", library_ms=None),
        dict(name="K2-bwd sfconv_freq_bwd", route="cuda",
             source="unidefense_torch/csrc/sfconv_freq_bwd.cu",
             replaces="unidefense_tpu/ops/sfconv_pallas.py:257", launches=k2_bwd_launches,
             max_abs_err=k2_bwd["max_abs_err"], ms=k2_bwd["ms"], plain_ms=k2_bwd["plain_ms"],
             bound_ms=k2_bwd["bound_ms"], bound_by="operations", library_ms=None),
    ]
    log(card)
    log(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
