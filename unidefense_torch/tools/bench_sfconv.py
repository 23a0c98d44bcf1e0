"""Per-shape SFConv frequency-branch microbenchmark of the port: the plain
PyTorch form against the CUDA kernels K2 (v2, per image row), K4 (v3,
row-tiled over a materialised double reversal) and K3 (v4, split output),
ms per fwd+bwd of one op instance, in bf16. The counterpart of the JAX
package's tools/bench_sfconv.py, with the same shapes, batch and columns
(its "xla" column is the plain form here) and no eligibility gate: on the
card every column runs its kernel.

Compare only numbers from the same invocation, on the same card.

    python -m unidefense_torch.tools.bench_sfconv                 # all shapes, all impls
    python -m unidefense_torch.tools.bench_sfconv --n 20          # batch override
    python -m unidefense_torch.tools.bench_sfconv --interleaved   # minima over alternating rounds
    python -m unidefense_torch.tools.bench_sfconv --device cpu    # plain versions, host clock
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from unidefense_torch.device import DeviceLike, resolve_device
from unidefense_torch.ops.sfconv_cuda import sfconv_freq
from unidefense_torch.ops.sfconv_rowtiled import sfconv_freq_v3, sfconv_freq_v4
from unidefense_torch.ops.sfconv_spatial import sfconv_freq_spatial

# (H, W, C) SFConv instances; N is the batch (10 real + 10 fake)
SHAPES_256 = [(64, 64, 192), (48, 48, 336), (32, 32, 336), (24, 24, 672),
              (16, 16, 672), (12, 12, 960)]
SHAPES_380 = [(95, 95, 192), (80, 80, 192)]

IMPLS = {"plain": sfconv_freq_spatial, "v2": sfconv_freq, "v3": sfconv_freq_v3,
         "v4": sfconv_freq_v4}


def _inputs(rng: np.random.Generator, n: int, h: int, w: int, c: int, device: torch.device):
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32))
    wp = torch.from_numpy(rng.normal(size=(2 * c, 2 * c)).astype(np.float32))
    return x.to(device, torch.bfloat16), wp.to(device, torch.bfloat16)


def _time_fwd_bwd(fn, x: torch.Tensor, wp: torch.Tensor, iters: int = 30) -> float:
    """ms per forward and backward (x̄ and w̄) of ``fn``, after one warm-up
    call: CUDA events on the card, the host clock on the CPU."""
    cot = torch.ones_like(x)
    x, wp = x.detach().requires_grad_(), wp.detach().requires_grad_()

    def step():
        gx, gw = torch.autograd.grad(fn(x, wp), (x, wp), cot)
        return gx.float().sum() + gw.float().sum()

    float(step())  # warm-up: builds the kernels on first use
    if x.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            v = step()
        end.record()
        float(v)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        v = step()
    float(v)
    return (time.perf_counter() - t0) / iters * 1e3


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run(shapes=None, n: int = 20, iters: int = 30, device: DeviceLike = "cuda") -> dict:
    """One timing window per column and shape; returns {(h, w, c): {column: ms}}."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    print(f"device={_device_name(dev)} n={n} (ms per fwd+bwd)")
    print(f"{'shape':>16} {'plain':>8} {'v2':>8} {'v3':>8} {'v4':>8}  notes")
    results = {}
    for h, w, c in shapes or SHAPES_256 + SHAPES_380:
        x, wp = _inputs(rng, n, h, w, c, dev)
        times = {name: _time_fwd_bwd(fn, x, wp, iters) for name, fn in IMPLS.items()}
        best = min(times, key=times.get)
        print(f"{h}x{w}/C{c:<4}" + "".join(f" {t:8.2f}" for t in times.values())
              + f"  win={best} ({times['plain'] / times[best]:.2f}x)")
        results[(h, w, c)] = times
    return results


def interleaved(shapes=None, n: int = 20, iters: int = 20, rounds: int = 3,
                device: DeviceLike = "cuda") -> dict:
    """Noise-robust per-shape A/B: alternate plain/v2/v4 timing windows
    within one process and take each column's minimum across rounds."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    print(f"device={_device_name(dev)} n={n} interleaved x{rounds} (min ms per fwd+bwd)")
    impls = {k: IMPLS[k] for k in ("plain", "v2", "v4")}
    results = {}
    for h, w, c in shapes or SHAPES_256 + SHAPES_380:
        x, wp = _inputs(rng, n, h, w, c, dev)
        best = {k: float("inf") for k in impls}
        for _ in range(rounds):
            for k, fn in impls.items():
                best[k] = min(best[k], _time_fwd_bwd(fn, x, wp, iters))
        results[(h, w, c)] = best
        fastest = min(best, key=best.get)
        print(f"{h}x{w}/C{c:<4} " + " ".join(f"{k}={v:.2f}" for k, v in best.items())
              + f"  win={fastest} ({best['plain'] / best[fastest]:.2f}x)")
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--iters", type=int, default=None,
                    help="calls per timing window (default 30; 20 with --interleaved)")
    ap.add_argument("--interleaved", action="store_true",
                    help="minima of plain, v2 and v4 over 3 alternating rounds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.interleaved:
        interleaved(n=args.n, iters=args.iters or 20, device=args.device)
    else:
        run(n=args.n, iters=args.iters or 30, device=args.device)


if __name__ == "__main__":
    main()
