"""The yardstick's arithmetic: a step's or a frame's FLOPs, and the least
time the SFConv frequency kernels could take.

FLOPs are those of the convolutions and matrix products (FFTs, norms and
elementwise work are not counted), as ``torch.utils.flop_counter`` counts
them over the benchmark's reference model on the ``meta`` device at the
cell's shapes: no memory, no arithmetic, nothing of the program. A training
step is two forwards and two backwards, nothing recomputed: 6 forwards.

``sfconv_bound_ms`` is a frozen copy of ``chip_smoke._sfconv_bound_ms``
(chip_smoke.py:360-368 at the commit that added the benchmark): per image
row the four C x C channel mixes per pixel and the Hilbert products, and
the bytes of the bf16 streams read or written once; the bound is the larger
of FLOPs over the bf16 peak and bytes over the HBM bandwidth.
"""

from __future__ import annotations

import torch

from perfbench.harness import PEAK_BF16_FLOPS, PEAK_HBM_BYTES
from perfbench.reference import model as ref_model


def sfconv_bound_ms(n, hw, c, hilberts, streams, out_bytes) -> float:
    flops = n * hw * (8 * hw * c * c + 2 * hilberts * hw * hw * c)
    nbytes = streams * n * hw * hw * c * 2 + out_bytes
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3


def k2_bound_ms(n: int, hw: int, c: int) -> float:
    """One K2 launch (a forward, or x̄ in the backward) on (n, hw, hw, c)."""
    return sfconv_bound_ms(n, hw, c, 1, 2, 4 * c * c * 2)


def k2bwd_bound_ms(n: int, hw: int, c: int) -> float:
    """One K2-bwd launch (the four weight sums) on (n, hw, hw, c)."""
    return sfconv_bound_ms(n, hw, c, 1, 2, 4 * c * c * 4)


def model_work(model_cfg: dict, n: int, size: int) -> dict:
    """For a batch of ``n`` frames at ``size``²: the ``flops`` of one
    forward, and the (hw, c) of each SFConv frequency branch it runs.

    A training step is counted as 6 forwards: two passes, each backward
    twice its forward (the input's and the weights' gradients).
    ``FlopCounterMode`` is not asked for the backward: it counts a grouped
    convolution's backward as a dense one (96 times too much for a
    depthwise 3x3 over 96 channels)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = ref_model.meta(model_cfg).eval()
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append((args[0].shape[2], args[0].shape[1])))
        for m in model.modules() if isinstance(m, ref_model.SFConv)]
    x = torch.zeros(n, 3, size, size, device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return {"flops": counter.get_total_flops(), "sfconvs": shapes}


def sfconv_bounds(shapes: list, n: int, train: bool) -> tuple:
    """(K2 ms, K2-bwd ms) of bound per step (``train``: each SFConv's two
    forwards, two x̄ and two weight sums) or per batch (one forward)."""
    k2 = sum(k2_bound_ms(n, hw, c) for hw, c in shapes)
    if not train:
        return k2, 0.0
    return 4 * k2, 2 * sum(k2bwd_bound_ms(n, hw, c) for hw, c in shapes)
