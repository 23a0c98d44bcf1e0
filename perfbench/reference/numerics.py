"""How the reference rounds, and where its random masks come from.

``Numerics`` rounds where the program holds its compute type: the operands
and outputs of every convolution and matrix product, the outputs of the
norms and of the SFConv frequency branch, the pooled means before the SE
gate and the bottleneck. It rounds not at all (float32,
the reference), or to float8 (the control: e4m3 with a per-tensor scale in
the forward, e5m2 for the gradient in the backward, as float8 training
keeps them; the arithmetic between those points stays float32).

``Draws`` hands out the dropout and drop-connect masks of the reference's
forward passes. The benchmark gives both sides the same per-rank
``torch.Generator``s; the masks are drawn from them in the order the
program's forward draws them, each rank's rows from its own generator, and
kept, so that a block recomputed under ``torch.utils.checkpoint`` reads the
masks its forward drew.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round8(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, E5M2_MAX)


class Numerics:
    """``fp8``: round to float8 (the control); otherwise not at all."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(t) if self.fp8 else t


class Draws:
    """The masks of one forward pass: ``rand(shape)`` is U[0, 1) of the
    batch-leading ``shape``, rank r's ``rows[r]`` rows drawn from
    ``gens[r]`` on its device; ``seek(i)`` replays from the i-th draw."""

    def __init__(self, gens: list, rows: list):
        if len(gens) != len(rows):
            raise ValueError("one generator per rank")
        self.gens, self.rows = gens, rows
        self.kept: list = []
        self.pos = 0

    def rand(self, shape, device) -> torch.Tensor:
        shape = tuple(shape)
        if shape[0] != sum(self.rows):
            raise ValueError(f"a draw of {shape[0]} rows from ranks of {self.rows} rows")
        if self.pos == len(self.kept):
            self.kept.append(torch.cat([
                torch.rand((n,) + shape[1:], generator=g, device=g.device).to(device)
                for g, n in zip(self.gens, self.rows)]))
        out = self.kept[self.pos]
        self.pos += 1
        return out
