"""Step builders (unidefense_tpu/train/step.py). Only the eval step is
ported; the two-pass train step arrives with the training slice."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from unidefense_torch.device import nchw


def make_eval_step(model: torch.nn.Module, preprocess: Optional[Callable] = None) -> Callable:
    """Inference step: P(real) = softmax(cls_out)[:, 0]. The returned
    ``eval_step(x, generator=None)`` takes an NHWC batch (uint8 when
    ``preprocess`` is set) and returns (probs, cls_out, rec)."""

    @torch.inference_mode()
    def eval_step(x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if preprocess is not None:
            x = preprocess(x, generator)
        out = model(nchw(x.contiguous()))
        probs = torch.softmax(out["cls_out"].float(), dim=-1)[:, 0]
        return probs, out["cls_out"], out["rec"]

    return eval_step
