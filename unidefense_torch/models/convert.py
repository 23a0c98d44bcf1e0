"""JAX variables -> torch state_dict for the port's UDEB4, UDR18 and UDR50
(unidefense_tpu/models/convert.py:62-162,257-304).

``state_dict_from_jax`` takes the JAX model's ``{'params', 'batch_stats'}``
tree as nested dicts of numpy arrays and returns a state_dict under the
reference's torch key names, which the port's modules load with
``load_state_dict(strict=True)``. It is the bridge that holds the port
against the JAX package, weight for weight.
"""

from __future__ import annotations

import re
from typing import Iterator

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var", "sf_coef": "sf_coef"}
_EFFNET_MODULES = ("expand_conv", "depthwise_conv", "project_conv", "se_reduce", "se_expand",
                   "conv_stem", "conv_head", "fc")
# position of each decoder stage in the reference's nn.Sequential decoders
_DEC_IDX = {"conv1": "0", "in1": "1", "deconv": "3", "in2": "4",
            "conv2": "6", "in3": "7", "conv_out": "9"}
_FILTER_IDX = {"proj": "layer1.0", "proj_norm": "layer1.1", "mask_conv": "layer2.0"}
# the ResNet blocks' and the embedders' shortcut
_DOWNSAMPLE = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1",
               "down_conv": "downsample.0", "down_norm": "downsample.1"}


def _flatten(tree: dict, prefix: tuple = ()) -> Iterator[tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _efficientnet_key(parts: list) -> str:
    out = []
    for m in parts[:-1]:
        bm = re.fullmatch(r"block(\d+)", m)
        if bm:
            out.append(f"_blocks.{bm.group(1)}")
        elif m in _EFFNET_MODULES or re.fullmatch(r"bn[0-2]", m):
            out.append("_" + m)
        elif m == "freq_conv":
            out.append("freq_conv")
        else:
            raise KeyError(f"unmapped EfficientNet module '{m}' in {parts}")
    return ".".join(out + [_LEAF[parts[-1]]])


def _resnet_key(parts: list) -> str:
    """ResNet path (under the extractor's ``net``, which has no torch
    level) -> torchvision/timm key: ``layerL.B.convK``, ``downsample.0/1``."""
    out = []
    for m in parts[:-1]:
        bm = re.fullmatch(r"block(\d+)", m)
        if bm:
            out.append(bm.group(1))
        elif m in _DOWNSAMPLE:
            out.append(_DOWNSAMPLE[m])
        elif re.fullmatch(r"(conv|bn|layer)\d|fc|freq_conv", m):
            out.append(m)
        elif m != "net":
            raise KeyError(f"unmapped ResNet module '{m}' in {parts}")
    return ".".join(out + [_LEAF[parts[-1]]])


def torch_key(path: tuple) -> str:
    """JAX variable path -> reference UniDefense state_dict key (UDEB4,
    UDR18, UDR50)."""
    parts = [p for p in path if p not in ("Conv_0", "Dense_0")]
    leaf, mods = parts[-1], parts[:-1]
    head = mods[0] if mods else None
    if head == "backbone":
        return "backbone." + _efficientnet_key(parts[1:])
    if head == "extractor":
        return "extractor." + _resnet_key(parts[1:])
    if head is not None and head.startswith("emb_block"):
        return ".".join([head, *(_DOWNSAMPLE.get(m, m) for m in mods[1:]), _LEAF[leaf]])
    if head is not None and head.startswith("dec_block"):
        return f"{head}.{_DEC_IDX[mods[1]]}.{_LEAF[leaf]}"
    if head == "bottleneck":
        return f"bottleneck.{_LEAF[leaf]}"
    if head == "classifier":
        return f"classifier.fc.{_LEAF[leaf]}"
    if head == "attention":
        if leaf == "fuse_coef":
            return "fuse_coef"
        return f"{mods[1]}.{_FILTER_IDX[mods[2]]}.{_LEAF[leaf]}"
    raise KeyError(f"unmapped UniDefense path {path}")


def _layout(path: tuple, v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float32)
    if path[-1] == "kernel":
        if v.ndim == 4 and "deconv" in path:  # (kh, kw, in, out) -> (in, out, kh, kw)
            v = v.transpose(2, 3, 0, 1)
        elif v.ndim == 4:  # (kh, kw, in, out) -> (out, in, kh, kw)
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 2:  # dense (in, out) -> (out, in)
            v = v.T
    return np.array(v, np.float32, order="C")  # a writable copy; 0-d stays 0-d


def state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """JAX {'params', 'batch_stats'} of a UniDefense model -> torch
    state_dict, including each BatchNorm's zero ``num_batches_tracked`` and
    the bottleneck's frozen zero bias."""
    sd: dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, val in _flatten(variables.get(coll, {})):
            key = torch_key(path)
            sd[key] = torch.from_numpy(_layout(path, val))
            if path[-1] == "mean":  # one per BatchNorm
                sd[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    if "bottleneck.weight" in sd and "bottleneck.bias" not in sd:
        sd["bottleneck.bias"] = torch.zeros_like(sd["bottleneck.weight"])
    return sd
