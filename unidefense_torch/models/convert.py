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


# the transposes from a JAX kernel to the torch weight: torch dim i holds JAX
# axis KERNEL_AXES[(ndim, deconv)][i]
KERNEL_AXES = {
    (4, False): (3, 2, 0, 1),  # conv (kh, kw, in, out) -> (out, in, kh, kw)
    (4, True): (2, 3, 0, 1),   # deconv (kh, kw, in, out) -> (in, out, kh, kw)
    (2, False): (1, 0),        # dense (in, out) -> (out, in)
}


def kernel_axes(ndim: int, deconv: bool = False) -> tuple:
    """The JAX axis each torch dim of a kernel holds; identity where the
    converter does not transpose."""
    return KERNEL_AXES.get((ndim, deconv), tuple(range(ndim)))


def jax_last_axis(ndim: int, deconv: bool = False) -> int:
    """The torch dim of a ``ndim``-d kernel that holds the JAX layout's last
    (output) axis: 0 for a conv (O, I, kh, kw) and a dense (out, in), 1 for a
    ConvTranspose (in, out, kh, kw)."""
    return kernel_axes(ndim, deconv).index(ndim - 1)


def _layout(path: tuple, v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float32)
    if path[-1] == "kernel":
        v = v.transpose(kernel_axes(v.ndim, "deconv" in path))
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


# ------------------------------------------------- the reference's files
# (unidefense_tpu/models/convert.py:206-318). The port's modules carry the
# reference's torch key names and layouts, so reading and writing these
# files is key selection plus load_state_dict / state_dict.

# the SFConv-only tensors, which the published backbones lack and which keep
# their initialisation (_SF_ONLY, unidefense_tpu/models/convert.py:23)
SF_ONLY = ("freq_conv", "sf_coef")
# each model's backbone sub-module: the prefix of its keys, the arch of the
# published file, and the classifier head that file carries and the model
# does not build
_BACKBONE = {"UDEB4": ("backbone.", "efficientnet", "_fc."),
             "UDR18": ("extractor.", "resnet", "fc."),
             "UDR50": ("extractor.", "resnet", "fc.")}
_ARCH_PREFIX = {"efficientnet": "backbone.", "resnet": "extractor.", "unidefense": ""}


def _load_file(path: str):
    """``torch.load`` of a reference file on the CPU. The files are pickles
    that may hold more than tensors (the step, best metrics, a whole module),
    so this unpickles with ``weights_only=False``, as the JAX package does:
    open only files you trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _load_matching(model: torch.nn.Module, state_dict: dict, prefix: str = "") -> list:
    """Load the tensors of ``state_dict`` whose ``prefix + key`` the model
    has; every other key of the file is ignored and every tensor the file
    lacks keeps its value (the JAX loader's ``strict=False``). A shape that
    differs raises, except a (1,) tensor into a 0-d one (``sf_coef``,
    ``fuse_coef``), which torch's ``_load_from_state_dict`` loads by its
    legacy rule, as the JAX loader does. Returns the keys of the model that
    the file did not give, SFConv-only ones aside."""
    own = model.state_dict()
    picked = {prefix + k: torch.as_tensor(v) for k, v in state_dict.items() if prefix + k in own}
    model.load_state_dict(picked, strict=False)
    return [k for k in own if k.startswith(prefix) and k not in picked
            and not k.endswith("num_batches_tracked") and not any(s in k for s in SF_ONLY)]


def load_unidefense_checkpoint(model: torch.nn.Module, path: str) -> list:
    """Load a whole reference UniDefense checkpoint into ``model`` (UDEB4,
    UDR18 or UDR50) in place: the ``{'model': state_dict, 'step', 'best_*'}``
    files of the reference's ``_save_ckpt`` and of
    :func:`save_torch_checkpoint`, or a bare ``state_dict``
    (unidefense_tpu/models/convert.py:206-216). Non-strict, as there; see
    :func:`_load_matching`. Returns the model's keys the file lacked."""
    sd = _load_file(path)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    return _load_matching(model, sd)


def load_pretrained_extractor(model: torch.nn.Module, path: str, model_name: str) -> list:
    """Load a published backbone (``extractor_weights``) into ``model``'s
    backbone in place (unidefense_tpu/models/convert.py:219-254): lukemelas
    EfficientNet naming (``_conv_stem``, ``_blocks.N._depthwise_conv``, ...)
    into UDEB4's ``backbone.``, torchvision/timm ResNet naming (``conv1``,
    ``layerL.B.convK``, ``downsample.0/1``) into UDR18's and UDR50's
    ``extractor.``. The file's classifier (``_fc.``, ``fc.``) is dropped;
    the extractors build the stem and layers 1-3, so ``layer4.`` goes
    unused; the SFConv-only tensors, which such files lack, keep their
    init. A pickled module is read through its ``state_dict()``. Returns
    the backbone's keys the file lacked, SFConv-only ones aside."""
    sd = _load_file(path)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    prefix, _, head = _BACKBONE[model_name.upper()]
    return _load_matching(model, {k: v for k, v in sd.items() if not k.startswith(head)}, prefix)


def export_state_dict(model: torch.nn.Module, arch: str = "unidefense") -> dict:
    """``model``'s weights as the reference's torch ``state_dict``, on the
    CPU (unidefense_tpu/models/convert.py:276-304): arch ``unidefense`` is
    the whole model, ``efficientnet`` and ``resnet`` its backbone with the
    ``backbone.`` / ``extractor.`` prefix stripped (the SFConv-only tensors
    included). The floats are the model's, bit for bit, the bottleneck's
    frozen zero bias among them; each BatchNorm's ``num_batches_tracked`` is
    the model's own count (the JAX package, which counts no batches, writes
    zeros there)."""
    prefix = _ARCH_PREFIX[arch]
    return {k[len(prefix):]: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if k.startswith(prefix)}


def write_checkpoint(state_dict: dict, path: str, step: int = 0,
                     extra_meta: dict | None = None) -> None:
    """``torch.save({'model': state_dict, 'step': step, **extra_meta})``:
    the reference's checkpoint format (engine/forgery_engine.py:215-223),
    which :func:`load_unidefense_checkpoint` and the reference's test path
    read (unidefense_tpu/models/convert.py:307-318)."""
    payload = {"model": state_dict, "step": step}
    payload.update(extra_meta or {})
    torch.save(payload, path)


def save_torch_checkpoint(model: torch.nn.Module, path: str, arch: str = "unidefense",
                          step: int = 0, extra_meta: dict | None = None) -> None:
    """:func:`export_state_dict` of ``model`` written as the reference's
    checkpoint (:func:`write_checkpoint`)."""
    write_checkpoint(export_state_dict(model, arch), path, step, extra_meta)
