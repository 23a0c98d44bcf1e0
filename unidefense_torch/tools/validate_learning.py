"""End-to-end learning check of the port (tools/validate_learning.py's
counterpart): train UDR18 through the FE engine on synthetic separable data
and check that the validation AUC climbs.

Real frames: smooth random blobs (torch's bicubic upsampling of a seeded
low-resolution field). Fake frames: the same plus a faint checkerboard, the
kind of spectral artifact the dual-space model is built to catch. A healthy
pipeline reaches AUC about 1.0 within 150 steps; a broken loss, step,
optimizer or data path does not. The frames are JPEGs at q98 from the
port's own encoder (``data/native.encode_jpeg``), the index a
``torch.save``: the card machine needs no cv2.

    python -m unidefense_torch.tools.validate_learning [--steps 150] [--size 64]

``run(steps, size, ...)`` returns the engine's best AUC and ACC; ``main``
asserts a best AUC above 0.95.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import zlib

import numpy as np
import torch
import torch.nn.functional as F

KINDS = (("original_sequences/youtube", False), ("manipulated_sequences/Deepfakes", True))
CHECKER = 0.10  # the fakes' checkerboard amplitude


def blob(seed: int, size: int) -> np.ndarray:
    """(size, size, 3) float32 in [0, 1]: a seeded (size/8)^2 field
    upsampled bicubically."""
    field = np.random.default_rng(seed).random((size // 8, size // 8, 3)).astype(np.float32)
    up = F.interpolate(torch.from_numpy(field).permute(2, 0, 1)[None], size=(size, size),
                       mode="bicubic", align_corners=False)
    return np.clip(up[0].permute(1, 2, 0).numpy(), 0.0, 1.0)


def make_dataset(root: str, size: int, n_videos: int = 24, frames: int = 4) -> list:
    """An FF++ tree under ``root``: ``n_videos`` real and fake videos of
    ``frames`` JPEG frames each, and one index for the train, val and test
    splits. Returns the index, [(relative path, label)]."""
    from unidefense_torch.data.native import encode_jpeg

    index = []
    checker = ((np.arange(size)[:, None] + np.arange(size)[None, :]) % 2).astype(np.float32)
    for kind, fake in KINDS:
        for v in range(n_videos):
            for f in range(frames):
                # crc32, not hash(): Python's hash is salted per process
                img = blob(zlib.crc32(f"{kind}|{v}|{f}".encode()) % 2**31, size)
                if fake:
                    img = np.clip(img + CHECKER * checker[:, :, None], 0.0, 1.0)
                rel = f"{kind}/c23/images/{v:03d}/{f:04d}.jpg"
                path = os.path.join(root, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as fh:
                    fh.write(encode_jpeg((img * 255).astype(np.uint8), quality=98))
                index.append((rel, int(fake)))
    os.makedirs(os.path.join(root, "pickle_files"), exist_ok=True)
    for split in ("train", "val", "test"):
        torch.save(index, os.path.join(root, "pickle_files", f"{split}_c23.pickle"))
    return index


def configs(root: str, work: str, steps: int, size: int, model: str = "UDR18") -> dict:
    """The engine config of tools/validate_learning.py: FF++ Origin against
    Deepfakes, b4+4, AdamW amsgrad 2e-4, bf16, validated at steps/2 and
    steps; its data YAML written into ``work``."""
    import yaml

    tf = [{"name": "Resize", "params": {"height": size, "width": size}},
          {"name": "Normalize", "params": {"mean": [0.5] * 3, "std": [0.5] * 3}}]
    ds_cfg = {
        "root": root, "name": "FFpp", "use_lmdb": False,
        "real_method": ["Origin"], "fake_method": ["Deepfakes"], "compression": "c23",
        "num_steps": steps, "log_steps": 25, "val_steps": max(1, steps // 2),
        "train_transforms": tf[:1] + [{"name": "HorizontalFlip", "params": {"p": 0.5}}] + tf[1:],
        "val_transforms": tf, "test_transforms": tf,
    }
    ds_path = os.path.join(work, "data.yml")
    with open(ds_path, "w") as f:
        yaml.dump(ds_cfg, f)
    return {
        "model": {"name": model, "num_classes": 2, "drop_rate": 0.2},
        "config": {
            "local_rank": 0, "num_devices": 1,
            "lambda_triplet": 0.1, "lambda_recons": 0.1, "lambda_freq": 1.0,
            "lambda_mask": 0.1, "lambda_fac": 0.1,
            "optimizer": {"name": "adamw", "lr": 2e-4, "betas": [0.9, 0.999],
                          "weight_decay": 5e-6, "amsgrad": True},
            "crop": "nocrop", "warmup_step": 0, "resume": False,
            "id": "learn-check", "debug": False, "offline": True, "precision": "bf16",
        },
        "data": {"train_batch_size": 4, "val_batch_size": 16, "test_batch_size": 16,
                 "file": ds_path},
        "cfg_path": ds_path,
    }


def run(steps: int = 150, size: int = 64, model: str = "UDR18", device=None,
        work: str = None) -> tuple[float, float]:
    """Write the tree, train ``steps`` steps through ``get_engine("FE")`` on
    ``device`` (the card unless told otherwise) and return its (best AUC,
    best ACC). ``work``: the directory of the tree and of ``runs/`` (a new
    temporary one, removed afterwards, when None). The working directory
    and ``sys.stdout`` (which the engine tees) are restored."""
    from unidefense_torch.engines import get_engine

    own = work is None
    work = tempfile.mkdtemp(prefix="ud_learn_") if own else work
    cwd, stdout = os.getcwd(), sys.stdout
    try:
        root = os.path.join(work, "ffpp")
        make_dataset(root, size)
        config = configs(root, work, steps, size, model)
        os.chdir(work)  # runs/ lands beside the tree
        on = {} if device is None else {"device": device}
        engine = get_engine("FE")(config, stage="Train", **on)
        engine.train()
        return float(engine.best_auc), float(engine.best_acc)
    finally:
        sys.stdout = stdout
        os.chdir(cwd)
        if own:
            shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--model", default="UDR18")
    args = ap.parse_args(argv)
    best_auc, best_acc = run(args.steps, args.size, args.model)
    print(f"FINAL best AUC: {best_auc:.4f}, best ACC: {best_acc:.4f}")
    assert best_auc > 0.95, f"pipeline failed to learn (AUC={best_auc})"
    print("LEARNING VALIDATION PASSED")


if __name__ == "__main__":
    main()
