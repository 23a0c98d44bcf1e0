"""Dataset index loaders and host-side item loading
(unidefense_tpu/data/datasets.py:33-226,537).

Each dataset builds (images, targets) lists of path strings and int labels
from the on-disk index artifacts the reference consumes (pickles), and
exposes:

* __getitem__(i) -> (path_string, target)        (abstract_dataset.py:45-48)
* load_item(items, labels, margin, crop) -> {'images': uint8 NHWC numpy,
  'path': [...]}: decode + face-crop + resize on the host, in one call of
  the host JPEG library per batch (data/native.py); normalisation and flip
  run later on the card (data/transforms.DevicePipeline, K1).

Ported: FF++ (``FFpp``). Celeb-DF, WildDeepfake, OCIM and UniAttack raise
an error naming ROADMAP.md queue 3.
Blob storage: files under ``root``, a FrameStore (.udb) or LMDB
(data/store.open_blob_source).
"""

from __future__ import annotations

import pickle
from os.path import join

import numpy as np
import torch

from unidefense_torch.data.native import decode_batch
from unidefense_torch.data.store import open_blob_source
from unidefense_torch.data.transforms import LockedRNG, build_transforms


def _load_index(path):
    """Reference indexes are torch-saved pickles (dataset/faceforensics.py:41);
    accept plain pickles too."""
    try:
        return torch.load(path, weights_only=False)
    except Exception:
        with open(path, "rb") as f:
            return pickle.load(f)


class AbstractDataset:
    """Shared decode/crop/load machinery (dataset/abstract_dataset.py)."""

    def __init__(self, cfg: dict, split: str, seed: int = 2022):
        self.cfg = cfg
        self.split = split
        self.root = cfg["root"]
        self.use_lmdb = cfg.get("use_lmdb", True)
        self.images: list = []
        self.targets: list = []
        # locked: load_item (margin draw) runs on prefetch worker threads
        self.rng = LockedRNG(seed)
        self.categories = ["real", "fake"]

        self._blob = None
        if self.use_lmdb:
            ds = cfg.get(f"{split}_dataset")
            name = cfg[ds + "_root"] if ds is not None else cfg.get("lmdb", "")
            self._blob = open_blob_source(self.root, name)

        tf_list = cfg.get(f"{split}_transforms")
        self.host_tf, self.device_tf = build_transforms(tf_list)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, index):
        return self.images[index], self.targets[index]

    def _resample(self, list_file, frames_per_video):
        """Cap frames per video, grouping by parent directory
        (abstract_dataset.py:50-69)."""
        video_dict: dict[str, list] = {}
        for i in list_file:
            name = i.split(" ")[0]
            video_dict.setdefault(name.rsplit("/", 1)[0], []).append(i)
        out = []
        for frames in video_dict.values():
            if len(frames) <= frames_per_video:
                out.extend(frames)
            else:
                pick = self.rng.choice(frames, frames_per_video, replace=False)
                out.extend(sorted(pick, key=lambda s: s.split(" ")[0]))
        return out

    @staticmethod
    def _add_face_margin(x, y, w, h, margin=0.5):
        xm = int(w * margin / 2)
        ym = int(h * margin / 2)
        return x - xm, x + w + xm, y - ym, y + h + ym

    def _convert_to_str(self, img_path, feature, postfix="jpg"):
        """Rewrite a frame path to its stored pre-cropped variant
        (abstract_dataset.py:83-99: per-FAS-dataset naming conventions)."""
        rules = [
            ("replayattack", f"replayattack_{feature}"),
            ("CASIA_database", f"CASIA_database_{feature}"),
            ("MSU-MFSD", f"MSU-MFSD_{feature}"),
            ("Oulu_NPU", f"Oulu_NPU_{feature}"),
        ]
        out_path = None
        for needle, repl in rules:
            if needle in img_path:
                out_path = img_path.replace(needle, repl)
                break
        if out_path is None:
            if "HQ_WMCA" in img_path or "Siw-MV2" in self.root:
                out_path = img_path.replace(".jpg", f"_{feature}.jpg")
            else:
                raise ValueError(f"Image path not recognised: {img_path}")
        return out_path.replace(".jpg", f".{postfix}")

    def _read_blob(self, img_path: str) -> bytes:
        if self.use_lmdb:
            crop_path = self._convert_to_str(img_path, "crop")
            buf = self._blob.get(crop_path)
            if buf is None:
                raise KeyError(f"Blob missing for key {crop_path}")
            return buf
        with open(join(self.root, img_path), "rb") as f:
            return f.read()

    def _resolve_margin(self, margin):
        """Draw ONE random margin per load_item batch: the reference draws on
        the first 4p item and then rebinds the tuple argument to that float,
        so every later item of the call reuses it
        (abstract_dataset.py:126-135)."""
        if margin is None or isinstance(margin, float):
            return margin
        lo, hi = int(margin[0] * 10), int(margin[1] * 10)
        return int(self.rng.integers(lo, hi)) / 10.0

    def _box_for(self, contents, margin, crop):
        """(x1, y1, x2, y2) crop rectangle; (-1,)*4 = full frame."""
        if crop == "4p":
            x, y, w, h = (int(v) for v in contents[2:6])
            if not isinstance(margin, float):
                margin = self._resolve_margin(margin)
            x1, x2, y1, y2 = self._add_face_margin(x, y, w, h, margin)
            return (x1, y1, x2, y2)
        if crop == "nocrop":
            return (-1, -1, -1, -1)
        raise ValueError(f"Unsupported crop version '{crop}'")

    def load_item(self, items, labels, margin=None, crop="4p"):
        """Decode + crop + resize a batch on the host: one call of the host
        JPEG library for the whole batch."""
        paths, contents_list = [], []
        for item in items:
            contents = str(item).split(" ")
            paths.append(contents[0])
            contents_list.append(contents)

        if crop == "4p":
            margin = self._resolve_margin(margin)  # one draw per batch
        blobs = [self._read_blob(p) for p in paths]
        boxes = np.asarray([self._box_for(c, margin, crop) for c in contents_list], np.int32)
        images = decode_batch(blobs, boxes, self.host_tf.height, self.host_tf.width)
        return {"images": images, "path": paths}


class FaceForensics(AbstractDataset):
    """FF++ (dataset/faceforensics.py): pickle index per split+compression,
    filtered by method list; label 0 iff 'original_sequences' in path."""

    METHOD = ["Origin", "Deepfakes", "Face2Face", "FaceSwap", "NeuralTextures",
              "FaceShifter", "DeeperForensics"]
    SPLITS = ["train", "val", "test"]

    def __init__(self, cfg: dict, split: str, seed: int = 2022):
        if split not in self.SPLITS:
            raise ValueError(f"split must be one of {self.SPLITS}")
        for m in cfg["method"]:
            if m not in self.METHOD:
                raise ValueError(f"method must be in {self.METHOD}, got {m}")
        super().__init__(cfg, split, seed)
        self.categories = ["original", "fake"]
        fpv = cfg.get(f"{split}_fpv")
        pre = _load_index(join(self.root, "pickle_files",
                               f"{split}_{cfg['compression']}.pickle"))
        indices = []
        for path, _ in pre:
            if self.METHOD[0] in cfg["method"] and "original" in path:
                indices.append(path)
            for m in self.METHOD[1:]:
                if m in cfg["method"] and m in path:
                    indices.append(path)
        if fpv is not None:
            indices = self._resample(indices, fpv)
        self.images = indices
        self.targets = [0 if "original_sequences" in p else 1 for p in indices]


def _not_ported(name):
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"Dataset '{name}' is not ported to unidefense_torch yet "
                                  "(ROADMAP.md queue 3)")
    return refuse


LOADERS = {
    "FFpp": FaceForensics,
    "CDF": _not_ported("CDF"),
    "WDF": _not_ported("WDF"),
    "OCIM": _not_ported("OCIM"),
    "UniAttack": _not_ported("UniAttack"),
}


def get_dataset(name: str = "FFpp"):
    if name not in LOADERS:
        raise KeyError(f"Dataset '{name}' not found; available: {sorted(LOADERS)}")
    return LOADERS[name]
