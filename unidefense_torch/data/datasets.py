"""Dataset index loaders and host-side item loading
(unidefense_tpu/data/datasets.py:33-226,336-525,537).

Each dataset builds (images, targets) lists of path strings and int labels
from the on-disk index artifacts the reference consumes (pickles), and
exposes:

* __getitem__(i) -> (path_string, target)        (abstract_dataset.py:45-48)
* load_item(items, labels, margin, crop) -> {'images': uint8 NHWC numpy,
  'path': [...]}: decode + face-crop + resize on the host, in one call of
  the host JPEG library per batch (data/native.py); normalisation and flip
  run later on the card (data/transforms.DevicePipeline, K1). It is
  ``finish_item(plan_item(...))``: ``plan_item`` makes every random draw of
  the batch (the margin, the host stage's draws), so a caller that loads
  batches on worker threads plans them on its own thread in batch order and
  hands only ``finish_item`` (blob reads, decode, the corruptions) to the
  pool.

Ported: FF++ (``FFpp``), Celeb-DF v2 (``CDF``), WildDeepfake (``WDF``),
OCIM (``OCIM``: Oulu-NPU, CASIA-FASD, Idiap Replay-Attack and MSU-MFSD,
face crops from 5-point boxes) and UniAttack (``UniAttack``: FF++,
Celeb-DF, Seq-DeepFake, HQ-WMCA, Oulu-NPU and SiW-Mv2, one blob store each,
frames of several sizes in one batch). Frames are JPEG or PNG (Celeb-DF's
are PNG); the host library decodes both and refuses any other format.
Blob storage: files under ``root``, a FrameStore (.udb) or LMDB
(data/store.open_blob_source).
"""

from __future__ import annotations

import copy
import functools
import os
import pickle
from glob import glob
from os.path import join

import numpy as np
import torch

from unidefense_torch.data.native import decode_batch, jpeg_dims
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

    def _plan(self, paths: list, boxes: np.ndarray, read, **out) -> dict:
        """The host stage's draws for a batch, made here on the calling
        thread, frame by frame in item order as the JAX stage makes them
        (the RandomResizedCrop box, then the OneOf, then ImageCompression).
        The RandomResizedCrop box needs the frame's size: the blobs are
        read here and their headers give it, the face box clamped to the
        frame as the JAX package's ``_crop`` slices it (the whole frame for
        x2 <= x1), and the library is later handed the composed box.
        ``read`` maps a path to its blob; ``out`` rides along to the
        result of :meth:`finish_item`."""
        host = self.host_tf
        blobs, draws = None, None
        if not host.is_plain_resize:
            if host.rrc_scale is not None:
                blobs = [read(p) for p in paths]
                dims = jpeg_dims(blobs)
            boxes, draws = boxes.copy(), []
            for i, (x1, y1, x2, y2) in enumerate(boxes.tolist()):
                if blobs is None:
                    draws.append(host.draw())
                    continue
                h, w = dims[i].tolist()
                if x2 <= x1:
                    x1, y1, x2, y2 = 0, 0, w, h
                else:
                    x1, y1, x2, y2 = max(0, x1), max(0, y1), min(w, x2), min(h, y2)
                draw = host.draw(y2 - y1, x2 - x1)
                bx1, by1, bx2, by2 = draw[0]
                boxes[i] = (x1 + bx1, y1 + by1, x1 + bx2, y1 + by2)
                draws.append(draw)
        return dict(out, path=paths, _read=read, _blobs=blobs, _boxes=boxes, _draws=draws)

    def finish_item(self, plan: dict) -> dict:
        """A planned batch (:meth:`plan_item`) decoded, cropped and resized
        in one call of the host JPEG library, then the host stage's
        corruptions; draws nothing, so worker threads may run it in any
        order."""
        host = self.host_tf
        out = {k: v for k, v in plan.items() if not k.startswith("_")}
        blobs = plan["_blobs"]
        if blobs is None:
            blobs = [plan["_read"](p) for p in plan["path"]]
        images = decode_batch(blobs, plan["_boxes"], host.height, host.width,
                              interp=host.interpolation)
        if plan["_draws"] is not None:
            images = host.apply(images, plan["_draws"])
        return dict(out, images=images)

    def plan_item(self, items, labels, margin=None, crop="4p") -> dict:
        """Every draw of :meth:`load_item`: the batch's margin, then the
        host stage's (:meth:`_plan`)."""
        paths, contents_list = [], []
        for item in items:
            contents = str(item).split(" ")
            paths.append(contents[0])
            contents_list.append(contents)

        if crop == "4p":
            margin = self._resolve_margin(margin)  # one draw per batch
        boxes = np.asarray([self._box_for(c, margin, crop) for c in contents_list], np.int32)
        return self._plan(paths, boxes, self._read_blob)

    def load_item(self, items, labels, *args, **kwargs):
        """Decode + crop + resize a batch on the host: one call of the host
        JPEG library for the whole batch. Takes :meth:`plan_item`'s
        arguments."""
        return self.finish_item(self.plan_item(items, labels, *args, **kwargs))


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


class CelebDF(AbstractDataset):
    """Celeb-DF v2 (unidefense_tpu/data/datasets.py:228-263; the reference's
    dataset/celeb_df.py): the test videos are those List_of_testing_videos.txt
    names, training takes the rest; the frames are the PNG files under
    ``<method>/images/<video>/``; label 0 iff "real" is in the path.

    The JAX class builds its index from sets and unsorted globs, so its
    order, and with ``<split>_fpv`` its pick, follows the hash seed and the
    directory listing. Here videos and frames are sorted, so the index and
    the pick are repeatable from the seed. ``root`` is made absolute: the
    items are root-joined paths, read as they are."""

    METHOD = ["YouTube-real", "Celeb-real", "Celeb-synthesis"]
    SPLITS = ["train", "test"]

    def __init__(self, cfg: dict, split: str, seed: int = 2022):
        if split not in self.SPLITS:
            raise ValueError(f"split must be one of {self.SPLITS}")
        cfg = dict(cfg, root=os.path.abspath(cfg["root"]))
        super().__init__(cfg, split, seed)
        self.categories = ["original", "fake"]
        self.fpv = cfg.get(f"{split}_fpv")
        test_ids = {m: set() for m in self.METHOD}
        with open(join(self.root, "List_of_testing_videos.txt"), encoding="utf-8") as f:
            for line in f:
                name = line.split(" ")[-1]
                number = name.split("/")[-1].split(".")[0]
                for m in self.METHOD:
                    if m in name:
                        test_ids[m].add(number)
        images = []
        for m in cfg["method"]:
            videos = set(os.listdir(join(self.root, m, "images")))
            videos = test_ids[m] if split == "test" else videos - test_ids[m]
            for vid in sorted(videos):
                images.extend(sorted(glob(join(self.root, m, "images", vid, "*.png"))))
        if self.fpv is not None:
            images = self._resample(images, self.fpv)
        self.images = images
        self.targets = [0 if "real" in p else 1 for p in images]


class WildDeepfake(AbstractDataset):
    """WildDeepfake (unidefense_tpu/data/datasets.py:266-283; the reference's
    dataset/wild_deepfake.py): a ``<split>/<method>.pickle`` index of
    split-relative frame paths per method; ``__getitem__`` returns them
    joined to ``root/split`` (``root`` made absolute, as in
    :class:`CelebDF`)."""

    SPLITS = ["train", "test"]

    def __init__(self, cfg: dict, split: str, seed: int = 2022):
        if split not in self.SPLITS:
            raise ValueError(f"split must be one of {self.SPLITS}")
        cfg = dict(cfg, root=os.path.abspath(cfg["root"]))
        super().__init__(cfg, split, seed)
        self.categories = ["original", "fake"]
        fpv = cfg.get(f"{split}_fpv")
        for m in cfg["method"]:
            imgs = _load_index(join(self.root, split, f"{m}.pickle"))
            if fpv is not None:
                imgs = self._resample(imgs, fpv)
            self.images.extend(imgs)
            self.targets.extend([0 if m == "real" else 1] * len(imgs))

    def __getitem__(self, index):
        return join(self.root, self.split, self.images[index]), self.targets[index]


class OCIMSubDataset(AbstractDataset):
    """One (domain, label) slice of the OCIM anti-spoofing protocol
    (dataset/ocim.py:11-50): 5-point box list pickles under
    <root>/<domain_root>/lists/."""

    DATASETS = ["O", "C", "I", "M"]
    SPLITS = ["train", "dev", "test"]
    LABELS = ["real", "fake", "both"]

    def __init__(self, cfg: dict, split: str, label: str, seed: int = 2022):
        if split not in self.SPLITS:
            raise ValueError(f"split must be one of {self.SPLITS}")
        if label not in self.LABELS:
            raise ValueError(f"label must be one of {self.LABELS}")
        dataset = cfg[split + "_dataset"]
        if dataset not in self.DATASETS:
            raise ValueError(f"dataset must be one of {self.DATASETS}")
        super().__init__(cfg, split, seed)
        self.categories = ["real", "attack"]
        lists_dir = join(self.root, cfg[dataset + "_root"], "lists")
        fpv = cfg.get(f"{split}_fpv")
        for lb in ["real", "fake"] if label == "both" else [label]:
            lst = _load_index(join(lists_dir, f"{lb}_5points.pickle"))
            if fpv is not None:
                lst = self._resample(lst, fpv)
            self.images.extend(lst)
            self.targets.extend([0 if lb == "real" else 1] * len(lst))


class OCIMDataset:
    """A real and a fake sub-dataset per source domain (dataset/ocim.py:
    52-60): even index real, odd fake, the order the OCIM engine's streams
    follow (engine/ocim_engine.py:245-252)."""

    def __init__(self, cfg: dict, split: str, seed: int = 2022):
        self.datasets = []
        domains = cfg[split + "_dataset"]
        self.num_domains = len(domains)
        for ds in domains:
            ds_cfg = copy.deepcopy(cfg)
            ds_cfg[split + "_dataset"] = ds
            self.datasets.append(OCIMSubDataset(ds_cfg, split, "real", seed))
            self.datasets.append(OCIMSubDataset(ds_cfg, split, "fake", seed))


class UniAttack(AbstractDataset):
    """The UniAttack benchmark (unidefense_tpu/data/datasets.py:336-525; the
    reference's dataset/uniattack.py): six sub-datasets, each its own blob
    store under its ``<subset>_root``, 22 method tags, per-split real and
    fake fpv, and the Protocol I ``distorted`` test corruption (the host
    OneOf, on the test split only)."""

    METHOD = [
        "FFpp-DF", "FFpp-F2F", "FFpp-FS", "FFpp-NT", "FFpp-Real",
        "CDF-Fake", "CDF-Real",
        "SeqDF-Fake", "SeqDF-Real",
        "HQ-Flexiblemask", "HQ-Glasses", "HQ-Makeup", "HQ-Mannequin",
        "HQ-Papermask", "HQ-Replay", "HQ-Rigidmask", "HQ-Tattoo", "HQ-Real",
        "OULU-Fake", "OULU-Real",
        "SiWMv2-Fake", "SiWMv2-Real",
    ]
    SPLITS = ["train", "val", "test"]
    SUBSETS = {
        "FFpp": "FaceForensics++",
        "CDF": "Celeb-DF",
        "SeqDF": "Seq-DeepFake",
        "HQ": "HQ_WMCA",
        "OULU": "Oulu_NPU",
        "SiWMv2": "SiW-Mv2",
    }

    def __init__(self, cfg: dict, split: str, methods: list, seed: int = 2022):
        if split not in self.SPLITS:
            raise ValueError(f"split must be one of {self.SPLITS}")
        for m in methods:
            if m not in self.METHOD:
                raise ValueError(f"method must be in METHOD, got {m}")
        # no single blob store: UniAttack keys its blobs per sub-dataset
        # root (dataset/uniattack.py:60-82)
        self.cfg = cfg
        self.split = split
        self.root = cfg["root"]
        self.use_lmdb = True
        self.images, self.targets = [], []
        self.rng = LockedRNG(seed)
        self.categories = ["original", "fake"]

        self.roots = {k: cfg.get(f"{k}_root") for k in self.SUBSETS}
        self._blobs = {k: open_blob_source(self.roots[k], store)
                       for k, store in self.SUBSETS.items() if self.roots[k] is not None}

        distorted = split == "test" and cfg.get("distorted", False)
        self.host_tf, self.device_tf = build_transforms(cfg.get(f"{split}_transforms"),
                                                        corrupt_distorted=distorted)
        self.real_fpv = cfg.get(f"{split}_real_fpv")
        self.fake_fpv = cfg.get(f"{split}_fake_fpv")
        for method in methods:
            ds, me = method.split("-")
            img, tgt = getattr(self, f"_load_{ds.lower()}")(me)
            self.images.extend(img)
            self.targets.extend(tgt)

    # --- per-subset path routing (dataset/uniattack.py:150-198) ---

    @staticmethod
    def _subset_of(img_path: str) -> str:
        if "manipulated_sequences" in img_path or "original_sequences" in img_path:
            return "FFpp"
        if "Celeb-real" in img_path or "Celeb-synthesis" in img_path or "YouTube-real" in img_path:
            return "CDF"
        if "Seq-DeepFake" in img_path:
            return "SeqDF"
        if "Oulu_NPU" in img_path:
            return "OULU"
        if "HQ_WMCA" in img_path:
            return "HQ"
        if "SiW-Mv2" in img_path:
            return "SiWMv2"
        raise ValueError(f"Image path not recognised: {img_path}")

    def _convert_to_str(self, img_path, feature, postfix="jpg"):
        """The stored variant's key: FF++ and Celeb-DF paths unchanged, the
        spoofing sources with ``_<feature>`` in each one's own place."""
        sub = self._subset_of(img_path)
        if sub in ("FFpp", "CDF"):
            out = img_path
        elif sub in ("SeqDF", "SiWMv2"):
            out = img_path[:-4] + f"_{feature}.jpg"
        elif sub == "OULU":
            out = img_path.replace("Oulu_NPU", f"Oulu_NPU_{feature}")
        else:  # HQ
            out = img_path.replace(".jpg", f"_{feature}.jpg")
        return out.replace(".jpg", f".{postfix}")

    def _read_blob_ua(self, img_path: str, crop: str) -> bytes:
        """The blob of a frame from its sub-dataset's store: the ``_crop``
        key when the config's crop is ``nocrop`` (whatever the item's own
        crop), else the path itself."""
        key = self._convert_to_str(img_path, "crop") if crop == "nocrop" else img_path
        buf = self._blobs[self._subset_of(img_path)].get(key)
        if buf is None:
            raise KeyError(f"Blob missing for key {key}")
        return buf

    def plan_item(self, items, labels, margin=None, crop="nocrop", dataset_label_map=None):
        """The draws of a batch of mixed sources (:meth:`_plan`), decoded
        later in one call of the host JPEG library. FF++ and Celeb-DF frames
        are stored cropped and are never cropped again; a margin is drawn
        once per batch only if some item is cropped 4p. ``dataset_labels``
        are the items' domain ids (int64) under ``dataset_label_map``, else
        None."""
        paths, contents_list, dlabels, eff_crops = [], [], [], []
        for item in items:
            contents = str(item).split(" ")
            paths.append(contents[0])
            contents_list.append(contents)
            sub = self._subset_of(contents[0])
            if dataset_label_map is not None:
                dlabels.append(dataset_label_map[self.roots[sub]])
            eff_crops.append("nocrop" if sub in ("FFpp", "CDF") else crop)

        if any(ec == "4p" for ec in eff_crops):
            margin = self._resolve_margin(margin)  # one draw per batch
        boxes = np.asarray([self._box_for(c, margin, ec)
                            for c, ec in zip(contents_list, eff_crops)], np.int32)
        return self._plan(paths, boxes, functools.partial(self._read_blob_ua, crop=crop),
                          dataset_labels=np.asarray(dlabels, np.int64) if dlabels else None)

    # --- per-subset index loaders (dataset/uniattack.py:296-420) ---

    def _finish(self, indices, method):
        fpv = self.real_fpv if method == "Real" else self.fake_fpv
        if fpv is not None:
            indices = self._resample(indices, fpv)
        return indices, [0 if method == "Real" else 1] * len(indices)

    def _load_ffpp(self, method):
        tag = {"DF": "Deepfakes", "F2F": "Face2Face", "FS": "FaceSwap",
               "NT": "NeuralTextures", "Real": "original_sequences"}[method]
        pre = _load_index(join(self.roots["FFpp"], "pickle_files", f"{self.split}_c23.pickle"))
        return self._finish([p for p, _ in pre if tag in p], method)

    def _load_cdf(self, method):
        cand = _load_index(join(self.roots["CDF"], "pickle_files", f"{self.split}.pickle"))
        if method == "Real":
            idx = [p for p in cand if "YouTube-real" in p or "Celeb-real" in p]
        else:
            idx = [p for p in cand if "Celeb-synthesis" in p]
        return self._finish(idx, method)

    def _load_seqdf(self, method):
        idx = _load_index(join(self.roots["SeqDF"], "pickle_files",
                               f"{self.split}_{method.lower()}.pickle"))
        # frame-level: no fpv resampling (dataset/uniattack.py:336-343)
        return list(idx), [0 if method == "Real" else 1] * len(idx)

    def _load_hq(self, method):
        split_map = {"train": "train", "val": "dev", "test": "eval"}
        record = _load_index(join(self.roots["HQ"], "record.pickle"))
        protocol = join(self.roots["HQ"], "PROTOCOL-grand_test-curated.csv")
        with open(protocol, encoding="utf-8") as f:
            lines = [ln.strip().split(",") for ln in f]
        want = "0" if method == "Real" else f"attack/{method}"
        col = 1 if method == "Real" else 2
        indices = []
        for r in lines:
            if r[col] == want and r[-1] == split_map[self.split]:
                indices.extend(record[r[0].split("/")[-1]])
        return self._finish(indices, method)

    def _load_oulu(self, method):
        split_map = {"train": "Train_files", "val": "Dev_files", "test": "Test_files"}
        lst = _load_index(join(self.roots["OULU"], "lists", f"{method.lower()}_5points.pickle"))
        return self._finish([p for p in lst if split_map[self.split] in p], method)

    def _load_siwmv2(self, method):
        label = "live" if method == "Real" else "all"
        idx = _load_index(join(self.roots["SiWMv2"], "lists",
                               f"{self.split.lower()}list_{label}.pickle"))
        return self._finish(list(idx), method)


LOADERS = {
    "FFpp": FaceForensics,
    "CDF": CelebDF,
    "WDF": WildDeepfake,
    "OCIM": OCIMDataset,
    "UniAttack": UniAttack,
}


def get_dataset(name: str = "FFpp"):
    if name not in LOADERS:
        raise KeyError(f"Dataset '{name}' not found; available: {sorted(LOADERS)}")
    return LOADERS[name]
