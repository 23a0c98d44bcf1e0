"""Visualisation helpers (unidefense_tpu/utils/visualize.py:12-64):
reconstruction-vs-input figures and image export. matplotlib is imported
when a figure is drawn.

Parity targets: plot_figure (engine/abstract_engine.py:451-486) and the image
utilities in utils/operation.py:48-68, on NHWC numpy arrays.
"""

from __future__ import annotations

import numpy as np


def norm_image(image: np.ndarray, min_zero: bool = False) -> np.ndarray:
    """Normalize a batch to [-1, 1] (or [0, 1]) per sample
    (utils/operation.py:48-58)."""
    n = image.shape[0]
    flat = image.reshape(n, -1)
    mx = flat.max(axis=1).reshape(n, 1, 1, 1)
    mn = flat.min(axis=1).reshape(n, 1, 1, 1)
    out = (image - mn) / (mx - mn + 1e-5)
    if not min_zero:
        out = out * 2.0 - 1.0
    return out


def save_image(image_hwc: np.ndarray, path: str):
    """Save one HWC image (utils/operation.py:61-68)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(image_hwc)
    img = (img - img.min()) / (img.max() - img.min() + 1e-5)
    plt.imsave(path, np.squeeze(img))


def plot_recon_figure(images, items, pred, gt, categories=None):
    """Grid figure of 4 samples per item row (inputs / reconstructions) with
    prediction captions (engine/abstract_engine.py:451-486). images: sequence
    of HWC arrays, len == 4 * len(items)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(dpi=200)
    pred = np.asarray(pred).argmax(1)
    if categories is not None:
        pred = [categories[int(i)] for i in pred]
        gt = [categories[int(i)] for i in np.asarray(gt).astype(int)]
    num_row = len(items)
    assert len(images) == 4 * num_row, "display 4 samples per item"
    plt.title(f"pred: {pred}\ngt: {gt}\nitem: {items}")
    for i in range(num_row):
        for j in range(4):
            ax = fig.add_subplot(num_row, 4, i * 4 + j + 1)
            ax.axis("off")
            img = np.asarray(images[i * 4 + j], np.float32)
            img = np.clip(img, img.min(), img.max())
            img = (img - img.min()) / (img.max() - img.min() + 1e-5)
            ax.imshow(np.squeeze(img))
    plt.axis("off")
    plt.close(fig)
    return fig
