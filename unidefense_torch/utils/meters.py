"""Training meters and timers (unidefense_tpu/utils/meters.py:36-187;
utils/misc.py:25-117 of the reference)."""

from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np
import torch


class AUCMeter:
    """Accumulates (score, label) pairs; their AUC and an ROC-curve dump
    (utils/misc.py:74-97), on the port's own ``utils.metrics.roc_curve`` and
    ``auc`` (sklearn's, with no sklearn)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.score = None
        self.true = None

    def update(self, score, true):
        score = np.asarray(score).reshape(-1)
        true = np.asarray(true).reshape(-1)
        self.score = score if self.score is None else np.concatenate([self.score, score])
        self.true = true if self.true is None else np.concatenate([self.true, true])

    def mean_auc(self) -> float:
        """sklearn's ``roc_auc_score`` of the pairs: the area under the ROC
        with label 1 positive."""
        from unidefense_torch.utils.metrics import auc, roc_curve

        fpr, tpr, _ = roc_curve(self.true, self.score, pos_label=1)
        return auc(fpr, tpr)

    def curve(self, prefix: str) -> None:
        """Print the EER and its threshold, and pickle [fpr, tpr,
        thresholds] to ``<prefix>/roc_curve.pickle``."""
        from scipy.interpolate import interp1d
        from scipy.optimize import brentq

        from unidefense_torch.utils.metrics import roc_curve

        fpr, tpr, thresholds = roc_curve(self.true, self.score, pos_label=1)
        eer = brentq(lambda x: 1.0 - x - interp1d(fpr, tpr)(x), 0.0, 1.0)
        thresh = interp1d(fpr, thresholds)(eer)
        print(f"# EER: {eer:.4f}(thresh: {float(thresh):.4f})")
        with open(os.path.join(prefix, "roc_curve.pickle"), "wb") as f:
            pickle.dump([fpr, tpr, thresholds], f)


class AverageMeter:
    """Running average (utils/misc.py:100-117)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / self.count


class Timer:
    """Elapsed / ETA timer (utils/misc.py:39-50)."""

    def __init__(self):
        self.o = time.time()

    def measure(self, p=1):
        x = int((time.time() - self.o) / p)
        if x >= 3600:
            return f"{x / 3600:.1f}h"
        if x >= 60:
            return f"{round(x / 60)}m"
        return f"{x}s"


class Logger:
    """Tee stdout to a records file (utils/misc.py:25-36)."""

    def __init__(self, filename):
        self.terminal = sys.stdout
        self.log = open(filename, "a")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self):
        pass


def center_print(content, around="*", repeat_around=10):
    print(repeat_around * around + f" {content} " + repeat_around * around)


class DeviceMetricAccumulator:
    """Every-step train metric averages with no host read per step.

    The reference updates its AverageMeters and AccMeter on every training
    step (engine/forgery_engine.py:285-297); reading the step's metrics on
    the host each step would wait for the card. The running sums stay on
    the metrics' device instead, as one fp32 vector (one entry per metric,
    then the count of correct classifications) that each step adds to
    asynchronously; ``snapshot()`` reads it in one transfer at log
    boundaries. Accuracy follows AccMeter: argmax, or sigmoid >= 0.5 for a
    one-logit head.

    With a process ``group`` (data parallelism) each snapshot sums the
    vector and the frame count over the ranks in one collective, so the
    accuracy is over every rank's frames, as the JAX engine's global
    ``cls_out`` gives it, and the means are over the ranks."""

    def __init__(self, group=None):
        self.group = group
        self._keys = None
        self._sums = None
        self._count = 0
        self._total = 0

    @torch.no_grad()
    def update(self, metrics: dict, cls_out: torch.Tensor, labels: torch.Tensor):
        if cls_out.shape[-1] == 1:
            pred = (torch.sigmoid(cls_out[:, 0].float()) >= 0.5).to(labels.dtype)
        else:
            pred = cls_out.argmax(-1).to(labels.dtype)
        if self._keys is None:
            self._keys = list(metrics)
            self._sums = torch.zeros(len(self._keys) + 1, dtype=torch.float32,
                                     device=cls_out.device)
        values = [metrics[k].float().reshape(()) for k in self._keys]
        values.append((pred == labels.to(pred.device)).sum().float())
        self._sums.add_(torch.stack(values))
        self._count += 1
        self._total += int(labels.shape[0])

    def snapshot(self) -> dict:
        """One host read: {'means': per-metric running means, 'acc': running
        accuracy, 'count': steps accumulated}."""
        if self._keys is None:
            return {"means": {}, "acc": 0.0, "count": 0}
        n = max(float(self._count), 1.0)
        if self.group is None:
            host = self._sums.cpu().tolist()
            total = float(self._total)
        else:
            import torch.distributed as dist

            summed = torch.cat([self._sums, self._sums.new_tensor([float(self._total)])])
            dist.all_reduce(summed, group=self.group)
            host = summed.cpu().tolist()
            total = host.pop()
            n *= dist.get_world_size(self.group)
        return {
            "means": {k: v / n for k, v in zip(self._keys, host)},
            "acc": host[-1] / max(total, 1.0),
            "count": self._count,
        }
