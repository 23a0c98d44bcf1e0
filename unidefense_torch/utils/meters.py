"""Training meters and timers (unidefense_tpu/utils/meters.py:75-187;
utils/misc.py:25-117 of the reference)."""

from __future__ import annotations

import sys
import time

import torch


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
    one-logit head."""

    def __init__(self):
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
        host = self._sums.cpu().tolist()
        n = max(float(self._count), 1.0)
        return {
            "means": {k: v / n for k, v in zip(self._keys, host)},
            "acc": host[-1] / max(float(self._total), 1.0),
            "count": self._count,
        }
