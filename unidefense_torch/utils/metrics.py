"""Evaluation metrics on the host (unidefense_tpu/utils/metrics.py:19-132),
with no sklearn.

Output parity with the reference's utils/statistic.py:33-74: AUC, EER (via
brentq root of 1-x-interp(tpr)(x)), threshold modes (float / 'auto' = EER
threshold / 'best' = min-ACER sweep), ACC, APCER/BPCER/ACER(=HTER), TP/TN
ratios, and TPR@{1,5}%FPR. Scores are P(real) and the ROC uses pos_label=0,
i.e. real is the positive class, as the reference does
(engine/forgery_engine.py:350). ``roc_curve``, ``auc`` and the 2x2
confusion matrix are numpy versions of sklearn.metrics', so the port needs
no sklearn: the same points, ``drop_intermediate`` and thresholds (the
first one +inf).
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import interp1d
from scipy.optimize import brentq


def roc_curve(y_true, y_score, pos_label=1, drop_intermediate=True):
    """sklearn.metrics.roc_curve for binary labels, no sample weights:
    (fpr, tpr, thresholds), thresholds decreasing from +inf."""
    y_true = np.ravel(y_true) == pos_label
    y_score = np.ravel(y_score)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[order]
    y_true = y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx - tps
    thresholds = y_score[idx]
    if drop_intermediate and len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def auc(x, y):
    """sklearn.metrics.auc: trapezoidal area under a monotonic curve."""
    x, y = np.asarray(x), np.asarray(y)
    dx = np.diff(x)
    direction = 1
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
        direction = -1
    return float(direction * np.trapezoid(y, x))


def confusion_matrix(y_true, y_pred, labels=(0, 1)):
    """Counts [i, j] of true label labels[i] predicted as labels[j]."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return np.array([[int(np.sum((y_true == a) & (y_pred == b))) for b in labels]
                     for a in labels], dtype=np.int64)


def get_tpr_at_fpr(tpr_lst, fpr_lst, score_lst, fpr_value):
    """TPR and threshold at (the closest available) FPR value
    (utils/statistic.py:7-13)."""
    abs_fpr = np.absolute(fpr_lst - fpr_value)
    idx_min = np.argmin(abs_fpr)
    fpr_target = fpr_lst[idx_min]
    idx = np.max(np.where(fpr_lst == fpr_target))
    return tpr_lst[idx], score_lst[idx]


def find_best_threshold(y_trues, y_preds):
    """Sweep unique scores minimizing ACER (utils/statistic.py:16-30)."""
    best_thre = 0.5
    best_metrics = None
    for thre in np.unique(np.sort(y_preds)):
        metrics = cal_metrics(y_trues, y_preds, threshold=float(thre))
        if best_metrics is None or metrics["ACER"] < best_metrics["ACER"]:
            best_metrics = metrics
            best_thre = float(thre)
    return best_thre, best_metrics


def cal_metrics(y_trues, y_preds, threshold=0.5):
    """Compute the full metric dict (utils/statistic.py:33-74).

    y_trues: 0 = real, 1 = fake. y_preds: P(real). threshold: float, 'auto'
    (use the EER threshold) or 'best' (min-ACER sweep).
    """
    y_trues = np.asarray(y_trues)
    y_preds = np.asarray(y_preds)
    metrics = {}

    fpr, tpr, thresholds = roc_curve(y_trues, y_preds, pos_label=0)
    metrics["AUC"] = auc(fpr, tpr)
    metrics["EER"] = brentq(lambda x: 1.0 - x - interp1d(fpr, tpr)(x), 0.0, 1.0)
    metrics["Thre"] = float(interp1d(fpr, thresholds)(metrics["EER"]))

    if threshold == "best":
        _, best_metrics = find_best_threshold(y_trues, y_preds)
        return best_metrics
    elif threshold == "auto":
        threshold = metrics["Thre"]
    else:
        metrics["Thre"] = threshold

    prediction = 1 - (y_preds > threshold).astype(int)

    res = confusion_matrix(y_trues, prediction, labels=[0, 1])
    TP, FN = res[0, :]
    FP, TN = res[1, :]
    metrics["ACC"] = (TP + TN) / len(y_trues)
    metrics["TP_Ratio"] = float(TP / (TP + FN)) if (TP + FN) else 0.0
    metrics["NumP"] = int(TP + FN)
    metrics["TN_Ratio"] = float(TN / (TN + FP)) if (TN + FP) else 0.0
    metrics["NumN"] = int(TN + FP)
    metrics["APCER"] = float(FP / (TN + FP)) if (TN + FP) else 0.0
    metrics["BPCER"] = float(FN / (FN + TP)) if (FN + TP) else 0.0
    metrics["ACER"] = (metrics["APCER"] + metrics["BPCER"]) / 2

    tpr_01, _ = get_tpr_at_fpr(tpr, fpr, thresholds, 0.01)
    tpr_05, _ = get_tpr_at_fpr(tpr, fpr, thresholds, 0.05)
    metrics["TPR1%"] = tpr_01
    metrics["TPR5%"] = tpr_05
    return metrics


def aggregate_video(paths, probs, tgts):
    """Group frame scores by video id (parent directory of the frame path) and
    mean-pool per video (engine/abstract_engine.py:428-449).

    Returns dict with frame_prob/frame_tgt/video_prob/video_tgt lists.
    """
    prob_dict: dict[str, list] = {}
    tgt_dict: dict[str, list] = {}
    for p, pr, tg in zip(paths, probs, tgts):
        vid = p.rsplit("/", 1)[0]
        prob_dict.setdefault(vid, []).append(float(pr))
        tgt_dict.setdefault(vid, []).append(float(tg))
    video_prob, video_tgt, frame_prob, frame_tgt = [], [], [], []
    for key in prob_dict:
        video_prob.append(sum(prob_dict[key]) / len(prob_dict[key]))
        video_tgt.append(sum(tgt_dict[key]) / len(tgt_dict[key]))
        frame_prob.extend(prob_dict[key])
        frame_tgt.extend(tgt_dict[key])
    return {
        "video_prob": video_prob,
        "video_tgt": video_tgt,
        "frame_prob": frame_prob,
        "frame_tgt": frame_tgt,
    }


def merge_video_dicts(prob_dicts, tgt_dicts):
    """Merge per-process video score dicts then aggregate
    (engine/abstract_engine.py:383-426)."""
    final_prob: dict[str, list] = {}
    final_tgt: dict[str, list] = {}
    for pd, td in zip(prob_dicts, tgt_dicts):
        for k, v in pd.items():
            final_prob.setdefault(k, []).extend(v)
        for k, v in td.items():
            final_tgt.setdefault(k, []).extend(v)
    video_prob, video_tgt, frame_prob, frame_tgt = [], [], [], []
    for key in final_prob:
        video_prob.append(sum(final_prob[key]) / len(final_prob[key]))
        video_tgt.append(sum(final_tgt[key]) / len(final_tgt[key]))
        frame_prob.extend(final_prob[key])
        frame_tgt.extend(final_tgt[key])
    return {
        "video_prob": video_prob,
        "video_tgt": video_tgt,
        "frame_prob": frame_prob,
        "frame_tgt": frame_tgt,
    }
