"""The port's metrics (unidefense_torch/utils/metrics.py: numpy ROC, AUC and
confusion matrix) against the JAX package's (sklearn.metrics), on seeded
scores with ties and lopsided classes: every float field within 1e-12,
every count exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidefense_torch.utils import metrics as tm
from unidefense_torch.utils.meters import DeviceMetricAccumulator
from unidefense_tpu.utils import metrics as jm
from unidefense_tpu.utils.meters import DeviceMetricAccumulator as JaxDeviceMetricAccumulator

# (seed, frames, share of fakes, decimals the scores are rounded to: ties)
CASES = [(0, 64, 0.5, None), (1, 97, 0.5, 2), (2, 120, 0.1, 1), (3, 50, 0.9, 2),
         (4, 33, 0.3, None), (5, 200, 0.5, 3)]
COUNTS = ("NumP", "NumN")


def _scores(seed, n, fake_share, decimals):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < fake_share).astype(np.int64)
    y[:2] = (0, 1)  # both classes
    # P(real): higher for reals, with overlap
    s = np.clip(0.5 + 0.25 * (1 - 2 * y) + 0.3 * rng.standard_normal(n), 0.0, 1.0)
    if decimals is not None:
        s = np.round(s, decimals)
    return y, s


@pytest.mark.parametrize("threshold", [0.5, "auto", "best"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}-n{c[1]}")
def test_cal_metrics_matches_jax(case, threshold):
    y, s = _scores(*case)
    got = tm.cal_metrics(y, s, threshold=threshold)
    ref = jm.cal_metrics(y, s, threshold=threshold)
    assert set(got) == set(ref)
    for k, r in ref.items():
        if k in COUNTS:
            assert got[k] == r, k
        else:
            np.testing.assert_allclose(float(got[k]), float(r), rtol=0, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("drop_intermediate", [True, False])
@pytest.mark.parametrize("pos_label", [0, 1])
def test_roc_curve_and_auc_match_sklearn(pos_label, drop_intermediate):
    from sklearn.metrics import auc, roc_curve

    for case in CASES:
        y, s = _scores(*case)
        got = tm.roc_curve(y, s, pos_label=pos_label, drop_intermediate=drop_intermediate)
        ref = roc_curve(y, s, pos_label=pos_label, drop_intermediate=drop_intermediate)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        assert tm.auc(got[0], got[1]) == pytest.approx(auc(ref[0], ref[1]), abs=1e-12)


def test_confusion_matrix_matches_sklearn():
    from sklearn.metrics import confusion_matrix

    rng = np.random.default_rng(9)
    y, p = rng.integers(0, 2, 77), rng.integers(0, 2, 77)
    np.testing.assert_array_equal(tm.confusion_matrix(y, p, labels=[0, 1]),
                                  confusion_matrix(y, p, labels=[0, 1]))


def _frames(seed):
    rng = np.random.default_rng(seed)
    vids = [f"root/{'original' if v % 2 == 0 else 'fake'}/{v:03d}" for v in range(7)]
    paths, probs, tgts = [], [], []
    for i in rng.permutation(40):
        v = vids[i % 7]
        paths.append(f"{v}/{i:04d}.jpg")
        probs.append(float(rng.random()))
        tgts.append(float(v.split("/")[1] == "fake"))
    return paths, probs, tgts


def test_aggregate_video_and_merge_match_jax():
    paths, probs, tgts = _frames(3)
    assert tm.aggregate_video(paths, probs, tgts) == jm.aggregate_video(paths, probs, tgts)
    halves = []
    for part in (slice(0, 17), slice(17, None)):
        pd, td = {}, {}
        for p, pr, tg in zip(paths[part], probs[part], tgts[part]):
            pd.setdefault(p.rsplit("/", 1)[0], []).append(pr)
            td.setdefault(p.rsplit("/", 1)[0], []).append(tg)
        halves.append((pd, td))
    pds, tds = [h[0] for h in halves], [h[1] for h in halves]
    assert tm.merge_video_dicts(pds, tds) == jm.merge_video_dicts(pds, tds)


@pytest.mark.parametrize("logits", [2, 1], ids=["argmax", "sigmoid"])
def test_device_metric_accumulator_matches_jax(logits):
    """Running means and accuracy over 5 steps, against the JAX package's
    accumulator (argmax, or sigmoid >= 0.5 for a one-logit head)."""
    rng = np.random.default_rng(logits)
    got, ref = DeviceMetricAccumulator(), JaxDeviceMetricAccumulator()
    assert got.snapshot() == {"means": {}, "acc": 0.0, "count": 0}
    for _ in range(5):
        metrics = {k: np.float32(rng.standard_normal()) for k in ("total_loss", "cls_loss")}
        cls_out = rng.standard_normal((6, logits)).astype(np.float32)
        labels = rng.integers(0, 2, 6)
        got.update({k: torch.tensor(v) for k, v in metrics.items()}, torch.from_numpy(cls_out),
                   torch.from_numpy(labels))
        ref.update({k: jnp.asarray(v) for k, v in metrics.items()}, jnp.asarray(cls_out),
                   jnp.asarray(labels))
    g, r = got.snapshot(), ref.snapshot()
    assert g["count"] == r["count"] == 5 and g["acc"] == pytest.approx(r["acc"], abs=1e-12)
    assert set(g["means"]) == set(r["means"])
    for k, v in r["means"].items():
        assert g["means"][k] == pytest.approx(v, rel=1e-6), k
