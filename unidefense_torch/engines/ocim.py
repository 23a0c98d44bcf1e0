"""OCIMEngine, cross-domain face anti-spoofing (the O/C/I/M protocol:
train on three of Oulu-NPU, CASIA-FASD, Idiap Replay-Attack and MSU-MFSD,
test on the fourth) (unidefense_tpu/engines/ocim.py:22-241; the reference's
engine/ocim_engine.py).

A real and a fake stream per source domain (even index real, odd fake,
:245-252), concatenated real streams first in domain order each step; a
face-crop margin drawn per batch from (0.0, 0.5) in training and 0.3 in
validation and test (:84-85); video-level validation at the EER threshold
(threshold='auto'); best checkpoint by max(AUC - HTER) (:393-397).

Resume restores the train state, the step, the best metrics and every
domain stream's selection (the streams are fast-forwarded), so a resumed
run trains on the same items from the same state as an uninterrupted one.
The stateful host draws (the margin, the RandomResizedCrop boxes) are not
replayed, in the JAX package either: resume is exact in selections and
state, not bit for bit in pixels.
"""

from __future__ import annotations

import numpy as np

from unidefense_torch.checkpoint import CheckpointManager
from unidefense_torch.config import load_dataset_config
from unidefense_torch.data.datasets import OCIMDataset, OCIMSubDataset
from unidefense_torch.data.pipeline import EpochSampler, InfiniteBatcher
from unidefense_torch.engines.base import OCIM_TRAIN_STREAM, AbstractEngine
from unidefense_torch.utils.meters import DeviceMetricAccumulator, Timer
from unidefense_torch.utils.metrics import cal_metrics


class OCIMEngine(AbstractEngine):
    engine_name = "OCIM"
    plateau_default_mode = "max"  # feeds AUC - HTER (higher is better)

    def _initiated_settings(self, model_cfg, data_cfg, config_cfg):
        pass

    def _train_settings(self, model_cfg, data_cfg, config_cfg):
        options = load_dataset_config(self.config)
        self._mprint(f"Using debug mode: {self.debug}.")

        self.train_set = OCIMDataset(options, split="train")
        self.num_train_domains = self.train_set.num_domains
        val_options = dict(options)
        val_options["test_dataset"] = options.get("test_dataset")[0]
        self.val_set = OCIMSubDataset(val_options, "test", "both")

        self.train_margin = tuple(config_cfg.get("train_margin", (0.0, 0.5)))
        self.val_margin = float(config_cfg.get("val_margin", 0.3))
        self.num_steps = options["num_steps"]
        self.log_steps = options["log_steps"]
        self.val_steps = options["val_steps"]
        self.crop = config_cfg.get("crop", "4p")
        self._mprint(f"crop: {self.crop}")
        self._setup_run_dir(options)

        bs = data_cfg["train_batch_size"]
        self.batchers = [
            InfiniteBatcher(sub, EpochSampler(len(sub), self._stream_batch(bs), shuffle=True,
                                              drop_last=True, **self._shard()),
                            load_kwargs={"margin": self.train_margin, "crop": self.crop})
            for sub in self.train_set.datasets
        ]
        self.val_batch_size = data_cfg.get("val_batch_size", 64)
        # bs real frames per real stream, bs fake per fake stream, real first;
        # validation preprocesses as test_transforms say (no flip), where the
        # JAX engine validates with the training stage's random flips
        # (ROADMAP.md section 3)
        per_label = bs * self.num_train_domains
        self._build_training(sum_real=per_label, sum_fake=per_label, num_steps=self.num_steps,
                             device_tf=self.train_set.datasets[0].device_tf,
                             eval_tf=self.val_set.device_tf)
        self._maybe_resume()

    def _test_settings(self, model_cfg, data_cfg, config_cfg):
        options = load_dataset_config(self.config)
        if isinstance(options.get("test_dataset"), list):
            options["test_dataset"] = options["test_dataset"][0]
        self.test_set = OCIMSubDataset(options, "test", "both")
        self.test_batch_size = data_cfg.get("test_batch_size", 96)
        self.test_margin = float(config_cfg.get("test_margin", 0.3))
        self.crop = config_cfg.get("crop", "4p")
        self._setup_test_dir(options)
        self._build_training(sum_real=1, sum_fake=1, num_steps=1,
                             device_tf=self.test_set.device_tf, train=False)
        self.ckpt = CheckpointManager(self.run_dir, self.dp)
        self.state, meta = self.ckpt.restore(self.state, best=True)
        self._mprint(
            f"Loaded best checkpoint: step {meta.get('best_step')}, "
            f"AUC {meta.get('best_auc', -1):.4f}, HTER {meta.get('best_hter', -1):.4f}"
        )

    def _select_batch(self, cur_step: int):
        return [b.select(cur_step) for b in self.batchers]

    def _load_batch(self, sels):
        """One batch per domain stream, the real streams then the fake ones
        in domain order (engine/ocim_engine.py:229-255), in one
        host-to-device copy."""
        outs = [b.load(sel) for b, sel in zip(self.batchers, sels)]
        real, fake = outs[0::2], outs[1::2]
        return self.assemble_batch(
            np.concatenate([o["images"] for o in real]), np.concatenate([o["label"] for o in real]),
            np.concatenate([o["images"] for o in fake]), np.concatenate([o["label"] for o in fake]),
        )

    def train(self):
        timer = Timer()
        train_meter = DeviceMetricAccumulator(self.dp.group)
        prefetch = self._make_prefetcher()
        self._install_preemption_handler()

        cur_step = self.start_step - 1
        try:
            for batch in prefetch:
                cur_step += 1
                self._profile_tick(cur_step)
                self.state, metrics, cls_out = self.train_step(
                    self.state, batch, self._step_generator(OCIM_TRAIN_STREAM, cur_step)
                )
                train_meter.update(metrics, cls_out, batch["label"])
                if cur_step % self.log_steps == 0 or cur_step % self.val_steps == 0:
                    snap = train_meter.snapshot()
                    iter_acc = snap["acc"]
                    if self.logger is not None and cur_step % self.log_steps == 0:
                        info = {"train/acc": iter_acc,
                                "train/lr": self._printed_lr(cur_step)}
                        info.update({f"train/{k}": v for k, v in snap["means"].items()})
                        self.logger.log(info, cur_step)
                    # the reference's OCIM line is the forgery engine's, field
                    # for field (engine/ocim_engine.py:291-298)
                    self._mprint(
                        "Train Iter (%d/%d), Loss %.4f, Triplet %.4f, Spat %.4f, Freq %.4f, ACC %.4f, LR %.6f"
                        % (cur_step, self.num_steps,
                           snap["means"].get("total_loss", 0.0),
                           snap["means"].get("triplet_loss", 0.0),
                           snap["means"].get("real_rec_loss", 0.0),
                           snap["means"].get("real_freq_loss", 0.0),
                           iter_acc, self._printed_lr(cur_step))
                    )
                if cur_step % self.val_steps == 0 and not self.debug:
                    self.validate(cur_step, timer)
                if self._graceful_stop(cur_step):
                    break
        finally:
            self._restore_preemption_handler()
        prefetch.close()
        if self.logger is not None:
            self.logger.finish()

    def _video_metrics(self, dataset, batch_size: int, margin: float, step: int,
                       desc: str) -> dict:
        """Video-level metrics of a split at the EER threshold."""
        prob_dict, tgt_dict = self.score_dataset(
            dataset, batch_size, {"margin": margin, "crop": self.crop}, step, desc=desc)
        out = self.gather_eval_output(prob_dict, tgt_dict)
        return cal_metrics(np.asarray(out["video_tgt"]), np.asarray(out["video_prob"]),
                           threshold="auto")

    def validate(self, step: int, timer: Timer):
        self.log_recon_figure(
            self.val_set, {"margin": self.val_margin, "crop": self.crop}, step, every=1000
        )
        metrics = self._video_metrics(self.val_set, self.val_batch_size, self.val_margin, step,
                                      "val")
        self._mprint(
            f"Eval Step {step}, EER {metrics['EER']:.4f}, HTER {metrics['ACER']:.4f}, "
            f"TPR5% {metrics['TPR5%']:.4f}, AUC {metrics['AUC']:.4f}, "
            f"Thres {metrics['Thre']:.4f}, ACC {metrics['ACC']:.4f}"
        )
        if metrics["AUC"] - metrics["ACER"] > self.best_auc - self.best_hter:
            self.best_auc = metrics["AUC"]
            self.best_hter = metrics["ACER"]
            self.best_step = step
            self._save_ckpt(step, best=True)
        self._mprint(
            "Best Step %d, Best AUC %.4f, Best HTER %.4f, Running Time: %s, Estimated Time: %s"
            % (self.best_step, self.best_auc, self.best_hter,
               timer.measure(), timer.measure(step / self.num_steps))
        )
        self._plateau_step(metrics["AUC"] - metrics["ACER"])
        self._save_ckpt(step, best=False)
        if self.logger is not None:
            self.logger.log(
                {"val/AUC": metrics["AUC"], "val/HTER": metrics["ACER"],
                 "val/TPR@5%": metrics["TPR5%"], "val/best_AUC": self.best_auc,
                 "val/best_HTER": self.best_hter},
                step,
            )

    def test(self):
        metrics = self._video_metrics(self.test_set, self.test_batch_size, self.test_margin, -1,
                                      "test")
        self._mprint(
            f"Test | EER {metrics['EER']:.4f}, HTER {metrics['ACER']:.4f}, "
            f"TPR 5% {metrics['TPR5%']:.4f}, AUC {metrics['AUC']:.4f}, "
            f"Thres {metrics['Thre']:.8f}, ACC {metrics['ACC']:.4f}\n"
            f"       APCER {metrics['APCER']:.4f}, BPCER {metrics['BPCER']:.4f}\n"
            f"       TP_Ratio {metrics['TP_Ratio']:.4f}, #Pos {metrics['NumP']}, "
            f"TN_Ratio {metrics['TN_Ratio']:.4f}, #Neg {metrics['NumN']}"
        )
        return metrics
