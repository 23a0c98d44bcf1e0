"""ForgeryEngine (FE), face-forgery detection training and evaluation
(unidefense_tpu/engines/forgery.py:26-246; the reference's
engine/forgery_engine.py).

Separate real and fake streams concatenated real-first each step (:261-264),
frame-level validation at threshold 0.5 (:394), best checkpoint by
max(AUC + ACC) (:399-403). The two streams are InfiniteBatchers whose
decode runs on a prefetch thread pool while the card runs the previous
step.
"""

from __future__ import annotations

import numpy as np

from unidefense_torch.checkpoint import CheckpointManager
from unidefense_torch.config import load_dataset_config
from unidefense_torch.data.datasets import get_dataset
from unidefense_torch.data.pipeline import EpochSampler, InfiniteBatcher
from unidefense_torch.engines.base import TRAIN_STREAM, AbstractEngine
from unidefense_torch.utils.meters import DeviceMetricAccumulator, Timer
from unidefense_torch.utils.metrics import cal_metrics


class ForgeryEngine(AbstractEngine):
    engine_name = "Forgery"
    plateau_default_mode = "max"  # feeds AUC + ACC (higher is better)

    def _initiated_settings(self, model_cfg, data_cfg, config_cfg):
        pass

    def _build_fe_datasets(self, options: dict, train: bool):
        """Real/fake method + fpv splitting (engine/forgery_engine.py:54-98):
        the real stream's fpv is scaled by the number of fake methods so both
        streams cover comparable video counts."""
        dataset_name = options.pop("name")
        real_method = options.pop("real_method")
        fake_method = options.pop("fake_method")
        fake_train_fpv = options.pop("train_fpv", None)
        ds_cls = get_dataset(dataset_name)

        opts_real = dict(options)
        opts_real["method"] = real_method
        opts_real["train_fpv"] = None if fake_train_fpv is None else fake_train_fpv * len(fake_method)
        opts_fake = dict(options)
        opts_fake["method"] = fake_method
        opts_fake["train_fpv"] = fake_train_fpv

        if train:
            self.train_real_set = ds_cls(opts_real, split="train")
            self.train_fake_set = ds_cls(opts_fake, split="train")
        opts_val = dict(options)
        opts_val["method"] = real_method + fake_method
        try:
            self.val_set = ds_cls(opts_val, "val")
        except (ValueError, FileNotFoundError):
            self.val_set = ds_cls(opts_val, "test")  # some datasets lack val
        return options

    def _train_settings(self, model_cfg, data_cfg, config_cfg):
        options = load_dataset_config(self.config)
        self._mprint(f"Using debug mode: {self.debug}.")
        options = self._build_fe_datasets(options, train=True)

        self.num_steps = options["num_steps"]
        self.log_steps = options["log_steps"]
        self.val_steps = options["val_steps"]
        self.crop = config_cfg.get("crop", "nocrop")
        self._mprint(f"crop: {self.crop}")
        self._setup_run_dir(options)

        bs = data_cfg["train_batch_size"]
        proc_bs = self._stream_batch(bs)
        # pad_last=True: the step's real/fake split is fixed, so the final
        # partial chunk of each epoch is wrap-around padded to full size
        self.real_batcher = InfiniteBatcher(
            self.train_real_set,
            EpochSampler(len(self.train_real_set), proc_bs, shuffle=True, pad_last=True),
            load_kwargs={"crop": self.crop},
        )
        self.fake_batcher = InfiniteBatcher(
            self.train_fake_set,
            EpochSampler(len(self.train_fake_set), proc_bs, shuffle=True, pad_last=True),
            load_kwargs={"crop": self.crop},
        )
        self.val_batch_size = data_cfg.get("val_batch_size", 64)
        # validation preprocesses as val_transforms say (no flip), as the
        # reference does; the JAX engine validates with the training stage's
        # random flips (ROADMAP.md section 3)
        self._build_training(sum_real=bs, sum_fake=bs, num_steps=self.num_steps,
                             device_tf=self.train_real_set.device_tf,
                             eval_tf=self.val_set.device_tf)
        self._maybe_resume()

    def _test_settings(self, model_cfg, data_cfg, config_cfg):
        options = load_dataset_config(self.config)
        dataset_name = options.pop("name")
        real_method = options.pop("real_method")
        fake_method = options.pop("fake_method")
        options["method"] = real_method + fake_method
        self.test_set = get_dataset(dataset_name)(options, "test")
        self.test_batch_size = data_cfg.get("test_batch_size", 96)
        self.crop = config_cfg.get("crop", "nocrop")

        self._setup_test_dir(options)
        self._build_training(sum_real=1, sum_fake=1, num_steps=1,
                             device_tf=self.test_set.device_tf, train=False)
        self.ckpt = CheckpointManager(self.run_dir)
        self.state, meta = self.ckpt.restore(self.state, best=True)
        self._mprint(
            f"Loaded best checkpoint: step {meta.get('best_step')}, "
            f"AUC {meta.get('best_auc', -1):.4f}, ACC {meta.get('best_acc', -1):.4f}"
        )

    def _select_batch(self, cur_step: int):
        return self.real_batcher.select(cur_step), self.fake_batcher.select(cur_step)

    def _load_batch(self, sels):
        real = self.real_batcher.load(sels[0])
        fake = self.fake_batcher.load(sels[1])
        return self.assemble_batch(
            real["images"], real["label"], fake["images"], fake["label"]
        )

    def train(self):
        timer = Timer()
        # every-step metric and accuracy sums on the device; one host read
        # at log boundaries (engine/forgery_engine.py:285-297)
        train_meter = DeviceMetricAccumulator()
        prefetch = self._make_prefetcher()
        self._install_preemption_handler()

        cur_step = self.start_step - 1
        try:
            for batch in prefetch:
                cur_step += 1
                self._profile_tick(cur_step)
                self.state, metrics, cls_out = self.train_step(
                    self.state, batch, self._generator(TRAIN_STREAM, cur_step)
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
                    # running means since the start and the LR, as the
                    # reference prints them (engine/forgery_engine.py:299-307)
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

    def validate(self, step: int, timer: Timer):
        self.log_recon_figure(self.val_set, {"crop": self.crop}, step, every=10000)
        prob_dict, tgt_dict = self.score_dataset(
            self.val_set, self.val_batch_size, {"crop": self.crop}, step
        )
        out = self.gather_eval_output(prob_dict, tgt_dict)
        metrics = cal_metrics(
            np.asarray(out["frame_tgt"]), np.asarray(out["frame_prob"]), threshold=0.5
        )
        self._mprint(
            f"Eval Step {step}, EER {metrics['EER']:.4f}, TPR5% {metrics['TPR5%']:.4f}, "
            f"AUC {metrics['AUC']:.4f}, ACC {metrics['ACC']:.4f}, Thre {metrics['Thre']:.4f}"
        )
        if metrics["AUC"] + metrics["ACC"] > self.best_auc + self.best_acc:
            self.best_auc = metrics["AUC"]
            self.best_acc = metrics["ACC"]
            self.best_step = step
            self._save_ckpt(step, best=True)
        self._mprint(
            "Best Step %d, Best AUC %.4f, Best ACC %.4f, Running Time: %s, Estimated Time: %s"
            % (self.best_step, self.best_auc, self.best_acc,
               timer.measure(), timer.measure(step / self.num_steps))
        )
        self._plateau_step(metrics["AUC"] + metrics["ACC"])
        self._save_ckpt(step, best=False)
        if self.logger is not None:
            self.logger.log(
                {"val/AUC": metrics["AUC"], "val/ACC": metrics["ACC"],
                 "val/TPR@5%": metrics["TPR5%"], "val/best_AUC": self.best_auc,
                 "val/best_ACC": self.best_acc},
                step,
            )

    def test(self):
        prob_dict, tgt_dict = self.score_dataset(
            self.test_set, self.test_batch_size, {"crop": self.crop}, -1, desc="test"
        )
        out = self.gather_eval_output(prob_dict, tgt_dict)
        metrics = cal_metrics(
            np.asarray(out["frame_tgt"]), np.asarray(out["frame_prob"]), threshold=0.5
        )
        self._mprint(
            f"Test | EER {metrics['EER']:.4f}, HTER {metrics['ACER']:.4f}, "
            f"TPR 5% {metrics['TPR5%']:.4f}, AUC {metrics['AUC']:.4f}, "
            f"Thres {metrics['Thre']:.8f}, ACC {metrics['ACC']:.4f}\n"
            f"\tTP_Ratio {metrics['TP_Ratio']:.4f}, #Pos {metrics['NumP']}, "
            f"TN_Ratio {metrics['TN_Ratio']:.4f}, #Neg {metrics['NumN']}"
        )
        return metrics
