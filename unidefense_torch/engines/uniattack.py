"""UniAttackEngine (UE), the UniAttack benchmark of joint face-forgery and
face-spoofing detection (unidefense_tpu/engines/uniattack.py:25-267; the
reference's engine/uniattack_engine.py).

Real and fake training streams over the six sub-datasets, concatenated
real first each step; each validation takes the frame-level EER threshold
of the validation split (val-real and val-fake together, threshold
'auto', :407-435) and applies that fixed threshold to the test split's
frame- and video-level metrics (:432-466); the best checkpoint by the
least test frame ACER (:469-476); an optional map from sub-dataset root to
domain id (:43-60). The validation and test splits are scored with the
validation set's device stage (no flip), where the JAX engine scores them
with the training stage's random flips (ROADMAP.md section 3).

Resume restores the train state, the step, both streams' selections and
the best metrics and threshold, so a resumed run selects its data and its
best checkpoint as an uninterrupted one would.
"""

from __future__ import annotations

import numpy as np

from unidefense_torch.checkpoint import CheckpointManager
from unidefense_torch.config import load_dataset_config
from unidefense_torch.data.datasets import UniAttack
from unidefense_torch.data.pipeline import EpochSampler, InfiniteBatcher
from unidefense_torch.engines.base import AbstractEngine
from unidefense_torch.utils.meters import DeviceMetricAccumulator, Timer
from unidefense_torch.utils.metrics import cal_metrics

UE_TRAIN_STREAM = 99999  # fold_in(base_rng, 99999) of the JAX UE engine's train loop


class UniAttackEngine(AbstractEngine):
    engine_name = "UniAttack"
    # plateau_default_mode "min": the engine feeds the test frame ACER

    def _initiated_settings(self, model_cfg, data_cfg, config_cfg):
        self.best_auc_frame = 0.0
        self.best_auc_video = 0.0
        self.best_hter_frame = 1.0e8
        self.best_hter_video = 1.0e8
        self.best_thres = 0.5

    @staticmethod
    def _prepare_domain_label_map(options: dict) -> dict:
        """Sub-dataset root -> integer domain id
        (engine/uniattack_engine.py:43-60)."""
        real_set = {m.split("-")[0] for m in options["train_real_method"]}
        fake_set = {m.split("-")[0] for m in options["train_fake_method"]}
        assert len(real_set) == len(fake_set), f"real: {real_set}, fake: {fake_set}"
        return {options[f"{d}_root"]: i for i, d in enumerate(sorted(real_set))}

    def _eval_sets(self, options: dict):
        self.val_real_set = UniAttack(options, "val", options["val_real_method"])
        self.val_fake_set = UniAttack(options, "val", options["val_fake_method"])
        self.test_set = UniAttack(options, "test", options["test_method"])

    def _train_settings(self, model_cfg, data_cfg, config_cfg):
        options = load_dataset_config(self.config)
        self._mprint(f"Using debug mode: {self.debug}.")

        self.train_real_set = UniAttack(options, "train", options["train_real_method"])
        self.train_fake_set = UniAttack(options, "train", options["train_fake_method"])
        self._eval_sets(options)

        self.num_steps = options["num_steps"]
        self.log_steps = options["log_steps"]
        self.val_steps = options["val_steps"]
        self.dlabel_map = (self._prepare_domain_label_map(options)
                           if config_cfg.get("use_domain_label", False) else None)
        self.margin = config_cfg.get("margin")
        self.crop = config_cfg.get("crop", "nocrop")
        self._mprint(f"crop: {self.crop}, margin: {self.margin}, dlabel map: {self.dlabel_map}")
        self._setup_run_dir(options)

        bs = data_cfg["train_batch_size"]
        load_kwargs = {"margin": self.margin, "crop": self.crop,
                       "dataset_label_map": self.dlabel_map}
        self.real_batcher, self.fake_batcher = (
            InfiniteBatcher(ds, EpochSampler(len(ds), self._stream_batch(bs), shuffle=True,
                                             drop_last=True, **self._shard()),
                            load_kwargs=load_kwargs)
            for ds in (self.train_real_set, self.train_fake_set))
        self.val_batch_size = data_cfg.get("val_batch_size", 64)
        self.test_batch_size = data_cfg.get("test_batch_size", self.val_batch_size)
        # validation and the in-training test preprocess as val_transforms
        # say (no flip); the JAX engine scores them with the training stage's
        # random flips (ROADMAP.md section 3)
        self._build_training(sum_real=bs, sum_fake=bs, num_steps=self.num_steps,
                             device_tf=self.train_real_set.device_tf,
                             eval_tf=self.val_real_set.device_tf)
        self._maybe_resume()

    def _test_settings(self, model_cfg, data_cfg, config_cfg):
        options = load_dataset_config(self.config)
        self._eval_sets(options)
        self.test_batch_size = data_cfg.get("test_batch_size", 96)
        # test mode scores the val splits with the test batch size
        # (engine/uniattack_engine.py:205-211)
        self.val_batch_size = self.test_batch_size
        self.margin = config_cfg.get("margin")
        self.crop = config_cfg.get("crop", "nocrop")
        self._setup_test_dir(options)
        self._build_training(sum_real=1, sum_fake=1, num_steps=1,
                             device_tf=self.test_set.device_tf, train=False)
        self.ckpt = CheckpointManager(self.run_dir, self.dp)
        self.state, meta = self.ckpt.restore(self.state, best=True)
        self._mprint(
            f"Loaded best checkpoint: step {meta.get('best_step')}.\n"
            f"\t[Video] Best ACER: {meta.get('best_hter_video', -1):.4f}"
            f"\tBest AUC: {meta.get('best_auc_video', -1):.4f}\n"
            f"\t[Frame] Best ACER: {meta.get('best_hter_frame', -1):.4f}"
            f"\tBest AUC: {meta.get('best_auc_frame', -1):.4f}"
        )

    def _meta(self, step: int) -> dict:
        meta = super()._meta(step)
        meta.update(
            best_auc_frame=self.best_auc_frame,
            best_auc_video=self.best_auc_video,
            best_hter_frame=self.best_hter_frame,
            best_hter_video=self.best_hter_video,
            best_thres=self.best_thres,
        )
        return meta

    def _select_batch(self, cur_step: int):
        return self.real_batcher.select(cur_step), self.fake_batcher.select(cur_step)

    def _load_batch(self, sels):
        real = self.real_batcher.load(sels[0])
        fake = self.fake_batcher.load(sels[1])
        return self.assemble_batch(real["images"], real["label"], fake["images"], fake["label"])

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
                    self.state, batch, self._step_generator(UE_TRAIN_STREAM, cur_step)
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
                    # running means and the LR, as the reference prints them
                    # (engine/uniattack_engine.py:353-361)
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

    def _val_threshold(self, step: int) -> dict:
        """Frame-level metrics of the val real+fake splits at their EER
        threshold (engine/uniattack_engine.py:407-435)."""
        kw = {"margin": self.margin, "crop": self.crop}
        rp, rt = self.score_dataset(self.val_real_set, self.val_batch_size, kw, step, "val-real")
        fp, ft = self.score_dataset(self.val_fake_set, self.val_batch_size, kw, step, "val-fake")
        real = self.gather_eval_output(rp, rt)
        fake = self.gather_eval_output(fp, ft)
        frame_tgt = np.asarray(real["frame_tgt"] + fake["frame_tgt"])
        frame_prob = np.asarray(real["frame_prob"] + fake["frame_prob"])
        metrics = cal_metrics(frame_tgt, frame_prob, threshold="auto")
        self._mprint(
            f"Eval Step {step} [Frame], ACER {metrics['ACER']:.4f}, "
            f"AUC {metrics['AUC']:.4f}, Thres {metrics['Thre']:.8f}"
        )
        return metrics

    def _test_metrics(self, step: int, thres: float) -> tuple[dict, dict]:
        """Video- and frame-level metrics of the test split at ``thres``."""
        kw = {"margin": self.margin, "crop": self.crop}
        pp, tt = self.score_dataset(self.test_set, self.test_batch_size, kw, step, "test")
        out = self.gather_eval_output(pp, tt)
        video = cal_metrics(np.asarray(out["video_tgt"]), np.asarray(out["video_prob"]),
                            threshold=thres)
        frame = cal_metrics(np.asarray(out["frame_tgt"]), np.asarray(out["frame_prob"]),
                            threshold=thres)
        for tag, m in (("Video", video), ("Frame", frame)):
            self._mprint(
                f"Test Step {step} [{tag}], EER {m['EER']:.4f}, APCER {m['APCER']:.4f}, "
                f"BPCER {m['BPCER']:.4f}, ACER {m['ACER']:.4f}, TPR5% {m['TPR5%']:.4f}, "
                f"AUC {m['AUC']:.4f}, Thres {m['Thre']:.8f}"
            )
        return video, frame

    def validate(self, step: int, timer: Timer):
        val_metrics = self._val_threshold(step)
        video, frame = self._test_metrics(step, val_metrics["Thre"])

        if frame["ACER"] < self.best_hter_frame:
            self.best_auc_frame = frame["AUC"]
            self.best_auc_video = video["AUC"]
            self.best_hter_frame = frame["ACER"]
            self.best_hter_video = video["ACER"]
            self.best_thres = frame["Thre"]
            self.best_step = step
            self._save_ckpt(step, best=True)
        self._mprint(
            "Best Step %d, Best AUC F %.4f, Best ACER F %.4f, Best AUC V %.4f, "
            "Best ACER V %.4f, Best Thres %.8f, Running Time: %s, Estimated Time: %s"
            % (self.best_step, self.best_auc_frame, self.best_hter_frame,
               self.best_auc_video, self.best_hter_video, self.best_thres,
               timer.measure(), timer.measure(step / self.num_steps))
        )
        self._plateau_step(frame["ACER"])
        self._save_ckpt(step, best=False)
        if self.logger is not None:
            self.logger.log(
                {"val/AUC": frame["AUC"], "val/HTER": frame["ACER"],
                 "val/TPR@5%": frame["TPR5%"], "val/best_AUC": self.best_auc_frame,
                 "val/best_AUC_video": self.best_auc_video,
                 "val/best_HTER": self.best_hter_frame,
                 "val/best_HTER_video": self.best_hter_video},
                step,
            )

    def test(self):
        val_metrics = self._val_threshold(-1)
        video, frame = self._test_metrics(-1, val_metrics["Thre"])
        self._mprint("Summary:")
        self._mprint(f"[Video] ACER {video['ACER']:.4f},\tAUC {video['AUC']:.4f}.")
        self._mprint(f"[Frame] ACER {frame['ACER']:.4f},\tAUC {frame['AUC']:.4f}.")
        return {"video": video, "frame": frame}
