"""AbstractEngine (unidefense_tpu/engines/base.py:49-723): the shared
lifecycle of the task engines, on one device or one rank per device.

Settings phases, seeding, the run directory and its logs, the two-pass
train step (train/step.make_train_step, with the K1 device stage as its
preprocessing), the eval step, checkpoints that resume exactly, a graceful
stop on preemption, and eval aggregation. The engine runs on ``cuda``
unless the caller passes ``device`` (the tests pass ``"cpu"``).

Randomness is indexed, as the JAX package's ``fold_in`` is: the train step
``s`` draws its flips, perturbation and dropout masks from a generator
seeded from (seed, stream, s) (stream 12345 in FE, 54321 in OCIM, 99999
in UE), and eval batch ``b`` from (seed, 777, b); so
a resumed run draws what an uninterrupted one would, with no generator
state saved.

Data parallelism (``parallel.mesh``): ``n_dev`` is the world size and
``self.device`` this rank's device. Each rank trains on its own sharded
streams with synced BatchNorm and averaged gradients; rank r's train step
``s`` draws from (seed, stream, s, r), JAX's ``fold_in(rng,
axis_index)``, and a world of one keeps (seed, stream, s). Rank 0 alone
prints, tees stdout, logs, snapshots the sources, draws the recon figure,
traces the profiler and writes checkpoints (every rank enters the save);
it picks the run id and creates the run directory, whose path the others
receive. Validation is striped: rank r scores items r, r + world, ... with
no collective, and the stripes are merged by ``all_gather_objects``. A
preemption flag is agreed every ``preempt_sync_steps`` steps. Collectives
are issued from the main thread only (the prefetch and decode threads
issue none).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from unidefense_torch.checkpoint import CheckpointManager
from unidefense_torch.device import DeviceLike, nhwc
from unidefense_torch.models.convert import load_pretrained_extractor, load_unidefense_checkpoint
from unidefense_torch.models.registry import build_model
from unidefense_torch.parallel.mesh import (
    all_gather_objects, broadcast_object, broadcast_state, init_data_parallel, sync_batchnorm)
from unidefense_torch.train.optim import build_optimizer, build_plateau
from unidefense_torch.train.step import create_train_state, make_eval_step, make_train_step
from unidefense_torch.utils.logging import TrainLogger
from unidefense_torch.utils.meters import Logger, Timer, center_print
from unidefense_torch.utils.metrics import merge_video_dicts

TRAIN_STREAM = 12345  # fold_in(base_rng, 12345) of the JAX forgery engine's train loop
OCIM_TRAIN_STREAM = 54321  # fold_in(base_rng, 54321) of the JAX OCIM engine's train loop
EVAL_STREAM = 777  # fold_in(base_rng, 777) of score_dataset


def step_seed(*key: int) -> int:
    """A 63-bit generator seed for an index path (seed, stream, index)."""
    return int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0] >> np.uint64(1))


class AbstractEngine:
    engine_name = "Abstract"
    # direction of the metric this engine feeds ReduceLROnPlateau
    plateau_default_mode = "min"

    def __init__(self, config: dict, stage: str = "Train", device: DeviceLike = None):
        if stage not in ("Train", "Test"):
            raise ValueError(f"stage should be 'Train' or 'Test', got '{stage}'")
        self.num_devices = (config.get("config") or {}).get("num_devices")
        self.dp = init_data_parallel(self.num_devices, device=device)
        self.n_dev = self.dp.world
        self.device = self.dp.device
        self.config = config
        self.stage = stage
        model_cfg = dict(config.get("model") or {})
        data_cfg = dict(config.get("data") or {})
        config_cfg = dict(config.get("config") or {})

        self.model_name = model_cfg.pop("name", None)
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.config_cfg = config_cfg
        self.dataset_config: Optional[dict] = None

        self.debug = bool(config_cfg.get("debug", False))
        self.offline = bool(config_cfg.get("offline", False))
        self.local_rank = int(config_cfg.get("local_rank", 0) or 0)
        self.precision = str(config_cfg.get("precision", "fp32"))
        self.compute_dtype = torch.bfloat16 if self.precision == "bf16" else None

        self.best_acc = 0.0
        self.best_auc = 0.0
        self.best_hter = 1.0e8
        self.best_step = 1
        self.start_step = 1

        self.run_dir: Optional[str] = None
        self.logger: Optional[TrainLogger] = None
        self.ckpt: Optional[CheckpointManager] = None
        self.seed = self.fixed_randomness()

        self._initiated_settings(model_cfg, data_cfg, config_cfg)
        if stage == "Train":
            self._train_settings(model_cfg, data_cfg, config_cfg)
        else:
            self._test_settings(model_cfg, data_cfg, config_cfg)

    # ------------------------------------------------------------------ setup

    @staticmethod
    def fixed_randomness(seed: int = 42) -> int:
        """The run's one seed (engine/abstract_engine.py:113-120 seeds
        everything with 42): the model's initial weights and, through
        :meth:`_generator`, every draw of a step."""
        return seed

    def _generator(self, stream: int, *index: int) -> torch.Generator:
        """The generator of draw ``index`` of ``stream``, on the engine's
        device (``fold_in(fold_in(base_rng, stream), index)``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.seed, stream, *index))
        return gen

    def _step_generator(self, stream: int, step: int) -> torch.Generator:
        """Train step ``step``'s generator: (seed, stream, step), and this
        rank's index after them in a world above one."""
        return self._generator(stream, step, *((self.dp.rank,) if self.n_dev > 1 else ()))

    def _mprint(self, content: str = ""):
        if self.dp.primary:
            print(content)

    def _initiated_settings(self, model_cfg, data_cfg, config_cfg):
        raise NotImplementedError

    def _train_settings(self, model_cfg, data_cfg, config_cfg):
        raise NotImplementedError

    def _test_settings(self, model_cfg, data_cfg, config_cfg):
        raise NotImplementedError

    def _setup_run_dir(self, options: dict):
        """Create runs/<model>/<id>/, tee stdout, init logging
        (engine/forgery_engine.py:102-125)."""
        if self.debug:
            return
        resume = bool(self.config_cfg.get("resume", False))
        run_id, error = None, None
        if self.dp.primary:
            # rank 0's clock names the run, and rank 0 alone checks and
            # creates its directory; the other ranks receive the id
            run_id = self.config_cfg.get(
                "id", time.strftime("%Y-%m-%d...%H.%M.%S", time.localtime())
            )
            run_dir = os.path.join("runs", self.model_name, run_id)
            if not resume:
                if os.path.exists(run_dir):
                    error = f"Error: given id '{run_id}' already exists."
                else:
                    os.makedirs(run_dir, exist_ok=True)
        run_id, error = broadcast_object((run_id, error), self.dp.group)
        if error:
            raise ValueError(error)  # on every rank
        self.run_id = run_id
        self.run_dir = os.path.join("runs", self.model_name, run_id)
        if not resume:
            self.dataset_config = options
        if self.dp.primary:
            print(f"Logging directory: {self.run_dir}.")
            sys.stdout = Logger(os.path.join(self.run_dir, "records.txt"))
            center_print("Train configurations begin.")
            print({k: v for k, v in self.config.items() if k != "cfg_path"})
            print(options)
            center_print("Train configurations end.")
            self._snapshot_sources()
        self.ckpt = CheckpointManager(self.run_dir, self.dp)
        self.logger = TrainLogger(
            self.run_dir,
            project="UniDefense",
            group=self.engine_name,
            name=f"{self.model_name}/{run_id}",
            config={"model": self.model_cfg, "config": self.config_cfg,
                    "data": self.data_cfg, "dataset": options},
            offline=self.offline,
            enabled=self.dp.primary,
        )

    def _setup_test_dir(self, options: dict):
        """Resolve runs/<model>/<id>/ for the Test stage and tee stdout to
        test.txt (engine/forgery_engine.py:185-197)."""
        self.run_id = self.config_cfg["id"]
        self.run_dir = os.path.join("runs", self.model_name, self.run_id)
        assert os.path.exists(self.run_dir), (
            f"Logging directory '{self.run_dir}' corrupted."
        )
        if self.dp.primary:
            print(f"Logging directory: {self.run_dir}.")
            sys.stdout = Logger(os.path.join(self.run_dir, "test.txt"))
            center_print("Test data configurations begins.")
            print(options)
            center_print("Test data configurations ends.")

    def _snapshot_sources(self):
        """Copy the engine and model source files and the config into the run
        dir (engine/abstract_engine.py:92-97)."""
        import inspect
        import shutil

        from unidefense_torch.models.registry import load_model

        code_dir = os.path.join(self.run_dir, "code")
        os.makedirs(code_dir, exist_ok=True)
        files = [inspect.getfile(type(self)), inspect.getfile(load_model(self.model_name))]
        cfg_path = self.config.get("cfg_path")
        if cfg_path and os.path.exists(cfg_path):
            files.append(cfg_path)
        for f in files:
            try:
                shutil.copy(f, code_dir)
            except OSError:
                pass

    def _build_model(self):
        model_cfg = self.model_cfg
        if self.config_cfg.get("deterministic_regularization", False):
            # additive key: zero every stochastic regularization (dropout,
            # feature dropout, EfficientNet drop-connect) for reproducible,
            # cross-framework-comparable runs
            model_cfg = dict(model_cfg)
            model_cfg.update(drop_rate=0.0, feat_drop_rate=0.0)
            if self.model_name.upper() == "UDEB4":
                model_cfg["drop_connect_rate"] = 0.0
            self.model_cfg = model_cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            self.model = build_model(self.model_name, self.model_cfg, dtype=self.compute_dtype,
                                     remat=bool(self.config_cfg.get("remat", False)))
        return self.model

    def _build_training(self, sum_real: int, sum_fake: int, num_steps: int, device_tf=None,
                        train: bool = True, eval_tf=None):
        """The train state on the device and the train/eval steps: the train
        step preprocesses with ``device_tf``, the eval step with ``eval_tf``
        (default ``device_tf``). train=False (the Test stage) builds no
        train step. Across ranks the train-mode BatchNorm statistics are
        synced and the step averages gradients and metrics."""
        model = self._build_model()
        sync_batchnorm(model, self.dp.group)
        self.tx, self.lr_schedule = build_optimizer(self.config_cfg)
        # metric-fed LR decay (scheduler name ReduceLROnPlateau); engines feed
        # their best-model selection metric each validation, in the
        # direction of plateau_default_mode unless the YAML says otherwise
        self.plateau = build_plateau(self.config_cfg, default_mode=self.plateau_default_mode)

        self.state = create_train_state(model, self.tx, self.device)
        if self.plateau is not None:
            self.state.lr_scale = self.plateau.scale

        # the reference's pretrained backbone ('extractor_weights',
        # config_template/forgery/model_udeb4.yml:2), then a full-model warm
        # start ('init_weights', a reference {'model': state_dict} file),
        # which supersedes it; a later resume supersedes both
        # (unidefense_tpu/engines/base.py:251-284)
        weights_path = self.model_cfg.get("extractor_weights")
        if weights_path and os.path.exists(weights_path):
            load_pretrained_extractor(self.state.model, weights_path, self.model_name)
            self._mprint(f"Loaded pretrained extractor weights from {weights_path}.")
        elif weights_path:
            self._mprint(f"WARNING: extractor_weights '{weights_path}' not found; "
                         "training from scratch.")
        init_path = self.config_cfg.get("init_weights")
        if init_path:
            if not os.path.exists(init_path):
                raise FileNotFoundError(f"config.init_weights '{init_path}' does not exist")
            load_unidefense_checkpoint(self.state.model, init_path)
            self._mprint(f"Initialized full model weights from {init_path}.")

        self.eval_step = make_eval_step(self.state.model,
                                        preprocess=device_tf if eval_tf is None else eval_tf)
        if train:
            self.train_step = make_train_step(
                self.tx,
                self.config_cfg,
                num_steps=num_steps,
                sum_real=sum_real,
                sum_fake=sum_fake,
                faithful_grad_accumulation=bool(
                    self.config_cfg.get("faithful_grad_accumulation", True)),
                freq_norm=self.model_cfg.get("freq_norm", "ortho"),
                preprocess=device_tf,
                group=self.dp.group,
            )
        return model

    def _maybe_resume(self):
        """Real resume: restore the whole train state and the best-metric
        bookkeeping; then, across ranks, every rank takes rank 0's state
        (the weight files and the checkpoint are the same files on every
        rank, so this only guards against a rank that read otherwise)."""
        self._restore_latest()
        broadcast_state(self.state.model, self.state.opt_state, self.dp.group)

    def _restore_latest(self):
        if not self.config_cfg.get("resume", False) or self.ckpt is None:
            return
        best = bool(self.config_cfg.get("resume_best", False))
        if not self.ckpt.exists(best):
            self._mprint(f"Resume requested but no checkpoint at {self.run_dir}; starting fresh.")
            return
        self.state, meta = self.ckpt.restore(self.state, best=best)
        # every best-metric attribute the engine keeps in _meta (best_step,
        # best_auc, ...; UE's best_hter_frame and best_thres too)
        for key, value in meta.items():
            if key.startswith("best_") and hasattr(self, key):
                setattr(self, key, value)
        # a checkpoint whose sidecar a kill mid-save lost keeps its step in model.pt
        self.start_step = int(meta.get("step", self.state.step)) + 1
        if getattr(self, "plateau", None) is not None and "plateau" in meta:
            p = self.plateau
            saved = meta["plateau"]
            p.lr = float(saved.get("lr", p.lr))
            p.best = float(saved.get("best", p.best))
            p.num_bad_epochs = int(saved.get("num_bad_epochs", 0))
            p.cooldown_counter = int(saved.get("cooldown_counter", 0))
        self._mprint(f"Resumed from step {self.start_step - 1} (best={best}).")

    # ---------------------------------------------------------------- helpers

    def _meta(self, step: int) -> dict:
        meta = {
            "step": step,
            "best_step": self.best_step,
            "best_auc": self.best_auc,
            "best_acc": self.best_acc,
            "best_hter": self.best_hter,
        }
        if getattr(self, "plateau", None) is not None:
            p = self.plateau
            meta["plateau"] = {
                "lr": p.lr, "best": p.best, "num_bad_epochs": p.num_bad_epochs,
                "cooldown_counter": p.cooldown_counter,
            }
        return meta

    def _plateau_step(self, metric: float):
        """Feed the validation metric to ReduceLROnPlateau (if configured);
        the train state carries the resulting LR multiplier."""
        if getattr(self, "plateau", None) is None:
            return
        self.state.lr_scale = self.plateau.step(metric)

    def _save_ckpt(self, step: int, best: bool = False):
        if self.ckpt is not None:
            self.ckpt.save(self.state, self._meta(step), best=best)

    # ----------------------------------------------------- preemption handling

    def _install_preemption_handler(self):
        """Arm a graceful stop on SIGTERM/SIGINT for the duration of train().
        The handler only sets a flag; the train loop finishes the step in
        flight, saves the `latest` checkpoint through _graceful_stop and
        returns, so a restart with `resume: true` continues exactly. A second
        SIGINT falls through to the previous handler."""
        import signal

        self._preempt_requested = False
        self._prev_handlers = {}

        def _handler(signum, frame):
            if self._preempt_requested and signum == signal.SIGINT:
                prev = self._prev_handlers.get(signal.SIGINT)
                if callable(prev):
                    prev(signum, frame)
                return
            self._preempt_requested = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, _handler)
            except ValueError:
                # signal.signal works on the main thread only; engines driven
                # from other threads can still set _preempt_requested
                pass

    def _restore_preemption_handler(self):
        import signal

        for sig, prev in getattr(self, "_prev_handlers", {}).items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev_handlers = {}

    def _graceful_stop(self, cur_step: int) -> bool:
        """True if training should stop now; saves the latest checkpoint
        first so the run resumes from exactly this step. Across ranks the
        flags are gathered every ``config.preempt_sync_steps`` steps
        (default 10) and a stop happens only there, where every rank sees
        the same flags and enters the same save."""
        stop = bool(getattr(self, "_preempt_requested", False))
        if self.n_dev > 1:
            sync_every = max(1, int(self.config_cfg.get("preempt_sync_steps", 10)))
            if cur_step % sync_every:
                return False
            stop = any(f[0] for f in all_gather_objects(stop, group=self.dp.group))
        if not stop:
            return False
        self._mprint(
            f"Preemption requested — saving latest checkpoint at step {cur_step}; "
            "restart with `resume: true` to continue."
        )
        self._save_ckpt(cur_step, best=False)
        return True

    def _current_lr(self, cur_step: int) -> float:
        """LR applied at this step: the count-based schedule times the
        plateau multiplier."""
        lr = float(self.lr_schedule(2 * (cur_step - 1)))
        if self.state.lr_scale is not None:
            lr *= float(self.state.lr_scale)
        return lr

    def _printed_lr(self, cur_step: int) -> float:
        """The LR value the reference prints and logs: param_groups are read
        after the step's scheduler.step() (engine/forgery_engine.py:290-298),
        so after warm-up it is the next step's lr; during warm-up it is this
        step's."""
        warmup = int(self.config_cfg.get("warmup_step", 0) or 0)
        if warmup and cur_step <= warmup:
            return self._current_lr(cur_step)
        return self._current_lr(cur_step + 1)

    def _profile_tick(self, cur_step: int):
        """Optional torch.profiler capture: set config.profile_start_step (and
        profile_steps, default 5) to write a Chrome trace of those steps
        into <run_dir>/profile/."""
        start = self.config_cfg.get("profile_start_step")
        if start is None or self.run_dir is None or not self.dp.primary:
            return
        start = int(start)
        n = max(1, int(self.config_cfg.get("profile_steps", 5)))
        stop_at = min(start + n, getattr(self, "num_steps", start + n))
        if cur_step == start and start < stop_at:
            self._trace_dir = os.path.join(self.run_dir, "profile")
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(self._trace_dir))
            self._profiler.start()
        elif getattr(self, "_profiler", None) is not None and cur_step >= stop_at:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profiler.stop()
            self._profiler = None
            self._mprint(f"Profiler trace written to {self._trace_dir}")

    def _make_prefetcher(self):
        """Decode-ahead training input: selection serial (sampler
        determinism), decode on `data.num_workers` threads (default 2; 1
        reproduces the reference's synchronous in-loop decode order). On
        resume the batchers are fast-forwarded, so the data stream continues
        where an uninterrupted run would be."""
        from unidefense_torch.data.pipeline import BatchPrefetcher

        if self.start_step > 1:
            for b in self._batchers():
                b.fast_forward(self.start_step)
        workers = int(self.data_cfg.get("num_workers", 2) or 1)
        # an explicit prefetch_depth: 0 means the minimum decode-ahead, 1;
        # only a null or missing key falls back to the default 2
        raw_depth = self.data_cfg.get("prefetch_depth", 2)
        depth = max(1, int(2 if raw_depth is None else raw_depth))
        return BatchPrefetcher(
            select=self._select_batch, load=self._on_device(self._load_batch), depth=depth,
            num_steps=self.num_steps, start_step=self.start_step, workers=workers,
        )

    def _on_device(self, fn):
        """``fn`` run with this rank's card as the current CUDA device: a
        decode thread's current device is cuda:0 otherwise, and the host
        library's nvJPEG decodes on the current one."""
        if self.device.type != "cuda" or self.device.index is None:
            return fn

        def run(*args, **kwargs):
            with torch.cuda.device(self.device):
                return fn(*args, **kwargs)
        return run

    def _batchers(self) -> list:
        """The engine's training InfiniteBatchers (for resume fast-forward):
        its ``batchers`` where it has a list of streams (OCIM's per-domain
        streams), else its real and fake streams."""
        if hasattr(self, "batchers"):
            return list(self.batchers)
        return [getattr(self, name) for name in ("real_batcher", "fake_batcher")
                if hasattr(self, name)]

    def _stream_batch(self, per_dev: int) -> int:
        """Per-process draw of a training stream: ``per_dev`` samples (one
        device per process; the JAX package's per_dev x n_dev / nproc)."""
        return per_dev

    def _shard(self) -> dict:
        """The samplers' shard of this rank: shard_id = rank, num_shards =
        world."""
        return {"shard_id": self.dp.rank, "num_shards": self.n_dev}

    def assemble_batch(self, images_real, labels_real, images_fake, labels_fake):
        """The step's batch on the device, real first, in one host-to-device
        copy: the uint8 images and, 8-byte aligned after them, the int64
        labels share one buffer."""
        shape = (len(images_real) + len(images_fake),) + images_real.shape[1:]
        img_bytes = int(np.prod(shape))
        at = -(-img_bytes // 8) * 8
        packed = np.empty(at + 8 * shape[0], np.uint8)
        np.concatenate([images_real, images_fake], axis=0, out=packed[:img_bytes].reshape(shape))
        packed[at:].view(np.int64)[:] = np.concatenate([labels_real, labels_fake])
        dev = torch.from_numpy(packed).to(self.device)
        return {"image": dev[:img_bytes].view(shape), "label": dev[at:].view(torch.int64)}

    def score_dataset(self, dataset, batch_size: int, load_kwargs: dict, step: int,
                      desc: str = "val") -> tuple[dict, dict]:
        """Score a whole split with fixed-size batches (the last padded by
        repetition), grouping frame probabilities by video
        (engine/forgery_engine.py:336-360). Across ranks, rank r scores the
        stripe r, r + world, ... with its own eval step and no collective
        (``gather_eval_output`` merges the stripes); batch b of a stripe
        draws from (seed, 777, b)."""
        stripe = range(self.dp.rank, len(dataset), self.n_dev)
        n = len(stripe)
        prob_dict: dict[str, list] = {}
        tgt_dict: dict[str, list] = {}
        num_batches = -(-n // batch_size)

        def _select(b):
            """Batch b's items and every draw of its load, on this thread
            in batch order (``plan_item``), so a stage that draws (the
            distorted test's OneOf) draws as a serial run would."""
            idx = list(stripe[b * batch_size:min(n, (b + 1) * batch_size)])
            n_valid = len(idx)
            while len(idx) < batch_size:
                idx.append(idx[-1])
            items = [dataset[i][0] for i in idx]
            labels = np.asarray([int(dataset[i][1]) for i in idx], np.int64)
            return dataset.plan_item(items, labels, **load_kwargs), labels, n_valid

        def _load(sel):
            plan, labels, n_valid = sel
            return dataset.finish_item(plan), labels, n_valid

        # decode batches b+1..b+lookahead on worker threads while the card
        # scores batch b
        from concurrent.futures import ThreadPoolExecutor

        lookahead = 2
        pool = ThreadPoolExecutor(max_workers=2)
        load = self._on_device(_load)
        futs = {b: pool.submit(load, _select(b)) for b in range(min(lookahead, num_batches))}
        model = self.state.model
        model.eval()
        try:
            for b in range(num_batches):
                out, labels, n_valid = futs.pop(b).result()
                nb = b + lookahead
                if nb < num_batches:
                    futs[nb] = pool.submit(load, _select(nb))
                x = torch.from_numpy(out["images"]).to(self.device)
                probs, _, _ = self.eval_step(x, self._generator(EVAL_STREAM, b))
                probs = probs[:n_valid].cpu().numpy()
                for p, pr, tg in zip(out["path"][:n_valid], probs, labels[:n_valid]):
                    vid = p.rsplit("/", 1)[0]
                    prob_dict.setdefault(vid, []).append(float(pr))
                    tgt_dict.setdefault(vid, []).append(float(tg))
                if b % 50 == 0:
                    self._mprint(f"Eval {desc} ({b + 1}/{num_batches}), Global Step {step}")
        finally:
            pool.shutdown(wait=False)
            model.train()
        return prob_dict, tgt_dict

    def log_recon_figure(self, dataset, load_kwargs: dict, step: int, every: int = 10000):
        """Save a recon-vs-input grid to the run dir every `every` steps
        (engine/abstract_engine.py:103-106, forgery_engine.py:379-386).
        Without matplotlib (GPU hosts may lack it) the figure is skipped
        with a note, not the run. Rank 0 alone draws it."""
        if self.run_dir is None or step % every != 0 or len(dataset) < 4 or not self.dp.primary:
            return
        import importlib.util

        if importlib.util.find_spec("matplotlib") is None:
            self._mprint(f"Recon figure of step {step} skipped: matplotlib is not installed.")
            return
        from unidefense_torch.utils.visualize import plot_recon_figure

        idx = list(range(4))
        items = [dataset[i][0] for i in idx]
        labels = [int(dataset[i][1]) for i in idx]
        out = dataset.load_item(items, labels, **load_kwargs)
        model = self.state.model
        model.eval()
        try:
            _, cls_out, rec = self.eval_step(torch.from_numpy(out["images"]).to(self.device))
        finally:
            model.train()
        inputs = out["images"].astype(np.float32) / 255.0
        recs = nhwc(rec).float().cpu().numpy()
        fig = plot_recon_figure(
            list(inputs) + list(recs), ("input", "recon"),
            cls_out.float().cpu().numpy(), labels, categories=dataset.categories,
        )
        fig_path = os.path.join(self.run_dir, f"recon_step{step}.png")
        try:
            fig.savefig(fig_path)
            if self.logger is not None:
                self.logger.log_image("figure/recon", fig, step)
        except Exception:
            pass
        finally:
            import matplotlib.pyplot as plt

            plt.close(fig)

    def gather_eval_output(self, prob_dict: dict, tgt_dict: dict) -> dict:
        """Every rank's stripe, gathered (dist.all_gather_object,
        engine/forgery_engine.py:373-390), merged and aggregated to
        frame/video lists; every rank gets the same lists."""
        gathered = all_gather_objects(prob_dict, tgt_dict, group=self.dp.group)
        return merge_video_dicts([g[0] for g in gathered], [g[1] for g in gathered])

    def train(self):
        raise NotImplementedError

    def validate(self, step: int, timer: Timer):
        raise NotImplementedError

    def test(self):
        raise NotImplementedError
