"""The trainer: datasets, steps, state, checkpoints and the epoch loops.

PyTorch counterpart of `dro_sfm_tpu/training/trainer.py`, in one process
or in several, one device each (`parallel/`). The Trainer owns the config,
the datasets and loaders, the training step (`make_train_step`) and the
flip-fused evaluation step (`make_eval_step`), the training state (the
net, Adam and the step), the top-k checkpoints and the metric sums. On the
card the training step runs kernels K1, K2 and K3 (and K5, K6 with
``sep_conv: "pallas"``) and every evaluation batch runs K1 (and K5); the
single-frame tasks run no kernel. Warm starts
(``model.depth_net.pretrained_encoders``, then ``model.checkpoint_path``)
and resumes read the JAX package's flax msgpack files as well as the
port's checkpoints.

In several processes (`scripts/launch_multihost.py` or ``torchrun``) each
process reads its shard of every epoch (``datasets.*.batch_size`` is per
process, as in the JAX package) and the training step computes the step
over the global batch (`training/step.py`). The weights start as process
0's. Validation sums its metrics over the processes and checks that every
sample was seen once; the preemption stop is agreed by all processes at
shared points; process 0 alone prints, logs, saves depth files and writes
checkpoints.

With ``arch.spatial_shards`` = S > 1 the world is D = world / S data
shards of S spatial ranks (`parallel/mesh.py:Layout`, the JAX package's
(data, spatial) mesh): each epoch is sharded over the data index, and each
spatial rank keeps its band of rows of the image keys (`parallel/spatial.py`),
in training and in validation, whose metrics count each sample once.
Checkpoints hold no layout and resume with any S. Every task runs the
split; the single-frame tasks need H >= 32 S, the multi-frame ones H >= 16 S
(`SfmModelConfig.deepest_stride`).
"""
from __future__ import annotations

import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from dro_sfm_torch.data import make_loader, setup_dataset
from dro_sfm_torch.data.loader import device_prefetch, to_device
from dro_sfm_torch.loggers import NoOpLogger, make_logger
from dro_sfm_torch.losses.photometric import PhotometricLossConfig
from dro_sfm_torch.models.sfm import SfmModelConfig, resolve_memory_policy
from dro_sfm_torch.parallel import spatial
from dro_sfm_torch.parallel.collectives import (
    all_reduce_metric_sums,
    any_process_flag,
    broadcast_tensors,
)
from dro_sfm_torch.parallel.mesh import (
    is_rank0,
    local_device,
    make_layout,
    maybe_init_distributed,
    process_count,
)
from dro_sfm_torch.training.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
    sync_checkpoint_dir,
)
from dro_sfm_torch.training.init_weights import warm_start
from dro_sfm_torch.training.metrics import (
    ALL_METRIC_NAMES,
    METRIC_MODES,
    MetricsConfig,
    compute_pose_metrics,
)
from dro_sfm_torch.training.state import create_train_state, group_schedule, make_optimizer
from dro_sfm_torch.training.step import EVAL_KEYS, make_eval_step, make_train_step
from dro_sfm_torch.utils.logging import AvgMeter, pcolor, print_metrics_table
from dro_sfm_torch.utils.save import save_depth


def model_config_from(cfg) -> SfmModelConfig:
    """The task-model config of a full config. The "auto" memory knobs
    resolve for the training batch and image size."""
    loss = cfg.model.loss
    remat, scan_unroll = resolve_memory_policy(
        cfg.model.depth_net.get("remat", True),
        cfg.model.depth_net.get("scan_unroll", "none"),
        cfg.datasets.train.batch_size,
        cfg.datasets.augmentation.image_shape)
    return SfmModelConfig(
        name=cfg.model.name,
        version=cfg.model.depth_net.version,
        min_depth=cfg.model.params.min_depth or 0.1,
        max_depth=cfg.model.params.max_depth,
        mixed_precision=bool(cfg.model.depth_net.get("mixed_precision", False)),
        warp_impl=cfg.model.depth_net.get("warp_impl", "gather"),
        sep_conv=cfg.model.depth_net.get("sep_conv", "conv"),
        remat=remat,
        scan_unroll=scan_unroll,
        flip_lr_prob=loss.flip_lr_prob,
        supervised_loss_weight=loss.supervised_loss_weight,
        progressive_scaling=loss.get("progressive_scaling", 0.0),
        percep_pretrained=cfg.model.percep_net.checkpoint_path,
        photometric=PhotometricLossConfig(
            percep_loss_weight=loss.get("percep_loss_weight", 0.0),
            ssim_loss_weight=loss.ssim_loss_weight,
            smooth_loss_weight=loss.smooth_loss_weight,
            c1=loss.C1, c2=loss.C2,
            photometric_reduce_op=loss.photometric_reduce_op,
            clip_loss=loss.clip_loss,
            automask_loss=loss.automask_loss))


def flip_generator(seed: int, epoch: int) -> torch.Generator:
    """The generator of an epoch's random flips."""
    return torch.Generator().manual_seed(seed * 1_000_003 + epoch)


class Trainer:
    """Train and evaluate ``cfg`` on ``device`` (the card unless the caller
    asks for the CPU; in several processes this process's card), from the
    config's initialisation (warm-started as the config says) or, with
    ``resume``, from a checkpoint of this package or of the JAX package
    (continuing with the epoch after the saved one). It joins the process
    group that the environment describes, unless the caller made one."""

    def __init__(self, cfg, resume: Optional[str] = None, device=None):
        self.cfg = cfg
        self.device = local_device(device)
        maybe_init_distributed(self.device)       # before the loaders shard
        self.model_cfg = model_config_from(cfg)
        self.layout = self._make_layout(int(cfg.arch.get("spatial_shards", 1)))
        shard = ({} if self.layout is None else
                 {"num_shards": self.layout.data, "shard_id": self.layout.data_index})
        self.metrics_cfg = MetricsConfig(
            crop=cfg.model.params.crop,
            min_depth=cfg.model.params.min_depth,
            max_depth=cfg.model.params.max_depth)

        # Datasets and loaders. Evaluation datasets stay apart: one loader and
        # metric suffix each. Training data is optional (evaluation runs).
        aug = cfg.datasets.augmentation
        self.train_dataset = None
        self.train_loader = None
        if cfg.datasets.train.dataset:
            self.train_dataset = setup_dataset(cfg.datasets.train, aug, "train")
            self.train_loader = make_loader(
                self.train_dataset, cfg.datasets.train.batch_size, "train",
                num_workers=cfg.datasets.train.num_workers, seed=cfg.arch.seed, **shard)
        self.val_datasets = (
            setup_dataset(cfg.datasets.validation, aug, "validation")
            if cfg.datasets.validation.dataset else [])
        self.test_datasets = None
        if cfg.datasets.test.dataset:
            self.test_datasets = setup_dataset(cfg.datasets.test, aug, "test")
        self.val_loaders = [
            make_loader(ds, cfg.datasets.validation.batch_size, "validation",
                        num_workers=cfg.datasets.validation.num_workers, **shard)
            for ds in self.val_datasets]

        # Net, optimizer and state.
        steps_per_epoch = (max(1, len(self.train_loader))
                           if self.train_loader is not None else 1)
        self.net = self.model_cfg.build_net(
            device=self.device, generator=torch.Generator().manual_seed(cfg.arch.seed))
        warm_start(self.net, cfg.model.depth_net.get("pretrained_encoders", ""),
                   cfg.model.checkpoint_path)
        self.optimizer = make_optimizer(self.net, cfg.model.optimizer,
                                        cfg.model.scheduler, steps_per_epoch)
        self.state = create_train_state(self.net, self.optimizer, device=self.device)
        # The groups' schedules, for the rates reported to the logger (the
        # pose group differs only for the single-frame tasks' pose_net).
        self._lr_fn = group_schedule(cfg.model.optimizer.depth, cfg.model.scheduler,
                                     steps_per_epoch)
        self._pose_lr_fn = (group_schedule(cfg.model.optimizer.pose, cfg.model.scheduler,
                                           steps_per_epoch, "pose")
                            if self.model_cfg.single_frame else None)
        self.current_epoch = 0
        if resume:
            restored = load_checkpoint(resume, self.state)
            # Checkpoints are written at the end of an epoch: go on with the next.
            self.current_epoch = int(restored["meta"].get("epoch", -1)) + 1
        # Every process starts from process 0's weights.
        broadcast_tensors(list(self.net.parameters()) + list(self.net.buffers()))

        self.train_step = make_train_step(self.model_cfg, self.net, self.optimizer,
                                          device=self.device)
        # One evaluation step per DeMoN-scaling flag: the scaling applies per
        # evaluation dataset.
        self._eval_steps: Dict[bool, object] = {}
        # Process 0 alone archives the code: processes that share the folder
        # would write (and, outside a git checkout, remove) one file at once.
        self.checkpointer = CheckpointManager(
            cfg.checkpoint.filepath, monitor=cfg.checkpoint.monitor,
            save_top_k=cfg.checkpoint.save_top_k, mode=cfg.checkpoint.mode,
            save_code=is_rank0(),
            sync_url=cfg.checkpoint.get("s3_url", "") or cfg.checkpoint.get("s3_path", ""),
            sync_frequency=int(cfg.checkpoint.get("s3_frequency", 1)))
        self.metric_keys = ALL_METRIC_NAMES
        self.logger = make_logger(cfg.wandb, cfg.name) if is_rank0() else NoOpLogger()
        self.logger.log_config(cfg)
        self._preempted = False

    def _make_layout(self, spatial_shards: int):
        """The (data, spatial) layout of ``arch.spatial_shards`` (None for
        1), with the JAX package's checks as ValueError: H/8 divides by S and
        every band reaches the net's deepest stride, H >= 16 S (32 S for the
        single-frame tasks; `spatial.Band`), and S divides the world size
        (`make_layout`)."""
        if spatial_shards == 1:
            return None
        spatial.Band(self.cfg.datasets.augmentation.image_shape[0], spatial_shards, 0,
                     deepest=self.model_cfg.deepest_stride)
        return make_layout(spatial_shards)

    # ------------------------------------------------------------------
    def _place(self, batch) -> Dict[str, torch.Tensor]:
        """An evaluation batch on the device: under a height split this
        rank's rows of the images, the ground truth whole."""
        return to_device(spatial.split_rows(batch, self.layout, ("rgb", "rgb_context")),
                         self.device, EVAL_KEYS)

    def _place_train(self, batch) -> Dict[str, torch.Tensor]:
        return to_device(spatial.split_rows(batch, self.layout), self.device,
                         self.model_cfg.batch_keys)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        self.train_loader.set_epoch(epoch)
        avg = AvgMeter(50)
        t0 = time.time()
        n_frames = 0
        flips = flip_generator(self.cfg.arch.seed, epoch)
        # Training progress for the progressive loss scaling.
        progress = float(epoch) / max(self.cfg.arch.max_epochs, 1)
        several = process_count() > 1
        # Batch i+1's host-to-device copy overlaps batch i's step.
        for i, (batch, arrays) in enumerate(
                device_prefetch(self.train_loader, self._place_train, depth=2)):
            # Stop on preemption (fit() saves the emergency checkpoint); in
            # several processes only at the shared 10-step cadence and by
            # consensus, since a process that stops alone leaves the others
            # waiting in the next sum.
            if several:
                if i % 10 == 0 and self._preempt_consensus():
                    break
            elif self._preempted:
                break
            self.state, metrics = self.train_step(self.state, arrays, flips, progress)
            n_frames += batch["rgb"].shape[0]
            if (i + 1) % 10 == 0 or i == 0:
                last_loss = float(metrics["loss"])
                run_avg = avg(last_loss)
                if not is_rank0():
                    continue                 # the other processes print nothing
                dt = time.time() - t0
                print(f"epoch {epoch:03d} step {i + 1:05d}/{len(self.train_loader):05d} "
                      f"loss {last_loss:.4f} (avg {run_avg:.4f}) "
                      f"{n_frames / dt:.1f} frames/s", flush=True)
                step_metrics = {"train-loss-step": last_loss,
                                "learning_rate": float(self._lr_fn(self.state.step)),
                                "global_step": self.state.step}
                if self._pose_lr_fn is not None:
                    step_metrics["learning_rate_pose"] = float(
                        self._pose_lr_fn(self.state.step))
                self.logger.log_metrics(step_metrics)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.time() - t0
        return {"avg_train-loss": avg.get(),
                "train_frames_per_sec": n_frames / max(dt, 1e-9)}

    # ------------------------------------------------------------------
    def validate_all(self, loaders=None, split: str = "validation",
                     save_artifacts: bool = False) -> Dict[str, float]:
        """Evaluate every dataset of a split: the first gives the unsuffixed
        (monitored) metrics, and each the metrics suffixed -<i>."""
        loaders = loaders if loaders is not None else self.val_loaders
        section = self.cfg.datasets[split]
        results: Dict[str, float] = {}
        for i, loader in enumerate(loaders):
            ds_name = section.dataset[i] if i < len(section.dataset) else ""
            name = f"{ds_name}-{section.split[i]}" if i < len(section.dataset) \
                else f"{split}-{i}"
            r = self.validate(loader, dataset_name=name, save_artifacts=save_artifacts,
                              demon_scaling=(ds_name == "Demon"))
            if i == 0:
                results.update(r)
            results.update({f"{k}-{i}": v for k, v in r.items()})
        return results

    def eval_step_for(self, demon_scaling: bool = False):
        """The evaluation step for one dataset's metric mode (cached)."""
        step = self._eval_steps.get(demon_scaling)
        if step is None:
            step = make_eval_step(self.model_cfg, self.net, self.metrics_cfg,
                                  demon_scaling=demon_scaling, device=self.device)
            self._eval_steps[demon_scaling] = step
        return step

    def validate(self, loader=None, dataset_name: str = "validation",
                 save_artifacts: bool = False,
                 demon_scaling: bool = False) -> Dict[str, float]:
        """Mean metrics over one dataset: the depth metrics summed over the
        valid samples of every batch, the pose metrics (first sample of a
        batch) averaged over batches."""
        loader = loader or self.val_loaders[0]
        eval_step = self.eval_step_for(demon_scaling)
        sums = {m: np.zeros(9) for m in METRIC_MODES}
        pose_sum = np.zeros(3)
        count = 0
        n_batches = 0
        num_logs = self.cfg.wandb.get("num_logs", 5)
        img_interval = max(1, len(loader) // max(num_logs, 1))
        single = process_count() == 1
        for batch in loader:
            if single and self._preempted:   # the grace time is short; fit() saves now
                break
            out = eval_step(self._place(batch))
            if n_batches % img_interval == 0:
                self.logger.log_depth_images(dataset_name, batch, out,
                                             step=self.state.step + n_batches)
            if save_artifacts and is_rank0():
                save_depth(batch, out, self.cfg.save)
            valid = batch["valid"]
            if out["metrics"] is not None:
                m = out["metrics"].cpu().numpy()            # [4,B,9]
                for mi, mode in enumerate(METRIC_MODES):
                    sums[mode] += m[mi][valid].sum(axis=0)
            if "pose_context" in batch:
                pose_sum += compute_pose_metrics(batch["pose_context"],
                                                 out["pose"].cpu().numpy())
            count += int(valid.sum())
            n_batches += 1
        # The sums over the processes. Padding duplicates carry valid=False:
        # every sample of the dataset counts once, or this raises.
        stacked, count = all_reduce_metric_sums(
            np.concatenate([sums[m] for m in METRIC_MODES] + [pose_sum, [n_batches]]),
            count, expected_total=None if single and self._preempted else len(loader.dataset))
        for i, m in enumerate(METRIC_MODES):
            sums[m] = stacked[i * 9:(i + 1) * 9]
        pose_sum, n_batches = stacked[len(METRIC_MODES) * 9:-1], int(round(stacked[-1]))
        results: Dict[str, float] = {}
        table = {}
        pose_vec = pose_sum / max(n_batches, 1)
        for mode in METRIC_MODES:
            full = np.concatenate([sums[mode] / max(count, 1), pose_vec])
            table[f"depth{mode}"] = full
            for name, value in zip(self.metric_keys, full):
                results[f"{name}{mode}"] = float(value)
        if is_rank0():
            print_metrics_table(table, self.metric_keys,
                                title=f"{dataset_name} epoch {self.current_epoch}")
        return results

    # -- preemption: SIGTERM, an emergency checkpoint, resume ----------------
    def _request_preemption(self, signum=None, frame=None):
        """SIGTERM handler: finish the current step, then checkpoint and
        leave the fit loop."""
        self._preempted = True

    def _install_preempt_handler(self):
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, self._request_preemption)
        except ValueError:                   # not the main thread
            self._prev_sigterm = None

    def _restore_preempt_handler(self):
        if getattr(self, "_prev_sigterm", None) is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)

    def _preempt_consensus(self) -> bool:
        """Whether any process got SIGTERM (each process's own flag with one
        process). SIGTERM may reach some processes only, or at other steps:
        all call this at the same points and stop together."""
        self._preempted = any_process_flag(self._preempted)
        return self._preempted

    def _save_preempt_checkpoint(self, epoch: int) -> None:
        """``preempt_epoch=NN.ckpt``, recorded as epoch ``epoch - 1``, so a
        resume re-runs epoch ``epoch``."""
        path = os.path.join(self.checkpointer.dirpath, f"preempt_epoch={epoch:02d}.ckpt")
        save_checkpoint(path, self.state, epoch - 1, config=self.cfg.to_dict())
        if self.checkpointer.sync_url:
            sync_checkpoint_dir(self.checkpointer.dirpath, self.checkpointer.sync_url)
        print(pcolor(f"preempted: state saved to {path}; resume with "
                     f"python -m dro_sfm_torch.scripts.train {path}", "yellow"),
              flush=True)

    def fit(self) -> Dict[str, float]:
        """Train from the current epoch to ``arch.max_epochs``, validating
        and checkpointing after each epoch. Returns the last epoch's train
        and validation metrics."""
        if self.train_loader is None:
            raise ValueError("fit() requires datasets.train.dataset; this "
                             "trainer was built for evaluation only")
        cfg = self.cfg
        metrics: Dict[str, float] = {}
        self._preempted = False
        self._install_preempt_handler()
        try:
            for epoch in range(self.current_epoch, cfg.arch.max_epochs):
                self.current_epoch = epoch
                train_metrics = self.train_epoch(epoch)
                if self._preempt_consensus():
                    # Mid-epoch stop: the partial epoch re-runs on resume.
                    if is_rank0():
                        self._save_preempt_checkpoint(epoch)
                    break
                val_metrics = self.validate_all()
                metrics = {**train_metrics, **val_metrics}
                if self._preempt_consensus():
                    # During validation: save now, skip the top-k save.
                    if is_rank0():
                        self._save_preempt_checkpoint(epoch + 1)
                    break
                if is_rank0():
                    self.checkpointer.check_and_save(self.state, epoch, val_metrics,
                                                     config=cfg.to_dict())
                self.logger.log_metrics({**metrics, "epoch": epoch})
        finally:
            self._restore_preempt_handler()
        return metrics

    def test(self, save_artifacts: bool = False) -> Dict[str, float]:
        """Evaluate the test datasets; with ``save_artifacts`` also write
        the depth files and images that ``save.depth`` asks for."""
        if self.test_datasets is None:
            raise ValueError("No test dataset configured")
        loaders = [make_loader(ds, self.cfg.datasets.test.batch_size, "test",
                               num_workers=self.cfg.datasets.test.num_workers)
                   for ds in self.test_datasets]
        return self.validate_all(loaders, split="test", save_artifacts=save_artifacts)
