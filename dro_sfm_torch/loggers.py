"""Experiment loggers: Weights & Biases, or a no-op.

The port's copy of `dro_sfm_tpu/loggers.py`. ``wandb`` is imported only
inside `WandbLogger`; without it, or with ``dry_run``, logging is a no-op.
`WandbLogger.log_depth_images` logs the first sample's image and its
colormapped inverse depth (`viz_inv_depth`), taken off the card.
"""
from __future__ import annotations

from typing import Dict


class NoOpLogger:
    """Swallow all logging calls."""

    def log_config(self, config) -> None:  # noqa: D102
        pass

    def log_metrics(self, metrics: Dict) -> None:  # noqa: D102
        pass

    def log_depth_images(self, prefix, batch, output, step: int = 0) -> None:  # noqa: D102
        pass

    def finish(self) -> None:  # noqa: D102
        pass


class WandbLogger(NoOpLogger):
    """Weights & Biases logger: the run, its config and its metrics."""

    def __init__(self, name: str = "", project: str = "", entity: str = "",
                 tags=(), dir: str = ""):
        import wandb  # raises ImportError -> make_logger falls back to NoOpLogger
        self._wandb = wandb
        self.run = wandb.init(name=name or None, project=project or None,
                              entity=entity or None, tags=list(tags),
                              dir=dir or None)

    def log_config(self, config) -> None:
        self.run.config.update(
            config.to_dict() if hasattr(config, "to_dict") else config,
            allow_val_change=True)

    def log_metrics(self, metrics: Dict) -> None:
        self._wandb.log({k: float(v) for k, v in metrics.items()})

    def log_depth_images(self, prefix, batch, output, step: int = 0) -> None:
        """The rgb and inverse-depth panels of the batch's first sample."""
        from dro_sfm_torch.utils.depth import viz_inv_depth
        from dro_sfm_torch.utils.save import to_host
        rgb = to_host(batch["rgb"][0])
        inv = to_host(output["inv_depth_pp"][0])
        self._wandb.log({
            f"{prefix}-rgb": self._wandb.Image(rgb),
            f"{prefix}-inv_depth": self._wandb.Image(viz_inv_depth(inv)),
        }, step=step)

    def finish(self) -> None:
        self.run.finish()


def make_logger(wandb_cfg, name: str = "") -> NoOpLogger:
    """The configured logger; a no-op without wandb or with ``dry_run``."""
    if getattr(wandb_cfg, "dry_run", True):
        return NoOpLogger()
    try:
        return WandbLogger(name=wandb_cfg.name or name,
                           project=wandb_cfg.project,
                           entity=wandb_cfg.entity,
                           tags=wandb_cfg.tags, dir=wandb_cfg.dir)
    except ImportError:
        return NoOpLogger()
