"""Checkpoints of the whole training state, and top-k management.

PyTorch counterpart of `dro_sfm_tpu/training/checkpoint.py`. The port
writes its own format: a ``torch.save`` file holding the net's state dict
(parameters and BatchNorm statistics), the optimizer's state dict (Adam's
moments) and the step, read back with ``torch.load(weights_only=True)``, so
a resumed run continues bit for bit. Beside it, a ``<path>.json`` sidecar
holds the epoch, the step, the config and the format marker.

It also reads the JAX package's checkpoints: flax msgpack of ``{params,
batch_stats, opt_state, step}`` (`dro_sfm_torch.utils.msgpack`), with the
legacy mask-head layout migrated, the weights carried over by
`convert.from_jax_variables` and the optax state by
`convert.optimizer_state_from_jax`. The format is decided by the content: a
zip file is the port's, anything else is msgpack.

`CheckpointManager` keeps the best ``save_top_k`` checkpoints of a
monitored metric (the direction inferred from its name) and can mirror the
directory to remote storage (`sync_checkpoint_dir`).
"""
from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from dro_sfm_torch.convert import LayoutMismatch, from_jax_variables, optimizer_state_from_jax
from dro_sfm_torch.utils.msgpack import unpackb

FORMAT = "dro_sfm_torch"
_FOREIGN = ("is a zip file but not a checkpoint of dro_sfm_torch (the JAX "
            "package's checkpoints are flax msgpack)")
# The JAX package's note when the optimizer's layout does not match
# (dro_sfm_tpu/training/checkpoint.py:load_checkpoint).
LAYOUT_NOTE = ("checkpoint: optimizer state layout mismatch — restored "
               "weights/step only, optimizer reinitialized")


def save_checkpoint(path: str, state, epoch: int,
                    config: Optional[Dict] = None) -> None:
    """Write ``state`` (a `TrainState`) to ``path`` and its sidecar."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"format": FORMAT,
               "net": state.net.state_dict(),
               "optimizer": state.optimizer.torch_optimizer.state_dict(),
               "step": int(state.step)}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    meta = {"format": FORMAT, "epoch": epoch, "step": int(state.step)}
    if config is not None:
        meta["config"] = config
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def _migrate_legacy_layout(tree) -> None:
    """Rewrite pre-mask-hoist trees in place: the convex-upsample mask convs
    moved from ``refinement/update_block_depth/cell/mask{1,2}`` to
    ``refinement/mask_head/mask{1,2}``, wherever the pattern occurs (params
    and every param-shaped optimizer moment). A copy of the JAX package's
    function of the same name."""
    if not isinstance(tree, dict):
        return
    ref = tree.get("refinement")
    if isinstance(ref, dict):
        cell = ref.get("update_block_depth", {}).get("cell", {})
        if isinstance(cell, dict) and ("mask1" in cell or "mask2" in cell):
            head = ref.setdefault("mask_head", {})
            for k in ("mask1", "mask2"):
                if k in cell:
                    head[k] = cell.pop(k)
    for v in tree.values():
        _migrate_legacy_layout(v)


def read_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The tree of a JAX package checkpoint (or of any flax msgpack file),
    legacy layout migrated. Raises ValueError on bytes that are not msgpack
    of flax's subset or hold no map."""
    with open(path, "rb") as f:
        raw = unpackb(f.read())
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: a flax msgpack file holds a map, this one a "
                         f"{type(raw).__name__}")
    _migrate_legacy_layout(raw)
    return raw


def _restore_jax(path: str, raw: Dict[str, Any], state) -> None:
    """Restore the net strictly and the step; Adam's moments where the
    optimizer's layout matches, else the JAX package's note."""
    missing = [k for k in ("params", "step") if k not in raw]
    if missing:
        raise ValueError(f"{path}: no {missing} in this JAX checkpoint")
    state.net.load_state_dict(from_jax_variables(
        {"params": raw["params"], "batch_stats": raw.get("batch_stats", {})}), strict=True)
    state.step = int(raw["step"])
    try:
        optimizer_state_from_jax(raw.get("opt_state", {}), state.net, state.optimizer)
    except LayoutMismatch as e:
        print(f"{LAYOUT_NOTE} ({e})", flush=True)


def load_checkpoint(path: str, state=None) -> Dict[str, Any]:
    """Read a checkpoint of the port or of the JAX package: {"payload": ...,
    "meta": sidecar}. The payload is the port's dict (``format``, ``net``,
    ``optimizer``, ``step``) or the JAX package's tree (``params``,
    ``batch_stats``, ``opt_state``, ``step``). With ``state`` given, restore
    the net (strictly), the optimizer and the step into it."""
    meta: Dict[str, Any] = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    if not zipfile.is_zipfile(path):
        raw = read_jax_checkpoint(path)
        if state is not None:
            _restore_jax(path, raw, state)
        return {"payload": raw, "meta": meta}
    if meta and meta.get("format") != FORMAT:
        raise ValueError(f"{path} {_FOREIGN}")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} {_FOREIGN}")
    if state is not None:
        state.net.load_state_dict(payload["net"], strict=True)
        state.optimizer.torch_optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
    return {"payload": payload, "meta": meta}


def sync_checkpoint_dir(local_dir: str, remote_url: str) -> bool:
    """Mirror the checkpoint directory to remote storage: ``gs://`` with
    ``gcloud storage rsync`` (or ``gsutil``), ``s3://`` with ``aws s3
    sync``, a plain or ``file://`` path with shutil. Returns success;
    failures are printed and never interrupt training."""
    import shutil
    import subprocess
    try:
        if remote_url.startswith("gs://"):
            for cmd in (["gcloud", "storage", "rsync", "-r"],
                        ["gsutil", "-m", "rsync", "-r"]):
                if shutil.which(cmd[0]):
                    subprocess.run(cmd + [local_dir, remote_url], check=True,
                                   timeout=600, capture_output=True)
                    return True
            print(f"checkpoint sync skipped: no gcloud/gsutil for {remote_url}")
            return False
        if remote_url.startswith("s3://"):
            if shutil.which("aws"):
                subprocess.run(
                    ["aws", "s3", "sync", local_dir, remote_url,
                     "--acl", "bucket-owner-full-control", "--quiet"],
                    check=True, timeout=600, capture_output=True)
                return True
            print(f"checkpoint sync skipped: no aws CLI for {remote_url}")
            return False
        dest = remote_url[len("file://"):] if remote_url.startswith("file://") \
            else remote_url
        os.makedirs(dest, exist_ok=True)
        for name in os.listdir(local_dir):
            src = os.path.join(local_dir, name)
            if os.path.isfile(src):
                shutil.copy2(src, os.path.join(dest, name))
        # --delete semantics: drop remote files that are gone locally.
        for name in os.listdir(dest):
            if not os.path.exists(os.path.join(local_dir, name)):
                os.remove(os.path.join(dest, name))
        return True
    except (OSError, subprocess.SubprocessError) as e:
        print(f"checkpoint sync to {remote_url} failed: {e}")
        return False


class CheckpointManager:
    """Keep the best ``save_top_k`` checkpoints of the metric ``monitor``.

    ``mode="auto"`` infers the direction from the name: a1/a2/a3 increase,
    error metrics decrease. ``sync_url`` / ``sync_frequency`` mirror the
    directory to remote storage every N epochs. ``save_code`` archives the
    source tree (``git archive HEAD``) beside the checkpoints.
    """

    def __init__(self, dirpath: str, monitor: str = "abs_rel_pp_gt",
                 save_top_k: int = 5, mode: str = "auto",
                 save_code: bool = True, sync_url: str = "",
                 sync_frequency: int = 1):
        self.dirpath = dirpath
        self.monitor = monitor
        self.save_top_k = save_top_k
        if mode == "auto":
            mode = "max" if re.search(r"\ba[123]\b|a1|a2|a3", monitor) else "min"
        self.mode = mode
        self.saved: list[tuple[float, str]] = []
        self.sync_url = sync_url
        self.sync_frequency = sync_frequency
        self._sync_pending = False
        os.makedirs(dirpath, exist_ok=True)
        if save_code:
            self._snapshot_code()

    def _snapshot_code(self) -> None:
        """``git archive HEAD`` of the repository into ``code.tar.gz``;
        nothing outside a git checkout."""
        import subprocess
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        target = os.path.join(self.dirpath, "code.tar.gz")
        try:
            with open(target, "wb") as f:
                subprocess.run(["git", "archive", "--format=tar.gz", "HEAD"],
                               cwd=repo, stdout=f, stderr=subprocess.DEVNULL,
                               timeout=60, check=True)
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(target):
                os.remove(target)

    def _improved(self, value: float) -> bool:
        if len(self.saved) < self.save_top_k:
            return True
        vals = [v for v, _ in self.saved]
        if self.mode == "min":
            return value < max(vals)
        return value > min(vals)

    def check_and_save(self, state, epoch: int, metrics: Dict[str, float],
                       config: Optional[Dict] = None) -> Optional[str]:
        """Save if the monitored metric ranks among the best; prune the rest.
        Returns the saved path or None."""
        value = float(metrics.get(self.monitor, np.nan))
        path = None
        if not np.isnan(value) and self._improved(value):
            fname = f"epoch={epoch:02d}_{self.monitor}={value:.3f}.ckpt"
            path = os.path.join(self.dirpath, fname)
            save_checkpoint(path, state, epoch, config)
            self.saved.append((value, path))
            self.saved.sort(reverse=(self.mode == "max"))
            while len(self.saved) > self.save_top_k:
                _, stale = self.saved.pop()
                for p in (stale, stale + ".json"):
                    if os.path.exists(p):
                        os.remove(p)
            self._sync_pending = True
        # Sync on the epoch schedule whenever anything changed since the
        # last sync, so saves that land off the schedule still reach it.
        if self.sync_url and self.sync_frequency > 0 and self._sync_pending \
                and (epoch + 1) % self.sync_frequency == 0:
            sync_checkpoint_dir(self.dirpath, self.sync_url)
            self._sync_pending = False
        return path
