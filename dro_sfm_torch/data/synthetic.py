"""Procedural multi-view scenes with exact ground truth.

The port's copy of `dro_sfm_tpu/data/synthetic.py`: photometrically
consistent views of textured planes rendered analytically, with exact depth
maps and relative poses, so no dataset download is needed.

Scene model: one slanted textured plane per scene (``num_planes`` > 1 adds
nearer finite patches, composited by nearest hit), the camera translating
and rotating between frames. Each pixel's ray is intersected with the planes
in closed form; the colour comes from a smooth procedural texture (a sum of
sinusoids), so every view is exact at any resolution.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from dro_sfm_torch.data.base import Sample, relative_pose, sample_rng
from dro_sfm_torch.data.transforms import eval_transform, train_transform


def _texture(u: np.ndarray, v: np.ndarray, freqs: np.ndarray,
             phases: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Smooth procedural RGB texture evaluated at (u, v) plane coords.

    freqs [K,2], phases [K,3], weights [K,3].
    """
    out = np.zeros((*u.shape, 3), dtype=np.float64)
    for k in range(freqs.shape[0]):
        a = 2 * np.pi * (u * freqs[k, 0] + v * freqs[k, 1])
        for c in range(3):
            out[..., c] += weights[k, c] * np.sin(a + phases[k, c])
    return (0.5 + 0.5 * out / np.abs(weights).sum(axis=0)).astype(np.float32)


@dataclasses.dataclass
class SyntheticConfig:
    num_scenes: int = 8
    height: int = 96
    width: int = 128
    num_context: int = 2
    seed: int = 0
    max_rotation: float = 0.03     # radians between frames
    max_translation: float = 0.15  # meters between frames
    with_depth: bool = True
    with_pose: bool = True
    # Surfaces per scene (nearest-hit compositing). 1 = one tilted plane,
    # which is degenerate for self-supervised evaluation (a homography
    # continuum of depth and pose explains two views of a plane).
    num_planes: int = 1


class SyntheticDataset:
    """Renders deterministic scenes; one sample per (scene) index."""

    def __init__(self, cfg: SyntheticConfig, mode: str = "train",
                 image_shape: Optional[Sequence[int]] = None,
                 jittering: Sequence[float] = ()):
        self.cfg = cfg
        self.mode = mode
        self.image_shape = tuple(image_shape) if image_shape else None
        self.jittering = tuple(jittering)
        h, w = cfg.height, cfg.width
        f = 0.9 * w
        self.K = np.array([[f, 0.0, (w - 1) / 2],
                           [0.0, f, (h - 1) / 2],
                           [0.0, 0.0, 1.0]], dtype=np.float32)

    def __len__(self) -> int:
        return self.cfg.num_scenes

    # ------------------------------------------------------------------
    def _scene(self, idx: int):
        rng = np.random.default_rng(self.cfg.seed * 10007 + idx)
        planes = []
        for k in range(max(1, self.cfg.num_planes)):
            # Plane 0: z ~ 3-6 m, mildly tilted. Extra planes: nearer, more
            # tilted, laterally offset, so the composite has depth edges.
            if k == 0:
                normal = np.array([rng.uniform(-0.25, 0.25),
                                   rng.uniform(-0.25, 0.25), -1.0])
                p0 = np.array([0.0, 0.0, rng.uniform(3.0, 6.0)])
                extent = np.inf         # backdrop covers the view
            else:
                normal = np.array([rng.uniform(-0.45, 0.45),
                                   rng.uniform(-0.45, 0.45), -1.0])
                p0 = np.array([rng.uniform(-1.2, 1.2),
                               rng.uniform(-0.8, 0.8),
                               rng.uniform(1.8, 4.0)])
                # Finite patch: foreground planes occlude only part of
                # the backdrop, guaranteeing depth discontinuities.
                extent = rng.uniform(0.4, 1.1)
            normal = normal / np.linalg.norm(normal)
            # Plane tangent basis
            eu = np.cross(normal, [0.0, 1.0, 0.0])
            eu /= np.linalg.norm(eu)
            ev = np.cross(normal, eu)
            tex = {
                "freqs": rng.uniform(0.15, 1.2, size=(6, 2)),
                "phases": rng.uniform(0, 2 * np.pi, size=(6, 3)),
                "weights": rng.uniform(0.3, 1.0, size=(6, 3)),
            }
            planes.append((normal, p0, eu, ev, tex, extent))
        # Camera-to-world poses: target = identity, contexts perturbed.
        poses = [np.eye(4)]
        for _ in range(self.cfg.num_context):
            angle = rng.uniform(-self.cfg.max_rotation,
                                self.cfg.max_rotation, size=3)
            trans = rng.uniform(-self.cfg.max_translation,
                                self.cfg.max_translation, size=3)
            T = np.eye(4)
            cx, cy, cz = np.cos(angle)
            sx, sy, sz = np.sin(angle)
            rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
            ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            T[:3, :3] = rx @ ry @ rz
            T[:3, 3] = trans
            poses.append(T)
        return planes, poses

    def _render(self, planes, pose_c2w):
        """Render one view (nearest-hit over planes): RGB [H,W,3]
        float32 and depth [H,W,1]."""
        h, w = self.cfg.height, self.cfg.width
        Kinv = np.linalg.inv(self.K.astype(np.float64))
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        rays_cam = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ Kinv.T
        R, t = pose_c2w[:3, :3], pose_c2w[:3, 3]
        rays_w = rays_cam @ R.T

        best_s = np.full((h, w), np.inf)
        rgb = np.zeros((h, w, 3), dtype=np.float32)
        for normal, p0, eu, ev, tex, extent in planes:
            denom = rays_w @ normal
            with np.errstate(divide="ignore", invalid="ignore"):
                s = ((p0 - t) @ normal) / denom  # z in cam frame (ray z=1)
            s = np.where((np.abs(denom) > 1e-9) & (s > 0.1), s, np.inf)
            pts = t + rays_w * np.where(np.isfinite(s), s, 0.0)[..., None]
            rel = pts - p0
            u = rel @ eu
            v = rel @ ev
            if np.isfinite(extent):  # finite patch: miss outside
                s = np.where((np.abs(u) < extent) & (np.abs(v) < extent),
                             s, np.inf)
            plane_rgb = _texture(u, v, tex["freqs"], tex["phases"],
                                 tex["weights"])
            nearer = s < best_s
            best_s = np.where(nearer, s, best_s)
            rgb = np.where(nearer[..., None], plane_rgb, rgb)
        depth = np.where(np.isfinite(best_s), best_s, 0.0)
        return rgb, depth.astype(np.float32)[..., None]

    # ------------------------------------------------------------------
    def __getitem__(self, idx: int) -> Sample:
        planes, poses = self._scene(idx)
        rgb, depth = self._render(planes, poses[0])
        ctx_rgb, ctx_pose = [], []
        for T in poses[1:]:
            c_rgb, _ = self._render(planes, T)
            ctx_rgb.append(c_rgb)
            ctx_pose.append(relative_pose(poses[0], T).astype(np.float32))
        sample: Sample = {
            "idx": idx,
            "filename": f"synthetic/{self.cfg.seed}/{idx:06d}",
            "rgb": rgb,
            "rgb_context": np.stack(ctx_rgb),
            "intrinsics": self.K.copy(),
        }
        if self.cfg.with_depth:
            sample["depth"] = depth
        if self.cfg.with_pose:
            sample["pose_context"] = np.stack(ctx_pose)

        if self.mode == "train":
            rng = sample_rng(self, "jitter", idx)
            sample = train_transform(sample, self.image_shape or (),
                                     self.jittering, rng)
        else:
            sample = eval_transform(sample, self.image_shape or ())
            sample = dict(sample)
            sample.setdefault("rgb_original", sample["rgb"].copy())
            sample.setdefault("rgb_context_original",
                              sample["rgb_context"].copy())
        return sample
