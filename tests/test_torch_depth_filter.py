"""The port's capture-quality filters against the JAX package (CPU), bit
for bit: the cases of ``tests/test_depth_filter.py`` and random sequences
(poses with jumps, NaN poses, random invalid-depth fractions) through
`filter_sequence` and `split_lines_from_segments`. Tolerance: none.
"""
import numpy as np
import pytest

from dro_sfm_tpu.data import depth_filter as J
from dro_sfm_torch.data import depth_filter as T


def test_small_cases_match():
    d = np.array([[0, 300, 400, 5000, 10000, 10001]], dtype=np.int64)
    assert np.array_equal(T.clip_depth(d), J.clip_depth(d))
    bad = np.eye(4)
    bad[1, 2] = np.nan
    assert T.is_invalid_pose(bad) and not T.is_invalid_pose(np.eye(4))
    for p in ([50, 10, 10, 2, 1, 1], [120, 0, 0, 10, 0, 0], [500, 0, 0, 30, 0, 0],
              [85, 85, 0, 0, 0, 0]):
        assert T.pose_in_threshold_1(p) == J.pose_in_threshold_1(p)
        assert T.pose_in_threshold_5(p) == J.pose_in_threshold_5(p)
    dropped = [False, True, False, True, False]
    for n in (1, 2, 3):
        assert T.find_idx_of_prev_n(dropped, 4, n) == J.find_idx_of_prev_n(dropped, 4, n)
    depth = np.random.default_rng(0).integers(0, 12000, (30, 40))
    assert T.invalid_depth_fraction(depth) == J.invalid_depth_fraction(depth)


def random_pose(rng, jump):
    a = rng.normal(0, 0.02 if not jump else 0.5, 3)
    c, s = np.cos(a), np.sin(a)
    rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    T_ = np.eye(4)
    T_[:3, :3] = rz @ ry
    T_[:3, 3] = rng.normal(0, 0.04 if not jump else 1.0, 3)
    return T_


@pytest.mark.parametrize("seed", range(8))
def test_random_sequences_match(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    poses, pose = [], np.eye(4)
    for _ in range(n):
        pose = pose @ random_pose(rng, rng.random() < 0.15)
        p = pose.copy()
        if rng.random() < 0.05:
            p[0, 1] = np.nan
        poses.append(p)
    fracs = rng.random(n) * 0.6
    for i in range(1, n):
        assert np.array_equal(T.matrix_to_6d_pose(poses[i], poses[i - 1]),
                              J.matrix_to_6d_pose(poses[i], poses[i - 1]), equal_nan=True)
    for thr in ("THRESHOLD_1", "THRESHOLD_5"):
        k1, s1 = T.filter_sequence(poses, fracs, threshold=getattr(T, thr))
        k2, s2 = J.filter_sequence(poses, fracs, threshold=getattr(J, thr))
        assert np.array_equal(k1, k2) and np.array_equal(s1, s2)
        names = [f"{i:06d}.jpg" for i in range(n)]
        for m in (1, 3):
            assert (T.split_lines_from_segments(names, k1, s1, "scene/cam_left", m)
                    == J.split_lines_from_segments(names, k2, s2, "scene/cam_left", m))
