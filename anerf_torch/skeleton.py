"""Skeleton definitions and constants for articulated human NeRF.

Numpy copy of ``anerf_tpu/skeleton.py`` (the reference skeleton layer,
core/utils/skeleton_utils.py:19-180), kept here so the PyTorch port
imports nothing of the JAX package.  Unlike the reference,
which hardcodes an 8-level unrolled SMPL kinematic chain
(core/pose_opt.py:482-521), we derive the level structure generically
from ``joint_trees`` at construction time so FK runs as a static,
compiler-unrollable sequence of batched (4,4) matmuls for *any* skeleton.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """Static skeleton description (pytree-free, used at trace time only).

    Mirrors the reference ``Skeleton`` namedtuple
    (core/utils/skeleton_utils.py:19) plus precomputed kinematic levels.
    """

    joint_names: Tuple[str, ...]
    joint_trees: Tuple[int, ...]      # parent index per joint
    root_id: int
    cutoffs: Dict[str, float]
    end_effectors: Optional[Tuple[int, ...]] = None

    @property
    def n_joints(self) -> int:
        return len(self.joint_names)

    @property
    def nonroot_id(self) -> List[int]:
        return [i for i in range(self.n_joints) if i != self.root_id]

    def joint_depths(self) -> np.ndarray:
        """Depth of every joint in the kinematic tree (root = 0)."""
        depths = np.full(self.n_joints, -1, dtype=np.int64)
        depths[self.root_id] = 0
        changed = True
        while changed:
            changed = False
            for j, p in enumerate(self.joint_trees):
                if j == self.root_id:
                    continue
                if depths[j] < 0 and depths[p] >= 0:
                    depths[j] = depths[p] + 1
                    changed = True
        if (depths < 0).any():
            raise ValueError("joint tree is not connected")
        return depths

    def kinematic_levels(self) -> List[np.ndarray]:
        """Joints grouped by tree depth: ``levels[0] == [root]``.

        All joints within one level have parents in strictly earlier
        levels, so FK can process one level per batched matmul
        (the generic equivalent of the reference's hand-unrolled chain,
        core/pose_opt.py:482-521).
        """
        depths = self.joint_depths()
        return [np.where(depths == d)[0] for d in range(depths.max() + 1)]

    def cutoff_dists(self, ext_scale: float = 1.0,
                     default_mm: float = 500.0) -> np.ndarray:
        """Per-joint cutoff distance in world units.

        The reference keeps a global ``cutoff_mm * ext_scale`` scalar
        expanded per joint (core/raycasters.py:33,
        core/cutoff_embedder.py:91); per-joint entries in
        ``Skeleton.cutoffs`` exist but are unused by the shipped configs.
        We reproduce the global behaviour by default.
        """
        return np.full(self.n_joints, default_mm * ext_scale, dtype=np.float32)


SMPLSkeleton = Skeleton(
    joint_names=(
        'pelvis', 'left_hip', 'right_hip', 'spine1',
        'left_knee', 'right_knee', 'spine2', 'left_ankle',
        'right_ankle', 'spine3', 'left_foot', 'right_foot',
        'neck', 'left_collar', 'right_collar', 'head',
        'left_shoulder', 'right_shoulder', 'left_elbow', 'right_elbow',
        'left_wrist', 'right_wrist', 'left_hand', 'right_hand',
    ),
    joint_trees=(0, 0, 0, 0,
                 1, 2, 3, 4,
                 5, 6, 7, 8,
                 9, 9, 9, 12,
                 13, 14, 16, 17,
                 18, 19, 20, 21),
    root_id=0,
    cutoffs={'hip': 200, 'spine': 300, 'knee': 70, 'ankle': 70, 'foot': 40,
             'collar': 100, 'neck': 100, 'head': 120, 'shoulder': 70,
             'elbow': 70, 'wrist': 60, 'hand': 60},
    end_effectors=(10, 11, 15, 22, 23),
)

# Canonical 17-joint skeleton (reference core/utils/skeleton_utils.py:61-81).
CanonicalSkeleton = Skeleton(
    joint_names=(
        'head_top', 'neck', 'right_shoulder', 'right_elbow', 'right_wrist',
        'left_shoulder', 'left_elbow', 'left_wrist', 'right_hip', 'right_knee',
        'right_ankle', 'left_hip', 'left_knee', 'left_ankle', 'pelvis',
        'spine', 'head',
    ),
    joint_trees=(1, 15, 1, 2, 3,
                 1, 5, 6, 14, 8,
                 9, 14, 11, 12, 14,
                 14, 1),
    root_id=14,
    cutoffs={},
)

# Mpi3dhp 28-joint skeleton (reference core/utils/skeleton_utils.py:148-178).
Mpi3dhpSkeleton = Skeleton(
    joint_names=(
        'spine3', 'spine4', 'spine2', 'spine',
        'pelvis', 'neck', 'head', 'head_top',
        'left_clavicle', 'left_shoulder', 'left_elbow', 'left_wrist',
        'left_hand', 'right_clavicle', 'right_shoulder', 'right_elbow',
        'right_wrist', 'right_hand', 'left_hip', 'left_knee',
        'left_ankle', 'left_foot', 'left_toe', 'right_hip',
        'right_knee', 'right_ankle', 'right_foot', 'right_toe',
    ),
    joint_trees=(2, 0, 3, 4,
                 4, 1, 5, 6,
                 5, 8, 9, 10,
                 11, 5, 13, 14,
                 15, 16, 4, 18,
                 19, 20, 21, 4,
                 23, 24, 25, 26),
    root_id=4,
    cutoffs={},
)


def get_skeleton_type(n_joints: int) -> Skeleton:
    """Pick skeleton by joint count (reference skeleton_utils.py:180-188)."""
    if n_joints == 17:
        return CanonicalSkeleton
    if n_joints == 28:
        return Mpi3dhpSkeleton
    return SMPLSkeleton


# SMPL canonical rest pose, xyz (reference skeleton_utils.py:259-282).
SMPL_REST_POSE = np.array(
    [[0.00000000e+00, 2.30003661e-09, -9.86228770e-08],
     [1.63832515e-01, -2.17391014e-01, -2.89178602e-02],
     [-1.57855421e-01, -2.14761734e-01, -2.09642015e-02],
     [-7.04505108e-03, 2.50450850e-01, -4.11837511e-02],
     [2.42021069e-01, -1.08830070e+00, -3.14962119e-02],
     [-2.47206554e-01, -1.10715497e+00, -3.06970738e-02],
     [3.95125849e-03, 5.94849110e-01, -4.03754264e-02],
     [2.12680623e-01, -1.99382353e+00, -1.29327580e-01],
     [-2.10857525e-01, -2.01218796e+00, -1.23002514e-01],
     [9.39484313e-03, 7.19204426e-01, 2.06931755e-02],
     [2.63385147e-01, -2.12222481e+00, 1.46775618e-01],
     [-2.51970559e-01, -2.12153077e+00, 1.60450473e-01],
     [3.83779174e-03, 1.22592449e+00, -9.78838727e-02],
     [1.91201791e-01, 1.00385976e+00, -6.21964522e-02],
     [-1.77145526e-01, 9.96228695e-01, -7.55542740e-02],
     [1.68482102e-02, 1.38698268e+00, 2.44048554e-02],
     [4.01985168e-01, 1.07928419e+00, -7.47655183e-02],
     [-3.98825467e-01, 1.07523870e+00, -9.96334553e-02],
     [1.00236952e+00, 1.05217218e+00, -1.35129794e-01],
     [-9.86728609e-01, 1.04515052e+00, -1.40235111e-01],
     [1.56646240e+00, 1.06961894e+00, -1.37338534e-01],
     [-1.56946480e+00, 1.05935931e+00, -1.53905824e-01],
     [1.75282109e+00, 1.04682994e+00, -1.68231070e-01],
     [-1.75758195e+00, 1.04255080e+00, -1.77773550e-01]],
    dtype=np.float32)


def rotate_x(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def rotate_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def rotate_z(psi: float) -> np.ndarray:
    c, s = np.cos(psi), np.sin(psi)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def translate(tx: float, ty: float, tz: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (tx, ty, tz)
    return m


def arccos_safe(a: np.ndarray) -> np.ndarray:
    return np.arccos(np.clip(a, -1. + 1e-8, 1. - 1e-8))


def create_local_coord(vec: np.ndarray) -> np.ndarray:
    """Coordinate frame with z-axis aligned to ``vec``.

    Offline helper (numpy) matching reference skeleton_utils.py:493-523.
    """
    axes = np.eye(3, dtype=np.float32)
    if np.isclose(np.linalg.norm(vec), 0.):
        return axes
    vec_xz = vec[[0, 2]] / np.linalg.norm(vec[[0, 2]])
    theta = arccos_safe(vec_xz[-1]) * np.sign(vec_xz[0])
    rot_y = rotate_y(theta)
    rotated_y = rot_y[:3, :3] @ vec
    vec_yz = rotated_y[1:3] / np.linalg.norm(rotated_y[1:3])
    psi = arccos_safe(vec_yz[-1]) * np.sign(vec_yz[0])
    rot_x = rotate_x(psi)
    rot = np.linalg.inv(rot_x @ rot_y)
    return axes @ rot[:3, :3].T


def get_per_joint_coords(rest_pose: np.ndarray,
                         skel: Skeleton = SMPLSkeleton) -> np.ndarray:
    """Per-joint local coordinate systems, parent-centered.

    Offline helper (numpy) matching reference skeleton_utils.py:525-539.
    """
    coords = []
    for i, j in enumerate(skel.joint_trees):
        vec = rest_pose[j] - rest_pose[i]
        vec = vec / (np.linalg.norm(vec) + 1e-5)
        coords.append(create_local_coord(vec))
    return np.array(coords)
