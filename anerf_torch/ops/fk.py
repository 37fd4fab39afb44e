"""Host-side forward kinematics (numpy/scipy).

Copy of ``anerf_tpu.ops.fk.get_smpl_l2ws_np`` (reference
skeleton_utils.py:334-376).  The differentiable torch FK of the training
path is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np

from ..skeleton import Skeleton, SMPLSkeleton, SMPL_REST_POSE


def get_smpl_l2ws_np(pose: np.ndarray, rest_pose: np.ndarray = None,
                     scale: float = 1.,
                     skel: Skeleton = SMPLSkeleton) -> np.ndarray:
    """Numpy FK used by offline data prep / pose generators.

    Matches reference ``get_smpl_l2ws`` (skeleton_utils.py:334-376):
    axis-angle pose (J, 3), scaled rest pose, no pelvis shift.
    """
    from scipy.spatial.transform import Rotation
    if rest_pose is None:
        rest_pose = SMPL_REST_POSE
    rest_kp = rest_pose * scale
    rots = Rotation.from_rotvec(pose.reshape(-1, 3)).as_matrix().astype(
        np.float32).reshape(-1, 3, 3)

    joint_trees = np.asarray(skel.joint_trees)
    l2ws = [None] * skel.n_joints

    def hom(rot, t):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot
        m[:3, 3] = t
        return m

    root = skel.root_id
    l2ws[root] = hom(rots[root], rest_kp[root])
    for level in skel.kinematic_levels()[1:]:
        for j in level:
            p = joint_trees[j]
            l2ws[j] = l2ws[p] @ hom(rots[j], rest_kp[j] - rest_kp[p])
    return np.stack(l2ws, axis=0)
