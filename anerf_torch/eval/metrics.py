"""Evaluation metrics: image quality (PSNR/SSIM) and pose accuracy
(PA-MPJPE / MPJPE / PCK / AUC).

Copy of ``anerf_tpu/eval/metrics.py``'s numpy metrics (reference
run_render.py:883-967 ``evaluate_metric``: box-cropped and fg-masked
PSNR/SSIM, a Gaussian-window SSIM; core/utils/evaluation_helpers.py:
387-612: Procrustes-aligned pose metrics), and its pose metrics of
refined SMPL parameters (``pose_metrics_from_smpl_params``): joints
regressed from given vertices, from the optional smplx body model, or
FK of the pose parameters through ``ops/fk.fk`` on a device.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def psnr(img: np.ndarray, target: np.ndarray,
         mask: Optional[np.ndarray] = None) -> float:
    d = (img.astype(np.float64) - target.astype(np.float64)) ** 2
    if mask is not None:
        m = np.broadcast_to(mask.astype(bool), d.shape)
        if m.sum() == 0:
            return float('nan')
        mse = d[m].mean()
    else:
        mse = d.mean()
    return float(-10. * np.log10(max(mse, 1e-12)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(img: np.ndarray, target: np.ndarray, data_range: float = 1.0,
         win_size: int = 11, sigma: float = 1.5) -> float:
    """Gaussian-window SSIM averaged over channels (the standard Wang et
    al. formulation used by pytorch-msssim in the reference)."""
    from scipy.signal import convolve2d
    img = img.astype(np.float64)
    target = target.astype(np.float64)
    if img.ndim == 2:
        img, target = img[..., None], target[..., None]
    w = _gaussian_window(win_size, sigma)
    kernel = np.outer(w, w)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2

    vals = []
    for c in range(img.shape[-1]):
        x, y = img[..., c], target[..., c]
        mu_x = convolve2d(x, kernel, mode='valid')
        mu_y = convolve2d(y, kernel, mode='valid')
        xx = convolve2d(x * x, kernel, mode='valid') - mu_x ** 2
        yy = convolve2d(y * y, kernel, mode='valid') - mu_y ** 2
        xy = convolve2d(x * y, kernel, mode='valid') - mu_x * mu_y
        s = ((2 * mu_x * mu_y + C1) * (2 * xy + C2)) / \
            ((mu_x ** 2 + mu_y ** 2 + C1) * (xx + yy + C2))
        vals.append(s.mean())
    return float(np.mean(vals))


def evaluate_images(preds: np.ndarray, gts: np.ndarray,
                    fgs: Optional[np.ndarray] = None,
                    bboxes: Optional[Sequence] = None
                    ) -> Dict[str, np.ndarray]:
    """Box-cropped PSNR/SSIM + fg-masked PSNR per image
    (reference run_render.py:883-967).

    Renders produced at a reduced resolution (``render_factor``) are
    bilinearly upsampled to the GT resolution before scoring, like the
    reference (evaluation_helpers.py:309-313); bounding boxes (given in
    render coordinates) are scaled accordingly.
    """
    psnrs, ssims, fg_psnrs = [], [], []
    for i in range(len(preds)):
        p, g = preds[i], gts[i]
        if p.shape[:2] != g.shape[:2]:
            from ..utils.image import bilinear_resize
            sy = g.shape[0] / p.shape[0]
            sx = g.shape[1] / p.shape[1]
            p = bilinear_resize(np.asarray(p, np.float32),
                                g.shape[0], g.shape[1])
            if bboxes is not None:
                tl, br = bboxes[i]
                bboxes = list(bboxes)
                bboxes[i] = (np.array([tl[0] * sx, tl[1] * sy], np.int64),
                             np.array([br[0] * sx, br[1] * sy], np.int64))
        if bboxes is not None:
            tl, br = bboxes[i]
            p = p[tl[1]:br[1], tl[0]:br[0]]
            g = g[tl[1]:br[1], tl[0]:br[0]]
        psnrs.append(psnr(p, g))
        ssims.append(ssim(p, g))
        if fgs is not None:
            fg = fgs[i]
            if bboxes is not None:
                tl, br = bboxes[i]
                fg = fg[tl[1]:br[1], tl[0]:br[0]]
            fg_psnrs.append(psnr(p, g, mask=fg > 0))
    out = {'psnr': np.array(psnrs), 'ssim': np.array(ssims)}
    if fg_psnrs:
        out['fg_psnr'] = np.array(fg_psnrs)
    return out


def procrustes(S1: np.ndarray, S2: np.ndarray) -> np.ndarray:
    """Similarity-align S1 (J, 3) to S2 (J, 3): returns aligned S1
    (reference evaluation_helpers.py procrustes)."""
    mu1 = S1.mean(0, keepdims=True)
    mu2 = S2.mean(0, keepdims=True)
    X1 = S1 - mu1
    X2 = S2 - mu2
    var1 = (X1 ** 2).sum()
    K = X1.T @ X2
    U, s, Vh = np.linalg.svd(K)
    V = Vh.T
    Z = np.eye(3)
    Z[-1, -1] = np.sign(np.linalg.det(U @ V.T))
    R = V @ Z @ U.T
    scale = np.trace(R @ K) / max(var1, 1e-12)
    return scale * (X1 @ R.T) + mu2


def pose_metrics(pred_kps: np.ndarray, gt_kps: np.ndarray,
                 scale_to_mm: float = 1000.,
                 pck_threshold: float = 150.,
                 auc_range: Tuple[float, float, int] = (0., 150., 31)
                 ) -> Dict[str, float]:
    """PA-MPJPE / MPJPE (mm) / PCK@threshold / AUC over N poses
    (reference evaluation_helpers.py:541-612)."""
    mpjpes, pa_mpjpes = [], []
    all_err = []
    for p, g in zip(pred_kps, gt_kps):
        err = np.linalg.norm(p - g, axis=-1) * scale_to_mm
        mpjpes.append(err.mean())
        pa = procrustes(p, g)
        pa_err = np.linalg.norm(pa - g, axis=-1) * scale_to_mm
        pa_mpjpes.append(pa_err.mean())
        all_err.append(pa_err)
    all_err = np.concatenate(all_err)
    pck = float((all_err < pck_threshold).mean())
    ths = np.linspace(*auc_range)
    auc = float(np.mean([(all_err < t).mean() for t in ths]))
    return {'mpjpe': float(np.mean(mpjpes)),
            'pa_mpjpe': float(np.mean(pa_mpjpes)),
            f'pck@{pck_threshold:.0f}': pck,
            'auc': auc}


# SPIN H36M-regressor output -> canonical joint order
# (reference evaluation_helpers.py:539 SPIN_TO_CANON: the values are
# the protocol's)
SPIN_TO_CANON = [10, 8, 14, 15, 16, 11, 12, 13, 4, 5, 6, 1, 2, 3, 0, 7, 9]
CANON_PELVIS = 14   # centering joint for MPJPE (evaluation_helpers.py:585)


def vertices2joints(j_regressor: np.ndarray,
                    vertices: np.ndarray) -> np.ndarray:
    """Regress joints from mesh vertices: (J, V) x (N, V, 3) -> (N, J, 3)
    (smplx.lbs.vertices2joints, used by the reference's SMPLEvalHelper,
    evaluation_helpers.py:525-537)."""
    return np.einsum('jv,nvc->njc', np.asarray(j_regressor, np.float64),
                     np.asarray(vertices, np.float64))


def h36m_joints_from_vertices(vertices: np.ndarray,
                              j_regressor: np.ndarray) -> np.ndarray:
    """H36M joints regressed from SMPL vertices, reordered to the
    canonical evaluation order (evaluation_helpers.py:556-560)."""
    return vertices2joints(j_regressor, vertices)[:, SPIN_TO_CANON]


def pose_metrics_from_smpl_params(gt_kps: np.ndarray,
                                  bones: Optional[np.ndarray] = None,
                                  pelvis: Optional[np.ndarray] = None,
                                  betas: Optional[np.ndarray] = None,
                                  rest_pose: Optional[np.ndarray] = None,
                                  vertices: Optional[np.ndarray] = None,
                                  j_regressor: Optional[np.ndarray] = None,
                                  smpl_model_path: Optional[str] = None,
                                  scale_to_mm: float = 1000.,
                                  pck_threshold: float = 150.,
                                  device=None) -> Dict[str, float]:
    """Pose accuracy of refined SMPL parameters against ground-truth
    joints (reference ``evaluate_pampjpe_from_smpl_params``,
    evaluation_helpers.py:541-612, which regresses H36M joints from SMPL
    vertices with ``J_regressor_h36m``).  Three prediction sources, by
    decreasing protocol fidelity:

      1. ``vertices`` + ``j_regressor``: joints regressed from given SMPL
         vertices, the reference's joint definition (``vertices2joints``
         + SPIN_TO_CANON, :556-560), without the body-model files.
      2. ``smpl_model_path`` + ``j_regressor`` (+ betas/bones): the
         smplx body model gives the vertices first (the optional smplx
         package and the user's SMPL .pkl).
      3. FK (the default): ``ops/fk.fk`` of the pose parameters on the
         given or betas-derived rest pose, on ``device`` (None: the GPU,
         as ``utils.device.resolve_device`` has it; ``'cpu'`` asks for
         the CPU).  It evaluates the same refined parameters with the
         skeleton's joint definition; its numbers are not comparable
         with the paper's vertex-regressed protocol.

    MPJPE is pelvis-centered as in the reference (:585-588: canonical
    joint 14 for regressed joints, root joint 0 for FK joints);
    PA-MPJPE/PCK/AUC are per-frame Procrustes-aligned.

    Args:
      gt_kps: (N, J, 3) ground-truth joints (the predictions' units;
        canonical 17-joint order for sources 1-2, skeleton order for 3).
      bones: (N, J, 3) axis-angle pose parameters (sources 2-3).
      pelvis: (N, 3) root translations; zeros if None.
      betas / rest_pose: one of them for source 3.
    """
    center_joint = 0
    if vertices is None and smpl_model_path is not None:
        assert j_regressor is not None and bones is not None
        vertices = _smpl_vertices(smpl_model_path, betas, bones)
    if vertices is not None:
        assert j_regressor is not None, \
            'vertex-regressed eval needs J_regressor_h36m'
        pred = h36m_joints_from_vertices(vertices, j_regressor)
        pred = pred.astype(np.float32)
        center_joint = CANON_PELVIS
    else:
        import torch
        from ..ops.fk import fk
        from ..utils.device import resolve_device
        dev = resolve_device(device)
        if rest_pose is None:
            from ..data.spin import rest_pose_from_betas
            assert betas is not None, 'need betas or rest_pose'
            rest_pose = rest_pose_from_betas(np.atleast_2d(betas))
        bones = np.asarray(bones, np.float32)
        if pelvis is None:
            pelvis = np.zeros((len(bones), 3), np.float32)
        on = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        with torch.no_grad():
            kps, _, _, _ = fk(on(bones), on(pelvis), on(rest_pose))
        pred = kps.cpu().numpy()
    gt = np.asarray(gt_kps, np.float32)

    # pelvis-center both sides for the translation-free MPJPE
    pred_c = pred - pred[:, center_joint:center_joint + 1]
    gt_c = gt - gt[:, center_joint:center_joint + 1]
    mpjpes, pa_mpjpes, all_err = [], [], []
    for p, g, pc, gc in zip(pred, gt, pred_c, gt_c):
        mpjpes.append(np.linalg.norm(pc - gc, axis=-1).mean() * scale_to_mm)
        pa = procrustes(p, g)
        pa_err = np.linalg.norm(pa - g, axis=-1) * scale_to_mm
        pa_mpjpes.append(pa_err.mean())
        all_err.append(pa_err)
    all_err = np.concatenate(all_err)
    ths = np.linspace(0., 150., 31)
    return {'mpjpe': float(np.mean(mpjpes)),
            'pa_mpjpe': float(np.mean(pa_mpjpes)),
            f'pck@{pck_threshold:.0f}': float(
                (all_err < pck_threshold).mean()),
            'auc': float(np.mean([(all_err < t).mean() for t in ths]))}


def _smpl_vertices(model_path: str, betas, bones) -> np.ndarray:
    """Vertices from the smplx body model, where it is installed
    (reference SMPLEvalHelper forward, evaluation_helpers.py:525-560)."""
    import smplx  # optional dependency, supplied by the user
    import torch
    from ..ops.rotations import axisang_to_rot
    rots = axisang_to_rot(torch.as_tensor(np.asarray(bones, np.float32)))
    model = smplx.SMPL(model_path)
    betas_t = torch.as_tensor(np.atleast_2d(betas), dtype=torch.float32)
    if betas_t.shape[0] == 1:
        betas_t = betas_t.expand(len(bones), -1)
    out = model(betas=betas_t, body_pose=rots[:, 1:],
                global_orient=rots[:, :1], pose2rot=False)
    return out.vertices.detach().cpu().numpy()
