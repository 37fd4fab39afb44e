"""Person-mask extraction for raw video frames (offline preprocessing).

The port's copy of ``anerf_tpu/data/mask_extract.py`` (reference
core/process_mask.py, which runs a TensorFlow DeepLab-v3 PASCAL model
over frames and keeps the 'person' class, and core/misc/save_mask_vid.py,
which exports the extracted masks as a video for inspection).

The segmentation backbone is pluggable: any callable
``seg_fn(imgs_uint8) -> (N, H, W) int labels`` works.  The model
backends (``torchscript_seg_fn``, ``transformers_seg_fn``) run the
model on a device: the GPU unless the caller asks for the CPU
(``device='cpu'``), the labels handed back as numpy.  Two backends need
no user model:

  * ``masks_from_background``: static-camera background subtraction
    (the same signal the reference's H36M pipeline uses to extract
    per-camera backgrounds, load_h36m.py:17-112) with morphological
    cleanup, fully offline, no model weights needed;
  * ``segment_person``: drives a user-provided PASCAL-labelled model
    and keeps class 15 ('person'), mirroring the reference's DeepLab
    postprocessing (process_mask.py).

``python -m anerf_torch.extract_masks`` is the command line over them.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

# PASCAL VOC class list used by the reference's DeepLab model
# (process_mask.py LABEL_NAMES); 'person' is class 15.
LABEL_NAMES = (
    'background', 'aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus',
    'car', 'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse', 'motorbike',
    'person', 'pottedplant', 'sheep', 'sofa', 'train', 'tv')
PERSON_LABEL = LABEL_NAMES.index('person')


def create_pascal_label_colormap() -> np.ndarray:
    """PASCAL VOC label colormap (bit-shuffled index colors), as used by
    the reference for mask visualization (process_mask.py)."""
    colormap = np.zeros((256, 3), dtype=int)
    ind = np.arange(256, dtype=int)
    for shift in reversed(range(8)):
        for channel in range(3):
            colormap[:, channel] |= ((ind >> channel) & 1) << shift
        ind >>= 3
    return colormap


def label_to_color_image(label: np.ndarray) -> np.ndarray:
    """Color-code a 2D label map with the PASCAL colormap."""
    if label.ndim != 2:
        raise ValueError('Expect 2-D input label')
    colormap = create_pascal_label_colormap()
    if np.max(label) >= len(colormap):
        raise ValueError('label value too large.')
    return colormap[label]


def segment_person(imgs: np.ndarray,
                   seg_fn: Callable[[np.ndarray], np.ndarray],
                   person_label: int = PERSON_LABEL) -> np.ndarray:
    """Run a segmentation model and keep the person class.

    Args:
      imgs: (N, H, W, 3) uint8 frames.
      seg_fn: callable mapping frames -> (N, H, W) integer PASCAL labels.
    Returns:
      (N, H, W, 1) uint8 binary masks in {0, 1}.
    """
    labels = np.asarray(seg_fn(imgs))
    return (labels == person_label).astype(np.uint8)[..., None]


def _binary_morph(mask: np.ndarray, kernel: int, op: str) -> np.ndarray:
    """Separable box erosion/dilation via numpy (no cv2 dependency in
    the core path)."""
    from numpy.lib.stride_tricks import sliding_window_view
    if kernel % 2 != 1:
        raise ValueError(f'_binary_morph requires an odd kernel, got {kernel}')
    pad = kernel // 2
    agg = np.max if op == 'dilate' else np.min
    m = np.pad(mask, ((pad, pad), (0, 0)),
               mode='constant', constant_values=(0 if op == 'dilate' else 1))
    m = agg(sliding_window_view(m, kernel, axis=0), axis=-1)
    m = np.pad(m, ((0, 0), (pad, pad)),
               mode='constant', constant_values=(0 if op == 'dilate' else 1))
    return agg(sliding_window_view(m, kernel, axis=1), axis=-1)


def masks_from_background(imgs: np.ndarray, bkgd: np.ndarray,
                          thresh: float = 25.0,
                          open_kernel: int = 3,
                          close_kernel: int = 7) -> np.ndarray:
    """Static-camera person masks by background subtraction.

    Args:
      imgs: (N, H, W, 3) uint8 frames.
      bkgd: (H, W, 3) uint8 clean-plate background (e.g. the per-camera
        median background the H36M pipeline extracts).
      thresh: per-pixel L2 color-distance threshold (uint8 scale).
    Returns:
      (N, H, W, 1) uint8 binary masks, morphologically opened (despeckle)
      then closed (fill holes).
    """
    diff = imgs.astype(np.float32) - bkgd.astype(np.float32)[None]
    dist = np.sqrt((diff ** 2).sum(-1))
    masks = (dist > thresh).astype(np.uint8)
    out = np.empty_like(masks)
    for i, m in enumerate(masks):
        m = _binary_morph(_binary_morph(m, open_kernel, 'erode'),
                          open_kernel, 'dilate')          # open
        m = _binary_morph(_binary_morph(m, close_kernel, 'dilate'),
                          close_kernel, 'erode')          # close
        out[i] = m
    return out[..., None]


# ---------------------------------------------------------------------------
# Model backends (reference DeepLabModel, process_mask.py:86-130): any
# callable (N, H, W, 3) uint8 -> (N, H, W) int labels plugs in.
# ---------------------------------------------------------------------------

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _to_batch(imgs: np.ndarray, device):
    """uint8 (N, H, W, 3) frames -> ImageNet-normalized NCHW floats on
    ``device``."""
    import torch
    x = imgs.astype(np.float32) / 255.
    x = (x - _IMAGENET_MEAN) / _IMAGENET_STD
    return torch.from_numpy(x.transpose(0, 3, 1, 2)).to(device)


def torchscript_seg_fn(model_path: str, batch_size: int = 4,
                       device=None) -> Callable:
    """Segmentation backend from a TorchScript file (e.g. a torchvision
    ``deeplabv3_resnet50`` exported with ``torch.jit.script``), the
    offline-friendly stand-in for the reference's frozen TF DeepLab
    graph (process_mask.py:86-130).

    The model is loaded onto ``device`` (None: the GPU, and no GPU
    raises; ``'cpu'`` asks for the CPU), receives ImageNet-normalized
    NCHW floats there, and may return a logits tensor (N, C, H, W) or a
    dict with key ``'out'`` (the torchvision convention); the labels
    come back as numpy.
    """
    import torch

    from ..utils.device import resolve_device
    dev = resolve_device(device)
    model = torch.jit.load(model_path, map_location=dev).eval()

    def seg_fn(imgs: np.ndarray) -> np.ndarray:
        outs = []
        with torch.no_grad():
            for s in range(0, len(imgs), batch_size):
                out = model(_to_batch(imgs[s:s + batch_size], dev))
                if isinstance(out, dict):
                    out = out['out']
                outs.append(out.argmax(1).cpu().numpy())
        return np.concatenate(outs, 0)
    return seg_fn


def transformers_seg_fn(model=None, model_dir: Optional[str] = None,
                        batch_size: int = 4, device=None) -> Callable:
    """Segmentation backend from a HuggingFace semantic-segmentation
    model (e.g. SegFormer), loaded offline from a local directory, run
    on ``device`` (None: the GPU; ``'cpu'`` asks for the CPU).

    Pass the person class id of the model's label space to
    ``segment_person`` / ``extract_masks`` (e.g. ADE20K person = 12;
    PASCAL person = 15).
    """
    import torch

    from ..utils.device import resolve_device
    dev = resolve_device(device)
    if model is None:
        from transformers import AutoModelForSemanticSegmentation
        assert model_dir is not None, 'need a model or a local model dir'
        model = AutoModelForSemanticSegmentation.from_pretrained(
            model_dir, local_files_only=True)
    model = model.to(dev).eval()

    def seg_fn(imgs: np.ndarray) -> np.ndarray:
        H, W = imgs.shape[1:3]
        outs = []
        with torch.no_grad():
            for s in range(0, len(imgs), batch_size):
                logits = model(pixel_values=_to_batch(
                    imgs[s:s + batch_size], dev)).logits
                logits = torch.nn.functional.interpolate(
                    logits, size=(H, W), mode='bilinear',
                    align_corners=False)
                outs.append(logits.argmax(1).cpu().numpy())
        return np.concatenate(outs, 0)
    return seg_fn


def _resize(img: np.ndarray, w: int, h: int, nearest: bool = False
            ) -> np.ndarray:
    import cv2
    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    return cv2.resize(img, (w, h), interpolation=interp)


def extract_masks(imgs: np.ndarray, seg_fn: Callable,
                  person_label: int = PERSON_LABEL,
                  input_size: Optional[int] = 513,
                  dilate: int = 1) -> np.ndarray:
    """Full-frame person masks via a segmentation backend.

    The reference pipeline (process_masks, process_mask.py:131-172):
    resize so the longer side is ``input_size`` (the DeepLab graph's
    fixed input), segment, resize the label map back (nearest here —
    the reference bilinearly blends label IDS, a visible artifact we do
    not reproduce), keep the person class, dilate 3x3 ``dilate`` times.

    Args:
      imgs: (N, H, W, 3) uint8 frames.
    Returns:
      (N, H, W, 1) uint8 binary masks.
    """
    import cv2
    H, W = imgs.shape[1:3]
    if input_size is not None and max(H, W) != input_size:
        r = input_size / max(H, W)
        tw, th = int(r * W), int(r * H)
        small = np.stack([_resize(im, tw, th) for im in imgs])
    else:
        small = imgs
    labels = np.asarray(seg_fn(small)).astype(np.uint8)
    masks = []
    kernel = np.ones((3, 3), np.uint8)
    for lab in labels:
        if lab.shape != (H, W):
            lab = _resize(lab, W, H, nearest=True)
        m = (lab == person_label).astype(np.uint8)
        if dilate > 0:
            m = cv2.dilate(m, kernel=kernel, iterations=dilate)
        masks.append(m)
    return np.stack(masks)[..., None]


def extract_bbox_masks(imgs: np.ndarray, bboxes: np.ndarray,
                       seg_fn: Callable,
                       person_label: int = PERSON_LABEL,
                       input_size: Optional[int] = 513,
                       mul: float = 1.1, dilate: int = 1) -> np.ndarray:
    """Bbox-cropped person masks (reference process_bbox_masks,
    process_mask.py:174-225): segment only a square crop around the
    detected person (SPIN bbox (cx, cy, box_len)), paste back, dilate.

    Args:
      imgs: (N, H, W, 3) uint8 frames.
      bboxes: (N, 3) [cx, cy, box_len] SPIN crop parameters.
    Returns:
      (N, H, W, 1) uint8 binary masks.
    """
    import cv2
    H, W = imgs.shape[1:3]
    kernel = np.ones((3, 3), np.uint8)
    masks = []
    for img, (cx, cy, box_len) in zip(imgs, np.asarray(bboxes)):
        cx, cy = int(cx), int(cy)
        half = int(box_len * 0.5 * mul)
        left, top = max(cx - half, 0), max(cy - half, 0)
        right, bot = min(cx + half, W), min(cy + half, H)
        crop = img[top:bot, left:right]
        m_crop = extract_masks(crop[None], seg_fn,
                               person_label=person_label,
                               input_size=input_size, dilate=0)[0, ..., 0]
        m = np.zeros((H, W), np.uint8)
        m[top:bot, left:right] = m_crop
        if dilate > 0:
            m = cv2.dilate(m, kernel=kernel, iterations=dilate)
        masks.append(m)
    return np.stack(masks)[..., None]


def save_mask_video(path: str, masks: np.ndarray, imgs: Optional[np.ndarray]
                    = None, fps: int = 14) -> None:
    """Export masks (optionally composited over the frames) as a video
    for inspection (reference core/misc/save_mask_vid.py)."""
    from ..utils.logging import save_video
    m = masks.astype(np.float32)
    if m.ndim == 3:
        m = m[..., None]
    if imgs is not None:
        frames = imgs.astype(np.float32) / 255. * (0.3 + 0.7 * m)
    else:
        frames = np.repeat(m, 3, axis=-1)
    save_video(path, frames, fps=fps)
