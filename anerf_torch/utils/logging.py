"""Metric logging: ``metrics.jsonl`` always, tensorboard events when
tensorboardX is installed; frames and videos on disk; skeleton overlays.

Port of ``anerf_tpu/utils/logging.py`` (which replaces the reference's
SummaryWriter use, run_nerf.py:529,590-615): scalars every ``i_print``,
validation videos and PSNR/SSIM at ``i_testset``, and a jsonl mirror
for headless runs; plus stdlib readers of tensorboard event files.
tensorboardX is imported inside ``MetricLogger`` only, so the logger
runs without it (jsonl alone).  The card's machine has neither imageio
nor cv2: ``save_images`` writes PNGs with ``utils.image.write_png``,
``save_video`` needs imageio only for the mp4 and writes per-frame PNGs
without it, and ``draw_skeleton_2d`` draws with numpy.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricLogger:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self.tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self.tb = SummaryWriter(logdir)
            except ImportError:
                pass
        self.jsonl = open(os.path.join(logdir, 'metrics.jsonl'), 'a')
        self.t0 = time.time()

    def log_scalars(self, step: int, scalars: Dict[str, float],
                    prefix: str = ''):
        rec = {'step': int(step), 'time': time.time() - self.t0}
        for k, v in scalars.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            rec[k] = v
            if self.tb is not None:
                self.tb.add_scalar(f'{prefix}{k}', v, step)
        self.jsonl.write(json.dumps(rec) + '\n')
        self.jsonl.flush()

    def log_images(self, step: int, tag: str, images: np.ndarray):
        """images: (N, H, W, 3) float [0,1]."""
        if self.tb is not None:
            for i, img in enumerate(images):
                self.tb.add_image(f'{tag}/{i}', img, step,
                                  dataformats='HWC')

    def log_video(self, step: int, tag: str, frames: np.ndarray,
                  fps: int = 14):
        if self.tb is not None:
            v = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
            v = v.transpose(0, 3, 1, 2)[None]  # (1, T, C, H, W)
            try:
                self.tb.add_video(tag, v, step, fps=fps)
            except Exception:
                pass

    def close(self):
        if self.tb is not None:
            self.tb.close()
        self.jsonl.close()


def _read_varint(buf: bytes, pos: int):
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7f) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _proto_fields(buf: bytes):
    """Minimal protobuf wire-format walk: yields (field_no, wire, value)."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            return
        yield field, wire, val


def read_tb_scalars(path_or_dir: str) -> Dict[str, list]:
    """Re-read scalar series from tensorboard event files.

    Self-contained equivalent of the reference's EventAccumulator-based
    readers (evaluation_helpers.py:28-67): parses the TFRecord framing
    and the Event/Summary protos directly, so no TF install is needed.

    Returns {tag: [(step, value), ...]} sorted by step.
    """
    import glob as _glob
    import struct
    paths = ([path_or_dir] if os.path.isfile(path_or_dir) else
             sorted(_glob.glob(os.path.join(path_or_dir, 'events.*'))))
    out: Dict[str, list] = {}
    for p in paths:
        with open(p, 'rb') as f:
            data = f.read()
        pos = 0
        while pos + 12 <= len(data):
            (length,) = struct.unpack('<Q', data[pos:pos + 8])
            payload = data[pos + 12:pos + 12 + length]
            pos += 12 + length + 4
            step = 0
            for field, wire, val in _proto_fields(payload):
                if field == 2 and wire == 0:       # Event.step
                    step = val
                elif field == 5 and wire == 2:     # Event.summary
                    for f2, w2, v2 in _proto_fields(val):
                        if f2 != 1 or w2 != 2:     # Summary.value
                            continue
                        tag, sv = None, None
                        for f3, w3, v3 in _proto_fields(v2):
                            if f3 == 1 and w3 == 2:
                                tag = v3.decode('utf-8', 'replace')
                            elif f3 == 2 and w3 == 5:
                                (sv,) = struct.unpack('<f', v3)
                        if tag is not None and sv is not None:
                            out.setdefault(tag, []).append((step, sv))
    for tag in out:
        out[tag].sort()
    return out


def read_tb_tags(path_or_dir: str) -> set:
    """All summary tags present in the event files (scalar OR video/
    image payloads — read_tb_scalars only surfaces simple_value tags)."""
    import glob as _glob
    import struct
    paths = ([path_or_dir] if os.path.isfile(path_or_dir) else
             sorted(_glob.glob(os.path.join(path_or_dir, 'events.*'))))
    tags = set()
    for p in paths:
        with open(p, 'rb') as f:
            data = f.read()
        pos = 0
        while pos + 12 <= len(data):
            (length,) = struct.unpack('<Q', data[pos:pos + 8])
            payload = data[pos + 12:pos + 12 + length]
            pos += 12 + length + 4
            for field, wire, val in _proto_fields(payload):
                if field == 5 and wire == 2:       # Event.summary
                    for f2, w2, v2 in _proto_fields(val):
                        if f2 != 1 or w2 != 2:     # Summary.value
                            continue
                        for f3, w3, v3 in _proto_fields(v2):
                            if f3 == 1 and w3 == 2:
                                tags.add(v3.decode('utf-8', 'replace'))
    return tags


def read_tag_scalars(tags, path_or_dirs) -> Dict[str, list]:
    """Reference-shaped accessor (evaluation_helpers.py:33-54): returns
    {tag: [values...], tag_steps: [steps...], num_events: N} across one
    or more logdirs."""
    if not isinstance(path_or_dirs, (list, tuple)):
        path_or_dirs = [path_or_dirs]
    if not isinstance(tags, (list, tuple)):
        tags = [tags]
    ret = {t: [] for t in tags}
    ret.update({t + '_steps': [] for t in tags})
    ret['num_events'] = len(path_or_dirs)
    for p in path_or_dirs:
        series = read_tb_scalars(p)
        for t in tags:
            sv = series.get(t, [])
            ret[t].append([v for _, v in sv])
            ret[t + '_steps'].append([s for s, _ in sv])
    return ret


def _frames8(frames: np.ndarray) -> np.ndarray:
    return (np.clip(frames, 0, 1) * 255).astype(np.uint8)


def save_video(path: str, frames: np.ndarray, fps: int = 14):
    """mp4/gif export through imageio (reference run_render.py:1030-1045)
    where imageio imports and can write it; else per-frame
    ``<base>_%04d.png`` files, the fallback anerf_tpu takes when its
    mp4 write fails."""
    from .image import write_png
    frames8 = _frames8(frames)
    try:
        import imageio
    except ImportError:
        why = 'imageio is not installed'
    else:
        try:
            imageio.mimwrite(path, frames8, fps=fps)
            return
        except Exception as e:      # a missing ffmpeg plugin, a codec
            why = f'imageio could not write it ({type(e).__name__})'
    base = os.path.splitext(path)[0]
    for i, f in enumerate(frames8):
        write_png(f'{base}_{i:04d}.png', f)
    print(f'save_video: {path}: {why}; wrote {len(frames8)} frames as '
          f'{base}_%04d.png')


def save_images(outdir: str, frames: np.ndarray, prefix: str = ''):
    """Each frame as an 8-bit RGB ``{prefix}%04d.png``."""
    from .image import write_png
    os.makedirs(outdir, exist_ok=True)
    for i, f in enumerate(_frames8(frames)):
        write_png(os.path.join(outdir, f'{prefix}{i:04d}.png'), f)


def _clip_line(W: int, H: int, x1: int, y1: int, x2: int, y2: int):
    """The segment's part inside the image, in integers, or None (the
    Cohen-Sutherland clip of OpenCV's ``clipLine``: against the top or
    bottom edge first, then the left or right one, truncating)."""
    right, bottom = W - 1, H - 1
    code = lambda x, y: ((x < 0) + (x > right) * 2 + (y < 0) * 4
                         + (y > bottom) * 8)
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return None if (c1 | c2) else (x1, y1, x2, y2)


def _draw_line(out: np.ndarray, x0: int, y0: int, x1: int, y1: int,
               color) -> None:
    """A 1-pixel 8-connected line as OpenCV's ``line`` draws it: clipped
    to the image, drawn left to right, one pixel per step along the
    major axis; the minor coordinate steps when Bresenham's error
    (starting at dx - 2 dy) is negative, i.e. after k steps it has moved
    ceil((2 dy k - dx) / (2 dx)) times."""
    H, W = out.shape[:2]
    seg = _clip_line(W, H, x0, y0, x1, y1)
    if seg is None:
        return
    x0, y0, x1, y1 = seg
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = -1 if y1 < y0 else 1
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1)
    m = np.maximum(-((major - 2 * minor * k) // max(2 * major, 1)), 0)
    if dy > dx:
        ys, xs = y0 + sy * k, x0 + m
    else:
        xs, ys = x0 + k, y0 + sy * m
    out[ys, xs] = color


def _draw_dot(out: np.ndarray, x: int, y: int, r: int, color) -> None:
    """A filled disc: every pixel within ``r`` of (x, y)."""
    H, W = out.shape[:2]
    oy, ox = np.mgrid[-r:r + 1, -r:r + 1]
    keep = oy ** 2 + ox ** 2 <= r * r
    ys, xs = (oy + y)[keep], (ox + x)[keep]
    ok = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    out[ys[ok], xs[ok]] = color


def draw_skeleton_2d(img: np.ndarray, kp3d: np.ndarray, c2w: np.ndarray,
                     focal, center=None, skel=None) -> np.ndarray:
    """Project 3D joints and draw the kinematic tree on the image: green
    1-pixel bones, then red radius-2 joint dots (anerf_tpu's cv2
    drawing, the 2D stand-in for the reference's pyrender overlay,
    core/misc/renderer.py), in numpy."""
    from ..ops.cylinder import nerf_c2w_to_extrinsic, world_to_cam_np
    from ..skeleton import SMPLSkeleton

    skel = skel or SMPLSkeleton
    H, W = img.shape[:2]
    ext = nerf_c2w_to_extrinsic(np.asarray(c2w))
    pix = world_to_cam_np(np.asarray(kp3d), ext, H, W, focal, center)
    out = _frames8(img).copy()
    for j, p in enumerate(skel.joint_trees):
        x0, y0 = pix[j]
        x1, y1 = pix[p]
        if np.isfinite([x0, y0, x1, y1]).all():
            _draw_line(out, int(x0), int(y0), int(x1), int(y1),
                       (0, 255, 0))
    for x, y in pix:
        if np.isfinite([x, y]).all():
            _draw_dot(out, int(x), int(y), 2, (255, 0, 0))
    return out.astype(np.float32) / 255.
