"""Metric logging: ``metrics.jsonl`` always, tensorboard events when
tensorboardX is installed.

Port of ``anerf_tpu/utils/logging.py`` (which replaces the reference's
SummaryWriter use, run_nerf.py:529,590-615): scalars every ``i_print``,
validation videos and PSNR/SSIM at ``i_testset``, and a jsonl mirror
for headless runs; plus stdlib readers of tensorboard event files.
tensorboardX is imported inside ``MetricLogger`` only, so the logger
runs without it (jsonl alone).  Not ported yet (ROADMAP.md A.5): the
skeleton overlay (cv2) and ``save_video``/``save_images`` (imageio).
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
