"""Shared pieces of the radiance-MLP kernels: statics, operand order and
the plain forward of one point tile.

Port of the MLP half of ``anerf_tpu/ops/pallas_mlp.py``.  The numeric
chain every fused kernel follows (``pallas_mlp.py:23-24``): bf16
operands, f32 accumulation, f32 bias and ReLU, a bf16 re-cast between
trunk layers; ``feat`` is rounded to bf16 after its bias with no ReLU;
alpha and rgb stay f32.

The split-operand MLP kernel itself (``pallas_mlp._fused_mlp``, taken
for configs outside ``fused_encmlp.supported_config``) is not ported
yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MLPStatic:
    """Static description of the MLP."""
    depth: int
    width: int
    dparts: Tuple[int, ...]   # x_pts part widths (kp-enc, bone-enc, ...)
    vparts: Tuple[int, ...]   # x_views part widths (view-enc, framecode)
    half: int                 # views-branch width (W // 2)
    skips: Tuple[int, ...]
    tile: int = 512

    @property
    def dnet(self) -> int:
        return sum(self.dparts)

    @property
    def xv(self) -> int:
        return sum(self.vparts)

    def has_x_part(self, i: int) -> bool:
        """Layer i consumes [x, h] when layer i-1 is a skip layer."""
        return i > 0 and (i - 1) in self.skips


def _split_rows(w, widths: Sequence[int]):
    out, off = [], 0
    for d in widths:
        out.append(w[off:off + d])
        off += d
    return out


def flatten_params(net_params: Dict[str, Any], st: MLPStatic
                   ) -> List[torch.Tensor]:
    """Order the param dict into the kernels' fixed operand list.

    Weights are cast to bf16, biases stay f32 as (1, dim) rows.  Every
    weight that contracts against the (virtual) concatenated input is
    split row-wise per part; the layer after a skip splits into the
    h-part first, then the x-parts (the input goes FIRST in the
    reference's concat, nerf.py:101).
    """
    flat: List[torch.Tensor] = []
    b16 = lambda a: a.to(torch.bfloat16)
    row = lambda b: b.float().reshape(1, -1)
    for i, p in enumerate(net_params['pts_linears']):
        w = p['w']
        if i == 0:
            flat += [b16(x) for x in _split_rows(w, st.dparts)]
        elif st.has_x_part(i):
            flat.append(b16(w[st.dnet:]))   # h-part
            flat += [b16(x) for x in _split_rows(w[:st.dnet], st.dparts)]
        else:
            flat.append(b16(w))
        flat.append(row(p['b']))
    flat.append(b16(net_params['alpha_linear']['w']))
    flat.append(row(net_params['alpha_linear']['b']))
    flat.append(b16(net_params['feature_linear']['w']))
    flat.append(row(net_params['feature_linear']['b']))
    wv = net_params['views_linear']['w']
    if st.width + sum(st.vparts) != wv.shape[0]:
        raise ValueError(
            f'views_linear rows {wv.shape[0]} != width {st.width} + '
            f'vparts {st.vparts}; a view-input part is missing')
    flat.append(b16(wv[:st.width]))         # feature-part (feature first)
    flat += [b16(x) for x in _split_rows(wv[st.width:], st.vparts)]
    flat.append(row(net_params['views_linear']['b']))
    flat.append(b16(net_params['rgb_linear']['w']))
    flat.append(row(net_params['rgb_linear']['b']))
    return flat


def _weight_shapes(st: MLPStatic) -> List[Tuple[Tuple[int, int],
                                                torch.dtype]]:
    """(shape, dtype) of every ``flatten_params`` operand, in order."""
    shapes: List[Tuple[Tuple[int, int], torch.dtype]] = []
    W, H = st.width, st.half
    b16, f32 = torch.bfloat16, torch.float32
    for i in range(st.depth):
        if i == 0:
            shapes += [((d, W), b16) for d in st.dparts]
        else:
            shapes.append(((W, W), b16))
            if st.has_x_part(i):
                shapes += [((d, W), b16) for d in st.dparts]
        shapes.append(((1, W), f32))
    shapes += [((W, 1), b16), ((1, 1), f32),
               ((W, W), b16), ((1, W), f32),
               ((W, H), b16)]
    shapes += [((d, H), b16) for d in st.vparts]
    shapes += [((1, H), f32), ((H, 3), b16), ((1, 3), f32)]
    return shapes


def _mlp_macs(st: MLPStatic) -> int:
    """Multiply-accumulates of one point through the MLP."""
    macs = st.dnet * st.width
    for i in range(1, st.depth):
        macs += (st.width + (st.dnet if st.has_x_part(i) else 0)) * st.width
    macs += st.width * (1 + st.width)
    macs += (st.width + st.xv) * st.half + st.half * 3
    return macs


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16-operand product summed in f32: the operands are rounded to
    bf16 and multiplied as f32, where bf16 products are exact."""
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def _forward_tile(st: MLPStatic, xs, xvs, flat):
    """Plain forward of the MLP on part tiles (never concatenated).

    Mirrors ``pallas_mlp._forward_tile``: returns (acts, feat, hv, rgb,
    alpha) with ``acts[i]`` the bf16-valued post-ReLU activation of
    trunk layer i (kept in f32 storage).
    """
    it = iter(flat)
    nxt = lambda: next(it)
    b16 = lambda a: a.to(torch.bfloat16).float()
    h = None
    acts = []
    for i in range(st.depth):
        if i == 0:
            pre = _dot(xs[0], nxt())
            for xk in xs[1:]:
                pre = pre + _dot(xk, nxt())
        else:
            pre = _dot(h, nxt())
            if st.has_x_part(i):
                for xk in xs:
                    pre = pre + _dot(xk, nxt())
        pre = pre + nxt()
        h = b16(torch.relu(pre))
        acts.append(h)
    wa, ba = nxt(), nxt()
    alpha = _dot(h, wa) + ba
    wf, bf = nxt(), nxt()
    feat = b16(_dot(h, wf) + bf)
    hv_pre = _dot(feat, nxt())
    for xvk in xvs:
        hv_pre = hv_pre + _dot(xvk, nxt())
    hv_pre = hv_pre + nxt()
    hv = b16(torch.relu(hv_pre))
    wr, br = nxt(), nxt()
    rgb = _dot(hv, wr) + br
    return acts, feat, hv, rgb, alpha
