"""Shared pieces of the radiance-MLP kernels: statics, operand order and
the plain forward and backward of one point tile.

Port of the MLP half of ``anerf_tpu/ops/pallas_mlp.py``.  The numeric
chain every fused kernel follows (``pallas_mlp.py:23-24``): bf16
operands, f32 accumulation, f32 bias and ReLU, a bf16 re-cast between
trunk layers; ``feat`` is rounded to bf16 after its bias with no ReLU;
alpha and rgb stay f32.  The backward (``pallas_encmlp._mlp_bwd_tile``)
takes its ReLU masks from the bf16 activations, rounds each cotangent to
bf16 before it feeds a product, and forms the bias gradients from the
f32 cotangents and the weight gradients from the bf16 ones.

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


def _dot_nt(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g @ w^T with bf16 operands summed in f32: (T, n), (m, n) -> (T, m)
    (``pallas_mlp._dot_nt``)."""
    return _dot(g, w.t())


def _dot_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T @ b contracting the point axis, bf16 operands summed in f32:
    (T, m), (T, n) -> (m, n) (``pallas_mlp._dot_tn``)."""
    return _dot(a.t(), b)


def _mlp_bwd_tile(st: MLPStatic, xs, xvs, flat, g: torch.Tensor):
    """Plain backward of ``_forward_tile`` for one net.

    Mirrors ``pallas_encmlp._mlp_bwd_tile``: recomputes the forward,
    derives ReLU masks from the bf16 activations, rounds each
    cotangent to bf16 before it feeds a product, forms the bias
    gradients from the f32 cotangents and the weight gradients from the
    bf16 ones.  ``g`` is the raw cotangent (T, 4) [rgb, alpha].
    Returns (g_x_parts, g_xv_parts, grads): f32 input cotangents per
    part and the f32 gradient of every ``flatten_params`` operand, in
    flatten order.
    """
    b16 = lambda a: a.to(torch.bfloat16).float()
    T = xs[0].shape[0]
    acts, feat, hv, _, _ = _forward_tile(st, xs, xvs, flat)
    g = g.float()
    g_rgb, g_alpha = g[:, :3], g[:, 3:4]

    it = iter(flat)
    trunk = []
    for i in range(st.depth):
        if i == 0:
            trunk.append((None, [next(it) for _ in st.dparts]))
        elif st.has_x_part(i):
            wh = next(it)
            trunk.append((wh, [next(it) for _ in st.dparts]))
        else:
            trunk.append((next(it), None))
        next(it)
    wa, _, wf, _, wvf = next(it), next(it), next(it), next(it), next(it)
    wvs = [next(it) for _ in st.vparts]
    next(it)
    wr = next(it)

    g_rgb_b = b16(g_rgb)
    g_hv = _dot_nt(g_rgb_b, wr) * (hv > 0)
    g_hv_b = b16(g_hv)
    g_feat = _dot_nt(g_hv_b, wvf)
    g_xvs = [_dot_nt(g_hv_b, wvk) for wvk in wvs]
    g_feat_b = b16(g_feat)
    g_alpha_b = b16(g_alpha)
    g_a = _dot_nt(g_feat_b, wf) + _dot_nt(g_alpha_b, wa)

    g_x = [torch.zeros((T, d), dtype=torch.float32, device=g.device)
           for d in st.dparts]
    g_pre_by_layer = {}
    for i in reversed(range(st.depth)):
        g_pre = g_a * (acts[i] > 0)
        g_pre_b = b16(g_pre)
        g_pre_by_layer[i] = (g_pre, g_pre_b)
        wh, wxs = trunk[i]
        if i == 0:
            for k, w0k in enumerate(wxs):
                g_x[k] = g_x[k] + _dot_nt(g_pre_b, w0k)
            break
        g_a = _dot_nt(g_pre_b, wh)
        if wxs is not None:
            for k, wxk in enumerate(wxs):
                g_x[k] = g_x[k] + _dot_nt(g_pre_b, wxk)

    col_sum = lambda a: a.sum(0, keepdim=True)
    grads = []
    for i in range(st.depth):
        g_pre, g_pre_b = g_pre_by_layer[i]
        if i == 0:
            grads += [_dot_tn(xk, g_pre_b) for xk in xs]
        else:
            grads.append(_dot_tn(acts[i - 1], g_pre_b))
            if st.has_x_part(i):
                grads += [_dot_tn(xk, g_pre_b) for xk in xs]
        grads.append(col_sum(g_pre))
    a_last = acts[-1]
    grads += [_dot_tn(a_last, g_alpha_b), col_sum(g_alpha),
              _dot_tn(a_last, g_feat_b), col_sum(g_feat),
              _dot_tn(feat, g_hv_b)]
    grads += [_dot_tn(xvk, g_hv_b) for xvk in xvs]
    grads += [col_sum(g_hv), _dot_tn(hv, g_rgb_b), col_sum(g_rgb)]
    return g_x, g_xvs, grads
