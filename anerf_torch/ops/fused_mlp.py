"""The split-operand radiance-MLP kernels (K5 forward, K6 backward),
and the pieces every MLP kernel of the port shares: statics, operand
order, the packed weight layouts and the plain forward and backward of
one point tile.

Port of ``anerf_tpu/ops/pallas_mlp.py``.  The numeric chain every fused
kernel follows (``pallas_mlp.py:23-24``): bf16 operands, f32
accumulation, f32 bias and ReLU, a bf16 re-cast between trunk layers;
``feat`` is rounded to bf16 after its bias with no ReLU; alpha and rgb
stay f32.  The backward (``pallas_encmlp._mlp_bwd_tile``) takes its ReLU
masks from the bf16 activations, rounds each cotangent to bf16 before
it feeds a product, and forms the bias gradients from the f32
cotangents and the weight gradients from the bf16 ones.

Two hand-written CUDA kernels replace the two Pallas kernels of
``pallas_mlp._fused_mlp`` (taken for configs outside
``fused_encmlp.supported_config``: multi-subject models, trainable
cutoffs, other encoders):

  * K5 ``mlp_fwd`` <- ``_fused_mlp_fwd`` / ``_fwd_kernel``
    (``csrc/mlp_fwd.cu``);
  * K6 ``mlp_bwd`` <- ``_fused_mlp_bwd`` / ``_bwd_kernel``
    (``csrc/mlp_bwd.cu``).

They take the encodings as separate bf16 part arrays (kp and bone
encodings for the trunk; view encoding, the subject channel of a
multi-subject model and framecodes for the views branch) and never
concatenate them in device memory.  ``nerf_mlp_fused`` runs K5 inside ``_FusedMLP``, a
``torch.autograd.Function`` whose backward is K6, so the gradients
reach every part and every weight on every device.  Beside each kernel
is its plain twin (``mlp_fwd_plain``, ``mlp_bwd_plain``); the wrappers
take the twins for CPU tensors only, launch the kernels for CUDA
tensors, and raise for any other device.  ``K5_LAUNCHES`` and
``K6_LAUNCHES`` count the launches (``launch_counts()``, merged into
``fused_encmlp.launch_counts()``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build


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


# ---------------------------------------------------------------------------
# The kernels' packed weight layouts (csrc/encmlp_common.cuh,
# csrc/mlp_bwd_common.cuh), shared by K1-K6
# ---------------------------------------------------------------------------

_XV_PAD = 672       # views input [parts | 0 ...], 42 x 16 columns


def _pack_kernel_weights(flat: Sequence[torch.Tensor], st: MLPStatic
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flatten_params`` (or ``flatten_params_cm``) operands -> the
    forward kernels' two buffers.

    bf16 buffer, each weight TRANSPOSED to (out, in) with the input
    parts of one product concatenated along ``in`` (zero rows padding
    the views input to a multiple of 16):
      L0 [v|r] (256, 432); L1-L4 (256, 256); L5 h (256, 256) then
      [v|r] (256, 432); L6, L7 (256, 256); feature (256, 256); views
      feature-part (128, 256) then [xv|codes|0] (128, 672);
      alpha (256,); rgb (3, 128).
    f32 buffer: b0..b7 (8 x 256), feature bias (256), views bias (128),
    alpha bias (1), rgb biases (3).
    """
    it = iter(flat)
    nx = len(st.dparts)
    w_parts: List[torch.Tensor] = []
    biases: List[torch.Tensor] = []
    t = lambda w: w.t().reshape(-1)
    for i in range(st.depth):
        if i == 0:
            w_parts.append(t(torch.cat([next(it) for _ in range(nx)], 0)))
        elif st.has_x_part(i):
            w_parts.append(t(next(it)))
            w_parts.append(t(torch.cat([next(it) for _ in range(nx)], 0)))
        else:
            w_parts.append(t(next(it)))
        biases.append(next(it).reshape(-1))
    wa, ba, wf, bf, wvf = (next(it) for _ in range(5))
    wvx = [next(it) for _ in st.vparts]
    bv, wr, br = next(it), next(it), next(it)
    w_parts.append(t(wf))
    w_parts.append(t(wvf))
    zeros = torch.zeros((_XV_PAD - sum(st.vparts), st.half),
                        dtype=wvf.dtype, device=wvf.device)
    w_parts.append(t(torch.cat(wvx + [zeros], 0)))
    w_parts.append(wa.reshape(-1))
    w_parts.append(t(wr))
    biases += [bf.reshape(-1), bv.reshape(-1), ba.reshape(-1),
               br.reshape(-1)]
    wbuf = torch.cat([w.to(torch.bfloat16) for w in w_parts]).contiguous()
    bbuf = torch.cat([b.float() for b in biases]).contiguous()
    return wbuf, bbuf


def _grad_layout(st: MLPStatic) -> List[Tuple[str, int, Tuple[int, int]]]:
    """Where the gradient of each ``flatten_params`` operand lies in the
    backward kernels' two f32 outputs: ('w', offset, shape) in the
    weight buffer or ('b', offset, shape) in the bias buffer.

    The weight buffer holds every weight as (in, out) row-major in
    flatten order, which puts the input parts of one product side by
    side (L0 [v|r] (432, 256), L5 h then [v|r], ..., views feature part
    then [xv|codes|0] (672, 128)): the layout ``_pack_bwd_weights``
    writes and ``csrc/mlp_bwd_common.cuh`` reads.  The bias buffer has the
    forward's bias layout (b0..b7, feature, views, alpha, rgb).
    """
    W, H = st.width, st.half
    ob_f = st.depth * W
    ob_v, ob_a = ob_f + W, ob_f + W + H
    ob_r = ob_a + 1
    out: List[Tuple[str, int, Tuple[int, int]]] = []
    woff = 0
    vx_last = len(_weight_shapes(st)) - 4      # the last views x-part
    for idx, (shape, dtype) in enumerate(_weight_shapes(st)):
        if dtype == torch.bfloat16:
            out.append(('w', woff, shape))
            woff += shape[0] * shape[1]
            if idx == vx_last:
                woff += (_XV_PAD - sum(st.vparts)) * H
        else:
            out.append(('b', 0, shape))
    biases = [i for i, (k, _, _) in enumerate(out) if k == 'b']
    offs = [i * W for i in range(st.depth)] + [ob_a, ob_f, ob_v, ob_r]
    for i, off in zip(biases, offs):
        out[i] = ('b', off, out[i][2])
    return out


def _pack_bwd_weights(flat: Sequence[torch.Tensor], st: MLPStatic
                      ) -> torch.Tensor:
    """The backward kernels' bf16 weight buffer: every weight at its
    ``_grad_layout`` offset, untransposed (in, out), zeros in the gaps
    (the rows past the views input parts).  The backward products
    contract over a layer's outputs, so their B fragments read these
    rows whole."""
    parts, pos = [], 0
    for w, (kind, off, shape) in zip(flat, _grad_layout(st)):
        if kind != 'w':
            continue
        if off > pos:
            parts.append(torch.zeros(off - pos, dtype=torch.bfloat16,
                                     device=w.device))
        parts.append(w.to(torch.bfloat16).reshape(-1))
        pos = off + shape[0] * shape[1]
    return torch.cat(parts).contiguous()


def _unpack_grads(st: MLPStatic, dw: torch.Tensor, db: torch.Tensor
                  ) -> List[torch.Tensor]:
    """The f32 gradient of every ``flatten_params`` operand, as views
    into one net's kernel outputs."""
    out = []
    for kind, off, shape in _grad_layout(st):
        buf = dw if kind == 'w' else db
        out.append(buf[off:off + shape[0] * shape[1]].view(shape))
    return out


# ---------------------------------------------------------------------------
# K5 / K6: plain twins, wrappers, autograd, launch counts
# ---------------------------------------------------------------------------

K5_LAUNCHES = 0
K6_LAUNCHES = 0

# the MLP the kernels are compiled for (csrc/encmlp_common.cuh): 8 x 256
# with the skip after layer 4, views branch 128, trunk parts summing to
# 432 and views parts to at most 672, at most 4 parts of each
_KERNEL_MLP = dict(depth=8, width=256, half=128, skips=(4,))
_DX, _MAX_PARTS = 432, 4


def reset_launch_counts() -> None:
    global K5_LAUNCHES, K6_LAUNCHES
    K5_LAUNCHES = K6_LAUNCHES = 0


def launch_counts() -> Dict[str, int]:
    return {'mlp_fwd': K5_LAUNCHES, 'mlp_bwd': K6_LAUNCHES}


def mlp_fwd_plain(st: MLPStatic, xs, xvs, flat) -> torch.Tensor:
    """Plain twin of K5: raw (n, 4) rows [r, g, b, alpha] in f32
    (``pallas_mlp._fwd_kernel``)."""
    _, _, _, rgb, alpha = _forward_tile(st, xs, xvs, flat)
    return torch.cat([rgb, alpha], -1)


def mlp_bwd_plain(st: MLPStatic, xs, xvs, flat, g):
    """Plain twin of K6 for the raw cotangent ``g`` (n, 4): returns
    (dxs, dxvs, grads), the part cotangents in bf16 as K6 writes them
    in the inputs' dtype (``pallas_mlp.py:357-358``) and the f32
    gradient of every ``flatten_params`` operand
    (``pallas_mlp._bwd_kernel``)."""
    g_x, g_xv, grads = _mlp_bwd_tile(st, xs, xvs, flat, g)
    b16 = lambda a: [x.to(torch.bfloat16) for x in a]
    return b16(g_x), b16(g_xv), grads


def _check_kernel_shape(st: MLPStatic) -> None:
    got = dict(depth=st.depth, width=st.width, half=st.half,
               skips=tuple(st.skips))
    if (got != _KERNEL_MLP or st.dnet != _DX or st.xv > _XV_PAD
            or max(len(st.dparts), len(st.vparts)) > _MAX_PARTS):
        raise NotImplementedError(
            f'the split-MLP CUDA kernels are built for {_KERNEL_MLP} with '
            f'trunk parts summing to {_DX} and views parts to at most '
            f'{_XV_PAD}; got {got}, parts {st.dparts} / {st.vparts}: other '
            'shapes are not ported yet (ROADMAP.md)')


def _check_parts(st: MLPStatic, xs, xvs) -> int:
    """Validate the part tiles; returns the point count n."""
    n = xs[0].shape[0]
    widths = [x.shape[-1] for x in xs], [x.shape[-1] for x in xvs]
    if (tuple(widths[0]), tuple(widths[1])) != (st.dparts, st.vparts):
        raise ValueError(f'part widths {widths} do not match '
                         f'{st.dparts} / {st.vparts}')
    for x in list(xs) + list(xvs):
        if x.dim() != 2 or x.shape[0] != n:
            raise ValueError('every part must be (n, width) with one n')
        if x.device != xs[0].device:
            raise ValueError('all kernel inputs must be on one device')
        if x.dtype != torch.bfloat16:
            raise TypeError(f'parts must be bfloat16, got {x.dtype}')
        if not x.is_contiguous():
            raise ValueError('parts must be contiguous')
    return n


def _part_args(ts):
    """(device pointers, widths) of part tensors as C arrays."""
    return ((ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts]),
            (ctypes.c_int * len(ts))(*[t.shape[1] for t in ts]))


def _packs(lib, flat, st):
    wbuf, bbuf = _pack_kernel_weights(flat, st)
    if (wbuf.numel() != lib.mlp_weight_elems()
            or bbuf.numel() != lib.mlp_bias_elems()):
        raise ValueError('packed weights do not match the kernel layout')
    return wbuf, bbuf


def mlp_fwd(st: MLPStatic, xs: Sequence[torch.Tensor],
            xvs: Sequence[torch.Tensor], flat: Sequence[torch.Tensor]
            ) -> torch.Tensor:
    """K5: the MLP on bf16 part tiles ``xs`` (n, dparts[k]) and ``xvs``
    (n, vparts[k]) with the ``flatten_params`` operands ``flat``;
    returns raw (n, 4) f32.  CPU tensors take the twin; CUDA tensors
    launch the kernel or raise.  No autograd (see ``_FusedMLP``)."""
    global K5_LAUNCHES
    n = _check_parts(st, xs, xvs)
    if cuda_build.device_of(xs[0]) == 'cpu':
        return mlp_fwd_plain(st, xs, xvs, flat)
    _check_kernel_shape(st)
    dev = xs[0].device
    lib = cuda_build.library('mlp_fwd')
    wbuf, bbuf = _packs(lib, flat, st)
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    (xp, xw), (vp, vw) = _part_args(xs), _part_args(xvs)
    with torch.cuda.device(dev):
        err = lib.mlp_fwd(xp, xw, len(xs), vp, vw, len(xvs),
                          wbuf.data_ptr(), bbuf.data_ptr(), out.data_ptr(),
                          n, cuda_build.stream(dev))
    if err != 0:
        raise RuntimeError(f'mlp_fwd launch failed: cudaError {err}')
    K5_LAUNCHES += 1
    return out


def mlp_bwd(st: MLPStatic, xs: Sequence[torch.Tensor],
            xvs: Sequence[torch.Tensor], flat: Sequence[torch.Tensor],
            g: torch.Tensor):
    """K6: the backward of K5 for the raw cotangent ``g`` (n, 4).
    Returns (dxs, dxvs, grads): the bf16 cotangents of the parts and the
    f32 gradient of every ``flatten_params`` operand, summed over all
    points.  CPU tensors take the twin; CUDA tensors launch the kernel
    or raise."""
    global K6_LAUNCHES
    n = _check_parts(st, xs, xvs)
    g = g.float().contiguous()
    if tuple(g.shape) != (n, 4) or g.device != xs[0].device:
        raise ValueError(f'the raw cotangent must be ({n}, 4) on '
                         f'{xs[0].device}')
    if cuda_build.device_of(xs[0]) == 'cpu':
        return mlp_bwd_plain(st, xs, xvs, flat, g)
    _check_kernel_shape(st)
    dev = xs[0].device
    lib = cuda_build.library('mlp_bwd')
    wbuf, bbuf = _packs(cuda_build.library('mlp_fwd'), flat, st)
    wbuf_b = _pack_bwd_weights(flat, st)
    n_dw = lib.mlp_grad_weight_elems()
    if wbuf_b.numel() != n_dw:
        raise ValueError('backward weight pack does not match the kernel')
    ws = torch.empty(int(lib.mlp_bwd_workspace_bytes(n)), dtype=torch.uint8,
                     device=dev)
    dxs = [torch.empty_like(x) for x in xs]
    dxvs = [torch.empty_like(x) for x in xvs]
    dw = torch.empty(n_dw, dtype=torch.float32, device=dev)
    db = torch.empty(bbuf.numel(), dtype=torch.float32, device=dev)
    (xp, xw), (vp, vw) = _part_args(xs), _part_args(xvs)
    dxp, dvp = _part_args(dxs)[0], _part_args(dxvs)[0]
    with torch.cuda.device(dev):
        err = lib.mlp_bwd(xp, xw, len(xs), vp, vw, len(xvs),
                          wbuf.data_ptr(), wbuf_b.data_ptr(), bbuf.data_ptr(),
                          g.data_ptr(), ws.data_ptr(), dxp, dvp,
                          dw.data_ptr(), db.data_ptr(), n,
                          cuda_build.stream(dev))
    if err != 0:
        raise RuntimeError(f'mlp_bwd launch failed: cudaError {err}')
    K6_LAUNCHES += 1
    return dxs, dxvs, _unpack_grads(st, dw, db)


class _FusedMLP(torch.autograd.Function):
    """K5 forward, K6 backward (``pallas_mlp._fused_mlp`` custom_vjp).
    Each gradient comes back in its operand's dtype: bf16 parts and
    weights, f32 biases (``gr.astype(d)``, pallas_mlp.py:503)."""

    @staticmethod
    def forward(ctx, st, nx, nv, *ops):
        ctx.st, ctx.nx, ctx.nv = st, nx, nv
        ctx.save_for_backward(*ops)
        return mlp_fwd(st, ops[:nx], ops[nx:nx + nv], ops[nx + nv:])

    @staticmethod
    def backward(ctx, g):
        ops = ctx.saved_tensors
        nx, nv = ctx.nx, ctx.nv
        flat = ops[nx + nv:]
        dxs, dxvs, grads = mlp_bwd(ctx.st, ops[:nx], ops[nx:nx + nv], flat,
                                   g)
        return (None, None, None, *dxs, *dxvs,
                *[gr.to(w.dtype) for gr, w in zip(grads, flat)])


def nerf_mlp_fused(net_params: Dict[str, Any], nerf_cfg,
                   x_parts: Sequence[torch.Tensor],
                   xv_parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The split-operand MLP on part lists -> raw (..., 4), the
    counterpart of ``pallas_mlp.nerf_mlp_pallas``.

    ``x_parts`` are the trunk input parts (kp encoding, bone encoding)
    and ``xv_parts`` the views-branch parts (view encoding, subject
    channel, framecodes), each (..., width); the parts are cast to bf16
    and never concatenated.  K5 forward and K6 backward on CUDA
    tensors, their twins on CPU tensors.  Unlike the TPU kernel the CUDA
    kernels mask their ragged edge, so any point count runs unpadded.
    """
    batch_shape = x_parts[0].shape[:-1]
    n = int(np.prod(batch_shape))
    st = MLPStatic(depth=nerf_cfg.depth, width=nerf_cfg.width,
                   dparts=tuple(int(p.shape[-1]) for p in x_parts),
                   vparts=tuple(int(p.shape[-1]) for p in xv_parts),
                   half=nerf_cfg.width // 2, skips=tuple(nerf_cfg.skips))
    prep = lambda p: p.reshape(n, p.shape[-1]).to(torch.bfloat16).contiguous()
    xs = [prep(p) for p in x_parts]
    xvs = [prep(p) for p in xv_parts]
    flat = flatten_params(net_params, st)
    raw = _FusedMLP.apply(st, len(xs), len(xvs), *xs, *xvs, *flat)
    return raw.reshape(*batch_shape, 4)


def kernel_cost(st: MLPStatic, n: int, backward: bool = False
                ) -> Dict[str, float]:
    """Work of one K5 (or, ``backward``, K6) launch on n points: bf16
    tensor-core FLOPs of the MLP (the backward recomputes the forward
    and forms the input cotangents and the weight gradients: 3x, as
    pallas_mlp.py:487 counts it) and the bytes that must move, as JAX's
    CostEstimate counts them (pallas_mlp.py:455, 488: the bf16 parts in,
    for the backward their cotangents out too, the raw rows or their
    cotangent at 16 bytes a point) plus the weights read once and, for
    the backward, the f32 weight gradients written once."""
    wshapes = _weight_shapes(st)
    wbytes = sum(int(np.prod(s)) * (2 if d == torch.bfloat16 else 4)
                 for s, d in wshapes)
    parts = n * (st.dnet + st.xv) * 2
    flops = 2. * _mlp_macs(st) * n
    if backward:
        flops *= 3
        gvals = sum(int(np.prod(s)) for s, _ in wshapes)
        nbytes = 2 * parts + n * 16 + wbytes + gvals * 4
    else:
        nbytes = parts + n * 16 + wbytes
    return {'bf16_flops': flops, 'f32_flops': 0., 'bytes': float(nbytes)}
