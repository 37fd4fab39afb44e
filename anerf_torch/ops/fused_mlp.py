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
``fused_encmlp.kernel_shape_ok``: multi-subject models, trainable
cutoffs, other encoders, shapes the fused encode kernels are not
built for such as 768-wide nets, ROADMAP B.1.4):

  * K5 ``mlp_fwd`` <- ``_fused_mlp_fwd`` / ``_fwd_kernel``
    (``csrc/mlp_fwd.cu``);
  * K6 ``mlp_bwd`` <- ``_fused_mlp_bwd`` / ``_bwd_kernel``
    (``csrc/mlp_bwd.cu``).

They take the encodings as separate bf16 part arrays (kp and bone
encodings for the trunk; view encoding, the subject channel of a
multi-subject model and framecodes for the views branch) and never
concatenate them in device memory.  Each is compiled for one shape, as
the TPU kernel compiles per static shape (``cuda_build.library(which,
dx, depth, width)``): the trunk width, the sum of the trunk parts (432
at the flagship's encoders, 117, 1152 or 1197 at 'querypts', 'relpos'
or 'cat'), and the net's depth and width (``kernel_static``).  A net
runs at its width rounded up to a multiple of 256: the packs pad every
hidden width with zero rows, columns and biases, which is exact (a
padded unit's pre-activation and ReLU output are 0, and its outgoing
weights are 0, so no cotangent flows back through it), and the padding's
gradients are dropped (``_unpack_grads``).  Past 512 columns the
kernels keep the activations in device memory (csrc/encmlp_common.cuh
``WIDE``).
``nerf_mlp_fused`` runs K5 inside ``_FusedMLP``, a
``torch.autograd.Function`` whose backward is K6, so the gradients
reach every part and every weight on every device.  Beside each kernel
is its plain twin (``mlp_fwd_plain``, ``mlp_bwd_plain``); the wrappers
take the twins for CPU tensors only, launch the kernels for CUDA
tensors, and raise for any other device.  ``K5_LAUNCHES`` and
``K6_LAUNCHES`` count the launches (``launch_counts()``, merged into
``fused_encmlp.launch_counts()``); in a captured CUDA graph at capture
only, as ``fused_encmlp``'s counters.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
    # the views input's width in the kernels' layouts ([parts | 0 ...]):
    # K5/K6's ``views_pad`` of the parts (None: that), a K1-K4 build's
    # 72 NB + its framecode columns + 8 (fused_encmlp._statics)
    xv_pad: Optional[int] = None

    def __post_init__(self):
        if self.xv_pad is None:
            object.__setattr__(self, 'xv_pad', views_pad(sum(self.vparts)))

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


def _dx_pad(st: MLPStatic) -> int:
    """The trunk input's width in the kernels' layouts: the parts' sum
    rounded up to the 16-deep k-step (``DXP``, csrc/encmlp_common.cuh)."""
    return -(-st.dnet // 16) * 16


def _weight_blocks(st: MLPStatic) -> List[Tuple[Tuple[int, int],
                                                torch.dtype, int]]:
    """(shape, dtype, zero rows after it in the kernels' layouts) of every
    ``flatten_params`` operand, in order: the last trunk part of layer 0
    and of the skip layer is followed by the trunk input's padding to
    ``_dx_pad``, the last views part by the views input's to
    ``st.xv_pad``."""
    blocks: List[Tuple[Tuple[int, int], torch.dtype, int]] = []
    W, H = st.width, st.half
    b16, f32 = torch.bfloat16, torch.float32
    xpad = _dx_pad(st) - st.dnet

    x_parts = [((d, W), b16, xpad if k == len(st.dparts) - 1 else 0)
               for k, d in enumerate(st.dparts)]
    for i in range(st.depth):
        if i == 0:
            blocks += x_parts
        else:
            blocks.append(((W, W), b16, 0))
            if st.has_x_part(i):
                blocks += x_parts
        blocks.append(((1, W), f32, 0))
    blocks += [((W, 1), b16, 0), ((1, 1), f32, 0),
               ((W, W), b16, 0), ((1, W), f32, 0),
               ((W, H), b16, 0)]
    vpad = st.xv_pad - sum(st.vparts)
    blocks += [((d, H), b16, vpad if k == len(st.vparts) - 1 else 0)
               for k, d in enumerate(st.vparts)]
    blocks += [((1, H), f32, 0), ((H, 3), b16, 0), ((1, 3), f32, 0)]
    return blocks


def _weight_shapes(st: MLPStatic) -> List[Tuple[Tuple[int, int],
                                                torch.dtype]]:
    """(shape, dtype) of every ``flatten_params`` operand, in order."""
    return [(shape, dtype) for shape, dtype, _ in _weight_blocks(st)]


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
        hv_pre = hv_pre + (_viewfac_dot(xvk, nxt()) if _is_fac(xvk)
                           else _dot(xvk, nxt()))
    hv_pre = hv_pre + nxt()
    hv = b16(torch.relu(hv_pre))
    wr, br = nxt(), nxt()
    rgb = _dot(hv, wr) + br
    return acts, feat, hv, rgb, alpha


def viewfac_operand(w: torch.Tensor, enc: torch.Tensor, S: int):
    """The factorized views operand (``pallas_mlp.viewfac_operand``).

    The 'relray' view rows are constant along each ray, so the views
    layer's ``xv @ Wv`` with ``xv[t, b J + j] = enc[ray(t), b J + j]
    w[t, j]`` equals ``xw @ M`` per ray, ``M[r, j] = sum_b enc[r, b J +
    j] Wv[b J + j]``: w (n, J) the per-point windows, enc (R, nblk J)
    the per-ray view rows, n = R S.  Returns the ('fac', xw, E, S) tuple
    that ``_viewfac_dot`` / ``_viewfac_bwd`` take in place of a dense xv
    part: xw and E rounded to bf16 (kept in f32 storage), as the TPU
    kernel's operands are.  Where the TPU kernel builds the block-diagonal
    form of a tile of rays, the port keeps the rays in a batch axis."""
    b16 = lambda a: a.to(torch.bfloat16).float()
    return ('fac', b16(w), b16(enc), S)


def _is_fac(x) -> bool:
    return isinstance(x, tuple) and x[0] == 'fac'


def viewfac_m(E: torch.Tensor, wv: torch.Tensor, J: int) -> torch.Tensor:
    """M (R, J, half) f32: ``M[r, j] = sum_b E[r, b J + j] wv[b J + j]``
    of bf16-valued operands, summed in f32 (``_dot(E, wv)`` of the TPU
    kernel's block form), J the joints."""
    R, nblkJ = E.shape
    half = wv.shape[1]
    E3 = E.reshape(R, nblkJ // J, J).float()
    W3 = wv.to(torch.bfloat16).float().reshape(nblkJ // J, J, half)
    return torch.einsum('rbj,bjh->rjh', E3, W3)


def _viewfac_dot(fac, wv: torch.Tensor) -> torch.Tensor:
    """``xw @ M`` per ray (``pallas_mlp._viewfac_dot``): M in f32 rounded
    to bf16, the product of bf16-valued operands summed in f32; returns
    (n, half) f32."""
    _, xw, E, S = fac
    R, J = E.shape[0], xw.shape[1]
    Mb = viewfac_m(E, wv, J).to(torch.bfloat16).float()
    return torch.bmm(xw.reshape(R, S, J), Mb).reshape(R * S, -1)


def _viewfac_bwd(fac, wv: torch.Tensor, g_hv: torch.Tensor):
    """Backward of ``_viewfac_dot`` for the views cotangent g_hv (n,
    half) (``pallas_mlp._viewfac_bwd``): with the per-ray Gram matrix
    ``Gw[r] = xw[ray r]^T bf16(g_hv[ray r])`` in f32, rounded to bf16,
    returns (d_window (n, J), d_enc (R, nblk J), dWv (nblk J, half)), all
    f32: ``d_window[t, j] = bf16(g_hv[t]) . bf16(M)[ray(t), j]``,
    ``dWv[b J + j] = sum_r E[r, b J + j] Gw[r, j]``, ``d_enc[r, b J + j]
    = Gw[r, j] . wv[b J + j]``."""
    _, xw, E, S = fac
    b16 = lambda a: a.to(torch.bfloat16).float()
    R, nblkJ = E.shape
    J, half = xw.shape[1], wv.shape[1]
    g3 = b16(g_hv).reshape(R, S, half)
    x3 = xw.reshape(R, S, J)
    Mb = b16(viewfac_m(E, wv, J))
    Gw = b16(torch.bmm(x3.transpose(1, 2), g3))              # (R, J, half)
    d_window = torch.bmm(g3, Mb.transpose(1, 2)).reshape(R * S, J)
    E3 = E.reshape(R, nblkJ // J, J)
    W3 = b16(wv).reshape(nblkJ // J, J, half)
    dWv = torch.einsum('rbj,rjh->bjh', E3, Gw).reshape(nblkJ, half)
    d_enc = torch.einsum('rjh,bjh->rbj', Gw, W3).reshape(R, nblkJ)
    return d_window, d_enc, dWv


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
    flatten order.  A factorized views part (``viewfac_operand``) backs
    through ``_viewfac_bwd``: its entry of g_xv_parts is ('facg',
    d_window, d_enc) and its weight's gradient dWv.
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
    g_xvs, fac_dwv = [], {}
    for k, (xvk, wvk) in enumerate(zip(xvs, wvs)):
        if _is_fac(xvk):
            d_window, d_enc, fac_dwv[k] = _viewfac_bwd(xvk, wvk, g_hv)
            g_xvs.append(('facg', d_window, d_enc))
        else:
            g_xvs.append(_dot_nt(g_hv_b, wvk))
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
    grads += [fac_dwv[k] if k in fac_dwv else _dot_tn(xvk, g_hv_b)
              for k, xvk in enumerate(xvs)]
    grads += [col_sum(g_hv), _dot_tn(hv, g_rgb_b), col_sum(g_rgb)]
    return g_x, g_xvs, grads


# ---------------------------------------------------------------------------
# The kernels' packed weight layouts (csrc/encmlp_common.cuh,
# csrc/mlp_bwd_common.cuh), shared by K1-K6
# ---------------------------------------------------------------------------

# K5/K6's views input [parts | 0 ...]: 672 columns (42 x 16) for any
# views parts up to it, as every build before views widths of their own
# had it; past that the parts' sum + 8 rounded up to 16, a build per
# width (cuda_build ``-DANERF_DXV``), up to 4096
_XV_PAD = cuda_build.FLAGSHIP_XV
_MAX_XV_PAD = 4096


def views_pad(xv: int) -> int:
    """K5/K6's views width for views parts summing to ``xv``."""
    return _XV_PAD if xv <= _XV_PAD else -(-(xv + 8) // 16) * 16


def kernel_static(st: MLPStatic) -> MLPStatic:
    """The net the kernels run ``st`` as: its width padded to the next
    multiple of 256, ``half`` to half of that; depth, parts and skips as
    they are (csrc/encmlp_common.cuh ``W``, ``HV``)."""
    width = max(256, -(-st.width // 256) * 256)
    if (st.width, st.half) == (width, width // 2):
        return st
    return dataclasses.replace(st, width=width, half=width // 2)


def _pad_operands(flat: Sequence[torch.Tensor], st: MLPStatic
                  ) -> List[torch.Tensor]:
    """The ``flatten_params`` operands of ``st`` as those of
    ``kernel_static(st)``: each at the top-left corner of its padded
    shape, zeros in the rest."""
    stk = kernel_static(st)
    if stk is st:
        return list(flat)
    return [torch.nn.functional.pad(w, (0, c - w.shape[1], 0, r - w.shape[0]))
            for w, ((r, c), _) in zip(flat, _weight_shapes(stk))]


def _pack_kernel_weights(flat: Sequence[torch.Tensor], st: MLPStatic
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flatten_params`` (or ``flatten_params_cm``) operands -> the
    forward kernels' two buffers.

    bf16 buffer, each weight TRANSPOSED to (out, in) with the input
    parts of one product concatenated along ``in`` (zero rows padding
    the trunk input to ``_dx_pad`` and the views input to ``st.xv_pad``,
    both multiples of 16):
      L0 [v|r|0] (256, DXP: 432 at the flagship's encoders);
      L1-L4 (256, 256); L5 h (256, 256) then [v|r|0] (256, DXP);
      L6, L7 (256, 256); feature (256, 256); views feature-part
      (128, 256) then [xv|codes|0] (128, ``st.xv_pad``: 672 for K5/K6);
      alpha (256,); rgb (3, 128).
    f32 buffer: b0..b7 (8 x 256), feature bias (256), views bias (128),
    alpha bias (1), rgb biases (3).  (The flagship's 8 x 256 net; a net
    of other depth has its layers and biases in the same order, one of
    other width is padded to ``kernel_static``'s first.)
    """
    flat = _pad_operands(flat, st)
    st = kernel_static(st)
    it = iter(flat)
    nx = len(st.dparts)
    w_parts: List[torch.Tensor] = []
    biases: List[torch.Tensor] = []
    t = lambda w: w.t().reshape(-1)

    def x_block():
        ws = [next(it) for _ in range(nx)]
        pad = _dx_pad(st) - st.dnet
        if pad:
            ws.append(torch.zeros((pad, ws[0].shape[1]), dtype=ws[0].dtype,
                                  device=ws[0].device))
        return t(torch.cat(ws, 0))
    for i in range(st.depth):
        if i == 0:
            w_parts.append(x_block())
        elif st.has_x_part(i):
            w_parts.append(t(next(it)))
            w_parts.append(x_block())
        else:
            w_parts.append(t(next(it)))
        biases.append(next(it).reshape(-1))
    wa, ba, wf, bf, wvf = (next(it) for _ in range(5))
    wvx = [next(it) for _ in st.vparts]
    bv, wr, br = next(it), next(it), next(it)
    w_parts.append(t(wf))
    w_parts.append(t(wvf))
    zeros = torch.zeros((st.xv_pad - sum(st.vparts), st.half),
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
    side, followed by the zero rows of the input's padding (L0
    [v|r|0] (DXP, 256), L5 h then [v|r|0], ..., views feature part then
    [xv|codes|0] (``st.xv_pad``, 128)): the layout ``_pack_bwd_weights`` writes
    and ``csrc/mlp_bwd_common.cuh`` reads.  The bias buffer has the
    forward's bias layout (b0..b7, feature, views, alpha, rgb).
    """
    W, H = st.width, st.half
    ob_f = st.depth * W
    ob_v, ob_a = ob_f + W, ob_f + W + H
    ob_r = ob_a + 1
    out: List[Tuple[str, int, Tuple[int, int]]] = []
    woff = 0
    for shape, dtype, pad in _weight_blocks(st):
        if dtype == torch.bfloat16:
            out.append(('w', woff, shape))
            woff += (shape[0] + pad) * shape[1]
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
    (the rows past the trunk and the views input parts).  The backward products
    contract over a layer's outputs, so their B fragments read these
    rows whole.  A net is padded to ``kernel_static``'s first."""
    flat = _pad_operands(flat, st)
    st = kernel_static(st)
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
    into one net's kernel outputs (at ``kernel_static(st)``): of a
    padded net, the real rows and columns of each, the padding's
    gradients dropped."""
    out = []
    for (kind, off, shape), (real, _) in zip(
            _grad_layout(kernel_static(st)), _weight_shapes(st)):
        buf = dw if kind == 'w' else db
        g = buf[off:off + shape[0] * shape[1]].view(shape)
        out.append(g if real == shape else g[:real[0], :real[1]])
    return out


# The dW pass's split over the point axis (csrc/mlp_bwd_common.cuh
# dw_kernel): 128 x 128 output tiles, each walking one of P slices of the
# points; P makes the tiles of a launch fill the card's 132 SMs about
# _DW_WAVES times over, with slices of at least _DW_MIN_SLICE points.
# (On the card the pass's time fell with P up to about 16 waves and
# then held, and slices shorter than ~2k points cost more than they
# gained: scripts/sweep_dw_slices.py.)  P depends on the shape and n
# alone, so the
# sums' order, and the bits, are the same on any card.
_DW_TILE, _SMS, _DW_WAVES, _DW_MIN_SLICE = 128, 132, 16, 2048


def dw_tiles(st: MLPStatic, nnet: int = 1) -> int:
    """The dW pass's output tiles for ``nnet`` nets of ``st`` (at
    ``kernel_static``), job by job as ``launch_grads`` lists them: 59 a
    flagship net."""
    stk = kernel_static(st)
    W, H, dxp = stk.width, stk.half, _dx_pad(stk)
    tiles = lambda m, n: -(-m // _DW_TILE) * -(-n // _DW_TILE)
    skip = any(stk.has_x_part(i) for i in range(stk.depth))
    per_net = ((2 if skip else 1) * tiles(dxp, W)
               + (stk.depth - 1) * tiles(W, W) + tiles(W, 1) + tiles(W, W)
               + tiles(W, H) + tiles(stk.xv_pad, H) + tiles(H, 3))
    return nnet * per_net


def dw_plan(st: MLPStatic, n: int, nnet: int = 1) -> Tuple[int, int]:
    """(P, slice): the dW pass's points (n padded to the 64-point tile)
    cut into P slices of ``slice`` points, a multiple of 64."""
    n_pad = -(-n // 64) * 64
    want = -(-_DW_WAVES * _SMS // dw_tiles(st, nnet))
    want = max(1, min(want, n_pad // _DW_MIN_SLICE))
    slice_ = -(-n_pad // want)
    slice_ = -(-slice_ // 64) * 64
    return -(-n_pad // slice_), slice_


def dw_partials(st: MLPStatic, n: int, n_dw: int, nnet: int,
                device) -> Tuple[torch.Tensor, int, int]:
    """The dW pass's f32 partials (P copies of ``nnet`` nets' ``n_dw``
    gradient values), from PyTorch's allocator (a graph capture's pool
    when capturing), with P and the slice."""
    P, slice_ = dw_plan(st, n, nnet)
    part = torch.empty(P * nnet * n_dw, dtype=torch.float32, device=device)
    return part, P, slice_


# ---------------------------------------------------------------------------
# K5 / K6: plain twins, wrappers, autograd, launch counts
# ---------------------------------------------------------------------------

K5_LAUNCHES = 0
K6_LAUNCHES = 0

# the nets the kernels are built for (csrc/encmlp_common.cuh, a library
# per shape, ops/cuda_build.py): 1-128 layers up to 4096 wide (run at the
# next multiple of 256, ``kernel_static``), depth x that width up to
# 262,144 (past it K6's workspace for the train step's 131,072 points,
# 4 bytes a layer's column a point, outgrows the card's 80 GB), the
# views branch half as wide, the skip after layer 4 as factory.py sets
# it; trunk parts summing to 1-4096 columns and views parts to a views
# width (``views_pad``) of at most 4096, at most 4 parts of each
_MAX_DEPTH, _MAX_WIDTH, _SKIPS = 128, 4096, (cuda_build.SKIP,)
_MAX_LAYER_COLS = 262144
_MAX_DX, _MAX_PARTS = 4096, 4


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


def kernel_refusal(st: MLPStatic) -> Optional[str]:
    """Why K5/K6 do not take ``st`` (the cap it passes, ROADMAP.md
    C.16), or None where they do: the gate the wrappers ask before a
    launch, asked without one."""
    width = kernel_static(st).width if st.width >= 1 else st.width
    if (st.width > _MAX_WIDTH or st.depth > _MAX_DEPTH
            or st.depth * width > _MAX_LAYER_COLS):
        return (f'a net of {st.depth} layers {st.width} wide: they take at '
                f'most {_MAX_DEPTH} layers, {_MAX_WIDTH} columns and depth '
                f'x width (rounded up to 256) {_MAX_LAYER_COLS}, past which '
                f'K6\'s workspace for 131,072 points outgrows the card '
                f'(ROADMAP.md C.16)')
    if (not 1 <= st.depth <= _MAX_DEPTH or st.width < 1
            or st.half != st.width // 2 or tuple(st.skips) != _SKIPS):
        return (f'depth {st.depth}, width {st.width}, half {st.half}, skips '
                f'{tuple(st.skips)}: they take 1-{_MAX_DEPTH} layers, half '
                f'= width // 2 and skips {_SKIPS} (ROADMAP.md)')
    if (not 1 <= st.dnet <= _MAX_DX or views_pad(st.xv) > _MAX_XV_PAD
            or max(len(st.dparts), len(st.vparts)) > _MAX_PARTS):
        return (f'parts {st.dparts} / {st.vparts}: they take trunk parts '
                f'summing to at most {_MAX_DX} and views parts to at most '
                f'{_MAX_XV_PAD - 8} (a views width of {_MAX_XV_PAD}), '
                f'{_MAX_PARTS} of each (ROADMAP.md C.16)')
    return None


def _check_kernel_shape(st: MLPStatic) -> None:
    why = kernel_refusal(st)
    if why is not None:
        raise NotImplementedError(
            f'the split-MLP CUDA kernels do not take {why}')


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


def _library(which: str, st: MLPStatic):
    """K5's or K6's library for the trunk width, net (at
    ``kernel_static``) and views width of ``st``, built at its first
    use."""
    want = (st.dnet, st.depth, kernel_static(st).width)
    lib = cuda_build.library(which, *want, xv=st.xv_pad)
    got = (lib.mlp_trunk_width(), lib.mlp_net_depth(), lib.mlp_net_width())
    if got != want:
        raise RuntimeError(f'{which} library built for (trunk, depth, width)'
                           f' {got}, not {want}')
    if which == 'mlp_fwd' and lib.mlp_views_width() != st.xv_pad:
        raise RuntimeError(f'{which} library built for views width '
                           f'{lib.mlp_views_width()}, not {st.xv_pad}')
    return lib


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
    lib = _library('mlp_fwd', st)
    wbuf, bbuf = _packs(lib, flat, st)
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    ws = torch.empty(int(lib.mlp_fwd_workspace_bytes(n)), dtype=torch.uint8,
                     device=dev)
    (xp, xw), (vp, vw) = _part_args(xs), _part_args(xvs)
    with torch.cuda.device(dev):
        err = lib.mlp_fwd(xp, xw, len(xs), vp, vw, len(xvs),
                          wbuf.data_ptr(), bbuf.data_ptr(), ws.data_ptr(),
                          out.data_ptr(), n, cuda_build.stream(dev))
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
    lib = _library('mlp_bwd', st)
    # both packs from the operands padded once to the build's net
    flat_k, st_k = _pad_operands(flat, st), kernel_static(st)
    wbuf, bbuf = _packs(_library('mlp_fwd', st), flat_k, st_k)
    wbuf_b = _pack_bwd_weights(flat_k, st_k)
    n_dw = lib.mlp_grad_weight_elems()
    if wbuf_b.numel() != n_dw:
        raise ValueError('backward weight pack does not match the kernel')
    ws = torch.empty(int(lib.mlp_bwd_workspace_bytes(n)), dtype=torch.uint8,
                     device=dev)
    dxs = [torch.empty_like(x) for x in xs]
    dxvs = [torch.empty_like(x) for x in xvs]
    dw = torch.empty(n_dw, dtype=torch.float32, device=dev)
    db = torch.empty(bbuf.numel(), dtype=torch.float32, device=dev)
    part, P, slice_ = dw_partials(st, n, n_dw, 1, dev)
    (xp, xw), (vp, vw) = _part_args(xs), _part_args(xvs)
    dxp, dvp = _part_args(dxs)[0], _part_args(dxvs)[0]
    with torch.cuda.device(dev):
        err = lib.mlp_bwd(xp, xw, len(xs), vp, vw, len(xvs),
                          wbuf.data_ptr(), wbuf_b.data_ptr(), bbuf.data_ptr(),
                          g.data_ptr(), ws.data_ptr(), dxp, dvp,
                          dw.data_ptr(), db.data_ptr(), part.data_ptr(), P,
                          slice_, n, cuda_build.stream(dev))
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


def dw_cost(st: MLPStatic, n: int, nnet: int = 1) -> Dict[str, float]:
    """Work of the backward kernels' dW pass on n points of ``nnet``
    nets (which share the trunk input, as K4's do): bf16 tensor-core
    FLOPs of every weight gradient A^T G, and the bytes that must move:
    each bf16 activation and cotangent it reads once (the trunk input,
    every layer's activation and pre-activation cotangent, feat, the
    views input and layer and their cotangents, the heads' 4
    cotangents) and each f32 weight gradient written once."""
    wvals = sum(int(np.prod(s)) for s, d in _weight_shapes(st)
                if d == torch.bfloat16)
    per_net = (2 * st.depth * st.width + 2 * st.width + 2 * st.half
               + st.xv + 4)
    nbytes = 2 * n * (st.dnet + nnet * per_net) + 4 * nnet * wvals
    return {'bf16_flops': 2. * n * wvals * nnet, 'f32_flops': 0.,
            'bytes': float(nbytes)}
