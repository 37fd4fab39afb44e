"""Fused encode+MLP: skeleton-relative points in, raw radiance out, and
its backward.

Port of ``anerf_tpu/ops/pallas_encmlp.py``.  For the flagship encoding
family (kp 'reldist' + bone 'reldir' + view 'relray', cutoff windows on
all three) the encoded features are a pure elementwise function of the
component-major points ``pts_t`` plus a small per-ray view PE, so the
kernels compute distances, windows, positional encodings AND the whole
radiance MLP per point tile: device memory sees ``pts_t`` (72 channels)
in and raw (4 channels) out.

Four hand-written CUDA kernels replace the four Pallas kernels of the
train step:

  * K1 ``encmlp_fwd``      <- ``_fused_call`` / ``_fwd_kernel`` (one
    net; the fine pass on the importance samples);
  * K2 ``encmlp_dual_fwd`` <- ``_fused_dual_call`` / ``_fwd_kernel_dual``
    (encode once, coarse AND fine nets; the coarse samples);
  * K3 ``encmlp_bwd``      <- ``_fused_bwd`` / ``_bwd_kernel``;
  * K4 ``encmlp_dual_bwd`` <- ``_fused_dual_bwd`` / ``_bwd_kernel_dual``.

K1/K2 are in ``csrc/encmlp_fwd.cu``, K3/K4 in ``csrc/encmlp_bwd.cu``
(their source notes give the designs and bounds).  All four are bound
by tensor-core operations: each point costs 2 x 863,872 MACs per net
forward, three times that backward, against a few hundred bytes of
device traffic.

``encmlp_fwd``/``encmlp_dual_fwd`` run K1/K2 inside a
``torch.autograd.Function`` whose backward is K3/K4 (the counterpart of
JAX's ``custom_vjp``), so the gradients reach the points, the view PE
rows, the framecodes and every weight on every device.  Each weight
gradient comes back in its operand's dtype (bf16 weights, f32 biases),
as JAX's ``gr.astype(d)``; ``cutoff`` and ``tau`` get none.

Beside each kernel is its plain PyTorch twin (``encmlp_fwd_plain``,
``encmlp_dual_fwd_plain``, ``encmlp_bwd_plain``,
``encmlp_dual_bwd_plain``): the same bf16 chain with the encodings
materialized and exact bf16 products summed in f32.  The wrappers take
the twin for tensors on the CPU only; for CUDA tensors they launch the
kernel or raise.  Each wrapper counts its launches in a module integer
(``K1_LAUNCHES`` .. ``K4_LAUNCHES``, read by ``launch_counts()``).

The PE bands use the double-angle recurrence from one sin and one
cos-as-shifted-sin per joint, as the TPU kernels do (pallas_encmlp.py
``SIN_RECURRENCE``), in the twins and the kernels alike; the backward
recomputes them instead of reading the TPU's stash.

Not ported yet (ROADMAP.md): the per-ray view factorization mode
(``viewfac``; its cost gate is computed here but the port always runs
the dense form, which is the same function up to bf16 rounding) and the
in-kernel rigid transform (``fuse_tform``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build, fused_mlp
from .cuda_build import build_kernels  # noqa: F401  (re-exported)
from .fused_mlp import (MLPStatic, _forward_tile, _mlp_bwd_tile, _mlp_macs,
                        _pack_bwd_weights, _pack_kernel_weights,
                        _unpack_grads, _weight_shapes)
from .fused_mlp import flatten_params as _flatten_plain


@dataclasses.dataclass(frozen=True)
class EncStatic:
    """Static description of the fused encode."""
    J: int                          # joints (24)
    kp_freqs: Tuple[float, ...]     # kp PE bands (2^0..2^6)
    view_nb: int                    # view PE rows incl. input (1 + 2F_v)
    S: int                          # samples per ray in this pass
    rpt: int                        # rays per TPU tile (tile // S)
    has_codes: bool
    bone_windowed: bool = False     # --cutoff_bones (off in all configs)
    eps: float = 1e-12
    # per-ray view factorization cost-gate decision (see _build_call)
    viewfac: bool = False


def _comp_major_perm(J: int) -> np.ndarray:
    """perm[i] = joint-major row for component-major index i."""
    comp, j = np.divmod(np.arange(3 * J), J)
    return (j * 3 + comp).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _perm_tensors(J: int, nb: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(component-major perm (3J,), the same per view PE row block
    (nb*3J,)) on ``device``, built once: a host-to-device copy waits
    for the stream to drain, so per-chunk copies would idle the GPU.
    Built outside inference mode, so that a renderer's first call leaves
    tensors that autograd may save later."""
    blocks = np.concatenate([b * 3 * J + _comp_major_perm(J)
                             for b in range(nb)])
    with torch.inference_mode(False):
        return (torch.as_tensor(_comp_major_perm(J), device=device),
                torch.as_tensor(blocks, device=device))


def _doubling_freqs(freqs) -> bool:
    """True iff the grid is exactly 2^0..2^(F-1), the precondition of
    the double-angle recurrence."""
    return bool(freqs) and abs(freqs[0] - 1.0) < 1e-6 and all(
        abs(freqs[k + 1] - 2. * freqs[k]) < 1e-6 * freqs[k + 1]
        for k in range(len(freqs) - 1))


def _encode_plain(est: EncStatic, p: torch.Tensor, enc_ray: torch.Tensor,
                  cutoff: torch.Tensor, tau: torch.Tensor):
    """Materialized encode of component-major points ``p`` (n, 3J):
    returns (v (n, (1+2F)J), r (n, 3J), xv (n, nb*3J)) in f32, the
    values the CUDA kernels build in shared memory."""
    return _encode_fwd_res(est, p, enc_ray, cutoff, tau)[0]


def _encode_fwd_res(est: EncStatic, p: torch.Tensor, enc_ray: torch.Tensor,
                    cutoff: torch.Tensor, tau: torch.Tensor):
    """``_encode_plain`` plus the pullback's residuals: returns
    ((v, r, xv), (dists, w, bands, invd)).

    Mirrors ``pallas_encmlp._encode_fwd_res`` for the flagship flags
    (include_input, cutoff_inputs, no shift/cut_to/schedule).
    """
    J = est.J
    x, y, z = p[:, :J], p[:, J:2 * J], p[:, 2 * J:]
    dists = torch.sqrt(x * x + y * y + z * z)                 # (n, J)
    w = 1. - torch.sigmoid(tau * (dists - cutoff))            # (n, J)
    F = len(est.kp_freqs)
    if not _doubling_freqs(est.kp_freqs):
        raise NotImplementedError('the fused encode needs the 2^k kp grid')
    # one sin for (sin f0 d, cos f0 d), then per octave
    # sin 2a = 2 sin a cos a, cos 2a = 1 - 2 sin^2 a
    ang = dists * est.kp_freqs[0]
    sc = torch.sin(torch.cat([ang, ang + np.float32(np.pi / 2)], -1))
    s_k, c_k = sc[:, :J], sc[:, J:]
    blocks = [sc]
    for _ in range(F - 1):
        s_k, c_k = 2. * s_k * c_k, 1. - 2. * s_k * s_k
        blocks.append(torch.cat([s_k, c_k], -1))
    bands = torch.cat(blocks, -1)
    v = torch.cat([dists, bands], -1) * w.repeat(1, 2 * F + 1)

    invd = 1. / torch.clamp(dists, min=est.eps)
    w3 = w.repeat(1, 3)
    r = p * invd.repeat(1, 3)
    if est.bone_windowed:
        r = r * w3
    # per-ray view PE rows times the per-sample window (col % J = joint)
    ray = torch.arange(p.shape[0], device=p.device) // est.S
    xv = enc_ray[ray] * w3.repeat(1, est.view_nb)
    return (v, r, xv), (dists, w, bands, invd)


def _sum_blocks(a: torch.Tensor, width: int, k: int) -> torch.Tensor:
    """Fold (n, k*width) to (n, width) by summing the k column blocks in
    order (the pullback of a column-block repeat)."""
    acc = a[:, :width]
    for i in range(1, k):
        acc = acc + a[:, i * width:(i + 1) * width]
    return acc


def _encode_pullback_plain(est: EncStatic, p, enc_ray, res, tau, gv, gr,
                           gxv):
    """Plain VJP of ``_encode_fwd_res`` (f32 cotangents in), the
    transcendental-free pullback of ``pallas_encmlp._encode_pullback``:
    each band's derivative is its paired band scaled by +-f, sigmoid'
    reuses the window, sqrt' the stored distances.  Returns
    (dp (n, 3J), denc (R, nb*3J)): ``denc`` sums over the samples of
    each ray."""
    J = est.J
    dists, w, bands, invd = res
    F = len(est.kp_freqs)

    g_vraw = gv * w.repeat(1, 2 * F + 1)
    vraw = torch.cat([dists, bands], -1)
    g_w = _sum_blocks(gv * vraw, J, 2 * F + 1)
    g_dists = g_vraw[:, :J]
    g_bands = g_vraw[:, J:]

    pair_parts = []
    for m in range(F):
        pair_parts += [bands[:, (2 * m + 1) * J:(2 * m + 2) * J],
                       bands[:, (2 * m) * J:(2 * m + 1) * J]]
    paired = torch.cat(pair_parts, -1)
    k2 = torch.arange(2 * F * J, device=p.device) // J
    sfreq = torch.exp2((k2 // 2).float()) * (1. - 2. * (k2 % 2).float())
    g_dists = g_dists + _sum_blocks(g_bands * sfreq * paired, J, 2 * F)

    invd3 = invd.repeat(1, 3)
    if est.bone_windowed:
        w3 = w.repeat(1, 3)
        dp = gr * invd3 * w3
        g_w = g_w + _sum_blocks(gr * p * invd3, J, 3)
        g_invd = _sum_blocks(gr * p * w3, J, 3)
    else:
        dp = gr * invd3
        g_invd = _sum_blocks(gr * p, J, 3)
    g_dists = g_dists - g_invd * (invd * invd) * (dists > est.eps).float()

    nbJ3 = est.view_nb * 3 * J
    ray = torch.arange(p.shape[0], device=p.device) // est.S
    g_enc_flat = gxv * w.repeat(1, 3 * est.view_nb)
    R = enc_ray.shape[0]
    denc = g_enc_flat.reshape(R, est.S, nbJ3).sum(1)
    g_w = g_w + _sum_blocks(_sum_blocks(gxv * enc_ray[ray], 3 * J,
                                        est.view_nb), J, 3)

    sig = 1. - w
    g_dists = g_dists - g_w * (tau * sig * w)
    dp = dp + p * (g_dists * invd).repeat(1, 3)
    return dp, denc


def _bwd_nets_plain(st: MLPStatic, est: EncStatic, p, enc_ray, codes_list,
                    cutoff, tau, flats, gs):
    """Shared body of the backward twins: one encode, each net's MLP
    backward, the nets' input cotangents summed in f32, rounded through
    bf16, and pulled back once (``_bwd_kernel_dual`` :784-822)."""
    b16 = lambda a: a.to(torch.bfloat16).float()
    (v, r, xv), res = _encode_fwd_res(est, p, enc_ray, cutoff, tau)
    xs = [b16(v), b16(r)]
    ray = torch.arange(p.shape[0], device=p.device) // est.S
    R = enc_ray.shape[0]
    gx_tot = [torch.zeros_like(x) for x in xs]
    gxv_tot = torch.zeros_like(xv)
    dcodes, grads = [], []
    for codes, flat, g in zip(codes_list, flats, gs):
        xvs = [b16(xv)] + ([b16(codes[ray])] if est.has_codes else [])
        g_x, g_xvs, gr = _mlp_bwd_tile(st, xs, xvs, flat, g.t())
        gx_tot = [a + b for a, b in zip(gx_tot, g_x)]
        gxv_tot = gxv_tot + g_xvs[0]
        dcodes.append(g_xvs[1].reshape(R, est.S, -1).sum(1)
                      if est.has_codes else None)
        grads.append(gr)
    dp, denc = _encode_pullback_plain(est, p, enc_ray, res, tau,
                                      b16(gx_tot[0]), b16(gx_tot[1]),
                                      b16(gxv_tot))
    return dp, denc, dcodes, grads


def encmlp_bwd_plain(st: MLPStatic, est: EncStatic, p, enc_ray, codes,
                     cutoff, tau, flat, g):
    """Plain twin of K3: the backward of K1 for the raw cotangent ``g``
    (4, n).  Returns (dp (n, 3J), denc (R, nb*3J), dcodes (R, C) or
    None, grads): f32 gradients of every ``flatten_params_cm`` operand.
    Mirrors ``pallas_encmlp._bwd_kernel``."""
    dp, denc, dcodes, grads = _bwd_nets_plain(
        st, est, p, enc_ray, [codes], cutoff, tau, [flat], [g])
    return dp, denc, dcodes[0], grads[0]


def encmlp_dual_bwd_plain(st: MLPStatic, est: EncStatic, p, enc_ray,
                          codes_c, codes_f, cutoff, tau, flat_c, flat_f,
                          g_c, g_f):
    """Plain twin of K4: the backward of K2.  Returns (dp, denc,
    dcodes_c, dcodes_f, grads_c, grads_f).  Mirrors
    ``pallas_encmlp._bwd_kernel_dual``."""
    dp, denc, dcodes, grads = _bwd_nets_plain(
        st, est, p, enc_ray, [codes_c, codes_f], cutoff, tau,
        [flat_c, flat_f], [g_c, g_f])
    return dp, denc, dcodes[0], dcodes[1], grads[0], grads[1]


def encmlp_fwd_plain(st: MLPStatic, est: EncStatic, p, enc_ray, codes,
                     cutoff, tau, flat) -> torch.Tensor:
    """Plain twin of K1: raw (4, n) rows [r, g, b, sigma]."""
    v, r, xv = _encode_plain(est, p, enc_ray, cutoff, tau)
    xvs = [xv]
    if est.has_codes:
        ray = torch.arange(p.shape[0], device=p.device) // est.S
        xvs.append(codes[ray])
    _, _, _, rgb, alpha = _forward_tile(st, [v, r], xvs, flat)
    return torch.cat([rgb, alpha], -1).T.contiguous()


def encmlp_dual_fwd_plain(st: MLPStatic, est: EncStatic, p, enc_ray,
                          codes_c, codes_f, cutoff, tau, flat_c, flat_f
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K2: the encode once, both nets on it."""
    v, r, xv = _encode_plain(est, p, enc_ray, cutoff, tau)
    ray = torch.arange(p.shape[0], device=p.device) // est.S
    outs = []
    for codes, flat in ((codes_c, flat_c), (codes_f, flat_f)):
        xvs = [xv] + ([codes[ray]] if est.has_codes else [])
        _, _, _, rgb, alpha = _forward_tile(st, [v, r], xvs, flat)
        outs.append(torch.cat([rgb, alpha], -1).T.contiguous())
    return outs[0], outs[1]


# ---------------------------------------------------------------------------
# CUDA kernels: build, weight packing, wrappers, autograd, launch counts
# ---------------------------------------------------------------------------

K1_LAUNCHES = 0
K2_LAUNCHES = 0
K3_LAUNCHES = 0
K4_LAUNCHES = 0

# the one shape the kernels are compiled for (csrc/encmlp_common.cuh):
# J=24 joints, kp PE 2^0..2^6, view PE 4 bands, 8x256 trunk with the
# skip after layer 4, views branch 128, framecodes of 16 (or none)
_KERNEL_SHAPE = dict(J=24, F=7, view_nb=9, depth=8, width=256, half=128,
                     skips=(4,), codes=16)


def reset_launch_counts() -> None:
    """Zero the launch counts of all six kernels (K5/K6 live in
    ``fused_mlp``)."""
    global K1_LAUNCHES, K2_LAUNCHES, K3_LAUNCHES, K4_LAUNCHES
    K1_LAUNCHES = K2_LAUNCHES = K3_LAUNCHES = K4_LAUNCHES = 0
    fused_mlp.reset_launch_counts()


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel since the last reset: K1-K4 here, K5/K6
    (``mlp_fwd``, ``mlp_bwd``) from ``fused_mlp.launch_counts``."""
    return {'encmlp_fwd': K1_LAUNCHES, 'encmlp_dual_fwd': K2_LAUNCHES,
            'encmlp_bwd': K3_LAUNCHES, 'encmlp_dual_bwd': K4_LAUNCHES,
            **fused_mlp.launch_counts()}


def _check_kernel_shape(st: MLPStatic, est: EncStatic) -> None:
    k = _KERNEL_SHAPE
    got = dict(J=est.J, F=len(est.kp_freqs), view_nb=est.view_nb,
               depth=st.depth, width=st.width, half=st.half,
               skips=tuple(st.skips),
               codes=st.vparts[1] if est.has_codes else k['codes'])
    if (got != k or not _doubling_freqs(est.kp_freqs)
            or est.bone_windowed or st.dparts != (k['J'] * (2 * k['F'] + 1),
                                                  3 * k['J'])):
        raise NotImplementedError(
            f'the fused CUDA kernels are built for {k}, got {got}; other '
            'shapes are not ported yet (ROADMAP.md)')


def _check_inputs(p, enc_ray, cutoff, tau, codes_list, est):
    dev = p.device
    n = p.shape[0]
    if p.dim() != 2 or p.shape[1] != 3 * est.J:
        raise ValueError(f'pts_t must be (n, {3 * est.J}), '
                         f'got {tuple(p.shape)}')
    if n % est.S != 0:
        raise ValueError(f'n={n} is not a multiple of S={est.S}')
    R = n // est.S
    if tuple(enc_ray.shape) != (R, est.view_nb * 3 * est.J):
        raise ValueError(f'enc_ray must be ({R}, {est.view_nb * 3 * est.J}),'
                         f' got {tuple(enc_ray.shape)}')
    for t in [p, enc_ray, cutoff, tau] + [c for c in codes_list
                                           if c is not None]:
        if t.device != dev:
            raise ValueError('all kernel inputs must be on one device')
        if t.dtype != torch.float32:
            raise TypeError(f'kernel inputs must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError('kernel inputs must be contiguous')
    if cutoff.numel() != est.J or tau.numel() != 1:
        raise ValueError('cutoff must hold J values and tau one')
    for c in codes_list:
        if est.has_codes and (c is None or c.shape[0] != R):
            raise ValueError('codes must be (R, framecode_ch)')
    return n, R


def _check_packs(lib, nnet, wbuf, bbuf) -> None:
    if (wbuf.numel() != nnet * lib.encmlp_weight_elems()
            or bbuf.numel() != nnet * lib.encmlp_bias_elems()):
        raise ValueError('packed weights do not match the kernel layout')


def _launch(name: str, nnet: int, p, enc_ray, codes, cutoff, tau, wbuf,
            bbuf, out, n: int, S: int, R: int) -> None:
    lib = cuda_build.library('fwd')
    _check_packs(lib, nnet, wbuf, bbuf)
    with torch.cuda.device(p.device):
        err = getattr(lib, name)(
            p.data_ptr(), enc_ray.data_ptr(), codes.data_ptr(),
            cutoff.data_ptr(), tau.data_ptr(), wbuf.data_ptr(),
            bbuf.data_ptr(), out.data_ptr(), n, S, R, cuda_build.stream(p.device))
    if err != 0:
        raise RuntimeError(f'{name} launch failed: cudaError {err}')


def _codes_operand(codes_list, est, R, device):
    """(nnet, R, 16) f32 codes for the kernel (zeros without codes)."""
    if est.has_codes:
        return torch.stack(codes_list).contiguous()
    return torch.zeros((len(codes_list), R, _KERNEL_SHAPE['codes']),
                       dtype=torch.float32, device=device)


def _fwd(st, est, p, enc_ray, codes, cutoff, tau, flat) -> torch.Tensor:
    """K1 or its twin, no autograd."""
    global K1_LAUNCHES
    n, R = _check_inputs(p, enc_ray, cutoff, tau, [codes], est)
    if cuda_build.device_of(p) == 'cpu':
        return encmlp_fwd_plain(st, est, p, enc_ray, codes, cutoff, tau, flat)
    _check_kernel_shape(st, est)
    wbuf, bbuf = _pack_kernel_weights(flat, st)
    out = torch.empty((4, n), dtype=torch.float32, device=p.device)
    _launch('encmlp_fwd', 1, p, enc_ray,
            _codes_operand([codes], est, R, p.device), cutoff, tau, wbuf,
            bbuf, out, n, est.S, R)
    K1_LAUNCHES += 1
    return out


def _dual_fwd(st, est, p, enc_ray, codes_c, codes_f, cutoff, tau, flat_c,
              flat_f) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 or its twin, no autograd."""
    global K2_LAUNCHES
    n, R = _check_inputs(p, enc_ray, cutoff, tau, [codes_c, codes_f], est)
    if cuda_build.device_of(p) == 'cpu':
        return encmlp_dual_fwd_plain(st, est, p, enc_ray, codes_c, codes_f,
                                     cutoff, tau, flat_c, flat_f)
    _check_kernel_shape(st, est)
    wc, bc = _pack_kernel_weights(flat_c, st)
    wf, bf = _pack_kernel_weights(flat_f, st)
    out = torch.empty((2, 4, n), dtype=torch.float32, device=p.device)
    _launch('encmlp_dual_fwd', 2, p, enc_ray,
            _codes_operand([codes_c, codes_f], est, R, p.device), cutoff,
            tau, torch.cat([wc, wf]), torch.cat([bc, bf]), out, n, est.S, R)
    K2_LAUNCHES += 1
    return out[0], out[1]


# -- backward ---------------------------------------------------------------

def _launch_bwd(name: str, nnet: int, st, est, p, enc_ray, codes_list,
                cutoff, tau, flats, gs):
    """Launch K3 (nnet=1) or K4 (nnet=2).  Returns (dp, denc, dcodes
    (nnet, R, 16), grads per net)."""
    _check_kernel_shape(st, est)
    n, R = p.shape[0], enc_ray.shape[0]
    dev = p.device
    fwd_lib, lib = cuda_build.library('fwd'), cuda_build.library('bwd')
    packs = [_pack_kernel_weights(f, st) for f in flats]
    wbuf = torch.cat([w for w, _ in packs])
    bbuf = torch.cat([b for _, b in packs])
    _check_packs(fwd_lib, nnet, wbuf, bbuf)
    wbuf_b = torch.cat([_pack_bwd_weights(f, st) for f in flats])
    n_dw = lib.encmlp_grad_weight_elems()
    if wbuf_b.numel() != nnet * n_dw:
        raise ValueError('backward weight pack does not match the kernel')
    g = torch.stack([x.float() for x in gs]).contiguous()
    if tuple(g.shape) != (nnet, 4, n):
        raise ValueError(f'raw cotangents must be ({nnet}, 4, {n})')
    f32 = dict(dtype=torch.float32, device=dev)
    ws = torch.empty(int(lib.encmlp_bwd_workspace_bytes(n, nnet)),
                     dtype=torch.uint8, device=dev)
    dp = torch.empty((n, 3 * est.J), **f32)
    denc = torch.empty(tuple(enc_ray.shape), **f32)
    dcodes = torch.empty((nnet, R, _KERNEL_SHAPE['codes']), **f32)
    dw = torch.empty((nnet, n_dw), **f32)
    db = torch.empty((nnet, fwd_lib.encmlp_bias_elems()), **f32)
    codes = _codes_operand(codes_list, est, R, dev)
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            p.data_ptr(), enc_ray.data_ptr(), codes.data_ptr(),
            cutoff.data_ptr(), tau.data_ptr(), wbuf.data_ptr(),
            wbuf_b.data_ptr(), bbuf.data_ptr(), g.data_ptr(), ws.data_ptr(),
            dp.data_ptr(), denc.data_ptr(), dcodes.data_ptr(),
            dw.data_ptr(), db.data_ptr(), n, est.S, R, cuda_build.stream(dev))
    if err != 0:
        raise RuntimeError(f'{name} launch failed: cudaError {err}')
    grads = [_unpack_grads(st, dw[i], db[i]) for i in range(nnet)]
    return dp, denc, dcodes, grads


def encmlp_bwd(st: MLPStatic, est: EncStatic, p, enc_ray, codes, cutoff,
               tau, flat, g):
    """K3: the backward of K1 for the raw cotangent ``g`` (4, n).
    Returns (dp (n, 3J), denc (R, nb*3J), dcodes (R, C) or None, f32
    gradients of the ``flatten_params_cm`` operands).  CPU tensors take
    the twin; CUDA tensors launch the kernel or raise."""
    global K3_LAUNCHES
    _check_inputs(p, enc_ray, cutoff, tau, [codes], est)
    if cuda_build.device_of(p) == 'cpu':
        return encmlp_bwd_plain(st, est, p, enc_ray, codes, cutoff, tau,
                                flat, g)
    dp, denc, dcodes, grads = _launch_bwd('encmlp_bwd', 1, st, est, p,
                                          enc_ray, [codes], cutoff, tau,
                                          [flat], [g])
    K3_LAUNCHES += 1
    return dp, denc, dcodes[0] if est.has_codes else None, grads[0]


def encmlp_dual_bwd(st: MLPStatic, est: EncStatic, p, enc_ray, codes_c,
                    codes_f, cutoff, tau, flat_c, flat_f, g_c, g_f):
    """K4: the backward of K2.  Returns (dp, denc, dcodes_c, dcodes_f,
    grads_c, grads_f)."""
    global K4_LAUNCHES
    _check_inputs(p, enc_ray, cutoff, tau, [codes_c, codes_f], est)
    if cuda_build.device_of(p) == 'cpu':
        return encmlp_dual_bwd_plain(st, est, p, enc_ray, codes_c, codes_f,
                                     cutoff, tau, flat_c, flat_f, g_c, g_f)
    dp, denc, dcodes, grads = _launch_bwd(
        'encmlp_dual_bwd', 2, st, est, p, enc_ray, [codes_c, codes_f],
        cutoff, tau, [flat_c, flat_f], [g_c, g_f])
    K4_LAUNCHES += 1
    dc = (dcodes[0], dcodes[1]) if est.has_codes else (None, None)
    return dp, denc, dc[0], dc[1], grads[0], grads[1]


# -- autograd ---------------------------------------------------------------

def _cast_grads(grads, flat):
    """Each gradient in its operand's dtype: bf16 for weights, f32 for
    biases (``gr.astype(d)``, pallas_encmlp.py:681,937-940)."""
    return [gr.to(w.dtype) for gr, w in zip(grads, flat)]


class _EncMLP(torch.autograd.Function):
    """K1 forward, K3 backward (``pallas_encmlp._fused`` custom_vjp).
    ``cutoff`` and ``tau`` get no gradient, as in JAX."""

    @staticmethod
    def forward(ctx, st, est, p, enc_ray, codes, cutoff, tau, *flat):
        ctx.st, ctx.est, ctx.has_codes = st, est, codes is not None
        ctx.save_for_backward(p, enc_ray, cutoff, tau,
                              *([codes] if codes is not None else []), *flat)
        return _fwd(st, est, p, enc_ray, codes, cutoff, tau, flat)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        p, enc_ray, cutoff, tau = saved[:4]
        codes = saved[4] if ctx.has_codes else None
        flat = saved[5 if ctx.has_codes else 4:]
        dp, denc, dcodes, grads = encmlp_bwd(ctx.st, ctx.est, p, enc_ray,
                                             codes, cutoff, tau, flat, g)
        return (None, None, dp, denc, dcodes, None, None,
                *_cast_grads(grads, flat))


class _EncMLPDual(torch.autograd.Function):
    """K2 forward, K4 backward (``pallas_encmlp._fused_dual``)."""

    @staticmethod
    def forward(ctx, st, est, nflat, p, enc_ray, codes_c, codes_f, cutoff,
                tau, *flats):
        ctx.st, ctx.est, ctx.nflat = st, est, nflat
        ctx.has_codes = codes_c is not None
        codes = [codes_c, codes_f] if ctx.has_codes else []
        ctx.save_for_backward(p, enc_ray, cutoff, tau, *codes, *flats)
        return _dual_fwd(st, est, p, enc_ray, codes_c, codes_f, cutoff, tau,
                         flats[:nflat], flats[nflat:])

    @staticmethod
    def backward(ctx, g_c, g_f):
        saved = ctx.saved_tensors
        p, enc_ray, cutoff, tau = saved[:4]
        k = 6 if ctx.has_codes else 4
        codes_c, codes_f = saved[4:6] if ctx.has_codes else (None, None)
        flat_c, flat_f = saved[k:k + ctx.nflat], saved[k + ctx.nflat:]
        dp, denc, dc_c, dc_f, gr_c, gr_f = encmlp_dual_bwd(
            ctx.st, ctx.est, p, enc_ray, codes_c, codes_f, cutoff, tau,
            flat_c, flat_f, g_c, g_f)
        return (None, None, None, dp, denc, dc_c, dc_f, None, None,
                *_cast_grads(gr_c, flat_c), *_cast_grads(gr_f, flat_f))


def encmlp_fwd(st: MLPStatic, est: EncStatic, p: torch.Tensor,
               enc_ray: torch.Tensor, codes: Optional[torch.Tensor],
               cutoff: torch.Tensor, tau: torch.Tensor,
               flat: Sequence[torch.Tensor]) -> torch.Tensor:
    """K1: fused encode + one net.  p (n, 3J) component-major f32,
    enc_ray (R, nb*3J), codes (R, C) or None, cutoff (J,), tau (1,),
    flat the ``flatten_params_cm`` operands.  Returns raw (4, n), with
    K3 as its backward on every device."""
    return _EncMLP.apply(st, est, p, enc_ray, codes, cutoff, tau, *flat)


def encmlp_dual_fwd(st: MLPStatic, est: EncStatic, p: torch.Tensor,
                    enc_ray: torch.Tensor, codes_c: Optional[torch.Tensor],
                    codes_f: Optional[torch.Tensor], cutoff: torch.Tensor,
                    tau: torch.Tensor, flat_c: Sequence[torch.Tensor],
                    flat_f: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: fused encode once + the coarse and the fine net.  Returns
    (raw_coarse, raw_fine), each (4, n), with K4 as their backward."""
    return _EncMLPDual.apply(st, est, len(flat_c), p, enc_ray, codes_c,
                             codes_f, cutoff, tau, *flat_c, *flat_f)


def kernel_cost(st: MLPStatic, est: EncStatic, n: int, nnet: int,
                backward: bool = False) -> Dict[str, float]:
    """Work of one launch, counted from the shapes: bf16 tensor-core
    FLOPs of the MLPs, f32 FLOPs of the encode, and the bytes that must
    move (each input read once, each output written once).

    ``backward``: K3/K4, which recompute the forward and form the input
    cotangents and the weight gradients (3x the forward's MLP FLOPs, as
    pallas_encmlp.py:666,917 counts them) and pull back through the
    encode; their bytes add the incoming g, dp, denc, dcodes and the f32
    weight gradients."""
    J, F, nb = est.J, len(est.kp_freqs), est.view_nb
    R = n // est.S
    # per point and joint: distance 6, window 6, first sin/cos 3, each
    # further octave 5, v scaling 2F+1, bone dir 5, view rows 3*nb
    enc = n * J * (6 + 6 + 3 + 5 * (F - 1) + (2 * F + 1) + 5 + 3 * nb)
    wshapes = _weight_shapes(st)
    wbytes = sum(int(np.prod(s)) * (2 if d == torch.bfloat16 else 4)
                 for s, d in wshapes)
    codes = st.vparts[1] if est.has_codes else 0
    nbytes = (n * 3 * J * 4 + R * nb * 3 * J * 4 + nnet * R * codes * 4
              + nnet * wbytes + nnet * 4 * n * 4 + (J + 1) * 4)
    flops = 2. * _mlp_macs(st) * n * nnet
    if backward:
        flops *= 3
        # pullback per point and joint: 2F+1 window products and sums,
        # 2F paired-band terms (3 each), bone dir 7, view rows 4*nb
        # (window and g_w), window and sqrt' 8
        enc += n * J * (3 * (2 * F + 1) + 3 * 2 * F + 7 + 4 * 3 * nb + 8)
        gvals = sum(int(np.prod(s)) for s, _ in wshapes)
        nbytes += (n * 3 * J * 4 + R * nb * 3 * J * 4
                   + nnet * R * codes * 4 + nnet * gvals * 4)
    return {'bf16_flops': flops, 'f32_flops': float(enc),
            'bytes': float(nbytes)}


# ---------------------------------------------------------------------------
# Operand preparation (shared by both kernels and their twins)
# ---------------------------------------------------------------------------

def flatten_params_cm(net_params: Dict[str, Any], st: MLPStatic,
                      J: int, view_nb: int) -> List[torch.Tensor]:
    """``flatten_params`` with the bone/view weight rows permuted to the
    kernels' component-major feature order."""
    perm_r, perm_view = _perm_tensors(
        J, view_nb, net_params['pts_linears'][0]['w'].device)
    dv = st.dparts[0]

    def perm_x(w):
        """Permute the r-part rows of an x-consuming trunk weight."""
        return torch.cat([w[:dv], w[dv:][perm_r]], 0)
    p = dict(net_params)
    pts = []
    for i, lin in enumerate(net_params['pts_linears']):
        w = lin['w']
        if i == 0:
            w = perm_x(w)
        elif st.has_x_part(i):
            w = torch.cat([perm_x(w[:st.dnet]), w[st.dnet:]], 0)
        pts.append({'w': w, 'b': lin['b']})
    p['pts_linears'] = pts
    wv = net_params['views_linear']['w']
    W = st.width
    wv_x = wv[W:W + view_nb * 3 * J][perm_view]
    p['views_linear'] = {
        'w': torch.cat([wv[:W], wv_x, wv[W + view_nb * 3 * J:]], 0),
        'b': net_params['views_linear']['b']}
    return _flatten_plain(p, st)


def supported_config(rc) -> bool:
    """Whether the fused encode kernels cover this raycast config."""
    ke, be, ve = rc.kp_embed, rc.bone_embed, rc.view_embed
    return (rc.kp_dist_type == 'reldist' and rc.bone_type == 'reldir'
            and rc.view_type == 'relray' and rc.use_viewdirs
            and not rc.opt_cutoff
            and not (ke.normalize or be.normalize or ve.normalize)
            and ke.cutoff and ke.cutoff_inputs and ke.include_input
            and not ke.cut_to_cutoff and not ke.shift_inputs
            and not ke.freq_schedule and ke.num_freqs > 0
            and ke.log_sampling  # in-kernel bands assume 2^k freqs
            and be.include_input and be.num_freqs == 0
            and not be.freq_schedule
            and (not be.cutoff or be.cutoff_inputs)
            and ve.cutoff and ve.cutoff_inputs and ve.include_input
            and not ve.freq_schedule
            and rc.nerf.width % 256 == 0)


def view_pe_rows(rays_t_norm: torch.Tensor, freq_bands: Sequence[float],
                 J: int) -> torch.Tensor:
    """Per-ray view PE rows [x, sin f0 x, cos f0 x, ...] in the kernels'
    component-major order: (R, (1+2F) * 3J)."""
    x = rays_t_norm
    rows = [x]
    for f in freq_bands:
        rows.append(torch.sin(x * f))
        rows.append(torch.cos(x * f))
    enc = torch.cat(rows, -1)
    return enc[..., _perm_tensors(J, len(rows), enc.device)[1]]


# point tile the viewfac cost gate prices, as in anerf_tpu (the TPU
# kernels' grid step; the CUDA kernels tile by 64 points instead)
DEFAULT_TILE = 512


def _build_call(rc, pts_t, rays_t_norm, cutoff_dist, tau, cam_idxs,
                tile, enc_ray=None):
    """Statics + kernel operands from component-major ``pts_t``
    (R, S, 3J).  Returns (st, est, p, enc_ray, cutoff (J,), tau (1,)).

    The tile arithmetic and the viewfac cost gate are those of
    ``pallas_encmlp._build_call``; unlike the TPU kernels the CUDA
    kernels mask their ragged edge, so every (R, S) is taken.
    """
    if tile is None:
        tile = DEFAULT_TILE
    R, S, K = pts_t.shape
    J = K // 3
    n = R * S
    while tile > 128 and (n < tile or tile % S != 0 or
                          R % (tile // S) != 0):
        tile //= 2
    rpt = max(tile // S, 1)

    nerf = rc.nerf
    has_codes = nerf.use_framecode and cam_idxs is not None
    st = MLPStatic(
        depth=nerf.depth, width=nerf.width,
        dparts=((1 + 2 * rc.kp_embed.num_freqs) * J, 3 * J),
        vparts=(((1 + 2 * rc.view_embed.num_freqs) * 3 * J,)
                + ((nerf.framecode_ch,) if has_codes else ())),
        half=nerf.width // 2, skips=tuple(nerf.skips), tile=tile)
    est = EncStatic(J=J, kp_freqs=tuple(float(f) for f in
                                        rc.kp_embed.freq_bands()),
                    view_nb=1 + 2 * rc.view_embed.num_freqs,
                    S=S, rpt=rpt, has_codes=has_codes,
                    bone_windowed=rc.bone_embed.cutoff,
                    viewfac=getattr(rc, 'viewfac', False))
    if est.viewfac:
        # the factorized forward costs rptJ*nblkJ + T*rptJ MACs per
        # half-column against T*nblkJ dense: it wins only when
        # J*(nblkJ + tile) < 0.9*S*nblkJ (pallas_encmlp.py:1116-1133)
        nblkJ = est.view_nb * 3 * J
        if J * (nblkJ + tile) >= 0.9 * S * nblkJ:
            est = dataclasses.replace(est, viewfac=False)

    p = pts_t.reshape(n, 3 * J).float().contiguous()
    if enc_ray is None:
        enc_ray = view_pe_rows(
            rays_t_norm, [float(f) for f in rc.view_embed.freq_bands()], J)
    enc_ray = enc_ray.float().contiguous()
    cutoff = torch.as_tensor(cutoff_dist, dtype=torch.float32,
                             device=p.device).reshape(J).contiguous()
    tau_t = torch.as_tensor(tau, dtype=torch.float32,
                            device=p.device).reshape(1).contiguous()
    return st, est, p, enc_ray, cutoff, tau_t


def _codes(net_params, cam_idxs) -> torch.Tensor:
    from ..models.nerf_mlp import framecode_select
    return framecode_select(net_params['framecodes'],
                            cam_idxs).float().contiguous()


def nerf_encmlp(net_params: Dict[str, Any], rc, pts_t: torch.Tensor,
                rays_t_norm: torch.Tensor, cutoff_dist, tau,
                cam_idxs: Optional[torch.Tensor] = None,
                tile: Optional[int] = None,
                enc_ray: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused encode+MLP for one network pass (K1).

    pts_t: (R, S, 3J) component-major skeleton-relative points;
    rays_t_norm: (R, 3J) normalized per-joint local ray directions;
    cutoff_dist: (J,); tau: scalar; cam_idxs: (R,) framecode indices or
    None; enc_ray: optionally the precomputed ``view_pe_rows``.
    Returns channel-major raw (4, R, S).
    """
    R, S = pts_t.shape[:2]
    st, est, p, enc_ray, cutoff, tau_t = _build_call(
        rc, pts_t, rays_t_norm, cutoff_dist, tau, cam_idxs, tile, enc_ray)
    codes = _codes(net_params, cam_idxs) if est.has_codes else None
    flat = flatten_params_cm(net_params, st, est.J, est.view_nb)
    raw = encmlp_fwd(st, est, p, enc_ray, codes, cutoff, tau_t, flat)
    return raw.reshape(4, R, S)


def nerf_encmlp_dual(coarse_params: Dict[str, Any],
                     fine_params: Dict[str, Any], rc,
                     pts_t: torch.Tensor, rays_t_norm: torch.Tensor,
                     cutoff_dist, tau,
                     cam_idxs: Optional[torch.Tensor] = None,
                     tile: Optional[int] = None,
                     enc_ray: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused encode once + BOTH MLPs on the same points (K2).  The
    reference runs the coarse and the fine net on the same stratified
    samples (core/raycasters.py:438,456-461).  Returns (raw_coarse,
    raw_fine), each (4, R, S)."""
    R, S = pts_t.shape[:2]
    st, est, p, enc_ray, cutoff, tau_t = _build_call(
        rc, pts_t, rays_t_norm, cutoff_dist, tau, cam_idxs, tile, enc_ray)
    if est.has_codes:
        codes_c = _codes(coarse_params, cam_idxs)
        codes_f = _codes(fine_params, cam_idxs)
    else:
        codes_c = codes_f = None
    flat_c = flatten_params_cm(coarse_params, st, est.J, est.view_nb)
    flat_f = flatten_params_cm(fine_params, st, est.J, est.view_nb)
    raw_c, raw_f = encmlp_dual_fwd(st, est, p, enc_ray, codes_c, codes_f,
                                   cutoff, tau_t, flat_c, flat_f)
    return raw_c.reshape(4, R, S), raw_f.reshape(4, R, S)
