"""Fused encode+MLP forward: skeleton-relative points in, raw radiance out.

Port of the forward half of ``anerf_tpu/ops/pallas_encmlp.py``.  For
the flagship encoding family (kp 'reldist' + bone 'reldir' + view
'relray', cutoff windows on all three) the encoded features are a pure
elementwise function of the component-major points ``pts_t`` plus a
small per-ray view PE, so the kernels compute distances, windows,
positional encodings AND the whole radiance MLP per point tile: device
memory sees ``pts_t`` (72 channels) in and raw (4 channels) out.

Two hand-written CUDA kernels (``csrc/encmlp_fwd.cu``) replace the two
Pallas forwards of the render path:

  * K1 ``encmlp_fwd``      <- pallas_encmlp.py ``_fused_call`` /
    ``_fwd_kernel`` (one net; the fine pass on the importance samples);
  * K2 ``encmlp_dual_fwd`` <- pallas_encmlp.py ``_fused_dual_call`` /
    ``_fwd_kernel_dual`` (encode once, coarse AND fine nets; the coarse
    samples).

Bound on an H100: each point costs 2 x 863,872 MACs per net against
~300 bytes of device traffic, so both kernels are bound by tensor-core
operations (the eval K2 chunk: 9.06e11 FLOP, 0.92 ms at 989 TFLOP/s
bf16, against 95 MB = 0.03 ms of HBM).  The design keeps every
encoding in shared memory (they never touch device memory), runs each
product on the tensor cores with ``mma.sync`` bf16 operands and f32
accumulators, and streams each layer's weights from L2, where one
net's 1.7 MB weight set stays resident because every block reads it.
Its first-order cost is that re-read: each 64-point tile reads every
weight once, ~14 GB of L2 traffic per eval K2 launch (PERF.md).

Beside each kernel is its plain PyTorch twin (``encmlp_fwd_plain`` /
``encmlp_dual_fwd_plain``), which materializes the encodings and runs
the same bf16 chain as exact bf16 products summed in f32.  The
wrappers take the twin for tensors on the CPU only; for CUDA tensors
they launch the kernel or raise.  Each wrapper counts its launches in a
module integer (``K1_LAUNCHES``, ``K2_LAUNCHES``).

The PE bands use the double-angle recurrence from one sin and one
cos-as-shifted-sin per joint, as the TPU kernels do (pallas_encmlp.py
``SIN_RECURRENCE``), in the twin and in the CUDA kernels alike.

Not ported yet (ROADMAP.md): the training stash and the backward
kernels, the per-ray view factorization mode (``viewfac``; its cost
gate is computed here but the port always runs the dense form, which
is the same function up to bf16 rounding) and the in-kernel rigid
transform (``fuse_tform``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .fused_mlp import MLPStatic, _forward_tile, _mlp_macs, _weight_shapes
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
    for the stream to drain, so per-chunk copies would idle the GPU."""
    blocks = np.concatenate([b * 3 * J + _comp_major_perm(J)
                             for b in range(nb)])
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
    values the CUDA kernels build in shared memory.

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
    return v, r, xv


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
# CUDA kernels: build, weight packing, wrappers, launch counts
# ---------------------------------------------------------------------------

K1_LAUNCHES = 0
K2_LAUNCHES = 0

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', 'csrc',
                    'encmlp_fwd.cu')
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                          '_build')
_LIB: Optional[ctypes.CDLL] = None

# the one shape the kernels are compiled for (csrc/encmlp_fwd.cu):
# J=24 joints, kp PE 2^0..2^6, view PE 4 bands, 8x256 trunk with the
# skip after layer 4, views branch 128, framecodes of 16 (or none)
_KERNEL_SHAPE = dict(J=24, F=7, view_nb=9, depth=8, width=256, half=128,
                     skips=(4,), codes=16)
_XV_PAD = 672       # views input [xv 648 | codes 16 | 0 x 8], 42 x 16


def reset_launch_counts() -> None:
    global K1_LAUNCHES, K2_LAUNCHES
    K1_LAUNCHES = K2_LAUNCHES = 0


def launch_counts() -> Dict[str, int]:
    return {'encmlp_fwd': K1_LAUNCHES, 'encmlp_dual_fwd': K2_LAUNCHES}


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the fused kernels build on a '
                       'machine with the CUDA toolkit')


def build_kernels(verbose: bool = False) -> float:
    """Compile ``csrc/encmlp_fwd.cu`` for sm_90a into ``_build/`` (keyed
    by the source's hash) and load it.  Returns the seconds spent
    (0 when the library was already loaded)."""
    global _LIB
    if _LIB is not None:
        return 0.
    t0 = time.perf_counter()
    with open(_SRC, 'rb') as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so = os.path.join(_BUILD_DIR, f'libencmlp_{digest}.so')
    if not os.path.exists(so):
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
               '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
               '-o', tmp, _SRC]
        if verbose:
            cmd[1:1] = ['-Xptxas', '-v']
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f'nvcc failed ({res.returncode}):\n'
                               f'{res.stdout}\n{res.stderr}')
        if verbose:
            print(res.stdout + res.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ('encmlp_fwd', 'encmlp_dual_fwd'):
        fn = getattr(lib, name)
        # p, enc_ray, codes, cutoff, tau, wpack, bpack, out, n, S, R, stream
        fn.argtypes = [vp] * 8 + [ci] * 3 + [vp]
        fn.restype = ci
    lib.encmlp_weight_elems.argtypes = []
    lib.encmlp_weight_elems.restype = ctypes.c_longlong
    lib.encmlp_bias_elems.argtypes = []
    lib.encmlp_bias_elems.restype = ci
    _LIB = lib
    return time.perf_counter() - t0


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


def _pack_kernel_weights(flat: Sequence[torch.Tensor], st: MLPStatic
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flatten_params_cm`` operands -> the kernels' two buffers.

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


def _launch(name: str, nnet: int, p, enc_ray, codes, cutoff, tau, wbuf,
            bbuf, out, n: int, S: int, R: int) -> None:
    build_kernels()
    if (wbuf.numel() != nnet * _LIB.encmlp_weight_elems()
            or bbuf.numel() != nnet * _LIB.encmlp_bias_elems()):
        raise ValueError('packed weights do not match the kernel layout')
    fn = getattr(_LIB, name)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), enc_ray.data_ptr(), codes.data_ptr(),
                 cutoff.data_ptr(), tau.data_ptr(), wbuf.data_ptr(),
                 bbuf.data_ptr(), out.data_ptr(), n, S, R, stream)
    if err != 0:
        raise RuntimeError(f'{name} launch failed: cudaError {err}')


def _codes_operand(codes_list, est, R, device):
    """(nnet, R, 16) f32 codes for the kernel (zeros without codes)."""
    if est.has_codes:
        return torch.stack(codes_list).contiguous()
    return torch.zeros((len(codes_list), R, _KERNEL_SHAPE['codes']),
                       dtype=torch.float32, device=device)


def encmlp_fwd(st: MLPStatic, est: EncStatic, p: torch.Tensor,
               enc_ray: torch.Tensor, codes: Optional[torch.Tensor],
               cutoff: torch.Tensor, tau: torch.Tensor,
               flat: Sequence[torch.Tensor]) -> torch.Tensor:
    """K1: fused encode + one net.  p (n, 3J) component-major f32,
    enc_ray (R, nb*3J), codes (R, C) or None, cutoff (J,), tau (1,),
    flat the ``flatten_params_cm`` operands.  Returns raw (4, n)."""
    global K1_LAUNCHES
    n, R = _check_inputs(p, enc_ray, cutoff, tau, [codes], est)
    if p.device.type == 'cpu':
        return encmlp_fwd_plain(st, est, p, enc_ray, codes, cutoff, tau, flat)
    if p.device.type != 'cuda':
        raise ValueError(f'unsupported device {p.device}')
    _check_kernel_shape(st, est)
    wbuf, bbuf = _pack_kernel_weights(flat, st)
    out = torch.empty((4, n), dtype=torch.float32, device=p.device)
    _launch('encmlp_fwd', 1, p, enc_ray,
            _codes_operand([codes], est, R, p.device), cutoff, tau, wbuf,
            bbuf, out, n, est.S, R)
    K1_LAUNCHES += 1
    return out


def encmlp_dual_fwd(st: MLPStatic, est: EncStatic, p: torch.Tensor,
                    enc_ray: torch.Tensor, codes_c: Optional[torch.Tensor],
                    codes_f: Optional[torch.Tensor], cutoff: torch.Tensor,
                    tau: torch.Tensor, flat_c: Sequence[torch.Tensor],
                    flat_f: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: fused encode once + the coarse and the fine net.  Returns
    (raw_coarse, raw_fine), each (4, n)."""
    global K2_LAUNCHES
    n, R = _check_inputs(p, enc_ray, cutoff, tau, [codes_c, codes_f], est)
    if p.device.type == 'cpu':
        return encmlp_dual_fwd_plain(st, est, p, enc_ray, codes_c, codes_f,
                                     cutoff, tau, flat_c, flat_f)
    if p.device.type != 'cuda':
        raise ValueError(f'unsupported device {p.device}')
    _check_kernel_shape(st, est)
    wc, bc = _pack_kernel_weights(flat_c, st)
    wf, bf = _pack_kernel_weights(flat_f, st)
    out = torch.empty((2, 4, n), dtype=torch.float32, device=p.device)
    _launch('encmlp_dual_fwd', 2, p, enc_ray,
            _codes_operand([codes_c, codes_f], est, R, p.device), cutoff,
            tau, torch.cat([wc, wf]), torch.cat([bc, bf]), out, n, est.S, R)
    K2_LAUNCHES += 1
    return out[0], out[1]


def kernel_cost(st: MLPStatic, est: EncStatic, n: int, nnet: int
                ) -> Dict[str, float]:
    """Work of one launch, counted from the shapes: bf16 tensor-core
    FLOPs of the MLPs, f32 FLOPs of the encode, and the bytes that must
    move (each input read once, each output written once)."""
    J, F, nb = est.J, len(est.kp_freqs), est.view_nb
    R = n // est.S
    # per point and joint: distance 6, window 6, first sin/cos 3, each
    # further octave 5, v scaling 2F+1, bone dir 5, view rows 3*nb
    enc = n * J * (6 + 6 + 3 + 5 * (F - 1) + (2 * F + 1) + 5 + 3 * nb)
    wbytes = sum(int(np.prod(s)) * (2 if d == torch.bfloat16 else 4)
                 for s, d in _weight_shapes(st))
    codes = st.vparts[1] if est.has_codes else 0
    nbytes = (n * 3 * J * 4 + R * nb * 3 * J * 4 + nnet * R * codes * 4
              + nnet * wbytes + nnet * 4 * n * 4 + (J + 1) * 4)
    return {'bf16_flops': 2. * _mlp_macs(st) * n * nnet,
            'f32_flops': float(enc), 'bytes': float(nbytes)}


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
