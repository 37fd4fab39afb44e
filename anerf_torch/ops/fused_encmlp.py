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
(their source notes give the designs and bounds).  Each is built per
static shape, as anerf_tpu's kernels are (``_build_call`` per shape):
1-13 kp bands (``KERNEL_NF``), 1-21 view PE rows, the windowed bone directions
(``--cutoff_bones``), nets of 1-16 layers of any width that is a
multiple of 256 up to 2048 and framecodes of at most 128
(``kernel_shape``: the encode shape a build is keyed by in
``cuda_build``); a shape outside that set takes the plain encode and
K5/K6 (``kernel_shape_ok``), and one inside it launches its build or
raises.  Where the trunk input does not stay resident in a block's
shared memory (512 wide and WIDE, 10-13 kp bands), K1/K2 write it to a
workspace of ``encmlp_fwd_workspace_bytes(n)`` that the wrapper
allocates a call, which WIDE nets (768-2048 wide) extend by each
block's activations; where the views input does not (15 view rows and
up, 13 with framecodes past 16, at 256 wide), their views
product builds it again 256 columns at a time in shared memory.

The per-ray view factorization (``viewfac``, on by default; the cost
gate of ``pallas_encmlp._build_call`` picks it, on the flagship for the
coarse pass, K2/K4): the views layer's views-input product becomes a
per-ray ``xw @ M`` (``fused_mlp.viewfac_operand``).  Two more kernels
(``csrc/viewfac.cu``) hold its per-ray parts: K-vf1 ``vf_operand``
builds M for every ray and net before K1/K2 (and again before K3/K4),
K-vf2 ``vf_fold`` folds the per-ray Gram matrices ``xw^T g_hv`` that a
pass of K3/K4 forms into the views weight's gradient and ``denc``.  With ``est.viewfac`` a launch runs
the factorized kernels or raises; the dense form runs only where the
gate says so.  All four are bound
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
(``K1_LAUNCHES`` .. ``K4_LAUNCHES``, read by ``launch_counts()``).  In
a captured CUDA graph (``trainer.make_multi_train_step``) a wrapper
runs, and counts, once at capture; a replay launches the kernel
without it, so a replay's launches are counted from a profile.
Everything a launch needs on the host is made before a capture by the
eager warm-up steps: the libraries (``cuda_build.library``) and the
cached index tensors (``_perm_tensors``); the weight packs of a launch
come from the graph's memory pool and its TMA maps pass by value.

The PE bands use the double-angle recurrence from one sin and one
cos-as-shifted-sin per joint, as the TPU kernels do (pallas_encmlp.py
``SIN_RECURRENCE``), in the twins and the kernels alike; the backward
recomputes them instead of reading the TPU's stash.  Every operation of
the encode is rounded on its own, in the order the twin's PyTorch
operations take ((x^2 + y^2) + z^2, (2 s) c, 1 - (2 s) s), in the
kernels too (no multiply-add contraction): each band doubles the last
one's rounding, so two orders part by whole bf16 steps within a few
bands past 10.  Past ``F_MAX`` bands the recurrence itself leaves the
unit circle (inf from the 23rd band in f32) and the gate sends the
shape to the plain encode's exact sines (ROADMAP C.17).

The in-kernel rigid transform (``fuse_tform``, off by default as in
anerf_tpu; ``rc.fuse_tform`` without ray noise): the sample points lie
on their rays, so their component-major local coordinates are a per-ray
affine in the depth, ``p = A + z B`` with ``A = W o + t`` and ``B = W
d`` (``tform_rows``).  K1-K4 then read the depths z (R, S) and the rows
[A; B] (R, 2, 3J) and build each point themselves (``EncStatic.
fuse_tform``); the (n, 3J) points never exist in device memory.  K3/K4
still write dp (n, 3J), and ``_tform_pullback`` contracts it into the
depths' and the rows' cotangents with torch ops after the kernel, where
anerf_tpu's XLA does.  The twins build the points with ``_apply_tform``
and run their chain.  ``launch_counts`` counts these launches apart
(``encmlp_fwd_tf`` .. ``encmlp_dual_bwd_tf``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build, encoders, fused_mlp
from .cuda_build import build_kernels  # noqa: F401  (re-exported)
from .fused_mlp import (MLPStatic, _forward_tile, _grad_layout,
                        _mlp_bwd_tile, _mlp_macs, _pack_bwd_weights,
                        _pack_kernel_weights, _unpack_grads, _weight_shapes,
                        kernel_static, viewfac_m, viewfac_operand)
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
    # in-kernel rigid transform (rc.fuse_tform): the kernels take the
    # depths (R, S) and the affine rows (R, 2, 3J) of ``tform_rows`` in
    # place of the points (n, 3J) (``_apply_tform``)
    fuse_tform: bool = False


def tform_rows(skts: torch.Tensor, rays_o: torch.Tensor,
               rays_d: torch.Tensor) -> torch.Tensor:
    """Each ray's rigid transforms reduced along the ray
    (``pallas_encmlp.tform_rows``): a sample ``o + z d`` has the
    component-major local coordinates ``W (o + z d) + t = A + z B`` with
    ``A = W o + t`` and ``B = W d``.  skts (R, J, 4, 4), a broadcast
    (expanded) one too; rays (R, 3).  Returns (R, 2, 3J) f32 [A; B]."""
    rcat, tcat = encoders.cm_transform_rows(skts)
    A = torch.einsum('rcd,rd->rc', rcat, rays_o.float()) + tcat
    B = torch.einsum('rcd,rd->rc', rcat, rays_d.float())
    return torch.stack([A, B], 1).float()


def _apply_tform(tf: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The points (n, 3J) of depths z (R, S) on rays with affine rows tf
    (R, 2, 3J): ``p[t] = A[ray(t)] + z[t] B[ray(t)]``, the product and the
    sum rounded one by one, as the kernels build them."""
    R, S = z.shape
    A, B = tf[:, :1], tf[:, 1:]
    return (A + z[..., None] * B).reshape(R * S, -1)


def _tform_pullback(tf: torch.Tensor, z: torch.Tensor, dp: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The VJP of ``_apply_tform`` (``pallas_encmlp._tform_pullback``):
    from the points' cotangent dp (n, 3J), returns (g_z (R, S), g_tf (R,
    2, 3J))."""
    R, S = z.shape
    dp3 = dp.reshape(R, S, -1)
    g_A = dp3.sum(1)
    g_B = torch.einsum('rsc,rs->rc', dp3, z)
    g_z = torch.einsum('rsc,rc->rs', dp3, tf[:, 1])
    return g_z, torch.stack([g_A, g_B], 1)


def _points(est: EncStatic, p: torch.Tensor, tf) -> torch.Tensor:
    """The points (n, 3J) a kernel encodes: ``p`` itself, or under
    ``est.fuse_tform`` the depths ``p`` (R, S) through the rows ``tf``."""
    return _apply_tform(tf, p) if est.fuse_tform else p


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
                    cutoff: torch.Tensor, tau: torch.Tensor,
                    skip_xv: bool = False):
    """``_encode_plain`` plus the pullback's residuals: returns
    ((v, r, xv), (dists, w, bands, invd)); ``skip_xv``: xv is None (the
    caller takes the factorized form instead).

    Mirrors ``pallas_encmlp._encode_fwd_res`` for the flagship flags
    (include_input, cutoff_inputs, no shift/cut_to/schedule).
    """
    J = est.J
    x, y, z = p[:, :J], p[:, J:2 * J], p[:, 2 * J:]
    # each operation rounded on its own, in this order: the kernels'
    # dist2 and band recurrence round the same way (encmlp_common.cuh)
    dists = torch.sqrt((x * x + y * y) + z * z)               # (n, J)
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
    xv = None
    if not skip_xv:
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
                           gxv, fac=None):
    """Plain VJP of ``_encode_fwd_res`` (f32 cotangents in), the
    transcendental-free pullback of ``pallas_encmlp._encode_pullback``:
    each band's derivative is its paired band scaled by +-f, sigmoid'
    reuses the window, sqrt' the stored distances.  Returns
    (dp (n, 3J), denc (R, nb*3J)): ``denc`` sums over the samples of
    each ray.  ``fac``: (d_window (n, J), d_enc (R, nb*3J)) of the
    factorized views backward, in place of the xv section (``gxv`` is
    then ignored): the window cotangent adds into g_w and d_enc is
    denc."""
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

    if fac is not None:
        g_w = g_w + fac[0]
        denc = fac[1]
    else:
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


def _views_operand(est: EncStatic, xv, w, enc_ray):
    """The views input part of the MLPs: the factorized operand under
    ``est.viewfac``, else the dense bf16 xv."""
    if est.viewfac:
        return viewfac_operand(w, enc_ray, est.S)
    return xv.to(torch.bfloat16).float()


def _bwd_nets_plain(st: MLPStatic, est: EncStatic, p, enc_ray, codes_list,
                    cutoff, tau, flats, gs, tf=None):
    """Shared body of the backward twins: one encode, each net's MLP
    backward, the nets' input cotangents summed in f32, rounded through
    bf16, and pulled back once (``_bwd_kernel_dual`` :784-822).  Under
    viewfac the nets' window and view-row cotangents add in f32, never
    rounded through bf16 (:809-816).  Under fuse_tform the points come
    from the depths ``p`` and the rows ``tf``; dp is the points' (n, 3J)
    cotangent either way."""
    b16 = lambda a: a.to(torch.bfloat16).float()
    p = _points(est, p, tf)
    (v, r, xv), res = _encode_fwd_res(est, p, enc_ray, cutoff, tau,
                                      skip_xv=est.viewfac)
    xs = [b16(v), b16(r)]
    xv_op = _views_operand(est, xv, res[1], enc_ray)
    ray = torch.arange(p.shape[0], device=p.device) // est.S
    R = enc_ray.shape[0]
    gx_tot = [torch.zeros_like(x) for x in xs]
    if est.viewfac:
        gw_tot = torch.zeros_like(res[1])
        genc_tot = torch.zeros_like(enc_ray)
    else:
        gxv_tot = torch.zeros_like(xv)
    dcodes, grads = [], []
    for codes, flat, g in zip(codes_list, flats, gs):
        xvs = [xv_op] + ([b16(codes[ray])] if est.has_codes else [])
        g_x, g_xvs, gr = _mlp_bwd_tile(st, xs, xvs, flat, g.t())
        gx_tot = [a + b for a, b in zip(gx_tot, g_x)]
        if est.viewfac:
            gw_tot = gw_tot + g_xvs[0][1]
            genc_tot = genc_tot + g_xvs[0][2]
        else:
            gxv_tot = gxv_tot + g_xvs[0]
        dcodes.append(g_xvs[1].reshape(R, est.S, -1).sum(1)
                      if est.has_codes else None)
        grads.append(gr)
    if est.viewfac:
        fac, gxv_in = (gw_tot, genc_tot), None
    else:
        fac, gxv_in = None, b16(gxv_tot)
    dp, denc = _encode_pullback_plain(est, p, enc_ray, res, tau,
                                      b16(gx_tot[0]), b16(gx_tot[1]),
                                      gxv_in, fac=fac)
    return dp, denc, dcodes, grads


def encmlp_bwd_plain(st: MLPStatic, est: EncStatic, p, enc_ray, codes,
                     cutoff, tau, flat, g, tf=None):
    """Plain twin of K3: the backward of K1 for the raw cotangent ``g``
    (4, n).  Returns (dp (n, 3J), denc (R, nb*3J), dcodes (R, C) or
    None, grads): f32 gradients of every ``flatten_params_cm`` operand.
    Mirrors ``pallas_encmlp._bwd_kernel``."""
    dp, denc, dcodes, grads = _bwd_nets_plain(
        st, est, p, enc_ray, [codes], cutoff, tau, [flat], [g], tf)
    return dp, denc, dcodes[0], grads[0]


def encmlp_dual_bwd_plain(st: MLPStatic, est: EncStatic, p, enc_ray,
                          codes_c, codes_f, cutoff, tau, flat_c, flat_f,
                          g_c, g_f, tf=None):
    """Plain twin of K4: the backward of K2.  Returns (dp, denc,
    dcodes_c, dcodes_f, grads_c, grads_f).  Mirrors
    ``pallas_encmlp._bwd_kernel_dual``."""
    dp, denc, dcodes, grads = _bwd_nets_plain(
        st, est, p, enc_ray, [codes_c, codes_f], cutoff, tau,
        [flat_c, flat_f], [g_c, g_f], tf)
    return dp, denc, dcodes[0], dcodes[1], grads[0], grads[1]


def encmlp_fwd_plain(st: MLPStatic, est: EncStatic, p, enc_ray, codes,
                     cutoff, tau, flat, tf=None) -> torch.Tensor:
    """Plain twin of K1: raw (4, n) rows [r, g, b, sigma]; under
    fuse_tform ``p`` is the depths (R, S) and ``tf`` their rows."""
    p = _points(est, p, tf)
    (v, r, xv), res = _encode_fwd_res(est, p, enc_ray, cutoff, tau,
                                      skip_xv=est.viewfac)
    xvs = [_views_operand(est, xv, res[1], enc_ray)]
    if est.has_codes:
        ray = torch.arange(p.shape[0], device=p.device) // est.S
        xvs.append(codes[ray])
    _, _, _, rgb, alpha = _forward_tile(st, [v, r], xvs, flat)
    return torch.cat([rgb, alpha], -1).T.contiguous()


def encmlp_dual_fwd_plain(st: MLPStatic, est: EncStatic, p, enc_ray,
                          codes_c, codes_f, cutoff, tau, flat_c, flat_f,
                          tf=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K2: the encode once, both nets on it."""
    p = _points(est, p, tf)
    (v, r, xv), res = _encode_fwd_res(est, p, enc_ray, cutoff, tau,
                                      skip_xv=est.viewfac)
    xv_op = _views_operand(est, xv, res[1], enc_ray)
    ray = torch.arange(p.shape[0], device=p.device) // est.S
    outs = []
    for codes, flat in ((codes_c, flat_c), (codes_f, flat_f)):
        xvs = [xv_op] + ([codes[ray]] if est.has_codes else [])
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
KVF1_LAUNCHES = 0
KVF2_LAUNCHES = 0
# K1-K4 under fuse_tform, counted apart
K1_TF_LAUNCHES = 0
K2_TF_LAUNCHES = 0
K3_TF_LAUNCHES = 0
K4_TF_LAUNCHES = 0

# the static shapes K1-K4 (and K-vf1/K-vf2 under viewfac) are built
# for, a library per shape (csrc/encmlp_common.cuh, ops/cuda_build.py):
# SMPL's 24 joints, 1-F_MAX kp bands on the 2^k grid (nerf-pytorch's
# default multires is 10), 1-21 view PE rows (multires_views 0-10), the
# bone directions windowed or not, trunk layers of any width that is a
# multiple of 256 up to 2048 (past 512, WIDE, the activations in device
# memory) with the skip after layer 4 (none below 6 layers), 1-32
# layers at 256 wide, 1-24 at 512 and 1-16 WIDE (``kernel_depths``): past
# 8 layers K1/K2's and K3/K4's recompute's sums reach their
# accumulators rounded to nearest (csrc/encmlp_common.cuh ENC_DEEP),
# which keeps the raw outputs and the weight gradients within twice the
# twin's distance of an f64 evaluation of the chain from the encode's own
# f32 bands (chip_smoke._check_close_f64, _check_bwd_f64) at every depth
# measured up to the caps; at 32 layers of 512 K4's gradients miss it
# with every accumulation tried (scripts/check_k6_f64.py --f32-encode
# --acc-group, ROADMAP B.1.4), the
# views layer half as wide, framecodes of at most 128 (zero-padded to
# the next multiple of 16, the views input's k-step; at least 16) or
# none.  The trunk and the views inputs stay in a block's shared memory
# where they fit, else the trunk input in device memory and the views
# input built again a column block at a time (the kernels decide,
# csrc/encmlp_fwd.cu, encmlp_bwd.cu).  The rest is ROADMAP B.1.4.
# F_MAX: the most kp bands at which anerf_tpu's double-angle recurrence
# still holds to the model.  Over 20 seeds of 32 rays the twins'
# gradients meet anerf_tpu's Pallas kernels' at the backward bar
# (cosine 0.9999) at every band count up to 13 (the worst 0.999937);
# at 14 one seed misses (0.999851), at 15 one by far (0.995981), and
# from 22 anerf_tpu's fused render parts from its own XLA path
# (scripts/kp_band_cap.py, ROADMAP C.17).  Past F_MAX a shape takes the
# plain encode's exact sines and K5/K6.  csrc/encmlp_common.cuh holds
# the same cap.
F_MAX = 13
KERNEL_J = 24
KERNEL_NF = range(1, F_MAX + 1)
KERNEL_NB = tuple(range(1, 22, 2))
KERNEL_DEPTH = {256: range(1, 33), 512: range(1, 25)}
KERNEL_WIDTH = tuple(range(256, 2049, 256))
KERNEL_WIDE_DEPTH = range(1, 17)
KERNEL_SKIPS = (4,)
KERNEL_CODES = 128


def kernel_depths(width: int) -> range:
    """The trunk depths K1-K4 are built for at a net ``width`` wide."""
    return KERNEL_DEPTH.get(width, KERNEL_WIDE_DEPTH)


def kernel_codes(codes: int) -> int:
    """The framecode columns of the K1-K4 build for codes ``codes``
    wide (0: none): the next multiple of 16, at least 16."""
    return max(16, -(-codes // 16) * 16)


def reset_launch_counts() -> None:
    """Zero the launch counts of all eight kernels and of K1-K4's
    fuse_tform forms (K5/K6 live in ``fused_mlp``)."""
    global K1_LAUNCHES, K2_LAUNCHES, K3_LAUNCHES, K4_LAUNCHES
    global KVF1_LAUNCHES, KVF2_LAUNCHES
    global K1_TF_LAUNCHES, K2_TF_LAUNCHES, K3_TF_LAUNCHES, K4_TF_LAUNCHES
    K1_LAUNCHES = K2_LAUNCHES = K3_LAUNCHES = K4_LAUNCHES = 0
    KVF1_LAUNCHES = KVF2_LAUNCHES = 0
    K1_TF_LAUNCHES = K2_TF_LAUNCHES = K3_TF_LAUNCHES = K4_TF_LAUNCHES = 0
    fused_mlp.reset_launch_counts()


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel since the last reset: K1-K4 on points,
    K1-K4 under fuse_tform (the ``_tf`` keys) and K-vf1/K-vf2
    (``vf_operand``, ``vf_fold``) here, K5/K6 (``mlp_fwd``, ``mlp_bwd``)
    from ``fused_mlp.launch_counts``.  A CUDA graph's launches count at
    its capture, not at its replays."""
    return {'encmlp_fwd': K1_LAUNCHES, 'encmlp_dual_fwd': K2_LAUNCHES,
            'encmlp_bwd': K3_LAUNCHES, 'encmlp_dual_bwd': K4_LAUNCHES,
            'encmlp_fwd_tf': K1_TF_LAUNCHES,
            'encmlp_dual_fwd_tf': K2_TF_LAUNCHES,
            'encmlp_bwd_tf': K3_TF_LAUNCHES,
            'encmlp_dual_bwd_tf': K4_TF_LAUNCHES,
            'vf_operand': KVF1_LAUNCHES, 'vf_fold': KVF2_LAUNCHES,
            **fused_mlp.launch_counts()}


def _shape_refusal(st: MLPStatic, est: EncStatic) -> Optional[str]:
    """None where K1-K4 (and K-vf1/K-vf2, which take every NB they do)
    are built for this static shape, else the refusal: what they do not
    take, and why."""
    F, nb = len(est.kp_freqs), est.view_nb
    codes = st.vparts[1] if est.has_codes and len(st.vparts) > 1 else 0

    def unported(why):
        return (f'the fused CUDA kernels K1-K4 do not take {why}; such '
                'shapes are not ported yet (ROADMAP.md B.1.4)')
    if est.J != KERNEL_J:
        return unported(f'{est.J} joints (they take SMPL\'s {KERNEL_J})')
    if not _doubling_freqs(est.kp_freqs):
        return unported(f'the kp bands {est.kp_freqs} (they take bands on '
                        'the 2^k grid)')
    if F not in KERNEL_NF:
        return (f'the fused CUDA kernels K1-K4 do not take {F} kp bands: '
                f'past {KERNEL_NF[-1]} bands anerf_tpu\'s band recurrence '
                'no longer holds to the model (ROADMAP.md C.17)')
    if nb not in KERNEL_NB:
        return unported(f'{nb} view PE rows (they take 1-21, odd: '
                        'multires_views 0-10)')
    if st.width not in KERNEL_WIDTH or st.half != st.width // 2:
        return unported(f'a net {st.width} wide with a views layer of '
                        f'{st.half} (they take a multiple of 256 up to '
                        '2048, the views layer half as wide)')
    if tuple(st.skips) != KERNEL_SKIPS:
        return unported(f'the skips {tuple(st.skips)} (they take the skip '
                        'after layer 4)')
    depths = kernel_depths(st.width)
    if st.depth not in depths:
        return unported(f'{st.depth} layers {st.width} wide (they take '
                        f'{depths[0]}-{depths[-1]}: past {depths[-1]} layers '
                        'K3/K4\'s per-tile sums are not held to the f64 '
                        'evaluation of the chain that holds the deep '
                        'nets)')
    if codes > KERNEL_CODES:
        return unported(f'framecodes of {codes} (they take at most '
                        f'{KERNEL_CODES})')
    if (st.dparts != ((2 * F + 1) * est.J, 3 * est.J)
            or st.vparts[0] != nb * 3 * est.J
            or len(st.vparts) != 1 + est.has_codes):
        return unported(f'the parts {st.dparts} / {st.vparts} of another '
                        'encoding')
    return None


def kernel_shape(st: MLPStatic, est: EncStatic) -> Tuple[int, int, bool,
                                                         int, int, int]:
    """The build of K1-K4 that runs this static shape: its encode shape
    (kp bands NF, view PE rows NB, bone window, depth, width, framecode
    columns NCODE), the key ``cuda_build.library(..., enc=...)`` takes
    (K-vf1/K-vf2's build is its (NB, width / 2)).  Raises
    NotImplementedError for a shape they are not built for
    (``_shape_refusal``: ROADMAP B.1.4 queues it, or C.17 keeps it on
    the split route)."""
    why = _shape_refusal(st, est)
    if why is not None:
        raise NotImplementedError(why)
    return (len(est.kp_freqs), est.view_nb, bool(est.bone_windowed),
            st.depth, st.width, _ncode(st, est))


def _ncode(st: MLPStatic, est: EncStatic) -> int:
    """The framecode columns NCODE of the build that runs ``st``
    (``kernel_codes`` of its codes part)."""
    return kernel_codes(st.vparts[1] if est.has_codes and len(st.vparts) > 1
                        else 0)


def kernel_shape_ok(rc) -> bool:
    """Whether the fused encode kernels take this raycast config:
    ``supported_config`` holds and K1-K4 are built for its static shape
    (the check ``kernel_shape`` makes at a launch).  Depends on ``rc``
    alone, so the CPU takes the route the card takes, and training and
    rendering take the same one; a config with framecodes is judged with
    them."""
    if not supported_config(rc):
        return False
    st, est = _statics(rc, rc.n_joints, 1, DEFAULT_TILE,
                       rc.nerf.use_framecode)
    return _shape_refusal(st, est) is None


def _check_inputs(p, enc_ray, cutoff, tau, codes_list, est, tf=None):
    """(n, R) of a call; raises on operands the kernels do not take.
    ``p``: the points (n, 3J), or under fuse_tform the depths (R, S)
    with ``tf`` their rows (R, 2, 3J)."""
    dev = p.device
    if est.fuse_tform:
        R = p.shape[0]
        if p.dim() != 2 or p.shape[1] != est.S:
            raise ValueError(f'the depths must be (R, {est.S}), '
                             f'got {tuple(p.shape)}')
        if tf is None or tuple(tf.shape) != (R, 2, 3 * est.J):
            raise ValueError(f'the affine rows must be ({R}, 2, '
                             f'{3 * est.J})')
        n = R * est.S
    else:
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
    for t in [p, enc_ray, cutoff, tau] + [c for c in codes_list + [tf]
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


def _packs(st: MLPStatic, flats):
    """The nets' forward packs (bf16 weights, f32 biases) back to back,
    in the layout of their K1-K4 build (``st.xv_pad``: ``_statics``)."""
    packs = [_pack_kernel_weights(f, st) for f in flats]
    return (torch.cat([w for w, _ in packs]),
            torch.cat([b for _, b in packs]))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(name: str, shape, nnet: int, p, enc_ray, codes, cutoff, tau,
            wbuf, bbuf, out, n: int, S: int, R: int, vf_m=None,
            tf=None) -> None:
    """K1 or K2, built for the encode shape ``shape`` (``kernel_shape``);
    ``vf_m``: the nets' M (``vf_operand``) under viewfac, else None (the
    dense views input); ``tf``: the affine rows under fuse_tform (``p``
    the depths), else None.  Where the build's trunk input does not stay
    in shared memory, the call's workspace for it (n rounded up to 64
    rows of its width, bf16: 113 MB at 131,072 points and 432 columns),
    which the encode writes and both nets of K2 read; a WIDE net's adds
    each 64-point block's activations, (2 W + W / 2) x 2 bytes a point
    (1.34 GB at 262,144 points 1024 wide)."""
    lib = cuda_build.library('fwd', enc=shape)
    _check_packs(lib, nnet, wbuf, bbuf)
    nx = int(lib.encmlp_fwd_workspace_bytes(n))
    xwork = (torch.empty(nx, dtype=torch.uint8, device=p.device) if nx
             else None)
    with torch.cuda.device(p.device):
        err = getattr(lib, name)(
            p.data_ptr(), enc_ray.data_ptr(), codes.data_ptr(),
            cutoff.data_ptr(), tau.data_ptr(), wbuf.data_ptr(),
            bbuf.data_ptr(), _ptr(vf_m), _ptr(tf), _ptr(xwork),
            out.data_ptr(), n, S, R, cuda_build.stream(p.device))
    if err != 0:
        raise RuntimeError(f'{name} launch failed: cudaError {err}')


def _wvx(st: MLPStatic, flats) -> torch.Tensor:
    """The nets' views-input weight rows (nnet, 72 NB, HV) bf16 (648 rows
    at the flagship's 9), the ``flatten_params_cm`` operand after the
    views layer's feat part."""
    k = len(flats[0]) - 3 - len(st.vparts)
    return torch.stack([f[k] for f in flats]).to(torch.bfloat16).contiguous()


def _vf_m(st, est, enc_ray, flats) -> Optional[torch.Tensor]:
    """K-vf1's M of the nets under viewfac, else None."""
    return vf_operand(est, enc_ray, _wvx(st, flats)) if est.viewfac else None


def _codes_operand(codes_list, st, est, R, device):
    """(nnet, R, NCODE) f32 codes for the kernel, NCODE the build's
    (``_ncode``): narrower codes padded with zero columns (which meet the
    pack's zero weight rows), zeros without codes."""
    ncode = _ncode(st, est)
    if est.has_codes:
        codes = torch.stack(codes_list)
        pad = ncode - codes.shape[-1]
        if pad:
            codes = torch.nn.functional.pad(codes, (0, pad))
        return codes.contiguous()
    return torch.zeros((len(codes_list), R, ncode),
                       dtype=torch.float32, device=device)


def _fwd(st, est, p, enc_ray, codes, cutoff, tau, flat,
         tf=None) -> torch.Tensor:
    """K1 or its twin, no autograd."""
    global K1_LAUNCHES, K1_TF_LAUNCHES
    n, R = _check_inputs(p, enc_ray, cutoff, tau, [codes], est, tf)
    if cuda_build.device_of(p) == 'cpu':
        return encmlp_fwd_plain(st, est, p, enc_ray, codes, cutoff, tau, flat,
                                tf)
    shape = kernel_shape(st, est)
    wbuf, bbuf = _packs(st, [flat])
    out = torch.empty((4, n), dtype=torch.float32, device=p.device)
    _launch('encmlp_fwd', shape, 1, p, enc_ray,
            _codes_operand([codes], st, est, R, p.device), cutoff, tau, wbuf,
            bbuf, out, n, est.S, R, _vf_m(st, est, enc_ray, [flat]), tf)
    if est.fuse_tform:
        K1_TF_LAUNCHES += 1
    else:
        K1_LAUNCHES += 1
    return out


def _dual_fwd(st, est, p, enc_ray, codes_c, codes_f, cutoff, tau, flat_c,
              flat_f, tf=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 or its twin, no autograd."""
    global K2_LAUNCHES, K2_TF_LAUNCHES
    n, R = _check_inputs(p, enc_ray, cutoff, tau, [codes_c, codes_f], est,
                         tf)
    if cuda_build.device_of(p) == 'cpu':
        return encmlp_dual_fwd_plain(st, est, p, enc_ray, codes_c, codes_f,
                                     cutoff, tau, flat_c, flat_f, tf)
    shape = kernel_shape(st, est)
    wbuf, bbuf = _packs(st, [flat_c, flat_f])
    out = torch.empty((2, 4, n), dtype=torch.float32, device=p.device)
    _launch('encmlp_dual_fwd', shape, 2, p, enc_ray,
            _codes_operand([codes_c, codes_f], st, est, R, p.device),
            cutoff, tau, wbuf, bbuf, out, n, est.S, R,
            _vf_m(st, est, enc_ray, [flat_c, flat_f]), tf)
    if est.fuse_tform:
        K2_TF_LAUNCHES += 1
    else:
        K2_LAUNCHES += 1
    return out[0], out[1]


# -- backward ---------------------------------------------------------------

def _launch_bwd(name: str, nnet: int, st, est, p, enc_ray, codes_list,
                cutoff, tau, flats, gs, tf=None):
    """Launch K3 (nnet=1) or K4 (nnet=2); under viewfac with K-vf1's M
    before and K-vf2's fold of its per-ray Gram matrices Gw after (the
    views weight's view rows and denc); under fuse_tform on the depths
    ``p`` and the rows ``tf``.  Returns (dp (n, 3J), denc, dcodes (nnet,
    R, C), grads per net)."""
    shape = kernel_shape(st, est)
    R = enc_ray.shape[0]
    n = R * est.S
    dev = p.device
    fwd_lib = cuda_build.library('fwd', enc=shape)
    lib = cuda_build.library('bwd', enc=shape)
    wbuf, bbuf = _packs(st, flats)
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
    dcodes = torch.empty((nnet, R, _ncode(st, est)), **f32)
    dw = torch.empty((nnet, n_dw), **f32)
    db = torch.empty((nnet, fwd_lib.encmlp_bias_elems()), **f32)
    part, P, slice_ = fused_mlp.dw_partials(st, n, n_dw, nnet, dev)
    codes = _codes_operand(codes_list, st, est, R, dev)
    vf_m = gw = None
    if est.viewfac:
        wvx = _wvx(st, flats)
        vf_m = vf_operand(est, enc_ray, wvx)
        gw = torch.empty((nnet, R, est.J, st.half), dtype=torch.bfloat16,
                         device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            p.data_ptr(), enc_ray.data_ptr(), codes.data_ptr(),
            cutoff.data_ptr(), tau.data_ptr(), wbuf.data_ptr(),
            wbuf_b.data_ptr(), bbuf.data_ptr(), g.data_ptr(), ws.data_ptr(),
            dp.data_ptr(), denc.data_ptr(), dcodes.data_ptr(),
            dw.data_ptr(), db.data_ptr(), part.data_ptr(), _ptr(vf_m),
            _ptr(gw), _ptr(tf), P, slice_, n, est.S, R,
            cuda_build.stream(dev))
    if err != 0:
        raise RuntimeError(f'{name} launch failed: cudaError {err}')
    if est.viewfac:
        # the views input's view rows of dW (the views layer's weight
        # operand after its feat part) and denc
        _, off, _ = _grad_layout(kernel_static(st))[
            len(flats[0]) - 3 - len(st.vparts)]
        dwv, denc = vf_fold(est, gw, enc_ray, wvx)
        dw[:, off:off + dwv[0].numel()] = dwv.reshape(nnet, -1)
    grads = [_unpack_grads(st, dw[i], db[i]) for i in range(nnet)]
    if est.has_codes:   # the codes' own columns
        dcodes = dcodes[..., :st.vparts[1]]
    return dp, denc, dcodes, grads


def encmlp_bwd(st: MLPStatic, est: EncStatic, p, enc_ray, codes, cutoff,
               tau, flat, g, tf=None):
    """K3: the backward of K1 for the raw cotangent ``g`` (4, n).
    Returns (dp (n, 3J), denc (R, nb*3J), dcodes (R, C) or None, f32
    gradients of the ``flatten_params_cm`` operands); under fuse_tform
    ``p`` is the depths and ``tf`` their rows, and dp is still the
    points' cotangent.  CPU tensors take the twin; CUDA tensors launch
    the kernel or raise."""
    global K3_LAUNCHES, K3_TF_LAUNCHES
    _check_inputs(p, enc_ray, cutoff, tau, [codes], est, tf)
    if cuda_build.device_of(p) == 'cpu':
        return encmlp_bwd_plain(st, est, p, enc_ray, codes, cutoff, tau,
                                flat, g, tf)
    dp, denc, dcodes, grads = _launch_bwd('encmlp_bwd', 1, st, est, p,
                                          enc_ray, [codes], cutoff, tau,
                                          [flat], [g], tf)
    if est.fuse_tform:
        K3_TF_LAUNCHES += 1
    else:
        K3_LAUNCHES += 1
    return dp, denc, dcodes[0] if est.has_codes else None, grads[0]


def encmlp_dual_bwd(st: MLPStatic, est: EncStatic, p, enc_ray, codes_c,
                    codes_f, cutoff, tau, flat_c, flat_f, g_c, g_f, tf=None):
    """K4: the backward of K2.  Returns (dp, denc, dcodes_c, dcodes_f,
    grads_c, grads_f)."""
    global K4_LAUNCHES, K4_TF_LAUNCHES
    _check_inputs(p, enc_ray, cutoff, tau, [codes_c, codes_f], est, tf)
    if cuda_build.device_of(p) == 'cpu':
        return encmlp_dual_bwd_plain(st, est, p, enc_ray, codes_c, codes_f,
                                     cutoff, tau, flat_c, flat_f, g_c, g_f,
                                     tf)
    dp, denc, dcodes, grads = _launch_bwd(
        'encmlp_dual_bwd', 2, st, est, p, enc_ray, [codes_c, codes_f],
        cutoff, tau, [flat_c, flat_f], [g_c, g_f], tf)
    if est.fuse_tform:
        K4_TF_LAUNCHES += 1
    else:
        K4_LAUNCHES += 1
    dc = (dcodes[0], dcodes[1]) if est.has_codes else (None, None)
    return dp, denc, dc[0], dc[1], grads[0], grads[1]


# -- viewfac's per-ray kernels: K-vf1, K-vf2 ---------------------------------

def vf_operand_plain(est: EncStatic, enc_ray, wvx) -> torch.Tensor:
    """Plain twin of K-vf1: M (nnet, R, J, HV) bf16, ``M[net, r, j] =
    bf16(sum_b bf16(enc_ray[r, b J + j]) wvx[net, b J + j])`` summed in
    f32 (``fused_mlp.viewfac_m``)."""
    E = enc_ray.to(torch.bfloat16).float()
    return torch.stack([viewfac_m(E, w, est.J) for w in wvx]
                       ).to(torch.bfloat16)


def vf_operand(est: EncStatic, enc_ray: torch.Tensor,
               wvx: torch.Tensor) -> torch.Tensor:
    """K-vf1: the per-ray operand M (nnet, R, J, HV) bf16 of viewfac from
    the view rows enc_ray (R, nb*3J) f32 and each net's views-input
    weight rows wvx (nnet, nb*3J, HV) bf16.  CPU tensors take the twin;
    CUDA tensors launch the kernel or raise."""
    global KVF1_LAUNCHES
    nnet, R = wvx.shape[0], enc_ray.shape[0]
    if cuda_build.device_of(enc_ray) == 'cpu':
        return vf_operand_plain(est, enc_ray, wvx)
    lib = cuda_build.library('viewfac', enc=(est.view_nb, wvx.shape[-1]))
    HV, nbJ = lib.viewfac_width(), est.view_nb * 3 * est.J
    if (tuple(wvx.shape) != (nnet, nbJ, HV)
            or tuple(enc_ray.shape) != (R, nbJ) or est.J != KERNEL_J
            or wvx.dtype != torch.bfloat16 or not _aligned(wvx, enc_ray)):
        raise ValueError(f'viewfac weights must be (nnet, {nbJ}, {HV}) '
                         'bf16')
    M = torch.empty((nnet, R, est.J, HV), dtype=torch.bfloat16,
                    device=enc_ray.device)
    with torch.cuda.device(enc_ray.device):
        err = lib.viewfac_m(enc_ray.data_ptr(), wvx.data_ptr(), M.data_ptr(),
                            R, nnet, cuda_build.stream(enc_ray.device))
    if err != 0:
        raise RuntimeError(f'viewfac_m launch failed: cudaError {err}')
    KVF1_LAUNCHES += 1
    return M


def vf_gram_plain(est: EncStatic, w: torch.Tensor,
                  g_hv: torch.Tensor) -> torch.Tensor:
    """Plain twin of K3/K4's Gram pass, of one net: Gw (R, J, HV) bf16,
    each ray's sum over its points of bf16(w[t, j]) bf16(g_hv[t])
    (``pallas_mlp._viewfac_bwd``'s xw^T g_hv), rounded to bf16."""
    n, J = w.shape
    b16 = lambda a: a.to(torch.bfloat16).float()
    R = n // est.S
    x3 = b16(w).reshape(R, est.S, J)
    return torch.bmm(x3.transpose(1, 2), b16(g_hv).reshape(R, est.S, -1)
                     ).to(torch.bfloat16)


def vf_fold_plain(est: EncStatic, gw, enc_ray, wvx):
    """Plain twin of K-vf2: from the nets' Gram matrices gw (nnet, R, J,
    HV) bf16, returns (dWvx (nnet, nb*3J, HV), denc (R, nb*3J)), f32:
    ``dWvx[net, b J + j] = sum_r bf16(enc[r, b J + j]) Gw[net, r, j]``,
    ``denc[r, b J + j] = sum_net wvx[net, b J + j] . Gw[net, r, j]``
    (``pallas_mlp._viewfac_bwd``)."""
    J = est.J
    nnet, R, nbJ, HV = gw.shape[0], enc_ray.shape[0], enc_ray.shape[1], \
        gw.shape[-1]
    b16 = lambda a: a.to(torch.bfloat16).float()
    Gw = gw.float()
    E3 = b16(enc_ray).reshape(R, nbJ // J, J)
    W3 = b16(wvx).reshape(nnet, nbJ // J, J, HV)
    dwv = torch.einsum('rbj,nrjh->nbjh', E3, Gw).reshape(nnet, nbJ, HV)
    denc = torch.einsum('nrjh,nbjh->rbj', Gw, W3).reshape(R, nbJ)
    return dwv, denc


# K-vf2's slices (viewfac.cu's FO_SLICE) and its partial sums at most:
# 8 partials x 24 joints, 192 blocks in clusters of 8, all resident at
# once on an H100
VF_SLICE = 64
VF_PARTIALS = 8


def vf_fold_plan(R: int) -> Tuple[int, int]:
    """K-vf2's plan for R rays: (P, slice).  The rays go in slices of
    ``slice`` (the last one ragged); dWvx is summed in P partials,
    partial p over the slices p, p + P, p + 2P, ... in order, then the
    P partials in order.  P is at most VF_PARTIALS and at most R / 216,
    so that the partials' f32 bytes, written and read back (P x 0.66 MB
    a net), stay under half of the Gw bytes the fold reads (R x 6 KB a
    net): 8 partials at R = 2048, 5.3 MB each way against 25.2 MB."""
    return max(1, min(VF_PARTIALS, R // 216)), VF_SLICE


def vf_fold(est: EncStatic, gw: torch.Tensor, enc_ray: torch.Tensor,
            wvx: torch.Tensor):
    """K-vf2: viewfac's fold of the nets' per-ray Gram matrices gw (nnet,
    R, J, HV) bf16 (K3/K4's Gram pass) with the view rows enc_ray (R,
    nb*3J) and the views-input weight rows wvx (nnet, nb*3J, HV) bf16:
    returns (dWvx (nnet, nb*3J, HV), denc (R, nb*3J)) f32, as
    ``vf_fold_plain``; dWvx's rays summed in the partials of
    ``vf_fold_plan``, each over its slices in order, then the partials
    in order; past 256 views columns (WIDE nets) denc's sum over them in
    blocks of 128, then the blocks in order.  CPU tensors take the twin;
    CUDA tensors launch the kernels or raise."""
    global KVF2_LAUNCHES
    if cuda_build.device_of(gw) == 'cpu':
        return vf_fold_plain(est, gw, enc_ray, wvx)
    lib = cuda_build.library('viewfac', enc=(est.view_nb, wvx.shape[-1]))
    nnet, R, nbJ = wvx.shape[0], enc_ray.shape[0], enc_ray.shape[1]
    HV = lib.viewfac_width()
    if (tuple(gw.shape) != (nnet, R, est.J, HV)
            or tuple(wvx.shape) != (nnet, nbJ, HV)
            or wvx.dtype != torch.bfloat16 or gw.dtype != torch.bfloat16
            or lib.viewfac_slice() != VF_SLICE
            or not _aligned(gw, enc_ray, wvx)):
        raise ValueError('viewfac fold operands do not match the kernel')
    dev = gw.device
    f32 = dict(dtype=torch.float32, device=dev)
    P, slice_ = vf_fold_plan(R)
    dwv = torch.empty((nnet, nbJ, HV), **f32)
    denc = torch.empty((R, nbJ), **f32)
    # the dWvx partials past one, and past 256 columns the column
    # blocks' partial denc
    nscratch = int(lib.viewfac_fold_scratch(R, nnet, P))
    part = torch.empty(nscratch, **f32) if nscratch else None
    with torch.cuda.device(dev):
        err = lib.viewfac_fold(gw.data_ptr(), enc_ray.data_ptr(),
                               wvx.data_ptr(), dwv.data_ptr(), nbJ * HV,
                               denc.data_ptr(),
                               None if part is None else part.data_ptr(), P,
                               slice_, R, nnet, cuda_build.stream(dev))
    if err != 0:
        raise RuntimeError(f'viewfac_fold launch failed: cudaError {err}')
    KVF2_LAUNCHES += 1
    return dwv, denc


def _aligned(*ts) -> bool:
    """Contiguous, on 16-byte boundaries: the viewfac kernels read whole
    16-byte chunks."""
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts)


def vf_cost(est: EncStatic, R: int, nnet: int, HV: int,
            fold: bool = False) -> Dict[str, float]:
    """Work of one K-vf1 (or, ``fold``, K-vf2) launch: bf16 FLOPs on the
    tensor cores (bf16 operands, f32 sums: 27 products a value of M;
    dWvx's and denc's sums over the rays and the columns) and the bytes
    that must move: enc and the views weights read once, M written (or
    Gw read, dWvx and denc written) once."""
    J, nbJ = est.J, est.view_nb * 3 * est.J
    m_bytes = nnet * R * J * HV * 2
    if not fold:
        return {'bf16_flops': 2. * nnet * R * HV * nbJ, 'f32_flops': 0.,
                'bytes': float(R * nbJ * 4 + nnet * nbJ * HV * 2 + m_bytes)}
    return {'bf16_flops': 4. * nnet * R * nbJ * HV, 'f32_flops': 0.,
            'bytes': float(m_bytes + R * nbJ * 4 + nnet * nbJ * HV * 2
                           + nnet * nbJ * HV * 4 + R * nbJ * 4)}


# -- autograd ---------------------------------------------------------------

def _cast_grads(grads, flat):
    """Each gradient in its operand's dtype: bf16 for weights, f32 for
    biases (``gr.astype(d)``, pallas_encmlp.py:681,937-940)."""
    return [gr.to(w.dtype) for gr, w in zip(grads, flat)]


def _point_grads(est: EncStatic, p, tf, dp):
    """The cotangents of the point operands from dp (n, 3J): (dp, None),
    or under fuse_tform those of the depths and of the rows."""
    if est.fuse_tform:
        return _tform_pullback(tf, p, dp)
    return dp, None


class _EncMLP(torch.autograd.Function):
    """K1 forward, K3 backward (``pallas_encmlp._fused`` custom_vjp).
    ``cutoff`` and ``tau`` get no gradient, as in JAX."""

    @staticmethod
    def forward(ctx, st, est, p, enc_ray, codes, cutoff, tau, tf, *flat):
        ctx.st, ctx.est, ctx.has_codes = st, est, codes is not None
        ctx.save_for_backward(p, enc_ray, cutoff, tau, tf,
                              *([codes] if codes is not None else []), *flat)
        return _fwd(st, est, p, enc_ray, codes, cutoff, tau, flat, tf)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        p, enc_ray, cutoff, tau, tf = saved[:5]
        codes = saved[5] if ctx.has_codes else None
        flat = saved[6 if ctx.has_codes else 5:]
        dp, denc, dcodes, grads = encmlp_bwd(ctx.st, ctx.est, p, enc_ray,
                                             codes, cutoff, tau, flat, g, tf)
        dp, dtf = _point_grads(ctx.est, p, tf, dp)
        return (None, None, dp, denc, dcodes, None, None, dtf,
                *_cast_grads(grads, flat))


class _EncMLPDual(torch.autograd.Function):
    """K2 forward, K4 backward (``pallas_encmlp._fused_dual``)."""

    @staticmethod
    def forward(ctx, st, est, nflat, p, enc_ray, codes_c, codes_f, cutoff,
                tau, tf, *flats):
        ctx.st, ctx.est, ctx.nflat = st, est, nflat
        ctx.has_codes = codes_c is not None
        codes = [codes_c, codes_f] if ctx.has_codes else []
        ctx.save_for_backward(p, enc_ray, cutoff, tau, tf, *codes, *flats)
        return _dual_fwd(st, est, p, enc_ray, codes_c, codes_f, cutoff, tau,
                         flats[:nflat], flats[nflat:], tf)

    @staticmethod
    def backward(ctx, g_c, g_f):
        saved = ctx.saved_tensors
        p, enc_ray, cutoff, tau, tf = saved[:5]
        k = 7 if ctx.has_codes else 5
        codes_c, codes_f = saved[5:7] if ctx.has_codes else (None, None)
        flat_c, flat_f = saved[k:k + ctx.nflat], saved[k + ctx.nflat:]
        dp, denc, dc_c, dc_f, gr_c, gr_f = encmlp_dual_bwd(
            ctx.st, ctx.est, p, enc_ray, codes_c, codes_f, cutoff, tau,
            flat_c, flat_f, g_c, g_f, tf)
        dp, dtf = _point_grads(ctx.est, p, tf, dp)
        return (None, None, None, dp, denc, dc_c, dc_f, None, None, dtf,
                *_cast_grads(gr_c, flat_c), *_cast_grads(gr_f, flat_f))


def encmlp_fwd(st: MLPStatic, est: EncStatic, p: torch.Tensor,
               enc_ray: torch.Tensor, codes: Optional[torch.Tensor],
               cutoff: torch.Tensor, tau: torch.Tensor,
               flat: Sequence[torch.Tensor],
               tf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: fused encode + one net.  p (n, 3J) component-major f32,
    enc_ray (R, nb*3J), codes (R, C) or None, cutoff (J,), tau (1,),
    flat the ``flatten_params_cm`` operands; under ``est.fuse_tform`` p
    is the depths (R, S) and tf their affine rows (R, 2, 3J).  Returns
    raw (4, n), with K3 as its backward on every device."""
    return _EncMLP.apply(st, est, p, enc_ray, codes, cutoff, tau, tf, *flat)


def encmlp_dual_fwd(st: MLPStatic, est: EncStatic, p: torch.Tensor,
                    enc_ray: torch.Tensor, codes_c: Optional[torch.Tensor],
                    codes_f: Optional[torch.Tensor], cutoff: torch.Tensor,
                    tau: torch.Tensor, flat_c: Sequence[torch.Tensor],
                    flat_f: Sequence[torch.Tensor],
                    tf: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: fused encode once + the coarse and the fine net.  Returns
    (raw_coarse, raw_fine), each (4, n), with K4 as their backward."""
    return _EncMLPDual.apply(st, est, len(flat_c), p, enc_ray, codes_c,
                             codes_f, cutoff, tau, tf, *flat_c, *flat_f)


def kernel_cost(st: MLPStatic, est: EncStatic, n: int, nnet: int,
                backward: bool = False) -> Dict[str, float]:
    """Work of one launch, counted from the shapes: bf16 tensor-core
    FLOPs of the MLPs, f32 FLOPs of the encode, and the bytes that must
    move (each input read once, each output written once).

    ``backward``: K3/K4, which recompute the forward and form the input
    cotangents and the weight gradients (3x the forward's MLP FLOPs, as
    pallas_encmlp.py:666,917 counts them) and pull back through the
    encode; their bytes add the incoming g, dp, denc, dcodes and the f32
    weight gradients.  Under viewfac the views input's products are a
    ray's J rows of M a point (recompute, window cotangent, xw^T g_hv),
    and the fold's own work is K-vf2's (``vf_cost``).  Under fuse_tform
    the points come in as the depths and the affine rows, R (S + 6J) x 4
    bytes (pallas_encmlp.py:592-593), and each build of a point (the
    forward's, the backward's recompute and pullback) adds its 3
    products and 3 sums a joint; dp (n, 3J) is still written."""
    J, F, nb = est.J, len(est.kp_freqs), est.view_nb
    R = n // est.S
    bw = 3 if est.bone_windowed else 0
    # per point and joint: distance 6, window 6, first sin/cos 3, each
    # further octave 5, v scaling 2F+1, bone dir 5 (+3 windowed), view
    # rows 3*nb
    enc = n * J * (6 + 6 + 3 + 5 * (F - 1) + (2 * F + 1) + 5 + bw + 3 * nb)
    tform = 6 * n * J if est.fuse_tform else 0
    wshapes = _weight_shapes(st)
    wbytes = sum(int(np.prod(s)) * (2 if d == torch.bfloat16 else 4)
                 for s, d in wshapes)
    codes = st.vparts[1] if est.has_codes else 0
    pts_bytes = (R * (est.S + 6 * J) * 4 if est.fuse_tform
                 else n * 3 * J * 4)
    nbytes = (pts_bytes + R * nb * 3 * J * 4 + nnet * R * codes * 4
              + nnet * wbytes + nnet * 4 * n * 4 + (J + 1) * 4)
    macs = _mlp_macs(st)
    if est.viewfac:
        # xw @ M: a point meets its ray's J rows of M, not the 648 view
        # rows of the views weight; M is read once a ray and net
        macs -= (nb * 3 * J - J) * st.half
        nbytes += nnet * R * J * st.half * 2
    flops = 2. * macs * n * nnet
    enc += tform
    if backward:
        flops *= 3
        # pullback per point and joint: 2F+1 window products and sums,
        # 2F paired-band terms (3 each), bone dir 7 (+9 windowed: the
        # window's share and its product in dp), view rows 4*nb (window
        # and g_w), window and sqrt' 8
        enc += n * J * (3 * (2 * F + 1) + 3 * 2 * F + 7 + 3 * bw
                        + 4 * 3 * nb + 8)
        enc += tform
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


def _statics(rc, J: int, S: int, tile: int, has_codes: bool,
             fuse_tform: bool = False) -> Tuple[MLPStatic, EncStatic]:
    """The static shapes of a call at S samples a ray and a point tile
    of ``tile``."""
    nerf = rc.nerf
    st = MLPStatic(
        depth=nerf.depth, width=nerf.width,
        dparts=((1 + 2 * rc.kp_embed.num_freqs) * J, 3 * J),
        vparts=(((1 + 2 * rc.view_embed.num_freqs) * 3 * J,)
                + ((nerf.framecode_ch,) if has_codes else ())),
        half=nerf.width // 2, skips=tuple(nerf.skips), tile=tile,
        # K1-K4's views input [view rows | codes (NCODE) | 0 x 8], DXV
        xv_pad=((1 + 2 * rc.view_embed.num_freqs) * 3 * J + 8
                + kernel_codes(nerf.framecode_ch if has_codes else 0)))
    est = EncStatic(J=J, kp_freqs=tuple(float(f) for f in
                                        rc.kp_embed.freq_bands()),
                    view_nb=1 + 2 * rc.view_embed.num_freqs,
                    S=S, rpt=max(tile // S, 1), has_codes=has_codes,
                    bone_windowed=rc.bone_embed.cutoff,
                    viewfac=getattr(rc, 'viewfac', False),
                    fuse_tform=fuse_tform)
    return st, est


def viewfac_taken(est: EncStatic, tile: int) -> bool:
    """The viewfac cost gate at a point tile of ``tile``: the factorized
    forward costs rptJ*nblkJ + T*rptJ MACs per half-column against
    T*nblkJ dense, so it wins only when J*(nblkJ + tile) < 0.9*S*nblkJ
    (pallas_encmlp.py:1116-1133): at S = 64 from 7 view rows on with
    the train step's 512-point tile, from 11 with the eval tile of
    1024."""
    nblkJ = est.view_nb * 3 * est.J
    return est.J * (nblkJ + tile) < 0.9 * est.S * nblkJ


def _build_call(rc, pts_t, rays_t_norm, cutoff_dist, tau, cam_idxs,
                tile, enc_ray=None, tf_rows=None, z_vals=None):
    """Statics + kernel operands from component-major ``pts_t``
    (R, S, 3J), or, given the affine rows ``tf_rows`` (R, 2, 3J) of
    ``tform_rows`` and the depths ``z_vals`` (R, S), for the in-kernel
    transform (``pts_t`` is then ignored and ``p`` is the depths).
    Returns (st, est, p, enc_ray, cutoff (J,), tau (1,)).

    The tile arithmetic and the viewfac cost gate are those of
    ``pallas_encmlp._build_call``, whichever form the points take;
    unlike the TPU kernels the CUDA kernels mask their ragged edge, so
    every (R, S) is taken.
    """
    if tile is None:
        tile = DEFAULT_TILE
    if tf_rows is not None:
        R, S = z_vals.shape
        J = tf_rows.shape[-1] // 3
    else:
        R, S, K = pts_t.shape
        J = K // 3
    n = R * S
    while tile > 128 and (n < tile or tile % S != 0 or
                          R % (tile // S) != 0):
        tile //= 2
    st, est = _statics(rc, J, S, tile,
                       rc.nerf.use_framecode and cam_idxs is not None,
                       fuse_tform=tf_rows is not None)
    if est.viewfac and not viewfac_taken(est, tile):
        est = dataclasses.replace(est, viewfac=False)

    if tf_rows is not None:
        p = z_vals.float().contiguous()
    else:
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


def _tf_operand(est: EncStatic, tf_rows) -> Optional[torch.Tensor]:
    return tf_rows.float().contiguous() if est.fuse_tform else None


def nerf_encmlp(net_params: Dict[str, Any], rc,
                pts_t: Optional[torch.Tensor],
                rays_t_norm: torch.Tensor, cutoff_dist, tau,
                cam_idxs: Optional[torch.Tensor] = None,
                tile: Optional[int] = None,
                enc_ray: Optional[torch.Tensor] = None,
                tf_rows: Optional[torch.Tensor] = None,
                z_vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused encode+MLP for one network pass (K1).

    pts_t: (R, S, 3J) component-major skeleton-relative points, or None
    when ``tf_rows`` (R, 2, 3J, ``tform_rows``) and ``z_vals`` (R, S) are
    given: the kernel then applies the rigid transform itself (fuse_tform);
    rays_t_norm: (R, 3J) normalized per-joint local ray directions;
    cutoff_dist: (J,); tau: scalar; cam_idxs: (R,) framecode indices or
    None; enc_ray: optionally the precomputed ``view_pe_rows``.
    Returns channel-major raw (4, R, S).
    """
    st, est, p, enc_ray, cutoff, tau_t = _build_call(
        rc, pts_t, rays_t_norm, cutoff_dist, tau, cam_idxs, tile, enc_ray,
        tf_rows, z_vals)
    R = enc_ray.shape[0]
    codes = _codes(net_params, cam_idxs) if est.has_codes else None
    flat = flatten_params_cm(net_params, st, est.J, est.view_nb)
    raw = encmlp_fwd(st, est, p, enc_ray, codes, cutoff, tau_t, flat,
                     _tf_operand(est, tf_rows))
    return raw.reshape(4, R, est.S)


def nerf_encmlp_dual(coarse_params: Dict[str, Any],
                     fine_params: Dict[str, Any], rc,
                     pts_t: Optional[torch.Tensor],
                     rays_t_norm: torch.Tensor, cutoff_dist, tau,
                     cam_idxs: Optional[torch.Tensor] = None,
                     tile: Optional[int] = None,
                     enc_ray: Optional[torch.Tensor] = None,
                     tf_rows: Optional[torch.Tensor] = None,
                     z_vals: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused encode once + BOTH MLPs on the same points (K2), as
    ``nerf_encmlp`` takes them.  The reference runs the coarse and the
    fine net on the same stratified samples (core/raycasters.py:438,
    456-461).  Returns (raw_coarse, raw_fine), each (4, R, S)."""
    st, est, p, enc_ray, cutoff, tau_t = _build_call(
        rc, pts_t, rays_t_norm, cutoff_dist, tau, cam_idxs, tile, enc_ray,
        tf_rows, z_vals)
    R, S = enc_ray.shape[0], est.S
    if est.has_codes:
        codes_c = _codes(coarse_params, cam_idxs)
        codes_f = _codes(fine_params, cam_idxs)
    else:
        codes_c = codes_f = None
    flat_c = flatten_params_cm(coarse_params, st, est.J, est.view_nb)
    flat_f = flatten_params_cm(fine_params, st, est.J, est.view_nb)
    raw_c, raw_f = encmlp_dual_fwd(st, est, p, enc_ray, codes_c, codes_f,
                                   cutoff, tau_t, flat_c, flat_f,
                                   _tf_operand(est, tf_rows))
    return raw_c.reshape(4, R, S), raw_f.reshape(4, R, S)
