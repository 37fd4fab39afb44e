#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``anerf_torch/csrc`` with nvcc
(sm_90a, one process per source, all started together), then:

1. kernel phase: K1 (one net, R=4096 rays x S=16) and K2 (two nets,
   R=4096 x S=64) at the SURREAL recipe's full width on realistic
   inputs, each held against its plain PyTorch twin on the card, with
   median kernel time, the twin's time and the card's bound;
2. backward kernel phase: K4 (two nets, R=2048 x S=64) and K3 (one
   net, R=2048 x S=16), the train step's shapes, held against their
   plain twins on the same inputs and the same incoming cotangent (that
   of an rgb loss after compositing), plus a ragged point count (S=24,
   R=171: a part-full last tile, every third ray across two tiles) with
   and without framecodes; kernel time, twin time, bound and achieved
   TFLOP/s;
3. path phase: ``ImageRenderer.render_path`` renders bullet-time frames
   at 512x512 with 4096-ray chunks through the port's render path; the
   launch counts of K1 and K2 must each equal the number of chunks, the
   maps must be finite, and one chunk is checked against the plain
   (unfused) path on the card;
4. train phase: 25 steps of ``make_train_step`` at the SURREAL recipe
   (``testing_utils.build_flagship``: 2048 rays, pose refinement every
   20 steps); each of K1-K4 must launch once a step, the losses must be
   finite and fall, the pose bank must hold still through step 18 and
   move at step 19, and one step's NeRF gradients on the fused backend
   must agree with the plain backend's; train rays/s over steps 5-24,
   seconds per step, peak device memory and a profile of one step;
5. split-MLP kernel phase: K5 and K6 (``fused_mlp``) on the encodings
   the plain encoders make of a two-subject scene, held against their
   twins (forward rows as in 1, every output of K6 as in 2): at a ragged
   4104 points with and without framecodes, then K5 at the eval coarse
   chunk (n=262,144) and the train shapes (n=131,072 and 32,768) and K6
   at the train shapes, with kernel time, twin time, bound and TFLOP/s;
6. multi-subject path phase: one bullet-time frame of the two-subject
   model at 512x512 (chunk 4096); K5 must launch 3 times a chunk and
   K1-K4 never, and one chunk must match the plain path;
7. multi-subject train phase: 12 steps of
   ``build_flagship(2048, n_subjects=2)`` (two subjects with different
   rest poses); K5 and K6 must launch 3 times a step and K1-K4 never,
   the losses must be finite, one step's NeRF gradients must agree with
   the plain backend's, and the same rays as subject 0 and subject 1
   must give other colors and the same densities; train rays/s, ms/step,
   peak memory and a profile of one step.

Prints the card (nvidia-smi name and power limit), a ``kernels`` JSON
line (K1-K6; each kernel's launches are those of its main path's run:
the flagship train step for K1-K4, the multi-subject one for K5/K6),
and as its last line ``{"ok": true, "device": {...}}``.  Any
failure raises: the exit code is then non-zero and the last line is
not printed.  Without CUDA, or outside a checkout of the repository,
it fails the same way.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

# K1/K2 against their twins, on the raw rows [r, g, b, sigma]: both
# compute the same bf16-operand chain, so they differ by f32 summation
# order, sinf/expf rounding and the bf16 re-cast flips these cause
# between layers.  A flip moves one activation by one bf16 ulp (2^-8
# relative) and the rows by far less on average, so: mean |d| below
# 1e-3 x the channel's max |value|, the worst point below 2e-2 x it.
RAW_MEAN_TOL = 1e-3
RAW_MAX_TOL = 2e-2
# rendered maps against the plain unfused path: the bar anerf_tpu holds
# its fused kernels to (tests/test_pallas_encmlp.py:53)
MAP_TOL = 1e-3
# K3/K4 against their twins, every output (dp, denc, dcodes, each weight
# and bias gradient): the bar anerf_tpu holds between its own two
# backward implementations (tests/test_pallas_encmlp.py:236-237)
BWD_COS_MIN = 0.9999
BWD_RATIO_TOL = 5e-3
# one train step's NeRF gradients, fused against plain backend: the bar
# anerf_tpu holds its fused backend to against XLA
# (tests/test_pallas_encmlp.py:257-258)
GRAD_COS_MIN = 0.98
GRAD_RATIO_TOL = 0.1
TRAIN_STEPS = 25
MS_STEPS = 12           # multi-subject train steps

# published dense peaks (NVIDIA data sheets) by card:
# (bf16 tensor FLOP/s, f32 FLOP/s, HBM bytes/s)
PEAKS = {'H100 PCIe': (756e12, 51e12, 2.0e12),
         'H100 NVL': (835e12, 60e12, 3.9e12),
         'H100': (989e12, 67e12, 3.35e12)}     # SXM


def _peaks(name):
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAKS['H100']


def _time_ms(fn, reps, windows=5):
    """Device time per call of ``fn``: CUDA events around ``reps``
    back-to-back calls (the host queues each call while the device runs
    the last, so host work stays out of the reading), after a warm-up;
    the median over ``windows`` such runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / reps)
    return statistics.median(per_call)


def _rel_err(ref, got):
    """Per-channel (max |d|, mean |d|) over the channel's max |ref|."""
    out = []
    for c in range(ref.shape[0]):
        scale = ref[c].abs().max().item() + 1e-6
        d = (ref[c] - got[c]).abs()
        out.append((d.max().item() / scale, d.mean().item() / scale))
    return out


def kernel_inputs(FE, T, rc, cfg, params, S, R, device, codes=True):
    """K1/K2 operands at R rays x S samples from a synthetic scene
    (``codes=False``: a config without framecodes)."""
    import torch
    from anerf_torch.models.factory import embed_state
    from anerf_torch.ops import encoders, rays as ray_ops
    _, bones, _, kps, skts, cyls = T.synthetic_pose(9, seed=0)
    b = T.to_device(T.synthetic_batch(R, 9, kps, skts, bones, cyls, seed=1),
                    device)
    near, far = ray_ops.get_near_far_in_cylinder(b['rays_o'], b['rays_d'],
                                                 b['cyls'], 0., 1.)
    z = ray_ops.sample_from_lineseg(near, far, S)
    pts = b['rays_o'][:, None] + b['rays_d'][:, None] * z[..., None]
    pts_t = encoders.transform_batch_pts_cm(pts, b['skts'])
    rays_t = encoders.transform_batch_rays(b['rays_d'][:, None], b['skts'])
    rays_t_norm = encoders.vec_norm(rays_t)[:, 0]
    tau = embed_state(cfg, rc, 10000)['tau']
    cams = b['cam_idxs'] if codes else None
    st, est, p, enc, cutoff, tau_t = FE._build_call(
        rc, pts_t, rays_t_norm, params['cutoff_dist'], tau, cams, 1024)
    if not codes:     # the views weights without the framecode rows
        params = {k: dict(params[k], views_linear={
            'w': params[k]['views_linear']['w'][:-cfg.framecode_size],
            'b': params[k]['views_linear']['b']}) for k in ('coarse', 'fine')}
    codes = [FE._codes(params[k], cams) if cams is not None else None
             for k in ('coarse', 'fine')]
    flats = [FE.flatten_params_cm(params[k], st, est.J, est.view_nb)
             for k in ('coarse', 'fine')]
    return st, est, p, enc, codes, cutoff, tau_t, flats


def _check_close(name, ref, got):
    """Raw rows of a kernel against its twin; returns max |d|."""
    import torch
    worst_max = worst_mean = max_abs = 0.
    for net, (r, g) in enumerate(zip(ref, got)):
        if not torch.isfinite(g).all():
            raise AssertionError(f'{name}: non-finite kernel output')
        max_abs = max(max_abs, (r - g).abs().max().item())
        for ch, (mx, mn) in enumerate(_rel_err(r, g)):
            print(f'  {name} net{net} ch{ch}: max|d|/scale {mx:.3e} '
                  f'mean|d|/scale {mn:.3e}')
            worst_max, worst_mean = max(worst_max, mx), max(worst_mean, mn)
    if worst_max > RAW_MAX_TOL or worst_mean > RAW_MEAN_TOL:
        raise AssertionError(
            f'{name} disagrees with its plain twin: max {worst_max:.3e}'
            f' (tol {RAW_MAX_TOL}), mean {worst_mean:.3e} '
            f'(tol {RAW_MEAN_TOL})')
    return max_abs


def _calls(FE, st, est, p, enc, codes, cutoff, tau, flats, nnet):
    """(kernel, twin) closures of K1 (nnet=1, the fine net) or K2."""
    if nnet == 1:
        args = (st, est, p, enc, codes[1], cutoff, tau, flats[1])
        return (lambda: [FE.encmlp_fwd(*args)],
                lambda: [FE.encmlp_fwd_plain(*args)])
    args = (st, est, p, enc, *codes, cutoff, tau, *flats)
    return (lambda: list(FE.encmlp_dual_fwd(*args)),
            lambda: list(FE.encmlp_dual_fwd_plain(*args)))


def kernel_phase(FE, T, rc, cfg, params, peaks, device, R=4096):
    import torch
    # ragged point counts (the last 64-point tile part-full) and a
    # config without framecodes, checked only
    for name, S, nnet, Rr, codes in (('encmlp_fwd', 16, 1, 7, True),
                                     ('encmlp_dual_fwd', 24, 2, 3, False)):
        ins = kernel_inputs(FE, T, rc, cfg, params, S, Rr, device, codes)
        run, plain = _calls(FE, *ins, nnet)
        print(f'{name} n={Rr * S} codes={codes}:')
        _check_close(name, plain(), run())
    rows = []
    for name, S, nnet in (('encmlp_fwd', 16, 1), ('encmlp_dual_fwd', 64, 2)):
        st, est, p, enc, codes, cutoff, tau, flats = kernel_inputs(
            FE, T, rc, cfg, params, S, R, device)
        run, plain = _calls(FE, st, est, p, enc, codes, cutoff, tau, flats,
                            nnet)
        got = run()
        torch.cuda.synchronize()
        max_abs = _check_close(name, plain(), got)
        rows.append(_timed_row(
            name, 'encmlp_fwd.cu', 345 if nnet == 1 else 709,
            FE.kernel_cost(st, est, p.shape[0], nnet), _time_ms(run, 10),
            _time_ms(plain, 2), max_abs, peaks, f'R={R} S={S}'))
    return rows


def _timed_row(name, source, tpu_line, cost, ms, plain_ms, max_abs, peaks,
               shape, tpu_file='pallas_encmlp.py'):
    """Print a kernel's time against its twin and its bound; return its
    row of the ``kernels`` line (launches filled in later)."""
    t_ops = cost['bf16_flops'] / peaks[0] + cost['f32_flops'] / peaks[1]
    t_bytes = cost['bytes'] / peaks[2]
    bound_ms = 1e3 * max(t_ops, t_bytes)
    print(f'{name}: {shape} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
          f'bound {bound_ms:.4f} ms ({cost["bf16_flops"]:.3e} bf16 FLOP, '
          f'{cost["bytes"] / 1e6:.1f} MB), '
          f'{cost["bf16_flops"] / (ms * 1e-3) / 1e12:.1f} TFLOP/s')
    return dict(name=name, route='cuda', source=f'anerf_torch/csrc/{source}',
                replaces=f'anerf_tpu/ops/{tpu_file}:{tpu_line}',
                launches=None, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                library_ms=None)


def _cmp(ref, got):
    """(cosine, norm ratio, worst |d| over max |ref|, max |d|) of two
    tensors."""
    a, b = ref.double().ravel(), got.double().ravel()
    na, nb = a.norm().item(), b.norm().item()
    cos = 1.0 if na == nb == 0 else (a @ b).item() / (na * nb + 1e-300)
    d = (a - b).abs()
    return (cos, nb / na if na > 0 else 1.0,
            d.max().item() / (a.abs().max().item() + 1e-30), d.max().item())


def _bwd_calls(FE, st, est, p, enc, codes, cutoff, tau, flats, g, nnet):
    """(kernel, twin) closures of K3 (nnet=1) or K4, each returning the
    named outputs [(name, tensor)]: dp, denc, dcodes, every gradient."""
    def named(out):
        if nnet == 1:
            dp, denc, dc, gr = out
            items = [('dp', dp), ('denc', denc), ('dcodes', dc)]
            items += [(f'g{i}', x) for i, x in enumerate(gr)]
        else:
            dp, denc, dcc, dcf, grc, grf = out
            items = [('dp', dp), ('denc', denc), ('dcodes_c', dcc),
                     ('dcodes_f', dcf)]
            items += [(f'coarse.g{i}', x) for i, x in enumerate(grc)]
            items += [(f'fine.g{i}', x) for i, x in enumerate(grf)]
        return [(k, v) for k, v in items if v is not None]
    if nnet == 1:
        args = (st, est, p, enc, codes[1], cutoff, tau, flats[1], g[0])
        return (lambda: named(FE.encmlp_bwd(*args)),
                lambda: named(FE.encmlp_bwd_plain(*args)))
    args = (st, est, p, enc, *codes, cutoff, tau, *flats, g[0], g[1])
    return (lambda: named(FE.encmlp_dual_bwd(*args)),
            lambda: named(FE.encmlp_dual_bwd_plain(*args)))


def _check_bwd(name, ref, got):
    """Every output of K3/K4 against its twin; returns max |d|."""
    import torch
    worst, max_abs = [], 0.
    for (k, r), (_, g) in zip(ref, got):
        if not torch.isfinite(g).all():
            raise AssertionError(f'{name}: non-finite {k}')
        cos, ratio, rel, mx = _cmp(r, g)
        max_abs = max(max_abs, mx)
        worst.append((cos, k, ratio, rel))
        if cos < BWD_COS_MIN or abs(ratio - 1) > BWD_RATIO_TOL:
            raise AssertionError(f'{name} {k} disagrees with its twin: '
                                 f'cos {cos:.6f} ratio {ratio:.5f}')
    print(f'  {name}: {len(got)} outputs, worst |d|/max|ref| of each: '
          + ', '.join(f'{k} {rel:.1e}' for _, k, _, rel in worst))
    worst.sort()
    for cos, k, ratio, rel in worst[:4]:
        print(f'  {name} {k}: cos {cos:.7f} ratio {ratio:.5f} '
              f'worst |d|/max|ref| {rel:.3e}')
    return max_abs


def _composited_cotangent(FE, ins, nnet, device):
    """The raw cotangent a train step hands K3/K4: the gradient of an
    rgb MSE after compositing each net's raw (4, n) along its rays,
    taken through the plain forward on the kernel's inputs.  (A random
    N(0, 1) cotangent on every point weighs the points the compositing
    ignores as much as the rest; there the kernel's recompute, rounded
    in another order than the twin's, flips a ReLU mask now and then,
    which moves whole elements of the cotangents; the phase prints the
    cosines that gives as well.)"""
    st, est, p, enc, codes, cutoff, tau, flats = ins
    if nnet == 2:
        outs = FE.encmlp_dual_fwd_plain(st, est, p, enc, *codes, cutoff, tau,
                                        *flats)
    else:
        outs = [FE.encmlp_fwd_plain(st, est, p, enc, codes[1], cutoff, tau,
                                    flats[1])]
    return _composite_grad(outs, est.S, device)


def _composite_grad(outs, S, device):
    """d(rgb MSE after compositing) / d raw for raw rows (4, n), n = R x S
    points in ray order, each a list entry; stacked (nnet, 4, n)."""
    import torch
    from anerf_torch.ops import compositing
    raws = [o.detach().requires_grad_(True) for o in outs]
    R = raws[0].shape[1] // S
    gen = torch.Generator(device=device).manual_seed(0)
    z = torch.linspace(0.5, 1.5, S, device=device).expand(R, S)
    rays_d = torch.randn((R, 3), generator=gen, device=device)
    target = torch.rand((R, 3), generator=gen, device=device)
    loss = 0.
    for raw in raws:
        r4 = raw.reshape(4, R, S)
        ret = compositing.raw2outputs_rows(r4[3], r4[0], r4[1], r4[2], z,
                                           rays_d)
        loss = loss + ((ret['rgb_map'] - target) ** 2).mean()
    return torch.stack(torch.autograd.grad(loss, raws))


def bwd_kernel_phase(FE, T, rc, cfg, params, peaks, device, R=2048):
    import torch
    # ragged point counts, checked only: S=24, R=171 is 4104 points, 64
    # full 64-point tiles and a part-full one, and every third ray
    # crosses a tile boundary
    for name, nnet, codes in (('encmlp_dual_bwd', 2, False),
                              ('encmlp_bwd', 1, True)):
        ins = kernel_inputs(FE, T, rc, cfg, params, 24, 171, device, codes)
        g = _composited_cotangent(FE, ins, nnet, device)
        run, plain = _bwd_calls(FE, *ins, g, nnet)
        print(f'{name} n=4104 S=24 codes={codes}:')
        _check_bwd(name, plain(), run())
    rows = []
    for name, S, nnet in (('encmlp_dual_bwd', 64, 2), ('encmlp_bwd', 16, 1)):
        ins = kernel_inputs(FE, T, rc, cfg, params, S, R, device)
        st, est, p = ins[0], ins[1], ins[2]
        run, plain = _bwd_calls(FE, *ins,
                                _composited_cotangent(FE, ins, nnet, device),
                                nnet)
        got = run()
        torch.cuda.synchronize()
        print(f'{name} R={R} S={S}:')
        max_abs = _check_bwd(name, plain(), got)
        del got
        # why the bar takes the composited cotangent: a random one on
        # every point, printed only
        g_rand = torch.randn((nnet, 4, p.shape[0]), device=device,
                             generator=torch.Generator(device).manual_seed(0))
        run_r, plain_r = _bwd_calls(FE, *ins, g_rand, nnet)
        cos, k = min((_cmp(r, g)[0], k)
                     for (k, r), (_, g) in zip(plain_r(), run_r()))
        print(f'  {name} with an N(0, 1) cotangent on every point (not '
              f'held to the bar): worst cos {cos:.7f} ({k})')
        rows.append(_timed_row(
            name, 'encmlp_bwd.cu', 480 if nnet == 1 else 744,
            FE.kernel_cost(st, est, p.shape[0], nnet, backward=True),
            _time_ms(run, 5), _time_ms(plain, 1, windows=3), max_abs, peaks,
            f'R={R} S={S}'))
    return rows


def split_inputs(FM, T, cfg, rc2, params2, R, S, device, codes=True,
                 cat_subject=False):
    """K5/K6 operands at R rays x S samples of the two-subject scene
    (``synthetic_pose(n_subjects=2)``): the plain encoders' encodings
    (``raycaster.encode_inputs``) as the train step makes them, the
    subject channel as its own part as the raycaster hands it over
    (``cat_subject``: appended to the view encoding, anerf_tpu's
    649-wide part), the fine net's framecodes as their own part
    (``codes=False``: a net without them).  Returns (st, xs, xvs,
    flat)."""
    import torch
    from anerf_torch.models import raycaster
    from anerf_torch.models.factory import embed_state
    from anerf_torch.models.nerf_mlp import framecode_select
    from anerf_torch.ops import rays as ray_ops
    _, bones, _, kps, skts, cyls = T.synthetic_pose(9, n_subjects=2)
    b = T.to_device(T.synthetic_batch(R, 9, kps, skts, bones, cyls, seed=1),
                    device)
    subj = torch.as_tensor(T.subject_of_frame(9, 2), device=device)
    near, far = ray_ops.get_near_far_in_cylinder(b['rays_o'], b['rays_d'],
                                                 b['cyls'], 0., 1.)
    z = ray_ops.sample_from_lineseg(near, far, S)
    pts = b['rays_o'][:, None] + b['rays_d'][:, None] * z[..., None]
    pose = {k: b[k] for k in ('kps', 'skts', 'bones', 'cyls')}
    net = params2['fine']
    with torch.no_grad():
        v, r, d = raycaster.encode_inputs(rc2, params2, pts, b['rays_o'],
                                          b['rays_d'], pose,
                                          embed_state(cfg, rc2, 10000))
        ch = subj[b['kp_idx']].to(d.dtype)[:, None, None].expand(R, S, 1)
        parts = [[v, r], [torch.cat([d, ch], -1)] if cat_subject
                 else [d, ch]]
        if codes:
            c = framecode_select(net['framecodes'], b['cam_idxs'])
            parts[1].append(c[:, None].expand(R, S, c.shape[-1]))
        else:
            net = dict(net, views_linear={
                'w': net['views_linear']['w'][:-cfg.framecode_size],
                'b': net['views_linear']['b']})
    xs, xvs = [[a.reshape(R * S, a.shape[-1]).to(torch.bfloat16).contiguous()
                for a in ps] for ps in parts]
    st = FM.MLPStatic(depth=rc2.nerf.depth, width=rc2.nerf.width,
                      dparts=tuple(x.shape[1] for x in xs),
                      vparts=tuple(x.shape[1] for x in xvs),
                      half=rc2.nerf.width // 2, skips=tuple(rc2.nerf.skips))
    return st, xs, xvs, FM.flatten_params(net, st)


def _split_calls(FM, st, xs, xvs, flat, g=None):
    """(kernel, twin) closures of K5 (raw rows as (4, n), for
    ``_check_close``) or, given the cotangent g (n, 4), of K6 (named
    outputs for ``_check_bwd``: each part's cotangent, every gradient)."""
    if g is None:
        return (lambda: [FM.mlp_fwd(st, xs, xvs, flat).T],
                lambda: [FM.mlp_fwd_plain(st, xs, xvs, flat).T])

    def named(out):
        dxs, dxvs, grads = out
        return ([(f'dx{i}', x) for i, x in enumerate(dxs)]
                + [(f'dxv{i}', x) for i, x in enumerate(dxvs)]
                + [(f'g{i}', x) for i, x in enumerate(grads)])
    return (lambda: named(FM.mlp_bwd(st, xs, xvs, flat, g)),
            lambda: named(FM.mlp_bwd_plain(st, xs, xvs, flat, g)))


def _split_cotangent(FM, st, xs, xvs, flat, S, device):
    """K6's incoming cotangent (n, 4): that of an rgb loss after
    compositing K5's twin output along its rays."""
    raw = FM.mlp_fwd_plain(st, xs, xvs, flat).T
    return _composite_grad([raw], S, device)[0].T.contiguous()


def split_mlp_phase(FM, T, cfg, rc2, params2, peaks, device):
    """K5 and K6 against their twins on the two-subject scene's
    encodings: checked at a ragged 4104 points (S=24, R=171) with the
    raycaster's parts and with a 649-wide odd one without framecodes,
    then checked and timed at the eval coarse chunk (K5, R=4096 x S=64)
    and the train shapes (R=2048 x S=64 and x S=16, both kernels).
    Returns the kernels' rows at n=131,072."""
    import torch
    for codes, cat in ((True, False), (False, True)):
        st, xs, xvs, flat = split_inputs(FM, T, cfg, rc2, params2, 171, 24,
                                         device, codes, cat)
        print(f'mlp_fwd, mlp_bwd n=4104 S=24 parts {st.dparts} / '
              f'{st.vparts}:')
        run, plain = _split_calls(FM, st, xs, xvs, flat)
        _check_close('mlp_fwd', plain(), run())
        g = _split_cotangent(FM, st, xs, xvs, flat, 24, device)
        run, plain = _split_calls(FM, st, xs, xvs, flat, g)
        _check_bwd('mlp_bwd', plain(), run())
    timed = {}
    for R, S in ((4096, 64), (2048, 64), (2048, 16)):
        st, xs, xvs, flat = split_inputs(FM, T, cfg, rc2, params2, R, S,
                                         device)
        n = R * S
        run, plain = _split_calls(FM, st, xs, xvs, flat)
        got = run()
        torch.cuda.synchronize()
        print(f'mlp_fwd R={R} S={S}:')
        max_abs = _check_close('mlp_fwd', plain(), got)
        timed['mlp_fwd', n] = _timed_row(
            'mlp_fwd', 'mlp_fwd.cu', 267, FM.kernel_cost(st, n),
            _time_ms(run, 10), _time_ms(plain, 2), max_abs, peaks, f'n={n}',
            tpu_file='pallas_mlp.py')
        if R != 2048:
            continue
        g = _split_cotangent(FM, st, xs, xvs, flat, S, device)
        run, plain = _split_calls(FM, st, xs, xvs, flat, g)
        got = run()
        torch.cuda.synchronize()
        print(f'mlp_bwd R={R} S={S}:')
        max_abs = _check_bwd('mlp_bwd', plain(), got)
        del got
        timed['mlp_bwd', n] = _timed_row(
            'mlp_bwd', 'mlp_bwd.cu', 276, FM.kernel_cost(st, n, backward=True),
            _time_ms(run, 5), _time_ms(plain, 1, windows=3), max_abs, peaks,
            f'n={n}', tpu_file='pallas_mlp.py')
    ws = FM.cuda_build.library('mlp_bwd').mlp_bwd_workspace_bytes(131072)
    print(f'mlp_bwd workspace at n=131,072: {ws / 2**30:.3f} GiB')
    # the rows of the train step's coarse samples
    return [timed['mlp_fwd', 131072], timed['mlp_bwd', 131072]]


def path_phase(FE, T, rc, cfg, params, device, gpu_line, per_chunk,
               n_bullet=3, what='path', H=512, chunk=4096):
    """``ImageRenderer.render_path`` over ``n_bullet`` bullet-time frames:
    each kernel must launch ``per_chunk[name]`` times a chunk (the rest
    none), the maps must be finite and not empty, and one chunk must
    match the plain path.  Returns the launch counts of the timed
    render."""
    import numpy as np
    import torch
    from anerf_torch.models import raycaster
    from anerf_torch.models.factory import embed_state
    from anerf_torch.render.poses import load_bullettime
    from anerf_torch.render.renderer import ImageRenderer, kp_to_valid_rays

    W = H
    focal = 0.8 * W
    rest, bones, _, kps, _, _ = T.synthetic_pose(9, seed=0)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 1.2        # the subject's cylinder fills ~1/5 of the frame
    rd = load_bullettime(kps, bones, np.stack([c2w] * len(kps)), focal,
                         rest, selected_idxs=[0], n_bullet=n_bullet)
    rd['hwf'] = (np.full(3, H), np.full(3, W), rd['focals'])
    state = embed_state(cfg, rc, 10000)
    renderer = ImageRenderer(rc, params, state, chunk=chunk, near=0.,
                             far=1., device=device)
    n_chunks = 0
    inner = renderer._render_chunk

    def counted(*args):
        nonlocal n_chunks
        n_chunks += 1
        return inner(*args)

    renderer._render_chunk = counted
    renderer.render_path(rd)          # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    n_chunks = 0
    FE.reset_launch_counts()
    t0 = time.perf_counter()
    out = renderer.render_path(rd)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = FE.launch_counts()
    print(f'{what}: {len(rd["c2ws"])} frames {H}x{W}, {n_chunks} chunks, '
          f'launches {counts}')
    expect = {k: per_chunk.get(k, 0) * n_chunks for k in counts}
    if counts != expect or n_chunks == 0:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    for k in ('rgbs', 'accs', 'disps'):
        if not np.isfinite(out[k]).all():
            raise AssertionError(f'non-finite {k}')
    if out['accs'].min() < 0. or out['accs'].max() > 1.:
        raise AssertionError('acc outside [0, 1]')
    if out['accs'].max() < 0.5:
        raise AssertionError('empty frames: the checks below would be vacuous')
    n_rays = sum(int((br[0] - tl[0]) * (br[1] - tl[1]))
                 for tl, br in out['bboxes'])
    print(f'{what}: {n_rays} rays in {dt:.3f} s: {n_rays / dt:.1f} rays/s, '
          f'{dt / len(rd["c2ws"]):.3f} s/frame, acc mean '
          f'{out["accs"].mean():.4f} ({gpu_line})')
    profile_frame(renderer, rd)

    # one chunk from the middle of frame 0 against the plain path
    rays, valid, cyl, _ = kp_to_valid_rays(
        rd['c2ws'][:1], H, W, focal, kps=rd['kp3d'][:1], ext_scale=0.001)
    ro, rdir = rays[0]
    mid = max(len(ro) // 2 - chunk // 2, 0)
    sl = slice(mid, mid + chunk)
    C = len(ro[sl])
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    pose = {'kps': t(rd['kp3d'][0]).expand(C, 24, 3),
            'skts': t(rd['skts'][0]).expand(C, 24, 4, 4),
            'bones': t(rd['bones'][0]).expand(C, 24, 3),
            'cyls': t(cyl[0]).expand(C, 5)}
    cam = torch.full((C,), int(rd['cam_idxs'][0]), dtype=torch.long,
                     device=device)
    res = {}
    for backend in ('fused', 'plain'):
        rc_b = dataclasses.replace(renderer.rc, mlp_backend=backend)
        with torch.inference_mode():
            res[backend] = raycaster.render_rays(
                rc_b, renderer.params, t(ro[sl]), t(rdir[sl]), 0., 1., pose,
                renderer.state, cam_idxs=cam)
    for k in ('rgb_map', 'acc_map', 'disp_map', 'rgb0', 'acc0'):
        ref, got = res['plain'][k], res['fused'][k]
        scale = ref.abs().max().item() + 1e-6
        err = (ref - got).abs().max().item()
        print(f'  chunk {k}: max|d| {err:.3e} scale {scale:.3e} '
              f'rel {err / scale:.3e}')
        if err > MAP_TOL * scale:
            raise AssertionError(f'fused path disagrees on {k}')
    return counts


def _profile(what, run, top):
    """Run ``run`` once under torch.profiler; print its wall time, the
    device's busy share, the ``top`` kernels by device time and the host
    calls that wait for the device.  Returns (events, device-ms function)
    or None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = lambda e: getattr(e, 'self_device_time_total',
                            getattr(e, 'self_cuda_time_total', 0)) / 1e3
    # device kernels only: a kernel launched inside an autograd Function
    # also counts as device time of the Function's own event
    events = [e for e in prof.key_averages()
              if dev(e) > 0 and str(e.device_type).endswith('CUDA')]
    busy_ms = sum(dev(e) for e in events)
    if busy_ms == 0:
        print('profile: device time not measured (no CUDA events)')
        return None
    print(f'profile: {what} {wall_ms:.1f} ms wall (profiled), device '
          f'busy {busy_ms:.1f} ms = {busy_ms / wall_ms:.1%}, '
          f'{sum(e.count for e in events)} device kernels and copies')
    for e in sorted(events, key=dev, reverse=True)[:top]:
        print(f'  {dev(e):9.3f} ms {e.count:5d}x  {e.key[:90]}')
    # host calls that wait for the device (each one drains the queue)
    for e in prof.key_averages():
        if 'Synchronize' in e.key or e.key.startswith('cudaMemcpy'):
            print(f'  host {e.key}: {e.count}x, '
                  f'{e.cpu_time_total / 1e3:.1f} ms')
    return events, dev


def profile_frame(renderer, rd):
    """Device time by kernel over one rendered frame."""
    one = {k: (v[:1] if k != 'hwf' else tuple(x[:1] for x in v))
           for k, v in rd.items()}
    _profile('one frame', lambda: renderer.render_path(one), 12)


def train_phase(FE, T, device, gpu_line):
    """25 flagship train steps through the kernels; returns the launch
    counts of the run."""
    import torch
    setup, state, batch, step = T.build_flagship(
        2048, device=device, compute_dtype='bfloat16')
    if setup.rc.mlp_backend != 'fused' or setup.cfg.opt_pose_step != 20:
        raise AssertionError('the flagship setup changed')
    gen = torch.Generator(device=device).manual_seed(0)
    state, _ = step(state, batch, gen)          # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    setup, state, batch, step = T.build_flagship(
        2048, device=device, compute_dtype='bfloat16')
    gen = torch.Generator(device=device).manual_seed(0)
    bank = [state['pose_params']['bones'].clone()]
    losses = []
    FE.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        if i == 5:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if i == TRAIN_STEPS - 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        state, stats = step(state, batch, gen)
        losses.append(stats['total_loss'])
        bank.append(state['pose_params']['bones'].clone())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = FE.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu()
    print(f'train: {TRAIN_STEPS} steps, launches {counts}')
    expect = {k: 0 for k in counts}
    expect.update({k: TRAIN_STEPS for k in ('encmlp_fwd', 'encmlp_dual_fwd',
                                            'encmlp_bwd', 'encmlp_dual_bwd')})
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    if not torch.isfinite(losses).all():
        raise AssertionError(f'non-finite losses {losses.tolist()}')
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    print(f'train: total_loss first 5 {first:.5f}, last 5 {last:.5f}')
    if not last < first:
        raise AssertionError('the loss did not fall')
    moved = [not torch.equal(bank[i + 1], bank[i]) for i in range(TRAIN_STEPS)]
    if any(moved[:19]) or not moved[19]:
        raise AssertionError(f'pose bank moved at steps '
                             f'{[i for i, m in enumerate(moved) if m]}, '
                             'expected first at 19')
    n_timed = TRAIN_STEPS - 5
    print(f'train: {2048 * n_timed / dt:.1f} train rays/s, '
          f'{dt / n_timed * 1e3:.2f} ms/step over steps 5-{TRAIN_STEPS - 1}, '
          f'peak device memory of a step {peak / 2**30:.2f} GiB '
          f'({gpu_line})')
    profile_step(step, state, batch, gen, K1_K4_GROUPS)
    check_backend_grads(setup, state, batch, device, 'train')
    return counts


def check_backend_grads(setup, state, batch, device, what):
    """One step's NeRF gradients, fused against plain backend, on the
    card."""
    import torch
    from anerf_torch.training import trainer as TT
    grads = {}
    for backend in ('fused', 'plain'):
        s2 = dataclasses.replace(setup, rc=dataclasses.replace(
            setup.rc, mlp_backend=backend))
        _, g_nerf, _ = TT.loss_and_grads(
            s2, state, batch, torch.Generator(device=device).manual_seed(3))
        grads[backend] = g_nerf
    names = _leaf_names(state['params'])
    worst = []
    for k, a, b in zip(names, grads['plain'], grads['fused']):
        if a.norm().item() == 0:
            if b.norm().item() != 0:
                raise AssertionError(f'{k}: fused gradient where plain has none')
            continue
        cos, ratio, _, _ = _cmp(a.float(), b.float())
        worst.append((cos, k, ratio))
        if cos < GRAD_COS_MIN or abs(ratio - 1) > GRAD_RATIO_TOL:
            raise AssertionError(f'fused gradient of {k} disagrees with plain:'
                                 f' cos {cos:.5f} ratio {ratio:.4f}')
    worst.sort()
    print(f'{what}: fused vs plain NeRF gradients, {len(worst)} leaves, '
          'worst: ' + ', '.join(f'{k} cos {c:.5f} ratio {r:.4f}'
                                for c, k, r in worst[:3]))


def ms_train_phase(FE, T, device, gpu_line):
    """MS_STEPS multi-subject train steps (``build_flagship(2048,
    n_subjects=2)``) through K5/K6; returns the launch counts of the
    run.  Then the fused-vs-plain gradients of one step, and the
    subject channel reaching the output."""
    import torch
    from anerf_torch.models import raycaster
    from anerf_torch.models.factory import embed_state

    def build():
        return T.build_flagship(2048, n_subjects=2, device=device,
                                compute_dtype='bfloat16')
    setup, state, batch, step = build()
    if setup.rc.mlp_backend != 'fused' or setup.rc.n_subjects != 2:
        raise AssertionError('the multi-subject setup changed')
    gen = torch.Generator(device=device).manual_seed(0)
    state, _ = step(state, batch, gen)          # warm-up
    torch.cuda.synchronize()
    setup, state, batch, step = build()
    gen = torch.Generator(device=device).manual_seed(0)
    losses = []
    FE.reset_launch_counts()
    for i in range(MS_STEPS):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if i == MS_STEPS - 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        state, stats = step(state, batch, gen)
        losses.append(stats['total_loss'])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = FE.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu()
    print(f'multi-subject train: {MS_STEPS} steps, launches {counts}')
    expect = {k: 0 for k in counts}
    expect.update(mlp_fwd=3 * MS_STEPS, mlp_bwd=3 * MS_STEPS)
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    if not torch.isfinite(losses).all():
        raise AssertionError(f'non-finite losses {losses.tolist()}')
    n_timed = MS_STEPS - 2
    print(f'multi-subject train: total_loss {losses[0]:.5f} -> '
          f'{losses[-1]:.5f}; {2048 * n_timed / dt:.1f} train rays/s, '
          f'{dt / n_timed * 1e3:.2f} ms/step over steps 2-{MS_STEPS - 1}, '
          f'peak device memory of a step {peak / 2**30:.2f} GiB '
          f'({gpu_line})')
    profile_step(step, state, batch, gen, K5_K6_GROUPS)
    check_backend_grads(setup, state, batch, device, 'multi-subject train')

    # the same rays as subject 0 and as subject 1: other colors, the
    # same densities (the channel enters the views branch only)
    rc_e = setup.rc.eval_variant()
    pose = {k: batch[k] for k in ('kps', 'skts', 'bones', 'cyls')}
    n = batch['rays_o'].shape[0]
    outs = []
    with torch.inference_mode():
        for subj in (0, 1):
            outs.append(raycaster.render_rays(
                rc_e, state['params'], batch['rays_o'], batch['rays_d'],
                setup.near, setup.far, pose,
                embed_state(setup.cfg, setup.rc, MS_STEPS),
                cam_idxs=batch['cam_idxs'],
                subject_idxs=torch.full((n,), subj, dtype=torch.long,
                                        device=device)))
    d_rgb = (outs[0]['rgb_map'] - outs[1]['rgb_map']).abs().max().item()
    d_alpha = (outs[0]['alpha'] - outs[1]['alpha']).abs().max().item()
    print(f'multi-subject: subject 0 vs 1 on the same rays: rgb max|d| '
          f'{d_rgb:.3e}, alpha max|d| {d_alpha:.3e}')
    if not (d_rgb > 1e-4 and d_alpha <= 1e-6):
        raise AssertionError('the subject channel does not reach the output '
                             'as it should')
    return counts


def _leaf_names(tree, prefix=''):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f'{prefix}{k}.')]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f'{prefix}{i}.')]
    return [] if tree is None else [prefix[:-1]]


# a step's device kernels by the fused kernel they belong to (name
# substrings); K3/K4: their passes, with the dW and bias passes summed
K1_K4_GROUPS = {'K1 encmlp_fwd_kernel<1>': ('encmlp_fwd_kernel<1>',),
                'K2 encmlp_fwd_kernel<2>': ('encmlp_fwd_kernel<2>',),
                'K3 passes <1>': ('kernel<1>',),
                'K4 passes <2>': ('kernel<2>',),
                'K3+K4 dw_kernel, bias_kernel': ('dw_kernel', 'bias_kernel')}
K5_K6_GROUPS = {'K5 mlp_fwd_kernel': ('mlp_fwd_kernel',),
                'K6 mlp_bwd_tile_kernel': ('mlp_bwd_tile_kernel',),
                'K6 dx_kernel': ('dx_kernel',),
                'K6 dw_kernel, bias_kernel': ('dw_kernel', 'bias_kernel')}


def profile_step(step, state, batch, gen, groups):
    """Device time by kernel over one train step, and each group's share
    of it."""
    res = _profile('one train step', lambda: step(state, batch, gen), 15)
    if res is None:
        return
    events, dev = res
    for g, keys in groups.items():
        ms = sum(dev(e) for e in events if any(k in e.key for k in keys)
                 and not ('encmlp_fwd' in e.key and 'encmlp_fwd' not in g))
        print(f'  {g}: {ms:.3f} ms')


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from anerf_torch import testing_utils as T
    from anerf_torch.interop import params_to
    from anerf_torch.models.factory import (build_raycast_config,
                                            init_raycaster_params)
    from anerf_torch.ops import fused_encmlp as FE
    from anerf_torch.ops import fused_mlp as FM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu_line = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(gpu_line)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}')
    build_s = FE.build_kernels(verbose=True)
    print(f'kernel build: {build_s:.1f} s')

    device = torch.device('cuda')
    cfg = T.surreal_config(compute_dtype='bfloat16')
    rc = build_raycast_config(cfg, n_framecodes=9)
    if rc.mlp_backend != 'fused':
        raise AssertionError(f'the recipe maps to {rc.mlp_backend!r}')
    # seed 1: its random density is positive inside the subject's
    # cylinder (seed 0's is negative everywhere and renders empty frames)
    params = params_to(init_raycaster_params(
        torch.Generator().manual_seed(1), rc, cfg), device)
    peaks = _peaks(torch.cuda.get_device_name(0))

    # the two-subject model (the subject channel on the views branch):
    # seed 4, whose fine net's random density is positive inside the
    # cylinder (seed 1's is not: the extra views row shifts its draws)
    rc2 = build_raycast_config(cfg, n_framecodes=9, n_subjects=2)
    params2 = params_to(init_raycaster_params(
        torch.Generator().manual_seed(4), rc2, cfg), device)

    rows = kernel_phase(FE, T, rc, cfg, params, peaks, device)
    rows += bwd_kernel_phase(FE, T, rc, cfg, params, peaks, device)
    rows += split_mlp_phase(FM, T, cfg, rc2, params2, peaks, device)
    paths = {'render': path_phase(FE, T, rc, cfg, params, device, gpu_line,
                                  {'encmlp_fwd': 1, 'encmlp_dual_fwd': 1}),
             'train': train_phase(FE, T, device, gpu_line),
             'ms_render': path_phase(FE, T, rc2, cfg, params2, device,
                                     gpu_line, {'mlp_fwd': 3}, n_bullet=1,
                                     what='multi-subject path'),
             'ms_train': ms_train_phase(FE, T, device, gpu_line)}
    # each kernel's main path: the flagship train step for K1-K4, the
    # multi-subject train step for K5/K6
    main_path = {'mlp_fwd': 'ms_train', 'mlp_bwd': 'ms_train'}
    for row in rows:
        row['launches'] = paths[main_path.get(row['name'], 'train')][
            row['name']]
        row['launches_by_path'] = {k: v[row['name']] for k, v in
                                   paths.items()}
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
