#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the fused encode+MLP kernels from ``anerf_torch/csrc`` with nvcc
(sm_90a), then:

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
   seconds per step, peak device memory and a profile of one step.

Prints the card (nvidia-smi name and power limit), a ``kernels`` JSON
line, and as its last line ``{"ok": true, "device": {...}}``.  Any
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
               shape):
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
                replaces=f'anerf_tpu/ops/pallas_encmlp.py:{tpu_line}',
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
    import torch
    from anerf_torch.ops import compositing
    st, est, p, enc, codes, cutoff, tau, flats = ins
    S = est.S
    R = p.shape[0] // S
    if nnet == 2:
        outs = FE.encmlp_dual_fwd_plain(st, est, p, enc, *codes, cutoff, tau,
                                        *flats)
    else:
        outs = [FE.encmlp_fwd_plain(st, est, p, enc, codes[1], cutoff, tau,
                                    flats[1])]
    raws = [o.detach().requires_grad_(True) for o in outs]
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


def path_phase(FE, T, rc, cfg, params, device, gpu_line, H=512,
               chunk=4096):
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
                         rest, selected_idxs=[0], n_bullet=3)
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
    print(f'path: {len(rd["c2ws"])} frames {H}x{W}, {n_chunks} chunks, '
          f'launches {counts}')
    if not (counts['encmlp_fwd'] == counts['encmlp_dual_fwd'] == n_chunks
            and n_chunks > 0):
        raise AssertionError(f'launch counts {counts} != chunks {n_chunks}')
    for k in ('rgbs', 'accs', 'disps'):
        if not np.isfinite(out[k]).all():
            raise AssertionError(f'non-finite {k}')
    if out['accs'].min() < 0. or out['accs'].max() > 1.:
        raise AssertionError('acc outside [0, 1]')
    if out['accs'].max() < 0.5:
        raise AssertionError('empty frames: the checks below would be vacuous')
    n_rays = sum(int((br[0] - tl[0]) * (br[1] - tl[1]))
                 for tl, br in out['bboxes'])
    print(f'path: {n_rays} rays in {dt:.3f} s: {n_rays / dt:.1f} rays/s, '
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
    import dataclasses as dc
    import torch
    from anerf_torch.training import trainer as TT
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
    if any(v != TRAIN_STEPS for v in counts.values()):
        raise AssertionError(f'launch counts {counts} != {TRAIN_STEPS} each')
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
    profile_step(step, state, batch, gen)

    # one step's NeRF gradients, fused against plain, on the card
    grads = {}
    for backend in ('fused', 'plain'):
        s2 = dc.replace(setup, rc=dc.replace(setup.rc, mlp_backend=backend))
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
    print(f'train: fused vs plain NeRF gradients, {len(worst)} leaves, '
          'worst: ' + ', '.join(f'{k} cos {c:.5f} ratio {r:.4f}'
                                for c, k, r in worst[:3]))
    return counts


def _leaf_names(tree, prefix=''):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f'{prefix}{k}.')]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f'{prefix}{i}.')]
    return [] if tree is None else [prefix[:-1]]


def profile_step(step, state, batch, gen):
    """Device time by kernel over one train step, and each of K1-K4's
    share of it (K3/K4: their passes, the dW and bias passes summed)."""
    res = _profile('one train step', lambda: step(state, batch, gen), 15)
    if res is None:
        return
    events, dev = res
    groups = {'K1 encmlp_fwd_kernel<1>': ('encmlp_fwd_kernel<1>',),
              'K2 encmlp_fwd_kernel<2>': ('encmlp_fwd_kernel<2>',),
              'K3 passes <1>': ('kernel<1>',), 'K4 passes <2>': ('kernel<2>',),
              'K3+K4 dw_kernel, bias_kernel': ('dw_kernel', 'bias_kernel')}
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

    rows = kernel_phase(FE, T, rc, cfg, params, peaks, device)
    rows += bwd_kernel_phase(FE, T, rc, cfg, params, peaks, device)
    paths = {'render': path_phase(FE, T, rc, cfg, params, device, gpu_line),
             'train': train_phase(FE, T, device, gpu_line)}
    for row in rows:
        # the train step is the main path; the render path launches K1/K2
        row['launches'] = paths['train'][row['name']]
        row['launches_by_path'] = {k: v[row['name']] for k, v in
                                   paths.items()}
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
