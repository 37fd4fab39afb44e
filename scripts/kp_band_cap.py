#!/usr/bin/env python3
"""How far the double-angle band recurrence holds, band count by band count.

    JAX_PLATFORMS=cpu python3 scripts/kp_band_cap.py [--bands 10 11 ...]
        [--skip-a] [--skip-b] [--seeds 0 1 ...] [--rays 8]

The fused encode (anerf_tpu's ``pallas_encmlp``, the port's K1-K4 and
their plain twins) builds the kp bands 2^0 .. 2^(F-1) from one sine and
cosine by ``s, c = 2 s c, 1 - 2 s^2``; each band doubles the f32
rounding of the last.  For each band count F (``multires = F`` over the
SURREAL recipe) this prints, on the CPU:

(a) anerf_tpu's fused render (the Pallas kernels in interpret mode)
    against its own XLA path, as ``tests/test_pallas_encmlp.py`` holds
    them: 8 rays, seed 0, the worst of rgb_map, acc_map, rgb0, acc0 and
    disp_map as max |d| / (max |ref| + 1e-6), its bar 1e-3;
(b) the port's twins against anerf_tpu's Pallas kernels in interpret
    mode on the same seed-made parameters (the scenes of
    ``tests/test_torch_encmlp_shapes.py``, viewfac off: parameters,
    poses and rays drawn from each of ``--seeds``, 0 by default, at
    ``--rays`` rays, 8 by default, as the test files take), forward (K2's
    twin at S=64, K1's at S=16: each raw channel's mean and max |d| /
    scale, the flagship's bars 1e-3 and 2e-2, the test files' 1e-4 and
    1e-2) and backward (K3's twin at S=16 and K4's at S=64 on an N(0, 1)
    raw cotangent: every output's gradient cosine, its bar 0.9999, and
    the worst norm ratio, its bar 5e-3).

The port's gate (``fused_encmlp.KERNEL_NF``) is lifted for the run, so
band counts past it reach the twins.  A line ``F ... ok`` means every
bar of that reading holds.

    python3 scripts/kp_band_cap.py --card [--bands 13 14] [--widths 256 512]

(c) on the card: K1-K4 at ``multires = F`` over the SURREAL recipe, two
8 x W nets, against their twins at the flagship's bars, as
``chip_smoke.enc_shape_check`` runs them (its weights, R=2048, K2/K4 at
S=64 and K1/K3 at S=16, K3/K4 on the composited cotangent): each raw
channel's max and mean |d| / scale within ``chip_smoke.RAW_MAX_TOL``
and ``RAW_MEAN_TOL``, every backward output's cosine and norm ratio
within ``BWD_COS_MIN`` and ``BWD_RATIO_TOL`` (``_check_close``,
``_check_bwd``; printed, not raised).  Then K1's bf16 trunk input
against the twin's, bit for bit (``chip_smoke.trunk_input_bits``): the
share of entries that differ, in all and in the distance, each band's
and the bone columns.  Past F_MAX the libraries are built from a copy
of the sources whose cap (``encmlp_common.cuh`` F_MAX) is raised to
the largest F.  Prints the card's name and power limit.

    python3 scripts/kp_band_cap.py --encode [--bands ...]

The recurrence alone, in f32 with each operation rounded in the twins'
(and the kernels') order, against the exact sine of each band
(float64) over 2,000,000 distances drawn uniformly from [0, 2) (seed
0): per band, the worst |error| and the share of entries off by more
than one bf16 step at 1 (2^-8).

    python3 scripts/kp_band_cap.py --render [--bands ...] [--rays 2048]
        [--seeds 1 3]

The port's render at ``multires = F``: ``build_flagship``'s recipe and
weights (``--seeds``), an eval chunk of ``--rays`` rays on the CPU
through three routes: the fused twins (the recurrence), the plain
backend and the split route (the plain encode's exact sines, then
K5's twin); per pair and map, max |d| / scale over the chunk and the
rays past 1e-3 of the scale (the render tests' bar), for disp_map also
on the rays whose acc reaches 1e-3 on both sides.  The two exact
routes' distance is the floor two f32 evaluations of the model give.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]
os.environ.setdefault('JAX_PLATFORMS', 'cpu')   # (a) and (b) only


def reading_a(F):
    """(a): anerf_tpu's fused render against its XLA path at F bands:
    the worst map's max |d| / scale and its name."""
    import numpy as np
    from test_pallas_encmlp import build, render
    rc, params, batch, est, pose = build(multires=F)
    a = render(rc, params, batch, est, pose, 'xla')
    b = render(rc, params, batch, est, pose, 'pallas')
    worst = []
    for k in ('rgb_map', 'acc_map', 'rgb0', 'acc0', 'disp_map'):
        ref, got = np.asarray(a[k]), np.asarray(b[k])
        worst.append((float(np.max(np.abs(ref - got))
                            / (np.abs(ref).max() + 1e-6)), k))
    return max(worst)


def _raw_dist(ref, got):
    """The worst channel's mean and max |d| / max |ref| of raw (4, R, S)."""
    import numpy as np
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    means, maxes = [], []
    for c in range(ref.shape[0]):
        d = np.abs(ref[c] - got[c]) / (np.abs(ref[c]).max() + 1e-6)
        means.append(d.mean())
        maxes.append(d.max())
    return max(means), max(maxes)


def _cos_ratio(a, b):
    import numpy as np
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    na = np.linalg.norm(a)
    return (float(a @ b / (na * np.linalg.norm(b) + 1e-30)),
            float(abs(np.linalg.norm(b) / na - 1.)))


def reading_b(F, seed=0, rays=8):
    """(b): the port's twins against anerf_tpu's Pallas kernels in
    interpret mode at F bands on the scene of ``seed`` and ``rays``
    rays: {'fwd64'/'fwd16': (mean, max), 'bwd16'/'bwd64': (min cosine,
    worst ratio)}."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from anerf_tpu.ops import pallas_encmlp as PE
    from anerf_torch.ops import fused_encmlp as FE
    import test_torch_encmlp_shapes as TS
    from test_torch_fused_bwd import _leaf, _operands
    from test_torch_fused_encmlp import _pts_cm

    name = f'cap_nf{F}'
    TS.SHAPES[name] = (dict(multires=F), (F, 9, False, 8, 256, 16))
    s = TS.shape_scene(name, seed, rays)
    out = {}
    tau = 21.9
    jp, tp = s['j_params'], s['t_params']
    for S in (64, 16):
        pts = _pts_cm(s['batch'], S)
        cam = s['batch']['cam_idxs']
        jargs = (jnp.asarray(pts), jnp.asarray(s['rays_t_norm']),
                 jp['cutoff_dist'], tau, jnp.asarray(cam))
        targs = (torch.as_tensor(pts), torch.as_tensor(s['rays_t_norm']),
                 tp['cutoff_dist'], tau, torch.as_tensor(cam))
        if S == 64:
            ref = PE.nerf_encmlp_dual_pallas(jp['coarse'], jp['fine'],
                                             s['j_rc'], *jargs,
                                             interpret=True, cm=True)
            got = FE.nerf_encmlp_dual(tp['coarse'], tp['fine'], s['t_rc'],
                                      *targs)
        else:
            ref = (PE.nerf_encmlp_pallas(jp['fine'], s['j_rc'], *jargs,
                                         interpret=True, cm=True),)
            got = (FE.nerf_encmlp(tp['fine'], s['t_rc'], *targs),)
        out[f'fwd{S}'] = tuple(max(v) for v in zip(
            *[_raw_dist(a, b) for a, b in zip(ref, got)]))

        nnet = 2 if S == 64 else 1
        jops, tops = _operands(s, S)
        st_j, est_j, p_j, enc_j, c_j, cut_j, tau_j, f_j = jops
        st_t, est_t, p_t, enc_t, c_t, cut_t, tau_t, f_t = tops
        n = p_j.shape[0]
        g = np.random.RandomState(3 + seed).normal(size=(nnet, 4, n)).astype(
            np.float32)
        tf = jnp.zeros((1, 1), jnp.float32)
        if nnet == 2:
            fn = lambda p, e, cc, cf, fc, ff: PE._fused_dual(
                st_j, est_j, p, e, tf, cc, cf, cut_j, tau_j, fc, ff)
            _, vjp = jax.vjp(fn, p_j, enc_j, c_j[0], c_j[1], f_j[0], f_j[1])
            dp, denc, dcc, dcf, dfc, dff = vjp((jnp.asarray(g[0]),
                                                jnp.asarray(g[1])))
            ref = [dp, denc, dcc, dcf] + dfc + dff
        else:
            fn = lambda p, e, c, f: PE._fused(st_j, est_j, p, e, tf, c,
                                              cut_j, tau_j, f)
            _, vjp = jax.vjp(fn, p_j, enc_j, c_j[1], f_j[1])
            dp, denc, dc, df = vjp(jnp.asarray(g[0]))
            ref = [dp, denc, dc] + df
        p, enc = _leaf(p_t), _leaf(enc_t)
        cs = [_leaf(c) for c in c_t]
        flats = [[_leaf(w) for w in f] for f in f_t]
        if nnet == 2:
            outs = FE.encmlp_dual_fwd(st_t, est_t, p, enc, cs[0], cs[1],
                                      cut_t, tau_t, flats[0], flats[1])
            ins = [p, enc] + cs + flats[0] + flats[1]
        else:
            outs = (FE.encmlp_fwd(st_t, est_t, p, enc, cs[1], cut_t, tau_t,
                                  flats[1]),)
            ins = [p, enc, cs[1]] + flats[1]
        got = torch.autograd.grad(outs, ins, [torch.as_tensor(x) for x in g])
        crs = [_cos_ratio(np.asarray(a, np.float32), b.float().numpy())
               for a, b in zip(ref, got)]
        out[f'bwd{S}'] = (min(c for c, _ in crs), max(r for _, r in crs))
    return out


def _raised_cap(FE, F):
    """A copy of ``anerf_torch/csrc`` under ``_build/`` whose kp band cap
    is ``F``; returns its directory."""
    import shutil
    import tempfile
    build = FE.cuda_build._BUILD_DIR
    os.makedirs(build, exist_ok=True)
    d = os.path.join(tempfile.mkdtemp(dir=build), 'csrc')
    shutil.copytree(FE.cuda_build._CSRC, d)
    path = os.path.join(d, 'encmlp_common.cuh')
    with open(path) as f:
        text = f.read()
    old = f'constexpr int F_MAX = {FE.F_MAX};'
    if old not in text:
        raise RuntimeError(f'anchor not in encmlp_common.cuh: {old!r}')
    with open(path, 'w') as f:
        f.write(text.replace(old, f'constexpr int F_MAX = {F};'))
    return d


def reading_c(C, T, FE, F, width):
    """(c) at F bands and two 8 x ``width`` nets: prints each kernel's
    worst readings against its twin and whether the flagship's bars
    hold, then K1's trunk input bits."""
    import torch
    device = torch.device('cuda')
    over = dict(multires=F)
    if width != 256:
        over.update(netwidth=width, netwidth_fine=width)
    name = f'nf{F}' + ('' if width == 256 else f'_w{width}')
    cfg, rc, params, plan = C.enc_shape_model(FE, T, name, over, None,
                                              device)
    for S, nnet in plan:
        (fwd, fplain), (bwd, bplain), ins = C._enc_shape_calls(
            FE, T, rc, cfg, params, S, nnet, device, False)
        got, ref = fwd(), fplain()
        errs = [e for r, g in zip(ref, got) for e in C._rel_err(r, g)]
        mx, mn = max(e[0] for e in errs), max(e[1] for e in errs)
        f_ok = (mx <= C.RAW_MAX_TOL and mn <= C.RAW_MEAN_TOL
                and all(torch.isfinite(g).all() for g in got))
        del got, ref
        kb, tb = bwd(), bplain()
        rows = sorted((C._cmp(r, g)[:2] + (k,))
                      for (k, r), (_, g) in zip(tb, kb))
        cos = rows[0][0]
        ratio = max(abs(r[1] - 1) for r in rows)
        b_ok = cos >= C.BWD_COS_MIN and ratio <= C.BWD_RATIO_TOL
        del kb, tb
        kf = 'K2' if nnet == 2 else 'K1'
        kbn = 'K4' if nnet == 2 else 'K3'
        print(f'F {F} (c) {name} S={S}: {kf} max|d|/scale {mx:.3e} mean '
              f'{mn:.3e} ({"ok" if f_ok else "FAILS"}); {kbn} worst cos '
              f'{cos:.7f} ({rows[0][2]}) ratio |r-1| {ratio:.2e} '
              f'({"ok" if b_ok else "FAILS"})', flush=True)
        if S == 16:
            bits = C.trunk_input_bits(FE, ins)
            if bits is None:
                print(f'F {F} {name}: the trunk input stays in shared memory')
            else:
                print(f'F {F} {name} S=16: K1\'s trunk input against the '
                      f'twin\'s, share of bf16 entries that differ: '
                      + ', '.join(f'{k} {v:.3e}' for k, v in bits.items()),
                      flush=True)
        del ins
        torch.cuda.empty_cache()


def card(a) -> int:
    import subprocess
    import torch
    import chip_smoke as C
    from anerf_torch import testing_utils as T
    from anerf_torch.ops import fused_encmlp as FE
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    FE.KERNEL_NF = range(1, max(a.bands) + 1)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    keys = {F: [C.enc_shape_key(FE, T, dict(multires=F, **(
        {} if w == 256 else dict(netwidth=w, netwidth_fine=w))))
        for w in a.widths] for F in a.bands}
    FE.build_kernels(enc_shapes=[k for F in a.bands if F <= FE.F_MAX
                                 for k in keys[F]])
    past = [k for F in a.bands if F > FE.F_MAX for k in keys[F]]
    if past:
        FE.cuda_build._CSRC = _raised_cap(FE, max(a.bands))
        print(f'the builds past {FE.F_MAX} bands from a copy of the '
              f'sources with the cap at {max(a.bands)} bands')
        FE.build_kernels(enc_shapes=past)
    for F in a.bands:
        for w in a.widths:
            reading_c(C, T, FE, F, w)
    return 0


def encode_errors(bands):
    """``--encode``: prints each band's recurrence error."""
    import numpy as np
    d = np.random.RandomState(0).uniform(0, 2, 2_000_000).astype(np.float32)
    s = np.sin(d)
    c = np.sin(d + np.float32(np.pi / 2))
    two, one = np.float32(2), np.float32(1)
    with np.errstate(over='ignore', invalid='ignore'):
        for k in range(1, max(bands) + 1):
            if k > 1:
                s, c = (two * s) * c, one - (two * s) * s
            err = np.abs(s.astype(np.float64)
                         - np.sin(d.astype(np.float64) * 2. ** (k - 1)))
            err[~np.isfinite(err)] = np.inf
            if k in bands:
                print(f'band {k}: worst |error| {err.max():.3e}, share past '
                      f'a bf16 step (2^-8) {np.mean(err > 2. ** -8):.3e}',
                      flush=True)


def render_routes(F, rays, seed):
    """``--render``: the flagship at F bands through the three routes;
    prints each pair's distances."""
    import contextlib
    import dataclasses
    import torch
    import chip_smoke as C
    from anerf_torch import testing_utils as T
    from anerf_torch.models import raycaster
    from anerf_torch.models.factory import embed_state
    from anerf_torch.ops import fused_encmlp as FE
    setup, state, _, _ = T.build_flagship(
        32, device='cpu', compute_dtype='bfloat16', seed=seed, multires=F)
    rc = setup.rc
    _, bones, _, kps, skts, cyls = T.synthetic_pose(
        9, ext_scale=setup.cfg.ext_scale)
    b = T.to_device(T.synthetic_batch(rays, 9, kps, skts, bones, cyls,
                                      seed=1), 'cpu')
    pose = {k: b[k] for k in ('kps', 'skts', 'bones', 'cyls')}
    est = embed_state(setup.cfg, rc, 10000)

    def chunk(backend, split=False):
        with torch.inference_mode(), (
                C._split_route(FE) if split else contextlib.nullcontext()):
            return raycaster.render_rays(
                dataclasses.replace(rc.eval_variant(), mlp_backend=backend),
                state['params'], b['rays_o'], b['rays_d'], setup.near,
                setup.far, pose, est, cam_idxs=b['cam_idxs'])
    res = {'fused': chunk('fused'), 'plain': chunk('plain'),
           'split': chunk('fused', True)}
    for x, y in (('plain', 'split'), ('plain', 'fused'), ('split', 'fused')):
        out = []
        # disp_map also on the rays lit on both sides (chip_smoke's
        # KP_CAP_ACC_MIN): below it disp is a few alpha quanta's mean depth
        lit = ((res[x]['weights'].sum(-1) >= 1e-3)
               & (res[y]['weights'].sum(-1) >= 1e-3))
        for k in ('rgb_map', 'acc_map', 'disp_map', 'rgb0', 'acc0'):
            r = res[x][k]
            scale = r.abs().max().item() + 1e-6
            d = (r - res[y][k]).abs().reshape(rays, -1).amax(1)
            out.append(f'{k} {d.max().item() / scale:.1e} '
                       f'({int((d > 1e-3 * scale).sum())} rays'
                       + (f'; {int((d[lit] > 1e-3 * scale).sum())} of '
                          f'{int(lit.sum())} lit' if k == 'disp_map' else '')
                       + ')')
        print(f'F {F} seed {seed} {x} vs {y}: ' + ', '.join(out), flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--bands', type=int, nargs='+',
                    default=list(range(10, 19)))
    ap.add_argument('--skip-a', action='store_true')
    ap.add_argument('--skip-b', action='store_true')
    ap.add_argument('--card', action='store_true')
    ap.add_argument('--widths', type=int, nargs='+', default=[256, 512])
    ap.add_argument('--encode', action='store_true')
    ap.add_argument('--render', action='store_true')
    ap.add_argument('--rays', type=int, default=None,
                    help='rays: 2048 for --render, 8 for (b)')
    ap.add_argument('--seeds', type=int, nargs='+', default=None,
                    help='seeds: 1 3 for --render, 0 for (b)')
    a = ap.parse_args(argv)
    if a.card:
        return card(a)
    if a.encode:
        encode_errors(a.bands)
        return 0
    import torch
    torch.set_num_threads(1)
    from anerf_torch.ops import fused_encmlp as FE
    FE.KERNEL_NF = range(1, max(a.bands) + 1)
    if a.render:
        for F in a.bands:
            for seed in a.seeds or [1, 3]:
                render_routes(F, a.rays or 2048, seed)
        return 0
    for F in a.bands:
        if not a.skip_a:
            d, k = reading_a(F)
            print(f'F {F} (a) fused vs XLA render: worst {k} {d:.3e} '
                  f'(bar 1e-3) {"ok" if d < 1e-3 else "FAILS"}', flush=True)
        if a.skip_b:
            continue
        for seed in a.seeds or [0]:
            r = reading_b(F, seed, a.rays or 8)
            fl = all(r[k][0] < 1e-3 and r[k][1] < 2e-2
                     for k in ('fwd64', 'fwd16'))
            tests = all(r[k][0] < 1e-4 and r[k][1] < 1e-2
                        for k in ('fwd64', 'fwd16'))
            bw = all(r[k][0] >= 0.9999 and r[k][1] < 5e-3
                     for k in ('bwd64', 'bwd16'))
            print(f'F {F} (b) seed {seed}, {a.rays or 8} rays: fwd S=64 '
                  f'mean {r["fwd64"][0]:.3e} max {r["fwd64"][1]:.3e}; S=16 '
                  f'mean {r["fwd16"][0]:.3e} max {r["fwd16"][1]:.3e} '
                  f'(flagship bars {"ok" if fl else "FAIL"}, test bars '
                  f'{"ok" if tests else "FAIL"}); bwd S=16 cos '
                  f'{r["bwd16"][0]:.6f} ratio {r["bwd16"][1]:.2e}; S=64 cos '
                  f'{r["bwd64"][0]:.6f} ratio {r["bwd64"][1]:.2e} '
                  f'({"ok" if bw else "FAIL"})', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
