#!/usr/bin/env python3
"""Every kernel K1-K6 of the tree against another build of the same
kernels, bit for bit, and K-vf1/K-vf2 against the other build's at
their twins' bars, timed in turns, on one GPU.

    python3 scripts/compare_builds.py BASE_CSRC_DIR

BASE_CSRC_DIR holds another version of ``anerf_torch/csrc`` (for
instance a parent commit's, unpacked with ``git archive`` into an
ignored directory).  Its libraries are built with nvcc beside the
tree's, at the flagship's trunk width, and, with ``--shapes``, K1-K4's
(and K-vf1/K-vf2's at their view rows) at each named encode shape of
``chip_smoke.ENC_SHAPES`` as well; then each kernel runs on
``chip_smoke.py``'s inputs (K1/K2 at R=4096 with S=16/64, K3/K4 at the
train step's R=2048 with their composited cotangents, K5/K6 on the
two-subject model at n=131,072 and a ragged 4104 points; at each named
shape K1-K4 as ``chip_smoke.enc_shape_check`` runs them, at R=2048)
once with the base's libraries and once with the tree's, and every
output must be bit-identical.  K-vf1 and K-vf2 (``viewfac.cu``) run on
the view rows of the train step (R=2048, and the first 1999 of them)
with Gram matrices drawn from seed 0: the tree's against the twins (M
at ``chip_smoke.vf_m_check``'s bar, dWvx and denc at cosine > 0.9999
and norm ratio within 5e-3, ``chip_smoke._check_bwd``) and against the
base's, bit-identical where the base's build states its view rows
(``viewfac_rows``; before that its sums may run in another order), else
at the same bars, and both builds timed at R=2048 in turns (base, tree, tree,
base; 20 calls replayed from a CUDA graph, the outputs' allocations
included: ``chip_smoke._graph_ms``).  Prints the card's name and power
limit and each output that differs; exits non-zero if any does or a bar
fails.  A base from before the view factorization and the WIDE nets (no
viewfac pointers in K1-K4's C interfaces, no workspace in K5's), from
before the in-kernel rigid transform (no affine-rows pointer in
K1-K4's) or from before K1/K2's trunk-input workspace (no pointer for
it) is called through shims that drop those arguments; the inputs keep
K1-K4 on the dense views input and on points, which every build takes.

    python3 scripts/compare_builds.py BASE_CSRC_DIR --shapes nb1 nb5 ...

(``--shapes all`` takes every one.)

With ``--nets`` (``chip_smoke.NET_SHAPES`` keys such as ``8x1024``) and
``--views`` (``chip_smoke.VIEWS_WIDTHS`` names such as ``1641_w1024``),
K5/K6 are built at those nets and views widths too, and run as
``chip_smoke.net_shapes_phase`` and ``views_kernel_phase`` run them (the
two-subject scene's parts at 4104 and 131,072 points, weights from
their seed rule) with the base's libraries and with the tree's, every
output bit for bit; ``--nets all`` / ``--views all`` take every one.

    python3 scripts/compare_builds.py BASE_CSRC_DIR --nets all --views all

With ``--time`` every call is also timed with each build in turns (base,
tree, tree, base: ``chip_smoke._time_ms``, 3 windows of 3 calls).
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {'fwd': 'encmlp_fwd.cu', 'bwd': 'encmlp_bwd.cu',
           'mlp_fwd': 'mlp_fwd.cu', 'mlp_bwd': 'mlp_bwd.cu',
           'viewfac': 'viewfac.cu'}
# the rays of one K-vf2 slice in a base without viewfac_slice
BASE_VF_SLICE = 64
# the base's nvcc processes at a time
MAX_NVCC = 24


def build_base(csrc, out_dir, keys):
    """{key: loaded CDLL} of the sources in ``csrc`` at each
    ``cuda_build.lib_key`` of ``keys`` (with the flags the tree's build
    of that key takes), one nvcc per library, all started together."""
    from anerf_torch.ops import cuda_build
    procs, logs = {}, {}
    for key in keys:
        which = key[0]
        so = os.path.join(out_dir, f'base_{cuda_build._tag(key)}.so')
        cmd = [cuda_build._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
               '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC', '-o',
               so, os.path.join(csrc, SOURCES[which])]
        cmd[1:1] = cuda_build._shape_flags(key)
        # at most MAX_NVCC compilers at a time: each takes ~1 GB
        running = [k for k, (_, p) in procs.items() if k not in logs]
        if len(running) >= MAX_NVCC:
            logs[running[0]] = procs[running[0]][1].communicate()[0]
        procs[key] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        which = key[0]
        log = logs[key] if key in logs else proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'base {key} failed to build:\n{log}')
        lib = ctypes.CDLL(so)
        if which.startswith('mlp') and not hasattr(lib, 'mlp_trunk_width'):
            # a build from before K5/K6 took other trunk widths
            lib.mlp_trunk_width = lambda: cuda_build.FLAGSHIP_DX
        if which == 'mlp_fwd' and not hasattr(lib, 'mlp_views_width'):
            # a build from before K5/K6 took other views widths
            lib.mlp_views_width = lambda: cuda_build.FLAGSHIP_XV
        with open(os.path.join(csrc, SOURCES[which])) as f:
            text = f.read()
        if which == 'viewfac':
            if not hasattr(lib, 'viewfac_fold_scratch'):
                # a build from before the views layers past 256: its
                # scratch the dWvx partials alone, (P, nnet, 72 NB, HV)
                nb, hv = (cuda_build.FLAGSHIP_VF if key[1] is None
                          else key[2:])
                lib.viewfac_fold_scratch = (
                    lambda R, nnet, P, per=72 * nb * hv:
                    P * nnet * per if P > 1 else 0)
            vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.viewfac_m.argtypes = [vp, vp, vp, ci, ci, vp]
            lib.viewfac_fold.argtypes = [vp, vp, vp, vp, cll, vp, vp] + \
                [ci] * 4 + [vp]
            lib.viewfac_m.restype = lib.viewfac_fold.restype = ci
        elif which in ('fwd', 'bwd') and 'tfab' not in text:
            lib = _Shim(lib, which, has_vf='vfM' in text)
        elif which == 'fwd' and 'xwork' not in text:
            lib = _Shim(lib, which, has_vf=True, has_tf=True)
        elif which == 'mlp_fwd' and 'workspace' not in text:
            lib = _Shim(lib, which)
        else:
            cuda_build._bind(lib, which)
        libs[key] = lib
    return libs


class _Shim:
    """A base library with an older C interface, called as the tree's
    wrappers call the tree's: the arguments the base does not take are
    dropped (they are null or unused on the dense path).  K1-K4: a base
    without K1/K2's trunk-input workspace, unless ``has_tf`` without the
    affine-rows pointer, and unless ``has_vf`` without viewfac's
    pointers."""

    def __init__(self, lib, which, has_vf=False, has_tf=False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self._lib = lib

        def fn(name, args, res, drop):
            f = getattr(lib, name)
            f.argtypes, f.restype = args, res
            setattr(self, name, lambda *a: f(*[x for i, x in enumerate(a)
                                                 if i not in drop]))
        if which == 'fwd':
            drop = {9} | (set() if has_tf else {8}) | (
                set() if has_vf else {7})
            for name in ('encmlp_fwd', 'encmlp_dual_fwd'):
                fn(name, [vp] * (11 - len(drop)) + [ci] * 3 + [vp], ci, drop)
            fn('encmlp_weight_elems', [], cll, ())
            fn('encmlp_bias_elems', [], ci, ())
            self.encmlp_fwd_workspace_bytes = lambda n: 0
        elif which == 'bwd':
            drop = {18} if has_vf else {16, 17, 18}
            for name in ('encmlp_bwd', 'encmlp_dual_bwd'):
                fn(name, [vp] * (19 - len(drop)) + [ci] * 5 + [vp], ci, drop)
            fn('encmlp_bwd_workspace_bytes', [ci, ci], cll, ())
            fn('encmlp_grad_weight_elems', [], cll, ())
        else:
            fn('mlp_fwd', [vp, vp, ci, vp, vp, ci, vp, vp, vp, ci, vp], ci,
               {8})
            self.mlp_fwd_workspace_bytes = lambda n: 0
            fn('mlp_weight_elems', [], cll, ())
            fn('mlp_bias_elems', [], ci, ())
            for name in ('mlp_trunk_width', 'mlp_net_depth',
                         'mlp_net_width'):
                fn(name, [], ci, ())


def _vf_calls(lib, est, enc, wvx, gw):
    """(K-vf1, K-vf2) of one build as closures on the same inputs, each
    returning its named outputs: M, and dWvx and denc on the build's
    plan (``vf_fold_plan`` where the build names its slice, else
    BASE_VF_SLICE rays a slice, one partial each)."""
    import torch
    from anerf_torch.ops import cuda_build
    from anerf_torch.ops import fused_encmlp as FE
    nnet, R, nbJ = wvx.shape[0], enc.shape[0], enc.shape[1]
    HV, dev = wvx.shape[-1], enc.device
    if hasattr(lib, 'viewfac_slice'):
        P, slice_ = FE.vf_fold_plan(R)
    else:
        P, slice_ = -(-R // BASE_VF_SLICE), BASE_VF_SLICE
    stream = lambda: cuda_build.stream(dev)

    def m():
        M = torch.empty((nnet, R, est.J, HV), dtype=torch.bfloat16,
                        device=dev)
        err = lib.viewfac_m(enc.data_ptr(), wvx.data_ptr(), M.data_ptr(), R,
                            nnet, stream())
        if err:
            raise RuntimeError(f'viewfac_m: cudaError {err}')
        return [('M', M)]

    def fold():
        f32 = dict(dtype=torch.float32, device=dev)
        dw = torch.empty((nnet, nbJ, HV), **f32)
        denc = torch.empty((R, nbJ), **f32)
        part = torch.empty((P, nnet, nbJ, HV), **f32)
        err = lib.viewfac_fold(gw.data_ptr(), enc.data_ptr(), wvx.data_ptr(),
                               dw.data_ptr(), nbJ * HV, denc.data_ptr(),
                               part.data_ptr(), P, slice_, R, nnet, stream())
        if err:
            raise RuntimeError(f'viewfac_fold: cudaError {err}')
        return [('dWvx', dw), ('denc', denc)]
    return m, fold


def compare_viewfac(C, FE, T, rc, cfg, params, base, tree, dev) -> int:
    """K-vf1/K-vf2 of the base and the tree at R=2048 and 1999: each
    against the twins and the other build at the twins' bars (and bit for
    bit where the base states its views width), then timed in turns at
    R=2048.  Returns the number of failed checks."""
    import torch
    ins = C.kernel_inputs(FE, T, rc, cfg, params, 64, 2048, dev, tile=512)
    est, enc_all, wvx = ins[1], ins[3], FE._wvx(ins[0], ins[7])
    failed = 0
    for R in (2048, 1999):
        enc = enc_all[:R].contiguous()
        gw = torch.randn((2, R, est.J, wvx.shape[-1]), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0)
                         ).to(torch.bfloat16)
        twin = [[('M', FE.vf_operand_plain(est, enc, wvx))],
                list(zip(('dWvx', 'denc'), FE.vf_fold_plain(est, gw, enc,
                                                            wvx)))]
        outs = {k: [f() for f in _vf_calls(lib, est, enc, wvx, gw)]
                for k, lib in (('base', base), ('tree', tree))}
        torch.cuda.synchronize()
        if hasattr(base, 'viewfac_rows'):
            bad = [k for (k, a), (_, b) in zip(
                outs['base'][0] + outs['base'][1],
                outs['tree'][0] + outs['tree'][1]) if not torch.equal(a, b)]
            print(f'R={R} K-vf1/K-vf2: ' + (
                f'FAILED {bad} differ from the base build' if bad else
                'M, dWvx, denc bit-identical to the base build'))
            failed += len(bad)
        for which, ref in (('twin', twin), ('base', outs['base'])):
            for kernel, a, b in zip(('K-vf1', 'K-vf2'), ref, outs['tree']):
                what = f'R={R} {kernel}: tree against {which}'
                try:
                    if kernel == 'K-vf1':
                        C.vf_m_check(what, est, enc, wvx, b[0][1], a[0][1])
                    else:
                        print(what + ':')
                        C._check_bwd(what, a, b)
                except AssertionError as e:
                    print(f'FAILED {e}')
                    failed += 1
        print(f'R={R} K-vf2: base against twin (for reference):')
        try:
            C._check_bwd('base K-vf2', twin[1], outs['base'][1])
        except AssertionError as e:
            print(f'  the base misses the bars: {e}')
    enc = enc_all
    gw = torch.randn((2, 2048, est.J, wvx.shape[-1]), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0)
                     ).to(torch.bfloat16)
    calls = {k: _vf_calls(lib, est, enc, wvx, gw)
             for k, lib in (('base', base), ('tree', tree))}
    for i, kernel in enumerate(('K-vf1', 'K-vf2')):
        t = [C._graph_ms(calls[k][i], 20) for k in ('base', 'tree', 'tree',
                                                   'base')]
        print(f'{kernel} R=2048 two nets, in turns: base {t[0]:.4f} ms, '
              f'tree {t[1]:.4f}, tree {t[2]:.4f}, base {t[3]:.4f}',
              flush=True)
    return failed


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('base_csrc')
    ap.add_argument('--shapes', nargs='*', default=[],
                    help='chip_smoke.ENC_SHAPES names to compare K1-K4 at, '
                    'or all')
    ap.add_argument('--nets', nargs='*', default=[],
                    help='chip_smoke.NET_SHAPES keys (DxW) to compare K5/K6 '
                    'at, or all')
    ap.add_argument('--views', nargs='*', default=[],
                    help='chip_smoke.VIEWS_WIDTHS names to compare K5/K6 '
                    'at, or all')
    ap.add_argument('--time', action='store_true',
                    help='also time every call with each build, in turns')
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from anerf_torch import testing_utils as T
    from anerf_torch.interop import params_to
    from anerf_torch.models.factory import (build_raycast_config,
                                            init_raycaster_params)
    from anerf_torch.ops import cuda_build
    from anerf_torch.ops import fused_encmlp as FE
    from anerf_torch.ops import fused_mlp as FM
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = list(C.ENC_SHAPES) if args.shapes == ['all'] else args.shapes
    enc = {name: C.enc_shape_key(FE, T, C.ENC_SHAPES[name][0])
           for name in shapes}
    nets = (list(C.NET_SHAPES) if args.nets == ['all'] else
            [tuple(int(x) for x in k.split('x')) for k in args.nets])
    views = (list(C.VIEWS_WIDTHS) if args.views == ['all'] else args.views)
    # K5/K6's builds (trunk width, depth, compiled width[, views width]),
    # as chip_smoke.main builds them
    split = {f'{d}x{w}': (432, d, FM.kernel_static(FM.MLPStatic(
        d, w, (432,), (665,), w // 2, (4,))).width) for d, w in nets}
    split.update({name: (432, 8, C.VIEWS_WIDTHS[name][1].get('netwidth',
                                                             256),
                         FM.views_pad(int(name.split('_')[0])))
                  for name in views})
    cuda_build.build_kernels(enc_shapes=enc.values())
    cuda_build.build_kernels(shapes=split.values())
    keys = [cuda_build.lib_key(w) for w in SOURCES]
    for shape in split.values():
        keys += [cuda_build.lib_key(w, *shape[:3], xv=shape[3] if
                                    len(shape) > 3 else cuda_build.FLAGSHIP_XV)
                 for w in ('mlp_fwd', 'mlp_bwd')]
    for shape in enc.values():
        keys += [cuda_build.lib_key(w, enc=shape) for w in ('fwd', 'bwd')]
        keys.append(cuda_build.lib_key('viewfac', enc=(shape[1],
                                                       shape[4] // 2)))
    keys = list(dict.fromkeys(keys))
    tree = {k: cuda_build._LIBS[k] for k in keys}
    vf_key = cuda_build.lib_key('viewfac')
    os.makedirs(os.path.join(ROOT, 'anerf_torch', '_build'), exist_ok=True)
    base = build_base(os.path.join(ROOT, args.base_csrc), tempfile.mkdtemp(
        dir=os.path.join(ROOT, 'anerf_torch', '_build')), keys)
    dev = torch.device('cuda')
    cfg = T.surreal_config(compute_dtype='bfloat16')
    rc = build_raycast_config(cfg, n_framecodes=9)
    params = params_to(init_raycaster_params(
        torch.Generator().manual_seed(1), rc, cfg), dev)
    rc2 = build_raycast_config(cfg, n_framecodes=9, n_subjects=2)
    params2 = params_to(init_raycaster_params(
        torch.Generator().manual_seed(4), rc2, cfg), dev)
    failed = compare_viewfac(C, FE, T, rc, cfg, params, base[vf_key],
                             tree[vf_key], dev)
    del base[vf_key], tree[vf_key]
    runs = {}
    for name, S, nnet, R in (('encmlp_fwd', 16, 1, 4096),
                             ('encmlp_dual_fwd', 64, 2, 4096)):
        ins = C.kernel_inputs(FE, T, rc, cfg, params, S, R, dev)
        runs[name] = lambda ins=ins, nnet=nnet: C._named(
            C._calls(FE, *ins, nnet)[0]())
    for name, S, nnet in (('encmlp_dual_bwd', 64, 2), ('encmlp_bwd', 16, 1)):
        ins = C.kernel_inputs(FE, T, rc, cfg, params, S, 2048, dev)
        g = C._composited_cotangent(FE, ins, nnet, dev)
        runs[name] = C._bwd_calls(FE, *ins, g, nnet)[0]
    for R, S in ((171, 24), (2048, 64)):
        st, xs, xvs, flat = C.split_inputs(FM, T, cfg, rc2, params2, R, S,
                                           dev)
        runs[f'mlp_fwd n={R * S}'] = lambda a=(st, xs, xvs, flat): C._named(
            C._split_calls(FM, *a)[0]())
        g = C._split_cotangent(FM, st, xs, xvs, flat, S, dev)
        runs[f'mlp_bwd n={R * S}'] = C._split_calls(FM, st, xs, xvs, flat,
                                                    g)[0]
    for key in split:    # K5/K6 at the nets and views widths
        if key in views:
            ns, over = C.VIEWS_WIDTHS[key]
            cfg_s, rc_s, params_s = C._views_model(FM, T, dev, key, ns, over)
            cat = False
        else:
            depth, width = (int(x) for x in key.split('x'))
            cfg_s, rc_s, params_s, _, _ = C._net_model(FM, T, dev, depth,
                                                       width)
            cat = True
        for R, S in ((171, 24), (2048, 64)):
            st, xs, xvs, flat = C.split_inputs(FM, T, cfg_s, rc_s, params_s,
                                               R, S, dev, cat_subject=cat)
            runs[f'{key} mlp_fwd n={R * S}'] = \
                lambda a=(st, xs, xvs, flat): C._named(
                    C._split_calls(FM, *a)[0]())
            g = C._split_cotangent(FM, st, xs, xvs, flat, S, dev)
            runs[f'{key} mlp_bwd n={R * S}'] = C._split_calls(
                FM, st, xs, xvs, flat, g)[0]
    for name, shape in enc.items():
        over, tf, samples = C.ENC_SHAPES[name]
        cfg_s, rc_s, params_s, plan = C.enc_shape_model(FE, T, name, over,
                                                        samples, dev)
        for S, nnet in plan:
            (fwd, _), (bwd, _), _ = C._enc_shape_calls(
                FE, T, rc_s, cfg_s, params_s, S, nnet, dev, tf)
            runs[f'{name} {shape} K{nnet} S={S}'] = \
                lambda fwd=fwd: C._named(fwd())
            runs[f'{name} {shape} K{nnet + 2} S={S}'] = bwd
    differ = 0
    for name, run in runs.items():
        cuda_build._LIBS.update(base)
        ref = run()
        cuda_build._LIBS.update(tree)
        got = run()
        torch.cuda.synchronize()
        bad = [(k, (a.float() - b.float()).abs().max().item())
               for (k, a), (_, b) in zip(ref, got) if not torch.equal(a, b)]
        for k, d in bad:
            print(f'{name} {k}: the two builds differ, max |d| {d:.3e}')
        if not bad:
            print(f'{name}: {len(got)} outputs bit-identical to the base '
                  'build', flush=True)
        differ += bool(bad)
        if args.time:   # device ms a call, base, tree, tree, base
            t = []
            for libs in (base, tree, tree, base):
                cuda_build._LIBS.update(libs)
                t.append(C._time_ms(run, 3, 3))
            print(f'{name}: in turns base {t[0]:.3f} ms, tree {t[1]:.3f}, '
                  f'tree {t[2]:.3f}, base {t[3]:.3f}', flush=True)
    return 1 if differ or failed else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
