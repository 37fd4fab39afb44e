#!/usr/bin/env python3
"""K6 and its plain twin against an f64 evaluation of the same bf16 chain.

    python3 scripts/check_k6_f64.py [--device cpu] [--seed 4] [--width 1152 ...]

K6 (``fused_mlp.mlp_bwd``) and its twin (``mlp_bwd_plain``: bf16
operands, products and sums in f32) on the operands of
``chip_smoke.py``'s grammar kernel check at each trunk width (default
1152: 'relpos' + 'axisang'; 117 and 1197 the grammar phase's others,
432 the flagship's 'reldist' + 'reldir'), weights from ``--seed``
(default 4, whose random density reaches few points at 1152, so the
composited loss's cotangent is sparse): a ragged 4104 points (R=171 x S=24) with the views inputs
'rayangle' (216) and 'relray' + subject channel (648 + 1), each with
and without framecodes, and the train step's coarse samples (R=2048 x
S=64).  The reference is the twin's chain with every product and sum
in float64 on the same bf16-rounded operands, the same ReLU masks'
rule and the same bf16 re-casts between layers (``fused_mlp._dot``
evaluated in f64).  Prints, per case, the share of points the cotangent
reaches and, for every output, the cosine and the worst |d| / max |ref|
of K6 and of the twin against the reference, worst outputs first.
On ``--device cpu`` the twin stands in for K6 (a rehearsal).  Exits
non-zero when K6 fails to build or launch.

    python3 scripts/check_k6_f64.py --enc [SHAPE ...]

holds K1-K4 and their twins to the f64 chain instead (the twins'
chain evaluated in f64 from the same f32 inputs, the encode too:
``chip_smoke._f64_twins``), at the encode shapes of
``chip_smoke.ENC_SHAPES`` (default: those deeper than
``chip_smoke.DEEP_ENC_LAYERS``, and ``w512``), each run as
``chip_smoke.enc_shape_check`` runs it (its weights, K2/K4 at R=2048 x
S=64 and K1/K3 at S=16, K3/K4 on the composited cotangent): for the
forward each raw channel's worst and mean |d| / scale of the kernel and
of the twin against the chain, for the backward the outputs nearest
``chip_smoke._check_bwd_f64``'s bar (the kernel's and the twin's cosine
to the chain, the kernel's to the twin), then the worst of each.  A
name of ``WIDE_DEEP`` (WIDE nets past 8 layers, which the gate refuses
because they miss that bar) is measured with the gate's cap lifted for
the run (``fused_encmlp.KERNEL_WIDE_DEPTH``); each shape at its
``chip_smoke.ENC_SHAPE_RS`` rays (``--rays R``: every shape at R).

    python3 scripts/check_k6_f64.py --enc SHAPE ... --f32-encode

takes the f64 chain from the encode's own f32 bands instead (the twins'
encode, which the kernels' matches bit for bit): only the products, and
what follows them, in f64 (``chip_smoke._f64_twins(f32_encode=True)``).
There the twin's distance from the chain is its products' rounding alone,
not the recurrence's, which the f64 encode puts into both the twin's and
the kernel's distance and so into the rule's bar.  Besides
``chip_smoke.ENC_SHAPES`` it takes the depth row's shapes past the gate
(``DEPTH_ROW``: 20 and 24 layers of 512, 24 of 256, WIDE 1024 at 9-16
layers), measured with the gate's depth caps lifted for the run.

    python3 scripts/check_k6_f64.py --enc w1024_depth16_nf10 --acc comp

also measures K3/K4 built from a copy of the sources whose WIDE
per-tile pass adds each product's mma sums compensated (``ACC_COMP``,
mlp_bwd_common.cuh) in place of rounded to nearest (``ACC_RN``), and
times both builds' K3/K4 calls in turns: what the more exact sums would
buy at those depths, and cost.
"""
import argparse
import contextlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the deep corners of the WIDE nets, 16 layers at ten kp bands 1024 and
# 2048 wide (config overrides over the SURREAL recipe, as
# chip_smoke.ENC_SHAPES' entries), and the rays each is measured at: the
# twins in f64 beside K4's workspace (37.6 GB at 16 x 2048 and R = 2048)
# fit the card at R = 512
WIDE_DEEP = {
    'w1024_depth16_nf10': (dict(netwidth=1024, netwidth_fine=1024,
                                netdepth=16, netdepth_fine=16, multires=10),
                           False, None),
    'w2048_depth16_nf10': (dict(netwidth=2048, netwidth_fine=2048,
                                netdepth=16, netdepth_fine=16, multires=10),
                           False, None),
}
WIDE_DEEP_RAYS = {'w2048_depth16_nf10': 512}
# ROADMAP B.1.4's depth row past the gate: 20 and 24 layers of 512 (10
# and 7 kp bands), 24 layers of 256 at 10 bands, and WIDE 1024 at 9-16
# layers at 10 bands (16 is WIDE_DEEP's)
DEPTH_ROW = {
    'w512_depth20_nf10': (dict(netwidth=512, netwidth_fine=512,
                               netdepth=20, netdepth_fine=20, multires=10),
                          False, None),
    'w512_depth24': (dict(netwidth=512, netwidth_fine=512, netdepth=24,
                          netdepth_fine=24), False, None),
    'depth24_nf10': (dict(netdepth=24, netdepth_fine=24, multires=10),
                     False, None),
    **{f'w1024_depth{d}_nf10': (dict(netwidth=1024, netwidth_fine=1024,
                                     netdepth=d, netdepth_fine=d,
                                     multires=10), False, None)
       for d in range(9, 16)},
}


@contextlib.contextmanager
def _f64_products(FM):
    """``fused_mlp._dot`` in float64 (bf16-rounded operands) for the
    duration: the twin then evaluates its chain in f64."""
    import torch
    dot = FM._dot
    FM._dot = lambda a, w: (a.to(torch.bfloat16).double()
                            @ w.to(torch.bfloat16).double())
    try:
        yield
    finally:
        FM._dot = dot


def _named(dxs, dxvs, grads):
    return ([(f'dx{i}', x) for i, x in enumerate(dxs)]
            + [(f'dxv{i}', x) for i, x in enumerate(dxvs)]
            + [(f'g{i}', x) for i, x in enumerate(grads)])


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--seed', type=int, default=4)
    ap.add_argument('--width', type=int, nargs='+', default=[1152])
    ap.add_argument('--enc', nargs='*', default=None, metavar='SHAPE')
    ap.add_argument('--acc', choices=('comp',), default=None,
                    help='also K3/K4 with the WIDE per-tile pass compensated')
    ap.add_argument('--f32-encode', action='store_true',
                    help='--enc: the f64 chain from the encode\'s own f32 '
                    'bands, the products in f64')
    ap.add_argument('--rays', type=int, default=None,
                    help='--enc at this many rays (default the shape\'s '
                    'chip_smoke.ENC_SHAPE_RS, else ENC_SHAPE_R)')
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from anerf_torch import testing_utils as T
    from anerf_torch.ops import cuda_build, fused_encmlp as FE
    from anerf_torch.ops import fused_mlp as FM
    device = torch.device(args.device)
    shapes = args.enc or [n for n, (over, _, _) in C.ENC_SHAPES.items()
                          if over.get('netdepth', 8) > C.DEEP_ENC_LAYERS
                          or n == 'w512']
    table = dict(C.ENC_SHAPES, **WIDE_DEEP, **DEPTH_ROW)
    C.ENC_SHAPE_RS.update(WIDE_DEEP_RAYS)
    if args.rays:
        C.ENC_SHAPE_RS.update({n: args.rays for n in shapes})
    if any(n in WIDE_DEEP or n in DEPTH_ROW for n in shapes):
        # measured where the gate refuses them: its caps lifted for the
        # run (the headers take 64 layers)
        FE.KERNEL_DEPTH = FE.KERNEL_WIDE_DEPTH = range(1, 65)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            print('no CUDA device', file=sys.stderr)
            return 1
        print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        if args.enc is not None:
            FE.build_kernels(enc_shapes=[C.enc_shape_key(
                FE, T, table[n][0]) for n in shapes])
        else:
            cuda_build.build_kernels(trunk_widths=args.width)
    if args.enc is not None:
        for name in shapes:
            check_enc(C, T, FE, device, name, table,
                      f32_encode=args.f32_encode)
            if args.acc and device.type == 'cuda':
                acc_variant(C, T, FE, device, name, table)
        return 0
    for width in args.width:
        check(C, T, FM, device, width, args.seed)
    return 0


def acc_variant(C, T, FE, device, name, table):
    """``--acc comp``: K3/K4 at shape ``name`` built from a copy of the
    sources whose WIDE per-tile pass adds its products' mma sums
    compensated (ACC_COMP): their outputs against the f64 chain, as
    ``check_enc``'s, and both builds' calls timed in turns (tree,
    variant, variant, tree)."""
    import shutil
    import tempfile
    from anerf_torch.ops import cuda_build
    key = cuda_build.lib_key('bwd', enc=C.enc_shape_key(FE, T,
                                                          table[name][0]))
    d = tempfile.mkdtemp(dir=os.path.join(ROOT, 'anerf_torch', '_build'))
    shutil.copytree(os.path.join(ROOT, 'anerf_torch', 'csrc'),
                    os.path.join(d, 'csrc'))
    path = os.path.join(d, 'csrc', 'mlp_bwd_common.cuh')
    with open(path) as f:
        text = f.read()
    old = 'constexpr int ACC_NET_G = ACC_NET > ACC_RN ? ACC_NET : ACC_RN;'
    if old not in text:
        raise RuntimeError(f'anchor not in mlp_bwd_common.cuh: {old!r}')
    with open(path, 'w') as f:
        f.write(text.replace(old, 'constexpr int ACC_NET_G = ACC_COMP;'))
    so = os.path.join(d, 'lib.so')
    proc = subprocess.run(
        [cuda_build._nvcc(), *cuda_build._shape_flags(key), '-gencode',
         'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-shared',
         '-Xcompiler', '-fPIC', '-Xptxas', '-v', '-o', so,
         os.path.join(d, 'csrc', 'encmlp_bwd.cu')],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f'the variant failed to build:\n{proc.stdout}'
                           f'{proc.stderr}')
    print('\n'.join(l for l in (proc.stdout + proc.stderr).splitlines()
                    if 'spill' in l))
    import ctypes
    lib = ctypes.CDLL(so)
    cuda_build._bind(lib, 'bwd')
    tree = cuda_build._LIBS[key]
    over, tf, samples = table[name]
    cfg, rc, params, plan = C.enc_shape_model(FE, T, name, over, samples,
                                              device)
    R = C.ENC_SHAPE_RS.get(name, C.ENC_SHAPE_R)
    for S, nnet in plan:
        _, (bwd, _), _ = C._enc_shape_calls(FE, T, rc, cfg, params, S, nnet,
                                            device, tf, R=R)
        ms = []
        for which in (tree, lib, lib, tree):
            cuda_build._LIBS[key] = which
            ms.append(C._time_ms(bwd, 2, 3))
        print(f'{name} S={S} K{nnet + 2} ms in turns: tree (RN) '
              f'{ms[0]:.3f}, compensated {ms[1]:.3f}, {ms[2]:.3f}, tree '
              f'{ms[3]:.3f}', flush=True)
    cuda_build._LIBS[key] = lib
    print(f'{name}: the compensated variant against the f64 chain:')
    check_enc(C, T, FE, device, name, table, bwd_only=True)
    cuda_build._LIBS[key] = tree


def check_enc(C, T, FE, device, name, table=None, bwd_only=False,
              f32_encode=False):
    """K1-K4 and their twins at encode shape ``name`` against the f64
    chain, the encode in f64 too (``chip_smoke._f64_twins``; ``--enc``;
    ``f32_encode``: the chain from the encode's own f32 bands), at the
    shape's ``chip_smoke.ENC_SHAPE_RS`` rays."""
    import torch
    over, tf, samples = (table or C.ENC_SHAPES)[name]
    cfg, rc, params, plan = C.enc_shape_model(FE, T, name, over, samples,
                                              device)
    R = C.ENC_SHAPE_RS.get(name, C.ENC_SHAPE_R)
    for S, nnet in plan:
        (fwd, fplain), (bwd, bplain), _ = C._enc_shape_calls(
            FE, T, rc, cfg, params, S, nnet, device, tf, R=R)
        if device.type == 'cpu':     # the twins stand in for the kernels
            fwd, bwd = fplain, bplain
        if not bwd_only:
            k, t = fwd(), fplain()
            with C._f64_twins(FE, f32_encode):
                d = fplain()
            for net in range(nnet):
                for who, x in (('kernel', k[net]), ('twin', t[net])):
                    print(f'{name} R={R} S={S} fwd net{net} {who} vs f64: '
                          + ', '.join(f'ch{c} max {a:.2e} mean {b:.2e}'
                                      for c, (a, b) in enumerate(C._rel_err(
                                          d[net].float(), x.float()))))
            del k, t, d
        kb, tb = bwd(), bplain()
        with C._f64_twins(FE, f32_encode):
            db = bplain()
        rows = []
        for (k, a), (_, b), (_, r) in zip(kb, tb, db):
            ck, ct, kt = C._cmp(r, a)[0], C._cmp(r, b)[0], C._cmp(b, a)[0]
            bar = 1. - max(1. - C.BWD_COS_MIN, C.DEEP_F64_RATIO * (1. - ct))
            rows.append((ck - bar, k, ck, ct, kt))
        rows.sort()
        for _, k, ck, ct, kt in rows[:6]:
            print(f'{name} R={R} S={S} bwd {k}: kernel~f64 {ck:.7f} '
                  f'twin~f64 {ct:.7f} kernel~twin {kt:.7f}')
        print(f'{name} R={R} S={S} bwd worst: kernel~f64 '
              f'{min(r[2] for r in rows):.7f} twin~f64 '
              f'{min(r[3] for r in rows):.7f} kernel~twin '
              f'{min(r[4] for r in rows):.7f}; nearest the bar by '
              f'{rows[0][0]:+.2e}', flush=True)
        del kb, tb, db
        if device.type == 'cuda':
            torch.cuda.empty_cache()


def check(C, T, FM, device, width, seed):
    import torch
    over = {} if width == 432 else C.GRAMMAR_WIDTHS[width]
    cases = [(view, ns, codes, 171, 24) for view, ns in (('rayangle', 1),
                                                         ('relray', 2))
             for codes in (True, False)]
    cases.append(('rayangle', 1, True, 2048, 64))
    worst = {}
    for view, ns, codes, R, S in cases:
        cfg, rc, params = C._grammar_model(T, device, seed, ns,
                                           view_type=view, **over)
        st, xs, xvs, flat = C.split_inputs(FM, T, cfg, rc, params, R, S,
                                           device, codes)
        if st.dnet != width:
            raise ValueError(f'trunk {st.dparts}, expected {width}')
        g = C._split_cotangent(FM, st, xs, xvs, flat, S, device)
        share = (g.abs().sum(-1) > 0).float().mean().item()
        kern = _named(*FM.mlp_bwd(st, xs, xvs, flat, g))
        twin = _named(*FM.mlp_bwd_plain(st, xs, xvs, flat, g))
        with _f64_products(FM):
            ref = _named(*FM._mlp_bwd_tile(st, xs, xvs, flat, g))
        if device.type == 'cuda':
            torch.cuda.synchronize()
        rows = []
        for (k, r), (_, a), (_, b) in zip(ref, kern, twin):
            ck, _, rk, _ = C._cmp(r, a)
            ct, _, rt, _ = C._cmp(r, b)
            rows.append((min(ck, ct), k, ck, rk, ct, rt))
            w = worst.setdefault(k, [1., 1.])
            w[0], w[1] = min(w[0], ck), min(w[1], ct)
        rows.sort()
        print(f'trunk {st.dparts} views {st.vparts} n={R * S} seed '
              f'{seed}: cotangent on {share:.1%} of the points')
        for _, k, ck, rk, ct, rt in rows[:4]:
            print(f'  {k:5s} K6 cos {ck:.7f} |d|/max {rk:.2e}   twin cos '
                  f'{ct:.7f} |d|/max {rt:.2e}   (against f64)')
    lo = sorted(worst.items(), key=lambda kv: min(kv[1]))[:4]
    print(f'trunk {width}, worst over the cases, against f64: ' + ', '.join(
        f'{k} K6 {a:.7f} twin {b:.7f}' for k, (a, b) in lo))


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
