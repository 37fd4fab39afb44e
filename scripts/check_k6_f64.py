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
the run (``fused_encmlp.kernel_depths``); each shape at its
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

    python3 scripts/check_k6_f64.py --enc SHAPE ... --acc-group SPEC ...

also measures K3/K4 built from copies of the sources, one a SPEC, in
which the per-tile pass's accumulation of some product groups is
replaced (mlp_bwd_common.cuh: ``rec`` the forward recompute's trunk and
feat products, ``vw`` the views layer's recompute, ``cot`` the cotangent
products; ``all`` the three) by a mode (``chain``: the mma chain adds
into the accumulators, ``rn``: each mma's sum added rounded to nearest,
``comp``: that add compensated, ``net``: ACC_NET, the sums of every
build before the deep ones), e.g. ``rec=rn,cot=net``; a group a SPEC
does not name keeps the header's.  Each variant runs on the same
inputs against the same f64 chain and twin (a K3/K4 call of each, the
tree's first), and the calls are timed in turns (the tree, each
variant, the tree).  ``--acc comp`` is ``--acc-group all=comp``.  The
forward (K1/K2, the tree's) is printed with its margin to
``chip_smoke._check_close_f64``'s bars.
"""
import argparse
import contextlib
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _net(width, depth, nf=None):
    over = dict(netwidth=width, netwidth_fine=width, netdepth=depth,
                netdepth_fine=depth)
    return (dict(over, multires=nf) if nf else over), False, None


# the deep corners of the WIDE nets, 16 layers at ten kp bands 1024 and
# 2048 wide (config overrides over the SURREAL recipe, as
# chip_smoke.ENC_SHAPES' entries), 2048 at 9 and 12 layers, and the rays
# each 2048-wide one is measured at: the twins in f64 beside K4's
# workspace (37.6 GB at 16 x 2048 and R = 2048) fit the card at R = 512
WIDE_DEEP = {f'w{w}_depth{d}_nf10': _net(w, d, 10)
             for w, d in ((1024, 16), (2048, 9), (2048, 12), (2048, 16))}
WIDE_DEEP_RAYS = {n: 512 for n in WIDE_DEEP if n.startswith('w2048')}
# ROADMAP B.1.4's depth row: 20, 24 and 32 layers of 512 (10, 7 and 10
# kp bands), 24 and 32 layers of 256 at 10 bands, and WIDE 1024 at 9-15
# layers at 10 bands (16 is WIDE_DEEP's)
DEPTH_ROW = {
    'w512_depth20_nf10': _net(512, 20, 10),
    'w512_depth24': _net(512, 24),
    'w512_depth32_nf10': _net(512, 32, 10),
    'depth24_nf10': _net(256, 24, 10),
    'depth32_nf10': _net(256, 32, 10),
    **{f'w1024_depth{d}_nf10': _net(1024, d, 10) for d in range(9, 16)},
}
# --acc-group: the product groups of the per-tile pass (K3/K4) and of
# K1/K2's forward, the header and line that set each one's accumulation,
# and each mode's value there
ACC_GROUPS = ('rec', 'vw', 'cot', 'fwd')
ACC_LINE = {'rec': ('mlp_bwd_common.cuh', 'constexpr int ACC_REC = '),
            'vw': ('mlp_bwd_common.cuh', 'constexpr int ACC_VW = '),
            'cot': ('mlp_bwd_common.cuh', 'constexpr int ACC_COT = '),
            'fwd': ('mlp_fwd_common.cuh', 'constexpr bool FWD_RN = ')}
ACC_MODES = {'chain': 'ACC_CHAIN', 'rn': 'ACC_RN', 'comp': 'ACC_COMP',
             'net': 'ACC_NET'}
FWD_MODES = {'chain': 'false', 'rn': 'true'}


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
                    help='--acc-group all=comp')
    ap.add_argument('--acc-group', nargs='+', default=[], metavar='SPEC',
                    help='also K3/K4 from source copies with these product '
                    'groups\' accumulation replaced (GROUP=MODE,...)')
    ap.add_argument('--f32-encode', action='store_true',
                    help='--enc: the f64 chain from the encode\'s own f32 '
                    'bands, the products in f64')
    ap.add_argument('--rays', type=int, default=None,
                    help='--enc at this many rays (default the shape\'s '
                    'chip_smoke.ENC_SHAPE_RS, else ENC_SHAPE_R)')
    args = ap.parse_args(argv)
    specs = [_acc_spec(x) for x in args.acc_group
             + (['all=comp'] if args.acc else [])]
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
        # measured where the gate may refuse them: its caps lifted for
        # the run (the headers' caps hold)
        FE.KERNEL_DEPTH = {256: range(1, 65), 512: range(1, 65)}
        FE.KERNEL_WIDE_DEPTH = range(1, 65)
    variants = {}
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            print('no CUDA device', file=sys.stderr)
            return 1
        print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        if args.enc is not None:
            keys = [C.enc_shape_key(FE, T, table[n][0]) for n in shapes]
            FE.build_kernels(enc_shapes=keys)
            if specs:
                variants = build_variants(cuda_build, specs, keys)
    if args.enc is not None:
        for name in shapes:
            if specs and device.type == 'cuda':
                acc_groups(C, T, FE, device, name, table, specs, variants,
                           args.f32_encode)
            else:
                check_enc(C, T, FE, device, name, table,
                          f32_encode=args.f32_encode)
        return 0
    for width in args.width:
        check(C, T, FM, device, width, args.seed)
    return 0


def _acc_spec(text):
    """{group: mode} of an --acc-group SPEC such as 'rec=rn,cot=net'
    ('all' names every group)."""
    spec = {}
    for part in text.split(','):
        group, _, mode = part.partition('=')
        if (group not in ACC_GROUPS + ('all',)
                or mode not in (FWD_MODES if group == 'fwd' else ACC_MODES)):
            raise SystemExit(f'--acc-group: {part!r} is not GROUP=MODE '
                             f'(groups {ACC_GROUPS} or all, the three of '
                             f'K3/K4; modes {tuple(ACC_MODES)}, fwd\'s '
                             f'{tuple(FWD_MODES)})')
        spec.update(dict.fromkeys(ACC_GROUPS[:3] if group == 'all'
                                  else (group,), mode))
    return tuple(sorted(spec.items()))


def _spec_name(spec):
    return ','.join(f'{g}={m}' for g, m in spec)


def build_variants(cuda_build, specs, keys):
    """K3/K4 (K1/K2 for a SPEC that names fwd) at each encode shape of
    ``keys`` from a copy of the sources per SPEC of ``specs`` (its
    groups' accumulation lines replaced), one nvcc each, all started
    together (ptxas's spill report printed): {(spec, key): the bound
    library}."""
    import ctypes
    import tempfile
    base = os.path.join(ROOT, 'anerf_torch', 'csrc')
    procs = {}
    for spec in specs:
        d = tempfile.mkdtemp(dir=os.path.join(ROOT, 'anerf_torch', '_build'))
        shutil.copytree(base, os.path.join(d, 'csrc'))
        for group, mode in spec:
            header, anchor = ACC_LINE[group]
            path = os.path.join(d, 'csrc', header)
            with open(path) as f:
                lines = f.read().split('\n')
            at = [i for i, l in enumerate(lines) if l.startswith(anchor)]
            if len(at) != 1:
                raise RuntimeError(f'anchor {anchor!r} not once in {header}')
            lines[at[0]] = anchor + (FWD_MODES if group == 'fwd'
                                     else ACC_MODES)[mode] + ';'
            with open(path, 'w') as f:
                f.write('\n'.join(lines))
        groups = {g for g, _ in spec}
        which = (['fwd'] if 'fwd' in groups else []) + (
            ['bwd'] if groups - {'fwd'} else [])
        for enc in dict.fromkeys(keys):
            for w in which:
                key = cuda_build.lib_key(w, enc=enc)
                so = os.path.join(d, f'{cuda_build._tag(key)}.so')
                procs[spec, key] = so, subprocess.Popen(
                    [cuda_build._nvcc(), *cuda_build._shape_flags(key),
                     '-gencode', 'arch=compute_90a,code=sm_90a',
                     '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
                     '-Xptxas', '-v', '-o', so,
                     os.path.join(d, 'csrc', cuda_build._SOURCES[w])],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
    libs = {}
    for (spec, key), (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'variant {_spec_name(spec)} {key} failed to '
                               f'build:\n{out}')
        print(f'variant {_spec_name(spec)} {cuda_build._tag(key)}: '
              + '; '.join(_spills(out)))
        lib = ctypes.CDLL(so)
        cuda_build._bind(lib, key[0])
        libs[spec, key] = lib
    return libs


def _spills(ptxas):
    """The per-tile pass's and K1/K2's spill lines of a ``-Xptxas -v``
    report (each line follows its function's 'Function properties for'
    line)."""
    fn, out = '', []
    for line in ptxas.splitlines():
        if 'Function properties for' in line:
            fn = line.rsplit(' ', 1)[-1]
        elif 'spill' in line and ('bwd_tile' in fn or 'encmlp_fwd' in fn):
            out.append(line.strip())
    return out


def _bwd_rows(C, kb, tb, db):
    """Each backward output's (margin to ``chip_smoke._check_bwd_f64``'s
    bar, name, kernel~f64, twin~f64, kernel~twin), nearest the bar
    first."""
    rows = []
    for (k, a), (_, b), (_, r) in zip(kb, tb, db):
        ck, ct, kt = C._cmp(r, a)[0], C._cmp(r, b)[0], C._cmp(b, a)[0]
        bar = 1. - max(1. - C.BWD_COS_MIN, C.DEEP_F64_RATIO * (1. - ct))
        rows.append((ck - bar, k, ck, ct, kt))
    return sorted(rows)


def _fwd_margin(C, ref, got, twin):
    """The kernel's forward margins to ``chip_smoke._check_close_f64``'s
    max and mean bars (negative: a miss)."""
    worst = {}
    for who, rows in (('kernel', got), ('twin', twin)):
        errs = [e for r, x in zip(ref, rows) for e in C._rel_err(
            r.float(), x.float())]
        worst[who] = (max(e[0] for e in errs), max(e[1] for e in errs))
    return (max(C.RAW_MAX_TOL, C.DEEP_F64_RATIO * worst['twin'][0])
            - worst['kernel'][0],
            max(C.RAW_MEAN_TOL, C.DEEP_F64_RATIO * worst['twin'][1])
            - worst['kernel'][1])


def acc_groups(C, T, FE, device, name, table, specs, variants, f32_encode):
    """``--acc-group``: at shape ``name``, K1/K2 of the tree and of each
    forward variant against the f64 chain (margins to the forward's
    bars), then K3/K4 of the tree and of each backward variant
    (``build_variants``) against the same f64 chain and twin, each
    build's worst outputs and margin, and every build's calls timed in
    turns (the tree, each variant, the tree)."""
    import torch
    from anerf_torch.ops import cuda_build
    over, tf, samples = table[name]
    cfg, rc, params, plan = C.enc_shape_model(FE, T, name, over, samples,
                                              device)
    enc = C.enc_shape_key(FE, T, over)
    R = C.ENC_SHAPE_RS.get(name, C.ENC_SHAPE_R)
    for S, nnet in plan:
        (fwd, fplain), (bwd, bplain), _ = C._enc_shape_calls(
            FE, T, rc, cfg, params, S, nnet, device, tf, R=R)
        for which, run, plain in (('fwd', fwd, fplain), ('bwd', bwd, bplain)):
            key = cuda_build.lib_key(which, enc=enc)
            tree = cuda_build._LIBS[key]
            builds = [('tree', tree)] + [(_spec_name(s), variants[s, key])
                                         for s in specs
                                         if (s, key) in variants]
            t = plain()
            with C._f64_twins(FE, f32_encode):
                d = plain()
            for label, lib in builds:
                cuda_build._LIBS[key] = lib
                if which == 'fwd':
                    mx, mean = _fwd_margin(C, d, run(), t)
                    print(f'{name} R={R} S={S} fwd {label} against the f64 '
                          f'chain: margin max {mx:+.3e} mean {mean:+.3e}',
                          flush=True)
                    continue
                rows = _bwd_rows(C, run(), t, d)
                print(f'{name} R={R} S={S} bwd {label}: margin '
                      f'{rows[0][0]:+.3e}; ' + ', '.join(
                          f'{k} kernel~f64 {ck:.7f} twin~f64 {ct:.7f}'
                          for _, k, ck, ct, _ in rows[:3]), flush=True)
            del t, d
            ms = []
            for label, lib in builds + builds[:1]:
                cuda_build._LIBS[key] = lib
                ms.append((label, C._time_ms(run, 2, 3)))
            kname = f'K{nnet + (2 if which == "bwd" else 0)}'
            print(f'{name} R={R} S={S} {kname} ms in turns: '
                  + ', '.join(f'{label} {t:.3f}' for label, t in ms),
                  flush=True)
            cuda_build._LIBS[key] = tree
        torch.cuda.empty_cache()


def check_enc(C, T, FE, device, name, table=None, f32_encode=False):
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
        k, t = fwd(), fplain()
        with C._f64_twins(FE, f32_encode):
            d = fplain()
        for net in range(nnet):
            for who, x in (('kernel', k[net]), ('twin', t[net])):
                print(f'{name} R={R} S={S} fwd net{net} {who} vs f64: '
                      + ', '.join(f'ch{c} max {a:.2e} mean {b:.2e}'
                                  for c, (a, b) in enumerate(C._rel_err(
                                      d[net].float(), x.float()))))
        mx, mean = _fwd_margin(C, d, k, t)
        print(f'{name} R={R} S={S} fwd margin max {mx:+.3e} mean '
              f'{mean:+.3e}')
        del k, t, d
        kb, tb = bwd(), bplain()
        with C._f64_twins(FE, f32_encode):
            db = bplain()
        rows = _bwd_rows(C, kb, tb, db)
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
