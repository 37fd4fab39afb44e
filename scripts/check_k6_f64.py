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
"""
import argparse
import contextlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from anerf_torch import testing_utils as T
    from anerf_torch.ops import cuda_build, fused_mlp as FM
    device = torch.device(args.device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            print('no CUDA device', file=sys.stderr)
            return 1
        print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        cuda_build.build_kernels(trunk_widths=args.width)
    for width in args.width:
        check(C, T, FM, device, width, args.seed)
    return 0


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
