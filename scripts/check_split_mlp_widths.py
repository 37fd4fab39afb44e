#!/usr/bin/env python3
"""K5/K6 (``fused_mlp.mlp_fwd``/``mlp_bwd``) at several trunk widths and
nets on one GPU: a quick check of new builds before the whole smoke run.

    python3 scripts/check_split_mlp_widths.py [WIDTH[:DEPTHxNETWIDTH] ...]

Builds K5/K6 for each trunk width (default 117, 1152, 1197 besides the
flagship's 432) and net (8x256 where not given; e.g. ``432:6x256``,
``432:8x384``, built at the width it is padded to; ``-Xptxas -v`` output
to ``k56_ptxas.log`` in the repo's ignored output directory, each
kernel's registers, shared memory and spills printed), holds both
kernels against
their plain twins on random weights and inputs at a ragged 4104 points
for views 216+16, 648+1+16 and 648+1 (K5 at ``chip_smoke.py``'s bars;
K6's cosines below 0.9999 printed: a random cotangent on every point
flips ReLU masks, ``chip_smoke.py`` holds K6 on a composited one),
checks that two calls are bit-identical, and times both at n=131,072
(views 216+16; CUDA events, median of 3 windows).  Exits non-zero when
a kernel fails to build, to launch, or to agree.
"""
import contextlib
import io
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(shapes) -> int:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from anerf_torch.ops import cuda_build, fused_mlp as FM
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import subprocess
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        cuda_build.build_kernels(verbose=True, shapes=[
            (dx, d, FM.kernel_static(FM.MLPStatic(d, w, (dx,), (16,), w // 2,
                                                  (4,))).width)
            for dx, d, w in shapes])
    print(f'build {time.perf_counter() - t0:.1f} s', flush=True)
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'k56_ptxas.log'), 'w') as f:
        f.write(log.getvalue())
    lines = log.getvalue().splitlines()
    for i, line in enumerate(lines):
        if 'Compiling entry' in line and any(k in line for k in (
                'mlp_fwd_kernel', 'mlp_bwd_tile', 'dw_kernel', 'dw_sum')):
            print(line.split("'")[1][:40], ' '.join(
                x.strip() for x in lines[i + 1:i + 3])[-160:])
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(0)

    def make(dparts, vparts, n, depth, width):
        st = FM.MLPStatic(depth, width, dparts, vparts, width // 2, (4,))
        flat = []
        for shape, dt in FM._weight_shapes(st):
            scale = 1.4 / shape[0] ** 0.5 if dt == torch.bfloat16 else 0.05
            flat.append((torch.randn(shape, generator=gen) * scale).to(dev,
                                                                       dt))
        rnd = lambda d: (torch.rand((n, d), generator=gen) * 2 - 1).to(
            dev, torch.bfloat16)
        return st, [rnd(d) for d in dparts], [rnd(d) for d in vparts], flat

    ok = True
    nets = [((dx - 72, 72) if dx > 72 else (dx,), d, w)
            for dx, d, w in shapes]
    for dparts, depth, width in nets:
        for vparts in ((216, 16), (648, 1, 16), (648, 1)):
            st, xs, xvs, flat = make(dparts, vparts, 4104, depth, width)
            print(f'{depth}x{width} parts {dparts} / {vparts}:', flush=True)
            try:
                run, plain = C._split_calls(FM, st, xs, xvs, flat)
                C._check_close('mlp_fwd', plain(), run())
                C._check_deterministic('mlp_fwd', C._named(run()),
                                       C._named(run()))
                g = torch.randn((4104, 4), generator=gen).to(dev)
                run, plain = C._split_calls(FM, st, xs, xvs, flat, g)
                got = run()
                for (k, r), (_, b) in zip(plain(), got):
                    cos, ratio, rel, _ = C._cmp(r.float(), b.float())
                    if cos < C.BWD_COS_MIN:
                        print(f'   {k}: cos {cos:.6f} ratio {ratio:.5f}')
                    ok &= cos > 0.999
                C._check_deterministic('mlp_bwd', got, run())
            except Exception as e:  # noqa: BLE001 - report and go on
                ok = False
                print('  FAILED', type(e).__name__, str(e)[:500], flush=True)
    for dparts, depth, width in nets:
        st, xs, xvs, flat = make(dparts, (216, 16), 131072, depth, width)
        run, _ = C._split_calls(FM, st, xs, xvs, flat)
        fwd_ms = C._time_ms(run, 5, 3)
        g = torch.randn((131072, 4), generator=gen).to(dev)
        run, _ = C._split_calls(FM, st, xs, xvs, flat, g)
        bwd_ms = C._time_ms(run, 2, 3)
        print(f'{depth}x{width} {dparts}: K5 {fwd_ms:.3f} ms, K6 '
              f'{bwd_ms:.3f} ms at n=131072', flush=True)
    print('OK' if ok else 'FAIL')
    return 0 if ok else 1


def _shape(arg):
    """'DX' or 'DX:DEPTHxWIDTH' -> (dx, depth, width)."""
    dx, _, net = arg.partition(':')
    depth, width = (int(v) for v in (net or '8x256').split('x'))
    return int(dx), depth, width


if __name__ == '__main__':
    sys.exit(main([(432, 8, 256)] + [_shape(a) for a in sys.argv[1:]
                                      or ('117', '1152', '1197')]))
