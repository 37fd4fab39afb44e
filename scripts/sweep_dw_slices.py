#!/usr/bin/env python3
"""The backward kernels' dW pass against the number of point slices P
on one GPU: K4 and K3 at the flagship train step's shapes, K6 at the
multi-subject step's (n=131,072), on ``chip_smoke.py``'s inputs.

    python3 scripts/sweep_dw_slices.py [P ...]

For each P (default 1 4 8 9 10 11 12 13 16 17 18 20 22 26 32 44) the
planner ``fused_mlp.dw_plan`` is replaced by one that cuts the points
into P slices, and each kernel prints its whole call's device ms (CUDA
events, median of 3 windows of 3 calls) and its dW and bias passes' ms
from one profiled call; two rounds, P in the same order.  Then the
planner's own choice of P for each.  Prints the card's name and power
limit first.
"""
import contextlib
import io
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(counts) -> int:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from anerf_torch import testing_utils as T
    from anerf_torch.interop import params_to
    from anerf_torch.models.factory import (build_raycast_config,
                                            init_raycaster_params)
    from anerf_torch.ops import fused_encmlp as FE, fused_mlp as FM
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    FE.build_kernels()
    dev = torch.device('cuda')
    cfg = T.surreal_config(compute_dtype='bfloat16')
    rc = build_raycast_config(cfg, n_framecodes=9)
    params = params_to(init_raycaster_params(
        torch.Generator().manual_seed(1), rc, cfg), dev)
    rc2 = build_raycast_config(cfg, n_framecodes=9, n_subjects=2)
    params2 = params_to(init_raycaster_params(
        torch.Generator().manual_seed(4), rc2, cfg), dev)
    cases = {}
    for name, kernel, S, nnet in (('K4', 'encmlp_dual_bwd', 64, 2),
                                  ('K3', 'encmlp_bwd', 16, 1)):
        ins = C.kernel_inputs(FE, T, rc, cfg, params, S, 2048, dev)
        g = C._composited_cotangent(FE, ins, nnet, dev)
        cases[name] = (kernel, C._bwd_calls(FE, *ins, g, nnet)[0],
                       (ins[0], ins[2].shape[0], nnet))
    st, xs, xvs, flat = C.split_inputs(FM, T, cfg, rc2, params2, 2048, 64,
                                       dev)
    g = C._split_cotangent(FM, st, xs, xvs, flat, 64, dev)
    cases['K6'] = ('mlp_bwd', C._split_calls(FM, st, xs, xvs, flat, g)[0],
                   (st, 131072, 1))
    planner = FM.dw_plan

    def cut_into(P):
        def plan(st, n, nnet=1):
            n_pad = -(-n // 64) * 64
            size = -(-(-(-n_pad // P)) // 64) * 64
            return -(-n_pad // size), size
        return plan

    for rnd in range(2):
        for name, (kernel, run, _) in cases.items():
            for P in counts:
                FM.dw_plan = cut_into(P)
                ms = C._time_ms(run, 3, 3)
                with contextlib.redirect_stdout(io.StringIO()):
                    out = C.pass_times(kernel, run, name)
                passes = ('passes not measured (no CUDA events)'
                          if out is None else f'dW {out["dW"]:.3f} ms, '
                          f'bias {out["bias"]:.3f} ms')
                print(f'round {rnd} {name} P={P}: call {ms:.3f} ms, '
                      f'{passes}', flush=True)
    FM.dw_plan = planner
    for name, (_, _, (st, n, nnet)) in cases.items():
        print(f'{name}: the planner takes (P, slice) = '
              f'{FM.dw_plan(st, n, nnet)} of {FM.dw_tiles(st, nnet)} tiles')
    return 0


if __name__ == '__main__':
    sys.exit(main(tuple(int(a) for a in sys.argv[1:])
                  or (1, 4, 8, 9, 10, 11, 12, 13, 16, 17, 18, 20, 22, 26,
                      32, 44)))
