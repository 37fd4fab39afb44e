#!/usr/bin/env python3
"""The forward kernels K1, K2 (``encmlp_fwd.cu``) and K5 (``mlp_fwd.cu``)
of several builds side by side on one GPU.

    python3 scripts/ab_fwd_kernels.py [--variant NAME=CSRC_DIR[:FLAG,...]]...

Each variant is the CUDA sources in CSRC_DIR (for instance a parent
commit's ``anerf_torch/csrc`` unpacked with ``git archive``) built with
nvcc for sm_90a with the given ``-D`` flags; with no ``--variant`` the
tree's own sources.  Every variant's K1, K2 and K5 are held against their
plain twins (``chip_smoke``'s bars) on the flagship and two-subject
inputs of ``chip_smoke.py`` at a ragged size, the eval shapes and the
train shapes, with two calls required bit-identical; then each shape is
timed in two rounds, the variants in turn and then in reverse order:
wrapper ms (CUDA events over back-to-back calls, weight packing
included) and the kernel's own device ms (torch.profiler).  Prints the
card's name and power limit and writes ``chiprun_out/ab_fwd/res.json``.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, 'chiprun_out', 'ab_fwd')


def build(variants, nvcc):
    """{name: {'fwd': lib, 'mlp_fwd': lib}} for the variants that build;
    one nvcc per source and variant, all started together."""
    from anerf_torch.ops import cuda_build
    procs = {}
    for name, (csrc, flags) in variants.items():
        for which, src in (('fwd', 'encmlp_fwd.cu'), ('mlp_fwd', 'mlp_fwd.cu')):
            so = os.path.join(OUT, f'lib{which}_{name}.so')
            cmd = [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                   '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
                   '-Xptxas', '-v', *[f'-D{f}' for f in flags], '-o', so,
                   os.path.join(csrc, src)]
            procs[name, which] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (name, which), (so, proc) in procs.items():
        log = proc.communicate()[0]
        with open(os.path.join(OUT, f'ptxas_{name}_{which}.log'), 'w') as f:
            f.write(log)
        lines = log.splitlines()
        for i, line in enumerate(lines):   # registers, stack and spills
            if 'Compiling entry function' in line and 'fwd_kernel' in line:
                print(name, which, line.split("'")[1][:60], '|',
                      ' '.join(x.strip() for x in lines[i + 1:i + 4]))
        if proc.returncode != 0:
            print(f'{name} {which}: build failed\n{log}', flush=True)
            continue
        lib = ctypes.CDLL(so)
        cuda_build._bind(lib, which)
        libs.setdefault(name, {})[which] = lib
    return {k: v for k, v in libs.items() if len(v) == 2}


def cases(device):
    """{label: (kernel call, twin call, cost)} on chip_smoke's inputs."""
    import chip_smoke as C
    import torch
    from anerf_torch import testing_utils as T
    from anerf_torch.interop import params_to
    from anerf_torch.models.factory import (build_raycast_config,
                                            init_raycaster_params)
    from anerf_torch.ops import fused_encmlp as FE
    from anerf_torch.ops import fused_mlp as FM
    cfg = T.surreal_config(compute_dtype='bfloat16')
    rc = build_raycast_config(cfg, n_framecodes=9)
    params = params_to(init_raycaster_params(
        torch.Generator().manual_seed(1), rc, cfg), device)
    rc2 = build_raycast_config(cfg, n_framecodes=9, n_subjects=2)
    params2 = params_to(init_raycaster_params(
        torch.Generator().manual_seed(4), rc2, cfg), device)
    out = {}
    for name, S, nnet, R, codes in (('encmlp_fwd', 16, 1, 7, True),
                                    ('encmlp_dual_fwd', 24, 2, 3, False),
                                    ('encmlp_fwd', 16, 1, 4096, True),
                                    ('encmlp_dual_fwd', 64, 2, 4096, True),
                                    ('encmlp_fwd', 16, 1, 2048, True),
                                    ('encmlp_dual_fwd', 64, 2, 2048, True)):
        ins = C.kernel_inputs(FE, T, rc, cfg, params, S, R, device, codes)
        run, plain = C._calls(FE, *ins, nnet)
        out[f'{name} R={R} S={S} codes={codes}'] = (
            run, plain, FE.kernel_cost(ins[0], ins[1], R * S, nnet))
    for R, S, codes, cat in ((171, 24, True, False), (171, 24, False, True),
                             (4096, 64, True, False), (2048, 64, True, False),
                             (2048, 16, True, False)):
        st, xs, xvs, flat = C.split_inputs(FM, T, cfg, rc2, params2, R, S,
                                           device, codes, cat)
        run, plain = C._split_calls(FM, st, xs, xvs, flat)
        out[f'mlp_fwd R={R} S={S} parts={st.vparts}'] = (
            run, plain, FM.kernel_cost(st, R * S))
    return out


def kernel_ms(run, reps=10):
    """Device ms per call of the forward kernel alone (torch.profiler)."""
    import chip_smoke as C
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    return sum(C._device_ms(e) for e in prof.key_averages()
               if 'fwd_kernel' in e.key) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('ab_fwd_kernels: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from anerf_torch.ops import cuda_build
    ap = argparse.ArgumentParser()
    ap.add_argument('--variant', action='append', default=[],
                    help='NAME=CSRC_DIR[:FLAG,...]')
    args = ap.parse_args()
    variants = {}
    tree = os.path.join(ROOT, 'anerf_torch', 'csrc')
    for v in args.variant or [f'tree={tree}']:
        name, spec = v.split('=', 1)
        csrc, _, flags = spec.partition(':')
        variants[name] = (os.path.join(ROOT, csrc),
                          [f for f in flags.split(',') if f])
    os.makedirs(OUT, exist_ok=True)
    gpu = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(gpu, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    libs = build(variants, cuda_build._nvcc())
    cuda_build.build_kernels()   # all four, so that library() builds no more
    print(f'builds {time.perf_counter() - t0:.1f} s', flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    todo = cases(torch.device('cuda'))
    refs = {k: [t.clone() for t in plain()]
            for k, (_, plain, _) in todo.items()}
    res = {name: {} for name in libs}

    def use(name):
        cuda_build._LIBS.update({cuda_build.lib_key(w): lib
                                 for w, lib in libs[name].items()})

    ok = {}
    for name in libs:
        use(name)
        ok[name] = True
        for k, (run, _, _) in todo.items():
            got = run()
            torch.cuda.synchronize()
            try:
                C._check_close(f'{name} {k}', refs[k], got)
            except AssertionError as e:
                print(f'{name} {k}: {e}', flush=True)
                ok[name] = False
            if not all(torch.equal(a, b) for a, b in zip(got, run())):
                print(f'{name} {k}: differs between two calls', flush=True)
                ok[name] = False
    order = [n for n in libs if ok[n]]
    for rnd, seq in enumerate((order, order[::-1])):
        for name in seq:
            use(name)
            for k, (run, _, cost) in todo.items():
                if ' R=171 ' in k or ' R=7 ' in k or ' R=3 ' in k:
                    continue
                ms, kms = C._time_ms(run, 10), kernel_ms(run)
                res[name].setdefault(k, []).append(dict(ms=ms, kernel_ms=kms))
                tflops = cost['bf16_flops'] / (kms or ms) * 1e-9
                print(f'{name} round {rnd} {k}: {ms:.3f} ms (kernel alone '
                      f'{kms:.3f}), {tflops:.1f} TFLOP/s', flush=True)
    with open(os.path.join(OUT, 'res.json'), 'w') as f:
        json.dump(dict(gpu=gpu, variants=variants, ok=ok, res=res), f,
                  indent=1)
    return 0 if all(ok.values()) else 1


if __name__ == '__main__':
    sys.exit(main())
