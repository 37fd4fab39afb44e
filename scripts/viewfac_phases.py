#!/usr/bin/env python3
"""What K-vf2's time is made of, on one GPU.

    python3 scripts/viewfac_phases.py [R]

No kernel profiler runs on the card's machine, so this takes the parts
of K-vf2's fold kernel (``anerf_torch/csrc/viewfac.cu``,
``vf_fold_kernel``) out one at a time: it builds copies of the source
with a part removed (its outputs then wrong), times every build on the
train step's inputs at R rays (2048 by default; Gram matrices drawn from
seed 0) as ``chip_smoke.viewfac_kernels`` times the tree's (20 calls
replayed from a CUDA graph, ``chip_smoke._graph_ms``), 3 rounds in
turns, and prints each build's median and what removing the part saved:

  pull       the denc hand-back (remote reads of the 8 blocks' Ds)
  send       the view values' hand-over (remote writes of E)
  loads      the next slices' view-value copies
  products   the dWvx and denc mma.sync products
  all four   all of them out: what is left is the Gw ring, the
             weights, the first two slices' hand-over, the barriers and
             the slice sum

Prints the card's name and power limit first.  The patches match the
source's text; a source they no longer match fails with the anchor
that is missing.
"""
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, 'anerf_torch', 'csrc')
PARTS = {
    'pull': [('    if (t > 0) pull_d(t - 1);\n', ''),
             ('  pull_d(T - 1);\n', '')],
    'send': [('      send_x(t + 2);\n', '')],
    'loads': [('        load_x(t + 2);\n', '')],
    'products': [('      if (dw_warp && wn < nnet) {\n#pragma unroll',
                  '      if (dw_warp && wn < 0) {\n#pragma unroll'),
                 ('      } else if (!dw_warp) {', '      } else if (false) {')],
}
PARTS['all four'] = [p for k in ('pull', 'send', 'loads', 'products')
                     for p in PARTS[k]]


def build(name, patches, out_dir):
    """A copy of csrc with ``patches`` applied to viewfac.cu, built into
    a library (the nvcc process returned with its output path)."""
    from anerf_torch.ops import cuda_build
    d = os.path.join(out_dir, name.replace(' ', '_'))
    shutil.copytree(CSRC, d)
    path = os.path.join(d, 'viewfac.cu')
    with open(path) as f:
        text = f.read()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f'{name}: anchor not in viewfac.cu: {old!r}')
        text = text.replace(old, new, 1)
    with open(path, 'w') as f:
        f.write(text)
    so = os.path.join(d, 'lib.so')
    return so, subprocess.Popen(
        [cuda_build._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
         '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC', '-o', so,
         path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main(R=2048) -> int:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from anerf_torch import testing_utils as T
    from anerf_torch.interop import params_to
    from anerf_torch.models.factory import (build_raycast_config,
                                            init_raycaster_params)
    from anerf_torch.ops import cuda_build
    from anerf_torch.ops import fused_encmlp as FE
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    key = cuda_build.lib_key('viewfac')
    cuda_build.library('viewfac')
    os.makedirs(cuda_build._BUILD_DIR, exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=cuda_build._BUILD_DIR)
    jobs = {name: build(name, patches, out_dir)
            for name, patches in PARTS.items()}
    libs = {'tree': cuda_build._LIBS[key]}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'{name} failed to build:\n{log}')
        lib = ctypes.CDLL(so)
        cuda_build._bind(lib, 'viewfac')
        libs[name] = lib
    dev = torch.device('cuda')
    cfg = T.surreal_config(compute_dtype='bfloat16')
    rc = build_raycast_config(cfg, n_framecodes=9)
    params = params_to(init_raycaster_params(
        torch.Generator().manual_seed(1), rc, cfg), dev)
    ins = C.kernel_inputs(FE, T, rc, cfg, params, 64, R, dev, tile=512)
    est, enc, wvx = ins[1], ins[3], FE._wvx(ins[0], ins[7])
    gw = torch.randn((2, R, est.J, wvx.shape[-1]), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0)
                     ).to(torch.bfloat16)
    fold = lambda: FE.vf_fold(est, gw, enc, wvx)
    ms = {name: [] for name in libs}
    for _ in range(3):
        for name, lib in libs.items():
            cuda_build._LIBS[key] = lib
            ms[name].append(C._graph_ms(fold, 20))
    cuda_build._LIBS[key] = libs['tree']
    tree = statistics.median(ms['tree'])
    P, slice_ = FE.vf_fold_plan(R)
    print(f'vf_fold R={R}, two nets, {P} partials over slices of {slice_} '
          f'rays: the tree {tree:.4f} ms (rounds '
          + ', '.join(f'{x:.4f}' for x in ms['tree']) + ')')
    for name in PARTS:
        m = statistics.median(ms[name])
        print(f'  without {name:8s} {m:.4f} ms (rounds '
              + ', '.join(f'{x:.4f}' for x in ms[name])
              + f'): the part costs {tree - m:.4f} ms')
    return 0


if __name__ == '__main__':
    sys.exit(main(*[int(a) for a in sys.argv[1:2]]))
