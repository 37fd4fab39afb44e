"""Build, load and bind the hand-written CUDA kernels.

Every source under ``anerf_torch/csrc`` is compiled by ``nvcc`` for
sm_90a into a shared library with a plain C interface, loaded with
ctypes (no PyTorch headers, so a build takes seconds).  One library per
source:

  * ``fwd``     ``csrc/encmlp_fwd.cu``  K1, K2 (fused encode + MLP);
  * ``bwd``     ``csrc/encmlp_bwd.cu``  K3, K4 (their backwards);
  * ``mlp_fwd`` ``csrc/mlp_fwd.cu``     K5 (split-operand MLP);
  * ``mlp_bwd`` ``csrc/mlp_bwd.cu``     K6 (its backward).

``build_kernels`` starts one nvcc per source, all together, into
``anerf_torch/_build/``; each library is keyed by the hash of its source
and of the shared headers (``csrc/*.cuh``), so an edit rebuilds it.
Nothing here runs at import: the CPU tests import every module, and
this machine may have no nvcc.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict

import torch

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
_CSRC = os.path.join(_ROOT, 'csrc')
_SOURCES = {'fwd': 'encmlp_fwd.cu', 'bwd': 'encmlp_bwd.cu',
            'mlp_fwd': 'mlp_fwd.cu', 'mlp_bwd': 'mlp_bwd.cu'}
_BUILD_DIR = os.path.join(_ROOT, '_build')
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the fused kernels build on a '
                       'machine with the CUDA toolkit')


def _bind(lib: ctypes.CDLL, which: str) -> None:
    """Declare the C signatures of one library (ctypes would otherwise
    pass every pointer as a 32-bit int)."""
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def sig(name, args, res=ci):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    if which == 'fwd':
        for name in ('encmlp_fwd', 'encmlp_dual_fwd'):
            # p, enc_ray, codes, cutoff, tau, wpack, bpack, out, n, S, R,
            # stream
            sig(name, [vp] * 8 + [ci] * 3 + [vp])
        sig('encmlp_weight_elems', [], cll)
        sig('encmlp_bias_elems', [])
    elif which == 'bwd':
        for name in ('encmlp_bwd', 'encmlp_dual_bwd'):
            # p, enc_ray, codes, cutoff, tau, wpack, wpack_b, bpack, g,
            # workspace, dp, denc, dcodes, dw, db, n, S, R, stream
            sig(name, [vp] * 15 + [ci] * 3 + [vp])
        sig('encmlp_bwd_workspace_bytes', [ci, ci], cll)
        sig('encmlp_grad_weight_elems', [], cll)
    elif which == 'mlp_fwd':
        # x ptrs, x widths, nx, xv ptrs, xv widths, nxv, wpack, bpack,
        # out, n, stream
        sig('mlp_fwd', [vp, vp, ci, vp, vp, ci, vp, vp, vp, ci, vp])
        sig('mlp_weight_elems', [], cll)
        sig('mlp_bias_elems', [])
    else:
        # x ptrs, x widths, nx, xv ptrs, xv widths, nxv, wpack, wpack_b,
        # bpack, g, workspace, dx ptrs, dxv ptrs, dw, db, n, stream
        sig('mlp_bwd', [vp, vp, ci, vp, vp, ci] + [vp] * 9 + [ci, vp])
        sig('mlp_bwd_workspace_bytes', [ci], cll)
        sig('mlp_grad_weight_elems', [], cll)


def build_kernels(verbose: bool = False) -> float:
    """Compile every source for sm_90a into ``_build/``, one nvcc per
    source, all started together, and load the libraries.  Returns the
    seconds spent (0 when all were loaded already).  A failed build
    raises with nvcc's output."""
    if len(_LIBS) == len(_SOURCES):
        return 0.
    t0 = time.perf_counter()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    headers = b''
    for h in sorted(glob.glob(os.path.join(_CSRC, '*.cuh'))):
        with open(h, 'rb') as f:
            headers += f.read()
    jobs = {}
    for which, name in _SOURCES.items():
        src = os.path.join(_CSRC, name)
        with open(src, 'rb') as f:
            digest = hashlib.sha1(f.read() + headers).hexdigest()[:12]
        so = os.path.join(_BUILD_DIR, f'lib{name[:-3]}_{digest}.so')
        if os.path.exists(so):
            jobs[which] = (so, None, None)
            continue
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
               '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
               '-o', tmp, src]
        if verbose:
            cmd[1:1] = ['-Xptxas', '-v']
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[which] = (so, tmp, proc)
    errors = []
    for which, (so, tmp, proc) in jobs.items():
        if proc is None:
            continue
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f'nvcc {which} failed ({proc.returncode}):\n{out}')
            continue
        if verbose:
            print(out)
        os.replace(tmp, so)
    if errors:
        raise RuntimeError('\n'.join(errors))
    for which, (so, _, _) in jobs.items():
        lib = ctypes.CDLL(so)
        _bind(lib, which)
        _LIBS[which] = lib
    return time.perf_counter() - t0


def library(which: str) -> ctypes.CDLL:
    """The loaded library ``which`` (see the module docstring), built
    on first use."""
    build_kernels()
    return _LIBS[which]


def device_of(t: torch.Tensor) -> str:
    """'cpu' (the plain twins) or 'cuda' (the kernels); any other
    device raises."""
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {t.device}')
    return t.device.type


def stream(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the C interfaces
    take it."""
    return torch.cuda.current_stream(device).cuda_stream
