"""Build, load and bind the hand-written CUDA kernels.

Every source under ``anerf_torch/csrc`` is compiled by ``nvcc`` for
sm_90a into a shared library with a plain C interface, loaded with
ctypes (no PyTorch headers, so a build takes seconds).  One library per
source, and for the split-operand MLP kernels one per shape:

  * ``fwd``     ``csrc/encmlp_fwd.cu``  K1, K2 (fused encode + MLP);
  * ``bwd``     ``csrc/encmlp_bwd.cu``  K3, K4 (their backwards);
  * ``viewfac`` ``csrc/viewfac.cu``     K-vf1, K-vf2 (the view
    factorization's per-ray operand and fold around K1-K4);
  * ``mlp_fwd`` ``csrc/mlp_fwd.cu``     K5 (split-operand MLP);
  * ``mlp_bwd`` ``csrc/mlp_bwd.cu``     K6 (its backward).

K5 and K6 are compiled for one shape each, as the TPU's Mosaic compiles
its kernel per static shape: a trunk width (``-DANERF_DX=dx``, the sum
of the trunk parts: 432 at the flagship's encoders, 117, 1152 or 1197
at others') and a net (``-DANERF_DEPTH``, ``-DANERF_WIDTH`` a multiple of
256, ``-DANERF_SKIP``: the depth, the width a net is padded to, the skip
after layer 4; ``fused_mlp.kernel_static``).  ``build_kernels``
starts one nvcc per library it lacks, all together, into
``anerf_torch/_build/``; each library is keyed by the hash of its
source, the shared headers (``csrc/*.cuh``) and its shape, so an edit
rebuilds it.  ``library`` builds a shape at its first use.  Nothing here
runs at import: the CPU tests import every module, and this machine may
have no nvcc.
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
from typing import Dict, Iterable, Optional, Tuple

import torch

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
_CSRC = os.path.join(_ROOT, 'csrc')
_SOURCES = {'fwd': 'encmlp_fwd.cu', 'bwd': 'encmlp_bwd.cu',
            'viewfac': 'viewfac.cu', 'mlp_fwd': 'mlp_fwd.cu',
            'mlp_bwd': 'mlp_bwd.cu'}
# the libraries built per shape, and K1-K4's shape: the trunk width,
# the nets' depth and width, the skip layer
_SHAPED = ('mlp_fwd', 'mlp_bwd')
FLAGSHIP_DX = 432
FLAGSHIP_NET = (8, 256)
SKIP = 4
_BUILD_DIR = os.path.join(_ROOT, '_build')
# lib_key(...) -> the loaded library
_LIBS: Dict[Tuple, ctypes.CDLL] = {}


def lib_key(which: str, dx: Optional[int] = None, depth: int = 8,
            width: int = 256) -> Tuple:
    """``_LIBS``'s key of library ``which``: for K5/K6 at trunk width
    ``dx`` (the flagship's by default) and a ``depth`` x ``width`` net
    (the compiled width, a multiple of 256), ``(which, dx)`` at the flagship's
    8 x 256 and ``(which, dx, depth, width)`` at any other net."""
    if which not in _SOURCES:
        raise KeyError(f'no library {which!r}')
    if which not in _SHAPED:
        return which, None
    dx = FLAGSHIP_DX if dx is None else int(dx)
    if (int(depth), int(width)) == FLAGSHIP_NET:
        return which, dx
    return which, dx, int(depth), int(width)


def _shape_flags(key: Tuple) -> list:
    """nvcc's defines of a K5/K6 key: the trunk width and, at a net
    other than 8 x 256, the net's depth, width and skip layer."""
    if key[1] is None:
        return []
    depth, width = key[2:] if len(key) == 4 else FLAGSHIP_NET
    flags = [f'-DANERF_DX={key[1]}']
    if (depth, width) != FLAGSHIP_NET:
        flags += [f'-DANERF_DEPTH={depth}', f'-DANERF_WIDTH={width}',
                  f'-DANERF_SKIP={SKIP}']
    return flags


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
            # p (or the depths), enc_ray, codes, cutoff, tau, wpack,
            # bpack, viewfac's M, fuse_tform's affine rows, out, n, S, R,
            # stream
            sig(name, [vp] * 10 + [ci] * 3 + [vp])
        sig('encmlp_weight_elems', [], cll)
        sig('encmlp_bias_elems', [])
    elif which == 'bwd':
        for name in ('encmlp_bwd', 'encmlp_dual_bwd'):
            # p (or the depths), enc_ray, codes, cutoff, tau, wpack,
            # wpack_b, bpack, g, workspace, dp, denc, dcodes, dw, db, dW
            # partials, viewfac's M and Gw, fuse_tform's affine rows, P,
            # slice, n, S, R, stream
            sig(name, [vp] * 19 + [ci] * 5 + [vp])
        sig('encmlp_bwd_workspace_bytes', [ci, ci], cll)
        sig('encmlp_grad_weight_elems', [], cll)
    elif which == 'viewfac':
        # enc_ray, wvx, M, R, nnet, stream
        sig('viewfac_m', [vp, vp, vp, ci, ci, vp])
        # Gw, enc_ray, wvx, dw, dw stride, denc, partials, P, slice, R,
        # nnet, stream
        sig('viewfac_fold', [vp, vp, vp, vp, cll, vp, vp] + [ci] * 4 + [vp])
        sig('viewfac_width', [])
        sig('viewfac_slice', [])
    elif which == 'mlp_fwd':
        # x ptrs, x widths, nx, xv ptrs, xv widths, nxv, wpack, bpack,
        # workspace, out, n, stream
        sig('mlp_fwd', [vp, vp, ci, vp, vp, ci, vp, vp, vp, vp, ci, vp])
        sig('mlp_fwd_workspace_bytes', [ci], cll)
        sig('mlp_weight_elems', [], cll)
        sig('mlp_bias_elems', [])
    else:
        # x ptrs, x widths, nx, xv ptrs, xv widths, nxv, wpack, wpack_b,
        # bpack, g, workspace, dx ptrs, dxv ptrs, dw, db, dW partials,
        # P, slice, n, stream
        sig('mlp_bwd', [vp, vp, ci, vp, vp, ci] + [vp] * 10
            + [ci] * 3 + [vp])
        sig('mlp_bwd_workspace_bytes', [ci], cll)
        sig('mlp_grad_weight_elems', [], cll)
    if which in _SHAPED:
        for name in ('mlp_trunk_width', 'mlp_net_depth', 'mlp_net_width'):
            sig(name, [])


def build_kernels(verbose: bool = False,
                  trunk_widths: Iterable[int] = (),
                  shapes: Iterable[Tuple[int, int, int]] = ()) -> float:
    """Compile every library not loaded yet for sm_90a into ``_build/``:
    K1-K4's, K-vf1/K-vf2's and K5/K6's at the flagship's shape, K5/K6's at each of
    ``trunk_widths`` (8 x 256 nets) and at each (trunk width, depth,
    compiled width) of ``shapes``; one nvcc per library, all started
    together.  Load them, and return the seconds spent (0 when all were
    loaded already).  A failed build raises with nvcc's output."""
    wanted = [lib_key(w) for w in _SOURCES]
    wanted += [lib_key(w, dx) for dx in sorted(set(trunk_widths))
               for w in _SHAPED]
    wanted += [lib_key(w, *shape) for shape in dict.fromkeys(shapes)
               for w in _SHAPED]
    todo = [k for k in dict.fromkeys(wanted) if k not in _LIBS]
    if not todo:
        return 0.
    t0 = time.perf_counter()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    headers = b''
    for h in sorted(glob.glob(os.path.join(_CSRC, '*.cuh'))):
        with open(h, 'rb') as f:
            headers += f.read()
    jobs = {}
    for key in todo:
        which, dx = key[:2]
        name = _SOURCES[which]
        src = os.path.join(_CSRC, name)
        flags = _shape_flags(key)
        with open(src, 'rb') as f:
            digest = hashlib.sha1(f.read() + headers + ' '.join(flags).encode()
                                  ).hexdigest()[:12]
        tag = name[:-3] if dx is None else f'{name[:-3]}_dx{dx}'
        if len(key) == 4:
            tag += f'_d{key[2]}w{key[3]}'
        so = os.path.join(_BUILD_DIR, f'lib{tag}_{digest}.so')
        if os.path.exists(so):
            jobs[key] = (so, None, None)
            continue
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
               '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
               '-o', tmp, src]
        cmd[1:1] = flags
        if verbose:
            cmd[1:1] = ['-Xptxas', '-v']
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[key] = (so, tmp, proc)
    errors = []
    for key, (so, tmp, proc) in jobs.items():
        if proc is None:
            continue
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f'nvcc {key} failed ({proc.returncode}):\n{out}')
            continue
        if verbose:
            print(out)
        os.replace(tmp, so)
    if errors:
        raise RuntimeError('\n'.join(errors))
    for key, (so, _, _) in jobs.items():
        lib = ctypes.CDLL(so)
        _bind(lib, key[0])
        _LIBS[key] = lib
    return time.perf_counter() - t0


def library(which: str, dx: Optional[int] = None, depth: int = 8,
            width: int = 256) -> ctypes.CDLL:
    """The loaded library ``which`` (see the module docstring; K5/K6's at
    trunk width ``dx`` and a ``depth`` x ``width`` net, the flagship's by
    default), built on first use."""
    key = lib_key(which, dx, depth, width)
    if key not in _LIBS:
        build_kernels(shapes=() if key[1] is None
                      else ((key[1], depth, width),))
    return _LIBS[key]


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
