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

Every library is compiled for one static shape, as the TPU's Mosaic
compiles its kernel per static shape.  K5 and K6: a trunk width
(``-DANERF_DX=dx``, the sum of the trunk parts: 432 at the flagship's
encoders, 117, 1152 or 1197 at others'), a net (``-DANERF_DEPTH``,
``-DANERF_WIDTH`` a multiple of 256, ``-DANERF_SKIP``: the depth, the
width a net is padded to, the skip after layer 4;
``fused_mlp.kernel_static``) and a views width (``-DANERF_DXV``, past
672: ``MLPStatic.xv_pad``).  K1-K4: an encode shape ``(NF, NB, bone
window, depth, width, framecode columns)`` (``-DANERF_NF`` kp bands,
``-DANERF_NB`` view PE rows, ``-DANERF_BONE_WIN``, ``-DANERF_DX`` their
trunk width, ``-DANERF_DEPTH`` and, past 256, ``-DANERF_WIDTH``, past
16 ``-DANERF_NCODE``; ``fused_encmlp.kernel_shape``: widths 256-2048),
and K-vf1/K-vf2 its view rows NB and views width HV (``-DANERF_WIDTH``
= 2 HV past 128: 256-1024).  The flagship's shapes build with no
flags.
``build_kernels`` starts one nvcc per library it lacks, all together,
into ``anerf_torch/_build/``; each library is keyed by the hash of its
source, the shared headers (``csrc/*.cuh``) and its shape's flags, so an
edit rebuilds it.  ``library`` builds a shape at its first use.  Nothing
here runs at import: the CPU tests import every module, and this machine
may have no nvcc.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

import torch

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
_CSRC = os.path.join(_ROOT, 'csrc')
_SOURCES = {'fwd': 'encmlp_fwd.cu', 'bwd': 'encmlp_bwd.cu',
            'viewfac': 'viewfac.cu', 'mlp_fwd': 'mlp_fwd.cu',
            'mlp_bwd': 'mlp_bwd.cu'}
# the split-operand libraries (K5/K6), built per trunk width and net,
# and the fused encode's (K1-K4, K-vf1/K-vf2), built per encode shape
_SHAPED = ('mlp_fwd', 'mlp_bwd')
_ENC = ('fwd', 'bwd', 'viewfac')
FLAGSHIP_DX = 432
FLAGSHIP_NET = (8, 256)
# K5/K6's views width up to 672 parts' columns (csrc/encmlp_common.cuh
# DXV's default)
FLAGSHIP_XV = 672
SKIP = 4
# K1-K4's flagship shape: (kp bands NF, view PE rows NB, bone window,
# depth, width, framecode columns NCODE), the defaults of
# csrc/encmlp_common.cuh (a shape of five leaves NCODE at 16);
# K-vf1/K-vf2's: (NB, views width HV)
FLAGSHIP_ENC = (7, 9, False, 8, 256, 16)
FLAGSHIP_VF = (9, 128)
_BUILD_DIR = os.path.join(_ROOT, '_build')
# lib_key(...) -> the loaded library
_LIBS: Dict[Tuple, ctypes.CDLL] = {}


def enc_shape(enc: Optional[Tuple] = None) -> Tuple:
    """A K1-K4 encode shape as six values (NF, NB, bone window, depth,
    width, framecode columns): the flagship's for None, NCODE 16 for a
    shape of five."""
    nf, nb, bw, d, w, *nc = FLAGSHIP_ENC if enc is None else enc
    return (int(nf), int(nb), bool(bw), int(d), int(w),
            int(nc[0]) if nc else FLAGSHIP_ENC[5])


def lib_key(which: str, dx: Optional[int] = None, depth: int = 8,
            width: int = 256, enc: Optional[Tuple] = None,
            xv: int = FLAGSHIP_XV) -> Tuple:
    """``_LIBS``'s key of library ``which``.  K5/K6 at trunk width ``dx``
    (the flagship's by default), a ``depth`` x ``width`` net (the
    compiled width, a multiple of 256) and views width ``xv``:
    ``(which, dx)`` at the flagship's 8 x 256 and 672, ``(which, dx,
    depth, width)`` at any other net, ``(which, dx, depth, width, xv)``
    past 672.  K1-K4 (``'fwd'``, ``'bwd'``) at the encode shape ``enc``
    (``enc_shape``) and K-vf1/K-vf2 (``'viewfac'``) at ``enc`` = (view PE
    rows NB, views width HV): ``(which, None)`` at the flagship's, else
    ``(which, 'enc', NF, NB, bone window, depth, width)`` (framecodes of
    16) or ``(which, 'enc', NF, NB, bone window, depth, width, NCODE)``
    and ``('viewfac', 'enc', NB, HV)``."""
    if which not in _SOURCES:
        raise KeyError(f'no library {which!r}')
    if which == 'viewfac':
        vf = FLAGSHIP_VF if enc is None else (int(enc[0]), int(enc[1]))
        return (which, None) if vf == FLAGSHIP_VF else (which, 'enc') + vf
    if which in _ENC:
        shape = enc_shape(enc)
        if shape == FLAGSHIP_ENC:
            return which, None
        return (which, 'enc') + (shape if shape[5] != FLAGSHIP_ENC[5]
                                 else shape[:5])
    dx = FLAGSHIP_DX if dx is None else int(dx)
    if int(xv) != FLAGSHIP_XV:
        return which, dx, int(depth), int(width), int(xv)
    if (int(depth), int(width)) == FLAGSHIP_NET:
        return which, dx
    return which, dx, int(depth), int(width)


def _shape_flags(key: Tuple) -> list:
    """nvcc's defines of a key: none at the flagship's shapes; for
    K5/K6 the trunk width and, at a net other than 8 x 256, the net's
    depth, width and skip layer, past 672 the views width; for K1-K4
    every define of the encode shape (NCODE past 16), for K-vf1/K-vf2
    its view rows."""
    if key[1] is None:
        return []
    if key[1] == 'enc':
        if key[0] == 'viewfac':
            nb, hv = key[2:]
            return [f'-DANERF_NB={nb}'] + (
                [f'-DANERF_WIDTH={2 * hv}'] if hv != FLAGSHIP_VF[1] else [])
        nf, nb, bw, depth, width, ncode = enc_shape(key[2:])
        flags = [f'-DANERF_NF={nf}', f'-DANERF_NB={nb}',
                 f'-DANERF_DX={(2 * nf + 1) * 24 + 72}',
                 f'-DANERF_DEPTH={depth}', f'-DANERF_BONE_WIN={int(bw)}']
        return flags + ([f'-DANERF_WIDTH={width}']
                        if width != FLAGSHIP_ENC[4] else []) + (
            [f'-DANERF_NCODE={ncode}'] if ncode != FLAGSHIP_ENC[5] else [])
    depth, width = key[2:4] if len(key) >= 4 else FLAGSHIP_NET
    flags = [f'-DANERF_DX={key[1]}']
    if (depth, width) != FLAGSHIP_NET:
        flags += [f'-DANERF_DEPTH={depth}', f'-DANERF_WIDTH={width}',
                  f'-DANERF_SKIP={SKIP}']
    if len(key) == 5:
        flags.append(f'-DANERF_DXV={key[4]}')
    return flags


def _tag(key: Tuple) -> str:
    """The file name stem of a key's library."""
    stem = _SOURCES[key[0]][:-3]
    if key[1] is None:
        return stem
    if key[1] == 'enc':
        if key[0] == 'viewfac':
            return f'{stem}_nb{key[2]}hv{key[3]}'
        nf, nb, bw, depth, width, ncode = enc_shape(key[2:])
        return (f'{stem}_nf{nf}nb{nb}bw{int(bw)}d{depth}w{width}'
                + (f'c{ncode}' if ncode != FLAGSHIP_ENC[5] else ''))
    tag = f'{stem}_dx{key[1]}'
    if len(key) >= 4:
        tag += f'_d{key[2]}w{key[3]}'
    if len(key) == 5:
        tag += f'_xv{key[4]}'
    return tag


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
            # bpack, viewfac's M, fuse_tform's affine rows, the trunk
            # input's workspace, out, n, S, R, stream
            sig(name, [vp] * 11 + [ci] * 3 + [vp])
        sig('encmlp_weight_elems', [], cll)
        sig('encmlp_bias_elems', [])
        sig('encmlp_fwd_workspace_bytes', [ci], cll)
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
        # R, nnet, P
        sig('viewfac_fold_scratch', [ci, ci, ci], cll)
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
    if which == 'mlp_fwd' and hasattr(lib, 'mlp_views_width'):
        sig('mlp_views_width', [])
    # the build's encode shape (absent from builds before it was a
    # define, which scripts/compare_builds.py loads)
    if which in ('fwd', 'bwd') and hasattr(lib, 'encmlp_shape'):
        sig('encmlp_shape', [ctypes.POINTER(ci)])
    if which == 'viewfac' and hasattr(lib, 'viewfac_rows'):
        sig('viewfac_rows', [])


def _check_built(key: Tuple, lib: ctypes.CDLL) -> None:
    """A K1-K4 library must be built for the encode shape of its key, a
    K-vf1/K-vf2 library for its view rows and views width (its flags
    reached the sources)."""
    if key[0] == 'viewfac':
        want = FLAGSHIP_VF if key[1] is None else key[2:]
        got = lib.viewfac_rows(), lib.viewfac_width()
    elif key[0] in _ENC:
        want = enc_shape(None if key[1] is None else key[2:])
        out = (ctypes.c_int * 6)()
        count = lib.encmlp_shape(out)
        got = enc_shape((out[0], out[1], bool(out[2]), out[3], out[4])
                        + tuple(out[5:count]))
    else:
        return
    if got != want:
        raise RuntimeError(f'library {key} was built for {got}, not {want}')


def build_kernels(verbose: bool = False,
                  trunk_widths: Iterable[int] = (),
                  shapes: Iterable[Tuple[int, ...]] = (),
                  enc_shapes: Iterable[Tuple] = (),
                  view_shapes: Iterable[Tuple[int, int]] = ()) -> float:
    """Compile every library not loaded yet for sm_90a into ``_build/``:
    K1-K4's, K-vf1/K-vf2's and K5/K6's at the flagship's shape, K5/K6's at each of
    ``trunk_widths`` (8 x 256 nets) and at each (trunk width, depth,
    compiled width[, views width]) of ``shapes``, K1-K4's and
    K-vf1/K-vf2's at each encode shape (``enc_shape``) of
    ``enc_shapes``, K-vf1/K-vf2's at each (NB, HV) of ``view_shapes``;
    one nvcc per library, all started together.  Load them, and return
    the seconds spent (0 when all were loaded already).  A failed build
    raises with nvcc's output."""
    wanted = [lib_key(w) for w in _SOURCES]
    wanted += [lib_key(w, dx) for dx in sorted(set(trunk_widths))
               for w in _SHAPED]
    wanted += [lib_key(w, *shape[:3], xv=shape[3] if len(shape) > 3
                       else FLAGSHIP_XV)
               for shape in dict.fromkeys(shapes) for w in _SHAPED]
    enc_shapes = list(dict.fromkeys(enc_shapes))
    wanted += [lib_key(w, enc=shape) for shape in enc_shapes
               for w in ('fwd', 'bwd')]
    wanted += [lib_key('viewfac', enc=vf) for vf in
               [(shape[1], shape[4] // 2) for shape in enc_shapes]
               + list(view_shapes)]
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
        src = os.path.join(_CSRC, _SOURCES[key[0]])
        flags = _shape_flags(key)
        with open(src, 'rb') as f:
            digest = hashlib.sha1(f.read() + headers + ' '.join(flags).encode()
                                  ).hexdigest()[:12]
        so = os.path.join(_BUILD_DIR, f'lib{_tag(key)}_{digest}.so')
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
    # each nvcc's output and seconds, read by a thread of its own (a
    # library's ptxas report may outgrow the pipe before its turn)
    done = {}

    def wait(key, proc):
        out, _ = proc.communicate()
        done[key] = (out, time.perf_counter() - t0)
    threads = [threading.Thread(target=wait, args=(key, proc))
               for key, (_, _, proc) in jobs.items() if proc is not None]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    errors = []
    for key, (so, tmp, proc) in jobs.items():
        if proc is None:
            continue
        out, secs = done[key]
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f'nvcc {key} failed ({proc.returncode}):\n{out}')
            continue
        if verbose:
            print(f'nvcc {_tag(key)}: {secs:.1f} s\n{out}')
        os.replace(tmp, so)
    if errors:
        raise RuntimeError('\n'.join(errors))
    for key, (so, _, _) in jobs.items():
        lib = ctypes.CDLL(so)
        _bind(lib, key[0])
        _check_built(key, lib)
        _LIBS[key] = lib
    return time.perf_counter() - t0


def library(which: str, dx: Optional[int] = None, depth: int = 8,
            width: int = 256, enc: Optional[Tuple] = None,
            xv: int = FLAGSHIP_XV) -> ctypes.CDLL:
    """The loaded library ``which`` (see the module docstring; K5/K6's at
    trunk width ``dx``, a ``depth`` x ``width`` net and views width
    ``xv``, K1-K4's at the encode shape ``enc``, K-vf1/K-vf2's at the
    (view rows, views width) ``enc``, the flagship's by default), built
    on first use: K1-K4's with the K-vf1/K-vf2 build of their view rows
    and width, all at once."""
    key = lib_key(which, dx, depth, width, enc, xv)
    if key not in _LIBS:
        if which == 'viewfac':
            build_kernels(view_shapes=() if key[1] is None else (key[2:],))
        elif which in _ENC:
            build_kernels(enc_shapes=() if enc is None else (enc,))
        else:
            build_kernels(shapes=() if key[1] is None
                          else ((key[1], depth, width, xv),))
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
