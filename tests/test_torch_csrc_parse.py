"""The port's CUDA sources parse as CUDA device code with no error.

There is no nvcc on a machine without the toolkit, but libclang can
type-check the sources: each ``anerf_torch/csrc/*.cu`` file is parsed
with ``-x cuda --cuda-device-only -nocudainc`` against a small mock of
the CUDA API it uses (attributes, built-in variables, the bf16
intrinsics, the runtime calls the launchers make).  That catches C++
errors (undeclared names, wrong types, bad template instantiations) in
the kernels and the shared headers; PTX in inline assembly, register
limits and shared-memory sizes only show when nvcc builds them for the
card (``ops/cuda_build.build_kernels``).  ``chip_smoke.py`` counts and
times the kernels by the names of their ``__global__`` functions in a
profile: every name it looks for must be one.
"""
import os
import re
import sys

import pytest

from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, 'anerf_torch', 'csrc')

# what each source must define for its ctypes binding (ops/cuda_build.py)
EXPORTS = {
    'encmlp_fwd.cu': ('encmlp_fwd', 'encmlp_dual_fwd', 'encmlp_shape',
                      'encmlp_fwd_workspace_bytes'),
    'encmlp_bwd.cu': ('encmlp_bwd', 'encmlp_dual_bwd',
                      'encmlp_bwd_workspace_bytes', 'encmlp_shape'),
    'viewfac.cu': ('viewfac_m', 'viewfac_fold', 'viewfac_width',
                   'viewfac_slice', 'viewfac_rows'),
    'mlp_fwd.cu': ('mlp_fwd', 'mlp_trunk_width'),
    'mlp_bwd.cu': ('mlp_bwd', 'mlp_bwd_workspace_bytes', 'mlp_trunk_width'),
}
# the trunk widths K5/K6 are built for (nvcc -DANERF_DX=...): resident
# in shared memory (117, 432) and read in column chunks (1152, 1197;
# 2064, a 41-band reldist trunk, and 4096, the ceiling), odd widths
# padded to the k-step (117, 1197)
TRUNK_WIDTHS = (117, 432, 1152, 1197, 2064, 4096)
# the views widths K5/K6 are built for past 672 (nvcc -DANERF_DXV=...,
# fused_mlp.views_pad): resident in K5's shared memory (688, 832) and
# read in column chunks (1664, the former ceiling; 1792, 23 view rows with
# framecodes of 128; 4096, the ceiling), at the flagship's net, at 8 x
# 512 and WIDE (8 x 1024) and beside a chunked trunk input (1152, 4096)
VIEWS_WIDTHS = ((688, 432, 8, 256), (832, 432, 8, 256),
                (1664, 432, 8, 256), (1664, 432, 8, 512),
                (1664, 1152, 8, 512), (1664, 432, 8, 1024),
                (1792, 432, 8, 256), (4096, 432, 8, 256),
                (4096, 4096, 8, 1024))

CUDA_RUNTIME_H = r'''
#pragma once
#define __global__ __attribute__((global))
#define __device__ __attribute__((device))
#define __host__ __attribute__((host))
#define __shared__ __attribute__((shared))
#define __constant__ __attribute__((constant))
#define __forceinline__ __inline__ __attribute__((always_inline))
#define __launch_bounds__(...) __attribute__((launch_bounds(__VA_ARGS__)))
#define __align__(n) __attribute__((aligned(n)))
#define __grid_constant__ __attribute__((grid_constant))
#define __cluster_dims__(...)
typedef __SIZE_TYPE__ size_t;
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  __host__ __device__ dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1)
      : x(a), y(b), z(c) {}
};
extern const __device__ uint3 threadIdx, blockIdx;
extern const __device__ dim3 blockDim, gridDim;
struct __attribute__((aligned(16))) uint4 { unsigned x, y, z, w; };
struct __attribute__((aligned(8))) float2 { float x, y; };
struct __attribute__((aligned(16))) float4 { float x, y, z, w; };
__host__ __device__ uint4 make_uint4(unsigned, unsigned, unsigned, unsigned);
__host__ __device__ float2 make_float2(float, float);
__host__ __device__ float4 make_float4(float, float, float, float);
__device__ void __syncthreads();
__device__ void __trap();
__device__ void __syncwarp(unsigned = 0xffffffffu);
__device__ float __shfl_xor_sync(unsigned, float, int);
__device__ float __ldg(const float*);
__device__ unsigned __ldg(const unsigned*);
__device__ uint4 __ldg(const uint4*);
__device__ uint4 __ldcg(const uint4*);
__device__ float4 __ldg(const float4*);
__device__ size_t __cvta_generic_to_shared(const void*);
__device__ float sqrtf(float);
__device__ float expf(float);
__device__ float sinf(float);
__device__ float fmaxf(float, float);
__device__ float __fadd_rn(float, float);
__device__ float __fsub_rn(float, float);
__device__ float __fmul_rn(float, float);
__device__ float ldexpf(float, int);
__device__ float __fmaf_rn(float, float, float);
__host__ __device__ int min(int, int);
__host__ __device__ int max(int, int);
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801
};
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
enum { cudaEnableDefault = 0 };
cudaError_t cudaGetDriverEntryPoint(const char*, void**, unsigned long long,
                                    cudaDriverEntryPointQueryResult*);
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
cudaError_t cudaGetLastError();
cudaError_t cudaGetDevice(int*);
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int);
cudaError_t cudaConfigureCall(dim3, dim3, size_t = 0, cudaStream_t = 0);
'''

CUDA_BF16_H = r'''
#pragma once
#include "cuda_runtime.h"
struct __attribute__((aligned(2))) __nv_bfloat16 { unsigned short x; };
struct __attribute__((aligned(4))) __nv_bfloat162 { __nv_bfloat16 x, y; };
__host__ __device__ __nv_bfloat16 __float2bfloat16_rn(float);
__host__ __device__ float __bfloat162float(__nv_bfloat16);
__host__ __device__ __nv_bfloat162 __floats2bfloat162_rn(float, float);
__host__ __device__ __nv_bfloat16 __ushort_as_bfloat16(unsigned short);
__host__ __device__ unsigned short __bfloat16_as_ushort(__nv_bfloat16);
'''

CUDA_H = r'''
#pragma once
typedef unsigned int cuuint32_t;
typedef unsigned long long cuuint64_t;
typedef enum { CUDA_SUCCESS = 0 } CUresult;
typedef struct __attribute__((aligned(64))) { cuuint64_t opaque[16]; } CUtensorMap;
typedef enum { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 } CUtensorMapDataType;
typedef enum { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 } CUtensorMapInterleave;
typedef enum { CU_TENSOR_MAP_SWIZZLE_64B = 2 } CUtensorMapSwizzle;
typedef enum { CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 } CUtensorMapL2promotion;
typedef enum { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 } CUtensorMapFloatOOBfill;
'''

STDINT_H = r'''
#pragma once
typedef unsigned char uint8_t;
typedef unsigned int uint32_t;
typedef unsigned long long uint64_t;
'''


def _parse(path, include_dir, defines=()):
    cindex = pytest.importorskip('clang.cindex')
    try:
        index = cindex.Index.create()
    except cindex.LibclangError as e:  # the bindings without the library
        pytest.skip(f'libclang not loadable: {e}')
    return cindex, index.parse(path, args=[
        '-x', 'cuda', '--cuda-device-only', '-nocudainc', '-nocudalib',
        '--cuda-gpu-arch=sm_90a', '-std=c++17', '-nostdinc', '-nostdinc++',
        f'-I{include_dir}', *[f'-D{d}' for d in defines]])


@pytest.fixture(scope='module')
def mock_include(tmp_path_factory):
    d = tmp_path_factory.mktemp('cuda_mock')
    for name, text in (('cuda_runtime.h', CUDA_RUNTIME_H),
                       ('cuda_bf16.h', CUDA_BF16_H), ('cuda.h', CUDA_H),
                       ('stdint.h', STDINT_H)):
        (d / name).write_text(text)
    return str(d)


def test_every_source_is_listed():
    assert sorted(f for f in os.listdir(CSRC) if f.endswith('.cu')) == \
        sorted(EXPORTS)


@pytest.mark.parametrize('source', sorted(EXPORTS))
def test_source_parses_without_errors(source, mock_include):
    cindex, tu = _parse(os.path.join(CSRC, source), mock_include)
    errors = [str(d) for d in tu.diagnostics
              if d.severity >= cindex.Diagnostic.Error]
    assert not errors, '\n'.join(errors)
    defined = {c.spelling for c in tu.cursor.walk_preorder()
               if c.kind == cindex.CursorKind.FUNCTION_DECL
               and c.is_definition()}
    missing = [f for f in EXPORTS[source] if f not in defined]
    assert not missing, f'{source} does not define {missing}'


@pytest.mark.parametrize('dx', TRUNK_WIDTHS)
@pytest.mark.parametrize('source', ['mlp_fwd.cu', 'mlp_bwd.cu'])
def test_split_mlp_sources_parse_at_every_trunk_width(source, dx,
                                                       mock_include):
    """K5/K6 at each trunk width they are built for: the schedule tables,
    their coverage checks and the shared-memory budget are static
    asserts, so a width they cannot take fails here."""
    cindex, tu = _parse(os.path.join(CSRC, source), mock_include,
                        [f'ANERF_DX={dx}'])
    errors = [str(d) for d in tu.diagnostics
              if d.severity >= cindex.Diagnostic.Error]
    assert not errors, '\n'.join(errors)


@pytest.mark.parametrize('dxv,dx,depth,width', VIEWS_WIDTHS)
@pytest.mark.parametrize('source', ['mlp_fwd.cu', 'mlp_bwd.cu'])
def test_split_mlp_sources_parse_at_every_views_width(source, dxv, dx, depth,
                                                      width, mock_include):
    """K5/K6 at the views widths past 672 that they are built for: the
    residency choices, the shared-memory budgets and the schedules'
    tables are static asserts, so a width they cannot take fails here;
    the next width past the ceiling fails its own."""
    net = ([f'ANERF_DEPTH={depth}', f'ANERF_WIDTH={width}', 'ANERF_SKIP=4']
           if (depth, width) != (8, 256) else [])
    cindex, tu = _parse(os.path.join(CSRC, source), mock_include,
                        [f'ANERF_DX={dx}', f'ANERF_DXV={dxv}', *net])
    assert not _errors(cindex, tu), '\n'.join(_errors(cindex, tu))
    cindex, tu = _parse(os.path.join(CSRC, source), mock_include,
                        [f'ANERF_DX={dx}', 'ANERF_DXV=4112', *net])
    assert any('at most 4096 columns' in e for e in _errors(cindex, tu))


# the nets K5/K6 are built for (nvcc -DANERF_DEPTH, -DANERF_WIDTH,
# -DANERF_SKIP): no skip layer (2, 4), the skip layer (6, 8, 10, 24, 32),
# 512 wide (its ring, activations and masks budgeted apart), WIDE past
# 512 (768 with a views layer of three 128-column blocks, 1024: the
# activations in device memory), at a resident trunk (432) and a wide
# chunked one (2048); then past the former caps (ROADMAP C.16): 65 and 128
# layers, 2304 and 4096 wide, 40 x 2048 and the ceilings 128 x 2048 and
# 64 x 4096 (at the widest trunk), whose schedules' segments and
# coverage checks no longer grow into tables
NET_SHAPES = ((432, 2, 256), (432, 4, 256), (432, 6, 256), (432, 10, 256),
              (432, 24, 256), (117, 6, 512), (432, 8, 512), (1152, 8, 512),
              (2048, 24, 512), (432, 8, 1024), (432, 6, 768),
              (432, 32, 256), (2048, 32, 1024),
              (432, 65, 256), (432, 128, 256), (432, 8, 2304),
              (432, 8, 4096), (432, 40, 2048), (432, 128, 2048),
              (4096, 64, 4096))


@pytest.mark.parametrize('dx,depth,width', NET_SHAPES)
@pytest.mark.parametrize('source', ['mlp_fwd.cu', 'mlp_bwd.cu'])
def test_split_mlp_sources_parse_at_every_net_shape(source, dx, depth, width,
                                                    mock_include):
    """K5/K6 at each net shape: the schedules' generated tables, their
    coverage checks, the shared-memory budgets and the descriptors'
    parameter room are static asserts, so a shape they cannot take
    fails here."""
    cindex, tu = _parse(os.path.join(CSRC, source), mock_include,
                        [f'ANERF_DX={dx}', f'ANERF_DEPTH={depth}',
                         f'ANERF_WIDTH={width}', 'ANERF_SKIP=4'])
    errors = [str(d) for d in tu.diagnostics
              if d.severity >= cindex.Diagnostic.Error]
    assert not errors, '\n'.join(errors)


# the first value past each of K5/K6's ceilings (ROADMAP C.16), the
# static_assert it fails: trunk and views widths, depth, width, depth x
# width
SPLIT_REFUSED = [
    (['ANERF_DX=4097'], 'trunk inputs of 1 to 4096 columns'),
    (['ANERF_DXV=4112'], 'at most 4096 columns'),
    (['ANERF_DEPTH=129'], '1 to 128 trunk layers'),
    (['ANERF_DEPTH=8', 'ANERF_WIDTH=4352'],
     'nets a multiple of 256 wide, up to 4096'),
    (['ANERF_DEPTH=65', 'ANERF_WIDTH=4096'],
     'at most depth x width = 262,144')]


@pytest.mark.parametrize('defines,message', SPLIT_REFUSED,
                         ids=[d[-1] for d, _ in SPLIT_REFUSED])
@pytest.mark.parametrize('source', ['mlp_fwd.cu', 'mlp_bwd.cu'])
def test_split_mlp_sources_refuse_past_the_ceilings(source, defines,
                                                    message, mock_include):
    """K5/K6 past each ceiling fail the shared header's static_assert,
    where ``fused_mlp.kernel_refusal`` stops them before a build."""
    cindex, tu = _parse(os.path.join(CSRC, source), mock_include,
                        [*defines, 'ANERF_SKIP=4'])
    failed = [e for e in _errors(cindex, tu) if 'static assertion' in e]
    assert any(message in e for e in failed), failed


# K1-K4 (encmlp_fwd.cu, encmlp_bwd.cu) and K-vf1/K-vf2 (viewfac.cu) per
# encode shape (nvcc -DANERF_NF, -DANERF_NB, -DANERF_BONE_WIN, -DANERF_DX,
# -DANERF_DEPTH and -DANERF_WIDTH; cuda_build._shape_flags): one shape for
# each value of each axis fused_encmlp.kernel_shape admitted at first
# (kp bands 1-7, view rows 1-9, depths 1-8 (1-5 without a skip layer),
# the bone window), the extremes together, and the shapes whose trunk
# input leaves shared memory in some of the four kernels (ROADMAP
# B.1.2): 8 x 512, nine and 16 layers, eight and ten kp bands, and the
# corner, 16 layers of 512 at ten bands; then the views inputs of B.1.3:
# 11 view rows (viewfac's 48-column k-steps; K1/K2's trunk input out of
# shared memory), framecodes of 32, and the corner, 21 view rows with
# framecodes of 128 (the views input out of K1/K2's shared memory), at
# 8 x 256, at 8 x 512 and at 16 layers of 512 with 10 kp bands; then
# the WIDE nets (ROADMAP B.1.4's first part: K5/K6's body inside K1-K4,
# the activations in device memory, viewfac's staging a views block at a
# time): 768 (three 128-column views blocks), 1024, 1536 and 2048 wide,
# one layer at 768, 21 view rows with framecodes of 128 at 1024 (the
# views input rebuilt in each views block), and the deep corners, 16
# layers at 10 kp bands 1024 and 2048 wide (admitted since B.1.4's
# depth rows); then the kp bands
# past 10 up to the cap F_MAX (ROADMAP B.1.4's kp-band row, C.17): 11
# and 13 bands at 256 and at 512 wide; then the deep nets (B.1.4's depth
# rows: the recompute's and K1/K2's sums rounded to nearest, ENC_DEEP):
# 17, 24 and 32 layers at 256 wide, 20 and 24 at 512 (10 kp bands at 20),
# 9, 12 and 16 layers WIDE
ENC_SHAPES = ([dict(nf=f) for f in range(1, 7)]
              + [dict(nb=b) for b in (1, 3, 5, 7)]
              + [dict(depth=d) for d in range(1, 8)]
              + [dict(bw=1), dict(nf=7, nb=9, bw=1, depth=8),
                 dict(nf=1, nb=1, bw=1, depth=1)]
              + [dict(width=512), dict(depth=9), dict(depth=16),
                 dict(nf=8), dict(nf=10),
                 dict(nf=10, depth=16, width=512),
                 dict(nf=1, nb=1, depth=1, width=512)]
              + [dict(nb=11), dict(ncode=32), dict(nb=21, ncode=128),
                 dict(nb=21, ncode=128, width=512),
                 dict(nb=21, ncode=128, nf=10, depth=16, width=512)]
              + [dict(width=768), dict(width=1024), dict(width=1536),
                 dict(width=2048), dict(width=768, depth=1),
                 dict(nb=21, ncode=128, width=1024),
                 dict(nf=10, depth=16, width=1024),
                 dict(nf=10, depth=16, width=2048)]
              + [dict(nf=11), dict(nf=13), dict(nf=11, width=512),
                 dict(nf=13, width=512)]
              + [dict(depth=17), dict(nf=10, depth=24), dict(depth=32),
                 dict(nf=10, depth=20, width=512), dict(depth=24, width=512),
                 dict(depth=9, width=768),
                 dict(nf=10, depth=12, width=1024),
                 dict(nf=10, depth=9, width=2048),
                 dict(nf=10, depth=16, width=1536)])
# the first value each axis refuses, the source that refuses it and the
# message of the static_assert it fails (ROADMAP B.1.4): 23 view rows
# (the headers' cap; viewfac's four k-steps a joint), 2304 wide (K1-K4's
# own cap in the shared header under ANERF_ENC_KERNEL, and viewfac.cu's:
# K5/K6 take 4096 since C.16), framecodes of 144 (the headers' cap,
# past 128), 14 kp bands (one past the headers' F_MAX, past which anerf_tpu's band
# recurrence no longer holds to the model: ROADMAP C.17), one layer past
# each depth cap (33 at 256 wide, 25 at 512, 17 WIDE: ROADMAP B.1.4)
ENC_REFUSED = [
    (dict(nb=23), 'encmlp_fwd.cu', 'at most 21 view PE rows'),
    (dict(nb=23), 'viewfac.cu', 'whole joint groups'),
    (dict(width=2304), 'encmlp_fwd.cu',
     'nets a multiple of 256 wide, up to 2048'),
    (dict(width=2304), 'encmlp_bwd.cu',
     'nets a multiple of 256 wide, up to 2048'),
    (dict(width=2304), 'viewfac.cu',
     'nets a multiple of 256 wide, up to 2048'),
    (dict(ncode=144), 'encmlp_fwd.cu', 'framecodes of 16 to 128 columns'),
    (dict(ncode=144), 'encmlp_bwd.cu', 'framecodes of 16 to 128 columns'),
    (dict(nf=14), 'encmlp_fwd.cu', 'at most 13 kp bands'),
    (dict(nf=14), 'encmlp_bwd.cu', 'at most 13 kp bands'),
    (dict(depth=33), 'encmlp_fwd.cu', '1 to 32 trunk layers at 256 wide'),
    (dict(depth=33), 'encmlp_bwd.cu', '1 to 32 trunk layers at 256 wide'),
    (dict(depth=25, width=512), 'encmlp_fwd.cu', '1 to 24 at 512'),
    (dict(depth=25, width=512), 'encmlp_bwd.cu', '1 to 24 at 512'),
    (dict(depth=17, width=1024), 'encmlp_fwd.cu', '1 to 16 wider'),
    (dict(depth=17, width=2048), 'encmlp_bwd.cu', '1 to 16 wider')]


def _enc_defines(nf=7, nb=9, bw=0, depth=8, width=256, ncode=16):
    defines = [f'ANERF_NF={nf}', f'ANERF_NB={nb}', f'ANERF_BONE_WIN={bw}',
               f'ANERF_DX={(2 * nf + 1) * 24 + 72}', f'ANERF_DEPTH={depth}']
    return defines + ([f'ANERF_WIDTH={width}'] if width != 256 else []) + (
        [f'ANERF_NCODE={ncode}'] if ncode != 16 else [])


def _errors(cindex, tu):
    return [str(d) for d in tu.diagnostics
            if d.severity >= cindex.Diagnostic.Error]


@pytest.mark.parametrize('shape', ENC_SHAPES, ids=lambda d: '-'.join(
    f'{k}{v}' for k, v in d.items()))
def test_encode_sources_parse_at_every_admitted_shape(shape, mock_include):
    """K1-K4 and, at its view rows, K-vf1/K-vf2 at each encode shape the
    gate admits: the shared-memory budgets, the trunk's
    residency, the schedules' tables and their coverage checks are static
    asserts, so a shape they cannot take fails here."""
    for source in ('encmlp_fwd.cu', 'encmlp_bwd.cu', 'viewfac.cu'):
        cindex, tu = _parse(os.path.join(CSRC, source), mock_include,
                            _enc_defines(**shape))
        errors = _errors(cindex, tu)
        assert not errors, (source, '\n'.join(errors))


@pytest.mark.parametrize('shape,source,message', ENC_REFUSED)
def test_encode_sources_refuse_the_next_shape(shape, source, message,
                                              mock_include):
    """The first value of each axis past the admitted set fails its
    source's own static_assert: the gate (``fused_encmlp.kernel_shape``)
    stops where the headers do."""
    cindex, tu = _parse(os.path.join(CSRC, source), mock_include,
                        _enc_defines(**shape))
    failed = [e for e in _errors(cindex, tu) if 'static assertion' in e]
    assert any(message in e for e in failed), failed


def _global_kernels():
    """The names of the ``__global__`` functions in ``csrc/``."""
    names = set()
    for f in os.listdir(CSRC):
        with open(os.path.join(CSRC, f)) as fh:
            names.update(re.findall(
                r'__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(',
                fh.read()))
    return names


def test_smoke_kernel_names_are_global_functions():
    """Every kernel name that chip_smoke.py's profile maps look for (the
    passes, the launch counts of the bundled phases, the step's groups)
    is the name of a ``__global__`` function, so no count or time reads
    a kernel that no longer exists as 0."""
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    keys = [*C.DW_KERNELS, *C.VF_KERNELS]
    keys += [k for passes in C.BWD_PASSES.values() for _, ks in passes
             for k in ks]
    for table in (C.BUNDLE_K1_K4, C.BUNDLE_K1_K4_TF, C.BUNDLE_K5_K6,
                  C.BUNDLE_SINGLE):
        keys += [k for k, _ in table.values()]
    for groups in (C.K1_K4_GROUPS, C.K5_K6_GROUPS):
        keys += [k for ks in groups.values() for k in ks]
    kernels = _global_kernels()
    assert {'vf_m_mma_kernel', 'vf_fold_kernel',
            'vf_fold_sum_kernel'} <= kernels
    missing = sorted({k for k in keys
                      if re.match(r'\w+', k).group(0) not in kernels})
    assert not missing, missing
