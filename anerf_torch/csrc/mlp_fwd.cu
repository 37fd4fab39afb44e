// Split-operand radiance-MLP forward kernel for Hopper (sm_90a): K5.
//
// Replaces anerf_tpu/ops/pallas_mlp.py _fused_mlp_fwd / _fwd_kernel, the
// MLP that configs outside the fused encode (multi-subject models,
// trainable cutoffs) run on encodings computed outside the kernel.  The
// encodings arrive as separate bf16 part arrays, never concatenated in
// device memory: the trunk parts (kp encoding 360, bone encoding 72)
// must sum to 432, the views parts (view encoding 648, the subject
// channel 1 of a multi-subject model, framecodes 16) to at most 672.  Out: raw (n, 4) f32, row-major
// [r, g, b, alpha], as the TPU kernel writes it.
//
// Per block: 64 points.  The block copies its rows of every part into
// shared memory at the part's column offset (load_parts: a part's 64 rows
// are one contiguous 16-byte-aligned run, read 16 bytes at a time and
// scattered value by value, since a 649-wide bf16 row is 1298 bytes and
// rows are not even 4-byte aligned), zero-fills the views input up to 672
// columns and the rows past n, then
// runs K1's MLP body (mlp_fwd_tile, encmlp_common.cuh): every product on
// the tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulators),
// the activations in shared memory (206 KB), each layer's weights
// streamed from L2.  Numeric chain as in the TPU kernel: f32 bias and
// ReLU, a bf16 re-cast between layers, feat rounded to bf16 after its
// bias, alpha and rgb in f32.
//
// Bound: 864,000 MACs (1.73 MFLOP) a point against ~2.2 KB of part
// reads, so tensor-core operations bound it.  This first version re-reads
// every weight from L2 once per 64-point tile; wgmma, TMA-staged weights
// and larger tiles are later work.
//
// C interface (loaded with ctypes): every tensor pointer is device
// memory; the part pointer and width arrays are host arrays; the stream
// is PyTorch's current stream; returns cudaGetLastError().
#include "encmlp_common.cuh"

namespace {

constexpr size_t SMEM_MLP = sizeof(bf16) * (size_t)T * (LDX + LDXV + 2 * LDH);

__global__ void __launch_bounds__(NTHREAD, 1)
mlp_fwd_kernel(const Parts xs, const Parts xvs,
               const bf16* __restrict__ wpack,
               const float* __restrict__ bpack, float* __restrict__ out,
               int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);   // [x parts]        (T, LDX)
  bf16* XV = X + T * LDX;                     // [xv parts | 0]   (T, LDXV)
  bf16* H0 = XV + T * LDXV;                   // activations      (T, LDH)
  bf16* H1 = H0 + T * LDH;
  const int t0 = blockIdx.x * T;
  load_parts(xs, X, LDX, DX, t0, n);
  load_parts(xvs, XV, LDXV, DXV, t0, n);
  __syncthreads();
  mlp_fwd_tile(X, XV, H0, H1, wpack, bpack, out, 1, 4, t0, n);
}

}  // namespace

extern "C" {

// xs: nx trunk part pointers (n, xw[k]) bf16, summing to 432 columns;
// xvs: nxv views part pointers (n, xvw[k]) bf16, at most 672 columns;
// wpack/bpack: one packed weight set; out (n, 4) f32.
int mlp_fwd(const void* const* xs, const int* xw, int nx,
            const void* const* xvs, const int* xvw, int nxv,
            const void* wpack, const float* bpack, float* out, int n,
            void* stream) {
  Parts px, pv;
  if (!make_parts(px, xs, xw, nx, DX) || px.total != DX ||
      !make_parts(pv, xvs, xvw, nxv, DXV))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_MLP);
  if (err != cudaSuccess) return (int)err;
  mlp_fwd_kernel<<<(n + T - 1) / T, NTHREAD, SMEM_MLP,
                   (cudaStream_t)stream>>>(
      px, pv, reinterpret_cast<const bf16*>(wpack), bpack, out, n);
  return (int)cudaGetLastError();
}

// Sizes of one packed weight set, for the wrapper's checks.
long long mlp_weight_elems(void) { return (long long)WSZ; }
int mlp_bias_elems(void) { return BSZ; }

}  // extern "C"
