// Split-operand radiance-MLP backward kernel for Hopper (sm_90a): K6.
//
// Replaces anerf_tpu/ops/pallas_mlp.py _fused_mlp_bwd / _bwd_kernel, the
// backward of K5 (mlp_fwd.cu).  Given K5's bf16 part arrays and the raw
// cotangent g (n, 4) f32 [rgb, alpha], it writes the cotangent of every
// part in bf16 at the part's own width, and the f32 gradient of every
// weight and bias summed over all points.
//
// The TPU kernel recomputes the forward per tile and sums the weight
// gradients across its in-order grid in VMEM.  Hopper blocks run in no
// order, so K6 is K3's design (encmlp_bwd.cu) without the encode and its
// pullback, in passes on one stream with no atomics (the gradients are
// the same from run to run):
//   1. mlp_bwd_tile_kernel, one block per 64-point tile: the part loader
//      of K5, the forward recompute and the MLP backward (mlp_bwd_tile,
//      shared with K3/K4 in mlp_bwd_common.cuh: ReLU masks from the bf16
//      activations, each cotangent rounded to bf16 before it feeds a
//      product, bias partials of the f32 cotangents).  It writes the
//      layers' bf16 inputs, activations and cotangents and the f32 input
//      cotangents to a workspace (about 16 KB a point: 2.1 GB at
//      n = 131,072);
//   2. dx_kernel, twice, one block per point: the f32 input cotangents
//      rounded to bf16 into each part's row, padding columns dropped
//      (element by element, as odd-width rows are unaligned);
//   3. bias_kernel and dw_kernel (mlp_bwd_common.cuh): the per-tile bias
//      partials summed in tile order, and every weight gradient A^T G on
//      the tensor cores, each block one 128 x 128 output tile walking all
//      points in order.
//
// Bound: recompute, input cotangents and weight gradients are 3x the
// forward's tensor-core work (5.2 MFLOP a point) against ~4.4 KB of part
// and cotangent traffic a point: operations bound it.  The workspace
// round trip and the L2 weight re-reads of this first version are later
// work, as for K3/K4.
//
// C interface (loaded with ctypes): every tensor pointer is device
// memory; the part pointer and width arrays are host arrays; the stream
// is PyTorch's current stream; returns the first cudaError of the
// launches.
#include "mlp_bwd_common.cuh"

namespace {

constexpr size_t SMEM_BWD =
    sizeof(bf16) * (size_t)T * (LDX + LDXV + 2 * LDH) + sizeof(float) * T * 4;

__global__ void __launch_bounds__(NTHREAD, 1)
mlp_bwd_tile_kernel(const Parts xs, const Parts xvs,
                    const bf16* __restrict__ wpack,
                    const bf16* __restrict__ wback,
                    const float* __restrict__ bpack,
                    const float* __restrict__ gin, Work wk, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);   // [x parts]        (T, LDX)
  bf16* XV = X + T * LDX;                     // [xv parts | 0]   (T, LDXV)
  bf16* H0 = XV + T * LDXV;                   // (T, LDH)
  bf16* H1 = H0 + T * LDH;
  float* GSM = reinterpret_cast<float*>(H1 + T * LDH);  // raw g (T, 4)
  const int t0 = blockIdx.x * T;
  load_parts(xs, X, LDX, DX, t0, n);
  load_parts(xvs, XV, LDXV, DXV, t0, n);
  for (int idx = threadIdx.x; idx < T * 4; idx += NTHREAD)
    GSM[idx] = t0 + (idx >> 2) < n ? __ldg(gin + (size_t)t0 * 4 + idx) : 0.f;
  __syncthreads();
  copy_rows(wk.x + (size_t)t0 * DX, DX, X, LDX, DX);
  mlp_bwd_tile(X, XV, H0, H1, GSM, wpack, wback, bpack, wk, 0, t0);
}

// out part k [t, c] = bf16(g[t, off_k + c]): the f32 input cotangent
// (stride ld) cut into the parts (whose pointers are written through
// here); one block per point t
constexpr int DX_THREADS = 128;

__global__ void __launch_bounds__(DX_THREADS)
dx_kernel(const float* __restrict__ g, int ld, const Parts out) {
  const float* __restrict__ row = g + (size_t)blockIdx.x * ld;
  for (int k = 0; k < out.count; ++k) {
    bf16* dst = static_cast<bf16*>(const_cast<void*>(out.p[k])) +
                (size_t)blockIdx.x * out.w[k];
    for (int c = threadIdx.x; c < out.w[k]; c += DX_THREADS)
      dst[c] = __float2bfloat16_rn(row[out.off[k] + c]);
  }
}

}  // namespace

extern "C" {

// xs/xvs as for mlp_fwd; wpack/bpack the forward packs, wback the
// backward pack (WGSZ); g (n, 4) f32; dxs/dxvs part pointers of the
// widths xw/xvw (bf16 out); dw (WGSZ) and db (BSZ) f32 out.
int mlp_bwd(const void* const* xs, const int* xw, int nx,
            const void* const* xvs, const int* xvw, int nxv,
            const void* wpack, const void* wback, const float* bpack,
            const float* g, void* workspace, void* const* dxs,
            void* const* dxvs, float* dw, float* db, int n, void* stream) {
  Parts px, pv, dx, dv;
  if (!make_parts(px, xs, xw, nx, DX) || px.total != DX ||
      !make_parts(pv, xvs, xvw, nxv, DXV) ||
      !make_parts(dx, dxs, xw, nx, DX) || !make_parts(dv, dxvs, xvw, nxv, DXV))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int np = (int)round_up((size_t)n, T);
  const Work wk = carve(workspace, n, 1, 0);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BWD);
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_tile_kernel<<<np / T, NTHREAD, SMEM_BWD, st>>>(
      px, pv, reinterpret_cast<const bf16*>(wpack),
      reinterpret_cast<const bf16*>(wback), bpack, g, wk, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dx_kernel<<<n, DX_THREADS, 0, st>>>(wk.gx[0], DX, dx);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dx_kernel<<<n, DX_THREADS, 0, st>>>(wk.gxv[0], DXV, dv);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_grads(wk, 1, dw, db, np, st);
}

long long mlp_bwd_workspace_bytes(int n) {
  return (long long)workspace_bytes(n, 1, 0);
}

long long mlp_grad_weight_elems(void) { return (long long)WGSZ; }

}  // extern "C"
