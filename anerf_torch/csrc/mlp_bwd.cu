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
//   1. mlp_bwd_tile_kernel, one block per 64-point tile (8 warps and a
//      producer warp for the weight ring): the part loader
//      of K5 (the trunk parts into shared memory, the views parts
//      straight into the workspace), then the forward recompute and the
//      MLP backward (mlp_bwd_tile, shared with K3/K4 in
//      mlp_bwd_common.cuh: weights through a TMA-fed ring of k-slices
//      in shared memory, the views input read back through the same
//      ring, ReLU masks as bits in shared memory, each cotangent rounded
//      to bf16 before it feeds a product, bias partials of the f32
//      cotangents).  It writes the layers' bf16 inputs, activations and
//      cotangents and the f32 input cotangents to a workspace (about
//      16 KB a point: 2.1 GB at n = 131,072).  The library is built
//      for one trunk width DX (nvcc -DANERF_DX=..., 1 to 4096, 432 by
//      default); a trunk input wider than 480 columns does not fit in
//      shared memory beside the ring, the activations and the masks, so
//      it goes to the workspace only, and layer 0 and the skip layer
//      read it back 256 columns at a time into a buffer that their
//      products refill between two barriers (ring_mma_x);
//   2. dx_kernel, twice, one block per point: the f32 input cotangents
//      rounded to bf16 into each part's row, padding columns dropped
//      (element by element, as odd-width rows are unaligned);
//   3. bias_kernel, dw_kernel and dw_sum_kernel (mlp_bwd_common.cuh): the
//      per-tile bias partials summed in tile order, and every weight
//      gradient A^T G on the tensor cores, each block one 128 x 128
//      output tile over one of P slices of the points (P from the host,
//      ops/fused_mlp.py dw_plan), the slices' partial tiles then summed
//      in slice order.
//
// The library is built for one net too (nvcc -DANERF_DEPTH, -DANERF_WIDTH
// a multiple of 256 up to 4096, -DANERF_SKIP; 8 x 256 by default): 1-128
// layers, depth x width up to 262,144 (mlp_bwd_common.cuh bwd_seg
// computes each segment of the schedule from its index),
// every layer of W outputs as W / 256 blocks of 256 columns over the
// same A operand.  At W = 512 the ring keeps 3 stages and the ReLU
// masks go to the workspace, so that the two (64, 520) activation
// buffers fit; past 512 (WIDE) the activations and cotangents go
// straight to the workspace and every product reads its A operand back
// 256 columns at a time (mlp_bwd_tile_wide).  Past 24 layers the
// per-tile pass's sums are compensated (mlp_bwd_common.cuh ACC_COMP), or
// those of a 32-layer net drift from the twin's.
//
// Bound: recompute, input cotangents and weight gradients are 3x the
// forward's tensor-core work (5.2 MFLOP a point) against ~4.4 KB of part
// and cotangent traffic a point: operations bound it.  Pass 1 re-reads
// the weight packs from L2 once per 64-point tile (~7 GB at n = 131,072,
// its floor at this tile size); the workspace round trip is later work,
// as for K3/K4.
//
// C interface (loaded with ctypes): every tensor pointer is device
// memory; the part pointer and width arrays are host arrays; the stream
// is PyTorch's current stream; returns the first cudaError of the
// launches.
#include "mlp_bwd_common.cuh"

namespace {

static_assert(SMEM_TILE <= 232448, "a block takes at most 227 KB");

__global__ void __launch_bounds__(NTHREAD + 32, 1)
mlp_bwd_tile_kernel(const Parts xs, const Parts xvs,
                    const bf16* __restrict__ wback,
                    const float* __restrict__ bpack,
                    const float* __restrict__ gin, Work wk,
                    const __grid_constant__ Maps<1> maps, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem sm = tile_smem(smem);
  const int t0 = blockIdx.x * T;
  BwdRing rg = ring_open<BwdSched>(sm.ring, sm.bars, &maps.seg[0][0],
                                     maps.xv, 1, t0);
  if (threadIdx.x >= NTHREAD) {  // the producer warp; the first weight
    ring_produce(rg);            // slices arrive while the parts load
    return;
  }
  bf16* xg = wk.x + (size_t)t0 * DXP;
  if constexpr (BWD_X_RESIDENT)
    load_parts(xs, sm.X, LDXB, DXP, t0, n);
  else  // too wide to stay: the products read it back from the workspace
    load_parts(xs, xg, DXP, DXP, t0, n);
  load_parts(xvs, wk.xv[0] + (size_t)t0 * DXV, DXV, DXV, t0, n);
  fence_async_global();  // the ring reads the views input back by TMA
  for (int idx = threadIdx.x; idx < T * 4; idx += NTHREAD)
    sm.gsm[idx] = t0 + (idx >> 2) < n ? __ldg(gin + (size_t)t0 * 4 + idx) : 0.f;
  sync_tile();
  if constexpr (BWD_X_RESIDENT) copy_rows(xg, DXP, sm.X, LDXB, DXP);
#if ANERF_WIDE
  mlp_bwd_tile_wide(rg, sm, wback, bpack, wk, 0, t0, xg);
#else
  mlp_bwd_tile<false>(rg, sm, wback, bpack, wk, 0, t0, xg);
#endif
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
// widths xw/xvw (bf16 out); dw (WGSZ) and db (BSZ) f32 out; part the dW
// pass's partials (P x WGSZ f32) of P slices of `slice` points.
int mlp_bwd(const void* const* xs, const int* xw, int nx,
            const void* const* xvs, const int* xvw, int nxv,
            const void* wpack, const void* wback, const float* bpack,
            const float* g, void* workspace, void* const* dxs,
            void* const* dxvs, float* dw, float* db, float* part, int P,
            int slice, int n, void* stream) {
  Parts px, pv, dx, dv;
  if (!make_parts(px, xs, xw, nx, DX) || px.total != DX ||
      !make_parts(pv, xvs, xvw, nxv, DXV) ||
      !make_parts(dx, dxs, xw, nx, DX) || !make_parts(dv, dxvs, xvw, nxv, DXV))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int np = (int)round_up((size_t)n, T);
  const Work wk = carve(workspace, n, 1, 0);
  const bf16* wf = reinterpret_cast<const bf16*>(wpack);
  const bf16* wb = reinterpret_cast<const bf16*>(wback);
  Maps<1> maps;
  cudaError_t err = make_maps(maps, wf, wb, wk, np);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      mlp_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_TILE);
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_tile_kernel<<<np / T, NTHREAD + 32, SMEM_TILE, st>>>(
      px, pv, wb, bpack, g, wk, maps, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dx_kernel<<<n, DX_THREADS, 0, st>>>(wk.gx[0], DXP, dx);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dx_kernel<<<n, DX_THREADS, 0, st>>>(wk.gxv[0], DXV, dv);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_grads(wk, 1, dw, db, part, P, slice, np, st);
}

long long mlp_bwd_workspace_bytes(int n) {
  return (long long)workspace_bytes(n, 1, 0);
}

long long mlp_grad_weight_elems(void) { return (long long)WGSZ; }

int mlp_trunk_width(void) { return DX; }
int mlp_net_depth(void) { return DEPTH; }
int mlp_net_width(void) { return W; }

}  // extern "C"
