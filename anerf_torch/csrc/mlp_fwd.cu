// Split-operand radiance-MLP forward kernel for Hopper (sm_90a): K5.
//
// Replaces anerf_tpu/ops/pallas_mlp.py _fused_mlp_fwd / _fwd_kernel, the
// MLP that configs outside the fused encode (multi-subject models,
// trainable cutoffs, shapes K1-K4 are not built for, such as 8 x 512
// nets: fused_encmlp.kernel_shape) run on encodings
// computed outside the kernel.  The encodings arrive as separate bf16
// part arrays, never concatenated in device memory: the trunk parts (the
// kp and bone encodings, 360 + 72 for the flagship's) must sum to DX,
// the width the library is built for (nvcc -DANERF_DX=..., 1 to 4096,
// 432 by default; the TPU kernel compiles per shape too), the views
// parts (view encoding 648, 216 or 72, the subject channel 1 of a
// multi-subject model, framecodes 16) to at most DXV, the views width
// it is built for (nvcc -DANERF_DXV=..., 672 by default; past 672 the
// parts' sum + 8 rounded up to 16, up to 4096: 1656 view columns at
// multires_views 11 and 128 framecodes take 1792).  It is built for one
// net as well (nvcc -DANERF_DEPTH, -DANERF_WIDTH a multiple of 256 up
// to 4096, -DANERF_SKIP; 8 x 256 by default; ops/fused_mlp.py pads other
// nets' weights with zeros): 1-128 layers, depth x width up to 262,144,
// the schedule's segments computed from their index at any depth
// (mlp_fwd_common.cuh fwd_seg), a layer of W outputs as W / 256
// blocks of 256 columns over the same A operand, at 512 the ring cut
// to 3 stages to fit the two (64, 520) activation buffers.  Past 512
// (WIDE: 768, 1024, ...) the activations do not fit shared memory:
// they go to a per-block workspace in device memory (L2-hot) and every
// product reads its A operand back 256 columns at a time
// (mlp_fwd_tile_wide), the views input staying in shared memory and
// the views layer running last, 128 outputs at a time.  The weights
// reach the ring through a few tensor maps over the pack (ring.cuh),
// whatever the depth.  Out: raw (n, 4) f32, row-major [r, g, b,
// alpha], as the TPU kernel writes it.
//
// Per block: 64 points, two consumer warpgroups and a producer warp.
// The block copies its rows of every part into shared memory at the
// part's column offset (load_parts: a part's 64 rows are one contiguous
// 16-byte-aligned run, read 16 bytes at a time and scattered value by
// value, since a 649-wide bf16 row is 1298 bytes and rows are not even
// 4-byte aligned), zero-fills the views input up to DXV columns, the
// trunk input up to the 16-column k-step and the rows past n, while the
// producer warp has the first weight slices in flight; then it runs K1's MLP body (mlp_fwd_tile, mlp_fwd_common.cuh):
// every weight through the TMA-fed ring of k-slices in shared memory,
// every product on wgmma with the activations from registers, the views
// input's product first so that the activation buffers can take its
// place.  A trunk input wider than 592 columns does not fit beside the
// ring and the activations in a block's 227 KB: layer 0 and the skip
// layer then read it from the parts 256 columns at a time into a buffer
// that their products refill between two barriers (ring_wgmma_x); the
// sums run in the same order.  A views input wider than 832 columns
// does not fit beside them either: the views product then reads it
// from the parts 256 columns at a time into the region the activations
// take after it (ring_wgmma_xv), value by value (load_cols), which
// costs K5 2.5 ms at n = 131,072 and 1664 columns (PERF.md §6).  Numeric chain as in the TPU kernel: f32 bias and ReLU, a bf16
// re-cast between layers, feat rounded to bf16 after its bias, alpha and
// rgb in f32.
//
// Bound: 864,000 MACs (1.73 MFLOP) a point at the flagship's widths
// (1,232,640 at a 1152-wide trunk) against ~2.2 KB (3.6 KB) of part
// reads, so tensor-core operations bound it.  Each 64-point tile reads
// the 1.73 MB weight pack from L2 (~3.5 GB at n = 131,072), this
// design's floor at this tile size, as for K1/K2.
//
// C interface (loaded with ctypes): every tensor pointer is device
// memory; the part pointer and width arrays are host arrays; the stream
// is PyTorch's current stream; returns cudaGetLastError().
#include "mlp_fwd_common.cuh"

namespace {

static_assert(SMEM_FWD <= 232448, "a block takes at most 227 KB");

__global__ void __launch_bounds__(NTHREAD + 32, 1)
mlp_fwd_kernel(const Parts xs, const Parts xvs,
               const bf16* __restrict__ wpack,
               const float* __restrict__ bpack, bf16* __restrict__ work,
               float* __restrict__ out, const __grid_constant__ FwdMaps maps,
               int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdSmem sm = fwd_smem(smem);
  const int t0 = blockIdx.x * T;
  FwdRing rg = ring_open<FwdSched>(sm.ring, sm.bars, &maps.seg[0][0],
                                   nullptr, 1, t0);
  if (threadIdx.x >= NTHREAD) {  // the producer warp; the first weight
    ring_produce(rg);            // slices arrive while the parts load
    return;
  }
  if constexpr (FWD_X_RESIDENT) load_parts(xs, sm.X, LDXF, DXP, t0, n);
  if constexpr (FWD_XV_RESIDENT) load_parts(xvs, sm.XV, LDXV, DXV, t0, n);
  sync_tile();
#if ANERF_WIDE
  mlp_fwd_tile_wide(rg, sm, wpack, bpack, out, 1, 4, t0, n, &xs, &xvs,
                    work + (size_t)blockIdx.x * FWD_WORK_ELEMS);
#else
  mlp_fwd_tile<false>(rg, sm, wpack, bpack, out, 1, 4, t0, n, &xs, &xvs);
#endif
}

}  // namespace

extern "C" {

// xs: nx trunk part pointers (n, xw[k]) bf16, summing to DX columns;
// xvs: nxv views part pointers (n, xvw[k]) bf16, at most DXV columns;
// wpack/bpack: one packed weight set; workspace:
// mlp_fwd_workspace_bytes(n) (none up to 512 wide); out (n, 4) f32.
int mlp_fwd(const void* const* xs, const int* xw, int nx,
            const void* const* xvs, const int* xvw, int nxv,
            const void* wpack, const float* bpack, void* workspace,
            float* out, int n, void* stream) {
  Parts px, pv;
  if (!make_parts(px, xs, xw, nx, DX) || px.total != DX ||
      !make_parts(pv, xvs, xvw, nxv, DXV))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const bf16* wf = reinterpret_cast<const bf16*>(wpack);
  FwdMaps maps;
  cudaError_t err = make_fwd_maps(maps, wf, 1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_FWD);
  if (err != cudaSuccess) return (int)err;
  mlp_fwd_kernel<<<(n + T - 1) / T, NTHREAD + 32, SMEM_FWD,
                   (cudaStream_t)stream>>>(
      px, pv, wf, bpack, reinterpret_cast<bf16*>(workspace), out, maps, n);
  return (int)cudaGetLastError();
}

// A WIDE net's device-memory activations: FWD_WORK_ELEMS bf16 a block.
long long mlp_fwd_workspace_bytes(int n) {
  return (long long)((n + T - 1) / T) * (long long)FWD_WORK_ELEMS * 2;
}

// The build's trunk and views widths and the sizes of one packed
// weight set, for the wrapper's checks.
int mlp_trunk_width(void) { return DX; }
int mlp_views_width(void) { return DXV; }
int mlp_net_depth(void) { return DEPTH; }
int mlp_net_width(void) { return W; }
long long mlp_weight_elems(void) { return (long long)WSZ; }
int mlp_bias_elems(void) { return BSZ; }

}  // extern "C"
