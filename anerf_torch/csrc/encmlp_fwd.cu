// Fused encode + radiance-MLP forward kernels for Hopper (sm_90a).
//
// Replaces the forward Pallas kernels of anerf_tpu/ops/pallas_encmlp.py:
//   encmlp_fwd       <- _fused_call / _fwd_kernel           (one net)
//   encmlp_dual_fwd  <- _fused_dual_call / _fwd_kernel_dual (encode once,
//                       coarse and fine nets)
// at the flagship A-NeRF shape by default: J=24 joints, kp PE bands
// 2^0..2^6 (360 channels), bone directions (72), view PE rows 9 x 72
// (648), framecodes (16), an 8 x 256 trunk with the input re-entering
// after layer 4, a 128-wide views branch.  A build per static shape
// takes 1-13 kp bands, 1-21 view rows, framecodes of 16-128 columns, the
// windowed bone directions and 1-16 layers of any width that is a
// multiple of 256 up to 2048 (encmlp_common.cuh;
// fused_encmlp.kernel_shape).
//
// Past 512 wide (WIDE) a block's activations do not fit its shared
// memory: the MLP body is K5's (mlp_fwd_tile_wide), each layer's bf16
// output going to a per-block workspace in device memory (L2-hot: two
// (64, W) buffers and hv, (2 W + HV) x 2 bytes a point, 1.34 GB at K2's
// eval chunk of 262,144 points at 8 x 1024) and each product reading
// its A operand back 256 columns at a time, the views layer last in
// blocks of 128 outputs.  Where the views input does not stay resident,
// each views block builds it again (NVB times a net).  With viewfac
// each views block stages its 128 columns of M for the tile's rays in
// the A operands' column buffer and adds xw @ M's block to the codes'
// k-slice product.
//
// Per block: 64 points (one S=64 ray, or four S=16 rays), two consumer
// warpgroups and a producer warp.  The encode runs in f32 on the CUDA
// cores and lands as bf16 in shared memory, where the trunk input stays
// resident beside the ring and the kernel's windows (FWD_X_RESIDENT,
// SMEM_ENC below: the flagship's and every shape of 256 up to 9 kp
// bands); else (512 wide, 10-13 kp bands) in the tile's rows of a device-
// memory workspace (n rounded up to 64, DXP columns: 113 MB at the
// train step's coarse n = 131,072), which each product that reads X
// (layer 0, the skip layer; K2: of both nets) brings back 256 columns
// at a time from L2 (ring_wgmma_x, mlp_fwd_common.cuh).  The views
// input [view rows x window | codes | 0 x 8] stays resident where it
// fits beside a buffer of X (up to 13 view rows at 256 wide, framecodes
// of 16 there); else the views product builds it again 256 columns at a
// time from the view rows (L2), the windows (shared memory) and the
// codes, into the region the activations take after it (ring_wgmma_xv,
// encode_views): no workspace, and the same values.  The products'
// sums are the same either way.  Meanwhile the producer warp has the
// net's first weight slices
// in flight: every weight reaches the block through a 4-stage ring of
// 32-deep k-slices in shared memory, one TMA copy a stage, walking a
// fixed schedule across the layers and the nets (ring.cuh).  Every
// product runs on wgmma (m64n128k16 for the 256-wide layers, m64n64k16
// for the views layer; A, the activations, from registers, B from the
// ring stage; f32 accumulators), each warpgroup owning half of a layer's
// output columns for all 64 rows, so no reduction crosses warps or
// blocks.  To make room for the ring, the views input leaves shared
// memory before the trunk: its product runs first, into accumulators
// that stay in registers until the feat part adds into them, and the
// activation buffers take its place (mlp_fwd_common.cuh).  K2 encodes
// the views input again for its second net from the windows it keeps.
//
// With viewfac (the view factorization, anerf_tpu's default: its cost
// gate takes it for the coarse pass at S = 64, K2), the views input is
// never built: the views layer's views-input product is the codes'
// k-slice through the ring plus xw @ M, the tile's windows against its
// rays' rows of M (at most 3 rays a tile at S >= 32; M from K-vf1,
// viewfac.cu), on mma.sync with both operands built in registers
// (encmlp_common.cuh).  The ring skips the 172 KB of the views weight's
// view rows a tile and net.
//
// With TF (the in-kernel rigid transform, anerf_tpu's fuse_tform:
// pallas_encmlp._apply_tform in _fwd_kernel / _fwd_kernel_dual) the
// kernels read the sample depths z (R, S) and each ray's affine rows
// [A; B] (R, 2, 72) in place of the points (n, 72): the encode builds
// each point as A + z B (load_point, encmlp_common.cuh) from __ldg reads
// (A and B, 1.2 MB at R = 2048, stay in L2), so no shared memory is
// added.  The point bytes fall from n x 288 to R (S + 144) x 4.
// Numeric chain as in the TPU kernels: f32 bias and ReLU, a bf16 re-cast
// between layers, feat rounded to bf16 after its bias, alpha and rgb in
// f32.  The ragged edge of the last block is masked.
//
// Bound: ~1.73 MFLOP per point and net against ~300 bytes of device
// traffic, so tensor-core operations bound both kernels at the card's
// peak (0.925 ms for K2 at n = 262,144).  At 64-point tiles, though, each
// block reads its net's whole 1.73 MB weight pack from L2: ~14 GB of L2
// reads per K2 call at n = 262,144, a few ms at the L2's rate, which is
// this design's floor.  Going below it needs weight reuse across tiles
// (a cluster sharing each slice by TMA multicast, or 128-point tiles).
//
// The shape, the weight layout and the encode live in encmlp_common.cuh,
// the ring in ring.cuh, the MLP body (mlp_fwd_tile) in
// mlp_fwd_common.cuh, shared with K5.
//
// C interface (loaded with ctypes): every pointer is device memory,
// the stream is PyTorch's current stream; returns cudaGetLastError().
#define ANERF_ENC_KERNEL  // the windows and slots count (SMEM_ADD)
#include "mlp_fwd_common.cuh"

static_assert(SKIP == 4, "K1/K2 take nets with the skip after layer 4");

namespace {

// + the windows (T, J) and viewfac's ray slots (T)
constexpr size_t SMEM_ENC = SMEM_FWD + SMEM_ADD;
static_assert(SMEM_ENC <= 232448, "a block takes at most 227 KB");
static_assert(DX == DV + C3 && DXP == DX,
              "K1/K2 encode the trunk input [v | r], a whole k-step wide");

// the workspace: X's device-memory rows (none where X stays resident),
// n rounded up to T, DXP bf16 each; then, WIDE, each block's activations
// (FWD_WORK_ELEMS bf16 a block)
constexpr size_t XWORK_ROW = FWD_X_RESIDENT ? 0 : (size_t)DXP * sizeof(bf16);

// tfab (TF: the affine rows) and then xwork are the last parameters, so
// that the point form's parameters keep their offsets and ptxas builds it
// as it would without the transform (its bits do not depend on TF's
// existence, nor on the workspace's)
template <int NNET, bool VF, bool TF>
__global__ void __launch_bounds__(NTHREAD + 32, 1)
encmlp_fwd_kernel(const float* __restrict__ p, const float* __restrict__ enc,
                  const float* __restrict__ codes,
                  const float* __restrict__ cutoff,
                  const float* __restrict__ tau_ptr,
                  const bf16* __restrict__ wpack,
                  const float* __restrict__ bpack,
                  const bf16* __restrict__ vfM, float* __restrict__ out,
                  const __grid_constant__ FwdMaps maps, int n, int S, int R,
                  const float* __restrict__ tfab, bf16* xwork) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdSmem sm = fwd_smem(smem);
  float* WIN = sm.end;                        // windows (T, J)
  int* SLOT = reinterpret_cast<int*>(WIN + T * J);
  const int t0 = blockIdx.x * T;
  Ring<FwdSchedT<VF>> rg = ring_open<FwdSchedT<VF>>(
      sm.ring, sm.bars, &maps.seg[0][0], nullptr, NNET, t0);
  if (threadIdx.x >= NTHREAD) {  // the producer warp; the first weight
    ring_produce(rg);            // slices arrive while the tile encodes
    return;
  }
  // X in shared memory, or the tile's rows of the workspace.  Those
  // rows' stores are ordered before every read of them (x_cols, from the
  // first trunk product of the first net on) by the consumers' barrier
  // right after the encode: bar.sync makes a thread's prior memory
  // accesses, global ones included, visible to the threads it
  // synchronises, and x_cols' barriers come later still.
  bf16* xg = FWD_X_RESIDENT ? nullptr : xwork + (size_t)t0 * DXP;
  bf16* hw = WIDE ? xwork + (FWD_X_RESIDENT ? 0 : (size_t)gridDim.x * T * DXP) +
                        (size_t)blockIdx.x * FWD_WORK_ELEMS
                  : nullptr;
  encode_points<TF>(p, tfab, cutoff, __ldg(tau_ptr),
                    FWD_X_RESIDENT ? sm.X : xg, FWD_X_RESIDENT ? LDX : DXP,
                    WIN, t0, n, S);
  if constexpr (VF) vf_slots(SLOT, t0, n, S);
  sync_tile();
  const XRows xr{xg};
  for (int net = 0; net < NNET; ++net) {
    // the views input of this net (the last net's trunk wrote over it);
    // where it does not stay resident, the views product builds it again
    // 256 columns at a time from the view rows, the windows and the codes
    const float* cn = codes + (size_t)net * R * NCODE;
    const XvEnc xe{enc, WIN, cn, S};
    const VfTile vft = vf_tile(
        WIN, SLOT, VF ? vfM + (size_t)net * R * J * HV : vfM, t0, n, S);
    if constexpr (VF) {
      write_vf_codes(sm.XV, LDCV, cn, t0, n, S);
      if constexpr (!WIDE) vf_stage(sm.XV + T * LDCV, vft);
    } else if constexpr (FWD_XV_RESIDENT) {
      encode_views(xe, sm.XV, LDXV, 0, DXV, t0, n);
    }
    sync_tile();
#if ANERF_WIDE
    mlp_fwd_tile_wide<VF, XRows, XvEnc>(
        rg, sm, wpack + (size_t)net * WSZ, bpack + (size_t)net * BSZ,
        out + (size_t)net * 4 * n, n, 1, t0, n, &xr, &xe, hw, &vft);
#else
    mlp_fwd_tile<VF, XRows, XvEnc>(rg, sm, wpack + (size_t)net * WSZ,
                                   bpack + (size_t)net * BSZ,
                                   out + (size_t)net * 4 * n, n, 1, t0, n,
                                   &xr, &xe);
#endif
  }
}

template <int NNET, bool VF, bool TF>
int launch_vf(const float* p, const float* tfab, const float* enc,
              const float* codes, const float* cutoff, const float* tau,
              const bf16* wf, const float* bpack, const bf16* vfM, float* out,
              const FwdMaps& maps, int n, int S, int R, bf16* xwork,
              void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      encmlp_fwd_kernel<NNET, VF, TF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_ENC);
  if (err != cudaSuccess) return (int)err;
  encmlp_fwd_kernel<NNET, VF, TF><<<(n + T - 1) / T, NTHREAD + 32, SMEM_ENC,
                                    (cudaStream_t)stream>>>(
      p, enc, codes, cutoff, tau, wf, bpack, vfM, out, maps, n, S, R, tfab,
      xwork);
  return (int)cudaGetLastError();
}

template <int NNET, bool TF>
int launch_tf(const float* p, const float* tfab, const float* enc,
              const float* codes, const float* cutoff, const float* tau,
              const bf16* wf, const float* bpack, const void* vfM, float* out,
              const FwdMaps& maps, int n, int S, int R, bf16* xwork,
              void* stream) {
  if (vfM)
    return launch_vf<NNET, true, TF>(p, tfab, enc, codes, cutoff, tau, wf,
                                     bpack, reinterpret_cast<const bf16*>(vfM),
                                     out, maps, n, S, R, xwork, stream);
  return launch_vf<NNET, false, TF>(p, tfab, enc, codes, cutoff, tau, wf,
                                    bpack, nullptr, out, maps, n, S, R, xwork,
                                    stream);
}

// vfM: the nets' M (NNET, R, J, HV) for viewfac, or null for the dense
// views input; viewfac needs S >= 32 (a tile's rays at most VFR).  tfab:
// null (p the points (n, 3J)) or the affine rows (R, 2, 3J) of the
// in-kernel transform (p the depths (R, S), n = R S).  xwork: the trunk
// input's rows and (WIDE) the blocks' activations,
// encmlp_fwd_workspace_bytes(n) (null where that is 0).
template <int NNET>
int launch(const float* p, const float* enc, const float* codes,
           const float* cutoff, const float* tau, const void* wpack,
           const float* bpack, const void* vfM, const float* tfab,
           void* xwork, float* out, int n, int S, int R, void* stream) {
  if (n <= 0) return 0;
  if (vfM && S < T / (VFR - 1)) return (int)cudaErrorInvalidValue;
  if (tfab && n != R * S) return (int)cudaErrorInvalidValue;
  if ((!FWD_X_RESIDENT || WIDE) && !xwork) return (int)cudaErrorInvalidValue;
  const bf16* wf = reinterpret_cast<const bf16*>(wpack);
  bf16* xw = reinterpret_cast<bf16*>(xwork);
  FwdMaps maps;
  const cudaError_t err = make_fwd_maps(maps, wf, NNET);
  if (err != cudaSuccess) return (int)err;
  if (tfab)
    return launch_tf<NNET, true>(p, tfab, enc, codes, cutoff, tau, wf, bpack,
                                 vfM, out, maps, n, S, R, xw, stream);
  return launch_tf<NNET, false>(p, nullptr, enc, codes, cutoff, tau, wf,
                                bpack, vfM, out, maps, n, S, R, xw, stream);
}

}  // namespace

extern "C" {

// One net: out (4, n) rows [r, g, b, sigma]; vfM null (dense views
// input) or its M (1, R, J, HV) bf16 (viewfac); tfab null (p the points)
// or the affine rows (R, 2, 3J) (p the depths); xwork the trunk input's
// workspace (launch).
int encmlp_fwd(const float* p, const float* enc, const float* codes,
               const float* cutoff, const float* tau, const void* wpack,
               const float* bpack, const void* vfM, const float* tfab,
               void* xwork, float* out, int n, int S, int R, void* stream) {
  return launch<1>(p, enc, codes, cutoff, tau, wpack, bpack, vfM, tfab,
                   xwork, out, n, S, R, stream);
}

// Coarse and fine nets on one encode: codes (2, R, NCODE), wpack/bpack two
// packed sets back to back, vfM null or (2, R, J, HV), out (2, 4, n);
// both nets read the one xwork.
int encmlp_dual_fwd(const float* p, const float* enc, const float* codes,
                    const float* cutoff, const float* tau, const void* wpack,
                    const float* bpack, const void* vfM, const float* tfab,
                    void* xwork, float* out, int n, int S, int R,
                    void* stream) {
  return launch<2>(p, enc, codes, cutoff, tau, wpack, bpack, vfM, tfab,
                   xwork, out, n, S, R, stream);
}

// Bytes of the workspace for n points: the trunk input's rows (none
// where X stays resident in shared memory, else n rounded up to T rows
// of DXP bf16), then (WIDE) FWD_WORK_ELEMS bf16 of activations a block.
long long encmlp_fwd_workspace_bytes(int n) {
  const long long ntile = ((long long)n + T - 1) / T;
  return ntile * T * (long long)XWORK_ROW +
         ntile * (long long)FWD_WORK_ELEMS * (long long)sizeof(bf16);
}

// Sizes of one packed weight set, for the wrapper's checks.
long long encmlp_weight_elems(void) { return (long long)WSZ; }
int encmlp_bias_elems(void) { return BSZ; }

// The build's encode shape, for the wrapper's checks: out[0 .. 5] = kp
// bands, view rows, bone window, depth, width, framecode columns;
// returns the count.
int encmlp_shape(int* out) {
  out[0] = NF;
  out[1] = NB;
  out[2] = BONE_WIN ? 1 : 0;
  out[3] = DEPTH;
  out[4] = W;
  out[5] = NCODE;
  return 6;
}

}  // extern "C"
