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
// takes 1-7 kp bands, 1-9 view rows, the windowed bone directions and
// 1-8 layers (encmlp_common.cuh; fused_encmlp.kernel_shape): the shapes
// whose trunk input stays resident in shared memory beside the ring.
//
// Per block: 64 points (one S=64 ray, or four S=16 rays), two consumer
// warpgroups and a producer warp.  The encode runs in f32 on the CUDA
// cores and lands in shared memory as bf16; it never touches device
// memory.  Meanwhile the producer warp has the net's first weight slices
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
#include "mlp_fwd_common.cuh"

static_assert(W == 256 && SKIP == 4,
              "K1/K2 take 256-wide nets with the skip after layer 4");

namespace {

// + the windows (T, J) and viewfac's ray slots (T)
constexpr size_t SMEM_ENC = SMEM_FWD + sizeof(float) * T * J + sizeof(int) * T;
static_assert(SMEM_ENC <= 232448, "a block takes at most 227 KB");
static_assert(DX == DV + C3 && DXP == DX && FWD_X_RESIDENT,
              "K1/K2 encode the trunk into resident shared memory");

// tfab (TF: the affine rows) is the last parameter, so that the point
// form's parameters keep their offsets and ptxas builds it as it would
// without the transform (its bits do not depend on TF's existence)
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
                  const float* __restrict__ tfab) {
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
  encode_points<TF>(p, tfab, cutoff, __ldg(tau_ptr), sm.X, WIN, t0, n, S);
  if constexpr (VF) vf_slots(SLOT, t0, n, S);
  sync_tile();
  for (int net = 0; net < NNET; ++net) {
    // the views input of this net (the last net's trunk wrote over it)
    const float* cn = codes + (size_t)net * R * NCODE;
    if constexpr (VF) {
      write_vf_codes(sm.XV, LDCV, cn, t0, n, S);
      vf_stage(sm.XV + T * LDCV,
               vf_tile(WIN, SLOT, vfM + (size_t)net * R * J * HV, t0, n, S));
    } else {
      encode_views(enc, WIN, sm.XV, LDXV, t0, n, S);
      write_codes(sm.XV, LDXV, cn, t0, n, S);
    }
    sync_tile();
    mlp_fwd_tile<VF>(rg, sm, wpack + (size_t)net * WSZ,
                     bpack + (size_t)net * BSZ, out + (size_t)net * 4 * n, n,
                     1, t0, n);
  }
}

template <int NNET, bool VF, bool TF>
int launch_vf(const float* p, const float* tfab, const float* enc,
              const float* codes, const float* cutoff, const float* tau,
              const bf16* wf, const float* bpack, const bf16* vfM, float* out,
              const FwdMaps& maps, int n, int S, int R, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      encmlp_fwd_kernel<NNET, VF, TF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_ENC);
  if (err != cudaSuccess) return (int)err;
  encmlp_fwd_kernel<NNET, VF, TF><<<(n + T - 1) / T, NTHREAD + 32, SMEM_ENC,
                                    (cudaStream_t)stream>>>(
      p, enc, codes, cutoff, tau, wf, bpack, vfM, out, maps, n, S, R, tfab);
  return (int)cudaGetLastError();
}

template <int NNET, bool TF>
int launch_tf(const float* p, const float* tfab, const float* enc,
              const float* codes, const float* cutoff, const float* tau,
              const bf16* wf, const float* bpack, const void* vfM, float* out,
              const FwdMaps& maps, int n, int S, int R, void* stream) {
  if (vfM)
    return launch_vf<NNET, true, TF>(p, tfab, enc, codes, cutoff, tau, wf,
                                     bpack, reinterpret_cast<const bf16*>(vfM),
                                     out, maps, n, S, R, stream);
  return launch_vf<NNET, false, TF>(p, tfab, enc, codes, cutoff, tau, wf,
                                    bpack, nullptr, out, maps, n, S, R,
                                    stream);
}

// vfM: the nets' M (NNET, R, J, HV) for viewfac, or null for the dense
// views input; viewfac needs S >= 32 (a tile's rays at most VFR).  tfab:
// null (p the points (n, 3J)) or the affine rows (R, 2, 3J) of the
// in-kernel transform (p the depths (R, S), n = R S).
template <int NNET>
int launch(const float* p, const float* enc, const float* codes,
           const float* cutoff, const float* tau, const void* wpack,
           const float* bpack, const void* vfM, const float* tfab, float* out,
           int n, int S, int R, void* stream) {
  if (n <= 0) return 0;
  if (vfM && S < T / (VFR - 1)) return (int)cudaErrorInvalidValue;
  if (tfab && n != R * S) return (int)cudaErrorInvalidValue;
  const bf16* wf = reinterpret_cast<const bf16*>(wpack);
  FwdMaps maps;
  const cudaError_t err = make_fwd_maps(maps, wf, NNET);
  if (err != cudaSuccess) return (int)err;
  if (tfab)
    return launch_tf<NNET, true>(p, tfab, enc, codes, cutoff, tau, wf, bpack,
                                 vfM, out, maps, n, S, R, stream);
  return launch_tf<NNET, false>(p, nullptr, enc, codes, cutoff, tau, wf,
                                bpack, vfM, out, maps, n, S, R, stream);
}

}  // namespace

extern "C" {

// One net: out (4, n) rows [r, g, b, sigma]; vfM null (dense views
// input) or its M (1, R, J, HV) bf16 (viewfac); tfab null (p the points)
// or the affine rows (R, 2, 3J) (p the depths; launch).
int encmlp_fwd(const float* p, const float* enc, const float* codes,
               const float* cutoff, const float* tau, const void* wpack,
               const float* bpack, const void* vfM, const float* tfab,
               float* out, int n, int S, int R, void* stream) {
  return launch<1>(p, enc, codes, cutoff, tau, wpack, bpack, vfM, tfab, out,
                   n, S, R, stream);
}

// Coarse and fine nets on one encode: codes (2, R, 16), wpack/bpack two
// packed sets back to back, vfM null or (2, R, J, HV), out (2, 4, n).
int encmlp_dual_fwd(const float* p, const float* enc, const float* codes,
                    const float* cutoff, const float* tau, const void* wpack,
                    const float* bpack, const void* vfM, const float* tfab,
                    float* out, int n, int S, int R, void* stream) {
  return launch<2>(p, enc, codes, cutoff, tau, wpack, bpack, vfM, tfab, out,
                   n, S, R, stream);
}

// Sizes of one packed weight set, for the wrapper's checks.
long long encmlp_weight_elems(void) { return (long long)WSZ; }
int encmlp_bias_elems(void) { return BSZ; }

// The build's encode shape, for the wrapper's checks: out[0 .. 3] = kp
// bands, view rows, bone window, depth; returns the count.
int encmlp_shape(int* out) {
  out[0] = NF;
  out[1] = NB;
  out[2] = BONE_WIN ? 1 : 0;
  out[3] = DEPTH;
  return 4;
}

}  // extern "C"
