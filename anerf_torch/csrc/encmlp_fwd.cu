// Fused encode + radiance-MLP forward kernels for Hopper (sm_90a).
//
// Replaces the forward Pallas kernels of anerf_tpu/ops/pallas_encmlp.py:
//   encmlp_fwd       <- _fused_call / _fwd_kernel           (one net)
//   encmlp_dual_fwd  <- _fused_dual_call / _fwd_kernel_dual (encode once,
//                       coarse and fine nets)
// at the flagship A-NeRF shape: J=24 joints, kp PE bands 2^0..2^6 (360
// channels), bone directions (72), view PE rows 9 x 72 (648), framecodes
// (16), an 8 x 256 trunk with the input re-entering after layer 4, a
// 128-wide views branch.
//
// Per block: 64 points (one S=64 ray, or four S=16 rays).  The encode
// runs in f32 on the CUDA cores and lands in shared memory as bf16; it
// never touches device memory.  Every product then runs on the tensor
// cores (mma.sync m16n8k16, bf16 operands, f32 accumulators) with the
// activations in shared memory and each layer's weights streamed from
// L2 (one net's 1.7 MB bf16 set is read by every block, so it stays
// L2-resident; a 227 KB block cannot hold it).  Each warp owns a slice
// of output columns for all 64 rows, so no reduction crosses warps or
// blocks.  Numeric chain as in the TPU kernels: f32 bias and ReLU, a
// bf16 re-cast between layers, feat rounded to bf16 after its bias,
// alpha and rgb in f32.  The ragged edge of the last block is masked.
//
// Bound: ~1.73 MFLOP per point and net against ~300 bytes of device
// traffic, so tensor-core operations bound both kernels.  This first
// version re-reads every weight from L2 once per 64-point tile
// (~14 GB of L2 reads per 4096-ray coarse chunk); wgmma, TMA and
// cluster multicast of the weights are later work.
//
// The shape, the weight layout, the product and the encode live in
// encmlp_common.cuh, shared with the backward kernels (encmlp_bwd.cu).
//
// C interface (loaded with ctypes): every pointer is device memory,
// the stream is PyTorch's current stream; returns cudaGetLastError().
#include "encmlp_common.cuh"

namespace {

template <int NNET>
__global__ void __launch_bounds__(NTHREAD, 1)
encmlp_fwd_kernel(const float* __restrict__ p, const float* __restrict__ enc,
                  const float* __restrict__ codes,
                  const float* __restrict__ cutoff,
                  const float* __restrict__ tau_ptr,
                  const bf16* __restrict__ wpack,
                  const float* __restrict__ bpack, float* __restrict__ out,
                  int n, int S, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);   // [v | r]       (T, LDX)
  bf16* XV = X + T * LDX;                     // [xv | codes]  (T, LDXV)
  bf16* H0 = XV + T * LDXV;                   // activations   (T, LDH)
  bf16* H1 = H0 + T * LDH;
  float* WIN = reinterpret_cast<float*>(H1 + T * LDH);  // windows (T, J)

  const int tid = threadIdx.x, warp = tid >> 5;
  const int t0 = blockIdx.x * T;
  const float tau = __ldg(tau_ptr);

  encode_tile(p, enc, cutoff, tau, X, XV, WIN, t0, n, S);

  for (int net = 0; net < NNET; ++net) {
    const bf16* Wn = wpack + (size_t)net * WSZ;
    const float* Bn = bpack + (size_t)net * BSZ;
    float* on = out + (size_t)net * 4 * n;
    write_codes(XV, codes + (size_t)net * R * NCODE, t0, n, S);
    __syncthreads();

    // ---- density trunk ---------------------------------------------------
    float acc[4][4][4];
    const int nw = warp * 32;  // this warp's 32 of the 256 columns
    zero_acc<4>(acc);
    gemm_acc<4>(acc, X, LDX, DX, Wn, nw);
    store_act<4, true>(acc, Bn, H0, LDH, nw);
    __syncthreads();
    bf16* hin = H0;
    bf16* hout = H1;
#pragma unroll 1
    for (int i = 1; i < DEPTH; ++i) {
      zero_acc<4>(acc);
      gemm_acc<4>(acc, hin, LDH, W, Wn + off_h(i), nw);
      if (i == SKIP + 1) gemm_acc<4>(acc, X, LDX, DX, Wn + OFF_SKIPX, nw);
      store_act<4, true>(acc, Bn + i * W, hout, LDH, nw);
      __syncthreads();
      bf16* tmp = hin;
      hin = hout;
      hout = tmp;
    }

    // ---- alpha head (f32 dot, 4 lanes per point) and feature layer -----
    {
      const int t = tid >> 2, part = tid & 3;
      const bf16* hr = hin + t * LDH + part * (W / 4);
      const bf16* wa = Wn + OFF_A + part * (W / 4);
      float sum = 0.f;
#pragma unroll 8
      for (int k = 0; k < W / 4; ++k)
        sum += __bfloat162float(hr[k]) * __bfloat162float(wa[k]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0 && t0 + t < n) on[3 * (size_t)n + t0 + t] = sum + __ldg(Bn + OB_A);
    }
    zero_acc<4>(acc);
    gemm_acc<4>(acc, hin, LDH, W, Wn + OFF_F, nw);
    store_act<4, false>(acc, Bn + OB_F, hout, LDH, nw);  // feat, no ReLU
    __syncthreads();

    // ---- views branch: [feat | xv | codes] -> 128, ReLU ----------------
    {
      float accv[4][2][4];
      const int nv = warp * 16;
      zero_acc<2>(accv);
      gemm_acc<2>(accv, hout, LDH, W, Wn + OFF_VF, nv);
      gemm_acc<2>(accv, XV, LDXV, DXV, Wn + OFF_VX, nv);
      store_act<2, true>(accv, Bn + OB_V, hin, LDH, nv);
    }
    __syncthreads();

    // ---- rgb head (f32 dot) ---------------------------------------------
    if (tid < T * 3) {
      const int t = tid / 3, ch = tid - t * 3;
      const bf16* hr = hin + t * LDH;
      const bf16* wr = Wn + OFF_R + ch * HV;
      float sum = 0.f;
#pragma unroll 8
      for (int k = 0; k < HV; ++k)
        sum += __bfloat162float(hr[k]) * __bfloat162float(wr[k]);
      if (t0 + t < n) on[(size_t)ch * n + t0 + t] = sum + __ldg(Bn + OB_R + ch);
    }
    __syncthreads();
  }
}

template <int NNET>
int launch(const float* p, const float* enc, const float* codes,
           const float* cutoff, const float* tau, const void* wpack,
           const float* bpack, float* out, int n, int S, int R, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      encmlp_fwd_kernel<NNET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + T - 1) / T;
  encmlp_fwd_kernel<NNET><<<grid, NTHREAD, SMEM_BYTES, (cudaStream_t)stream>>>(
      p, enc, codes, cutoff, tau, reinterpret_cast<const bf16*>(wpack), bpack,
      out, n, S, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One net: out (4, n) rows [r, g, b, sigma].
int encmlp_fwd(const float* p, const float* enc, const float* codes,
               const float* cutoff, const float* tau, const void* wpack,
               const float* bpack, float* out, int n, int S, int R,
               void* stream) {
  return launch<1>(p, enc, codes, cutoff, tau, wpack, bpack, out, n, S, R,
                   stream);
}

// Coarse and fine nets on one encode: codes (2, R, 16), wpack/bpack two
// packed sets back to back, out (2, 4, n).
int encmlp_dual_fwd(const float* p, const float* enc, const float* codes,
                    const float* cutoff, const float* tau, const void* wpack,
                    const float* bpack, float* out, int n, int S, int R,
                    void* stream) {
  return launch<2>(p, enc, codes, cutoff, tau, wpack, bpack, out, n, S, R,
                   stream);
}

// Sizes of one packed weight set, for the wrapper's checks.
long long encmlp_weight_elems(void) { return (long long)WSZ; }
int encmlp_bias_elems(void) { return BSZ; }

}  // extern "C"
