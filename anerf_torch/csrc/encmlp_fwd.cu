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
// The shape, the weight layout, the product, the encode and the MLP body
// (mlp_fwd_tile) live in encmlp_common.cuh, shared with K3-K6.
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

  const int t0 = blockIdx.x * T;
  const float tau = __ldg(tau_ptr);

  encode_tile(p, enc, cutoff, tau, X, XV, WIN, t0, n, S);

  for (int net = 0; net < NNET; ++net) {
    write_codes(XV, LDXV, codes + (size_t)net * R * NCODE, t0, n, S);
    __syncthreads();
    mlp_fwd_tile(X, XV, H0, H1, wpack + (size_t)net * WSZ,
                 bpack + (size_t)net * BSZ, out + (size_t)net * 4 * n, n, 1,
                 t0, n);
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
