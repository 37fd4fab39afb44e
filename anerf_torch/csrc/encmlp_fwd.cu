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
// C interface (loaded with ctypes): every pointer is device memory,
// the stream is PyTorch's current stream; returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int J = 24;
constexpr int NF = 7;                  // kp bands 2^0 .. 2^6
constexpr int NB = 9;                  // view PE rows (1 + 2 x 4)
constexpr int C3 = 3 * J;              // 72
constexpr int DV = (2 * NF + 1) * J;   // 360 kp encoding
constexpr int DX = DV + C3;            // 432 trunk input [v | r]
constexpr int DE = NB * C3;            // 648 view encoding
constexpr int NCODE = 16;
constexpr int DXV = 672;               // views input [xv | codes | 0 x 8]
constexpr int W = 256;
constexpr int HV = 128;
constexpr int DEPTH = 8;
constexpr int SKIP = 4;                // layer SKIP+1 consumes [h, x]
constexpr int T = 64;                  // points per block
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;

// shared-memory row strides in bf16 elements: rows stay 16-byte
// aligned and the +8 spreads the fragment loads over all 32 banks
constexpr int LDX = DX + 8;
constexpr int LDXV = DXV + 8;
constexpr int LDH = W + 8;

constexpr size_t SMEM_BYTES =
    sizeof(bf16) * (size_t)T * (LDX + LDXV + 2 * LDH) + sizeof(float) * T * J;

// packed weights (bf16, each matrix transposed to (out, in)); the layout
// anerf_torch/ops/fused_encmlp.py::_pack_kernel_weights writes
constexpr size_t SZ_X = (size_t)W * DX;
constexpr size_t SZ_H = (size_t)W * W;
__host__ __device__ constexpr size_t off_h(int i) {  // trunk layer i >= 1
  return SZ_X + (size_t)(i - 1) * SZ_H + (i > SKIP + 1 ? SZ_X : 0);
}
constexpr size_t OFF_SKIPX = SZ_X + (size_t)(SKIP + 1) * SZ_H;
constexpr size_t OFF_F = 2 * SZ_X + (size_t)(DEPTH - 1) * SZ_H;
constexpr size_t OFF_VF = OFF_F + SZ_H;
constexpr size_t OFF_VX = OFF_VF + (size_t)HV * W;
constexpr size_t OFF_A = OFF_VX + (size_t)HV * DXV;
constexpr size_t OFF_R = OFF_A + W;
constexpr size_t WSZ = OFF_R + 3 * HV;
// packed biases (f32)
constexpr int OB_F = DEPTH * W;
constexpr int OB_V = OB_F + W;
constexpr int OB_A = OB_V + HV;
constexpr int OB_R = OB_A + 1;
constexpr int BSZ = OB_R + 3;

__device__ __forceinline__ uint32_t lds_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[4][NT][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
}

// acc += A[0:64, 0:K] @ Wt[n0 : n0 + 8 NT, 0:K]^T for this warp's
// columns.  A: shared, row-major, stride lda; Wt: global, (N, K)
// row-major.  Fragment layouts of mma.m16n8k16 (PTX ISA): A regs hold
// (row g | g+8, cols 2q..2q+1 | +8); B regs (k = 2q..2q+1 | +8, col g).
template <int NT>
__device__ __forceinline__ void gemm_acc(float (&acc)[4][NT][4], const bf16* A,
                                         int lda, int K,
                                         const bf16* __restrict__ Wt, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const bf16* wrow[NT];
  uint32_t b[NT][2], bn[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    wrow[j] = Wt + (size_t)(n0 + j * 8 + g) * K + 2 * q;
    b[j][0] = ldg_u32(wrow[j]);
    b[j][1] = ldg_u32(wrow[j] + 8);
    bn[j][0] = bn[j][1] = 0u;
  }
  for (int k0 = 0; k0 < K; k0 += 16) {
    if (k0 + 16 < K) {  // prefetch the next k-slice of the weights
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        bn[j][0] = ldg_u32(wrow[j] + k0 + 16);
        bn[j][1] = ldg_u32(wrow[j] + k0 + 24);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const bf16* ap = A + (m * 16 + g) * lda + k0 + 2 * q;
      uint32_t a[4] = {lds_u32(ap), lds_u32(ap + 8 * lda), lds_u32(ap + 8),
                       lds_u32(ap + 8 * lda + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[m][j], a, b[j][0], b[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      b[j][0] = bn[j][0];
      b[j][1] = bn[j][1];
    }
  }
}

// out[row, col] = bf16(act(acc + bias[col])) for this warp's columns
template <int NT, bool RELU>
__device__ __forceinline__ void store_act(const float (&acc)[4][NT][4],
                                          const float* __restrict__ bias,
                                          bf16* out, int ldo, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + j * 8 + 2 * q;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int row = m * 16 + g;
      float v0 = acc[m][j][0] + b0, v1 = acc[m][j][1] + b1;
      float v2 = acc[m][j][2] + b0, v3 = acc[m][j][3] + b1;
      if (RELU) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
        v2 = fmaxf(v2, 0.f);
        v3 = fmaxf(v3, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + col) =
          __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * ldo + col) =
          __floats2bfloat162_rn(v2, v3);
    }
  }
}

// XV[:, DE:DE+NCODE] = this net's per-ray codes
__device__ __forceinline__ void write_codes(bf16* XV, const float* __restrict__ codes,
                                            int t0, int n, int S) {
  for (int idx = threadIdx.x; idx < T * (NCODE / 2); idx += NTHREAD) {
    const int t = idx / (NCODE / 2), c = (idx - t * (NCODE / 2)) * 2;
    const int gp = t0 + t;
    float v0 = 0.f, v1 = 0.f;
    if (gp < n) {
      const float* cr = codes + (size_t)(gp / S) * NCODE;
      v0 = __ldg(cr + c);
      v1 = __ldg(cr + c + 1);
    }
    *reinterpret_cast<__nv_bfloat162*>(XV + t * LDXV + DE + c) =
        __floats2bfloat162_rn(v0, v1);
  }
}

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

  // ---- encode: distances, windows, kp PE (double-angle recurrence),
  // bone directions -------------------------------------------------------
  for (int idx = tid; idx < T * J; idx += NTHREAD) {
    const int t = idx / J, j = idx - t * J, gp = t0 + t;
    float x = 0.f, y = 0.f, z = 0.f;
    if (gp < n) {
      const float* pp = p + (size_t)gp * C3;
      x = __ldg(pp + j);
      y = __ldg(pp + J + j);
      z = __ldg(pp + 2 * J + j);
    }
    const float d = sqrtf(x * x + y * y + z * z);
    const float w = 1.f - 1.f / (1.f + expf(-tau * (d - __ldg(cutoff + j))));
    bf16* xr = X + t * LDX;
    xr[j] = __float2bfloat16_rn(d * w);
    float s = sinf(d), c = sinf(d + 1.57079632679489662f);
    xr[J + j] = __float2bfloat16_rn(s * w);
    xr[2 * J + j] = __float2bfloat16_rn(c * w);
#pragma unroll
    for (int k = 1; k < NF; ++k) {
      const float s2 = 2.f * s * c;
      c = 1.f - 2.f * s * s;
      s = s2;
      xr[(1 + 2 * k) * J + j] = __float2bfloat16_rn(s * w);
      xr[(2 + 2 * k) * J + j] = __float2bfloat16_rn(c * w);
    }
    const float invd = 1.f / fmaxf(d, 1e-12f);
    xr[DV + j] = __float2bfloat16_rn(x * invd);
    xr[DV + J + j] = __float2bfloat16_rn(y * invd);
    xr[DV + 2 * J + j] = __float2bfloat16_rn(z * invd);
    WIN[t * J + j] = w;
  }
  __syncthreads();

  // ---- view rows x per-sample window (xv[t, c] = enc[ray, c] w[t, c % J]),
  // then the zero tail of the views input --------------------------------
  for (int idx = tid; idx < T * (DE / 2); idx += NTHREAD) {
    const int t = idx / (DE / 2), c = (idx - t * (DE / 2)) * 2;
    const int gp = t0 + t;
    float v0 = 0.f, v1 = 0.f;
    if (gp < n) {
      const float* er = enc + (size_t)(gp / S) * DE;
      v0 = __ldg(er + c) * WIN[t * J + c % J];
      v1 = __ldg(er + c + 1) * WIN[t * J + (c + 1) % J];
    }
    *reinterpret_cast<__nv_bfloat162*>(XV + t * LDXV + c) =
        __floats2bfloat162_rn(v0, v1);
  }
  for (int idx = tid; idx < T * (DXV - DE - NCODE); idx += NTHREAD) {
    const int t = idx / (DXV - DE - NCODE);
    XV[t * LDXV + DE + NCODE + (idx - t * (DXV - DE - NCODE))] =
        __float2bfloat16_rn(0.f);
  }

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
