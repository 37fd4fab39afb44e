// Device code shared by the fused encode + radiance-MLP kernels
// (encmlp_fwd.cu: K1, K2; encmlp_bwd.cu: K3, K4): the compiled shape,
// the packed weight layout, the tensor-core product and the in-block
// encode.  Each .cu file includes it once; everything here has internal
// linkage.
#pragma once
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

// The encode of points t0 .. t0+T-1 into shared memory: X = [v | r]
// (bf16), XV[:, 0:DE] = view rows x per-sample window and its zero tail
// past the codes (bf16), WIN = the windows (f32).  Points past n encode
// as p = 0.  Ends with the block synchronised.
__device__ __forceinline__ void encode_tile(const float* __restrict__ p,
                                            const float* __restrict__ enc,
                                            const float* __restrict__ cutoff,
                                            float tau, bf16* X, bf16* XV,
                                            float* WIN, int t0, int n,
                                            int S) {
  const int tid = threadIdx.x;
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
  __syncthreads();
}

}  // namespace
