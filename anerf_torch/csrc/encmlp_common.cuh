// Device code shared by the radiance-MLP kernels (encmlp_fwd.cu: K1,
// K2; encmlp_bwd.cu: K3, K4; mlp_fwd.cu: K5; mlp_bwd.cu: K6): the
// compiled shape, the packed weight layout, the tensor-core product, the
// in-block encode (K1-K4), the loader of split input parts (K5, K6) and
// the MLP forward of one tile.  Each .cu file includes it once;
// everything here has internal linkage.
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

// ---- split input parts (K5, K6) -----------------------------------------
// The trunk input [x_0 | x_1 | ...] (DX wide) and the views input
// [xv_0 | xv_1 | ... | 0] (DXV wide) arrive as separate row-major bf16
// part arrays of any width and alignment; a block copies its rows of
// each part into shared memory at the part's column offset.
constexpr int MAXP = 4;

struct Parts {
  const void* p[MAXP];   // (n, w[k]) row-major bf16, device memory
  int w[MAXP];
  int off[MAXP];         // column offset in the concatenated input
  int count;
  int total;             // sum of the widths
};

// Parts from the C interface's host arrays; false when there are more
// than MAXP parts, a width is not positive or they overflow `cap`.
inline bool make_parts(Parts& ps, const void* const* ptrs, const int* widths,
                       int count, int cap) {
  if (count < 1 || count > MAXP) return false;
  ps = Parts{};
  ps.count = count;
  for (int k = 0; k < count; ++k) {
    if (widths[k] < 1) return false;
    ps.p[k] = ptrs[k];
    ps.w[k] = widths[k];
    ps.off[k] = ps.total;
    ps.total += widths[k];
  }
  return ps.total <= cap;
}

__device__ __forceinline__ bf16 bf16_of(const uint4& v, int q) {
  const uint32_t word = q < 2 ? v.x : q < 4 ? v.y : q < 6 ? v.z : v.w;
  return __ushort_as_bfloat16((unsigned short)(word >> (16 * (q & 1))));
}

// dst[t, 0:width] = the parts' rows t0 + t, zeros past the parts and past
// n.  A part's rows t0 .. t0+T-1 are one contiguous run of T * w values
// (a multiple of 8) that starts 128 bytes into the part for every 64
// rows, so a thread reads 8 values at a time with one 16-byte load, LU
// loads in flight, whatever w is; it scatters them into the rows one by
// one, since a row of an odd-width part is not even 4-byte aligned.  A
// part whose base is not 16-byte aligned, and the ragged end of the last
// tile, are read value by value.  Leaves the block unsynchronised.
__device__ __forceinline__ void load_parts(const Parts& ps, bf16* dst, int ld,
                                           int width, int t0, int n) {
  constexpr int LU = 4;
  const int rows = min(T, n - t0);
  for (int k = 0; k < ps.count; ++k) {
    const int w = ps.w[k], valid = rows * w;
    const bf16* __restrict__ src =
        reinterpret_cast<const bf16*>(ps.p[k]) + (size_t)t0 * w;
    const bool vec = (reinterpret_cast<size_t>(ps.p[k]) & 15) == 0;
    bf16* d = dst + ps.off[k];
    for (int i0 = threadIdx.x * 8; i0 < T * w; i0 += LU * NTHREAD * 8) {
      uint4 v[LU];
#pragma unroll
      for (int u = 0; u < LU; ++u) {
        const int i = i0 + u * NTHREAD * 8;
        if (vec && i + 8 <= valid) {
          v[u] = __ldg(reinterpret_cast<const uint4*>(src + i));
        } else {
          uint32_t h[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            h[q] = i + q < valid ? __bfloat16_as_ushort(src[i + q]) : 0u;
          v[u] = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                            h[4] | h[5] << 16, h[6] | h[7] << 16);
        }
      }
#pragma unroll
      for (int u = 0; u < LU; ++u) {
        const int i = i0 + u * NTHREAD * 8;
        if (i < T * w) {
          int t = i / w, c = i - t * w;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            d[t * ld + c] = bf16_of(v[u], q);
            if (++c == w) {
              c = 0;
              ++t;
            }
          }
        }
      }
    }
  }
  const int pad = width - ps.total;
  for (int idx = threadIdx.x; idx < T * pad; idx += NTHREAD) {
    const int t = idx / pad;
    dst[t * ld + ps.total + idx - t * pad] = __float2bfloat16_rn(0.f);
  }
}

// ---- the MLP forward of one 64-point tile ---------------------------------
// X = the trunk input (T, LDX) and XV = the views input (T, LDXV), both
// complete in shared memory; H0, H1 = activation buffers (T, LDH).  Wn/Bn
// = one net's packed weights and biases.  Writes channel ch of point
// t0 + t < n to out[ch * cs + (t0 + t) * ps]: (cs, ps) = (n, 1) for K1's
// channel-major rows, (1, 4) for K5's row-major [rgb, alpha].  Ends with
// the block synchronised.
__device__ __forceinline__ void mlp_fwd_tile(const bf16* X, const bf16* XV,
                                             bf16* H0, bf16* H1,
                                             const bf16* __restrict__ Wn,
                                             const float* __restrict__ Bn,
                                             float* __restrict__ out, size_t cs,
                                             size_t ps, int t0, int n) {
  const int tid = threadIdx.x, warp = tid >> 5;
  // ---- density trunk -----------------------------------------------------
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

  // ---- alpha head (f32 dot, 4 lanes per point) and feature layer -------
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
    if (part == 0 && t0 + t < n)
      out[3 * cs + (size_t)(t0 + t) * ps] = sum + __ldg(Bn + OB_A);
  }
  zero_acc<4>(acc);
  gemm_acc<4>(acc, hin, LDH, W, Wn + OFF_F, nw);
  store_act<4, false>(acc, Bn + OB_F, hout, LDH, nw);  // feat, no ReLU
  __syncthreads();

  // ---- views branch: [feat | views input] -> 128, ReLU ------------------
  {
    float accv[4][2][4];
    const int nv = warp * 16;
    zero_acc<2>(accv);
    gemm_acc<2>(accv, hout, LDH, W, Wn + OFF_VF, nv);
    gemm_acc<2>(accv, XV, LDXV, DXV, Wn + OFF_VX, nv);
    store_act<2, true>(accv, Bn + OB_V, hin, LDH, nv);
  }
  __syncthreads();

  // ---- rgb head (f32 dot) -----------------------------------------------
  if (tid < T * 3) {
    const int t = tid / 3, ch = tid - t * 3;
    const bf16* hr = hin + t * LDH;
    const bf16* wr = Wn + OFF_R + ch * HV;
    float sum = 0.f;
#pragma unroll 8
    for (int k = 0; k < HV; ++k)
      sum += __bfloat162float(hr[k]) * __bfloat162float(wr[k]);
    if (t0 + t < n) out[ch * cs + (size_t)(t0 + t) * ps] = sum + __ldg(Bn + OB_R + ch);
  }
  __syncthreads();
}

}  // namespace
