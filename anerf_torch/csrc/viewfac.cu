// The per-ray operands of the view factorization (viewfac) for Hopper
// (sm_90a): K-vf1, the per-ray matrix M before the fused kernels, and
// K-vf2, the per-ray fold after the backward.
//
// Replaces the per-ray parts of anerf_tpu/ops/pallas_mlp.py's
// viewfac_operand / _viewfac_dot / _viewfac_bwd (:151-222) that the
// fused Pallas kernels (_fwd_kernel_dual, _bwd_kernel_dual) build inside
// each tile from the whole views weight.  The 'relray' view rows are
// constant along a ray, so the views layer's views-input product is
// xw @ M with, for each ray r and joint j (column c = b J + j of the
// 648, b < 27):
//   M[r, j, :] = bf16( sum_b bf16(enc[r, b J + j]) Wvx[b J + j, :] )
// and its backward folds the per-ray Gram matrix Gw = bf16(xw^T g_hv)
// (encmlp_bwd.cu's vf_gram_kernel forms it):
//   dWvx[c, :] = sum_r bf16(enc[r, c]) Gw[r, c % J, :]
//   d_enc[r, c] = sum_net Wvx[c, :] . Gw[r, c % J, :]
// A Hopper block holding a 64-point tile (one ray at S = 64) cannot
// rebuild M from the 166 KB of Wvx per tile without streaming the
// weight viewfac is meant to save, so M is built once per ray and net
// here, and the tile reads its rays' 6 KB.
//
// K-vf1 (vf_m_kernel): a block per (128 rays, joint, net): the joint's
// 27 weight rows and the rays' 27 view values in shared memory, a
// thread per column and 64 rays, each value's 27 products summed in
// order in f32.
// K-vf2: vf_dwv_kernel takes a (joint, net, slice of
// rays) a block and writes its f32 partial of the 27 x HV rows of dWvx;
// vf_dwv_sum_kernel adds the slices in order into the weight gradient;
// vf_denc_kernel takes a (joint, 128 rays) a block.  No atomics: every sum runs in a
// fixed order, so two calls give the same bits.
//
// Bound: K-vf1 reads enc (R x 648 f32) and Wvx and writes M (nnet x R x
// 24 x HV bf16), 27 f32 MACs a value of M; K-vf2 reads Gw (nnet x R x
// 24 x HV bf16), enc and Wvx and writes dWvx and denc, R MACs a value
// of dWvx and HV of denc: f32 operations on the CUDA cores bound both,
// near the bytes' time.
//
// C interface (loaded with ctypes): every pointer is device memory, the
// stream is PyTorch's current stream; returns cudaGetLastError().
#include "encmlp_common.cuh"

namespace {

constexpr int NBJ = NB * 3;          // 27 view columns a joint
constexpr int MRAYS = 128;           // K-vf1: rays a block
constexpr int DW_RAYS = 32;          // K-vf2's dWvx: rays staged a step

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// M[net, r, j, :] for rays r0 .. r0 + MRAYS - 1, joint blockIdx.y, net
// blockIdx.z; wvx (nnet, DE, HV) bf16, enc (R, DE) f32.  Thread (h, g)
// holds column h of MRAYS / G rays of group g: a weight value and four
// rays' view values (one 16-byte load, the same for the warp) a step.
__global__ void __launch_bounds__(256)
vf_m_kernel(const float* __restrict__ enc, const bf16* __restrict__ wvx,
            bf16* __restrict__ M, int R) {
  constexpr int G = 256 / HV, RPT = MRAYS / G;
  static_assert(256 % HV == 0 && RPT % 4 == 0, "whole columns, 4-ray loads");
  __shared__ float w[NBJ][HV];
  // transposed, [b][ray]; rows 4 floats apart from a bank's multiple
  __shared__ __align__(16) float e[NBJ][MRAYS + 4];
  const int j = blockIdx.y, net = blockIdx.z, r0 = blockIdx.x * MRAYS;
  const bf16* wn = wvx + (size_t)net * DE * HV;
  for (int i = threadIdx.x; i < NBJ * HV; i += blockDim.x) {
    const int b = i / HV, h = i - b * HV;
    w[b][h] = __bfloat162float(wn[(size_t)(b * J + j) * HV + h]);
  }
  for (int i = threadIdx.x; i < MRAYS * NBJ; i += blockDim.x) {
    const int r = i / NBJ, b = i - r * NBJ;
    e[b][r] = r0 + r < R ? bf16r(__ldg(enc + (size_t)(r0 + r) * DE + b * J + j))
                         : 0.f;
  }
  __syncthreads();
  const int h = threadIdx.x % HV, rb = (threadIdx.x / HV) * RPT;
  float acc[RPT] = {};
#pragma unroll 3
  for (int b = 0; b < NBJ; ++b) {
    const float wv = w[b][h];
#pragma unroll
    for (int q = 0; q < RPT; q += 4) {
      const float4 ev = *reinterpret_cast<const float4*>(&e[b][rb + q]);
      acc[q] += ev.x * wv;
      acc[q + 1] += ev.y * wv;
      acc[q + 2] += ev.z * wv;
      acc[q + 3] += ev.w * wv;
    }
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q)
    if (r0 + rb + q < R)
      M[(((size_t)net * R + r0 + rb + q) * J + j) * HV + h] =
          __float2bfloat16_rn(acc[q]);
}

// part[slice][net][b J + j][h] = sum over the slice's rays, in order, of
// bf16(enc[r, b J + j]) Gw[net, r, j, h]: a block per (joint, net,
// slice), a thread per column h and every 256 / HV-th of the 27 rows
__global__ void __launch_bounds__(256)
vf_dwv_kernel(const float* __restrict__ enc, const bf16* __restrict__ gw,
              float* __restrict__ part, int R, int nnet, int slice) {
  constexpr int RG = 256 / HV, NPER = (NBJ + RG - 1) / RG;
  static_assert(256 % HV == 0, "whole columns a block");
  __shared__ float e[DW_RAYS][NBJ];
  __shared__ float g[DW_RAYS][HV];
  const int j = blockIdx.x, net = blockIdx.y, sl = blockIdx.z;
  const int h = threadIdx.x % HV, b0 = threadIdx.x / HV;
  const int rb = sl * slice, re = min(R, rb + slice);
  float acc[NPER] = {};
  for (int r0 = rb; r0 < re; r0 += DW_RAYS) {
    const int nr = min(DW_RAYS, re - r0);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * NBJ; i += blockDim.x) {
      const int r = i / NBJ, b = i - r * NBJ;
      e[r][b] = bf16r(__ldg(enc + (size_t)(r0 + r) * DE + b * J + j));
    }
    for (int i = threadIdx.x; i < nr * HV; i += blockDim.x) {
      const int r = i / HV, hh = i - r * HV;
      g[r][hh] = __bfloat162float(gw[(((size_t)net * R + r0 + r) * J + j) * HV + hh]);
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      const float gv = g[r][h];
#pragma unroll
      for (int k = 0; k < NPER; ++k)
        if (b0 + k * RG < NBJ) acc[k] += e[r][b0 + k * RG] * gv;
    }
  }
#pragma unroll
  for (int k = 0; k < NPER; ++k) {
    const int b = b0 + k * RG;
    if (b < NBJ)
      part[(((size_t)sl * nnet + net) * DE + b * J + j) * HV + h] = acc[k];
  }
}

// dw[net * wstride + c * HV + h] = sum of the P slices' parts in order
__global__ void __launch_bounds__(256)
vf_dwv_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                  long long wstride, int nnet, int P) {
  const size_t per = (size_t)DE * HV, total = per * nnet;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int p = 1; p < P; ++p) s += part[(size_t)p * total + i];
    const size_t net = i / per;
    dw[net * (size_t)wstride + (i - net * per)] = s;
  }
}

// denc[r, b J + j] = sum over the nets, in order, of Wvx[net, b J + j, :]
// . Gw[net, r, j, :]: a block per (joint j, DENC_RAYS rays), the joint's
// 27 weight rows of each net and the rays' Gw in shared memory; thread
// (ray group, row group) holds 4 rays x 7 rows, a step a value of Gw
// for its 4 rays (one 16-byte load) and of each of its 7 rows
constexpr int DENC_RAYS = 128, DENC_RB = 7;

__global__ void __launch_bounds__(128)
vf_denc_kernel(const bf16* __restrict__ wvx, const bf16* __restrict__ gw,
               float* __restrict__ denc, int R, int nnet) {
  constexpr int NRG = DENC_RAYS / 4, NBG = (NBJ + DENC_RB - 1) / DENC_RB;
  static_assert(NRG * NBG == 128, "a thread per (4 rays, 7 rows)");
  constexpr int HC = 32;     // Gw's columns staged a step
  // [h][ray]; rows 4 floats apart from a bank's multiple
  __shared__ __align__(16) float g[HC][DENC_RAYS + 4];
  __shared__ float w[NBJ][HC];
  const int j = blockIdx.x, r0 = blockIdx.y * DENC_RAYS;
  const int rg = threadIdx.x % NRG, bg = threadIdx.x / NRG;
  float total[4][DENC_RB] = {};
  for (int net = 0; net < nnet; ++net) {
    float acc[4][DENC_RB] = {};
    for (int h0 = 0; h0 < HV; h0 += HC) {
      __syncthreads();
      for (int i = threadIdx.x; i < DENC_RAYS * HC; i += blockDim.x) {
        const int r = i / HC, h = i - r * HC;
        g[h][r] = r0 + r < R ? __bfloat162float(
            gw[(((size_t)net * R + r0 + r) * J + j) * HV + h0 + h]) : 0.f;
      }
      for (int i = threadIdx.x; i < NBJ * HC; i += blockDim.x) {
        const int b = i / HC, h = i - b * HC;
        w[b][h] = __bfloat162float(
            wvx[((size_t)net * DE + b * J + j) * HV + h0 + h]);
      }
      __syncthreads();
#pragma unroll 4
      for (int h = 0; h < HC; ++h) {
        const float4 gv = *reinterpret_cast<const float4*>(&g[h][rg * 4]);
#pragma unroll
        for (int k = 0; k < DENC_RB; ++k) {
          const int b = bg * DENC_RB + k;
          const float wv = b < NBJ ? w[b][h] : 0.f;
          acc[0][k] += gv.x * wv;
          acc[1][k] += gv.y * wv;
          acc[2][k] += gv.z * wv;
          acc[3][k] += gv.w * wv;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int k = 0; k < DENC_RB; ++k)
        total[q][k] = net ? total[q][k] + acc[q][k] : acc[q][k];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < DENC_RB; ++k) {
      const int r = r0 + rg * 4 + q, b = bg * DENC_RB + k;
      if (r < R && b < NBJ) denc[(size_t)r * DE + b * J + j] = total[q][k];
    }
}

}  // namespace

extern "C" {

// K-vf1: M (nnet, R, J, HV) bf16 from enc (R, 648) f32 and each net's
// views-input weight rows wvx (nnet, 648, HV) bf16.
int viewfac_m(const float* enc, const void* wvx, void* M, int R, int nnet,
              void* stream) {
  if (R <= 0) return 0;
  if (nnet < 1 || nnet > 2) return (int)cudaErrorInvalidValue;
  vf_m_kernel<<<dim3((R + MRAYS - 1) / MRAYS, J, nnet), 256, 0,
                (cudaStream_t)stream>>>(enc, reinterpret_cast<const bf16*>(wvx),
                                        reinterpret_cast<bf16*>(M), R);
  return (int)cudaGetLastError();
}

// K-vf2: from the nets' per-ray Gram matrices gw (nnet, R, J, HV) bf16
// (encmlp_bwd.cu's vf_gram_kernel): dWvx into dw (net's at dw + net *
// wstride, (648, HV) row-major f32) and denc (R, 648) f32; part (P,
// nnet, 648, HV) f32 is scratch, P slices of `slice` rays.
int viewfac_fold(const void* gw, const float* enc, const void* wvx,
                 float* dw, long long wstride, float* denc, float* part,
                 int P, int slice, int R, int nnet, void* stream) {
  if (R <= 0) return 0;
  if (nnet < 1 || nnet > 2 || slice <= 0 || P != (R + slice - 1) / slice)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* g = reinterpret_cast<const bf16*>(gw);
  const bf16* w = reinterpret_cast<const bf16*>(wvx);
  vf_dwv_kernel<<<dim3(J, nnet, P), 256, 0, st>>>(enc, g, part, R, nnet,
                                                  slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vf_dwv_sum_kernel<<<(int)(((size_t)nnet * DE * HV + 255) / 256), 256, 0,
                      st>>>(part, dw, wstride, nnet, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  vf_denc_kernel<<<dim3(J, (R + DENC_RAYS - 1) / DENC_RAYS), 128, 0, st>>>(
      w, g, denc, R, nnet);
  return (int)cudaGetLastError();
}

// The build's views width, for the wrapper's checks.
int viewfac_width(void) { return HV; }

}  // extern "C"
