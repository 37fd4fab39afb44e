// Device code shared by the backward kernels of the radiance MLP
// (encmlp_bwd.cu: K3, K4; mlp_bwd.cu: K6): the workspace, the MLP
// backward of one 64-point tile, and the deterministic bias and weight
// gradient passes.  See encmlp_bwd.cu for the design.  Each .cu file
// includes it once; everything here has internal linkage.
#pragma once
#include "encmlp_common.cuh"

namespace {

// the backward weight pack and the weight-gradient buffer share one
// layout: every weight (in, out) row-major in flatten order
// (anerf_torch/ops/fused_mlp.py::_grad_layout)
constexpr size_t G_A = 2 * SZ_X + (size_t)(DEPTH - 1) * SZ_H;  // (256, 1)
constexpr size_t G_F = G_A + W;                                // (256, 256)
constexpr size_t G_VF = G_F + SZ_H;                            // (256, 128)
constexpr size_t G_VX = G_VF + (size_t)W * HV;                 // (672, 128)
constexpr size_t G_R = G_VX + (size_t)DXV * HV;                // (128, 3)
constexpr size_t WGSZ = G_R + 3 * HV;
// trunk layer i's weights: off_h(i) (h part), 0 (layer 0), OFF_SKIPX
// (layer SKIP+1's [v | r] part): the forward's offsets, which already
// follow flatten order for the trunk

constexpr int NGS = 8;  // bf16 head cotangents a point: [rgb 3 | alpha | 0]

// workspace: bf16 arrays, each (n_pad, width) row-major, then f32 ones
struct Work {
  bf16* x;            // [v | r]                       (432)
  bf16* xv[2];        // [xv | codes | 0] per net      (672)
  bf16* act[2];       // trunk activations, 8 layers   (8 x 256)
  bf16* feat[2];      // (256)
  bf16* hv[2];        // (128)
  bf16* gp[2];        // pre-activation cotangents     (8 x 256)
  bf16* gf[2];        // feat cotangent                (256)
  bf16* ghv[2];       // views cotangent               (128)
  bf16* gs[2];        // head cotangents               (8)
  float* gx[2];       // [v | r] input cotangent       (432)
  float* gxv[2];      // views input cotangent         (672)
  float* win;         // windows (K3/K4 only)          (24)
  float* bpart[2];    // per-tile bias partials        (ntile, BSZ)
};

constexpr int BF_PER_NET = DXV + DEPTH * W + W + HV + DEPTH * W + W + HV + NGS;
constexpr int F_PER_NET = DX + DXV;

__host__ __device__ inline size_t round_up(size_t v, size_t a) {
  return (v + a - 1) / a * a;
}

// nwin: f32 values a point after the nets' arrays (J windows for K3/K4,
// none for K6)
size_t workspace_bytes(int n, int nnet, int nwin) {
  const size_t np = round_up((size_t)n, T), ntile = np / T;
  return round_up(np * 2 * (DX + (size_t)nnet * BF_PER_NET), 256) +
         np * 4 * ((size_t)nnet * F_PER_NET + nwin) +
         (size_t)nnet * ntile * BSZ * 4;
}

Work carve(void* base, int n, int nnet, int nwin) {
  const size_t np = round_up((size_t)n, T);
  Work w{};
  bf16* b = reinterpret_cast<bf16*>(base);
  auto take = [&](size_t width) { bf16* r = b; b += np * width; return r; };
  w.x = take(DX);
  for (int k = 0; k < nnet; ++k) {
    w.xv[k] = take(DXV);
    w.act[k] = take(DEPTH * W);
    w.feat[k] = take(W);
    w.hv[k] = take(HV);
    w.gp[k] = take(DEPTH * W);
    w.gf[k] = take(W);
    w.ghv[k] = take(HV);
    w.gs[k] = take(NGS);
  }
  float* f = reinterpret_cast<float*>(
      reinterpret_cast<char*>(base) +
      round_up(np * 2 * (DX + (size_t)nnet * BF_PER_NET), 256));
  for (int k = 0; k < nnet; ++k) {
    w.gx[k] = f;
    f += np * DX;
    w.gxv[k] = f;
    f += np * DXV;
  }
  w.win = f;
  f += np * nwin;
  for (int k = 0; k < nnet; ++k) {
    w.bpart[k] = f;
    f += (np / T) * BSZ;
  }
  return w;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// rows of a shared-memory tile (T rows, stride lds) -> device memory
// (stride ldg), `width` bf16 a row, 16 bytes at a time
__device__ __forceinline__ void copy_rows(bf16* __restrict__ dst, int ldg,
                                          const bf16* src, int lds,
                                          int width) {
  const int per_row = width / 8;
  for (int idx = threadIdx.x; idx < T * per_row; idx += NTHREAD) {
    const int t = idx / per_row, c = (idx - t * per_row) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)t * ldg + c) =
        *reinterpret_cast<const uint4*>(src + t * lds + c);
  }
}

// column sums over the tile's 64 rows of a warp's accumulators (its
// 8 NT columns from n0), written to out[n0 ...]; deterministic: the
// rows of a thread first, then the 8 row groups by a fixed butterfly
template <int NT>
__device__ __forceinline__ void colsum_store(const float (&acc)[4][NT][4],
                                             float* __restrict__ out,
                                             int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      s0 += acc[m][j][0] + acc[m][j][2];
      s1 += acc[m][j][1] + acc[m][j][3];
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (g == 0) {
      out[n0 + j * 8 + 2 * q] = s0;
      out[n0 + j * 8 + 2 * q + 1] = s1;
    }
  }
}

// the bf16 rounding of a warp's accumulators into shared memory (stride
// LDH; the next product's A) and device memory (stride ldg; the dW G)
template <int NT>
__device__ __forceinline__ void emit_bf16(const float (&acc)[4][NT][4], bf16* sm,
                                          bf16* __restrict__ gdst, int ldg,
                                          int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + j * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m * 16 + g + 8 * h;
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[m][j][2 * h],
                                                       acc[m][j][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(sm + row * LDH + col) = v;
        *reinterpret_cast<__nv_bfloat162*>(gdst + (size_t)row * ldg + col) = v;
      }
    }
}

// acc <- acc * (act > 0) with act the bf16 activation in device memory
// (this tile's rows, stride DEPTH * W); then the bias partial of the f32 cotangent,
// and its bf16 rounding into shared memory (the next product's A) and
// device memory (the dW pass's G)
template <int NT>
__device__ __forceinline__ void mask_emit(float (&acc)[4][NT][4],
                                          const bf16* __restrict__ act,
                                          float* __restrict__ bpart,
                                          bf16* sm, bf16* __restrict__ gdst,
                                          int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + j * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m * 16 + g + 8 * h;
        const __nv_bfloat162 a =
            *reinterpret_cast<const __nv_bfloat162*>(act + (size_t)row * DEPTH * W +
                                                     col);
        if (!(__bfloat162float(a.x) > 0.f)) acc[m][j][2 * h] = 0.f;
        if (!(__bfloat162float(a.y) > 0.f)) acc[m][j][2 * h + 1] = 0.f;
      }
    }
  colsum_store<NT>(acc, bpart, n0);
  emit_bf16<NT>(acc, sm, gdst, DEPTH * W, n0);
}

// out[t0 + row, c] (=|+=) (A @ Wt^T)[row, c] for all N columns, in
// 16-column chunks dealt round-robin to the warps; f32 to device memory
template <bool ADD>
__device__ __forceinline__ void gemm_to_global(const bf16* A, int lda, int K,
                                               const bf16* __restrict__ Wt,
                                               int N, float* __restrict__ out,
                                               int ldo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int warp = threadIdx.x >> 5;
  for (int n0 = warp * 16; n0 < N; n0 += NWARP * 16) {
    float acc[4][2][4];
    zero_acc<2>(acc);
    gemm_acc<2>(acc, A, lda, K, Wt, n0);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* o = reinterpret_cast<float2*>(
              out + (size_t)(m * 16 + g + 8 * h) * ldo + n0 + j * 8 + 2 * q);
          float2 v = make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
          if (ADD) {
            const float2 old = *o;
            v.x = old.x + v.x;
            v.y = old.y + v.y;
          }
          *o = v;
        }
  }
}

// The MLP backward of one tile for net `net` (Wn/Bn its forward packs,
// Wb its backward pack): X and XV complete in shared memory, GSM the
// tile's raw cotangent (T, 4) [rgb, alpha].  Writes the views input,
// every bf16 activation and cotangent, the f32 input cotangents gx/gxv
// and the tile's bias partials to the workspace `wk`.  Ends with the
// block synchronised.
__device__ __forceinline__ void mlp_bwd_tile(const bf16* X, const bf16* XV,
                                             bf16* H0, bf16* H1,
                                             const float* GSM,
                                             const bf16* __restrict__ Wn,
                                             const bf16* __restrict__ Wb,
                                             const float* __restrict__ Bn,
                                             const Work& wk, int net, int t0) {
  const int tid = threadIdx.x, warp = tid >> 5;
  float* bpart = wk.bpart[net] + (size_t)blockIdx.x * BSZ;
  bf16* act = wk.act[net];
  bf16* gp = wk.gp[net];
  copy_rows(wk.xv[net] + (size_t)t0 * DXV, DXV, XV, LDXV, DXV);

  // ---- forward recompute, every activation to device memory --------
  float acc[4][4][4];
  const int nw = warp * 32;
  zero_acc<4>(acc);
  gemm_acc<4>(acc, X, LDX, DX, Wn, nw);
  store_act<4, true>(acc, Bn, H0, LDH, nw);
  __syncthreads();
  copy_rows(act + (size_t)t0 * DEPTH * W, DEPTH * W, H0, LDH, W);
  bf16* hin = H0;
  bf16* hout = H1;
#pragma unroll 1
  for (int i = 1; i < DEPTH; ++i) {
    zero_acc<4>(acc);
    gemm_acc<4>(acc, hin, LDH, W, Wn + off_h(i), nw);
    if (i == SKIP + 1) gemm_acc<4>(acc, X, LDX, DX, Wn + OFF_SKIPX, nw);
    store_act<4, true>(acc, Bn + i * W, hout, LDH, nw);
    __syncthreads();
    copy_rows(act + (size_t)t0 * DEPTH * W + i * W, DEPTH * W, hout, LDH, W);
    bf16* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  zero_acc<4>(acc);
  gemm_acc<4>(acc, hin, LDH, W, Wn + OFF_F, nw);
  store_act<4, false>(acc, Bn + OB_F, hout, LDH, nw);  // feat
  __syncthreads();
  copy_rows(wk.feat[net] + (size_t)t0 * W, W, hout, LDH, W);
  {
    float accv[4][2][4];
    const int nv = warp * 16;
    zero_acc<2>(accv);
    gemm_acc<2>(accv, hout, LDH, W, Wn + OFF_VF, nv);
    gemm_acc<2>(accv, XV, LDXV, DXV, Wn + OFF_VX, nv);
    store_act<2, true>(accv, Bn + OB_V, hin, LDH, nv);  // hv
  }
  __syncthreads();
  copy_rows(wk.hv[net] + (size_t)t0 * HV, HV, hin, LDH, HV);
  __syncthreads();
  bf16* HVB = hin;    // hv, then the bf16 views cotangent in place
  bf16* FB = hout;    // feat, then the bf16 feat cotangent

  // ---- heads: g_hv = (bf16(g_rgb) . wr) * (hv > 0), column by column -
  if (tid < HV) {
    const int h = tid;
    const float w0 = __bfloat162float(Wb[G_R + h * 3]);
    const float w1 = __bfloat162float(Wb[G_R + h * 3 + 1]);
    const float w2 = __bfloat162float(Wb[G_R + h * 3 + 2]);
    float colsum = 0.f;
    for (int t = 0; t < T; ++t) {
      const float* gr = GSM + t * 4;
      float v = bf16r(gr[0]) * w0 + bf16r(gr[1]) * w1 + bf16r(gr[2]) * w2;
      if (!(__bfloat162float(HVB[t * LDH + h]) > 0.f)) v = 0.f;
      colsum += v;
      const bf16 vb = __float2bfloat16_rn(v);
      HVB[t * LDH + h] = vb;
      wk.ghv[net][(size_t)(t0 + t) * HV + h] = vb;
    }
    bpart[OB_V + h] = colsum;
  } else if (tid < HV + 4) {
    // rgb and alpha bias partials; the bf16 head cotangents
    const int c = tid - HV;
    float colsum = 0.f;
    for (int t = 0; t < T; ++t) {
      colsum += GSM[t * 4 + c];
      wk.gs[net][(size_t)(t0 + t) * NGS + c] =
          __float2bfloat16_rn(GSM[t * 4 + c]);
    }
    bpart[c < 3 ? OB_R + c : OB_A] = colsum;
  } else if (tid < HV + 8) {
    const int c = tid - HV;
    for (int t = 0; t < T; ++t)
      wk.gs[net][(size_t)(t0 + t) * NGS + c] = __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  // ---- g_feat = g_hv_b @ wvf^T (bias partial, bf16 to FB); the views
  // input cotangent g_xv = g_hv_b @ wvx^T to device memory ------------
  zero_acc<4>(acc);
  gemm_acc<4>(acc, HVB, LDH, HV, Wb + G_VF, nw);
  colsum_store<4>(acc, bpart + OB_F, nw);
  emit_bf16<4>(acc, FB, wk.gf[net] + (size_t)t0 * W, W, nw);
  gemm_to_global<false>(HVB, LDH, HV, Wb + G_VX, DXV,
                        wk.gxv[net] + (size_t)t0 * DXV, DXV);
  __syncthreads();

  // ---- g_a = g_feat_b @ wf^T + bf16(g_alpha) wa; layer 7's cotangent --
  zero_acc<4>(acc);
  gemm_acc<4>(acc, FB, LDH, W, Wb + G_F, nw);
  {
    const int lane = tid & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = nw + j * 8 + 2 * q;
        const float wa0 = __bfloat162float(Wb[G_A + col]);
        const float wa1 = __bfloat162float(Wb[G_A + col + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float ga = bf16r(GSM[(m * 16 + g + 8 * h) * 4 + 3]);
          acc[m][j][2 * h] += ga * wa0;
          acc[m][j][2 * h + 1] += ga * wa1;
        }
      }
  }
  bf16* gin_b = HVB;   // the current layer's bf16 cotangent
  bf16* gout_b = FB;
  mask_emit<4>(acc, act + (size_t)t0 * DEPTH * W + (DEPTH - 1) * W,
               bpart + (DEPTH - 1) * W, gin_b,
               gp + (size_t)t0 * DEPTH * W + (DEPTH - 1) * W, nw);
  __syncthreads();

  // ---- the trunk in reverse ----------------------------------------
#pragma unroll 1
  for (int i = DEPTH - 1; i >= 1; --i) {
    if (i == SKIP + 1)
      gemm_to_global<false>(gin_b, LDH, W, Wb + OFF_SKIPX, DX,
                            wk.gx[net] + (size_t)t0 * DX, DX);
    zero_acc<4>(acc);
    gemm_acc<4>(acc, gin_b, LDH, W, Wb + off_h(i), nw);
    mask_emit<4>(acc, act + (size_t)t0 * DEPTH * W + (i - 1) * W,
                 bpart + (i - 1) * W, gout_b,
                 gp + (size_t)t0 * DEPTH * W + (i - 1) * W, nw);
    __syncthreads();
    bf16* tmp = gin_b;
    gin_b = gout_b;
    gout_b = tmp;
  }
  gemm_to_global<true>(gin_b, LDH, W, Wb, DX, wk.gx[net] + (size_t)t0 * DX,
                       DX);
  __syncthreads();
}

// bias gradients: the per-tile partials summed in tile order
__global__ void bias_kernel(Work wk, float* __restrict__ db, int ntile,
                            int nnet) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nnet * BSZ) return;
  const int net = idx / BSZ, k = idx - net * BSZ;
  float sum = 0.f;
  for (int t = 0; t < ntile; ++t) sum += wk.bpart[net][(size_t)t * BSZ + k];
  db[idx] = sum;
}

// ---- weight gradients: out (M, N) = A^T G, A (np, M) and G (np, N) -----
// One block per 128 x 128 output tile, 8 warps of 64 x 32.  Each step
// stages 32 points of A and G in shared memory as they lie in device
// memory (point-major rows, 16-byte copies; the next step's rows wait in
// registers meanwhile), and ldmatrix.trans turns them into the mma
// fragments of the point-contracted product.
constexpr int DW_TM = 128, DW_TN = 128, DW_TK = 32, DW_LD = 128 + 8;
constexpr int MAX_JOBS = 32;

struct DwJob {
  const bf16* a;
  const bf16* g;
  float* out;
  int lda, m, ldg, ncols;  // A stride and rows of the result; G stride, cols
};

struct DwJobs {
  DwJob job[MAX_JOBS];
  int first_tile[MAX_JOBS + 1];
  int njobs;
};

// this thread's two 8-wide pieces of 32 points x 128 columns of a
// (np, ld) array, columns past lim as zeros
__device__ __forceinline__ void dw_load(uint4 (&v)[2], const bf16* __restrict__ src,
                                        int ld, int lim, int c0, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * NTHREAD, row = idx >> 4,
              c = c0 + (idx & 15) * 8;
    const bf16* s = src + (size_t)(k0 + row) * ld + c;
    if (c + 8 <= lim && (ld & 7) == 0 &&
        (reinterpret_cast<size_t>(s) & 15) == 0) {
      v[i] = *reinterpret_cast<const uint4*>(s);
    } else {
      __align__(16) bf16 e[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        e[k] = c + k < lim ? s[k] : __float2bfloat16_rn(0.f);
      v[i] = *reinterpret_cast<const uint4*>(e);
    }
  }
}

__device__ __forceinline__ void dw_store(bf16* dst, const uint4 (&v)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * NTHREAD;
    *reinterpret_cast<uint4*>(dst + (idx >> 4) * DW_LD + (idx & 15) * 8) = v[i];
  }
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__global__ void __launch_bounds__(NTHREAD)
dw_kernel(const DwJobs jobs, int np) {
  __shared__ __align__(16) bf16 As[DW_TK * DW_LD];   // [point][m]
  __shared__ __align__(16) bf16 Gs[DW_TK * DW_LD];   // [point][n]
  int ji = 0;
  while (ji + 1 < jobs.njobs && (int)blockIdx.x >= jobs.first_tile[ji + 1]) ++ji;
  const DwJob jb = jobs.job[ji];
  const int tiles_n = (jb.ncols + DW_TN - 1) / DW_TN;
  const int tile = blockIdx.x - jobs.first_tile[ji];
  const int m0 = (tile / tiles_n) * DW_TM, n0 = (tile % tiles_n) * DW_TN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  // ldmatrix row addresses: matrix lane >> 3, row lane & 7
  const int mat = lane >> 3, r8 = lane & 7;
  const int a_k = r8 + ((mat >> 1) << 3), a_m = (mat & 1) << 3;
  const int b_k = r8 + ((mat & 1) << 3), b_n = (mat >> 1) << 3;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  uint4 va[2], vg[2];
  dw_load(va, jb.a, jb.lda, jb.m, m0, 0);
  dw_load(vg, jb.g, jb.ldg, jb.ncols, n0, 0);
  for (int k0 = 0; k0 < np; k0 += DW_TK) {
    dw_store(As, va);
    dw_store(Gs, vg);
    __syncthreads();
    if (k0 + DW_TK < np) {
      dw_load(va, jb.a, jb.lda, jb.m, m0, k0 + DW_TK);
      dw_load(vg, jb.g, jb.ldg, jb.ncols, n0, k0 + DW_TK);
    }
#pragma unroll
    for (int kk = 0; kk < DW_TK; kk += 16) {
      uint32_t b[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4_t(b[nj], Gs + (kk + b_k) * DW_LD + wn + nj * 16 + b_n);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t a[4];
        ldsm_x4_t(a, As + (kk + a_k) * DW_LD + wm + mi * 16 + a_m);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          mma_bf16(acc[mi][2 * nj], a, b[nj][0], b[nj][1]);
          mma_bf16(acc[mi][2 * nj + 1], a, b[nj][2], b[nj][3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn + nt * 8 + 2 * q + (e & 1);
        if (row < jb.m && col < jb.ncols)
          jb.out[(size_t)row * jb.ncols + col] = acc[mi][nt][e];
      }
}

void add_job(DwJobs& js, int& tiles, const bf16* a, int lda, int m,
             const bf16* g, int ldg, int ncols, float* out) {
  DwJob& jb = js.job[js.njobs];
  jb.a = a;
  jb.g = g;
  jb.out = out;
  jb.lda = lda;
  jb.m = m;
  jb.ldg = ldg;
  jb.ncols = ncols;
  js.first_tile[js.njobs] = tiles;
  tiles += ((m + DW_TM - 1) / DW_TM) * ((ncols + DW_TN - 1) / DW_TN);
  ++js.njobs;
  js.first_tile[js.njobs] = tiles;
}

// The bias and weight gradients of `nnet` nets from a filled workspace:
// db (nnet, BSZ), dw (nnet, WGSZ).  Returns the first launch error.
cudaError_t launch_grads(const Work& wk, int nnet, float* dw, float* db,
                         int np, cudaStream_t st) {
  bias_kernel<<<(nnet * BSZ + 255) / 256, 256, 0, st>>>(wk, db, np / T, nnet);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  DwJobs js{};
  int tiles = 0;
  for (int k = 0; k < nnet; ++k) {
    float* o = dw + (size_t)k * WGSZ;
    const bf16* act = wk.act[k];
    const bf16* gp = wk.gp[k];
    const int LA = DEPTH * W;
    add_job(js, tiles, wk.x, DX, DX, gp, LA, W, o);
    for (int i = 1; i < DEPTH; ++i)
      add_job(js, tiles, act + (i - 1) * W, LA, W, gp + i * W, LA, W,
              o + off_h(i));
    add_job(js, tiles, wk.x, DX, DX, gp + (SKIP + 1) * W, LA, W,
            o + OFF_SKIPX);
    add_job(js, tiles, act + (DEPTH - 1) * W, LA, W, wk.gs[k] + 3, NGS, 1,
            o + G_A);
    add_job(js, tiles, act + (DEPTH - 1) * W, LA, W, wk.gf[k], W, W, o + G_F);
    add_job(js, tiles, wk.feat[k], W, W, wk.ghv[k], HV, HV, o + G_VF);
    add_job(js, tiles, wk.xv[k], DXV, DXV, wk.ghv[k], HV, HV, o + G_VX);
    add_job(js, tiles, wk.hv[k], HV, HV, wk.gs[k], NGS, 3, o + G_R);
  }
  dw_kernel<<<tiles, NTHREAD, 0, st>>>(js, np);
  return cudaGetLastError();
}

}  // namespace
