// Device code shared by the radiance-MLP kernels (encmlp_fwd.cu: K1,
// K2; encmlp_bwd.cu: K3, K4; mlp_fwd.cu: K5; mlp_bwd.cu: K6): the
// compiled shape, the packed weight layout, the mma.sync product and its
// epilogue (the backward's), the in-block encode (K1-K4) and the loader
// of split input parts (K5, K6).  The weight ring is in ring.cuh, the
// forward's MLP body in mlp_fwd_common.cuh.  Each .cu file includes it
// once; everything here has internal linkage.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// The encode's shape (K1-K4, K-vf1/K-vf2): J joints, NF kp bands 2^0 ..
// 2^(NF-1), NB view PE rows (1 + 2 multires_views), the bone directions
// windowed (--cutoff_bones) or not.  The flagship's by default; a build
// per shape takes NF 1-13 and NB 1-21 (nvcc -DANERF_NF=... -DANERF_NB=...
// -DANERF_BONE_WIN=0|1, with -DANERF_DX the trunk width DV + C3,
// -DANERF_DEPTH, -DANERF_WIDTH and -DANERF_NCODE; ops/cuda_build.py,
// fused_encmlp.kernel_shape); the headers' and the sources'
// static_asserts refuse the rest.  K5/K6 ignore all three.
#ifndef ANERF_NF
#define ANERF_NF 7
#endif
#ifndef ANERF_NB
#define ANERF_NB 9
#endif
#ifndef ANERF_BONE_WIN
#define ANERF_BONE_WIN 0
#endif
constexpr int J = 24;
constexpr int NF = ANERF_NF;           // kp bands: 7 (2^0 .. 2^6)
constexpr int NB = ANERF_NB;           // view PE rows: 9 (1 + 2 x 4)
constexpr bool BONE_WIN = ANERF_BONE_WIN != 0;  // r = p / d x window
static_assert(NF >= 1 && NB >= 1 && NB % 2 == 1, "kp bands and view rows");
// The bands come from anerf_tpu's double-angle recurrence (encode_points),
// which doubles its f32 rounding with each band: past F_MAX bands it no
// longer holds to the model, and the plain encode's exact sines take the
// shape (fused_encmlp.F_MAX, ROADMAP C.17).
constexpr int F_MAX = 13;
static_assert(NF <= F_MAX,
              "at most 13 kp bands: past them anerf_tpu's band recurrence "
              "no longer holds to the model");
static_assert(NB <= 21, "at most 21 view PE rows (multires_views 10)");
constexpr int C3 = 3 * J;              // 72
constexpr int DV = (2 * NF + 1) * J;   // 360 kp encoding
// the trunk input [v | r]: DV + C3 (432) wide for K1-K4; a K5/K6 build
// takes any width from 1 to 4096 (nvcc -DANERF_DX=...; ops/cuda_build.py)
#ifndef ANERF_DX
#define ANERF_DX 432
#endif
constexpr int DX = ANERF_DX;
static_assert(DX >= 1 && DX <= 4096, "trunk inputs of 1 to 4096 columns");
// X's columns and the weight rows that meet them, padded with zeros to
// the 16-deep k-step of a product
constexpr int DXP = (DX + 15) / 16 * 16;
constexpr int DE = NB * C3;            // 648 view encoding
// the framecodes' columns of the views input: K1-K4 take codes of 16 to
// 128 columns, narrower ones zero-padded to the next multiple of 16
// (nvcc -DANERF_NCODE=..., 16 by default), so that the views input stays
// whole k-steps: 72 NB is 8 past a multiple of 16 for every odd NB
#ifndef ANERF_NCODE
#define ANERF_NCODE 16
#endif
constexpr int NCODE = ANERF_NCODE;
static_assert(NCODE >= 16 && NCODE <= 128 && NCODE % 16 == 0,
              "framecodes of 16 to 128 columns, in whole k-steps");
// the views input [xv | codes | 0 x 8]: K1-K4's 72 NB + NCODE + 8 (672
// at the flagship's shape); K5/K6 are built for a views width of their
// own (nvcc -DANERF_DXV=...: 672 for any views parts up to it, else the
// parts' sum + 8 rounded up to 16; ops/fused_mlp.py), at most 4096
#ifdef ANERF_DXV
constexpr int DXV = ANERF_DXV;
#else
constexpr int DXV = DE + NCODE + 8;
#endif
static_assert(DXV % 16 == 0 && DXV <= 4096,
              "the views input in whole k-steps, at most 4096 columns");
// viewfac's codes k-slice (K1-K4): the views input's columns VF_KB ..
// DXV - 1, [0 x 8 | codes | 0 x 8], NCODE + 16 wide: it starts on the
// last 8 view columns (masked to zeros), since DE is 8 past a k-step
constexpr int VF_KB = DE - 8;
constexpr int VF_CW = NCODE + 16;

// the net: DEPTH trunk layers of W units, the views layer HV = W / 2
// wide, layer SKIP + 1 taking [h, x] where it exists.  K1-K4 are built
// for 1-16 layers of any W that is a multiple of 256 up to 2048 (8 x 256
// by default; fused_encmlp.kernel_shape admits the depths); a K5/K6
// build takes any depth from 1 to 128 and any W that is a multiple of
// 256 up to 4096, depth x W up to 262,144 (64 x 4096, 128 x 2048: past
// that K6's workspace for the train step's 131,072 points outgrows the
// card; nvcc -DANERF_DEPTH=... -DANERF_WIDTH=... -DANERF_SKIP=...;
// ops/cuda_build.py), other nets padded with zeros to the next multiple
// of 256 (ops/fused_mlp.py).  A net past 512 wide is WIDE: its
// activations do not fit a block's shared memory, so they live in device
// memory (L2) and each product reads its A operand back XCH columns at
// a time.
#ifndef ANERF_DEPTH
#define ANERF_DEPTH 8
#endif
#ifndef ANERF_WIDTH
#define ANERF_WIDTH 256
#endif
#ifndef ANERF_SKIP
#define ANERF_SKIP 4
#endif
constexpr int W = ANERF_WIDTH;
constexpr int HV = W / 2;
constexpr int DEPTH = ANERF_DEPTH;
constexpr int SKIP = ANERF_SKIP;       // layer SKIP+1 consumes [h, x]
constexpr bool HAS_SKIP = SKIP >= 0 && SKIP + 1 < DEPTH;
static_assert(W % 256 == 0 && W >= 256 && W <= 4096,
              "nets a multiple of 256 wide, up to 4096");
static_assert(DEPTH >= 1 && DEPTH <= 128, "1 to 128 trunk layers");
static_assert(DEPTH * W <= 262144, "at most depth x width = 262,144");
#define ANERF_WIDE (ANERF_WIDTH > 512)
constexpr bool WIDE = ANERF_WIDE;
constexpr int SMEM_MAX = 232448;       // a block's shared memory
// a product's output rows a block: a ring stage's 256 weight rows, so
// a 512-wide layer is two blocks over the same A operand
constexpr int WB = 256;
constexpr int NBLK = W / WB;
constexpr int T = 64;                  // points per block
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
// the shared memory a kernel adds after its MLP body's own, counted
// where the headers decide what stays resident beside the ring
// (mlp_fwd_common.cuh FWD_XV_RESIDENT, FWD_X_RESIDENT, mlp_bwd_common.cuh
// MASK_RESIDENT, BWD_X_RESIDENT): K1-K4 (whose sources define ANERF_ENC_KERNEL before
// they include a header) keep the tile's windows (T, J) f32 and
// viewfac's ray slots (T), 6,400 bytes; K5/K6 nothing
#ifdef ANERF_ENC_KERNEL
constexpr bool ENC_KERNEL = true;
constexpr size_t SMEM_ADD = sizeof(float) * T * J + sizeof(int) * T;
#else
constexpr bool ENC_KERNEL = false;
constexpr size_t SMEM_ADD = 0;
#endif
// K1-K4 keep the nets they were built for before K5/K6's went past them,
// and stop at the depths where their deep builds' per-tile sums were
// held to the f64 rule (fused_encmlp.KERNEL_DEPTH, KERNEL_WIDE_DEPTH)
static_assert(!ENC_KERNEL || W <= 2048,
              "nets a multiple of 256 wide, up to 2048");
static_assert(!ENC_KERNEL || DEPTH <= (W == 256 ? 32 : W == 512 ? 24 : 16),
              "1 to 32 trunk layers at 256 wide, 1 to 24 at 512, 1 to 16 "
              "wider");
// K1-K4's deep builds, more than 8 trunk layers: their products' sums
// reach the accumulators rounded to nearest (mlp_fwd_common.cuh FWD_RN,
// mlp_bwd_common.cuh ACC_REC), which holds them to an f64 evaluation of
// the chain from the encode's own f32 bands (chip_smoke._check_close_f64,
// _check_bwd_f64) where the chain's sums miss it (16 x 512 already);
// every other build, K5/K6's all, keeps the sums and the bits it had.
constexpr bool ENC_DEEP = ENC_KERNEL && DEPTH > 8;

// shared-memory row strides in bf16 elements: rows stay 16-byte
// aligned and the +8 spreads the fragment loads over all 32 banks
constexpr int LDX = DXP + 8;
constexpr int LDXV = DXV + 8;
constexpr int LDH = W + 8;
// a trunk input too wide to stay in shared memory (K5 past 592 columns,
// K6 past 480), a views input too wide for the forward's (K1/K2 past 11
// view rows, K5 past 832 columns), and a WIDE net's activations, take
// part in their products XCH columns at a time, through a buffer of
// stride LDC
constexpr int XCH = 256;
constexpr int LDC = XCH + 8;

// packed weights (bf16, each matrix transposed to (out, in)); the layout
// anerf_torch/ops/fused_encmlp.py::_pack_kernel_weights writes
constexpr size_t SZ_X = (size_t)W * DXP;
constexpr size_t SZ_H = (size_t)W * W;
__host__ __device__ constexpr size_t off_h(int i) {  // trunk layer i >= 1
  return SZ_X + (size_t)(i - 1) * SZ_H +
         (HAS_SKIP && i > SKIP + 1 ? SZ_X : 0);
}
// layer SKIP+1's [v | r] part (where HAS_SKIP)
constexpr size_t OFF_SKIPX = SZ_X + (size_t)(SKIP + 1) * SZ_H;
constexpr size_t OFF_F =
    SZ_X + (size_t)(DEPTH - 1) * SZ_H + (HAS_SKIP ? SZ_X : 0);
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

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 r;
  uint32_t* w = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    w[q] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return r;
}

// (x^2 + y^2) + z^2, each operation rounded on its own (no fused
// multiply-add), as the plain twin's PyTorch operations round it: every
// kernel that takes a point's distance (the forward's encode, the
// backward's recompute and its pullback) gets the twin's bits, whatever
// ptxas would fuse in its own context.
__device__ __forceinline__ float dist2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// One step of the bands' double-angle recurrence, sin 2a = (2 sin a) cos a
// and cos 2a = 1 - (2 sin a) sin a, each operation rounded on its own in
// the twin's order (fused_encmlp._encode_fwd_res).  Each band doubles the
// last one's rounding, so a contracted 1 - 2 s^2 (nvcc's default) parts
// from the twin by whole bf16 steps a few bands past 10.
__device__ __forceinline__ void double_angle(float& s, float& c) {
  const float s2 = __fmul_rn(2.f, s);
  const float c2 = __fsub_rn(1.f, __fmul_rn(s2, s));
  s = __fmul_rn(s2, c);
  c = c2;
}

// The skeleton-relative coordinates (x, y, z) of point gp at joint j.
// Dense: p is the component-major points (n, 3J).  TF (the in-kernel rigid
// transform, anerf_tpu's fuse_tform): p is the sample depths (n = R S) and
// tfab the per-ray affine rows (R, 2, 3J) [A; B] (fused_encmlp.tform_rows),
// so the point is A + z B of its ray gp / S, the way pallas_encmlp.
// _apply_tform builds it.  The product and the sum are rounded one by one
// (no FMA contraction, which nvcc would make or not by context): the
// forward, the backward's recompute and its pullback build the same bits,
// and so does the plain twin's A + z * B.
template <bool TF>
__device__ __forceinline__ void load_point(const float* __restrict__ p,
                                           const float* __restrict__ tfab,
                                           int gp, int j, int S, float& x,
                                           float& y, float& z) {
  if constexpr (TF) {
    const float zz = __ldg(p + gp);
    const float* ab = tfab + (size_t)(gp / S) * 2 * C3 + j;
    x = __fadd_rn(__ldg(ab), __fmul_rn(zz, __ldg(ab + C3)));
    y = __fadd_rn(__ldg(ab + J), __fmul_rn(zz, __ldg(ab + C3 + J)));
    z = __fadd_rn(__ldg(ab + 2 * J), __fmul_rn(zz, __ldg(ab + C3 + 2 * J)));
  } else {
    const float* pp = p + (size_t)gp * C3;
    x = __ldg(pp + j);
    y = __ldg(pp + J + j);
    z = __ldg(pp + 2 * J + j);
  }
}

// The encode of points t0 .. t0+T-1: X = [v | r] (bf16; BONE_WIN: r
// times the window, as pallas_encmlp._encode_fwd_res under
// bone_windowed), T rows of stride ldx, in shared memory where the
// trunk input stays resident (sm.X, LDX) or else the tile's rows of
// device memory (DXP), and WIN = the windows (f32, shared memory).
// Points past n encode as p = 0.
// TF: the points from depths and affine rows (load_point).  Leaves the
// block unsynchronised.
template <bool TF>
__device__ __forceinline__ void encode_points(const float* __restrict__ p,
                                              const float* __restrict__ tfab,
                                              const float* __restrict__ cutoff,
                                              float tau, bf16* X, int ldx,
                                              float* WIN, int t0, int n,
                                              int S) {
  const int tid = threadIdx.x;
  // ---- encode: distances, windows, kp PE (double-angle recurrence),
  // bone directions -------------------------------------------------------
  for (int idx = tid; idx < T * J; idx += NTHREAD) {
    const int t = idx / J, j = idx - t * J, gp = t0 + t;
    float x = 0.f, y = 0.f, z = 0.f;
    if (gp < n) load_point<TF>(p, tfab, gp, j, S, x, y, z);
    const float d = sqrtf(dist2(x, y, z));
    const float w = 1.f - 1.f / (1.f + expf(-tau * (d - __ldg(cutoff + j))));
    bf16* xr = X + t * ldx;
    xr[j] = __float2bfloat16_rn(d * w);
    float s = sinf(d), c = sinf(d + 1.57079632679489662f);
    xr[J + j] = __float2bfloat16_rn(s * w);
    xr[2 * J + j] = __float2bfloat16_rn(c * w);
#pragma unroll
    for (int k = 1; k < NF; ++k) {
      double_angle(s, c);
      xr[(1 + 2 * k) * J + j] = __float2bfloat16_rn(s * w);
      xr[(2 + 2 * k) * J + j] = __float2bfloat16_rn(c * w);
    }
    const float invd = 1.f / fmaxf(d, 1e-12f);
    float rx = x * invd, ry = y * invd, rz = z * invd;
    if constexpr (BONE_WIN) {  // the windowed bone encoding
      rx *= w;
      ry *= w;
      rz *= w;
    }
    xr[DV + j] = __float2bfloat16_rn(rx);
    xr[DV + J + j] = __float2bfloat16_rn(ry);
    xr[DV + 2 * J + j] = __float2bfloat16_rn(rz);
    WIN[t * J + j] = w;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// ---- viewfac (K1-K4): the views input factorized per ray -----------------
// The view rows are constant along a ray, so the views layer's
// views-input product xv @ Wvx equals xw @ M (pallas_mlp.viewfac_operand,
// _viewfac_dot): M[r, j, :] = sum_b bf16(enc[r, b J + j]) Wvx[b J + j, :]
// rounded to bf16, a (J, HV) matrix a ray and net built once before the
// kernel (viewfac.cu), and xw[t, (k, j)] = bf16(w[t, j]) where point t
// lies on the tile's k-th ray, else 0.  A 64-point tile touches at most
// VFR rays at S >= 32 (the cost gate takes viewfac only there), so the
// product is 64 x VFK x HV, VFK = VFR J padded to the 16-deep k-step,
// on mma.sync, both operands staged in shared memory (vf_stage): M's
// rows of the tile's rays, from device memory (L2), and xw, from the
// tile's windows.  Up to 512 wide a staging holds all HV columns of M;
// WIDE the views layer runs in blocks of 128 outputs (mlp_fwd_common.cuh
// VB, mlp_bwd_common.cuh VXR) and a staging holds one block's columns
// (VF_MC), staged again for each block.
constexpr int VFR = 3;
constexpr int VFK = (VFR * J + 15) / 16 * 16;
constexpr int VF_MC = WIDE ? 128 : HV;   // the staged columns of M
constexpr int VF_LDM = VF_MC + 8; // the staged M's row stride (bf16)
constexpr int VF_LDW = VFK + 8;   // the staged xw's
constexpr int VF_STAGE = VFK * VF_LDM + T * VF_LDW;  // bf16 of a staging

struct VfTile {
  const float* win;   // the tile's windows (T, J), shared memory
  const int* slot;    // each point's ray less r0, -1 past n (vf_slots)
  const bf16* M;      // this net's M (R, J, HV), device memory
  int r0, nr;         // the tile's first ray and its rays' count
};

// slot[t] = the ray of point t0 + t less the tile's first, -1 past n:
// written by threads 0 .. T-1, read after the consumers' next barrier
__device__ __forceinline__ void vf_slots(int* slot, int t0, int n, int S) {
  const int t = threadIdx.x;
  if (t < T) slot[t] = t0 + t < n ? (t0 + t) / S - t0 / S : -1;
}

__device__ __forceinline__ VfTile vf_tile(const float* win, const int* slot,
                                          const bf16* M, int t0, int n,
                                          int S) {
  VfTile v;
  v.win = win;
  v.slot = slot;
  v.M = M;
  v.r0 = t0 / S;
  v.nr = (min(t0 + T, n) - 1) / S - v.r0 + 1;
  return v;
}

// bf16 bits of xw[t, k] (0 off point t's ray and past VFR J)
__device__ __forceinline__ uint32_t vf_xw(const VfTile& v, int t, int k) {
  const int kr = k / J;
  if (v.slot[t] != kr) return 0u;
  return __bfloat16_as_ushort(__float2bfloat16_rn(v.win[t * J + k - kr * J]));
}

// buf (VF_STAGE bf16, 16-byte aligned) = MS (VFK, VF_LDM): row k the
// columns c0 .. c0 + VF_MC - 1 of row k % J of M of the tile's ray k / J,
// zeros past its rays; then XW (T, VF_LDW): xw.  Run by the consumer
// warps; the caller synchronises them before the products read it.
__device__ __forceinline__ void vf_stage(bf16* buf, const VfTile& v,
                                         int c0 = 0) {
  static_assert(VF_MC % 8 == 0 && VF_LDM % 8 == 0 && HV % VF_MC == 0,
                "16-byte rows of M");
  constexpr int C8 = VF_MC / 8, NL = (VFK * C8 + NTHREAD - 1) / NTHREAD;
  uint4 val[NL];   // every load in flight before the first store
#pragma unroll
  for (int u = 0; u < NL; ++u) {
    const int idx = threadIdx.x + u * NTHREAD, k = idx / C8, kr = k / J;
    const bool on = idx < VFK * C8 && kr < v.nr;
    val[u] = *reinterpret_cast<const uint4*>(
        v.M + (on ? ((size_t)(v.r0 + kr) * J + (k - kr * J)) * HV + c0 +
                        (idx - k * C8) * 8
                  : (size_t)v.r0 * J * HV));
    if (!on) val[u] = make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < NL; ++u) {
    const int idx = threadIdx.x + u * NTHREAD, k = idx / C8;
    if (idx < VFK * C8)
      *reinterpret_cast<uint4*>(buf + k * VF_LDM + (idx - k * C8) * 8) =
          val[u];
  }
  bf16* xw = buf + VFK * VF_LDM;
  for (int idx = threadIdx.x; idx < T * VFK / 2; idx += NTHREAD) {
    const int t = idx / (VFK / 2), k = (idx - t * (VFK / 2)) * 2;
    *reinterpret_cast<uint32_t*>(xw + t * VF_LDW + k) =
        vf_xw(v, t, k) | vf_xw(v, t, k + 1) << 16;
  }
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d[j] += xw[m0 .. m0+15, :] @ M[:, n0 + 8 j .. n0 + 8 j + 7] for j < NJ
// (NJ even) from a staging: mma.m16n8k16 accumulators (rows m0 + lane /
// 4 (+8), columns n0 + 8 j + 2 (lane % 4) (+1)), as this warp holds them
// in both the forward's wgmma layout and the backward's mma.sync one
template <int NJ>
__device__ __forceinline__ void vf_xw_m(float (&d)[NJ][4], const bf16* buf,
                                        int m0, int n0) {
  static_assert(NJ % 2 == 0, "n-tiles in pairs");
  const int lane = threadIdx.x & 31, mat = lane >> 3, r8 = lane & 7;
  const bf16* xw = buf + VFK * VF_LDM;
#pragma unroll
  for (int ks = 0; ks < VFK / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, xw + (m0 + (lane & 15)) * VF_LDW + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      uint32_t b[4];   // M rows 16 ks .. (k), columns n0 + 16 jp .. (n)
      ldsm_x4_t(b, buf + (ks * 16 + r8 + ((mat & 1) << 3)) * VF_LDM + n0 +
                       jp * 16 + ((mat >> 1) << 3));
      mma_bf16(d[2 * jp], a, b[0], b[1]);
      mma_bf16(d[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// XV[:, 0:VF_CW] = the views input's codes k-slice [0 x 8 | codes | 0 x
// 8] (columns VF_KB .. DXV - 1; XV: T rows, stride ld), viewfac's only
// views-input columns beside xw
__device__ __forceinline__ void write_vf_codes(bf16* XV, int ld,
                                               const float* __restrict__ codes,
                                               int t0, int n, int S) {
  static_assert(VF_KB % 8 == 0 && VF_KB + 8 == DE && VF_CW % 16 == 0,
                "the codes' k-slice");
  constexpr int PER_ROW = VF_CW / 8;
  for (int idx = threadIdx.x; idx < T * PER_ROW; idx += NTHREAD) {
    const int t = idx / PER_ROW, c = (idx - t * PER_ROW) * 8, gp = t0 + t;
    float v[8] = {};
    if (c >= 8 && c < 8 + NCODE && gp < n) {
      const float* cr = codes + (size_t)(gp / S) * NCODE + c - 8;
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = __ldg(cr + q);
    }
    *reinterpret_cast<uint4*>(XV + t * ld + c) = pack8(v);
  }
}

// The views input [view rows x window | codes | 0 x 8] of the tile, or
// its columns c0 .. c1-1 (multiples of 8; where it does not stay in the
// forward's shared memory, K1/K2 build it a column block at a time:
// mlp_fwd_common.cuh FWD_XV_RESIDENT), into XV (T rows, stride ld,
// 16-byte aligned rows in shared or device memory), 8 values a store:
// the view rows times each sample's windows (xv[t, c] = enc[ray, c]
// w[t, c % J], WIN f32 in shared memory), this net's codes, zeros past
// them and past n.  Leaves the block unsynchronised.
struct XvEnc {
  const float* enc;     // the view rows (R, DE)
  const float* win;     // the tile's windows (T, J), shared memory
  const float* codes;   // this net's codes (R, NCODE)
  int S;
};

__device__ __forceinline__ void encode_views(const XvEnc& xe, bf16* XV,
                                             int ld, int c0, int c1, int t0,
                                             int n) {
  static_assert(DE % 8 == 0 && J % 8 == 0 && NCODE % 8 == 0 &&
                    DXV - DE - NCODE >= 8,
                "8-value pieces of the views input");
  const int per_row = (c1 - c0) / 8;
  for (int idx = threadIdx.x; idx < T * per_row; idx += NTHREAD) {
    const int t = idx / per_row, cc = (idx - t * per_row) * 8, c = c0 + cc;
    const int gp = t0 + t;
    float v[8] = {};
    if (gp < n && c < DE) {
      const float* er = xe.enc + (size_t)(gp / xe.S) * DE + c;
      const float* wr = xe.win + t * J + c % J;  // c % J + 7 < J
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = __ldg(er + q) * wr[q];
    } else if (gp < n && c < DE + NCODE) {
      const float* cr = xe.codes + (size_t)(gp / xe.S) * NCODE + c - DE;
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = __ldg(cr + q);
    }
    *reinterpret_cast<uint4*>(XV + t * ld + cc) = pack8(v);
  }
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

// dst[t, 0:c1-c0] = columns c0 .. c1-1 of the concatenated parts' rows
// t0 + t, zeros past the parts and past n: value by value, adjacent
// threads on adjacent columns of a row.  Leaves the block unsynchronised.
__device__ __forceinline__ void load_cols(const Parts& ps, bf16* dst, int ld,
                                          int c0, int c1, int t0, int n) {
  const int rows = min(T, n - t0);
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int k = 0; k < ps.count; ++k) {
    const int lo = max(c0, ps.off[k]), hi = min(c1, ps.off[k] + ps.w[k]);
    if (lo >= hi) continue;
    const int w = hi - lo, wk = ps.w[k];
    const bf16* __restrict__ src = reinterpret_cast<const bf16*>(ps.p[k]) +
                                   (size_t)t0 * wk + (lo - ps.off[k]);
    bf16* d = dst + (lo - c0);
    for (int idx = threadIdx.x; idx < T * w; idx += NTHREAD) {
      const int t = idx / w, c = idx - t * w;
      d[t * ld + c] = t < rows ? src[(size_t)t * wk + c] : zero;
    }
  }
  const int lo = max(c0, ps.total), pad = c1 - lo;
  for (int idx = threadIdx.x; idx < T * pad; idx += NTHREAD) {
    const int t = idx / pad;
    dst[t * ld + lo - c0 + idx - t * pad] = zero;
  }
}

}  // namespace
