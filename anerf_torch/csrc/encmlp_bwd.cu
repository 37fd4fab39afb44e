// Fused encode + radiance-MLP backward kernels for Hopper (sm_90a).
//
// Replaces the backward Pallas kernels of anerf_tpu/ops/pallas_encmlp.py:
//   encmlp_bwd       <- _fused_bwd / _bwd_kernel            (one net; K3)
//   encmlp_dual_bwd  <- _fused_dual_bwd / _bwd_kernel_dual  (coarse and
//                       fine nets on one encode; K4)
// at the shape of encmlp_common.cuh (the flagship's by default, or a
// build per static shape as K1/K2's, encmlp_fwd.cu).  Given the raw
// cotangent g (nnet, 4, n) they return dp (n, 72), denc (R, 72 NB: 648),
// dcodes (nnet, R, NCODE) and the f32 gradient of every weight and bias of
// each net.
//
// What the TPU kernel does that a Hopper block cannot, and the design:
//
// * The TPU sums the weight gradients across its in-order grid in VMEM.
//   Hopper blocks run in no order, so the work is split in passes, all
//   on one stream, none with atomics (deterministic run to run):
//   1. bwd_tile_kernel, one block per 64-point tile (8 warps and a
//      producer warp for the weight ring): the encode (the
//      forward's own device code, so the values are the forward's bit
//      for bit), then per net the forward recompute and the MLP backward
//      for the input cotangents (mlp_bwd_tile, mlp_bwd_common.cuh).  It
//      writes each layer's bf16 input and activation, each bf16
//      pre-activation cotangent, the f32 input cotangents of [v | r] and
//      [xv | codes], and per-tile bias partial sums of the f32
//      cotangents to a workspace (about 23 KB a point for two nets: 3 GB
//      at n = 131,072).
//   2. pullback_kernel, one thread per (point, joint): sums the nets'
//      input cotangents in f32, rounds them through bf16, and pulls them
//      back through the encode without transcendentals beyond the
//      forward's own (each band's derivative is its paired band) into dp.
//   3. denc_kernel, one thread per (ray, column): denc and dcodes sum
//      over the samples of a ray in a fixed order, so a ray may straddle
//      tiles and any (R, S) is taken.
//   4. bias_kernel: the bias gradients, the per-tile partials summed in
//      tile order.
//   5. dw_kernel and dw_sum_kernel: every weight gradient A^T G, bf16
//      operands on the tensor cores (mma.sync m16n8k16, f32
//      accumulators).  Each block owns one 128 x 128 tile of one weight
//      gradient and one slice of the points, walks it in order, 32
//      points at a time, through shared memory, and writes its f32
//      partial tile; the second kernel sums the slices' partials of each
//      element in slice order.  The 118 tiles of two nets alone would
//      leave the card's 132 SMs idle in turns; the slices fill them.
// * The TPU keeps every weight in VMEM across its grid.  A Hopper block
//   cannot (3.46 MB a net), so pass 1 streams both weight packs through a
//   5-stage ring of 32-deep k-slices in shared memory, each filled by one
//   TMA copy that a producer warp issues ahead across layers and nets
//   (mlp_bwd_common.cuh; the launcher encodes a tensor map per weight
//   block).  To make room for the ring, the views input goes from the
//   encode straight to the workspace, once per net with its codes, and
//   the views layer's forward reads it back through the ring; the ReLU
//   masks of the recompute stay in shared memory as bits.  Pass 1 holds
//   the ring (80 KB), X, two activation buffers, the masks, g and the
//   windows: 231,584 bytes with the ring's alignment and barriers at the
//   flagship's shape.  Where that does not fit (512 wide: a 3-stage
//   ring, two (64, 520) buffers; 9 layers or more; 8 kp bands or more),
//   the masks keep their bits in shared memory only where they fit
//   beside a 256-column buffer of X, else in the workspace
//   (MASK_RESIDENT), and X stays resident only where it then fits: else
//   the encode writes it straight to the workspace's copy, and the
//   products that read it (layer 0 and the skip layer of the recompute)
//   bring it back 256 columns at a time, each mma's sum added with
//   rounding (ring_mma_x, mlp_bwd_common.cuh), where the resident X's
//   chain adds into its accumulators.  Both choices count the windows
//   and slots (SMEM_ADD) and are constexpr: a shape that fits stays
//   resident with its bits.
// * WIDE nets (768-2048 wide): no activation buffer fits beside the
//   ring, so the per-tile pass is K6's WIDE body (mlp_bwd_tile_wide,
//   mlp_bwd_common.cuh): every bf16 activation and cotangent goes
//   straight to the workspace, where the next product reads its A
//   operand back 256 columns at a time, each mma's sum added with
//   rounding; the views layer's recompute runs in blocks of 128 outputs.
//   The workspace then holds (2 DEPTH + 2) W + 2 HV bf16 a net and point
//   beside the inputs' and cotangents' rows: 38.9 KB a net and point at
//   8 x 1024, 10.2 GB for K4 at n = 131,072 (offsets in size_t
//   throughout).  Under viewfac each views block stages its 128 columns
//   of M in the A operands' column buffer; the Gram pass walks HV in
//   blocks of 128 columns past 256.
// * viewfac (the view factorization, K4 on the flagship's coarse pass):
//   the per-tile pass recomputes the views layer from the codes' k-slice
//   and xw @ M and writes the codes' cotangent alone; the pullback adds
//   the window cotangent g_hv . M[ray] (both nets', f32) from g_hv in the
//   workspace, vf_gram_kernel forms each ray's xw^T g_hv (bf16: Gw),
//   denc_kernel takes the codes alone, the dW pass the codes' rows
//   alone, and K-vf2 (viewfac.cu) folds Gw into the views weight's view
//   rows and denc.  (Formed inside the per-tile pass, the two products
//   cost it ~0.8 ms at the flagship's train shapes, probed on the card.)  Of the views input the workspace holds
//   only the codes' k-slice.
// * TF (the in-kernel rigid transform, anerf_tpu's fuse_tform:
//   _bwd_kernel / _bwd_kernel_dual with _apply_tform): the per-tile pass
//   and the pullback read the depths z (R, S) and each ray's affine rows
//   [A; B] (R, 2, 72) in place of the points and build each point as
//   A + z B with the forward's own device code (load_point), so the
//   recompute's bits are the forward's.  dp (n, 72) is still written, as
//   the TPU kernel writes it: the wrapper contracts it into the depths'
//   and the rows' cotangents (fused_encmlp._tform_pullback), where
//   anerf_tpu's XLA does.
// * The stash: the TPU stashes the f32 PE bands because its wide sin was
//   the forward's largest VPU block.  Here the bands come from one sinf
//   pair and the double-angle recurrence, so passes 1 and 2 recompute
//   them from the same code, bit-identical to the forward's; no stash.
//
// Bound: recompute, input cotangents and weight gradients are 3x the
// forward's tensor-core work (~5.2 MFLOP a point and net), against a few
// KB of device traffic a point: operations bound both kernels at the
// card's peak.  Pass 1 re-reads both weight packs from L2 once per
// 64-point tile and net: ~14 GB of L2 reads per K4 call at n = 131,072,
// its floor at this tile size (a few ms at the L2's rate).  Weight reuse
// across tiles and wgmma on the ring are later work.
//
// The workspace, the ring, the per-tile MLP backward, the bias pass and
// the dW pass live in mlp_bwd_common.cuh, shared with K6 (mlp_bwd.cu).
//
// C interface (loaded with ctypes): every pointer is device memory, the
// stream is PyTorch's current stream; returns the first cudaError of
// the six launches.
#define ANERF_ENC_KERNEL  // the windows and slots count (SMEM_ADD)
#include "mlp_bwd_common.cuh"

static_assert(SKIP == 4, "K3/K4 take nets with the skip after layer 4");

namespace {

// + the windows (T, J) and viewfac's ray slots (T)
constexpr size_t SMEM_BWD = SMEM_TILE + SMEM_ADD;
static_assert(SMEM_BWD <= 232448, "a block takes at most 227 KB");
static_assert(DX == DV + C3 && DXP == DX,
              "K3/K4 encode the trunk input [v | r], a whole k-step wide");

// tfab last, as in encmlp_fwd.cu, here and in the pullback
template <int NNET, bool VF, bool TF>
__global__ void __launch_bounds__(NTHREAD + 32, 1)
bwd_tile_kernel(const float* __restrict__ p, const float* __restrict__ enc,
                const float* __restrict__ codes,
                const float* __restrict__ cutoff,
                const float* __restrict__ tau_ptr,
                const bf16* __restrict__ wback,
                const float* __restrict__ bpack, const float* __restrict__ gin,
                Work wk, const __grid_constant__ Maps<NNET> maps, int n, int S,
                int R, const float* __restrict__ tfab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem sm = tile_smem(smem);
  float* WIN = sm.end;                        // windows (T, J)
  int* SLOT = reinterpret_cast<int*>(WIN + T * J);

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * T;
  Ring<BwdSchedT<VF>> rg = ring_open<BwdSchedT<VF>>(
      sm.ring, sm.bars, &maps.seg[0][0], maps.xv, NNET, t0);
  if (tid >= NTHREAD) {  // the producer warp; the first weight slices
    ring_produce(rg);    // arrive while the tile encodes
    return;
  }

  const float tau = __ldg(tau_ptr);
  // X in shared memory, copied to the workspace for the dW pass below,
  // or straight into the workspace, where the recompute's products read
  // it back after the barrier below orders the stores (ring_mma_x)
  bf16* xg = wk.x + (size_t)t0 * DXP;
  encode_points<TF>(p, tfab, cutoff, tau, BWD_X_RESIDENT ? sm.X : xg,
                    BWD_X_RESIDENT ? LDX : DXP, WIN, t0, n, S);
  if constexpr (VF) vf_slots(SLOT, t0, n, S);
  sync_tile();
  for (int net = 0; net < NNET; ++net) {
    bf16* xv = wk.xv[net] + (size_t)t0 * DXV;
    const float* cn = codes + (size_t)net * R * NCODE;
    if constexpr (VF) {  // the codes' k-slice alone
      write_vf_codes(xv + VF_KB, DXV, cn, t0, n, S);
    } else {
      encode_views(XvEnc{enc, WIN, cn, S}, xv, DXV, 0, DXV, t0, n);
    }
  }
  fence_async_global();  // the ring reads the views input back by TMA
  if constexpr (BWD_X_RESIDENT) copy_rows(xg, DXP, sm.X, LDX, DXP);

  for (int net = 0; net < NNET; ++net) {
    // g of this net; the pass reads it after its first stage's barrier,
    // and the last net's pass stopped reading it many barriers ago
    for (int idx = tid; idx < T * 4; idx += NTHREAD) {
      const int t = idx >> 2, c = idx & 3, gpt = t0 + t;
      sm.gsm[idx] = gpt < n ? __ldg(gin + ((size_t)net * 4 + c) * n + gpt) : 0.f;
    }
    const VfTile vf = vf_tile(WIN, SLOT, wk.vfM[net], t0, n, S);
#if ANERF_WIDE
    mlp_bwd_tile_wide<VF>(rg, sm, wback + (size_t)net * WGSZ,
                          bpack + (size_t)net * BSZ, wk, net, t0, xg, &vf);
#else
    mlp_bwd_tile<VF>(rg, sm, wback + (size_t)net * WGSZ,
                     bpack + (size_t)net * BSZ, wk, net, t0, xg, &vf);
#endif
  }
}

// dp: one thread per (point, joint).  VF: the views input's part of the
// window cotangent is g_hv . M[ray, j] of each net (the block fold of
// pallas_mlp._viewfac_bwd's g_hv M^T), the nets' added in f32.  TF: the
// point from its depth and its ray's affine rows (load_point).
// BONE_WIN: r = p / d x w, so the bone part's cotangent takes its share
// of the window's (pallas_encmlp._encode_pullback under bone_windowed).
template <int NNET, bool VF, bool TF>
__global__ void pullback_kernel(const float* __restrict__ p,
                                const float* __restrict__ enc,
                                const float* __restrict__ cutoff,
                                const float* __restrict__ tau_ptr, Work wk,
                                float* __restrict__ dp, int n, int S,
                                const float* __restrict__ tfab) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * J) return;
  const int gp = idx / J, j = idx - gp * J;
  const float tau = __ldg(tau_ptr);
  float x, y, z;
  load_point<TF>(p, tfab, gp, j, S, x, y, z);
  const float d = sqrtf(dist2(x, y, z));
  const float w = 1.f - 1.f / (1.f + expf(-tau * (d - __ldg(cutoff + j))));
  wk.win[(size_t)gp * J + j] = w;
  const float invd = 1.f / fmaxf(d, 1e-12f);

  auto gx = [&](int col) {
    float v = wk.gx[0][(size_t)gp * DX + col];
    if (NNET == 2) v += wk.gx[1][(size_t)gp * DX + col];
    return bf16r(v);
  };
  // v = [d | s0 c0 s1 c1 ...] * w
  float s = sinf(d), c = sinf(d + 1.57079632679489662f);
  float gv = gx(j);
  float g_w = gv * d;
  float g_dists = gv * w;
  float bandsum = 0.f;
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    if (k > 0) double_angle(s, c);
    const float f = ldexpf(1.f, k);   // 2^k, exact
    const float gs = gx((1 + 2 * k) * J + j), gc = gx((2 + 2 * k) * J + j);
    g_w += gs * s;
    g_w += gc * c;
    bandsum += gs * w * f * c;      // d sin(f d) = f cos(f d)
    bandsum += gc * w * (-f) * s;   // d cos(f d) = -f sin(f d)
  }
  g_dists += bandsum;
  // r = p / d (BONE_WIN: x w)
  const float pc[3] = {x, y, z};
  float gr[3], g_invd = 0.f;
  [[maybe_unused]] float g_wb = 0.f;  // the bone part's window cotangent
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gr[k] = gx(DV + k * J + j);
    if constexpr (BONE_WIN) {
      g_wb += gr[k] * pc[k] * invd;
      g_invd += gr[k] * pc[k] * w;
    } else {
      g_invd += gr[k] * pc[k];
    }
  }
  if constexpr (BONE_WIN) g_w += g_wb;
  g_dists -= g_invd * (invd * invd) * (d > 1e-12f ? 1.f : 0.f);
  // xv = enc[ray] * w
  if constexpr (VF) {
    float dw = 0.f;
#pragma unroll
    for (int net = 0; net < NNET; ++net) {
      const uint4* gr =
          reinterpret_cast<const uint4*>(wk.ghv[net] + (size_t)gp * HV);
      const uint4* mr = reinterpret_cast<const uint4*>(
          wk.vfM[net] + ((size_t)(gp / S) * J + j) * HV);
      float sum = 0.f;
#pragma unroll 4
      for (int c = 0; c < HV / 8; ++c) {
        const uint4 gv = gr[c], mv = __ldg(mr + c);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          sum += __bfloat162float(bf16_of(gv, q)) *
                 __bfloat162float(bf16_of(mv, q));
      }
      dw = net ? dw + sum : sum;
    }
    g_w += dw;
  } else {
    const float* er = enc + (size_t)(gp / S) * DE;
    float g_wv = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float sb = 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int col = b * C3 + k * J + j;
        float v = wk.gxv[0][(size_t)gp * DXV + col];
        if (NNET == 2) v += wk.gxv[1][(size_t)gp * DXV + col];
        sb += bf16r(v) * __ldg(er + col);
      }
      g_wv += sb;
    }
    g_w += g_wv;
  }
  g_dists -= g_w * (tau * (1.f - w) * w);
  const float gd = g_dists * invd;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    dp[(size_t)gp * C3 + k * J + j] =
        (BONE_WIN ? gr[k] * invd * w : gr[k] * invd) + pc[k] * gd;
}

// viewfac's per-ray Gram matrix Gw[net, r, j, :] = bf16(sum over the
// ray's points t, in order, of bf16(w[t, j]) g_hv[t, :]) (the xw^T g_hv
// of pallas_mlp._viewfac_bwd), which K-vf2 (viewfac.cu) folds into the
// views weight's view rows and denc: a block per (ray, net, VF_GC
// columns), its points' windows and g_hv's columns staged in shared
// memory VF_GS at a time, a thread per (joint, 8 columns).  All HV
// columns in one block up to 256 (768 threads); past that (WIDE nets'
// views layers of 384-1024) blocks of 128 along a third grid dimension,
// each column's sum over the points in the same order.
constexpr int VF_GS = 32;
constexpr int VF_GC = HV <= 256 ? HV : 128;
static_assert(HV % VF_GC == 0 && J * VF_GC / 8 <= 1024,
              "the Gram pass's column blocks");

__global__ void __launch_bounds__(J * VF_GC / 8)
vf_gram_kernel(Work wk, bf16* __restrict__ gw, int S, int R) {
  __shared__ float w[VF_GS][J];
  __shared__ __align__(16) bf16 g[VF_GS][VF_GC];
  const int r = blockIdx.x, net = blockIdx.y, c0 = blockIdx.z * VF_GC;
  const int j = threadIdx.x / (VF_GC / 8);
  const int c = (threadIdx.x % (VF_GC / 8)) * 8;
  float acc[8] = {};
  for (int s0 = 0; s0 < S; s0 += VF_GS) {
    const int ns = min(VF_GS, S - s0);
    const size_t p0 = (size_t)r * S + s0;
    __syncthreads();
    for (int i = threadIdx.x; i < ns * J; i += blockDim.x)
      w[i / J][i % J] = bf16r(wk.win[p0 * J + i]);
    for (int i = threadIdx.x; i < ns * VF_GC / 8; i += blockDim.x) {
      const int s = i / (VF_GC / 8), ch = i - s * (VF_GC / 8);
      reinterpret_cast<uint4*>(&g[s][0])[ch] = reinterpret_cast<const uint4*>(
          wk.ghv[net] + (p0 + s) * HV + c0)[ch];
    }
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
      const float ws = w[s][j];
      const uint4 gv = *reinterpret_cast<const uint4*>(&g[s][c]);
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] += ws * __bfloat162float(bf16_of(gv, q));
    }
  }
  bf16* o = gw + (((size_t)net * R + r) * J + j) * HV + c0 + c;
#pragma unroll
  for (int q = 0; q < 8; ++q) o[q] = __float2bfloat16_rn(acc[q]);
}

// denc (R, DE) and dcodes (NNET, R, NCODE): sums over a ray's samples;
// VF: dcodes alone (viewfac.cu's fold writes denc)
template <int NNET, bool VF>
__global__ void denc_kernel(Work wk, float* __restrict__ denc,
                            float* __restrict__ dcodes, int S, int R) {
  constexpr int C0 = VF ? DE : 0, NCOL = DE + NNET * NCODE - C0;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * NCOL) return;
  const int r = idx / NCOL, c = idx - r * NCOL + C0;
  float sum = 0.f;
  if (c < DE) {
    for (int s = 0; s < S; ++s) {
      const size_t gp = (size_t)r * S + s;
      float v = wk.gxv[0][gp * DXV + c];
      if (NNET == 2) v += wk.gxv[1][gp * DXV + c];
      sum += bf16r(v) * wk.win[gp * J + c % J];
    }
    denc[(size_t)r * DE + c] = sum;
  } else {
    const int net = (c - DE) / NCODE, cc = c - DE - net * NCODE;
    for (int s = 0; s < S; ++s)
      sum += wk.gxv[net][((size_t)r * S + s) * DXV + DE + cc];
    dcodes[((size_t)net * R + r) * NCODE + cc] = sum;
  }
}

template <int NNET, bool VF, bool TF>
int launch_passes(const float* p, const float* tfab, const float* enc,
                  const float* codes,
                  const float* cutoff, const float* tau, const bf16* wf,
                  const bf16* wb, const float* bpack, const float* g,
                  const Work& wk, float* dp, float* denc, float* dcodes,
                  float* dw, float* db, float* part, bf16* gw, int P,
                  int slice, int n, int S, int R, cudaStream_t st) {
  const int np = (int)round_up((size_t)n, T), ntile = np / T;
  Maps<NNET> maps;
  cudaError_t err = make_maps<NNET, VF>(maps, wf, wb, wk, np);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_tile_kernel<NNET, VF, TF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BWD);
  if (err != cudaSuccess) return (int)err;
  bwd_tile_kernel<NNET, VF, TF><<<ntile, NTHREAD + 32, SMEM_BWD, st>>>(
      p, enc, codes, cutoff, tau, wb, bpack, g, wk, maps, n, S, R, tfab);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  pullback_kernel<NNET, VF, TF><<<(n * J + 255) / 256, 256, 0, st>>>(
      p, enc, cutoff, tau, wk, dp, n, S, tfab);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (VF) {  // after the pullback, which writes the windows it reads
    vf_gram_kernel<<<dim3(R, NNET, HV / VF_GC), J * VF_GC / 8, 0, st>>>(
        wk, gw, S, R);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int ncol = (VF ? 0 : DE) + NNET * NCODE;
  denc_kernel<NNET, VF><<<(R * ncol + 255) / 256, 256, 0, st>>>(
      wk, denc, dcodes, S, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_grads(wk, NNET, dw, db, part, P, slice, np, st, VF);
}

template <int NNET, bool TF>
int launch_tf(const float* p, const float* tfab, const float* enc,
              const float* codes, const float* cutoff, const float* tau,
              const bf16* wf, const bf16* wb, const float* bpack,
              const float* g, const Work& wk, float* dp, float* denc,
              float* dcodes, float* dw, float* db, float* part,
              const void* vfM, void* gw, int P, int slice, int n, int S,
              int R, cudaStream_t st) {
  if (vfM)
    return launch_passes<NNET, true, TF>(
        p, tfab, enc, codes, cutoff, tau, wf, wb, bpack, g, wk, dp, denc,
        dcodes, dw, db, part, reinterpret_cast<bf16*>(gw), P, slice, n, S, R,
        st);
  return launch_passes<NNET, false, TF>(p, tfab, enc, codes, cutoff, tau, wf,
                                        wb, bpack, g, wk, dp, denc, dcodes, dw,
                                        db, part, nullptr, P, slice, n, S, R,
                                        st);
}

// vfM: the nets' M (NNET, R, J, HV) bf16 for viewfac, or null for the
// dense views input; gw: viewfac's Gram matrices (NNET, R, J, HV) bf16
// out, which viewfac.cu's fold reads (S >= 32).  tfab: null (p the
// points (n, 3J)) or the affine rows (R, 2, 3J) of the in-kernel
// transform (p the depths (R, S), n = R S); dp is (n, 3J) either way.
template <int NNET>
int launch_bwd(const float* p, const float* enc, const float* codes,
               const float* cutoff, const float* tau, const void* wpack,
               const void* wback, const float* bpack, const float* g,
               void* workspace, float* dp, float* denc, float* dcodes,
               float* dw, float* db, float* part, const void* vfM,
               void* gw, const float* tfab, int P, int slice, int n, int S,
               int R, void* stream) {
  if (n <= 0) return 0;
  if (vfM && (S < T / (VFR - 1) || !gw)) return (int)cudaErrorInvalidValue;
  if (tfab && n != R * S) return (int)cudaErrorInvalidValue;
  Work wk = carve(workspace, n, NNET, J);
  for (int k = 0; k < NNET && vfM; ++k)
    wk.vfM[k] = reinterpret_cast<const bf16*>(vfM) + (size_t)k * R * J * HV;
  const bf16* wf = reinterpret_cast<const bf16*>(wpack);
  const bf16* wb = reinterpret_cast<const bf16*>(wback);
  cudaStream_t st = (cudaStream_t)stream;
  if (tfab)
    return launch_tf<NNET, true>(p, tfab, enc, codes, cutoff, tau, wf, wb,
                                 bpack, g, wk, dp, denc, dcodes, dw, db, part,
                                 vfM, gw, P, slice, n, S, R, st);
  return launch_tf<NNET, false>(p, nullptr, enc, codes, cutoff, tau, wf, wb,
                                bpack, g, wk, dp, denc, dcodes, dw, db, part,
                                vfM, gw, P, slice, n, S, R, st);
}

}  // namespace

extern "C" {

// One net (K3): g (1, 4, n); dcodes (1, R, NCODE); dw (WGSZ); db (BSZ);
// vfM, gw null, or viewfac's; tfab null, or the affine rows (launch_bwd).
int encmlp_bwd(const float* p, const float* enc, const float* codes,
               const float* cutoff, const float* tau, const void* wpack,
               const void* wback, const float* bpack, const float* g,
               void* workspace, float* dp, float* denc, float* dcodes,
               float* dw, float* db, float* part, const void* vfM,
               void* gw, const float* tfab, int P, int slice, int n, int S,
               int R, void* stream) {
  return launch_bwd<1>(p, enc, codes, cutoff, tau, wpack, wback, bpack, g,
                       workspace, dp, denc, dcodes, dw, db, part, vfM, gw,
                       tfab, P, slice, n, S, R, stream);
}

// Coarse and fine nets on one encode (K4): every per-net operand holds
// two sets back to back.
int encmlp_dual_bwd(const float* p, const float* enc, const float* codes,
                    const float* cutoff, const float* tau, const void* wpack,
                    const void* wback, const float* bpack, const float* g,
                    void* workspace, float* dp, float* denc, float* dcodes,
                    float* dw, float* db, float* part, const void* vfM,
                    void* gw, const float* tfab, int P, int slice, int n,
                    int S, int R, void* stream) {
  return launch_bwd<2>(p, enc, codes, cutoff, tau, wpack, wback, bpack, g,
                       workspace, dp, denc, dcodes, dw, db, part, vfM, gw,
                       tfab, P, slice, n, S, R, stream);
}

long long encmlp_bwd_workspace_bytes(int n, int nnet) {
  return (long long)workspace_bytes(n, nnet, J);
}

long long encmlp_grad_weight_elems(void) { return (long long)WGSZ; }

// The build's encode shape, as encmlp_fwd.cu's.
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
