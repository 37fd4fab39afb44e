// Device code shared by the backward kernels of the radiance MLP
// (encmlp_bwd.cu: K3, K4; mlp_bwd.cu: K6): the workspace, the weight
// ring, the MLP backward of one 64-point tile, and the deterministic
// bias and weight gradient passes.  Each .cu file includes it once;
// everything here has internal linkage.
//
// The per-tile pass (mlp_bwd_tile) recomputes one net's forward on a
// 64-point tile and runs its backward down to the input cotangents.
// Every product of it, forward and backward, reads its weights from the
// weight ring of ring.cuh (NSTAGE stages of 32-deep k-slices, filled by
// TMA from a producer warp beside the 8 consumer warps), walking one
// fixed schedule (bwd_seg) across the products and the nets of the tile.
// The views layer's forward takes its A operand, the tile's views input,
// from the workspace through the same ring, so no views input stays in
// shared memory.  The recompute keeps each trunk layer's ReLU mask as
// bits (DEPTH layers x 64 x W bits: in shared memory, or at W = 512 in
// the workspace) for the backward; the bf16 activations and cotangents
// go to the workspace for the dW pass as 16-byte rows from shared
// memory.  Products stay mma.sync m16n8k16 with
// bf16 operands and f32 accumulators (the forward's wgmma product,
// mlp_fwd_common.cuh, is not used here yet); each warp owns a slice of
// output columns for all 64 rows, so column sums never cross warps.
//
// Bound of the per-tile pass: it re-reads both weight packs (3.46 MB a
// net) once per 64-point tile, ~14 GB of L2 reads per K4 call at
// n = 131,072: that L2 traffic, not the tensor cores, is its floor at
// this tile size.  Going below it needs weight reuse across tiles (larger
// tiles or a cluster sharing each slice by multicast).
//
// The dW pass (dw_kernel, dw_sum_kernel) reads the workspace's
// activations and cotangents back: ~1.6 GB a flagship net at
// n = 131,072, its floor at the card's memory rate (~0.47 ms), above
// its tensor-core work (~0.23 ms).  A block per 128 x 128 output tile
// alone gives one net 59 blocks for 132 SMs; each tile also takes one of
// P slices of the points, and a second kernel sums the slices' partial
// tiles in order.
#pragma once
#include "ring.cuh"

namespace {

// the backward weight pack and the weight-gradient buffer share one
// layout: every weight (in, out) row-major in flatten order
// (anerf_torch/ops/fused_mlp.py::_grad_layout)
constexpr size_t G_A = OFF_F;                   // (W, 1)
constexpr size_t G_F = G_A + W;                 // (W, W)
constexpr size_t G_VF = G_F + SZ_H;             // (W, HV)
constexpr size_t G_VX = G_VF + (size_t)W * HV;  // (DXV, HV)
constexpr size_t G_R = G_VX + (size_t)DXV * HV; // (HV, 3)
constexpr size_t WGSZ = G_R + 3 * HV;
static_assert(WGSZ % 4 == 0, "the dW partials are summed 4 at a time");
// trunk layer i's weights: off_h(i) (h part), 0 (layer 0), OFF_SKIPX
// (layer SKIP+1's [v | r] part): the forward's offsets, which already
// follow flatten order for the trunk

constexpr int NGS = 8;  // bf16 head cotangents a point: [rgb 3 | alpha | 0]

// ---- shared memory of the per-tile pass -----------------------------------
// the ring (1024-byte aligned for the swizzle), its barriers, X, two
// activation / cotangent buffers (T, LDH) (WIDE: one buffer C of XCH
// columns for the A operands read back from the workspace), the ReLU
// mask bits, the raw cotangent g (T, 4), a reduction scratch; K3/K4 add
// the windows (T, J) and the ray slots after it (SMEM_ADD, counted in
// both choices below).  The ring has 5 stages, 3 at W = 512.
// The mask bits of every trunk layer ([layer][block][warp][row][q]
// bytes) stay in shared memory where they fit beside a buffer of XCH
// trunk columns (K3/K4 up to 19 layers of 256; K6 at W = 256 up to 16
// layers), else each tile keeps its own in the workspace.  X is the
// whole trunk input (T, LDX) where that fits in a block's 227 KB as
// well, else a buffer of XCH columns that its products refill from the
// workspace's copy (ring_mma_x), and then C too.
constexpr int NSTAGE = W == 512 ? 3 : 5;
constexpr int MASK_LAYER = NBLK * NWARP * T * 4;
constexpr int MASK_BYTES = DEPTH * MASK_LAYER;
constexpr int NRED = NTHREAD + NWARP;
constexpr size_t tile_smem_bytes(int ldx, bool mask) {
  return 1024 + sizeof(bf16) * (size_t)NSTAGE * STAGE + sizeof(uint64_t) * 16 +
         sizeof(bf16) * (size_t)T *
             (ldx + (WIDE ? (ldx == LDC ? 0 : LDC) : 2 * LDH)) +
         (mask ? MASK_BYTES : 0) + sizeof(float) * (T * 4 + NRED);
}
constexpr bool MASK_RESIDENT =
    tile_smem_bytes(LDC, true) + SMEM_ADD <= SMEM_MAX;
constexpr bool BWD_X_RESIDENT =
    tile_smem_bytes(LDX, MASK_RESIDENT) + SMEM_ADD <= SMEM_MAX;
constexpr int LDXB = BWD_X_RESIDENT ? LDX : LDC;
constexpr size_t SMEM_TILE = tile_smem_bytes(LDXB, MASK_RESIDENT);
constexpr size_t MASK_SMEM = MASK_RESIDENT ? MASK_BYTES : 0;

// workspace: bf16 arrays, each (n_pad, width) row-major, then f32 ones
struct Work {
  bf16* x;            // [v | r | 0]                   (DXP)
  bf16* xv[2];        // [xv | codes | 0] per net      (DXV)
  bf16* act[2];       // trunk activations             (DEPTH x W)
  bf16* feat[2];      // (W)
  bf16* hv[2];        // (HV)
  bf16* gp[2];        // pre-activation cotangents     (DEPTH x W)
  bf16* gf[2];        // feat cotangent                (W)
  bf16* ghv[2];       // views cotangent               (HV)
  bf16* gs[2];        // head cotangents               (8)
  float* gx[2];       // [v | r | 0] input cotangent   (DXP)
  float* gxv[2];      // views input cotangent         (DXV)
  float* win;         // windows (K3/K4 only)          (24)
  float* bpart[2];    // per-tile bias partials        (ntile, BSZ)
  uint8_t* mask;      // per-tile ReLU masks, where not in shared memory
  const bf16* vfM[2]; // viewfac (K3/K4): each net's M (R, J, HV)
};

constexpr int BF_PER_NET = DXV + DEPTH * W + W + HV + DEPTH * W + W + HV + NGS;
constexpr int F_PER_NET = DXP + DXV;

__host__ __device__ inline size_t round_up(size_t v, size_t a) {
  return (v + a - 1) / a * a;
}

// nwin: f32 values a point after the nets' arrays (J windows for K3/K4,
// none for K6)
size_t workspace_bytes(int n, int nnet, int nwin) {
  const size_t np = round_up((size_t)n, T), ntile = np / T;
  return round_up(np * 2 * (DXP + (size_t)nnet * BF_PER_NET), 256) +
         np * 4 * ((size_t)nnet * F_PER_NET + nwin) +
         (size_t)nnet * ntile * BSZ * 4 +
         (MASK_RESIDENT ? 0 : ntile * MASK_BYTES);
}

Work carve(void* base, int n, int nnet, int nwin) {
  const size_t np = round_up((size_t)n, T);
  Work w{};
  bf16* b = reinterpret_cast<bf16*>(base);
  auto take = [&](size_t width) { bf16* r = b; b += np * width; return r; };
  w.x = take(DXP);
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
      round_up(np * 2 * (DXP + (size_t)nnet * BF_PER_NET), 256));
  for (int k = 0; k < nnet; ++k) {
    w.gx[k] = f;
    f += np * DXP;
    w.gxv[k] = f;
    f += np * DXV;
  }
  w.win = f;
  f += np * nwin;
  for (int k = 0; k < nnet; ++k) {
    w.bpart[k] = f;
    f += (np / T) * BSZ;
  }
  w.mask = MASK_RESIDENT ? nullptr : reinterpret_cast<uint8_t*>(f);
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

// ---- the backward's schedule on the weight ring (ring.cuh) -------------
// The schedule of one net, in the order the per-tile pass consumes it.
// Every product with W output columns runs as NBLK blocks of 256 (a
// segment each); one with more output columns than that (the input
// cotangents) is cut into 256-row chunks, one product each: ceil(DXP /
// 256) for each of the two trunk-input cotangents, ceil(DXV / 256) for
// the views input's.  The views layer's views-input part streams the
// tile's views input in each stage after its weight rows, 128 rows a
// segment; WIDE, the views layer's recompute runs in blocks of 128
// outputs, each its feat part and its views-input part.  With viewfac
// (K3, K4) the views-input part streams only the codes' k-slice (from
// VF_KB: NCODE + 16 columns) and the views input's cotangent is the
// codes' alone (NCODE rows).  bwd_seg computes segment i from its index,
// on nine maps: the forward pack's five (the views layer's parts in
// blocks of 128 rows, its feat part whole up to 512 wide), and in the
// backward pack (pack 1, from its start) the 256-row blocks and chunks
// HV deep (g_feat's, the views input's) and W deep (every trunk layer's
// and the feature layer's, the trunk input's chunks), and the ragged
// last chunk of each (or viewfac's codes rows).
constexpr int NXC = (DXP + 255) / 256;
constexpr int NVC = (DXV + 255) / 256;
constexpr int VXR = 128;
constexpr int NVXS = HV / VXR;
constexpr int NSEG_VIEWS = WIDE ? 2 * NVXS : 1 + NVXS;
// the trunk's backward after layer D-1's cotangent: layers D-1 .. 1, the
// skip layer's trunk-input chunks before its blocks
constexpr int NREV = NBLK * (DEPTH - 1) + (HAS_SKIP ? NXC : 0);
constexpr int NSEG = NBLK * (DEPTH + (HAS_SKIP ? 1 : 0) + 1) + NSEG_VIEWS +
                     NBLK * (DEPTH + 1) + NVC + (HAS_SKIP ? 2 : 1) * NXC;

enum { M_GHV = NMAP_FWD, M_GHV_T, M_GW, M_GW_T, NMAP_BWD };
static_assert(NMAP_BWD <= MAXMAP, "a net's maps");

// the rows of the last of the chunks of N rows
__host__ __device__ __forceinline__ constexpr int tail_rows(int N) {
  return N % 256 ? N % 256 : 256;
}

template <bool VF>
struct BwdPack {
  __host__ __device__ __forceinline__ static constexpr MapSpec map(int k) {
    return k < NMAP_FWD ? fwd_pack_map(k, WIDE ? VXR : HV, VXR)
           : k == M_GHV ? MapSpec{1, 0, HV, 256}
           : k == M_GHV_T ? MapSpec{1, 0, HV, VF ? NCODE : tail_rows(DXV)}
           : k == M_GW  ? MapSpec{1, 0, W, 256}
                        : MapSpec{1, 0, W, tail_rows(DXP)};
  }
  // chunk c of the (N, K) block of the backward pack at off, on the
  // map of its rows (full, or the ragged last)
  __host__ __device__ __forceinline__ static constexpr Seg chunk(
      size_t off, int c, int N, int full, int tail) {
    const int k = (c + 1) * 256 <= N ? full : tail;
    return seg_on(map(k), k, off + (size_t)c * 256 * map(k).K);
  }
};

template <bool VF>
__host__ __device__ __forceinline__ constexpr Seg bwd_seg(int i) {
  typedef BwdPack<VF> P;
  const int kb = VF ? VF_KB : 0;  // the codes' k-slice
  // forward recompute
  if (i < NBLK)                                         // layer 0   A = X
    return seg_on(P::map(M_X), M_X, (size_t)i * WB * DXP);
  i -= NBLK;
  if (i < NTRUNK) return trunk_seg<P>(i);               // layers 1 ..
  i -= NTRUNK;                                          //   skip: x part
  if (i < NBLK)                                         // feat
    return seg_on(P::map(M_H), M_H, OFF_F + (size_t)i * WB * W);
  i -= NBLK;
  if (i < NSEG_VIEWS) {
    if (!WIDE) {
      if (i == 0) return seg_on(P::map(M_VF), M_VF, OFF_VF);  // views: feat
      return seg_on(P::map(M_VX), M_VX,                       //   views-input
                    OFF_VX + (size_t)(i - 1) * VXR * DXV, kb, 1);  // part
    }
    const size_t v = (size_t)(i / 2);                   // views, by blocks
    return i % 2 == 0
               ? seg_on(P::map(M_VF), M_VF, OFF_VF + v * VXR * W)
               : seg_on(P::map(M_VX), M_VX, OFF_VX + v * VXR * DXV, kb, 1);
  }
  i -= NSEG_VIEWS;
  // backward
  if (i < NBLK)                                         // g_feat    A = g_hv
    return seg_on(P::map(M_GHV), M_GHV, G_VF + (size_t)i * WB * HV);
  i -= NBLK;
  if (VF) {                                             // g_codes   A = g_hv
    if (i == 0)
      return seg_on(P::map(M_GHV_T), M_GHV_T, G_VX + (size_t)DE * HV);
    i -= 1;
  } else {                                              // g_xv      A = g_hv
    if (i < NVC) return P::chunk(G_VX, i, DXV, M_GHV, M_GHV_T);
    i -= NVC;
  }
  if (i < NBLK)                                         // g of layer D-1
    return seg_on(P::map(M_GW), M_GW, G_F + (size_t)i * WB * W);  // A = g_feat
  i -= NBLK;
  if (i < NREV) {
    if (HAS_SKIP) {
      constexpr int a = (DEPTH - 2 - SKIP) * NBLK;      // layers D-1 .. SKIP+2
      if (i >= a && i < a + NXC)                        // g_x skip part
        return P::chunk(OFF_SKIPX, i - a, DXP, M_GW, M_GW_T);
      if (i >= a + NXC) i -= NXC;
    }
    return seg_on(P::map(M_GW), M_GW,                   // g of layer l-1
                  off_h(DEPTH - 1 - i / NBLK) + (size_t)(i % NBLK) * WB * W);
  }
  i -= NREV;
  return P::chunk(0, i, DXP, M_GW, M_GW_T);             // g_x layer-0 part
}
static_assert(WGSZ <= MAX_PACK && WSZ <= MAX_PACK,
              "a pack's offsets are ints");

// the backward's schedule; VF: viewfac's (K3, K4), whose views input's
// cotangent is one segment
template <bool VF>
struct BwdSchedT {
  static constexpr int N = VF ? NSEG - NVC + 1 : NSEG;
  static constexpr int NMAP = NMAP_BWD;
  static constexpr int NSTAGE = ::NSTAGE;
  __host__ __device__ __forceinline__ static constexpr MapSpec map(int k) {
    return BwdPack<VF>::map(k);
  }
  __host__ __device__ __forceinline__ static constexpr Seg seg(int i) {
    return bwd_seg<VF>(i);
  }
  __device__ __forceinline__ static Seg at(int i);
};
typedef BwdSchedT<false> BwdSched;

// the schedules' tables (ring.cuh seg_table)
constexpr int NSEG_VF = BwdSchedT<true>::N;
__constant__ Segs<in_const(NSEG)> SEGS_C =
    seg_table<BwdSchedT<false>, in_const(NSEG)>();
__constant__ Segs<in_const(NSEG_VF)> SEGS_VF_C =
    seg_table<BwdSchedT<true>, in_const(NSEG_VF)>();
__device__ Segs<in_global(NSEG)> SEGS_G =
    seg_table<BwdSchedT<false>, in_global(NSEG)>();
__device__ Segs<in_global(NSEG_VF)> SEGS_VF_G =
    seg_table<BwdSchedT<true>, in_global(NSEG_VF)>();

template <bool VF>
__device__ __forceinline__ Seg BwdSchedT<VF>::at(int i) {
  if constexpr (VF)
    return NSEG_VF <= SEG_CACHE ? SEGS_VF_C.s[i] : SEGS_VF_G.s[i];
  else
    return NSEG <= SEG_CACHE ? SEGS_C.s[i] : SEGS_G.s[i];
}

// The segments of each pack are blocks of it, pairwise disjoint: the
// recompute reads every matrix of the forward pack once; the backward
// every matrix of the backward pack but the heads' vectors (alpha's and
// rgb's, read directly); viewfac's backward skips the views input's rows
// but the codes'
static_assert(covers<BwdSchedT<false>>(0, WSZ, OFF_A, 0, 0, OFF_A) &&
                  covers<BwdSchedT<true>>(0, WSZ, OFF_A, 0, 0, OFF_A),
              "the recompute must cover the forward pack once");
static_assert(covers<BwdSchedT<false>>(1, WGSZ, G_R, G_A, G_F,
                                       G_A + (G_R - G_F)),
              "the backward must cover the backward pack once");
static_assert(covers<BwdSchedT<true>>(
                  1, WGSZ, G_R, G_A, G_F,
                  G_A + (G_R - G_F) - (size_t)(DXV - NCODE) * HV),
              "viewfac's backward must cover the backward pack but xv's rows");

// Every stage's source as a TMA descriptor (a kernel parameter): each
// net's packs through the schedule's maps (MAXMAP a net), and each net's
// views input (n_pad, DXV) in boxes of KS x T; 64-byte swizzle, columns
// past K read as zeros.
template <int NN>
struct Maps {
  CUtensorMap seg[NN][MAXMAP];
  CUtensorMap xv[NN];
};

// The descriptors of NN nets (forward packs wf, backward packs wb,
// views inputs in wk, np padded points) for the schedule VF.
template <int NN, bool VF = false>
cudaError_t make_maps(Maps<NN>& mp, const bf16* wf, const bf16* wb,
                      const Work& wk, int np) {
  EncodeTiled enc;
  const cudaError_t err = tensor_map_encoder(&enc);
  if (err != cudaSuccess) return err;
  mp = Maps<NN>{};
  MapSpec spec[NMAP_BWD];
  for (int k = 0; k < NMAP_BWD; ++k) spec[k] = BwdPack<VF>::map(k);
  for (int net = 0; net < NN; ++net) {
    if (!encode_maps(enc, mp.seg[net], spec, NMAP_BWD,
                     wf + (size_t)net * WSZ, WSZ, wb + (size_t)net * WGSZ,
                     WGSZ))
      return cudaErrorInvalidValue;
    if (!encode_2d(enc, &mp.xv[net], wk.xv[net], DXV, np, T))
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// device-memory writes of this thread made visible to later TMA reads
// (the async proxy) once the block has synchronised
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

typedef Ring<BwdSched> BwdRing;

// acc += A[0:64, k_lo:k_hi] @ Wseg[n0 : n0 + 8 NT, k_lo:k_hi]^T over the
// ring's stages of k-slices k_lo .. k_hi - 1 of segment s, for this
// warp's columns (none where n0 is outside the segment's rows).  A:
// shared, row-major, stride lda, its column 0 at k_lo (k_lo a multiple
// of KS, k_hi of 16), or nullptr for the views input that rides in the
// stages.  Each stage: wait for its bytes, ldmatrix + mma, then the
// warp's arrival on the stage's empty barrier.  No block barrier: the
// warps drift apart by up to NSTAGE stages.
//
// ACC, how the mma's sums reach acc.  ACC_CHAIN: the mma chain adds its
// products to acc itself.  The tensor cores add the products to the
// accumulator they are given with truncation, so a chain of mma on one
// accumulator drifts with its depth; the trunk input's products past
// 480 columns (1152 deep for 'relpos') drifted far enough to flip ReLU
// masks that the twin's f32 sums (and an f64 evaluation of the chain)
// keep.  ACC_RN: each mma sums its k16 products from zero and the f32
// add that takes that sum into acc rounds to nearest.  ACC_COMP: that
// add compensated (Kahan), so acc carries the rounding error of the
// adds along: a net of 32 layers flipped masks under ACC_RN as well
// (K6 against its twin at cosine 0.99982 at 4104 points; compensated
// 0.9999974, and 0.9999996 against f64, where the twin reads 0.999998;
// at 24 layers the chain and the compensated sums read alike).
constexpr int ACC_CHAIN = 0, ACC_RN = 1, ACC_COMP = 2;
template <int NT, int ACC = ACC_CHAIN, class SC>
__device__ __forceinline__ void mma_slices(Ring<SC>& r, float (&acc)[4][NT][4],
                                           const Seg& s, const bf16* A,
                                           int lda, int n0, int k_lo,
                                           int k_hi) {
  const int lane = threadIdx.x & 31;
  float comp[4][NT][4];  // ACC_COMP: the adds' rounding errors
  if constexpr (ACC == ACC_COMP) zero_acc<NT>(comp);
  // ldmatrix row addresses: B matrices (n 0-7 | 8-15) x (k 0-7 | 8-15),
  // A matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
  const int b_row = n0 + (lane & 7) + ((lane >> 4) << 3), b_ch = (lane >> 3) & 1;
  const int a_row = lane & 15, a_ch = lane >> 4;
  const bool on = n0 >= 0 && n0 < s.rows;
  for (int k0 = k_lo; k0 < k_hi; k0 += KS) {
    mbar_wait(r.full + r.c_slot, r.c_phase);
    const bf16* sb = r.buf + r.c_slot * STAGE;
    const int nk = min(KS, k_hi - k0) >> 4;  // k16 steps in this stage
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      if (!on || kk >= nk) break;
      uint32_t b[NT][2];
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t t4[4];
        ldsm_x4(t4, sb + swz(b_row + jp * 16, 2 * kk + b_ch));
        b[2 * jp][0] = t4[0];
        b[2 * jp][1] = t4[1];
        b[2 * jp + 1][0] = t4[2];
        b[2 * jp + 1][1] = t4[3];
      }
      uint32_t a[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (A)
          ldsm_x4(a[m], A + (m * 16 + a_row) * lda + (k0 - k_lo) + kk * 16 +
                            a_ch * 8);
        else
          ldsm_x4(a[m], sb + swz(s.rows + m * 16 + a_row, 2 * kk + a_ch));
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (ACC == ACC_COMP) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(t, a[m], b[j][0], b[j][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float y = t[e] - comp[m][j][e];
              const float sum = acc[m][j][e] + y;
              comp[m][j][e] = (sum - acc[m][j][e]) - y;
              acc[m][j][e] = sum;
            }
          } else if constexpr (ACC == ACC_RN) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(t, a[m], b[j][0], b[j][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] += t[e];
          } else {
            mma_bf16(acc[m][j], a[m], b[j][0], b[j][1]);
          }
        }
    }
    ring_release(r, r.c_slot);
    ring_advance(r);
  }
}

// The per-tile pass's accumulation: compensated past 24 layers (a 32-
// layer net's cotangents drift from the twin's on the chain: ACC_COMP's
// note), else the chain (K1-K4's bits and every net's to 24 layers are
// those of the chain; the compensation's registers spill, and cost a
// 10-layer net 2.3x the per-tile pass).  A WIDE net's products are RN
// at least (ring_mma_g).
constexpr int DEEP_NET = 24;
constexpr int ACC_NET = DEPTH > DEEP_NET ? ACC_COMP : ACC_CHAIN;
__host__ __device__ constexpr int acc_g(int acc) {
  return acc > ACC_RN ? acc : ACC_RN;
}
constexpr int ACC_NET_G = acc_g(ACC_NET);

// The per-tile pass's accumulation by product group: the forward
// recompute's trunk and feat products (ACC_REC), the views layer's
// recompute (ACC_VW) and the cotangent products (ACC_COT: g_feat, g_xv,
// the trunk's in reverse, g_x).  ACC_NET in each but K1-K4's deep builds
// (ENC_DEEP, encmlp_common.cuh), whose recompute is RN and the rest the
// chain: from 16 layers of 512 on the recompute's chain sums put the
// later layers' weight gradients outside the f64 rule (chip_smoke.
// _check_bwd_f64, from the encode's own f32 bands) and RN brings them
// back; the cotangents' and the views layer's sums do not move them
// (scripts/check_k6_f64.py --acc-group, PERF.md).  A WIDE group's
// products read back from the workspace are RN at least (acc_g).
// --acc-group builds a source copy with one of these lines replaced.
constexpr int ACC_REC = ENC_DEEP ? ACC_RN : ACC_NET;
constexpr int ACC_VW = ENC_DEEP ? ACC_CHAIN : ACC_NET;
constexpr int ACC_COT = ENC_DEEP ? ACC_CHAIN : ACC_NET;

// acc += A[0:64, kb:K] @ Wseg[n0 : n0 + 8 NT, kb:K]^T over the next
// segment of the schedule (mma_slices), A's column 0 at its first
// k-slice kb
template <int NT, int ACC = ACC_NET, class SC>
__device__ __forceinline__ void ring_mma(Ring<SC>& r, float (&acc)[4][NT][4],
                                         const bf16* A, int lda, int n0) {
  const Seg s = ring_next_seg(r);
  mma_slices<NT, ACC>(r, acc, s, A, lda, n0, s.kb, s.K);
}

struct TileSmem {
  bf16* ring;
  uint64_t* bars;   // the ring's full and empty barriers
  bf16* X;
  bf16* H0;
  bf16* H1;
  bf16* C;          // WIDE: the A operands' column buffer
  uint8_t* mask;
  float* gsm;
  float* red;
  float* end;   // what a kernel adds after the pass's own
};

__device__ __forceinline__ TileSmem tile_smem(unsigned char* base) {
  TileSmem s;
  const uint32_t pad = (1024u - (smem_addr(base) & 1023u)) & 1023u;
  s.ring = reinterpret_cast<bf16*>(base + pad);
  s.bars = reinterpret_cast<uint64_t*>(s.ring + NSTAGE * STAGE);
  s.X = reinterpret_cast<bf16*>(s.bars + 16);
  s.H0 = s.X + T * LDXB;
  s.H1 = s.H0 + T * LDH;
  s.C = BWD_X_RESIDENT ? s.H0 : s.X;
  s.mask = reinterpret_cast<uint8_t*>(
      WIDE ? s.H0 + (BWD_X_RESIDENT ? T * LDC : 0) : s.H1 + T * LDH);
  s.gsm = reinterpret_cast<float*>(s.mask + MASK_SMEM);
  s.red = s.gsm + T * 4;
  s.end = s.red + NRED;
  return s;
}

// acc += X @ Wseg[n0 : n0 + 8 NT, :]^T over the next segment, whose A
// operand is the trunk input X: resident in sm.X, or, where it does not
// fit, copied from the tile's rows xg of the workspace (stride DXP) into
// sm.X XCH columns at a time between two barriers of the consumer warps,
// each mma's sum then added with rounding (mma_slices' RN).
template <int NT, int ACC = ACC_NET, class SC>
__device__ __forceinline__ void ring_mma_x(Ring<SC>& r, float (&acc)[4][NT][4],
                                           const TileSmem& sm,
                                           const bf16* __restrict__ xg,
                                           int n0) {
  if constexpr (BWD_X_RESIDENT) {
    ring_mma<NT, ACC>(r, acc, sm.X, LDXB, n0);
  } else {
    const Seg s = ring_next_seg(r);
    for (int c0 = 0; c0 < s.K; c0 += XCH) {
      const int c1 = min(c0 + XCH, s.K), per_row = (c1 - c0) / 8;
      sync_tile();  // every warp is past its reads of the last columns
      for (int idx = threadIdx.x; idx < T * per_row; idx += NTHREAD) {
        const int t = idx / per_row, c = (idx - t * per_row) * 8;
        *reinterpret_cast<uint4*>(sm.X + t * LDXB + c) =
            *reinterpret_cast<const uint4*>(xg + (size_t)t * DXP + c0 + c);
      }
      sync_tile();
      mma_slices<NT, ACC == ACC_CHAIN ? ACC_RN : ACC>(r, acc, s, sm.X, LDXB,
                                                      n0, c0, c1);
    }
  }
}

// acc += A @ Wseg[n0 : n0 + 8 NT, :]^T over the next segment, A (T rows,
// row stride lda) in device memory, copied into sm.C XCH columns at a
// time between two barriers of the consumer warps, with mma_slices' RN
// (WIDE)
template <int NT, int ACC = ACC_NET_G, class SC>
__device__ __forceinline__ void ring_mma_g(Ring<SC>& r, float (&acc)[4][NT][4],
                                           const TileSmem& sm,
                                           const bf16* __restrict__ A,
                                           int lda, int n0) {
  const Seg s = ring_next_seg(r);
  for (int c0 = 0; c0 < s.K; c0 += XCH) {
    const int c1 = min(c0 + XCH, s.K), per_row = (c1 - c0) / 8;
    sync_tile();  // every warp is past its reads of the last columns
    for (int idx = threadIdx.x; idx < T * per_row; idx += NTHREAD) {
      const int t = idx / per_row, c = (idx - t * per_row) * 8;
      *reinterpret_cast<uint4*>(sm.C + t * LDC + c) =
          *reinterpret_cast<const uint4*>(A + (size_t)t * lda + c0 + c);
    }
    sync_tile();
    mma_slices<NT, ACC>(r, acc, s, sm.C, LDC, n0, c0, c1);
  }
}

// ---- epilogues ------------------------------------------------------------
// The fragment layout of mma.m16n8k16's accumulators: acc[m][j] holds
// rows m*16 + g (| +8) and columns n0 + j*8 + 2q (| +1), g = lane / 4,
// q = lane % 4.  A warp's ReLU mask bits of one row and layer are one
// 32-bit word: byte q of it is thread q's, bit 2j + e its column
// n0 + j*8 + 2q + e.  Outputs have row stride ldo (shared memory, or
// device memory for a WIDE net).

// out[row, col] = bf16(relu(acc + bias[col])) for this warp's 32
// columns, and the bits (value > 0) into this layer's mask
__device__ __forceinline__ void store_relu_mask(const float (&acc)[4][4][4],
                                                const float* __restrict__ bias,
                                                bf16* out, uint8_t* mask,
                                                int n0, int ldo = LDH) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  uint8_t* mk = mask + (threadIdx.x >> 5) * T * 4 + q;
  uint32_t bits[4][2] = {};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + j * 8 + 2 * q;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(fmaxf(acc[m][j][2 * h] + b0, 0.f),
                                  fmaxf(acc[m][j][2 * h + 1] + b1, 0.f));
        *reinterpret_cast<__nv_bfloat162*>(out + (m * 16 + g + 8 * h) * ldo +
                                           col) = v;
        bits[m][h] |= (__bfloat162float(v.x) > 0.f ? 1u : 0u) << (2 * j);
        bits[m][h] |= (__bfloat162float(v.y) > 0.f ? 1u : 0u) << (2 * j + 1);
      }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) mk[(m * 16 + g + 8 * h) * 4] = (uint8_t)bits[m][h];
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

// the bf16 rounding of a warp's accumulators: the next product's A, and
// the dW pass's G
template <int NT>
__device__ __forceinline__ void emit_bf16(const float (&acc)[4][NT][4], bf16* out,
                                          int n0, int ldo = LDH) {
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
        *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + col) = v;
      }
    }
}

// acc <- acc * mask with the layer's ReLU mask bits (store_relu_mask);
// then the bias partial of the f32 cotangent, and its bf16 rounding
// (emit_bf16)
__device__ __forceinline__ void mask_emit(float (&acc)[4][4][4],
                                          const uint8_t* mask,
                                          float* __restrict__ bpart, bf16* out,
                                          int n0, int ldo = LDH) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const uint8_t* mk = mask + (threadIdx.x >> 5) * T * 4 + q;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t bits = mk[(m * 16 + g + 8 * h) * 4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!(bits >> (2 * j) & 1u)) acc[m][j][2 * h] = 0.f;
        if (!(bits >> (2 * j + 1) & 1u)) acc[m][j][2 * h + 1] = 0.f;
      }
    }
  colsum_store<4>(acc, bpart, n0);
  emit_bf16<4>(acc, out, n0, ldo);
}

// out[row, c] (=|+=) acc for this warp's columns c < lim (f32, device
// memory, row stride ldo)
template <bool ADD>
__device__ __forceinline__ void store_f32(const float (&acc)[4][4][4],
                                          float* __restrict__ out, int ldo,
                                          int n0, int lim) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + j * 8 + 2 * q;
    if (col >= lim) continue;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* o =
            reinterpret_cast<float2*>(out + (size_t)(m * 16 + g + 8 * h) * ldo + col);
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

// an input cotangent chunk by chunk: out[:, 0:N] (=|+=) A @ W^T over
// the schedule's next ceil(N / 256) segments (out's row stride ldo);
// A in shared memory (stride LDH), or, given sm, in device memory (row
// stride lda, ring_mma_g)
template <bool ADD, int ACC = ACC_NET, class SC>
__device__ __forceinline__ void ring_to_global(Ring<SC>& rg, const bf16* A,
                                               float* __restrict__ out,
                                               int N, int nw, int ldo,
                                               const TileSmem* sm = nullptr,
                                               int lda = 0) {
  for (int c0 = 0; c0 < N; c0 += WB) {
    float acc[4][4][4];
    zero_acc<4>(acc);
    if (sm)
      ring_mma_g<4, acc_g(ACC)>(rg, acc, *sm, A, lda, nw);
    else
      ring_mma<4, ACC>(rg, acc, A, LDH, nw);
    store_f32<ADD>(acc, out + c0, ldo, nw, N - c0);
  }
}

#if !ANERF_WIDE
// The MLP backward of one tile for net `net` through the ring `rg` (whose
// schedule is at the net's first segment): X complete in shared memory
// where it stays resident, and in any case the tile's rows of it at xg
// (wk.x) and its views input in wk.xv[net]; sm.gsm the tile's raw
// cotangent (T, 4) [rgb, alpha].  Bn: the net's packed biases; Wb: its
// backward pack (the head weights are read from it directly).  Writes
// every bf16 activation and cotangent, the f32 input cotangents gx/gxv
// and the tile's bias partials to the workspace `wk`.  A product with W
// output columns runs as NBLK blocks of 256, warp w taking columns
// 32w .. 32w+31 of each.  VF (viewfac, K3/K4): the views input in the
// workspace is the codes' k-slice alone, the views layer's recompute
// adds xw @ M (vf_xw_m; the tile's rays, windows and M in `vf`), and
// the views input's cotangent is the codes' alone (encmlp_bwd.cu's
// passes take the rest from g_hv in the workspace).  Run by the
// consumer warps; ends with them synchronised.
static_assert(VF_STAGE <= T * LDH,
              "viewfac's staging (K3/K4) in an activation buffer");

template <bool VF>
__device__ __forceinline__ void mlp_bwd_tile(Ring<BwdSchedT<VF>>& rg,
                                             const TileSmem& sm,
                                             const bf16* __restrict__ Wb,
                                             const float* __restrict__ Bn,
                                             const Work& wk, int net, int t0,
                                             const bf16* xg = nullptr,
                                             const VfTile* vf = nullptr) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const float* GSM = sm.gsm;
  float* bpart = wk.bpart[net] + (size_t)blockIdx.x * BSZ;
  bf16* act = wk.act[net] + (size_t)t0 * DEPTH * W;
  bf16* gp = wk.gp[net] + (size_t)t0 * DEPTH * W;
  const int nw = warp * 32;  // this warp's 32 of a block's 256 columns
  // the mask bits of trunk layer l, output block b
  uint8_t* const mask0 =
      MASK_RESIDENT ? sm.mask : wk.mask + (size_t)blockIdx.x * MASK_BYTES;
  auto mask = [&](int l, int b) {
    return mask0 + l * MASK_LAYER + b * (MASK_LAYER / NBLK);
  };

  // ---- forward recompute: activations to device memory, masks kept ---
  float acc[4][4][4];
#pragma unroll 1
  for (int b = 0; b < NBLK; ++b) {
    zero_acc<4>(acc);
    ring_mma_x<4, ACC_REC>(rg, acc, sm, xg, nw);
    store_relu_mask(acc, Bn + b * WB, sm.H0 + b * WB, mask(0, b), nw);
  }
  sync_tile();
  copy_rows(act, DEPTH * W, sm.H0, LDH, W);
  bf16* hin = sm.H0;
  bf16* hout = sm.H1;
#pragma unroll 1
  for (int i = 1; i < DEPTH; ++i) {
#pragma unroll 1
    for (int b = 0; b < NBLK; ++b) {
      zero_acc<4>(acc);
      ring_mma<4, ACC_REC>(rg, acc, hin, LDH, nw);
      if (HAS_SKIP && i == SKIP + 1)
        ring_mma_x<4, ACC_REC>(rg, acc, sm, xg, nw);
      store_relu_mask(acc, Bn + i * W + b * WB, hout + b * WB, mask(i, b),
                      nw);
    }
    sync_tile();
    copy_rows(act + i * W, DEPTH * W, hout, LDH, W);
    bf16* tmp = hin;
    hin = hout;
    hout = tmp;
  }
#pragma unroll 1
  for (int b = 0; b < NBLK; ++b) {
    zero_acc<4>(acc);
    ring_mma<4, ACC_REC>(rg, acc, hin, LDH, nw);
    store_act<4, false>(acc, Bn + OB_F + b * WB, hout + b * WB, LDH,
                        nw);  // feat
  }
  sync_tile();
  copy_rows(wk.feat[net] + (size_t)t0 * W, W, hout, LDH, W);
  if constexpr (VF) {  // M and xw in hin, free until hv lands there
    vf_stage(hin, *vf);
    sync_tile();
  }
  {
    // the views layer: warp w takes 8 NTV of its HV columns
    constexpr int NTV = HV / (8 * NWARP);
    float accv[4][NTV][4];
    const int nv = warp * 8 * NTV;
    zero_acc<NTV>(accv);
    ring_mma<NTV, ACC_VW>(rg, accv, hout, LDH, nv);
#pragma unroll 1
    for (int v = 0; v < NVXS; ++v)  // the views input, streamed
      ring_mma<NTV, ACC_VW>(rg, accv, nullptr, 0, nv - v * VXR);
    if constexpr (VF) {
#pragma unroll
      for (int m = 0; m < 4; ++m) vf_xw_m<NTV>(accv[m], hin, 16 * m, nv);
      sync_tile();  // every warp is past its reads of the staging
    }
    store_act<NTV, true>(accv, Bn + OB_V, hin, LDH, nv);  // hv
  }
  sync_tile();
  copy_rows(wk.hv[net] + (size_t)t0 * HV, HV, hin, LDH, HV);
  sync_tile();
  bf16* HVB = hin;    // hv, then the bf16 views cotangent in place
  bf16* FB = hout;    // feat, then the bf16 feat cotangent

  // ---- heads on all threads: g_hv = (bf16(g_rgb) . wr) * (hv > 0), for
  // column h = tid % HV of RPT rows each; the rgb and alpha column sums
  // by warp butterflies; each sum in a fixed order -----------------------
  static_assert(NTHREAD % HV == 0 && NTHREAD == 4 * T, "head section layout");
  constexpr int RPT = T * HV / NTHREAD;
  {
    const int h = tid % HV, r0 = (tid / HV) * RPT;
    const float w0 = __bfloat162float(Wb[G_R + h * 3]);
    const float w1 = __bfloat162float(Wb[G_R + h * 3 + 1]);
    const float w2 = __bfloat162float(Wb[G_R + h * 3 + 2]);
    float colsum = 0.f;
    for (int t = r0; t < r0 + RPT; ++t) {
      const float* gr = GSM + t * 4;
      float v = bf16r(gr[0]) * w0 + bf16r(gr[1]) * w1 + bf16r(gr[2]) * w2;
      if (!(__bfloat162float(HVB[t * LDH + h]) > 0.f)) v = 0.f;
      colsum += v;
      HVB[t * LDH + h] = __float2bfloat16_rn(v);
    }
    sm.red[tid] = colsum;
    float x = GSM[(tid & (T - 1)) * 4 + tid / T];  // column tid / 64
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if ((tid & 31) == 0) sm.red[NTHREAD + warp] = x;
    if (tid < T) {  // the bf16 head cotangents [rgb | alpha | 0 x 4]
      const float* gr = GSM + tid * 4;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(gr[0], gr[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(gr[2], gr[3]);
      *reinterpret_cast<uint4*>(wk.gs[net] + (size_t)(t0 + tid) * NGS) =
          make_uint4(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi), 0u, 0u);
    }
  }
  sync_tile();
  if (tid < HV) {
    float sum = sm.red[tid];
#pragma unroll
    for (int k = 1; k < NTHREAD / HV; ++k) sum += sm.red[k * HV + tid];
    bpart[OB_V + tid] = sum;
  }
  if (tid >= NTHREAD - 4) {
    const int c = tid - (NTHREAD - 4);  // rgb 0-2, alpha 3: warps 2c, 2c + 1
    bpart[c < 3 ? OB_R + c : OB_A] =
        sm.red[NTHREAD + 2 * c] + sm.red[NTHREAD + 2 * c + 1];
  }
  copy_rows(wk.ghv[net] + (size_t)t0 * HV, HV, HVB, LDH, HV);

  // ---- g_feat = g_hv_b @ wvf^T (bias partial, bf16 to FB); the views
  // input cotangent g_xv = g_hv_b @ wvx^T to device memory ------------
#pragma unroll 1
  for (int b = 0; b < NBLK; ++b) {
    zero_acc<4>(acc);
    ring_mma<4, ACC_COT>(rg, acc, HVB, LDH, nw);
    colsum_store<4>(acc, bpart + OB_F + b * WB, nw);
    emit_bf16<4>(acc, FB + b * WB, nw);
  }
  sync_tile();
  copy_rows(wk.gf[net] + (size_t)t0 * W, W, FB, LDH, W);
  if constexpr (VF)  // the codes' cotangent alone
    ring_to_global<false, ACC_COT>(rg, HVB, wk.gxv[net] + (size_t)t0 * DXV + DE,
                                   NCODE, nw, DXV);
  else
    ring_to_global<false, ACC_COT>(rg, HVB, wk.gxv[net] + (size_t)t0 * DXV, DXV,
                                   nw, DXV);

  // ---- g_a = g_feat_b @ wf^T + bf16(g_alpha) wa; layer D-1's cotangent
  bf16* gin_b = HVB;   // the current layer's bf16 cotangent
  bf16* gout_b = FB;
#pragma unroll 1
  for (int b = 0; b < NBLK; ++b) {
    zero_acc<4>(acc);
    ring_mma<4, ACC_COT>(rg, acc, FB, LDH, nw);
    if (b == 0) sync_tile();  // every warp is past the g_xv products'
                              // reads of HVB
    const int lane = tid & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = b * WB + nw + j * 8 + 2 * q;
        const float wa0 = __bfloat162float(Wb[G_A + col]);
        const float wa1 = __bfloat162float(Wb[G_A + col + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float ga = bf16r(GSM[(m * 16 + g + 8 * h) * 4 + 3]);
          acc[m][j][2 * h] += ga * wa0;
          acc[m][j][2 * h + 1] += ga * wa1;
        }
      }
    mask_emit(acc, mask(DEPTH - 1, b), bpart + (DEPTH - 1) * W + b * WB,
              gin_b + b * WB, nw);
  }
  sync_tile();
  copy_rows(gp + (DEPTH - 1) * W, DEPTH * W, gin_b, LDH, W);

  // ---- the trunk in reverse ----------------------------------------
  float* gx = wk.gx[net] + (size_t)t0 * DXP;
#pragma unroll 1
  for (int i = DEPTH - 1; i >= 1; --i) {
    if (HAS_SKIP && i == SKIP + 1)
      ring_to_global<false, ACC_COT>(rg, gin_b, gx, DXP, nw, DXP);
#pragma unroll 1
    for (int b = 0; b < NBLK; ++b) {
      zero_acc<4>(acc);
      ring_mma<4, ACC_COT>(rg, acc, gin_b, LDH, nw);
      mask_emit(acc, mask(i - 1, b), bpart + (i - 1) * W + b * WB,
                gout_b + b * WB, nw);
    }
    sync_tile();
    copy_rows(gp + (i - 1) * W, DEPTH * W, gout_b, LDH, W);
    bf16* tmp = gin_b;
    gin_b = gout_b;
    gout_b = tmp;
  }
  // layer 0's part: added to the skip layer's, where there is one
  ring_to_global<HAS_SKIP, ACC_COT>(rg, gin_b, gx, DXP, nw, DXP);
  sync_tile();  // the next net may take every buffer
}

#endif

#if ANERF_WIDE
// The MLP backward of one tile, WIDE: mlp_bwd_tile's products in its
// order, with every activation and cotangent written straight to the
// workspace (where the dW pass reads them) and every A operand but the
// trunk input and the streamed views input read back from there XCH
// columns at a time (ring_mma_g, with mma_slices' RN); the views layer's
// recompute in blocks of 128 outputs (warp w takes 16 of each); the
// masks in the workspace where they do not fit.  VF (viewfac, K3/K4):
// each views block's recompute adds xw @ M's 128 columns of the block
// (M's rows of the tile's rays, `vf`, staged into C after the block's
// feat part has read it) to the codes' k-slice streamed from the
// workspace, and the views input's cotangent is the codes' alone (as
// mlp_bwd_tile's).
static_assert(VF_STAGE <= T * LDC && VXR == VF_MC,
              "viewfac's staging (K3/K4) in the A operands' column buffer");

template <bool VF>
__device__ __forceinline__ void mlp_bwd_tile_wide(
    Ring<BwdSchedT<VF>>& rg, const TileSmem& sm, const bf16* __restrict__ Wb,
    const float* __restrict__ Bn, const Work& wk, int net, int t0,
    const bf16* xg, const VfTile* vf = nullptr) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const float* GSM = sm.gsm;
  float* bpart = wk.bpart[net] + (size_t)blockIdx.x * BSZ;
  constexpr int LA = DEPTH * W;
  bf16* act = wk.act[net] + (size_t)t0 * LA;
  bf16* gp = wk.gp[net] + (size_t)t0 * LA;
  bf16* feat = wk.feat[net] + (size_t)t0 * W;
  bf16* hv = wk.hv[net] + (size_t)t0 * HV;
  bf16* gf = wk.gf[net] + (size_t)t0 * W;
  bf16* ghv = wk.ghv[net] + (size_t)t0 * HV;
  const int nw = warp * 32;  // this warp's 32 of a block's 256 columns
  uint8_t* const mask0 =
      MASK_RESIDENT ? sm.mask : wk.mask + (size_t)blockIdx.x * MASK_BYTES;
  auto mask = [&](int l, int b) {
    return mask0 + l * MASK_LAYER + b * (MASK_LAYER / NBLK);
  };

  // ---- forward recompute -------------------------------------------------
  float acc[4][4][4];
#pragma unroll 1
  for (int b = 0; b < NBLK; ++b) {
    zero_acc<4>(acc);
    ring_mma_x<4, ACC_REC>(rg, acc, sm, xg, nw);
    store_relu_mask(acc, Bn + b * WB, act + b * WB, mask(0, b), nw, LA);
  }
#pragma unroll 1
  for (int i = 1; i < DEPTH; ++i) {
#pragma unroll 1
    for (int b = 0; b < NBLK; ++b) {
      zero_acc<4>(acc);
      ring_mma_g<4, acc_g(ACC_REC)>(rg, acc, sm, act + (i - 1) * W, LA, nw);
      if (HAS_SKIP && i == SKIP + 1)
        ring_mma_x<4, ACC_REC>(rg, acc, sm, xg, nw);
      store_relu_mask(acc, Bn + i * W + b * WB, act + i * W + b * WB,
                      mask(i, b), nw, LA);
    }
  }
#pragma unroll 1
  for (int b = 0; b < NBLK; ++b) {
    zero_acc<4>(acc);
    ring_mma_g<4, acc_g(ACC_REC)>(rg, acc, sm, act + (DEPTH - 1) * W, LA, nw);
    store_act<4, false>(acc, Bn + OB_F + b * WB, feat + b * WB, W, nw);
  }
#pragma unroll 1
  for (int v = 0; v < NVXS; ++v) {
    float accv[4][2][4];
    const int nv = warp * 16;
    zero_acc<2>(accv);
    ring_mma_g<2, acc_g(ACC_VW)>(rg, accv, sm, feat, W, nv);
    if constexpr (VF) {
      sync_tile();  // every warp is past its reads of C
      vf_stage(sm.C, *vf, v * VXR);
      sync_tile();
    }
    ring_mma<2, ACC_VW>(rg, accv, nullptr, 0, nv);  // the views input, streamed
    if constexpr (VF) {
#pragma unroll
      for (int m = 0; m < 4; ++m) vf_xw_m<2>(accv[m], sm.C, 16 * m, nv);
    }
    store_act<2, true>(accv, Bn + OB_V + v * VXR, hv + v * VXR, HV, nv);
  }
  sync_tile();

  // ---- heads: g_hv = (bf16(g_rgb) . wr) * (hv > 0), column h by one
  // thread over the 64 rows in order; the rgb and alpha column sums by
  // warp butterflies ---------------------------------------------------------
  static_assert(NTHREAD == 4 * T, "head section layout");
  for (int h = tid; h < HV; h += NTHREAD) {
    const float w0 = __bfloat162float(Wb[G_R + h * 3]);
    const float w1 = __bfloat162float(Wb[G_R + h * 3 + 1]);
    const float w2 = __bfloat162float(Wb[G_R + h * 3 + 2]);
    float colsum = 0.f;
    for (int t = 0; t < T; ++t) {
      const float* gr = GSM + t * 4;
      float v = bf16r(gr[0]) * w0 + bf16r(gr[1]) * w1 + bf16r(gr[2]) * w2;
      if (!(__bfloat162float(hv[t * HV + h]) > 0.f)) v = 0.f;
      colsum += v;
      ghv[t * HV + h] = __float2bfloat16_rn(v);
    }
    bpart[OB_V + h] = colsum;
  }
  {
    float x = GSM[(tid & (T - 1)) * 4 + tid / T];  // column tid / 64
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if ((tid & 31) == 0) sm.red[NTHREAD + warp] = x;
    if (tid < T) {  // the bf16 head cotangents [rgb | alpha | 0 x 4]
      const float* gr = GSM + tid * 4;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(gr[0], gr[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(gr[2], gr[3]);
      *reinterpret_cast<uint4*>(wk.gs[net] + (size_t)(t0 + tid) * NGS) =
          make_uint4(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi), 0u, 0u);
    }
  }
  sync_tile();
  if (tid >= NTHREAD - 4) {
    const int c = tid - (NTHREAD - 4);  // rgb 0-2, alpha 3: warps 2c, 2c + 1
    bpart[c < 3 ? OB_R + c : OB_A] =
        sm.red[NTHREAD + 2 * c] + sm.red[NTHREAD + 2 * c + 1];
  }

  // ---- g_feat = g_hv_b @ wvf^T; the views input cotangent g_xv --------
#pragma unroll 1
  for (int b = 0; b < NBLK; ++b) {
    zero_acc<4>(acc);
    ring_mma_g<4, acc_g(ACC_COT)>(rg, acc, sm, ghv, HV, nw);
    colsum_store<4>(acc, bpart + OB_F + b * WB, nw);
    emit_bf16<4>(acc, gf + b * WB, nw, W);
  }
  if constexpr (VF)  // the codes' cotangent alone
    ring_to_global<false, ACC_COT>(rg, ghv, wk.gxv[net] + (size_t)t0 * DXV + DE,
                                   NCODE, nw, DXV, &sm, HV);
  else
    ring_to_global<false, ACC_COT>(rg, ghv, wk.gxv[net] + (size_t)t0 * DXV, DXV,
                                   nw, DXV, &sm, HV);

  // ---- g_a = g_feat_b @ wf^T + bf16(g_alpha) wa; layer D-1's cotangent
#pragma unroll 1
  for (int b = 0; b < NBLK; ++b) {
    zero_acc<4>(acc);
    ring_mma_g<4, acc_g(ACC_COT)>(rg, acc, sm, gf, W, nw);
    const int lane = tid & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = b * WB + nw + j * 8 + 2 * q;
        const float wa0 = __bfloat162float(Wb[G_A + col]);
        const float wa1 = __bfloat162float(Wb[G_A + col + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float ga = bf16r(GSM[(m * 16 + g + 8 * h) * 4 + 3]);
          acc[m][j][2 * h] += ga * wa0;
          acc[m][j][2 * h + 1] += ga * wa1;
        }
      }
    mask_emit(acc, mask(DEPTH - 1, b), bpart + (DEPTH - 1) * W + b * WB,
              gp + (DEPTH - 1) * W + b * WB, nw, LA);
  }

  // ---- the trunk in reverse ----------------------------------------
  float* gx = wk.gx[net] + (size_t)t0 * DXP;
#pragma unroll 1
  for (int i = DEPTH - 1; i >= 1; --i) {
    if (HAS_SKIP && i == SKIP + 1)
      ring_to_global<false, ACC_COT>(rg, gp + i * W, gx, DXP, nw, DXP, &sm,
                                     LA);
#pragma unroll 1
    for (int b = 0; b < NBLK; ++b) {
      zero_acc<4>(acc);
      ring_mma_g<4, acc_g(ACC_COT)>(rg, acc, sm, gp + i * W, LA, nw);
      mask_emit(acc, mask(i - 1, b), bpart + (i - 1) * W + b * WB,
                gp + (i - 1) * W + b * WB, nw, LA);
    }
  }
  // layer 0's part: added to the skip layer's, where there is one
  ring_to_global<HAS_SKIP, ACC_COT>(rg, gp, gx, DXP, nw, DXP, &sm, LA);
  sync_tile();  // the next net may take every buffer
}
#endif

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
// The point axis is cut into P slices of `slice` points (a multiple of
// T), P chosen by the host (ops/fused_mlp.py dw_plan) so that the output
// tiles times P fill the card several times over.  dw_kernel: one block
// per 128 x 128 output tile and slice, 8 warps of 64 x 32, writes the
// tile's f32 partial sum over its slice to the workspace `part` (P
// copies of the dW layout).  Each step stages 32 points of A and G in
// shared memory as they lie in device memory (point-major rows, 16-byte
// copies; the next step's rows wait in registers meanwhile), and
// ldmatrix.trans turns them into the mma fragments of the
// point-contracted product.  dw_sum_kernel then adds the P partials of
// each element in slice order: no atomics, the same bits every call.
constexpr int DW_TM = 128, DW_TN = 128, DW_TK = 32, DW_LD = 128 + 8;
constexpr int MAX_JOBS = 2 * (DEPTH + 6);  // two nets' jobs

struct DwJob {
  const bf16* a;
  const bf16* g;
  size_t off;              // the result's offset in the dW layout
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

// block (tile blockIdx.x, slice blockIdx.y): part[slice][off + M x N] =
// the tile's sum over points slice * blockIdx.y .. min(np, + slice) - 1
__global__ void __launch_bounds__(NTHREAD)
dw_kernel(const DwJobs jobs, float* __restrict__ part, size_t total, int np,
          int slice) {
  __shared__ __align__(16) bf16 As[DW_TK * DW_LD];   // [point][m]
  __shared__ __align__(16) bf16 Gs[DW_TK * DW_LD];   // [point][n]
  int ji = 0;
  while (ji + 1 < jobs.njobs && (int)blockIdx.x >= jobs.first_tile[ji + 1]) ++ji;
  const DwJob jb = jobs.job[ji];
  const int tiles_n = (jb.ncols + DW_TN - 1) / DW_TN;
  const int tile = blockIdx.x - jobs.first_tile[ji];
  const int m0 = (tile / tiles_n) * DW_TM, n0 = (tile % tiles_n) * DW_TN;
  const int kb = blockIdx.y * slice, ke = min(np, kb + slice);
  float* out = part + blockIdx.y * total + jb.off;
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
  dw_load(va, jb.a, jb.lda, jb.m, m0, kb);
  dw_load(vg, jb.g, jb.ldg, jb.ncols, n0, kb);
  for (int k0 = kb; k0 < ke; k0 += DW_TK) {
    dw_store(As, va);
    dw_store(Gs, vg);
    __syncthreads();
    if (k0 + DW_TK < ke) {
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
          out[(size_t)row * jb.ncols + col] = acc[mi][nt][e];
      }
}

// dw[i] = part[0][i] + part[1][i] + ... + part[P-1][i], 4 elements a
// thread
__global__ void __launch_bounds__(256)
dw_sum_kernel(const float4* __restrict__ part, float4* __restrict__ dw,
              size_t total4, int P) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int p = 1; p < P; ++p) {
      const float4 v = part[(size_t)p * total4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    dw[i] = s;
  }
}

void add_job(DwJobs& js, int& tiles, const bf16* a, int lda, int m,
             const bf16* g, int ldg, int ncols, size_t off) {
  DwJob& jb = js.job[js.njobs];
  jb.a = a;
  jb.g = g;
  jb.off = off;
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
// db (nnet, BSZ), dw (nnet, WGSZ; with viewfac, all but the views
// input's rows past the codes' and before them), through the dW partials `part`
// (P x nnet x WGSZ f32) of P slices of `slice` points.  Returns the
// first launch error; cudaErrorInvalidValue where slice is not a
// positive multiple of T or P is not the slices' count.
cudaError_t launch_grads(const Work& wk, int nnet, float* dw, float* db,
                         float* part, int P, int slice, int np,
                         cudaStream_t st, bool viewfac = false) {
  if (slice <= 0 || slice % T != 0 || P != (np + slice - 1) / slice)
    return cudaErrorInvalidValue;
  bias_kernel<<<(nnet * BSZ + 255) / 256, 256, 0, st>>>(wk, db, np / T, nnet);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  DwJobs js{};
  int tiles = 0;
  for (int k = 0; k < nnet; ++k) {
    const size_t o = (size_t)k * WGSZ;
    const bf16* act = wk.act[k];
    const bf16* gp = wk.gp[k];
    const int LA = DEPTH * W;
    add_job(js, tiles, wk.x, DXP, DXP, gp, LA, W, o);
    for (int i = 1; i < DEPTH; ++i)
      add_job(js, tiles, act + (i - 1) * W, LA, W, gp + i * W, LA, W,
              o + off_h(i));
    if (HAS_SKIP)
      add_job(js, tiles, wk.x, DXP, DXP, gp + (SKIP + 1) * W, LA, W,
              o + OFF_SKIPX);
    add_job(js, tiles, act + (DEPTH - 1) * W, LA, W, wk.gs[k] + 3, NGS, 1,
            o + G_A);
    add_job(js, tiles, act + (DEPTH - 1) * W, LA, W, wk.gf[k], W, W, o + G_F);
    add_job(js, tiles, wk.feat[k], W, W, wk.ghv[k], HV, HV, o + G_VF);
    if (viewfac)  // the codes' rows (viewfac.cu's fold writes xv's)
      add_job(js, tiles, wk.xv[k] + DE, DXV, NCODE, wk.ghv[k], HV, HV,
              o + G_VX + (size_t)DE * HV);
    else
      add_job(js, tiles, wk.xv[k], DXV, DXV, wk.ghv[k], HV, HV, o + G_VX);
    add_job(js, tiles, wk.hv[k], HV, HV, wk.gs[k], NGS, 3, o + G_R);
  }
  const size_t total = (size_t)nnet * WGSZ;
  dw_kernel<<<dim3(tiles, P), NTHREAD, 0, st>>>(js, part, total, np, slice);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dw_sum_kernel<<<(int)((total / 4 + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(dw),
      total / 4, P);
  return cudaGetLastError();
}

}  // namespace
