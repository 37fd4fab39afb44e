// The MLP forward of one 64-point tile, shared by the forward kernels
// (encmlp_fwd.cu: K1, K2; mlp_fwd.cu: K5): its schedule on the weight
// ring (ring.cuh), its shared memory, and the warpgroup products.  Each
// .cu file includes it once; everything here has internal linkage.
//
// Threads: two consumer warpgroups (warps 0-7) and the ring's producer
// warp.  Every product is wgmma.mma_async m64nNk16 (bf16 operands, f32
// accumulators in registers): warpgroup g takes half of a block of a
// layer's output columns (N = 128 of a 256-column block of a trunk
// layer, HV / 2 of the views layer) for all 64 rows.  A comes from registers: warp w of a
// warpgroup loads rows 16w .. 16w+15 of the tile's activations with
// ldmatrix from the padded row-major buffers (X, XV, H0, H1), the
// fragment of mma.m16n8k16's A.  B is the ring stage as the TMA laid it
// down (K-major 64-byte rows, 64-byte swizzle), read through a shared-
// memory matrix descriptor; a stage is released, by each warp's arrival
// on its empty barrier, as soon as wgmma.wait_group shows that the
// products reading it have completed.  (Keeping one group in flight
// across stages instead holds two stages per warp, so the producer runs
// a stage less ahead; on the card that measured slower, PERF.md §6.)
//
// Shared memory: the ring (4 stages of 16 KB, 3 at W = 512), X (T, LDX;
// or, for a trunk input too wide to stay, XCH of its columns at a
// time), and one region
// that holds the views input XV (T, LDXV; or, for a views input too
// wide to stay, XCH of its columns at a time) and then the two
// activation buffers H0, H1 (T, LDH) over it.  XV feeds one product, the
// views layer's views-input part, so that product runs first, right
// after the encode, into its own f32 accumulators that stay in registers
// through the trunk; the feat part adds into them at the end.  (The
// views layer thus sums its two parts in the other order than the plain
// twin.)  K2
// encodes the views input again for its second net, from the windows
// kept in shared memory.
#pragma once
#include "ring.cuh"

namespace {

// ---- the forward's schedule on the ring -----------------------------------
// The segments of one net in the order the tile's forward consumes them.
// Up to 512 wide (mlp_fwd_tile): the views layer's views-input part (A =
// XV), layer 0 (A = X), layers 1 .. DEPTH-1 (A = h; the skip layer's x
// part after its h part), the feature layer, the views layer's feat part
// (A = feat).  WIDE (mlp_fwd_tile_wide): the trunk and the feature layer
// the same way, then the views layer in blocks of 128 outputs, each its
// views-input part and its feat part.  Every layer of W outputs runs as
// NBLK blocks of 256 output rows, each block's parts in a row.  With
// viewfac (K1, K2), each views-input part streams only its last k-slice:
// the codes (mlp_fwd_tile's note).  fwd_seg computes segment i from its
// index, on the forward pack's five maps (ring.cuh fwd_pack_map).
constexpr int VB = 128;                           // WIDE: views block rows
constexpr int NVB = HV / VB;
static_assert(!WIDE || VB == VF_MC, "viewfac's staging a views block's M");
constexpr int NFSEG = (WIDE ? 2 * NVB : 2) + NBLK * 2 + NTRUNK;

// map k of a net's forward pack, segment i of its schedule; VF:
// viewfac's (K1, K2)
struct FwdPack {
  __host__ __device__ __forceinline__ static constexpr MapSpec map(int k) {
    return fwd_pack_map(k, WIDE ? VB : HV, WIDE ? VB : HV);
  }
};

template <bool VF>
__host__ __device__ __forceinline__ constexpr Seg fwd_seg(int i) {
  typedef FwdPack P;
  constexpr int kb = VF ? VF_KB : 0;
  if (!WIDE) {
    if (i == 0) return seg_on(P::map(M_VX), M_VX, OFF_VX, kb);  // views-input
    --i;                                                        // part
  }
  if (i < NBLK)                                               // layer 0
    return seg_on(P::map(M_X), M_X, (size_t)i * WB * DXP);
  i -= NBLK;
  if (i < NTRUNK) return trunk_seg<P>(i);                     // layers 1 ..
  i -= NTRUNK;
  if (i < NBLK)                                               // feat
    return seg_on(P::map(M_H), M_H, OFF_F + (size_t)i * WB * W);
  i -= NBLK;
  if (!WIDE) return seg_on(P::map(M_VF), M_VF, OFF_VF);       // views: feat
  const size_t v = (size_t)(i / 2);                           // views, by
  return i % 2 == 0                                           // blocks
             ? seg_on(P::map(M_VX), M_VX, OFF_VX + v * VB * DXV, kb)
             : seg_on(P::map(M_VF), M_VF, OFF_VF + v * VB * W);
}
static_assert(WSZ <= MAX_PACK, "a pack's offsets are ints");
static_assert(VF_KB + 8 == DE && DXV - VF_KB >= VF_CW,
              "viewfac's codes slice holds the codes and no view rows but "
              "the 8 it masks");

// ---- shared memory --------------------------------------------------------
// the ring (1024-byte aligned for the swizzle), its barriers, X, then up
// to 512 wide the XV / H0 H1 region (K1/K2 add the windows (T, J) and
// the ray slots after it: SMEM_ADD), WIDE the views input XV and a
// buffer C of XCH columns for the A operands read back from device
// memory.  X is the whole trunk input (T, LDX) where that fits in a
// block's 227 KB with the kernel's additions, else a buffer of XCH
// columns that its products refill (ring_wgmma_x), and then C too.  XV
// is the whole views input (T, LDXV) where that fits beside the ring and
// a buffer of X (FWD_XV_RESIDENT), else its product refills XCH columns
// at a time (ring_wgmma_xv): up to 512 wide in the XV region, which then
// holds H0 and H1 alone, WIDE in C, the XV region then empty.  The ring
// has 4 stages, 3 at W = 512, whose two (T, 520) activation buffers
// leave no room for a fourth beside the trunk input's column buffer
// (the buffer cannot share the activations' room: the skip layer reads
// both); WIDE 4, or 3 where a resident X needs the room (the kernel's
// additions counted).  K1/K2's WIDE XV region holds at least viewfac's
// codes k-slice (T, LDCV), M's staging going to C a views block at a
// time (mlp_fwd_tile_wide).
constexpr int LDCV = VF_CW + 8;
constexpr size_t xh_elems(bool xvres) {
  return WIDE ? (size_t)T * (xvres ? LDXV : ENC_KERNEL ? LDCV : 0)
              : (size_t)T * (xvres && LDXV > 2 * LDH ? LDXV : 2 * LDH);
}
constexpr size_t fwd_smem_bytes(int nstage, bool xres, bool xvres = true) {
  return 1024 + sizeof(bf16) * (size_t)nstage * STAGE +
         sizeof(uint64_t) * 16 +
         sizeof(bf16) * ((size_t)T * (xres ? LDX : LDC) + xh_elems(xvres) +
                         (WIDE && xres ? (size_t)T * LDC : 0));
}
constexpr int FWD_NSTAGE =
    !WIDE ? (W == 512 ? 3 : 4)
    : fwd_smem_bytes(4, true) + SMEM_ADD <= SMEM_MAX ? 4
    : fwd_smem_bytes(3, true) + SMEM_ADD <= SMEM_MAX ? 3 : 4;
// the views input stays where it fits beside a buffer of X (so every
// shape whose views input stayed before keeps its bits), then X where it
// fits beside what the views input takes
constexpr bool FWD_XV_RESIDENT =
    fwd_smem_bytes(FWD_NSTAGE, false, true) + SMEM_ADD <= SMEM_MAX;
constexpr bool FWD_X_RESIDENT =
    fwd_smem_bytes(FWD_NSTAGE, true, FWD_XV_RESIDENT) + SMEM_ADD <= SMEM_MAX;
constexpr int LDXF = FWD_X_RESIDENT ? LDX : LDC;
constexpr size_t XH_ELEMS = xh_elems(FWD_XV_RESIDENT);
constexpr size_t SMEM_FWD =
    fwd_smem_bytes(FWD_NSTAGE, FWD_X_RESIDENT, FWD_XV_RESIDENT);
static_assert(2 * FWD_NSTAGE <= 16, "the barriers' room");

// the forward's schedule; VF: viewfac's (K1, K2)
template <bool VF>
struct FwdSchedT {
  static constexpr int N = NFSEG;
  static constexpr int NMAP = NMAP_FWD;
  static constexpr int NSTAGE = FWD_NSTAGE;
  __host__ __device__ __forceinline__ static constexpr MapSpec map(int k) {
    return FwdPack::map(k);
  }
  __host__ __device__ __forceinline__ static constexpr Seg seg(int i) {
    return fwd_seg<VF>(i);
  }
  __device__ __forceinline__ static Seg at(int i);
};
typedef FwdSchedT<false> FwdSched;

// the schedules' tables (ring.cuh seg_table)
__constant__ Segs<in_const(NFSEG)> FSEGS_C =
    seg_table<FwdSchedT<false>, in_const(NFSEG)>();
__constant__ Segs<in_const(NFSEG)> FSEGS_VF_C =
    seg_table<FwdSchedT<true>, in_const(NFSEG)>();
__device__ Segs<in_global(NFSEG)> FSEGS_G =
    seg_table<FwdSchedT<false>, in_global(NFSEG)>();
__device__ Segs<in_global(NFSEG)> FSEGS_VF_G =
    seg_table<FwdSchedT<true>, in_global(NFSEG)>();

template <bool VF>
__device__ __forceinline__ Seg FwdSchedT<VF>::at(int i) {
  if constexpr (NFSEG <= SEG_CACHE)
    return VF ? FSEGS_VF_C.s[i] : FSEGS_C.s[i];
  else
    return VF ? FSEGS_VF_G.s[i] : FSEGS_G.s[i];
}

// The schedule covers the forward pack's matrices (everything before
// the head vectors at OFF_A) exactly once: weight blocks of the forward
// pack, inside [0, OFF_A), pairwise disjoint, summing to OFF_A.
static_assert(covers<FwdSchedT<false>>(0, WSZ, OFF_A, 0, 0, OFF_A),
              "the forward schedule must cover the forward pack once");
static_assert(fwd_seg<true>(0).kb == (WIDE ? 0 : VF_KB) &&
                  fwd_seg<true>(NFSEG - 2).kb == (WIDE ? VF_KB : 0),
              "viewfac's views-input parts stream the codes' slice");

// each net's pack maps (a kernel parameter, MAXMAP a net)
struct FwdMaps {
  CUtensorMap seg[2][MAXMAP];
};

// The descriptors of `nnet` nets' forward packs wf (WSZ each).
cudaError_t make_fwd_maps(FwdMaps& mp, const bf16* wf, int nnet) {
  EncodeTiled enc;
  const cudaError_t err = tensor_map_encoder(&enc);
  if (err != cudaSuccess) return err;
  mp = FwdMaps{};
  MapSpec spec[NMAP_FWD];
  for (int k = 0; k < NMAP_FWD; ++k) spec[k] = FwdPack::map(k);
  for (int net = 0; net < nnet; ++net)
    if (!encode_maps(enc, mp.seg[net], spec, NMAP_FWD,
                     wf + (size_t)net * WSZ, WSZ, nullptr, 0))
      return cudaErrorInvalidValue;
  return cudaSuccess;
}


typedef Ring<FwdSched> FwdRing;

struct FwdSmem {
  bf16* ring;
  uint64_t* bars;   // the ring's full and empty barriers
  bf16* X;
  bf16* XV;         // the views input (or its column buffer), then (up to
                    // 512 wide) H0, H1 over it
  bf16* H0;
  bf16* H1;
  bf16* C;          // WIDE: the A operands' column buffer
  float* end;       // what a kernel adds after the forward's own
};

__device__ __forceinline__ FwdSmem fwd_smem(unsigned char* base) {
  FwdSmem s;
  const uint32_t pad = (1024u - (smem_addr(base) & 1023u)) & 1023u;
  s.ring = reinterpret_cast<bf16*>(base + pad);
  s.bars = reinterpret_cast<uint64_t*>(s.ring + FWD_NSTAGE * STAGE);
  s.X = reinterpret_cast<bf16*>(s.bars + 16);
  s.XV = s.X + T * LDXF;
  s.H0 = s.XV;
  s.H1 = s.H0 + T * LDH;
  s.C = FWD_X_RESIDENT ? s.XV + XH_ELEMS : s.X;
  s.end = reinterpret_cast<float*>(s.XV + XH_ELEMS +
                                   (WIDE && FWD_X_RESIDENT ? T * LDC : 0));
  return s;
}

// viewfac (K1/K2): the codes' k-slice (T, LDCV) and the staging of M and
// xw in the XV region; WIDE the codes' slice there and the staging of a
// views block's columns of M in C
static_assert(WIDE ? !ENC_KERNEL || (T * LDCV <= (int)XH_ELEMS &&
                                     VF_STAGE <= T * LDC)
                   : T * LDCV + VF_STAGE <= (int)XH_ELEMS,
              "viewfac's operands in the XV region");

// WIDE: the device-memory activations of one block: two (T, W) buffers
// and hv (T, HV), bf16
constexpr size_t FWD_WORK_ELEMS = WIDE ? (size_t)T * (2 * W + HV) : 0;

// ---- warpgroup products ---------------------------------------------------
// A shared-memory matrix descriptor of a K-major B operand with the
// 64-byte swizzle: start address >> 4 (bits 0-13), leading offset 1
// (unused by a swizzled K-major operand), stride between 8-row groups
// 512 bytes >> 4 (bits 32-45), layout 64-byte swizzle (2 in bits 62-63).
__device__ __forceinline__ uint64_t wg_desc(const bf16* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFFu) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(512 >> 4) << 32 | (uint64_t)2 << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int NJ>
__device__ __forceinline__ void fence_acc(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

#define WG_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d = A (64 x 16, registers) @ B (16 x 128, descriptor) + (scale_d ? d :
// 0), per warpgroup
__device__ __forceinline__ void wgmma_acc(float (&d)[16][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4), WG_D4(5),
        WG_D4(6), WG_D4(7), WG_D4(8), WG_D4(9), WG_D4(10), WG_D4(11),
        WG_D4(12), WG_D4(13), WG_D4(14), WG_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// the same with B (16 x 64, descriptor)
__device__ __forceinline__ void wgmma_acc(float (&d)[8][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_D4(0), WG_D4(1), WG_D4(2), WG_D4(3), WG_D4(4), WG_D4(5),
        WG_D4(6), WG_D4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}
#undef WG_D4

template <int NJ>
__device__ __forceinline__ void zero_wg(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
}

// How a stage's sums reach the accumulators: K1/K2's deep builds
// (ENC_DEEP, encmlp_common.cuh) sum each stage's two k16 products from
// zero into a second accumulator and add it to d rounded to nearest
// (the tensor cores add into the accumulator they are given with
// truncation, and at 24 layers of 512 and 12 of 2048 the chain's drift
// puts the raw outputs outside the f64 rule, chip_smoke.
// _check_close_f64); every other build, K5's all, chains the products
// into d.  scripts/check_k6_f64.py --acc-group fwd=chain builds a
// source copy with this line replaced.
constexpr bool FWD_RN = ENC_DEEP;

// d += A[0:64, k_lo:k_hi] @ Wseg[g 8NJ : (g+1) 8NJ, k_lo:k_hi]^T over the
// ring's stages of k-slices k_lo .. k_hi - 1 of the current segment, for
// warpgroup g = this thread's: NJ = 16 (N = 128) of a 256-row segment,
// NJ = 8 (N = 64) of a 128-row one.  A: shared, row-major, stride lda
// (16-byte aligned rows), its column 0 at k_lo; k_lo a multiple of KS,
// k_hi a multiple of 16.  Per stage: this warp's A fragments (two k16
// steps, one in a ragged last stage such as K = 432's), the wait for the
// stage's bytes, two wgmma, one commit, the wait for them, and this
// warp's release of the stage (FWD_RN: then the stage's sum added).
template <class SC, int NJ>
__device__ __forceinline__ void wgmma_slices(Ring<SC>& r, float (&d)[NJ][4],
                                             const bf16* A, int lda, int k_lo,
                                             int k_hi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // ldmatrix rows of this warp's A fragment: rows 16 (warp % 4) + 0-15,
  // k 0-7 (lanes 0-15) and 8-15 (lanes 16-31)
  const bf16* arow =
      A + (16 * (warp & 3) + (lane & 15)) * lda + (lane >> 4) * 8;
  // warpgroup g's rows start g * 8NJ rows (64 bytes each) into a stage
  const uint32_t b_off = (uint32_t)(warp >> 2) * NJ * 8 * KS * sizeof(bf16);
  float t[FWD_RN ? NJ : 1][4];  // FWD_RN: a stage's sum
  if constexpr (FWD_RN) zero_wg(t);
  fence_acc(d);
  for (int k0 = k_lo; k0 < k_hi; k0 += KS) {
    const bool two = k0 + 16 < k_hi;
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, arow + (k0 - k_lo));
    if (two) ldsm_x4(a1, arow + (k0 - k_lo) + 16);
    mbar_wait(r.full + r.c_slot, r.c_phase);
    const uint64_t desc = wg_desc(r.buf + r.c_slot * STAGE) + (b_off >> 4);
    wg_fence();
    if constexpr (FWD_RN) {
      fence_acc(t);
      wgmma_acc(t, a0, desc, 0);
      if (two) wgmma_acc(t, a1, desc + (16 * sizeof(bf16) >> 4));
    } else {
      wgmma_acc(d, a0, desc);
      if (two) wgmma_acc(d, a1, desc + (16 * sizeof(bf16) >> 4));
    }
    wg_commit();
    wg_wait<0>();
    ring_release(r, r.c_slot);
    ring_advance(r);
    if constexpr (FWD_RN) {
      fence_acc(t);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][e] = __fadd_rn(d[j][e], t[j][e]);
    }
  }
  fence_acc(d);
}

// d += A[0:64, kb:K] @ Wseg^T over the ring's next segment (wgmma_slices),
// A's column 0 at the segment's first k-slice kb
template <class SC, int NJ>
__device__ __forceinline__ void ring_wgmma(Ring<SC>& r, float (&d)[NJ][4],
                                           const bf16* A, int lda) {
  const Seg s = ring_next_seg(r);
  wgmma_slices(r, d, A, lda, s.kb, s.K);
}

// Where the trunk input does not stay resident, its source: the split
// parts (K5: Parts, load_cols) or the rows that K1/K2's encode wrote to
// device memory (XRows: the tile's first row, stride DXP, every one of
// its T rows written).  x_cols brings columns c0 .. c1-1 of the tile's
// rows into dst (stride LDXF); leaves the block unsynchronised.
struct XRows {
  const bf16* x;
};

__device__ __forceinline__ void x_cols(const Parts& xs, bf16* dst, int c0,
                                       int c1, int t0, int n) {
  load_cols(xs, dst, LDXF, c0, c1, t0, n);
}

// 16 bytes a load, from L2 (ld.global.cg): the block wrote these rows
// itself earlier in the same kernel
__device__ __forceinline__ void x_cols(const XRows& xs, bf16* dst, int c0,
                                       int c1, int, int) {
  const int per_row = (c1 - c0) / 8;
  for (int idx = threadIdx.x; idx < T * per_row; idx += NTHREAD) {
    const int t = idx / per_row, c = (idx - t * per_row) * 8;
    *reinterpret_cast<uint4*>(dst + t * LDXF + c) = __ldcg(
        reinterpret_cast<const uint4*>(xs.x + (size_t)t * DXP + c0 + c));
  }
}

// d += X @ Wseg^T over the ring's next segment, whose A operand is the
// trunk input X: resident in sm.X, or, where it does not fit, brought
// from its source xs (x_cols) into sm.X XCH columns at a time between
// two barriers of the consumer warps (the producer runs on ahead).
template <class SC, int NJ, class XS>
__device__ __forceinline__ void ring_wgmma_x(Ring<SC>& r, float (&d)[NJ][4],
                                             const FwdSmem& sm, const XS* xs,
                                             int t0, int n) {
  if constexpr (FWD_X_RESIDENT) {
    ring_wgmma(r, d, sm.X, LDXF);
  } else {
    const Seg s = ring_next_seg(r);
    for (int c0 = 0; c0 < s.K; c0 += XCH) {
      const int c1 = min(c0 + XCH, s.K);
      sync_tile();  // every warp is past its reads of the last columns
      x_cols(*xs, sm.X, c0, c1, t0, n);
      sync_tile();
      wgmma_slices(r, d, sm.X, LDXF, c0, c1);
    }
  }
}

// Where the views input does not stay resident (FWD_XV_RESIDENT), its
// source: the split parts (K5: Parts, load_cols) or the view rows,
// windows and codes that K1/K2 build it from (XvEnc, encode_views).
// xv_cols brings columns c0 .. c1-1 of the tile's rows into dst (stride
// LDC); leaves the block unsynchronised.
__device__ __forceinline__ void xv_cols(const Parts& xvs, bf16* dst, int c0,
                                        int c1, int t0, int n) {
  load_cols(xvs, dst, LDC, c0, c1, t0, n);
}

__device__ __forceinline__ void xv_cols(const XvEnc& xe, bf16* dst, int c0,
                                        int c1, int t0, int n) {
  encode_views(xe, dst, LDC, c0, c1, t0, n);
}

// d += XV @ Wseg^T over the ring's next segment, whose A operand is the
// views input: resident in sm.XV, or, where it does not fit, brought
// from its source xvs (xv_cols) XCH columns at a time between two
// barriers of the consumer warps into the XV region (up to 512 wide,
// before H0 and H1 take it) or sm.C (WIDE).  The sums run in the same
// order either way.  (Viewfac's codes slice always stays resident.)
template <class SC, int NJ, class XVS>
__device__ __forceinline__ void ring_wgmma_xv(Ring<SC>& r, float (&d)[NJ][4],
                                              const FwdSmem& sm,
                                              const XVS* xvs, int t0,
                                              int n) {
  if constexpr (FWD_XV_RESIDENT) {
    ring_wgmma(r, d, sm.XV, LDXV);
  } else {
    bf16* buf = WIDE ? sm.C : sm.XV;
    const Seg s = ring_next_seg(r);
    for (int c0 = 0; c0 < s.K; c0 += XCH) {
      const int c1 = min(c0 + XCH, s.K);
      sync_tile();  // every warp is past its reads of the last columns
      xv_cols(*xvs, buf, c0, c1, t0, n);
      sync_tile();
      wgmma_slices(r, d, buf, LDC, c0, c1);
    }
  }
}

// d += A @ Wseg^T over the ring's next segment, A (T rows, row stride
// lda) in device memory, brought into sm.C XCH columns at a time between
// two barriers of the consumer warps (WIDE)
template <class SC, int NJ>
__device__ __forceinline__ void ring_wgmma_g(Ring<SC>& r, float (&d)[NJ][4],
                                             const FwdSmem& sm,
                                             const bf16* A, int lda) {
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
    wgmma_slices(r, d, sm.C, LDC, c0, c1);
  }
}

// out[row, col] = bf16(act(d + bias[col])) for this warpgroup's columns
// from n0 (row stride ldo, shared or device memory): d[j][e] holds row
// 16 w + lane / 4 (+8 for e >= 2) of warp w of the warpgroup, column
// n0 + 8 j + 2 (lane % 4) (+1 for odd e)
template <int NJ, bool RELU>
__device__ __forceinline__ void store_wg(const float (&d)[NJ][4],
                                         const float* __restrict__ bias,
                                         bf16* out, int n0, int ldo = LDH) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + j * 8 + 2 * q;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
    float v0 = d[j][0] + b0, v1 = d[j][1] + b1;
    float v2 = d[j][2] + b0, v3 = d[j][3] + b1;
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

// the alpha head (f32 dot, 4 lanes per point) of the last activation h
// (row stride ld) to channel 3
__device__ __forceinline__ void alpha_head(const bf16* h, int ld,
                                           const bf16* __restrict__ Wn,
                                           const float* __restrict__ Bn,
                                           float* __restrict__ out, size_t cs,
                                           size_t ps, int t0, int n) {
  const int t = threadIdx.x >> 2, part = threadIdx.x & 3;
  const bf16* hr = h + t * ld + part * (W / 4);
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

// the rgb head (f32 dot) of hv (row stride ld) to channels 0-2
__device__ __forceinline__ void rgb_head(const bf16* hv, int ld,
                                         const bf16* __restrict__ Wn,
                                         const float* __restrict__ Bn,
                                         float* __restrict__ out, size_t cs,
                                         size_t ps, int t0, int n) {
  static_assert(NTHREAD >= T * 3, "one thread per point and channel");
  const int tid = threadIdx.x;
  if (tid < T * 3) {
    const int t = tid / 3, ch = tid - t * 3;
    const bf16* hr = hv + t * ld;
    const bf16* wr = Wn + OFF_R + ch * HV;
    float sum = 0.f;
#pragma unroll 8
    for (int k = 0; k < HV; ++k)
      sum += __bfloat162float(hr[k]) * __bfloat162float(wr[k]);
    if (t0 + t < n) out[ch * cs + (size_t)(t0 + t) * ps] = sum + __ldg(Bn + OB_R + ch);
  }
}

#if !ANERF_WIDE
// ---- the MLP forward of one 64-point tile, up to 512 wide ----------------
// X (the trunk input, where it stays resident; else xs, its source:
// x_cols) and
// XV (the views input, where it stays resident; else xvs, its source:
// xv_cols) complete in shared memory and the consumers
// synchronised; the ring's schedule at the net's first
// segment.  Wn/Bn = one net's packed weights and biases (the heads'
// vectors are read from Wn directly).  Writes channel ch of point
// t0 + t < n to out[ch * cs + (t0 + t) * ps]: (cs, ps) = (n, 1) for
// K1/K2's channel-major rows, (1, 4) for K5's row-major [rgb, alpha].
// A layer of W outputs runs as NBLK blocks of 256 columns, each over
// the whole A operand (warpgroup g takes 128 columns of a block).
// VF (viewfac, K1/K2): the XV region holds the codes' k-slice [0 x 8 |
// codes | 0 x 8] as (T, LDCV) and after it M and xw (vf_stage), and the
// views-input part is that slice's product plus xw @ M (vf_xw_m).
// Run by the consumer warps; ends with them synchronised, past every
// read of the region that holds XV.
template <bool VF, class XS = Parts, class XVS = Parts>
__device__ __forceinline__ void mlp_fwd_tile(Ring<FwdSchedT<VF>>& rg,
                                             const FwdSmem& sm,
                                             const bf16* __restrict__ Wn,
                                             const float* __restrict__ Bn,
                                             float* __restrict__ out,
                                             size_t cs, size_t ps, int t0,
                                             int n,
                                             const XS* xs = nullptr,
                                             const XVS* xvs = nullptr) {
  const int tid = threadIdx.x, wg = tid >> 7;
  constexpr int NJV = HV / 16;  // the views layer: HV / 2 columns a group
  // ---- the views layer's views-input part, before the trunk ------------
  float dv[NJV][4];
  zero_wg(dv);
  if constexpr (VF) {
    ring_wgmma(rg, dv, sm.XV, LDCV);
    vf_xw_m<NJV>(dv, sm.XV + T * LDCV, 16 * ((tid >> 5) & 3), wg * (HV / 2));
  } else {
    ring_wgmma_xv(rg, dv, sm, xvs, t0, n);
  }

  // ---- density trunk -----------------------------------------------------
  float d[16][4];
#pragma unroll 1
  for (int b = 0; b < NBLK; ++b) {
    zero_wg(d);
    ring_wgmma_x(rg, d, sm, xs, t0, n);
    if (b == 0) sync_tile();  // every warp is past its reads of XV,
                              // which H0 overlays
    store_wg<16, true>(d, Bn, sm.H0, b * WB + wg * 128);
  }
  sync_tile();
  bf16* hin = sm.H0;
  bf16* hout = sm.H1;
#pragma unroll 1
  for (int i = 1; i < DEPTH; ++i) {
#pragma unroll 1
    for (int b = 0; b < NBLK; ++b) {
      zero_wg(d);
      ring_wgmma(rg, d, hin, LDH);
      if (HAS_SKIP && i == SKIP + 1) ring_wgmma_x(rg, d, sm, xs, t0, n);
      store_wg<16, true>(d, Bn + i * W, hout, b * WB + wg * 128);
    }
    sync_tile();
    bf16* tmp = hin;
    hin = hout;
    hout = tmp;
  }

  // ---- alpha head and feature layer -------------------------------------
  alpha_head(hin, LDH, Wn, Bn, out, cs, ps, t0, n);
#pragma unroll 1
  for (int b = 0; b < NBLK; ++b) {
    zero_wg(d);
    ring_wgmma(rg, d, hin, LDH);
    store_wg<16, false>(d, Bn + OB_F, hout, b * WB + wg * 128);  // feat
  }
  sync_tile();

  // ---- views layer: + feat part, ReLU -------------------------------------
  ring_wgmma(rg, dv, hout, LDH);
  store_wg<NJV, true>(dv, Bn + OB_V, hin, wg * (HV / 2));
  sync_tile();

  // ---- rgb head ------------------------------------------------------------
  rgb_head(hin, LDH, Wn, Bn, out, cs, ps, t0, n);
  sync_tile();
}
#else
// ---- the MLP forward of one 64-point tile, WIDE -----------------------------
// As mlp_fwd_tile, with the activations in device memory: hw, the
// block's FWD_WORK_ELEMS (two (T, W) buffers, then hv (T, HV)).  Each
// trunk block, feat block and views block reads its A operand back XCH
// columns at a time (ring_wgmma_g); the trunk input comes as
// ring_wgmma_x takes it (resident, or from xs); the views layer runs
// last, in NVB blocks of 128 outputs (warpgroup g takes 64), each its
// views-input part from XV (resident in shared memory throughout, or
// brought from xvs XCH columns at a time: ring_wgmma_xv) then its feat
// part, the order of mlp_fwd_tile's sums.  VF (viewfac, K1/K2): XV holds
// the codes' k-slice (T, LDCV) and each views block's views-input part
// is that slice's product plus xw @ M's 128 columns of the block, M's
// rows of the tile's rays (vft) staged into C a block at a time.
template <bool VF, class XS = Parts, class XVS = Parts>
__device__ __forceinline__ void mlp_fwd_tile_wide(
    Ring<FwdSchedT<VF>>& rg, const FwdSmem& sm, const bf16* __restrict__ Wn,
    const float* __restrict__ Bn, float* __restrict__ out, size_t cs,
    size_t ps, int t0, int n, const XS* xs, const XVS* xvs, bf16* hw,
    const VfTile* vft = nullptr) {
  const int wg = threadIdx.x >> 7;
  bf16* hin = hw;
  bf16* hout = hw + T * W;
  bf16* hv = hw + 2 * T * W;
  float d[16][4];
#pragma unroll 1
  for (int b = 0; b < NBLK; ++b) {
    zero_wg(d);
    ring_wgmma_x(rg, d, sm, xs, t0, n);
    store_wg<16, true>(d, Bn, hin, b * WB + wg * 128, W);
  }
  sync_tile();
#pragma unroll 1
  for (int i = 1; i < DEPTH; ++i) {
#pragma unroll 1
    for (int b = 0; b < NBLK; ++b) {
      zero_wg(d);
      ring_wgmma_g(rg, d, sm, hin, W);
      if (HAS_SKIP && i == SKIP + 1) ring_wgmma_x(rg, d, sm, xs, t0, n);
      store_wg<16, true>(d, Bn + i * W, hout, b * WB + wg * 128, W);
    }
    sync_tile();
    bf16* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  alpha_head(hin, W, Wn, Bn, out, cs, ps, t0, n);
#pragma unroll 1
  for (int b = 0; b < NBLK; ++b) {
    zero_wg(d);
    ring_wgmma_g(rg, d, sm, hin, W);
    store_wg<16, false>(d, Bn + OB_F, hout, b * WB + wg * 128, W);  // feat
  }
  sync_tile();
  float dv[8][4];
#pragma unroll 1
  for (int v = 0; v < NVB; ++v) {
    zero_wg(dv);
    if constexpr (VF) {
      sync_tile();  // every warp is past its reads of C
      vf_stage(sm.C, *vft, v * VB);
      sync_tile();
      ring_wgmma(rg, dv, sm.XV, LDCV);
      vf_xw_m<8>(dv, sm.C, 16 * ((threadIdx.x >> 5) & 3), wg * (VB / 2));
    } else {
      ring_wgmma_xv(rg, dv, sm, xvs, t0, n);
    }
    ring_wgmma_g(rg, dv, sm, hout, W);
    store_wg<8, true>(dv, Bn + OB_V, hv, v * VB + wg * (VB / 2), HV);
  }
  sync_tile();
  rgb_head(hv, HV, Wn, Bn, out, cs, ps, t0, n);
  sync_tile();
}
#endif

}  // namespace
