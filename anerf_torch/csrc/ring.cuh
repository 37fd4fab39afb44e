// The weight ring that the MLP kernels of both directions stream their
// weights through (forward: mlp_fwd_common.cuh, K1, K2, K5; backward:
// mlp_bwd_common.cuh, K3, K4, K6).  Each .cu file includes it once;
// everything here has internal linkage.
//
// A stage is one 32-deep k-slice of up to 256 weight rows in shared
// memory: 64-byte rows, K-major, 64-byte swizzled, so that ldmatrix reads
// them without bank conflicts and wgmma reads them as they lie (a K-major
// B operand with 8-row groups 512 bytes apart).  A producer warp, beside
// the 8 consumer warps, fills each stage with one TMA copy
// (cp.async.bulk.tensor) that completes on the stage's full barrier, and
// refills a slot once every consumer warp has arrived on its empty
// barrier; the consumers spend no instruction slots on copies and meet at no
// block barrier per stage.  The stages follow one fixed schedule of
// weight blocks (a Sched: its Seg table, walked net after net), so the
// next product's first slices are in flight while the current one's
// epilogue runs, and each slice crosses L2 once per block.
//
// The copies read a pack through a few tensor maps, not one per block:
// every block of a pack with the same depth K and row count lies on the
// row grid of one (rows, K) view of the pack from some base (the trunk's
// W x W layers, whatever the depth, on one map), so a segment is a map
// and a row coordinate, and the maps a kernel takes as a parameter stay
// a handful at any depth.  A schedule computes each segment from its
// index (mlp_fwd_common.cuh fwd_seg, mlp_bwd_common.cuh bwd_seg) at
// compile time, into one table a kernel reads (seg_table: constant
// memory where it fits, global memory past SEG_CACHE segments), and
// compile-time checks sort the segments once (covers).
#pragma once
#include <cuda.h>  // CUtensorMap and its enums (encoded through the runtime)

#include "encmlp_common.cuh"

namespace {

constexpr int KS = 32;               // k-depth of a stage: 64-byte rows
constexpr int STAGE = WB * KS;       // bf16 a stage: up to 256 rows

// One block of weight rows that the ring streams: `rows` rows of depth K
// at `off` in the forward (pack 0, (out, in) rows) or backward (pack 1,
// (in, out) rows) pack of the net, its k-slices from kb (0, or the last
// slice of a part whose first columns a mode skips) to K; with stream_a,
// the tile's views input (T rows of depth K) rides in each stage after
// the weight rows as the product's A operand.  map and row: the tensor
// map the copies read it through and its first row there.
struct Seg {
  int pack, off, rows, K, stream_a, kb, map, row;
};

// A tensor map over pack `pack` from element `base`: a (rows, K) bf16
// row-major view read in boxes of KS x box rows.
struct MapSpec {
  int pack, base, K, box;
};
constexpr int MAXMAP = 9;    // a net's maps, whatever its depth

// The segment at element `off` of map m (number `map`): box rows of
// depth K, at row (off - base) / K of the map.
__host__ __device__ __forceinline__ constexpr Seg seg_on(
    const MapSpec& m, int map, size_t off, int kb = 0, int stream_a = 0) {
  Seg s{};
  s.pack = m.pack;
  s.off = (int)off;
  s.rows = m.box;
  s.K = m.K;
  s.stream_a = stream_a;
  s.kb = kb;
  s.map = map;
  s.row = (s.off - m.base) / m.K;   // offsets are ints (MAX_PACK)
  return s;
}

// A pack's offsets are ints (Seg::off, MapSpec::base)
constexpr size_t MAX_PACK = 0x7fffffff;

// Maps a TMA copy can read: 16-byte aligned bases and rows, boxes of 1
// to 256 rows
__host__ __device__ constexpr bool map_ok(const MapSpec& m) {
  return m.base >= 0 && m.base % 8 == 0 && m.K % 8 == 0 && m.box >= 1 &&
         m.box <= 256;
}

// Heap sort of the n spans lo[i] .. hi[i] by lo (a compile-time check's
// helper: O(n log n) steps, so it holds at any depth)
constexpr void sort_spans(size_t* lo, size_t* hi, int n) {
  auto sift = [&](int i, int end) {
    for (;;) {
      int c = 2 * i + 1;
      if (c >= end) return;
      if (c + 1 < end && lo[c + 1] > lo[c]) ++c;
      if (lo[c] <= lo[i]) return;
      const size_t tl = lo[c], th = hi[c];
      lo[c] = lo[i];
      hi[c] = hi[i];
      lo[i] = tl;
      hi[i] = th;
      i = c;
    }
  };
  for (int i = n / 2 - 1; i >= 0; --i) sift(i, n);
  for (int end = n - 1; end > 0; --end) {
    const size_t tl = lo[0], th = hi[0];
    lo[0] = lo[end];
    hi[0] = hi[end];
    lo[end] = tl;
    hi[end] = th;
    sift(0, end);
  }
}

// A schedule's segments, computed at compile time into a table
// (seg_table) that a consumer warp reads with one load per segment,
// where decoding each from its index costs K5 at 8 x 256 about a tenth
// of its time in branches (PERF.md §6).  A table of at most SEG_CACHE
// segments lies in constant memory: two a kernel (with viewfac and
// without) stay within its 64 KB.  A longer one (the deepest and widest
// nets: 1,088 forward and 2,135 backward segments at 64 x 4096) lies in
// global memory.
constexpr int SEG_CACHE = 768;

template <int M>
struct Segs {
  Seg s[M];
};

// the size of a table of n segments in constant and in global memory
// (one unused entry in the space it does not take)
constexpr int in_const(int n) { return n <= SEG_CACHE ? n : 1; }
constexpr int in_global(int n) { return n <= SEG_CACHE ? 1 : n; }

// Schedule S's table where it has M entries (else one empty entry)
template <class S, int M>
constexpr Segs<M> seg_table() {
  Segs<M> t{};
  for (int i = 0; M == S::N && i < M; ++i) t.s[i] = S::seg(i);
  return t;
}

// The segments S::seg(0 .. S::N - 1) of schedule S that lie in pack
// `pack` are blocks of it on their maps (S::map(k), each map_ok; every
// row of a segment inside its map's view of a pack of `size` elements),
// pairwise disjoint, inside [0, end) and outside [gap_lo, gap_hi), and
// sum to `total`.
template <class S>
constexpr bool covers(int pack, size_t size, size_t end, size_t gap_lo,
                      size_t gap_hi, size_t total) {
  size_t lo[S::N] = {}, hi[S::N] = {};
  int n = 0;
  size_t sum = 0;
  for (int i = 0; i < S::N; ++i) {
    const Seg s = S::seg(i);
    if (s.map < 0 || s.map >= S::NMAP) return false;
    const MapSpec m = S::map(s.map);
    if (!map_ok(m) || m.pack != s.pack || m.K != s.K || m.box != s.rows ||
        s.kb < 0 || s.kb >= s.K)
      return false;
    const size_t l = (size_t)s.off, h = l + (size_t)s.rows * s.K;
    if (l < (size_t)m.base || (l - m.base) % m.K != 0 ||
        (size_t)s.row != (l - m.base) / m.K ||
        (size_t)s.row + s.rows > (size - m.base) / m.K)
      return false;
    if (s.pack != pack) continue;
    if (h > end || (l < gap_hi && gap_lo < h)) return false;
    lo[n] = l;
    hi[n] = h;
    ++n;
    sum += h - l;
  }
  sort_spans(lo, hi, n);
  for (int i = 1; i < n; ++i)
    if (lo[i] < hi[i - 1]) return false;
  return sum == total;
}

// the trunk's segments after layer 0: layers 1 .. DEPTH-1, the skip
// layer's x part beside its h part
constexpr int NTRUNK = NBLK * (DEPTH - 1 + (HAS_SKIP ? 1 : 0));

// Map k of a net's forward pack (pack 0), whose views layer's feat
// part and views-input part a schedule reads in blocks of vf_rows and
// vx_rows rows: layer 0's blocks (DXP deep); every W-deep block of 256
// rows (the trunk's layers and the feature layer, on one map from the
// pack's start, whatever the depth); the skip layer's x part; the views
// layer's two parts.  Every block of a map has its box's rows.
enum { M_X, M_H, M_SKIPX, M_VF, M_VX, NMAP_FWD };

__host__ __device__ __forceinline__ constexpr MapSpec fwd_pack_map(
    int k, int vf_rows, int vx_rows) {
  return k == M_X       ? MapSpec{0, 0, DXP, WB}
         : k == M_H     ? MapSpec{0, 0, W, WB}
         : k == M_SKIPX ? MapSpec{0, HAS_SKIP ? (int)OFF_SKIPX : 0, DXP, WB}
         : k == M_VF    ? MapSpec{0, (int)OFF_VF, W, vf_rows}
                        : MapSpec{0, (int)OFF_VX, DXV, vx_rows};
}

// segment j of the trunk after layer 0 (j < NTRUNK) on the maps P::map
template <class P>
__host__ __device__ __forceinline__ constexpr Seg trunk_seg(int j) {
  if (HAS_SKIP) {
    constexpr int a = SKIP * NBLK;  // layers 1 .. SKIP
    if (j >= a && j < a + 2 * NBLK) {  // the skip layer: h, x by blocks
      const size_t b = (size_t)((j - a) / 2);
      return (j - a) % 2 == 0
                 ? seg_on(P::map(M_H), M_H, off_h(SKIP + 1) + b * WB * W)
                 : seg_on(P::map(M_SKIPX), M_SKIPX,
                          OFF_SKIPX + b * WB * DXP);
    }
    if (j >= a + 2 * NBLK) j -= NBLK;
  }
  return seg_on(P::map(M_H), M_H,
                off_h(1 + j / NBLK) + (size_t)(j % NBLK) * WB * W);
}

// A schedule S provides S::N segments a net (S::seg(i) computes segment
// i, S::at(i) reads it on the device: from its cache or computed), its
// S::NMAP maps (S::map(k)) and the ring's stage count S::NSTAGE; the
// ring reads MAXMAP maps a net.

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime, so nothing
// links against libcuda
cudaError_t tensor_map_encoder(EncodeTiled* out) {
  static EncodeTiled enc = nullptr;
  if (!enc) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorNotSupported;
    enc = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = enc;
  return cudaSuccess;
}

// a (rows, K) bf16 row-major matrix read in boxes of KS x box_rows, with
// the 64-byte swizzle; columns past K read as zeros (rows past `rows`
// too, but every segment lies inside its pack)
bool encode_2d(EncodeTiled enc, CUtensorMap* m, const void* base, int K,
               int rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t box[2] = {KS, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The `nmap` maps `spec` of one net's packs (forward wf, backward wb; nf
// and nb elements) into out[0 .. nmap): each a view of its pack from its
// base to the pack's end.
inline bool encode_maps(EncodeTiled enc, CUtensorMap* out,
                        const MapSpec* spec, int nmap, const bf16* wf,
                        size_t nf, const bf16* wb, size_t nb) {
  for (int k = 0; k < nmap; ++k) {
    const MapSpec& m = spec[k];
    const size_t rows = ((m.pack ? nb : nf) - (size_t)m.base) / m.K;
    if (!encode_2d(enc, out + k, (m.pack ? wb : wf) + m.base, m.K, (int)rows,
                   m.box))
      return false;
  }
  return true;
}

// the bf16 offset of 16-byte chunk ch (0-3) of row `row` in a stage: the
// TMA's 64-byte swizzle (chunk bits XOR address bits 7-8), so ldmatrix
// reads 8 rows of one chunk column without bank conflicts
__device__ __forceinline__ int swz(int row, int ch) {
  return row * KS + ((ch ^ ((row >> 1) & 3)) << 3);
}

// Wait until the barrier's phase `parity` has completed.  A lost copy
// would hang the card, so a wait of seconds traps instead.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1u << 26)) __trap();
  }
}

// the consumer warps' barrier (named barrier 1): the producer warp
// never joins it
__device__ __forceinline__ void sync_tile() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NTHREAD) : "memory");
}

// The ring's state.  The producer warp (threads NTHREAD and up) fills
// the stages in schedule order; the NWARP consumer warps take them in the
// same order.  full[i]: stage i's bytes have landed (the producer's one
// arrival plus the TMA's transaction count); empty[i]: every consumer
// warp has read it.
template <class S>
struct Ring {
  bf16* buf;                  // S::NSTAGE stages in shared memory
  uint64_t* full;
  uint64_t* empty;
  const CUtensorMap* maps;    // nnet x MAXMAP pack descriptors
  const CUtensorMap* xv;      // each net's views input (stream_a), or null
  int nnet, t0;
  int c_seg, c_slot;          // the consumers' next segment and stage
  uint32_t c_phase;           // the phase the consumed slot completes
};

__device__ __forceinline__ void tma_2d(bf16* dst, const CUtensorMap* map,
                                       int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// The producer: one thread walks the whole schedule, net after net;
// before it refills a slot it waits until the consumers have read it,
// then arms the slot's full barrier with the stage's bytes and starts
// one TMA copy (two with the views input).
template <class S>
__device__ __forceinline__ void ring_produce(const Ring<S>& r) {
  if ((threadIdx.x & 31) != 0) return;
  int slot = 0;
  uint32_t phase = 0;
  bool refill = false;        // every slot has been filled once
  for (int net = 0; net < r.nnet; ++net)
    for (int i = 0; i < S::N; ++i) {
      const Seg s = S::at(i);
      const int bytes = (s.rows + (s.stream_a ? T : 0)) * KS * (int)sizeof(bf16);
      for (int k0 = s.kb; k0 < s.K; k0 += KS) {
        if (refill) mbar_wait(r.empty + slot, phase);
        const uint32_t bar = smem_addr(r.full + slot);
        bf16* dst = r.buf + slot * STAGE;
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                bar),
            "r"(bytes)
            : "memory");
        tma_2d(dst, r.maps + net * MAXMAP + s.map, k0, s.row, bar);
        if (s.stream_a) tma_2d(dst + s.rows * KS, r.xv + net, k0, r.t0, bar);
        if (++slot == S::NSTAGE) {
          slot = 0;
          if (refill) phase ^= 1u;
          refill = true;
        }
      }
    }
}

// A ring over `buf` (S::NSTAGE stages, 1024-byte aligned) and its
// barriers `bars` (2 S::NSTAGE) for `nnet` nets of tile t0, reading the
// descriptors `maps` (and `xv`).  Called by all NTHREAD + 32 threads;
// synchronises the block.
template <class S>
__device__ __forceinline__ Ring<S> ring_open(bf16* buf, uint64_t* bars,
                                             const CUtensorMap* maps,
                                             const CUtensorMap* xv,
                                             int nnet, int t0) {
  Ring<S> r;
  r.buf = buf;
  r.full = bars;
  r.empty = bars + S::NSTAGE;
  r.maps = maps;
  r.xv = xv;
  r.nnet = nnet;
  r.t0 = t0;
  r.c_seg = r.c_slot = 0;
  r.c_phase = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::NSTAGE; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(r.full + i))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(r.empty + i)),
                   "n"(NWARP)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The consumers' next segment; the schedule wraps to the next net.
template <class S>
__device__ __forceinline__ Seg ring_next_seg(Ring<S>& r) {
  const Seg s = S::at(r.c_seg);
  r.c_seg = r.c_seg + 1 == S::N ? 0 : r.c_seg + 1;
  return s;
}

// This warp is done with the consumers' current stage: its arrival on
// the stage's empty barrier (lane 0, once the warp has converged), and
// the consumers' next stage.
template <class S>
__device__ __forceinline__ void ring_release(Ring<S>& r, int slot) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_addr(r.empty + slot))
                 : "memory");
}

template <class S>
__device__ __forceinline__ void ring_advance(Ring<S>& r) {
  if (++r.c_slot == S::NSTAGE) {
    r.c_slot = 0;
    r.c_phase ^= 1u;
  }
}

}  // namespace
