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
// and a row coordinate (assign_maps), and the maps a kernel takes as a
// parameter stay a handful at any depth.
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
// map the copies read it through and its first row there (assign_maps).
struct Seg {
  int pack, off, rows, K, stream_a, kb, map, row;
};

// A tensor map over pack `pack` from element `base`: a (rows, K) bf16
// row-major view read in boxes of KS x box rows.
struct MapSpec {
  int pack, base, K, box;
};
constexpr int MAXMAP = 12;   // a net's maps, whatever its depth

// Each segment's map and row: segments of one pack, depth and row count
// whose offsets differ by a multiple of K share a map, based at the
// lowest of them.  Returns the maps' count, or -1 where they exceed
// MAXMAP or a base is not 16-byte aligned.
__host__ __device__ constexpr int assign_maps(Seg* s, int n, MapSpec* m) {
  int nmap = 0;
  for (int i = 0; i < n; ++i) {
    int k = 0;
    for (; k < nmap; ++k)
      if (m[k].pack == s[i].pack && m[k].K == s[i].K &&
          m[k].box == s[i].rows && (s[i].off - m[k].base) % s[i].K == 0)
        break;
    if (k == nmap) {
      if (nmap == MAXMAP) return -1;
      m[k].pack = s[i].pack;
      m[k].base = s[i].off;
      m[k].K = s[i].K;
      m[k].box = s[i].rows;
      ++nmap;
    }
    if (s[i].off < m[k].base) m[k].base = s[i].off;
    s[i].map = k;
  }
  for (int k = 0; k < nmap; ++k)
    if (m[k].base % 8 != 0) return -1;
  for (int i = 0; i < n; ++i)
    s[i].row = (s[i].off - m[s[i].map].base) / s[i].K;
  return nmap;
}

// A schedule S provides S::N segments a net (S::at(i) reads its
// __constant__ table) and the ring's stage count S::NSTAGE; the ring
// reads MAXMAP maps a net.

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
