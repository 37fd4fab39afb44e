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
// Every product is one of bf16 operands with f32 sums, so both kernels
// run them on the tensor cores (mma.sync m16n8k16), with b zero-padded
// to K = 32 (two k-steps).  Joints go in groups of JG = 8: the 8 joints'
// values of one (ray, b) are 32 consecutive bytes of enc and of denc,
// one whole sector, and 8 joints' rows of M or Gw for one ray 2 KB.
//
// K-vf1 (vf_m_mma_kernel): a block per (run of 16-ray tiles, 8 joints,
// net), two a multiprocessor, the tiles of a run Q apart.  The group's
// 27 weight rows a joint (55 KB, cp.async) are staged once; a tile's
// view values (a 32-byte sector a (ray, b), to bf16) load while the
// last tile's products run; warp jj computes E_j (16 rays x 32) @ Wvx_j
// (32 x HV) for its joint into a staging tile that leaves as 16-byte
// stores, 2 KB contiguous a ray: every byte of M written once.  Bound:
// the 30.8 MB it moves at R = 2048 (two nets), 9.2 us at 3.35 TB/s; the
// 0.68 GFLOP take 0.7 us of the tensor cores.
//
// K-vf2 (vf_fold_kernel, vf_fold_sum_kernel): a block per (joint, one
// of P partial sums) holds both nets (denc sums over them) over the
// slices p, p + P, ... of FO_SLICE rays, and a cluster of JG blocks the
// 8 joints of a group over the same slices.  Its rays' Gw of both nets
// streams through a ring of cp.async stages once; per stage of 32 rays
//   dWvx  E_j^T (32 x 16 rays) @ Gw (16 rays x HV): warps 0-3, a net and
//         half the columns each, summed in registers over the slices;
//   denc  Gw (16 rays x 2 HV) @ [Wvx_0; Wvx_1]^T (2 HV x 32): warps 4-7,
//         a 16-ray tile and 16 b each, the nets side by side in K.
// Each (ray, b)'s 8 joints meet in one block's shared memory through the
// cluster (st/ld.shared::cluster), so enc is read and denc written in
// whole sectors: the view values handed over two slices ahead, denc
// handed back one slice behind, under one split cluster barrier a
// slice.  vf_fold_sum_kernel adds the P partials in order (one partial:
// written straight into dWvx).  fused_encmlp.vf_fold_plan picks P: 8 at
// R = 2048, 5.3 MB of partials each way against Gw's 25.2 MB.  No
// atomics: every sum runs in a fixed order, so two calls give the same
// bits.  Bound: the 36.8 MB it must move at R = 2048, 11.0 us.
//
// C interface (loaded with ctypes): every pointer is device memory, the
// stream is PyTorch's current stream; returns cudaGetLastError().
//
// Built per view PE row count NB (1-21: -DANERF_NB, ops/cuda_build.py)
// and views layer width HV (128, or 2 x 128 up to 8 x 128 for a net
// 512-2048 wide: -DANERF_WIDTH), the flagship's 9 and 128 (27 columns, the counts
// above) by default.  Up to 9 rows a joint's NB x 3 view columns fit the
// 32 of two k-steps (KB); past that (11-21 rows, 33-63 columns) K-vf1
// takes them in KB = 48 or 64 (whole k-steps), its staged weights then
// one block a multiprocessor past 11 rows (VM_BLOCKS: 180 KB at 21),
// and K-vf2 takes them in two blocks along a third grid dimension, each
// its even share of the columns in the 32-column block above (FO_NBH,
// FO_NBJ: dWvx and denc are per column), each reading its rays' Gw:
// Gw's 25.2 MB twice at R = 2048.
//
// At HV = 256 the two kernels differ in how they take the extra columns.
// K-vf1's columns are independent (M[r, j, h] sums over b alone), so a
// block computes 128 of them, exactly as at HV = 128, and a grid
// dimension walks the halves (VM_HALF): the staging stays 91 KB a block,
// two blocks a multiprocessor, for a kernel bound by its 50 MB of M.
// K-vf2's denc sums over all HV columns of both nets, so halves would
// need a second pass to add their partial denc; a block keeps all 256
// columns in its chain instead (FO_SMEM 178 KB: one block a
// multiprocessor, FO_BLOCKS), dWvx's columns split over its warps as at
// 128.  The HV = 128 builds are the kernels above unchanged.
//
// Past 256 (the views layers of WIDE nets, HV = 384-1024: -DANERF_WIDTH
// 768-2048) K-vf1 walks HV / 128 column blocks on its grid dimension as
// at 256.  K-vf2's chain of all HV columns would not fit a block (its
// ring stages and weight rows grow with HV: ~238 KB at 384 with 9 view
// rows), so it too runs blocks of 128 columns along its third grid
// dimension, each exactly the HV = 128 kernel on its columns: dWvx is
// per column, and each block writes its partial denc over its 128
// columns to scratch, which vf_denc_sum_kernel adds in column-block
// order (no atomics; two calls give the same bits).  Each block reads
// its columns of Gw once: Gw is read once in all, and the partial denc
// adds (HV / 128) x R x DE x 4 bytes each way (42 MB at R = 2048 and HV
// 1024).
#include "encmlp_common.cuh"

namespace {

// the nets of K1-K4 (encmlp_common.cuh ENC_KERNEL)
static_assert(W <= 2048, "nets a multiple of 256 wide, up to 2048");
static_assert(HV % 128 == 0 && HV <= 1024,
              "viewfac's kernels take a views layer of 128-column blocks");

constexpr int NBJ = NB * 3;          // 27 view columns a joint
// K-vf1: NBJ zero-padded to two k-steps, or past 32 (11 view rows and
// up) to whole k-steps: 48 at 11-15 rows, 64 at 17-21
constexpr int KB = NBJ <= 32 ? 32 : (NBJ + 15) / 16 * 16;
constexpr int JG = 8;                // joints a group: a sector of enc
constexpr int NTH = 256;
static_assert(J % JG == 0 && NBJ <= KB && KB <= 64, "whole joint groups");

// ---- asynchronous copies and the cluster's shared memory ---------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// the shared::cluster address of p's offset in cluster block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ void st_cluster_v4(uint32_t a, uint4 v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a)
               : "memory");
  return v;
}
// The cluster's barrier, which every thread of every block of the
// cluster passes: arrive releases this thread's shared-memory writes
// (local and remote), wait returns once every thread has arrived and
// acquires theirs; a thread alternates the two.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// a 256-byte row's 16-byte chunk c in shared memory, XOR-swizzled by the
// row so that 8 rows' same chunk fall in 8 bank groups
__device__ __forceinline__ int swz(int row, int c) {
  return (c ^ (row & 7)) << 3;
}

// ---- K-vf1 ---------------------------------------------------------------

constexpr int VM_RAYS = 16;            // rays a tile: one m-tile
constexpr int VM_LDE = KB + 8;         // E's row stride (bf16): 80 bytes
constexpr int VM_H = HV < 128 ? HV : 128;   // columns of M a block
constexpr int VM_HALF = HV / VM_H;     // blocks a (tile run, group, net)
constexpr int VM_HCH = VM_H / 8;       // 16-byte chunks of a block's row
constexpr int VM_W = JG * NBJ * VM_H;  // weights: [jj][b][VM_H], swizzled
constexpr int VM_E = JG * VM_RAYS * VM_LDE;   // view values: [jj][ray][b]
constexpr int VM_O = VM_RAYS * JG * VM_H;  // output tile: [ray][jj][VM_H], swizzled
constexpr int VM_SMEM = 2 * (VM_W + VM_E + VM_O + 8);
constexpr int VM_NP = VM_RAYS * NBJ;   // a tile's (ray, b) sectors of enc
constexpr int VM_PPT = (VM_NP + NTH - 1) / NTH;
// blocks a multiprocessor: two up to 11 view rows, past that one (the
// group's staged weights grow with NBJ: 180 KB a block at 21 rows)
constexpr int VM_BLOCKS = 2 * (VM_SMEM + 1024) <= 233472 ? 2 : 1;
static_assert(VM_H * VM_HALF == HV, "whole column blocks of M");
static_assert(VM_SMEM + 1024 <= 233472, "a block a multiprocessor");

// M[net, r, j0 .. j0 + 7, h0 .. h0 + VM_H - 1] for the rays r of tiles
// q, q + Q, ... (Q = gridDim.x) at joint group blockIdx.y, (net, column
// block) blockIdx.z = net VM_HALF + h0 / VM_H; enc (R, DE) f32, wvx
// (nnet, DE, HV) bf16.  The group's weights are staged once; the next
// tile's view values load while this one's products run.
__global__ void __launch_bounds__(NTH, VM_BLOCKS)
vf_m_mma_kernel(const float* __restrict__ enc, const bf16* __restrict__ wvx,
                bf16* __restrict__ M, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  bf16* Es = Ws + VM_W;
  bf16* Os = Es + VM_E;
  bf16* Z = Os + VM_O;                 // a zero chunk: W's rows b >= 27
  const int tid = threadIdx.x, j0 = blockIdx.y * JG;
  const int net = blockIdx.z / VM_HALF;
  const int h0 = (blockIdx.z - net * VM_HALF) * VM_H;
  const int ntile = (R + VM_RAYS - 1) / VM_RAYS;
  // the group's weight rows b J + j0 .. + 7, columns h0 ..: 2 KB
  // contiguous a b at HV = 128
  const bf16* wn = wvx + ((size_t)net * DE + j0) * HV + h0;
  for (int i = tid; i < NBJ * JG * VM_HCH; i += NTH) {
    const int b = i / (JG * VM_HCH), rem = i - b * (JG * VM_HCH);
    const int jj = rem / VM_HCH, c = rem - jj * VM_HCH;
    cp_async16(Ws + (jj * NBJ + b) * VM_H + swz(b, c),
               wn + ((size_t)b * J + jj) * HV + c * 8);
  }
  cp_async_commit();
  if (tid == 0) *reinterpret_cast<uint4*>(Z) = make_uint4(0u, 0u, 0u, 0u);
  // E's pads b = NBJ .. KB - 1 (27 .. 31) stay zero
  for (int i = tid; i < JG * VM_RAYS * (KB - NBJ); i += NTH) {
    const int row = i / (KB - NBJ);
    Es[row * VM_LDE + NBJ + i - row * (KB - NBJ)] = __ushort_as_bfloat16(0);
  }
  // a tile's view values: (ray, b) a 32-byte sector of 8 joints
  float4 v[VM_PPT][2];
  auto load_v = [&](int tile) {
#pragma unroll
    for (int u = 0; u < VM_PPT; ++u) {
      const int i = tid + u * NTH, r = i / NBJ, b = i - r * NBJ;
      const int rr = tile * VM_RAYS + r;
      v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < VM_NP && rr < R) {
        const float4* src = reinterpret_cast<const float4*>(
            enc + (size_t)rr * DE + b * J + j0);
        v[u][0] = __ldg(src);
        v[u][1] = __ldg(src + 1);
      }
    }
  };
  const int warp = tid >> 5, lane = tid & 31, mat = lane >> 3, r8 = lane & 7;
  const int g = lane >> 2, q = lane & 3;
  const bf16* Ej = Es + warp * VM_RAYS * VM_LDE;   // warp jj: joint j0 + jj
  const bf16* Wj = Ws + warp * NBJ * VM_H;
  int tile = blockIdx.x;
  if (tile < ntile) load_v(tile);
  for (; tile < ntile; tile += gridDim.x) {
#pragma unroll
    for (int u = 0; u < VM_PPT; ++u) {
      const int i = tid + u * NTH, r = i / NBJ, b = i - r * NBJ;
      if (i < VM_NP) {
        const float x[JG] = {v[u][0].x, v[u][0].y, v[u][0].z, v[u][0].w,
                             v[u][1].x, v[u][1].y, v[u][1].z, v[u][1].w};
#pragma unroll
        for (int jj = 0; jj < JG; ++jj)
          Es[(jj * VM_RAYS + r) * VM_LDE + b] = __float2bfloat16_rn(x[jj]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();                   // E whole; the last tile left Os
    if (tile + (int)gridDim.x < ntile) load_v(tile + gridDim.x);
    float acc[VM_HCH][4];
#pragma unroll
    for (int t = 0; t < VM_HCH; ++t)
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KB / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, Ej + (lane & 15) * VM_LDE + ks * 16 + (lane >> 4) * 8);
      const int k = ks * 16 + r8 + ((mat & 1) << 3);   // this lane's b
#pragma unroll
      for (int jp = 0; jp < VM_HCH / 2; ++jp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, k < NBJ ? Wj + k * VM_H + swz(k, 2 * jp + (mat >> 1))
                              : Z);
        mma_bf16(acc[2 * jp], a, bb[0], bb[1]);
        mma_bf16(acc[2 * jp + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int t = 0; t < VM_HCH; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int ray = g + 8 * hf;
        *reinterpret_cast<__nv_bfloat162*>(
            Os + (ray * JG + warp) * VM_H + swz(ray, t) + 2 * q) =
            __floats2bfloat162_rn(acc[t][2 * hf], acc[t][2 * hf + 1]);
      }
    __syncthreads();                   // Os whole; E free
    for (int i = tid; i < VM_RAYS * JG * VM_HCH; i += NTH) {
      const int ray = i / (JG * VM_HCH), rem = i - ray * (JG * VM_HCH);
      const int jj = rem / VM_HCH, c = rem - jj * VM_HCH;
      const int r = tile * VM_RAYS + ray;
      if (r < R)
        *reinterpret_cast<uint4*>(
            M + (((size_t)net * R + r) * J + j0 + jj) * HV + h0 + c * 8) =
            *reinterpret_cast<const uint4*>(Os + (ray * JG + jj) * VM_H +
                                            swz(ray, c));
    }
  }
}

// ---- K-vf2 ---------------------------------------------------------------

constexpr int FO_SLICE = 64;           // rays a slice
constexpr int FO_CH = 32;              // Gw's rays a stage: two a slice
constexpr int FO_NST = 3;              // stages in the ring
constexpr int FO_NB = 3;               // slices' E and Ds buffers
// a block's view columns b: 32 (two k-steps) at most; past 32 a joint
// (11 view rows and up) the blocks of a third grid dimension share the
// columns evenly, FO_NBJ each (17 at 11 rows, 32 at 21; dWvx and denc
// are per column: no sum crosses them), each reading its rays' Gw again
constexpr int FO_KB = 32;
constexpr int FO_NBH = (NBJ + FO_KB - 1) / FO_KB;   // column blocks
constexpr int FO_NBJ = (NBJ + FO_NBH - 1) / FO_NBH;  // a block's at most
// a block's columns h of Gw and dWvx: all HV up to 256 (denc's chain
// over them in one block); past 256 (WIDE nets' views layers, 384-1024)
// blocks of 128 along the third grid dimension as well, each writing its
// partial denc over its columns to scratch, which vf_denc_sum_kernel
// adds in block order
constexpr int FO_H = HV <= 256 ? HV : 128;
constexpr int FO_NHB = HV / FO_H;      // column blocks of h
constexpr int FO_HCH = FO_H / 8;       // 16-byte chunks of a block's row
constexpr int FO_LDG = FO_H + 8;       // a stage's row stride (bf16)
constexpr int FO_LDE = FO_KB + 8;      // E's row stride (bf16)
constexpr int FO_W = 2 * FO_KB * FO_H; // both nets' rows: [net][b][FO_H], swizzled
constexpr int FO_E = FO_SLICE * FO_LDE;    // a slice's view values: [ray][b]
constexpr int FO_D = FO_SLICE * FO_NBJ;    // a slice's denc at the joint: [ray][b]
constexpr int FO_G = 2 * FO_CH * FO_LDG;   // a stage: [net][ray][FO_H]
constexpr size_t FO_SMEM = 2 * ((size_t)FO_W + FO_NB * FO_E + FO_NST * FO_G) +
                           sizeof(float) * (FO_NB * FO_D + NTH * JG);
// blocks a multiprocessor: two at HV = 128 where a block's view columns
// are at most 27 (up to 9 view rows, 11-17 rows' halves), else one (the
// note above)
constexpr int FO_BLOCKS = 2 * (FO_SMEM + 1024) <= 233472 ? 2 : 1;
static_assert(FO_BLOCKS * (FO_SMEM + 1024) <= 233472,
              "FO_BLOCKS blocks a multiprocessor");
static_assert(FO_SLICE == 2 * FO_CH && FO_SLICE * 4 == NTH && FO_D % 4 == 0,
              "a thread a (ray, 8 b) unit's b, and a (unit, joint)");

// Block (joint j = blockIdx.x, partial y = blockIdx.y, view columns b0
// = FO_NBJ (blockIdx.z % FO_NBH) .. b0 + FO_NBJ - 1, columns h0 = FO_H
// (blockIdx.z / FO_NBH) .. h0 + FO_H - 1 of Gw), cluster rank j % JG:
// the dWvx partial of
// joint j's rows of those columns over the slices y, y + P, ... (P =
// gridDim.y) of FO_SLICE rays, both nets, and denc of those slices' rays
// at joint j and those columns (past 256 columns of h, its column block's
// partial, to denc + (h0 / FO_H) R DE).  Gw streams through a ring of FO_NST stages
// across the slices.  A slice's view values come in as (ray, 8 b)
// units, each unit's 8 sectors read by one block of the cluster (a
// sector a thread, cp.async into Xf) and handed to the 8 blocks as
// 16-byte rows of their E two slices ahead; its denc goes out one slice
// behind as (ray, b) pairs, each owner of a run of pairs reading their 8
// joints from the 8 blocks' Ds.  A slice's split cluster barrier
// (arrive after its products, wait before the next slice's hand-over)
// orders both, so no block waits on the others while its products run.
// dst: the partial of net n at dst + n * net_stride + y * slice_stride.
__global__ void __cluster_dims__(JG, 1, 1) __launch_bounds__(NTH, FO_BLOCKS)
vf_fold_kernel(const bf16* __restrict__ gw, const float* __restrict__ enc,
               const bf16* __restrict__ wvx, float* __restrict__ dst,
               long long net_stride, long long slice_stride,
               float* __restrict__ denc, int R, int nnet) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  bf16* Es = Ws + FO_W;                  // [FO_NB][FO_E]
  bf16* Gs = Es + FO_NB * FO_E;          // [FO_NST][FO_G]
  float* Ds = reinterpret_cast<float*>(Gs + FO_NST * FO_G);   // [FO_NB][FO_D]
  float* Xf = Ds + FO_NB * FO_D;         // [unit][b][joint]: a sector a thread
  const int tid = threadIdx.x, j = blockIdx.x, jj = j % JG, j0 = j - jj;
  const int y = blockIdx.y, P = gridDim.y;
  // this block's view columns b0 .. b0 + nbj - 1 (all NBJ in one block
  // up to 9 view rows), b below counting from b0, and its columns of Gw
  // h0 .. h0 + FO_H - 1 (all HV up to 256)
  const int b0 = (blockIdx.z % FO_NBH) * FO_NBJ;
  const int hb = blockIdx.z / FO_NBH, h0 = hb * FO_H;
  float* dn = denc + (size_t)hb * R * DE;
  const int nbj = FO_NBH == 1 ? NBJ : min(FO_NBJ, NBJ - b0);
  const int nslice = (R + FO_SLICE - 1) / FO_SLICE;
  const int T = (nslice - y + P - 1) / P;          // this block's slices
  const int K = 2 * T;                             // and their stages
  auto slice_ray = [&](int t) { return (y + P * t) * FO_SLICE; };

  // slice t's view values: thread (unit jj + JG (tid / 8), b 8 o + q)
  // copies the sector of (ray, b)'s 8 joints to Xf
  auto load_x = [&](int t) {
    const int u = jj + JG * (tid >> 3), b = (u & 3) * 8 + (tid & 7);
    const int r = slice_ray(t) + (u >> 2);
    const bool on = b < nbj && r < R;
    const float* src = enc + (on ? (size_t)r * DE + (b0 + b) * J + j0 : 0);
    cp_async16(Xf + tid * JG, src, on ? 16 : 0);
    cp_async16(Xf + tid * JG + 4, src + 4, on ? 16 : 0);
  };
  uint32_t e_at[JG], d_at[JG];
#pragma unroll
  for (int k = 0; k < JG; ++k) {
    e_at[k] = cluster_addr(Es, k);
    d_at[k] = cluster_addr(Ds, k);
  }
  // Xf to every block's E of slice t, in bf16: thread (unit, joint k)
  // sends the unit's 8 values of joint k to block k, 16 bytes
  auto send_x = [&](int t) {
    const int k = tid & 7, u = tid >> 3, uu = jj + JG * u;
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = Xf[(u * 8 + q) * JG + k];
    st_cluster_v4(e_at[k] + (uint32_t)(((t % FO_NB) * FO_E +
                                        (uu >> 2) * FO_LDE + (uu & 3) * 8) *
                                       2),
                  pack8(v));
  };
  // slice t's denc: this block's run of its (ray, b) pairs, i / nbj and
  // i % nbj, 4 at a time, each pair's 8 joints from the 8 blocks' Ds
  auto pull_d = [&](int t) {
    const int npair = min(FO_SLICE, R - slice_ray(t)) * nbj;
    const int per = (npair + 4 * JG - 1) / (4 * JG) * 4;
    const uint32_t dof = (uint32_t)(t % FO_NB) * FO_D * 4u;
    for (int i0 = jj * per + 4 * tid; i0 < min(npair, (jj + 1) * per);
         i0 += 4 * NTH) {
      float4 v[JG];
#pragma unroll
      for (int k = 0; k < JG; ++k)
        v[k] = ld_cluster_f4(d_at[k] + dof + (uint32_t)i0 * 4u);
      const float w[JG][4] = {
          {v[0].x, v[0].y, v[0].z, v[0].w}, {v[1].x, v[1].y, v[1].z, v[1].w},
          {v[2].x, v[2].y, v[2].z, v[2].w}, {v[3].x, v[3].y, v[3].z, v[3].w},
          {v[4].x, v[4].y, v[4].z, v[4].w}, {v[5].x, v[5].y, v[5].z, v[5].w},
          {v[6].x, v[6].y, v[6].z, v[6].w}, {v[7].x, v[7].y, v[7].z, v[7].w}};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int i = i0 + p, r = i / nbj, b = i - r * nbj;
        if (i < npair) {
          float4* o = reinterpret_cast<float4*>(
              dn + (size_t)(slice_ray(t) + r) * DE + (b0 + b) * J + j0);
          o[0] = make_float4(w[0][p], w[1][p], w[2][p], w[3][p]);
          o[1] = make_float4(w[4][p], w[5][p], w[6][p], w[7][p]);
        }
      }
    }
  };
  // stage k % FO_NST <- Gw of stage k's 32 rays, zeros past R
  auto load_stage = [&](int k) {
    bf16* G = Gs + (k % FO_NST) * FO_G;
    const int r0 = slice_ray(k >> 1) + (k & 1) * FO_CH;
    for (int i = tid; i < nnet * FO_CH * FO_HCH; i += NTH) {
      const int row = i / FO_HCH, ch = i - row * FO_HCH, n = row / FO_CH;
      const int r = r0 + row - n * FO_CH;
      const bool on = r < R;
      cp_async16(G + row * FO_LDG + ch * 8,
                 gw + (((size_t)n * R + (on ? r : 0)) * J + j) * HV + h0 +
                     ch * 8,
                 on ? 16 : 0);
    }
  };

  // both nets' nbj (27) weight rows of joint j, rows nbj .. 31 zero
  for (int i = tid; i < nnet * nbj * FO_HCH; i += NTH) {
    const int row = i / FO_HCH, c = i - row * FO_HCH, n = row / nbj;
    const int b = row - n * nbj;
    cp_async16(Ws + (n * FO_KB + b) * FO_H + swz(b, c),
               wvx + ((size_t)n * DE + (b0 + b) * J + j) * HV + h0 + c * 8);
  }
  load_x(0);
  cp_async_commit();
  for (int i = tid; i < 2 * (FO_KB - nbj) * FO_HCH; i += NTH) {
    const int row = i / FO_HCH, n = row / (FO_KB - nbj);
    *reinterpret_cast<uint4*>(Ws + (n * FO_KB + nbj + row -
                                    n * (FO_KB - nbj)) * FO_H +
                              (i - row * FO_HCH) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  for (int k = 0; k < FO_NST - 1; ++k) {
    if (k < K) load_stage(k);
    cp_async_commit();
  }
  cluster_sync();   // every block of the cluster runs
  // slices 0 and 1's E
  cp_async_wait<FO_NST - 1>();
  __syncthreads();
  send_x(0);
  if (T > 1) {
    __syncthreads();
    load_x(1);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    send_x(1);
  }
  cluster_sync();
  cluster_arrive();

  const int warp = tid >> 5, lane = tid & 31, mat = lane >> 3, r8 = lane & 7;
  const int g = lane >> 2, q = lane & 3;
  // warps 0-3: dWvx of net wn, columns nh 64 .. + 63, both b-tiles;
  // warps 4-7: denc of the stage's 16-ray tile mt, b-tiles 2 nb, 2 nb + 1
  const bool dw_warp = warp < 4;
  const int wn = (warp >> 1) & 1, nh = warp & 1;
  const int mt = (warp >> 1) & 1, nb = warp & 1;
  float dacc[2][FO_HCH / 2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int t = 0; t < FO_HCH / 2; ++t)
      dacc[m][t][0] = dacc[m][t][1] = dacc[m][t][2] = dacc[m][t][3] = 0.f;

  for (int t = 0; t < T; ++t) {
    const bf16* E = Es + (t % FO_NB) * FO_E;
    float* D = Ds + (t % FO_NB) * FO_D;
    const bool x_ahead = t + 2 < T;
    for (int h = 0; h < 2; ++h) {
      const int k = 2 * t + h;
      if (h == 1 && x_ahead) {       // Xf was read before the last barrier
        load_x(t + 2);
        cp_async_commit();
      }
      if (k + FO_NST - 1 < K) load_stage(k + FO_NST - 1);
      cp_async_commit();
      if (h == 1 && x_ahead)
        cp_async_wait<FO_NST>();
      else
        cp_async_wait<FO_NST - 1>();
      __syncthreads();
      const bf16* G = Gs + (k % FO_NST) * FO_G;
      if (dw_warp && wn < nnet) {
#pragma unroll
        for (int ks = 0; ks < FO_CH / 16; ++ks) {
          uint32_t a[2][4];   // E^T: rows b, columns the stage's rays
#pragma unroll
          for (int m = 0; m < 2; ++m)
            ldsm_x4_t(a[m], E + (h * FO_CH + ks * 16 + r8 +
                                 ((mat >> 1) << 3)) * FO_LDE + m * 16 +
                                ((mat & 1) << 3));
#pragma unroll
          for (int jp = 0; jp < FO_HCH / 4; ++jp) {
            uint32_t bb[4];
            ldsm_x4_t(bb, G + (wn * FO_CH + ks * 16 + r8 +
                               ((mat & 1) << 3)) * FO_LDG + nh * (FO_H / 2) +
                              jp * 16 + ((mat >> 1) << 3));
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma_bf16(dacc[m][2 * jp], a[m], bb[0], bb[1]);
              mma_bf16(dacc[m][2 * jp + 1], a[m], bb[2], bb[3]);
            }
          }
        }
      } else if (!dw_warp) {
        float e8[2][4] = {};
        for (int n = 0; n < nnet; ++n) {
#pragma unroll
          for (int ks = 0; ks < FO_H / 16; ++ks) {
            uint32_t a[4], bb[4];   // Wvx rows nb 16 .. + 15, h ks 16 ..
            ldsm_x4(a, G + (n * FO_CH + mt * 16 + (lane & 15)) * FO_LDG +
                           ks * 16 + (lane >> 4) * 8);
            const int wr = nb * 16 + r8 + ((mat >> 1) << 3);
            ldsm_x4(bb, Ws + (n * FO_KB + wr) * FO_H +
                            swz(wr, ks * 2 + (mat & 1)));
            mma_bf16(e8[0], a, bb[0], bb[1]);
            mma_bf16(e8[1], a, bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = h * FO_CH + mt * 16 + g + 8 * hf;
            const int b = nb * 16 + nt * 8 + 2 * q;
            if (b < nbj) D[r * nbj + b] = e8[nt][2 * hf];
            if (b + 1 < nbj) D[r * nbj + b + 1] = e8[nt][2 * hf + 1];
          }
      }
      __syncthreads();   // the stage is free for the load FO_NST - 1 on
    }
    // every block done with slice t - 1: its Ds whole, E of t + 1 whole,
    // E of t + 2's buffer free
    cluster_wait();
    if (t > 0) pull_d(t - 1);
    if (x_ahead) {
      cp_async_wait<1>();
      __syncthreads();
      send_x(t + 2);
    }
    cluster_arrive();   // slice t's Ds, slice t + 2's E
  }
  cluster_wait();
  pull_d(T - 1);
  cp_async_wait<0>();
  if (dw_warp && wn < nnet) {
    float* o = dst + wn * net_stride + y * slice_stride;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int t = 0; t < FO_HCH / 2; ++t)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int b = m * 16 + g + 8 * hf;
          if (b < nbj)
            *reinterpret_cast<float2*>(o + (size_t)((b0 + b) * J + j) * HV +
                                       h0 + nh * (FO_H / 2) + t * 8 + 2 * q) =
                make_float2(dacc[m][t][2 * hf], dacc[m][t][2 * hf + 1]);
        }
  }
  cluster_sync();   // no block leaves while another reads its Ds
}

// dw[net * wstride + c * HV + h] = the P slices' partials of (net, c, h)
// summed in slice order, 4 values a thread
__global__ void __launch_bounds__(NTH)
vf_fold_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                   long long wstride, int nnet, int P) {
  const size_t per = (size_t)DE * HV / 4, total = per * nnet;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 s = p4[i];
    for (int p = 1; p < P; ++p) {
      const float4 x = p4[(size_t)p * total + i];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    const size_t net = i / per;
    reinterpret_cast<float4*>(dw + net * (size_t)wstride)[i - net * per] = s;
  }
}

// denc[i] = the FO_NHB column blocks' partials of i summed in block
// order (past 256 columns of Gw), 4 values a thread
__global__ void __launch_bounds__(NTH)
vf_denc_sum_kernel(const float* __restrict__ dpart, float* __restrict__ denc,
                   int R) {
  const size_t total = (size_t)R * DE / 4;
  const float4* p4 = reinterpret_cast<const float4*>(dpart);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 s = p4[i];
    for (int hb = 1; hb < FO_NHB; ++hb) {
      const float4 x = p4[(size_t)hb * total + i];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    reinterpret_cast<float4*>(denc)[i] = s;
  }
}

// the kernels' shared memory past 48 KB, set once per library
cudaError_t set_smem_once() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        vf_m_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, VM_SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(vf_fold_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)FO_SMEM);
  }();
  return err;
}

}  // namespace

extern "C" {

// K-vf1: M (nnet, R, J, HV) bf16 from enc (R, DE) f32 and each net's
// views-input weight rows wvx (nnet, DE, HV) bf16 (16-byte aligned); DE
// = 72 NB, 648 at the flagship's 9 view rows.
int viewfac_m(const float* enc, const void* wvx, void* M, int R, int nnet,
              void* stream) {
  if (R <= 0) return 0;
  if (nnet < 1 || nnet > 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_once();
  if (err != cudaSuccess) return (int)err;
  // VM_BLOCKS blocks a multiprocessor, each a run of ray tiles
  int dev = 0, nsm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int ntile = (R + VM_RAYS - 1) / VM_RAYS;
  const int lanes =
      max(1, min(ntile, VM_BLOCKS * nsm / (J / JG * nnet * VM_HALF)));
  vf_m_mma_kernel<<<dim3(lanes, J / JG, nnet * VM_HALF), NTH, VM_SMEM,
                    (cudaStream_t)stream>>>(
      enc, reinterpret_cast<const bf16*>(wvx), reinterpret_cast<bf16*>(M), R);
  return (int)cudaGetLastError();
}

// K-vf2's scratch, f32 values: the P partials of dWvx (P, nnet, DE, HV)
// where P > 1, then past 256 columns of Gw the column blocks' partial
// denc (FO_NHB, R, DE); 0 where it needs none.
long long viewfac_fold_scratch(int R, int nnet, int P) {
  return (P > 1 ? (long long)P * nnet * DE * HV : 0) +
         (FO_NHB > 1 ? (long long)FO_NHB * R * DE : 0);
}

// K-vf2: from the nets' per-ray Gram matrices gw (nnet, R, J, HV) bf16
// (encmlp_bwd.cu's vf_gram_kernel): dWvx into dw (net's at dw + net *
// wstride, (DE, HV) row-major f32) and denc (R, DE) f32, over slices
// of `slice` (= FO_SLICE) rays, P partial sums (fused_encmlp.vf_fold_plan):
// partial p over the slices p, p + P, ...; part is scratch of
// viewfac_fold_scratch(R, nnet, P) values (null where that is 0).
int viewfac_fold(const void* gw, const float* enc, const void* wvx,
                 float* dw, long long wstride, float* denc, float* part,
                 int P, int slice, int R, int nnet, void* stream) {
  if (R <= 0) return 0;
  if (nnet < 1 || nnet > 2 || slice != FO_SLICE || P < 1 ||
      P > (R + slice - 1) / slice || wstride % 4 != 0 ||
      (viewfac_fold_scratch(R, nnet, P) > 0 && !part))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem_once();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const long long per = (long long)DE * HV;
  float* dpart = part + (P > 1 ? (long long)P * nnet * per : 0);
  vf_fold_kernel<<<dim3(J, P, FO_NBH * FO_NHB), NTH, FO_SMEM, st>>>(
      reinterpret_cast<const bf16*>(gw), enc,
      reinterpret_cast<const bf16*>(wvx), P > 1 ? part : dw,
      P > 1 ? per : wstride, P > 1 ? per * nnet : 0,
      FO_NHB > 1 ? dpart : denc, R, nnet);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (P > 1) {
    vf_fold_sum_kernel<<<(int)((per / 4 * nnet + NTH - 1) / NTH), NTH, 0,
                         st>>>(part, dw, wstride, nnet, P);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (FO_NHB > 1) {
    vf_denc_sum_kernel<<<(int)(((long long)R * DE / 4 + NTH - 1) / NTH), NTH,
                         0, st>>>(dpart, denc, R);
    err = cudaGetLastError();
  }
  return (int)err;
}

// The build's views width and view PE rows, for the wrapper's checks.
int viewfac_width(void) { return HV; }
int viewfac_rows(void) { return NB; }

// K-vf2's slice, for fused_encmlp.vf_fold_plan's check.
int viewfac_slice(void) { return FO_SLICE; }

}  // extern "C"
