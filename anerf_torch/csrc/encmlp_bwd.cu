// Fused encode + radiance-MLP backward kernels for Hopper (sm_90a).
//
// Replaces the backward Pallas kernels of anerf_tpu/ops/pallas_encmlp.py:
//   encmlp_bwd       <- _fused_bwd / _bwd_kernel            (one net; K3)
//   encmlp_dual_bwd  <- _fused_dual_bwd / _bwd_kernel_dual  (coarse and
//                       fine nets on one encode; K4)
// at the flagship shape of encmlp_common.cuh.  Given the raw cotangent g
// (nnet, 4, n) they return dp (n, 72), denc (R, 648), dcodes (nnet, R, 16)
// and the f32 gradient of every weight and bias of each net.
//
// What the TPU kernel does that a Hopper block cannot, and the design:
//
// * The TPU sums the weight gradients across its in-order grid in VMEM.
//   Hopper blocks run in no order, so the work is split in passes, all
//   on one stream, none with atomics (deterministic run to run):
//   1. bwd_tile_kernel, one block per 64-point tile: the encode (the
//      forward's own device code, so the values and ReLU masks are the
//      forward's bit for bit), the forward recompute, and the MLP
//      backward for the input cotangents.  It writes each layer's bf16
//      input and activation, each bf16 pre-activation cotangent, the f32
//      input cotangents of [v | r] and [xv | codes], and per-tile bias
//      partial sums of the f32 cotangents to a workspace (about 23 KB a
//      point for two nets: 3 GB at n = 131,072).
//   2. pullback_kernel, one thread per (point, joint): sums the nets'
//      input cotangents in f32, rounds them through bf16, and pulls them
//      back through the encode without transcendentals beyond the
//      forward's own (each band's derivative is its paired band) into dp.
//   3. denc_kernel, one thread per (ray, column): denc and dcodes sum
//      over the samples of a ray in a fixed order, so a ray may straddle
//      tiles and any (R, S) is taken.
//   4. bias_kernel: the bias gradients, the per-tile partials summed in
//      tile order.
//   5. dw_kernel: every weight gradient A^T G, bf16 operands on the
//      tensor cores (mma.sync m16n8k16, f32 accumulators).  Each block
//      owns one 128 x 128 tile of one weight gradient and walks all
//      points in order, 32 at a time, through shared memory.
// * The per-tile state does not fit where the forward's did (217 KB for
//   64 points; the f32 input cotangents would add 276 KB).  Pass 1 keeps
//   the forward's shared-memory plan (X, XV, two activation buffers,
//   windows: 217,088 bytes, plus 1 KB for g) and streams what the
//   backward reads back from device memory: the activations for the
//   ReLU masks in reverse layer order, and the f32 input cotangents,
//   which it writes straight from the accumulators.
// * The stash: the TPU stashes the f32 PE bands because its wide sin was
//   the forward's largest VPU block.  Here the bands come from one sinf
//   pair and the double-angle recurrence, so passes 1 and 2 recompute
//   them from the same code, bit-identical to the forward's; no stash.
//
// Bound: recompute, input cotangents and weight gradients are 3x the
// forward's tensor-core work (~5.2 MFLOP a point and net), against a few
// KB of device traffic a point: operations bound both kernels.  This
// first version re-reads the weights from L2 for every tile, writes the
// workspace once and reads it in the dW pass; wgmma and fusing the dW
// products into fewer passes are later work.
//
// The workspace, the per-tile MLP backward, the bias pass and the dW
// pass live in mlp_bwd_common.cuh, shared with K6 (mlp_bwd.cu).
//
// C interface (loaded with ctypes): every pointer is device memory, the
// stream is PyTorch's current stream; returns the first cudaError of
// the five launches.
#include "mlp_bwd_common.cuh"

namespace {

template <int NNET>
__global__ void __launch_bounds__(NTHREAD, 1)
bwd_tile_kernel(const float* __restrict__ p, const float* __restrict__ enc,
                const float* __restrict__ codes,
                const float* __restrict__ cutoff,
                const float* __restrict__ tau_ptr,
                const bf16* __restrict__ wpack, const bf16* __restrict__ wback,
                const float* __restrict__ bpack, const float* __restrict__ gin,
                Work wk, int n, int S, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);   // [v | r]       (T, LDX)
  bf16* XV = X + T * LDX;                     // [xv | codes]  (T, LDXV)
  bf16* H0 = XV + T * LDXV;                   // (T, LDH)
  bf16* H1 = H0 + T * LDH;
  float* WIN = reinterpret_cast<float*>(H1 + T * LDH);  // (T, J)
  float* GSM = WIN + T * J;                             // raw g (T, 4)

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * T;
  const float tau = __ldg(tau_ptr);

  encode_tile(p, enc, cutoff, tau, X, XV, WIN, t0, n, S);
  copy_rows(wk.x + (size_t)t0 * DX, DX, X, LDX, DX);

  for (int net = 0; net < NNET; ++net) {
    write_codes(XV, codes + (size_t)net * R * NCODE, t0, n, S);
    for (int idx = tid; idx < T * 4; idx += NTHREAD) {
      const int t = idx >> 2, c = idx & 3, gpt = t0 + t;
      GSM[idx] = gpt < n ? __ldg(gin + ((size_t)net * 4 + c) * n + gpt) : 0.f;
    }
    __syncthreads();
    mlp_bwd_tile(X, XV, H0, H1, GSM, wpack + (size_t)net * WSZ,
                 wback + (size_t)net * WGSZ, bpack + (size_t)net * BSZ, wk,
                 net, t0);
  }
}

// dp: one thread per (point, joint)
template <int NNET>
__global__ void pullback_kernel(const float* __restrict__ p,
                                const float* __restrict__ enc,
                                const float* __restrict__ cutoff,
                                const float* __restrict__ tau_ptr, Work wk,
                                float* __restrict__ dp, int n, int S) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * J) return;
  const int gp = idx / J, j = idx - gp * J;
  const float tau = __ldg(tau_ptr);
  const float* pp = p + (size_t)gp * C3;
  const float x = __ldg(pp + j), y = __ldg(pp + J + j), z = __ldg(pp + 2 * J + j);
  const float d = sqrtf(x * x + y * y + z * z);
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
    if (k > 0) {
      const float s2 = 2.f * s * c;
      c = 1.f - 2.f * s * s;
      s = s2;
    }
    const float f = (float)(1 << k);
    const float gs = gx((1 + 2 * k) * J + j), gc = gx((2 + 2 * k) * J + j);
    g_w += gs * s;
    g_w += gc * c;
    bandsum += gs * w * f * c;      // d sin(f d) = f cos(f d)
    bandsum += gc * w * (-f) * s;   // d cos(f d) = -f sin(f d)
  }
  g_dists += bandsum;
  // r = p / d
  const float pc[3] = {x, y, z};
  float gr[3], g_invd = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gr[k] = gx(DV + k * J + j);
    g_invd += gr[k] * pc[k];
  }
  g_dists -= g_invd * (invd * invd) * (d > 1e-12f ? 1.f : 0.f);
  // xv = enc[ray] * w
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
  g_dists -= g_w * (tau * (1.f - w) * w);
  const float gd = g_dists * invd;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    dp[(size_t)gp * C3 + k * J + j] = gr[k] * invd + pc[k] * gd;
}

// denc (R, DE) and dcodes (NNET, R, NCODE): sums over a ray's samples
template <int NNET>
__global__ void denc_kernel(Work wk, float* __restrict__ denc,
                            float* __restrict__ dcodes, int S, int R) {
  constexpr int NCOL = DE + NNET * NCODE;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * NCOL) return;
  const int r = idx / NCOL, c = idx - r * NCOL;
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

template <int NNET>
int launch_bwd(const float* p, const float* enc, const float* codes,
               const float* cutoff, const float* tau, const void* wpack,
               const void* wback, const float* bpack, const float* g,
               void* workspace, float* dp, float* denc, float* dcodes,
               float* dw, float* db, int n, int S, int R, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int np = (int)round_up((size_t)n, T), ntile = np / T;
  const Work wk = carve(workspace, n, NNET, J);
  const size_t smem = SMEM_BYTES + sizeof(float) * T * 4;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_tile_kernel<NNET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_tile_kernel<NNET><<<ntile, NTHREAD, smem, st>>>(
      p, enc, codes, cutoff, tau, reinterpret_cast<const bf16*>(wpack),
      reinterpret_cast<const bf16*>(wback), bpack, g, wk, n, S, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  pullback_kernel<NNET><<<(n * J + 255) / 256, 256, 0, st>>>(
      p, enc, cutoff, tau, wk, dp, n, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int ncol = DE + NNET * NCODE;
  denc_kernel<NNET><<<(R * ncol + 255) / 256, 256, 0, st>>>(wk, denc, dcodes,
                                                             S, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_grads(wk, NNET, dw, db, np, st);
}

}  // namespace

extern "C" {

// One net (K3): g (1, 4, n); dcodes (1, R, 16); dw (WGSZ); db (BSZ).
int encmlp_bwd(const float* p, const float* enc, const float* codes,
               const float* cutoff, const float* tau, const void* wpack,
               const void* wback, const float* bpack, const float* g,
               void* workspace, float* dp, float* denc, float* dcodes,
               float* dw, float* db, int n, int S, int R, void* stream) {
  return launch_bwd<1>(p, enc, codes, cutoff, tau, wpack, wback, bpack, g,
                       workspace, dp, denc, dcodes, dw, db, n, S, R, stream);
}

// Coarse and fine nets on one encode (K4): every per-net operand holds
// two sets back to back.
int encmlp_dual_bwd(const float* p, const float* enc, const float* codes,
                    const float* cutoff, const float* tau, const void* wpack,
                    const void* wback, const float* bpack, const float* g,
                    void* workspace, float* dp, float* denc, float* dcodes,
                    float* dw, float* db, int n, int S, int R, void* stream) {
  return launch_bwd<2>(p, enc, codes, cutoff, tau, wpack, wback, bpack, g,
                       workspace, dp, denc, dcodes, dw, db, n, S, R, stream);
}

long long encmlp_bwd_workspace_bytes(int n, int nnet) {
  return (long long)workspace_bytes(n, nnet, J);
}

long long encmlp_grad_weight_elems(void) { return (long long)WGSZ; }

}  // extern "C"
