// K2: fused model mean and residual sum of squares, batched over chains.
//
// Replaces bayesfmmm_tpu/ops/pallas_kernels.py::fused_mean_rss (kernel
// body _mean_rss_kernel).  B (N, L, P) and y (N, L) are shared by all
// chains, already zero at padded points (so no mask is read); w (C, N, P)
// holds each chain's effective coefficients.  For chain c:
//   mu[c, n, l] = sum_p B[n, l, p] w[c, n, p]
//   rss[c]      = sum_{n, l} (y[n, l] - mu[c, n, l])^2
// and mu is written only when the caller passes a buffer for it.  The sum
// is formed in residual space: the Gram identity yy - 2 u.w + w'Gw cancels
// catastrophically in f32 (bayesfmmm_tpu/ops/mean.py:84-92).
//
// What bounds it on the card: operations, barely (19 FLOP per chain and
// point against 1.2 MB of compulsory traffic at C = 256, N = L = 100,
// P = 8: 0.73 us of f32 arithmetic, 0.35 us of bytes), so in practice the
// launch and one round trip to L2.  What a kernel can waste is reads of B
// from L2: one block per chain reads all of B once per chain, 256 x 320 KB
// = 82 MB for a call that needs 1.2 MB.
//
// Design: a block owns a tile of TC chains and a tile of TN observations
// (TN * L points, one contiguous run of B and of y).  B is therefore read
// from L2 once per chain tile, ceil(C / TC) times a call.  The tile sizes,
// the grid and the scratch shape are chosen by ops/kernels.py::
// mean_rss_plan, which takes the smallest TC of 8, 24 and 40 that keeps the
// grid within one block per SM: 11 chain tiles of 24 by 10 point tiles at
// C = 256, 13 of 40 by 10 at C = 512.  On the card one wave of larger
// blocks beat two or three waves of smaller ones at both shapes; 24 and 40
// are the tiles those two shapes select, 8 serves few chains.  With mu the
// tile is 8 chains: the call is then bound by writing mu, and the larger
// tiles would spill registers.
//   * The tile's w (TC runs of TN * P floats) goes to shared memory with
//     cp.async, and while it is in flight each thread loads its points'
//     B[n, l, :] (two 16-byte loads at P = 8) and y[n, l] into registers,
//     four points at a time: every load of the block is started before the
//     one barrier.
//   * Each point is then applied to every chain of the tile: the chain's
//     w[c, n, :] comes from shared memory (a warp's points share n, so the
//     read is a broadcast), the P-term dot product runs in the order
//     p = 0..P-1, and the squared residual goes to one accumulator per
//     chain, in registers.  One integer division per point, none per chain.
//   * P = 8 or 16 with 16-byte aligned B and w keeps B in registers (four
//     points a thread at P = 8, two at P = 16: the hd family's tensor
//     basis); any other P or alignment takes the general instantiation,
//     which takes one point a thread at a time and re-reads its B[n, l, :]
//     per chain (from L1) with 4-byte loads.  At P = 16 the general
//     instantiation took 41.5 us at 64 chains where the plain version takes
//     14.1, which is why P = 16 has one of its own.
//   * The block's TC sums are reduced by a shuffle tree per warp and an
//     in-order pass over the warps, and go to partial[point tile, chain].
//     A second kernel adds the point tiles in index order.  No atomics of
//     any kind: the same input gives the same bits on every run.
// The TPU kernel's per-tile partial sums, added by its caller, become the
// scratch buffer and the second kernel.
//
// K2's backward (mean_rss_grad): the gradient of rss with respect to w, for
// an upstream gradient g (C,) of the rss,
//   grad_w[c, n, p] = -2 g[c] sum_l B[n, l, p] (y[n, l] - mu[c, n, l]),
// which XLA forms by differentiating the JAX package's einsum
// (bayesfmmm_tpu/ops/mean.py:100-101) and the TPU kernel does not have.  It
// recomputes the residual rather than keeping mu from the forward pass, so
// the forward writes nothing more than before.  Bound: operations, barely
// (4P + 1 FLOP per chain and point against the forward's bytes and grad_w:
// at the HMC path's C = 64, N = L = 100, P = 8, 0.32 us of f32 arithmetic
// and 0.23 us of bytes), so in practice the launch.  Design, simple first:
// a block owns one observation n (blockIdx.x) and a tile of TC chains
// (blockIdx.y; TC * P <= BFMMM_K2_GRAD_OUTPUTS outputs, a few a thread).  The
// tile's w[c, n, :] goes to shared memory; then, a chunk of LC points at a
// time, every thread forms residuals of (chain, point) pairs into shared
// memory (the P-term dot product in the order p = 0..P-1, as the forward),
// and after a barrier each thread adds B[n, l, p] r[c, l] over the chunk's
// points, in index order, into its outputs' accumulators in registers.  No
// atomics: the same input gives the same bits on every run.
// The tile sizes and the grid come from ops/kernels.py::mean_rss_grad_plan.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPtFloats = 32;  // floats of B a thread holds in registers
constexpr int kMuTile = 8;  // chains a block when mu is written as well

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// TC chains a block; PV = 8 or 16: P == PV, 16-byte loads, B in registers;
// PV = 0: any P, 4-byte loads; MU: also write mu.
template <int TC, int PV, bool MU>
__global__ void __launch_bounds__(kThreads)
mean_rss_tile_kernel(const float* __restrict__ B, const float* __restrict__ y,
                     const float* __restrict__ w, float* __restrict__ partial,
                     float* __restrict__ mu, int C, int N, int L, int P,
                     int TN) {
  extern __shared__ __align__(16) float ws[];   // (TC, tn, P)
  __shared__ float red[kWarps][TC];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * TC, n0 = blockIdx.y * TN;
  const int tc = min(TC, C - c0), tn = min(TN, N - n0);
  const int run = tn * P;                        // one chain's w in the tile
  const int npts = tn * L;
  const float* Bt = B + (size_t)n0 * L * P;
  const float* yt = y + (size_t)n0 * L;

  constexpr int E = PV ? 4 : 1;                  // floats per copy
  constexpr int PT = PV ? kPtFloats / PV : 1;    // points a thread at once
  constexpr int NQ = PV ? PV / 4 : 1;            // 16-byte loads a point
  const int per = run / E;
  for (int i = tid; i < tc * per; i += kThreads) {
    const int c = i / per, j = (i - c * per) * E;
    __pipeline_memcpy_async(ws + c * run + j,
                            w + ((size_t)(c0 + c) * N + n0) * P + j,
                            sizeof(float) * E);
  }
  __pipeline_commit();
  // chains past the ragged edge take zeros; their sums are never written
  for (int i = tc * run + tid; i < TC * run; i += kThreads) ws[i] = 0.0f;

  float acc[TC];
#pragma unroll
  for (int c = 0; c < TC; ++c) acc[c] = 0.0f;

  for (int base = 0; base < npts; base += PT * kThreads) {
    float4 bq[PT][NQ];
    float yv[PT];
    int idx[PT], off[PT];
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      idx[j] = base + j * kThreads + tid;
      const bool ok = idx[j] < npts;
      // a point past the tile reads nothing: B = 0, y = 0 add 0 to each sum
      off[j] = ok ? (idx[j] / L) * P : 0;
      yv[j] = ok ? yt[idx[j]] : 0.0f;
      if (PV) {
        const float4* Bp = reinterpret_cast<const float4*>(Bt) + NQ * idx[j];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          bq[j][q] = ok ? Bp[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if (base == 0) {            // uniform: every thread runs this iteration
      __pipeline_wait_prior(0);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const bool ok = idx[j] < npts;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float* wp = ws + c * run + off[j];
        float m = 0.0f;
        if (PV) {
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const float4 wq = *reinterpret_cast<const float4*>(wp + 4 * q);
            m = fmaf(bq[j][q].x, wq.x, m);
            m = fmaf(bq[j][q].y, wq.y, m);
            m = fmaf(bq[j][q].z, wq.z, m);
            m = fmaf(bq[j][q].w, wq.w, m);
          }
        } else if (ok) {
          const float* Bp = Bt + (size_t)idx[j] * P;
          for (int p = 0; p < P; ++p) m = fmaf(__ldg(Bp + p), wp[p], m);
        }
        if (MU && ok && c < tc)
          mu[((size_t)(c0 + c) * N + n0) * L + idx[j]] = m;
        const float r = yv[j] - m;
        acc[c] = fmaf(r, r, acc[c]);
      }
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int c = 0; c < TC; ++c) {
    const float v = warp_sum(acc[c]);
    if (lane == 0) red[warp][c] = v;
  }
  __syncthreads();
  if (tid < tc) {
    float s = 0.0f;
    for (int v = 0; v < kWarps; ++v) s += red[v][tid];
    partial[(size_t)blockIdx.y * C + c0 + tid] = s;
  }
}

// rss[c] = sum over the T point tiles of partial[t, c], in index order.
__global__ void __launch_bounds__(kThreads)
mean_rss_sum_kernel(const float* __restrict__ partial, float* __restrict__ rss,
                    int C, int T) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  float s = 0.0f;
#pragma unroll 8   // eight loads in flight; the adds stay in index order
  for (int t = 0; t < T; ++t) s += partial[(size_t)t * C + c];
  rss[c] = s;
}

// One chain tile size: 16-byte loads at P = `pv` (8 or 16), else (0) any P.
template <int TC, bool MU>
void launch_tile(int pv, const float* B, const float* y, const float* w,
                 float* partial, float* mu, int C, int N, int L, int P, int TN,
                 dim3 grid, size_t smem, cudaStream_t stream) {
  if (pv == 8)
    mean_rss_tile_kernel<TC, 8, MU><<<grid, kThreads, smem, stream>>>(
        B, y, w, partial, mu, C, N, L, P, TN);
  else if (pv == 16)
    mean_rss_tile_kernel<TC, 16, MU><<<grid, kThreads, smem, stream>>>(
        B, y, w, partial, mu, C, N, L, P, TN);
  else
    mean_rss_tile_kernel<TC, 0, MU><<<grid, kThreads, smem, stream>>>(
        B, y, w, partial, mu, C, N, L, P, TN);
}

// Outputs a block of mean_rss_grad owns at most: ops/kernels.py's
// K2_GRAD_OUTPUTS, given on nvcc's command line.  A thread keeps kGradOuts.
constexpr int kGradOuts = BFMMM_K2_GRAD_OUTPUTS / kThreads;
static_assert(kGradOuts * kThreads == BFMMM_K2_GRAD_OUTPUTS,
              "BFMMM_K2_GRAD_OUTPUTS must be a multiple of kThreads");

__global__ void __launch_bounds__(kThreads)
mean_rss_grad_kernel(const float* __restrict__ B, const float* __restrict__ y,
                     const float* __restrict__ w, const float* __restrict__ g,
                     float* __restrict__ grad, int C, int N, int L, int P,
                     int TC, int LC) {
  extern __shared__ __align__(16) float sm[];
  float* ws = sm;                 // (tc, P): the tile's w[c, n, :]
  float* rs = sm + TC * P;        // (tc, LC): one chunk's residuals
  const int tid = threadIdx.x;
  const int n = blockIdx.x, c0 = blockIdx.y * TC;
  const int tc = min(TC, C - c0);
  const int nout = tc * P;
  const float* Bn = B + (size_t)n * L * P;
  const float* yn = y + (size_t)n * L;
  for (int i = tid; i < nout; i += kThreads) {
    const int c = i / P, p = i - c * P;
    ws[i] = w[((size_t)(c0 + c) * N + n) * P + p];
  }
  float acc[kGradOuts];
#pragma unroll
  for (int k = 0; k < kGradOuts; ++k) acc[k] = 0.0f;

  for (int l0 = 0; l0 < L; l0 += LC) {
    const int lc = min(LC, L - l0);
    __syncthreads();              // ws is written; the last chunk is read
    for (int i = tid; i < tc * lc; i += kThreads) {
      const int c = i / lc, l = i - c * lc;
      const float* Bp = Bn + (size_t)(l0 + l) * P;
      const float* wp = ws + c * P;
      float m = 0.0f;
      for (int q = 0; q < P; ++q) m = fmaf(__ldg(Bp + q), wp[q], m);
      rs[c * LC + l] = __ldg(yn + l0 + l) - m;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kGradOuts; ++k) {
      const int o = tid + k * kThreads;
      if (o < nout) {
        const int c = o / P, p = o - c * P;
        const float* rp = rs + c * LC;
        const float* Bp = Bn + (size_t)l0 * P + p;
        float s = acc[k];
        for (int l = 0; l < lc; ++l)
          s = fmaf(__ldg(Bp + (size_t)l * P), rp[l], s);
        acc[k] = s;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kGradOuts; ++k) {
    const int o = tid + k * kThreads;
    if (o < nout) {
      const int c = o / P, p = o - c * P;
      grad[((size_t)(c0 + c) * N + n) * P + p] = (-2.0f * g[c0 + c]) * acc[k];
    }
  }
}

}  // namespace

// B (N, L, P), y (N, L), w (C, N, P), rss (C,), mu (C, N, L) or null, all
// contiguous float32; partial is scratch of ceil(N / TN) * C floats.  TC and
// TN are the plan's tile sizes: TC is 8, 24 or 40 for rss alone and kMuTile
// with mu, whose extra registers a larger tile would spill; TC * TN * P
// floats must fit the 48 KB of shared memory a block has without opting in.
extern "C" int bfmmm_mean_rss(const float* B, const float* y, const float* w,
                              float* rss, float* mu, float* partial, int C,
                              int N, int L, int P, int TC, int TN,
                              void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (TN < 1 || (size_t)TC * TN * P * sizeof(float) > 40 * 1024)
    return (int)cudaErrorInvalidValue;
  const int T = (N + TN - 1) / TN;
  const dim3 grid((C + TC - 1) / TC, T);
  const size_t smem = (size_t)TC * TN * P * sizeof(float);
  const int pv = (P == 8 || P == 16)
      && reinterpret_cast<std::uintptr_t>(B) % 16 == 0
      && reinterpret_cast<std::uintptr_t>(w) % 16 == 0 ? P : 0;
  if (mu) {
    if (TC != kMuTile) return (int)cudaErrorInvalidValue;
    launch_tile<kMuTile, true>(pv, B, y, w, partial, mu, C, N, L, P, TN, grid,
                               smem, stream);
  } else {
    switch (TC) {
      case 8:
        launch_tile<8, false>(pv, B, y, w, partial, nullptr, C, N, L, P, TN,
                              grid, smem, stream);
        break;
      case 24:
        launch_tile<24, false>(pv, B, y, w, partial, nullptr, C, N, L, P, TN,
                               grid, smem, stream);
        break;
      case 40:
        launch_tile<40, false>(pv, B, y, w, partial, nullptr, C, N, L, P, TN,
                               grid, smem, stream);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  mean_rss_sum_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, rss, C, T);
  return (int)cudaGetLastError();
}

// K2's backward: B (N, L, P), y (N, L), w (C, N, P), g (C,) in, grad
// (C, N, P) out, all contiguous float32.  TC and LC are the plan's chain
// tile and chunk of points: TC * P <= BFMMM_K2_GRAD_OUTPUTS outputs a block;
// the block's w and residuals, (TC * P + TC * LC) floats, must fit the
// shared memory a block has without opting in, or the launch fails.
extern "C" int bfmmm_mean_rss_grad(const float* B, const float* y,
                                   const float* w, const float* g,
                                   float* grad, int C, int N, int L, int P,
                                   int TC, int LC, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (TC < 1 || LC < 1 || TC * P > BFMMM_K2_GRAD_OUTPUTS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N, (C + TC - 1) / TC);
  const size_t smem = (size_t)(TC * P + TC * LC) * sizeof(float);
  mean_rss_grad_kernel<<<grid, kThreads, smem, stream>>>(B, y, w, g, grad, C,
                                                         N, L, P, TC, LC);
  return (int)cudaGetLastError();
}
