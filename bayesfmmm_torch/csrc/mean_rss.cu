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
// the forward writes nothing more than before.
//
// What bounds it on the card: neither bytes nor FLOP.  At the HMC path's
// C = 64, N = L = 100, P = 8 the f32 arithmetic (4P + 1 FLOP a chain and
// point) is 0.32 us and the bytes 0.23 us; what a call costs is latency:
// the launch, one round trip to L2 for B[n] and y[n], and the longest
// chain of dependent steps a thread runs.  The tensor cores do not help:
// TF32 keeps ~3 digits where the gradient is held to 2e-5 of its largest
// entry, and the arithmetic they would speed up is not what takes the time.
//
// Design: a block owns one observation n (blockIdx.x) and TC chains
// (blockIdx.y); a group of S = SL x SP lanes of one warp owns one chain.
//   * B[n] and y[n] go to shared memory by cp.async, every copy of the
//     block in flight before one wait and one barrier; the lanes' w[c, n, :]
//     and g[c] are read into registers meanwhile.  At P = 8 or 16 with B,
//     w and grad 16-byte aligned, B, w and grad move 16 bytes at a time;
//     any other P up to 16 (or an unaligned view) is copied 4 bytes at a
//     time into rows padded with zeros to 8 or 16 floats, so the arithmetic
//     is the same.  Where the rows do not fit ops/kernels.py's K2_GRAD_SMEM
//     the points come LC at a time through two buffers, the next chunk's
//     copy in flight while this one is used (two barriers a chunk).
//   * One pass: lane sl of a chain takes the points l = sl, sl + SL, ...,
//     U a loop step (4 at P <= 8, 2 at 16); for each it reads the row
//     B[n, l, :] from shared memory once (float4s), forms r = y[l] - B[l, :] w
//     (the P-term dot product in the order p = 0..P-1) and adds r B[l, p]
//     into P accumulators in registers, reusing the row.  No residual
//     buffer, no second pass over B.
//   * A P above 16 is split over SP lanes as well (lane sp holds
//     p = sp, sp + SP, ...; KP = 16 or 40 of them at most, read 4 bytes at a
//     time): their partial dot products meet in an xor-shuffle tree, which
//     leaves the same bits in every lane.
//   * The SL lanes' accumulators meet in an xor-shuffle tree; the lanes
//     then write grad[c, n, :] = -2 g[c] acc, a float4 each where aligned.
//     No atomics: the same input gives the same bits on every run, aligned
//     or not, and the order of the sums is ops/kernels.py::
//     mean_rss_grad_tiled_plain's.
//   * SL is the smallest power of two that puts about K2_GRAD_WANT threads
//     on the card, at most a warp: one chain and four take a warp each,
//     64 a few lanes (more lanes cost more in shuffles and in blocks that
//     stage the same B[n] than they save in points a lane).
// Where the time goes (utils/k2_grad_probe.py on the card): at 64 chains
// the points loop is about half of the call at P = 8 and three quarters at
// P = 16, the dot products a fraction of it; the copies, the barrier and
// the shuffle tree are a few tenths of a microsecond each, the rest the
// launch.  ptxas issues the U points of an iteration one after another;
// interleaving their dot products by hand or loading the next points'
// rows ahead did not make the loop faster, nor did other U.
// The lanes, tiles, chunk and shared memory come from ops/kernels.py::
// mean_rss_grad_plan.

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

// K2's backward: threads a block at most, and shared memory a block fills
// (ops/kernels.py's K2_GRAD_THREADS and K2_GRAD_SMEM).
constexpr int kGradThreads = 256;
constexpr int kGradSmem = 48 * 1024;

// KP: floats of w (and accumulators) a lane holds.  SPLIT = false: SP = 1,
// P <= KP (8 or 16), B's rows KP floats apart in shared memory (zeros past
// P) and read as float4s; with A16 (P == KP, B, w and grad 16-byte
// aligned) rows, w and grad move 16 bytes at a time, else 4.  SPLIT: SP
// lanes split P, rows P floats apart, read 4 bytes at a time.
template <int KP, bool SPLIT>
__global__ void __launch_bounds__(kGradThreads)
mean_rss_grad_kernel(const float* __restrict__ B, const float* __restrict__ y,
                     const float* __restrict__ w, const float* __restrict__ g,
                     float* __restrict__ grad, int C, int N, int L, int P,
                     int SP, int SL, int TC, int LC, bool A16) {
  constexpr int U = KP <= 8 ? 4 : (KP <= 16 ? 2 : 1);  // points a step
  extern __shared__ __align__(16) float sm[];
  const int PS = SPLIT ? P : KP;           // floats from row to row
  const int nbuf = L > LC ? 2 : 1;
  float* Bs = sm;                          // (nbuf, LC, PS)
  float* ys = sm + nbuf * LC * PS;         // (nbuf, LC)
  const int tid = threadIdx.x, T = blockDim.x;
  // SP and SL are powers of two: shifts and masks, no division
  const int lsp = __ffs(SP) - 1, ls = lsp + __ffs(SL) - 1;
  const int q = tid & ((1 << ls) - 1);
  const int sp = q & (SP - 1), sl = q >> lsp;
  const int n = blockIdx.x, c = blockIdx.y * TC + (tid >> ls);
  const bool live = c < C;                 // groups past C write nothing
  const float* Bn = B + (size_t)n * L * P;
  const float* yn = y + (size_t)n * L;
  const int nch = (L + LC - 1) / LC;

  auto stage = [&](int ch) {               // chunk ch into buffer ch & 1
    const int l0 = ch * LC, lc = min(LC, L - l0);
    float* Bd = Bs + (ch & 1) * LC * PS;
    float* yd = ys + (ch & 1) * LC;
    const float* src = Bn + (size_t)l0 * P;
    if (!SPLIT && A16) {                   // rows back to back
      for (int i = tid; i < lc * KP / 4; i += T)
        __pipeline_memcpy_async(Bd + 4 * i, src + 4 * i, 16);
    } else if (!SPLIT) {                   // rows padded to KP floats
      for (int i = tid; i < lc * P; i += T) {
        const int l = i / P;
        __pipeline_memcpy_async(Bd + l * KP + (i - l * P), src + i, 4);
      }
    } else {
      for (int i = tid; i < lc * P; i += T)
        __pipeline_memcpy_async(Bd + i, src + i, 4);
    }
    for (int i = tid; i < lc; i += T)
      __pipeline_memcpy_async(yd + i, yn + l0 + i, 4);
    __pipeline_commit();
  };
  stage(0);
  if (!SPLIT && P < KP) {                  // the pads, once for both buffers
    const int pad = KP - P;
    for (int i = tid; i < nbuf * LC * pad; i += T) {
      const int r = i / pad;
      Bs[r * KP + P + (i - r * pad)] = 0.0f;
    }
  }

  float wr[KP], acc[KP];
  const float* wc = w + ((size_t)(live ? c : 0) * N + n) * P;
#pragma unroll
  for (int k = 0; k < KP; ++k) acc[k] = 0.0f;
  if (!SPLIT && A16) {
#pragma unroll
    for (int k = 0; k < KP; k += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(wc) + k / 4);
      wr[k] = v.x; wr[k + 1] = v.y; wr[k + 2] = v.z; wr[k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int p = SPLIT ? sp + k * SP : k;
      wr[k] = p < P ? __ldg(wc + p) : 0.0f;
    }
  }
  const float scale = -2.0f * __ldg(g + (live ? c : 0));

  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      stage(ch + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();                       // chunk ch is in shared memory
    const int lc = min(LC, L - ch * LC);
    const float* Bc = Bs + (ch & 1) * LC * PS;
    const float* yc = ys + (ch & 1) * LC;
    // the same trip count in every lane: the shuffles below need the warp
    for (int j0 = 0; j0 < lc; j0 += U * SL) {
      float b[U][KP], yv[U], m[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = j0 + u * SL + sl;
        const bool ok = i < lc;            // past the chunk: B = 0, y = 0
        const float* row = Bc + (size_t)(ok ? i : 0) * PS;
        if (!SPLIT) {
#pragma unroll
          for (int k = 0; k < KP; k += 4) {
            const float4 v = reinterpret_cast<const float4*>(row)[k / 4];
            b[u][k] = ok ? v.x : 0.0f;
            b[u][k + 1] = ok ? v.y : 0.0f;
            b[u][k + 2] = ok ? v.z : 0.0f;
            b[u][k + 3] = ok ? v.w : 0.0f;
          }
        } else {
#pragma unroll
          for (int k = 0; k < KP; ++k) {
            const int p = sp + k * SP;
            b[u][k] = ok && p < P ? row[p] : 0.0f;
          }
        }
        yv[u] = ok ? yc[i] : 0.0f;
        m[u] = 0.0f;
#pragma unroll
        for (int k = 0; k < KP; ++k) m[u] = fmaf(b[u][k], wr[k], m[u]);
      }
      if (SPLIT) {                         // the SP lanes' partial products
#pragma unroll
        for (int u = 0; u < U; ++u)
          for (int o = 1; o < SP; o <<= 1)
            m[u] += __shfl_xor_sync(0xffffffffu, m[u], o);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float r = yv[u] - m[u];
#pragma unroll
        for (int k = 0; k < KP; ++k) acc[k] = fmaf(r, b[u][k], acc[k]);
      }
    }
    if (ch + 1 < nch) __syncthreads();     // the buffer is free to refill
  }

  for (int o = SP; o < SP * SL; o <<= 1) {    // the SL lanes' sums
#pragma unroll
    for (int k = 0; k < KP; ++k)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
  }
  if (!live) return;
  float* gc = grad + ((size_t)c * N + n) * P;
  if (!SPLIT && A16) {
#pragma unroll
    for (int k = 0; k < KP; k += 4)
      if (((k / 4) & (SL - 1)) == sl)
        reinterpret_cast<float4*>(gc)[k / 4] = make_float4(
            scale * acc[k], scale * acc[k + 1], scale * acc[k + 2],
            scale * acc[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int p = SPLIT ? sp + k * SP : k;
      if (p < P && (k & (SL - 1)) == sl) gc[p] = scale * acc[k];
    }
  }
}

template <int KP, bool SPLIT>
void launch_grad(const float* B, const float* y, const float* w,
                 const float* g, float* grad, int C, int N, int L, int P,
                 int SP, int SL, int TC, int LC, bool a16, size_t smem,
                 cudaStream_t stream) {
  const dim3 grid(N, (C + TC - 1) / TC);
  mean_rss_grad_kernel<KP, SPLIT><<<grid, TC * SP * SL, smem, stream>>>(
      B, y, w, g, grad, C, N, L, P, SP, SL, TC, LC, a16);
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
// (C, N, P) out, all contiguous float32.  KP, SP, SL, TC and LC are
// ops/kernels.py::mean_rss_grad_plan's: KP floats a lane (8 or 16 with
// SP = 1, else 16 or 40), SP lanes splitting P and SL splitting the points
// (powers of two, SP * SL <= 32, KP * SP >= P), TC chains a block
// (TC * SP * SL threads, a multiple of 32, at most kGradThreads), LC
// points a chunk (a multiple of SL when L > LC); the chunks' shared memory
// within kGradSmem.  Aligned or not, the sums run in the same order: the
// same bits.
extern "C" int bfmmm_mean_rss_grad(const float* B, const float* y,
                                   const float* w, const float* g,
                                   float* grad, int C, int N, int L, int P,
                                   int KP, int SP, int SL, int TC, int LC,
                                   void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const bool split = SP > 1;
  const int S = SP * SL, T = TC * S, nbuf = L > LC ? 2 : 1;
  const size_t smem =
      (size_t)nbuf * LC * ((split ? P : KP) + 1) * sizeof(float);
  if (SP < 1 || SL < 1 || (SP & (SP - 1)) || (SL & (SL - 1)) || S > 32 ||
      TC < 1 || T > kGradThreads || T % 32 || LC < 1 ||
      (nbuf == 2 && LC % SL) || KP * SP < P || smem > kGradSmem)
    return (int)cudaErrorInvalidValue;
  const auto a16 = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const bool vec = !split && P == KP && a16(B) && a16(w) && a16(grad);
  if (!split && KP == 8)
    launch_grad<8, false>(B, y, w, g, grad, C, N, L, P, SP, SL, TC, LC, vec,
                          smem, stream);
  else if (!split && KP == 16)
    launch_grad<16, false>(B, y, w, g, grad, C, N, L, P, SP, SL, TC, LC, vec,
                           smem, stream);
  else if (split && KP == 16)
    launch_grad<16, true>(B, y, w, g, grad, C, N, L, P, SP, SL, TC, LC, false,
                          smem, stream);
  else if (split && KP == 40)
    launch_grad<40, true>(B, y, w, g, grad, C, N, L, P, SP, SL, TC, LC, false,
                          smem, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
