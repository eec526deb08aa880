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
// What bounds it on the card: bytes read.  Each chain reads B once
// (N*L*P*4 = 320 KB at N = L = 100, P = 8) and does 2*N*L*P FLOP, a few
// FLOP per byte, far below the point where arithmetic would limit it.  B is
// shared, so after the first chains it is served from the 50 MB L2.
//
// Design: one block per chain, threads striding over the N*L points; each
// point's P-term dot product, residual and square stay in registers, so mu
// never goes to device memory unless asked for.  Each thread accumulates
// its points in a fixed order, then a warp-shuffle tree and one pass over
// the warp partials reduce the block: no atomics, so the same input gives
// the same bits on every run.  The TPU kernel's per-tile partial sums,
// added by the caller, are replaced by this in-block reduction.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads)
mean_rss_kernel(const float* __restrict__ B, const float* __restrict__ y,
                const float* __restrict__ w, float* __restrict__ rss,
                float* __restrict__ mu, int N, int L, int P) {
  __shared__ float part[kWarps];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int NL = N * L;
  const float* wc = w + (size_t)c * N * P;
  float* muc = mu ? mu + (size_t)c * NL : nullptr;

  float acc = 0.0f;
  for (int idx = tid; idx < NL; idx += kThreads) {
    const float* Bp = B + (size_t)idx * P;
    const float* wp = wc + (size_t)(idx / L) * P;
    float m = 0.0f;
    for (int p = 0; p < P; ++p) m = fmaf(Bp[p], wp[p], m);
    if (muc) muc[idx] = m;
    const float r = y[idx] - m;
    acc = fmaf(r, r, acc);
  }

  acc = warp_sum(acc);
  if ((tid & 31) == 0) part[tid >> 5] = acc;
  __syncthreads();
  if (tid < 32) {
    acc = warp_sum(tid < kWarps ? part[tid] : 0.0f);
    if (tid == 0) rss[c] = acc;
  }
}

}  // namespace

extern "C" int bfmmm_mean_rss(const float* B, const float* y, const float* w,
                              float* rss, float* mu, int C, int N, int L,
                              int P, void* stream) {
  mean_rss_kernel<<<C, kThreads, 0, (cudaStream_t)stream>>>(B, y, w, rss, mu,
                                                            N, L, P);
  return (int)cudaGetLastError();
}
