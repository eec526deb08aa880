// K3: weighted Gram sums, out[r] = sum_n W[r, n] G[n], for many rows r.
//
// Replaces bayesfmmm_tpu/ops/pallas_kernels.py::weighted_gram (kernel body
// _weighted_gram_kernel), which forms one (P, P) sum per call.  Here every
// row of W (R, N) gets its own sum over the shared G (N, P, P):
//   out[r, p, q] = sum_n W[r, n] G[n, p, q]
// This is the data-precision block of the blocked Gibbs updates; in
// update_nu the rows are (chain, feature) pairs with weights Z_nk^2.
//
// What bounds it on the card: latency.  At the main path's shape (R = 768,
// N = 100, P = 8) a call is ~5 M multiply-adds and ~0.5 MB of reads and
// writes (G is 25.6 KB, W 307 KB, out 197 KB), a few microseconds of either
// on an H100, so the launch and one round trip to L2 are the cost.
//
// Design: one block per tile of rows and of (p, q) columns; one thread per
// output.  The block stages G, whole when it fits (it does at N = 100,
// P = 8) and in N-chunks otherwise, in shared memory beside its rows of W,
// then each thread sums its output over n in a fixed order, chunk after
// chunk, in a register.  When a block takes every (p, q) column (P <= 16)
// its chunk of G is one contiguous run, staged with 16-byte loads: with
// one 4-byte load at a time each thread waited on ~25 dependent L2 round
// trips, which took 9.7 us a call at the main path's shape against 5.5 us
// with the wide loads (NVIDIA H100 80GB HBM3, 700 W).  Neighbouring
// threads read neighbouring (p, q) entries of G, and a warp reads one W
// entry, which shared memory broadcasts.  No atomics and no second pass:
// the same input gives the same bits on every run.  The TPU kernel's
// per-tile partial sums, added by the caller, are an artifact of its
// sequential grid and are not carried over.  Ragged R, N and P*P are
// masked here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Dynamic shared memory a block may use without opting in (48 KB).
constexpr int kSmemFloats = 48 * 1024 / 4;

__global__ void __launch_bounds__(kThreads)
weighted_gram_kernel(const float* __restrict__ W, const float* __restrict__ G,
                     float* __restrict__ out, int R, int N, int PP, int TR,
                     int QT, int NC, bool vec) {
  extern __shared__ float smem[];
  float* Gs = smem;              // (NC, QT): G[n0 + i, q0 + j]
  float* Ws = smem + NC * QT;    // (TR, NC): W[r0 + i, n0 + j]
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * TR, q0 = blockIdx.y * QT;
  const int rl = tid / QT, ql = tid % QT;
  const int r = r0 + rl, q = q0 + ql;
  const bool mine = rl < TR && r < R && q < PP;

  float acc = 0.0f;
  for (int n0 = 0; n0 < N; n0 += NC) {
    const int nc = min(NC, N - n0);
    __syncthreads();             // the previous chunk is consumed
    if (vec) {                   // QT == PP, a multiple of 4, aligned
      const float4* src = reinterpret_cast<const float4*>(G + (size_t)n0 * PP);
      float4* dst = reinterpret_cast<float4*>(Gs);
#pragma unroll 4
      for (int i = tid; i < nc * QT / 4; i += kThreads) dst[i] = src[i];
    } else {
      for (int i = tid; i < nc * QT; i += kThreads) {
        const int n = i / QT, j = i % QT;
        Gs[i] = q0 + j < PP ? G[(size_t)(n0 + n) * PP + q0 + j] : 0.0f;
      }
    }
    for (int i = tid; i < TR * nc; i += kThreads) {
      const int rr = i / nc, n = i % nc;
      Ws[rr * NC + n] = r0 + rr < R ? W[(size_t)(r0 + rr) * N + n0 + n]
                                    : 0.0f;
    }
    __syncthreads();
    if (mine) {
      const float* wr = Ws + rl * NC;
      for (int n = 0; n < nc; ++n) acc = fmaf(wr[n], Gs[n * QT + ql], acc);
    }
  }
  if (mine) out[(size_t)r * PP + q] = acc;
}

}  // namespace

// W (R, N), G (N, P, P) and out (R, P, P), all contiguous float32.
extern "C" int bfmmm_weighted_gram(const float* W, const float* G, float* out,
                                   int R, int N, int P, void* stream) {
  const int PP = P * P;
  const int QT = PP < kThreads ? PP : kThreads;     // (p, q) columns a block
  const int TR = kThreads / QT;                     // rows a block
  int NC = kSmemFloats / (QT + TR);                 // N-chunk staged at once
  if (NC > N) NC = N;
  if (NC < 1) NC = 1;
  // Gs starts the shared buffer, so only G's own alignment needs a check
  const bool vec = QT == PP && PP % 4 == 0
                   && reinterpret_cast<std::uintptr_t>(G) % 16 == 0;
  const dim3 grid((R + TR - 1) / TR, (PP + QT - 1) / QT);
  const size_t smem = (size_t)NC * (QT + TR) * sizeof(float);
  weighted_gram_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      W, G, out, R, N, PP, TR, QT, NC, vec);
  return (int)cudaGetLastError();
}
