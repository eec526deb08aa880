// K3: weighted Gram sums, out[r] = sum_n W[r, n] G[n], for many rows r.
//
// Replaces bayesfmmm_tpu/ops/pallas_kernels.py::weighted_gram (kernel body
// _weighted_gram_kernel), which forms one (P, P) sum per call.  Here every
// row of W (R, N) gets its own sum over the shared G (N, P, P):
//   out[r, p, q] = sum_n W[r, n] G[n, p, q]
// This is the data-precision block of the blocked Gibbs updates; in
// update_nu the rows are (chain, feature) pairs with weights Z_nk^2.
//
// What bounds it on the card: bytes by the count (0.53 MB and 9.8 MFLOP at
// the main path's R = 768, N = 100, P = 8: 0.16 us of either), so in
// practice latency: the launch, one round trip to L2 for the inputs, and
// then each SM's reads of shared memory in the N-long loop behind it.
//
// Design of the tiled kernel (P <= 16, P * P a multiple of 4, and G plus a
// block's rows of W within one block's shared memory; ops/kernels.py::
// weighted_gram_plan chooses it and its tile):
//   * A block of 128 threads owns TR = 128 / (P * P / 4) consecutive rows
//     of W and every (p, q) column; R = 768 gives 96 blocks of 8 rows, one
//     wave, so G is staged 96 times a call.  Fewer, larger blocks (48 of
//     16 rows) stage G less often and were slower on the card: the loop's
//     shared-memory reads per SM grow with the rows a block owns, and L2
//     delivers G to 96 SMs as fast as to 48.
//   * All of a block's loads are started at once with cp.async, behind one
//     wait and one barrier: G is one contiguous run, and so are the
//     block's rows of W, since W is contiguous.  Each run goes in 16-byte
//     copies when source and destination are 16-byte aligned (G's base
//     address; for W also TR * N a multiple of 4) and in 4-byte copies
//     otherwise.  Copying G in 2, 4 or 8 slabs, each with its own wait and
//     barrier so the sums over the first start while the rest arrive, was
//     slower on the card by 0.4 us a slab: a barrier costs more than the
//     overlap saves.
//   * Each thread owns one row by one float4 of (p, q) columns and sums
//     over n = 0..N-1 in registers: per n one 16-byte read of G and one
//     4-byte read of W from shared memory for 4 multiply-adds (2 reads per
//     4, against 2 per 1 with one output a thread).  Neighbouring threads
//     read neighbouring float4s of G; the W reads are broadcasts.  The
//     loop takes 4 steps of n at a time, reads first, so the reads'
//     latency is paid once per 4 steps.  With 2 or 4 rows a thread a block
//     of the same rows has too few warps to hide the loop's latency: both
//     were slower on the card at every block size, and so were 64 and 256
//     threads a block.
// Any other shape takes the chunked kernel: one thread per output, G and W
// staged through 48 KB of shared memory in N-chunks with 4-byte loads.
// Both sum over n in the same fixed order with no atomics and no second
// pass: the same input gives the same bits on every run, and the same bits
// from either kernel.  The TPU kernel's per-tile partial sums, added by
// its caller, are an artifact of its sequential grid and are not carried
// over.  Ragged R, N and P * P are masked here.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Copy n floats from global src to shared dst, asynchronously: 16 bytes at
// a time when `wide` (both 16-byte aligned), the tail and otherwise 4.
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            int n, bool wide, int tid,
                                            int threads) {
  const int n4 = wide ? n / 4 : 0;
  for (int i = tid; i < n4; i += threads)
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  for (int i = 4 * n4 + tid; i < n; i += threads)
    __pipeline_memcpy_async(dst + i, src + i, 4);
}

constexpr int kBatch = 4;
constexpr int kTileThreads = 128;

__global__ void __launch_bounds__(kTileThreads)
weighted_gram_tile_kernel(const float* __restrict__ W,
                          const float* __restrict__ G,
                          float* __restrict__ out, int R, int N, int PP,
                          bool g_wide, bool w_wide) {
  extern __shared__ __align__(16) float smem[];
  float* Gs = smem;                 // (N, PP)
  float* Ws = smem + N * PP;        // (TR, N); N * PP is a multiple of 4
  const int tid = threadIdx.x;
  const int CG = PP / 4, TR = kTileThreads / CG;
  const int r0 = blockIdx.x * TR;
  const int rows = min(TR, R - r0);

  stage_async(Gs, G, N * PP, g_wide, tid, kTileThreads);
  stage_async(Ws, W + (size_t)r0 * N, rows * N, w_wide, tid, kTileThreads);
  __pipeline_commit();
  // rows past the ragged edge take zeros; their sums are never written
  for (int i = rows * N + tid; i < TR * N; i += kTileThreads) Ws[i] = 0.0f;
  __pipeline_wait_prior(0);
  __syncthreads();

  const int rl = tid / CG, cg = tid - rl * CG;
  if (rl >= TR) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* wr = Ws + rl * N;
  const float* gc = Gs + 4 * cg;
  // kBatch steps of n at a time: their reads of shared memory are started
  // together, ahead of the multiply-adds, which still run in the order of n
  int n = 0;
  for (; n + kBatch <= N; n += kBatch) {
    float4 g[kBatch];
    float wv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      g[u] = *reinterpret_cast<const float4*>(gc + (n + u) * PP);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) wv[u] = wr[n + u];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      acc.x = fmaf(wv[u], g[u].x, acc.x);
      acc.y = fmaf(wv[u], g[u].y, acc.y);
      acc.z = fmaf(wv[u], g[u].z, acc.z);
      acc.w = fmaf(wv[u], g[u].w, acc.w);
    }
  }
  for (; n < N; ++n) {
    const float4 g = *reinterpret_cast<const float4*>(gc + n * PP);
    const float wv = wr[n];
    acc.x = fmaf(wv, g.x, acc.x);
    acc.y = fmaf(wv, g.y, acc.y);
    acc.z = fmaf(wv, g.z, acc.z);
    acc.w = fmaf(wv, g.w, acc.w);
  }
  const int r = r0 + rl;
  if (r < R) *reinterpret_cast<float4*>(out + (size_t)r * PP + 4 * cg) = acc;
}

constexpr int kChunkThreads = 256;
// Dynamic shared memory a block may use without opting in (48 KB).
constexpr int kChunkFloats = 48 * 1024 / 4;

__global__ void __launch_bounds__(kChunkThreads)
weighted_gram_chunk_kernel(const float* __restrict__ W,
                           const float* __restrict__ G,
                           float* __restrict__ out, int R, int N, int PP,
                           int TR, int QT, int NC) {
  extern __shared__ __align__(16) float smem[];
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
    for (int i = tid; i < nc * QT; i += kChunkThreads) {
      const int n = i / QT, j = i % QT;
      Gs[i] = q0 + j < PP ? G[(size_t)(n0 + n) * PP + q0 + j] : 0.0f;
    }
    for (int i = tid; i < TR * nc; i += kChunkThreads) {
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

cudaError_t launch_tile(const float* W, const float* G, float* out, int R,
                        int N, int PP, cudaStream_t stream) {
  if (PP % 4 != 0 || PP / 4 > kTileThreads) return cudaErrorInvalidValue;
  const int TR = kTileThreads / (PP / 4);
  const size_t smem = ((size_t)N * PP + (size_t)TR * N) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        weighted_gram_tile_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  const bool g_wide = reinterpret_cast<std::uintptr_t>(G) % 16 == 0;
  const bool w_wide = reinterpret_cast<std::uintptr_t>(W) % 16 == 0
                      && ((size_t)TR * N) % 4 == 0;
  weighted_gram_tile_kernel<<<(R + TR - 1) / TR, kTileThreads, smem, stream>>>(
      W, G, out, R, N, PP, g_wide, w_wide);
  return cudaGetLastError();
}

}  // namespace

// W (R, N), G (N, P, P) and out (R, P, P), all contiguous float32.  `tiled`
// asks for the tiled kernel, which needs P * P a multiple of 4 and at most
// 4 * 128, and G with a block's rows of W within a block's shared memory;
// otherwise the chunked kernel runs.
extern "C" int bfmmm_weighted_gram(const float* W, const float* G, float* out,
                                   int R, int N, int P, int tiled,
                                   void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const int PP = P * P;
  if (tiled) return (int)launch_tile(W, G, out, R, N, PP, stream);
  const int QT = PP < kChunkThreads ? PP : kChunkThreads;  // columns a block
  const int TR = kChunkThreads / QT;                       // rows a block
  int NC = kChunkFloats / (QT + TR);                       // N-chunk staged
  if (NC > N) NC = N;
  if (NC < 1) NC = 1;
  const dim3 grid((R + TR - 1) / TR, (PP + QT - 1) / QT);
  const size_t smem = (size_t)NC * (QT + TR) * sizeof(float);
  weighted_gram_chunk_kernel<<<grid, kChunkThreads, smem, stream>>>(
      W, G, out, R, N, PP, TR, QT, NC);
  return (int)cudaGetLastError();
}
