// K1: per-chain Cholesky factor-and-solve of the joint precision draw.
//
// Replaces bayesfmmm_tpu/ops/pallas_kernels.py::chol_solve_batch_minor
// (kernel body _chol_solve_kernel).  For each chain c, given an SPD
// A_c (D x D, row-major), b_c and z_c (D), it computes L = chol(A_c),
// mean_c = L^-T L^-1 b_c and noise_c = L^-T z_c in one launch: the
// N(A^-1 b, A^-1) draw of update_phi's joint block (D = K*M*P = 96 and
// C = 256 chains on the main path).  With jitter > 0 it factors
// A_c + jitter * (tr(A_c) / D + 1) * I, adding to the diagonal it holds on
// chip, so no caller builds that matrix in device memory.
//
// What bounds it on the card.  By the count, bytes: one triangle of A, b
// and z in, mean and noise out are 5.16 MB at the main path's shape, 1.5 us
// at the card's memory rate, and D^3/3 multiply-adds a chain are less.  In
// practice neither: the factorization is a chain of D dependent column
// steps (the next diagonal is known only after this column's update), and
// the two back substitutions are D more.  The time is 2*D steps times the
// latency of one step, so the design makes a step short and keeps as much
// of the card busy beside it as the dependency allows: one block per chain,
// two blocks an SM, all 256 chains resident at once.
//
// The tiled kernel (D <= 128; ops/kernels.py::chol_solve_plan chooses it):
//   * The matrix lives in registers.  The block's 256 threads form a
//     16 x 16 grid; thread (r, c) owns the entries (i, k) with i = r and
//     k = c mod 16, a TS x TS tile (6 x 6 at D <= 96, 8 x 8 up to 128).
//     The cyclic layout keeps every thread busy until the last columns.
//     D below 16 * TS is padded with the identity in registers, never in
//     memory.  All register indices are compile-time constants: the column
//     loop is an unrolled loop over blocks of 16 columns with a run-time
//     loop inside, in which the owner is found by comparing thread
//     coordinates.
//   * Column step j: the 16 threads that own column j (one half-warp:
//     thread ids run along r first) get the diagonal by a warp shuffle (in
//     which every warp takes part, so it stands under no branch), take one
//     reciprocal square root, scale their entries and publish the column of
//     L to a D-float buffer in shared memory.  After ONE barrier every
//     thread reads its TS row values and TS column values with 8-byte loads
//     (the buffer is laid out thread by thread: at most TS loads for up to
//     TS * (TS + 1) / 2 multiply-adds) and updates its tile in registers.  Tile blocks wholly above the diagonal or in finished
//     columns are skipped at compile time; the blocks on the diagonal are
//     updated whole, which costs multiply-adds and no predicate.  Two
//     buffers are used in turn, so the owners of column j + 1 do not wait
//     for the readers of column j.  Rows above j are published as zeros,
//     which makes the update of finished rows a no-op.
//   * No division stands in a dependent chain: rsqrtf once a column, kept
//     for the substitutions, which multiply by it.
//   * The forward solve rides along: b is one more row of the matrix, held
//     by the threads r = 0, and the same column step turns it into
//     w = L^-1 b.
//   * Each finished column of L is also written once to shared memory, row
//     by row (L[i][j] at i * LD + j), and one warp then runs both back
//     substitutions together: u and v in registers, x_j broadcast by
//     shuffle, one conflict-free row of L read a step, no barrier.
//   * A is staged with 16-byte cp.async copies, only the groups on or below
//     the diagonal (when A is 16-byte aligned and D a multiple of 4; 4-byte
//     copies otherwise), into the area that later holds L.
//   * tr(A) for the jitter is summed from the registers in a fixed order
//     (shuffle tree, then warp by warp): the same bits on every call.
//   What the card chose (256 chains, D = 96, variants timed in one call):
//   other thread grids (8 x 16 and 16 x 8 with 12 x 6 tiles), two chains a
//   block, the 8 x 8 tile at D = 96, publishing column j + 1 before the
//   rest of column j's update, and moving the stores of L after the barrier
//   or to other threads were all slower or the same; none is kept.  With
//   parts knocked out (timing only): the wait at the barrier for the owners
//   is 10 us of a call, the back substitutions 3, the staging of A 2.  A
//   step is latency: barrier, shared-memory read, multiply-adds, shuffle,
//   rsqrtf, shared-memory write.
// The shared-memory kernel (every other D up to 240, the largest whose
// D*D + 2*D floats fit one block's 227 KB) keeps the matrix in shared
// memory: right-looking, two barriers a column, finished columns mirrored
// along rows, the three substitutions in one warp.
// No batch-minor transpose and no 128-lane padding: the TPU kernel needed
// both to put chains on vector lanes; here chains are blocks.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullWarp, s, o);
  return s;
}

// ---------------------------------------------------------------------------
// The tiled kernel: matrix in registers
// ---------------------------------------------------------------------------

// 16 x 16 threads a block; thread (r, c) owns the entries (i, k) with
// i % 16 == r and k % 16 == c, a TS x TS tile.
constexpr int kGrid = 16;
constexpr int kTiledThreads = kGrid * kGrid;
constexpr int kTiledWarps = kTiledThreads / 32;

template <int TS>
struct Tile {
  static constexpr int DP = kGrid * TS;         // rows and columns covered
  static constexpr int LD = DP + 4;             // row stride of the L area
  static constexpr int TSP = TS + (TS & 1);     // padded for 8-byte loads
  // A column buffer: L[i][j] at (i % 16) * TSP + i / 16, so a thread reads
  // its rows at r * TSP and its columns at c * TSP; then w_j.
  static constexpr int WSLOT = kGrid * TSP;
  static constexpr int BUF = WSLOT + 4;
  static constexpr int NV = DP / 32;            // values a lane of the solve
  // floats of shared memory: L, two buffers, 1/L_jj, w, the warps' sums
  static constexpr int FLOATS = DP * LD + 2 * BUF + 2 * DP + kTiledWarps;
  static_assert(DP % 32 == 0, "the solve's lanes cover whole rows");
};

template <int TS>
__global__ void __launch_bounds__(kTiledThreads, 2)
chol_tiled_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  const float* __restrict__ z, float* __restrict__ mean,
                  float* __restrict__ noise, int D, float jitter, bool wide) {
  using K = Tile<TS>;
  constexpr int T = kTiledThreads, G = kGrid, LD = K::LD, TSP = K::TSP;
  constexpr int NV = K::NV;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int r = t % G, c = t / G, warp = t / 32, lane = t % 32;
  float* S = smem;                       // (DP, LD): A staged, then L
  float* buf = S + K::DP * LD;           // two column buffers
  float* rinv = buf + 2 * K::BUF;        // 1 / L_jj
  float* wsh = rinv + K::DP;             // w = L^-1 b
  float* red = wsh + K::DP;              // the warps' sums of the trace
  const float* Ag = A + (size_t)blockIdx.x * D * D;
  const size_t off_v = (size_t)blockIdx.x * D;

  // stage the groups of A on or below the diagonal
  if (wide) {
    const int G4 = D / 4;
    for (int idx = t; idx < D * G4; idx += T) {
      const int i = idx / G4, g = idx - i * G4;
      if (4 * g <= i)
        __pipeline_memcpy_async(S + i * LD + 4 * g, Ag + (size_t)i * D + 4 * g,
                                16);
    }
  } else {
    for (int idx = t; idx < D * D; idx += T) {
      const int i = idx / D, k = idx - i * D;
      if (k <= i)
        __pipeline_memcpy_async(S + i * LD + k, Ag + (size_t)i * D + k, 4);
    }
  }
  __pipeline_commit();
  float wb[TS];                          // the row b, held where r == 0
#pragma unroll
  for (int bi = 0; bi < TS; ++bi) {
    const int k = c + G * bi;
    wb[bi] = (r == 0 && k < D) ? b[off_v + k] : 0.0f;
  }
  float v[NV];                           // z, in the warp of the solves
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const int i = t + 32 * m;
    v[m] = (t < 32 && i < D) ? z[off_v + i] : 0.0f;
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // the tile: A below and on the diagonal, the identity past D; the tile
  // blocks above the diagonal (ai < bi) are never touched
  float a[TS][TS];
  float part = 0.0f;
#pragma unroll
  for (int ai = 0; ai < TS; ++ai) {
#pragma unroll
    for (int bi = 0; bi <= ai; ++bi) {
      const int i = r + G * ai, k = c + G * bi;
      a[ai][bi] = i == k ? 1.0f : 0.0f;
      if (i < D && k <= i) a[ai][bi] = S[i * LD + k];
      if (i == k && i < D) part += a[ai][bi];
    }
  }
  if (jitter != 0.0f) {
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
  }
  __syncthreads();                       // S is read; the trace is summed
  if (jitter != 0.0f) {
    float tr = 0.0f;
#pragma unroll
    for (int w = 0; w < kTiledWarps; ++w) tr += red[w];
    const float eps = jitter * (tr / (float)D + 1.0f);
    if (r == c) {
#pragma unroll
      for (int ai = 0; ai < TS; ++ai)
        if (r + G * ai < D) a[ai][ai] += eps;
    }
  }

  // the factorization, with w = L^-1 b riding along: column j = 16 jb + jj
  // lies in the tile blocks (., jb) of the threads c == jj, its diagonal in
  // block (jb, jb) of thread (jj, jj)
#pragma unroll
  for (int jb = 0; jb < TS; ++jb) {
    const int jn = min(G, D - G * jb);
    for (int jj = 0; jj < jn; ++jj) {
      const int j = G * jb + jj;
      float* bw = buf + (j & 1) * K::BUF;
      // Every warp shuffles, though only the warp jj / 2 that owns column j
      // reads the diagonal: a shuffle under a branch costs that warp a
      // reconvergence every column (3.4 us of 27 a call on the card).
      const float d = __shfl_sync(kFullWarp, a[jb][jb], (jj % 2) * G + jj);
      if (c == jj) {
        const float inv = rsqrtf(d);
#pragma unroll
        for (int ai = jb; ai < TS; ++ai) {
          const int i = r + G * ai;
          float l = a[ai][jb] * inv;
          if (ai == jb && i < j) l = 0.0f;      // rows above: finished
          bw[r * TSP + ai] = l;
          S[i * LD + j] = l;
        }
        if (r == 0) {
          const float wj = wb[jb] * inv;
          bw[K::WSLOT] = wj;
          wsh[j] = wj;
        }
        if (r == jj) rinv[j] = inv;
      }
      __syncthreads();
      float rv[TSP], cv[TSP];
#pragma unroll
      for (int p = jb / 2; p < TSP / 2; ++p) {
        const float2 q =
            *reinterpret_cast<const float2*>(bw + r * TSP + 2 * p);
        rv[2 * p] = q.x;
        rv[2 * p + 1] = q.y;
        const float2 s =
            *reinterpret_cast<const float2*>(bw + c * TSP + 2 * p);
        cv[2 * p] = s.x;
        cv[2 * p + 1] = s.y;
      }
#pragma unroll
      for (int bi = jb; bi < TS; ++bi) {
#pragma unroll
        for (int ai = bi; ai < TS; ++ai)
          a[ai][bi] = fmaf(-rv[ai], cv[bi], a[ai][bi]);
      }
      if (r == 0) {
        const float wj = bw[K::WSLOT];
#pragma unroll
        for (int bi = jb; bi < TS; ++bi) wb[bi] = fmaf(-wj, cv[bi], wb[bi]);
      }
    }
  }
  __syncthreads();

  // both back substitutions in one warp: x <- L^-T x for w and z
  if (t < 32) {
    float u[NV];
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int i = t + 32 * m;
      u[m] = i < D ? wsh[i] : 0.0f;
    }
#pragma unroll
    for (int mb = NV - 1; mb >= 0; --mb) {
      for (int l = min(31, D - 1 - 32 * mb); l >= 0; --l) {
        const int j = 32 * mb + l;
        const float ri = rinv[j];
        float lrow[NV];
#pragma unroll
        for (int m = 0; m <= mb; ++m) {
          const int i = t + 32 * m;
          lrow[m] = i < j ? S[j * LD + i] : 0.0f;
        }
        const float xu = __shfl_sync(kFullWarp, u[mb], l) * ri;
        const float xv = __shfl_sync(kFullWarp, v[mb], l) * ri;
        if (t == l) {
          u[mb] = xu;
          v[mb] = xv;
        }
#pragma unroll
        for (int m = 0; m <= mb; ++m) {
          u[m] = fmaf(-lrow[m], xu, u[m]);
          v[m] = fmaf(-lrow[m], xv, v[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int i = t + 32 * m;
      if (i < D) {
        mean[off_v + i] = u[m];
        noise[off_v + i] = v[m];
      }
    }
  }
}

template <int TS>
cudaError_t launch_tiled(const float* A, const float* b, const float* z,
                         float* mean, float* noise, int C, int D,
                         float jitter, cudaStream_t stream) {
  using K = Tile<TS>;
  if (D > K::DP) return cudaErrorInvalidValue;
  constexpr size_t smem = sizeof(float) * K::FLOATS;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_tiled_kernel<TS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const bool wide = reinterpret_cast<std::uintptr_t>(A) % 16 == 0 && D % 4 == 0;
  chol_tiled_kernel<TS><<<C, kTiledThreads, smem, stream>>>(
      A, b, z, mean, noise, D, jitter, wide);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The shared-memory kernel: any D up to 240
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
chol_shared_kernel(const float* __restrict__ A, const float* __restrict__ b,
                   const float* __restrict__ z, float* __restrict__ mean,
                   float* __restrict__ noise, int D, float jitter) {
  extern __shared__ __align__(16) float smem[];
  float* a = smem;          // D*D: lower triangle -> L, upper -> L^T
  float* u = a + D * D;     // b -> L^-1 b -> mean
  float* v = u + D;         // z -> noise
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t off_a = (size_t)blockIdx.x * D * D;
  const size_t off_v = (size_t)blockIdx.x * D;

  for (int i = tid; i < D * D; i += kThreads) a[i] = A[off_a + i];
  for (int i = tid; i < D; i += kThreads) {
    u[i] = b[off_v + i];
    v[i] = z[off_v + i];
  }
  __syncthreads();
  if (jitter != 0.0f) {
    if (warp == 0) {        // the trace, summed in a fixed order
      float s = 0.0f;
      for (int i = lane; i < D; i += 32) s += a[i * D + i];
      const float eps = jitter * (warp_sum(s) / (float)D + 1.0f);
      for (int i = lane; i < D; i += 32) a[i * D + i] += eps;
    }
    __syncthreads();
  }

  for (int j = 0; j < D; ++j) {
    const float ljj = sqrtf(a[j * D + j]);
    const float inv = 1.0f / ljj;
    for (int i = j + 1 + tid; i < D; i += kThreads) {
      const float l = a[i * D + j] * inv;
      a[i * D + j] = l;   // L[i][j]
      a[j * D + i] = l;   // the same value, along row j
    }
    __syncthreads();
    if (tid == 0) a[j * D + j] = ljj;
    // trailing update: A[i][k] -= L[i][j] * L[k][j] for j < k <= i
    for (int i = j + 1 + warp; i < D; i += kWarps) {
      const float lij = a[j * D + i];
      for (int k = j + 1 + lane; k <= i; k += 32)
        a[i * D + k] -= lij * a[j * D + k];
    }
    __syncthreads();
  }

  if (warp == 0) {
    // forward: u <- L^-1 u, column by column (L[i][j] = a[j*D + i])
    for (int j = 0; j < D; ++j) {
      __syncwarp();
      const float wj = u[j] / a[j * D + j];
      __syncwarp();
      if (lane == 0) u[j] = wj;
      for (int i = j + 1 + lane; i < D; i += 32) u[i] -= a[j * D + i] * wj;
    }
    // backward on both right-hand sides: x <- L^-T x (L[j][i] = a[j*D + i])
    for (int j = D - 1; j >= 0; --j) {
      __syncwarp();
      const float d = a[j * D + j];
      const float xu = u[j] / d, xv = v[j] / d;
      __syncwarp();
      if (lane == 0) {
        u[j] = xu;
        v[j] = xv;
      }
      for (int i = lane; i < j; i += 32) {
        const float l = a[j * D + i];
        u[i] -= l * xu;
        v[i] -= l * xv;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < D; i += kThreads) {
    mean[off_v + i] = u[i];
    noise[off_v + i] = v[i];
  }
}

cudaError_t launch_shared(const float* A, const float* b, const float* z,
                          float* mean, float* noise, int C, int D,
                          float jitter, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)D * D + 2 * (size_t)D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  chol_shared_kernel<<<C, kThreads, smem, stream>>>(A, b, z, mean, noise, D,
                                                    jitter);
  return cudaGetLastError();
}

}  // namespace

// A (C, D, D), b, z, mean and noise (C, D), all contiguous float32.  `tile`
// names the kernel, as ops/kernels.py::chol_solve_plan chooses it: 0 the
// shared-memory kernel, otherwise the side of a thread's tile in the
// register-tiled one (6 or 8), which needs D <= 16 * tile.
extern "C" int bfmmm_chol_solve(const float* A, const float* b,
                                const float* z, float* mean, float* noise,
                                int C, int D, float jitter, int tile,
                                void* stream_) {
  cudaStream_t s = (cudaStream_t)stream_;
  switch (tile) {
    case 0: return (int)launch_shared(A, b, z, mean, noise, C, D, jitter, s);
    case 6: return (int)launch_tiled<6>(A, b, z, mean, noise, C, D, jitter, s);
    case 8: return (int)launch_tiled<8>(A, b, z, mean, noise, C, D, jitter, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
