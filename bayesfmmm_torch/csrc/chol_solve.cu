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
// The packed kernel (128 < D <= 334; config shapes D = K*M*P = 256 of the
// covariate-adjusted xi draw and of the hd family's Phi draw).  A square
// 256 x 256 float matrix is 256 KB and does not fit a block's 227 KB, and
// the designs that would hold it elsewhere cost more than they give at this
// size: panels streamed from global memory pay a round trip to L2 in every
// one of the D dependent column steps, and a cluster sharing the factor
// through distributed shared memory pays a cluster barrier there.  The
// factor only ever touches the lower triangle, and D (D + 1) / 2 floats are
// 128.5 KB at D = 256: so the triangle is kept packed in one block's shared
// memory, row by row, every row padded to 16 bytes (131 KB at D = 256),
// which serves every D up to 334 with the chain still one block and no
// global traffic inside the loop.  What it does about the cost of a column
// step:
//   * ONE barrier a column.  Row i belongs to warp i mod 16 for the whole
//     factorization.  The owner of a row updates it, hands the entry of the
//     next column to a buffer of D + 1 raw (unscaled) values, and stores
//     L[i][j]; after the barrier every warp reads the raw column, takes the
//     one reciprocal square root of its diagonal itself and scales what it
//     needs.  Two buffers in turn, as in the tiled kernel.  The hand-over is
//     done by every lane with the same values after a __syncwarp.  What the
//     card chose at 16 chains of D = 256 (utils/k1_probe.py --kernel
//     packed): stores under a one-lane branch in the inner loop cost 0.17 of
//     0.60 ms; a shuffle from the lane that holds the entry in place of the
//     read-back, 0.15 ms more; two rows of a warp at a time, 0.13 ms more;
//     1,024 threads the same, 256 threads 0.2 ms more.
//   * A lane keeps its scaled column values l_k in registers, four
//     neighbouring columns a chunk, for all the rows of its warp, so the
//     inner step is one 16-byte shared-memory load, four multiply-adds and
//     one 16-byte store; rows are contiguous and aligned, so the loads are
//     conflict-free.  l_k is 0 at the finished columns, which makes the
//     update a no-op there, and the last four entries of a row may reach
//     into the row's own pad: no store needs a mask.  (One entry a lane
//     with a predicate each, the first version, took 1,056 us at 16 chains:
//     ten instructions a multiply-add.)
//   * b is row D of the matrix, so w = L^-1 b rides along, and 1 / L_jj is
//     kept in the diagonal's place: the back substitutions (one warp, both
//     right-hand sides in registers, along contiguous rows of L, as in the
//     tiled kernel) multiply by it.
//   * The jitter goes onto the diagonal in shared memory, the trace summed
//     by one warp in a fixed order.
// 128.5 KB a block is one block an SM: 132 chains run at once, and 256
// chains take two waves.  ops/kernels.py::chol_solve_packed_plain repeats
// this arithmetic on the same storage in PyTorch.  It also serves
// 128 < D <= 240, where a kernel that kept the matrix in shared memory as a
// square (two barriers a column) stood before: the card gave the packed
// kernel 129, 266 and 366 us at 16 chains of D = 129, 200 and 240 against
// the square's 224, 514 and 756, and 255, 536 and 745 against 241, 1,042
// and 1,537 at 256 chains (utils/kernel_bench.py --sweep, one call), so the
// square went.
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
// The packed kernel: the lower triangle in shared memory, D up to 334
// ---------------------------------------------------------------------------

constexpr int kPackedThreads = 512;
constexpr int kPackedWarps = kPackedThreads / 32;
constexpr int kPackedChunks = 3;        // 128-column chunks of a row: D <= 384
constexpr int kPackedSolveValues = 11;  // values a lane of the solve: D <= 352

// Offset of row i of the packed triangle.  Row i holds its i + 1 entries and
// is padded to a multiple of 4 floats, so every row starts on 16 bytes: four
// rows of 4 floats, four of 8, and so on.
__host__ __device__ __forceinline__ int packed_row(int i) {
  const int g = i >> 2, r = i & 3;
  return 4 * (g + 1) * (2 * g + r);
}

__global__ void __launch_bounds__(kPackedThreads, 1)
chol_packed_kernel(const float* __restrict__ A, const float* __restrict__ b,
                   const float* __restrict__ z, float* __restrict__ mean,
                   float* __restrict__ noise, int D, float jitter) {
  constexpr int T = kPackedThreads, W = kPackedWarps, NC = kPackedChunks;
  extern __shared__ __align__(16) float smem[];
  const int CB = (D + 4) & ~3;              // a raw column: D + 1, padded
  float* a = smem;                          // rows 0..D; row D is b
  float* colbuf = a + packed_row(D + 1);    // two raw columns
  float* v = colbuf + 2 * CB;               // z -> noise
  float* u = a + packed_row(D);             // row D: b -> L^-1 b -> mean
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* Ag = A + (size_t)blockIdx.x * D * D;
  const size_t off_v = (size_t)blockIdx.x * D;

  for (int i = warp; i < D; i += W) {
    const float* src = Ag + (size_t)i * D;
    float* dst = a + packed_row(i);
    for (int k = lane; k <= i; k += 32) dst[k] = src[k];
  }
  for (int k = tid; k < D; k += T) {
    u[k] = b[off_v + k];
    v[k] = z[off_v + k];
  }
  __syncthreads();
  if (jitter != 0.0f) {
    if (warp == 0) {        // the trace, summed in a fixed order
      float s = 0.0f;
      for (int i = lane; i < D; i += 32) s += a[packed_row(i) + i];
      const float eps = jitter * (warp_sum(s) / (float)D + 1.0f);
      for (int i = lane; i < D; i += 32) a[packed_row(i) + i] += eps;
    }
    __syncthreads();
  }
  for (int i = tid; i < 2 * CB; i += T)      // column 0, raw; the pads 0
    colbuf[i] = i <= D ? a[packed_row(i)] : 0.0f;

  for (int j = 0; j < D; ++j) {
    __syncthreads();
    const float* cur = colbuf + (j & 1) * CB;
    float* nxt = colbuf + ((j + 1) & 1) * CB;
    const float inv = rsqrtf(cur[j]);
    if (tid == 0) a[packed_row(j) + j] = inv;
    const int jn = j + 1;
    // this lane's scaled column values l_k, four columns a chunk; 0 at the
    // finished columns k <= j, whose entries the update then leaves alone
    float4 lk[NC];
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int k0 = 4 * (lane + 32 * m);
      float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k0 < CB) c = *reinterpret_cast<const float4*>(cur + k0);
      lk[m].x = (k0 > j && k0 < D) ? c.x * inv : 0.0f;
      lk[m].y = (k0 + 1 > j && k0 + 1 < D) ? c.y * inv : 0.0f;
      lk[m].z = (k0 + 2 > j && k0 + 2 < D) ? c.z * inv : 0.0f;
      lk[m].w = (k0 + 3 > j && k0 + 3 < D) ? c.w * inv : 0.0f;
    }
    // the rows below j of this warp: i = warp (mod W), row D included.  A
    // lane updates four entries of a row at once, all of a row's loads
    // before its stores; the last four of a row may reach into the row's
    // own pad, which nothing reads.
    const int first = jn + ((warp - jn) % W + W) % W;
    for (int i = first; i <= D; i += W) {
      const float li = cur[i] * inv;
      float* row = a + packed_row(i);
      const int kmax = min(i, D - 1);
      float4 x[NC];
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int k0 = 4 * (lane + 32 * m);
        if (k0 <= kmax && k0 + 3 >= j)
          x[m] = *reinterpret_cast<const float4*>(row + k0);
      }
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int k0 = 4 * (lane + 32 * m);
        if (k0 <= kmax && k0 + 3 >= j) {
          x[m].x = fmaf(-li, lk[m].x, x[m].x);
          x[m].y = fmaf(-li, lk[m].y, x[m].y);
          x[m].z = fmaf(-li, lk[m].z, x[m].z);
          x[m].w = fmaf(-li, lk[m].w, x[m].w);
          *reinterpret_cast<float4*>(row + k0) = x[m];
        }
      }
      // the raw entry of the next column goes to its buffer and L[i][j] (in
      // row D, w_j) into the place of the entry it was made from: every
      // lane stores the same values, so nothing branches
      __syncwarp();
      nxt[i] = row[jn];
      row[j] = li;
    }
  }
  __syncthreads();

  if (warp == 0) {
    // backward on both right-hand sides along the rows of L, x <- L^-T x,
    // as in the tiled kernel: u and v in registers, x_j handed round by
    // shuffle, one row of L read a step, no barrier
    constexpr int NV = kPackedSolveValues;
    float uu[NV], vv[NV];
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int i = lane + 32 * m;
      uu[m] = i < D ? u[i] : 0.0f;
      vv[m] = i < D ? v[i] : 0.0f;
    }
#pragma unroll
    for (int mb = NV - 1; mb >= 0; --mb) {
      for (int l = min(31, D - 1 - 32 * mb); l >= 0; --l) {
        const int j = 32 * mb + l;
        const float* row = a + packed_row(j);
        const float ri = row[j];
        float lrow[NV];
#pragma unroll
        for (int m = 0; m <= mb; ++m) {
          const int i = lane + 32 * m;
          lrow[m] = i < j ? row[i] : 0.0f;
        }
        const float xu = __shfl_sync(kFullWarp, uu[mb], l) * ri;
        const float xv = __shfl_sync(kFullWarp, vv[mb], l) * ri;
        if (lane == l) {
          uu[mb] = xu;
          vv[mb] = xv;
        }
#pragma unroll
        for (int m = 0; m <= mb; ++m) {
          uu[m] = fmaf(-lrow[m], xu, uu[m]);
          vv[m] = fmaf(-lrow[m], xv, vv[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int i = lane + 32 * m;
      if (i < D) {
        mean[off_v + i] = uu[m];
        noise[off_v + i] = vv[m];
      }
    }
  }
}

cudaError_t launch_packed(const float* A, const float* b, const float* z,
                          float* mean, float* noise, int C, int D,
                          float jitter, cudaStream_t stream) {
  if (D > 128 * kPackedChunks || D > 32 * kPackedSolveValues)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)packed_row(D + 1) +
                                       2 * (size_t)((D + 4) & ~3) + (size_t)D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  chol_packed_kernel<<<C, kPackedThreads, smem, stream>>>(A, b, z, mean, noise,
                                                          D, jitter);
  return cudaGetLastError();
}

}  // namespace

// A (C, D, D), b, z, mean and noise (C, D), all contiguous float32.  `tile`
// names the kernel, as ops/kernels.py::chol_solve_plan chooses it: 0 the
// packed kernel, otherwise the side of a thread's tile in the
// register-tiled one (6 or 8), which needs D <= 16 * tile.
extern "C" int bfmmm_chol_solve(const float* A, const float* b,
                                const float* z, float* mean, float* noise,
                                int C, int D, float jitter, int tile,
                                void* stream_) {
  cudaStream_t s = (cudaStream_t)stream_;
  switch (tile) {
    case 0: return (int)launch_packed(A, b, z, mean, noise, C, D, jitter, s);
    case 6: return (int)launch_tiled<6>(A, b, z, mean, noise, C, D, jitter, s);
    case 8: return (int)launch_tiled<8>(A, b, z, mean, noise, C, D, jitter, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
