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
// The blocked kernel (128 < D <= 336; config shapes D = K*M*P = 256 of the
// covariate-adjusted xi draw and of the hd family's Phi draw).  A square
// 256 x 256 float matrix is 256 KB and does not fit a block's 227 KB, but
// the factor only touches the lower triangle: D (D + 1) / 2 floats, packed
// row by row with every row padded to 16 bytes (134 KB at D = 256), with b
// as row D and z beside it, fit one block up to D = 336.  One chain a block,
// and 134 KB of shared memory a block is one block an SM.
// What bounds it on the card.  By the count, operations: D^3/3 multiply-adds
// a chain against 34 KB of A, b and z, 1.38 us at 16 chains of D = 256.  In
// practice the chain's own work on one SM: at one block an SM, 16 chains
// use 16 SMs, and the time is the chain of dependent steps (the diagonal
// blocks, the panel solves, the back substitutions) plus the trailing
// updates' instructions on that SM.  Device memory is touched only to stage
// A and write the result.  What the design does about it, a panel of NB
// columns at a time (right-looking):
//   * The diagonal block (NB x NB) is factored by one warp in registers:
//     lane r holds row k0 + r, the diagonal comes by a shuffle, every lane
//     takes the one reciprocal square root, and the scaled column goes round
//     by shuffles, the next diagonal first.  No block barrier inside;
//     1 / L_jj is kept in the diagonal's place for the substitutions.
//   * The panel below it, L21 = A21 L11^-T, one row a thread (row D among
//     them, so b's panel becomes w = L^-1 b on the way): forward
//     substitution by multiplication with the reciprocals, L11 read from its
//     packed rows with 16-byte broadcast loads.  No barrier inside.
//   * The trailing update A22 -= L21 L21^T on the lower triangle and row D,
//     register-tiled: a thread owns a 4 x 4 tile, accumulates its NB-deep
//     products from 16-byte loads of L21 and loads and stores each entry of
//     A22 once a panel, not once a column.  A warp takes 4 x 8 tiles at once
//     (lane = row tile + 4 * column tile: a quarter-warp reads 4 rows and 2
//     columns of L21, the rest comes by broadcast); warps take these groups
//     in turn; tiles wholly above the diagonal are skipped, and what a
//     diagonal tile computes above the diagonal falls into its row's pad.
//   * Three barriers a panel (24 at D = 256 with NB = 32) where an
//     unblocked factor needs one a column.
//   * Both back substitutions as before: one warp, u and v in registers,
//     x_j handed round by shuffle, one row of L read a step.
//   * A is staged with 16-byte cp.async copies of the groups on or below the
//     diagonal (A 16-byte aligned and D a multiple of 4; 4-byte copies
//     otherwise); the jitter goes onto the diagonal in shared memory, the
//     trace summed by one warp in a fixed order.
// This is blocking inside shared memory, which is neither of the designs
// set aside for this size before: panels streamed from global memory pay a
// round trip to L2 in each dependent step, and a cluster sharing the factor
// through distributed shared memory pays a cluster barrier there.  Here
// the whole triangle stays in one block's shared memory, as in the unblocked
// packed kernel that stood here before (one barrier and one load and store
// of the whole trailing triangle a column), and only the order of the work
// changes.  What the card chose (an H100 80GB HBM3 at 700 W, with
// utils/kernel_bench.py --sweep and utils/k1_probe.py --kernel blocked):
// NB = 32 over 16 (slower from D = 200 up, the same at 129), the lanes and
// the unmasked update above, the next diagonal first and the back
// substitutions' steps unrolled by 4; slower, and set aside: lanes column
// tile first, masking what lands in pads, 1,024 threads (64 registers,
// spills), and a look-ahead in which warp 0 factors the next diagonal
// block while the others finish the update (the update split in two costs
// more than the diagonal blocks it hides).
// ops/kernels.py::chol_solve_blocked_plain repeats this arithmetic in
// PyTorch; tests/test_torch_kernel_bounds.py holds a copy of the tiling to
// owning every entry once a panel.
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
// The blocked kernel: the lower triangle in shared memory, a panel of NB
// columns at a time, D up to 336
// ---------------------------------------------------------------------------

constexpr int kBlockedThreads = 512;
constexpr int kBlockedWarps = kBlockedThreads / 32;
constexpr int kSolveValues = 11;        // values a lane of the solve: D <= 352

// Offset of row i of the packed triangle.  Row i holds its i + 1 entries and
// is padded to a multiple of 4 floats, so every row starts on 16 bytes: four
// rows of 4 floats, four of 8, and so on.
__host__ __device__ __forceinline__ int packed_row(int i) {
  const int g = i >> 2, r = i & 3;
  return 4 * (g + 1) * (2 * g + r);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float part(const float4& c, int m) {
  return m == 0 ? c.x : m == 1 ? c.y : m == 2 ? c.z : c.w;
}

// One warp: the diagonal block at (k0, k0), nb <= NB of its rows real.  Lane
// r holds row k0 + r in registers, the entries above the diagonal 0.  After
// the column steps the row holds L (k < r) and 1 / L_rr (k == r); what lies
// past the diagonal in its last 16-byte group is pad, read only under a
// mask.
template <int NB>
__device__ __forceinline__ void factor_diagonal_block(float* a, int k0,
                                                      int nb, int lane) {
  float* row = a + packed_row(k0 + min(lane, nb - 1)) + k0;
  float x[NB];
#pragma unroll
  for (int q = 0; q < NB / 4; ++q) {
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (lane < nb && 4 * q <= lane) c = ld4(row + 4 * q);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      x[4 * q + m] = 4 * q + m <= lane ? part(c, m) : 0.0f;
  }
  float d = __shfl_sync(kFullWarp, x[0], 0);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j < nb) {
      const float inv = rsqrtf(d);
      const float l = lane > j ? x[j] * inv : 0.0f;
      x[j] = lane == j ? inv : l;
      if (j + 1 < NB) {
        // the next diagonal before the rest of the update: lane j + 1
        // takes off its own l squared, one shuffle less in the chain
        d = __shfl_sync(kFullWarp, fmaf(-l, l, x[j + 1]), j + 1);
#pragma unroll
        for (int k = j + 1; k < NB; ++k)
          x[k] = fmaf(-l, __shfl_sync(kFullWarp, l, k), x[k]);
      }
    }
  }
  if (lane < nb) {
#pragma unroll
    for (int q = 0; q < NB / 4; ++q)
      if (4 * q <= lane)
        *reinterpret_cast<float4*>(row + 4 * q) =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  }
}

// One thread: row i (below the diagonal block, or row D) of the panel,
// x <- x L11^-T by forward substitution, left-looking: x_j takes the dot
// product of the finished x_m with row j of L11 in four partial sums, then
// the reciprocal of L_jj, which lies in the same 16-byte group.
template <int NB>
__device__ __forceinline__ void solve_panel_row(float* a, int k0, int nb,
                                                int i) {
  float* row = a + packed_row(i) + k0;
  float x[NB];
#pragma unroll
  for (int q = 0; q < NB / 4; ++q) {
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (4 * q < nb) c = ld4(row + 4 * q);
    x[4 * q] = c.x;
    x[4 * q + 1] = c.y;
    x[4 * q + 2] = c.z;
    x[4 * q + 3] = c.w;
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j < nb) {
      const float* lj = a + packed_row(k0 + j) + k0;
      float s[4] = {x[j], 0.0f, 0.0f, 0.0f};
      float ri = 0.0f;
#pragma unroll
      for (int q = 0; q <= j / 4; ++q) {
        const float4 c = ld4(lj + 4 * q);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (4 * q + m < j) s[m] = fmaf(-x[4 * q + m], part(c, m), s[m]);
          if (4 * q + m == j) ri = part(c, m);
        }
      }
      x[j] = ((s[0] + s[1]) + (s[2] + s[3])) * ri;
    }
  }
#pragma unroll
  for (int q = 0; q < NB / 4; ++q)
    if (4 * q < nb)
      *reinterpret_cast<float4*>(row + 4 * q) =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// One thread: the 4 x 4 tile of rows i0.. and columns c0.. of the trailing
// part, A -= L21 L21^T over the panel's NB columns.  Rows past D and columns
// from D on read row D instead, unmasked: what they compute lands in rows
// past D, which are not stored, or past a row's diagonal, in its pad, which
// is only ever read under a mask.  Masking them was slower on the card
// (utils/k1_probe.py, alt_masked_update).
template <int NB>
__device__ __forceinline__ void update_tile(float* a, int k0, int i0, int c0,
                                            int D) {
  int ro[4], co[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    ro[r] = packed_row(min(i0 + r, D)) + k0;
    co[r] = packed_row(min(c0 + r, D)) + k0;
  }
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll
  for (int q = 0; q < NB / 4; ++q) {
    float4 rv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) rv[r] = ld4(a + ro[r] + 4 * q);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 cv = ld4(a + co[c] + 4 * q);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][c] = fmaf(rv[r].x, cv.x, acc[r][c]);
        acc[r][c] = fmaf(rv[r].y, cv.y, acc[r][c]);
        acc[r][c] = fmaf(rv[r].z, cv.z, acc[r][c]);
        acc[r][c] = fmaf(rv[r].w, cv.w, acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (i0 + r <= D) {
      float4* p = reinterpret_cast<float4*>(a + packed_row(i0 + r) + c0);
      float4 t = *p;
      t.x -= acc[r][0];
      t.y -= acc[r][1];
      t.z -= acc[r][2];
      t.w -= acc[r][3];
      *p = t;
    }
  }
}

// Every warp: the trailing part of the panel, rows s..D and columns
// s..min(i, D - 1), in 4 x 4 tiles.  Tile (a, b) holds rows s + 4a.. and
// columns s + 4b..; a warp owns the tiles (4 ga + lane % 4, 8 gb + lane / 4)
// of a group (ga, gb), and the groups on or below the diagonal go to the
// warps in turn, row of groups by row of groups.
template <int NB>
__device__ __forceinline__ void update_trailing(float* a, int k0, int s, int D,
                                                int warp, int lane) {
  const int n_rows = (D - s) / 4 + 1, n_cols = (D - s + 3) / 4;
  const int rt = lane & 3, ct = lane >> 2;
  int u = 0;
  for (int ga = 0; 4 * ga < n_rows; ++ga) {
    const int n_groups = min((4 * ga + 3) / 8 + 1, (n_cols + 7) / 8);
    for (int gb = 0; gb < n_groups; ++gb, ++u) {
      const int ta = 4 * ga + rt, tb = 8 * gb + ct;
      if (u % kBlockedWarps == warp && tb <= ta && ta < n_rows && tb < n_cols)
        update_tile<NB>(a, k0, s + 4 * ta, s + 4 * tb, D);
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(kBlockedThreads, 1)
chol_blocked_kernel(const float* __restrict__ A, const float* __restrict__ b,
                    const float* __restrict__ z, float* __restrict__ mean,
                    float* __restrict__ noise, int D, float jitter,
                    bool wide) {
  constexpr int T = kBlockedThreads, W = kBlockedWarps;
  extern __shared__ __align__(16) float smem[];
  float* a = smem;                          // rows 0..D; row D is b
  float* v = a + packed_row(D + 1);         // z -> noise
  float* u = a + packed_row(D);             // row D: b -> L^-1 b -> mean
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* Ag = A + (size_t)blockIdx.x * D * D;
  const size_t off_v = (size_t)blockIdx.x * D;

  // stage the lower triangle, a row a warp
  for (int i = warp; i < D; i += W) {
    const float* src = Ag + (size_t)i * D;
    float* dst = a + packed_row(i);
    if (wide) {
      for (int g = lane; 4 * g <= i; g += 32)
        __pipeline_memcpy_async(dst + 4 * g, src + 4 * g, 16);
    } else {
      for (int k = lane; k <= i; k += 32)
        __pipeline_memcpy_async(dst + k, src + k, 4);
    }
  }
  __pipeline_commit();
  for (int k = tid; k < D; k += T) {
    u[k] = b[off_v + k];
    v[k] = z[off_v + k];
  }
  __pipeline_wait_prior(0);
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

  for (int k0 = 0; k0 < D; k0 += NB) {
    const int nb = min(NB, D - k0), s = k0 + nb;
    if (warp == 0) factor_diagonal_block<NB>(a, k0, nb, lane);
    __syncthreads();
    for (int i = s + tid; i <= D; i += T) solve_panel_row<NB>(a, k0, nb, i);
    __syncthreads();
    if (s < D) update_trailing<NB>(a, k0, s, D, warp, lane);
    __syncthreads();
  }

  if (warp == 0) {
    // x <- L^-T x for w and z together, along the rows of L: u and v in
    // registers, x_j handed round by shuffle, one row of L read a step
    constexpr int NV = kSolveValues;
    float uu[NV], vv[NV];
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int i = lane + 32 * m;
      uu[m] = i < D ? u[i] : 0.0f;
      vv[m] = i < D ? v[i] : 0.0f;
    }
#pragma unroll
    for (int mb = NV - 1; mb >= 0; --mb) {
      // four steps unrolled, so rows of L load ahead of the shuffles
#pragma unroll 4
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

template <int NB>
cudaError_t launch_blocked(const float* A, const float* b, const float* z,
                           float* mean, float* noise, int C, int D,
                           float jitter, cudaStream_t stream) {
  if (D > 32 * kSolveValues) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)packed_row(D + 1) + (size_t)D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_blocked_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const bool wide = reinterpret_cast<std::uintptr_t>(A) % 16 == 0 && D % 4 == 0;
  chol_blocked_kernel<NB><<<C, kBlockedThreads, smem, stream>>>(
      A, b, z, mean, noise, D, jitter, wide);
  return cudaGetLastError();
}

}  // namespace

// A (C, D, D), b, z, mean and noise (C, D), all contiguous float32.  `tile`
// names the kernel, as ops/kernels.py::chol_solve_plan chooses it: -32 the
// blocked kernel (panels of 32 columns), otherwise the side of a thread's
// tile in the register-tiled one (6 or 8), which needs D <= 16 * tile.
extern "C" int bfmmm_chol_solve(const float* A, const float* b,
                                const float* z, float* mean, float* noise,
                                int C, int D, float jitter, int tile,
                                void* stream_) {
  cudaStream_t s = (cudaStream_t)stream_;
  switch (tile) {
    case -32:
      return (int)launch_blocked<32>(A, b, z, mean, noise, C, D, jitter, s);
    case 6: return (int)launch_tiled<6>(A, b, z, mean, noise, C, D, jitter, s);
    case 8: return (int)launch_tiled<8>(A, b, z, mean, noise, C, D, jitter, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
