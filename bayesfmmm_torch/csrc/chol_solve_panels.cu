// K1's panels kernels: the joint precision draw for 336 < D <= 4,096.
//
// Replaces bayesfmmm_tpu/ops/pallas_kernels.py::chol_solve_batch_minor for
// the dimensions where the lower triangle of A no longer fits one block's
// shared memory (csrc/chol_solve.cu's blocked kernel stops at D = 336).  The
// JAX package itself hands D > 112 to XLA (stock Cholesky and
// blocked_tri_solves, bayesfmmm_tpu/ops/linalg.py); its Gibbs updaters draw
// Phi and xi jointly up to D = 4,096 (_JOINT_MAX_DIM), so the port needs a
// kernel up to there.  The path that runs it: update_xi of config 4's model
// at two covariates (K*M*D*P = 512) and update_phi of an hd fit on a 5 x 5
// tensor basis (K*M*P = 400).  For each chain c, given an SPD A_c (D x D,
// row-major), b_c and z_c (D), it computes L = chol(A_c + jitter * (tr(A_c)
// / D + 1) * I), mean_c = L^-T L^-1 b_c and noise_c = L^-T z_c.
//
// What bounds it on the card.  By the count, operations: D^3/3
// multiply-adds a chain against D (D + 1) / 2 floats of A
// (ops/kernels.py::kernel_bound("chol_solve", C=, D=)): 10.9 us at 16 chains
// of D = 512, 174 us at 256, 343 us at one chain of D = 4,096.  At 256
// chains the trailing updates' multiply-adds and the workspace traffic they
// bring; at few chains the chain of dependent steps: a launch a panel, the
// factor of each diagonal block (128 dependent column steps on one SM),
// the back substitutions.
//
// What the design does about it.  The matrix lives in a workspace in device
// memory, (C, D + 1, LD) float32 with the row stride LD = D rounded up to a
// multiple of 4 floats, so every row starts on 16 bytes; row D holds b, so
// the forward solve rides along as one more row.  The wrapper allocates the
// workspace and a (C,) buffer for the jitter with torch.empty; the kernels
// allocate nothing, and the caller's A is never written.  Panels of NB = 128
// (or 64) columns, which cut the passes over the trailing triangle and the
// launches fourfold against 32 (ops/kernels.py::chol_solve_plan names the
// width, the cluster and the update's blocks an SM), from one C entry
// point, every launch on the caller's stream:
//   * the factor of a diagonal block is done once, by one block, in shared
//     memory (factor_diagonal_block): 32 columns at a time one warp factors
//     and inverts the 32 x 32 block in registers, the column of each step
//     broadcast through shared memory (factor_32; shuffles, which a lone
//     warp issues slowly, were slower on the card), then the
//     block's rows below it, the rest of the block and the inverse's
//     blocks below the diagonal are short products of 4 x 4 register
//     tiles; the workspace's diagonal block then holds L11^-T, zeros below
//     its diagonal, which is all the later launches read of it;
//   * panels_first (one launch, a block a chain): the jitter (the trace
//     summed in a fixed order, kept in the buffer for the first update) and
//     the factor of the first diagonal block, read from A;
//   * per panel, panels_panel: the rows below the panel (row D among them)
//     X <- X L11^-T, a product parallel over rows and columns (64 rows a
//     block, L11^-T and the rows staged by cp.async, 4 x 8 outputs a
//     thread, the inverse's zero blocks skipped), not a chain of
//     substitutions; the first panel reads A and b directly;
//   * per panel but the last, panels_update: the trailing lower triangle
//     and row D less the panel's product, NB deep, in 128 x 128 tiles of 256
//     threads, each an 8 x 8 register tile; the panel's two operand slices
//     go through shared memory by cp.async in 32-column stages, double
//     buffered; a diagonal tile loads one slice and skips its 16 x 16
//     blocks above the diagonal.  The grid holds only the tiles on or below
//     the diagonal (a linear block index mapped to its row and column
//     tile); where row D starts a row tile of its own, that row's blocks
//     are products of a vector and run as such.  After the product the
//     tile's part of the matrix comes in by cp.async, every load at once;
//     the first update reads it from A (the jitter added on the diagonal)
//     and b, so no pass copies A.  The tile at the corner, scheduled first,
//     then factors the next diagonal block, which it has just updated.
//     Compiled for two blocks an SM (128 registers) where chains are many
//     and one (255) where they are few;
//   * panels_solve (one launch): x <- L^-T x for w (row D) and z, a panel at
//     a time from the last, over a thread-block cluster a chain where
//     chains are few: block r of the cluster holds the entries of u and v
//     in panels r, r + cs, ... in shared memory; per panel its owner forms
//     x_p = L11^-T y_p from the stored inverse, publishes it, and every
//     block reads it from the owner's shared memory and takes it off its
//     own entries above the panel, reading the panel's rows of L once.
// That is 2 ceil(D / NB) + 1 launches a call: 9 at D = 512 with NB = 128,
// 65 at 4,096.  No atomics: every sum has a fixed order, so two calls give
// the same bits.  A non-positive pivot gives NaN through rsqrtf, carried to
// the result, as in the two other K1 kernels.
// Left for later: a shorter chain for the diagonal block's factor (now the
// longest part at few chains), a look-ahead across launches, a persistent
// launch, TMA.  The update's product on the tensor cores by mma.sync, three
// TF32 products a float32 one (TF32 alone misses the sampler's
// tolerances), kept the tolerances but was slower at four of the five timed
// shapes and only a few percent faster at 256 chains: not kept; wgmma's
// asynchronous warpgroup products are untried.
// ops/kernels.py::chol_solve_panels_plain is this order of work in
// PyTorch; tests/test_torch_k1_large_d.py transcribes these kernels launch
// by launch, block by block, and holds the transcription against
// torch.linalg.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kThreads = 256;           // every launch (K1_PANELS_THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;              // update tile side (K1_PANELS_TILE)
constexpr int kChunk = 32;              // panel columns a stage holds
constexpr int kChunkStride = kChunk + 4;
constexpr int kStageFloats = 2 * kTile * kChunkStride;
constexpr int kRows = 64;               // rows a panel-product block takes
constexpr int kMaxCluster = 16;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullWarp, s, o);
  return s;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// The warp's index, read through a shuffle so that the compiler knows it is
// the same across the warp and takes a branch on it as uniform.
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(kFullWarp, (int)threadIdx.x >> 5, 0);
}

__device__ __forceinline__ float part(const float4& c, int m) {
  return m == 0 ? c.x : m == 1 ? c.y : m == 2 ? c.z : c.w;
}

// c += a . b over the four components, in order
__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

// 16 (or 4) bytes from device to shared memory, or zeros where !pred
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row and column of the lower-triangle block t: the blocks on or below the
// diagonal row by row.
__device__ __forceinline__ void lower_block(int t, int& r, int& c) {
  r = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > t) --r;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  c = t - r * (r + 1) / 2;
}

// One warp, right-looking: the m x m block B (m <= 32, row stride SP, its
// lower triangle read) factored and inverted.  Lane i holds row i of the
// block, lane j column j of its inverse, and every lane the whole
// diagonal; at column j each lane scales its entry, the column goes
// through the 32 floats of lv, and every lane takes it off its row, off
// the diagonal (so the next pivot is at hand in every lane) and off its
// column of the inverse (y_j /= L_jj, then y_i -= L_ij y_j below it).  Rows
// past m are the identity.  Row i of B then holds L and 1 / L_ii up to
// the diagonal and L^-1 transposed past it (B[i][k] = L^-1[k][i]).  No
// shuffles: a lone warp issues those slowly.
template <int SP>
__device__ __forceinline__ void factor_32(float* B, float* lv, int m,
                                          int lane) {
  float x[32], dg[32], y[32];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (lane < m && 4 * q <= lane) v = ld4(B + lane * SP + 4 * q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * q + i;
      x[k] = k < lane || (k == lane && lane < m) ? part(v, i)
                                                : k == lane ? 1.0f : 0.0f;
      y[k] = k == lane ? 1.0f : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) dg[k] = k < m ? B[k * SP + k] : 1.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float inv = rsqrtf(dg[j]);
    const float l = lane > j ? x[j] * inv : 0.0f;
    x[j] = lane == j ? inv : l;
    y[j] *= inv;
    if (j + 1 < 32) {
      lv[lane] = l;
      __syncwarp();
#pragma unroll
      for (int q = (j + 1) / 4; q < 8; ++q) {
        const float4 lq = ld4(lv + 4 * q);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = 4 * q + i;
          if (k > j) {
            x[k] = fmaf(-l, part(lq, i), x[k]);
            dg[k] = fmaf(-part(lq, i), part(lq, i), dg[k]);
            y[k] = fmaf(-part(lq, i), y[j], y[k]);
          }
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (lane < m && 4 * q < m)
      st4(B + lane * SP + 4 * q,
          4 * q <= lane ? x[4 * q] : y[4 * q],
          4 * q + 1 <= lane ? x[4 * q + 1] : y[4 * q + 1],
          4 * q + 2 <= lane ? x[4 * q + 2] : y[4 * q + 2],
          4 * q + 3 <= lane ? x[4 * q + 3] : y[4 * q + 3]);
}

// Floats of shared memory factor_diagonal_block takes beside the block:
// M = L^-1[I][I] L[I][<I] (32 rows of NB) and the warp's column of l.
template <int NB>
constexpr int factor_scratch() {
  return 32 * NB + 32;
}

// One thread's 4 x 4 piece t of the update of a diagonal block's rest by
// the rows below its 32 columns q0..q1-1: S[i][j] -= X_i . X_j, q1 <= j <=
// i < nb, in 32 x 32 blocks on or below the diagonal (t / 64 in row order,
// lower_block), rows i0 + u + 8 r and columns j0 + v + 8 c of one (u = t %
// 8, v = t / 8 % 8), so that neighbouring lanes read neighbouring rows.
template <int SP>
__device__ __forceinline__ void rest_less_product(float* S, int q0, int q1,
                                                  int nb, int t) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int bi, bj;
  lower_block(t >> 6, bi, bj);
  const int i0 = q1 + 32 * bi + (t & 7), j0 = q1 + 32 * bj + ((t >> 3) & 7);
  float c4[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) c4[r][c] = 0.0f;
#pragma unroll 2
  for (int bq = 0; bq < 8; ++bq) {
    float4 xi[4], xj[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 8 * r, j = j0 + 8 * r;
      xi[r] = i < nb ? ld4(S + i * SP + q0 + 4 * bq) : zero;
      xj[r] = j < nb ? ld4(S + j * SP + q0 + 4 * bq) : zero;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) c4[r][c] = dot4(xi[r], xj[c], c4[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (i0 + 8 * r < nb && j0 + 8 * c <= i0 + 8 * r)
        S[(i0 + 8 * r) * SP + j0 + 8 * c] -= c4[r][c];
}

// One thread's 4 x 4 piece t of the inverse's block row q0..q0+m-1:
// L^-T[j][q0 + a] = -sum_(j <= k < q0) L^-T[j][k] M[a][k] for j < q0, rows
// j = jb + u + 8 r and columns a = v + 8 c (M in Mt, row stride MS).
template <int SP, int MS>
__device__ __forceinline__ void inverse_block_row(float* S, const float* Mt,
                                                  int q0, int m, int t) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int jb = 32 * (t >> 6), j0 = jb + (t & 7), a0 = (t >> 3) & 7;
  float c4[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) c4[r][c] = 0.0f;
  for (int k = jb; k < q0; k += 4) {
    float4 lt[4], mk[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + 8 * r;
      lt[r] = ld4(S + j * SP + k);
      // L^-T[j][k] is zero for k < j, where S holds L
      lt[r].x = k >= j ? lt[r].x : 0.0f;
      lt[r].y = k + 1 >= j ? lt[r].y : 0.0f;
      lt[r].z = k + 2 >= j ? lt[r].z : 0.0f;
      lt[r].w = k + 3 >= j ? lt[r].w : 0.0f;
      mk[r] = a0 + 8 * r < m ? ld4(Mt + (a0 + 8 * r) * MS + k) : zero;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) c4[r][c] = dot4(lt[r], mk[c], c4[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      S[(j0 + 8 * r) * SP + q0 + a0 + 8 * c] = -c4[r][c];
}

// The nb x nb diagonal block (nb <= NB) in shared memory S, row stride SP
// (a multiple of 4 floats), its lower triangle on entry; all kThreads
// threads, with factor_scratch<NB>() floats at Mt.  On exit S holds L11
// below the diagonal, 1 / L_jj on it and L11^-1 transposed above it (S[a][b]
// = L11^-1[b][a] for a < b).  A block row I of 32 at a time: one warp
// factors and inverts its 32 x 32 block (factor_32); then, in one step,
// the rows below it within the block X <- X L^-T (4 columns and H rows a
// thread) and M = L^-1[I][I] L[I][<I]; then, in one step, the rest of the
// block less X X^T (rest_less_product) and the inverse's block row
// L^-1[I][<I] = -M L^-1[<I][<I] (inverse_block_row).  Warp 0 factoring the
// next block beside the other warps' products was slower on the card: a
// second copy of factor_32's unrolled code.
template <int NB, int SP>
__device__ void factor_diagonal_block(float* S, float* Mt, int nb) {
  constexpr int H = NB / 32 - 1;       // row slots a thread below a block
  constexpr int MS = NB;               // row stride of M
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_index();
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float* lv = Mt + 32 * NB;
  for (int q0 = 0; q0 < nb; q0 += 32) {
    const int m = min(32, nb - q0), q1 = q0 + 32;
    if (warp == 0) factor_32<SP>(S + q0 * SP + q0, lv, m, lane);
    __syncthreads();
    // rows q1.. of the block: X <- X L^-T; thread: 4 columns, H rows
    const int g = tid & 7, rs = tid >> 3;
    float acc[H][4];
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[h][c] = 0.0f;
    if (q1 < nb) {
#pragma unroll 2
      for (int bq = 0; bq < 8; ++bq) {
        float4 xv[H];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int i = q1 + rs + 32 * h;
          xv[h] = i < nb ? ld4(S + i * SP + q0 + 4 * bq) : zero;
        }
#pragma unroll
        for (int bi = 0; bi < 4; ++bi) {
          const int bb = 4 * bq + bi;
          float4 lt = ld4(S + (q0 + bb) * SP + q0 + 4 * g);
          // L^-T is zero below its diagonal, where S holds L
          lt.x = 4 * g >= bb ? lt.x : 0.0f;
          lt.y = 4 * g + 1 >= bb ? lt.y : 0.0f;
          lt.z = 4 * g + 2 >= bb ? lt.z : 0.0f;
          lt.w = 4 * g + 3 >= bb ? lt.w : 0.0f;
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const float xb = part(xv[h], bi);
            acc[h][0] = fmaf(xb, lt.x, acc[h][0]);
            acc[h][1] = fmaf(xb, lt.y, acc[h][1]);
            acc[h][2] = fmaf(xb, lt.z, acc[h][2]);
            acc[h][3] = fmaf(xb, lt.w, acc[h][3]);
          }
        }
      }
    }
    // M[a][k] = sum_(b <= a) L^-1[q0 + a][q0 + b] L[q0 + b][k], k < q0:
    // 4 columns k and rows a0 + 8 c a thread
    for (int t = tid; t < 2 * q0; t += kThreads) {
      const int k = 4 * (t % (q0 / 4)), a0 = t / (q0 / 4);
      float mc[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) mc[c][i] = 0.0f;
      for (int bb = 0; bb < m; ++bb) {
        const float4 l = ld4(S + (q0 + bb) * SP + k);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int a = a0 + 8 * c;
          const float y = bb <= a ? S[(q0 + bb) * SP + q0 + a] : 0.0f;
          mc[c][0] = fmaf(y, l.x, mc[c][0]);
          mc[c][1] = fmaf(y, l.y, mc[c][1]);
          mc[c][2] = fmaf(y, l.z, mc[c][2]);
          mc[c][3] = fmaf(y, l.w, mc[c][3]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        st4(Mt + (a0 + 8 * c) * MS + k, mc[c][0], mc[c][1], mc[c][2],
            mc[c][3]);
    }
    __syncthreads();
    if (q1 < nb) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int i = q1 + rs + 32 * h;
        if (i < nb)
          st4(S + i * SP + q0 + 4 * g, acc[h][0], acc[h][1], acc[h][2],
              acc[h][3]);
      }
      __syncthreads();
      const int nsb = (nb - q1 + 31) / 32;
      for (int t = tid; t < 32 * nsb * (nsb + 1); t += kThreads)
        rest_less_product<SP>(S, q0, q1, nb, t);
    }
    for (int t = tid; t < 2 * q0; t += kThreads)
      inverse_block_row<SP, MS>(S, Mt, q0, m, t);
    __syncthreads();
  }
}

// L11^-T of the factored nb x nb block S (row stride SP) into the
// workspace at (k0, k0), zeros below its diagonal and past nb (to the end
// of the 16-byte group, in the row's padding or past column D): what the
// panel products and the back substitutions read, as it stands.
template <int SP>
__device__ __forceinline__ void store_diagonal_block(const float* S,
                                                     float* Wc, int LD,
                                                     int k0, int nb) {
  const int g4 = (nb + 3) / 4;
  for (int idx = threadIdx.x; idx < nb * g4; idx += kThreads) {
    const int a = idx / g4, k = 4 * (idx % g4);
    const float4 v = ld4(S + a * SP + k);
    st4(Wc + (size_t)(k0 + a) * LD + k0 + k,
        k >= a && k < nb ? v.x : 0.0f, k + 1 >= a && k + 1 < nb ? v.y : 0.0f,
        k + 2 >= a && k + 2 < nb ? v.z : 0.0f,
        k + 3 >= a && k + 3 < nb ? v.w : 0.0f);
  }
}

// Row and column tile of the trailing update's block t: the nC (nC + 1) / 2
// tiles on or below the diagonal row by row, then, where row D starts a row
// tile of its own, that row tile's nC tiles.
__device__ __forceinline__ void tile_of(int t, int nC, int& rt, int& ct) {
  const int tri = nC * (nC + 1) / 2;
  if (t < tri) {
    lower_block(t, rt, ct);
  } else {
    rt = nC + (t - tri) / nC;
    ct = (t - tri) % nC;
  }
}

// Grid C.  The jitter eps_c = jitter * (tr(A_c) / D + 1) into eps (the trace
// in a fixed order), and the first diagonal block of A_c + eps_c I, brought
// in by cp.async, factored into the workspace.
template <int NB>
__global__ void __launch_bounds__(kThreads)
panels_first(const float* __restrict__ A, float* __restrict__ W,
             float* __restrict__ eps, int D, int LD, float jitter) {
  extern __shared__ __align__(16) float S[];
  __shared__ float red[kWarps];
  constexpr int SP = NB + 4;
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const float* Ac = A + (size_t)c * D * D;
  const int nb = min(NB, D);
  for (int idx = tid; idx < nb * nb; idx += kThreads) {
    const int a = idx / nb, k = idx % nb;
    cp_async4(S + a * SP + k, Ac + (size_t)a * D + k, true);
  }
  cp_async_commit();
  float e = 0.0f;
  if (jitter != 0.0f) {
    float s = 0.0f;
#pragma unroll 4
    for (int i = tid; i < D; i += kThreads) s += Ac[(size_t)i * D + i];
    s = warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    float tr = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tr += red[w];
    e = jitter * (tr / (float)D + 1.0f);
  }
  if (tid == 0) eps[c] = e;
  cp_async_wait<0>();
  __syncthreads();
  if (jitter != 0.0f)
    for (int a = tid; a < nb; a += kThreads) S[a * SP + a] += e;
  __syncthreads();
  factor_diagonal_block<NB, SP>(S, S + NB * SP, nb);
  store_diagonal_block<SP>(S, W + (size_t)c * (D + 1) * LD, LD, 0, nb);
}

// Grid (C, ceil((D + 1 - s) / kRows)) for the panel of columns k0..s-1,
// s = min(k0 + NB, D): rows s..D of those columns times L11^-T.  L11^-T and
// the block's rows come in by cp.async (the first panel's rows from A and
// b, 4 bytes at a time).
template <int NB>
__global__ void __launch_bounds__(kThreads)
panels_panel(const float* __restrict__ A, const float* __restrict__ b,
             float* __restrict__ W, int D, int LD, int k0) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LS = NB + 4;
  constexpr int H = NB / 64;            // column groups of 64 a thread
  float* LT = smem;                     // L11^-T: LT[k][j], zero for k > j
  float* X = smem + NB * LS;            // the block's rows
  const int c = blockIdx.x, tid = threadIdx.x;
  const int nb = min(NB, D - k0), s = k0 + nb;
  const int r0 = s + blockIdx.y * kRows;
  float* Wc = W + (size_t)c * (D + 1) * LD;

  for (int idx = tid; idx < NB * NB / 4; idx += kThreads) {
    const int k = idx / (NB / 4), j = 4 * (idx % (NB / 4));
    const bool in = k < nb && j < nb;
    cp_async16(LT + k * LS + j, Wc + (size_t)(k0 + (in ? k : 0)) * LD + k0 +
                                    (in ? j : 0), in);
  }
  if (k0 == 0) {
    const float* Ac = A + (size_t)c * D * D;
    for (int idx = tid; idx < kRows * NB; idx += kThreads) {
      const int r = idx / NB, k = idx % NB, i = r0 + r;
      const float* src =
          i < D ? Ac + (size_t)i * D + k : b + (size_t)c * D + k;
      cp_async4(X + r * LS + k, i <= D ? src : b, i <= D);
    }
  } else {
    for (int idx = tid; idx < kRows * NB / 4; idx += kThreads) {
      const int r = idx / (NB / 4), k = 4 * (idx % (NB / 4)), i = r0 + r;
      const bool in = i <= D && k < nb;
      cp_async16(X + r * LS + k,
                 Wc + (size_t)(in ? i : D) * LD + k0 + (in ? k : 0), in);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // the last panel's rows are zero past nb too
  if (nb < NB)
    for (int idx = tid; idx < kRows * NB; idx += kThreads)
      if (idx % NB >= nb) X[(idx / NB) * LS + idx % NB] = 0.0f;
  __syncthreads();

  // thread (ty, tx): rows 4 ty.. of the block, columns 64 h + 4 tx..
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4 * H];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4 * H; ++q) acc[r][q] = 0.0f;
#pragma unroll
  for (int kb = 0; kb < H; ++kb) {
    // columns below 64 (kb + 1) see no k past them
#pragma unroll 2
    for (int kk = 0; kk < 64; kk += 4) {
      const int k = 64 * kb + kk;
      float4 xa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xa[r] = ld4(X + (4 * ty + r) * LS + k);
#pragma unroll
      for (int ki = 0; ki < 4; ++ki) {
#pragma unroll
        for (int h = kb; h < H; ++h) {
          const float4 lb = ld4(LT + (k + ki) * LS + 64 * h + 4 * tx);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float xr = part(xa[r], ki);
            acc[r][4 * h] = fmaf(xr, lb.x, acc[r][4 * h]);
            acc[r][4 * h + 1] = fmaf(xr, lb.y, acc[r][4 * h + 1]);
            acc[r][4 * h + 2] = fmaf(xr, lb.z, acc[r][4 * h + 2]);
            acc[r][4 * h + 3] = fmaf(xr, lb.w, acc[r][4 * h + 3]);
          }
        }
      }
    }
  }
  // what a 16-byte group holds past nb (the last panel only) lands in the
  // row's padding or past column D, never read
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r0 + 4 * ty + r;
    if (i > D) continue;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int j = 64 * h + 4 * tx;
      if (j < nb)
        st4(Wc + (size_t)i * LD + k0 + j, acc[r][4 * h], acc[r][4 * h + 1],
            acc[r][4 * h + 2], acc[r][4 * h + 3]);
    }
  }
}

// One 32-column stage of the product: acc[r][q] += X_row(ty + 16 r) .
// X_col(tx + 16 q) over the stage's columns.  A diagonal tile skips its
// 16 x 16 blocks above the diagonal (q > r), which it never stores, and
// their loads.
template <bool DIAG>
__device__ __forceinline__ void stage_product(const float* Xr,
                                              const float* Xc, int ty,
                                              int tx, float (&acc)[8][8]) {
#pragma unroll
  for (int kq = 0; kq < kChunk / 4; ++kq) {
    // four rows at a time, which keeps the registers under 128
#pragma unroll
    for (int h = 0; h < 8; h += 4) {
      float4 a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = ld4(Xr + (ty + 16 * (h + r)) * kChunkStride + 4 * kq);
#pragma unroll
      for (int q = 0; q < (DIAG ? h + 4 : 8); ++q) {
        const float4 bv = ld4(Xc + (tx + 16 * q) * kChunkStride + 4 * kq);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (!DIAG || q <= h + r)
            acc[h + r][q] = dot4(a[r], bv, acc[h + r][q]);
      }
    }
  }
}

// Grid (C, tiles) for the trailing part of the full panel k0..s-1 (s =
// k0 + NB < D): rows s..D, columns s..min(i, D - 1), less the panel's
// product L21 L21^T (row D: less w_panel L21^T).  The first panel's update
// reads that part from A (eps on the diagonal) and b.  The corner tile
// then factors the next diagonal block.
template <int NB, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
panels_update(const float* __restrict__ A, const float* __restrict__ b,
              float* __restrict__ W, const float* __restrict__ eps, int D,
              int LD, int k0) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int s = k0 + NB;
  const int nC = (D - s + kTile - 1) / kTile;
  int rt, ct;
  tile_of(blockIdx.y, nC, rt, ct);
  const int i0 = s + kTile * rt, j0 = s + kTile * ct;
  float* Wc = W + (size_t)c * (D + 1) * LD;
  const float* Ac = A + (size_t)c * D * D;
  const float* bc = b + (size_t)c * D;
  const bool first = k0 == 0;

  if (i0 == D) {
    // row D alone in its row tile: w_j -= w_panel . L21_j, two threads a
    // column, each half of the panel, every load in flight at once
    constexpr int HALF = NB / 2;
    const int j = j0 + tid / 2, h = tid & 1;
    const float* xd = Wc + (size_t)D * LD + k0 + h * HALF;
    const float* lj = Wc + (size_t)min(j, D - 1) * LD + k0 + h * HALF;
    float4 l[HALF / 4];
#pragma unroll
    for (int t = 0; t < HALF / 4; ++t) l[t] = ld4(lj + 4 * t);
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < HALF / 4; ++t) sum = dot4(ld4(xd + 4 * t), l[t], sum);
    sum += __shfl_xor_sync(kFullWarp, sum, 1);
    if (h == 0 && j < D)
      Wc[(size_t)D * LD + j] = (first ? bc[j] : Wc[(size_t)D * LD + j]) - sum;
    return;
  }

  const bool diag = rt == ct;
  // stage st, columns k0 + 32 kc..: the tile's rows (to D) and, off the
  // diagonal, its columns' rows (below D); zeros past them
  auto load = [&](int st, int kc) {
    float* Xr = smem + st * kStageFloats;
    float* Xc = Xr + kTile * kChunkStride;
    const int col = k0 + kc * kChunk;
#pragma unroll
    for (int h = 0; h < kTile * kChunk / 4 / kThreads; ++h) {
      const int idx = tid + h * kThreads, r = idx / (kChunk / 4),
                q = idx % (kChunk / 4);
      const int ir = i0 + r, jr = j0 + r;
      cp_async16(Xr + r * kChunkStride + 4 * q,
                 Wc + (size_t)min(ir, D) * LD + col + 4 * q, ir <= D);
      if (!diag)
        cp_async16(Xc + r * kChunkStride + 4 * q,
                   Wc + (size_t)min(jr, D) * LD + col + 4 * q, jr < D);
    }
    cp_async_commit();
  };

  const int ty = tid / 16, tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
  constexpr int NK = NB / kChunk;
  load(0, 0);
#pragma unroll 1
  for (int kc = 0; kc < NK; ++kc) {
    if (kc + 1 < NK) {
      load((kc + 1) & 1, kc + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Xr = smem + (kc & 1) * kStageFloats;
    if (diag)
      stage_product<true>(Xr, Xr, ty, tx, acc);
    else
      stage_product<false>(Xr, Xr + kTile * kChunkStride, ty, tx, acc);
    __syncthreads();
  }

  // the stages are free now: the tile's part of the matrix comes in by
  // cp.async, every load at once (the first panel's from A and b, 4 bytes
  // at a time); the corner tile keeps the next diagonal block there
  constexpr int TS = kTile + 4;
  float* T = smem;
  if (!first) {
    for (int idx = tid; idx < kTile * kTile / 4; idx += kThreads) {
      const int r = idx / (kTile / 4), q = 4 * (idx % (kTile / 4));
      const int i = i0 + r, j = j0 + q;
      const bool in = i <= D && j < D && j <= i + 3;
      cp_async16(T + r * TS + q, Wc + (size_t)(in ? i : D) * LD + (in ? j : 0),
                 in);
    }
  } else {
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int r = idx / kTile, q = idx % kTile, i = i0 + r, j = j0 + q;
      const bool in = i <= D && j < D && j <= i;
      cp_async4(T + r * TS + q,
                !in ? bc : i < D ? Ac + (size_t)i * D + j : bc + j, in);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const bool corner = rt == 0 && ct == 0;
  const float e = first ? eps[c] : 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + tx + 16 * q;
      if (i <= D && j < D && j <= i) {
        float* t = T + (ty + 16 * r) * TS + tx + 16 * q;
        float x = *t;
        if (first && i == j && e != 0.0f) x += e;
        const float v = x - acc[r][q];
        Wc[(size_t)i * LD + j] = v;
        if (corner) *t = v;
      }
    }
  }
  if (corner) {
    __syncthreads();
    const int nbn = min(NB, D - s);
    factor_diagonal_block<NB, TS>(T, T + kTile * TS, nbn);
    store_diagonal_block<TS>(T, Wc, LD, s, nbn);
  }
}

// Grid (cs, C), clusters of cs blocks a chain: x <- L^-T x for x = w (row D
// of the workspace) and x = z, a panel at a time from the last.  Block r of
// a cluster owns panels r, r + cs, ...: their entries of u (w -> mean) and
// v (z -> noise) stay in its shared memory.  Per panel p its owner forms
// x_p = L11^-T y_p from the inverse above the diagonal block (all its
// threads, every row's loads in flight at once) and publishes it (two
// buffers, by the parity of p); after the cluster's barrier every block
// copies x_p from the owner's shared memory and takes L_p^T x_p off its own
// entries above the panel, an owned panel at a time: 4 columns and NB / 8
// (or NB / 16) rows of L a thread, the partial sums added in a fixed order.
template <int NB>
__global__ void __launch_bounds__(kThreads)
panels_solve(const float* __restrict__ W, const float* __restrict__ z,
             float* __restrict__ mean, float* __restrict__ noise, int D,
             int LD) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TPR = kThreads / NB;    // threads a row of L11^-T
  constexpr int CW = NB / TPR;          // its columns a thread
  constexpr int CG = NB / 4;            // column groups of an update
  constexpr int JG = kThreads / CG;     // row groups of an update
  constexpr int JL = NB / JG;           // rows of L a thread
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int c = blockIdx.y, tid = threadIdx.x;
  const int nP = (D + NB - 1) / NB, slots = (nP + cs - 1) / cs;
  float* U = smem;
  float* V = U + slots * NB;
  float* Xb = V + slots * NB;           // [parity][u, v][NB], published
  float* Xl = Xb + 4 * NB;              // [u, v][NB], this block's copy
  float* red = Xl + 2 * NB;             // [JG][NB][u, v]
  const float* Wc = W + (size_t)c * (D + 1) * LD;
  const float* zc = z + (size_t)c * D;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int t = 0; t < slots; ++t) {
    const int q = rank + cs * t;
    for (int i = tid; i < NB; i += kThreads) {
      const int col = q * NB + i;
      const bool in = q < nP && col < D;
      U[t * NB + i] = in ? Wc[(size_t)D * LD + col] : 0.0f;
      V[t * NB + i] = in ? zc[col] : 0.0f;
    }
  }
  cluster.sync();
  for (int p = nP - 1; p >= 0; --p) {
    const int k0 = p * NB, nb = min(NB, D - k0), owner = p % cs;
    float* xb = Xb + (p & 1) * 2 * NB;
    if (rank == owner) {
      // x_p[a] = sum_(bb >= a) L11^-T[a][bb] y_p[bb]: TPR threads a row
      const float* yu = U + (p / cs) * NB;
      const float* yv = V + (p / cs) * NB;
      const int a = tid / TPR, h = tid % TPR;
      float su = 0.0f, sv = 0.0f;
      if (a < nb) {
        const float* row = Wc + (size_t)(k0 + a) * LD + k0 + h * CW;
        float4 l[CW / 4];
#pragma unroll
        for (int t = 0; t < CW / 4; ++t)
          l[t] = h * CW + 4 * t < nb ? ld4(row + 4 * t) : zero;
#pragma unroll
        for (int t = 0; t < CW / 4; ++t) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int bb = h * CW + 4 * t + m;
            if (bb >= a && bb < nb) {
              su = fmaf(part(l[t], m), yu[bb], su);
              sv = fmaf(part(l[t], m), yv[bb], sv);
            }
          }
        }
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) {
        su += __shfl_xor_sync(kFullWarp, su, o);
        sv += __shfl_xor_sync(kFullWarp, sv, o);
      }
      if (h == 0 && a < nb) {
        xb[a] = su;
        xb[NB + a] = sv;
      }
    }
    cluster.sync();
    const float* src = cluster.map_shared_rank(xb, owner);
    for (int i = tid; i < 2 * NB; i += kThreads)
      Xl[i] = (i % NB) < nb ? src[i] : 0.0f;
    __syncthreads();
    if (rank == owner) {
      for (int i = tid; i < nb; i += kThreads) {
        U[(p / cs) * NB + i] = Xl[i];
        V[(p / cs) * NB + i] = Xl[NB + i];
      }
    }
    // this block's entries above the panel: y_i -= sum_j L[k0 + j][i] x_j
    const int nq = p > rank ? (p - rank + cs - 1) / cs : 0;
    const int cgi = tid % CG, jg = tid / CG;
    for (int t = 0; t < nq; ++t) {
      const float* l = Wc + (size_t)(k0 + jg * JL) * LD +
                       (rank + cs * t) * NB + 4 * cgi;
      float4 lj[JL];
#pragma unroll
      for (int jj = 0; jj < JL; ++jj)
        lj[jj] = jg * JL + jj < nb ? ld4(l + (size_t)jj * LD) : zero;
      float4 pu = zero, pv = zero;
#pragma unroll
      for (int jj = 0; jj < JL; ++jj) {
        const float xu = Xl[jg * JL + jj], xv = Xl[NB + jg * JL + jj];
        pu.x = fmaf(lj[jj].x, xu, pu.x);
        pu.y = fmaf(lj[jj].y, xu, pu.y);
        pu.z = fmaf(lj[jj].z, xu, pu.z);
        pu.w = fmaf(lj[jj].w, xu, pu.w);
        pv.x = fmaf(lj[jj].x, xv, pv.x);
        pv.y = fmaf(lj[jj].y, xv, pv.y);
        pv.z = fmaf(lj[jj].z, xv, pv.z);
        pv.w = fmaf(lj[jj].w, xv, pv.w);
      }
      float* rd = red + (jg * NB + 4 * cgi) * 2;
      st4(rd, pu.x, pv.x, pu.y, pv.y);
      st4(rd + 4, pu.z, pv.z, pu.w, pv.w);
      __syncthreads();
      if (tid < NB) {
        float su = 0.0f, sv = 0.0f;
#pragma unroll
        for (int g = 0; g < JG; ++g) {
          su += red[(g * NB + tid) * 2];
          sv += red[(g * NB + tid) * 2 + 1];
        }
        U[t * NB + tid] -= su;
        V[t * NB + tid] -= sv;
      }
      __syncthreads();
    }
  }
  for (int t = 0; t < slots; ++t) {
    const int q = rank + cs * t;
    for (int i = tid; i < NB; i += kThreads) {
      const int col = q * NB + i;
      if (q < nP && col < D) {
        mean[(size_t)c * D + col] = U[t * NB + i];
        noise[(size_t)c * D + col] = V[t * NB + i];
      }
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

template <int NB>
constexpr int first_smem() {
  return 4 * (NB * (NB + 4) + factor_scratch<NB>());
}
template <int NB>
constexpr int panel_smem() {
  return 4 * (NB + kRows) * (NB + 4);
}
// the stages, or the tile's part of the matrix and the factor's scratch
template <int NB>
constexpr int update_smem() {
  return 2 * kStageFloats > kTile * (kTile + 4) + factor_scratch<NB>()
             ? 4 * 2 * kStageFloats
             : 4 * (kTile * (kTile + 4) + factor_scratch<NB>());
}

template <int NB>
int solve_smem(int D, int cs) {
  const int nP = (D + NB - 1) / NB, slots = (nP + cs - 1) / cs;
  return 4 * (2 * slots * NB + 6 * NB + 8 * kThreads);
}

template <int NB>
cudaError_t launch_all(const float* A, const float* b, const float* z,
                       float* mean, float* noise, float* work, float* eps,
                       int C, int D, int LD, float jitter, int cs, int ub,
                       cudaStream_t s) {
  cudaError_t err;
  // shared memory above 48 KB and clusters above 8 blocks are opt-in,
  // once a device
  static int ready_on = -1;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (ready_on != dev) {
    if ((err = cudaFuncSetAttribute(
             panels_first<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             first_smem<NB>())) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             panels_panel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             panel_smem<NB>())) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             panels_update<NB, 1>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             update_smem<NB>())) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             panels_update<NB, 2>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             update_smem<NB>())) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             panels_solve<NB>,
             cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
            cudaSuccess)
      return err;
    ready_on = dev;
  }
  panels_first<NB><<<C, kThreads, first_smem<NB>(), s>>>(A, work, eps, D, LD,
                                                         jitter);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int k0 = 0; k0 < D; k0 += NB) {
    const int st = k0 + NB < D ? k0 + NB : D;
    panels_panel<NB><<<dim3(C, (D + kRows - st) / kRows), kThreads,
                       panel_smem<NB>(), s>>>(A, b, work, D, LD, k0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (st < D) {
      const int nC = (D - st + kTile - 1) / kTile;
      const int nR = (D + 1 - st + kTile - 1) / kTile;
      const dim3 grid(C, nC * (nC + 1) / 2 + (nR - nC) * nC);
      if (ub == 1)
        panels_update<NB, 1><<<grid, kThreads, update_smem<NB>(), s>>>(
            A, b, work, eps, D, LD, k0);
      else
        panels_update<NB, 2><<<grid, kThreads, update_smem<NB>(), s>>>(
            A, b, work, eps, D, LD, k0);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = solve_smem<NB>(D, cs);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, panels_solve<NB>, (const float*)work, z,
                                mean, noise, D, LD)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // namespace

// A (C, D, D), b, z, mean and noise (C, D), all contiguous float32; work
// (C, D + 1, LD) and eps (C,) float32 scratch, LD >= D a multiple of 4, work
// 16-byte aligned.  nb, the panel width, is 64 or 128 and below D; cs, the
// back substitutions' blocks a chain, 1 to 16; ub, the trailing update's
// blocks an SM the kernel is compiled for, 1 (255 registers a thread) or 2
// (128).  Every launch goes to `stream` in order; the first error stops the
// call and is returned.
extern "C" int bfmmm_chol_solve_panels(const float* A, const float* b,
                                       const float* z, float* mean,
                                       float* noise, float* work, float* eps,
                                       int C, int D, int LD, float jitter,
                                       int nb, int cs, int ub,
                                       void* stream_) {
  if (C < 1 || C > 65535 || D < 1 || LD < D || LD % 4 != 0 ||
      reinterpret_cast<std::uintptr_t>(work) % 16 != 0 ||
      (nb != 64 && nb != 128) || D <= nb || cs < 1 || cs > kMaxCluster ||
      (ub != 1 && ub != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_;
  if (nb == 64) {
    if (solve_smem<64>(D, cs) > 48 * 1024) return (int)cudaErrorInvalidValue;
    return (int)launch_all<64>(A, b, z, mean, noise, work, eps, C, D, LD,
                               jitter, cs, ub, s);
  }
  if (solve_smem<128>(D, cs) > 48 * 1024) return (int)cudaErrorInvalidValue;
  return (int)launch_all<128>(A, b, z, mean, noise, work, eps, C, D, LD,
                              jitter, cs, ub, s);
}
