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
// of D = 512, 174 us at 256, 343 us at one chain of D = 4,096.  In practice,
// for this first design, the traffic of the workspace: a right-looking
// factor with panels of 32 columns reads and writes the whole trailing
// triangle once a panel, D^3 / 24 bytes a chain (2.9 GB at D = 4,096; 1.4
// GB at 256 chains of D = 512, more than the 50 MB L2 holds), 8 FLOP a
// byte; and at few chains the chain of launches, 2 D / 32 of them a call.
//
// What the design does about it.  The matrix lives in a workspace in device
// memory, (C, D + 1, LD) float32 with the row stride LD = D rounded up to a
// multiple of 4 floats, so every row starts on 16 bytes and is read with
// 16-byte loads whatever D is; row D holds b, so the forward solve rides
// along as in the blocked kernel.  The wrapper allocates the workspace and
// a (C, 32, 32) buffer for the next diagonal block with torch.empty; the
// kernels allocate nothing, and the caller's A is never written.  The
// algorithm is kernels.chol_solve_blocked_plain's, spread over many blocks
// a chain and over launches on the caller's stream, from one C entry point:
//   * the prologue (one launch): A's lower triangle and b copied into the
//     workspace, the jitter on the diagonal (the trace summed by each block
//     in a fixed order, so every block of a chain adds the same bits), and
//     the first diagonal block copied to the buffer;
//   * per panel of 32 columns, launch a: every block factors the 32 x 32
//     diagonal block from the buffer itself, by one warp in registers with
//     shuffles (as the blocked kernel does), which costs 32 dependent steps
//     and saves a launch; the block then solves its 128 rows below it (row D
//     among them) by forward substitution, one row a thread, and writes them
//     back; the block of the first rows also writes L11 and the
//     reciprocals into the workspace.  The blocks read the diagonal block
//     from the buffer, never from the workspace, so that write races with
//     no read;
//   * per panel, launch b: the trailing lower triangle and row D less the
//     panel's product, in 64 x 64 tiles of 256 threads, each a 4 x 4
//     register tile, the panel's two 32-deep slices through shared memory,
//     float32 fused multiply-adds.  The grid holds only the tiles on or
//     below the diagonal (a linear block index mapped to its row and column
//     tile); diagonal tiles store on and below the diagonal only.  The tile
//     at the panel's corner also copies the next diagonal block to the
//     buffer.  The last panel has no trailing part and no launch b;
//   * the back substitutions (one launch, one block a chain): u and v in
//     shared memory, a panel at a time from the last: one warp solves the
//     32 x 32 block by shuffles (u and v in registers, a column of L11 a
//     lane), then every thread takes its share of the rows above the
//     panel, each a dot product along the panel's rows of L, which
//     neighbouring threads read at neighbouring addresses.
// That is 2 ceil(D / 32) + 1 launches a call: 33 at D = 512, 257 at 4,096.
// No atomics: every sum has a fixed order, so two calls give the same bits.
// A non-positive pivot gives NaN through rsqrtf and is carried to the
// result, as in the two other K1 kernels.
// Left for later: tensor cores (TF32's ~3 digits miss the sampler's
// tolerances), a left-looking or wider-panel update that keeps more of the
// trailing part on chip, thread-block clusters, a persistent single launch,
// TMA.
// ops/kernels.py::chol_solve_blocked_plain is the algorithm a panel at a
// time; tests/test_torch_k1_large_d.py transcribes these kernels launch by
// launch, tile by tile, and holds the transcription against torch.linalg.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int NB = 32;                  // panel width (kernels.K1_PANEL)
constexpr int kPrologueThreads = 256;
constexpr int kPrologueRows = 64;       // workspace rows a prologue block copies
constexpr int kPanelThreads = 128;      // rows below the panel a block solves
constexpr int kTile = 64;               // side of a trailing-update tile
constexpr int kUpdateThreads = 256;     // 16 x 16, a 4 x 4 tile each
constexpr int kSolveThreads = 512;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullWarp, s, o);
  return s;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float part(const float4& c, int m) {
  return m == 0 ? c.x : m == 1 ? c.y : m == 2 ? c.z : c.w;
}

// Grid (C, ceil((D + 1) / kPrologueRows)).  Rows r0.. of the workspace: A's
// lower triangle (row i, columns 0..i) with the jitter on the diagonal, and
// row D = b; rows below 32 also to the diagonal-block buffer.
__global__ void __launch_bounds__(kPrologueThreads)
panels_prologue(const float* __restrict__ A, const float* __restrict__ b,
                float* __restrict__ W, float* __restrict__ Dg, int D, int LD,
                float jitter) {
  constexpr int kWarps = kPrologueThreads / 32;
  __shared__ float red[kWarps];
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const float* Ac = A + (size_t)c * D * D;
  float* Wc = W + (size_t)c * (D + 1) * LD;
  float* Dc = Dg + (size_t)c * NB * NB;
  float eps = 0.0f;
  if (jitter != 0.0f) {     // the trace, in the same order in every block
    float s = 0.0f;
    for (int i = tid; i < D; i += kPrologueThreads) s += Ac[(size_t)i * D + i];
    s = warp_sum(s);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    float tr = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tr += red[w];
    eps = jitter * (tr / (float)D + 1.0f);
  }
  const int r0 = blockIdx.y * kPrologueRows;
  const int r1 = min(r0 + kPrologueRows, D + 1);
  for (int i = r0 + warp; i < r1; i += kWarps) {
    float* dst = Wc + (size_t)i * LD;
    if (i < D) {
      const float* src = Ac + (size_t)i * D;
      for (int k = lane; k <= i; k += 32) {
        float a = src[k];
        if (k == i && jitter != 0.0f) a += eps;
        dst[k] = a;
        if (i < NB) Dc[i * NB + k] = a;
      }
    } else {
      const float* src = b + (size_t)c * D;
      for (int k = lane; k < D; k += 32) dst[k] = src[k];
    }
  }
}

// Grid (C, ceil((D + 1 - s) / kPanelThreads)) for the panel of columns
// k0..s-1, s = min(k0 + 32, D).
__global__ void __launch_bounds__(kPanelThreads)
panels_panel(float* __restrict__ W, const float* __restrict__ Dg, int D,
             int LD, int k0) {
  __shared__ __align__(16) float L11[NB * NB];   // L below, 1 / L_jj on
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int nb = min(NB, D - k0), s = k0 + nb;
  float* Wc = W + (size_t)c * (D + 1) * LD;

  if (tid < 32) {
    // The diagonal block by one warp: lane r holds row k0 + r (entries
    // above the diagonal 0); after the column steps the row holds L (k < r)
    // and 1 / L_rr (k == r).
    const float* row = Dg + (size_t)c * NB * NB + lane * NB;
    float x[NB];
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (lane < nb && 4 * q <= lane) v = ld4(row + 4 * q);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        x[4 * q + m] = 4 * q + m <= lane ? part(v, m) : 0.0f;
    }
    float d = __shfl_sync(kFullWarp, x[0], 0);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nb) {
        const float inv = rsqrtf(d);
        const float l = lane > j ? x[j] * inv : 0.0f;
        x[j] = lane == j ? inv : l;
        if (j + 1 < NB) {
          // the next diagonal first: lane j + 1 takes off its own l squared
          d = __shfl_sync(kFullWarp, fmaf(-l, l, x[j + 1]), j + 1);
#pragma unroll
          for (int k = j + 1; k < NB; ++k)
            x[k] = fmaf(-l, __shfl_sync(kFullWarp, l, k), x[k]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NB / 4; ++q)
      *reinterpret_cast<float4*>(L11 + lane * NB + 4 * q) =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    if (blockIdx.y == 0 && lane < nb) {
      // L11 and the reciprocals into the workspace; what a 16-byte group
      // holds past the diagonal lands above it in the same row, never read
      float* dst = Wc + (size_t)(k0 + lane) * LD + k0;
#pragma unroll
      for (int q = 0; q < NB / 4; ++q)
        if (4 * q <= lane)
          *reinterpret_cast<float4*>(dst + 4 * q) =
              make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }
  }
  __syncthreads();

  // One thread a row below the block (row D, b, among them): x <- x L11^-T,
  // left-looking, x_j from the dot product of the finished x_m with row j
  // of L11 in four partial sums, times 1 / L_jj.
  const int i = s + blockIdx.y * kPanelThreads + tid;
  if (i > D) return;
  float* row = Wc + (size_t)i * LD + k0;
  float x[NB];
#pragma unroll
  for (int q = 0; q < NB / 4; ++q) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (4 * q < nb) v = ld4(row + 4 * q);
#pragma unroll
    for (int m = 0; m < 4; ++m) x[4 * q + m] = 4 * q + m < nb ? part(v, m) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j < nb) {
      const float* lj = L11 + j * NB;
      float sum[4] = {x[j], 0.0f, 0.0f, 0.0f};
      float ri = 0.0f;
#pragma unroll
      for (int q = 0; q <= j / 4; ++q) {
        const float4 v = ld4(lj + 4 * q);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (4 * q + m < j) sum[m] = fmaf(-x[4 * q + m], part(v, m), sum[m]);
          if (4 * q + m == j) ri = part(v, m);
        }
      }
      x[j] = ((sum[0] + sum[1]) + (sum[2] + sum[3])) * ri;
    }
  }
#pragma unroll
  for (int q = 0; q < NB / 4; ++q)
    if (4 * q < nb)
      *reinterpret_cast<float4*>(row + 4 * q) =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// Row and column tile of the trailing update's block t: the nC (nC + 1) / 2
// tiles on or below the diagonal row by row, then, where row D starts a row
// tile of its own, that row tile's nC tiles.
__device__ __forceinline__ void tile_of(int t, int nC, int& rt, int& ct) {
  const int tri = nC * (nC + 1) / 2;
  if (t < tri) {
    rt = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
    while (rt * (rt + 1) / 2 > t) --rt;
    while ((rt + 1) * (rt + 2) / 2 <= t) ++rt;
    ct = t - rt * (rt + 1) / 2;
  } else {
    rt = nC + (t - tri) / nC;
    ct = (t - tri) % nC;
  }
}

// Grid (C, tiles) for the trailing part of the full panel k0..s-1 (s =
// k0 + 32 < D): rows s..D, columns s..min(i, D - 1), less the panel's
// product L21 L21^T (row D: less w_panel L21^T).
__global__ void __launch_bounds__(kUpdateThreads)
panels_update(float* __restrict__ W, float* __restrict__ Dg, int D, int LD,
              int k0) {
  __shared__ float Xr[kTile][NB + 1];
  __shared__ float Xc[kTile][NB + 1];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int s = k0 + NB;
  const int nC = (D - s + kTile - 1) / kTile;
  int rt, ct;
  tile_of(blockIdx.y, nC, rt, ct);
  const int i0 = s + kTile * rt, j0 = s + kTile * ct;
  float* Wc = W + (size_t)c * (D + 1) * LD;

  // the panel's slices of the tile's rows (to D) and columns (below D)
#pragma unroll
  for (int h = 0; h < kTile * NB / 4 / kUpdateThreads; ++h) {
    const int idx = tid + h * kUpdateThreads, r = idx / (NB / 4),
              q = idx % (NB / 4);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 vr =
        i0 + r <= D ? ld4(Wc + (size_t)(i0 + r) * LD + k0 + 4 * q) : zero;
    const float4 vc =
        j0 + r < D ? ld4(Wc + (size_t)(j0 + r) * LD + k0 + 4 * q) : zero;
    Xr[r][4 * q] = vr.x;
    Xr[r][4 * q + 1] = vr.y;
    Xr[r][4 * q + 2] = vr.z;
    Xr[r][4 * q + 3] = vr.w;
    Xc[r][4 * q] = vc.x;
    Xc[r][4 * q + 1] = vc.y;
    Xc[r][4 * q + 2] = vc.z;
    Xc[r][4 * q + 3] = vc.w;
  }
  __syncthreads();

  // thread (ty, tx) owns rows ty + 16 r and columns tx + 16 cc of the tile
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.0f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float a[4], bb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = Xr[ty + 16 * r][k];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) bb[cc] = Xc[tx + 16 * cc][k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(a[r], bb[cc], acc[r][cc]);
  }
  const int nb_next = min(NB, D - s);
  const bool corner = rt == 0 && ct == 0;
  float* Dc = Dg + (size_t)c * NB * NB;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i > D) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int j = j0 + tx + 16 * cc;
      if (j < D && j <= i) {
        float* p = Wc + (size_t)i * LD + j;
        const float v = *p - acc[r][cc];
        *p = v;
        // the next panel's diagonal block, which its blocks read
        if (corner && i - s < nb_next) Dc[(i - s) * NB + (j - s)] = v;
      }
    }
  }
}

// Grid C: x <- L^-T x for x = w (row D of the workspace) and x = z, a panel
// at a time from the last.
__global__ void __launch_bounds__(kSolveThreads)
panels_solve(const float* __restrict__ W, const float* __restrict__ z,
             float* __restrict__ mean, float* __restrict__ noise, int D,
             int LD) {
  extern __shared__ float uv[];
  float* u = uv;          // w -> mean
  float* v = uv + D;      // z -> noise
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const float* Wc = W + (size_t)c * (D + 1) * LD;
  for (int i = tid; i < D; i += kSolveThreads) {
    u[i] = Wc[(size_t)D * LD + i];
    v[i] = z[(size_t)c * D + i];
  }
  __syncthreads();
  for (int k0 = (D - 1) / NB * NB; k0 >= 0; k0 -= NB) {
    const int nb = min(NB, D - k0);
    if (tid < 32) {
      // lane r: column r of L11 below the diagonal, 1 / L_rr, and u, v at
      // k0 + r
      float lc[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j)
        lc[j] = (j > lane && j < nb)
                    ? Wc[(size_t)(k0 + j) * LD + k0 + lane] : 0.0f;
      const bool own = lane < nb;
      const float ri = own ? Wc[(size_t)(k0 + lane) * LD + k0 + lane] : 0.0f;
      float yu = own ? u[k0 + lane] : 0.0f;
      float yv = own ? v[k0 + lane] : 0.0f;
#pragma unroll
      for (int j = NB - 1; j >= 0; --j) {
        if (j < nb) {
          const float xu = __shfl_sync(kFullWarp, yu * ri, j);
          const float xv = __shfl_sync(kFullWarp, yv * ri, j);
          if (lane == j) {
            yu = xu;
            yv = xv;
          } else if (lane < j) {
            yu = fmaf(-lc[j], xu, yu);
            yv = fmaf(-lc[j], xv, yv);
          }
        }
      }
      if (own) {
        u[k0 + lane] = yu;
        v[k0 + lane] = yv;
      }
    }
    __syncthreads();
    // the rows above the panel: x_i -= sum_j L[k0 + j][i] x_(k0 + j)
    for (int i = tid; i < k0; i += kSolveThreads) {
      float su = 0.0f, sv = 0.0f;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < nb) {
          const float l = Wc[(size_t)(k0 + j) * LD + i];
          su = fmaf(l, u[k0 + j], su);
          sv = fmaf(l, v[k0 + j], sv);
        }
      }
      u[i] -= su;
      v[i] -= sv;
    }
    __syncthreads();
  }
  for (int i = tid; i < D; i += kSolveThreads) {
    mean[(size_t)c * D + i] = u[i];
    noise[(size_t)c * D + i] = v[i];
  }
}

}  // namespace

// A (C, D, D), b, z, mean and noise (C, D), all contiguous float32; work
// (C, D + 1, LD) and diag (C, 32, 32) float32 scratch, LD >= D a multiple
// of 4, both 16-byte aligned.  Every launch goes to `stream` in order; the
// first error stops the call and is returned.
extern "C" int bfmmm_chol_solve_panels(const float* A, const float* b,
                                       const float* z, float* mean,
                                       float* noise, float* work, float* diag,
                                       int C, int D, int LD, float jitter,
                                       void* stream_) {
  if (C < 1 || D < 1 || LD < D || LD % 4 != 0 ||
      reinterpret_cast<std::uintptr_t>(work) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(diag) % 16 != 0 ||
      (size_t)2 * D * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_;
  cudaError_t err;
  panels_prologue<<<dim3(C, (D + kPrologueRows) / kPrologueRows),
                    kPrologueThreads, 0, s>>>(A, b, work, diag, D, LD, jitter);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int k0 = 0; k0 < D; k0 += NB) {
    const int st = k0 + NB < D ? k0 + NB : D;
    panels_panel<<<dim3(C, (D + kPanelThreads - st) / kPanelThreads),
                   kPanelThreads, 0, s>>>(work, diag, D, LD, k0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (st < D) {
      const int nC = (D - st + kTile - 1) / kTile;
      const int nR = (D + 1 - st + kTile - 1) / kTile;
      const int tiles = nC * (nC + 1) / 2 + (nR - nC) * nC;
      panels_update<<<dim3(C, tiles), kUpdateThreads, 0, s>>>(work, diag, D,
                                                               LD, k0);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  panels_solve<<<C, kSolveThreads, 2 * D * sizeof(float), s>>>(
      work, z, mean, noise, D, LD);
  return (int)cudaGetLastError();
}
