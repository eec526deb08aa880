// K1: per-chain Cholesky factor-and-solve of the joint precision draw.
//
// Replaces bayesfmmm_tpu/ops/pallas_kernels.py::chol_solve_batch_minor
// (kernel body _chol_solve_kernel).  For each chain c, given an SPD
// A_c (D x D, row-major), b_c and z_c (D), it computes L = chol(A_c),
// mean_c = L^-T L^-1 b_c and noise_c = L^-T z_c in one launch: the
// N(A^-1 b, A^-1) draw of update_phi's joint block (D = K*M*P = 96 and
// C = 256 chains on the main path).
//
// What bounds it on the card: neither bytes nor FLOPs.  At the main path's
// shape the launch reads 9.4 MB and does D^3/3 ~ 0.3 MFLOP per chain;
// its time is the dependency chain of D column steps of the factorization
// (two block barriers each) and 2*D substitution steps.
//
// Design: one thread block per chain, so the chains' chains of dependent
// steps run side by side (at D = 96 a block takes 37 KB of shared memory
// and all 256 blocks are resident at once on 132 SMs).  The matrix lives
// in shared memory for the whole launch, so every step reads and writes
// on-chip.  The factorization is right-looking, column by column: scale
// column j, then update the trailing lower triangle with warps over rows
// and lanes over columns.  Each finished column of L is also written, as
// a row, into the unused upper triangle, so the trailing update and both
// substitutions read L along rows: consecutive lanes touch consecutive
// addresses and no bank conflicts arise.  The substitutions are serial in
// j and short (D steps of D - j multiply-adds), so one warp runs them with
// __syncwarp only.  No batch-minor transpose and no 128-lane padding: the
// TPU kernel needed both to put chains on vector lanes; here chains are
// blocks.  D up to the largest for which (D*D + 2*D) floats fit the
// 227 KB opt-in shared memory of one block (240); the wrapper rejects more.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  const float* __restrict__ z, float* __restrict__ mean,
                  float* __restrict__ noise, int D) {
  extern __shared__ float smem[];
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

}  // namespace

extern "C" int bfmmm_chol_solve(const float* A, const float* b,
                                const float* z, float* mean, float* noise,
                                int C, int D, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)D * D + 2 * (size_t)D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  chol_solve_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(
      A, b, z, mean, noise, D);
  return (int)cudaGetLastError();
}
