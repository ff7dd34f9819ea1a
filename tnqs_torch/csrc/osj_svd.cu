// Batched one-sided (Hestenes) Jacobi SVD on a warm-started iterate.
//
// Replaces the Pallas kernel of `tnqs/ops/osj.py::osj_svd` (kernel body
// `_make_osj_kernel`, tnqs/ops/osj.py:141; rotation `_rot_params_rel`,
// :117).  It computes the same thing: sweeps*(n-1) rounds of the
// round-robin tournament over the n columns of A [R, n] (R >= n, n even),
// each rotating the n/2 disjoint column pairs (left i, right i) from the
// RIGHT, with a = |l|^2, b = |r|^2, g = l^H r recomputed fresh every round
// and the relative Hestenes skip |g|^2 <= eps^2 a b.  The same rotations
// accumulate into V.  Column norms, the sort, U = A/s and the Frobenius
// prescale stay in PyTorch (tnqs_torch/ops/osj.py).
//
// Layout: one CTA per matrix.  At the engine's widest shape A is
// [256, 128] complex64 (256 KB) and V is 128 KB, more than the 227 KB of
// shared memory a block may use, so both stay in the global buffers, which
// the wrapper fills column-contiguous (at[col][row], vt[col][row]) so that
// a column pair's reductions and updates are coalesced.  The whole batch's
// working set (B x 384 KB, ~10 MB) stays resident in the 50 MB L2.  Each
// warp owns column pairs; the 2x2 Gram entries are warp-shuffle
// reductions; a block barrier separates rounds.  The pairing is a
// permutation array in shared memory updated each round; columns never
// move (the TPU kernel shifts tile columns instead, `pcol`).
//
// What bounds it on Hopper: the latency of the sequential rounds (each a
// reduction, a dependent update and a barrier), not FLOPs or bytes.  The
// engine's batches (B <= 26 matrices) fill at most 26 of the 132 SMs; a
// version in distributed shared memory across a thread-block cluster is
// left for later work.

#include <cuda_runtime.h>

namespace {

// `_rot_params_rel` (tnqs/ops/osj.py:117): ([l, r] @ J) has orthogonal
// columns.  Returns false (identity rotation) when |g|^2 <= eps^2 * a * b.
__device__ __forceinline__ bool rot_params_rel(float a, float b, float gr,
                                               float gi, float eps, float& c,
                                               float& sr, float& si) {
  const float g2 = gr * gr + gi * gi;
  if (!(g2 > (eps * eps) * (a * b))) return false;
  const float absg = sqrtf(g2);
  const float phr = gr / absg;
  const float phi = gi / absg;
  const float tau = (b - a) / (2.0f * absg);
  const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
  const float t = -sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  c = 1.0f / sqrtf(1.0f + t * t);
  const float sm = t * c;
  sr = sm * phr;
  si = -sm * phi;
  return true;
}

// Round-robin of `pcol` with position 0 fixed (see jacobi_eigh.cu).
__device__ __forceinline__ int next_src(int j, int m) {
  if (j == 0) return 0;
  if (j == 1) return m;
  if (j < m) return j - 1;
  if (j < 2 * m - 1) return j + 1;
  return m - 1;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// [l', r'] = [l, r] @ [[c, -conj(s)], [s, c]] on `len` rows, lane-strided.
__device__ __forceinline__ void colmix(float2* __restrict__ l, float2* __restrict__ r,
                                       int len, int lane, float c, float sr, float si) {
  for (int k = lane; k < len; k += 32) {
    const float2 x = l[k], y = r[k];
    l[k] = make_float2(x.x * c + (y.x * sr - y.y * si), x.y * c + (y.x * si + y.y * sr));
    r[k] = make_float2(-(x.x * sr + x.y * si) + y.x * c, -(x.y * sr - x.x * si) + y.y * c);
  }
}

__global__ void osj_svd_kernel(float2* __restrict__ at, float2* __restrict__ vt,
                               int rows, int n, int rounds, float eps) {
  extern __shared__ int perm[];
  const int m = n / 2;
  int* P = perm;      // [n] position -> column
  int* Pn = perm + n; // [n] next round's
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float2* A = at + (size_t)blockIdx.x * n * rows;
  float2* V = vt + (size_t)blockIdx.x * n * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) P[j] = j;
  __syncthreads();

  for (int round = 0; round < rounds; ++round) {
    for (int i = warp; i < m; i += nwarps) {
      const int cl = P[i], cr = P[m + i];
      float2* Al = A + (size_t)cl * rows;
      float2* Ar = A + (size_t)cr * rows;
      float a = 0.0f, b = 0.0f, gr = 0.0f, gi = 0.0f;
      for (int k = lane; k < rows; k += 32) {
        const float2 x = Al[k], y = Ar[k];
        a += x.x * x.x + x.y * x.y;
        b += y.x * y.x + y.y * y.y;
        gr += x.x * y.x + x.y * y.y;
        gi += x.x * y.y - x.y * y.x;
      }
      // xor butterflies leave bitwise-identical sums in every lane, so all
      // lanes take the same rotation
      a = warp_sum(a);
      b = warp_sum(b);
      gr = warp_sum(gr);
      gi = warp_sum(gi);
      float c = 1.0f, sr = 0.0f, si = 0.0f;
      if (rot_params_rel(a, b, gr, gi, eps, c, sr, si)) {
        colmix(Al, Ar, rows, lane, c, sr, si);
        colmix(V + (size_t)cl * n, V + (size_t)cr * n, n, lane, c, sr, si);
      }
    }
    for (int j = threadIdx.x; j < n; j += blockDim.x) Pn[j] = P[next_src(j, m)];
    __syncthreads();
    int* tmp = P;
    P = Pn;
    Pn = tmp;
  }
}

}  // namespace

// at [batch, n, rows] and vt [batch, n, n] complex64, column-contiguous
// (at[b][col][row] = A[row, col]); both are rotated in place.
extern "C" int tnqs_osj_svd(void* at, void* vt, int batch, int rows, int n,
                            int rounds, float eps, void* stream) {
  if (batch <= 0 || n < 4 || n % 2 != 0 || rows < n || rounds < 0)
    return (int)cudaErrorInvalidValue;
  const int m = n / 2;
  const int threads = 32 * (m < 32 ? m : 32);
  const size_t smem = (size_t)2 * n * sizeof(int);
  osj_svd_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      (float2*)at, (float2*)vt, rows, n, rounds, eps);
  return (int)cudaGetLastError();
}
