// Batched Hermitian eigensolver: two-sided parallel (Brent-Luk) Jacobi.
//
// Replaces the Pallas kernel of `tnqs/ops/jacobi.py::jacobi_eigh` (kernel
// body `_make_kernel`, tnqs/ops/jacobi.py:81; rotation `_rot_params`, :58).
// It computes the same thing: sweeps*(n-1) rounds of the round-robin
// tournament, each rotating the n/2 disjoint index pairs (top i, bottom i)
// with the complex Givens J = [[c, -conj(s)], [s, c]] from the stable
// small-root tangent, skipping a pair when |g| <= eps (absolute).  Rows are
// rotated first, then columns of H and of the accumulated V.  Eigenvalues
// are the final diagonal; the Newton-Schulz repair, Rayleigh quotients and
// sort stay in PyTorch (tnqs_torch/ops/jacobi.py).
//
// Layout: one CTA per matrix.  H (n x n complex64, 128 KB at n = 128) lives
// in dynamic shared memory with a row pitch of n+1 so column accesses do not
// collide on banks; V is kept in the global output buffer, column-contiguous
// (vt[col][row]), so a column rotation is a coalesced access.  The pairing
// is tracked by a permutation array in shared memory that is updated each
// round; the data never moves (the TPU kernel shifts tile rows and columns
// instead, `prow`/`pcol`).  After whole sweeps the permutation is the
// identity again.
//
// What bounds it on Hopper: the latency of the sequential rounds and their
// three block barriers, not FLOPs or bytes (a round is n^2 complex updates
// out of shared memory).  The engine's batches (B <= 26 matrices) fill at
// most 26 of the 132 SMs; spreading a matrix over a thread-block cluster is
// left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;

// `_rot_params` (tnqs/ops/jacobi.py:58): J diagonalizes [[a, g], [conj(g), b]].
// Returns false (identity rotation) when |g| <= eps.
__device__ __forceinline__ bool rot_params(float a, float b, float gr, float gi,
                                           float eps, float& c, float& sr,
                                           float& si) {
  const float absg = sqrtf(gr * gr + gi * gi);
  if (!(absg > eps)) return false;
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

// Position whose entry moves to position j in the next round: the
// round-robin of `pcol`/`prow` with position 0 fixed,
// left' = [l0, r0, l1 .. l(m-2)], right' = [r1 .. r(m-1), l(m-1)].
__device__ __forceinline__ int next_src(int j, int m) {
  if (j == 0) return 0;
  if (j == 1) return m;
  if (j < m) return j - 1;
  if (j < 2 * m - 1) return j + 1;
  return m - 1;
}

__global__ void jacobi_eigh_kernel(const float2* __restrict__ h_in,
                                   float2* __restrict__ vt,
                                   float* __restrict__ w, int n, int rounds,
                                   float eps) {
  extern __shared__ float2 smem[];
  const int m = n / 2;
  const int ld = n + 1;
  float2* H = smem;                                    // [n][ld]
  float* rc = reinterpret_cast<float*>(H + n * ld);    // [m] cos
  float* rsr = rc + m;                                 // [m] Re s
  float* rsi = rsr + m;                                // [m] Im s
  int* live = reinterpret_cast<int*>(rsi + m);         // [m] rotation taken
  int* P = live + m;                                   // [n] position -> index
  int* Pn = P + n;                                     // [n] next round's

  const float2* hb = h_in + (size_t)blockIdx.x * n * n;
  float2* vb = vt + (size_t)blockIdx.x * n * n;
  for (int t = threadIdx.x; t < n * n; t += blockDim.x) {
    const int r = t / n, c = t % n;
    H[r * ld + c] = hb[t];
    vb[t] = make_float2(r == c ? 1.0f : 0.0f, 0.0f);
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) P[j] = j;
  __syncthreads();

  for (int round = 0; round < rounds; ++round) {
    // phase 1: rotation of each pair from its 2x2 block; next pairing
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int p = P[i], q = P[m + i];
      const float2 g = H[p * ld + q];
      float c = 1.0f, sr = 0.0f, si = 0.0f;
      live[i] = rot_params(H[p * ld + p].x, H[q * ld + q].x, g.x, g.y, eps, c, sr, si);
      rc[i] = c;
      rsr[i] = sr;
      rsi[i] = si;
    }
    for (int j = threadIdx.x; j < n; j += blockDim.x) Pn[j] = P[next_src(j, m)];
    __syncthreads();

    // phase 2: rows, top' = c*top + conj(s)*bot, bot' = -s*top + c*bot
    for (int t = threadIdx.x; t < m * n; t += blockDim.x) {
      const int i = t / n, j = t % n;
      if (!live[i]) continue;
      const float c = rc[i], sr = rsr[i], si = rsi[i];
      float2* top = &H[P[i] * ld + j];
      float2* bot = &H[P[m + i] * ld + j];
      const float2 x = *top, y = *bot;
      *top = make_float2(c * x.x + (sr * y.x + si * y.y), c * x.y + (sr * y.y - si * y.x));
      *bot = make_float2(-(sr * x.x - si * x.y) + c * y.x, -(sr * x.y + si * x.x) + c * y.y);
    }
    __syncthreads();

    // phase 3: columns of H and V, left' = c*left + s*right,
    // right' = -conj(s)*left + c*right
    for (int t = threadIdx.x; t < m * n; t += blockDim.x) {
      const int i = t / n, r = t % n;
      if (!live[i]) continue;
      const float c = rc[i], sr = rsr[i], si = rsi[i];
      const int p = P[i], q = P[m + i];
      float2* cols[2][2] = {{&H[r * ld + p], &H[r * ld + q]},
                            {&vb[(size_t)p * n + r], &vb[(size_t)q * n + r]}};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float2 x = *cols[k][0], y = *cols[k][1];
        *cols[k][0] = make_float2(x.x * c + (y.x * sr - y.y * si), x.y * c + (y.x * si + y.y * sr));
        *cols[k][1] = make_float2(-(x.x * sr + x.y * si) + y.x * c, -(x.y * sr - x.x * si) + y.y * c);
      }
    }
    __syncthreads();
    int* tmp = P;
    P = Pn;
    Pn = tmp;
  }

  for (int j = threadIdx.x; j < n; j += blockDim.x)
    w[(size_t)blockIdx.x * n + j] = H[j * ld + j].x;
}

}  // namespace

// h_in [batch, n, n] hermitian complex64 (row-major), vt_out [batch, n, n]
// with vt_out[b][col][row] = V[row, col], w_out [batch, n] (unsorted).
extern "C" int tnqs_jacobi_eigh(const void* h_in, void* vt_out, void* w_out,
                                int batch, int n, int rounds, float eps,
                                void* stream) {
  if (batch <= 0 || n < 4 || n > kMaxN || n % 2 != 0 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  const int m = n / 2;
  const size_t smem = (size_t)n * (n + 1) * sizeof(float2) +
                      (size_t)4 * m * sizeof(float) + (size_t)2 * n * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_eigh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = m * n < 1024 ? ((m * n + 31) / 32) * 32 : 1024;
  jacobi_eigh_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      (const float2*)h_in, (float2*)vt_out, (float*)w_out, n, rounds, eps);
  return (int)cudaGetLastError();
}
