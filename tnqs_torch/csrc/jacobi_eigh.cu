// Batched Hermitian eigensolver: two-sided parallel (Brent-Luk) Jacobi, one
// cluster of three CTAs per matrix: H in one, the accumulated V in two.
//
// Replaces the Pallas kernel of `tnqs/ops/jacobi.py::jacobi_eigh` (kernel
// body `_make_kernel`, tnqs/ops/jacobi.py:81; rotation `_rot_params`, :58).
// It computes the same thing: sweeps*(n-1) rounds of the round-robin
// tournament, each rotating the n/2 disjoint index pairs (position i,
// position m+i) with the complex Givens J = [[c, -conj(s)], [s, c]] from the
// stable small-root tangent, skipping a pair when |g| <= eps (absolute, as
// the TPU kernel) or, with `relative`, when |g| <= eps sqrt(|a|) sqrt(|b|)
// (Demmel-Veselic: the rotation decisions, and so the result, are then
// invariant under a scaling of H, and small eigenpairs of a graded PSD
// matrix keep their relative accuracy).
// Rows are rotated first, then columns of H and of the accumulated V.
// Eigenvalues are the final diagonal; the Newton-Schulz repair, Rayleigh
// quotients and sort stay in PyTorch (tnqs_torch/ops/jacobi.py).
//
// Layout.  CTA 0 keeps H (n x n complex64, 132 KB at n = 128) in shared
// memory with a row pitch of n+1.  A round there: the m rotations from the
// 2x2 diagonal blocks, a block vote (`__syncthreads_or`) on whether any is
// taken, and, only if one is, one fused pass over the 2x2 blocks (pair i's
// rows, pair j's columns): load the 4 entries, rotate the rows, then the
// columns, in registers, as the TPU kernel does (`prow` then `pcol`), and
// store; a block barrier.  Only blocks with i <= j are computed; block
// (j, i) gets their conjugate, so H stays exactly Hermitian off the
// diagonal blocks.  A round with nothing to rotate costs the rotations and
// the vote.  CTAs 1 and 2 each keep n/2 rows of V in shared memory and
// rotate their columns with the rounds' rotations, which CTA 0 writes into
// their shared memory (distributed shared memory) kBatch rounds at a time,
// double-buffered: one cluster barrier every kBatch rounds hands a batch
// over, while CTA 0 goes on with the next.  Its last warp writes a round's
// rotations while the other warps update H.
// So V is off H's critical path and never goes through L2.  Indices never
// move; the pairing of round r has a closed form (`index_at`).  n is a
// template parameter: 128, and 0 for any other even n (4 <= n <= 128)
// given at run time.
//
// What bounds it on Hopper: the latency of the 1016 dependent rounds (two
// block barriers each) and the FP32 issue rate of one SM for the fused
// pass (12 FP32 instructions per element of H's upper half a rotated
// round), not bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxN = 128;
constexpr int kThreads = 1024;
constexpr int kBatch = 16;  // rounds of rotations CTA 0 hands the V CTAs at a time
constexpr int kVCtas = 2;   // CTAs that hold V, each n/2 of its rows

// `_rot_params` (tnqs/ops/jacobi.py:58): J diagonalizes [[a, g], [conj(g), b]].
// Returns false (identity rotation) when |g| <= eps, or with `relative` when
// |g| <= eps sqrt(|a|) sqrt(|b|).
__device__ __forceinline__ bool rot_params(float a, float b, float gr, float gi,
                                           float eps, bool relative, float& c,
                                           float& sr, float& si) {
  const float absg = sqrtf(gr * gr + gi * gi);
  const float tol = relative ? eps * sqrtf(fabsf(a)) * sqrtf(fabsf(b)) : eps;
  if (!(absg > tol)) return false;
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

// Index that stands at position j after r rounds (0 <= r < n-1) of the
// round-robin of `pcol`/`prow` with position 0 fixed (`round_robin`,
// tnqs_torch/ops/jacobi.py): the other n-1 positions form one cycle,
// m -> 1 -> 2 -> ... -> m-1 -> n-1 -> n-2 -> ... -> m+1 -> m, along which
// every entry moves one step a round; k is the cycle step of position j.
__device__ __forceinline__ int index_at(int j, int r, int m) {
  if (j == 0) return 0;
  int k = (j < m ? j : j == m ? 0 : 3 * m - 1 - j) - r;
  if (k < 0) k += 2 * m - 1;
  return k == 0 ? m : k < m ? k : 3 * m - 1 - k;
}

// rows: top' = c*top + conj(s)*bot, bot' = -s*top + c*bot
__device__ __forceinline__ void rowmix(float2& top, float2& bot, float4 q) {
  const float c = q.x, sr = q.y, si = q.z;
  const float2 x = top, y = bot;
  top = make_float2(c * x.x + (sr * y.x + si * y.y), c * x.y + (sr * y.y - si * y.x));
  bot = make_float2(-(sr * x.x - si * x.y) + c * y.x, -(sr * x.y + si * x.x) + c * y.y);
}

// columns: left' = c*left + s*right, right' = -conj(s)*left + c*right
__device__ __forceinline__ void colmix(float2& left, float2& right, float4 q) {
  const float c = q.x, sr = q.y, si = q.z;
  const float2 x = left, y = right;
  left = make_float2(x.x * c + (y.x * sr - y.y * si), x.y * c + (y.x * si + y.y * sr));
  right = make_float2(-(x.x * sr + x.y * si) + y.x * c, -(x.y * sr - x.x * si) + y.y * c);
}

// Shared memory, the same layout in every CTA so that a peer's addresses
// are known: batch [2][kBatch][m] float4 (V CTAs: c, Re s, Im s and the
// pair's two indices packed), sent [2][kBatch] int (V CTAs: whether the
// round rotates anything), rot [m] float4 (CTA 0: c, Re s, Im s, taken),
// pos [n] int (CTA 0), then H [n][n+1] (CTA 0) or n/2 rows of V (V CTAs).
constexpr size_t smem_bytes(int n) {
  return (size_t)16 * (2 * kBatch + 1) * (n / 2) + (size_t)4 * (2 * kBatch + n) +
         (size_t)8 * n * (n + 1);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
jacobi_eigh_kernel(const float2* __restrict__ h_in, float2* __restrict__ vt,
                   float* __restrict__ w, int n_rt, int rounds, float eps,
                   int relative) {
  const int n = N ? N : n_rt;
  const int m = n / 2;
  extern __shared__ float4 smem[];
  float4* batch = smem;
  float4* rot = batch + 2 * kBatch * m;
  int* sent = reinterpret_cast<int*>(rot + m);
  int* pos = sent + 2 * kBatch;
  float2* X = reinterpret_cast<float2*>(pos + n);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int mat = blockIdx.x / (1 + kVCtas);
  const int tid = threadIdx.x;
  const int batches = (rounds + kBatch - 1) / kBatch;

  if (rank == 0) {
    const int ld = n + 1;
    float2* H = X;
    const float2* hb = h_in + (size_t)mat * n * n;
    for (int t = tid; t < n * n; t += blockDim.x) {
      const int r = t / n, c = t - r * n;
      H[r * ld + c] = hb[t];
    }
    float4* batch_peer[kVCtas];
    int* sent_peer[kVCtas];
#pragma unroll
    for (int v = 0; v < kVCtas; ++v) {
      batch_peer[v] = cluster.map_shared_rank(batch, v + 1);
      sent_peer[v] = cluster.map_shared_rank(sent, v + 1);
    }
    // the last warp sends the rotations to the V CTAs; the others rotate H
    const int workers = (int)blockDim.x - 32;
    const int tri = (m / 2) * (m + 1);  // 2x2 blocks (i, j) with i <= j
    cluster.sync();  // every CTA is running
    int rr = 0;      // round mod (n-1)
    for (int b = 0; b < batches; ++b) {
      const int buf = (b & 1) * kBatch;
      for (int round = b * kBatch; round < min(rounds, (b + 1) * kBatch); ++round) {
        const int slot = buf + round - b * kBatch;
        // the rotations, and the index at each position
        int live = 0;
        if (tid < n) pos[tid] = index_at(tid, rr, m);
        if (tid < m) {
          float4 q = make_float4(1.0f, 0.0f, 0.0f, 0.0f);
          const int p = index_at(tid, rr, m), qq = index_at(m + tid, rr, m);
          const float2 g = H[p * ld + qq];
          live = rot_params(H[p * ld + p].x, H[qq * ld + qq].x, g.x, g.y, eps, relative != 0,
                           q.x, q.y, q.z);
          q.w = live ? 1.0f : 0.0f;
          rot[tid] = q;
        }
        const int any = __syncthreads_or(live);
        if (tid == workers)
#pragma unroll
          for (int v = 0; v < kVCtas; ++v) sent_peer[v][slot] = any;
        if (any) {
          if (tid < workers) {
            // Block (i, j), i <= j: pair i's rows and pair j's columns, rows
            // first, then columns; for i < j the conjugate goes to block
            // (j, i), so H stays Hermitian and half the blocks are computed.
            // The triangle is folded: row f of it holds block rows f and
            // m-1-f.
            for (int e = tid; e < tri; e += workers) {
              const int f = e / (m + 1), c = e - f * (m + 1);
              const bool low = c >= m - f;
              const int i = low ? m - 1 - f : f, j = low ? c - 1 : f + c;
              const float4 qi = rot[i], qj = rot[j];
              if (qi.w == 0.0f && qj.w == 0.0f) continue;
              const int rw[2] = {pos[i], pos[m + i]}, cl[2] = {pos[j], pos[m + j]};
              float2 h[4];
#pragma unroll
              for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int bb = 0; bb < 2; ++bb) h[2 * a + bb] = H[rw[a] * ld + cl[bb]];
              if (qi.w != 0.0f) {
                rowmix(h[0], h[2], qi);
                rowmix(h[1], h[3], qi);
              }
              if (qj.w != 0.0f) {
                colmix(h[0], h[1], qj);
                colmix(h[2], h[3], qj);
              }
#pragma unroll
              for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int bb = 0; bb < 2; ++bb) {
                  const float2 x = h[2 * a + bb];
                  H[rw[a] * ld + cl[bb]] = x;
                  if (i != j) H[cl[bb] * ld + rw[a]] = make_float2(x.x, -x.y);
                }
            }
          } else {
            // the last warp: this round's rotations and their pairs into the
            // V CTAs' batch, while the others update H
            for (int i = tid - workers; i < m; i += 32) {
              const float4 q = rot[i];
              const float4 e = make_float4(
                  q.x, q.y, q.z, __int_as_float(pos[i] << 16 | pos[m + i] << 1 | (q.w != 0.0f)));
#pragma unroll
              for (int v = 0; v < kVCtas; ++v) batch_peer[v][slot * m + i] = e;
            }
          }
          __syncthreads();
        }
        if (++rr == n - 1) rr = 0;
      }
      // batch b is in the V CTAs, which have finished batch b-1
      cluster.sync();
    }
    for (int j = tid; j < n; j += blockDim.x) w[(size_t)mat * n + j] = H[j * ld + j].x;
  } else {
    // rows [row0, row0 + hv) of V, column-major: V[col * hv + row - row0]
    const int hv = n / kVCtas, row0 = (rank - 1) * hv;
    float2* V = X;
    for (int t = tid; t < n * hv; t += blockDim.x) {
      const int col = t / hv, r = t - col * hv;
      V[t] = make_float2(col == row0 + r ? 1.0f : 0.0f, 0.0f);
    }
    cluster.sync();  // every CTA is running
    for (int b = 0; b < batches; ++b) {
      cluster.sync();  // batch b has arrived
      const int buf = (b & 1) * kBatch;
      for (int slot = buf; slot < buf + min(kBatch, rounds - b * kBatch); ++slot) {
        if (!sent[slot]) continue;
        const float4* qs = batch + slot * m;
        // four elements at a time, every load before any store
        for (int e0 = tid; e0 < m * hv; e0 += 4 * blockDim.x) {
          int lo[4], ro[4];
          float4 q[4];
          float2 x[4], y[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = min(e0 + u * (int)blockDim.x, m * hv - 1);
            const int i = e / hv, row = e - i * hv;
            q[u] = qs[i];
            const int meta = e0 + u * (int)blockDim.x < m * hv ? __float_as_int(q[u].w) : 0;
            q[u].w = __int_as_float(meta & 1);  // taken; its bits, not a value
            lo[u] = (meta >> 16) * hv + row;
            ro[u] = (meta >> 1 & 0x7fff) * hv + row;
            x[u] = V[lo[u]];
            y[u] = V[ro[u]];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (__float_as_int(q[u].w) == 0) continue;
            colmix(x[u], y[u], q[u]);
            V[lo[u]] = x[u];
            V[ro[u]] = y[u];
          }
        }
        __syncthreads();  // the next round's columns are other pairs
      }
    }
    float2* vb = vt + (size_t)mat * n * n;
    for (int t = tid; t < n * hv; t += blockDim.x) {
      const int col = t / hv, r = t - col * hv;
      vb[(size_t)col * n + row0 + r] = V[t];
    }
  }
  // CTA 0 passes this barrier when the V CTAs have taken the last batch; no
  // shared memory is read or written across CTAs after it
  cluster.sync();
}

using Kernel = void (*)(const float2*, float2*, float*, int, int, float, int);

Kernel kernel_for(int n) { return n == kMaxN ? jacobi_eigh_kernel<kMaxN> : jacobi_eigh_kernel<0>; }

cudaLaunchConfig_t launch_config(int batch, int n, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((1 + kVCtas) * batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(n);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1 + kVCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The most clusters the card holds at once for size n
// (cudaOccupancyMaxActiveClusters), into *active.
extern "C" int tnqs_jacobi_eigh_clusters(int n, int* active) {
  if (n < 4 || n > kMaxN || n % 2 != 0) return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(n);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(n));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, n, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(active, (const void*)kernel, &cfg);
}

// h_in [batch, n, n] hermitian complex64 (row-major), vt_out [batch, n, n]
// with vt_out[b][col][row] = V[row, col], w_out [batch, n] (unsorted);
// `relative` != 0 takes the scale-relative skip.
extern "C" int tnqs_jacobi_eigh(const void* h_in, void* vt_out, void* w_out,
                                int batch, int n, int rounds, float eps,
                                int relative, void* stream) {
  if (batch <= 0 || n < 4 || n > kMaxN || n % 2 != 0 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(n);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(n));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(batch, n, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, (const float2*)h_in, (float2*)vt_out,
                           (float*)w_out, n, rounds, eps, relative);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
