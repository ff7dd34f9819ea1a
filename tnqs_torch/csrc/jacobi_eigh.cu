// Batched Hermitian eigensolver: two-sided parallel (Brent-Luk) Jacobi.  Up
// to n = 128 one cluster of three CTAs per matrix: H in one, the
// accumulated V in two; past n = 128 the resident variant (H in the shared
// memory of a cluster of 2 to 16 CTAs) and, past its widths, the L2 variant,
// at the end: H alone in the rounds and V from their rotation log
// (`rotation_log.cu`).
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


// ---------------------------------------------------------------------------
// n > 128.  H no longer fits one CTA (296,448 bytes at n = 192), and V no
// longer takes part in the rounds: each round's m rotations go to a
// rotation log in device memory ([batch][rounds][m] float4: c, Re s, Im s
// and meta = p << 16 | q << 1 | taken, p and q the pair's indices), and
// `rotation_log.cu` applies the log to V = I afterwards, or beside the
// rounds on SMs their clusters leave idle, by slabs of rows, with the same
// `colmix` in the same order.  The rounds then touch H alone: 8 n^2 bytes a
// matrix, half of H and V.  (Up to n = 224, `kRingN`, a second instance
// keeps V's columns in the rings beside H's, `kV`: the same slots, the
// same hand-over, no log.)
//
// The resident variant (128 < n <= 598: on 2, 4, 8 or 16 CTAs, the size that
// takes a batch in the fewest waves, `eigh_res_fits` and `resident_choice`
// in tnqs_torch/ops/jacobi.py; n = 256 fits 4 CTAs, 598 only 16).  H stays
// in the cluster's shared memory for all rounds as Brent and Luk's
// processor array: CTA k owns the pair positions [k m / C, (k+1) m / C) (P
// of them, at least 2) and holds the columns of H standing at them, in two
// rings of slots (`Ring`: the left lane's positions moving up, the right
// lane's down), each with two spare slots; rows keep their index; columns
// move along the tournament's cycle (m -> 1 -> ... -> m-1 -> n-1 -> ... ->
// m+1 -> m), and so between CTAs, and keep their slot while they stay, so
// every CTA knows every slot in closed form.  The same rotations as the
// kernel above: the same pairing (`index_at`), `rot_params` with either
// skip, rows first, then columns, by `rowmix` and `colmix`, H updated in
// full (not mirrored: it stays Hermitian to rounding, and the Newton-Schulz
// repair and the Rayleigh quotients in PyTorch follow as above).  One
// hand-over a round: every CTA forms all m rotations itself from the
// entries (H[x][x], and right of its pair H[p][x]) of every column x, which
// the column's holder sends into every CTA for the round ahead, so no
// rotation is broadcast.  A round r:
//   A. wait on the mbarrier of round r's parity for the n entries and (past
//      round 0) the two columns that arrive;
//   B. all m rotations from the entries, bitwise the same in every CTA, so
//      the block vote on whether any is taken is the same everywhere; the
//      CTA's own pairs' rotations into the log;
//   C. if one is: each 2x2 block (row pair i of all m, column pair j of the
//      CTA's P) rotated, rows then columns, in registers, a thread keeping
//      one row pair; a block barrier;
//   D. (not after the last round) the two columns that leave the CTA's
//      positions go into a spare slot of the CTAs that own their next
//      positions, by `st.async` (16 bytes each) against the receiver's
//      mbarrier of round r+1's parity; and the entries of the CTA's 2P
//      columns for round r+1 (`next_position`), computed from its own
//      columns (the leaving ones too), into every CTA the same way.
// Why no buffer is overwritten while it is read: a CTA sends round r+1's
// entries and columns only after it received every CTA's round r entries.
// (a) Entries, double-buffered by parity: CTA c read its round r-1 half
//     (B of round r-1) before it sent its round r entries (D of round r-1).
// (b) Slots: the arriving column of round r+1 takes the slot of the
//     receiver's ring that its column leaving after round r-2 freed (two
//     spare slots a ring); the receiver read that column (D of round r-2)
//     before the vote barrier of round r-1, which precedes its round r
//     entries (D of round r-1).  So D needs no barrier between the columns
//     and the entries, which a ring with one spare slot would.
// (c) mbarriers: a round r+2 byte can reach CTA c only after c's round r
//     phase completed (the round r+1 data that precedes it was sent after
//     every CTA received round r's), and a byte that lands before c's thread
//     0 posts the phase's expected count leaves the count below zero, which
//     the phase allows.
// No send follows the last round, so every CTA has received all that was
// sent to it when it leaves.  H's final diagonal is w.  Every `stage` rounds
// (and at the end) thread 0 publishes how many rounds the CTA has logged
// (`publish`), for a V kernel that follows the log (`rotation_log.cu`).
//
// What bounds it: the latency of the sweeps * (n-1) dependent rounds (one
// DSMEM hand-over, the vote and a block barrier each) and one SM's FP32
// issue rate for a round's m P blocks (48 FP32 operations a block), not
// bytes: H is read from device memory once and only w is written.
//
// Past that width (or where the card holds no such cluster) the L2 variant:
// H column-major in device memory (hc[col][row] = H[row][col]; the wrapper
// copies H in) kept hot in L2 (the wrapper runs only as many matrices at
// once as keep their H within ~40 MB of it, `eigh_l2_plan`), each cluster
// taking the next matrix when it is done.  One cluster of C CTAs (16,
// non-portable, where the card holds one, else 8) per matrix; CTA k owns the
// pair positions [k m / C, (k+1) m / C) and, each round, the columns of H
// whose indices stand at them (`index_at`); columns never move.  A round:
//   A. every CTA forms all m rotations from a small exchange buffer that
//      holds, for every column x, H[x][x] and, if x stands right of its
//      pair, the coupling H[p][x] to the left column p; every CTA reads the
//      same values in the same order, so all take bitwise the same
//      rotations and the same vote on whether any is taken, with no
//      exchange of rotations; the CTA's own pairs' rotations into the log;
//   B. if one is: the CTA rotates the 2x2 blocks (every row pair i, its own
//      column pairs j) of H, in device memory;
//   C. the CTA writes into the other half of the exchange buffer the next
//      round's entries of its own columns (`next_position`), then a cluster
//      barrier, release then acquire, makes its writes visible to the CTAs
//      that own those columns next.
// Every load of H or the exchange buffer is `ld.global.cg`: a column is
// written by other CTAs between two of this CTA's visits, so no line of it
// may be served from this SM's L1.  The exchange buffer is double-buffered
// by round parity: round r+1 writes the half round r read only after all
// CTAs passed round r's barrier, which each reaches after its reads of
// round r.  H is updated in full, not mirrored.  The eigenvalues are the
// final diagonal, which the wrapper reads.  What bounds it: the bytes a
// round moves through L2 (H's columns read and written once a round a
// rotation is taken: 16 n^2 bytes a matrix) and the latency of the rounds,
// each one cluster barrier; not FLOPs.

constexpr int kResThreads = 512;
// V in the rings up to this width, where H and V fit clusters of 4
// (`RING_N` in tnqs_torch/ops/jacobi.py)
constexpr int kRingN = 224;
constexpr int kL2Threads = 512;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// This phase of the mbarrier at `bar` expects `bytes` more.
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` of the mbarrier at `bar`; a wait far
// longer than any round traps rather than hangs.
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1ll << 24)) __trap();
  }
}

// the most pairs a CTA of a cluster of C owns
__host__ __device__ constexpr int ring_pmax(int m, int C) { return (m + C - 1) / C; }

// `v` (16 bytes) into CTA `rank`'s shared memory at this CTA's address
// `addr`, counted against the transaction count of the mbarrier there at
// `bar`.
__device__ __forceinline__ void send4(unsigned addr, float4 v, unsigned bar, unsigned rank) {
  unsigned raddr, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(raddr) : "r"(addr), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rbar) : "r"(bar), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
               ::"r"(raddr), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
               "r"(__float_as_uint(v.w)), "r"(rbar) : "memory");
}

// The position the entry at position j takes in the next round, along the
// cycle of `index_at` (m -> 1 -> ... -> m-1 -> n-1 -> ... -> m+1 -> m).
__device__ __forceinline__ int next_position(int j, int m) {
  if (j == 0) return 0;
  if (j == m) return 1;
  if (j < m - 1) return j + 1;
  if (j == m - 1) return 2 * m - 1;
  return j - 1;
}

// The log's entry of pair (p, q): the rotation and its meta bits.
__device__ __forceinline__ float4 log_entry(float4 q, int p, int qq) {
  return make_float4(q.x, q.y, q.z, __int_as_float(p << 16 | qq << 1 | (q.w != 0.0f)));
}

// The entry of column x (held in `col`, by row) for the round whose cycle
// step is rr, x standing at position j then: (H[x][x], and right of its
// pair Re, Im of H[p][x] with p the left column).
__device__ __forceinline__ float4 res_entry(const float2* col, int x, int j, int rr, int m) {
  float4 e = make_float4(col[x].x, 0.0f, 0.0f, 0.0f);
  if (j >= m) {
    const float2 g = col[index_at(j - m, rr, m)];
    e.y = g.x;
    e.z = g.y;
  }
  return e;
}

// A lane's ring of column slots in the resident variant: `size` slots for
// size - 2 moving columns, two spare; `off` = the round mod size, kept by
// stepping (no division in the round).  The column t steps along the lane
// (t = 0 where the arriving column enters) sits at slot at(t) while it
// stays.
struct Ring {
  int size, off;
  __device__ int at(int t) const {
    const int x = t - off;
    return x < 0 ? x + size : x;
  }
  __device__ int next_at(int t) const {  // at(t) a round later
    const int x = t - (off + 1 == size ? 0 : off + 1);
    return x < 0 ? x + size : x;
  }
  __device__ void step() { off = off + 1 == size ? 0 : off + 1; }
};

// the entries [2][n] float4 (by round parity), the rotations [m] float4, the
// column slots of H [2 pmax + 5][n] float2 (two rings of pmax + 2, and CTA
// 0's fixed position 0) and, with `v`, as many of V, 2 mbarriers (by round
// parity), the index at each position [n] int, the CTA's pairs' slots
// [2][pmax] int (`eigh_res_smem` in tnqs_torch/ops/jacobi.py states the same
// sum)
__host__ __device__ constexpr size_t res_smem_bytes(int n, int C, bool v) {
  return (size_t)32 * n + (size_t)8 * n + (size_t)8 * (v ? 2 : 1) * (2 * ring_pmax(n / 2, C) + 5) * n + 16 +
         (size_t)4 * n + (size_t)8 * ring_pmax(n / 2, C);
}

// Where a V kernel follows this one's log as it grows (`rotation_log.cu`):
// store v at p after every write of this CTA's threads that a block barrier
// ordered before (the device-wide fence makes them visible first).
__device__ __forceinline__ void publish(int* p, int v) {
  __threadfence();
  *(volatile int*)p = v;
}

// V's rows p, q of the column pair L, R rotated by qj (`colmix`).
__device__ __forceinline__ void res_vpair(float2* L, float2* R, int p, int q, float4 qj) {
  float2 a = L[p], b = R[p], c = L[q], d = R[q];
  colmix(a, b, qj);
  colmix(c, d, qj);
  L[p] = a;
  R[p] = b;
  L[q] = c;
  R[q] = d;
}

// kV = false: V from the log (`log`, w, the flags for a following V kernel);
// kV = true: V's columns in the rings beside H's, written to vt (vt[col][row]
// = V[row, col]) at the end, no log.
template <bool kV>
__global__ void __launch_bounds__(kResThreads, 1)
jacobi_eigh_res_kernel(const float2* __restrict__ h_in, float4* __restrict__ log, float2* __restrict__ vt,
                       float* __restrict__ w, unsigned long long* __restrict__ taken_out, int* __restrict__ started,
                       int* __restrict__ progress, int stage, int n, int rounds, float eps, int relative) {
  extern __shared__ float4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int k = (int)cluster.block_rank();
  const int mat = blockIdx.x / C;
  const int m = n / 2, tid = threadIdx.x;
  const int pmax = ring_pmax(m, C), nslots = 2 * pmax + 5;
  const int s0 = k * m / C, P = (k + 1) * m / C - s0;  // the CTA's pair positions
  const int lc = __ffs(C) - 1;                          // C = 1 << lc
  float4* ent = smem;                                                                      // [2][n]
  float4* rot = ent + 2 * n;                                                               // [m]
  float2* Hs = reinterpret_cast<float2*>(rot + m);                                         // [nslots][n]
  float2* Vs = Hs + (size_t)nslots * n;                                                    // kV: [nslots][n]
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(Hs + (size_t)(kV ? 2 : 1) * nslots * n);  // [2]
  int* pos = reinterpret_cast<int*>(bars + 2);                                             // [n]
  int* cs = pos + n;  // [2][P]: the left, then the right slot of each pair
  float4* lg = kV ? nullptr : log + (size_t)mat * rounds * m;
  // The rings: the left lane (positions moving up; CTA 0's position 0 stays
  // in slot 2 pmax + 4) in slots [0, pmax + 2), the right lane (moving down)
  // in [pmax + 2, 2 pmax + 4); those of the CTAs the leaving columns go to.
  const auto pairs = [&](int c) { return (c + 1) * m / C - c * m / C; };
  Ring left{P - (k == 0) + 2, 0}, right{P + 2, 0};
  Ring up{k < C - 1 ? pairs(k + 1) + 2 : P + 2, 0}, down{k > 0 ? pairs(k - 1) + 2 : P - (k == 0) + 2, 0};
  const int fixed = 2 * pmax + 4;
  const auto slot_of = [&](int t) {  // the slot of the CTA's t-th column: left of pair t, or right of pair t - P
    return t < P ? (k == 0 && t == 0 ? fixed : left.at(t - (k == 0))) : pmax + 2 + right.at(2 * P - 1 - t);
  };

  // round 0: position = index; the CTA's columns of H (and of V = I)
  const float2* hb = h_in + (size_t)mat * n * n;
  for (int e = tid; e < 2 * P * n; e += blockDim.x) {
    const int row = e / (2 * P), t = e - row * (2 * P);
    const int col = t < P ? s0 + t : m + s0 + t - P;
    Hs[slot_of(t) * n + row] = hb[(size_t)row * n + col];
    if constexpr (kV) Vs[slot_of(t) * n + row] = make_float2(row == col ? 1.0f : 0.0f, 0.0f);
  }
  if (tid == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + b)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA of the cluster is running, its columns are loaded and its
  // mbarriers are set
  cluster.sync();
  if (started != nullptr && k == 0 && tid == 0) publish(started + mat, 1);
  // round 0's entries of the CTA's columns, into every CTA
  for (int e = tid; rounds > 0 && e < 2 * P * C; e += blockDim.x) {
    const int t = e >> lc, c = e & (C - 1);
    const int j = t < P ? s0 + t : m + s0 + t - P;
    send4(smem_addr(ent + j), res_entry(Hs + slot_of(t) * n, j, j, 0, m), smem_addr(bars), c);
  }

  unsigned long long taken_here = 0;  // the rotations of the CTA's pairs taken
  int rr = 0;                         // round mod (n-1)
  for (int r = 0; r < rounds; ++r) {
    const int par = r & 1;
    const unsigned bar = smem_addr(bars + par);
    // n entries, two columns of H (and of V)
    if (tid == 0) expect_bytes(bar, r > 0 ? (kV ? 48u : 32u) * n : 16u * n);
    for (int j = tid; j < n; j += blockDim.x) pos[j] = index_at(j, rr, m);
    if (tid < 2 * P) cs[tid] = slot_of(tid);
    // A.
    wait_phase(bar, (r >> 1) & 1);
    // B. every rotation, the same in every CTA; the vote (also the barrier
    // before pos and cs are read)
    const float4* er = ent + par * n;
    int live = 0;
    for (int i = tid; i < m; i += blockDim.x) {
      const int p = index_at(i, rr, m), q = index_at(m + i, rr, m);
      const float4 ep = er[p], eq = er[q];
      float4 qv = make_float4(1.0f, 0.0f, 0.0f, 0.0f);
      const bool taken = rot_params(ep.x, eq.x, eq.y, eq.z, eps, relative != 0, qv.x, qv.y, qv.z);
      qv.w = taken ? 1.0f : 0.0f;
      rot[i] = qv;
      live |= taken;
      if (i >= s0 && i < s0 + P) {
        if constexpr (!kV) lg[(size_t)r * m + i] = log_entry(qv, p, q);
        taken_here += taken;
      }
    }
    const int any = __syncthreads_or(live);
    // C. block (pair i's rows, the CTA's pair j's columns), rows first, then
    // columns; a thread keeps one row pair and takes every `step`-th of the
    // CTA's column pairs, two blocks at a time, the second's loads before
    // the first's stores.  (nvcc contracts the two blocks' products into
    // FMAs otherwise than in a loop of one block at a time, so H and w
    // part from the L2 variant's by rounding; one block at a time gives its
    // bits and costs ~7% more at [4, 512, 512].)
    if (any) {
      const int step = blockDim.x / m, i = tid % m;
      if (tid < step * m) {
        const float4 qi = rot[i];
        const int p = pos[i], q = pos[m + i];
        for (int j = tid / m; j < P; j += 2 * step) {
          const int j2 = min(j + step, P - 1);
          const float4 qj = rot[s0 + j], qk = rot[s0 + j2];
          const bool g1 = qi.w != 0.0f || qj.w != 0.0f;
          const bool g2 = j + step < P && (qi.w != 0.0f || qk.w != 0.0f);
          float2* L = Hs + cs[j] * n;
          float2* R = Hs + cs[P + j] * n;
          float2* L2 = Hs + cs[j2] * n;
          float2* R2 = Hs + cs[P + j2] * n;
          float2 h0, h1, h2, h3, k0, k1, k2, k3;
          if (g1) {
            h0 = L[p];
            h1 = R[p];
            h2 = L[q];
            h3 = R[q];
          }
          if (g2) {
            k0 = L2[p];
            k1 = R2[p];
            k2 = L2[q];
            k3 = R2[q];
          }
          if (g1) {
            if (qi.w != 0.0f) {
              rowmix(h0, h2, qi);
              rowmix(h1, h3, qi);
            }
            if (qj.w != 0.0f) {
              colmix(h0, h1, qj);
              colmix(h2, h3, qj);
            }
            L[p] = h0;
            R[p] = h1;
            L[q] = h2;
            R[q] = h3;
          }
          if (g2) {
            if (qi.w != 0.0f) {
              rowmix(k0, k2, qi);
              rowmix(k1, k3, qi);
            }
            if (qk.w != 0.0f) {
              colmix(k0, k1, qk);
              colmix(k2, k3, qk);
            }
            L2[p] = k0;
            R2[p] = k1;
            L2[q] = k2;
            R2[q] = k3;
          }
          if constexpr (kV) {  // V's rows p, q of the same column pairs
            if (qj.w != 0.0f) res_vpair(Vs + cs[j] * n, Vs + cs[P + j] * n, p, q, qj);
            if (j + step < P && qk.w != 0.0f) res_vpair(Vs + cs[j2] * n, Vs + cs[P + j2] * n, p, q, qk);
          }
        }
      }
      __syncthreads();
    }
    if (r + 1 == rounds) break;
    const int rn = rr + 1 == n - 1 ? 0 : rr + 1;
    const unsigned bar_n = smem_addr(bars + (par ^ 1));
    // D. the left lane's top column goes up to the next CTA's left lane (the
    // last CTA's to its own right lane, position m-1 -> n-1), the right
    // lane's bottom one down to the previous CTA's right lane (CTA 0's to its
    // own left lane, position m -> 1), each into a spare slot of the
    // receiver's ring (H's, then V's: the same slots)
    {
      const int src_l = left.at(P - (k == 0) - 1), src_r = pmax + 2 + right.at(P - 1);
      const int to_l = k < C - 1 ? k + 1 : k, to_r = k > 0 ? k - 1 : 0;
      const int dst_l = k < C - 1 ? up.next_at(0) : pmax + 2 + up.next_at(0);
      const int dst_r = k > 0 ? pmax + 2 + down.next_at(0) : down.next_at(0);
      for (int e = tid; e < (kV ? 2 : 1) * n; e += blockDim.x) {  // two columns, two rows a store
        const int v = e >= n, f = e - v * n;
        const int lane = f >= m, u = f - lane * m;
        float2* X = v ? Vs : Hs;
        const float4 val = reinterpret_cast<const float4*>(X + (lane ? src_r : src_l) * n)[u];
        send4(smem_addr(reinterpret_cast<float4*>(X + (lane ? dst_r : dst_l) * n) + u), val, bar_n,
              lane ? to_r : to_l);
      }
    }
    // then the entries of the CTA's 2P columns for round r+1, into every CTA
    for (int e = tid; e < 2 * P * C; e += blockDim.x) {
      const int t = e >> lc, c = e & (C - 1);
      const int j = t < P ? s0 + t : m + s0 + t - P;
      const int x = index_at(j, rr, m);
      send4(smem_addr(ent + (par ^ 1) * n + x), res_entry(Hs + slot_of(t) * n, x, next_position(j, m), rn, m), bar_n,
            c);
    }
    // the log's rounds up to r are written (B, before the vote barrier):
    // every `stage` rounds, tell a V kernel that follows
    if (progress != nullptr && tid == 0 && (r + 1) % stage == 0) publish(progress + mat * C + k, r + 1);
    rr = rn;
    left.step();
    right.step();
    up.step();
    down.step();
  }

  // w from the diagonal at the last round's positions (its move is not made)
  for (int t = tid; t < 2 * P; t += blockDim.x) {
    const int j = t < P ? s0 + t : m + s0 + t - P;
    const int x = index_at(j, rr, m);
    w[(size_t)mat * n + x] = Hs[slot_of(t) * n + x].x;
  }
  if constexpr (kV) {  // V's columns by index
    for (int e = tid; e < 2 * P * n; e += blockDim.x) {
      const int t = e / n, row = e - t * n;
      const int x = index_at(t < P ? s0 + t : m + s0 + t - P, rr, m);
      vt[((size_t)mat * n + x) * n + row] = Vs[slot_of(t) * n + row];
    }
  }
  if (progress != nullptr && tid == 0) publish(progress + mat * C + k, rounds);
  if (taken_out != nullptr && taken_here) atomicAdd(taken_out, taken_here);
  cluster.sync();
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

// The exchange entry of column x, standing at position j in the round whose
// cycle step is rr: (H[x][x], and right of its pair Re, Im of H[p][x] with
// p the left column).
__device__ __forceinline__ float4 l2_entry(const float2* H, int x, int j, int rr, int n, int m) {
  float4 e = make_float4(__ldcg(H + (size_t)x * n + x).x, 0.0f, 0.0f, 0.0f);
  if (j >= m) {
    const float2 g = __ldcg(H + (size_t)x * n + index_at(j - m, rr, m));
    e.y = g.x;
    e.z = g.y;
  }
  return e;
}

__host__ __device__ constexpr size_t l2_smem_bytes(int n) { return (size_t)16 * (n / 2) + (size_t)4 * n; }

__global__ void __launch_bounds__(kL2Threads, 1)
jacobi_eigh_l2_kernel(float2* __restrict__ hc, float4* __restrict__ log, float4* __restrict__ xbuf,
                      unsigned long long* __restrict__ taken_out, int batch, int n, int round0, int rounds,
                      float eps, int relative) {
  extern __shared__ float4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const int cid = blockIdx.x / C, W = gridDim.x / C;  // this cluster, the clusters at once
  const int m = n / 2, tid = threadIdx.x, rr0 = round0 % (n - 1);
  const int s0 = k * m / C, P = (k + 1) * m / C - s0;  // the CTA's pair positions
  float4* rot = smem;                             // [m] (c, Re s, Im s, taken)
  int* pos = reinterpret_cast<int*>(rot + m);     // [n] the index at each position
  float4* xb = xbuf + (size_t)cid * 2 * n;        // [2][n] by round parity
  unsigned long long taken_here = 0;  // CTA 0's count of the rotations taken
  for (int mat = cid; mat < batch; mat += W) {
    float2* H = hc + (size_t)mat * n * n;
    float4* lg = log + (size_t)mat * rounds * m;
    // the first round's entries of the CTA's columns, from H as it stands
    // (the input, or where an earlier launch's rounds left it: the same
    // values as that launch's step C would have written)
    for (int t = tid; t < 2 * P; t += blockDim.x) {
      const int j = t < P ? s0 + t : m + s0 + t - P;
      xb[index_at(j, rr0, m)] = l2_entry(H, index_at(j, rr0, m), j, rr0, n, m);
    }
    cluster_barrier();
    int rr = rr0;  // round mod (n-1)
    for (int r = 0; r < rounds; ++r) {
      const int rn = rr + 1 == n - 1 ? 0 : rr + 1;
      // A. every rotation, the same in every CTA; the CTA's pairs' into the log
      const float4* xr = xb + (r & 1) * n;
      int live = 0;
      for (int i = tid; i < m; i += blockDim.x) {
        const int p = index_at(i, rr, m), q = index_at(m + i, rr, m);
        const float4 ep = __ldcg(xr + p), eq = __ldcg(xr + q);
        float4 qv = make_float4(1.0f, 0.0f, 0.0f, 0.0f);
        const bool taken = rot_params(ep.x, eq.x, eq.y, eq.z, eps, relative != 0, qv.x, qv.y, qv.z);
        qv.w = taken ? 1.0f : 0.0f;
        rot[i] = qv;
        live |= taken;
        taken_here += k == 0 && taken;
        if (i >= s0 && i < s0 + P) lg[(size_t)r * m + i] = log_entry(qv, p, q);
      }
      for (int j = tid; j < n; j += blockDim.x) pos[j] = index_at(j, rr, m);
      const int any = __syncthreads_or(live);
      // B. the blocks (row pair i, the CTA's column pair j), rows first, then
      // columns
      if (any) {
        for (int e = tid; e < P * m; e += blockDim.x) {
          const int j = e / m, i = e - j * m;
          const float4 qi = rot[i], qj = rot[s0 + j];
          if (qi.w == 0.0f && qj.w == 0.0f) continue;
          float2* L = H + (size_t)pos[s0 + j] * n;
          float2* R = H + (size_t)pos[m + s0 + j] * n;
          const int p = pos[i], q = pos[m + i];
          float2 h0 = __ldcg(L + p), h1 = __ldcg(R + p), h2 = __ldcg(L + q), h3 = __ldcg(R + q);
          if (qi.w != 0.0f) {
            rowmix(h0, h2, qi);
            rowmix(h1, h3, qi);
          }
          if (qj.w != 0.0f) {
            colmix(h0, h1, qj);
            colmix(h2, h3, qj);
          }
          L[p] = h0;
          R[p] = h1;
          L[q] = h2;
          R[q] = h3;
        }
        __syncthreads();
      }
      // C. the next round's entries of the CTA's columns, then the barrier
      float4* xn = xb + ((r + 1) & 1) * n;
      for (int t = tid; t < 2 * P; t += blockDim.x) {
        const int j = t < P ? s0 + t : m + s0 + t - P;
        xn[pos[j]] = l2_entry(H, pos[j], next_position(j, m), rn, n, m);
      }
      cluster_barrier();
      rr = rn;
    }
  }
  if (taken_out != nullptr && taken_here) atomicAdd(taken_out, taken_here);
}

// A launch of `clusters` clusters of `cluster` CTAs of `threads` threads.
cudaLaunchConfig_t cluster_launch_config(int clusters, int cluster, int threads, size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * clusters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kV>
cudaError_t res_attributes(int n, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(jacobi_eigh_res_kernel<kV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)res_smem_bytes(n, cluster, kV));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(jacobi_eigh_res_kernel<kV>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t res_launch_config(int batch, int n, int cluster, bool v, cudaStream_t stream,
                                     cudaLaunchAttribute* attr) {
  return cluster_launch_config(batch, cluster, kResThreads, res_smem_bytes(n, cluster, v), stream, attr);
}

// 128 < n (V in the rings: n <= kRingN), two pairs a CTA at least, C a power of two
bool res_ok(int n, int cluster, bool v) {
  return n > kMaxN && n % 2 == 0 && n / 2 <= 0x7fff && (!v || n <= kRingN) &&
         (cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16) && (n / 2) / cluster >= 2 &&
         res_smem_bytes(n, cluster, v) <= 232448;
}

template <bool kV>
int res_clusters(int n, int cluster, int* active) {
  if (!res_ok(n, cluster, kV)) return (int)cudaErrorInvalidValue;
  cudaError_t err = res_attributes<kV>(n, cluster);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = res_launch_config(1, n, cluster, kV, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(active, (const void*)jacobi_eigh_res_kernel<kV>, &cfg);
}

cudaError_t l2_attributes(int n) {
  cudaError_t err = cudaFuncSetAttribute(jacobi_eigh_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)l2_smem_bytes(n));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(jacobi_eigh_l2_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t l2_launch_config(int clusters, int n, int cluster, cudaStream_t stream,
                                    cudaLaunchAttribute* attr) {
  return cluster_launch_config(clusters, cluster, kL2Threads, l2_smem_bytes(n), stream, attr);
}

bool l2_ok(int n, int cluster) {
  return n >= 4 && n % 2 == 0 && n / 2 <= 0x7fff && (cluster == 8 || cluster == 16) &&
         l2_smem_bytes(n) <= 232448;
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

// The most clusters of `cluster` CTAs the card holds at once for the
// resident variant at size n (cudaOccupancyMaxActiveClusters), into *active.
extern "C" int tnqs_jacobi_eigh_res_clusters(int n, int cluster, int* active) {
  return res_clusters<false>(n, cluster, active);
}

// The resident variant, 128 < n, one cluster of `cluster` CTAs a matrix:
// h_in [batch, n, n] hermitian complex64 (row-major), w_out [batch, n] (the
// final diagonal, unsorted), log [batch][rounds][n/2] float4 (the rotations,
// for `tnqs_rotation_log`); `relative` != 0 takes the scale-relative skip.
// The rotations taken (not skipped) are added to *taken unless it is null.
// Unless null, started [batch] and progress [batch][cluster] (zero) tell a
// V kernel that follows the log: a matrix's cluster runs; the rounds each
// CTA has logged, every `stage` rounds and at the end.
extern "C" int tnqs_jacobi_eigh_res(const void* h_in, void* log, void* w_out, void* taken, void* started,
                                    void* progress, int stage, int batch, int n, int rounds, float eps, int relative,
                                    int cluster, void* stream) {
  if (batch <= 0 || rounds < 0 || stage < 1 || !res_ok(n, cluster, false)) return (int)cudaErrorInvalidValue;
  cudaError_t err = res_attributes<false>(n, cluster);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = res_launch_config(batch, n, cluster, false, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, jacobi_eigh_res_kernel<false>, (const float2*)h_in, (float4*)log, (float2*)nullptr,
                           (float*)w_out, (unsigned long long*)taken, (int*)started, (int*)progress, stage, n, rounds,
                           eps, relative);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The same for the resident variant with V's columns in the rings
// (128 < n <= kRingN).
extern "C" int tnqs_jacobi_eigh_res_v_clusters(int n, int cluster, int* active) {
  return res_clusters<true>(n, cluster, active);
}

// The resident variant with V in the rings: vt_out [batch, n, n] with
// vt_out[b][col][row] = V[row, col], the other arguments as
// tnqs_jacobi_eigh_res's; no log.
extern "C" int tnqs_jacobi_eigh_res_v(const void* h_in, void* vt_out, void* w_out, void* taken, int batch, int n,
                                      int rounds, float eps, int relative, int cluster, void* stream) {
  if (batch <= 0 || rounds < 0 || !res_ok(n, cluster, true)) return (int)cudaErrorInvalidValue;
  cudaError_t err = res_attributes<true>(n, cluster);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = res_launch_config(batch, n, cluster, true, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, jacobi_eigh_res_kernel<true>, (const float2*)h_in, (float4*)nullptr,
                           (float2*)vt_out, (float*)w_out, (unsigned long long*)taken, (int*)nullptr, (int*)nullptr, 1,
                           n, rounds, eps, relative);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The most clusters of `cluster` CTAs the card holds at once for the L2
// variant at size n (cudaOccupancyMaxActiveClusters), into *active.
extern "C" int tnqs_jacobi_eigh_l2_clusters(int n, int cluster, int* active) {
  if (!l2_ok(n, cluster)) return (int)cudaErrorInvalidValue;
  cudaError_t err = l2_attributes(n);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = l2_launch_config(1, n, cluster, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(active, (const void*)jacobi_eigh_l2_kernel, &cfg);
}

// The L2 variant, n > 256, in place: hc [batch, n, n] with hc[b][col][row] =
// H[row, col] (hermitian) ends holding the rotated H, whose diagonal is the
// eigenvalues; log [batch][rounds][n/2] float4 the rotations (for
// `tnqs_rotation_log`).  The launch runs rounds [round0, round0 + rounds) of
// the schedule: a run split into launches at any rounds gives the bits of
// one launch, each launch's log holding its own rounds.  `clusters` clusters of `cluster` CTAs run at once,
// each taking matrices clusters apart; xbuf is their exchange buffers,
// [clusters][2][n] float4.  The rotations taken (not skipped) are added to
// *taken unless it is null.
extern "C" int tnqs_jacobi_eigh_l2(void* hc, void* log, void* xbuf, void* taken, int batch, int n, int round0,
                                   int rounds, float eps, int relative, int cluster, int clusters, void* stream) {
  if (batch <= 0 || round0 < 0 || rounds < 0 || clusters <= 0 || !l2_ok(n, cluster))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = l2_attributes(n);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = l2_launch_config(clusters, n, cluster, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, jacobi_eigh_l2_kernel, (float2*)hc, (float4*)log, (float4*)xbuf,
                           (unsigned long long*)taken, batch, n, round0, rounds, eps, relative);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
