// Batched one-sided (Hestenes) Jacobi SVD on a warm-started iterate, one
// thread-block cluster per matrix with the iterate resident in shared memory:
// up to n = 128 A and V (the cluster kernel); past it A alone (the resident
// variant), and V from the rounds' rotation log (`rotation_log.cu`); past
// the rows a cluster holds, the L2 variant at the end.
//
// Replaces the Pallas kernel of `tnqs/ops/osj.py::osj_svd` (kernel body
// `_make_osj_kernel`, tnqs/ops/osj.py:141; rotation `_rot_params_rel`,
// :117).  It computes the same thing: sweeps*(n-1) rounds of the
// round-robin tournament over the n columns of A [R, n] (R >= n, n even),
// each rotating the n/2 disjoint column pairs (position i, position m+i)
// from the RIGHT, with a = |l|^2, b = |r|^2, g = l^H r recomputed fresh
// every round and the relative Hestenes skip |g|^2 <= eps^2 a b.  The same
// rotations accumulate into V.  Column norms, the sort, U = A/s and the
// Frobenius prescale stay in PyTorch (tnqs_torch/ops/osj.py).
//
// The cluster kernel, n <= 128: one cluster of C CTAs per matrix (C in
// {1, 2, 4, 8}, picked by the wrapper, `osj_plan`/`osj_cluster` in
// tnqs_torch/ops/osj.py).  n is even, 4 <= n <= 128.  The rows
// of A and of V are cut into 32-row chunks; CTA c holds chunks
// [c*cpc, (c+1)*cpc) of A and [c*vpc, (c+1)*vpc) of V in its shared memory
// for all rounds, column-major with an odd pitch, so that lanes over rows
// (and the transposing load and store) are free of bank conflicts.  Columns
// never move; the pairing of round r has a closed form (`index_at`), so
// there is no permutation array.  A round:
//   1. each warp forms the partial (a, b, Re g, Im g) of 8 pairs over one
//      chunk (lane = row), folds the 32 values across the warp, 31 shuffles
//      in all, lane L ending with the chunk's sum of value L, and sends it
//      into every CTA of the cluster (distributed shared memory) with
//      `st.async`, which counts its bytes against that CTA's mbarrier for
//      the round;
//   2. each of m (<= 64) threads waits on its own CTA's mbarrier for every
//      chunk's partials (no cluster-wide barrier), then sums one pair's four
//      values over all chunks in chunk order, from its own shared memory.  The sum
//      does not depend on C or on which CTA forms it, so every CTA takes
//      bitwise the same rotation and skip, and the result is the same for
//      every C; the rotations go to shared memory, with a table of the next
//      round's index at each position; block barrier;
//   3. each warp rotates 8 pairs over one chunk of A or of V, reading only
//      the pairs that rotate, all loads before any store; block barrier.
// The partials and their mbarriers are double-buffered by round parity: a
// CTA sends round r+2's into a peer only after it has received the peer's
// round r+1 partials, which the peer sends after it has summed round r's,
// so a buffer is never overwritten while it is read.  Every CTA waits for
// everything sent to it, so none leaves while a peer still writes to it.
//
// What bounds it on Hopper: the latency of the dependent rounds (508-762 at
// n = 128; a DSMEM exchange, a rotation and two block barriers each) and
// one SM's issue rate for a CTA's rows, not FLOPs or bytes; the iterate
// never leaves shared memory between its one load and its one store.  256
// threads of at most 128 registers let two CTAs share an SM, so the card
// holds twice the clusters: 30 of 8 at [R, 128] = [256, 128], where a batch
// of 26 takes one wave.  Past n = 128 V beside A would put a CTA past half
// an SM's shared memory on clusters up to 16 ([512, 256] took four waves
// of 16), so wider A takes the resident variant below, A alone.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // rows of a chunk: one warp, lane = row
constexpr int kGroup = 8;   // pairs of a warp's task: 8 x 4 values = 32 lanes
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 128;  // the cluster kernel's widest A; past it the resident variant

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

// Index that stands at position j after r rounds (0 <= r < n-1) of the
// round-robin of `pcol` with position 0 fixed (`round_robin`,
// tnqs_torch/ops/jacobi.py).  The other n-1 positions form one cycle,
// m -> 1 -> 2 -> ... -> m-1 -> n-1 -> n-2 -> ... -> m+1 -> m, along which
// every entry moves one step a round; k is the cycle step of position j.
__device__ __forceinline__ int index_at(int j, int r, int m) {
  if (j == 0) return 0;
  int k = (j < m ? j : j == m ? 0 : 3 * m - 1 - j) - r;
  if (k < 0) k += 2 * m - 1;
  return k == 0 ? m : k < m ? k : 3 * m - 1 - k;
}

// One step of the warp's transposing reduction: lanes with bit OFF set keep
// the upper half of their OFF*2 values, the others the lower half, and each
// adds its partner's copy of the half it keeps.
template <int OFF>
__device__ __forceinline__ void fold(float (&v)[32], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int j = 0; j < OFF; ++j) {
    const float send = up ? v[j] : v[j + OFF];
    const float keep = up ? v[j + OFF] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// `v` into CTA `rank`'s shared memory at this CTA's address `addr`, counted
// as 4 bytes against the transaction count of the mbarrier there at `bar`.
__device__ __forceinline__ void send(unsigned addr, float v, unsigned bar, unsigned rank) {
  unsigned raddr, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(raddr) : "r"(addr), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rbar) : "r"(bar), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(raddr), "r"(__float_as_uint(v)), "r"(rbar) : "memory");
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

// [l', r'] = [l, r] @ [[c, -conj(s)], [s, c]] on one row.
__device__ __forceinline__ void colmix(float2& l, float2& r, float c, float sr, float si) {
  const float2 x = l, y = r;
  l = make_float2(x.x * c + (y.x * sr - y.y * si), x.y * c + (y.x * si + y.y * sr));
  r = make_float2(-(x.x * sr + x.y * si) + y.x * c, -(x.y * sr - x.x * si) + y.y * c);
}

constexpr size_t smem_bytes(int rows, int n, int cpc, int vpc) {
  // A [n][cpc*32+1] and V [n][vpc*32+1] complex64, every chunk's partials
  // [2][nch][groups][32] float, the rotations [m] float4, the index at each
  // position [2][n] int, two mbarriers (tnqs_torch/ops/osj.py `osj_plan`
  // states the same sum)
  return (size_t)8 * n * (cpc * kChunk + 1 + vpc * kChunk + 1) +
         (size_t)8 * ((rows + kChunk - 1) / kChunk) * ((n / 2 + kGroup - 1) / kGroup) * 32 +
         (size_t)16 * (n / 2) + (size_t)8 * n + 16;
}

__global__ void __launch_bounds__(kThreads, 2)
osj_svd_kernel(const float2* __restrict__ a_in, const float2* __restrict__ v_in,
               float2* __restrict__ a_out, float2* __restrict__ v_out, int rows,
               int n, int rounds, int cpc, int vpc, float eps) {
  extern __shared__ float4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int mat = blockIdx.x / C;
  const int m = n / 2;
  const int groups = (m + kGroup - 1) / kGroup;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int lda = cpc * kChunk + 1, ldv = vpc * kChunk + 1;
  const int nch = (rows + kChunk - 1) / kChunk;  // chunks that hold rows of A
  const int a0 = rank * cpc, v0 = rank * vpc;    // this CTA's first chunks
  const int ach = max(0, min(cpc, nch - a0));    // its chunks of A, of V
  const int vch = max(0, min(vpc, (n + kChunk - 1) / kChunk - v0));
  const int pstride = nch * groups * 32;  // floats of one round's partials
  float2* As = reinterpret_cast<float2*>(smem);                  // [n][lda]
  float2* Vs = As + (size_t)n * lda;                             // [n][ldv]
  float* part = reinterpret_cast<float*>(Vs + (size_t)n * ldv);  // [2][nch][groups][32]
  float4* rot = reinterpret_cast<float4*>(part + 2 * pstride);   // [m] (c, Re s, Im s, taken)
  int* tab = reinterpret_cast<int*>(rot + m);                     // [2][n], by round parity
  // [2], by round parity: a round's partials from every CTA have arrived
  unsigned long long* full = reinterpret_cast<unsigned long long*>(tab + 2 * n);

  const float2* ab = a_in + (size_t)mat * rows * n;
  const float2* vb = v_in + (size_t)mat * n * n;
  for (int t = threadIdx.x; t < cpc * kChunk * n; t += blockDim.x) {
    const int r = t / n, col = t - r * n, g = a0 * kChunk + r;
    As[col * lda + r] = g < rows ? ab[(size_t)g * n + col] : make_float2(0.0f, 0.0f);
  }
  for (int t = threadIdx.x; t < vpc * kChunk * n; t += blockDim.x) {
    const int r = t / n, col = t - r * n, g = v0 * kChunk + r;
    Vs[col * ldv + r] = g < n ? vb[(size_t)g * n + col] : make_float2(0.0f, 0.0f);
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) tab[j] = index_at(j, 0, m);
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(full + b)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA of the cluster is running, its rows are loaded and its
  // mbarriers are set
  cluster.sync();
  const unsigned round_bytes = 4u * nch * groups * 32;  // the partials a CTA receives a round

  int rr = 0;  // round mod (n-1)
  for (int round = 0; round < rounds; ++round) {
    float* pbuf = part + (round & 1) * pstride;
    const int* pos = tab + (round & 1) * n;  // the index at each position
    const unsigned bar = smem_addr(full + (round & 1));
    if (threadIdx.x == 0)  // this round's phase expects every chunk's partials
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(round_bytes)
                   : "memory");
    // 1. partial Gram entries of 8 pairs over one chunk, folded across the warp
    for (int task = warp; task < ach * groups; task += nwarps) {
      const int ch = task / groups, gp = task - ch * groups;
      const int row = ch * kChunk + lane;
      float v[32];
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        const int i = gp * kGroup + p;
        float2 x = make_float2(0.0f, 0.0f), y = x;
        if (i < m) {
          x = As[pos[i] * lda + row];
          y = As[pos[m + i] * lda + row];
        }
        v[4 * p] = x.x * x.x + x.y * x.y;
        v[4 * p + 1] = y.x * y.x + y.y * y.y;
        v[4 * p + 2] = x.x * y.x + x.y * y.y;
        v[4 * p + 3] = x.x * y.y - x.y * y.x;
      }
      fold<16>(v, lane);
      fold<8>(v, lane);
      fold<4>(v, lane);
      fold<2>(v, lane);
      fold<1>(v, lane);
      // into every CTA of the cluster, this one included: [chunk][gp][lane]
      const unsigned dst = smem_addr(pbuf + ((a0 + ch) * groups + gp) * 32 + lane);
      for (int c = 0; c < C; ++c) send(dst, v[0], bar, c);
    }

    // 2. pair t's (a, b, Re g, Im g) summed over all chunks in chunk order,
    // and its rotation; meanwhile threads m .. kThreads-1 write the next
    // round's index at each position
    const int t = threadIdx.x;
    if (t < m) {
      wait_phase(bar, (round >> 1) & 1);
      const float4* pv = reinterpret_cast<const float4*>(pbuf) + t;
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int k = 0; k < nch; ++k) {
        const float4 val = pv[k * groups * 8];
        sum.x += val.x;
        sum.y += val.y;
        sum.z += val.z;
        sum.w += val.w;
      }
      float c = 1.0f, sr = 0.0f, si = 0.0f;
      const bool live = rot_params_rel(sum.x, sum.y, sum.z, sum.w, eps, c, sr, si);
      rot[t] = make_float4(c, sr, si, live ? 1.0f : 0.0f);
    } else {
      for (int j = t - m; j < n; j += kThreads - m)
        tab[((round + 1) & 1) * n + j] = index_at(j, rr + 1 == n - 1 ? 0 : rr + 1, m);
    }
    __syncthreads();

    // 3. rotate 8 pairs over one chunk of A (the first ach*groups tasks) or V
    for (int task = warp; task < (ach + vch) * groups; task += nwarps) {
      const int ch = task / groups, gp = task - ch * groups;
      const bool in_a = ch < ach;
      float2* X = in_a ? As : Vs;
      const int ld = in_a ? lda : ldv;
      const int row = (in_a ? ch : ch - ach) * kChunk + lane;
      // all 8 pairs at once: every load before any store (the pairs'
      // columns are disjoint), so the loads overlap
      int lo[kGroup], ro[kGroup];
      float4 q[kGroup];
      float2 x[kGroup], y[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int i = gp * kGroup + u, ic = min(i, m - 1);
        q[u] = rot[ic];
        if (i >= m) q[u].w = 0.0f;
        lo[u] = pos[ic] * ld + row;
        ro[u] = pos[m + ic] * ld + row;
        if (q[u].w != 0.0f) {  // a pair that does not rotate is not read
          x[u] = X[lo[u]];
          y[u] = X[ro[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (q[u].w == 0.0f) continue;
        colmix(x[u], y[u], q[u].x, q[u].y, q[u].z);
        X[lo[u]] = x[u];
        X[ro[u]] = y[u];
      }
    }
    __syncthreads();
    if (++rr == n - 1) rr = 0;
  }

  float2* ao = a_out + (size_t)mat * rows * n;
  float2* vo = v_out + (size_t)mat * n * n;
  for (int t = threadIdx.x; t < ach * kChunk * n; t += blockDim.x) {
    const int r = t / n, col = t - r * n, g = a0 * kChunk + r;
    if (g < rows) ao[(size_t)g * n + col] = As[col * lda + r];
  }
  for (int t = threadIdx.x; t < vch * kChunk * n; t += blockDim.x) {
    const int r = t / n, col = t - r * n, g = v0 * kChunk + r;
    if (g < n) vo[(size_t)g * n + col] = Vs[col * ldv + r];
  }
}

cudaLaunchConfig_t launch_config(int batch, int cluster, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(kThreads);
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

cudaError_t set_attributes(int smem) {
  return cudaFuncSetAttribute(osj_svd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// ---------------------------------------------------------------------------
// Past the cluster kernel (n > 128, or rows past what its clusters hold with
// V beside A).  V no longer takes part in the rounds: each round's m
// rotations go to a rotation log in device memory ([batch][rounds][m]
// float4: c, Re s, Im s and meta = p << 16 | q << 1 | taken, p and q the
// pair's columns), and `rotation_log.cu` applies the log to the warm start
// V0, by slabs of rows, with the same `colmix` in the same order: after the
// rounds, or beside them on the SMs their clusters leave idle where the
// batch takes one wave.  The rounds touch A alone.
//
// The resident variant, where A's chunks fit a cluster of 2, 4, 8 or 16
// CTAs (`osj_res_sizes`, `osj_log_plan` in tnqs_torch/ops/osj.py: the size
// whose clusters take the batch in the fewest waves, the larger on a tie).
// For 128 < n <= 256 that is the chi = 96 and 128 thetas: [26, 384, 192]
// on 4 CTAs (three chunks a CTA, 156,704 bytes), [26, 512, 256] on 8 (two,
// 143,392 bytes, two waves on the H100), [18, 192, 192] and
// [18, 256, 256] on 4, one wave each; past n = 256 [512, 512] (one chunk a
// CTA on 16, 135,168 bytes), [640, 320] (one or two).  CTA k holds the
// 32-row chunks [k nch / C, (k+1) nch / C) of A in shared memory for all
// rounds, column-major with an odd pitch, as the kernel above; columns
// never move (`index_at`).  CTA k owns the pairs [k m / C, (k+1) m / C).
// A round r:
//   1. each warp takes groups of 8 pairs and sums their (a, b, Re g, Im g)
//      over the CTA's chunks, chunk by chunk in order (lane = row, the warp
//      fold), and sends each of the CTA's partials to the pair's owner with
//      `st.async` against the owner's mbarrier for round r's partials;
//   2. each owner thread waits for its pair's C partials and sums them in
//      CTA order, so the rotation and skip (|g|^2 <= eps^2 a b) are the L2
//      variant's bitwise at the same C; it sends the rotation into every CTA
//      (16 bytes by `st.async`) against that CTA's mbarrier for round r's
//      rotations, and writes it to the log; the other threads write the
//      next round's index at each position;
//   3. every thread waits for the m rotations; each warp rotates 8 pairs
//      over one of the CTA's chunks of A, reading only the pairs that
//      rotate; block barrier.
// Two hand-overs a round, of 16 C P and 16 m bytes into a CTA.  One
// hand-over (every chunk's partials into every CTA, as the kernel above)
// also fits clusters of 2-8 and would give every C the same bits; built as
// a mode of the cluster kernel and, with chunk-order sums, of this one, it
// took 4-5% longer a call at [26, 384, 192] and [26, 512, 256] (PERF.md
// §6): a CTA folds and sends each chunk's partials, and an owner sums nch
// of them, where here a CTA sends one partial a pair and an owner sums C.
// Why no buffer is overwritten while it is read: the partials, the
// rotations and their mbarriers are double-buffered by round parity.  A CTA
// sends its round r+2 partials to an owner only after it received the
// owner's round r+1 rotations, which the owner's threads send after their
// sums of round r+1, which follow their sums of round r; and an owner sends
// round r+2's rotations into a CTA only after it received that CTA's round
// r+2 partials, which the CTA sends after the block barrier that ends its
// round r+1, which follows its reads of round r's rotations.  A byte of
// round r+2 reaches an mbarrier only after its round r phase completed, by
// the same chains, and one that lands before thread 0 posts the phase's
// expected count leaves the count below zero, which the phase allows.
// Every CTA waits for all that was sent to it, so none leaves while a peer
// still writes to it.  Every `stage` rounds (and at the end) a thread that
// step 2 does not hold publishes how many rounds the CTA has logged
// (`publish`), for a V kernel that follows the log (`rotation_log.cu`).
//
// What bounds it: the latency of the dependent rounds (two DSMEM
// hand-overs and two block barriers each) and one SM's issue rate for the
// Gram's products and folds and the rotations of its chunks, not bytes: A
// is read from device memory once and written once.  A round's time grows
// with a CTA's chunks (the Gram's folds and the rotations), so the smallest
// cluster that holds A is the slowest a round, and the card holds the most
// of them: the plan trades the two by waves.  One CTA of 512 threads an SM.
//
// Past that ([1024, 512]: two chunks of 512 columns a CTA, 266,240 bytes)
// the L2 variant: the wrapper lays A out column-major, x[col][row] with rows
// [0, 32 nch) (zero past R), and the kernel rotates it in place in device
// memory, kept hot in L2 (the wrapper runs only as many matrices at once as
// keep their iterates within ~40 MB of it, `osj_l2_plan`), each cluster
// taking the next matrix when it is done.  One cluster of C CTAs (16,
// non-portable, where the card holds one, else 8) per matrix; CTA k owns
// the A chunks [k nch / C, (k+1) nch / C), and only it reads or writes them,
// so the iterate needs no exchange.  A round:
//   1. each warp takes groups of 8 pairs and sums their (a, b, Re g, Im g)
//      over the CTA's chunks of A, chunk by chunk in order, and writes the
//      CTA's partial of each pair into the cluster's exchange buffer in
//      device memory;
//   2. a cluster barrier, release then acquire;
//   3. every CTA sums each pair's C partials in CTA order (`ld.global.cg`:
//      other SMs wrote them), so every CTA takes bitwise the same rotation
//      and skip, writes its own pairs' rotations to the log and the next
//      round's index at each position; block barrier;
//   4. each warp rotates 8 pairs over one of the CTA's chunks, reading only
//      the pairs that rotate; block barrier.
// The exchange buffer is double-buffered by the parity of a round count that
// runs on across the cluster's matrices: a CTA writes round t+2's partials
// into round t's half only after round t+1's barrier, which every CTA
// reaches after its sums of round t.  The result is bitwise the same on
// every run; it depends on C (the order of the partial sums).  What bounds
// it: the bytes each round moves through L2 (the Gram reads A, the rotation
// reads and writes A where a pair rotates: up to 24 n R bytes a matrix a
// round) and the latency of the dependent rounds.

constexpr int kResThreads = 512;
constexpr int kL2Threads = 512;

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

__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

// The log's entry of pair (p, q): the rotation and its meta bits.
__device__ __forceinline__ float4 log_entry(float c, float sr, float si, bool taken, int p, int q) {
  return make_float4(c, sr, si, __int_as_float(p << 16 | q << 1 | (int)taken));
}

// The CTA's partial (a, b, Re g, Im g) of the 8 pairs of group gp over its
// `ach` chunks of X (column-major, pitch ld, the chunks from row row0), the
// chunks in order: lane L ends with value L % 4 of pair 8 gp + L / 4.
__device__ __forceinline__ float group_partial(const float2* X, size_t ld, int row0, int ach, const int* pos, int gp,
                                               int m, int lane) {
  float acc = 0.0f;
  for (int ch = 0; ch < ach; ++ch) {
    const int row = row0 + ch * kChunk + lane;
    float v[32];
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      const int i = gp * kGroup + p;
      float2 a = make_float2(0.0f, 0.0f), b = a;
      if (i < m) {
        a = X[(size_t)pos[i] * ld + row];
        b = X[(size_t)pos[m + i] * ld + row];
      }
      v[4 * p] = a.x * a.x + a.y * a.y;
      v[4 * p + 1] = b.x * b.x + b.y * b.y;
      v[4 * p + 2] = a.x * b.x + a.y * b.y;
      v[4 * p + 3] = a.x * b.y - a.y * b.x;
    }
    fold<16>(v, lane);
    fold<8>(v, lane);
    fold<4>(v, lane);
    fold<2>(v, lane);
    fold<1>(v, lane);
    acc += v[0];
  }
  return acc;
}

// Rotate 8 pairs (group gp) over one chunk of X (column-major, pitch ld) at
// `row`, reading only the pairs that rotate, every load before any store.
__device__ __forceinline__ void rotate_group(float2* X, size_t ld, int row, const float4* rot, const int* pos, int gp,
                                             int m) {
  size_t lo[kGroup], ro[kGroup];
  float4 q[kGroup];
  float2 a[kGroup], b[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int i = gp * kGroup + u, ic = min(i, m - 1);
    q[u] = rot[ic];
    if (i >= m) q[u].w = 0.0f;
    lo[u] = (size_t)pos[ic] * ld + row;
    ro[u] = (size_t)pos[m + ic] * ld + row;
    if (q[u].w != 0.0f) {
      a[u] = X[lo[u]];
      b[u] = X[ro[u]];
    }
  }
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    if (q[u].w == 0.0f) continue;
    colmix(a[u], b[u], q[u].x, q[u].y, q[u].z);
    X[lo[u]] = a[u];
    X[ro[u]] = b[u];
  }
}

__host__ __device__ constexpr int res_pmax(int m, int C) { return (m + C - 1) / C; }

// A [n][cpc*32+1] complex64, the owner's partials [2][C][pmax] float4, the
// rotations [2][m] float4, the index at each position [2][n] int, four
// mbarriers (`osj_res_smem` in tnqs_torch/ops/osj.py states the same sum)
__host__ __device__ constexpr size_t res_smem_bytes(int n, int cpc, int C) {
  return (size_t)8 * n * (cpc * kChunk + 1) + (size_t)32 * C * res_pmax(n / 2, C) + (size_t)32 * (n / 2) +
         (size_t)8 * n + 32;
}

// Where a V kernel follows this one's log as it grows (`rotation_log.cu`):
// store v at p after every write of this CTA's threads that a block barrier
// ordered before (the device-wide fence makes them visible first).
__device__ __forceinline__ void publish(int* p, int v) {
  __threadfence();
  *(volatile int*)p = v;
}

__global__ void __launch_bounds__(kResThreads, 1)
osj_svd_res_kernel(const float2* __restrict__ a_in, float2* __restrict__ a_out, float4* __restrict__ log,
                   unsigned long long* __restrict__ taken_out, int* __restrict__ started, int* __restrict__ progress,
                   int stage, int rows, int n, int nch, int cpc, int rounds, float eps) {
  extern __shared__ float4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const int mat = blockIdx.x / C;
  const int m = n / 2, groups = (m + kGroup - 1) / kGroup;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int lda = cpc * kChunk + 1, pmax = res_pmax(m, C);
  const int a0 = k * nch / C, ach = (k + 1) * nch / C - a0;  // the CTA's chunks of A
  const int s0 = k * m / C, P = (k + 1) * m / C - s0;         // the CTA's pairs
  float2* As = reinterpret_cast<float2*>(smem);                                         // [n][lda]
  float4* part = reinterpret_cast<float4*>(As + (size_t)n * lda);                      // [2][C][pmax]
  float4* rot = part + 2 * C * pmax;                                                   // [2][m]
  int* tab = reinterpret_cast<int*>(rot + 2 * m);                                      // [2][n]
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(tab + 2 * n);       // [4]
  float4* lg = log + (size_t)mat * rounds * m;

  const float2* ab = a_in + (size_t)mat * rows * n;
  for (int t = threadIdx.x; t < ach * kChunk * n; t += blockDim.x) {
    const int r = t / n, col = t - r * n, g = a0 * kChunk + r;
    As[col * lda + r] = g < rows ? ab[(size_t)g * n + col] : make_float2(0.0f, 0.0f);
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) tab[j] = index_at(j, 0, m);
  if (threadIdx.x == 0) {
    for (int b = 0; b < 4; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + b)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA of the cluster is running, its rows are loaded and its
  // mbarriers are set
  cluster.sync();
  if (started != nullptr && k == 0 && threadIdx.x == 0) publish(started + mat, 1);

  unsigned long long taken_here = 0;  // the rotations of the CTA's pairs taken
  int rr = 0;                         // round mod (n-1)
  for (int r = 0; r < rounds; ++r) {
    const int par = r & 1, rn = rr + 1 == n - 1 ? 0 : rr + 1;
    const int* pos = tab + par * n;
    const unsigned bar_p = smem_addr(bars + par), bar_r = smem_addr(bars + 2 + par), ph = (r >> 1) & 1;
    if (threadIdx.x == 0) {
      expect_bytes(bar_p, 16u * C * P);  // every CTA's partial of the CTA's pairs
      expect_bytes(bar_r, 16u * m);      // every rotation
    }
    // 1. the CTA's partial of every pair, each value to the pair's owner
    for (int gp = warp; gp < groups; gp += nwarps) {
      const float acc = group_partial(As, lda, 0, ach, pos, gp, m, lane);
      const int i = gp * kGroup + lane / 4;
      if (i < m) {
        const int o = ((i + 1) * C + m - 1) / m - 1;  // i in [o m / C, (o+1) m / C)
        float* dst = reinterpret_cast<float*>(part + (par * C + k) * pmax + i - o * m / C) + (lane & 3);
        send(smem_addr(dst), acc, bar_p, o);
      }
    }
    // 2. the owners: pair s0 + t's sum over the CTAs in order, its rotation
    // into every CTA and the log; the others: the next round's positions
    if ((int)threadIdx.x < P) {
      const int t = threadIdx.x, i = s0 + t;
      wait_phase(bar_p, ph);
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int c = 0; c < C; ++c) {
        const float4 val = part[(par * C + c) * pmax + t];
        sum.x += val.x;
        sum.y += val.y;
        sum.z += val.z;
        sum.w += val.w;
      }
      float cr = 1.0f, sr = 0.0f, si = 0.0f;
      const bool live = rot_params_rel(sum.x, sum.y, sum.z, sum.w, eps, cr, sr, si);
      const float4 q = make_float4(cr, sr, si, live ? 1.0f : 0.0f);
      for (int c = 0; c < C; ++c) send4(smem_addr(rot + par * m + i), q, bar_r, c);
      lg[(size_t)r * m + i] = log_entry(cr, sr, si, live, pos[i], pos[m + i]);
      taken_here += live;
    } else {
      for (int j = threadIdx.x - P; j < n; j += blockDim.x - P) tab[(par ^ 1) * n + j] = index_at(j, rn, m);
      // the log's rounds before r are written (step 2, before the block
      // barrier that ended round r-1): every `stage` rounds, tell a V kernel
      // that follows, from a thread the round does not wait for here
      if (progress != nullptr && (int)threadIdx.x == P && r > 0 && r % stage == 0)
        publish(progress + mat * C + k, r);
    }
    // 3. every rotation; rotate 8 pairs over one of the CTA's chunks
    wait_phase(bar_r, ph);
    for (int task = warp; task < ach * groups; task += nwarps) {
      const int ch = task / groups, gp = task - ch * groups;
      rotate_group(As, lda, ch * kChunk + lane, rot + par * m, pos, gp, m);
    }
    __syncthreads();
    rr = rn;
  }

  float2* ao = a_out + (size_t)mat * rows * n;
  for (int t = threadIdx.x; t < ach * kChunk * n; t += blockDim.x) {
    const int r = t / n, col = t - r * n, g = a0 * kChunk + r;
    if (g < rows) ao[(size_t)g * n + col] = As[col * lda + r];
  }
  if (progress != nullptr && threadIdx.x == 0) publish(progress + mat * C + k, rounds);
  if (taken_out != nullptr && taken_here) atomicAdd(taken_out, taken_here);
  cluster.sync();
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

__host__ __device__ constexpr size_t l2_smem_bytes(int n) { return (size_t)16 * (n / 2) + (size_t)8 * n; }

__global__ void __launch_bounds__(kL2Threads, 1)
osj_svd_l2_kernel(float2* __restrict__ x, float4* __restrict__ log, float4* __restrict__ part,
                  unsigned long long* __restrict__ taken_out, int batch, int n, int nch, int round0, int rounds,
                  float eps) {
  extern __shared__ float4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const int cid = blockIdx.x / C, W = gridDim.x / C;  // this cluster, the clusters at once
  const int m = n / 2, groups = (m + kGroup - 1) / kGroup;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int ld = nch * kChunk;
  const int a0 = k * nch / C, ach = (k + 1) * nch / C - a0;  // the CTA's chunks of A
  const int s0 = k * m / C, P = (k + 1) * m / C - s0;         // the pairs whose rotations it logs
  float4* rot = smem;                         // [m] (c, Re s, Im s, taken)
  int* tab = reinterpret_cast<int*>(rot + m);  // [2][n] the index at each position, by round parity
  float4* pc = part + (size_t)cid * 2 * C * m;  // [2][C][m] this cluster's partials
  int t = 0;  // rounds this cluster has run, over its matrices
  unsigned long long taken_here = 0;  // CTA 0's count of the rotations taken
  for (int mat = cid; mat < batch; mat += W) {
    float2* X = x + (size_t)mat * n * ld;
    float4* lg = log + (size_t)mat * rounds * m;
    const int rr0 = round0 % (n - 1);  // the launch's first round mod (n-1)
    for (int j = threadIdx.x; j < n; j += blockDim.x) tab[(t & 1) * n + j] = index_at(j, rr0, m);
    __syncthreads();
    int rr = rr0;  // round mod (n-1)
    for (int round = 0; round < rounds; ++round, ++t) {
      const int* pos = tab + (t & 1) * n;
      float4* pr = pc + (size_t)(t & 1) * C * m;
      // 1. the CTA's partial of every pair, its chunks summed in order
      for (int gp = warp; gp < groups; gp += nwarps) {
        const float acc = group_partial(X, ld, a0 * kChunk, ach, pos, gp, m, lane);
        if (gp * kGroup + lane / 4 < m) reinterpret_cast<float*>(pr + (size_t)k * m)[gp * 32 + lane] = acc;
      }
      // 2. every CTA's partials are in
      cluster_barrier();
      // 3. pair i's sum over the CTAs in order, and its rotation; the next
      // round's index at each position
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int c = 0; c < C; ++c) {
          const float4 val = __ldcg(pr + (size_t)c * m + i);
          sum.x += val.x;
          sum.y += val.y;
          sum.z += val.z;
          sum.w += val.w;
        }
        float cr = 1.0f, sr = 0.0f, si = 0.0f;
        const bool live = rot_params_rel(sum.x, sum.y, sum.z, sum.w, eps, cr, sr, si);
        rot[i] = make_float4(cr, sr, si, live ? 1.0f : 0.0f);
        taken_here += k == 0 && live;
        if (i >= s0 && i < s0 + P) lg[(size_t)round * m + i] = log_entry(cr, sr, si, live, pos[i], pos[m + i]);
      }
      const int rn = rr + 1 == n - 1 ? 0 : rr + 1;
      for (int j = threadIdx.x; j < n; j += blockDim.x) tab[((t + 1) & 1) * n + j] = index_at(j, rn, m);
      __syncthreads();
      // 4. rotate 8 pairs over one of the CTA's chunks
      for (int task = warp; task < ach * groups; task += nwarps) {
        const int c = task / groups, gp = task - c * groups;
        rotate_group(X, ld, (a0 + c) * kChunk + lane, rot, pos, gp, m);
      }
      __syncthreads();
      rr = rn;
    }
  }
  if (taken_out != nullptr && taken_here) atomicAdd(taken_out, taken_here);
}

cudaError_t res_attributes(int smem) {
  cudaError_t err = cudaFuncSetAttribute(osj_svd_res_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(osj_svd_res_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t res_launch_config(int batch, int cluster, int smem, cudaStream_t stream,
                                     cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = launch_config(batch, cluster, smem, stream, attr);
  cfg.blockDim = dim3(kResThreads);
  return cfg;
}

bool res_ok(int n, int nch, int cpc, int cluster) {
  return n >= 4 && n % 2 == 0 && n / 2 <= 0x7fff && (cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16) &&
         cpc * cluster >= nch &&
         nch * kChunk >= n && res_smem_bytes(n, cpc, cluster) <= 232448 && n / 2 / cluster >= 1;
}

cudaError_t l2_attributes(int n) {
  cudaError_t err = cudaFuncSetAttribute(osj_svd_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)l2_smem_bytes(n));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(osj_svd_l2_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t l2_launch_config(int clusters, int cluster, int n, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = launch_config(clusters, cluster, (int)l2_smem_bytes(n), stream, attr);
  cfg.blockDim = dim3(kL2Threads);
  return cfg;
}

bool l2_ok(int n, int cluster) {
  return n >= 4 && n % 2 == 0 && n / 2 <= 0x7fff && (cluster == 8 || cluster == 16) &&
         l2_smem_bytes(n) <= 232448;
}

}  // namespace

// The most clusters of `cluster` CTAs with `smem` bytes each that the card
// holds at once (cudaOccupancyMaxActiveClusters), into *active.
extern "C" int tnqs_osj_svd_clusters(int cluster, int smem, int* active) {
  const cudaError_t err = set_attributes(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, cluster, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(active, (const void*)osj_svd_kernel, &cfg);
}

// a_in [batch, rows, n] and v_in [batch, n, n] complex64, row-major; the
// rotated iterate and accumulator go to a_out and v_out, row-major.  One
// cluster of `cluster` CTAs per matrix, each holding `cpc` chunks of 32 rows
// of A and `vpc` of V in `smem` bytes of shared memory.
extern "C" int tnqs_osj_svd(const void* a_in, const void* v_in, void* a_out, void* v_out,
                            int batch, int rows, int n, int rounds, float eps, int cluster,
                            int cpc, int vpc, int smem, void* stream) {
  if (batch <= 0 || n < 4 || n > kMaxN || n % 2 != 0 || rows < n || rounds < 0 ||
      cluster < 1 || cluster > 8 || cluster * cpc * kChunk < rows || cluster * vpc * kChunk < n ||
      (size_t)smem < smem_bytes(rows, n, cpc, vpc))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_attributes(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(batch, cluster, smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, osj_svd_kernel, (const float2*)a_in, (const float2*)v_in,
                           (float2*)a_out, (float2*)v_out, rows, n, rounds, cpc, vpc, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The most clusters of `cluster` CTAs the card holds at once for the
// resident variant at width n with `cpc` chunks of A a CTA
// (cudaOccupancyMaxActiveClusters), into *active.
extern "C" int tnqs_osj_svd_res_clusters(int n, int cpc, int cluster, int* active) {
  if (!res_ok(n, cpc * cluster, cpc, cluster)) return (int)cudaErrorInvalidValue;
  const int smem = (int)res_smem_bytes(n, cpc, cluster);
  const cudaError_t err = res_attributes(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = res_launch_config(1, cluster, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(active, (const void*)osj_svd_res_kernel, &cfg);
}

// The resident variant: a_in [batch, rows, n] complex64 row-major, the
// rotated iterate to a_out (row-major) and the rotations to log
// [batch][rounds][n/2] float4 (for `tnqs_rotation_log`).  One cluster of
// `cluster` CTAs per matrix, CTA k holding A's 32-row chunks
// [k nch / cluster, (k+1) nch / cluster), at most `cpc`, in shared memory.
// The rotations taken (not skipped) are added to *taken unless it is null.
// Unless null, started [batch] and progress [batch][cluster] (zero) tell a
// V kernel that follows the log: a matrix's cluster runs; the rounds each
// CTA has logged, every `stage` rounds and at the end.
extern "C" int tnqs_osj_svd_res(const void* a_in, void* a_out, void* log, void* taken, void* started, void* progress,
                                int stage, int batch, int rows, int n, int nch, int cpc, int rounds, float eps,
                                int cluster, void* stream) {
  if (batch <= 0 || rounds < 0 || stage < 1 || rows < n || nch * kChunk < rows || !res_ok(n, nch, cpc, cluster))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)res_smem_bytes(n, cpc, cluster);
  cudaError_t err = res_attributes(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = res_launch_config(batch, cluster, smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, osj_svd_res_kernel, (const float2*)a_in, (float2*)a_out, (float4*)log,
                           (unsigned long long*)taken, (int*)started, (int*)progress, stage, rows, n, nch, cpc,
                           rounds, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The most clusters of `cluster` CTAs the card holds at once for the L2
// variant at width n (cudaOccupancyMaxActiveClusters), into *active.
extern "C" int tnqs_osj_svd_l2_clusters(int n, int cluster, int* active) {
  if (!l2_ok(n, cluster)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = l2_attributes(n);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = l2_launch_config(1, cluster, n, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(active, (const void*)osj_svd_l2_kernel, &cfg);
}

// The L2 variant, in place on x [batch, n, 32 nch] complex64: x[b][col][row]
// holds A[row, col] (zero past A's rows); the rotations go to log
// [batch][rounds][n/2] float4 (for `tnqs_rotation_log`).  `clusters`
// clusters of `cluster` CTAs run at once, each taking matrices clusters
// apart; part is their exchange buffers, [clusters][2][cluster][n/2] float4.
// The rotations taken (not skipped) are added to *taken unless it is null.
// The launch runs rounds [round0, round0 + rounds) of the schedule: a run
// split into launches at any rounds gives the bits of one launch, each
// launch's log holding its own rounds.
extern "C" int tnqs_osj_svd_l2(void* x, void* log, void* part, void* taken, int batch, int n, int nch, int round0,
                               int rounds, float eps, int cluster, int clusters, void* stream) {
  if (batch <= 0 || round0 < 0 || rounds < 0 || clusters <= 0 || nch * kChunk < n || !l2_ok(n, cluster) ||
      (long long)n * nch * kChunk >= (1ll << 31))  // offsets within a matrix are int
    return (int)cudaErrorInvalidValue;
  cudaError_t err = l2_attributes(n);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = l2_launch_config(clusters, cluster, n, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, osj_svd_l2_kernel, (float2*)x, (float4*)log, (float4*)part,
                           (unsigned long long*)taken, batch, n, nch, round0, rounds, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
