// V from a log of Jacobi rotations: the accumulated rotation product of K1
// (`osj_svd.cu`) and K2 (`jacobi_eigh.cu`) past the widths their clusters
// hold, moved out of their rounds.
//
// Replaces the V accumulation inside the Pallas kernels of
// `tnqs/ops/jacobi.py::jacobi_eigh` (`pallas_call` :279, V's columns rotated
// with H's) and `tnqs/ops/osj.py::osj_svd` (`pallas_call` :306, V's rows
// rotated with A's).  The next rotation reads only H (K2) or A (K1), so V
// need not be rotated in the round that forms the rotation: the iterate
// kernels append each round's m rotations to a log in device memory,
// [batch][rounds][m] float4 (c, Re s, Im s, meta), meta's bits holding the
// pair's two column indices and whether the rotation is taken
// (p << 16 | q << 1 | taken), and these kernels apply the log to V
// afterwards, with the same `colmix` in the same order, so every element of
// V sees the same arithmetic as when V was rotated in the rounds.  Column
// rotations never mix rows, so rows never exchange anything.
//
// Two layouts, by width (`ops.rotation_log.plan`).
//
// Registers (n <= 1024, `rotation_log_regs_kernel<P>`): a warp holds R whole
// rows of V in registers (R = 2 up to P = 4, else 1; 16 rows a CTA up to
// P = 8, 12 up to P = 12, else 7), its
// lanes the pair positions in blocks of P = ceil(m/32), top [b P, b P + P)
// and bottom m + the same, as Brent and Luk's processor array (and K2's
// resident variant, `jacobi_eigh.cu`).  A round: each lane applies its P
// entries to its P pairs of each row (an untaken pair kept by a select, no
// branch), then the entries move one step along the tournament's cycle
// (`index_at`: m -> 1 -> ... -> m-1 -> n-1 -> ... -> m+1 -> m, position 0
// fixed): inside a lane by renaming registers over P unrolled rounds (top
// logical slot s in register (s - k) mod P, bottom in (s + k) mod P, k the
// round mod P), across lanes by one shuffle up the top chain and one down
// the bottom chain, and by selects at the turn-arounds (m -> 1 in block 0,
// m-1 -> n-1 in the last block, at its own slot where P does not divide m)
// and at position 0.  Position j starts with V0's column
// index_at(j, round0) and ends with V's column index_at(j, round0 + rounds).
// One more warp loads the log into shared memory, K whole rounds a stage,
// four stages, each with a full and an empty mbarrier, by 16-byte
// `cp.async` (coalesced reads, completing on the full mbarrier): a round's
// entries go in D = gcd(P, 8) runs, run g shifted by g entries, and lane
// 8 q + l holds block g (32/D) + q (8/D) + t (l = g (8/D) + t), so the 8
// lanes of a quarter warp read their 16-byte entries from 8 different bank
// groups (a bulk copy, `cp.async.bulk`, would take D copies a round; issued
// by warp 0 instead of a loading warp, it was slower at P = 4 and 8).
// Each lane carries the
// columns at its positions (`key`: top's << 16 | bottom's << 1) and traps,
// before it writes V, if an entry's p and q were not those columns: an
// iterate whose pairing drifted from `index_at` cannot give a wrong V
// silently.  A round none of whose pairs is taken costs one vote and the
// movement.
//
// Slabs (n > 1024, `rotation_log_kernel`): one CTA per slab of S rows of one
// matrix (S = 16 where it fits), row-major in shared memory.  Each warp owns
// two rows of the slab, a half-warp each, its 16 lanes the round's pairs
// (lane l pairs l, l + 16, ...; the two halves read the same rotations),
// loaded four at a time before any store; rows never meet, so a warp passes
// from one round to the next with `__syncwarp` alone.  The log streams in by
// `cp.async.bulk`, E entries a stage, two stages against two mbarriers, one
// block barrier a stage before its buffer is refilled.  A stage is K whole
// rounds (E = K m) where they fit beside the slab, else a part of a round
// (past n = 9684, where a row of V and one round no longer fit): the lanes
// walk a stage round by round, each round's entries in order, so a round
// split over two stages sees the same operations as one held whole (its
// pairs are disjoint).
//
// Beside the iterate kernel.  Where the iterate's clusters leave SMs idle in
// its one or last wave, the wrapper launches a kernel on a second stream to
// follow the log as it grows ("follow"), and again after the iterate on its
// own stream for what is left ("rest"); the unit is a CTA's rows.  A follow
// CTA takes its unit only once the clusters of every matrix of the launch
// run (`started`, which the iterate sets once all its CTAs run); until then
// it polls for a bounded while and then leaves.  So it waits only on work
// that is running and needs nothing of this kernel, and cannot hang
// whatever the scheduler does; and no CTA of this kernel holds an SM while a
// cluster of the iterate still waits to be placed, beyond that bounded poll
// (a cluster needs its C SMs free in one GPC at once, so CTAs that stayed
// could delay it by a whole iterate).  Past one wave a gate
// (`rotation_log_gate_kernel`, one warp, ahead of the follow launch on its
// stream) returns once every cluster runs, or after a bounded while, so
// that the follow CTAs reach the SMs the last wave leaves idle; once every
// cluster runs the first waves' logs are whole.  A follow CTA issues a stage
// only when every CTA of the matrix's cluster has published (`progress`,
// after a device-wide fence) that it logged those rounds.  A unit is
// claimed by one CTA of either launch (`claim`, compare-and-swap); the rest
// launch does every unit no follow CTA took.
//
// What bounds them: the FP32 issue rate of the colmixes (12 FP32 operations
// a row of a taken pair); the slab layout also moves every pair through
// shared memory.  The log (16 m bytes a round) is read once a CTA, from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kStages = 2;
constexpr int kUnroll = 4;  // pairs a lane loads before it stores

// columns: left' = c*left + s*right, right' = -conj(s)*left + c*right (the
// `colmix` of jacobi_eigh.cu and osj_svd.cu, the same operations)
__device__ __forceinline__ void colmix(float2& left, float2& right, float4 q) {
  const float c = q.x, sr = q.y, si = q.z;
  const float2 x = left, y = right;
  left = make_float2(x.x * c + (y.x * sr - y.y * si), x.y * c + (y.x * si + y.y * sr));
  right = make_float2(-(x.x * sr + x.y * si) + y.x * c, -(x.y * sr - x.x * si) + y.y * c);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// Wait for the phase of parity `parity` of the mbarrier at `bar`; a wait far
// longer than any stage traps rather than hangs.
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1ll << 24)) __trap();
  }
}

// the log's stages [kStages][E] float4, V's slab [S][n] float2, the
// stages' mbarriers (`ops.rotation_log.plan` states the same sum)
__host__ __device__ constexpr size_t smem_bytes(int n, int S, int E) {
  return (size_t)16 * kStages * E + (size_t)8 * S * n + 8 * kStages;
}

// how a launch takes its slabs
enum Mode { kAll = 0, kFollow = 1, kRest = 2 };
constexpr int kStartSpins = 256;  // polls of `started`, ~0.1 ms, before a follow CTA leaves its slab

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Whether this CTA takes its unit (blockIdx.x of matrix blockIdx.y) in a
// follow or rest launch.  A follow CTA gives the iterate's clusters a
// bounded while to start (clusters take longer to place than CTAs), then
// leaves its unit to the rest launch: it never waits on work that may not
// run, and stays only once no cluster of the launch waits for SMs.
__device__ __forceinline__ bool takes_unit(int mode, const int* __restrict__ started, int* __restrict__ claim) {
  __shared__ int take;
  if (threadIdx.x == 0) {
    bool runs = mode == kRest;
    for (int spin = 0, b = 0; !runs && spin < kStartSpins; ++spin) {
      while (b < (int)gridDim.y && load_acquire(started + b) != 0) ++b;
      runs = b == (int)gridDim.y;
      if (!runs) __nanosleep(256);
    }
    take = runs && atomicCAS(claim + blockIdx.y * gridDim.x + blockIdx.x, 0, 1) == 0;
  }
  __syncthreads();
  return take;
}

// one half-warp a row: S / 2 warps (one for S = 1).  v_in may be v_out (V
// updated in place): a CTA reads its whole slab before it writes any of it.
__global__ void __launch_bounds__(512)
rotation_log_kernel(const float2* v_in, const float4* __restrict__ log, float2* v_out, int n, int rounds, int S,
                    int E, const int* __restrict__ started, const int* __restrict__ progress, int* __restrict__ claim,
                    int C, int mode) {
  extern __shared__ float4 smem[];
  const int m = n / 2, tid = threadIdx.x, lane = tid & 15, row = tid >> 4;
  const int mat = blockIdx.y, r0 = blockIdx.x * S, rows = min(S, n - r0);
  if (mode != kAll && !takes_unit(mode, started, claim)) return;
  float4* stage = smem;                                                                  // [kStages][E]
  float2* V = reinterpret_cast<float2*>(stage + (size_t)kStages * E);                    // [S][n]
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(V + (size_t)S * n);  // [kStages]
  const float4* lg = log + (size_t)mat * rounds * m;
  const long long total = (long long)rounds * m;  // the matrix's entries, round by round
  const int chunks = (int)((total + E - 1) / E);

  // chunk c of the log, entries [c E, c E + E), into stage c % kStages; a
  // follow launch first waits until every CTA of the cluster logged the
  // rounds they reach into
  auto issue = [&](int c) {
    const long long e0 = (long long)c * E, e1 = min(total, e0 + E);
    const int need = (int)((e1 + m - 1) / m);
    for (int k = 0; mode == kFollow && k < C; ++k)
      while (load_acquire(progress + mat * C + k) < need) __nanosleep(200);
    if (mode == kFollow) asm volatile("fence.proxy.async.global;" ::: "memory");
    const unsigned bar = smem_addr(bars + c % kStages);
    const unsigned bytes = 16u * (unsigned)(e1 - e0);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(smem_addr(stage + (size_t)(c % kStages) * E)), "l"(lg + e0), "r"(bytes), "r"(bar) : "memory");
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + s)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int c = 0; c < min(kStages, chunks); ++c) issue(c);
  }
  // the slab: rows [r0, r0 + rows) of V0 (the identity without one)
  for (int t = tid; t < rows * n; t += blockDim.x) {
    const int r = t / n, col = t - r * n;
    V[t] = v_in ? v_in[((size_t)mat * n + r0 + r) * n + col] : make_float2(r0 + r == col ? 1.0f : 0.0f, 0.0f);
  }
  __syncthreads();

  float2* X = V + (size_t)row * n;
  for (int c = 0, off = 0; c < chunks; ++c) {  // off: the stage's first entry's place in its round
    wait_phase(smem_addr(bars + c % kStages), (c / kStages) & 1);
    const int len = (int)min((long long)E, total - (long long)c * E);
    // the stage's entries round by round: [a, b) the part of one round
    for (int a = 0, b, at = off; row < rows && a < len; a = b, at = 0) {
      b = min(len, a + m - at);
      const float4* q = stage + (size_t)(c % kStages) * E + a;
      const int cnt = b - a;
      for (int i0 = lane; i0 < cnt; i0 += 16 * kUnroll) {
        float4 r[kUnroll];
        float2 x[kUnroll], y[kUnroll];
        int lo[kUnroll], hi[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + 16 * u;
          r[u] = i < cnt ? q[i] : make_float4(1.0f, 0.0f, 0.0f, 0.0f);
          const int meta = i < cnt ? __float_as_int(r[u].w) : 0;
          lo[u] = meta & 1 ? meta >> 16 : -1;
          hi[u] = meta >> 1 & 0x7fff;
          if (lo[u] >= 0) {
            x[u] = X[lo[u]];
            y[u] = X[hi[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (lo[u] < 0) continue;
          colmix(x[u], y[u], r[u]);
          X[lo[u]] = x[u];
          X[hi[u]] = y[u];
        }
      }
      __syncwarp(0xffffu << (tid & 16));  // the next round pairs other columns of the half-warp's row
    }
    __syncthreads();  // every warp is done with the stage
    if (tid == 0 && c + kStages < chunks) issue(c + kStages);
    off = (off + len) % m;
  }
  for (int t = tid; t < rows * n; t += blockDim.x) {
    const int r = t / n, col = t - r * n;
    v_out[((size_t)mat * n + r0 + r) * n + col] = V[t];
  }
}

// ---------------------------------------------------------------------------
// The register layout, n <= 1024.

constexpr int kRegStages = 4;  // stages of the log in flight

// the register layout's shared bytes a CTA: K rounds a stage, a full and an
// empty mbarrier a stage (`ops.rotation_log.reg_smem_bytes`)
__host__ __device__ constexpr size_t reg_smem_bytes(int RS, int K) {
  return (size_t)16 * kRegStages * K * RS + 16 * kRegStages;
}

// The rounds a stage (`ops.rotation_log.reg_rounds`): up to P = 8 the
// multiple of P up to 8, past it the largest divisor of P up to 8 that
// fits, so that every stage starts and ends at a round the unrolled loop
// knows.
__host__ __device__ constexpr int stage_rounds(int P, int RS) {
  if (P <= 8) return P * (8 / P);
  int K = 1;
  for (int d = 2; d <= 8; ++d)
    if (P % d == 0 && reg_smem_bytes(RS, d) <= 232448) K = d;
  return K;
}

// A CTA's warps go to the SM's 4 schedulers, whose register files of 16K
// hold at most 128 registers a thread; 2 CTAs of 9 warps or one of 17 give
// a scheduler 5 warps (96 registers each), one of 13 gives it 4 (128), one
// of 8 gives it 2 (255).
template <int P>
struct Regs {
  static constexpr int R = P <= 4 ? 2 : 1;  // rows a warp: 4 P R floats of V a thread
  static constexpr int kRows = P <= 8 ? 16 : P <= 12 ? 12 : 7;  // rows of V a CTA: its unit beside the iterate
  static constexpr int kWarps = kRows / R;  // the warps that rotate, and one that loads the log
  static constexpr int kThreads = 32 * (kWarps + 1);
  static constexpr int kMinBlocks = R == 2 ? 2 : 1;
  static constexpr bool kSplit = P >= 8;  // the round's entries read twice (meta, then rotations): no spills
  static constexpr bool kBits = P >= 8;   // the taken bits kept as a mask, not in the entries: no spills
  static constexpr int D = P % 8 == 0 ? 8 : P % 4 == 0 ? 4 : P % 2 == 0 ? 2 : 1;  // gcd(P, 8): runs a round
  static constexpr int RS = 32 * P + D;  // a round's 16-byte units in a stage
  static constexpr int K = stage_rounds(P, RS);  // rounds a stage, a multiple or a divisor of P
};

// the block of positions lane L holds (`ops.rotation_log.lane_block`), and
// the lane holding block b
template <int P>
__device__ __forceinline__ int lane_block(int L) {
  constexpr int D = Regs<P>::D;
  const int q = L >> 3, l = L & 7;
  return l / (8 / D) * (32 / D) + q * (8 / D) + l % (8 / D);
}
template <int P>
__device__ __forceinline__ int block_lane(int b) {
  constexpr int D = Regs<P>::D;
  const int g = b / (32 / D), t = b % (32 / D);
  return 8 * (t / (8 / D)) + g * (8 / D) + t % (8 / D);
}

// index standing at position j after r rounds (`index_at` of jacobi_eigh.cu
// and ops.jacobi)
__device__ __forceinline__ int index_at(int j, int r, int m) {
  if (j == 0) return 0;
  int k = (j < m ? j : j == m ? 0 : 3 * m - 1 - j) - r;
  if (k < 0) k += 2 * m - 1;
  return k == 0 ? m : k < m ? k : 3 * m - 1 - k;
}

// a key's halves: the top column's (<< 16) from x and the bottom's (<< 1)
// from v, or the other way round
__device__ __forceinline__ int hi_of_x_lo_of_v(int x, int v) { return (int)__byte_perm(x, v, 0x3254); }
__device__ __forceinline__ int lo_of_x_hi_of_v(int x, int v) { return (int)__byte_perm(x, v, 0x7610); }

// A 16-byte shared load the compiler keeps in program order (no loads
// hoisted ahead of the rotations that need them: no spills at large P).
__device__ __forceinline__ float4 lds_in_order(const float4* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(smem_addr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// The loading warp: every stage of the log (rounds [c K, c K + K)) into
// buffer c % kRegStages, entry i of a round at unit i + its run's shift, by
// 16-byte `cp.async` (coalesced reads; one instruction a lane for 32
// entries), each lane's copies completing on the stage's full mbarrier
// (`cp.async.mbarrier.arrive.noinc`, 32 arrivals).  Before it refills a
// buffer it waits until every rotating warp is done with its last stage,
// and (a follow launch) until every CTA of the cluster logged the rounds.
template <int P>
__device__ __forceinline__ void load_log(float4* stage, unsigned long long* bars, const float4* lg, int K, int rounds,
                                         int m, const int* progress, int C, bool follow) {
  constexpr int D = Regs<P>::D, RS = Regs<P>::RS, per_run = 32 / D;
  const int lane = threadIdx.x & 31, stages = (rounds + K - 1) / K;
  for (int c = 0; c < stages; ++c) {
    const int buf = c % kRegStages, r0 = c * K, kr = min(K, rounds - r0);
    if (lane == 0) {
      for (int k = 0; follow && k < C; ++k)
        while (load_acquire(progress + k) < r0 + kr) __nanosleep(200);
      if (c >= kRegStages) wait_phase(smem_addr(bars + kRegStages + buf), (c / kRegStages - 1) & 1);
    }
    __syncwarp();
    float4* dst = stage + (size_t)buf * K * RS;
    for (int r = 0; r < kr; ++r) {
      const float4* src = lg + (size_t)(r0 + r) * m;
      for (int i = lane; i < m; i += 32)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst + r * RS + i + i / P / per_run)),
                     "l"(src + i) : "memory");
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bars + buf)) : "memory");
  }
}

// One round's movement of the entries one step along the cycle, k the
// round mod P: top logical slot s in register (s - k) mod P, bottom in
// (s + k) mod P.  The top chain's last register goes up to the next block
// and the bottom chain's first down to the one before; block 0 keeps
// position 0 and takes position m at 1; the last block turns its last top
// position to its last bottom one (at slot P-1 where P divides m, else at
// `sm`, where the top's stale copy keys as empty).
template <int P, int R>
__device__ __forceinline__ void move_round(float2 (&top)[R][P], float2 (&bot)[R][P], int (&key)[P], int k,
                                           int src_up, int src_dn, bool first, bool last, bool exact, int sm) {
  const int a = P - 1 - k, b = (P - k) % P, c = k;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2 ta = top[r][a], tb = top[r][b], bc = bot[r][c];
    const float2 up = P == 1 && first ? bc : ta;
    const float2 in_up = make_float2(__shfl_sync(0xffffffffu, up.x, src_up), __shfl_sync(0xffffffffu, up.y, src_up));
    const float2 in_dn = make_float2(__shfl_sync(0xffffffffu, bc.x, src_dn), __shfl_sync(0xffffffffu, bc.y, src_dn));
    if (P == 1) {
      top[r][a] = first ? ta : in_up;
    } else {
      top[r][a] = first ? tb : in_up;
      top[r][b] = first ? bc : tb;
    }
    bot[r][c] = last && exact ? ta : in_dn;
  }
  const int ka = key[a], kb = key[b], kc = key[c];
  const int kup = P == 1 && first ? (kc & 0xffff) << 15 : ka;
  const int in_up = __shfl_sync(0xffffffffu, kup, src_up), in_dn = __shfl_sync(0xffffffffu, kc, src_dn);
  const int lo_c = last && exact ? (int)((unsigned)ka >> 16 << 1) : in_dn;
  if (P == 1) {
    key[a] = lo_of_x_hi_of_v(key[a], first ? ka : in_up);
  } else {
    key[a] = lo_of_x_hi_of_v(key[a], first ? kb : in_up);
    key[b] = lo_of_x_hi_of_v(key[b], first ? (kc & 0xffff) << 15 : kb);
  }
  key[c] = hi_of_x_lo_of_v(key[c], lo_c);
  if (!exact) {  // uniform: P does not divide m
#pragma unroll
    for (int s = 0; s < P; ++s) {
      if (last && s == sm) {
        const int src = (s - k + P) % P, dst = (s + k + 1) % P, kx = key[src];
#pragma unroll
        for (int r = 0; r < R; ++r) bot[r][dst] = top[r][src];
        key[src] = kx & 0xffff;
        key[dst] = hi_of_x_lo_of_v(key[dst], (int)((unsigned)kx >> 16 << 1));
      }
    }
  }
}

// R rows a warp, `Regs<P>::kRows` a CTA; v_in may be v_out (V updated in
// place): a warp reads its rows whole before it writes any of them.
template <int P>
__global__ void __launch_bounds__(Regs<P>::kThreads, Regs<P>::kMinBlocks)
rotation_log_regs_kernel(const float2* v_in, const float4* __restrict__ log, float2* v_out, int n, int rounds,
                         int round0, const int* __restrict__ started, const int* __restrict__ progress,
                         int* __restrict__ claim, int C, int mode) {
  using G = Regs<P>;
  constexpr int R = G::R, RS = G::RS, K = G::K;
  extern __shared__ float4 smem[];
  const int m = n / 2, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, mat = blockIdx.y;
  if (mode != kAll && !takes_unit(mode, started, claim)) return;
  float4* stage = smem;  // [kRegStages][K][RS]
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(stage + (size_t)kRegStages * K * RS);  // full, empty
  const float4* lg = log + (size_t)mat * rounds * m;
  const int* prog = mode == kFollow ? progress + (size_t)mat * C : nullptr;
  // zeros where no entry stands: the blocks past m read as untaken
  for (int t = tid; t < kRegStages * K * RS; t += blockDim.x) stage[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid == 0) {
    for (int s = 0; s < kRegStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;" ::"r"(smem_addr(bars + s)));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bars + kRegStages + s)), "r"(G::kWarps));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == G::kWarps) {  // the loading warp
    load_log<P>(stage, bars, lg, K, rounds, m, prog, C, mode == kFollow);
    return;
  }

  // the lane's block, its neighbours' lanes, the last block's last slot
  const int blk = lane_block<P>(lane), W = (m + P - 1) / P, sm = m - 1 - (W - 1) * P;
  const bool first = blk == 0, last = blk == W - 1, exact = sm == P - 1;
  const int src_up = first ? lane : block_lane<P>(blk - 1), src_dn = blk == 31 ? lane : block_lane<P>(blk + 1);
  const int unit0 = blk * P + blk / (32 / G::D);  // its first entry's place in a round of a stage
  const int row0 = blockIdx.x * G::kRows + warp * R;
  const int rr0 = round0 % (n - 1);
  float2 top[R][P], bot[R][P];
  int key[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int i = blk * P + s;
    const bool valid = i < m;
    const int ct = valid ? index_at(i, rr0, m) : 0, cb = valid ? index_at(m + i, rr0, m) : 0;
    key[s] = valid ? ct << 16 | cb << 1 : 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      float2 x = make_float2(0.0f, 0.0f), y = x;
      if (valid && row < n) {
        const size_t at = ((size_t)mat * n + row) * n;
        x = v_in ? v_in[at + ct] : make_float2(row == ct ? 1.0f : 0.0f, 0.0f);
        y = v_in ? v_in[at + cb] : make_float2(row == cb ? 1.0f : 0.0f, 0.0f);
      }
      top[r][s] = x;
      bot[r][s] = y;
    }
  }

  // stages of K rounds: J whole unrolled blocks of P rounds a stage, or P / K
  // stages a block, so a round's place in its stage is known at compile time
  constexpr int J = K % P == 0 ? K / P : 1;
  unsigned bad = 0;  // OR of every entry's meta against its key (bit 0: taken)
  const float4 *st = stage, *sb = stage;
  for (int t0 = 0, c = 0, j = 0; t0 < rounds; t0 += P, j = j + 1 == J ? 0 : j + 1) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (t0 + k < rounds) {
        if (K % P == 0 ? k == 0 && j == 0 : k % K == 0) {
          wait_phase(smem_addr(bars + c % kRegStages), (c / kRegStages) & 1);
          st = stage + (size_t)(c % kRegStages) * K * RS + unit0;
        }
        if (k == 0) sb = K % P == 0 ? st + j * P * RS : st;
        const float4* e = K % P == 0 ? sb + k * RS : st + k % K * RS;
        float4 q[P];
        int any = 0;  // the taken bits (split reads), or the OR of the metas
#pragma unroll
        for (int s = 0; s < P; ++s) {
          const int meta = G::kSplit ? __float_as_int(e[s].w) : __float_as_int((q[s] = e[s]).w);
          bad |= meta ^ hi_of_x_lo_of_v(key[(s - k + P) % P], key[(s + k) % P]);
          any |= G::kBits ? (meta & 1) << s : meta;
        }
        if (__any_sync(0xffffffffu, G::kBits ? any : any & 1)) {
#pragma unroll
          for (int s = 0; s < P; ++s) {
            const float4 qs = G::kSplit ? lds_in_order(e + s) : q[s];
            const bool t = G::kBits ? any >> s & 1 : __float_as_int(q[s].w) & 1;
#pragma unroll
            for (int r = 0; r < R; ++r) {  // untaken: the pair as it stands (selects, no branch)
              float2 x = top[r][(s - k + P) % P], y = bot[r][(s + k) % P];
              colmix(x, y, qs);
              top[r][(s - k + P) % P] = t ? x : top[r][(s - k + P) % P];
              bot[r][(s + k) % P] = t ? y : bot[r][(s + k) % P];
            }
          }
        }
        move_round<P, R>(top, bot, key, k, src_up, src_dn, first, last, exact, sm);
        if (K % P == 0 ? k == P - 1 && j == J - 1 : k % K == K - 1) {  // the stage is done: free its buffer
          __syncwarp();
          if (lane == 0) arrive(smem_addr(bars + kRegStages + c % kRegStages));
          ++c;
        }  // (the last stage, where it ends early, is refilled by no one)
      }
    }
  }

  // the columns standing at the positions now; the keys must name them
  const int kend = rounds % P, rr = (int)(((long long)round0 + rounds) % (n - 1));
  int colt[P], colb[P];
#pragma unroll
  for (int ph = 0; ph < P; ++ph) {
    const int it = blk * P + (ph + kend) % P, ib = blk * P + (ph - kend + P) % P;
    colt[ph] = it < m ? index_at(it, rr, m) : -1;
    colb[ph] = ib < m ? index_at(m + ib, rr, m) : -1;
    if (colt[ph] >= 0) bad |= (unsigned)((key[ph] >> 16) != colt[ph]) << 1;
    if (colb[ph] >= 0) bad |= (unsigned)(((key[ph] & 0xffff) >> 1) != colb[ph]) << 1;
  }
  if (blk < W && (bad & ~1u)) __trap();  // a log entry's p, q is not the pair at its positions
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= n) continue;
    float2* vr = v_out + ((size_t)mat * n + row) * n;
#pragma unroll
    for (int ph = 0; ph < P; ++ph) {
      if (colt[ph] >= 0) vr[colt[ph]] = top[r][ph];
      if (colb[ph] >= 0) vr[colb[ph]] = bot[r][ph];
    }
  }
}

// One warp ahead of a follow launch past one wave: returns once the
// clusters of every matrix run (`started`), or after about a second.
__global__ void rotation_log_gate_kernel(const int* __restrict__ started, int batch) {
  if (threadIdx.x != 0) return;
  for (int spin = 0, b = 0; spin < (1 << 20); ++spin) {
    while (b < batch && load_acquire(started + b) != 0) ++b;
    if (b == batch) return;
    __nanosleep(1000);
  }
}

template <int P>
int launch_regs(const void* v_in, const void* log, void* v_out, int batch, int n, int rounds, int round0, int K,
                const void* started, const void* progress, void* claim, int cluster, int mode, cudaStream_t stream) {
  const int smem = (int)reg_smem_bytes(Regs<P>::RS, Regs<P>::K);
  if (K != Regs<P>::K || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(rotation_log_regs_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rotation_log_regs_kernel<P><<<dim3((n + Regs<P>::kRows - 1) / Regs<P>::kRows, batch), Regs<P>::kThreads, smem,
                                stream>>>(
      (const float2*)v_in, (const float4*)log, (float2*)v_out, n, rounds, round0, (const int*)started,
      (const int*)progress, (int*)claim, cluster, mode);
  return (int)cudaGetLastError();
}

// CTAs of a kernel one SM holds at once, or a negative cudaError_t
template <typename Kernel>
int ctas_per_sm(Kernel kernel, int threads, int smem) {
  int ctas = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, smem);
  return err == cudaSuccess ? ctas : -(int)err;
}

bool ok(int n, int S, int E) {
  return n >= 4 && n % 2 == 0 && n / 2 <= 0x7fff && S >= 1 && S <= 16 && (S & (S - 1)) == 0 && E >= 16 &&
         smem_bytes(n, S, E) <= 232448;
}

}  // namespace

// V [batch, n, n] row-major (v_out) from V0 (v_in, row-major; the identity
// when null; it may be v_out) and the rotation log [batch][rounds][n/2]
// float4 of an iterate kernel: S rows a CTA (a half-warp each), E entries a
// stage of the log (K whole rounds, E = K n/2, or a part of one).
// mode 0: every slab; 1 (follow): the slabs of matrices whose iterate
// cluster runs (started [batch]), claimed in claim [batch][slabs], each
// stage once progress [batch][cluster] says every CTA logged it; 2 (rest):
// the slabs no launch claimed.  A follow CTA waits a bounded while for the
// clusters of all batch matrices to start, then leaves its slab to the rest
// launch.
extern "C" int tnqs_rotation_log(const void* v_in, const void* log, void* v_out, int batch, int n, int rounds, int S,
                                 int E, const void* started, const void* progress, void* claim, int cluster, int mode,
                                 void* stream) {
  if (batch <= 0 || rounds < 0 || !ok(n, S, E) || mode < kAll || mode > kRest ||
      (mode != kAll && (claim == nullptr || (mode == kFollow && (started == nullptr || progress == nullptr ||
                                                                 cluster < 1)))))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_bytes(n, S, E);
  cudaError_t err = cudaFuncSetAttribute(rotation_log_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rotation_log_kernel<<<dim3((n + S - 1) / S, batch), 32 * ((S + 1) / 2), smem, (cudaStream_t)stream>>>(
      (const float2*)v_in, (const float4*)log, (float2*)v_out, n, rounds, S, E, (const int*)started,
      (const int*)progress, (int*)claim, cluster, mode);
  return (int)cudaGetLastError();
}

// V [batch, n, n] by the register layout (even 4 <= n <= 1024, P =
// ceil(n/64) positions a lane): the log's first round is round `round0` of
// the iterate's schedule (its chunks past `LOG_BUDGET`), K whole rounds a
// stage (`stage_rounds`; another K is refused).  mode, started, progress, claim and cluster as above; the unit is
// a CTA's 16 rows (12 past n = 512, 7 past n = 768).
extern "C" int tnqs_rotation_log_regs(const void* v_in, const void* log, void* v_out, int batch, int n, int rounds,
                                      int round0, int K, const void* started, const void* progress, void* claim,
                                      int cluster, int mode, void* stream) {
  if (batch <= 0 || rounds < 0 || round0 < 0 || n < 4 || n > 1024 || n % 2 || K < 1 || mode < kAll ||
      mode > kRest ||
      (mode != kAll && (claim == nullptr || (mode == kFollow && (started == nullptr || progress == nullptr ||
                                                                 cluster < 1)))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define TNQS_REGS(P) \
  case P:            \
    return launch_regs<P>(v_in, log, v_out, batch, n, rounds, round0, K, started, progress, claim, cluster, mode, st);
  switch ((n / 2 + 31) / 32) {
    TNQS_REGS(1) TNQS_REGS(2) TNQS_REGS(3) TNQS_REGS(4) TNQS_REGS(5) TNQS_REGS(6) TNQS_REGS(7) TNQS_REGS(8)
    TNQS_REGS(9) TNQS_REGS(10) TNQS_REGS(11) TNQS_REGS(12) TNQS_REGS(13) TNQS_REGS(14) TNQS_REGS(15) TNQS_REGS(16)
  }
#undef TNQS_REGS
  return (int)cudaErrorInvalidValue;
}

// CTAs one SM holds at once on the current device: the register layout's
// for V [n, n] (regs != 0), else the slab layout's of S rows and E entries a
// stage; a negative cudaError_t where the layout does not take n.
extern "C" int tnqs_rotation_log_ctas_per_sm(int n, int S, int E, int regs) {
  if (!regs) return ok(n, S, E) ? ctas_per_sm(rotation_log_kernel, 32 * ((S + 1) / 2), (int)smem_bytes(n, S, E))
                                : -(int)cudaErrorInvalidValue;
  if (n < 4 || n > 1024 || n % 2) return -(int)cudaErrorInvalidValue;
#define TNQS_REGS(P) \
  case P:            \
    return ctas_per_sm(rotation_log_regs_kernel<P>, Regs<P>::kThreads, (int)reg_smem_bytes(Regs<P>::RS, Regs<P>::K));
  switch ((n / 2 + 31) / 32) {
    TNQS_REGS(1) TNQS_REGS(2) TNQS_REGS(3) TNQS_REGS(4) TNQS_REGS(5) TNQS_REGS(6) TNQS_REGS(7) TNQS_REGS(8)
    TNQS_REGS(9) TNQS_REGS(10) TNQS_REGS(11) TNQS_REGS(12) TNQS_REGS(13) TNQS_REGS(14) TNQS_REGS(15) TNQS_REGS(16)
  }
#undef TNQS_REGS
  return -(int)cudaErrorInvalidValue;
}

// The gate ahead of a follow launch past one wave, on the follow launch's
// stream: one warp polling started [batch].
extern "C" int tnqs_rotation_log_gate(const void* started, int batch, void* stream) {
  if (started == nullptr || batch <= 0) return (int)cudaErrorInvalidValue;
  rotation_log_gate_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const int*)started, batch);
  return (int)cudaGetLastError();
}
