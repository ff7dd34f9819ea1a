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
// (p << 16 | q << 1 | taken), and this kernel applies the log to V
// afterwards, with the same `colmix` in the same order, so every element of
// V sees the same arithmetic as when V was rotated in the rounds.
//
// Layout: one CTA per slab of S rows of one matrix (S = 16 where it fits),
// row-major in shared memory; column rotations never mix rows, so slabs
// never exchange anything.  Each warp owns two rows of the slab, a half-warp
// each, its 16 lanes the round's pairs (lane l pairs l, l + 16, ...; the two
// halves read the same rotations), loaded four at a time before any store;
// rows never meet, so a warp passes from one round to the next with
// `__syncwarp` alone.  The log streams in by `cp.async.bulk`
// (the TMA's bulk copy), E entries a stage, two stages against two
// mbarriers, one block barrier a stage before its buffer is refilled.  A
// stage is K whole rounds (E = K m) where they fit beside the slab, else a
// part of a round (past n = 9684, where a row of V and one round no longer
// fit): the lanes walk a stage round by round, each round's entries in
// order, so a round split over two stages sees the same operations as one
// held whole (its pairs are disjoint).
//
// Beside the iterate kernel.  Where the iterate's clusters leave SMs idle,
// the wrapper launches this kernel on a second stream to follow the log as
// it grows ("follow"), and again after the iterate on its own stream for
// what is left ("rest").  A follow CTA takes its slab only once the
// clusters of every matrix of the launch run (`started`, which the iterate
// sets once all its CTAs run); until then it polls for a bounded while and
// then leaves.  So it waits only on work that is running and needs nothing
// of this kernel, and cannot hang whatever the scheduler does; and no CTA
// of this kernel holds an SM while a cluster of the iterate still waits to
// be placed, beyond that bounded poll (a cluster needs its C SMs free in
// one GPC at once, so CTAs that stayed could delay it by a whole iterate).
// Its thread 0 issues a stage only when every CTA of the matrix's cluster
// has published (`progress`, after a device-wide fence) that it logged
// those rounds.  A slab is claimed by one CTA of either launch (`claim`,
// compare-and-swap); the rest launch does every slab no follow CTA took.
//
// What bounds it: the FP32 issue rate of the colmixes (12 FP32 operations
// a row of a taken pair) and their shared-memory traffic; the log (16 m
// bytes a round) is read once a CTA, from L2.

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

// one half-warp a row: S / 2 warps (one for S = 1).  v_in may be v_out (V
// updated in place): a CTA reads its whole slab before it writes any of it.
__global__ void __launch_bounds__(512)
rotation_log_kernel(const float2* v_in, const float4* __restrict__ log, float2* v_out, int n, int rounds, int S,
                    int E, const int* __restrict__ started, const int* __restrict__ progress, int* __restrict__ claim,
                    int C, int mode) {
  extern __shared__ float4 smem[];
  __shared__ int take;
  const int m = n / 2, tid = threadIdx.x, lane = tid & 15, row = tid >> 4;
  const int mat = blockIdx.y, r0 = blockIdx.x * S, rows = min(S, n - r0);
  if (mode != kAll) {
    if (tid == 0) {
      // a follow CTA gives the iterate's clusters a bounded while to start
      // (clusters take longer to place than CTAs), then leaves its slab to
      // the rest launch: it never waits on work that may not run, and stays
      // only once no cluster of the launch waits for SMs
      bool runs = mode == kRest;
      for (int spin = 0, b = 0; !runs && spin < kStartSpins; ++spin) {
        while (b < (int)gridDim.y && load_acquire(started + b) != 0) ++b;
        runs = b == (int)gridDim.y;
        if (!runs) __nanosleep(256);
      }
      take = runs && atomicCAS(claim + mat * gridDim.x + blockIdx.x, 0, 1) == 0;
    }
    __syncthreads();
    if (!take) return;
  }
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
