// Fused BP message update for one (stage, degree, slot) group.
//
// Replaces the Pallas kernel of `tnqs/ops/bp_sweep.py::bp_sweep_group`
// (tnqs/ops/bp_sweep.py:230; kernel body `_make_kernel`, :129).  For each
// source b of the group (bucket row rows[b] of T[k]) it computes the
// un-normalized outgoing message
//
//   m[b, i, j] = sum_s sum_{x, y} K[s, i, x] (M_0 x ... x M_{k-2})[x, y] conj(K[s, j, y])
//
// where K[s, i, x] is the site tensor T[k][rows[b], s] with the outgoing slot t
// indexed by i and the other k-1 bond slots (ascending) by the multi-index x,
// and message col is absorbed into the other slot col as `...x, xy -> ...y`
// (`_absorb_message`).  The caller sum-normalizes.  The rows come as an
// index array, so gathered groups (the wavefront schedule's) take the kernel
// too; the TPU kernel takes a contiguous range `lo` only.
//
// The kernel reads complex64 T[k] in place, in its natural [n_k, d, chi^k]
// layout: removing the slot-t digit from a flat site offset f gives the
// other slots' linear index y directly, f = (y / st) * st * chi + i * st +
// y % st with st = chi^(k-1-t).  The TPU kernel needs pre-permuted real and
// imaginary plane copies and a blocked-real embedding instead (Mosaic has no
// complex type and only 2D dots); none of that is carried over.
//
// Layout: one CTA of 512 threads per (message b, chunk of ROWS = 8 or 4
// outgoing rows i; the bond dimension is a multiple of 8, as the wrapper's
// `supports_group` requires).  The incoming messages are staged in shared
// memory once per CTA when they fit (both of them at degree 3, chi=64),
// else read from global memory (degree 2 at chi=512).
// Per site value s and row i of the chunk, the k-1 absorbs run as mode
// products between two buffers of X = chi^(k-1) elements (Z_i, then a
// shared temp), each a small complex GEMM over the contracted slot in
// which every thread keeps a 4 x 2 register tile of independent
// accumulators (rows x output columns), so the FMA chains overlap and a
// complex MAC costs 0.75 shared loads.  At degree 2 the one absorb takes
// all rows of the chunk in a single product.  The chunk's ket rows are
// gathered in one pass, row index fastest when slot t is the last (stride
// 1), so the gather is coalesced for every t.  The chunk's Z rows stay
// resident for the final product: each warp owns groups of 4 consecutive
// bra indices j, its lanes walk the other-slot index y, and the bra
// K[s, j, y] is read straight from L2 (consecutive y per lane, or two
// float4 of consecutive j when t is the last slot) with no barrier in the
// loop, so each element read serves all ROWS rows; warp shuffles reduce
// over y and the owning warp adds the sum over s in shared memory (the TPU
// wrote per-site partial slabs and summed them in XLA, since its grid
// could not revisit an output).  The buffers live in dynamic shared memory
// when they fit, else in a global scratch the wrapper allocates (large
// chi^(k-1), e.g. k=6 at chi=8); the code reaches both through generic
// pointers.  The limits on k and chi are stated once, in the wrapper's
// `supports_group` (tnqs_torch/ops/bp_sweep.py); this file checks only that
// the arguments are well formed.
//
// What bounds it on Hopper: FLOPs.  At Eagle chi=64 a degree-3 message is
// 3 * d * chi^4 complex MACs (~805 MFLOP) against 4 MB of site tensor, so
// the floor is the FP32 CUDA-core rate (67 TFLOP/s; TF32 tensor cores are
// ruled out by the "highest" precision contract).  The design reaches about
// a quarter of it: one 227 KB CTA per SM (16 warps) leaves the absorbs'
// shared-memory latency partly exposed, and 576 CTAs make 4.4 waves.  The
// final product reads every bra element once per CTA from L2, so four rows
// per CTA (what shared memory holds at chi=64) also lean on L2 bandwidth.
// Batching the chunk's rows into larger absorb GEMMs, 3xTF32 wgmma and a
// cluster-shared bra are the next steps.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 4;  // register tile: absorb rows, final-product bra indices
constexpr int TC = 2;  // register tile: absorb output columns
constexpr int THREADS = 512;

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}

// acc += a * conj(b)
__device__ __forceinline__ void cmac_conj(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(a.y, b.x, fmaf(-a.x, b.y, acc.y));
}

// rows of X elements in the absorb buffers: Z [rows][X] and the temp
__host__ __device__ __forceinline__ int buffer_rows(int rows, int k) { return rows + (k == 2 ? rows : 1); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dst[hi, y, lo] = sum_x src[hi, x, lo] M[x, y] over X elements with the
// contracted slot of extent chi and stride L: a GEMM with X / chi rows
// (hi, lo), in TW-row x TC-column thread tiles; columns y = yb + YB * n
__device__ __forceinline__ void mode_product(const float2* src, float2* dst, const float2* M, int X,
                                             int chi, int L) {
  const int R = X / chi;
  const int RB = (R + TW - 1) / TW;
  const int YB = (chi + TC - 1) / TC;
  for (int tt = threadIdx.x; tt < RB * YB; tt += blockDim.x) {
    const int yb = tt % YB;
    const int rb = tt / YB;
    int addr[TW], col[TC];
#pragma unroll
    for (int m = 0; m < TW; ++m) {
      const int r = min(rb * TW + m, R - 1);
      addr[m] = (r / L) * L * chi + r % L;
    }
#pragma unroll
    for (int n = 0; n < TC; ++n) col[n] = min(yb + YB * n, chi - 1);
    float2 acc[TW][TC];
#pragma unroll
    for (int m = 0; m < TW; ++m)
#pragma unroll
      for (int n = 0; n < TC; ++n) acc[m][n] = make_float2(0.0f, 0.0f);
#pragma unroll 4
    for (int x = 0; x < chi; ++x) {
      float2 a[TW], b[TC];
#pragma unroll
      for (int m = 0; m < TW; ++m) a[m] = src[addr[m] + x * L];
#pragma unroll
      for (int n = 0; n < TC; ++n) b[n] = M[x * chi + col[n]];
#pragma unroll
      for (int m = 0; m < TW; ++m)
#pragma unroll
        for (int n = 0; n < TC; ++n) cmac(acc[m][n], a[m], b[n]);
    }
#pragma unroll
    for (int m = 0; m < TW; ++m) {
      if (rb * TW + m >= R) break;
#pragma unroll
      for (int n = 0; n < TC; ++n) {
        const int y = yb + YB * n;
        if (y < chi) dst[addr[m] + y * L] = acc[m][n];
      }
    }
  }
}

// macc[o, j] += sum_y Z_o[y] conj(K[j, y]) with K's slot-t index j at
// stride st; warp w owns the bra indices j = TW * g + n of groups g = w, w +
// nwarps, ..., its lanes walk y = yh * st + yl.  VEC (st == 1, chi % 4 ==
// 0): a lane's four j are contiguous and load as two float4.
template <int ROWS, bool VEC>
__device__ __forceinline__ void bra_product(const float2* __restrict__ K, const float2* bufs, float2* macc,
                                            int X, int chi, int st) {
  const int lane = threadIdx.x & 31;
  const int NJ = (chi + TW - 1) / TW;
  for (int g = threadIdx.x >> 5; g < NJ; g += blockDim.x >> 5) {
    int jofs[TW];
#pragma unroll
    for (int n = 0; n < TW; ++n) jofs[n] = min(TW * g + n, chi - 1) * st;
    float2 acc[ROWS][TW];
#pragma unroll
    for (int o = 0; o < ROWS; ++o)
#pragma unroll
      for (int n = 0; n < TW; ++n) acc[o][n] = make_float2(0.0f, 0.0f);
    int yh = lane / st, yl = lane % st;
#pragma unroll 2
    for (int y = lane; y < X; y += 32) {
      const float2* bra = K + (size_t)yh * st * chi + yl;
      float2 bv[TW], z[ROWS];
      if (VEC) {
        const float4* v = reinterpret_cast<const float4*>(bra + TW * g);
        const float4 a = __ldg(v), c = __ldg(v + 1);
        bv[0] = make_float2(a.x, a.y);
        bv[1] = make_float2(a.z, a.w);
        bv[2] = make_float2(c.x, c.y);
        bv[3] = make_float2(c.z, c.w);
      } else {
#pragma unroll
        for (int n = 0; n < TW; ++n) bv[n] = __ldg(bra + jofs[n]);
      }
#pragma unroll
      for (int o = 0; o < ROWS; ++o) z[o] = bufs[(size_t)o * X + y];
#pragma unroll
      for (int o = 0; o < ROWS; ++o)
#pragma unroll
        for (int n = 0; n < TW; ++n) cmac_conj(acc[o][n], z[o], bv[n]);
      yl += 32;
      if (yl >= st) {
        yh += yl / st;
        yl %= st;
      }
    }
#pragma unroll
    for (int o = 0; o < ROWS; ++o)
#pragma unroll
      for (int n = 0; n < TW; ++n) {
        const float re = warp_sum(acc[o][n].x);
        const float im = warp_sum(acc[o][n].y);
        const int j = TW * g + n;
        if (lane == 0 && j < chi) {
          macc[o * chi + j].x += re;
          macc[o * chi + j].y += im;
        }
      }
  }
}

// dst[o][y] = K[i0 + o at slot t, y at the other slots] for the chunk's rows
__device__ __forceinline__ void gather_rows(const float2* __restrict__ K, float2* dst, int nrows, int i0, int X,
                                            int chi, int st) {
  for (int q = threadIdx.x; q < nrows * X; q += blockDim.x) {
    const int o = st == 1 ? q % nrows : q / X;
    const int y = st == 1 ? q / nrows : q % X;
    dst[(size_t)o * X + y] = K[(size_t)(y / st) * st * chi + (size_t)(i0 + o) * st + y % st];
  }
}

template <int ROWS>
__global__ void __launch_bounds__(THREADS) bp_sweep_kernel(const float2* __restrict__ T,
                                                           const float2* __restrict__ Min,
                                                           float2* __restrict__ out,
                                                           float2* __restrict__ scratch,
                                                           const long long* __restrict__ rows, int n_k,
                                                           int k, int chi, int d, int t, int use_smem,
                                                           int m_smem) {
  extern __shared__ float2 smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, chi - i0);

  int X = 1;  // chi^(k-1)
  for (int c = 0; c < k - 1; ++c) X *= chi;
  int st = 1;  // stride of slot t in a site block: chi^(k-1-t)
  for (int c = t + 1; c < k; ++c) st *= chi;
  const size_t site = (size_t)X * chi;
  const long long row = rows[b];
  if (row < 0 || row >= n_k) __trap();  // a row outside the bucket

  // shared: the messages [k-1][chi, chi] when they fit, the sum over s
  // [ROWS][chi], then the buffers Z [ROWS][X] and temp (X, or [ROWS][X] at
  // degree 2), when they fit
  float2* Ms = smem;
  float2* macc = smem + (m_smem ? (size_t)(k - 1) * chi * chi : 0);
  float2* bufs = use_smem ? macc + (size_t)ROWS * chi
                          : scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * buffer_rows(ROWS, k) * X;
  float2* temp = bufs + (size_t)ROWS * X;
  for (int q = tid; q < ROWS * chi; q += blockDim.x) macc[q] = make_float2(0.0f, 0.0f);
  const float2* Mb = Min + (size_t)b * (k - 1) * chi * chi;
  if (m_smem)
    for (int q = tid; q < (k - 1) * chi * chi; q += blockDim.x) Ms[q] = Mb[q];
  const float2* Mr = m_smem ? Ms : Mb;  // message c at Mr + c * chi * chi

  for (int s = 0; s < d; ++s) {
    const float2* K = T + ((size_t)row * d + s) * site;

    // phase A: Z_i = K_i absorbed with every incoming message
    if (k == 2) {  // one absorb, every row of the chunk in one product
      gather_rows(K, temp, nrows, i0, X, chi, st);
      __syncthreads();
      mode_product(temp, bufs, Mr, nrows * X, chi, 1);
      __syncthreads();
    } else {
      // with an even number of absorbs each row ends where it starts, in Z_i
      const bool even = (k - 1) % 2 == 0;
      if (even) gather_rows(K, bufs, nrows, i0, X, chi, st);
      for (int o = 0; o < nrows; ++o) {
        float2* Z = bufs + (size_t)o * X;
        float2* src = even ? Z : temp;
        float2* dst = even ? temp : Z;
        if (!even) gather_rows(K + (size_t)o * st, temp, 1, i0, X, chi, st);
        int L = X / chi;  // extent of the slots after mode c
        for (int c = 0; c < k - 1; ++c) {
          __syncthreads();
          mode_product(src, dst, Mr + (size_t)c * chi * chi, X, chi, L);
          __syncthreads();
          float2* tmp = src;
          src = dst;
          dst = tmp;
          L /= chi;
        }
      }
    }

    // phase B: m[i, j] += sum_y Z_i[y] conj(K[s, j, y])
    if (st == 1 && chi % TW == 0)
      bra_product<ROWS, true>(K, bufs, macc, X, chi, st);
    else
      bra_product<ROWS, false>(K, bufs, macc, X, chi, st);
    __syncthreads();  // the buffers are rewritten for the next s
  }

  for (int q = tid; q < ROWS * chi; q += blockDim.x) {
    const int o = q / chi;
    if (i0 + o < chi) out[((size_t)b * chi + i0) * chi + q] = macc[q];
  }
}

// the shared memory a launch needs, in float2
size_t smem_elems(int rows, int k, int X, int chi, int use_smem, int m_smem) {
  return (m_smem ? (size_t)(k - 1) * chi * chi : 0) + (size_t)rows * chi +
         (use_smem ? (size_t)buffer_rows(rows, k) * X : 0);
}

struct Plan {
  int rows;      // outgoing rows per CTA (8 or 4)
  int use_smem;  // the absorb buffers in shared memory, else in the scratch
  int m_smem;    // the messages in shared memory, else read from global
  int X;         // chi^(k-1)
};

// Eight rows per CTA, else four, with the buffers in shared memory beside
// the messages if possible, else without them; four rows in the global
// scratch when not even four fit, with the messages in shared memory if
// they fit there.
Plan plan(int k, int chi) {
  const size_t limit = 227 * 1024 / sizeof(float2);
  Plan p = {4, 0, 0, 1};
  for (int c = 0; c < k - 1; ++c) p.X *= chi;
  for (int m = 1; m >= 0 && !p.use_smem; --m)
    for (int rows = 8; rows >= 4 && !p.use_smem; rows /= 2)
      if (smem_elems(rows, k, p.X, chi, 1, m) <= limit) p = {rows, 1, m, p.X};
  if (!p.use_smem) p.m_smem = smem_elems(p.rows, k, p.X, chi, 0, 1) <= limit;
  return p;
}

size_t scratch_elems(int batch, int k, int chi, const Plan& p) {
  return p.use_smem ? 0 : (size_t)batch * ((chi + p.rows - 1) / p.rows) * buffer_rows(p.rows, k) * p.X;
}

template <int ROWS>
int launch(const void* T, const void* Min, void* out, void* scratch, const long long* rows, int n_k,
           int batch, int k, int chi, int d, int t, const Plan& p, cudaStream_t stream) {
  const size_t smem = smem_elems(ROWS, k, p.X, chi, p.use_smem, p.m_smem) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(bp_sweep_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((chi + ROWS - 1) / ROWS, batch);
  bp_sweep_kernel<ROWS><<<grid, THREADS, smem, stream>>>((const float2*)T, (const float2*)Min, (float2*)out,
                                                         (float2*)scratch, rows, n_k, k, chi, d, t,
                                                         p.use_smem, p.m_smem);
  return (int)cudaGetLastError();
}

bool well_formed(int batch, int k, int chi) { return batch > 0 && k >= 2 && chi >= 1; }

}  // namespace

// Complex64 elements of global scratch that tnqs_bp_sweep needs for a
// group of `batch` messages (0 when its buffers fit in shared memory).
extern "C" int tnqs_bp_sweep_scratch(int batch, int k, int chi, long long* elems) {
  if (!well_formed(batch, k, chi)) return (int)cudaErrorInvalidValue;
  *elems = (long long)scratch_elems(batch, k, chi, plan(k, chi));
  return (int)cudaSuccess;
}

// T: the bucket [n_k, d, chi^k] complex64, contiguous; rows [batch] int64,
// each in [0, n_k) (the kernel traps otherwise); Min [batch, k-1, chi, chi];
// out [batch, chi, chi]; scratch as tnqs_bp_sweep_scratch says (may be null
// when that is 0).
extern "C" int tnqs_bp_sweep(const void* T, const void* rows, const void* Min, void* out, void* scratch,
                             int n_k, int batch, int k, int chi, int d, int t, void* stream) {
  if (!well_formed(batch, k, chi) || n_k < 1 || d < 1 || t < 0 || t >= k) return (int)cudaErrorInvalidValue;
  const Plan p = plan(k, chi);
  if (!p.use_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* r = (const long long*)rows;
  return p.rows == 8 ? launch<8>(T, Min, out, scratch, r, n_k, batch, k, chi, d, t, p, s)
                     : launch<4>(T, Min, out, scratch, r, n_k, batch, k, chi, d, t, p, s);
}
