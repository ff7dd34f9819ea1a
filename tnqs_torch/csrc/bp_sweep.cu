// Fused BP message update for one (stage, degree, slot) group.
//
// Replaces the Pallas kernel of `tnqs/ops/bp_sweep.py::bp_sweep_group`
// (tnqs/ops/bp_sweep.py:230; kernel body `_make_kernel`, :129).  For each
// source b of the group (bucket row rows[b] of T[k]) it computes the
// un-normalized outgoing message through slot t
//
//   m[b, i, j] = sum_s sum_{x, y} K[s, i, x] (M_0 x ... x M_{k-2})[x, y] conj(K[s, j, y])
//
// where K[s] = T[k][rows[b], s], i and j index slot t, x and y the other k-1
// slots (ascending), and message col is absorbed into the col-th other slot
// as `...x, xy -> ...y` (`_absorb_message`).  The caller sum-normalizes.
// The rows come as an index array, so gathered groups (the wavefront
// schedule's) take the kernel too.  T[k] is read in place, complex64 in its
// natural [n_k, d, chi^k] layout: the TPU kernel's pre-permuted real and
// imaginary plane copies and blocked-real embedding are Mosaic workarounds
// and are not carried over.
//
// What bounds it on Hopper: FP32 operations.  A degree-3 message at chi=64
// is 3 d chi^4 complex MACs (805 MFLOP) against 4 MB of site tensor, and
// the precision contract ("highest") rules out TF32, so the floor is the
// CUDA cores' 67 TFLOP/s.  The design keeps the FMA pipes fed:
//
// * Split absorbs.  One incoming message (slot u) goes to the bra side,
//   V = K x_u conj(M_u), the others to the ket side, W = K x_v M_v x ...;
//   then m[i, j] = sum_{s, rest} W[s, i, rest] conj(V[s, j, rest]).  Every
//   step is a contraction of depth chi over whole 64 x 64 tiles, and the
//   total stays k d chi^(k+1) complex MACs a message.
// * Passes.  `bp_mode_product` writes V (and, at degree >= 4, all but one
//   ket absorb) for the whole group into a scratch the wrapper allocates, in
//   T's natural layout.  `bp_pass2` takes, per CTA, a chunk of (s, o) items
//   of one message, o the index of every slot but t and the last ket-absorb
//   slot v: it loads the tile K[s, i, o, y], makes W = K M_v in shared
//   memory against M_v held there for the whole CTA, and accumulates
//   W V^H over the tile into a 64 x 64 register-tiled partial.  Chunks of
//   one message are summed by `bp_reduce` in chunk order: no float atomics,
//   so two calls give the same bits.  A bond wider than 64 (degree 2 only)
//   runs the same pass over 64-blocks of i, j, y and q.
// * Register-tiled FP32 GEMM.  Operands sit in shared memory k-major (a row
//   per depth index, pitch 66 float2: 16-byte rows, fewer bank conflicts on
//   transposed stores).  256 threads each own a 4 x 4 complex tile of a
//   64 x 64 output, rows and columns interleaved in pairs so a warp's four
//   16-byte loads a depth step are broadcasts or conflict-free: 64 FMAs for
//   4 shared loads, with no barrier inside a contraction.
// * Copies.  Tiles arrive by 8-byte cp.async (any index order, no register
//   staging): pass 1 double-buffers its column blocks, pass 2 loads V's tile
//   while W's product runs.
// * Occupancy.  Each pass holds three tiles (99 KB) in <= 128 registers, so
//   two CTAs share an SM and one CTA's tile loads overlap another's FMAs;
//   the wrapper's plan sizes the chunks so the grid fills the card's CTA
//   slots in whole waves.
//
// The second mode, "bf16_3x" (the TPU kernel's `mode="bf16_3x"`, which the
// JAX engine runs under `bp_precision="high"`, tnqs/engine.py:801-812): every
// complex product of the same three steps (V = K x_u conj(M_u), W = K M_v,
// W V^H) is four real products, each hi.hi + hi.lo + lo.hi of the operands'
// bfloat16 split (hi = bf16(x), lo = bf16(x - hi), nearest even) with
// float32 accumulation.  What bounds it: the same work at the dense bf16
// rate (24 FLOP a complex MAC), and nearly as much the bytes: pass 1 reads
// K and writes V, pass 2 reads both, each the group's d chi^k values a
// message at 8 bytes.  Degree 2 and 3 at chi <= 64 (`tc_route` in the
// wrapper: every shape a path runs) take the tensor-core kernels,
// `bp_bra_tc` and `bp_pass2_tc`:
// * Split once.  `bp_split_planes` writes T's planes (re hi, im hi, re lo,
//   im lo; bf16 [4][n_k, d, chi^k]) once a BP run: the engine makes them
//   with the run, the wrapper when it is given T alone.  Pass 1 writes V in
//   the same planes, split in registers; a CTA splits its message as it
//   stores it.  No split in the tile loads.
// * TMA.  A K or V tile is one `cp.async.bulk.tensor` of a 5-D map over the
//   planes (the slots from the last, bucket row x d + s, the plane): the
//   tile's two strided slots and its four planes at once, the row from
//   `rows[b]` (gathered groups stay), in the 128-byte swizzle wgmma reads,
//   zero past chi (no padding code for chi = 8..56).  Tiles land in a ring
//   of two 32 KB stages against mbarriers; pass 1 stores V's tile by TMA
//   from the stage it read.
// * `wgmma` m64n64k16 from shared memory, bf16 in, float32 accumulate;
//   each tile K-major or MN-major as it lies (MN-major when t is the last
//   slot), so no transposing copy; conj and minus by the instruction's
//   operand scale.
// * W stays in registers: its float32 accumulator, split into bf16 hi and
//   lo, is the register A operand of the W V^H `wgmma` (the accumulator's
//   layout is the fragment's, pair for pair), as FlashAttention-3 keeps P.
// * V goes through HBM: launches of a few messages at a time, whose V pass
//   2 would read back from L2, measured slower than one launch of each pass
//   for the whole group (each launch's tail costs more than the trip).
// * chi = 32 (the thermal path, d = 4) fills a quarter of each 64 x 64
//   output tile: left so (K3 is a small share of a thermal step).
// Pass 2 is one warpgroup whose thread 0 issues the loads (a producer warp
// would cap two CTAs an SM at 168 registers, and the kernel spilled there);
// pass 1 has a producer warp.  Two CTAs share an SM in both.  The other
// admitted shapes (degree 4-6 at chi 8 and 16; degree 2 past chi = 64)
// keep the `mma.sync` kernels, `bp_mode_product_3x` and `bp_pass2_3x`: the
// split made as each tile is stored to shared memory (hi and lo planes of
// the real and imaginary parts, k-major, pitch 72 bf16), fragments by
// `ldmatrix`, `mma.sync.m16n8k16`, each warp a 32 x 16 block of the 64 x 64
// output.  Every route keeps the chunked, in-order reduce, so two calls give
// the same bits.
//
// The limits on k and chi are stated once, in the wrapper's `supports_group`
// (tnqs_torch/ops/bp_sweep.py), and the launch plan (slots u and v, chunk
// sizes, scratch layout) is made there too; this file checks only that the
// arguments are well formed.

#include <cuda.h>  // CUtensorMap; the driver's encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;                  // rows and columns of every shared tile
constexpr int PITCH = TILE + 2;           // float2 per shared row
constexpr int TILE_ELEMS = TILE * PITCH;  // float2 per shared tile
constexpr int THREADS = 256;              // a 16 x 16 grid of 4 x 4 register tiles
constexpr int MAX_DEGREE = 6;             // chi >= 8 and chi^k <= 2^18
constexpr size_t SMEM_MODE = 3 * TILE_ELEMS * sizeof(float2);
constexpr size_t SMEM_PASS2 = 3 * TILE_ELEMS * sizeof(float2);

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}

// acc += a * conj(b)
__device__ __forceinline__ void cmac_conj(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(a.y, b.x, fmaf(-a.x, b.y, acc.y));
}

// this thread's m-th row (or column) of a 64-wide tile: 2 g, 2 g + 1,
// 32 + 2 g, 33 + 2 g for its row (or column) group g in 0..15
__device__ __forceinline__ int lane_index(int g, int m) { return (m < 2 ? 0 : 30) + 2 * g + m; }

// acc[m][n] += sum_{kk < depth} A[kk][row m] * op(B[kk][column n]) over
// k-major shared tiles A and B (op = conj with CONJ_B)
template <bool CONJ_B>
__device__ __forceinline__ void tile_gemm(const float2* __restrict__ As, const float2* __restrict__ Bs, int depth,
                                          float2 (&acc)[4][4]) {
  const float2* a = As + 2 * (threadIdx.x / 16);
  const float2* b = Bs + 2 * (threadIdx.x % 16);
#pragma unroll 8
  for (int kk = 0; kk < depth; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + kk * PITCH);
    const float4 a1 = *reinterpret_cast<const float4*>(a + kk * PITCH + 32);
    const float4 b0 = *reinterpret_cast<const float4*>(b + kk * PITCH);
    const float4 b1 = *reinterpret_cast<const float4*>(b + kk * PITCH + 32);
    const float2 av[4] = {make_float2(a0.x, a0.y), make_float2(a0.z, a0.w), make_float2(a1.x, a1.y),
                          make_float2(a1.z, a1.w)};
    const float2 bv[4] = {make_float2(b0.x, b0.y), make_float2(b0.z, b0.w), make_float2(b1.x, b1.y),
                          make_float2(b1.z, b1.w)};
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (CONJ_B)
          cmac_conj(acc[m][n], av[m], bv[n]);
        else
          cmac(acc[m][n], av[m], bv[n]);
      }
  }
}

__device__ __forceinline__ void zero(float2 (&acc)[4][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = make_float2(0.0f, 0.0f);
}

// dst[r][c] (dst[c][r] with TRANS) = src[r * sr + c * sc] (conjugated with
// CONJ) for r < nr, c < nc; lanes walk r when its stride is 1, else c, so
// the reads coalesce whichever index is contiguous
template <bool TRANS, bool CONJ>
__device__ __forceinline__ void load_tile(float2* dst, const float2* __restrict__ src, long long sr, long long sc,
                                          int nr, int nc) {
  const bool along_r = sr == 1 && sc != 1;
  for (int e = threadIdx.x; e < nr * nc; e += THREADS) {
    const int r = along_r ? e % nr : e / nc;
    const int c = along_r ? e / nr : e % nc;
    float2 x = __ldg(src + r * sr + c * sc);
    if (CONJ) x.y = -x.y;
    dst[TRANS ? c * PITCH + r : r * PITCH + c] = x;
  }
}

// dst[r][c] (dst[c][r] with TRANS) = src[r * sr + c * sc] for r < nr,
// c < nc, 8-byte cp.async copies that the caller commits and waits for;
// lanes walk r when its stride is 1, else c, so the reads coalesce
template <bool TRANS>
__device__ __forceinline__ void copy_tile_async(float2* dst, const float2* __restrict__ src, long long sr,
                                                long long sc, int nr, int nc) {
  const bool along_r = sr == 1 && sc != 1;
  for (int e = threadIdx.x; e < nr * nc; e += THREADS) {
    const int r = along_r ? e % nr : e / nc;
    const int c = along_r ? e / nr : e % nc;
    const unsigned to = (unsigned)__cvta_generic_to_shared(dst + (TRANS ? c * PITCH + r : r * PITCH + c));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(to), "l"(src + r * sr + c * sc));
  }
}

__device__ __forceinline__ void async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ __forceinline__ long long ipow(int base, int e) {
  long long p = 1;
  for (int c = 0; c < e; ++c) p *= base;
  return p;
}

// the bucket row of group entry b, or b itself for the group's own scratch
__device__ __forceinline__ long long source_row(const long long* rows, int b, int n_k) {
  if (rows == nullptr) return b;
  const long long row = rows[b];
  if (row < 0 || row >= n_k) __trap();  // a row outside the bucket
  return row;
}

// Bs[p][c] = in[p@slot, r0 + c], p < chi, c < 64, by cp.async in one
// committed group; the other slots' index r sits at offset (r / st) st chi
// + r % st, st the contracted slot's stride
__device__ __forceinline__ void copy_columns_async(float2* Bs, const float2* __restrict__ src, int chi, int st,
                                                   int r0) {
  const bool along_p = st == 1;
  for (int e = threadIdx.x; e < chi * TILE; e += THREADS) {
    const int p = along_p ? e % chi : e / TILE;
    const int c = along_p ? e / chi : e % TILE;
    const int r = r0 + c;
    const unsigned to = (unsigned)__cvta_generic_to_shared(Bs + p * PITCH + c);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(to), "l"(src + p * st + (r / st) * st * chi + r % st));
  }
  async_commit();
}

// out[b, s] = in[row b, s] x_slot A: with CONJ_T out[.., x@slot, ..] =
// sum_p conj(M[x, p]) in[.., p@slot, ..] (the bra side, V), else
// out[.., y@slot, ..] = sum_x in[.., x@slot, ..] M[x, y] (a ket absorb);
// M = Min[b, col].  As a GEMM per (b, s): C[x, r] = sum_p A[x, p] In[p, r]
// over the chi^(k-1) columns r of the other slots, in 64-column blocks,
// the next block's copy in flight during this one's product; grid
// (column-block chunks, d, B), `per_cta` blocks a CTA.
__global__ void __launch_bounds__(THREADS, 2)
    bp_mode_product(const float2* __restrict__ in, const long long* __restrict__ in_rows,
                    const float2* __restrict__ Min, float2* __restrict__ out, int n_k, int k, int chi, int d,
                    int slot, int col, int conj_t, int per_cta) {
  extern __shared__ float4 smem_f4[];
  float2* As = reinterpret_cast<float2*>(smem_f4);  // then two column buffers
  const int b = blockIdx.z, s = blockIdx.y;
  const int site = (int)ipow(chi, k);
  const int st = (int)ipow(chi, k - 1 - slot);  // stride of the contracted slot
  const int nrb = site / chi / TILE;           // chi^(k-1) is a multiple of 64
  const float2* src = in + ((size_t)source_row(in_rows, b, n_k) * d + s) * site;
  float2* dst = out + ((size_t)b * d + s) * site;
  const float2* M = Min + ((size_t)b * (k - 1) + col) * chi * chi;
  const int rb0 = blockIdx.x * per_cta, rb1 = min(nrb, rb0 + per_cta);
  copy_columns_async(As + TILE_ELEMS, src, chi, st, rb0 * TILE);
  if (conj_t)
    load_tile<true, true>(As, M, chi, 1, chi, chi);  // As[p][x] = conj(M[x][p])
  else
    load_tile<false, false>(As, M, chi, 1, chi, chi);  // As[x][y] = M[x][y]
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  for (int rb = rb0; rb < rb1; ++rb) {
    float2* Bs = As + (1 + ((rb - rb0) & 1)) * TILE_ELEMS;
    if (rb + 1 < rb1) {  // the other buffer, free since the last block's barrier
      copy_columns_async(As + (2 - ((rb - rb0) & 1)) * TILE_ELEMS, src, chi, st, (rb + 1) * TILE);
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();
    float2 acc[4][4];
    zero(acc);
    tile_gemm<false>(As, Bs, chi, acc);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int x = lane_index(tm, m);
      if (x >= chi) continue;
#pragma unroll
      for (int n = 0; n < 4; n += 2) {  // columns r, r + 1: adjacent unless st == 1
        const int r = rb * TILE + lane_index(tn, n);
        float2* o = dst + x * st + (r / st) * st * chi + r % st;
        if (st > 1) {
          *reinterpret_cast<float4*>(o) = make_float4(acc[m][n].x, acc[m][n].y, acc[m][n + 1].x, acc[m][n + 1].y);
        } else {
          o[0] = acc[m][n];
          o[chi] = acc[m][n + 1];
        }
      }
    }
    __syncthreads();  // Bs is rewritten two blocks on
  }
}

// One CTA: message b, the chunk of its (s, o) items [chunk * per_cta, ...),
// output block (ib, jb) of 64 x 64.  Per item K = ket[b, s] and V = vt[b, s]
// at the offset of o (the slots other than t and v, ascending, the last
// fastest):
//   W[i, q] = sum_y K[i@t, y@v] M_v[y, q],  P[i, j] += sum_q W[i, q] conj(V[j@t, q@v]).
// P goes to dst[b, chunk] ([B, chunks, chi, chi]; with one chunk that is
// the output).  WIDE (chi > 64, degree 2 only) walks 64-blocks of i and j
// over the grid and of y and q in the CTA, reloading M_v's blocks, with one
// CTA an SM (the block loops need more than 128 registers); else M_v stays
// in shared memory for the whole CTA.
template <bool WIDE>
__global__ void __launch_bounds__(THREADS, WIDE ? 1 : 2)
    bp_pass2(const float2* __restrict__ ket, const long long* __restrict__ ket_rows, const float2* __restrict__ vt,
             const long long* __restrict__ v_rows, const float2* __restrict__ Min, float2* __restrict__ dst,
             int n_k, int k, int chi, int d, int t, int v, int per_cta, int chunks) {
  extern __shared__ float4 smem_f4[];
  float2* Ms = reinterpret_cast<float2*>(smem_f4);
  float2* KW = Ms + TILE_ELEMS;  // K's tile, then W's
  float2* Vs = KW + TILE_ELEMS;
  const int nblk = WIDE ? (chi + TILE - 1) / TILE : 1;
  const int b = blockIdx.y;
  const int chunk = blockIdx.x / (nblk * nblk);
  const int i0 = WIDE ? (blockIdx.x / nblk) % nblk * TILE : 0, j0 = WIDE ? blockIdx.x % nblk * TILE : 0;
  const int ni = min(TILE, chi - i0), nj = min(TILE, chi - j0);
  const int site = (int)ipow(chi, k);
  const int st_t = (int)ipow(chi, k - 1 - t), st_v = (int)ipow(chi, k - 1 - v);
  const int O = (int)ipow(chi, k - 2);  // values of the outer slots
  const float2* ket_b = ket + (size_t)source_row(ket_rows, b, n_k) * d * site;
  const float2* vt_b = vt + (size_t)source_row(v_rows, b, n_k) * d * site;
  const float2* Mv = Min + ((size_t)b * (k - 1) + (v < t ? v : v - 1)) * chi * chi;
  if (!WIDE) load_tile<false, false>(Ms, Mv, chi, 1, chi, chi);  // Ms[y][q] = M_v[y][q], for the whole CTA

  float2 P[4][4];
  zero(P);
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  const int it1 = min(d * O, (chunk + 1) * per_cta);
  for (int it = chunk * per_cta; it < it1; ++it) {
    int o = it % O, off = (it / O) * site;
    for (int j = k - 1; j >= 0; --j) {  // o's digits, the last outer slot fastest
      if (j == t || j == v) continue;
      off += (o % chi) * (int)ipow(chi, k - 1 - j);
      o /= chi;
    }
    const int span = WIDE ? chi : 1;  // one block of q and y unless WIDE
    for (int q0 = 0; q0 < span; q0 += TILE) {
      const int nq = WIDE ? min(TILE, chi - q0) : chi;
      float2 W[4][4];
      zero(W);
      for (int y0 = 0; y0 < span; y0 += TILE) {
        const int ny = WIDE ? min(TILE, chi - y0) : chi;
        if (WIDE) copy_tile_async<false>(Ms, Mv + (size_t)y0 * chi + q0, chi, 1, ny, nq);
        copy_tile_async<true>(KW, ket_b + off + i0 * st_t + y0 * st_v, st_t, st_v, ni, ny);  // KW[y][i] = K[i][y]
        async_commit();
        if (!WIDE || y0 + TILE >= chi) {  // V's tile lands while W's product runs
          copy_tile_async<true>(Vs, vt_b + off + j0 * st_t + q0 * st_v, st_t, st_v, nj, nq);  // Vs[q][j] = V[j][q]
          async_commit();
          async_wait<1>();
        } else {
          async_wait<0>();
        }
        __syncthreads();
        tile_gemm<false>(KW, Ms, ny, W);
        __syncthreads();  // KW (and Ms when WIDE) are rewritten next
      }
      // KW[q][i] = W[i][q], in pairs of rows
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float2* w = KW + lane_index(tn, n) * PITCH + 2 * tm;
        *reinterpret_cast<float4*>(w) = make_float4(W[0][n].x, W[0][n].y, W[1][n].x, W[1][n].y);
        *reinterpret_cast<float4*>(w + 32) = make_float4(W[2][n].x, W[2][n].y, W[3][n].x, W[3][n].y);
      }
      async_wait<0>();
      __syncthreads();
      tile_gemm<true>(KW, Vs, nq, P);
      __syncthreads();  // KW and Vs are rewritten for the next item
    }
  }
  float2* out = dst + ((size_t)b * chunks + chunk) * chi * chi;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = lane_index(tm, m);
    if (i >= ni) continue;
#pragma unroll
    for (int n = 0; n < 4; n += 2) {  // columns j, j + 1, both inside since nj % 8 == 0
      const int j = lane_index(tn, n);
      if (j < nj)
        *reinterpret_cast<float4*>(out + (size_t)(i0 + i) * chi + j0 + j) =
            make_float4(P[m][n].x, P[m][n].y, P[m][n + 1].x, P[m][n + 1].y);
    }
  }
}

// out[b] = sum over c = 0, 1, ... of part[b, c], in that order
__global__ void bp_reduce(const float2* __restrict__ part, float2* __restrict__ out, int chunks, int per_msg,
                          long long total) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const float2* p = part + (e / per_msg) * chunks * per_msg + e % per_msg;
    float2 acc = p[0];
    for (int c = 1; c < chunks; ++c) {
      acc.x += p[(size_t)c * per_msg].x;
      acc.y += p[(size_t)c * per_msg].y;
    }
    out[e] = acc;
  }
}

// ---------------------------------------------------------------------
// bf16_3x mode on mma.sync (degree >= 4, or chi > 64)
// ---------------------------------------------------------------------

constexpr int PITCH_H = TILE + 8;         // bf16 per plane row (144 bytes)
constexpr int PLANE = TILE * PITCH_H;     // bf16 per plane: 64 depth rows
constexpr int SPLIT_ELEMS = 4 * PLANE;    // planes re hi, im hi, re lo, im lo
constexpr size_t SPLIT_BYTES = SPLIT_ELEMS * sizeof(__nv_bfloat16);
constexpr size_t SMEM_MODE_3X = 2 * SPLIT_BYTES;   // the message, one column block
constexpr size_t SMEM_PASS2_3X = 3 * SPLIT_BYTES;  // M_v, K then W, V
constexpr unsigned NEG2 = 0x80008000u;    // flips the sign of both bf16 halves

__device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }

// row r, column c of a split tile <- x: hi = bf16(x), lo = bf16(x - hi),
// each rounded to nearest even (x - hi is exact in float32)
__device__ __forceinline__ void put_split(__nv_bfloat16* tile, int r, int c, float2 x) {
  const int at = r * PITCH_H + c;
  const __nv_bfloat16 hr = __float2bfloat16_rn(x.x), hi = __float2bfloat16_rn(x.y);
  tile[at] = hr;
  tile[PLANE + at] = hi;
  tile[2 * PLANE + at] = __float2bfloat16_rn(x.x - __bfloat162float(hr));
  tile[3 * PLANE + at] = __float2bfloat16_rn(x.y - __bfloat162float(hi));
}

// rows [r0, r1) of every plane to zero: the depth padding up to a multiple of
// 16, so the padded products add nothing (both operands are zeroed, never
// left as whatever the shared memory held)
__device__ __forceinline__ void zero_split_rows(__nv_bfloat16* tile, int r0, int r1) {
  const int per = (r1 - r0) * PITCH_H;
  for (int e = threadIdx.x; e < 4 * per; e += THREADS)
    tile[(e / per) * PLANE + r0 * PITCH_H + e % per] = __float2bfloat16_rn(0.0f);
}

// the split of load_tile: dst[r][c] (dst[c][r] with TRANS) = src[r * sr +
// c * sc] (conjugated with CONJ), then the depth rows up to a multiple of 16
// zeroed
template <bool TRANS, bool CONJ>
__device__ __forceinline__ void load_split_tile(__nv_bfloat16* dst, const float2* __restrict__ src, long long sr,
                                                long long sc, int nr, int nc) {
  const bool along_r = sr == 1 && sc != 1;
  for (int e = threadIdx.x; e < nr * nc; e += THREADS) {
    const int r = along_r ? e % nr : e / nc;
    const int c = along_r ? e / nr : e % nc;
    float2 x = __ldg(src + r * sr + c * sc);
    if (CONJ) x.y = -x.y;
    if (TRANS)
      put_split(dst, c, r, x);
    else
      put_split(dst, r, c, x);
  }
  const int depth = TRANS ? nc : nr;
  zero_split_rows(dst, depth, pad16(depth));
}

// the split of copy_columns_async: Bs[p][c] = in[p@slot, r0 + c], p < chi,
// c < 64, and the depth rows up to a multiple of 16 zeroed
__device__ __forceinline__ void load_split_columns(__nv_bfloat16* Bs, const float2* __restrict__ src, int chi, int st,
                                                   int r0) {
  const bool along_p = st == 1;
  for (int e = threadIdx.x; e < chi * TILE; e += THREADS) {
    const int p = along_p ? e % chi : e / TILE;
    const int c = along_p ? e / chi : e % TILE;
    const int r = r0 + c;
    put_split(Bs, p, c, __ldg(src + p * st + (r / st) * st * chi + r % st));
  }
  zero_split_rows(Bs, chi, pad16(chi));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a b over one 16 x 8 x 16 block, bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += x y by the three bf16 products, the small ones first:
// xl yh + xh yl + xh yh; `flip` negates x (a sign flip is exact)
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&xh)[4], const unsigned (&xl)[4], unsigned flip,
                                     unsigned yh0, unsigned yh1, unsigned yl0, unsigned yl1) {
  mma_bf16(c, xl[0] ^ flip, xl[1] ^ flip, xl[2] ^ flip, xl[3] ^ flip, yh0, yh1);
  mma_bf16(c, xh[0] ^ flip, xh[1] ^ flip, xh[2] ^ flip, xh[3] ^ flip, yl0, yl1);
  mma_bf16(c, xh[0] ^ flip, xh[1] ^ flip, xh[2] ^ flip, xh[3] ^ flip, yh0, yh1);
}

// a warp's share of a 64 x 64 complex output: rows 32 (warp / 4) + 16 mt +
// {g, g + 8}, columns 16 (warp % 4) + 8 nt + 2 t + {0, 1} (g = lane / 4,
// t = lane % 4), the mma.sync accumulator layout
struct Acc3 {
  float re[2][2][4];
  float im[2][2][4];
};

__device__ __forceinline__ void zero3(Acc3& acc) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.re[mt][nt][e] = acc.im[mt][nt][e] = 0.0f;
}

// f(row, column, value) for each of this thread's outputs
template <class F>
__device__ __forceinline__ void visit3(const Acc3& acc, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = 32 * (warp >> 2) + (lane >> 2), c0 = 16 * (warp & 3) + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(r0 + 16 * mt + 8 * (e >> 1), c0 + 8 * nt + (e & 1), make_float2(acc.re[mt][nt][e], acc.im[mt][nt][e]));
}

// acc[m][n] += sum_{kk < depth} A[kk][m] op(B[kk][n]) over k-major split
// tiles (op = conj with CONJ_B); depth a multiple of 16 with zeroed padding
template <bool CONJ_B>
__device__ __forceinline__ void tile_gemm3(const __nv_bfloat16* __restrict__ As, const __nv_bfloat16* __restrict__ Bs,
                                           int depth, Acc3& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = 32 * (warp >> 2), n0 = 16 * (warp & 3);
  // ldmatrix: lane supplies row (lane % 8) of matrix (lane / 8); A's four
  // matrices are (k, m) blocks (0, 0), (0, 8), (8, 0), (8, 8), B's (k, n)
  // blocks (0, 0), (8, 0), (0, 8), (8, 8): the a0..a3 and b0, b1 registers
  const int q = lane >> 3, r = lane & 7;
  const int a_off = (r + ((q >> 1) << 3)) * PITCH_H + m0 + ((q & 1) << 3);
  const int b_off = (r + ((q & 1) << 3)) * PITCH_H + n0 + ((q >> 1) << 3);
  for (int k0 = 0; k0 < depth; k0 += 16) {
    unsigned b[4][4];  // planes re hi, im hi, re lo, im lo; {b0, b1} of n block 0, then of n block 1
#pragma unroll
    for (int p = 0; p < 4; ++p) ldsm_x4_trans(b[p], Bs + p * PLANE + k0 * PITCH_H + b_off);
    if (CONJ_B) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        b[1][e] ^= NEG2;
        b[3][e] ^= NEG2;
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      unsigned a[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) ldsm_x4_trans(a[p], As + p * PLANE + k0 * PITCH_H + 16 * mt + a_off);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = 2 * nt;
        // re += Ar Br - Ai Bi, im += Ar Bi + Ai Br
        mma3(acc.re[mt][nt], a[0], a[2], 0u, b[0][j], b[0][j + 1], b[2][j], b[2][j + 1]);
        mma3(acc.re[mt][nt], a[1], a[3], NEG2, b[1][j], b[1][j + 1], b[3][j], b[3][j + 1]);
        mma3(acc.im[mt][nt], a[0], a[2], 0u, b[1][j], b[1][j + 1], b[3][j], b[3][j + 1]);
        mma3(acc.im[mt][nt], a[1], a[3], 0u, b[0][j], b[0][j + 1], b[2][j], b[2][j + 1]);
      }
    }
  }
}

// bp_mode_product in bf16_3x: the same product per (b, s) and column block,
// the message split once a CTA, each column block split as it is stored
__global__ void __launch_bounds__(THREADS, 2)
    bp_mode_product_3x(const float2* __restrict__ in, const long long* __restrict__ in_rows,
                       const float2* __restrict__ Min, float2* __restrict__ out, int n_k, int k, int chi, int d,
                       int slot, int col, int conj_t, int per_cta) {
  extern __shared__ float4 smem_f4[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_f4);
  __nv_bfloat16* Bs = As + SPLIT_ELEMS;
  const int b = blockIdx.z, s = blockIdx.y;
  const int site = (int)ipow(chi, k);
  const int st = (int)ipow(chi, k - 1 - slot);
  const int nrb = site / chi / TILE;
  const float2* src = in + ((size_t)source_row(in_rows, b, n_k) * d + s) * site;
  float2* dst = out + ((size_t)b * d + s) * site;
  const float2* M = Min + ((size_t)b * (k - 1) + col) * chi * chi;
  const int rb0 = blockIdx.x * per_cta, rb1 = min(nrb, rb0 + per_cta);
  if (conj_t)
    load_split_tile<true, true>(As, M, chi, 1, chi, chi);  // As[p][x] = conj(M[x][p])
  else
    load_split_tile<false, false>(As, M, chi, 1, chi, chi);  // As[x][y] = M[x][y]
  for (int rb = rb0; rb < rb1; ++rb) {
    __syncthreads();  // the last block's product is done with Bs
    load_split_columns(Bs, src, chi, st, rb * TILE);
    __syncthreads();
    Acc3 acc;
    zero3(acc);
    tile_gemm3<false>(As, Bs, pad16(chi), acc);
    visit3(acc, [&](int x, int c, float2 v) {
      if (x < chi) {
        const int r = rb * TILE + c;
        dst[x * st + (r / st) * st * chi + r % st] = v;
      }
    });
  }
}

// bp_pass2 in bf16_3x: the same items, blocks and chunks; M_v, K and V split
// as they are stored, W split as it is written back transposed
template <bool WIDE>
__global__ void __launch_bounds__(THREADS, WIDE ? 1 : 2)
    bp_pass2_3x(const float2* __restrict__ ket, const long long* __restrict__ ket_rows,
                const float2* __restrict__ vt, const long long* __restrict__ v_rows, const float2* __restrict__ Min,
                float2* __restrict__ dst, int n_k, int k, int chi, int d, int t, int v, int per_cta, int chunks) {
  extern __shared__ float4 smem_f4[];
  __nv_bfloat16* Ms = reinterpret_cast<__nv_bfloat16*>(smem_f4);
  __nv_bfloat16* KW = Ms + SPLIT_ELEMS;  // K's tile, then W's
  __nv_bfloat16* Vs = KW + SPLIT_ELEMS;
  const int nblk = WIDE ? (chi + TILE - 1) / TILE : 1;
  const int b = blockIdx.y;
  const int chunk = blockIdx.x / (nblk * nblk);
  const int i0 = WIDE ? (blockIdx.x / nblk) % nblk * TILE : 0, j0 = WIDE ? blockIdx.x % nblk * TILE : 0;
  const int ni = min(TILE, chi - i0), nj = min(TILE, chi - j0);
  const int site = (int)ipow(chi, k);
  const int st_t = (int)ipow(chi, k - 1 - t), st_v = (int)ipow(chi, k - 1 - v);
  const int O = (int)ipow(chi, k - 2);
  const float2* ket_b = ket + (size_t)source_row(ket_rows, b, n_k) * d * site;
  const float2* vt_b = vt + (size_t)source_row(v_rows, b, n_k) * d * site;
  const float2* Mv = Min + ((size_t)b * (k - 1) + (v < t ? v : v - 1)) * chi * chi;
  if (!WIDE) load_split_tile<false, false>(Ms, Mv, chi, 1, chi, chi);  // Ms[y][q] = M_v[y][q]

  Acc3 P;
  zero3(P);
  const int it1 = min(d * O, (chunk + 1) * per_cta);
  for (int it = chunk * per_cta; it < it1; ++it) {
    int o = it % O, off = (it / O) * site;
    for (int j = k - 1; j >= 0; --j) {
      if (j == t || j == v) continue;
      off += (o % chi) * (int)ipow(chi, k - 1 - j);
      o /= chi;
    }
    const int span = WIDE ? chi : 1;
    for (int q0 = 0; q0 < span; q0 += TILE) {
      const int nq = WIDE ? min(TILE, chi - q0) : chi;
      Acc3 W;
      zero3(W);
      for (int y0 = 0; y0 < span; y0 += TILE) {
        const int ny = WIDE ? min(TILE, chi - y0) : chi;
        __syncthreads();  // KW (and Ms when WIDE) are free
        if (WIDE) load_split_tile<false, false>(Ms, Mv + (size_t)y0 * chi + q0, chi, 1, ny, nq);
        load_split_tile<true, false>(KW, ket_b + off + i0 * st_t + y0 * st_v, st_t, st_v, ni, ny);  // KW[y][i]
        __syncthreads();
        tile_gemm3<false>(KW, Ms, pad16(ny), W);
      }
      __syncthreads();  // KW and Vs are free
      visit3(W, [&](int i, int q, float2 w) {  // KW[q][i] = W[i][q]
        if (q < nq) put_split(KW, q, i, w);
      });
      zero_split_rows(KW, nq, pad16(nq));
      load_split_tile<true, false>(Vs, vt_b + off + j0 * st_t + q0 * st_v, st_t, st_v, nj, nq);  // Vs[q][j]
      __syncthreads();
      tile_gemm3<true>(KW, Vs, pad16(nq), P);
    }
  }
  float2* out = dst + ((size_t)b * chunks + chunk) * chi * chi;
  visit3(P, [&](int i, int j, float2 p) {
    if (i < ni && j < nj) out[(size_t)(i0 + i) * chi + j0 + j] = p;
  });
}

// ---------------------------------------------------------------------
// bf16_3x on Hopper's tensor cores: wgmma fed by TMA (k <= 3, chi <= 64)
// ---------------------------------------------------------------------

constexpr int TC_THREADS = 160;                    // pass 1: a consumer warpgroup, then a producer warp
constexpr int TC_PASS2_THREADS = 128;              // pass 2: the warpgroup alone
constexpr int TC_PLANE_BYTES = TILE * TILE * 2;    // a 64 x 64 bf16 plane, rows of 128 bytes
constexpr int TC_TILE_BYTES = 4 * TC_PLANE_BYTES;  // planes re hi, im hi, re lo, im lo: 32 KB
constexpr int TC_STAGES = 2;                       // the ring of tiles TMA fills
// 1024 bytes of slack to align the tiles (the 128-byte swizzle repeats every
// 1024), the CTA's message tile, the ring, and the ring's full and empty
// mbarriers
constexpr size_t SMEM_TC = 1024 + (1 + TC_STAGES) * TC_TILE_BYTES + 2 * TC_STAGES * 8;
// a plane's offset and a k16 step's in a wgmma descriptor's address field
// (16-byte units): 8192 bytes a plane; 32 bytes along a row (K-major), 16
// rows of 128 bytes (MN-major)
constexpr unsigned long long DESC_PLANE = TC_PLANE_BYTES >> 4;
constexpr unsigned long long DESC_K_ROW = 32 >> 4;
constexpr unsigned long long DESC_K_ROWS = 2048 >> 4;

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the phase of parity `parity` of the mbarrier at `bar`; a wait far
// longer than any tile load traps rather than hangs.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 24)) __trap();
  }
}

// the consumer warpgroup's own barrier (the producer warp never joins it)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 128;" ::: "memory"); }

// generic-proxy writes to shared memory made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// the box of `map` at coordinates c0..c4 into shared memory at `dst`, its
// bytes counted against the mbarrier at `bar`
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, unsigned bar, int c0, int c1, int c2,
                                         int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], "
      "[%7];" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// shared memory at `src` into the box of `map` at c0..c4 (the part of the box
// inside the tensor), in a bulk group of this thread
__device__ __forceinline__ void tma_store(const CUtensorMap* map, unsigned src, int c0, int c1, int c2, int c3,
                                          int c4) {
  asm volatile("cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];" ::"l"(
                   reinterpret_cast<unsigned long long>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// (x0, x1) -> hi and lo bf16 pairs, each rounded to nearest even, x0 in the
// low half (the lower column, or the lower depth index of a fragment)
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// byte offset of row r, column c of a 64 x 64 bf16 plane in the 128-byte
// swizzle that TMA writes and wgmma reads: 16-byte chunk c / 8 of row r sits
// at chunk (c / 8) ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1)); }

// the four split planes of message M [chi, chi] into `tile` (row r, column c
// = M[r, c]), zero past chi, by the 128 consumer threads
__device__ __forceinline__ void put_message(unsigned char* tile, const float2* __restrict__ M, int chi) {
  float4 m[16];  // every load in flight at once: the tile loads of the ring wait on this
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int e = threadIdx.x + 128 * q, r = e >> 5, c = 2 * (e & 31);
    m[q] = r < chi && c < chi ? __ldg(reinterpret_cast<const float4*>(M + (size_t)r * chi + c))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int e = threadIdx.x + 128 * q, r = e >> 5, c = 2 * (e & 31);
    unsigned rh, rl, ih, il;
    split2(m[q].x, m[q].z, rh, rl);
    split2(m[q].y, m[q].w, ih, il);
    const int at = swz(r, c);
    *reinterpret_cast<unsigned*>(tile + at) = rh;
    *reinterpret_cast<unsigned*>(tile + TC_PLANE_BYTES + at) = ih;
    *reinterpret_cast<unsigned*>(tile + 2 * TC_PLANE_BYTES + at) = rl;
    *reinterpret_cast<unsigned*>(tile + 3 * TC_PLANE_BYTES + at) = il;
  }
}

// the wgmma descriptor of a 64 x 64 bf16 plane at shared address `addr`
// (1024-byte aligned) in the 128-byte swizzle: 8-row groups 1024 bytes apart
// (K-major: rows along M or N; MN-major: rows along K); the leading offset is
// unused for a 64-wide tile
__device__ __forceinline__ unsigned long long wg_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wg_begin() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }

// commit the products issued since `wg_begin` and wait for them
__device__ __forceinline__ void wg_end() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

#define TNQS_WG_D32(d)                                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),      \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),        \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define TNQS_WG_REGS32                                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"

// d += SA a b, a 64 x 16 and b 16 x 64 bf16 from shared memory (descriptors;
// TA, TB: MN-major), float32 accumulation; m64n64k16
template <int SA, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], unsigned long long a, unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TNQS_WG_REGS32 ", %32, %33, p, %35, 1, %36, %37;\n}\n"
      : TNQS_WG_D32(d)
      : "l"(a), "l"(b), "r"(1), "n"(SA), "n"(TA), "n"(TB));
}

// d += SA a b, a from registers (the m16k16 fragment of each warp's 16 rows),
// b from shared memory
template <int SA, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4], unsigned long long b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TNQS_WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, %38, 1, %39;\n}\n"
      : TNQS_WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(SA), "n"(TB));
}

// d += SA x y by the three bf16 products, the small ones first: xl yh, xh yl,
// xh yh (x, y by their hi and lo planes' descriptors)
template <int SA, int TA, int TB>
__device__ __forceinline__ void mma3_ss(float (&d)[32], unsigned long long xh, unsigned long long xl,
                                        unsigned long long yh, unsigned long long yl) {
  wgmma_ss<SA, TA, TB>(d, xl, yh);
  wgmma_ss<SA, TA, TB>(d, xh, yl);
  wgmma_ss<SA, TA, TB>(d, xh, yh);
}

template <int SA, int TB>
__device__ __forceinline__ void mma3_rs(float (&d)[32], const unsigned (&xh)[4], const unsigned (&xl)[4],
                                        unsigned long long yh, unsigned long long yl) {
  wgmma_rs<SA, TB>(d, xl, yh);
  wgmma_rs<SA, TB>(d, xh, yl);
  wgmma_rs<SA, TB>(d, xh, yh);
}

__device__ __forceinline__ void zero32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
}

// The CTA's shared memory: the message tile, the ring, then the mbarriers
// (full[stage], empty[stage]).
struct TcSmem {
  unsigned char* msg;
  unsigned char* ring;
  unsigned full, empty;
};

__device__ __forceinline__ TcSmem tc_smem(unsigned char* raw, unsigned empty_count) {
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  TcSmem sm;
  sm.msg = base;
  sm.ring = base + TC_TILE_BYTES;
  sm.full = smem_u32(base + (1 + TC_STAGES) * TC_TILE_BYTES);
  sm.empty = sm.full + 8 * TC_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, empty_count);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return sm;
}

// Pass 1 on the tensor cores (k = 3): V = K x_u conj(M_u), split.  A unit is
// one value o of the slot that is neither u nor the last:
//   C[x, n] = sum_p conj(M_u[x, p]) K[s, p@u, o, n@last],
// its 64 x 64 tile of K's planes brought by TMA (zero past chi), conj(M_u)
// split into the CTA's shared memory once (the sign of its imaginary part
// taken in the products), C split in registers and stored by TMA into V's
// planes from the tile it was computed from.  Grid (unit chunks, d, B),
// `per_cta` units a CTA.
__global__ void __launch_bounds__(TC_THREADS, 2)
    bp_bra_tc(const __grid_constant__ CUtensorMap src, const __grid_constant__ CUtensorMap dst,
              const long long* __restrict__ rows, const float2* __restrict__ Min, int n_k, int chi, int d, int u,
              int col, int per_cta) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const TcSmem sm = tc_smem(smem_tc, 1);
  const int b = blockIdx.z, s = blockIdx.y;
  const int i0 = blockIdx.x * per_cta, i1 = min(chi, i0 + per_cta);
  // slot j is dimension 2 - j of the maps; u is 0 or 1, the other of the two
  // (dimension 1 + u) is the unit's slot
  const int dother = 1 + u;
  if (threadIdx.x >= 128) {  // the producer warp: one thread issues every tile load
    if (threadIdx.x == 128) {
      const int row = (int)(source_row(rows, b, n_k) * d + s);
      for (int i = i0, n = 0; i < i1; ++i, ++n) {
        const int st = n % TC_STAGES;
        mbar_wait(sm.empty + 8 * st, ((n / TC_STAGES) & 1) ^ 1);
        mbar_expect(sm.full + 8 * st, TC_TILE_BYTES);
        tma_load(smem_u32(sm.ring + st * TC_TILE_BYTES), &src, sm.full + 8 * st, 0, dother == 1 ? i : 0,
                 dother == 2 ? i : 0, row, 0);
      }
    }
    return;
  }
  put_message(sm.msg, Min + ((size_t)b * 2 + col) * chi * chi, chi);
  fence_async_smem();
  consumers_sync();
  const unsigned long long a0 = wg_desc(smem_u32(sm.msg));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = i0, n = 0; i < i1; ++i, ++n) {
    const int st = n % TC_STAGES;
    unsigned char* tile = sm.ring + st * TC_TILE_BYTES;
    mbar_wait(sm.full + 8 * st, (n / TC_STAGES) & 1);
    float cr[32], ci[32];
    zero32(cr);
    zero32(ci);
    wg_fence(cr);
    wg_fence(ci);
    wg_begin();
    const unsigned long long b0 = wg_desc(smem_u32(tile));
    // the whole depth of 64 (the rows past chi are zero in both operands):
    // no branch between the products
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A = M_u (K-major), B = K's tile [p][n] (MN-major); Cr += Mr Kr + Mi
      // Ki, Ci += Mr Ki - Mi Kr
      const unsigned long long a = a0 + DESC_K_ROW * kk, bb = b0 + DESC_K_ROWS * kk;
      mma3_ss<1, 0, 1>(cr, a, a + 2 * DESC_PLANE, bb, bb + 2 * DESC_PLANE);
      mma3_ss<1, 0, 1>(cr, a + DESC_PLANE, a + 3 * DESC_PLANE, bb + DESC_PLANE, bb + 3 * DESC_PLANE);
      mma3_ss<1, 0, 1>(ci, a, a + 2 * DESC_PLANE, bb + DESC_PLANE, bb + 3 * DESC_PLANE);
      mma3_ss<-1, 0, 1>(ci, a + DESC_PLANE, a + 3 * DESC_PLANE, bb, bb + 2 * DESC_PLANE);
    }
    wg_end();
    wg_fence(cr);
    wg_fence(ci);
    consumers_sync();  // every warp's products have read the tile
    // C's split planes over the tile, in the swizzle the store reads
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned rh, rl, ih, il;
        split2(cr[4 * c + 2 * h], cr[4 * c + 2 * h + 1], rh, rl);
        split2(ci[4 * c + 2 * h], ci[4 * c + 2 * h + 1], ih, il);
        const int at = swz(16 * warp + g + 8 * h, 8 * c + 2 * t4);
        *reinterpret_cast<unsigned*>(tile + at) = rh;
        *reinterpret_cast<unsigned*>(tile + TC_PLANE_BYTES + at) = ih;
        *reinterpret_cast<unsigned*>(tile + 2 * TC_PLANE_BYTES + at) = rl;
        *reinterpret_cast<unsigned*>(tile + 3 * TC_PLANE_BYTES + at) = il;
      }
    fence_async_smem();
    consumers_sync();
    if (threadIdx.x == 0) {
      tma_store(&dst, smem_u32(tile), 0, dother == 1 ? i : 0, dother == 2 ? i : 0, b * d + s, 0);
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // the tile is read: refill it
      mbar_arrive(sm.empty + 8 * st);
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Pass 2 on the tensor cores (k = 2, 3): per item (s, o), o the value of the
// slot that is neither t nor v (k = 3),
//   W[i, q] = sum_y K[i@t, y@v] M_v[y, q],  P[i, j] += sum_q W[i, q] conj(V[j@t, q@v]),
// K's and V's tiles brought by TMA into a ring of two stages (k = 2: V is K,
// one tile an item), M_v split into the CTA's shared memory once; W stays in
// registers: its float32 accumulator, split into bf16 hi and lo, is the
// register operand of W V^H.  One warpgroup, no producer warp: with two
// stages a tile load can start only once the CTA is done with the tile two
// before it, so thread 0 issues it then, and the CTA keeps the 255 registers
// two CTAs of 128 threads may use (five warps would cap it at 168 and spill).
// T_INNER: t is the last slot, so K's and V's tiles are MN-major operands.
// P goes to dst[b, chunk] as in `bp_pass2`.
template <bool T_INNER>
__global__ void __launch_bounds__(TC_PASS2_THREADS, 2)
    bp_pass2_tc(const __grid_constant__ CUtensorMap ket, const __grid_constant__ CUtensorMap bra,
                const long long* __restrict__ rows, const float2* __restrict__ Min, float2* __restrict__ dst,
                int n_k, int k, int chi, int d, int t, int v, int per_cta, int chunks) {
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const TcSmem sm = tc_smem(smem_tc, 1);  // the empty mbarriers stay unused
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int O = k == 3 ? chi : 1;
  const int it0 = chunk * per_cta, it1 = min(d * O, it0 + per_cta);
  const int per_item = k == 3 ? 2 : 1, tiles = (it1 - it0) * per_item;
  // slot j is dimension k - 1 - j of the maps; the third slot (k = 3) is
  // dimension t + v - 1 (1 or 2: one of t, v is the last slot); k = 2's unit
  // dimension 2 stays at 0
  const int dother = k == 3 ? t + v - 1 : 2;
  const int krow = threadIdx.x == 0 ? (int)(source_row(rows, b, n_k) * d) : 0;
  // tile n of the CTA (item n / per_item; K's, then V's at k = 3) into stage n % 2
  auto load = [&](int n) {
    if (n >= tiles) return;
    const int it = it0 + n / per_item, s = it / O, o = it % O;
    const int c1 = dother == 1 ? o : 0, c2 = dother == 2 ? o : 0;
    const int st = n % TC_STAGES;
    const unsigned to = smem_u32(sm.ring + st * TC_TILE_BYTES);
    mbar_expect(sm.full + 8 * st, TC_TILE_BYTES);
    if (n % per_item == 0)
      tma_load(to, &ket, sm.full + 8 * st, 0, c1, c2, krow + s, 0);
    else
      tma_load(to, &bra, sm.full + 8 * st, 0, c1, c2, b * d + s, 0);
  };
  if (threadIdx.x == 0) {
    load(0);
    load(1);
  }
  put_message(sm.msg, Min + ((size_t)b * (k - 1) + (v < t ? v : v - 1)) * chi * chi, chi);
  fence_async_smem();
  __syncthreads();
  constexpr int TI = T_INNER ? 1 : 0;
  constexpr unsigned long long STEP = T_INNER ? DESC_K_ROWS : DESC_K_ROW;  // K's and V's tiles
  const unsigned long long m0 = wg_desc(smem_u32(sm.msg));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float pr[32], pi[32];
  zero32(pr);
  zero32(pi);
  int n = 0;
  for (int it = it0; it < it1; ++it) {
    // W = K M_v: Wr += Kr Mr - Ki Mi, Wi += Kr Mi + Ki Mr
    const int st = n % TC_STAGES;
    mbar_wait(sm.full + 8 * st, (n / TC_STAGES) & 1);
    float wr[32], wi[32];
    zero32(wr);
    zero32(wi);
    wg_fence(wr);
    wg_fence(wi);
    wg_begin();
    const unsigned long long k0 = wg_desc(smem_u32(sm.ring + st * TC_TILE_BYTES));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // the whole depth, as in pass 1
      const unsigned long long a = k0 + STEP * kk, bm = m0 + DESC_K_ROWS * kk;
      mma3_ss<1, TI, 1>(wr, a, a + 2 * DESC_PLANE, bm, bm + 2 * DESC_PLANE);
      mma3_ss<-1, TI, 1>(wr, a + DESC_PLANE, a + 3 * DESC_PLANE, bm + DESC_PLANE, bm + 3 * DESC_PLANE);
      mma3_ss<1, TI, 1>(wi, a, a + 2 * DESC_PLANE, bm + DESC_PLANE, bm + 3 * DESC_PLANE);
      mma3_ss<1, TI, 1>(wi, a + DESC_PLANE, a + 3 * DESC_PLANE, bm, bm + 2 * DESC_PLANE);
    }
    wg_end();
    wg_fence(wr);
    wg_fence(wi);
    int vst = st;  // k = 2: V's tile is K's
    if (k == 3) {
      __syncthreads();  // every warp is done with K's tile: the next but one tile may land there
      if (threadIdx.x == 0) load(n + 2);
      ++n;
      vst = n % TC_STAGES;
      mbar_wait(sm.full + 8 * vst, (n / TC_STAGES) & 1);
    }
    // W's split: the accumulator's columns 16 kk .. 16 kk + 15 are the A
    // fragment of depth step kk, pairs in order
    unsigned wrh[4][4], wrl[4][4], wih[4][4], wil[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split2(wr[8 * kk + 2 * e], wr[8 * kk + 2 * e + 1], wrh[kk][e], wrl[kk][e]);
        split2(wi[8 * kk + 2 * e], wi[8 * kk + 2 * e + 1], wih[kk][e], wil[kk][e]);
      }
    // P += W V^H: Pr += Wr Vr + Wi Vi, Pi += Wi Vr - Wr Vi
    wg_fence(pr);
    wg_fence(pi);
    wg_begin();
    const unsigned long long v0 = wg_desc(smem_u32(sm.ring + vst * TC_TILE_BYTES));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // W's columns past chi are zero (M_v's are)
      const unsigned long long bv = v0 + STEP * kk;
      mma3_rs<1, TI>(pr, wrh[kk], wrl[kk], bv, bv + 2 * DESC_PLANE);
      mma3_rs<1, TI>(pr, wih[kk], wil[kk], bv + DESC_PLANE, bv + 3 * DESC_PLANE);
      mma3_rs<1, TI>(pi, wih[kk], wil[kk], bv, bv + 2 * DESC_PLANE);
      mma3_rs<-1, TI>(pi, wrh[kk], wrl[kk], bv + DESC_PLANE, bv + 3 * DESC_PLANE);
    }
    wg_end();
    wg_fence(pr);
    wg_fence(pi);
    __syncthreads();  // every warp is done with V's tile
    if (threadIdx.x == 0) load(n + 2);
    ++n;
  }
  float2* out = dst + ((size_t)b * chunks + chunk) * chi * chi;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * warp + g + 8 * h, j = 8 * c + 2 * t4;  // j + 1 < chi with j, since chi % 8 == 0
      if (i < chi && j < chi)
        *reinterpret_cast<float4*>(out + (size_t)i * chi + j) =
            make_float4(pr[4 * c + 2 * h], pi[4 * c + 2 * h], pr[4 * c + 2 * h + 1], pi[4 * c + 2 * h + 1]);
    }
}

// planes[4][n] = the re hi, im hi, re lo, im lo of x[n], each bf16 rounded to
// nearest even; two complex values a thread (n even), a word of each plane
__global__ void bp_split_planes(const float4* __restrict__ x, unsigned* __restrict__ planes, long long pairs) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < pairs;
       e += (long long)gridDim.x * blockDim.x) {
    const float4 z = x[e];
    unsigned rh, rl, ih, il;
    split2(z.x, z.z, rh, rl);
    split2(z.y, z.w, ih, il);
    planes[e] = rh;
    planes[pairs + e] = ih;
    planes[2 * pairs + e] = rl;
    planes[3 * pairs + e] = il;
  }
}

}  // namespace

// Once per device: raise the kernels' dynamic shared memory limits and
// report their shared memory, how many CTAs of each an SM holds (pass 1,
// pass 2, pass 2 for bonds wider than 64), and the SM count.
extern "C" int tnqs_bp_sweep_setup(int* smem_mode, int* smem_pass2, int* ctas_mode, int* ctas_pass2,
                                   int* ctas_wide, int* sms) {
  cudaError_t err = cudaFuncSetAttribute(bp_mode_product, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MODE);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bp_pass2<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_PASS2);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bp_pass2<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_PASS2);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_mode, bp_mode_product, THREADS, SMEM_MODE);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_pass2, bp_pass2<false>, THREADS, SMEM_PASS2);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_wide, bp_pass2<true>, THREADS, SMEM_PASS2);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  *smem_mode = (int)SMEM_MODE;
  *smem_pass2 = (int)SMEM_PASS2;
  return (int)err;
}

// The same for the bf16_3x kernels.
extern "C" int tnqs_bp_sweep_setup_3x(int* smem_mode, int* smem_pass2, int* ctas_mode, int* ctas_pass2,
                                      int* ctas_wide, int* sms) {
  cudaError_t err =
      cudaFuncSetAttribute(bp_mode_product_3x, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MODE_3X);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bp_pass2_3x<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_PASS2_3X);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bp_pass2_3x<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_PASS2_3X);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_mode, bp_mode_product_3x, THREADS, SMEM_MODE_3X);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_pass2, bp_pass2_3x<false>, THREADS, SMEM_PASS2_3X);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_wide, bp_pass2_3x<true>, THREADS, SMEM_PASS2_3X);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  *smem_mode = (int)SMEM_MODE_3X;
  *smem_pass2 = (int)SMEM_PASS2_3X;
  return (int)err;
}

namespace {

// the group's launches, in order, on `st`: the FP32 kernels, or with SPLIT3
// the bf16_3x ones
template <bool SPLIT3>
cudaError_t launch_group(const float2* T, const long long* rows, const float2* M, float2* out, float2* scratch,
                         const long long* plan, int n_k, cudaStream_t st) {
  const int batch = (int)plan[0], k = (int)plan[1], chi = (int)plan[2], d = (int)plan[3], t = (int)plan[4];
  const int u = (int)plan[5], v = (int)plan[6], mode_per_cta = (int)plan[7], per_cta = (int)plan[8];
  const int chunks = (int)plan[9];
  const bool ok = batch > 0 && n_k > 0 && d > 0 && k >= 2 && k <= MAX_DEGREE && chi >= 8 && chi % 8 == 0 &&
                  (k == 2 || chi <= TILE) && t >= 0 && t < k && v >= 0 && v < k && v != t &&
                  (k == 2 ? u == -1 : u >= 0 && u < k && u != t && u != v) && mode_per_cta > 0 && per_cta > 0 &&
                  chunks > 0 && (scratch != nullptr || (k == 2 && chunks == 1));
  if (!ok) return cudaErrorInvalidValue;
  float2* vbuf = scratch + plan[10];
  float2* wbuf[2] = {scratch + plan[11], scratch + plan[12]};
  float2* part = scratch + plan[13];
  const int nrb = k >= 3 ? (int)(ipow(chi, k - 1) / TILE) : 0;
  const dim3 mode_grid((nrb + mode_per_cta - 1) / mode_per_cta, d, batch);
  const float2* vt = T;
  const long long* v_rows = rows;
  if (k >= 3) {  // the bra side: V = K x_u conj(M_u)
    if (SPLIT3)
      bp_mode_product_3x<<<mode_grid, THREADS, SMEM_MODE_3X, st>>>(T, rows, M, vbuf, n_k, k, chi, d, u,
                                                                   u < t ? u : u - 1, 1, mode_per_cta);
    else
      bp_mode_product<<<mode_grid, THREADS, SMEM_MODE, st>>>(T, rows, M, vbuf, n_k, k, chi, d, u, u < t ? u : u - 1,
                                                             1, mode_per_cta);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    vt = vbuf;
    v_rows = nullptr;
  }
  const float2* ket = T;
  const long long* ket_rows = rows;
  int w = 0;
  for (int j = 0; j < k; ++j) {  // the ket absorbs before pass 2
    if (j == t || j == u || j == v) continue;
    if (SPLIT3)
      bp_mode_product_3x<<<mode_grid, THREADS, SMEM_MODE_3X, st>>>(ket, ket_rows, M, wbuf[w], n_k, k, chi, d, j,
                                                                   j < t ? j : j - 1, 0, mode_per_cta);
    else
      bp_mode_product<<<mode_grid, THREADS, SMEM_MODE, st>>>(ket, ket_rows, M, wbuf[w], n_k, k, chi, d, j,
                                                             j < t ? j : j - 1, 0, mode_per_cta);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ket = wbuf[w];
    ket_rows = nullptr;
    w ^= 1;
  }
  const int nblk = (chi + TILE - 1) / TILE;
  float2* dst = chunks == 1 ? out : part;
  const dim3 grid(chunks * nblk * nblk, batch);
  if (SPLIT3 && nblk > 1)
    bp_pass2_3x<true><<<grid, THREADS, SMEM_PASS2_3X, st>>>(ket, ket_rows, vt, v_rows, M, dst, n_k, k, chi, d, t, v,
                                                            per_cta, chunks);
  else if (SPLIT3)
    bp_pass2_3x<false><<<grid, THREADS, SMEM_PASS2_3X, st>>>(ket, ket_rows, vt, v_rows, M, dst, n_k, k, chi, d, t, v,
                                                             per_cta, chunks);
  else if (nblk > 1)
    bp_pass2<true><<<grid, THREADS, SMEM_PASS2, st>>>(ket, ket_rows, vt, v_rows, M, dst, n_k, k, chi, d, t, v, per_cta,
                                                      chunks);
  else
    bp_pass2<false><<<grid, THREADS, SMEM_PASS2, st>>>(ket, ket_rows, vt, v_rows, M, dst, n_k, k, chi, d, t, v,
                                                       per_cta, chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const long long total = (long long)batch * chi * chi;
  bp_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, out, chunks, chi * chi, total);
  return cudaGetLastError();
}

template <bool SPLIT3>
int sweep_on(const void* T, const void* rows, const void* Min, void* out, void* scratch, const long long* plan,
             int n_k, int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch_group<SPLIT3>((const float2*)T, (const long long*)rows, (const float2*)Min, (float2*)out,
                             (float2*)scratch, plan, n_k, (cudaStream_t)stream);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

}  // namespace

// T: the bucket [n_k, d, chi^k] complex64, contiguous, on CUDA device
// `device`; rows [batch] int64, each in [0, n_k) (the kernels trap
// otherwise); Min [batch, k-1, chi, chi]; out [batch, chi, chi].  `plan`
// (`_launch_args` in tnqs_torch/ops/bp_sweep.py, from `bp_plan`): batch, k,
// chi, d, t, u (the bra-side slot, -1 at k = 2), v (the ket slot absorbed in
// pass 2; the other ket slots are absorbed first, ascending), the 64-column
// blocks a pass-1 CTA, the (s, o) items a pass-2 CTA, the chunks, then the
// element offsets in `scratch` of V [batch, d, chi^k] (k >= 3), of the two
// alternating ket-absorb buffers of the same shape (k >= 4) and of the
// partials [batch, chunks, chi, chi] (chunks > 1).  The launches go on
// `stream`; the caller's current device is restored.
extern "C" int tnqs_bp_sweep(const void* T, const void* rows, const void* Min, void* out, void* scratch,
                             const long long* plan, int n_k, int device, void* stream) {
  return sweep_on<false>(T, rows, Min, out, scratch, plan, n_k, device, stream);
}

// The same group in the bf16_3x mode; `plan` is made for the bf16_3x
// kernels' occupancy (`tnqs_bp_sweep_setup_3x`).
extern "C" int tnqs_bp_sweep_3x(const void* T, const void* rows, const void* Min, void* out, void* scratch,
                                const long long* plan, int n_k, int device, void* stream) {
  return sweep_on<true>(T, rows, Min, out, scratch, plan, n_k, device, stream);
}

// The same for the tensor-core bf16_3x kernels: their shared memory, how
// many CTAs of pass 1 and of pass 2 an SM holds, and the SM count.
extern "C" int tnqs_bp_sweep_setup_tc(int* smem, int* ctas_mode, int* ctas_pass2, int* sms) {
  cudaError_t err = cudaFuncSetAttribute(bp_bra_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_TC);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bp_pass2_tc<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_TC);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bp_pass2_tc<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_TC);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_mode, bp_bra_tc, TC_THREADS, SMEM_TC);
  int other = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_pass2, bp_pass2_tc<false>, TC_PASS2_THREADS, SMEM_TC);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&other, bp_pass2_tc<true>, TC_PASS2_THREADS, SMEM_TC);
  if (err == cudaSuccess && other < *ctas_pass2) *ctas_pass2 = other;
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  *smem = (int)SMEM_TC;
  return (int)err;
}

namespace {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The tensor map of split planes [4][rows_d][chi^k] bf16 (k = 2, 3) in five
// dimensions, innermost first: the slots from the last (k = 2: then a unit
// dimension), the rows (bucket row x d + s), the plane.  The box is 64 on
// dimensions da and db, 4 planes, 1 elsewhere, in the 128-byte swizzle; TMA
// fills zeros past chi on loads and leaves them out on stores.
cudaError_t plane_map(CUtensorMap* map, const void* base, int k, int chi, long long rows_d, int da, int db) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const unsigned long long site = (unsigned long long)ipow(chi, k);
  const cuuint64_t dims[5] = {(cuuint64_t)chi, (cuuint64_t)chi, (cuuint64_t)(k == 3 ? chi : 1), (cuuint64_t)rows_d,
                              4};
  const cuuint64_t strides[4] = {(cuuint64_t)chi * 2, (cuuint64_t)chi * chi * 2, site * 2, rows_d * site * 2};
  cuuint32_t box[5] = {1, 1, 1, 1, 4};
  box[da] = TILE;
  box[db] = TILE;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the group's launches on the tensor cores, in order, on `st`: pass 1 (k =
// 3), pass 2, then the reduce
cudaError_t launch_group_tc(const void* planes, const long long* rows, const float2* M, float2* out, float2* scratch,
                            const long long* plan, int n_k, cudaStream_t st) {
  const int batch = (int)plan[0], k = (int)plan[1], chi = (int)plan[2], d = (int)plan[3], t = (int)plan[4];
  const int u = (int)plan[5], v = (int)plan[6], mode_per_cta = (int)plan[7], per_cta = (int)plan[8];
  const int chunks = (int)plan[9];
  const bool ok = batch > 0 && n_k > 0 && d > 0 && (k == 2 || k == 3) && chi >= 8 && chi <= TILE && chi % 8 == 0 &&
                  t >= 0 && t < k && v >= 0 && v < k && v != t && (v == k - 1 || t == k - 1) &&
                  (k == 2 ? u == -1 : u >= 0 && u < 2 && u != t && u != v) && mode_per_cta > 0 && per_cta > 0 &&
                  chunks > 0 && (scratch != nullptr || (k == 2 && chunks == 1));
  if (!ok) return cudaErrorInvalidValue;
  const void* vbuf = scratch + plan[10];  // V's planes [4][batch][d][chi^3]
  float2* part = scratch + plan[11];
  CUtensorMap ket, bra;
  cudaError_t err = plane_map(&ket, planes, k, chi, (long long)n_k * d, k - 1 - t, k - 1 - v);
  if (err == cudaSuccess && k == 3) {  // the bra side first: V = K x_u conj(M_u)
    CUtensorMap src, dst;
    err = plane_map(&src, planes, k, chi, (long long)n_k * d, 2 - u, 0);
    if (err == cudaSuccess) err = plane_map(&dst, vbuf, k, chi, (long long)batch * d, 2 - u, 0);
    if (err == cudaSuccess) err = plane_map(&bra, vbuf, k, chi, (long long)batch * d, k - 1 - t, k - 1 - v);
    if (err != cudaSuccess) return err;
    bp_bra_tc<<<dim3((chi + mode_per_cta - 1) / mode_per_cta, d, batch), TC_THREADS, SMEM_TC, st>>>(
        src, dst, rows, M, n_k, chi, d, u, u < t ? u : u - 1, mode_per_cta);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  float2* dst = chunks == 1 ? out : part;
  const dim3 grid(chunks, batch);
  if (t == k - 1)
    bp_pass2_tc<true><<<grid, TC_PASS2_THREADS, SMEM_TC, st>>>(ket, k == 3 ? bra : ket, rows, M, dst, n_k, k, chi, d,
                                                                t, v, per_cta, chunks);
  else
    bp_pass2_tc<false><<<grid, TC_PASS2_THREADS, SMEM_TC, st>>>(ket, k == 3 ? bra : ket, rows, M, dst, n_k, k, chi, d,
                                                                 t, v, per_cta, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const long long total = (long long)batch * chi * chi;
  bp_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, out, chunks, chi * chi, total);
  return cudaGetLastError();
}

}  // namespace

// The same group in bf16_3x on the tensor cores (k = 2, 3 and chi <= 64:
// `tc_route` in tnqs_torch/ops/bp_sweep.py), reading T's split planes
// `planes` [4][n_k, d, chi^k] bf16 (`tnqs_bp_split`) in place of T.  `plan`
// (`_launch_args_tc`): batch, k, chi, d, t, u, v, the pass-1 units a CTA,
// the pass-2 items a CTA, the chunks, then the element offsets in `scratch`
// (complex64 units) of V's planes [4][batch][d][chi^3] bf16 (k = 3) and of
// the partials [batch, chunks, chi, chi] (chunks > 1).
extern "C" int tnqs_bp_sweep_tc(const void* planes, const void* rows, const void* Min, void* out, void* scratch,
                                const long long* plan, int n_k, int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch_group_tc(planes, (const long long*)rows, (const float2*)Min, (float2*)out, (float2*)scratch, plan, n_k,
                        (cudaStream_t)stream);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

// T's split planes: x [rows][per_row] complex64 (per_row even) -> planes
// [4][rows][per_row] bf16, re hi, im hi, re lo, im lo, on `stream`.
extern "C" int tnqs_bp_split(const void* x, void* planes, int rows, int per_row, int device, void* stream) {
  if (rows <= 0 || per_row <= 0 || per_row % 2) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)rows * per_row / 2;
  const long long blocks = (pairs + 255) / 256;
  bp_split_planes<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (unsigned*)planes, pairs);
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
