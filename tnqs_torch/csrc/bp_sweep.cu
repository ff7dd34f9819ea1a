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
// bfloat16 split (hi = bf16(x), lo = bf16(x - hi)) with float32
// accumulation, on the tensor cores by `mma.sync.m16n8k16` (bf16 in, f32
// accumulate).  The split is made as a tile is stored to shared memory, into
// hi and lo planes of the real and imaginary parts in a k-major layout of
// their own (pitch 72 bf16: 144-byte rows, so `ldmatrix.trans` reads eight
// rows without a bank conflict), and the fragments come by `ldmatrix`.  A
// 64 x 64 x 16 complex step is 12 MMAs per 16 x 8 output block.  Loads are
// plain (no cp.async) and each warp owns a 32 x 16 block of the 64 x 64
// output: a simple kernel that is right; `wgmma` and TMA are later work.
// What bounds it: the same work at the dense bf16 rate (three passes), or
// the site tensors' bytes.  The passes keep the chunked, in-order reduce, so
// two calls give the same bits here too.
//
// The limits on k and chi are stated once, in the wrapper's `supports_group`
// (tnqs_torch/ops/bp_sweep.py), and the launch plan (slots u and v, chunk
// sizes, scratch layout) is made there too; this file checks only that the
// arguments are well formed.

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
// bf16_3x mode
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
