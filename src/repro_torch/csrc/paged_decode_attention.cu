// Paged decode attention for Hopper: one query token per request against
// K/V read only through the request's block-table row.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// paged_decode_attention_pallas (body _paged_decode_kernel).  There the
// tables and lengths arrive by scalar prefetch and the grid walks all
// max_blocks blocks of every request, masking the dead ones.  Here line
// `pos` of request `b` is pool row
// tables[b][pos / block_lines] * block_lines + pos % block_lines, and only
// live lines are read.
//
// Bound on this card: bytes.  A step must read every live K and V line
// once (2 * len * KVH * hd * dtype bytes per request); the products are a
// few flops per byte.  At decode batch a block per (request, KV head)
// would leave most of the 132 SMs idle, so the kernel is split-KV
// (flash-decoding) in one launch:
//
// * Grid (splits, KVH * head groups, B), 128 threads.  A block owns the
//   lines [split * chunk, (split + 1) * chunk) of one request and KV head,
//   clipped to the row's length, and up to 16 of the KV head's query heads
//   in bf16 (8 in f32), which share every K/V line it reads.  The
//   n_live = ceil(len / chunk) blocks of a row that see a line do the
//   work; the others exit at once, so a short row costs its own lines
//   only.
// * Gather.  Per tile of lines, the pool row of each line is worked out
//   once into shared memory (-1 for a line past the span, or whose table
//   entry lies outside [0, num_blocks)), two tiles ahead of its use, in a
//   ring of three slots.  Each line's hd * dtype bytes then come in by
//   16-byte cp.async (zero fill for -1), double-buffered so the next
//   tile's copy overlaps this one's arithmetic.  A tile may span several
//   pool blocks: the lookup is per line, so any block_lines works.
// * Products.  bf16: each warp takes 16 lines of a 64-line tile and runs
//   Q K^T and P V on the tensor cores (mma.sync m16n8k16; K and V
//   fragments by ldmatrix from rows padded to hd + 8 elements, so no bank
//   conflicts).  The 16 query heads of a block fill all 16 rows of the A
//   operand, so at starcoder2's G = 12 one block serves every head of its
//   KV head and reads each line once.  P is split into two bf16 terms
//   (hi + lo) so that P V keeps ~16 bits of P.  f32 (the consistency
//   checks): CUDA cores in full f32, a thread per (head, 8-element slice
//   of hd), scores reduced over the hd / 8 threads of a head by shuffles.
//   The online softmax is f32, base 2.
// * Merge, in the same launch.  The block first merges its warps' (or
//   line lanes') partials in shared memory, so it holds one (m, l, acc)
//   per head.  A row with one live block writes its output there.
//   Otherwise each live block writes its partial to an f32 scratch, takes
//   a ticket from the row's counter, and the last to arrive merges the
//   n_live partials (rescaled by exp2(m - max m)), writes the output and
//   resets the counter to 0 for the next launch.  The scratch and counters
//   belong to the wrapper (kernels/decode_attention.py), which keeps them
//   per device and stream, so a call allocates nothing; launches on one
//   stream run in order and never share them at once.
//
// The wrapper picks `splits` on the host from B, KVH, G, W and the SM
// count, never from lengths, so choosing it costs no device read.
//
// Contracts, the same as the plain version's: lengths are clamped to
// [0, max_blocks * block_lines]; a table entry outside the pool masks its
// lines (zero-filled, scores masked), so the kernel never reads outside
// the pool; a row with no live line writes exactly 0 (l clamped at
// 1e-30, as in the TPU kernels).
//
// The cp.async / ldmatrix wrappers repeat decode_attention.cu's, which is
// left as it is so that the dense kernel's instructions do not move.
#include <stdint.h>

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SPLIT_ALIGN = 64;  // chunk is a multiple of both tile sizes

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)  // 0 source bytes: zero fill
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for every committed group, or all but the newest one.
__device__ __forceinline__ void cp_async_wait(bool keep_one) {
  if (keep_one) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Thread r of [0, TK) writes the pool row of line t0 + r: -1 at or past
// `end`, or where the table entry lies outside the pool.
__device__ __forceinline__ void tile_row(int* rows, const int* table, int t0,
                                         int end, int num_blocks,
                                         int block_lines, int r) {
  int row = -1;
  const int pos = t0 + r;
  if (pos < end) {
    const int blk = table[pos / block_lines];
    if (blk >= 0 && blk < num_blocks)
      row = blk * block_lines + pos % block_lines;
  }
  rows[r] = row;
}

// Copy the K and V lines of one tile, pool rows `rows`, of one KV head into
// shared rows of LD elements; a row of -1 is zero-filled.
template <typename T, int HD, int TK, int LD>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kb,
                                          const T* vb, const int* rows,
                                          size_t line, int tid) {
  constexpr int PER_LINE = HD * (int)sizeof(T) / 16;
  constexpr int E = 16 / (int)sizeof(T);
  for (int i = tid; i < TK * PER_LINE; i += THREADS) {
    const int r = i / PER_LINE, off = (i % PER_LINE) * E;
    const int row = rows[r];
    const size_t src = (size_t)max(row, 0) * line + off;
    cp_async16(ks + r * LD + off, kb + src, row >= 0);
    cp_async16(vs + r * LD + off, vb + src, row >= 0);
  }
  cp_async_commit();
}

// Where a block sits: request b, KV head kvh, head group grp (of GBK heads),
// split `split` of the row's n_live live ones.
struct Place {
  int b, kvh, grp, G, H, split, n_live, NP;
};

// The block's end: merge its NW partials per head (acc rows of HD + 8
// floats in `red`, m and l in red_m, red_l, indexed [i][head]), then
// write the output (one live block) or the partial, and in the row's
// last block merge the n_live partials and write the output.
template <typename T, int HD, int GBK, int NW>
__device__ __forceinline__ void finish(const float* red, const float* red_m,
                                       const float* red_l, const Place& p,
                                       T* __restrict__ out,
                                       float* __restrict__ part_ml,
                                       float* __restrict__ part_acc,
                                       int* __restrict__ counters, int tid) {
  constexpr int RS = HD + 8;
  constexpr int TPH = THREADS / GBK;  // threads per head
  constexpr int VALS = HD / TPH;      // output columns per thread
  __shared__ int is_last;
  const int hl = tid / TPH, col = VALS * (tid % TPH);
  const int gh = p.grp * GBK + hl;
  const bool live_head = gh < p.G;
  const size_t bh = (size_t)p.b * p.H + (size_t)p.kvh * p.G + gh;

  float mw[NW], w[NW], mx = NEG_INF, l = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    mw[i] = red_m[i * GBK + hl];
    mx = fmaxf(mx, mw[i]);
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const float li = red_l[i * GBK + hl];  // 0: that part saw no line
    w[i] = li == 0.f ? 0.f : exp2f(mw[i] - mx);
    l = fmaf(li, w[i], l);
  }
  float acc[VALS];
#pragma unroll
  for (int c = 0; c < VALS; c += 4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(
          red + (i * GBK + hl) * RS + col + c);
      a.x = fmaf(x.x, w[i], a.x);
      a.y = fmaf(x.y, w[i], a.y);
      a.z = fmaf(x.z, w[i], a.z);
      a.w = fmaf(x.w, w[i], a.w);
    }
    acc[c] = a.x;
    acc[c + 1] = a.y;
    acc[c + 2] = a.z;
    acc[c + 3] = a.w;
  }

  if (p.n_live == 1) {  // the row's only live block: no partial to merge
    if (!live_head) return;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < VALS; ++c)
      out[bh * HD + col + c] = from_float<T>(acc[c] * inv);
    return;
  }

  if (live_head) {
    const size_t row = bh * p.NP + p.split;
    if (tid % TPH == 0) {
      part_ml[2 * row] = l == 0.f ? NEG_INF : mx;
      part_ml[2 * row + 1] = l;
    }
#pragma unroll
    for (int c = 0; c < VALS; c += 4)
      *reinterpret_cast<float4*>(part_acc + row * HD + col + c) =
          make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  }
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  int* counter = counters + (size_t)p.b * gridDim.y + blockIdx.y;
  if (tid == 0) is_last = atomicAdd(counter, 1) == p.n_live - 1;
  __syncthreads();
  if (!is_last) return;
  if (tid == 0) *counter = 0;  // ready for the next launch
  __threadfence();
  if (!live_head) return;

  // the row's last block: merge the n_live partials, read from L2
  const float* ml = part_ml + 2 * bh * p.NP;
  float m_all = NEG_INF;
  for (int s = 0; s < p.n_live; ++s) m_all = fmaxf(m_all, __ldcg(ml + 2 * s));
  float l_all = 0.f, o[VALS];
#pragma unroll
  for (int c = 0; c < VALS; ++c) o[c] = 0.f;
  for (int s = 0; s < p.n_live; ++s) {
    const float ls = __ldcg(ml + 2 * s + 1);
    if (ls == 0.f) continue;  // saw no line: its m is NEG_INF
    const float ws = exp2f(__ldcg(ml + 2 * s) - m_all);
    l_all = fmaf(ls, ws, l_all);
    const float4* src = reinterpret_cast<const float4*>(
        part_acc + (bh * p.NP + s) * HD + col);
#pragma unroll
    for (int c = 0; c < VALS / 4; ++c) {
      const float4 x = __ldcg(src + c);
      o[4 * c] = fmaf(x.x, ws, o[4 * c]);
      o[4 * c + 1] = fmaf(x.y, ws, o[4 * c + 1]);
      o[4 * c + 2] = fmaf(x.z, ws, o[4 * c + 2]);
      o[4 * c + 3] = fmaf(x.w, ws, o[4 * c + 3]);
    }
  }
  const float inv = 1.f / fmaxf(l_all, 1e-30f);
#pragma unroll
  for (int c = 0; c < VALS; ++c)
    out[bh * HD + col + c] = from_float<T>(o[c] * inv);
}

// The block's place in the grid and its span of lines [start, end).
__device__ __forceinline__ Place place(const int* lengths, int H, int KVH,
                                       int GBK, int W, int chunk, int NP,
                                       int& start, int& end) {
  Place p;
  p.G = H / KVH;
  p.H = H;
  const int groups = (p.G + GBK - 1) / GBK;
  p.split = blockIdx.x;
  p.b = blockIdx.z;
  p.kvh = blockIdx.y / groups;
  p.grp = blockIdx.y % groups;
  p.NP = NP;
  const int len = max(0, min(lengths[p.b], W));
  p.n_live = max(1, (len + chunk - 1) / chunk);
  start = p.split * chunk;
  end = min(start + chunk, len);
  return p;
}

// ---- bf16: tensor cores -------------------------------------------------

namespace mma {

constexpr int TK = 64;  // lines per tile: 16 per warp
constexpr int GB = 16;  // query heads per block: the m16 rows

template <int HD>
constexpr int LD = HD + 8;  // shared row stride in elements

template <int HD>
__host__ __device__ constexpr size_t tile_bytes() {
  return 2 * 2 * (size_t)TK * LD<HD> * 2;  // 2 buffers x (K, V), bf16
}
template <int HD>
constexpr size_t smem_bytes() {
  return tile_bytes<HD>() + 3 * TK * sizeof(int);  // + the ring of rows
}
// the warps' partials are merged in the tile buffers
static_assert(tile_bytes<64>() >= sizeof(float) * WARPS * GB * (64 + 10), "");

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ uint32_t head_pair(const __nv_bfloat16* qh,
                                              bool live) {
  return live ? *reinterpret_cast<const uint32_t*>(qh) : 0u;
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): the
// accumulator's d[0], d[1] are row g, columns 2t, 2t + 1 and d[2], d[3]
// row g + 8; A's registers are (row g, k 2t..2t+1), (row g + 8, k 2t..),
// (row g, k 2t+8..), (row g + 8, k 2t+8..).  Row r is head r of the
// block's group; rows past G are zero.
template <int HD>
__global__ void __launch_bounds__(THREADS)
    paged_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ tables,
                 const int* __restrict__ lengths,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part_ml,
                 float* __restrict__ part_acc, int* __restrict__ counters,
                 int H, int KVH, int num_blocks, int block_lines,
                 int max_blocks, int chunk, int NP, float scale_log2) {
  constexpr int L = LD<HD>;
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int NT = HD / 8;   // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int* rows = reinterpret_cast<int*>(smem_raw + tile_bytes<HD>());

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  int start, end;
  const Place p = place(lengths, H, KVH, GB, max_blocks * block_lines,
                        chunk, NP, start, end);
  if (p.split >= p.n_live) return;  // the span lies past the row's length
  const int n_tiles = end > start ? (end - start + TK - 1) / TK : 0;
  const int* table = tables + (size_t)p.b * max_blocks;

  // q of heads g and g + 8 of the group as A fragments, unscaled bf16
  const int gh0 = p.grp * GB + g, gh1 = gh0 + 8;
  const __nv_bfloat16* q0 = q + ((size_t)p.b * H + p.kvh * p.G + gh0) * HD;
  const __nv_bfloat16* q1 = q0 + 8 * HD;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qa[kk][0] = head_pair(q0 + 16 * kk + 2 * t, gh0 < p.G);
    qa[kk][1] = head_pair(q1 + 16 * kk + 2 * t, gh1 < p.G);
    qa[kk][2] = head_pair(q0 + 16 * kk + 8 + 2 * t, gh0 < p.G);
    qa[kk][3] = head_pair(q1 + 16 * kk + 8 + 2 * t, gh1 < p.G);
  }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const size_t line = (size_t)KVH * HD;  // elements between pool rows
  const __nv_bfloat16* kb = k + (size_t)p.kvh * HD;
  const __nv_bfloat16* vb = v + (size_t)p.kvh * HD;
  auto buf = [&](int i) { return tiles + (size_t)(i & 1) * 2 * TK * L; };
  auto slot = [&](int i) { return rows + (i % 3) * TK; };

  // the rows of the first two tiles: one thread per line
  static_assert(2 * TK == THREADS, "");
  if (tid / TK < n_tiles)
    tile_row(slot(tid / TK), table, start + (tid / TK) * TK, end,
             num_blocks, block_lines, tid % TK);
  __syncthreads();
  if (n_tiles > 0)
    load_tile<__nv_bfloat16, HD, TK, L>(buf(0), buf(0) + TK * L, kb, vb,
                                        slot(0), line, tid);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles)
      load_tile<__nv_bfloat16, HD, TK, L>(buf(it + 1), buf(it + 1) + TK * L,
                                          kb, vb, slot(it + 1), line, tid);
    cp_async_wait(it + 1 < n_tiles);
    __syncthreads();
    // the rows two tiles on, into the slot tile it - 1 has left; the
    // barrier that ends this tile publishes them
    if (tid < TK && it + 2 < n_tiles)
      tile_row(slot(it + 2), table, start + (it + 2) * TK, end, num_blocks,
               block_lines, tid);
    const __nv_bfloat16* ks = buf(it) + 16 * warp * L;  // this warp's lines
    const __nv_bfloat16* vs = buf(it) + TK * L + 16 * warp * L;
    const int* rw = slot(it) + 16 * warp;

    // S = Q K^T for lines 8j + 2t + e of the warp's 16
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
        uint32_t r[4];
        ldsm_x4(r, ks + (8 * j + lane % 8) * L + 16 * kk + 8 * (lane / 8));
        mma_bf16(sc[j], qa[kk], r[0], r[1]);
        mma_bf16(sc[j], qa[kk + 1], r[2], r[3]);
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = rw[8 * j + 2 * t + e] >= 0;
        sc[j][e] = ok ? sc[j][e] * scale_log2 : NEG_INF;          // head g
        sc[j][2 + e] = ok ? sc[j][2 + e] * scale_log2 : NEG_INF;  // g + 8
        mx[0] = fmaxf(mx[0], sc[j][e]);
        mx[1] = fmaxf(mx[1], sc[j][2 + e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - mn);
      m[h] = mn;
      l[h] *= corr[h];  // this thread's lines; the quad sums at the end
    }
    float pr[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        pr[j][e] = sc[j][e] <= NEG_INF ? 0.f : exp2f(sc[j][e] - m[h]);
        l[h] += pr[j][e];
      }
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      o[nn][0] *= corr[0];
      o[nn][1] *= corr[0];
      o[nn][2] *= corr[1];
      o[nn][3] *= corr[1];
    }

    // O += P V: P's k16 is the warp's 16 lines (A registers from the
    // accumulator layout), V's fragments by transposed ldmatrix
    uint32_t p_hi[4], p_lo[4];
    split_bf16(pr[0][0], pr[0][1], p_hi[0], p_lo[0]);
    split_bf16(pr[0][2], pr[0][3], p_hi[1], p_lo[1]);
    split_bf16(pr[1][0], pr[1][1], p_hi[2], p_lo[2]);
    split_bf16(pr[1][2], pr[1][3], p_hi[3], p_lo[3]);
#pragma unroll
    for (int nn = 0; nn < NT; nn += 2) {
      uint32_t r[4];
      ldsm_x4_t(r, vs + (lane % 8 + 8 * ((lane / 8) % 2)) * L + 8 * nn +
                       8 * (lane / 16));
      mma_bf16(o[nn], p_hi, r[0], r[1]);
      mma_bf16(o[nn], p_lo, r[0], r[1]);
      mma_bf16(o[nn + 1], p_hi, r[2], r[3]);
      mma_bf16(o[nn + 1], p_lo, r[2], r[3]);
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // the warps' partials into the tile buffers (the loop ended on a
  // barrier, and no copy is in flight)
  constexpr int RS = HD + 8;
  float* red = reinterpret_cast<float*>(smem_raw);  // [warp][GB][RS] acc
  float* red_m = red + WARPS * GB * RS;              // [warp][GB]
  float* red_l = red_m + WARPS * GB;
#pragma unroll
  for (int nn = 0; nn < NT; ++nn) {
    *reinterpret_cast<float2*>(red + (warp * GB + g) * RS + 8 * nn + 2 * t) =
        make_float2(o[nn][0], o[nn][1]);
    *reinterpret_cast<float2*>(red + (warp * GB + g + 8) * RS + 8 * nn +
                               2 * t) = make_float2(o[nn][2], o[nn][3]);
  }
  if (t == 0) {
    red_m[warp * GB + g] = m[0];
    red_l[warp * GB + g] = l[0];
    red_m[warp * GB + g + 8] = m[1];
    red_l[warp * GB + g + 8] = l[1];
  }
  __syncthreads();
  finish<__nv_bfloat16, HD, GB, WARPS>(red, red_m, red_l, p, out, part_ml,
                                       part_acc, counters, tid);
}

}  // namespace mma

// ---- f32: CUDA cores -----------------------------------------------------

namespace simt {

constexpr int TK = 32;  // lines per tile
constexpr int VEC = 8;  // head-dim elements per thread
constexpr int GB = 8;   // query heads per block

__device__ __forceinline__ void load8(const float* p, float (&x)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// threads per (head, line) and line lanes (partials) per block
template <int HD>
struct Shape {
  static constexpr int CH = HD / VEC;
  static constexpr int LP = THREADS / (GB * CH);
};

template <int HD>
__host__ __device__ constexpr size_t tile_bytes() {
  return 2 * 2 * (size_t)TK * HD * sizeof(float);  // 2 buffers x (K, V)
}
template <int HD>
constexpr size_t smem_bytes() {
  return tile_bytes<HD>() + 3 * TK * sizeof(int);
}
static_assert(tile_bytes<64>() >=
                  sizeof(float) * Shape<64>::LP * GB * (64 + 10), "");

template <int HD>
__global__ void __launch_bounds__(THREADS)
    paged_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ tables,
                 const int* __restrict__ lengths, float* __restrict__ out,
                 float* __restrict__ part_ml, float* __restrict__ part_acc,
                 int* __restrict__ counters, int H, int KVH, int num_blocks,
                 int block_lines, int max_blocks, int chunk, int NP,
                 float scale_log2) {
  constexpr int CH = Shape<HD>::CH;
  constexpr int LP = Shape<HD>::LP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tiles = reinterpret_cast<float*>(smem_raw);  // [buffer][K, V][TK][HD]
  int* rows = reinterpret_cast<int*>(smem_raw + tile_bytes<HD>());

  const int tid = threadIdx.x;
  const int c = tid % CH, g = (tid / CH) % GB, lp = tid / (CH * GB);
  int start, end;
  const Place p = place(lengths, H, KVH, GB, max_blocks * block_lines,
                        chunk, NP, start, end);
  if (p.split >= p.n_live) return;  // the span lies past the row's length
  const int n_tiles = end > start ? (end - start + TK - 1) / TK : 0;
  const int* table = tables + (size_t)p.b * max_blocks;
  const int gh = p.grp * GB + g;  // head within the KV group
  const bool live_head = gh < p.G;

  float qv[VEC];
  if (live_head) {
    load8(q + ((size_t)p.b * H + p.kvh * p.G + gh) * HD + c * VEC, qv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[e] *= scale_log2;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[e] = 0.f;
  }
  float m = NEG_INF, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  const size_t line = (size_t)KVH * HD;  // elements between pool rows
  const float* kb = k + (size_t)p.kvh * HD;
  const float* vb = v + (size_t)p.kvh * HD;
  auto buf = [&](int i) { return tiles + (size_t)(i & 1) * 2 * TK * HD; };
  auto slot = [&](int i) { return rows + (i % 3) * TK; };

  if (tid < 2 * TK && tid / TK < n_tiles)
    tile_row(slot(tid / TK), table, start + (tid / TK) * TK, end,
             num_blocks, block_lines, tid % TK);
  __syncthreads();
  if (n_tiles > 0)
    load_tile<float, HD, TK, HD>(buf(0), buf(0) + TK * HD, kb, vb, slot(0),
                                 line, tid);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles)
      load_tile<float, HD, TK, HD>(buf(it + 1), buf(it + 1) + TK * HD, kb,
                                   vb, slot(it + 1), line, tid);
    cp_async_wait(it + 1 < n_tiles);
    __syncthreads();
    if (tid < TK && it + 2 < n_tiles)
      tile_row(slot(it + 2), table, start + (it + 2) * TK, end, num_blocks,
               block_lines, tid);
    const float* ks = buf(it);
    const float* vs = ks + TK * HD;
    const int* rw = slot(it);

    float sc[TK / LP];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < TK / LP; ++j) {
      const int r = j * LP + lp;
      float kx[VEC];
      load8(ks + r * HD + c * VEC, kx);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) d = fmaf(qv[e], kx[e], d);
#pragma unroll
      for (int off = CH / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      sc[j] = rw[r] >= 0 ? d : NEG_INF;
      mx = fmaxf(mx, sc[j]);
    }
    const float mn = fmaxf(m, mx);
    const float corr = exp2f(m - mn);
    m = mn;
    l *= corr;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] *= corr;
#pragma unroll
    for (int j = 0; j < TK / LP; ++j) {
      const int r = j * LP + lp;
      if (sc[j] > NEG_INF) {
        const float pj = exp2f(sc[j] - mn);
        l += pj;
        float vx[VEC];
        load8(vs + r * HD + c * VEC, vx);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pj, vx[e], acc[e]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  constexpr int RS = HD + 8;
  float* red = reinterpret_cast<float*>(smem_raw);  // [lp][GB][RS] acc
  float* red_m = red + LP * GB * RS;                 // [lp][GB]
  float* red_l = red_m + LP * GB;
  float4* dst = reinterpret_cast<float4*>(red + (lp * GB + g) * RS + c * VEC);
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  if (c == 0) {
    red_m[lp * GB + g] = m;
    red_l[lp * GB + g] = l;
  }
  __syncthreads();
  finish<float, HD, GB, LP>(red, red_m, red_l, p, out, part_ml, part_acc,
                            counters, tid);
}

}  // namespace simt

template <typename T, auto kernel>
cudaError_t launch(size_t smem, int GBK, const void* q, const void* k,
                   const void* v, const int* tables, const int* lengths,
                   void* out, float* part_ml, float* part_acc, int* counters,
                   int B, int H, int KVH, int num_blocks, int block_lines,
                   int max_blocks, int splits, int chunk, float scale,
                   cudaStream_t stream) {
  static bool smem_ok = false;
  cudaError_t err = allow_smem(kernel, smem, smem_ok);
  if (err != cudaSuccess) return err;
  const int groups = (H / KVH + GBK - 1) / GBK;
  dim3 grid(splits, KVH * groups, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, lengths, static_cast<T*>(out),
      part_ml, part_acc, counters, H, KVH, num_blocks, block_lines,
      max_blocks, chunk, splits, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, hd); k_pool/v_pool (num_blocks, block_lines, KVH, hd); tables
// (B, max_blocks) int32; lengths (B,) int32; out (B, H, hd).  Scratch:
// part_ml (B, H, splits, 2) and part_acc (B, H, splits, hd) f32, counters
// (B, KVH * ceil(G / 8)) int32, all zero on entry and left zero.  All
// contiguous and 16-byte aligned; q, pools and out of one dtype
// (DTYPE_F32 or DTYPE_BF16); hd is 64 or 128; chunk a multiple of 64 and
// splits * chunk >= max_blocks * block_lines.  Returns the cudaError_t of
// the launch.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, void* part_ml, void* part_acc,
    void* counters, int B, int H, int KVH, int hd, int num_blocks,
    int block_lines, int max_blocks, int splits, int chunk, float scale,
    int dtype, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (splits < 1 || chunk < 1 || chunk % SPLIT_ALIGN || block_lines < 1 ||
      (long long)splits * chunk < (long long)max_blocks * block_lines)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  int* cnt = static_cast<int*>(counters);
  if (dtype == DTYPE_F32 && hd == 64)
    return (int)launch<float, simt::paged_kernel<64>>(
        simt::smem_bytes<64>(), simt::GB, q, k_pool, v_pool, tb, ln, out, ml,
        acc, cnt, B, H, KVH, num_blocks, block_lines, max_blocks, splits,
        chunk, scale, s);
  if (dtype == DTYPE_F32 && hd == 128)
    return (int)launch<float, simt::paged_kernel<128>>(
        simt::smem_bytes<128>(), simt::GB, q, k_pool, v_pool, tb, ln, out,
        ml, acc, cnt, B, H, KVH, num_blocks, block_lines, max_blocks, splits,
        chunk, scale, s);
  if (dtype == DTYPE_BF16 && hd == 64)
    return (int)launch<__nv_bfloat16, mma::paged_kernel<64>>(
        mma::smem_bytes<64>(), mma::GB, q, k_pool, v_pool, tb, ln, out, ml,
        acc, cnt, B, H, KVH, num_blocks, block_lines, max_blocks, splits,
        chunk, scale, s);
  if (dtype == DTYPE_BF16 && hd == 128)
    return (int)launch<__nv_bfloat16, mma::paged_kernel<128>>(
        mma::smem_bytes<128>(), mma::GB, q, k_pool, v_pool, tb, ln, out, ml,
        acc, cnt, B, H, KVH, num_blocks, block_lines, max_blocks, splits,
        chunk, scale, s);
  return (int)cudaErrorInvalidValue;
}
