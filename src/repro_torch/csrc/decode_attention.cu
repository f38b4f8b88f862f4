// Dense decode attention for Hopper: one query token per request against
// its own (W, KVH, hd) rows of a dense cache, lines >= lengths[b] masked.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention_pallas (body _decode_kernel), the decode attention of
// every stack that does not page (the hybrid Mamba+attention stack among
// them).  There the grid walks all W / block_k cache blocks of every
// request and masks the dead ones.  Here line `pos` of request `b` is row
// b * W + pos of the cache (no table), and only live lines are read.
//
// Bound on this card: bytes.  A step must read every live K and V line
// once (2 * len * KVH * hd * dtype bytes per request); the products are a
// few flops per byte.  At decode batch, one block per (request, KV head)
// would leave most of the 132 SMs idle, so the kernel is split-KV
// (flash-decoding), in two passes:
//
// 1. split: grid (splits, KVH * head groups, B), 128 threads.  A block
//    owns the lines [split * chunk, (split + 1) * chunk) of one request and
//    KV head, clipped to the row's length, and up to 8 of the KV head's
//    query heads, which share every K/V line it reads.  Tiles of lines
//    come in by 16-byte cp.async, double-buffered so the next tile's copy
//    overlaps this one's arithmetic.  The online softmax is in f32, base 2.
//    bf16: each warp takes 16 lines of a 64-line tile and runs both
//      products on the tensor cores (mma.sync m16n8k16, the 8 heads padded
//      to 16 rows; K and V fragments by ldmatrix from rows padded to
//      hd + 8 elements, so no bank conflicts).  P is split into two bf16
//      terms (hi + lo) so that P V keeps ~16 bits of P.  Each warp keeps
//      its own (m, l, acc); at the end the block merges the four in shared
//      memory, so a split writes one partial per head.
//    f32: CUDA cores in full f32 (the consistency checks only).  A thread
//      owns one (head, 8-element slice of hd), holds that slice of q in
//      registers and reduces each line's score over the hd / 8 threads of
//      its head by shuffles; 128 / hd partials per split.
//    Each partial (m, l, acc) per head goes to an f32 scratch the wrapper
//    allocates.  A partial that saw no line (its split starts at or past
//    the row's length) is written as m = NEG_INF, l = 0 and no acc; one
//    that saw a line has l >= 1, since its largest score adds exp2(0).
// 2. merge: grid (B * H), hd threads.  Skips empty partials, rescales the
//    others by exp2(m - max m) and writes acc / max(l, 1e-30) in the
//    output dtype; a row of length 0 writes 0.
//
// The wrapper (kernels/decode_attention.py) picks `splits` on the host
// from B, KVH, the head groups, W and the SM count, never from lengths, so
// choosing it costs no device read.  Lengths are clamped to [0, W].
//
// Measured at the hybrid path's shape (8 rows, W 1024, 64/8 heads, hd
// 128, bf16, 6 splits of 192 lines) on an NVIDIA H100 80GB HBM3 (700 W
// power limit; kernel_times.py, L2 evicted, device time after a spin):
// 0.018-0.019 ms for both passes, against 0.032-0.043 ms for torch's
// scaled_dot_product_attention and 0.318-0.320 ms for the
// one-block-per-KV-head version it replaced, on the same clock, back to
// back on one card.  The profiler's kernel durations: split pass 0.009 ms
// (2.4x the 0.0037 ms bytes bound), merge pass 0.0033 ms; the rest is the
// second launch.  Merging in the last block of each row, in one launch, is
// next.
#include <stdint.h>

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int THREADS = 128;
constexpr int GB = 8;          // query heads per block
constexpr int SPLIT_ALIGN = 64; // chunk is a multiple of both tile sizes

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

// Copy lines [t0, t0 + TK) of one KV head's K and V into shared rows of
// LD elements; lines at or past `end` are zero-filled.
template <typename T, int HD, int TK, int LD>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kb,
                                          const T* vb, size_t line, int t0,
                                          int end, int tid) {
  constexpr int PER_LINE = HD * (int)sizeof(T) / 16;
  constexpr int E = 16 / (int)sizeof(T);
  for (int i = tid; i < TK * PER_LINE; i += THREADS) {
    const int r = i / PER_LINE, off = (i % PER_LINE) * E;
    const bool ok = t0 + r < end;
    const size_t src = (size_t)(ok ? t0 + r : 0) * line + off;
    cp_async16(ks + r * LD + off, kb + src, ok);
    cp_async16(vs + r * LD + off, vb + src, ok);
  }
  cp_async_commit();
}

// ---- bf16: tensor cores -------------------------------------------------

namespace mma {

constexpr int TK = 64;  // lines per tile: 16 per warp
constexpr int WARPS = THREADS / 32;

template <int HD>
constexpr int LD = HD + 8;  // shared row stride in elements

template <int HD>
constexpr size_t smem_bytes() {
  return 2 * 2 * (size_t)TK * LD<HD> * 2;  // 2 buffers x (K, V), bf16
}
// the warps' partials are merged in the tile buffers
static_assert(smem_bytes<64>() >= sizeof(float) * WARPS * GB * (64 + 10), "");

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  // A rows 8..15 (registers a1, a3) are the zero padding of 8 heads
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
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

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): the
// accumulator's d[0], d[1] are row g, columns 2t, 2t + 1 (d[2], d[3] row
// g + 8, the padding); A's first register is row g, k 2t..2t+1 and its
// third row g, k 2t+8..2t+9.  Row g is head g of the block.
template <int HD>
__global__ void __launch_bounds__(THREADS)
    split_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ lengths, float* __restrict__ part_ml,
                 float* __restrict__ part_acc, int H, int KVH, int W,
                 int chunk, int NP, float scale_log2) {
  constexpr int L = LD<HD>;
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int NT = HD / 8;   // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int G = H / KVH, groups = (G + GB - 1) / GB;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / groups;
  const int gh = (blockIdx.y % groups) * GB + g;  // head within the KV group
  const bool live_head = gh < G;
  const int h = kvh * G + gh;

  const int len = max(0, min(lengths[b], W));
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const int n_tiles = end > start ? (end - start + TK - 1) / TK : 0;

  uint32_t qa[KS][2];  // q of head g as A fragments, unscaled bf16
  const __nv_bfloat16* qh = q + ((size_t)b * H + h) * HD;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qa[kk][0] = live_head
        ? *reinterpret_cast<const uint32_t*>(qh + 16 * kk + 2 * t) : 0u;
    qa[kk][1] = live_head
        ? *reinterpret_cast<const uint32_t*>(qh + 16 * kk + 8 + 2 * t) : 0u;
  }
  float m = NEG_INF, l = 0.f, o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const size_t line = (size_t)KVH * HD;
  const __nv_bfloat16* kb = k + (size_t)b * W * line + (size_t)kvh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * W * line + (size_t)kvh * HD;
  auto buf = [&](int i) { return tiles + (size_t)(i & 1) * 2 * TK * L; };

  if (n_tiles > 0)
    load_tile<__nv_bfloat16, HD, TK, L>(buf(0), buf(0) + TK * L, kb, vb,
                                        line, start, end, tid);
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = start + it * TK;
    if (it + 1 < n_tiles)
      load_tile<__nv_bfloat16, HD, TK, L>(buf(it + 1), buf(it + 1) + TK * L,
                                          kb, vb, line, t0 + TK, end, tid);
    cp_async_wait(it + 1 < n_tiles);
    __syncthreads();
    const __nv_bfloat16* ks = buf(it) + 16 * warp * L;  // this warp's lines
    const __nv_bfloat16* vs = buf(it) + TK * L + 16 * warp * L;
    const int n = min(TK, end - t0) - 16 * warp;      // its live lines

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
        mma_bf16(sc[j], qa[kk][0], qa[kk][1], r[0], r[1]);
        mma_bf16(sc[j], qa[kk + 1][0], qa[kk + 1][1], r[2], r[3]);
      }
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = 8 * j + 2 * t + e < n ? sc[j][e] * scale_log2 : NEG_INF;
        mx = fmaxf(mx, sc[j][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float corr = exp2f(m - mn);
    m = mn;
    l *= corr;  // this thread's lines; the quad sums at the end
    float p[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[j][e] = sc[j][e] <= NEG_INF ? 0.f : exp2f(sc[j][e] - mn);
        l += p[j][e];
      }
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      o[nn][0] *= corr;
      o[nn][1] *= corr;
    }

    // O += P V: P's k16 is the warp's 16 lines (A registers from the
    // accumulator layout), V's fragments by transposed ldmatrix
    uint32_t p_hi[2], p_lo[2];
    split_bf16(p[0][0], p[0][1], p_hi[0], p_lo[0]);
    split_bf16(p[1][0], p[1][1], p_hi[1], p_lo[1]);
#pragma unroll
    for (int nn = 0; nn < NT; nn += 2) {
      uint32_t r[4];
      ldsm_x4_t(r, vs + (lane % 8 + 8 * ((lane / 8) % 2)) * L + 8 * nn +
                       8 * (lane / 16));
      mma_bf16(o[nn], p_hi[0], p_hi[1], r[0], r[1]);
      mma_bf16(o[nn], p_lo[0], p_lo[1], r[0], r[1]);
      mma_bf16(o[nn + 1], p_hi[0], p_hi[1], r[2], r[3]);
      mma_bf16(o[nn + 1], p_lo[0], p_lo[1], r[2], r[3]);
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // Merge the four warps' partials in shared memory (the tiles are free:
  // the loop ended on a barrier), so a split writes one partial per head.
  constexpr int RS = HD + 8;  // padded rows: no bank conflict in the stores
  float* red = reinterpret_cast<float*>(smem_raw);  // [warp][GB][RS] acc
  float* red_m = red + WARPS * GB * RS;              // [warp][GB]
  float* red_l = red_m + WARPS * GB;
#pragma unroll
  for (int nn = 0; nn < NT; ++nn)
    *reinterpret_cast<float2*>(red + (warp * GB + g) * RS + 8 * nn + 2 * t) =
        make_float2(o[nn][0], o[nn][1]);
  if (t == 0) {
    red_m[warp * GB + g] = m;
    red_l[warp * GB + g] = l;
  }
  __syncthreads();
  // thread tid: head tid / 16 of the block, columns VALS * (tid % 16) on
  constexpr int VALS = HD / 16;
  const int hg = tid / 16, col = VALS * (tid % 16);
  const int gh_out = (blockIdx.y % groups) * GB + hg;
  if (gh_out >= G) return;
  float mw[WARPS], w[WARPS], mx_all = NEG_INF, l_all = 0.f;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    mw[i] = red_m[i * GB + hg];
    mx_all = fmaxf(mx_all, mw[i]);
  }
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    const float li = red_l[i * GB + hg];  // 0: the warp saw no line
    w[i] = li == 0.f ? 0.f : exp2f(mw[i] - mx_all);
    l_all = fmaf(li, w[i], l_all);
  }
  const size_t row = ((size_t)b * H + kvh * G + gh_out) * NP + split;
  if (tid % 16 == 0) {
    part_ml[2 * row] = l_all == 0.f ? NEG_INF : mx_all;
    part_ml[2 * row + 1] = l_all;
  }
  if (l_all == 0.f) return;  // empty: the merge reads no acc where l is 0
#pragma unroll
  for (int c = 0; c < VALS; c += 4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(
          red + (i * GB + hg) * RS + col + c);
      a.x = fmaf(x.x, w[i], a.x);
      a.y = fmaf(x.y, w[i], a.y);
      a.z = fmaf(x.z, w[i], a.z);
      a.w = fmaf(x.w, w[i], a.w);
    }
    *reinterpret_cast<float4*>(part_acc + row * HD + col + c) = a;
  }
}

}  // namespace mma

// ---- f32: CUDA cores -----------------------------------------------------

namespace simt {

constexpr int TK = 32;  // lines per tile
constexpr int VEC = 8;  // head-dim elements per thread

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
constexpr size_t smem_bytes() {
  return 2 * 2 * (size_t)TK * HD * sizeof(float);  // 2 buffers x (K, V)
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ part_ml, float* __restrict__ part_acc,
                 int H, int KVH, int W, int chunk, int NP, float scale_log2) {
  constexpr int CH = Shape<HD>::CH;
  constexpr int LP = Shape<HD>::LP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tiles = reinterpret_cast<float*>(smem_raw);  // [buffer][K, V][TK][HD]

  const int tid = threadIdx.x;
  const int c = tid % CH, g = (tid / CH) % GB, lp = tid / (CH * GB);
  const int G = H / KVH, groups = (G + GB - 1) / GB;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / groups;
  const int gh = (blockIdx.y % groups) * GB + g;  // head within the KV group
  const bool live_head = gh < G;
  const int h = kvh * G + gh;

  const int len = max(0, min(lengths[b], W));
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const int n_tiles = end > start ? (end - start + TK - 1) / TK : 0;

  float qv[VEC];
  if (live_head) {
    load8(q + ((size_t)b * H + h) * HD + c * VEC, qv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[e] *= scale_log2;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[e] = 0.f;
  }
  float m = NEG_INF, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  const size_t line = (size_t)KVH * HD;  // elements between cache lines
  const float* kb = k + (size_t)b * W * line + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * W * line + (size_t)kvh * HD;
  auto buf = [&](int i) { return tiles + (size_t)(i & 1) * 2 * TK * HD; };

  if (n_tiles > 0)
    load_tile<float, HD, TK, HD>(buf(0), buf(0) + TK * HD, kb, vb, line,
                                 start, end, tid);
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = start + it * TK;
    if (it + 1 < n_tiles)
      load_tile<float, HD, TK, HD>(buf(it + 1), buf(it + 1) + TK * HD, kb,
                                   vb, line, t0 + TK, end, tid);
    cp_async_wait(it + 1 < n_tiles);
    __syncthreads();
    const float* ks = buf(it);
    const float* vs = ks + TK * HD;
    const int n = min(TK, end - t0);

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
      sc[j] = r < n ? d : NEG_INF;
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
      if (r < n) {
        const float p = exp2f(sc[j] - mn);
        l += p;
        float vx[VEC];
        load8(vs + r * HD + c * VEC, vx);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vx[e], acc[e]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  if (!live_head) return;
  const size_t row = ((size_t)b * H + h) * NP + (size_t)split * LP + lp;
  if (c == 0) {
    part_ml[2 * row] = m;
    part_ml[2 * row + 1] = l;
  }
  if (l == 0.f) return;  // empty: the merge reads no acc where l is 0
  float4* dst = reinterpret_cast<float4*>(part_acc + row * HD + c * VEC);
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

}  // namespace simt

// ---- merge ----------------------------------------------------------------

// One block per (request, head), one thread per output column.  The
// partials' (m, l) are staged in shared memory first, so the loop over
// them issues independent loads of acc.
template <typename T>
__global__ void merge_kernel(const float* __restrict__ part_ml,
                             const float* __restrict__ part_acc,
                             T* __restrict__ out, int NP) {
  extern __shared__ float w[];  // NP weights
  const int HD = blockDim.x, d = threadIdx.x;
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * NP * 2;
  for (int p = d; p < NP; p += HD) w[p] = ml[2 * p];
  __syncthreads();
  float mx = NEG_INF;
  for (int p = 0; p < NP; ++p) mx = fmaxf(mx, w[p]);
  __syncthreads();
  for (int p = d; p < NP; p += HD) {
    const float l = ml[2 * p + 1];  // 0: empty, acc not written
    w[p] = l == 0.f ? 0.f : exp2f(w[p] - mx);
  }
  __syncthreads();
  float l = 0.f, o = 0.f;
#pragma unroll 4
  for (int p = 0; p < NP; ++p) {
    if (w[p] != 0.f) {
      l = fmaf(ml[2 * p + 1], w[p], l);
      o = fmaf(part_acc[(bh * NP + p) * HD + d], w[p], o);
    }
  }
  out[bh * HD + d] = from_float<T>(o / fmaxf(l, 1e-30f));
}

template <typename T, auto kernel>
cudaError_t launch(size_t smem, int parts, const void* q,
                   const void* k, const void* v, const int* lengths,
                   void* out, float* part_ml, float* part_acc, int B, int H,
                   int HD, int KVH, int W, int splits, int chunk, float scale,
                   cudaStream_t stream) {
  static bool smem_ok = false;
  cudaError_t err = allow_smem(kernel, smem, smem_ok);
  if (err != cudaSuccess) return err;
  const int G = H / KVH, groups = (G + GB - 1) / GB;
  const int NP = splits * parts;
  dim3 grid(splits, KVH * groups, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_ml, part_acc, H, KVH, W, chunk,
      NP, scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<T><<<B * H, HD, NP * sizeof(float), stream>>>(
      part_ml, part_acc, static_cast<T*>(out), NP);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, hd); k_cache/v_cache (B, W, KVH, hd); lengths (B,) int32; out
// (B, H, hd); part_ml (B, H, splits * 2, 2) and part_acc (B, H, splits * 2,
// hd) f32 scratch (a split writes one partial per head in bf16, 128 / hd
// in f32).  All contiguous and 16-byte aligned; q, caches and out
// of one dtype (DTYPE_F32 or DTYPE_BF16); hd is 64 or 128; splits * chunk
// >= W and chunk a multiple of 64.  Returns the cudaError_t of the launches.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache, const void* lengths,
                                    void* out, void* part_ml, void* part_acc,
                                    int B, int H, int KVH, int hd, int W,
                                    int splits, int chunk, float scale,
                                    int dtype, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (splits < 1 || chunk < 1 || chunk % SPLIT_ALIGN ||
      (long long)splits * chunk < W)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  if (dtype == DTYPE_F32 && hd == 64)
    return (int)launch<float, simt::split_kernel<64>>(
        simt::smem_bytes<64>(), simt::Shape<64>::LP, q, k_cache, v_cache, ln,
        out, ml, acc, B, H, 64, KVH, W, splits, chunk, scale, s);
  if (dtype == DTYPE_F32 && hd == 128)
    return (int)launch<float, simt::split_kernel<128>>(
        simt::smem_bytes<128>(), simt::Shape<128>::LP, q, k_cache, v_cache,
        ln, out, ml, acc, B, H, 128, KVH, W, splits, chunk, scale, s);
  if (dtype == DTYPE_BF16 && hd == 64)
    return (int)launch<__nv_bfloat16, mma::split_kernel<64>>(
        mma::smem_bytes<64>(), 1, q, k_cache, v_cache, ln, out, ml,
        acc, B, H, 64, KVH, W, splits, chunk, scale, s);
  if (dtype == DTYPE_BF16 && hd == 128)
    return (int)launch<__nv_bfloat16, mma::split_kernel<128>>(
        mma::smem_bytes<128>(), 1, q, k_cache, v_cache, ln, out, ml,
        acc, B, H, 128, KVH, W, splits, chunk, scale, s);
  return (int)cudaErrorInvalidValue;
}
