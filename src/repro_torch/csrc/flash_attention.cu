// Prefill attention for Hopper: causal or non-causal GQA attention with an
// optional sliding window, online softmax in f32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel).  There the KV-block axis is
// a sequential grid dimension carrying (m, l, acc) in VMEM scratch; here
// one thread block owns one (batch, head, query tile) and walks the KV
// tiles in a loop, keeping m, l and the output tile in registers.
//
// Bound on this card: bytes, by a small margin, at the main path's shape
// (B 8, S 512, H 24, KVH 2, hd 128, bf16).  A causal prefill of S tokens
// does 4 * B * H * hd * S * (S + 1) / 2 flops (1.29e10 here, 0.0130 ms at
// the 989 TFLOP/s bf16 tensor-core rate) against reading q, k, v and
// writing out once (54.5 MB, 0.0163 ms at 3.35 TB/s): about 237 flops per
// byte, under the ~295 ridge.  With G = 12 query heads per KV head, q and
// out carry most of those bytes.  Flops grow as S^2 and bytes as S, so
// prompts past ~640 tokens are bound by operations.  Either way only the
// tensor cores can come near the bound, so:
//
// bf16 (the serving path): warp-specialised, on wgmma and TMA.
//   * One block per (head, batch, 128-row query tile): two consumer
//     warpgroups of 64 rows each and one producer warp, 288 threads.
//   * The producer issues TMA loads (4-d tensor maps over (B, S, heads,
//     hd), 128-byte swizzle, so a ragged S edge reads as zeros per batch):
//     the Q tile once, then K and V tiles of 128 keys into a 2-stage ring,
//     each stage with its own full (K, V) and empty mbarriers.
//   * S = Q K^T runs as wgmma m64n128k16 from shared memory (both operands
//     K-major).  The online softmax (exp2, scale folded in) runs on the
//     accumulator fragments; a row's max and sum reduce over the 4 threads
//     of a quad.  P is split into two bf16 terms in registers (hi + lo, so
//     it keeps ~16 bits) that are wgmma's A operand for O += P V, with V
//     read from shared memory as an MN-major B.
//   * Tiles that the causal mask or the window hide entirely are skipped;
//     only edge tiles are masked.  The heaviest query tiles (the last, under
//     the causal mask) are launched first.
//   * O is normalised, packed to bf16 into the warpgroup's (now free) Q
//     tile in the swizzled layout, and written by a TMA store that clips
//     rows past Sq.
//   An hd-128 row is two 64-element boxes: a 128-byte-swizzled box is at
//   most 128 bytes wide, and the wgmma descriptors name the same swizzle.
//   Measured at the main shape on an NVIDIA H100 80GB HBM3 (700 W power
//   limit; kernel_times.py, L2 evicted, device time after a spin):
//   0.110-0.111 ms, against 0.729-0.731 ms for the CUDA-core version it
//   replaced on the same clock, back to back on one card, and 0.046 ms for
//   torch's scaled_dot_product_attention.  What holds it back: 168
//   registers, the cap for a 288-thread block, so one warpgroup cannot
//   overlap a tile's softmax with the next tile's products (queuing the next
//   Q K^T behind P V spilled and ran slower); P V runs twice (hi + lo).
//
// f32 (only the decode-vs-prefill consistency checks use it): the products
//   stay on the CUDA cores in full f32 (scalar FMA from shared memory).
//   TF32 wgmma would keep about three decimal digits, which the 1e-4 kernel
//   tolerance and the 1e-3 * max|logit| consistency gate do not allow.
//
// Any Sq and Skv are taken: rows past Sq are computed on zeros and never
// stored, keys past Skv are masked.  q_offset is the absolute position of
// query row 0 relative to key 0 (chunked prefill).  A row that sees no key
// writes 0 (l is clamped at 1e-30).
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

using namespace repro_torch;

namespace {

// ---- bf16: wgmma + TMA ------------------------------------------------------

namespace tc {

using namespace repro_torch::hopper;

constexpr int BQ = 128;                 // query rows per block
constexpr int BK = 128;                 // keys per tile (wgmma N of S)
constexpr int STAGES = 2;               // K/V ring depth
constexpr int CONSUMERS = 256;          // two warpgroups
constexpr int THREADS = CONSUMERS + 32; // plus the producer warp
constexpr uint32_t BOX = 8192;          // one 64-row x 64-column bf16 box

// Shared memory, from a 1024-byte aligned base: per warpgroup its Q tile
// (64 rows, HD / 64 boxes); per stage a K and a V tile (BK rows, HD / 64
// boxes of BK x 128 bytes); then the mbarriers.
template <int HD>
struct Layout {
  static constexpr uint32_t Q_WG = (HD / 64) * BOX;
  static constexpr uint32_t KV_HALF = BK * 128;
  static constexpr uint32_t KV_TILE = (HD / 64) * KV_HALF;
  static constexpr uint32_t K = 2 * Q_WG;
  static constexpr uint32_t V = K + STAGES * KV_TILE;
  static constexpr uint32_t BAR = V + STAGES * KV_TILE;
  static constexpr uint32_t BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;
};

// O (64 x HD) += P (64 x 16, registers) V (16 x HD, smem, MN-major)
template <int HD>
__device__ __forceinline__ void mma_pv(float (&d)[HD / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 64) wgmma_rs_n64<1>(d, a, b, 1);
  else wgmma_rs_n128<1>(d, a, b, 1);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_o, int Sq, int Skv,
                     int H, int KVH, float scale_log2, int causal, int window,
                     int q_offset) {
  using L = Layout<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_k = bar_q + 8;                // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * STAGES;
  const uint32_t bar_e = bar_v + 8 * STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tiles first
  const int kvh = h / (H / KVH);

  // the KV range any real row of this tile can see
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + BQ, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_first - window + 1);
  kv_begin = (kv_begin / BK) * BK;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, CONSUMERS / 32);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // ---- producer warp ----
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * L::Q_WG);
      for (int wg = 0; wg < 2; ++wg)
        for (int half = 0; half < HD / 64; ++half)
          tma_load_4d(base + wg * L::Q_WG + half * BOX, &tm_q, bar_q,
                      64 * half, h, q0 + 64 * wg, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(bar_e + 8 * s, ((it / STAGES) - 1) & 1);
        const int k0 = kv_begin + it * BK;
        mbar_arrive_expect_tx(bar_k + 8 * s, L::KV_TILE);
        for (int half = 0; half < HD / 64; ++half)
          tma_load_4d(base + L::K + s * L::KV_TILE + half * L::KV_HALF, &tm_k,
                      bar_k + 8 * s, 64 * half, kvh, k0, b);
        mbar_arrive_expect_tx(bar_v + 8 * s, L::KV_TILE);
        for (int half = 0; half < HD / 64; ++half)
          tma_load_4d(base + L::V + s * L::KV_TILE + half * L::KV_HALF, &tm_v,
                      bar_v + 8 * s, 64 * half, kvh, k0, b);
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  // Accumulator fragment of wgmma m64nN: register 4j + e of a thread holds
  // row r_lo (e < 2) or r_lo + 8 (e >= 2), column 8j + cq + (e & 1).
  const int wg = warp / 4;
  const int r_lo = 16 * (warp % 4) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qpos_lo = q_offset + q0 + 64 * wg + r_lo;
  const int qpos_hi = qpos_lo + 8;
  const uint32_t qs = base + wg * L::Q_WG;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const int k0 = kv_begin + it * BK;
    const uint32_t ks = base + L::K + s * L::KV_TILE;
    const uint32_t vs = base + L::V + s * L::KV_TILE;

    // S = Q K^T
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    mbar_wait(bar_k + 8 * s, parity);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n128<0>(
          sc, desc_sw128(qs + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024),
          desc_sw128(ks + (kk / 4) * L::KV_HALF + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // mask (edge tiles only), then the online softmax in base 2
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > q_first) ||
                      (window > 0 && q_offset + q0 + BQ - 1 - k0 >= window);
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
        const int qpos = (i & 2) ? qpos_hi : qpos_lo;
        if (!(kpos < Skv && (!causal || kpos <= qpos) &&
              (window <= 0 || qpos - kpos < window)))
          x = NEG_INF;
      }
      sc[i] = x;
      if (i & 2) mx_hi = fmaxf(mx_hi, x);
      else mx_lo = fmaxf(mx_lo, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float c_lo = exp2f(m_lo - mn_lo), c_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float mn = (i & 2) ? mn_hi : mn_lo;
      const float p = sc[i] <= NEG_INF ? 0.f : exp2f(sc[i] - mn);
      sc[i] = p;
      if (i & 2) sum_hi += p;
      else sum_lo += p;
    }
    l_lo = l_lo * c_lo + sum_lo;  // this thread's columns; the quad sums last
    l_hi = l_hi * c_hi + sum_hi;

    // P as wgmma's A fragments: k-slice kk is accumulator chunks 2kk, 2kk+1.
    // P = hi + lo, both bf16, so P V keeps P to about 16 bits where one
    // bf16 term would round it to 8 (an output near 4 would then move by a
    // whole bf16 step, 0.03, against the f32 plain version)
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], p_hi[kk][r],
                   p_lo[kk][r]);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 2) ? c_hi : c_lo;

    // O += P V: V is MN-major (hd contiguous); a k-slice is 16 keys = 2048
    // bytes, and the two 64-column halves of hd 128 lie KV_HALF apart
    mbar_wait(bar_v + 8 * s, parity);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t vd = desc_sw128(vs + kk * 2048, L::KV_HALF, 1024);
      mma_pv<HD>(o, p_hi[kk], vd);
      mma_pv<HD>(o, p_lo[kk], vd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_e + 8 * s);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);

  // O into this warpgroup's Q tile, swizzled as the TMA store reads it
  named_bar_sync(1 + wg, 128);  // every warp's last read of Q is done
  unsigned char* ot = sbase + wg * L::Q_WG;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int box = j / 8, chunk = j % 8;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r_lo + 8 * e;
      const float inv = e ? inv_hi : inv_lo;
      const uint32_t off =
          box * BOX + r * 128 + ((chunk ^ (r & 7)) * 16) + cq * 2;
      *reinterpret_cast<uint32_t*>(ot + off) =
          pack_bf16(o[4 * j + 2 * e] * inv, o[4 * j + 2 * e + 1] * inv);
    }
  }
  fence_proxy_async();
  named_bar_sync(1 + wg, 128);
  if (tid % 128 == 0) {
    for (int half = 0; half < HD / 64; ++half)
      tma_store_4d(&tm_o, qs + half * BOX, 64 * half, h, q0 + 64 * wg, b);
    tma_store_drain();
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int KVH, float scale,
                   int causal, int window, int q_offset, cudaStream_t stream) {
  if (Skv <= 0)  // no key: every row is 0
    return cudaMemsetAsync(out, 0, (size_t)B * Sq * H * HD * 2, stream);
  CUtensorMap tq, tk, tv, to;
  if (!make_map_bf16_4d(&tq, q, HD, H, Sq, B, 64) ||
      !make_map_bf16_4d(&tk, k, HD, KVH, Skv, B, BK) ||
      !make_map_bf16_4d(&tv, v, HD, KVH, Skv, B, BK) ||
      !make_map_bf16_4d(&to, out, HD, H, Sq, B, 64))
    return cudaErrorInvalidValue;
  static bool smem_ok = false;
  cudaError_t err =
      allow_smem(flash_fwd_kernel<HD>, Layout<HD>::BYTES, smem_ok);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<HD><<<grid, THREADS, Layout<HD>::BYTES, stream>>>(
      tq, tk, tv, to, Sq, Skv, H, KVH, scale * 1.4426950408889634f, causal,
      window, q_offset);
  return cudaGetLastError();
}

}  // namespace tc


// ---- f32: products on the CUDA cores -------------------------------------

namespace f32 {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per tile
constexpr int THREADS = 256;       // a 16 x 16 thread grid
constexpr int PS_STRIDE = BK + 16; // P tile row stride: conflict-free halves

template <int HD>
constexpr size_t smem_bytes() {
  // Q tile + one K-or-V tile (rows padded to HD + 1) + the P tile
  return sizeof(float) * ((size_t)BQ * (HD + 1) + (size_t)BK * (HD + 1) +
                          (size_t)BQ * PS_STRIDE);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int Sq, int Skv, int H, int KVH, float scale,
                     int causal, int window, int q_offset) {
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LD
  float* KVs = Qs + BQ * LD;    // BK x LD: K for the scores, then V
  float* Ps = KVs + BK * LD;    // BQ x PS_STRIDE

  const int tid = threadIdx.x;
  const int tx = tid & 15;      // key column / output column group
  const int ty = tid >> 4;      // query row group
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = h / (H / KVH);

  const size_t q_row = (size_t)H * HD;
  const size_t kv_row = (size_t)KVH * HD;
  const float* qb = q + (size_t)b * Sq * q_row + (size_t)h * HD;
  const float* kb = k + (size_t)b * Skv * kv_row + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * Skv * kv_row + (size_t)kvh * HD;
  float* ob = out + (size_t)b * Sq * q_row + (size_t)h * HD;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    Qs[r * LD + d] =
        (q0 + r < Sq) ? qb[(size_t)(q0 + r) * q_row + d] : 0.f;
  }

  // the KV range any real row of this tile can see
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + BQ, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_first - window + 1);
  kv_begin = (kv_begin / BK) * BK;

  float m[4], l[4], o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) o[i][j] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // Qs written / previous tile's V and P consumed
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      KVs[r * LD + d] =
          (k0 + r < Skv) ? kb[(size_t)(k0 + r) * kv_row + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      bool ok[4];
      float rowmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Skv && (!causal || kpos <= qpos) &&
                (window <= 0 || qpos - kpos < window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        rowmax = fmaxf(rowmax, s[i][j]);
      }
      // the 16 threads of one row are lanes tx of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, off));
      const float m_new = fmaxf(m[i], rowmax);
      const float corr = expf(m[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * PS_STRIDE + tx + 16 * j] = p;
        rowsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
      l[i] = l[i] * corr + rowsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) o[i][j] *= corr;
    }
    __syncthreads();  // scores done with K; P written

    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      KVs[r * LD + d] =
          (k0 + r < Skv) ? vb[(size_t)(k0 + r) * kv_row + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PS_STRIDE + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = KVs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) o[i][j] = fmaf(p[i], vv[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      ob[(size_t)r * q_row + tx + 16 * j] = o[i][j] / denom;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int KVH, float scale,
                   int causal, int window, int q_offset, cudaStream_t stream) {
  static bool smem_ok = false;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = allow_smem(flash_fwd_kernel<HD>, smem, smem_ok);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H, KVH,
      scale, causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// q (B, Sq, H, hd), k/v (B, Skv, KVH, hd), out (B, Sq, H, hd), all
// contiguous and of one dtype (DTYPE_F32 or DTYPE_BF16); hd is 64 or 128;
// bf16 pointers 16-byte aligned (TMA).  window <= 0 means no window.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Skv, int H,
                                   int KVH, int hd, float scale, int causal,
                                   int window, int q_offset, int dtype,
                                   void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32 && hd == 64)
    return (int)f32::launch<64>(q, k, v, out, B, Sq, Skv, H, KVH, scale,
                                causal, window, q_offset, s);
  if (dtype == DTYPE_F32 && hd == 128)
    return (int)f32::launch<128>(q, k, v, out, B, Sq, Skv, H, KVH, scale,
                                 causal, window, q_offset, s);
  if (dtype == DTYPE_BF16 && hd == 64)
    return (int)tc::launch<64>(q, k, v, out, B, Sq, Skv, H, KVH, scale,
                               causal, window, q_offset, s);
  if (dtype == DTYPE_BF16 && hd == 128)
    return (int)tc::launch<128>(q, k, v, out, B, Sq, Skv, H, KVH, scale,
                                causal, window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
