// Prefill attention for Hopper: causal or non-causal GQA attention with an
// optional sliding window, online softmax in f32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel).  There the KV-block axis is
// a sequential grid dimension carrying (m, l, acc) in VMEM scratch; here
// one thread block owns one (batch, head, 64-row query tile) and walks the
// KV tiles in a loop, keeping m and l in registers and the output tile in
// registers too.
//
// Bound on this card: bytes, by a small margin, at the main path's shape
// (B 8, S 512, H 24, KVH 2, hd 128, bf16).  A causal prefill of S tokens
// does 4 * B * H * hd * S * (S + 1) / 2 flops (1.29e10 here, 0.0130 ms at
// the 989 TFLOP/s bf16 tensor-core rate) against reading q, k, v and
// writing out once (54.5 MB, 0.0163 ms at 3.35 TB/s): about 237 flops per
// byte, under the ~295 ridge.  With G = 12 query heads per KV head, q and
// out carry most of those bytes.  Flops grow as S^2 and bytes as S, so
// prompts past ~640 tokens are bound by operations.  This first version
// runs the two products on the CUDA cores in f32 (scalar FMA from shared
// memory, 4x4 and 4x8 register tiles per thread), so it is far from
// either bound; wgmma with TMA-fed K/V tiles is the next step.
// What the design does about the bound now: it skips KV tiles that the
// causal mask or the window hide entirely (about half the tiles of a
// causal prefill), and reuses each K and V tile for 64 query rows.
//
// Any Sq and Skv are taken: rows past Sq are computed on zeros and never
// stored, keys past Skv are masked.  q_offset is the absolute position of
// query row 0 relative to key 0 (chunked prefill).
#include <stdint.h>

#include "common.cuh"

using namespace repro_torch;

namespace {

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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Sq,
                     int Skv, int H, int KVH, float scale, int causal,
                     int window, int q_offset) {
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
  const T* qb = q + (size_t)b * Sq * q_row + (size_t)h * HD;
  const T* kb = k + (size_t)b * Skv * kv_row + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * Skv * kv_row + (size_t)kvh * HD;
  T* ob = out + (size_t)b * Sq * q_row + (size_t)h * HD;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    Qs[r * LD + d] =
        (q0 + r < Sq) ? to_float(qb[(size_t)(q0 + r) * q_row + d]) : 0.f;
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
          (k0 + r < Skv) ? to_float(kb[(size_t)(k0 + r) * kv_row + d]) : 0.f;
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
          (k0 + r < Skv) ? to_float(vb[(size_t)(k0 + r) * kv_row + d]) : 0.f;
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
      ob[(size_t)r * q_row + tx + 16 * j] = from_float<T>(o[i][j] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int KVH, float scale,
                   int causal, int window, int q_offset, cudaStream_t stream) {
  static bool smem_ok = false;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, HD>, smem, smem_ok);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KVH, scale,
      causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, hd), k/v (B, Skv, KVH, hd), out (B, Sq, H, hd), all
// contiguous and of one dtype (DTYPE_F32 or DTYPE_BF16); hd is 64 or 128.
// window <= 0 means no window.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Skv, int H,
                                   int KVH, int hd, float scale, int causal,
                                   int window, int q_offset, int dtype,
                                   void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32 && hd == 64)
    return (int)launch<float, 64>(q, k, v, out, B, Sq, Skv, H, KVH, scale,
                                  causal, window, q_offset, s);
  if (dtype == DTYPE_F32 && hd == 128)
    return (int)launch<float, 128>(q, k, v, out, B, Sq, Skv, H, KVH, scale,
                                   causal, window, q_offset, s);
  if (dtype == DTYPE_BF16 && hd == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, out, B, Sq, Skv, H, KVH,
                                          scale, causal, window, q_offset, s);
  if (dtype == DTYPE_BF16 && hd == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, out, B, Sq, Skv, H, KVH,
                                           scale, causal, window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
