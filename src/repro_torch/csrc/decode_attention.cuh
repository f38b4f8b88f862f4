// One-token GQA decode attention for Hopper: the body of the paged kernel
// (paged_decode_attention.cu).  Line `pos` of request `b` lives in the
// block pool, in the block that the request's table row names.
//
// One thread block owns one (request, kv head).  It walks only the
// ceil(len / 64) tiles of live lines, loads each K/V tile once into
// shared memory, and shares it among the G = H / KVH query heads of its KV
// head (G need not be a power of two).  Scores, softmax and the output
// accumulators are f32 (online softmax).
//
// Bound on this card: bytes.  Each step must read every live K and V line
// once (2 * len * KVH * hd * dtype bytes per request); the flops are two
// skinny products, a few per byte.  This first version keeps the reads
// minimal (live lines only, each line once per KV head) but puts only
// B * KVH blocks on the card, so at small batch most SMs idle and the
// kernel is latency bound.  The next step is flash-decoding, as the
// dense-cache kernel (decode_attention.cu) does: split each request's
// lines over several blocks and merge their (m, l, acc) partials in a
// second short pass.
//
// A row of length 0 writes 0 (l is clamped at 1e-30, as in the TPU
// kernels).  Lengths are clamped to max_blocks * block_lines, and a
// line whose table entry lies outside [0, num_blocks) is masked instead of
// read.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace decode {

constexpr int TK = 64;          // lines per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <int HD>
size_t smem_bytes(int G) {
  return sizeof(float) * ((size_t)G * HD          // q
                          + (size_t)TK * (HD + 1) // K tile, padded rows
                          + (size_t)TK * HD       // V tile
                          + (size_t)G * TK        // scores / probabilities
                          + (size_t)G * HD        // output accumulators
                          + 3 * (size_t)G)        // m, l, correction
         + sizeof(long long) * TK;                // cache row of each line
}

// k and v are (rows, KVH, HD).  Line `pos` of request `b` is row
// tables[b][pos / block_lines] * block_lines + pos % block_lines.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ tables,
                  const int* __restrict__ lengths, T* __restrict__ out,
                  int H, int KVH, int num_blocks, int block_lines,
                  int max_blocks, float scale) {
  constexpr int LD = HD + 1;
  const int G = H / KVH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* rows = reinterpret_cast<long long*>(smem_raw);
  float* Qs = reinterpret_cast<float*>(rows + TK);  // G x HD
  float* Ks = Qs + G * HD;                          // TK x LD
  float* Vs = Ks + TK * LD;                         // TK x HD
  float* Ss = Vs + TK * HD;                         // G x TK
  float* Os = Ss + G * TK;                          // G x HD
  float* Ms = Os + G * HD;                          // G
  float* Ls = Ms + G;                               // G
  float* Cs = Ls + G;                               // G

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int len = max(0, min(lengths[b], max_blocks * block_lines));
  const int* table = tables + (size_t)b * max_blocks;
  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * HD;

  for (int i = tid; i < G * HD; i += THREADS) {
    Qs[i] = to_float(qb[i]);
    Os[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }

  for (int t0 = 0; t0 < len; t0 += TK) {
    const int n = min(TK, len - t0);
    __syncthreads();  // previous tile fully consumed
    if (tid < TK) {
      long long row = -1;
      if (tid < n) {
        const int pos = t0 + tid;
        const int blk = table[pos / block_lines];
        if (blk >= 0 && blk < num_blocks)
          row = (long long)blk * block_lines + pos % block_lines;
      }
      rows[tid] = row;
    }
    __syncthreads();
    for (int i = tid; i < TK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      const long long row = rows[r];
      float kx = 0.f, vx = 0.f;
      if (row >= 0) {
        const size_t idx = ((size_t)row * KVH + kvh) * HD + d;
        kx = to_float(k[idx]);
        vx = to_float(v[idx]);
      }
      Ks[r * LD + d] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();

    for (int p = tid; p < G * TK; p += THREADS) {
      const int g = p / TK, r = p % TK;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) acc = fmaf(Qs[g * HD + d], Ks[r * LD + d], acc);
      Ss[p] = (r < n && rows[r] >= 0) ? acc * scale : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int r = lane; r < TK; r += 32) mx = fmaxf(mx, Ss[g * TK + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < TK; r += 32) {
        const bool live = r < n && rows[r] >= 0;
        const float p = live ? expf(Ss[g * TK + r] - m_new) : 0.f;
        Ss[g * TK + r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Cs[g] = corr;
        Ls[g] = Ls[g] * corr + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    for (int p = tid; p < G * HD; p += THREADS) {
      const int g = p / HD, d = p % HD;
      float acc = Os[p] * Cs[g];
      for (int r = 0; r < n; ++r) acc = fmaf(Ss[g * TK + r], Vs[r * HD + d], acc);
      Os[p] = acc;
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * H + (size_t)kvh * G) * HD;
  for (int p = tid; p < G * HD; p += THREADS)
    ob[p] = from_float<T>(Os[p] / fmaxf(Ls[p / HD], 1e-30f));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* lengths, void* out, int B,
                   int H, int KVH, int num_blocks, int block_lines,
                   int max_blocks, float scale, cudaStream_t stream) {
  static bool smem_ok = false;
  static size_t smem_max = 0;
  const size_t smem = smem_bytes<HD>(H / KVH);
  if (smem > smem_max) {  // a larger G needs a larger opt-in
    smem_ok = false;
    cudaError_t err = allow_smem(decode_kernel<T, HD>, smem, smem_ok);
    if (err != cudaSuccess) return err;
    smem_max = smem;
  }
  dim3 grid(KVH, B);
  decode_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, lengths, static_cast<T*>(out), H, KVH,
      num_blocks, block_lines, max_blocks, scale);
  return cudaGetLastError();
}

// The four (dtype, head dim) instances the wrapper accepts.
inline int dispatch(const void* q, const void* k, const void* v,
                    const void* tables, const void* lengths, void* out, int B,
                    int H, int KVH, int hd, int num_blocks, int block_lines,
                    int max_blocks, float scale, int dtype, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == DTYPE_F32 && hd == 64)
    return (int)launch<float, 64>(q, k, v, tb, ln, out, B, H, KVH, num_blocks,
                                  block_lines, max_blocks, scale, s);
  if (dtype == DTYPE_F32 && hd == 128)
    return (int)launch<float, 128>(q, k, v, tb, ln, out, B, H, KVH,
                                   num_blocks, block_lines, max_blocks, scale,
                                   s);
  if (dtype == DTYPE_BF16 && hd == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, tb, ln, out, B, H, KVH,
                                          num_blocks, block_lines, max_blocks,
                                          scale, s);
  if (dtype == DTYPE_BF16 && hd == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, tb, ln, out, B, H, KVH,
                                           num_blocks, block_lines,
                                           max_blocks, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace repro_torch
