// Mamba-1 selective scan for Hopper, in f32:
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) outer B_t
//   y_t = h_t . C_t + D * x_t
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py::
// mamba_scan_pallas (body _scan_kernel).  There a (C_BLK, N) state tile
// stays in VMEM while a sequential grid axis walks time blocks.  Blocks on
// this card run in parallel and in no order, so nothing can carry across
// them: here the state stays in registers for the whole sequence and the
// time loop runs inside the block.
//
// Bound on this card: the exponentials and the bytes, about equally.  x,
// dt and y each cross memory once (3 * B * S * C * 4 bytes), and each of
// the B * S * C * N state updates needs one exp, which only the SFU
// computes (16 per clock per SM on compute capability 9.0).  At Jamba's
// C = 16384, N = 16 that is 262,144 independent recurrences per request,
// so the design spreads them wide:
//
// * Each channel's N states are spread over 4 lanes, N / 4 a lane, so a
//   256-thread block covers 64 channels and the card holds C * 4 threads
//   per request (16 warps per SM at B 1, C 16384).  A lane's states are
//   independent chains, so the one dependent FMA per step and state hides
//   behind the others and the other warps.
// * exp(dt * A) is ex2.approx of dt * (A * log2 e), with A scaled once per
//   thread: one SFU op and one multiply per update.
// * y_t is summed across a channel's lanes once per tile, not per step:
//   each lane leaves its part of y_t in shared memory, and after the tile
//   one thread per (step, channel) adds the 4 parts and D * x_t and stores
//   y coalesced across channels.  That keeps shuffles and scattered
//   stores out of the recurrence's loop.
// * x and dt (TT steps x 64 channels, coalesced across channels) and B_t,
//   C_t (TT x N, shared by every channel of the block) come into shared
//   memory by cp.async, double-buffered, so the next tile's loads overlap
//   this tile's recurrence.  16-byte copies where C is a multiple of 4,
//   4-byte copies otherwise.
// * h0 is read and h_final written once per thread.
//
// A chunked, parallel-in-time scan (chunk states combined in a second
// pass) is not built: it would add a pass and more exps to a kernel whose
// parallel width already fills the card at B 1.
//
// It takes any S >= 0 (S = 0 returns h0's values) and any C; the ragged
// channel edge is masked.
#include <stdint.h>

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int THREADS = 256;
constexpr int L = 4;              // lanes per channel
constexpr int CB = THREADS / L;   // channels per block
constexpr int TT = 32;            // time steps per staged tile
constexpr float LOG2E = 1.4426950408889634f;

// x, dt and B, C tiles (two buffers each), the lanes' parts of y, D
template <int N>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * 2 * (size_t)TT * CB + 2 * 2 * (size_t)TT * N +
                          (size_t)TT * THREADS + CB);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// BYTES (4 or 16) from src to shared dst, zero-filled where !ok.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// VEC: floats per copy of x and dt, 4 where C % 4 == 0, else 1.
template <int N, int VEC>
__global__ void __launch_bounds__(THREADS)
    mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      const float* __restrict__ a, const float* __restrict__ d,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_out, int S, int C) {
  constexpr int SP = N / L;  // states per lane
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [2][TT][CB]
  float* ds = xs + 2 * TT * CB;     // [2][TT][CB]
  float* bs = ds + 2 * TT * CB;     // [2][TT][N]
  float* cs = bs + 2 * TT * N;      // [2][TT][N]
  float* ps = cs + 2 * TT * N;      // [TT][THREADS]: each lane's part of y_t
  float* dsh = ps + TT * THREADS;   // [CB]: D of the block's channels

  const int tid = threadIdx.x;
  const int cl = tid / L, sub = tid % L;  // channel in the block, lane in it
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CB;
  const int c = c0 + cl;
  const bool live = c < C;

  float h[SP], a2[SP];
#pragma unroll
  for (int s = 0; s < SP; s += 2) {
    float2 hv = make_float2(0.f, 0.f), av = make_float2(0.f, 0.f);
    if (live) {
      hv = *reinterpret_cast<const float2*>(h0 + ((size_t)b * C + c) * N +
                                            SP * sub + s);
      av = *reinterpret_cast<const float2*>(a + (size_t)c * N + SP * sub + s);
    }
    h[s] = hv.x;
    h[s + 1] = hv.y;
    a2[s] = av.x * LOG2E;
    a2[s + 1] = av.y * LOG2E;
  }
  for (int k = tid; k < CB; k += THREADS) dsh[k] = c0 + k < C ? d[c0 + k] : 0.f;

  const size_t row0 = (size_t)b * S;  // row of (b, t) is row0 + t
  const int n_tiles = (S + TT - 1) / TT;
  // tile i into buffer i % 2; past the last tile, an empty group
  auto load = [&](int i) {
    if (i < n_tiles) {
      const int buf = i & 1, t0 = i * TT, nt = min(TT, S - t0);
      constexpr int PER_ROW = CB / VEC;
      for (int k = tid; k < TT * PER_ROW; k += THREADS) {
        const int r = k / PER_ROW, cc = (k % PER_ROW) * VEC;
        const bool ok = r < nt && c0 + cc < C;
        const size_t src = ok ? (row0 + t0 + r) * C + c0 + cc : 0;
        cp_async<4 * VEC>(xs + (buf * TT + r) * CB + cc, x + src, ok);
        cp_async<4 * VEC>(ds + (buf * TT + r) * CB + cc, dt + src, ok);
      }
      for (int k = tid; k < TT * N / 4; k += THREADS) {
        const bool ok = 4 * k < nt * N;
        const size_t src = ok ? (row0 + t0) * N + 4 * k : 0;
        cp_async<16>(bs + buf * TT * N + 4 * k, bm + src, ok);
        cp_async<16>(cs + buf * TT * N + 4 * k, cm + src, ok);
      }
    }
    cp_async_commit();
  };

  load(0);
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();  // tile i has landed
    // ... for every thread, and tile i - 1's buffers and y parts are
    // consumed, so its buffer takes tile i + 1 while tile i runs
    __syncthreads();
    load(i + 1);
    const int buf = i & 1, t0 = i * TT, nt = min(TT, S - t0);
    const float* xt = xs + buf * TT * CB;
    const float* dtt = ds + buf * TT * CB;
    const float* bt = bs + buf * TT * N;
    const float* ct = cs + buf * TT * N;
#pragma unroll 4
    for (int r = 0; r < nt; ++r) {
      const float xr = xt[r * CB + cl], dtr = dtt[r * CB + cl];
      const float dx = dtr * xr;
      float bv[SP], cv[SP];
      if constexpr (SP % 4 == 0) {
#pragma unroll
        for (int s = 0; s < SP; s += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(
              bt + r * N + SP * sub + s);
          const float4 c4 = *reinterpret_cast<const float4*>(
              ct + r * N + SP * sub + s);
          bv[s] = b4.x; bv[s + 1] = b4.y; bv[s + 2] = b4.z; bv[s + 3] = b4.w;
          cv[s] = c4.x; cv[s + 1] = c4.y; cv[s + 2] = c4.z; cv[s + 3] = c4.w;
        }
      } else {
#pragma unroll
        for (int s = 0; s < SP; s += 2) {
          const float2 b2 = *reinterpret_cast<const float2*>(
              bt + r * N + SP * sub + s);
          const float2 c2 = *reinterpret_cast<const float2*>(
              ct + r * N + SP * sub + s);
          bv[s] = b2.x; bv[s + 1] = b2.y;
          cv[s] = c2.x; cv[s + 1] = c2.y;
        }
      }
#pragma unroll
      for (int s = 0; s < SP; ++s)
        h[s] = fmaf(ex2(dtr * a2[s]), h[s], dx * bv[s]);
      float acc = h[0] * cv[0];
#pragma unroll
      for (int s = 1; s < SP; ++s) acc = fmaf(h[s], cv[s], acc);
      ps[r * THREADS + tid] = acc;
    }
    __syncthreads();
    // y_t of each (step, channel): its 4 lanes' parts, added as a xor-2,
    // xor-1 butterfly would, then D * x_t
    for (int k = tid; k < nt * CB; k += THREADS) {
      const int r = k / CB, ch = k % CB;
      if (c0 + ch < C) {
        const float* pp = ps + r * THREADS + ch * L;
        float v[L];
#pragma unroll
        for (int j = 0; j < L; ++j) v[j] = pp[j];
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
          for (int j = 0; j < off; ++j) v[j] += v[j + off];
        y[(row0 + t0 + r) * C + c0 + ch] =
            fmaf(dsh[ch], xt[r * CB + ch], v[0]);
      }
    }
  }
  cp_async_wait_all();  // the empty group committed past the last tile
  if (live) {
#pragma unroll
    for (int s = 0; s < SP; ++s)
      h_out[((size_t)b * C + c) * N + SP * sub + s] = h[s];
  }
}

template <int N, int VEC>
cudaError_t launch(const float* x, const float* dt, const float* bm,
                   const float* cm, const float* a, const float* d,
                   const float* h0, float* y, float* h_out, int B, int S,
                   int C, cudaStream_t stream) {
  static bool smem_ok = false;
  constexpr size_t smem = smem_bytes<N>();
  cudaError_t err = allow_smem(mamba_scan_kernel<N, VEC>, smem, smem_ok);
  if (err != cudaSuccess) return err;
  dim3 grid((C + CB - 1) / CB, B);
  mamba_scan_kernel<N, VEC><<<grid, THREADS, smem, stream>>>(
      x, dt, bm, cm, a, d, h0, y, h_out, S, C);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_n(const float* x, const float* dt, const float* bm,
                     const float* cm, const float* a, const float* d,
                     const float* h0, float* y, float* h_out, int B, int S,
                     int C, cudaStream_t stream) {
  if (C % 4 == 0)
    return launch<N, 4>(x, dt, bm, cm, a, d, h0, y, h_out, B, S, C, stream);
  return launch<N, 1>(x, dt, bm, cm, a, d, h0, y, h_out, B, S, C, stream);
}

}  // namespace

// x, dt (B, S, C); b_ssm, c_ssm (B, S, N); a (C, N); d (C,); h0 (B, C, N);
// y (B, S, C) and h_out (B, C, N) are written.  All f32, contiguous and
// 16-byte aligned; N is 8 or 16.  Returns the cudaError_t of the launch.
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const void* b_ssm,
                              const void* c_ssm, const void* a, const void* d,
                              const void* h0, void* y, void* h_out, int B,
                              int S, int C, int N, void* stream) {
  if (B <= 0 || C <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* bf = static_cast<const float*>(b_ssm);
  const float* cf = static_cast<const float*>(c_ssm);
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(d);
  const float* hf = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* of = static_cast<float*>(h_out);
  if (N == 8)
    return (int)launch_n<8>(xf, dtf, bf, cf, af, df, hf, yf, of, B, S, C, s);
  if (N == 16)
    return (int)launch_n<16>(xf, dtf, bf, cf, af, df, hf, yf, of, B, S, C, s);
  return (int)cudaErrorInvalidValue;
}
