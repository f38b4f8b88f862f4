// Mamba-1 selective scan for Hopper, in f32:
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) outer B_t
//   y_t = h_t . C_t + D * x_t
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py::
// mamba_scan_pallas (body _scan_kernel).  There a (C_BLK, N) state tile
// stays in VMEM while a sequential grid axis walks time blocks.  Blocks on
// this card run in parallel and in no order, so nothing can carry across
// them: here one thread owns one (batch, channel) and keeps its N state
// values and its N decay rates in registers for the whole sequence, and
// the time loop runs inside the block.  A block covers 128 neighbouring
// channels; the grid is ceil(C / 128) x B (at B = 1 and C = 16384, 128
// blocks on 132 SMs).
//
// Per tile of TT time steps the block stages x and dt (TT x 128, read
// coalesced across channels) and B_t, C_t (TT x N, shared by every
// channel of the block) in shared memory, then each thread steps through
// the tile and writes y_t, again coalesced across channels.  h0 is read
// and h_final written once per thread.
//
// Bound on this card: bytes.  x, dt and y are each B * S * C * 4 bytes
// and must cross memory once; the B * S * C * N exps and their FMAs are
// the operations side.  The first version serialises each tile's loads
// and its compute inside a block, with 4 warps per SM: the load of the
// next tile does not overlap the recurrence of this one.  The next steps
// are double-buffered tiles (cp.async) and a chunked, parallel-in-time
// scan (the recurrence is linear in h, so chunk states combine by a
// second pass) that fills the SMs at small B * C.
//
// It takes any S >= 0 and any C; the ragged channel edge is masked.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int CB = 128;   // channels per block, one thread each
constexpr int TT = 32;    // time steps per staged tile

template <int N>
__global__ void __launch_bounds__(CB)
    mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      const float* __restrict__ a, const float* __restrict__ d,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_out, int S, int C) {
  __shared__ float xs[TT][CB];
  __shared__ float ds[TT][CB];
  __shared__ float bs[TT][N];
  __shared__ float cs[TT][N];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.x * CB + tid;
  const bool live = c < C;

  float h[N], an[N];
  float dd = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = live ? h0[((size_t)b * C + c) * N + n] : 0.f;
    an[n] = live ? a[(size_t)c * N + n] : 0.f;
  }
  if (live) dd = d[c];

  const size_t row0 = (size_t)b * S;  // row of (b, t) is row0 + t
  for (int t0 = 0; t0 < S; t0 += TT) {
    const int nt = min(TT, S - t0);
    __syncthreads();  // the previous tile is consumed
    for (int r = 0; r < nt; ++r) {
      const size_t idx = (row0 + t0 + r) * C + c;
      xs[r][tid] = live ? x[idx] : 0.f;
      ds[r][tid] = live ? dt[idx] : 0.f;
    }
    for (int i = tid; i < nt * N; i += CB) {
      const size_t idx = (row0 + t0) * N + i;
      bs[i / N][i % N] = bm[idx];
      cs[i / N][i % N] = cm[idx];
    }
    __syncthreads();
    if (!live) continue;
    for (int r = 0; r < nt; ++r) {
      const float xt = xs[r][tid];
      const float dtt = ds[r][tid];
      const float dx = dtt * xt;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtt * an[n]) * h[n] + dx * bs[r][n];
        acc = fmaf(h[n], cs[r][n], acc);
      }
      y[(row0 + t0 + r) * C + c] = acc + dd * xt;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[((size_t)b * C + c) * N + n] = h[n];
  }
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* bm,
                   const float* cm, const float* a, const float* d,
                   const float* h0, float* y, float* h_out, int B, int S,
                   int C, cudaStream_t stream) {
  dim3 grid((C + CB - 1) / CB, B);
  mamba_scan_kernel<N><<<grid, CB, 0, stream>>>(x, dt, bm, cm, a, d, h0, y,
                                                h_out, S, C);
  return cudaGetLastError();
}

}  // namespace

// x, dt (B, S, C); b_ssm, c_ssm (B, S, N); a (C, N); d (C,); h0 (B, C, N);
// y (B, S, C) and h_out (B, C, N) are written.  All f32 and contiguous;
// N is 8 or 16.  Returns the cudaError_t of the launch.
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
    return (int)launch<8>(xf, dtf, bf, cf, af, df, hf, yf, of, B, S, C, s);
  if (N == 16)
    return (int)launch<16>(xf, dtf, bf, cf, af, df, hf, yf, of, B, S, C, s);
  return (int)cudaErrorInvalidValue;
}
