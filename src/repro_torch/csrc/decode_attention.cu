// Dense decode attention for Hopper: one query token per request against
// its own (W, KVH, hd) rows of a dense cache, lines >= lengths[b] masked.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention_pallas (body _decode_kernel), the decode attention of
// every stack that does not page (the hybrid Mamba+attention stack among
// them).  There the grid walks all W / block_k cache blocks of every
// request and masks the dead ones.  Here one thread block owns one
// (request, kv head) and reads its rows of the cache directly, with no
// table: line `pos` of request `b` is row b * W + pos.  It walks only the
// tiles of live lines, so a step reads each live K/V line once and no
// line past the length.  The kernel body, its bound (bytes) and its next
// step (flash-decoding) are in decode_attention.cuh, shared with the
// paged kernel.
//
// Lengths are clamped to [0, W]; a row of length 0 writes 0, as the TPU
// kernel does.  The plain version in kernels/decode_attention.py keeps the
// same contract.
#include "decode_attention.cuh"

using namespace repro_torch;

// q (B, H, hd); k_cache/v_cache (B, W, KVH, hd); lengths (B,) int32; out
// (B, H, hd).  All contiguous; q, caches and out of one dtype (DTYPE_F32
// or DTYPE_BF16); hd is 64 or 128.  Returns the cudaError_t of the launch.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache, const void* lengths,
                                    void* out, int B, int H, int KVH, int hd,
                                    int W, float scale, int dtype,
                                    void* stream) {
  // one "block" of W lines per request, at rows b * W of the cache
  return decode::dispatch<false>(q, k_cache, v_cache, nullptr, lengths, out,
                                 B, H, KVH, hd, B, W, 1, scale, dtype,
                                 stream);
}
