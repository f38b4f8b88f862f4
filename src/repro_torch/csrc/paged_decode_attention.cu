// Paged decode attention for Hopper: one query token per request against
// K/V read only through the request's block-table row.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// paged_decode_attention_pallas (body _paged_decode_kernel).  There the
// tables and lengths arrive by scalar prefetch and the grid walks all
// max_blocks blocks, masking the dead ones.  Here one thread block owns
// one (request, kv head): it reads its own table row and length, and
// walks only the tiles of live lines, gathering each line from the pool
// block its table names.  The kernel body, its bound and its next step
// are in decode_attention.cuh.
//
// Lengths past max_blocks * block_lines are clamped to it, and a table
// entry outside the pool masks its lines instead of reading outside the
// pool.  The plain version in kernels/decode_attention.py keeps the same
// contract, so a bad table gives the same answer on the CPU and on the
// card.
#include "decode_attention.cuh"

using namespace repro_torch;

// q (B, H, hd); k_pool/v_pool (num_blocks, block_lines, KVH, hd); tables
// (B, max_blocks) int32; lengths (B,) int32; out (B, H, hd).  All
// contiguous; q, pools and out of one dtype (DTYPE_F32 or DTYPE_BF16);
// hd is 64 or 128.  Returns the cudaError_t of the launch.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* lengths, void* out, int B, int H, int KVH, int hd,
    int num_blocks, int block_lines, int max_blocks, float scale, int dtype,
    void* stream) {
  return decode::dispatch(q, k_pool, v_pool, tables, lengths, out, B,
                                H, KVH, hd, num_blocks, block_lines,
                                max_blocks, scale, dtype, stream);
}
