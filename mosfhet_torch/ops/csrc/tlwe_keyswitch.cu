// The select-sum of the TLWE key switch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `tlwe_keyswitch_sum` (the TPU package's
// ops/pbs_kernel.py:2070, body `_make_tlwe_ks_kernel` :2015).  For each
// ciphertext b and table column c it computes, exactly mod 2^64,
//
//   out[b][c] = sum over (i, j) with d = dig[b][i][j] in [1, base) of
//               ab[i][j][d - 1][c]
//
// where ab [n_in][t][base-1][n_out+1] is the KS table (mask words, then b in
// the last column).  Digit 0 adds nothing (the reference's `if aij != 0`,
// `tlwe.c:289-303`); so does any digit outside [1, base), as in the TPU
// kernel's select chain.  The caller forms (0, b) - out.  At the 32-bit
// torus (TORUS32) the table holds u32 words and the sum is mod 2^32: the
// TPU kernel's one-plane form (`nl == 1`, pbs_kernel.py:2115); the same
// body runs on the word type W.
//
// Design.  The TPU kernel streams the table through VMEM along a sequential
// grid axis, carries the sum in scratch, picks each row with a (base-1)-way
// select over a 64-ciphertext tile and adds in two u32 limbs.  Hopper adds
// u64 natively and runs blocks in no order, so here one thread owns one
// column of one ciphertext: grid (B, ceil((n_out+1) / 128)), 128 threads.
// The block stages its ciphertext's digits in shared memory in tiles of
// 4096 (16 KiB) and walks (i, j) in order; the digit is the same
// for every thread of the block, so the skip never diverges, and the 128
// threads read 1 KiB of one table row, coalesced.  Sums mod 2^64 are exact
// in any order, so the result is bit-identical to the plain PyTorch version.
//
// What bounds it on this card.  At TFHEpp-L2, B=512 (n_in=2048, t=8,
// base-1=15, n_out+1=633): 512 x 2048 x 8 x 633 = 5.31e9 u64 adds, two
// INT32 operations each, 1.06e10 over 132 SMs x 64 lanes x 1980 MHz =
// 0.635 ms; the table (1.244e9 B) plus digits and output over 3.35 TB/s is
// 0.38 ms.  So operations bound it, at ~0.64 ms.  This design does not reach
// that: every ciphertext gathers its own 16,384 rows, 42.5 GB in all at
// B=512, which only the 50 MB L2 can serve at the rate needed (blocks walk
// (i, j) in step, so concurrent blocks share the rows of the same (i, j)).
// Tiling ciphertexts in a block, so that each row is read once per tile,
// is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // table columns per block
constexpr int kTile = 4096;    // digits staged in shared memory per pass

template <typename W>
__global__ void __launch_bounds__(kThreads)
tlwe_keyswitch_sum_kernel(const int32_t* __restrict__ dig,
                          const W* __restrict__ ab, W* __restrict__ out,
                          int n_rows, int base_m1, int width) {
  __shared__ int32_t sd[kTile];
  const int b = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  const bool live = col < width;
  const int32_t* db = dig + size_t(b) * n_rows;
  W acc = 0;
  for (int r0 = 0; r0 < n_rows; r0 += kTile) {
    const int nr = min(kTile, n_rows - r0);
    __syncthreads();  // the previous tile is consumed
    for (int r = threadIdx.x; r < nr; r += kThreads) sd[r] = db[r0 + r];
    __syncthreads();
    if (live) {
      // row (r, v) of this tile starts at ((r0 + r) * base_m1 + v) * width
      const W* tab = ab + size_t(r0) * base_m1 * width + col;
#pragma unroll 8
      for (int r = 0; r < nr; ++r) {
        const unsigned v = unsigned(sd[r]) - 1u;  // digit 0 -> out of range
        if (v < unsigned(base_m1))
          acc += __ldg(tab + (size_t(r) * base_m1 + v) * width);
      }
    }
  }
  if (live) out[size_t(b) * width + col] = acc;
}

}  // namespace

extern "C" {

// dig [B, n_rows] int32 (n_rows = n_in * t); ab [n_rows, base_m1, width]
// and out [B, width] (fully written) u64 words (word_bits 64) or u32 words
// (word_bits 32).  Returns the launch's cudaGetLastError() code.
int tlwe_keyswitch_sum_launch(const void* dig, const void* ab, void* out,
                              int B, int n_rows, int base_m1, int width,
                              int word_bits, void* stream) {
  if (B < 0 || n_rows < 0 || base_m1 < 1 || width < 0 ||
      (word_bits != 32 && word_bits != 64))
    return int(cudaErrorInvalidValue);
  if (B == 0 || width == 0) return int(cudaSuccess);
  const dim3 grid(unsigned(B), unsigned((width + kThreads - 1) / kThreads));
  if (grid.y > 65535) return int(cudaErrorInvalidValue);
  const auto* d = static_cast<const int32_t*>(dig);
  const auto st = static_cast<cudaStream_t>(stream);
  if (word_bits == 32)
    tlwe_keyswitch_sum_kernel<uint32_t><<<grid, kThreads, 0, st>>>(
        d, static_cast<const uint32_t*>(ab), static_cast<uint32_t*>(out),
        n_rows, base_m1, width);
  else
    tlwe_keyswitch_sum_kernel<uint64_t><<<grid, kThreads, 0, st>>>(
        d, static_cast<const uint64_t*>(ab), static_cast<uint64_t*>(out),
        n_rows, base_m1, width);
  return int(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
