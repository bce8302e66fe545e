// Device code shared by the automorphism key switch (K6, auto_keyswitch.cu)
// and the GA blind rotation (K7, ga_scan.cu), for NVIDIA Hopper (sm_90a):
// the Galois permutation, the digit-row NTT multiply-accumulate and the
// TRLWE key switch against one keyset entry.
//
// Counterparts of the TPU package's kernel helpers (ops/pbs_kernel.py):
// `_galois_permute_limbs` (1077), `_ntt_mul_acc` / `_ntt_mul_acc_keyfn`
// (739) and the key-switch tail of `_make_auto_ks_stream_kernel` (2256).
// Everything ends in canonical residues or exact u64 words, so the kernels
// give the plain PyTorch versions' words.

#pragma once

#include "ntt_common.cuh"

namespace {

// dst[c][j] = +-src[c][(j ginv mod 2N) mod N], negated mod 2^64 when
// (j ginv mod 2N) >= N: the automorphism X -> X^g of the C polynomials of
// src, for an odd g with inverse ginv mod 2N (ginv = 1 copies).  2N divides
// 2^32, so the 32-bit product wraps harmlessly.  src (global or shared) and
// dst [C][N] must not overlap.  Block-wide; ends with a barrier.
__device__ void galois_permute(const uint64_t* src, uint64_t* dst, int ginv,
                               const PbsConsts& K) {
  const int N = K.N, CN = K.C * K.N;
  const unsigned mask = 2u * unsigned(N) - 1u;
  for (int idx = threadIdx.x; idx < CN; idx += blockDim.x) {
    const int c = idx >> K.logN, j = idx & (N - 1);
    const unsigned ic = (unsigned(j) * unsigned(ginv)) & mask;
    const uint64_t v = src[c * N + (ic & unsigned(N - 1))];
    dst[idx] = (ic & unsigned(N)) ? 0 - v : v;
  }
  __syncthreads();
}

// spec[c][p] = sum_{j < R} NTT(dec_{j % l}(src[j / l])) * key[j][c][p] for
// the first R digit rows of src [.][N] u64 (shared memory) under plan K:
// l = K.l digits of K.Bg_bit bits with the rounded offset.  key [R][C][PP][N]
// u32 canonical residues (global memory, coalesced along N), multiplied by
// Shoup with the companions keys, or by Barrett when keys is null (runtime
// keys).  One digit row's PP prime rows are transformed at a time in work
// [PP][N]; spec [C][PP][N] is zeroed here.  Block-wide; ends with a barrier.
template <int PP>
__device__ void digit_mul_acc(const uint64_t* src, int R,
                              const uint32_t* __restrict__ key,
                              const uint32_t* __restrict__ keys,
                              uint32_t* spec, uint32_t* work,
                              const PbsConsts& K,
                              const uint32_t* __restrict__ tw,
                              const uint32_t* __restrict__ tws) {
  const int N = K.N, C = K.C, l = K.l;
  for (int idx = threadIdx.x; idx < C * PP * N; idx += blockDim.x)
    spec[idx] = 0;
  for (int j = 0; j < R; ++j) {
    const int cj = j / l, d = j % l;
    for (int k = threadIdx.x; k < N; k += blockDim.x) {
      const int digit = gadget_digit(src[cj * N + k] + K.offset, d, K);
#pragma unroll
      for (int pi = 0; pi < PP; ++pi)
        work[pi * N + k] = small_residue(digit, K.p[pi]);
    }
    __syncthreads();
    forward_ntt<PP>(work, PP, K, tw, tws);
    for (int idx = threadIdx.x; idx < PP * N; idx += blockDim.x) {
      const int pi = idx >> K.logN, k = idx & (N - 1);
      const uint32_t p = K.p[pi], x = work[idx];
      for (int c = 0; c < C; ++c) {
        const size_t ko = (size_t(j * C + c) * PP + pi) * N + k;
        const uint32_t prod = keys ? shoup(x, key[ko], keys[ko], p)
                                   : barrett(x, key[ko], p, K.mup[pi]);
        uint32_t* sp = spec + (c * PP + pi) * N + k;
        *sp = add_mod(*sp, prod, p);
      }
    }
    __syncthreads();
  }
}

// The C*PP inverse NTTs of spec in place, then Garner (with 1/N) to exact
// u64 words: out[c] = INTT(spec[c]) when perm is null (the external
// product), else out = (0, .., 0, perm[C-1]) - INTT(spec) (the key switch).
// out (shared or global) may be the digit source of the preceding
// `digit_mul_acc` but not perm.  Block-wide; ends with a barrier.
template <int PP>
__device__ void inverse_to_words(uint32_t* spec, const uint64_t* perm,
                                 uint64_t* out, const PbsConsts& K,
                                 const uint32_t* __restrict__ itw,
                                 const uint32_t* __restrict__ itws) {
  const int N = K.N, C = K.C, CN = K.C * K.N;
  inverse_ntt<PP>(spec, C * PP, K, itw, itws);
  for (int idx = threadIdx.x; idx < CN; idx += blockDim.x) {
    const int c = idx >> K.logN, k = idx & (N - 1);
    const uint64_t w = garner<PP>(spec + c * PP * N, k, K);
    out[idx] = perm ? (c == C - 1 ? perm[idx] : 0) - w : w;
  }
  __syncthreads();
}

// The TRLWE key switch of perm = (a_0 .. a_{k-1}, b) [C][N] u64 (shared
// memory) against one keyset entry key [k t][C][PK][N] u32 (Barrett):
// out = (0, b) - sum_{j < k t} dec_j(a) (x) key[j], with the key-switch
// plan K (t = K.l).  Block-wide; ends with a barrier.
template <int PK>
__device__ void keyswitch_entry(const uint64_t* perm, uint64_t* out,
                                const uint32_t* __restrict__ key,
                                uint32_t* spec, uint32_t* work,
                                const PbsConsts& K,
                                const uint32_t* __restrict__ ftw,
                                const uint32_t* __restrict__ ftws,
                                const uint32_t* __restrict__ itw,
                                const uint32_t* __restrict__ itws) {
  digit_mul_acc<PK>(perm, (K.C - 1) * K.l, key, nullptr, spec, work, K, ftw,
                    ftws);
  inverse_to_words<PK>(spec, perm, out, K, itw, itws);
}

}  // namespace
