// Device code of the automorphism key switch on gathered keys (K6-old,
// the second entry of auto_keyswitch.cu), for NVIDIA Hopper (sm_90a): the
// digit-row NTT multiply-accumulate and the TRLWE key switch against one
// keyset entry, on the block-wide NTTs of ntt_common.cuh.  K6 itself,
// K1-delta (cmux_delta.cu) and the GA blind rotation (K7, ga_scan.cu) run
// on K1's schedule (rotate_sched.cuh); K7 takes only `dispatch_pk` from
// here.
//
// Counterparts of the TPU package's kernel helpers (ops/pbs_kernel.py):
// `_ntt_mul_acc_keyfn` (739) and the key-switch tail of
// `_make_auto_ks_kernel` (2134).
// Everything ends in canonical residues or exact torus words, so the kernels
// give the plain PyTorch versions' words.  Torus words are the type W:
// uint64_t at the 64-bit torus, uint32_t at the 32-bit one (the TPU body's
// `nl == 1` branches, pbs_kernel.py:2154 and :2180, with their Garner step
// `_garner_limb32` :725); every word operation wraps mod 2^(8 sizeof W).

#pragma once

#include "ntt_common.cuh"

namespace {

// spec[c][p] = sum_{j < R} NTT(dec_{j % l}(src[j / l])) * key[j][c][p] for
// the first R digit rows of src [.][N] W words (shared or global memory)
// under plan K: l = K.l digits of K.Bg_bit bits with the rounded offset of
// W's width, cast to W once (a u64 offset added to a u32 word would widen
// the sum and shift the digits by 64 bits).  key [R][C][PP][N] u32
// canonical residues (runtime keys: global memory, coalesced along N),
// multiplied by Barrett.  One digit row's PP prime rows are transformed at
// a time in work [PP][N]; spec [C][PP][N] is zeroed here.  Block-wide; ends
// with a barrier.
template <int PP, typename W>
__device__ void digit_mul_acc(const W* src, int R,
                              const uint32_t* __restrict__ key,
                              uint32_t* spec, uint32_t* work,
                              const PbsConsts& K,
                              const uint32_t* __restrict__ tw,
                              const uint32_t* __restrict__ tws) {
  const int N = K.N, C = K.C, l = K.l;
  const W offset = W(K.offset);
  for (int idx = threadIdx.x; idx < C * PP * N; idx += blockDim.x)
    spec[idx] = 0;
  for (int j = 0; j < R; ++j) {
    const int cj = j / l, d = j % l;
    for (int k = threadIdx.x; k < N; k += blockDim.x) {
      const int digit = gadget_digit<W>(src[cj * N + k] + offset, d, K);
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
        const uint32_t prod = barrett(x, key[ko], p, K.mup[pi]);
        uint32_t* sp = spec + (c * PP + pi) * N + k;
        *sp = add_mod(*sp, prod, p);
      }
    }
    __syncthreads();
  }
}

// The C*PP inverse NTTs of spec in place, then Garner (with 1/N) to exact
// W words (mod 2^32 for u32: the Horner step wraps): out = (0, .., 0,
// perm[C-1]) - INTT(spec), the key switch's words.  out (global) does not
// overlap perm.  Block-wide; ends with a barrier.
template <int PP, typename W>
__device__ void inverse_to_words(uint32_t* spec, const W* perm, W* out,
                                 const PbsConsts& K,
                                 const uint32_t* __restrict__ itw,
                                 const uint32_t* __restrict__ itws) {
  const int N = K.N, C = K.C, CN = K.C * K.N;
  inverse_ntt<PP>(spec, C * PP, K, itw, itws);
  for (int idx = threadIdx.x; idx < CN; idx += blockDim.x) {
    const int c = idx >> K.logN, k = idx & (N - 1);
    const W w = garner<PP, W>(spec + c * PP * N, k, K);
    out[idx] = (c == C - 1 ? perm[idx] : W(0)) - w;
  }
  __syncthreads();
}

// The TRLWE key switch of perm = (a_0 .. a_{k-1}, b) [C][N] W words (shared
// memory) against one keyset entry key [k t][C][PK][N] u32 (Barrett):
// out = (0, b) - sum_{j < k t} dec_j(a) (x) key[j], with the key-switch
// plan K (t = K.l).  Block-wide; ends with a barrier.
template <int PK, typename W>
__device__ void keyswitch_entry(const W* perm, W* out,
                                const uint32_t* __restrict__ key,
                                uint32_t* spec, uint32_t* work,
                                const PbsConsts& K,
                                const uint32_t* __restrict__ ftw,
                                const uint32_t* __restrict__ ftws,
                                const uint32_t* __restrict__ itw,
                                const uint32_t* __restrict__ itws) {
  digit_mul_acc<PK, W>(perm, (K.C - 1) * K.l, key, spec, work, K, ftw,
                       ftws);
  inverse_to_words<PK, W>(spec, perm, out, K, itw, itws);
}

// Calls f(std::integral_constant<int, PK>{}) for a key-switch plan's prime
// count PK: 2-5 with u64 words, 2 or 3 with u32 words (as `dispatch_pw`
// does for the words' own plan).  Any other count is refused.
template <typename W, typename F>
cudaError_t dispatch_pk(int PK, F&& f) {
  switch (PK) {
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    default: break;
  }
  if constexpr (sizeof(W) == 8) {
    switch (PK) {
      case 4: return f(std::integral_constant<int, 4>{});
      case 5: return f(std::integral_constant<int, 5>{});
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
