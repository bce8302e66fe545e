// The whole GA blind rotation (MOSFHET's Galois-automorphism bootstrap,
// eprint 2022/198, `bootstrap_ga.c:39-60`) of a batch of TRLWE accumulators
// in one launch, for NVIDIA Hopper (sm_90a).  Per ciphertext and per step i,
// with g = gens[i][b] odd, exactly mod 2^64 (mod 2^32 at the 32-bit torus):
//
//   1. t = BK_i (x) acc, the replace-mode external product with
//      TRGSW(X^{s_i}) (l digits of Bg_bit bits, Shoup keys, plan Kb);
//   2. (a', b') = psi_g(t), the automorphism X -> X^g, through
//      ginv = inv2n[(g - 1) / 2];
//   3. acc = (0, b') - sum_j dec_j(a') (x) AK[(g - 1) / 2][j], the key
//      switch back to the ring key (t digits of base_bit bits, Barrett
//      keys, plan Kk).
//
// Replaces the TPU kernel `ga_scan_fused` (the TPU package's
// ops/pbs_kernel.py:2558, body `_make_ga_scan_kernel` :2452).  The caller
// runs K6 (auto_keyswitch.cu) first for the initial psi_{w0}; the last
// generator is a_{n-1} itself.
//
// At the 32-bit torus (TORUS32) the same body runs on u32 words (the word
// type W): both stages' digits take their plan's 32-bit offset, cast to W
// once, the permutation negates mod 2^32 and Garner's Horner step wraps mod
// 2^32, as in the one-limb K3 (ext_product_apply.cu) and K6.  The TPU
// kernel has no such form (it asserts two limbs, pbs_kernel.py:2570; the
// TPU package runs the 32-bit GA rotation as a jnp scan); this one gives
// that scan's words.
//
// Design.  As K1 (blind_rotate.cu): one block of 1024 threads per
// ciphertext runs the n steps as a loop, the accumulator held in shared
// memory for the whole rotation.  The permutation is a gather, so it cannot
// run in place: it writes a second C x N buffer (perm), which the key
// switch decomposes and whose b it subtracts from; the key switch writes the
// new accumulator.  Shared memory: acc 32 KiB + perm 32 KiB + spectra 48 KiB
// + one digit row's NTTs 24 KiB = 136 KiB at TFHEpp-L2, one block per SM.
// Where they do not all fit (320 KiB at N=4096 with 4 primes) the wrapper
// keeps the NTT rows and the spectra in shared memory, perm in a global
// workspace and acc in place in the caller's tensor.
// The two plans are separate constant blocks: a key-switch plan may have
// another prime count, and its gadget offset differs whenever t != l or
// base_bit != Bg_bit.  Keyset entries are runtime data (per ciphertext and
// step), read straight from global memory, coalesced along N.
//
// What bounds it on this card: integer multiplies.  Per step and ciphertext
// at TFHEpp-L2: (24 + 6 + 12 + 6) NTTs x 11,264 butterflies, 98,304 Shoup
// and 49,152 Barrett key products and 2 x 4,096 Garner words, 1.58 times
// K1's step.  Bytes: the 497 MB TRGSW key is shared by a wave's blocks
// through the 50 MB L2, but each block gathers its own 192 KiB keyset entry
// per step (63.6 GB over 632 steps and 512 ciphertexts, from a 403 MB
// keyset that L2 cannot hold), still below the operations at HBM's rate.

#include "ga_common.cuh"

namespace {

constexpr int kThreads = 1024;
enum { kWork, kSpec, kPerm, kAcc, kNumBuf };  // buffers, as the wrapper lists

template <int P, int PK, typename W, bool S>
__global__ void __launch_bounds__(kThreads, 1)
ga_scan_kernel(W* __restrict__ acc_g, const int32_t* __restrict__ gens,
               const uint32_t* __restrict__ sv,
               const uint32_t* __restrict__ svs,
               const uint32_t* __restrict__ ak,
               const int32_t* __restrict__ inv2n,
               const uint32_t* __restrict__ ftw,
               const uint32_t* __restrict__ ftws,
               const uint32_t* __restrict__ itw,
               const uint32_t* __restrict__ itws,
               const uint32_t* __restrict__ kftw,
               const uint32_t* __restrict__ kftws,
               const uint32_t* __restrict__ kitw,
               const uint32_t* __restrict__ kitws, unsigned char* ws,
               const PbsConsts Kbp, const PbsConsts Kkp, const Layout L,
               int n, int B) {
  constexpr int PM = P > PK ? P : PK;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts Kb, Kk;
  if (threadIdx.x == 0) {
    Kb = Kbp;
    Kk = Kkp;
  }
  __syncthreads();
  const int N = Kb.N, C = Kb.C, CN = Kb.C * Kb.N, J = Kb.C * Kb.l;
  const int b = blockIdx.x;
  W* acc_b = acc_g + size_t(b) * CN;
  W* acc = buffer<S, W>(L, kAcc, smem, ws, acc_b);                  // [C][N]
  W* perm = buffer<S, W>(L, kPerm, smem, ws, nullptr);              // [C][N]
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);  // [C][PM][N]
  auto* work = buffer<S, uint32_t>(L, kWork, smem, ws, nullptr);  // [PM][N]
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += blockDim.x) acc[i] = acc_b[i];
  __syncthreads();

  const size_t step_stride = size_t(J) * C * P * N;
  const size_t entry = size_t(C - 1) * Kk.l * C * PK * N;
  for (int s = 0; s < n; ++s) {
    const int kidx = (gens[size_t(s) * B + b] - 1) >> 1;
    // 1. t = BK_s (x) acc, replacing acc
    digit_mul_acc<P, W>(acc, J, sv + s * step_stride, svs + s * step_stride,
                        spec, work, Kb, ftw, ftws);
    inverse_to_words<P, W>(spec, nullptr, acc, Kb, itw, itws);
    // 2. perm = psi_g(t)
    galois_permute<W>(acc, perm, inv2n[kidx], Kb);
    // 3. acc = (0, b') - KS(a') with keyset entry (g - 1) / 2
    keyswitch_entry<PK, W>(perm, acc, ak + kidx * entry, spec, work, Kk,
                           kftw, kftws, kitw, kitws);
  }
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += blockDim.x) acc_b[i] = acc[i];
}

struct Args {
  void* acc;
  const int32_t* gens;
  const uint32_t *sv, *svs, *ak;
  const int32_t* inv2n;
  const uint32_t* const* tw;
  unsigned char* ws;
  int n, B;
  cudaStream_t stream;
};

template <int P, int PK, typename W, bool S>
cudaError_t launch_s(const Args& x, const PbsConsts& Kb, const PbsConsts& Kk,
                     const Layout& L) {
  cudaError_t err = cudaFuncSetAttribute(
      ga_scan_kernel<P, PK, W, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.smem));
  if (err != cudaSuccess) return err;
  const uint32_t* const* tw = x.tw;
  ga_scan_kernel<P, PK, W, S><<<x.B, kThreads, L.smem, x.stream>>>(
      static_cast<W*>(x.acc), x.gens, x.sv, x.svs, x.ak, x.inv2n, tw[0],
      tw[1], tw[2], tw[3], tw[4], tw[5], tw[6], tw[7], x.ws, Kb, Kk, L, x.n,
      x.B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// consts / kconsts: the bootstrap-key plan's and the key-switch plan's int64
// host arrays (layout in ntt_common.cuh); layout: the buffer placement (smem
// bytes, workspace stride, offsets of work, spec, perm, acc); ws: the
// workspace, B x stride bytes (null when the stride is 0).  acc [B, k+1, N]
// u64 words (word_bits 64) or u32 words (word_bits 32, both plans' gadget
// offsets of that width) is rotated in place; gens [n, B] int32 odd,
// (g - 1) / 2 < G; sv/svs [n, (k+1)l, k+1, P, N] u32; ak [G, k t, k+1,
// PK, N] u32; inv2n [N] int32; twiddles [P, N] and [PK, N] u32.
int ga_scan_launch(void* acc, const void* gens, const void* sv,
                   const void* svs, const void* ak, const void* inv2n,
                   const void* ftw, const void* ftws, const void* itw,
                   const void* itws, const void* kftw, const void* kftws,
                   const void* kitw, const void* kitws, void* ws,
                   const int64_t* consts, const int64_t* kconsts,
                   const int64_t* layout, int B, int n, int word_bits,
                   void* stream) {
  PbsConsts Kb, Kk;
  if (!parse_consts(consts, Kb) || !parse_consts(kconsts, Kk) ||
      Kb.N != Kk.N || Kb.C != Kk.C)
    return int(cudaErrorInvalidValue);
  if (B == 0 || n == 0) return int(cudaSuccess);
  const uint32_t* tw[8] = {
      static_cast<const uint32_t*>(ftw),  static_cast<const uint32_t*>(ftws),
      static_cast<const uint32_t*>(itw),  static_cast<const uint32_t*>(itws),
      static_cast<const uint32_t*>(kftw), static_cast<const uint32_t*>(kftws),
      static_cast<const uint32_t*>(kitw), static_cast<const uint32_t*>(kitws)};
  const Args x{acc,
               static_cast<const int32_t*>(gens),
               static_cast<const uint32_t*>(sv),
               static_cast<const uint32_t*>(svs),
               static_cast<const uint32_t*>(ak),
               static_cast<const int32_t*>(inv2n),
               tw,
               static_cast<unsigned char*>(ws),
               n,
               B,
               static_cast<cudaStream_t>(stream)};
  const Layout L = parse_layout(layout, kNumBuf);
  const bool shared = all_shared(L, kNumBuf);
  return int(dispatch_pw(Kb.P, word_bits, [&](auto p, auto w) {
    using W = decltype(w);
    constexpr int P = decltype(p)::value;
    return dispatch_pk<W>(Kk.P, [&](auto pk) {
      constexpr int PK = decltype(pk)::value;
      return shared ? launch_s<P, PK, W, true>(x, Kb, Kk, L)
                    : launch_s<P, PK, W, false>(x, Kb, Kk, L);
    });
  }));
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
