// The whole GA blind rotation (MOSFHET's Galois-automorphism bootstrap,
// eprint 2022/198, `bootstrap_ga.c:39-60`) of a batch of TRLWE accumulators
// in one launch, for NVIDIA Hopper (sm_90a).  Per ciphertext and per step i,
// with g = gens[i][b] odd, exactly mod 2^64 (mod 2^32 at the 32-bit torus):
//
//   1. t = BK_i (x) acc, the replace-mode external product with
//      TRGSW(X^{s_i}) (l digits of Bg_bit bits, plan Kb);
//   2. (a', b') = psi_g(t), the automorphism X -> X^g, through
//      ginv = inv2n[(g - 1) / 2];
//   3. acc = (0, b') - sum_j dec_j(a') (x) AK[(g - 1) / 2][j], the key
//      switch back to the ring key (t digits of base_bit bits, plan Kk).
//
// Replaces the TPU kernel `ga_scan_fused` (the TPU package's
// ops/pbs_kernel.py:2558, body `_make_ga_scan_kernel` :2452).  The caller
// runs K6 (auto_keyswitch.cu) first for the initial psi_{w0}; the last
// generator is a_{n-1} itself.
//
// At the 32-bit torus (TORUS32) the same body runs on u32 words (the word
// type W): both stages' digits take their plan's 32-bit offset, cast to W
// once, the permutation negates mod 2^32 and Garner's Horner step wraps mod
// 2^32.  The TPU kernel has no such form (it asserts two limbs,
// pbs_kernel.py:2570; the TPU package runs the 32-bit GA rotation as a jnp
// scan); this one gives that scan's words.
//
// What bounds it on this card: integer operations.  Per step and ciphertext
// at TFHEpp-L2: (24 + 6 + 12 + 6) NTTs x 11,264 butterflies, 98,304 + 49,152
// key products and 2 x 4,096 Garner reconstructions, 1.6 times K1's step.
// Bytes: the 497 MB TRGSW key is shared by a wave's blocks through the 50 MB
// L2, but each block gathers its own 192 KiB keyset entry per step (63.6 GB
// over 632 steps and 512 ciphertexts, from a 403 MB keyset that L2 cannot
// hold), about half the operations' time at HBM's rate.
//
// Design.  K1's schedule (rotate_sched.cuh): one block per ciphertext runs
// the n steps as a loop; the block is split into groups of T = N/16 threads,
// one group per prime of the larger plan (PM = max(P, PK) primes; NG =
// min(PM, 1024/T) groups), each thread owning 16 coefficients of its
// group's row through the NTT passes, the MAC into its own window-0 slots of
// spec, and the inverse from those slots to natural order.  Both external
// products of a step run that way (`product_spectra`, rotate_sched.cuh),
// each on its own plan (twiddles, primes; a group with no prime of a plan
// waits at the next block barrier):
//   - stage 1 reads its digits straight from acc and, after a block
//     barrier, Garner *replaces* acc with t (K1 adds; `replace_acc`, whose
//     body, with stage 1's, is K3's, ext_product_apply.cu);
//   - stage 2 has no buffer: stage 3's digits read a'[c][k] =
//     +-t[c][(k ginv mod 2N) mod N] from acc, as K1 reads X^a acc;
//   - stage 3's Garner writes acc = (0, b') - INTT(.), b' = psi_g(t)[C-1].
//     A thread's b' words are read from acc into registers before the block
//     barrier that precedes Garner, since other threads overwrite acc after
//     it: every read of t precedes every write of the new acc.
// Four block barriers per step (one before and one after each Garner).
// Both MACs take Barrett products of key residues alone (`mac_product`):
// the TRGSW's Shoup companions svs are not read, which halves its L2
// traffic.  A keyset entry is runtime data gathered per ciphertext from HBM,
// so a thread asks L2 for a digit row's key words before the row's forward
// passes, which hide their latency.
//
// Buffers of a block, as K1's: acc [C][N] words, spec [C][PM][SR] u32 and
// work [NG][SR] u32 (SR = N + N/16 from N = 256): 108.5 KiB at TFHEpp-L2
// (N=2048, k=1, P=PK=3; two blocks per SM) and 67 KiB at its 32-bit form
// (P=PK=2; three per SM).  Where they do not all fit, the wrapper places
// them by traffic: work in shared memory, then spec, then acc; spec in a
// global workspace, acc updated in place in the caller's tensor (SET_3: acc
// in place).  The two plans are separate constant blocks: a key-switch plan
// may have another prime count, and its gadget offset differs whenever
// t != l or base_bit != Bg_bit.  N from 16 to 16384.

#include "rotate_sched.cuh"

namespace {

enum { kWork, kSpec, kAcc, kNumBuf };  // buffers, as the wrapper lists them

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

// K7: the whole GA rotation, one block per ciphertext.  LogN != 0: the
// compile-time shape of K1's 80-register instances (N = 2^LogN, k = 1, P
// and PK at most 3, all in shared memory).
template <int P, int PK, typename W, bool S, int LogN>
__global__ void __launch_bounds__(kBlockThreads<LogN>, kMinBlocks<LogN>)
ga_scan_kernel(W* __restrict__ acc_g, const int32_t* __restrict__ gens,
               const uint32_t* __restrict__ sv,
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
  constexpr bool Fixed = LogN != 0;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts Kb, Kk;
  if (threadIdx.x == 0) {
    Kb = Kbp;
    Kk = Kkp;
  }
  __syncthreads();
  Sched s;  // compile-time where LogN is
  make_sched(LogN ? LogN : Kb.logN, PM, s);
  const int N = 1 << s.logN, C = Fixed ? 2 : Kb.C, CN = C * N;
  const int J = C * Kb.l, JK = (C - 1) * Kk.l;
  // Garner's positions of a thread: k = threadIdx.x + r threads, r < keep
  // (threads >= T = N / kR, so keep <= kR)
  const int threads = s.NG * s.T, keep = (N + threads - 1) / threads;
  W* acc_b = acc_g + size_t(blockIdx.x) * CN;
  W* acc = buffer<S, W>(L, kAcc, smem, ws, acc_b);                // [C][N]
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);  // [C][PM][SR]
  auto* work = buffer<S, uint32_t>(L, kWork, smem, ws, nullptr);  // [NG][SR]
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += threads) acc[i] = acc_b[i];
  __syncthreads();

  const size_t step_stride = size_t(J) * C * P * N;
  const size_t entry = size_t(JK) * C * PK * N;
  for (int i = 0; i < n; ++i) {
    const int kidx = (gens[size_t(i) * B + blockIdx.x] - 1) >> 1;
    const int ginv = inv2n[kidx];
    // 1. t = BK_i (x) acc, replacing acc after every group's inverse NTTs
    product_spectra<P, PM, W, Fixed, false>(
        [&](int c, int k) { return acc[c * N + k]; }, J,
        sv + i * step_stride, spec, work, ftw, ftws, itw, itws, Kb, s);
    replace_acc<P, PM, W>(acc, spec, N, CN, threads, Kb, s);
    // 2-3. (a', b') = psi_g(t) read through ginv; the key switch's spectra
    //      against keyset entry (g - 1) / 2
    product_spectra<PK, PM, W, Fixed, true>(
        [&](int c, int k) { return permuted_word(acc + c * N, k, ginv, N); },
        JK, ak + kidx * entry, spec, work, kftw, kftws, kitw, kitws, Kk, s);
    // b' of this thread's Garner positions, read before the barrier after
    // which Garner overwrites acc
    W bp[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int k = threadIdx.x + r * threads;
      if (r < keep && k < N)
        bp[r] = permuted_word(acc + (C - 1) * N, k, ginv, N);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int k = threadIdx.x + r * threads;
      if (r < keep && k < N)
        for (int c = 0; c < C; ++c) {
          const W w = garner_rows<PK, W>(spec + c * PM * s.SR, s.SR, k, Kk);
          acc[c * N + k] = (c == C - 1 ? bp[r] : W(0)) - w;
        }
    }
    __syncthreads();
  }
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += threads) acc_b[i] = acc[i];
}

struct Args {
  void* acc;
  const int32_t* gens;
  const uint32_t *sv, *ak;
  const int32_t* inv2n;
  const uint32_t* const* tw;
  unsigned char* ws;
  int n, B;
  cudaStream_t stream;
  int* blocks_per_sm;  // non-null: report the residency, launch nothing
};

template <int P, int PK, typename W, bool S, int LogN>
cudaError_t launch(const Args& x, const PbsConsts& Kb, const PbsConsts& Kk,
                   const Layout& L, const Sched& s) {
  const uint32_t* const* tw = x.tw;
  return launch_sched(ga_scan_kernel<P, PK, W, S, LogN>, s, L, x.B, x.stream,
                      x.blocks_per_sm, static_cast<W*>(x.acc), x.gens, x.sv,
                      x.ak, x.inv2n, tw[0], tw[1], tw[2], tw[3], tw[4], tw[5],
                      tw[6], tw[7], x.ws, Kb, Kk, L, x.n, x.B);
}

template <int P, int PK, typename W>
cudaError_t launch_s(const Args& x, const PbsConsts& Kb, const PbsConsts& Kk,
                     const Layout& L, const Sched& s) {
  return with_log_n<(P > PK ? P : PK)>(Kb, [&](auto n) {
    if (!all_shared(L, kNumBuf))
      return launch<P, PK, W, false, 0>(x, Kb, Kk, L, s);
    return launch<P, PK, W, true, decltype(n)::value>(x, Kb, Kk, L, s);
  });
}

int launch_entry(void* acc, const void* gens, const void* sv, const void* ak,
                 const void* inv2n, const uint32_t* const* tw, void* ws,
                 const int64_t* consts, const int64_t* kconsts,
                 const int64_t* layout, int B, int n, int word_bits,
                 void* stream, int* blocks_per_sm = nullptr) {
  PbsConsts Kb, Kk;
  Sched s;
  if (!parse_consts(consts, Kb) || !parse_consts(kconsts, Kk) ||
      Kb.N != Kk.N || Kb.C != Kk.C ||
      !make_sched(Kb.logN, Kb.P > Kk.P ? Kb.P : Kk.P, s))
    return int(cudaErrorInvalidValue);
  if ((B == 0 || n == 0) && !blocks_per_sm) return int(cudaSuccess);
  const Args x{acc,
               static_cast<const int32_t*>(gens),
               static_cast<const uint32_t*>(sv),
               static_cast<const uint32_t*>(ak),
               static_cast<const int32_t*>(inv2n),
               tw,
               static_cast<unsigned char*>(ws),
               n,
               B,
               static_cast<cudaStream_t>(stream),
               blocks_per_sm};
  const Layout L = parse_layout(layout, kNumBuf);
  return int(dispatch_pw(Kb.P, word_bits, [&](auto p, auto w) {
    using W = decltype(w);
    constexpr int P = decltype(p)::value;
    return dispatch_pk<W>(Kk.P, [&](auto pk) {
      return launch_s<P, decltype(pk)::value, W>(x, Kb, Kk, L, s);
    });
  }));
}

}  // namespace

extern "C" {

// consts / kconsts: the bootstrap-key plan's and the key-switch plan's int64
// host arrays (layout in ntt_common.cuh); layout: the buffer placement (smem
// bytes, workspace stride, offsets of work, spec, acc); ws: the workspace,
// B x stride bytes (null when the stride is 0).  acc [B, k+1, N] u64 words
// (word_bits 64) or u32 words (word_bits 32, both plans' gadget offsets of
// that width) is rotated in place; gens [n, B] int32 odd, (g - 1) / 2 < G;
// sv [n, (k+1)l, k+1, P, N] u32 and ak [G, k t, k+1, PK, N] u32, both
// 16-byte aligned; svs, the TRGSW's Shoup companions, is not read (the
// MAC's Barrett products need only the residues); inv2n [N] int32;
// twiddles [P, N] and [PK, N] u32.
int ga_scan_launch(void* acc, const void* gens, const void* sv,
                   const void* svs, const void* ak, const void* inv2n,
                   const void* ftw, const void* ftws, const void* itw,
                   const void* itws, const void* kftw, const void* kftws,
                   const void* kitw, const void* kitws, void* ws,
                   const int64_t* consts, const int64_t* kconsts,
                   const int64_t* layout, int B, int n, int word_bits,
                   void* stream) {
  const uint32_t* tw[8] = {
      static_cast<const uint32_t*>(ftw),  static_cast<const uint32_t*>(ftws),
      static_cast<const uint32_t*>(itw),  static_cast<const uint32_t*>(itws),
      static_cast<const uint32_t*>(kftw), static_cast<const uint32_t*>(kftws),
      static_cast<const uint32_t*>(kitw), static_cast<const uint32_t*>(kitws)};
  return launch_entry(acc, gens, sv, ak, inv2n, tw, ws, consts, kconsts,
                      layout, B, n, word_bits, stream);
}

// The blocks of K7 resident on one SM at the two plans' shape, the
// placement and the word width (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// on the current device), and the threads of a block.
int ga_scan_residency(const int64_t* consts, const int64_t* kconsts,
                      const int64_t* layout, int word_bits, int* blocks,
                      int* threads) {
  PbsConsts Kb, Kk;
  Sched s;
  if (!parse_consts(consts, Kb) || !parse_consts(kconsts, Kk) ||
      !make_sched(Kb.logN, Kb.P > Kk.P ? Kb.P : Kk.P, s))
    return int(cudaErrorInvalidValue);
  *threads = s.NG * s.T;
  const uint32_t* tw[8] = {};
  return launch_entry(nullptr, nullptr, nullptr, nullptr, nullptr, tw,
                      nullptr, consts, kconsts, layout, 0, 1, word_bits,
                      nullptr, blocks);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
