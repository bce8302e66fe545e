// The automorphism key switch of a batch of TRLWEs in one launch, for NVIDIA
// Hopper (sm_90a): per ciphertext b, with (a', b') = psi_g(x[b]) the Galois
// automorphism X -> X^g (g given by ginv[b] = g^-1 mod 2N; 1 leaves x as it
// is),
//
//   out[b] = (0, b') - sum_{j < k t} dec_j(a') (x) AK[kidx[b]][j]
//
// exactly mod 2^64 (mod 2^32 at the 32-bit torus).  Replaces the TPU kernel
// `auto_keyswitch_stream` (the TPU package's ops/pbs_kernel.py:2374, body
// `_make_auto_ks_stream_kernel` :2256, with its in-kernel permutation
// `ginv`).  It is the GA bootstrap's initial psi_{w0} key switch, each key
// switch of `bootstrap_ga.blind_rotate_ga_stepwise`,
// `keyswitch.trlwe_keyswitch` (one keyset entry, ginv 1) and
// `keyswitch.eval_automorphism` (ginv = gen^-1).
//
// Its second entry (K6-old) replaces the TPU kernel `auto_keyswitch`
// (ops/pbs_kernel.py:2200, body `_make_auto_ks_kernel` :2134): the input is
// already permuted and each ciphertext's keyset entry was gathered for it
// beforehand, key_rows [B, k t, k+1, P, N].  That is K6 with ginv = 1 (the
// identity: k * 1 mod 2N = k < N, no sign) and the entry index b, so the
// entry launches the same kernel in its Gathered instances, whose block b
// reads its key at key_rows + b * entry and takes ginv 1 at compile time
// (K6's own instances, and their registers, stay as they were).  It is
// `bootstrap_ga.blind_rotate_ga_gathered`'s key switch.
//
// At the 32-bit torus (TORUS32) it runs on u32 words (the word type W):
// the permutation negates mod 2^32, the key switch's gadget offset is cast
// to W once, and Garner's Horner step wraps mod 2^32 (the TPU bodies'
// `nl == 1` branches, pbs_kernel.py:2154/2180 and :2326/2355, through
// `_garner_limb32` :725).  The NTT side is the same at both widths.
//
// Design of K6: K1's schedule (rotate_sched.cuh), K7's stages 2-3
// (ga_scan.cu) once per launch.  One block per ciphertext, split into
// groups of T = N/16 threads, one group per prime of the key-switch plan
// (NG = min(P, 1024/T) groups).  The block loads x[b] coalesced into acc
// [C][N]; there is no permutation buffer: the key switch's digits read
// a'[c][k] = +-x[c][(k ginv mod 2N) mod N] from acc (`permuted_word`).  Per
// digit row each thread runs the forward passes on its 16 digits and a
// Barrett multiply-accumulate against keyset entry kidx[b] (runtime
// residues, 16-byte loads, each row's key words asked of L2 before its
// forward passes, which hide their latency) into its own slots of spec;
// then the inverse NTTs to natural order (`product_spectra`), one block
// barrier, and Garner writing out[b] = (0, b') - INTT(.), b' = psi_g(x)[C-1]
// read from acc.  out is distinct from x, so nothing overwrites acc and no
// barrier follows.
//
// What bounds it on this card: bytes, at the GA path's B=512.  Each
// ciphertext reads its own 192 KiB keyset entry (distinct entries for
// random generators, ~450 of 2048 at B=512) and 32 KiB in and out, against
// 18 NTTs x 11,264 butterflies + 49,152 Barrett products of work.  K6-old
// reads B distinct entries, one gathered row per ciphertext.
//
// Buffers of a block, as K7's with one plan: acc [C][N] words, spec
// [C][P][SR] u32 and work [NG][SR] u32 (SR = N + N/16 from N = 256):
// 108.5 KiB at TFHEpp-L2 (N=2048, k=1, P=3; two blocks of 384 threads per
// SM) and 67 KiB at its 32-bit form (P=2; three of 256).  Where they do not
// all fit, the wrapper places them by traffic: work in shared memory, then
// spec, then acc; spec in a global workspace, acc left out, the block then
// reading x in place (SET_3's 4-prime key-switch plan: x in place).

#include "rotate_sched.cuh"

namespace {

enum { kWork, kSpec, kAcc, kNumBuf };  // buffers, as the wrapper lists them

// K6, one block per ciphertext.  ak [G][k t][C][PK][N] u32 residues,
// 16-byte aligned.  LogN != 0: the compile-time shape of K1's 80-register
// instances (N = 2^LogN, k = 1, PK at most 3, all in shared memory).
// Gathered (K6-old): ak holds one entry per ciphertext, block b reads
// entry b with ginv 1; kidx and ginv are not read.
template <int PK, typename W, bool S, int LogN, bool Gathered>
__global__ void __launch_bounds__(kBlockThreads<LogN>, kMinBlocks<LogN>)
auto_keyswitch_kernel(const W* __restrict__ x_g,
                      const uint32_t* __restrict__ ak,
                      const int32_t* __restrict__ kidx,
                      const int32_t* __restrict__ ginv,
                      W* __restrict__ out_g,
                      const uint32_t* __restrict__ ftw,
                      const uint32_t* __restrict__ ftws,
                      const uint32_t* __restrict__ itw,
                      const uint32_t* __restrict__ itws, unsigned char* ws,
                      const PbsConsts Kp, const Layout L) {
  constexpr bool Fixed = LogN != 0;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  Sched s;  // compile-time where LogN is
  make_sched(LogN ? LogN : K.logN, PK, s);
  const int N = 1 << s.logN, C = Fixed ? 2 : K.C, CN = C * N;
  const int JK = (C - 1) * K.l, threads = s.NG * s.T;
  // x is only read: where acc is left out of shared memory it is x itself
  W* x_b = const_cast<W*>(x_g) + size_t(blockIdx.x) * CN;
  W* acc = buffer<S, W>(L, kAcc, smem, ws, x_b);                  // [C][N]
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);  // [C][PK][SR]
  auto* work = buffer<S, uint32_t>(L, kWork, smem, ws, nullptr);  // [NG][SR]
  if (acc != x_b)
    for (int i = threadIdx.x; i < CN; i += threads) acc[i] = x_b[i];
  __syncthreads();

  const int gi = Gathered ? 1 : ginv[blockIdx.x];
  const size_t entry = size_t(JK) * C * PK * N;
  product_spectra<PK, PK, W, Fixed, true>(
      [&](int c, int k) { return permuted_word(acc + c * N, k, gi, N); }, JK,
      ak + (Gathered ? int(blockIdx.x) : kidx[blockIdx.x]) * entry, spec,
      work, ftw, ftws, itw, itws, K, s);
  __syncthreads();
  W* out = out_g + size_t(blockIdx.x) * CN;
  for (int idx = threadIdx.x; idx < CN; idx += threads) {
    const int c = idx >> s.logN, k = idx & (N - 1);
    const W w = garner_rows<PK, W>(spec + c * PK * s.SR, s.SR, k, K);
    const W b = c == C - 1 ? permuted_word(acc + c * N, k, gi, N) : W(0);
    out[idx] = b - w;
  }
}

struct Args {
  const void* x;
  const uint32_t* ak;
  const int32_t *kidx, *ginv;
  void* out;
  const uint32_t *ftw, *ftws, *itw, *itws;
  unsigned char* ws;
  int B;
  cudaStream_t stream;
  int* blocks_per_sm;  // non-null: report the residency, launch nothing
};

template <int PK, typename W, bool S, int LogN, bool Gathered>
cudaError_t launch(const Args& x, const PbsConsts& K, const Layout& L,
                   const Sched& s) {
  return launch_sched(auto_keyswitch_kernel<PK, W, S, LogN, Gathered>, s, L,
                      x.B, x.stream, x.blocks_per_sm,
                      static_cast<const W*>(x.x), x.ak, x.kidx, x.ginv,
                      static_cast<W*>(x.out), x.ftw, x.ftws, x.itw, x.itws,
                      x.ws, K, L);
}

template <int PK, typename W, bool Gathered>
cudaError_t launch_s(const Args& x, const PbsConsts& K, const Layout& L,
                     const Sched& s) {
  if (!all_shared(L, kNumBuf))
    return launch<PK, W, false, 0, Gathered>(x, K, L, s);
  return with_log_n<PK>(K, [&](auto n) {
    return launch<PK, W, true, decltype(n)::value, Gathered>(x, K, L, s);
  });
}

template <bool Gathered>
int launch_entry(const Args& a, const int64_t* consts, const int64_t* layout,
                 int word_bits) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || !make_sched(K.logN, K.P, s))
    return int(cudaErrorInvalidValue);
  if (a.B == 0 && !a.blocks_per_sm) return int(cudaSuccess);
  const Layout L = parse_layout(layout, kNumBuf);
  return int(dispatch_pw(K.P, word_bits, [&](auto p, auto w) {
    return launch_s<decltype(p)::value, decltype(w), Gathered>(a, K, L, s);
  }));
}

}  // namespace

extern "C" {

// consts: the key-switch plan's int64 host array (layout in ntt_common.cuh;
// its l and Bg_bit are the key switch's t and base_bit, its gadget offset of
// the word width); layout: the buffer placement (smem bytes, workspace
// stride, offsets of work, spec, acc); ws: the workspace, B x stride bytes
// (null when the stride is 0).  x, out [B, k+1, N] u64 words (word_bits 64)
// or u32 words (word_bits 32), distinct; ak [G, k t, k+1, P, N] u32,
// 16-byte aligned; kidx [B] int32 in [0, G); ginv [B] int32 odd; twiddles
// [P, N] u32.
int auto_keyswitch_launch(const void* x, const void* ak, const void* kidx,
                          const void* ginv, void* out, const void* ftw,
                          const void* ftws, const void* itw, const void* itws,
                          void* ws, const int64_t* consts,
                          const int64_t* layout, int B, int word_bits,
                          void* stream) {
  const Args a{x,
               static_cast<const uint32_t*>(ak),
               static_cast<const int32_t*>(kidx),
               static_cast<const int32_t*>(ginv),
               out,
               static_cast<const uint32_t*>(ftw),
               static_cast<const uint32_t*>(ftws),
               static_cast<const uint32_t*>(itw),
               static_cast<const uint32_t*>(itws),
               static_cast<unsigned char*>(ws),
               B,
               static_cast<cudaStream_t>(stream),
               nullptr};
  return launch_entry<false>(a, consts, layout, word_bits);
}

// K6-old: `auto_keyswitch_launch` with perm (already permuted) in place of
// x, key_rows [B, k t, k+1, P, N] u32 (ciphertext b's keyset entry, 16-byte
// aligned) in place of ak, entry b for block b and ginv 1 (the Gathered
// instances).
int auto_keyswitch_rows_launch(const void* perm, const void* key_rows,
                               void* out, const void* ftw, const void* ftws,
                               const void* itw, const void* itws, void* ws,
                               const int64_t* consts, const int64_t* layout,
                               int B, int word_bits, void* stream) {
  const Args a{perm,
               static_cast<const uint32_t*>(key_rows),
               nullptr,
               nullptr,
               out,
               static_cast<const uint32_t*>(ftw),
               static_cast<const uint32_t*>(ftws),
               static_cast<const uint32_t*>(itw),
               static_cast<const uint32_t*>(itws),
               static_cast<unsigned char*>(ws),
               B,
               static_cast<cudaStream_t>(stream),
               nullptr};
  return launch_entry<true>(a, consts, layout, word_bits);
}

// The blocks of K6 (gathered != 0: K6-old) resident on one SM at the
// key-switch plan's shape, the placement and the word width
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device),
// and the threads of a block.
int auto_keyswitch_residency(const int64_t* consts, const int64_t* layout,
                             int word_bits, int gathered, int* blocks,
                             int* threads) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || !make_sched(K.logN, K.P, s))
    return int(cudaErrorInvalidValue);
  *threads = s.NG * s.T;
  Args a{};
  a.blocks_per_sm = blocks;
  return gathered ? launch_entry<true>(a, consts, layout, word_bits)
                  : launch_entry<false>(a, consts, layout, word_bits);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
