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
// A second entry (K6-old) replaces the TPU kernel `auto_keyswitch`
// (ops/pbs_kernel.py:2200, body `_make_auto_ks_kernel` :2134): the input is
// already permuted and each ciphertext's keyset entry was gathered for it
// beforehand, key_rows [B, k t, k+1, P, N], so the key of block b is
// key_rows + b * entry and nothing is permuted.  It is
// `bootstrap_ga.blind_rotate_ga_gathered`'s key switch.
//
// At the 32-bit torus (TORUS32) both run on u32 words (the word type W):
// the permutation negates mod 2^32, the key switch's gadget offset is cast
// to W once, and Garner's Horner step wraps mod 2^32 (the TPU bodies'
// `nl == 1` branches, pbs_kernel.py:2154/2180 and :2326/2355, through
// `_garner_limb32` :725).  The NTT side is the same at both widths.
//
// Design.  One block of 1024 threads per ciphertext: the block gathers the
// permuted words from global memory into shared memory (perm, C x N W),
// decomposes the k mask components into k t digit rows, and for each row
// runs P forward NTTs and a Barrett multiply-accumulate against the row's
// keyset entry (runtime residues, no Shoup companions), read straight from
// global memory and coalesced along N; then C x P inverse NTTs and Garner
// write (0, b') - sum to global memory.  Shared memory: perm 32 KiB,
// spectra 48 KiB, one digit row's NTTs 24 KiB at TFHEpp-L2.  Where they do
// not all fit (256 KiB at N=4096 with a 4-prime key-switch plan, the GA
// key's at SET_3) the wrapper moves perm to a global workspace.  The code
// is `ga_common.cuh`'s, which K7 runs once per step; K6-old copies its
// input into perm unpermuted and runs the same body.
//
// What bounds it on this card: bytes, at the GA path's B=512.  Each
// ciphertext reads its own 192 KiB keyset entry (distinct entries for
// random generators, ~450 of 2048 at B=512) and 32 KiB in and out, against
// 18 NTTs x 11,264 butterflies + 49,152 Barrett products of work.  Its time
// is set by neither: like K1, each block is a chain of block-wide barriers
// (one per NTT stage), and B=512 takes four waves of 132 blocks.

#include "ga_common.cuh"

namespace {

constexpr int kThreads = 1024;
enum { kWork, kSpec, kPerm, kNumBuf };  // buffers, as the wrapper lists them

// Gathered: K6-old (key rows per ciphertext, input already permuted);
// otherwise K6 (keyset entry kidx[b], permutation by ginv[b]).
template <int PK, typename W, bool S, bool Gathered>
__global__ void __launch_bounds__(kThreads, 1)
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
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  const int CN = K.C * K.N;
  W* perm = buffer<S, W>(L, kPerm, smem, ws, nullptr);            // [C][N]
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);  // [C][PK][N]
  auto* work = buffer<S, uint32_t>(L, kWork, smem, ws, nullptr);  // [PK][N]

  const int b = blockIdx.x;
  const size_t entry = size_t(K.C - 1) * K.l * K.C * PK * K.N;
  const W* x = x_g + size_t(b) * CN;
  if constexpr (Gathered) {
    for (int i = threadIdx.x; i < CN; i += blockDim.x) perm[i] = x[i];
    __syncthreads();
  } else {
    galois_permute<W>(x, perm, ginv[b], K);
  }
  const uint32_t* key = Gathered ? ak + b * entry : ak + kidx[b] * entry;
  keyswitch_entry<PK, W>(perm, out_g + size_t(b) * CN, key, spec, work, K,
                         ftw, ftws, itw, itws);
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
};

template <int PK, typename W, bool S, bool Gathered>
cudaError_t launch_s(const Args& x, const PbsConsts& K, const Layout& L) {
  cudaError_t err = cudaFuncSetAttribute(
      auto_keyswitch_kernel<PK, W, S, Gathered>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.smem));
  if (err != cudaSuccess) return err;
  auto_keyswitch_kernel<PK, W, S, Gathered>
      <<<x.B, kThreads, L.smem, x.stream>>>(
          static_cast<const W*>(x.x), x.ak, x.kidx, x.ginv,
          static_cast<W*>(x.out), x.ftw, x.ftws, x.itw, x.itws, x.ws, K, L);
  return cudaGetLastError();
}

template <bool Gathered>
int launch(const Args& a, const int64_t* consts, const int64_t* layout,
           int word_bits) {
  PbsConsts K;
  if (!parse_consts(consts, K)) return int(cudaErrorInvalidValue);
  if (a.B == 0) return int(cudaSuccess);
  const Layout L = parse_layout(layout, kNumBuf);
  const bool shared = all_shared(L, kNumBuf);
  return int(dispatch_pw(K.P, word_bits, [&](auto p, auto w) {
    using W = decltype(w);
    constexpr int PK = decltype(p)::value;
    return shared ? launch_s<PK, W, true, Gathered>(a, K, L)
                  : launch_s<PK, W, false, Gathered>(a, K, L);
  }));
}

}  // namespace

extern "C" {

// consts: the key-switch plan's int64 host array (layout in ntt_common.cuh;
// its l and Bg_bit are the key switch's t and base_bit, its gadget offset of
// the word width); layout: the buffer placement (smem bytes, workspace
// stride, offsets of work, spec, perm); ws: the workspace, B x stride bytes
// (null when the stride is 0).  x, out [B, k+1, N] u64 words (word_bits 64)
// or u32 words (word_bits 32); ak [G, k t, k+1, P, N] u32; kidx [B] int32 in
// [0, G); ginv [B] int32 odd; twiddles [P, N] u32.
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
               static_cast<cudaStream_t>(stream)};
  return launch<false>(a, consts, layout, word_bits);
}

// K6-old: as `auto_keyswitch_launch` with perm (already permuted) in place
// of x, key_rows [B, k t, k+1, P, N] u32 (ciphertext b's keyset entry) in
// place of ak, and no kidx or ginv.
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
               static_cast<cudaStream_t>(stream)};
  return launch<true>(a, consts, layout, word_bits);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
