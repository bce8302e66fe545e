// The automorphism key switch of a batch of TRLWEs in one launch, for NVIDIA
// Hopper (sm_90a): per ciphertext b, with (a', b') = psi_g(x[b]) the Galois
// automorphism X -> X^g (g given by ginv[b] = g^-1 mod 2N; 1 leaves x as it
// is),
//
//   out[b] = (0, b') - sum_{j < k t} dec_j(a') (x) AK[kidx[b]][j]
//
// exactly mod 2^64.  Replaces the TPU kernel `auto_keyswitch_stream` (the
// TPU package's ops/pbs_kernel.py:2374, body `_make_auto_ks_stream_kernel`
// :2256, with its in-kernel permutation `ginv`).  It is the GA bootstrap's
// initial psi_{w0} key switch, `keyswitch.trlwe_keyswitch` (one keyset
// entry, ginv 1) and `keyswitch.eval_automorphism` (ginv = gen^-1).
//
// Design.  One block of 1024 threads per ciphertext: the block gathers the
// permuted words from global memory into shared memory (perm, C x N u64),
// decomposes the k mask components into k t digit rows, and for each row
// runs P forward NTTs and a Barrett multiply-accumulate against the row's
// keyset entry (runtime residues, no Shoup companions), read straight from
// global memory and coalesced along N; then C x P inverse NTTs and Garner
// write (0, b') - sum to global memory.  Shared memory: perm 32 KiB,
// spectra 48 KiB, one digit row's NTTs 24 KiB at TFHEpp-L2.  The code is
// `ga_common.cuh`'s, which K7 runs once per step.
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

template <int PK>
__global__ void __launch_bounds__(kThreads, 1)
auto_keyswitch_kernel(const uint64_t* __restrict__ x_g,
                      const uint32_t* __restrict__ ak,
                      const int32_t* __restrict__ kidx,
                      const int32_t* __restrict__ ginv,
                      uint64_t* __restrict__ out_g,
                      const uint32_t* __restrict__ ftw,
                      const uint32_t* __restrict__ ftws,
                      const uint32_t* __restrict__ itw,
                      const uint32_t* __restrict__ itws, const PbsConsts Kp) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  const int N = K.N, C = K.C, CN = K.C * K.N;
  uint64_t* perm = reinterpret_cast<uint64_t*>(smem);        // [C][N]
  uint32_t* spec = reinterpret_cast<uint32_t*>(perm + CN);   // [C][PK][N]
  uint32_t* work = spec + C * PK * N;                        // [PK][N]

  const int b = blockIdx.x;
  const size_t entry = size_t(C - 1) * K.l * C * PK * N;
  galois_permute(x_g + size_t(b) * CN, perm, ginv[b], K);
  keyswitch_entry<PK>(perm, out_g + size_t(b) * CN, ak + kidx[b] * entry,
                      spec, work, K, ftw, ftws, itw, itws);
}

template <int PK>
cudaError_t launch(const uint64_t* x, const uint32_t* ak, const int32_t* kidx,
                   const int32_t* ginv, uint64_t* out, const uint32_t* ftw,
                   const uint32_t* ftws, const uint32_t* itw,
                   const uint32_t* itws, const PbsConsts& K, int B,
                   cudaStream_t stream) {
  const size_t smem = size_t(K.C) * K.N * sizeof(uint64_t) +
                      size_t(K.C * PK + PK) * K.N * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      auto_keyswitch_kernel<PK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  auto_keyswitch_kernel<PK><<<B, kThreads, smem, stream>>>(
      x, ak, kidx, ginv, out, ftw, ftws, itw, itws, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// consts: the key-switch plan's int64 host array (layout in ntt_common.cuh;
// its l and Bg_bit are the key switch's t and base_bit).  x, out [B, k+1, N]
// u64; ak [G, k t, k+1, P, N] u32; kidx [B] int32 in [0, G); ginv [B] int32
// odd; twiddles [P, N] u32.
int auto_keyswitch_launch(const void* x, const void* ak, const void* kidx,
                          const void* ginv, void* out, const void* ftw,
                          const void* ftws, const void* itw, const void* itws,
                          const int64_t* consts, int B, void* stream) {
  PbsConsts K;
  if (!parse_consts(consts, K)) return int(cudaErrorInvalidValue);
  if (B == 0) return int(cudaSuccess);
  auto* x64 = static_cast<const uint64_t*>(x);
  auto* a32 = static_cast<const uint32_t*>(ak);
  auto* ki = static_cast<const int32_t*>(kidx);
  auto* gi = static_cast<const int32_t*>(ginv);
  auto* o64 = static_cast<uint64_t*>(out);
  auto* f = static_cast<const uint32_t*>(ftw);
  auto* fs = static_cast<const uint32_t*>(ftws);
  auto* iv = static_cast<const uint32_t*>(itw);
  auto* is = static_cast<const uint32_t*>(itws);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (K.P) {
    case 2: err = launch<2>(x64, a32, ki, gi, o64, f, fs, iv, is, K, B, st); break;
    case 3: err = launch<3>(x64, a32, ki, gi, o64, f, fs, iv, is, K, B, st); break;
    case 4: err = launch<4>(x64, a32, ki, gi, o64, f, fs, iv, is, K, B, st); break;
    default: err = launch<5>(x64, a32, ki, gi, o64, f, fs, iv, is, K, B, st); break;
  }
  return int(err);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
