// One replace-mode external product with a static TRGSW over a batch of
// TRLWEs in one launch, for NVIDIA Hopper (sm_90a):
//
//   out[b] = BK (x) x[b]
//
// exactly mod 2^64, with BK one NTT-form TRGSW [(k+1)l][k+1][P][N] u32 and
// its Shoup companions.  Replaces the TPU kernel `_cmux_delta_tiles` (the
// TPU package's ops/pbs_kernel.py:895, reached through `cmux_delta` :3193,
// body `_make_kernel` :849), the GA step's external product as a launch of
// its own: `bootstrap_ga.blind_rotate_ga_stepwise` and
// `blind_rotate_ga_gathered` launch it once per step, where K7
// (ga_scan.cu) fuses it with the key switch.  Per ciphertext:
//
//   1. signed gadget digits of x + offset, l per component (J = (k+1) l);
//   2. per digit row and prime: forward negacyclic NTT and a Shoup
//      multiply-accumulate against BK[j][c][p] into spec[c][p];
//   3. inverse NTTs of the C*P spectra, Garner CRT to exact u64 words,
//      written to out.
//
// 64-bit torus only, as the TPU kernel (it asserts two limbs,
// pbs_kernel.py:3204); the wrapper refuses int32 words.
//
// Design.  K7's external-product stage (ga_common.cuh's `digit_mul_acc`
// and `inverse_to_words`), with x read from and out written to global
// memory: one block of 1024 threads per ciphertext, one digit row's P NTT
// rows and the C x P spectra in shared memory (72 KiB at TFHEpp-L2).  Where
// the spectra do not fit beside the NTT rows (N=8192 with 4 primes) the
// wrapper moves them to a global workspace.  The TRGSW (384 KiB at L2) is
// read by every block, and the blocks of a wave share it through L2.
//
// What bounds it on this card: integer multiplies, per ciphertext (24 + 6)
// NTTs x 11,264 butterflies + 98,304 Shoup key products + 4,096 Garner
// words at TFHEpp-L2 (K3's product with Shoup keys); like K1, its NTT
// stages are block-wide barriers.

#include "ga_common.cuh"

namespace {

constexpr int kThreads = 1024;
enum { kWork, kSpec, kNumBuf };  // buffers, as the wrapper lists them

template <int P, bool S>
__global__ void __launch_bounds__(kThreads, 1)
cmux_delta_kernel(const uint64_t* __restrict__ x_g,
                  const uint32_t* __restrict__ keyv,
                  const uint32_t* __restrict__ keyvs,
                  uint64_t* __restrict__ out_g,
                  const uint32_t* __restrict__ ftw,
                  const uint32_t* __restrict__ ftws,
                  const uint32_t* __restrict__ itw,
                  const uint32_t* __restrict__ itws, unsigned char* ws,
                  const PbsConsts Kp, const Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  const size_t CN = size_t(K.C) * K.N;
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);  // [C][P][N]
  auto* work = buffer<S, uint32_t>(L, kWork, smem, ws, nullptr);  // [P][N]
  const int b = blockIdx.x;
  digit_mul_acc<P, uint64_t>(x_g + b * CN, K.C * K.l, keyv, keyvs, spec,
                             work, K, ftw, ftws);
  inverse_to_words<P, uint64_t>(spec, nullptr, out_g + b * CN, K, itw, itws);
}

struct Args {
  const uint64_t* x;
  const uint32_t *keyv, *keyvs;
  uint64_t* out;
  const uint32_t *ftw, *ftws, *itw, *itws;
  unsigned char* ws;
  int B;
  cudaStream_t stream;
};

template <int P, bool S>
cudaError_t launch_s(const Args& x, const PbsConsts& K, const Layout& L) {
  cudaError_t err = cudaFuncSetAttribute(
      cmux_delta_kernel<P, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(L.smem));
  if (err != cudaSuccess) return err;
  cmux_delta_kernel<P, S><<<x.B, kThreads, L.smem, x.stream>>>(
      x.x, x.keyv, x.keyvs, x.out, x.ftw, x.ftws, x.itw, x.itws, x.ws, K, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh), 64-bit
// gadget offset; layout: the buffer placement (smem bytes, workspace
// stride, offsets of work, spec); ws: the workspace, B x stride bytes (null
// when the stride is 0).  x, out [B, k+1, N] u64 (distinct); keyv, keyvs
// [(k+1)l, k+1, P, N] u32; twiddles [P, N] u32.
int cmux_delta_launch(const void* x, const void* keyv, const void* keyvs,
                      void* out, const void* ftw, const void* ftws,
                      const void* itw, const void* itws, void* ws,
                      const int64_t* consts, const int64_t* layout, int B,
                      void* stream) {
  PbsConsts K;
  if (!parse_consts(consts, K)) return int(cudaErrorInvalidValue);
  if (B == 0) return int(cudaSuccess);
  const Args a{static_cast<const uint64_t*>(x),
               static_cast<const uint32_t*>(keyv),
               static_cast<const uint32_t*>(keyvs),
               static_cast<uint64_t*>(out),
               static_cast<const uint32_t*>(ftw),
               static_cast<const uint32_t*>(ftws),
               static_cast<const uint32_t*>(itw),
               static_cast<const uint32_t*>(itws),
               static_cast<unsigned char*>(ws),
               B,
               static_cast<cudaStream_t>(stream)};
  const Layout L = parse_layout(layout, kNumBuf);
  const bool shared = all_shared(L, kNumBuf);
  return int(dispatch_pw(K.P, 64, [&](auto p, auto) {
    constexpr int P = decltype(p)::value;
    return shared ? launch_s<P, true>(a, K, L) : launch_s<P, false>(a, K, L);
  }));
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
