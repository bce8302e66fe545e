// One replace-mode external product with a static TRGSW over a batch of
// TRLWEs in one launch, for NVIDIA Hopper (sm_90a):
//
//   out[b] = BK (x) x[b]
//
// exactly mod 2^64, with BK one NTT-form TRGSW [(k+1)l][k+1][P][N] u32.
// Replaces the TPU kernel `_cmux_delta_tiles` (the TPU package's
// ops/pbs_kernel.py:895, reached through `cmux_delta` :3193, body
// `_make_kernel` :849), the GA step's external product as a launch of its
// own: `bootstrap_ga.blind_rotate_ga_stepwise` and
// `blind_rotate_ga_gathered` launch it once per step, where K7
// (ga_scan.cu) fuses it with the key switch.  Per ciphertext:
//
//   1. signed gadget digits of x + offset, l per component (J = (k+1) l);
//   2. per digit row and prime: forward negacyclic NTT and a Barrett
//      multiply-accumulate against BK[j][c][p] into spec[c][p];
//   3. inverse NTTs of the C*P spectra, Garner CRT to exact u64 words,
//      written to out.
//
// 64-bit torus only, as the TPU kernel (it asserts two limbs,
// pbs_kernel.py:3204); the wrapper refuses int32 words.
//
// Design: K1's schedule (rotate_sched.cuh), the product of K3
// (ext_product_apply.cu) run once with a distinct output.  One block per
// ciphertext, split into groups of T = N/16 threads, one group per prime
// (NG = min(P, 1024/T) groups; a group takes primes g, g + NG, ...).  The
// block loads x[b] coalesced into acc [C][N]; per digit row each thread
// reads its 16 digits from acc, runs the forward passes on them (a
// 2,048-point row is three passes and two exchanges through the group's
// exchange row, one under a named barrier of the group's threads, one
// inside each warp; lazy residues) and multiplies its 16 bit-reversed
// positions by the key (16-byte loads, each row's words asked of L2 before
// its forward passes; Barrett products on the key's residues alone, so the
// Shoup companions keyvs are not read and the key's L2 traffic halves)
// into its own slots of spec, the first row replacing, so nothing is
// zeroed; then the inverse NTTs from those slots to natural order, a block
// barrier, and Garner writing out[b] (`product_spectra`, `replace_acc`).
//
// What bounds it on this card: integer multiplies, per ciphertext at
// TFHEpp-L2 (24 + 6) NTTs x 11,264 butterflies (one Shoup product, 3
// multiplies) + 98,304 Barrett key products (4 multiplies) + 4,096 Garner
// words.  The TRGSW (384 KiB at L2) is read by every block and shared by
// a wave's blocks through L2.
//
// Buffers of a block, as K3's: acc [C][N] u64, spec [C][P][SR] u32 and
// work [NG][SR] u32 (SR = N + N/16 from N = 256): 108.5 KiB at TFHEpp-L2
// (N=2048, k=1, P=3; two blocks of 384 threads per SM).  Where they do not
// all fit, the wrapper places them by traffic: work in shared memory, then
// spec, then acc; spec in a global workspace, acc left out, the block then
// reading x in place (SET_3: x in place; N=8192: spec in the workspace).
// N from 16 to 16384.

#include "rotate_sched.cuh"

namespace {

enum { kWork, kSpec, kAcc, kNumBuf };  // buffers, as the wrapper lists them

// LogN != 0: the compile-time shape of K1's 80-register instances (N =
// 2^LogN, k = 1, P at most 3, all in shared memory).
template <int P, bool S, int LogN>
__global__ void __launch_bounds__(kBlockThreads<LogN>, kMinBlocks<LogN>)
cmux_delta_kernel(const uint64_t* __restrict__ x_g,
                  const uint32_t* __restrict__ keyv,
                  uint64_t* __restrict__ out_g,
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
  make_sched(LogN ? LogN : K.logN, P, s);
  const int N = 1 << s.logN, C = Fixed ? 2 : K.C, CN = C * N, J = C * K.l;
  const int threads = s.NG * s.T;
  // x is only read: where acc is left out of shared memory it is x itself
  uint64_t* x_b = const_cast<uint64_t*>(x_g) + size_t(blockIdx.x) * CN;
  uint64_t* acc = buffer<S, uint64_t>(L, kAcc, smem, ws, x_b);    // [C][N]
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);  // [C][P][SR]
  auto* work = buffer<S, uint32_t>(L, kWork, smem, ws, nullptr);  // [NG][SR]
  if (acc != x_b)
    for (int i = threadIdx.x; i < CN; i += threads) acc[i] = x_b[i];
  __syncthreads();
  product_spectra<P, P, uint64_t, Fixed, true>(
      [&](int c, int k) { return acc[c * N + k]; }, J, keyv, spec, work, ftw,
      ftws, itw, itws, K, s);
  replace_acc<P, P, uint64_t>(out_g + size_t(blockIdx.x) * CN, spec, N, CN,
                              threads, K, s);
}

struct Args {
  const uint64_t* x;
  const uint32_t* keyv;
  uint64_t* out;
  const uint32_t *ftw, *ftws, *itw, *itws;
  unsigned char* ws;
  int B;
  cudaStream_t stream;
  int* blocks_per_sm;  // non-null: report the residency, launch nothing
};

template <int P, bool S, int LogN>
cudaError_t launch(const Args& x, const PbsConsts& K, const Layout& L,
                   const Sched& s) {
  return launch_sched(cmux_delta_kernel<P, S, LogN>, s, L, x.B, x.stream,
                      x.blocks_per_sm, x.x, x.keyv, x.out, x.ftw, x.ftws,
                      x.itw, x.itws, x.ws, K, L);
}

template <int P>
cudaError_t launch_s(const Args& x, const PbsConsts& K, const Layout& L,
                     const Sched& s) {
  if (!all_shared(L, kNumBuf)) return launch<P, false, 0>(x, K, L, s);
  return with_log_n<P>(K, [&](auto n) {
    return launch<P, true, decltype(n)::value>(x, K, L, s);
  });
}

int launch_entry(const void* x, const void* keyv, void* out, const void* ftw,
                 const void* ftws, const void* itw, const void* itws,
                 void* ws, const int64_t* consts, const int64_t* layout,
                 int B, void* stream, int* blocks_per_sm = nullptr) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || !make_sched(K.logN, K.P, s))
    return int(cudaErrorInvalidValue);
  if (B == 0 && !blocks_per_sm) return int(cudaSuccess);
  const Args a{static_cast<const uint64_t*>(x),
               static_cast<const uint32_t*>(keyv),
               static_cast<uint64_t*>(out),
               static_cast<const uint32_t*>(ftw),
               static_cast<const uint32_t*>(ftws),
               static_cast<const uint32_t*>(itw),
               static_cast<const uint32_t*>(itws),
               static_cast<unsigned char*>(ws),
               B,
               static_cast<cudaStream_t>(stream),
               blocks_per_sm};
  const Layout L = parse_layout(layout, kNumBuf);
  return int(dispatch_pw(K.P, 64, [&](auto p, auto) {
    return launch_s<decltype(p)::value>(a, K, L, s);
  }));
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh), 64-bit
// gadget offset; layout: the buffer placement (smem bytes, workspace
// stride, offsets of work, spec, acc); ws: the workspace, B x stride bytes
// (null when the stride is 0).  x, out [B, k+1, N] u64 (distinct); keyv
// [(k+1)l, k+1, P, N] u32, 16-byte aligned; keyvs, its Shoup companions,
// is not read (the MAC's Barrett products need only the residues);
// twiddles [P, N] u32.
int cmux_delta_launch(const void* x, const void* keyv, const void* keyvs,
                      void* out, const void* ftw, const void* ftws,
                      const void* itw, const void* itws, void* ws,
                      const int64_t* consts, const int64_t* layout, int B,
                      void* stream) {
  (void)keyvs;
  return launch_entry(x, keyv, out, ftw, ftws, itw, itws, ws, consts, layout,
                      B, stream);
}

// The blocks of K1-delta resident on one SM at the plan's shape and
// placement (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current
// device), and the threads of a block.
int cmux_delta_residency(const int64_t* consts, const int64_t* layout,
                         int* blocks, int* threads) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || !make_sched(K.logN, K.P, s))
    return int(cudaErrorInvalidValue);
  *threads = s.NG * s.T;
  return launch_entry(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, consts, layout, 0, nullptr, blocks);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
