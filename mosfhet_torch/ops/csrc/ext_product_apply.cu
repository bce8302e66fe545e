// G replace-mode external products with runtime keys in one launch, for
// NVIDIA Hopper (sm_90a):
//
//   acc <- SA_g (x) acc                 for g = 0 .. G-1,
//
// exactly mod 2^64 (mod 2^32 at the 32-bit torus).
//
// Replaces the TPU kernel `_apply_scan_fused` (the TPU package's
// ops/pbs_kernel.py:1944, reached through `ext_product_apply_scan` :1858,
// body `_make_apply_scan_kernel` :1892).  It is `trgsw.external_product`
// (G = 1) and UBR phase 2 (G = n/u cached products).  Per ciphertext and g:
//
//   1. signed gadget digits of acc + offset, l per component (J = (k+1) l);
//   2. per digit row and prime: forward negacyclic NTT and a Barrett
//      multiply-accumulate against SA_g[j][c][p] into spec[c][p] (the key
//      is runtime data, so there are no Shoup companions);
//   3. inverse NTTs of the C*P spectra, Garner CRT to exact u64 words,
//      which replace acc.
//
// Keys: [G, J, C, P, N] u32 broadcast over the batch, or [G, B, J, C, P, N]
// with one key per ciphertext (per_row).
//
// At the 32-bit torus (TORUS32) the same body runs on u32 words (the word
// type W): one limb, the 32-bit gadget offset cast to W once (a u64 offset
// would widen the sum and shift the digits by 64 bits), and Garner's Horner
// step mod 2^32 (the TPU kernel's `nl == 1` branches, pbs_kernel.py:1739-1744
// and :1934-1935).  The NTT side is the same at both widths.
//
// Design: K1's schedule (rotate_sched.cuh).  One block per ciphertext runs
// the G products as a loop, split into groups of T = N/16 threads, one
// group per prime (NG = min(P, 1024/T) groups; a group takes primes g,
// g + NG, ...).  A product is K7's stage 1 (ga_scan.cu), the same device
// code (`product_spectra`, `replace_acc`): per digit row, each thread reads
// its 16 digits straight from acc, runs the forward passes on them (a
// 2,048-point row is three passes and two exchanges through the group's
// exchange row, one under a named barrier of the group's threads, one
// inside each warp; lazy residues) and multiplies its 16 bit-reversed
// positions by the key (16-byte loads, Barrett products on the key's
// residues) into its own slots of spec, the first row replacing, so
// nothing is zeroed; then the inverse NTTs from those slots to natural
// order, a block barrier, Garner replacing acc, and a block barrier: two
// block barriers per product.
// A broadcast key is read by every block of a wave from L2, so each thread
// asks L2 for its key words of product g + 1 before a row's forward passes
// (per row, its own ciphertext's next key: the same hint, from HBM).
//
// What bounds it on this card: integer multiplies.  Per product and
// ciphertext at TFHEpp-L2: (24 + 6) NTTs x 11,264 butterflies (one Shoup
// product, 3 multiplies) + 98,304 Barrett products (4 multiplies) + the
// Garner reconstructions of 4,096 words.  Bytes are far below that: the
// broadcast key (384 KiB per g) is shared through the 50 MB L2.
//
// Buffers of a block, as K1's: acc [C][N] words, spec [C][P][SR] u32 and
// work [NG][SR] u32 (SR = N + N/16 from N = 256): 108.5 KiB at TFHEpp-L2
// (N=2048, k=1, P=3; two blocks of 384 threads per SM) and 67 KiB at its
// 32-bit form (P=2; three of 256).  Where they do not all fit, the wrapper
// places them by traffic: work in shared memory, then spec, then acc; spec
// in a global workspace, acc updated in place in the caller's tensor
// (SET_3: acc in place; N=8192: spec in the workspace).  N from 16 to
// 16384.
//
// K3-step (entry `ext_product_apply_step_launch`) is one product per launch
// of the same kernel at G = 1: the TPU kernel `_apply_step_tiles`
// (pbs_kernel.py:1802, the per-step `ext_product_apply_scan` at :1858).
// acc is replaced in the caller's tensor, as the TPU kernel aliases it;
// the key is [J, C, P, N] broadcast or [B, J, C, P, N] per row (the TPU's
// per-row tile [nb, J, C, P, BT, N] without its sublane axis), K3's layout
// with G = 1.

#include "rotate_sched.cuh"

namespace {

enum { kWork, kSpec, kAcc, kNumBuf };  // buffers, as the wrapper lists them

// K3: the G products, one block per ciphertext.  sa [G][J][C][P][N] or,
// per row, [G][B][J][C][P][N] u32 residues, 16-byte aligned.  LogN != 0:
// the compile-time shape of K1's 80-register instances (N = 2^LogN, k = 1,
// P at most 3, all in shared memory).
template <int P, typename W, bool S, int LogN>
__global__ void __launch_bounds__(kBlockThreads<LogN>, kMinBlocks<LogN>)
ext_product_apply_kernel(W* __restrict__ acc_g,
                         const uint32_t* __restrict__ sa,
                         const uint32_t* __restrict__ ftw,
                         const uint32_t* __restrict__ ftws,
                         const uint32_t* __restrict__ itw,
                         const uint32_t* __restrict__ itws, unsigned char* ws,
                         const PbsConsts Kp, const Layout L, int B, int G,
                         int per_row) {
  constexpr bool Fixed = LogN != 0;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  Sched s;  // compile-time where LogN is
  make_sched(LogN ? LogN : K.logN, P, s);
  const int N = 1 << s.logN, C = Fixed ? 2 : K.C, CN = C * N, J = C * K.l;
  const int threads = s.NG * s.T;
  W* acc_b = acc_g + size_t(blockIdx.x) * CN;
  W* acc = buffer<S, W>(L, kAcc, smem, ws, acc_b);                // [C][N]
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);  // [C][P][SR]
  auto* work = buffer<S, uint32_t>(L, kWork, smem, ws, nullptr);  // [NG][SR]
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += threads) acc[i] = acc_b[i];
  __syncthreads();

  const size_t key_size = size_t(J) * C * P * N;
  const size_t g_stride = per_row ? size_t(B) * key_size : key_size;
  const uint32_t* key = sa + (per_row ? size_t(blockIdx.x) * key_size : 0);
  for (int g = 0; g < G; ++g, key += g_stride) {
    product_spectra<P, P, W, Fixed, true>(
        [&](int c, int k) { return acc[c * N + k]; }, J, key, spec, work, ftw,
        ftws, itw, itws, K, s, g + 1 < G ? g_stride : 0);
    replace_acc<P, P, W>(acc, spec, N, CN, threads, K, s);
  }
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += threads) acc_b[i] = acc[i];
}

struct Args {
  void* acc;
  const uint32_t *sa, *ftw, *ftws, *itw, *itws;
  unsigned char* ws;
  int B, G, per_row;
  cudaStream_t stream;
  int* blocks_per_sm;  // non-null: report K3's residency, launch nothing
};

template <int P, typename W, bool S, int LogN>
cudaError_t launch_scan(const Args& x, const PbsConsts& K, const Layout& L,
                        const Sched& s) {
  return launch_sched(ext_product_apply_kernel<P, W, S, LogN>, s, L, x.B,
                      x.stream, x.blocks_per_sm, static_cast<W*>(x.acc), x.sa,
                      x.ftw, x.ftws, x.itw, x.itws, x.ws, K, L, x.B, x.G,
                      x.per_row);
}

template <int P, typename W>
cudaError_t launch_scan_s(const Args& x, const PbsConsts& K, const Layout& L,
                          const Sched& s) {
  if (!all_shared(L, kNumBuf)) return launch_scan<P, W, false, 0>(x, K, L, s);
  return with_log_n<P>(K, [&](auto n) {
    return launch_scan<P, W, true, decltype(n)::value>(x, K, L, s);
  });
}

int launch_entry(void* acc, const void* sa, const void* ftw, const void* ftws,
                 const void* itw, const void* itws, void* ws,
                 const int64_t* consts, const int64_t* layout, int B, int G,
                 int per_row, int word_bits, void* stream,
                 int* blocks_per_sm = nullptr) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || !make_sched(K.logN, K.P, s))
    return int(cudaErrorInvalidValue);
  if ((B == 0 || G == 0) && !blocks_per_sm) return int(cudaSuccess);
  const Args x{acc,
               static_cast<const uint32_t*>(sa),
               static_cast<const uint32_t*>(ftw),
               static_cast<const uint32_t*>(ftws),
               static_cast<const uint32_t*>(itw),
               static_cast<const uint32_t*>(itws),
               static_cast<unsigned char*>(ws),
               B,
               G,
               per_row,
               static_cast<cudaStream_t>(stream),
               blocks_per_sm};
  const Layout L = parse_layout(layout, kNumBuf);
  return int(dispatch_pw(K.P, word_bits, [&](auto p, auto w) {
    return launch_scan_s<decltype(p)::value, decltype(w)>(x, K, L, s);
  }));
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh), whose
// gadget offset is of the word width; layout: the buffer placement (smem
// bytes, workspace stride, offsets of work, spec, acc); ws: the workspace,
// B x stride bytes (null when the stride is 0).  acc [B, k+1, N] u64 words
// (word_bits 64) or u32 words (word_bits 32) is replaced in place; sa
// [G, (k+1)l, k+1, P, N] u32 canonical residues, or [G, B, (k+1)l, k+1, P,
// N] when per_row != 0, 16-byte aligned; twiddles [P, N] u32.
int ext_product_apply_launch(void* acc, const void* sa, const void* ftw,
                             const void* ftws, const void* itw,
                             const void* itws, void* ws, const int64_t* consts,
                             const int64_t* layout, int B, int G, int per_row,
                             int word_bits, void* stream) {
  return launch_entry(acc, sa, ftw, ftws, itw, itws, ws, consts, layout, B,
                      G, per_row, word_bits, stream);
}

// K3-step: one product, acc <- SA (x) acc in place, the scan at G = 1; sa
// [(k+1)l, k+1, P, N] u32, or [B, (k+1)l, k+1, P, N] when per_row != 0,
// 16-byte aligned; the rest as above.
int ext_product_apply_step_launch(void* acc, const void* sa, const void* ftw,
                                  const void* ftws, const void* itw,
                                  const void* itws, void* ws,
                                  const int64_t* consts,
                                  const int64_t* layout, int B, int per_row,
                                  int word_bits, void* stream) {
  return launch_entry(acc, sa, ftw, ftws, itw, itws, ws, consts, layout, B,
                      1, per_row, word_bits, stream);
}

// The blocks of K3 (and K3-step) resident on one SM at the plan's shape,
// the placement and the word width
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device), and
// the threads of a block.
int ext_product_apply_residency(const int64_t* consts, const int64_t* layout,
                                int word_bits, int* blocks, int* threads) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || !make_sched(K.logN, K.P, s))
    return int(cudaErrorInvalidValue);
  *threads = s.NG * s.T;
  return launch_entry(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, consts, layout, 0, 1, 0, word_bits, nullptr,
                      blocks);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
