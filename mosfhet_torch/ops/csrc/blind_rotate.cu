// The whole blind rotation (n CMUX steps) of a batch of TRLWE accumulators
// in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `blind_rotate_scan_fused` (the TPU package's
// ops/pbs_kernel.py:1404, step body `_step_body` :1186).  Per ciphertext and
// per step i it computes, exactly mod 2^64,
//
//   acc += BK_i (x) ((X^{a_i} - 1) * acc)
//
//   1. rot = X^{a_i} * acc - acc, a negacyclic rotation of u64 words;
//   2. signed gadget digits of rot + offset, l per component (J = (k+1) l);
//   3. per digit row and prime: forward negacyclic NTT (Longa-Naehrig,
//      bit-reversed output: the bootstrap key is stored in that order) and
//      a Shoup multiply-accumulate against BK_i[j][c][p] into spec[c][p];
//   4. inverse NTTs of the C*P spectra (1/N folded into the next step);
//   5. Garner CRT to the exact value mod 2^64 with a centred top digit;
//   6. acc += delta.
//
// At the 32-bit torus (TORUS32) the same body runs on u32 words: one limb
// per word, the gadget offset and digits of 32 bits and Garner's Horner step
// mod 2^32 (the TPU kernel's `nl == 1` branches, pbs_kernel.py:1142-1145 and
// :1213-1214).  The NTT side is the same at both widths.
//
// Design.  A blind rotate is one call, so it is one launch: one thread
// block per ciphertext runs the n steps as a loop (the TPU's sequential grid
// axis).  Its buffers are acc and rot (C x N words), spec (C x P x N u32)
// and one digit row's NTT buffer work (P x N u32): 136 KiB at TFHEpp-L2
// (N=2048, k=1, P=3) and 80 KiB at its 32-bit form (P=2), all in shared
// memory, one block of 1024 threads per SM.  Where they do not all fit
// (N=4096 with 4 primes needs 320 KiB, sm_90 allows 227 KiB) the wrapper
// places them by traffic: work, then spec, in shared memory; rot in a
// global workspace; acc updated in place in the caller's tensor (192 KiB of
// shared memory at SET_3; at N=8192 only the 128 KiB NTT row).  Every
// residue is kept canonical in [0, p) with Shoup products (__umulhi), so
// the result is bit-identical to the plain PyTorch version.
//
// What bounds it on this card: integer multiplies.  Per step and ciphertext
// at TFHEpp-L2 it does (24 + 6) NTTs x 11,264 butterflies + 98,304 key
// products + 4,096 Garner reconstructions, each one Shoup product of three
// 32-bit multiplies, against 64 INT32 lanes per SM.  Bytes are far below
// that: the u32 key and its Shoup companions, 786 KiB per step, are read by
// every block (blocks of one wave share them through the 50 MB L2).  This
// first version does not reuse a key row across ciphertexts inside a block
// (the TPU's batch tile), and its NTT stages synchronise the whole block
// each time: both are later work.
//
// K1-step (`pbs_step_kernel`, entry `pbs_step_launch`) is the same step body
// run once per launch: the TPU kernel `_pbs_step_tiles` (pbs_kernel.py:1253,
// the per-step `blind_rotate_scan` at :1335).  acc comes from and goes back
// to the caller's tensor, updated in place as the TPU kernel aliases it
// (`input_output_aliases={0: 0}`).  In place is safe: step 1 reads the
// whole row of acc into rot before the first barrier, and acc is written
// only in step 6, one word per thread, after the inverse NTTs' barriers.
// Its bound is K1's over n plus acc's round trip through HBM (2 x 16 MiB
// at TFHEpp-L2, B=512), which K1 keeps on chip across the n steps.

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 1024;
enum { kWork, kSpec, kRot, kAcc, kNumBuf };  // buffers, as the wrapper lists

// One CMUX step of one ciphertext (steps 1-6 above), block-wide: acc and
// rot [C][N] words, spec [C][P][N] and work [P][N] u32 wherever they were
// placed; kv, ks the step's key rows [J][C][P][N].  Starts after a barrier
// and ends with one.
template <int P, typename W>
__device__ __forceinline__ void cmux_step(
    W* acc, W* rot, uint32_t* spec, uint32_t* work, int a,
    const uint32_t* __restrict__ kv, const uint32_t* __restrict__ ks,
    const uint32_t* __restrict__ ftw, const uint32_t* __restrict__ ftws,
    const uint32_t* __restrict__ itw, const uint32_t* __restrict__ itws,
    const PbsConsts& K) {
  const int N = K.N, C = K.C, l = K.l, J = K.C * K.l, CN = K.C * K.N;
  const W offset = W(K.offset);
  // 1. rot + offset, with rot = X^a acc - acc
  for (int idx = threadIdx.x; idx < CN; idx += blockDim.x) {
    const int c = idx >> K.logN, k = idx & (N - 1);
    rot[idx] = rotated_word(acc + c * N, k, a, N) - acc[idx] + offset;
  }
  for (int idx = threadIdx.x; idx < C * P * N; idx += blockDim.x)
    spec[idx] = 0;
  __syncthreads();

  for (int j = 0; j < J; ++j) {
    // 2. digit row j = (component c_j, digit d) as residues mod each prime
    const int cj = j / l, d = j % l;
    for (int k = threadIdx.x; k < N; k += blockDim.x) {
      const int digit = gadget_digit(rot[cj * N + k], d, K);
#pragma unroll
      for (int pi = 0; pi < P; ++pi)
        work[pi * N + k] = small_residue(digit, K.p[pi]);
    }
    __syncthreads();
    // 3. forward NTTs, then spec[c][p] += NTT(digit row) * BK_i[j][c][p]
    forward_ntt<P>(work, P, K, ftw, ftws);
    for (int idx = threadIdx.x; idx < P * N; idx += blockDim.x) {
      const int pi = idx >> K.logN, k = idx & (N - 1);
      const uint32_t p = K.p[pi], x = work[idx];
      for (int c = 0; c < C; ++c) {
        const size_t ko = (size_t(j * C + c) * P + pi) * N + k;
        uint32_t* sp = spec + (c * P + pi) * N + k;
        *sp = add_mod(*sp, shoup(x, kv[ko], ks[ko], p), p);
      }
    }
    __syncthreads();
  }
  // 4. inverse NTTs of all C*P spectra
  inverse_ntt<P>(spec, C * P, K, itw, itws);
  // 5-6. Garner (with 1/N) and the carry-add into acc
  for (int idx = threadIdx.x; idx < CN; idx += blockDim.x) {
    const int c = idx >> K.logN, k = idx & (N - 1);
    acc[idx] += garner<P, W>(spec + c * P * N, k, K);
  }
  __syncthreads();
}

// A block's rotation of its ciphertext: n steps with a_g [n][B] exponents
// and keyv/keyvs [n][J][C][P][N] (K1), or with Step one step with a_g [B]
// and keyv/keyvs [J][C][P][N] (K1-step).  acc is loaded into its buffer
// and stored back where that is not the caller's tensor itself.
template <int P, typename W, bool S, bool Step>
__device__ __forceinline__ void rotate_block(
    W* __restrict__ acc_g, const int32_t* __restrict__ a_g,
    const uint32_t* __restrict__ keyv, const uint32_t* __restrict__ keyvs,
    const uint32_t* __restrict__ ftw, const uint32_t* __restrict__ ftws,
    const uint32_t* __restrict__ itw, const uint32_t* __restrict__ itws,
    unsigned char* ws, const PbsConsts& Kp, const Layout& L, int n, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  // The constants are indexed by a per-thread prime index: keep one copy in
  // shared memory, where that costs a broadcast load.
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  const int N = K.N, C = K.C, J = K.C * K.l, CN = K.C * K.N;
  W* acc_b = acc_g + size_t(blockIdx.x) * CN;
  W* acc = buffer<S, W>(L, kAcc, smem, ws, acc_b);  // [C][N]
  W* rot = buffer<S, W>(L, kRot, smem, ws, nullptr);  // [C][N]
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);  // [C][P][N]
  auto* work = buffer<S, uint32_t>(L, kWork, smem, ws, nullptr);  // [P][N]

  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += blockDim.x) acc[i] = acc_b[i];
  __syncthreads();

  if (Step) {
    cmux_step<P, W>(acc, rot, spec, work, a_g[blockIdx.x], keyv, keyvs, ftw,
                    ftws, itw, itws, K);
  } else {
    const size_t step_stride = size_t(J) * C * P * N;
    for (int s = 0; s < n; ++s)  // a in [0, 2N]
      cmux_step<P, W>(acc, rot, spec, work, a_g[size_t(s) * B + blockIdx.x],
                      keyv + s * step_stride, keyvs + s * step_stride, ftw,
                      ftws, itw, itws, K);
  }
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += blockDim.x) acc_b[i] = acc[i];
}

// K1: the whole rotation, one block per ciphertext.
template <int P, typename W, bool S>
__global__ void __launch_bounds__(kThreads, 1)
blind_rotate_kernel(W* __restrict__ acc_g, const int32_t* __restrict__ a_g,
                    const uint32_t* __restrict__ keyv,
                    const uint32_t* __restrict__ keyvs,
                    const uint32_t* __restrict__ ftw,
                    const uint32_t* __restrict__ ftws,
                    const uint32_t* __restrict__ itw,
                    const uint32_t* __restrict__ itws, unsigned char* ws,
                    const PbsConsts Kp, const Layout L, int n, int B) {
  rotate_block<P, W, S, false>(acc_g, a_g, keyv, keyvs, ftw, ftws, itw, itws,
                               ws, Kp, L, n, B);
}

// K1-step: one step per launch, one block per ciphertext.
template <int P, typename W, bool S>
__global__ void __launch_bounds__(kThreads, 1)
pbs_step_kernel(W* __restrict__ acc_g, const int32_t* __restrict__ a_g,
                const uint32_t* __restrict__ keyv,
                const uint32_t* __restrict__ keyvs,
                const uint32_t* __restrict__ ftw,
                const uint32_t* __restrict__ ftws,
                const uint32_t* __restrict__ itw,
                const uint32_t* __restrict__ itws, unsigned char* ws,
                const PbsConsts Kp, const Layout L, int n, int B) {
  rotate_block<P, W, S, true>(acc_g, a_g, keyv, keyvs, ftw, ftws, itw, itws,
                              ws, Kp, L, 1, B);
}

struct Args {
  void* acc;
  const int32_t* a;
  const uint32_t *keyv, *keyvs, *ftw, *ftws, *itw, *itws;
  unsigned char* ws;
  int n, B;
  cudaStream_t stream;
};

template <int P, typename W, bool S, bool Step>
cudaError_t launch(const Args& x, const PbsConsts& K, const Layout& L) {
  auto* kernel = Step ? pbs_step_kernel<P, W, S> : blind_rotate_kernel<P, W, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.smem));
  if (err != cudaSuccess) return err;
  kernel<<<x.B, kThreads, L.smem, x.stream>>>(
      static_cast<W*>(x.acc), x.a, x.keyv, x.keyvs, x.ftw, x.ftws, x.itw,
      x.itws, x.ws, K, L, x.n, x.B);
  return cudaGetLastError();
}

template <int P, typename W, bool Step>
cudaError_t launch_s(const Args& x, const PbsConsts& K, const Layout& L) {
  return all_shared(L, kNumBuf) ? launch<P, W, true, Step>(x, K, L)
                                : launch<P, W, false, Step>(x, K, L);
}

template <typename W, bool Step>
cudaError_t launch_w(const Args& x, const PbsConsts& K, const Layout& L) {
  switch (K.P) {
    case 2: return launch_s<2, W, Step>(x, K, L);
    case 3: return launch_s<3, W, Step>(x, K, L);
    case 4: return launch_s<4, W, Step>(x, K, L);
    default: return launch_s<5, W, Step>(x, K, L);
  }
}

template <bool Step>
int launch_entry(void* acc, const void* a, const void* keyv,
                 const void* keyvs, const void* ftw, const void* ftws,
                 const void* itw, const void* itws, void* ws,
                 const int64_t* consts, const int64_t* layout, int B, int n,
                 int word_bits, void* stream) {
  PbsConsts K;
  if (!parse_consts(consts, K) || (word_bits != 32 && word_bits != 64))
    return int(cudaErrorInvalidValue);
  if (B == 0) return int(cudaSuccess);
  const Args x{acc,
               static_cast<const int32_t*>(a),
               static_cast<const uint32_t*>(keyv),
               static_cast<const uint32_t*>(keyvs),
               static_cast<const uint32_t*>(ftw),
               static_cast<const uint32_t*>(ftws),
               static_cast<const uint32_t*>(itw),
               static_cast<const uint32_t*>(itws),
               static_cast<unsigned char*>(ws),
               n,
               B,
               static_cast<cudaStream_t>(stream)};
  const Layout L = parse_layout(layout, kNumBuf);
  return int(word_bits == 32 ? launch_w<uint32_t, Step>(x, K, L)
                             : launch_w<uint64_t, Step>(x, K, L));
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh), whose
// gadget offset is of the word width; layout: the buffer placement (smem
// bytes, workspace stride, then the offsets of work, spec, rot, acc); ws: the
// workspace, B x stride bytes (null when the stride is 0).  acc [B, k+1, N]
// u64 words (word_bits 64) or u32 words (word_bits 32) is rotated in place;
// a [n, B] int32 in [0, 2N]; keyv/keyvs [n, (k+1)l, k+1, P, N] u32;
// twiddles [P, N] u32.
int blind_rotate_launch(void* acc, const void* a, const void* keyv,
                        const void* keyvs, const void* ftw, const void* ftws,
                        const void* itw, const void* itws, void* ws,
                        const int64_t* consts, const int64_t* layout, int B,
                        int n, int word_bits, void* stream) {
  return launch_entry<false>(acc, a, keyv, keyvs, ftw, ftws, itw, itws, ws,
                             consts, layout, B, n, word_bits, stream);
}

// K1-step: one CMUX step of acc [B, k+1, N] (updated in place) with the
// step's exponents a [B] int32 in [0, 2N] and key rows keyv/keyvs
// [(k+1)l, k+1, P, N] u32; the rest as above.
int pbs_step_launch(void* acc, const void* a, const void* keyv,
                    const void* keyvs, const void* ftw, const void* ftws,
                    const void* itw, const void* itws, void* ws,
                    const int64_t* consts, const int64_t* layout, int B,
                    int word_bits, void* stream) {
  return launch_entry<true>(acc, a, keyv, keyvs, ftw, ftws, itw, itws, ws,
                            consts, layout, B, 1, word_bits, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
