// The whole unfolded blind rotation of a batch of TRLWE accumulators in one
// launch, for NVIDIA Hopper (sm_90a):
//
//   acc <- (sum_m X^{rot[b,g,m]} SU[g,m]) (x) acc     for g = 0 .. G-1
//
// exactly mod 2^64 (mod 2^32 at the 32-bit torus), with G = n/u groups of
// M = 2^u key-product TRGSWs (`blind_rotate_unfolded`, the reference's
// bootstrap.c:124-148).
//
// Replaces the TPU kernel `unfolded_rotate` (the TPU package's
// ops/pbs_kernel.py:3123, body `_make_unfolded_kernel`).  Per ciphertext
// and group:
//
//   1. per digit row j of the accumulator (J = (k+1) l): signed gadget
//      digits as residues, P forward NTTs;
//   2. for each component c of that row: the key row (j, c) combined over
//      the M key products, each rotated by its own exponent, summed mod
//      2^64 in the time domain; reduced to the residues of its centred
//      (signed) representative, as `ntt.to_resi_u64` defines them; P forward
//      NTTs; a Barrett multiply-accumulate with the digit spectra into
//      spec[c][p];
//   3. inverse NTTs of the C*P spectra, Garner CRT to exact u64 words,
//      which replace acc (replace mode: the combined TRGSW carries the
//      CMUX itself).
//
// The combine is never done in the NTT domain: a sum of 2^u spectra would
// outgrow the CRT range that the primes were chosen for.
//
// At the 32-bit torus (TORUS32) the same body runs on u32 words (the word
// type W): the key products and acc are u32, the M rotated words are summed
// mod 2^32, the combined word's residue is that of its int32 value, the
// gadget offset is the 32-bit one (cast to W once) and Garner's Horner step
// wraps mod 2^32 (the TPU kernel's `nl == 1` branches, pbs_kernel.py:
// 3044-3046 and :3113-3114).  The key row buffer holds residues (u32) at
// both widths.
//
// Design.  One thread block per ciphertext, the G groups a loop inside it
// (the TPU's sequential grid axes), as K1 (blind_rotate.cu).  The combined
// TRGSW of one group in NTT form is J*C*P*N u32 = 384 KiB at TFHEpp-L2, more
// than a block's 227 KB of shared memory (the TPU held it in VMEM), so it is
// streamed by row: each key row (j, c) is combined, reduced, transformed and
// consumed before the next.  Buffers: acc C*N u64, spec C*P*N u32, the
// digit spectra and one key row P*N u32 each, and the group's M exponents:
// 129 KiB at TFHEpp-L2 whatever u is, all in shared memory, so one block per
// SM.  Nothing is sized by M beyond the M exponents.  Exponents may be 0 or
// 2N (the identity).  Where the buffers do not all fit (320 KiB + 4M at
// N=4096 with 4 primes) the wrapper fills shared memory by traffic: the
// exponents, the key row (J*C NTTs per group), the digit rows (J NTTs),
// the spectra, acc; what is left over lives in a global workspace (the
// spectra at SET_3) or, for acc, in the caller's tensor.
//
// What bounds it on this card: integer multiplies.  Per ciphertext and
// group at TFHEpp-L2: 24 digit + 48 key + 6 inverse NTTs x 11,264 Shoup
// butterflies, 98,304 Barrett products, 98,304 centred reductions and
// 32,768 x M u64 rotate-adds.  Bytes are far below that: every block reads
// the whole key (663 MB at u=4), but blocks resident together start
// together and walk the groups roughly in step, so each 4 MiB group slice
// is read from HBM about once per wave and shared through the 50 MB L2.
// Like K1, this first version runs its NTT stages as block-wide barriers.

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 1024;
// buffers, as the wrapper lists them
enum { kRots, kKey, kDig, kSpec, kAcc, kNumBuf };

template <int P, typename W, bool S>
__global__ void __launch_bounds__(kThreads, 1)
unfolded_rotate_kernel(W* __restrict__ acc_g,
                       const int32_t* __restrict__ rot_g,
                       const W* __restrict__ su,
                       const uint32_t* __restrict__ ftw,
                       const uint32_t* __restrict__ ftws,
                       const uint32_t* __restrict__ itw,
                       const uint32_t* __restrict__ itws, unsigned char* ws,
                       const PbsConsts Kp, const Layout L, int G, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  const int N = K.N, C = K.C, l = K.l, J = K.C * K.l, CN = K.C * K.N;
  const W offset = W(K.offset);
  const int b = blockIdx.x;
  W* acc_b = acc_g + size_t(b) * CN;
  W* acc = buffer<S, W>(L, kAcc, smem, ws, acc_b);                 // [C][N]
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);  // [C][P][N]
  auto* dig = buffer<S, uint32_t>(L, kDig, smem, ws, nullptr);    // [P][N]
  auto* key = buffer<S, uint32_t>(L, kKey, smem, ws, nullptr);    // [P][N]
  auto* rots = buffer<S, int32_t>(L, kRots, smem, ws, nullptr);   // [M]
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += blockDim.x) acc[i] = acc_b[i];

  const size_t m_stride = size_t(J) * C * N;  // su [G][M][J][C][N]
  for (int g = 0; g < G; ++g) {
    const int32_t* rot_bg = rot_g + (size_t(b) * G + g) * M;
    for (int m = threadIdx.x; m < M; m += blockDim.x) rots[m] = rot_bg[m];
    for (int idx = threadIdx.x; idx < C * P * N; idx += blockDim.x)
      spec[idx] = 0;
    const W* su_g = su + size_t(g) * M * m_stride;
    for (int j = 0; j < J; ++j) {
      // 1. digit row j = (component c_j, digit d), P forward NTTs
      const int cj = j / l, d = j % l;
      __syncthreads();
      for (int k = threadIdx.x; k < N; k += blockDim.x) {
        const int digit = gadget_digit<W>(acc[cj * N + k] + offset, d, K);
#pragma unroll
        for (int pi = 0; pi < P; ++pi)
          dig[pi * N + k] = small_residue(digit, K.p[pi]);
      }
      __syncthreads();
      forward_ntt<P>(dig, P, K, ftw, ftws);
      for (int c = 0; c < C; ++c) {
        // 2. key row (j, c): sum_m X^{rots[m]} SU[g, m, j, c] mod 2^64 (or
        //    2^32), centred residues, P forward NTTs, then the product
        const W* row = su_g + size_t(j * C + c) * N;
        for (int k = threadIdx.x; k < N; k += blockDim.x) {
          W x = 0;
          for (int m = 0; m < M; ++m)
            x += rotated_word<W>(row + m * m_stride, k, rots[m], N);
#pragma unroll
          for (int pi = 0; pi < P; ++pi)
            key[pi * N + k] = centred_residue(x, pi, K);
        }
        __syncthreads();
        forward_ntt<P>(key, P, K, ftw, ftws);
        for (int idx = threadIdx.x; idx < P * N; idx += blockDim.x) {
          const int pi = idx >> K.logN;
          const uint32_t p = K.p[pi];
          uint32_t* sp = spec + c * P * N + idx;
          *sp = add_mod(*sp, barrett(dig[idx], key[idx], p, K.mup[pi]), p);
        }
        __syncthreads();
      }
    }
    // 3. inverse NTTs, Garner (with 1/N) replacing acc
    inverse_ntt<P>(spec, C * P, K, itw, itws);
    for (int idx = threadIdx.x; idx < CN; idx += blockDim.x) {
      const int c = idx >> K.logN, k = idx & (N - 1);
      acc[idx] = garner<P, W>(spec + c * P * N, k, K);
    }
    __syncthreads();
  }
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += blockDim.x) acc_b[i] = acc[i];
}

struct Args {
  void* acc;
  const int32_t* rot;
  const void* su;
  const uint32_t *ftw, *ftws, *itw, *itws;
  unsigned char* ws;
  int B, G, M;
  cudaStream_t stream;
};

template <int P, typename W, bool S>
cudaError_t launch_s(const Args& x, const PbsConsts& K, const Layout& L) {
  cudaError_t err = cudaFuncSetAttribute(
      unfolded_rotate_kernel<P, W, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.smem));
  if (err != cudaSuccess) return err;
  unfolded_rotate_kernel<P, W, S><<<x.B, kThreads, L.smem, x.stream>>>(
      static_cast<W*>(x.acc), x.rot, static_cast<const W*>(x.su), x.ftw,
      x.ftws, x.itw, x.itws, x.ws, K, L, x.G, x.M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh), whose
// gadget offset is of the word width; layout: the buffer placement (smem
// bytes, workspace stride, offsets of rots, key, dig, spec, acc); ws: the
// workspace, B x stride bytes (null when the stride is 0).  acc [B, k+1, N]
// is rotated in place; rot [B, G, M] int32 in [0, 2N]; su [G, M, (k+1)l,
// k+1, N] key products; acc and su hold u64 words (word_bits 64) or u32
// words (word_bits 32); twiddles [P, N] u32.
int unfolded_rotate_launch(void* acc, const void* rot, const void* su,
                           const void* ftw, const void* ftws, const void* itw,
                           const void* itws, void* ws, const int64_t* consts,
                           const int64_t* layout, int B, int G, int M,
                           int word_bits, void* stream) {
  PbsConsts K;
  if (!parse_consts(consts, K)) return int(cudaErrorInvalidValue);
  if (B == 0 || G == 0) return int(cudaSuccess);
  const Args x{acc,
               static_cast<const int32_t*>(rot),
               su,
               static_cast<const uint32_t*>(ftw),
               static_cast<const uint32_t*>(ftws),
               static_cast<const uint32_t*>(itw),
               static_cast<const uint32_t*>(itws),
               static_cast<unsigned char*>(ws),
               B,
               G,
               M,
               static_cast<cudaStream_t>(stream)};
  const Layout L = parse_layout(layout, kNumBuf);
  const bool shared = all_shared(L, kNumBuf);
  return int(dispatch_pw(K.P, word_bits, [&](auto p, auto w) {
    using W = decltype(w);
    constexpr int P = decltype(p)::value;
    return shared ? launch_s<P, W, true>(x, K, L)
                  : launch_s<P, W, false>(x, K, L);
  }));
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
