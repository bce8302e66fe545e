// The whole unfolded blind rotation of a batch of TRLWE accumulators in one
// launch, for NVIDIA Hopper (sm_90a):
//
//   acc <- (sum_m X^{rot[b,g,m]} SU[g,m]) (x) acc     for g = 0 .. G-1
//
// exactly mod 2^64, with G = n/u groups of M = 2^u key-product TRGSWs
// (`blind_rotate_unfolded`, the reference's bootstrap.c:124-148).
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
// Design.  One thread block per ciphertext, the G groups a loop inside it
// (the TPU's sequential grid axes), as K1 (blind_rotate.cu).  The combined
// TRGSW of one group in NTT form is J*C*P*N u32 = 384 KiB at TFHEpp-L2, more
// than a block's 227 KB of shared memory (the TPU held it in VMEM), so it is
// streamed by row: each key row (j, c) is combined, reduced, transformed and
// consumed before the next.  Shared memory: acc C*N u64, spec C*P*N u32, the
// digit spectra and one key row P*N u32 each, and the group's M exponents:
// 129 KiB at TFHEpp-L2 whatever u is, so one block per SM.  Nothing is sized
// by M beyond the M exponents.  Exponents may be 0 or 2N (the identity).
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

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
unfolded_rotate_kernel(uint64_t* __restrict__ acc_g,
                       const int32_t* __restrict__ rot_g,
                       const uint64_t* __restrict__ su,
                       const uint32_t* __restrict__ ftw,
                       const uint32_t* __restrict__ ftws,
                       const uint32_t* __restrict__ itw,
                       const uint32_t* __restrict__ itws, const PbsConsts Kp,
                       int G, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  const int N = K.N, C = K.C, l = K.l, J = K.C * K.l, CN = K.C * K.N;
  uint64_t* acc = reinterpret_cast<uint64_t*>(smem);       // [C][N]
  uint32_t* spec = reinterpret_cast<uint32_t*>(acc + CN);  // [C][P][N]
  uint32_t* dig = spec + C * P * N;                        // [P][N]
  uint32_t* key = dig + P * N;                             // [P][N]
  int32_t* rots = reinterpret_cast<int32_t*>(key + P * N);  // [M]

  const int b = blockIdx.x;
  uint64_t* acc_b = acc_g + size_t(b) * CN;
  for (int i = threadIdx.x; i < CN; i += blockDim.x) acc[i] = acc_b[i];

  const size_t m_stride = size_t(J) * C * N;  // su [G][M][J][C][N]
  for (int g = 0; g < G; ++g) {
    const int32_t* rot_bg = rot_g + (size_t(b) * G + g) * M;
    for (int m = threadIdx.x; m < M; m += blockDim.x) rots[m] = rot_bg[m];
    for (int idx = threadIdx.x; idx < C * P * N; idx += blockDim.x)
      spec[idx] = 0;
    const uint64_t* su_g = su + size_t(g) * M * m_stride;
    for (int j = 0; j < J; ++j) {
      // 1. digit row j = (component c_j, digit d), P forward NTTs
      const int cj = j / l, d = j % l;
      __syncthreads();
      for (int k = threadIdx.x; k < N; k += blockDim.x) {
        const int digit = gadget_digit(acc[cj * N + k] + K.offset, d, K);
#pragma unroll
        for (int pi = 0; pi < P; ++pi)
          dig[pi * N + k] = small_residue(digit, K.p[pi]);
      }
      __syncthreads();
      forward_ntt<P>(dig, P, K, ftw, ftws);
      for (int c = 0; c < C; ++c) {
        // 2. key row (j, c): sum_m X^{rots[m]} SU[g, m, j, c] mod 2^64,
        //    centred residues, P forward NTTs, then the product
        const uint64_t* row = su_g + size_t(j * C + c) * N;
        for (int k = threadIdx.x; k < N; k += blockDim.x) {
          uint64_t x = 0;
          for (int m = 0; m < M; ++m)
            x += rotated_word(row + m * m_stride, k, rots[m], N);
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
      acc[idx] = garner<P>(spec + c * P * N, k, K);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < CN; i += blockDim.x) acc_b[i] = acc[i];
}

template <int P>
cudaError_t launch(uint64_t* acc, const int32_t* rot, const uint64_t* su,
                   const uint32_t* ftw, const uint32_t* ftws,
                   const uint32_t* itw, const uint32_t* itws,
                   const PbsConsts& K, int B, int G, int M,
                   cudaStream_t stream) {
  const size_t smem = size_t(K.C) * K.N * sizeof(uint64_t) +
                      size_t(K.C * P + 2 * P) * K.N * sizeof(uint32_t) +
                      size_t(M) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      unfolded_rotate_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  unfolded_rotate_kernel<P><<<B, kThreads, smem, stream>>>(
      acc, rot, su, ftw, ftws, itw, itws, K, G, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh).
// acc [B, k+1, N] u64 is rotated in place; rot [B, G, M] int32 in [0, 2N];
// su [G, M, (k+1)l, k+1, N] u64 key products; twiddles [P, N] u32.
int unfolded_rotate_launch(void* acc, const void* rot, const void* su,
                           const void* ftw, const void* ftws, const void* itw,
                           const void* itws, const int64_t* consts, int B,
                           int G, int M, void* stream) {
  PbsConsts K;
  if (!parse_consts(consts, K)) return int(cudaErrorInvalidValue);
  if (B == 0 || G == 0) return int(cudaSuccess);
  auto* a64 = static_cast<uint64_t*>(acc);
  auto* r = static_cast<const int32_t*>(rot);
  auto* s = static_cast<const uint64_t*>(su);
  auto* f = static_cast<const uint32_t*>(ftw);
  auto* fs = static_cast<const uint32_t*>(ftws);
  auto* iv = static_cast<const uint32_t*>(itw);
  auto* is = static_cast<const uint32_t*>(itws);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (K.P) {
    case 2: err = launch<2>(a64, r, s, f, fs, iv, is, K, B, G, M, st); break;
    case 3: err = launch<3>(a64, r, s, f, fs, iv, is, K, B, G, M, st); break;
    case 4: err = launch<4>(a64, r, s, f, fs, iv, is, K, B, G, M, st); break;
    default: err = launch<5>(a64, r, s, f, fs, iv, is, K, B, G, M, st); break;
  }
  return int(err);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
