// UBR phase 1 for NVIDIA Hopper (sm_90a): per ciphertext b and group g the
// combined key TRGSW in NTT form,
//
//   out[b, g] = NTT(sum_m X^{rot[b,g,m]} SU[g,m])
//
// summed mod 2^64 (mod 2^32 at the 32-bit torus), the cache that UBR phase
// 2 applies to every LUT (`multivalue_bootstrap_UBR_phase1`, the
// reference's bootstrap.c:151-175).
//
// Replaces the TPU kernel `ubr_phase1_combine_v2` (the TPU package's
// ops/pbs_kernel.py:2881, body `_make_phase1_v2_kernel`).  Per output row
// (b, g, j, c):
//
//   1. the key row combined over the M = 2^u key products, each rotated by
//      its own exponent in [0, 2N] (2N is the identity), summed mod 2^64 in
//      the time domain;
//   2. reduced to the residues of its centred (signed) representative, as
//      `ntt.to_resi_u64` defines them;
//   3. P forward negacyclic NTTs, written as u32 canonical residues into
//      out [B, G, J, C, P, N], the layout the apply-scan kernel
//      (ext_product_apply.cu) takes.
//
// At the 32-bit torus (TORUS32) the key products are u32 words (the word
// type W), summed mod 2^32, and the residue is that of the sum's int32
// value (the TPU kernel's `nl == 1` branch, pbs_kernel.py:2833-2836).
//
// Design.  One thread block per output row (b, g, j, c): B*G*J*C blocks
// (1,264 at TFHEpp-L2, u=8, one ciphertext), so even one ciphertext fills
// the card, where a block per (b, g) would leave most SMs idle at G = 79.
// A block holds the row's P residue rows (P*N u32, 24 KiB at N=2048) and
// the M exponents in shared memory, so several blocks share an SM; nothing
// is sized by M beyond the exponents.  Helpers are shared with the other
// kernels (ntt_common.cuh).
//
// What bounds it on this card: at u=8 the M = 256 rotate-adds per output
// word (2 INT32 operations each) and the P NTTs of each row, against 64
// INT32 lanes per SM; the key (5.3 GB at TFHEpp-L2, u=8) is read once for
// one ciphertext, about 1.6 ms at the HBM rate.  Consecutive threads read
// consecutive words of each rotated key row, so the reads are coalesced.
//
// K5-v1 (`ubr_phase1_v1_launch`, replacing the TPU package's first
// phase-1 kernel `ubr_phase1_combine`, pbs_kernel.py:2744) launches this
// kernel on the same operands.

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int P, typename W>
__global__ void __launch_bounds__(kThreads)
ubr_phase1_kernel(const W* __restrict__ su, const int32_t* __restrict__ rot_g,
                  uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ ftw,
                  const uint32_t* __restrict__ ftws, const PbsConsts Kp,
                  int G, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  const int JC = Kp.C * Kp.l * Kp.C, N = Kp.N;
  uint32_t* row_res = reinterpret_cast<uint32_t*>(smem);     // [P][N]
  int32_t* rots = reinterpret_cast<int32_t*>(row_res + P * N);  // [M]

  // blockIdx.x = (b * G + g) * JC + jc
  const int jc = blockIdx.x % JC;
  const int bg = blockIdx.x / JC;
  const int g = bg % G;
  const int32_t* rot_bg = rot_g + size_t(bg) * M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) rots[m] = rot_bg[m];
  __syncthreads();

  // 1-2. combine the key row over m, centred residues
  const size_t m_stride = size_t(JC) * N;  // su [G][M][J][C][N]
  const W* row = su + (size_t(g) * M * JC + jc) * N;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    W x = 0;
    for (int m = 0; m < M; ++m)
      x += rotated_word<W>(row + m * m_stride, k, rots[m], N);
#pragma unroll
    for (int pi = 0; pi < P; ++pi)
      row_res[pi * N + k] = centred_residue(x, pi, K);
  }
  __syncthreads();
  // 3. forward NTTs, then the row's P residue rows out
  forward_ntt<P>(row_res, P, K, ftw, ftws);
  uint32_t* out_row = out + size_t(blockIdx.x) * P * N;
  for (int idx = threadIdx.x; idx < P * N; idx += blockDim.x)
    out_row[idx] = row_res[idx];
}

template <int P, typename W>
cudaError_t launch(const void* su, const int32_t* rot, uint32_t* out,
                   const uint32_t* ftw, const uint32_t* ftws,
                   const PbsConsts& K, int B, int G, int M,
                   cudaStream_t stream) {
  const size_t smem = size_t(P) * K.N * sizeof(uint32_t) +
                      size_t(M) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ubr_phase1_kernel<P, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * G * K.C * K.l * K.C;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  ubr_phase1_kernel<P, W><<<unsigned(blocks), kThreads, smem, stream>>>(
      static_cast<const W*>(su), rot, out, ftw, ftws, K, G, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh).
// su [G, M, (k+1)l, k+1, N] key products, u64 words (word_bits 64) or u32
// words (word_bits 32); rot [B, G, M] int32 in [0, 2N]; out [B, G, (k+1)l,
// k+1, P, N] u32; twiddles [P, N] u32.
int ubr_phase1_launch(const void* su, const void* rot, void* out,
                      const void* ftw, const void* ftws,
                      const int64_t* consts, int B, int G, int M,
                      int word_bits, void* stream) {
  PbsConsts K;
  if (!parse_consts(consts, K)) return int(cudaErrorInvalidValue);
  if (B == 0 || G == 0) return int(cudaSuccess);
  auto* r = static_cast<const int32_t*>(rot);
  auto* o = static_cast<uint32_t*>(out);
  auto* f = static_cast<const uint32_t*>(ftw);
  auto* fs = static_cast<const uint32_t*>(ftws);
  auto st = static_cast<cudaStream_t>(stream);
  return int(dispatch_pw(K.P, word_bits, [&](auto p, auto w) {
    return launch<decltype(p)::value, decltype(w)>(su, r, o, f, fs, K, B, G,
                                                   M, st);
  }));
}

// K5-v1: the same operands and output as ubr_phase1_launch, and the same
// launch of K5's kernel.
int ubr_phase1_v1_launch(const void* su, const void* rot, void* out,
                         const void* ftw, const void* ftws,
                         const int64_t* consts, int B, int G, int M,
                         int word_bits, void* stream) {
  return ubr_phase1_launch(su, rot, out, ftw, ftws, consts, B, G, M,
                           word_bits, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
