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
// Design.  A blind rotate is one call, so it is one launch: one thread
// block per ciphertext runs the n steps as a loop (the TPU's sequential grid
// axis).  The accumulator stays in shared memory for the whole rotation
// (acc and rot: 2 x C x N u64; spec: C x P x N u32; one digit row's NTT
// buffer: P x N u32 -- 136 KiB at N=2048, k=1, P=3, so one block per SM).
// Every residue is kept canonical in [0, p) with Shoup products
// (__umulhi), so the result is bit-identical to the plain PyTorch version.
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

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 1024;

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
blind_rotate_kernel(uint64_t* __restrict__ acc_g,
                    const int32_t* __restrict__ a_g,
                    const uint32_t* __restrict__ keyv,
                    const uint32_t* __restrict__ keyvs,
                    const uint32_t* __restrict__ ftw,
                    const uint32_t* __restrict__ ftws,
                    const uint32_t* __restrict__ itw,
                    const uint32_t* __restrict__ itws, const PbsConsts Kp,
                    int n, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  // The constants are indexed by a per-thread prime index: keep one copy in
  // shared memory, where that costs a broadcast load.
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  const int N = K.N, C = K.C, l = K.l, J = K.C * K.l, CN = K.C * K.N;
  uint64_t* acc = reinterpret_cast<uint64_t*>(smem);   // [C][N]
  uint64_t* rot = acc + CN;                            // [C][N]
  uint32_t* spec = reinterpret_cast<uint32_t*>(rot + CN);  // [C][P][N]
  uint32_t* work = spec + C * P * N;                   // [P][N]

  uint64_t* acc_b = acc_g + size_t(blockIdx.x) * CN;
  for (int i = threadIdx.x; i < CN; i += blockDim.x) acc[i] = acc_b[i];
  __syncthreads();

  const size_t step_stride = size_t(J) * C * P * N;
  for (int s = 0; s < n; ++s) {
    const int a = a_g[size_t(s) * B + blockIdx.x];  // in [0, 2N]
    // 1. rot + offset, with rot = X^a acc - acc
    for (int idx = threadIdx.x; idx < CN; idx += blockDim.x) {
      const int c = idx >> K.logN, k = idx & (N - 1);
      rot[idx] = rotated_word(acc + c * N, k, a, N) - acc[idx] + K.offset;
    }
    for (int idx = threadIdx.x; idx < C * P * N; idx += blockDim.x)
      spec[idx] = 0;
    __syncthreads();

    const uint32_t* kv = keyv + s * step_stride;
    const uint32_t* ks = keyvs + s * step_stride;
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
      acc[idx] += garner<P>(spec + c * P * N, k, K);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < CN; i += blockDim.x) acc_b[i] = acc[i];
}

template <int P>
cudaError_t launch(uint64_t* acc, const int32_t* a, const uint32_t* keyv,
                   const uint32_t* keyvs, const uint32_t* ftw,
                   const uint32_t* ftws, const uint32_t* itw,
                   const uint32_t* itws, const PbsConsts& K, int n, int B,
                   cudaStream_t stream) {
  const size_t smem = size_t(2) * K.C * K.N * sizeof(uint64_t) +
                      size_t(K.C * P + P) * K.N * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  blind_rotate_kernel<P><<<B, kThreads, smem, stream>>>(
      acc, a, keyv, keyvs, ftw, ftws, itw, itws, K, n, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh).
// acc [B, k+1, N] u64 is rotated in place; a [n, B] int32 in [0, 2N];
// keyv/keyvs [n, (k+1)l, k+1, P, N] u32; twiddles [P, N] u32.
int blind_rotate_launch(void* acc, const void* a, const void* keyv,
                        const void* keyvs, const void* ftw, const void* ftws,
                        const void* itw, const void* itws,
                        const int64_t* consts, int B, int n, void* stream) {
  PbsConsts K;
  if (!parse_consts(consts, K)) return int(cudaErrorInvalidValue);
  if (B == 0) return int(cudaSuccess);
  auto* acc64 = static_cast<uint64_t*>(acc);
  auto* a32 = static_cast<const int32_t*>(a);
  auto* kv = static_cast<const uint32_t*>(keyv);
  auto* ks = static_cast<const uint32_t*>(keyvs);
  auto* f = static_cast<const uint32_t*>(ftw);
  auto* fs = static_cast<const uint32_t*>(ftws);
  auto* iv = static_cast<const uint32_t*>(itw);
  auto* is = static_cast<const uint32_t*>(itws);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (K.P) {
    case 2: err = launch<2>(acc64, a32, kv, ks, f, fs, iv, is, K, n, B, st); break;
    case 3: err = launch<3>(acc64, a32, kv, ks, f, fs, iv, is, K, n, B, st); break;
    case 4: err = launch<4>(acc64, a32, kv, ks, f, fs, iv, is, K, n, B, st); break;
    default: err = launch<5>(acc64, a32, kv, ks, f, fs, iv, is, K, n, B, st); break;
  }
  return int(err);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
