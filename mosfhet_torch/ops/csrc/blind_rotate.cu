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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 5;
constexpr int kThreads = 1024;

struct PbsConsts {
  uint32_t p[kMaxP], ninv[kMaxP], ninvs[kMaxP];
  uint32_t cinv[kMaxP], cinvs[kMaxP];
  uint32_t gw[kMaxP][kMaxP], gws[kMaxP][kMaxP];
  uint64_t offset;
  int N, logN, C, l, Bg_bit, n, B;
};

// a * w mod p in [0, 2p) for any a < 2^32, w < p, ws = floor(w 2^32 / p).
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, uint32_t w,
                                               uint32_t ws, uint32_t p) {
  return a * w - __umulhi(a, ws) * p;
}

__device__ __forceinline__ uint32_t shoup(uint32_t a, uint32_t w, uint32_t ws,
                                          uint32_t p) {
  uint32_t r = shoup_lazy(a, w, ws, p);
  return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  uint32_t s = a + p - b;
  return s >= p ? s - p : s;
}

// Forward negacyclic NTT of `rows` rows of length N in place; row r uses
// prime r % P.  Cooley-Tukey with merged psi powers: stage (m, t) pairs
// x[i 2t + j] with x[i 2t + j + t] under psi_rev[m + i].
template <int P>
__device__ void forward_ntt(uint32_t* x, int rows, const PbsConsts& K,
                            const uint32_t* __restrict__ tw,
                            const uint32_t* __restrict__ tws) {
  const int N = K.N, lh = K.logN - 1;
  const int total = rows << lh;
  for (int m = 1, lt = lh; m < N; m <<= 1, --lt) {
    const int t = 1 << lt;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int r = idx >> lh, b = idx & ((1 << lh) - 1);
      const int pi = r % P;
      const uint32_t p = K.p[pi];
      const int i = b >> lt, j = b & (t - 1);
      uint32_t* row = x + r * N;
      const int u = (i << (lt + 1)) + j;
      const uint32_t S = tw[pi * N + m + i], Ss = tws[pi * N + m + i];
      const uint32_t U = row[u];
      const uint32_t V = shoup(row[u + t], S, Ss, p);
      row[u] = add_mod(U, V, p);
      row[u + t] = sub_mod(U, V, p);
    }
    __syncthreads();
  }
}

// Inverse (Gentleman-Sande) of `forward_ntt` without the 1/N scaling.
template <int P>
__device__ void inverse_ntt(uint32_t* x, int rows, const PbsConsts& K,
                            const uint32_t* __restrict__ tw,
                            const uint32_t* __restrict__ tws) {
  const int N = K.N, lh = K.logN - 1;
  const int total = rows << lh;
  for (int lt = 0, h = N >> 1; h >= 1; ++lt, h >>= 1) {
    const int t = 1 << lt;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int r = idx >> lh, b = idx & ((1 << lh) - 1);
      const int pi = r % P;
      const uint32_t p = K.p[pi];
      const int i = b >> lt, j = b & (t - 1);
      uint32_t* row = x + r * N;
      const int u = (i << (lt + 1)) + j;
      const uint32_t S = tw[pi * N + h + i], Ss = tws[pi * N + h + i];
      const uint32_t U = row[u], V = row[u + t];
      row[u] = add_mod(U, V, p);
      row[u + t] = shoup(sub_mod(U, V, p), S, Ss, p);
    }
    __syncthreads();
  }
}

// Unscaled inverse-NTT outputs of one coefficient -> exact value mod 2^64.
template <int P>
__device__ __forceinline__ uint64_t garner(const uint32_t* spec_c, int k,
                                           const PbsConsts& K) {
  uint32_t d[P];
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const uint32_t p = K.p[m];
    const uint32_t r = shoup(spec_c[m * K.N + k], K.ninv[m], K.ninvs[m], p);
    if (m == 0) {
      d[0] = r;
      continue;
    }
    uint32_t acc = d[0];  // d[0] < p_0 < p_m
#pragma unroll
    for (int j = 1; j < m; ++j)
      acc = add_mod(acc, shoup(d[j], K.gw[m][j], K.gws[m][j], p), p);
    d[m] = shoup(sub_mod(r, acc, p), K.cinv[m], K.cinvs[m], p);
  }
  const uint32_t top = d[P - 1], ptop = K.p[P - 1];
  uint64_t v = top > ptop / 2 ? uint64_t(top) - ptop : uint64_t(top);
#pragma unroll
  for (int m = P - 2; m >= 0; --m) v = v * K.p[m] + d[m];
  return v;
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
blind_rotate_kernel(uint64_t* __restrict__ acc_g,
                    const int32_t* __restrict__ a_g,
                    const uint32_t* __restrict__ keyv,
                    const uint32_t* __restrict__ keyvs,
                    const uint32_t* __restrict__ ftw,
                    const uint32_t* __restrict__ ftws,
                    const uint32_t* __restrict__ itw,
                    const uint32_t* __restrict__ itws, const PbsConsts Kp) {
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
  const int digit_mask = (1 << K.Bg_bit) - 1, digit_half = 1 << (K.Bg_bit - 1);
  for (int s = 0; s < K.n; ++s) {
    const int a = a_g[size_t(s) * K.B + blockIdx.x];  // in [0, 2N]
    // 1. rot + offset, with rot = X^a acc - acc: out[k] = +-acc[(k-a) mod N],
    //    negated when (k - a) mod 2N >= N.  a == 2N is the identity.
    for (int idx = threadIdx.x; idx < CN; idx += blockDim.x) {
      const int c = idx >> K.logN, k = idx & (N - 1);
      const int m = (k - a) & (2 * N - 1);
      uint64_t v = acc[c * N + (m & (N - 1))];
      if (m & N) v = 0 - v;
      rot[idx] = v - acc[idx] + K.offset;
    }
    for (int idx = threadIdx.x; idx < C * P * N; idx += blockDim.x)
      spec[idx] = 0;
    __syncthreads();

    const uint32_t* kv = keyv + s * step_stride;
    const uint32_t* ks = keyvs + s * step_stride;
    for (int j = 0; j < J; ++j) {
      // 2. digit row j = (component c_j, digit d) as residues mod each prime
      const int cj = j / l, d = j % l;
      const int shift = 64 - (d + 1) * K.Bg_bit;
      for (int k = threadIdx.x; k < N; k += blockDim.x) {
        const int digit =
            int((rot[cj * N + k] >> shift) & uint64_t(digit_mask)) - digit_half;
#pragma unroll
        for (int pi = 0; pi < P; ++pi)
          work[pi * N + k] = digit < 0 ? uint32_t(digit + int(K.p[pi]))
                                       : uint32_t(digit);
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
                   const uint32_t* itws, const PbsConsts& K,
                   cudaStream_t stream) {
  const size_t smem = size_t(2) * K.C * K.N * sizeof(uint64_t) +
                      size_t(K.C * P + P) * K.N * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  blind_rotate_kernel<P><<<K.B, kThreads, smem, stream>>>(
      acc, a, keyv, keyvs, ftw, ftws, itw, itws, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// consts (host memory, int64): N, k, l, Bg_bit, P, offset (u64 bits), then
// p[P], ninv[P], ninvs[P], cinv[P], cinvs[P], gw[P*P], gws[P*P].
// acc [B, k+1, N] u64 is rotated in place; a [n, B] int32 in [0, 2N];
// keyv/keyvs [n, (k+1)l, k+1, P, N] u32; twiddles [P, N] u32.
int blind_rotate_launch(void* acc, const void* a, const void* keyv,
                        const void* keyvs, const void* ftw, const void* ftws,
                        const void* itw, const void* itws,
                        const int64_t* consts, int B, int n, void* stream) {
  PbsConsts K = {};
  K.N = int(consts[0]);
  K.C = int(consts[1]) + 1;
  K.l = int(consts[2]);
  K.Bg_bit = int(consts[3]);
  const int P = int(consts[4]);
  K.offset = uint64_t(consts[5]);
  K.n = n;
  K.B = B;
  if (P < 2 || P > kMaxP || K.N < 4 || (K.N & (K.N - 1)))
    return int(cudaErrorInvalidValue);
  K.logN = 0;
  while ((1 << K.logN) < K.N) ++K.logN;
  const int64_t* c = consts + 6;
  for (int m = 0; m < P; ++m) {
    K.p[m] = uint32_t(c[m]);
    K.ninv[m] = uint32_t(c[P + m]);
    K.ninvs[m] = uint32_t(c[2 * P + m]);
    K.cinv[m] = uint32_t(c[3 * P + m]);
    K.cinvs[m] = uint32_t(c[4 * P + m]);
    for (int j = 0; j < P; ++j) {
      K.gw[m][j] = uint32_t(c[5 * P + m * P + j]);
      K.gws[m][j] = uint32_t(c[5 * P + P * P + m * P + j]);
    }
  }
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
  switch (P) {
    case 2: err = launch<2>(acc64, a32, kv, ks, f, fs, iv, is, K, st); break;
    case 3: err = launch<3>(acc64, a32, kv, ks, f, fs, iv, is, K, st); break;
    case 4: err = launch<4>(acc64, a32, kv, ks, f, fs, iv, is, K, st); break;
    default: err = launch<5>(acc64, a32, kv, ks, f, fs, iv, is, K, st); break;
  }
  return int(err);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
