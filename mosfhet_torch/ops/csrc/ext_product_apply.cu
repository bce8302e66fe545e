// G replace-mode external products with runtime keys in one launch, for
// NVIDIA Hopper (sm_90a):
//
//   acc <- SA_g (x) acc                 for g = 0 .. G-1, exactly mod 2^64
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
// Design.  One thread block per ciphertext, as K1 (blind_rotate.cu): the G
// products are a loop inside the block, with the accumulator (C x N u64),
// the spectra (C x P x N u32) and one digit row's P NTT rows in shared
// memory (104 KiB at TFHEpp-L2), so one launch serves any G and any batch
// (no padding to a tile).  Where that does not fit (256 KiB at N=4096 with
// 4 primes) the wrapper keeps the NTT rows and the spectra in shared memory
// and the block updates acc in place in the caller's tensor.  Helpers are
// shared with K1 (ntt_common.cuh).
//
// What bounds it on this card: integer multiplies.  Per product and
// ciphertext at TFHEpp-L2: (24 + 6) NTTs x 11,264 butterflies (one Shoup
// product, 3 multiplies) + 98,304 Barrett products (4 multiplies) + the
// Garner reconstructions of 4,096 words.  Bytes are far below that: the
// broadcast key (384 KiB per g) is read by every block, and blocks of a
// wave share it through the 50 MB L2.  Like K1, its NTT stages are
// block-wide barriers with a few butterflies per thread in between.

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 1024;
enum { kWork, kSpec, kAcc, kNumBuf };  // buffers, as the wrapper lists them

template <int P, bool S>
__global__ void __launch_bounds__(kThreads, 1)
ext_product_apply_kernel(uint64_t* __restrict__ acc_g,
                         const uint32_t* __restrict__ sa,
                         const uint32_t* __restrict__ ftw,
                         const uint32_t* __restrict__ ftws,
                         const uint32_t* __restrict__ itw,
                         const uint32_t* __restrict__ itws, unsigned char* ws,
                         const PbsConsts Kp, const Layout L, int B, int G,
                         int per_row) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  const int N = K.N, C = K.C, l = K.l, J = K.C * K.l, CN = K.C * K.N;
  const int b = blockIdx.x;
  uint64_t* acc_b = acc_g + size_t(b) * CN;
  uint64_t* acc = buffer<S, uint64_t>(L, kAcc, smem, ws, acc_b);  // [C][N]
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);  // [C][P][N]
  auto* work = buffer<S, uint32_t>(L, kWork, smem, ws, nullptr);  // [P][N]
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += blockDim.x) acc[i] = acc_b[i];

  const size_t key_size = size_t(J) * C * P * N;
  for (int g = 0; g < G; ++g) {
    const uint32_t* key =
        sa + (per_row ? size_t(g) * B + b : size_t(g)) * key_size;
    for (int idx = threadIdx.x; idx < C * P * N; idx += blockDim.x)
      spec[idx] = 0;
    __syncthreads();
    for (int j = 0; j < J; ++j) {
      // 1. digit row j = (component c_j, digit d) as residues mod each prime
      const int cj = j / l, d = j % l;
      for (int k = threadIdx.x; k < N; k += blockDim.x) {
        const int digit = gadget_digit(acc[cj * N + k] + K.offset, d, K);
#pragma unroll
        for (int pi = 0; pi < P; ++pi)
          work[pi * N + k] = small_residue(digit, K.p[pi]);
      }
      __syncthreads();
      // 2. forward NTTs, then spec[c][p] += NTT(digit row) * SA_g[j][c][p]
      forward_ntt<P>(work, P, K, ftw, ftws);
      for (int idx = threadIdx.x; idx < P * N; idx += blockDim.x) {
        const int pi = idx >> K.logN, k = idx & (N - 1);
        const uint32_t p = K.p[pi], mup = K.mup[pi], x = work[idx];
        for (int c = 0; c < C; ++c) {
          const size_t ko = (size_t(j * C + c) * P + pi) * N + k;
          uint32_t* sp = spec + (c * P + pi) * N + k;
          *sp = add_mod(*sp, barrett(x, key[ko], p, mup), p);
        }
      }
      __syncthreads();
    }
    // 3. inverse NTTs, Garner (with 1/N) replacing acc
    inverse_ntt<P>(spec, C * P, K, itw, itws);
    for (int idx = threadIdx.x; idx < CN; idx += blockDim.x) {
      const int c = idx >> K.logN, k = idx & (N - 1);
      acc[idx] = garner<P>(spec + c * P * N, k, K);
    }
    __syncthreads();
  }
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += blockDim.x) acc_b[i] = acc[i];
}

template <int P, bool S>
cudaError_t launch_s(uint64_t* acc, const uint32_t* sa, const uint32_t* ftw,
                     const uint32_t* ftws, const uint32_t* itw,
                     const uint32_t* itws, unsigned char* ws,
                     const PbsConsts& K, const Layout& L, int B, int G,
                     int per_row, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ext_product_apply_kernel<P, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.smem));
  if (err != cudaSuccess) return err;
  ext_product_apply_kernel<P, S><<<B, kThreads, L.smem, stream>>>(
      acc, sa, ftw, ftws, itw, itws, ws, K, L, B, G, per_row);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch(uint64_t* acc, const uint32_t* sa, const uint32_t* ftw,
                   const uint32_t* ftws, const uint32_t* itw,
                   const uint32_t* itws, unsigned char* ws,
                   const PbsConsts& K, const Layout& L, int B, int G,
                   int per_row, cudaStream_t stream) {
  return all_shared(L, kNumBuf)
             ? launch_s<P, true>(acc, sa, ftw, ftws, itw, itws, ws, K, L, B,
                                 G, per_row, stream)
             : launch_s<P, false>(acc, sa, ftw, ftws, itw, itws, ws, K, L, B,
                                  G, per_row, stream);
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh); layout:
// the buffer placement (smem bytes, workspace stride, offsets of work, spec,
// acc); ws: the workspace, B x stride bytes (null when the stride is 0).
// acc [B, k+1, N] u64 is replaced in place; sa [G, (k+1)l, k+1, P, N] u32
// canonical residues, or [G, B, (k+1)l, k+1, P, N] when per_row != 0;
// twiddles [P, N] u32.
int ext_product_apply_launch(void* acc, const void* sa, const void* ftw,
                             const void* ftws, const void* itw,
                             const void* itws, void* ws, const int64_t* consts,
                             const int64_t* layout, int B, int G, int per_row,
                             void* stream) {
  PbsConsts K;
  if (!parse_consts(consts, K)) return int(cudaErrorInvalidValue);
  const Layout L = parse_layout(layout, kNumBuf);
  auto* w = static_cast<unsigned char*>(ws);
  if (B == 0 || G == 0) return int(cudaSuccess);
  auto* a64 = static_cast<uint64_t*>(acc);
  auto* s = static_cast<const uint32_t*>(sa);
  auto* f = static_cast<const uint32_t*>(ftw);
  auto* fs = static_cast<const uint32_t*>(ftws);
  auto* iv = static_cast<const uint32_t*>(itw);
  auto* is = static_cast<const uint32_t*>(itws);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (K.P) {
    case 2: err = launch<2>(a64, s, f, fs, iv, is, w, K, L, B, G, per_row, st); break;
    case 3: err = launch<3>(a64, s, f, fs, iv, is, w, K, L, B, G, per_row, st); break;
    case 4: err = launch<4>(a64, s, f, fs, iv, is, w, K, L, B, G, per_row, st); break;
    default: err = launch<5>(a64, s, f, fs, iv, is, w, K, L, B, G, per_row, st); break;
  }
  return int(err);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
