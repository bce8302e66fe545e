// One CMUX step split over the bootstrap key's gadget rows, for NVIDIA
// Hopper (sm_90a): the two kernels of the gadget-row (tensor-parallel)
// sharded blind rotation of `parallel/mesh.py`.
//
// Replaces the TPU kernels `partial_step_tiles` (the TPU package's
// ops/pbs_kernel.py:1536, body `_make_partial_step_kernel` :1477) and
// `finish_step_tiles` (ops/pbs_kernel.py:1651, body
// `_make_finish_step_kernel` :1595).  Together, per ciphertext, they compute
// K1's step (blind_rotate.cu)
//
//   acc += BK_i (x) ((X^{a_i} - 1) * acc)
//
// with the key's J = (k+1) l rows cut into m shards of J/m rows:
//
//   K8a  partial_step: rot = X^a acc - acc; for the global rows j in
//        [j0, j0 + j_local): digit row j (component j / l, digit j % l of
//        the WHOLE decomposition), forward NTT, Shoup multiply-accumulate
//        against the shard's key rows.  Writes the exact (canonical, < p)
//        NTT-domain partial [C][P][N] of the ciphertext.
//   K8b  finish_step: reduces the m partials of every shard to their sum
//        mod p (add_mod, canonical after each add, so exact for any m: the
//        TPU's u32 psum needed m p < 2^32, this needs nothing), inverse
//        NTTs of the C*P spectra, Garner to u64, and acc += delta in place
//        (the TPU kernel aliases acc to its output).
//
// The cross-shard sum is therefore a gather, not an add: the caller puts
// the m partials side by side ([m, B, C, P, N], each shard's K8a writing its
// own slot; a shard on another card is copied in), and K8b reduces them.
// K8a is K1's steps 1-3 and K8b its steps 4-6, built from the same
// ntt_common.cuh helpers, so a split step gives K1's words.
//
// At the 32-bit torus (TORUS32) both run on u32 words (the word type W):
// K8a's rotation, offset (cast to W once) and digits of 32 bits, K8b's
// Garner step and carry-add mod 2^32 (the TPU kernels' `nl == 1` branches,
// pbs_kernel.py:1142-1145 and :1636-1637).  The partials are the same u32
// residues at both widths.
//
// Design.  One thread block per ciphertext, as in K1; nothing carries over
// between steps inside a kernel (the step loop, and the sum between the two
// halves, are the caller's).  K8a keeps rot (C x N u64), the spectra
// (C x P x N u32) and one digit row's NTT buffer (P x N u32) in shared
// memory, 104 KiB at N=2048, k=1, P=3; acc is read from device memory.
// Where they do not all fit (256 KiB at N=4096 with 4 primes) the wrapper
// moves rot, then the spectra, to a global workspace.
// K8b keeps the C*P spectra, 48 KiB, in shared memory; where they do not
// fit (256 KiB at N=8192 with 4 primes) the wrapper places one component's
// P rows (128 KiB there) and K8b runs its steps 4a-6 once per component, a
// compile-time case beside the one-pass body every smaller shape keeps.
// The partial and the sum go through device memory: at TFHEpp-L2, batch
// 512, 25.2 MB per shard and step.
//
// What bounds them on this card.  K8a: integer multiplies, as K1 (at m = 2
// per ciphertext 12 NTTs x 11,264 butterflies + 49,152 key products, each
// a Shoup product of three 32-bit multiplies), with its bytes (acc in,
// partial out, the shard's key rows) below that.  K8b: bytes (m partials
// and acc in, acc out) above its 6 inverse NTTs and Garner.  This first
// version does not fuse the m shards' partials of one card into one launch
// and synchronises the whole block at each NTT stage, as K1 does.

#include "ntt_common.cuh"

namespace {

constexpr int kThreads = 1024;
enum { kWork, kSpec, kRot, kNumBuf };  // K8a's buffers, as the wrapper lists
// K8b's: component 0's P spectra rows, then the other components' rows,
// placed right after them when they fit (one pass), else left out
enum { kRows0, kRowsRest, kNumFinishBuf };

template <int P, typename W, bool S>
__global__ void __launch_bounds__(kThreads, 1)
partial_step_kernel(const W* __restrict__ acc_g,
                    const int32_t* __restrict__ a_g,
                    const uint32_t* __restrict__ keyv,
                    const uint32_t* __restrict__ keyvs,
                    const uint32_t* __restrict__ ftw,
                    const uint32_t* __restrict__ ftws,
                    uint32_t* __restrict__ out_g, unsigned char* ws,
                    const PbsConsts Kp, const Layout L, int j0, int j_local) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  const int N = K.N, C = K.C, l = K.l, CN = K.C * K.N;
  const W offset = W(K.offset);
  W* rot = buffer<S, W>(L, kRot, smem, ws, nullptr);              // [C][N]
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);  // [C][P][N]
  auto* work = buffer<S, uint32_t>(L, kWork, smem, ws, nullptr);  // [P][N]

  const W* acc_b = acc_g + size_t(blockIdx.x) * CN;
  const int a = a_g[blockIdx.x];  // in [0, 2N]
  // 1. rot + offset, with rot = X^a acc - acc
  for (int idx = threadIdx.x; idx < CN; idx += blockDim.x) {
    const int c = idx >> K.logN, k = idx & (N - 1);
    rot[idx] = rotated_word<W>(acc_b + c * N, k, a, N) - acc_b[idx] + offset;
  }
  for (int idx = threadIdx.x; idx < C * P * N; idx += blockDim.x) spec[idx] = 0;
  __syncthreads();

  for (int jj = 0; jj < j_local; ++jj) {
    // 2. global digit row j = (component c_j, digit d), residues mod each p
    const int j = j0 + jj, cj = j / l, d = j % l;
    for (int k = threadIdx.x; k < N; k += blockDim.x) {
      const int digit = gadget_digit<W>(rot[cj * N + k], d, K);
#pragma unroll
      for (int pi = 0; pi < P; ++pi)
        work[pi * N + k] = small_residue(digit, K.p[pi]);
    }
    __syncthreads();
    // 3. forward NTTs, then spec[c][p] += NTT(digit row) * key row jj
    forward_ntt<P>(work, P, K, ftw, ftws);
    for (int idx = threadIdx.x; idx < P * N; idx += blockDim.x) {
      const int pi = idx >> K.logN, k = idx & (N - 1);
      const uint32_t p = K.p[pi], x = work[idx];
      for (int c = 0; c < C; ++c) {
        const size_t ko = (size_t(jj * C + c) * P + pi) * N + k;
        uint32_t* sp = spec + (c * P + pi) * N + k;
        *sp = add_mod(*sp, shoup(x, keyv[ko], keyvs[ko], p), p);
      }
    }
    __syncthreads();
  }
  uint32_t* out_b = out_g + size_t(blockIdx.x) * C * P * N;
  for (int idx = threadIdx.x; idx < C * P * N; idx += blockDim.x)
    out_b[idx] = spec[idx];
}

// OnePass: all C*P spectra rows in shared memory, steps 4a-6 once (every
// shape up to N=4096 with 4 primes); else once per component, on P rows.
template <int P, typename W, bool OnePass>
__global__ void __launch_bounds__(kThreads, 1)
finish_step_kernel(W* __restrict__ acc_g,
                   const uint32_t* __restrict__ parts_g,
                   const uint32_t* __restrict__ itw,
                   const uint32_t* __restrict__ itws, const PbsConsts Kp,
                   int m, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  const int N = K.N, C = K.C, CN = K.C * K.N, PN = P * K.N, CPN = C * PN;
  const int cpp = OnePass ? C : 1;     // components per pass
  const int passes = OnePass ? 1 : C;  // a compile-time 1: the old body
  uint32_t* spec = reinterpret_cast<uint32_t*>(smem);  // [cpp][P][N]
  const size_t part_stride = size_t(B) * CPN;
  const uint32_t* parts_b = parts_g + size_t(blockIdx.x) * CPN;
  W* acc_b = acc_g + size_t(blockIdx.x) * CN;

  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = pass * cpp;
    // 4a. the sum of the m partials mod p, canonical after every add
    const uint32_t* pc = parts_b + size_t(c0) * PN;
    for (int idx = threadIdx.x; idx < cpp * PN; idx += blockDim.x) {
      const uint32_t p = K.p[(idx >> K.logN) % P];
      uint32_t s = pc[idx];
      for (int j = 1; j < m; ++j) s = add_mod(s, pc[j * part_stride + idx], p);
      spec[idx] = s;
    }
    __syncthreads();
    // 4b. inverse NTTs of the pass's spectra
    inverse_ntt<P>(spec, cpp * P, K, itw, itws);
    // 5-6. Garner (with 1/N) and the carry-add into acc
    for (int idx = threadIdx.x; idx < cpp * N; idx += blockDim.x) {
      const int c = idx >> K.logN, k = idx & (N - 1);
      acc_b[c0 * N + idx] += garner<P, W>(spec + c * PN, k, K);
    }
    if (!OnePass) __syncthreads();  // the next pass rewrites spec
  }
}

struct PartialArgs {
  const void* acc;
  const int32_t* a;
  const uint32_t *keyv, *keyvs, *ftw, *ftws;
  uint32_t* out;
  unsigned char* ws;
  int B, j0, j_local;
  cudaStream_t stream;
};

template <int P, typename W, bool S>
cudaError_t launch_partial_s(const PartialArgs& x, const PbsConsts& K,
                             const Layout& L) {
  cudaError_t err = cudaFuncSetAttribute(
      partial_step_kernel<P, W, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.smem));
  if (err != cudaSuccess) return err;
  partial_step_kernel<P, W, S><<<x.B, kThreads, L.smem, x.stream>>>(
      static_cast<const W*>(x.acc), x.a, x.keyv, x.keyvs, x.ftw, x.ftws,
      x.out, x.ws, K, L, x.j0, x.j_local);
  return cudaGetLastError();
}

struct FinishArgs {
  void* acc;
  const uint32_t *parts, *itw, *itws;
  int B, m;
  cudaStream_t stream;
};

template <int P, typename W, bool OnePass>
cudaError_t launch_finish(const FinishArgs& x, const PbsConsts& K,
                          const Layout& L) {
  cudaError_t err = cudaFuncSetAttribute(
      finish_step_kernel<P, W, OnePass>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.smem));
  if (err != cudaSuccess) return err;
  finish_step_kernel<P, W, OnePass><<<x.B, kThreads, L.smem, x.stream>>>(
      static_cast<W*>(x.acc), x.parts, x.itw, x.itws, K, x.m, x.B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh), whose
// gadget offset is of the word width; layout: the buffer placement (smem
// bytes, workspace stride, offsets of work, spec, rot); ws: the workspace,
// B x stride bytes (null when the stride is 0).  acc [B, k+1, N] (read), u64
// words (word_bits 64) or u32 words (word_bits 32); a [B] int32 in [0, 2N];
// keyv/keyvs [j_local, k+1, P, N] u32, global key rows [j0, j0 + j_local);
// out [B, k+1, P, N] u32 canonical residues.
int partial_step_launch(const void* acc, const void* a, const void* keyv,
                        const void* keyvs, const void* ftw, const void* ftws,
                        void* out, void* ws, const int64_t* consts,
                        const int64_t* layout, int B, int j0, int j_local,
                        int word_bits, void* stream) {
  PbsConsts K;
  if (!parse_consts(consts, K)) return int(cudaErrorInvalidValue);
  if (j0 < 0 || j_local < 1 || j0 + j_local > K.C * K.l)
    return int(cudaErrorInvalidValue);
  if (B == 0) return int(cudaSuccess);
  const PartialArgs x{acc,
                      static_cast<const int32_t*>(a),
                      static_cast<const uint32_t*>(keyv),
                      static_cast<const uint32_t*>(keyvs),
                      static_cast<const uint32_t*>(ftw),
                      static_cast<const uint32_t*>(ftws),
                      static_cast<uint32_t*>(out),
                      static_cast<unsigned char*>(ws),
                      B,
                      j0,
                      j_local,
                      static_cast<cudaStream_t>(stream)};
  const Layout L = parse_layout(layout, kNumBuf);
  const bool shared = all_shared(L, kNumBuf);
  return int(dispatch_pw(K.P, word_bits, [&](auto p, auto w) {
    using W = decltype(w);
    constexpr int P = decltype(p)::value;
    return shared ? launch_partial_s<P, W, true>(x, K, L)
                  : launch_partial_s<P, W, false>(x, K, L);
  }));
}

// layout: smem bytes, stride (0), the offsets of component 0's rows and of
// the other components' rows (>= 0: right after them, one pass; else one
// pass per component).  acc [B, k+1, N] u64 or u32 words (word_bits),
// updated in place; parts [m, B, k+1, P, N] u32, each partial canonical
// (< p).
int finish_step_launch(void* acc, const void* parts, const void* itw,
                       const void* itws, const int64_t* consts,
                       const int64_t* layout, int B, int m, int word_bits,
                       void* stream) {
  PbsConsts K;
  if (!parse_consts(consts, K)) return int(cudaErrorInvalidValue);
  if (m < 1) return int(cudaErrorInvalidValue);
  if (B == 0) return int(cudaSuccess);
  const FinishArgs x{acc,
                     static_cast<const uint32_t*>(parts),
                     static_cast<const uint32_t*>(itw),
                     static_cast<const uint32_t*>(itws),
                     B,
                     m,
                     static_cast<cudaStream_t>(stream)};
  const Layout L = parse_layout(layout, kNumFinishBuf);
  const bool one_pass = L.off[kRowsRest] >= 0;
  return int(dispatch_pw(K.P, word_bits, [&](auto p, auto w) {
    using W = decltype(w);
    constexpr int P = decltype(p)::value;
    return one_pass ? launch_finish<P, W, true>(x, K, L)
                    : launch_finish<P, W, false>(x, K, L);
  }));
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
