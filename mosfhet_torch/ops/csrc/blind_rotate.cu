// The whole blind rotation (n CMUX steps) of a batch of TRLWE accumulators
// in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `blind_rotate_scan_fused` (the TPU package's
// ops/pbs_kernel.py:1404, step body `_step_body` :1186).  Per ciphertext and
// per step i it computes, exactly mod 2^64,
//
//   acc += BK_i (x) ((X^{a_i} - 1) * acc)
//
//   1. rot = X^{a_i} * acc - acc, a negacyclic rotation of u64 words, read
//      straight from acc wherever a digit needs it (no rotation buffer);
//   2. signed gadget digits of rot + offset, l per component (J = (k+1) l);
//   3. per digit row and prime: forward negacyclic NTT (Longa-Naehrig,
//      bit-reversed output: the bootstrap key is stored in that order) and
//      a multiply-accumulate against BK_i[j][c][p] into spec[c][p];
//   4. inverse NTTs of the C*P spectra (1/N folded into the next step);
//   5. Garner CRT to the exact value mod 2^64 with a centred top digit;
//   6. acc += delta.
//
// At the 32-bit torus (TORUS32) the same body runs on u32 words: one limb
// per word, the gadget offset and digits of 32 bits and Garner's Horner step
// mod 2^32 (the TPU kernel's `nl == 1` branches, pbs_kernel.py:1142-1145 and
// :1213-1214).  The NTT side is the same at both widths.
//
// What bounds it on this card: integer operations.  Per step and ciphertext
// at TFHEpp-L2 it does (24 + 6) NTTs x 11,264 butterflies + 98,304 key
// products + 4,096 Garner reconstructions, each one Shoup product of three
// 32-bit multiplies, against 64 INT32 lanes per SM.  Every block reads the
// step's key from the 50 MB L2: the MAC takes Barrett products of the key's
// residues alone (`mac_product`), 393 KiB per step at TFHEpp-L2, and never
// reads their Shoup companions, which would double that traffic.
//
// Design.  A blind rotate is one call, so it is one launch: one block per
// ciphertext runs the n steps as a loop (the TPU's sequential grid axis).
// The block is split into groups of T = N/16 threads, one group per prime
// (NG = min(P, 1024/T) groups; a group takes primes g, g + NG, ...).  A
// thread owns 16 coefficients of its group's row in registers and runs up
// to four radix-2 stages on them between exchanges (`Sched`): a 2,048-point
// row takes three passes and two exchanges through the group's slice of
// `work`, one synchronised by a named barrier of the group's threads
// (`bar.sync 1+g, T`), the other inside each warp (`__syncwarp`).  After the
// forward NTT a thread holds 16 consecutive bit-reversed positions; it
// multiplies them by the key (16-byte loads) and accumulates into its own
// slots of spec, so a group needs no barrier for the MAC and the groups
// none between them until Garner.  The inverse NTT starts from those same
// slots (bit-reversed input) and ends in natural order, which Garner reads
// across the primes after one block barrier: two block barriers per step.
//
// Residues are lazy (Harvey butterflies): the forward NTT keeps them in
// [0, 4p), the MAC and the inverse NTT in [0, 2p) (p < 2^30, so no sum
// passes 2^32); Garner's first Shoup product ends canonical, so the words
// are those of the plain PyTorch version.  Twiddles come from the plan's
// tables in 1-8 word vector loads: a pass's first stages read one shared
// word per warp, its last ones 8 consecutive words per thread.
//
// Buffers of a block: acc [C][N] words, spec [C][P][SR] u32 and work
// [NG][SR] u32, SR = N + N/16 from N = 256 (one pad word per 16 keeps the
// exchanges and the MAC's slots free of bank conflicts; SR = N below):
// 108.5 KiB at TFHEpp-L2 (N=2048, k=1, P=3; two blocks per SM) and 67 KiB
// at its 32-bit form (P=2; three per SM).  Where they do not all fit, the
// wrapper places them by traffic: work always in shared memory, then spec,
// then acc; spec in a global workspace, acc updated in place in the
// caller's tensor (SET_3: acc in place; N=8192: spec in the workspace).
// N from 16 to 16384.
//
// K1-step (`pbs_step_kernel`, entry `pbs_step_launch`) is the same step body
// run once per launch: the TPU kernel `_pbs_step_tiles` (pbs_kernel.py:1253,
// the per-step `blind_rotate_scan` at :1335).  acc comes from and goes back
// to the caller's tensor, updated in place as the TPU kernel aliases it
// (`input_output_aliases={0: 0}`).  In place is safe: the forward phase
// only reads acc, and acc is written only after the block barrier that
// ends every group's inverse NTTs.

#include "rotate_sched.cuh"

namespace {

enum { kWork, kSpec, kAcc, kNumBuf };  // buffers, as the wrapper lists

// One CMUX step of one ciphertext (steps 1-6 above): acc [C][N] words,
// spec [C][P][SR] and work [NG][SR] u32 wherever they were placed; kv the
// step's key rows [J][C][P][N].  Fixed: the shape of the 80-register
// instances (N = 2^LogN, C = 2; see kBlockThreads), whose MAC has both
// components' key words in flight; else one component's at a time.
// Starts after a block barrier and ends with one.
template <int P, typename W, bool Fixed>
__device__ __forceinline__ void cmux_step(
    W* acc, uint32_t* spec, uint32_t* work, int a,
    const uint32_t* __restrict__ kv, const uint32_t* __restrict__ ftw,
    const uint32_t* __restrict__ ftws, const uint32_t* __restrict__ itw,
    const uint32_t* __restrict__ itws, const PbsConsts& K, const Sched& s) {
  constexpr int H = Fixed ? 2 : 1;
  const int N = 1 << s.logN, C = Fixed ? 2 : K.C, l = K.l, J = C * l;
  const int g = threadIdx.x >> s.logT, t = threadIdx.x & (s.T - 1);
  const W offset = W(K.offset);
  uint32_t* buf = work + g * s.SR;
  const int slot0 = slots(s, t, 0).first;  // window 0: slot0 + v
  uint32_t x[kR];
  for (int pi = g; pi < P; pi += s.NG) {
    const uint32_t p = K.p[pi], p2 = 2 * p, mup = K.mup[pi];
    const uint32_t *fw = ftw + pi * N, *fws = ftws + pi * N;
    // 2-3. digit rows through the forward NTT, then the MAC into this
    //      thread's window-0 slots of spec[c][pi]
    for (int j = 0; j < J; ++j) {
      const int cj = j / l, d = j % l;
      const W* row = acc + cj * N;
#pragma unroll
      for (int v = 0; v < kR; ++v) {
        const int k = t | (v << s.logT);
        const W word = rotated_word(row, k, a, N) - row[k] + offset;
        x[v] = small_residue(gadget_digit(word, d, K), p);
      }
      forward_row(x, buf, s, t, g, fw, fws, p);
      // H components' key words in flight at once (16 H registers)
      for (int c0 = 0; c0 < C; c0 += H) {
        uint4 kw[H][kR / 4];
#pragma unroll
        for (int u = 0; u < H; ++u) {
          const uint4* kv4 = reinterpret_cast<const uint4*>(
              kv + (size_t(j * C + c0 + u) * P + pi) * N + (t << kQ));
#pragma unroll
          for (int q = 0; q < kR / 4; ++q) kw[u][q] = __ldg(kv4 + q);
        }
#pragma unroll
        for (int u = 0; u < H; ++u) {
          uint32_t* sp = spec + ((c0 + u) * P + pi) * s.SR + slot0;
#pragma unroll
          for (int q = 0; q < kR / 4; ++q) {
            const uint4 k4 = kw[u][q];
            const uint32_t m[4] = {mac_product(x[4 * q], k4.x, p, mup),
                                   mac_product(x[4 * q + 1], k4.y, p, mup),
                                   mac_product(x[4 * q + 2], k4.z, p, mup),
                                   mac_product(x[4 * q + 3], k4.w, p, mup)};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sp[4 * q + e] = j == 0 ? m[e] : lazy2(sp[4 * q + e] + m[e], p2);
          }
        }
      }
    }
    // 4. inverse NTTs of spec[c][pi], from this thread's slots to natural
    //    order in the same row (every slot is read before the exchanges'
    //    group barrier, every output written after it)
    const uint32_t *iw = itw + pi * N, *iws = itws + pi * N;
    for (int c = 0; c < C; ++c) {
      uint32_t* row = spec + (c * P + pi) * s.SR;
#pragma unroll
      for (int v = 0; v < kR; ++v) x[v] = row[slot0 + v];
      inverse_row(x, buf, s, t, g, iw, iws, p);
#pragma unroll
      for (int v = 0; v < kR; ++v) row[t | (v << s.logT)] = x[v];
    }
  }
  __syncthreads();
  // 5-6. Garner (with 1/N) and the carry-add into acc
  for (int idx = threadIdx.x; idx < C * N; idx += blockDim.x) {
    const int c = idx >> s.logN, k = idx & (N - 1);
    acc[idx] += garner_rows<P, W>(spec + c * P * s.SR, s.SR, k, K);
  }
  __syncthreads();
}

// A block's rotation of its ciphertext: n steps with a_g [n][B] exponents
// and keyv [n][J][C][P][N] (K1), or with Step one step with a_g [B] and
// keyv [J][C][P][N] (K1-step).  acc is loaded into its buffer
// and stored back where that is not the caller's tensor itself.
template <int P, typename W, bool S, bool Step, int LogN>
__device__ __forceinline__ void rotate_block(
    W* __restrict__ acc_g, const int32_t* __restrict__ a_g,
    const uint32_t* __restrict__ keyv, const uint32_t* __restrict__ ftw,
    const uint32_t* __restrict__ ftws, const uint32_t* __restrict__ itw,
    const uint32_t* __restrict__ itws, unsigned char* ws,
    const PbsConsts& Kp, const Layout& L, int n, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  // The constants are indexed by a per-group prime index: keep one copy in
  // shared memory, where that costs a broadcast load.
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  Sched s;  // compile-time where LogN is
  make_sched(LogN ? LogN : K.logN, P, s);
  const int N = 1 << s.logN, C = K.C, J = K.C * K.l, CN = C * N;
  W* acc_b = acc_g + size_t(blockIdx.x) * CN;
  W* acc = buffer<S, W>(L, kAcc, smem, ws, acc_b);  // [C][N]
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);  // [C][P][SR]
  auto* work = buffer<S, uint32_t>(L, kWork, smem, ws, nullptr);  // [NG][SR]

  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += blockDim.x) acc[i] = acc_b[i];
  __syncthreads();

  if (Step) {
    cmux_step<P, W, LogN != 0>(acc, spec, work, a_g[blockIdx.x], keyv, ftw,
                               ftws, itw, itws, K, s);
  } else {
    const size_t step_stride = size_t(J) * C * P * N;
    for (int i = 0; i < n; ++i)  // a in [0, 2N]
      cmux_step<P, W, LogN != 0>(acc, spec, work,
                                 a_g[size_t(i) * B + blockIdx.x],
                                 keyv + i * step_stride, ftw, ftws, itw, itws,
                                 K, s);
  }
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += blockDim.x) acc_b[i] = acc[i];
}


// K1: the whole rotation, one block per ciphertext.
template <int P, typename W, bool S, int LogN>
__global__ void __launch_bounds__(kBlockThreads<LogN>, kMinBlocks<LogN>)
blind_rotate_kernel(W* __restrict__ acc_g, const int32_t* __restrict__ a_g,
                    const uint32_t* __restrict__ keyv,
                    const uint32_t* __restrict__ ftw,
                    const uint32_t* __restrict__ ftws,
                    const uint32_t* __restrict__ itw,
                    const uint32_t* __restrict__ itws, unsigned char* ws,
                    const PbsConsts Kp, const Layout L, int n, int B) {
  rotate_block<P, W, S, false, LogN>(acc_g, a_g, keyv, ftw, ftws, itw, itws,
                                     ws, Kp, L, n, B);
}

// K1-step: one step per launch, one block per ciphertext.
template <int P, typename W, bool S, int LogN>
__global__ void __launch_bounds__(kBlockThreads<LogN>, kMinBlocks<LogN>)
pbs_step_kernel(W* __restrict__ acc_g, const int32_t* __restrict__ a_g,
                const uint32_t* __restrict__ keyv,
                const uint32_t* __restrict__ ftw,
                const uint32_t* __restrict__ ftws,
                const uint32_t* __restrict__ itw,
                const uint32_t* __restrict__ itws, unsigned char* ws,
                const PbsConsts Kp, const Layout L, int n, int B) {
  rotate_block<P, W, S, true, LogN>(acc_g, a_g, keyv, ftw, ftws, itw, itws,
                                    ws, Kp, L, 1, B);
}

struct Args {
  void* acc;
  const int32_t* a;
  const uint32_t *keyv, *ftw, *ftws, *itw, *itws;
  unsigned char* ws;
  int n, B;
  cudaStream_t stream;
  int* blocks_per_sm;  // non-null: report the residency, launch nothing
};

template <int P, typename W, bool S, bool Step, int LogN>
cudaError_t launch(const Args& x, const PbsConsts& K, const Layout& L) {
  auto* kernel = Step ? pbs_step_kernel<P, W, S, LogN>
                      : blind_rotate_kernel<P, W, S, LogN>;
  Sched s;
  if (!make_sched(K.logN, P, s)) return cudaErrorInvalidValue;
  const int threads = s.NG * s.T;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.smem));
  if (err != cudaSuccess) return err;
  if (x.blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        x.blocks_per_sm, kernel, threads, size_t(L.smem));
  kernel<<<x.B, threads, L.smem, x.stream>>>(
      static_cast<W*>(x.acc), x.a, x.keyv, x.ftw, x.ftws, x.itw, x.itws, x.ws,
      K, L, x.n, x.B);
  return cudaGetLastError();
}

template <int P, typename W, bool Step>
cudaError_t launch_s(const Args& x, const PbsConsts& K, const Layout& L) {
  if (!all_shared(L, kNumBuf)) return launch<P, W, false, Step, 0>(x, K, L);
  if constexpr (P <= 3)
    if (K.logN == kFixedLogN && K.C == 2)
      return launch<P, W, true, Step, kFixedLogN>(x, K, L);
  return launch<P, W, true, Step, 0>(x, K, L);
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
int launch_entry(void* acc, const void* a, const void* keyv, const void* ftw,
                 const void* ftws, const void* itw, const void* itws, void* ws,
                 const int64_t* consts, const int64_t* layout, int B, int n,
                 int word_bits, void* stream, int* blocks_per_sm = nullptr) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || !make_sched(K.logN, K.P, s) ||
      (word_bits != 32 && word_bits != 64))
    return int(cudaErrorInvalidValue);
  if (B == 0 && !blocks_per_sm) return int(cudaSuccess);
  const Args x{acc,
               static_cast<const int32_t*>(a),
               static_cast<const uint32_t*>(keyv),
               static_cast<const uint32_t*>(ftw),
               static_cast<const uint32_t*>(ftws),
               static_cast<const uint32_t*>(itw),
               static_cast<const uint32_t*>(itws),
               static_cast<unsigned char*>(ws),
               n,
               B,
               static_cast<cudaStream_t>(stream),
               blocks_per_sm};
  const Layout L = parse_layout(layout, kNumBuf);
  return int(word_bits == 32 ? launch_w<uint32_t, Step>(x, K, L)
                             : launch_w<uint64_t, Step>(x, K, L));
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh), whose
// gadget offset is of the word width; layout: the buffer placement (smem
// bytes, workspace stride, then the offsets of work, spec, acc); ws: the
// workspace, B x stride bytes (null when the stride is 0).  acc [B, k+1, N]
// u64 words (word_bits 64) or u32 words (word_bits 32) is rotated in place;
// a [n, B] int32 in [0, 2N]; keyv [n, (k+1)l, k+1, P, N] u32 (16-byte
// aligned); keyvs, the key's Shoup companions, is not read (the MAC's
// Barrett products need only the residues); twiddles [P, N] u32.
int blind_rotate_launch(void* acc, const void* a, const void* keyv,
                        const void* keyvs, const void* ftw, const void* ftws,
                        const void* itw, const void* itws, void* ws,
                        const int64_t* consts, const int64_t* layout, int B,
                        int n, int word_bits, void* stream) {
  return launch_entry<false>(acc, a, keyv, ftw, ftws, itw, itws, ws, consts,
                             layout, B, n, word_bits, stream);
}

// K1-step: one CMUX step of acc [B, k+1, N] (updated in place) with the
// step's exponents a [B] int32 in [0, 2N] and key rows keyv [(k+1)l, k+1,
// P, N] u32; the rest as above.
int pbs_step_launch(void* acc, const void* a, const void* keyv,
                    const void* keyvs, const void* ftw, const void* ftws,
                    const void* itw, const void* itws, void* ws,
                    const int64_t* consts, const int64_t* layout, int B,
                    int word_bits, void* stream) {
  return launch_entry<true>(acc, a, keyv, ftw, ftws, itw, itws, ws, consts,
                            layout, B, 1, word_bits, stream);
}

// The blocks of K1 (step 0) or K1-step (step 1) resident on one SM at the
// plan's shape, placement and word width (cudaOccupancyMaxActiveBlocks-
// PerMultiprocessor on the current device), and the threads of a block.
int blind_rotate_residency(const int64_t* consts, const int64_t* layout,
                           int word_bits, int step, int* blocks,
                           int* threads) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || !make_sched(K.logN, K.P, s))
    return int(cudaErrorInvalidValue);
  *threads = s.NG * s.T;
  return step ? launch_entry<true>(nullptr, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, nullptr, consts,
                                   layout, 0, 1, word_bits, nullptr, blocks)
              : launch_entry<false>(nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, nullptr, consts,
                                    layout, 0, 1, word_bits, nullptr, blocks);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
