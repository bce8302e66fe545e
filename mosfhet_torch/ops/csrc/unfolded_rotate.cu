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
// ops/pbs_kernel.py:3123, body `_make_unfolded_kernel` :3002).  Per
// ciphertext and group:
//
//   1. per digit row j of the accumulator (J = (k+1) l): signed gadget
//      digits as residues, forward NTTs;
//   2. for each component c of that row: the key row (j, c) combined over
//      the M key products, each rotated by its own exponent, summed mod
//      2^64 in the time domain; reduced to the residues of its centred
//      (signed) representative, as `ntt.to_resi_u64` defines them; forward
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
// 3044-3046 and :3113-3114).
//
// Design: K1's schedule (rotate_sched.cuh).  One block per ciphertext runs
// the G groups as a loop, split into groups of T = N/16 threads, one group
// per prime (NG = min(P, 1024/T) thread groups; where NG < P the primes are
// taken in rounds of NG).  Per digit row j, each thread reads its 16 digits
// from acc and runs the forward passes on them (a 2,048-point row is three
// passes and two exchanges through the group's exchange row, one under a
// named barrier of the group's threads, one inside each warp; lazy
// residues); it then holds its 16 window-0 digit spectra in registers,
// reduced to [0, p), for the C key rows of j.  Per key row (j, c):
//   - the combine, once per block: between two block barriers the block's
//     threads split the N positions k; a thread sums the M rotated words
//     +-SU[g, m, j, c, (k - r_m) mod N] (read through L2) and writes the
//     centred residue of the sum for each thread group's prime into that
//     group's exchange row, at position k's slot of the top window, where
//     the forward passes start.  Every group needs the same positions, so
//     the block reads each word of the key row once, and adds once, where
//     a combine per group would read and add P times.  No buffer is added:
//     the exchange rows are free between two forward transforms;
//   - the thread loads its 16 slots, runs the forward passes and multiplies
//     its 16 key spectra (in [0, 4p)) by its digit spectra (in [0, p), as
//     `mac_product` needs one operand below p) into its own slots of spec,
//     the first row replacing, so nothing is zeroed.
// After the J rows, the inverse NTTs from those slots to natural order, a
// block barrier, Garner replacing acc, and a block barrier: acc is read by
// the next group's digits.  Per group at TFHEpp-L2: 2 J C = 32 block
// barriers for the combines and 2 for Garner.
//
// What bounds it on this card: integer operations.  Per ciphertext and
// group at TFHEpp-L2: 24 digit + 48 key + 6 inverse NTTs x 11,264 Shoup
// butterflies, 98,304 Barrett products, 98,304 centred reductions and
// 32,768 x M u64 rotate-adds.  HBM bytes are far below that: every block
// reads the whole key (663 MB at u=4), but blocks resident together start
// together and walk the groups roughly in step, so each 4 MiB group slice
// is read from HBM about once per wave and shared through the 50 MB L2.
// L2 then moves 4 MiB into each block per group (339 GB per call at u=4,
// B=512), which may set the pace before the multiplies do.
//
// Buffers of a block: the group's M exponents, work [NG][SR] u32 (the
// exchange rows, which carry the combined key rows), spec [C][P][SR] u32
// and acc [C][N] words (SR = N + N/16 from N = 256): 108.6 KiB at
// TFHEpp-L2 with u=4 (two blocks of 384 threads per SM, as K1) and 67 KiB
// at its 32-bit form (three of 256).  Where they do not all fit, the
// wrapper places them by traffic: work in shared memory, then the
// exponents, spec and acc; spec in a global workspace, acc updated in place
// in the caller's tensor (SET_3: acc in place).  Exponents may be 0 or 2N
// (the identity).  N from 16 to 16384.

#include "rotate_sched.cuh"

namespace {

// buffers, as the wrapper lists them
enum { kRots, kWork, kSpec, kAcc, kNumBuf };

// K4: the G groups, one block per ciphertext.  LogN != 0: the compile-time
// shape of K1's 80-register instances (N = 2^LogN, k = 1, P at most 3, all
// in shared memory).
template <int P, typename W, bool S, int LogN>
__global__ void __launch_bounds__(kBlockThreads<LogN>, kMinBlocks<LogN>)
unfolded_rotate_kernel(W* __restrict__ acc_g,
                       const int32_t* __restrict__ rot_g,
                       const W* __restrict__ su,
                       const uint32_t* __restrict__ ftw,
                       const uint32_t* __restrict__ ftws,
                       const uint32_t* __restrict__ itw,
                       const uint32_t* __restrict__ itws, unsigned char* ws,
                       const PbsConsts Kp, const Layout L, int G, int M) {
  constexpr bool Fixed = LogN != 0;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  Sched s;  // compile-time where LogN is
  make_sched(LogN ? LogN : K.logN, P, s);
  const int N = 1 << s.logN, C = Fixed ? 2 : K.C, l = K.l, J = C * l;
  const int CN = C * N, threads = s.NG * s.T;
  const int g = threadIdx.x >> s.logT, t = threadIdx.x & (s.T - 1);
  const W offset = W(K.offset);
  W* acc_b = acc_g + size_t(blockIdx.x) * CN;
  W* acc = buffer<S, W>(L, kAcc, smem, ws, acc_b);                // [C][N]
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);  // [C][P][SR]
  auto* work = buffer<S, uint32_t>(L, kWork, smem, ws, nullptr);  // [NG][SR]
  auto* rots = buffer<S, int32_t>(L, kRots, smem, ws, nullptr);   // [M]
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += threads) acc[i] = acc_b[i];
  __syncthreads();

  uint32_t* buf = work + g * s.SR;
  const int slot0 = slots(s, t, 0).first;             // window 0: slot0 + v
  const Slots top = slots(s, t, window(s, s.np - 1));  // where passes start
  const int rounds = (P + s.NG - 1) / s.NG;
  const size_t m_stride = size_t(J) * C * N;  // su [G][M][J][C][N]
  uint32_t xd[kR], xk[kR];
  for (int gi = 0; gi < G; ++gi) {
    const int32_t* rot_bg = rot_g + (size_t(blockIdx.x) * G + gi) * M;
    for (int m = threadIdx.x; m < M; m += threads) rots[m] = rot_bg[m];
    const W* su_g = su + size_t(gi) * M * m_stride;
    for (int r = 0; r < rounds; ++r) {
      // this thread group's prime in round r (none past P)
      const int pi = g + r * s.NG;
      const bool live = pi < P;
      const int pr = live ? pi : 0;
      const uint32_t p = K.p[pr], p2 = 2 * p, mup = K.mup[pr];
      const uint32_t *fw = ftw + pr * N, *fws = ftws + pr * N;
      for (int j = 0; j < J; ++j) {
        // 1. digit row j = (component cj, digit d), forward passes, the
        //    spectra reduced to [0, p) and kept for the C key rows
        const int cj = j / l, d = j % l;
        if (live) {
#pragma unroll
          for (int v = 0; v < kR; ++v) {
            const W w = acc[cj * N + (t | (v << s.logT))] + offset;
            xd[v] = small_residue(gadget_digit(w, d, K), p);
          }
          forward_row(xd, buf, s, t, g, fw, fws, p);
#pragma unroll
          for (int v = 0; v < kR; ++v) xd[v] = canonical4(xd[v], p);
        }
        for (int c = 0; c < C; ++c) {
          // 2a. the combine of key row (j, c), once per block, into every
          //     thread group's exchange row at the top window's slots
          const W* row = su_g + size_t(j * C + c) * N;
          __syncthreads();
          for (int k = threadIdx.x; k < N; k += threads) {
            W x = 0;
#pragma unroll 4
            for (int m = 0; m < M; ++m) {
              const int e = (k - rots[m]) & (2 * N - 1);
              const W v = __ldg(row + m * m_stride + (e & (N - 1)));
              x += (e & N) ? W(0) - v : v;
            }
            const int slot = s.pad ? k + (k >> kQ) : k;
            for (int h = 0; h < s.NG; ++h)
              if (h + r * s.NG < P)
                work[h * s.SR + slot] = centred_residue(x, h + r * s.NG, K);
          }
          __syncthreads();
          if (!live) continue;
          // 2b. the forward passes of the key row, then the MAC into this
          //     thread's window-0 slots of spec[c][pi]
#pragma unroll
          for (int v = 0; v < kR; ++v) xk[v] = buf[top.first + v * top.stride];
          forward_row(xk, buf, s, t, g, fw, fws, p);
          uint32_t* sp = spec + (c * P + pi) * s.SR + slot0;
#pragma unroll
          for (int v = 0; v < kR; ++v) {
            const uint32_t m = mac_product(xk[v], xd[v], p, mup);
            sp[v] = j == 0 ? m : lazy2(sp[v] + m, p2);
          }
        }
      }
      // 3a. the inverse NTTs from this thread's slots to natural order in
      //     the same rows (every slot is read before the exchanges' group
      //     barrier, every output written after it)
      if (live) {
        const uint32_t *iw = itw + pi * N, *iws = itws + pi * N;
        for (int c = 0; c < C; ++c) {
          uint32_t* srow = spec + (c * P + pi) * s.SR;
#pragma unroll
          for (int v = 0; v < kR; ++v) xk[v] = srow[slot0 + v];
          inverse_row(xk, buf, s, t, g, iw, iws, p);
#pragma unroll
          for (int v = 0; v < kR; ++v) srow[t | (v << s.logT)] = xk[v];
        }
      }
    }
    // 3b. Garner (with 1/N) replacing acc, between two block barriers
    replace_acc<P, P, W>(acc, spec, N, CN, threads, K, s);
  }
  if (acc != acc_b)
    for (int i = threadIdx.x; i < CN; i += threads) acc_b[i] = acc[i];
}

struct Args {
  void* acc;
  const int32_t* rot;
  const void* su;
  const uint32_t *ftw, *ftws, *itw, *itws;
  unsigned char* ws;
  int B, G, M;
  cudaStream_t stream;
  int* blocks_per_sm;  // non-null: report the residency, launch nothing
};

template <int P, typename W, bool S, int LogN>
cudaError_t launch(const Args& x, const PbsConsts& K, const Layout& L,
                   const Sched& s) {
  return launch_sched(unfolded_rotate_kernel<P, W, S, LogN>, s, L, x.B,
                      x.stream, x.blocks_per_sm, static_cast<W*>(x.acc), x.rot,
                      static_cast<const W*>(x.su), x.ftw, x.ftws, x.itw,
                      x.itws, x.ws, K, L, x.G, x.M);
}

template <int P, typename W>
cudaError_t launch_s(const Args& x, const PbsConsts& K, const Layout& L,
                     const Sched& s) {
  if (!all_shared(L, kNumBuf)) return launch<P, W, false, 0>(x, K, L, s);
  return with_log_n<P>(K, [&](auto n) {
    return launch<P, W, true, decltype(n)::value>(x, K, L, s);
  });
}

int launch_entry(const Args& x, const int64_t* consts, const int64_t* layout,
                 int word_bits) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || !make_sched(K.logN, K.P, s) || x.M < 1)
    return int(cudaErrorInvalidValue);
  if ((x.B == 0 || x.G == 0) && !x.blocks_per_sm) return int(cudaSuccess);
  const Layout L = parse_layout(layout, kNumBuf);
  return int(dispatch_pw(K.P, word_bits, [&](auto p, auto w) {
    return launch_s<decltype(p)::value, decltype(w)>(x, K, L, s);
  }));
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh), whose
// gadget offset is of the word width; layout: the buffer placement (smem
// bytes, workspace stride, offsets of rots, work, spec, acc); ws: the
// workspace, B x stride bytes (null when the stride is 0).  acc [B, k+1, N]
// is rotated in place; rot [B, G, M] int32 in [0, 2N]; su [G, M, (k+1)l,
// k+1, N] key products; acc and su hold u64 words (word_bits 64) or u32
// words (word_bits 32); twiddles [P, N] u32.
int unfolded_rotate_launch(void* acc, const void* rot, const void* su,
                           const void* ftw, const void* ftws, const void* itw,
                           const void* itws, void* ws, const int64_t* consts,
                           const int64_t* layout, int B, int G, int M,
                           int word_bits, void* stream) {
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
               static_cast<cudaStream_t>(stream),
               nullptr};
  return launch_entry(x, consts, layout, word_bits);
}

// The blocks of K4 resident on one SM at the plan's shape, the placement
// (for 2^u = M exponents) and the word width
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device),
// and the threads of a block.
int unfolded_rotate_residency(const int64_t* consts, const int64_t* layout,
                              int word_bits, int* blocks, int* threads) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || !make_sched(K.logN, K.P, s))
    return int(cudaErrorInvalidValue);
  *threads = s.NG * s.T;
  const Args x{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, 0,       1,       1,       nullptr,
               blocks};
  return launch_entry(x, consts, layout, word_bits);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
