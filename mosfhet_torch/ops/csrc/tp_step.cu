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
//   K8a  partial_step: for the global rows j in [j0, j0 + j_local): digit
//        row j (component j / l, digit j % l of the WHOLE decomposition) of
//        X^a acc - acc, forward NTT, multiply-accumulate against the shard's
//        key rows.  Writes the exact (canonical, < p) NTT-domain partial
//        [C][P][N] of the ciphertext.
//   K8b  finish_step: reduces the m partials of every shard to their sum
//        mod p (canonical after each add, so exact for any m: the TPU's
//        u32 psum needed m p < 2^32, this needs nothing), inverse NTTs of
//        the C*P spectra, Garner to exact words, and acc += delta in place
//        (the TPU kernel aliases acc to its output).
//
// The cross-shard sum is therefore a gather, not an add: the caller puts
// the m partials side by side ([m, B, C, P, N], each shard's K8a writing its
// own slot; a shard on another card is copied in), and K8b reduces them.
// K8a is K1's steps 1-3 and K8b its steps 4-6, on K1's block schedule
// (rotate_sched.cuh), so a split step gives K1's words.
//
// The rotation-free step (the TPU package's MOSFHET_ROT_NTT form of K8a,
// `_make_partial_step_kernel` with `kp.rot_ntt`, pbs_kernel.py:1498-1526 and
// :1574) takes K8a's digits from acc itself, with no rotation, and
// multiplies the partial by zeta^a - 1 before it is written (template flag
// Rot, `apply_rot_twiddle` in rotate_sched.cuh): the factor is a scalar per
// (row, position), so it commutes with K8b's cross-shard sum, and K8b is
// the same for both steps.
//
// At the 32-bit torus (TORUS32) both run on u32 words (the word type W):
// K8a's rotation, offset (cast to W once) and digits of 32 bits, K8b's
// Garner step and carry-add mod 2^32 (the TPU kernels' `nl == 1` branches,
// pbs_kernel.py:1142-1145 and :1636-1637).  The partials are the same u32
// residues at both widths.
//
// What bounds them on this card.  K8a: integer operations, as K1 (at m = 2
// per ciphertext 12 NTTs x 11,264 butterflies + 49,152 key products at
// TFHEpp-L2), with its bytes (acc in, partial out, the shard's key rows)
// below that.  K8b: bytes (m partials and acc in, acc out) above its 6
// inverse NTTs and Garner.
//
// Design: K1's schedule.  One block per ciphertext, split into groups of
// T = N/16 threads, one group per prime (NG = min(P, 1024/T) groups; a group
// takes primes g, g + NG, ...).  A thread owns 16 coefficients of its
// group's row and runs up to four radix-2 stages on them between exchanges
// through the group's exchange row (`forward_row`, `inverse_row`: a
// 2,048-point row is three passes and two exchanges, one under a named
// barrier of the group's threads, one inside each warp; lazy residues).
//   K8a reads its digits straight from acc in device memory (read only,
//   through the read-only data path: no rotation buffer, no staging and no
//   barrier).  After the forward NTT a thread holds the bit-reversed
//   positions 16 t .. 16 t + 15; it multiplies them by the key row with
//   Barrett products on the key's residues alone (`mac_product`: the Shoup
//   companions keyvs are checked by the wrapper and never read), key words
//   in 16-byte loads, and accumulates into its own 16 slots per component
//   in shared memory (the first row replaces, so nothing is zeroed).  Its
//   last row done, it reduces the slots to canonical residues and stores
//   them as four 16-byte words per component into the partial, whose
//   layout is the key's.  No thread reads another's slots, so K8a has no
//   block barrier after the constants load.
//   K8b's thread loads its 16 window-0 words of each of the m partials in
//   16-byte loads and sums them mod p, canonical after each add (the
//   plain version's remainder of the sum); its inverse NTT starts from
//   those registers, exactly where K1's starts, and writes natural order
//   into the spectra rows.  One block barrier, then Garner and the
//   carry-add into acc.
//
// Buffers of a block.  K8a: work [NG][SR] u32 exchange rows and spec
// [NG][C][SR] u32 MAC slots (SR = N + N/16 from N = 256: one pad word per
// 16 keeps the exchanges and the slots free of bank conflicts), 76.5 KiB at
// TFHEpp-L2 (N=2048, k=1, P=3) and 51 KiB at its 32-bit form (P=2); a group
// keeps only the prime it is on, so every registered shape fits in shared
// memory (the wrapper would move spec to a global workspace otherwise).
// K8b: work [NG][SR] and the spectra rows [C][P][N] u32, 73.5 KiB at
// TFHEpp-L2; where the C*P rows do not fit (N=8192 with 4 primes: 256 KiB)
// the wrapper places one component's P rows and K8b runs its steps 4-6
// once per component (a block barrier after each Garner); N=16384 with 4
// primes raises before launch.  N from 16 to 16384.

#include "rotate_sched.cuh"

namespace {

enum { kWork, kSpec, kNumBuf };  // K8a's buffers, as the wrapper lists them
// K8b's: the exchange rows, component 0's P spectra rows, then the other
// components' rows, placed right after them when they fit (one pass), else
// left out
enum { kFinWork, kRows0, kRowsRest, kNumFinishBuf };

// K8a, steps 1-3 of K1's step on the global key rows [j0, j0 + j_local):
// acc [B][C][N] words (read), keyv [j_local][C][P][N], out [B][C][P][N].
// LogN: the compile-time row length of the 80-register instances (N = 2048,
// C = 2; see kBlockThreads), whose MAC has both components' key words in
// flight; else 0, read from the plan, one component's at a time.  Rot: the
// rotation-free step, with rpow [P][2N] and rexp [N] (unread otherwise).
template <int P, typename W, bool S, int LogN, bool Rot>
__global__ void __launch_bounds__(kBlockThreads<LogN>, kMinBlocks<LogN>)
partial_step_kernel(const W* __restrict__ acc_g,
                    const int32_t* __restrict__ a_g,
                    const uint32_t* __restrict__ keyv,
                    const uint32_t* __restrict__ ftw,
                    const uint32_t* __restrict__ ftws,
                    const uint32_t* __restrict__ rpow,
                    const uint32_t* __restrict__ rexp,
                    uint32_t* __restrict__ out_g, unsigned char* ws,
                    const PbsConsts Kp, const Layout L, int j0, int j_local) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  constexpr int H = LogN ? 2 : 1;
  Sched s;  // compile-time where LogN is
  make_sched(LogN ? LogN : K.logN, P, s);
  const int N = 1 << s.logN, C = LogN ? 2 : K.C, l = K.l;
  const int g = threadIdx.x >> s.logT, t = threadIdx.x & (s.T - 1);
  const W offset = W(K.offset);
  auto* work = buffer<S, uint32_t>(L, kWork, smem, ws, nullptr);  // [NG][SR]
  // the MAC slots [NG][C][SR]
  auto* spec = buffer<S, uint32_t>(L, kSpec, smem, ws, nullptr);
  uint32_t* buf = work + g * s.SR;
  // this thread's window-0 slots of component c: mine[c * SR + v]
  uint32_t* mine = spec + g * C * s.SR + slots(s, t, 0).first;
  const W* acc_b = acc_g + size_t(blockIdx.x) * C * N;
  uint32_t* out_b = out_g + size_t(blockIdx.x) * C * P * N;
  const int a = a_g[blockIdx.x];  // in [0, 2N]
  uint32_t x[kR];
  for (int pi = g; pi < P; pi += s.NG) {
    const uint32_t p = K.p[pi], p2 = 2 * p, mup = K.mup[pi];
    const uint32_t *fw = ftw + pi * N, *fws = ftws + pi * N;
    for (int jj = 0; jj < j_local; ++jj) {
      // 1-2. digit d of component cj of X^a acc - acc + offset (of acc +
      //      offset in the rotation-free step), at the top window's
      //      positions
      const int j = j0 + jj, cj = j / l, d = j % l;
      const W* row = acc_b + cj * N;
#pragma unroll
      for (int v = 0; v < kR; ++v) {
        const int k = t | (v << s.logT);
        W word;
        if constexpr (Rot)
          word = row[k] + offset;
        else
          word = rotated_word(row, k, a, N) - row[k] + offset;
        x[v] = small_residue(gadget_digit(word, d, K), p);
      }
      // 3. forward NTT, then the MAC into this thread's slots
      forward_row(x, buf, s, t, g, fw, fws, p);
      for (int c0 = 0; c0 < C; c0 += H) {
        uint4 kw[H][kR / 4];
#pragma unroll
        for (int u = 0; u < H; ++u) {
          const uint4* kv4 = reinterpret_cast<const uint4*>(
              keyv + (size_t(jj * C + c0 + u) * P + pi) * N + (t << kQ));
#pragma unroll
          for (int q = 0; q < kR / 4; ++q) kw[u][q] = __ldg(kv4 + q);
        }
#pragma unroll
        for (int u = 0; u < H; ++u) {
          uint32_t* sp = mine + (c0 + u) * s.SR;
#pragma unroll
          for (int q = 0; q < kR / 4; ++q) {
            const uint4 k4 = kw[u][q];
            const uint32_t m[4] = {mac_product(x[4 * q], k4.x, p, mup),
                                   mac_product(x[4 * q + 1], k4.y, p, mup),
                                   mac_product(x[4 * q + 2], k4.z, p, mup),
                                   mac_product(x[4 * q + 3], k4.w, p, mup)};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sp[4 * q + e] = jj == 0 ? m[e] : lazy2(sp[4 * q + e] + m[e], p2);
          }
        }
      }
    }
    // the rotation-free step's factor zeta^a - 1 on the slots
    if constexpr (Rot)
      apply_rot_twiddle(mine, s.SR, C, a, N, t, rpow + size_t(pi) * 2 * N,
                        rexp, p, mup);
    // the slots, [0, 2p) -> canonical, as 16 consecutive words per component
    for (int c = 0; c < C; ++c) {
      const uint32_t* sp = mine + c * s.SR;
      uint4* o =
          reinterpret_cast<uint4*>(out_b + (c * P + pi) * N + (t << kQ));
#pragma unroll
      for (int q = 0; q < kR / 4; ++q)
        o[q] = make_uint4(min(sp[4 * q], sp[4 * q] - p),
                          min(sp[4 * q + 1], sp[4 * q + 1] - p),
                          min(sp[4 * q + 2], sp[4 * q + 2] - p),
                          min(sp[4 * q + 3], sp[4 * q + 3] - p));
    }
  }
}

// K8b, steps 4-6 of K1's step: acc [B][C][N] words (updated in place) +=
// Garner(INTT(sum of the m partials parts [m][B][C][P][N] mod p)).
// OnePass: all C*P spectra rows in shared memory, steps 4-6 once; else once
// per component, on P rows.  LogN as in K8a.
template <int P, typename W, bool OnePass, int LogN>
__global__ void __launch_bounds__(kBlockThreads<LogN>, kMinBlocks<LogN>)
finish_step_kernel(W* __restrict__ acc_g,
                   const uint32_t* __restrict__ parts_g,
                   const uint32_t* __restrict__ itw,
                   const uint32_t* __restrict__ itws, const PbsConsts Kp,
                   const Layout L, int m, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  if (threadIdx.x == 0) K = Kp;
  __syncthreads();
  Sched s;
  make_sched(LogN ? LogN : K.logN, P, s);
  const int N = 1 << s.logN, C = LogN ? 2 : K.C, PN = P * N;
  const int g = threadIdx.x >> s.logT, t = threadIdx.x & (s.T - 1);
  const int cpp = OnePass ? C : 1;     // components per pass
  const int passes = OnePass ? 1 : C;
  uint32_t* buf =
      reinterpret_cast<uint32_t*>(smem + L.off[kFinWork]) + g * s.SR;
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem + L.off[kRows0]);
  const size_t part_stride = size_t(B) * C * PN;
  const uint32_t* parts_b = parts_g + size_t(blockIdx.x) * C * PN + (t << kQ);
  W* acc_b = acc_g + size_t(blockIdx.x) * C * N;
  uint32_t x[kR];
  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = pass * cpp;
    for (int pi = g; pi < P; pi += s.NG) {
      const uint32_t p = K.p[pi];
      const uint32_t *iw = itw + pi * N, *iws = itws + pi * N;
      for (int cc = 0; cc < cpp; ++cc) {
        // 4a. this thread's 16 window-0 words of the m partials, summed mod
        //     p, canonical after every add
        const uint32_t* src = parts_b + ((c0 + cc) * P + pi) * N;
        for (int sh = 0; sh < m; ++sh) {
          const uint4* s4 =
              reinterpret_cast<const uint4*>(src + sh * part_stride);
#pragma unroll
          for (int q = 0; q < kR / 4; ++q) {
            const uint4 y = __ldg(s4 + q);
            const uint32_t w[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x[4 * q + e] = sh == 0 ? w[e] : add_mod(x[4 * q + e], w[e], p);
          }
        }
        // 4b. the inverse NTT, to natural order in the spectra row
        inverse_row(x, buf, s, t, g, iw, iws, p);
        uint32_t* row = rows + (cc * P + pi) * N;
#pragma unroll
        for (int v = 0; v < kR; ++v) row[t | (v << s.logT)] = x[v];
      }
    }
    __syncthreads();
    // 5-6. Garner (with 1/N) and the carry-add into acc
    for (int idx = threadIdx.x; idx < cpp * N; idx += blockDim.x) {
      const int c = idx >> s.logN, k = idx & (N - 1);
      acc_b[c0 * N + idx] += garner_rows<P, W>(rows + c * PN, N, k, K);
    }
    if (!OnePass) __syncthreads();  // the next pass rewrites the rows
  }
}

struct PartialArgs {
  const void* acc;
  const int32_t* a;
  const uint32_t *keyv, *ftw, *ftws, *rpow, *rexp;
  uint32_t* out;
  unsigned char* ws;
  int B, j0, j_local;
  cudaStream_t stream;
  int* blocks_per_sm;  // non-null: report the residency, launch nothing
};

template <int P, typename W, bool S, int LogN, bool Rot>
cudaError_t launch_partial(const PartialArgs& x, const PbsConsts& K,
                           const Layout& L, const Sched& s) {
  return launch_sched(partial_step_kernel<P, W, S, LogN, Rot>, s, L, x.B,
                      x.stream, x.blocks_per_sm, static_cast<const W*>(x.acc),
                      x.a, x.keyv, x.ftw, x.ftws, x.rpow, x.rexp, x.out, x.ws,
                      K, L, x.j0, x.j_local);
}

template <int P, typename W, bool Rot>
cudaError_t launch_partial_s(const PartialArgs& x, const PbsConsts& K,
                             const Layout& L, const Sched& s) {
  if (!all_shared(L, kNumBuf))
    return launch_partial<P, W, false, 0, Rot>(x, K, L, s);
  return with_log_n<P>(K, [&](auto n) {
    return launch_partial<P, W, true, decltype(n)::value, Rot>(x, K, L, s);
  });
}

struct FinishArgs {
  void* acc;
  const uint32_t *parts, *itw, *itws;
  int B, m;
  cudaStream_t stream;
  int* blocks_per_sm;
};

template <int P, typename W, bool OnePass, int LogN>
cudaError_t launch_finish(const FinishArgs& x, const PbsConsts& K,
                          const Layout& L, const Sched& s) {
  return launch_sched(finish_step_kernel<P, W, OnePass, LogN>, s, L, x.B,
                      x.stream, x.blocks_per_sm, static_cast<W*>(x.acc),
                      x.parts, x.itw, x.itws, K, L, x.m, x.B);
}

template <int P, typename W>
cudaError_t launch_finish_s(const FinishArgs& x, const PbsConsts& K,
                            const Layout& L, const Sched& s) {
  if (L.off[kRowsRest] < 0) return launch_finish<P, W, false, 0>(x, K, L, s);
  return with_log_n<P>(K, [&](auto n) {
    return launch_finish<P, W, true, decltype(n)::value>(x, K, L, s);
  });
}

int partial_entry(const PartialArgs& x, const int64_t* consts,
                  const int64_t* layout, int word_bits) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || !make_sched(K.logN, K.P, s))
    return int(cudaErrorInvalidValue);
  if (x.j0 < 0 || x.j_local < 1 || x.j0 + x.j_local > K.C * K.l ||
      !x.rpow != !x.rexp)
    return int(cudaErrorInvalidValue);
  if (x.B == 0 && !x.blocks_per_sm) return int(cudaSuccess);
  const Layout L = parse_layout(layout, kNumBuf);
  return int(dispatch_pw(K.P, word_bits, [&](auto p, auto w) {
    constexpr int P = decltype(p)::value;
    using W = decltype(w);
    return x.rpow ? launch_partial_s<P, W, true>(x, K, L, s)
                  : launch_partial_s<P, W, false>(x, K, L, s);
  }));
}

int finish_entry(const FinishArgs& x, const int64_t* consts,
                 const int64_t* layout, int word_bits) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || !make_sched(K.logN, K.P, s) || x.m < 1)
    return int(cudaErrorInvalidValue);
  if (x.B == 0 && !x.blocks_per_sm) return int(cudaSuccess);
  const Layout L = parse_layout(layout, kNumFinishBuf);
  return int(dispatch_pw(K.P, word_bits, [&](auto p, auto w) {
    return launch_finish_s<decltype(p)::value, decltype(w)>(x, K, L, s);
  }));
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh), whose
// gadget offset is of the word width; layout: the buffer placement (smem
// bytes, workspace stride, offsets of work, spec); ws: the workspace, B x
// stride bytes (null when the stride is 0).  acc [B, k+1, N] (read), u64
// words (word_bits 64) or u32 words (word_bits 32); a [B] int32 in [0, 2N];
// keyv [j_local, k+1, P, N] u32 (16-byte aligned), global key rows [j0, j0 +
// j_local); keyvs, their Shoup companions, is not read (the MAC's Barrett
// products need only the residues); out [B, k+1, P, N] u32 canonical
// residues (16-byte aligned).  rpow [P, 2N] u32 (psi^e) and rexp [N] u32
// (16-byte aligned, each slot's exponent) select the rotation-free step;
// both null, the classic one.
int partial_step_launch(const void* acc, const void* a, const void* keyv,
                        const void* keyvs, const void* ftw, const void* ftws,
                        const void* rpow, const void* rexp, void* out,
                        void* ws, const int64_t* consts,
                        const int64_t* layout, int B, int j0, int j_local,
                        int word_bits, void* stream) {
  const PartialArgs x{acc,
                      static_cast<const int32_t*>(a),
                      static_cast<const uint32_t*>(keyv),
                      static_cast<const uint32_t*>(ftw),
                      static_cast<const uint32_t*>(ftws),
                      static_cast<const uint32_t*>(rpow),
                      static_cast<const uint32_t*>(rexp),
                      static_cast<uint32_t*>(out),
                      static_cast<unsigned char*>(ws),
                      B,
                      j0,
                      j_local,
                      static_cast<cudaStream_t>(stream),
                      nullptr};
  return partial_entry(x, consts, layout, word_bits);
}

// layout: smem bytes, stride (0), the offsets of the exchange rows, of
// component 0's spectra rows and of the other components' rows (>= 0:
// right after them, one pass; else one pass per component).  acc [B, k+1,
// N] u64 or u32 words (word_bits), updated in place; parts [m, B, k+1, P,
// N] u32 (16-byte aligned), each partial canonical (< p).
int finish_step_launch(void* acc, const void* parts, const void* itw,
                       const void* itws, const int64_t* consts,
                       const int64_t* layout, int B, int m, int word_bits,
                       void* stream) {
  const FinishArgs x{acc,
                     static_cast<const uint32_t*>(parts),
                     static_cast<const uint32_t*>(itw),
                     static_cast<const uint32_t*>(itws),
                     B,
                     m,
                     static_cast<cudaStream_t>(stream),
                     nullptr};
  return finish_entry(x, consts, layout, word_bits);
}

// The blocks of K8a (finish 0; its rotation-free instances with rot 1) or
// K8b (finish 1) resident on one SM at the plan's shape, the placement (each
// kernel's own layout) and the word width
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device),
// and the threads of a block.
int tp_step_residency(const int64_t* consts, const int64_t* layout,
                      int word_bits, int finish, int rot, int* blocks,
                      int* threads) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || !make_sched(K.logN, K.P, s))
    return int(cudaErrorInvalidValue);
  *threads = s.NG * s.T;
  if (finish)
    return finish_entry(
        FinishArgs{nullptr, nullptr, nullptr, nullptr, 0, 1, nullptr, blocks},
        consts, layout, word_bits);
  // any non-null address selects the instances; nothing is read
  const auto* r = rot ? reinterpret_cast<const uint32_t*>(consts) : nullptr;
  return partial_entry(PartialArgs{nullptr, nullptr, nullptr, nullptr,
                                   nullptr, r, r, nullptr, nullptr, 0, 0, 1,
                                   nullptr, blocks},
                       consts, layout, word_bits);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
