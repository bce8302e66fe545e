// K1's block schedule (blind_rotate.cu), shared with the GA rotation K7
// (ga_scan.cu), the split CMUX step K8a/K8b (tp_step.cu), the external-product
// scan K3 (ext_product_apply.cu), the unfolded rotation K4
// (unfolded_rotate.cu), the GA step's external product K1-delta
// (cmux_delta.cu), the automorphism key switch K6 (auto_keyswitch.cu) and
// UBR phase 1 K5 (ubr_phase1.cu, whose groups are ciphertexts, not primes):
// a block of groups of T = N/16 threads, one group per prime, each thread
// owning 16 coefficients of its group's row and running up to four radix-2
// stages on them between exchanges through the group's exchange row; lazy
// Harvey residues ([0, 4p) forward, [0, 2p) in the MAC and the inverse);
// the MAC's Barrett product on a key residue alone; Garner on rows a stride
// apart; an external product's spectra (K7's stages 1 and 3, K3, K1-delta,
// K6) and the Garner that replaces acc with them; the Galois permutation
// read one word at a time; and the choice of a shape's instance and its
// launch.  How each kernel uses it is in its source.
//
// Each kernel source that includes this header is compiled into its own
// shared library, so everything here has internal linkage.

#pragma once

#include "ntt_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kQ = 4;            // radix-2 stages per pass
constexpr int kR = 1 << kQ;      // coefficients a thread owns

// The schedule of one row: T = N / kR threads per group, NG groups, the
// row stride SR, np passes.  Pass e (0 = lowest bits) owns the window of kQ
// bits [w, w + kQ) of the position and runs the stages on its bits
// [lo, hi]: e < np-1 has w = lo = e kQ; the top pass has w = logN - kQ and
// lo = (np-1) kQ, hi = logN - 1.  Thread t's coefficient v sits at
//   pos = (t mod 2^w) | v << w | (t >> w) << (w + kQ),
// in row slot pos + (pos >> kQ) where N >= 256 (one pad word after every
// kR keeps the exchanges and the MAC's slots free of bank conflicts; then
// every window has w = 0 or w >= kQ), and in slot pos below.
struct Sched {
  int logN, logT, T, NG, SR, np;
  bool pad;
};

__host__ __device__ inline bool make_sched(int logN, int P, Sched& s) {
  if (logN < kQ || logN > 14) return false;
  s.logN = logN;
  s.logT = logN - kQ;
  s.T = 1 << s.logT;
  s.NG = P < kMaxThreads / s.T ? P : kMaxThreads / s.T;
  s.pad = logN >= 2 * kQ;
  s.SR = (1 << logN) + (s.pad ? 1 << s.logT : 0);
  s.np = (logN + kQ - 1) / kQ;
  return true;
}

__device__ __forceinline__ int window(const Sched& s, int e) {
  return e == s.np - 1 ? s.logN - kQ : e * kQ;
}

// Thread t's slots at window w: coefficient v in slot first + v * stride.
struct Slots {
  int first, stride;
};

__device__ __forceinline__ Slots slots(const Sched& s, int t, int w) {
  const int pos = (t & ((1 << w) - 1)) | ((t >> w) << (w + kQ));
  if (!s.pad) return {pos, 1 << w};
  return {pos + (pos >> kQ), (1 << w) + (w >= kQ ? 1 << (w - kQ) : 0)};
}

// Synchronise the threads of group g: a named barrier of its T threads,
// or the whole block where T < 32 (every group then runs the same steps).
__device__ __forceinline__ void group_sync(int g, int T) {
  if (T >= 32)
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(T) : "memory");
  else
    __syncthreads();
}

// The exchange between windows 1 and 0 stays inside each warp when T >= 32:
// both windows cover position bits 0-8 with a warp's 32 x 16 coefficients.
__device__ __forceinline__ void warp_sync(int T) {
  if (T >= 32)
    __syncwarp();
  else
    __syncthreads();
}

// NS consecutive twiddles and their Shoup companions from tw[i], i a
// multiple of NS (so the vector load is aligned: rows are N >= 16 words).
template <int NS>
__device__ __forceinline__ void load_tw(const uint32_t* __restrict__ tw,
                                        const uint32_t* __restrict__ tws,
                                        int i, uint32_t (&w)[NS],
                                        uint32_t (&ws)[NS]) {
  if constexpr (NS == 1) {
    w[0] = __ldg(tw + i);
    ws[0] = __ldg(tws + i);
  } else if constexpr (NS == 2) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(tw + i));
    const uint2 b = __ldg(reinterpret_cast<const uint2*>(tws + i));
    w[0] = a.x, w[1] = a.y, ws[0] = b.x, ws[1] = b.y;
  } else {
#pragma unroll
    for (int q = 0; q < NS / 4; ++q) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(tw + i) + q);
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(tws + i) + q);
      w[4 * q] = a.x, w[4 * q + 1] = a.y, w[4 * q + 2] = a.z,
      w[4 * q + 3] = a.w;
      ws[4 * q] = b.x, ws[4 * q + 1] = b.y, ws[4 * q + 2] = b.z,
      ws[4 * q + 3] = b.w;
    }
  }
}

// x in [0, 4p) -> [0, 2p)
__device__ __forceinline__ uint32_t lazy2(uint32_t x, uint32_t p2) {
  return min(x, x - p2);
}

// x in [0, 4p) -> [0, p): a forward transform's output made canonical (K4's
// digit spectra, K5's output)
__device__ __forceinline__ uint32_t canonical4(uint32_t x, uint32_t p) {
  const uint32_t y = lazy2(x, 2 * p);
  return min(y, y - p);
}

// x * k mod p in [0, 2p) for a forward-NTT output x < 4p and a key residue
// k < p, by `barrett` (ntt_common.cuh) without the key's Shoup companion:
// z = x k < 2^62, t = floor(z / 2^30) < 2^32 and q = floor(t floor(2^62/p)
// / 2^32) is at most 3 below floor(z / p) (the 2^30 / p < 1.75 of t's floor
// and t / 2^32 < 1 of the constant's), so z - q p < 4p < 2^32; one lazy
// reduction.  Five 32-bit operations more than a Shoup product, and half
// the key's bytes.
__device__ __forceinline__ uint32_t mac_product(uint32_t x, uint32_t k,
                                                uint32_t p, uint32_t mup) {
  const uint32_t zlo = x * k, zhi = __umulhi(x, k);
  const uint32_t t = (zhi << 2) | (zlo >> 30);
  const uint32_t q = t + __umulhi(t, mup);
  return lazy2(zlo - q * p, 2 * p);
}

// One stage on value bit I of a thread's kR coefficients, pass window w,
// position bit b = w + I: pairs (v, v | 2^I), twiddle index
// 2^(logN-1-b) + (pos >> (b+1)) = 2^(logN-1-b) + (t >> w) 2^(kQ-1-I)
// + (v >> (I+1)).  Forward: Cooley-Tukey, [0, 4p) -> [0, 4p); inverse:
// Gentleman-Sande, [0, 2p) -> [0, 2p).
template <int I, bool Fwd>
__device__ __forceinline__ void stage(uint32_t (&x)[kR], int t, int w,
                                      int logN,
                                      const uint32_t* __restrict__ tw,
                                      const uint32_t* __restrict__ tws,
                                      uint32_t p) {
  constexpr int NS = 1 << (kQ - 1 - I);
  const int b = w + I;
  uint32_t W[NS], Ws[NS];
  load_tw<NS>(tw, tws, (1 << (logN - 1 - b)) + ((t >> w) << (kQ - 1 - I)), W,
              Ws);
  const uint32_t p2 = 2 * p;
#pragma unroll
  for (int u = 0; u < NS; ++u)
#pragma unroll
    for (int z = 0; z < (1 << I); ++z) {
      uint32_t& X = x[(u << (I + 1)) | z];
      uint32_t& Y = x[(u << (I + 1)) | z | (1 << I)];
      if (Fwd) {
        const uint32_t a = lazy2(X, p2);
        const uint32_t m = shoup_lazy(Y, W[u], Ws[u], p);
        X = a + m;
        Y = a - m + p2;
      } else {
        const uint32_t d = X - Y + p2;
        X = lazy2(X + Y, p2);
        Y = shoup_lazy(d, W[u], Ws[u], p);
      }
    }
}

// The stages of pass e whose position bits lie in [lo, hi], in the
// transform's order: top bit first forward, bottom bit first inverse.
template <bool Fwd>
__device__ __forceinline__ void run_pass(uint32_t (&x)[kR], const Sched& s,
                                         int e, int t,
                                         const uint32_t* __restrict__ tw,
                                         const uint32_t* __restrict__ tws,
                                         uint32_t p) {
  const int w = window(s, e), lo = e * kQ,
            hi = e == s.np - 1 ? s.logN - 1 : e * kQ + kQ - 1;
  // bit I of the window is staged when w + I lies in [lo, hi]
#define MOSFHET_STAGE(I) \
  if (w + I >= lo && w + I <= hi) stage<I, Fwd>(x, t, w, s.logN, tw, tws, p);
  if (Fwd) {
    MOSFHET_STAGE(3) MOSFHET_STAGE(2) MOSFHET_STAGE(1) MOSFHET_STAGE(0)
  } else {
    MOSFHET_STAGE(0) MOSFHET_STAGE(1) MOSFHET_STAGE(2) MOSFHET_STAGE(3)
  }
#undef MOSFHET_STAGE
  static_assert(kQ == 4, "run_pass unrolls four stages");
}

// Move a thread's coefficients from pass window `from` to `to` through its
// group's row `buf`.  The thread writes only slots it read at the last
// exchange (or, first in a transform, after `pre` synchronises the group),
// so `local` (windows 1 and 0) needs only the warp's synchronisation.
__device__ __forceinline__ void exchange(uint32_t (&x)[kR], uint32_t* buf,
                                         const Sched& s, int t, int from,
                                         int to, bool pre, bool local,
                                         int g) {
  if (pre) group_sync(g, s.T);
  const Slots a = slots(s, t, from), b = slots(s, t, to);
#pragma unroll
  for (int v = 0; v < kR; ++v) buf[a.first + v * a.stride] = x[v];
  if (local)
    warp_sync(s.T);
  else
    group_sync(g, s.T);
#pragma unroll
  for (int v = 0; v < kR; ++v) x[v] = buf[b.first + v * b.stride];
}

// Forward negacyclic NTT of one row held as x at the top window's
// positions (values < 4p); ends at window 0 (bit-reversed positions
// 16 t .. 16 t + 15), values in [0, 4p).
__device__ __forceinline__ void forward_row(uint32_t (&x)[kR], uint32_t* buf,
                                            const Sched& s, int t, int g,
                                            const uint32_t* __restrict__ tw,
                                            const uint32_t* __restrict__ tws,
                                            uint32_t p) {
  for (int e = s.np - 1; e >= 0; --e) {
    run_pass<true>(x, s, e, t, tw, tws, p);
    if (e > 0)
      exchange(x, buf, s, t, window(s, e), window(s, e - 1), e == s.np - 1,
               e == 1, g);
  }
}

// Inverse (unscaled) of `forward_row`: x at window 0 in [0, 2p) -> x at the
// top window, natural order, in [0, 2p).
__device__ __forceinline__ void inverse_row(uint32_t (&x)[kR], uint32_t* buf,
                                            const Sched& s, int t, int g,
                                            const uint32_t* __restrict__ tw,
                                            const uint32_t* __restrict__ tws,
                                            uint32_t p) {
  for (int e = 0; e < s.np; ++e) {
    run_pass<false>(x, s, e, t, tw, tws, p);
    if (e < s.np - 1)
      exchange(x, buf, s, t, window(s, e), window(s, e + 1), e == 0, e == 0,
               g);
  }
}

// Unscaled inverse-NTT outputs of one coefficient, rows `stride` words
// apart -> exact value mod 2^64, or mod 2^32 for W = uint32_t (the TPU's
// `_garner_limbs`, pbs_kernel.py:682, and `_garner_limb32` :725: the same
// digits, the Horner step wrapping mod 2^32).
template <int P, typename W>
__device__ __forceinline__ W garner_rows(const uint32_t* spec_c, int stride,
                                         int k, const PbsConsts& K) {
  uint32_t d[P];
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const uint32_t p = K.p[m];
    const uint32_t r = shoup(spec_c[m * stride + k], K.ninv[m], K.ninvs[m], p);
    if (m == 0) {
      d[0] = r;
      continue;
    }
    uint32_t acc = d[0];
#pragma unroll
    for (int j = 1; j < m; ++j)
      acc = add_mod(acc, shoup(d[j], K.gw[m][j], K.gws[m][j], p), p);
    d[m] = shoup(sub_mod(r, acc, p), K.cinv[m], K.cinvs[m], p);
  }
  const uint32_t top = d[P - 1], ptop = K.p[P - 1];
  W v = top > ptop / 2 ? W(top) - W(ptop) : W(top);
#pragma unroll
  for (int m = P - 2; m >= 0; --m) v = v * W(K.p[m]) + W(d[m]);
  return v;
}

// Coefficient k of psi_g(row), the automorphism X -> X^g of a negacyclic row
// of length N given by ginv = g^-1 mod 2N: +-row[(k ginv mod 2N) mod N],
// negated mod 2^(8 sizeof W) when (k ginv mod 2N) >= N (2N divides 2^32, so
// the 32-bit product wraps harmlessly).  row may be in shared or global
// memory.
template <typename W>
__device__ __forceinline__ W permuted_word(const W* row, int k, int ginv,
                                           int N) {
  const unsigned ic = (unsigned(k) * unsigned(ginv)) & (2u * unsigned(N) - 1u);
  const W v = row[ic & unsigned(N - 1)];
  return (ic & unsigned(N)) ? W(0) - v : v;
}

__device__ __forceinline__ void prefetch_l2(const uint32_t* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The spectra of one external product on K1's schedule, for this thread's
// group: per prime pi of plan K (PP primes; group g takes g, g + NG, ...),
// the R digit rows j (component j / K.l, digit j % K.l) of the words
// word(c, k) through the forward NTT and the MAC against key rows
// [R][C][PP][N] (16-byte aligned) into the thread's window-0 slots of
// spec[c][pi] (rows SR words apart, components PM rows apart; replaced at
// j = 0), then the inverse NTTs of spec[c][pi] to natural order in the same
// rows.  Prefetch: ask L2 for a row's key words `ahead` words on (0: the
// row itself) before its forward passes.  Fixed: the 80-register shape
// (C = 2), whose MAC has both components' key words in flight.  Below a
// warp per group every exchange synchronises the whole block and every
// group has one prime of PM: a group with none of this plan's then runs the
// same passes on prime 0 without loading a key or storing, so that every
// thread reaches the same barriers.
template <int PP, int PM, typename W, bool Fixed, bool Prefetch,
          typename Word>
__device__ __forceinline__ void product_spectra(
    Word word, int R, const uint32_t* __restrict__ key, uint32_t* spec,
    uint32_t* work, const uint32_t* __restrict__ ftw,
    const uint32_t* __restrict__ ftws, const uint32_t* __restrict__ itw,
    const uint32_t* __restrict__ itws, const PbsConsts& K, const Sched& s,
    size_t ahead = 0) {
  constexpr int H = Fixed ? 2 : 1;
  const int N = 1 << s.logN, C = Fixed ? 2 : K.C, l = K.l;
  const int g = threadIdx.x >> s.logT, t = threadIdx.x & (s.T - 1);
  const W offset = W(K.offset);
  uint32_t* buf = work + g * s.SR;
  const int slot0 = slots(s, t, 0).first;  // window 0: slot0 + v
  uint32_t x[kR];
  for (int pi = g; pi < PP || (s.T < 32 && pi == g); pi += s.NG) {
    const bool live = pi < PP;
    const int pr = live ? pi : 0;
    const uint32_t p = K.p[pr], p2 = 2 * p, mup = K.mup[pr];
    const uint32_t *fw = ftw + pr * N, *fws = ftws + pr * N;
    for (int j = 0; j < R; ++j) {
      const int cj = j / l, d = j % l;
      const uint32_t* kj = key + (size_t(j * C) * PP + pr) * N + (t << kQ);
      if (Prefetch && live)
        for (int c = 0; c < C; ++c) {
          prefetch_l2(kj + ahead + size_t(c) * PP * N);
          prefetch_l2(kj + ahead + size_t(c) * PP * N + kR / 2);
        }
#pragma unroll
      for (int v = 0; v < kR; ++v) {
        const W w = word(cj, t | (v << s.logT)) + offset;
        x[v] = small_residue(gadget_digit(w, d, K), p);
      }
      forward_row(x, buf, s, t, g, fw, fws, p);
      if (!live) continue;
      for (int c0 = 0; c0 < C; c0 += H) {
        uint4 kw[H][kR / 4];
#pragma unroll
        for (int u = 0; u < H; ++u) {
          const uint4* k4 = reinterpret_cast<const uint4*>(
              kj + size_t(c0 + u) * PP * N);
#pragma unroll
          for (int q = 0; q < kR / 4; ++q) kw[u][q] = __ldg(k4 + q);
        }
#pragma unroll
        for (int u = 0; u < H; ++u) {
          uint32_t* sp = spec + ((c0 + u) * PM + pi) * s.SR + slot0;
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
    // the inverse NTTs from this thread's slots to natural order in the
    // same row (every slot is read before the exchanges' group barrier,
    // every output written after it)
    const uint32_t *iw = itw + pr * N, *iws = itws + pr * N;
    for (int c = 0; c < C; ++c) {
      uint32_t* row = spec + (c * PM + pr) * s.SR;
      if (live) {
#pragma unroll
        for (int v = 0; v < kR; ++v) x[v] = row[slot0 + v];
      }
      inverse_row(x, buf, s, t, g, iw, iws, p);
      if (live) {
#pragma unroll
        for (int v = 0; v < kR; ++v) row[t | (v << s.logT)] = x[v];
      }
    }
  }
}

// acc [C][N] <- Garner of the natural-order spectra rows spec[c][0 .. P)
// (SR words apart, components PM rows apart), between two block barriers:
// the first waits for every group's inverse NTTs, the second for every
// word of acc before anything reads it again.  N, CN = C N and the block's
// threads as the kernel holds them.
template <int P, int PM, typename W>
__device__ __forceinline__ void replace_acc(W* acc, const uint32_t* spec,
                                            int N, int CN, int threads,
                                            const PbsConsts& K,
                                            const Sched& s) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < CN; idx += threads)
    acc[idx] = garner_rows<P, W>(spec + (idx >> s.logN) * PM * s.SR, s.SR,
                                 idx & (N - 1), K);
  __syncthreads();
}

// Launch bounds: a block of at most 384 threads (TFHEpp-L2's and L2_32's
// shape: N = 2048, k = 1, 2 or 3 primes, all in shared memory) may take 80
// registers and still keep two or three blocks per SM; any other shape, up
// to 1,024 threads, 64.  LogN: the row length's log, a compile-time
// constant in the first case (every index of the schedule folds, and k = 1
// with it), 0 (read from the plan) in the other.
template <int LogN>
constexpr int kBlockThreads = LogN ? 384 : kMaxThreads;
template <int LogN>
constexpr int kMinBlocks = LogN ? 2 : 1;
constexpr int kFixedLogN = 11;

// Calls f(std::integral_constant<int, LogN>{}) with the LogN of the
// instance that takes the plan's shape: kFixedLogN where N = 2048, k = 1
// and the block's groups cover at most 3 primes (P), else 0.
template <int P, typename F>
cudaError_t with_log_n(const PbsConsts& K, F&& f) {
  if constexpr (P <= 3)
    if (K.logN == kFixedLogN && K.C == 2)
      return f(std::integral_constant<int, kFixedLogN>{});
  return f(std::integral_constant<int, 0>{});
}

// Launches kernel on B blocks of the schedule's threads with L.smem bytes
// of dynamic shared memory, or, given blocks_per_sm, reports how many of
// its blocks are resident on one SM instead.
template <typename Kernel, typename... A>
cudaError_t launch_sched(Kernel kernel, const Sched& s, const Layout& L,
                         int B, cudaStream_t stream, int* blocks_per_sm,
                         A... args) {
  const int threads = s.NG * s.T;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.smem));
  if (err != cudaSuccess) return err;
  if (blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, threads, size_t(L.smem));
  kernel<<<B, threads, L.smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
