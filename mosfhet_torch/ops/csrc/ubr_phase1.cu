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
// ops/pbs_kernel.py:2881, body `_make_phase1_v2_kernel` :2792).  Per output
// row (b, g, j, c):
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
// Design.  One block per key row (g, j, c) and tile of TB ciphertexts
// (`pbs_kernel.ubr_phase1_tiling`: TB up to 8 with u64 words and up to 2
// with u32 words at N = 2048, the batch spread evenly over the fewest
// tiles), blockIdx.x = (g J C + j C + c) * tiles +
// tile: the tiles of a key row run side by side, so L2 serves their repeats
// and the key leaves HBM about once per call.  The block streams the row's
// M key products SU[g, m, j, c, :] through a ring of S whole rows in shared
// memory (4, else 2 or 1 where 4 do not fit; a rotation reads any word of a
// row): thread 0 copies each row by one TMA bulk copy onto its stage's
// `full` mbarrier and refills a stage with the row S on once every warp has
// arrived on its `empty` mbarrier.  So each key word leaves L2 once per
// tile, not once per ciphertext.  The block is TB groups of T = N/16
// threads, group i owning ciphertext i of the tile and thread t the 16
// positions t + T v of the top window of K1's schedule (rotate_sched.cuh),
// where the forward passes start.  Per staged row and exponent a = hi N + rr
// (`add_rotated`) a thread's positions below rr read one run of the row and
// the others another, each run at a constant offset from its base and with
// one sign: a switch over the warp's count K of positions below rr picks
// the unrolled case, so every add is a shared-memory load and a u64 (u32)
// add or subtract, with no index or sign arithmetic; the count varies by at
// most one within a warp, so the switch does not diverge and only position
// K chooses its base and sign per thread.  Consecutive threads read
// consecutive words: no bank conflicts.  Then the ring, read out, becomes
// the exchange rows (after a block barrier), and per prime the 16 centred
// residues, `forward_row` through the group's exchange row (three passes
// and two exchanges at N = 2048, lazy residues), `canonical4`, and the
// thread's 16 window-0 outputs (positions 16 t .. 16 t + 15) written by four
// 16-byte stores.  A group past B (the last tile's) combines the last
// ciphertext's words and stores nothing.  The residues, the passes and the
// reduction are K4's (unfolded_rotate.cu), on the same helpers.
//
// What bounds it on this card: at TFHEpp-L2, u=8 the rotate-adds, 663e6
// u64 adds per ciphertext (1.33e9 INT32 operations), against 5.3 GB of key
// that one ciphertext reads once (1.6 ms at the HBM rate) and a batch
// shares.  Each staged add reads 8 bytes (u32: 4) of shared memory: 5.3 GB
// per ciphertext, 0.16 ms at the card's 33.4 TB/s, the ceiling of this
// design.  At L2_32, u=4 (16 adds per output word) the NTTs weigh as much
// as the adds.  Forms tried on an H100 and dropped (PERF.md, K5): each
// add's index wrapped and its sign selected (about 10 instructions an
// add), stages of 2N words holding each row twice, and stages of 3N words
// holding [row, -row, row] filled by the block one row ahead.  Each read
// slower at B = 64 than this form did in a later call, never in the same
// call; rows held twice read faster than the form it was paired with.
//
// Buffers of a block (`kernel_buffers("ubr_phase1")`, all in shared
// memory): the ring [S][N] words, which the exchange rows [TB][SR] u32
// reuse after the adds, and the exponents [TB][M]; the wrapper takes the
// most stages that fit (one row at N = 16384 with u64 words) and raises
// ValueError where not one does.
//
// K5-v1 (`pbs_kernel.ubr_phase1_combine_v1`, replacing the TPU package's
// first phase-1 kernel `ubr_phase1_combine`, pbs_kernel.py:2744) launches
// this kernel through the same entry on the same operands.

#include "rotate_sched.cuh"

namespace {

// buffers, as the wrapper lists them (the exchange rows reuse the ring)
enum { kRing, kRots, kNumBuf };
constexpr int kMaxStages = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// arrives, and adds bytes to the phase's expected transaction count
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "UBR_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra UBR_WAIT;\n}"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// bytes (a multiple of 16) from 16-byte aligned global src to 16-byte
// aligned shared dst by the TMA unit, completing on bar's transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The lanes of this thread's warp among the block's first `threads`.
__device__ __forceinline__ unsigned warp_mask(int threads) {
  const int n = threads - int(threadIdx.x & ~31u);
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// Row st (N words) rotated by X^a, a = hi N + rr with rr in [0, N], added
// into the 16 words x of positions t + T v (T = 2^logT): a position below
// rr reads st[t + T v - rr + N] (base `lo`), any other st[t + T v - rr]
// (base `hi0`), negated below rr when hi is false and from rr on when it is
// true (X^N = -1).  K: the positions below rr of the warp's last thread,
// the same for the whole warp, so the switch below does not diverge; a
// thread of the warp has K or K + 1 below rr, so only position K's base and
// sign vary across the warp (`below`).  Every other read is at a constant
// offset from its base, its sign known at compile time.
template <bool Hi, int K, typename W>
__device__ __forceinline__ void add_rotated(W (&x)[kR], const W* st, int lo,
                                            int hi0, int logT, bool below) {
#pragma unroll
  for (int v = 0; v < kR; ++v) {
    if (v == K) {
      const W w = st[(below ? lo : hi0) + (v << logT)];
      x[v] = below != Hi ? x[v] - w : x[v] + w;
    } else {
      const W w = st[(v < K ? lo : hi0) + (v << logT)];
      if ((v < K) != Hi)
        x[v] -= w;
      else
        x[v] += w;
    }
  }
}

template <bool Hi, typename W>
__device__ __forceinline__ void add_rotated(W (&x)[kR], const W* st, int lo,
                                            int hi0, int logT, int k,
                                            bool below) {
  switch (k) {
#define MOSFHET_RUN(V) \
  case V:              \
    add_rotated<Hi, V>(x, st, lo, hi0, logT, below); \
    break;
    MOSFHET_RUN(0) MOSFHET_RUN(1) MOSFHET_RUN(2) MOSFHET_RUN(3)
    MOSFHET_RUN(4) MOSFHET_RUN(5) MOSFHET_RUN(6) MOSFHET_RUN(7)
    MOSFHET_RUN(8) MOSFHET_RUN(9) MOSFHET_RUN(10) MOSFHET_RUN(11)
    MOSFHET_RUN(12) MOSFHET_RUN(13) MOSFHET_RUN(14) MOSFHET_RUN(15)
    default: add_rotated<Hi, kR>(x, st, lo, hi0, logT, below);
#undef MOSFHET_RUN
  }
  static_assert(kR == 16, "add_rotated's cases cover 16 positions");
}

// K5.  LogN != 0: N = 2^LogN at compile time (N = 2048, k = 1, P at most
// 3: every index of the schedule folds).  TB: ciphertexts per block; S:
// stages of the ring.
template <int P, typename W, int LogN>
__global__ void __launch_bounds__(kMaxThreads, 1)
ubr_phase1_kernel(const W* __restrict__ su, const int32_t* __restrict__ rot_g,
                  uint32_t* __restrict__ out,
                  const uint32_t* __restrict__ ftw,
                  const uint32_t* __restrict__ ftws, const PbsConsts Kp,
                  const Layout L, int B, int G, int M, int TB, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PbsConsts K;
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  Sched s;  // one group of T threads per ciphertext of the tile
  make_sched(LogN ? LogN : Kp.logN, TB, s);
  const int N = 1 << s.logN, JC = Kp.C * Kp.l * Kp.C;
  const int threads = TB << s.logT, warps = (threads + 31) >> 5;
  const int i = threadIdx.x >> s.logT, t = threadIdx.x & (s.T - 1);
  const int tiles = (B + TB - 1) / TB;
  const int row = blockIdx.x / tiles, tile = blockIdx.x - row * tiles;
  const int g = row / JC, jc = row - g * JC;
  const int b = tile * TB + i;
  const bool live = b < B;
  W* ring = reinterpret_cast<W*>(smem + L.off[kRing]);          // [S][N]
  int32_t* rots = reinterpret_cast<int32_t*>(smem + L.off[kRots]) +
                  i * M;                                    // [TB][M]: own
  const size_t m_stride = size_t(JC) * N;  // su [G][M][J][C][N]
  const W* key = su + size_t(g) * M * m_stride + size_t(jc) * N;
  const uint32_t row_bytes = uint32_t(N) * uint32_t(sizeof(W));
  if (threadIdx.x == 0) {
    K = Kp;
    for (int q = 0; q < S; ++q) {
      mbar_init(&full[q], 1);
      mbar_init(&empty[q], warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int32_t* rot_b = rot_g + (size_t(live ? b : B - 1) * G + g) * M;
  for (int m = t; m < M; m += s.T) rots[m] = rot_b[m];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int m = 0; m < S && m < M; ++m) {
      mbar_arrive_expect(&full[m], row_bytes);
      bulk_copy(ring + size_t(m) * N, key + m * m_stride, row_bytes,
                &full[m]);
    }

  // 1. the combine: row m, from stage m mod S (its round's parity (m / S)
  //    mod 2), into the 16 words at positions t + T v
  W x[kR];
#pragma unroll
  for (int v = 0; v < kR; ++v) x[v] = 0;
  const unsigned mask = s.T >= 32 ? 0xffffffffu : warp_mask(threads);
  const bool lead = (threadIdx.x & 31) == 0;
  const int log_s = S == 4 ? 2 : S - 1;  // S is 1, 2 or 4
  for (int m = 0; m < M; ++m) {
    const int q = m & (S - 1);
    // the stage row m-1 used, once every warp has read it: row m-1+S, in
    // flight while rows m .. m+S-2 are read
    if (threadIdx.x == 0 && m >= 1 && m - 1 + S < M) {
      const int qp = (m - 1) & (S - 1);
      mbar_wait(&empty[qp], ((m - 1) >> log_s) & 1);
      mbar_arrive_expect(&full[qp], row_bytes);
      bulk_copy(ring + size_t(qp) * N, key + size_t(m - 1 + S) * m_stride,
                row_bytes, &full[qp]);
    }
    mbar_wait(&full[q], (m >> log_s) & 1);
    const int r = rots[m];
    const bool hi = r >= N;
    const int rr = hi ? r - N : r;
    // the positions below rr of the warp's last thread, ceil((rr - t) / T)
    // in [0, 16] (below a warp per group: this thread's), and whether this
    // thread's position K is below rr too
    const int t_last = s.T >= 32 ? t | 31 : t;
    const int k = rr > t_last ? (rr - t_last + s.T - 1) >> s.logT : 0;
    const bool below = t + (k << s.logT) < rr;
    const W* st = ring + size_t(q) * N;
    if (hi)
      add_rotated<true>(x, st, t - rr + N, t - rr, s.logT, k, below);
    else
      add_rotated<false>(x, st, t - rr + N, t - rr, s.logT, k, below);
    __syncwarp(mask);
    if (lead) mbar_arrive(&empty[q]);
  }
  // every warp's adds done: the ring becomes the exchange rows
  __syncthreads();

  // 2-3. per prime: centred residues at the top window, the forward passes
  //      through the group's row, canonical residues, four 16-byte stores
  //      of window 0's positions 16 t .. 16 t + 15
  uint32_t* buf = reinterpret_cast<uint32_t*>(ring) + i * s.SR;  // [TB][SR]
  uint32_t* o = out + ((size_t(live ? b : 0) * G + g) * JC + jc) * P * N +
                (t << kQ);
#pragma unroll 1
  for (int pi = 0; pi < P; ++pi) {
    const uint32_t p = K.p[pi];
    uint32_t y[kR];
#pragma unroll
    for (int v = 0; v < kR; ++v) y[v] = centred_residue(x[v], pi, K);
    forward_row(y, buf, s, t, i, ftw + pi * N, ftws + pi * N, p);
    if (live) {
      uint4* o4 = reinterpret_cast<uint4*>(o + size_t(pi) * N);
#pragma unroll
      for (int e = 0; e < kR / 4; ++e)
        o4[e] = make_uint4(canonical4(y[4 * e], p), canonical4(y[4 * e + 1], p),
                           canonical4(y[4 * e + 2], p),
                           canonical4(y[4 * e + 3], p));
    }
  }
}

struct Args {
  const void* su;
  const int32_t* rot;
  uint32_t* out;
  const uint32_t *ftw, *ftws;
  int B, G, M, TB, S;
  cudaStream_t stream;
  int* blocks_per_sm;  // non-null: report the residency, launch nothing
};

template <int P, typename W, int LogN>
cudaError_t launch(const Args& x, const PbsConsts& K, const Layout& L,
                   const Sched& s) {
  const long long blocks =
      (long long)x.G * K.C * K.l * K.C * ((x.B + x.TB - 1) / x.TB);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  return launch_sched(ubr_phase1_kernel<P, W, LogN>, s, L, int(blocks),
                      x.stream, x.blocks_per_sm, static_cast<const W*>(x.su),
                      x.rot, x.out, x.ftw, x.ftws, K, L, x.B, x.G, x.M, x.TB,
                      x.S);
}

int launch_entry(const Args& x, const int64_t* consts, const int64_t* layout,
                 int word_bits) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || x.TB < 1 || !make_sched(K.logN, x.TB, s) ||
      s.NG != x.TB || (x.S != 1 && x.S != 2 && x.S != kMaxStages) ||
      x.M < 1)
    return int(cudaErrorInvalidValue);
  if ((x.B == 0 || x.G == 0) && !x.blocks_per_sm) return int(cudaSuccess);
  const Layout L = parse_layout(layout, kNumBuf);
  if (!all_shared(L, kNumBuf)) return int(cudaErrorInvalidValue);
  return int(dispatch_pw(K.P, word_bits, [&](auto p, auto w) {
    return with_log_n<decltype(p)::value>(K, [&](auto n) {
      return launch<decltype(p)::value, decltype(w), decltype(n)::value>(
          x, K, L, s);
    });
  }));
}

}  // namespace

extern "C" {

// consts: the plan's int64 host array (layout in ntt_common.cuh); layout:
// the buffer placement (smem bytes, workspace stride 0, offsets of the ring,
// which the exchange rows reuse, and of the exponents), all in shared
// memory.  su [G, M, (k+1)l, k+1, N] key products, 16-byte aligned, u64
// words (word_bits 64) or u32 words (word_bits 32); rot [B, G, M] int32 in
// [0, 2N]; out [B, G, (k+1)l, k+1, P, N] u32; twiddles [P, N] u32; tile:
// ciphertexts per block (its groups of N/16 threads at most 1,024); stages:
// the ring's rows (1, 2 or 4).
int ubr_phase1_launch(const void* su, const void* rot, void* out,
                      const void* ftw, const void* ftws,
                      const int64_t* consts, const int64_t* layout, int B,
                      int G, int M, int tile, int stages, int word_bits,
                      void* stream) {
  const Args x{su,
               static_cast<const int32_t*>(rot),
               static_cast<uint32_t*>(out),
               static_cast<const uint32_t*>(ftw),
               static_cast<const uint32_t*>(ftws),
               B,
               G,
               M,
               tile,
               stages,
               static_cast<cudaStream_t>(stream),
               nullptr};
  return launch_entry(x, consts, layout, word_bits);
}

// The blocks of K5 resident on one SM at the plan's shape, the placement,
// the tile and stages and the word width
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device),
// and the threads of a block.
int ubr_phase1_residency(const int64_t* consts, const int64_t* layout,
                         int tile, int stages, int word_bits, int* blocks,
                         int* threads) {
  PbsConsts K;
  Sched s;
  if (!parse_consts(consts, K) || tile < 1 || !make_sched(K.logN, tile, s))
    return int(cudaErrorInvalidValue);
  *threads = s.NG * s.T;
  const Args x{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 1, 1,
               tile,    stages,  nullptr, blocks};
  return launch_entry(x, consts, layout, word_bits);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
