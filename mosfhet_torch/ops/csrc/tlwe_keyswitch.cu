// The select-sum of the TLWE key switch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `tlwe_keyswitch_sum` (the TPU package's
// ops/pbs_kernel.py:2070, body `_make_tlwe_ks_kernel` :2015).  For each
// ciphertext b and table column c it computes, exactly mod 2^64,
//
//   out[b][c] = sum over (i, j) with d = dig[b][i][j] in [1, base) of
//               ab[i][j][d - 1][c]
//
// where ab [n_in][t][base-1][n_out+1] is the KS table (mask words, then b in
// the last column).  Digit 0 adds nothing (the reference's `if aij != 0`,
// `tlwe.c:289-303`); so does any digit outside [1, base), as in the TPU
// kernel's select chain.  The caller forms (0, b) - out.  At the 32-bit
// torus (TORUS32) the table holds u32 words and the sum is mod 2^32: the
// TPU kernel's one-plane form (`nl == 1`, pbs_kernel.py:2115); the same
// body runs on the word type W.
//
// What bounds it on this card.  At TFHEpp-L2, B=512 (n_rows = n_in t =
// 16,384, base-1 = 15, width n_out+1 = 633) the digits select 4.98e9 u64
// adds, two INT32 operations each: 9.96e9 over 132 SMs x 64 lanes x 1980
// MHz is 0.595 ms; the table (1.244 GB) once over 3.35 TB/s is 0.37 ms.  So
// operations bound it.  A gather from shared memory cannot reach that: each
// add loads its word from shared memory, and an SM moves 128 B per clock
// (33.4 TB/s on the card), so 4.98e9 x 8 B is at least 1.19 ms (0.45 ms at
// L2_32, 3.72e9 u32 adds x 4 B): about half the operations bound.  Reading
// each selected word from L2 per ciphertext, as the first design did, moved
// 39.8 GB through L2 per call at L2, B=512.
//
// Design.  A block owns a column slice of 512 B of words (64 u64 or 128 u32
// columns), a tile of kTile = 128 ciphertexts and a part of the rows; the
// S blocks that share a slice and a tile, one per part of the rows, form a
// thread block cluster.  Each block walks its rows in chunks of R rows
// (R x (base-1) table row segments, about 32 KiB of the slice, and the
// tile's R x 128 digits) through a ring of kStages chunks in shared memory.
// A chunk's segments come by TMA: thread x copies segment x's slice with
// one cp.async.bulk, which wants 16-byte aligned addresses and lengths,
// while a row segment starts wherever (g * width + c0) words put it (633
// words: every other u64 segment is 8 bytes off).  So the copy takes the
// 16-byte granules around the slice into a slot of 528 bytes, and the
// slice sits `shift` bytes into it; a granule never crosses a page, so the
// bytes read past the table's ends cannot fault.  The digits come by
// cp.async (zero for a row past n_rows or a ciphertext past B).  A chunk's
// `full` mbarrier completes when every thread has arrived (with its TMA
// bytes) and its digit copies and TMA bytes have landed; every thread
// arrives on `empty` when it has summed the chunk, and the stage is
// refilled with the chunk kStages on once all have, while the next two are
// summed.  So each table word of a slice leaves L2 once per tile of 128
// ciphertexts: 1.244 GB x ceil(B / 128) in all (4.98 GB at L2, B=512).
// Warp w sums ciphertexts 16w .. 16w+15: it turns its digits of the chunk,
// in place, into the shared byte where the selected segment's slice
// starts, slot and shift (-1 where a digit outside [1, base) selects
// nothing), and lane l sums columns l + 32 m, whose words are 32
// consecutive ones per load whatever the shift: conflict-free, two
// shared-memory wavefronts per u64 load.  A digit is the same for the whole
// warp, so the skip never diverges.  Last, each block writes its sums into
// shared memory and, after a cluster barrier, block q of the cluster adds
// the S blocks' sums for its 1/S of the tile's words through distributed
// shared memory and writes them: one launch, no atomics, no zero fill.
// Sums mod 2^W are exact in any order, so the words are the plain PyTorch
// version's.  The host picks S in 1..16 to fill the card: for each S it
// asks the CUDA runtime how many clusters of S blocks fit at once, and takes
// the S whose waves of clusters walk the fewest chunks (a (slice, tile) pair
// is one cluster: at L2, B=512, 10 slices x 4 tiles = 40 clusters).  Two
// other forms were slower on an H100: a pass moving each slice to its
// slot's start, so that lanes read 16 contiguous bytes (it costs a block
// barrier per chunk), and copies by cp.async of 8 or 4 bytes a thread
// (they share the load pipe with the sums).  A batch of fewer than 128
// ciphertexts still stages the whole table: below about 15 ciphertexts a
// direct gather would read less.

#include <algorithm>
#include <climits>
#include <cooperative_groups.h>
#include <mutex>
#include <vector>

#include "ntt_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 128;                  // ciphertexts per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPerWarp = kTile / kWarps;    // ciphertexts per warp
constexpr int kStages = 3;                  // chunks in the ring
constexpr int kSliceBytes = 512;            // a slice's words of one segment
constexpr int kSlotBytes = kSliceBytes + 16;  // its slot: 16-byte copies
constexpr int kStageTableBytes = 32768;     // slice bytes a chunk aims at
constexpr int kMaxChunkRows = 32;
constexpr int kPitch = kTile + 8;           // a digit row, ints (no bank
                                            // conflicts on its copies)
constexpr int kMaxCluster = 16;
constexpr int kEpilogueChunks = 2;          // a block's fill and reduction,
                                            // in chunks, for choosing S

template <typename W>
constexpr int kCols = kSliceBytes / int(sizeof(W));   // columns per slice
template <typename W>
constexpr int kPerLane = kCols<W> / 32;               // columns per lane

// A chunk: R = 2^log_rows rows, the largest power of two up to
// kMaxChunkRows whose R (base-1) segment slices fit kStageTableBytes (at
// least 1).  Stage: slots [R][base-1] of kSlotBytes, then digits
// [R][kPitch] int32.
struct Tiling {
  int rows, log_rows;
  long long table_bytes, stage_bytes, smem;
};

Tiling tiling(int base_m1) {
  Tiling t{1, 0, 0, 0, 0};
  const long long seg = (long long)base_m1 * kSliceBytes;
  while (2 * t.rows <= kMaxChunkRows && 2 * t.rows * seg <= kStageTableBytes) {
    t.rows *= 2;
    ++t.log_rows;
  }
  t.table_bytes = (long long)t.rows * base_m1 * kSlotBytes;
  t.stage_bytes = t.table_bytes + (long long)t.rows * kPitch * 4;
  t.smem = kStages * t.stage_bytes;
  if (t.smem < (long long)kTile * kSliceBytes)  // the sums, reusing the ring
    t.smem = (long long)kTile * kSliceBytes;
  return t;
}

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
      "KS_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra KS_WAIT;\n}"
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

// 4 bytes, or zeros where src_bytes is 0
__device__ __forceinline__ void cp_async_zfill4(void* dst, const void* src,
                                                int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// arrives on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// The byte where column c0 of table segment g (row g / (base-1), digit
// g % (base-1) + 1) starts, within its 16-byte copy: the segment's slice is
// copied from the 16-byte boundary at or below it.
template <typename W>
__device__ __forceinline__ uint32_t segment_shift(const W* ab, int g,
                                                  int width, int c0) {
  return uint32_t(uintptr_t(ab) + (uint32_t(g) * uint32_t(width) +
                                   uint32_t(c0)) * sizeof(W)) & 15u;
}

// a row of the warp's 16 digits (by now shared bytes), four 16-byte loads
__device__ __forceinline__ void unpack(int (&a)[kPerWarp], const int4* row) {
#pragma unroll
  for (int h = 0; h < kPerWarp / 4; ++h) {
    const int4 v = row[h];
    a[4 * h] = v.x;
    a[4 * h + 1] = v.y;
    a[4 * h + 2] = v.z;
    a[4 * h + 3] = v.w;
  }
}

// Chunk k into stage st.  Thread x < rows (base-1) copies segment x's
// slice (columns [c0, c0 + wl) and the 16-byte granules around them) into
// slot x by one TMA copy, having arrived on `full` with its bytes; every
// thread copies its share of the tile's digits ([R][kPitch], zero for a row
// past n_rows or a ciphertext past B) and arrives once they land.
template <typename W>
__device__ __forceinline__ void fill(unsigned char* st, uint64_t* full,
                                     const int32_t* __restrict__ dig,
                                     const W* __restrict__ ab, int k,
                                     int log_rows, int table_bytes,
                                     int n_rows, int base_m1, int width,
                                     int B, int b0, int c0, int wl) {
  const int R = 1 << log_rows;
  const int row0 = k << log_rows;
  const int rows = min(R, n_rows - row0);
  const int x = threadIdx.x;
  if (x < rows * base_m1) {
    const int g = row0 * base_m1 + x;
    const uint32_t shift = segment_shift(ab, g, width, c0);
    const unsigned char* from = reinterpret_cast<const unsigned char*>(
        ab + size_t(g) * width + c0) - shift;
    const uint32_t bytes = (shift + wl * uint32_t(sizeof(W)) + 15u) & ~15u;
    mbar_arrive_expect(full, bytes);
    bulk_copy(st + x * kSlotBytes, from, bytes, full);
  } else {
    mbar_arrive(full);
  }
  int32_t* sd = reinterpret_cast<int32_t*>(st + table_bytes);
  for (int idx = threadIdx.x; idx < (kTile << log_rows); idx += kThreads) {
    const int r = idx & (R - 1), i = idx >> log_rows;
    const bool ok = r < rows && b0 + i < B;
    cp_async_zfill4(sd + r * kPitch + i,
                    ok ? dig + size_t(b0 + i) * n_rows + row0 + r : dig,
                    ok ? 4 : 0);
  }
  cp_async_arrive(full);
}

// blockIdx.x = (slice * tiles + tile) * S + q; the cluster is the S blocks
// of one (slice, tile), block q walking chunks [q n / S, (q + 1) n / S).
template <typename W>
__global__ void __launch_bounds__(kThreads, 2)
tlwe_keyswitch_sum_kernel(const int32_t* __restrict__ dig,
                          const W* __restrict__ ab, W* __restrict__ out,
                          int B, int n_rows, int base_m1, int width,
                          int log_rows, int table_bytes, int stage_bytes,
                          int tiles) {
  constexpr int Wc = kCols<W>, L = kPerLane<W>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = int(cluster.num_blocks()), q = int(cluster.block_rank());
  const int pair = blockIdx.x / S;
  const int b0 = (pair % tiles) * kTile, c0 = (pair / tiles) * Wc;
  const int wl = min(Wc, width - c0);
  const int R = 1 << log_rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (n_rows + R - 1) >> log_rows;
  const int k0 = int((long long)q * chunks / S);
  const int n = int((long long)(q + 1) * chunks / S) - k0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 2 * kThreads);
      mbar_init(&empty[s], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  for (int j = 0; j < min(n, kStages); ++j)
    fill<W>(smem + j * stage_bytes, &full[j], dig, ab, k0 + j, log_rows,
            table_bytes, n_rows, base_m1, width, B, b0, c0, wl);
  W acc[kPerWarp][L] = {};
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    // the stage chunk j-1 used, once every thread has read it: chunk
    // j-1+kStages, in flight while chunks j and j+1 are summed
    if (j >= 1 && j - 1 + kStages < n) {
      const int sp = (j - 1) % kStages;
      mbar_wait(&empty[sp], ((j - 1) / kStages) & 1);
      fill<W>(smem + sp * stage_bytes, &full[sp], dig, ab, k0 + j - 1 +
              kStages, log_rows, table_bytes, n_rows, base_m1, width, B, b0,
              c0, wl);
    }
    mbar_wait(&full[s], (j / kStages) & 1);
    // the warp's digits, turned in place into the shared byte where each
    // selected row segment's column c0 sits (-1: selects nothing)
    int32_t* sd = reinterpret_cast<int32_t*>(smem + s * stage_bytes +
                                             table_bytes) + warp * kPerWarp;
    const int row0 = (k0 + j) << log_rows;
    for (int idx = lane; idx < (kPerWarp << log_rows); idx += 32) {
      const int r = idx / kPerWarp, i = idx % kPerWarp;
      const unsigned v = unsigned(sd[r * kPitch + i]) - 1u;  // 0 -> none
      const int x = r * base_m1 + int(v);
      sd[r * kPitch + i] =
          v < unsigned(base_m1)
              ? s * stage_bytes + x * kSlotBytes +
                    int(segment_shift(ab, row0 * base_m1 + x, width, c0))
              : -1;
    }
    __syncwarp();
    // lane l sums columns l + 32 m of its 16 ciphertexts; rows past
    // n_rows select nothing
    const unsigned char* mine = smem + lane * sizeof(W);
    const int4* rows4 = reinterpret_cast<const int4*>(sd);
    if constexpr (sizeof(W) == 8) {
      // u64: a digit that selects nothing skips its loads and adds
      for (int r = 0; r < R; ++r) {
        int a[kPerWarp];
        unpack(a, rows4 + r * (kPitch / 4));
#pragma unroll
        for (int i = 0; i < kPerWarp; ++i)
          if (a[i] >= 0) {
            const W* w = reinterpret_cast<const W*>(mine + a[i]);
#pragma unroll
            for (int m = 0; m < L; ++m) acc[i][m] += w[32 * m];
          }
      }
    } else {
      // u32: the next row's bytes read ahead, and every load made (from
      // the ring's start where the digit selects nothing), its words added
      // or not; faster here than the u64 form, slower there (measured)
      int next[kPerWarp];
      unpack(next, rows4);
      for (int r = 0; r < R; ++r) {
        int a[kPerWarp];
#pragma unroll
        for (int i = 0; i < kPerWarp; ++i) a[i] = next[i];
        if (r + 1 < R) unpack(next, rows4 + (r + 1) * (kPitch / 4));
#pragma unroll
        for (int i = 0; i < kPerWarp; ++i) {
          const bool take = a[i] >= 0;
          const W* w = reinterpret_cast<const W*>(mine + (take ? a[i] : 0));
          W x[L];
#pragma unroll
          for (int m = 0; m < L; ++m) x[m] = w[32 * m];
#pragma unroll
          for (int m = 0; m < L; ++m) acc[i][m] += take ? x[m] : W(0);
        }
      }
    }
    mbar_arrive(&empty[s]);
  }

  // the S blocks' sums, added through distributed shared memory
  __syncthreads();  // every thread is past the ring
  W* part = reinterpret_cast<W*>(smem);  // [kTile][Wc]
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i)
#pragma unroll
    for (int m = 0; m < L; ++m)
      part[(warp * kPerWarp + i) * Wc + lane + 32 * m] = acc[i][m];
  cluster.sync();
  constexpr int E = kTile * Wc;
  const int hi = int((long long)(q + 1) * E / S);
  for (int e = int((long long)q * E / S) + threadIdx.x; e < hi;
       e += kThreads) {
    const int i = e / Wc, c = e % Wc;
    if (b0 + i < B && c < wl) {
      W sum = 0;
      for (int p = 0; p < S; ++p) sum += *cluster.map_shared_rank(part + e, p);
      out[size_t(b0 + i) * width + c0 + c] = sum;
    }
  }
  cluster.sync();  // no block leaves while another reads its sums
}


// Clusters of S blocks resident at once, per (card, word size, shared
// bytes) and S, asked of the CUDA runtime once.
struct Occupancy {
  int device, word_bytes;
  long long smem;
  int clusters[kMaxCluster + 1];
};
std::mutex occupancy_mutex;
std::vector<Occupancy> occupancy_cache;

template <typename W>
cudaError_t prepare(long long smem) {
  cudaError_t err = cudaFuncSetAttribute(
      tlwe_keyswitch_sum_kernel<W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(tlwe_keyswitch_sum_kernel<W>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

// Clusters of S blocks resident at once for S = 1..kMaxCluster, copied
// into clusters[S] while the cache's lock is held.
template <typename W>
cudaError_t active_clusters(long long smem, int* clusters) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(occupancy_mutex);
  for (const Occupancy& o : occupancy_cache)
    if (o.device == device && o.word_bytes == int(sizeof(W)) &&
        o.smem == smem) {
      std::copy(o.clusters, o.clusters + kMaxCluster + 1, clusters);
      return cudaSuccess;
    }
  Occupancy o{device, int(sizeof(W)), smem, {}};
  for (int S = 1; S <= kMaxCluster; ++S) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = unsigned(S);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(unsigned(S));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = size_t(smem);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, tlwe_keyswitch_sum_kernel<W>,
                                       &cfg) != cudaSuccess) {
      cudaGetLastError();  // a size the card refuses: none fit
      n = 0;
    }
    o.clusters[S] = n;
  }
  occupancy_cache.push_back(o);
  std::copy(o.clusters, o.clusters + kMaxCluster + 1, clusters);
  return cudaSuccess;
}

struct Plan {
  Tiling t;
  int tiles, slices, pairs, chunks, S, active;
  int clusters[kMaxCluster + 1];  // resident at once, by cluster size
};

// The tiling and the cluster size S for this shape on the current card.
template <typename W>
cudaError_t make_plan(int B, int n_rows, int base_m1, int width, Plan& p) {
  p = Plan{};
  p.t = tiling(base_m1);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (p.t.smem > optin - kStaticSmem) return cudaErrorInvalidValue;
  if ((err = prepare<W>(p.t.smem)) != cudaSuccess) return err;
  if ((err = active_clusters<W>(p.t.smem, p.clusters)) != cudaSuccess)
    return err;
  p.tiles = (B + kTile - 1) / kTile;
  p.slices = (width + kCols<W> - 1) / kCols<W>;
  if ((long long)p.tiles * p.slices * kMaxCluster > INT_MAX)
    return cudaErrorInvalidValue;
  p.pairs = p.tiles * p.slices;
  p.chunks = (n_rows + p.t.rows - 1) >> p.t.log_rows;
  long long best = LLONG_MAX;
  for (int S = 1; S <= kMaxCluster && (S == 1 || S <= p.chunks); ++S) {
    const int c = p.clusters[S];
    if (c <= 0) continue;
    const long long waves = (p.pairs + c - 1) / c;
    const long long cost = waves * ((p.chunks + S - 1) / S + kEpilogueChunks);
    if (cost < best) {
      best = cost;
      p.S = S;
      p.active = c;
    }
  }
  return p.S ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename W>
cudaError_t launch(const int32_t* dig, const void* ab, void* out, int B,
                   int n_rows, int base_m1, int width, cudaStream_t stream) {
  Plan p;
  cudaError_t err = make_plan<W>(B, n_rows, base_m1, width, p);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(p.S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(unsigned(p.pairs * p.S));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(p.t.smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, tlwe_keyswitch_sum_kernel<W>, dig,
                           static_cast<const W*>(ab), static_cast<W*>(out),
                           B, n_rows, base_m1, width, p.t.log_rows,
                           int(p.t.table_bytes), int(p.t.stage_bytes),
                           p.tiles);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename W>
cudaError_t schedule(int B, int n_rows, int base_m1, int width, int* out) {
  Plan p;
  cudaError_t err = make_plan<W>(B, n_rows, base_m1, width, p);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tlwe_keyswitch_sum_kernel<W>, kThreads, size_t(p.t.smem));
  if (err != cudaSuccess) return err;
  const int v[] = {kTile, kCols<W>, p.t.rows, kStages,
                   int(p.t.stage_bytes), int(p.t.smem), p.tiles, p.slices,
                   p.S, p.pairs * p.S, p.active, per_sm, kThreads,
                   kEpilogueChunks};
  constexpr int n = int(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < n; ++i) out[i] = v[i];
  for (int S = 1; S <= kMaxCluster; ++S) out[n + S - 1] = p.clusters[S];
  return cudaSuccess;
}

bool valid(int B, int n_rows, int base_m1, int width, int word_bits) {
  return B >= 0 && n_rows >= 0 && base_m1 >= 1 && width >= 0 &&
         (word_bits == 32 || word_bits == 64);
}

}  // namespace

extern "C" {

// dig [B, n_rows] int32 (n_rows = n_in * t); ab [n_rows, base_m1, width]
// and out [B, width] (fully written) u64 words (word_bits 64) or u32 words
// (word_bits 32).  Returns the launch's cudaGetLastError() code
// (cudaErrorInvalidValue where a chunk's ring does not fit a block's
// shared memory: base-1 above about 145).
int tlwe_keyswitch_sum_launch(const void* dig, const void* ab, void* out,
                              int B, int n_rows, int base_m1, int width,
                              int word_bits, void* stream) {
  if (!valid(B, n_rows, base_m1, width, word_bits))
    return int(cudaErrorInvalidValue);
  if (B == 0 || width == 0) return int(cudaSuccess);
  const auto* d = static_cast<const int32_t*>(dig);
  const auto st = static_cast<cudaStream_t>(stream);
  return int(word_bits == 32
                 ? launch<uint32_t>(d, ab, out, B, n_rows, base_m1, width, st)
                 : launch<uint64_t>(d, ab, out, B, n_rows, base_m1, width,
                                    st));
}

// The launch's schedule for this shape on the current card, into out[30]:
// tile (ciphertexts per block), slice (columns per block), chunk rows,
// stages, stage bytes, shared bytes per block, tiles, slices, cluster size
// S, blocks, clusters resident at once, blocks resident per SM, threads,
// the epilogue's weight in chunks when S is chosen, then the clusters of
// S = 1..16 blocks the runtime can hold at once.
int tlwe_keyswitch_schedule(int B, int n_rows, int base_m1, int width,
                            int word_bits, int* out) {
  if (!valid(B, n_rows, base_m1, width, word_bits) || B == 0 || width == 0)
    return int(cudaErrorInvalidValue);
  return int(word_bits == 32
                 ? schedule<uint32_t>(B, n_rows, base_m1, width, out)
                 : schedule<uint64_t>(B, n_rows, base_m1, width, out));
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
