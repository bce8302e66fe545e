// Device helpers shared by the port's CUDA kernels (sm_90a): 32-bit modular
// products, gadget digits, the negacyclic rotation, and where a block's
// buffers live.  The kernels' NTTs and Garner run on K1's schedule
// (rotate_sched.cuh).
//
// Counterparts of the TPU package's kernel helpers (ops/pbs_kernel.py):
// `_shoup_lazy` (108), `_barrett_lazy` (125), `_decompose_digit` (661),
// `_negacyclic_rotate_limbs` (998) and `_limbs_to_resi` (1694), and the
// one-limb (TORUS32) form `_negacyclic_rotate_limb32` (1099).  Torus words
// are the type W: uint64_t at the 64-bit torus, uint32_t at the 32-bit one,
// and every word operation wraps mod 2^(8 sizeof W).  Every function here
// returns canonical residues in [0, p), so any kernel built from them gives
// the same words as the plain PyTorch versions.
//
// Each kernel source includes this header and is compiled into its own
// shared library, so everything here has internal linkage.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 5;

// The kernel plan's constants, read from the int64 host array that
// `PBSKernelPlan.host_consts` builds (see `parse_consts`).
struct PbsConsts {
  uint32_t p[kMaxP], ninv[kMaxP], ninvs[kMaxP];
  uint32_t cinv[kMaxP], cinvs[kMaxP];
  uint32_t gw[kMaxP][kMaxP], gws[kMaxP][kMaxP];
  // runtime-operand products and the centred u64 -> residue reduction
  uint32_t mup[kMaxP];          // floor(2^62 / p) - 2^32
  uint32_t red1[kMaxP];         // floor(2^32 / p), Shoup companion of 1
  uint32_t c32[kMaxP], c32s[kMaxP];  // 2^32 mod p and its Shoup companion
  uint32_t c64m[kMaxP];         // 2^64 mod p
  uint64_t offset;              // gadget offset (rounded)
  int N, logN, C, l, Bg_bit, P;
};

// consts: N, k, l, Bg_bit, P, offset (u64 bits), then p[P], ninv[P],
// ninvs[P], cinv[P], cinvs[P], gw[P*P], gws[P*P], mup[P], red1[P], c32[P],
// c32s[P], c64m[P].  Returns false on a configuration no kernel takes.
inline bool parse_consts(const int64_t* consts, PbsConsts& K) {
  K = PbsConsts{};
  K.N = int(consts[0]);
  K.C = int(consts[1]) + 1;
  K.l = int(consts[2]);
  K.Bg_bit = int(consts[3]);
  K.P = int(consts[4]);
  K.offset = uint64_t(consts[5]);
  const int P = K.P;
  if (P < 2 || P > kMaxP || K.N < 4 || (K.N & (K.N - 1))) return false;
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
    const int64_t* e = c + 5 * P + 2 * P * P;
    K.mup[m] = uint32_t(e[m]);
    K.red1[m] = uint32_t(e[P + m]);
    K.c32[m] = uint32_t(e[2 * P + m]);
    K.c32s[m] = uint32_t(e[3 * P + m]);
    K.c64m[m] = uint32_t(e[4 * P + m]);
  }
  return true;
}

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

// a * b mod p in [0, p) for two runtime residues a, b < p, with p in
// (2^30 / 1.75, 2^30) and mup = floor(2^62 / p) - 2^32 (the TPU's
// `_barrett_lazy`): z = a b < 2^60, t = floor(z / 2^30) < 2^30,
// q = t + mulhi(t, mup) = floor(t floor(2^62/p) / 2^32) is at most 2 below
// floor(z / p), so z - q p < 3p < 2^32 and two conditional subtractions end
// canonical.  Four 32-bit multiplies.
__device__ __forceinline__ uint32_t barrett(uint32_t a, uint32_t b,
                                            uint32_t p, uint32_t mup) {
  const uint32_t zlo = a * b, zhi = __umulhi(a, b);
  const uint32_t t = (zhi << 2) | (zlo >> 30);
  const uint32_t q = t + __umulhi(t, mup);
  uint32_t r = zlo - q * p;
  r = r >= 2 * p ? r - 2 * p : r;
  return r >= p ? r - p : r;
}

// Residue mod prime m of the centred (signed) representative of the u64
// word x, as `ntt.to_resi_u64` defines it: lo + hi 2^32 - [x >= 2^63] 2^64.
__device__ __forceinline__ uint32_t centred_residue(uint64_t x, int m,
                                                    const PbsConsts& K) {
  const uint32_t p = K.p[m];
  const uint32_t lo = uint32_t(x), hi = uint32_t(x >> 32);
  const uint32_t t0 = shoup(lo, 1u, K.red1[m], p);
  const uint32_t t1 = shoup(hi, K.c32[m], K.c32s[m], p);
  const uint32_t s = add_mod(t0, t1, p);
  return (hi >> 31) ? sub_mod(s, K.c64m[m], p) : s;
}

// The same for a u32 word (the 32-bit torus): lo - [x >= 2^31] 2^32, the
// int32 value of its bits (the TPU's `_limbs_to_resi` with hi None).
__device__ __forceinline__ uint32_t centred_residue(uint32_t x, int m,
                                                    const PbsConsts& K) {
  const uint32_t p = K.p[m];
  const uint32_t s = shoup(x, 1u, K.red1[m], p);
  return (x >> 31) ? sub_mod(s, K.c32[m], p) : s;
}

// Coefficient k of X^a * row (negacyclic, length N, a in [0, 2N]):
// +-row[(k - a) mod N], negated when (k - a) mod 2N >= N; a == 2N is the
// identity.  row may be in shared or global memory.
template <typename W>
__device__ __forceinline__ W rotated_word(const W* row, int k, int a, int N) {
  const int m = (k - a) & (2 * N - 1);
  const W v = row[m & (N - 1)];
  return (m & N) ? W(0) - v : v;
}

// Signed gadget digit d (0-based, most significant first) of the word x
// with the rounded offset already added (the offset of the word's width).
template <typename W>
__device__ __forceinline__ int gadget_digit(W x_plus_offset, int d,
                                            const PbsConsts& K) {
  const int shift = int(8 * sizeof(W)) - (d + 1) * K.Bg_bit;
  const int mask = (1 << K.Bg_bit) - 1, half = 1 << (K.Bg_bit - 1);
  return int((x_plus_offset >> shift) & W(mask)) - half;
}

__device__ __forceinline__ uint32_t small_residue(int digit, uint32_t p) {
  return digit < 0 ? uint32_t(digit + int(p)) : uint32_t(digit);
}

// Where each of a block's buffers lives, as the wrapper placed it
// (`ops/pbs_kernel._place`): buffer i is at byte off[i] of dynamic shared
// memory when off[i] >= 0; it is the block's own slice of the caller's
// tensor (the accumulator, updated in place) when off[i] == -1; and it is at
// byte -off[i] - 2 of the block's slice of the global workspace (stride
// bytes per block) otherwise.  Shared memory is filled in order of traffic,
// up to the card's opt-in limit; a barrier orders a block's global writes
// and reads as it does its shared ones, so the kernels' bodies are the same
// wherever a buffer lives.  Host layout array: smem bytes, stride, off[].
constexpr int kMaxBuf = 6;
struct Layout {
  int64_t smem, stride, off[kMaxBuf];
};

inline Layout parse_layout(const int64_t* layout, int nbuf) {
  Layout L{};
  L.smem = layout[0];
  L.stride = layout[1];
  for (int i = 0; i < nbuf && i < kMaxBuf; ++i) L.off[i] = layout[2 + i];
  return L;
}

// Shared: every buffer is in shared memory (all_shared(L)), which the
// compiler then knows, as it did before buffers could move.
template <bool Shared, typename T>
__device__ __forceinline__ T* buffer(const Layout& L, int i,
                                     unsigned char* smem, unsigned char* ws,
                                     T* home) {
  const int64_t o = L.off[i];
  if (Shared || o >= 0) return reinterpret_cast<T*>(smem + o);
  if (o == -1) return home;
  return reinterpret_cast<T*>(ws + size_t(blockIdx.x) * L.stride + (-o - 2));
}

inline bool all_shared(const Layout& L, int nbuf) {
  for (int i = 0; i < nbuf; ++i)
    if (L.off[i] < 0) return false;
  return true;
}

// Calls f(std::integral_constant<int, P>{}, W{}) for the plan's prime
// count P and the words' type W: uint64_t (word_bits 64) with 2-5 primes,
// uint32_t (word_bits 32) with 2 or 3 (the 32-bit torus's products need 2
// primes at every registered width).  Only those (P, W) pairs are
// instantiated; any other is refused (the wrappers check it first).
template <typename F>
cudaError_t dispatch_pw(int P, int word_bits, F&& f) {
  using P2 = std::integral_constant<int, 2>;
  using P3 = std::integral_constant<int, 3>;
  if (word_bits == 32) {
    switch (P) {
      case 2: return f(P2{}, uint32_t{});
      case 3: return f(P3{}, uint32_t{});
      default: return cudaErrorInvalidValue;
    }
  }
  if (word_bits != 64) return cudaErrorInvalidValue;
  switch (P) {
    case 2: return f(P2{}, uint64_t{});
    case 3: return f(P3{}, uint64_t{});
    case 4: return f(std::integral_constant<int, 4>{}, uint64_t{});
    default: return f(std::integral_constant<int, 5>{}, uint64_t{});
  }
}

// Static __shared__ bytes a kernel may declare besides its dynamic shared
// memory (at most two PbsConsts).
constexpr int kStaticSmem = 1024;
static_assert(2 * sizeof(PbsConsts) <= kStaticSmem, "static shared memory");

}  // namespace

extern "C" {

// The dynamic shared memory a block of these kernels may ask for on
// `device`: the opt-in limit per block less kStaticSmem.
int smem_budget(int device, int* bytes) {
  int optin = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return int(err);
  *bytes = optin - kStaticSmem;
  return int(cudaSuccess);
}

}  // extern "C"
