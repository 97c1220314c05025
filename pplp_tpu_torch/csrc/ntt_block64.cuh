// In-block m62 negacyclic NTT over u64 rows in shared memory, for Hopper
// (sm_90a): the schedule of csrc/ntt_block.cuh on 8-byte words. Included by
// csrc/ntt.cu (the standalone u64 transform kernels); the entry points
// ntt_fwd_block64 / ntt_inv_block64 are device functions that a fused m62
// multiply kernel can include as csrc/behz.cu includes the m31 ones.
//
// Arithmetic (the m62 profile, 2^32 <= q < 2^62), as the stage engine
// pplp_tpu/ops/ntt.py:205-267 runs it on (lo, hi) u32 pairs: Shoup products
// x * w mod q = w x - umul64hi(w', x) q in wrapping u64 (w' =
// floor(w 2^64 / q), valid for any x < 2^64); Harvey-lazy Cooley-Tukey
// forward with values in [0, 4q) (4q < 2^64), Gentleman-Sande inverse in
// [0, 2q) with the n^-1 Shoup product; canonical in, canonical out; the
// spectrum in the stage engine's bit-reversed order.
//
// Schedule (modelled op for op in tests/test_torch_ntt_schedule.py):
//
// * Register-radix rounds of kk <= k = kRadixLog64 stages, the groups,
//   strides and twiddle indices of ntt_block.cuh: a forward group at stage s
//   is base + m * T, T = 2^(logm - s - kk), base = hi * T * 2^kk + lo; local
//   stage j pairs (m, m + 2^(kk-1-j)) with the twiddle (r << j) +
//   (m >> (kk - j)). The inverse mirrors it. One shared-memory exchange and
//   one __syncthreads() per round; the remainder stages run first in the
//   forward and last in the inverse, so the stride-1 round has k stages.
// * Sub-transforms. A block may hold only the 2^logm-point part `top` of a
//   larger row (top = 1: the whole row; the halves of a row after its first
//   stage are the parts 2 and 3, and so on down the tree). The twiddle node
//   of a group is then r = (top << s) + hi in the forward and
//   (top << (logm - s - kk)) + hi in the inverse, and the transform may
//   begin (forward) or end (inverse) at an inner stage. The kernels that
//   spread a row over a thread block cluster use it: each block holds one
//   part (a u64 row of n = 32768 is 256 KB, over the 227 KB of a block).
// * Twiddles are (w, w_shoup) pairs interleaved as ulonglong2 (int64
//   [L, n, 2], ops/ntt_cuda.py::table_buffers): one 16-byte read-only load
//   per pair, one level of the round's twiddle tree at a time.
// * Shared memory holds element i of a row at word swz64(i): 16-byte units
//   (two words) XOR-permuted within each 128-byte line. A warp's 8-byte
//   accesses in a strided round are at most 2-way bank conflicted; the
//   stride-1 round and the row I/O move 16-byte vectors, conflict-free.
//
// What bounds it: at the seal shapes bytes and integer work sit at the
// crossover (a u64 Shoup product is about ten 32-bit multiplies,
// measure_multiply.U64_PRODUCT_MULS, against 16 B of row I/O per residue),
// so a row crosses device memory once and every stage runs in registers.

#pragma once

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ntt_block.cuh"

namespace pplp {

// Stages per register round and the most threads of a block. A group of
// 2^k u64 values is 2^(k+1) registers and a twiddle level up to 2^(k+1):
// k = 3 fits the 64 registers a thread has when two blocks of 512 share an
// SM. k = 4 on 512 threads (one block per SM) measured the same as k = 3 on
// an H100, within 2%, before the blocks were halved.
constexpr int kRadixLog64 = 3;
constexpr int kMaxThreads64 = 512;
static_assert(kRadixLog64 == 3, "the remainder rounds below have 1 or 2 stages");

__device__ __forceinline__ uint64_t csub64(uint64_t x, uint64_t m) {
  return x >= m ? x - m : x;
}

// x * w mod q in [0, 2q) for any x < 2^64 (w_shoup = floor(w * 2^64 / q)).
__device__ __forceinline__ uint64_t shoup_lazy64(uint64_t x, uint64_t w, uint64_t w_shoup,
                                                 uint64_t q) {
  return w * x - __umul64hi(w_shoup, x) * q;
}

// One residue through the read-only path.
__device__ __forceinline__ uint64_t ldg64(const uint64_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ int swz64(int i) { return i ^ (((i >> 4) & 7) << 1); }

__device__ __forceinline__ uint64_t* dyn_smem64() {
  return reinterpret_cast<uint64_t*>(dyn_smem());
}

// ---- row I/O (n / 2 16-byte units per row) -------------------------------

// `rows` rows of 2^logm residues, `stride` words apart in device memory, into
// consecutive shared-memory rows by 16-byte asynchronous copies (an int64
// residue already is the u64's bits). The caller waits with
// cp_async_wait_all() and a __syncthreads().
__device__ __forceinline__ void load_rows_async64(const uint64_t* __restrict__ x,
                                                  int64_t stride, uint64_t* a, int rows,
                                                  int logm) {
  const int lu = logm - 1;  // log2 of the units per row
  for (int c = threadIdx.x; c < (rows << lu); c += blockDim.x) {
    const int r = c >> lu;
    const int i = (c & ((1 << lu) - 1)) << 1;
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(a + (r << logm) + swz64(i)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(x + r * stride + i)
                 : "memory");
  }
}

// The rows back to device memory as 16-byte vectors.
__device__ __forceinline__ void store_rows64(const uint64_t* a, uint64_t* __restrict__ y,
                                             int64_t stride, int rows, int logm) {
  const int lu = logm - 1;
  for (int c = threadIdx.x; c < (rows << lu); c += blockDim.x) {
    const int r = c >> lu;
    const int i = (c & ((1 << lu) - 1)) << 1;
    *reinterpret_cast<ulonglong2*>(y + r * stride + i) =
        *reinterpret_cast<const ulonglong2*>(a + (r << logm) + swz64(i));
  }
}

// ---- one group's registers -----------------------------------------------

template <int KK>
__device__ __forceinline__ void load_group64(const uint64_t* row, int base, int logt,
                                             uint64_t (&x)[1 << KK]) {
  if (logt == 0) {
#pragma unroll
    for (int c = 0; c < (1 << KK); c += 2) {
      const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(row + swz64(base + c));
      x[c] = v.x;
      x[c + 1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int m = 0; m < (1 << KK); ++m) x[m] = row[swz64(base + (m << logt))];
}

template <int KK>
__device__ __forceinline__ void store_group64(uint64_t* row, int base, int logt,
                                              const uint64_t (&x)[1 << KK]) {
  if (logt == 0) {
#pragma unroll
    for (int c = 0; c < (1 << KK); c += 2) {
      *reinterpret_cast<ulonglong2*>(row + swz64(base + c)) = make_ulonglong2(x[c], x[c + 1]);
    }
    return;
  }
#pragma unroll
  for (int m = 0; m < (1 << KK); ++m) row[swz64(base + (m << logt))] = x[m];
}

// ---- the stages of one round, in registers -------------------------------

// The 2^lev twiddle pairs of one level of a group's twiddle tree,
// t[(1 << lev) - 1 + i] = tw[(r << lev) + i], loaded right before the local
// stage that reads them.
template <int KK>
__device__ __forceinline__ void load_level64(const ulonglong2* __restrict__ tw, int r, int lev,
                                             ulonglong2 (&t)[(1 << KK) - 1]) {
#pragma unroll
  for (int i = 0; i < (1 << (KK - 1)); ++i) {
    if (i < (1 << lev)) t[(1 << lev) - 1 + i] = __ldg(tw + (r << lev) + i);
  }
}

// KK forward stages on a group whose twiddle node is r: [0, 4q) in and out.
template <int KK>
__device__ __forceinline__ void fwd_stages64(uint64_t (&x)[1 << KK],
                                             const ulonglong2* __restrict__ tw, int r,
                                             uint64_t q) {
  const uint64_t two_q = 2 * q;
  ulonglong2 t[(1 << KK) - 1];
#pragma unroll
  for (int j = 0; j < KK; ++j) {  // local stage j: pairs (u, u + 2^h)
    load_level64<KK>(tw, r, j, t);
#pragma unroll
    for (int b = 0; b < (1 << (KK - 1)); ++b) {
      const int h = KK - 1 - j;
      const int i = b >> h;  // the butterfly's block within the round
      const int u = (i << (h + 1)) + (b & ((1 << h) - 1));
      const ulonglong2 w = t[(1 << j) - 1 + i];
      const uint64_t xu = csub64(x[u], two_q);
      const uint64_t mv = shoup_lazy64(x[u + (1 << h)], w.x, w.y, q);
      x[u] = xu + mv;
      x[u + (1 << h)] = xu + two_q - mv;
    }
  }
}

// KK inverse stages on a group whose twiddle node is r: [0, 2q) in and out.
template <int KK>
__device__ __forceinline__ void inv_stages64(uint64_t (&x)[1 << KK],
                                             const ulonglong2* __restrict__ itw, int r,
                                             uint64_t q) {
  const uint64_t two_q = 2 * q;
  ulonglong2 t[(1 << KK) - 1];
#pragma unroll
  for (int j = 0; j < KK; ++j) {  // local stage j: pairs (u, u + 2^j)
    load_level64<KK>(itw, r, KK - 1 - j, t);
#pragma unroll
    for (int b = 0; b < (1 << (KK - 1)); ++b) {
      const int i = b >> j;
      const int u = (i << (j + 1)) + (b & ((1 << j) - 1));
      const ulonglong2 w = t[(1 << (KK - 1 - j)) - 1 + i];
      const uint64_t xu = x[u];
      const uint64_t xv = x[u + (1 << j)];
      x[u] = csub64(xu + xv, two_q);
      x[u + (1 << j)] = shoup_lazy64(xu + two_q - xv, w.x, w.y, q);
    }
  }
}

// Lazy forward values [0, 4q) -> canonical.
template <int KK>
__device__ __forceinline__ void canonical64(uint64_t (&x)[1 << KK], uint64_t q) {
#pragma unroll
  for (int m = 0; m < (1 << KK); ++m) x[m] = csub64(csub64(x[m], 2 * q), q);
}

// The inverse's n^-1 product: [0, 2q) -> canonical.
template <int KK>
__device__ __forceinline__ void scale64(uint64_t (&x)[1 << KK], uint64_t n_inv,
                                        uint64_t n_inv_shoup, uint64_t q) {
#pragma unroll
  for (int m = 0; m < (1 << KK); ++m) {
    x[m] = csub64(shoup_lazy64(x[m], n_inv, n_inv_shoup, q), q);
  }
}

// ---- rounds through shared memory ------------------------------------------

// Forward stages s .. s + KK - 1 of the part `top` on `rows` rows (row
// stride 2^logm) of one limb; the round that reaches stride 1 leaves
// canonical values.
template <int KK>
__device__ __forceinline__ void fwd_round64(uint64_t* a, int rows, int logm, int s, int top,
                                            const ulonglong2* __restrict__ tw, uint64_t q) {
  const int logt = logm - s - KK;
  const int lg = logm - KK;  // log2 of the groups per row
  for (int gi = threadIdx.x; gi < (rows << lg); gi += blockDim.x) {
    const int g = gi & ((1 << lg) - 1);
    const int hi = g >> logt;
    const int base = (hi << (logt + KK)) + (g & ((1 << logt) - 1));
    uint64_t* row = a + ((gi >> lg) << logm);
    uint64_t x[1 << KK];
    load_group64<KK>(row, base, logt, x);
    fwd_stages64<KK>(x, tw, (top << s) + hi, q);
    if (logt == 0) canonical64<KK>(x, q);
    store_group64<KK>(row, base, logt, x);
  }
  __syncthreads();
}

// Inverse stages s .. s + KK - 1 of the part `top`; the last round of a
// whole transform (top = 1) multiplies by n^-1.
template <int KK>
__device__ __forceinline__ void inv_round64(uint64_t* a, int rows, int logm, int s, int top,
                                            const ulonglong2* __restrict__ itw, uint64_t q,
                                            uint64_t n_inv, uint64_t n_inv_shoup) {
  const int logt = s;
  const int lg = logm - KK;
  for (int gi = threadIdx.x; gi < (rows << lg); gi += blockDim.x) {
    const int g = gi & ((1 << lg) - 1);
    const int hi = g >> logt;
    const int base = (hi << (logt + KK)) + (g & ((1 << logt) - 1));
    uint64_t* row = a + ((gi >> lg) << logm);
    uint64_t x[1 << KK];
    load_group64<KK>(row, base, logt, x);
    inv_stages64<KK>(x, itw, (top << (logm - s - KK)) + hi, q);
    if (top == 1 && s + KK == logm) scale64<KK>(x, n_inv, n_inv_shoup, q);
    store_group64<KK>(row, base, logt, x);
  }
  __syncthreads();
}

// ---- whole transforms --------------------------------------------------------

// Forward stages s_begin .. logm - 1 of the part `top` on `rows` rows of
// one limb in shared memory ([0, 4q) in, canonical out; the whole transform
// with the defaults). Every thread of the block calls it after a
// __syncthreads() that makes the rows visible; it ends with one.
__device__ __forceinline__ void ntt_fwd_block64(uint64_t* a, int rows, int logm,
                                                const ulonglong2* __restrict__ tw, uint64_t q,
                                                int top = 1, int s_begin = 0) {
  constexpr int K = kRadixLog64;
  int s = s_begin;
  const int rem = (logm - s) % K;
  if (rem == 1) fwd_round64<1>(a, rows, logm, s, top, tw, q);
  if (rem == 2) fwd_round64<2>(a, rows, logm, s, top, tw, q);
  for (s += rem; s < logm; s += K) fwd_round64<K>(a, rows, logm, s, top, tw, q);
}

// Inverse stages 0 .. s_end - 1 of the part `top` (s_end = 0: all logm,
// with the n^-1 product), the same contract: canonical or [0, 2q) in,
// canonical out of the whole transform, [0, 2q) out of a part.
__device__ __forceinline__ void ntt_inv_block64(uint64_t* a, int rows, int logm,
                                                const ulonglong2* __restrict__ itw, uint64_t q,
                                                uint64_t n_inv, uint64_t n_inv_shoup,
                                                int top = 1, int s_end = 0) {
  constexpr int K = kRadixLog64;
  if (s_end == 0) s_end = logm;
  int s = 0;
  for (; s + K <= s_end; s += K) {
    inv_round64<K>(a, rows, logm, s, top, itw, q, n_inv, n_inv_shoup);
  }
  const int rem = s_end - s;
  if (rem == 1) inv_round64<1>(a, rows, logm, s, top, itw, q, n_inv, n_inv_shoup);
  if (rem == 2) inv_round64<2>(a, rows, logm, s, top, itw, q, n_inv, n_inv_shoup);
}

// ---- a row across a cluster of 2^CL blocks -----------------------------------

// After the forward's first KK >= CL stages the 2^CL parts of a row (n >> CL
// contiguous points each) are independent transforms: block `rank` of the
// cluster holds the part 2^CL + rank in its shared memory. Element m of a
// first-round group lies in the part m >> (KK - CL), at this word of it.
template <int KK, int CL>
__device__ __forceinline__ int part_word(int m, int logt, int lo) {
  return swz64(((m & ((1 << (KK - CL)) - 1)) << logt) + lo);
}

// The forward's first KK stages over a whole row in device memory
// (canonical), each block taking its share of the n >> KK groups: the 2^KK
// elements of a group are n >> KK apart, loaded straight into registers
// (neighbouring threads on neighbouring addresses), and go lazily into the
// shared memory of the block that holds their part, this one's or a peer's
// (distributed shared memory). Begins and ends with a cluster barrier: every
// block runs before any writes into it, and every part is whole after.
template <int KK, int CL>
__device__ __forceinline__ void fwd_first_round_cluster64(
    const uint64_t* __restrict__ x, uint64_t* a, int logn, const ulonglong2* __restrict__ tw,
    uint64_t q, cooperative_groups::cluster_group& cluster) {
  static_assert(KK >= CL, "the parts are independent only after CL stages");
  const int logt = logn - KK;
  const int per_block = 1 << (logt - CL);
  const int first = cluster.block_rank() * per_block;
  cluster.sync();
  for (int g = threadIdx.x; g < per_block; g += blockDim.x) {
    const int lo = first + g;
    uint64_t v[1 << KK];
#pragma unroll
    for (int m = 0; m < (1 << KK); ++m) v[m] = ldg64(x + lo + (m << logt));
    fwd_stages64<KK>(v, tw, 1, q);
#pragma unroll
    for (int m = 0; m < (1 << KK); ++m) {
      *cluster.map_shared_rank(a + part_word<KK, CL>(m, logt, lo), m >> (KK - CL)) = v[m];
    }
  }
  cluster.sync();
}

// The inverse's last KK stages and the n^-1 product, mirrored: each group
// reads its elements from the blocks' shared memory ([0, 2q)) and writes
// canonical residues to device memory. A cluster barrier before (every
// part's local stages are done) and after (no block exits while a peer
// still reads its shared memory).
template <int KK, int CL>
__device__ __forceinline__ void inv_last_round_cluster64(
    uint64_t* a, uint64_t* __restrict__ y, int logn, const ulonglong2* __restrict__ itw,
    uint64_t q, uint64_t n_inv, uint64_t n_inv_shoup,
    cooperative_groups::cluster_group& cluster) {
  static_assert(KK >= CL, "the parts are independent only before the last CL stages");
  const int logt = logn - KK;
  const int per_block = 1 << (logt - CL);
  const int first = cluster.block_rank() * per_block;
  cluster.sync();
  for (int g = threadIdx.x; g < per_block; g += blockDim.x) {
    const int lo = first + g;
    uint64_t v[1 << KK];
#pragma unroll
    for (int m = 0; m < (1 << KK); ++m) {
      v[m] = *cluster.map_shared_rank(a + part_word<KK, CL>(m, logt, lo), m >> (KK - CL));
    }
    inv_stages64<KK>(v, itw, 1, q);
    scale64<KK>(v, n_inv, n_inv_shoup, q);
#pragma unroll
    for (int m = 0; m < (1 << KK); ++m) y[lo + (m << logt)] = v[m];
  }
  cluster.sync();
}

}  // namespace pplp
