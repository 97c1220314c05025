// In-block m31 negacyclic NTT over u32 rows in shared memory, for Hopper
// (sm_90a). Included by csrc/ntt.cu (the standalone transform kernels) and
// csrc/behz.cu (the fused multiply kernels), so both run one schedule.
//
// Arithmetic (the m31 profile, every q < 2^30), unchanged from the stage
// engine pplp_tpu/ops/ntt.py::forward / inverse: Shoup products
// x * w mod q = w x - umulhi(w', x) q in wrapping u32 (valid for any
// x < 2^32); Harvey-lazy Cooley-Tukey forward with values in [0, 4q),
// Gentleman-Sande inverse in [0, 2q) with the n^-1 Shoup product; canonical
// in, canonical out. The spectrum is in the stage engine's bit-reversed
// order (the port's only order).
//
// Schedule (modelled op for op in tests/test_torch_ntt_schedule.py):
//
// * Register-radix rounds. A round of kk <= k stages (k = kRadixLog = 4)
//   gives each thread a group of 2^kk elements of a row: at forward stage s the group is base + m * T, T = n >> (s + kk),
//   base = hi * T * 2^kk + lo (lo < T, hi < 2^s). All kk stages run in
//   registers; local stage j pairs (m, m + 2^(kk-1-j)) with the twiddle
//   index (r << j) + (m >> (kk - j)), r = 2^s + hi. The inverse mirrors it
//   (T = 2^s, r = (n >> (s + kk)) + hi, local stage j pairs (m, m + 2^j)
//   with index (r << (kk-1-j)) + (m >> (j + 1))). The row goes through
//   shared memory once per round and one __syncthreads() ends each round:
//   3 exchanges at n = 4096 instead of 12, 4 at n = 32768 instead of 15. The forward runs the logn mod k remainder stages first
//   and the inverse last, so the stride-1 round always has k stages.
// * Twiddles are read once per group and round through the read-only
//   path, as (w, w_shoup) pairs interleaved in one uint2 table per limb
//   (ops/ntt_cuda.py::table_buffers packs it), each level of the round's
//   twiddle tree right before the local stage that uses it. Flat butterfly
//   loops keep every register index a compile-time constant.
// * Shared memory holds element i of a row at word swz(i): 16-byte units
//   XOR-permuted within each 128-byte line. Strided rounds are at most
//   2-way bank conflicted; the stride-1 round (the forward's last, the
//   inverse's first) reads and writes its 2^k contiguous elements as
//   16-byte vectors, conflict-free; row I/O moves 16-byte vectors too.
//
// Tensor cores are not used: a 30-bit modular product needs an exact
// 60-bit integer result, which no tensor-core type gives. An int8 wgmma
// formulation (each residue split into 4 bytes, the transform as ~16 int8
// products per tile, as in TensorFHE) is a redesign of its own.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pplp {

constexpr int kMaxThreads = 512;       // the fused kernels' blocks
// Stages per register round. k = 3 (more exchanges, the same products)
// made a batch-256 multiply + relinearization 6% slower on an H100.
constexpr int kRadixLog = 4;
constexpr int kMaxRowThreads = 1024;   // one row per block (n = 32768: 1 block per SM)

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t m) {
  return x >= m ? x - m : x;
}

// x * w mod q in [0, 2q) for any x < 2^32 (w_shoup = floor(w * 2^32 / q)).
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint32_t w, uint32_t w_shoup,
                                               uint32_t q) {
  return w * x - __umulhi(w_shoup, x) * q;
}

// x mod q for any x < 2^64, mu = floor(2^64 / q): the estimate is the
// quotient or one less, so one conditional subtract makes it canonical.
__device__ __forceinline__ uint32_t barrett(uint64_t x, uint32_t q, uint64_t mu) {
  const uint64_t est = __umul64hi(x, mu);
  return csub(static_cast<uint32_t>(x - est * q), q);
}

__device__ __forceinline__ int swz(int i) { return i ^ (((i >> 5) & 7) << 2); }

__device__ __forceinline__ uint32_t* dyn_smem() {
  extern __shared__ uint4 pplp_smem[];
  return reinterpret_cast<uint32_t*>(pplp_smem);
}

__device__ __forceinline__ uint4 ld4(const uint32_t* row, int i) {
  return *reinterpret_cast<const uint4*>(row + swz(i));
}

__device__ __forceinline__ void st4(uint32_t* row, int i, uint4 v) {
  *reinterpret_cast<uint4*>(row + swz(i)) = v;
}

// ---- row I/O (n / 4 16-byte units per row) -------------------------------

// Four int64 residues p[i .. i + 3] narrowed to u32 (two 16-byte loads).
__device__ __forceinline__ uint4 ld_i64x4(const int64_t* __restrict__ p, int i) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p + i));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p + i) + 1);
  return make_uint4(static_cast<uint32_t>(a.x), static_cast<uint32_t>(a.y),
                    static_cast<uint32_t>(b.x), static_cast<uint32_t>(b.y));
}

// u32 residues -> u32 row by 16-byte asynchronous copies; the caller waits
// with cp_async_wait_all() (so several rows can be in flight at once).
__device__ __forceinline__ void load_row_async(const uint32_t* __restrict__ x, uint32_t* row,
                                               int n) {
  for (int c = threadIdx.x; c < n / 4; c += blockDim.x) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(row + swz(4 * c)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(x + 4 * c)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// int64 residues -> u32 row, narrowing on load.
__device__ __forceinline__ void load_row(const int64_t* __restrict__ x, uint32_t* row, int n) {
  for (int c = threadIdx.x; c < n / 4; c += blockDim.x) st4(row, 4 * c, ld_i64x4(x, 4 * c));
}

__device__ __forceinline__ void load_row(const uint32_t* __restrict__ x, uint32_t* row, int n) {
  load_row_async(x, row, n);
  cp_async_wait_all();
}

// u32 row -> int64 residues, widening on store.
__device__ __forceinline__ void store_row(const uint32_t* row, int64_t* __restrict__ y, int n) {
  longlong2* y2 = reinterpret_cast<longlong2*>(y);
  for (int c = threadIdx.x; c < n / 4; c += blockDim.x) {
    const uint4 v = ld4(row, 4 * c);
    y2[2 * c] = make_longlong2(v.x, v.y);
    y2[2 * c + 1] = make_longlong2(v.z, v.w);
  }
}

__device__ __forceinline__ void store_row(const uint32_t* row, uint32_t* __restrict__ y, int n) {
  uint4* y4 = reinterpret_cast<uint4*>(y);
  for (int c = threadIdx.x; c < n / 4; c += blockDim.x) y4[c] = ld4(row, 4 * c);
}

// ---- one group's registers -----------------------------------------------

template <int KK>
__device__ __forceinline__ void load_group(const uint32_t* row, int base, int logt,
                                           uint32_t (&x)[1 << KK]) {
  if constexpr (KK >= 2) {
    if (logt == 0) {
#pragma unroll
      for (int c = 0; c < (1 << KK); c += 4) {
        const uint4 v = ld4(row, base + c);
        x[c] = v.x;
        x[c + 1] = v.y;
        x[c + 2] = v.z;
        x[c + 3] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int m = 0; m < (1 << KK); ++m) x[m] = row[swz(base + (m << logt))];
}

template <int KK>
__device__ __forceinline__ void store_group(uint32_t* row, int base, int logt,
                                            const uint32_t (&x)[1 << KK]) {
  if constexpr (KK >= 2) {
    if (logt == 0) {
#pragma unroll
      for (int c = 0; c < (1 << KK); c += 4) {
        st4(row, base + c, make_uint4(x[c], x[c + 1], x[c + 2], x[c + 3]));
      }
      return;
    }
  }
#pragma unroll
  for (int m = 0; m < (1 << KK); ++m) row[swz(base + (m << logt))] = x[m];
}

// ---- rounds ----------------------------------------------------------------

// The 2^lev twiddle pairs of one level of a group's twiddle tree,
// t[(1 << lev) - 1 + i] = tw[(r << lev) + i], loaded right before the
// local stage that reads them (fewer live registers than the whole tree).
template <int KK>
__device__ __forceinline__ void load_level(const uint2* __restrict__ tw, int r, int lev,
                                           uint2 (&t)[(1 << KK) - 1]) {
#pragma unroll
  for (int i = 0; i < (1 << (KK - 1)); ++i) {
    if (i < (1 << lev)) t[(1 << lev) - 1 + i] = __ldg(tw + (r << lev) + i);
  }
}

// Forward stages s .. s + KK - 1 on `rows` rows (row stride n) of one limb.
template <int KK>
__device__ __forceinline__ void fwd_round(uint32_t* a, int rows, int logn, int s,
                                          const uint2* __restrict__ tw, uint32_t q) {
  const int logt = logn - s - KK;
  const int lg = logn - KK;  // log2 of the groups per row
  const uint32_t two_q = 2u * q;
  for (int gi = threadIdx.x; gi < (rows << lg); gi += blockDim.x) {
    const int g = gi & ((1 << lg) - 1);
    const int hi = g >> logt;
    const int base = (hi << (logt + KK)) + (g & ((1 << logt) - 1));
    uint32_t* row = a + ((gi >> lg) << logn);
    uint32_t x[1 << KK];
    uint2 t[(1 << KK) - 1];
    const int r = (1 << s) + hi;
    load_group<KK>(row, base, logt, x);
#pragma unroll
    for (int j = 0; j < KK; ++j) {  // local stage j: pairs (u, u + 2^h)
      load_level<KK>(tw, r, j, t);
#pragma unroll
      for (int b = 0; b < (1 << (KK - 1)); ++b) {
        const int h = KK - 1 - j;
        const int i = b >> h;  // the butterfly's block within the round
        const int u = (i << (h + 1)) + (b & ((1 << h) - 1));
        const uint2 w = t[(1 << j) - 1 + i];
        const uint32_t xu = csub(x[u], two_q);
        const uint32_t mv = shoup_lazy(x[u + (1 << h)], w.x, w.y, q);
        x[u] = xu + mv;
        x[u + (1 << h)] = xu + two_q - mv;
      }
    }
    if (logt == 0) {  // the last round: canonical out
#pragma unroll
      for (int m = 0; m < (1 << KK); ++m) x[m] = csub(csub(x[m], two_q), q);
    }
    store_group<KK>(row, base, logt, x);
  }
  __syncthreads();
}

// Inverse stages s .. s + KK - 1; the last round multiplies by n^-1.
template <int KK>
__device__ __forceinline__ void inv_round(uint32_t* a, int rows, int logn, int s,
                                          const uint2* __restrict__ itw, uint32_t q,
                                          uint32_t n_inv, uint32_t n_inv_shoup) {
  const int logt = s;
  const int lg = logn - KK;
  const uint32_t two_q = 2u * q;
  for (int gi = threadIdx.x; gi < (rows << lg); gi += blockDim.x) {
    const int g = gi & ((1 << lg) - 1);
    const int hi = g >> logt;
    const int base = (hi << (logt + KK)) + (g & ((1 << logt) - 1));
    uint32_t* row = a + ((gi >> lg) << logn);
    uint32_t x[1 << KK];
    uint2 t[(1 << KK) - 1];
    const int r = (1 << (logn - s - KK)) + hi;
    load_group<KK>(row, base, logt, x);
#pragma unroll
    for (int j = 0; j < KK; ++j) {  // local stage j: pairs (u, u + 2^j)
      load_level<KK>(itw, r, KK - 1 - j, t);
#pragma unroll
      for (int b = 0; b < (1 << (KK - 1)); ++b) {
        const int i = b >> j;
        const int u = (i << (j + 1)) + (b & ((1 << j) - 1));
        const uint2 w = t[(1 << (KK - 1 - j)) - 1 + i];
        const uint32_t xu = x[u];
        const uint32_t xv = x[u + (1 << j)];
        x[u] = csub(xu + xv, two_q);
        x[u + (1 << j)] = shoup_lazy(xu + two_q - xv, w.x, w.y, q);
      }
    }
    if (s + KK == logn) {
#pragma unroll
      for (int m = 0; m < (1 << KK); ++m) {
        x[m] = csub(shoup_lazy(x[m], n_inv, n_inv_shoup, q), q);
      }
    }
    store_group<KK>(row, base, logt, x);
  }
  __syncthreads();
}

// ---- whole transforms --------------------------------------------------------

// Forward transform of `rows` rows of one limb in shared memory (canonical
// in and out). Every thread of the block calls it after a __syncthreads()
// that makes the rows visible; it ends with one.
__device__ __forceinline__ void ntt_fwd_block(uint32_t* a, int rows, int logn,
                                              const uint2* __restrict__ tw, uint32_t q) {
  constexpr int K = kRadixLog;
  const int rem = logn % K;
  switch (rem) {
    case 1: fwd_round<1>(a, rows, logn, 0, tw, q); break;
    case 2: fwd_round<2>(a, rows, logn, 0, tw, q); break;
    case 3: fwd_round<3>(a, rows, logn, 0, tw, q); break;
    default: break;
  }
  for (int s = rem; s < logn; s += K) fwd_round<K>(a, rows, logn, s, tw, q);
}

// Inverse transform of `rows` rows of one limb, the same contract.
__device__ __forceinline__ void ntt_inv_block(uint32_t* a, int rows, int logn,
                                              const uint2* __restrict__ itw, uint32_t q,
                                              uint32_t n_inv, uint32_t n_inv_shoup) {
  constexpr int K = kRadixLog;
  int s = 0;
  for (; s + K <= logn; s += K) inv_round<K>(a, rows, logn, s, itw, q, n_inv, n_inv_shoup);
  switch (logn - s) {
    case 1: inv_round<1>(a, rows, logn, s, itw, q, n_inv, n_inv_shoup); break;
    case 2: inv_round<2>(a, rows, logn, s, itw, q, n_inv, n_inv_shoup); break;
    case 3: inv_round<3>(a, rows, logn, s, itw, q, n_inv, n_inv_shoup); break;
    default: break;
  }
}

// Threads of a block whose rounds cover `elements` = rows * n: one per
// group of 16, at least a warp, at most `most`.
inline int block_threads(int elements, int most = kMaxThreads) {
  const int t = elements >> 4;
  return t < 32 ? 32 : (t > most ? most : t);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

constexpr size_t kMaxSmem = 232448;  // 227 KB, the H100's per-block limit

}  // namespace pplp
