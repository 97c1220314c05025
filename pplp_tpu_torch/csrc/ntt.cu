// Negacyclic NTT / inverse NTT over RNS limbs for Hopper (sm_90a).
//
// The u32 kernels (m31 profile, every q < 2^30) replace the Pallas kernel
// pplp_tpu/ops/ntt_vmem.py::_kernel (driven by _run, public forward_vmem /
// inverse_vmem). They compute the same transform, but emit the stage
// engine's bit-reversed spectrum order (pplp_tpu/ops/ntt.py::forward /
// inverse), which is the port's only order.
//
// Layout: one thread block per polynomial row (one (batch, limb) pair of an
// [..., L, n] tensor). The row comes into shared memory as u32 (4n bytes:
// 16 KB at n = 4096, 128 KB at n = 32768, so no shape needs a split), the
// in-block transform of csrc/ntt_block.cuh runs there (register-radix
// rounds of 4 stages, one shared-memory exchange per round,
// twiddles as interleaved (w, w_shoup) uint2 pairs), and the canonical row
// goes back out. Loads and stores are 16-byte vectors, neighbouring threads
// on neighbouring addresses. Each kernel comes in two I/O widths:
//
//   ntt_forward_kernel / ntt_inverse_kernel: int64 in and out, narrowed on
//     load and widened on store (ntt_cuda.forward / inverse, the protocol,
//     the pipeline);
//   ntt_forward_u32_kernel / ntt_inverse_u32_kernel: u32 out, from u32 rows
//     (cp.async 16-byte copies into shared memory) or from int64 ciphertext
//     rows; the multiply's intermediates on the shapes whose fused BEHZ
//     kernels would not fit in shared memory (ops/behz_cuda.py).
//
// What bounds it. Against the card's peaks, bytes: at n = 4096 a row's
// forward is 24,576 Shoup products against 64 KB of int64 I/O (32 KB at
// u32), 0.38 (0.75) products per byte, where the H100's integer-multiply
// peak (3 multiplies per product) over its 3.35 TB/s is 1.66. In practice,
// integer instruction issue: a butterfly adds a lazy compare-subtract, an
// add and a subtract to its product's 3 multiplies, and even the bare
// Shoup loop of csrc/mulmod_chain.cu reaches about half the multiply peak.
// So the design keeps the butterflies in registers and the exchanges few;
// tensor cores are not used (see ntt_block.cuh).
//
// The u64 kernels (pplp_ntt_forward_u64 / pplp_ntt_inverse_u64) run the m62
// profile (2^32 <= q < 2^62). They replace no TPU kernel: the reference runs
// m62 transforms through the XLA stage engine (pplp_tpu/ops/ntt.py:205-267,
// (lo, hi) u32 pairs), and these emit that engine's order. One block per
// row, the row in shared memory as u64, one stage per __syncthreads(),
// Shoup products x * w mod q = w * x - __umul64hi(w_shoup, x) * q in
// wrapping u64 (w_shoup = floor(w * 2^64 / q), valid for any x < 2^64),
// Harvey-lazy CT forward in [0, 4q) (4q < 2^64), GS inverse in [0, 2q) with
// the n^-1 product, canonical out. Tables are the int64 [L, n] tensors of
// the port's NttTables, read as u64 (the Shoup companions are stored as bit
// patterns).
//
// A u64 row takes 8n bytes of shared memory: 128 KB at n = 16384, but 256 KB
// at n = 32768, over the H100's 227 KB per block. So n = 32768 splits: the
// forward runs CT stage 0 (pairs i, i + n/2) in one global-memory pass, then
// each half as an independent 16384-point sub-transform in its own block
// with the twiddle indices offset; the inverse mirrors it (the halves first,
// then the last GS stage and the n^-1 product in a global pass).

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_block.cuh"

namespace {

using pplp::allow_smem;

// One row per block: load (narrowing int64 or copying u32), transform,
// store (widening to int64 or as u32).
template <typename In, typename Out>
__device__ __forceinline__ void forward_row(const In* x, Out* y, const uint32_t* q_limb,
                                            const uint2* tw, int L, int logn) {
  uint32_t* a = pplp::dyn_smem();
  const int n = 1 << logn;
  const int64_t row = blockIdx.x;
  const int limb = static_cast<int>(row % L);
  pplp::load_row(x + row * n, a, n);
  __syncthreads();
  pplp::ntt_fwd_block(a, 1, logn, tw + static_cast<int64_t>(limb) * n, q_limb[limb]);
  pplp::store_row(a, y + row * n, n);
}

template <typename In, typename Out>
__device__ __forceinline__ void inverse_row(const In* x, Out* y, const uint32_t* q_limb,
                                            const uint2* itw, const uint32_t* n_inv,
                                            const uint32_t* n_inv_shoup, int L, int logn) {
  uint32_t* a = pplp::dyn_smem();
  const int n = 1 << logn;
  const int64_t row = blockIdx.x;
  const int limb = static_cast<int>(row % L);
  pplp::load_row(x + row * n, a, n);
  __syncthreads();
  pplp::ntt_inv_block(a, 1, logn, itw + static_cast<int64_t>(limb) * n, q_limb[limb],
                         n_inv[limb], n_inv_shoup[limb]);
  pplp::store_row(a, y + row * n, n);
}

__global__ void __launch_bounds__(pplp::kMaxRowThreads)
ntt_forward_kernel(const void* x, void* y, const uint32_t* __restrict__ q,
                   const uint2* __restrict__ tw, int L, int logn) {
  forward_row<int64_t, int64_t>(static_cast<const int64_t*>(x), static_cast<int64_t*>(y), q,
                                tw, L, logn);
}

template <typename In>
__global__ void __launch_bounds__(pplp::kMaxRowThreads)
ntt_forward_u32_kernel(const void* x, void* y, const uint32_t* __restrict__ q,
                       const uint2* __restrict__ tw, int L, int logn) {
  forward_row<In, uint32_t>(static_cast<const In*>(x), static_cast<uint32_t*>(y), q, tw, L,
                            logn);
}

__global__ void __launch_bounds__(pplp::kMaxRowThreads)
ntt_inverse_kernel(const void* x, void* y, const uint32_t* __restrict__ q,
                   const uint2* __restrict__ itw, const uint32_t* __restrict__ n_inv,
                   const uint32_t* __restrict__ n_inv_shoup, int L, int logn) {
  inverse_row<int64_t, int64_t>(static_cast<const int64_t*>(x), static_cast<int64_t*>(y), q,
                                itw, n_inv, n_inv_shoup, L, logn);
}

__global__ void __launch_bounds__(pplp::kMaxRowThreads)
ntt_inverse_u32_kernel(const void* x, void* y, const uint32_t* __restrict__ q,
                       const uint2* __restrict__ itw, const uint32_t* __restrict__ n_inv,
                       const uint32_t* __restrict__ n_inv_shoup, int L, int logn) {
  inverse_row<uint32_t, uint32_t>(static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
                                  q, itw, n_inv, n_inv_shoup, L, logn);
}

using FwdKernel = void (*)(const void*, void*, const uint32_t*, const uint2*, int, int);
using InvKernel = void (*)(const void*, void*, const uint32_t*, const uint2*,
                           const uint32_t*, const uint32_t*, int, int);

// The forward kernel of an I/O width: (int64, int64), (int64, u32) or
// (u32, u32); nullptr for (u32, int64), which no caller needs.
FwdKernel forward_kernel(int in_u32, int out_u32) {
  if (!out_u32) return in_u32 ? nullptr : ntt_forward_kernel;
  return in_u32 ? ntt_forward_u32_kernel<uint32_t> : ntt_forward_u32_kernel<int64_t>;
}

// The inverse kernel: (int64, int64) or (u32, u32).
InvKernel inverse_kernel(int in_u32, int out_u32) {
  if (in_u32 != out_u32) return nullptr;
  return in_u32 ? ntt_inverse_u32_kernel : ntt_inverse_kernel;
}

int u32_shape(int logn, int* threads, size_t* smem) {
  if (logn < 6 || logn > 15) return static_cast<int>(cudaErrorInvalidValue);
  *threads = pplp::block_threads(1 << logn, pplp::kMaxRowThreads);
  *smem = static_cast<size_t>(4) << logn;
  return 0;
}

// ---- u64 (m62) kernels --------------------------------------------------

__device__ __forceinline__ uint64_t csub64(uint64_t x, uint64_t m) {
  return x >= m ? x - m : x;
}

// x * w mod q in [0, 2q) for any x < 2^64 (w_shoup = floor(w * 2^64 / q)).
__device__ __forceinline__ uint64_t mulmod_shoup_lazy64(uint64_t x, uint64_t w,
                                                        uint64_t w_shoup,
                                                        uint64_t q) {
  const uint64_t est = __umul64hi(w_shoup, x);
  return w * x - est * q;
}

constexpr int kMaxSmemLogn = 14;  // 8 * 2^14 = 128 KB of shared memory

// Forward CT stages on one sub-transform of m = n >> split elements per block
// (split = 0: the whole row; split = 1: half b of the row after stage 0).
// Local stage s' is global stage s' + split; its twiddle block index is
// (h' << split) + (b << s') + blk'. Input in [0, 4q) (canonical when
// split = 0); output canonical. x may equal y.
__global__ void ntt_forward_u64_kernel(const int64_t* x, int64_t* y,
                                       const uint64_t* __restrict__ q_limb,
                                       const uint64_t* __restrict__ w,
                                       const uint64_t* __restrict__ ws, int L,
                                       int logn, int split) {
  extern __shared__ uint64_t a64[];
  const int logm = logn - split;
  const int m = 1 << logm;
  const int half = m >> 1;
  const int64_t row = blockIdx.x >> split;
  const int b = blockIdx.x & ((1 << split) - 1);
  const int limb = static_cast<int>(row % L);
  const int64_t base = (row << logn) + (static_cast<int64_t>(b) << logm);
  const uint64_t* wl = w + (static_cast<int64_t>(limb) << logn);
  const uint64_t* wsl = ws + (static_cast<int64_t>(limb) << logn);
  const uint64_t q = q_limb[limb];
  const uint64_t two_q = 2 * q;

  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    a64[i] = static_cast<uint64_t>(x[base + i]);
  }
  __syncthreads();

  for (int s = 0; s < logm; ++s) {
    const int logt = logm - 1 - s;
    const int t = 1 << logt;
    const int tw0 = ((1 << s) << split) + (b << s);
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int blk = j >> logt;
      const int iu = (blk << (logt + 1)) + (j & (t - 1));
      const int iv = iu + t;
      const uint64_t u = csub64(a64[iu], two_q);
      const uint64_t mv =
          mulmod_shoup_lazy64(a64[iv], wl[tw0 + blk], wsl[tw0 + blk], q);
      a64[iu] = u + mv;
      a64[iv] = u + two_q - mv;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    y[base + i] = static_cast<int64_t>(csub64(csub64(a64[i], two_q), q));
  }
}

// Forward CT stage 0 over whole rows in global memory (twiddle index 1):
// canonical x -> lazy [0, 4q) y, as u64 bit patterns.
__global__ void ntt_forward_u64_stage0(const int64_t* __restrict__ x,
                                       int64_t* __restrict__ y,
                                       const uint64_t* __restrict__ q_limb,
                                       const uint64_t* __restrict__ w,
                                       const uint64_t* __restrict__ ws, int L,
                                       int logn, int64_t pairs) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= pairs) return;
  const int64_t row = idx >> (logn - 1);
  const int64_t j = idx & ((int64_t{1} << (logn - 1)) - 1);
  const int limb = static_cast<int>(row % L);
  const uint64_t q = q_limb[limb];
  const uint64_t two_q = 2 * q;
  const int64_t tw = (static_cast<int64_t>(limb) << logn) + 1;
  const int64_t iu = (row << logn) + j;
  const int64_t iv = iu + (int64_t{1} << (logn - 1));
  const uint64_t u = csub64(static_cast<uint64_t>(x[iu]), two_q);
  const uint64_t mv = mulmod_shoup_lazy64(static_cast<uint64_t>(x[iv]), w[tw], ws[tw], q);
  y[iu] = static_cast<int64_t>(u + mv);
  y[iv] = static_cast<int64_t>(u + two_q - mv);
}

// Inverse GS stages 0 .. logm - 1 on one sub-transform (split as above; the
// twiddle block index is (h' << split) + (b << (logm - 1 - s)) + blk'). With
// split = 0 the n^-1 product makes the output canonical; with split = 1 the
// output stays lazy in [0, 2q) for ntt_inverse_u64_last. x may equal y.
__global__ void ntt_inverse_u64_kernel(const int64_t* x, int64_t* y,
                                       const uint64_t* __restrict__ q_limb,
                                       const uint64_t* __restrict__ iw,
                                       const uint64_t* __restrict__ iws,
                                       const uint64_t* __restrict__ n_inv,
                                       const uint64_t* __restrict__ n_inv_shoup,
                                       int L, int logn, int split) {
  extern __shared__ uint64_t a64[];
  const int logm = logn - split;
  const int m = 1 << logm;
  const int half = m >> 1;
  const int64_t row = blockIdx.x >> split;
  const int b = blockIdx.x & ((1 << split) - 1);
  const int limb = static_cast<int>(row % L);
  const int64_t base = (row << logn) + (static_cast<int64_t>(b) << logm);
  const uint64_t* wl = iw + (static_cast<int64_t>(limb) << logn);
  const uint64_t* wsl = iws + (static_cast<int64_t>(limb) << logn);
  const uint64_t q = q_limb[limb];
  const uint64_t two_q = 2 * q;

  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    a64[i] = static_cast<uint64_t>(x[base + i]);
  }
  __syncthreads();

  for (int s = 0; s < logm; ++s) {
    const int logh = logm - 1 - s;
    const int t = 1 << s;
    const int tw0 = ((1 << logh) << split) + (b << logh);
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int blk = j >> s;
      const int iu = (blk << (s + 1)) + (j & (t - 1));
      const int iv = iu + t;
      const uint64_t u = a64[iu];
      const uint64_t v = a64[iv];
      a64[iu] = csub64(u + v, two_q);
      a64[iv] = mulmod_shoup_lazy64(u + two_q - v, wl[tw0 + blk], wsl[tw0 + blk], q);
    }
    __syncthreads();
  }

  if (split) {
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      y[base + i] = static_cast<int64_t>(a64[i]);
    }
    return;
  }
  const uint64_t ni = n_inv[limb];
  const uint64_t nis = n_inv_shoup[limb];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    y[base + i] = static_cast<int64_t>(csub64(mulmod_shoup_lazy64(a64[i], ni, nis, q), q));
  }
}

// Inverse GS last stage (pairs j, j + n/2, twiddle index 1) and the n^-1
// product over whole rows, in place: lazy [0, 2q) in, canonical out.
__global__ void ntt_inverse_u64_last(int64_t* __restrict__ y,
                                     const uint64_t* __restrict__ q_limb,
                                     const uint64_t* __restrict__ iw,
                                     const uint64_t* __restrict__ iws,
                                     const uint64_t* __restrict__ n_inv,
                                     const uint64_t* __restrict__ n_inv_shoup,
                                     int L, int logn, int64_t pairs) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= pairs) return;
  const int64_t row = idx >> (logn - 1);
  const int64_t j = idx & ((int64_t{1} << (logn - 1)) - 1);
  const int limb = static_cast<int>(row % L);
  const uint64_t q = q_limb[limb];
  const uint64_t two_q = 2 * q;
  const int64_t tw = (static_cast<int64_t>(limb) << logn) + 1;
  const int64_t iu = (row << logn) + j;
  const int64_t iv = iu + (int64_t{1} << (logn - 1));
  const uint64_t u = static_cast<uint64_t>(y[iu]);
  const uint64_t v = static_cast<uint64_t>(y[iv]);
  const uint64_t s = csub64(u + v, two_q);
  const uint64_t d = mulmod_shoup_lazy64(u + two_q - v, iw[tw], iws[tw], q);
  const uint64_t ni = n_inv[limb];
  const uint64_t nis = n_inv_shoup[limb];
  y[iu] = static_cast<int64_t>(csub64(mulmod_shoup_lazy64(s, ni, nis, q), q));
  y[iv] = static_cast<int64_t>(csub64(mulmod_shoup_lazy64(d, ni, nis, q), q));
}


// Block shape of the u64 shared-memory kernels, and whether n splits.
int launch_shape_u64(int logn, int* split, int* threads, size_t* smem) {
  if (logn < 6 || logn > 15) return static_cast<int>(cudaErrorInvalidValue);
  *split = logn > kMaxSmemLogn ? 1 : 0;
  const int m = 1 << (logn - *split);
  *threads = m / 2 < 512 ? m / 2 : 512;
  *smem = static_cast<size_t>(m) * sizeof(uint64_t);
  return 0;
}

constexpr int kGlobalThreads = 256;

int global_blocks(int64_t pairs) {
  return static_cast<int>((pairs + kGlobalThreads - 1) / kGlobalThreads);
}

}  // namespace

extern "C" {

// Each entry point returns the launch's error code (0 = success)
// or cudaErrorInvalidValue for a shape or width it does not take.
// x, y: [rows, n] contiguous, 16-byte aligned, rows = batch * L with the
// limb index fastest; int64 or u32 as in_u32 / out_u32 say. Tables: u32
// [L] (q, n^-1, its companion) and the interleaved (w, w_shoup) uint2
// [L, n] tables.

int pplp_ntt_forward(const void* x, void* y, const void* q, const void* tw, int rows, int L,
                     int logn, int in_u32, int out_u32, void* stream) {
  int threads;
  size_t smem;
  int err = u32_shape(logn, &threads, &smem);
  if (err) return err;
  const FwdKernel kernel = forward_kernel(in_u32, out_u32);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(kernel, smem);
  if (err) return err;
  const uint32_t* qq = static_cast<const uint32_t*>(q);
  const uint2* ww = static_cast<const uint2*>(tw);
  void* args[] = {&x, &y, &qq, &ww, &L, &logn};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(rows),
                                           dim3(threads), args, smem,
                                           static_cast<cudaStream_t>(stream)));
}

int pplp_ntt_inverse(const void* x, void* y, const void* q, const void* itw,
                     const void* n_inv, const void* n_inv_shoup, int rows, int L, int logn,
                     int in_u32, int out_u32, void* stream) {
  int threads;
  size_t smem;
  int err = u32_shape(logn, &threads, &smem);
  if (err) return err;
  const InvKernel kernel = inverse_kernel(in_u32, out_u32);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(kernel, smem);
  if (err) return err;
  const uint32_t* qq = static_cast<const uint32_t*>(q);
  const uint2* ww = static_cast<const uint2*>(itw);
  const uint32_t* ni = static_cast<const uint32_t*>(n_inv);
  const uint32_t* nis = static_cast<const uint32_t*>(n_inv_shoup);
  void* args[] = {&x, &y, &qq, &ww, &ni, &nis, &L, &logn};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(rows),
                                           dim3(threads), args, smem,
                                           static_cast<cudaStream_t>(stream)));
}

// x, y: int64 [rows, n] as above; tables: the int64 [L, n] / [L] tensors of
// an m62 NttTables (q, w, w_shoup; iw, iw_shoup, n^-1, its companion),
// read as u64. For n = 32768 the entry point makes two launches.

int pplp_ntt_forward_u64(const void* x, void* y, const void* q, const void* w,
                         const void* ws, int rows, int L, int logn,
                         void* stream) {
  int split, threads;
  size_t smem;
  int err = launch_shape_u64(logn, &split, &threads, &smem);
  if (err) return err;
  err = allow_smem(ntt_forward_u64_kernel, smem);
  if (err) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto qq = static_cast<const uint64_t*>(q);
  auto ww = static_cast<const uint64_t*>(w);
  auto wws = static_cast<const uint64_t*>(ws);
  const int64_t* in = static_cast<const int64_t*>(x);
  int64_t* out = static_cast<int64_t*>(y);
  if (split) {
    const int64_t pairs = static_cast<int64_t>(rows) << (logn - 1);
    ntt_forward_u64_stage0<<<global_blocks(pairs), kGlobalThreads, 0, st>>>(
        in, out, qq, ww, wws, L, logn, pairs);
    in = out;
  }
  ntt_forward_u64_kernel<<<rows << split, threads, smem, st>>>(
      in, out, qq, ww, wws, L, logn, split);
  return static_cast<int>(cudaGetLastError());
}

int pplp_ntt_inverse_u64(const void* x, void* y, const void* q, const void* iw,
                         const void* iws, const void* n_inv,
                         const void* n_inv_shoup, int rows, int L, int logn,
                         void* stream) {
  int split, threads;
  size_t smem;
  int err = launch_shape_u64(logn, &split, &threads, &smem);
  if (err) return err;
  err = allow_smem(ntt_inverse_u64_kernel, smem);
  if (err) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto qq = static_cast<const uint64_t*>(q);
  auto ww = static_cast<const uint64_t*>(iw);
  auto wws = static_cast<const uint64_t*>(iws);
  auto ni = static_cast<const uint64_t*>(n_inv);
  auto nis = static_cast<const uint64_t*>(n_inv_shoup);
  int64_t* out = static_cast<int64_t*>(y);
  ntt_inverse_u64_kernel<<<rows << split, threads, smem, st>>>(
      static_cast<const int64_t*>(x), out, qq, ww, wws, ni, nis, L, logn, split);
  if (split) {
    const int64_t pairs = static_cast<int64_t>(rows) << (logn - 1);
    ntt_inverse_u64_last<<<global_blocks(pairs), kGlobalThreads, 0, st>>>(
        out, qq, ww, wws, ni, nis, L, logn, pairs);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
