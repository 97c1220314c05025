// Negacyclic NTT / inverse NTT over RNS limbs for Hopper (sm_90a).
//
// Replaces the Pallas kernel pplp_tpu/ops/ntt_vmem.py::_kernel (driven by
// _run, public forward_vmem / inverse_vmem). It computes the same transform,
// but emits the stage engine's bit-reversed spectrum order
// (pplp_tpu/ops/ntt.py::forward / inverse), which is the port's only order.
//
// Layout: one thread block per polynomial row (one (batch, limb) pair of an
// [..., L, n] tensor). The row is narrowed from int64 to u32 into shared
// memory (n * 4 bytes: 32 KB at n = 8192, 128 KB at n = 32768, dynamic shared
// memory above 48 KB), all log2(n) butterfly stages run there with a
// __syncthreads() between stages, and the canonical result is widened back
// to int64. Twiddles and their Shoup companions are read from global memory
// (u32 tables [L, n], the same values as the stage engine's w/ws/iw/iws).
//
// Arithmetic is the m31 profile (q < 2^30): Harvey-lazy butterflies with
// Shoup products, x * w mod q = w * x - umulhi(w_shoup, x) * q in wrapping
// u32, valid for any x < 2^32. Forward: Cooley-Tukey stages, values in
// [0, 4q); inverse: Gentleman-Sande stages in [0, 2q), then a full Shoup
// product by n^-1. Outputs are canonical.
//
// What bounds it: device-memory bytes at batch scale. Each element is read
// and written once as int64 (16 bytes) plus the twiddle reads, against
// ~log2(n) * 3 integer multiplies. Later work: keep residues as u32 end to
// end, fuse pointwise twiddles into the epilogue, several rows per block.
//
// The u64 kernels (pplp_ntt_forward_u64 / pplp_ntt_inverse_u64) run the m62
// profile (2^32 <= q < 2^62). They replace no TPU kernel: the reference runs
// m62 transforms through the XLA stage engine (pplp_tpu/ops/ntt.py:205-267,
// (lo, hi) u32 pairs), and these emit that engine's order. Same design as the
// u32 kernels: one block per row, the row in shared memory as u64, Shoup
// products x * w mod q = w * x - __umul64hi(w_shoup, x) * q in wrapping u64
// (w_shoup = floor(w * 2^64 / q), valid for any x < 2^64), Harvey-lazy CT
// forward in [0, 4q) (4q < 2^64), GS inverse in [0, 2q) with the n^-1
// product, canonical out. Tables are the int64 [L, n] tensors of the port's
// NttTables, read as u64 (the Shoup companions are stored as bit patterns).
//
// A u64 row takes 8n bytes of shared memory: 128 KB at n = 16384, but 256 KB
// at n = 32768, over the H100's 227 KB per block. So n = 32768 splits: the
// forward runs CT stage 0 (pairs i, i + n/2) in one global-memory pass, then
// each half as an independent 16384-point sub-transform in its own block
// with the twiddle indices offset; the inverse mirrors it (the halves first,
// then the last GS stage and the n^-1 product in a global pass).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t m) {
  return x >= m ? x - m : x;
}

// x * w mod q in [0, 2q) for any x < 2^32 (w_shoup = floor(w * 2^32 / q)).
__device__ __forceinline__ uint32_t mulmod_shoup_lazy(uint32_t x, uint32_t w,
                                                      uint32_t w_shoup,
                                                      uint32_t q) {
  const uint32_t est = __umulhi(w_shoup, x);
  return w * x - est * q;
}

__global__ void ntt_forward_kernel(const int64_t* __restrict__ x,
                                   int64_t* __restrict__ y,
                                   const uint32_t* __restrict__ q_limb,
                                   const uint32_t* __restrict__ w,
                                   const uint32_t* __restrict__ ws, int L,
                                   int logn) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const int64_t row = blockIdx.x;
  const int limb = static_cast<int>(row % L);
  const int64_t* xr = x + row * n;
  int64_t* yr = y + row * n;
  const uint32_t* wl = w + static_cast<int64_t>(limb) * n;
  const uint32_t* wsl = ws + static_cast<int64_t>(limb) * n;
  const uint32_t q = q_limb[limb];
  const uint32_t two_q = 2u * q;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    a[i] = static_cast<uint32_t>(xr[i]);
  }
  __syncthreads();

  // Stage s: h = 2^s twiddle blocks of 2t elements, t = n / 2h.
  for (int s = 0; s < logn; ++s) {
    const int h = 1 << s;
    const int logt = logn - 1 - s;
    const int t = 1 << logt;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int blk = j >> logt;
      const int iu = (blk << (logt + 1)) + (j & (t - 1));
      const int iv = iu + t;
      const uint32_t u = csub(a[iu], two_q);
      const uint32_t mv = mulmod_shoup_lazy(a[iv], wl[h + blk], wsl[h + blk], q);
      a[iu] = u + mv;
      a[iv] = u + two_q - mv;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    yr[i] = static_cast<int64_t>(csub(csub(a[i], two_q), q));
  }
}

__global__ void ntt_inverse_kernel(const int64_t* __restrict__ x,
                                   int64_t* __restrict__ y,
                                   const uint32_t* __restrict__ q_limb,
                                   const uint32_t* __restrict__ iw,
                                   const uint32_t* __restrict__ iws,
                                   const uint32_t* __restrict__ n_inv,
                                   const uint32_t* __restrict__ n_inv_shoup,
                                   int L, int logn) {
  extern __shared__ uint32_t a[];
  const int n = 1 << logn;
  const int half = n >> 1;
  const int64_t row = blockIdx.x;
  const int limb = static_cast<int>(row % L);
  const int64_t* xr = x + row * n;
  int64_t* yr = y + row * n;
  const uint32_t* wl = iw + static_cast<int64_t>(limb) * n;
  const uint32_t* wsl = iws + static_cast<int64_t>(limb) * n;
  const uint32_t q = q_limb[limb];
  const uint32_t two_q = 2u * q;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    a[i] = static_cast<uint32_t>(xr[i]);
  }
  __syncthreads();

  // Stage s: t = 2^s, h = n / 2t twiddle blocks.
  for (int s = 0; s < logn; ++s) {
    const int h = half >> s;
    const int t = 1 << s;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int blk = j >> s;
      const int iu = (blk << (s + 1)) + (j & (t - 1));
      const int iv = iu + t;
      const uint32_t u = a[iu];
      const uint32_t v = a[iv];
      a[iu] = csub(u + v, two_q);
      a[iv] = mulmod_shoup_lazy(u + two_q - v, wl[h + blk], wsl[h + blk], q);
    }
    __syncthreads();
  }

  const uint32_t ni = n_inv[limb];
  const uint32_t nis = n_inv_shoup[limb];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    yr[i] = static_cast<int64_t>(csub(mulmod_shoup_lazy(a[i], ni, nis, q), q));
  }
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

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

constexpr int kGlobalThreads = 256;

int global_blocks(int64_t pairs) {
  return static_cast<int>((pairs + kGlobalThreads - 1) / kGlobalThreads);
}

int launch_shape(int logn, int* threads, size_t* smem) {
  if (logn < 6 || logn > 15) return static_cast<int>(cudaErrorInvalidValue);
  const int n = 1 << logn;
  *threads = n / 2 < 512 ? n / 2 : 512;
  *smem = static_cast<size_t>(n) * sizeof(uint32_t);
  return 0;
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after the launch (0 = success).
// x, y: int64 [rows, n] contiguous, rows = batch * L with the limb index
// fastest; tables: u32 [L, n] (twiddles) and [L] (q, n^-1, its companion).

int pplp_ntt_forward(const void* x, void* y, const void* q, const void* w,
                     const void* ws, int rows, int L, int logn, void* stream) {
  int threads;
  size_t smem;
  const int err = launch_shape(logn, &threads, &smem);
  if (err) return err;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ntt_forward_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(y),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(w),
      static_cast<const uint32_t*>(ws), L, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_ntt_inverse(const void* x, void* y, const void* q, const void* iw,
                     const void* iws, const void* n_inv,
                     const void* n_inv_shoup, int rows, int L, int logn,
                     void* stream) {
  int threads;
  size_t smem;
  const int err = launch_shape(logn, &threads, &smem);
  if (err) return err;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ntt_inverse_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(y),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(iw),
      static_cast<const uint32_t*>(iws), static_cast<const uint32_t*>(n_inv),
      static_cast<const uint32_t*>(n_inv_shoup), L, logn);
  return static_cast<int>(cudaGetLastError());
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
