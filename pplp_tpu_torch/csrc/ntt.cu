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

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
