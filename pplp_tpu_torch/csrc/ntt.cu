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
// (lo, hi) u32 pairs), and these emit that engine's order, int64 residues in
// and out (the u64's bits, so a row needs no narrowing). They run the
// in-block transform of csrc/ntt_block64.cuh: register-radix rounds on u64
// rows in swizzled shared memory, twiddles as interleaved (w, w_shoup)
// ulonglong2 pairs, rows in by 16-byte cp.async and out as 16-byte vectors.
//
// What bounds them: bytes and integer work sit at the crossover. A residue
// crosses device memory once each way (16 B), and a butterfly's u64 Shoup
// product is about ten 32-bit multiplies (measure_multiply.U64_PRODUCT_MULS
// has the count from the SASS); at [64, 16, 32768] the forward is bound by
// bytes and the inverse, with its n^-1 products, by operations. So every
// row crosses device memory once, and every stage runs in registers with one
// shared-memory exchange per round.
//
// Block shapes. Blocks have at most 512 threads and 64 registers a thread, so
// that two fit an SM and one computes while the other waits at a barrier.
// For n <= 1024 a block holds several rows of one limb, so that it has at
// least 256 groups of work; the tail block takes the rows that are left;
// n = 2048 is one row per block. From n = 4096 on (the seal chains) a row is
// spread over a thread block cluster: 2 blocks up to n = 16384 and 4 at
// n = 32768, where a row is 256 KB, over the 227 KB one block may use. The
// forward's first round (1 .. 3 stages, so that every later round has 3)
// reads the row straight from device memory into registers and writes each
// element into the shared memory of the block that holds its part (its own,
// or a peer's through distributed shared memory); after a cluster barrier
// the parts are independent transforms, and each block runs the other
// stages on its 2048 .. 8192 points and stores them. The inverse mirrors
// it: the local stages, a cluster barrier, and a last round that reads the
// blocks' shared memory, multiplies by n^-1 and writes device memory. Every
// transform is one launch and moves 16 B per residue.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_block.cuh"
#include "ntt_block64.cuh"

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

// Rows of one limb per block: batch entries b0 .. b0 + rows - 1 of limb
// blockIdx.x % L, which lie L rows apart.
__global__ void __launch_bounds__(pplp::kMaxThreads64, 2)
ntt_forward_u64_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                       const uint64_t* __restrict__ q_limb,
                       const ulonglong2* __restrict__ tw, int batch, int L, int logn,
                       int rows_per_block) {
  uint64_t* a = pplp::dyn_smem64();
  const int limb = blockIdx.x % L;
  const int b0 = (blockIdx.x / L) * rows_per_block;
  const int rows = min(rows_per_block, batch - b0);
  const int64_t first = (static_cast<int64_t>(b0) * L + limb) << logn;
  const int64_t stride = static_cast<int64_t>(L) << logn;
  pplp::load_rows_async64(x + first, stride, a, rows, logn);
  pplp::cp_async_wait_all();
  __syncthreads();
  pplp::ntt_fwd_block64(a, rows, logn, tw + (static_cast<int64_t>(limb) << logn),
                        q_limb[limb]);
  pplp::store_rows64(a, y + first, stride, rows, logn);
}

__global__ void __launch_bounds__(pplp::kMaxThreads64, 2)
ntt_inverse_u64_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                       const uint64_t* __restrict__ q_limb,
                       const ulonglong2* __restrict__ itw,
                       const uint64_t* __restrict__ n_inv,
                       const uint64_t* __restrict__ n_inv_shoup, int batch, int L, int logn,
                       int rows_per_block) {
  uint64_t* a = pplp::dyn_smem64();
  const int limb = blockIdx.x % L;
  const int b0 = (blockIdx.x / L) * rows_per_block;
  const int rows = min(rows_per_block, batch - b0);
  const int64_t first = (static_cast<int64_t>(b0) * L + limb) << logn;
  const int64_t stride = static_cast<int64_t>(L) << logn;
  pplp::load_rows_async64(x + first, stride, a, rows, logn);
  pplp::cp_async_wait_all();
  __syncthreads();
  pplp::ntt_inv_block64(a, rows, logn, itw + (static_cast<int64_t>(limb) << logn),
                        q_limb[limb], n_inv[limb], n_inv_shoup[limb]);
  pplp::store_rows64(a, y + first, stride, rows, logn);
}

// One row per cluster of 2^CL blocks; block `rank` holds the part
// 2^CL + rank of the transform (n >> CL contiguous points). KK is the round
// that runs between device memory and the cluster's shared memory: the
// first of the forward, the last of the inverse.
template <int KK, int CL>
__global__ void __launch_bounds__(pplp::kMaxThreads64, 2)
ntt_forward_u64_cluster_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                               const uint64_t* __restrict__ q_limb,
                               const ulonglong2* __restrict__ tw, int L, int logn) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  uint64_t* a = pplp::dyn_smem64();
  const int rank = cluster.block_rank();
  const int64_t row = blockIdx.x >> CL;
  const int limb = static_cast<int>(row % L);
  const ulonglong2* twl = tw + (static_cast<int64_t>(limb) << logn);
  const uint64_t q = q_limb[limb];
  const int logm = logn - CL;
  pplp::fwd_first_round_cluster64<KK, CL>(x + (row << logn), a, logn, twl, q, cluster);
  pplp::ntt_fwd_block64(a, 1, logm, twl, q, (1 << CL) + rank, KK - CL);
  pplp::store_rows64(a, y + (row << logn) + (static_cast<int64_t>(rank) << logm), 0, 1, logm);
}

template <int KK, int CL>
__global__ void __launch_bounds__(pplp::kMaxThreads64, 2)
ntt_inverse_u64_cluster_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
                               const uint64_t* __restrict__ q_limb,
                               const ulonglong2* __restrict__ itw,
                               const uint64_t* __restrict__ n_inv,
                               const uint64_t* __restrict__ n_inv_shoup, int L, int logn) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  uint64_t* a = pplp::dyn_smem64();
  const int rank = cluster.block_rank();
  const int64_t row = blockIdx.x >> CL;
  const int limb = static_cast<int>(row % L);
  const ulonglong2* twl = itw + (static_cast<int64_t>(limb) << logn);
  const uint64_t q = q_limb[limb];
  const int logm = logn - CL;
  pplp::load_rows_async64(x + (row << logn) + (static_cast<int64_t>(rank) << logm), 0, a, 1,
                          logm);
  pplp::cp_async_wait_all();
  __syncthreads();
  pplp::ntt_inv_block64(a, 1, logm, twl, q, 0, 0, (1 << CL) + rank, logn - KK);
  pplp::inv_last_round_cluster64<KK, CL>(a, y + (row << logn), logn, twl, q, n_inv[limb],
                                         n_inv_shoup[limb], cluster);
}

// The launch of one u64 transform over batch * L rows: blocks, threads,
// shared memory, rows per block, and log2 of the blocks a row is spread over
// (0: the row kernels).
struct Shape64 {
  int blocks, threads, rows_per_block, cluster_log;
  size_t smem;
};

// n = 4096 .. 32768 (logn = 12 .. 15), the seal chains: a row goes over a
// cluster of 2, 2, 2 and 4 blocks, so that a block holds 16 .. 64 KB and an
// SM at least two blocks that hide each other's barriers (measured: at
// n = 32768 4 blocks beat 2 and 8, at n = 4096 and 16384 2 beat 1 and 4);
// below, whole rows per block. log2 of the blocks of a row:
constexpr int cluster_log(int logn) { return logn < 12 ? 0 : (logn < 15 ? 1 : 2); }
// The cluster round's stages, so that every other round has k = 3.
constexpr int cluster_stages(int logn) { return (logn - 1) % pplp::kRadixLog64 + 1; }

int shape_u64(int batch, int L, int logn, Shape64* s) {
  if (logn < 6 || logn > 15 || batch < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int K = pplp::kRadixLog64;
  constexpr int kMinGroups = 256;  // of a block, where the batch has them
  s->cluster_log = cluster_log(logn);
  const int logm = logn - s->cluster_log;
  const int groups = 1 << (logm - K);
  int rpb = s->cluster_log || groups >= kMinGroups ? 1 : kMinGroups / groups;
  if (rpb > batch) rpb = batch;
  s->rows_per_block = rpb;
  const int64_t blocks = s->cluster_log ? (static_cast<int64_t>(batch) * L) << s->cluster_log
                                        : static_cast<int64_t>((batch + rpb - 1) / rpb) * L;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  s->blocks = static_cast<int>(blocks);
  s->smem = (static_cast<size_t>(rpb) * sizeof(uint64_t)) << logm;
  const int work = rpb * groups;
  s->threads = work < 32 ? 32 : (work > pplp::kMaxThreads64 ? pplp::kMaxThreads64 : work);
  return 0;
}

// Launch `kernel` over s.blocks blocks, in clusters of 2^s.cluster_log.
template <typename... Params, typename... Args>
int launch_u64(void (*kernel)(Params...), const Shape64& s, cudaStream_t stream, Args... args) {
  const int err = allow_smem(kernel, s.smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.blocks);
  cfg.blockDim = dim3(s.threads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << s.cluster_log;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...));
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

// x, y: int64 [batch * L, n] as above (x != y), read as u64; tables: the
// int64 [L] tensors of an m62 NttTables (q; n^-1 and its companion) and the
// interleaved (w, w_shoup) ulonglong2 [L, n] tables. One launch at every n.

int pplp_ntt_forward_u64(const void* x, void* y, const void* q, const void* tw, int batch,
                         int L, int logn, void* stream) {
  Shape64 s;
  const int err = shape_u64(batch, L, logn, &s);
  if (err) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const uint64_t*>(x);
  auto out = static_cast<uint64_t*>(y);
  auto qq = static_cast<const uint64_t*>(q);
  auto ww = static_cast<const ulonglong2*>(tw);
  switch (logn) {
    case 12:
      return launch_u64(ntt_forward_u64_cluster_kernel<cluster_stages(12), cluster_log(12)>,
                        s, st, in, out, qq, ww, L, logn);
    case 13:
      return launch_u64(ntt_forward_u64_cluster_kernel<cluster_stages(13), cluster_log(13)>,
                        s, st, in, out, qq, ww, L, logn);
    case 14:
      return launch_u64(ntt_forward_u64_cluster_kernel<cluster_stages(14), cluster_log(14)>,
                        s, st, in, out, qq, ww, L, logn);
    case 15:
      return launch_u64(ntt_forward_u64_cluster_kernel<cluster_stages(15), cluster_log(15)>,
                        s, st, in, out, qq, ww, L, logn);
    default:
      break;
  }
  return launch_u64(ntt_forward_u64_kernel, s, st, in, out, qq, ww, batch, L, logn,
                    s.rows_per_block);
}

int pplp_ntt_inverse_u64(const void* x, void* y, const void* q, const void* itw,
                         const void* n_inv, const void* n_inv_shoup, int batch, int L,
                         int logn, void* stream) {
  Shape64 s;
  const int err = shape_u64(batch, L, logn, &s);
  if (err) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const uint64_t*>(x);
  auto out = static_cast<uint64_t*>(y);
  auto qq = static_cast<const uint64_t*>(q);
  auto ww = static_cast<const ulonglong2*>(itw);
  auto ni = static_cast<const uint64_t*>(n_inv);
  auto nis = static_cast<const uint64_t*>(n_inv_shoup);
  switch (logn) {
    case 12:
      return launch_u64(ntt_inverse_u64_cluster_kernel<cluster_stages(12), cluster_log(12)>,
                        s, st, in, out, qq, ww, ni, nis, L, logn);
    case 13:
      return launch_u64(ntt_inverse_u64_cluster_kernel<cluster_stages(13), cluster_log(13)>,
                        s, st, in, out, qq, ww, ni, nis, L, logn);
    case 14:
      return launch_u64(ntt_inverse_u64_cluster_kernel<cluster_stages(14), cluster_log(14)>,
                        s, st, in, out, qq, ww, ni, nis, L, logn);
    case 15:
      return launch_u64(ntt_inverse_u64_cluster_kernel<cluster_stages(15), cluster_log(15)>,
                        s, st, in, out, qq, ww, ni, nis, L, logn);
    default:
      break;
  }
  return launch_u64(ntt_inverse_u64_kernel, s, st, in, out, qq, ww, ni, nis, batch, L, logn,
                    s.rows_per_block);
}

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
