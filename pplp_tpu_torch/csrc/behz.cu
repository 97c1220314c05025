// BEHZ ciphertext multiply + RNS-gadget relinearization for Hopper (sm_90a).
//
// Replaces the Pallas kernel pplp_tpu/bfv/behz_fused.py::_kernel (driven by
// FusedMultiplier._call). It computes what that kernel computes, bit for
// bit, on the m31 profile (every prime below 2^30):
//
//   (a) behz_to_bsk:   Q -> B_sk base extension of the four input
//                      polynomials with the m~ = 2^16 Montgomery correction;
//   (b) NTTs of the inputs over Q and B_sk (csrc/ntt.cu, launched by the
//       wrapper);
//   (c) behz_tensor:   the Karatsuba tensor product, 3 products per base;
//   (d) inverse NTTs (csrc/ntt.cu);
//   (e) behz_floor_sk: fast floor + Shenoy-Kumaresan conversion back to Q;
//   (f) relinearization: behz_lift (the gadget digits, width 1 or 2, lifted
//       into every limb), forward NTTs, behz_keyprod (products with the
//       keys, summed over digits), inverse NTTs, behz_add.
//
// Design. The TPU kernel holds a whole batch tile in VMEM; at n = 4096 one
// multiply's working set is 4 polynomials x (L + |B_sk|) limbs x 16 KB,
// far above the ~227 KB of shared memory of a block. So the work is split
// by phase and intermediates live in device memory as int64 residues in the
// port's [component, batch, limb, n] layout. Per-coefficient phases ((a),
// (e), the lift) run one thread per (row, coefficient) with every limb of
// that coefficient in a shared-memory column (neighbouring threads on
// neighbouring coefficients, so global reads and writes coalesce and shared
// accesses have no bank conflicts); per-element phases ((c), key products,
// the final add) run one thread per residue.
//
// Arithmetic: Shoup products (x * w mod q = w x - umulhi(w', x) q in
// wrapping u32), canonical results throughout; fast base conversions sum
// lazy Shoup terms (< 2 q_d each) in u64 and reduce once; tensor products
// are exact u64 products of canonical values (the cross term's operands are
// canonical sums below 2q, so the product stays below 2^62).
//
// What bounds it: device-memory bytes. Every phase reads and writes int64
// residues; the integer work per byte is small. Fusing phases (shared-memory
// tiles, a cluster spreading one multiply over DSMEM, u32 storage) is later
// work.
//
// Bounds: L <= 40 limbs in Q and K = |B_sk| <= 48 limbs (the per-coefficient
// columns take (L + K) * 128 * 4 bytes of shared memory, at most 44 KB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxL = 40;
constexpr int kMaxK = 48;
constexpr int kColThreads = 128;   // coefficients per block, per-coefficient phases
constexpr int kElemThreads = 256;  // residues per block, per-element phases
constexpr uint32_t kNoLimb = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t q) {
  return x >= q ? x - q : x;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t x, uint32_t y, uint32_t q) {
  return csub(x + y, q);  // x, y < q < 2^30
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t x, uint32_t y, uint32_t q) {
  return x >= y ? x - y : x + q - y;
}

// x * w mod q in [0, 2q) for any x < 2^32 (ws = floor(w * 2^32 / q)).
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint32_t w, uint32_t ws,
                                               uint32_t q) {
  return w * x - __umulhi(ws, x) * q;
}

__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w, uint32_t ws,
                                          uint32_t q) {
  return csub(shoup_lazy(x, w, ws, q), q);
}

// The multiplier's constants, one u32 buffer packed by ops/behz_cuda.py
// (_pack_constants) in exactly this order; l = K - 1. Pairs *_w / *_ws are a
// constant and its Shoup companion; conversion tables are row-major
// [destination][source].
struct Consts {
  uint32_t neg_inv_q_mt, imm_w, imm_ws, msk_half;  // scalars
  const uint32_t *qq, *qb;                          // [L], [K]
  const uint32_t *mqh_w, *mqh_ws;                   // [L]  m~ qhat_i^-1 mod q_i
  const uint32_t *cqb_w, *cqb_ws;                   // [K][L] (q / q_i) mod b_d
  const uint32_t *cqm;                              // [L]  (q / q_i) mod m~
  const uint32_t *qmb_w, *qmb_ws;                   // [K]  q mod b_d
  const uint32_t *imt_w, *imt_ws;                   // [K]  m~^-1 mod b_d
  const uint32_t *tq_w, *tq_ws;                     // [L]  t mod q_i
  const uint32_t *tb_w, *tb_ws;                     // [K]  t mod b_d
  const uint32_t *iqb_w, *iqb_ws;                   // [K]  q^-1 mod b_d
  const uint32_t *qhi_w, *qhi_ws;                   // [L]  qhat_i^-1 mod q_i
  const uint32_t *bhat_w, *bhat_ws;                 // [l]  bhat_i^-1 mod b_i
  const uint32_t *cbq_w, *cbq_ws;                   // [L][l] (M / b_i) mod q_d
  const uint32_t *cbm_w, *cbm_ws;                   // [l]  (M / b_i) mod m_sk
  const uint32_t *mmq_w, *mmq_ws;                   // [L]  M mod q_d
  const uint32_t *mskm;                             // [L]  m_sk M mod q_d
};

// Host side: cut the device buffer into its arrays (pointer arithmetic only;
// the four scalars are passed in from the host copy).
Consts layout(const uint32_t* base, const uint32_t* host_scalars, int L, int K) {
  const int l = K - 1;
  Consts c;
  c.neg_inv_q_mt = host_scalars[0];
  c.imm_w = host_scalars[1];
  c.imm_ws = host_scalars[2];
  c.msk_half = host_scalars[3];
  const uint32_t* p = base + 4;
  auto take = [&p](int count) {
    const uint32_t* at = p;
    p += count;
    return at;
  };
  c.qq = take(L);
  c.qb = take(K);
  c.mqh_w = take(L);
  c.mqh_ws = take(L);
  c.cqb_w = take(K * L);
  c.cqb_ws = take(K * L);
  c.cqm = take(L);
  c.qmb_w = take(K);
  c.qmb_ws = take(K);
  c.imt_w = take(K);
  c.imt_ws = take(K);
  c.tq_w = take(L);
  c.tq_ws = take(L);
  c.tb_w = take(K);
  c.tb_ws = take(K);
  c.iqb_w = take(K);
  c.iqb_ws = take(K);
  c.qhi_w = take(L);
  c.qhi_ws = take(L);
  c.bhat_w = take(l);
  c.bhat_ws = take(l);
  c.cbq_w = take(L * l);
  c.cbq_ws = take(L * l);
  c.cbm_w = take(l);
  c.cbm_ws = take(l);
  c.mmq_w = take(L);
  c.mmq_ws = take(L);
  c.mskm = take(L);
  return c;
}

// Row and coefficient of this thread in a per-coefficient phase: the grid
// has rows * (n / blockDim.x) blocks.
__device__ __forceinline__ void row_coeff(int logn, int64_t* row, int* coeff) {
  const int per_row = (1 << logn) / blockDim.x;
  *row = blockIdx.x / per_row;
  *coeff = static_cast<int>(blockIdx.x % per_row) * blockDim.x + threadIdx.x;
}

// (a) x [B, L, n] for each of c0, c1, d0, d1 -> xb [4, B, K, n].
__global__ void to_bsk_kernel(const int64_t* __restrict__ c0,
                              const int64_t* __restrict__ c1,
                              const int64_t* __restrict__ d0,
                              const int64_t* __restrict__ d1,
                              int64_t* __restrict__ xb, Consts k, int B, int L,
                              int K, int logn) {
  extern __shared__ uint32_t col[];  // y [L][blockDim.x]
  const int n = 1 << logn;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  int64_t row;
  int c;
  row_coeff(logn, &row, &c);
  const int p = static_cast<int>(row / B);
  const int64_t b = row % B;
  const int64_t* src = (p == 0 ? c0 : p == 1 ? c1 : p == 2 ? d0 : d1) + b * L * n + c;

  uint32_t acc16 = 0;
  for (int i = 0; i < L; ++i) {
    const uint32_t x = static_cast<uint32_t>(src[static_cast<int64_t>(i) * n]);
    const uint32_t y = shoup(x, k.mqh_w[i], k.mqh_ws[i], k.qq[i]);
    col[i * T + tid] = y;
    acc16 = (acc16 + (y & 0xFFFFu) * k.cqm[i]) & 0xFFFFu;  // mod 2^16
  }
  const uint32_t r = (acc16 * k.neg_inv_q_mt) & 0xFFFFu;

  int64_t* dst = xb + row * K * n + c;
  for (int d = 0; d < K; ++d) {
    const uint32_t qd = k.qb[d];
    uint64_t acc = 0;
    for (int i = 0; i < L; ++i) {
      acc += shoup_lazy(col[i * T + tid], k.cqb_w[d * L + i], k.cqb_ws[d * L + i], qd);
    }
    uint32_t v = static_cast<uint32_t>(acc % qd);
    v = add_mod(v, shoup(r, k.qmb_w[d], k.qmb_ws[d], qd), qd);
    dst[static_cast<int64_t>(d) * n] = shoup(v, k.imt_w[d], k.imt_ws[d], qd);
  }
}

// (c) Karatsuba over one base: spectra a0, a1, b0, b1 [B, Lx, n] ->
// out [3, B, Lx, n] = (a0 b0, a0 b1 + a1 b0, a1 b1).
__global__ void tensor_kernel(const int64_t* __restrict__ a0,
                              const int64_t* __restrict__ a1,
                              const int64_t* __restrict__ b0,
                              const int64_t* __restrict__ b1,
                              int64_t* __restrict__ out,
                              const uint32_t* __restrict__ q_limb, int64_t total,
                              int Lx, int logn) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const uint32_t q = q_limb[(e >> logn) % Lx];
  const uint64_t x0 = static_cast<uint64_t>(a0[e]), x1 = static_cast<uint64_t>(a1[e]);
  const uint64_t y0 = static_cast<uint64_t>(b0[e]), y1 = static_cast<uint64_t>(b1[e]);
  const uint32_t e0 = static_cast<uint32_t>((x0 * y0) % q);
  const uint32_t e2 = static_cast<uint32_t>((x1 * y1) % q);
  const uint32_t cross = static_cast<uint32_t>(((x0 + x1) * (y0 + y1)) % q);
  out[e] = e0;
  out[total + e] = sub_mod(sub_mod(cross, e0, q), e2, q);
  out[2 * total + e] = e2;
}

// (e) eq [3, B, L, n], eb [3, B, K, n] (coefficients) -> out [3, B, L, n].
__global__ void floor_sk_kernel(const int64_t* __restrict__ eq,
                                const int64_t* __restrict__ eb,
                                int64_t* __restrict__ out, Consts k, int L, int K,
                                int logn) {
  extern __shared__ uint32_t col[];  // y [L][T], then w [K][T]
  const int n = 1 << logn;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int l = K - 1;
  int64_t row;
  int c;
  row_coeff(logn, &row, &c);
  uint32_t* ys = col;
  uint32_t* ws = col + L * T;

  // Fast floor: y_i = (t e_i mod q_i) qhat_i^-1 mod q_i.
  const int64_t* srcq = eq + row * L * n + c;
  for (int i = 0; i < L; ++i) {
    const uint32_t qi = k.qq[i];
    const uint32_t e = static_cast<uint32_t>(srcq[static_cast<int64_t>(i) * n]);
    ys[i * T + tid] = shoup(shoup(e, k.tq_w[i], k.tq_ws[i], qi), k.qhi_w[i], k.qhi_ws[i], qi);
  }
  // w_d = (t e_d - conv_d(y)) q^-1 mod b_d over B_sk.
  const int64_t* srcb = eb + row * K * n + c;
  for (int d = 0; d < K; ++d) {
    const uint32_t qd = k.qb[d];
    uint64_t acc = 0;
    for (int i = 0; i < L; ++i) {
      acc += shoup_lazy(ys[i * T + tid], k.cqb_w[d * L + i], k.cqb_ws[d * L + i], qd);
    }
    const uint32_t conv = static_cast<uint32_t>(acc % qd);
    const uint32_t e = static_cast<uint32_t>(srcb[static_cast<int64_t>(d) * n]);
    const uint32_t te = shoup(e, k.tb_w[d], k.tb_ws[d], qd);
    ws[d * T + tid] = shoup(sub_mod(te, conv, qd), k.iqb_w[d], k.iqb_ws[d], qd);
  }
  // Shenoy-Kumaresan: y_i = w_i bhat_i^-1 mod b_i (in place), then
  // alpha = (conv_msk(y) - w_msk) M^-1 mod m_sk.
  for (int i = 0; i < l; ++i) {
    ws[i * T + tid] = shoup(ws[i * T + tid], k.bhat_w[i], k.bhat_ws[i], k.qb[i]);
  }
  const uint32_t msk = k.qb[l];
  uint64_t am = 0;
  for (int i = 0; i < l; ++i) {
    am += shoup_lazy(ws[i * T + tid], k.cbm_w[i], k.cbm_ws[i], msk);
  }
  const uint32_t conv_msk = static_cast<uint32_t>(am % msk);
  const uint32_t alpha =
      shoup(sub_mod(conv_msk, ws[l * T + tid], msk), k.imm_w, k.imm_ws, msk);
  const bool high = alpha > k.msk_half;

  int64_t* dst = out + row * L * n + c;
  for (int d = 0; d < L; ++d) {
    const uint32_t qd = k.qq[d];
    uint64_t acc = 0;
    for (int i = 0; i < l; ++i) {
      acc += shoup_lazy(ws[i * T + tid], k.cbq_w[d * l + i], k.cbq_ws[d * l + i], qd);
    }
    uint32_t v = sub_mod(static_cast<uint32_t>(acc % qd),
                         shoup(alpha, k.mmq_w[d], k.mmq_ws[d], qd), qd);
    if (high) v = add_mod(v, k.mskm[d], qd);
    dst[static_cast<int64_t>(d) * n] = v;
  }
}

// (f) Gadget digits of c2 [B, L, n] lifted into every limb -> dig [D, B, L, n].
// lc: q[L], then per digit g a record of 4 + 2L words: i0, i1 (kNoLimb for a
// one-limb digit), q0^-1 mod q1 and its companion, then (q0 mod q_d, its
// companion) for d < L.
__global__ void lift_kernel(const int64_t* __restrict__ c2, int64_t* __restrict__ dig,
                            const uint32_t* __restrict__ lc, int B, int L, int D,
                            int logn) {
  const int n = 1 << logn;
  int64_t b;
  int c;
  row_coeff(logn, &b, &c);
  const uint32_t* qq = lc;
  const int64_t* src = c2 + b * L * n + c;
  for (int g = 0; g < D; ++g) {
    const uint32_t* rec = lc + L + g * (4 + 2 * L);
    const uint32_t r0 = static_cast<uint32_t>(src[static_cast<int64_t>(rec[0]) * n]);
    int64_t* dst = dig + (static_cast<int64_t>(g) * B + b) * L * n + c;
    if (rec[1] == kNoLimb) {
      for (int d = 0; d < L; ++d) dst[static_cast<int64_t>(d) * n] = r0 % qq[d];
      continue;
    }
    const uint32_t q1 = qq[rec[1]];
    const uint32_t r1 = static_cast<uint32_t>(src[static_cast<int64_t>(rec[1]) * n]);
    const uint32_t t = shoup(sub_mod(r1, r0 % q1, q1), rec[2], rec[3], q1);
    for (int d = 0; d < L; ++d) {
      const uint32_t qd = qq[d];
      dst[static_cast<int64_t>(d) * n] =
          add_mod(r0 % qd, shoup(t, rec[4 + 2 * d], rec[5 + 2 * d], qd), qd);
    }
  }
}

// (f) dn [D, B, L, n] (digit spectra), keys [D, L, n] -> acc [2, B, L, n].
__global__ void keyprod_kernel(const int64_t* __restrict__ dn,
                               const int64_t* __restrict__ k0,
                               const int64_t* __restrict__ k0s,
                               const int64_t* __restrict__ k1,
                               const int64_t* __restrict__ k1s,
                               int64_t* __restrict__ acc,
                               const uint32_t* __restrict__ q_limb, int64_t total,
                               int L, int D, int logn) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t mask = (int64_t{1} << logn) - 1;
  const int limb = static_cast<int>((e >> logn) % L);
  const int64_t kpos = (static_cast<int64_t>(limb) << logn) | (e & mask);
  const int64_t kstride = static_cast<int64_t>(L) << logn;
  const uint32_t q = q_limb[limb];
  uint32_t s0 = 0, s1 = 0;
  for (int g = 0; g < D; ++g) {
    const uint32_t x = static_cast<uint32_t>(dn[g * total + e]);
    const int64_t kp = g * kstride + kpos;
    s0 = add_mod(s0, shoup(x, static_cast<uint32_t>(k0[kp]), static_cast<uint32_t>(k0s[kp]), q), q);
    s1 = add_mod(s1, shoup(x, static_cast<uint32_t>(k1[kp]), static_cast<uint32_t>(k1s[kp]), q), q);
  }
  acc[e] = s0;
  acc[total + e] = s1;
}

// (f) out [2, B, L, n] = (c0 + d[0], c1 + d[1]) mod q.
__global__ void add_kernel(const int64_t* __restrict__ c0, const int64_t* __restrict__ c1,
                           const int64_t* __restrict__ d, int64_t* __restrict__ out,
                           const uint32_t* __restrict__ q_limb, int64_t total, int L,
                           int logn) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const uint32_t q = q_limb[(e >> logn) % L];
  out[e] = add_mod(static_cast<uint32_t>(c0[e]), static_cast<uint32_t>(d[e]), q);
  out[total + e] =
      add_mod(static_cast<uint32_t>(c1[e]), static_cast<uint32_t>(d[total + e]), q);
}

int col_shape(int logn, int64_t rows, dim3* grid, dim3* block) {
  if (logn < 6 || logn > 15 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n = 1 << logn;
  const int threads = n < kColThreads ? n : kColThreads;
  const int64_t blocks = rows * (n / threads);
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(static_cast<unsigned>(blocks));
  *block = dim3(threads);
  return 0;
}

int elem_shape(int64_t total, dim3* grid, dim3* block) {
  const int64_t blocks = (total + kElemThreads - 1) / kElemThreads;
  if (total <= 0 || blocks >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *grid = dim3(static_cast<unsigned>(blocks));
  *block = dim3(kElemThreads);
  return 0;
}

bool limbs_ok(int L, int K) { return L >= 1 && L <= kMaxL && K >= 2 && K <= kMaxK; }

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 = success)
// or cudaErrorInvalidValue for a shape outside the bounds above. Residue
// tensors are contiguous int64; B is the flattened batch.

int pplp_behz_to_bsk(const void* c0, const void* c1, const void* d0, const void* d1,
                     void* xb, const void* consts, const void* scalars, int B, int L,
                     int K, int logn, void* stream) {
  dim3 grid, block;
  if (!limbs_ok(L, K)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = col_shape(logn, int64_t{4} * B, &grid, &block);
  if (err) return err;
  const Consts k = layout(static_cast<const uint32_t*>(consts),
                          static_cast<const uint32_t*>(scalars), L, K);
  const size_t smem = static_cast<size_t>(L) * block.x * sizeof(uint32_t);
  to_bsk_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(c0), static_cast<const int64_t*>(c1),
      static_cast<const int64_t*>(d0), static_cast<const int64_t*>(d1),
      static_cast<int64_t*>(xb), k, B, L, K, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz_tensor(const void* a0, const void* a1, const void* b0, const void* b1,
                     void* out, const void* q, int B, int Lx, int logn, void* stream) {
  dim3 grid, block;
  const int64_t total = (static_cast<int64_t>(B) * Lx) << logn;
  const int err = elem_shape(total, &grid, &block);
  if (err) return err;
  tensor_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a0), static_cast<const int64_t*>(a1),
      static_cast<const int64_t*>(b0), static_cast<const int64_t*>(b1),
      static_cast<int64_t*>(out), static_cast<const uint32_t*>(q), total, Lx, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz_floor_sk(const void* eq, const void* eb, void* out, const void* consts,
                       const void* scalars, int B, int L, int K, int logn,
                       void* stream) {
  dim3 grid, block;
  if (!limbs_ok(L, K)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = col_shape(logn, int64_t{3} * B, &grid, &block);
  if (err) return err;
  const Consts k = layout(static_cast<const uint32_t*>(consts),
                          static_cast<const uint32_t*>(scalars), L, K);
  const size_t smem = static_cast<size_t>(L + K) * block.x * sizeof(uint32_t);
  floor_sk_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(eq), static_cast<const int64_t*>(eb),
      static_cast<int64_t*>(out), k, L, K, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz_lift(const void* c2, void* dig, const void* lift_consts, int B, int L,
                   int D, int logn, void* stream) {
  dim3 grid, block;
  if (L < 1 || L > kMaxL || D < 1 || D > L) return static_cast<int>(cudaErrorInvalidValue);
  const int err = col_shape(logn, B, &grid, &block);
  if (err) return err;
  lift_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(c2), static_cast<int64_t*>(dig),
      static_cast<const uint32_t*>(lift_consts), B, L, D, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz_keyprod(const void* dn, const void* k0, const void* k0s, const void* k1,
                      const void* k1s, void* acc, const void* q, int B, int L, int D,
                      int logn, void* stream) {
  dim3 grid, block;
  const int64_t total = (static_cast<int64_t>(B) * L) << logn;
  const int err = elem_shape(total, &grid, &block);
  if (err) return err;
  keyprod_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(dn), static_cast<const int64_t*>(k0),
      static_cast<const int64_t*>(k0s), static_cast<const int64_t*>(k1),
      static_cast<const int64_t*>(k1s), static_cast<int64_t*>(acc),
      static_cast<const uint32_t*>(q), total, L, D, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz_add(const void* c0, const void* c1, const void* d, void* out, const void* q,
                  int B, int L, int logn, void* stream) {
  dim3 grid, block;
  const int64_t total = (static_cast<int64_t>(B) * L) << logn;
  const int err = elem_shape(total, &grid, &block);
  if (err) return err;
  add_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(c0), static_cast<const int64_t*>(c1),
      static_cast<const int64_t*>(d), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(q), total, L, logn);
  return static_cast<int>(cudaGetLastError());
}

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
