// BEHZ ciphertext multiply + RNS-gadget relinearization for Hopper (sm_90a).
//
// Replaces the Pallas kernel pplp_tpu/bfv/behz_fused.py::_kernel (driven by
// FusedMultiplier._call). It computes what that kernel computes, bit for
// bit, on the m31 profile (every prime below 2^30):
//
//   behz_to_bsk:     Q -> B_sk base extension of the four input polynomials
//                    with the m~ = 2^16 Montgomery correction;
//   behz_tensor_ntt: per (base, batch, limb) block, the forward transforms
//                    of the four inputs, the Karatsuba tensor product (3
//                    products) and the inverse transforms of the three
//                    results, all in shared memory;
//   behz_floor_sk:   fast floor + Shenoy-Kumaresan conversion back to Q;
//   behz_relin_ntt:  per (batch, limb d) block, for each gadget digit g (width
//                    1 or 2): lift the digit of c2 into limb d, transform it,
//                    accumulate its Shoup products with the keys k0[g, d] and
//                    k1[g, d] into two spectral accumulators; then the
//                    inverse transforms of both and the add of (c0, c1).
//
// Design. The TPU kernel holds a batch tile in VMEM through all phases. A
// block's shared memory (227 KB) cannot hold a multiply's working set, but
// it holds one (batch, limb) row group: the phases bound by bytes (the
// transforms, the tensor and key products, the lift, the add) run fused
// around the in-block transform of csrc/ntt_block.cuh, with the rows in
// shared memory as u32. Shared memory per block: 4 rows x 4n bytes for
// behz_tensor_ntt (64 KB at n = 4096, 128 KB at n = 8192) and 3 rows for
// behz_relin_ntt (digits go one at a time: 48 KB at n = 4096, 192 KB at
// n = 16384). The per-coefficient base conversions (to_bsk, floor_sk) keep
// their column design (every limb of one coefficient in a shared-memory
// column, one thread per coefficient). Every intermediate between them is
// u32 in device memory ([component, batch, limb, n]); a multiply makes 3
// launches and a relinearization 1.
//
// Shapes the fused kernels do not hold (n >= 16384 for the tensor kernel,
// n = 32768 for the relinearization) run as separate launches: the u32-I/O
// transforms of csrc/ntt.cu around behz_tensor, behz_lift, behz_keyprod and
// behz_add, all on u32 intermediates. ops/behz_cuda.py dispatches on n.
//
// Arithmetic: Shoup products (x * w mod q = w x - umulhi(w', x) q in
// wrapping u32), canonical results throughout; fast base conversions sum
// lazy Shoup terms (< 2 q_d each) in u64 and reduce once by Barrett
// (floor(2^64 / q) per modulus, exact: the estimate is the quotient or one
// less); tensor products are exact u64 products of canonical values (the
// cross term's operands are sums below 2q, the product below 2^62), reduced
// the same way.
//
// What bounds it. At n = 4096, batch 256, a multiply + relinearization
// does ~1.1e9 Shoup products and its four kernels move ~1.0 GB: ~0.20 ms at
// the H100's integer-multiply peak, ~0.30 ms at 3.35 TB/s. The kernels take
// ~0.93 ms on an H100, held by integer instruction issue rather than by
// either peak: the compare-subtracts and adds around each product, and the
// u64 Barrett reductions of the conversions, which cost several multiplies
// each where the count takes one.
//
// Bounds: L <= 40 limbs in Q and K = |B_sk| <= 48 limbs (the per-coefficient
// columns take (L + K) * 128 * 4 bytes of shared memory, at most 44 KB).

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_block.cuh"

namespace {

using pplp::barrett;
using pplp::csub;
using pplp::kMaxThreads;

constexpr int kMaxL = 40;
constexpr int kMaxK = 48;
constexpr int kColThreads = 128;   // coefficients per block, per-coefficient phases
constexpr int kElemThreads = 256;  // residues per block, per-element phases
constexpr uint32_t kNoLimb = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t add_mod(uint32_t x, uint32_t y, uint32_t q) {
  return csub(x + y, q);  // x, y < q < 2^30
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t x, uint32_t y, uint32_t q) {
  return x >= y ? x - y : x + q - y;
}

__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint32_t w, uint32_t ws,
                                               uint32_t q) {
  return pplp::shoup_lazy(x, w, ws, q);
}

__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w, uint32_t ws, uint32_t q) {
  return csub(shoup_lazy(x, w, ws, q), q);
}

// The multiplier's constants, one u32 buffer packed by ops/behz_cuda.py
// (_pack_constants) in exactly this order; l = K - 1. Pairs *_w / *_ws are a
// constant and its Shoup companion; conversion tables are row-major
// [destination][source]. muq / mub are floor(2^64 / q) of Q and B_sk (the
// NTT tables' Barrett constants, ops/ntt_cuda.py::table_buffers).
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
  const uint64_t *muq, *mub;                        // [L], [K]
};

// Host side: cut the device buffer into its arrays (pointer arithmetic only;
// the four scalars are passed in from the host copy).
Consts layout(const uint32_t* base, const uint32_t* host_scalars, const void* muq,
              const void* mub, int L, int K) {
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
  c.muq = static_cast<const uint64_t*>(muq);
  c.mub = static_cast<const uint64_t*>(mub);
  return c;
}

// One base's transform tables (ops/ntt_cuda.py::table_buffers): q, the
// interleaved (w, w_shoup) forward and inverse tables [Lx][n], n^-1 and its
// companion, floor(2^64 / q).
struct Base {
  const uint32_t* q;
  const uint2* tw;
  const uint2* itw;
  const uint32_t* n_inv;
  const uint32_t* n_inv_shoup;
  const uint64_t* mu;
};

// One of two bases, field by field (a reference to either kernel parameter
// would copy both to local memory).
__device__ __forceinline__ Base pick(bool first, const Base& a, const Base& b) {
  return Base{first ? a.q : b.q,         first ? a.tw : b.tw,
              first ? a.itw : b.itw,     first ? a.n_inv : b.n_inv,
              first ? a.n_inv_shoup : b.n_inv_shoup, first ? a.mu : b.mu};
}

// Row and coefficient of this thread in a per-coefficient phase: the grid
// has rows * (n / blockDim.x) blocks.
__device__ __forceinline__ void row_coeff(int logn, int64_t* row, int* coeff) {
  const int per_row = (1 << logn) / blockDim.x;
  *row = blockIdx.x / per_row;
  *coeff = static_cast<int>(blockIdx.x % per_row) * blockDim.x + threadIdx.x;
}

// x [B, L, n] for each of c0, c1, d0, d1 -> xb [4, B, K, n] (u32).
__global__ void to_bsk_kernel(const int64_t* __restrict__ c0,
                              const int64_t* __restrict__ c1,
                              const int64_t* __restrict__ d0,
                              const int64_t* __restrict__ d1,
                              uint32_t* __restrict__ xb, Consts k, int B, int L, int K,
                              int logn) {
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

  uint32_t* dst = xb + row * K * n + c;
  for (int d = 0; d < K; ++d) {
    const uint32_t qd = k.qb[d];
    uint64_t acc = 0;
    for (int i = 0; i < L; ++i) {
      acc += shoup_lazy(col[i * T + tid], k.cqb_w[d * L + i], k.cqb_ws[d * L + i], qd);
    }
    uint32_t v = barrett(acc, qd, k.mub[d]);
    v = add_mod(v, shoup(r, k.qmb_w[d], k.qmb_ws[d], qd), qd);
    dst[static_cast<int64_t>(d) * n] = shoup(v, k.imt_w[d], k.imt_ws[d], qd);
  }
}

// e0 = x0 y0, e1 = (x0 + x1)(y0 + y1) - e0 - e2, e2 = x1 y1 mod q, on
// canonical operands.
__device__ __forceinline__ void karatsuba(uint32_t x0, uint32_t x1, uint32_t y0, uint32_t y1,
                                          uint32_t q, uint64_t mu, uint32_t* e0,
                                          uint32_t* e1, uint32_t* e2) {
  *e0 = barrett(static_cast<uint64_t>(x0) * y0, q, mu);
  *e2 = barrett(static_cast<uint64_t>(x1) * y1, q, mu);
  const uint32_t cross = barrett(static_cast<uint64_t>(x0 + x1) * (y0 + y1), q, mu);
  *e1 = sub_mod(sub_mod(cross, *e0, q), *e2, q);
}

__device__ __forceinline__ void karatsuba4(uint4 x0, uint4 x1, uint4 y0, uint4 y1, uint32_t q,
                                           uint64_t mu, uint4* e0, uint4* e1, uint4* e2) {
  karatsuba(x0.x, x1.x, y0.x, y1.x, q, mu, &e0->x, &e1->x, &e2->x);
  karatsuba(x0.y, x1.y, y0.y, y1.y, q, mu, &e0->y, &e1->y, &e2->y);
  karatsuba(x0.z, x1.z, y0.z, y1.z, q, mu, &e0->z, &e1->z, &e2->z);
  karatsuba(x0.w, x1.w, y0.w, y1.w, q, mu, &e0->w, &e1->w, &e2->w);
}

// Blocks [0, B L) take limb l of batch b over Q (int64 c0, c1, d0, d1
// [B, L, n]); blocks [B L, B (L + K)) take limb l over B_sk (u32 xb
// [4, B, K, n]). Each writes the coefficient-domain products of its limb to
// eq [3, B, L, n] or eb [3, B, K, n] (u32).
__global__ void __launch_bounds__(kMaxThreads)
tensor_ntt_kernel(const int64_t* __restrict__ c0, const int64_t* __restrict__ c1,
                  const int64_t* __restrict__ d0, const int64_t* __restrict__ d1,
                  const uint32_t* __restrict__ xb, uint32_t* __restrict__ eq,
                  uint32_t* __restrict__ eb, Base tq, Base tb, int B, int L, int K,
                  int logn) {
  uint32_t* a = pplp::dyn_smem();
  const int n = 1 << logn;
  int64_t blk = blockIdx.x;
  const bool on_q = blk < static_cast<int64_t>(B) * L;
  if (!on_q) blk -= static_cast<int64_t>(B) * L;
  const int Lx = on_q ? L : K;
  const Base t = pick(on_q, tq, tb);
  const int limb = static_cast<int>(blk % Lx);
  const int64_t off = blk * n;                        // (b * Lx + limb) * n
  const int64_t plane = static_cast<int64_t>(B) * Lx * n;  // one component

  if (on_q) {
    for (int c = threadIdx.x; c < n / 4; c += blockDim.x) {  // the four rows' loads together
      const uint4 v0 = pplp::ld_i64x4(c0 + off, 4 * c), v1 = pplp::ld_i64x4(c1 + off, 4 * c);
      const uint4 v2 = pplp::ld_i64x4(d0 + off, 4 * c), v3 = pplp::ld_i64x4(d1 + off, 4 * c);
      pplp::st4(a, 4 * c, v0);
      pplp::st4(a + n, 4 * c, v1);
      pplp::st4(a + 2 * n, 4 * c, v2);
      pplp::st4(a + 3 * n, 4 * c, v3);
    }
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) pplp::load_row_async(xb + p * plane + off, a + p * n, n);
    pplp::cp_async_wait_all();
  }
  __syncthreads();

  const uint32_t q = t.q[limb];
  pplp::ntt_fwd_block(a, 4, logn, t.tw + static_cast<int64_t>(limb) * n, q);
  const uint64_t mu = t.mu[limb];
  for (int c = threadIdx.x; c < n / 4; c += blockDim.x) {
    uint4 e0, e1, e2;
    karatsuba4(pplp::ld4(a, 4 * c), pplp::ld4(a + n, 4 * c), pplp::ld4(a + 2 * n, 4 * c),
               pplp::ld4(a + 3 * n, 4 * c), q, mu, &e0, &e1, &e2);
    pplp::st4(a, 4 * c, e0);
    pplp::st4(a + n, 4 * c, e1);
    pplp::st4(a + 2 * n, 4 * c, e2);
  }
  __syncthreads();
  pplp::ntt_inv_block(a, 3, logn, t.itw + static_cast<int64_t>(limb) * n, q,
                         t.n_inv[limb], t.n_inv_shoup[limb]);
  uint32_t* dst = (on_q ? eq : eb) + off;
#pragma unroll
  for (int p = 0; p < 3; ++p) pplp::store_row(a + p * n, dst + p * plane, n);
}

// eq [3, B, L, n], eb [3, B, K, n] (u32 coefficients) -> out [3, B, L, n].
__global__ void floor_sk_kernel(const uint32_t* __restrict__ eq,
                                const uint32_t* __restrict__ eb,
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
  const uint32_t* srcq = eq + row * L * n + c;
  for (int i = 0; i < L; ++i) {
    const uint32_t qi = k.qq[i];
    const uint32_t e = srcq[static_cast<int64_t>(i) * n];
    ys[i * T + tid] = shoup(shoup(e, k.tq_w[i], k.tq_ws[i], qi), k.qhi_w[i], k.qhi_ws[i], qi);
  }
  // w_d = (t e_d - conv_d(y)) q^-1 mod b_d over B_sk.
  const uint32_t* srcb = eb + row * K * n + c;
  for (int d = 0; d < K; ++d) {
    const uint32_t qd = k.qb[d];
    uint64_t acc = 0;
    for (int i = 0; i < L; ++i) {
      acc += shoup_lazy(ys[i * T + tid], k.cqb_w[d * L + i], k.cqb_ws[d * L + i], qd);
    }
    const uint32_t conv = barrett(acc, qd, k.mub[d]);
    const uint32_t e = srcb[static_cast<int64_t>(d) * n];
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
  const uint32_t conv_msk = barrett(am, msk, k.mub[l]);
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
    uint32_t v = sub_mod(barrett(acc, qd, k.muq[d]),
                         shoup(alpha, k.mmq_w[d], k.mmq_ws[d], qd), qd);
    if (high) v = add_mod(v, k.mskm[d], qd);
    dst[static_cast<int64_t>(d) * n] = v;
  }
}

// The digit of c2 (r0 from limb i0 and, for a two-limb digit, r1 from limb
// i1) lifted into limb d. rec: the digit's record of the lift buffer (i0,
// i1 or kNoLimb, q0^-1 mod q1 and its companion, then (q0 mod q_d, its
// companion) for d < L); qq: q [L]; mu: floor(2^64 / q) [L].
__device__ __forceinline__ uint32_t lift(uint32_t r0, uint32_t r1, const uint32_t* rec,
                                         const uint32_t* qq, const uint64_t* mu, int d) {
  const uint32_t qd = qq[d];
  const uint32_t r0d = barrett(r0, qd, mu[d]);
  if (rec[1] == kNoLimb) return r0d;
  const uint32_t q1 = qq[rec[1]];
  const uint32_t t = shoup(sub_mod(r1, barrett(r0, q1, mu[rec[1]]), q1), rec[2], rec[3], q1);
  return add_mod(r0d, shoup(t, rec[4 + 2 * d], rec[5 + 2 * d], qd), qd);
}

__device__ __forceinline__ void st_i64x4(int64_t* __restrict__ p, int i, uint4 v) {
  reinterpret_cast<longlong2*>(p + i)[0] = make_longlong2(v.x, v.y);
  reinterpret_cast<longlong2*>(p + i)[1] = make_longlong2(v.z, v.w);
}

// acc += (x * k mod q) elementwise for both keys of one packed (k0, k0',
// k1, k1') uint4 per coefficient.
__device__ __forceinline__ void keyprod4(uint4 x, const uint4* __restrict__ key, uint32_t q,
                                         uint4* s0, uint4* s1) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  uint32_t* a0[4] = {&s0->x, &s0->y, &s0->z, &s0->w};
  uint32_t* a1[4] = {&s1->x, &s1->y, &s1->z, &s1->w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint4 k = __ldg(key + e);
    *a0[e] = add_mod(*a0[e], shoup(xs[e], k.x, k.y, q), q);
    *a1[e] = add_mod(*a1[e], shoup(xs[e], k.z, k.w, q), q);
  }
}

__device__ __forceinline__ uint4 add4(uint4 x, uint4 y, uint32_t q) {
  return make_uint4(add_mod(x.x, y.x, q), add_mod(x.y, y.y, q), add_mod(x.z, y.z, q),
                    add_mod(x.w, y.w, q));
}

// One block per (batch b, limb d): out [2, B, L, n] = (c0, c1) + the key
// switch of c2 (each [B, L, n] int64). Shared memory: the digit row and two
// spectral accumulators. keys: [D, L, n] packed uint4; lc: q [L], then the
// lift records. Every thread owns the same 4-coefficient units in the
// lift, the key products and the add, so only the transforms synchronise.
__global__ void __launch_bounds__(kMaxThreads)
relin_ntt_kernel(const int64_t* __restrict__ c0, const int64_t* __restrict__ c1,
                 const int64_t* __restrict__ c2, int64_t* __restrict__ out,
                 const uint32_t* __restrict__ lc, const uint4* __restrict__ keys, Base tq,
                 int B, int L, int D, int logn) {
  uint32_t* dig = pplp::dyn_smem();
  const int n = 1 << logn;
  uint32_t* acc = dig + n;  // two rows
  const int64_t b = blockIdx.x / L;
  const int d = static_cast<int>(blockIdx.x % L);
  const int64_t own = (b * L + d) * n;
  const int64_t* c2b = c2 + b * L * n;
  const uint32_t qd = tq.q[d];
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = threadIdx.x; c < n / 4; c += blockDim.x) {
    pplp::st4(acc, 4 * c, zero);
    pplp::st4(acc + n, 4 * c, zero);
  }
  for (int g = 0; g < D; ++g) {
    const uint32_t* rec = lc + L + g * (4 + 2 * L);
    const int64_t* r0p = c2b + static_cast<int64_t>(rec[0]) * n;
    const int64_t* r1p = rec[1] == kNoLimb ? r0p : c2b + static_cast<int64_t>(rec[1]) * n;
    for (int c = threadIdx.x; c < n / 4; c += blockDim.x) {
      const uint4 r0 = pplp::ld_i64x4(r0p, 4 * c);
      const uint4 r1 = pplp::ld_i64x4(r1p, 4 * c);
      pplp::st4(dig, 4 * c,
                make_uint4(lift(r0.x, r1.x, rec, lc, tq.mu, d), lift(r0.y, r1.y, rec, lc, tq.mu, d),
                           lift(r0.z, r1.z, rec, lc, tq.mu, d),
                           lift(r0.w, r1.w, rec, lc, tq.mu, d)));
    }
    __syncthreads();
    pplp::ntt_fwd_block(dig, 1, logn, tq.tw + static_cast<int64_t>(d) * n, qd);
    const uint4* kg = keys + (static_cast<int64_t>(g) * L + d) * n;
    for (int c = threadIdx.x; c < n / 4; c += blockDim.x) {
      uint4 s0 = pplp::ld4(acc, 4 * c), s1 = pplp::ld4(acc + n, 4 * c);
      keyprod4(pplp::ld4(dig, 4 * c), kg + 4 * c, qd, &s0, &s1);
      pplp::st4(acc, 4 * c, s0);
      pplp::st4(acc + n, 4 * c, s1);
    }
  }
  __syncthreads();
  pplp::ntt_inv_block(acc, 2, logn, tq.itw + static_cast<int64_t>(d) * n, qd,
                         tq.n_inv[d], tq.n_inv_shoup[d]);
  const int64_t plane = static_cast<int64_t>(B) * L * n;
  for (int c = threadIdx.x; c < n / 4; c += blockDim.x) {
    st_i64x4(out + own, 4 * c,
             add4(pplp::ld_i64x4(c0 + own, 4 * c), pplp::ld4(acc, 4 * c), qd));
    st_i64x4(out + plane + own, 4 * c,
             add4(pplp::ld_i64x4(c1 + own, 4 * c), pplp::ld4(acc + n, 4 * c), qd));
  }
}

// ---- the separate launches of the shapes the fused kernels do not hold ----

// Karatsuba over one base: spectra [4, B, Lx, n] -> out [3, B, Lx, n] (u32).
__global__ void tensor_kernel(const uint32_t* __restrict__ spec, uint32_t* __restrict__ out,
                              const uint32_t* __restrict__ q_limb,
                              const uint64_t* __restrict__ mu_limb, int64_t total, int Lx,
                              int logn) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int limb = static_cast<int>((e >> logn) % Lx);
  uint32_t e0, e1, e2;
  karatsuba(spec[e], spec[total + e], spec[2 * total + e], spec[3 * total + e], q_limb[limb],
            mu_limb[limb], &e0, &e1, &e2);
  out[e] = e0;
  out[total + e] = e1;
  out[2 * total + e] = e2;
}

// Gadget digits of c2 [B, L, n] lifted into every limb -> dig [D, B, L, n].
__global__ void lift_kernel(const int64_t* __restrict__ c2, uint32_t* __restrict__ dig,
                            const uint32_t* __restrict__ lc, const uint64_t* __restrict__ mu,
                            int B, int L, int D, int logn) {
  const int n = 1 << logn;
  int64_t b;
  int c;
  row_coeff(logn, &b, &c);
  const int64_t* src = c2 + b * L * n + c;
  for (int g = 0; g < D; ++g) {
    const uint32_t* rec = lc + L + g * (4 + 2 * L);
    const uint32_t r0 = static_cast<uint32_t>(src[static_cast<int64_t>(rec[0]) * n]);
    const uint32_t r1 =
        rec[1] == kNoLimb ? r0 : static_cast<uint32_t>(src[static_cast<int64_t>(rec[1]) * n]);
    uint32_t* dst = dig + (static_cast<int64_t>(g) * B + b) * L * n + c;
    for (int d = 0; d < L; ++d) dst[static_cast<int64_t>(d) * n] = lift(r0, r1, rec, lc, mu, d);
  }
}

// Digit spectra dn [D, B, L, n], packed keys [D, L, n] -> acc [2, B, L, n].
__global__ void keyprod_kernel(const uint32_t* __restrict__ dn, const uint4* __restrict__ keys,
                               uint32_t* __restrict__ acc, const uint32_t* __restrict__ q_limb,
                               int64_t total, int L, int D, int logn) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t mask = (int64_t{1} << logn) - 1;
  const int limb = static_cast<int>((e >> logn) % L);
  const int64_t kpos = (static_cast<int64_t>(limb) << logn) | (e & mask);
  const int64_t kstride = static_cast<int64_t>(L) << logn;
  const uint32_t q = q_limb[limb];
  uint32_t s0 = 0, s1 = 0;
  for (int g = 0; g < D; ++g) {
    const uint32_t x = dn[g * total + e];
    const uint4 k = __ldg(keys + g * kstride + kpos);
    s0 = add_mod(s0, shoup(x, k.x, k.y, q), q);
    s1 = add_mod(s1, shoup(x, k.z, k.w, q), q);
  }
  acc[e] = s0;
  acc[total + e] = s1;
}

// out [2, B, L, n] = (c0 + d[0], c1 + d[1]) mod q; c0, c1 int64, d u32.
__global__ void add_kernel(const int64_t* __restrict__ c0, const int64_t* __restrict__ c1,
                           const uint32_t* __restrict__ d, int64_t* __restrict__ out,
                           const uint32_t* __restrict__ q_limb, int64_t total, int L,
                           int logn) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const uint32_t q = q_limb[(e >> logn) % L];
  out[e] = add_mod(static_cast<uint32_t>(c0[e]), d[e], q);
  out[total + e] = add_mod(static_cast<uint32_t>(c1[e]), d[total + e], q);
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

// Grid, block and shared memory of a fused kernel: `rows` rows of n in
// shared memory, `blocks` blocks; cudaErrorInvalidValue where they do not
// fit. Threads cover one row's groups (256 at n = 4096) whatever the rows:
// more resident blocks per SM overlap one block's loads with another's
// butterflies (on an H100 the tensor kernel ran 7% faster than with 512).
int fused_shape(int logn, int rows, int64_t blocks, dim3* grid, dim3* block, size_t* smem) {
  if (logn < 6 || logn > 15 || blocks <= 0 || blocks >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *smem = static_cast<size_t>(4 * rows) << logn;
  if (*smem > pplp::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(static_cast<unsigned>(blocks));
  *block = dim3(pplp::block_threads(1 << logn));
  return 0;
}

Base base_of(const void* const* t) {
  return Base{static_cast<const uint32_t*>(t[0]), static_cast<const uint2*>(t[1]),
              static_cast<const uint2*>(t[2]), static_cast<const uint32_t*>(t[3]),
              static_cast<const uint32_t*>(t[4]), static_cast<const uint64_t*>(t[5])};
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 = success)
// or cudaErrorInvalidValue for a shape outside the bounds above. Residue
// tensors are contiguous and 16-byte aligned, int64 or u32 as named; B is
// the flattened batch. A base's tables are passed as the array of six
// device pointers (q, tw, itw, n_inv, n_inv_shoup, mu) of Base.

int pplp_behz_to_bsk(const void* c0, const void* c1, const void* d0, const void* d1,
                     void* xb, const void* consts, const void* scalars, const void* muq,
                     const void* mub, int B, int L, int K, int logn, void* stream) {
  dim3 grid, block;
  if (!limbs_ok(L, K)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = col_shape(logn, int64_t{4} * B, &grid, &block);
  if (err) return err;
  const Consts k = layout(static_cast<const uint32_t*>(consts),
                          static_cast<const uint32_t*>(scalars), muq, mub, L, K);
  const size_t smem = static_cast<size_t>(L) * block.x * sizeof(uint32_t);
  to_bsk_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(c0), static_cast<const int64_t*>(c1),
      static_cast<const int64_t*>(d0), static_cast<const int64_t*>(d1),
      static_cast<uint32_t*>(xb), k, B, L, K, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz_tensor_ntt(const void* c0, const void* c1, const void* d0, const void* d1,
                         const void* xb, void* eq, void* eb, const void* const* tq,
                         const void* const* tb, int B, int L, int K, int logn,
                         void* stream) {
  dim3 grid, block;
  size_t smem;
  if (!limbs_ok(L, K)) return static_cast<int>(cudaErrorInvalidValue);
  int err = fused_shape(logn, 4, static_cast<int64_t>(B) * (L + K), &grid, &block, &smem);
  if (err) return err;
  err = pplp::allow_smem(tensor_ntt_kernel, smem);
  if (err) return err;
  tensor_ntt_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(c0), static_cast<const int64_t*>(c1),
      static_cast<const int64_t*>(d0), static_cast<const int64_t*>(d1),
      static_cast<const uint32_t*>(xb), static_cast<uint32_t*>(eq), static_cast<uint32_t*>(eb),
      base_of(tq), base_of(tb), B, L, K, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz_floor_sk(const void* eq, const void* eb, void* out, const void* consts,
                       const void* scalars, const void* muq, const void* mub, int B, int L,
                       int K, int logn, void* stream) {
  dim3 grid, block;
  if (!limbs_ok(L, K)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = col_shape(logn, int64_t{3} * B, &grid, &block);
  if (err) return err;
  const Consts k = layout(static_cast<const uint32_t*>(consts),
                          static_cast<const uint32_t*>(scalars), muq, mub, L, K);
  const size_t smem = static_cast<size_t>(L + K) * block.x * sizeof(uint32_t);
  floor_sk_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(eq), static_cast<const uint32_t*>(eb),
      static_cast<int64_t*>(out), k, L, K, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz_relin_ntt(const void* c0, const void* c1, const void* c2, void* out,
                        const void* lift_consts, const void* keys, const void* const* tq, int B,
                        int L, int D, int logn, void* stream) {
  dim3 grid, block;
  size_t smem;
  if (L < 1 || L > kMaxL || D < 1 || D > L) return static_cast<int>(cudaErrorInvalidValue);
  int err = fused_shape(logn, 3, static_cast<int64_t>(B) * L, &grid, &block, &smem);
  if (err) return err;
  err = pplp::allow_smem(relin_ntt_kernel, smem);
  if (err) return err;
  relin_ntt_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(c0), static_cast<const int64_t*>(c1),
      static_cast<const int64_t*>(c2), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(lift_consts), static_cast<const uint4*>(keys), base_of(tq),
      B, L, D, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz_tensor(const void* spec, void* out, const void* q, const void* mu, int B, int Lx,
                     int logn, void* stream) {
  dim3 grid, block;
  const int64_t total = (static_cast<int64_t>(B) * Lx) << logn;
  const int err = elem_shape(total, &grid, &block);
  if (err) return err;
  tensor_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(spec), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(q), static_cast<const uint64_t*>(mu), total, Lx, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz_lift(const void* c2, void* dig, const void* lift_consts, const void* mu, int B,
                   int L, int D, int logn, void* stream) {
  dim3 grid, block;
  if (L < 1 || L > kMaxL || D < 1 || D > L) return static_cast<int>(cudaErrorInvalidValue);
  const int err = col_shape(logn, B, &grid, &block);
  if (err) return err;
  lift_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(c2), static_cast<uint32_t*>(dig),
      static_cast<const uint32_t*>(lift_consts), static_cast<const uint64_t*>(mu), B, L, D, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz_keyprod(const void* dn, const void* keys, void* acc, const void* q, int B, int L,
                      int D, int logn, void* stream) {
  dim3 grid, block;
  const int64_t total = (static_cast<int64_t>(B) * L) << logn;
  const int err = elem_shape(total, &grid, &block);
  if (err) return err;
  keyprod_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dn), static_cast<const uint4*>(keys),
      static_cast<uint32_t*>(acc), static_cast<const uint32_t*>(q), total, L, D, logn);
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
      static_cast<const uint32_t*>(d), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(q), total, L, logn);
  return static_cast<int>(cudaGetLastError());
}

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
