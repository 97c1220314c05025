// BEHZ ciphertext multiply + RNS-gadget relinearization on the m62 profile
// (the seal chains, 2^32 <= q < 2^62) for Hopper (sm_90a): the u64 route.
//
// Replaces no Pallas kernel: the reference runs the m62 multiply through
// XLA on (lo, hi) u32 pairs (pplp_tpu/bfv/behz.py:388-422,
// RnsMultiplier.multiply, and :772-785, relinearize; its fused Pallas
// kernel refuses m62). It computes what those compute, bit for bit, as
// separate launches around the u64 transforms of csrc/ntt.cu (one launch per
// base and direction, ops/ntt_cuda.py):
//
//   behz64_to_bsk:   Q -> B_sk base extension of the four inputs with the
//                    m~ = 2^16 Montgomery correction (one thread per
//                    coefficient, its column of L residues in shared memory);
//   behz64_tensor:   the Karatsuba tensor product of the spectra over Q and
//                    over B_sk, both bases in one launch;
//   behz64_floor_sk: fast floor t e / q in B_sk, then Shenoy-Kumaresan back
//                    to Q (one thread per coefficient, L + K residues of
//                    shared memory each);
//   behz64_lift:     the gadget digits of c2 (one or two limbs each, from the
//                    keys' groups) lifted into every limb;
//   behz64_keyprod:  sum over digits of digit spectrum x (k0, k1), with the
//                    keys' 64-bit Shoup companions;
//   behz64_add:      (c0 + d0, c1 + d1) mod q.
//
// A multiply is to_bsk, two forward transforms (Q, B_sk), tensor, two
// inverse transforms and floor_sk: 7 launches; a relinearization is lift,
// one forward, keyprod, one inverse and add: 5. Every intermediate is u64 in
// device memory (int64 tensors with the same bits, [component, batch, limb,
// n]); every kernel reads and writes canonical residues, so each output
// equals the plain step's (bfv/behz.py) bit for bit.
//
// Arithmetic. Shoup products x w mod q = w x - umul64hi(w', x) q in
// wrapping u64 with w' = floor(w 2^64 / q), valid for any x < 2^64. General
// products (the tensor's, the base conversions' sums) are exact 128-bit
// values reduced by Barrett with floor(2^128 / q) = (r1, r0) (r1 < 2^32):
// the estimate floor(z r / 2^128) is the quotient or one less, so z - est q,
// formed in wrapping u64, needs one conditional subtract. A fast base
// conversion sums its products exactly in a 128-bit accumulator: every
// product has one factor below 2^60 (a B_sk prime, a residue mod one, or a
// constant reduced mod one; ops/behz64_cuda.py checks the B_sk primes) and
// the other below 2^62, so it stays below 2^122, and a sum of at most
// max(L, K - 1) <= 47 of them below 2^127.6. On the seal chains the sums
// stay below 2^121. The tensor product's operands are canonical sums below
// 2q < 2^63, so its products stay below 2^126.
//
// What bounds it. At n = 4096, batch 256, |B_sk| = 5, width 1 the seven
// multiply launches move 1.96 GB and the five of the relinearization 0.63 GB
// at their interfaces (0.77 ms at 3.35 TB/s); a general 64 x 64 product
// mod q needs about two Shoup products' worth of 32-bit multiplies, so
// floor_sk's conversions are bound by integer work
// (measure_multiply.kernel_counts64). This is the simple first route: every
// stage crosses device memory. Fusing the tensor and key products with the
// in-block u64 transforms (csrc/ntt_block64.cuh: ntt_fwd_block64 /
// ntt_inv_block64), as csrc/behz.cu does on m31, is the next step.
//
// Bounds: L <= 40 limbs in Q and K = |B_sk| <= 48 (the per-coefficient
// columns take up to (L + K) x 128 x 8 bytes of shared memory, 88 KB),
// checked here and in ops/behz64_cuda.py; D <= L digits.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_block64.cuh"

namespace {

using pplp::csub64;
using pplp::shoup_lazy64;

constexpr int kMaxL = 40;
constexpr int kMaxK = 48;
constexpr int kColThreads = 128;   // coefficients per block, per-coefficient phases
constexpr int kElemThreads = 256;  // residues per block, per-element phases
constexpr uint64_t kNoLimb = ~uint64_t{0};

__device__ __forceinline__ uint64_t add_mod(uint64_t x, uint64_t y, uint64_t q) {
  return csub64(x + y, q);  // x, y < q < 2^62
}

__device__ __forceinline__ uint64_t sub_mod(uint64_t x, uint64_t y, uint64_t q) {
  return x >= y ? x - y : x + q - y;
}

__device__ __forceinline__ uint64_t shoup(uint64_t x, uint64_t w, uint64_t ws, uint64_t q) {
  return csub64(shoup_lazy64(x, w, ws, q), q);
}

// (z1 2^64 + z0) mod q for any z < 2^128, r = floor(2^128 / q) = r1 2^64 + r0.
// est = floor(z r / 2^128) mod 2^64 is word 2 of the product z r: the high
// words of z0 r1 and z1 r0, the low word of z1 r1, and the carries of word 1.
__device__ __forceinline__ uint64_t barrett128(uint64_t z1, uint64_t z0, uint64_t q,
                                               uint64_t r0, uint64_t r1) {
  const uint64_t a = __umul64hi(z0, r0);
  const uint64_t b = z0 * r1;
  const uint64_t c = z1 * r0;
  uint64_t w1 = a + b;
  uint64_t carry = w1 < a;
  w1 += c;
  carry += w1 < c;
  const uint64_t est = __umul64hi(z0, r1) + __umul64hi(z1, r0) + z1 * r1 + carry;
  return csub64(z0 - est * q, q);
}

__device__ __forceinline__ uint64_t mulmod(uint64_t x, uint64_t y, uint64_t q, uint64_t r0,
                                           uint64_t r1) {
  return barrett128(__umul64hi(x, y), x * y, q, r0, r1);
}

// A sum of products below 2^128 (the header's bound): acc = hi 2^64 + lo.
struct Acc {
  uint64_t lo = 0, hi = 0;

  __device__ __forceinline__ void mac(uint64_t x, uint64_t y) {
    const uint64_t plo = x * y;
    lo += plo;
    hi += __umul64hi(x, y) + (lo < plo);
  }

  __device__ __forceinline__ uint64_t reduce(uint64_t q, const uint64_t* r) const {
    return barrett128(hi, lo, q, r[0], r[1]);
  }
};

// The multiplier's constants: four scalars, passed from host memory at each
// launch, then the arrays of one u64 device buffer packed by
// ops/behz64_cuda.py (_pack_constants) in exactly this order; l = K - 1.
// Pairs *_w / *_ws are a constant and its 64-bit Shoup companion;
// conversion tables are row-major [destination][source] plain constants
// (their products are summed in 128 bits); rq / rb are floor(2^128 / q) of
// Q and B_sk as (low, high) words.
struct Consts {
  uint64_t neg_inv_q_mt, imm_w, imm_ws, msk_half;  // scalars
  const uint64_t *qq, *qb;                          // [L], [K]
  const uint64_t *rq, *rb;                          // [L][2], [K][2]
  const uint64_t *mqh_w, *mqh_ws;                   // [L]  m~ qhat_i^-1 mod q_i
  const uint64_t* cqb;                              // [K][L] (q / q_i) mod b_d
  const uint64_t* cqm;                              // [L]  (q / q_i) mod m~
  const uint64_t *qmb_w, *qmb_ws;                   // [K]  q mod b_d
  const uint64_t *imt_w, *imt_ws;                   // [K]  m~^-1 mod b_d
  const uint64_t *tq_w, *tq_ws;                     // [L]  t mod q_i
  const uint64_t *tb_w, *tb_ws;                     // [K]  t mod b_d
  const uint64_t *iqb_w, *iqb_ws;                   // [K]  q^-1 mod b_d
  const uint64_t *qhi_w, *qhi_ws;                   // [L]  qhat_i^-1 mod q_i
  const uint64_t *bhat_w, *bhat_ws;                 // [l]  bhat_i^-1 mod b_i
  const uint64_t* cbq;                              // [L][l] (M / b_i) mod q_d
  const uint64_t* cbm;                              // [l]  (M / b_i) mod m_sk
  const uint64_t *mmq_w, *mmq_ws;                   // [L]  M mod q_d
  const uint64_t* mskm;                             // [L]  m_sk M mod q_d
};

// Host side: the four scalars, and the device buffer cut into its arrays
// (pointer arithmetic only).
Consts layout(const uint64_t* base, const uint64_t* host_scalars, int L, int K) {
  const int l = K - 1;
  Consts c;
  c.neg_inv_q_mt = host_scalars[0];
  c.imm_w = host_scalars[1];
  c.imm_ws = host_scalars[2];
  c.msk_half = host_scalars[3];
  const uint64_t* p = base;
  auto take = [&p](int count) {
    const uint64_t* at = p;
    p += count;
    return at;
  };
  c.qq = take(L);
  c.qb = take(K);
  c.rq = take(2 * L);
  c.rb = take(2 * K);
  c.mqh_w = take(L);
  c.mqh_ws = take(L);
  c.cqb = take(K * L);
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
  c.cbq = take(L * l);
  c.cbm = take(l);
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

// x [B, L, n] for each of c0, c1, d0, d1 -> xb [4, B, K, n].
__global__ void to_bsk64_kernel(const uint64_t* __restrict__ c0,
                                const uint64_t* __restrict__ c1,
                                const uint64_t* __restrict__ d0,
                                const uint64_t* __restrict__ d1, uint64_t* __restrict__ xb,
                                Consts k, int B, int L, int K, int logn) {
  uint64_t* col = pplp::dyn_smem64();  // y [L][blockDim.x]
  const int n = 1 << logn;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  int64_t row;
  int c;
  row_coeff(logn, &row, &c);
  const int p = static_cast<int>(row / B);
  const int64_t b = row % B;
  const uint64_t* src = (p == 0 ? c0 : p == 1 ? c1 : p == 2 ? d0 : d1) + b * L * n + c;

  uint32_t acc16 = 0;  // mod 2^16, on the low 16 bits of each y
  for (int i = 0; i < L; ++i) {
    const uint64_t y = shoup(src[static_cast<int64_t>(i) * n], k.mqh_w[i], k.mqh_ws[i], k.qq[i]);
    col[i * T + tid] = y;
    acc16 = (acc16 + (static_cast<uint32_t>(y) & 0xFFFFu) * static_cast<uint32_t>(k.cqm[i])) &
            0xFFFFu;
  }
  const uint64_t r = (acc16 * static_cast<uint32_t>(k.neg_inv_q_mt)) & 0xFFFFu;

  uint64_t* dst = xb + row * K * n + c;
  for (int d = 0; d < K; ++d) {
    const uint64_t qd = k.qb[d];
    Acc acc;
    for (int i = 0; i < L; ++i) acc.mac(col[i * T + tid], k.cqb[d * L + i]);
    uint64_t v = acc.reduce(qd, k.rb + 2 * d);
    v = add_mod(v, shoup(r, k.qmb_w[d], k.qmb_ws[d], qd), qd);
    dst[static_cast<int64_t>(d) * n] = shoup(v, k.imt_w[d], k.imt_ws[d], qd);
  }
}

// Karatsuba over both bases: spectra sq [4, B, L, n] and sb [4, B, K, n] ->
// eq [3, B, L, n] and eb [3, B, K, n]; e0 = x0 y0, e2 = x1 y1,
// e1 = (x0 + x1)(y0 + y1) - e0 - e2 mod q.
__global__ void tensor64_kernel(const uint64_t* __restrict__ sq, const uint64_t* __restrict__ sb,
                                uint64_t* __restrict__ eq, uint64_t* __restrict__ eb, Consts k,
                                int64_t total_q, int64_t total_b, int L, int K, int logn) {
  int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool on_q = e < total_q;
  if (!on_q) e -= total_q;
  const int64_t total = on_q ? total_q : total_b;
  if (e >= total) return;
  const uint64_t* spec = on_q ? sq : sb;
  uint64_t* out = on_q ? eq : eb;
  const int limb = static_cast<int>((e >> logn) % (on_q ? L : K));
  const uint64_t q = on_q ? k.qq[limb] : k.qb[limb];
  const uint64_t* r = (on_q ? k.rq : k.rb) + 2 * limb;
  const uint64_t x0 = spec[e], x1 = spec[total + e];
  const uint64_t y0 = spec[2 * total + e], y1 = spec[3 * total + e];
  const uint64_t e0 = mulmod(x0, y0, q, r[0], r[1]);
  const uint64_t e2 = mulmod(x1, y1, q, r[0], r[1]);
  const uint64_t cross = mulmod(x0 + x1, y0 + y1, q, r[0], r[1]);  // sums < 2q < 2^63
  out[e] = e0;
  out[total + e] = sub_mod(sub_mod(cross, e0, q), e2, q);
  out[2 * total + e] = e2;
}

// eq [3, B, L, n], eb [3, B, K, n] (coefficients) -> out [3, B, L, n].
__global__ void floor_sk64_kernel(const uint64_t* __restrict__ eq,
                                  const uint64_t* __restrict__ eb, uint64_t* __restrict__ out,
                                  Consts k, int L, int K, int logn) {
  uint64_t* ys = pplp::dyn_smem64();  // y [L][T], then w [K][T]
  const int n = 1 << logn;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int l = K - 1;
  int64_t row;
  int c;
  row_coeff(logn, &row, &c);
  uint64_t* ws = ys + L * T;

  // Fast floor: y_i = (t e_i mod q_i) qhat_i^-1 mod q_i.
  const uint64_t* srcq = eq + row * L * n + c;
  for (int i = 0; i < L; ++i) {
    const uint64_t qi = k.qq[i];
    const uint64_t te = shoup(srcq[static_cast<int64_t>(i) * n], k.tq_w[i], k.tq_ws[i], qi);
    ys[i * T + tid] = shoup(te, k.qhi_w[i], k.qhi_ws[i], qi);
  }
  // w_d = (t e_d - conv_d(y)) q^-1 mod b_d over B_sk.
  const uint64_t* srcb = eb + row * K * n + c;
  for (int d = 0; d < K; ++d) {
    const uint64_t qd = k.qb[d];
    Acc acc;
    for (int i = 0; i < L; ++i) acc.mac(ys[i * T + tid], k.cqb[d * L + i]);
    const uint64_t conv = acc.reduce(qd, k.rb + 2 * d);
    const uint64_t te = shoup(srcb[static_cast<int64_t>(d) * n], k.tb_w[d], k.tb_ws[d], qd);
    ws[d * T + tid] = shoup(sub_mod(te, conv, qd), k.iqb_w[d], k.iqb_ws[d], qd);
  }
  // Shenoy-Kumaresan: y_i = w_i bhat_i^-1 mod b_i (in place), then
  // alpha = (conv_msk(y) - w_msk) M^-1 mod m_sk.
  for (int i = 0; i < l; ++i) {
    ws[i * T + tid] = shoup(ws[i * T + tid], k.bhat_w[i], k.bhat_ws[i], k.qb[i]);
  }
  const uint64_t msk = k.qb[l];
  Acc am;
  for (int i = 0; i < l; ++i) am.mac(ws[i * T + tid], k.cbm[i]);
  const uint64_t conv_msk = am.reduce(msk, k.rb + 2 * l);
  const uint64_t alpha = shoup(sub_mod(conv_msk, ws[l * T + tid], msk), k.imm_w, k.imm_ws, msk);
  const bool high = alpha > k.msk_half;

  uint64_t* dst = out + row * L * n + c;
  for (int d = 0; d < L; ++d) {
    const uint64_t qd = k.qq[d];
    Acc acc;
    for (int i = 0; i < l; ++i) acc.mac(ws[i * T + tid], k.cbq[d * l + i]);
    uint64_t v = sub_mod(acc.reduce(qd, k.rq + 2 * d), shoup(alpha, k.mmq_w[d], k.mmq_ws[d], qd),
                         qd);
    if (high) v = add_mod(v, k.mskm[d], qd);
    dst[static_cast<int64_t>(d) * n] = v;
  }
}

// Gadget digits of c2 [B, L, n] lifted into every limb -> dig [D, B, L, n].
// lc: q [L], floor(2^128 / q) [L][2], then per digit the record i0, i1 (or
// kNoLimb), q0^-1 mod q1 and its companion, then (q0 mod q_d, its
// companion) for d < L. Width 2: t = (r1 - r0) q0^-1 mod q1, and the digit
// in limb d is (r0 mod q_d) + (q0 mod q_d) t.
__global__ void lift64_kernel(const uint64_t* __restrict__ c2, uint64_t* __restrict__ dig,
                              const uint64_t* __restrict__ lc, int B, int L, int D, int logn) {
  const int n = 1 << logn;
  int64_t b;
  int c;
  row_coeff(logn, &b, &c);
  const uint64_t* qq = lc;
  const uint64_t* rr = lc + L;
  const uint64_t* src = c2 + b * L * n + c;
  for (int g = 0; g < D; ++g) {
    const uint64_t* rec = lc + 3 * L + g * (4 + 2 * L);
    const uint64_t r0 = src[static_cast<int64_t>(rec[0]) * n];
    const bool wide = rec[1] != kNoLimb;
    uint64_t t = 0;
    if (wide) {
      const int i1 = static_cast<int>(rec[1]);
      const uint64_t q1 = qq[i1];
      const uint64_t r1 = src[static_cast<int64_t>(i1) * n];
      const uint64_t r0m = barrett128(0, r0, q1, rr[2 * i1], rr[2 * i1 + 1]);
      t = shoup(sub_mod(r1, r0m, q1), rec[2], rec[3], q1);
    }
    uint64_t* dst = dig + (static_cast<int64_t>(g) * B + b) * L * n + c;
    for (int d = 0; d < L; ++d) {
      const uint64_t qd = qq[d];
      uint64_t v = barrett128(0, r0, qd, rr[2 * d], rr[2 * d + 1]);
      if (wide) v = add_mod(v, shoup(t, rec[4 + 2 * d], rec[5 + 2 * d], qd), qd);
      dst[static_cast<int64_t>(d) * n] = v;
    }
  }
}

// Digit spectra dn [D, B, L, n], keys [D, L, n] as (k0, k0', k1, k1') per
// coefficient -> acc [2, B, L, n].
__global__ void keyprod64_kernel(const uint64_t* __restrict__ dn,
                                 const ulonglong2* __restrict__ keys, uint64_t* __restrict__ acc,
                                 const uint64_t* __restrict__ q_limb, int64_t total, int L, int D,
                                 int logn) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t mask = (int64_t{1} << logn) - 1;
  const int limb = static_cast<int>((e >> logn) % L);
  const int64_t kpos = (static_cast<int64_t>(limb) << logn) | (e & mask);
  const int64_t kstride = static_cast<int64_t>(L) << logn;
  const uint64_t q = q_limb[limb];
  uint64_t s0 = 0, s1 = 0;
  for (int g = 0; g < D; ++g) {
    const uint64_t x = dn[g * total + e];
    const ulonglong2* kp = keys + 2 * (g * kstride + kpos);
    const ulonglong2 k0 = __ldg(kp), k1 = __ldg(kp + 1);
    s0 = add_mod(s0, shoup(x, k0.x, k0.y, q), q);
    s1 = add_mod(s1, shoup(x, k1.x, k1.y, q), q);
  }
  acc[e] = s0;
  acc[total + e] = s1;
}

// out [2, B, L, n] = (c0 + d[0], c1 + d[1]) mod q.
__global__ void add64_kernel(const uint64_t* __restrict__ c0, const uint64_t* __restrict__ c1,
                             const uint64_t* __restrict__ d, uint64_t* __restrict__ out,
                             const uint64_t* __restrict__ q_limb, int64_t total, int L,
                             int logn) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const uint64_t q = q_limb[(e >> logn) % L];
  out[e] = add_mod(c0[e], d[e], q);
  out[total + e] = add_mod(c1[e], d[total + e], q);
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
// tensors are contiguous int64 (read as u64); B is the flattened batch.
// consts: the device buffer of Consts' arrays; scalars: its four scalars in
// host memory.

int pplp_behz64_to_bsk(const void* c0, const void* c1, const void* d0, const void* d1,
                       void* xb, const void* consts, const void* scalars, int B, int L, int K,
                       int logn, void* stream) {
  dim3 grid, block;
  if (!limbs_ok(L, K)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = col_shape(logn, int64_t{4} * B, &grid, &block);
  if (err) return err;
  const Consts k = layout(static_cast<const uint64_t*>(consts),
                          static_cast<const uint64_t*>(scalars), L, K);
  const size_t smem = static_cast<size_t>(L) * block.x * sizeof(uint64_t);
  to_bsk64_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(c0), static_cast<const uint64_t*>(c1),
      static_cast<const uint64_t*>(d0), static_cast<const uint64_t*>(d1),
      static_cast<uint64_t*>(xb), k, B, L, K, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz64_tensor(const void* sq, const void* sb, void* eq, void* eb, const void* consts,
                       const void* scalars, int B, int L, int K, int logn, void* stream) {
  dim3 grid, block;
  if (!limbs_ok(L, K) || logn < 6 || logn > 15) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total_q = (static_cast<int64_t>(B) * L) << logn;
  const int64_t total_b = (static_cast<int64_t>(B) * K) << logn;
  const int err = elem_shape(total_q + total_b, &grid, &block);
  if (err) return err;
  const Consts k = layout(static_cast<const uint64_t*>(consts),
                          static_cast<const uint64_t*>(scalars), L, K);
  tensor64_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(sq), static_cast<const uint64_t*>(sb),
      static_cast<uint64_t*>(eq), static_cast<uint64_t*>(eb), k, total_q, total_b, L, K, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz64_floor_sk(const void* eq, const void* eb, void* out, const void* consts,
                         const void* scalars, int B, int L, int K, int logn, void* stream) {
  dim3 grid, block;
  if (!limbs_ok(L, K)) return static_cast<int>(cudaErrorInvalidValue);
  int err = col_shape(logn, int64_t{3} * B, &grid, &block);
  if (err) return err;
  const Consts k = layout(static_cast<const uint64_t*>(consts),
                          static_cast<const uint64_t*>(scalars), L, K);
  const size_t smem = static_cast<size_t>(L + K) * block.x * sizeof(uint64_t);
  err = pplp::allow_smem(floor_sk64_kernel, smem);
  if (err) return err;
  floor_sk64_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(eq), static_cast<const uint64_t*>(eb),
      static_cast<uint64_t*>(out), k, L, K, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz64_lift(const void* c2, void* dig, const void* lift_consts, int B, int L, int D,
                     int logn, void* stream) {
  dim3 grid, block;
  if (L < 1 || L > kMaxL || D < 1 || D > L) return static_cast<int>(cudaErrorInvalidValue);
  const int err = col_shape(logn, B, &grid, &block);
  if (err) return err;
  lift64_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(c2), static_cast<uint64_t*>(dig),
      static_cast<const uint64_t*>(lift_consts), B, L, D, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz64_keyprod(const void* dn, const void* keys, void* acc, const void* q, int B, int L,
                        int D, int logn, void* stream) {
  dim3 grid, block;
  if (L < 1 || L > kMaxL || D < 1 || D > L) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = (static_cast<int64_t>(B) * L) << logn;
  const int err = elem_shape(total, &grid, &block);
  if (err) return err;
  keyprod64_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(dn), static_cast<const ulonglong2*>(keys),
      static_cast<uint64_t*>(acc), static_cast<const uint64_t*>(q), total, L, D, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz64_add(const void* c0, const void* c1, const void* d, void* out, const void* q,
                    int B, int L, int logn, void* stream) {
  dim3 grid, block;
  const int64_t total = (static_cast<int64_t>(B) * L) << logn;
  const int err = elem_shape(total, &grid, &block);
  if (err) return err;
  add64_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(c0), static_cast<const uint64_t*>(c1),
      static_cast<const uint64_t*>(d), static_cast<uint64_t*>(out),
      static_cast<const uint64_t*>(q), total, L, logn);
  return static_cast<int>(cudaGetLastError());
}

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
