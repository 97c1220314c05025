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
//                    m~ = 2^16 Montgomery correction;
//   behz64_tensor:   the Karatsuba tensor product of the spectra over Q and
//                    over B_sk, both bases in one launch;
//   behz64_floor_sk: fast floor t e / q in B_sk, then Shenoy-Kumaresan back
//                    to Q;
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
// Arithmetic of tensor, lift, keyprod, add. Shoup products x w mod q =
// w x - umul64hi(w', x) q in wrapping u64 with w' = floor(w 2^64 / q), valid
// for any x < 2^64. General products are exact 128-bit values reduced by
// Barrett with floor(2^128 / q) = (r1, r0) (r1 < 2^32): the estimate
// floor(z r / 2^128) is the quotient or one less, so z - est q, formed in
// wrapping u64, needs one conditional subtract. The tensor product's
// operands are canonical sums below 2q < 2^63, so its products stay below
// 2^126.
//
// The base conversions (to_bsk, floor_sk). Each output residue is one
// 128-bit sum of products, reduced once:
//
// * Folded constants. Every modular step between two conversions that stays
//   in one modulus is folded into the conversion's constants on the host
//   (ops/behz64_cuda.py, _pack_constants): to_bsk's out_d =
//   (sum_i y_i (q/q_i) m~^-1 + r (q m~^-1)) mod b_d; floor_sk's
//   y_i = e_i (t qhat_i^-1) mod q_i (one Shoup product), then
//   y'_i = (e_i t q^-1 bhat_i^-1 - sum_j y_j (q/q_j) q^-1 bhat_i^-1) mod b_i
//   for the l primes of B, alpha = (sum_i y'_i (M/b_i) M^-1 - w_msk M^-1)
//   mod m_sk with w_msk's sum expanded in place, and out_d =
//   (sum_i y'_i (M/b_i) - alpha M [+ m_sk M if alpha > m_sk / 2]) mod q_d.
//   The values that leave a modulus as integers (y, y', alpha) are
//   canonical, as in the plain version, so every output is the same
//   residue. Per coefficient at L = 3, K = 5 that is 3 Shoup products, 39
//   product terms and 8 reductions in floor_sk, and 3, 20 and 5 in to_bsk.
// * Split-word products. A source value y is split once into 32-bit words
//   (ya, yb) at bit 31 when it is a residue mod q (< 2^62) or at bit 30 when
//   it is below 2^60 (a B_sk residue, alpha); the host splits each constant
//   at 61 minus that (it is below 2^60 where y is mod q, below 2^62
//   otherwise). All four partial products are then below 2^61, and each is
//   added by one 32 x 32 + 64-bit multiply-add (IMAD.WIDE.U32) into its own
//   u64 column: weight 1, 2^30, 2^31 and 2^61, with no carry and no compare.
//   Eight terms fit (8 x 2^61 = 2^64), so a sum is folded into its 128-bit
//   total every eight terms: 4 partial products per term
//   (measure_multiply.U64_MAC_MULS).
// * Sums stay below 2^128: every product has one factor below 2^60 (a B_sk
//   prime or a residue mod one; ops/behz64_cuda.py checks the B_sk primes)
//   and the other below 2^62. At the bounds (L = 40, K = 48) the widest sum,
//   alpha's, holds L products below 2^122 and K below 2^120: below
//   1.625 x 2^127; out_d's holds K below 2^122 plus m_sk M mod q_d: below
//   1.5 x 2^127 + 2^62.
// * The reduction of z = z1 2^64 + z0 < 2^128 by r = floor(2^128 / q) =
//   rh 2^64 + r0 uses that rh < 2^32 (q > 2^32): est = floor((z0 rh +
//   z1 r0) / 2^64) + z1 rh mod 2^64, from 11 partial products (z0 rh: 2,
//   z1 r0: 4, z1 rh: 2, est q: 3). It leaves out the high word of z0 r0
//   (below 2^64 at weight 2^64), which can carry one into the estimate, so
//   est is the quotient, or one or two less; z - est q < 3q < 2^64 takes two
//   conditional subtracts. Exact for every z < 2^128
//   (tests/test_torch_behz64_words.py models it against Python integers).
//
// Layout. A block owns a tile of 2T coefficients of one row (T threads, up
// to kPairThreads; fewer for a row shorter than the tile or where L and K
// need the shared memory), and a thread owns two adjacent coefficients:
// 16-byte loads and stores, and two independent sums (eight u64 columns) in
// flight per term. The row's residues reach shared memory by 16-byte
// cp.async, each thread's pair in its own slot per limb, so the thread reads
// back only what it wrote; the block stages its kernel's constant buffer in
// shared memory once, and a term reads one 8-byte constant (both words) by
// broadcast. Index arithmetic is per block, in 32 bits: a row is a shift of
// the block index. The seal chains' (L, K) = (3, 5), (5, 7), (9, 11),
// (16, 18) are compiled with constant limb counts (unrolled loops, folds at
// fixed terms; one destination per loop pass, so the code stays small);
// any other shape within the bounds takes the same code with L and K read
// at run time. On an H100, 128 threads a block measured best at the three
// seal chains against 64 and 256, and the constant limb counts 20-50%
// faster than run-time ones (PERF.md).
//
// What bounds it. At n = 4096, batch 256, |B_sk| = 5 the conversions move
// 268 MB (to_bsk) and 277 MB (floor_sk) at 8 B a residue; their integer
// work, counted as above, takes less time than that at the integer-multiply
// peak (measure_multiply.kernel_counts64), so both are bound by bytes.
// Tensor cores are not used: an int8 mma/wgmma conversion (TensorFHE-style
// byte splitting) has a contraction only 8 L bytes deep, 24 at L = 3, below
// one k-step of 32, and its recombination of 15 byte columns per product
// costs as much as the multiply-adds it replaces. It is a candidate for the
// wide chains (L >= 16; ROADMAP Queue 1 #11).
//
// Bounds: L <= 40 limbs in Q and K = |B_sk| <= 48, checked here and in
// ops/behz64_cuda.py; D <= L digits.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_block64.cuh"

namespace {

using pplp::csub64;
using pplp::shoup_lazy64;
using u128 = unsigned __int128;

constexpr int kMaxL = 40;
constexpr int kMaxK = 48;
constexpr int kColThreads = 128;   // coefficients per block, lift64
constexpr int kPairThreads = 128;  // coefficient pairs per block, the conversions
constexpr int kElemThreads = 256;  // residues per block, per-element phases
constexpr int kFoldTerms = 8;      // products per column before a fold (each < 2^61)
constexpr size_t kConvSmem = 100 * 1024;  // a conversion block's shared memory, at most
constexpr uint64_t kNoLimb = ~uint64_t{0};
constexpr uint32_t kLow31 = (1u << 31) - 1;
constexpr uint32_t kLow30 = (1u << 30) - 1;

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

// ---- the base conversions' arithmetic ------------------------------------

// Two coefficients' values split into 32-bit words: {y0a, y0b, y1a, y1b},
// y = ya + yb 2^31 for a residue mod q (kQ), ya + yb 2^30 below 2^60.
template <bool kQ>
__device__ __forceinline__ uint4 split2(uint64_t y0, uint64_t y1) {
  constexpr int s = kQ ? 31 : 30;
  constexpr uint32_t m = kQ ? kLow31 : kLow30;
  return make_uint4(static_cast<uint32_t>(y0) & m, static_cast<uint32_t>(y0 >> s),
                    static_cast<uint32_t>(y1) & m, static_cast<uint32_t>(y1 >> s));
}

// x y + acc for 32-bit x, y: one IMAD.WIDE.U32.
__device__ __forceinline__ uint64_t mad_wide(uint32_t x, uint32_t y, uint64_t acc) {
  return static_cast<uint64_t>(x) * y + acc;
}

// The four columns of a sum, by weight: 1, 2^30, 2^31, 2^61.
struct Cols {
  uint64_t a = 0, w30 = 0, w31 = 0, d = 0;

  // + y c: y split at 31 and c at 30 (kQ), or y at 30 and c at 31; c.x, c.y
  // are the constant's words.
  template <bool kQ>
  __device__ __forceinline__ void mac(uint32_t ya, uint32_t yb, uint2 c) {
    a = mad_wide(ya, c.x, a);
    if (kQ) {
      w30 = mad_wide(ya, c.y, w30);
      w31 = mad_wide(yb, c.x, w31);
    } else {
      w31 = mad_wide(ya, c.y, w31);
      w30 = mad_wide(yb, c.x, w30);
    }
    d = mad_wide(yb, c.y, d);
  }

  __device__ __forceinline__ u128 fold() const {
    return u128(a) + (u128(w30) << 30) + (u128(w31) << 31) + (u128(d) << 61);
  }
};

// The sums of one destination for a thread's two coefficients.
struct Sum2 {
  u128 t0 = 0, t1 = 0;  // folded totals
  Cols s0, s1;          // open columns
  int open = 0;         // terms in the open columns

  template <bool kQ>
  __device__ __forceinline__ void add(uint4 y, uint2 c) {
    if (open == kFoldTerms) flush();
    s0.mac<kQ>(y.x, y.y, c);
    s1.mac<kQ>(y.z, y.w, c);
    ++open;
  }

  __device__ __forceinline__ void flush() {
    t0 += s0.fold();
    t1 += s1.fold();
    s0 = Cols();
    s1 = Cols();
    open = 0;
  }
};

// z mod q for any z < 2^128 (the header's proof); r = floor(2^128 / q) =
// rh 2^64 + r0 with rh < 2^32.
__device__ __forceinline__ uint64_t reduce128(u128 z, uint64_t q, uint64_t r0, uint32_t rh) {
  const uint64_t z0 = static_cast<uint64_t>(z), z1 = static_cast<uint64_t>(z >> 64);
  const uint32_t z00 = static_cast<uint32_t>(z0), z01 = static_cast<uint32_t>(z0 >> 32);
  const uint32_t z10 = static_cast<uint32_t>(z1), z11 = static_cast<uint32_t>(z1 >> 32);
  const uint32_t r00 = static_cast<uint32_t>(r0), r01 = static_cast<uint32_t>(r0 >> 32);
  // s = z0 rh (96 bits): s_lo, s_hi.
  const uint64_t u = static_cast<uint64_t>(z00) * rh;
  const uint64_t v = mad_wide(z01, rh, u >> 32);
  const uint64_t s_lo = (v << 32) | static_cast<uint32_t>(u);
  const uint64_t s_hi = v >> 32;
  // c = z1 r0 (128 bits): c_lo, c_hi.
  const uint64_t p = static_cast<uint64_t>(z10) * r00;
  const uint64_t m1 = mad_wide(z10, r01, p >> 32);
  const uint64_t m2 = mad_wide(z11, r00, static_cast<uint32_t>(m1));
  const uint64_t c_lo = (m2 << 32) | static_cast<uint32_t>(p);
  const uint64_t c_hi = mad_wide(z11, r01, (m1 >> 32) + (m2 >> 32));
  // est = s_hi + c_hi + carry(s_lo + c_lo) + z1 rh, mod 2^64.
  const uint64_t w1 = s_lo + c_lo;
  const uint64_t z1rh = mad_wide(z10, rh, static_cast<uint64_t>(z11 * rh) << 32);
  const uint64_t est = s_hi + c_hi + (w1 < s_lo) + z1rh;
  return csub64(csub64(z0 - est * q, q), q);
}

// A cp.async of 16 bytes into this thread's shared-memory slot.
__device__ __forceinline__ void cp_async16(uint4* dst, const uint64_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ ulonglong2 pair_at(const uint4* slot) {
  return *reinterpret_cast<const ulonglong2*>(slot);
}

// Copies `words` u64 constants into shared memory (the whole block).
__device__ __forceinline__ void stage(uint64_t* dst, const uint64_t* __restrict__ src,
                                      int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = pplp::ldg64(src + i);
}

// ---- the conversions' constant buffers (ops/behz64_cuda.py, _pack_constants)
//
// Moduli q [L] or b [K]; reduction words (r0, rh) per modulus; Shoup pairs
// as [w] then [w']; conversion rows of split constants, one u64 each (low
// word: the bits below the split, high word: the rest), [destination][term].

// to_bsk: q [L], mqh_w [L], mqh_ws [L] (m~ qhat_i^-1 mod q_i), cqm [L]
// ((q / q_i) mod m~), b [K], rb [K][2], xq [K][L + 1] (terms y_i, then r).
struct ToBsk {
  const uint64_t *q, *mqh_w, *mqh_ws, *cqm, *b, *rb;
  const uint2* xq;

  __device__ ToBsk(const uint64_t* p, int L, int K)
      : q(p), mqh_w(p + L), mqh_ws(p + 2 * L), cqm(p + 3 * L), b(p + 4 * L),
        rb(p + 4 * L + K), xq(reinterpret_cast<const uint2*>(p + 4 * L + 3 * K)) {}

  static __host__ __device__ int words(int L, int K) { return 4 * L + 3 * K + K * (L + 1); }
};

// floor_sk: q [L], rq [L][2], fu_w [L], fu_ws [L] (t qhat_i^-1 mod q_i),
// mskm [L] (m_sk M mod q_d), b [K], rb [K][2], fb [l][L + 1] (terms y_j,
// then e_i), fa [l + 1 + L] (terms y'_i, e_msk, y_j), fq [L][l + 1]
// (terms y'_i, then alpha).
struct FloorSk {
  const uint64_t *q, *rq, *fu_w, *fu_ws, *mskm, *b, *rb;
  const uint2 *fb, *fa, *fq;

  __device__ FloorSk(const uint64_t* p, int L, int K)
      : q(p), rq(p + L), fu_w(p + 3 * L), fu_ws(p + 4 * L), mskm(p + 5 * L), b(p + 6 * L),
        rb(p + 6 * L + K),
        fb(reinterpret_cast<const uint2*>(p + 6 * L + 3 * K)),
        fa(fb + (K - 1) * (L + 1)),
        fq(fa + K + L) {}

  static __host__ __device__ int words(int L, int K) {
    return 6 * L + 3 * K + (K - 1) * (L + 1) + (K + L) + L * K;
  }
};

template <int N>
__device__ __forceinline__ int limbs(int runtime) {
  return N ? N : runtime;
}

// The block's row and the first of the thread's two coefficients: the grid
// has rows << log_tiles blocks of T threads, 2T coefficients a tile.
__device__ __forceinline__ void tile_pos(int log_tiles, int* row, int* c) {
  *row = static_cast<int>(blockIdx.x >> log_tiles);
  const int tile = static_cast<int>(blockIdx.x & ((1u << log_tiles) - 1));
  *c = (tile * static_cast<int>(blockDim.x) + static_cast<int>(threadIdx.x)) * 2;
}

// x [B, L, n] for each of c0, c1, d0, d1 -> xb [4, B, K, n]. kL, kK: the
// limb counts, or 0 to read them at run time.
template <int kL, int kK>
__global__ void __launch_bounds__(kPairThreads)
    to_bsk64_kernel(const uint64_t* __restrict__ c0, const uint64_t* __restrict__ c1,
                    const uint64_t* __restrict__ d0, const uint64_t* __restrict__ d1,
                    uint64_t* __restrict__ xb, const uint64_t* __restrict__ consts,
                    uint32_t neg_inv_q_mt, int B, int L_, int K_, int logn, int log_tiles) {
  const int L = limbs<kL>(L_), K = limbs<kK>(K_);
  const int T = blockDim.x;
  const int words = ToBsk::words(L, K);
  uint64_t* sc = pplp::dyn_smem64();
  uint4* slot = reinterpret_cast<uint4*>(sc + ((words + 1) & ~1)) + threadIdx.x;  // [L][T]
  int row, c;
  tile_pos(log_tiles, &row, &c);
  const int p = row / B;
  const int64_t n = int64_t{1} << logn;
  const uint64_t* src = (p == 0 ? c0 : p == 1 ? c1 : p == 2 ? d0 : d1) +
                        static_cast<int64_t>(row - p * B) * L * n + c;
#pragma unroll
  for (int i = 0; i < L; ++i) cp_async16(slot + i * T, src + i * n);
  stage(sc, consts, words);
  cp_async_wait_all();
  __syncthreads();
  const ToBsk k(sc, L, K);

  // y_i = x_i m~ qhat_i^-1 mod q_i, and r = -(sum_i y_i (q / q_i)) q^-1 mod m~.
  uint32_t acc0 = 0, acc1 = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const ulonglong2 x = pair_at(slot + i * T);
    const uint64_t y0 = csub64(shoup_lazy64(x.x, k.mqh_w[i], k.mqh_ws[i], k.q[i]), k.q[i]);
    const uint64_t y1 = csub64(shoup_lazy64(x.y, k.mqh_w[i], k.mqh_ws[i], k.q[i]), k.q[i]);
    const uint32_t m = static_cast<uint32_t>(k.cqm[i]);
    acc0 += (static_cast<uint32_t>(y0) & 0xFFFFu) * m;  // mod 2^32 keeps mod 2^16
    acc1 += (static_cast<uint32_t>(y1) & 0xFFFFu) * m;
    slot[i * T] = split2<true>(y0, y1);
  }
  const uint4 r = make_uint4((acc0 * neg_inv_q_mt) & 0xFFFFu, 0, (acc1 * neg_inv_q_mt) & 0xFFFFu,
                             0);

  uint64_t* dst = xb + static_cast<int64_t>(row) * K * n + c;
#pragma unroll 1
  for (int d = 0; d < K; ++d) {
    const uint2* cd = k.xq + d * (L + 1);
    Sum2 s;
#pragma unroll
    for (int i = 0; i < L; ++i) s.add<true>(slot[i * T], cd[i]);
    s.add<true>(r, cd[L]);
    s.flush();
    const uint64_t bd = k.b[d], r0 = k.rb[2 * d];
    const uint32_t rh = static_cast<uint32_t>(k.rb[2 * d + 1]);
    *reinterpret_cast<ulonglong2*>(dst + d * n) =
        make_ulonglong2(reduce128(s.t0, bd, r0, rh), reduce128(s.t1, bd, r0, rh));
  }
}

// The tensor kernel's constants (ops/behz64_cuda.py, _pack_constants): q [L],
// b [K], then floor(2^128 / q) [L][2] and floor(2^128 / b) [K][2] as (low,
// high) words.
struct Consts {
  const uint64_t *qq, *qb;  // [L], [K]
  const uint64_t *rq, *rb;  // [L][2], [K][2]
};

Consts layout(const uint64_t* base, int L, int K) {
  return Consts{base, base + L, base + L + K, base + 3 * L + K};
}

// Row and coefficient of this thread in a per-coefficient phase: the grid
// has rows * (n / blockDim.x) blocks.
__device__ __forceinline__ void row_coeff(int logn, int64_t* row, int* coeff) {
  const int per_row = (1 << logn) / blockDim.x;
  *row = blockIdx.x / per_row;
  *coeff = static_cast<int>(blockIdx.x % per_row) * blockDim.x + threadIdx.x;
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
// kL, kK: the limb counts, or 0 to read them at run time.
template <int kL, int kK>
__global__ void __launch_bounds__(kPairThreads)
    floor_sk64_kernel(const uint64_t* __restrict__ eq, const uint64_t* __restrict__ eb,
                      uint64_t* __restrict__ out, const uint64_t* __restrict__ consts,
                      uint64_t msk_half, int L_, int K_, int logn, int log_tiles) {
  const int L = limbs<kL>(L_), K = limbs<kK>(K_);
  const int l = K - 1;
  const int T = blockDim.x;
  const int words = FloorSk::words(L, K);
  uint64_t* sc = pplp::dyn_smem64();
  uint4* slot = reinterpret_cast<uint4*>(sc + ((words + 1) & ~1)) + threadIdx.x;  // [L + K][T]
  uint4* bslot = slot + L * T;
  int row, c;
  tile_pos(log_tiles, &row, &c);
  const int64_t n = int64_t{1} << logn;
  const uint64_t* srcq = eq + static_cast<int64_t>(row) * L * n + c;
  const uint64_t* srcb = eb + static_cast<int64_t>(row) * K * n + c;
#pragma unroll
  for (int j = 0; j < L; ++j) cp_async16(slot + j * T, srcq + j * n);
#pragma unroll
  for (int d = 0; d < K; ++d) cp_async16(bslot + d * T, srcb + d * n);
  stage(sc, consts, words);
  cp_async_wait_all();
  __syncthreads();
  const FloorSk k(sc, L, K);

  // y_j = e_j t qhat_j^-1 mod q_j, split at 31; e over B_sk split at 30.
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const ulonglong2 e = pair_at(slot + j * T);
    const uint64_t qj = k.q[j];
    slot[j * T] = split2<true>(csub64(shoup_lazy64(e.x, k.fu_w[j], k.fu_ws[j], qj), qj),
                               csub64(shoup_lazy64(e.y, k.fu_w[j], k.fu_ws[j], qj), qj));
  }
#pragma unroll
  for (int d = 0; d < K; ++d) {
    const ulonglong2 e = pair_at(bslot + d * T);
    bslot[d * T] = split2<false>(e.x, e.y);
  }

  // y'_i = (e_i c_i + sum_j y_j c_ij) mod b_i over B, in e_i's slot.
#pragma unroll 1
  for (int i = 0; i < l; ++i) {
    const uint2* ci = k.fb + i * (L + 1);
    Sum2 s;
#pragma unroll
    for (int j = 0; j < L; ++j) s.add<true>(slot[j * T], ci[j]);
    s.add<false>(bslot[i * T], ci[L]);
    s.flush();
    const uint64_t bi = k.b[i], r0 = k.rb[2 * i];
    const uint32_t rh = static_cast<uint32_t>(k.rb[2 * i + 1]);
    bslot[i * T] = split2<false>(reduce128(s.t0, bi, r0, rh), reduce128(s.t1, bi, r0, rh));
  }

  // alpha over m_sk, canonical.
  uint64_t a0, a1;
  {
    Sum2 s;
#pragma unroll
    for (int i = 0; i <= l; ++i) s.add<false>(bslot[i * T], k.fa[i]);
#pragma unroll
    for (int j = 0; j < L; ++j) s.add<true>(slot[j * T], k.fa[K + j]);
    s.flush();
    const uint64_t msk = k.b[l], r0 = k.rb[2 * l];
    const uint32_t rh = static_cast<uint32_t>(k.rb[2 * l + 1]);
    a0 = reduce128(s.t0, msk, r0, rh);
    a1 = reduce128(s.t1, msk, r0, rh);
  }
  const uint4 alpha = split2<false>(a0, a1);
  const bool high0 = a0 > msk_half, high1 = a1 > msk_half;

  // out_d = (sum_i y'_i c_di + alpha c_d [+ m_sk M]) mod q_d.
  uint64_t* dst = out + static_cast<int64_t>(row) * L * n + c;
#pragma unroll 1
  for (int d = 0; d < L; ++d) {
    const uint2* cd = k.fq + d * K;
    Sum2 s;
#pragma unroll
    for (int i = 0; i < l; ++i) s.add<false>(bslot[i * T], cd[i]);
    s.add<false>(alpha, cd[l]);
    s.flush();
    const uint64_t corr = k.mskm[d];
    if (high0) s.t0 += corr;
    if (high1) s.t1 += corr;
    const uint64_t qd = k.q[d], r0 = k.rq[2 * d];
    const uint32_t rh = static_cast<uint32_t>(k.rq[2 * d + 1]);
    *reinterpret_cast<ulonglong2*>(dst + d * n) =
        make_ulonglong2(reduce128(s.t0, qd, r0, rh), reduce128(s.t1, qd, r0, rh));
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

// A conversion's tile: T threads (two coefficients each) and log2 of the
// tiles per row, with the shared memory of `words` constants and
// `slots` 16-byte slots per thread.
int conv_shape(int logn, int64_t rows, int words, int slots, dim3* grid, dim3* block,
               size_t* smem) {
  if (logn < 6 || logn > 15 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int log_t = __builtin_ctz(kPairThreads);
  while (log_t > logn - 1) --log_t;
  auto bytes = [&](int lt) {
    return static_cast<size_t>((words + 1) & ~1) * 8 + (static_cast<size_t>(slots) << lt) * 16;
  };
  while (log_t > 5 && bytes(log_t) > kConvSmem) --log_t;
  const int log_tiles = logn - 1 - log_t;
  const int64_t blocks = rows << log_tiles;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(static_cast<unsigned>(blocks));
  *block = dim3(1u << log_t);
  *smem = bytes(log_t);
  return 0;
}

template <int kL, int kK>
int launch_to_bsk(const uint64_t* c0, const uint64_t* c1, const uint64_t* d0,
                  const uint64_t* d1, uint64_t* xb, const uint64_t* consts,
                  uint32_t neg_inv_q_mt, int B, int L, int K, int logn, cudaStream_t stream) {
  dim3 grid, block;
  size_t smem;
  int err = conv_shape(logn, int64_t{4} * B, ToBsk::words(L, K), L, &grid, &block, &smem);
  if (err) return err;
  err = pplp::allow_smem(to_bsk64_kernel<kL, kK>, smem);
  if (err) return err;
  const int log_tiles = logn - 1 - __builtin_ctz(block.x);
  to_bsk64_kernel<kL, kK><<<grid, block, smem, stream>>>(c0, c1, d0, d1, xb, consts,
                                                         neg_inv_q_mt, B, L, K, logn, log_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int kL, int kK>
int launch_floor_sk(const uint64_t* eq, const uint64_t* eb, uint64_t* out,
                    const uint64_t* consts, uint64_t msk_half, int B, int L, int K, int logn,
                    cudaStream_t stream) {
  dim3 grid, block;
  size_t smem;
  int err = conv_shape(logn, int64_t{3} * B, FloorSk::words(L, K), L + K, &grid, &block, &smem);
  if (err) return err;
  err = pplp::allow_smem(floor_sk64_kernel<kL, kK>, smem);
  if (err) return err;
  const int log_tiles = logn - 1 - __builtin_ctz(block.x);
  floor_sk64_kernel<kL, kK><<<grid, block, smem, stream>>>(eq, eb, out, consts, msk_half, L, K,
                                                           logn, log_tiles);
  return static_cast<int>(cudaGetLastError());
}

// The seal chains' shapes with constant limb counts, else run-time ones.
#define PPLP_SEAL_SHAPES(X) X(3, 5) X(5, 7) X(9, 11) X(16, 18)

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 = success)
// or cudaErrorInvalidValue for a shape outside the bounds above. Residue
// tensors are contiguous int64 (read as u64); B is the flattened batch.
// consts: the kernel's constant buffer on the device; scalars: host memory.

int pplp_behz64_to_bsk(const void* c0, const void* c1, const void* d0, const void* d1,
                       void* xb, const void* consts, const void* scalars, int B, int L, int K,
                       int logn, void* stream) {
  if (!limbs_ok(L, K)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const uint64_t*>(c0);
  const auto* b = static_cast<const uint64_t*>(c1);
  const auto* c = static_cast<const uint64_t*>(d0);
  const auto* d = static_cast<const uint64_t*>(d1);
  auto* out = static_cast<uint64_t*>(xb);
  const auto* k = static_cast<const uint64_t*>(consts);
  const auto mt = static_cast<uint32_t>(static_cast<const uint64_t*>(scalars)[0]);
  const auto s = static_cast<cudaStream_t>(stream);
#define PPLP_TO_BSK(LL, KK) \
  if (L == LL && K == KK) return launch_to_bsk<LL, KK>(a, b, c, d, out, k, mt, B, L, K, logn, s);
  PPLP_SEAL_SHAPES(PPLP_TO_BSK)
#undef PPLP_TO_BSK
  return launch_to_bsk<0, 0>(a, b, c, d, out, k, mt, B, L, K, logn, s);
}

int pplp_behz64_tensor(const void* sq, const void* sb, void* eq, void* eb, const void* consts,
                       int B, int L, int K, int logn, void* stream) {
  dim3 grid, block;
  if (!limbs_ok(L, K) || logn < 6 || logn > 15) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total_q = (static_cast<int64_t>(B) * L) << logn;
  const int64_t total_b = (static_cast<int64_t>(B) * K) << logn;
  const int err = elem_shape(total_q + total_b, &grid, &block);
  if (err) return err;
  const Consts k = layout(static_cast<const uint64_t*>(consts), L, K);
  tensor64_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(sq), static_cast<const uint64_t*>(sb),
      static_cast<uint64_t*>(eq), static_cast<uint64_t*>(eb), k, total_q, total_b, L, K, logn);
  return static_cast<int>(cudaGetLastError());
}

int pplp_behz64_floor_sk(const void* eq, const void* eb, void* out, const void* consts,
                         const void* scalars, int B, int L, int K, int logn, void* stream) {
  if (!limbs_ok(L, K)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const uint64_t*>(eq);
  const auto* b = static_cast<const uint64_t*>(eb);
  auto* o = static_cast<uint64_t*>(out);
  const auto* k = static_cast<const uint64_t*>(consts);
  const uint64_t half = static_cast<const uint64_t*>(scalars)[1];
  const auto s = static_cast<cudaStream_t>(stream);
#define PPLP_FLOOR_SK(LL, KK) \
  if (L == LL && K == KK) return launch_floor_sk<LL, KK>(a, b, o, k, half, B, L, K, logn, s);
  PPLP_SEAL_SHAPES(PPLP_FLOOR_SK)
#undef PPLP_FLOOR_SK
  return launch_floor_sk<0, 0>(a, b, o, k, half, B, L, K, logn, s);
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
