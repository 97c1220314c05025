// Batched multi-precision Montgomery arithmetic for the DGK back-end on
// Hopper (sm_90a): products, exponentiations and the blind-distance chain
// mod a 2048-bit (or 512-bit) DGK modulus n.
//
// Replaces no Pallas kernel: the reference's Montgomery product is the XLA
// CIOS scan pplp_tpu/dgk/modexp.py:111 (MontgomeryCtx.mont_mul), which the
// reference's batched DGK (pplp_tpu/dgk/batched.py) runs under jit. Eager
// torch would spend ~1,500 launches on one such product, so every
// exponentiation here runs its whole exponent walk inside one launch.
//
// Representation: a number is W 32-bit limbs, little-endian (int32 tensors
// [B, W] holding the u32 bits); the wrapper (ops/dgk_cuda.py) converts from
// and to the port's 16-bit digit rows. Montgomery products are CIOS on
// 32 x 32 -> 64-bit multiply-adds with R' = 2^(32 W) (2^(32 W') in the group
// kernels) and one conditional subtraction: for a, b < R' with one of them
// below n, the product is below 2n before it and canonical after it. Every
// entry point takes and returns standard-domain values below R' and writes
// canonical values below n; the Montgomery domain never leaves the kernel,
// so the kernels agree with the plain version (R = 2^(16 D)) whatever D's
// parity or W'.
//
// The modulus and its constants (n, R'^2 mod n, R' mod n, 1, -n^-1 mod 2^32)
// and the shared exponents travel by value in the kernel parameters
// (constant bank 0, __grid_constant__).
//
// What bounds it: integer multiplies. A product takes 2 W^2 + W 32 x 32 ->
// 64-bit multiply-adds (8,515 at W = 65), each an IMAD.WIDE.U32: two slots
// of the card's 32-bit multiply rate at its nominal issue rate (the bound's
// count; measure_dgk's probe reaches 2.79-2.90 with eight chains a thread),
// against 3 W words of memory traffic per lane and exponentiation: every
// entry point is bound by operations, by three orders of magnitude.
//
// Two designs. dgk_mulmod and dgk_blind_distance run one thread a lane: the
// accumulator and the running value in registers (the j loops unroll over
// the compile-time W), the operand whose limb i the outer loop reads from
// memory (device memory, the parameter bank, or a saved value in local
// memory: the ptxas stack frame, 2 W words for an exponentiation, 6 W for
// the blind distance); each CIOS step is a serial carry chain of W
// multiply-adds, and at B = 10,000 the card holds about one warp a
// scheduler: latency-bound.
//
// dgk_powmod_lanes and dgk_powmod_shared, the two exponentiations that hold
// a full comparison's time (h^r, g^m and the decrypt's c^vpq), run a group
// of G threads of one warp a number, thread `rank` holding L limbs of the
// accumulator, the running value, the operand and n in registers, indexed
// by compile-time constants only (the step loop runs over the owning thread
// outside and unrolls over L inside): a product is G L steps of a broadcast
// limb a_i, L multiply-adds into the slice, a broadcast quotient from rank
// 0, L more, and a one-limb shift whose top word comes from the rank above;
// each rank's carry out stays pending and is resolved once a product by
// ballot and look-ahead (group_mul). Every group runs the same product
// sequence, a fixed 3-bit window walk with its table in shared memory, so a
// warp no longer pays for the union of its lanes' set bits.
//   Measured at B = 10,000, k = 2048 (H100 80GB HBM3, 700 W; measure_dgk on
// copies of the package): G = 5, L = 13 (W' = W = 65; six groups in 30
// lanes, two idle) h^r 27.0 ms, c^vpq 21.6 ms; G = 4, W' = 68: 29.6 and
// 23.4; G = 8, W' = 72: 28.3 and 23.0; one thread a lane (the design
// dgk_mulmod keeps) 84.8 and 51.4. W = 17 takes G = 4, L = 5 (W' = 20).
// 64 threads a block and 8 blocks an SM (__launch_bounds__: at most 128
// registers; 26,624 B of table a block), so B = 10,000 (834 blocks) is
// resident in one wave at 12.6 warps an SM. ptxas (-Xptxas -v): dgk_powmod_lanes 106 registers,
// dgk_powmod_shared 100 (74 and 72 at W = 17), 0 bytes of stack frame, no
// spills.
//   Limb products as u64 multiply-adds (csrc/dgk_rows.cuh: 3.08 SASS
// instructions a limb product) rather than PTX carry chains (4.31): h^r
// 26.4 ms against 27.0.
//   Products a lane: 2^3 + (ceil(bits / 3) - 1) 4, whatever the bits: 1,072
// for h^r's 800-bit exponents (the binary method, which the bound counts:
// 1,199 on average), 856 for c^vpq's 640 bits (967), 28 for g^m's 16 (22.9).
// A 4-bit window runs 1,011 and 811 and measured 1.5% faster on h^r and
// c^vpq, 15% slower on g^m, with 53,248 B of table a block.
// Widths: W = 17 (k = 512 keys, moduli of 497-528 bits) and W = 65
// (k = 2048, 2033-2064 bits); any other W is refused.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "dgk_rows.cuh"

namespace {

using pplp_dgk::mad_row;

constexpr int kThreads = 64;
constexpr int kExpWords = 64;  // a shared exponent has at most 2048 bits

template <int W>
struct Modulus {
  uint32_t n[W];
  uint32_t r2[W];    // R'^2 mod n: to_mont multiplier
  uint32_t one[W];   // R' mod n: 1 in the Montgomery domain
  uint32_t unit[W];  // 1: from_mont multiplier
  uint32_t n0inv;    // -n^-1 mod 2^32
};

struct Exponents {
  int bits[3];
  uint32_t words[3][kExpWords];
};

// acc <- a acc R'^-1 mod n (canonical). acc: registers, below n or below R'
// with a below n; a: W words anywhere (device, local or parameter memory),
// one read per outer step.
template <int W>
__device__ __forceinline__ void mont_mul(uint32_t (&acc)[W], const uint32_t* a,
                                         const Modulus<W>& m) {
  uint32_t t[W + 1];
#pragma unroll
  for (int j = 0; j <= W; ++j) t[j] = 0;
#pragma unroll 1
  for (int i = 0; i < W; ++i) {
    const uint64_t ai = a[i];
    uint64_t s;
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {  // t += a_i acc
      s = ai * acc[j] + t[j] + c;
      t[j] = static_cast<uint32_t>(s);
      c = static_cast<uint32_t>(s >> 32);
    }
    s = static_cast<uint64_t>(t[W]) + c;
    t[W] = static_cast<uint32_t>(s);
    const uint32_t top = static_cast<uint32_t>(s >> 32);
    const uint64_t q = t[0] * m.n0inv;  // t + q n = 0 mod 2^32
    s = q * m.n[0] + t[0];
    c = static_cast<uint32_t>(s >> 32);
#pragma unroll
    for (int j = 1; j < W; ++j) {  // t <- (t + q n) / 2^32
      s = q * m.n[j] + t[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = static_cast<uint32_t>(s >> 32);
    }
    s = static_cast<uint64_t>(t[W]) + c;
    t[W - 1] = static_cast<uint32_t>(s);
    t[W] = top + static_cast<uint32_t>(s >> 32);
  }
  // t < 2n: subtract n where t >= n (no borrow out of the low W words, or a
  // top word).
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t d = static_cast<uint64_t>(t[j]) - m.n[j] - borrow;
    borrow = static_cast<uint32_t>(d >> 32) & 1u;
  }
  const uint32_t keep = (t[W] == 0 && borrow) ? 0u : 0xFFFFFFFFu;
  borrow = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t d = static_cast<uint64_t>(t[j]) - (m.n[j] & keep) - borrow;
    acc[j] = static_cast<uint32_t>(d);
    borrow = static_cast<uint32_t>(d >> 32) & 1u;
  }
}

template <int W>
__device__ __forceinline__ void copy(uint32_t (&dst)[W], const uint32_t* src) {
#pragma unroll
  for (int j = 0; j < W; ++j) dst[j] = src[j];
}

template <int W>
__device__ __forceinline__ void save(uint32_t* dst, const uint32_t (&src)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) dst[j] = src[j];
}

__device__ __forceinline__ uint32_t bit_of(const uint32_t* words, int bit) {
  return (words[bit >> 5] >> (bit & 31)) & 1u;
}

// x <- x^e in the Montgomery domain for a shared exponent of `bits` bits,
// left to right: a square per bit below the top one, a product per set bit
// below it. base and sq: W words of local memory each.
template <int W>
__device__ __forceinline__ void pow_shared(uint32_t (&x)[W], const uint32_t* e, int bits,
                                           uint32_t* base, uint32_t* sq,
                                           const Modulus<W>& m) {
  if (bits == 0) {
    copy<W>(x, m.one);
    return;
  }
  save<W>(base, x);
#pragma unroll 1
  for (int bit = bits - 2; bit >= 0; --bit) {
    save<W>(sq, x);
    mont_mul<W>(x, sq, m);
    if (bit_of(e, bit)) mont_mul<W>(x, base, m);
  }
}

// out = a b mod n; b_stride 0: one b for every lane.
template <int W>
__global__ void __launch_bounds__(kThreads)
    dgk_mulmod_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      int64_t b_stride, uint32_t* __restrict__ out, int batch,
                      const __grid_constant__ Modulus<W> m) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= batch) return;
  uint32_t x[W];
  copy<W>(x, a + static_cast<int64_t>(lane) * W);
#pragma unroll 1
  for (int k = 0; k < 2; ++k)  // a R', then a R' b R'^-1 = a b
    mont_mul<W>(x, k == 0 ? m.r2 : b + lane * b_stride, m);
  save<W>(out + static_cast<int64_t>(lane) * W, x);
}

// The server's DGK blind distance, per lane:
// out = ((c1 c2^xb c3^yb)^s) cz cr mod n, exponents e.words[0..2] = xb, yb, s.
// Five conversions in, one out, everything between in the Montgomery domain.
template <int W>
__global__ void __launch_bounds__(kThreads)
    dgk_blind_distance_kernel(const uint32_t* __restrict__ c1, const uint32_t* __restrict__ c2,
                              const uint32_t* __restrict__ c3, const uint32_t* __restrict__ cz,
                              const uint32_t* __restrict__ cr, uint32_t* __restrict__ out,
                              int batch, const __grid_constant__ Modulus<W> m,
                              const __grid_constant__ Exponents e) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= batch) return;
  const int64_t row = static_cast<int64_t>(lane) * W;
  uint32_t kept[4][W];  // c1 R', cz R', cr R', then c2^xb R'
  uint32_t base[W], sq[W], x[W];
  const uint32_t* in[5] = {c1 + row, cz + row, cr + row, c2 + row, c3 + row};
#pragma unroll 1
  for (int k = 0; k < 5; ++k) {
    copy<W>(x, in[k]);
    mont_mul<W>(x, m.r2, m);
    if (k < 3) {
      save<W>(kept[k], x);
      continue;
    }
    pow_shared<W>(x, e.words[k - 3], e.bits[k - 3], base, sq, m);
    if (k == 3) save<W>(kept[3], x);
  }
  // x = c3^yb: times c2^xb and c1, raised to s, times cz and cr.
#pragma unroll 1
  for (int k = 0; k < 2; ++k) mont_mul<W>(x, kept[3 - 3 * k], m);
  pow_shared<W>(x, e.words[2], e.bits[2], base, sq, m);
#pragma unroll 1
  for (int k = 1; k < 3; ++k) mont_mul<W>(x, kept[k], m);
  mont_mul<W>(x, m.unit, m);
  save<W>(out + row, x);
}

// ---------------------------------------------------------------------------
// The group kernels (dgk_powmod_lanes, dgk_powmod_shared): G threads of one
// warp per number, thread `rank` holding limbs rank L .. rank L + L - 1 of
// every operand in registers (W' = G L limbs; the words above W are zero).

// (W, G, L) for each width compiled.
#define PPLP_DGK_GROUPS(X) X(17, 4, 5) X(65, 5, 13)

constexpr int kGroupThreads = 64;  // threads a block
constexpr int kGroupBlocks = 8;    // blocks an SM holds: at most 128 registers a thread
constexpr int kWindow = 3;         // exponent bits a window
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int G, int L>
struct Group {
  int lane;        // lane in the warp
  int first;       // lane of the group's rank 0
  int rank;        // rank in the group
  bool active;     // the group owns a number below batch
  int64_t number;  // that number (clamped below batch for idle groups)
  uint32_t n[L];   // this thread's slice of n
  uint32_t n0inv;  // -n^-1 mod 2^32

  __device__ __forceinline__ Group(const Modulus<G * L>& m, int batch) {
    constexpr int kPerWarp = 32 / G;  // with G = 5 the last two lanes idle
    lane = static_cast<int>(threadIdx.x & 31);
    const int group = lane / G;
    first = group * G;
    rank = lane - first;
    const int64_t num =
        (static_cast<int64_t>(blockIdx.x) * (kGroupThreads / 32) + (threadIdx.x >> 5)) *
            kPerWarp + group;
    active = group < kPerWarp && num < batch;
    number = num < batch ? num : batch - 1;
#pragma unroll
    for (int l = 0; l < L; ++l) n[l] = m.n[word(l)];
    n0inv = m.n0inv;
  }
  __device__ __forceinline__ int word(int l) const { return rank * L + l; }
  // The group's bits of a warp ballot, rank r at bit r.
  __device__ __forceinline__ uint32_t bits(uint32_t ballot) const {
    return (ballot >> first) & ((1u << G) - 1);
  }
};

// t += c over one slice; returns the carry out (0 or 1).
template <int L>
__device__ __forceinline__ uint32_t add_word(uint32_t (&t)[L], uint32_t c) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t s = static_cast<uint64_t>(t[j]) + c;
    t[j] = static_cast<uint32_t>(s);
    c = static_cast<uint32_t>(s >> 32);
  }
  return c;
}

// d = t - n - b over one slice (b 0 or 1); returns the borrow out.
template <int L>
__device__ __forceinline__ uint32_t sub_row(uint32_t (&d)[L], const uint32_t (&t)[L],
                                            const uint32_t (&n)[L], uint32_t b) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t s = static_cast<uint64_t>(t[j]) - n[j] - b;
    d[j] = static_cast<uint32_t>(s);
    b = static_cast<uint32_t>(s >> 32) & 1u;
  }
  return b;
}

// Carry look-ahead over a group's ballot bits: bit r of the result is the
// carry into rank r, bit G the carry out of the group. gen: the ranks that
// carry out by themselves; prop: those that pass a carry in on.
__device__ __forceinline__ uint32_t lookahead(uint32_t gen, uint32_t prop) {
  const uint32_t a = gen | prop;
  return (a + gen) ^ a ^ gen;
}

// out = a b R'^-1 mod n (canonical) for a, b below n: CIOS over the group.
// Step i broadcasts a_i from its owner and q from rank 0; each thread adds
// a_i b and q n to its slice and shifts it down one limb, its top limb
// taking the low word of the rank above. The word each rank carries out of
// its top stays pending in C, which the shift brings back into that rank's
// top limb; C stays below 4. At the end the pending carries move up one
// rank (what they ripple on is one bit a rank, resolved by look-ahead), then
// one conditional subtraction of n, its borrows by look-ahead. The result
// lies below 2n < R', so nothing is carried out of the group. out may be a
// or b: both are read to the end before out is written.
template <int G, int L>
__device__ __forceinline__ void group_mul(uint32_t (&out)[L], const uint32_t (&a)[L],
                                          const uint32_t (&b)[L], const Group<G, L>& g) {
  uint32_t t[L];
#pragma unroll
  for (int j = 0; j < L; ++j) t[j] = 0;
  uint32_t C = 0;
  const int up = (g.lane + 1) & 31;
#pragma unroll 1
  for (int o = 0; o < G; ++o) {  // the owner of a_i; i = o L + l
    const int src = (g.first + o) & 31;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const uint32_t ai = __shfl_sync(kFull, a[l], src);
      const uint32_t c1 = mad_row<L>(t, ai, b);
      const uint32_t q = __shfl_sync(kFull, t[0] * g.n0inv, g.first);
      const uint32_t c2 = mad_row<L>(t, q, g.n);
      uint32_t nx = __shfl_sync(kFull, t[0], up);  // rank 0's t[0] is 0 here
      if (g.rank == G - 1) nx = 0;
#pragma unroll
      for (int j = 0; j + 1 < L; ++j) t[j] = t[j + 1];
      const uint64_t s = static_cast<uint64_t>(nx) + C + c1 + c2;
      t[L - 1] = static_cast<uint32_t>(s);
      C = static_cast<uint32_t>(s >> 32);
    }
  }
  uint32_t cin = __shfl_sync(kFull, C, (g.lane + 31) & 31);
  if (g.rank == 0) cin = 0;
  const uint32_t e = add_word<L>(t, cin);
  uint32_t ones = kFull;
#pragma unroll
  for (int j = 0; j < L; ++j) ones &= t[j];
  const uint32_t carries = lookahead(g.bits(__ballot_sync(kFull, e != 0 && g.rank < G - 1)),
                                     g.bits(__ballot_sync(kFull, ones == kFull)));
  add_word<L>(t, (carries >> g.rank) & 1u);
  uint32_t d[L];
  const uint32_t zero[L] = {};
  const uint32_t bo = sub_row<L>(d, t, g.n, 0);
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) any |= d[j];
  const uint32_t borrows = lookahead(g.bits(__ballot_sync(kFull, bo != 0)),
                                     g.bits(__ballot_sync(kFull, any == 0)));
  sub_row<L>(d, d, zero, (borrows >> g.rank) & 1u);
  const bool ge = ((borrows >> G) & 1u) == 0;  // no borrow out of the group: t >= n
#pragma unroll
  for (int j = 0; j < L; ++j) out[j] = ge ? d[j] : t[j];
}

// Window d (kWindow bits) of an exponent of `words` u32 words: one or two
// words, shifted.
__device__ __forceinline__ uint32_t window_of(const uint32_t* e, int words, int d) {
  const int bit = d * kWindow, i = bit >> 5;
  uint64_t v = e[i];
  if (i + 1 < words) v |= static_cast<uint64_t>(e[i + 1]) << 32;
  return static_cast<uint32_t>(v >> (bit & 31)) & ((1u << kWindow) - 1);
}

// The table: this thread's slice of entry k at tab[(k L + l) kGroupThreads]
// (tab = the block's dynamic shared memory + threadIdx.x): each thread reads
// only what it wrote, and a warp's 32 threads hit 32 banks.
template <int L>
__device__ __forceinline__ void put(uint32_t* tab, int k, const uint32_t (&x)[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) tab[(k * L + l) * kGroupThreads] = x[l];
}

template <int L>
__device__ __forceinline__ void get(uint32_t (&x)[L], const uint32_t* tab, int k) {
#pragma unroll
  for (int l = 0; l < L; ++l) x[l] = tab[(k * L + l) * kGroupThreads];
}

// x <- x^e mod n for a standard-domain x below R' and an exponent of
// `windows` windows, read by digit(d): to the Montgomery domain, the table
// x^0 .. x^(2^kWindow - 1) (2^kWindow - 2 products), then per window below
// the top one kWindow squarings and one product by the entry it selects
// (entry 0 is R' mod n, so a zero window costs what any other does), and
// back. Every group runs the same 2^kWindow + (windows - 1)(kWindow + 1)
// products whatever its bits; all of them go through one group_mul, whose
// operand b the step selects.
template <int G, int L, typename Digit>
__device__ __forceinline__ void group_pow(uint32_t (&x)[L], int windows, Digit digit,
                                          uint32_t* tab, const Group<G, L>& g,
                                          const Modulus<G * L>& m) {
  constexpr int kTable = 1 << kWindow;
  const int total = kTable + (windows > 1 ? (windows - 1) * (kWindow + 1) : 0);
  uint32_t b[L];
#pragma unroll 1
  for (int s = 0; s < total; ++s) {
    const int w = s - (kTable - 1);  // the walk's step, from 0
    if (s == 0) {  // x R'
#pragma unroll
      for (int l = 0; l < L; ++l) b[l] = m.r2[g.word(l)];
    } else if (s == total - 1) {  // back: x 1 R'^-1
#pragma unroll
      for (int l = 0; l < L; ++l) b[l] = (g.rank == 0 && l == 0) ? 1u : 0u;
    } else if (w < 0) {  // the table: x^(s + 1) = x^s x
      get<L>(b, tab, 1);
    } else if (w % (kWindow + 1) == kWindow) {
      get<L>(b, tab, digit(windows - 2 - w / (kWindow + 1)));
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) b[l] = x[l];
    }
    group_mul<G, L>(x, x, b, g);
    if (s == 0) {
#pragma unroll
      for (int l = 0; l < L; ++l) b[l] = m.one[g.word(l)];
      put<L>(tab, 0, b);
      put<L>(tab, 1, x);
    } else if (w < 0) {
      put<L>(tab, s + 1, x);
    }
    if (w == -1) get<L>(x, tab, windows > 0 ? digit(windows - 1) : 0);
  }
}

// x = this thread's slice of a W-limb row (zero above W).
template <int W, int L>
__device__ __forceinline__ void load_row(uint32_t (&x)[L], const uint32_t* row, int rank) {
#pragma unroll
  for (int l = 0; l < L; ++l) x[l] = rank * L + l < W ? row[rank * L + l] : 0u;
}

template <int W, int L>
__device__ __forceinline__ void store_row(uint32_t* row, const uint32_t (&x)[L], int rank) {
#pragma unroll
  for (int l = 0; l < L; ++l)
    if (rank * L + l < W) row[rank * L + l] = x[l];
}

// out = base^e mod n with a per-lane exponent (exp_words words a lane, at
// most exp_bits bits); base_stride 0: one base for every lane. A group reads
// its own lane's words, every thread of it the same ones.
template <int W, int G, int L>
__global__ void __launch_bounds__(kGroupThreads, kGroupBlocks)
    dgk_powmod_lanes_kernel(const uint32_t* __restrict__ base_in, int64_t base_stride,
                            const uint32_t* __restrict__ exps, int exp_words, int exp_bits,
                            uint32_t* __restrict__ out, int batch,
                            const __grid_constant__ Modulus<G * L> m) {
  extern __shared__ uint32_t dgk_table[];
  const Group<G, L> g(m, batch);
  uint32_t x[L];
  load_row<W, L>(x, base_in + g.number * base_stride, g.rank);
  const uint32_t* e = exps + g.number * exp_words;
  group_pow<G, L>(x, (exp_bits + kWindow - 1) / kWindow,
                  [&](int d) { return window_of(e, exp_words, d); },
                  dgk_table + threadIdx.x, g, m);
  if (g.active) store_row<W, L>(out + g.number * W, x, g.rank);
}

// out = base^e mod n, one exponent (e.words[0], e.bits[0]) for every lane.
template <int W, int G, int L>
__global__ void __launch_bounds__(kGroupThreads, kGroupBlocks)
    dgk_powmod_shared_kernel(const uint32_t* __restrict__ base_in,
                             uint32_t* __restrict__ out, int batch,
                             const __grid_constant__ Modulus<G * L> m,
                             const __grid_constant__ Exponents e) {
  extern __shared__ uint32_t dgk_table[];
  const Group<G, L> g(m, batch);
  uint32_t x[L];
  load_row<W, L>(x, base_in + g.number * W, g.rank);
  group_pow<G, L>(x, (e.bits[0] + kWindow - 1) / kWindow,
                  [&](int d) { return window_of(e.words[0], kExpWords, d); },
                  dgk_table + threadIdx.x, g, m);
  if (g.active) store_row<W, L>(out + g.number * W, x, g.rank);
}

template <int G>
dim3 group_grid(int batch) {
  constexpr int kPerBlock = (32 / G) * (kGroupThreads / 32);
  return dim3((batch + kPerBlock - 1) / kPerBlock);
}

template <int L>
constexpr size_t table_bytes() {
  return sizeof(uint32_t) * (size_t{1} << kWindow) * L * kGroupThreads;
}

template <int W>
Modulus<W> modulus_of(const void* consts) {
  Modulus<W> m;
  const auto* w = static_cast<const uint32_t*>(consts);
  std::memcpy(m.n, w, sizeof(m.n));
  std::memcpy(m.r2, w + W, sizeof(m.r2));
  std::memcpy(m.one, w + 2 * W, sizeof(m.one));
  std::memcpy(m.unit, w + 3 * W, sizeof(m.unit));
  m.n0inv = w[4 * W];
  return m;
}

Exponents exponents_of(const void* words, const int* bits, int count) {
  Exponents e{};
  std::memcpy(e.words, words, sizeof(e.words));
  for (int k = 0; k < count; ++k) e.bits[k] = bits[k];
  return e;
}

bool exps_ok(const Exponents& e) {
  for (int b : e.bits)
    if (b < 0 || b > 32 * kExpWords) return false;
  return true;
}

dim3 grid_of(int batch) { return dim3((batch + kThreads - 1) / kThreads); }

}  // namespace

#define PPLP_DGK_WIDTHS(X) X(17) X(65)

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 = success)
// or cudaErrorInvalidValue for a width other than 17 or 65, a batch below 1
// or an exponent outside [0, 2048] bits. Numbers are contiguous int32
// [batch, W] on the device (u32 limbs); consts: the host's 4 W + 1 words
// (n, R'^2 mod n, R' mod n, 1, -n^-1 mod 2^32), for the group kernels
// 4 W' + 1 words at their internal width W' = G L (pplp_dgk_group); exps:
// the host's 3 x 64 exponent words (shared exponents).

// The group kernels' geometry at width W: geometry = {G, L, window bits}.
int pplp_dgk_group(int W, int* geometry) {
#define PPLP_DGK_GEOMETRY(WW, GG, LL) \
  if (W == WW) {                      \
    geometry[0] = GG;                 \
    geometry[1] = LL;                 \
    geometry[2] = kWindow;            \
    return 0;                         \
  }
  PPLP_DGK_GROUPS(PPLP_DGK_GEOMETRY)
#undef PPLP_DGK_GEOMETRY
  return static_cast<int>(cudaErrorInvalidValue);
}

int pplp_dgk_mulmod(const void* a, const void* b, long long b_stride, void* out, int batch,
                    int W, const void* consts, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define PPLP_DGK_MULMOD(WW)                                                          \
  if (W == WW) {                                                                     \
    dgk_mulmod_kernel<WW><<<grid_of(batch), kThreads, 0, s>>>(                       \
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), b_stride,  \
        static_cast<uint32_t*>(out), batch, modulus_of<WW>(consts));                 \
    return static_cast<int>(cudaGetLastError());                                     \
  }
  PPLP_DGK_WIDTHS(PPLP_DGK_MULMOD)
#undef PPLP_DGK_MULMOD
  return static_cast<int>(cudaErrorInvalidValue);
}

int pplp_dgk_powmod_lanes(const void* base, long long base_stride, const void* exps,
                          int exp_words, int exp_bits, void* out, int batch, int W,
                          const void* consts, void* stream) {
  if (batch < 1 || exp_bits < 0 || exp_bits > 32 * exp_words)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define PPLP_DGK_LANES(WW, GG, LL)                                                         \
  if (W == WW) {                                                                           \
    const auto kernel = dgk_powmod_lanes_kernel<WW, GG, LL>;                               \
    const cudaError_t set = cudaFuncSetAttribute(                                          \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, table_bytes<LL>());           \
    if (set != cudaSuccess) return static_cast<int>(set);                                  \
    kernel<<<group_grid<GG>(batch), kGroupThreads, table_bytes<LL>(), s>>>(               \
        static_cast<const uint32_t*>(base), base_stride, static_cast<const uint32_t*>(exps), \
        exp_words, exp_bits, static_cast<uint32_t*>(out), batch,                           \
        modulus_of<GG * LL>(consts));                                                      \
    return static_cast<int>(cudaGetLastError());                                           \
  }
  PPLP_DGK_GROUPS(PPLP_DGK_LANES)
#undef PPLP_DGK_LANES
  return static_cast<int>(cudaErrorInvalidValue);
}

int pplp_dgk_powmod_shared(const void* base, void* out, int batch, int W,
                           const void* consts, const void* exps, const void* bits,
                           void* stream) {
  const Exponents e = exponents_of(exps, static_cast<const int*>(bits), 1);
  if (batch < 1 || !exps_ok(e)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define PPLP_DGK_SHARED(WW, GG, LL)                                                \
  if (W == WW) {                                                                   \
    const auto kernel = dgk_powmod_shared_kernel<WW, GG, LL>;                      \
    const cudaError_t set = cudaFuncSetAttribute(                                  \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, table_bytes<LL>());   \
    if (set != cudaSuccess) return static_cast<int>(set);                          \
    kernel<<<group_grid<GG>(batch), kGroupThreads, table_bytes<LL>(), s>>>(       \
        static_cast<const uint32_t*>(base), static_cast<uint32_t*>(out), batch,    \
        modulus_of<GG * LL>(consts), e);                                           \
    return static_cast<int>(cudaGetLastError());                                   \
  }
  PPLP_DGK_GROUPS(PPLP_DGK_SHARED)
#undef PPLP_DGK_SHARED
  return static_cast<int>(cudaErrorInvalidValue);
}

int pplp_dgk_blind_distance(const void* c1, const void* c2, const void* c3, const void* cz,
                            const void* cr, void* out, int batch, int W, const void* consts,
                            const void* exps, const void* bits, void* stream) {
  const Exponents e = exponents_of(exps, static_cast<const int*>(bits), 3);
  if (batch < 1 || !exps_ok(e)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define PPLP_DGK_BLIND(WW)                                                                 \
  if (W == WW) {                                                                           \
    dgk_blind_distance_kernel<WW><<<grid_of(batch), kThreads, 0, s>>>(                     \
        static_cast<const uint32_t*>(c1), static_cast<const uint32_t*>(c2),                \
        static_cast<const uint32_t*>(c3), static_cast<const uint32_t*>(cz),                \
        static_cast<const uint32_t*>(cr), static_cast<uint32_t*>(out), batch,              \
        modulus_of<WW>(consts), e);                                                        \
    return static_cast<int>(cudaGetLastError());                                           \
  }
  PPLP_DGK_WIDTHS(PPLP_DGK_BLIND)
#undef PPLP_DGK_BLIND
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
