// Batched multi-precision Montgomery arithmetic for the DGK back-end on
// Hopper (sm_90a): products, exponentiations and the blind-distance chain
// mod an odd DGK modulus n of up to 4,112 bits.
//
// Replaces no Pallas kernel: the reference's Montgomery product is the XLA
// CIOS scan pplp_tpu/dgk/modexp.py:111 (MontgomeryCtx.mont_mul), which the
// reference's batched DGK (pplp_tpu/dgk/batched.py) runs under jit. Eager
// torch would spend ~1,500 launches on one such product, so every
// exponentiation here runs its whole exponent walk inside one launch.
//
// Four kernels, each a group of G threads of one warp per number:
//   dgk_mulmod          a b mod n, b per lane or one for every lane: two
//                       products (a R', then by b); or one product by b R'
//                       mod n made on the host (the BSGS giant step, as the
//                       reference runs it)
//   dgk_powmod_lanes    base^e with per-lane exponents (encrypt's g^m, h^r)
//   dgk_powmod_shared   base^e with one exponent (the decrypt's c^vpq)
//   dgk_blind_distance  ((c1 c2^xb c3^yb)^s) cz cr, the server's chain
//
// Representation: a number is W' = G L 32-bit limbs, little-endian; thread
// `rank` of its group holds limbs rank L .. rank L + L - 1 of every operand
// in registers, indexed by compile-time constants only. dgk_mulmod and
// dgk_blind_distance read and write the port's rows of D 16-bit digits
// (int64 [B, D]) themselves; the two exponentiations take u32 limb rows
// [B, W] (int32 tensors) that the wrapper (ops/dgk_cuda.py) makes. A modulus
// of fewer limbs than a compiled width W runs at that width with zero limbs
// above n: CIOS is exact for any odd n below R' = 2^(32 W'). A product is
// CIOS on 32 x 32 -> 64-bit multiply-adds at R' with one conditional
// subtraction: for a below R' and b below n the result is below 2n before it
// and canonical after it. Every entry point takes standard-domain values
// below R' and writes canonical values below n; the Montgomery domain never
// leaves a kernel, so the kernels agree with the plain version (R = 2^(16 D))
// whatever R'.
//
// The modulus' constants (n, R'^2 mod n, R' mod n, -n^-1 mod 2^32, at W'),
// the giant step's b R' mod n and the shared exponents travel by value in
// the kernel parameters (constant bank 0, __grid_constant__). A shared
// exponent has at most 2048 bits (kExpWords), which every caller's fits: the
// decrypt's vpq has 2t bits (640 at t = 320), xb and yb are coordinates and
// s an l-bit blind.
//
// What bounds it: integer multiplies. A product takes 2 W^2 + W 32 x 32 ->
// 64-bit multiply-adds (8,515 at W = 65), each an IMAD.WIDE.U32: two slots
// of the card's 32-bit multiply rate at its nominal issue rate, against a
// few rows of memory traffic a lane (int64 digit rows, 16 B a limb, for the
// product and the blind distance; u32 limb rows for the exponentiations):
// every entry point is bound by operations at W = 65.
//
// The group product (group_mul): W' steps of a broadcast limb a_i, L
// multiply-adds into the slice, a broadcast quotient from rank 0, L more,
// and a one-limb shift whose top word comes from the rank above; each
// rank's carry out stays pending and is resolved once a product by ballot
// and look-ahead. Each kernel runs all its products through one call site
// of group_mul, whose operand b the step selects, and every group of a
// launch runs the same product sequence whatever its data: the per-lane
// exponents by a fixed 3-bit window (group_pow), the shared ones bit by bit.
//   The blind distance (dgk_blind_distance_kernel) walks xb and yb together,
// left to right (Shamir's trick: per bit a squaring and, where either bit
// is set, one product by c2, c3 or c2 c3 from shared memory), then s by
// the binary method, and folds the conversions into the chain's products:
// 43 products a lane at bench.py's (123321, 123654, 37), against the 63 of
// two binary walks and the 65 of the reference chain.
//
// Geometry (PPLP_DGK_GROUPS; 64 threads a block, 8 blocks an SM, so
// __launch_bounds__ allows at most 128 registers a thread):
//   W = 17  (k = 512,  moduli of up to 528 bits)    G = 4,  L = 5  (W' = 20)
//   W = 33  (k = 1024, up to 1,040 bits)            G = 3,  L = 11 (W' = 33)
//   W = 65  (k = 2048, up to 2,064 bits)            G = 5,  L = 13 (W' = 65)
//   W = 97  (k = 3072, up to 3,088 bits)            G = 8,  L = 13 (W' = 104)
//   W = 129 (k = 4096, up to 4,112 bits)            G = 10, L = 13 (W' = 130)
// 32 / G groups a warp; the lanes above them idle. A wider modulus is
// refused.
//   Measured at B = 10,000, k = 2048 (H100 80GB HBM3, 700 W; measure_dgk,
// profiler, a launch), each against the products its function needs at 2
// slots a multiply-add (measure_dgk.kernel_bounds: the fewer of the binary
// and the window counts; the blind distance's 43): h^r 26.2-26.5 ms and
// c^vpq 21.3-21.4 ms (41%; 46% of the binary count); the blind distance
// 1.12-1.14 ms (39%; 58-59% of the reference chain's 65; one thread a lane
// with the chain's five conversions and two binary walks took 3.57-3.59;
// two binary walks on the group product 1.69); encrypt's product
// 0.071-0.072 ms (28%: a launch of two products a lane pays ~0.03 ms of
// ramp and one latency-bound product chain; 38% at B = 30,000); the giant
// step 0.013 ms at 1,000 lanes. The other widths' geometry, h^r, c^vpq and
// the blind distance at B = 10,000: W = 33 (k = 1024) G = 3, L = 11 3.37,
// 2.69, 0.33 ms, G = 4, L = 9 4.70, 3.88, 0.39; W = 97 (k = 3072) G = 8,
// L = 13 79.3, 63.5, 2.24 ms (44-46%), G = 10, L = 10 83.4-83.9,
// 68.5-68.7, 2.35-2.36; W = 129 (k = 4096) G = 10, L = 13 180.5,
// 146.4-146.5, 3.84 ms (45-47%), G = 16, L = 9 230.2, 189.4-190.6,
// 4.69-4.75.
//   ptxas (-Xptxas -v): 0 bytes of stack frame and no spill in every kernel
// at every width; registers at W = 17, 33, 65, 97, 129: dgk_powmod_lanes 74,
// 94, 106, 106, 106; dgk_powmod_shared 72, 90, 100, 100, 100; dgk_mulmod 64,
// 80, 100, 102, 100; dgk_blind_distance 76, 94, 104, 102, 104.
//   Limb products as u64 multiply-adds (csrc/dgk_rows.cuh: 3.08 SASS
// instructions a limb product) rather than PTX carry chains (4.31).
//   The window: products a lane 2^3 + (ceil(bits / 3) - 1) 4, whatever the
// bits: 1,072 for h^r's 800-bit exponents (the binary method: 1,199 on
// average), 856 for c^vpq's 640 bits (967), 28 for g^m's 16 (22.9). A 4-bit window ran h^r and c^vpq 1.5% faster and g^m 15%
// slower, with 53,248 B of table a block.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "dgk_rows.cuh"

namespace {

using pplp_dgk::mad_row;

constexpr int kExpWords = 64;      // a shared exponent has at most 2048 bits
constexpr int kGroupThreads = 64;  // threads a block
constexpr int kGroupBlocks = 8;    // blocks an SM holds: at most 128 registers a thread
constexpr int kWindow = 3;         // per-lane exponent bits a window
constexpr unsigned kFull = 0xFFFFFFFFu;

// (W, G, L) for each width compiled.
#define PPLP_DGK_GROUPS(X) X(17, 4, 5) X(33, 3, 11) X(65, 5, 13) X(97, 8, 13) X(129, 10, 13)

template <int W>
struct Modulus {
  uint32_t n[W];
  uint32_t r2[W];   // R'^2 mod n: the to-domain multiplier
  uint32_t one[W];  // R' mod n: 1 in the Montgomery domain
  uint32_t n0inv;   // -n^-1 mod 2^32
};

template <int W>
struct Operand {
  uint32_t v[W];
};

struct Exponents {
  int bits[3];
  uint32_t words[3][kExpWords];
};

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
    constexpr int kPerWarp = 32 / G;  // the lanes above kPerWarp G idle
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
  // x = this thread's slice of a W'-word constant.
  __device__ __forceinline__ void slice(uint32_t (&x)[L], const uint32_t* words) const {
#pragma unroll
    for (int l = 0; l < L; ++l) x[l] = words[word(l)];
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

// out = a b R'^-1 mod n (canonical) for a below R' and b below n: CIOS over
// the group. Step i broadcasts a_i from its owner and q from rank 0; each
// thread adds a_i b and q n to its slice and shifts it down one limb, its
// top limb taking the low word of the rank above. The word each rank
// carries out of its top stays pending in C, which the shift brings back
// into that rank's top limb; C stays below 4. At the end the pending carries
// move up one rank (what they ripple on is one bit a rank, resolved by
// look-ahead), then one conditional subtraction of n, its borrows by
// look-ahead. The result lies below 2n < R', so nothing is carried out of
// the group. out may be a or b: both are read to the end before out is
// written.
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

// Bit `bit` of an exponent of `bits` bits (0 at and above bits).
__device__ __forceinline__ uint32_t bit_of(const uint32_t* e, int bits, int bit) {
  return bit < bits ? (e[bit >> 5] >> (bit & 31)) & 1u : 0u;
}

// A table in the block's dynamic shared memory: this thread's slice of
// entry k at tab[(k L + l) kGroupThreads] (tab = the table + threadIdx.x):
// each thread reads only what it wrote, and a warp's 32 threads hit 32
// banks.
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

template <int L>
constexpr size_t table_bytes(int entries) {
  return sizeof(uint32_t) * entries * L * kGroupThreads;
}

// x <- x^e mod n for a standard-domain x below R' and an exponent of
// `windows` windows, read by digit(d): to the Montgomery domain, the table
// x^0 .. x^(2^kWindow - 1) (2^kWindow - 2 products), then per window below
// the top one kWindow squarings and one product by the entry it selects
// (entry 0 is R' mod n, so a zero window costs what any other does), and
// back. Every group runs the same 2^kWindow + (windows - 1)(kWindow + 1)
// products whatever its bits.
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
      g.slice(b, m.r2);
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
      g.slice(b, m.one);
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

// x = this thread's slice of a row of D 16-bit digits in int64 (zero above D).
template <int L>
__device__ __forceinline__ void load_digits(uint32_t (&x)[L], const int64_t* row, int D,
                                            int rank) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = 2 * (rank * L + l);
    const uint32_t lo = i < D ? static_cast<uint32_t>(row[i]) : 0u;
    const uint32_t hi = i + 1 < D ? static_cast<uint32_t>(row[i + 1]) : 0u;
    x[l] = lo | hi << 16;
  }
}

// The slice's digits below D into a row of them (a value below n has no
// digit at or above D).
template <int L>
__device__ __forceinline__ void store_digits(int64_t* row, const uint32_t (&x)[L], int D,
                                             int rank) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int i = 2 * (rank * L + l);
    if (i < D) row[i] = x[l] & 0xFFFFu;
    if (i + 1 < D) row[i + 1] = x[l] >> 16;
  }
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

// out = a b mod n over digit rows of D digits. b_mont 0: b per lane
// (b_stride D) or one for every lane (b_stride 0), two products: a R', then
// a R' b R'^-1. b_mont 1: b is ignored and every lane takes one product by
// bm = c R' mod n for the host's constant c: a c R' R'^-1 = a c.
template <int G, int L>
__global__ void __launch_bounds__(kGroupThreads, kGroupBlocks)
    dgk_mulmod_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                      int64_t b_stride, int64_t* __restrict__ out, int batch, int D,
                      const __grid_constant__ Modulus<G * L> m, int b_mont,
                      const __grid_constant__ Operand<G * L> bm) {
  const Group<G, L> g(m, batch);
  uint32_t x[L], y[L];
  load_digits<L>(x, a + g.number * D, D, g.rank);
#pragma unroll 1
  for (int k = b_mont; k < 2; ++k) {
    if (k == 0)
      g.slice(y, m.r2);
    else if (b_mont)
      g.slice(y, bm.v);
    else
      load_digits<L>(y, b + g.number * b_stride, D, g.rank);
    group_mul<G, L>(x, x, y, g);
  }
  if (g.active) store_digits<L>(out + g.number * D, x, D, g.rank);
}

// The blind distance's table entries (shared memory): c2 R', c3 R', c2 c3 R';
// entry 0 is then the s walk's base.
constexpr int kBlindEntries = 3;

// A shared-exponent walk of the blind distance: two exponents read
// together (the second of 0 bits for a walk over one), the bit in progress,
// and whether that bit's product (after its squaring) is next.
struct Walk {
  const uint32_t* e1;
  const uint32_t* e2;
  int bits1, bits2, bit;
  bool mul;

  // The bit pair at bit i: bit i of e1, plus 2 for bit i of e2.
  __device__ __forceinline__ int pair(int i) const {
    return static_cast<int>(bit_of(e1, bits1, i) | bit_of(e2, bits2, i) << 1);
  }
  // x = the start of the walk: the entry the top bit pair selects (R' mod n
  // for two exponents of 0); false if no bit is left below the top one.
  template <int G, int L>
  __device__ __forceinline__ bool start(uint32_t (&x)[L], const uint32_t* tab,
                                        const Group<G, L>& g, const Modulus<G * L>& m) {
    const int top = bits1 > bits2 ? bits1 : bits2;
    if (top == 0)
      g.slice(x, m.one);
    else
      get<L>(x, tab, pair(top - 1) - 1);
    bit = top - 2;
    mul = false;
    return bit >= 0;
  }
  // b = the operand of the next product: x (a squaring) or an entry.
  template <int L>
  __device__ __forceinline__ void operand(uint32_t (&b)[L], const uint32_t (&x)[L],
                                          const uint32_t* tab) const {
    if (mul) {
      get<L>(b, tab, pair(bit) - 1);
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) b[l] = x[l];
    }
  }
  // After a product: false once the last bit is done.
  __device__ __forceinline__ bool advance() {
    if (!mul && pair(bit) != 0) {
      mul = true;
      return true;
    }
    mul = false;
    return --bit >= 0;
  }
};

// The steps of the blind distance, in order; each is one product x <- x b R'^-1.
enum BlindStep : int {
  kC2Mont,   // x = c2: b = R'^2                      -> c2 R' (entry 0)
  kC3Mont,   // x = c3: b = R'^2                      -> c3 R' (entry 1)
  kC23,      // b = entry 0                           -> c2 c3 R' (entry 2)
  kJoint,    // the joint walk over xb, yb            -> T R', T = c2^xb c3^yb
  kC1,       // b = c1                                -> c1 T (standard domain)
  kC1Mont,   // b = R'^2                              -> c1 T R' (entry 0)
  kWalkS,    // the walk over s                       -> A R', A = (c1 T)^s
  kCz,       // b = cz                                -> A cz
  kCzMont,   // b = R'^2                              -> A cz R'
  kCr,       // b = cr                                -> A cz cr
  kDone
};

// The server's DGK blind distance per lane, out = ((c1 c2^xb c3^yb)^s) cz cr
// mod n over digit rows of D digits (e.words[0..2] = xb, yb, s), as the
// sequence of products BlindStep lists, every one through one group_mul.
// A walk goes left to right from the top bit of its exponents (of yb and xb
// together, or of s alone): x starts at the entry the top bit pair selects
// (x^0 = R' mod n if both exponents are 0), and each lower bit takes a
// squaring (b = x) and, where the pair is not 0, a product by entry pair - 1
// (1: c2, 2: c3, 3: c2 c3; s has pairs 0 and 1 only). Every group runs the
// same steps: the exponents are shared.
template <int G, int L>
__global__ void __launch_bounds__(kGroupThreads, kGroupBlocks)
    dgk_blind_distance_kernel(const int64_t* __restrict__ c1, const int64_t* __restrict__ c2,
                              const int64_t* __restrict__ c3, const int64_t* __restrict__ cz,
                              const int64_t* __restrict__ cr, int64_t* __restrict__ out,
                              int batch, int D, const __grid_constant__ Modulus<G * L> m,
                              const __grid_constant__ Exponents e) {
  extern __shared__ uint32_t dgk_table[];
  uint32_t* tab = dgk_table + threadIdx.x;
  const Group<G, L> g(m, batch);
  const int64_t row = g.number * D;
  uint32_t x[L], b[L];
  load_digits<L>(x, c2 + row, D, g.rank);
  Walk walk{e.words[0], e.words[1], e.bits[0], e.bits[1], 0, false};
  int step = kC2Mont;
#pragma unroll 1
  while (step != kDone) {
    switch (step) {
      case kJoint:
      case kWalkS:
        walk.operand<L>(b, x, tab);
        break;
      case kC23:
        get<L>(b, tab, 0);
        break;
      case kC1:
        load_digits<L>(b, c1 + row, D, g.rank);
        break;
      case kCz:
        load_digits<L>(b, cz + row, D, g.rank);
        break;
      case kCr:
        load_digits<L>(b, cr + row, D, g.rank);
        break;
      default:  // kC2Mont, kC3Mont, kC1Mont, kCzMont
        g.slice(b, m.r2);
    }
    group_mul<G, L>(x, x, b, g);
    switch (step) {
      case kC2Mont:
        put<L>(tab, 0, x);
        load_digits<L>(x, c3 + row, D, g.rank);
        step = kC3Mont;
        break;
      case kC3Mont:
        put<L>(tab, 1, x);
        step = kC23;
        break;
      case kC23:
        put<L>(tab, 2, x);
        step = walk.start<G, L>(x, tab, g, m) ? kJoint : kC1;
        break;
      case kJoint:
        if (!walk.advance()) step = kC1;
        break;
      case kC1Mont:
        put<L>(tab, 0, x);
        walk = Walk{e.words[2], e.words[2], e.bits[2], 0, 0, false};
        step = walk.start<G, L>(x, tab, g, m) ? kWalkS : kCz;
        break;
      case kWalkS:
        if (!walk.advance()) step = kCz;
        break;
      default:  // kC1, kCz, kCzMont, kCr: the next step
        ++step;
    }
  }
  if (g.active) store_digits<L>(out + row, x, D, g.rank);
}

template <int G>
dim3 group_grid(int batch) {
  constexpr int kPerBlock = (32 / G) * (kGroupThreads / 32);
  return dim3((batch + kPerBlock - 1) / kPerBlock);
}

template <int W>
Modulus<W> modulus_of(const void* consts) {
  Modulus<W> m;
  const auto* w = static_cast<const uint32_t*>(consts);
  std::memcpy(m.n, w, sizeof(m.n));
  std::memcpy(m.r2, w + W, sizeof(m.r2));
  std::memcpy(m.one, w + 2 * W, sizeof(m.one));
  m.n0inv = w[3 * W];
  return m;
}

template <int W>
Operand<W> operand_of(const void* words) {
  Operand<W> v{};
  if (words) std::memcpy(v.v, words, sizeof(v.v));
  return v;
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

// Launches dgk_mulmod_kernel at width W; bm null: the two-product form.
int mulmod_launch(const void* a, const void* b, long long b_stride, void* out, int batch,
                  int D, int W, const void* consts, const void* bm, void* stream) {
  if (batch < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define PPLP_DGK_MULMOD(WW, GG, LL)                                                      \
  if (W == WW && D <= 2 * WW) {                                                          \
    dgk_mulmod_kernel<GG, LL><<<group_grid<GG>(batch), kGroupThreads, 0, s>>>(           \
        static_cast<const int64_t*>(a), static_cast<const int64_t*>(b), b_stride,        \
        static_cast<int64_t*>(out), batch, D, modulus_of<GG * LL>(consts), bm ? 1 : 0,   \
        operand_of<GG * LL>(bm));                                                        \
    return static_cast<int>(cudaGetLastError());                                         \
  }
  PPLP_DGK_GROUPS(PPLP_DGK_MULMOD)
#undef PPLP_DGK_MULMOD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch (0 = success)
// or cudaErrorInvalidValue for a width not compiled (PPLP_DGK_GROUPS), a
// batch below 1, rows of more than 2 W digits or an exponent outside
// [0, 2048] bits. W is the compiled width the modulus runs at; consts: the
// host's 3 W' + 1 words (n, R'^2 mod n, R' mod n, -n^-1 mod 2^32) at the
// width's W' = G L (pplp_dgk_group); exps: the host's 3 x 64 exponent words
// (shared exponents). dgk_mulmod and dgk_blind_distance take contiguous
// int64 rows of D 16-bit digits [batch, D]; the exponentiations contiguous
// int32 [batch, W] rows of u32 limbs.

// The geometry at width W: geometry = {G, L, window bits}.
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

// out = a b mod n; b_stride 0: one b for every lane, else D.
int pplp_dgk_mulmod(const void* a, const void* b, long long b_stride, void* out, int batch,
                    int D, int W, const void* consts, void* stream) {
  return mulmod_launch(a, b, b_stride, out, batch, D, W, consts, nullptr, stream);
}

// out = a c mod n for one constant c, one product a lane: bm, the host's W'
// words of c R' mod n.
int pplp_dgk_mulmod_mont(const void* a, void* out, int batch, int D, int W,
                         const void* consts, const void* bm, void* stream) {
  if (bm == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return mulmod_launch(a, nullptr, 0, out, batch, D, W, consts, bm, stream);
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
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, table_bytes<LL>(1 << kWindow)); \
    if (set != cudaSuccess) return static_cast<int>(set);                                  \
    kernel<<<group_grid<GG>(batch), kGroupThreads, table_bytes<LL>(1 << kWindow), s>>>(   \
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
#define PPLP_DGK_SHARED(WW, GG, LL)                                                  \
  if (W == WW) {                                                                     \
    const auto kernel = dgk_powmod_shared_kernel<WW, GG, LL>;                        \
    const cudaError_t set = cudaFuncSetAttribute(                                    \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,                         \
        table_bytes<LL>(1 << kWindow));                                              \
    if (set != cudaSuccess) return static_cast<int>(set);                            \
    kernel<<<group_grid<GG>(batch), kGroupThreads, table_bytes<LL>(1 << kWindow), s>>>( \
        static_cast<const uint32_t*>(base), static_cast<uint32_t*>(out), batch,      \
        modulus_of<GG * LL>(consts), e);                                             \
    return static_cast<int>(cudaGetLastError());                                     \
  }
  PPLP_DGK_GROUPS(PPLP_DGK_SHARED)
#undef PPLP_DGK_SHARED
  return static_cast<int>(cudaErrorInvalidValue);
}

int pplp_dgk_blind_distance(const void* c1, const void* c2, const void* c3, const void* cz,
                            const void* cr, void* out, int batch, int D, int W,
                            const void* consts, const void* exps, const void* bits,
                            void* stream) {
  const Exponents e = exponents_of(exps, static_cast<const int*>(bits), 3);
  if (batch < 1 || D < 1 || !exps_ok(e)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define PPLP_DGK_BLIND(WW, GG, LL)                                                          \
  if (W == WW && D <= 2 * WW) {                                                             \
    dgk_blind_distance_kernel<GG, LL>                                                       \
        <<<group_grid<GG>(batch), kGroupThreads, table_bytes<LL>(kBlindEntries), s>>>(      \
            static_cast<const int64_t*>(c1), static_cast<const int64_t*>(c2),               \
            static_cast<const int64_t*>(c3), static_cast<const int64_t*>(cz),               \
            static_cast<const int64_t*>(cr), static_cast<int64_t*>(out), batch, D,          \
            modulus_of<GG * LL>(consts), e);                                                \
    return static_cast<int>(cudaGetLastError());                                            \
  }
  PPLP_DGK_GROUPS(PPLP_DGK_BLIND)
#undef PPLP_DGK_BLIND
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
