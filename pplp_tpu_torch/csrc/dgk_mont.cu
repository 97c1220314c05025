// Batched multi-precision Montgomery arithmetic for the DGK back-end on
// Hopper (sm_90a): products, exponentiations and the blind-distance chain
// mod a 2048-bit (or 512-bit) DGK modulus n, one lane per thread.
//
// Replaces no Pallas kernel: the reference's Montgomery product is the XLA
// CIOS scan pplp_tpu/dgk/modexp.py:111 (MontgomeryCtx.mont_mul), which the
// reference's batched DGK (pplp_tpu/dgk/batched.py) runs under jit. Eager
// torch would spend ~1,500 launches on one such product, so every
// exponentiation here runs its whole square-and-multiply loop inside one
// launch.
//
// Representation: a number is W 32-bit limbs, little-endian (int32 tensors
// [B, W] holding the u32 bits); the wrapper (ops/dgk_cuda.py) converts from
// and to the port's 16-bit digit rows. Montgomery products are CIOS on
// 32 x 32 -> 64-bit multiply-adds with R' = 2^(32 W) and one conditional
// subtraction: for a, b < R' with one of them below n, the product is below
// 2n before it and canonical after it. Every entry point takes and returns
// standard-domain values below R' and writes canonical values below n; the
// Montgomery domain never leaves the kernel, so the kernel agrees with the
// plain version (R = 2^(16 D)) whatever D's parity.
//
// The modulus and its constants (n, R'^2 mod n, R' mod n, 1, -n^-1 mod 2^32)
// and the shared exponents travel by value in the kernel parameters
// (constant bank 0, __grid_constant__): the inner loops read n[j] as a
// constant operand of the multiply-add, and a shared exponent's bits as
// uniform constant loads.
//
// What bounds it: integer multiplies. A product takes 2 W^2 + W 32 x 32
// multiplies (8,515 at W = 65) against 3 W words of memory traffic per lane
// and exponentiation, so every entry point is bound by operations by three
// orders of magnitude. Design, simple first: one thread per lane; the
// accumulator and the running value in registers (the j loops unroll over
// the compile-time W, so their indices are constants); the operand whose
// limb i is read by the outer loop (i stays a loop counter, or the code
// would grow by W^2) comes through memory: the input row in device memory,
// the constants in the parameter bank, a saved value in local memory (the
// ptxas stack frame: 2 W words for an exponentiation, 6 W for the blind
// distance, by design, not a spill). Each CIOS step is a serial carry
// chain of W multiply-adds, and at B = 10,000 lanes of 64 threads a block
// the card holds 157 blocks, about one warp per scheduler: latency, not the
// multiply rate, bounds this design (a warp or a CTA per number is the next
// step). Widths: W = 17 (k = 512 keys, moduli of 497-528 bits) and W = 65
// (k = 2048, 2033-2064 bits); any other W is refused.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

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

// out = base^e mod n with a per-lane exponent (exp_words words a lane, at
// most exp_bits bits); base_stride 0: one base for every lane. Left to
// right from each lane's own top bit.
template <int W>
__global__ void __launch_bounds__(kThreads)
    dgk_powmod_lanes_kernel(const uint32_t* __restrict__ base_in, int64_t base_stride,
                            const uint32_t* __restrict__ exps, int exp_words, int exp_bits,
                            uint32_t* __restrict__ out, int batch,
                            const __grid_constant__ Modulus<W> m) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= batch) return;
  uint32_t base[W], sq[W], x[W];
  copy<W>(x, base_in + lane * base_stride);
  mont_mul<W>(x, m.r2, m);
  save<W>(base, x);
  const uint32_t* e = exps + static_cast<int64_t>(lane) * exp_words;
  bool started = false;
  copy<W>(x, m.one);
#pragma unroll 1
  for (int bit = exp_bits - 1; bit >= 0; --bit) {
    if (started) {
      save<W>(sq, x);
      mont_mul<W>(x, sq, m);
    }
    if (bit_of(e, bit)) {
      if (started) {
        mont_mul<W>(x, base, m);
      } else {
        copy<W>(x, base);
        started = true;
      }
    }
  }
  mont_mul<W>(x, m.unit, m);
  save<W>(out + static_cast<int64_t>(lane) * W, x);
}

// out = base^e mod n, one exponent (e.words[0], e.bits[0]) for every lane.
template <int W>
__global__ void __launch_bounds__(kThreads)
    dgk_powmod_shared_kernel(const uint32_t* __restrict__ base_in,
                             uint32_t* __restrict__ out, int batch,
                             const __grid_constant__ Modulus<W> m,
                             const __grid_constant__ Exponents e) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= batch) return;
  uint32_t base[W], sq[W], x[W];
  copy<W>(x, base_in + static_cast<int64_t>(lane) * W);
  mont_mul<W>(x, m.r2, m);
  pow_shared<W>(x, e.words[0], e.bits[0], base, sq, m);
  mont_mul<W>(x, m.unit, m);
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
// (n, R'^2 mod n, R' mod n, 1, -n^-1 mod 2^32); exps: the host's
// 3 x 64 exponent words (shared exponents).

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
#define PPLP_DGK_LANES(WW)                                                              \
  if (W == WW) {                                                                        \
    dgk_powmod_lanes_kernel<WW><<<grid_of(batch), kThreads, 0, s>>>(                    \
        static_cast<const uint32_t*>(base), base_stride, static_cast<const uint32_t*>(exps), \
        exp_words, exp_bits, static_cast<uint32_t*>(out), batch, modulus_of<WW>(consts)); \
    return static_cast<int>(cudaGetLastError());                                        \
  }
  PPLP_DGK_WIDTHS(PPLP_DGK_LANES)
#undef PPLP_DGK_LANES
  return static_cast<int>(cudaErrorInvalidValue);
}

int pplp_dgk_powmod_shared(const void* base, void* out, int batch, int W, const void* consts,
                           const void* exps, const void* bits, void* stream) {
  const Exponents e = exponents_of(exps, static_cast<const int*>(bits), 1);
  if (batch < 1 || !exps_ok(e)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define PPLP_DGK_SHARED(WW)                                                              \
  if (W == WW) {                                                                         \
    dgk_powmod_shared_kernel<WW><<<grid_of(batch), kThreads, 0, s>>>(                    \
        static_cast<const uint32_t*>(base), static_cast<uint32_t*>(out), batch,          \
        modulus_of<WW>(consts), e);                                                      \
    return static_cast<int>(cudaGetLastError());                                         \
  }
  PPLP_DGK_WIDTHS(PPLP_DGK_SHARED)
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
