// The m62 profile's elementwise modular arithmetic for Hopper (sm_90a): one
// kernel for each op of ops/modmath.py's m62 class that the port calls on
// card residues (2^32 <= q < 2^62, one int64 residue read as a u64). The
// lazy ops (csub, csub2q, lazy_sub2q, mulmod_shoup_lazy) have no kernel:
// only the plain chain's own compositions call them.
//
// They replace no TPU kernel: the reference runs this arithmetic as XLA on
// (lo, hi) u32 pairs (pplp_tpu/ops/modmath.py's m62). On the card the port
// ran it as int64 PyTorch ops, every 64 x 64-bit product built from 16- and
// 32-bit pieces (ops/modmath.py's mul32, _mul_words, _mulhi64): 10 to 200
// elementwise launches an op, ~4,100 in the BFV stages of one proximity
// test. Here an op is one launch, every value a u64 in registers and every
// 128-bit product two multiplies (the low word and __umul64hi).
//
// Results equal the plain chain's bit for bit, lazy ones included: each
// kernel runs the plain chain's formula on the same 64-bit patterns. The
// plain chain compares int64s, so the kernels compare as signed where a
// value could reach 2^63 (add, sub, the Barrett subtract); a Shoup
// companion is the u64 whose bit pattern the int64 holds.
//
//   m62_add          x + y, less q if that is >= q
//   m62_sub          x - y, plus q if that is < 0
//   m62_neg          q - x, 0 for x = 0
//   m62_shoup        w x - umul64hi(w', x) q, less q if >= q  (x < 2^63)
//   m62_mulmod       x y mod q by Barrett with floor(2^128 / q)
//   m62_reduce128    (z3 z2 z1 z0 in 32-bit words) mod q, the same Barrett
//   m62_shoup_pre    floor(w 2^64 / q) from floor(2^128 / q)
//
// Operands broadcast as PyTorch's do: the wrapper (ops/modmath_cuda.py)
// hands each operand's strides over the output's shape (0 on a broadcast
// dimension) after merging the dimensions every operand walks alike, and an
// operand that is a Python int as an immediate. So a per-limb constant
// [L, 1], a spectrum [L, n] and a batch [B, L, n] are read where they lie,
// with no expanded copy. floor(2^128 / q) comes as its three 32-bit words
// (ops/ntt.py's NttTables.mu_b), each an operand.
//
// What bounds them: bytes (at most four 8-byte reads and one write a residue
// for at most six multiplies), and at the BFV stages' sizes, [3, 5, 8192] at
// most, the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_block64.cuh"

namespace {

using pplp::csub64;
using pplp::shoup_lazy64;

constexpr int kThreads = 256;
constexpr int kMaxDims = 6;
constexpr int kMaxOperands = 8;
constexpr int64_t kMaxBlocks = 132 * 16;
// The grid-stride index is 32-bit: numel stays below 2^32 less one stride.
constexpr int64_t kMaxNumel = (int64_t{1} << 32) - kMaxBlocks * kThreads;

// The op codes, in ops/modmath_cuda.py's OPS order.
enum Op { kAdd, kSub, kNeg, kShoup, kMulmod, kReduce128, kShoupPre, kOpCount };

// Operands of each op, by op code (the wrapper's OPS gives their order):
// x, y, q (add, sub), x, q (neg), x, w, w', q (shoup), x, y, q, r0, r1, r2
// (mulmod), z0..z3, q, r0, r1, r2 (reduce128), w, q, r0, r1, r2 (shoup_pre).
__host__ __device__ constexpr int operand_count(int op) {
  constexpr int kOperands[kOpCount] = {3, 3, 2, 4, 6, 8, 5};
  return kOperands[op];
}

struct Args {
  uint64_t* out;
  const uint64_t* in[kMaxOperands];  // null: the operand is imm[k]
  uint64_t imm[kMaxOperands];
  int64_t stride[kMaxOperands][kMaxDims];  // in elements, over shape
  int64_t shape[kMaxDims];                 // the output's, row-major
  int64_t numel;
  int ndim;
};

__device__ __forceinline__ uint64_t csub_signed(uint64_t x, uint64_t m) {
  return static_cast<int64_t>(x) >= static_cast<int64_t>(m) ? x - m : x;
}

// floor(z r / 2^128) mod 2^64 for z = zh 2^64 + zl and r = rh 2^64 + rl:
// the third 64-bit word of the product, with the carries of the second.
__device__ __forceinline__ uint64_t barrett_estimate(uint64_t zl, uint64_t zh, uint64_t rl,
                                                     uint64_t rh) {
  const uint64_t b_lo = zl * rh, c_lo = zh * rl;
  uint64_t mid = __umul64hi(zl, rl) + b_lo;
  uint64_t carry = mid < b_lo;
  mid += c_lo;
  carry += mid < c_lo;
  return __umul64hi(zl, rh) + __umul64hi(zh, rl) + zh * rh + carry;
}

// z mod q for the 128-bit z: the estimate is floor(z / q) or one less, so
// z - est q lies in [0, 2q) and one conditional subtract ends it.
__device__ __forceinline__ uint64_t reduce128(uint64_t zl, uint64_t zh, uint64_t q,
                                              uint64_t rl, uint64_t rh) {
  return csub_signed(zl - barrett_estimate(zl, zh, rl, rh) * q, q);
}

// v: the operands of one residue, in the op's order.
template <int kOp>
__device__ __forceinline__ uint64_t apply(const uint64_t (&v)[kMaxOperands]) {
  if constexpr (kOp == kAdd) {
    return csub_signed(v[0] + v[1], v[2]);
  } else if constexpr (kOp == kSub) {
    const uint64_t d = v[0] - v[1];
    return static_cast<int64_t>(d) < 0 ? d + v[2] : d;
  } else if constexpr (kOp == kNeg) {
    return v[0] == 0 ? v[0] : v[1] - v[0];
  } else if constexpr (kOp == kShoup) {
    return csub64(shoup_lazy64(v[0], v[1], v[2], v[3]), v[3]);  // [0, 2q) < 2^63
  } else if constexpr (kOp == kMulmod) {
    return reduce128(v[0] * v[1], __umul64hi(v[0], v[1]), v[2], v[3] + (v[4] << 32), v[5]);
  } else if constexpr (kOp == kReduce128) {
    return reduce128(v[0] + (v[1] << 32), v[2] + (v[3] << 32), v[4], v[5] + (v[6] << 32),
                     v[7]);
  } else {  // kShoupPre: est = floor(w r / 2^64), the quotient or one less
    const uint64_t w = v[0], q = v[1], rl = v[2] + (v[3] << 32), rh = v[4];
    const uint64_t est = __umul64hi(w, rl) + w * rh;
    return static_cast<int64_t>(0 - est * q) >= static_cast<int64_t>(q) ? est + 1 : est;
  }
}

// One residue a thread, over a grid-stride loop: the output's index is
// split into its coordinates by 32-bit division and each operand read at
// its own strides.
template <int kOp>
__device__ __forceinline__ void elementwise(const Args& a) {
  constexpr int K = operand_count(kOp);
  const uint32_t numel = static_cast<uint32_t>(a.numel);
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < numel;
       i += gridDim.x * blockDim.x) {
    int64_t off[K] = {};
    uint32_t rest = i;
#pragma unroll
    for (int d = kMaxDims - 1; d >= 0; --d) {
      if (d >= a.ndim) continue;
      const uint32_t size = static_cast<uint32_t>(a.shape[d]);
      const uint32_t c = rest % size;
      rest /= size;
#pragma unroll
      for (int k = 0; k < K; ++k) off[k] += static_cast<int64_t>(c) * a.stride[k][d];
    }
    uint64_t v[kMaxOperands];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = a.in[k] ? pplp::ldg64(a.in[k] + off[k]) : a.imm[k];
    a.out[i] = apply<kOp>(v);
  }
}

#define PPLP_M62_KERNEL(name, op)                                       \
  __global__ void __launch_bounds__(kThreads) m62_##name(const Args a) { \
    elementwise<op>(a);                                                 \
  }

PPLP_M62_KERNEL(add, kAdd)
PPLP_M62_KERNEL(sub, kSub)
PPLP_M62_KERNEL(neg, kNeg)
PPLP_M62_KERNEL(shoup, kShoup)
PPLP_M62_KERNEL(mulmod, kMulmod)
PPLP_M62_KERNEL(reduce128, kReduce128)
PPLP_M62_KERNEL(shoup_pre, kShoupPre)

#undef PPLP_M62_KERNEL

void launch(int op, const Args& a, int blocks, cudaStream_t s) {
  switch (op) {
    case kAdd: m62_add<<<blocks, kThreads, 0, s>>>(a); break;
    case kSub: m62_sub<<<blocks, kThreads, 0, s>>>(a); break;
    case kNeg: m62_neg<<<blocks, kThreads, 0, s>>>(a); break;
    case kShoup: m62_shoup<<<blocks, kThreads, 0, s>>>(a); break;
    case kMulmod: m62_mulmod<<<blocks, kThreads, 0, s>>>(a); break;
    case kReduce128: m62_reduce128<<<blocks, kThreads, 0, s>>>(a); break;
    default: m62_shoup_pre<<<blocks, kThreads, 0, s>>>(a); break;
  }
}

}  // namespace

extern "C" {

// One launch of op's kernel into out (int64, contiguous, the layout's
// numel). in0..in7: the operands' device pointers in the op's order (null:
// an immediate, or an operand the op does not take). layout: host int64
// [numel, ndim, shape[ndim], then per operand of the op: its immediate and
// its strides[ndim]]. Returns the launch's error code (0 = success) or
// cudaErrorInvalidValue for a layout it does not take (numel of kMaxNumel
// or more among them).
int pplp_m62_elementwise(int op, void* out, const void* in0, const void* in1, const void* in2,
                         const void* in3, const void* in4, const void* in5, const void* in6,
                         const void* in7, const void* layout, void* stream) {
  const auto* l = static_cast<const int64_t*>(layout);
  Args a = {};
  a.numel = l[0];
  a.ndim = static_cast<int>(l[1]);
  if (op < 0 || op >= kOpCount || a.numel < 1 || a.numel >= kMaxNumel || a.ndim < 1 ||
      a.ndim > kMaxDims)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < a.ndim; ++d) a.shape[d] = l[2 + d];
  const void* in[kMaxOperands] = {in0, in1, in2, in3, in4, in5, in6, in7};
  const int64_t* p = l + 2 + a.ndim;
  for (int k = 0; k < operand_count(op); ++k, p += 1 + a.ndim) {
    a.in[k] = static_cast<const uint64_t*>(in[k]);
    a.imm[k] = static_cast<uint64_t>(p[0]);
    for (int d = 0; d < a.ndim; ++d) a.stride[k][d] = p[1 + d];
  }
  a.out = static_cast<uint64_t*>(out);
  const int64_t want = (a.numel + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const auto s = static_cast<cudaStream_t>(stream);
  launch(op, a, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
