// The packed proximity step's elementwise work for Hopper (sm_90a): the
// combine in the NTT domain between the forward and the inverse transforms,
// and the BEHZ decode after the inverse.
//
// They replace no TPU kernel: the reference leaves this chain to XLA, which
// fuses it (pplp_tpu/parallel/pipeline.py's step, pplp_tpu/bfv/
// rns_decrypt.py's decode_mod_t). On the card the port ran it as ~195
// PyTorch int64 elementwise launches a step, each a full pass over a
// [rows, L, n] int64 tensor, and every m31 Shoup product went through
// 16-bit halves (ops/modmath.py's mul32). Here each residue is a u32 word
// in registers and every product is a Shoup product by __umulhi.
//
// pipe_combine_kernel: per residue of the six u32 spectra (ntt_cuda's
//   forward_u32 of c1, c2, c3's two polynomials), with the plaintext
//   spectra of xb, yb, s, the secret key's spectrum and the spectra of the
//   two additive terms z and s r (the transforms are linear and every value
//   is canonical, so adding a term's spectrum equals transforming the sum):
//     acc0 = (c1_0 + z) - (xb c2_0 + yb c3_0)
//     acc1 = c1_1 - (xb c2_1 + yb c3_1)
//     val  = s acc0 + (s acc1) sk + s r
//   written once, canonical, as u32 (for ntt_cuda.inverse_u32) or int64
//   (for ntt_cuda.inverse). A thread owns four neighbouring residues of a
//   (limb, coefficient) quad, holds that quad's ten constant words in
//   registers and walks kRowsPerThread rows of the batch.
// pipe_decode_kernel: per coefficient of x = c0 + c1 s (u32 or int64
//   residues [rows, L, n]), over its L limbs: y_i = x_i (gamma t qhat_i^-1)
//   mod q_i, the two sums of y_i c[i] mod t and mod gamma, the centred-gamma
//   correction and the product by gamma^-1 mod t; the blind distance is
//   written as int64 [rows, n] (what bf_probe takes).
//
// What bounds them: bytes. The combine reads 24 B (six spectra) and writes
// 4 B a residue for 7 Shoup products (21 multiplies): 0.75 multiplies a
// byte, where the H100's integer-multiply peak over its 3.35 TB/s is ~5.
// The decode reads 4 B a residue and writes 8 B a coefficient. So both
// read every input once in 16-byte (combine) or coalesced 4-byte (decode)
// loads, keep every intermediate in registers and write every output once.
// Every value that leaves a kernel is the canonical residue the plain torch
// chain gives, bit for bit; the numpy model in
// tests/test_torch_pipeline_words.py follows these kernels op for op.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
// The constant planes of the combine, each u32 [L, n].
constexpr int kPlanes = 10;
enum Plane { kZ, kSr, kXb, kXbS, kYb, kYbS, kS, kSS, kSk, kSkS };
// The words of a limb in the decode's table, u32 [L, kLimbWords].
constexpr int kLimbWords = 7;
enum LimbWord { kQ, kY, kYS, kCt, kCtS, kCg, kCgS };

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t q) { return x >= q ? x - q : x; }

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  return csub(a + b, q);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// x w mod q, canonical, for any x < 2^32, w < q < 2^31 and ws = floor(w 2^32 / q):
// the estimate is the quotient or one less, so the wrapped difference is
// the true value in [0, 2q).
__device__ __forceinline__ uint32_t mul_shoup(uint32_t x, uint32_t w, uint32_t ws, uint32_t q) {
  return csub(w * x - __umulhi(ws, x) * q, q);
}

__device__ __forceinline__ uint32_t combine1(uint32_t c10, uint32_t c20, uint32_t c30,
                                             uint32_t c11, uint32_t c21, uint32_t c31,
                                             const uint32_t* k, uint32_t q) {
  const uint32_t acc0 =
      sub_mod(add_mod(c10, k[kZ], q),
              add_mod(mul_shoup(c20, k[kXb], k[kXbS], q), mul_shoup(c30, k[kYb], k[kYbS], q), q),
              q);
  const uint32_t acc1 =
      sub_mod(c11,
              add_mod(mul_shoup(c21, k[kXb], k[kXbS], q), mul_shoup(c31, k[kYb], k[kYbS], q), q),
              q);
  const uint32_t val = add_mod(mul_shoup(acc0, k[kS], k[kSS], q),
                               mul_shoup(mul_shoup(acc1, k[kS], k[kSS], q), k[kSk], k[kSkS], q),
                               q);
  return add_mod(val, k[kSr], q);
}

__device__ __forceinline__ uint32_t lane(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// spec: u32 [6, rows, L, n], the spectra of (c1_0, c2_0, c3_0, c1_1, c2_1,
// c3_1); consts: u32 [kPlanes, L, n]; q: u32 [L]; out: u32 or int64
// [rows, L, n]. quads = L n / 4, quad_log = log2(n / 4).
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    pipe_combine_kernel(const uint4* __restrict__ spec, const uint4* __restrict__ consts,
                        const uint32_t* __restrict__ q, void* __restrict__ out, int rows,
                        int quads, int quad_log) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= quads) return;
  const uint32_t m = __ldg(q + (c >> quad_log));
  uint32_t k[kPlanes][4];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const uint4 v = __ldg(consts + static_cast<size_t>(p) * quads + c);
    k[p][0] = v.x;
    k[p][1] = v.y;
    k[p][2] = v.z;
    k[p][3] = v.w;
  }
  const size_t plane = static_cast<size_t>(rows) * quads;
  const int r0 = blockIdx.y * kRowsPerThread;
  const int r1 = min(rows, r0 + kRowsPerThread);
  for (int r = r0; r < r1; ++r) {
    const size_t e = static_cast<size_t>(r) * quads + c;
    uint4 s[6];
#pragma unroll
    for (int p = 0; p < 6; ++p) s[p] = __ldcs(spec + p * plane + e);
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t ki[kPlanes] = {k[0][i], k[1][i], k[2][i], k[3][i], k[4][i],
                                    k[5][i], k[6][i], k[7][i], k[8][i], k[9][i]};
      v[i] = combine1(lane(s[0], i), lane(s[1], i), lane(s[2], i), lane(s[3], i),
                      lane(s[4], i), lane(s[5], i), ki, m);
    }
    if (kWide) {
      auto* o = static_cast<longlong2*>(out) + 2 * e;
      o[0] = make_longlong2(v[0], v[1]);
      o[1] = make_longlong2(v[2], v[3]);
    } else {
      static_cast<uint4*>(out)[e] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// x: u32 or int64 [count / n, L, n]; limbs: u32 [L, kLimbWords]; out: int64
// [count / n, n]. One thread a coefficient.
template <bool kInU32>
__global__ void __launch_bounds__(kThreads)
    pipe_decode_kernel(const void* __restrict__ x, const uint32_t* __restrict__ limbs,
                       int64_t* __restrict__ out, int64_t count, int L, int n, uint32_t t,
                       uint32_t gamma, uint32_t gamma_mod_t, uint32_t inv_gamma,
                       uint32_t inv_gamma_shoup) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= count) return;
  const int64_t row = i / n;
  const int64_t base = row * L * n + (i - row * n);
  uint32_t st = 0, sg = 0;
  for (int l = 0; l < L; ++l) {
    const uint32_t* w = limbs + l * kLimbWords;
    const int64_t e = base + static_cast<int64_t>(l) * n;
    const uint32_t v = kInU32 ? __ldcs(static_cast<const uint32_t*>(x) + e)
                              : static_cast<uint32_t>(__ldcs(static_cast<const long long*>(x) + e));
    const uint32_t y = mul_shoup(v, __ldg(w + kY), __ldg(w + kYS), __ldg(w + kQ));
    st = add_mod(st, mul_shoup(y, __ldg(w + kCt), __ldg(w + kCtS), t), t);
    sg = add_mod(sg, mul_shoup(y, __ldg(w + kCg), __ldg(w + kCgS), gamma), gamma);
  }
  uint32_t d = sub_mod(st, sg % t, t);
  if (sg > gamma / 2) d = add_mod(d, gamma_mod_t, t);
  out[i] = mul_shoup(d, inv_gamma, inv_gamma_shoup, t);
}

}  // namespace

extern "C" {

// Each entry point returns the launch's error code (0 = success) or
// cudaErrorInvalidValue for a shape it does not take. Every tensor is
// contiguous and 16-byte aligned.

// spec: u32 [6, rows, L, n]; consts: u32 [10, L, n]; q: u32 [L]; out: u32
// (wide 0) or int64 (wide 1) [rows, L, n]; n a power of two >= 4.
int pplp_pipe_combine(const void* spec, const void* consts, const void* q, void* out, int wide,
                      int rows, int L, int logn, void* stream) {
  if (rows < 1 || L < 1 || logn < 2 || logn > 20) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t quads = static_cast<int64_t>(L) << (logn - 2);
  const int64_t row_blocks = (rows + kRowsPerThread - 1) / kRowsPerThread;
  if (quads >= (1LL << 31) || row_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((quads + kThreads - 1) / kThreads),
                  static_cast<unsigned>(row_blocks));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const uint4*>(spec);
  const auto* k = static_cast<const uint4*>(consts);
  const auto* qq = static_cast<const uint32_t*>(q);
  if (wide)
    pipe_combine_kernel<true><<<grid, kThreads, 0, s>>>(sp, k, qq, out, rows,
                                                        static_cast<int>(quads), logn - 2);
  else
    pipe_combine_kernel<false><<<grid, kThreads, 0, s>>>(sp, k, qq, out, rows,
                                                         static_cast<int>(quads), logn - 2);
  return static_cast<int>(cudaGetLastError());
}

// x: u32 (in_u32 1) or int64 [count / n, L, n]; limbs: u32 [L, 7] (q, the
// y multiplier and its companion, c_t and its companion mod t, c_gamma and
// its companion mod gamma); out: int64 [count / n, n]; t, gamma < 2^30.
int pplp_pipe_decode(const void* x, int in_u32, const void* limbs, void* out, long long count,
                     int L, int n, unsigned t, unsigned gamma, unsigned gamma_mod_t,
                     unsigned inv_gamma, unsigned inv_gamma_shoup, void* stream) {
  if (count < 1 || L < 1 || n < 1 || count % n || t < 2 || t >= (1u << 30) || gamma < 2 ||
      gamma >= (1u << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(limbs);
  auto* o = static_cast<int64_t*>(out);
  if (in_u32)
    pipe_decode_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        x, w, o, count, L, n, t, gamma, gamma_mod_t, inv_gamma, inv_gamma_shoup);
  else
    pipe_decode_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        x, w, o, count, L, n, t, gamma, gamma_mod_t, inv_gamma, inv_gamma_shoup);
  return static_cast<int>(cudaGetLastError());
}

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
