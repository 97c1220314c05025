// Chained Shoup modular multiplications for Hopper (sm_90a): the port's
// integer-throughput probe.
//
// Replaces the Pallas kernel scripts/gated_profile.py::build_prim (16 chained
// m31 Shoup mulmods by one scalar constant over u32 [256, 4, 4096]). Each
// thread takes residues in a grid-stride loop, narrows the int64 residue to
// u32 and applies y = y * w mod q `steps` times, as
// w y - umulhi(w', y) q in wrapping u32 followed by one conditional
// subtract (canonical for any y < 2^32), then writes canonical int64.
//
// What bounds it: at 16 steps, 3 integer multiplies and a compare-subtract
// per step against 16 bytes of int64 traffic per residue, the chain sits
// near the balance point of the H100's integer pipes and its memory; more
// steps make it compute-bound, which is what the probe is for.
//
// pplp_mad_probe, beside it, measures the multiply slot of a 32 x 32 -> 64
// bit multiply-add, the unit the DGK bounds count: every thread runs
// kMadChains independent chains acc <- lo(acc) c + acc, either as one
// mad.wide.u32 (SASS IMAD.WIDE.U32) or as the pair mad.lo.u32 +
// mad.hi.u32 (IMAD + IMAD.HI.U32) on the two halves, `steps` times; no
// memory traffic but one word a thread at the end.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void mulmod_chain_kernel(const int64_t* __restrict__ x,
                                    int64_t* __restrict__ y, int64_t count,
                                    uint32_t w, uint32_t w_shoup, uint32_t q,
                                    int steps) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    uint32_t v = static_cast<uint32_t>(x[i]);
#pragma unroll 16
    for (int s = 0; s < steps; ++s) {
      const uint32_t r = w * v - __umulhi(w_shoup, v) * q;
      v = r >= q ? r - q : r;
    }
    y[i] = v;
  }
}

constexpr int kMadChains = 8;

template <bool kWide>
__global__ void __launch_bounds__(256) mad_probe_kernel(uint32_t* __restrict__ out, int steps,
                                                        uint32_t c) {
  uint32_t lo[kMadChains], hi[kMadChains];
#pragma unroll
  for (int k = 0; k < kMadChains; ++k) {
    lo[k] = blockIdx.x * blockDim.x + threadIdx.x + k;
    hi[k] = k;
  }
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int k = 0; k < kMadChains; ++k) {
      if (kWide) {
        uint64_t acc = (static_cast<uint64_t>(hi[k]) << 32) | lo[k];
        asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(acc) : "r"(lo[k]), "r"(c));
        lo[k] = static_cast<uint32_t>(acc);
        hi[k] = static_cast<uint32_t>(acc >> 32);
      } else {
        uint32_t l2, h2;
        asm volatile("mad.lo.u32 %0, %1, %2, %3;" : "=r"(l2) : "r"(lo[k]), "r"(c), "r"(lo[k]));
        asm volatile("mad.hi.u32 %0, %1, %2, %3;" : "=r"(h2) : "r"(lo[k]), "r"(c), "r"(hi[k]));
        lo[k] = l2;
        hi[k] = h2;
      }
    }
  }
  uint32_t x = 0;
#pragma unroll
  for (int k = 0; k < kMadChains; ++k) x ^= lo[k] ^ hi[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
}

}  // namespace

extern "C" {

// x, y: contiguous int64 [count]; returns cudaGetLastError() after the launch.
int pplp_mulmod_chain(const void* x, void* y, long long count, unsigned w,
                      unsigned w_shoup, unsigned q, int steps, void* stream) {
  if (count <= 0 || steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int threads = 256;
  int64_t blocks = (count + threads - 1) / threads;
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  mulmod_chain_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(x), static_cast<int64_t*>(y), count, w, w_shoup, q,
      steps);
  return static_cast<int>(cudaGetLastError());
}

// out: int32 [blocks * 256] on the device; wide 1: mad.wide.u32, 0: the
// lo/hi pair. Each thread runs 8 chains of `steps` multiply-adds.
int pplp_mad_probe(void* out, int wide, int steps, int blocks, void* stream) {
  if (steps < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint32_t*>(out);
  if (wide)
    mad_probe_kernel<true><<<blocks, 256, 0, s>>>(o, steps, 0x9E3779B1u);
  else
    mad_probe_kernel<false><<<blocks, 256, 0, s>>>(o, steps, 0x9E3779B1u);
  return static_cast<int>(cudaGetLastError());
}

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
