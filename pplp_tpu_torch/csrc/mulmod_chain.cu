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

const char* pplp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
