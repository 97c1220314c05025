// The limb row of the DGK group product (csrc/dgk_mont.cu): one thread's
// slice of L 32-bit limbs. A header of its own so that a probe
// (measure_dgk --parts sass) compiles mad_row alone and counts the SASS
// instructions of its limb products against another form.

#pragma once

#include <cstdint>

namespace pplp_dgk {

// t += a b over one slice; returns the word carried out of its top. One
// u64 multiply-add a limb (IMAD.WIDE.U32, then the carry in by IADD3 and
// IADD3.X): 3.08 SASS instructions a limb product at L = 13, against 4.31
// for two PTX carry chains (mad.lo.cc / madc.hi.cc, which ptxas writes as
// IMAD, IMAD.HI.U32 and IADD3.X); measure_dgk --parts sass counts both.
template <int L>
__device__ __forceinline__ uint32_t mad_row(uint32_t (&t)[L], uint32_t a,
                                            const uint32_t (&b)[L]) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t s = static_cast<uint64_t>(a) * b[j] + t[j] + c;
    t[j] = static_cast<uint32_t>(s);
    c = static_cast<uint32_t>(s >> 32);
  }
  return c;
}

}  // namespace pplp_dgk
