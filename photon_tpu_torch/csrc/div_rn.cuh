// Division by a divisor that many quotients share, with the IEEE quotient's
// bits.
//
// Given inv_b = RN(1 / b), the correctly rounded f32 reciprocal, the sequence
//   q = RN(a inv_b),  e = RN(a - q b),  RN(q + e inv_b)
// returns RN(a / b), what the IEEE division a / b returns, whenever q is
// within an ulp of a / b: the remainder a - q b is then exact and one
// correction rounds correctly (Markstein's theorem; P. Markstein, IBM J. Res.
// Dev. 34(1), 1990).  q = RN(a inv_b) is not always within an ulp, so that is
// no proof for every divisor.  What holds is what tests/test_torch_division.py
// shows: for each divisor of the bench scene, all 2^23 numerator
// significands, emulated exactly, give the division's bits, and so does every
// numerator whose quotient and remainder stay normal numbers (a power of two
// scales all of it exactly).  An infinite a gives NaN where the division
// gives inf.  It is a product and two FMAs; nvcc's IEEE division is a
// reciprocal, its refinement, the same correction, a range check and its
// branch.  The rounding intrinsics keep the sequence as written whether or
// not the file is built with FMA contraction.
#pragma once
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float div_rn_by(float a, float b, float inv_b) {
  const float q = __fmul_rn(a, inv_b);
  return __fmaf_rn(__fmaf_rn(-q, b, a), inv_b, q);
}

}  // namespace
