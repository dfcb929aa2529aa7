// Double-single ("df64") arithmetic on pairs of float32: the device side of
// blingfire_tpu_torch/ops/dfloat.py, replacing blingfire_tpu/ops/dfloat.py
// (two_sum, df_add, df_lt at dfloat.py:14-31).
//
// The operations and their order are those of dfloat.py, each rounded to
// nearest by an explicit intrinsic (__fadd_rn / __fsub_rn), so that neither
// contraction nor reassociation can change a bit: the Viterbi DP picks its
// winner by comparing these pairs, and one differently rounded sum flips a
// decision.  Build without --use_fast_math.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& err) {
    s = __fadd_rn(a, b);
    const float bb = __fsub_rn(s, a);
    err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// (hi, lo) + f -> normalized (hi2, lo2)
__device__ __forceinline__ void df_add(float hi, float lo, float f, float& hi2,
                                       float& lo2) {
    float s, e;
    two_sum(hi, f, s, e);
    e = __fadd_rn(e, lo);
    two_sum(s, e, hi2, lo2);
}

// a < b for df64 pairs (no short circuit: a select, not a branch)
__device__ __forceinline__ bool df_lt(float a_hi, float a_lo, float b_hi,
                                      float b_lo) {
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo));
}
