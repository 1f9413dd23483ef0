// Shared device helpers of the quantize tail: the one place the u8
// rounding rule lives, included by quantize_u8.cu (standalone) and
// s2d_tail.cu (inline).
#pragma once

// clip(round(x), 0, 255) -> u8 with jnp.round's semantics: rintf rounds
// half to even under the default rounding mode.  roundf would round .5
// away from zero and break every tie that the reference sends to even.
// fmaxf/fminf clamp before the cast, so out-of-range values (and inf)
// saturate instead of wrapping.
__device__ __forceinline__ unsigned char quantize_u8_value(float x) {
    return (unsigned char)fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

// bfloat16 bits -> float32: bf16 is the top half of an f32, so this is
// exact and needs no cuda_bf16.h conversion intrinsic.
__device__ __forceinline__ float bf16_bits_to_f32(unsigned int bits16) {
    return __uint_as_float(bits16 << 16);
}
