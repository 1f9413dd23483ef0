// Standalone quantize: u8 = clip(round_half_even(x), 0, 255), elementwise.
//
// Replaces the Pallas TPU kernel _pallas_quantize_u8
// (downloader_tpu/compute/ops/pixel_shuffle.py:75-106, pallas_call at :98),
// which worked on a (rows, cols) view in 8-row blocks because Mosaic tiles
// by (8, 128) sublanes x lanes and needs the last dim % 128 == 0.  None of
// that carries over: here the tensor is a flat run of n elements, any n.
//
// Bound on an H100: bytes.  It reads 4 (f32) or 2 (bf16) bytes and writes
// 1 byte per element and does ~4 operations on them, far below the ~295
// operations per byte where the card turns compute-bound.  So the design
// only has to keep the memory system busy: each thread moves 4 elements
// with one 16-byte (f32) or 8-byte (bf16) load and one 4-byte store, and
// neighbouring threads touch neighbouring addresses, so every warp access
// is fully coalesced.  A scalar kernel takes the ragged tail (n % 4) and
// any input that is not aligned for the vector loads.
//
// The C entry launches on the caller's stream, never synchronises, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;  // grid-stride beyond this

__global__ void quantize_f32_vec4(const float4* __restrict__ in,
                                  uchar4* __restrict__ out, long long n4) {
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n4; i += stride) {
        float4 v = in[i];
        out[i] = make_uchar4(quantize_u8_value(v.x), quantize_u8_value(v.y),
                             quantize_u8_value(v.z), quantize_u8_value(v.w));
    }
}

// four bf16 per 8-byte load; element 0 is the low half of .x (little endian)
__global__ void quantize_bf16_vec4(const uint2* __restrict__ in,
                                   uchar4* __restrict__ out, long long n4) {
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n4; i += stride) {
        uint2 v = in[i];
        out[i] = make_uchar4(
            quantize_u8_value(bf16_bits_to_f32(v.x & 0xffffu)),
            quantize_u8_value(bf16_bits_to_f32(v.x >> 16)),
            quantize_u8_value(bf16_bits_to_f32(v.y & 0xffffu)),
            quantize_u8_value(bf16_bits_to_f32(v.y >> 16)));
    }
}

__global__ void quantize_f32_scalar(const float* __restrict__ in,
                                    unsigned char* __restrict__ out,
                                    long long begin, long long n) {
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = begin + (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        out[i] = quantize_u8_value(in[i]);
    }
}

__global__ void quantize_bf16_scalar(const unsigned short* __restrict__ in,
                                     unsigned char* __restrict__ out,
                                     long long begin, long long n) {
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = begin + (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        out[i] = quantize_u8_value(bf16_bits_to_f32(in[i]));
    }
}

unsigned int blocks_for(long long work) {
    long long blocks = (work + kThreads - 1) / kThreads;
    return (unsigned int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// in: n contiguous f32 (is_bf16 == 0) or bf16 (is_bf16 != 0) values;
// out: n u8.  n == 0 launches nothing.
extern "C" int quantize_u8_launch(const void* in, void* out, long long n,
                                  int is_bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const uintptr_t in_align = is_bf16 ? 8 : 16;
    const bool vec = ((uintptr_t)in % in_align == 0) && ((uintptr_t)out % 4 == 0);
    const long long n4 = vec ? n / 4 : 0;
    if (n4 > 0) {
        if (is_bf16) {
            quantize_bf16_vec4<<<blocks_for(n4), kThreads, 0, s>>>(
                (const uint2*)in, (uchar4*)out, n4);
        } else {
            quantize_f32_vec4<<<blocks_for(n4), kThreads, 0, s>>>(
                (const float4*)in, (uchar4*)out, n4);
        }
    }
    const long long begin = 4 * n4;
    if (n > begin) {
        if (is_bf16) {
            quantize_bf16_scalar<<<blocks_for(n - begin), kThreads, 0, s>>>(
                (const unsigned short*)in, (unsigned char*)out, begin, n);
        } else {
            quantize_f32_scalar<<<blocks_for(n - begin), kThreads, 0, s>>>(
                (const float*)in, (unsigned char*)out, begin, n);
        }
    }
    return (int)cudaGetLastError();
}
