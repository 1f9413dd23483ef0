// The s2d sub-pixel tail: packed head output -> u8 luma at 2x and u8
// 4:2:0 chroma, in one pass.
//
// Replaces the reference's fused_subpixel_ycc_s2d
// (downloader_tpu/compute/ops/colorspace.py:171-211), which XLA compiled
// around the Pallas quantize kernel _pallas_quantize_u8
// (downloader_tpu/compute/ops/pixel_shuffle.py:75-106, pallas_call at :98).
// All three quantizes run inline here through quantize.cuh, the same
// device function as the standalone kernel in quantize_u8.cu, so no f32
// intermediate ever reaches memory.
//
// Input: packed (B, H/2, W/2, 48) bf16.  Channel block g = di*2+dj holds
// the 12 sub-pixel values of full-res position (2i+di, 2j+dj): sub-pixel
// s = si*2+sj, rgb c at g*12 + s*3 + c.  The reference's two-level
// shuffle (s2d block, then sub-pixel) reduces to: one thread for each
// full-res position (b, y, x), i.e. each output chroma pixel, reading
// block g = (y%2)*2 + (x%2) of packed[b, y/2, x/2] and writing
//   luma   Y[b, 2y+si, 2x+sj]   from sub-pixel s = si*2+sj,
//   chroma C[0|1, b, y, x]      (Cb | Cr) from the mean of the 4 rgb triples.
//
// Arithmetic, exactly the reference's order on XLA's CPU lowering, so the
// plain PyTorch version (ops/colorspace.py) and this kernel agree byte
// for byte: bf16 -> f32 first; each 3-wide contraction is
// fma(x2, w2, fma(x1, w1, x0*w0)); the mean sums the 4 sub-pixels left to
// right, then scales by 1/4 (exact); chroma adds 128 as its own rounding.
// Every step is an explicit _rn intrinsic so nvcc cannot contract or
// reorder it.
//
// Bound on an H100: bytes.  Per chroma pixel it reads 24 bytes and writes
// 4 + 2 bytes for ~44 flops.  The block is 32 x 8 threads over (x, y):
// a warp reads 16 packed pixels' worth of neighbouring 24-byte runs with
// 8-byte loads, and rows y and y+1, which share each packed pixel's
// 96 bytes, sit in the same block, so the half a warp skips is an L1/L2
// hit for its neighbour.  Stores are 2-byte luma pairs and u8 chroma,
// coalesced along x.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quantize.cuh"

struct TailCoeffs {
    float y[3];   // 255 * RGB->Y row
    float cb[3];  // 255 * RGB->Cb row
    float cr[3];  // 255 * RGB->Cr row
};

namespace {

__device__ __forceinline__ float contract3(float x0, float x1, float x2,
                                           const float w[3]) {
    return __fmaf_rn(x2, w[2], __fmaf_rn(x1, w[1], __fmul_rn(x0, w[0])));
}

__global__ void __launch_bounds__(256)
s2d_tail_kernel(const unsigned short* __restrict__ packed,
                unsigned char* __restrict__ luma, unsigned char* __restrict__ chroma,
                int height, int width, long long plane, TailCoeffs k) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const long long b = blockIdx.z;
    if (x >= width || y >= height) return;

    const int g = (y & 1) * 2 + (x & 1);
    const long long pix = (b * (height / 2) + (y >> 1)) * (width / 2) + (x >> 1);
    // 12 bf16 = 24 bytes at an 8-byte-aligned offset (96 * pix + 24 * g)
    const uint2* src = reinterpret_cast<const uint2*>(packed + pix * 48 + g * 12);
    const uint2 w0 = src[0], w1 = src[1], w2 = src[2];
    const unsigned int words[6] = {w0.x, w0.y, w1.x, w1.y, w2.x, w2.y};
    float v[12];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        v[2 * i] = bf16_bits_to_f32(words[i] & 0xffffu);
        v[2 * i + 1] = bf16_bits_to_f32(words[i] >> 16);
    }

    unsigned char q[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        q[s] = quantize_u8_value(contract3(v[3 * s], v[3 * s + 1], v[3 * s + 2], k.y));
    }
    const long long luma_w = 2LL * width;
    const long long row0 = (b * 2 * height + 2LL * y) * luma_w + 2LL * x;
    *reinterpret_cast<uchar2*>(luma + row0) = make_uchar2(q[0], q[1]);
    *reinterpret_cast<uchar2*>(luma + row0 + luma_w) = make_uchar2(q[2], q[3]);

    float mean[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float sum = __fadd_rn(__fadd_rn(__fadd_rn(v[c], v[3 + c]), v[6 + c]), v[9 + c]);
        mean[c] = __fmul_rn(sum, 0.25f);
    }
    const long long at = (b * height + y) * (long long)width + x;
    chroma[at] = quantize_u8_value(
        __fadd_rn(contract3(mean[0], mean[1], mean[2], k.cb), 128.0f));
    chroma[plane + at] = quantize_u8_value(
        __fadd_rn(contract3(mean[0], mean[1], mean[2], k.cr), 128.0f));
}

}  // namespace

// packed: (batch, height/2, width/2, 48) bf16, contiguous, 8-byte aligned;
// luma: (batch, 2*height, 2*width) u8; chroma: (2, batch, height, width) u8.
// height and width are the full-res input dims (both even); batch <= 65535.
extern "C" int s2d_tail_launch(const void* packed, void* luma, void* chroma,
                               int batch, int height, int width,
                               TailCoeffs coeffs, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((width + block.x - 1) / block.x,
                    (height + block.y - 1) / block.y, batch);
    s2d_tail_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const unsigned short*)packed, (unsigned char*)luma, (unsigned char*)chroma,
        height, width, (long long)batch * height * width, coeffs);
    return (int)cudaGetLastError();
}
