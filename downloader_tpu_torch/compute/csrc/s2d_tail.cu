// The s2d sub-pixel tail: packed head output -> u8 luma at scale x and
// u8 chroma at the input size, in one pass, at any scale r >= 1.
//
// Replaces the reference's fused_subpixel_ycc_s2d
// (downloader_tpu/compute/ops/colorspace.py:171-211), which XLA compiled
// around the Pallas quantize kernel _pallas_quantize_u8
// (downloader_tpu/compute/ops/pixel_shuffle.py:75-106, pallas_call at :98).
// All three quantizes run inline here through quantize.cuh, the same
// device function as the standalone kernel in quantize_u8.cu, so no f32
// intermediate ever reaches memory.
//
// Input: packed (B, H/2, W/2, 4*r*r*3) bf16.  Channel block g = di*2+dj
// holds the 3*r*r sub-pixel values of full-res position (2i+di, 2j+dj):
// sub-pixel s = si*r+sj, rgb c at g*3r^2 + s*3 + c.  The reference's
// two-level shuffle (s2d block, then sub-pixel) reduces to: one thread for
// each full-res position (b, y, x), i.e. each output chroma pixel, reading
// block g = (y%2)*2 + (x%2) of packed[b, y/2, x/2] and writing
//   luma   Y[b, y*r+si, x*r+sj]  from sub-pixel s = si*r+sj,
//   chroma C[0|1, b, y, x]       (Cb | Cr) from the mean of the r*r rgb
//                                triples.
//
// Arithmetic, exactly the reference's order on XLA's CPU lowering, so the
// plain PyTorch version (ops/colorspace.py) and this kernel agree byte
// for byte: bf16 -> f32 first; each 3-wide contraction is
// fma(x2, w2, fma(x1, w1, x0*w0)); the mean sums the r*r sub-pixels left
// to right, then multiplies by f32(1/(r*r)) (given by the caller: XLA
// multiplies, it does not divide); chroma adds 128 as its own rounding.
// Every step is an explicit _rn intrinsic so nvcc cannot contract or
// reorder it.  Scales 1-4 are compiled with r fixed, so a block's values
// sit in registers; larger scales take a loop with r at run time.
//
// Bound on an H100: bytes.  Per chroma pixel it reads 6*r^2 bytes and
// writes r^2 + 2 for ~(5r^2 + 4r^2 + 12) flops.  The block is 32 x 8
// threads over (x, y): a warp reads 16 packed pixels' worth of
// neighbouring blocks, and rows y and y+1, which share each packed
// pixel, sit in the same block, so the half a warp skips is an L1/L2 hit
// for its neighbour.  A block's loads are as wide as its alignment allows
// (6*r^2 bytes at a multiple of 6*r^2: 8 bytes at r = 2, 16 at r = 4, 2
// at odd r).  One thread per packed pixel, handling all four blocks with
// 16-byte loads, ran 3.8% slower at r = 2 on an H100 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quantize.cuh"

// 1: the scales above with r fixed at compile time; 0: every scale through
// the run-time loop (chip_smoke.py builds that to time the two apart)
#ifndef S2D_TAIL_FIXED_SCALES
#define S2D_TAIL_FIXED_SCALES 1
#endif

struct TailCoeffs {
    float y[3];   // 255 * RGB->Y row
    float cb[3];  // 255 * RGB->Cb row
    float cr[3];  // 255 * RGB->Cr row
};

namespace {

constexpr int kBlockX = 32, kBlockY = 8;

__device__ __forceinline__ float contract3(float x0, float x1, float x2,
                                           const float w[3]) {
    return __fmaf_rn(x2, w[2], __fmaf_rn(x1, w[1], __fmul_rn(x0, w[0])));
}

__device__ __forceinline__ unsigned char chroma_u8(float mr, float mg, float mb,
                                                   const float w[3]) {
    return quantize_u8_value(__fadd_rn(contract3(mr, mg, mb, w), 128.0f));
}

// the 3*R*R values of one s2d block as f32, by the widest load the
// block's alignment allows
template <int R>
__device__ __forceinline__ void load_block(const unsigned short* src, float (&v)[3 * R * R]) {
    constexpr int kVals = 3 * R * R;
    if constexpr ((2 * kVals) % 16 == 0) {
#pragma unroll
        for (int e = 0; e < kVals / 8; ++e) {
            const uint4 w = reinterpret_cast<const uint4*>(src)[e];
            const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                v[8 * e + 2 * i] = bf16_bits_to_f32(words[i] & 0xffffu);
                v[8 * e + 2 * i + 1] = bf16_bits_to_f32(words[i] >> 16);
            }
        }
    } else if constexpr ((2 * kVals) % 8 == 0) {
#pragma unroll
        for (int e = 0; e < kVals / 4; ++e) {
            const uint2 w = reinterpret_cast<const uint2*>(src)[e];
            v[4 * e] = bf16_bits_to_f32(w.x & 0xffffu);
            v[4 * e + 1] = bf16_bits_to_f32(w.x >> 16);
            v[4 * e + 2] = bf16_bits_to_f32(w.y & 0xffffu);
            v[4 * e + 3] = bf16_bits_to_f32(w.y >> 16);
        }
    } else {
#pragma unroll
        for (int i = 0; i < kVals; ++i) v[i] = bf16_bits_to_f32(src[i]);
    }
}

// R bytes to an address that is a multiple of R
template <int R>
__device__ __forceinline__ void store_row(unsigned char* dst, const unsigned char (&q)[R]) {
    if constexpr (R % 4 == 0) {
#pragma unroll
        for (int w = 0; w < R / 4; ++w) {
            reinterpret_cast<uint32_t*>(dst)[w] = q[4 * w] | q[4 * w + 1] << 8 |
                                                  q[4 * w + 2] << 16 | (uint32_t)q[4 * w + 3] << 24;
        }
    } else if constexpr (R % 2 == 0) {
#pragma unroll
        for (int w = 0; w < R / 2; ++w) {
            reinterpret_cast<uchar2*>(dst)[w] = make_uchar2(q[2 * w], q[2 * w + 1]);
        }
    } else {
#pragma unroll
        for (int w = 0; w < R; ++w) dst[w] = q[w];
    }
}

template <int R>
__global__ void __launch_bounds__(kBlockX * kBlockY)
s2d_tail_kernel(const unsigned short* __restrict__ packed,
                unsigned char* __restrict__ luma, unsigned char* __restrict__ chroma,
                int height, int width, long long plane, float inv_n, TailCoeffs k) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    const long long b = blockIdx.z;
    if (x >= width || y >= height) return;

    const int g = (y & 1) * 2 + (x & 1);
    const long long pix = (b * (height / 2) + (y >> 1)) * (width / 2) + (x >> 1);
    float v[3 * R * R];
    load_block<R>(packed + (pix * 4 + g) * (3 * R * R), v);

    const long long luma_w = (long long)width * R;
    unsigned char* row = luma + (b * height + y) * R * luma_w + (long long)x * R;
#pragma unroll
    for (int si = 0; si < R; ++si) {
        unsigned char q[R];
#pragma unroll
        for (int sj = 0; sj < R; ++sj) {
            const int s = 3 * (si * R + sj);
            q[sj] = quantize_u8_value(contract3(v[s], v[s + 1], v[s + 2], k.y));
        }
        store_row<R>(row + si * luma_w, q);
    }

    float mean[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        float sum = v[c];
#pragma unroll
        for (int s = 1; s < R * R; ++s) sum = __fadd_rn(sum, v[3 * s + c]);
        mean[c] = __fmul_rn(sum, inv_n);
    }
    const long long at = (b * height + y) * (long long)width + x;
    chroma[at] = chroma_u8(mean[0], mean[1], mean[2], k.cb);
    chroma[plane + at] = chroma_u8(mean[0], mean[1], mean[2], k.cr);
}

// any r: the same arithmetic with r at run time, one bf16 load a value
__global__ void __launch_bounds__(kBlockX * kBlockY)
s2d_tail_kernel_any(const unsigned short* __restrict__ packed,
                    unsigned char* __restrict__ luma, unsigned char* __restrict__ chroma,
                    int height, int width, int r, long long plane, float inv_n, TailCoeffs k) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    const long long b = blockIdx.z;
    if (x >= width || y >= height) return;

    const int g = (y & 1) * 2 + (x & 1), rr = r * r;
    const long long pix = (b * (height / 2) + (y >> 1)) * (width / 2) + (x >> 1);
    const unsigned short* px = packed + (pix * 4 + g) * 3LL * rr;
    const long long luma_w = (long long)width * r;
    unsigned char* row = luma + (b * height + y) * r * luma_w + (long long)x * r;
    float sum[3];
    for (int s = 0; s < rr; ++s) {
        const float x0 = bf16_bits_to_f32(px[3 * s]);
        const float x1 = bf16_bits_to_f32(px[3 * s + 1]);
        const float x2 = bf16_bits_to_f32(px[3 * s + 2]);
        row[(s / r) * luma_w + s % r] = quantize_u8_value(contract3(x0, x1, x2, k.y));
        sum[0] = s ? __fadd_rn(sum[0], x0) : x0;
        sum[1] = s ? __fadd_rn(sum[1], x1) : x1;
        sum[2] = s ? __fadd_rn(sum[2], x2) : x2;
    }
    const float mr = __fmul_rn(sum[0], inv_n), mg = __fmul_rn(sum[1], inv_n),
                mb = __fmul_rn(sum[2], inv_n);
    const long long at = (b * height + y) * (long long)width + x;
    chroma[at] = chroma_u8(mr, mg, mb, k.cb);
    chroma[plane + at] = chroma_u8(mr, mg, mb, k.cr);
}

}  // namespace

// packed: (batch, height/2, width/2, 12*scale^2) bf16, contiguous, aligned
// to gcd(6*scale^2, 16) bytes at scales 1-4 (2 beyond); luma: (batch,
// height*scale, width*scale) u8; chroma: (2, batch, height, width) u8.
// height and width are the full-res input dims (both even); scale >= 1;
// inv_n is f32(1/scale^2); batch <= 65535.
extern "C" int s2d_tail_launch(const void* packed, void* luma, void* chroma,
                               int batch, int height, int width, int scale,
                               float inv_n, TailCoeffs coeffs, void* stream) {
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY, batch);
    const long long plane = (long long)batch * height * width;
    const auto* src = (const unsigned short*)packed;
    auto* y = (unsigned char*)luma;
    auto* c = (unsigned char*)chroma;
    cudaStream_t s = (cudaStream_t)stream;
    switch (S2D_TAIL_FIXED_SCALES ? scale : 0) {
        case 1: s2d_tail_kernel<1><<<grid, block, 0, s>>>(src, y, c, height, width, plane, inv_n, coeffs); break;
        case 2: s2d_tail_kernel<2><<<grid, block, 0, s>>>(src, y, c, height, width, plane, inv_n, coeffs); break;
        case 3: s2d_tail_kernel<3><<<grid, block, 0, s>>>(src, y, c, height, width, plane, inv_n, coeffs); break;
        case 4: s2d_tail_kernel<4><<<grid, block, 0, s>>>(src, y, c, height, width, plane, inv_n, coeffs); break;
        default:
            s2d_tail_kernel_any<<<grid, block, 0, s>>>(src, y, c, height, width, scale, plane, inv_n, coeffs);
    }
    return (int)cudaGetLastError();
}
