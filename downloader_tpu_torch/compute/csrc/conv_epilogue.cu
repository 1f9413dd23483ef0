// A conv's whole epilogue in one pass over its bf16 NHWC output: the
// bias add, then the relu and the residual add where the layer has them,
// with the roundings of the module's PyTorch ops on the card, in their
// order, so the result is the same bytes:
//
//   t = bf16(y + b)           f32 add, rounded to nearest even
//   t = relu(t)               NaN passes through, else fmaxf(t, 0): the
//                             clamp_min that F.relu runs on the card
//   out = bf16(t + x)         the residual, f32 add, rounded again
//
// Replaces no Pallas kernel: on the TPU, XLA fused these passes into the
// conv itself (downloader_tpu/compute/models/upscaler.py, Upscaler).  In
// PyTorch each one is a pass of its own over the whole activation, which
// at 1080p and batch 8 is 4.25 GB of bf16 (the bias add on a broadcast
// PyTorch does not vectorise).
//
// Bound on an H100: bytes.  A few operations per 2-byte element, far
// below the ~295 operations per byte where the card turns compute-bound.
// At (8, 1080, 1920, 128) a body conv's launch reads the conv output and
// the residual and writes the result: 12.74 GB, at least 3.80 ms at 3.35
// TB/s (0.95 ms at 540p); the stem's, with no residual, 8.49 GB (2.54
// ms).  So the design keeps the memory system busy and nothing else:
//
// - each thread moves 8 channels with one 16-byte load per operand and
//   one 16-byte store, neighbouring threads on neighbouring addresses;
// - the block size and the grid stride are multiples of C / 8, so a
//   thread's channels never change over its loop and its 8 bias values
//   sit in registers; the grid is one wave of resident blocks;
// - the result is written in place over the conv's fresh output, which
//   saves an allocation per layer and moves no byte more.
//
// Two or four vectors a thread per iteration, and streaming cache hints
// (__ldcs/__stcs), timed the same within 0.3% at these shapes: the plain
// loop stays.
//
// A channel count that is not a multiple of 8 (the 12-wide head of the
// x2 odd-dims path), or a pointer that is not 16-byte aligned, takes the
// scalar variant: one element a thread, its one bias value in a register
// the same way.
//
// Three variants with names of their own, since a device trace matches
// kernels by name: conv_epilogue_residual_kernel (bias, relu, residual:
// the body convs), conv_epilogue_relu_kernel (bias, relu: the stem),
// conv_epilogue_bias_kernel (bias: the plain sub-pixel head).
//
// The C entry launches on the caller's stream, never synchronises, and
// returns cudaGetLastError() (cudaErrorInvalidValue for a combination it
// has no variant for) so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "quantize.cuh"  // bf16_bits_to_f32

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 1024;  // channel groups a block can hold

__device__ __forceinline__ unsigned int f32_to_bf16_bits(float x) {
    // cvt.rn.bf16.f32, the conversion PyTorch's bf16 ops make on sm_80+
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <bool RELU, bool RESIDUAL>
__device__ __forceinline__ unsigned int epilogue_value(unsigned int y, float b,
                                                       unsigned int x) {
    unsigned int t = f32_to_bf16_bits(bf16_bits_to_f32(y) + b);
    if (RELU) {
        const float v = bf16_bits_to_f32(t);
        if (!isnan(v)) t = f32_to_bf16_bits(fmaxf(v, 0.0f));
    }
    if (RESIDUAL) t = f32_to_bf16_bits(bf16_bits_to_f32(t) + bf16_bits_to_f32(x));
    return t;
}

// two bf16 in one 32-bit word; the element of the lower address is the
// low half (little endian)
template <bool RELU, bool RESIDUAL>
__device__ __forceinline__ unsigned int epilogue_pair(unsigned int y2, float b_lo,
                                                      float b_hi, unsigned int x2) {
    return epilogue_value<RELU, RESIDUAL>(y2 & 0xffffu, b_lo, x2 & 0xffffu)
           | (epilogue_value<RELU, RESIDUAL>(y2 >> 16, b_hi, x2 >> 16) << 16);
}

// y: n_vec runs of 8 bf16, read and overwritten; bias: C bf16; res: as y
// (unread without RESIDUAL); groups = C / 8
template <bool RELU, bool RESIDUAL>
__device__ __forceinline__ void epilogue_vec8(uint4* y, const uint4* __restrict__ res,
                                              const unsigned short* __restrict__ bias,
                                              long long n_vec, int groups) {
    const int c0 = (threadIdx.x % groups) * 8;
    float b[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = bf16_bits_to_f32(bias[c0 + k]);
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
         i += stride) {
        uint4 v = y[i];
        const uint4 r = RESIDUAL ? __ldg(res + i) : make_uint4(0, 0, 0, 0);
        v.x = epilogue_pair<RELU, RESIDUAL>(v.x, b[0], b[1], r.x);
        v.y = epilogue_pair<RELU, RESIDUAL>(v.y, b[2], b[3], r.y);
        v.z = epilogue_pair<RELU, RESIDUAL>(v.z, b[4], b[5], r.z);
        v.w = epilogue_pair<RELU, RESIDUAL>(v.w, b[6], b[7], r.w);
        y[i] = v;
    }
}

// one element a thread; groups = C
template <bool RELU, bool RESIDUAL>
__device__ __forceinline__ void epilogue_scalar(unsigned short* y,
                                                const unsigned short* __restrict__ res,
                                                const unsigned short* __restrict__ bias,
                                                long long n, int groups) {
    const float b = bf16_bits_to_f32(bias[threadIdx.x % groups]);
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        y[i] = (unsigned short)epilogue_value<RELU, RESIDUAL>(
            y[i], b, RESIDUAL ? (unsigned int)res[i] : 0u);
    }
}

template <bool RELU, bool RESIDUAL, bool VEC8>
__device__ __forceinline__ void epilogue(void* y, const void* res,
                                         const unsigned short* bias, long long work,
                                         int groups) {
    if (VEC8) {
        epilogue_vec8<RELU, RESIDUAL>((uint4*)y, (const uint4*)res, bias, work, groups);
    } else {
        epilogue_scalar<RELU, RESIDUAL>((unsigned short*)y, (const unsigned short*)res,
                                        bias, work, groups);
    }
}

template <bool VEC8>
__global__ void conv_epilogue_residual_kernel(void* y, const void* res,
                                              const unsigned short* bias,
                                              long long work, int groups) {
    epilogue<true, true, VEC8>(y, res, bias, work, groups);
}

template <bool VEC8>
__global__ void conv_epilogue_relu_kernel(void* y, const void* res,
                                          const unsigned short* bias, long long work,
                                          int groups) {
    epilogue<true, false, VEC8>(y, res, bias, work, groups);
}

template <bool VEC8>
__global__ void conv_epilogue_bias_kernel(void* y, const void* res,
                                          const unsigned short* bias, long long work,
                                          int groups) {
    epilogue<false, false, VEC8>(y, res, bias, work, groups);
}

using Kernel = void (*)(void*, const void*, const unsigned short*, long long, int);

template <bool VEC8>
Kernel pick(bool relu, bool residual) {
    if (residual) return conv_epilogue_residual_kernel<VEC8>;
    return relu ? conv_epilogue_relu_kernel<VEC8> : conv_epilogue_bias_kernel<VEC8>;
}

// the blocks the current device holds at once of `kernel` at `threads`
// a block: asked of the runtime on the first launch of each (kernel,
// device, threads) and kept, so a later launch makes one query
// (cudaGetDevice) where it made three
long long resident_blocks(Kernel kernel, int threads) {
    static std::mutex lock;
    static std::map<std::tuple<uintptr_t, int, int>, long long> known;
    int device = 0;
    cudaGetDevice(&device);
    const std::tuple<uintptr_t, int, int> key(reinterpret_cast<uintptr_t>(kernel),
                                              device, threads);
    std::lock_guard<std::mutex> hold(lock);
    const auto found = known.find(key);
    if (found != known.end()) return found->second;
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    const long long resident = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    known.emplace(key, resident);
    return resident;
}

// at most one wave of the blocks the card holds at once
unsigned int blocks_for(Kernel kernel, int threads, long long work) {
    const long long resident = resident_blocks(kernel, threads);
    const long long needed = (work + threads - 1) / threads;
    return (unsigned int)(needed < resident ? needed : resident);
}

}  // namespace

// y: n bf16, NHWC with `channels` innermost, overwritten with the result;
// bias: `channels` bf16; residual: n bf16 laid out as y, or NULL.  relu
// != 0 applies the relu; a residual needs it.  n == 0 launches nothing.
extern "C" int conv_epilogue_launch(void* y, const void* bias, const void* residual,
                                    long long n, int channels, int relu,
                                    void* stream) {
    if (channels <= 0 || (residual != nullptr && !relu)) return (int)cudaErrorInvalidValue;
    const bool vec8 = channels % 8 == 0 && (uintptr_t)y % 16 == 0
                      && (uintptr_t)residual % 16 == 0;
    const int groups = vec8 ? channels / 8 : channels;
    if (groups > kMaxGroups) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const int threads = groups >= kThreads ? groups : (kThreads / groups) * groups;
    const long long work = vec8 ? n / 8 : n;
    const Kernel kernel = vec8 ? pick<true>(relu != 0, residual != nullptr)
                               : pick<false>(relu != 0, residual != nullptr);
    kernel<<<blocks_for(kernel, threads, work), threads, 0, (cudaStream_t)stream>>>(
        y, residual, (const unsigned short*)bias, work, groups);
    return (int)cudaGetLastError();
}
