// The packed s2d head: a SAME stride-2 4x4 conv, 128 -> 48 channels, on
// bf16 tensor cores with f32 accumulation.
//
// Replaces the Pallas TPU kernel pallas_s2d_head/_kernel
// (scripts/pallas_head_spike.py:35-107, pallas_call at :93):
//
//   out[b, i, j, n] = round( sum_{u,v,c} x[b, 2i+u-1, 2j+v-1, c] * k4[u, v, c, n]
//                            + f32(bias4[n]) )
//
// with x zero outside the frame (the SAME padding: one row/column on the
// top/left, and whatever lies past the bottom/right edge).  The sum is
// taken in f32, the bias is added in f32, and the result is rounded to
// the output type ONCE.  (The engine's cuDNN head, ops/s2d_head.py,
// rounds the conv to bf16 and then adds a bf16 bias: two roundings.)
//
// Layout: feats (B, H, W, 128) bf16 NHWC, k4 (4, 4, 128, 48) bf16 HWIO,
// bias4 (48,) bf16, out (B, H/2, W/2, 48) bf16 or f32; H and W even, any
// size (edge blocks zero-fill their loads and mask their stores).
//
// Design.  A block of 8 warps computes BM x BN = 8 x 16 output pixels:
// warp w owns output row i0+w, and its 16 output columns are the M = 16
// rows of an mma.sync m16n8k16 tile.  N = 48 is six n8 tiles; K = 16 taps
// x 128 channels, in k16 steps, all into one f32 accumulator (24 floats a
// thread).
//   - The block's input window, (2BM+2) x (2BN+2) pixels, is copied into
//     dynamic shared memory with cp.async (zero-filled outside the frame)
//     one half of the channels at a time: 64 channels a pixel keep the
//     window at 78 KB, so two blocks share an SM and one block's copies
//     overlap the other's MMAs.  The window is split by column parity so
//     the stride-2 reads of a tap are unit-stride: window column 2m+v sits
//     at [parity v&1][m + v/2].  An A fragment is one ldmatrix.x4 over 8
//     consecutive pixels, whose 16-byte chunks are XOR-swizzled by the
//     pixel slot (cc & 7), so the 8 row reads hit 8 bank groups.
//   - The weights stream one (half, tap) step at a time (6 KB; all of them
//     are 196 KB), double-buffered with cp.async: step s+1 lands while step
//     s's MMAs run.  A step is stored as [n/8][c][8 n], so the B fragments
//     of two n8 tiles are one ldmatrix.x4.trans over 128 contiguous bytes.
//   - Shared memory: 78,336 B of window + 2 x 6,144 B of weights = 90,624
//     B a block.
//   Measured on an H100 (PERF.md): blocks of 4 rows (two per SM with all
//   128 channels staged) re-stream the weights twice as often per output;
//   8 rows with all channels fit one block per SM, which then idles while
//   its window lands.
//
// Bound on an H100 SXM: bytes.  At (8, 1080, 1920, 128) it must read 4.25
// GB and write 0.40 GB (1.39 ms at 3.35 TB/s) for 0.815 TFLOP (0.82 ms at
// the dense bf16 rate).  Windows overlap by 2 rows and 2 columns (~1.2x
// the input), and every block streams all 196 KB of weights from L2 —
// more bytes than its window — so it sits well above the bound.  Sharing
// the weights across a cluster (TMA multicast), wider blocks and wgmma
// are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCin = 128;
constexpr int kCout = 48;
constexpr int kBM = 8;                          // output rows per block, one warp each
constexpr int kBN = 16;                         // output columns per block = MMA M
constexpr int kSplit = 2;                       // channel parts, staged one at a time
constexpr int kStages = 2;                      // weight steps in flight
constexpr int kThreads = 32 * kBM;
constexpr int kWinRows = 2 * kBM + 2;           // input rows
constexpr int kWinHalf = kBN + 1;               // 17 input columns of each parity
constexpr int kCinPart = kCin / kSplit;         // channels staged at once
constexpr int kChunks = kCinPart / 8;           // 16-byte chunks per staged pixel
constexpr int kPixBytes = kCinPart * 2;
constexpr int kWinBytes = kWinRows * 2 * kWinHalf * kPixBytes;
constexpr int kNChunks = kCout / 8;             // 6 n8 tiles
constexpr int kStepChunks = kCinPart * kNChunks;  // 16-byte chunks of one (part, tap)
constexpr int kStepBytes = kStepChunks * 16;
constexpr int kSteps = kSplit * 16;             // (part, tap) steps, part-major
constexpr size_t kSmemBytes = (size_t)kWinBytes + kStages * (size_t)kStepBytes;

static_assert(kChunks >= 8, "the XOR swizzle needs 8 chunks a pixel");
static_assert(kNChunks % 2 == 0, "B fragments load two n8 tiles at a time");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk `chunk` of window pixel [row][parity][cc]
__device__ __forceinline__ uint32_t win_offset(int row, int parity, int cc, int chunk) {
    return (uint32_t)(((row * 2 + parity) * kWinHalf + cc) * kPixBytes +
                      ((chunk ^ (cc & 7)) << 4));
}

// the weights of step (part, tap): chunk e = c * 6 + j of the part holds
// k4[u][v][part * kCinPart + c][8j .. 8j+7]; it lands at [j][c]
__device__ __forceinline__ void copy_step(uint32_t buf, const uint4* k4, int step, int tid) {
    const uint4* src = k4 + (step % 16) * kCin * kNChunks + (step / 16) * kStepChunks;
    for (int e = tid; e < kStepChunks; e += kThreads) {
        const int c = e / kNChunks, j = e % kNChunks;
        cp_async16(buf + (uint32_t)((j * kCinPart + c) << 4), src + e, 16u);
    }
}

// the window's channel part `part`: input rows 2*i0-1 .. 2*i0+2BM, columns
// 2*j0-1 .. 2*j0+2BN, zeros outside the frame; consecutive threads copy
// consecutive chunks
__device__ __forceinline__ void copy_window(uint32_t win, const uint4* feats, long long b,
                                            int i0, int j0, int height, int width,
                                            int part, int tid) {
    const int row0 = 2 * i0 - 1, col0 = 2 * j0 - 1;
    for (int e = tid; e < kWinRows * 2 * kWinHalf * kChunks; e += kThreads) {
        const int chunk = e % kChunks;
        const int p = e / kChunks;
        const int r = p / (2 * kWinHalf), wc = p % (2 * kWinHalf);
        const int gr = row0 + r, gc = col0 + wc;
        const bool inside = gr >= 0 && gr < height && gc >= 0 && gc < width;
        const uint4* src = inside
            ? feats + ((b * height + gr) * (long long)width + gc) * (kCin / 8) +
                  part * kChunks + chunk
            : feats;
        cp_async16(win + win_offset(r, wc & 1, wc >> 1, chunk), src, inside ? 16u : 0u);
    }
}

__global__ void __launch_bounds__(kThreads)
s2d_head_kernel(const uint4* __restrict__ feats, const uint4* __restrict__ k4,
                const unsigned short* __restrict__ bias4, void* __restrict__ out,
                int height, int width, int out_f32) {
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t win = smem_u32(smem);
    const uint32_t wring = win + kWinBytes;  // kStages weight-step buffers

    const int h2 = height / 2, w2 = width / 2;
    const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
    const long long b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;

    // one commit group per step: the window's first part rides with step 0
    copy_window(win, feats, b, i0, j0, height, width, 0, tid);
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
        copy_step(wring + t * kStepBytes, k4, t, tid);
        cp_async_commit();
    }

    float acc[kNChunks][4];
#pragma unroll
    for (int nt = 0; nt < kNChunks; ++nt) {
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
    }

    // ldmatrix roles of this lane: matrix q = lane / 8, its row lane % 8
    const int q = lane >> 3, r8 = lane & 7;
    const int a_m = r8 + 8 * (q & 1), a_kc = q >> 1;      // A: pixel, k chunk
    const int b_k = r8 + 8 * (q & 1), b_j = q >> 1;       // B: k row, n8 tile

    for (int step = 0; step < kSteps; ++step) {
        const int tap = step % 16;
        if (tap == 0 && step > 0) {
            // every warp is past the previous part (the trailing barrier):
            // stage the next part over it, and wait for it whole
            copy_window(win, feats, b, i0, j0, height, width, step / 16, tid);
            cp_async_commit();
            cp_async_wait<0>();
        }
        // refill the buffer the previous step read (the trailing barrier
        // below has freed it); an empty group past the last step keeps the
        // count uniform, so kStages - 1 pending groups means this step landed
        const int ahead = step + kStages - 1;
        if (ahead < kSteps) copy_step(wring + (ahead % kStages) * kStepBytes, k4, ahead, tid);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();
        const int u = tap >> 2, v = tap & 3;
        const int a_row = 2 * warp + u, a_cc = a_m + (v >> 1);
        const uint32_t wb = wring + (step % kStages) * kStepBytes;
#pragma unroll
        for (int ks = 0; ks < kCinPart / 16; ++ks) {
            uint32_t a[4];
            ldmatrix_x4(a, win + win_offset(a_row, v & 1, a_cc, 2 * ks + a_kc));
#pragma unroll
            for (int pair = 0; pair < kNChunks / 2; ++pair) {
                uint32_t bf[4];
                ldmatrix_x4_trans(
                    bf, wb + (uint32_t)((((2 * pair + b_j) * kCinPart) + ks * 16 + b_k) << 4));
                mma_bf16(acc[2 * pair], a, bf[0], bf[1]);
                mma_bf16(acc[2 * pair + 1], a, bf[2], bf[3]);
            }
        }
        __syncthreads();  // every warp is done with this step's buffer
    }

    // epilogue: + f32 bias, one rounding, masked stores.  This thread holds
    // output columns g and g+8, channels nt*8 + 2*t4 and +1.
    const int i = i0 + warp;
    if (i >= h2) return;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int j = j0 + g + 8 * half;
        if (j >= w2) continue;
        const long long o = ((b * h2 + i) * (long long)w2 + j) * kCout;
#pragma unroll
        for (int nt = 0; nt < kNChunks; ++nt) {
            const int n = nt * 8 + 2 * t4;
            const float v0 = __fadd_rn(acc[nt][2 * half],
                                       __uint_as_float((uint32_t)bias4[n] << 16));
            const float v1 = __fadd_rn(acc[nt][2 * half + 1],
                                       __uint_as_float((uint32_t)bias4[n + 1] << 16));
            if (out_f32) {
                *reinterpret_cast<float2*>(static_cast<float*>(out) + o + n) =
                    make_float2(v0, v1);
            } else {
                *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o + n) =
                    __floats2bfloat162_rn(v0, v1);
            }
        }
    }
}

}  // namespace

// feats: (batch, height, width, 128) bf16, contiguous, 16-byte aligned;
// k4: (4, 4, 128, 48) bf16, contiguous, 16-byte aligned; bias4: (48,) bf16;
// out: (batch, height/2, width/2, 48), bf16 (out_f32 == 0) or f32.
// height and width even and > 0; batch <= 65535.
extern "C" int s2d_head_launch(const void* feats, const void* k4, const void* bias4,
                               void* out, int batch, int height, int width,
                               int out_f32, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        s2d_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((width / 2 + kBN - 1) / kBN, (height / 2 + kBM - 1) / kBM, batch);
    s2d_head_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        (const uint4*)feats, (const uint4*)k4, (const unsigned short*)bias4, out,
        height, width, out_f32);
    return (int)cudaGetLastError();
}
