// The packed s2d head: a SAME stride-2 4x4 conv, 128 -> 48 channels, on
// Hopper's warpgroup tensor cores (wgmma) fed by the Tensor Memory
// Accelerator (TMA), with f32 accumulation.
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
// Layout: feats (B, H, W, 128) bf16 NHWC; the weights repacked by the
// wrapper as w16 (16 taps u*4+v, 48 n, 128 c) bf16, so that a (32-channel
// chunk, 4 taps) step is one TMA box; bias4 (48,) bf16; out (B, H/2, W/2,
// 48) bf16 or f32; H and W even, any size.
//
// Bound on an H100 SXM: bytes.  At (8, 1080, 1920, 128) it must read 4.25
// GB and write 0.40 GB (1.39 ms at 3.35 TB/s) for 0.815 TFLOP (0.82 ms at
// the dense bf16 rate).  Against that bound the design reads each input
// pixel ~1.16 times (the 18 x 66 window of a tile's 8 x 32 outputs) and
// keeps both operands of the tensor cores fed from shared memory while
// the next copies are in flight.  Its time beside the bound, and what
// sets its pace: PERF.md.
//
// Design.  A persistent block (one per SM) of three roles walks over
// output tiles of 8 rows x 32 columns:
//   - one producer warp issues every copy with TMA.  The input window of
//     a tile, (2*8+2) x (2*32+2) pixels, is loaded per 32-channel chunk as
//     two column-parity planes of 18 x 33 pixels (the feature map viewed
//     as (B, H, W/2, 2, 128): window parity 0 is global parity 1 from
//     half-column j0-1, window parity 1 is global parity 0 from j0), so
//     each tap's stride-2 reads are unit-stride.  TMA's zero fill past the
//     frame (coordinates -1 and beyond the ragged bottom/right edge) is
//     the SAME padding.  Window chunks (76 KB) sit in a ring of 2; weight
//     steps (32 channels x 4 taps x 48 n = 12 KB) in a ring of 4, each
//     slot guarded by a full and an empty mbarrier;
//   - two consumer warpgroups each own 4 of the tile's rows, as two M = 64
//     tiles of wgmma.mma_async m64n48k16 (bf16 -> f32).  Warp w of a
//     warpgroup supplies the A fragment of rows 16w..16w+15, an output row
//     of 16 columns, with ldmatrix over the window (the m16n8k16 A layout);
//     64-byte TMA swizzling (16-byte chunk ^ bits 7-8 of the address) makes
//     those 8-pixel reads conflict-free.  B, the weight step, is read from
//     shared memory through a K-major 64B-swizzle matrix descriptor, ONCE
//     per warpgroup: against the mma.sync design, where each warp read the
//     whole weight step through ldmatrix, that cuts the shared-memory
//     reads of B 4x.  A weight step's wgmmas are one commit group, and
//     wgmma.wait_group 0 sees it done before the next step's ldmatrix
//     writes A's registers again (the PTX rule for A in registers: no
//     write while a wgmma that reads them may run).  So a warpgroup's
//     loads and its own wgmmas take turns, and the two warpgroups overlap
//     each other.  Smaller groups that keep one in flight while the next
//     loads ran slower (ptxas serialises one tap a group; two are still
//     slower than one a step), as did sharing the weight steps across a
//     cluster by TMA multicast, which halved their L2 reads: PERF.md.
//   The producer runs ahead of the consumers across tile boundaries, so a
//   tile's epilogue (+ f32 bias, one rounding, masked stores straight from
//   the accumulators) overlaps the next tile's loads.
//   Shared memory: 2 x 77,824 B of window + 4 x 12,288 B of weights + 2
//   KB of barriers and alignment = 206,848 B: one block an SM.
//
// The build links no libcuda: cuTensorMapEncodeTiled comes from the
// runtime's driver entry point, and the maps are passed by value as
// __grid_constant__ kernel parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The tile, ring and group sizes; scripts/head_sweep.py builds other
// values with -D to time them against these defaults.
#ifndef S2D_HEAD_M_TILES
#define S2D_HEAD_M_TILES 2        // M = 64 tiles per warpgroup (2 output rows each)
#endif
#ifndef S2D_HEAD_WIN_STAGES
#define S2D_HEAD_WIN_STAGES 2     // window chunks in flight
#endif
#ifndef S2D_HEAD_W_STAGES
#define S2D_HEAD_W_STAGES 4       // weight steps in flight
#endif
#ifndef S2D_HEAD_TAPS_PER_STEP
#define S2D_HEAD_TAPS_PER_STEP 4  // taps of one 32-channel chunk per weight step
#endif
#ifndef S2D_HEAD_TAPS_PER_GROUP
#define S2D_HEAD_TAPS_PER_GROUP S2D_HEAD_TAPS_PER_STEP  // taps of one wgmma commit group
#endif

namespace {

constexpr int kCin = 128;
constexpr int kCout = 48;
constexpr int kMTiles = S2D_HEAD_M_TILES;
constexpr int kBM = 4 * kMTiles;                 // output rows per tile
constexpr int kBN = 32;                          // output columns per tile
constexpr int kChunkC = 32;                      // channels per window chunk
constexpr int kChunks = kCin / kChunkC;          // 4
constexpr int kWinRows = 2 * kBM + 2;            // 18 at the default 8 rows
constexpr int kWinCols = kBN + 1;                // 33 of each column parity
constexpr int kPixBytes = kChunkC * 2;           // 64: one swizzle row
constexpr int kPlaneBox = kWinRows * kWinCols * kPixBytes;   // 38,016 at 8 rows
constexpr int kPlaneBytes = (kPlaneBox + 1023) / 1024 * 1024;  // 38,912
constexpr int kWinStage = 2 * kPlaneBytes;
constexpr int kWinStages = S2D_HEAD_WIN_STAGES;
constexpr int kTapsPerStep = S2D_HEAD_TAPS_PER_STEP;
constexpr int kStepsPerChunk = 16 / kTapsPerStep;
constexpr int kTapBytes = kCout * kPixBytes;     // 3,072: 48 n x 32 c
constexpr int kStepBytes = kTapsPerStep * kTapBytes;  // 12,288 at 4 taps
constexpr int kWStages = S2D_HEAD_W_STAGES;
constexpr int kTapsPerGroup = S2D_HEAD_TAPS_PER_GROUP;
constexpr int kGroupsPerStep = kTapsPerStep / kTapsPerGroup;
// groups left in flight after each commit: none when a group is the
// whole step (the next step's first group reloads its A registers), else
// one (a group's registers are reloaded a step later, after the wait of
// a later group has seen it done)
constexpr int kPending = kGroupsPerStep > 1 ? 1 : 0;
constexpr int kConsumerWarps = 8;                // two warpgroups
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kBarBytes = 1024;
constexpr size_t kSmemBytes =
    1024 + (size_t)kWinStages * kWinStage + (size_t)kWStages * kStepBytes + kBarBytes;
constexpr long long kWaitLimit = 1LL << 34;      // ~10 s of clocks: a hang traps instead

static_assert(kPlaneBytes % 1024 == 0 && kStepBytes % 1024 == 0 && kTapBytes % 512 == 0,
              "swizzled buffers must start on a swizzle-pattern boundary");
static_assert(kBN == 2 * 16, "an M tile is 2 output rows x 2 warps' 16 columns");
static_assert(16 % kTapsPerStep == 0, "weight steps split the 16 taps evenly");
static_assert(kTapsPerStep % kTapsPerGroup == 0, "wgmma groups split a weight step evenly");
static_assert(kSmemBytes <= 232448, "more shared memory than a block can have");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try_wait(bar, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try_wait(bar, parity)) {
        if (clock64() - t0 > kWaitLimit) __trap();
    }
}

// -- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
           "r"(c3), "r"(c4), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
           "r"(bar)
        : "memory");
}

// -- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kGroups>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kGroups) : "memory");
}

// K-major B tile of 48 rows (n) x 64 bytes (32 k), 64-byte swizzle: the
// 8-row groups are 512 bytes apart (SBO); the leading offset is unused
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
           (uint64_t)(512 >> 4) << 32 | (uint64_t)2 << 62;
}

// d (64 x 48, f32) += a (64 x 16 bf16, registers) * b (16 x 48 bf16, smem)
__device__ __forceinline__ void wgmma_m64n48k16(float (&d)[24], const uint32_t (&a)[4],
                                                uint64_t desc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// keep the compiler from moving accumulator reads/writes across a wgmma wait
__device__ __forceinline__ void fence_acc(float (&d)[24]) {
#pragma unroll
    for (int k = 0; k < 24; ++k) asm volatile("" : "+f"(d[k]) :: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// output tiles: column tiles fastest, then row tiles, then frames
struct Tiles {
    int n_tr, n_tc, count;
    __host__ __device__ Tiles(int batch, int h2, int w2) {
        n_tr = (h2 + kBM - 1) / kBM;
        n_tc = (w2 + kBN - 1) / kBN;
        count = batch * n_tr * n_tc;
    }
    __device__ void at(int tile, int& b, int& i0, int& j0) const {
        const int rest = tile / n_tc;
        j0 = (tile % n_tc) * kBN;
        b = rest / n_tr;
        i0 = (rest % n_tr) * kBM;
    }
};

__global__ void __launch_bounds__(kThreads, 1)
s2d_head_kernel(const __grid_constant__ CUtensorMap feats_map,
                const __grid_constant__ CUtensorMap w_map,
                const unsigned short* __restrict__ bias4, void* __restrict__ out,
                int batch, int height, int width, int out_f32) {
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t win = base;                                   // kWinStages window chunks
    const uint32_t wts = win + kWinStages * kWinStage;           // kWStages weight steps
    const uint32_t bars = wts + kWStages * kStepBytes;
    auto full_x = [&](int s) { return bars + 8 * s; };
    auto empty_x = [&](int s) { return bars + 8 * (kWinStages + s); };
    auto full_w = [&](int s) { return bars + 8 * (2 * kWinStages + s); };
    auto empty_w = [&](int s) { return bars + 8 * (2 * kWinStages + kWStages + s); };

    const int h2 = height / 2, w2 = width / 2;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const Tiles tiles(batch, h2, w2);

    if (threadIdx.x == 0) {
        for (int s = 0; s < kWinStages; ++s) {
            mbar_init(full_x(s), 1);
            mbar_init(empty_x(s), kConsumerWarps);
        }
        for (int s = 0; s < kWStages; ++s) {
            mbar_init(full_w(s), 1);
            mbar_init(empty_w(s), kConsumerWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == kConsumerWarps) {
        // ---- producer: one thread issues every TMA copy ----
        if (lane == 0) {
            asm volatile("prefetch.tensormap [%0];\n"
                         :: "l"(reinterpret_cast<uint64_t>(&feats_map)) : "memory");
            asm volatile("prefetch.tensormap [%0];\n"
                         :: "l"(reinterpret_cast<uint64_t>(&w_map)) : "memory");
            int xs = 0, xph = 0, ws = 0, wph = 0;
            for (int tile = blockIdx.x; tile < tiles.count; tile += gridDim.x) {
                int b, i0, j0;
                tiles.at(tile, b, i0, j0);
                for (int c = 0; c < kChunks; ++c) {
                    mbar_wait(empty_x(xs), xph ^ 1);
                    mbar_expect_tx(full_x(xs), 2 * kPlaneBox);
                    const uint32_t dst = win + xs * kWinStage;
                    tma_load_5d(dst, &feats_map, full_x(xs), c * kChunkC, 1, j0 - 1,
                                2 * i0 - 1, b);
                    tma_load_5d(dst + kPlaneBytes, &feats_map, full_x(xs), c * kChunkC, 0,
                                j0, 2 * i0 - 1, b);
                    if (++xs == kWinStages) xs = 0, xph ^= 1;
                    for (int st = 0; st < kStepsPerChunk; ++st) {
                        mbar_wait(empty_w(ws), wph ^ 1);
                        mbar_expect_tx(full_w(ws), kStepBytes);
                        tma_load_3d(wts + ws * kStepBytes, &w_map, full_w(ws), c * kChunkC, 0,
                                    st * kTapsPerStep);
                        if (++ws == kWStages) ws = 0, wph ^= 1;
                    }
                }
            }
        }
    } else {
        // ---- consumers: two warpgroups of wgmma ----
        const int wg = warp >> 2, w = warp & 3;
        const int g = lane >> 2, t4 = lane & 3;
        // ldmatrix roles of this lane: matrix q = lane / 8, its row lane % 8
        const int q = lane >> 3, a_m = (lane & 7) + 8 * (q & 1), a_kc = q >> 1;
        const int lj0 = 16 * (w & 1);
        float bias[6][2];
#pragma unroll
        for (int nt = 0; nt < 6; ++nt) {
            bias[nt][0] = __uint_as_float((uint32_t)bias4[nt * 8 + 2 * t4] << 16);
            bias[nt][1] = __uint_as_float((uint32_t)bias4[nt * 8 + 2 * t4 + 1] << 16);
        }
        auto release_w = [&](int slot) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty_w(slot));
        };

        float acc[kMTiles][24];
        int xs = 0, xph = 0, ws = 0, wph = 0;
        for (int tile = blockIdx.x; tile < tiles.count; tile += gridDim.x) {
            int b, i0, j0;
            tiles.at(tile, b, i0, j0);
#pragma unroll
            for (int t = 0; t < kMTiles; ++t) {
#pragma unroll
                for (int k = 0; k < 24; ++k) acc[t][k] = 0.0f;
            }
            int prev = -1;  // the weight slot whose last group may still run
            for (int c = 0; c < kChunks; ++c) {
                mbar_wait(full_x(xs), xph);
                const uint32_t xbase = win + xs * kWinStage;
                for (int st = 0; st < kStepsPerChunk; ++st) {
                    mbar_wait(full_w(ws), wph);
                    const uint32_t wb = wts + ws * kStepBytes;
#pragma unroll
                    for (int gr = 0; gr < kGroupsPerStep; ++gr) {
                        // this group's A: [tap][k16 step][M tile].  The
                        // registers were last read by this group's wgmmas
                        // one step back, which the last wait saw done.
                        uint32_t a[kTapsPerGroup][2][kMTiles][4];
#pragma unroll
                        for (int tg = 0; tg < kTapsPerGroup; ++tg) {
                            const int tap = st * kTapsPerStep + gr * kTapsPerGroup + tg;
                            const int u = tap >> 2, v = tap & 3;
#pragma unroll
                            for (int t = 0; t < kMTiles; ++t) {
                                const int li = 2 * kMTiles * wg + 2 * t + (w >> 1);
                                const int pix = (2 * li + u) * kWinCols + lj0 + a_m + (v >> 1);
                                const uint32_t row =
                                    xbase + (v & 1) * kPlaneBytes + pix * kPixBytes;
                                const int swz = (pix >> 1) & 3;
#pragma unroll
                                for (int ks = 0; ks < 2; ++ks) {
                                    ldmatrix_x4(a[tg][ks][t], row + (((2 * ks + a_kc) ^ swz) << 4));
                                }
                            }
                        }
                        wgmma_fence();
#pragma unroll
                        for (int tg = 0; tg < kTapsPerGroup; ++tg) {
#pragma unroll
                            for (int ks = 0; ks < 2; ++ks) {
                                const uint64_t desc =
                                    b_desc(wb + (gr * kTapsPerGroup + tg) * kTapBytes + ks * 32);
#pragma unroll
                                for (int t = 0; t < kMTiles; ++t) {
                                    wgmma_m64n48k16(acc[t], a[tg][ks][t], desc);
                                }
                            }
                        }
                        wgmma_commit();
                        wgmma_wait<kPending>();
                        // every group of the last step is done now
                        if (gr == 0 && prev >= 0) release_w(prev);
                    }
                    prev = ws;
                    if (++ws == kWStages) ws = 0, wph ^= 1;
                }
                // every A load of this window chunk is in registers
                __syncwarp();
                if (lane == 0) mbar_arrive(empty_x(xs));
                if (++xs == kWinStages) xs = 0, xph ^= 1;
            }
            wgmma_wait<0>();
#pragma unroll
            for (int t = 0; t < kMTiles; ++t) fence_acc(acc[t]);
            release_w(prev);

            // epilogue: + f32 bias, one rounding, masked stores.  This
            // thread holds, of M tile t, output columns g and g+8 of its
            // warp's 16, channels nt*8 + 2*t4 and +1.
#pragma unroll
            for (int t = 0; t < kMTiles; ++t) {
                const int i = i0 + 2 * kMTiles * wg + 2 * t + (w >> 1);
                if (i >= h2) continue;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int j = j0 + lj0 + g + 8 * half;
                    if (j >= w2) continue;
                    const long long o = (((long long)b * h2 + i) * w2 + j) * kCout;
#pragma unroll
                    for (int nt = 0; nt < 6; ++nt) {
                        const int n = nt * 8 + 2 * t4;
                        const float v0 = __fadd_rn(acc[t][4 * nt + 2 * half], bias[nt][0]);
                        const float v1 = __fadd_rn(acc[t][4 * nt + 2 * half + 1], bias[nt][1]);
                        if (out_f32) {
                            *reinterpret_cast<float2*>(static_cast<float*>(out) + o + n) =
                                make_float2(v0, v1);
                        } else {
                            *reinterpret_cast<__nv_bfloat162*>(
                                static_cast<__nv_bfloat16*>(out) + o + n) =
                                __floats2bfloat162_rn(v0, v1);
                        }
                    }
                }
            }
        }
    }
}

// -- host ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
    }
    return fn;
}

int launch(const void* feats, const void* w16, const void* bias4, void* out, int batch, int height,
           int width, int out_f32, cudaStream_t stream) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const int h2 = height / 2, w2 = width / 2;
    CUtensorMap feats_map, w_map;
    {
        // (B, H, W/2, 2, 128), innermost first
        const cuuint64_t dims[5] = {(cuuint64_t)kCin, 2, (cuuint64_t)w2, (cuuint64_t)height,
                                    (cuuint64_t)batch};
        const cuuint64_t strides[4] = {kCin * 2, kCin * 4, (cuuint64_t)width * kCin * 2,
                                       (cuuint64_t)height * width * kCin * 2};
        const cuuint32_t box[5] = {kChunkC, 1, kWinCols, kWinRows, 1};
        const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
        if (encode(&feats_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(feats),
                   dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
            return (int)cudaErrorInvalidValue;
        }
    }
    {
        // (16 taps, 48 n, 128 c), innermost first
        const cuuint64_t dims[3] = {kCin, kCout, 16};
        const cuuint64_t strides[2] = {kCin * 2, kCout * kCin * 2};
        const cuuint32_t box[3] = {kChunkC, kCout, kTapsPerStep};
        const cuuint32_t ones[3] = {1, 1, 1};
        if (encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w16), dims,
                   strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
            return (int)cudaErrorInvalidValue;
        }
    }
    cudaError_t err = cudaFuncSetAttribute(s2d_head_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    // persistent: as many blocks as are resident at once (a cached answer)
    static int max_blocks = 0;
    if (max_blocks == 0) {
        int device = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&device);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, s2d_head_kernel, kThreads,
                                                            kSmemBytes);
        if (err != cudaSuccess) return (int)err;
        if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
        max_blocks = sms * per_sm;
    }
    const int tiles = Tiles(batch, h2, w2).count;
    s2d_head_kernel<<<tiles < max_blocks ? tiles : max_blocks, kThreads, kSmemBytes, stream>>>(
        feats_map, w_map, (const unsigned short*)bias4, out, batch, height, width, out_f32);
    return (int)cudaGetLastError();
}

}  // namespace

// feats: (batch, height, width, 128) bf16, contiguous, 16-byte aligned;
// w16: (16, 48, 128) bf16, contiguous, 16-byte aligned (k4 (4, 4, 128, 48)
// as [u*4+v][n][c]); bias4: (48,) bf16; out: (batch, height/2, width/2,
// 48), bf16 (out_f32 == 0) or f32.  height and width even and > 0.
extern "C" int s2d_head_launch(const void* feats, const void* w16, const void* bias4,
                               void* out, int batch, int height, int width, int out_f32,
                               void* stream) {
    return launch(feats, w16, bias4, out, batch, height, width, out_f32, (cudaStream_t)stream);
}
