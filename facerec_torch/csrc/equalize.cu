// Histogram equalization statistics of the scene detector, for Hopper
// (sm_90a).  Built by facerec_torch/ops/_build.py into a shared library
// with a plain C interface and bound with ctypes
// (facerec_torch/ops/equalize.py).
//
// Replaces the three Pallas TPU kernels of
// facerec_tpu/ops/pallas/equalize.py:
//   - _fused_kernel  (launched by _equalize_fused, one frame per step)
//   - _hist_kernel   (launched by _equalize_tiled, per-frame counts)
//   - _eq_kernel     (launched by _equalize_tiled, cdf lookup)
// The TPU split between the fused and tiled forms is a VMEM residency
// decision; here one pair of kernels serves every plane size:
//   hist256     = _hist_kernel, and the first half of _fused_kernel;
//                 it also computes the luminance plane the TPU path
//                 reads (facerec_tpu/ops/scene.py:luminance) from the
//                 uint8 RGB frames
//   cum_lookup  = _eq_kernel, and the second half of _fused_kernel
// The radix-16 one-hot matrix formulation of the TPU kernels exists
// only because the TPU has no scatter; it is not carried over.
//
// Plane: y (B, R, W) f32 luminance, rows padded with -1 (padding is
// any y < 0).  A pixel's bin is clip(int(y), 0, 255).  hist (B, 256)
// int32 counts of the real pixels (zeroed by the caller); cum (B, 256)
// f32 inclusive cumulative counts; eq (B, R, W) f32 holding cum[bin]
// per pixel and 0 at padding.  Counts are integer atomics, so the
// result is exact and the same on every run.
//
// hist256 has two loaders, one kernel template:
//   PlaneSrc   the (B, R, W) f32 plane above;
//   RgbSrc     (B, H, W, 3) uint8 frames, rows [lo, hi) of each: it
//              writes y itself (rows hi-lo..R = -1) and counts its bins.
//              Y = fma(b, w2, fma(g, w1, r * w0)) in f32 with the first
//              product rounded alone, bit for bit the JAX CPU path's
//              dot (and facerec_torch/ops/equalize.py:luminance);
//              grayscale takes channel 0.
//
// Bound: device-memory bytes (O(1) integer work per pixel).  At the
// main path's block (128 frames of 576x768, cropped to 384 rows):
//   hist256 plane   reads y once: 151 MB, 0.045 ms at 3.35 TB/s
//   hist256 RGB     reads 113 MB of uint8, writes 151 MB of y:
//                   264 MB, 0.079 ms (the f32 plane is never read)
//   cum_lookup      reads y, writes eq: 302 MB, 0.090 ms
// What the design does about it:
//   - coalesced 16-byte loads and stores.  The plane: four float4 per
//     thread per round, neighbouring threads on neighbouring vectors.
//     RGB: a warp moves 32 pixel groups (16 pixels, 48 bytes each) at a
//     time through shared memory: uint4 loads in, each lane converts
//     its own 16 pixels, float4 stores of y out (slots XOR-swizzled
//     against bank conflicts).  Widths with 3W % 16 != 0 (so W % 16 !=
//     0) and unaligned frames take byte loads, a pixel per thread.  No
//     load reaches past the crop: within a frame, rows [lo, hi) and y
//     are both contiguous, so the kernel walks them as one run.
//   - one wave of CTAs (SMs x resident CTAs per SM), each streaming an
//     even, contiguous share of all frames' pixels; a CTA whose share
//     crosses a frame boundary finishes one frame before the next.
//   - hist256 keeps a private histogram per warp in shared memory and
//     counts runs of one bin in registers before each shared atomic,
//     so a flat frame (black, white flash) costs no more than a noisy
//     one; the per-warp histograms are summed per CTA and merged into
//     the frame's counts with integer atomicAdd (order-free, exact).
//   - cum_lookup scans the 256 counts once per frame a CTA touches
//     (warp shuffles, two barriers) into a shared table, then streams.
//
// Left for a later change: keeping the plane on chip between the two
// passes (a thread-block cluster holding one frame in distributed
// shared memory), so that y is written once and not read back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kPadBin = kBins;         // padding pixels land here, dropped
constexpr int kSlots = kBins + 1;      // one warp's histogram
constexpr int kThreads = 256;          // cum_lookup's scan: a thread a bin
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                // float4s a thread moves per round
constexpr int kGroup = 16;             // RGB pixels a thread takes at once
static_assert(kThreads == kBins, "flush_frame and the scan: a thread a bin");

// float32 values of the luminance weights
constexpr float kW0 = 0.299f, kW1 = 0.587f, kW2 = 0.114f;

__device__ __forceinline__ int bin_of(float v) {
    // y < 0 is padding; else truncation, as int32(y) in the reference
    return v < 0.f ? kPadBin : min((int)v, kBins - 1);
}

// A uint8 as an exact float: 2^23 + b, minus 2^23.
__device__ __forceinline__ float u8f(uint32_t b) {
    return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.f);
}

// Explicit intrinsics: nvcc would contract r*w0 + g*w1 into one fma.
template <bool kGray>
__device__ __forceinline__ float luma(uint32_t r, uint32_t g, uint32_t b) {
    if constexpr (kGray) return u8f(r);
    return __fmaf_rn(u8f(b), kW2, __fmaf_rn(u8f(g), kW1,
                                            __fmul_rn(u8f(r), kW0)));
}

// Byte n of 48 bytes held as 12 words (n is a constant once unrolled).
__device__ __forceinline__ uint32_t byte_at(const uint32_t (&w)[12], int n) {
    return (w[n >> 2] >> ((n & 3) * 8)) & 0xFFu;
}

// Consecutive pixels of one bin are counted in registers and added to
// the warp's histogram once.
struct Runs {
    int bin = -1, n = 0;
    __device__ __forceinline__ void add(int* h, int b) {
        if (b == bin) {
            ++n;
            return;
        }
        if (n) atomicAdd(&h[bin], n);
        bin = b;
        n = 1;
    }
    __device__ __forceinline__ void flush(int* h) {
        if (n) atomicAdd(&h[bin], n);
    }
};

// This CTA's share [u0, u1) of `total` work units.
__device__ __forceinline__ void cta_range(int64_t total, int64_t& u0,
                                          int64_t& u1) {
    u0 = total * blockIdx.x / gridDim.x;
    u1 = total * (blockIdx.x + 1) / gridDim.x;
}

// The part [a, b) of frame f's `per` units inside [u0, u1).
__device__ __forceinline__ void frame_part(int64_t u0, int64_t u1, int64_t f,
                                           int64_t per, int& a, int& b) {
    const int64_t f0 = f * per;
    a = (int)(u0 > f0 ? u0 - f0 : 0);
    b = (int)(u1 < f0 + per ? u1 - f0 : per);
}

struct PlaneSrc {
    const float* y;
    int per_frame;                      // float4s per frame, R * W / 4

    // Count units [a, b) of frame f (float4s; warp-coalesced rounds).
    __device__ __forceinline__ void run(int64_t f, int a, int b,
                                        int* h) const {
        const float4* p = reinterpret_cast<const float4*>(y) +
                          f * per_frame;
        Runs runs;
        for (int base = a; base < b; base += kVec * kThreads) {
            float4 v[kVec];
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
                const int i = base + j * kThreads + threadIdx.x;
                v[j] = i < b ? __ldg(p + i)
                             : make_float4(-1.f, -1.f, -1.f, -1.f);
            }
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
                runs.add(h, bin_of(v[j].x));
                runs.add(h, bin_of(v[j].y));
                runs.add(h, bin_of(v[j].z));
                runs.add(h, bin_of(v[j].w));
            }
        }
        runs.flush(h);
    }
};

// Bank-conflict-free slot of lane l's float4 j in a warp's 32 x 4
// staging tile: the XOR spreads the 8 lanes of a quarter-warp over all
// 32 banks, both when each lane writes its own four and when the warp
// reads the tile back in order.
__device__ __forceinline__ int out_slot(int l, int j) {
    return 4 * l + (j ^ ((l >> 1) & 3));
}

// uint8 frames → luminance plane and its counts.  kStaged: width % 16
// == 0 and 16-byte aligned frames, so each frame's crop is a run of
// 48-byte pixel groups on 16-byte boundaries.  A warp then moves 32
// groups at a time through shared memory: coalesced uint4 loads in,
// each lane converts its own 16 pixels, coalesced float4 stores out.
// Otherwise (ragged widths) every pixel takes byte loads.
template <bool kGray, bool kStaged>
struct RgbSrc {
    const uint8_t* rgb;                 // (B, H, W, 3)
    float* y;                           // (B, R, W) out
    int height, width, lo, real_rows, rows;
    int per_frame;                      // 16-pixel groups of R * W

    __device__ __forceinline__ void run(int64_t f, int a, int b,
                                        int* h) const {
        // Within a frame the crop [lo, hi) is contiguous, and so is y:
        // pixel p of the frame reads src[3p..3p+2] and writes dst[p].
        const uint8_t* src = rgb + (f * height + lo) * (int64_t)width * 3;
        float* dst = y + f * rows * (int64_t)width;
        const int n_real = real_rows * width;
        Runs runs;
        if constexpr (kStaged) {
            __shared__ uint4 stage_in[kWarps][3 * 32];
            __shared__ float4 stage_out[kWarps][4 * 32];
            const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
            uint4* sin = stage_in[warp];
            float4* sout = stage_out[warp];
            const uint4* src4 = reinterpret_cast<const uint4*>(src);
            float4* dst4 = reinterpret_cast<float4*>(dst);
            const int real_groups = n_real / kGroup;
            for (int c0 = a + warp * 32; c0 < b; c0 += kThreads) {
                const int nb = min(32, b - c0);                 // groups
                const int nr = max(0, min(nb, real_groups - c0));  // real
                uint4 q[3];
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    const int i = lane + 32 * k;
                    q[k] = i < 3 * nr ? __ldg(src4 + 3 * c0 + i)
                                      : make_uint4(0, 0, 0, 0);
                }
#pragma unroll
                for (int k = 0; k < 3; ++k) sin[lane + 32 * k] = q[k];
                __syncwarp();
                float out[kGroup];
                if (lane < nr) {
                    const uint4 q0 = sin[3 * lane], q1 = sin[3 * lane + 1],
                                q2 = sin[3 * lane + 2];
                    const uint32_t w[12] = {q0.x, q0.y, q0.z, q0.w,
                                            q1.x, q1.y, q1.z, q1.w,
                                            q2.x, q2.y, q2.z, q2.w};
#pragma unroll
                    for (int k = 0; k < kGroup; ++k) {
                        out[k] = luma<kGray>(byte_at(w, 3 * k),
                                             byte_at(w, 3 * k + 1),
                                             byte_at(w, 3 * k + 2));
                        runs.add(h, bin_of(out[k]));
                    }
                } else {                                  // padding rows
#pragma unroll
                    for (int k = 0; k < kGroup; ++k) out[k] = -1.f;
                }
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    sout[out_slot(lane, j)] = make_float4(
                        out[4 * j], out[4 * j + 1], out[4 * j + 2],
                        out[4 * j + 3]);
                __syncwarp();
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int i = lane + 32 * k;
                    if (i < 4 * nb)
                        dst4[4 * c0 + i] = sout[out_slot(i >> 2, i & 3)];
                }
                __syncwarp();         // the tiles are refilled next
            }
        } else {
            // pixels [16a, 16b) of the frame, one per thread in turn
            const int p1 = min(b * kGroup, rows * width);
            for (int p = a * kGroup + threadIdx.x; p < p1; p += kThreads) {
                if (p < n_real) {
                    const uint8_t* px = src + 3 * p;
                    const float v =
                        luma<kGray>(__ldg(px), __ldg(px + 1), __ldg(px + 2));
                    dst[p] = v;
                    runs.add(h, bin_of(v));
                } else {
                    dst[p] = -1.f;
                }
            }
        }
        runs.flush(h);
    }
};

// Sum the warps' histograms into the frame's counts and zero them.
__device__ __forceinline__ void flush_frame(int* sh, int* hist) {
    __syncthreads();
    const int t = threadIdx.x;
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        c += sh[w * kSlots + t];
        sh[w * kSlots + t] = 0;
    }
    if (t < kWarps) sh[t * kSlots + kPadBin] = 0;
    if (c) atomicAdd(&hist[t], c);
    __syncthreads();
}

template <class Src>
__global__ void __launch_bounds__(kThreads)
hist256_kernel(const Src src, int* __restrict__ hist, int frames) {
    __shared__ int sh[kWarps * kSlots];
    for (int i = threadIdx.x; i < kWarps * kSlots; i += kThreads) sh[i] = 0;
    __syncthreads();
    int* h = sh + (threadIdx.x >> 5) * kSlots;

    const int64_t per = src.per_frame;
    int64_t u0, u1;
    cta_range((int64_t)frames * per, u0, u1);
    for (int64_t f = u0 / per; f * per < u1; ++f) {
        int a, b;
        frame_part(u0, u1, f, per, a, b);
        src.run(f, a, b, h);
        flush_frame(sh, hist + f * kBins);
    }
}

__global__ void __launch_bounds__(kThreads)
cum_lookup_kernel(const float* __restrict__ y,
                  const int* __restrict__ hist, float* __restrict__ eq,
                  float* __restrict__ cum, int frames, int per_frame) {
    __shared__ float table[kSlots];
    __shared__ int warp_total[kWarps];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    if (t == 0) table[kPadBin] = 0.f;

    const int64_t per = per_frame;
    int64_t u0, u1;
    cta_range((int64_t)frames * per, u0, u1);
    for (int64_t f = u0 / per; f * per < u1; ++f) {
        int a, b;
        frame_part(u0, u1, f, per, a, b);

        // inclusive scan of the 256 counts: in each warp, then across
        int c = hist[f * kBins + t];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(0xFFFFFFFFu, c, off);
            if (lane >= off) c += v;
        }
        if (lane == 31) warp_total[warp] = c;
        __syncthreads();
        for (int w = 0; w < warp; ++w) c += warp_total[w];
        table[t] = (float)c;
        if (a == 0) cum[f * kBins + t] = (float)c;   // the frame's first CTA
        __syncthreads();

        const float4* p = reinterpret_cast<const float4*>(y) + f * per;
        float4* o = reinterpret_cast<float4*>(eq) + f * per;
        for (int base = a; base < b; base += kVec * kThreads) {
            float4 v[kVec];
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
                const int i = base + j * kThreads + t;
                v[j] = i < b ? __ldg(p + i)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
                const int i = base + j * kThreads + t;
                if (i < b)
                    o[i] = make_float4(table[bin_of(v[j].x)],
                                       table[bin_of(v[j].y)],
                                       table[bin_of(v[j].z)],
                                       table[bin_of(v[j].w)]);
            }
        }
        __syncthreads();      // the table and totals are rewritten next
    }
}

// One wave: as many CTAs as fit on the card at once, but none with
// less than `min_units` of work.
template <class... P, class... A>
int launch(void (*kernel)(P...), int64_t units, int64_t min_units,
           cudaStream_t stream, A... args) {
    static int per_sm = 0;              // per kernel: one instantiation each
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (!e) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
    if (!e && !per_sm)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (e) return (int)e;
    const int64_t want = (units + min_units - 1) / min_units;
    const int64_t wave = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    const int grid = (int)(want < wave ? (want > 0 ? want : 1) : wave);
    kernel<<<grid, kThreads, 0, stream>>>(args...);
    return (int)cudaGetLastError();
}

template <bool kGray, bool kStaged>
int launch_rgb(const uint8_t* rgb, float* y, int* hist, int frames,
               int height, int width, int lo, int hi, int rows,
               cudaStream_t stream) {
    const RgbSrc<kGray, kStaged> src{
        rgb, y, height, width, lo, hi - lo, rows,
        (rows * width + kGroup - 1) / kGroup};
    return launch(hist256_kernel<RgbSrc<kGray, kStaged>>,
                  (int64_t)frames * src.per_frame, kThreads, stream, src,
                  hist, frames);
}

}  // namespace

extern "C" {

// Every function launches on `stream`, does not synchronise, allocates
// nothing, and returns the launch's cudaError_t (0 on success).

// y (frames, rows, width) f32, 16-byte aligned, rows * width % 4 == 0.
int fr_hist256(const float* y, int* hist, int frames, int rows, int width,
               cudaStream_t stream) {
    const PlaneSrc src{y, rows * width / 4};
    return launch(hist256_kernel<PlaneSrc>,
                  (int64_t)frames * src.per_frame, kVec * kThreads, stream,
                  src, hist, frames);
}

// rgb (frames, height, width, 3) uint8 → y (frames, rows, width) f32
// from rows [lo, hi), padded with -1, and its counts.
int fr_hist256_rgb(const uint8_t* rgb, float* y, int* hist, int frames,
                   int height, int width, int lo, int hi, int rows,
                   int grayscale, cudaStream_t stream) {
    const bool staged = width % kGroup == 0 &&
                        !(reinterpret_cast<uintptr_t>(rgb) & 15) &&
                        !(reinterpret_cast<uintptr_t>(y) & 15);
    auto go = grayscale
        ? (staged ? &launch_rgb<true, true> : &launch_rgb<true, false>)
        : (staged ? &launch_rgb<false, true> : &launch_rgb<false, false>);
    return go(rgb, y, hist, frames, height, width, lo, hi, rows, stream);
}

// y as fr_hist256's; eq the same shape; cum (frames, 256) f32.
int fr_cum_lookup(const float* y, const int* hist, float* eq, float* cum,
                  int frames, int rows, int width, cudaStream_t stream) {
    const int per_frame = rows * width / 4;
    return launch(cum_lookup_kernel, (int64_t)frames * per_frame,
                  8 * kVec * kThreads, stream, y, hist, eq, cum, frames,
                  per_frame);
}

}  // extern "C"
