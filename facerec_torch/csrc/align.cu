// Five-point face alignment of ArcFace's crops, for Hopper (sm_90a).
// Built by facerec_torch/ops/_build.py (without fused multiply-adds)
// into a shared library with a plain C interface and bound with ctypes
// (facerec_torch/ops/align.py, which holds the plain version).
//
// Replaces no TPU kernel: the JAX package embeds box crops only
// (facerec_tpu/ops/crops.py:crop_resize, two matrix products).  This
// crop is insightface's face_align.norm_crop, a similarity warp, which
// no pair of separable resampling products can compute.
//
// Per crop n: the frame frames[frame_idx[n]] (H, W, 3) uint8, the five
// landmarks landmarks[n] (5, 2) float32 in frame pixels.  The kernel
// solves the least-squares similarity x -> [[p, -q], [q, p]] x + t onto
// insightface's 112-px template in float64 (Umeyama's solution in two
// dimensions, in closed form; a set whose spread sum |a - mean|^2 is
// below 1e-6 px^2 takes p = 1, q = 0), inverts it as
// cv2.invertAffineTransform does, and writes out[n] (3, 112, 112)
// float32: output pixel (x, y) of channel c is the bilinear value at
// the inverse map of (x, y, 1), integer pixel centres, a tap outside
// the frame reading 0 (cv2.warpAffine, BORDER_CONSTANT 0, at the exact
// point), scaled as (v - 127.5) / 127.5.  The arithmetic is float64
// throughout, in the plain version's order of operations.
//
// Bound: device-memory bytes.  A crop writes 150,528 bytes of float32
// and reads its 40 bytes of landmarks and the few KB of frame pixels
// under it (the face's box, about 35x40 px in the crowd's traffic, read
// through L1/L2): at 3.35 TB/s a 64-crop batch needs ~2.9 us.  What the
// design does about it:
//   - 7 CTAs a crop, each 16 rows of the output (1,792 pixels, 7 a
//     thread at 256 threads), so a 64-crop batch fills the card's 132
//     SMs 3.4 times over;
//   - neighbouring threads write neighbouring pixels of one channel
//     plane, so every store is coalesced;
//   - each thread solves the similarity itself from the 10 landmark
//     floats (a broadcast read): a few hundred float64 operations, no
//     shared memory and no barrier;
//   - the taps are byte loads of the uint8 frame: a face's pixels sit in
//     a few cache lines that the CTA's threads share.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSize = 112;
constexpr int kPoints = 5;
constexpr int kThreads = 256;
constexpr int kSplit = 7;                 // CTAs a crop
constexpr int kRows = kSize / kSplit;     // output rows a CTA
static_assert(kRows * kSplit == kSize, "the CTAs tile the crop's rows");
constexpr double kDegenerate = 1e-6;      // px^2

__constant__ double kTemplate[kPoints][2] = {
    {38.2946, 51.6963}, {73.5318, 51.5014}, {56.0252, 71.7366},
    {41.5493, 92.3655}, {70.7299, 92.2041}};

struct Inverse {
    double a11, a12, b1, a21, a22, b2;
};

// The inverse map (crop pixel -> frame point) of one crop's similarity,
// in facerec_torch/ops/align.py:inverse_maps' order of operations.
__device__ Inverse inverse_map(const float* ldm) {
    double mx = 0.0, my = 0.0, dmx = 0.0, dmy = 0.0;
    for (int i = 0; i < kPoints; ++i) {
        mx = mx + (double)ldm[2 * i];
        my = my + (double)ldm[2 * i + 1];
        dmx = dmx + kTemplate[i][0];
        dmy = dmy + kTemplate[i][1];
    }
    mx = mx / kPoints;
    my = my / kPoints;
    dmx = dmx / kPoints;
    dmy = dmy / kPoints;
    double s = 0.0, a = 0.0, b = 0.0;
    for (int i = 0; i < kPoints; ++i) {
        const double ax = (double)ldm[2 * i] - mx;
        const double ay = (double)ldm[2 * i + 1] - my;
        const double bx = kTemplate[i][0] - dmx;
        const double by = kTemplate[i][1] - dmy;
        s = s + (ax * ax + ay * ay);
        a = a + (ax * bx + ay * by);
        b = b + (ax * by - ay * bx);
    }
    const bool ok = s >= kDegenerate;
    const double p = ok ? a / s : 1.0;
    const double q = ok ? b / s : 0.0;
    const double tx = dmx - (p * mx - q * my);
    const double ty = dmy - (q * mx + p * my);
    const double d = 1.0 / (p * p + q * q);
    Inverse m;
    m.a11 = p * d;
    m.a12 = q * d;
    m.a21 = -q * d;
    m.a22 = p * d;
    m.b1 = -(m.a11 * tx) - m.a12 * ty;
    m.b2 = -(m.a21 * tx) - m.a22 * ty;
    return m;
}

__global__ void __launch_bounds__(kThreads)
align_warp_kernel(const uint8_t* __restrict__ frames,
                  const int64_t* __restrict__ frame_idx,
                  const float* __restrict__ landmarks,
                  float* __restrict__ out, int n_frames, int height,
                  int width) {
    const int n = blockIdx.x / kSplit;
    const int row0 = (blockIdx.x % kSplit) * kRows;
    const Inverse m = inverse_map(landmarks + (int64_t)n * 2 * kPoints);
    const int64_t f = frame_idx[n];
    const bool frame_ok = f >= 0 && f < n_frames;
    const uint8_t* src = frames + (frame_ok ? f : 0) * height * width * 3;
    float* dst = out + (int64_t)n * 3 * kSize * kSize;

    for (int k = threadIdx.x; k < kRows * kSize; k += kThreads) {
        const int y = row0 + k / kSize;
        const int x = k % kSize;
        const double sx = m.a11 * (double)x + m.a12 * (double)y + m.b1;
        const double sy = m.a21 * (double)x + m.a22 * (double)y + m.b2;
        const double x0 = floor(sx), y0 = floor(sy);
        const double fx = sx - x0, fy = sy - y0;
        const double gx = 1.0 - fx, gy = 1.0 - fy;
        double tap[2][2][3];
        for (int dy = 0; dy < 2; ++dy) {
            for (int dx = 0; dx < 2; ++dx) {
                const double yy = y0 + dy, xx = x0 + dx;
                const bool in = frame_ok && yy >= 0.0 && yy < height &&
                                xx >= 0.0 && xx < width;
                const uint8_t* px =
                    src + ((int64_t)(in ? yy : 0.0) * width +
                           (int64_t)(in ? xx : 0.0)) * 3;
                for (int c = 0; c < 3; ++c)
                    tap[dy][dx][c] = in ? (double)px[c] : 0.0;
            }
        }
        for (int c = 0; c < 3; ++c) {
            const double top = gx * tap[0][0][c] + fx * tap[0][1][c];
            const double bot = gx * tap[1][0][c] + fx * tap[1][1][c];
            const double v = gy * top + fy * bot;
            dst[(c * kSize + y) * kSize + x] = (float)((v - 127.5) / 127.5);
        }
    }
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, allocates nothing, and
// returns the launch's cudaError_t (0 on success).  frames (n_frames,
// height, width, 3) uint8; frame_idx (n,) int64; landmarks (n, 5, 2)
// float32; out (n, 3, 112, 112) float32; all contiguous.  A crop whose
// frame index lies outside [0, n_frames) reads 0 at every tap.
int fr_align_warp(const uint8_t* frames, const int64_t* frame_idx,
                  const float* landmarks, float* out, int n, int n_frames,
                  int height, int width, cudaStream_t stream) {
    if (n <= 0) return 0;
    align_warp_kernel<<<(unsigned)n * kSplit, kThreads, 0, stream>>>(
        frames, frame_idx, landmarks, out, n_frames, height, width);
    return (int)cudaGetLastError();
}

}  // extern "C"
