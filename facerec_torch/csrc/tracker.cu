// The SORT tracker's block scan for Hopper (sm_90a): every frame of a
// block, in order, in one kernel launch of one CTA.  Built by
// facerec_torch/ops/_build.py into a shared library with a plain C
// interface and bound with ctypes (facerec_torch/track/tracker.py).
//
// Replaces facerec_tpu/track/tracker.py:227 (_run_block_impl, an XLA
// lax.scan of step :84), with the association of
// facerec_tpu/ops/assignment.py: the argmax fast path behind lax.cond
// (:176) and the Jonker-Volgenant solver in while_loops (:22-104).  It
// computes what facerec_torch/track/tracker.py:run_block_plain
// computes, frame by frame:
//   - the scene-cut kill and the Kalman predict of the followed slots;
//   - the D x T IoU matrix and the association: every active
//     detection's argmax when the maxima are unique and distinct, else
//     the JV solve on K = max(D, T) (always when D > T);
//   - the Joseph-form update through the 2x2-block inverse of S
//     (facerec_torch/ops/kalman.py:inv4), not a generic inverse;
//   - zeroing non-finite box_to_z rows, the unfollow rules, spawning
//     unmatched detections into free slots by rank, the emissions and
//     the overflow count.
//
// Bound.  A serial chain of B dependent frames (128 on the main path):
// each frame's association reads the Kalman state the frame before
// wrote, so the block is latency-bound.  Its bytes (detections and the
// state in, the state and the emissions out: 0.17 MB at B = 128,
// T = 32, D = 16) take 0.05 us at 3.35 TB/s, and its arithmetic (~3,100
// flops per matched slot per frame, ~17 per IoU pair) less at 67 TFLOP/s
// of float32; both bounds say little about a chain of dependent steps.
// What the design does about it: it shortens each frame's chain.
//   - one CTA of 8 threads per track slot (8 T rounded up to whole
//     warps, 1,024 at T = 128), the whole frame loop in the kernel: no
//     host round trip, no launch per frame;
//   - the block's detections, validity and scene flags are staged in
//     shared memory before the frame loop (in chunks of frames where
//     they do not fit), with every frame's box_to_z and detection area
//     computed there in parallel: the frame loop never waits on device
//     memory;
//   - thread (t, r) owns row r of slot t's covariance and x[r] in
//     registers; the predict exchanges rows by shuffles within the
//     slot's 8-lane segment, and the Joseph-form update spreads its
//     products over the rows, each row reading the slot's P and K rows
//     from shared memory;
//   - the D x T IoUs are spread over the CTA, a warp per valid
//     detection row (one to four slots a lane; an invalid row needs
//     none); each row's maximum is one __reduce_max_sync of order keys
//     and its argmax the first set bit of a ballot, so ties go to the
//     lower index, as torch.argmax / jnp.argmax break them; a second
//     active row on one slot shows in a shared atomic count per slot;
//   - the JV solve runs in warp 0 (rare: a tie, a collision or D > T),
//     a lane holding up to four columns and rows, while the other
//     warps wait at a barrier;
//   - spawn and free ranks are prefix counts over per-warp ballot words.
// Exactness.  Built with -fmad=false, so every float expression rounds
// as the plain version's separate tensor operations do: the IoUs, the
// utilities, the JV's reduced costs and the predict (its products are
// by 0 or 1).  Every element of the update's small matrix products is
// summed over m in index order by the row that owns it, as the plain
// version's (ops/kalman.py:_mm).  So the kernel's emissions and state
// are meant to be the plain version's bit for bit; a tie between two
// equally good assignments (a duplicated detection) is broken by those
// bits, the same way in both.
//
// Inputs: det_boxes (B, D, 4) f32, det_valid (B, D) u8, scene (B,) u8,
// frame0 () i32 (read on the card, so a captured graph replays), the
// state (x (T, 8) f32, p (T, 8, 8) f32, active (T,) u8, six (T,) i32
// counters, next_uid () i32).  Outputs: the new state in the same
// layout and the emissions (box (B, T, 4) f32, emit and detected
// (B, T) u8, uid and first_frame (B, T) i32, det_slot (B, D) i32,
// overflow (B,) i32).  T and D in 1..128.  Inputs and outputs must not
// overlap.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

// The launch's arguments, by value into the kernel (C layout: the
// wrapper's ctypes Structure mirrors it field for field).  At namespace
// scope: the C entry point below takes it, and a type of an unnamed
// namespace would give that entry point internal linkage.
struct ScanArgs {
    const float* det_boxes;
    const uint8_t* det_valid;
    const uint8_t* scene;
    const int* frame0;
    const float* x;
    const float* p;
    const uint8_t* active;
    const int* uid;
    const int* first_frame;
    const int* hist_len;
    const int* tsu;
    const int* hits;
    const int* initial_hits;
    const int* next_uid;
    float* x_out;
    float* p_out;
    uint8_t* active_out;
    int* uid_out;
    int* first_frame_out;
    int* hist_len_out;
    int* tsu_out;
    int* hits_out;
    int* initial_hits_out;
    int* next_uid_out;
    float* e_box;
    uint8_t* e_emit;
    uint8_t* e_detected;
    int* e_uid;
    int* e_first_frame;
    int* e_det_slot;
    int* e_overflow;
    int frames, tracks, dets, max_age, min_hits;
    float iou_threshold;
    float q[8];       // diagonals of Q, P0 and R (ops/kalman.py)
    float p0[8];
    float r[4];
};

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxSlots = 128;       // T and D; 8 threads a slot
constexpr int kMaxThreads = 8 * kMaxSlots;
constexpr int kNarrow = 256;         // the CTA up to T = 32
constexpr int kWords = kMaxSlots / 32;
constexpr int kCols = kMaxSlots / 32;    // JV columns (and rows) a lane
constexpr int kSlotScratch = 64 + 32 + 8;   // a slot's P, K and x
constexpr float kInf = 3.0e38f;      // the solver's "infinity" (_INF)
// dynamic shared memory a launch may take (of the SM's 227 KB)
constexpr size_t kSmemMax = 200 * 1024;

// torch.maximum / torch.minimum propagate NaN; fmaxf would drop it
__device__ __forceinline__ float tmax(float a, float b) {
    return (a != a || b != b) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
    return (a != a || b != b) ? NAN : fminf(a, b);
}
// clamp_min(0): NaN stays NaN
__device__ __forceinline__ float relu0(float a) { return a < 0.f ? 0.f : a; }

// a / b and sqrtf(a), the same bits, with a zero dividend or radicand
// (an empty slot's state, a box that misses another, a zero covariance
// entry) answered directly: the IEEE routines send it down their slow
// path, far longer on the frame's serial chain
__device__ __forceinline__ float qdiv(float a, float b) {
    if (a == 0.f && b != 0.f && isfinite(b))      // a signed zero
        return __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                              0x80000000);
    return a / b;
}
__device__ __forceinline__ float qsqrt(float a) {
    return a == 0.f ? a : sqrtf(a);                // sqrt(-0) = -0
}

// component k of v, k in 0..3 at run time (no local memory)
__device__ __forceinline__ float comp(float4 v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// ops/boxes.py:iou_broadcast of one (detection, prior) pair, with each
// box's area (x2 - x1) * (y2 - y1) computed once
__device__ __forceinline__ float iou(float4 a, float area_a, float4 b,
                                     float area_b) {
    const float x1 = tmax(a.x, b.x), y1 = tmax(a.y, b.y);
    const float x2 = tmin(a.z, b.z), y2 = tmin(a.w, b.w);
    const float inter = relu0(x2 - x1) * relu0(y2 - y1);
    const float uni = area_a + area_b - inter;
    return uni > 0.f ? qdiv(inter, uni) : 0.f;
}

// A key whose unsigned order is the float order (-0 as +0, so equal
// floats have equal keys; no NaN reaches it)
__device__ __forceinline__ unsigned order_key(float f) {
    const unsigned b = __float_as_uint(f + 0.f);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// ops/boxes.py:z_to_box
__device__ __forceinline__ float4 z_to_box(float z0, float z1, float z2,
                                           float z3) {
    const float w = qsqrt(relu0(z2 * z3));
    const float h = w > 0.f ? qdiv(z2, w) : 0.f;
    // halving is exact: * 0.5f is / 2.f
    return make_float4(z0 - w * 0.5f, z1 - h * 0.5f, z0 + w * 0.5f,
                       z1 + h * 0.5f);
}

// ops/boxes.py:box_to_z, non-finite components zeroed
__device__ __forceinline__ float4 box_to_z(float4 b) {
    const float w = b.z - b.x, h = b.w - b.y;
    float z[4] = {b.x + w * 0.5f, b.y + h * 0.5f, w * h, w / h};
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (!isfinite(z[k])) z[k] = 0.f;
    return make_float4(z[0], z[1], z[2], z[3]);
}

// 2x2 helpers, row-major [a b; c d]
__device__ __forceinline__ void inv2(const float* m, float* o) {
    const float det = m[0] * m[3] - m[1] * m[2];
    o[0] = qdiv(m[3], det);
    o[1] = qdiv(-m[1], det);
    o[2] = qdiv(-m[2], det);
    o[3] = qdiv(m[0], det);
}
__device__ __forceinline__ void mm2(const float* a, const float* b,
                                    float* o) {
    o[0] = a[0] * b[0] + a[1] * b[2];
    o[1] = a[0] * b[1] + a[1] * b[3];
    o[2] = a[2] * b[0] + a[3] * b[2];
    o[3] = a[2] * b[1] + a[3] * b[3];
}

// ops/kalman.py:inv4: the 2x2 block Schur complement
__device__ __forceinline__ void inv4(const float* s, float* o) {
    const float a[4] = {s[0], s[1], s[4], s[5]};
    const float b[4] = {s[2], s[3], s[6], s[7]};
    const float c[4] = {s[8], s[9], s[12], s[13]};
    const float d[4] = {s[10], s[11], s[14], s[15]};
    float ai[4], aib[4], cab[4], sch[4], si[4], ca[4], t1[4], t2[4], bl[4];
    inv2(a, ai);
    mm2(ai, b, aib);
    mm2(c, aib, cab);
#pragma unroll
    for (int k = 0; k < 4; ++k) sch[k] = d[k] - cab[k];
    inv2(sch, si);
    mm2(c, ai, ca);
    mm2(aib, si, t1);          // tl = ai + aib si (c ai); tr = -aib si
    mm2(t1, ca, t2);
    mm2(si, ca, bl);           // bl = -si (c ai)
    const int tl_at[4] = {0, 1, 4, 5}, tr_at[4] = {2, 3, 6, 7};
    const int bl_at[4] = {8, 9, 12, 13}, br_at[4] = {10, 11, 14, 15};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        o[tl_at[k]] = ai[k] + t2[k];
        o[tr_at[k]] = -t1[k];
        o[bl_at[k]] = -bl[k];
        o[br_at[k]] = si[k];
    }
}

// (I - K H)[i][m] from row i of K
__device__ __forceinline__ float ikh(int i, int m, const float* ki) {
    const float e = i == m ? 1.f : 0.f;
    return m < 4 ? e - ki[m] : e;
}

// Row `row` of ops/kalman.py:update (Joseph form) of one matched slot,
// run by the slot's 8 threads together (one 8-lane segment of a warp;
// every lane of the warp calls it, `matched` says which segments
// update).  sp: the slot's kSlotScratch floats of shared memory.
__device__ __forceinline__ void update_row(float (&P)[8], float& xr,
                                           int row, bool matched,
                                           float4 z4, const float (&r)[4],
                                           float* sp) {
    if (matched) {
        float4* prow = reinterpret_cast<float4*>(sp + row * 8);
        prow[0] = make_float4(P[0], P[1], P[2], P[3]);
        prow[1] = make_float4(P[4], P[5], P[6], P[7]);
        sp[96 + row] = xr;
    }
    __syncwarp();
    float k[4] = {0.f, 0.f, 0.f, 0.f};
    if (matched) {
        // S = H P H^T + R (rows 0..3 of P), inverted by every row
        float s[16], si[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float4 pr = *reinterpret_cast<const float4*>(sp + i * 8);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                s[i * 4 + j] = comp(pr, j) + (i == j ? r[i] : 0.f);
        }
        inv4(s, si);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float acc = P[0] * si[j];
#pragma unroll
            for (int m = 1; m < 4; ++m) acc = acc + P[m] * si[m * 4 + j];
            k[j] = acc;
        }
        *reinterpret_cast<float4*>(sp + 64 + row * 4) =
            make_float4(k[0], k[1], k[2], k[3]);
    }
    __syncwarp();
    if (!matched) return;
    const float4 x4 = *reinterpret_cast<const float4*>(sp + 96);
    const float y[4] = {z4.x - x4.x, z4.y - x4.y, z4.z - x4.z, z4.w - x4.w};
    float ky = k[0] * y[0];
#pragma unroll
    for (int m = 1; m < 4; ++m) ky = ky + k[m] * y[m];
    xr = xr + ky;
    // a = (I - K H)[row] P, each element summed over m in order
    float a[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
        const float4 lo = *reinterpret_cast<const float4*>(sp + m * 8);
        const float4 hi = *reinterpret_cast<const float4*>(sp + m * 8 + 4);
        const float pm[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const float e = ikh(row, m, k);
#pragma unroll
        for (int j = 0; j < 8; ++j)
            a[j] = m == 0 ? e * pm[j] : a[j] + e * pm[j];
    }
    // P[row][j] = a (I - K H)[j]^T + (K R)[row] K[j]^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float4 kj4 = *reinterpret_cast<const float4*>(sp + 64 + j * 4);
        const float kj[4] = {kj4.x, kj4.y, kj4.z, kj4.w};
        float b = a[0] * ikh(j, 0, kj);
#pragma unroll
        for (int m = 1; m < 8; ++m) b = b + a[m] * ikh(j, m, kj);
        float c = (k[0] * r[0]) * kj[0];
#pragma unroll
        for (int m = 1; m < 4; ++m) c = c + (k[m] * r[m]) * kj[m];
        P[j] = b + c;
    }
}

// a[c] for a warp-uniform c, kept in registers (no local memory)
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[kCols], int c) {
    V v = a[0];
#pragma unroll
    for (int k = 1; k < kCols; ++k)
        if (c == k) v = a[k];
    return v;
}
template <typename V>
__device__ __forceinline__ void put(V (&a)[kCols], int c, V v) {
#pragma unroll
    for (int k = 0; k < kCols; ++k)
        if (c == k) a[k] = v;
}

// Warp argmin of (v, i) pairs, the lower index winning a tie: the least
// order key, then the least index holding it (two __reduce_*_sync in
// place of a tree of shuffles), then its value from the lane holding it
// (-0 and +0 share a key).  The caller's i is its lane's argmin.
__device__ __forceinline__ void argmin_lo(float& v, int& i) {
    const unsigned key = order_key(v);
    const unsigned least = __reduce_min_sync(kAll, key);
    i = __reduce_min_sync(kAll, key == least ? i : 0x7fffffff);
    v = __shfl_sync(kAll, v, i & 31);
}

// Index of the n-th (from 0) set bit of mask; the caller guarantees it.
__device__ __forceinline__ int nth_bit(unsigned mask, int n) {
    for (int r = 0; r < n; ++r) mask &= mask - 1u;
    return __ffs(mask) - 1;
}
// Set bits of words[] before bit i.
__device__ __forceinline__ int rank_of(const unsigned* words, int i) {
    int r = __popc(words[i >> 5] & ((1u << (i & 31)) - 1u));
    for (int w = 0; w < (i >> 5); ++w) r += __popc(words[w]);
    return r;
}
// Index of the n-th (from 0) set bit of words[]; the caller guarantees it.
__device__ __forceinline__ int nth_of(const unsigned* words, int n) {
    int w = 0;
    for (int c = __popc(words[0]); n >= c; c = __popc(words[++w])) n -= c;
    return 32 * w + nth_bit(words[w], n);
}

// ops/assignment.py:solve_lap_min on cost = -(utility padded with -2),
// K x K, in one warp.  Lane l holds columns and rows l + 32 c (c <
// kCols): each column's v, min_val, path, row4col and scanned flag, each
// row's u, col4row and scanned flag.  Writes col4row of rows < D to
// c4r; mv is K floats of scratch.
__device__ void solve_lap(const float* util, int D, int T, int K, int lane,
                          float* mv, int* c4r) {
    auto cost = [&](int i, int j) -> float {
        return -((i < D && j < T) ? util[i * T + j] : -2.f);
    };
    float u[kCols], v[kCols], min_val[kCols];
    int col4row[kCols], row4col[kCols], path[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
        u[c] = v[c] = 0.f;
        col4row[c] = row4col[c] = -1;
    }
    for (int cur = 0; cur < K; ++cur) {
        float min_cur = 0.f;
        unsigned srow = 0u, scol = 0u;      // bit c: row / column l + 32c
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            min_val[c] = kInf;
            path[c] = -1;
        }
        int i = cur, sink = 0;
        while (true) {
            if ((i & 31) == lane) srow |= 1u << (i >> 5);
            const float ui = __shfl_sync(kAll, pick(u, i >> 5), i & 31);
            // this lane's least column, the lower index on a tie; past
            // K: +inf, above every real column's value
            float m = INFINITY;
            int jm = lane + 32 * kCols;
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                const int j = lane + 32 * c;
                if (j < K) {
                    const bool remaining = !((scol >> c) & 1u);
                    const float reduced = min_cur + cost(i, j) - ui - v[c];
                    if (remaining && reduced < min_val[c]) {
                        min_val[c] = reduced;
                        path[c] = i;
                    }
                    const float mc = remaining ? min_val[c] : kInf;
                    if (mc < m) {
                        m = mc;
                        jm = j;
                    }
                }
            }
            argmin_lo(m, jm);
            min_cur = m;
            if ((jm & 31) == lane) scol |= 1u << (jm >> 5);
            const int owner = __shfl_sync(kAll, pick(row4col, jm >> 5),
                                          jm & 31);
            if (owner < 0) {
                sink = jm;
                break;
            }
            i = owner;
        }
        // dual updates (keep reduced costs non-negative)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
            if (lane + 32 * c < K) mv[lane + 32 * c] = min_val[c];
        __syncwarp();
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            const int row = lane + 32 * c;
            if (row == cur) {
                u[c] = u[c] + min_cur;
            } else if ((srow >> c) & 1u) {
                const int assigned = min(max(col4row[c], 0), K - 1);
                u[c] = u[c] + min_cur - mv[assigned];
            }
            if ((scol >> c) & 1u) v[c] = v[c] - (min_cur - min_val[c]);
        }
        __syncwarp();
        // augment along the alternating path ending at the sink
        int j = sink;
        while (true) {
            const int row = __shfl_sync(kAll, pick(path, j >> 5), j & 31);
            const int j_next = __shfl_sync(kAll, pick(col4row, row >> 5),
                                           row & 31);
            if ((j & 31) == lane) put(row4col, j >> 5, row);
            if ((row & 31) == lane) put(col4row, row >> 5, j);
            if (row == cur) break;
            j = j_next;
        }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
        if (lane + 32 * c < D) c4r[lane + 32 * c] = col4row[c];
}

// Byte offsets of the dynamic shared memory, for T slots, D detections
// and `chunk` staged frames (the host sizes the launch with it).
struct Layout {
    size_t box, dz, prior, scratch, area, parea, mv, was, best, c4r,
        dslot, match, cnt, fm, um, flag, valid, scene, bytes;
};

__host__ __device__ inline Layout layout(int T, int D, int chunk) {
    Layout l;
    size_t at = 0;
    auto take = [&at](size_t n, size_t align) {
        at = (at + align - 1) / align * align;
        const size_t o = at;
        at += n;
        return o;
    };
    const size_t cd = (size_t)chunk * D;
    l.box = take(cd * 16, 16);          // float4 boxes [chunk][D]
    l.dz = take(cd * 16, 16);           // float4 box_to_z [chunk][D]
    l.prior = take((size_t)T * 16, 16); // float4 prior box by slot
    // the utility matrix (D, T) until the slots are known, then each
    // slot's P, K and x for its update
    const size_t util = (size_t)D * T, upd = (size_t)T * kSlotScratch;
    l.scratch = take((util > upd ? util : upd) * 4, 16);
    l.area = take(cd * 4, 4);           // detection areas [chunk][D]
    l.parea = take((size_t)T * 4, 4);   // prior areas
    l.mv = take((size_t)(T > D ? T : D) * 4, 4);   // JV min_val
    l.was = take((size_t)T * 4, 4);     // slot followed this frame
    l.best = take((size_t)D * 4, 4);    // fast-path slot by detection
    l.c4r = take((size_t)D * 4, 4);     // JV column by detection
    l.dslot = take((size_t)D * 4, 4);   // matched slot by detection
    l.match = take((size_t)T * 4, 4);   // matched detection by slot
    l.cnt = take((size_t)T * 4, 4);     // active rows whose argmax it is
    l.fm = take(kWords * 4, 4);         // free slots, a bit each
    l.um = take(kWords * 4, 4);         // unmatched valid detections
    l.flag = take(4, 4);                // a tie or a collision: JV
    l.valid = take(cd, 1);              // [chunk][D]
    l.scene = take((size_t)chunk, 1);
    l.bytes = (at + 15) / 16 * 16;
    return l;
}

// kThreads: the launch's largest CTA (256 up to T = 32: registers
// unbounded, no spills; 1,024 beyond: 64 registers a thread)
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
tracker_scan_kernel(const ScanArgs a, int chunk) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int T = a.tracks, D = a.dets, K = max(T, D), B = a.frames;
    const Layout L = layout(T, D, chunk);
    float4* s_box = reinterpret_cast<float4*>(smem + L.box);
    float4* s_dz = reinterpret_cast<float4*>(smem + L.dz);
    float4* s_prior = reinterpret_cast<float4*>(smem + L.prior);
    float* s_scr = reinterpret_cast<float*>(smem + L.scratch);
    float* s_area = reinterpret_cast<float*>(smem + L.area);
    float* s_parea = reinterpret_cast<float*>(smem + L.parea);
    float* s_mv = reinterpret_cast<float*>(smem + L.mv);
    int* s_was = reinterpret_cast<int*>(smem + L.was);
    int* s_best = reinterpret_cast<int*>(smem + L.best);
    int* s_c4r = reinterpret_cast<int*>(smem + L.c4r);
    int* s_dslot = reinterpret_cast<int*>(smem + L.dslot);
    int* s_match = reinterpret_cast<int*>(smem + L.match);
    int* s_cnt = reinterpret_cast<int*>(smem + L.cnt);
    unsigned* s_fm = reinterpret_cast<unsigned*>(smem + L.fm);
    unsigned* s_um = reinterpret_cast<unsigned*>(smem + L.um);
    int* s_flag = reinterpret_cast<int*>(smem + L.flag);
    uint8_t* s_valid = smem + L.valid;
    uint8_t* s_scene = smem + L.scene;

    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
    // thread (slot, row): row `row` of slot `slot`'s state
    const int slot = tid >> 3, row = tid & 7;
    const bool owner = slot < T;
    // this row's entries of Q's and P0's diagonals, and R's diagonal
    float q_r = a.q[0], p0_r = a.p0[0];
#pragma unroll
    for (int k = 1; k < 8; ++k)
        if (row == k) {
            q_r = a.q[k];
            p0_r = a.p0[k];
        }
    const float r[4] = {a.r[0], a.r[1], a.r[2], a.r[3]};

    float xr = 0.f, P[8];
    bool active = false;
    int uid = -1, first = 0, hist = 0, tsu = 0, hits = 0, ih = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) P[j] = 0.f;
    if (owner) {
        xr = a.x[slot * 8 + row];
#pragma unroll
        for (int j = 0; j < 8; ++j) P[j] = a.p[slot * 64 + row * 8 + j];
        active = a.active[slot] != 0;
        uid = a.uid[slot];
        first = a.first_frame[slot];
        hist = a.hist_len[slot];
        tsu = a.tsu[slot];
        hits = a.hits[slot];
        ih = a.initial_hits[slot];
    }
    int next_uid = *a.next_uid;
    const int frame0 = *a.frame0;

    for (int c0 = 0; c0 < B; c0 += chunk) {
        const int nf = min(chunk, B - c0);
        __syncthreads();    // the previous chunk's frames are done
        // stage the chunk's detections, their box_to_z and areas
#pragma unroll 4
        for (int i = tid; i < nf * D; i += nt) {
            const float* g = a.det_boxes + ((size_t)c0 * D + i) * 4;
            const float4 b = make_float4(g[0], g[1], g[2], g[3]);
            s_box[i] = b;
            s_dz[i] = box_to_z(b);
            s_area[i] = (b.z - b.x) * (b.w - b.y);
            s_valid[i] = a.det_valid[(size_t)c0 * D + i];
        }
        for (int i = tid; i < nf; i += nt) s_scene[i] = a.scene[c0 + i];
        __syncthreads();

        for (int fl = 0; fl < nf; ++fl) {
            const int f = c0 + fl, frame = frame0 + f, at0 = fl * D;

            // 1-2. scene-cut kill, predict the followed slots: rows
            // 0..3 add rows 4..7 (F = I + upper identity at offset 4)
            const bool was = active && s_scene[fl] == 0;
            const float xu = __shfl_up_sync(kAll, xr, 4, 8);
            if (was && row >= 6 && xr + xu < 1e-3f) xr = 0.f;
            const float xd = __shfl_down_sync(kAll, xr, 4, 8);
            float Pd[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                Pd[j] = __shfl_down_sync(kAll, P[j], 4, 8);
            if (was) {
                if (row < 4) xr = xr + xd;
                float fp[8];
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    fp[j] = row < 4 ? P[j] + Pd[j] : P[j];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const float v = j < 4 ? fp[j] + fp[j + 4] : fp[j];
                    P[j] = v + (row == j ? q_r : 0.f);
                }
                ++tsu;
                ++hist;
            }
            const float z0 = __shfl_sync(kAll, xr, 0, 8);
            const float z1 = __shfl_sync(kAll, xr, 1, 8);
            const float z2 = __shfl_sync(kAll, xr, 2, 8);
            const float z3 = __shfl_sync(kAll, xr, 3, 8);
            if (owner && row == 0) {
                const float4 pb = z_to_box(z0, z1, z2, z3);
                s_prior[slot] = pb;
                s_parea[slot] = (pb.z - pb.x) * (pb.w - pb.y);
                s_was[slot] = was;
                s_match[slot] = -1;
                s_cnt[slot] = 0;
            }
            if (tid == 0) *s_flag = 0;
            __syncthreads();

            // 3. utilities, a warp per detection row: the IoU against
            // every followed slot, the row's maximum (a shuffle-free
            // reduction of order keys), its first slot and how many
            // share it, whether any pair passes; a tie or a second
            // active row on one slot flags the JV solve.  An invalid
            // detection's row is -1 throughout and never active.
            for (int d = warp; d < D; d += nwarps) {
                float* urow = s_scr + d * T;
                const bool dv = s_valid[at0 + d] != 0;
                const float4 db = s_box[at0 + d];
                const float da = s_area[at0 + d];
                if (!dv) {
                    for (int t = lane; t < T; t += 32) urow[t] = -1.f;
                    if (lane == 0) s_best[d] = -1;
                    continue;
                }
                unsigned key[kCols], top = 0u;
                bool ok_any = false;
#pragma unroll
                for (int c = 0; c < kCols; ++c) {
                    const int t = lane + 32 * c;
                    key[c] = 0u;            // below every utility's key
                    if (t < T) {
                        const bool was_t = s_was[t] != 0;
                        const float4 pb = s_prior[t];
                        const float pa = s_parea[t];
                        float u = -1.f;
                        if (was_t) {
                            const float v = iou(db, da, pb, pa);
                            if (v >= a.iou_threshold) {
                                u = v;
                                ok_any = true;
                            }
                        }
                        urow[t] = u;
                        key[c] = order_key(u);
                        top = max(top, key[c]);
                    }
                }
                top = __reduce_max_sync(kAll, top);
                int n_best = 0, bt = -1;
#pragma unroll
                for (int c = 0; c < kCols; ++c) {
                    if (32 * c >= T) break;
                    const unsigned eq = __ballot_sync(kAll, key[c] == top);
                    n_best += __popc(eq);
                    if (bt < 0 && eq) bt = 32 * c + __ffs(eq) - 1;
                }
                const bool row_active = __any_sync(kAll, ok_any);
                if (lane == 0) {
                    s_best[d] = row_active ? bt : -1;
                    if (row_active &&
                        (n_best > 1 || atomicAdd(&s_cnt[bt], 1) > 0))
                        *s_flag = 1;
                }
            }
            __syncthreads();
            const bool fast = D <= T && *s_flag == 0;

            // 4. the association: the argmaxes, or the JV solve; each
            // detection's slot, the unmatched and the free as bit words
            if (!fast) {
                if (warp == 0) solve_lap(s_scr, D, T, K, lane, s_mv, s_c4r);
                __syncthreads();
            }
            for (int w = warp; w * 32 < D; w += nwarps) {
                const int d = w * 32 + lane;
                bool unmatched = false;
                if (d < D) {
                    const bool dv = s_valid[at0 + d] != 0;
                    int sl = s_best[d];
                    if (!fast) {
                        const int c = s_c4r[d];
                        sl = c < T && dv && s_scr[d * T + c] >= 0.f ? c : -1;
                    }
                    if (sl >= 0) s_match[sl] = d;
                    s_dslot[d] = sl;
                    unmatched = dv && sl < 0;
                }
                const unsigned um = __ballot_sync(kAll, unmatched);
                if (lane == 0) s_um[w] = um;
            }
            for (int w = warp; w * 32 < T; w += nwarps) {
                const int t = w * 32 + lane;
                const unsigned fm = __ballot_sync(kAll, t < T && !s_was[t]);
                if (lane == 0) s_fm[w] = fm;
            }
            __syncthreads();

            // 5. update the matched slots' posteriors (the utilities'
            // shared memory is free again)
            const int md = owner ? s_match[slot] : -1;
            const bool matched = md >= 0;
            update_row(P, xr, row, matched,
                       matched ? s_dz[at0 + md] : make_float4(0, 0, 0, 0),
                       r, s_scr + (owner ? slot : 0) * kSlotScratch);
            if (matched) {
                ++hits;
                tsu = 0;
                if (hist == hits) ++ih;
            }

            // 6. unfollow rules, then spawn: the r-th unmatched detection
            // takes the r-th free slot
            const bool expired = was && tsu > a.max_age &&
                                 hist >= a.min_hits;
            const bool not_started = was && hist <= a.min_hits && ih < hist;
            const bool still = was && !(expired || not_started);
            int n_free = 0, n_um = 0;
            for (int w = 0; w * 32 < T; ++w) n_free += __popc(s_fm[w]);
            for (int w = 0; w * 32 < D; ++w) n_um += __popc(s_um[w]);
            const int n_spawn = min(n_um, n_free);
            const int free_rank = owner && !was ? rank_of(s_fm, slot) : T;
            const bool spawned = free_rank < n_spawn;
            if (spawned) {
                const float4 z = s_dz[at0 + nth_of(s_um, free_rank)];
                xr = row < 4 ? comp(z, row) : 0.f;
#pragma unroll
                for (int j = 0; j < 8; ++j) P[j] = row == j ? p0_r : 0.f;
                uid = next_uid + free_rank;
                first = frame;
                hist = hits = ih = 1;
                tsu = 0;
            }
            active = still || spawned;

            // emissions
            const float e0 = __shfl_sync(kAll, xr, 0, 8);
            const float e1 = __shfl_sync(kAll, xr, 1, 8);
            const float e2 = __shfl_sync(kAll, xr, 2, 8);
            const float e3 = __shfl_sync(kAll, xr, 3, 8);
            if (owner) {
                const size_t at = (size_t)f * T + slot;
                if (row == 0) {
                    const float4 eb = z_to_box(e0, e1, e2, e3);
                    float* o = a.e_box + at * 4;
                    o[0] = eb.x;
                    o[1] = eb.y;
                    o[2] = eb.z;
                    o[3] = eb.w;
                } else if (row == 1) {
                    a.e_emit[at] = was || spawned;
                } else if (row == 2) {
                    a.e_detected[at] = matched || spawned;
                } else if (row == 3) {
                    a.e_uid[at] = uid;
                } else if (row == 4) {
                    a.e_first_frame[at] = first;
                }
            }
            for (int d = tid; d < D; d += nt) {
                int sl = s_dslot[d];
                if (s_valid[at0 + d] && sl < 0) {
                    const int rank = rank_of(s_um, d);
                    if (rank < n_free) sl = nth_of(s_fm, rank);
                }
                a.e_det_slot[(size_t)f * D + d] = sl;
            }
            if (tid == 0) a.e_overflow[f] = n_um - n_spawn;
            next_uid += n_spawn;
            __syncthreads();    // the shared tables are rewritten next frame
        }
    }

    if (owner) {
        a.x_out[slot * 8 + row] = xr;
#pragma unroll
        for (int j = 0; j < 8; ++j) a.p_out[slot * 64 + row * 8 + j] = P[j];
        if (row == 0) {
            a.active_out[slot] = active;
            a.uid_out[slot] = uid;
            a.first_frame_out[slot] = first;
            a.hist_len_out[slot] = hist;
            a.tsu_out[slot] = tsu;
            a.hits_out[slot] = hits;
            a.initial_hits_out[slot] = ih;
        }
    }
    if (tid == 0) *a.next_uid_out = next_uid;
}

}  // namespace

extern "C" {

// Launches one CTA of 8 threads per slot (whole warps) on `stream`, does
// not synchronise, allocates nothing; returns the launch's cudaError_t
// (0 on success), or cudaErrorInvalidValue for T or D outside 1..128.
int fr_tracker_scan(const ScanArgs* args, cudaStream_t stream) {
    const int T = args->tracks, D = args->dets, B = args->frames;
    if (T < 1 || T > kMaxSlots || D < 1 || D > kMaxSlots || B < 0)
        return (int)cudaErrorInvalidValue;
    // as many frames a chunk as fit, at least one
    const size_t fixed = layout(T, D, 0).bytes;
    int chunk = (int)((kSmemMax - fixed) / ((size_t)D * 37 + 1));
    chunk = chunk < B ? chunk : B;
    chunk = chunk > 1 ? chunk : 1;
    while (chunk > 1 && layout(T, D, chunk).bytes > kSmemMax) --chunk;
    const int threads = (8 * T + 31) / 32 * 32;
    const size_t bytes = layout(T, D, chunk).bytes;
    // above 48 KB of shared memory: opt in once per process and kernel
    static bool opted_in[2] = {false, false};
    const bool wide = threads > kNarrow;
    auto kernel = wide ? tracker_scan_kernel<kMaxThreads>
                       : tracker_scan_kernel<kNarrow>;
    if (!opted_in[wide]) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)kSmemMax);
        if (e != cudaSuccess) return (int)e;
        opted_in[wide] = true;
    }
    kernel<<<1, threads, bytes, stream>>>(*args, chunk);
    return (int)cudaGetLastError();
}

}  // extern "C"
