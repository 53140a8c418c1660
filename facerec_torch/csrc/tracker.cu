// The SORT tracker's block scan for Hopper (sm_90a): every frame of a
// block, in order, in one kernel launch.  Built by
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
// of float32; both bounds say little about a chain of warp-synchronous
// steps.
// What the design does about it:
//   - one CTA of one warp per tracker state, the whole frame loop in
//     the kernel: no host round trip, no launch per frame;
//   - lane t owns track slot t (T <= 32): its 8-vector and 8x8
//     covariance stay in registers across the block, so the predict and
//     the update are per-lane straight-line code;
//   - lane d owns detection d (D <= 32) for its IoU row, its argmax and
//     its spawn rank; argmax and argmin break ties toward the lower
//     index, as torch.argmax / jnp.argmax do (a tie broken the other
//     way changes det_slot);
//   - spawn and free ranks are __ballot_sync / __popc prefix counts;
//   - the JV solve runs in the same warp, a lane a column (and a row):
//     each search step is one reduced-cost update and one shuffle
//     argmin, the augmenting path a chain of shuffles.
// Exactness.  Built with -fmad=false, so every float expression rounds
// as the plain version's separate tensor operations do: the IoUs, the
// utilities, the JV's reduced costs and the predict (its products are
// by 0 or 1).  The update's small matrix products are summed in index
// order, as the plain version's (ops/kalman.py:_mm).  So the kernel's
// emissions and state are meant to be the plain version's bit for bit;
// a tie between two equally good assignments (a duplicated detection)
// is broken by those bits, the same way in both.
//
// Inputs: det_boxes (B, D, 4) f32, det_valid (B, D) u8, scene (B,) u8,
// frame0 () i32 (read on the card, so a captured graph replays), the
// state (x (T, 8) f32, p (T, 8, 8) f32, active (T,) u8, six (T,) i32
// counters, next_uid () i32).  Outputs: the new state in the same
// layout and the emissions (box (B, T, 4) f32, emit and detected
// (B, T) u8, uid and first_frame (B, T) i32, det_slot (B, D) i32,
// overflow (B,) i32).  Inputs and outputs must not overlap.

#include <cuda_runtime.h>
#include <math.h>
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
constexpr int kLanes = 32;
constexpr float kInf = 3.0e38f;      // the solver's "infinity" (_INF)

// torch.maximum / torch.minimum propagate NaN; fmaxf would drop it
__device__ __forceinline__ float tmax(float a, float b) {
    return (a != a || b != b) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
    return (a != a || b != b) ? NAN : fminf(a, b);
}
// clamp_min(0): NaN stays NaN
__device__ __forceinline__ float relu0(float a) { return a < 0.f ? 0.f : a; }

// ops/boxes.py:iou_broadcast of one (detection, prior) pair
__device__ __forceinline__ float iou(const float* a, const float* b) {
    const float x1 = tmax(a[0], b[0]), y1 = tmax(a[1], b[1]);
    const float x2 = tmin(a[2], b[2]), y2 = tmin(a[3], b[3]);
    const float inter = relu0(x2 - x1) * relu0(y2 - y1);
    const float area_a = (a[2] - a[0]) * (a[3] - a[1]);
    const float area_b = (b[2] - b[0]) * (b[3] - b[1]);
    const float uni = area_a + area_b - inter;
    return uni > 0.f ? inter / uni : 0.f;
}

// ops/boxes.py:z_to_box
__device__ __forceinline__ void z_to_box(const float* z, float* box) {
    const float w = sqrtf(relu0(z[2] * z[3]));
    const float h = w > 0.f ? z[2] / w : 0.f;
    box[0] = z[0] - w / 2.f;
    box[1] = z[1] - h / 2.f;
    box[2] = z[0] + w / 2.f;
    box[3] = z[1] + h / 2.f;
}

// ops/boxes.py:box_to_z, non-finite components zeroed
__device__ __forceinline__ void box_to_z(const float* b, float* z) {
    const float w = b[2] - b[0], h = b[3] - b[1];
    z[0] = b[0] + w / 2.f;
    z[1] = b[1] + h / 2.f;
    z[2] = w * h;
    z[3] = w / h;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (!isfinite(z[k])) z[k] = 0.f;
}

// ops/kalman.py:predict.  F = I + (upper identity at offset 4), so every
// product is by 0 or 1 and each entry takes a single rounded sum.
__device__ __forceinline__ void predict(float (&x)[8], float (&P)[64],
                                        const float* q) {
    if (x[6] + x[2] < 1e-3f) x[6] = 0.f;
    if (x[7] + x[3] < 1e-3f) x[7] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = x[i] + x[i + 4];
    float fp[64];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            fp[i * 8 + j] = i < 4 ? P[i * 8 + j] + P[(i + 4) * 8 + j]
                                  : P[i * 8 + j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float v = j < 4 ? fp[i * 8 + j] + fp[i * 8 + j + 4]
                                  : fp[i * 8 + j];
            P[i * 8 + j] = v + (i == j ? q[i] : 0.f);
        }
}

// 2x2 helpers, row-major [a b; c d]
__device__ __forceinline__ void inv2(const float* m, float* o) {
    const float det = m[0] * m[3] - m[1] * m[2];
    o[0] = m[3] / det;
    o[1] = -m[1] / det;
    o[2] = -m[2] / det;
    o[3] = m[0] / det;
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

// ops/kalman.py:update of one matched slot (Joseph form)
__device__ __forceinline__ void update(float (&x)[8], float (&P)[64],
                                       const float* z, const float* r) {
    float y[4], s[16], si[16], k[32];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = z[i] - x[i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            s[i * 4 + j] = P[i * 8 + j] + (i == j ? r[i] : 0.f);
    inv4(s, si);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float acc = P[i * 8] * si[j];
#pragma unroll
            for (int m = 1; m < 4; ++m) acc = acc + P[i * 8 + m] * si[m * 4 + j];
            k[i * 4 + j] = acc;
        }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        float ky = k[i * 4] * y[0];
#pragma unroll
        for (int m = 1; m < 4; ++m) ky = ky + k[i * 4 + m] * y[m];
        x[i] = x[i] + ky;
    }
    // I - K H: rows of K in the first four columns
    auto ikh = [&](int i, int m) -> float {
        const float e = i == m ? 1.f : 0.f;
        return m < 4 ? e - k[i * 4 + m] : e;
    };
    float pn[64];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        float a[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float acc = ikh(i, 0) * P[j];
#pragma unroll
            for (int m = 1; m < 8; ++m) acc = acc + ikh(i, m) * P[m * 8 + j];
            a[j] = acc;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float b = a[0] * ikh(j, 0);
#pragma unroll
            for (int m = 1; m < 8; ++m) b = b + a[m] * ikh(j, m);
            float c = (k[i * 4] * r[0]) * k[j * 4];
#pragma unroll
            for (int m = 1; m < 4; ++m)
                c = c + (k[i * 4 + m] * r[m]) * k[j * 4 + m];
            pn[i * 8 + j] = b + c;
        }
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) P[e] = pn[e];
}

// Warp argmin of (v, i) pairs: the lower index wins a tie.
__device__ __forceinline__ void argmin_lo(float& v, int& i) {
#pragma unroll
    for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_xor_sync(kAll, v, off);
        const int oi = __shfl_xor_sync(kAll, i, off);
        if (ov < v || (ov == v && oi < i)) {
            v = ov;
            i = oi;
        }
    }
}

// Index of the n-th (from 0) set bit of mask; the caller guarantees it.
__device__ __forceinline__ int nth_bit(unsigned mask, int n) {
    for (int r = 0; r < n; ++r) mask &= mask - 1u;
    return __ffs(mask) - 1;
}

// ops/assignment.py:solve_lap_min on cost = -(utility padded with -2),
// K x K.  Lane j holds column j's v, min_val, path, row4col and scanned
// flag, and row j's u, col4row and scanned flag.  Returns this lane's
// row's col4row.
__device__ int solve_lap(const float (*util)[kLanes + 1], int D, int T,
                         int K, int lane) {
    auto cost = [&](int i, int j) -> float {
        return -((i < D && j < T) ? util[i][j] : -2.f);
    };
    const bool col = lane < K;
    float u = 0.f, v = 0.f;
    int col4row = -1, row4col = -1;
    for (int cur = 0; cur < K; ++cur) {
        float min_cur = 0.f, min_val = kInf;
        int path = -1, i = cur, sink = 0;
        bool srow = false, scol = false;
        while (true) {
            if (lane == i) srow = true;
            const float ui = __shfl_sync(kAll, u, i);
            const bool remaining = col && !scol;
            const float reduced = min_cur + cost(i, lane) - ui - v;
            if (remaining && reduced < min_val) {
                min_val = reduced;
                path = i;
            }
            // lanes past K take +inf, above every real column's value
            float m = remaining ? min_val : (col ? kInf : INFINITY);
            int j = lane;
            argmin_lo(m, j);
            min_cur = m;
            if (lane == j) scol = true;
            const int owner = __shfl_sync(kAll, row4col, j);
            if (owner < 0) {
                sink = j;
                break;
            }
            i = owner;
        }
        // dual updates (keep reduced costs non-negative)
        if (lane == cur) u = u + min_cur;
        const int assigned = min(max(col4row, 0), K - 1);
        const float mv = __shfl_sync(kAll, min_val, assigned);
        if (srow && lane != cur) u = u + min_cur - mv;
        if (scol) v = v - (min_cur - min_val);
        // augment along the alternating path ending at the sink
        int j = sink;
        while (true) {
            const int row = __shfl_sync(kAll, path, j);
            const int j_next = __shfl_sync(kAll, col4row, row);
            if (lane == j) row4col = row;
            if (lane == row) col4row = j;
            if (row == cur) break;
            j = j_next;
        }
    }
    return col4row;
}

__global__ void __launch_bounds__(kLanes, 1)
tracker_scan_kernel(const ScanArgs a) {
    __shared__ float s_dz[kLanes][4];              // detection measurements
    __shared__ float s_prior[kLanes][4];           // prior boxes by slot
    __shared__ float s_util[kLanes][kLanes + 1];   // utility (D, T)
    __shared__ int s_slot[kLanes];                 // det_slot by detection

    const int lane = threadIdx.x;
    const int T = a.tracks, D = a.dets, K = max(T, D);
    const bool is_trk = lane < T, is_det = lane < D;
    const unsigned below = (1u << lane) - 1u;

    float x[8], P[64];
    bool active = false;
    int uid = -1, first = 0, hist = 0, tsu = 0, hits = 0, ih = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 64; ++e) P[e] = 0.f;
    if (is_trk) {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = a.x[lane * 8 + e];
#pragma unroll
        for (int e = 0; e < 64; ++e) P[e] = a.p[lane * 64 + e];
        active = a.active[lane] != 0;
        uid = a.uid[lane];
        first = a.first_frame[lane];
        hist = a.hist_len[lane];
        tsu = a.tsu[lane];
        hits = a.hits[lane];
        ih = a.initial_hits[lane];
    }
    int next_uid = *a.next_uid;
    const int frame0 = *a.frame0;

    for (int f = 0; f < a.frames; ++f) {
        const int frame = frame0 + f;
        float db[4] = {0.f, 0.f, 0.f, 0.f};
        bool dv = false;
        if (is_det) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                db[k] = a.det_boxes[((size_t)f * D + lane) * 4 + k];
            dv = a.det_valid[(size_t)f * D + lane] != 0;
            box_to_z(db, s_dz[lane]);
        }

        // 1-2. scene-cut kill, predict the followed slots
        const bool was = active && a.scene[f] == 0;
        if (was) {
            predict(x, P, a.q);
            ++tsu;
            ++hist;
        }
        if (is_trk) z_to_box(x, s_prior[lane]);
        const unsigned was_mask = __ballot_sync(kAll, is_trk && was);
        __syncwarp();

        // 3. utility rows: lane d scores detection d against every slot
        unsigned ok_mask = 0;
        int best = 0, n_best = 0;
        float best_val = 0.f;
        if (is_det) {
            for (int t = 0; t < T; ++t) {
                const float v = iou(db, s_prior[t]);
                const bool ok = dv && ((was_mask >> t) & 1u) &&
                                v >= a.iou_threshold;
                const float util = ok ? v : -1.f;
                s_util[lane][t] = util;
                ok_mask |= (unsigned)ok << t;
                if (t == 0 || util > best_val) {
                    best_val = util;
                    best = t;
                    n_best = 1;
                } else if (util == best_val) {
                    ++n_best;
                }
            }
        }
        const bool row_active = ok_mask != 0u;
        // column collisions: active rows whose argmax is this lane's slot
        int taken = 0;
        for (int d = 0; d < D; ++d) {
            const int act_d = __shfl_sync(kAll, (int)row_active, d);
            const int best_d = __shfl_sync(kAll, best, d);
            taken += act_d && best_d == lane;
        }
        const bool fast = D <= T &&
                          !__any_sync(kAll, taken > 1) &&
                          !__any_sync(kAll, row_active && n_best > 1);
        __syncwarp();
        int slot;
        if (fast) {
            slot = row_active ? best : -1;
        } else {
            const int c = solve_lap(s_util, D, T, K, lane);
            const bool good = c < T && dv &&
                              ((ok_mask >> min(max(c, 0), T - 1)) & 1u);
            slot = good ? c : -1;
        }
        if (is_det) s_slot[lane] = slot;
        __syncwarp();

        // 4. update the matched slots' posteriors
        bool matched = false;
        int dsel = 0;
        if (is_trk) {
            for (int d = 0; d < D; ++d)
                if (s_slot[d] == lane) {
                    matched = true;
                    dsel = d;
                    break;
                }
        }
        if (matched) {
            update(x, P, s_dz[dsel], a.r);
            ++hits;
            tsu = 0;
            if (hist == hits) ++ih;
        }

        // 5. unfollow rules
        const bool expired = was && tsu > a.max_age && hist >= a.min_hits;
        const bool not_started = was && hist <= a.min_hits && ih < hist;
        const bool still = was && !(expired || not_started);

        // 6. spawn: the r-th unmatched detection takes the r-th free slot
        const bool unmatched = is_det && dv && slot < 0;
        const unsigned um = __ballot_sync(kAll, unmatched);
        const int spawn_rank = __popc(um & below);
        const bool free_slot = is_trk && !was;
        const unsigned fm = __ballot_sync(kAll, free_slot);
        const int n_free = __popc(fm);
        const bool will = unmatched && spawn_rank < n_free;
        const unsigned wm = __ballot_sync(kAll, will);
        const int n_spawn = __popc(wm);
        const int free_rank = __popc(fm & below);
        const bool spawned = free_slot && free_rank < n_spawn;
        if (spawned) {
            const float* z = s_dz[nth_bit(wm, free_rank)];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                x[e] = z[e];
                x[e + 4] = 0.f;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    P[i * 8 + j] = i == j ? a.p0[i] : 0.f;
            uid = next_uid + free_rank;
            first = frame;
            hist = hits = ih = 1;
            tsu = 0;
        }
        if (will) slot = nth_bit(fm, spawn_rank);
        next_uid += n_spawn;
        active = still || spawned;

        // emissions
        if (is_trk) {
            const size_t at = (size_t)f * T + lane;
            z_to_box(x, &a.e_box[at * 4]);
            a.e_emit[at] = was || spawned;
            a.e_detected[at] = matched || spawned;
            a.e_uid[at] = uid;
            a.e_first_frame[at] = first;
        }
        if (is_det) a.e_det_slot[(size_t)f * D + lane] = slot;
        if (lane == 0) a.e_overflow[f] = __popc(um) - n_spawn;
        __syncwarp();      // the shared tables are rewritten next frame
    }

    if (is_trk) {
#pragma unroll
        for (int e = 0; e < 8; ++e) a.x_out[lane * 8 + e] = x[e];
#pragma unroll
        for (int e = 0; e < 64; ++e) a.p_out[lane * 64 + e] = P[e];
        a.active_out[lane] = active;
        a.uid_out[lane] = uid;
        a.first_frame_out[lane] = first;
        a.hist_len_out[lane] = hist;
        a.tsu_out[lane] = tsu;
        a.hits_out[lane] = hits;
        a.initial_hits_out[lane] = ih;
    }
    if (lane == 0) *a.next_uid_out = next_uid;
}

}  // namespace

extern "C" {

// Launches one warp on `stream`, does not synchronise, allocates
// nothing; returns the launch's cudaError_t (0 on success), or
// cudaErrorInvalidValue for T or D outside 1..32.
int fr_tracker_scan(const ScanArgs* args, cudaStream_t stream) {
    if (args->tracks < 1 || args->tracks > kLanes || args->dets < 0 ||
        args->dets > kLanes || args->frames < 0)
        return (int)cudaErrorInvalidValue;
    tracker_scan_kernel<<<1, kLanes, 0, stream>>>(*args);
    return (int)cudaGetLastError();
}

}  // extern "C"
