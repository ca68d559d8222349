// Single-leg reachability and distance kernels for Hopper (sm_90a), and the
// reach probe's io-only floor (K7).
//
// Build (legmov_tpu_torch/ops/_build.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -ftz=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
//
// Numerics are the contract of these kernels.  -fmad=false keeps every
// `a * b + c` as two IEEE roundings (no FMA contraction), and the absence of
// --use_fast_math keeps sqrtf, `/` and every comparison IEEE: each kernel is
// then bit-identical, booleans and floats alike, to its plain PyTorch version
// (ops/cuda_kernels.py, eager PyTorch never contracts either) on the same
// card, which is what the on-card check requires.  A later performance pass
// may revisit contraction, with measurements of what flips.
//
// No PyTorch headers: plain C launchers, loaded with ctypes.  All leg
// geometry arrives as one by-value `__grid_constant__` parameter block that
// the host fills from the workspace tables, so one binary serves every leg.
//
// The two point kernels run grid-stride loops with 64-bit indexing and take
// an element stride on the inputs (1 for SoA arrays, 3 for the columns of an
// [N, 3] tensor) and, for the distance vectors, on the outputs: K1 four
// points a thread where the arrays allow 16-byte loads (a template whose
// instance the launcher picks from the leg), K2 one.  K2 has a second
// kernel, for the cells of the hierarchical solve (legmov_dist_cells_kernel),
// on the same body.
// Launchers enqueue on the caller's stream, do not synchronise, and return
// cudaGetLastError().

#include <cuda_runtime.h>

#define LEGMOV_MAX_CIRCLES 16   // unique circles of a [2][2][4] slot table
#define LEGMOV_MAX_CORNERS 10
#define LEGMOV_BLOCK 256

// ---------------------------------------------------------------------------
// parameter blocks (mirrored field for field by ctypes.Structure in
// ops/cuda_kernels.py; every member is 4 bytes, so there is no padding)
// ---------------------------------------------------------------------------

struct ReachParams {
    float body, cp, sp, coxa_length;
    float cmax_c, cmax_s, cmin_c, cmin_s;
    float mid_c, mid_s;
    float sat_c[2], sat_s[2];               // [lower, upper]
    int gt_possible, lt_possible, mid_neg;
    int sat_neg[2];
    int n_circles;
    // unique circles in expanded linear form, centre norm folded in
    float ax[LEGMOV_MAX_CIRCLES], ay[LEGMOV_MAX_CIRCLES];
    float r2k[LEGMOV_MAX_CIRCLES], hi2k[LEGMOV_MAX_CIRCLES];
    float lo2k[LEGMOV_MAX_CIRCLES];
    int collapse[LEGMOV_MAX_CIRCLES];       // lo2k < r2k < hi2k holds
    // per (upper*2 + ext) configuration: which unique circles its four slots
    // test attractively (pos) and repulsively (neg), as bit masks
    unsigned pos_mask[4], neg_mask[4];
};

struct DistParams {
    float body, cp, sp, coxa_length, cp_inv, sp_inv;
    float cmax_c, cmax_s, cmin_c, cmin_s;
    float mid_c, mid_s;
    float sat_c[2], sat_s[2];
    float margin2, big;
    // [(upper*2 + ext)*4 + slot] circle tables
    float cx[16], cy[16], r[16], r2[16], hi2[16], lo2[16];
    // live corners with their linear-form constants
    float corner_x[LEGMOV_MAX_CORNERS], corner_y[LEGMOV_MAX_CORNERS];
    float corner_ax[LEGMOV_MAX_CORNERS], corner_ay[LEGMOV_MAX_CORNERS];
    float corner_k[LEGMOV_MAX_CORNERS];
    // threshold directions: mega_hi, mega_lo, max, min, mid
    float dir_c[5], dir_s[5];
    int mid_neg;
    int sat_neg[2];
    int att[16];
    int n_corners;
    int dir_neg[5];
};

// ---------------------------------------------------------------------------
// shared device helpers
// ---------------------------------------------------------------------------

// raw atan2(yp, xp) > theta for a constant threshold direction, trig-free:
// theta < 0 ? (nn | pos) : (nn & pos).  PRED writes it as one boolean
// expression (one predicate operation) instead of a select on theta's
// sign: faster where the sign is a parameter-bank operand (the point
// kernels), slower where it is read from shared memory (the cell driver,
// whose register count it raises from 96 to 112); both measured on an H100
template <bool PRED>
__device__ __forceinline__ bool angle_gt(float xp, float yp, float c, float s,
                                         bool theta_neg) {
    const bool pos = (yp * c - xp * s) > 0.0f;
    const bool nn = yp >= 0.0f;
    return PRED ? (nn & pos) | (theta_neg & (nn | pos))
                : (theta_neg ? (nn | pos) : (nn & pos));
}

// raw atan2(yp, xp) < theta (strict), mirror of angle_gt:
// theta < 0 ? (below & neg) : (below | neg)
template <bool PRED>
__device__ __forceinline__ bool angle_lt(float xp, float yp, float c, float s,
                                         bool theta_neg) {
    const bool neg = (yp * c - xp * s) < 0.0f;
    const bool below = yp < 0.0f;
    return PRED ? (below & neg) | ((!theta_neg) & (below | neg))
                : (theta_neg ? (below & neg) : (below | neg));
}

// ---------------------------------------------------------------------------
// K1  reachability
//
// Replaces the Pallas kernel legmov_tpu/ops/pallas_kernels.py
// make_reachability_kernel (body `kernel`).
//
// Bound on this card: it moves 13 bytes per point (three f32 in, one byte
// out) and does 74 fp32 operations per point for the shipped legs, counting
// every add, multiply, compare and sqrt as one and no select or boolean
// (coxa frame 7, limit tests 8, sqrt and plane coordinate 5, region bits
// 15, q 3, six unique circles x 6; reach_flops_per_point in
// ops/cuda_kernels.py).  At 3.35 TB/s and 67 TFLOP/s that is 3.9 ps
// against 1.1 ps a point: bytes bound it.  The floor of this access
// pattern on the card is K7 below, the same loads and stores with no
// geometry.
//
// Design: K7's I/O shape.  For SoA arrays (stride 1, 16-byte aligned) a
// thread takes four points a step with three 16-byte loads and one 4-byte
// store, in a grid-stride loop; the ragged tail, unaligned arrays and the
// columns of an [N, 3] tensor (stride 3) go through a scalar loop, correct
// but not tuned (the launcher picks the path from the pointers and the
// stride).  The geometry stays out of memory: the kernel is a
// template on the unique-circle count, instantiated for the counts of the
// shipped legs with every circle's interval collapse legal (see the
// launcher), so the circle loop unrolls and each circle's constants are
// operands of the parameter bank at fixed offsets; any other leg takes the
// generic instance (-1), which unrolls to LEGMOV_MAX_CIRCLES under the
// launch-uniform predicates `c < n_circles` and `collapse[c]`.  Unlike the
// TPU form, which evaluates all four (region, ext) circle sets densely and
// selects, a point tests the unique circles once, collects the tests it
// fails in one word (attractive tests in the low half, repulsive in the
// high) and checks it against its own configuration's mask, selected among
// four registers, not read by a per-lane index.  The angle tests are one
// predicate expression each (angle_gt).
// ---------------------------------------------------------------------------

// Per (upper, ext) configuration, the circles whose test it needs to pass:
// bit c its attractive test of circle c, bit 16 + c its repulsive one.
struct ReachMasks {
    unsigned m[4];
    __device__ __forceinline__ explicit ReachMasks(const ReachParams& P) {
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = P.pos_mask[i] | (P.neg_mask[i] << 16);
    }
};

// NC > 0: NC unique circles, all collapsed; NC == -1: any leg
template <int NC>
__device__ __forceinline__ bool reach_point(const ReachParams& P,
                                            const ReachMasks& M, float xin,
                                            float yin, float zin) {
    // place_over_coxa: shift by -body along x, pitch by -coxa_pitch
    const float px = xin - P.body;
    const float y = yin;
    const float pz = zin;
    const float x = px * P.cp - pz * P.sp;
    const float z = px * P.sp + pz * P.cp;

    // mirrored half-plane; the sign bit sees -0.0
    const bool flip = (__float_as_uint(x) >> 31) != 0u;
    const float fx = flip ? -x : x;
    const float fy = flip ? -y : y;
    bool coxa_invalid = false;
    if (P.gt_possible)
        coxa_invalid = (fy * P.cmax_c - fx * P.cmax_s) > 0.0f;
    if (P.lt_possible)
        coxa_invalid = coxa_invalid | ((fy * P.cmin_c - fx * P.cmin_s) < 0.0f);

    const float rho = sqrtf(x * x + y * y);
    const float xp = (flip ? -rho : rho) - P.coxa_length;
    const float yp = z;

    const bool upper = angle_gt<true>(xp, yp, P.mid_c, P.mid_s, P.mid_neg);
    const bool gt_lo =
        angle_gt<true>(xp, yp, P.sat_c[0], P.sat_s[0], P.sat_neg[0]);
    const bool gt_up =
        angle_gt<true>(xp, yp, P.sat_c[1], P.sat_s[1], P.sat_neg[1]);
    const bool ext = upper ^ (upper ? gt_up : gt_lo);

    // each unique circle once, both validity polarities: the tests it fails
    const float q = xp * xp + yp * yp;
    unsigned fail = 0u;
#pragma unroll
    for (int c = 0; c < (NC > 0 ? NC : LEGMOV_MAX_CIRCLES); ++c) {
        if (NC < 0 && c >= P.n_circles) continue;
        const float t = q + P.ax[c] * xp + P.ay[c] * yp;
        bool vp, vn;
        if (NC > 0 || P.collapse[c]) {
            // contiguous-interval collapse; !(t <= lo) and not (t > lo),
            // so a NaN t keeps the truth value of `~inside | near`
            vp = t < P.hi2k[c];
            vn = !(t <= P.lo2k[c]);
        } else {
            const bool inside = t <= P.r2k[c];
            const bool near = (t < P.hi2k[c]) & (t > P.lo2k[c]);
            vp = inside | near;
            vn = (!inside) | near;
        }
        fail |= (vp ? 0u : 1u) << c;
        fail |= (vn ? 0u : 1u) << (16 + c);
    }
    // the configuration's mask, selected among registers
    const unsigned m = upper ? (ext ? M.m[3] : M.m[2]) : (ext ? M.m[1] : M.m[0]);
    return (!coxa_invalid) & ((fail & m) == 0u);
}

// `vector`: the inputs are SoA arrays on 16-byte boundaries and the output
// on a 4-byte one (the launcher decides)
template <int NC>
__global__ void __launch_bounds__(LEGMOV_BLOCK)
legmov_reach_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                    const float* __restrict__ zs, long long in_stride,
                    unsigned char* __restrict__ out, long long n, int vector,
                    const __grid_constant__ ReachParams P) {
    const ReachMasks M(P);
    const long long step = (long long)gridDim.x * blockDim.x;
    const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long done = 0;
    if (vector) {
        const float4* x4 = reinterpret_cast<const float4*>(xs);
        const float4* y4 = reinterpret_cast<const float4*>(ys);
        const float4* z4 = reinterpret_cast<const float4*>(zs);
        uchar4* o4 = reinterpret_cast<uchar4*>(out);
        const long long n4 = n >> 2;
        for (long long i = first; i < n4; i += step) {
            const float4 a = x4[i], b = y4[i], c = z4[i];
            o4[i] = make_uchar4(reach_point<NC>(P, M, a.x, b.x, c.x),
                                reach_point<NC>(P, M, a.y, b.y, c.y),
                                reach_point<NC>(P, M, a.z, b.z, c.z),
                                reach_point<NC>(P, M, a.w, b.w, c.w));
        }
        done = n4 << 2;
    }
    for (long long i = done + first; i < n; i += step)
        out[i] = reach_point<NC>(P, M, xs[i * in_stride], ys[i * in_stride],
                                    zs[i * in_stride]);
}

// ---------------------------------------------------------------------------
// K2  distance to the workspace boundary
//
// Replaces the Pallas kernel legmov_tpu/ops/pallas_kernels.py
// make_distance_kernel (plane_clamp_tiles, finish, body `kernel`) in its
// default variant: rsqrt clamp and linear-form corner tournament.
//
// Bound on this card: it moves 25 bytes per point (three f32 in, one byte
// and three f32 out) and does at most 651 fp32 operations per point with
// ten live corners (579 and 591 for the two shipped legs, which have four
// and five), counted as for K1 (frame and heading 14; per finish branch
// 310: five angle tests 25, rotation 7, region bits 16, four circles
// validated and clamped 72, 4 x 3 cross-validations 96, circle tournament
// 4, corner tournament 63, result 3, limit-plane alternative and
// un-rotation 24; final select and un-pitch 17; dist_flops_per_point in
// ops/cuda_kernels.py).  At 3.35 TB/s and 67 TFLOP/s that is 7.5 ps
// against 9.7 ps a point: operations bound it, and since no multiply-add
// is fused here the real ceiling is lower still.  Not every point needs
// all of it: a branch's tail (its clamps, tournaments and limit plane) is
// read only where the two branches' results agree or that branch won, and
// the corner tournament only where the query is invalid
// (dist_flops_needed counts what a set of points needs, the bound that
// chip_smoke.py states).
//
// Design: the whole program of a point in one thread's registers (no
// intermediate reaches memory; the two finish branches share the frame and
// the heading).  The point driver stages the 16 (configuration, slot)
// circles in shared memory once a block, two float4 a slot, where a warp
// whose points sit in different configurations reads them in one access
// each instead of the serialised constant-bank accesses of a per-lane
// index.  Measured on an H100 and left out (PERF.md): skipping a
// branch's tail or the corner tournament by warp vote where no lane needs
// it, skipping a clamp's cross-validation when its score cannot win, an
// instance for each corner count (more registers, fewer warps) and two
// points a thread all made the kernel slower.  It uses one rsqrtf per clamp where the TPU
// kernel uses lax.rsqrt, and does not apply the interval collapse: it
// computes what the TPU kernel computes.  The cell driver below shares the
// body, with its slot tables in its shared copy of the parameter block.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool circ_valid(float px, float py, float cx,
                                           float cy, float r2, float hi2,
                                           float lo2, bool att) {
    const float dx = px - cx;
    const float dy = py - cy;
    const float d2 = dx * dx + dy * dy;
    const bool inside = d2 <= r2;
    const bool near = (d2 < hi2) & (d2 > lo2);
    return (inside == att) | near;
}

// The (configuration, slot) circles, read where the caller keeps them, and
// the form of the angle tests that suits where the leg's scalars are read
// from: in a DistParams (the cell driver's shared copy) ...
struct ParamSlots {
    static constexpr bool kPredAngles = false;  // see angle_gt
    const DistParams& P;
    __device__ __forceinline__ void get(int i, float& cx, float& cy, float& r,
                                        float& r2, float& hi2, float& lo2,
                                        bool& att) const {
        cx = P.cx[i];
        cy = P.cy[i];
        r = P.r[i];
        r2 = P.r2[i];
        hi2 = P.hi2[i];
        lo2 = P.lo2[i];
        att = P.att[i] != 0;
    }
};

// ... or staged in shared memory by the point driver (its scalars are
// parameter-bank operands): a = (cx, cy, r, r2), b = (hi2, lo2, att as
// bits, unused)
struct StagedSlots {
    static constexpr bool kPredAngles = true;
    const float4* a;
    const float4* b;
    __device__ __forceinline__ void get(int i, float& cx, float& cy, float& r,
                                        float& r2, float& hi2, float& lo2,
                                        bool& att) const {
        const float4 u = a[i], v = b[i];
        cx = u.x;
        cy = u.y;
        r = u.z;
        r2 = u.w;
        hi2 = v.x;
        lo2 = v.y;
        att = __float_as_int(v.z) != 0;
    }
};

// ops/plane.py plane_clamp on the configuration's four circles + corners
template <class Slots>
__device__ __forceinline__ void plane_clamp(const DistParams& P,
                                            const Slots& S, float xp,
                                            float yp, bool& overall,
                                            float& out_x, float& out_y) {
    constexpr bool pred = Slots::kPredAngles;
    const bool upper = angle_gt<pred>(xp, yp, P.mid_c, P.mid_s, P.mid_neg);
    const bool gt_lo =
        angle_gt<pred>(xp, yp, P.sat_c[0], P.sat_s[0], P.sat_neg[0]);
    const bool gt_up =
        angle_gt<pred>(xp, yp, P.sat_c[1], P.sat_s[1], P.sat_neg[1]);
    const bool ext = upper ^ (upper ? gt_up : gt_lo);
    const int base = ((upper ? 2 : 0) + (ext ? 1 : 0)) * 4;
    // the TPU kernel builds its attract bits from `ones = (xp == xp)` and
    // `zeros = ~ones`, so a NaN plane coordinate inverts every slot's
    // polarity; kept, so that NaN inputs give the same `ok`
    const bool ordered = xp == xp;

    float cxs[4], cys[4], rs[4], r2s[4], hi2s[4], lo2s[4];
    bool atts[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        bool att;
        S.get(base + s, cxs[s], cys[s], rs[s], r2s[s], hi2s[s], lo2s[s], att);
        atts[s] = att == ordered;
    }

    overall = true;
    float clamp_x[4], clamp_y[4], score[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        const float dx = xp - cxs[s];
        const float dy = yp - cys[s];
        const float d2 = dx * dx + dy * dy;
        const bool inside = d2 <= r2s[s];
        const bool near = (d2 < hi2s[s]) & (d2 > lo2s[s]);
        overall = overall & ((inside == atts[s]) | near);
        // one rsqrt + two multiplies instead of sqrt + divide; the
        // degenerate-centre guard is the squared test d2 < margin^2
        const bool deg = d2 < P.margin2;
        const float rinv = rsqrtf(deg ? 1.0f : d2);
        const float mag = d2 * rinv;
        const float scale = rs[s] * rinv;
        clamp_x[s] = cxs[s] + (deg ? 1.0f : dx) * scale;
        clamp_y[s] = cys[s] + (deg ? 0.0f : dy) * scale;
        score[s] = (rs[s] - mag) * (rs[s] - mag);
    }

    float best_s2 = P.big, best_x = 0.0f, best_y = 0.0f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        bool ok = true;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            if (t == s) continue;  // a clamp lies on its own circumference
            ok = ok & circ_valid(clamp_x[s], clamp_y[s], cxs[t], cys[t],
                                 r2s[t], hi2s[t], lo2s[t], atts[t]);
        }
        const float s2 = ok ? score[s] : P.big;
        const bool take = s2 < best_s2;
        best_s2 = take ? s2 : best_s2;
        best_x = take ? clamp_x[s] : best_x;
        best_y = take ? clamp_y[s] : best_y;
    }

    // corner-only tournament in expanded linear form (first wins, strict <),
    // merged with the circle winner once and only for an invalid query
    if (P.n_corners > 0) {
        const float q = xp * xp + yp * yp;
        float c_s2 = q + P.corner_ax[0] * xp + P.corner_ay[0] * yp + P.corner_k[0];
        float c_x = P.corner_x[0], c_y = P.corner_y[0];
        for (int j = 1; j < P.n_corners; ++j) {
            const float s2 =
                q + P.corner_ax[j] * xp + P.corner_ay[j] * yp + P.corner_k[j];
            const bool take = s2 < c_s2;
            c_s2 = take ? s2 : c_s2;
            c_x = take ? P.corner_x[j] : c_x;
            c_y = take ? P.corner_y[j] : c_y;
        }
        const bool take = (!overall) & (c_s2 < best_s2);
        best_s2 = take ? c_s2 : best_s2;
        best_x = take ? c_x : best_x;
        best_y = take ? c_y : best_y;
    }
    const bool found = best_s2 < P.big;
    out_x = xp - (found ? best_x : 0.0f);
    out_y = yp - (found ? best_y : 0.0f);
}

// ops/distance.py _finish_finding_closest.  `flipped` selects the pi-flip
// branch, whose raw angle is the angle of direction (-x, -y).
template <class Slots>
__device__ __forceinline__ void finish(const DistParams& P, const Slots& S,
                                       float x, float y, float z, float cos_a,
                                       float sin_a, bool flipped, bool& res,
                                       float& gx, float& gy, float& gz) {
    const float ax = flipped ? -x : x;
    const float ay = flipped ? -y : y;
    constexpr bool pred = Slots::kPredAngles;
    const bool mega =
        angle_gt<pred>(ax, ay, P.dir_c[0], P.dir_s[0], P.dir_neg[0]) |
        angle_lt<pred>(ax, ay, P.dir_c[1], P.dir_s[1], P.dir_neg[1]);
    const bool over = angle_gt<pred>(ax, ay, P.dir_c[2], P.dir_s[2], P.dir_neg[2]);
    const bool under =
        angle_lt<pred>(ax, ay, P.dir_c[3], P.dir_s[3], P.dir_neg[3]);
    const bool saturated = mega | over | under;
    const float c1 =
        mega ? -cos_a : (over ? P.cmax_c : (under ? P.cmin_c : cos_a));
    const float s1 =
        mega ? -sin_a : (over ? P.cmax_s : (under ? P.cmin_s : sin_a));
    const float xr = x * c1 + y * s1;
    const float yr = (-x) * s1 + y * c1;
    bool was_valid;
    float dxp, dzp;
    plane_clamp(P, S, xr - P.coxa_length, z, was_valid, dxp, dzp);
    // alternative boundary: the coxa angular-limit plane
    const bool use_max =
        angle_gt<pred>(ax, ay, P.dir_c[4], P.dir_s[4], P.dir_neg[4]);
    const float cl = use_max ? P.cmax_c : P.cmin_c;
    const float sl = use_max ? P.cmax_s : P.cmin_s;
    const float c2 = cl * c1 + sl * s1;
    const float s2 = sl * c1 - cl * s1;
    const float ys = (-xr) * s2 + yr * c2;
    const float d2c = dxp * dxp + yr * yr + dzp * dzp;
    const bool better = was_valid & (!mega) & (d2c > ys * ys);
    const float rx = (-ys) * s2;
    const float ry = ys * c2;
    const float fx = better ? rx : dxp;
    const float fy = better ? ry : yr;
    gz = better ? 0.0f : dzp;
    gx = fx * c1 - fy * s1;
    gy = fx * s1 + fy * c1;
    res = was_valid & (!saturated);
}

// One point of K2's body: a point in the leg's frame (the frame the leg's
// geometry is given in, before the coxa pitch) -> ok and the displacement
// to the workspace boundary in that frame.  Both kernels below call it.
template <class Slots>
__device__ __forceinline__ bool dist_point(const DistParams& P,
                                           const Slots& S, float xin,
                                           float yin, float zin, float& gx,
                                           float& gy, float& gz) {
    const float px = xin - P.body;
    const float y = yin;
    const float pz = zin;
    const float x = px * P.cp - pz * P.sp;
    const float z = px * P.sp + pz * P.cp;

    // heading direction from coordinates (identity on the coxa axis)
    const float rho = sqrtf(x * x + y * y);
    const bool on_axis = rho == 0.0f;
    const float inv = on_axis ? 1.0f : rho;
    const float cos_a = on_axis ? 1.0f : x / inv;
    const float sin_a = on_axis ? 0.0f : y / inv;

    bool res, resf;
    float dx, dy, dz, fx, fy, fz;
    finish(P, S, x, y, z, cos_a, sin_a, false, res, dx, dy, dz);
    finish(P, S, x, y, z, -cos_a, -sin_a, true, resf, fx, fy, fz);

    const float d2d = dx * dx + dy * dy + dz * dz;
    const float d2f = fx * fx + fy * fy + fz * fz;
    const bool use_d = (res == resf) ? (d2d < d2f) : res;
    const float ox = use_d ? dx : fx;
    const float oy = use_d ? dy : fy;
    const float oz = use_d ? dz : fz;
    gx = ox * P.cp_inv - oz * P.sp_inv;
    gy = oy;
    gz = ox * P.sp_inv + oz * P.cp_inv;
    return res | resf;
}

// The point kernel (`cli evaluate`, the `[N, 3]` and `.soa` entries): one
// thread a point in a grid-stride loop.
extern "C" __global__ void __launch_bounds__(LEGMOV_BLOCK)
legmov_dist_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                   const float* __restrict__ zs, long long in_stride,
                   unsigned char* __restrict__ ok_out,
                   float* __restrict__ dx_out, float* __restrict__ dy_out,
                   float* __restrict__ dz_out, long long out_stride,
                   long long n, const __grid_constant__ DistParams P) {
    __shared__ float4 slot_a[16], slot_b[16];
    if (threadIdx.x < 16) {
        const int i = threadIdx.x;
        slot_a[i] = make_float4(P.cx[i], P.cy[i], P.r[i], P.r2[i]);
        slot_b[i] = make_float4(P.hi2[i], P.lo2[i], __int_as_float(P.att[i]),
                                0.0f);
    }
    __syncthreads();
    const StagedSlots S{slot_a, slot_b};
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += step) {
        float gx, gy, gz;
        const bool ok = dist_point(P, S, xs[i * in_stride], ys[i * in_stride],
                                   zs[i * in_stride], gx, gy, gz);
        ok_out[i] = (unsigned char)ok;
        dx_out[i * out_stride] = gx;
        dy_out[i * out_stride] = gy;
        dz_out[i * out_stride] = gz;
    }
}

// ---------------------------------------------------------------------------
// K2, cell kernel: the identity levels of the hierarchical solve
//
// Replaces what XLA fused around the same Pallas kernel in
// legmov_tpu/models/hier_solver.py make_fast_cell_eval (a lax.scan over
// foothold chunks around one kernel call per leg): for a batch of cells and
// the batch's foothold subset it gives each cell's (valid, edge, leaf) flags
// in one launch.  Per (cell, foothold) pair: v = f - c; the elongated-box
// prefilter; for each leg x0 = vx ca - vy sa, y0 = vx sa + vy ca, K2's body,
// the vector back to the world frame (wx = dx ca + dy sa, wy = -dx sa +
// dy ca) and the crossing test (box against hm, or wx^2 + wy^2 + wz^2 <
// h2m); then the per-pair counts (shared rule) or the per-leg any-bits
// (per-leg rule), OR-ed over the cell's footholds.  Same expressions in the
// same order as the plain version (ops/cuda_kernels.py
// distance_cells_plain), so the flags are its bits.
//
// Bound on this card: operations.  Per pair 9 for the prefilter, then per
// pair inside the box and leg the body's 579-651 and 18 for the frame,
// restore and crossing test (cells_flops in ops/cuda_kernels.py); the bytes
// (cells, a foothold subset of at most a few hundred kB, three bytes a cell
// out) are noise beside them.  Design: one warp per cell, four cells a
// block; the block stages footholds through shared memory in tiles of
// LEGMOV_CELL_TILE, double-buffered with cp.async, so a foothold is read
// from memory once a block; each lane prefilters one foothold of the tile,
// and a ballot writes the in-box ones into the warp's 64-slot ring (as
// vectors, so the ring outlives the tile), from which the L-leg body runs
// on full warps only (plus one partial warp at the end).  A lane keeps its
// pairs' bits in a register; the warp ORs them with __reduce_or_sync.
// Distinct leg geometries live in shared memory, legs refer to them by
// index.  A batch of 1,024 cells is 1,024 warps, fewer than the card holds
// at once, so `splits` blocks share a cell's footholds (tile y, y + splits,
// ...; by default four waves of resident warps): their bits meet in a
// scratch word with atomicOr, and the split that arrives last writes the
// cell's flags.  A cell that could stop once
// all its bits are set (an early exit) was measured no faster, and has
// none.
// ---------------------------------------------------------------------------

// Launch shape, chosen by timing builds in turns on real identity-level
// batches on an H100: four cells a block (eight were 6-20 % slower); at
// least four blocks an SM, which caps a thread at 128 registers (the kernel
// takes 96, no spills; a cap of three blocks spilled and was 3-6 % slower);
// tiles of 256 footholds (128 or 512 were -9 to +10 %, no clear winner).
#define LEGMOV_CELL_MAX_LEGS 8
#define LEGMOV_CELL_WARPS 4       // cells a block, one warp each
#define LEGMOV_CELL_MIN_BLOCKS 4  // blocks an SM: the register cap (128)
#define LEGMOV_CELL_TILE 256      // footholds a shared-memory stage
#define LEGMOV_CELL_RING 64
#define LEGMOV_FULL 0xffffffffu

// the level and the legs, by value (mirrored by ctypes in
// ops/cuda_kernels.py; every member is 4 bytes)
struct CellArgs {
    float ca[LEGMOV_CELL_MAX_LEGS], sa[LEGMOV_CELL_MAX_LEGS];  // cos/sin(-az)
    float elong[3], hm[3];
    float h2m;
    int pidx[LEGMOV_CELL_MAX_LEGS];  // leg -> its geometry
    int n_legs, k, shared, big_cell;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// footholds [lo, lo + LEGMOV_CELL_TILE) into one stage, as one copy group
__device__ __forceinline__ void stage_tile(float (*dst)[LEGMOV_CELL_TILE],
                                           const float* xs, const float* ys,
                                           const float* zs, long long stride,
                                           long long lo, long long n) {
    for (int i = threadIdx.x; i < LEGMOV_CELL_TILE; i += blockDim.x) {
        const long long f = lo + i;
        if (f < n) {
            cp_async4(&dst[0][i], xs + f * stride);
            cp_async4(&dst[1][i], ys + f * stride);
            cp_async4(&dst[2][i], zs + f * stride);
        }
    }
    cp_async_commit();
}

// One pair inside the elongated box, v = foothold - centre.  Per-leg rule:
// bit l ok, L + l ok & !cross, 2L + l ok | cross.  Shared rule: bit 0 the
// item valid ((rc >= k) | pv), 1 the item edge (cc > L - k), 2 valid & !edge.
__device__ __forceinline__ unsigned pair_bits(const DistParams* P,
                                              const CellArgs& A, float vx,
                                              float vy, float vz, bool pv) {
    const int L = A.n_legs;
    unsigned bits = 0u;
    int rc = 0, cc = 0;
    for (int l = 0; l < L; ++l) {
        const float ca = A.ca[l], sa = A.sa[l];
        const float x0 = vx * ca - vy * sa;
        const float y0 = vx * sa + vy * ca;
        float dx, dy, dz;
        const DistParams& P_l = P[A.pidx[l]];
        const bool ok = dist_point(P_l, ParamSlots{P_l}, x0, y0, vz, dx, dy, dz);
        const float wx = dx * ca + dy * sa;
        const float wy = (-dx) * sa + dy * ca;
        const float wz = dz;
        bool cross;
        if (A.big_cell)
            cross = (wx > -A.hm[0]) & (wx <= A.hm[0]) & (wy > -A.hm[1]) &
                    (wy <= A.hm[1]) & (wz > -A.hm[2]) & (wz <= A.hm[2]);
        else
            cross = (wx * wx + wy * wy + wz * wz) < A.h2m;
        rc += ok ? 1 : 0;
        cc += cross ? 1 : 0;
        bits |= (ok ? 1u : 0u) << l;
        bits |= ((ok & !cross) ? 1u : 0u) << (L + l);
        bits |= ((ok | cross) ? 1u : 0u) << (2 * L + l);
    }
    if (A.shared) {
        const bool iv = (rc >= A.k) | pv;
        const bool ie = cc > L - A.k;
        bits = (iv ? 1u : 0u) | (ie ? 2u : 0u) | ((iv & !ie) ? 4u : 0u);
    }
    return bits;
}

extern "C" __global__ void __launch_bounds__(LEGMOV_CELL_WARPS * 32,
                                             LEGMOV_CELL_MIN_BLOCKS)
legmov_dist_cells_kernel(const float* __restrict__ centers,
                         const unsigned char* __restrict__ parent_valid,
                         long long n_cells, const float* __restrict__ xs,
                         const float* __restrict__ ys,
                         const float* __restrict__ zs, long long f_stride,
                         long long n_feet, const DistParams* __restrict__ params,
                         int n_params, unsigned char* __restrict__ flags,
                         unsigned* __restrict__ scratch,
                         unsigned long long* __restrict__ audit,
                         const __grid_constant__ CellArgs A) {
    __shared__ DistParams sp[LEGMOV_CELL_MAX_LEGS];
    __shared__ float tile[2][3][LEGMOV_CELL_TILE];
    __shared__ float ring[LEGMOV_CELL_WARPS][3][LEGMOV_CELL_RING];
    {
        const int words = n_params * (int)(sizeof(DistParams) / 4);
        const int* src = reinterpret_cast<const int*>(params);
        int* dst = reinterpret_cast<int*>(sp);
        for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    const long long cell = (long long)blockIdx.x * LEGMOV_CELL_WARPS + warp;
    const bool live = cell < n_cells;
    float cx = 0.0f, cy = 0.0f, cz = 0.0f;
    bool pv = false;
    if (live) {
        cx = centers[cell * 3];
        cy = centers[cell * 3 + 1];
        cz = centers[cell * 3 + 2];
        pv = parent_valid[cell] != 0;
    }
    const int L = A.n_legs;
    const float e0 = A.elong[0], e1 = A.elong[1], e2 = A.elong[2];
    float(*rg)[LEGMOV_CELL_RING] = ring[warp];
    unsigned bits = 0u;
    int head = 0, cnt = 0;
    unsigned long long tested = 0, run = 0;

    // this block's share of the footholds: tiles y, y + splits, ...
    const long long n_tiles = (n_feet + LEGMOV_CELL_TILE - 1) / LEGMOV_CELL_TILE;
    const long long step = gridDim.y;
    long long t = blockIdx.y;
    if (t < n_tiles)
        stage_tile(tile[0], xs, ys, zs, f_stride, t * LEGMOV_CELL_TILE, n_feet);
    for (int j = 0; t < n_tiles; ++j, t += step) {
        if (t + step < n_tiles)
            stage_tile(tile[(j + 1) & 1], xs, ys, zs, f_stride,
                       (t + step) * LEGMOV_CELL_TILE, n_feet);
        else
            cp_async_commit();  // an empty group: wait_group 1 stays right
        cp_async_wait_prior();
        __syncthreads();  // tile t is in shared memory (and the legs, at j 0)
        if (live) {
            const float(*T)[LEGMOV_CELL_TILE] = tile[j & 1];
            const long long left = n_feet - t * LEGMOV_CELL_TILE;
            const int n = left < LEGMOV_CELL_TILE ? (int)left : LEGMOV_CELL_TILE;
            for (int base = 0; base < n; base += 32) {
                const int i = base + lane;
                float vx = 0.0f, vy = 0.0f, vz = 0.0f;
                bool p = false;
                if (i < n) {
                    vx = T[0][i] - cx;
                    vy = T[1][i] - cy;
                    vz = T[2][i] - cz;
                    p = (vx > -e0) & (vx <= e0) & (vy > -e1) & (vy <= e1) &
                        (vz > -e2) & (vz <= e2);
                }
                const unsigned bal = __ballot_sync(LEGMOV_FULL, p);
                if (p) {
                    const int s = (head + cnt + __popc(bal & below)) &
                                  (LEGMOV_CELL_RING - 1);
                    rg[0][s] = vx;
                    rg[1][s] = vy;
                    rg[2][s] = vz;
                }
                cnt += __popc(bal);
                if (cnt >= 32) {
                    __syncwarp();
                    const int s = (head + lane) & (LEGMOV_CELL_RING - 1);
                    bits |= pair_bits(sp, A, rg[0][s], rg[1][s], rg[2][s], pv);
                    head = (head + 32) & (LEGMOV_CELL_RING - 1);
                    cnt -= 32;
                    run += 32;
                    __syncwarp();  // the slots just read may be written next
                }
            }
            tested += n;
        }
        __syncthreads();  // every warp is through tile t, whose stage is
                          // refilled next
    }
    cp_async_wait_all();
    if (live) {
        if (lane < cnt) {
            const int s = (head + lane) & (LEGMOV_CELL_RING - 1);
            bits |= pair_bits(sp, A, rg[0][s], rg[1][s], rg[2][s], pv);
        }
        run += cnt;
    }
    unsigned all = __reduce_or_sync(LEGMOV_FULL, bits);
    if (!live || lane != 0) return;
    if (audit != nullptr) {
        atomicAdd(&audit[2 * cell], tested);
        atomicAdd(&audit[2 * cell + 1], run);
    }
    if (gridDim.y > 1) {
        // the cell's bits from every split meet in scratch; the split that
        // arrives last writes the flags and leaves the scratch zeroed
        atomicOr(&scratch[2 * cell], all);
        __threadfence();
        if (atomicAdd(&scratch[2 * cell + 1], 1u) != gridDim.y - 1) return;
        __threadfence();
        all = atomicExch(&scratch[2 * cell], 0u);
        scratch[2 * cell + 1] = 0u;
    }
    bool v, e;
    if (A.shared) {
        v = all & 1u;
        e = (all >> 1) & 1u;
        flags[2 * n_cells + cell] = (unsigned char)((all >> 2) & 1u);
    } else {
        const unsigned m = (1u << L) - 1u;
        v = (__popc(all & m) >= A.k) | pv;
        e = (__popc((all >> L) & m) < A.k) &
            (__popc((all >> (2 * L)) & m) >= A.k);
        flags[2 * n_cells + cell] = (unsigned char)(v & !e);
    }
    flags[cell] = (unsigned char)v;
    flags[n_cells + cell] = (unsigned char)e;
}

// ---------------------------------------------------------------------------
// K7, the reach probe's io-only floor (tools/reach_kernel_probe.py
// make_io_only): K1's input and output with no geometry, `(x + y) + z > 0`
// a point (NaN gives 0), so that its time is the memory floor of K1's access
// pattern.  The TPU form pads to [rows, 128] tiles; here the three SoA arrays
// stream in coalesced 16-byte loads (four points a thread a step, their four
// bytes in one 4-byte store) when every pointer is aligned, with a scalar
// loop for the tail and for unaligned arrays.  The launcher uses K1's grid
// and block, so the floor measures the same launch.
// ---------------------------------------------------------------------------

extern "C" __global__ void __launch_bounds__(LEGMOV_BLOCK)
legmov_io_only_kernel(const float* __restrict__ xs,
                      const float* __restrict__ ys,
                      const float* __restrict__ zs,
                      unsigned char* __restrict__ out, long long n) {
    const long long step = (long long)gridDim.x * blockDim.x;
    const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long done = 0;
    const bool aligned =
        ((((unsigned long long)xs | (unsigned long long)ys |
           (unsigned long long)zs) & 15ull) == 0) &&
        (((unsigned long long)out & 3ull) == 0);
    if (aligned) {
        const float4* x4 = reinterpret_cast<const float4*>(xs);
        const float4* y4 = reinterpret_cast<const float4*>(ys);
        const float4* z4 = reinterpret_cast<const float4*>(zs);
        uchar4* o4 = reinterpret_cast<uchar4*>(out);
        const long long n4 = n >> 2;
        for (long long i = first; i < n4; i += step) {
            const float4 a = x4[i], b = y4[i], c = z4[i];
            o4[i] = make_uchar4((a.x + b.x) + c.x > 0.0f,
                                (a.y + b.y) + c.y > 0.0f,
                                (a.z + b.z) + c.z > 0.0f,
                                (a.w + b.w) + c.w > 0.0f);
        }
        done = n4 << 2;
    }
    for (long long i = done + first; i < n; i += step)
        out[i] = (xs[i] + ys[i]) + zs[i] > 0.0f;
}

// ---------------------------------------------------------------------------
// C launchers
// ---------------------------------------------------------------------------

// Blocks an SM that K1's grid-stride loop is launched with (on an H100 at
// 16,777,216 points K1 took 1.09x as long with 4, 1.03x with 8, the same
// with 32).  K7, K1's yardstick, keeps the grid it was first measured
// with (blocks for one thread a point, under the same cap); at 16,777,216
// points both grids are the cap.
#define LEGMOV_REACH_BLOCKS_PER_SM 16

// Blocks of LEGMOV_BLOCK threads for `threads` threads' work, at most
// `per_sm` an SM (a grid-stride loop takes the rest).
static int grid_for(long long threads, int per_sm) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                cudaSuccess ||
            sms <= 0)
            sms = 132;
    }
    const long long want = (threads + LEGMOV_BLOCK - 1) / LEGMOV_BLOCK;
    const long long cap = (long long)sms * per_sm;
    return (int)(want < cap ? want : cap);
}

// K1's instance and I/O path come from the inputs: the six-circle instance
// where the parameter block holds six unique circles whose interval
// collapses are all legal (the shipped legs), the generic one (-1) for any
// other leg; four points a thread where the inputs are SoA arrays on 16-byte
// boundaries and the output is on a 4-byte one, the scalar loop otherwise.
extern "C" int legmov_reachability(const float* x, const float* y,
                                   const float* z, long long in_stride,
                                   unsigned char* out, long long n,
                                   const ReachParams* params, void* stream) {
    if (n <= 0) return 0;
    const int vector =
        in_stride == 1 &&
        (((unsigned long long)x | (unsigned long long)y |
          (unsigned long long)z) & 15ull) == 0 &&
        ((unsigned long long)out & 3ull) == 0;
    bool six = params->n_circles == 6;
    for (int c = 0; six && c < 6; ++c) six = params->collapse[c] != 0;
    const int grid = grid_for((n + 3) / 4, LEGMOV_REACH_BLOCKS_PER_SM);
    cudaStream_t s = (cudaStream_t)stream;
    if (six)
        legmov_reach_kernel<6><<<grid, LEGMOV_BLOCK, 0, s>>>(
            x, y, z, in_stride, out, n, vector, *params);
    else
        legmov_reach_kernel<-1><<<grid, LEGMOV_BLOCK, 0, s>>>(
            x, y, z, in_stride, out, n, vector, *params);
    return (int)cudaGetLastError();
}

extern "C" int legmov_io_only(const float* x, const float* y, const float* z,
                              unsigned char* out, long long n, void* stream) {
    if (n <= 0) return 0;
    legmov_io_only_kernel<<<grid_for(n, 16), LEGMOV_BLOCK, 0,
                            (cudaStream_t)stream>>>(x, y, z, out, n);
    return (int)cudaGetLastError();
}

extern "C" int legmov_distance(const float* x, const float* y, const float* z,
                               long long in_stride, unsigned char* ok,
                               float* dx, float* dy, float* dz,
                               long long out_stride, long long n,
                               const DistParams* params, void* stream) {
    if (n <= 0) return 0;
    legmov_dist_kernel<<<grid_for(n, 16), LEGMOV_BLOCK, 0,
                         (cudaStream_t)stream>>>(x, y, z, in_stride, ok, dx, dy,
                                                 dz, out_stride, n, *params);
    return (int)cudaGetLastError();
}

// Splits of the foothold range a batch of `n_cells` cells and `n_feet`
// footholds is launched with by default: enough blocks for four waves of
// the warps the card holds at once (the later waves even out cells of
// unequal work), at most one split a tile.
static long long cell_splits(long long n_cells, long long n_feet) {
    static int resident = 0;
    if (resident == 0) {
        int dev = 0, sms = 0, nb = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                cudaSuccess ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &nb, legmov_dist_cells_kernel, LEGMOV_CELL_WARPS * 32, 0) !=
                cudaSuccess ||
            sms <= 0 || nb <= 0)
            return 1;
        resident = sms * nb * LEGMOV_CELL_WARPS;
    }
    const long long n_tiles = (n_feet + LEGMOV_CELL_TILE - 1) / LEGMOV_CELL_TILE;
    long long s = (4LL * resident + n_cells - 1) / n_cells;
    if (s > n_tiles) s = n_tiles;
    if (s > 65535) s = 65535;
    return s < 1 ? 1 : s;
}

// flags: uint8 [3, n_cells] (valid, edge, leaf rows).  cell_splits() blocks
// share a cell's footholds; more than one needs `scratch`, uint32
// [2 * n_cells], zero, which the kernel leaves zero.  audit, when not null:
// uint64 [n_cells, 2], zero, gains the footholds each cell tested and the
// pairs it sent through the legs.
extern "C" int legmov_distance_cells(const float* centers,
                                     const unsigned char* parent_valid,
                                     long long n_cells, const float* x,
                                     const float* y, const float* z,
                                     long long f_stride, long long n_feet,
                                     const DistParams* params, int n_params,
                                     unsigned char* flags, unsigned* scratch,
                                     long long* audit, const CellArgs* args,
                                     void* stream) {
    if (n_cells <= 0) return 0;
    if (n_params < 1 || n_params > LEGMOV_CELL_MAX_LEGS || args->n_legs < 1 ||
        args->n_legs > LEGMOV_CELL_MAX_LEGS)
        return (int)cudaErrorInvalidValue;
    const int splits = (int)cell_splits(n_cells, n_feet);
    if (splits > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const dim3 grid(
        (unsigned)((n_cells + LEGMOV_CELL_WARPS - 1) / LEGMOV_CELL_WARPS),
        (unsigned)splits);
    legmov_dist_cells_kernel<<<grid, LEGMOV_CELL_WARPS * 32, 0,
                               (cudaStream_t)stream>>>(
        centers, parent_valid, n_cells, x, y, z, f_stride, n_feet, params,
        n_params, flags, scratch, (unsigned long long*)audit, *args);
    return (int)cudaGetLastError();
}

// How the cell kernel is launched: registers and local memory a thread,
// threads and shared memory a block, blocks an SM.
extern "C" int legmov_dist_cells_occupancy(int* regs, int* local_bytes,
                                           int* threads, int* smem_bytes,
                                           int* blocks_per_sm) {
    const void* fn = (const void*)legmov_dist_cells_kernel;
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, fn);
    int nb = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &nb, fn, LEGMOV_CELL_WARPS * 32, 0);
    if (e != cudaSuccess) return (int)e;
    *regs = fa.numRegs;
    *local_bytes = (int)fa.localSizeBytes;
    *threads = LEGMOV_CELL_WARPS * 32;
    *smem_bytes = (int)fa.sharedSizeBytes;
    *blocks_per_sm = nb;
    return 0;
}

extern "C" int legmov_param_sizes(int* reach_bytes, int* dist_bytes,
                                  int* cell_bytes) {
    *reach_bytes = (int)sizeof(ReachParams);
    *dist_bytes = (int)sizeof(DistParams);
    *cell_bytes = (int)sizeof(CellArgs);
    return 0;
}
