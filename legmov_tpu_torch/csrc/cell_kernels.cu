// Hierarchical-solve kernels for Hopper (sm_90a): the fused validity_child
// item over dense candidates, and the three CSR cell-evaluation forms.
//
// Build (legmov_tpu_torch/ops/_build.py does this at first use, with the same
// flags as leg_kernels.cu):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -ftz=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
//
// Numerics are the contract, as in leg_kernels.cu: no FMA contraction, IEEE
// sqrtf and divide, and every expression in the order of the plain PyTorch
// versions (ops/cuda_multileg_dist.py item_head_plain / item_leg_plain), so
// that each kernel gives its plain version's bits on the same card: the
// corner score is (((q - (2 pcx) xp) - (2 pcy) yp) + pcx pcx) + pcy pcy, the
// first corner is pcx + 0.0f * xp (NaN for a NaN or infinite xp), and the
// clamp uses one rsqrtf of (deg ? 1 : d2).
//
// No PyTorch headers: plain C launchers, loaded with ctypes.  What is static
// per leg (mount yaw, coxa frame, coxa yaw limits, the five saturation
// threshold directions) arrives as one by-value `__grid_constant__` block for
// up to six legs; what depends on the orientation (per leg the [2][2][4]
// circle tables, ten corners and the region threshold directions: 151 floats)
// is one row of a packed table, staged in shared memory: K6c as the table
// holds it, K5, K6a and K6b in a layout of their own (below) that gives a
// circle or a corner in two 16-byte loads.
//
// One device function under five kernels: item_head + item_leg are the fused
// validity_child item (several_leg_octree.cu:19-151), one body over either
// layout; K5 runs it over dense candidates (the item form over candidate
// rows, the cell driver over a batch's footholds), K6a/K6b/K6c over per-cell
// queues of CSR chunks.  Every kernel inlines the item, so no call saves
// live registers around each leg (out of line it ran 10-20 % slower).

#include <cuda_runtime.h>

#define CK_MAX_LEGS 6
#define CK_HDR 16          // quat 4, position 3, parent_valid, hm 3, h2m,
                           // big_cell, elong 3
#define CK_LEG_BLOCK 151   // floats per leg in a table row
#define CK_MAX_W 1024      // table floats for six legs, padded to 128
#define CK_BLOCK 256
#define CK_OUT_WORDS 10    // valid, edge, leaf, 3 work counters, 4 element counters
#define CK_MAX_QUATS 64
#define CK_MAX_WINDOW 40960  // K6b keeps a 16-bit word per element of a chunk
#define CK_FULL 0xffffffffu

#define CK_RING 64           // per-warp ring of candidates that passed the head

// offsets inside a leg block of a table row (ops/cuda_multileg_dist.py
// leg_blocks); circle tables are [upper][ext][slot]
#define CK_CX 0
#define CK_CY 16
#define CK_CR 32
#define CK_CR2 48
#define CK_CHI2 64
#define CK_CLO2 80
#define CK_ATT 96
#define CK_CORX 112
#define CK_CORY 122
#define CK_CORV 132
#define CK_MID_DIR 142
#define CK_MID_NEG 144
#define CK_SAT_DIR 145
#define CK_SAT_NEG 149

// The kernels stage a row in shared memory in a layout of their own: the
// header as it is, then per leg a record of CK_KL_LEG floats, 16-byte
// aligned, so that a circle or a corner is two 16-byte loads:
//   circle r = 4 (2 upper + ext) + slot at CK_KL_CIRC + 8 r:
//       cx, cy, r2, hi2 | lo2, att, r, 0
//   corner j at CK_KL_CORN + 8 j: pcx, pcy, 2 pcx, 2 pcy | pcx pcx, pcy pcy,
//       valid, 0
//   CK_KL_DIR: mid_dir 2, mid_neg, sat_neg lo | sat_dir 4 | sat_neg hi, 0...
// 2 pcx is exact and pcx pcx is the product the item formed itself, so the
// corner score keeps its bits.
#define CK_KL_CIRC 0
#define CK_KL_CORN 128
#define CK_KL_DIR 208
#define CK_KL_LEG 224
#define CK_KW(L) (CK_HDR + (L) * CK_KL_LEG)
#define CK_MAX_KW CK_KW(CK_MAX_LEGS)
// a row as the table holds it, rounded up to 16 bytes
#define CK_TW(L) ((CK_HDR + (L) * CK_LEG_BLOCK + 3) / 4 * 4)

// mirrored field for field by ctypes.Structure in ops/cuda_multileg_dist.py;
// every member is 4 bytes wide, so there is no padding
struct ItemParams {
    int n_legs, table_width, k;
    int balls;  // K6b's launcher refuses 0: the balls below are unset
    float margin2, big;
    float ca[CK_MAX_LEGS], sa[CK_MAX_LEGS];      // cos / sin of -body_angle
    float body[CK_MAX_LEGS];
    float cp[CK_MAX_LEGS], sp[CK_MAX_LEGS];      // cos / sin of -coxa_pitch
    float cpi[CK_MAX_LEGS], spi[CK_MAX_LEGS];    // cos / sin of +coxa_pitch
    float coxa_len[CK_MAX_LEGS];
    float cmax_c[CK_MAX_LEGS], cmax_s[CK_MAX_LEGS];
    float cmin_c[CK_MAX_LEGS], cmin_s[CK_MAX_LEGS];
    // threshold directions mega_hi, mega_lo, max, min, mid of leg l at l*5
    float dir_c[CK_MAX_LEGS * 5], dir_s[CK_MAX_LEGS * 5];
    int dir_neg[CK_MAX_LEGS * 5];
    // leg l's reach balls in the body frame (ops/csr_cell_eval.py
    // element_balls): centre the coxa mount, squared radii r_ok and r_in of
    // build_cell_queue's role masks
    float ball_x[CK_MAX_LEGS], ball_y[CK_MAX_LEGS], ball_z[CK_MAX_LEGS];
    float ball_ok2[CK_MAX_LEGS], ball_in2[CK_MAX_LEGS];
};

// ---------------------------------------------------------------------------
// the item
// ---------------------------------------------------------------------------

// raw atan2(ay, ax) > theta for a threshold direction, trig-free
__device__ __forceinline__ bool angle_gt(float ax, float ay, float c, float s,
                                         int theta_neg) {
    const bool pos = (ay * c - ax * s) > 0.0f;
    const bool nn = ay >= 0.0f;
    return theta_neg ? (nn | pos) : (nn & pos);
}

// raw atan2(ay, ax) < theta (strict), mirror of angle_gt
__device__ __forceinline__ bool angle_lt(float ax, float ay, float c, float s,
                                         int theta_neg) {
    const bool below = ay < 0.0f;
    const bool ng = (ay * c - ax * s) < 0.0f;
    return theta_neg ? (below & ng) : (below | ng);
}

// the relative vector r = candidate - item position, un-rotated by the
// item's quaternion T[0..3] (its conjugate rotation)
__device__ __forceinline__ void item_unrotate(const float* T, float rx,
                                              float ry, float rz, float& vx,
                                              float& vy, float& vz) {
    const float w = T[0];
    const float ux = -T[1];
    const float uy = -T[2];
    const float uz = -T[3];
    const float tx = 2.0f * (uy * rz - uz * ry);
    const float ty = 2.0f * (uz * rx - ux * rz);
    const float tz = 2.0f * (ux * ry - uy * rx);
    vx = rx + w * tx + (uy * tz - uz * ty);
    vy = ry + w * ty + (uz * tx - ux * tz);
    vz = rz + w * tz + (ux * ty - uy * tx);
}

// the elongated-box prefilter on the unrotated relative vector, half-extents
// (e0, e1, e2); NaN and inf components fail it
__device__ __forceinline__ bool in_box(float rx, float ry, float rz, float e0,
                                       float e1, float e2) {
    return (rx > -e0) & (rx <= e0) & (ry > -e1) & (ry <= e1) & (rz > -e2) &
           (rz <= e2);
}

// candidate relative to the item, un-rotated by the item's quaternion, and
// the elongated-box prefilter on the unrotated relative vector; T = the
// item's table row
__device__ __forceinline__ bool item_head(const float* T, float x, float y,
                                          float z, float& vx, float& vy,
                                          float& vz) {
    const float rx = x - T[4];
    const float ry = y - T[5];
    const float rz = z - T[6];
    item_unrotate(T, rx, ry, rz, vx, vy, vz);
    return in_box(rx, ry, rz, T[13], T[14], T[15]);
}

// entry i of a row in the kernels' layout, from `row`, a row of the table
__device__ __forceinline__ float staged_value(const float* row, int i) {
    if (i < CK_HDR) return row[i];
    const int l = (i - CK_HDR) / CK_KL_LEG;
    const int o = (i - CK_HDR) - l * CK_KL_LEG;
    const float* B = row + CK_HDR + l * CK_LEG_BLOCK;
    if (o < CK_KL_CORN) {
        const int r = o >> 3;
        switch (o & 7) {
            case 0: return B[CK_CX + r];
            case 1: return B[CK_CY + r];
            case 2: return B[CK_CR2 + r];
            case 3: return B[CK_CHI2 + r];
            case 4: return B[CK_CLO2 + r];
            case 5: return B[CK_ATT + r];
            case 6: return B[CK_CR + r];
            default: return 0.0f;
        }
    }
    if (o < CK_KL_DIR) {
        const int j = (o - CK_KL_CORN) >> 3;
        const float pcx = B[CK_CORX + j], pcy = B[CK_CORY + j];
        switch (o & 7) {
            case 0: return pcx;
            case 1: return pcy;
            case 2: return 2.0f * pcx;
            case 3: return 2.0f * pcy;
            case 4: return pcx * pcx;
            case 5: return pcy * pcy;
            case 6: return B[CK_CORV + j];
            default: return 0.0f;
        }
    }
    switch (o - CK_KL_DIR) {
        case 0: return B[CK_MID_DIR];
        case 1: return B[CK_MID_DIR + 1];
        case 2: return B[CK_MID_NEG];
        case 3: return B[CK_SAT_NEG];
        case 4: return B[CK_SAT_DIR];
        case 5: return B[CK_SAT_DIR + 1];
        case 6: return B[CK_SAT_DIR + 2];
        case 7: return B[CK_SAT_DIR + 3];
        case 8: return B[CK_SAT_NEG + 1];
        default: return 0.0f;
    }
}

// entries t0, t0 + step, ... of row `row` in the kernels' layout, `kw`
// floats, into T; with `cell`, header slots 4-7 become the cell centre and
// parent-valid
__device__ __forceinline__ void stage_entries(float* T, const float* row,
                                              int kw, int t0, int step,
                                              const float* cell, bool pv) {
    for (int i = t0; i < kw; i += step) {
        float v = staged_value(row, i);
        if (cell != nullptr && i >= 4 && i < 8)
            v = i < 7 ? cell[i - 4] : (pv ? 1.0f : 0.0f);
        T[i] = v;
    }
}

__device__ __forceinline__ float4 lds4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// the same load, which the compiler may not merge with an earlier one of the
// same address (so what it loaded need not stay live in registers)
__device__ __forceinline__ float4 lds4_again(const float* p) {
#if defined(__CUDA_ARCH__)
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"((unsigned)__cvta_generic_to_shared(p)));
    return v;
#else
    return lds4(p);
#endif
}

// What the plane clamp reads of a leg: one circle, one corner, the
// threshold directions that pick the (upper, ext) configuration.
struct Circle { float cx, cy, r2, hi2, lo2, r; bool att; };
struct Corner { float pcx, pcy, tpx, tpy, pxx, pyy; bool valid; };
struct Dirs { float mid_c, mid_s, lo_c, lo_s, hi_c, hi_s; bool mid_neg, lo_neg, hi_neg; };

// Where the item finds them.  TableRow: a row of the table as the table
// holds it (ops/cuda_multileg_dist.py leg_blocks); K6c stages that.
// Staged: the kernels' layout above, two 16-byte loads a circle or corner;
// K5, K6a and K6b stage that.  The corner's 2 pcx and pcx pcx are the same
// values either way, so both give the same bits.
struct TableRow {
    static constexpr int leg_floats = CK_LEG_BLOCK;
    __device__ static Dirs dirs(const float* B) {
        return {B[CK_MID_DIR], B[CK_MID_DIR + 1], B[CK_SAT_DIR],
                B[CK_SAT_DIR + 1], B[CK_SAT_DIR + 2], B[CK_SAT_DIR + 3],
                B[CK_MID_NEG] > 0.5f, B[CK_SAT_NEG] > 0.5f,
                B[CK_SAT_NEG + 1] > 0.5f};
    }
    // circle r = 4 (2 upper + ext) + slot
    __device__ static Circle circle(const float* B, int r) {
        return {B[CK_CX + r], B[CK_CY + r], B[CK_CR2 + r], B[CK_CHI2 + r],
                B[CK_CLO2 + r], B[CK_CR + r], B[CK_ATT + r] > 0.5f};
    }
    __device__ static Circle circle_again(const float* B, int r) {
        return circle(B, r);
    }
    __device__ static Corner corner(const float* B, int j) {
        const float pcx = B[CK_CORX + j], pcy = B[CK_CORY + j];
        return {pcx, pcy, 2.0f * pcx, 2.0f * pcy, pcx * pcx, pcy * pcy,
                B[CK_CORV + j] > 0.5f};
    }
};

struct Staged {
    static constexpr int leg_floats = CK_KL_LEG;
    __device__ static Dirs dirs(const float* B) {
        const float4 d0 = lds4(B + CK_KL_DIR);
        const float4 d1 = lds4(B + CK_KL_DIR + 4);
        return {d0.x, d0.y, d1.x, d1.y, d1.z, d1.w, d0.z > 0.5f, d0.w > 0.5f,
                B[CK_KL_DIR + 8] > 0.5f};
    }
    __device__ static Circle circle(const float* B, int r) {
        const float4 u = lds4(B + CK_KL_CIRC + 8 * r);
        const float4 w = lds4(B + CK_KL_CIRC + 8 * r + 4);
        return {u.x, u.y, u.z, u.w, w.x, w.z, w.y > 0.5f};
    }
    __device__ static Circle circle_again(const float* B, int r) {
        const float4 u = lds4_again(B + CK_KL_CIRC + 8 * r);
        const float4 w = lds4_again(B + CK_KL_CIRC + 8 * r + 4);
        return {u.x, u.y, u.z, u.w, w.x, w.z, w.y > 0.5f};
    }
    __device__ static Corner corner(const float* B, int j) {
        const float4 u = lds4(B + CK_KL_CORN + 8 * j);
        const float4 w = lds4(B + CK_KL_CORN + 8 * j + 4);
        return {u.x, u.y, u.z, u.w, w.x, w.y, w.z > 0.5f};
    }
};

// ops/plane.py plane_clamp on the (upper, ext) configuration's four circles
// and the ten corners; B = the leg's part of the staged row
template <class Lay>
__device__ __forceinline__ void plane_clamp(const ItemParams& P, const float* B,
                                            float xp, float yp, bool& overall,
                                            float& out_x, float& out_y) {
    const Dirs d = Lay::dirs(B);
    const bool nn = yp >= 0.0f;
    const bool crossm = (yp * d.mid_c - xp * d.mid_s) > 0.0f;
    const bool upper = nn ? (d.mid_neg | crossm) : (d.mid_neg & crossm);
    const bool c_lo = (yp * d.lo_c - xp * d.lo_s) > 0.0f;
    const bool c_hi = (yp * d.hi_c - xp * d.hi_s) > 0.0f;
    const bool gt_lo = nn ? (d.lo_neg | c_lo) : (d.lo_neg & c_lo);
    const bool gt_hi = nn ? (d.hi_neg | c_hi) : (d.hi_neg & c_hi);
    const bool ext = upper ^ (upper ? gt_hi : gt_lo);
    const int base = (upper ? 8 : 0) + (ext ? 4 : 0);

    float clamp_x[4], clamp_y[4], score[4];
    overall = true;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        const Circle c = Lay::circle(B, base + s);
        const float dx = xp - c.cx;
        const float dy = yp - c.cy;
        const float d2 = dx * dx + dy * dy;
        const bool inside = d2 <= c.r2;
        const bool near = (d2 < c.hi2) & (d2 > c.lo2);
        overall = overall & ((c.att ? inside : !inside) | near);
        const bool deg = d2 < P.margin2;
        const float rinv = rsqrtf(deg ? 1.0f : d2);
        const float mag = d2 * rinv;
        const float scale = c.r * rinv;
        clamp_x[s] = c.cx + (deg ? 1.0f : dx) * scale;
        clamp_y[s] = c.cy + (deg ? 0.0f : dy) * scale;
        score[s] = (c.r - mag) * (c.r - mag);
    }

    float best_s2 = P.big, best_x = 0.0f, best_y = 0.0f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        bool okc = true;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            if (t == s) continue;  // a clamp lies on its own circumference
            const Circle c = Lay::circle_again(B, base + t);
            const float dx = clamp_x[s] - c.cx;
            const float dy = clamp_y[s] - c.cy;
            const float d2 = dx * dx + dy * dy;
            const bool inside = d2 <= c.r2;
            const bool near = (d2 < c.hi2) & (d2 > c.lo2);
            okc = okc & ((c.att ? inside : !inside) | near);
        }
        const float s2 = okc ? score[s] : P.big;
        const bool take = s2 < best_s2;
        best_s2 = take ? s2 : best_s2;
        best_x = take ? clamp_x[s] : best_x;
        best_y = take ? clamp_y[s] : best_y;
    }

    // corner-only tournament (first wins, strict <), merged with the circle
    // winner once and only for an invalid query; the score is
    // (((q - (2 pcx) xp) - (2 pcy) yp) + pcx pcx) + pcy pcy
    const float q = xp * xp + yp * yp;
    float c_s2 = 0.0f, c_x = 0.0f, c_y = 0.0f;
#pragma unroll
    for (int j = 0; j < 10; ++j) {
        const Corner c = Lay::corner(B, j);
        float s2 = q - c.tpx * xp - c.tpy * yp + c.pxx + c.pyy;
        s2 = c.valid ? s2 : P.big;
        if (j == 0) {
            c_s2 = s2;
            c_x = c.pcx + 0.0f * xp;
            c_y = c.pcy + 0.0f * xp;
        } else {
            const bool take = s2 < c_s2;
            c_s2 = take ? s2 : c_s2;
            c_x = take ? c.pcx : c_x;
            c_y = take ? c.pcy : c_y;
        }
    }
    const bool take = (!overall) & (c_s2 < best_s2);
    best_s2 = take ? c_s2 : best_s2;
    best_x = take ? c_x : best_x;
    best_y = take ? c_y : best_y;
    const bool found = best_s2 < P.big;
    out_x = xp - (found ? best_x : 0.0f);
    out_y = yp - (found ? best_y : 0.0f);
}

// ops/distance.py _finish_finding_closest.  `flipped` selects the pi-flip
// branch, whose raw angle is the angle of direction (-x, -y).
template <class Lay>
__device__ __forceinline__ void finish(const ItemParams& P, int l,
                                       const float* B, float x, float y,
                                       float z, float cos_a, float sin_a,
                                       bool flipped, bool& res, float& gx,
                                       float& gy, float& gz) {
    const float* dc = P.dir_c + l * 5;
    const float* ds = P.dir_s + l * 5;
    const int* dn = P.dir_neg + l * 5;
    const float ax = flipped ? -x : x;
    const float ay = flipped ? -y : y;
    const bool mega = angle_gt(ax, ay, dc[0], ds[0], dn[0]) |
                      angle_lt(ax, ay, dc[1], ds[1], dn[1]);
    const bool over = angle_gt(ax, ay, dc[2], ds[2], dn[2]);
    const bool under = angle_lt(ax, ay, dc[3], ds[3], dn[3]);
    const bool saturated = mega | over | under;
    const float c1 =
        mega ? -cos_a : (over ? P.cmax_c[l] : (under ? P.cmin_c[l] : cos_a));
    const float s1 =
        mega ? -sin_a : (over ? P.cmax_s[l] : (under ? P.cmin_s[l] : sin_a));
    const float xr = x * c1 + y * s1;
    const float yr = (-x) * s1 + y * c1;
    bool was_valid;
    float dxp, dzp;
    plane_clamp<Lay>(P, B, xr - P.coxa_len[l], z, was_valid, dxp, dzp);
    // alternative boundary: the coxa angular-limit plane
    const bool use_max = angle_gt(ax, ay, dc[4], ds[4], dn[4]);
    const float cl = use_max ? P.cmax_c[l] : P.cmin_c[l];
    const float sl = use_max ? P.cmax_s[l] : P.cmin_s[l];
    const float c2 = cl * c1 + sl * s1;
    const float s2 = sl * c1 - cl * s1;
    const float ys = (-xr) * s2 + yr * c2;
    const float d2c = dxp * dxp + yr * yr + dzp * dzp;
    const bool better = was_valid & (!mega) & (d2c > ys * ys);
    const float fx = better ? (-ys) * s2 : dxp;
    const float fy = better ? ys * c2 : yr;
    gz = better ? 0.0f : dzp;
    gx = fx * c1 - fy * s1;
    gy = fx * s1 + fy * c1;
    res = was_valid & (!saturated);
}

// leg l of the item for one body-frame candidate: the distance pipeline, the
// displacement back in the world frame, and the crossing test against the
// item's cell box.  T = the staged row, in layout Lay.  Call only for a
// candidate that passed the prefilter: both results are gated by it.
// Returns ok in bit 0 and crossed in bit 1.
template <class Lay = Staged>
__device__ __forceinline__ unsigned item_leg(const ItemParams& P, int l,
                                             const float* T, float vx,
                                             float vy, float vz) {
    const float* B = T + CK_HDR + l * Lay::leg_floats;
    // yaw to "as if leg 0", then the coxa frame
    const float x0 = vx * P.ca[l] - vy * P.sa[l];
    const float y = vx * P.sa[l] + vy * P.ca[l];
    const float px = x0 - P.body[l];
    const float x = px * P.cp[l] - vz * P.sp[l];
    const float z = px * P.sp[l] + vz * P.cp[l];
    const float rho = sqrtf(x * x + y * y);
    const bool on_axis = rho == 0.0f;
    const float inv = on_axis ? 1.0f : rho;
    const float cos_a = on_axis ? 1.0f : x / inv;
    const float sin_a = on_axis ? 0.0f : y / inv;

    bool res, resf;
    float dx, dy, dz, fx, fy, fz;
    finish<Lay>(P, l, B, x, y, z, cos_a, sin_a, false, res, dx, dy, dz);
    finish<Lay>(P, l, B, x, y, z, -cos_a, -sin_a, true, resf, fx, fy, fz);
    const float d2d = dx * dx + dy * dy + dz * dz;
    const float d2f = fx * fx + fy * fy + fz * fz;
    const bool use_d = (res == resf) ? (d2d < d2f) : res;
    const float ox = use_d ? dx : fx;
    const float oy = use_d ? dy : fy;
    const float oz = use_d ? dz : fz;
    const bool ok = res | resf;
    // vector back: coxa pitch inverse, yaw by +azimuth, then the body
    // quaternion (not its conjugate): compared with the axis-aligned cell box
    const float wx0 = ox * P.cpi[l] - oz * P.spi[l];
    const float wz0 = ox * P.spi[l] + oz * P.cpi[l];
    const float wx1 = wx0 * P.ca[l] + oy * P.sa[l];
    const float wy1 = (-wx0) * P.sa[l] + oy * P.ca[l];
    const float qw = T[0], qx = T[1], qy = T[2], qz = T[3];
    const float t2x = 2.0f * (qy * wz0 - qz * wy1);
    const float t2y = 2.0f * (qz * wx1 - qx * wz0);
    const float t2z = 2.0f * (qx * wy1 - qy * wx1);
    const float wvx = wx1 + qw * t2x + (qy * t2z - qz * t2y);
    const float wvy = wy1 + qw * t2y + (qz * t2x - qx * t2z);
    const float wvz = wz0 + qw * t2z + (qx * t2y - qy * t2x);
    const float hmx = T[8], hmy = T[9], hmz = T[10];
    const bool cross_big = (wvx > -hmx) & (wvx <= hmx) & (wvy > -hmy) &
                           (wvy <= hmy) & (wvz > -hmz) & (wvz <= hmz);
    const float dv2 = wvx * wvx + wvy * wvy + wvz * wvz;
    const bool cross_small = dv2 < T[11];
    const bool crossed = (T[12] > 0.5f) ? cross_big : cross_small;
    return (ok ? 1u : 0u) | (crossed ? 2u : 0u);
}

// ---------------------------------------------------------------------------
// K5  fused multi-leg distance item over dense candidates: the item form
//     ([P, W] items x candidate rows; the solver's dense path runs the cell
//     driver below)
//
// Replaces the Pallas kernel legmov_tpu/ops/pallas_multileg_dist.py
// make_multileg_distance_kernel (body `kernel`, item from make_item_parts).
//
// Per pose item (one (cell, orientation) pair) and candidate: head, every
// leg, reach_cnt >= k, cross_cnt > L - k, and 3L + 3 any-reductions over the
// candidate axis, packed as bits l, L + l, 2L + l, 3L, 3L + 1, 3L + 2 of one
// word per item.  The candidate row may be shared by all items.
//
// Bound on this card: per (item, candidate) 39 fp32 operations for the head
// and 860 per leg (HEAD_FLOPS, LEG_FLOPS in ops/cuda_multileg_dist.py) for a
// candidate inside the item's elongated box; a shared candidate row is 12
// bytes a candidate once, read from L2 by every item.  Operations bound it
// by two orders of magnitude wherever candidates pass the box.
//
// Design: one block per (item, slab of candidates), as K3: the item's row
// (640 or 1024 floats) goes to shared memory once, a thread keeps the 3L + 3
// result bits in a register, a candidate outside the elongated box costs the
// head only (every output is gated by it), one warp OR, one shared and one
// global atomic OR a block.  The TPU form's [8, C] tile, its C % 128 and the
// padding of the item axis to 8 are not carried over.  Registers are capped
// at 128 (two blocks an SM), what the out-of-line item gave it.
// ---------------------------------------------------------------------------

extern "C" __global__ void __launch_bounds__(CK_BLOCK, 2)
legmov_item_kernel(const float* __restrict__ tab, const float* __restrict__ gx,
                   const float* __restrict__ gy, const float* __restrict__ gz,
                   long long C, long long slab, int shared_row,
                   int* __restrict__ out_bits,
                   const __grid_constant__ ItemParams P) {
    __shared__ __align__(16) float T[CK_MAX_KW];
    __shared__ unsigned bits_sh;
    const long long item = blockIdx.x;
    const int L = P.n_legs;
    stage_entries(T, tab + item * P.table_width, CK_KW(L), threadIdx.x,
                  blockDim.x, nullptr, false);
    if (threadIdx.x == 0) bits_sh = 0u;
    __syncthreads();

    const long long lo = (long long)blockIdx.y * slab;
    const long long hi = (lo + slab < C) ? lo + slab : C;
    const long long row = shared_row ? 0 : item * C;
    const bool pv = T[7] > 0.5f;
    unsigned bits = 0u;
    for (long long c = lo + threadIdx.x; c < hi; c += blockDim.x) {
        float vx, vy, vz;
        if (!item_head(T, gx[row + c], gy[row + c], gz[row + c], vx, vy, vz))
            continue;
        int rc = 0, cc = 0;
        for (int l = 0; l < L; ++l) {
            const unsigned r = item_leg<Staged>(P, l, T, vx, vy, vz);
            const bool ok = r & 1u, crossed = (r >> 1) & 1u;
            bits |= (ok ? 1u : 0u) << l;
            bits |= ((ok & !crossed) ? 1u : 0u) << (L + l);
            bits |= ((ok | crossed) ? 1u : 0u) << (2 * L + l);
            rc += ok ? 1 : 0;
            cc += crossed ? 1 : 0;
        }
        const bool iv = (rc >= P.k) | pv;
        const bool ie = cc > L - P.k;
        bits |= (iv ? 1u : 0u) << (3 * L);
        bits |= (ie ? 1u : 0u) << (3 * L + 1);
        bits |= ((iv & !ie) ? 1u : 0u) << (3 * L + 2);
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
    if ((threadIdx.x & 31) == 0 && bits) atomicOr(&bits_sh, bits);
    __syncthreads();
    if (threadIdx.x == 0 && bits_sh) atomicOr(out_bits + item, (int)bits_sh);
}

// ---------------------------------------------------------------------------
// K5, cell driver: the orientation-active levels of `cli solve --candidates
// dense`, one launch a batch
//
// Replaces the same Pallas kernel as legmov_item_kernel, with what XLA fused
// around it in legmov_tpu/models/hier_solver.py _eval_cells (the scan over
// foothold chunks, the any over orientations, the per-leg rule's fold): for
// a batch of cells, the level's S orientations and the batch's footholds it
// gives each cell's (valid, edge, leaf) flags.  Per (cell, foothold) pair:
// r = f - c and the elongated-box prefilter, once; per pair inside the box
// and orientation: the un-rotation by the orientation's quaternion, then
// per leg the item's leg pipeline (item_leg), in the plain version's order
// (ops/cuda_multileg_dist.py item_cells_plain), so the flags are its bits.
//
// Bound on this card: operations.  9 per (cell, foothold) pair for the box
// test (3 subtractions, 6 compares), then per pair inside the box and
// orientation 30 for the un-rotation and 860 per leg, counted over the
// work that decides the flags: a walk over each cell's footholds in order
// that stops settled work as below (item_cells_need in
// ops/cuda_multileg_dist.py).  The bytes (S table rows, the cells, a
// foothold subset of a few MB at most, three bytes a cell out) are noise.
//
// Design.  One warp a cell, IC_WARPS cells a block.  The block stages the S
// rows in the kernels' layout in shared memory once (the leg blocks depend
// on the orientation only; the cell's centre and parent-valid stay in
// registers) and streams the footholds through shared memory in
// double-buffered cp.async tiles, as K2's cell driver does.  Each lane
// box-tests one foothold of the tile and a ballot writes the in-box vectors
// into the warp's ring, so the box test runs once per (cell, foothold) and
// the S x L leg pipelines of a pair run on full warps (the last partial
// batch aside).  Per-leg rule: per orientation the warp keeps the 3L run
// bits in shared memory (OR-ed over its lanes after each batch of 32 pairs)
// and skips a leg whose bits are settled (any ok and ok & !crossed seen,
// so ok | crossed too: nothing it gives can change them); the fold to valid
// and edge is made once every foothold is seen.  Shared rule: a lane ORs
// (valid, edge, leaf) over its pairs and orientations; once the warp holds
// all three the cell is decided and its warp skips the rest, and once it
// holds edge (and the cell has no valid parent) the legs of an orientation
// stop as soon as no lane's pair can still reach k (K6b's leg chain).  One
// kernel a rule (each its own registers).  A cell's footholds are shared by
// `splits` blocks (enough for one or two waves of resident warps, at most
// one a tile); their bits meet in a scratch row with atomicOr and the split
// that arrives last writes the flags.
// ---------------------------------------------------------------------------

#define IC_WARPS 8    // cells a block, one warp each
#define IC_TILE 256   // footholds a shared-memory stage
#define IC_RING 64    // per-warp ring of in-box vectors

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

// footholds [lo, lo + IC_TILE) into one stage ([3][IC_TILE]), one copy group
__device__ __forceinline__ void stage_feet(float* dst, const float* xs,
                                           const float* ys, const float* zs,
                                           long long stride, long long lo,
                                           long long n) {
    for (int i = threadIdx.x; i < IC_TILE; i += blockDim.x) {
        const long long f = lo + i;
        if (f < n) {
            cp_async4(dst + i, xs + f * stride);
            cp_async4(dst + IC_TILE + i, ys + f * stride);
            cp_async4(dst + 2 * IC_TILE + i, zs + f * stride);
        }
    }
    cp_async_commit();
}

// dynamic shared memory of a block: S rows, two foothold stages, the rings,
// S run words a warp
static size_t item_cells_bytes(int n_legs, int S) {
    return 4 * ((size_t)S * CK_KW(n_legs) + 6 * IC_TILE +
                IC_WARPS * 3 * IC_RING + (size_t)IC_WARPS * S);
}

// one warp's cell; SHARED: the shared rule, else the per-leg rule
template <bool SHARED>
__device__ __forceinline__ void item_cells(
    const float* __restrict__ legtab, int S, const float* __restrict__ centers,
    const unsigned char* __restrict__ parent_valid, long long n_cells,
    const float* __restrict__ xs, const float* __restrict__ ys,
    const float* __restrict__ zs, long long f_stride, long long n_feet,
    unsigned char* __restrict__ flags, unsigned* __restrict__ scratch,
    const ItemParams& P) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int L = P.n_legs, k = P.k;
    const int kw = CK_KW(L);
    const unsigned Lmask = (1u << L) - 1u;
    float* rows = reinterpret_cast<float*>(smem);
    float* tile = rows + S * kw;               // [2][3][IC_TILE]
    float* rings = tile + 6 * IC_TILE;         // [IC_WARPS][3][IC_RING]
    unsigned* runs =
        reinterpret_cast<unsigned*>(rings + IC_WARPS * 3 * IC_RING);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    for (int i = threadIdx.x; i < S * kw; i += blockDim.x) {
        const int q = i / kw;
        rows[i] = staged_value(legtab + (long long)q * P.table_width,
                               i - q * kw);
    }
    unsigned* run = runs + warp * S;  // per-leg rule: 3L run bits a row
    for (int q = lane; q < S; q += 32) run[q] = 0u;
    const long long cell = (long long)blockIdx.x * IC_WARPS + warp;
    const bool live = cell < n_cells;
    float cx = 0.0f, cy = 0.0f, cz = 0.0f;
    bool pv = false;
    if (live) {
        cx = centers[cell * 3];
        cy = centers[cell * 3 + 1];
        cz = centers[cell * 3 + 2];
        pv = parent_valid[cell] != 0;
    }
    float* rg = rings + warp * 3 * IC_RING;
    int head = 0, cnt = 0;
    unsigned acc = 0u;   // shared rule: valid, edge, leaf of this lane's pairs
    bool done = !live;   // warp-uniform: the cell's flags can change no more
    bool chain = false;  // warp-uniform: shared rule, edge settled, no valid
                         // parent

    // the orientations and legs of one in-box pair a lane (`act`); call with
    // the whole warp
    auto pair = [&](bool act, float rx, float ry, float rz) {
        bool settled_all = true;
        for (int q = 0; q < S; ++q) {
            const float* T = rows + q * kw;
            if (SHARED) {
                float vx = 0.0f, vy = 0.0f, vz = 0.0f;
                if (act) item_unrotate(T, rx, ry, rz, vx, vy, vz);
                int rc = 0, cc = 0;
                bool cut = false;
                for (int l = 0; l < L; ++l) {
                    if (act) {
                        const unsigned r =
                            item_leg<Staged>(P, l, T, vx, vy, vz);
                        rc += (r & 1u) ? 1 : 0;
                        cc += (r & 2u) ? 1 : 0;
                    }
                    // the leg chain (K6b's): with edge settled and no valid
                    // parent only valid and leaf are left to find, so the
                    // legs stop once no lane's pair can still reach k; such
                    // a pair gives neither
                    if (chain && l < L - 1 &&
                        !__any_sync(CK_FULL, act & (rc + (L - 1 - l) >= k))) {
                        cut = true;
                        break;
                    }
                }
                const bool iv = (rc >= k) | pv;
                const bool ie = cc > L - k;
                if (act && !cut)
                    acc |= (iv ? 1u : 0u) | (ie ? 2u : 0u) |
                           ((iv & !ie) ? 4u : 0u);
            } else {
                const unsigned r0 = run[q];
                const unsigned m = ~(r0 & (r0 >> L)) & Lmask;
                if (m == 0u) continue;
                unsigned bits = 0u;
                if (act) {
                    float vx, vy, vz;
                    item_unrotate(T, rx, ry, rz, vx, vy, vz);
                    for (int l = 0; l < L; ++l) {
                        if (!((m >> l) & 1u)) continue;
                        const unsigned r =
                            item_leg<Staged>(P, l, T, vx, vy, vz);
                        const bool ok = r & 1u, crossed = (r >> 1) & 1u;
                        bits |= (ok ? 1u : 0u) << l;
                        bits |= ((ok & !crossed) ? 1u : 0u) << (L + l);
                        bits |= ((ok | crossed) ? 1u : 0u) << (2 * L + l);
                    }
                }
                const unsigned now = r0 | __reduce_or_sync(CK_FULL, bits);
                __syncwarp();
                if (lane == 0) run[q] = now;
                __syncwarp();
                settled_all &= (now & (now >> L) & Lmask) == Lmask;
            }
        }
        if (SHARED) {
            const unsigned seen = __reduce_or_sync(CK_FULL, acc);
            done = seen == 7u;
            chain = ((seen & 2u) != 0u) & !pv;
        } else {
            done = settled_all;
        }
    };

    // this block's share of the footholds: tiles y, y + splits, ...
    const long long n_tiles = (n_feet + IC_TILE - 1) / IC_TILE;
    const long long step = gridDim.y;
    long long t = blockIdx.y;
    if (t < n_tiles) stage_feet(tile, xs, ys, zs, f_stride, t * IC_TILE, n_feet);
    for (int j = 0; t < n_tiles; ++j, t += step) {
        if (t + step < n_tiles)
            stage_feet(tile + ((j + 1) & 1) * 3 * IC_TILE, xs, ys, zs,
                       f_stride, (t + step) * IC_TILE, n_feet);
        else
            cp_async_commit();  // an empty group: wait_group 1 stays right
        cp_async_wait_prior();
        __syncthreads();  // tile t is in shared memory (and the rows, at j 0)
        if (!done) {
            const float* F = tile + (j & 1) * 3 * IC_TILE;
            const float e0 = rows[13], e1 = rows[14], e2 = rows[15];
            const long long left = n_feet - t * IC_TILE;
            const int n = left < IC_TILE ? (int)left : IC_TILE;
            for (int base = 0; base < n && !done; base += 32) {
                const int i = base + lane;
                float rx = 0.0f, ry = 0.0f, rz = 0.0f;
                bool p = false;
                if (i < n) {
                    rx = F[i] - cx;
                    ry = F[IC_TILE + i] - cy;
                    rz = F[2 * IC_TILE + i] - cz;
                    p = in_box(rx, ry, rz, e0, e1, e2);
                }
                const unsigned bal = __ballot_sync(CK_FULL, p);
                if (p) {
                    const int s =
                        (head + cnt + __popc(bal & below)) & (IC_RING - 1);
                    rg[s] = rx;
                    rg[IC_RING + s] = ry;
                    rg[2 * IC_RING + s] = rz;
                }
                cnt += __popc(bal);
                if (cnt >= 32) {
                    __syncwarp();
                    const int s = (head + lane) & (IC_RING - 1);
                    pair(true, rg[s], rg[IC_RING + s], rg[2 * IC_RING + s]);
                    head = (head + 32) & (IC_RING - 1);
                    cnt -= 32;
                    __syncwarp();  // the slots just read may be written next
                }
            }
        }
        __syncthreads();  // every warp is through tile t, whose stage is
                          // refilled next
    }
    cp_async_wait_all();
    if (!done && cnt > 0) {
        __syncwarp();
        const int s = (head + lane) & (IC_RING - 1);
        pair(lane < cnt, rg[s], rg[IC_RING + s], rg[2 * IC_RING + s]);
    }
    if (!live) return;
    __syncwarp();  // every lane sees the run words, with no footholds too
    unsigned all = SHARED ? __reduce_or_sync(CK_FULL, acc) : 0u;
    if (gridDim.y > 1) {
        // the cell's bits from every split meet in its scratch row (S run
        // words or one flags word, then the arrival count); the split that
        // arrives last takes them and leaves the row zeroed
        unsigned* sc = scratch + cell * (S + 1);
        if (SHARED) {
            if (lane == 0 && all) atomicOr(sc, all);
        } else {
            for (int q = lane; q < S; q += 32)
                if (run[q]) atomicOr(sc + q, run[q]);
        }
        __threadfence();
        __syncwarp();
        unsigned last = 0u;
        if (lane == 0) last = atomicAdd(sc + S, 1u) == gridDim.y - 1;
        if (!__shfl_sync(CK_FULL, last, 0)) return;
        __threadfence();
        if (SHARED) {
            all = __shfl_sync(CK_FULL, lane == 0 ? atomicExch(sc, 0u) : 0u, 0);
        } else {
            for (int q = lane; q < S; q += 32) run[q] = atomicExch(sc + q, 0u);
        }
        if (lane == 0) sc[S] = 0u;
        __syncwarp();
    }
    bool v, e, lf;
    if (SHARED) {
        v = all & 1u;
        e = (all >> 1) & 1u;
        lf = (all >> 2) & 1u;
    } else {
        bool a0 = false, a1 = false;
        for (int q = 0; q < S; ++q) {
            const unsigned r = run[q];
            a0 |= __popc(r & Lmask) >= k;
            a1 |= (__popc((r >> L) & Lmask) < k) &
                  (__popc((r >> (2 * L)) & Lmask) >= k);
        }
        v = a0 | pv;
        e = a1;
        lf = v & !e;
    }
    if (lane == 0) {
        flags[cell] = (unsigned char)v;
        flags[n_cells + cell] = (unsigned char)e;
        flags[2 * n_cells + cell] = (unsigned char)lf;
    }
}

// Launch shape, from timing builds in turns on phase 10's batch and on real
// batches of the dense solves on an H100: the per-leg rule at two blocks an
// SM (128 registers, 104 B of spills) is 1.15x one block's speed; the
// shared rule at one block (162 registers, no spills) is 1.10x two blocks'
// on phase 10's batch and 0.96x on a real batch.  One kernel a rule, each
// with its own call sites and registers: one kernel for both rules (one
// call site, the shared rule's votes in the leg loop) ran the per-leg rule
// 10-12 % slower.
#define IC_PERLEG_BLOCKS 2
#define IC_SHARED_BLOCKS 1

#define IC_ARGS                                                               \
    const float* __restrict__ legtab, int S,                                  \
        const float* __restrict__ centers,                                    \
        const unsigned char* __restrict__ parent_valid, long long n_cells,    \
        const float* __restrict__ xs, const float* __restrict__ ys,           \
        const float* __restrict__ zs, long long f_stride, long long n_feet,   \
        unsigned char* __restrict__ flags, unsigned* __restrict__ scratch,    \
        const __grid_constant__ ItemParams P

extern "C" __global__ void __launch_bounds__(IC_WARPS * 32, IC_PERLEG_BLOCKS)
legmov_item_cells_kernel(IC_ARGS) {
    item_cells<false>(legtab, S, centers, parent_valid, n_cells, xs, ys, zs,
                      f_stride, n_feet, flags, scratch, P);
}

extern "C" __global__ void __launch_bounds__(IC_WARPS * 32, IC_SHARED_BLOCKS)
legmov_item_cells_shared_kernel(IC_ARGS) {
    item_cells<true>(legtab, S, centers, parent_valid, n_cells, xs, ys, zs,
                     f_stride, n_feet, flags, scratch, P);
}

// ---------------------------------------------------------------------------
// K6  CSR cell evaluation: shared pieces
//
// A cell's queue is `tot` chunks; chunk ch is `cln[ch]` elements of the
// cell-sorted foothold arrays from element `cst[ch]`, and carries one role
// byte per orientation: bits 0-5 the legs whose inflated reach ball meets the
// chunk's box, bit 6 (V) a shared-valid item is possible there, bit 7 (E) an
// edge item is possible.  One warp walks one cell's queue, so every skip
// decision is uniform across it; the running flags live identically in each
// of its lanes (they only change by votes over the warp).  The orientation's
// table row is staged in shared memory when an orientation is evaluated,
// with the cell centre written over header slots 4-6 (and, in K6a and K6b,
// parent-valid over slot 7).
//
// Each kernel writes ten words a cell: valid, edge, leaf (leaf only under
// the shared rule; parent-valid is ORed into valid by the caller under the
// per-leg rule), then chunks evaluated, (chunk, orientation) items evaluated,
// leg pipelines evaluated, the elements behind each of those three, and the
// leg pipelines that ran on an element inside the cell's elongated box (the
// only ones that cost more than the head).
// ---------------------------------------------------------------------------

// orientation q's row of the level's [S, W] table in the kernels' layout,
// staged by one warp for itself, with the cell centre and parent-valid
__device__ __forceinline__ void stage_row_warp(float* T, const ItemParams& P,
                                               const float* legtab, int q,
                                               const float* cell, bool pv,
                                               int lane) {
    __syncwarp();  // no lane still reads the previous row
    stage_entries(T, legtab + (long long)q * P.table_width, CK_KW(P.n_legs),
                  lane, 32, cell, pv);
    __syncwarp();
}

// the first n floats of a table row as the table holds it, with the cell
// centre over header slots 4-6, staged by one warp for itself
__device__ __forceinline__ void stage_table_row_warp(float* T, const float* row,
                                                     int n, const float* cell,
                                                     int lane) {
    __syncwarp();  // no lane still reads the previous row
    for (int i = lane; i < n; i += 32) {
        float v = row[i];
        if (i >= 4 && i < 7) v = cell[i - 4];
        T[i] = v;
    }
    __syncwarp();
}

__device__ __forceinline__ void write_out(int* out, long long cell, int v,
                                          int e, int lf, const int* a,
                                          bool lead) {
    if (lead) {
        int* o = out + cell * CK_OUT_WORDS;
        o[0] = v;
        o[1] = e;
        o[2] = lf;
        for (int i = 0; i < 7; ++i) o[3 + i] = a[i];
    }
}

// Full warps through the leg pipeline.  The warp scans elements [0, len) of
// a chunk 32 at a time; `pass(c)` says whether element c goes on, and each
// lane whose element does writes c into the warp's ring (a ballot gives its
// slot).  Whenever the ring holds 32, every lane takes one and runs
// `take(c)`; the rest are taken once at the end.  Call with the whole warp.
template <class Pass, class Take>
__device__ __forceinline__ void compact_walk(int* ring, int len, int lane,
                                             Pass pass, Take take) {
    const unsigned below = (1u << lane) - 1u;
    int head = 0, cnt = 0;
    for (int base = 0; base < len; base += 32) {
        const int c = base + lane;
        const bool p = c < len && pass(c);
        const unsigned bal = __ballot_sync(CK_FULL, p);
        if (p) ring[(head + cnt + __popc(bal & below)) & (CK_RING - 1)] = c;
        cnt += __popc(bal);
        if (cnt >= 32) {
            __syncwarp();
            take(ring[(head + lane) & (CK_RING - 1)]);
            head = (head + 32) & (CK_RING - 1);
            cnt -= 32;
            __syncwarp();  // the slots just read may be written next
        }
    }
    __syncwarp();
    if (lane < cnt) take(ring[(head + lane) & (CK_RING - 1)]);
    __syncwarp();
}

// element e, which passed the head under the staged row T (in layout Lay):
// the head again, then the masked legs.  Per-leg rule: bit l any ok, L + l
// ok & !crossed, 2L + l ok | crossed.  Shared rule: bit 0 valid ((rc >= k) |
// pv), bit 1 edge (cc > L - k), bit 2 valid & !edge.
template <class Lay = Staged>
__device__ __forceinline__ unsigned item_legs(const ItemParams& P,
                                              const float* T, unsigned m,
                                              bool shared, bool pv,
                                              const float* xs, const float* ys,
                                              const float* zs, long long e,
                                              int& work) {
    const int L = P.n_legs;
    float vx, vy, vz;
    item_head(T, xs[e], ys[e], zs[e], vx, vy, vz);
    work += __popc(m);
    unsigned bits = 0u;
    int rc = 0, cc = 0;
    for (int l = 0; l < L; ++l) {
        if (!((m >> l) & 1u)) continue;
        const unsigned r = item_leg<Lay>(P, l, T, vx, vy, vz);
        const bool ok = r & 1u, crossed = (r >> 1) & 1u;
        rc += ok ? 1 : 0;
        cc += crossed ? 1 : 0;
        bits |= (ok ? 1u : 0u) << l;
        bits |= ((ok & !crossed) ? 1u : 0u) << (L + l);
        bits |= ((ok | crossed) ? 1u : 0u) << (2 * L + l);
    }
    if (shared) {
        const bool iv = (rc >= P.k) | pv;
        const bool ie = cc > L - P.k;
        bits = (iv ? 1u : 0u) | (ie ? 2u : 0u) | ((iv & !ie) ? 4u : 0u);
    }
    return bits;
}

// ---------------------------------------------------------------------------
// K6a  quat-major CSR cell evaluation (the per-leg rule's default form; the
//      shared rule runs it too when asked)
//
// Replaces the Pallas kernel legmov_tpu/ops/csr_cell_eval.py `kernel`
// (pallas_call at the quat-major branch of make_csr_cell_eval).
//
// Orientation-outer, chunk-inner.  Per-leg rule: run bits per leg over the
// orientation's chunks (a leg is settled once any-ok and certain are both
// seen, and a chunk is walked only for unsettled legs whose ball meets it),
// folded into valid / edge at the orientation's last chunk whether or not
// that chunk was evaluated; a cell whose valid (with parent-valid) and edge
// are both set is decided and skips every later step.  Shared rule: per
// candidate reach and crossing counts over the masked legs; a chunk is
// walked while it can still set valid+leaf (V or parent-valid) or edge (E).
//
// Bound on this card: the work is the queue's: per element of an evaluated
// (chunk, orientation) 12 bytes (from L2 after the first orientation) and 39
// operations, plus 860 per masked leg for an element inside the cell's
// elongated box.  Operations bound it, by two orders of magnitude.  The
// bound counts a fused multiply-add as two operations at the card's 67
// TFLOP/s, and the build forbids the fusion (the flags must be the plain
// version's bits), so about half of the bound is the most this kernel can
// reach.
//
// What holds it back is instruction issue: beside its arithmetic the leg
// pipeline issues about as many compares, selects and loads (phase 1 of
// chip_smoke.py prints each kernel's instruction mix).
//
// Design.  Occupancy: one warp walks one cell, in a block of its own, so a
// block retires with its cell (a batch's cells differ in work many times
// over).  __launch_bounds__(32, 16) caps it at 128 registers, 16 warps an
// SM: caps for 24 or 32 warps spill and ran 16-17 % slower.  (The form with
// a block of 256 threads a cell held 149 registers: one block, 8 warps, an
// SM.)  Barriers: none of the block; a chunk's vote is one __reduce_or_sync
// of the warp.
// Divergence: about half of a chunk's elements pass the elongated-box head;
// those go through the warp's ring (compact_walk), so the leg pipelines run
// on full warps and not on the lanes that happened to pass, and the head is
// recomputed from the element (39 operations against 860 a leg).
// Instructions: the warp stages its table row in the kernels' layout (912 or
// 1,360 floats: a circle or corner in two 16-byte loads, where the table's
// own layout takes seven or three of 4 bytes) in dynamic shared memory when
// it reaches an orientation, and stops once nothing it walks can change a
// flag.  No S-fold unrolled queue exists in memory: the loop reads the
// [C, CH] chunk grid and the [C, CH, S] role bytes in place.
// ---------------------------------------------------------------------------

extern "C" __global__ void __launch_bounds__(32, 16)
legmov_cell_quat_major_kernel(
    const int* __restrict__ cst, const int* __restrict__ cln,
    const unsigned char* __restrict__ role, const int* __restrict__ tot,
    const float* __restrict__ cellinfo, const float* __restrict__ legtab,
    const float* __restrict__ xs, const float* __restrict__ ys,
    const float* __restrict__ zs, int* __restrict__ out, long long CH, int S,
    int shared, const __grid_constant__ ItemParams P) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x;
    const long long cell = blockIdx.x;
    float* T = reinterpret_cast<float*>(smem);
    int* ring = reinterpret_cast<int*>(T + CK_KW(P.n_legs));
    const int L = P.n_legs, k = P.k;
    const unsigned Lmask = (1u << L) - 1u;
    const float* ci = cellinfo + cell * 4;
    const bool pv = ci[3] > 0.5f;
    long long n = tot[cell];
    if (n > CH) n = CH;
    const int* st = cst + cell * CH;
    const int* ln = cln + cell * CH;
    const unsigned char* rl = role + cell * CH * S;

    bool acc0 = false, acc1 = false, acc2 = false, dec = false;
    unsigned run = 0u;
    int a[7] = {0, 0, 0, 0, 0, 0, 0};
    int work = 0;
    // a decided cell (per-leg rule) or one with all three flags (shared
    // rule: acc2 stays false under the per-leg rule) has nothing left to do
    for (int q = 0; q < S && !dec && !(acc0 & acc1 & acc2); ++q) {
        bool staged = false;
        for (long long ch = 0; ch < n; ++ch) {
            const unsigned rb = rl[ch * S + q];
            const unsigned infl = rb & 0x3Fu;
            const bool vbit = (rb >> 6) & 1u, ebit = (rb >> 7) & 1u;
            const int len = ln[ch];
            unsigned m;
            bool useful;
            if (shared) {
                const bool need_v = !(acc0 & acc2);
                useful = ((vbit | pv) & need_v) | (ebit & !acc1);
                m = infl;
            } else {
                const unsigned settled = run & (run >> L) & Lmask;
                m = infl & ~settled & Lmask;
                useful = (!dec) & (m != 0u);
            }
            if (useful && len > 0) {
                if (!staged) {
                    stage_row_warp(T, P, legtab, q, ci, pv, lane);
                    staged = true;
                }
                const int legs = __popc(m);
                a[0] += 1;
                a[1] += 1;
                a[2] += legs;
                a[3] += len;
                a[4] += len;
                a[5] += len * legs;
                const long long start = st[ch];
                unsigned bits = 0u;
                compact_walk(
                    ring, len, lane,
                    [&](int c) {
                        float vx, vy, vz;
                        return item_head(T, xs[start + c], ys[start + c],
                                         zs[start + c], vx, vy, vz);
                    },
                    [&](int c) {
                        bits |= item_legs(P, T, m, shared, pv, xs, ys, zs,
                                          start + c, work);
                    });
                bits = __reduce_or_sync(CK_FULL, bits);
                if (shared) {
                    acc0 |= (bits & 1u) != 0u;
                    acc1 |= (bits & 2u) != 0u;
                    acc2 |= (bits & 4u) != 0u;
                } else {
                    run |= bits;
                }
            }
            if (!shared && ch == n - 1 && !dec) {
                // the orientation's fold; run bits are complete: skipped
                // chunks had nothing left to contribute
                const int cnt = __popc(run & Lmask);
                const int nmin = __popc((run >> L) & Lmask);
                const int nmax = __popc((run >> (2 * L)) & Lmask);
                acc0 |= cnt >= k;
                acc1 |= (nmin < k) & (nmax >= k);
                dec = (acc0 | pv) & acc1;
                run = 0u;
            }
        }
    }
    a[6] = (int)__reduce_add_sync(CK_FULL, (unsigned)work);
    write_out(out, cell, acc0, acc1, acc2, a, lane == 0);
}

// ---------------------------------------------------------------------------
// K6b  chunk-major CSR cell evaluation, shared rule
//
// Replaces the Pallas kernel legmov_tpu/ops/csr_cell_eval.py `kernel_shared`
// (pallas_call at the chunk-major branch of make_csr_cell_eval, `shared`).
//
// Chunk-outer, orientation-inner: a chunk is skipped once valid+leaf and edge
// are settled or no orientation's role byte can still change them; inside a
// chunk an orientation is skipped likewise.  The leg chain: once edge is
// settled and the cell has no valid parent, a chunk is scanned for valid/leaf
// only, so after leg l the remaining legs run only if some candidate can
// still reach k with every masked leg left (a vote on rc >= k - rem over the
// whole chunk); a partially chained chunk contributes nothing, because its
// counts are understated and edge is already set.
//
// Bound on this card: as K6a, over the (chunk, orientation, leg) triples this
// walk evaluates; a chunk's elements come from device memory once and from
// L1/L2 for the other orientations and legs.  Operations bound it, and as in
// K6a the forbidden fused multiply-add leaves about half of that bound
// within reach.  What the inputs need (bench_port/counts/k6.py) is one leg
// pipeline for each foothold within leg l's reach plus the cell's crossing
// radius of its coxa mount; the role bytes test that per chunk, and a
// chunk's box holds 3-4x more elements than a leg's ball.
//
// Per-element reach balls.  The head pass also tests each
// element's body-frame vector against leg l's balls about its coxa mount
// (P.ball_*: the radii of build_cell_queue, r_ok = reach + 2 mm, r_in =
// reach + the crossing radius, squared), for the legs of the role byte, and
// keeps the legs whose pipeline the element still needs.  Exact, by the
// argument the role bytes rest on, for one element instead of a chunk's
// box: outside r_in of l the pipeline gives neither ok nor crossed, so a
// skipped (element, leg) adds 0 to rc and cc, what the pipeline would add;
// outside r_ok it gives no ok.  In the chain (edge set, no valid parent)
// only an element with rc >= k can still change a flag, valid or leaf, and
// rc counts only legs whose r_ok ball holds it: an element inside fewer than
// k of those balls runs no leg (it contributes nothing, as before), the
// others run every leg whose r_in ball holds them, so that leaf = valid &
// !edge keeps its bits at any k.  So the walk runs at most one pipeline for
// each (element, leg) inside r_in, the count the bound needs, and inside
// the chain, at k = L, only on the balls' intersection.  The dropped
// elements' counts stay 0, so the chain's vote can stop a chunk's legs
// sooner than before: words 5 and 8 (leg passes and their elements) can
// fall with word 9 (pipelines run); the flags cannot change.
//
// Design.  Occupancy and instructions: as K6a, one warp a cell in a block of
// its own, 16 warps an SM, the row in the kernels' layout (the form with a
// block of 256 threads a cell held 128 registers and spilled).  Barriers:
// leg-outer, candidate-inner inside a (chunk, orientation) item, because the
// vote between legs is over the whole chunk; the vote is one __any_sync of
// the warp, not a barrier of the block.
// The block's dynamic shared memory holds the table row, the ring, and a
// 16-bit word per chunk element (reach count bits 0-2, crossing count bits
// 3-5, head bit 7, the legs to run bits 8-13), so any window up to 40,960
// elements works without per-thread arrays.  Divergence: each leg's pass
// takes the elements whose bit of that leg is set through the ring
// (compact_walk), so the pipelines run on full warps; the head is recomputed
// from the element.
// ---------------------------------------------------------------------------

// the legs of role mask m whose pipeline an element that passed the head
// still needs, from its body-frame vector (above): those whose r_in ball
// holds it, and in the chain (!chain_off) none unless at least k of m's r_ok
// balls hold it
__device__ __forceinline__ unsigned element_legs(const ItemParams& P,
                                                 unsigned m, int k,
                                                 bool chain_off, float vx,
                                                 float vy, float vz) {
    unsigned in = 0u;
    int n_ok = 0;
#pragma unroll
    for (int l = 0; l < CK_MAX_LEGS; ++l) {
        if (!((m >> l) & 1u)) continue;
        const float dx = vx - P.ball_x[l];
        const float dy = vy - P.ball_y[l];
        const float dz = vz - P.ball_z[l];
        const float d2 = dx * dx + dy * dy + dz * dz;
        in |= (d2 <= P.ball_in2[l] ? 1u : 0u) << l;
        n_ok += d2 <= P.ball_ok2[l] ? 1 : 0;
    }
    return (chain_off || n_ok >= k) ? in : 0u;
}

extern "C" __global__ void __launch_bounds__(32, 16)
legmov_cell_shared_kernel(
    const int* __restrict__ cst, const int* __restrict__ cln,
    const unsigned char* __restrict__ role, const int* __restrict__ tot,
    const float* __restrict__ cellinfo, const float* __restrict__ legtab,
    const float* __restrict__ xs, const float* __restrict__ ys,
    const float* __restrict__ zs, int* __restrict__ out, long long CH, int S,
    const __grid_constant__ ItemParams P) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x;
    const long long cell = blockIdx.x;
    float* T = reinterpret_cast<float*>(smem);
    int* ring = reinterpret_cast<int*>(T + CK_KW(P.n_legs));
    unsigned short* cnt = reinterpret_cast<unsigned short*>(ring + CK_RING);
    const int L = P.n_legs, k = P.k;
    const float* ci = cellinfo + cell * 4;
    const bool pv = ci[3] > 0.5f;
    long long n = tot[cell];
    if (n > CH) n = CH;
    const int* st = cst + cell * CH;
    const int* ln = cln + cell * CH;
    const unsigned char* rl = role + cell * CH * S;

    bool acc0 = false, acc1 = false, acc2 = false;
    int a[7] = {0, 0, 0, 0, 0, 0, 0};
    int work = 0;
    // with all three flags set no chunk is useful any more
    for (long long ch = 0; ch < n && !(acc0 & acc1 & acc2); ++ch) {
        const int len = ln[ch];
        // does any orientation's byte carry V / E
        unsigned any = 0u;
        for (int q = lane; q < S; q += 32) any |= rl[ch * S + q] >> 6;
        any = __reduce_or_sync(CK_FULL, any);
        const bool vany = any & 1u, eany = (any >> 1) & 1u;
        const bool useful =
            ((vany | pv) & !(acc0 & acc2)) | (eany & !acc1);
        if (!useful || len <= 0) continue;
        a[0] += 1;
        a[3] += len;
        const long long start = st[ch];
        for (int q = 0; q < S; ++q) {
            const unsigned rb = rl[ch * S + q];
            const unsigned m = rb & 0x3Fu;
            const bool vbit = (rb >> 6) & 1u, ebit = (rb >> 7) & 1u;
            const bool uq = ((vbit | pv) & !(acc0 & acc2)) | (ebit & !acc1);
            if (!uq) continue;
            a[1] += 1;
            a[4] += len;
            stage_row_warp(T, P, legtab, q, ci, pv, lane);
            const bool chain_off = (!acc1) | pv;
            for (int c = lane; c < len; c += 32) {
                float vx, vy, vz;
                const bool h = item_head(T, xs[start + c], ys[start + c],
                                         zs[start + c], vx, vy, vz);
                cnt[c] = h ? (unsigned short)(0x80u |
                                              (element_legs(P, m, k, chain_off,
                                                            vx, vy, vz)
                                               << 8))
                           : (unsigned short)0u;
            }
            bool viable = true;
            int rcmax = 0;  // rc only grows: the lanes' maxima give the chunk's
            for (int l = 0; l < L; ++l) {
                if (((m >> l) & 1u) && (chain_off || viable)) {
                    a[2] += 1;
                    a[5] += len;
                    compact_walk(
                        ring, len, lane,
                        [&](int c) { return ((cnt[c] >> (8 + l)) & 1u) != 0u; },
                        [&](int c) {
                            work += 1;
                            const long long e = start + c;
                            float vx, vy, vz;
                            item_head(T, xs[e], ys[e], zs[e], vx, vy, vz);
                            const unsigned r =
                                item_leg<Staged>(P, l, T, vx, vy, vz);
                            const unsigned b = cnt[c];
                            const int rc = (int)(b & 7u) + (int)(r & 1u);
                            const int cc =
                                (int)((b >> 3) & 7u) + (int)((r >> 1) & 1u);
                            cnt[c] = (unsigned short)((b & ~0x3Fu) | rc |
                                                      (cc << 3));
                            rcmax = rc > rcmax ? rc : rcmax;
                        });
                }
                if (!chain_off && l < L - 1) {
                    const int rem = __popc(m >> (l + 1));
                    viable = __any_sync(CK_FULL, rcmax >= k - rem);
                }
            }
            // compact_walk ended in __syncwarp, and without a leg pass each
            // lane reads back its own bytes
            unsigned bits = 0u;
            for (int c = lane; c < len; c += 32) {
                const unsigned b = cnt[c];
                if (!(b & 0x80u)) continue;
                const bool iv = ((int)(b & 7u) >= k) | pv;
                const bool ie = (int)((b >> 3) & 7u) > L - k;
                bits |= (iv ? 1u : 0u) | (ie ? 2u : 0u) | ((iv & !ie) ? 4u : 0u);
            }
            bits = __reduce_or_sync(CK_FULL, bits);
            acc0 |= (bits & 1u) != 0u;
            acc1 |= (bits & 2u) != 0u;
            acc2 |= (bits & 4u) != 0u;
        }
    }
    a[6] = (int)__reduce_add_sync(CK_FULL, (unsigned)work);
    write_out(out, cell, acc0, acc1, acc2, a, lane == 0);
}

// ---------------------------------------------------------------------------
// K6c  chunk-major CSR cell evaluation, per-leg rule
//
// Replaces the Pallas kernel legmov_tpu/ops/csr_cell_eval.py
// `kernel_cm_perleg` (the same pallas_call as K6b, `not shared`).
//
// Per orientation q the run bits (3 x L, as K6a's) and two sticky marks:
// edge under q is certainly false, and q can no longer make the cell valid.
// The marks come from the run bits and the lookahead: per (orientation,
// leg) the last live chunk whose role byte sets the leg, from one pass over
// the cell's [CH, S] role bytes, so that "the legs whose ball meets a later
// chunk" is a compare a leg.
//   Valid is walked chunk-major: once a chunk, every orientation that can
//   still make it valid walks the legs not yet ok.  Valid is final once an
//   orientation's any-ok count reaches k; q can no longer make it once that
//   count plus the legs not yet ok that meet a later chunk is below k.
//   Edge is walked for one candidate orientation at a time, chunk by chunk:
//   the legs not yet ok & !crossed.  Edge is certainly true once the
//   candidate has nmax >= k and nmin plus its uncertain legs that meet a
//   later chunk below k; certainly false under q once nmin >= k, or (under
//   the candidate) nmax plus the legs not yet ok | crossed that meet a later
//   chunk is below k.  When the candidate's edge is certainly false, the
//   next orientation whose edge is not becomes the candidate, and its walk
//   starts again at chunk 0 (chunks already walked for valid are walked for
//   the candidate alone).
// The cell stops once valid (or parent-valid, or every orientation's valid
// mark) and edge (certain, or every orientation's edge mark) are decided.
// The marks are read at the start (every orientation, the lookahead alone),
// after each evaluated (chunk, orientation), and at each chunk's end; the
// plain version (ops/csr_cell_eval.py cell_eval_cm_perleg_plain) reads them
// at the same points, so the seven counters are its counters.
//
// Why one candidate: a cell's edge is known only when an orientation's
// uncertain legs are past their last chunk, near the end of the queue.
// Walked for every orientation at once, edge took 9x K6a's leg pipelines on
// the solve's real cells; walked for one orientation at a time (most cells
// are decided by the first), as much as K6a's.
//
// Bound on this card: as K6a, over the (chunk, orientation, leg) triples
// this walk evaluates: operations, about half of which the forbidden fused
// multiply-add leaves within reach.
//
// Design.  One warp a cell in a block of its own, as K6a and K6b (16 warps
// an SM, no block barrier; votes are warp votes).  Lane q & 31 keeps the
// run word and marks of orientations q and q + 32 in registers and their
// lookahead in shared memory; the next orientation to evaluate in a chunk
// is the first set bit of two ballots.  The elements that pass the head go
// through the warp's ring (compact_walk), so the leg pipelines run on full
// warps.  The row is staged as the table holds it (TableRow: seven 4-byte
// loads a circle, three a corner) when an orientation is evaluated: timed in
// turns on the depth-7 batch it was 1.02x the speed of the kernels' layout
// (two 16-byte loads a circle or corner, more work to stage), which K5, K6a
// and K6b keep.  Staging only the masked legs' records, or holding the
// chunk's coordinates in shared memory across its orientations (24 KB a
// block: 7 warps an SM, not 16), did not pay.
// ---------------------------------------------------------------------------

#define CM_EDGE_DEAD (1u << 30)   // edge under this orientation certainly false
#define CM_VALID_DEAD (1u << 31)  // this orientation cannot make the cell valid

// orientation word r (run bits and marks) with its marks brought up to date
// after chunk ch, `last` its lookahead: the edge marks of the lookahead where
// `cand` (its edge walk is complete up to ch), its valid mark where `front`
// (its valid walk is).  v: the any-ok count reached k; et: edge is
// certainly true under it.
__device__ __forceinline__ unsigned cm_mark(unsigned r, const int* last,
                                            int ch, bool cand, bool front,
                                            int L, int k, bool& v, bool& et) {
    const unsigned Lmask = (1u << L) - 1u;
    unsigned pend = 0u;
    for (int l = 0; l < L; ++l) pend |= (last[l] > ch ? 1u : 0u) << l;
    const unsigned ok = r & Lmask, cert = (r >> L) & Lmask,
                   any = (r >> (2 * L)) & Lmask;
    const int cnt = __popc(ok), nmin = __popc(cert), nmax = __popc(any);
    v = cnt >= k;
    et = cand & !(r & CM_EDGE_DEAD) & (nmax >= k) &
         (nmin + __popc(pend & ~cert) < k);
    if ((nmin >= k) | (cand & (nmax + __popc(pend & ~any) < k)))
        r |= CM_EDGE_DEAD;
    if (front & (cnt + __popc(pend & ~ok) < k)) r |= CM_VALID_DEAD;
    return r;
}

// the legs of role byte rb that orientation word r still needs walked:
// `edge_walk` for the candidate while edge is open, `valid_walk` while
// valid is open on a chunk not yet walked for it
__device__ __forceinline__ unsigned cm_need(unsigned r, unsigned rb,
                                            bool edge_walk, bool valid_walk,
                                            int L) {
    unsigned legs = 0u;
    if (edge_walk & !(r & CM_EDGE_DEAD))
        legs = ~(r >> L);
    else if (valid_walk & !(r & CM_VALID_DEAD))
        legs = ~r;
    return rb & legs & ((1u << L) - 1u);
}

extern "C" __global__ void __launch_bounds__(32, 16)
legmov_cell_cm_perleg_kernel(
    const int* __restrict__ cst, const int* __restrict__ cln,
    const unsigned char* __restrict__ role, const int* __restrict__ tot,
    const float* __restrict__ cellinfo, const float* __restrict__ legtab,
    const float* __restrict__ xs, const float* __restrict__ ys,
    const float* __restrict__ zs, int* __restrict__ out, long long CH, int S,
    const __grid_constant__ ItemParams P) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x;
    const long long cell = blockIdx.x;
    float* T = reinterpret_cast<float*>(smem);
    int* ring = reinterpret_cast<int*>(T + CK_TW(P.n_legs));
    // lookahead of orientations lane and lane + 32, written and read by
    // this lane alone
    int* lastA = ring + CK_RING + lane * CK_MAX_LEGS;
    int* lastB = lastA + 32 * CK_MAX_LEGS;
    const int L = P.n_legs, k = P.k;
    const float* ci = cellinfo + cell * 4;
    const bool pv = ci[3] > 0.5f;
    const int n = (int)(tot[cell] < CH ? tot[cell] : CH);
    const int* st = cst + cell * CH;
    const int* ln = cln + cell * CH;
    const unsigned char* rl = role + cell * CH * S;
    const bool hasA = lane < S, hasB = lane + 32 < S;

    {
        int la[CK_MAX_LEGS], lb[CK_MAX_LEGS];
#pragma unroll
        for (int l = 0; l < CK_MAX_LEGS; ++l) la[l] = lb[l] = -1;
        for (int ch = 0; ch < n; ++ch) {
            if (ln[ch] <= 0) continue;
            const unsigned ra = hasA ? rl[(long long)ch * S + lane] : 0u;
            const unsigned rb = hasB ? rl[(long long)ch * S + lane + 32] : 0u;
#pragma unroll
            for (int l = 0; l < CK_MAX_LEGS; ++l) {
                if ((ra >> l) & 1u) la[l] = ch;
                if ((rb >> l) & 1u) lb[l] = ch;
            }
        }
#pragma unroll
        for (int l = 0; l < CK_MAX_LEGS; ++l) {
            lastA[l] = la[l];
            lastB[l] = lb[l];
        }
    }

    // orientations past S are marked dead, so that the votes over the
    // warp's 64 words see only real ones
    const unsigned dead = CM_EDGE_DEAD | CM_VALID_DEAD;
    unsigned rA = hasA ? 0u : dead, rB = hasB ? 0u : dead;
    bool valid = false, edge = false, all_e = false, all_v = false;
    // the flags from orientation flags (v, et) and the words' marks
    auto vote = [&](bool v, bool et) {
        valid |= __any_sync(CK_FULL, v);
        edge |= __any_sync(CK_FULL, et);
        all_e = __all_sync(CK_FULL, (rA & rB & CM_EDGE_DEAD) != 0u);
        all_v = __all_sync(CK_FULL, (rA & rB & CM_VALID_DEAD) != 0u);
        return (valid | pv | all_v) & (edge | all_e);
    };
    // every orientation's marks after chunk ch; `c` the candidate, or every
    // orientation when c < 0
    auto mark_all = [&](int ch, int c, bool front) {
        bool va = false, ea = false, vb = false, eb = false;
        if (hasA)
            rA = cm_mark(rA, lastA, ch, c < 0 || lane == c, front, L, k, va,
                         ea);
        if (hasB)
            rB = cm_mark(rB, lastB, ch, c < 0 || lane + 32 == c, front, L, k,
                         vb, eb);
        return vote(va | vb, ea | eb);
    };
    // the first orientation past `after` whose edge is open, S for none
    auto next_cand = [&](int after) {
        const unsigned oa = __ballot_sync(
            CK_FULL, hasA & (lane > after) & !(rA & CM_EDGE_DEAD));
        const unsigned ob = __ballot_sync(
            CK_FULL, hasB & (lane + 32 > after) & !(rB & CM_EDGE_DEAD));
        return oa ? __ffs(oa) - 1 : (ob ? 31 + __ffs(ob) : S);
    };
    bool done = mark_all(-1, -1, true);
    int cand = next_cand(-1);
    int front_at = 0;  // the first chunk not yet walked for valid

    int a[7] = {0, 0, 0, 0, 0, 0, 0};
    int work = 0;
    for (int ch = 0; !done && ch < n;) {
        const int len = ln[ch];
        const long long start = st[ch];
        const unsigned rbA = hasA ? rl[(long long)ch * S + lane] : 0u;
        const unsigned rbB = hasB ? rl[(long long)ch * S + lane + 32] : 0u;
        const bool front = ch >= front_at;
        bool walked = false;
        int qc = -1;  // the orientation evaluated last in this chunk
        while (len > 0) {
            const bool e_open = !(edge | all_e);
            const bool v_open = front & !(valid | pv | all_v);
            const unsigned mA =
                lane > qc ? cm_need(rA, rbA, e_open & (lane == cand), v_open, L)
                          : 0u;
            const unsigned mB =
                lane + 32 > qc
                    ? cm_need(rB, rbB, e_open & (lane + 32 == cand), v_open, L)
                    : 0u;
            const unsigned bA = __ballot_sync(CK_FULL, mA != 0u);
            const unsigned bB = __ballot_sync(CK_FULL, mB != 0u);
            if ((bA | bB) == 0u) break;
            const int q = bA ? __ffs(bA) - 1 : 31 + __ffs(bB);
            const unsigned m = __shfl_sync(CK_FULL, bA ? mA : mB, q & 31);
            stage_table_row_warp(T, legtab + (long long)q * P.table_width,
                                 CK_HDR + L * CK_LEG_BLOCK, ci, lane);
            const int legs = __popc(m);
            a[1] += 1;
            a[2] += legs;
            a[4] += len;
            a[5] += len * legs;
            unsigned bits = 0u;
            compact_walk(
                ring, len, lane,
                [&](int c) {
                    float vx, vy, vz;
                    return item_head(T, xs[start + c], ys[start + c],
                                     zs[start + c], vx, vy, vz);
                },
                [&](int c) {
                    bits |= item_legs<TableRow>(P, T, m, false, false, xs, ys,
                                                zs, start + c, work);
                });
            bits = __reduce_or_sync(CK_FULL, bits);
            bool vq = false, eq = false;
            if (lane == (q & 31)) {
                if (q < 32)
                    rA = cm_mark(rA | bits, lastA, ch, q == cand, front, L, k,
                                 vq, eq);
                else
                    rB = cm_mark(rB | bits, lastB, ch, q == cand, front, L, k,
                                 vq, eq);
            }
            walked = true;
            done = vote(vq, eq);
            if (done) break;
            qc = q;
        }
        if (walked) {
            a[0] += 1;
            a[3] += len;
        }
        if (done) break;
        if (front) front_at = ch + 1;
        done = mark_all(ch, cand, front);
        if (done) break;
        // a candidate whose edge is certainly false hands over to the next
        // one, whose walk starts again at chunk 0
        const bool e_open = !(edge | all_e);
        const unsigned cw =
            __shfl_sync(CK_FULL, cand < 32 ? rA : rB, cand & 31);
        if (e_open & ((cw & CM_EDGE_DEAD) != 0u)) {
            cand = next_cand(cand);
            ch = 0;
        } else {
            ch = e_open ? ch + 1 : (ch + 1 > front_at ? ch + 1 : front_at);
        }
    }
    a[6] = (int)__reduce_add_sync(CK_FULL, (unsigned)work);
    write_out(out, cell, valid, edge, 0, a, lane == 0);
}

// ---------------------------------------------------------------------------
// C launchers: enqueue on the caller's stream, do not synchronise, return
// cudaGetLastError()
// ---------------------------------------------------------------------------

static int sm_count() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                cudaSuccess ||
            sms <= 0)
            sms = 132;
    }
    return sms;
}

// the most dynamic shared memory a block may ask for on this device
static int smem_optin() {
    static int bytes = 0;
    if (bytes == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&bytes,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev) != cudaSuccess ||
            bytes <= 0)
            bytes = 48 * 1024;
    }
    return bytes;
}

static bool params_ok(const ItemParams* p) {
    return p->n_legs >= 1 && p->n_legs <= CK_MAX_LEGS &&
           p->table_width >= CK_HDR + p->n_legs * CK_LEG_BLOCK &&
           p->table_width <= CK_MAX_W;
}

extern "C" int legmov_item(const float* tab, const float* gx, const float* gy,
                           const float* gz, long long P, long long C,
                           int shared_row, int* out_bits,
                           const ItemParams* params, void* stream) {
    if (P <= 0 || C <= 0) return 0;
    if (!params_ok(params)) return (int)cudaErrorInvalidValue;
    // slabs of candidates per item: enough blocks to fill the card eight
    // times over, but no slab below two candidates a thread
    const long long min_slab = 2LL * CK_BLOCK;
    long long slabs = ((long long)sm_count() * 8 + P - 1) / P;
    const long long max_slabs = (C + min_slab - 1) / min_slab;
    if (slabs > max_slabs) slabs = max_slabs;
    if (slabs < 1) slabs = 1;
    if (slabs > 65535) slabs = 65535;
    const long long slab = (C + slabs - 1) / slabs;
    dim3 grid((unsigned)P, (unsigned)((C + slab - 1) / slab));
    legmov_item_kernel<<<grid, CK_BLOCK, 0, (cudaStream_t)stream>>>(
        tab, gx, gy, gz, C, slab, shared_row, out_bits, *params);
    return (int)cudaGetLastError();
}

static cudaError_t allow_smem(const void* fn, size_t bytes);

// Splits of the foothold range for a batch of `n_cells` cells and `n_feet`
// footholds: enough blocks for `waves` waves of the warps the card holds at
// once, at most one a tile.  Each split settles legs and meets the shared
// rule's exit on its own, so more splits repeat work, and fewer leave SMs
// idle behind cells of unequal work.  Timed in turns on an H100 (against
// four waves, then against the per-leg rule's two): the per-leg rule at two
// waves 1.05x four's speed, 1.00-1.03x one's and three's; the shared rule
// at one wave 1.04-1.37x two's, which were 1.0-1.2x four's; eight waves
// 0.77-1.0x four's.
#define IC_PERLEG_WAVES 2
#define IC_SHARED_WAVES 1

static long long item_cells_splits(const void* fn, int waves,
                                   long long n_cells, long long n_feet,
                                   size_t bytes) {
    int dev = 0, sms = 0, nb = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fn, IC_WARPS * 32,
                                                      bytes) != cudaSuccess ||
        sms <= 0 || nb <= 0)
        return 0;
    const long long resident = (long long)sms * nb * IC_WARPS;
    const long long n_tiles = (n_feet + IC_TILE - 1) / IC_TILE;
    long long s = (waves * resident + n_cells - 1) / n_cells;
    if (s > n_tiles) s = n_tiles;
    if (s > 65535) s = 65535;
    return s < 1 ? 1 : s;
}

// flags: uint8 [3, n_cells] (valid, edge, leaf rows).  legtab: the level's
// [S, table_width] rows (quaternion and level header; the centre and
// parent-valid slots are not read).  Footholds x, y, z with stride f_stride
// (3 for an [F, 3] array read in place).  scratch: uint32 [n_cells, S + 1],
// zero, which the kernel leaves zero.
extern "C" int legmov_item_cells(const float* legtab, int S,
                                 const float* centers,
                                 const unsigned char* parent_valid,
                                 long long n_cells, const float* x,
                                 const float* y, const float* z,
                                 long long f_stride, long long n_feet,
                                 int shared, unsigned char* flags,
                                 unsigned* scratch, const ItemParams* params,
                                 void* stream) {
    if (n_cells <= 0) return 0;
    if (!params_ok(params) || S < 1 || S > CK_MAX_QUATS || n_feet < 0 ||
        scratch == nullptr)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = item_cells_bytes(params->n_legs, S);
    const void* fn = shared ? (const void*)legmov_item_cells_shared_kernel
                            : (const void*)legmov_item_cells_kernel;
    const cudaError_t e = allow_smem(fn, bytes);
    if (e != cudaSuccess) return (int)e;
    const long long splits = item_cells_splits(
        fn, shared ? IC_SHARED_WAVES : IC_PERLEG_WAVES, n_cells, n_feet, bytes);
    if (splits < 1) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)((n_cells + IC_WARPS - 1) / IC_WARPS),
                    (unsigned)splits);
    if (shared)
        legmov_item_cells_shared_kernel<<<grid, IC_WARPS * 32, bytes,
                                          (cudaStream_t)stream>>>(
            legtab, S, centers, parent_valid, n_cells, x, y, z, f_stride,
            n_feet, flags, scratch, *params);
    else
        legmov_item_cells_kernel<<<grid, IC_WARPS * 32, bytes,
                                   (cudaStream_t)stream>>>(
            legtab, S, centers, parent_valid, n_cells, x, y, z, f_stride,
            n_feet, flags, scratch, *params);
    return (int)cudaGetLastError();
}

static bool cell_args_ok(long long CH, int S, const ItemParams* p) {
    return params_ok(p) && CH >= 0 && S >= 1 && S <= CK_MAX_QUATS;
}

// dynamic shared memory of a K6a / K6b block: the warp's staged row and
// ring, and for K6b a 16-bit word per chunk element
static size_t cell_block_bytes(int n_legs, int window, bool counts) {
    const size_t row = (size_t)CK_KW(n_legs) * 4 + CK_RING * 4;
    return row + (counts ? ((size_t)window * 2 + 15) / 16 * 16 : 0);
}

// dynamic shared memory of a K6c block: the row as the table holds it, the
// ring and the lookahead of 64 orientations
static size_t cm_block_bytes(int n_legs) {
    return (size_t)CK_TW(n_legs) * 4 + CK_RING * 4 +
           (size_t)CK_MAX_QUATS * CK_MAX_LEGS * 4;
}

static cudaError_t allow_smem(const void* fn, size_t bytes) {
    if (bytes > (size_t)smem_optin()) return cudaErrorInvalidValue;
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

extern "C" int legmov_cell_quat_major(
    const int* cst, const int* cln, const unsigned char* role, const int* tot,
    const float* cellinfo, const float* legtab, const float* xs,
    const float* ys, const float* zs, int* out, long long C, long long CH,
    int S, int window, int shared, const ItemParams* params, void* stream) {
    (void)window;
    if (C <= 0) return 0;
    if (!cell_args_ok(CH, S, params) || C > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = cell_block_bytes(params->n_legs, 0, false);
    const cudaError_t e =
        allow_smem((const void*)legmov_cell_quat_major_kernel, bytes);
    if (e != cudaSuccess) return (int)e;
    legmov_cell_quat_major_kernel<<<(unsigned)C, 32, bytes,
                                    (cudaStream_t)stream>>>(
        cst, cln, role, tot, cellinfo, legtab, xs, ys, zs, out, CH, S, shared,
        *params);
    return (int)cudaGetLastError();
}

extern "C" int legmov_cell_shared(
    const int* cst, const int* cln, const unsigned char* role, const int* tot,
    const float* cellinfo, const float* legtab, const float* xs,
    const float* ys, const float* zs, int* out, long long C, long long CH,
    int S, int window, const ItemParams* params, void* stream) {
    if (C <= 0) return 0;
    if (!cell_args_ok(CH, S, params) || !params->balls ||
        C > 0x7fffffffLL || window < 1 || window > CK_MAX_WINDOW)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = cell_block_bytes(params->n_legs, window, true);
    const cudaError_t e =
        allow_smem((const void*)legmov_cell_shared_kernel, bytes);
    if (e != cudaSuccess) return (int)e;
    legmov_cell_shared_kernel<<<(unsigned)C, 32, bytes,
                                (cudaStream_t)stream>>>(
        cst, cln, role, tot, cellinfo, legtab, xs, ys, zs, out, CH, S, *params);
    return (int)cudaGetLastError();
}

extern "C" int legmov_cell_cm_perleg(
    const int* cst, const int* cln, const unsigned char* role, const int* tot,
    const float* cellinfo, const float* legtab, const float* xs,
    const float* ys, const float* zs, int* out, long long C, long long CH,
    int S, int window, const ItemParams* params, void* stream) {
    (void)window;
    if (C <= 0) return 0;
    if (!cell_args_ok(CH, S, params) || C > 0x7fffffffLL ||
        CH > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = cm_block_bytes(params->n_legs);
    const cudaError_t e =
        allow_smem((const void*)legmov_cell_cm_perleg_kernel, bytes);
    if (e != cudaSuccess) return (int)e;
    legmov_cell_cm_perleg_kernel<<<(unsigned)C, 32, bytes,
                                   (cudaStream_t)stream>>>(
        cst, cln, role, tot, cellinfo, legtab, xs, ys, zs, out, CH, S, *params);
    return (int)cudaGetLastError();
}

extern "C" int legmov_cell_layout(int* param_bytes, int* header,
                                  int* leg_block, int* out_words) {
    *param_bytes = (int)sizeof(ItemParams);
    *header = CK_HDR;
    *leg_block = CK_LEG_BLOCK;
    *out_words = CK_OUT_WORDS;
    return 0;
}

// How kernel `form` (0 K5, 1 K6a, 2 K6b, 3 K6c, 4 and 5 K5's cell driver
// under the per-leg and the shared rule) is launched for `n_legs` legs and
// chunks of `window` elements (forms 4 and 5: `window` orientations):
// registers a thread, local memory a thread (spills and stack), threads and
// shared memory a block, and the blocks an SM holds at once.
extern "C" int legmov_cell_occupancy(int form, int n_legs, int window,
                                     int* regs, int* local_bytes,
                                     int* threads, int* smem_bytes,
                                     int* blocks_per_sm) {
    const void* fn = nullptr;
    size_t bytes = 0;
    int thr = CK_BLOCK;
    if (form == 1 || form == 2) {
        thr = 32;
        if (n_legs < 1 || n_legs > CK_MAX_LEGS) return (int)cudaErrorInvalidValue;
        bytes = cell_block_bytes(n_legs, window, form == 2);
        fn = form == 1 ? (const void*)legmov_cell_quat_major_kernel
                       : (const void*)legmov_cell_shared_kernel;
    } else if (form == 4 || form == 5) {
        thr = IC_WARPS * 32;
        if (n_legs < 1 || n_legs > CK_MAX_LEGS || window < 1 ||
            window > CK_MAX_QUATS)
            return (int)cudaErrorInvalidValue;
        bytes = item_cells_bytes(n_legs, window);
        fn = form == 4 ? (const void*)legmov_item_cells_kernel
                       : (const void*)legmov_item_cells_shared_kernel;
    } else if (form == 0) {
        fn = (const void*)legmov_item_kernel;
    } else if (form == 3) {
        thr = 32;
        if (n_legs < 1 || n_legs > CK_MAX_LEGS) return (int)cudaErrorInvalidValue;
        bytes = cm_block_bytes(n_legs);
        fn = (const void*)legmov_cell_cm_perleg_kernel;
    } else {
        return (int)cudaErrorInvalidValue;
    }
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, fn);
    if (e == cudaSuccess) e = allow_smem(fn, bytes);
    int nb = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fn, thr, bytes);
    if (e != cudaSuccess) return (int)e;
    *regs = fa.numRegs;
    *local_bytes = (int)fa.localSizeBytes;
    *threads = thr;
    *smem_bytes = (int)(bytes + fa.sharedSizeBytes);
    *blocks_per_sm = nb;
    return 0;
}
