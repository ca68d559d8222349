// Multi-leg oriented-reachability kernels for Hopper (sm_90a).
//
// Build (legmov_tpu_torch/ops/_build.py does this at first use, with the same
// flags as leg_kernels.cu):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -ftz=false -prec-div=true -prec-sqrt=true -shared -Xcompiler -fPIC
//
// Numerics are the contract, as in leg_kernels.cu: no FMA contraction and
// IEEE sqrtf, so that each kernel is bit-identical to its plain PyTorch
// version (ops/cuda_multileg.py) on the same card.  The operation order of
// the shared body below is the order of that plain version, including the
// `inside | near` / `!inside | near` pair per circle, so that NaN, inf and
// far-sentinel candidates give the same bits.
//
// No PyTorch headers: plain C launchers, loaded with ctypes.  What is static
// per leg (mount yaw, coxa frame, coxa yaw limits) arrives as one by-value
// `__grid_constant__` block for up to six legs; what depends on the pose
// (quaternion, body position, the six unique circles in linear form, the
// region-construction bits and threshold directions of every leg) is one row
// of the packed [P, W] table, copied to shared memory once per block.

#include <cuda_runtime.h>

#define ML_MAX_LEGS 6
#define ML_HDR 7          // quaternion (4) + body position (3)
#define ML_LEG_BLOCK 43   // floats per leg in a table row
#define ML_MAX_W 384      // table floats for six legs, padded to 128
#define ML_BLOCK 256

// offsets inside a leg block; six unique circles ordered
// [inner, outer, fa_neg, fa_pos, wing_neg, wing_pos]
#define ML_AX 0
#define ML_AY 6
#define ML_R2K 12
#define ML_HI2K 18
#define ML_LO2K 24
#define ML_FAL 30        // fal_low, fal_up, falo_low, falo_up
#define ML_MID_DIR 34
#define ML_MID_NEG 36
#define ML_SAT_DIR 37
#define ML_SAT_NEG 41

#define C_INNER 0
#define C_OUTER 1
#define C_FAN 2
#define C_FAP 3
#define C_WN 4
#define C_WP 5

// mirrored field for field by ctypes.Structure in ops/cuda_multileg.py;
// every member is 4 bytes wide, so there is no padding
struct MultilegParams {
    int n_legs, table_width;
    float ca[ML_MAX_LEGS], sa[ML_MAX_LEGS];      // cos / sin of -body_angle
    float body[ML_MAX_LEGS];
    float cp[ML_MAX_LEGS], sp[ML_MAX_LEGS];      // cos / sin of -coxa_pitch
    float coxa_len[ML_MAX_LEGS];
    float cmax_c[ML_MAX_LEGS], cmax_s[ML_MAX_LEGS];
    float cmin_c[ML_MAX_LEGS], cmin_s[ML_MAX_LEGS];
    int gt_possible[ML_MAX_LEGS], lt_possible[ML_MAX_LEGS];
};

// ---------------------------------------------------------------------------
// shared body
// ---------------------------------------------------------------------------

// body-frame candidate: subtract the body position, un-rotate by the pose
// quaternion (conjugate rotation); once per candidate, shared by the legs
__device__ __forceinline__ void unrotate(const float* T, float x, float y,
                                         float z, float& vx, float& vy,
                                         float& vz) {
    const float rx = x - T[4];
    const float ry = y - T[5];
    const float rz = z - T[6];
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

// what the reachability of leg l reads: its static constants (parameter
// block) and its part of the pose's table row (B)
struct LegConst {
    float ca, sa, body, cp, sp, coxa_len, cmax_c, cmax_s, cmin_c, cmin_s;
    bool gt_possible, lt_possible;
    bool mid_neg, sat_lo_neg, sat_hi_neg;
    float mid_c, mid_s, lo_c, lo_s, hi_c, hi_s;
    float ax[6], ay[6], r2k[6], hi2k[6], lo2k[6];
    bool fal_low, fal_up, falo_low, falo_up;
};

__device__ __forceinline__ LegConst load_leg(const MultilegParams& P, int l,
                                             const float* B) {
    LegConst K;
    K.ca = P.ca[l];
    K.sa = P.sa[l];
    K.body = P.body[l];
    K.cp = P.cp[l];
    K.sp = P.sp[l];
    K.coxa_len = P.coxa_len[l];
    K.cmax_c = P.cmax_c[l];
    K.cmax_s = P.cmax_s[l];
    K.cmin_c = P.cmin_c[l];
    K.cmin_s = P.cmin_s[l];
    K.gt_possible = P.gt_possible[l] != 0;
    K.lt_possible = P.lt_possible[l] != 0;
    K.mid_neg = B[ML_MID_NEG] > 0.5f;
    K.sat_lo_neg = B[ML_SAT_NEG] > 0.5f;
    K.sat_hi_neg = B[ML_SAT_NEG + 1] > 0.5f;
    K.mid_c = B[ML_MID_DIR];
    K.mid_s = B[ML_MID_DIR + 1];
    K.lo_c = B[ML_SAT_DIR];
    K.lo_s = B[ML_SAT_DIR + 1];
    K.hi_c = B[ML_SAT_DIR + 2];
    K.hi_s = B[ML_SAT_DIR + 3];
#pragma unroll
    for (int u = 0; u < 6; ++u) {
        K.ax[u] = B[ML_AX + u];
        K.ay[u] = B[ML_AY + u];
        K.r2k[u] = B[ML_R2K + u];
        K.hi2k[u] = B[ML_HI2K + u];
        K.lo2k[u] = B[ML_LO2K + u];
    }
    K.fal_low = B[ML_FAL] > 0.5f;
    K.fal_up = B[ML_FAL + 1] > 0.5f;
    K.falo_low = B[ML_FAL + 2] > 0.5f;
    K.falo_up = B[ML_FAL + 3] > 0.5f;
    return K;
}

// reachability of one leg (its constants K) for one body-frame candidate
__device__ __forceinline__ bool leg_reach(const LegConst& K, float vx,
                                          float vy, float vz) {
    // yaw by -body_angle ("as if leg 0"), then the coxa frame
    const float x0 = vx * K.ca - vy * K.sa;
    const float y1 = vx * K.sa + vy * K.ca;
    const float px = x0 - K.body;
    const float x1 = px * K.cp - vz * K.sp;
    const float z1 = px * K.sp + vz * K.cp;
    // mirrored half-plane; the sign bit sees -0.0 and NaN
    const bool flip = (__float_as_uint(x1) >> 31) != 0u;
    const float fx = flip ? -x1 : x1;
    const float fy = flip ? -y1 : y1;
    bool coxa_invalid = false;
    if (K.gt_possible)
        coxa_invalid = (fy * K.cmax_c - fx * K.cmax_s) > 0.0f;
    if (K.lt_possible)
        coxa_invalid = coxa_invalid | ((fy * K.cmin_c - fx * K.cmin_s) < 0.0f);
    const float rho = sqrtf(x1 * x1 + y1 * y1);
    const float xp = (flip ? -rho : rho) - K.coxa_len;
    const float yp = z1;

    // region bits from the pose's threshold directions
    const bool nn = yp >= 0.0f;
    const bool crossm = (yp * K.mid_c - xp * K.mid_s) > 0.0f;
    const bool upper = nn ? (K.mid_neg | crossm) : (K.mid_neg & crossm);
    const bool cross_lo = (yp * K.lo_c - xp * K.lo_s) > 0.0f;
    const bool cross_hi = (yp * K.hi_c - xp * K.hi_s) > 0.0f;
    const bool gt_lo =
        nn ? (K.sat_lo_neg | cross_lo) : (K.sat_lo_neg & cross_lo);
    const bool gt_hi =
        nn ? (K.sat_hi_neg | cross_hi) : (K.sat_hi_neg & cross_hi);
    const bool ext = upper ^ (upper ? gt_hi : gt_lo);

    // six unique circles once each, both validity polarities
    const float q2 = xp * xp + yp * yp;
    bool pos[6], neg[6];
#pragma unroll
    for (int u = 0; u < 6; ++u) {
        const float t = q2 + K.ax[u] * xp + K.ay[u] * yp;
        const bool inside = t <= K.r2k[u];
        const bool near = (t < K.hi2k[u]) & (t > K.lo2k[u]);
        pos[u] = inside | near;
        neg[u] = (!inside) | near;
    }
    const bool fal_low = K.fal_low, fal_up = K.fal_up;
    const bool falo_low = K.falo_low, falo_up = K.falo_up;
    // the four (region, ext) configurations as boolean algebra on the
    // construction bits.  lower: [inner, fa_neg(att=!fal), excl(rep), wing]
    const bool excl0 = falo_low ? neg[C_WP] : neg[C_FAP];
    const bool other0 = fal_low ? neg[C_FAN] : pos[C_FAN];
    const bool wing0 = fal_low ? pos[C_WN] : neg[C_WN];
    const bool base0 = neg[C_INNER] & excl0;
    const bool v00 = base0 & other0 & wing0;
    const bool other0e = fal_low ? other0 : pos[C_OUTER];
    const bool wing0e = fal_low ? pos[C_OUTER] : wing0;
    const bool v01 = base0 & other0e & wing0e;
    // upper: [inner, excl(rep), fa_pos(att=!fal), wing]
    const bool excl1 = falo_up ? neg[C_WN] : neg[C_FAN];
    const bool other1 = fal_up ? neg[C_FAP] : pos[C_FAP];
    const bool wing1 = fal_up ? pos[C_WP] : neg[C_WP];
    const bool base1 = neg[C_INNER] & excl1;
    const bool v10 = base1 & other1 & wing1;
    const bool other1e = fal_up ? other1 : pos[C_OUTER];
    const bool wing1e = fal_up ? pos[C_OUTER] : wing1;
    const bool v11 = base1 & other1e & wing1e;
    const bool plane_ok = upper ? (ext ? v11 : v10) : (ext ? v01 : v00);
    return (!coxa_invalid) & plane_ok;
}

// the same, reading the constants where they lie; B = the leg's block of
// the pose's table row
__device__ __forceinline__ bool leg_reach(const MultilegParams& P, int l,
                                          const float* B, float vx, float vy,
                                          float vz) {
    return leg_reach(load_leg(P, l, B), vx, vy, vz);
}

// copy one pose's table row to shared memory (all threads of the block)
__device__ __forceinline__ void load_row(float* T, const float* tab,
                                         long long pose, int width) {
    for (int i = threadIdx.x; i < width; i += blockDim.x)
        T[i] = tab[pose * width + i];
}

// ---------------------------------------------------------------------------
// K3  multi-leg any-reach
//
// Replaces the Pallas kernel legmov_tpu/ops/pallas_multileg.py
// make_multileg_kernel (body tile_unrotate, tile_one_leg_bit).
//
// Per (pose, candidate): the un-rotation, then every leg's reachability;
// the output bit of (pose, leg) is the OR over the pose's candidates, ORed
// into the pose's word, which may start with legs found before the launch
// (found-legs input).
//
// Bound on this card: per candidate it reads 12 bytes and does 33 fp32
// operations for the un-rotation plus 84 per leg (mount yaw 6, coxa frame 7,
// two limit tests 8, sqrt and plane coordinate 5, region bits 13, q 3, six
// circles x 7; leg_flops in ops/cuda_multileg.py): 369 for four legs, 537
// for six.  At 3.35 TB/s and 67 TFLOP/s that is 3.6 ps against 5.5 to 8.0 ps
// a candidate: operations bound it, and with no multiply-add fused the real
// ceiling is half the peak at best.  A leg once found needs no more work
// for its pose, so what a launch needs depends on its data: a walk over
// each pose's candidates in order up to each missing leg's first hit, the
// padding read but not evaluated (multileg_need in ops/cuda_multileg.py).
//
// Design: one block per (pose, slab of candidates), so that few poses with
// many candidates still fill the card.  The pose's table row goes to shared
// memory once.  A warp walks tiles of 32 x ML_R candidates (tile w, w +
// warps, ..., so the block sweeps its slab front to back), a thread holding
// ML_R of them: their un-rotations first, then leg by leg the leg's
// constants are loaded once into registers and its reachability runs on the
// ML_R candidates (independent chains); a warp vote per (tile, leg) finds a
// hit.  A candidate out of every leg's reach (ML_FAR: the driver's padding)
// is known to hit nothing, and a tile of them is skipped.  The block keeps
// the legs found so far in one shared word (seeded from the pose's output
// word, which holds the found-legs input and what other blocks of the pose
// have found): a warp reads it at each tile and skips found legs, and a
// tile with every leg found ends the warp's walk.
// The output is a pure OR, so a stale read only costs work, never a bit;
// no barrier is needed inside the walk.  One atomicOr a block into the
// pose's word.  The TPU form's [8, C] tile, its cap on C and its padding of
// the pose axis are not carried over.
// ---------------------------------------------------------------------------

// Candidates a thread holds in a tile: two.  Timed in turns on an H100:
// 1.6x four's speed at [2048, 8192], where legs are found in the first
// tiles, and 1.18x on `cli map --solver csr`'s launches; one is 1.3x faster
// at [2048, 8192] but 1.16x slower on the map's launches; a cap of three
// blocks an SM 1.06-1.11x slower.
#define ML_R 2
// A candidate this far (mm) from the pose's body in some axis, or infinitely
// far, reaches no leg: its plane point lies some 1e16 mm^2 beyond every
// circle's threshold (oriented_tables in ops/cuda_multileg.py refuses a leg
// whose circles reach 1e5 mm from the body), so every circle test is false
// and so is every region's validity.  The CSR driver pads its windows with
// such candidates (SENTINEL = 1e9).
#define ML_FAR 1e8f

extern "C" __global__ void __launch_bounds__(ML_BLOCK, 2)
legmov_multileg_kernel(const float* __restrict__ tab,
                       const float* __restrict__ gx,
                       const float* __restrict__ gy,
                       const float* __restrict__ gz, long long C,
                       long long slab, int* __restrict__ out_bits,
                       const __grid_constant__ MultilegParams P) {
    __shared__ float T[ML_MAX_W];
    __shared__ unsigned found_sh;
    const long long pose = blockIdx.x;
    const int L = P.n_legs;
    const unsigned all = (1u << L) - 1u;
    load_row(T, tab, pose, P.table_width);
    if (threadIdx.x == 0) found_sh = (unsigned)out_bits[pose] & all;
    __syncthreads();

    const long long lo = (long long)blockIdx.y * slab;
    const long long hi = (lo + slab < C) ? lo + slab : C;
    const float* x = gx + pose * C;
    const float* y = gy + pose * C;
    const float* z = gz + pose * C;
    const int lane = threadIdx.x & 31;
    const long long tile = 32 * ML_R;
    const long long stride = (long long)(blockDim.x >> 5) * tile;
    volatile unsigned* found_v = &found_sh;
    for (long long t0 = lo + (long long)(threadIdx.x >> 5) * tile; t0 < hi;
         t0 += stride) {
        // the legs found so far, the same in every lane
        unsigned found = __shfl_sync(0xffffffffu, *found_v, 0);
        if (found == all) break;
        float vx[ML_R], vy[ML_R], vz[ML_R];
        bool live[ML_R];
        bool any = false;
#pragma unroll
        for (int r = 0; r < ML_R; ++r) {
            const long long c = t0 + r * 32 + lane;
            const long long cc = c < hi ? c : lo;
            const float px = x[cc], py = y[cc], pz = z[cc];
            const bool far = (fabsf(px - T[4]) > ML_FAR) |
                             (fabsf(py - T[5]) > ML_FAR) |
                             (fabsf(pz - T[6]) > ML_FAR);
            live[r] = (c < hi) & !far;
            any |= live[r];
            unrotate(T, px, py, pz, vx[r], vy[r], vz[r]);
        }
        // a tile of padding (or of candidates out of reach) costs its loads
        if (!__any_sync(0xffffffffu, any)) continue;
        for (int l = 0; l < L; ++l) {
            if ((found >> l) & 1u) continue;
            const LegConst K = load_leg(P, l, T + ML_HDR + l * ML_LEG_BLOCK);
            bool hit = false;
#pragma unroll
            for (int r = 0; r < ML_R; ++r)
                hit = hit | (live[r] & leg_reach(K, vx[r], vy[r], vz[r]));
            if (__any_sync(0xffffffffu, hit)) {
                found |= 1u << l;
                if (lane == 0) atomicOr(&found_sh, 1u << l);
            }
        }
    }
    __syncthreads();
    if (threadIdx.x == 0 && found_sh) atomicOr(out_bits + pose, (int)found_sh);
}

// ---------------------------------------------------------------------------
// K4  CSR window streaming
//
// Replaces the Pallas kernel of legmov_tpu/ops/csr_grid.py
// make_csr_dma_solver (make_kernel, launched by dma_round).
//
// Per (pose, queue step): a window of `len` candidates of the cell-sorted
// foothold arrays starting at element `start`, the legs in the step's bit
// mask evaluated with the shared body, hits ORed into the pose's bits, which
// start from legs_in.  Mask 0 or length 0 is a dead step.
//
// Bound on this card: the work is the queue's: per fetched candidate 12
// bytes and 33 operations, plus 84 per masked leg that is still missing when
// its step is reached.  With one to six legs a step that is 3.6 ps of bytes
// against 1.7 to 8.0 ps of operations a candidate: operations bound a
// typical queue.  The indices (12 bytes a step) and the table row are noise.
//
// Design: one block per pose walks that pose's steps in order, so the found
// bits live in the block and a step whose legs are all found costs three
// loads (a pure OR: skipping changes no bit).  Windows are read straight
// from global memory at their element offset, coalesced, with the step's own
// length: nothing of the TPU form's 1024-element DMA alignment, widened
// fetch, [rows, 128] layout, sentinel pad for dead steps or unmasked window
// tail is needed.  Poses are independent, so A blocks run side by side; a
// round with few poses and long queues leaves SMs idle (see PERF.md).
// ---------------------------------------------------------------------------

extern "C" __global__ void __launch_bounds__(ML_BLOCK)
legmov_csr_window_kernel(const int* __restrict__ starts,
                         const int* __restrict__ lens,
                         const int* __restrict__ masks, long long S,
                         const float* __restrict__ tab,
                         const unsigned char* __restrict__ legs_in,
                         const float* __restrict__ xs,
                         const float* __restrict__ ys,
                         const float* __restrict__ zs,
                         unsigned char* __restrict__ out,
                         const __grid_constant__ MultilegParams P) {
    __shared__ float T[ML_MAX_W];
    __shared__ unsigned found_sh;
    const long long pose = blockIdx.x;
    const int L = P.n_legs;
    load_row(T, tab, pose, P.table_width);
    if (threadIdx.x == 0) {
        unsigned f = 0u;
        for (int l = 0; l < L; ++l)
            f |= (legs_in[pose * L + l] ? 1u : 0u) << l;
        found_sh = f;
    }
    __syncthreads();
    unsigned found = found_sh;

    const int* st = starts + pose * S;
    const int* ln = lens + pose * S;
    const int* mk = masks + pose * S;
    for (long long s = 0; s < S; ++s) {
        // the same for every thread of the block, so the barriers below are
        // reached by all or by none
        const unsigned need = (unsigned)mk[s] & ~found;
        const int len = ln[s];
        if (need == 0u || len <= 0) continue;
        const long long start = st[s];
        unsigned hits = 0u;
        for (int c = threadIdx.x; c < len; c += blockDim.x) {
            float vx, vy, vz;
            unrotate(T, xs[start + c], ys[start + c], zs[start + c], vx, vy, vz);
            for (int l = 0; l < L; ++l) {
                if (!((need >> l) & 1u) || ((hits >> l) & 1u)) continue;
                if (leg_reach(P, l, T + ML_HDR + l * ML_LEG_BLOCK, vx, vy, vz))
                    hits |= 1u << l;
            }
        }
        hits = __reduce_or_sync(0xffffffffu, hits);
        if ((threadIdx.x & 31) == 0 && hits) atomicOr(&found_sh, hits);
        __syncthreads();
        found = found_sh;
        __syncthreads();  // nobody ORs the next step in before all have read
    }
    if (threadIdx.x < L)
        out[pose * L + threadIdx.x] = (unsigned char)((found >> threadIdx.x) & 1u);
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

// out_bits: int32 [P], the found-legs input (bit l = leg l), which the
// launch ORs its hits into
extern "C" int legmov_multileg(const float* tab, const float* gx,
                               const float* gy, const float* gz, long long P,
                               long long C, int* out_bits,
                               const MultilegParams* params, void* stream) {
    if (P <= 0 || C <= 0) return 0;
    if (params->n_legs < 1 || params->n_legs > ML_MAX_LEGS ||
        params->table_width > ML_MAX_W)
        return (int)cudaErrorInvalidValue;
    // slabs of candidates per pose: enough blocks to fill the card eight
    // times over, but no slab below one tile a warp
    const long long min_slab = (long long)ML_R * ML_BLOCK;
    long long slabs = ((long long)sm_count() * 8 + P - 1) / P;
    const long long max_slabs = (C + min_slab - 1) / min_slab;
    if (slabs > max_slabs) slabs = max_slabs;
    if (slabs < 1) slabs = 1;
    if (slabs > 65535) slabs = 65535;
    const long long slab = (C + slabs - 1) / slabs;
    dim3 grid((unsigned)P, (unsigned)((C + slab - 1) / slab));
    legmov_multileg_kernel<<<grid, ML_BLOCK, 0, (cudaStream_t)stream>>>(
        tab, gx, gy, gz, C, slab, out_bits, *params);
    return (int)cudaGetLastError();
}

extern "C" int legmov_csr_window(const int* starts, const int* lens,
                                 const int* masks, long long A, long long S,
                                 const float* tab,
                                 const unsigned char* legs_in, const float* xs,
                                 const float* ys, const float* zs,
                                 unsigned char* out,
                                 const MultilegParams* params, void* stream) {
    if (A <= 0) return 0;
    if (params->n_legs < 1 || params->n_legs > ML_MAX_LEGS ||
        params->table_width > ML_MAX_W)
        return (int)cudaErrorInvalidValue;
    legmov_csr_window_kernel<<<(unsigned)A, ML_BLOCK, 0, (cudaStream_t)stream>>>(
        starts, lens, masks, S, tab, legs_in, xs, ys, zs, out, *params);
    return (int)cudaGetLastError();
}

extern "C" int legmov_multileg_layout(int* param_bytes, int* header,
                                      int* leg_block) {
    *param_bytes = (int)sizeof(MultilegParams);
    *header = ML_HDR;
    *leg_block = ML_LEG_BLOCK;
    return 0;
}
