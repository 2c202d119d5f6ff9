// Relative-position attention for TRAINING: the fp32 forward and backward
// kernels, and the entry points of both element types.
//
// Replaces ops/pallas_train_attention.py::_fwd_kernel and ::_bwd_kernel of
// the JAX package:
//
//   S  = ([q_u | q_rot] . [k | k_std]) / sqrt(dh)     one dot of width kd = dh + D
//   S[:, s >= length] := -1e9                          replaced, not added
//   P  = softmax(S) in fp32;  Pd = keep ? P / (1 - rate) : 0   keep from the counter hash
//   out = Pd v
//
//   dv = Pd^T dO;  dP = keep ? (dO v^T) / (1 - rate) : 0
//   dS = P (dP - rowsum(dP P)) / sqrt(dh)
//   dq_u = dS k;  dq_rot = dS k_std;  dk = dS^T q_u
//
// bf16 runs rel_attention_train_fwd.cu and rel_attention_train_bwd.cu (wgmma,
// TMA rings); this file holds their entry points and the fp32 kernels.
//
// What bounds the fp32 kernels on the H100: fp32 FFMA at 67 TFLOP/s. At head
// 64 and q_rot 512 the S product is 576 columns deep, 90 % of the forward's
// operations and half the backward's; every operand is read from L2 more
// than once, but the bytes each kernel must move are far below its operations
// at 3.35 TB/s. The design keeps the FFMA pipes fed and walks S as few times
// as the work needs:
//
//   products  every product is a register-tiled FFMA loop: a thread holds a
//             4 x 4 (S, dP, P v, dk, dv) or 4 x 8 (dq) tile of the result in
//             registers and reads its operands as float4, one shared-memory
//             load per 8 to 11 FFMAs. The operands of the deep products
//             (S over kd, dq over the keys) stream through a ring of chunks
//             in shared memory (64 columns in two stages; dq: 32 keys in
//             three), each chunk's 16-byte cp.async.cg issued one (two)
//             chunks ahead of its FFMAs; the query rows
//             are read again from L2 for each key tile (a resident 64 x 576
//             tile would leave room for one block an SM). Blocks of 256
//             threads, two an SM (76-102 KB of shared memory each).
//   forward   block = (64 query rows, head, batch), ONE walk over the key
//             tiles: the online row max and sum of FlashAttention-2, P v
//             accumulated in registers as exp(x - m_run) (keep ? inv_keep :
//             0) v, rescaled when m_run moves, divided by the row sum at the
//             end. Equal to the plain version's P v with P = exp(x - m) / l
//             up to fp32 rounding (a few ulps a term, well inside the 1e-4
//             tolerance): no fp32 rounding point sits between P and the
//             dropout scale. Writes stats (m, l) for the backward.
//   backward  three kernels, ONE S product:
//     delta   delta = rowsum(dO out) in fp32 from the forward's out. With
//             Pd = keep P inv_keep and dP = keep (dO v^T) inv_keep,
//             rowsum(dP P) = dO . sum_s Pd_s v_s = dO . out: the TPU kernel's
//             rowsum(dP P32) up to fp32 rounding (in bf16 they differ, since
//             out is built from the rounded P; the bf16 kernels keep the
//             TPU kernel's form).
//     dk/dv   block = (64 keys, head, batch), walks the query tiles once: S
//             (the ring), dP = dO v^T (one more chunk of the ring: dO against
//             v), P from stats, dS; accumulates dv += Pd^T dO and
//             dk += dS^T q_u in registers, reading dO and q_u from the stages
//             that brought them, and writes dS (fp32) to a (B, H, T, ld)
//             scratch, every visited key tile whole.
//     dq      block = (64 query rows, 128 columns of [dq_u | dq_rot], head,
//             batch): [dq_u | dq_rot] = dS [k | k_std] over the visited keys,
//             both operands through the ring.
#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 64;        // rows a block owns: queries (forward, dq) or keys (dk/dv)
constexpr int BN = 64;        // rows of a tile it walks: keys (forward) or queries (dk/dv)
constexpr int KC = 64;        // columns of a chunk of [q_u | q_rot] and [k | k_std] in the forward and dk/dv rings
constexpr int LDC = KC + 4;   // row stride of a chunk in shared memory, floats (16 bytes of pad)
constexpr int LDP = BN + 4;   // row stride of P, Pd and dS tiles
constexpr int QC = 128;       // dq: columns of [dq_u | dq_rot] a block
constexpr int LDQ = QC + 4;
constexpr int DKC = 32;       // dq: keys of a chunk, in a ring of DQ_STAGES stages
constexpr int LDD = DKC + 4;
constexpr int DQ_STAGES = 3;

// Shared-memory bytes of each kernel (tests/test_torch_fp32_wide_k4.py recomputes them: change both together).
// The rings of the forward and dk/dv have two stages (a chunk's cp.async issued one chunk ahead of its
// FFMAs), dq's three (two chunks ahead). None depends on q_rot: the rings stream [q_u | q_rot] and
// [k | k_std] at any width.
constexpr size_t fwd_smem(int dh) { return 4 * (size_t)(2 * (BM + BN) * LDC + BN * (dh + 4) + BM * LDP); }
constexpr size_t dkv_smem() { return 4 * (size_t)(2 * (BN + BM) * LDC + BN * LDP); }
constexpr size_t dq_smem() { return 4 * (size_t)(DQ_STAGES * (BM * LDD + DKC * LDQ)); }

// cp.async of rows [r0, r0 + ROWS) x columns [c0, c0 + W) of [a | b] (a of na
// columns, b of nb; row strides sa, sb) into dst (row stride ld). Rows at or
// past T and columns at or past na + nb are zeros. na and nb are multiples of 4.
template <int ROWS, int W>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* a, size_t sa, int na, const float* b,
                                          size_t sb, int nb, int r0, int c0, int T) {
    constexpr int VR = W / 4;
    static_assert(ROWS * VR % THREADS == 0, "whole vectors a thread");
#pragma unroll
    for (int u = 0; u < ROWS * VR / THREADS; ++u) {
        const int i = threadIdx.x + u * THREADS;
        const int r = i / VR, c = c0 + (i % VR) * 4, t = r0 + r;
        const bool ok = t < T && c < na + nb;
        const float* src = a;
        if (ok) src = c < na ? a + (size_t)t * sa + c : b + (size_t)t * sb + (c - na);
        cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * ld + (c - c0))), src, ok);
    }
}

template <int VW>
__device__ __forceinline__ void ld_vec(float (&dst)[VW], const float* p) {
    if constexpr (VW == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
    } else {
        const float2 t = *reinterpret_cast<const float2*>(p);
        dst[0] = t.x; dst[1] = t.y;
    }
}

template <int VW>
__device__ __forceinline__ void st_vec(float* p, const float (&src)[VW]) {
    if constexpr (VW == 4)
        *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
    else
        *reinterpret_cast<float2*>(p) = make_float2(src[0], src[1]);
}

// acc[i][j] += sum over k < K of A[i * LDA + k] B[16 j * LDB + k]: both
// operands k-contiguous (S = Q K^T, dP = dO V^T). The thread's 4 rows are
// consecutive, its 4 columns 16 apart: a phase of 8 lanes then reads one A
// row (broadcast) and 8 B rows on distinct banks.
template <int K, int LDA, int LDB>
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* A, const float* B) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
        float a[4][4], b[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ld_vec<4>(a[i], A + i * LDA + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) ld_vec<4>(b[j], B + 16 * j * LDB + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
    }
}

// acc[i][g VW + v] += sum over k < K of A[i * LDA + k] B[k * LDB + g GS + v]:
// A k-contiguous, B row-major (P v, dS [k | k_std]).
template <int K, int LDA, int LDB, int G, int GS, int VW>
__device__ __forceinline__ void mm_nn(float (&acc)[4][G * VW], const float* A, const float* B) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ld_vec<4>(a[i], A + i * LDA + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            float b[G][VW];
#pragma unroll
            for (int g = 0; g < G; ++g) ld_vec<VW>(b[g], B + (k + kk) * LDB + g * GS);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int g = 0; g < G; ++g)
#pragma unroll
                    for (int v = 0; v < VW; ++v) acc[i][g * VW + v] = fmaf(a[i][kk], b[g][v], acc[i][g * VW + v]);
        }
    }
}

// acc[i][v] += sum over k < K of A[k * LDA + i] B[k * LDB + v]: A stored
// transposed (dv = Pd^T dO, dk = dS^T q_u, with Pd and dS as [query][key]).
template <int K, int LDA, int LDB, int VW>
__device__ __forceinline__ void mm_tn(float (&acc)[4][VW], const float* A, const float* B) {
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
        float a[4], b[VW];
        ld_vec<4>(a, A + k * LDA);
        ld_vec<VW>(b, B + k * LDB);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int v = 0; v < VW; ++v) acc[i][v] = fmaf(a[i], b[v], acc[i][v]);
    }
}

// ---------------------------------------------------------------------------
// forward: block = (64 query rows, head, batch), one walk over the key tiles

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
train_fwd_kernel(const float* __restrict__ q_u, const float* __restrict__ q_rot, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ k_std, const int* __restrict__ lengths,
                 float* __restrict__ out, float* __restrict__ stats, int B, int T, int H, int D, float scale,
                 DropoutArgs drop) {
    constexpr int LDV = DH + 4, VW = DH / 16, STAGE = (BM + BN) * LDC;
    extern __shared__ __align__(128) float smem[];
    float* ring = smem;            // [2][query chunk BM x LDC, key chunk BN x LDC]
    float* Vs = ring + 2 * STAGE;  // [BN][LDV]
    float* Ps = Vs + BN * LDV;     // [BM][LDP]: Pd of the key tile

    const int t0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // this thread's rows of S and out: row0 + i; its score columns cg + 16 j, its out columns VW cg + v
    const int row0 = warp * 8 + (lane / 16) * 4, cg = lane % 16;
    const int kd = DH + D, len = lengths[b], n_keys = visited_keys(len, T);
    const int nc = (kd + KC - 1) / KC, total = (n_keys + BN - 1) / BN * nc;
    const size_t hs = (size_t)H * DH, rs = (size_t)H * D;  // row strides of (B,T,H,dh), (B,T,H,D)
    const float* qu_b = q_u + (size_t)b * T * hs + (size_t)h * DH;
    const float* qr_b = q_rot + (size_t)b * T * rs + (size_t)h * D;
    const float* k_b = k + (size_t)b * T * hs + (size_t)h * DH;
    const float* v_b = v + (size_t)b * T * hs + (size_t)h * DH;

    // chunk idx of the walk: key tile idx / nc, columns (idx % nc) KC of both operands
    auto issue = [&](int idx) {
        if (idx < total) {
            float* st = ring + (idx & 1) * STAGE;
            const int c0 = (idx % nc) * KC;
            load_tile<BM, KC>(st, LDC, qu_b, hs, DH, qr_b, rs, D, t0, c0, T);
            load_tile<BN, KC>(st + BM * LDC, LDC, k_b, hs, DH, k_std, (size_t)D, D, (idx / nc) * BN, c0, T);
        }
        cp_async_commit();
    };
    issue(0);

    const uint32_t key = dropout_key(drop.seed, drop.row0 + b, h, H);
    float o[4][VW], m_run[4], l_part[4];  // l_part: this thread's columns' share of the row sum
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m_run[i] = -INFINITY;
        l_part[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < VW; ++c) o[i][c] = 0.0f;
    }

    for (int s0 = 0, idx = 0; s0 < n_keys; s0 += BN) {
        load_tile<BN, DH>(Vs, LDV, v_b, hs, DH, v_b, hs, 0, s0, 0, T);  // lands with the next group
        float s[4][4] = {};
        for (int c = 0; c < nc; ++c, ++idx) {
            cp_async_wait<0>();
            __syncthreads();  // chunk idx is in place; every warp is done with chunk idx - 1
            issue(idx + 1);
            const float* st = ring + (idx & 1) * STAGE;
            mm_nt<KC, LDC, LDC>(s, st + row0 * LDC, st + BM * LDC + cg * LDC);
        }
        // online softmax over this key tile
        float mx[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            mx[i] = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = masked_score(s[i][j], scale, s0 + cg + 16 * j, len, T);
                mx[i] = fmaxf(mx[i], s[i][j]);
            }
            mx[i] = group_max(mx[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float m_new = fmaxf(m_run[i], mx[i]);
            const float alpha = expf(m_run[i] - m_new);  // 0 on the first tile (m_run = -inf)
            m_run[i] = m_new;
            l_part[i] *= alpha;
#pragma unroll
            for (int c = 0; c < VW; ++c) o[i][c] *= alpha;
            const int t = t0 + row0 + i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int sc = s0 + cg + 16 * j;
                float p = expf(s[i][j] - m_new);
                l_part[i] += p;
                if (drop.enabled) p = dropout_keep(key, t, sc, T, drop.thresh) ? p * drop.inv_keep : 0.0f;
                Ps[(row0 + i) * LDP + cg + 16 * j] = p;
            }
        }
        cp_async_wait<0>();
        __syncthreads();  // V of the tile and every row of Pd in place
        mm_nn<BN, LDP, LDV, 1, 0, VW>(o, Ps + row0 * LDP, Vs + VW * cg);
        __syncthreads();  // Ps and Vs are free for the next tile
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float l = group_sum(l_part[i]);
        const int t = t0 + row0 + i;
        if (t >= T) continue;
        if (cg == 0) {
            const size_t at = ((size_t)b * H + h) * T + t;
            stats[at] = m_run[i];
            stats[(size_t)B * H * T + at] = l;
        }
        float r[VW];
#pragma unroll
        for (int c = 0; c < VW; ++c) r[c] = o[i][c] / l;
        st_vec<VW>(out + ((size_t)b * T + t) * hs + (size_t)h * DH + VW * cg, r);
    }
}

// ---------------------------------------------------------------------------
// backward, delta = rowsum(dO out): one thread a (b, t, h) row

template <int DH>
__global__ void __launch_bounds__(THREADS)
train_bwd_delta_kernel(const float* __restrict__ out, const float* __restrict__ d_out, float* __restrict__ delta,
                       int B, int T, int H) {
    const int r = blockIdx.x * THREADS + threadIdx.x;  // row of (B, T, H)
    if (r >= B * T * H) return;
    const float* o = out + (size_t)r * DH;
    const float* g = d_out + (size_t)r * DH;
    float sum = 0.0f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
        float a[4], c[4];
        ld_vec<4>(a, o + d);
        ld_vec<4>(c, g + d);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum = fmaf(a[e], c[e], sum);
    }
    const int h = r % H, t = (r / H) % T, b = r / (H * T);
    delta[((size_t)b * H + h) * T + t] = sum;
}

// ---------------------------------------------------------------------------
// backward, dk/dv: block = (64 keys, head, batch), one walk over the query tiles

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
train_bwd_dkv_kernel(const float* __restrict__ q_u, const float* __restrict__ q_rot, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ k_std, const int* __restrict__ lengths,
                     const float* __restrict__ d_out, const float* __restrict__ stats,
                     const float* __restrict__ delta, float* __restrict__ ds, int ld, float* __restrict__ dk,
                     float* __restrict__ dv, int B, int T, int H, int D, float scale, DropoutArgs drop) {
    constexpr int VW = DH / 16, STAGE = (BN + BM) * LDC;
    extern __shared__ __align__(128) float smem[];
    float* ring = smem;             // [2][query side BN x LDC, key side BM x LDC]
    float* PS = ring + 2 * STAGE;   // [BN][LDP]: Pd, then dS, of the query tile

    const int s0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // S and dP as in the forward: query rows row0 + i, key columns cg + 16 j
    const int row0 = warp * 8 + (lane / 16) * 4, cg = lane % 16;
    // dk and dv: key rows 4 ms + i, columns VW nd + v
    const int ms = 4 * (warp % 4) + lane / 8, nd = 8 * (warp / 4) + lane % 8;
    const int kd = DH + D, len = lengths[b];
    const size_t hs = (size_t)H * DH, rs = (size_t)H * D;
    float* dk_b = dk + (size_t)b * T * hs + (size_t)h * DH;
    float* dv_b = dv + (size_t)b * T * hs + (size_t)h * DH;

    if (s0 >= visited_keys(len, T)) {
        // every probability of these keys is an exact zero: so are dk and dv
        for (int i = threadIdx.x; i < BM * DH; i += THREADS) {
            const int s = s0 + i / DH, d = i % DH;
            if (s < T) dk_b[(size_t)s * hs + d] = dv_b[(size_t)s * hs + d] = 0.0f;
        }
        return;
    }

    const float* qu_b = q_u + (size_t)b * T * hs + (size_t)h * DH;
    const float* qr_b = q_rot + (size_t)b * T * rs + (size_t)h * D;
    const float* k_b = k + (size_t)b * T * hs + (size_t)h * DH;
    const float* v_b = v + (size_t)b * T * hs + (size_t)h * DH;
    const float* do_b = d_out + (size_t)b * T * hs + (size_t)h * DH;
    const size_t bh = ((size_t)b * H + h) * T;  // (b, h)'s row 0 of stats, delta and dS
    // a query tile takes nc + 1 chunks: S over columns chunk 1 .. nc - 1, then dO against v (dP), then S
    // over chunk 0, whose query side holds q_u, so that it stays in its stage for dk; dO stays in its
    // stage for dv
    const int nc = (kd + KC - 1) / KC, per = nc + 1, n_tiles = (T + BN - 1) / BN;

    auto issue = [&](int idx) {
        const int t0 = idx / per * BN, p = idx % per;
        float* st = ring + (idx & 1) * STAGE;
        if (p == nc - 1) {
            load_tile<BN, KC>(st, LDC, do_b, hs, DH, do_b, hs, 0, t0, 0, T);
            load_tile<BM, KC>(st + BN * LDC, LDC, v_b, hs, DH, v_b, hs, 0, s0, 0, T);
        } else {
            const int c0 = (p == nc ? 0 : p + 1) * KC;
            load_tile<BN, KC>(st, LDC, qu_b, hs, DH, qr_b, rs, D, t0, c0, T);
            load_tile<BM, KC>(st + BN * LDC, LDC, k_b, hs, DH, k_std, (size_t)D, D, s0, c0, T);
        }
        cp_async_commit();
    };
    issue(0);

    const uint32_t key = dropout_key(drop.seed, drop.row0 + b, h, H);
    float acc_v[4][VW] = {}, acc_k[4][VW] = {};

    for (int q = 0, idx = 0; q < n_tiles; ++q) {
        float s[4][4] = {}, dp[4][4] = {};
        for (int p = 0; p < per; ++p, ++idx) {
            cp_async_wait<0>();
            __syncthreads();  // chunk idx in place; every warp is done with chunk idx - 1
            if (p < nc) issue(idx + 1);
            const float* st = ring + (idx & 1) * STAGE;
            if (p == nc - 1)
                mm_nt<DH, LDC, LDC>(dp, st + row0 * LDC, st + BN * LDC + cg * LDC);
            else
                mm_nt<KC, LDC, LDC>(s, st + row0 * LDC, st + BN * LDC + cg * LDC);
        }
        const float* dO_st = ring + (idx & 1) * STAGE;        // chunk idx - 2: dO
        const float* qu_st = ring + ((idx - 1) & 1) * STAGE;  // chunk idx - 1: q_u in columns [0, DH)
        const int t0 = q * BN;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int t = t0 + row0 + i;
            const bool live = t < T;
            const size_t at = bh + min(t, T - 1);
            const float m = stats[at], l = stats[(size_t)B * H * T + at], dl = delta[at];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int sc = s0 + cg + 16 * j;
                const float x = masked_score(s[i][j], scale, sc, len, T);
                const float p = live ? expf(x - m) / l : 0.0f;
                float pd = p, dpv = dp[i][j];
                if (drop.enabled) {
                    const bool keep = dropout_keep(key, t, sc, T, drop.thresh);
                    pd = keep ? p * drop.inv_keep : 0.0f;
                    dpv = keep ? dpv * drop.inv_keep : 0.0f;
                }
                s[i][j] = p * (dpv - dl) * scale;  // dS
                PS[(row0 + i) * LDP + cg + 16 * j] = pd;
                if (live) ds[(bh + t) * ld + sc] = s[i][j];
            }
        }
        __syncthreads();  // every query row of Pd in place
        mm_tn<BN, LDP, LDC, VW>(acc_v, PS + 4 * ms, dO_st + VW * nd);
        __syncthreads();  // dO's stage and PS are free
        if (q + 1 < n_tiles) issue(idx);  // the next tile's first chunk, into dO's stage
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) PS[(row0 + i) * LDP + cg + 16 * j] = s[i][j];
        __syncthreads();  // every query row of dS in place
        mm_tn<BN, LDP, LDC, VW>(acc_k, PS + 4 * ms, qu_st + VW * nd);
        __syncthreads();  // PS and q_u's stage are free
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = s0 + 4 * ms + i;
        if (s >= T) continue;
        st_vec<VW>(dk_b + (size_t)s * hs + VW * nd, acc_k[i]);
        st_vec<VW>(dv_b + (size_t)s * hs + VW * nd, acc_v[i]);
    }
}

// ---------------------------------------------------------------------------
// backward, dq: block = (64 query rows, 128 columns of [dq_u | dq_rot], head, batch)

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
train_bwd_dq_kernel(const float* __restrict__ k, const float* __restrict__ k_std, const int* __restrict__ lengths,
                    const float* __restrict__ ds, int ld, float* __restrict__ dq_u, float* __restrict__ dq_rot,
                    int B, int T, int H, int D) {
    constexpr int STAGE = BM * LDD + DKC * LDQ;
    extern __shared__ __align__(128) float smem[];  // [DQ_STAGES][dS chunk BM x LDD, [k | k_std] chunk DKC x LDQ]

    const int kd = DH + D, n_cc = (kd + QC - 1) / QC;
    const int t0 = blockIdx.x / n_cc * BM, c0 = blockIdx.x % n_cc * QC, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // rows row0 + i; columns c0 + 4 cg + e and c0 + 64 + 4 cg + e
    const int row0 = warp * 8 + (lane / 16) * 4, cg = lane % 16;
    const int n_chunks = (visited_keys(lengths[b], T) + DKC - 1) / DKC;
    const size_t hs = (size_t)H * DH, rs = (size_t)H * D;
    const float* k_b = k + (size_t)b * T * hs + (size_t)h * DH;
    const float* ds_b = ds + ((size_t)b * H + h) * T * ld;

    // chunk idx: keys [idx DKC, idx DKC + DKC) of dS's rows and of [k | k_std]'s columns c0..
    auto issue = [&](int idx) {
        if (idx < n_chunks) {
            float* st = smem + (idx % DQ_STAGES) * STAGE;
            load_tile<BM, DKC>(st, LDD, ds_b, (size_t)ld, ld, ds_b, 0, 0, t0, idx * DKC, T);
            load_tile<DKC, QC>(st + BM * LDD, LDQ, k_b, hs, DH, k_std, (size_t)D, D, idx * DKC, c0, T);
        }
        cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < DQ_STAGES - 1; ++i) issue(i);

    float acc[4][8] = {};
    for (int idx = 0; idx < n_chunks; ++idx) {
        cp_async_wait<DQ_STAGES - 2>();
        __syncthreads();  // chunk idx in place; every warp is done with chunk idx - 1
        issue(idx + DQ_STAGES - 1);
        const float* st = smem + (idx % DQ_STAGES) * STAGE;
        mm_nn<DKC, LDD, LDQ, 2, 64, 4>(acc, st + row0 * LDD, st + BM * LDD + 4 * cg);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int t = t0 + row0 + i;
        if (t >= T) continue;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
            const int c = c0 + 64 * g + 4 * cg;
            const float r[4] = {acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]};
            if (c < DH)
                st_vec<4>(dq_u + ((size_t)b * T + t) * hs + (size_t)h * DH + c, r);
            else if (c < kd)
                st_vec<4>(dq_rot + ((size_t)b * T + t) * rs + (size_t)h * D + (c - DH), r);
        }
    }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DH>
int fwd(const void* q_u, const void* q_rot, const void* k, const void* v, const void* k_std, const void* lengths,
        void* out, void* stats, int B, int T, int H, int D, float scale, DropoutArgs drop, cudaStream_t stream) {
    const size_t bytes = fwd_smem(DH);
    cudaError_t err = allow_smem(train_fwd_kernel<DH>, bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T + BM - 1) / BM, H, B);
    train_fwd_kernel<DH><<<grid, THREADS, bytes, stream>>>(
        (const float*)q_u, (const float*)q_rot, (const float*)k, (const float*)v, (const float*)k_std,
        (const int*)lengths, (float*)out, (float*)stats, B, T, H, D, scale, drop);
    return (int)cudaGetLastError();
}

template <int DH>
int bwd(const void* q_u, const void* q_rot, const void* k, const void* v, const void* k_std, const void* lengths,
        const void* out, const void* d_out, const void* stats, void* delta, void* ds, void* dq_u, void* dq_rot,
        void* dk, void* dv, int B, int T, int H, int D, int ld, float scale, DropoutArgs drop, cudaStream_t stream) {
    cudaError_t err = allow_smem(train_bwd_dkv_kernel<DH>, dkv_smem());
    if (err == cudaSuccess) err = allow_smem(train_bwd_dq_kernel<DH>, dq_smem());
    if (err != cudaSuccess) return (int)err;
    train_bwd_delta_kernel<DH><<<(B * T * H + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        (const float*)out, (const float*)d_out, (float*)delta, B, T, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    train_bwd_dkv_kernel<DH><<<dim3((T + BM - 1) / BM, H, B), THREADS, dkv_smem(), stream>>>(
        (const float*)q_u, (const float*)q_rot, (const float*)k, (const float*)v, (const float*)k_std,
        (const int*)lengths, (const float*)d_out, (const float*)stats, (const float*)delta, (float*)ds, ld,
        (float*)dk, (float*)dv, B, T, H, D, scale, drop);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int n_cc = (DH + D + QC - 1) / QC;
    train_bwd_dq_kernel<DH><<<dim3((T + BM - 1) / BM * n_cc, H, B), THREADS, dq_smem(), stream>>>(
        (const float*)k, (const float*)k_std, (const int*)lengths, (const float*)ds, ld, (float*)dq_u,
        (float*)dq_rot, B, T, H, D);
    return (int)cudaGetLastError();
}

}  // namespace

// q_u, k, v, out: (B, T, H, dh) contiguous; q_rot: (B, T, H, D); k_std: (T, D);
// lengths: (B,) int32; stats: (2, B, H, T) fp32 (row max, row sum). dh = 32 or
// 64 (the wrapper pads other head sizes with zero columns); is_bf16 selects the
// element type (bf16 or float); row0: the number the dropout hash gives batch row 0.
ASR_API int asr_rel_attention_train_fwd(const void* q_u, const void* q_rot, const void* k,
                                        const void* v, const void* k_std, const void* lengths,
                                        void* out, void* stats, int B, int T, int H, int dh, int D,
                                        int is_bf16, float scale, unsigned seed, unsigned thresh,
                                        float inv_keep, int dropout, int row0, void* stream) {
    if (D % 16 != 0 || T < 1) return (int)cudaErrorInvalidValue;
    const DropoutArgs drop{seed, thresh, inv_keep, dropout, row0};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_head_width(dh, [&](auto head) {
        constexpr int DH = decltype(head)::value;
        return is_bf16 ? train_fwd_bf16<DH>(q_u, q_rot, k, v, k_std, lengths, out, stats, B, T, H, D, scale, drop, st)
                       : fwd<DH>(q_u, q_rot, k, v, k_std, lengths, out, stats, B, T, H, D, scale, drop, st);
    });
}

// The bf16 backward: the dq kernel, then the dk/dv kernel, which reads the
// first's delta. delta: (B, H, T) fp32 scratch; dq_rot: (B, T, H, D); dq_u,
// dk, dv: (B, T, H, dh). fp32 runs asr_rel_attention_train_bwd_fp32.
ASR_API int asr_rel_attention_train_bwd(const void* q_u, const void* q_rot, const void* k,
                                        const void* v, const void* k_std, const void* lengths,
                                        const void* d_out, const void* stats, void* delta,
                                        void* dq_u, void* dq_rot, void* dk, void* dv, int B, int T,
                                        int H, int dh, int D, int is_bf16, float scale,
                                        unsigned seed, unsigned thresh, float inv_keep, int dropout,
                                        int row0, void* stream) {
    if (D % 16 != 0 || T < 1 || !is_bf16) return (int)cudaErrorInvalidValue;
    const DropoutArgs drop{seed, thresh, inv_keep, dropout, row0};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_head_width(dh, [&](auto head) {
        constexpr int DH = decltype(head)::value;
        return train_bwd_bf16<DH>(q_u, q_rot, k, v, k_std, lengths, d_out, stats, delta, dq_u, dq_rot, dk, dv, B, T,
                                  H, D, scale, drop, st);
    });
}

// The fp32 backward: delta = rowsum(dO out), the dk/dv kernel (writes dS),
// then the dq kernel (reads it). out: the forward's (B, T, H, dh) output;
// delta: (B, H, T) fp32 scratch; ds: (B, H, T, ld) fp32 scratch, ld a multiple
// of 64 and at least T (every visited key tile is written whole, so it needs
// no zeroing); the other tensors as in the forward.
ASR_API int asr_rel_attention_train_bwd_fp32(const void* q_u, const void* q_rot, const void* k, const void* v,
                                             const void* k_std, const void* lengths, const void* out,
                                             const void* d_out, const void* stats, void* delta, void* ds,
                                             void* dq_u, void* dq_rot, void* dk, void* dv, int B, int T, int H,
                                             int dh, int D, int ld, float scale, unsigned seed, unsigned thresh,
                                             float inv_keep, int dropout, int row0, void* stream) {
    if (D % 16 != 0 || T < 1 || ld % BN != 0 || ld < T) return (int)cudaErrorInvalidValue;
    const DropoutArgs drop{seed, thresh, inv_keep, dropout, row0};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_head_width(dh, [&](auto head) {
        constexpr int DH = decltype(head)::value;
        return bwd<DH>(q_u, q_rot, k, v, k_std, lengths, out, d_out, stats, delta, ds, dq_u, dq_rot, dk, dv, B, T,
                       H, D, ld, scale, drop, st);
    });
}
