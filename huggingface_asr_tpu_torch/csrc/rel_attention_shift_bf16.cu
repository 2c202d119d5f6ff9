// Relative-position attention for INFERENCE, shift form: the bf16 kernel.
//
// Replaces ops/pallas_attention.py::_rel_attn_kernel of the JAX package (the
// function is set out at the head of rel_attention_shift.cu, which keeps the
// fp32 kernel):
//
//   S[t, s] = (q_u[t] . k[s] + q_v[t] . pos[t - s + T - 1, h]) / sqrt(dh)
//   S[:, s >= length] := -1e9;  P = bf16(softmax(S));  out = P v
//
// What bounds it on the H100: by the roofline, bytes (five (B, T, H, dh)
// tensors once each; the table is small and cached). Both products have an
// inner width of only dh (32, or 64 padded), so the tensor cores have little to do; what
// costs is the positional term's skew: the score of (t, s) needs
// G[t][t - s + const] of G = q_v band^T, which the accumulator fragment
// holds in another lane than S[t][s].
//
// What the design does about it:
//   * A block owns 128 query rows of one (b, h): two consumer warpgroups of
//     64 rows and one producer thread, as the other attention kernels on
//     wgmma (attention_wgmma.cuh). q_u and q_v are loaded once. Per 64-key
//     tile the ring carries k, the band of the table and, in the second
//     walk, v. The band is one TMA box of 192 rows of this head's table,
//     rows t0 - s0 - 63 + T - 1 onwards: warpgroup w reads rows 64w .. 64w +
//     127 of it. Table rows outside [0, 2T - 1) come back as zeros and belong
//     only to (t, s) pairs with t >= T or s >= T, which are masked or never
//     written.
//   * S = q_u k^T (m64n64k16 x 2) and G = q_v band^T (m64n128k16 x 2) land
//     in registers. Each thread stores its G values to shared memory at the
//     skewed place, row r, column r + 63 - j (where that lies in [0, 64)),
//     and reads the positional scores back in the layout its S fragment
//     has. A warp owns the same 16 rows in both layouts, so the exchange
//     needs no barrier beyond __syncwarp; rows are 72 floats apart, which
//     makes the 8-byte reads conflict-free and the scattered 4-byte stores
//     two-way at worst. 18 KB per warpgroup.
//   * Two walks, because P is rounded from the final max and sum. Each
//     masked score and each expf is computed once per walk; the running sum
//     stays per lane until the walk ends.
#include "attention_wgmma.cuh"

namespace attn {

namespace {

constexpr int BAND = 192;  // table rows a block needs for one key tile (191 used)
constexpr int GLD = 72;    // floats between rows of the skew buffer
constexpr uint32_t G_BYTES = BQ * GLD * 4;

// Shared memory of head width DH: q_u | q_v | STAGES x (k | band | v) | skew buffer | barriers.
template <int DH>
struct Layout {
    static constexpr uint32_t QH = Head<DH>::Q_BYTES, KH = Head<DH>::K_BYTES;
    static constexpr uint32_t BAND_BYTES = BAND * DH * 2;
    static constexpr uint32_t STAGE_BYTES = KH + BAND_BYTES + KH;
    static constexpr uint32_t SMEM_BYTES = 1024 + 2 * QH + STAGES * STAGE_BYTES + G_BYTES + 8 * (1 + 2 * STAGES);
    static_assert(SMEM_BYTES <= MAX_SMEM, "the shift kernel's tiles fit a block's shared memory");
};

struct ShiftMaps {
    CUtensorMap qu, qv, k, v, pos;
};

template <int DH>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
shift_bf16_kernel(const __grid_constant__ ShiftMaps maps, const int* __restrict__ lengths,
                  bf16* __restrict__ out, int T, int H, float scale) {
    using L = Layout<DH>;
    constexpr uint32_t QH_BYTES = L::QH, KH_BYTES = L::KH, BAND_BYTES = L::BAND_BYTES, STAGE_BYTES = L::STAGE_BYTES;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = smem_u32(smem_raw);
    const uint32_t qu = (base + 1023u) & ~1023u;
    const uint32_t qv = qu + QH_BYTES;
    const uint32_t ring = qv + QH_BYTES;
    const uint32_t gs = ring + STAGES * STAGE_BYTES;
    const uint32_t q_full = gs + G_BYTES;
    const uint32_t full = q_full + 8, empty = full + 8 * STAGES;

    init_block_barriers(q_full, full, empty);

    const int t0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int len = lengths[b];
    const int n_keys = visited_keys(len, T);
    const int n_tiles = (n_keys + BKEY - 1) / BKEY;
    const int wg = threadIdx.x / 128;

    if (wg == 2) {
        // producer: one thread keeps the ring full, walk after walk
        if (threadIdx.x != 256) return;
        mbar_arrive_expect_tx(q_full, 2 * QH_BYTES);
        tma_load_3d(qu, &maps.qu, q_full, h * DH, t0, b);
        tma_load_3d(qv, &maps.qv, q_full, h * DH, t0, b);
        for (int it = 0; it < 2 * n_tiles; ++it) {
            const bool with_v = it >= n_tiles;
            const int s0 = (with_v ? it - n_tiles : it) * BKEY;
            const int st = it % STAGES;
            const uint32_t stage = ring + st * STAGE_BYTES, bar = full + 8 * st;
            mbar_wait(empty + 8 * st, ((it / STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(bar, KH_BYTES + BAND_BYTES + (with_v ? KH_BYTES : 0));
            tma_load_3d(stage, &maps.k, bar, h * DH, s0, b);
            // band row j is table row (t0 - s0 - 63 + T - 1) + j of head h
            tma_load_2d(stage + KH_BYTES, &maps.pos, bar, h * DH, t0 - s0 - (BKEY - 1) + T - 1);
            if (with_v) tma_load_3d(stage + KH_BYTES + BAND_BYTES, &maps.v, bar, h * DH, s0, b);
        }
        return;
    }

    // consumers: warpgroup wg owns query rows t0 + 64 * wg .. + 63
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int rl = lane / 4;             // this thread's rows within its warp's 16: rl, rl + 8
    const int r_wg = warp * 16 + rl;     // within the warpgroup's 64
    const int cq = 2 * (lane % 4);       // its columns: 8j + cq, 8j + cq + 1
    const int ta = t0 + wg * 64 + r_wg;
    // this warp's 16 rows of the skew buffer
    float* g_rows = reinterpret_cast<float*>(smem_raw + (gs - base)) + (size_t)((wg * 4 + warp) * 16) * GLD;
    float* g_a = g_rows + rl * GLD;
    float* g_b = g_a + 8 * GLD;

    float s[32], g[64], o[DH / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) g[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

    mbar_wait(q_full, 0);
    const uint64_t a_u = head_desc<DH>(qu + wg * Head<DH>::WG_Q);
    const uint64_t a_v = head_desc<DH>(qv + wg * Head<DH>::WG_Q);

    // s := the scaled, masked scores of ring step `it` (this thread's part)
    auto scores = [&](int it, int s0) {
        const uint32_t stage = ring + (it % STAGES) * STAGE_BYTES;
        mbar_wait(full + 8 * (it % STAGES), (it / STAGES) & 1);
        const uint64_t b_k = head_desc<DH>(stage);
        const uint64_t b_band = head_desc<DH>(stage + KH_BYTES + wg * (64 * DH * 2));
        fence_regs(s);
        fence_regs(g);
        wgmma_fence();
        head_product<DH>(s, a_u, b_k, 0);
        head_product<DH>(g, a_v, b_band, 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(g);
        // G[r][j] is the positional score of column c = r + 63 - j
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int c_a = r_wg + 63 - (8 * jj + cq + e), c_b = c_a + 8;
                if (c_a >= 0 && c_a < BKEY) g_a[c_a] = g[4 * jj + e];
                if (c_b >= 0 && c_b < BKEY) g_b[c_b] = g[4 * jj + 2 + e];
            }
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float2 p_a = *reinterpret_cast<const float2*>(g_a + 8 * j + cq);
            const float2 p_b = *reinterpret_cast<const float2*>(g_b + 8 * j + cq);
            const int col = s0 + 8 * j + cq;
            s[4 * j] = masked_score(s[4 * j] + p_a.x, scale, col, len, T);
            s[4 * j + 1] = masked_score(s[4 * j + 1] + p_a.y, scale, col + 1, len, T);
            s[4 * j + 2] = masked_score(s[4 * j + 2] + p_b.x, scale, col, len, T);
            s[4 * j + 3] = masked_score(s[4 * j + 3] + p_b.y, scale, col + 1, len, T);
        }
        __syncwarp();  // the rows are free for the next tile's stores
    };

    // walk 1: row max and sum over all visited keys
    for (int it = 0; it < n_tiles; ++it) {
        scores(it, it * BKEY);
        if (lane == 0) mbar_arrive(empty + 8 * (it % STAGES));
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
            mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        // every visited tile has a column below T, so the new max is finite
        const float new_a = fmaxf(m_a, quad_max(mx_a)), new_b = fmaxf(m_b, quad_max(mx_b));
        float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            sum_a += expf(s[4 * j] - new_a) + expf(s[4 * j + 1] - new_a);
            sum_b += expf(s[4 * j + 2] - new_b) + expf(s[4 * j + 3] - new_b);
        }
        l_a = l_a * expf(m_a - new_a) + sum_a;
        l_b = l_b * expf(m_b - new_b) + sum_b;
        m_a = new_a;
        m_b = new_b;
    }
    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);

    // walk 2: P = exp(S - m) / l rounded to bf16; O += P v
    for (int it = n_tiles; it < 2 * n_tiles; ++it) {
        scores(it, (it - n_tiles) * BKEY);
        uint32_t pd[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            pack_p(pd, j, expf(s[4 * j] - m_a) / l_a, expf(s[4 * j + 1] - m_a) / l_a,
                   expf(s[4 * j + 2] - m_b) / l_b, expf(s[4 * j + 3] - m_b) / l_b);
        add_pv<DH>(o, pd, ring + (it % STAGES) * STAGE_BYTES + KH_BYTES + BAND_BYTES);
        if (lane == 0) mbar_arrive(empty + 8 * (it % STAGES));
    }

    store_o<DH>(o, 1.0f, 1.0f, out, (size_t)H * DH, b, T, ta, h, cq);
}

}  // namespace

template <int DH>
int shift_fwd_bf16(const void* q_u, const void* q_v, const void* k, const void* v, const void* pos,
                   const void* lengths, void* out, int B, int T, int H, float scale,
                   cudaStream_t stream) {
    if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
    // (B, T, H * DH) tensors: coordinates (column, t, b); the table (2T - 1, H * DH):
    // (column, row). Rows outside a tensor read as zeros.
    const cuuint64_t dims_h[3] = {(cuuint64_t)H * DH, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides_h[2] = {(cuuint64_t)H * DH * 2, (cuuint64_t)T * H * DH * 2};
    const cuuint64_t dims_p[2] = {(cuuint64_t)H * DH, (cuuint64_t)(2 * T - 1)};
    const cuuint64_t strides_p[1] = {(cuuint64_t)H * DH * 2};
    const cuuint32_t box_q[3] = {DH, BQ, 1}, box_kv[3] = {DH, BKEY, 1}, box_band[2] = {DH, BAND};
    constexpr CUtensorMapSwizzle SW = Head<DH>::MAP_SWIZZLE;
    ShiftMaps maps;
    cudaError_t err = tensor_map_bf16(&maps.qu, q_u, 3, dims_h, strides_h, box_q, SW);
    if (err == cudaSuccess) err = tensor_map_bf16(&maps.qv, q_v, 3, dims_h, strides_h, box_q, SW);
    if (err == cudaSuccess) err = tensor_map_bf16(&maps.k, k, 3, dims_h, strides_h, box_kv, SW);
    if (err == cudaSuccess) err = tensor_map_bf16(&maps.v, v, 3, dims_h, strides_h, box_kv, SW);
    if (err == cudaSuccess) err = tensor_map_bf16(&maps.pos, pos, 2, dims_p, strides_p, box_band, SW);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(shift_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)Layout<DH>::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(T, BQ), H, B);
    shift_bf16_kernel<DH><<<grid, BLOCK_THREADS, Layout<DH>::SMEM_BYTES, stream>>>(
        maps, (const int*)lengths, (bf16*)out, T, H, scale);
    return (int)cudaGetLastError();
}

#define INSTANTIATE(DH)                                                                                         \
    template int shift_fwd_bf16<DH>(const void*, const void*, const void*, const void*, const void*, const void*, \
                                    void*, int, int, int, float, cudaStream_t);
INSTANTIATE(32)
INSTANTIATE(64)
#undef INSTANTIATE

}  // namespace attn
