// E-Branchformer layer pieces: the row-major GEMM entry, LayerNorm and the
// positional-query kernel.
//
// Replaces ops/pallas_layer.py::_layer_kernel (via ebranchformer_layer). The
// TPU kernel keeps one whole layer resident in VMEM; Hopper has 227 KB of
// shared memory per block, so the layer is split into a few kernels (see
// kernels/layer.py for the order): GEMMs with fused epilogues (gemm.cuh, on
// wgmma + TMA),
// LayerNorm (here), the positional query (here), the rel-pos attention
// forward (rel_attention.cu) and the two depthwise convs (dwconv.cu).
//
// LayerNorm: a row reduction over D <= 1024 values, memory-bound. One warp
// per row reads the row once for both moments (flax's fast variance
// E[x^2] - mu^2, clipped at 0, as pallas_layer.py::_ln; common.cuh's ln_*
// steps) and writes bf16 once. It runs each layer's final LayerNorm; the four
// whose output only feeds a GEMM run in that GEMM's prologue (gemm_ln.cu),
// with the same operations in the same order.
//
// Positional query (pallas_layer.py:489-499): per (row, head) ce|co = q_v_h @
// [wp_e | wp_o][h] (K = the head width, 32 or 64 with the fold's zero pad)
// and the rotation [cos*ce + sin*co, cos*co - sin*ce] at frame row % T,
// rounded once to bf16. What bounds it on the H100: writing q_rot, H x D_rot
// bf16 values a row (134 MB at B=128 x 10 s against 17 MB of q_v read; the
// product is 4.3 GFLOP, 4 us of bf16 tensor-core time). The design:
//   * a block is one warpgroup that stays on its SM, owns one head and walks
//     64-row tiles blockIdx.x, blockIdx.x + gridDim.x, ...; the head's
//     weights, (D_rot, HW) K-major as the fold stores them, arrive once (one
//     TMA box, two past 256 rows), and the q_v tiles (the QKV GEMM's second output, read in
//     place through its row stride) through two stages, so that the next
//     tile's load runs under this one's products and stores;
//   * per 32 columns of each half, two wgmma products (m64n32, K = HW) fill
//     ce and co of the same columns, so each thread holds the pairs it
//     rotates. The fold stores the weight rows of each 32 columns in the
//     order that puts columns 8q .. 8q + 7 in the fragment of lane q of a quad
//     (kernels/layer.py::pos_weights), so a thread reads cos / sin of its two
//     rows' frames as one 16-byte piece each (the tables are L2-resident, 64 KB
//     each at T = 256; the loads are issued under the products) and writes
//     each half's 8 rotated bf16 values as one 16-byte store: a row's 32
//     columns of a half leave as 64 contiguous bytes, with no trade of values
//     between lanes;
//   * rows past M are the TMA's zeros and are not written. The pad columns
//     (the 176-wide configs' q_rot 176 -> 192) come out as zeros from the
//     fold's zero weights and tables.
#include "gemm.cuh"

ASR_API const char* asr_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

ASR_API int asr_gemm_bf16(const void* a, const void* b, const void* bias, const void* bias2,
                          void* out, void* out2, const void* res,
                          int M, int N, int K, int lda, int ldb, int ldo, int ldo2, int ldr,
                          int n2, int act, int round_first, float alpha, void* stream) {
    gemm::Epilogue e;
    e.bias = static_cast<const float*>(bias);
    e.bias2 = static_cast<const float*>(bias2);
    e.out = static_cast<bf16*>(out);
    e.out2 = static_cast<bf16*>(out2);
    e.res = static_cast<const bf16*>(res);
    e.ldo = ldo;
    e.ldo2 = ldo2;
    e.ldr = ldr;
    e.n2 = n2;
    e.alpha = alpha;
    e.act = act;
    e.round_first = round_first;
    e.gate = 0;
    return gemm::launch(static_cast<const bf16*>(a), lda, static_cast<const bf16*>(b), ldb, M, N, K, e,
                        static_cast<cudaStream_t>(stream));
}

// The gate epilogue (gemm.cuh): out = bf16(xr * bf16(act(bf16(a @ b + bias)))),
// xr [M, ldx] bf16 read in place (K1's CSGU linear, x_r a column view of
// channel_proj1's output).
ASR_API int asr_gemm_gate_bf16(const void* a, const void* b, const void* bias, void* out, const void* xr,
                               int M, int N, int K, int lda, int ldb, int ldo, int ldx, int act, void* stream) {
    gemm::Epilogue e;
    e.bias = static_cast<const float*>(bias);
    e.bias2 = nullptr;
    e.out = static_cast<bf16*>(out);
    e.out2 = nullptr;
    e.res = static_cast<const bf16*>(xr);
    e.ldo = ldo;
    e.ldo2 = 0;
    e.ldr = ldx;
    e.n2 = 0;
    e.alpha = 1.0f;
    e.act = act;
    e.round_first = 0;
    e.gate = 1;
    if (xr == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return gemm::launch(static_cast<const bf16*>(a), lda, static_cast<const bf16*>(b), ldb, M, N, K, e,
                        static_cast<cudaStream_t>(stream));
}

constexpr int LN_ROWS = 8;  // rows (warps) per block

__global__ void __launch_bounds__(32 * LN_ROWS)
layernorm_kernel(const bf16* __restrict__ x, int ldx, const float* __restrict__ g,
                 const float* __restrict__ b, bf16* __restrict__ y, int ldy, int M, int D,
                 float eps) {
    const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= M) return;
    const bf16* xr = x + (size_t)row * ldx;
    float s = 0.0f, ss = 0.0f, mu, r;
    for (int c = lane; c < D; c += 32) ln_accumulate(to_f(xr[c]), s, ss);
    ln_finish(warp_sum(s), warp_sum(ss), D, eps, mu, r);
    bf16* yr = y + (size_t)row * ldy;
    for (int c = lane; c < D; c += 32) yr[c] = to_bf(ln_apply(to_f(xr[c]), mu, r, g[c], b[c]));
}

ASR_API int asr_layernorm_bf16(const void* x, const void* g, const void* b, void* y, int M,
                               int D, int ldx, int ldy, float eps, void* stream) {
    layernorm_kernel<<<ceil_div(M, LN_ROWS), 32 * LN_ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), ldx, static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<bf16*>(y), ldy, M, D, eps);
    return cudaGetLastError();
}

namespace pq {

using namespace hopper;

constexpr int ROWS = 64;           // rows of a tile: one warpgroup's
constexpr int BLOCKS_PER_SM = 4;   // blocks of a head walk the tiles; this many fit an SM
constexpr int MAX_D = 512;         // q_rot width
constexpr int BOX_ROWS = 256;      // the most rows a TMA box holds

// Shared-memory layout of a block for head width HW (32 or 64: one row of HW
// bf16 values is one 64- or 128-byte swizzle row).
template <int HW>
struct Layout {
    static constexpr uint64_t SWIZZLE = HW == 32 ? SWIZZLE_64 : SWIZZLE_128;
    static constexpr CUtensorMapSwizzle MAP_SWIZZLE = HW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    static constexpr uint32_t SBO = 8 * HW * 2;          // bytes of 8 rows
    static constexpr uint32_t Q_BYTES = ROWS * HW * 2;   // a q_v tile
    // the head's D weight rows, then two q_v stages and three barriers
    static __host__ __device__ uint32_t w_bytes(int D) { return ((uint32_t)D * HW * 2 + 1023u) & ~1023u; }
    static uint32_t smem_bytes(int D) { return 1024 + w_bytes(D) + 2 * Q_BYTES + 3 * 8; }
};

// The weight rows of a head arrive as this many TMA boxes of D / boxes rows.
__host__ __device__ inline int weight_boxes(int D) { return (D + BOX_ROWS - 1) / BOX_ROWS; }

__device__ __forceinline__ float rot_even(float c, float s, float ce, float co) {
    return __fadd_rn(__fmul_rn(c, ce), __fmul_rn(s, co));  // cos*ce + sin*co, the plain version's roundings
}
__device__ __forceinline__ float rot_odd(float c, float s, float ce, float co) {
    return __fsub_rn(__fmul_rn(c, co), __fmul_rn(s, ce));  // cos*co - sin*ce
}

// q_map: q_v as (H * HW, M) boxes {HW, 64}; w_map: wp as (HW, H * D) boxes
// {HW, D / weight_boxes(D)}, row n < D/2 of head h holding column n of
// wp_e[h], row D/2 + n column n of wp_o[h] (within each 32 columns in the
// order pos_weights gives them); rot_cos / rot_sin: (T, D/2); q_rot: (M, H, D).
template <int HW>
__global__ void __launch_bounds__(128, BLOCKS_PER_SM)
pos_query_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap w_map,
                 const bf16* __restrict__ rot_cos, const bf16* __restrict__ rot_sin, bf16* __restrict__ q_rot,
                 int M, int T, int H, int D) {
    using L = Layout<HW>;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t w_tile = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t q_tiles = w_tile + L::w_bytes(D), w_full = q_tiles + 2 * L::Q_BYTES, full = w_full + 8;
    const int h = blockIdx.y, half = D / 2, tiles = (M + ROWS - 1) / ROWS;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, q = lane % 4;
    if (threadIdx.x == 0) {
        mbar_init(w_full, 1);
        mbar_init(full, 1);
        mbar_init(full + 8, 1);
        mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const int rows = D / weight_boxes(D);
        mbar_arrive_expect_tx(w_full, (uint32_t)D * HW * 2);
        for (int i = 0; i < weight_boxes(D); ++i)
            tma_load_2d(w_tile + i * rows * HW * 2, &w_map, w_full, 0, h * D + i * rows);
        for (int s = 0; s < 2; ++s) {
            const int t = blockIdx.x + s * gridDim.x;
            if (t < tiles) {
                mbar_arrive_expect_tx(full + 8 * s, L::Q_BYTES);
                tma_load_2d(q_tiles + s * L::Q_BYTES, &q_map, full + 8 * s, h * HW, t * ROWS);
            }
        }
    }
    mbar_wait(w_full, 0);
    float ce[16], co[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) ce[i] = co[i] = 0.0f;
    for (int i = 0; blockIdx.x + i * gridDim.x < tiles; ++i) {
        const int t = blockIdx.x + i * gridDim.x, s = i & 1;
        const uint32_t q_tile = q_tiles + s * L::Q_BYTES;
        mbar_wait(full + 8 * s, (i >> 1) & 1);
        const uint64_t a = make_desc(q_tile, 16, L::SBO, L::SWIZZLE);
        const int m_a = t * ROWS + warp * 16 + lane / 4, m_b = m_a + 8;
        const uint4* cos_a = reinterpret_cast<const uint4*>(rot_cos + (size_t)(m_a % T) * half + 8 * q);
        const uint4* sin_a = reinterpret_cast<const uint4*>(rot_sin + (size_t)(m_a % T) * half + 8 * q);
        const uint4* cos_b = reinterpret_cast<const uint4*>(rot_cos + (size_t)(m_b % T) * half + 8 * q);
        const uint4* sin_b = reinterpret_cast<const uint4*>(rot_sin + (size_t)(m_b % T) * half + 8 * q);
        uint4* out_a = reinterpret_cast<uint4*>(q_rot + ((size_t)m_a * H + h) * D + 8 * q);
        uint4* out_b = reinterpret_cast<uint4*>(q_rot + ((size_t)m_b * H + h) * D + 8 * q);
        for (int c = 0; c < half / 32; ++c) {
            // ce and co of columns 32c .. 32c + 31: weight rows 32c.. and D/2 + 32c..
            const uint64_t be = make_desc(w_tile + 32 * c * HW * 2, 16, L::SBO, L::SWIZZLE);
            const uint64_t bo = make_desc(w_tile + (half + 32 * c) * HW * 2, 16, L::SBO, L::SWIZZLE);
            fence_regs(ce);
            fence_regs(co);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HW / 16; ++kk) {
                wgmma_m64n32k16_ss(ce, a + 2 * kk, be + 2 * kk, kk);
                wgmma_m64n32k16_ss(co, a + 2 * kk, bo + 2 * kk, kk);
            }
            wgmma_commit();
            // the tables' columns 32c + 8q .. + 7 of both rows, under the products
            const uint4 ca = __ldg(cos_a + 4 * c), sa = __ldg(sin_a + 4 * c);
            const uint4 cb = __ldg(cos_b + 4 * c), sb = __ldg(sin_b + 4 * c);
            wgmma_wait<0>();
            fence_regs(ce);
            fence_regs(co);
            if (c == half / 32 - 1) {
                // every product that reads this stage is done: it takes the tile after next
                named_barrier(1, 128);
                const int t2 = t + 2 * gridDim.x;
                if (threadIdx.x == 0 && t2 < tiles) {
                    mbar_arrive_expect_tx(full + 8 * s, L::Q_BYTES);
                    tma_load_2d(q_tile, &q_map, full + 8 * s, h * HW, t2 * ROWS);
                }
            }
            // fragment group j holds columns 32c + 8q + 2j, + 1 of rows a (ce[4j], ce[4j + 1]) and
            // b (ce[4j + 2], ce[4j + 3]); word j of a table piece the same two columns
            const uint32_t wca[4] = {ca.x, ca.y, ca.z, ca.w}, wsa[4] = {sa.x, sa.y, sa.z, sa.w};
            const uint32_t wcb[4] = {cb.x, cb.y, cb.z, cb.w}, wsb[4] = {sb.x, sb.y, sb.z, sb.w};
            uint32_t ea[4], eb[4], oa[4], ob[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                ea[j] = pack_bf16(rot_even(bf16_lo(wca[j]), bf16_lo(wsa[j]), ce[4 * j], co[4 * j]),
                                  rot_even(bf16_hi(wca[j]), bf16_hi(wsa[j]), ce[4 * j + 1], co[4 * j + 1]));
                oa[j] = pack_bf16(rot_odd(bf16_lo(wca[j]), bf16_lo(wsa[j]), ce[4 * j], co[4 * j]),
                                  rot_odd(bf16_hi(wca[j]), bf16_hi(wsa[j]), ce[4 * j + 1], co[4 * j + 1]));
                eb[j] = pack_bf16(rot_even(bf16_lo(wcb[j]), bf16_lo(wsb[j]), ce[4 * j + 2], co[4 * j + 2]),
                                  rot_even(bf16_hi(wcb[j]), bf16_hi(wsb[j]), ce[4 * j + 3], co[4 * j + 3]));
                ob[j] = pack_bf16(rot_odd(bf16_lo(wcb[j]), bf16_lo(wsb[j]), ce[4 * j + 2], co[4 * j + 2]),
                                  rot_odd(bf16_hi(wcb[j]), bf16_hi(wsb[j]), ce[4 * j + 3], co[4 * j + 3]));
            }
            if (m_a < M) {
                out_a[4 * c] = make_uint4(ea[0], ea[1], ea[2], ea[3]);
                out_a[(half + 32 * c) / 8] = make_uint4(oa[0], oa[1], oa[2], oa[3]);
            }
            if (m_b < M) {
                out_b[4 * c] = make_uint4(eb[0], eb[1], eb[2], eb[3]);
                out_b[(half + 32 * c) / 8] = make_uint4(ob[0], ob[1], ob[2], ob[3]);
            }
        }
    }
}

template <int HW>
cudaError_t launch(const bf16* q_v, int ldq, const bf16* wp, const bf16* rot_cos, const bf16* rot_sin,
                   bf16* q_rot, int M, int T, int H, int D, cudaStream_t stream) {
    using L = Layout<HW>;
    static bool ready = false;  // the attribute is set once per instantiation, for the widest q_rot
    if (!ready) {
        cudaError_t err = cudaFuncSetAttribute(pos_query_kernel<HW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)L::smem_bytes(MAX_D));
        if (err != cudaSuccess) return err;
        ready = true;
    }
    CUtensorMap q_map, w_map;
    const cuuint64_t q_dims[2] = {(cuuint64_t)H * HW, (cuuint64_t)M}, q_strides[1] = {(cuuint64_t)ldq * 2};
    const cuuint64_t w_dims[2] = {(cuuint64_t)HW, (cuuint64_t)H * D}, w_strides[1] = {(cuuint64_t)HW * 2};
    const cuuint32_t q_box[2] = {HW, ROWS}, w_box[2] = {HW, (cuuint32_t)(D / weight_boxes(D))};
    cudaError_t err = tensor_map_bf16(&q_map, q_v, 2, q_dims, q_strides, q_box, L::MAP_SWIZZLE);
    if (err == cudaSuccess) err = tensor_map_bf16(&w_map, wp, 2, w_dims, w_strides, w_box, L::MAP_SWIZZLE);
    if (err != cudaSuccess) return err;
    const int tiles = ceil_div(M, ROWS), per_head = ceil_div(BLOCKS_PER_SM * gemm::SMS, H);
    dim3 grid(tiles < per_head ? tiles : per_head, H);
    pos_query_kernel<HW><<<grid, 128, L::smem_bytes(D), stream>>>(q_map, w_map, rot_cos, rot_sin, q_rot, M, T, H, D);
    return cudaGetLastError();
}

}  // namespace pq

// q_v: [M, ldq] bf16 (head h at columns h*hw); wp: [H, D, hw] bf16 (K-major:
// row n < D/2 is column n of wp_e[h], row D/2 + n column n of wp_o[h]);
// rot_cos/rot_sin: [T, D/2] bf16; q_rot: [M, H, D] bf16. Row m is frame m % T.
// Takes hw in {32, 64}, D a multiple of 64 up to 512, ldq % 8 == 0, H <= 65535.
ASR_API int asr_pos_query(const void* q_v, const void* wp, const void* rot_cos, const void* rot_sin,
                          void* q_rot, int M, int T, int H, int hw, int D, int ldq, void* stream) {
    if (M < 1 || T < 1 || H < 1 || H > 65535 || D % 64 || D > pq::MAX_D || ldq % 8 || ldq < H * hw)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* qv = static_cast<const bf16*>(q_v);
    const auto* w = static_cast<const bf16*>(wp);
    const auto* c = static_cast<const bf16*>(rot_cos);
    const auto* sn = static_cast<const bf16*>(rot_sin);
    auto* out = static_cast<bf16*>(q_rot);
    auto st = static_cast<cudaStream_t>(stream);
    if (hw == 32) return pq::launch<32>(qv, ldq, w, c, sn, out, M, T, H, D, st);
    if (hw == 64) return pq::launch<64>(qv, ldq, w, c, sn, out, M, T, H, D, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
