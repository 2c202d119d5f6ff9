// Relative-position attention for TRAINING: the bf16 forward kernel.
//
// Replaces ops/pallas_train_attention.py::_fwd_kernel of the JAX package (the
// function, its rounding points and the dropout hash are set out at the head
// of rel_attention_train.cu, which keeps the fp32 forward and the backward):
//
//   S  = ([q_u | q_rot] . [k | k_std]) * scale,  columns >= length := -1e9
//   P  = bf16(softmax(S)),  Pd = keep ? bf16(P * bf16(1 / (1 - rate))) : 0
//   out = Pd v;   stats = (row max, row sum) in fp32 for the backward
//
// What bounds it on the H100: by the roofline, bytes (q_rot, B x T x H x D
// bf16, is read once and nothing quadratic is written: 49 MB, 15 us at B=32,
// T=250). In practice the score product has an inner width of dh + D = 288,
// so the kernel lives or dies by how the tensor cores are fed, and after
// that by the fp32 work on every score (mask, exp, divide, three hash
// rounds), which no tensor core takes.
//
// What the design does about it:
//   * A block owns 128 query rows of one (batch row, head): two consumer
//     warpgroups of 64 rows and one producer thread. [q_u | q_rot] is loaded
//     once (72 KB) and stays; [k | k_std] and v arrive as 64-key tiles through
//     a ring of three stages. Every tile is a TMA load into the swizzled
//     layout wgmma reads, reported to an mbarrier: no thread spends a register
//     or an instruction on a copy, and two tiles are in flight under every
//     product. Rows past the sequence end come back as zeros.
//   * S = Q K^T is 18 wgmma.m64n64k16 steps per warpgroup with both operands
//     in shared memory and the accumulator in registers. Mask, scale, row
//     max and sum, exp, the bf16 rounding, the keep hash and the dropout
//     scale all run on the accumulator fragment (a row lives in the four
//     lanes of a quad: two shuffles per reduction). P goes to the second
//     product as its register A operand (wgmma.m64n32k16, v as the
//     transposed B operand), and O stays in registers until it is written
//     once. Nothing but Q, K and V tiles touches shared memory.
//   * There are two score fragments: the product of the next key tile is
//     started before the fp32 work on this one, so the tensor cores run under
//     the softmax (3 % on the card; the fp32 work, not the products, is what
//     the kernel spends its time on).
//   * Two walks over the keys are kept: P must be rounded before the dropout
//     scale, from the final row max and sum, so the first walk takes (max,
//     sum) and the second the exact P. The second S product costs 9 GFLOP
//     that run under the fp32 work. Holding all of a row block's S in
//     registers for T <= 256 would save only that product, so it is not done.
#include "attention_common.cuh"
#include "hopper.cuh"

namespace attn {

namespace {

using namespace hopper;

constexpr int BQ = 128;    // query rows of a block
constexpr int BKEY = 64;   // key rows of a tile
constexpr int STAGES = 3;  // key tiles in the ring
constexpr int CW = 64;     // columns of one 128-byte-swizzled chunk of q_rot / k_std
constexpr int N_CONSUMER_WARPS = 8;
constexpr uint32_t QU_BYTES = BQ * DH * 2, QR_CHUNK = BQ * CW * 2;
constexpr uint32_t KU_BYTES = BKEY * DH * 2, KS_CHUNK = BKEY * CW * 2, V_BYTES = BKEY * DH * 2;

// Shared memory past the 1024-byte aligned base, for D = 64 * nc:
//   q_u | q_rot chunks | STAGES x (k | k_std chunks | v) | barriers
__host__ __device__ inline uint32_t stage_bytes(int nc) { return KU_BYTES + nc * KS_CHUNK + V_BYTES; }
__host__ __device__ inline uint32_t smem_bytes(int nc) {
    return 1024 + QU_BYTES + nc * QR_CHUNK + STAGES * stage_bytes(nc) + 8 * (1 + 2 * STAGES);
}

// S (this warpgroup's 64 rows x the stage's 64 keys) = [q_u | q_rot] . [k | k_std]^T
// Started and committed as one group; the caller waits for it.
__device__ __forceinline__ void start_scores(float (&s)[32], uint32_t qu, uint32_t qr,
                                             uint32_t stage, int nc) {
    fence_regs(s);
    wgmma_fence();
    const uint64_t a_u = make_desc(qu, 16, 512, SWIZZLE_64);
    const uint64_t b_u = make_desc(stage, 16, 512, SWIZZLE_64);
    wgmma_m64n64k16_ss(s, a_u, b_u, 0);
    wgmma_m64n64k16_ss(s, a_u + 2, b_u + 2, 1);
    for (int c = 0; c < nc; ++c) {
        const uint64_t a_r = make_desc(qr + c * QR_CHUNK, 16, 1024, SWIZZLE_128);
        const uint64_t b_r = make_desc(stage + KU_BYTES + c * KS_CHUNK, 16, 1024, SWIZZLE_128);
#pragma unroll
        for (int kk = 0; kk < CW / 16; ++kk) wgmma_m64n64k16_ss(s, a_r + 2 * kk, b_r + 2 * kk, 1);
    }
    wgmma_commit();
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(384, 1)
train_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_qu,
                      const __grid_constant__ CUtensorMap map_qrot,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_kstd,
                      const int* __restrict__ lengths, bf16* __restrict__ out,
                      float* __restrict__ stats, int B, int T, int H, int D, float scale,
                      DropoutArgs drop) {
    extern __shared__ unsigned char smem_raw[];
    const int nc = D / CW;
    const uint32_t qu = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t qr = qu + QU_BYTES;
    const uint32_t ring = qr + nc * QR_CHUNK;
    const uint32_t stage_sz = stage_bytes(nc);
    const uint32_t q_full = ring + STAGES * stage_sz;
    const uint32_t full = q_full + 8, empty = full + 8 * STAGES;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, N_CONSUMER_WARPS);
        }
        mbar_init_fence();
    }
    __syncthreads();

    const int t0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int len = lengths[b];
    const int n_keys = visited_keys(len, T);
    const int wg = threadIdx.x / 128;

    if (wg == 2) {
        // producer: one thread keeps the ring full, walk after walk
        if (threadIdx.x != 256) return;
        mbar_arrive_expect_tx(q_full, QU_BYTES + nc * QR_CHUNK);
        tma_load_3d(qu, &map_qu, q_full, h * DH, t0, b);
        for (int c = 0; c < nc; ++c) tma_load_3d(qr + c * QR_CHUNK, &map_qrot, q_full, h * D + c * CW, t0, b);
        int it = 0;
        for (int pass = 0; pass < 2; ++pass) {
            for (int s0 = 0; s0 < n_keys; s0 += BKEY, ++it) {
                const int s = it % STAGES;
                const uint32_t stage = ring + s * stage_sz, bar = full + 8 * s;
                mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
                mbar_arrive_expect_tx(bar, KU_BYTES + nc * KS_CHUNK + (pass ? V_BYTES : 0));
                tma_load_3d(stage, &map_k, bar, h * DH, s0, b);
                for (int c = 0; c < nc; ++c)
                    tma_load_2d(stage + KU_BYTES + c * KS_CHUNK, &map_kstd, bar, c * CW, s0);
                if (pass) tma_load_3d(stage + KU_BYTES + nc * KS_CHUNK, &map_v, bar, h * DH, s0, b);
            }
        }
        return;
    }

    // consumers: warpgroup wg owns query rows t0 + 64 * wg .. + 63
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int row = wg * 64 + warp * 16 + lane / 4;  // this thread's rows: row, row + 8
    const int cq = 2 * (lane % 4);                   // and columns 8j + cq, 8j + cq + 1
    const int ta = t0 + row, tb = ta + 8;
    const uint32_t my_qu = qu + wg * (64 * DH * 2), my_qr = qr + wg * (64 * CW * 2);

    mbar_wait(q_full, 0);

    // Both walks are one loop of 2 * n_tiles steps over the ring. The score
    // product of step it + 1 is started before the fp32 work on step it, into
    // the other of two accumulator fragments, so the tensor cores run under
    // the softmax instead of before it.
    const int n_tiles = (n_keys + BKEY - 1) / BKEY, n_steps = 2 * n_tiles;
    float s_even[32], s_odd[32], o[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) s_even[i] = s_odd[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.0f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
    const uint32_t key = dropout_key(drop.seed, b, h, H);
    const float inv_keep_e = round_bf(drop.inv_keep);

    auto start = [&](float (&s)[32], int it) {
        const int st = it % STAGES;
        mbar_wait(full + 8 * st, (it / STAGES) & 1);
        start_scores(s, my_qu, my_qr, ring + st * stage_sz, nc);
    };

    // the fp32 work on step `it`, whose product is the oldest group in flight
    auto consume = [&](float (&s)[32], int it, bool next_in_flight) {
        if (next_in_flight) wgmma_wait<1>(); else wgmma_wait<0>();
        fence_regs(s);
        const int st = it % STAGES;
        const bool second_walk = it >= n_tiles;
        const int s0 = (second_walk ? it - n_tiles : it) * BKEY;
        if (!second_walk) {
            // walk 1: row max and sum over all visited keys
            if (lane == 0) mbar_arrive(empty + 8 * st);
            // (the fragment is only read: a write to it by anything but
            // wgmma would make the compiler serialise the products in flight)
            float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = s0 + 8 * j + cq + e;
                    mx_a = fmaxf(mx_a, masked_score(s[4 * j + e], scale, col, len, T));
                    mx_b = fmaxf(mx_b, masked_score(s[4 * j + 2 + e], scale, col, len, T));
                }
            }
            const float new_a = fmaxf(m_a, quad_max(mx_a)), new_b = fmaxf(m_b, quad_max(mx_b));
            float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = s0 + 8 * j + cq + e;
                    sum_a += expf(masked_score(s[4 * j + e], scale, col, len, T) - new_a);
                    sum_b += expf(masked_score(s[4 * j + 2 + e], scale, col, len, T) - new_b);
                }
            }
            l_a = l_a * expf(m_a - new_a) + quad_sum(sum_a);
            l_b = l_b * expf(m_b - new_b) + quad_sum(sum_b);
            m_a = new_a;
            m_b = new_b;
            if (it == n_tiles - 1 && lane % 4 == 0) {
                const size_t at = ((size_t)b * H + h) * T, n = (size_t)B * H * T;
                if (ta < T) {
                    stats[at + ta] = m_a;
                    stats[n + at + ta] = l_a;
                }
                if (tb < T) {
                    stats[at + tb] = m_b;
                    stats[n + at + tb] = l_b;
                }
            }
            return;
        }
        // walk 2: P = exp(S - m) / l, rounded, dropped; O += Pd v. The S
        // fragment of 16 keys maps onto the A fragment of one k16 step:
        // pd[j / 2][2 * (j % 2)] is row a, [.. + 1] row b of column pair j.
        uint32_t pd[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = s0 + 8 * j + cq + e;
                float p_a = round_bf(expf(masked_score(s[4 * j + e], scale, col, len, T) - m_a) / l_a);
                float p_b = round_bf(expf(masked_score(s[4 * j + 2 + e], scale, col, len, T) - m_b) / l_b);
                if (drop.enabled) {
                    p_a = dropout_keep(key, ta, col, T, drop.thresh) ? round_bf(p_a * inv_keep_e) : 0.0f;
                    p_b = dropout_keep(key, tb, col, T, drop.thresh) ? round_bf(p_b * inv_keep_e) : 0.0f;
                }
                p[e] = p_a;
                p[2 + e] = p_b;
            }
            pd[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
            pd[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
        }
        const uint64_t b_v =
            make_desc(ring + st * stage_sz + KU_BYTES + nc * KS_CHUNK, 16, 512, SWIZZLE_64);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_m64n32k16_rs_bt(o, pd[kk], b_v + kk * (16 * DH * 2 / 16), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty + 8 * st);
    };

    start(s_even, 0);
    for (int it = 0; it < n_steps; it += 2) {  // n_steps is even
        start(s_odd, it + 1);
        consume(s_even, it, true);
        const bool more = it + 2 < n_steps;
        if (more) start(s_even, it + 2);
        consume(s_odd, it + 1, more);
    }

    const size_t hs = (size_t)H * DH;
    bf16* out_a = out + ((size_t)b * T + ta) * hs + (size_t)h * DH + cq;
    bf16* out_b = out_a + 8 * hs;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
        if (ta < T) *reinterpret_cast<uint32_t*>(out_a + 8 * j) = pack_bf16(o[4 * j], o[4 * j + 1]);
        if (tb < T) *reinterpret_cast<uint32_t*>(out_b + 8 * j) = pack_bf16(o[4 * j + 2], o[4 * j + 3]);
    }
}

}  // namespace

int train_fwd_bf16(const void* q_u, const void* q_rot, const void* k, const void* v,
                   const void* k_std, const void* lengths, void* out, void* stats, int B, int T,
                   int H, int D, float scale, DropoutArgs drop, cudaStream_t stream) {
    if (D % CW != 0 || D > 256 || D < CW || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
    const int nc = D / CW;
    // (B, T, H * width) views: coordinates (column, t, b); rows past T read as zeros
    const cuuint64_t dims_h[3] = {(cuuint64_t)H * DH, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides_h[2] = {(cuuint64_t)H * DH * 2, (cuuint64_t)T * H * DH * 2};
    const cuuint64_t dims_r[3] = {(cuuint64_t)H * D, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides_r[2] = {(cuuint64_t)H * D * 2, (cuuint64_t)T * H * D * 2};
    const cuuint64_t dims_s[2] = {(cuuint64_t)D, (cuuint64_t)T};
    const cuuint64_t strides_s[1] = {(cuuint64_t)D * 2};
    const cuuint32_t box_qu[3] = {DH, BQ, 1}, box_qr[3] = {CW, BQ, 1}, box_kv[3] = {DH, BKEY, 1};
    const cuuint32_t box_ks[2] = {CW, BKEY};
    CUtensorMap m_qu, m_qr, m_k, m_v, m_ks;
    cudaError_t err = tensor_map_bf16(&m_qu, q_u, 3, dims_h, strides_h, box_qu, CU_TENSOR_MAP_SWIZZLE_64B);
    if (err == cudaSuccess)
        err = tensor_map_bf16(&m_qr, q_rot, 3, dims_r, strides_r, box_qr, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
        err = tensor_map_bf16(&m_k, k, 3, dims_h, strides_h, box_kv, CU_TENSOR_MAP_SWIZZLE_64B);
    if (err == cudaSuccess)
        err = tensor_map_bf16(&m_v, v, 3, dims_h, strides_h, box_kv, CU_TENSOR_MAP_SWIZZLE_64B);
    if (err == cudaSuccess)
        err = tensor_map_bf16(&m_ks, k_std, 2, dims_s, strides_s, box_ks, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = smem_bytes(nc);
    err = cudaFuncSetAttribute(train_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(T, BQ), H, B);
    train_fwd_bf16_kernel<<<grid, 384, smem, stream>>>(
        m_qu, m_qr, m_k, m_v, m_ks, (const int*)lengths, (bf16*)out, (float*)stats, B, T, H, D,
        scale, drop);
    return (int)cudaGetLastError();
}

}  // namespace attn
