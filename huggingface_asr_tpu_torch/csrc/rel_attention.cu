// Relative-position attention for INFERENCE, factored form (flash style, one
// walk with an online softmax).
//
// Replaces the attention branch of ops/pallas_layer.py::_layer_kernel of the
// JAX package. q_u, k, v are (B, T, H, dh) with one shared row stride (they
// may be column views of the layer's (B*T, 3D) projection buffer), q_rot is
// (B, T, H, D), k_std (T, D), lengths (B,):
//
//   s[t, s'] = [q_u | q_rot][t] . [k | k_std][s']      (one dot of width dh+D)
//            + (s' < len ? 0 : -1e9)                     (finite: a zero-length
//                                                          row stays finite)
//   out[t]   = sum_s' bf16(exp2(s - m)) v[s'] / sum_s' exp2(s - m)
//
// Under the serving profile (SERVING, pallas_layer.py's SOFTMAX_Z_MODE "mxu")
// the normaliser is sum_s' bf16(exp2(s - m)): the running row sum adds the
// same bf16-rounded probabilities that enter P.V (read back from their packed
// pairs), rescaled online as the fp32 sum is; the output is still divided
// once, at the end.
//
// Head width dh = 32 or 64 (a template parameter; a head of another size is
// padded with zero columns in the folded weights, kernels/layer.py), q_rot
// width D in whole 64-column chunks (padded there too), at most 512: past 256
// the k_std chunks come through a ring of their own (WIDE, attention_wgmma.cuh's
// namespace wide) and S is a synchronous product of 1 + D / 64 groups.
//
// The 1/sqrt(dh) and log2(e) scales are folded into the query weights
// (kernels/layer.py::fold_layer_weights), so the softmax runs on exp2 and is
// normalised after P.V, as on the TPU.
//
// What bounds it on the H100: by the roofline, bytes (q_rot is read once and
// nothing quadratic is written). In practice the score product's inner width
// of dh + D = 288 against dh = 32 output columns (flagship; 64 + 192 against
// 64 at the 176-wide configs' padded widths): most of the arithmetic is S, so the kernel lives by how the tensor cores are fed.
//
// What the design does about it:
//   * The block structure of the training forward (attention_wgmma.cuh): 128
//     query rows of one (b, h), two consumer warpgroups, one producer thread;
//     [q_u | q_rot] loaded once by TMA, [k | k_std | v] tiles of 64 keys
//     through an mbarrier ring of three stages; S is (dh + D) / 16 wgmma.m64n64k16 steps
//     out of swizzled shared memory into registers. The tensor maps take the
//     projection buffer's row stride, so no copy is made of q_u, k or v.
//   * One walk. The running max and sum of a row pair live in registers;
//     mask, max, exp2 and the bf16 rounding run on the accumulator fragment
//     (about ten operations a score), P is the register A operand of the
//     P.V product, O stays in registers, is rescaled by exp2(m_old - m_new)
//     there and written once, divided by the row sum.
//   * A warpgroup takes its tiles one after another (product, softmax, P.V)
//     and the two warpgroups fill each other's gaps. Starting the next
//     tile's product before this tile's softmax, into a second fragment, as
//     the training forward does, was 12 % slower here (B=128, T_pad=256):
//     O is rescaled between two products, and the compiler then serialises
//     every wgmma of a loop that keeps a product in flight across that write.
//   * Key tiles past an utterance's length are skipped (their probabilities
//     are exact zeros); a zero-length row attends uniformly over all T keys,
//     as the TPU kernel's -1e9 additive mask gives. Columns past T in a
//     ragged last tile (TMA returns zeros there) get weight 0.
#include "attention_wgmma.cuh"

using namespace attn;
using namespace attn::fa;

namespace {

// Score of key column `col` as the softmax sees it.
__device__ __forceinline__ float masked(float raw, int col, int len, int T) {
    if (col >= T) return -INFINITY;
    return col < len ? raw : raw + MASK_NEG;
}

template <int DH, bool WIDE, bool SERVING>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
rel_attention_kernel(const __grid_constant__ Maps maps, const int* __restrict__ lengths,
                     bf16* __restrict__ out, int ld_o, int T, int H, int D) {
    extern __shared__ unsigned char smem_raw[];
    const Smem<DH, WIDE> sm(smem_raw, D);
    const int nc = sm.nc;
    init_barriers(sm);

    const int t0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int len = lengths[b];
    const int n_keys = visited_keys(len, T);
    const int wg = threadIdx.x / 128;

    if (wg == 2) {
        // producer: one thread keeps the ring full; v rides in every stage
        if (threadIdx.x == 256) produce(sm, maps, b, h, t0, D, n_keys, 1, 0);
        return;
    }

    // consumers: warpgroup wg owns query rows t0 + 64 * wg .. + 63
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int row = wg * 64 + warp * 16 + lane / 4;  // this thread's rows: row, row + 8
    const int cq = 2 * (lane % 4);                   // and columns 8j + cq, 8j + cq + 1
    const uint32_t my_qu = sm.qu + wg * Head<DH>::WG_Q, my_qr = sm.qr + wg * (64 * CW * 2);

    const int n_tiles = (n_keys + BKEY - 1) / BKEY;
    const int n_clear = min(len, T);  // columns below it carry no mask
    float s[32], o[DH / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
    // running max (the same in the four lanes of a quad) and this lane's part
    // of the running sum, for rows a (row) and b (row + 8)
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

    wide::Cursor cur;  // WIDE: this consumer's place in the k_std chunk ring
    mbar_wait(sm.q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(sm.full_bar(it), (it / STAGES) & 1);
        if constexpr (WIDE) {
            wide_scores<DH>(s, my_qu, my_qr, sm.stage(it), sm, cur, lane);
        } else {
            start_scores<DH>(s, my_qu, my_qr, sm.stage(it), nc);
            wgmma_wait<0>();
            fence_regs(s);
        }
        const int s0 = it * BKEY;
        const bool edge = s0 + BKEY > n_clear;  // a tile with masked or absent columns
        float mx_a = -INFINITY, mx_b = -INFINITY;
        if (edge) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = s0 + 8 * j + cq + e;
                    s[4 * j + e] = masked(s[4 * j + e], col, len, T);
                    s[4 * j + 2 + e] = masked(s[4 * j + 2 + e], col, len, T);
                }
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
            mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        // every visited tile has a column below T, so the new max is finite
        const float new_a = fmaxf(m_a, quad_max(mx_a)), new_b = fmaxf(m_b, quad_max(mx_b));
        const float alpha_a = exp2f(m_a - new_a), alpha_b = exp2f(m_b - new_b);
        m_a = new_a;
        m_b = new_b;
        float sum_a = 0.0f, sum_b = 0.0f;
        uint32_t pd[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float a0 = exp2f(s[4 * j] - new_a), a1 = exp2f(s[4 * j + 1] - new_a);
            const float b0 = exp2f(s[4 * j + 2] - new_b), b1 = exp2f(s[4 * j + 3] - new_b);
            pack_p(pd, j, a0, a1, b0, b1);
            if constexpr (SERVING) {
                const uint32_t pa = pd[j / 2][2 * (j % 2)], pb = pd[j / 2][2 * (j % 2) + 1];
                sum_a += bf16_lo(pa) + bf16_hi(pa);
                sum_b += bf16_lo(pb) + bf16_hi(pb);
            } else {
                sum_a += a0 + a1;
                sum_b += b0 + b1;
            }
        }
        l_a = l_a * alpha_a + sum_a;
        l_b = l_b * alpha_b + sum_b;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
            o[4 * j] *= alpha_a;
            o[4 * j + 1] *= alpha_a;
            o[4 * j + 2] *= alpha_b;
            o[4 * j + 3] *= alpha_b;
        }
        add_pv<DH>(o, pd, sm.v_tile(it));
        if (lane == 0) mbar_arrive(sm.empty_bar(it));
    }

    store_o<DH>(o, 1.0f / quad_sum(l_a), 1.0f / quad_sum(l_b), out, (size_t)ld_o, b, T, t0 + row, h, cq);
}

}  // namespace

ASR_API int asr_rel_attention(const void* q_u, const void* k, const void* v, const void* q_rot,
                              const void* k_std, const void* lengths, void* out, int B, int T,
                              int H, int dh, int D, int ld_qkv, int ld_o, int serving, void* stream) {
    return with_head_width(dh, [&](auto head) {
        constexpr int DH = decltype(head)::value;
        if (T < 1 || !supported<DH>(B, H, D) || ld_qkv % 8 != 0 || ld_qkv < H * DH || ld_o % 2 != 0)
            return static_cast<int>(cudaErrorInvalidValue);
        Maps maps;
        cudaError_t err = make_maps<DH>(&maps, q_u, q_rot, k, v, k_std, B, T, H, D, ld_qkv);
        auto kernel = wide_path(D) ? (serving ? rel_attention_kernel<DH, true, true> : rel_attention_kernel<DH, true, false>)
                                   : (serving ? rel_attention_kernel<DH, false, true> : rel_attention_kernel<DH, false, false>);
        if (err == cudaSuccess) err = allow_smem<DH>(kernel, D);
        if (err != cudaSuccess) return static_cast<int>(err);
        kernel<<<grid(B, T, H), BLOCK_THREADS, block_smem<DH>(D), static_cast<cudaStream_t>(stream)>>>(
            maps, static_cast<const int*>(lengths), static_cast<bf16*>(out), ld_o, T, H, D);
        return static_cast<int>(cudaGetLastError());
    });
}
