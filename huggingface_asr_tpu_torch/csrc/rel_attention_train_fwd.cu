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
// T=250). In practice the score product has an inner width of dh + D (288 at
// the flagship's widths; head width dh = 32 or 64, a template parameter),
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
//   * S = Q K^T is (dh + D) / 16 wgmma.m64n64k16 steps per warpgroup with both operands
//     in shared memory and the accumulator in registers. Mask, scale, row
//     max and sum, exp, the bf16 rounding, the keep hash and the dropout
//     scale all run on the accumulator fragment (a row lives in the four
//     lanes of a quad: two shuffles per reduction). P goes to the second
//     product as its register A operand (wgmma.m64n{dh}k16, v as the
//     transposed B operand), and O stays in registers until it is written
//     once. Nothing but Q, K and V tiles touches shared memory.
//   * There are two score fragments: the product of the next key tile is
//     started before the fp32 work on this one, so the tensor cores run under
//     the softmax (3 % on the card; the fp32 work, not the products, is what
//     the kernel spends its time on).
//   * The block structure (ring, producer, score product, tensor maps) is
//     attention_wgmma.cuh's, shared with the inference kernel rel_attention.cu.
//   * q_rot past 256 columns (WIDE, up to 512): the query tile stays resident
//     (144 KB at D = 512) and the k_std chunks come through attention_wgmma.cuh's
//     chunk ring; S is then computed to its end before the fp32 work (the two
//     fragments stay, with nothing in flight between them).
//   * Two walks over the keys are kept: P must be rounded before the dropout
//     scale, from the final row max and sum, so the first walk takes (max,
//     sum) and the second the exact P. The second S product costs 9 GFLOP
//     that run under the fp32 work. Holding all of a row block's S in
//     registers for T <= 256 would save only that product, so it is not done.
#include "attention_wgmma.cuh"

namespace attn {

namespace {

using namespace fa;

template <int DH, bool WIDE>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
train_fwd_bf16_kernel(const __grid_constant__ Maps maps, const int* __restrict__ lengths,
                      bf16* __restrict__ out, float* __restrict__ stats, int B, int T, int H, int D,
                      float scale, DropoutArgs drop) {
    extern __shared__ unsigned char smem_raw[];
    const Smem<DH, WIDE> sm(smem_raw, D);
    const int nc = sm.nc;
    init_barriers(sm);

    const int t0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int len = lengths[b];
    const int n_keys = visited_keys(len, T);
    const int wg = threadIdx.x / 128;

    if (wg == 2) {
        // producer: one thread keeps the ring full, walk after walk (v in the second)
        if (threadIdx.x == 256) produce(sm, maps, b, h, t0, D, n_keys, 2, 1);
        return;
    }

    // consumers: warpgroup wg owns query rows t0 + 64 * wg .. + 63
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int row = wg * 64 + warp * 16 + lane / 4;  // this thread's rows: row, row + 8
    const int cq = 2 * (lane % 4);                   // and columns 8j + cq, 8j + cq + 1
    const int ta = t0 + row, tb = ta + 8;
    const uint32_t my_qu = sm.qu + wg * Head<DH>::WG_Q, my_qr = sm.qr + wg * (64 * CW * 2);

    mbar_wait(sm.q_full, 0);

    // Both walks are one loop of 2 * n_tiles steps over the ring. The score
    // product of step it + 1 is started before the fp32 work on step it, into
    // the other of two accumulator fragments, so the tensor cores run under
    // the softmax instead of before it.
    const int n_tiles = (n_keys + BKEY - 1) / BKEY, n_steps = 2 * n_tiles;
    float s_even[32], s_odd[32], o[DH / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) s_even[i] = s_odd[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
    const uint32_t key = dropout_key(drop.seed, drop.row0 + b, h, H);
    const float inv_keep_e = round_bf(drop.inv_keep);

    wide::Cursor cur;  // WIDE: this consumer's place in the k_std chunk ring
    auto start = [&](float (&s)[32], int it) {
        mbar_wait(sm.full_bar(it), (it / STAGES) & 1);
        if constexpr (WIDE) wide_scores<DH>(s, my_qu, my_qr, sm.stage(it), sm, cur, lane);
        else start_scores<DH>(s, my_qu, my_qr, sm.stage(it), nc);
    };

    // the fp32 work on step `it`, whose product is the oldest group in flight
    // (WIDE: done already)
    auto consume = [&](float (&s)[32], int it, bool next_in_flight) {
        if constexpr (!WIDE) {
            if (next_in_flight) wgmma_wait<1>(); else wgmma_wait<0>();
            fence_regs(s);
        }
        const bool second_walk = it >= n_tiles;
        const int s0 = (second_walk ? it - n_tiles : it) * BKEY;
        if (!second_walk) {
            // walk 1: row max and sum over all visited keys
            if (lane == 0) mbar_arrive(sm.empty_bar(it));
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
            pack_p(pd, j, p[0], p[1], p[2], p[3]);
        }
        add_pv<DH>(o, pd, sm.v_tile(it));
        if (lane == 0) mbar_arrive(sm.empty_bar(it));
    };

    start(s_even, 0);
    for (int it = 0; it < n_steps; it += 2) {  // n_steps is even
        start(s_odd, it + 1);
        consume(s_even, it, true);
        const bool more = it + 2 < n_steps;
        if (more) start(s_even, it + 2);
        consume(s_odd, it + 1, more);
    }

    store_o<DH>(o, 1.0f, 1.0f, out, (size_t)H * DH, b, T, ta, h, cq);
}

}  // namespace

template <int DH>
int train_fwd_bf16(const void* q_u, const void* q_rot, const void* k, const void* v,
                   const void* k_std, const void* lengths, void* out, void* stats, int B, int T,
                   int H, int D, float scale, DropoutArgs drop, cudaStream_t stream) {
    if (!fa::supported<DH>(B, H, D)) return (int)cudaErrorInvalidValue;
    fa::Maps maps;
    cudaError_t err = fa::make_maps<DH>(&maps, q_u, q_rot, k, v, k_std, B, T, H, D, H * DH);
    auto kernel = fa::wide_path(D) ? train_fwd_bf16_kernel<DH, true> : train_fwd_bf16_kernel<DH, false>;
    if (err == cudaSuccess) err = fa::allow_smem<DH>(kernel, D);
    if (err != cudaSuccess) return (int)err;
    kernel<<<fa::grid(B, T, H), BLOCK_THREADS, fa::block_smem<DH>(D), stream>>>(
        maps, (const int*)lengths, (bf16*)out, (float*)stats, B, T, H, D, scale, drop);
    return (int)cudaGetLastError();
}

#define INSTANTIATE(DH)                                                                              \
    template int train_fwd_bf16<DH>(const void*, const void*, const void*, const void*, const void*, \
                                    const void*, void*, void*, int, int, int, int, float, DropoutArgs, \
                                    cudaStream_t);
INSTANTIATE(32)
INSTANTIATE(64)
#undef INSTANTIATE

}  // namespace attn
