// bf16 x bf16 -> fp32-accumulated GEMM with a fused epilogue, on wgmma + TMA.
//
// Replaces the `_mm` / `jnp.dot(..., preferred_element_type=f32)` products
// inside the TPU kernels ops/pallas_layer.py::_layer_kernel (FF1/FF2 in and
// out, Q/K/V, output projection, cgMLP proj1/proj2, merge_proj) and
// ops/pallas_subsample.py::_subsample_kernel (out-dense, projection; conv2,
// the one compute-bound product, has its own kernel in conv2.cu).
//
// What bounds it on the H100: bytes. The products are skinny (K = 256..1024,
// 5120 once; N = 256..1024) over many rows (M = B x T_pad, 32,768 at B=128 x
// 10 s): FF1-in reads 17 MB and writes 67 MB for 17 GFLOP, so a call lives by
// how A and the output move, not by the tensor cores; and with K = 256 a tile's
// epilogue (35 instructions a value with GELU) takes longer than its
// products. 110 calls per request.
//
// What the design does about it:
//   * A (M, K) row-major and the weight (K, N) row-major arrive as TMA boxes
//     of 64 k-values in the 128-byte-swizzled layout wgmma reads (the weight as
//     the transposed B operand, so it keeps its layout), through a ring of
//     stages under full/empty mbarriers filled by one producer thread: no
//     thread computes an address and the loads of the next k-steps run under
//     the products of this one. Rows past M and columns past K or N are the
//     TMA's out-of-range zeros (K and N need only be multiples of 8: the
//     176-wide configs end in edge tiles at K = 176 and N = 176). The
//     accumulator stays in registers.
//   * Two kernels, chosen in launch() from (M, N). Large (gemm_kernel_pingpong,
//     128 x 128 tiles): one block per SM that stays there and takes tiles
//     blockIdx.x, blockIdx.x + gridDim.x, ...; the producer streams the k-steps
//     of all of them through a ring of six 32 KB stages without a pause at a
//     tile's end; two teams of two consumer warpgroups (64 rows each) take the
//     tiles in turn, so that one team's epilogue runs under the other's
//     products and under the loads of the tiles after them, and sixteen warps
//     share the epilogue's latency. Small (gemm_kernel, 64 x 64 tiles, one
//     consumer warpgroup, ring of four 16 KB stages, several blocks per SM)
//     when the large tiles would not fill the card's 132 SMs once. With column
//     tiles fastest in the tile order an A tile is fetched from device memory
//     once and re-read by its other column tiles from L2.
//   * The epilogue runs on the accumulator fragment: bias, rounding,
//     activation and rounding in the fragment's own layout; then the four
//     lanes of a quad trade their packed pairs (quad_transpose) so that each
//     holds 8 consecutive columns, reads the residual as one 16-byte load and
//     writes one 16-byte store: a row of the tile leaves in 64-byte pieces.
//     Rows >= M and columns >= N are never written, so `out` may be a column
//     slice of a wider buffer. No fp32 tile passes through shared memory.
//     It is straight-line code: the activation is a template parameter (a
//     switch per value kept the 64 chains of a thread apart), GELU is
//     evaluated on eight values at a time without a branch (gelu8, and
//     gelu_serving8 under the serving profile), the
//     tile's biases wait in shared memory from before the first product, and
//     a thread's residual loads are all issued before the first is used.
//
// Rounding points (one numeric contract, the TPU kernels'):
//   round_first = 0 (K1's `_mm`):        v = bf16(acc + bias)
//   round_first = 1 (K2's conv/dense):   v = bf16(bf16(acc) + bias)
//   then, if act:      v = bf16(act(v))   (act ACT_GELU_SERVING: the serving
//                      profile's GELU, common.cuh::gelu_serving8, eight at a time)
//   then, if residual: v = bf16(res + alpha * v)
//   or, if gate:       v = bf16(res * v)   (K1's CSGU linear: res is x_r)
//   dual output (Q):   out2 = bf16(acc + bias2) for columns < n2
//
// The LayerNorm prologue (gemm_ln_kernel and gemm_ln_small_kernel, entry
// asr_gemm_ln_bf16 in gemm_ln.cu; the end of this file): the GEMM of
// bf16(LN(x)) with x the raw rows, on the two tiles' products and epilogue,
// with a row tile of the A operand held whole in shared memory.
//
// The gate epilogue (asr_gemm_gate_bf16 in layer.cu) finishes the CSGU of a
// model with csgu_use_linear_after_conv (pallas_layer.py:578-583): the
// product is the linear over the conv output, the activation the CSGU's, and
// `res` the first half of channel_proj1's output (x_r, read in place through
// its row stride). It takes the residual's loads and replaces its sum by a
// product; nothing else of the epilogue changes.
#pragma once

#include "hopper.cuh"

namespace gemm {

using namespace hopper;

constexpr int BK = 64;  // k-values of a stage: one 128-byte-swizzled row
constexpr int SMS = 132;  // the card's SMs

struct Epilogue {
    const float* bias;   // [N] or null
    const float* bias2;  // [n2] or null
    bf16* out;           // [M, ldo]
    bf16* out2;          // [M, ldo2] or null
    const bf16* res;     // [M, ldr] or null: the residual, or (gate) the gate's other factor
    int ldo, ldo2, ldr, n2;
    float alpha;
    int act;
    int round_first;
    int gate;            // 1: v = bf16(res * v) in place of the residual's sum
};

struct Maps {
    CUtensorMap a, b;  // A as (k, m) boxes {64, BM}; the weight as (n, k) boxes {64, 64}
};

// The small tile's shape: NWG x 64 rows and BN columns; STAGES ring stages; BLOCKS per SM.
template <int NWG_, int BN_, int STAGES_, int BLOCKS_>
struct Tile {
    static constexpr int NWG = NWG_, BM = 64 * NWG_, BN = BN_, STAGES = STAGES_, BLOCKS = BLOCKS_;
    static constexpr int THREADS = 128 * NWG_ + 32;  // the consumers and the producer's warp
    static constexpr uint32_t A_BYTES = BM * BK * 2, B_BOX = BK * 64 * 2, B_BYTES = B_BOX * (BN / 64);
    static constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
    static constexpr uint32_t SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 8 * 2 * STAGES + 2 * BN * 4;
};
using Small = Tile<1, 64, 4, 3>;

// The large tile: 128 x 128 per team of two consumer warpgroups, two teams
// taking turns in a block that stays on its SM, and a producer warpgroup whose
// registers go to the consumers (64 accumulators and the epilogue's values).
struct Large {
    static constexpr int BM = 128, BN = 128, STAGES = 6, THREADS = 640;
    static constexpr int CONSUMER_REGS = 112, PRODUCER_REGS = 32;  // 128 * (4 * 112 + 32) = 640 * 96
    static constexpr uint32_t A_BYTES = BM * BK * 2, B_BOX = BK * 64 * 2, B_BYTES = B_BOX * (BN / 64);
    static constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
    static constexpr uint32_t SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 2) + 2 * 2 * BN * 4;
};

__device__ __forceinline__ void product(float (&acc)[64], uint64_t a, uint64_t b) {
    wgmma_m64n128k16_ss_bt(acc, a, b, 1);
}
__device__ __forceinline__ void product(float (&acc)[32], uint64_t a, uint64_t b) {
    wgmma_m64n64k16_ss_bt(acc, a, b, 1);
}

// GELU (erf form) of eight values at once, stage by stage, so that eight
// independent chains are in flight and no branch parts them: Phi(x) =
// 1/2 erfc(-x / sqrt 2) with erfc(z) = t exp(-z^2 + P(t)), t = 1 / (1 + z / 2)
// for z >= 0 (Numerical Recipes' erfcc, relative error < 1.2e-7 also in the
// tail; erfcf costs twice the instructions and branches), the exponential as
// ex2 with log2(e) and the factor 1/2 folded into P's coefficients.
__device__ __forceinline__ void gelu8(float (&x)[8]) {
    constexpr float L = 1.4426950408889634f;  // log2(e)
    constexpr float C[10] = {0.17087277f * L, -0.82215223f * L, 1.48851587f * L, -1.13520398f * L,
                             0.27886807f * L, -0.18628806f * L, 0.09678418f * L, 0.37409196f * L,
                             1.00002368f * L, -1.26551223f * L - 1.0f};
    float a[8], t[8], p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = fabsf(x[i]) * 0.70710678118654752f;
#pragma unroll
    for (int i = 0; i < 8; ++i) asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t[i]) : "f"(fmaf(0.5f, a[i], 1.0f)));
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = C[0];
#pragma unroll
    for (int c = 1; c < 10; ++c) {
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = fmaf(p[i], t[i], C[c]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = fmaf(-a[i] * a[i], L, p[i]);
#pragma unroll
    for (int i = 0; i < 8; ++i) asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p[i]) : "f"(p[i]));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const float h = t[i] * p[i];  // Phi(-|x|)
        x[i] *= x[i] <= 0.0f ? h : 1.0f - h;
    }
}

// The epilogue on one accumulator fragment of 64 rows x BN columns whose first
// row is m_top and first column n0: this thread's rows m_a, m_a + 8 and, of
// every 8-column group j, columns 2q, 2q + 1. Straight-line code (the
// activation is a template parameter, round_first a select), so that the
// chains of the 64 values overlap. Every thread of the warpgroup calls it.
template <int BN, int ACT>
__device__ __forceinline__ void epilogue(float (&acc)[BN / 2], int m_top, int n0, const float* bias_s,
                                         const float* bias2_s, bool dual, int M, int N, const Epilogue& e) {
    constexpr int NG = BN / 8;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int q = lane % 4;
    const int m_a = m_top + warp * 16 + lane / 4, m_b = m_a + 8;
    const int n_mine = n0 + 8 * q;  // after a trade of groups j0 .. j0 + 3: columns n_mine + 8 j0 .. + 7
    if (dual) {
#pragma unroll
        for (int j0 = 0; j0 < NG; j0 += 4) {
            uint32_t xa[4], xb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int j = j0 + i;
                const float2 b2 = *reinterpret_cast<const float2*>(bias2_s + 8 * j + 2 * q);
                xa[i] = pack_bf16(acc[4 * j] + b2.x, acc[4 * j + 1] + b2.y);
                xb[i] = pack_bf16(acc[4 * j + 2] + b2.x, acc[4 * j + 3] + b2.y);
            }
            quad_transpose(xa, q);
            quad_transpose(xb, q);
            const int n = n_mine + 8 * j0;
            if (n < e.n2) {
                if (m_a < M)
                    *reinterpret_cast<uint4*>(e.out2 + (size_t)m_a * e.ldo2 + n) = make_uint4(xa[0], xa[1], xa[2], xa[3]);
                if (m_b < M)
                    *reinterpret_cast<uint4*>(e.out2 + (size_t)m_b * e.ldo2 + n) = make_uint4(xb[0], xb[1], xb[2], xb[3]);
            }
        }
    }
    // Every rounding is the one a bf16 pair's pack does (the conversion unit
    // is the scarce one here: one conversion per two values and rounding point).
    if (e.round_first) {
#pragma unroll
        for (int i = 0; i < BN / 2; i += 2) {
            const uint32_t r = pack_bf16(acc[i], acc[i + 1]);
            acc[i] = bf16_lo(r);
            acc[i + 1] = bf16_hi(r);
        }
    }
    uint32_t va[NG], vb[NG];  // the chain's rounded values, packed: rows a and b of group j
#pragma unroll
    for (int j = 0; j < NG; ++j) {
        const float2 bias = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * q);
        va[j] = pack_bf16(acc[4 * j] + bias.x, acc[4 * j + 1] + bias.y);
        vb[j] = pack_bf16(acc[4 * j + 2] + bias.x, acc[4 * j + 3] + bias.y);
        if (ACT != ACT_IDENTITY && ACT != ACT_GELU && ACT != ACT_GELU_SERVING) {
            va[j] = pack_bf16(apply_act(ACT, bf16_lo(va[j])), apply_act(ACT, bf16_hi(va[j])));
            vb[j] = pack_bf16(apply_act(ACT, bf16_lo(vb[j])), apply_act(ACT, bf16_hi(vb[j])));
        }
    }
    if (ACT == ACT_GELU || ACT == ACT_GELU_SERVING) {
#pragma unroll
        for (int j = 0; j < NG; j += 2) {
            float x[8] = {bf16_lo(va[j]), bf16_hi(va[j]), bf16_lo(vb[j]), bf16_hi(vb[j]),
                          bf16_lo(va[j + 1]), bf16_hi(va[j + 1]), bf16_lo(vb[j + 1]), bf16_hi(vb[j + 1])};
            if constexpr (ACT == ACT_GELU) gelu8(x);
            else gelu_serving8(x);
            va[j] = pack_bf16(x[0], x[1]);
            vb[j] = pack_bf16(x[2], x[3]);
            va[j + 1] = pack_bf16(x[4], x[5]);
            vb[j + 1] = pack_bf16(x[6], x[7]);
        }
    }
#pragma unroll
    for (int j0 = 0; j0 < NG; j0 += 4) {
        uint32_t ta[4] = {va[j0], va[j0 + 1], va[j0 + 2], va[j0 + 3]};
        uint32_t tb[4] = {vb[j0], vb[j0 + 1], vb[j0 + 2], vb[j0 + 3]};
        quad_transpose(ta, q);
        quad_transpose(tb, q);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            va[j0 + c] = ta[c];
            vb[j0 + c] = tb[c];
        }
    }
    // now va[j0 .. j0 + 3] are columns n_mine + 8 j0 .. + 7 of row a
    if (e.res != nullptr) {
        // all of the thread's residual loads first, then the sums
        uint4 ra[NG / 4], rb[NG / 4];
#pragma unroll
        for (int g = 0; g < NG / 4; ++g) {
            const int n = n_mine + 32 * g;
            ra[g] = rb[g] = make_uint4(0u, 0u, 0u, 0u);
            if (n < N && m_a < M) ra[g] = *reinterpret_cast<const uint4*>(e.res + (size_t)m_a * e.ldr + n);
            if (n < N && m_b < M) rb[g] = *reinterpret_cast<const uint4*>(e.res + (size_t)m_b * e.ldr + n);
        }
        if (e.gate) {
#pragma unroll
            for (int g = 0; g < NG / 4; ++g) {
                const uint32_t wa[4] = {ra[g].x, ra[g].y, ra[g].z, ra[g].w}, wb[4] = {rb[g].x, rb[g].y, rb[g].z, rb[g].w};
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const uint32_t a = va[4 * g + c], b = vb[4 * g + c];
                    va[4 * g + c] = pack_bf16(bf16_lo(wa[c]) * bf16_lo(a), bf16_hi(wa[c]) * bf16_hi(a));
                    vb[4 * g + c] = pack_bf16(bf16_lo(wb[c]) * bf16_lo(b), bf16_hi(wb[c]) * bf16_hi(b));
                }
            }
        } else {
#pragma unroll
            for (int g = 0; g < NG / 4; ++g) {
                const uint32_t wa[4] = {ra[g].x, ra[g].y, ra[g].z, ra[g].w}, wb[4] = {rb[g].x, rb[g].y, rb[g].z, rb[g].w};
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const uint32_t a = va[4 * g + c], b = vb[4 * g + c];
                    va[4 * g + c] = pack_bf16(bf16_lo(wa[c]) + e.alpha * bf16_lo(a), bf16_hi(wa[c]) + e.alpha * bf16_hi(a));
                    vb[4 * g + c] = pack_bf16(bf16_lo(wb[c]) + e.alpha * bf16_lo(b), bf16_hi(wb[c]) + e.alpha * bf16_hi(b));
                }
            }
        }
    }
#pragma unroll
    for (int g = 0; g < NG / 4; ++g) {
        const int n = n_mine + 32 * g;
        if (n < N) {
            if (m_a < M)
                *reinterpret_cast<uint4*>(e.out + (size_t)m_a * e.ldo + n) =
                    make_uint4(va[4 * g], va[4 * g + 1], va[4 * g + 2], va[4 * g + 3]);
            if (m_b < M)
                *reinterpret_cast<uint4*>(e.out + (size_t)m_b * e.ldo + n) =
                    make_uint4(vb[4 * g], vb[4 * g + 1], vb[4 * g + 2], vb[4 * g + 3]);
        }
    }
}

template <class T, int ACT>
__global__ void __launch_bounds__(T::THREADS, T::BLOCKS)
gemm_kernel(const __grid_constant__ Maps maps, int M, int N, int K, Epilogue e) {
    constexpr int NWG = T::NWG, BN = T::BN, STAGES = T::STAGES;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t full = ring + STAGES * T::STAGE_BYTES, empty = full + 8 * STAGES;
    // the tile's columns of bias and bias2, past the barriers
    float* bias_s = reinterpret_cast<float*>(smem_raw + (empty + 8 * STAGES - smem_u32(smem_raw)));
    float* bias2_s = bias_s + BN;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 4 * NWG);
        }
        mbar_init_fence();
    }
    __syncthreads();

    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T::BM;
    const int k_steps = (K + BK - 1) / BK;
    const int wg = threadIdx.x / 128;
    if (wg == NWG) {
        // ---- producer: one thread, 1 + BN / 64 TMA boxes per k-step
        if (threadIdx.x != 128 * NWG) return;
        for (int ks = 0; ks < k_steps; ++ks) {
            const int s = ks % STAGES;
            const uint32_t a_st = ring + s * T::STAGE_BYTES, b_st = a_st + T::A_BYTES, bar = full + 8 * s;
            mbar_wait(empty + 8 * s, ((ks / STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(bar, T::STAGE_BYTES);
            tma_load_2d(a_st, &maps.a, bar, ks * BK, m0);
#pragma unroll
            for (int j = 0; j < BN / 64; ++j) tma_load_2d(b_st + j * T::B_BOX, &maps.b, bar, n0 + 64 * j, ks * BK);
        }
        return;
    }

    // ---- consumer warpgroups: tile rows 64 * wg .. + 63, all BN columns
    const int lane = threadIdx.x % 32;
    const bool dual = e.out2 != nullptr && n0 < e.n2;  // this column tile also writes out2
    if (threadIdx.x < BN) {
        // the biases' trip from device memory runs under the first loads
        const int n = n0 + threadIdx.x;
        bias_s[threadIdx.x] = e.bias != nullptr && n < N ? e.bias[n] : 0.0f;
        bias2_s[threadIdx.x] = dual && n < e.n2 ? e.bias2[n] : 0.0f;
    }
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    fence_regs(acc);
    for (int ks = 0; ks < k_steps; ++ks) {
        const int s = ks % STAGES;
        const uint32_t a_st = ring + s * T::STAGE_BYTES, b_st = a_st + T::A_BYTES;
        mbar_wait(full + 8 * s, (ks / STAGES) & 1);
        const uint64_t a_desc = make_desc(a_st + wg * (64 * 128), 16, 1024, SWIZZLE_128);
        const uint64_t b_desc = make_desc(b_st, T::B_BOX, 1024, SWIZZLE_128);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) product(acc, a_desc + 2 * kk, b_desc + kk * (16 * 128 / 16));
        wgmma_commit();
        if (ks > 0) {
            // the previous step's products are done: hand its stage back
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(empty + 8 * ((ks - 1) % STAGES));
        }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    named_barrier(1, 128 * NWG);  // the biases are in place

    epilogue<BN, ACT>(acc, m0 + wg * 64, n0, bias_s, bias2_s, dual, M, N, e);
}

// Column tile of the output tile numbered t (row tile t / tiles_n): the
// columns are taken in an order that turns by one from row tile to row tile,
// so that a block, whose tiles are gridDim.x apart, meets every column tile
// in turn and not (when tiles_n divides gridDim.x) one alone: the column tiles
// that also write the second output cost more than the others.
__device__ __forceinline__ int tile_column(int t, int tiles_n) {
    return (t % tiles_n + t / tiles_n) % tiles_n;
}

// The large tile's kernel. The block stays on its SM and takes output tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... (column tiles fastest, so that the
// blocks running together share their A rows in L2). The producer streams the
// k-steps of all of them through one ring without a pause at a tile's end; the
// two teams of consumer warpgroups take the tiles in turn, warpgroup wg % 2 of
// a team the tile's rows 64 (wg % 2) .. + 63: while one team runs its epilogue
// the other's products keep the tensor cores and the loads busy.
template <int ACT>
__global__ void __launch_bounds__(Large::THREADS, 1)
gemm_kernel_pingpong(const __grid_constant__ Maps maps, int M, int N, int K, Epilogue e) {
    using T = Large;
    constexpr int BN = T::BN, STAGES = T::STAGES;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t full = ring + STAGES * T::STAGE_BYTES, empty = full + 8 * STAGES, turn = empty + 8 * STAGES;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 8);  // the eight warps of the team whose tile the stage holds
        }
        mbar_init(turn, 8);  // team 0 may start its next main loop: the eight warps of team 1 say so
        mbar_init(turn + 8, 8);
        mbar_init_fence();
    }
    __syncthreads();

    const int tiles_n = (N + BN - 1) / BN, tiles = tiles_n * ((M + T::BM - 1) / T::BM);
    const int k_steps = (K + BK - 1) / BK;
    const int wg = threadIdx.x / 128;
    if (wg == 4) {
        // ---- producer: one thread, three TMA boxes per k-step, tile after tile
        setmaxnreg_dec<T::PRODUCER_REGS>();
        if (threadIdx.x != 512) return;
        int g = 0;  // k-steps loaded so far
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
            const int m0 = (t / tiles_n) * T::BM, n0 = tile_column(t, tiles_n) * BN;
            for (int ks = 0; ks < k_steps; ++ks, ++g) {
                const int s = g % STAGES;
                const uint32_t a_st = ring + s * T::STAGE_BYTES, b_st = a_st + T::A_BYTES, bar = full + 8 * s;
                mbar_wait(empty + 8 * s, ((g / STAGES) & 1) ^ 1);
                mbar_arrive_expect_tx(bar, T::STAGE_BYTES);
                tma_load_2d(a_st, &maps.a, bar, ks * BK, m0);
#pragma unroll
                for (int j = 0; j < BN / 64; ++j) tma_load_2d(b_st + j * T::B_BOX, &maps.b, bar, n0 + 64 * j, ks * BK);
            }
        }
        return;
    }
    setmaxnreg_inc<T::CONSUMER_REGS>();

    // ---- consumer team wg / 2: the block's tiles number team, team + 2, ...;
    // its warpgroup wg % 2 has rows 64 (wg % 2) .. + 63 of each
    const int lane = threadIdx.x % 32, team = wg / 2, tid = threadIdx.x % 256;
    // this team's columns of bias and bias2, past the barriers
    float* bias_s = reinterpret_cast<float*>(smem_raw + (turn + 16 - smem_u32(smem_raw))) + team * 2 * BN;
    float* bias2_s = bias_s + BN;
    for (int i = team; blockIdx.x + i * gridDim.x < tiles; i += 2) {
        const int t = blockIdx.x + i * gridDim.x;
        const int m0 = (t / tiles_n) * T::BM, n0 = tile_column(t, tiles_n) * BN;
        const bool dual = e.out2 != nullptr && n0 < e.n2;  // this column tile also writes out2
        named_barrier(1 + team, 256);  // the last tile's epilogue has read its biases
        if (tid < BN) {
            const int n = n0 + tid;
            bias_s[tid] = e.bias != nullptr && n < N ? e.bias[n] : 0.0f;
            bias2_s[tid] = dual && n < e.n2 ? e.bias2[n] : 0.0f;
        }
        float acc[BN / 2];
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
        fence_regs(acc);
        // The main loops take turns in the tiles' order: a team that waited
        // for a stage more than one round of the ring ahead would mistake an
        // earlier filling of it for its own.
        if (team == 1) mbar_wait(turn + 8, (i / 2) & 1);
        else if (i > 0) mbar_wait(turn, (i / 2 - 1) & 1);
        const int g0 = i * k_steps;
        for (int ks = 0; ks < k_steps; ++ks) {
            const int g = g0 + ks, s = g % STAGES;
            const uint32_t a_st = ring + s * T::STAGE_BYTES, b_st = a_st + T::A_BYTES;
            mbar_wait(full + 8 * s, (g / STAGES) & 1);
            const uint64_t a_desc = make_desc(a_st + (wg % 2) * (64 * 128), 16, 1024, SWIZZLE_128);
            const uint64_t b_desc = make_desc(b_st, T::B_BOX, 1024, SWIZZLE_128);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) product(acc, a_desc + 2 * kk, b_desc + kk * (16 * 128 / 16));
            wgmma_commit();
            if (ks > 0) {
                // the previous step's products are done: hand its stage back
                wgmma_wait<1>();
                if (lane == 0) mbar_arrive(empty + 8 * ((g - 1) % STAGES));
            }
        }
        if (lane == 0) mbar_arrive(turn + 8 * (1 - team));  // every stage of this tile has been waited for
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * ((g0 + k_steps - 1) % STAGES));
        fence_regs(acc);
        named_barrier(1 + team, 256);  // the biases are in place
        epilogue<BN, ACT>(acc, m0 + 64 * (wg % 2), n0, bias_s, bias2_s, dual, M, N, e);
    }
}

template <int ACT>
cudaError_t launch_kernel(Small, const Maps& maps, int M, int N, int K, const Epilogue& e, cudaStream_t stream) {
    using T = Small;
    static bool ready = false;  // the attribute is set once per activation
    if (!ready) {
        cudaError_t err = cudaFuncSetAttribute(gemm_kernel<T, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)T::SMEM_BYTES);
        if (err != cudaSuccess) return err;
        ready = true;
    }
    dim3 grid(ceil_div(N, T::BN), ceil_div(M, T::BM));
    gemm_kernel<T, ACT><<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(maps, M, N, K, e);
    return cudaGetLastError();
}

template <int ACT>
cudaError_t launch_kernel(Large, const Maps& maps, int M, int N, int K, const Epilogue& e, cudaStream_t stream) {
    using T = Large;
    static bool ready = false;  // the attribute and the check below are made once per activation
    if (!ready) {
        cudaError_t err = cudaFuncSetAttribute(gemm_kernel_pingpong<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)T::SMEM_BYTES);
        if (err != cudaSuccess) return err;
        // A consumer that waits for registers the block was never given would
        // hang, not trap: refuse unless the launch allocates what they take.
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, gemm_kernel_pingpong<ACT>);
        if (err != cudaSuccess) return err;
        if (attr.numRegs * T::THREADS < 128 * (4 * T::CONSUMER_REGS + T::PRODUCER_REGS))
            return cudaErrorLaunchOutOfResources;
        ready = true;
    }
    const int tiles = ceil_div(N, T::BN) * ceil_div(M, T::BM);
    gemm_kernel_pingpong<ACT><<<tiles < SMS ? tiles : SMS, T::THREADS, T::SMEM_BYTES, stream>>>(maps, M, N, K, e);
    return cudaGetLastError();
}

// The tile's tensor maps, then its kernel for the activation; `norm`: the
// LayerNorm prologue's operands, for its tiles (the end of this file).
template <class T, class... Prologue>
cudaError_t launch_tile(const bf16* A, int lda, const bf16* B, int ldb, int M, int N, int K,
                        const Epilogue& e, cudaStream_t stream, const Prologue&... norm) {
    Maps maps;
    const cuuint64_t dims_a[2] = {(cuuint64_t)K, (cuuint64_t)M}, dims_b[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t stride_a[1] = {(cuuint64_t)lda * 2}, stride_b[1] = {(cuuint64_t)ldb * 2};
    const cuuint32_t box_a[2] = {BK, (cuuint32_t)T::BM}, box_b[2] = {64, BK};
    cudaError_t err = tensor_map_bf16(&maps.a, A, 2, dims_a, stride_a, box_a, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
        err = tensor_map_bf16(&maps.b, B, 2, dims_b, stride_b, box_b, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
    switch (e.act) {
        case ACT_IDENTITY: return launch_kernel<ACT_IDENTITY>(T(), maps, M, N, K, e, norm..., stream);
        case ACT_GELU: return launch_kernel<ACT_GELU>(T(), maps, M, N, K, e, norm..., stream);
        case ACT_GELU_TANH: return launch_kernel<ACT_GELU_TANH>(T(), maps, M, N, K, e, norm..., stream);
        case ACT_RELU: return launch_kernel<ACT_RELU>(T(), maps, M, N, K, e, norm..., stream);
        case ACT_SILU: return launch_kernel<ACT_SILU>(T(), maps, M, N, K, e, norm..., stream);
        case ACT_GELU_SERVING: return launch_kernel<ACT_GELU_SERVING>(T(), maps, M, N, K, e, norm..., stream);
        default: return cudaErrorInvalidValue;
    }
}

// Shape contract checked by the Python wrapper (kernels/layer.py::gemm_contract):
// N % 8 == 0, K % 8 == 0, n2 a multiple of 8, every row stride a multiple of
// 8 elements and every base pointer 16-byte aligned (TMA boxes and 16-byte
// stores). Edge tiles need nothing more: the maps carry the true K and N, so a
// box past either comes back as the TMA's zeros (a product over them adds
// exact zeros), and the epilogue writes a 16-byte group of 8 columns only
// below N (N % 8 == 0 makes that every column below N). The large tile serves
// whenever its grid covers the card's SMs at least once.
inline cudaError_t launch(const bf16* A, int lda, const bf16* B, int ldb, int M, int N, int K,
                          const Epilogue& e, cudaStream_t stream) {
    if (M < 1 || N % 8 || K % 8 || lda % 8 || ldb % 8 || e.ldo % 8 || e.ldr % 8 || e.ldo2 % 8 || e.n2 % 8 ||
        ceil_div(M, Small::BM) > 65535)
        return cudaErrorInvalidValue;
    if (ceil_div(M, Large::BM) * ceil_div(N, Large::BN) >= SMS)
        return launch_tile<Large>(A, lda, B, ldb, M, N, K, e, stream);
    return launch_tile<Small>(A, lda, B, ldb, M, N, K, e, stream);
}

// ---- The LayerNorm prologue: pallas_layer.py::_ln inside the product that
// consumes it (the TPU kernel's `_ln` output never leaves VMEM; here it never
// reaches device memory), for the GEMMs whose A operand is only the
// LayerNorm of their input rows (gemm_ln.cu). A row's statistics need all K
// of its values before its first normalised k-step, and the operand is the
// same for every column tile of a row tile: normalising each A box as it
// arrives in the ring (the tiles' A boxes come anew for every column tile)
// repeats the statistics and the normalisation 8 to 16 times at the layer's N,
// which made such a GEMM slower than the standalone LayerNorm and the GEMM
// together. So the A row tile stays: a block loads the raw rows of a row tile
// once (K / 64 TMA boxes of 128 or 64 rows), takes their statistics from
// shared memory, normalises them in place, and streams only the B boxes of
// the row tile's column tiles through the ring. Where the row tiles are few
// (M = 2,048) a row tile's column tiles are split over several blocks, each
// of which normalises the rows again. The operations are common.cuh's, in
// the standalone LayerNorm's order, so the operand is bit for bit the bf16
// tensor that layer.cu's kernel writes, and the products (each output's sum
// over k in the same order, whatever the tile) and the epilogue are the
// GEMM's: the outputs are those of asr_layernorm_bf16 followed by
// asr_gemm_bf16, bit for bit.

struct Norm {
    const float* g;  // [K]
    const float* b;  // [K]
    float eps;
};

// The large tile with A resident. The output tiles are cut into units of one
// row tile and a run of its column tiles (all of them where the row tiles
// alone cover the card's SMs, else `segs` runs of a row tile); a block takes
// units blockIdx.x, blockIdx.x + gridDim.x, ... and the tiles of each in
// turn, the two teams alternating over the block's tiles and their main loops
// taking turns as in gemm_kernel_pingpong. For each unit the producer loads
// the row tile's raw rows into an A buffer (two where they fit beside the
// ring, K <= 256: the next unit's rows arrive under this one's products), then
// the B boxes of the unit's tiles; the team of the unit's first tile takes the
// statistics from the buffer and normalises it (its eight warps, 16 rows
// each; all sixteen warps, 8 rows each, for a block's first unit, when both
// teams are idle), then signals `a_ready`; each team signals `a_free` (its
// eight warps) once its last product on the unit is done, and the producer
// refills a buffer only after both teams did. A barrier of a buffer completes once per
// use of it and nobody waits past the next use, so its parity is never
// ambiguous.
struct LargeLN {
    static constexpr int BM = 128, BN = 128, THREADS = 640, MAX_KB = 8, MAX_STAGES = 8;  // K <= 512
    static constexpr int CONSUMER_REGS = Large::CONSUMER_REGS, PRODUCER_REGS = Large::PRODUCER_REGS;
    static constexpr uint32_t A_BOX = BM * BK * 2, B_BOX = BK * 64 * 2, B_BYTES = B_BOX * (BN / 64);
    static constexpr uint32_t GB = 2 * MAX_KB * BK * 4;  // the LayerNorm's g and b, K floats each
    static constexpr uint32_t BARRIERS = 8 * 32, TAIL = BARRIERS + 2 * 2 * BN * 4 + GB;  // 26 barriers; biases; g, b
    static constexpr uint32_t SMEM_MAX = 232448;  // the dynamic shared memory a block can take
    static int buffers(int kb) { return 1024 + 2 * kb * A_BOX + 4 * B_BYTES + TAIL <= SMEM_MAX ? 2 : 1; }
    static int stages(int kb, int nbuf) {
        const int n = (int)((SMEM_MAX - 1024 - TAIL - nbuf * kb * A_BOX) / B_BYTES);
        return n < MAX_STAGES ? n : MAX_STAGES;
    }
    static uint32_t smem_bytes(int kb, int nbuf, int stages) { return 1024 + nbuf * kb * A_BOX + stages * B_BYTES + TAIL; }
};

// The statistics of rows row0 .. row0 + 8 Q - 1 of the A row tile at `a` (one
// warp; its K / 64 boxes BOX bytes apart), with the standalone kernel's sums:
// there, lane v adds columns v, v + 32, ... of a row. Here lane L = 4 h + u reads
// 16-byte chunks, columns 8 u .. 8 u + 7 of each 32-column segment of rows
// row0 + h (and row0 + h + 8 for Q = 2), and holds the sums of those eight
// lanes v = 8 u + e (each over the same values in the same order); 4 Q chunks
// in flight. warp_sum's butterfly (lane bits 4 to 0) is then lane bits 1 and 0
// of u, across the four lanes of h, and bits 2 to 0 of e, inside the lane. Each
// lane keeps mu and r of the rows it normalises (ln_box): row0 + L / 8 + 4 i,
// i < 2 Q. Rows past M are the TMA's zeros.
template <uint32_t BOX, int Q>
__device__ __forceinline__ void ln_rows(uint32_t a, int row0, int K, float eps, float (&mu)[2 * Q], float (&r)[2 * Q]) {
    const int lane = threadIdx.x % 32, u = lane % 4, h = lane / 4;
    float s[Q][8], ss[Q][8];
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) s[q][e] = ss[q][e] = 0.0f;
    for (int c0 = 0; c0 < K; c0 += 4 * 32) {
        uint4 v[Q][4];
#pragma unroll
        for (int q = 0; q < Q; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = c0 + 32 * j + 8 * u, row = row0 + h + 8 * q;  // box c / 64, swizzled chunk
                v[q][j] = c < K ? ld_shared_v4(a + (c / BK) * BOX + row * 128 + ((((c % BK) / 8) ^ (row & 7)) << 4))
                                : make_uint4(0u, 0u, 0u, 0u);
            }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (c0 + 32 * j + 8 * u >= K) break;  // K % 8 == 0: lane v's columns end below K
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const uint32_t w[4] = {v[q][j].x, v[q][j].y, v[q][j].z, v[q][j].w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    ln_accumulate(bf16_lo(w[e]), s[q][2 * e], ss[q][2 * e]);
                    ln_accumulate(bf16_hi(w[e]), s[q][2 * e + 1], ss[q][2 * e + 1]);
                }
            }
        }
    }
    float m[Q], rr[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
        for (int o = 2; o > 0; o >>= 1)  // lane bits 4, 3
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                s[q][e] += __shfl_xor_sync(0xffffffffu, s[q][e], o);
                ss[q][e] += __shfl_xor_sync(0xffffffffu, ss[q][e], o);
            }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1)  // lane bits 2, 1, 0: a + b == b + a, so lane e's sum serves e ^ o too
#pragma unroll
            for (int e = 0; e < o; ++e) {
                s[q][e] = s[q][e] + s[q][e + o];
                ss[q][e] = ss[q][e] + ss[q][e + o];
            }
        ln_finish(s[q][0], ss[q][0], K, eps, m[q], rr[q]);
    }
    // row row0 + L / 8 + 4 i: q = i / 2, held by lane 4 ((L / 8 + 4 i) % 8)
#pragma unroll
    for (int i = 0; i < 2 * Q; ++i) {
        const int src = 4 * ((lane / 8 + 4 * i) % 8);
        mu[i] = __shfl_sync(0xffffffffu, m[i / 2], src);
        r[i] = __shfl_sync(0xffffffffu, rr[i / 2], src);
    }
}

// Normalise in place rows row0 .. row0 + 8 Q - 1 of an A box (k-values k0 ..
// k0 + 63, 128-byte swizzle: chunk c of row q at chunk c ^ (q % 8)), one warp:
// lane l rewrites the 16-byte chunk l % 8 (8 columns) of rows row0 + l / 8 +
// 4 i, i < 2 Q, so that a quarter warp covers one row's 128 bytes (no bank
// conflict) and a lane needs the g and b of 8 columns (`gb`: g, then b, K
// floats each, in shared memory). Columns past K (an edge box: the TMA's
// zeros) take g = b = 0 and stay 0. Fenced for the async proxy: the caller's
// barrier then makes the box whole for the products.
template <int Q>
__device__ __forceinline__ void ln_box(uint32_t box, int row0, int k0, int K, uint32_t gb, const float (&mu)[2 * Q],
                                       const float (&r)[2 * Q]) {
    const int lane = threadIdx.x % 32, j = lane % 8, c = k0 + 8 * j;
    row0 += lane / 8;
    float g[8], b[8];
    if (c < K) {  // K % 8 == 0: the chunk lies wholly below K or wholly past it
        const uint4 g0 = ld_shared_v4(gb + 4 * c), g1 = ld_shared_v4(gb + 4 * c + 16);
        const uint4 b0 = ld_shared_v4(gb + 4 * (K + c)), b1 = ld_shared_v4(gb + 4 * (K + c) + 16);
        const uint32_t wg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const uint32_t wb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) g[e] = __uint_as_float(wg[e]), b[e] = __uint_as_float(wb[e]);
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) g[e] = b[e] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 2 * Q; ++i) {
        const int q = row0 + 4 * i;
        const uint32_t addr = box + q * 128 + ((j ^ (q & 7)) << 4);
        const uint4 v = ld_shared_v4(addr);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)  // word e: columns c + 2e (low half), c + 2e + 1
            o[e] = pack_bf16(ln_apply(bf16_lo(w[e]), mu[i], r[i], g[2 * e], b[2 * e]),
                             ln_apply(bf16_hi(w[e]), mu[i], r[i], g[2 * e + 1], b[2 * e + 1]));
        st_shared_v4(addr, make_uint4(o[0], o[1], o[2], o[3]));
    }
    fence_proxy_async();
}

template <int ACT>
__global__ void __launch_bounds__(LargeLN::THREADS, 1)
gemm_ln_kernel(const __grid_constant__ Maps maps, int M, int N, int K, Epilogue e, Norm nm, int nbuf, int stages,
               int segs) {
    using T = LargeLN;
    constexpr int BN = T::BN;
    extern __shared__ unsigned char smem_raw[];
    const int k_steps = (K + BK - 1) / BK;  // and the A boxes of a row tile
    const uint32_t abuf = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t ring = abuf + nbuf * k_steps * T::A_BOX;
    const uint32_t full = ring + stages * T::B_BYTES, empty = full + 8 * T::MAX_STAGES, turn = empty + 8 * T::MAX_STAGES;
    const uint32_t a_full = turn + 16, a_ready = a_full + 16, a_free = a_ready + 16;  // [buffer]; a_free [team][buffer]
    const uint32_t gb = full + T::BARRIERS + 2 * 2 * BN * 4;  // g, then b
    if (threadIdx.x == 0) {
        for (int st = 0; st < stages; ++st) {
            mbar_init(full + 8 * st, 1);
            mbar_init(empty + 8 * st, 8);  // the eight warps of the team whose tile the stage holds
        }
        for (int i = 0; i < 2; ++i) {
            mbar_init(turn + 8 * i, 8);
            mbar_init(a_full + 8 * i, 1);
            mbar_init(a_ready + 8 * i, 1);
            mbar_init(a_free + 8 * i, 8);
            mbar_init(a_free + 16 + 8 * i, 8);
        }
        mbar_init_fence();
    }
    __syncthreads();

    const int tiles_n = (N + BN - 1) / BN, units = ((M + T::BM - 1) / T::BM) * segs;
    const int wg = threadIdx.x / 128;
    if (wg == 4) {
        // ---- producer: one thread; per unit its A row tile, then two B boxes per k-step of each tile
        setmaxnreg_dec<T::PRODUCER_REGS>();
        if (threadIdx.x != 512) return;
        int st = 0;
        uint32_t ph = 0;  // the ring stage loaded next, and the parity of its filling
        for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x, ++n) {
            const int b = n % nbuf, use = n / nbuf;
            if (use > 0) {  // both teams are done with the buffer's last unit
                mbar_wait(a_free + 8 * b, (use - 1) & 1);
                mbar_wait(a_free + 16 + 8 * b, (use - 1) & 1);
            }
            mbar_arrive_expect_tx(a_full + 8 * b, k_steps * T::A_BOX + (n == 0 ? 8 * K : 0));
            if (n == 0) {  // g and b, once, with the first rows
                bulk_load(gb, nm.g, 4 * K, a_full);
                bulk_load(gb + 4 * K, nm.b, 4 * K, a_full);
            }
            for (int kb = 0; kb < k_steps; ++kb)
                tma_load_2d(abuf + (b * k_steps + kb) * T::A_BOX, &maps.a, a_full + 8 * b, kb * BK, u / segs * T::BM);
            const int seg = u % segs;
            for (int c = seg * tiles_n / segs; c < (seg + 1) * tiles_n / segs; ++c)
                for (int ks = 0; ks < k_steps; ++ks) {
                    const uint32_t bar = full + 8 * st;
                    mbar_wait(empty + 8 * st, ph ^ 1);
                    mbar_arrive_expect_tx(bar, T::B_BYTES);
#pragma unroll
                    for (int j = 0; j < BN / 64; ++j)
                        tma_load_2d(ring + st * T::B_BYTES + j * T::B_BOX, &maps.b, bar, c * BN + 64 * j, ks * BK);
                    if (++st == stages) st = 0, ph ^= 1;
                }
        }
        return;
    }
    setmaxnreg_inc<T::CONSUMER_REGS>();

    // ---- consumer team wg / 2 takes the block's tiles team, team + 2, ...; its
    // warpgroup wg % 2 has rows 64 (wg % 2) .. + 63 of each
    const int lane = threadIdx.x % 32, team = wg / 2, tid = threadIdx.x % 256;
    float* bias_s = reinterpret_cast<float*>(smem_raw + (full + T::BARRIERS - smem_u32(smem_raw))) + team * 2 * BN;
    float* bias2_s = bias_s + BN;
    int i = 0, st = 0;  // the block's tiles so far; the ring stage of the next one's first k-step
    uint32_t ph = 0;    // and the parity of that stage's filling
    for (int u = blockIdx.x, n = 0; u < units; u += gridDim.x, ++n) {
        const int b = n % nbuf, use = n / nbuf, seg = u % segs;
        const int c0 = seg * tiles_n / segs, c1 = (seg + 1) * tiles_n / segs;
        const uint32_t a = abuf + b * k_steps * T::A_BOX;
        if (n == 0) {
            // the block's first rows: both teams are idle, its sixteen warps take 8 rows each
            mbar_wait(a_full, 0);
            float mu[2], rs[2];
            const int row0 = 64 * team + tid / 32 * 8;
            ln_rows<T::A_BOX, 1>(a, row0, K, nm.eps, mu, rs);
            for (int kb = 0; kb < k_steps; ++kb) ln_box<1>(a + kb * T::A_BOX, row0, kb * BK, K, gb, mu, rs);
            named_barrier(3, 512);  // every row of the buffer normalised and fenced
            if (threadIdx.x == 0) mbar_arrive(a_ready);  // the buffer's first use, as for the units after it
            if (team != i % 2 && c1 - c0 == 1 && lane == 0) mbar_arrive(a_free + 16 * team);  // no tile of it
        } else if (team == i % 2) {
            // the unit's first tile is this team's: the statistics and the
            // normalised operand, under the other team's products
            mbar_wait(a_full + 8 * b, use & 1);
            float mu[4], rs[4];
            ln_rows<T::A_BOX, 2>(a, tid / 32 * 16, K, nm.eps, mu, rs);
            for (int kb = 0; kb < k_steps; ++kb) ln_box<2>(a + kb * T::A_BOX, tid / 32 * 16, kb * BK, K, gb, mu, rs);
            named_barrier(1 + team, 256);  // every row of the buffer normalised and fenced
            if (tid == 0) mbar_arrive(a_ready + 8 * b);
        } else {
            mbar_wait(a_ready + 8 * b, use & 1);
            if (c1 - c0 == 1 && lane == 0) mbar_arrive(a_free + 16 * team + 8 * b);  // no tile of it is this team's
        }
        for (int c = c0; c < c1; ++c, ++i) {
            if (i % 2 != team) {  // the other team's tile: its k-steps pass through the ring
                for (st += k_steps; st >= stages; st -= stages) ph ^= 1;
                continue;
            }
            const int m0 = u / segs * T::BM, n0 = c * BN;
            const bool dual = e.out2 != nullptr && n0 < e.n2;  // this column tile also writes out2
            named_barrier(1 + team, 256);  // the last tile's epilogue has read its biases
            if (tid < BN) {
                const int col = n0 + tid;
                bias_s[tid] = e.bias != nullptr && col < N ? e.bias[col] : 0.0f;
                bias2_s[tid] = dual && col < e.n2 ? e.bias2[col] : 0.0f;
            }
            float acc[BN / 2];
#pragma unroll
            for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
            fence_regs(acc);
            if (team == 1) mbar_wait(turn + 8, (i / 2) & 1);  // the main loops take turns in the tiles' order
            else if (i > 0) mbar_wait(turn, (i / 2 - 1) & 1);
            int prev = 0;
            for (int ks = 0; ks < k_steps; ++ks) {
                mbar_wait(full + 8 * st, ph);
                const uint64_t a_desc = make_desc(a + ks * T::A_BOX + (wg % 2) * (64 * 128), 16, 1024, SWIZZLE_128);
                const uint64_t b_desc = make_desc(ring + st * T::B_BYTES, T::B_BOX, 1024, SWIZZLE_128);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk) product(acc, a_desc + 2 * kk, b_desc + kk * (16 * 128 / 16));
                wgmma_commit();
                if (ks > 0) {
                    // the previous step's products are done: hand its stage back
                    wgmma_wait<1>();
                    if (lane == 0) mbar_arrive(empty + 8 * prev);
                }
                prev = st;
                if (++st == stages) st = 0, ph ^= 1;
            }
            if (lane == 0) mbar_arrive(turn + 8 * (1 - team));  // every stage of this tile has been waited for
            wgmma_wait<0>();
            if (lane == 0) {
                mbar_arrive(empty + 8 * prev);
                if (c + 2 >= c1) mbar_arrive(a_free + 16 * team + 8 * b);  // this team's last product on the unit
            }
            fence_regs(acc);
            named_barrier(1 + team, 256);  // the biases are in place
            epilogue<BN, ACT>(acc, m0 + 64 * (wg % 2), n0, bias_s, bias2_s, dual, M, N, e);
        }
    }
}

// The small tile with A resident, where the large tiles would not fill the
// card's SMs (launch()'s rule): gemm_kernel's 64 x 64 tiles and products, two
// consumer warpgroups and a producer warp, two blocks an SM. A block takes one
// unit, 64 rows and a run of their column tiles (as many runs as give the SMs
// two blocks each): the producer loads the rows' raw A (K / 64 boxes of 64 x
// 64) and then, k-step by k-step, the B boxes of the warpgroups' current tiles
// into a ring each; the eight warps take the statistics of 8 rows each and
// normalise them in place, and then warpgroup w runs the run's tiles w, w + 2,
// ..., products and epilogue, beside the other's. (One warpgroup doing the
// rows' prologue and then each tile in turn measured 19 % slower than the
// LayerNorm and the GEMM apart at M = 2,048: its prologue took 3.5 us.)
struct SmallLN {
    static constexpr int BM = 64, BN = 64, NWG = 2, BLOCKS = 2, THREADS = 128 * NWG + 32;
    static constexpr uint32_t A_BOX = BM * BK * 2, B_BOX = BK * 64 * 2;
    static int stages(int kb) { return kb <= 4 ? 4 : 2; }  // a warpgroup's ring: two blocks an SM at K = 512 too
    static uint32_t smem_bytes(int kb) {
        return 1024 + kb * A_BOX + NWG * stages(kb) * B_BOX + kb * BK * 8 + 8 * (2 * NWG * 4 + 1) + NWG * BN * 8;
    }
};

template <int ACT>
__global__ void __launch_bounds__(SmallLN::THREADS, SmallLN::BLOCKS)
gemm_ln_small_kernel(const __grid_constant__ Maps maps, int M, int N, int K, Epilogue e, Norm nm, int segs,
                     int stages) {
    using T = SmallLN;
    constexpr int BN = T::BN, NWG = T::NWG;
    extern __shared__ unsigned char smem_raw[];
    const int k_steps = (K + BK - 1) / BK;
    const uint32_t a = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t ring = a + k_steps * T::A_BOX, gb = ring + NWG * stages * T::B_BOX;  // gb: g, then b
    // full / empty of warpgroup w's stage st at 8 (4 w + st); then a_full
    const uint32_t full = gb + 8 * K, empty = full + 8 * 4 * NWG, a_full = empty + 8 * 4 * NWG;
    if (threadIdx.x == 0) {
        for (int i = 0; i < 4 * NWG; ++i) {
            mbar_init(full + 8 * i, 1);
            mbar_init(empty + 8 * i, 4);  // the consumer warpgroup's four warps
        }
        mbar_init(a_full, 1);
        mbar_init_fence();
    }
    __syncthreads();

    const int tiles_n = (N + BN - 1) / BN, seg = blockIdx.x % segs, m0 = blockIdx.x / segs * T::BM;
    const int c0 = seg * tiles_n / segs, c1 = (seg + 1) * tiles_n / segs;
    const int wg = threadIdx.x / 128;
    if (wg == NWG) {
        // ---- producer: one thread; the rows' A boxes, then k-step by k-step one B box for each
        // warpgroup's current tile
        if (threadIdx.x != 128 * NWG) return;
        mbar_arrive_expect_tx(a_full, k_steps * T::A_BOX + 8 * K);
        bulk_load(gb, nm.g, 4 * K, a_full);
        bulk_load(gb + 4 * K, nm.b, 4 * K, a_full);
        for (int kb = 0; kb < k_steps; ++kb) tma_load_2d(a + kb * T::A_BOX, &maps.a, a_full, kb * BK, m0);
        int st = 0;
        uint32_t ph = 0;
        for (int c = c0; c < c1; c += NWG)
            for (int ks = 0; ks < k_steps; ++ks) {
                for (int w = 0; w < NWG && c + w < c1; ++w) {
                    const uint32_t i = 4 * w + st;
                    mbar_wait(empty + 8 * i, ph ^ 1);
                    mbar_arrive_expect_tx(full + 8 * i, T::B_BOX);
                    tma_load_2d(ring + (w * stages + st) * T::B_BOX, &maps.b, full + 8 * i, (c + w) * BN, ks * BK);
                }
                if (++st == stages) st = 0, ph ^= 1;
            }
        return;
    }

    // ---- consumers: the rows' statistics and operand (8 rows a warp), then warpgroup wg's tiles
    const int lane = threadIdx.x % 32;
    mbar_wait(a_full, 0);
    {
        float mu[2], rs[2];
        ln_rows<T::A_BOX, 1>(a, threadIdx.x / 32 * 8, K, nm.eps, mu, rs);
        for (int kb = 0; kb < k_steps; ++kb) ln_box<1>(a + kb * T::A_BOX, threadIdx.x / 32 * 8, kb * BK, K, gb, mu, rs);
    }
    named_barrier(1, 128 * NWG);  // every row of the operand normalised and fenced
    float* bias_s = reinterpret_cast<float*>(smem_raw + (a_full + 8 - smem_u32(smem_raw))) + wg * 2 * BN;
    float* bias2_s = bias_s + BN;
    int st = 0;
    uint32_t ph = 0;
    for (int c = c0 + wg; c < c1; c += NWG) {
        const int n0 = c * BN;
        const bool dual = e.out2 != nullptr && n0 < e.n2;  // this column tile also writes out2
        named_barrier(2 + wg, 128);  // the last tile's epilogue has read its biases
        if (threadIdx.x % 128 < BN) {
            const int col = n0 + threadIdx.x % 128;
            bias_s[threadIdx.x % 128] = e.bias != nullptr && col < N ? e.bias[col] : 0.0f;
            bias2_s[threadIdx.x % 128] = dual && col < e.n2 ? e.bias2[col] : 0.0f;
        }
        float acc[BN / 2];
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
        fence_regs(acc);
        int prev = 0;
        for (int ks = 0; ks < k_steps; ++ks) {
            const uint32_t i = 4 * wg + st;
            mbar_wait(full + 8 * i, ph);
            const uint64_t a_desc = make_desc(a + ks * T::A_BOX, 16, 1024, SWIZZLE_128);
            const uint64_t b_desc = make_desc(ring + (wg * stages + st) * T::B_BOX, T::B_BOX, 1024, SWIZZLE_128);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) product(acc, a_desc + 2 * kk, b_desc + kk * (16 * 128 / 16));
            wgmma_commit();
            if (ks > 0) {
                wgmma_wait<1>();
                if (lane == 0) mbar_arrive(empty + 8 * prev);
            }
            prev = i;
            if (++st == stages) st = 0, ph ^= 1;
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
        fence_regs(acc);
        named_barrier(2 + wg, 128);  // the biases are in place
        epilogue<BN, ACT>(acc, m0, n0, bias_s, bias2_s, dual, M, N, e);
    }
}

template <int ACT>
cudaError_t launch_kernel(LargeLN, const Maps& maps, int M, int N, int K, const Epilogue& e, const Norm& nm,
                             cudaStream_t stream) {
    using T = LargeLN;
    static bool ready = false;  // the attribute and the check below are made once per activation
    if (!ready) {
        cudaError_t err = cudaFuncSetAttribute(gemm_ln_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)T::SMEM_MAX);
        if (err != cudaSuccess) return err;
        cudaFuncAttributes attr;  // as for the large tile: the consumers' registers must be there
        err = cudaFuncGetAttributes(&attr, gemm_ln_kernel<ACT>);
        if (err != cudaSuccess) return err;
        if (attr.numRegs * T::THREADS < 128 * (4 * T::CONSUMER_REGS + T::PRODUCER_REGS))
            return cudaErrorLaunchOutOfResources;
        ready = true;
    }
    const int kb = ceil_div(K, BK), nbuf = T::buffers(kb), stages = T::stages(kb, nbuf);
    // as many runs of a row tile's column tiles as fill the SMs, where its row tiles alone do not
    const int rows = ceil_div(M, T::BM), tiles_n = ceil_div(N, T::BN);
    int segs = SMS / rows;
    segs = segs < 1 ? 1 : segs > tiles_n ? tiles_n : segs;
    const int units = rows * segs;
    gemm_ln_kernel<ACT><<<units < SMS ? units : SMS, T::THREADS, T::smem_bytes(kb, nbuf, stages), stream>>>(
        maps, M, N, K, e, nm, nbuf, stages, segs);
    return cudaGetLastError();
}

template <int ACT>
cudaError_t launch_kernel(SmallLN, const Maps& maps, int M, int N, int K, const Epilogue& e, const Norm& nm,
                             cudaStream_t stream) {
    using T = SmallLN;
    static bool ready = false;  // the attribute is set once per activation, for the widest K
    if (!ready) {
        cudaError_t err = cudaFuncSetAttribute(gemm_ln_small_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)T::smem_bytes(LargeLN::MAX_KB));
        if (err != cudaSuccess) return err;
        ready = true;
    }
    // runs of a row tile's column tiles: enough blocks for two an SM
    const int rows = ceil_div(M, T::BM), tiles_n = ceil_div(N, T::BN), kb = ceil_div(K, BK);
    int segs = T::BLOCKS * SMS / rows;
    segs = segs < 1 ? 1 : segs > tiles_n ? tiles_n : segs;
    gemm_ln_small_kernel<ACT><<<rows * segs, T::THREADS, T::smem_bytes(kb), stream>>>(maps, M, N, K, e, nm, segs,
                                                                                     T::stages(kb));
    return cudaGetLastError();
}

// The LayerNorm prologue's shape contract (kernels/layer.py::ln_gemm_contract):
// launch()'s, without a residual or gate, and K <= 512 (a row tile, K wide,
// in shared memory); g and b 16-byte aligned. The tile is chosen as launch()
// chooses it.
inline cudaError_t launch_ln(const bf16* A, int lda, const bf16* B, int ldb, int M, int N, int K, const Epilogue& e,
                             const Norm& nm, cudaStream_t stream) {
    if (M < 1 || N % 8 || K % 8 || K > BK * LargeLN::MAX_KB || lda % 8 || ldb % 8 || e.ldo % 8 || e.ldo2 % 8 ||
        e.n2 % 8 || e.res != nullptr)
        return cudaErrorInvalidValue;
    if (ceil_div(M, LargeLN::BM) * ceil_div(N, LargeLN::BN) >= SMS)
        return launch_tile<LargeLN>(A, lda, B, ldb, M, N, K, e, stream, nm);
    return launch_tile<SmallLN>(A, lda, B, ldb, M, N, K, e, stream, nm);
}

}  // namespace gemm
