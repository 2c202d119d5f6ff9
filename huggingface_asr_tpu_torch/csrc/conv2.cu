// conv2 of the conv subsampler: 3x3, stride 2, pad 1, C -> C channels, + bias
// + GELU, as an implicit GEMM on wgmma.
//
// Replaces the second convolution of ops/pallas_subsample.py::_subsample_kernel
// of the JAX package (conv1 and the rest of the subsampler are in
// subsample.cu):
//
//   y2[m, n] = GELU(bf16(bf16(acc) + b2[n])),  m = (b * T2 + t2) * F2 + f2
//   acc = sum over k = (kt * 3 + kf) * C + c of
//         y1[b, 2 * t2 + kt - 1, 2 * f2 + kf - 1, c] * w2[k, n]   (zeros outside y1)
//
// with the TPU kernel's rounding points: the fp32 sum rounds to bf16 before
// the bias is added, the sum rounds again, and the GELU of that rounds once.
//
// What bounds it on the H100: operations. M = B * T2 * F2 rows (40,000 at
// B=8 x 10 s), N = C = 256, K = 9 * C = 2304: 47 GFLOP over 41 MB, the one
// compute-bound piece of the serving path. So the tensor cores have to be
// kept fed, and every row of A gathered once.
//
// What the design does about it:
//   * A block owns up to 128 output rows of one utterance, whole output
//     frames (128 / F2 = 6 frames of F2 = 20 bins: 120 rows), and ALL 256
//     columns, so a row of the 3x3 neighbourhood is fetched once and not once
//     per column tile. Two consumer warpgroups of 64 rows each run
//     wgmma.m64n256k16 with a 64 x 256 fp32 accumulator in registers (128 per
//     thread); one producer thread feeds them.
//   * K runs in 36 steps of 64: one tap (kt, kf) and 64 of its channels. With
//     stride 2 a tap reads input frame 2 * t2 + kt - 1 and bin 2 * f2 + kf - 1:
//     one parity of frames and one of bins, shifted by -1 or 0. So y1 is
//     given to the TMA as four views, one per (frame parity, bin parity),
//     each (channel, f2, t2, b) with strides 2 and 2 * F1 pixels: the A tile
//     of a step is ONE box {64, F2, 6, 1} of one view at (c0, -1 or 0,
//     t2_0 - 1 or t2_0, b), and the conv's padding, frames past y1 and frames
//     past T2 are the TMA's out-of-range zeros. No thread computes an address,
//     and the box lands in the 128-byte-swizzled layout wgmma reads. The
//     weights (L2-resident, 1.2 MB) arrive as four more boxes per step and
//     are read as the transposed B operand, so w2 keeps its (k, n) layout.
//     A ring of four 48 KB stages under full/empty mbarriers keeps three
//     steps in flight behind the one being multiplied. (The first version
//     gathered A with 16-byte cp.async from a producer warpgroup: its
//     consumers spent most of the main loop waiting for a stage; sharing the
//     weights across a cluster of two blocks by multicast was slower still.)
//   * The epilogue runs on the accumulator fragment: round, add the bias,
//     round, exact GELU, round, and bf16 pairs go straight to y2. No fp32
//     tile passes through shared memory.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int C = 256;  // channels in and out: the block's N
constexpr int BM = 128, BK = 64, STAGES = 4;
constexpr int K_STEPS = 9 * C / BK;  // 36
constexpr int N_CONSUMER_WARPS = 8;
constexpr uint32_t A_BYTES = BM * BK * 2, B_BOX = BK * 64 * 2, B_BYTES = BK * C * 2;
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
constexpr uint32_t SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 8 * 2 * STAGES;

struct Maps {
    CUtensorMap y1[2][2];  // [frame parity][bin parity] views of conv1's output
    CUtensorMap w;
};

// SERVING: the serving profile's GELU (common.cuh::gelu_serving8, eight values at a
// time) in place of gelu_erf.
template <bool SERVING>
__global__ void __launch_bounds__(384, 1)
conv2_kernel(const __grid_constant__ Maps maps, const float* __restrict__ b2,
             bf16* __restrict__ y2, int T2, int F2, int frames) {
    extern __shared__ unsigned char smem_raw[];
    const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t full = ring + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, N_CONSUMER_WARPS);
        }
        mbar_init_fence();
    }
    __syncthreads();

    // the block's rows: output frames t2_0 .. t2_0 + frames - 1 of utterance b
    const int t2_0 = blockIdx.x * frames, b = blockIdx.y;
    const int wg = threadIdx.x / 128;
    if (wg == 2) {
        // ---- producer: one thread, five TMA boxes per k-step
        if (threadIdx.x != 256) return;
        const uint32_t a_bytes = (uint32_t)(BK * F2 * frames * 2);
        for (int ks = 0; ks < K_STEPS; ++ks) {
            const int s = ks % STAGES;
            const uint32_t a_st = ring + s * STAGE_BYTES, b_st = a_st + A_BYTES, bar = full + 8 * s;
            mbar_wait(empty + 8 * s, ((ks / STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(bar, a_bytes + B_BYTES);
            const int tap = ks / (C / BK), kt = tap / 3, kf = tap % 3;
            tma_load_4d(a_st, &maps.y1[kt != 1][kf != 1], bar, (ks % (C / BK)) * BK,
                        kf == 0 ? -1 : 0, t2_0 - (kt == 0), b);
#pragma unroll
            for (int j = 0; j < C / 64; ++j) tma_load_2d(b_st + j * B_BOX, &maps.w, bar, 64 * j, ks * BK);
        }
    } else {
        // ---- consumer warpgroups: tile rows 64 * wg .. + 63, all 256 columns
        // (rows past F2 * frames hold whatever the stage held: never stored)
        const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
        float acc[128];
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
        fence_regs(acc);
        for (int ks = 0; ks < K_STEPS; ++ks) {
            const int s = ks % STAGES;
            const uint32_t a_st = ring + s * STAGE_BYTES, b_st = a_st + A_BYTES;
            mbar_wait(full + 8 * s, (ks / STAGES) & 1);
            const uint64_t a_desc = make_desc(a_st + wg * (64 * 128), 16, 1024, SWIZZLE_128);
            const uint64_t b_desc = make_desc(b_st, B_BOX, 1024, SWIZZLE_128);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                wgmma_m64n256k16_ss_bt(acc, a_desc + 2 * kk, b_desc + kk * (16 * 128 / 16), 1);
            wgmma_commit();
            if (ks > 0) {
                // the previous step's products are done: hand its stage back
                wgmma_wait<1>();
                if (lane == 0) mbar_arrive(empty + 8 * ((ks - 1) % STAGES));
            }
        }
        wgmma_wait<0>();
        fence_regs(acc);

        const int row = wg * 64 + warp * 16 + lane / 4, cq = 2 * (lane % 4);
        const int rows = min(frames, T2 - t2_0) * F2;  // of this tile, inside y2
        bf16* out_a = y2 + (((size_t)b * T2 + t2_0) * F2 + row) * C + cq;
        bf16* out_b = out_a + 8 * C;
#pragma unroll
        for (int j = 0; j < C / 8; j += 2) {
            float v[8];  // column groups j and j + 1: rows a, a, b, b of each
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float2 bias = *reinterpret_cast<const float2*>(b2 + 8 * (j + h) + cq);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    v[4 * h + e] = round_bf(round_bf(acc[4 * (j + h) + e]) + (e % 2 ? bias.y : bias.x));
            }
            if constexpr (SERVING) {
                gelu_serving8(v);
            } else {
#pragma unroll
                for (int i = 0; i < 8; ++i) v[i] = gelu_erf(v[i]);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (row < rows) *reinterpret_cast<uint32_t*>(out_a + 8 * (j + h)) = pack_bf16(v[4 * h], v[4 * h + 1]);
                if (row + 8 < rows)
                    *reinterpret_cast<uint32_t*>(out_b + 8 * (j + h)) = pack_bf16(v[4 * h + 2], v[4 * h + 3]);
            }
        }
    }
}

}  // namespace

// y2[B*T2*F2, C] = GELU(bf16(bf16(conv2(y1)) + b2)); y1: [B, T1, F1, C] bf16;
// w2: [9*C, C] bf16, rows (kt, kf, c); b2: [C] fp32. C must be 256, F1 even,
// F2 = F1 / 2 <= 128. serving 1: the serving profile's GELU.
ASR_API int asr_conv2(const void* y1, const void* w2, const void* b2, void* y2, int B, int T1,
                      int F1, int Cn, int T2, int F2, int serving, void* stream) {
    if (Cn != C || F1 % 2 || F2 != F1 / 2 || F2 < 1 || F2 > BM || T1 < 2 || B < 1 || T2 < 1 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const int frames = BM / F2;  // whole output frames in a tile of at most BM rows
    Maps maps;
    cudaError_t err = cudaSuccess;
    for (int pt = 0; pt < 2 && err == cudaSuccess; ++pt) {
        for (int pf = 0; pf < 2 && err == cudaSuccess; ++pf) {
            // frames pt, pt + 2, .. and bins pf, pf + 2, .. of y1 as (c, f2, t2, b)
            const cuuint64_t dims[4] = {C, (cuuint64_t)(F1 - pf + 1) / 2, (cuuint64_t)(T1 - pt + 1) / 2,
                                        (cuuint64_t)B};
            const cuuint64_t strides[3] = {2ull * C * 2, 2ull * F1 * C * 2, (cuuint64_t)T1 * F1 * C * 2};
            const cuuint32_t box[4] = {BK, (cuuint32_t)F2, (cuuint32_t)frames, 1};
            err = tensor_map_bf16(&maps.y1[pt][pf], static_cast<const bf16*>(y1) + ((size_t)pt * F1 + pf) * C,
                                  4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
        }
    }
    if (err != cudaSuccess) return (int)err;
    const cuuint64_t dims[2] = {C, 9 * C};
    const cuuint64_t strides[1] = {C * 2};
    const cuuint32_t box[2] = {64, BK};
    err = tensor_map_bf16(&maps.w, w2, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return (int)err;
    auto kernel = serving ? conv2_kernel<true> : conv2_kernel<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(T2, frames), B);
    kernel<<<grid, 384, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        maps, static_cast<const float*>(b2), static_cast<bf16*>(y2), T2, F2, frames);
    return (int)cudaGetLastError();
}
