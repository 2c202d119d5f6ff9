// Log-mel front end with the DFT as a bf16 tensor-core product: the "bf16"
// and "high" modes of ops/pallas_features.py::_mel_kernel (the serving
// path's front end, PallasLogMelFrontEnd(LogMelConfig(matmul_precision=
// "bf16"))). mel.cu keeps the "highest" contract in fp32 FFMA; the CMVN
// kernel there follows either.
//
// Per frame f (samples [f*hop, f*hop + L)) and output column n of the folded
// bases (kernels/mel.py::folded_bases, [cos | sin], Nyquist bin dropped):
//   bf16: coef[f, n] = sum_k bf16(x[f*hop + k]) hi[k, n]
//   high: coef[f, n] = sum_k  bf16(x) hi + bf16(x) lo + bf16(x - bf16(x)) hi
// (hi = bf16(dft), lo = bf16(dft - hi); the lo x lo term dropped, as the TPU
// kernel drops it), fp32 accumulation, then as in mel.cu: the power c^2 + s^2,
// the fp32 mel product, log(max(mel, floor)).
//
// What bounds it on the H100: operations. At B=128 x 10 s the DFT is 52 GFLOP
// of bf16 products (0.053 ms at 989 TFLOP/s; three times that in "high") and
// the mel product 5.2 GFLOP of fp32 FMA (0.078 ms at 67 TFLOP/s), against
// 0.037 ms for the waveform and the log-mel moved once.
//
// What the design does about it (a first, simple version; PERF.md section 6):
//   * the A operand is the frames, which overlap: frame f's band j (samples
//     j*hop .. j*hop + hop - 1 of the frame) is hop-row f + j of the
//     waveform. So a block stages the hop-rows its 64 frames read (64 + 2 at
//     L = 400, hop = 160) once, as bf16 (and, in "high", the low halves
//     beside them), in shared memory rows padded to hop + 8 values, and a
//     k16 step of the product, which lies in one band because hop % 16 == 0,
//     reads its A fragment straight from the rows f + j: a shifted row is a
//     shifted address, which a swizzled wgmma tile could not take. The
//     padding puts the eight rows of a fragment on eight different bank
//     quads (168 / 2 = 84 words, 84 = 20 mod 32): no bank conflicts;
//   * the products are mma.sync m16n8k16 (bf16 in, fp32 accumulators in
//     registers); B fragments are read from the transposed bases (a row per
//     output column, k contiguous: one 32-bit load per fragment register),
//     which stay in L2;
//   * a warp owns 16 bins of a 64-bin pass for all 64 frames, and computes
//     their cos and their sin columns as separate n8 tiles: the accumulator
//     fragments of a bin's cos and sin then sit in the same registers of the
//     same thread, and the power is formed there;
//   * the power goes to shared memory at the end of a pass and the mel
//     product is mel.cu's: each thread adds its 8 frames x 5 mel columns over
//     the pass's bins in order, in fp32 FMA; after four passes, log and one
//     fp32 store.
#include "common.cuh"

namespace {

constexpr int FT = 64;               // frames of a block
constexpr int PASS_BINS = 64;        // bins of a pass: 16 a warp
constexpr int THREADS = 128;         // four warps
constexpr int PW_LD = PASS_BINS + 1;  // row stride of the staged power
constexpr int MEL_J = 5;             // mel columns of a thread, 16 apart: n_mel <= 80

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wav: [B, S] fp32; dft: [P, 2*NB, L] bf16, P = 1 (hi) or 2 (hi, lo), a row
// per output column (cos columns, then sin); melbank: [NB, n_mel] fp32;
// out: [B, n_frames, n_mel] fp32. Shared memory: the power [FT][PW_LD] fp32,
// then the hop-rows [R][RS] bf16 (and, HIGH, their low halves).
template <bool HIGH>
__global__ void __launch_bounds__(THREADS)
mel_bf16_kernel(const float* __restrict__ wav, int S, const bf16* __restrict__ dft,
                const float* __restrict__ melbank, float* __restrict__ out, int n_frames, int L, int hop,
                int NB, int n_mel, float floor_) {
    extern __shared__ __align__(16) unsigned char smem[];
    float (*pw)[PW_LD] = reinterpret_cast<float (*)[PW_LD]>(smem);
    const int RS = hop + 8, R = FT + (L - 1) / hop;  // row stride (bf16 values) and rows of the block
    bf16* xh = reinterpret_cast<bf16*>(smem + FT * PW_LD * 4);
    bf16* xl = xh + R * RS;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, c = lane % 4;
    const int b = blockIdx.y, f0 = blockIdx.x * FT;
    const float* x = wav + (size_t)b * S;

    // hop-rows f0 .. f0 + R - 1, zeros past S
    for (int i = tid; i < R * hop; i += THREADS) {
        const int r = i / hop, col = i - r * hop;
        const long long at = (long long)(f0 + r) * hop + col;
        const float v = at < S ? __ldg(x + at) : 0.0f;
        const bf16 h = to_bf(v);
        xh[r * RS + col] = h;
        if constexpr (HIGH) xl[r * RS + col] = to_bf(v - to_f(h));
    }
    __syncthreads();

    float mel[8][MEL_J];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int m = 0; m < MEL_J; ++m) mel[i][m] = 0.0f;
    const int tx = tid % 16, ty = tid / 16;  // the mel product's 16 column groups x 8 frame groups
    const size_t plane = (size_t)2 * NB * L;
    const int steps = L / 16;

    for (int p = 0; p < NB / PASS_BINS; ++p) {
        // this warp's bins p*64 + 16 warp + 8 t + g (t = 0, 1): B rows of cos (tiles 0, 1) and sin (2, 3)
        const bf16* brow[4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
            const int bin = p * PASS_BINS + 16 * warp + 8 * t + g;
            brow[t] = dft + (size_t)bin * L + 2 * c;
            brow[2 + t] = dft + (size_t)(NB + bin) * L + 2 * c;
        }
        float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll 5
        for (int s = 0; s < steps; ++s) {
            const int k0 = 16 * s, j = k0 / hop, kk = k0 - j * hop;
            uint32_t bh[4][2], bl[4][2];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                bh[nt][0] = __ldg(reinterpret_cast<const unsigned int*>(brow[nt] + k0));
                bh[nt][1] = __ldg(reinterpret_cast<const unsigned int*>(brow[nt] + k0 + 8));
                if constexpr (HIGH) {
                    bl[nt][0] = __ldg(reinterpret_cast<const unsigned int*>(brow[nt] + plane + k0));
                    bl[nt][1] = __ldg(reinterpret_cast<const unsigned int*>(brow[nt] + plane + k0 + 8));
                }
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                // frame rows 16 mt + g and + 8 read hop-rows (those) + j, columns kk + 2c (+ 8)
                const int at = (16 * mt + g + j) * RS + kk + 2 * c;
                uint32_t ah[4], al[4];
                ah[0] = *reinterpret_cast<const uint32_t*>(xh + at);
                ah[1] = *reinterpret_cast<const uint32_t*>(xh + at + 8 * RS);
                ah[2] = *reinterpret_cast<const uint32_t*>(xh + at + 8);
                ah[3] = *reinterpret_cast<const uint32_t*>(xh + at + 8 * RS + 8);
                if constexpr (HIGH) {
                    al[0] = *reinterpret_cast<const uint32_t*>(xl + at);
                    al[1] = *reinterpret_cast<const uint32_t*>(xl + at + 8 * RS);
                    al[2] = *reinterpret_cast<const uint32_t*>(xl + at + 8);
                    al[3] = *reinterpret_cast<const uint32_t*>(xl + at + 8 * RS + 8);
                }
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    mma_bf16(acc[mt][nt], ah, bh[nt][0], bh[nt][1]);
                    if constexpr (HIGH) {
                        mma_bf16(acc[mt][nt], ah, bl[nt][0], bl[nt][1]);
                        mma_bf16(acc[mt][nt], al, bh[nt][0], bh[nt][1]);
                    }
                }
            }
        }
        // the pass's power, c^2 + s^2 as the plain version rounds it: fragment e of
        // tile (mt, t) is frame 16 mt + g + 8 (e / 2), bin 16 warp + 8 t + 2c + e % 2
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float cv = acc[mt][t][e], sv = acc[mt][2 + t][e];
                    pw[16 * mt + g + 8 * (e / 2)][16 * warp + 8 * t + 2 * c + e % 2] =
                        __fadd_rn(__fmul_rn(cv, cv), __fmul_rn(sv, sv));
                }
        __syncthreads();
        // mel.cu's mel product: 8 frames x 5 mel columns a thread, over the pass's bins in order
        const float* wrow = melbank + (size_t)p * PASS_BINS * n_mel;
#pragma unroll 8
        for (int jb = 0; jb < PASS_BINS; ++jb) {
            float w[MEL_J];
#pragma unroll
            for (int m = 0; m < MEL_J; ++m) {
                const int col = tx + 16 * m;
                w[m] = col < n_mel ? __ldg(wrow + (size_t)jb * n_mel + col) : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float v = pw[8 * ty + i][jb];
#pragma unroll
                for (int m = 0; m < MEL_J; ++m) mel[i][m] = fmaf(v, w[m], mel[i][m]);
            }
        }
        __syncthreads();  // every thread is done with pw before the next pass writes it
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int f = f0 + 8 * ty + i;
        if (f >= n_frames) break;
        float* o = out + ((size_t)b * n_frames + f) * n_mel;
#pragma unroll
        for (int m = 0; m < MEL_J; ++m) {
            const int col = tx + 16 * m;
            if (col < n_mel) o[col] = logf(fmaxf(mel[i][m], floor_));
        }
    }
}

}  // namespace

// wav: [B, S] fp32; dft: [1 + high, 2*NB, L] bf16 (kernels/mel.py::MelFrontEnd's
// transposed hi and lo bases); melbank: [NB, n_mel] fp32; out: [B, n_frames,
// n_mel] fp32 log-mel. Takes NB % 64 == 0, n_mel <= 80, L % 16 == 0, hop % 16
// == 0 and frames within S (the wrapper checks).
ASR_API int asr_log_mel_bf16(const void* wav, const void* dft, const void* melbank, void* out, int B, int S,
                             int n_frames, int L, int hop, int NB, int n_mel, float floor_, int high,
                             void* stream) {
    if (B < 1 || B > 65535 || n_frames < 1 || L < 16 || L % 16 || hop < 16 || hop % 16 || NB < PASS_BINS ||
        NB % PASS_BINS || n_mel < 1 || n_mel > 16 * MEL_J)
        return static_cast<int>(cudaErrorInvalidValue);
    const int rows = FT + (L - 1) / hop;
    const size_t smem = (size_t)FT * PW_LD * 4 + (size_t)(high ? 2 : 1) * rows * (hop + 8) * 2;
    auto kernel = high ? mel_bf16_kernel<true> : mel_bf16_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(ceil_div(n_frames, FT), B);
    kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(wav), S, static_cast<const bf16*>(dft), static_cast<const float*>(melbank),
        static_cast<float*>(out), n_frames, L, hop, NB, n_mel, floor_);
    return static_cast<int>(cudaGetLastError());
}
