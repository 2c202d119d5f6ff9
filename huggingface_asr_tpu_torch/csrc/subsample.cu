// Conv subsampler: conv1 (direct); conv2 (implicit GEMM) is in conv2.cu.
//
// Replaces ops/pallas_subsample.py::_subsample_kernel (via conv_subsample_fused):
//   conv1 (1 -> C, 3x3, stride 2, pad 1) + bias + GELU
//   conv2 (C -> C, 3x3, stride 2, pad 1) + bias + GELU
//   channel-major flatten + Dense (F2*C -> D), LayerNorm, Dense projection
// The last three run as the row-major GEMM (layer.cu) and LayerNorm; the
// Dense weight's rows are regathered at load time into f2-major order so the
// (B*T2, F2*C) view of conv2's output multiplies it directly
// (kernels/subsample.py::fold_subsample_weights).
//
// Rounding points are the TPU kernel's, not K1's: every product accumulates
// in fp32 and rounds to bf16 BEFORE the bf16 bias is added, then GELU on the
// bf16 value rounds once.
//
// What bounds conv1 on the H100: C_in = 1 and 9 taps, so it is bound by
// writing its (B, T1, F1, C) bf16 output (1.31 GB at B=128 x 10 s, 0.40 ms).
// Per output it needs 9 fp32 FMAs, two roundings, a bias add and a GELU, and
// at ~18 instructions an output the issue slots alone take as long as the
// writes, so the design is about instructions per output:
//   * a persistent grid, one block of 16 warps an SM; two warps share an
//     output frame, one for each half of the channels, and lane l of a warp
//     owns 4 consecutive channels, whose 36 taps and biases stay in registers
//     for the whole run (8 channels a lane left the compiler unpacking bf16
//     taps in the loop to stay under 128 registers);
//   * the frame's three mel rows are staged by the warp in shared memory as
//     fp32 (one 16-byte load a lane, the time and frequency padding as
//     zeros); every lane reads the same address, so a 16-byte shared load
//     brings four mel values, two outputs' windows, to all its channels;
//   * the nine FMAs of an output run in (kt, kf) order; the sums round to
//     bf16 in pairs (cvt.rn.bf16x2) and take the bias in one bf16x2 add,
//     which rounds as the fp32 add and second rounding do;
//   * the GELU of a bf16 value is a function of its 16 bits: each block
//     tabulates gelu_erf (common.cuh; gelu_serving under the serving
//     profile), rounded to bf16, for every bf16 of
//     magnitude in [2^-24, 2^8), both signs, in shared memory; one check on
//     the packed pairs of two outputs sends a lane whose values all lie in
//     the table to eight lookups, else each value outside it (zero, tiny,
//     huge, inf, NaN) takes the GELU itself, so the output is the same
//     function bit for bit;
//   * a lane writes its 4 channels as one 8-byte store, a warp 256
//     contiguous bytes.
// What holds it at ~1.35x the byte bound: ~16 issue slots an output and the
// table lookups, whose random banks cost ~3.5 shared-memory cycles a warp's
// lookup (PERF.md, section 6).
// conv2, the one large product of the front end (K = 9*C = 2304), is a
// kernel of its own: conv2.cu.
#include "common.cuh"

namespace {

constexpr int F_MAX = 128;               // mel bins a frame may have
constexpr int C1 = 256;                  // output channels
constexpr int CPL = 4;                   // channels of a lane: the stores below are 8 bytes
constexpr int GROUPS = C1 / (32 * CPL);  // warps that share an output frame, one channel group each
static_assert(CPL == 4, "a lane stores its outputs of a position as one 8-byte word pair");
constexpr int WARPS = 16;                // warps of a block, one block an SM
constexpr int ROW_LD = F_MAX + 4;        // floats of a staged mel row: bin f at f + 4, f = -1 the zero pad
constexpr uint32_t G_LO = 0x3380u;       // bf16 bits of 2^-24
constexpr uint32_t G_N = 0x1000u;        // 32 binades of 128 values: magnitudes in [2^-24, 2^8)
// The table is indexed by d = bits - G_LO: d in [0, G_N) for the positive
// values, [0x8000, 0x8000 + G_N) for the negative ones. Its two halves sit
// 64 KB apart, and the warps' mel rows fill part of the gap.
constexpr uint32_t TABLE_NEG = 0x8000u * 2;  // byte offset of the negative half
constexpr uint32_t STAGE_OFF = G_N * 2;       // byte offset of the warps' mel rows
constexpr uint32_t SMEM_BYTES = TABLE_NEG + G_N * 2;
static_assert(STAGE_OFF + WARPS * 3 * ROW_LD * 4 <= TABLE_NEG, "the mel rows must fit the table's gap");

// The GELU of v rounded to bf16, as bits: gelu_erf, or the serving profile's.
__device__ __forceinline__ uint32_t gelu_bits(float v, int serving) {
    const bf16 y = to_bf(serving ? gelu_serving(v) : gelu_erf(v));
    return *reinterpret_cast<const unsigned short*>(&y);
}

// The table entry at shared-space address `addr`.
__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
    unsigned short v;
    asm("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(addr));
    return v;
}

// The table entries of the low and the high bf16 of a packed pair: base + 2
// bits, two instructions each (written out so that the compiler does not
// turn them into a shift, a mask and an add)
__device__ __forceinline__ uint32_t entry_lo(uint32_t base, uint32_t q) {
    uint32_t a;
    asm("{\n .reg .b32 t;\n and.b32 t, %1, 0xFFFF;\n mad.lo.u32 %0, t, 2, %2;\n}" : "=r"(a) : "r"(q), "r"(base));
    return a;
}
__device__ __forceinline__ uint32_t entry_hi(uint32_t base, uint32_t q) {
    uint32_t a;
    asm("{\n .reg .b32 t;\n shr.u32 t, %1, 16;\n mad.lo.u32 %0, t, 2, %2;\n}" : "=r"(a) : "r"(q), "r"(base));
    return a;
}

// The GELU of the bf16 value with bits `bits`: from the table (its entry for
// bits at base + 2 * bits) where it holds the value, else the GELU itself.
__device__ __forceinline__ uint32_t gelu_of_bits(uint32_t base, uint32_t bits, int serving) {
    return ((bits - G_LO) & 0x7000u) == 0 ? lds_u16(base + 2 * bits)
                                          : gelu_bits(__uint_as_float(bits << 16), serving);
}

// mel: [B, T_in, F] bf16; w1: [9, C1] bf16 ((kt, kf) major); b1: [C1] fp32;
// y1: [B, T1, F1, C1] bf16 with T1 = (T_in - 1) / 2 + 1, F1 = F / 2;
// serving: 1 for the serving profile's GELU.
__global__ void __launch_bounds__(WARPS * 32, 1)
conv1_kernel(const bf16* __restrict__ mel, const bf16* __restrict__ w1, const float* __restrict__ b1,
             bf16* __restrict__ y1, int B, int T_in, int T1, int F, int serving) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned short* tab = reinterpret_cast<unsigned short*>(smem);
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    float* rows = reinterpret_cast<float*>(smem + STAGE_OFF) + warp * 3 * ROW_LD;

    for (uint32_t i = threadIdx.x; i < 2 * G_N; i += blockDim.x) {
        const uint32_t d = i < G_N ? i : 0x8000u + (i - G_N);
        tab[d] = (unsigned short)gelu_bits(__uint_as_float(((G_LO + d) & 0xFFFFu) << 16), serving);
    }
    // this warp's channels: group warp % GROUPS, CPL consecutive ones a lane
    const int c0 = (warp % GROUPS) * 32 * CPL + CPL * lane;
    float w[9][CPL];
    __nv_bfloat162 bias[CPL / 2];
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int j = 0; j < CPL / 2; ++j) {
            const uint32_t u = __ldg(reinterpret_cast<const uint32_t*>(w1 + k * C1 + c0) + j);
            w[k][2 * j] = __uint_as_float(u << 16);
            w[k][2 * j + 1] = __uint_as_float(u & 0xFFFF0000u);
        }
#pragma unroll
    for (int j = 0; j < CPL / 2; ++j)  // b1 holds bf16 values: exact
        bias[j] = __floats2bfloat162_rn(__ldg(b1 + c0 + 2 * j), __ldg(b1 + c0 + 2 * j + 1));
    // the shared-space address at which the entry of the bf16 with bits b sits: base + 2 b
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tab)) - 2 * G_LO;
    if (lane < 3) rows[lane * ROW_LD + 3] = 0.0f;  // bin -1 of each row
    __syncthreads();

    const int F1 = F / 2, pieces = F / 8, frames = B * T1;
    // fr = b * T1 + t1, the index of the output frame; the block's frame slots
    // are WARPS / GROUPS wide
    constexpr int SLOTS = WARPS / GROUPS;
    for (int fr = blockIdx.x * SLOTS + warp / GROUPS; fr < frames; fr += gridDim.x * SLOTS) {
        const int b = fr / T1, t1 = fr - b * T1;
        __syncwarp();  // every lane is done with the previous frame's rows
        for (int p = lane; p < 3 * pieces; p += 32) {
            const int kt = p / pieces, c8 = p - kt * pieces;
            const int t = 2 * t1 + kt - 1;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (t >= 0 && t < T_in) v = __ldg(reinterpret_cast<const uint4*>(mel + ((size_t)b * T_in + t) * F) + c8);
            float4* dst = reinterpret_cast<float4*>(rows + kt * ROW_LD + 4 + 8 * c8);
            dst[0] = make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xFFFF0000u),
                                 __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xFFFF0000u));
            dst[1] = make_float4(__uint_as_float(v.z << 16), __uint_as_float(v.z & 0xFFFF0000u),
                                 __uint_as_float(v.w << 16), __uint_as_float(v.w & 0xFFFF0000u));
        }
        __syncwarp();
        bf16* out = y1 + (size_t)fr * F1 * C1 + c0;
        float prev[3];
#pragma unroll
        for (int kt = 0; kt < 3; ++kt) prev[kt] = rows[kt * ROW_LD + 3];
#pragma unroll 2
        for (int f1 = 0; f1 < F1; f1 += 2) {
            // bins 2 f1 .. 2 f1 + 3: the windows of outputs f1 (bins 2 f1 - 1 .. 2 f1 + 1)
            // and f1 + 1 (bins 2 f1 + 1 .. 2 f1 + 3)
            float x[3][5];
#pragma unroll
            for (int kt = 0; kt < 3; ++kt) {
                const float4 m = *reinterpret_cast<const float4*>(rows + kt * ROW_LD + 4 + 2 * f1);
                x[kt][0] = prev[kt];
                x[kt][1] = m.x;
                x[kt][2] = m.y;
                x[kt][3] = m.z;
                x[kt][4] = m.w;
                prev[kt] = m.w;
            }
            // v = bf16(bf16(acc) + b1) of both outputs as packed pairs: the bf16 add
            // rounds the exact sum once, as rounding the fp32 sum does (it is exact in
            // fp32, or within far less than half a bf16 ulp of it: 24 >= 2 * 8 + 2 bits)
            constexpr int P = CPL / 2;  // packed pairs of an output
            uint32_t q[2 * P], any = 0;
#pragma unroll
            for (int o = 0; o < 2; ++o) {
                float acc[CPL];
#pragma unroll
                for (int j = 0; j < CPL; ++j) {
                    acc[j] = 0.0f;
#pragma unroll
                    for (int kt = 0; kt < 3; ++kt)
#pragma unroll
                        for (int kf = 0; kf < 3; ++kf) acc[j] = fmaf(x[kt][2 * o + kf], w[kt * 3 + kf][j], acc[j]);
                }
#pragma unroll
                for (int j = 0; j < P; ++j) {
                    const __nv_bfloat162 v = __hadd2(__floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]), bias[j]);
                    q[o * P + j] = *reinterpret_cast<const uint32_t*>(&v);
                    // bits 12-14 of each half of q - G_LO are zero where the half is in the
                    // table (a borrow out of the low half only follows a low half outside it)
                    any |= q[o * P + j] - (G_LO | G_LO << 16);
                }
            }
            uint32_t y[2 * P];
            if ((any & 0x70007000u) == 0) {  // all inside the table
#pragma unroll
                for (int j = 0; j < 2 * P; ++j)
                    y[j] = __byte_perm(lds_u16(entry_lo(base, q[j])), lds_u16(entry_hi(base, q[j])), 0x5410);
            } else {
#pragma unroll
                for (int j = 0; j < 2 * P; ++j)
                    y[j] = __byte_perm(gelu_of_bits(base, q[j] & 0xFFFFu, serving),
                                       gelu_of_bits(base, q[j] >> 16, serving), 0x5410);
            }
            // a lane's 4 outputs of each position as one 8-byte store
            *reinterpret_cast<uint2*>(out + (size_t)f1 * C1) = make_uint2(y[0], y[1]);
            *reinterpret_cast<uint2*>(out + (size_t)(f1 + 1) * C1) = make_uint2(y[2], y[3]);
        }
    }
}

}  // namespace

// Takes C == 256 and F % 8 == 0, F <= 128 (the wrapper's tensors are
// contiguous and 16-byte aligned); serving 1 tabulates the serving profile's GELU.
ASR_API int asr_conv1(const void* mel, const void* w1, const void* b1, void* y1, int B, int T_in,
                      int T1, int F, int C, int serving, void* stream) {
    if (C != C1 || F < 8 || F > F_MAX || F % 8 || B < 1 || T_in < 1 || T1 != (T_in - 1) / 2 + 1)
        return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(conv1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long frames = (long long)B * T1;
    if (frames > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    const long long need = (frames + WARPS / GROUPS - 1) / (WARPS / GROUPS);
    const int blocks = need < sms ? (int)need : sms;
    conv1_kernel<<<blocks, WARPS * 32, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(mel), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<bf16*>(y1), B, T_in, T1, F, serving);
    return static_cast<int>(cudaGetLastError());
}
