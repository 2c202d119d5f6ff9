// Conv subsampler: conv1 (direct) and conv2 (implicit GEMM).
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
// What bounds it on the H100: conv1 has C_in = 1 and 9 taps, so it is bound
// by writing its (B, T1, F1, C) bf16 output; a block per (frame, utterance)
// stages three mel rows in shared memory and each thread writes one channel
// across all 40 frequency groups. conv2 is the one large product of the
// front end (K = 9*C = 2304); it runs on the GEMM core with a loader that
// gathers each 8-channel vector of the 3x3 neighbourhood straight from
// conv1's output, so no im2col tensor (about 3 GB of bf16 at B=128 x 10 s)
// is ever written.
#include "gemm.cuh"

namespace {

constexpr int F_MAX = 128;

// mel: [B, T_in, F] bf16; w1: [9, C] bf16 ((kt, kf) major); b1: [C] fp32;
// y1: [B, T1, F1, C] bf16 with T1 = (T_in - 1) / 2 + 1, F1 = F / 2.
__global__ void conv1_kernel(const bf16* __restrict__ mel, const bf16* __restrict__ w1,
                             const float* __restrict__ b1, bf16* __restrict__ y1, int T_in,
                             int T1, int F, int C) {
    __shared__ float rows[3][F_MAX + 2];
    const int t1 = blockIdx.x, b = blockIdx.y;
    const int F1 = F / 2;
    for (int i = threadIdx.x; i < 3 * (F + 2); i += blockDim.x) {
        const int kt = i / (F + 2), f = i % (F + 2) - 1;
        const int t = 2 * t1 + kt - 1;
        float v = 0.0f;
        if (t >= 0 && t < T_in && f >= 0 && f < F) v = to_f(mel[((size_t)b * T_in + t) * F + f]);
        rows[kt][f + 1] = v;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        float w[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) w[i] = to_f(w1[(size_t)i * C + c]);
        const float bc = b1[c];
        bf16* dst = y1 + ((size_t)b * T1 + t1) * F1 * C + c;
        for (int f1 = 0; f1 < F1; ++f1) {
            float acc = 0.0f;
#pragma unroll
            for (int kt = 0; kt < 3; ++kt)
#pragma unroll
                for (int kf = 0; kf < 3; ++kf)
                    acc = fmaf(rows[kt][2 * f1 + kf], w[kt * 3 + kf], acc);
            const float v = round_bf(round_bf(acc) + bc);
            dst[(size_t)f1 * C] = to_bf(gelu_erf(v));
        }
    }
}

// A[m, k] of conv2 as an implicit GEMM: m = (b*T2 + t2)*F2 + f2,
// k = (kt*3 + kf)*C + c, reading y1[b, 2*t2 + kt - 1, 2*f2 + kf - 1, c]
// (zero outside the conv1 output: the conv's padding).
struct Conv2Loader {
    const bf16* y1;
    int T1, F1, C, T2, F2;
    __device__ __forceinline__ uint4 load(int m, int k) const {
        const int f2 = m % F2, bt = m / F2;
        const int t2 = bt % T2, b = bt / T2;
        const int tap = k / C, c = k % C;
        const int t1 = 2 * t2 + tap / 3 - 1, f1 = 2 * f2 + tap % 3 - 1;
        if (t1 < 0 || t1 >= T1 || f1 < 0 || f1 >= F1) return make_uint4(0u, 0u, 0u, 0u);
        return *reinterpret_cast<const uint4*>(y1 + (((size_t)b * T1 + t1) * F1 + f1) * C + c);
    }
};

}  // namespace

ASR_API int asr_conv1(const void* mel, const void* w1, const void* b1, void* y1, int B, int T_in,
                      int T1, int F, int C, void* stream) {
    if (F > F_MAX || F % 2) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(T1, B);
    conv1_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(mel), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<bf16*>(y1), T_in, T1, F, C);
    return static_cast<int>(cudaGetLastError());
}

// y2[B*T2*F2, C] = GELU(bf16(bf16(conv2(y1)) + b2)); w2: [9*C, C] bf16.
ASR_API int asr_conv2(const void* y1, const void* w2, const void* b2, void* y2, int B, int T1,
                      int F1, int C, int T2, int F2, void* stream) {
    Conv2Loader A{static_cast<const bf16*>(y1), T1, F1, C, T2, F2};
    gemm::Epilogue e{};
    e.bias = static_cast<const float*>(b2);
    e.out = static_cast<bf16*>(y2);
    e.ldo = C;
    e.act = ACT_GELU;
    e.round_first = 1;
    return static_cast<int>(gemm::launch(A, static_cast<const bf16*>(w2), C, B * T2 * F2, C,
                                         9 * C, e, static_cast<cudaStream_t>(stream)));
}
