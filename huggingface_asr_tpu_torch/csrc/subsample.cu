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
// What bounds it on the H100: conv1 has C_in = 1 and 9 taps, so it is bound
// by writing its (B, T1, F1, C) bf16 output; a block per (frame, utterance)
// stages three mel rows in shared memory and each thread writes one channel
// across all 40 frequency groups. conv2, the one large product of the front
// end (K = 9*C = 2304), is a kernel of its own: conv2.cu.
#include "common.cuh"

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
