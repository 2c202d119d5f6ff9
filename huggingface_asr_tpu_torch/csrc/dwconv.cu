// Depthwise convolution along T for the E-Branchformer layer, in two forms.
//
// Replaces `_dwconv` and its callers inside ops/pallas_layer.py::_layer_kernel:
//   CSGU  (mode 0): g = LN(l[:, C:]) over the C gate channels (bf16);
//                   gated = bf16(l[:, :C] * bf16(act(dwconv(g))))
//   merge (mode 1): out = bf16(x + bf16(dwconv(x)))  over all C channels
// with dwconv(x)[t, c] = bias[c] + sum_j x[t + j - P, c] * w[j, c] accumulated
// in fp32, P = (K - 1) / 2, and rows outside [0, t_valid) read as zero — the
// TPU kernel's t_mask, so padding rows of a bucket never reach valid frames.
// Padding rows below t_valid are NOT zeroed per utterance (the encoder zeroes
// them once at its input, as the TPU path does).
//
// What bounds it on the H100: each output reads K = 31 inputs, but the data
// is (B, T, 512) bf16 and memory-bound; a block stages one T tile plus its
// halo of K - 1 rows in shared memory (with the CSGU LayerNorm applied while
// staging, one warp per row), so every input element is read from device
// memory about (TILE + K - 1) / TILE times and every output written once.
#include "common.cuh"

namespace {

constexpr int TILE = 16, THREADS = 256, WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
dwconv_kernel(const bf16* __restrict__ x, int ldx, const float* __restrict__ ln_g,
              const float* __restrict__ ln_b, const bf16* __restrict__ w,
              const float* __restrict__ bias, bf16* __restrict__ out, int T, int t_valid, int C,
              int K, int mode, int act, float eps) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [TILE + K - 1][C]
    const int P = (K - 1) / 2;
    const int win = TILE + K - 1;
    const int t0 = blockIdx.x * TILE, b = blockIdx.y;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int in_off = mode == 0 ? C : 0;  // CSGU convolves the gate half

    for (int wr = warp; wr < win; wr += WARPS) {
        const int t = t0 - P + wr;
        bf16* dst = xs + (size_t)wr * C;
        if (t < 0 || t >= t_valid) {
            for (int c = lane; c < C; c += 32) dst[c] = to_bf(0.0f);
            continue;
        }
        const bf16* src = x + ((size_t)b * T + t) * ldx + in_off;
        if (mode == 0) {
            float s = 0.0f, ss = 0.0f;
            for (int c = lane; c < C; c += 32) {
                const float v = to_f(src[c]);
                s += v;
                ss += v * v;
            }
            s = warp_sum(s);
            ss = warp_sum(ss);
            const float mu = s / C;
            const float r = rsqrtf(fmaxf(ss / C - mu * mu, 0.0f) + eps);
            for (int c = lane; c < C; c += 32) dst[c] = to_bf((to_f(src[c]) - mu) * (r * ln_g[c]) + ln_b[c]);
        } else {
            for (int c = lane; c < C; c += 32) dst[c] = src[c];
        }
    }
    __syncthreads();

    for (int c = threadIdx.x; c < C; c += THREADS) {
        const float bc = bias[c];
        for (int r = 0; r < TILE; ++r) {
            const int t = t0 + r;
            if (t >= T) break;
            float acc = bc;
            for (int j = 0; j < K; ++j) acc = fmaf(to_f(xs[(size_t)(r + j) * C + c]), to_f(w[(size_t)j * C + c]), acc);
            const size_t row = (size_t)b * T + t;
            if (mode == 0) {
                const float gate = round_bf(apply_act(act, acc));
                out[row * C + c] = to_bf(to_f(x[row * ldx + c]) * gate);
            } else {
                out[row * C + c] = to_bf(to_f(x[row * ldx + c]) + round_bf(acc));
            }
        }
    }
}

}  // namespace

// x: [B*T, ldx] bf16. mode 0 (CSGU): x = [x_r | x_g], each C wide, out [B*T, C].
// mode 1 (merge): x is C wide, out [B*T, C]. w: [K, C] bf16; bias: [C] fp32.
ASR_API int asr_dwconv(const void* x, const void* ln_g, const void* ln_b, const void* w,
                       const void* bias, void* out, int B, int T, int t_valid, int C, int K,
                       int ldx, int mode, int act, float eps, void* stream) {
    const size_t smem = (size_t)(TILE + K - 1) * C * sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(dwconv_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(ceil_div(T, TILE), B);
    dwconv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), ldx, static_cast<const float*>(ln_g),
        static_cast<const float*>(ln_b), static_cast<const bf16*>(w),
        static_cast<const float*>(bias), static_cast<bf16*>(out), T, t_valid, C, K, mode, act,
        eps);
    return static_cast<int>(cudaGetLastError());
}
