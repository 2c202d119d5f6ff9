// The merge form of the depthwise convolution and the C entry of both forms
// (design and numeric contract in dwconv.cuh; the CSGU kernels are in
// dwconv_csgu.cu).
#include "dwconv.cuh"

namespace dwconv {

template <int KP>
__global__ void __launch_bounds__(MAX_THREADS, 1)
dwconv_merge_kernel(const Args a, const __grid_constant__ Maps maps, int TT, int CS) {
    dwconv_body<false, KP, ROWS>(a, maps, TT, CS);
}

template <int KP>
static cudaError_t launch_merge_k(const Args& a, cudaStream_t stream) {
    return launch_tiled(dwconv_merge_kernel<KP>, a, false, KP, stream);
}

cudaError_t launch_merge(const Args& a, cudaStream_t stream) {
    switch (padded_k(a.K)) {
        case 7: return launch_merge_k<7>(a, stream);
        case 31: return launch_merge_k<31>(a, stream);
        default: return launch_merge_k<33>(a, stream);
    }
}

}  // namespace dwconv

// x: [B*T rows, row stride ldx] bf16. mode 0 (CSGU) and 2 (CSGU, ungated:
// bf16(dwconv(LN(x_g))), no activation and no gate): x = [x_r | x_g], each C
// wide; mode 1 (merge): x is C wide. out [B*T, C]; w: [K, C] bf16; bias,
// ln_g, ln_b: [C] fp32. K odd, at most 33; C and ldx multiples of 8, C at
// most 1024 (both forms; CSGU past 768 also needs `stats`, [B*T] float2
// scratch, and C % 128 == 0); every pointer 16-byte aligned
// (kernels/layer.py::dwconv_contract).
ASR_API int asr_dwconv(const void* x, const void* ln_g, const void* ln_b, const void* w,
                       const void* bias, void* out, void* stats, int B, int T, int t_valid, int C, int K,
                       int ldx, int mode, int act, float eps, void* stream) {
    const bool csgu = mode != 1;
    const int max_c = csgu ? dwconv::MAX_C_CSGU_SPLIT : dwconv::MAX_C_MERGE;
    const bool split = csgu && C > dwconv::MAX_C_CSGU;
    if (mode < 0 || mode > 2 || K < 1 || K > dwconv::MAX_K || K % 2 == 0 || C < 8 || C % 8 || C > max_c ||
        ldx % 8 || ldx < (csgu ? 2 * C : C) || B < 1 || T < 1 ||
        (split && (stats == nullptr || C % dwconv::BOX)))
        return static_cast<int>(cudaErrorInvalidValue);
    const dwconv::Args a{static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
                         static_cast<const float*>(ln_b), static_cast<const bf16*>(w),
                         static_cast<const float*>(bias), static_cast<bf16*>(out),
                         ldx, B, T, t_valid, C, K, act, eps, static_cast<float2*>(stats), mode == 0 ? 1 : 0};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(csgu ? dwconv::launch_csgu(a, s) : dwconv::launch_merge(a, s));
}
