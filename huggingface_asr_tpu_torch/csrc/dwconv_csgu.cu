// The CSGU forms of the depthwise convolution (design and numeric contract in
// dwconv.cuh): LayerNorm of the gate half, conv, activation and gate; or
// (ungated, a model with the CSGU linear) LayerNorm and conv alone.
#include "dwconv.cuh"

namespace dwconv {

// SPLIT: past MAX_C_CSGU channels, 128-channel slices behind the statistics pass
template <int KP, bool SPLIT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
dwconv_csgu_kernel(const Args a, const __grid_constant__ Maps maps, int TT, int CS) {
    dwconv_body<true, KP, ROWS, SPLIT>(a, maps, TT, CS);
}

template <int KP, bool SPLIT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
dwconv_csgu_conv_kernel(const Args a, const __grid_constant__ Maps maps, int TT, int CS) {
    dwconv_body<true, KP, ROWS, SPLIT, false>(a, maps, TT, CS);
}

template <int KP>
static cudaError_t launch_csgu_k(const Args& a, cudaStream_t stream) {
    if (!a.gated)
        return csgu_split(a) ? launch_tiled(dwconv_csgu_conv_kernel<KP, true>, a, true, KP, stream)
                             : launch_tiled(dwconv_csgu_conv_kernel<KP, false>, a, true, KP, stream);
    return csgu_split(a) ? launch_tiled(dwconv_csgu_kernel<KP, true>, a, true, KP, stream)
                         : launch_tiled(dwconv_csgu_kernel<KP, false>, a, true, KP, stream);
}

cudaError_t launch_csgu(const Args& a, cudaStream_t stream) {
    switch (padded_k(a.K)) {
        case 7: return launch_csgu_k<7>(a, stream);
        case 31: return launch_csgu_k<31>(a, stream);
        default: return launch_csgu_k<33>(a, stream);
    }
}

}  // namespace dwconv
