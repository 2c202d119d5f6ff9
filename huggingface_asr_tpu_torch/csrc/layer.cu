// E-Branchformer layer pieces: the row-major GEMM entry, LayerNorm and the
// positional-query kernel.
//
// Replaces ops/pallas_layer.py::_layer_kernel (via ebranchformer_layer). The
// TPU kernel keeps one whole layer resident in VMEM; Hopper has 227 KB of
// shared memory per block, so the layer is split into a few kernels (see
// kernels/layer.py for the order): GEMMs with fused epilogues (gemm.cuh, on
// wgmma + TMA),
// LayerNorm (here), the positional query (here), the rel-pos attention
// forward (rel_attention.cu) and the two depthwise convs (dwconv.cu).
//
// LayerNorm: a row reduction over D <= 1024 values, memory-bound. One warp
// per row reads the row once for both moments (flax's fast variance
// E[x^2] - mu^2, clipped at 0, as pallas_layer.py::_ln) and writes bf16 once.
//
// Positional query: per (row, head) ce/co = q_v_h @ wp_e/wp_o (K = dh) and
// the rotation [cos*ce + sin*co, cos*co - sin*ce] (pallas_layer.py:489-499).
// Bound by writing q_rot (H x D values per row); a block keeps 32 rows of
// q_v_h in shared memory and each thread one output column, so the weights
// are read once per block and q_rot is written once.
#include "gemm.cuh"

ASR_API const char* asr_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

ASR_API int asr_gemm_bf16(const void* a, const void* b, const void* bias, const void* bias2,
                          void* out, void* out2, const void* res,
                          int M, int N, int K, int lda, int ldb, int ldo, int ldo2, int ldr,
                          int n2, int act, int round_first, float alpha, void* stream) {
    gemm::Epilogue e;
    e.bias = static_cast<const float*>(bias);
    e.bias2 = static_cast<const float*>(bias2);
    e.out = static_cast<bf16*>(out);
    e.out2 = static_cast<bf16*>(out2);
    e.res = static_cast<const bf16*>(res);
    e.ldo = ldo;
    e.ldo2 = ldo2;
    e.ldr = ldr;
    e.n2 = n2;
    e.alpha = alpha;
    e.act = act;
    e.round_first = round_first;
    return gemm::launch(static_cast<const bf16*>(a), lda, static_cast<const bf16*>(b), ldb, M, N, K, e,
                        static_cast<cudaStream_t>(stream));
}

constexpr int LN_ROWS = 8;  // rows (warps) per block

__global__ void __launch_bounds__(32 * LN_ROWS)
layernorm_kernel(const bf16* __restrict__ x, int ldx, const float* __restrict__ g,
                 const float* __restrict__ b, bf16* __restrict__ y, int ldy, int M, int D,
                 float eps) {
    const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= M) return;
    const bf16* xr = x + (size_t)row * ldx;
    float s = 0.0f, ss = 0.0f;
    for (int c = lane; c < D; c += 32) {
        const float v = to_f(xr[c]);
        s += v;
        ss += v * v;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / D;
    const float var = fmaxf(ss / D - mu * mu, 0.0f);
    const float r = rsqrtf(var + eps);
    bf16* yr = y + (size_t)row * ldy;
    for (int c = lane; c < D; c += 32) yr[c] = to_bf((to_f(xr[c]) - mu) * (r * g[c]) + b[c]);
}

ASR_API int asr_layernorm_bf16(const void* x, const void* g, const void* b, void* y, int M,
                               int D, int ldx, int ldy, float eps, void* stream) {
    layernorm_kernel<<<ceil_div(M, LN_ROWS), 32 * LN_ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), ldx, static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<bf16*>(y), ldy, M, D, eps);
    return cudaGetLastError();
}

constexpr int PQ_ROWS = 32;
constexpr int PQ_THREADS = 128;
constexpr int PQ_MAX_DH = 64;

// q_v: [M, ldq] (head h at columns h*dh); wp_e/wp_o: [H, dh, D/2];
// rot_cos/rot_sin: [T, D/2]; q_rot: [M, H, D]. Row m is frame m % T.
__global__ void __launch_bounds__(PQ_THREADS)
pos_query_kernel(const bf16* __restrict__ q_v, int ldq, const bf16* __restrict__ wp_e,
                 const bf16* __restrict__ wp_o, const bf16* __restrict__ rot_cos,
                 const bf16* __restrict__ rot_sin, bf16* __restrict__ q_rot, int M, int T, int H,
                 int dh, int D) {
    __shared__ float qs[PQ_ROWS][PQ_MAX_DH];
    const int m0 = blockIdx.x * PQ_ROWS, h = blockIdx.y;
    const int half = D / 2;
    const int j = blockIdx.z * PQ_THREADS + threadIdx.x;
    for (int i = threadIdx.x; i < PQ_ROWS * dh; i += PQ_THREADS) {
        const int r = i / dh, d = i % dh;
        const int m = m0 + r;
        qs[r][d] = m < M ? to_f(q_v[(size_t)m * ldq + h * dh + d]) : 0.0f;
    }
    __syncthreads();
    if (j >= half) return;
    float ce[PQ_ROWS], co[PQ_ROWS];
#pragma unroll
    for (int r = 0; r < PQ_ROWS; ++r) ce[r] = co[r] = 0.0f;
    for (int d = 0; d < dh; ++d) {
        const float we = to_f(wp_e[((size_t)h * dh + d) * half + j]);
        const float wo = to_f(wp_o[((size_t)h * dh + d) * half + j]);
#pragma unroll
        for (int r = 0; r < PQ_ROWS; ++r) {
            ce[r] = fmaf(qs[r][d], we, ce[r]);
            co[r] = fmaf(qs[r][d], wo, co[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < PQ_ROWS; ++r) {
        const int m = m0 + r;
        if (m >= M) break;
        const int t = m % T;
        const float c = to_f(rot_cos[(size_t)t * half + j]);
        const float s = to_f(rot_sin[(size_t)t * half + j]);
        bf16* o = q_rot + ((size_t)m * H + h) * D;
        o[j] = to_bf(c * ce[r] + s * co[r]);
        o[half + j] = to_bf(c * co[r] - s * ce[r]);
    }
}

ASR_API int asr_pos_query(const void* q_v, const void* wp_e, const void* wp_o,
                          const void* rot_cos, const void* rot_sin, void* q_rot, int M, int T,
                          int H, int dh, int D, int ldq, void* stream) {
    if (dh > PQ_MAX_DH) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(ceil_div(M, PQ_ROWS), H, ceil_div(D / 2, PQ_THREADS));
    pos_query_kernel<<<grid, PQ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q_v), ldq, static_cast<const bf16*>(wp_e),
        static_cast<const bf16*>(wp_o), static_cast<const bf16*>(rot_cos),
        static_cast<const bf16*>(rot_sin), static_cast<bf16*>(q_rot), M, T, H, dh, D);
    return cudaGetLastError();
}
