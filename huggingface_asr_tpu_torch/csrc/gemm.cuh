// bf16 x bf16 -> fp32-accumulated tiled GEMM with a fused epilogue.
//
// Replaces the `_mm` / `jnp.dot(..., preferred_element_type=f32)` products
// inside the TPU kernels ops/pallas_layer.py::_layer_kernel (FF1/FF2 in and
// out, Q/K/V, output projection, cgMLP proj1/proj2, merge_proj) and
// ops/pallas_subsample.py::_subsample_kernel (out-dense, projection; conv2,
// the one compute-bound product, has its own wgmma kernel in conv2.cu).
//
// On the H100 these products are small (K <= 5120, N <= 1024) and the layer
// is memory-bound at D=256: what bounds a GEMM here is reading A and writing
// C, not tensor-core rate. The design keeps it simple and right: 64x64x32
// block tiles, four warps of 32x32 each on `nvcuda::wmma` bf16 fragments
// (mma.sync underneath), and an epilogue that applies bias, activation and
// residual in fp32 on the accumulator tile before ONE bf16 write, so no
// intermediate makes an extra round trip through device memory.
// wgmma/TMA pipelining is later work.
//
// A is read through a loader functor (row-major today).
//
// Rounding points (one numeric contract, the TPU kernels'):
//   round_first = 0 (K1's `_mm`):        v = bf16(acc + bias)
//   round_first = 1 (K2's conv/dense):   v = bf16(bf16(acc) + bias)
//   then, if act:      v = bf16(act(v))
//   then, if residual: v = bf16(res + alpha * v)
//   dual output (Q):   out2 = bf16(acc + bias2) for columns < n2
#pragma once

#include <mma.h>

#include "common.cuh"

namespace gemm {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int APAD = 8, BPAD = 8, CPAD = 4;
constexpr int THREADS = 128;

struct Epilogue {
    const float* bias;   // [N] or null
    const float* bias2;  // [n2] or null
    bf16* out;           // [M, ldo]
    bf16* out2;          // [M, ldo2] or null
    const bf16* res;     // [M, ldr] or null
    int ldo, ldo2, ldr, n2;
    float alpha;
    int act;
    int round_first;
};

struct RowMajorA {
    const bf16* a;
    int lda;
    __device__ __forceinline__ uint4 load(int m, int k) const {
        return *reinterpret_cast<const uint4*>(a + (size_t)m * lda + k);
    }
};

template <class Loader>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(Loader A, const bf16* __restrict__ B, int ldb, int M, int N, int K, Epilogue e) {
    using namespace nvcuda;
    __shared__ __align__(128) bf16 As[BM][BK + APAD];
    __shared__ __align__(128) bf16 Bs[BK][BN + BPAD];
    __shared__ __align__(128) float Cs[BM][BN + CPAD];

    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < K; k0 += BK) {
        for (int i = threadIdx.x; i < BM * (BK / 8); i += THREADS) {
            const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
            const int m = m0 + r;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (m < M) v = A.load(m, k0 + c);
            *reinterpret_cast<uint4*>(&As[r][c]) = v;
        }
        for (int i = threadIdx.x; i < BK * (BN / 8); i += THREADS) {
            const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
            *reinterpret_cast<uint4*>(&Bs[r][c]) =
                *reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * ldb + n0 + c);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[wm + 16 * i][kk], BK + APAD);
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], &Bs[kk][wn + 16 * j], BN + BPAD);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j], BN + CPAD,
                                    wmma::mem_row_major);
    __syncthreads();

    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
        const int r = i / BN, c = i % BN;
        const int m = m0 + r, n = n0 + c;
        if (m >= M) continue;
        const float a = Cs[r][c];
        if (e.out2 != nullptr && n < e.n2)
            e.out2[(size_t)m * e.ldo2 + n] = to_bf(a + e.bias2[n]);
        const float b = e.bias ? e.bias[n] : 0.0f;
        float v = e.round_first ? round_bf(round_bf(a) + b) : round_bf(a + b);
        if (e.act != ACT_IDENTITY) v = round_bf(apply_act(e.act, v));
        if (e.res != nullptr) v = to_f(e.res[(size_t)m * e.ldr + n]) + e.alpha * v;
        e.out[(size_t)m * e.ldo + n] = to_bf(v);
    }
}

// Shape contract checked by the Python wrapper: N % BN == 0, K % BK == 0,
// lda/ldb multiples of 8 and 16-byte aligned base pointers.
template <class Loader>
cudaError_t launch(const Loader& A, const bf16* B, int ldb, int M, int N, int K,
                   const Epilogue& e, cudaStream_t stream) {
    dim3 grid(N / BN, ceil_div(M, BM));
    gemm_kernel<Loader><<<grid, THREADS, 0, stream>>>(A, B, ldb, M, N, K, e);
    return cudaGetLastError();
}

}  // namespace gemm
