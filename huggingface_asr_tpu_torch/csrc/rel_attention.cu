// Relative-position attention forward (flash style, online softmax).
//
// Replaces the attention branch of ops/pallas_layer.py::_layer_kernel (and,
// at dropout rate 0, the forward of ops/pallas_train_attention.py::_fwd_kernel
// and ops/pallas_attention.py::_rel_attn_kernel, which compute the same
// scores). The interface is K4's: q_u, k, v as (B, T, H, dh) with a row
// stride, q_rot (B, T, H, D), k_std (T, D), lengths (B,).
//
//   s[t, s'] = [q_u | q_rot][t] . [k | k_std][s']      (one dot of width dh+D)
//            + (s' < len ? 0 : -1e9)                     (finite: a zero-length
//                                                          row stays finite)
//   out[t]   = sum_s' exp2(s - m) v[s'] / sum_s' exp2(s - m)
//
// The 1/sqrt(dh) and log2(e) scales are folded into the query weights
// (kernels/layer.py::fold_layer_weights), so the softmax runs on exp2 and is
// normalised after P.V, as on the TPU.
//
// What bounds it on the H100: at T_pad = 256 the (T, T) score tile of one
// (b, h) fits on chip, but the 30 s bucket (T_pad ~ 752) does not, and the
// score tensor must never reach device memory. One block per (query tile of
// 64, head, batch) walks 64-key tiles with a running max and sum (online
// softmax), so device traffic is Q, K, V, q_rot and k_std once per block plus
// the output. Products run on bf16 wmma fragments with fp32 accumulation;
// the softmax bookkeeping is fp32 in shared memory, one warp per 16 rows.
// Key tiles past an utterance's length are skipped (their probabilities are
// exact zeros); a zero-length row attends uniformly over all T keys, as the
// TPU kernel's -1e9 additive mask gives.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, DH = 32, THREADS = 128;
constexpr int PAD = 8;
constexpr float MASK_NEG = -1.0e9f;

__host__ __device__ inline size_t up(size_t x) { return (x + 127) / 128 * 128; }

// Byte offsets of the shared-memory regions for a dot width kd = dh + D.
struct Smem {
    int kd;
    size_t q, k, v, s, p, o, m, l, a, total;
    __host__ __device__ explicit Smem(int kd_) : kd(kd_) {
        q = 0;
        k = up(q + (size_t)BQ * (kd + PAD) * 2);
        v = up(k + (size_t)BKV * (kd + PAD) * 2);
        s = up(v + (size_t)BKV * (DH + PAD) * 2);
        p = up(s + (size_t)BQ * (BKV + 4) * 4);
        o = up(p + (size_t)BQ * (BKV + PAD) * 2);
        m = up(o + (size_t)BQ * (DH + 4) * 4);
        l = up(m + BQ * 4);
        a = up(l + BQ * 4);
        total = up(a + BQ * 4);
    }
};

// Copy `n` bf16 values (n % 8 == 0, 16-byte aligned both sides) or zeros.
__device__ __forceinline__ void copy_row(bf16* dst, const bf16* src, int n, bool valid, int lane,
                                         int lanes) {
    for (int c = lane * 8; c < n; c += lanes * 8) {
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (valid) val = *reinterpret_cast<const uint4*>(src + c);
        *reinterpret_cast<uint4*>(dst + c) = val;
    }
}

__global__ void __launch_bounds__(THREADS)
rel_attention_kernel(const bf16* __restrict__ q_u, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, int ld_qkv, const bf16* __restrict__ q_rot,
                     const bf16* __restrict__ k_std, const int* __restrict__ lengths,
                     bf16* __restrict__ out, int ld_o, int T, int H, int D) {
    using namespace nvcuda;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int kd = DH + D;
    const Smem L(kd);
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw + L.q);
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L.k);
    bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L.v);
    float* Ss = reinterpret_cast<float*>(smem_raw + L.s);
    bf16* Ps = reinterpret_cast<bf16*>(smem_raw + L.p);
    float* Os = reinterpret_cast<float*>(smem_raw + L.o);
    float* m_s = reinterpret_cast<float*>(smem_raw + L.m);
    float* l_s = reinterpret_cast<float*>(smem_raw + L.l);
    float* a_s = reinterpret_cast<float*>(smem_raw + L.a);
    const int ldk = kd + PAD, ldv = DH + PAD, lds = BKV + 4, ldp = BKV + PAD, ldo_s = DH + 4;

    const int t0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int len = lengths[b];
    const int n_keys = len > 0 ? min(len, T) : T;

    // Q tile: [q_u | q_rot], 16 rows per warp.
    for (int r = warp; r < BQ; r += THREADS / 32) {
        const int t = t0 + r;
        const size_t row = (size_t)b * T + t;
        copy_row(Qs + r * ldk, q_u + row * ld_qkv + h * DH, DH, t < T, lane, 32);
        copy_row(Qs + r * ldk + DH, q_rot + (row * H + h) * D, D, t < T, lane, 32);
    }
    for (int i = threadIdx.x; i < BQ * DH; i += THREADS) Os[(i / DH) * ldo_s + i % DH] = 0.0f;
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
        m_s[i] = -INFINITY;
        l_s[i] = 0.0f;
    }

    const int wr = warp * 16;  // this warp's 16 query rows
    for (int s0 = 0; s0 < n_keys; s0 += BKV) {
        __syncthreads();  // previous tile's K/V reads are done
        for (int r = warp; r < BKV; r += THREADS / 32) {
            const int s = s0 + r;
            const size_t row = (size_t)b * T + s;
            copy_row(Ks + r * ldk, k + row * ld_qkv + h * DH, DH, s < T, lane, 32);
            copy_row(Ks + r * ldk + DH, k_std + (size_t)s * D, D, s < T, lane, 32);
            copy_row(Vs + r * ldv, v + row * ld_qkv + h * DH, DH, s < T, lane, 32);
        }
        __syncthreads();

        // S = Q K^T for this warp's 16 rows x 64 keys.
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BKV / 16];
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(sacc[j], 0.0f);
        for (int kk = 0; kk < kd; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::load_matrix_sync(fa, Qs + wr * ldk + kk, ldk);
#pragma unroll
            for (int j = 0; j < BKV / 16; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
                wmma::load_matrix_sync(fb, Ks + (16 * j) * ldk + kk, ldk);
                wmma::mma_sync(sacc[j], fa, fb, sacc[j]);
            }
        }
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j)
            wmma::store_matrix_sync(Ss + wr * lds + 16 * j, sacc[j], lds, wmma::mem_row_major);
        __syncwarp();

        // Online softmax over this key tile, one row at a time.
        for (int r = wr; r < wr + 16; ++r) {
            float sv[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int c = lane + 32 * u, s = s0 + c;
                float x = Ss[r * lds + c];
                if (s >= T) x = -INFINITY;
                else if (s >= len) x += MASK_NEG;
                sv[u] = x;
            }
            const float m_old = m_s[r];
            const float m_new = fmaxf(m_old, warp_max(fmaxf(sv[0], sv[1])));
            const float e0 = exp2f(sv[0] - m_new), e1 = exp2f(sv[1] - m_new);
            const float rs = warp_sum(e0 + e1);
            Ps[r * ldp + lane] = to_bf(e0);
            Ps[r * ldp + lane + 32] = to_bf(e1);
            __syncwarp();
            if (lane == 0) {
                const float alpha = exp2f(m_old - m_new);
                a_s[r] = alpha;
                l_s[r] = l_s[r] * alpha + rs;
                m_s[r] = m_new;
            }
        }
        __syncwarp();

        // PV for this warp's rows; the product lands in the warp's S rows.
#pragma unroll
        for (int j = 0; j < DH / 16; ++j) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> pacc;
            wmma::fill_fragment(pacc, 0.0f);
#pragma unroll
            for (int kk = 0; kk < BKV; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
                wmma::load_matrix_sync(fa, Ps + wr * ldp + kk, ldp);
                wmma::load_matrix_sync(fb, Vs + kk * ldv + 16 * j, ldv);
                wmma::mma_sync(pacc, fa, fb, pacc);
            }
            wmma::store_matrix_sync(Ss + wr * lds + 16 * j, pacc, lds, wmma::mem_row_major);
        }
        __syncwarp();
        for (int i = lane; i < 16 * DH; i += 32) {
            const int r = wr + i / DH, d = i % DH;
            Os[r * ldo_s + d] = Os[r * ldo_s + d] * a_s[r] + Ss[r * lds + d];
        }
        __syncwarp();
    }

    for (int i = lane; i < 16 * DH; i += 32) {
        const int r = wr + i / DH, d = i % DH;
        const int t = t0 + r;
        if (t < T) {
            out[((size_t)b * T + t) * ld_o + h * DH + d] = to_bf(Os[r * ldo_s + d] * (1.0f / l_s[r]));
        }
    }
}

}  // namespace

ASR_API int asr_rel_attention(const void* q_u, const void* k, const void* v, const void* q_rot,
                              const void* k_std, const void* lengths, void* out, int B, int T,
                              int H, int dh, int D, int ld_qkv, int ld_o, void* stream) {
    if (dh != DH || D % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const Smem L(DH + D);
    cudaError_t err = cudaFuncSetAttribute(rel_attention_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(L.total));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(ceil_div(T, BQ), H, B);
    rel_attention_kernel<<<grid, THREADS, L.total, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q_u), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        ld_qkv, static_cast<const bf16*>(q_rot), static_cast<const bf16*>(k_std),
        static_cast<const int*>(lengths), static_cast<bf16*>(out), ld_o, T, H, D);
    return static_cast<int>(cudaGetLastError());
}
