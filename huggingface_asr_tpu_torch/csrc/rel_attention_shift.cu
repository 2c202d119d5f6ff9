// Relative-position attention for INFERENCE, shift form.
//
// Replaces ops/pallas_attention.py::_rel_attn_kernel of the JAX package:
//
//   S[t, s] = (q_u[t] . k[s] + q_v[t] . pos[t - s + T - 1, h]) / sqrt(dh)
//   S[:, s >= length] := -1e9;  P = softmax(S) in fp32, rounded;  out = P v
//
// The TPU kernel multiplies q_v against the whole reversed (2T, dh) table and
// barrel-shifts every row by log2(T) masked rolls, because a per-row lane
// offset does not lower there. On the GPU a per-row offset is an index: for a
// (query tile, key tile) pair the table rows t - s + T - 1 form one
// contiguous band of 2*TILE - 1 rows. The block stages that band for its
// head, takes G = q_v band^T (a K = dh product of width 2*TILE) and reads
// the positional score of (t, s) at G[t - t0][(t - t0) - (s - s0) + TILE - 1].
// So the positional term stays a K = 32 product (the factored form pays
// K = 256 for it).
//
// Block = (query tile, head, batch); two passes over the key tiles, as the
// training forward: row max and sum first, then P = exp(S - m) / l rounded
// to the element type and out += P v. Nothing quadratic reaches device
// memory. Bound by bytes on the H100 (q_u, q_v, k, v, out once each; the
// table is small and cached).
//
// This file holds the entry point and the fp32 kernel: exact FMA loops out of
// padded shared memory, which hold the logic to the plain version at fp32
// tolerance. bf16 inputs run rel_attention_shift_bf16.cu (wgmma + TMA).
#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename E, int DH>
struct ShiftSmem {
    size_t qu, qv, k, v, band, g, s, p, o, total;
    int ldv, ldg, lds, ldp, ldo;
    __host__ __device__ ShiftSmem() {
        constexpr int BT = Tile<E>::B, V = 16 / (int)sizeof(E);
        ldv = DH + V; ldg = 2 * BT + 4; lds = BT + 4; ldp = BT + V; ldo = DH + 4;
        qu = 0;
        qv = up128(qu + (size_t)BT * ldv * sizeof(E));
        k = up128(qv + (size_t)BT * ldv * sizeof(E));
        v = up128(k + (size_t)BT * ldv * sizeof(E));
        band = up128(v + (size_t)BT * ldv * sizeof(E));
        g = up128(band + (size_t)2 * BT * ldv * sizeof(E));
        s = up128(g + (size_t)BT * ldg * 4);
        p = up128(s + (size_t)BT * lds * 4);
        o = up128(p + (size_t)BT * ldp * sizeof(E));
        total = up128(o + (size_t)BT * ldo * 4);
    }
};

template <typename E, int DH>
__device__ __forceinline__ void load_tile(E* dst, int ld, const E* src, size_t stride, int r0,
                                          int lo, int hi, int rows, int warp, int n_warps, int lane) {
    for (int r = warp; r < rows; r += n_warps) {
        const int t = r0 + r;
        const bool valid = t >= lo && t < hi;
        copy_row<E>(dst + (size_t)r * ld, src + (size_t)(valid ? t : 0) * stride, DH, valid, lane);
    }
}

// (instantiated for fp32 only; bf16 runs shift_fwd_bf16)
template <typename E, int DH>
__global__ void __launch_bounds__(Tile<E>::B * 2)
shift_attention_kernel(const E* __restrict__ q_u, const E* __restrict__ q_v,
                       const E* __restrict__ k, const E* __restrict__ v,
                       const E* __restrict__ pos, const int* __restrict__ lengths,
                       E* __restrict__ out, int T, int H, float scale) {
    constexpr int BT = Tile<E>::B, NW = BT / 16;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const ShiftSmem<E, DH> L;
    E* Qu = reinterpret_cast<E*>(smem_raw + L.qu);
    E* Qv = reinterpret_cast<E*>(smem_raw + L.qv);
    E* Ks = reinterpret_cast<E*>(smem_raw + L.k);
    E* Vs = reinterpret_cast<E*>(smem_raw + L.v);
    E* Band = reinterpret_cast<E*>(smem_raw + L.band);
    float* Gs = reinterpret_cast<float*>(smem_raw + L.g);
    float* Ss = reinterpret_cast<float*>(smem_raw + L.s);
    E* Ps = reinterpret_cast<E*>(smem_raw + L.p);
    float* Os = reinterpret_cast<float*>(smem_raw + L.o);

    const int t0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wr = warp * 16;
    const int len = lengths[b];
    const int n_keys = visited_keys(len, T);
    const size_t hs = (size_t)H * DH;
    const size_t base = (size_t)b * T * hs + (size_t)h * DH;

    load_tile<E, DH>(Qu, L.ldv, q_u + base, hs, t0, 0, T, BT, warp, NW, lane);
    load_tile<E, DH>(Qv, L.ldv, q_v + base, hs, t0, 0, T, BT, warp, NW, lane);
    for (int i = threadIdx.x; i < BT * DH; i += NW * 32) Os[(i / DH) * L.ldo + i % DH] = 0.0f;

    float m[16], l[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.0f;
    }

    for (int pass = 0; pass < 2; ++pass) {
        for (int s0 = 0; s0 < n_keys; s0 += BT) {
            __syncthreads();
            load_tile<E, DH>(Ks, L.ldv, k + base, hs, s0, 0, T, BT, warp, NW, lane);
            if (pass == 1) load_tile<E, DH>(Vs, L.ldv, v + base, hs, s0, 0, T, BT, warp, NW, lane);
            // band row j is table row (t0 - s0 - (BT - 1) + T - 1) + j of head h
            load_tile<E, DH>(Band, L.ldv, pos + (size_t)h * DH, hs, t0 - s0 - (BT - 1) + T - 1, 0,
                         2 * T - 1, 2 * BT, warp, NW, lane);
            __syncthreads();
            warp_mm<false, true, false>(Ss + wr * L.lds, L.lds, Qu + wr * L.ldv, L.ldv, Ks, L.ldv,
                                        DH, BT / 16);
            warp_mm<false, true, false>(Gs + wr * L.ldg, L.ldg, Qv + wr * L.ldv, L.ldv, Band,
                                        L.ldv, DH, 2 * BT / 16);
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const int r = wr + i;
                const float* srow = Ss + r * L.lds;
                const float* grow = Gs + r * L.ldg + r + BT - 1;  // grow[-c] is column c's term
                if (pass == 0) {
                    float mx = -INFINITY;
                    for (int c = lane; c < BT; c += 32)
                        mx = fmaxf(mx, masked_score(srow[c] + grow[-c], scale, s0 + c, len, T));
                    const float m_new = fmaxf(m[i], warp_max(mx));
                    float sum = 0.0f;
                    for (int c = lane; c < BT; c += 32)
                        sum += expf(masked_score(srow[c] + grow[-c], scale, s0 + c, len, T) - m_new);
                    l[i] = l[i] * expf(m[i] - m_new) + warp_sum(sum);
                    m[i] = m_new;
                } else {
                    for (int c = lane; c < BT; c += 32) {
                        const float x = masked_score(srow[c] + grow[-c], scale, s0 + c, len, T);
                        Ps[r * L.ldp + c] = from_float<E>(expf(x - m[i]) / l[i]);
                    }
                }
            }
            if (pass == 1) {
                __syncwarp();
                warp_mm<false, false, true>(Os + wr * L.ldo, L.ldo, Ps + wr * L.ldp, L.ldp, Vs,
                                            L.ldv, BT, DH / 16);
            }
        }
    }

    for (int i = lane; i < 16 * DH; i += 32) {
        const int r = wr + i / DH, d = i % DH, t = t0 + r;
        if (t < T) out[base + (size_t)t * hs + d] = from_float<E>(Os[r * L.ldo + d]);
    }
}

template <typename E, int DH>
int run(const void* q_u, const void* q_v, const void* k, const void* v, const void* pos,
        const void* lengths, void* out, int B, int T, int H, float scale, cudaStream_t stream) {
    constexpr int BT = Tile<E>::B;
    const ShiftSmem<E, DH> L;
    if (L.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(shift_attention_kernel<E, DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(T, BT), H, B);
    shift_attention_kernel<E, DH><<<grid, BT * 2, L.total, stream>>>(
        (const E*)q_u, (const E*)q_v, (const E*)k, (const E*)v, (const E*)pos, (const int*)lengths,
        (E*)out, T, H, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q_u, q_v, k, v, out: (B, T, H, dh) contiguous; pos: (2T - 1, H, dh); lengths: (B,) int32.
// dh = 32 or 64 (the wrapper pads other head sizes with zero columns).
ASR_API int asr_rel_attention_shift(const void* q_u, const void* q_v, const void* k, const void* v,
                                    const void* pos, const void* lengths, void* out, int B, int T,
                                    int H, int dh, int is_bf16, float scale, void* stream) {
    if (T < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_head_width(dh, [&](auto head) {
        constexpr int DH = decltype(head)::value;
        return is_bf16 ? shift_fwd_bf16<DH>(q_u, q_v, k, v, pos, lengths, out, B, T, H, scale, st)
                       : run<float, DH>(q_u, q_v, k, v, pos, lengths, out, B, T, H, scale, st);
    });
}
