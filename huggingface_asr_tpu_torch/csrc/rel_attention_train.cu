// Relative-position attention for TRAINING: forward and backward kernels.
//
// Replaces ops/pallas_train_attention.py::_fwd_kernel and ::_bwd_kernel of
// the JAX package:
//
//   S  = ([q_u | q_rot] . [k | k_std]) / sqrt(dh)     one dot of width dh + D
//   S[:, s >= length] := -1e9                          replaced, not added
//   P  = softmax(S) in fp32, rounded to the element type
//   Pd = keep ? round(P * round(1 / (1 - rate))) : 0   keep from the counter hash
//   out = Pd v
//
//   dv = Pd^T dO;  dP = keep ? (dO v^T) / (1 - rate) : 0
//   dS = P32 (dP - rowsum(dP P32)) / sqrt(dh), rounded to the element type
//   dq_u = dS k;  dq_rot = dS k_std;  dk = dS^T q_u
//
// The TPU kernels keep the whole (T, T) matrices of all heads of a batch row
// in VMEM (grid (B,)). A Hopper block has 227 KB of shared memory, so here
// nothing quadratic exists anywhere: every kernel owns one tile of rows and
// walks the other direction in tiles, recomputing S from the inputs.
//
//   forward   bf16: rel_attention_train_fwd.cu (wgmma, TMA ring, softmax in
//             registers). fp32, below: block = (query tile, head, batch).
//             Pass A walks the key tiles for the row max m and sum l (saved,
//             fp32, for the backward); pass B walks them again, forms
//             P = exp(S - m) / l exactly as the plain version does, rounds,
//             drops, and accumulates Pd v. Both forwards walk twice: a second
//             S product keeps the TPU kernel's rounding points (P is rounded
//             before the dropout scale). The fp32 forward is exact FMA loops
//             on 32-row tiles: slow, and there to hold the logic to the plain
//             version at fp32 tolerance.
//   backward  bf16: rel_attention_train_bwd.cu (wgmma, TMA rings, dS and Pd
//             formed on the accumulator fragment). fp32, below:
//   dq pass   block = (query tile, head, batch). Pass 0 walks the key tiles
//             for delta = rowsum(dP P32) over the fp32 P and the masked,
//             scaled dP, as the TPU kernel takes it (written out for the dkv
//             pass); pass 1 walks them again and accumulates
//             [dq_u | dq_rot] += dS [k | k_std] in shared memory (fp32).
//             [k | k_std] of a key tile comes through one buffer in chunks of
//             KC columns, twice in pass 1: S summed over the chunks in column
//             order (the same fma chain as one product over the whole width),
//             then each chunk's columns of the accumulator. So only the
//             [q_u | q_rot] tile and the accumulator grow with the width: at
//             dh 64 + q_rot 512 the pass holds 196,992 bytes where a resident
//             [k | k_std] tile would need 253,952 (more than a block has).
//   dkv pass  block = (key tile, head, batch), walks the query tiles and
//             accumulates dv += Pd^T dO and dk += dS^T q_u.
//
// The kernels of this file are instantiated for fp32 only: exact FMA loops on
// 32-row tiles out of padded shared memory, S recomputed three times in the
// backward, at any q_rot up to 512 columns. They are slow by design: fp32
// training (--dtype float32) runs them; what bounds the bf16 kernels is said
// in their own files.
#include "attention_common.cuh"

namespace {

using namespace attn;

// Load columns [c0, c0 + w) of `rows` rows of [a | b] (a of width na) starting at row r0.
template <typename E>
__device__ __forceinline__ void load_cat_cols(E* dst, int ld, const E* a, size_t a_stride, int na,
                                              const E* b, size_t b_stride, int c0, int w, int r0, int T,
                                              int rows, int warp, int n_warps, int lane) {
    const int wa = max(0, min(na - c0, w));  // the columns that come from a
    for (int r = warp; r < rows; r += n_warps) {
        const int t = r0 + r;
        if (wa > 0) copy_row<E>(dst + (size_t)r * ld, a + (size_t)t * a_stride + c0, wa, t < T, lane);
        if (wa < w)
            copy_row<E>(dst + (size_t)r * ld + wa, b + (size_t)t * b_stride + (c0 + wa - na), w - wa, t < T, lane);
    }
}

// ---------------------------------------------------------------------------
// forward (instantiated for fp32 only; bf16 runs train_fwd_bf16)

template <typename E, int DH>
struct FwdSmem {
    size_t q, k, v, s, p, o, total;
    int ldk, ldv, lds, ldp, ldo;
    __host__ __device__ explicit FwdSmem(int kd) {
        constexpr int BT = Tile<E>::B, V = 16 / (int)sizeof(E);
        ldk = kd + V; ldv = DH + V; lds = BT + 4; ldp = BT + V; ldo = DH + 4;
        q = 0;
        k = up128(q + (size_t)BT * ldk * sizeof(E));
        v = up128(k + (size_t)BT * ldk * sizeof(E));
        s = up128(v + (size_t)BT * ldv * sizeof(E));
        p = up128(s + (size_t)BT * lds * 4);
        o = up128(p + (size_t)BT * ldp * sizeof(E));
        total = up128(o + (size_t)BT * ldo * 4);
    }
};

template <typename E, int DH>
__global__ void __launch_bounds__(Tile<E>::B * 2)
train_fwd_kernel(const E* __restrict__ q_u, const E* __restrict__ q_rot, const E* __restrict__ k,
                 const E* __restrict__ v, const E* __restrict__ k_std,
                 const int* __restrict__ lengths, E* __restrict__ out, float* __restrict__ stats,
                 int B, int T, int H, int D, float scale, DropoutArgs drop) {
    constexpr int BT = Tile<E>::B, NW = BT / 16;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int kd = DH + D;
    const FwdSmem<E, DH> L(kd);
    E* Qs = reinterpret_cast<E*>(smem_raw + L.q);
    E* Ks = reinterpret_cast<E*>(smem_raw + L.k);
    E* Vs = reinterpret_cast<E*>(smem_raw + L.v);
    float* Ss = reinterpret_cast<float*>(smem_raw + L.s);
    E* Ps = reinterpret_cast<E*>(smem_raw + L.p);
    float* Os = reinterpret_cast<float*>(smem_raw + L.o);

    const int t0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wr = warp * 16;
    const int len = lengths[b];
    const int n_keys = visited_keys(len, T);
    const size_t hs = (size_t)H * DH, rs = (size_t)H * D;  // row strides of (B,T,H,dh), (B,T,H,D)
    const E* qu_b = q_u + (size_t)b * T * hs + (size_t)h * DH;
    const E* qr_b = q_rot + (size_t)b * T * rs + (size_t)h * D;
    const E* k_b = k + (size_t)b * T * hs + (size_t)h * DH;
    const E* v_b = v + (size_t)b * T * hs + (size_t)h * DH;

    load_cat_cols<E>(Qs, L.ldk, qu_b, hs, DH, qr_b, rs, 0, kd, t0, T, BT, warp, NW, lane);
    for (int i = threadIdx.x; i < BT * DH; i += NW * 32) Os[(i / DH) * L.ldo + i % DH] = 0.0f;

    float m[16], l[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.0f;
    }

    // pass A: row max and sum over all visited keys
    for (int s0 = 0; s0 < n_keys; s0 += BT) {
        __syncthreads();
        load_cat_cols<E>(Ks, L.ldk, k_b, hs, DH, k_std, (size_t)D, 0, kd, s0, T, BT, warp, NW, lane);
        __syncthreads();
        warp_mm<false, true, false>(Ss + wr * L.lds, L.lds, Qs + (size_t)wr * L.ldk, L.ldk, Ks,
                                    L.ldk, kd, BT / 16);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const float* row = Ss + (wr + i) * L.lds;
            float mx = -INFINITY;
            for (int c = lane; c < BT; c += 32)
                mx = fmaxf(mx, masked_score(row[c], scale, s0 + c, len, T));
            const float m_new = fmaxf(m[i], warp_max(mx));
            float sum = 0.0f;
            for (int c = lane; c < BT; c += 32)
                sum += expf(masked_score(row[c], scale, s0 + c, len, T) - m_new);
            l[i] = l[i] * expf(m[i] - m_new) + warp_sum(sum);
            m[i] = m_new;
        }
    }
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int t = t0 + wr + i;
            if (t < T) {
                const size_t at = ((size_t)b * H + h) * T + t;
                stats[at] = m[i];
                stats[(size_t)B * H * T + at] = l[i];
            }
        }
    }

    // pass B: P = exp(S - m) / l, rounded, dropped; out += Pd v
    const uint32_t key = dropout_key(drop.seed, drop.row0 + b, h, H);
    const float inv_keep_e = round_to<E>(drop.inv_keep);
    for (int s0 = 0; s0 < n_keys; s0 += BT) {
        __syncthreads();
        load_cat_cols<E>(Ks, L.ldk, k_b, hs, DH, k_std, (size_t)D, 0, kd, s0, T, BT, warp, NW, lane);
        load_cat_cols<E>(Vs, L.ldv, v_b, hs, DH, v_b, hs, 0, DH, s0, T, BT, warp, NW, lane);
        __syncthreads();
        warp_mm<false, true, false>(Ss + wr * L.lds, L.lds, Qs + (size_t)wr * L.ldk, L.ldk, Ks,
                                    L.ldk, kd, BT / 16);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int r = wr + i, t = t0 + r;
            for (int c = lane; c < BT; c += 32) {
                const int s = s0 + c;
                const float x = masked_score(Ss[r * L.lds + c], scale, s, len, T);
                float p = round_to<E>(expf(x - m[i]) / l[i]);
                if (drop.enabled)
                    p = dropout_keep(key, t, s, T, drop.thresh) ? round_to<E>(p * inv_keep_e) : 0.0f;
                Ps[r * L.ldp + c] = from_float<E>(p);
            }
        }
        __syncwarp();
        warp_mm<false, false, true>(Os + wr * L.ldo, L.ldo, Ps + (size_t)wr * L.ldp, L.ldp, Vs,
                                    L.ldv, BT, DH / 16);
    }

    for (int i = lane; i < 16 * DH; i += 32) {
        const int r = wr + i / DH, d = i % DH, t = t0 + r;
        if (t < T) out[((size_t)b * T + t) * hs + (size_t)h * DH + d] = from_float<E>(Os[r * L.ldo + d]);
    }
}

// ---------------------------------------------------------------------------
// backward, dq pass (instantiated for fp32 only; bf16 runs train_bwd_bf16)

template <typename E, int DH>
struct DqSmem {
    static constexpr int KC = 128;  // columns of [k | k_std] a chunk
    size_t q, kc, v, dO, s, d, ds, acc, st, total;
    int ldq, ldkc, ldv, lds, ldp, lda;
    __host__ __device__ explicit DqSmem(int kd) {
        constexpr int BT = Tile<E>::B, V = 16 / (int)sizeof(E);
        ldq = kd + V; ldkc = KC + V; ldv = DH + V; lds = BT + 4; ldp = BT + V; lda = kd + 4;
        q = 0;
        kc = up128(q + (size_t)BT * ldq * sizeof(E));
        v = up128(kc + (size_t)BT * ldkc * sizeof(E));
        dO = up128(v + (size_t)BT * ldv * sizeof(E));
        s = up128(dO + (size_t)BT * ldv * sizeof(E));
        d = up128(s + (size_t)BT * lds * 4);
        ds = up128(d + (size_t)BT * lds * 4);
        acc = up128(ds + (size_t)BT * ldp * sizeof(E));
        st = up128(acc + (size_t)BT * lda * 4);
        total = up128(st + (size_t)3 * BT * 4);
    }
};

template <typename E, int DH>
__global__ void __launch_bounds__(Tile<E>::B * 2)
train_bwd_dq_kernel(const E* __restrict__ q_u, const E* __restrict__ q_rot,
                    const E* __restrict__ k, const E* __restrict__ v,
                    const E* __restrict__ k_std, const int* __restrict__ lengths,
                    const E* __restrict__ d_out, const float* __restrict__ stats,
                    float* __restrict__ delta_out, E* __restrict__ dq_u, E* __restrict__ dq_rot,
                    int B, int T, int H, int D, float scale, DropoutArgs drop) {
    constexpr int BT = Tile<E>::B, NW = BT / 16, KC = DqSmem<E, DH>::KC;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int kd = DH + D;
    const DqSmem<E, DH> L(kd);
    E* Qs = reinterpret_cast<E*>(smem_raw + L.q);
    E* Kc = reinterpret_cast<E*>(smem_raw + L.kc);
    E* Vs = reinterpret_cast<E*>(smem_raw + L.v);
    E* dOs = reinterpret_cast<E*>(smem_raw + L.dO);
    float* Ss = reinterpret_cast<float*>(smem_raw + L.s);
    float* Ds = reinterpret_cast<float*>(smem_raw + L.d);
    E* dSs = reinterpret_cast<E*>(smem_raw + L.ds);
    float* Acc = reinterpret_cast<float*>(smem_raw + L.acc);
    // the rows' max, sum and delta (in shared memory, not registers: the
    // chunked products leave no room for them there)
    float* m_s = reinterpret_cast<float*>(smem_raw + L.st);
    float* l_s = m_s + BT;
    float* dl_s = l_s + BT;

    const int t0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wr = warp * 16;
    const int len = lengths[b];
    const int n_keys = visited_keys(len, T);
    const size_t hs = (size_t)H * DH, rs = (size_t)H * D;
    const E* qu_b = q_u + (size_t)b * T * hs + (size_t)h * DH;
    const E* qr_b = q_rot + (size_t)b * T * rs + (size_t)h * D;
    const E* k_b = k + (size_t)b * T * hs + (size_t)h * DH;
    const E* v_b = v + (size_t)b * T * hs + (size_t)h * DH;
    const E* do_b = d_out + (size_t)b * T * hs + (size_t)h * DH;

    load_cat_cols<E>(Qs, L.ldq, qu_b, hs, DH, qr_b, rs, 0, kd, t0, T, BT, warp, NW, lane);
    load_cat_cols<E>(dOs, L.ldv, do_b, hs, DH, do_b, hs, 0, DH, t0, T, BT, warp, NW, lane);
    for (int i = threadIdx.x; i < BT * kd; i += NW * 32) Acc[(i / kd) * L.lda + i % kd] = 0.0f;
    for (int r = threadIdx.x; r < BT; r += NW * 32) {
        const size_t at = ((size_t)b * H + h) * T + min(t0 + r, T - 1);
        m_s[r] = stats[at];
        l_s[r] = stats[(size_t)B * H * T + at];
        dl_s[r] = 0.0f;
    }
    const uint32_t key = dropout_key(drop.seed, drop.row0 + b, h, H);

    for (int pass = 0; pass < 2; ++pass) {
        for (int s0 = 0; s0 < n_keys; s0 += BT) {
            __syncthreads();  // the previous key tile's products are done
            load_cat_cols<E>(Vs, L.ldv, v_b, hs, DH, v_b, hs, 0, DH, s0, T, BT, warp, NW, lane);
            // S over the chunks of [k | k_std], in column order
            for (int c0 = 0; c0 < kd; c0 += KC) {
                const int w = min(KC, kd - c0);
                if (c0 > 0) __syncthreads();  // every warp is done with the last chunk
                load_cat_cols<E>(Kc, L.ldkc, k_b, hs, DH, k_std, (size_t)D, c0, w, s0, T, BT, warp, NW, lane);
                __syncthreads();
                if (c0 == 0)
                    warp_mm<false, true, false>(Ss + wr * L.lds, L.lds, Qs + (size_t)wr * L.ldq, L.ldq, Kc,
                                                L.ldkc, w, BT / 16);
                else
                    warp_mm<false, true, true>(Ss + wr * L.lds, L.lds, Qs + (size_t)wr * L.ldq + c0, L.ldq,
                                               Kc, L.ldkc, w, BT / 16);
            }
            warp_mm<false, true, false>(Ds + wr * L.lds, L.lds, dOs + (size_t)wr * L.ldv, L.ldv,
                                        Vs, L.ldv, DH, BT / 16);
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const int r = wr + i, t = t0 + r;
                const float m = m_s[r], l = l_s[r], delta = dl_s[r];
                float part = 0.0f;
                for (int c = lane; c < BT; c += 32) {
                    const int s = s0 + c;
                    const float x = masked_score(Ss[r * L.lds + c], scale, s, len, T);
                    const float p = expf(x - m) / l;
                    float dp = Ds[r * L.lds + c];
                    if (drop.enabled)
                        dp = dropout_keep(key, t, s, T, drop.thresh) ? dp * drop.inv_keep : 0.0f;
                    if (pass == 0)
                        part += p * dp;
                    else
                        dSs[r * L.ldp + c] = from_float<E>(p * (dp - delta) * scale);
                }
                if (pass == 0) {
                    part = warp_sum(part);
                    if (lane == 0) dl_s[r] = delta + part;
                }
            }
            if (pass == 1) {
                // [dq_u | dq_rot] += dS [k | k_std], chunk by chunk
                for (int c0 = 0; c0 < kd; c0 += KC) {
                    const int w = min(KC, kd - c0);
                    __syncthreads();  // every warp is done with the chunk in the buffer
                    load_cat_cols<E>(Kc, L.ldkc, k_b, hs, DH, k_std, (size_t)D, c0, w, s0, T, BT, warp, NW,
                                     lane);
                    __syncthreads();
                    warp_mm<false, false, true>(Acc + (size_t)wr * L.lda + c0, L.lda, dSs + (size_t)wr * L.ldp,
                                                L.ldp, Kc, L.ldkc, BT, w / 16);
                }
            }
        }
        if (pass == 0 && lane == 0) {
            for (int i = 0; i < 16; ++i) {
                const int t = t0 + wr + i;
                if (t < T) delta_out[((size_t)b * H + h) * T + t] = dl_s[wr + i];
            }
        }
    }

    for (int i = lane; i < 16 * kd; i += 32) {
        const int r = wr + i / kd, c = i % kd, t = t0 + r;
        if (t >= T) continue;
        const E val = from_float<E>(Acc[(size_t)r * L.lda + c]);
        if (c < DH)
            dq_u[((size_t)b * T + t) * hs + (size_t)h * DH + c] = val;
        else
            dq_rot[((size_t)b * T + t) * rs + (size_t)h * D + (c - DH)] = val;
    }
}

// ---------------------------------------------------------------------------
// backward, dk/dv pass

template <typename E, int DH>
struct DkvSmem {
    size_t q, k, v, dO, s, d, p, ds, acc_v, acc_k, st, total;
    int ldk, ldv, lds, ldp, lda;
    __host__ __device__ explicit DkvSmem(int kd) {
        constexpr int BT = Tile<E>::B, V = 16 / (int)sizeof(E);
        ldk = kd + V; ldv = DH + V; lds = BT + 4; ldp = BT + V; lda = DH + 4;
        q = 0;
        k = up128(q + (size_t)BT * ldk * sizeof(E));
        v = up128(k + (size_t)BT * ldk * sizeof(E));
        dO = up128(v + (size_t)BT * ldv * sizeof(E));
        s = up128(dO + (size_t)BT * ldv * sizeof(E));
        d = up128(s + (size_t)BT * lds * 4);
        p = up128(d + (size_t)BT * lds * 4);
        ds = up128(p + (size_t)BT * ldp * sizeof(E));
        acc_v = up128(ds + (size_t)BT * ldp * sizeof(E));
        acc_k = up128(acc_v + (size_t)BT * lda * 4);
        st = up128(acc_k + (size_t)BT * lda * 4);
        total = up128(st + (size_t)3 * BT * 4);
    }
};

template <typename E, int DH>
__global__ void __launch_bounds__(Tile<E>::B * 2)
train_bwd_dkv_kernel(const E* __restrict__ q_u, const E* __restrict__ q_rot,
                     const E* __restrict__ k, const E* __restrict__ v,
                     const E* __restrict__ k_std, const int* __restrict__ lengths,
                     const E* __restrict__ d_out, const float* __restrict__ stats,
                     const float* __restrict__ delta_in, E* __restrict__ dk, E* __restrict__ dv,
                     int B, int T, int H, int D, float scale, DropoutArgs drop) {
    constexpr int BT = Tile<E>::B, NW = BT / 16;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int kd = DH + D;
    const DkvSmem<E, DH> L(kd);
    E* Qs = reinterpret_cast<E*>(smem_raw + L.q);
    E* Ks = reinterpret_cast<E*>(smem_raw + L.k);
    E* Vs = reinterpret_cast<E*>(smem_raw + L.v);
    E* dOs = reinterpret_cast<E*>(smem_raw + L.dO);
    float* Ss = reinterpret_cast<float*>(smem_raw + L.s);
    float* Ds = reinterpret_cast<float*>(smem_raw + L.d);
    E* Ps = reinterpret_cast<E*>(smem_raw + L.p);
    E* dSs = reinterpret_cast<E*>(smem_raw + L.ds);
    float* AccV = reinterpret_cast<float*>(smem_raw + L.acc_v);
    float* AccK = reinterpret_cast<float*>(smem_raw + L.acc_k);
    float* m_s = reinterpret_cast<float*>(smem_raw + L.st);
    float* l_s = m_s + BT;
    float* dl_s = l_s + BT;

    const int s0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wr = warp * 16;
    const int len = lengths[b];
    const size_t hs = (size_t)H * DH, rs = (size_t)H * D;
    E* dk_b = dk + (size_t)b * T * hs + (size_t)h * DH;
    E* dv_b = dv + (size_t)b * T * hs + (size_t)h * DH;

    if (s0 >= visited_keys(len, T)) {
        // every probability of these keys is an exact zero: so are dk and dv
        for (int i = threadIdx.x; i < BT * DH; i += NW * 32) {
            const int s = s0 + i / DH, d = i % DH;
            if (s < T) {
                dk_b[(size_t)s * hs + d] = from_float<E>(0.0f);
                dv_b[(size_t)s * hs + d] = from_float<E>(0.0f);
            }
        }
        return;
    }

    const E* qu_b = q_u + (size_t)b * T * hs + (size_t)h * DH;
    const E* qr_b = q_rot + (size_t)b * T * rs + (size_t)h * D;
    const E* k_b = k + (size_t)b * T * hs + (size_t)h * DH;
    const E* v_b = v + (size_t)b * T * hs + (size_t)h * DH;
    const E* do_b = d_out + (size_t)b * T * hs + (size_t)h * DH;

    load_cat_cols<E>(Ks, L.ldk, k_b, hs, DH, k_std, (size_t)D, 0, kd, s0, T, BT, warp, NW, lane);
    load_cat_cols<E>(Vs, L.ldv, v_b, hs, DH, v_b, hs, 0, DH, s0, T, BT, warp, NW, lane);
    for (int i = threadIdx.x; i < BT * DH; i += NW * 32) {
        AccV[(i / DH) * L.lda + i % DH] = 0.0f;
        AccK[(i / DH) * L.lda + i % DH] = 0.0f;
    }
    const uint32_t key = dropout_key(drop.seed, drop.row0 + b, h, H);
    const float inv_keep_e = round_to<E>(drop.inv_keep);

    for (int t0 = 0; t0 < T; t0 += BT) {
        __syncthreads();  // the previous query tile's products are done
        load_cat_cols<E>(Qs, L.ldk, qu_b, hs, DH, qr_b, rs, 0, kd, t0, T, BT, warp, NW, lane);
        load_cat_cols<E>(dOs, L.ldv, do_b, hs, DH, do_b, hs, 0, DH, t0, T, BT, warp, NW, lane);
        for (int r = threadIdx.x; r < BT; r += NW * 32) {
            const int t = t0 + r;
            const size_t at = ((size_t)b * H + h) * T + min(t, T - 1);
            m_s[r] = stats[at];
            l_s[r] = stats[(size_t)B * H * T + at];
            dl_s[r] = delta_in[at];
        }
        __syncthreads();
        // this warp's 16 QUERY rows of S and dP against the block's keys
        warp_mm<false, true, false>(Ss + wr * L.lds, L.lds, Qs + (size_t)wr * L.ldk, L.ldk, Ks,
                                    L.ldk, kd, BT / 16);
        warp_mm<false, true, false>(Ds + wr * L.lds, L.lds, dOs + (size_t)wr * L.ldv, L.ldv, Vs,
                                    L.ldv, DH, BT / 16);
#pragma unroll 1
        for (int i = 0; i < 16; ++i) {
            const int r = wr + i, t = t0 + r;
            const float m = m_s[r], l = l_s[r], delta = dl_s[r];
            for (int c = lane; c < BT; c += 32) {
                const int s = s0 + c;
                const float x = masked_score(Ss[r * L.lds + c], scale, s, len, T);
                const float p = t < T ? expf(x - m) / l : 0.0f;
                float pd = round_to<E>(p);
                float dp = Ds[r * L.lds + c];
                if (drop.enabled) {
                    const bool keep = dropout_keep(key, t, s, T, drop.thresh);
                    pd = keep ? round_to<E>(pd * inv_keep_e) : 0.0f;
                    dp = keep ? dp * drop.inv_keep : 0.0f;
                }
                Ps[r * L.ldp + c] = from_float<E>(pd);
                dSs[r * L.ldp + c] = from_float<E>(p * (dp - delta) * scale);
            }
        }
        __syncthreads();  // every query row of Pd and dS is in place
        // this warp's 16 KEY rows: dv += Pd^T dO, dk += dS^T q_u
        warp_mm<true, false, true>(AccV + wr * L.lda, L.lda, Ps + wr, L.ldp, dOs, L.ldv, BT,
                                   DH / 16);
        warp_mm<true, false, true>(AccK + wr * L.lda, L.lda, dSs + wr, L.ldp, Qs, L.ldk, BT,
                                   DH / 16);
    }

    for (int i = lane; i < 16 * DH; i += 32) {
        const int r = wr + i / DH, d = i % DH, s = s0 + r;
        if (s < T) {
            dk_b[(size_t)s * hs + d] = from_float<E>(AccK[r * L.lda + d]);
            dv_b[(size_t)s * hs + d] = from_float<E>(AccV[r * L.lda + d]);
        }
    }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename E, int DH>
int fwd(const void* q_u, const void* q_rot, const void* k, const void* v, const void* k_std,
        const void* lengths, void* out, void* stats, int B, int T, int H, int D, float scale,
        DropoutArgs drop, cudaStream_t stream) {
    constexpr int BT = Tile<E>::B;
    const FwdSmem<E, DH> L(DH + D);
    cudaError_t err = allow_smem(train_fwd_kernel<E, DH>, L.total);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(T, BT), H, B);
    train_fwd_kernel<E, DH><<<grid, BT * 2, L.total, stream>>>(
        (const E*)q_u, (const E*)q_rot, (const E*)k, (const E*)v, (const E*)k_std,
        (const int*)lengths, (E*)out, (float*)stats, B, T, H, D, scale, drop);
    return (int)cudaGetLastError();
}

template <typename E, int DH>
int bwd(const void* q_u, const void* q_rot, const void* k, const void* v, const void* k_std,
        const void* lengths, const void* d_out, const void* stats, void* delta, void* dq_u,
        void* dq_rot, void* dk, void* dv, int B, int T, int H, int D, float scale,
        DropoutArgs drop, cudaStream_t stream) {
    constexpr int BT = Tile<E>::B;
    const DqSmem<E, DH> Lq(DH + D);
    const DkvSmem<E, DH> Lk(DH + D);
    cudaError_t err = allow_smem(train_bwd_dq_kernel<E, DH>, Lq.total);
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(train_bwd_dkv_kernel<E, DH>, Lk.total);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(T, BT), H, B);
    train_bwd_dq_kernel<E, DH><<<grid, BT * 2, Lq.total, stream>>>(
        (const E*)q_u, (const E*)q_rot, (const E*)k, (const E*)v, (const E*)k_std,
        (const int*)lengths, (const E*)d_out, (const float*)stats, (float*)delta, (E*)dq_u,
        (E*)dq_rot, B, T, H, D, scale, drop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    train_bwd_dkv_kernel<E, DH><<<grid, BT * 2, Lk.total, stream>>>(
        (const E*)q_u, (const E*)q_rot, (const E*)k, (const E*)v, (const E*)k_std,
        (const int*)lengths, (const E*)d_out, (const float*)stats, (const float*)delta, (E*)dk,
        (E*)dv, B, T, H, D, scale, drop);
    return (int)cudaGetLastError();
}

}  // namespace

// q_u, k, v, out: (B, T, H, dh) contiguous; q_rot: (B, T, H, D); k_std: (T, D);
// lengths: (B,) int32; stats: (2, B, H, T) fp32 (row max, row sum). dh = 32 or
// 64 (the wrapper pads other head sizes with zero columns); is_bf16 selects the
// element type (bf16 or float); row0: the number the dropout hash gives batch row 0.
ASR_API int asr_rel_attention_train_fwd(const void* q_u, const void* q_rot, const void* k,
                                        const void* v, const void* k_std, const void* lengths,
                                        void* out, void* stats, int B, int T, int H, int dh, int D,
                                        int is_bf16, float scale, unsigned seed, unsigned thresh,
                                        float inv_keep, int dropout, int row0, void* stream) {
    if (D % 16 != 0 || T < 1) return (int)cudaErrorInvalidValue;
    const DropoutArgs drop{seed, thresh, inv_keep, dropout, row0};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_head_width(dh, [&](auto head) {
        constexpr int DH = decltype(head)::value;
        return is_bf16 ? train_fwd_bf16<DH>(q_u, q_rot, k, v, k_std, lengths, out, stats, B, T, H, D, scale, drop, st)
                       : fwd<float, DH>(q_u, q_rot, k, v, k_std, lengths, out, stats, B, T, H, D, scale, drop, st);
    });
}

// The two backward passes, dq then dkv (the second reads the first's delta).
// delta: (B, H, T) fp32 scratch; dq_rot: (B, T, H, D); dq_u, dk, dv: (B, T, H, dh).
ASR_API int asr_rel_attention_train_bwd(const void* q_u, const void* q_rot, const void* k,
                                        const void* v, const void* k_std, const void* lengths,
                                        const void* d_out, const void* stats, void* delta,
                                        void* dq_u, void* dq_rot, void* dk, void* dv, int B, int T,
                                        int H, int dh, int D, int is_bf16, float scale,
                                        unsigned seed, unsigned thresh, float inv_keep, int dropout,
                                        int row0, void* stream) {
    if (D % 16 != 0 || T < 1) return (int)cudaErrorInvalidValue;
    const DropoutArgs drop{seed, thresh, inv_keep, dropout, row0};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_head_width(dh, [&](auto head) {
        constexpr int DH = decltype(head)::value;
        return is_bf16 ? train_bwd_bf16<DH>(q_u, q_rot, k, v, k_std, lengths, d_out, stats, delta, dq_u, dq_rot,
                                            dk, dv, B, T, H, D, scale, drop, st)
                       : bwd<float, DH>(q_u, q_rot, k, v, k_std, lengths, d_out, stats, delta, dq_u,
                                        dq_rot, dk, dv, B, T, H, D, scale, drop, st);
    });
}
