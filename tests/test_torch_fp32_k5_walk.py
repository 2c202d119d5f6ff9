"""PyTorch port, the fp32 shift-form inference attention's walk of the keys,
on the CPU.

``csrc/rel_attention_shift.cu``'s fp32 kernel walks the keys once: a block
owns 64 query rows of one (b, h), and for each 64-key tile it takes the
positional score of (t, s) from a band of table rows, row 64 + (t - t0) -
(s - s0) of the two 64-row chunks j + 1 and j of the sequence chunk m =
table rows t0 + T - 1 - 64 m + [0, 64) (zeros outside [0, 2T - 1)), then
updates the online row max and sum of FlashAttention-2 and out. A row of
length 0 visits all T keys, each at -1e9. ``walk`` below repeats that
schedule in numpy (fp32) and is held within 1e-5 of the scale (the
reference's largest magnitude, at least 1) against the JAX kernel
(``ops/pallas_attention.py::rel_attention``, interpret mode; T a multiple of
8 for its roll) and against ``rel_attention_reference``, at head widths 32
and 64 with rows of length T, a ragged length, 1 and 0.

The kernel's shared-memory layout is recomputed from its constants: two
blocks an SM must fit, and the 16 lanes of a row group must read 16
distinct 16-byte slots spread evenly over the 8 bank groups.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest

from huggingface_asr_tpu.ops.pallas_attention import rel_attention as j_rel_attention
from huggingface_asr_tpu.ops.pallas_attention import rel_attention_reference

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "huggingface_asr_tpu_torch", "csrc")
BM = BN = 64  # query rows a block, keys a tile (and rows of a band chunk)
NEG = np.float32(-1.0e9)


def _tile(x, rows):
    """x[rows] with rows outside [0, len(x)) as zeros."""
    ok = (rows >= 0) & (rows < x.shape[0])
    out = np.zeros((len(rows),) + x.shape[1:], x.dtype)
    out[ok] = x[rows[ok]]
    return out


def walk(q_u, q_v, k, v, pos, lengths):
    """The fp32 kernel's schedule in numpy: (B, T, H, dh) out."""
    B, T, H, dh = q_u.shape
    scale = np.float32(1.0 / np.sqrt(dh))
    out = np.zeros_like(q_u)
    r, c = np.arange(BM), np.arange(BN)
    diag = BN + r[:, None] - c[None, :]  # band row of (t, s) in [chunk j + 1 | chunk j]: 1 .. 127
    for b in range(B):
        n = int(lengths[b])
        n_keys = min(n, T) if n > 0 else T
        for h in range(H):
            table = pos[:, h]
            for t0 in range(0, T, BM):
                qu, qv = _tile(q_u[b, :, h], t0 + r), _tile(q_v[b, :, h], t0 + r)
                m_run = np.full(BM, -np.inf, np.float32)
                l_run = np.zeros(BM, np.float32)
                o = np.zeros((BM, dh), np.float32)
                chunk = lambda m: _tile(table, t0 + T - 1 - BN * m + c)  # noqa: E731
                for j in range((n_keys + BN - 1) // BN):
                    s0 = j * BN
                    keys = s0 + c
                    band = np.concatenate([chunk(j + 1), chunk(j)])
                    s = qu @ _tile(k[b, :, h], keys).T + np.einsum("rd,rcd->rc", qv, band[diag])
                    s = np.where(keys >= T, -np.inf, np.where(keys >= n, NEG, s * scale)).astype(np.float32)
                    m_new = np.maximum(m_run, s.max(axis=1))
                    alpha = np.exp(m_run - m_new)
                    p = np.exp(s - m_new[:, None])
                    l_run = l_run * alpha + p.sum(axis=1)
                    o = o * alpha[:, None] + p @ _tile(v[b, :, h], keys)
                    m_run = m_new
                rows = t0 + r < T
                out[b, (t0 + r)[rows], h] = (o / l_run[:, None])[rows]
    return out


def _inputs(B, T, H, dh, lens, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (mk(B, T, H, dh), mk(B, T, H, dh), mk(B, T, H, dh), mk(B, T, H, dh), mk(2 * T - 1, H, dh),
            np.asarray(lens, np.int32))


def _close(got, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    assert err <= 1e-5 * scale, (err, scale)


def test_walk_matches_the_pallas_kernel_in_interpret_mode():
    x = _inputs(4, 136, 2, 32, [136, 65, 1, 0], seed=136)
    ref = np.asarray(j_rel_attention(*(jnp.asarray(a) for a in x), interpret=True))
    got = walk(*x)
    _close(got, ref)
    # a zero-length row is uniform over all T keys; a row of length 1 takes its first key's v
    np.testing.assert_allclose(got[3, :, 0], np.broadcast_to(x[3][3, :, 0].mean(axis=0), (136, 32)), atol=1e-5)
    np.testing.assert_allclose(got[2, :, 1], np.broadcast_to(x[3][2, 0, 1], (136, 32)), atol=1e-6)


@pytest.mark.parametrize("dh", [32, 64])
def test_walk_matches_the_reference_over_several_tiles(dh):
    x = _inputs(4, 250, 2, dh, [250, 200, 1, 0], seed=dh)
    _close(walk(*x), np.asarray(rel_attention_reference(*(jnp.asarray(a) for a in x))))


def _consts():
    with open(os.path.join(CSRC, "rel_attention_shift.cu")) as f:
        src = f.read()
    ints = {name: int(val) for name, val in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    return src, {k: ints[k] for k in ("THREADS", "BM", "BN", "ALIGN")}


SM_SMEM, BLOCK_RESERVED = 233472, 1024  # an H100 SM's 228 KB of shared memory; 1 KB of it reserved a block


def test_fp32_kernel_layout_fits_two_blocks_an_sm_without_bank_conflicts():
    src, c = _consts()
    assert (c["THREADS"], c["BM"], c["BN"]) == (256, BM, BN)
    # q_u, q_v (BM rows), k, v and two band chunks (BN rows), P (BM x BN), the base's alignment slack
    body = re.search(r"constexpr size_t shift_smem\(int dh\) \{ return (.*?); \}", src).group(1)
    assert body == "ALIGN + 4 * (size_t)(2 * BM * dh + 4 * BN * dh + BM * BN)"
    smem = {dh: c["ALIGN"] + 4 * (2 * BM * dh + 4 * BN * dh + BM * BN) for dh in (32, 64)}
    assert smem == {32: 65792, 64: 114944}
    for n in smem.values():
        assert 2 * (n + BLOCK_RESERVED) <= SM_SMEM, n

    perm = lambda x: 16 * (x & 3) + (x >> 2)  # noqa: E731  stored row of key (band row) x of a tile
    assert sorted(perm(x) for x in range(64)) == list(range(64))
    lanes = np.arange(16)  # cg of the 16 lanes of a row group
    for dh in (32, 64):
        row_bytes = 4 * dh

        def slots(rows, chunk, swizzle):
            """16-byte slots and bank groups the lanes read: rows of 16-byte chunks, XOR-swizzled."""
            addr = rows * row_bytes + ((chunk ^ swizzle) << 4)
            return addr // 16, (addr // 16) % 8

        for chunk in range(dh // 4):
            # k: lane cg reads key 4 cg + j, stored row 16 j + cg, swizzled by its low 3 bits
            for j in range(4):
                rows = np.array([perm(4 * cg + j) for cg in lanes])
                slot, group = slots(rows, chunk, rows & 7)
                assert len(set(slot)) == 16 and np.bincount(group, minlength=8).tolist() == [2] * 8
            # band: lane cg of rows row0 .. row0 + 3 reads diagonal 64 + row0 - 4 cg + d - 3 of the window,
            # chunk j + 1 below 64 and chunk j from 64 (the two slots of the ring, BN rows apart)
            for row0 in range(0, 64, 4):
                for d in range(7):
                    x = 64 + row0 - 4 * lanes + d - 3
                    rows = np.array([perm(i & 63) for i in x]) + np.where(x < 64, 0, BN)
                    slot, group = slots(rows, chunk, rows & 7)
                    assert len(set(slot)) == 16 and np.bincount(group, minlength=8).max() <= 2
            # q and P: the two row groups of a warp (rows r and r + 4) on distinct bank groups
            for r in range(0, 64, 8):
                rows = np.array([r, r + 4])
                assert len(set(slots(rows, chunk, (rows >> 2) & 1)[1])) == 2
